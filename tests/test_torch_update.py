"""The update phase of the port (ops/fused_update.py, ppo/train.py's
optimizer and loss) vs the JAX package on identical numpy inputs.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_fused_update.py does, and `jax.grad` of `make_update_fns`'s
loss; the port runs its plain versions (the kernels' CPU path).

Tolerances: gradients 1e-5 absolute (the JAX test pins its kernel against
jax.grad at 2e-6; across frameworks the float32 matmul sums run in other
orders, and the largest gradient entries here are ~1e-1); params, Adam
mu and nu 1e-5 absolute after two chained phases of 4 Adam steps each;
the Adam count and the packing round trip exact."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from madrona_basketball_tpu import constants as C
from madrona_basketball_tpu.models.agent import init_agent as j_init_agent
from madrona_basketball_tpu.models.normalize import rms_update as j_rms_update
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import make_optimizer, make_update_fns

from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.utils.jax_params import (adam_from_numpy,
                                                           agent_from_numpy)

D = C.OBS_USED
GRAD_ATOL = 1e-5
STATE_ATOL = 1e-5


def _hps(**kw):
    return JPPOParams(**kw), PPOParams(**kw)


def _agents(seed):
    """A JAX AgentParams with non-trivial obs stats and its port twin."""
    net, ap = j_init_agent(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    ap = ap.replace(obs_rms=j_rms_update(
        ap.obs_rms,
        jnp.asarray(rng.normal(1.0, 2.0, (256, C.OBS_SIZE)), jnp.float32)))
    return net, ap, agent_from_numpy(jax.tree.map(np.asarray, ap), "cpu"), rng


def _make_feat(rng, mb):
    obs = rng.normal(scale=3.0, size=(mb, D))
    acts = np.stack([rng.randint(0, n, mb) for n in C.ACTION_BUCKETS], -1)
    lp = rng.normal(scale=0.3, size=(mb, 1))
    rest = rng.normal(size=(mb, 3))
    return np.concatenate([obs, acts, lp, rest], -1).astype(np.float32)


def _make_traj_side(rng, T, W):
    traj = rng.normal(scale=3.0, size=(T, JFR.ROLL_ROWS, W))
    for j, n in enumerate(C.ACTION_BUCKETS):
        traj[:, JFR.R_ACT + j] = rng.randint(0, n, (T, W))
    traj[:, JFR.R_LOGP] = rng.normal(scale=0.3, size=(T, W))
    side = rng.normal(size=(T, FU.SIDE_ROWS, W))
    return traj.astype(np.float32), side.astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol, msg=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=atol, err_msg=f"{msg} {i}")


def _jax_packed_grad(ref_tree):
    """jax.grad's tree -> the four kernel-orientation matrices."""
    return JFU.pack_weights(ref_tree, D)


def test_pack_unpack_roundtrip_and_orientation():
    _, ap, agent, _ = _agents(4)
    mats = FU.pack_weights(agent.net)
    for g, w in zip(mats, JFU.pack_weights(ap.params, D)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tuple(tuple(m.shape) for m in mats) == FU.SHAPES
    net = copy.deepcopy(agent.net)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(-3.0)
    tail = net.backbone[0].weight[:, D:].clone()
    FU.unpack_weights(net, *mats)
    for g, w in zip(FU.pack_weights(net), mats):
        assert torch.equal(g, w)
    assert torch.equal(net.backbone[0].weight[:, D:], tail)
    for name, p in agent.net.named_parameters():
        q = dict(net.named_parameters())[name]
        if name != "backbone.0.weight":
            assert torch.equal(p, q), name


def test_pick_update_block():
    assert FU.pick_update_block(8192, 65536) == 4096
    assert FU.pick_update_block(8192, 65536, cap=2048) == 2048
    assert FU.pick_update_block(512, 4096) == 512
    assert FU.pick_update_block(16, 32) == 16
    assert FU.pick_update_block(24, 96) == 8


@pytest.mark.parametrize("clip_vloss", [True, False])
def test_minibatch_grad_plain_matches_jax_kernel_and_autodiff(clip_vloss):
    jhp, hp = _hps(num_envs=16, num_rollout_steps=16, num_minibatches=1,
                   update_epochs=1, clip_vloss=clip_vloss)
    mb = hp.minibatch_size
    net, ap, agent, rng = _agents(0 if clip_vloss else 1)
    feat = _make_feat(rng, mb)
    nrm = JFU.pack_norm(ap.obs_rms, D)
    mats = JFU.pack_weights(ap.params, D)
    kern = JFU.make_fused_minibatch_grad(jhp, D, mb, block_rows=mb // 2,
                                         interpret=True)(
        jnp.asarray(feat), nrm, *mats)
    _, update_policy = make_update_fns(jhp, net)
    fj = jnp.asarray(feat)
    ref, _ = jax.grad(update_policy.loss_fn, has_aux=True)(
        ap.params, ap, fj[:, :D], fj[:, D:D + 6].astype(jnp.int32),
        fj[:, D + 6], fj[:, D + 7], fj[:, D + 8], fj[:, D + 9])

    t_nrm = FU.pack_norm(agent.obs_rms)
    # rsqrt: torch's and XLA's may differ by an ulp
    np.testing.assert_allclose(t_nrm.numpy(), np.asarray(nrm), rtol=3e-7)
    got = FU.minibatch_grad_plain(hp, _t(feat), t_nrm,
                                  *FU.pack_weights(agent.net))
    _close(got, kern, GRAD_ATOL, "vs interpret kernel, leaf")
    _close(got, _jax_packed_grad(ref), GRAD_ATOL, "vs jax.grad, leaf")
    # the wrapper's CPU path is the plain version and launches nothing
    n0 = dict(FU.launches)
    wrapped = FU.fused_minibatch_grad(hp, _t(feat), t_nrm,
                                      *FU.pack_weights(agent.net))
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)
    assert FU.launches == n0


def test_minibatch_grad_prefetch_plain_matches_jax_kernel():
    jhp, hp = _hps(num_envs=16, num_rollout_steps=4, num_minibatches=2,
                   update_epochs=1)
    T, W, wb = 4, 16, 4
    net, ap, agent, rng = _agents(7)
    traj, side = _make_traj_side(rng, T, W)
    idx = rng.permutation(T * W // wb)[:hp.minibatch_size // wb]
    idx = idx.astype(np.int32)
    nrm = JFU.pack_norm(ap.obs_rms, D)
    want = JFU.make_fused_minibatch_grad_prefetch(jhp, D, T, W, wb,
                                                  interpret=True)(
        jnp.asarray(idx), jnp.asarray(traj), jnp.asarray(side), nrm,
        *JFU.pack_weights(ap.params, D))
    args = (hp, _t(idx), _t(traj), _t(side), FU.pack_norm(agent.obs_rms),
            *FU.pack_weights(agent.net))
    got = FU.minibatch_grad_prefetch_plain(*args, wb=wb)
    _close(got, want, GRAD_ATOL, "prefetch leaf")
    for g, w in zip(FU.fused_minibatch_grad_prefetch(*args, wb=wb), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("clip_vloss", [True, False])
def test_block_grads_plain_matches_torch_autograd(clip_vloss):
    """The hand-derived backward vs autograd of the port's own loss."""
    _, hp = _hps(num_envs=32, num_rollout_steps=8, num_minibatches=2,
                 update_epochs=1, clip_vloss=clip_vloss)
    _, _, agent, rng = _agents(5)
    mb = hp.minibatch_size
    feat = torch.tensor(_make_feat(rng, mb))
    o, a = feat[:, :D], feat[:, D:D + 6].long()
    lp, v, adv, ret = (feat[:, D + 6 + i] for i in range(4))
    net = agent.net
    params = list(net.parameters())
    loss = TT.loss_fn(hp, net, agent.obs_rms, o, a, lp, v, adv, ret)
    grads = torch.autograd.grad(loss, params)
    gnet = copy.deepcopy(net)
    with torch.no_grad():
        for p, g in zip(gnet.parameters(), grads):
            p.copy_(g)
        assert float(gnet.backbone[0].weight[:, D:].abs().max()) == 0.0
    want = FU.pack_weights(gnet)
    ft = feat.T
    got = FU.block_grads_plain(hp, 1.0 / mb, ft[:D], ft[D:D + 6], ft[D + 6],
                               ft[D + 7], ft[D + 8], ft[D + 9],
                               FU.pack_norm(agent.obs_rms),
                               *FU.pack_weights(net))
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_ATOL,
                                   msg=f"leaf {i}")


def _ustats(rng):
    return np.array([[rng.normal(), 0.5 + rng.uniform(), rng.normal(0, .1),
                      0.5 + rng.uniform(), 0, 0, 0, 0]], np.float32)


@pytest.mark.parametrize("T,W,wb", [(8, 16, 4), (4, 8, 8)])
def test_update_phase_plain_matches_jax_phase_kernel(T, W, wb):
    """Two chained phases (the second from a non-zero Adam count) of the
    raw-side update phase: `update_phase_plain` vs the interpret-mode
    `make_fused_update_phase(raw_side=True)`, and the moments carried in
    the port vs `adam_from_numpy` of the JAX optimizer state."""
    jhp, hp = _hps(num_envs=W, num_rollout_steps=T, num_minibatches=2,
                   update_epochs=2)
    n_blocks = T * W // wb
    _, ap, agent, rng = _agents(13 if wb < W else 21)
    ufp = JFU.make_fused_update_phase(jhp, D, T, W, wb, interpret=True,
                                      raw_side=True)
    nrm = JFU.pack_norm(ap.obs_rms, D)
    opt = make_optimizer(jhp).init(ap.params)
    adam = opt[1][0]
    j_mats = (JFU.pack_weights(ap.params, D), JFU.pack_weights(adam.mu, D),
              JFU.pack_weights(adam.nu, D))
    j_count = adam.count
    t_opt = TT.init_adam(FU.pack_weights(agent.net))
    params, mu, nu = FU.pack_weights(agent.net), t_opt.mu, t_opt.nu
    count = t_opt.count
    for phase in range(2):
        traj, side = _make_traj_side(rng, T, W)
        us = _ustats(rng)
        perms = np.stack([rng.permutation(n_blocks) for _ in range(2)])
        perms = perms.reshape(-1).astype(np.int32)
        out = ufp(jnp.asarray(perms), j_count, jnp.asarray(traj),
                  jnp.asarray(side), nrm, jnp.asarray(us), *j_mats[0],
                  *j_mats[1], *j_mats[2])
        j_mats = (out[0:4], out[4:8], out[8:12])
        j_count = j_count + 4
        params, mu, nu = FU.fused_update_phase(
            hp, _t(perms), count, _t(traj), _t(side),
            FU.pack_norm(agent.obs_rms), _t(us), params, mu, nu, wb=wb)
        count += 4
        assert count == int(j_count)
        for name, g, w in (("params", params, j_mats[0]),
                           ("mu", mu, j_mats[1]), ("nu", nu, j_mats[2])):
            _close(g, w, STATE_ATOL, f"phase {phase} {name} leaf")
    # optax's state after the same two phases, through adam_from_numpy
    tree_mu = JFU.unpack_weights(adam.mu, *j_mats[1], D)
    tree_nu = JFU.unpack_weights(adam.nu, *j_mats[2], D)
    j_opt = (opt[0], (adam._replace(count=j_count, mu=tree_mu, nu=tree_nu),
                      opt[1][1]))
    conv = adam_from_numpy(jax.tree.map(np.asarray, j_opt), "cpu")
    assert conv.count == count == 8
    for got, want in ((conv.mu, j_mats[1]), (conv.nu, j_mats[2])):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_clip_adam_step_matches_optax():
    """One optimizer step from non-zero moments, with and without the
    global-norm clip engaging."""
    _, hp = _hps()
    _, ap, agent, rng = _agents(3)
    tx = make_optimizer(JPPOParams())
    opt = tx.init(ap.params)
    params = FU.pack_weights(agent.net)
    st = TT.init_adam(params)
    for scale in (0.01, 10.0):       # |g| below and above max_grad_norm
        g_tree = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(scale=scale, size=x.shape),
                                  jnp.float32), ap.params)
        g_tree["params"]["Dense_0"]["kernel"] = \
            g_tree["params"]["Dense_0"]["kernel"].at[D:].set(0.0)
        upd, opt = tx.update(g_tree, opt, ap.params)
        ap = ap.replace(params=optax.apply_updates(ap.params, upd))
        grads = tuple(_t(m) for m in JFU.pack_weights(g_tree, D))
        # the packed bias matrix's padding rows carry zero gradient
        params, mu, nu = TT.clip_adam_step(params, st.mu, st.nu, grads,
                                           st.count + 1,
                                           lr=hp.learning_rate,
                                           max_norm=hp.max_grad_norm)
        st = TT.AdamState(count=st.count + 1, mu=mu, nu=nu)
        _close(params, JFU.pack_weights(ap.params, D), 1e-6, "params")
        _close(mu, JFU.pack_weights(opt[1][0].mu, D), 1e-8, "mu")
        _close(nu, JFU.pack_weights(opt[1][0].nu, D), 1e-8, "nu")
