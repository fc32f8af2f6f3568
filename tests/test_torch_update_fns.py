"""The autodiff update of the port (ppo/train.py::make_update_fns,
make_minibatch_update) vs the JAX package's `make_update_fns` on the same
numpy inputs, with the JAX permutations injected: the argsort of
`jax.random.bits(key, (E, rows), uint32)` that JAX `run_epochs` draws
from the update key (train.py:186-191).

Covers `compute_advantages` (GAE, both normalizers, the standardized
advantages), `update_policy` (full-width obs, as the per-tick and
structured trainers call it) and `update_policy.with_feat` (the packed
feat matrix of `--no-fused-grads`), at shuffle_block 8 and 1, and the
JAX warnings and fallback for a block that is invalid or does not divide
the minibatch.

Tolerances: compute_advantages' outputs 1e-5 relative / 1e-5 absolute
(float32 sums in other orders); the first Adam step (per-step tier)
params, mu and nu 2e-6 absolute; the whole phase (E x M = 4 steps, two
chained phases) 1e-5 absolute, the tier of tests/test_torch_update.py;
the Adam count exact."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import constants as C
from madrona_basketball_tpu.models.agent import init_agent as j_init_agent
from madrona_basketball_tpu.models.normalize import rms_update as j_rms_update
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import (make_minibatch_update,
                                              make_optimizer, make_update_fns)

from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.utils.jax_params import (adam_from_numpy,
                                                           agent_from_numpy)
from tests import torch_threads  # noqa: F401

D = C.OBS_USED
T, N = 4, 16
STEP_ATOL = 2e-6
PHASE_ATOL = 1e-5


def _hps(**kw):
    kw = {**dict(num_envs=N, num_rollout_steps=T, num_minibatches=2,
                 update_epochs=2), **kw}
    return JPPOParams(**kw), PPOParams(**kw)


def _agents(seed):
    net, ap = j_init_agent(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    obs = np.zeros((256, C.OBS_SIZE), np.float32)
    obs[:, :D] = rng.normal(1.0, 2.0, (256, D))
    ap = ap.replace(obs_rms=j_rms_update(ap.obs_rms, jnp.asarray(obs)))
    return net, ap, agent_from_numpy(jax.tree.map(np.asarray, ap), "cpu"), rng


def _buf(rng):
    """A rollout buffer as the per-tick trainer fills it: full-width obs
    whose tail beyond OBS_USED is the structural zero."""
    obs = np.zeros((T, N, C.OBS_SIZE), np.float32)
    obs[..., :D] = rng.normal(scale=3.0, size=(T, N, D))
    acts = np.stack([rng.randint(0, n, (T, N)) for n in C.ACTION_BUCKETS],
                    -1).astype(np.int32)
    done = (rng.uniform(size=(T, N)) < 0.2).astype(np.float32)
    return dict(obs=obs, actions=acts,
                values=rng.normal(size=(T, N)).astype(np.float32),
                log_probs=rng.normal(-6.0, 0.5, (T, N)).astype(np.float32),
                not_dones=1.0 - done,
                rewards=rng.normal(size=(T, N)).astype(np.float32),
                next_value=rng.normal(size=(N,)).astype(np.float32))


def _jax_perms(key, jhp, G):
    rows = jhp.rollout_batch_size // G
    return jnp.argsort(jax.random.bits(key, (jhp.update_epochs, rows),
                                       jnp.uint32), axis=1)


def _close(got, want, atol, msg=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=atol, err_msg=f"{msg} {i}")


def _check_state(agent, opt, ap, jopt, atol, msg):
    _close(FU.pack_weights(agent.net), JFU.pack_weights(ap.params, D), atol,
           msg + " params")
    want = adam_from_numpy(jax.tree.map(np.asarray, jopt), "cpu")
    _close(opt.mu, want.mu, atol, msg + " mu")
    _close(opt.nu, want.nu, atol, msg + " nu")
    assert opt.count == want.count


def test_compute_advantages_matches_jax():
    jhp, hp = _hps()
    net, ap, agent, rng = _agents(1)
    buf = _buf(rng)
    c_j, _ = make_update_fns(jhp, net)
    c_t, _ = TT.make_update_fns(hp)
    ap2, adv, vn, rn = c_j(ap, {k: jnp.asarray(v) for k, v in buf.items()})
    agent2, t_adv, t_vn, t_rn = c_t(agent, {k: torch.tensor(v)
                                            for k, v in buf.items()})
    assert agent2.net is agent.net
    for g, w in ((t_adv, adv), (t_vn, vn), (t_rn, rn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    for k in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                getattr(getattr(agent2, k), f).numpy(),
                np.asarray(getattr(getattr(ap2, k), f)), rtol=1e-5,
                atol=1e-5, err_msg=f"{k}.{f}")


@pytest.mark.parametrize("G", [8, 1])
def test_update_policy_matches_jax(G):
    """Two chained phases of update_policy over the same buffer; the first
    Adam step alone at the per-step tier."""
    jhp, hp = _hps(shuffle_block=G)
    net, ap, agent, rng = _agents(2)
    buf = _buf(rng)
    c_j, u_j = make_update_fns(jhp, net)
    _, u_t = TT.make_update_fns(hp)
    jbuf = {k: jnp.asarray(v) for k, v in buf.items()}
    ap, adv, vn, rn = c_j(ap, jbuf)
    tbuf = {k: torch.tensor(v) for k, v in buf.items()}
    targs = tuple(torch.tensor(np.asarray(x)) for x in (adv, vn, rn))
    agent = agent_from_numpy(jax.tree.map(np.asarray, ap), "cpu")
    jopt = make_optimizer(jhp).init(ap.params)
    opt = TT.init_adam(FU.pack_weights(agent.net))
    assert u_t.perm_shape == (jhp.update_epochs,
                              jhp.rollout_batch_size // G)

    # the first Adam step: one epoch of one minibatch on each side
    jhp1, hp1 = _hps(shuffle_block=G, update_epochs=1, num_minibatches=1)
    key = jax.random.PRNGKey(40)
    _, u_j1 = make_update_fns(jhp1, net)
    _, u_t1 = TT.make_update_fns(hp1)
    ap1, jopt1 = u_j1(ap, jopt, jbuf, adv, vn, rn, key)
    a1 = agent_from_numpy(jax.tree.map(np.asarray, ap), "cpu")
    a1, opt1 = u_t1(a1, opt, tbuf, *targs,
                    torch.tensor(np.asarray(_jax_perms(key, jhp1, G))))
    _check_state(a1, opt1, ap1, jopt1, STEP_ATOL, "step 1")

    for it in range(2):
        key = jax.random.PRNGKey(50 + it)
        ap, jopt = u_j(ap, jopt, jbuf, adv, vn, rn, key)
        agent, opt = u_t(agent, opt, tbuf, *targs,
                         torch.tensor(np.asarray(_jax_perms(key, jhp, G))))
        _check_state(agent, opt, ap, jopt, PHASE_ATOL, f"phase {it}")


@pytest.mark.parametrize("G", [8, 1])
def test_update_policy_feat_matches_jax(G):
    """update_policy.with_feat over a packed (T * N, 128) feat matrix laid
    out as the `--no-fused-grads` trajectory rows: obs 0:103, actions,
    logp, value_n, adv, ret_n, then ignored padding columns."""
    jhp, hp = _hps(shuffle_block=G)
    net, ap, agent, rng = _agents(3)
    feat = rng.normal(size=(T * N, 128)).astype(np.float32)
    feat[:, :D] *= 3.0
    for j, n in enumerate(C.ACTION_BUCKETS):
        feat[:, D + j] = rng.randint(0, n, T * N)
    _, u_j = make_update_fns(jhp, net)
    _, u_t = TT.make_update_fns(hp)
    jopt = make_optimizer(jhp).init(ap.params)
    opt = TT.init_adam(FU.pack_weights(agent.net))
    for it in range(2):
        key = jax.random.PRNGKey(60 + it)
        ap, jopt = u_j.with_feat(ap, jopt, jnp.asarray(feat), D, 6, key)
        agent, opt = u_t.with_feat(
            agent, opt, torch.tensor(feat), D, 6,
            torch.tensor(np.asarray(_jax_perms(key, jhp, G))))
        _check_state(agent, opt, ap, jopt, PHASE_ATOL, f"phase {it}")


def test_update_policy_takes_a_device_count():
    """A 0-d count tensor (how a captured iteration passes Adam's step)
    gives the int count's result bit for bit."""
    _, hp = _hps()
    _, _, agent, rng = _agents(4)
    buf = {k: torch.tensor(v) for k, v in _buf(rng).items()}
    c_t, u_t = TT.make_update_fns(hp)
    agent, adv, vn, rn = c_t(agent, buf)
    perms = u_t.draw_perms(torch.Generator().manual_seed(1), "cpu")
    opt = TT.init_adam(FU.pack_weights(agent.net))
    opt = TT.AdamState(count=3, mu=opt.mu, nu=opt.nu)
    w0 = FU.pack_weights(agent.net)
    a1, o1 = u_t(agent, opt, buf, adv, vn, rn, perms)
    got1 = FU.pack_weights(a1.net)
    FU.unpack_weights(agent.net, *w0)
    a2, o2 = u_t(agent, opt, buf, adv, vn, rn, perms,
                 count=torch.tensor(3, dtype=torch.int32))
    for g, w in zip(FU.pack_weights(a2.net) + o2.mu, got1 + o1.mu):
        assert torch.equal(g, w)
    assert o1.count == o2.count == 3 + 4


def test_draw_perms_are_permutations():
    _, hp = _hps()
    _, u_t = TT.make_update_fns(hp)
    p = u_t.draw_perms(torch.Generator().manual_seed(5), "cpu")
    assert tuple(p.shape) == u_t.perm_shape
    for row in p:
        assert sorted(row.tolist()) == list(range(p.shape[1]))
    q = u_t.draw_perms(torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(p, q)


@pytest.mark.parametrize("G, match", [
    (0, "shuffle_block=0 is invalid"),
    (3, "shuffle_block=3 does not divide minibatch_size=32")])
def test_invalid_shuffle_block_warns_like_jax(G, match):
    jhp, hp = _hps(shuffle_block=G)
    with pytest.warns(UserWarning, match=match) as got:
        assert TT.shuffle_block(hp) == 1
    with pytest.warns(UserWarning) as want:
        make_minibatch_update(jhp)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert TT.make_minibatch_update(hp).perm_shape == (
            2, jhp.rollout_batch_size)
