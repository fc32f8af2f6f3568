"""The trainer's bf16 flags: `make_train_iteration(..., bf16_traj=,
bf16_policy=)`, `check_paths` and the training CLI.

  * The bf16_traj iteration on injected noise and block permutations
    against the JAX path composed by hand as tests/test_torch_train.py
    composes it (the collect of tests/test_torch_collect.py, whose module
    fixes T = 6 and trainee 1, then the update phase), with the JAX
    rollout, GAE and update kernels built with traj_dtype=bfloat16, at
    32 worlds (the port's rollout takes whole warps) x 6 ticks, 2 epochs
    x 2 minibatches, two chained iterations.  Tolerances as
    tests/test_torch_train.py's, the trajectory within one bf16 ulp (a
    float32 difference there can round to the neighbouring bf16 value).
  * bf16_traj against the float32 iteration from one state and the same
    draws (tests/test_bf16_traj.py's facts): the rollout is the same, so
    the obs normalizer is equal bit for bit (it folds the obs before
    rounding); the value normalizer sees rounded values, close; the
    params within the storage rounding's envelope.
  * `check_paths` refuses each combination the JAX trainer refuses, with
    its message (the JAX function raises it before it builds anything),
    and takes the ones it takes (the CLI's cases are in
    tests/test_torch_cli.py).
  * A chunk of 3 on the CPU equals 3 eager iterations with both flags."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import constants as C
from madrona_basketball_tpu import engine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.ops import fused_gae as JFG
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ppo import train_fused as JTF
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import init_stats, make_optimizer

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_gae as TFG
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    METRICS, CollectNoise, TrainState, check_paths, init_train_state,
    make_train_iteration, state_tensors)
from madrona_basketball_tpu_torch.utils.jax_params import (agent_from_numpy,
                                                           rows_from_numpy)
from tests.test_torch_collect import T, TI, _jax_iteration

W, WB, ITERS = 32, 8, 2
D = C.OBS_USED
BF16 = torch.bfloat16


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **kw)


def _draws(rng, hp, n_blocks):
    pulse = np.concatenate([rng.uniform(-1, 1, (8, W)),
                            rng.uniform(0, 1, (1, W))]).astype(np.float32)
    noise = rng.uniform(0, 1, (T * JFR.EXT_NOISE_CHUNK, W))
    row = np.arange(T * JFR.EXT_NOISE_CHUNK) % JFR.EXT_NOISE_CHUNK
    noise = np.where((row < 8)[:, None], 2 * noise - 1, noise)
    frozen_u = rng.uniform(0, 1, (JFR.N_LOGITS, W)).astype(np.float32)
    perms = np.stack([rng.permutation(n_blocks)
                      for _ in range(hp.update_epochs)]).astype(np.int32)
    return pulse, noise.astype(np.float32), frozen_u, perms


def _hp_kw():
    return dict(num_envs=W, num_rollout_steps=T, trainee_idx=TI,
                use_frozen=False, num_minibatches=2, update_epochs=2,
                update_block=WB)


def test_bf16_traj_iteration_matches_composed_jax_path():
    jhp, hp = JPPOParams(**_hp_kw()), PPOParams(**_hp_kw())
    jcfg = JSimConfig()
    net, agent = jagent.init_agent(jax.random.PRNGKey(5))
    sf, si = JL.pack(engine.init_batch(jcfg, jax.random.PRNGKey(7), W))
    obs = jnp.zeros((JL.N_OBS_ROWS, W), jnp.float32)
    stats = init_stats(W)
    gb = TFG.pick_gae_block(W)
    bf = dict(interpret=True, traj_dtype=jnp.bfloat16)
    rollout = jax.jit(JFR.make_fused_rollout(
        jcfg, W, T, trainee_idx=TI, use_frozen=False, block=128,
        external_noise=True, obs_moments=True, **bf))
    gae = jax.jit(JFG.make_fused_gae(T, W, hp.gamma, hp.gae_lambda,
                                     JFR.R_VALUE, JFR.R_REW, JFR.R_DONE,
                                     gb=gb, **bf))
    ufp = jax.jit(JFU.make_fused_update_phase(jhp, D, T, W, WB,
                                              raw_side=True, **bf))
    adam = make_optimizer(jhp).init(agent.params)[1][0]

    t_agent = agent_from_numpy(jax.tree.map(np.asarray, agent), "cpu")
    state = TrainState(
        agent=t_agent, frozen=copy.deepcopy(t_agent),
        sf=rows_from_numpy(np.asarray(sf), device="cpu"),
        si=rows_from_numpy(np.asarray(si), device="cpu"),
        obs=torch.zeros((JL.N_OBS_ROWS, W)),
        stats=TT.init_stats(W, "cpu"), seed=0, counter=0,
        opt=TT.init_adam(FU.pack_weights(t_agent.net)), iteration=0)
    train_iteration = make_train_iteration(SimConfig(), hp, device="cpu",
                                           bf16_traj=True)
    rng = np.random.RandomState(23)
    for it in range(ITERS):
        pulse, noise, frozen_u, perms = _draws(rng, hp, T * W // WB)
        agent, sf, si, obs, stats, want = _jax_iteration(
            jcfg, hp, net, agent, None, sf, si, obs, stats,
            jnp.asarray(pulse), jnp.asarray(frozen_u), jnp.asarray(noise),
            rollout, gae, gb)
        assert want["traj"].dtype == jnp.bfloat16
        out = ufp(jnp.asarray(perms.reshape(-1)), adam.count, want["traj"],
                  want["side"], JFU.pack_norm(agent.obs_rms, D),
                  want["ustats"], *JFU.pack_weights(agent.params, D),
                  *JFU.pack_weights(adam.mu, D),
                  *JFU.pack_weights(adam.nu, D))
        agent = agent.replace(params=JFU.unpack_weights(agent.params,
                                                        *out[0:4], D))
        adam = adam._replace(count=adam.count + 4,
                             mu=JFU.unpack_weights(adam.mu, *out[4:8], D),
                             nu=JFU.unpack_weights(adam.nu, *out[8:12], D))

        state, got = train_iteration(
            state, CollectNoise(pulse=torch.tensor(pulse),
                                rollout=torch.tensor(noise)),
            perms=torch.tensor(perms))
        assert got["traj"].dtype == BF16
        traj = got["traj"].float().numpy()
        wtraj = np.asarray(want["traj"].astype(jnp.float32))
        acts = slice(JFR.R_ACT, JFR.R_ACT + 6)
        np.testing.assert_array_equal(traj[:, acts], wtraj[:, acts])
        np.testing.assert_array_equal(traj[:, JFR.R_DONE],
                                      wtraj[:, JFR.R_DONE])
        # one bf16 ulp: at most 2**-7 of the value
        np.testing.assert_allclose(traj, wtraj, rtol=2 ** -7, atol=1e-4)
        np.testing.assert_array_equal(state.si.numpy(), np.asarray(si))
        _close(state.sf, sf, atol=1e-5, rtol=1e-6)
        _close(state.obs, obs, atol=1e-5, rtol=1e-6)
        _close(got["side"], want["side"], rtol=1e-5, atol=1e-4)
        _close(got["ustats"], want["ustats"], rtol=1e-4, atol=1e-6)
        for k in ("obs_rms", "value_rms"):
            for f in ("mean", "var", "count"):
                _close(getattr(getattr(state.agent, k), f),
                       getattr(getattr(agent, k), f), rtol=1e-4, atol=1e-5)
        for k, v in want["metrics"].items():
            _close(got["metrics"][k], v, rtol=1e-4, atol=1e-5)
        assert state.opt.count == int(adam.count) == 4 * (it + 1)
        for name, g, w in (
                ("params", FU.pack_weights(state.agent.net),
                 JFU.pack_weights(agent.params, D)),
                ("mu", state.opt.mu, JFU.pack_weights(adam.mu, D)),
                ("nu", state.opt.nu, JFU.pack_weights(adam.nu, D))):
            for i, (a, b) in enumerate(zip(g, w)):
                _close(a, b, rtol=0, atol=1e-5, err_msg=f"{it} {name} {i}")


def test_bf16_traj_keeps_the_obs_normalizer_and_nudges_the_value_one():
    hp = PPOParams(**_hp_kw())
    rng = np.random.RandomState(4)
    draws = [_draws(rng, hp, T * W // WB) for _ in range(2)]
    runs = {}
    for bf in (False, True):
        state = init_train_state(SimConfig(), hp, seed=7, device="cpu")
        it = make_train_iteration(SimConfig(), hp, "cpu", bf16_traj=bf)
        outs = []
        for pulse, noise, _, perms in draws:
            state, out = it(state, CollectNoise(
                pulse=torch.tensor(pulse), rollout=torch.tensor(noise)),
                perms=torch.tensor(perms))
            outs.append(out)
        runs[bf] = (state, outs)
    (s32, o32), (s16, o16) = runs[False], runs[True]
    # the first iteration's rollout is the same: its rows rounded
    assert torch.equal(o16[0]["traj"].view(torch.int16),
                       o32[0]["traj"].to(BF16).view(torch.int16))
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(o16[0]["obs_rms"], f),
                           getattr(o32[0]["obs_rms"], f)), f
        torch.testing.assert_close(getattr(o16[0]["value_rms"], f),
                                   getattr(o32[0]["value_rms"], f),
                                   rtol=2e-2, atol=2e-2)
    assert not torch.equal(o16[0]["value_rms"].mean,
                           o32[0]["value_rms"].mean)
    for a, b in zip(FU.pack_weights(s16.agent.net),
                    FU.pack_weights(s32.agent.net)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=2e-3)
    # the train state keeps float32 leaves (.ckpt files stay the JAX ones)
    assert all(t.dtype != BF16 for t in state_tensors(s16))


def test_chunk_of_three_equals_three_eager_iterations():
    hp = PPOParams(num_envs=64, num_rollout_steps=4)
    it = make_train_iteration(SimConfig(), hp, "cpu", bf16_traj=True,
                              bf16_policy=True)
    state = init_train_state(SimConfig(), hp, seed=11, device="cpu")
    want = copy.deepcopy(state)
    metrics = []
    for _ in range(3):
        want, out = it(want)
        metrics.append(out["metrics"])
    got, stacked = TT.make_train_chunk(it, 3)(copy.deepcopy(state))
    for i, (x, y) in enumerate(zip(state_tensors(got), state_tensors(want))):
        assert torch.equal(x, y), i
    assert (got.counter, got.opt.count) == (want.counter, want.opt.count)
    for i in range(3):
        for k in METRICS:
            assert torch.equal(stacked[k][i], metrics[i][k]), k


# ---------------------------------------------------------------- refusals

# (make_train_iteration's path flags, the JAX check it trips)
REFUSED = [
    (dict(bf16_traj=True, rollout_tiled=True), "bf16_traj"),
    (dict(bf16_traj=True, fused_gae=False), "bf16_traj"),
    (dict(bf16_traj=True, fused_grads=False, fused_gae=False), "bf16_traj"),
    (dict(bf16_traj=True, rollout_kernel=False, fused_gae=False),
     "bf16_traj"),
    (dict(bf16_policy=True, rollout_tiled=True), "bf16_policy"),
    (dict(bf16_policy=True, rollout_kernel=False, fused_gae=False),
     "bf16_policy"),
]


def _jax_message(flags):
    net, _ = jagent.init_agent(jax.random.PRNGKey(0))
    kw = dict(rollout_kernel=True, fused_grads=True, fused_gae=True)
    kw.update(flags)
    with pytest.raises(ValueError) as e:
        JTF.make_train_iteration_fused(JSimConfig(), JPPOParams(), net,
                                       backend="pallas", **kw)
    return str(e.value)


@pytest.mark.parametrize("flags,check", REFUSED)
def test_check_paths_refuses_with_the_jax_message(flags, check):
    want = _jax_message(flags)
    assert want.startswith(check)
    kw = dict(rollout_kernel=True, fused_grads=True, fused_gae=True,
              rollout_tiled=False)
    kw.update(flags)
    with pytest.raises(ValueError) as e:
        check_paths(PPOParams(), "pallas", mesh=None, dp_update=False, **kw)
    assert str(e.value) == want
    hp = PPOParams(num_envs=1024, num_rollout_steps=2)
    with pytest.raises(ValueError) as e:
        make_train_iteration(SimConfig(), hp, "cpu", **flags)
    assert str(e.value) == want


@pytest.mark.parametrize("flags", [
    dict(bf16_traj=True, mesh=True), dict(bf16_traj=True, mesh=True,
                                          dp_update=True),
    dict(bf16_policy=True, fused_gae=False),
    dict(bf16_policy=True, fused_grads=False, fused_gae=False),
    dict(bf16_traj=True, bf16_policy=True)])
def test_check_paths_takes_the_paths_jax_takes(flags):
    kw = dict(rollout_kernel=True, fused_grads=True, fused_gae=True,
              rollout_tiled=False, mesh=None, dp_update=False)
    kw.update(flags)
    check_paths(PPOParams(), "pallas", **kw)


def test_iteration_takes_the_flags_on_a_mesh_of_one():
    """bf16_traj on the plain data-parallel path (the gathered trajectory
    is bf16, kernel E reads it) and under dp_update (kernel G reads each
    rank's bf16 blocks), in a world-size-1 gloo group, against the
    flagship's bf16_traj iteration on the same draws: the trajectory bit
    for bit on both; dp_update's obs normalizer (the rollout's fold) and
    learner bit for bit; the plain path's obs normalizer takes kernel E's
    moments of the rounded obs rows (as the JAX trainer's plain mesh
    does), within one bf16 ulp, 2**-7 of the value."""
    from tests import torch_dist_workers as DW
    hp = PPOParams(**_hp_kw())
    rng = np.random.RandomState(8)
    pulse, noise, _, perms = _draws(rng, hp, T * W // WB)
    draws = CollectNoise(pulse=torch.tensor(pulse),
                         rollout=torch.tensor(noise))

    def run(mesh=None, dp=False):
        from madrona_basketball_tpu_torch.parallel.mesh import \
            shard_train_state
        state = init_train_state(SimConfig(), hp, seed=2, device="cpu")
        if mesh is not None:
            state = shard_train_state(state, mesh, dp)
        it = make_train_iteration(SimConfig(), hp, "cpu", mesh=mesh,
                                  dp_update=dp, bf16_traj=True)
        p = torch.tensor(perms)[None] if dp else torch.tensor(perms)
        return it(state, draws, perms=p)

    flag_state, flag_out = run()
    with DW.single_group() as mesh:
        plain_state, plain_out = run(mesh)
        dp_state, dp_out = run(mesh, dp=True)
    for out in (plain_out, dp_out):
        assert out["traj"].dtype == BF16
        assert torch.equal(out["traj"].view(torch.int16),
                           flag_out["traj"].view(torch.int16))
    for f in ("mean", "var", "count"):
        want = getattr(flag_state.agent.obs_rms, f)
        assert torch.equal(getattr(dp_state.agent.obs_rms, f), want), f
        torch.testing.assert_close(getattr(plain_state.agent.obs_rms, f),
                                   want, rtol=2 ** -7, atol=1e-5)
    for a, b in zip(FU.pack_weights(dp_state.agent.net),
                    FU.pack_weights(flag_state.agent.net)):
        assert torch.equal(a, b)
