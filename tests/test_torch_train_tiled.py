"""The `--rollout-tiled` iteration: `make_train_iteration(device="cpu",
rollout_tiled=True)` with injected noise and block permutations vs the
JAX path composed by hand as ppo/train_fused.py composes it with
rollout_tiled=True: the collect of tests/test_torch_collect.py
(`_jax_iteration`, T = 6 ticks, trainee 1) with the interpret-mode tiled
rollout, whose obs moments come from the separate interpret-mode
`make_obs_moments` (train_fused.py:403-406,640), then
`make_fused_update_phase(interpret=True, raw_side=True)` on the same
permutations, at 1024 worlds (the tiled kernel's multiple), one
iteration.  Tolerances as tests/test_torch_train.py.  The JAX update
phase runs on the port's collect outputs (trajectory, side rows, ustats,
obs normalizer), which are held to the JAX collect's first: at this
width the game and shot clocks, identical in every world, vary only with
the tick, so their normalized columns give near-cancelling gradient
sums, and a last-ulp difference of the obs normalizer (the collects' sin
and cos round differently) flips their sign, which Adam turns into
whole steps of the learning rate (6.8e-4 on the first layer, measured).

Also the port's tiled iteration against its flagship iteration on the
same injected draws, the counterpart of tests/test_rollout_kernel.py::
test_trainer_tiled_matches_1d: kernels I and B compute the same
trajectory, kernel E the moments kernel B folds, so params, Adam moments
and metrics agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from madrona_basketball_tpu import engine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.ops import fused_gae as JFG
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import init_stats, make_optimizer

from madrona_basketball_tpu_torch import constants as C
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_gae as TFG
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (CollectNoise,
                                                          TrainState,
                                                          init_train_state,
                                                          make_train_iteration)
from madrona_basketball_tpu_torch.utils.jax_params import (agent_from_numpy,
                                                           rows_from_numpy)
from tests import torch_threads  # noqa: F401
from tests.test_torch_collect import T, TI, _jax_iteration

W = 1024
D = C.OBS_USED
KW = dict(num_envs=W, num_rollout_steps=T, trainee_idx=TI, use_frozen=False,
          num_minibatches=2, update_epochs=2)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **kw)


def _draws(rng, n_blocks, epochs):
    pulse = np.concatenate([rng.uniform(-1, 1, (8, W)),
                            rng.uniform(0, 1, (1, W))]).astype(np.float32)
    noise = rng.uniform(0, 1, (T * JFR.EXT_NOISE_CHUNK, W))
    row = np.arange(T * JFR.EXT_NOISE_CHUNK) % JFR.EXT_NOISE_CHUNK
    noise = np.where((row < 8)[:, None], 2 * noise - 1, noise)
    perms = np.stack([rng.permutation(n_blocks)
                      for _ in range(epochs)]).astype(np.int32)
    return pulse, noise.astype(np.float32), perms


def test_tiled_iteration_matches_composed_jax_path():
    jhp, hp = JPPOParams(**KW), PPOParams(**KW)
    jcfg = JSimConfig()
    net, agent = jagent.init_agent(jax.random.PRNGKey(5))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(6))
    sf, si = JL.pack(engine.init_batch(jcfg, jax.random.PRNGKey(7), W))
    obs = jnp.zeros((JL.N_OBS_ROWS, W), jnp.float32)
    stats = init_stats(W)
    gb = TFG.pick_gae_block(W)
    wb = FU.pick_update_block(W, hp.minibatch_size)
    tiled = JFR.make_fused_rollout_tiled(jcfg, W, T, trainee_idx=TI,
                                         use_frozen=False, block=1024,
                                         interpret=True, external_noise=True)
    moments = JFG.make_obs_moments(T, W, JFR.ROLL_OBS, interpret=True)

    def rollout(noise, sf, si, obs, *mats):
        sf, si, obs, traj = tiled(noise, sf, si, obs, *mats)
        return sf, si, obs, traj, moments(traj)
    gae = JFG.make_fused_gae(T, W, hp.gamma, hp.gae_lambda, JFR.R_VALUE,
                             JFR.R_REW, JFR.R_DONE, gb=gb, interpret=True)
    ufp = JFU.make_fused_update_phase(jhp, D, T, W, wb, interpret=True,
                                      raw_side=True)
    adam = make_optimizer(jhp).init(agent.params)[1][0]

    t_agent = agent_from_numpy(jax.tree.map(np.asarray, agent), "cpu")
    state = TrainState(
        agent=t_agent,
        frozen=agent_from_numpy(jax.tree.map(np.asarray, frozen), "cpu"),
        sf=rows_from_numpy(np.asarray(sf), device="cpu"),
        si=rows_from_numpy(np.asarray(si), device="cpu"),
        obs=torch.zeros((JL.N_OBS_ROWS, W)),
        stats=TT.init_stats(W, "cpu"), seed=0, counter=0,
        opt=TT.init_adam(FU.pack_weights(t_agent.net)), iteration=0)
    train_iteration = make_train_iteration(SimConfig(), hp, device="cpu",
                                           rollout_tiled=True)

    pulse, noise, perms = _draws(np.random.RandomState(31), T * W // wb,
                                 hp.update_epochs)
    frozen_u = np.zeros((JFR.N_LOGITS, W), np.float32)
    agent, sf, si, obs, stats, want = _jax_iteration(
        jcfg, hp, net, agent, frozen, sf, si, obs, stats,
        jnp.asarray(pulse), jnp.asarray(frozen_u), jnp.asarray(noise),
        rollout, gae, gb)
    marks = []
    state, got = train_iteration(
        state, CollectNoise(pulse=torch.tensor(pulse),
                            rollout=torch.tensor(noise)),
        perms=torch.tensor(perms), mark=marks.append)
    t_rms = state.agent.obs_rms
    j_rms = agent.obs_rms.replace(
        mean=jnp.asarray(t_rms.mean.numpy()),
        var=jnp.asarray(t_rms.var.numpy()),
        count=jnp.asarray(t_rms.count.numpy()))
    out = ufp(jnp.asarray(perms.reshape(-1)), adam.count,
              jnp.asarray(got["traj"].numpy()),
              jnp.asarray(got["side"].numpy()), JFU.pack_norm(j_rms, D),
              jnp.asarray(got["ustats"].numpy()),
              *JFU.pack_weights(agent.params, D),
              *JFU.pack_weights(adam.mu, D), *JFU.pack_weights(adam.nu, D))

    assert marks == ["reset_pulse", "rollout", "gae", "obs_moments", "glue",
                     "update"]
    traj, wtraj = got["traj"].numpy(), np.asarray(want["traj"])
    acts = slice(JFR.R_ACT, JFR.R_ACT + 6)
    np.testing.assert_array_equal(traj[:, acts], wtraj[:, acts])
    np.testing.assert_array_equal(traj[:, JFR.R_DONE], wtraj[:, JFR.R_DONE])
    np.testing.assert_allclose(traj, wtraj, atol=1e-4)
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
    n_up = hp.update_epochs * hp.num_minibatches
    assert state.opt.count == n_up
    for name, g, w in (
            ("params", FU.pack_weights(state.agent.net), out[0:4]),
            ("mu", state.opt.mu, out[4:8]), ("nu", state.opt.nu, out[8:12])):
        for i, (a, b) in enumerate(zip(g, w)):
            _close(a, b, rtol=0, atol=1e-5, err_msg=f"{name} {i}")


def test_tiled_iteration_matches_the_flagship_iteration():
    hp = PPOParams(**KW)
    wb = FU.pick_update_block(W, hp.minibatch_size)
    pulse, noise, perms = _draws(np.random.RandomState(32), T * W // wb,
                                 hp.update_epochs)
    results = []
    for tiled in (False, True):
        state = init_train_state(SimConfig(), hp, seed=9, device="cpu")
        it = make_train_iteration(SimConfig(), hp, device="cpu",
                                  rollout_tiled=tiled)
        results.append(it(state, CollectNoise(pulse=torch.tensor(pulse),
                                              rollout=torch.tensor(noise)),
                          perms=torch.tensor(perms)))
    (sa, oa), (sb, ob) = results
    assert torch.equal(oa["traj"], ob["traj"])
    for name, a, b in (("params", FU.pack_weights(sa.agent.net),
                        FU.pack_weights(sb.agent.net)),
                       ("mu", sa.opt.mu, sb.opt.mu),
                       ("nu", sa.opt.nu, sb.opt.nu)):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y.numpy(), rtol=0, atol=1e-5, err_msg=f"{name} {i}")
    for f in ("mean", "var", "count"):
        _close(getattr(sa.agent.obs_rms, f),
               getattr(sb.agent.obs_rms, f).numpy(), rtol=1e-5, atol=1e-6)
    for k in oa["metrics"]:
        _close(oa["metrics"][k], ob["metrics"][k].numpy(), rtol=1e-5,
               atol=1e-6)
