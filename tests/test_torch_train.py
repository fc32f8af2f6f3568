"""The whole flagship iteration: `make_train_iteration(device="cpu")` with
injected noise and block permutations vs the JAX path composed by hand,
exactly as ppo/train_fused.py:547-677 composes it: the collect of
tests/test_torch_collect.py (`_jax_iteration`, whose module fixes T = 6
ticks and trainee 1), then `make_fused_update_phase(interpret=True,
raw_side=True)` on the same permutations with the post-collect obs
normalizer, as `update_policy_traj` (train_fused.py:521-545) calls it.
Two chained iterations with the frozen opponent, so the second collect
runs on updated weights.  The iteration has no branch of its own on the
frozen opponent (the collect without it is held in
tests/test_torch_collect.py), and each setting compiles its own
interpret-mode rollout, ~20 s of JAX on the CPU.

Tolerances: the collect's outputs as tests/test_torch_collect.py holds
them; params, Adam mu and nu 1e-5 absolute; sampled actions, dones and the
Adam count exact."""

import dataclasses

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
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import init_stats, make_optimizer

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_gae as TFG
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (CollectNoise,
                                                          TrainState,
                                                          make_train_iteration)
from madrona_basketball_tpu_torch.utils.jax_params import (agent_from_numpy,
                                                           rows_from_numpy)
from tests.test_torch_collect import T, TI, _jax_iteration

W, WB, ITERS = 32, 8, 2
D = C.OBS_USED


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **kw)


def test_train_iteration_matches_composed_jax_path():
    kw = dict(num_envs=W, num_rollout_steps=T, trainee_idx=TI,
              use_frozen=True, num_minibatches=2, update_epochs=2,
              update_block=WB)
    jhp, hp = JPPOParams(**kw), PPOParams(**kw)
    jcfg = JSimConfig()
    net, agent = jagent.init_agent(jax.random.PRNGKey(5))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(6))
    sf, si = JL.pack(engine.init_batch(jcfg, jax.random.PRNGKey(7), W))
    obs = jnp.zeros((JL.N_OBS_ROWS, W), jnp.float32)
    stats = init_stats(W)
    gb = TFG.pick_gae_block(W)
    # jitted, so that the second iteration reuses the first's compile
    rollout = jax.jit(JFR.make_fused_rollout(
        jcfg, W, T, trainee_idx=TI, use_frozen=True, block=128,
        interpret=True, external_noise=True, obs_moments=True))
    gae = jax.jit(JFG.make_fused_gae(T, W, hp.gamma, hp.gae_lambda,
                                     JFR.R_VALUE, JFR.R_REW, JFR.R_DONE,
                                     gb=gb, interpret=True))
    ufp = jax.jit(JFU.make_fused_update_phase(jhp, D, T, W, WB,
                                              interpret=True, raw_side=True))
    opt = make_optimizer(jhp).init(agent.params)
    adam = opt[1][0]

    t_agent = agent_from_numpy(jax.tree.map(np.asarray, agent), "cpu")
    state = TrainState(
        agent=t_agent,
        frozen=agent_from_numpy(jax.tree.map(np.asarray, frozen), "cpu"),
        sf=rows_from_numpy(np.asarray(sf), device="cpu"),
        si=rows_from_numpy(np.asarray(si), device="cpu"),
        obs=torch.zeros((JL.N_OBS_ROWS, W)),
        stats=TT.init_stats(W, "cpu"), seed=0, counter=0,
        opt=TT.init_adam(FU.pack_weights(t_agent.net)), iteration=0)
    train_iteration = make_train_iteration(SimConfig(), hp, device="cpu")

    rng = np.random.RandomState(23)
    n_blocks = T * W // WB
    marks = []
    for it in range(ITERS):
        pulse = np.concatenate([rng.uniform(-1, 1, (8, W)),
                                rng.uniform(0, 1, (1, W))]).astype(np.float32)
        noise = rng.uniform(0, 1, (T * JFR.EXT_NOISE_CHUNK, W))
        row = np.arange(T * JFR.EXT_NOISE_CHUNK) % JFR.EXT_NOISE_CHUNK
        noise = np.where((row < 8)[:, None], 2 * noise - 1, noise)
        noise = noise.astype(np.float32)
        frozen_u = rng.uniform(0, 1, (JFR.N_LOGITS, W)).astype(np.float32)
        perms = np.stack([rng.permutation(n_blocks)
                          for _ in range(hp.update_epochs)]).astype(np.int32)

        # ---- JAX: the collect, then update_policy_traj
        agent, sf, si, obs, stats, want = _jax_iteration(
            jcfg, hp, net, agent, frozen, sf, si, obs, stats,
            jnp.asarray(pulse), jnp.asarray(frozen_u), jnp.asarray(noise),
            rollout, gae, gb)
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

        # ---- the port
        state, got = train_iteration(
            state, CollectNoise(
                pulse=torch.tensor(pulse), rollout=torch.tensor(noise),
                pulse_frozen_u=torch.tensor(frozen_u)),
            perms=torch.tensor(perms), mark=marks.append)

        traj, wtraj = got["traj"].numpy(), np.asarray(want["traj"])
        acts = slice(JFR.R_ACT, JFR.R_ACT + 6)
        np.testing.assert_array_equal(traj[:, acts], wtraj[:, acts])
        np.testing.assert_array_equal(traj[:, JFR.R_DONE],
                                      wtraj[:, JFR.R_DONE])
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

        assert state.opt.count == int(adam.count) == 4 * (it + 1)
        assert state.iteration == state.counter == it + 1
        for name, g, w in (
                ("params", FU.pack_weights(state.agent.net),
                 JFU.pack_weights(agent.params, D)),
                ("mu", state.opt.mu, JFU.pack_weights(adam.mu, D)),
                ("nu", state.opt.nu, JFU.pack_weights(adam.nu, D))):
            for i, (a, b) in enumerate(zip(g, w)):
                _close(a, b, rtol=0, atol=1e-5, err_msg=f"{it} {name} {i}")
        # the structural-zero obs tail of the first layer is carried over
        full = np.asarray(agent.params["params"]["Dense_0"]["kernel"]).T
        _close(state.agent.net.backbone[0].weight, full, rtol=0, atol=1e-5)
    assert marks == ["reset_pulse", "rollout", "gae", "glue",
                     "update"] * ITERS


def test_train_iteration_checks_its_geometry():
    bad = PPOParams(num_envs=32, num_rollout_steps=6, num_minibatches=5)
    with pytest.raises(ValueError, match="num_minibatches"):
        make_train_iteration(SimConfig(), bad, device="cpu")
    bad = PPOParams(num_envs=32, num_rollout_steps=6, num_minibatches=2,
                    update_block=12)
    with pytest.raises(ValueError, match="update_block"):
        make_train_iteration(SimConfig(), bad, device="cpu")
    hp = PPOParams(num_envs=32, num_rollout_steps=6, num_minibatches=2,
                   update_epochs=2, update_block=8)
    it = make_train_iteration(SimConfig(), hp, device="cpu")
    from madrona_basketball_tpu_torch.ppo.train_fused import init_train_state
    st = init_train_state(SimConfig(), hp, seed=0, device="cpu")
    with pytest.raises(ValueError, match="perms"):
        it(st, perms=torch.zeros((2, 5), dtype=torch.int32))
    st2, _ = it(dataclasses.replace(st))
    assert st2.opt.count == 4 and st2.iteration == 1
