"""The whole slice: `make_collect(device="cpu")` with injected noise vs the
JAX pieces composed by hand exactly as ppo/train_fused.py:549-655
composes them (fused_step_xla reset pulse, the interpret-mode rollout
kernel, `evaluate`, the interpret-mode GAE kernel, `combine_block_moments`,
`_rms_merge`, `rms_update_padded_moments` and the meter scan), over two
iterations so the carried normalizers and episode stats are exercised;
with and without the frozen opponent, whose reset-pulse actions come
from `frozen_forward` (train_fused.py:200-205) on injected Gumbel draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import constants as C
from madrona_basketball_tpu import engine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.models import action as jaction
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.models.normalize import (EPS, _rms_merge,
                                                     rms_normalize,
                                                     rms_update_padded_moments)
from madrona_basketball_tpu.ops import fused_gae as JFG
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ops.fused_step import fused_step_xla
from madrona_basketball_tpu.ppo.train import _meter_update, init_stats

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_gae as TFG
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (CollectNoise,
                                                          RolloutState,
                                                          make_collect)
from madrona_basketball_tpu_torch.utils.jax_params import (agent_from_numpy,
                                                           rows_from_numpy)

W, T, TI, ITERS = 256, 6, 1, 2
OBS = C.OBS_SIZE


def _frozen_forward(net, frozen, obs_rows, u):
    """train_fused.py:200-205 with the Gumbel draws of `sample`
    (models/action.py:43) taken from the uniforms `u` (N_LOGITS, W)."""
    fi_lo = (1 - TI) * OBS
    x = rms_normalize(frozen.obs_rms, obs_rows[fi_lo:fi_lo + OBS].T,
                      clamp=5.0)
    logits, _ = net.apply(frozen.params, x)
    return jaction.best(logits + JFR.gumbel_from_uniform(u).T,
                        C.ACTION_BUCKETS)


def _jax_iteration(jcfg, hp, net, agent, frozen, sf, si, obs, stats, pulse,
                   frozen_u, noise, rollout, gae, gb):
    """ppo/train_fused.py:549-655, up to the update call."""
    for r in (JL.I_IDX["a0.reset"], JL.I_IDX["a1.reset"]):
        si = si.at[r].set(1)
    for n in JL.AGENT_I32[:6]:
        si = si.at[JL.I_IDX[f"a{TI}.{n}"]].set(0)
    mats = JFR.pack_policy(agent)
    if hp.use_frozen:
        fa = _frozen_forward(net, frozen, obs, frozen_u)
        for j, n in enumerate(JL.AGENT_I32[:6]):
            si = si.at[JL.I_IDX[f"a{1 - TI}.{n}"]].set(fa[:, j])
        mats = mats + JFR.pack_policy(frozen)
    sf, si, obs = fused_step_xla(jcfg, sf, si, pulse)
    for r in (JL.I_IDX["a0.reset"], JL.I_IDX["a1.reset"]):
        si = si.at[r].set(0)
    sf, si, obs, traj, om = rollout(noise, sf, si, obs, *mats)
    ti_lo = TI * OBS
    next_value = jagent.evaluate(net, agent, obs[ti_lo:ti_lo + OBS].T)
    vrm = agent.value_rms
    vstats = jnp.concatenate([vrm.mean[0].reshape(1, 1),
                              jnp.sqrt(vrm.var[0] + EPS).reshape(1, 1),
                              jnp.zeros((1, 6), jnp.float32)], axis=1)
    carry = jnp.stack([stats.curr_rewards, stats.episode_lengths])
    side, moments, carry_out, ticks = gae(traj, carry, next_value[None, :],
                                          vstats)
    per_t = jnp.sum(ticks, axis=0)
    rm, rs, lm, ls = (stats.mean_reward, stats.reward_size,
                      stats.mean_length, stats.length_size)
    for t in range(T):
        rm, rs = _meter_update(rm, rs, per_t[t, 1], per_t[t, 0])
        lm, ls = _meter_update(lm, ls, per_t[t, 2], per_t[t, 0])
    stats = stats.replace(curr_rewards=carry_out[0],
                          episode_lengths=carry_out[1], mean_reward=rm,
                          reward_size=rs, mean_length=lm, length_size=ls)
    n_per = float(T * gb)
    vm_b, vv_b, nN = JFG.combine_block_moments(moments[:, 0], moments[:, 1],
                                               n_per)
    am_b, av_b, _ = JFG.combine_block_moments(moments[:, 2], moments[:, 3],
                                              n_per)
    rm_b, rv_b, _ = JFG.combine_block_moments(moments[:, 4], moments[:, 5],
                                              n_per)
    value_rms = _rms_merge(vrm, vm_b.reshape(1), vv_b.reshape(1), nN)
    value_rms = _rms_merge(value_rms, rm_b.reshape(1), rv_b.reshape(1), nN)
    ar = 1.0 / (jnp.sqrt(av_b) + 1e-8)
    vr_post = jax.lax.rsqrt(value_rms.var[0] + EPS)
    ustats = jnp.array([[value_rms.mean[0], vr_post, am_b, ar, 0, 0, 0, 0]],
                       jnp.float32)
    obs_rms = rms_update_padded_moments(agent.obs_rms, om[:, 0], om[:, 1],
                                        om[0, 2])
    adv_n = (side[:, 1, :] - am_b) * ar
    values_n = jnp.clip((side[:, 0, :] - value_rms.mean[0]) * vr_post,
                        -5.0, 5.0)
    metrics = {"mean_reward": stats.mean_reward,
               "mean_episode_length": stats.mean_length,
               "reward_window": stats.reward_size,
               "adv_abs_mean": jnp.abs(adv_n).mean(),
               "value_mean": values_n.mean()}
    agent = agent.replace(obs_rms=obs_rms, value_rms=value_rms)
    out = dict(traj=traj, side=side, ustats=ustats, obs_rms=obs_rms,
               value_rms=value_rms, stats=stats, metrics=metrics)
    return agent, sf, si, obs, stats, out


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **kw)


@pytest.mark.parametrize("use_frozen", [False, True])
def test_collect_matches_composed_jax_path(use_frozen):
    jcfg = JSimConfig()
    hp = PPOParams(num_envs=W, num_rollout_steps=T, trainee_idx=TI,
                   use_frozen=use_frozen)
    net, agent = jagent.init_agent(jax.random.PRNGKey(2))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(3))
    sf, si = JL.pack(engine.init_batch(jcfg, jax.random.PRNGKey(4), W))
    obs = jnp.zeros((JL.N_OBS_ROWS, W), jnp.float32)
    stats = init_stats(W)
    gb = TFG.pick_gae_block(W)
    rollout = JFR.make_fused_rollout(jcfg, W, T, trainee_idx=TI,
                                     use_frozen=use_frozen, block=128,
                                     interpret=True, external_noise=True,
                                     obs_moments=True)
    gae = JFG.make_fused_gae(T, W, hp.gamma, hp.gae_lambda, JFR.R_VALUE,
                             JFR.R_REW, JFR.R_DONE, gb=gb, interpret=True)

    np_tree = jax.tree.map(np.asarray, agent)
    state = RolloutState(
        agent=agent_from_numpy(np_tree, "cpu"),
        frozen=agent_from_numpy(jax.tree.map(np.asarray, frozen), "cpu"),
        sf=rows_from_numpy(np.asarray(sf), device="cpu"),
        si=rows_from_numpy(np.asarray(si), device="cpu"),
        obs=torch.zeros((JL.N_OBS_ROWS, W)),
        stats=TT.init_stats(W, "cpu"), seed=0, counter=0)
    collect = make_collect(SimConfig(), hp, device="cpu")

    rng = np.random.RandomState(17)
    marks = []
    for it in range(ITERS):
        pulse = np.concatenate([rng.uniform(-1, 1, (8, W)),
                                rng.uniform(0, 1, (1, W))]).astype(np.float32)
        noise = rng.uniform(0, 1, (T * JFR.EXT_NOISE_CHUNK, W))
        row = np.arange(T * JFR.EXT_NOISE_CHUNK) % JFR.EXT_NOISE_CHUNK
        noise = np.where((row < 8)[:, None], 2 * noise - 1, noise)
        noise = noise.astype(np.float32)
        frozen_u = rng.uniform(0, 1, (JFR.N_LOGITS, W)).astype(np.float32)
        agent, sf, si, obs, stats, want = _jax_iteration(
            jcfg, hp, net, agent, frozen, sf, si, obs, stats,
            jnp.asarray(pulse), jnp.asarray(frozen_u), jnp.asarray(noise),
            rollout, gae, gb)
        state, got = collect(state, CollectNoise(
            pulse=torch.tensor(pulse), rollout=torch.tensor(noise),
            pulse_frozen_u=torch.tensor(frozen_u) if use_frozen else None),
            mark=marks.append)

        traj, wtraj = got["traj"].numpy(), np.asarray(want["traj"])
        acts = slice(JFR.R_ACT, JFR.R_ACT + 6)
        np.testing.assert_array_equal(traj[:, acts], wtraj[:, acts])
        np.testing.assert_array_equal(traj[:, JFR.R_DONE],
                                      wtraj[:, JFR.R_DONE])
        np.testing.assert_allclose(traj, wtraj, atol=1e-4)
        np.testing.assert_array_equal(state.si.numpy(), np.asarray(si))
        # with the frozen opponent passing and shooting, the ball's flight
        # carries the per-tick 1-ulp differences of XLA's CPU sin/cos
        # against torch's over 14 ticks: 1.1e-5 at 11.7 m (~12 ulp) seen
        state_rtol = 1e-6 if use_frozen else 1e-7
        _close(state.sf, sf, atol=1e-5, rtol=state_rtol)
        _close(state.obs, obs, atol=1e-5, rtol=state_rtol)
        _close(got["side"], want["side"], rtol=1e-5, atol=1e-4)
        _close(got["ustats"], want["ustats"], rtol=1e-4, atol=1e-6)
        for k in ("obs_rms", "value_rms"):
            for f in ("mean", "var", "count"):
                _close(getattr(got[k], f), getattr(want[k], f), rtol=1e-4,
                       atol=1e-5)
        for f in ("curr_rewards", "episode_lengths", "mean_reward",
                  "reward_size", "mean_length", "length_size"):
            _close(getattr(got["stats"], f), getattr(want["stats"], f),
                   rtol=1e-5, atol=1e-4)
        for k, v in want["metrics"].items():
            _close(got["metrics"][k], v, rtol=1e-4, atol=1e-5)
        assert float(got["obs_rms"].count) == 1.0 + (it + 1) * T * W
        assert float(got["value_rms"].count) == 1.0 + (it + 1) * 2 * T * W
    assert state.counter == ITERS
    assert marks == ["reset_pulse", "rollout", "gae", "glue"] * ITERS


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from madrona_basketball_tpu_torch.ppo.train_fused import \
        init_rollout_state
    with pytest.raises(RuntimeError):
        init_rollout_state(SimConfig(), PPOParams(num_envs=64), seed=0)
