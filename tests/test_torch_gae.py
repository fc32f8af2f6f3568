"""`gae_plain` (and `fused_gae` on CPU tensors) vs the JAX GAE kernel
`make_fused_gae(interpret=True)` run with the port's world block, and vs
the unfused reference `ops/gae.compute_gae` + `ppo/train._stats_step`
(the contract of tests/test_fused_gae.py); the meter scan that consumes
the kernel's per-tick sums vs the JAX scan of ppo/train_fused.py:602-615."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.models.normalize import EPS
from madrona_basketball_tpu.ops import fused_gae as JFG
from madrona_basketball_tpu.ops.gae import compute_gae as j_compute_gae
from madrona_basketball_tpu.ppo.train import EpisodeStats as JStats
from madrona_basketball_tpu.ppo.train import _meter_update as j_meter_update
from madrona_basketball_tpu.ppo.train import _stats_step as j_stats_step

from madrona_basketball_tpu_torch.ops import fused_gae as TFG
from madrona_basketball_tpu_torch.ops.gae import compute_gae
from madrona_basketball_tpu_torch.ppo import train as TT

T, W, ROWS = 8, 256, 16
RV, RR, RD = 3, 5, 7
GAMMA, LAM = 0.998, 0.95


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    traj = rng.uniform(-4, 4, (T, ROWS, W)).astype(np.float32)
    traj[:, RV] = rng.uniform(-6, 6, (T, W))
    traj[:, RR] = rng.uniform(-120, 20, (T, W))
    traj[:, RD] = rng.uniform(size=(T, W)) < 0.05
    carry = rng.uniform(0, 50, (2, W)).astype(np.float32)
    nv = rng.uniform(-6, 6, (1, W)).astype(np.float32)
    vstats = np.zeros((1, 8), np.float32)
    vstats[0, 0] = -80.0
    vstats[0, 1] = np.sqrt(np.float32(900.0) + np.float32(EPS))
    return traj, carry, nv, vstats


@pytest.mark.parametrize("fn", ["gae_plain", "fused_gae"])
def test_gae_matches_pallas_interpret(fn):
    traj, carry, nv, vstats = _inputs()
    gb = TFG.pick_gae_block(W)
    want = [np.asarray(x) for x in JFG.make_fused_gae(
        T, W, GAMMA, LAM, RV, RR, RD, gb=gb, interpret=True)(
        jnp.asarray(traj), jnp.asarray(carry), jnp.asarray(nv),
        jnp.asarray(vstats))]
    got = [x.numpy() for x in getattr(TFG, fn)(
        torch.tensor(traj), torch.tensor(carry), torch.tensor(nv),
        torch.tensor(vstats), gamma=GAMMA, lam=LAM, r_value=RV, r_rew=RR,
        r_done=RD)]
    side, mom, carry_out, ticks = got
    np.testing.assert_allclose(side, want[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mom[:, 0::2], want[1][:, 0::2], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(mom[:, 1::2], want[1][:, 1::2], rtol=1e-4)
    np.testing.assert_allclose(carry_out, want[2], rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(ticks[..., 0], want[3][..., 0])
    np.testing.assert_allclose(ticks, want[3], rtol=1e-5, atol=1e-3)


def test_gae_matches_unfused_reference():
    traj, carry, nv, vstats = _inputs(seed=4)
    side, mom, carry_out, ticks = TFG.gae_plain(
        torch.tensor(traj), torch.tensor(carry), torch.tensor(nv),
        torch.tensor(vstats), gamma=GAMMA, lam=LAM, r_value=RV, r_rew=RR,
        r_done=RD)
    vm, vs = float(vstats[0, 0]), float(vstats[0, 1])
    v_un = vm + vs * np.clip(traj[:, RV], -5, 5)
    nv_un = vm + vs * np.clip(nv[0], -5, 5)
    adv, ret = j_compute_gae(jnp.asarray(traj[:, RR]), jnp.asarray(v_un),
                             jnp.asarray(1.0 - traj[:, RD]),
                             jnp.asarray(nv_un), GAMMA, LAM)
    np.testing.assert_allclose(side[:, TFG.SIDE_ADV].numpy(),
                               np.asarray(adv), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(side[:, TFG.SIDE_RET].numpy(),
                               np.asarray(ret), rtol=1e-5, atol=1e-3)
    tadv, tret = compute_gae(torch.tensor(traj[:, RR]), torch.tensor(v_un),
                             torch.tensor(1.0 - traj[:, RD]),
                             torch.tensor(nv_un), GAMMA, LAM)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(adv), rtol=1e-5,
                               atol=1e-3)
    gb = TFG.pick_gae_block(W)
    for col, x in ((0, v_un), (2, np.asarray(adv)), (4, np.asarray(ret))):
        m, var, n = TFG.combine_block_moments(mom[:, col], mom[:, col + 1],
                                              float(T * gb))
        assert n == T * W
        np.testing.assert_allclose(float(m), x.mean(), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(float(var), x.astype(np.float64).var(
            ddof=1), rtol=1e-4)

    # episode stats: carry + per-tick partials + meter scan == _stats_step
    st0 = dict(curr_rewards=carry[0], episode_lengths=carry[1],
               mean_reward=np.float32(-3.0), reward_size=np.float32(40.0),
               mean_length=np.float32(120.0), length_size=np.float32(40.0))
    jst = JStats(**{k: jnp.asarray(v) for k, v in st0.items()})
    tst = TT.EpisodeStats(**{k: torch.tensor(v) for k, v in st0.items()})
    for t in range(T):
        jst = j_stats_step(jst, jnp.asarray(traj[t, RR]),
                           jnp.asarray(traj[t, RD]))
        tst = TT._stats_step(tst, torch.tensor(traj[t, RR]),
                             torch.tensor(traj[t, RD]))
    m = TT.meter_scan(ticks, torch.tensor([-3.0, 40.0, 120.0, 40.0]))
    r, ln = m[0:2], m[2:4]
    np.testing.assert_allclose(carry_out[0].numpy(),
                               np.asarray(jst.curr_rewards), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(carry_out[1].numpy(),
                               np.asarray(jst.episode_lengths))
    for got, want in ((r[0], jst.mean_reward), (r[1], jst.reward_size),
                      (ln[0], jst.mean_length), (ln[1], jst.length_size),
                      (tst.mean_reward, jst.mean_reward),
                      (tst.mean_length, jst.mean_length)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_chan_fold_matches_numpy_moments():
    rows, n_tiles, tile = 9, 13, 32
    x = np.random.RandomState(11).uniform(-50, 50, (rows, n_tiles * tile))
    x = x.astype(np.float32)
    acc = None
    for i in range(n_tiles):
        acc = TFG.chan_fold(acc, torch.tensor(x[:, i * tile:(i + 1) * tile]))
    np.testing.assert_allclose(acc[:, 0].numpy(), x.mean(1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(acc[:, 1].numpy(),
                               ((x - x.mean(1, keepdims=True)) ** 2).sum(1),
                               rtol=1e-4)
    assert np.all(acc[:, 2].numpy() == n_tiles * tile)
    assert not np.any(acc[:, 3:].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_meter_scan_matches_jax_scan(seed):
    """Ticks with no episode end (the meter keeps its value), ticks past
    the 100-episode window, and a fresh meter (size 0)."""
    rng = np.random.RandomState(seed)
    nb = 6
    ticks = np.zeros((nb, T, 8), np.float32)
    count = rng.randint(0, 3, (nb, T)) * (rng.uniform(size=(nb, T)) < 0.6)
    count[:, T // 2] = 30                       # 180 ends: window overflow
    ticks[..., 0] = count
    ticks[..., 1] = count * rng.uniform(-60, 10, (nb, T))
    ticks[..., 2] = count * rng.uniform(1, 400, (nb, T))
    meters = np.array([-4.5, 0.0 if seed else 73.0, 88.0,
                       0.0 if seed else 73.0], np.float32)

    per_t = jnp.sum(jnp.asarray(ticks), axis=0)
    rm, rs, lm, ls = (jnp.float32(x) for x in meters)
    for t in range(T):
        rm, rs = j_meter_update(rm, rs, per_t[t, 1], per_t[t, 0])
        lm, ls = j_meter_update(lm, ls, per_t[t, 2], per_t[t, 0])
    want = np.array([rm, rs, lm, ls], np.float32)
    for fn in (TT.meter_scan, TT.meter_scan_plain):
        got = fn(torch.tensor(ticks), torch.tensor(meters)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert want[1] == 100.0 and want[3] == 100.0
