"""`rollout_plain` (and `fused_rollout` on CPU tensors) vs the JAX rollout
kernel `make_fused_rollout(interpret=True, external_noise=True,
obs_moments=True)`, with and without the frozen policy, on identical
injected noise (the contract of tests/test_rollout_kernel.py:65-149):
actions and integer state exact, obs / reward / state 1e-5, logp and
value 1e-4, obs moments 1e-5 relative.

Also the plain Philox4x32-10: known-answer vectors of a numpy reference
implementation, agreement of the torch twin with it, the [0, 1) mapping,
and the composition property (one T-tick launch == T one-tick launches)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import engine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ops.fused_step import fused_step_xla

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy
from tests import torch_threads  # noqa: F401

W, T, TI = 256, 4, 1
NL = TFR.N_LOGITS


def _setup(seed=21):
    cfg = JSimConfig()
    _, agent = jagent.init_agent(jax.random.PRNGKey(11))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(12))
    sf, si = JL.pack(engine.init_batch(cfg, jax.random.PRNGKey(5), W))
    rng = np.random.RandomState(seed)

    def sim_noise():
        return np.concatenate([rng.uniform(-1, 1, (8, W)),
                               rng.uniform(0, 1, (1, W))]).astype(np.float32)

    sf, si, obs0 = fused_step_xla(cfg, sf, si, jnp.asarray(sim_noise()))
    chunks = [sim_noise() for _ in range(T)]
    t_u = rng.uniform(0, 1, (T, NL, W)).astype(np.float32)
    f_u = rng.uniform(0, 1, (T, NL, W)).astype(np.float32)
    t_u[0, :, :3] = 0.0  # exercise the u == 0 guard
    noise = np.asarray(JFR.pack_rollout_noise(
        [jnp.asarray(c) for c in chunks], jnp.asarray(t_u),
        jnp.asarray(f_u)))
    return cfg, agent, frozen, (sf, si, obs0), noise


@pytest.mark.parametrize("use_frozen", [False, True])
def test_rollout_plain_matches_pallas_interpret(use_frozen):
    jcfg, agent, frozen, (sf, si, obs0), noise = _setup()
    rollout = JFR.make_fused_rollout(jcfg, W, T, trainee_idx=TI,
                                     use_frozen=use_frozen, block=128,
                                     interpret=True, external_noise=True,
                                     obs_moments=True)
    mats = JFR.pack_policy(agent) + (JFR.pack_policy(frozen) if use_frozen
                                     else ())
    want = [np.asarray(x) for x in rollout(jnp.asarray(noise), sf, si, obs0,
                                           *mats)]

    ta = agent_from_numpy(jax.tree.map(np.asarray, agent), "cpu")
    tf = agent_from_numpy(jax.tree.map(np.asarray, frozen), "cpu")
    args = (SimConfig(), torch.tensor(np.asarray(sf)),
            torch.tensor(np.asarray(si)), torch.tensor(np.asarray(obs0)),
            TFR.pack_policy(ta), TFR.pack_policy(tf) if use_frozen else None)
    got = [x.numpy() for x in TFR.rollout_plain(
        *args, n_steps=T, trainee_idx=TI, noise=torch.tensor(noise))]
    wrapped = TFR.fused_rollout(*args, n_steps=T, trainee_idx=TI,
                                noise=torch.tensor(noise))
    for a, b in zip(got, wrapped):
        np.testing.assert_array_equal(a, b.numpy())

    sf_k, si_k, obs_k, traj_k, mom_k = want
    sf_t, si_t, obs_t, traj_t, mom_t = got
    acts = slice(TFR.R_ACT, TFR.R_ACT + 6)
    np.testing.assert_array_equal(traj_t[:, acts], traj_k[:, acts])
    np.testing.assert_allclose(traj_t[:, :TFR.ROLL_OBS],
                               traj_k[:, :TFR.ROLL_OBS], atol=1e-5)
    for r in (TFR.R_LOGP, TFR.R_VALUE):
        np.testing.assert_allclose(traj_t[:, r], traj_k[:, r], atol=1e-4)
    np.testing.assert_allclose(traj_t[:, TFR.R_REW], traj_k[:, TFR.R_REW],
                               atol=1e-5)
    np.testing.assert_array_equal(traj_t[:, TFR.R_DONE],
                                  traj_k[:, TFR.R_DONE])
    pad = [TFR.R_LOGP + 1, TFR.R_LOGP + 2] + list(range(TFR.R_DONE + 1, 128))
    assert not np.any(traj_t[:, pad])
    np.testing.assert_array_equal(si_t, si_k)
    np.testing.assert_allclose(sf_t, sf_k, atol=1e-5)
    np.testing.assert_allclose(obs_t, obs_k, atol=1e-5)
    assert mom_t[0, 2] == mom_k[0, 2] == T * W
    np.testing.assert_allclose(mom_t[:, 0], mom_k[:, 0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mom_t[:, 1], mom_k[:, 1], rtol=1e-4,
                               atol=1e-3)


# ---------------------------------------------------------------- Philox

def _philox_np(ctr, key):
    """Philox4x32-10 reference in numpy uint64 arithmetic."""
    c = [np.uint64(x) for x in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m32 = np.uint64(0xFFFFFFFF)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m32
            k1 = (k1 + np.uint64(0xBB67AE85)) & m32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m32]
    return [int(x) for x in c]


# Random123 known-answer vectors (kat_vectors, philox4x32 R=10)
_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def test_philox_known_answers_and_torch_twin():
    for ctr, key, want in _KAT:
        assert tuple(_philox_np(ctr, key)) == want
        t = [torch.tensor([x], dtype=torch.int64) for x in ctr]
        got = TFR.philox4x32(*t, key[0], key[1])
        assert tuple(int(x) for x in got) == want
    rng = np.random.RandomState(0)
    ctrs = rng.randint(0, 2 ** 32, (64, 4), dtype=np.uint64)
    key = (0x12345678, 0x9abcdef0)
    got = TFR.philox4x32(*[torch.tensor(ctrs[:, i].astype(np.int64))
                           for i in range(4)], *key)
    for n in range(64):
        assert [int(g[n]) for g in got] == _philox_np(ctrs[n], key)


def test_philox_uniforms_range_and_stream_layout():
    seed, W_ = (7 << 32) | 99, 64
    u = TFR.philox_uniforms(seed, 5, W_, "cpu")
    assert u.shape == (TFR.N_DRAWS, W_)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    w = 3
    for n in (0, 9, 46):
        g = n // 4
        bits = _philox_np((w, 5, g, 0), (99, 7))[n % 4]
        want = np.float32(np.uint32((bits >> 9) | 0x3F800000).view(
            np.float32)) - np.float32(1.0)
        assert float(u[n, w]) == float(want)
    big = TFR.philox_uniforms(1, 0, 4096, "cpu")
    assert abs(float(big.mean()) - 0.5) < 0.01


def test_philox_noise_composes_over_ticks():
    """The stream depends on (world, tick) only: a T-tick noise matrix is
    the T one-tick matrices stacked, so one T-tick launch and T one-tick
    launches with tick_base = t draw the same numbers."""
    W_ = 64
    whole = TFR.philox_noise(3, 10, 4, W_, "cpu")
    parts = torch.cat([TFR.philox_noise(3, 10 + t, 1, W_, "cpu")
                       for t in range(4)])
    assert torch.equal(whole, parts)
    assert float(whole[:8].min()) >= -1.0 and float(whole[8].min()) >= 0.0


def test_rollout_plain_composes_over_launches():
    cfg, agent, _, (sf, si, obs0), _ = _setup(seed=3)
    ta = agent_from_numpy(jax.tree.map(np.asarray, agent), "cpu")
    mats = TFR.pack_policy(ta)
    state = [torch.tensor(np.asarray(x)) for x in (sf, si, obs0)]
    one = TFR.fused_rollout(SimConfig(), *state, mats, n_steps=3,
                            trainee_idx=TI, seed=9, tick_base=0)
    s = state
    trajs = []
    for t in range(3):
        out = TFR.fused_rollout(SimConfig(), *s, mats, n_steps=1,
                                trainee_idx=TI, seed=9, tick_base=t)
        s = out[:3]
        trajs.append(out[3])
    for a, b in zip(one[:3], s):
        assert torch.equal(a, b)
    assert torch.equal(one[3], torch.cat(trajs))
