"""Kernel F's plain version (`multistep_rows_plain`, and `fused_multistep`
on CPU tensors) vs the JAX package.

* obs every tick with agent 0 blanked: against the interpret-mode Pallas
  kernel `make_fused_multistep(external_noise=True, obs_every_tick=True,
  blank_agent=0)` at W = 128, block = 128, K = 3;
* held obs (with and without a blanked agent): against K calls of the JAX
  `fused_step_xla`, which tests/test_fused.py holds equal to the kernel;
* `step_fields(compute_obs=False)` leaves the state of compute_obs=True;
* `pack_multistep_noise` equals the JAX one element for element;
* the Philox plain twin: one K-tick call equals K one-tick calls.

Tolerance: integer rows exact, float rows 1e-5 absolute (the JAX/torch CPU
rounding tier of tests/test_torch_step.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import engine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ops import fused_step as JFS

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS, RESET_ROWS
from tests.test_torch_step import _stage

W, K = 128, 3
_BUCKETS = (2, 8, 3, 2, 2, 2)


def _inputs(seed):
    """Staged fresh worlds with random actions and a few Reset flags, and
    K ticks of numpy noise (rows 0-7 U(-1,1), row 8 U(0,1))."""
    sf, si = JL.pack(engine.init_batch(JSimConfig(), jax.random.PRNGKey(seed),
                                       W))
    sf, si = _stage(sf, si)
    rng = np.random.RandomState(seed)
    for i in range(2):
        for r, n in zip(ACTION_ROWS[i], _BUCKETS):
            si[r] = rng.randint(0, n, W)
        si[ACTION_ROWS[i][5], :8] = 1
    for r in RESET_ROWS:
        si[r] = rng.uniform(size=W) < 0.05
    chunks = [np.concatenate([rng.uniform(-1, 1, (8, W)),
                              rng.uniform(0, 1, (1, W))]).astype(np.float32)
              for _ in range(K)]
    return sf, si, chunks


def _check(got, want):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)


def test_every_tick_obs_blank_matches_interpret_kernel():
    sf, si, chunks = _inputs(1)
    noise = JFS.pack_multistep_noise([jnp.asarray(c) for c in chunks])
    kern = JFS.make_fused_multistep(JSimConfig(), W, K, block=128,
                                    interpret=True, external_noise=True,
                                    obs_every_tick=True, blank_agent=0)
    want = kern(noise, jnp.asarray(sf), jnp.asarray(si))
    got = FS.fused_multistep(SimConfig(), torch.tensor(sf), torch.tensor(si),
                             K, noise=torch.tensor(np.asarray(noise)),
                             obs_every_tick=True, blank_agent=0)
    _check(got, want)


@pytest.mark.parametrize("blank_agent", [None, 1])
def test_held_obs_matches_xla_steps(blank_agent):
    sf, si, chunks = _inputs(2)
    jsf, jsi = jnp.asarray(sf), jnp.asarray(si)
    for c in chunks:
        if blank_agent is not None:
            for r in ACTION_ROWS[blank_agent]:
                jsi = jsi.at[r].set(0)
        jsf, jsi, jobs = JFS.fused_step_xla(JSimConfig(), jsf, jsi,
                                            jnp.asarray(c))
    noise = FS.pack_multistep_noise([torch.tensor(c) for c in chunks])
    got = FS.multistep_rows_plain(SimConfig(), torch.tensor(sf),
                                  torch.tensor(si), noise, K,
                                  blank_agent=blank_agent)
    _check(got, (jsf, jsi, jobs))


def test_step_fields_skip_obs_same_state():
    sf, si, chunks = _inputs(3)
    cfg = SimConfig()
    sf, si, noise = torch.tensor(sf), torch.tensor(si), torch.tensor(chunks[0])
    a = FS.step_rows_plain(cfg, sf, si, noise)
    b = FS.step_rows_plain(cfg, sf, si, noise, compute_obs=False)
    assert b[2] is None and a[2].shape == (256, W)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_pack_multistep_noise_matches_jax():
    rng = np.random.RandomState(4)
    steps = [rng.uniform(-1, 1, (9, 40)).astype(np.float32) for _ in range(4)]
    want = np.asarray(JFS.pack_multistep_noise([jnp.asarray(s)
                                                for s in steps]))
    got = FS.pack_multistep_noise([torch.tensor(s) for s in steps]).numpy()
    assert FS.NOISE_CHUNK == JFS.NOISE_CHUNK
    np.testing.assert_array_equal(got, want)


def test_philox_plain_twin_composes():
    cfg = SimConfig()
    sf, si, _ = _inputs(5)
    sf, si = torch.tensor(sf), torch.tensor(si)
    seed = (3 << 32) | 17
    one = FS.fused_multistep(cfg, sf, si, K, seed=seed, tick_base=5,
                             obs_every_tick=True, blank_agent=0)
    steps = (sf, si)
    for t in range(K):
        steps = FS.fused_multistep(cfg, steps[0], steps[1], 1, seed=seed,
                                   tick_base=5 + t, obs_every_tick=True,
                                   blank_agent=0)
    assert all(torch.equal(a, b) for a, b in zip(one, steps))
    # the noise is kernel B's first 9 draws, rows 0-7 as 2u - 1, row 8 as u
    noise = FS.philox_multistep_noise(seed, 5, 2, W, "cpu")
    u = FR.philox_uniforms(seed, 6, W, "cpu")
    chunk = noise[FS.NOISE_CHUNK:]
    assert torch.equal(chunk[:8], 2.0 * u[:8] - 1.0)
    assert torch.equal(chunk[8], u[8])
    assert not chunk[9:].any()


def test_fused_multistep_rejects_bad_arguments():
    cfg = SimConfig()
    sf = torch.zeros((72, 4))
    si = torch.zeros((59, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        FS.fused_multistep(cfg, sf, si, 2)                       # no noise
    with pytest.raises(ValueError):
        FS.fused_multistep(cfg, sf, si, 2, seed=0,
                           noise=torch.zeros((32, 4)))           # both
    with pytest.raises(ValueError):
        FS.fused_multistep(cfg, sf, si, 2, noise=torch.zeros((18, 4)))
    with pytest.raises(ValueError):
        FS.fused_multistep(cfg, sf, si, 0, seed=0)
    with pytest.raises(ValueError):
        FS.fused_multistep(cfg, sf, si, 1, seed=0, blank_agent=2)
