"""Kernel E's plain version: `obs_moments` on CPU tensors (which runs
`obs_moments_plain`, the sequential Chan fold) vs the JAX
`make_obs_moments(interpret=True)` over several (tick, world-block)
tiles, at 1e-5 relative; vs `torch.var_mean` over ticks and worlds; and,
merged into a normalizer by `rms_update_padded_moments`, vs the JAX
package's two-pass `rms_update_padded_tdw` on the same rows and vs the
JAX moments path (as tests/test_fused_gae.py:140-165 holds the JAX
kernel).  A tensor on neither the CPU nor a CUDA device raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.models.normalize import RMSState as JRMSState
from madrona_basketball_tpu.models.normalize import (
    rms_update_padded_moments as j_update_moments, rms_update_padded_tdw)
from madrona_basketball_tpu.ops import fused_gae as JFG

from madrona_basketball_tpu_torch.models.normalize import (
    RMSState, rms_update_padded_moments)
from madrona_basketball_tpu_torch.ops import fused_gae as TFG
from tests import torch_threads  # noqa: F401

T, ROWS, W, USED, FULL = 4, 128, 2048, 103, 128


def _traj(seed=3):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-20, 20, (T, ROWS, W)).astype(np.float32)
    x[:, :USED] += rng.normal(0, 30, (1, USED, 1)).astype(np.float32)
    return x


def test_obs_moments_matches_pallas_interpret():
    x = _traj()
    assert TFG.pick_gae_block(W, TFG.OBS_MOMENT_TILE_CAP) == 1024  # 2 tiles
    want = np.asarray(JFG.make_obs_moments(T, W, USED, interpret=True)(
        jnp.asarray(x)))
    got = TFG.obs_moments(torch.tensor(x)).numpy()
    assert got.shape == (USED, 8) and got[0, 2] == want[0, 2] == T * W
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.any(got[:, 3:])


def test_obs_moments_matches_var_mean():
    x = torch.tensor(_traj(4))
    got = TFG.obs_moments(x)
    var, mean = torch.var_mean(x[:, :USED].double(), dim=(0, 2),
                               correction=0)
    np.testing.assert_allclose(got[:, 0].numpy(), mean.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose((got[:, 1] / got[:, 2]).numpy(), var.numpy(),
                               rtol=1e-5)


def test_obs_moments_normalizer_matches_jax():
    x = _traj(5)
    rng = np.random.RandomState(6)
    mean0 = rng.uniform(-1, 1, (FULL,)).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, (FULL,)).astype(np.float32)
    jst = JRMSState(mean=jnp.asarray(mean0), var=jnp.asarray(var0),
                    count=jnp.asarray(300.0))
    tst = RMSState(mean=torch.tensor(mean0), var=torch.tensor(var0),
                   count=torch.tensor(300.0))
    om = TFG.obs_moments(torch.tensor(x))
    got = rms_update_padded_moments(tst, om[:, 0], om[:, 1], om[0, 2])
    jom = JFG.make_obs_moments(T, W, USED, interpret=True)(jnp.asarray(x))
    for want in (rms_update_padded_tdw(jst, jnp.asarray(x[:, :USED])),
                 j_update_moments(jst, jom[:, 0], jom[:, 1], jom[0, 2])):
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var),
                                   rtol=1e-4, atol=1e-4)
        assert float(got.count) == float(want.count) == 300.0 + T * W


def test_obs_moments_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        TFG.obs_moments(torch.empty((T, ROWS, W), device="meta"))
    with pytest.raises(ValueError):
        TFG.obs_moments(torch.zeros((T, 64, W)))
