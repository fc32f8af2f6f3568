"""The rows engine, the state view and the export vs the JAX package, on
the CPU (the wrappers' plain versions), driven on the JAX package's own
noise.

* `FusedEngine.step` / `step_many` / `set_actions` / `trainee_obs` vs the
  JAX `FusedEngine(backend="xla")` from the same initial state
  (`init_rows(reset_u=...)` with the JAX spawn draws), the noise drawn by
  `engine_fused.make_noise_fn` on the JAX engine's keys and injected
  through the port's `noise=` seam: integer rows exact, floats 1e-5 (the
  JAX/torch CPU rounding tier of tests/test_torch_step.py).
* `state()` + `export_tensors` vs the JAX `export_tensors(layout.unpack())`
  on the same rows, `bitcast_compat` off and on: every tensor exact, with
  its shape and dtype.

tests/test_torch_engine_env.py holds the env."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.engine_fused import FusedEngine as JFusedEngine
from madrona_basketball_tpu.engine_fused import make_noise_fn
from madrona_basketball_tpu.export import export_tensors as j_export
from madrona_basketball_tpu.ops import layout as JL

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.engine_fused import FusedEngine
from madrona_basketball_tpu_torch.export import export_tensors
from madrona_basketball_tpu_torch.ops.fused_step import pack_multistep_noise
from tests import torch_threads  # noqa: F401
from tests.test_torch_init import _jax_reset_u

W = 32
_BUCKETS = (2, 8, 3, 2, 2, 2)


def _init_from_jax(port_engine, seed):
    ru = _jax_reset_u(JSimConfig(), jax.random.PRNGKey(seed), W)
    port_engine.sf, port_engine.si = init_rows(
        SimConfig(), W, None, "cpu", reset_u=torch.tensor(ru.T.copy()))


def _check_rows(e, je):
    np.testing.assert_array_equal(e.si.numpy(), np.asarray(je.si))
    np.testing.assert_allclose(e.sf.numpy(), np.asarray(je.sf), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(e.obs.numpy(), np.asarray(je.obs), atol=1e-5,
                               rtol=0)


def _actions(rng, shape):
    return np.stack([rng.randint(0, b, shape) for b in _BUCKETS],
                    axis=-1).astype(np.int32)


def test_engine_matches_jax_fused_engine():
    je = JFusedEngine(JSimConfig(), W, seed=5, backend="xla")
    e = FusedEngine(SimConfig(), W, seed=5, device="cpu")
    _init_from_jax(e, 5)
    np.testing.assert_array_equal(e.si.numpy(), np.asarray(je.si))
    np.testing.assert_allclose(e.sf.numpy(), np.asarray(je.sf), atol=2e-6,
                               rtol=0)
    noise_fn = make_noise_fn(JSimConfig())
    rng = np.random.RandomState(0)
    acts = _actions(rng, (W, 2))
    je.set_actions(jnp.asarray(acts))
    e.set_actions(torch.tensor(acts))
    np.testing.assert_array_equal(e.si.numpy(), np.asarray(je.si))
    for _ in range(2):
        _, noise = noise_fn(je.keys)
        je.step()
        e.step(noise=torch.tensor(np.asarray(noise)))
        _check_rows(e, je)
    keys, chunks = je.keys, []
    for _ in range(4):
        keys, n = noise_fn(keys)
        chunks.append(torch.tensor(np.asarray(n)))
    je.step_many(4)
    e.step_many(4, noise=pack_multistep_noise(chunks))
    _check_rows(e, je)
    for i in range(2):
        np.testing.assert_allclose(e.trainee_obs(i).numpy(),
                                   np.asarray(je.trainee_obs(i)), atol=1e-5,
                                   rtol=0)
    before = (e.sf, e.si)
    e.step_many(0)
    assert e.sf is before[0] and e.si is before[1]
    # without injected noise: Philox from (call counter, engine seed)
    e.step_many(3)
    e2 = FusedEngine(SimConfig(), W, seed=5, device="cpu")
    e2.sf, e2.si = before
    e2._multistep_calls = e._multistep_calls - 1
    e2.step_many(3)
    assert torch.equal(e.sf, e2.sf) and torch.equal(e.si, e2.si)


@pytest.mark.parametrize("bitcast_compat", [False, True])
def test_state_view_and_export_match_jax(bitcast_compat):
    e = FusedEngine(SimConfig(), W, seed=2, device="cpu")
    e.sf[JL.F_IDX["a0.stat_points"]] = 2.0      # non-zero float stats, so
    e.sf[JL.F_IDX["a1.stat_fouls"]] = 1.0       # bitcast and cast differ
    for _ in range(3):
        e.step()
    jview = JL.unpack(JSimConfig(), jnp.asarray(e.sf.numpy()),
                      jnp.asarray(e.si.numpy()), jax.random.PRNGKey(0),
                      obs=jnp.asarray(e.obs.numpy()))
    want = j_export(jview, bitcast_compat=bitcast_compat)
    got = export_tensors(e.state(), bitcast_compat=bitcast_compat)
    assert set(got) == set(want) and len(got) == 19
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
