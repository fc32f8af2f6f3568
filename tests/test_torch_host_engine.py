"""The port's native host executor (native/__init__.py::NativeEngine,
csrc/host_step.cpp's threaded entry over `sim_world.cuh::step_world`)
against the JAX package's `NativeEngine` (native/mbb_sim.cpp), on
identical rows, actions and noise each tick, in two game modes: integer
rows exact, floats within 5e-4 absolute / 1e-3 relative (the tier of
tests/test_native.py: two C++ transcriptions with their own libm calls
and algebraic forms; quaternions compared up to sign, the same
rotation), the JAX engine resynchronized to the port's rows after each
tick so that float differences do not compound.  Then the thread count:
1, 3 and all threads give the same bits; and the API's shapes."""

import numpy as np
import pytest
import torch

from madrona_basketball_tpu.config import SimConfig as JSimConfig

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.native import NativeEngine
from madrona_basketball_tpu_torch.ops import layout as L

try:
    from madrona_basketball_tpu.native import NativeEngine as JNativeEngine
    from madrona_basketball_tpu.native import build_library
    build_library()
    HAVE_JAX_NATIVE = True
except Exception:  # pragma: no cover - toolchain missing
    HAVE_JAX_NATIVE = False

W, TICKS = 48, 40
_QUAT = [L.F_IDX[f"a{i}.quat_{c}"] for i in range(2) for c in "wxyz"]


def _actions(rng, w):
    return rng.randint(0, [2, 8, 3, 2, 2, 2],
                       size=(w, 2, 6)).astype(np.int32)


@pytest.mark.skipif(not HAVE_JAX_NATIVE,
                    reason="the JAX package's native toolchain is missing")
@pytest.mark.parametrize("kw", [dict(one_on_one=True, tag_mode=True),
                                dict(one_on_one=False, tag_mode=False)])
def test_host_engine_matches_jax_native_engine(kw):
    eng = NativeEngine(SimConfig(**kw), W, seed=4, n_threads=2)
    jeng = JNativeEngine(JSimConfig(**kw), W, seed=4, n_threads=2)
    np.copyto(jeng.sf, eng.sf)
    np.copyto(jeng.si, eng.si)
    rng = np.random.RandomState(0)
    mask = np.ones(L.N_F32_ROWS, bool)
    mask[_QUAT] = False
    for t in range(TICKS):
        acts = _actions(rng, W)
        eng.set_actions(acts)
        jeng.set_actions(acts)
        noise = eng.draw_noise()
        eng.step(noise)
        jeng.step(noise)
        np.testing.assert_array_equal(eng.si, jeng.si, err_msg=f"tick {t}")
        np.testing.assert_allclose(eng.sf[mask], jeng.sf[mask], atol=5e-4,
                                   rtol=1e-3, err_msg=f"tick {t}")
        np.testing.assert_allclose(np.abs(eng.sf[_QUAT]),
                                   np.abs(jeng.sf[_QUAT]), atol=5e-4,
                                   err_msg=f"tick {t}")
        assert np.allclose(eng.obs, jeng.obs, atol=5e-4, rtol=1e-3) or \
            np.allclose(np.abs(eng.obs), np.abs(jeng.obs), atol=5e-4,
                        rtol=1e-3), f"tick {t}"
        np.copyto(jeng.sf, eng.sf)
        np.copyto(jeng.si, eng.si)


def test_thread_count_is_bit_for_bit():
    cfg = SimConfig()
    engines = [NativeEngine(cfg, 100, seed=7, n_threads=n) for n in (1, 3, 0)]
    assert engines[2].n_threads >= 1
    rng = np.random.RandomState(1)
    for _ in range(20):
        acts, noise = _actions(rng, 100), engines[0].draw_noise()
        for e in engines:
            e.set_actions(acts)
            e.step(noise)
    for e in engines[1:]:
        for a, b in ((e.sf, engines[0].sf), (e.si, engines[0].si),
                     (e.obs, engines[0].obs)):
            assert np.array_equal(a, b)


def test_api_shapes():
    eng = NativeEngine(SimConfig(), 8, seed=0)
    noise = eng.draw_noise()
    assert noise.shape == (L.N_NOISE_ROWS, 8) and noise.dtype == np.float32
    assert ((noise[:8] >= -1) & (noise[:8] <= 1)).all()
    assert ((noise[8] >= 0) & (noise[8] <= 1)).all()
    sf_id = id(eng.sf)
    eng.step()
    assert id(eng.sf) == sf_id                       # in place
    assert eng.sf.shape == (L.N_F32_ROWS, 8) and eng.sf.dtype == np.float32
    assert eng.si.shape == (L.N_I32_ROWS, 8) and eng.si.dtype == np.int32
    assert eng.obs.shape == (L.N_OBS_ROWS, 8) and np.isfinite(eng.obs).all()
    st = eng.state()
    assert st.agents.pos.shape == (8, 2, 3)
    assert st.agents.obs.shape == (8, 2, 128)
    assert torch.equal(st.agents.obs[:, 1], torch.from_numpy(
        eng.obs[128:].T.copy()))
    # init_state: the rows of a structured state, packed
    eng2 = NativeEngine(SimConfig(), 8, init_state=st)
    assert np.array_equal(eng2.sf, eng.sf) and np.array_equal(eng2.si, eng.si)
