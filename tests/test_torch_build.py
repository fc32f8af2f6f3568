"""The kernels' host interface is read from the CUDA sources.

`_build.c_signature` types each `extern "C"` entry from its source and
`_build.c_struct` builds `SimParams` from csrc/sim_world.cuh, so a
signature edited in a .cu changes the ctypes binding with it.  These
tests parse the real sources (no nvcc needed) and pin the result."""

import ctypes

import pytest

from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_step as FS

P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float


def test_kernel_signatures_parse_from_sources():
    sp = _build.SimParams
    want = {
        "fused_step": [sp] + [P] * 6 + [I, P],
        "fused_rollout": [sp] + [P] * 8 + [I] * 4 + [U, U, I, P],
        "fused_gae": [P] * 8 + [I] * 7 + [F, F, P],
        "meter_scan": [P] * 3 + [I] * 2 + [P],
    }
    # one source, three entries: kernels D, G and H
    update = {
        "mbb_fused_update_phase": [P, I] + [P] * 8 + [I] * 6 + [F] * 3 +
        [I, F, F, P],
        "mbb_fused_minibatch_grad_prefetch": [P] * 7 + [I] * 5 + [F] * 3 +
        [I, P],
        "mbb_fused_minibatch_grad": [P] * 5 + [I] * 3 + [F] * 3 + [I, P],
    }
    assert set(want) | {"fused_update"} == set(_build.KERNELS)
    for name, types in want.items():
        got = _build.c_signature(_build.CSRC / f"{name}.cu", f"mbb_{name}")
        assert got == types, name
        assert _build.entries(name) == [f"mbb_{name}"]
    assert _build.entries("fused_update") == list(update)
    for entry, types in update.items():
        got = _build.c_signature(_build.CSRC / "fused_update.cu", entry)
        assert got == types, entry
    host = _build.c_signature(_build.CSRC / "host_step.cpp", "mbb_host_step")
    assert host == [sp] + [P] * 6 + [I]


def test_sim_params_struct_matches_header():
    names = [n for n, _ in _build.SimParams._fields_]
    assert names[-1] == "tag_mode" and len(names) == 25
    assert all(t is F for _, t in _build.SimParams._fields_[:-1])
    assert ctypes.sizeof(_build.SimParams) == 25 * 4
    p = FS.sim_params(SimConfig())
    assert p.tag_mode == 1 and p.grid_w == SimConfig().grid_width
    assert FS.sim_params(SimConfig(tag_mode=False)).tag_mode == 0


def test_unknown_parameter_type_raises(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('extern "C" int mbb_k(double x, float *y) {\n}\n')
    with pytest.raises(KeyError):
        _build.c_signature(src, "mbb_k")
    with pytest.raises(RuntimeError):
        _build.c_signature(src, "mbb_missing")
