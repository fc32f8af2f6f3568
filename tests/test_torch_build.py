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
        # ... key, tick_base, world_base, stream
        "fused_rollout": [sp] + [P] * 8 + [I] * 4 + [U, U, P, I, P],
        "fused_gae": [P] * 8 + [I] * 7 + [F, F, P],
        "meter_scan": [P] * 3 + [I] * 2 + [P],
        "fused_rollout_tiled": [sp] + [P] * 7 + [I] * 4 + [U, U, P, I, P],
        "obs_moments": [P] * 3 + [I] * 5 + [P],
        # kernel B's contract plus traj_bf16, policy_bf16
        "fused_rollout_bf16": [sp] + [P] * 8 + [I] * 6 + [U, U, P, I, P],
        # kernel B's contract plus the probe
        "fused_rollout_probe": [sp] + [P] * 8 + [I] * 5 + [U, U, P, I, P],
        # kernel B's contract plus policy_bf16 and the probe (bf16
        # storage), or the probe (float32 storage, the bf16 policy)
        "fused_rollout_probe_bf16": [sp] + [P] * 8 + [I] * 6 +
        [U, U, P, I, P],
        "fused_rollout_probe_pbf": [sp] + [P] * 8 + [I] * 5 +
        [U, U, P, I, P],
        # the tracer's stamp: ring, cursor, capacity, id, stream
        "trace_stamp": [P, P, I, I, P],
        # kernel J: pointers, noise kinds, agents, worlds, obs and action
        # strides, stream
        "eval_policy": [P, P] + [I] * 6 + [P],
        # kernel D's stage probe: D's inputs, partials, stamps, max_parts,
        # max_tiles, rows, W, wb, bpm, the loss's scalars, stream
        "fused_update_probe": [P] * 8 + [I] * 6 + [F] * 3 + [I, P],
    }
    # a source's entries besides its kernel's: its bf16 instance (the
    # trajectory as bf16 bits), the resident CTAs per SM (kernel C's at a
    # tick count), the tracer's clock calibration
    occupancy = {"fused_rollout": {"mbb_fused_rollout_occupancy": [P]},
                 "fused_rollout_bf16": {
                     "mbb_fused_rollout_bf16_occupancy": [P]},
                 "fused_gae": {"mbb_fused_gae_bf16": [P] * 8 + [I] * 7 +
                               [F, F, P],
                               "mbb_fused_gae_occupancy": [I, P]},
                 "obs_moments": {"mbb_obs_moments_bf16": [P] * 3 + [I] * 5 +
                                 [P]},
                 "trace_stamp": {"mbb_trace_stamp_calibrate": [P, P, I, P]},
                 "fused_update_probe": {
                     "mbb_fused_update_probe_layout": [P]}}
    # one source, six entries: kernels D, G and H, D's and G's bf16
    # instances, and the occupancy
    update = {
        "mbb_fused_update_phase": [P, P] + [P] * 8 + [I] * 6 + [F] * 3 +
        [I, F, F, P],
        "mbb_fused_update_phase_bf16": [P, P] + [P] * 8 + [I] * 6 +
        [F] * 3 + [I, F, F, P],
        "mbb_fused_minibatch_grad_prefetch": [P] * 7 + [I] * 5 + [F] * 3 +
        [I, P],
        "mbb_fused_minibatch_grad_prefetch_bf16": [P] * 7 + [I] * 5 +
        [F] * 3 + [I, P],
        "mbb_fused_minibatch_grad": [P] * 5 + [I] * 3 + [F] * 3 + [I, P],
        "mbb_update_occupancy": [P],
    }
    # one source, three entries: kernel F with in-kernel and external
    # noise, and its occupancy
    multistep = {
        "mbb_fused_multistep": [sp] + [P] * 5 + [I] * 3 + [U, U, I, I, P],
        "mbb_fused_multistep_ext": [sp] + [P] * 6 + [I] * 4 + [P],
        "mbb_fused_multistep_occupancy": [P],
    }
    assert set(want) | {"fused_update", "fused_multistep"} == \
        set(_build.KERNELS)
    for name, types in want.items():
        got = _build.c_signature(_build.CSRC / f"{name}.cu", f"mbb_{name}")
        assert got == types, name
        assert _build.entries(name) == [f"mbb_{name}"] + \
            list(occupancy.get(name, {}))
        for entry, types in occupancy.get(name, {}).items():
            assert _build.c_signature(_build.CSRC / f"{name}.cu",
                                      entry) == types
    assert _build.entries("fused_update") == list(update)
    for entry, types in update.items():
        got = _build.c_signature(_build.CSRC / "fused_update.cu", entry)
        assert got == types, entry
    assert _build.entries("fused_multistep") == list(multistep)
    for entry, types in multistep.items():
        got = _build.c_signature(_build.CSRC / "fused_multistep.cu", entry)
        assert got == types, entry
    host = _build.c_signature(_build.CSRC / "host_step.cpp", "mbb_host_step")
    assert host == [sp] + [P] * 6 + [I]
    host = _build.c_signature(_build.CSRC / "host_step.cpp",
                              "mbb_host_multistep")
    assert host == [sp] + [P] * 6 + [I] * 3 + [U, U, I, I]


def test_iteration_scalars_are_read_from_device_memory():
    """Kernel B's and I's tick_base and kernel D's Adam count (and its
    host twin's) are `const int *` parameters, typed as pointers, so a
    CUDA graph that replays the launch reads each replay's value."""
    for src, entry, name in (
            ("fused_rollout.cu", "mbb_fused_rollout", "tick_base"),
            ("fused_rollout_tiled.cu", "mbb_fused_rollout_tiled",
             "tick_base"),
            ("fused_rollout_probe_bf16.cu", "mbb_fused_rollout_probe_bf16",
             "tick_base"),
            ("fused_rollout_probe_pbf.cu", "mbb_fused_rollout_probe_pbf",
             "tick_base"),
            ("fused_update.cu", "mbb_fused_update_phase", "count"),
            ("host_update.cpp", "mbb_host_update_phase", "count")):
        text = _build._strip_comments((_build.CSRC / src).read_text())
        params = text.split(f"{entry}(", 1)[1].split(")", 1)[0]
        names = [p.split("*")[-1].split()[-1] for p in params.split(",")]
        decl = params.split(",")[names.index(name)]
        assert "const int *" in " ".join(decl.split()), (entry, decl)
        types = _build.c_signature(_build.CSRC / src, entry)
        assert types[names.index(name)] is P, entry
    host = _build.c_signature(_build.CSRC / "host_update.cpp",
                              "mbb_host_update_phase")
    assert host == [P] * 9 + [I] * 6 + [F] * 3 + [I, F, F]


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
