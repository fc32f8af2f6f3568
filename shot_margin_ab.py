#!/usr/bin/env python3
"""The shot's going-in test at its threshold: kernel A of this checkout
against kernel A built from another tree's sources, one card.

    python3 shot_margin_ab.py [--other DIR]

DIR holds another version of madrona_basketball_tpu_torch/csrc (for
example the parent commit's, unpacked with `git archive`).  On 8192
worlds from `fused_step.shot_margin_inputs` - each world's shot lands
within a few rounding steps of ZONE_R^2 - both builds of kernel A run
one tick beside the plain version `step_rows_plain` on the same card,
and the script prints, for each build, how many worlds decide the shot
differently (integer state, score or ball rows not equal to the plain
version's) and the largest float difference.  chip_smoke.py's
`parity_shot_margin` phase requires 0 for this checkout; a build that
lets nvcc contract the going-in chain into fused multiply-adds shows
thousands.  The card's name and power limit come last.
"""

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, default=None,
                    help="a directory holding another csrc/ version")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("shot_margin_ab: needs one CUDA card")
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.config import SimConfig
    from madrona_basketball_tpu_torch.engine import init_rows
    from madrona_basketball_tpu_torch.ops import fused_step as FS
    from madrona_basketball_tpu_torch.ops.layout import F_IDX

    dev = torch.device("cuda:0")
    builds = {"this": None}
    t0 = time.perf_counter()
    other = None
    if args.other is not None:
        src = args.other / "fused_step.cu"
        out = _build.BUILD_DIR / "libfused_step-other-ab.so"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        other = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    _build.build(["fused_step"])
    if other is not None:
        log, _ = other.communicate()
        if other.returncode != 0:
            raise SystemExit(f"nvcc failed for {src}:\n{log[:4000]}")
        lib = ctypes.CDLL(str(out))
        lib.mbb_fused_step.argtypes = _build.c_signature(src,
                                                         "mbb_fused_step")
        builds["other"] = lib
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0,
             "builds": sorted(builds)})

    cfg = SimConfig()
    W = cs.W
    gen = torch.Generator(device=dev).manual_seed(17)
    sf, si = init_rows(cfg, W, gen, dev)
    sf, si, noise, margin = FS.shot_margin_inputs(cfg, sf, si, gen)
    plain = FS.step_rows_plain(cfg, sf, si, noise)
    rows = [F_IDX[n] for n in ("sbaskets", "t0score", "t1score", "bpos_x",
                               "bpos_y", "bpos_z", "bvel_x", "bvel_y",
                               "bvel_z", "bdone")]
    for name, lib in builds.items():
        if lib is None:
            got = FS.fused_step(cfg, sf, si, noise)
        else:
            got = (torch.empty_like(sf), torch.empty_like(si),
                   torch.empty((256, W), device=dev))
            err = lib.mbb_fused_step(
                FS.sim_params(cfg), noise.data_ptr(), sf.data_ptr(),
                si.data_ptr(), got[0].data_ptr(), got[1].data_ptr(),
                got[2].data_ptr(), W, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: launch failed ({err})")
        torch.cuda.synchronize()
        bad = (got[1] != plain[1]).any(dim=0) | \
            (got[0][rows] != plain[0][rows]).any(dim=0)
        cs.emit({"build": name, "worlds": W,
                 "worlds_in_band": int((margin.abs() <=
                                        FS.SHOT_BAND_ULPS).sum()),
                 "worlds_deciding_differently": int(bad.sum()),
                 "max_float_err": float((got[0] - plain[0]).abs().max())})
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
