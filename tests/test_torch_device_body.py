"""The CUDA device body on the CPU: csrc/sim_world.cuh compiled by g++
(csrc/host_step.cpp) vs the plain torch tick, in all three game modes.

The same `step_world` source that kernels A and B run, built for the host
with contraction off, must give the plain version's integer state exactly
and its floats to 1e-4 (host libm sin/cos/exp vs torch's, 1/sqrtf for the
card's rsqrtf).  This checks the transcription here; the card's own
parity runs in chip_smoke.py."""

import ctypes
import shutil
import subprocess

import pytest
import torch

from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops.layout import (ACTION_ROWS, F_IDX,
                                                     RESET_ROWS)

W, TICKS = 256, 40


@pytest.fixture(scope="module")
def host_step():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = _build.BUILD_DIR / "host" / "libhost_step.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out),
                    str(_build.CSRC / "host_step.cpp")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.mbb_host_step.argtypes = _build.c_signature(
        _build.CSRC / "host_step.cpp", "mbb_host_step")

    def step(cfg, sf, si, noise):
        sf2, si2 = torch.empty_like(sf), torch.empty_like(si)
        obs = torch.empty((256, sf.shape[1]))
        lib.mbb_host_step(FS.sim_params(cfg), noise.data_ptr(),
                          sf.data_ptr(), si.data_ptr(), sf2.data_ptr(),
                          si2.data_ptr(), obs.data_ptr(), sf.shape[1])
        return sf2, si2, obs
    return step


@pytest.mark.parametrize("mode", sorted(GAME_MODES))
def test_device_body_matches_plain_step(host_step, mode):
    cfg = GAME_MODES[mode]
    g = torch.Generator().manual_seed(5)
    sf, si = init_rows(cfg, W, g, "cpu")
    sf[F_IDX["a0.pos_y"], :16] = 0.9           # near the sideline: OOB
    sf[F_IDX["bpos_y"], :16] = 0.9
    for t in range(TICKS):
        si = si.clone()
        for i in range(2):
            for r, n in zip(ACTION_ROWS[i], (2, 8, 3, 2, 2, 2)):
                si[r] = torch.randint(0, n, (W,), generator=g,
                                      dtype=torch.int32)
        for r in RESET_ROWS:
            si[r] = int(t % 15 == 0)
        u = torch.rand((9, W), generator=g)
        noise = torch.cat([2 * u[:8] - 1, u[8:]]).contiguous()
        got = host_step(cfg, sf, si, noise)
        want = FS.step_rows_plain(cfg, sf, si, noise)
        assert torch.equal(got[1], want[1]), f"tick {t}"
        torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
        torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=0)
        sf, si = want[0], want[1]
