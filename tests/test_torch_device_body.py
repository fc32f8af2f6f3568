"""The CUDA device body on the CPU: csrc/sim_world.cuh compiled by g++
(csrc/host_step.cpp, built by native/__init__.py::build_host_step) vs the
plain torch tick, in all three game modes.

The same `step_world` source that kernels A and B run, built for the host
with contraction off, must give the plain version's integer state exactly
and its floats to 1e-4 (host libm sin/cos/exp vs torch's, 1/sqrtf for the
card's rsqrtf).  This checks the transcription here; the card's own
parity runs in chip_smoke.py.  Kernel F's CTA, its warp roles run in the
card's order and built the same way (`mbb_host_multistep`), is held against
`multistep_rows_plain` at the same tolerance, on external and on Philox
noise.  On worlds whose shot lands within a few rounding steps of the
going-in threshold (`shot_margin_inputs`), the shot's outcome - the
integer state, the score rows and the ball - must equal the plain
version's exactly; there the plain tick takes its sin and cos from the C
library, as the host build does, and its sqrt and 1 / sqrt correctly
rounded (torch's vectorized CPU sin, cos, sqrt and rsqrt are not
correctly rounded on every build, and one ulp of cos moves closest_sq by
an ulp of dist2).  On the card both sides use CUDA's sinf and cosf."""

import ctypes
import ctypes.util
import shutil

import numpy as np
import pytest
import torch

from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.native import load_host_step
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops.layout import (ACTION_ROWS, F_IDX,
                                                     RESET_ROWS)
from tests import torch_threads  # noqa: F401

W, TICKS = 256, 40


@pytest.fixture(scope="module")
def host_step():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = load_host_step()   # the package's build, contraction off

    def step(cfg, sf, si, noise):
        sf2, si2 = torch.empty_like(sf), torch.empty_like(si)
        obs = torch.empty((256, sf.shape[1]))
        lib.mbb_host_step(FS.sim_params(cfg), noise.data_ptr(),
                          sf.data_ptr(), si.data_ptr(), sf2.data_ptr(),
                          si2.data_ptr(), obs.data_ptr(), sf.shape[1])
        return sf2, si2, obs

    def multistep(cfg, sf, si, K, noise=None, seed=0, tick_base=0,
                  obs_every_tick=False, blank_agent=None):
        sf2, si2 = torch.empty_like(sf), torch.empty_like(si)
        obs = torch.empty((256, sf.shape[1]))
        lib.mbb_host_multistep(
            FS.sim_params(cfg), None if noise is None else noise.data_ptr(),
            sf.data_ptr(), si.data_ptr(), sf2.data_ptr(), si2.data_ptr(),
            obs.data_ptr(), sf.shape[1], K, tick_base, seed & 0xFFFFFFFF,
            seed >> 32, int(obs_every_tick),
            -1 if blank_agent is None else blank_agent)
        return sf2, si2, obs
    step.multistep = multistep
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


@pytest.mark.parametrize("obs_every_tick,blank_agent,philox", [
    (False, None, False), (True, 0, False), (False, 1, True)])
def test_multistep_body_matches_plain(host_step, obs_every_tick, blank_agent,
                                      philox):
    cfg, K, w = GAME_MODES["1v1"], 12, 128
    g = torch.Generator().manual_seed(6)
    sf, si = init_rows(cfg, w, g, "cpu")
    sf[F_IDX["a0.pos_y"], :16] = 0.9           # near the sideline: OOB
    sf[F_IDX["bpos_y"], :16] = 0.9
    for i in range(2):
        for r, n in zip(ACTION_ROWS[i], (2, 8, 3, 2, 2, 2)):
            si[r] = torch.randint(0, n, (w,), generator=g, dtype=torch.int32)
    si[RESET_ROWS[0], :8] = 1
    seed, base = (2 << 32) | 9, 4
    noise = FS.philox_multistep_noise(seed, base, K, w, "cpu") if philox \
        else FS.pack_multistep_noise([torch.rand((9, w), generator=g)
                                      for _ in range(K)])
    got = host_step.multistep(cfg, sf, si, K, None if philox else noise,
                              seed, base, obs_every_tick, blank_agent)
    want = FS.multistep_rows_plain(cfg, sf, si, noise, K, obs_every_tick,
                                   blank_agent)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=0)


def _correctly_rounded_sqrt(mp):
    """Give torch the correctly rounded sqrt and 1 / sqrt that the host
    build computes (sqrtf, 1.0f / sqrtf): some torch CPU builds return
    sqrt and rsqrt an ulp off on a share of float32 inputs, which moves a
    shot at the threshold.  numpy's sqrt is the IEEE instruction in every
    precision."""
    def sqrt(x):
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))

    mp.setattr(torch, "sqrt", sqrt)
    mp.setattr(torch, "rsqrt", lambda x: 1.0 / sqrt(x))


def test_shot_outcome_exact_at_the_threshold(host_step):
    cfg, w = GAME_MODES["1v1"], 512
    g = torch.Generator().manual_seed(8)
    sf, si = init_rows(cfg, w, g, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        _correctly_rounded_sqrt(mp)
        sf, si, noise, margin = FS.shot_margin_inputs(cfg, sf, si, g)
    band = margin.abs() <= FS.SHOT_BAND_ULPS
    assert float(band.float().mean()) > 0.5
    got = host_step(cfg, sf, si, noise)
    libm = ctypes.CDLL(ctypes.util.find_library("m"))

    def c_lib(name):
        fn = getattr(libm, name)
        fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
        return lambda x: torch.tensor([fn(v) for v in x.reshape(-1).tolist()],
                                      dtype=x.dtype).reshape(x.shape)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "sin", c_lib("sinf"))
        mp.setattr(torch, "cos", c_lib("cosf"))
        _correctly_rounded_sqrt(mp)
        want = FS.step_rows_plain(cfg, sf, si, noise)
    made = want[0][F_IDX["sbaskets"]] - sf[F_IDX["sbaskets"]]
    assert 0.2 < float(made.mean()) < 0.8      # both outcomes occur
    assert torch.equal(got[1], want[1])
    rows = [F_IDX[n] for n in ("sbaskets", "t0score", "t1score", "bpos_x",
                               "bpos_y", "bpos_z", "bvel_x", "bvel_y",
                               "bvel_z", "bdone")]
    assert torch.equal(got[0][rows], want[0][rows])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
