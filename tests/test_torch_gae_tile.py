"""Kernel C's decomposition on the CPU: csrc/host_gae.cpp runs the steps
of csrc/fused_gae.cu (each world block a cluster of gb / 32 CTAs of 32
worlds: staged rows, the reverse GAE and the episode-stat carry per
world, per-CTA partial sums in lane order, the block means and M2 summed
over the cluster in rank order) from the same csrc/gae_tile.cuh, compiled
by g++, and is held against `gae_plain` at world counts whose block holds
4, 2 and 1 CTAs.  The side rows and the carry are the plain version's
arithmetic (1e-6 absolute); the block moments and per-tick sums are summed
in another order (1e-5 of max(1, |x|))."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.ops import fused_gae as FG

T, ROWS = 8, 16
R_VALUE, R_REW, R_DONE = 12, 13, 14


@pytest.fixture(scope="module")
def host_gae():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = _build.BUILD_DIR / "host" / "libhost_gae.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out),
                    str(_build.CSRC / "host_gae.cpp")], check=True)
    import ctypes
    lib = ctypes.CDLL(str(out))
    lib.mbb_host_gae.argtypes = _build.c_signature(
        _build.CSRC / "host_gae.cpp", "mbb_host_gae")
    return lib


def _inputs(W, seed):
    rng = np.random.RandomState(seed)
    traj = rng.standard_normal((T, ROWS, W)).astype(np.float32)
    traj[:, R_VALUE] *= 3.0                       # some values clamp at 5
    traj[:, R_DONE] = rng.uniform(size=(T, W)) < 0.2
    carry = np.stack([rng.standard_normal(W) * 4.0,
                      rng.randint(0, 50, W)]).astype(np.float32)
    nv = rng.standard_normal((1, W)).astype(np.float32)
    vstats = np.zeros((1, 8), np.float32)
    vstats[0, :2] = (0.7, 1.9)
    return [torch.from_numpy(x) for x in (traj, carry, nv, vstats)]


@pytest.mark.parametrize("W", [256, 64, 96])
def test_host_gae_tile_matches_plain(host_gae, W):
    traj, carry, nv, vstats = _inputs(W, W)
    gb = FG.pick_gae_block(W)
    assert gb // 32 == {256: 4, 64: 2, 96: 1}[W]
    kw = dict(gamma=0.99, lam=0.95, r_value=R_VALUE, r_rew=R_REW,
              r_done=R_DONE)
    want = FG.gae_plain(traj, carry, nv, vstats, **kw)
    nb = W // gb
    side = torch.empty((T, FG.SIDE_ROWS, W))
    moments, carry2 = torch.empty((nb, 8)), torch.empty((2, W))
    ticks = torch.empty((nb, T, 8))
    host_gae.mbb_host_gae(
        traj.data_ptr(), carry.data_ptr(), nv.data_ptr(), vstats.data_ptr(),
        side.data_ptr(), moments.data_ptr(), carry2.data_ptr(),
        ticks.data_ptr(), T, ROWS, W, gb, R_VALUE, R_REW, R_DONE,
        kw["gamma"], kw["gamma"] * kw["lam"])
    torch.testing.assert_close(side, want[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(carry2, want[2], atol=1e-6, rtol=0)
    for got, ref in ((moments, want[1]), (ticks, want[3])):
        scale = torch.clamp(ref.abs(), min=1.0)
        assert float(((got - ref).abs() / scale).max()) <= 1e-5
