"""Kernel F's CTA decomposition on the CPU: csrc/host_step.cpp's
`mbb_host_multistep` runs the warp roles of csrc/fused_multistep.cu (the
sim warp's `sim_tick` and obs snapshot, the noise warp's Philox ring, the
obs warps' `obs_from_snapshot` into the shared tile, and the final flush)
in the card's barrier order over tiles of 32 worlds, compiled by g++ from
the same csrc/sim_world.cuh.  It is held against `multistep_rows_plain`
for both instances, with Philox and with external noise: 64 worlds (and
a ragged 48, whose second tile is part empty), K = 8, integer rows exact,
float rows and obs 1e-5 absolute."""

import pytest
import torch

from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops.layout import (ACTION_ROWS, F_IDX,
                                                     RESET_ROWS)
from tests import torch_threads  # noqa: F401
from tests.test_torch_device_body import host_step  # noqa: F401 (fixture)

K = 8


@pytest.mark.parametrize("w", [64, 48])
@pytest.mark.parametrize("obs_every_tick,blank_agent,philox", [
    (True, 0, True), (True, 0, False), (False, None, True),
    (False, 1, False)])
def test_host_tile_matches_plain(host_step, w, obs_every_tick, blank_agent,
                                 philox):
    cfg = GAME_MODES["1v1"]
    g = torch.Generator().manual_seed(21)
    sf, si = init_rows(cfg, w, g, "cpu")
    sf[F_IDX["a0.pos_y"], :8] = 0.9            # near the sideline: OOB
    sf[F_IDX["bpos_y"], :8] = 0.9
    for i in range(2):
        for r, n in zip(ACTION_ROWS[i], (2, 8, 3, 2, 2, 2)):
            si[r] = torch.randint(0, n, (w,), generator=g, dtype=torch.int32)
    si[RESET_ROWS[0], :4] = 1
    seed, base = (3 << 32) | 77, 11
    noise = FS.philox_multistep_noise(seed, base, K, w, "cpu") if philox \
        else FS.pack_multistep_noise([torch.rand((9, w), generator=g)
                                      for _ in range(K)])
    got = host_step.multistep(cfg, sf, si, K, None if philox else noise,
                              seed, base, obs_every_tick, blank_agent)
    want = FS.multistep_rows_plain(cfg, sf, si, noise, K, obs_every_tick,
                                   blank_agent)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=0)
