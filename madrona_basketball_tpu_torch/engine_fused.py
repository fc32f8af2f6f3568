"""Per-tick sim noise in the kernels' 9-row layout (port of
`madrona_basketball_tpu.engine_fused`, engine_fused.py:31-50).

Rows 0-5: shot deviations U(-1,1), 3 per agent; rows 6-7: offense spawn
x/y deviation U(-1,1); row 8: defender spawn angle U(0,1).  The draws
come from the caller's `torch.Generator`, not from JAX's key splits:
only the distribution is shared with the JAX package (SURVEY section 2.3).
"""

from __future__ import annotations

import torch

from .ops.layout import N_NOISE_ROWS


def draw_noise_rows(num_worlds: int, gen: torch.Generator,
                    device="cuda") -> torch.Tensor:
    """(N_NOISE_ROWS, W) float32: rows 0-7 U(-1,1), row 8 U(0,1)."""
    u = torch.rand((N_NOISE_ROWS, num_worlds), generator=gen,
                   dtype=torch.float32, device=device)
    return torch.cat([2.0 * u[:N_NOISE_ROWS - 1] - 1.0,
                      u[N_NOISE_ROWS - 1:]])
