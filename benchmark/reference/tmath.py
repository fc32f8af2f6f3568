"""A frozen copy of the port's
`madrona_basketball_tpu_torch/ops/tmath.py`, for the benchmark's
reference; it stays as it is when the port's copy changes.  Its own
docstring follows.

Polynomial atan / erf (port of `madrona_basketball_tpu.ops.tmath`).

The sim uses these instead of libm so the plain torch step, the CUDA
kernels (csrc/sim_world.cuh, same coefficients) and the JAX package all
compute the same float32 function and agree to ~1e-6.
"""

from __future__ import annotations

import torch

HALF_PI = 1.5707963267948966


def atan(x: torch.Tensor) -> torch.Tensor:
    """11th-order odd minimax polynomial on |t| <= 1 plus
    atan(x) = sign(x) * pi/2 - atan(1/x) for |x| > 1."""
    ax = torch.abs(x)
    big = ax > 1.0
    t = torch.where(big, 1.0 / torch.clamp(ax, min=1e-30), ax)
    r = t * t
    p = torch.full_like(r, -0.0117212)
    p = p * r + 0.05265332
    p = p * r - 0.11643287
    p = p * r + 0.19354346
    p = p * r - 0.33262347
    p = p * r + 0.99997726
    a = t * p
    a = torch.where(big, HALF_PI - a, a)
    return torch.where(x < 0.0, -a, a)


def erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7)."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    p = torch.full_like(t, 1.061405429)
    p = p * t - 1.453152027
    p = p * t + 1.421413741
    p = p * t - 0.284496736
    p = p * t + 0.254829592
    y = 1.0 - p * t * torch.exp(-ax * ax)
    return s * y
