"""Diagonal PopArt value-head normalization (port of
`madrona_basketball_tpu.models.popart`, popart.py:22-64).

Functional port of the reference's `DiagonalPopArt` (scripts/agent.py:
53-94), defined there but unused by the training path and kept for
capability parity.  It tracks EMA first and second moments of the targets
and rescales the value head's weight and bias so that past predictions
stay consistent when the statistics move ("Preserving Outputs Precisely
while Adaptively Rescaling Targets").  `head_kernel` is (in, dim), the
JAX Dense layout.
"""

from __future__ import annotations

import dataclasses

import torch

F32 = torch.float32
EPS = 1e-5


@dataclasses.dataclass
class PopArtState:
    m: torch.Tensor       # (dim,) first moment
    v: torch.Tensor       # (dim,) second moment
    debias: torch.Tensor  # (1,)
    momentum: float = 0.1


def popart_init(dim: int, momentum: float = 0.1,
                device="cuda") -> PopArtState:
    return PopArtState(m=torch.zeros((dim,), dtype=F32, device=device),
                       v=torch.full((dim,), EPS, dtype=F32, device=device),
                       debias=torch.zeros((1,), dtype=F32, device=device),
                       momentum=momentum)


def popart_normalize(st: PopArtState, x: torch.Tensor,
                     unnorm: bool = False) -> torch.Tensor:
    debias = torch.clamp(st.debias, min=EPS)
    mean = st.m / debias
    var = (st.v - st.m * st.m) / debias
    if unnorm:
        return (mean + torch.sqrt(var) * x).to(x.dtype)
    return ((x - mean) * torch.rsqrt(var)).to(x.dtype)


def popart_update(st: PopArtState, x: torch.Tensor,
                  head_kernel: torch.Tensor, head_bias: torch.Tensor):
    """Update the statistics; returns (state', rescaled kernel, rescaled
    bias)."""
    x = x.reshape(-1, x.shape[-1]).to(F32)
    running_m = x.mean(dim=0)
    running_v = (x * x).mean(dim=0)
    mom = st.momentum
    new_m = st.m * (1 - mom) + running_m * mom
    new_v = st.v * (1 - mom) + running_v * mom

    std = torch.sqrt(st.v - st.m * st.m)
    new_std_inv = torch.rsqrt(new_v - new_m * new_m)
    scale = std * new_std_inv
    shift = (st.m - new_m) * new_std_inv

    new_bias = head_bias * scale + shift
    new_kernel = head_kernel * scale[None, :]
    new_state = dataclasses.replace(st, m=new_m, v=new_v,
                                    debias=st.debias * (1 - mom) + mom)
    return new_state, new_kernel, new_bias
