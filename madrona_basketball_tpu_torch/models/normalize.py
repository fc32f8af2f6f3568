"""Running mean/std normalizers (port of
`madrona_basketball_tpu.models.normalize`, normalize.py:30-139).

The state stays float32, like the JAX package (the reference's f64
buffers are not copied).  `RMSState` is a plain dataclass of tensors;
every function returns a new state.
"""

from __future__ import annotations

import dataclasses

import torch

F32 = torch.float32
EPS = 1e-5


@dataclasses.dataclass
class RMSState:
    mean: torch.Tensor   # (dim,) f32
    var: torch.Tensor    # (dim,) f32
    count: torch.Tensor  # () f32


def rms_init(dim: int, device="cuda") -> RMSState:
    return RMSState(mean=torch.zeros((dim,), dtype=F32, device=device),
                    var=torch.ones((dim,), dtype=F32, device=device),
                    count=torch.ones((), dtype=F32, device=device))


def rms_normalize(st: RMSState, x, clamp: float = 5.0):
    out = (x - st.mean) * torch.rsqrt(st.var + EPS)
    if clamp:
        out = torch.clamp(out, -clamp, clamp)
    return out


def rms_unnormalize(st: RMSState, x, clamp: float = 5.0):
    if clamp:
        x = torch.clamp(x, -clamp, clamp)
    return st.mean + torch.sqrt(st.var + EPS) * x


def _rms_merge(st: RMSState, mean, var, count) -> RMSState:
    """Chan parallel merge of batch (mean, var, count) into the running
    stats (scripts/agent.py:40-50)."""
    count_ = count + st.count
    delta = mean - st.mean
    m = (st.var * st.count + var * count +
         delta ** 2 * st.count * count / count_)
    return RMSState(mean=st.mean + delta * count / count_,
                    var=m / count_, count=count_)


def _pad_tail(st: RMSState, used: int, n):
    """Closed-form Chan merge for features that are ALL ZERO in the batch
    (delta = -mean, batch var = 0)."""
    count_ = st.count + n
    pad_mean = st.mean[used:]
    pad_var = st.var[used:]
    new_pad_mean = pad_mean * (st.count / count_)
    m = pad_var * st.count + pad_mean ** 2 * st.count * n / count_
    return new_pad_mean, m / count_


def _count(n: int, device):
    """A batch count as a 0-d float32 tensor, made by a fill (no host
    copy, so a CUDA graph can capture it)."""
    return torch.full((), float(n), dtype=F32, device=device)


def rms_update(st: RMSState, x) -> RMSState:
    """Merge a batch (N, dim) with its unbiased variance."""
    x = x.reshape(-1, x.shape[-1]).to(F32)
    count = _count(x.shape[0], x.device)
    mean = x.mean(dim=0)
    var = ((x - mean) ** 2).sum(dim=0) / torch.clamp(count - 1.0, min=1.0)
    return _rms_merge(st, mean, var, count)


def _with_tail(st: RMSState, sub: RMSState, used: int, n) -> RMSState:
    """`sub` (the first `used` features merged) joined to the closed-form
    merge of the structural-zero tail."""
    new_pad_mean, new_pad_var = _pad_tail(st, used, n)
    return RMSState(mean=torch.cat([sub.mean, new_pad_mean]),
                    var=torch.cat([sub.var, new_pad_var]),
                    count=sub.count)


def _head(st: RMSState, used: int) -> RMSState:
    return RMSState(mean=st.mean[:used], var=st.var[:used], count=st.count)


def rms_update_padded(st: RMSState, x) -> RMSState:
    """`rms_update` where the batch's features >= x.shape[-1] are all zero
    and not materialized (the obs tail, constants.OBS_USED)
    (normalize.py:76-91)."""
    used = x.shape[-1]
    sub = rms_update(_head(st, used), x)
    return _with_tail(st, sub, used, _count(x.reshape(-1, used).shape[0],
                                            x.device))


def rms_update_padded_tdw(st: RMSState, x) -> RMSState:
    """`rms_update_padded` of a feature-major (T, used, W) batch, the
    rollout kernel's trajectory layout, reduced over (T, W) without the
    (T * W, used) relayout (normalize.py:94-110)."""
    used = x.shape[1]
    n = _count(x.shape[0] * x.shape[2], x.device)
    mean = x.mean(dim=(0, 2))
    var = ((x - mean[None, :, None]) ** 2).sum(dim=(0, 2)) / \
        torch.clamp(n - 1.0, min=1.0)
    return _with_tail(st, _rms_merge(_head(st, used), mean, var, n), used, n)


def rms_update_padded_moments(st: RMSState, mean, m2, n) -> RMSState:
    """Merge per-feature batch moments (mean, centred M2, count) of the
    first `mean.shape[0]` features; the rest are the structural-zero obs
    tail."""
    used = mean.shape[0]
    n = torch.as_tensor(n, dtype=F32, device=mean.device)
    var = m2 / torch.clamp(n - 1.0, min=1.0)
    return _with_tail(st, _rms_merge(_head(st, used), mean, var, n), used, n)
