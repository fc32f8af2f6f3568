"""The precision of the reference's Dense products.

The configurations state float32 with no TF32: the port's kernels run
float32 multiply-add chains.  "float32" is that.  "tf32" rounds both
operands of every Dense product (the policy's forward in the rollout and
the critic, the update's forward and backward) to TF32's 10-bit mantissa
before a float32 product, as Hopper's TF32 tensor cores take them: the
benchmark's control, the nearest precision below the one the
configurations state, which the comparison has to refuse.
"""

from __future__ import annotations

import torch

MODES = ("float32", "tf32")
_mode = ["float32"]


def set_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"precision must be one of {MODES}, not {mode!r}")
    _mode[0] = mode


def mode() -> str:
    return _mode[0]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to nearest even at 10 mantissa bits."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32)


def operand(x: torch.Tensor) -> torch.Tensor:
    """x as a Dense product takes it in the current mode."""
    return round_tf32(x) if _mode[0] == "tf32" else x


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with TF32 off, on operands taken in the current mode."""
    return operand(a) @ operand(b)
