"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12     # float32 outside the tensor cores


def bound_s(nbytes: float, nops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S)
