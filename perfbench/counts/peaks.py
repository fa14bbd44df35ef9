"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): bf16 tensor-core operations and HBM3 bytes."""

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
