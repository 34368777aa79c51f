"""Data-sheet peaks of one NVIDIA H100 SXM5 (80 GB HBM3) at its full 700 W
power limit: dense bf16 tensor-core FLOP/s without sparsity, HBM3 bytes/s,
and the fp32 rate of the CUDA cores, which bounds integer adds and
compares.  Peaks, not measurements."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS = 67e12


def bound_s(nbytes: float, flops: float = 0.0, ops: float = 0.0) -> float:
    """The least time the card could take: the largest of the bytes over
    HBM bandwidth, the tensor-core FLOPs over the bf16 peak and the
    CUDA-core operations over the fp32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS, ops / CUDA_CORE_OPS)
