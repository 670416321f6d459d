"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    'bfloat16': 989e12,         # tensor cores
    'float16': 989e12,
    'float8': 1979e12,
    'tf32': 495e12,
    'float32': 67e12,           # outside the tensor cores
}


def least_seconds(flops: float, moved_bytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations over
    the peak rate of ``dtype`` and the bytes over the memory bandwidth."""
    return max(flops / FLOPS_PER_S[dtype], moved_bytes / HBM_BYTES_PER_S)
