"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). A card set below 700 W
runs under these; the benchmark prints its limit beside every share."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores, dense
FP32_FLOPS = 67e12  # outside the tensor cores


def bound_s(bytes_moved: float, ops: float, op_rate: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory bandwidth and operations over their peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / op_rate)
