"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, at the
700 W power limit), and the least time of a piece of work at them."""

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12


def bound_s(nbytes: float, tensor_flops: float = 0.0) -> float:
    """The larger of bytes over the HBM rate and bf16 tensor-core
    operations over their peak."""
    return max(nbytes / HBM_BYTES_PER_S, tensor_flops / BF16_TENSOR_FLOPS)
