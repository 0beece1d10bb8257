"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12      # HBM3
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
F64_FLOPS_PER_S = 34e12        # float64 outside the tensor cores


def bound_s(nbytes: float, flops: float = 0.0, f64: bool = False) -> float:
    """The least time of a call: the larger of its bytes over the memory
    rate and its operations over the float32 (or float64) rate."""
    rate = F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S
    return max(nbytes / HBM_BYTES_PER_S, flops / rate)
