"""Published peaks of one NVIDIA H100 SXM (data sheet, 700 W): 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM3."""

PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(ops / PEAK_F32, nbytes / HBM_BYTES_S)
