"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): HBM3 bandwidth and float32 outside the
tensor cores.  A roofline share is stated against these, with the card's
power limit beside it."""

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for ``nbytes`` and ``ops``
    float32 operations: the larger of the two quotients."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)
