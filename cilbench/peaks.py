"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit).  A share is stated against these, with the
card's power limit printed beside it."""

F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores (TF32 off)
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9

# The peak a cell's precision runs at, by the configuration's "precision"
# and "tf32" keys.
def flop_peak(precision: str, tf32: bool) -> float:
    if precision.startswith("bf16"):
        return BF16_FLOP_PER_S
    return TF32_FLOP_PER_S if tf32 else F32_FLOP_PER_S
