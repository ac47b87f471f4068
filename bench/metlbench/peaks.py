"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W).  A card set to a lower power limit runs below them; every
result carries the card's name and power limit beside the shares."""

BF16_FLOP_PER_S = 989e12
FP8_FLOP_PER_S = 1979e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
