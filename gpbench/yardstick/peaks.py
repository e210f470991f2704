"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit; a result states the card's limit beside
every share of them)."""

PEAK_BYTES_S = 3.35e12   # HBM3
PEAK_FP32_S = 67e12      # float32 outside the tensor cores (an FMA is 2 FLOP)
