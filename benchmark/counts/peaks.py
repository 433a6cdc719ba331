"""Published peaks of one NVIDIA H100 SXM 80GB (NVIDIA's data sheet, dense, at its 700 W
limit), the yardstick of every roofline and utilisation share."""
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12
SM_CLOCK_HZ = 1.98e9  # boost clock
# 16 MUFU results per clock per SM on compute capability 9.0 x 132 SMs x the boost clock
SFU_PER_S = 16 * 132 * SM_CLOCK_HZ
