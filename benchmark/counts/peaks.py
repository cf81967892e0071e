"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense
rates, 700 W). The card's ``power.limit`` is printed beside every share
computed against them."""
BF16_DENSE_FLOPS = 989e12       # tensor cores, bf16 in, f32 accumulate
F32_FLOPS = 67e12               # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 1.98e9            # the boost clock
SFU_PER_CLOCK_PER_SM = 16       # __popc and the exponential (CC 9.0 table)
SFU_OPS_PER_S = SFU_PER_CLOCK_PER_SM * SMS * SM_CLOCK_HZ
