"""Published peaks of one NVIDIA H100 SXM (dense rates at its 700 W
limit; NVIDIA's data sheet)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
MEMORY_BYTES = 80e9
