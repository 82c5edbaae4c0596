"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit; a card set lower runs slower under load)."""

BF16_FLOPS = 989e12     # bf16 / fp16 tensor cores, FLOP/s
FP8_FLOPS = 1979e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES = 3.35e12     # HBM3, bytes/s
HBM_CAPACITY = 80e9     # bytes
