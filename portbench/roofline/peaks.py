"""Published dense peaks of one NVIDIA H100 SXM at its 700 W limit
(NVIDIA's data sheet): the rates every roofline share is taken against."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
