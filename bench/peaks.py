"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W), the yardstick of the roofline and ``mfu`` metrics."""

#: HBM3 bandwidth, bytes a second
HBM_BYTES_S = 3.35e12
#: float32-accurate products on the tensor cores: each is three TF32
#: products (3xTF32), so a third of the 495 TFLOP/s TF32 rate
F32_TC_FLOPS = 495e12 / 3
#: float32 outside the tensor cores
F32_FLOPS = 67e12
