"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W): TF32
on the tensor cores and HBM3 bandwidth.  The port's kernels compute every
product in 3xTF32 (three TF32 passes a product), so their scale is a third
of the TF32 rate."""

TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12
TF32X3_FLOPS = TF32_FLOPS / 3
