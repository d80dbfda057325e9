"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

HBM_BYTES_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12   # matrix products of bf16 (and fp16) operands
TF32_TENSOR_FLOPS = 495e12   # matrix products of float32 operands on the tensor cores
F32_FLOPS = 67e12            # float32 arithmetic on the CUDA cores

# the whole step's peak for a model of each compute dtype (``mfu``)
MODEL_PEAK = {"bfloat16": BF16_TENSOR_FLOPS, "float32": TF32_TENSOR_FLOPS}
