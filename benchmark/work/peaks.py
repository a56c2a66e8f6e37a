"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

FLOPS = {  # per second, by the dtype of the products
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
