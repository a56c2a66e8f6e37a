"""The port's CUDA kernels on the card, vs their plain-torch versions.

Every test here needs a CUDA card of compute capability 9.0 and ``nvcc``,
and skips without one (here on the CPU they all skip). The file imports
no JAX, so on the card it runs without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Tolerances: f32 (TF32 off) at 1e-4 x scale, where only the summation order
differs; bf16 against the plain version computed in f32 from the same bf16
inputs at 2e-2 x scale (the kernels round their output to bf16); the model
at 5e-2 x scale with argmax agreement >= 99.5 % (bf16 layers after CCA).
"""

import numpy as np
import pytest
import torch

from ccnet_tpu_torch.ops import cc_attention as plain
from ccnet_tpu_torch.ops import cc_attention_cuda as K
from ccnet_tpu_torch.utils import is_hopper

SHAPES = [
    (1, 5, 6, 4, 8),
    (2, 9, 8, 8, 16),
    (1, 1, 7, 4, 8),      # H=1: column path fully masked
    (1, 7, 1, 4, 8),      # W=1
    (8, 97, 97, 64, 512),  # the sliding-window tile batch
    (1, 129, 257, 64, 512),  # the whole 1024x2048 image
]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    if not is_hopper():
        pytest.skip("the kernels are built for sm_90a (H100/H200)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def case(seed, B, H, W, Cq, Cv):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, Cq).astype(np.float32),
            rng.randn(B, H, W, Cq).astype(np.float32),
            rng.randn(B, H, W, Cv).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(cuda, shape, dtype):
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype)) for a in case(4, *shape))
    q32, k32, v32 = q.float(), k.float(), v.float()
    before = dict(K.LAUNCHES)
    with torch.inference_mode():
        col = K.cca_fwd_col(q, k, v)
        pairs = list(zip(col, K.cca_fwd_col_plain(q32, k32, v32)))
        pairs += zip(K.cca_fwd_row(q, k, v, *col), K.cca_fwd_row_plain(q32, k32, v32, *col))
        pairs += zip(K.criss_cross_attention_cuda(q, k, v),
                     plain.criss_cross_attention_stats(q32, k32, v32))
    assert K.LAUNCHES == {n: c + 2 for n, c in before.items()}
    for got, want in pairs:
        scale = max(1.0, want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= tol * scale


def test_tiny_model_kernel_route_matches_plain(cuda):
    from ccnet_tpu_torch.models import CCNet

    torch.manual_seed(0)
    model = CCNet(num_classes=5, layers=(1, 1, 1, 1), recurrence=2, drop_rate=0.0,
                  dtype=torch.bfloat16).eval().to(cuda)
    model.head.cca.gamma.data.fill_(0.5)  # gamma = 0 would hide the attention path
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 129, 129)
                         .astype(np.float32) * 50).to(cuda)
    with torch.inference_mode():
        model.set_cca_impl("kernel")
        got = model(x)["main"]
        model.set_cca_impl("torch")
        want = model(x)["main"]
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 5e-2 * scale
    assert (got.argmax(1) == want.argmax(1)).float().mean().item() >= 0.995
