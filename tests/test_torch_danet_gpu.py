"""DANet's attentions on the card (``ops/dual_attention.py``).

Every test here needs a CUDA card and skips without one (here on the CPU
they all skip). No JAX: on the card

    python -m pytest --noconftest tests/test_torch_danet_gpu.py -q

* :class:`PositionAttentionFn` on the card's route at the cell's shape (B =
  2, N = 97² = 9409, Cq 64, Cv 512, bf16) against the plain op in f32 an
  image at a time (the whole affinity, 354 MB an image), forward and
  backward. Tolerances: q·kᵀ is computed in f32 from the bf16 values on
  both sides; the card's route rounds p (in [0, 1]) to bf16 before p·v, as
  flash attention does, and its outputs to bf16: 2^-7 of each result's
  magnitude covers those two roundings (2^-9 each) summed over the row's
  weights. The backward's dq and dk are sums of N products of p with the
  difference ``dp − Σ p·dp``, taken from bf16 operands: 2^-6 of their
  magnitude;
* the card's route holds far less than one bf16 N×N affinity at the cell's
  batch of 8 (1.42 GB): under half of it above the inputs, forward and
  backward, where what it holds grows with N alone (out and the grads, q
  and k copied to every head of v, flash attention's f32 dq accumulator:
  0.47 GB measured);
* a DANet training step on the card counts no ``danet.pam.plain`` call.
"""

import pytest
import torch

from ccnet_tpu_torch.models import build_model, registry
from ccnet_tpu_torch.ops import dual_attention as da
from ccnet_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu

B, N, CQ, CV = 2, 97 * 97, 64, 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the position attention's card route")
    return torch.device("cuda")


def _inputs(batch, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    # q, k as a 1×1 convolution of BN + ReLU outputs gives them: logits
    # spread by a few units over the row
    q, k = (torch.randn(batch, N, CQ, device=device, generator=g).mul_(0.4).bfloat16()
            for _ in range(2))
    v, gout = (torch.randn(batch, N, CV, device=device, generator=g).bfloat16()
               for _ in range(2))
    return q, k, v, gout


def test_position_attention_at_cell_shape(cuda):
    q, k, v, gout = _inputs(B, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    route = da.pam_route(q)
    out = da.PositionAttentionFn.apply(*leaves, route)
    grads = torch.autograd.grad(out, leaves, gout)
    for b in range(B):
        ref_leaves = [t[b:b + 1].float().requires_grad_() for t in (q, k, v)]
        ref = da.position_attention_plain(*ref_leaves)
        ref_grads = torch.autograd.grad(ref, ref_leaves, gout[b:b + 1].float())
        got = [out] + list(grads)
        want = [ref] + list(ref_grads)
        for name, x, y, tol in zip(("out", "dq", "dk", "dv"), got, want,
                                   (2 ** -7, 2 ** -6, 2 ** -6, 2 ** -7)):
            err = float((x[b:b + 1].float() - y).abs().max())
            assert err <= tol * float(y.abs().max()), (name, b, err)


def test_position_attention_memory_far_below_affinity(cuda):
    q, k, v, gout = _inputs(8, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = da.position_attention(*leaves)
    torch.autograd.grad(out, leaves, gout)
    torch.cuda.synchronize()
    affinity = 8 * N * N * 2
    assert torch.cuda.max_memory_allocated() - base < affinity / 2


def test_training_step_takes_no_plain_route(cuda, monkeypatch):
    from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setitem(registry._DEPTH_LAYERS, 50, (1, 1, 1, 1))
    before = trace.counts()
    trainer = Trainer(TrainConfig(model="danet", depth=50, num_classes=19,
                                  input_size=(129, 129), batch_size=2, bf16=True, ohem=True,
                                  ohem_keep=1000, export_pth=False, device="cuda"))
    x = torch.randn(2, 3, 129, 129, device=cuda) * 40
    y = torch.randint(0, 19, (2, 129, 129), device=cuda, dtype=torch.int32)
    trainer.train_step(trainer.state, x, y)
    torch.cuda.synchronize()
    after = trace.counts()
    assert after.get("danet.pam.plain", 0) == before.get("danet.pam.plain", 0)
    assert after.get(f"danet.pam.{da.pam_route(x)}", 0) > before.get(
        f"danet.pam.{da.pam_route(x)}", 0)
    model = build_model("danet", num_classes=19, depth=50, device=cuda)
    with torch.inference_mode():
        model(x[:1])
    assert trace.counts().get("danet.pam.plain", 0) == before.get("danet.pam.plain", 0)
