"""DANet's two attentions (Fu et al., CVPR 2019, junfu1115/DANet ``PAM_Module``
and ``CAM_Module``), each a ``torch.autograd.Function`` so that a profiler
trace names the device work launched from its forward and its backward.

* :class:`PositionAttentionFn`, position attention over all N = H·W
  positions: q, k ``(B, N, Cq)`` and v ``(B, N, Cv)`` in, ``out_i = Σ_j
  softmax_j(q_i·k_j) v_j`` ``(B, N, Cv)`` out, with scale 1 (the published
  module has no 1/√Cq) and a value width other than the query width (512
  and 64). At a 769² crop N = 97² = 9409: the affinity is N² = 88.5 M
  entries an image, 2.83 GB in f32 at batch 8, so the card's route never
  holds it whole. The routes, one a call, each counted as
  ``danet.pam.<route>``:

  - ``sdpa`` (the card's; the CPU runs it too in fp16 or bf16, which the
    tests use): torch's fused ``scaled_dot_product_attention``, which
    computes q·kᵀ in f32 a tile at a time, keeps only ``out`` and the rows'
    log-sum-exp, and recomputes the tiles in its backward. Flash attention
    needs equal query and value widths, so v's Cv channels go in as Cv/Cq
    heads of Cq, every head sharing q and k: the same softmax weights on
    each slice of v, the exact mathematics (autograd sums dq and dk over
    the heads). On an H100 at batch 8 of 97² positions that runs forward
    and backward 3.2× faster than the memory-efficient backend on the whole
    width, and 1.5× faster than exact attention a block of queries at a
    time with cuBLAS products and an f32 softmax (PERF.md). bf16 and fp16
    take flash attention, f32 the
    memory-efficient backend (flash has no f32 kernel). Held to that
    backend it raises where it cannot run, rather than fall back to the
    math backend, which would materialise N².
  - ``plain`` (CPU): matmul, f32 softmax, matmul under autograd, the whole
    affinity at the small sizes CPU runs have.

* :class:`ChannelAttentionFn`, channel attention: x ``(B, C, N)`` in, ``out
  = A·x`` with ``A = softmax_j(max_k E_ik − E_ij)`` and ``E = x·xᵀ`` out.
  E's entries are sums of N products of non-negative ReLU outputs: in the
  thousands at N = 9409, where bf16's spacing is 8 to 32, and a rounding of
  16 moves a softmax weight by e¹⁶. So E, its max-subtraction and the
  softmax are f32 whatever x's dtype (bf16 values are exact in f32, their
  products too), and only ``A·x`` runs in x's dtype. A is C×C a batch row
  and is kept for the backward.

No route falls back to another: a CUDA tensor takes the card's route and a
CPU tensor the plain one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ccnet_tpu_torch.utils import trace

PAM_ROUTES = ("sdpa", "plain")


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, in f32: exact products of bf16 or f32 values with
    f32 sums. On a card bf16 operands go to cuBLAS with an f32 result."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def position_attention_plain(q, k, v):
    """The plain version: the whole affinity, f32 softmax, under autograd."""
    a = torch.softmax(_mm32(q, k.transpose(1, 2)), dim=-1)
    return torch.bmm(a.to(v.dtype), v)


def _sdpa(q, k, v):
    """The fused route: v as Cv/Cq heads of Cq sharing q and k."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, N, Cq = q.shape
    Cv = v.shape[2]
    if Cv % Cq:
        raise ValueError(f"the sdpa route splits v's {Cv} channels into heads of q's {Cq}")
    heads = Cv // Cq
    backend = (SDPBackend.FLASH_ATTENTION if q.dtype in (torch.bfloat16, torch.float16)
               else SDPBackend.EFFICIENT_ATTENTION)
    qh = q[:, None].expand(B, heads, N, Cq)
    kh = k[:, None].expand(B, heads, N, Cq)
    vh = v.view(B, N, heads, Cq).transpose(1, 2)
    with sdpa_kernel([backend]):
        out = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
    return out.transpose(1, 2).reshape(B, N, Cv)


class PositionAttentionFn(torch.autograd.Function):
    """``apply(q (B, N, Cq), k (B, N, Cq), v (B, N, Cv), route)`` → ``(B, N,
    Cv)``: position attention with scale 1 on ``route`` (one of
    :data:`PAM_ROUTES`)."""

    @staticmethod
    def forward(ctx, q, k, v, route: str):
        if route not in PAM_ROUTES:
            raise ValueError(f"unknown position-attention route {route!r}; have {PAM_ROUTES}")
        trace.count(f"danet.pam.{route}")
        fn = _sdpa if route == "sdpa" else position_attention_plain
        if not any(ctx.needs_input_grad[:3]):
            return fn(q, k, v)
        # the inner graph keeps what its own backward needs: for sdpa q, k,
        # v, out and the log-sum-exp, for the plain version the affinity
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves)
        ctx.inner = (leaves, out)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        leaves, out = ctx.inner
        ctx.inner = None
        dq, dk, dv = torch.autograd.grad(out, leaves, g.contiguous())
        return dq, dk, dv, None


def pam_route(x: torch.Tensor) -> str:
    """The route a tensor's device takes: the card's, or the plain one."""
    return "sdpa" if x.is_cuda else "plain"


def position_attention(q, k, v):
    """:class:`PositionAttentionFn` on the route of q's device."""
    return PositionAttentionFn.apply(q, k, v, pam_route(q))


class ChannelAttentionFn(torch.autograd.Function):
    """``apply(x (B, C, N))`` → ``(B, C, N)`` in x's dtype: ``A·x`` with ``A
    = softmax_j(max_k E_ik − E_ij)``, ``E = x·xᵀ``, E and A in f32."""

    @staticmethod
    def forward(ctx, x):
        trace.count("danet.cam.calls")
        e = _mm32(x, x.transpose(1, 2))
        a = torch.softmax(e.amax(dim=-1, keepdim=True) - e, dim=-1)
        ctx.save_for_backward(x, a)
        return torch.bmm(a.to(x.dtype), x)

    @staticmethod
    def backward(ctx, g):
        x, a = ctx.saved_tensors
        g = g.contiguous()
        da = _mm32(g, x.transpose(1, 2))
        # A = softmax(m − E): the row max m shifts a row and moves no weight,
        # so dE = −softmax'(dA)
        de = a * ((a * da).sum(dim=-1, keepdim=True) - da)
        dx = torch.bmm(a.to(x.dtype).transpose(1, 2), g).float()
        dx += _mm32((de + de.transpose(1, 2)).to(torch.float32), x.float())
        return dx.to(x.dtype)


def channel_attention(x):
    """:class:`ChannelAttentionFn` of x ``(B, C, N)``."""
    return ChannelAttentionFn.apply(x)
