"""Criss-cross attention — plain-torch version (NHWC).

Counterpart of :mod:`ccnet_tpu.ops.cc_attention`, with the same semantics:
every pixel ``(h, w)`` attends over the union of its column (``H`` slots)
and its row (``W`` slots) with ONE joint softmax over the concatenated
``H + W`` axis. The column-path self slot ``h' == h`` is set to the finite
``NEG_INF = -1e9`` (not −inf), so the self pixel counts once (through the
row path) and an ``H == 1`` image, whose column path is all self slot,
stays finite.

This is the plain version beside the CUDA kernels of
:mod:`ccnet_tpu_torch.ops.cc_attention_cuda`: the model's ``impl="torch"``
route, the wrapper's route for CPU tensors, and the oracle every kernel
test holds the kernels against.

Layout: q/k/v are NHWC ``(B, H, W, C)`` like the JAX op, so tests compare
like with like; the NCHW model permutes at the call site.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9  # finite −inf stand-in: keeps an all-masked column path NaN-free


def cca_logits_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, W, H + W) f32 logits: column slots [0, H) with the h'==h
    diagonal at ``NEG_INF``, then row slots [H, H+W)."""
    H = q.shape[1]
    q32, k32 = q.float(), k.float()
    e_col = torch.einsum("bhwc,bkwc->bhwk", q32, k32)
    diag = torch.eye(H, dtype=torch.bool, device=q.device)[:, None, :]  # (H, 1, H)
    e_col = e_col.masked_fill(diag[None], NEG_INF)
    e_row = torch.einsum("bhwc,bhvc->bhwv", q32, k32)
    return torch.cat([e_col, e_row], dim=-1)


def criss_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Criss-cross attention core (no projections, no residual).

    q, k: (B, H, W, Cq); v: (B, H, W, Cv). Returns (B, H, W, Cv) in v's dtype.
    Logits and products accumulate in f32; the attention weights are rounded
    to v's dtype before the aggregation, as the JAX op does.
    """
    H = q.shape[1]
    att = torch.softmax(cca_logits_reference(q, k), dim=-1)
    att = att.to(v.dtype).float()
    v32 = v.float()
    out_col = torch.einsum("bhwk,bkwc->bhwc", att[..., :H], v32)
    out_row = torch.einsum("bhwv,bhvc->bhwc", att[..., H:], v32)
    return (out_col + out_row).to(v.dtype)


def criss_cross_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``(out f32, m, L)``: the normalised output and the joint-softmax row
    max ``m`` and sum ``L = Σ exp(logits − m)``, each ``(B, H, W)`` f32.

    Mirrors ``_fwd_jnp_stats`` of the JAX kernel module; ``(m, L)`` are the
    O(HW) residuals a backward pass recomputes the probabilities from.
    """
    H = q.shape[1]
    logits = cca_logits_reference(q, k)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    L = p.sum(dim=-1)
    att = p / L[..., None]
    v32 = v.float()
    out_col = torch.einsum("bhwk,bkwc->bhwc", att[..., :H], v32)
    out_row = torch.einsum("bhwv,bhvc->bhwc", att[..., H:], v32)
    return out_col + out_row, m, L
