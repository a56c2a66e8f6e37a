from ccnet_tpu_torch.ops.cc_attention import (
    cca_logits_reference,
    criss_cross_attention,
    criss_cross_attention_stats,
)
from ccnet_tpu_torch.ops.cc_attention_cuda import (
    LAUNCHES,
    CrissCrossAttentionFn,
    criss_cross_attention_cuda,
)
from ccnet_tpu_torch.ops.pooling import adaptive_avg_pool, max_pool_ceil
from ccnet_tpu_torch.ops.resize import resize_bilinear_align_corners
from ccnet_tpu_torch.ops.upsampled_ce import UpsampledNLLFn, upsampled_nll_reference


def launch_counts() -> dict:
    """A copy of the launch count of every hand-written kernel's wrapper:
    the attention's (K1–K4, K7a/K7b, each tensor-core design also under its
    own name), the loss's (K5/K6), the probes' (P1–P5) and eval-mode ABN's
    (``abn_eval``, those with a residual also under ``abn_eval_residual``).
    Each wrapper adds one where it launches its kernel; the
    plain versions on the CPU add none."""
    from ccnet_tpu_torch.ops import abn_eval, cc_attention_cuda, probes, upsampled_ce

    return {name: n for counts in (cc_attention_cuda.LAUNCHES, upsampled_ce.LAUNCHES,
                                   probes.LAUNCHES, abn_eval.LAUNCHES)
            for name, n in counts.items()}


__all__ = [
    "LAUNCHES",
    "CrissCrossAttentionFn",
    "UpsampledNLLFn",
    "adaptive_avg_pool",
    "cca_logits_reference",
    "criss_cross_attention",
    "criss_cross_attention_cuda",
    "criss_cross_attention_stats",
    "launch_counts",
    "max_pool_ceil",
    "resize_bilinear_align_corners",
    "upsampled_nll_reference",
]
