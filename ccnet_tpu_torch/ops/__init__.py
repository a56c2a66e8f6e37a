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

__all__ = [
    "LAUNCHES",
    "CrissCrossAttentionFn",
    "UpsampledNLLFn",
    "adaptive_avg_pool",
    "cca_logits_reference",
    "criss_cross_attention",
    "criss_cross_attention_cuda",
    "criss_cross_attention_stats",
    "max_pool_ceil",
    "resize_bilinear_align_corners",
    "upsampled_nll_reference",
]
