from tpuclip_torch.ops.patch_embed import patch_embed_fused  # noqa: F401
from tpuclip_torch.ops.topk_int8 import (  # noqa: F401
    int8_candidates,
    int8_candidates_packed,
    int8_scores,
    topk_int8_rerank_fused,
    topk_int8_rerank_fused_auto,
    topk_int8_scores,
)
