"""trinity-mini [hf:arcee-ai/Trinity-Mini] (``afmoe``) — 32 layers: 2 dense
SwiGLU layers of 6,144, then 30 MoE layers of 128 experts of 1,024, top 8,
and one shared expert; sigmoid router scores with a per-layer expert bias
for selection, the chosen scores renormalised and scaled by 2.826.  GQA
32 / 4 heads of 128 with QK norm and a sigmoid output gate; 3:1 local:
global attention (layer i is global iff i % 4 == 3, the others a 2,048
window with RoPE; global layers without RoPE); an RMSNorm before and after
each sublayer; the embedding times sqrt(d_model) (muP).
"""
import math

from repro_torch.configs.base import (ATTN_MLP, ATTN_MOE, ArchConfig,
                                      MoECfg, Stage)

CONFIG = ArchConfig(
    name="trinity-mini", family="moe",
    n_layers=32, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=6144, vocab=200192, qk_norm=True, rope_theta=10_000.0,
    sliding_window=2048, rope_local_only=True, attn_out_gate=True,
    sandwich_norm=True, embed_multiplier=math.sqrt(2048),
    # n_experts / top_k: every routed entry keeps a slot (dropless)
    moe=MoECfg(n_experts=128, top_k=8, d_expert=1024, capacity_factor=16.0,
               n_shared_experts=1, score_func="sigmoid", route_scale=2.826),
    stages=(Stage(ATTN_MLP, 2, local_global_period=4),
            Stage(ATTN_MOE, 30, local_global_period=4)),
)
