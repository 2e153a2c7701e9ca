"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base] — MoE,
32 experts top-8, d_expert=512, GQA kv=8.
"""
from repro_torch.configs.base import ATTN_MOE, ArchConfig, MoECfg, simple_stages

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155,
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512),
    stages=simple_stages(ATTN_MOE, 24),
)
