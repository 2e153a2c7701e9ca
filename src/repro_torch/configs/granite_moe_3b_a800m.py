"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base] — MoE,
40 experts top-8, d_expert=512, GQA kv=8.
"""
from repro_torch.configs.base import ATTN_MOE, ArchConfig, MoECfg, simple_stages

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155,
    moe=MoECfg(n_experts=40, top_k=8, d_expert=512),
    stages=simple_stages(ATTN_MOE, 32),
)
