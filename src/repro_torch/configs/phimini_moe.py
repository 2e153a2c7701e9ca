"""phimini-moe — the paper's MoE evaluation model (§III-A): 16 experts top-2."""
from repro_torch.configs.base import ATTN_MOE, ArchConfig, MoECfg, simple_stages

CONFIG = ArchConfig(
    name="phimini-moe", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=960, vocab=32064,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=960),
    stages=simple_stages(ATTN_MOE, 32),
)
