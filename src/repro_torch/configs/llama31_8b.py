"""llama3.1-8b — the paper's dense evaluation model (§III-A)."""
from repro_torch.configs.base import ATTN_MLP, ArchConfig, simple_stages

CONFIG = ArchConfig(
    name="llama3.1-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=128256, rope_theta=5e5,
    stages=simple_stages(ATTN_MLP, 32),
)
