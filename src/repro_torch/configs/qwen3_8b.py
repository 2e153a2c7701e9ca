"""qwen3-8b [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, qk_norm."""
from repro_torch.configs.base import ATTN_MLP, ArchConfig, simple_stages

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12288, vocab=151936, qk_norm=True, rope_theta=1e6,
    stages=simple_stages(ATTN_MLP, 36),
)
