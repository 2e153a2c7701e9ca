"""qwen1.5-32b [hf:Qwen/Qwen1.5-32B] — dense, QKV bias, kv=40 (MHA)."""
from repro_torch.configs.base import ATTN_MLP, ArchConfig, simple_stages

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_head=128,
    d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1e6,
    stages=simple_stages(ATTN_MLP, 64),
)
