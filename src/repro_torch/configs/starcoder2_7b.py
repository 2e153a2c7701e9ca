"""starcoder2-7b [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE."""
from repro_torch.configs.base import ATTN_MLP, ArchConfig, simple_stages

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab=49152, rope_theta=1e5, mlp_gated=False,
    stages=simple_stages(ATTN_MLP, 32),
)
