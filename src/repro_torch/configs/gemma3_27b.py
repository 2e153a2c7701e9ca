"""gemma3-27b [hf:google/gemma-3-27b-pt] — dense, GQA kv=16, 5:1 local:global
sliding window (1024), qk_norm, 128k nominal context. Layer i is global iff
i % 6 == 5. Sub-quadratic for long_500k: 5/6 of layers are windowed and the
global layers at decode are linear-in-cache single-query reads.
"""
from repro_torch.configs.base import ATTN_MLP, ArchConfig, Stage

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=21504, vocab=262144, qk_norm=True, rope_theta=1e6,
    sliding_window=1024,
    stages=(Stage(ATTN_MLP, 62, local_global_period=6),),
    subquadratic=True,
)
