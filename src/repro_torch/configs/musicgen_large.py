"""musicgen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens;
4 codebooks -> 4 parallel output heads over vocab 2048. The EnCodec frontend
is a stub: input_specs() provides precomputed (summed) frame embeddings.
Cross-attention text conditioning is out of backbone scope (DESIGN.md §5).
"""
from repro_torch.configs.base import ATTN_MLP, ArchConfig, simple_stages

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048, n_codebooks=4, embed_inputs=False, mlp_gated=False,
    stages=simple_stages(ATTN_MLP, 48),
)
