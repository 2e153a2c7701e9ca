"""chameleon-34b [arXiv:2405.09818] — early-fusion VLM: VQ image tokens share
a unified vocab with text; the modality frontend is a stub (input ids are
precomputed VQ codes). qk_norm per the paper.
"""
from repro_torch.configs.base import ATTN_MLP, ArchConfig, simple_stages

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=65536, qk_norm=True,
    stages=simple_stages(ATTN_MLP, 48),
)
