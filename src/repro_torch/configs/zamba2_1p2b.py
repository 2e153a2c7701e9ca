"""zamba2-1.2b [arXiv:2411.15242; hf] — hybrid: Mamba2 (SSD) backbone with a
single *shared* attention+MLP block applied every 6th layer. 38 layers =
6 superblocks of (5 mamba + 1 mamba+shared-attn) + 2 trailing mamba.
"""
from repro_torch.configs.base import MAMBA2, ZAMBA_SUPER, ArchConfig, SSMCfg, Stage

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000,
    ssm=SSMCfg(d_state=64, expand=2, head_dim=64, chunk=256),
    stages=(Stage(ZAMBA_SUPER, 6), Stage(MAMBA2, 2)),
    subquadratic=True,
)
