"""xlstm-125m [arXiv:2405.04517] — alternating mLSTM/sLSTM blocks; d_ff=0
(the blocks carry their own projections). 12 layers = 6 (mLSTM, sLSTM) pairs.
Fully recurrent -> O(1)-state decode, runs long_500k.
"""
from repro_torch.configs.base import XLSTM_PAIR, ArchConfig, Stage

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_head=192,
    d_ff=0, vocab=50304,
    stages=(Stage(XLSTM_PAIR, 6),),
    subquadratic=True,
)
