"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355].

64L d_model=4096, d_inner=8192 (expand 2), ssm_state=16, conv 4,
dt_rank=256, vocab 65024. ``long_500k`` RUNS (linear-time SSM).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "falcon-mamba-7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,           # unused (attention-free)
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    attn_type="none",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dt_rank=256,
    pad_multiple=16,
)
