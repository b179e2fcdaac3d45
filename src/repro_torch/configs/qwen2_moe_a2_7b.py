"""qwen2-moe-a2.7b — MoE LM [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16, head_dim 128) vocab=151936.
MoE every layer: 60 routed top-4 + shared expert (4x1408=5632 wide).
60 % 16 != 0 -> no EP; TP inside experts (moe_ff 1408/16; DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-moe-a2.7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    n_experts=60,
    n_shared_experts=4,
    experts_per_token=4,
    moe_d_ff=1408,
    moe_layer_period=1,
    pad_multiple=16,
)
