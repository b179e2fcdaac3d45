"""deepseek-v3-671b — MoE with MLA + MTP [arXiv:2412.19437].

61L d_model=7168 128H (MLA) vocab=129280. MoE: 1 shared + 256 routed
top-8, expert d_ff=2048 (dense d_ff=18432 on the first 3 layers).
MLA: q_lora 1536, kv_lora 512, qk nope/rope 128/64, v 128. MTP head.

Default run config uses adafactor + bf16 state (fp32 Adam for 671B params
exceeds 256x16GB; see EXPERIMENTS.md §Dry-run notes).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "deepseek-v3-671b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,              # dense layers (first 3)
    vocab_size=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    moe_layer_period=1,
    first_dense_layers=3,
    mtp=True,
    pad_multiple=16,
)

RUN_OVERRIDES = dict(optimizer="adafactor", opt_state_dtype="bfloat16")
