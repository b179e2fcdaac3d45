"""internvl2-1b — VLM: InternViT frontend (STUB) + Qwen2-0.5B-class backbone
[arXiv:2404.16821].

Backbone: 24L d_model=896 14H (GQA kv=2, head_dim 64) d_ff=4864
vocab=151655. The ViT frontend is a stub per the assignment spec:
``input_specs()`` provides 256 precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "internvl2-1b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1000000.0,
    frontend="vit_stub",
    frontend_tokens=256,
    pad_multiple=16,
)
