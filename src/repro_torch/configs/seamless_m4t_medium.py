"""seamless-m4t-medium — encoder-decoder multimodal [arXiv:2308.11596].

12L encoder + 12L decoder, d_model=1024 16H (kv=16, head_dim 64)
d_ff=4096 vocab=256206 (padded to 256208). The speech frontend is a STUB
per the assignment spec: ``input_specs()`` provides precomputed frame
embeddings for the encoder.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "seamless-m4t-medium"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    is_encoder_decoder=True,
    n_encoder_layers=12,
    frontend="speech_stub",
    pad_multiple=16,
)
