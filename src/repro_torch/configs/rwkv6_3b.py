"""rwkv6-3b [ssm] — Finch, data-dependent decay. [arXiv:2404.05892; hf]

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.  head size 64
(40 wkv heads), untied embeddings.  ~3.1B parameters.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # d_model / rwkv_head_dim; informational for rooflines
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,
    notes="attention-free; O(1)-state decode => long_500k applicable.",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        family="ssm",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        rwkv_head_dim=16,
    )
