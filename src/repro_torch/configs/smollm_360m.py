"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, tied embeddings.
~362M parameters.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    notes="full attention: long_500k skipped.",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke",
        family="dense",
        n_layers=3,
        d_model=60,
        n_heads=3,
        n_kv_heads=1,
        head_dim=20,
        d_ff=96,
        vocab_size=256,
        tie_embeddings=True,
    )
