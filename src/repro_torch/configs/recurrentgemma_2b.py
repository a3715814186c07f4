"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2 recurrent : 1
attention. [arXiv:2402.19427; hf]

26L d_model=2560 10H (GQA kv=1 = MQA) d_ff=7680 vocab=256000, head_dim=256,
local attention window 2048.  26 layers = 8 x (rglru, rglru, attn) + 2
trailing rglru layers.  ~2.9B parameters.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    local_window=2048,
    tie_embeddings=True,
    block_pattern=("rglru", "rglru", "attn"),
    notes="O(1)-state + bounded-window decode => long_500k applicable; "
          "10 heads => head-TP falls back to d_ff TP on 16-way axes.",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        n_layers=5,           # 1 group (R,R,A) + tail (R,R): exercises both paths
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        local_window=16,
        tie_embeddings=True,
        block_pattern=("rglru", "rglru", "attn"),
    )
