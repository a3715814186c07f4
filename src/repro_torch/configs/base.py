"""Model / run configuration dataclasses.

The port keeps its own copy of ``ModelConfig``, ``MoEConfig`` and
``RunConfig``: the same fields with the same defaults as the JAX package's,
so a configuration converts field by field between the two.  Only the
methods the port's code paths use are carried over.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0           # per-expert hidden size
    n_shared_experts: int = 0      # qwen2-moe: always-on shared expert(s)
    d_ff_shared: int = 0           # total hidden size of the merged shared expert
    capacity_factor: float = 1.25
    group_size: int = 512          # tokens per dispatch group (einsum dispatch)
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA window (mixtral)
    local_window: Optional[int] = None     # local-attn window for hybrid blocks
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_bias: bool = False
    mlp_variant: str = "swiglu"    # "swiglu" (3-mat) | "gelu" (2-mat)
    moe: Optional[MoEConfig] = None
    # layer pattern for hybrids: e.g. ("rglru","rglru","attn") repeated.
    # None -> homogeneous ("attn" or "rwkv" depending on family).
    block_pattern: Optional[Sequence[str]] = None
    # rwkv6 specifics
    rwkv_head_dim: int = 64
    # rg-lru specifics
    rglru_conv_width: int = 4
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> tuple:
        if self.block_pattern is None:
            kind = "rwkv" if self.family == "ssm" else "attn"
            return tuple([kind] * self.n_layers)
        pat = list(self.block_pattern)
        out = []
        while len(out) < self.n_layers:
            out.extend(pat)
        return tuple(out[: self.n_layers])

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RunConfig:
    """Execution knobs, orthogonal to architecture.

    In the port ``use_pallas`` selects the hand-written CUDA kernels for
    prefill, flash attention, the RG-LRU scan and WKV6 (their plain PyTorch
    versions on a CPU tensor); False runs the plain versions everywhere.
    As in the JAX package, only the plain WKV path reads ``rwkv_chunk`` and
    ``rwkv_bf16_streams``.  The training, sharding and block-size knobs are
    kept for field parity and are not read by the serving path.
    """
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    use_pallas: bool = False
    remat: bool = True
    scan_layers: bool = True
    microbatches: int = 1          # gradient-accumulation steps per train step
    attn_block_q: int = 512        # blockwise-attention chunking (pure-JAX flash)
    attn_block_kv: int = 1024
    loss_chunk: int = 512          # chunked cross-entropy seq chunk
    fsdp: bool = True              # shard params/opt over "data" axis too
    zero_opt: bool = True          # shard optimizer state over "data"
    swa_block_skip: bool = True    # skip out-of-window kv blocks
    rwkv_chunk: int = 64           # WKV6 chunk length (kernel block size)
    rwkv_bf16_streams: bool = False  # store r/k/v chunk streams in bf16
    quantize_serving: bool = False # int8 weight-only quant for decode
    grad_compression: bool = False # int8 pod-axis gradient all-reduce
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
