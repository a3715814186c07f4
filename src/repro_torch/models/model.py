"""Top-level LM facade: embedding, stack, logits, prefill/decode.

``LM`` is a namespace of functions over (params, cfg, run), as in the JAX
package.  Params are ``{"embed", "final_norm", "layers": [per-layer dict]}``,
plus ``"unembed"`` (M, V) when the config does not tie the embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import transformer
from repro_torch.models.modules import rms_norm
from repro_torch.utils.tree import ParamBuilder, fan_in_init, zeros_init


class LM:
    # ----------------------------------------------------------------- init

    @staticmethod
    def init(cfg, run, seed: int = 0, device: DeviceLike = None) -> dict:
        """Random params from ``seed``, drawn on ``device`` (default cuda)."""
        transformer.check_supported(cfg, run)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        pb = ParamBuilder(gen, torch_dtype(run.param_dtype))
        pb.param("embed", (cfg.vocab_size, cfg.d_model), init=fan_in_init(cfg.d_model))
        pb.param("final_norm", (cfg.d_model,), init=zeros_init)
        if not cfg.tie_embeddings:
            pb.param("unembed", (cfg.d_model, cfg.vocab_size),
                     init=fan_in_init(cfg.d_model))
        params = pb.params
        params["layers"] = transformer.init_stack(cfg, gen, pb.dtype)
        return params

    # -------------------------------------------------------------- forward

    @staticmethod
    def hidden(params, cfg, run, tokens, mode="train", cache=None, pos=None):
        """tokens: (B, S) int -> final-normed hidden (B, S, M)."""
        transformer.check_supported(cfg, run)
        adt = torch_dtype(run.activation_dtype)
        x = params["embed"][tokens].to(adt)
        positions = None
        if mode != "decode":
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        x = transformer.apply_stack(params["layers"], cfg, run, x, positions,
                                    mode=mode, cache=cache, pos=pos)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    @staticmethod
    def _unembed(params, cfg, h):
        """Logits, products of h.dtype values summed in f32: (B, S, M) ->
        (B, S, V), through the embedding (tied) or the ``unembed`` leaf."""
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return h.float() @ w.to(h.dtype).float()

    @staticmethod
    def logits(params, cfg, run, tokens):
        """Full logits (small-model paths only: tests)."""
        return LM._unembed(params, cfg, LM.hidden(params, cfg, run, tokens))

    @staticmethod
    def loss(params, cfg, run, tokens, labels, label_mask=None):
        raise NotImplementedError("training (LM.loss) is not ported to repro_torch yet")

    # ------------------------------------------------------------- serving

    @staticmethod
    def prefill(params, cfg, run, tokens, max_seq):
        """Process the prompt; returns (last_logits (B, 1, V), cache)."""
        adt = torch_dtype(run.activation_dtype)
        cache = transformer.init_cache(cfg, tokens.shape[0], max_seq, adt,
                                       tokens.device)
        h = LM.hidden(params, cfg, run, tokens, mode="prefill", cache=cache)
        return LM._unembed(params, cfg, h[:, -1:]), cache

    @staticmethod
    def decode_step(params, cfg, run, tokens, cache, pos: int):
        """tokens: (B, 1); ``pos`` tokens already cached.  Updates ``cache``
        in place; returns (logits (B, 1, V), cache)."""
        h = LM.hidden(params, cfg, run, tokens, mode="decode", cache=cache, pos=pos)
        return LM._unembed(params, cfg, h), cache
