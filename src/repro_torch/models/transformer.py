"""Backbone assembly (the port of ``repro/models/transformer.py``, dense
attention blocks, prefill).

The layer stack keeps the JAX package's layout
    [first_k_dense layers] ++ [n_superblocks x pattern] ++ [remainder]
with every superblock leaf stacked along a leading axis (n_sb, ...), so the
early-exit boundary slices the stack at superblock granularity and params
bridge from the JAX tree leaf for leaf. ``lax.scan`` over superblocks is a
loop over the stacked axis.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (dense_init, embed, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm,
                                       unembed)

_NOT_PORTED = ("ROADMAP.md Queue 1, item 12 (other architectures): the port "
               "builds dense attention blocks only")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the architecture features the port does not build yet."""
    unsupported = [name for name, on in (
        ("mla", cfg.mla is not None), ("moe", cfg.moe is not None),
        ("encdec", cfg.encdec), ("frontend", cfg.frontend is not None),
        ("window", cfg.window is not None),
        ("logit_softcap", cfg.logit_softcap is not None),
        ("pattern " + str(cfg.pattern), set(cfg.pattern) != {"attn"}),
        ("mlp_act " + cfg.mlp_act, cfg.mlp_act != "swiglu"),
        ("d_ff=0", cfg.d_ff <= 0)) if on]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported; "
            f"{_NOT_PORTED}")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, lead=(), *,
                dense_mlp: bool = False) -> dict:
    """One attention + MLP block; ``lead`` stacks it (n_superblocks,)."""
    dt, dev, d = cfg.p_dtype(), gen.device, cfg.d_model
    lead = tuple(lead)
    ff = cfg.dense_ff if (dense_mlp and cfg.dense_ff) else cfg.d_ff
    return {"norm1": init_rmsnorm(lead + (d,), dt, dev),
            "attn": attn.init_attention(gen, cfg, lead),
            "norm2": init_rmsnorm(lead + (d,), dt, dev),
            "mlp": init_mlp(gen, d, ff, dt, lead)}


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Backbone param tree on ``generator.device``, in the JAX package's
    layout ({embed, first, blocks, rem, final_norm[, head]}), drawn from
    ``generator``. The numbers differ from ``jax.random``'s: to compare
    the two packages, bridge the JAX tree (``repro_torch.bridge``)."""
    check_supported(cfg)
    dt, dev = cfg.p_dtype(), generator.device
    p: Dict[str, Any] = {"embed": init_embedding(generator, cfg.vocab,
                                                 cfg.d_model, dt)}
    p["first"] = [_init_block(generator, cfg, dense_mlp=True)
                  for _ in range(cfg.first_k_dense)]
    p["blocks"] = tuple(
        _init_block(generator, cfg, (cfg.n_superblocks,))
        if cfg.n_superblocks else None for _ in cfg.pattern)
    p["rem"] = [_init_block(generator, cfg) for _ in range(cfg.n_remainder)]
    p["final_norm"] = init_rmsnorm((cfg.d_model,), dt, dev)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dt)
    return p


# ----------------------------------------------------------------------------
# apply
# ----------------------------------------------------------------------------

def _apply_block(params, cfg: ArchConfig, h: torch.Tensor):
    """Attention + MLP block, prefill. Returns (h, {"k", "v"} cache)."""
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    y, (k, v) = attn.attention_fwd(params["attn"], cfg, x)
    h = h + y
    x = rmsnorm(params["norm2"], h, cfg.norm_eps)
    h = h + mlp(params["mlp"], x)
    return h, {"k": k, "v": v}


def embed_tokens(params, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens: (B, S) int. Returns (B, S, d) in the activation dtype."""
    return embed(params["embed"], tokens).to(cfg.act_dtype())


def run_layers(params, cfg: ArchConfig, h: torch.Tensor, lo: int, hi: int,
               *, param_base_sb: int = 0):
    """Run backbone layers [lo, hi) in prefill mode. lo/hi land on
    superblock boundaries (or 0 / n_layers). ``param_base_sb`` is the
    superblock the 'blocks' leaves of a pre-sliced param tree start at.
    Returns (h, caches) with caches in the JAX package's layout: {first:
    [...], blocks: tuple per pattern position of {k, v} stacked (n_sb, B,
    S, KH, hd), rem: [...]}."""
    caches: Dict[str, Any] = {"first": [], "blocks": None, "rem": []}
    for i in range(cfg.first_k_dense):
        if lo <= i < hi:
            h, c = _apply_block(params["first"][i], cfg, h)
            caches["first"].append(c)

    pl = cfg.pattern_len
    s_lo = max(0, (lo - cfg.first_k_dense + pl - 1) // pl)
    s_hi_layer = min(hi, cfg.first_k_dense + cfg.n_superblocks * pl)
    s_hi = max(s_lo, (s_hi_layer - cfg.first_k_dense) // pl)
    if s_hi > s_lo and cfg.n_superblocks:
        per_pos = [[] for _ in range(pl)]
        for sb in range(s_lo - param_base_sb, s_hi - param_base_sb):
            for pos in range(pl):
                bp = _index_tree(params["blocks"][pos], sb)
                h, c = _apply_block(bp, cfg, h)
                per_pos[pos].append(c)
        caches["blocks"] = tuple(
            {k: torch.stack([c[k] for c in cs]) for k in ("k", "v")}
            for cs in per_pos)

    rem_base = cfg.first_k_dense + cfg.n_superblocks * pl
    for i in range(cfg.n_remainder):
        if lo <= rem_base + i < hi:
            h, c = _apply_block(params["rem"][i], cfg, h)
            caches["rem"].append(c)
    return h, caches


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def head(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + unembedding -> fp32 logits."""
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], h)
    return h.float() @ params["head"].float()
