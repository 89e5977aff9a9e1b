"""Backbone assembly (the port of ``repro/models/transformer.py``, dense
attention blocks): prefill over a whole sequence, and one-token decode
against per-layer caches.

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

def _apply_block(params, cfg: ArchConfig, h: torch.Tensor, *,
                 mode: str = "prefill", cache=None, step=None):
    """Attention + MLP block. Prefill returns (h, {"k", "v"} cache); decode
    (h: (B, 1, d)) writes the new token into ``cache`` at ``step`` and
    returns (h, the updated cache)."""
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    if mode == "decode":
        y, kv = attn.attention_decode(params["attn"], cfg, x, cache, step)
        new_cache = dict(cache)
        new_cache.update(kv)
    else:
        # the flash kernel on the card (reached under a mesh only); the
        # plain blocked path on the CPU, as the JAX package on its host
        y, (k, v) = attn.attention_fwd(params["attn"], cfg, x,
                                       use_kernel=x.is_cuda)
        new_cache = {"k": k, "v": v}
    h = h + y
    x = rmsnorm(params["norm2"], h, cfg.norm_eps)
    h = h + mlp(params["mlp"], x)
    return h, new_cache


def embed_tokens(params, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens: (B, S) int. Returns (B, S, d) in the activation dtype."""
    return embed(params["embed"], tokens).to(cfg.act_dtype())


def run_layers(params, cfg: ArchConfig, h: torch.Tensor, lo: int, hi: int,
               *, mode: str = "prefill", caches=None, step=None,
               cache_base_sb: int = 0, param_base_sb: int = 0):
    """Run backbone layers [lo, hi). lo/hi land on superblock boundaries
    (or 0 / n_layers). ``mode`` is "prefill" (a whole sequence) or
    "decode" (one token against ``caches`` at ``step``). ``param_base_sb``
    / ``cache_base_sb`` are the superblocks the 'blocks' leaves of a
    pre-sliced param tree / segment cache (``ee.split_caches``) start at.
    Returns (h, caches) with caches in the JAX package's layout: {first:
    [...], blocks: tuple per pattern position of dicts whose leaves stack
    along a leading superblock axis (n_sb, ...), rem: [...]}."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if mode == "decode" and caches is None:
        raise ValueError("decode mode needs caches")
    out: Dict[str, Any] = {"first": [], "blocks": None, "rem": []}
    for i in range(cfg.first_k_dense):
        if lo <= i < hi:
            c = caches["first"][i] if mode == "decode" else None
            h, nc = _apply_block(params["first"][i], cfg, h, mode=mode,
                                 cache=c, step=step)
            out["first"].append(nc)

    pl = cfg.pattern_len
    s_lo = max(0, (lo - cfg.first_k_dense + pl - 1) // pl)
    s_hi_layer = min(hi, cfg.first_k_dense + cfg.n_superblocks * pl)
    s_hi = max(s_lo, (s_hi_layer - cfg.first_k_dense) // pl)
    if s_hi > s_lo and cfg.n_superblocks:
        per_pos = [[] for _ in range(pl)]
        for sb in range(s_lo, s_hi):
            for pos in range(pl):
                bp = _index_tree(params["blocks"][pos], sb - param_base_sb)
                c = (_index_tree(caches["blocks"][pos], sb - cache_base_sb)
                     if mode == "decode" else None)
                h, nc = _apply_block(bp, cfg, h, mode=mode, cache=c,
                                     step=step)
                per_pos[pos].append(nc)
        # paged pools were appended to in place through the per-superblock
        # views: hand back views of the incoming leaves, not a stacked copy
        # of every pool
        out["blocks"] = tuple(
            {k: x[s_lo - cache_base_sb:s_hi - cache_base_sb]
             for k, x in caches["blocks"][pos].items()}
            if mode == "decode" and "bt" in caches["blocks"][pos] else
            {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
            for pos, cs in enumerate(per_pos))

    rem_base = cfg.first_k_dense + cfg.n_superblocks * pl
    for i in range(cfg.n_remainder):
        if lo <= rem_base + i < hi:
            c = caches["rem"][i] if mode == "decode" else None
            h, nc = _apply_block(params["rem"][i], cfg, h, mode=mode,
                                 cache=c, step=step)
            out["rem"].append(nc)
    return h, out


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


# ----------------------------------------------------------------------------
# caches and whole-model decode (single exit; EE staging lives in
# core/early_exit.py and reuses run_layers with slicing)
# ----------------------------------------------------------------------------

def _init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      device) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"{kind!r} block caches are not ported; "
                                  f"{_NOT_PORTED}")
    return attn.init_kv_cache(cfg, batch, max_len, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """Zero decode caches in the param layout ('blocks' leaves stacked
    (n_sb, batch, max_len, KH, hd))."""
    check_supported(cfg)

    def stack_cache(pos: int):
        if cfg.n_superblocks == 0:
            return None
        one = _init_block_cache(cfg, cfg.pattern[pos], batch, max_len,
                                device)
        return {k: x[None].repeat((cfg.n_superblocks,) + (1,) * x.dim())
                for k, x in one.items()}

    return {"first": [_init_block_cache(cfg, cfg.layer_kind(i), batch,
                                        max_len, device)
                      for i in range(cfg.first_k_dense)],
            "blocks": tuple(stack_cache(p) for p in range(cfg.pattern_len)),
            "rem": [_init_block_cache(cfg, cfg.pattern[i], batch, max_len,
                                      device)
                    for i in range(cfg.n_remainder)]}


def pad_caches(cfg: ArchConfig, caches, max_len: int):
    """Grow prefill caches along their time axis to ``max_len`` with zeros,
    so decode steps have slots to write into."""
    def pad_block(c):
        if c is None:
            return None
        c = dict(c)
        for key in ("k", "v"):
            x = c[key]
            cur = x.shape[-3]
            if cur < max_len:
                c[key] = torch.nn.functional.pad(
                    x, (0, 0, 0, 0, 0, max_len - cur))
        return c

    return {"first": [pad_block(c) for c in caches["first"]],
            "blocks": (None if caches["blocks"] is None else
                       tuple(pad_block(c) for c in caches["blocks"])),
            "rem": [pad_block(c) for c in caches["rem"]]}


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, *,
            max_len: int = 0):
    """Returns (last logits (B, V), caches). ``max_len`` > the sequence
    pads the caches so that later decode steps have write slots."""
    h = embed_tokens(params, cfg, tokens)
    h, caches = run_layers(params, cfg, h, 0, cfg.n_layers)
    if max_len > tokens.shape[1]:
        caches = pad_caches(cfg, caches, max_len)
    return head(params, cfg, h[:, -1]), caches


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches, step):
    """token: (B, 1) int; step: the absolute position (int) or (B,)
    per-row positions. Returns (logits (B, V), new caches)."""
    h = embed_tokens(params, cfg, token)
    h, caches = run_layers(params, cfg, h, 0, cfg.n_layers, mode="decode",
                           caches=caches, step=step)
    return head(params, cfg, h[:, 0]), caches
