"""Attention blocks (the port of ``repro/models/attention.py``, dense GQA
self-attention for prefill).

On one device the JAX package's ``attention_core`` takes its plain blocked
path (``blocked_attention``); the port does the same with
``layers.causal_attention``. The mesh branch and its flash kernel wait for
the mesh prefill path (ROADMAP.md, Queue 2, K4).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, causal_attention,
                                       dense_init, init_rmsnorm, rmsnorm)


def init_attention(gen: torch.Generator, cfg: ArchConfig, lead=()) -> dict:
    """``lead`` prepends stacked axes, e.g. (n_superblocks,)."""
    d, H, KH, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    dt, lead = cfg.p_dtype(), tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, H * hd), dt),
        "wk": dense_init(gen, lead + (d, KH * hd), dt),
        "wv": dense_init(gen, lead + (d, KH * hd), dt),
        "wo": dense_init(gen, lead + (H * hd, d), dt),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros(lead + (KH * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros(lead + (KH * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(lead + (hd,), dt, dev)
        p["k_norm"] = init_rmsnorm(lead + (hd,), dt, dev)
    return p


def _project_qkv(params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KH, hd)
    v = v.reshape(B, S, KH, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_fwd(params, cfg: ArchConfig, x: torch.Tensor, *,
                  positions=None):
    """Causal self-attention over the full sequence (prefill).

    x: (B, S, d_model). Returns (out, (k, v)) so prefill can keep the
    cache; k, v: (B, S, KH, hd)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = causal_attention(q, k, v)
    out = out.reshape(B, S, -1) @ params["wo"]
    return out, (k, v)
