"""Attention blocks (the port of ``repro/models/attention.py``): dense GQA
self-attention for prefill, and one-token decode against a dense or a
paged KV cache.

On one device the JAX package's ``attention_core`` takes its plain blocked
path (``blocked_attention``); the port does the same with
``layers.causal_attention``. The mesh branch and its flash kernel wait for
the mesh prefill path (ROADMAP.md, Queue 2, K4).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, causal_attention,
                                       dense_init, init_rmsnorm,
                                       masked_decode_attention, rmsnorm)

_WINDOW_NOT_PORTED = ("windowed ('lattn') layers and their ring cache are "
                      "not ported: ROADMAP.md Queue 1, item 4")


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


# ----------------------------------------------------------------------------
# KV cache (decode)
# ----------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                  window=None) -> dict:
    """Zero {k, v} caches (batch, max_len, KH, hd) for ONE attention layer,
    in the activation dtype."""
    if window:
        raise NotImplementedError(_WINDOW_NOT_PORTED)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.act_dtype(), device=device),
            "v": torch.zeros(shape, dtype=cfg.act_dtype(), device=device)}


def init_paged_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                        page_size: int, n_pages: int, device) -> dict:
    """Paged cache for ONE attention layer: shared pools (n_pages, page, KH,
    hd) (page 0 = NULL, kept all zero) plus a per-row block table ``bt``
    (batch, max_len // page) of pool page ids (0 = unused). The ``bt`` key
    marks the cache as paged."""
    if max_len % page_size != 0:
        raise ValueError(f"max_len={max_len} must be a multiple of "
                         f"page_size={page_size} (bitwise paged/dense "
                         f"parity needs the gathered span == max_len)")
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.act_dtype(), device=device),
            "v": torch.zeros(shape, dtype=cfg.act_dtype(), device=device),
            "bt": torch.zeros((batch, max_len // page_size),
                              dtype=torch.int32, device=device)}


def attention_decode(params, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     step, *, window=None):
    """One-token decode. x: (B, 1, d). cache: this layer's {k, v}, or the
    paged {k pool, v pool, bt block table} (told apart by ``bt``). step: an
    int, the absolute position the batch shares, or a (B,) int32 tensor of
    per-row positions. Every path ends in the one masked core
    (``layers.masked_decode_attention``), so dense and paged agree bit for
    bit given the same cache bytes.

    Returns (out (B, 1, d), new cache). The dense caches come back as new
    tensors; the paged pools are updated IN PLACE by the append (the JAX
    package returned new ones) and returned."""
    if window:
        raise NotImplementedError(_WINDOW_NOT_PORTED)
    B = x.shape[0]
    dev = x.device
    per_row = torch.is_tensor(step) and step.dim() == 1
    pos_vec = (step.to(torch.int32) if per_row else
               torch.full((B,), int(step), dtype=torch.int32, device=dev))
    q, k, v = _project_qkv(params, cfg, x, pos_vec[:, None])
    q = q[:, 0]                                        # (B, H, hd)
    if "bt" in cache:
        bt = cache["bt"]
        M, page = bt.shape[1], cache["k"].shape[1]
        gk, gv, k_pool, v_pool = dispatch.paged_gather_append(
            cache["k"], cache["v"], k[:, 0], v[:, 0], bt, pos_vec)
        L = M * page
        k_cache = gk.reshape((B, L) + tuple(gk.shape[3:]))
        v_cache = gv.reshape((B, L) + tuple(gv.shape[3:]))
        # sentinel rows (pos >= L: parked / flush slots) keep an all-true
        # mask over all-zero gathered pages: finite garbage on a discarded
        # row, never a NaN softmax
        span = torch.arange(L, device=dev)[None, :]
        valid = (span <= pos_vec[:, None]) | (pos_vec[:, None] >= L)
        out = masked_decode_attention(q, k_cache, v_cache, valid)
        out = out.reshape(B, -1) @ params["wo"]
        return out[:, None, :], {"k": k_pool, "v": v_pool, "bt": bt}
    L = cache["k"].shape[1]
    k_cache = cache["k"].clone(memory_format=torch.contiguous_format)
    v_cache = cache["v"].clone(memory_format=torch.contiguous_format)
    if per_row:
        # a row whose slot is out of range writes nothing (the JAX scatter
        # drops it); selecting with where keeps the write free of host syncs
        rows = torch.arange(B, device=dev)
        slot = torch.clamp(pos_vec, 0, L - 1).long()
        keep = ((pos_vec >= 0) & (pos_vec < L))[:, None, None]
        k_cache[rows, slot] = torch.where(keep, k[:, 0], k_cache[rows, slot])
        v_cache[rows, slot] = torch.where(keep, v[:, 0], v_cache[rows, slot])
    else:
        # a shared slot past the end is clamped, as dynamic_update_slice does
        slot = min(max(int(step), 0), L - 1)
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
    valid = torch.arange(L, device=dev)[None, :] < pos_vec[:, None] + 1
    out = masked_decode_attention(q, k_cache, v_cache, valid)
    out = out.reshape(B, -1) @ params["wo"]
    return out[:, None, :], {"k": k_cache, "v": v_cache}
