"""Attention blocks (the port of ``repro/models/attention.py``): dense GQA
self-attention for prefill, and one-token decode against a dense or a
paged KV cache.

On one device ``attention_core`` takes the plain blocked path
(``layers.blocked_attention``), as in the JAX package. Under a mesh with a
'model' axis (``models/hints.py``) it splits the work over the ranks, by
batch or by query rows, runs each shard through the flash-attention
kernel on the card (``kernels.dispatch.flash_attention``) and gathers the
shards back, so the rest of the layer runs whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import hints
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, blocked_attention,
                                       dense_init, init_rmsnorm,
                                       masked_decode_attention, rmsnorm)

_WINDOW_NOT_PORTED = ("windowed ('lattn') layers and their ring cache are "
                      "not ported: ROADMAP.md Queue 1, item 4")


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: Optional[int],
                   softcap: Optional[float], use_kernel: bool = False):
    """q: (B, S, H, D); k, v: (B, S, KH, D). Returns (B, S, H, D).

    With a mesh that ``hints.attn_split`` accepts, this rank computes its
    shard: "batch" takes B / (batch ranks x model ranks) whole sequences,
    "seq" the query rows [i S/m, (i+1) S/m) of its batch chunk against the
    whole K/V at q offset i S/m; the shards are all-gathered over the ranks
    that split them. ``use_kernel`` runs a shard through
    ``dispatch.flash_attention`` (the CUDA kernel on a CUDA tensor), else
    through ``blocked_attention`` at the shard's offset, the same function.
    softcap and non-causal attention stay on ``blocked_attention``. With no
    such mesh: ``blocked_attention`` on the whole input."""
    split = hints.attn_split(q.shape[1], q.shape[0])
    if split is None or q.shape[1] != k.shape[1]:
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    kind, baxes = split
    mesh = hints.mesh()
    kernel_ok = use_kernel and softcap is None and causal

    def kern(q_l, k_l, v_l, off):
        if kernel_ok:
            o = dispatch.flash_attention(
                q_l.transpose(1, 2), k_l.transpose(1, 2),
                v_l.transpose(1, 2), off, causal=True, window=window)
            return o.transpose(1, 2)
        return blocked_attention(q_l, k_l, v_l, causal=causal, window=window,
                                 softcap=softcap, q_offset=off)

    if kind == "batch":
        axes = (*baxes, "model")
        n = q.shape[0] // mesh.size(axes)
        lo = mesh.index(axes) * n
        o = kern(q[lo:lo + n], k[lo:lo + n], v[lo:lo + n], 0)
        return mesh.gather(o, batch_axes=axes)
    n = q.shape[0] // mesh.size(baxes)
    lo = mesh.index(baxes) * n
    s = q.shape[1] // mesh.shape["model"]
    off = mesh.coords["model"] * s
    o = kern(q[lo:lo + n, off:off + s], k[lo:lo + n], v[lo:lo + n], off)
    return mesh.gather(o, batch_axes=baxes, seq_axes=("model",))


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
                  positions=None, use_kernel: bool = False):
    """Causal self-attention over the full sequence (prefill).

    x: (B, S, d_model). ``use_kernel``: split attention runs its shards
    through the flash-attention kernel (``attention_core``). Returns (out,
    (k, v)) so prefill can keep the cache; k, v: (B, S, KH, hd)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = attention_core(q, k, v, causal=True, window=None,
                         softcap=cfg.logit_softcap, use_kernel=use_kernel)
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
