"""Common neural primitives (the port of ``repro/models/layers.py``, dense
subset).

Param convention as in the JAX package: every module is a pair
  init_<mod>(generator, ...) -> params (dict of tensors)
  <mod>(params, x, ...)      -> y
so per-layer params stack along a leading superblock axis. The casts sit
where the JAX package puts them: norms, RoPE and the MLP nonlinearity in
fp32, cast back to the activation dtype; the unembedding in fp32.
"""
from __future__ import annotations

import math

import torch


# ----------------------------------------------------------------------------
# initializers (drawn from an explicit torch.Generator on its device)
# ----------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    1/sqrt(fan_in) (fan_in = shape[-2] for stacked (n, in, out) leaves)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t / math.sqrt(shape[-2])).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    t = torch.randn(shape, dtype=torch.float32, device=gen.device,
                    generator=gen)
    return (t * 0.02).to(dtype)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

def init_rmsnorm(shape, dtype, device) -> dict:
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------------------
# RoPE (split-halves rotation, fp32)
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions.float()[..., None] * inv              # (..., S, D/2)
    if x.dim() == ang.dim() + 1:                          # broadcast heads
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# MLP (SwiGLU)
# ----------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             lead=()) -> dict:
    """SwiGLU weights; ``lead`` prepends stacked axes, e.g.
    (n_superblocks,)."""
    lead = tuple(lead)
    return {"wi_gate": dense_init(gen, lead + (d_model, d_ff), dtype),
            "wo": dense_init(gen, lead + (d_ff, d_model), dtype),
            "wi_up": dense_init(gen, lead + (d_model, d_ff), dtype)}


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu in fp32, cast back, times the up projection."""
    g = x @ params["wi_gate"]
    u = x @ params["wi_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ params["wo"]


# ----------------------------------------------------------------------------
# embedding / unembedding
# ----------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype) -> dict:
    return {"table": embed_init(gen, (vocab, d_model), dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params, h: torch.Tensor) -> torch.Tensor:
    """Tied unembedding in fp32: h @ table.T -> fp32 logits (full fp32 on
    the card while ``torch.backends.cuda.matmul.allow_tf32`` is False,
    PyTorch's default, which the serving CLI pins). The table is
    cast on every call, not cached: at qwen2-1.5b width the fp32 copy is a
    933 MB temporary, which the card holds easily, and a cached copy would
    be a second resident table to keep in step with the first."""
    return h.float() @ params["table"].float().T


# ----------------------------------------------------------------------------
# memory-bounded attention (prefill)
# ----------------------------------------------------------------------------

def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window=None, q_block: int = 256,
                      kv_block: int = 512, softcap=None,
                      q_offset: int = 0) -> torch.Tensor:
    """Memory-bounded grouped-query attention, the JAX package's
    ``blocked_attention``: kv-head groups, then query blocks, then kv
    blocks with an online softmax, so every intermediate is one tile.

    q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0; head h reads
    kv head h // (H / KH). ``q_offset`` is the absolute position of q row 0
    (a sequence-parallel shard). The query tile widens from ``q_block`` up
    to 1024 rows while the (B, G, qb, kb) fp32 score tile stays within
    4 MB, as in the reference. Scores accumulate in fp32 from the inputs'
    values, p is cast to v's dtype before the PV product, which
    accumulates in fp32, and the result is cast to q's dtype. A kv block
    that no query of the tile may see (causal or window) is skipped: it
    would leave (m, l, acc) exactly as they are. A fully masked row is 0.
    """
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    kb = min(kv_block, Sk)
    budget = 4 * 1024 * 1024
    qb_fit = max(budget // (B * G * kb * 4), 1)
    qb_fit = 1 << (qb_fit.bit_length() - 1)             # floor pow2
    qb = min(max(q_block, qb_fit), 1024, Sq)
    dev = q.device
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    for kh in range(KH):
        k_h, v_h = k[:, :, kh], v[:, :, kh]              # (B, Sk, D)
        for q0 in range(0, Sq, qb):
            q1 = min(q0 + qb, Sq)
            qblk = q[:, q0:q1, kh * G:(kh + 1) * G].float()   # (B, n, G, D)
            qp = q_offset + torch.arange(q0, q1, device=dev)
            lo, hi = q_offset + q0, q_offset + q1 - 1     # absolute rows
            m = torch.full((B, G, q1 - q0), float("-inf"), device=dev)
            l = torch.zeros((B, G, q1 - q0), device=dev)
            acc = torch.zeros((B, G, q1 - q0, D), device=dev)
            for k0 in range(0, Sk, kb):
                k1 = min(k0 + kb, Sk)
                if causal and k0 > hi:
                    break
                if window is not None and lo - (k1 - 1) >= window:
                    continue
                s = torch.einsum("bqgd,bkd->bgqk", qblk,
                                 k_h[:, k0:k1].float()) * scale
                if softcap is not None:
                    s = softcap * torch.tanh(s / softcap)
                kp = torch.arange(k0, k1, device=dev)
                mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                                  device=dev)
                if causal:
                    mask &= qp[:, None] >= kp[None, :]
                if window is not None:
                    mask &= qp[:, None] - kp[None, :] < window
                s = s.masked_fill(~mask, float("-inf"))
                m_new = torch.maximum(m, s.amax(dim=-1))
                m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
                p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
                corr = torch.where(torch.isneginf(m), 0.0,
                                   torch.exp(m - m_safe))
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bgqk,bkd->bgqd", p.to(v.dtype).float(),
                    v_h[:, k0:k1].float())
                m = m_new
            o = acc / torch.clamp(l, min=1e-30)[..., None]    # (B, G, n, D)
            out[:, q0:q1, kh * G:(kh + 1) * G] = o.permute(0, 2, 1, 3).to(
                q.dtype)
    return out


# ----------------------------------------------------------------------------
# single-step decode attention
# ----------------------------------------------------------------------------

def masked_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """The ONE masked single-step attention core every decode path shares.

    q: (B, H, D); caches: (B, Smax, KH, D); valid: (B, Smax) bool, the cache
    positions that take part. Callers build ``valid`` from their own
    bookkeeping (prefix length, paged block tables); the arithmetic is the
    same, so dense and paged decode agree bit for bit given the same cache
    bytes. Scores, softmax and the PV product in fp32, cast to q's dtype."""
    B, Smax, KH, D = k_cache.shape
    H = q.shape[1]
    G = H // KH
    qf = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    s = s * (1.0 / math.sqrt(D))
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-step attention against a cache. q: (B, H, D); caches: (B,
    Smax, KH, D); cache_len: (B,) valid lengths (the new token's k/v
    already written at cache_len - 1)."""
    pos = torch.arange(k_cache.shape[1], device=k_cache.device)[None, :]
    return masked_decode_attention(q, k_cache, v_cache,
                                   pos < cache_len[:, None])
