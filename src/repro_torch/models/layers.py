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
# causal GQA attention (prefill)
# ----------------------------------------------------------------------------

def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention with the semantics of the JAX
    package's ``blocked_attention``: scores accumulate in fp32 from the
    inputs' values, p is cast to v's dtype before the PV product, which
    accumulates in fp32, and the result is cast to q's dtype.

    q: (B, S, H, D); k, v: (B, S, KH, D) with H % KH == 0. Head h reads kv
    head h // (H / KH). Computed in one block over the sequence (the JAX
    package's online softmax over kv blocks is the same function; for
    S <= 512 it is one block there too)."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, S, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = s * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    # causal: every row keeps its diagonal, so its max is finite
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]    # (B, KH, G, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
