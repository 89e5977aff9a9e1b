"""Wrapper of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py:
flash_attention_pallas``. Bound on the card: operations, the QK^T and PV
products over the pairs that the causal and window masks keep (4 D flops
a pair); see the source for the design. The dtype picks the kernel, and
nothing else does: bf16 runs ``flash_fwd_mma`` (tensor cores through
``mma.sync``, K/V through a ``cp.async`` ring, PV on p split into two bf16
halves), fp32 runs ``flash_fwd`` (fp32 FMAs). The kernels read q, k and v
through their strides, so the (B, S, H, D) activations of the model go in
as (B, H, S, D) views without a copy, and they write an output laid out
(B, Sq, H, D), returned as the (B, H, Sq, D) view the reference returns.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = {torch.float32: "flash_fwd", torch.bfloat16: "flash_fwd_mma"}
HEAD_DIMS = (16, 32, 64, 128)


def _chunk_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its base and the strides of its (batch, head,
    position) dims of more than one element are multiples of 16 bytes, as
    the bf16 kernel's 16-byte ``cp.async`` copies need; else a contiguous
    copy. The model's activations and their mesh shards pass as they
    are."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            st % step == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
            if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_offset: int = 0, *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KH, Sk, D); float32 or bfloat16, one
    dtype, unit stride along D, on one CUDA device; D in {16, 32, 64, 128}.
    Returns (B, H, Sq, D) in q.dtype. Launches the kernel of q's dtype;
    raises on anything it does not take."""
    _build.require_cuda(q, "flash_attention")
    dev = q.device
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v "
                         f"(B, KH, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KH == 0 or H % KH:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H % KH must be 0)")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, "
                         f"v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got "
                         f"{D}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: q on {dev}, k on {k.device}, v "
                         f"on {v.device}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs unit stride along D")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention window must be >= 1, got "
                         f"{window}")
    q_offset = int(q_offset)
    if B * KH > 65535 or q_offset < 0 or q_offset + Sq + Sk >= 2 ** 31:
        raise ValueError(f"flash_attention: B * KH = {B * KH} > 65535 or "
                         f"positions past int32 (q_offset {q_offset})")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    o = out.transpose(1, 2)                              # (B, H, Sq, D)
    if B * Sq == 0:
        return o
    if q.dtype == torch.bfloat16:
        q, k, v = (_chunk_aligned(t) for t in (q, k, v))
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPE_CODES[q.dtype], D, B, H, KH, Sq, Sk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], q_offset, int(causal),
            0 if window is None else int(window), D ** -0.5,
            _build.stream())
    _build.check(err, "flash_attention")
    flash_attention_cuda.launches[KERNELS[q.dtype]] += 1
    return o


def kernel_attrs(D: int) -> dict:
    """The bf16 kernel's resources at head dim ``D`` on the current card,
    from ``cudaFuncGetAttributes`` and the occupancy calculator."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.library().repro_flash_attention_attrs(D, out),
                 "flash_attention attrs")
    return dict(zip(("regs", "dyn_smem", "static_smem", "spill_bytes",
                     "blocks_per_sm", "threads"), out))


# launches of each kernel, by its symbol
flash_attention_cuda.launches = dict.fromkeys(KERNELS.values(), 0)
