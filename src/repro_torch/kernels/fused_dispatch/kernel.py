"""Wrapper of the CUDA ring scatter-merge kernel (``csrc/scatter_merge.cu``)
and the fused dispatch built on it.

Replaces the TPU kernels ``repro/kernels/fused_dispatch/kernel.py:
_scatter_merge`` (body ``_scatter_merge_kernel``) and its composition
``fused_dispatch_pallas``. Bound on the card: the bytes of the claimed
rows, 2 * n_enq rows per payload leaf; unclaimed ring slots are not
touched. The slot map is a few integer prefix sums over (B,) and (size,)
vectors in plain PyTorch on the device (the JAX package left the same
math to XLA outside its kernel), so nothing syncs with the host.
"""
from __future__ import annotations

import math

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _build
from repro_torch.kernels.exit_decision.kernel import exit_decision_cuda
from repro_torch.kernels.fused_dispatch.ref import compact_src


def slot_src_map(src: torch.Tensor, n_hard, head, count, size: int):
    """Ring slot -> payload row map: slot r takes row ``src[(r - head -
    count) % size]`` when that lane is below ``n_enq = min(n_hard, size -
    count)``, else -1. Each slot is claimed at most once (n_enq <= size).
    Returns (src_map (size,) int32, n_enq () int32)."""
    b = src.shape[0]
    n_enq = torch.minimum(n_hard, size - count).to(torch.int32)
    slots = torch.arange(size, dtype=torch.int32, device=src.device)
    lane = (slots - head - count) % size
    rows = src[torch.clamp(lane, max=b - 1).long()]
    return torch.where(lane < n_enq, rows, -1).to(torch.int32), n_enq


def scatter_merge_cuda(src_map: torch.Tensor, x: torch.Tensor,
                       ring: torch.Tensor) -> torch.Tensor:
    """Ring row r <- x row ``src_map[r]`` where that is >= 0, IN PLACE (the
    JAX kernel returned a new, aliased ring). src_map: (size,) int32 with
    values in [-1, B) (``slot_src_map`` builds it so; checking would cost a
    host sync); x: (B, F) and ring: (size, F), contiguous, one dtype, one
    CUDA device. Launches the kernel; returns ``ring``."""
    for t, what in ((src_map, "src_map"), (x, "x"), (ring, "ring")):
        _build.require_cuda(t, f"scatter_merge {what}")
        if t.device != ring.device or not t.is_contiguous():
            raise ValueError(f"scatter_merge {what} must be contiguous on "
                             f"{ring.device}")
    size = ring.shape[0]
    if (x.dim() != 2 or ring.dim() != 2 or x.shape[1] != ring.shape[1]
            or x.dtype != ring.dtype):
        raise ValueError(f"scatter_merge takes x (B, F) and ring (size, F) "
                         f"of one dtype, got {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(ring.shape)} {ring.dtype}")
    if src_map.shape != (size,) or src_map.dtype != torch.int32:
        raise ValueError(f"scatter_merge src_map must be ({size},) int32, "
                         f"got {tuple(src_map.shape)} {src_map.dtype}")
    if size > 65535:
        raise ValueError(f"scatter_merge ring of {size} slots > 65535")
    lib = _build.library()
    with torch.cuda.device(ring.device):
        err = lib.repro_scatter_merge(
            src_map.data_ptr(), size, x.data_ptr(), ring.data_ptr(),
            ring.shape[1] * ring.element_size(), _build.stream())
    _build.check(err, "scatter_merge")
    scatter_merge_cuda.launches += 1
    return ring


scatter_merge_cuda.launches = 0


def fused_dispatch_cuda(logits, active, sample_ids, payload, ring: dict,
                        c_thr):
    """Same contract as ``fused_dispatch_ref`` (ring updated in place):
    the exit-decision kernel, the slot map, then one scatter-merge launch
    per payload leaf and one for the ids lane."""
    exit_mask, pred, conf = exit_decision_cuda(logits, c_thr)
    hard = ~exit_mask if active is None else active & ~exit_mask
    src, n_hard = compact_src(hard)
    b = src.shape[0]
    size = ring["ids"].shape[0]
    src_map, n_enq = slot_src_map(src, n_hard, ring["head"], ring["count"],
                                  size)

    def merge(d, p):
        if math.prod(d.shape[1:]) == 0:      # degenerate leaf: nothing moves
            return
        scatter_merge_cuda(src_map, p.reshape(b, -1).to(d.dtype),
                           d.view(size, -1))

    pytree.tree_map(merge, ring["data"], payload)
    merge(ring["ids"][:, None], sample_ids[:, None])
    ring["count"] = ring["count"] + n_enq
    return ring, exit_mask, pred, conf, src, n_hard
