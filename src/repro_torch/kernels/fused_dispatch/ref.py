"""Plain PyTorch version of the fused dispatch: exit decision +
conditional-buffer compaction + ring enqueue.

Semantics (the JAX package's ``fused_dispatch/ref.py`` contract):

    exit_mask, pred, conf = exit_decision(logits, c_thr)           (Eq. 4)
    hard                  = active & ~exit_mask
    src, n_hard           = compact_src(hard)                 (section III-C.2)
    ring'                 = hard rows src[i] of every payload leaf written at
                            slot (head + count + i) % size for
                            i < n_enq = min(n_hard, size - count)

Rows ``[n_enq, n_hard)`` are the caller's overflow (it spills them through
``RingQueue.enqueue``). Unlike the JAX package, which returned a new ring,
the ring's tensors are updated IN PLACE and the same dict is returned with
its ``count`` advanced.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.exit_decision.ref import exit_decision_ref


def compact_src(hard_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable stream-compaction source vector: ``src`` (B,) int32 holds the
    original row per compacted lane, -1 past ``n_hard`` (a () int32)."""
    b = hard_mask.shape[0]
    dev = hard_mask.device
    hard = hard_mask.to(torch.int32)
    n_hard = hard.sum(dtype=torch.int32)
    pos_hard = torch.cumsum(hard, 0, dtype=torch.int32) - 1
    pos_easy = torch.cumsum(1 - hard, 0, dtype=torch.int32) - 1
    slot = torch.where(hard_mask, pos_hard, n_hard + pos_easy)
    perm = torch.empty((b,), dtype=torch.int32, device=dev)
    perm[slot.long()] = torch.arange(b, dtype=torch.int32, device=dev)
    valid = torch.arange(b, device=dev) < n_hard
    return torch.where(valid, perm, -1), n_hard


def ring_offsets(src: torch.Tensor, n_hard, head, count, size: int):
    """Ring slot per compacted lane: lane i lands at ``(head + count + i) %
    size`` for ``i < n_enq``; lanes past the free space get ``size`` (out of
    range: the caller selects the in-range lanes before writing)."""
    b = src.shape[0]
    n_enq = torch.minimum(n_hard, size - count).to(torch.int32)
    lanes = torch.arange(b, dtype=torch.int32, device=src.device)
    idx = (head + count + lanes) % size
    return torch.where(lanes < n_enq, idx, size), n_enq


def scatter_merge_ref(src_map: torch.Tensor, x: torch.Tensor,
                      ring: torch.Tensor) -> torch.Tensor:
    """Plain version of the scatter-merge kernel: ring row r <- x row
    ``src_map[r]`` where that is >= 0, in place. x: (B, F); ring: (size,
    F)."""
    claimed = src_map >= 0
    ring[claimed] = x[src_map[claimed].long()]
    return ring


def fused_dispatch_ref(logits: torch.Tensor, active: Optional[torch.Tensor],
                       sample_ids: torch.Tensor, payload, ring: dict, c_thr):
    """logits (B, V); active (B,) bool or None (all rows eligible);
    sample_ids (B,) int32; payload a pytree of (B, *row) leaves matching
    ``ring['data']``. Returns ``(ring, exit_mask, pred, conf, src,
    n_hard)``; see the module doc."""
    exit_mask, pred, conf = exit_decision_ref(logits, c_thr)
    hard = ~exit_mask if active is None else active & ~exit_mask
    src, n_hard = compact_src(hard)
    size = ring["ids"].shape[0]
    idx, n_enq = ring_offsets(src, n_hard, ring["head"], ring["count"], size)
    keep = idx < size                    # PyTorch has no drop-mode scatter
    slots = idx[keep].long()
    take = src[keep].long()

    def write(d, p):
        d[slots] = p[take].to(d.dtype)

    pytree.tree_map(write, ring["data"], payload)
    ring["ids"][slots] = sample_ids[take].to(torch.int32)
    ring["count"] = ring["count"] + n_enq
    return ring, exit_mask, pred, conf, src, n_hard
