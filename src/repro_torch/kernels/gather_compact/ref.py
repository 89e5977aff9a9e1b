"""Plain PyTorch version of the stream-compaction (conditional buffer)
kernel.

Semantics (shared with the CUDA kernel in ``csrc/gather_compact.cu``):
given x (B, F), hard_mask (B,) bool and a capacity C,
  - slab (C, F): rows of x whose mask is True, in original order, padded
    with x's row 0 for flush slots;
  - slab_ids (C,): the original row index per slab row, -1 for flush slots
    and for rows past the capacity;
  - n_hard (): the number of True rows (may exceed C).
"""
from __future__ import annotations

from typing import Tuple

import torch


def gather_compact_ref(x: torch.Tensor, hard_mask: torch.Tensor,
                       capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b = hard_mask.shape[0]
    hard = hard_mask.to(torch.int32)
    n_hard = hard.sum(dtype=torch.int32)
    pos_hard = torch.cumsum(hard, 0, dtype=torch.int32) - 1
    pos_easy = torch.cumsum(1 - hard, 0, dtype=torch.int32) - 1
    slot = torch.where(hard_mask, pos_hard, n_hard + pos_easy)
    perm = torch.empty((b,), dtype=torch.int32, device=x.device)
    perm[slot.long()] = torch.arange(b, dtype=torch.int32, device=x.device)
    if capacity > b:
        perm = torch.cat([perm, perm.new_zeros(capacity - b)])
    take = perm[:capacity]
    lanes = torch.arange(capacity, device=x.device)
    valid = lanes < torch.clamp(n_hard, max=capacity)
    take = torch.where(valid, take, 0)
    slab = x[take.long()]
    slab_ids = torch.where(valid, take, -1).to(torch.int32)
    return slab, slab_ids, n_hard
