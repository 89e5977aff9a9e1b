"""Conditional buffer and exit merge, ATHEENA section III-C.2-4 (the port
of ``repro/core/conditional.py``, the functions on the prefill path).

The conditional buffer is a static-shaped compaction: a stable prefix-sum
partition that moves hard samples (exit_mask False) to the front, plus the
sample-ID tags that let out-of-order completions merge. The serving path
runs the compaction through ``kernels.dispatch``; these functions are the
framework-level reference.
"""
from __future__ import annotations

from typing import Tuple

import torch


def compact_indices(hard_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable partition: indices of hard samples first, then easy.
    hard_mask: (B,) bool. Returns (perm (B,) int32, n_hard () int32) where
    perm[:n_hard] are the hard indices in original order."""
    b = hard_mask.shape[0]
    hard = hard_mask.to(torch.int32)
    pos_hard = torch.cumsum(hard, 0, dtype=torch.int32) - 1
    pos_easy = torch.cumsum(1 - hard, 0, dtype=torch.int32) - 1
    n_hard = hard.sum(dtype=torch.int32)
    slot = torch.where(hard_mask, pos_hard, n_hard + pos_easy)
    perm = torch.empty((b,), dtype=torch.int32, device=hard_mask.device)
    perm[slot.long()] = torch.arange(b, dtype=torch.int32,
                                     device=hard_mask.device)
    return perm, n_hard


def exit_merge(batch: int, easy_ids: torch.Tensor, easy_vals: torch.Tensor,
               hard_ids: torch.Tensor, hard_vals: torch.Tensor,
               fill_value=0) -> torch.Tensor:
    """Merge the two exit streams by sample ID.

    easy_ids: (B,) int32, -1 for non-exited slots; easy_vals: (B, ...).
    hard_ids: (C,) int32, -1 for flush slots;       hard_vals: (C, ...).
    Returns (batch, ...) ordered by sample id. Negative ids write to a
    scratch row past the end, which is dropped (no host sync)."""
    out = torch.full((batch + 1,) + tuple(easy_vals.shape[1:]), fill_value,
                     dtype=easy_vals.dtype, device=easy_vals.device)
    for ids, vals in ((easy_ids, easy_vals), (hard_ids, hard_vals)):
        safe = torch.where(ids >= 0, ids, batch).long()
        out[safe] = vals.to(out.dtype)
    return out[:batch]
