"""Plain PyTorch version of the paged KV-cache gather + append kernel.

Semantics (the JAX package's ``paged_attention/ref.py``, shared with the
CUDA kernel in ``csrc/paged_gather_append.cu``): the cache lives in pages of
a shared pool ``(P, page, *F)``; row b of the batch owns the int32 block
table row ``bt[b]`` (M pool page ids, 0 = the NULL page, always zero). One
call, in this order:

  1. APPEND: row b's new features go to page ``bt[b, pos[b] // page]`` at
     row ``pos[b] % page`` of both pools. Rows with ``pos >= M * page`` (the
     parked/flush sentinel), or whose tail entry is the NULL page or lies
     outside the pool, write nothing.
  2. GATHER: every row's M pages, read from the appended pools, into
     ``(B, M, page, *F)``; reshaped to ``(B, M * page, *F)`` that is the
     dense cache row.

Unlike the JAX function, which returned new pools, the pools are updated
IN PLACE (as the CUDA kernel does) and returned. Table entries outside
``[0, P)`` gather the nearest page (JAX clamps its gather indices too).
"""
from __future__ import annotations

from typing import Tuple

import torch


def paged_gather_append_ref(a_pool: torch.Tensor, b_pool: torch.Tensor,
                            a_new: torch.Tensor, b_new: torch.Tensor,
                            block_tables: torch.Tensor, pos: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """a_pool: (P, page, *Fa); b_pool: (P, page, *Fb); a_new: (B, *Fa);
    b_new: (B, *Fb); block_tables: (B, M) int32; pos: (B,) int32. Returns
    (gathered_a (B, M, page, *Fa), gathered_b, a_pool, b_pool)."""
    n_pages, page = a_pool.shape[:2]
    B, M = block_tables.shape
    pg = torch.clamp(torch.div(pos, page, rounding_mode="floor"), 0, M - 1)
    tail = torch.gather(block_tables, 1, pg[:, None].long())[:, 0]
    # PyTorch has no drop-mode scatter: select the appending rows instead
    rows = ((pos < M * page) & (tail > 0) & (tail < n_pages)).nonzero()[:, 0]
    dst_page, dst_row = tail[rows].long(), (pos[rows] % page).long()
    a_pool[dst_page, dst_row] = a_new[rows].to(a_pool.dtype)
    b_pool[dst_page, dst_row] = b_new[rows].to(b_pool.dtype)
    take = torch.clamp(block_tables, 0, n_pages - 1).long()
    return a_pool[take], b_pool[take], a_pool, b_pool
