"""Wrapper of the CUDA paged-cache append + gather kernel
(``csrc/paged_gather_append.cu``).

Replaces the TPU kernel ``repro/kernels/paged_attention/kernel.py:
paged_gather_append_pallas``. Bound on the card: the bytes of the gathered
pages, read from the pools and written out once each (B * M pages of both
pools), plus the 2 * B appended rows. The append runs over B rows before
the gather runs over the (B, M) cells, on one stream, so a page that
several rows read shows every row's append. The pools are updated in place.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build


def _check_pool(pool: torch.Tensor, new: torch.Tensor, B: int, dev,
                what: str) -> None:
    _build.require_cuda(pool, f"paged_gather_append {what} pool")
    if pool.dim() != 3 or not pool.is_contiguous() or pool.device != dev:
        raise ValueError(f"paged_gather_append takes a contiguous (P, page, "
                         f"F) {what} pool on {dev}, got {tuple(pool.shape)} "
                         f"on {pool.device}")
    if (new.shape != (B, pool.shape[2]) or new.dtype != pool.dtype
            or not new.is_contiguous() or new.device != dev):
        raise ValueError(f"paged_gather_append takes contiguous ({B}, "
                         f"{pool.shape[2]}) {pool.dtype} new {what} rows on "
                         f"{dev}, got {tuple(new.shape)} {new.dtype} on "
                         f"{new.device}")


def paged_gather_append_cuda(a_pool: torch.Tensor, b_pool: torch.Tensor,
                             a_new: torch.Tensor, b_new: torch.Tensor,
                             block_tables: torch.Tensor, pos: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """a_pool: (P, page, Fa) and b_pool: (P, page, Fb), contiguous, any
    dtype, updated IN PLACE; a_new: (B, Fa) and b_new: (B, Fb) in the pools'
    dtypes; block_tables: (B, M) int32; pos: (B,) int32; all on one CUDA
    device. Returns (gathered_a (B, M, page, Fa), gathered_b, a_pool,
    b_pool). Launches the kernel; raises on anything it does not take."""
    _build.require_cuda(block_tables, "paged_gather_append block_tables")
    dev = block_tables.device
    if (block_tables.dim() != 2 or block_tables.dtype != torch.int32
            or not block_tables.is_contiguous()):
        raise ValueError(f"paged_gather_append takes contiguous (B, M) int32 "
                         f"block tables, got {tuple(block_tables.shape)} "
                         f"{block_tables.dtype}")
    B, M = block_tables.shape
    if (pos.shape != (B,) or pos.dtype != torch.int32 or pos.device != dev
            or not pos.is_contiguous()):
        raise ValueError(f"paged_gather_append takes ({B},) int32 positions "
                         f"on {dev}, got {tuple(pos.shape)} {pos.dtype} on "
                         f"{pos.device}")
    _check_pool(a_pool, a_new, B, dev, "a")
    _check_pool(b_pool, b_new, B, dev, "b")
    n_pages, page = a_pool.shape[:2]
    if b_pool.shape[:2] != (n_pages, page) or n_pages < 1:
        raise ValueError(f"paged_gather_append pools must share (P >= 1, "
                         f"page), got {tuple(a_pool.shape)} and "
                         f"{tuple(b_pool.shape)}")
    if M * page > 2 ** 31 - 1 or B * M > 2 ** 31 - 1:
        raise ValueError(f"paged_gather_append table ({B}, {M}) x page "
                         f"{page} too large for int32 positions")
    ga = torch.empty((B, M, page, a_pool.shape[2]), dtype=a_pool.dtype,
                     device=dev)
    gb = torch.empty((B, M, page, b_pool.shape[2]), dtype=b_pool.dtype,
                     device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.repro_paged_gather_append(
            block_tables.data_ptr(), pos.data_ptr(), B, M, page, n_pages,
            a_pool.data_ptr(), b_pool.data_ptr(), a_new.data_ptr(),
            b_new.data_ptr(), a_pool.shape[2] * a_pool.element_size(),
            b_pool.shape[2] * b_pool.element_size(), ga.data_ptr(),
            gb.data_ptr(), _build.stream())
    _build.check(err, "paged_gather_append")
    paged_gather_append_cuda.launches += 1
    return ga, gb, a_pool, b_pool


paged_gather_append_cuda.launches = 0
