"""Wrapper of the CUDA stream-compaction kernel (``csrc/gather_compact.cu``).

Replaces the TPU kernel ``repro/kernels/gather_compact/kernel.py:
gather_compact_pallas``. Bound on the card: the bytes of the rows it moves,
(min(n_hard, C) + C) payload rows; a one-block prefix sum builds the take
vector, then a row copy in 16-byte words (see the source).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build


def gather_compact_cuda(x: torch.Tensor, hard_mask: torch.Tensor,
                        capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, F) contiguous, any dtype; hard_mask: (B,) bool; both on one
    CUDA device. Returns (slab (C, F), slab_ids (C,) i32, n_hard () i32).
    Launches the kernel; raises on anything it does not take."""
    _build.require_cuda(x, "gather_compact")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"gather_compact takes a contiguous (B, F) payload, "
                         f"got {tuple(x.shape)}")
    B = x.shape[0]
    if B == 0:
        raise ValueError("gather_compact needs at least one row (flush "
                         "slots copy row 0)")
    if (hard_mask.shape != (B,) or hard_mask.dtype != torch.bool
            or hard_mask.device != x.device):
        raise ValueError(f"gather_compact needs a ({B},) bool mask on "
                         f"{x.device}, got {tuple(hard_mask.shape)} "
                         f"{hard_mask.dtype} on {hard_mask.device}")
    if not 0 <= capacity <= 65535:
        raise ValueError(f"gather_compact capacity {capacity} outside "
                         f"[0, 65535]")
    mask = hard_mask.contiguous()
    dev = x.device
    slab = torch.empty((capacity, x.shape[1]), dtype=x.dtype, device=dev)
    ids = torch.empty((capacity,), dtype=torch.int32, device=dev)
    n_hard = torch.empty((), dtype=torch.int32, device=dev)
    take = torch.empty((capacity,), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.repro_gather_compact(
            x.data_ptr(), mask.data_ptr(), B, x.shape[1] * x.element_size(),
            capacity, slab.data_ptr(), ids.data_ptr(), n_hard.data_ptr(),
            take.data_ptr(), _build.stream())
    _build.check(err, "gather_compact")
    gather_compact_cuda.launches += 1
    return slab, ids, n_hard


gather_compact_cuda.launches = 0
