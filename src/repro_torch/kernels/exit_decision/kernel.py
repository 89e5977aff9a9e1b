"""Wrapper of the CUDA exit-decision kernel (``csrc/exit_decision.cu``).

Replaces the TPU kernel ``repro/kernels/exit_decision/kernel.py:
exit_decision_pallas``. Bound on the card: the bytes of the logits, read
once; the vocab is split into chunks so that B rows fill the card (see the
source for the design).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

CHUNK = 4096          # vocab columns per block in the partial pass
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def exit_decision_cuda(logits: torch.Tensor, c_thr: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: (B, V) float32/bfloat16/float16 on a CUDA device, rows
    contiguous. Returns (exit bool (B,), pred i32 (B,), conf f32 (B,)).
    Launches the kernel; raises on anything it does not take."""
    _build.require_cuda(logits, "exit_decision")
    if logits.dim() != 2 or logits.dtype not in DTYPE_CODES:
        raise ValueError(f"exit_decision takes (B, V) float32/bfloat16/"
                         f"float16 logits, got {tuple(logits.shape)} "
                         f"{logits.dtype}")
    if logits.stride(1) != 1:
        raise ValueError("exit_decision needs unit stride along the vocab")
    B, V = logits.shape
    if not 0 < B <= 65535 or V == 0:
        raise ValueError(f"exit_decision takes 1 <= B <= 65535 rows and "
                         f"V >= 1, got {(B, V)}")
    n_chunks = -(-V // CHUNK)
    dev = logits.device
    part_m = torch.empty((B, n_chunks), dtype=torch.float32, device=dev)
    part_s = torch.empty((B, n_chunks), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, n_chunks), dtype=torch.int32, device=dev)
    exit_mask = torch.empty((B,), dtype=torch.bool, device=dev)
    pred = torch.empty((B,), dtype=torch.int32, device=dev)
    conf = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.repro_exit_decision(
            logits.data_ptr(), DTYPE_CODES[logits.dtype], B, V,
            logits.stride(0), CHUNK, n_chunks, part_m.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), float(np.float32(c_thr)),
            exit_mask.data_ptr(), pred.data_ptr(), conf.data_ptr(),
            _build.stream())
    _build.check(err, "exit_decision")
    exit_decision_cuda.launches += 1
    return exit_mask, pred, conf


exit_decision_cuda.launches = 0
