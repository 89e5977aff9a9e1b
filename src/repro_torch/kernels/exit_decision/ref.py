"""Plain PyTorch version of the exit-decision kernel (ATHEENA Eqs. 2-4).

Semantics (shared with the CUDA kernel in ``csrc/exit_decision.cu``):
    exit_mask[i] = max_softmax(logits[i]) > c_thr             (Eq. 2)
  computed division-free and max-shifted (Eq. 4):
    1 > c_thr * sum_j exp(x_ij - m_i),  m_i = max_j x_ij
    conf[i] = 1 / sum_j exp(x_ij - m_i)
    pred[i] = argmax_j x_ij   (first occurrence on ties)
All arithmetic in fp32 whatever the input dtype.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def exit_decision_ref(logits: torch.Tensor, c_thr: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: (B, V) any float. Returns (exit bool (B,), pred i32 (B,),
    conf f32 (B,))."""
    x = logits.float()
    m = x.max(dim=-1).values
    s = torch.exp(x - m[:, None]).sum(dim=-1)
    conf = 1.0 / s
    pred = torch.argmax(x, dim=-1).to(torch.int32)
    exit_mask = float(np.float32(c_thr)) * s < 1.0
    return exit_mask, pred, conf
