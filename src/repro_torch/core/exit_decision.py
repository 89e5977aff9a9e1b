"""Exit (softmax) decision layer, ATHEENA section III-C.1, Eqs. (2)-(4)
(the port of ``repro/core/exit_decision.py``).

An early exit occurs when max_i softmax(x)_i > C_thr (Eq. 2). Division-free
and max-shifted (Eq. 4): 1 > C_thr * sum_j exp(x_j - m), m = max_j x_j.
These plain functions are the framework-level API; the CUDA kernel in
``kernels/exit_decision`` computes the same triple on the card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def softmax_confidence(logits: torch.Tensor) -> torch.Tensor:
    """max_i softmax(x)_i per row, computed stably. logits: (..., C)."""
    x = logits.float()
    m = x.max(dim=-1).values
    s = torch.exp(x - m[..., None]).sum(dim=-1)
    return 1.0 / s


def decision_and_argmax(logits: torch.Tensor, c_thr: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(exit_mask bool, predicted class int32, confidence fp32) in one pass,
    with the division-free mask ``c_thr * s < 1`` of the kernel."""
    x = logits.float()
    m = x.max(dim=-1).values
    s = torch.exp(x - m[..., None]).sum(dim=-1)
    conf = 1.0 / s
    pred = torch.argmax(x, dim=-1).to(torch.int32)
    return float(np.float32(c_thr)) * s < 1.0, pred, conf


def calibrate_threshold(confidences, target_exit_rate: float) -> float:
    """Pick C_thr so that a ``target_exit_rate`` fraction of the profiling
    set exits early. confidences: (N,) stage-1 max-softmax values.

    Corners as in the JAX package: an empty set and a rate outside [0, 1]
    raise; rate 0 returns the max confidence (the exit test is strict, so
    nothing exits); rate 1 returns the largest float32 strictly below the
    min, so ties at the minimum still exit; otherwise the linear-
    interpolation quantile at 1 - rate (``torch.quantile``'s default, as
    ``jnp.quantile``'s)."""
    conf = torch.as_tensor(confidences, dtype=torch.float32).reshape(-1)
    if conf.numel() == 0:
        raise ValueError("calibrate_threshold needs a non-empty confidence "
                         "set (the online reservoir has not filled yet?)")
    if not 0.0 <= target_exit_rate <= 1.0:
        raise ValueError(f"target_exit_rate must be in [0, 1], got "
                         f"{target_exit_rate}")
    if target_exit_rate <= 0.0:
        return float(conf.max())
    if target_exit_rate >= 1.0:
        return float(np.nextafter(np.float32(conf.min().item()),
                                  np.float32(-1)))
    return float(torch.quantile(conf, 1.0 - target_exit_rate))
