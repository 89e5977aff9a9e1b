"""Kernel dispatch: where each exit-machinery op runs.

The serving runtime (``runtime/serve_loop.py``) and the one-shot pipeline
(``core/early_exit.serve_batch``) call the ops here. The choice follows the
tensors, and nothing else:

  * a CUDA tensor goes to the hand-written CUDA kernel, which launches or
    raises: there is no fallback to the plain version on the card;
  * a CPU tensor goes to the plain PyTorch version beside the kernel
    (``ref.py``), which is how the tests run the port without a card.

Any other device raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.exit_decision.kernel import exit_decision_cuda
from repro_torch.kernels.exit_decision.ref import exit_decision_ref
from repro_torch.kernels.fused_dispatch.kernel import fused_dispatch_cuda
from repro_torch.kernels.fused_dispatch.ref import fused_dispatch_ref
from repro_torch.kernels.gather_compact.kernel import gather_compact_cuda
from repro_torch.kernels.gather_compact.ref import gather_compact_ref


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}: the port runs "
                     f"its kernels on CUDA and their plain versions on the "
                     f"CPU")


def exit_decision_op(logits: torch.Tensor, c_thr
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused exit decision (Eq. 4). logits: (..., V) -> (exit bool, pred
    i32, conf f32), each shaped (...,). One read of the logits; no softmax
    is materialized by the kernel."""
    lead = logits.shape[:-1]
    x = logits.reshape(-1, logits.shape[-1])
    fn = exit_decision_cuda if on_card(x) else exit_decision_ref
    e, p, c = fn(x, c_thr)
    return e.reshape(lead), p.reshape(lead), c.reshape(lead)


def gather_compact_op(x: torch.Tensor, hard_mask: torch.Tensor,
                      capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Conditional-buffer compaction. x: (B, ...); hard_mask: (B,) bool.
    Returns (slab (capacity, ...), slab_ids (capacity,) int32 with -1 flush
    slots, n_hard () int32)."""
    B, feat = x.shape[0], x.shape[1:]
    xf = x.reshape(B, -1)
    fn = gather_compact_cuda if on_card(xf) else gather_compact_ref
    slab, ids, nh = fn(xf, hard_mask, capacity)
    return slab.reshape((capacity,) + tuple(feat)), ids, nh


def fused_dispatch_op(logits: torch.Tensor, active: Optional[torch.Tensor],
                      sample_ids: torch.Tensor, payload, ring: dict, c_thr):
    """Decision + compaction + in-ring enqueue in one pass over each
    operand. logits (B, V); active (B,) bool or None; sample_ids (B,)
    int32; payload a pytree of (B, *row) leaves matching ``ring['data']``.
    The ring is updated IN PLACE (the JAX op donated it and returned a new
    one). Returns (ring, exit_mask, pred, conf, src, n_hard); rows past the
    ring's free space are NOT written (the caller spills them via src)."""
    fn = fused_dispatch_cuda if on_card(logits) else fused_dispatch_ref
    return fn(logits, active, sample_ids, payload, ring, c_thr)
