"""Kernel dispatch: where each exit-machinery and attention op runs.

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
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.fused_dispatch.kernel import (fused_dispatch_cuda,
                                                       scatter_merge_cuda)
from repro_torch.kernels.fused_dispatch.ref import (fused_dispatch_ref,
                                                    scatter_merge_ref)
from repro_torch.kernels.gather_compact.kernel import gather_compact_cuda
from repro_torch.kernels.gather_compact.ref import gather_compact_ref
from repro_torch.kernels.paged_attention.kernel import \
    paged_gather_append_cuda
from repro_torch.kernels.paged_attention.ref import paged_gather_append_ref


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


def scatter_merge_op(src_map: torch.Tensor, x: torch.Tensor,
                     dst: torch.Tensor) -> torch.Tensor:
    """Row scatter without a host sync: dst row r <- x row ``src_map[r]``
    where that is >= 0, IN PLACE. src_map (R,) int32; x (C, F) and dst
    (R, F) contiguous, one dtype. The ring scatter-merge kernel on the card
    (the serving loop's bucket merges use it beside the ring enqueue)."""
    fn = scatter_merge_cuda if on_card(dst) else scatter_merge_ref
    return fn(src_map, x, dst)


def paged_gather_append(a_pool, b_pool, a_new, b_new, block_tables, pos):
    """Paged-cache append + gather for one attention layer.

    a_pool/b_pool: (P, page, *F) page pools (page 0 = NULL, all zeros),
    updated IN PLACE; a_new/b_new: (B, *F) new-token rows; block_tables:
    (B, M) int32; pos: (B,) int32 write positions (>= M * page skips the
    append). Returns (gathered_a (B, M, page, *Fa), gathered_b, a_pool,
    b_pool): the gathered slabs reshaped to (B, M * page, *F) are the dense
    cache rows, appended token included. Feature dims are flattened for
    the kernel and restored here."""
    fa, fb = a_pool.shape[2:], b_pool.shape[2:]
    n_pages, page = a_pool.shape[:2]
    B, M = block_tables.shape
    if not on_card(a_pool):
        return paged_gather_append_ref(a_pool, b_pool, a_new, b_new,
                                       block_tables, pos)
    ga, gb, _, _ = paged_gather_append_cuda(
        a_pool.view(n_pages, page, -1), b_pool.view(n_pages, page, -1),
        a_new.reshape(B, -1).contiguous(), b_new.reshape(B, -1).contiguous(),
        block_tables.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous())
    return (ga.view((B, M, page) + tuple(fa)),
            gb.view((B, M, page) + tuple(fb)), a_pool, b_pool)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blocked causal / windowed GQA attention, the mesh prefill path's
    per-shard core. q: (B, H, Sq, D); k, v: (B, KH, Sk, D); ``q_offset``
    the absolute position of q row 0. Returns (B, H, Sq, D) in q.dtype."""
    fn = flash_attention_cuda if on_card(q) else flash_attention_ref
    return fn(q, k, v, q_offset, causal=causal, window=window)
