"""Plain PyTorch version of the flash-attention kernel.

Semantics (the JAX package's ``flash_attention/kernel.py:
flash_attention_pallas``, shared with the CUDA kernel in
``csrc/flash_attention.cu``): q (B, H, Sq, D), k and v (B, KH, Sk, D) with
H % KH == 0; query head h reads kv head h // (H / KH). Query row i sits at
absolute position ``q_offset + i``; key j at position j. A pair (i, j)
takes part when j < Sk, and, if ``causal``, q_offset + i >= j, and, with a
``window``, q_offset + i - j < window. Scores are (q * D^-1/2) . k in
fp32 from the inputs' values; p = exp(s - max) in fp32 over the pairs that
take part, the PV product in fp32, divided by the row's sum of p; a row
with no pair is 0. The output is (B, H, Sq, D) in q's dtype.

This version materializes each (b, h) head's (Sq, Sk) fp32 scores at once;
it is what the CPU takes and what the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: int = 0, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KH, Sk, D). Returns (B, H, Sq, D) in
    q.dtype."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    dev = q.device
    qi = int(q_offset) + torch.arange(Sq, device=dev)[:, None]
    ki = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= (qi - ki) < window
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=dev)
    for b in range(B):
        for h in range(H):
            qf = q[b, h].float() * D ** -0.5
            kf, vf = k[b, h // G].float(), v[b, h // G].float()
            s = (qf @ kf.T).masked_fill(~mask, float("-inf"))
            m = s.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isneginf(m), 0.0, m)
            p = torch.exp(s - m).masked_fill(~mask, 0.0)
            l = p.sum(dim=-1, keepdim=True)
            l = torch.where(l == 0.0, 1.0, l)
            out[b, h] = ((p @ vf) / l).to(q.dtype)
    return out
