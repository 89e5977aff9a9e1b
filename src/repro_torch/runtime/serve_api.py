"""Server construction (the port of ``repro/runtime/serve_api.py``'s
``build``, prefill mode).

The decode modes, the schedulers and the fleet surface (``RequestQueue``,
``ReplicaHandle``, ``validate_request``) are not ported yet; asking for
them raises ``NotImplementedError`` naming the ROADMAP.md item.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.device import resolve_device

_MODES = ("prefill", "decode")
_SCHEDULERS = (None, "sync", "continuous")


def build(params, cfg, spec, sc, *, mode: str = "prefill",
          scheduler: Optional[str] = None, host: bool = False,
          device="cuda"):
    """Build the prefill server over ``params`` (a tree on ``device``):
    ``TwoStageServer``, or ``HostLoopServer`` with ``host=True``.
    ``device="cuda"`` raises when no card is present."""
    from repro_torch.runtime import serve_loop as SL

    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if scheduler not in _SCHEDULERS:
        raise ValueError(
            f"scheduler must be one of {_SCHEDULERS}, got {scheduler!r}")
    if mode == "decode":
        raise NotImplementedError(
            "decode serving is not ported yet: ROADMAP.md Queue 1, items "
            "8-10 (DecodeServer, the schedulers, paged decode)")
    if scheduler is not None:
        raise ValueError(
            "prefill serving has no scheduling policy: pass "
            "scheduler=None (decode owns sync/continuous)")
    dev = resolve_device(device)
    s1, s2 = SL._stage_fns(params, cfg, spec)
    cls = SL.HostLoopServer if host else SL.TwoStageServer
    return cls(s1, s2, sc, device=dev)
