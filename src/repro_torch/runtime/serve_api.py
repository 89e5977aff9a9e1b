"""Server construction and the admission surface (the port of
``repro/runtime/serve_api.py``).

  * ``validate_request``: the one submit-side validation, with the JAX
    package's error messages byte for byte;
  * ``RequestQueue``: the validated FIFO admission queue (sid bookkeeping,
    revocation of unadmitted requests);
  * ``build``: the construction entry point for the ported modes.

The continuous scheduler and its page pool (``scheduler="continuous"``,
``n_pages``; ROADMAP.md Queue 1, items 9-10) and the event feed
(``events=``; item 14) are not ported yet: asking for them raises
``NotImplementedError`` naming the item. Nothing from the runtime is
imported at module scope (``build`` resolves its classes lazily), so the
scheduler can import ``RequestQueue`` without a cycle.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional, Sequence

from repro_torch.device import resolve_device

__all__ = ["RequestQueue", "build", "validate_request"]

_MODES = ("prefill", "decode")
_SCHEDULERS = (None, "sync", "continuous")
_CONTINUOUS_NOT_PORTED = ("the continuous scheduler and its page pool are "
                          "not ported yet: ROADMAP.md Queue 1, items 9-10")


def validate_request(req, *, max_len: Optional[int] = None,
                     is_dup: Optional[Callable[[int], bool]] = None) -> None:
    """Submit-side request validation. ``max_len`` bounds ``len(prompt) +
    n_tokens`` (None = unbounded); ``is_dup(sid)`` says whether the surface
    has already seen the sample id."""
    if req.n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {req.n_tokens}")
    if max_len is not None and len(req.prompt) + req.n_tokens > max_len:
        raise ValueError(
            f"request {req.sample_id}: S + n_tokens = "
            f"{len(req.prompt) + req.n_tokens} exceeds pool max_len "
            f"{max_len}")
    if is_dup is not None and is_dup(req.sample_id):
        raise ValueError(f"duplicate sample id {req.sample_id}")


class RequestQueue:
    """Validated FIFO admission queue over ``Request`` objects. It owns the
    set of queued sample ids that the duplicate check reads; ``revoke``
    hands back unadmitted requests (a pop is the admission boundary)."""

    def __init__(self, max_len: Optional[int] = None,
                 is_dup: Optional[Callable[[int], bool]] = None):
        self.max_len = max_len
        self._is_dup = is_dup
        self._q: Deque = deque()
        self._queued: set = set()

    def append(self, req) -> None:
        """Validate and enqueue (arrival order = queue order)."""
        validate_request(
            req, max_len=self.max_len,
            is_dup=lambda sid: sid in self._queued
            or (self._is_dup is not None and self._is_dup(sid)))
        self._queued.add(req.sample_id)
        self._q.append(req)

    def popleft(self):
        req = self._q.popleft()
        self._queued.discard(req.sample_id)
        return req

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __contains__(self, sample_id: int) -> bool:
        return sample_id in self._queued

    def next_arrival(self) -> Optional[float]:
        """The head request's arrival time (None when empty)."""
        return self._q[0].arrival_time if self._q else None

    def revoke(self, sample_ids: Optional[Sequence[int]] = None) -> List:
        """Remove and return queued requests by sample id (None: all),
        keeping the arrival order of the rest."""
        want = None if sample_ids is None else set(sample_ids)
        taken, kept = [], deque()
        for r in self._q:
            if want is None or r.sample_id in want:
                taken.append(r)
                self._queued.discard(r.sample_id)
            else:
                kept.append(r)
        self._q = kept
        return taken


def build(params, cfg, spec, sc, *, mode: str = "prefill",
          scheduler: Optional[str] = None, n_slots: Optional[int] = None,
          max_len: Optional[int] = None, clock=None, host: bool = False,
          page_size: Optional[int] = None, n_pages: Optional[int] = None,
          events=None, device="cuda"):
    """Build a serving object over ``params`` (a tree on ``device``):

    ==========  ==========  ============================================
    mode        scheduler   returns
    ==========  ==========  ============================================
    "prefill"   None        ``TwoStageServer`` (``HostLoopServer`` with
                            ``host=True``)
    "decode"    None        ``DecodeServer`` (``HostLoopDecoder`` with
                            ``host=True``)
    "decode"    "sync"      ``SyncScheduler`` over a ``DecodeServer``
                            (needs ``n_slots``)
    ==========  ==========  ============================================

    ``page_size`` (decode only) keeps the stage-2 cache in page pools.
    ``mode`` defaults to "prefill" here, where the JAX package defaults to
    decode under the continuous scheduler: the port keeps the prefill
    default until that scheduler is ported. ``device="cuda"`` raises when
    no card is present."""
    from repro_torch.runtime import scheduler as SCH
    from repro_torch.runtime import serve_loop as SL

    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if scheduler not in _SCHEDULERS:
        raise ValueError(
            f"scheduler must be one of {_SCHEDULERS}, got {scheduler!r}")
    if page_size is not None and mode != "decode":
        raise ValueError("page_size is a decode-mode knob (the paged pool "
                         "is the stage-2 decode cache)")
    if n_pages is not None or scheduler == "continuous":
        raise NotImplementedError(_CONTINUOUS_NOT_PORTED)
    dev = resolve_device(device)
    if mode == "prefill":
        if scheduler is not None:
            raise ValueError(
                "prefill serving has no scheduling policy: pass "
                "scheduler=None (decode owns sync/continuous)")
        s1, s2 = SL._stage_fns(params, cfg, spec)
        cls = SL.HostLoopServer if host else SL.TwoStageServer
        return cls(s1, s2, sc, device=dev)
    if events is not None:
        if scheduler is None:
            raise ValueError("events= is a scheduler-mode feed (the bare "
                             "servers have no request lifecycle to emit)")
        raise NotImplementedError(SCH._EVENTS_NOT_PORTED)
    fns = SL.decode_stage_fns(params, cfg, spec, page_size=page_size)
    if scheduler is None:
        if host:
            if page_size is not None:
                raise ValueError("the host-loop oracle has no paged cache "
                                 "(it IS the dense reference)")
            return SL.HostLoopDecoder(fns, sc, device=dev)
        return SL.DecodeServer(fns, sc, device=dev)
    if host:
        raise ValueError("host=True is a baseline-oracle knob for the bare "
                         "servers; schedulers wrap the device-resident one")
    if n_slots is None:
        raise ValueError(f"scheduler={scheduler!r} needs n_slots")
    return SCH.SyncScheduler(SL.DecodeServer(fns, sc, device=dev), n_slots,
                             clock=clock, max_len=max_len)
