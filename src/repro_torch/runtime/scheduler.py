"""Serving substrate shared by the port's servers, and the sync decode
scheduler (the port of ``repro/runtime/scheduler.py``, all but the
continuous scheduler and its page allocator).

  * ``ServeConfig`` / ``ServeStats``: the serving knobs and counters, with
    the JAX package's versioned ``as_dict`` key set (schema v3);
  * the device ring over a pytree payload (``ring_init``,
    ``_ring_enqueue_range``, ``ring_enqueue``, ``ring_drain``): every leaf
    is a ``(size, *row)`` slab sharing one sample-ID lane and int32
    head/count cursors on the device. PyTorch tensors are mutable, so the
    ring is updated IN PLACE where the JAX package donated it and returned
    a new one; each function returns the same dict;
  * ``RingQueue``: chunked enqueue under backpressure plus bucket pops
    (the paper's Fig. 7 sizing story);
  * ``_gather_rows`` / ``_scatter_rows``: sample-major row moves between a
    store and a compacted slab, with no host sync;
  * ``Request``, ``Clock`` / ``LogicalClock``, ``poisson_arrivals``: the
    open-loop request plumbing;
  * ``SyncScheduler``: static batch formation over a step-synchronous
    decode server's ``generate``.

The continuous scheduler and its ``PageAllocator`` (ROADMAP.md Queue 1,
items 9-10), the event feed and the drift controller (item 14), the fault
points around the enqueue and the harvest timeouts are not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import dispatch
from repro_torch.runtime.serve_api import RequestQueue

# bounded history so long-running streams keep O(1)-ish stats memory
_SERIES_CAP = 65536
# the drift filter's window and smoothing (repro/runtime/telemetry.py)
DRIFT_WINDOW = 256
DRIFT_ALPHA = 0.1


def ewma(series) -> float:
    """EWMA (alpha DRIFT_ALPHA) over the last DRIFT_WINDOW entries of
    ``series``; 0.0 when empty."""
    v: Optional[float] = None
    for x in list(series)[-DRIFT_WINDOW:]:
        v = float(x) if v is None else (DRIFT_ALPHA * float(x)
                                        + (1.0 - DRIFT_ALPHA) * v)
    return 0.0 if v is None else v


@dataclass
class ServeConfig:
    capacity: int                   # stage-2 bucket size (ceil(p*B) rounded)
    queue_depth: int = 4            # buckets the ring can hold
    c_thr: float = 0.9
    max_pending: int = 16           # pending device result groups (stage-1
                                    # batches + stage-2 buckets) before the
                                    # oldest are collected to host


@dataclass
class ServeStats:
    """Serving counters (the JAX package's ``ServeStats``; see its
    docstring for each field). ``as_dict`` emits the same versioned key set
    (schema v3). The fields of planes the port does not have yet (latency
    tracking, migration, the paged cache) stay at their zero values."""
    SCHEMA_VERSION = 3
    n_samples: int = 0
    n_decisions: int = 0
    n_exited: int = 0
    n_stage2: int = 0
    n_stalls: int = 0
    n_stage1_batches: int = 0
    n_buckets: int = 0
    provisioned_p: Optional[float] = None
    bucket_fill_sum: float = 0.0
    stage1_chips: int = 1
    stage2_chips: int = 1
    latencies: Deque[float] = field(
        default_factory=lambda: deque(maxlen=_SERIES_CAP), repr=False)
    submit_times: Dict[int, float] = field(default_factory=dict, repr=False)
    realized_q_series: Deque[float] = field(
        default_factory=lambda: deque(maxlen=_SERIES_CAP), repr=False)
    _q_window: Deque[float] = field(
        default_factory=lambda: deque(maxlen=DRIFT_WINDOW), repr=False)
    n_migrations: int = 0
    n_migration_rollbacks: int = 0
    migration_pauses_ms: Deque[float] = field(
        default_factory=lambda: deque(maxlen=1024), repr=False)
    cache_pages_total: int = 0
    cache_pages_in_use: int = 0
    cache_hbm_bytes: int = 0
    cache_page_size: int = 0
    live_tokens: int = 0
    ring_bytes_moved: int = 0

    def record_decisions(self, n: int, n_hard: int) -> None:
        self.n_stage1_batches += 1
        self.n_decisions += n
        self.n_exited += n - n_hard
        q = n_hard / n if n else 0.0
        self.realized_q_series.append(q)
        self._q_window.append(q)

    def record_bucket(self, fill: float) -> None:
        self.n_buckets += 1
        self.bucket_fill_sum += fill

    def record_submit(self, sample_id: int, t: float) -> None:
        self.submit_times[sample_id] = t

    def record_finish(self, sample_id: int, t: float) -> None:
        """Submit -> finish latency; a finish with no recorded submit is
        ignored, so servers that never record submits stay latency-free."""
        t0 = self.submit_times.pop(sample_id, None)
        if t0 is not None:
            self.latencies.append(t - t0)

    @property
    def n_finished(self) -> int:
        return len(self.latencies)

    @property
    def decisions_per_sample(self) -> float:
        return self.n_decisions / max(self.n_samples, 1)

    @staticmethod
    def _pct(series, pct: float) -> float:
        return float(np.percentile(np.asarray(series), pct)) if series \
            else 0.0

    @property
    def mean_bucket_fill(self) -> float:
        return self.bucket_fill_sum / self.n_buckets if self.n_buckets else 0.0

    @property
    def stage1_occupancy(self) -> float:
        total = self.n_stage1_batches + self.n_stalls
        return self.n_stage1_batches / total if total else 0.0

    @property
    def realized_q(self) -> float:
        return self.n_stage2 / max(self.n_decisions, 1)

    @property
    def realized_q_ewma(self) -> float:
        return ewma(self._q_window)

    @property
    def q_drift(self) -> float:
        if self.provisioned_p is None:
            return 0.0
        return self.realized_q_ewma - self.provisioned_p

    @property
    def page_fragmentation(self) -> float:
        cap = self.cache_pages_in_use * self.cache_page_size
        if cap <= 0:
            return 0.0
        return float(min(max(1.0 - self.live_tokens / cap, 0.0), 1.0))

    def as_dict(self):
        lat = self.latencies
        return {"schema_version": self.SCHEMA_VERSION,
                "n_samples": self.n_samples, "n_decisions": self.n_decisions,
                "n_exited": self.n_exited, "n_stage2": self.n_stage2,
                "n_stalls": self.n_stalls, "realized_q": self.realized_q,
                "decisions_per_sample": self.decisions_per_sample,
                "mean_bucket_fill": self.mean_bucket_fill,
                "stage1_chips": self.stage1_chips,
                "stage2_chips": self.stage2_chips,
                "stage1_occupancy": self.stage1_occupancy,
                # buckets share one capacity: mean fill IS slot occupancy
                "stage2_occupancy": self.mean_bucket_fill,
                "n_finished": len(lat),
                "latency_p50": self._pct(lat, 50.0),
                "latency_p90": self._pct(lat, 90.0),
                "latency_p99": self._pct(lat, 99.0),
                "provisioned_p": self.provisioned_p,
                "realized_q_ewma": self.realized_q_ewma,
                "q_drift": self.q_drift,
                "n_migrations": self.n_migrations,
                "n_migration_rollbacks": self.n_migration_rollbacks,
                "migration_pause_p50_ms":
                    self._pct(self.migration_pauses_ms, 50.0),
                "migration_pause_p99_ms":
                    self._pct(self.migration_pauses_ms, 99.0),
                "cache_pages_total": self.cache_pages_total,
                "cache_pages_in_use": self.cache_pages_in_use,
                "cache_pages_free": max(self.cache_pages_total
                                        - self.cache_pages_in_use, 0),
                "cache_hbm_bytes": self.cache_hbm_bytes,
                "page_fragmentation": self.page_fragmentation,
                "ring_bytes_moved": self.ring_bytes_moved,
                "realized_q_series": list(self.realized_q_series)}


# ---------------------------------------------------------------------------
# device ring over a pytree payload, updated in place
# ---------------------------------------------------------------------------

def ring_init(size: int, row, device) -> dict:
    """Allocate the ring on ``device``. ``row`` is a pytree of per-row
    ``(shape, dtype)`` pairs (``row_spec_of`` a payload). Returns {'data'
    pytree of (size, *row_leaf), 'ids' (size,) int32 all -1 (the unused
    sample ID), 'head' (), 'count' ()}."""
    data = pytree.tree_map(
        lambda spec: torch.zeros((size,) + tuple(spec[0]), dtype=spec[1],
                                 device=device),
        row, is_leaf=_is_row_spec)
    return {
        "data": data,
        "ids": torch.full((size,), -1, dtype=torch.int32, device=device),
        "head": torch.zeros((), dtype=torch.int32, device=device),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _is_row_spec(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def row_spec_of(tree):
    """The per-row ``(shape, dtype)`` pytree of a batch-major payload."""
    return pytree.tree_map(lambda t: (tuple(t.shape[1:]), t.dtype), tree)


def _ring_enqueue_range(buf: dict, slab, slab_ids: torch.Tensor, lo: int,
                        hi: int) -> dict:
    """Append slab rows [lo, min(hi, n_valid)) at the ring's tail, where
    n_valid is the compacted slab's valid prefix (ids >= 0). The caller
    guarantees the range fits. Reads n_valid to the host (the spill path
    runs after the batch's n_hard sync)."""
    size = buf["ids"].shape[0]
    n_valid = int((slab_ids >= 0).sum())
    upper = min(hi, n_valid)
    if upper <= lo:
        return buf
    lanes = torch.arange(upper - lo, dtype=torch.int32,
                         device=slab_ids.device)
    idx = ((buf["head"] + buf["count"] + lanes) % size).long()

    def put(d, s):
        d[idx] = s[lo:upper].to(d.dtype)

    pytree.tree_map(put, buf["data"], slab)
    buf["ids"][idx] = slab_ids[lo:upper].to(torch.int32)
    buf["count"] = buf["count"] + (upper - lo)
    return buf


def ring_enqueue(buf: dict, slab, slab_ids: torch.Tensor) -> dict:
    """Append the whole valid prefix of a compacted slab (ids >= 0)."""
    return _ring_enqueue_range(buf, slab, slab_ids, 0, slab_ids.shape[0])


def ring_drain(buf: dict, capacity: int):
    """Pop up to ``capacity`` samples from the ring's head into a stage-2
    bucket. Returns (buf, bucket pytree of (capacity, *row_leaf),
    bucket_ids (capacity,)): slots past the take carry id -1 (flush) and
    whatever stale rows the ring holds (stage 2 is row-independent; the
    merge drops flush rows). No host sync."""
    size = buf["ids"].shape[0]
    take_n = torch.clamp(buf["count"], max=capacity)
    lanes = torch.arange(capacity, dtype=torch.int32,
                         device=buf["ids"].device)
    idx = ((buf["head"] + lanes) % size).long()
    valid = lanes < take_n
    bucket = pytree.tree_map(lambda d: d[idx], buf["data"])
    old_ids = buf["ids"][idx]
    bucket_ids = torch.where(valid, old_ids, -1)
    buf["ids"][idx] = torch.where(valid, -1, old_ids)
    buf["head"] = (buf["head"] + take_n) % size
    buf["count"] = buf["count"] - take_n
    return buf, bucket, bucket_ids


class RingQueue:
    """Chunked enqueue / bucket pop over the device ring: the hard-sample
    queue of the two-stage servers.

    ``enqueue`` appends rows of a compacted slab pytree in chunks, calling
    ``drain_one`` (pop a bucket + dispatch stage 2) whenever the ring is
    out of space, so a batch with more hard samples than the whole ring
    still serves: it just stalls stage 1 harder (paper Fig. 7). ``count``
    mirrors the device cursor on the host."""

    def __init__(self, sc: ServeConfig, device, stats: ServeStats):
        self.sc = sc
        self.device = device
        self.stats = stats
        self.size = sc.queue_depth * sc.capacity
        self._buf: Optional[dict] = None
        self.count = 0
        self._row_nbytes = 0

    def reset(self) -> None:
        """Forget the buffer: the next ``ensure`` allocates one for the new
        stream's row shapes."""
        self._buf, self.count, self._row_nbytes = None, 0, 0

    def ensure(self, row_spec) -> dict:
        """Allocate (or return) the device buffer for rows ``row_spec`` (a
        pytree of ``(shape, dtype)``)."""
        if self._buf is None:
            self._buf = ring_init(self.size, row_spec, self.device)
            self._row_nbytes = sum(
                t[0].numel() * t.element_size()
                for t in pytree.tree_leaves(self._buf["data"]))
        return self._buf

    def put_buf(self, buf: dict) -> None:
        self._buf = buf

    def note_enqueued(self, k: int) -> None:
        """Advance the host mirror for ``k`` rows the fused dispatch
        already wrote on the device."""
        self.count += k
        self.stats.ring_bytes_moved += k * self._row_nbytes

    def enqueue(self, slab_tree, slab_ids: torch.Tensor, n_hard: int,
                drain_one: Callable[[], None], off: int = 0) -> None:
        """Append rows [off, n_hard) of the compacted slab. ``off > 0`` is
        the fused dispatch's overflow spill: the first ``off`` rows already
        sit in the ring."""
        self.ensure(row_spec_of(slab_tree))
        while off < n_hard:
            free = self.size - self.count
            if free == 0:
                self.stats.n_stalls += 1
                before = self.count
                drain_one()
                # a drain that frees nothing would spin this loop forever
                if self.count >= before:
                    raise RuntimeError(
                        "ring backpressure drain made no progress "
                        f"(count {before} -> {self.count}): stage-2 "
                        "dispatch is stuck")
                continue
            take = min(free, n_hard - off)
            self._buf = _ring_enqueue_range(self._buf, slab_tree, slab_ids,
                                            off, off + take)
            self.count += take
            self.stats.ring_bytes_moved += take * self._row_nbytes
            off += take

    def pop(self):
        """Pop up to ``capacity`` rows; returns (bucket pytree, ids,
        n_taken) or None when the ring is empty."""
        take = min(self.count, self.sc.capacity)
        if take == 0:
            return None
        self._buf, bucket, bucket_ids = ring_drain(self._buf,
                                                   self.sc.capacity)
        self.count -= take
        self.stats.n_stage2 += take
        self.stats.record_bucket(take / self.sc.capacity)
        return bucket, bucket_ids, take


def _gather_rows(rows, ids: torch.Tensor):
    """Gather batch-major rows by compacted slab ids (-1 flush slots read
    row 0; their content is never used)."""
    take = torch.clamp(ids, min=0).long()
    return pytree.tree_map(lambda m: m[take], rows)


def _scatter_rows(rows, bucket_rows, ids: torch.Tensor):
    """Scatter updated bucket rows back into a sample-major store IN PLACE
    (the JAX package donated the store and scattered with drop mode): store
    row ``ids[j]`` <- bucket row j for every ``ids[j] >= 0``; flush ids (-1)
    write nothing. The inverse map is built on the device and the rows move
    through the ring scatter-merge kernel (``dispatch.scatter_merge_op``),
    so nothing syncs with the host. Returns ``rows``."""
    leaves = pytree.tree_leaves(rows)
    if not leaves:
        return rows
    b = leaves[0].shape[0]
    dev = ids.device
    # store row -> bucket lane; flush lanes land in a scratch slot past the
    # end (live ids are distinct, so no two lanes claim one store row)
    src_map = torch.full((b + 1,), -1, dtype=torch.int32, device=dev)
    safe = torch.where(ids >= 0, ids, b).long()
    src_map[safe] = torch.arange(ids.shape[0], dtype=torch.int32, device=dev)
    src_map = src_map[:b]

    def put(m, r):
        if m[0].numel() == 0:
            return
        dispatch.scatter_merge_op(src_map, r.reshape(r.shape[0], -1)
                                  .to(m.dtype).contiguous(),
                                  m.view(b, -1))

    pytree.tree_map(put, rows, bucket_rows)
    return rows


# ---------------------------------------------------------------------------
# open-loop request plumbing: arrivals, clocks
# ---------------------------------------------------------------------------

@dataclass
class Request:
    """One decode request in the admission queue. ``arrival_time`` is in the
    scheduler clock's time base (seconds); a request is admissible once the
    clock passes it."""
    sample_id: int
    prompt: np.ndarray          # (S,) int32
    n_tokens: int               # total tokens to emit (incl. prefill token)
    arrival_time: float = 0.0


class Clock:
    """Wall clock with fast-forward: ``now`` is seconds since construction
    plus all skipped idle time, so an idle server jumps to the next arrival
    instead of sleeping, while service time stays real wall time."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._skip = 0.0

    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._skip

    def advance_to(self, t: float) -> None:
        gap = t - self.now()
        if gap > 0:
            self._skip += gap


class LogicalClock:
    """Deterministic clock for tests: only ``advance_to`` moves it."""

    def __init__(self, t: float = 0.0):
        self._t = t

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        self._t = max(self._t, t)


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Cumulative Poisson-process arrival times for ``n`` requests at
    ``rate`` (requests/second); ``rate`` <= 0 or inf means all at t=0."""
    if not np.isfinite(rate) or rate <= 0:
        return np.zeros(n)
    gaps = np.random.default_rng(seed).exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)


# ---------------------------------------------------------------------------
# the sync policy: static batch formation over a step-synchronous server
# ---------------------------------------------------------------------------

_EVENTS_NOT_PORTED = ("the request-lifecycle event feed is not ported: "
                      "ROADMAP.md Queue 1, item 14 (observability)")


class SyncScheduler:
    """Batch formation over a step-synchronous decode server
    (``DecodeServer`` or ``HostLoopDecoder``): admit requests in arrival
    order into static batches of ``n_slots``, wait for the batch's last
    arrival, run ``generate`` to the batch's longest request (finished
    samples ride along until the whole batch completes), truncate per
    request. Prompts within a batch share one length. A partial tail batch
    runs at its own, smaller shape; the stats count real traffic only.

    ``max_len`` bounds requests when given (``validate_request``).
    ``request_migration`` raises, as in the JAX package (the sync policy
    has no live slot pool). The event feed (``events=``) is not ported."""

    def __init__(self, server, n_slots: int, clock=None,
                 max_len: Optional[int] = None, events=None):
        if events is not None:
            raise NotImplementedError(_EVENTS_NOT_PORTED)
        self.server = server
        self.n_slots = n_slots
        self.max_len = max_len
        self.clock = clock or Clock()
        self.queue = RequestQueue(max_len=max_len,
                                  is_dup=lambda sid: sid in self.results)
        self.results: Dict[int, List[int]] = {}

    @property
    def stats(self) -> ServeStats:
        return self.server.stats

    def request_migration(self, plan) -> None:
        raise NotImplementedError(
            "the sync policy has no live slot pool to migrate — live "
            "migration needs the continuous scheduler")

    @property
    def queue_len(self) -> int:
        return len(self.queue)

    def next_arrival(self) -> Optional[float]:
        return self.queue.next_arrival()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def step(self) -> str:
        """Form and run ONE static batch (waiting for its last arrival).
        Returns "busy" when a batch ran, "idle" when the queue is empty."""
        if not self.queue:
            return "idle"
        batch = [self.queue.popleft()
                 for _ in range(min(self.n_slots, len(self.queue)))]
        self.clock.advance_to(max(r.arrival_time for r in batch))
        for r in batch:
            self.stats.record_submit(r.sample_id, r.arrival_time)
        prompts = np.stack([np.asarray(r.prompt, np.int32) for r in batch])
        n_max = max(r.n_tokens for r in batch)
        out = self.server.generate(prompts, n_max)
        t = self.clock.now()
        for i, r in enumerate(batch):
            self.results[r.sample_id] = [
                int(x) for x in out["tokens"][i, :r.n_tokens]]
            self.stats.record_finish(r.sample_id, t)
        return "busy"

    def drain(self) -> Dict[int, List[int]]:
        while self.step() != "idle":
            pass
        return self.results

    def run(self) -> Dict[int, List[int]]:
        return self.drain()
