"""Serving substrate shared by the port's servers (the port of the ring and
stats part of ``repro/runtime/scheduler.py``).

  * ``ServeConfig`` / ``ServeStats``: the serving knobs and counters, with
    the JAX package's versioned ``as_dict`` key set (schema v3);
  * the device ring over a pytree payload (``ring_init``,
    ``_ring_enqueue_range``, ``ring_enqueue``, ``ring_drain``): every leaf
    is a ``(size, *row)`` slab sharing one sample-ID lane and int32
    head/count cursors on the device. PyTorch tensors are mutable, so the
    ring is updated IN PLACE where the JAX package donated it and returned
    a new one; each function returns the same dict;
  * ``RingQueue``: chunked enqueue under backpressure plus bucket pops
    (the paper's Fig. 7 sizing story).

The continuous scheduler, the fault points around the enqueue and the
harvest timeouts are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

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
                "decisions_per_sample":
                    self.n_decisions / max(self.n_samples, 1),
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
