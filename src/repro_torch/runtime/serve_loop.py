"""Two-stage early-exit prefill serving (the paper's Fig. 3 pipeline), the
port of ``repro/runtime/serve_loop.py``'s prefill servers.

Stage 1 (full batch) -> exit decision -> conditional buffer -> stage 2
(buckets of hard samples only) -> exit merge by sample ID. Between the
stages sits the device ring (``scheduler.RingQueue``); when it is full,
stage 1 stalls while full buckets drain (paper Fig. 7).

``TwoStageServer`` keeps the exit machinery on the device: per stage-1
batch one fused dispatch (the exit-decision kernel, the slot map and the
ring scatter-merge kernel) writes the hard rows straight into the ring;
the single host sync per batch is the scalar ``n_hard`` that steers the
backpressure loop. Stage 2 runs on popped buckets and its logits, like the
easy samples' exit logits, stay on the device until ``flush`` (or until
more than ``max_pending`` groups wait). ``HostLoopServer`` is the
per-sample host loop that the device server is held against.

One device serves both stages here: the JAX package's stage placement is
the degenerate single-device one.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch.core import early_exit as ee
from repro_torch.core import exit_decision as ed
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.scheduler import (  # noqa: F401  (re-exports)
    RingQueue, ServeConfig, ServeStats, _gather_rows, row_spec_of)


def _decide_compact(hidden, exit_logits, sample_ids, c_thr):
    """Exit decision + conditional-buffer compaction at capacity = the
    batch (the JAX package's composed path, which its disaggregated
    placement takes). Returns (slab, slab_ids, n_hard, exit_mask, pred,
    conf)."""
    exit_mask, pred, conf = dispatch.exit_decision_op(exit_logits, c_thr)
    b = hidden.shape[0]
    slab, pos, n_hard = dispatch.gather_compact_op(hidden, ~exit_mask, b)
    slab_ids = torch.where(pos >= 0, sample_ids[torch.clamp(pos, min=0)
                                                .long()], -1)
    return slab, slab_ids, n_hard, exit_mask, pred, conf


class _RingedServer:
    def __init__(self, sc: ServeConfig, device):
        self.sc = sc
        self.device = resolve_device(device)
        self.stats = ServeStats()
        self.ring = RingQueue(sc, self.device, self.stats)
        self.c_thr = float(sc.c_thr)

    @property
    def _count(self) -> int:             # host mirror of the ring count
        return self.ring.count

    def _drain(self) -> None:             # pop one bucket + dispatch stage 2
        raise NotImplementedError

    def _fused_dispatch_enqueue(self, exit_logits, sample_ids, payload):
        """Decision + compaction + in-ring enqueue in one op: the hard rows
        land in the ring at (head + count) offsets. Reads the scalar n_hard
        (the one host sync), advances the host count mirror, and spills
        any rows past the ring's free space through the backpressure loop.
        Returns (exit_mask, pred, conf, n_hard)."""
        ring_buf = self.ring.ensure(row_spec_of(payload))
        (ring_buf, exit_mask, pred, conf, src,
         n_hard_dev) = dispatch.fused_dispatch_op(
            exit_logits, None, sample_ids, payload, ring_buf, self.c_thr)
        self.ring.put_buf(ring_buf)
        n_hard = int(n_hard_dev)              # the one host sync
        if n_hard > 0:
            n_enq = min(n_hard, self.ring.size - self.ring.count)
            self.ring.note_enqueued(n_enq)
            if n_enq < n_hard:                # ring filled mid-batch: spill
                slab = _gather_rows(payload, src)
                ids = torch.where(src >= 0,
                                  sample_ids[torch.clamp(src, min=0).long()],
                                  -1)
                self.ring.enqueue(slab, ids, n_hard, self._drain, off=n_enq)
        return exit_mask, pred, conf, n_hard

    def _pop_bucket(self):
        popped = self.ring.pop()
        if popped is None:
            return None
        bucket, bucket_ids, _ = popped
        return bucket, bucket_ids


class TwoStageServer(_RingedServer):
    """Batch-level EE server over stage callables, device-resident.

    stage1_fn: tokens (B, S) -> (hidden (B, S, d), exit_logits (B, V))
    stage2_fn: hidden slab (C, S, d) -> final logits (C, V)

    ``submit`` runs stage 1, the fused dispatch into the ring, and stage 2
    on every full bucket. Results stay on the device until ``flush``
    collects them (or the backlog passes ``max_pending``): unlike
    ``HostLoopServer``, a sample's logits are not in ``results`` right
    after the submit that resolved it."""

    def __init__(self, stage1_fn: Callable, stage2_fn: Callable,
                 sc: ServeConfig, device="cuda"):
        super().__init__(sc, device)
        self.stage1 = stage1_fn
        self.stage2 = stage2_fn
        self._easy: List[Tuple[np.ndarray, torch.Tensor, torch.Tensor]] = []
        self._buckets: List[Tuple[torch.Tensor, torch.Tensor]] = []

    @staticmethod
    def _collect_easy(entry, results: dict) -> None:
        sids, exit_mask, exit_logits = entry
        mask = exit_mask.cpu().numpy()
        logits = exit_logits.cpu().numpy()
        for i in np.nonzero(mask)[0]:
            results[int(sids[i])] = logits[i]

    @staticmethod
    def _collect_bucket(entry, results: dict) -> None:
        bucket_ids, logits = entry
        ids = bucket_ids.cpu().numpy()
        logits = logits.cpu().numpy()
        for i in np.nonzero(ids >= 0)[0]:
            results[int(ids[i])] = logits[i]

    def _harvest_oldest(self, results: dict) -> None:
        """Collect the oldest pending groups until the backlog fits
        ``max_pending``, bounding device result memory."""
        while len(self._easy) + len(self._buckets) > self.sc.max_pending:
            if self._easy:
                self._collect_easy(self._easy.pop(0), results)
            else:
                self._collect_bucket(self._buckets.pop(0), results)

    def _drain(self) -> None:
        """Pop one bucket from the ring and dispatch stage 2."""
        popped = self._pop_bucket()
        if popped is None:
            return
        bucket, bucket_ids = popped
        self._buckets.append((bucket_ids, self.stage2(bucket)))

    def submit(self, tokens: np.ndarray, sample_ids: np.ndarray,
               results: dict) -> None:
        """Serve one stage-1 batch; full buckets drain as they fill."""
        toks = torch.as_tensor(np.asarray(tokens), device=self.device)
        sids = np.asarray(sample_ids)
        ids_dev = torch.as_tensor(sids.astype(np.int32), device=self.device)
        hidden, exit_logits = self.stage1(toks)
        exit_mask, _, _, n_hard = self._fused_dispatch_enqueue(
            exit_logits, ids_dev, hidden)
        b = int(toks.shape[0])
        self.stats.n_samples += b
        self.stats.record_decisions(b, n_hard)
        self._easy.append((sids, exit_mask, exit_logits))
        while self._count >= self.sc.capacity:
            self._drain()
        self._harvest_oldest(results)

    def flush(self, results: dict) -> None:
        """Drain the ring (a partial last bucket included) and collect
        every pending result into ``results``."""
        while self._count > 0:
            self._drain()
        for entry in self._easy:
            self._collect_easy(entry, results)
        for entry in self._buckets:
            self._collect_bucket(entry, results)
        self._easy.clear()
        self._buckets.clear()


class HostLoopServer:
    """Per-sample host-loop EE server: the decision is the plain
    ``core.exit_decision.decision_and_argmax`` (no kernel), each hard
    hidden row waits in a Python deque, and buckets are re-stacked with
    flush rows copying the first. Same interface as ``TwoStageServer``."""

    def __init__(self, stage1_fn: Callable, stage2_fn: Callable,
                 sc: ServeConfig, device="cuda"):
        self.stage1 = stage1_fn
        self.stage2 = stage2_fn
        self.sc = sc
        self.device = resolve_device(device)
        self.queue: deque = deque()          # (hidden_row, sample_id)
        self.stats = ServeStats()

    def _drain_bucket(self, results: dict) -> None:
        take = min(len(self.queue), self.sc.capacity)
        if take == 0:
            return
        rows, ids = zip(*[self.queue.popleft() for _ in range(take)])
        slab = torch.stack(list(rows))
        if take < self.sc.capacity:          # flush slots
            pad = slab[:1].expand((self.sc.capacity - take,)
                                  + tuple(slab.shape[1:]))
            slab = torch.cat([slab, pad])
        logits = self.stage2(slab).cpu().numpy()
        for i, sid in enumerate(ids):
            results[sid] = logits[i]
        self.stats.n_stage2 += take
        self.stats.record_bucket(take / self.sc.capacity)

    def submit(self, tokens: np.ndarray, sample_ids: np.ndarray,
               results: dict) -> None:
        hidden, exit_logits = self.stage1(
            torch.as_tensor(np.asarray(tokens), device=self.device))
        exit_mask, _, _ = ed.decision_and_argmax(exit_logits, self.sc.c_thr)
        exit_mask = exit_mask.cpu().numpy()
        logits_np = exit_logits.cpu().numpy()
        self.stats.n_samples += len(sample_ids)
        self.stats.record_decisions(len(sample_ids),
                                    int((~exit_mask).sum()))
        for i, sid in enumerate(sample_ids):
            if exit_mask[i]:
                results[sid] = logits_np[i]
            else:
                if len(self.queue) >= self.sc.queue_depth * self.sc.capacity:
                    self.stats.n_stalls += 1
                    self._drain_bucket(results)
                self.queue.append((hidden[i], int(sid)))
        while len(self.queue) >= self.sc.capacity:
            self._drain_bucket(results)

    def flush(self, results: dict) -> None:
        while self.queue:
            self._drain_bucket(results)


def _stage_fns(params, cfg: ArchConfig, spec: ee.EarlyExitSpec):
    """The two stage callables of the prefill servers, both over the full
    param tree on one device."""

    @torch.inference_mode()
    def s1(tokens):
        h, _, logits, _ = ee.stage1_prefill(params, cfg, spec, tokens)
        return h, logits

    @torch.inference_mode()
    def s2(slab):
        logits, _ = ee.stage2_prefill(params, cfg, spec, slab)
        return logits

    return s1, s2


def serve_dataset(server, tokens: np.ndarray, batch: int) -> dict:
    """Run a whole token set through the server in stage-1 batches.
    Returns {sample_id: logits}."""
    n = tokens.shape[0]
    results: dict = {}
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        server.submit(tokens[lo:hi], np.arange(lo, hi), results)
    server.flush(results)
    return results
