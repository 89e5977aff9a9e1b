"""Two-stage early-exit serving (the paper's Fig. 3 pipeline), the port of
``repro/runtime/serve_loop.py``: prefill servers and step-synchronous
decode servers.

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

``DecodeServer`` makes the exit decision per token: each decode step runs
stage 1 on the whole batch, and only the hard tokens' hidden rows, with
their samples' stage-2 cache rows (or, paged, their block-table rows), go
through the ring into bucketed stage-2 dispatches. Decode is
step-synchronous, so the ring drains fully every step. A token that exits
early skips stage 2, so its stage-2 cache keeps zeros at that position
(exit-gap semantics, shared bit for bit with ``HostLoopDecoder``).

One device serves both stages here: the JAX package's stage placement is
the degenerate single-device one.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import early_exit as ee
from repro_torch.core import exit_decision as ed
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.scheduler import (  # noqa: F401  (re-exports)
    RingQueue, ServeConfig, ServeStats, _gather_rows, _scatter_rows,
    row_spec_of)


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


# ---------------------------------------------------------------------------
# decode serving: per-token exit decisions, stage-2 cache rows through the
# ring
# ---------------------------------------------------------------------------

def _map_blocks(blocks, fn):
    return tuple(None if b is None else {k: fn(x) for k, x in b.items()}
                 for b in blocks)


def cache_rows_of(seg: dict) -> dict:
    """Re-layout a segment cache (run_layers layout) sample-major: 'blocks'
    leaves (n_sb, B, ...) become contiguous (B, n_sb, ...); 'first'/'rem'
    leaves already lead with the batch. The result is a ring payload (rows
    = axis 0 of every leaf)."""
    return {"first": seg["first"],
            "blocks": _map_blocks(seg["blocks"],
                                  lambda x: x.movedim(1, 0).contiguous()),
            "rem": seg["rem"]}


def cache_of_rows(rows: dict) -> dict:
    """Inverse of ``cache_rows_of``, as views: back to the run_layers
    layout."""
    return {"first": rows["first"],
            "blocks": _map_blocks(rows["blocks"],
                                  lambda x: x.movedim(0, 1)),
            "rem": rows["rem"]}


# -- paged stage-2 cache: page pools + block tables instead of dense rows ---

def _is_layer_cache(node) -> bool:
    """A per-layer attention decode cache {k, v}: the one cache shape the
    paged store accepts."""
    return isinstance(node, dict) and "k" in node and "v" in node


def _map_layer_caches(node, fn):
    """Apply ``fn`` to every per-layer cache dict of a segment tree, keeping
    the structure around them."""
    if _is_layer_cache(node):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_layer_caches(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_layer_caches(v, fn) for v in node)
    return node


def paged_seg_pool(rows: dict, page_size: int, n_pages: int) -> dict:
    """Zero page pools (run_layers layout) shaped after a sample-major
    stage-2 rows tree: 'blocks' leaves (B, n_sb, max_len, *F) become (n_sb,
    n_pages, page, *F), 'rem' leaves (B, max_len, *F) become (n_pages, page,
    *F). Every leaf's position axis must be the same max_len, a multiple of
    ``page_size``."""
    if rows["first"]:
        raise ValueError("stage-2 rows carry no 'first' caches; got a "
                         "non-empty first segment — not pageable")
    lens = set()

    def pool_leaf(x, lead):
        L = x.shape[1 + lead]
        if L % page_size != 0:
            raise ValueError(f"cache position axis {L} is not a multiple of "
                             f"page_size={page_size} — not pageable")
        lens.add(L)
        head = (x.shape[1],) if lead else ()
        return torch.zeros(head + (n_pages, page_size)
                           + tuple(x.shape[2 + lead:]), dtype=x.dtype,
                           device=x.device)

    def check(node, lead):
        if not _is_layer_cache(node):
            raise ValueError("non-attention cache — not pageable")
        if "bt" in node:
            raise ValueError("rows template is already paged")
        return {k: pool_leaf(v, lead) for k, v in node.items()}

    pool = {"first": [],
            "blocks": _map_layer_caches(rows["blocks"],
                                        lambda d: check(d, 1)),
            "rem": _map_layer_caches(rows["rem"], lambda d: check(d, 0))}
    if len(lens) > 1:
        raise ValueError(f"inconsistent cache position axes {sorted(lens)} "
                         "— not pageable")
    return pool


def _inject_bt(pool: dict, bt: torch.Tensor) -> dict:
    """Add the block table to every layer-cache dict of a pool tree ('blocks'
    layers get it expanded over their superblock axis)."""
    def blocks_fn(d):
        n_sb = next(iter(d.values())).shape[0]
        return dict(d, bt=bt[None].expand((n_sb,) + tuple(bt.shape)))

    return {"first": pool["first"],
            "blocks": _map_layer_caches(pool["blocks"], blocks_fn),
            "rem": _map_layer_caches(pool["rem"], lambda d: dict(d, bt=bt))}


def _strip_bt(seg: dict) -> dict:
    """Inverse of ``_inject_bt``: drop the block-table leaves."""
    return _map_layer_caches(
        seg, lambda d: {k: v for k, v in d.items() if k != "bt"})


def _sanitize_paged_bucket(bt_rows: torch.Tensor, ids: torch.Tensor, step,
                           sentinel: int):
    """Flush / stale ring rows (ids < 0) must not touch the shared pool:
    their block tables collapse to the NULL page and their write position
    to the out-of-range sentinel, so the append skips them and the gather
    reads zeros. Live rows pass through. Returns (bt (C, M), step (C,))."""
    bad = ids < 0
    step = torch.full(ids.shape, int(step), dtype=torch.int32,
                      device=ids.device)
    return (torch.where(bad[:, None], 0, bt_rows),
            torch.where(bad, sentinel, step).to(torch.int32))


def _merge_bucket_logits(merged: torch.Tensor, ids: torch.Tensor,
                         logits: torch.Tensor) -> torch.Tensor:
    """Exit merge, one bucket at a time: hard samples' rows of the step's
    logits take their stage-2 results (flush ids dropped), in place."""
    return _scatter_rows(merged, logits, ids)


def _merge_bucket_tokens(tok_vec: torch.Tensor, ids: torch.Tensor,
                         logits: torch.Tensor) -> torch.Tensor:
    """Exit merge of the greedy token lane, in place: easy rows keep the
    decision kernel's pred, hard rows take their bucket's argmax."""
    s2_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return _scatter_rows(tok_vec, s2_tok, ids)


def _greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


class DecodeFns(NamedTuple):
    """The decode-stage callables ``DecodeServer`` and ``HostLoopDecoder``
    share, so the two differ only in the exit machinery and agree bit for
    bit. ``step`` is the batch's position (an int). With ``page_size`` set,
    the stage-2 cache is kept as page pools plus block tables, and the
    ring's cache payload is the (M,) int32 table row."""
    prefill: Callable   # (tokens (B, S), max_len) -> (logits, caches)
    split: Callable     # caches -> (stage-1 caches, stage-2 cache rows)
    s1: Callable        # (tok (B, 1), c1, step) -> (h (B, d), c1', logits)
    s2: Callable        # (h (C, d), cache rows, step) -> (logits, rows')
    page_size: Optional[int] = None
    s2_paged: Optional[Callable] = None   # (h, bt, step (C,), pool)
                                          #   -> (logits, pool)
    pool_init: Optional[Callable] = None  # (rows template, n_pages) -> pool
    admit_pages: Optional[Callable] = None  # (pool, rows, bt) -> pool


def decode_stage_fns(params, cfg: ArchConfig, spec: ee.EarlyExitSpec,
                     page_size: Optional[int] = None) -> DecodeFns:
    """The decode callables over the full param tree on one device (the
    JAX package's degenerate placement). They run under ``no_grad`` rather
    than ``inference_mode``: the servers update their outputs in place."""

    @torch.no_grad()
    def pf(tokens, max_len: int):
        return T.prefill(params["backbone"], cfg, tokens, max_len=max_len)

    @torch.no_grad()
    def split(caches):
        c1, c2 = ee.split_caches(cfg, spec, caches)
        return c1, cache_rows_of(c2)

    @torch.no_grad()
    def s1(tok, c1, step):
        h, nc1, exit_logits = ee.stage1_decode(params, cfg, spec, tok, c1,
                                               step)
        return h[:, 0], nc1, exit_logits

    @torch.no_grad()
    def s2(h_rows, cache_rows, step):
        logits, nc = ee.stage2_decode(params, cfg, spec, h_rows[:, None],
                                      cache_of_rows(cache_rows), step)
        return logits, cache_rows_of(nc)

    if page_size is None:
        return DecodeFns(pf, split, s1, s2)
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")

    @torch.no_grad()
    def s2_paged(h_rows, bt, step, pool):
        logits, nc = ee.stage2_decode(params, cfg, spec, h_rows[:, None],
                                      _inject_bt(pool, bt), step)
        return logits, _strip_bt(nc)

    def pool_init(rows, n_pages: int):
        return paged_seg_pool(rows, page_size, n_pages)

    @torch.no_grad()
    def admit_pages(pool, rows, bt_rows):
        """Write k admitted rows' DENSE stage-2 caches into their pages, in
        place. rows: sample-major leaves (k, [n_sb,] L, *F); bt_rows: (k, M)
        int32. NULL (0) entries land in page 0 and carry the dense tail's
        zeros, so page 0 stays zero."""
        k, M = bt_rows.shape
        idx = bt_rows.reshape(-1).long()

        def rem_fn(d, r):
            for key in d:
                x = r[key]
                d[key][idx] = x.reshape((k * M, page_size)
                                        + tuple(x.shape[2:]))
            return d

        def blocks_fn(d, r):
            for key in d:
                x = r[key]
                n_sb = x.shape[1]
                d[key][:, idx] = x.movedim(0, 1).reshape(
                    (n_sb, k * M, page_size) + tuple(x.shape[3:]))
            return d

        return {"first": [],
                "blocks": tuple(None if d is None else blocks_fn(d, r)
                                for d, r in zip(pool["blocks"],
                                                rows["blocks"])),
                "rem": [rem_fn(d, r) for d, r in zip(pool["rem"],
                                                      rows["rem"])]}

    return DecodeFns(pf, split, s1, s2, page_size=page_size,
                     s2_paged=s2_paged, pool_init=pool_init,
                     admit_pages=admit_pages)


@torch.no_grad()
def decode_step0_confidences(params, cfg: ArchConfig,
                             spec: ee.EarlyExitSpec, prompt,
                             max_len: int) -> torch.Tensor:
    """Exit-head max-softmax confidences of the FIRST decode step (greedy
    token from the prefill logits): the calibration set for per-token
    thresholds. prompt: (B, S) int32 (numpy, or a tensor on the params'
    device); max_len sizes the cache pads."""
    if not torch.is_tensor(prompt):
        prompt = torch.as_tensor(np.asarray(prompt, np.int32),
                                 device=params["backbone"]["embed"]["table"]
                                 .device)
    logits, caches = T.prefill(params["backbone"], cfg, prompt,
                               max_len=max_len)
    c1, _ = ee.split_caches(cfg, spec, caches)
    _, _, exit_logits = ee.stage1_decode(params, cfg, spec,
                                         _greedy_tokens(logits), c1,
                                         prompt.shape[1])
    return ed.softmax_confidence(exit_logits)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


class DecodeServer(_RingedServer):
    """Device-resident, step-synchronous two-stage EE decode server.

    ``generate`` prefills the full-depth model, then decodes greedily with
    a per-token exit decision: each step runs stage 1 on the whole batch,
    the fused dispatch (exit-decision kernel, slot map, ring scatter-merge
    kernel) writes the hard tokens' hidden rows and stage-2 cache rows into
    the ring, and buckets of them run stage 2. Updated cache rows scatter
    back into the store in place; with a paged store the pools are updated
    in place by the paged append. The one host sync per step is the scalar
    ``n_hard``; merged logits go to the host lazily under ``max_pending``.
    """

    def __init__(self, fns: DecodeFns, sc: ServeConfig, device="cuda"):
        super().__init__(sc, device)
        self.fns = fns
        self._c1 = None          # stage-1 segment caches (run_layers layout)
        self._rows = None        # stage-2 cache store, sample-major rows
                                 # (paged: the (B, M) block-table lane)
        self._pool = None        # paged: the stage-2 page pools
        self._max_len = 0        # paged: the append sentinel
        self._ids = None         # arange(B) on the device
        self._pos = 0            # the step's position (drains need it)
        self._step_buckets: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def _drain(self) -> None:
        popped = self._pop_bucket()
        if popped is None:
            return
        bucket, bucket_ids = popped
        if self.fns.page_size is not None:
            # flush rows must not append: a flush slot holds a stale ring
            # row, and an easy row's stage-2 pages keep zeros at this step
            bt_safe, step_safe = _sanitize_paged_bucket(
                bucket["cache"], bucket_ids, self._pos, self._max_len)
            logits, self._pool = self.fns.s2_paged(bucket["h"], bt_safe,
                                                   step_safe, self._pool)
        else:
            logits, new_rows = self.fns.s2(bucket["h"], bucket["cache"],
                                           self._pos)
            _scatter_rows(self._rows, new_rows, bucket_ids)
        self._step_buckets.append((bucket_ids, logits))

    def _step(self, tok: torch.Tensor, pos: int):
        """One decode step for the whole batch; returns (merged (B, V)
        logits, next greedy tokens (B, 1)), both on the device. The token
        lane starts as the decision kernel's pred and hard rows are
        overwritten per bucket; the ring drains fully."""
        h_rows, self._c1, exit_logits = self.fns.s1(tok, self._c1, pos)
        self._pos = pos
        self._step_buckets = []
        _, pred, _, n_hard = self._fused_dispatch_enqueue(
            exit_logits, self._ids, {"h": h_rows, "cache": self._rows})
        self.stats.record_decisions(h_rows.shape[0], n_hard)
        while self._count > 0:               # full buckets, then the partial
            self._drain()
        for bucket_ids, logits in self._step_buckets:
            _merge_bucket_logits(exit_logits, bucket_ids, logits)
            _merge_bucket_tokens(pred, bucket_ids, logits)
        return exit_logits, pred[:, None]

    def generate(self, prompt: np.ndarray, n_tokens: int) -> dict:
        """Greedy EE generation: prefill the (B, S) prompt, then emit
        ``n_tokens`` tokens (the first from the prefill logits, the rest
        from per-token two-stage decode). Returns {'tokens' (B, n_tokens),
        'logits' (B, n_tokens, V)} as numpy arrays."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        prompt = torch.as_tensor(np.asarray(prompt, np.int32),
                                 device=self.device)
        B, S = prompt.shape
        page = self.fns.page_size
        if page is not None and (S + n_tokens) % page != 0:
            raise ValueError(
                f"paged decode needs S + n_tokens divisible by "
                f"page_size={page}, got {S} + {n_tokens}")
        self.stats.n_samples += B
        self.ring.reset()                    # a fresh ring per stream shape
        self._ids = torch.arange(B, dtype=torch.int32, device=self.device)
        logits0, caches = self.fns.prefill(prompt, S + n_tokens)
        self._c1, rows = self.fns.split(caches)
        if page is not None:
            # an identity block table (row b owns pages [1 + b*M, 1 +
            # (b+1)*M)) over a pool sized for the batch: the dense store's
            # contents through the paged data path
            self._max_len = S + n_tokens
            M = self._max_len // page
            bt = 1 + torch.arange(B * M, dtype=torch.int32,
                                  device=self.device).reshape(B, M)
            self._pool = self.fns.admit_pages(
                self.fns.pool_init(rows, B * M + 1), rows, bt)
            self._rows = bt                  # the ring's cache payload lane
            self.stats.cache_pages_total = B * M
            self.stats.cache_pages_in_use = B * M
            self.stats.cache_page_size = page
            self.stats.live_tokens = B * (S + n_tokens - 1)
            self.stats.cache_hbm_bytes = _nbytes(self._pool)
        else:
            self._rows = rows
            self.stats.cache_hbm_bytes = _nbytes(self._rows)
        merged = logits0
        tok = _greedy_tokens(merged)         # t = 0: from the prefill logits
        logits_out: List = [None] * n_tokens
        toks_out: List[torch.Tensor] = []
        pending: List[Tuple[int, torch.Tensor]] = []
        for t in range(n_tokens):
            toks_out.append(tok)
            pending.append((t, merged))
            while len(pending) > self.sc.max_pending:
                slot, arr = pending.pop(0)
                logits_out[slot] = arr.cpu().numpy()
            if t == n_tokens - 1:
                break
            merged, tok = self._step(tok, S + t)
        for slot, arr in pending:
            logits_out[slot] = arr.cpu().numpy()
        tokens = torch.cat(toks_out, dim=1).cpu().numpy()
        return {"tokens": tokens, "logits": np.stack(logits_out, axis=1)}


class HostLoopDecoder:
    """Per-token host-loop decode: syncs the exit mask every step (the plain
    ``core.exit_decision.decision_and_argmax``, no kernel), walks the hard
    tokens in Python, stacks each bucket's hidden and cache rows sample by
    sample, and writes updated cache rows back one sample at a time. It
    shares the stage callables with ``DecodeServer``, so the merged logits
    agree bit for bit: the difference is the exit machinery alone."""

    def __init__(self, fns: DecodeFns, sc: ServeConfig, device="cuda"):
        self.fns = fns
        self.sc = sc
        self.device = resolve_device(device)
        self.stats = ServeStats()

    def generate(self, prompt: np.ndarray, n_tokens: int) -> dict:
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        prompt = torch.as_tensor(np.asarray(prompt, np.int32),
                                 device=self.device)
        B, S = prompt.shape
        self.stats.n_samples += B
        logits0, caches = self.fns.prefill(prompt, S + n_tokens)
        c1, rows = self.fns.split(caches)
        merged = logits0.cpu().numpy()
        logits_out, toks_out = [], []
        C = self.sc.capacity
        for t in range(n_tokens):
            tok = np.argmax(merged, axis=-1).astype(np.int32)[:, None]
            toks_out.append(tok)
            logits_out.append(merged)
            if t == n_tokens - 1:
                break
            pos = S + t
            h_rows, c1, exit_logits = self.fns.s1(
                torch.as_tensor(tok, device=self.device), c1, pos)
            exit_mask, _, _ = ed.decision_and_argmax(exit_logits,
                                                     self.sc.c_thr)
            exit_mask = exit_mask.cpu().numpy()      # per-step host sync
            merged = exit_logits.cpu().numpy().copy()
            hard = [i for i in range(B) if not exit_mask[i]]
            self.stats.record_decisions(B, len(hard))
            for lo in range(0, len(hard), C):
                chunk = hard[lo:lo + C]
                take = chunk + [chunk[0]] * (C - len(chunk))   # flush pad
                bucket_h = torch.stack([h_rows[i] for i in take])
                bucket_cache = pytree.tree_map(
                    lambda m: torch.stack([m[i] for i in take]), rows)
                logits, new_rows = self.fns.s2(bucket_h, bucket_cache, pos)
                lnp = logits.cpu().numpy()
                for j, sid in enumerate(chunk):
                    merged[sid] = lnp[j]
                    for m, r in zip(pytree.tree_leaves(rows),
                                    pytree.tree_leaves(new_rows)):
                        m[sid] = r[j]
                self.stats.n_stage2 += len(chunk)
                self.stats.record_bucket(len(chunk) / C)
        tokens = np.concatenate(toks_out, axis=1)
        return {"tokens": tokens, "logits": np.stack(logits_out, axis=1)}
