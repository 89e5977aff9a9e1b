#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each printing its result on its own line:

  1. device  -- the card (``nvidia-smi`` name and power limit), torch, CUDA;
  2. build   -- the kernel library from ``src/repro_torch/csrc`` (sm_90a);
  3. kernels -- each CUDA kernel against its plain PyTorch version at the
     serving path's shapes and on edge cases, then timed with CUDA events
     (L2 flushed before every launch) beside its plain version, one PyTorch
     library call doing the same main work, and its bound;
  4. serve   -- qwen2-1.5b at full published width (28 layers, d 1536,
     12/2 heads, d_ff 8960, vocab 151,936, bf16), exit after layer 14,
     weights from a seeded torch.Generator, threshold calibrated for
     p = 0.25: 256 requests of 64 tokens in batches of 32 through
     ``serve_api.build(mode="prefill")`` + ``serve_dataset``, then
     ``serve_batch`` on the first batch; every kernel must have launched in
     that window; the server is held against ``serve_batch`` and against
     ``HostLoopServer`` (which runs no kernel);
  3b. F1     -- the peak device memory of one full-width attention layer's
     single-device prefill (the plain blocked path) at B 8, S 2048 and S
     4096: it must grow with S, not S^2 (ratio <= 2.5);
  4a. mesh   -- the mesh prefill cell (``launch/steps.make_prefill_cell``)
     on two ranks sharing the card (``gloo``, mesh data 1 x model 2), each
     holding the same full-width qwen2-1.5b: B 32 x S 512 (attention split
     by batch) and B 1 x S 4096 (split by query rows, rank 1 at offset
     2048); the flash-attention kernel must have launched once per
     attention layer of both stages on each rank (the bf16 tensor-core
     kernel in the bf16 cells, the fp32 one in the fp32 cells); in bf16
     both ranks must equal the single device with the kernel run unsplit
     bit for bit, and
     the same cells in fp32 the single-device ``serve_batch`` (plain
     blocked attention) within 1e-3;
  5. decode  -- the same model and weights, threshold calibrated on the
     first decode step's confidences for p = 0.25: 64 requests of 64-token
     prompts, 64 tokens each, in static batches of 32 through
     ``serve_api.build(mode="decode", scheduler="sync")``, first with the
     dense stage-2 cache, then paged (16-token pages); the exit-decision,
     ring scatter-merge and paged append + gather kernels must each have
     launched in that window; paged tokens equal dense ones, the paged
     ``DecodeServer``'s logits equal the dense one's bit for bit on the
     first batch, and a short run equals ``HostLoopDecoder`` bit for bit.

A line of per-kernel JSON and the ``nvidia-smi`` line come before the last
line, which is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line is printed. Without a card, or without the rest
of the repository beside it, the script exits non-zero at once.
"""
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
CONF_RTOL = 1e-5        # fp32 sum of exps, reduced in another order
MARGIN = 1e-4           # decisions compare exactly where |c_thr*s - 1| > 1e-4
LOGIT_ATOL = 5e-2       # bf16 stage-2 activations, GEMMs of other row counts
FP32_LOGIT_ATOL = 1e-3  # the fp32 mesh cells against the fp32 blocked path
N_REQUESTS, BATCH, SEQ, TARGET_P = 256, 32, 64, 0.25
DEC_REQUESTS, DEC_TOKENS, PAGE = 64, 64, 16    # decode: prompts of SEQ
# the flash kernel against its plain version, |got - want| <= rtol |want|
# + atol: both compute in fp32 and differ in the order of the sums; bf16
# adds one rounding of the output (one bf16 ulp is at most 2^-7 |want|)
FLASH_TOL = {"float32": (0.0, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}
MESH_CELLS = {"batch": (32, 512), "seq": (1, 4096)}   # (B, S) per cell
F1_BATCH, F1_SEQS, F1_MAX_RATIO = 8, (2048, 4096), 2.5
RANK_TIMEOUT_S = 600


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA GPU")
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, str(root / "src"))

    # -- 1. device -------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 heads stay fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"PHASE device: {torch.cuda.get_device_name(0)} | "
          f"capability {torch.cuda.get_device_capability(0)} | "
          f"torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} | nvidia-smi: {smi}")

    # -- 2. build ----------------------------------------------------------
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"PHASE build: {lib._name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)}; sources "
          f"{', '.join(p.name for p in _build._sources())})")

    # -- 3. kernels against their plain versions ---------------------------
    kernels = kernel_phase(torch, dev)

    # -- 3b. the memory of single-device prefill attention -----------------
    f1_phase(torch, dev)

    # -- 4a. the mesh prefill path ----------------------------------------
    params, cfg, init_s = build_model(torch, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"PHASE model: {cfg.name}: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}, exit after "
          f"layer {cfg.default_exit_layers()[0]}, {n_params / 1e9:.3f} B "
          f"params, init {init_s:.1f} s")
    mesh_phase(torch, dev, kernels, params, cfg)

    # -- 4. the prefill path ----------------------------------------------
    serve_phase(torch, dev, kernels, params, cfg)

    # -- 5. the decode path -----------------------------------------------
    decode_phase(torch, dev, kernels, params, cfg)

    print("KERNELS: " + "; ".join(
        f"{k['name']}: max_err {k['max_abs_err']:.3g}, launches "
        f"{k['launches']}, {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms "
        f"by {k['bound_by']}, plain {k['plain_ms']:.4f} ms, "
        f"{k['library_call']} {k['library_ms']:.4f} ms)"
        for k in kernels.values()))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn``, with CUDA events, after
    warm-up, with the 50 MB L2 cache overwritten before every call. A
    ~1 ms sleep kernel runs ahead of the start event, so the host-side
    work of the call (checks, allocations, the launch itself) overlaps it
    and the events bracket device time only, unless ``fn`` syncs."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decisions_agree(torch, got, want, c_thr, what: str) -> int:
    """Exact pred, conf within CONF_RTOL, exact decisions off the margin.
    Returns the number of rows inside the margin."""
    e, p, c = got
    we, wp, wc = want
    check(torch.equal(p, wp), f"{what}: pred differs")
    rel = ((c - wc).abs() / wc.abs()).max().item()
    check(rel <= CONF_RTOL, f"{what}: conf rel err {rel:.3g} > {CONF_RTOL}")
    s = 1.0 / wc.double()
    clear = (float(np.float32(c_thr)) * s - 1.0).abs() > MARGIN
    check(torch.equal(e[clear], we[clear]), f"{what}: exit differs")
    return int((~clear).sum())


def kernel_phase(torch, dev) -> dict:
    from repro_torch.kernels.exit_decision import (exit_decision_cuda,
                                                   exit_decision_ref)
    from repro_torch.kernels.fused_dispatch import (compact_src,
                                                    fused_dispatch_cuda,
                                                    fused_dispatch_ref,
                                                    scatter_merge_cuda,
                                                    scatter_merge_ref,
                                                    slot_src_map)
    from repro_torch.kernels.gather_compact import (gather_compact_cuda,
                                                    gather_compact_ref)
    g = torch.Generator(device=dev).manual_seed(1234)
    i32 = torch.int32
    out = {}

    # exit decision ---------------------------------------------------------
    V = 151936
    err, margin_rows = 0.0, 0
    cases = []
    for B, v, dt in ((32, V, torch.float32), (32, V, torch.bfloat16),
                     (5, 1000, torch.float16), (3, 4097, torch.float32)):
        x = (torch.randn(B, v, generator=g, device=dev) * 3).to(dt)
        cases.append((x, (0.5,)))
    tie = torch.randn(8, V, generator=g, device=dev)
    tie[:, 7] = tie[:, 140000] = tie.max(dim=1).values + 1   # chunks 0 / 34
    cases.append((tie, (0.5,)))
    main_x = torch.randn(32, V, generator=g, device=dev) * 3
    mid = float(exit_decision_ref(main_x, 0.5)[2].median())
    cases.append((main_x, (1e-9, 1.0, mid)))    # all exit, none, half
    for x, thrs in cases:
        for thr in thrs:
            got = exit_decision_cuda(x, thr)
            want = exit_decision_ref(x, thr)
            margin_rows += decisions_agree(torch, got, want, thr,
                                           f"exit_decision {tuple(x.shape)} "
                                           f"{x.dtype} c_thr={thr}")
            err = max(err, (got[2] - want[2]).abs().max().item())
    check(bool((exit_decision_cuda(tie, 0.5)[1] == 7).all()),
          "exit_decision: tie across chunks not resolved to the first")
    check(bool(exit_decision_cuda(main_x, 1e-9)[0].all()),
          "exit_decision: c_thr=1e-9 must exit every row")
    check(not bool(exit_decision_cuda(main_x, 1.0)[0].any()),
          "exit_decision: c_thr=1 must exit no row")
    ms = time_ms(torch, lambda: exit_decision_cuda(main_x, mid))
    b_ms, b_by = bound(main_x.numel() * 4 + 32 * 9, 4.0 * main_x.numel())
    out["exit_decision"] = {
        "name": "exit_decision", "route": "cuda",
        "source": "src/repro_torch/csrc/exit_decision.cu",
        "replaces": "src/repro/kernels/exit_decision/kernel.py:74",
        "launches": 0, "max_abs_err": err, "ms": ms,
        "plain_ms": time_ms(torch, lambda: exit_decision_ref(main_x, mid)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch,
                              lambda: torch.logsumexp(main_x, dim=-1)),
        "library_call": "torch.logsumexp(logits, -1)",
        "shape": [32, V], "dtype": "float32"}
    print(f"  exit_decision: match on {len(cases)} cases (rows inside the "
          f"{MARGIN:g} margin, left out of the decision compare: "
          f"{margin_rows}), max |conf err| {err:.3g}")

    # gather compact --------------------------------------------------------
    F = SEQ * 1536
    x_main = torch.randn(32, F, generator=g, device=dev).to(torch.bfloat16)
    m_main = torch.zeros(32, dtype=torch.bool, device=dev)
    m_main[torch.randperm(32, generator=g, device=dev)[:8]] = True
    gc_cases = [(x_main, m_main, 32), (x_main, m_main, 4),          # C < n
                (x_main, torch.ones_like(m_main), 32),
                (x_main, torch.zeros_like(m_main), 32),
                (torch.randint(0, 1 << 30, (32, 64), generator=g,
                               device=dev, dtype=i32), m_main, 16),
                (torch.randn(7, 33, generator=g, device=dev)
                 .to(torch.bfloat16), m_main[:7], 3)]              # 66 B rows
    for x, m, cap in gc_cases:
        got, want = gather_compact_cuda(x, m, cap), gather_compact_ref(x, m,
                                                                       cap)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"gather_compact {tuple(x.shape)} {x.dtype} C={cap} differs")
    n_hard = int(m_main.sum())
    take = gather_compact_ref(x_main, m_main, 32)[1].clamp(min=0).long()
    ms = time_ms(torch, lambda: gather_compact_cuda(x_main, m_main, 32))
    row = F * 2
    b_ms, b_by = bound((min(n_hard, 32) + 32) * row + 32 + 32 * 4 + 4, 32)
    out["gather_compact"] = {
        "name": "gather_compact", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_compact.cu",
        "replaces": "src/repro/kernels/gather_compact/kernel.py:55",
        "launches": 0, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": time_ms(torch,
                            lambda: gather_compact_ref(x_main, m_main, 32)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch,
                              lambda: torch.index_select(x_main, 0, take)),
        "library_call": "torch.index_select(x, 0, take)",
        "shape": [32, F], "dtype": "bfloat16", "n_hard": n_hard}
    print(f"  gather_compact: bitwise match on {len(gc_cases)} cases")

    # scatter merge ---------------------------------------------------------
    size = 4 * 16

    def src_map_for(mask, head, count, sz):
        src, nh = compact_src(mask)
        return slot_src_map(src, nh, torch.tensor(head, dtype=i32,
                                                  device=dev),
                            torch.tensor(count, dtype=i32, device=dev), sz)

    ring_main = torch.randn(size, F, generator=g, device=dev).to(
        torch.bfloat16)
    sm_cases = [(x_main, ring_main, m_main, 0, 0),
                (x_main, ring_main, m_main, 60, 0),           # wraparound
                (x_main, ring_main, torch.ones_like(m_main), 5, 50),
                (torch.arange(32, dtype=i32, device=dev)[:, None],
                 torch.full((size, 1), -1, dtype=i32, device=dev), m_main,
                 62, 3)]                                      # int32 ids lane
    for x, ring, m, head, count in sm_cases:
        smap, _ = src_map_for(m, head, count, ring.shape[0])
        got = scatter_merge_cuda(smap, x, ring.clone())
        want = scatter_merge_ref(smap, x, ring.clone())
        check(torch.equal(got, want),
              f"scatter_merge {tuple(x.shape)} head={head} count={count} "
              f"differs")
    # the whole fused dispatch (decision + slot map + per-leaf merges)
    logits = torch.randn(16, 64, generator=g, device=dev) * 3
    payload = {"h": torch.randn(16, 8, generator=g, device=dev),
               "n": torch.randint(0, 97, (16, 1), generator=g, device=dev,
                                  dtype=i32)}
    for head, count in ((0, 0), (20, 5), (7, 21), (3, 24)):
        rings = []
        for _ in range(2):
            rings.append({"data": {"h": torch.zeros(24, 8, device=dev),
                                   "n": torch.zeros(24, 1, dtype=i32,
                                                    device=dev)},
                          "ids": torch.full((24,), -1, dtype=i32, device=dev),
                          "head": torch.tensor(head, dtype=i32, device=dev),
                          "count": torch.tensor(count, dtype=i32,
                                                device=dev)})
        sids = torch.arange(16, dtype=i32, device=dev) * 3 + 1
        got = fused_dispatch_cuda(logits, None, sids, payload, rings[0], 0.6)
        want = fused_dispatch_ref(logits, None, sids, payload, rings[1], 0.6)
        inside = decisions_agree(torch, got[1:4], want[1:4], 0.6,
                                 "fused_dispatch")
        if inside == 0:
            for a, b in ((got[0]["data"]["h"], want[0]["data"]["h"]),
                         (got[0]["data"]["n"], want[0]["data"]["n"]),
                         (got[0]["ids"], want[0]["ids"]),
                         (got[0]["count"], want[0]["count"]),
                         (got[4], want[4]), (got[5], want[5])):
                check(torch.equal(a, b),
                      f"fused_dispatch ring head={head} count={count} "
                      f"differs")
    smap, n_enq = src_map_for(m_main, 0, 0, size)
    n_enq = int(n_enq)
    claimed = (smap >= 0).nonzero()[:, 0]
    rows = x_main[smap[claimed].long()]
    ms = time_ms(torch, lambda: scatter_merge_cuda(smap, x_main, ring_main))
    b_ms, b_by = bound(2 * n_enq * row + size * 4, 0)
    out["scatter_merge"] = {
        "name": "scatter_merge", "route": "cuda",
        "source": "src/repro_torch/csrc/scatter_merge.cu",
        "replaces": "src/repro/kernels/fused_dispatch/kernel.py:47",
        "launches": 0, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": time_ms(torch, lambda: scatter_merge_ref(smap, x_main,
                                                             ring_main)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lambda: ring_main.index_copy_(
            0, claimed, rows)),
        "library_call": "ring.index_copy_(0, slots, rows)",
        "shape": [size, F], "dtype": "bfloat16", "n_enq": n_enq}
    print(f"  scatter_merge: bitwise match on {len(sm_cases)} cases + the "
          f"fused dispatch on 4 ring states")
    out["paged_gather_append"] = paged_kernel_check(torch, dev, g)
    out["flash_attention"] = flash_kernel_check(torch, dev, g)
    print("PHASE kernels: " + "; ".join(
        f"{k['name']} max_err {k['max_abs_err']:.3g} ms {k['ms']:.4f} "
        f"(plain {k['plain_ms']:.4f}, library {k['library_ms']:.4f}, bound "
        f"{k['bound_ms']:.4f} by {k['bound_by']})" for k in out.values()))
    return out


def paged_kernel_check(torch, dev, g) -> dict:
    """The paged append + gather kernel against its plain version: the
    decode path's shapes (a bucket of C = 16 rows of a 32-row identity
    table, M = 8 pages of 16 rows, bf16 pools of 2 x 128 = 256 features:
    512-byte rows) and the edge cases, bit for bit; then timed."""
    from repro_torch.core.stage_mesh import stage2_capacity
    from repro_torch.kernels.paged_attention import (paged_gather_append_cuda,
                                                     paged_gather_append_ref)
    i32 = torch.int32
    C, M, F = stage2_capacity(BATCH, TARGET_P), (SEQ + DEC_TOKENS) // PAGE, 256
    P = BATCH * M + 1

    def pools(dt, width, n=P):
        ps = [torch.randn(n, PAGE, width, generator=g, device=dev).to(dt)
              for _ in range(2)]
        for p in ps:
            p[0] = 0
        return ps

    table = 1 + torch.arange(BATCH * M, dtype=i32, device=dev).reshape(
        BATCH, M)
    rows = torch.randperm(BATCH, generator=g, device=dev)[:C]
    main_bt = table[rows].contiguous()
    main_pos = torch.full((C,), SEQ + 5, dtype=i32, device=dev)
    main_pos[C - 3:] = M * PAGE            # three flush rows: the sentinel
    main_bt[C - 3:] = 0                    # ... with NULL tables
    a_main, b_main = pools(torch.bfloat16, F)
    new = [torch.randn(C, F, generator=g, device=dev).to(torch.bfloat16)
           for _ in range(2)]
    shared = main_bt.clone()
    shared[1, 0] = shared[0, 4]            # a page two rows read
    null_tail = main_bt.clone()
    null_tail[2, (SEQ + 5) // PAGE] = 0    # a NULL tail entry
    cases = [(a_main, b_main, new[0], new[1], main_bt, main_pos),
             (a_main, b_main, new[0], new[1], shared, main_pos),
             (a_main, b_main, new[0], new[1], null_tail, main_pos),
             (a_main, b_main, new[0], new[1], main_bt,
              torch.randint(0, M * PAGE, (C,), generator=g, device=dev,
                            dtype=i32))]
    fa, fb = pools(torch.float32, 16, 12)
    cases.append((fa, fb, torch.randn(3, 16, generator=g, device=dev),
                  torch.randn(3, 16, generator=g, device=dev),
                  torch.tensor([[1, 2, 0], [1, 3, 0], [4, 5, 6]], dtype=i32,
                               device=dev),
                  torch.tensor([5, 6, 40], dtype=i32, device=dev)))
    oa, ob = pools(torch.bfloat16, 7, 6)   # 14-byte rows: 1-byte words
    cases.append((oa, ob, torch.randn(2, 7, generator=g, device=dev).to(
        torch.bfloat16), torch.randn(2, 7, generator=g, device=dev).to(
        torch.bfloat16), torch.tensor([[1, 2], [3, 0]], dtype=i32,
                                      device=dev),
        torch.tensor([17, 4], dtype=i32, device=dev)))
    for a, b, an, bn, bt, pos in cases:
        got = paged_gather_append_cuda(a.clone(), b.clone(), an, bn, bt, pos)
        want = paged_gather_append_ref(a.clone(), b.clone(), an, bn, bt, pos)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"paged_gather_append {tuple(a.shape)} {a.dtype} B="
              f"{bt.shape[0]} differs")
        check(not got[2][0].any() and not got[3][0].any(),
              "paged_gather_append wrote into the NULL page")

    # time it at the main shapes, the pools reused (the appends rewrite the
    # same bytes at every call)
    args = (a_main, b_main, new[0], new[1], main_bt, main_pos)
    es = 2
    n_append = int(((main_pos < M * PAGE) & (main_bt.gather(
        1, (main_pos // PAGE).clamp(max=M - 1)[:, None].long())[:, 0] > 0)
                    ).sum())
    n_pages_read = int(torch.unique(main_bt).numel())  # flush rows: page 0
    nbytes = (2 * n_pages_read * PAGE * F * es   # distinct pages read, 2 pools
              + 2 * C * M * PAGE * F * es        # gathered slabs written
              + 2 * 2 * n_append * F * es        # appended rows: read + write
              + C * M * 4 + C * 4)               # table and positions
    b_ms, b_by = bound(nbytes, 0)
    take = main_bt.long()
    tail = main_bt.gather(1, (main_pos // PAGE).clamp(max=M - 1)[:, None]
                          .long())[:, 0]
    live = (main_pos < M * PAGE) & (tail > 0)
    idx = (tail[live].long(), (main_pos[live] % PAGE).long())
    new_live = (new[0][live], new[1][live])

    def library():
        a_main.index_put_(idx, new_live[0])
        b_main.index_put_(idx, new_live[1])
        return a_main[take], b_main[take]

    print(f"  paged_gather_append: bitwise match on {len(cases)} cases "
          f"(sentinel, NULL tail, shared page, fp32, 14-byte rows)")
    return {
        "name": "paged_gather_append", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_gather_append.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:55",
        "launches": 0, "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: paged_gather_append_cuda(*args)),
        "plain_ms": time_ms(torch, lambda: paged_gather_append_ref(*args)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, library),
        "library_call": "pool.index_put_((page, row), new) + pool[bt], "
                        "both pools",
        "shape": [C, M, PAGE, F], "dtype": "bfloat16", "pool_pages": P,
        "n_append": n_append, "n_pages_read": n_pages_read}


def flash_kernel_check(torch, dev, g) -> dict:
    """The flash-attention kernels against their plain version at the mesh
    prefill cell's shard shapes in bf16 (qwen2-1.5b: 12 query heads over 2
    kv heads of 128), a windowed case, a ragged Sq of 200, fp32 and the
    narrower head dims in both dtypes, and fully masked rows; the bf16
    kernel's registers, shared memory and occupancy; then the two shard
    shapes timed beside the plain version, SDPA with the same mask, and the
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import kernel_attrs
    H, KH, D = 12, 2, 128
    for d in (16, 32, 64, 128):
        a = kernel_attrs(d)
        print(f"  flash_fwd_mma D {d}: {a['regs']} registers a thread, "
              f"{a['dyn_smem']} B dynamic shared memory a block (static "
              f"{a['static_smem']} B), {a['spill_bytes']} B local a thread, "
              f"{a['threads']} threads, {a['blocks_per_sm']} resident "
              f"blocks an SM")
    B_b, S_b = MESH_CELLS["batch"]
    S_s = MESH_CELLS["seq"][1]

    def qkv(B, Sq, Sk, h, kh, d, dt):
        # the model's (B, S, heads, D) layout, handed over as strided views
        return [torch.randn(B, s, n, d, generator=g, device=dev).to(dt)
                .transpose(1, 2) for s, n in ((Sq, h), (Sk, kh), (Sk, kh))]

    main = {  # name: (B, Sq, Sk, q_offset)
        "batch": (B_b // 2, S_b, S_b, 0),              # one rank's shard
        "seq": (1, S_s // 2, S_s, S_s // 2)}           # rank 1's rows
    cases = [(name, B, Sq, Sk, off, None, H, KH, D, torch.bfloat16)
             for name, (B, Sq, Sk, off) in main.items()]
    cases += [("window", 2, 384, 384, 0, 128, H, KH, D, torch.bfloat16),
              ("ragged", 2, 200, 200, 0, None, H, KH, D, torch.bfloat16),
              ("fp32", 2, 256, 512, 256, None, 8, 2, 64, torch.float32),
              ("d32", 1, 130, 130, 0, 40, 4, 4, 32, torch.float32),
              ("d64bf16", 2, 300, 300, 0, 100, 12, 2, 64, torch.bfloat16),
              ("d32bf16", 1, 130, 390, 260, None, 8, 2, 32, torch.bfloat16),
              ("d16", 2, 70, 140, 70, None, 8, 1, 16, torch.bfloat16),
              ("masked", 1, 64, 128, 256, 32, 4, 2, 32, torch.float32)]
    err, timed = 0.0, {}
    for name, B, Sq, Sk, off, win, h, kh, d, dt in cases:
        q, k, v = qkv(B, Sq, Sk, h, kh, d, dt)
        got = flash_attention_cuda(q, k, v, off, causal=True, window=win)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, off, causal=True, window=win)
        diff = (got.float() - want.float()).abs()
        e = diff.max().item()
        rtol, atol = FLASH_TOL[str(dt).split(".")[-1]]
        over = (diff - rtol * want.float().abs() - atol).max().item()
        check(over <= 0, f"flash_attention {name} {(B, h, Sq, d)} vs "
                         f"{(B, kh, Sk, d)} off {off} window {win} {dt}: "
                         f"max err {e:.3g}, {over:.3g} past {rtol:g} "
                         f"|want| + {atol:g}")
        check(bool(torch.isfinite(got).all()), f"flash_attention {name}: "
                                               f"non-finite output")
        if name == "masked":
            check(not got.any(), "flash_attention: fully masked rows not 0")
        err = max(err, e)
        if name in main:
            timed[name] = (q, k, v, off, e)
    print(f"  flash_attention: match on {len(cases)} cases (each element "
          f"within rtol |want| + atol: bf16 {FLASH_TOL['bfloat16']}, fp32 "
          f"{FLASH_TOL['float32']}; max err {err:.3g})")

    rows = []
    for name, (q, k, v, off, e) in timed.items():
        B, _, Sq, _ = q.shape
        Sk = k.shape[2]
        qi = off + torch.arange(Sq, device=dev)[:, None]
        mask = qi >= torch.arange(Sk, device=dev)[None, :]
        pairs = int(mask.sum()) * B * H
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, o, k, v
        b_ms, b_by = bound(nbytes, 0)
        f_ms = 4.0 * D * pairs / BF16_FLOP_PER_S * 1e3
        if f_ms > b_ms:
            b_ms, b_by = f_ms, "operations"
        ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, off))
        plain = time_ms(torch, lambda: flash_attention_ref(q, k, v, off),
                        iters=5)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
        rows.append({"case": name, "q": list(q.shape), "kv": list(k.shape),
                     "q_offset": off, "ms": ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                     "pairs": pairs, "max_abs_err": e})
        print(f"  flash_attention {name}: q {tuple(q.shape)} kv "
              f"{tuple(k.shape)} offset {off}: {ms:.4f} ms (plain "
              f"{plain:.4f}, SDPA {lib:.4f}, bound {b_ms:.4f} by {b_by}: "
              f"{pairs} pairs x {4 * D} flops at 989 TFLOP/s bf16)")
    head = rows[[r["case"] for r in rows].index("seq")]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
            "launches": 0, "max_abs_err": err, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_call": "F.scaled_dot_product_attention(q, k, v, "
                            "attn_mask, enable_gqa=True)",
            "shape": head["q"], "dtype": "bfloat16", "cases": rows}


# ---------------------------------------------------------------------------
# phase 3b
# ---------------------------------------------------------------------------

def f1_phase(torch, dev) -> None:
    """Peak memory of one full-width attention layer's single-device
    prefill (``attention_fwd``: the plain blocked path) at two lengths."""
    from repro_torch.models import attention as attn
    from repro_torch.models.registry import get_arch
    cfg = get_arch("qwen2-1.5b")
    p = attn.init_attention(torch.Generator(device=dev).manual_seed(5), cfg)
    got = {}
    for S in F1_SEQS:
        x = torch.randn(F1_BATCH, S, cfg.d_model, device=dev,
                        dtype=cfg.act_dtype()) * 0.5
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, _ = attn.attention_fwd(p, cfg, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(out).all()), f"F1: non-finite at S {S}")
        got[S] = (peak, peak - resident, wall)
        del x, out
    (p2, w2, t2), (p4, w4, t4) = (got[s] for s in F1_SEQS)
    ratio = w4 / w2
    check(ratio <= F1_MAX_RATIO, f"F1: attention working set grew "
                                 f"{ratio:.2f}x from S {F1_SEQS[0]} to "
                                 f"{F1_SEQS[1]} (> {F1_MAX_RATIO})")
    print(f"PHASE F1: one qwen2-1.5b attention layer, prefill B {F1_BATCH}: "
          f"S {F1_SEQS[0]} peak {p2 / 2**20:.1f} MiB (working set "
          f"{w2 / 2**20:.1f} MiB, {t2 * 1e3:.1f} ms host clock), S "
          f"{F1_SEQS[1]} peak {p4 / 2**20:.1f} MiB (working set "
          f"{w4 / 2**20:.1f} MiB, {t4 * 1e3:.1f} ms); working-set ratio "
          f"{ratio:.3f} (limit {F1_MAX_RATIO}; peak ratio {p4 / p2:.3f})")


# ---------------------------------------------------------------------------
# phase 4a
# ---------------------------------------------------------------------------

def fp32_model(params, cfg):
    """The same weights in fp32, and the config that runs them in fp32."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(cast(v) for v in t)
        return t.float() if t is not None and t.is_floating_point() else t
    return cast(params), cfg.replace(dtype="float32", param_dtype="float32")


def mesh_rank(rank: int, world: int, out_dir: str, cells: dict,
              device: str) -> None:
    """One rank of the mesh phase, on ``device`` (cuda:0, beside the other
    rank): the same model from the same seed, a (data 1, model 2) mesh,
    each cell once to warm up and once counted, in bf16 and in fp32."""
    import torch
    from repro_torch.core import early_exit as ee
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import hints

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    params, cfg, _ = build_model(torch, dev)
    steps.assert_replicated(params)
    models = {"bfloat16": (params, cfg)}
    mesh = M.make_mesh((1, world), ("data", "model"))
    res = {}
    for (dt, name), (toks, c_thr) in cells.items():   # bf16 cells first
        if dt not in models:                # the fp32 copy after them, so
            models[dt] = fp32_model(params, cfg)   # bf16 peaks exclude it
        p, c = models[dt]
        spec = ee.EarlyExitSpec(exit_layer=c.default_exit_layers()[0],
                                c_thr=c_thr)
        B, S = toks.shape
        cell = steps.make_prefill_cell(c, mesh, seq_len=S, global_batch=B,
                                       p=TARGET_P, spec=spec)
        tok = torch.as_tensor(toks, device=dev)
        cell.step_fn(p, tok)                        # warm-up, off the count
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for key in flash_attention_cuda.launches:
            flash_attention_cuda.launches[key] = 0
        t0 = time.perf_counter()
        out = cell.step_fn(p, tok)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with hints.use_mesh(mesh):
            kinds = [hints.attn_split(S, B), hints.attn_split(
                S, cell.meta["capacity"])]
        res[dt, name] = {"by_kernel": dict(flash_attention_cuda.launches),
                         "ms": ms, "peak": torch.cuda.max_memory_allocated(),
                         "kinds": [None if k is None else k[0]
                                   for k in kinds],
                         "capacity": cell.meta["capacity"],
                         **{k: v.cpu().numpy() for k, v in out.items()}}
        del out
        if dt == "bfloat16":
            res[dt, name]["profile"] = rank_profile(
                torch, lambda: cell.step_fn(p, tok))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def rank_profile(torch, run) -> dict:
    """One more run of a rank's cell under torch.profiler: device time in
    all, in the flash kernel, and the host time of the all-gathers (gloo
    moves the shards through the host), beside the same run's host clock
    without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = flash = 0.0
    gathers = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total",
                        getattr(evt, "self_cuda_time_total", 0.0)) / 1e3
            device += t
            # flash_fwd_mma (bf16) and flash_fwd (fp32)
            flash += t if "flash_fwd" in evt.key else 0.0
        elif "gather" in evt.key.lower():
            gathers[evt.key] = (evt.count, evt.cpu_time_total / 1e3)
    return {"wall_ms": wall, "device_ms": device, "flash_ms": flash,
            "gathers": gathers}


def unsplit_kernel_core(q, k, v, *, causal, window, softcap,
                        use_kernel=False):
    """attention_core as one rank that holds every shard: the kernel on
    the whole (B, S) input at offset 0. The bf16 kernel computes every
    (position, head) row from its own q row over the same 64-key tiles in
    any block of 64 rows (a tile fully masked for a row leaves it exactly
    as it was), so the mesh's shards, gathered, must equal this bit for
    bit."""
    from repro_torch.kernels import dispatch
    o = dispatch.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), 0, causal=causal,
                                 window=window)
    return o.transpose(1, 2)


def mesh_phase(torch, dev, kernels: dict, params, cfg) -> None:
    """The mesh prefill cell on two ranks sharing the card, in bf16 (the
    serving dtype) and in fp32, each held against the single-device
    ``serve_batch`` (plain blocked attention) in the same dtype, and the
    bf16 run also against the single device with the kernel unsplit."""
    import tempfile
    from repro_torch.core import early_exit as ee
    from repro_torch.core import exit_decision as ed
    from repro_torch.core.stage_mesh import stage2_capacity
    from repro_torch.launch import mesh as M
    from repro_torch.models import attention

    models = {"bfloat16": (params, cfg), "float32": fp32_model(params, cfg)}
    cells, want = {}, {}
    for dt, (p, c) in models.items():
        spec0 = ee.default_spec(c)
        for i, (name, (B, S)) in enumerate(MESH_CELLS.items()):
            toks = np.random.default_rng(10 + i).integers(
                0, c.vocab, (B, S), dtype=np.int32)
            tok = torch.as_tensor(toks, device=dev)
            _, _, logits, _ = ee.stage1_prefill(p, c, spec0, tok)
            conf = ed.softmax_confidence(logits)
            # B 32: p = 0.25 of the rows to stage 2; B 1: the row to stage 2
            c_thr = (float(conf[0]) * 2 if B == 1 else
                     ed.calibrate_threshold(conf, 1.0 - TARGET_P))
            spec = ee.EarlyExitSpec(exit_layer=spec0.exit_layer, c_thr=c_thr)
            cap = stage2_capacity(B, TARGET_P)
            t0 = time.perf_counter()
            out = ee.serve_batch(p, c, spec, tok, capacity=cap)
            torch.cuda.synchronize()
            w = {k: v.cpu().numpy() for k, v in out.items()}
            w["ms"] = (time.perf_counter() - t0) * 1e3
            w["clear"] = ((float(np.float32(c_thr)) / conf.double() - 1.0)
                          .abs() > MARGIN).cpu().numpy()
            if dt == "bfloat16":
                # the kernel unsplit, the gate of the bf16 mesh run
                plain = attention.attention_core
                attention.attention_core = unsplit_kernel_core
                try:
                    w["unsplit"] = {k: v.cpu().numpy() for k, v in
                                    ee.serve_batch(p, c, spec, tok,
                                                   capacity=cap).items()}
                finally:
                    attention.attention_core = plain
            want[dt, name] = w
            cells[dt, name] = (toks, c_thr)
            del out, logits
    del models
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        t0 = time.perf_counter()
        M.run_ranks(mesh_rank, 2, backend="gloo",
                    args=(tmp, cells, str(dev)),
                    timeout_s=RANK_TIMEOUT_S, init_timeout_s=300,
                    rdzv_dir=tmp)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    n_attn = cfg.n_layers       # both stages: every attention layer
    total = 0
    for (dt, name), w in want.items():
        for r, res in enumerate(ranks):
            got = res[dt, name]
            what = f"mesh {dt} {name}: rank {r}"
            sym = "flash_fwd_mma" if dt == "bfloat16" else "flash_fwd"
            check(got["by_kernel"] == {k: n_attn if k == sym else 0
                                       for k in got["by_kernel"]},
                  f"{what} launched {got['by_kernel']}, not {sym} once per "
                  f"attention layer ({n_attn})")
            check(got["kinds"] == [name, name],
                  f"{what} split as {got['kinds']}")
            check(np.isfinite(got["logits"]).all(), f"{what}: non-finite")
            for key in ("logits", "exit_mask", "n_hard", "overflow"):
                check(np.array_equal(got[key], ranks[0][dt, name][key]),
                      f"{what} {key} differs from rank 0")
            clear = w["clear"]
            check(np.array_equal(got["exit_mask"][clear],
                                 w["exit_mask"][clear]),
                  f"{what} exit decisions differ from the single device "
                  f"off the {MARGIN:g} margin")
            if clear.all():
                check(int(got["n_hard"]) == int(w["n_hard"]),
                      f"{what} n_hard differs from the single device")
            agree = got["exit_mask"] == w["exit_mask"]
            got["max_d"] = float(np.abs(got["logits"][agree]
                                        - w["logits"][agree]).max())
            if dt == "float32":
                check(got["max_d"] <= FP32_LOGIT_ATOL,
                      f"{what} logits max |d| {got['max_d']:.3g} > "
                      f"{FP32_LOGIT_ATOL} from the single device")
            else:
                for key in ("logits", "exit_mask", "n_hard", "overflow"):
                    check(np.array_equal(got[key], w["unsplit"][key]),
                          f"{what} {key} differs from the single device "
                          f"with the kernel unsplit")
            total += sum(got["by_kernel"].values())
        B, S = MESH_CELLS[name]
        def gap(a, b):
            return float(np.abs(a["logits"] - b["logits"]).max())
        extra = (f" (limit {FP32_LOGIT_ATOL:g})" if dt == "float32" else
                 f"; equal bit for bit to the single device with the kernel "
                 f"unsplit. Single-device logits (std "
                 f"{float(w['logits'].std()):.3g}, max |logit| "
                 f"{float(np.abs(w['logits']).max()):.3g}): kernel unsplit "
                 f"vs blocked {gap(w['unsplit'], w):.3g}")
        for r, res in enumerate(ranks):
            prof = res[dt, name].get("profile")
            if prof:
                print(f"  mesh {dt} {name} rank {r} profile: "
                      f"{prof['wall_ms']:.1f} ms host clock, device "
                      f"{prof['device_ms']:.3f} ms (busy "
                      f"{100 * prof['device_ms'] / prof['wall_ms']:.1f}%), "
                      f"flash kernel {prof['flash_ms']:.3f} ms; host time "
                      f"of gathers (count, ms): {prof['gathers']}")
        print(f"  mesh {dt} {name}: B {B} x S {S}, stage-2 capacity "
              f"{ranks[0][dt, name]['capacity']}, n_hard "
              f"{int(w['n_hard'])}; single device (blocked attention) "
              f"{w['ms']:.1f} ms; "
              + "; ".join(f"rank {r}: split {res[dt, name]['kinds'][0]}, "
                          f"flash launches {res[dt, name]['by_kernel']}, "
                          f"{res[dt, name]['ms']:.1f} ms host clock, peak "
                          f"{res[dt, name]['peak'] / 2**30:.2f} GiB, max |d "
                          f"logits| vs blocked {res[dt, name]['max_d']:.3g}"
                          for r, res in enumerate(ranks)) + extra)
    kernels["flash_attention"]["launches"] = total
    kernels["flash_attention"]["launches_by_path"] = {"mesh_prefill": total}
    kernels["flash_attention"]["launches_by_kernel"] = {
        sym: sum(res[key]["by_kernel"][sym] for res in ranks for key in want)
        for sym in ("flash_fwd_mma", "flash_fwd")}
    print(f"PHASE mesh: ok; two gloo ranks on one card, mesh (data 1, model "
          f"2), {spawn_s:.1f} s with start-up; flash launches {total} "
          f"({n_attn} a rank a cell a dtype); rows inside the {MARGIN:g} "
          f"margin: {sum(int((~w['clear']).sum()) for w in want.values())}")


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def decode_phase(torch, dev, kernels: dict, params, cfg) -> None:
    from repro_torch.core import early_exit as ee
    from repro_torch.core import exit_decision as ed
    from repro_torch.core.stage_mesh import stage2_capacity
    from repro_torch.kernels.exit_decision import exit_decision_cuda
    from repro_torch.kernels.fused_dispatch import scatter_merge_cuda
    from repro_torch.kernels.paged_attention import paged_gather_append_cuda
    from repro_torch.runtime import serve_api
    from repro_torch.runtime import serve_loop as SL
    from repro_torch.runtime.scheduler import Request

    wrappers = {"exit_decision": exit_decision_cuda,
                "scatter_merge": scatter_merge_cuda,
                "paged_gather_append": paged_gather_append_cuda}
    spec0 = ee.default_spec(cfg)
    max_len = SEQ + DEC_TOKENS
    cal = np.random.default_rng(3).integers(0, cfg.vocab,
                                            (DEC_REQUESTS, SEQ),
                                            dtype=np.int32)
    conf = SL.decode_step0_confidences(params, cfg, spec0, cal, max_len)
    c_thr = ed.calibrate_threshold(conf, 1.0 - TARGET_P)
    spec = ee.EarlyExitSpec(exit_layer=spec0.exit_layer, c_thr=c_thr)
    cap = stage2_capacity(BATCH, TARGET_P)
    sc = SL.ServeConfig(capacity=cap, c_thr=c_thr)
    print(f"  decode: calibrated c_thr {c_thr!r} on the first decode step "
          f"of {DEC_REQUESTS} prompts for p {TARGET_P}; stage-2 capacity "
          f"{cap}, ring {sc.queue_depth * cap} rows, pages of {PAGE}")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab,
                                                (DEC_REQUESTS, SEQ),
                                                dtype=np.int32)

    def server(page_size, c=sc, s=spec):
        return serve_api.build(params, cfg, s, c, mode="decode",
                               page_size=page_size, device=dev)

    for page_size in (None, PAGE):               # warm-up, off the count
        server(page_size).generate(prompts[:BATCH], PAGE)
    torch.cuda.synchronize()

    def serve(page_size):
        sched = serve_api.build(params, cfg, spec, sc, mode="decode",
                                scheduler="sync", n_slots=BATCH,
                                page_size=page_size, device=dev)
        for i in range(DEC_REQUESTS):
            sched.submit(Request(sample_id=i, prompt=prompts[i],
                                 n_tokens=DEC_TOKENS))
        before = {k: w.launches for k, w in wrappers.items()}
        results = sched.run()                    # generate returns numpy
        makespan = sched.clock.now()
        return results, sched, makespan, {
            k: w.launches - before[k] for k, w in wrappers.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    runs = {name: serve(ps) for name, ps in (("dense", None),
                                             ("paged", PAGE))}
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the decode path")
        kernels[k]["launches"] += n
        kernels[k].setdefault("launches_by_path", {})["decode"] = n
    for name, (results, _, _, _) in runs.items():
        check(set(results) == set(range(DEC_REQUESTS)),
              f"decode {name}: {DEC_REQUESTS - len(results)} requests "
              f"unanswered")
        check(all(len(v) == DEC_TOKENS for v in results.values()),
              f"decode {name}: a request got the wrong number of tokens")
    check(runs["paged"][0] == runs["dense"][0],
          "decode: paged tokens differ from dense tokens")
    n_l2 = cfg.n_layers - spec.exit_layer
    st_p = runs["paged"][1].stats
    check(runs["paged"][3]["paged_gather_append"] == st_p.n_buckets * n_l2,
          "decode: paged kernel launches != buckets x stage-2 layers")

    # the paged DecodeServer against the dense one on the first batch
    first = prompts[:BATCH]
    out_d = server(None).generate(first, DEC_TOKENS)
    out_p = server(PAGE).generate(first, DEC_TOKENS)
    check(out_d["logits"].shape == (BATCH, DEC_TOKENS, cfg.vocab),
          "decode logits shape")
    check(bool(np.isfinite(out_d["logits"]).all()), "non-finite decode "
          "logits")
    check(np.array_equal(out_d["logits"], out_p["logits"]) and
          np.array_equal(out_d["tokens"], out_p["tokens"]),
          "decode: paged DecodeServer logits differ from dense on the first "
          "batch")
    del out_d, out_p

    # a short run against the host loop (plain decision, per-row Python),
    # at the calibrated threshold, and all-hard through a ring smaller than
    # the batch (stalls, the fused dispatch's spill)
    short = prompts[:8, :SEQ]
    for c, depth in ((c_thr, 4), (1.1, 1)):
        sc_s = SL.ServeConfig(capacity=4 if c > 1 else cap, queue_depth=depth,
                              c_thr=c)
        sp = ee.EarlyExitSpec(exit_layer=spec.exit_layer, c_thr=c)
        for ps in (None, PAGE):
            dev_out = server(ps, sc_s, sp).generate(short, PAGE)
            host_out = serve_api.build(params, cfg, sp, sc_s, mode="decode",
                                       host=True, device=dev).generate(
                                           short, PAGE)
            check(np.array_equal(dev_out["tokens"], host_out["tokens"]) and
                  np.array_equal(dev_out["logits"], host_out["logits"]),
                  f"decode: DecodeServer (page_size={ps}) differs from "
                  f"HostLoopDecoder at c_thr={c!r}")

    def window():
        server(PAGE).generate(first, PAGE)
        torch.cuda.synchronize()

    shares = kernel_shares(torch, window, kernels, wrappers)
    for name, (results, sched, makespan, counts) in runs.items():
        st = sched.stats
        n_tok = sum(len(v) for v in results.values())
        print(f"  decode {name}: {DEC_REQUESTS} requests x {DEC_TOKENS} "
              f"tokens (prompts of {SEQ}) in {makespan:.3f} s: goodput "
              f"{n_tok / makespan:.1f} tokens/s; realized q "
              f"{st.realized_q:.4f} ({st.n_stage2} of {st.n_decisions} "
              f"decisions to stage 2, {st.n_buckets} buckets, stalls "
              f"{st.n_stalls}); stage-2 cache {st.cache_hbm_bytes} bytes; "
              f"launches {counts}")
    print(f"  decode peak memory {peak / 2**30:.2f} GiB (both runs)")
    print(f"PHASE decode: ok; launches {launches}; kernel time share "
          f"{shares}")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def build_model(torch, dev):
    """qwen2-1.5b at full width, its weights from torch.Generator seed 0 on
    ``dev``: the same on every process that calls this on the card."""
    from repro_torch.core import early_exit as ee
    from repro_torch.models.registry import get_arch

    cfg = get_arch("qwen2-1.5b")
    spec0 = ee.default_spec(cfg)
    t0 = time.perf_counter()
    params = ee.init_ee_params(cfg, spec0,
                               torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    return params, cfg, time.perf_counter() - t0


def serve_phase(torch, dev, kernels: dict, params, cfg) -> None:
    from repro_torch.core import early_exit as ee
    from repro_torch.core import exit_decision as ed
    from repro_torch.core.stage_mesh import stage2_capacity
    from repro_torch.kernels.exit_decision import exit_decision_cuda
    from repro_torch.kernels.fused_dispatch import scatter_merge_cuda
    from repro_torch.kernels.gather_compact import gather_compact_cuda
    from repro_torch.runtime import serve_api
    from repro_torch.runtime import serve_loop as SL

    wrappers = {"exit_decision": exit_decision_cuda,
                "gather_compact": gather_compact_cuda,
                "scatter_merge": scatter_merge_cuda}
    spec0 = ee.default_spec(cfg)

    # calibrate C_thr on a profiling set so that p_hard ~ 0.25
    s1, _ = SL._stage_fns(params, cfg, spec0)
    prof = np.random.default_rng(1).integers(0, cfg.vocab, (N_REQUESTS, SEQ),
                                             dtype=np.int32)
    conf = torch.cat([ed.softmax_confidence(s1(torch.as_tensor(
        prof[lo:lo + BATCH], device=dev))[1])
        for lo in range(0, N_REQUESTS, BATCH)])
    c_thr = ed.calibrate_threshold(conf, 1.0 - TARGET_P)
    spec = ee.EarlyExitSpec(exit_layer=spec0.exit_layer, c_thr=c_thr)
    cap = stage2_capacity(BATCH, TARGET_P)
    sc = SL.ServeConfig(capacity=cap, c_thr=c_thr)
    print(f"  calibrated c_thr {c_thr!r} for p {TARGET_P}; stage-2 capacity "
          f"{cap}, ring {sc.queue_depth * cap} rows")

    toks = np.random.default_rng(2).integers(0, cfg.vocab,
                                             (N_REQUESTS, SEQ),
                                             dtype=np.int32)
    # warm-up (cuBLAS handles, allocator) on a server of its own
    SL.serve_dataset(serve_api.build(params, cfg, spec, sc, device=dev),
                     toks[:2 * BATCH], batch=BATCH)
    server = serve_api.build(params, cfg, spec, sc, mode="prefill",
                             device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    results = SL.serve_dataset(server, toks, batch=BATCH)   # flush syncs
    serve_s = time.perf_counter() - t0
    one = ee.serve_batch(params, cfg, spec,
                         torch.as_tensor(toks[:BATCH], device=dev),
                         capacity=BATCH)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
        kernels[k]["launches"] = n
        kernels[k]["launches_by_path"] = {"prefill": n}

    st = server.stats
    check(len(results) == N_REQUESTS and set(results) == set(range(
        N_REQUESTS)), f"{N_REQUESTS - len(results)} requests unanswered")
    check(st.n_exited + st.n_stage2 == N_REQUESTS,
          f"n_exited {st.n_exited} + n_stage2 {st.n_stage2} != "
          f"{N_REQUESTS}")
    stacked = np.stack([results[i] for i in range(N_REQUESTS)])
    check(stacked.shape == (N_REQUESTS, cfg.vocab), "logits shape")
    check(bool(np.isfinite(stacked).all()), "non-finite logits")

    # the server against the one-shot pipeline on the first batch
    merged = one["logits"].cpu().numpy()
    d_one = float(np.abs(stacked[:BATCH] - merged).max())
    check(d_one <= LOGIT_ATOL, f"server vs serve_batch max |d| {d_one:.3g}")

    # the server against the host loop (plain decision, no kernel) on the
    # whole set; rows inside the decision margin may take the other head
    host = serve_api.build(params, cfg, spec, sc, host=True, device=dev)
    host_res = SL.serve_dataset(host, toks, batch=BATCH)
    s1, _ = SL._stage_fns(params, cfg, spec)
    inside, d_host = 0, 0.0
    for lo in range(0, N_REQUESTS, BATCH):
        logits = s1(torch.as_tensor(toks[lo:lo + BATCH], device=dev))[1]
        e_kernel = exit_decision_cuda(logits, c_thr)[0]
        e_plain, _, conf_p = ed.decision_and_argmax(logits, c_thr)
        clear = ((float(np.float32(c_thr)) / conf_p.double() - 1.0).abs()
                 > MARGIN).cpu().numpy()
        agree = (e_kernel == e_plain).cpu().numpy()
        check(bool(agree[clear].all()),
              f"kernel and plain decisions differ off the margin at batch "
              f"{lo // BATCH}")
        inside += int((~clear).sum())
        for i in np.nonzero(agree)[0]:
            d_host = max(d_host, float(np.abs(results[lo + i]
                                              - host_res[lo + i]).max()))
    check(d_host <= LOGIT_ATOL, f"server vs host loop max |d| {d_host:.3g}")

    def window():
        srv = serve_api.build(params, cfg, spec, sc, device=dev)
        SL.serve_dataset(srv, toks[:2 * BATCH], batch=BATCH)
        ee.serve_batch(params, cfg, spec, torch.as_tensor(
            toks[:BATCH], device=dev), capacity=BATCH)
        torch.cuda.synchronize()

    shares = kernel_shares(torch, window, kernels, wrappers)
    print(f"  served {N_REQUESTS} requests x {SEQ} tokens in {serve_s:.3f} "
          f"s: {N_REQUESTS / serve_s:.1f} samples/s; realized q "
          f"{st.realized_q:.4f}; exited {st.n_exited}, stage 2 "
          f"{st.n_stage2}, stalls {st.n_stalls}, buckets {st.n_buckets}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"  server vs serve_batch (first batch) max |d logits| {d_one:.3g};"
          f" vs HostLoopServer max |d| {d_host:.3g} (tolerance "
          f"{LOGIT_ATOL:g}); rows inside the {MARGIN:g} decision margin: "
          f"{inside}")
    print(f"PHASE serve: ok; launches {launches}; kernel time share "
          f"{shares}")


KERNEL_NAMES = {"exit_decision": ("exit_decision_partial",
                                  "exit_decision_combine"),
                "gather_compact": ("gather_compact_partition",
                                   "gather_rows"),
                "scatter_merge": ("scatter_merge_rows",),
                "paged_gather_append": ("paged_append", "paged_gather"),
                "flash_attention": ("flash_fwd",)}   # and flash_fwd_mma


def kernel_shares(torch, window, kernels, wrappers) -> str:
    """Per-kernel share of device time over one torch.profiler window of
    ``window()`` (which ends in a synchronize), beside the same window's
    host-clock time without the profiler: the device busy share. CUDA
    events and the phase-3 kernel times when the profiler reports no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {k: KERNEL_NAMES[k] for k in wrappers}
    t0 = time.perf_counter()
    window()                                       # host clock, no profiler
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
    per, total, top = {k: 0.0 for k in names}, 0.0, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:     # host ops: no double count
            continue
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0))
        total += t
        top.append((t, evt.count, evt.key))
        for k, pats in names.items():
            if any(p in evt.key for p in pats):
                per[k] += t
    for t, n, key in sorted(top, reverse=True)[:12]:
        print(f"  profiler: {t / 1e3:9.3f} ms {n:6d}x {key[:90]}")
    if total > 0:
        return ", ".join(f"{k} {100 * v / total:.3f}% ({v / 1e3:.4f} ms)"
                         for k, v in per.items()) + \
            (f" of {total / 1e3:.3f} ms device time (torch.profiler); the "
             f"window takes {wall_ms:.3f} ms on the host clock without the "
             f"profiler: device busy {100 * total / 1e3 / wall_ms:.1f}%")
    before = {k: w.launches for k, w in wrappers.items()}
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    window()
    b.record()
    torch.cuda.synchronize()
    wall = a.elapsed_time(b)
    est = {k: kernels[k]["ms"] * (w.launches - before[k])
           for k, w in wrappers.items()}
    return ("profiler showed no device time; CUDA events, phase-3 times x "
            "launches: " + ", ".join(f"{k} ~{100 * v / wall:.3f}%"
                                     for k, v in est.items())
            + f" of {wall:.2f} ms")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


if __name__ == "__main__":
    main()
