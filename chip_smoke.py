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
     ``HostLoopServer`` (which runs no kernel).

A line of per-kernel JSON and the ``nvidia-smi`` line come before the last
line, which is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line is printed. Without a card, or without the rest
of the repository beside it, the script exits non-zero at once.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
CONF_RTOL = 1e-5        # fp32 sum of exps, reduced in another order
MARGIN = 1e-4           # decisions compare exactly where |c_thr*s - 1| > 1e-4
LOGIT_ATOL = 5e-2       # bf16 stage-2 activations, GEMMs of other row counts
N_REQUESTS, BATCH, SEQ, TARGET_P = 256, 32, 64, 0.25


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

    # -- 4. the main path --------------------------------------------------
    serve_phase(torch, dev, kernels)

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
    print("PHASE kernels: " + "; ".join(
        f"{k['name']} max_err {k['max_abs_err']:.3g} ms {k['ms']:.4f} "
        f"(plain {k['plain_ms']:.4f}, library {k['library_ms']:.4f}, bound "
        f"{k['bound_ms']:.4f} by {k['bound_by']})" for k in out.values()))
    return out


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def serve_phase(torch, dev, kernels: dict) -> None:
    from repro_torch.core import early_exit as ee
    from repro_torch.core import exit_decision as ed
    from repro_torch.core.stage_mesh import stage2_capacity
    from repro_torch.kernels.exit_decision import exit_decision_cuda
    from repro_torch.kernels.fused_dispatch import scatter_merge_cuda
    from repro_torch.kernels.gather_compact import gather_compact_cuda
    from repro_torch.models.registry import get_arch
    from repro_torch.runtime import serve_api
    from repro_torch.runtime import serve_loop as SL

    wrappers = {"exit_decision": exit_decision_cuda,
                "gather_compact": gather_compact_cuda,
                "scatter_merge": scatter_merge_cuda}
    cfg = get_arch("qwen2-1.5b")
    spec0 = ee.default_spec(cfg)
    t0 = time.perf_counter()
    params = ee.init_ee_params(cfg, spec0,
                               torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  model {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.param_dtype}, exit after layer "
          f"{spec0.exit_layer}, {n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.1f} s")

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

    shares = kernel_shares(torch, params, cfg, spec, sc, toks, dev, kernels,
                           wrappers)
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


def kernel_shares(torch, params, cfg, spec, sc, toks, dev, kernels,
                  wrappers) -> str:
    """Per-kernel share of device time over one torch.profiler window (a
    fresh server over two batches, then serve_batch on one); CUDA events
    and the phase-3 kernel times when the profiler reports no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import early_exit as ee
    from repro_torch.runtime import serve_api
    from repro_torch.runtime import serve_loop as SL

    def window():
        srv = serve_api.build(params, cfg, spec, sc, device=dev)
        SL.serve_dataset(srv, toks[:2 * BATCH], batch=BATCH)
        ee.serve_batch(params, cfg, spec, torch.as_tensor(
            toks[:BATCH], device=dev), capacity=BATCH)
        torch.cuda.synchronize()

    names = {"exit_decision": ("exit_decision_partial",
                               "exit_decision_combine"),
             "gather_compact": ("gather_compact_partition", "gather_rows"),
             "scatter_merge": ("scatter_merge_rows",)}
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
