"""Serving CLI: ``PYTHONPATH=src python -m repro_torch.launch.serve
--arch qwen2-1.5b [--smoke] [--device cuda]``.

The port of ``repro/launch/serve.py``, prefill mode: builds the two-stage
EE server (stage 2 bucketed at capacity = ceil((p + slack) * B), hard
samples carried between batches in the device ring) over weights drawn
from a seeded ``torch.Generator``, serves ``--requests`` random requests
of ``--seq`` tokens in batches of ``--batch``, and prints one JSON object:
``throughput_samples_per_s`` plus ``ServeStats.as_dict`` (the realized q
series summarized). The flags of the modes not ported yet are accepted
and rejected with a message naming the ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import early_exit as ee
from repro_torch.core.stage_mesh import stage2_capacity
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_arch, get_smoke, list_archs
from repro_torch.runtime import serve_api
from repro_torch.runtime import serve_loop as SL

# flags of the JAX CLI whose planes are not ported: flag -> (default,
# ROADMAP.md item)
_NOT_PORTED = {
    "mode": ("prefill", "Queue 1, items 8-10 (decode serving)"),
    "decode_tokens": (32, "Queue 1, items 8-10 (decode serving)"),
    "scheduler": ("sync", "Queue 1, item 9 (schedulers)"),
    "replicas": (1, "Queue 1, item 14 (fleet router)"),
    "routing_policy": ("drift_aware", "Queue 1, item 14 (fleet router)"),
    "tenant_slos": (None, "Queue 1, item 14 (fleet router)"),
    "page_size": (None, "Queue 1, item 10 (paged decode)"),
    "n_pages": (None, "Queue 1, item 10 (paged decode)"),
    "arrival_rate": (float("inf"), "Queue 1, item 9 (open-loop arrivals)"),
    "controller": (False, "Queue 1, item 14 (drift controller)"),
    "controller_band": (0.05, "Queue 1, item 14 (drift controller)"),
    "controller_cooldown": (8, "Queue 1, item 14 (drift controller)"),
    "controller_slo_p99": (None, "Queue 1, item 14 (drift controller)"),
    "controller_replan": (False, "Queue 1, item 14 (drift controller)"),
    "disaggregate": (False, "Queue 1, item 15 (stage placement)"),
    "chips1": (None, "Queue 1, item 15 (stage placement)"),
    "chips2": (None, "Queue 1, item 15 (stage placement)"),
    "metrics_port": (None, "Queue 1, item 14 (observability)"),
    "metrics_dump": (None, "Queue 1, item 14 (observability)"),
    "spans_out": (None, "Queue 1, item 14 (observability)"),
    "trace_out": (None, "Queue 1, item 14 (observability)"),
    "profile_dir": (None, "Queue 1, item 14 (observability)"),
    "profile_ticks": (64, "Queue 1, item 14 (observability)"),
}


def _summarized_stats(stats) -> dict:
    """ServeStats.as_dict with the per-dispatch realized_q series reduced
    to its mean and tail."""
    d = stats.as_dict()
    series = d.pop("realized_q_series")
    d["realized_q_series_mean"] = (float(np.mean(series)) if series
                                   else 0.0)
    d["realized_q_series_tail"] = series[-8:]
    return d


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64, help="request length")
    ap.add_argument("--p", type=float, default=0.25,
                    help="design-time hard probability (sizes stage 2)")
    ap.add_argument("--c-thr", type=float, default=0.9)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    ap.add_argument("--mode", default="prefill",
                    choices=("prefill", "decode"))
    for flag, (default, _) in _NOT_PORTED.items():
        if flag == "mode":
            continue
        name = "--" + flag.replace("_", "-")
        if isinstance(default, bool):
            ap.add_argument(name, action="store_true",
                            help="not ported yet (rejected)")
        else:
            ap.add_argument(name, type=type(default) if default is not None
                            else str, default=default,
                            help="not ported yet (rejected)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    for flag, (default, item) in _NOT_PORTED.items():
        if getattr(args, flag) != default:
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported to "
                             f"repro_torch yet (ROADMAP.md {item}); this "
                             f"CLI serves prefill only")

    dev = resolve_device(args.device)
    # the exit and final heads are fp32 matmuls: keep them out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    spec = ee.default_spec(cfg, c_thr=args.c_thr)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = ee.init_ee_params(cfg, spec, gen)
    cap = stage2_capacity(args.batch, args.p)
    sc = SL.ServeConfig(capacity=cap, c_thr=args.c_thr)
    server = serve_api.build(params, cfg, spec, sc, mode="prefill",
                             device=dev)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (args.requests, args.seq), dtype=np.int32)
    t0 = time.perf_counter()
    results = SL.serve_dataset(server, toks, batch=args.batch)
    dt = time.perf_counter() - t0        # flush copies results to the host
    if len(results) != args.requests:
        raise RuntimeError(f"{args.requests - len(results)} requests got "
                           f"no answer")
    payload = {"arch": args.arch, "mode": "prefill", "capacity": cap,
               "throughput_samples_per_s": args.requests / dt,
               **_summarized_stats(server.stats)}
    print(json.dumps(payload, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
