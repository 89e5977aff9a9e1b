"""The port's prefill server against the JAX package's, on the CPU.

The same tokens and threshold go through the JAX ``TwoStageServer`` and the
port's; thresholds sit off the decision margin, so both decide every row
the same way. Merged logits agree within fp32 tolerance (rtol 1e-5, atol
2e-5: the same arithmetic in another library); the counters (``n_exited``,
``n_stage2``, ``n_stalls``) and the ring's ids and cursors agree exactly.
Inside the port, the device server and the host loop agree bit for bit.
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import early_exit as jx_ee  # noqa: E402
from repro.core import exit_decision as jx_ed  # noqa: E402
from repro.runtime import scheduler as jx_sch  # noqa: E402
from repro.runtime import serve_loop as JSL  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import early_exit as ee  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.runtime import scheduler as sch  # noqa: E402
from repro_torch.runtime import serve_api  # noqa: E402
from repro_torch.runtime import serve_loop as SL  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def setup(tiny_cfg, tiny_params):
    cfg = ArchConfig(**{f: getattr(tiny_cfg, f)
                        for f in tiny_cfg.__dataclass_fields__})
    params = params_from_numpy(jax.tree.map(np.asarray, tiny_params), "cpu")
    return tiny_cfg, cfg, tiny_params, params


def _off_margin_threshold(jcfg, jparams, toks, rate):
    """About ``rate`` of the rows exit; the threshold sits in the widest
    gap between neighbouring confidences near that quantile."""
    spec = jx_ee.EarlyExitSpec(exit_layer=2)
    _, _, logits, _ = jx_ee.stage1_prefill(jparams, jcfg, spec,
                                           jnp.asarray(toks))
    c = np.sort(np.asarray(jx_ed.softmax_confidence(logits), np.float64))
    k = min(max(int(round((1 - rate) * len(c))), 1), len(c) - 1)
    j = max(range(max(k - 3, 1), min(k + 3, len(c) - 1) + 1),
            key=lambda i: c[i] - c[i - 1])
    return float((c[j] + c[j - 1]) / 2)


# (n, batch, capacity, queue_depth, max_pending, rate): steady traffic; a
# ring one bucket deep under all-hard traffic (stalls); an all-hard batch
# twice the ring (the fused op's spill); a tiny pending backlog
_CASES = [(24, 8, 4, 4, 16, 0.5), (15, 3, 4, 1, 16, None),
          (16, 8, 2, 2, 16, None), (32, 4, 2, 4, 2, 0.5)]


@pytest.mark.parametrize("n,batch,cap,depth,pending,rate", _CASES)
def test_server_matches_jax_and_host_loop(setup, n, batch, cap, depth,
                                          pending, rate):
    jcfg, cfg, jparams, params = setup
    toks = np.random.default_rng(n * batch).integers(
        0, cfg.vocab, (n, 8), dtype=np.int32)
    # rate None: c_thr = 1.0, so c_thr * s < 1 never holds (s >= 1)
    c_thr = 1.0 if rate is None else _off_margin_threshold(jcfg, jparams,
                                                           toks, rate)
    jspec = jx_ee.EarlyExitSpec(exit_layer=2, c_thr=c_thr)
    spec = ee.EarlyExitSpec(exit_layer=2, c_thr=c_thr)
    jsc = JSL.ServeConfig(capacity=cap, queue_depth=depth, c_thr=c_thr,
                          max_pending=pending)
    sc = SL.ServeConfig(capacity=cap, queue_depth=depth, c_thr=c_thr,
                        max_pending=pending)
    jserver = JSL.TwoStageServer(*JSL._stage_fns(jparams, jcfg, jspec), jsc)
    want = JSL.serve_dataset(jserver, toks, batch=batch)
    server = serve_api.build(params, cfg, spec, sc, device="cpu")
    got = SL.serve_dataset(server, toks, batch=batch)
    host = serve_api.build(params, cfg, spec, sc, host=True, device="cpu")
    got_host = SL.serve_dataset(host, toks, batch=batch)

    assert set(got) == set(want) == set(got_host) == set(range(n))
    for sid in range(n):
        np.testing.assert_allclose(got[sid], want[sid], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got[sid], got_host[sid])
    js, ps, hs = jserver.stats, server.stats, host.stats
    for key in ("n_samples", "n_exited", "n_stage2", "n_stalls",
                "n_buckets", "ring_bytes_moved"):
        assert getattr(ps, key) == getattr(js, key), key
    assert ps.n_exited == hs.n_exited and ps.n_stage2 == hs.n_stage2
    assert ps.n_exited + ps.n_stage2 == n
    if rate is None:
        assert ps.n_stalls > 0
    assert not server._easy and not server._buckets


def test_results_harvested_before_flush(setup):
    """A backlog past max_pending is collected during submit."""
    _, cfg, _, params = setup
    spec = ee.EarlyExitSpec(exit_layer=2, c_thr=1.0)
    sc = SL.ServeConfig(capacity=2, queue_depth=4, c_thr=1.0, max_pending=2)
    server = serve_api.build(params, cfg, spec, sc, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (16, 8),
                                             dtype=np.int32)
    partial: dict = {}
    for lo in range(0, 16, 4):
        server.submit(toks[lo:lo + 4], np.arange(lo, lo + 4), partial)
        assert len(server._easy) + len(server._buckets) <= sc.max_pending
    assert partial
    server.flush(partial)
    assert set(partial) == set(range(16))


def test_serve_stats_keys_match_jax():
    assert set(sch.ServeStats().as_dict()) == \
        set(jx_sch.ServeStats().as_dict())
    assert sch.ServeStats.SCHEMA_VERSION == jx_sch.ServeStats.SCHEMA_VERSION


# ---------------------------------------------------------------------------
# the ring: the same enqueue / drain trace on both packages
# ---------------------------------------------------------------------------

def _ring_state(buf):
    leaves = jax.tree.leaves(buf["data"]) if isinstance(
        buf["ids"], jax.Array) else list(
            torch.utils._pytree.tree_leaves(buf["data"]))
    return ([np.asarray(x) for x in leaves], np.asarray(buf["ids"]),
            int(buf["head"]), int(buf["count"]))


def test_ring_trace_matches_jax():
    rng = np.random.default_rng(8)
    size, cap = 6, 3
    jbuf = jx_sch.ring_init(size, {"h": jax.ShapeDtypeStruct((2,),
                                                             jnp.float32),
                                   "n": jax.ShapeDtypeStruct((), jnp.int32)})
    buf = sch.ring_init(size, {"h": ((2,), torch.float32),
                               "n": ((), torch.int32)}, "cpu")
    next_id = 0
    for step in range(12):
        if step % 3 == 2:
            jbuf, jb, jids = jx_sch.ring_drain(jbuf, cap)
            buf, b, ids = sch.ring_drain(buf, cap)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
            np.testing.assert_array_equal(b["h"].numpy(),
                                          np.asarray(jb["h"]))
        else:
            k = int(rng.integers(0, 4))
            k = min(k, size - int(buf["count"]))
            h = rng.standard_normal((4, 2)).astype(np.float32)
            nn = rng.integers(0, 9, (4,), dtype=np.int32)
            ids = np.array([next_id + i if i < k else -1 for i in range(4)],
                           np.int32)
            next_id += k
            jbuf = jx_sch.ring_enqueue(jbuf, {"h": jnp.asarray(h),
                                              "n": jnp.asarray(nn)},
                                       jnp.asarray(ids))
            buf = sch.ring_enqueue(buf, {"h": torch.from_numpy(h),
                                         "n": torch.from_numpy(nn)},
                                   torch.from_numpy(ids))
        g, w = _ring_state(buf), _ring_state(jbuf)
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]
        for x, y in zip(sorted(g[0], key=lambda a: a.ndim),
                        sorted(w[0], key=lambda a: a.ndim)):
            np.testing.assert_array_equal(x, y)


def test_decide_compact_matches_jax(setup):
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((8, 4, 6)).astype(np.float32)
    logits = (rng.standard_normal((8, 20)) * 3).astype(np.float32)
    sids = (np.arange(8, dtype=np.int32) + 100)
    got = SL._decide_compact(torch.from_numpy(hidden),
                             torch.from_numpy(logits), torch.from_numpy(sids),
                             0.5)
    want = JSL._decide_compact(jnp.asarray(hidden), jnp.asarray(logits),
                               jnp.asarray(sids), 0.5, backend="ref")
    for i in (0, 1, 2, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# construction and the CLI
# ---------------------------------------------------------------------------

def test_build_rejects_what_is_not_ported(setup):
    _, cfg, _, params = setup
    spec = ee.EarlyExitSpec(exit_layer=2)
    sc = SL.ServeConfig(capacity=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_api.build(params, cfg, spec, sc, mode="decode", device="cpu")
    with pytest.raises(ValueError, match="scheduler"):
        serve_api.build(params, cfg, spec, sc, scheduler="sync",
                        device="cpu")
    assert isinstance(serve_api.build(params, cfg, spec, sc, host=True,
                                      device="cpu"), SL.HostLoopServer)


def test_cli_prefill_payload():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "12",
                             "--batch", "4", "--seq", "6"])
    assert rc == 0
    payload = json.loads(out.getvalue())
    stats = sch.ServeStats().as_dict()
    stats.pop("realized_q_series")
    assert set(stats) <= set(payload)
    assert payload["n_samples"] == 12 and payload["mode"] == "prefill"
    assert payload["throughput_samples_per_s"] > 0


@pytest.mark.parametrize("argv", [["--controller"], ["--mode", "decode"],
                                  ["--replicas", "2"],
                                  ["--page-size", "16"]])
def test_cli_rejects_unported_flags(argv):
    with pytest.raises(SystemExit, match="not ported"):
        serve_cli.main(["--smoke", "--device", "cpu"] + argv)
