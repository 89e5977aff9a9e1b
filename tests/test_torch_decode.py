"""The port's decode path against the JAX package, on the CPU.

Bottom up: ``prefill`` + ``decode_step`` and the early-exit decode stages
(``stage1_decode``, ``stage2_decode``, ``split_caches``) on ``tiny_cfg``
and ``smoke_config(qwen2-1.5b)``, with the JAX params carried across by
``repro_torch.bridge``; then, inside the port, ``DecodeServer`` against
``HostLoopDecoder`` bit for bit (the contracts of
``tests/test_serve_decode.py``); the port's ``DecodeServer`` and
``SyncScheduler`` against the JAX package's at calibrated thresholds; the
admission surface (``validate_request``, ``RequestQueue``,
``poisson_arrivals``); and the decode CLI.

Tolerances: both configs run in fp32. One step: rtol 1e-5, atol 2e-5 (the
same arithmetic reduced in another order by another library); eight
steps deep: rtol/atol 1e-4 (the caches carry the difference forward).
Integers, counts and bookkeeping match exactly. Token streams of the two
packages are compared on each row up to its first near tie: a step whose
exit decision sits within 1e-4 of the threshold (|c_thr * s - 1| <= 1e-4)
or whose top-2 logit gap is <= 1e-4; at least 80% of the row-steps must be
compared. Inside the port, device server and host loop agree bit for bit.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JX_ARCHS  # noqa: E402
from repro.configs.archs import smoke_config as jx_smoke  # noqa: E402
from repro.core import early_exit as jx_ee  # noqa: E402
from repro.launch import serve as jx_cli  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import scheduler as jx_sch  # noqa: E402
from repro.runtime import serve_api as jx_api  # noqa: E402
from repro.runtime import serve_loop as JSL  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import early_exit as ee  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.runtime import scheduler as sch  # noqa: E402
from repro_torch.runtime import serve_api  # noqa: E402
from repro_torch.runtime import serve_loop as SL  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5
DEEP_TOL = 1e-4
NEAR = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


@pytest.fixture(scope="module", params=["tiny", "qwen2-smoke"])
def model(request, tiny_cfg):
    """(jax cfg, port cfg, jax spec, port spec, jax params, port params)."""
    jcfg = tiny_cfg if request.param == "tiny" else jx_smoke(
        JX_ARCHS["qwen2-1.5b"])
    jspec = jx_ee.default_spec(jcfg)
    jparams = jx_ee.init_ee_params(jax.random.PRNGKey(0), jcfg, jspec)
    spec = ee.EarlyExitSpec(exit_layer=jspec.exit_layer, c_thr=jspec.c_thr)
    return (jcfg, _port_cfg(jcfg), jspec, spec, jparams,
            params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.fixture(scope="module")
def tiny(tiny_cfg, tiny_params, tiny_spec):
    """(jax cfg, port cfg, jax params, port params); the exit at layer 2."""
    params = params_from_numpy(jax.tree.map(np.asarray, tiny_params), "cpu")
    return tiny_cfg, _port_cfg(tiny_cfg), tiny_params, params


@pytest.fixture(scope="module")
def prompt(tiny_cfg):
    return np.random.default_rng(21).integers(0, tiny_cfg.vocab, (6, 8),
                                              dtype=np.int32)


def _specs(c_thr):
    return (jx_ee.EarlyExitSpec(exit_layer=2, c_thr=c_thr),
            ee.EarlyExitSpec(exit_layer=2, c_thr=c_thr))


def _top2_gap(logits: np.ndarray) -> np.ndarray:
    part = np.sort(logits, axis=-1)
    return part[..., -1] - part[..., -2]


# ---------------------------------------------------------------------------
# the model: prefill + decode steps, and the early-exit decode stages
# ---------------------------------------------------------------------------

def test_decode_steps_match_jax(model):
    """Prefill and 8 greedy decode steps, the JAX package's tokens fed to
    both: logits allclose at every step, and the port's greedy token equal
    to JAX's wherever the top-2 gap clears the tolerance."""
    jcfg, cfg, _, _, jparams, params = model
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 6),
                                             dtype=np.int32)
    max_len = 6 + 8
    jlog, jc, _ = JT.prefill(jparams["backbone"], jcfg, jnp.asarray(toks),
                             max_len=max_len)
    log, c = T.prefill(params["backbone"], cfg, _t(toks), max_len=max_len)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    compared = 0
    for t in range(8):
        jl = np.asarray(jlog)
        clear = _top2_gap(jl) > 2 * DEEP_TOL
        np.testing.assert_array_equal(log.numpy().argmax(-1)[clear],
                                      jl.argmax(-1)[clear])
        compared += int(clear.sum())
        tok = jl.argmax(-1).astype(np.int32)[:, None]
        jlog, jc = JT.decode_step(jparams["backbone"], jcfg,
                                  jnp.asarray(tok), jc, jnp.int32(6 + t))
        log, c = T.decode_step(params["backbone"], cfg, _t(tok), c, 6 + t)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   rtol=DEEP_TOL, atol=DEEP_TOL)
    assert compared >= 0.8 * 3 * 8
    for key in ("k", "v"):
        np.testing.assert_allclose(c["blocks"][0][key].numpy(),
                                   np.asarray(jc["blocks"][0][key]),
                                   rtol=DEEP_TOL, atol=DEEP_TOL)


def test_init_cache_matches_jax(model):
    jcfg, cfg, _, _, _, _ = model
    want = JT.init_cache(jcfg, 3, 10)
    got = T.init_cache(cfg, 3, 10, "cpu")
    for key in ("k", "v"):
        assert tuple(got["blocks"][0][key].shape) == \
            want["blocks"][0][key].shape
        assert not got["blocks"][0][key].any()
    assert got["first"] == [] and got["rem"] == []


def test_decode_stages_match_jax(model):
    """split_caches, stage1_decode and stage2_decode on a prefilled cache,
    the stage-2 slab a compacted subset of the rows."""
    jcfg, cfg, jspec, spec, jparams, params = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (4, 6),
                                             dtype=np.int32)
    _, jc, _ = JT.prefill(jparams["backbone"], jcfg, jnp.asarray(toks),
                          max_len=8)
    _, c = T.prefill(params["backbone"], cfg, _t(toks), max_len=8)
    jc1, jc2 = jx_ee.split_caches(jcfg, jspec, jc)
    c1, c2 = ee.split_caches(cfg, spec, c)
    n1 = jspec.exit_layer // jcfg.pattern_len
    assert c1["blocks"][0]["k"].shape[0] == n1
    assert c2["blocks"][0]["k"].shape[0] == jcfg.n_superblocks - n1
    tok = np.array([[1], [7], [3], [0]], np.int32)
    jh, jn1, jlog = jx_ee.stage1_decode(jparams, jcfg, jspec,
                                        jnp.asarray(tok), jc1, jnp.int32(6))
    h, n1c, log = ee.stage1_decode(params, cfg, spec, _t(tok), c1, 6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(n1c["blocks"][0]["k"].numpy(),
                               np.asarray(jn1["blocks"][0]["k"]), rtol=RTOL,
                               atol=ATOL)
    take = np.array([2, 0])                        # a two-row hard slab
    jseg = jax.tree.map(lambda x: x[:, take], jc2)
    seg = {"first": [], "rem": [],
           "blocks": tuple({k: v[:, take] for k, v in b.items()}
                           for b in c2["blocks"])}
    jfin, jn2 = jx_ee.stage2_decode(jparams, jcfg, jspec, jh[take], jseg,
                                    jnp.int32(6))
    fin, n2c = ee.stage2_decode(params, cfg, spec, h[take], seg, 6)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(n2c["blocks"][0]["v"].numpy(),
                               np.asarray(jn2["blocks"][0]["v"]), rtol=RTOL,
                               atol=ATOL)


def test_step0_confidences_match_jax(tiny, prompt):
    jcfg, cfg, jparams, params = tiny
    jspec, spec = _specs(0.5)
    want = JSL.decode_step0_confidences(jparams, jcfg, jspec, prompt, 12)
    got = SL.decode_step0_confidences(params, cfg, spec, prompt, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


# ---------------------------------------------------------------------------
# inside the port: DecodeServer == HostLoopDecoder, bit for bit
# ---------------------------------------------------------------------------

def _port_pair(params, cfg, spec, sc, prompt, n_tokens):
    fns = SL.decode_stage_fns(params, cfg, spec)
    dev = SL.DecodeServer(fns, sc, device="cpu")
    host = SL.HostLoopDecoder(fns, sc, device="cpu")
    return (dev.generate(prompt, n_tokens), dev,
            host.generate(prompt, n_tokens), host)


def _median_step0(params, cfg, spec, prompt):
    conf = SL.decode_step0_confidences(params, cfg, spec, prompt,
                                       prompt.shape[1] + 2)
    return float(np.median(conf.numpy()))


@pytest.mark.parametrize("c_thr", [0.0, 1.1, None],
                         ids=["all_exit", "all_hard", "median"])
def test_decode_server_equals_host_loop(tiny, prompt, c_thr):
    _, cfg, _, params = tiny
    if c_thr is None:
        c_thr = _median_step0(params, cfg, _specs(0.5)[1], prompt)
    spec = _specs(c_thr)[1]
    sc = SL.ServeConfig(capacity=3, queue_depth=2, c_thr=c_thr)
    od, dev, oh, host = _port_pair(params, cfg, spec, sc, prompt, 6)
    np.testing.assert_array_equal(od["tokens"], oh["tokens"])
    np.testing.assert_array_equal(od["logits"], oh["logits"])
    for key in ("n_decisions", "n_exited", "n_stage2", "n_buckets"):
        assert getattr(dev.stats, key) == getattr(host.stats, key), key


def test_decode_stats_per_token(tiny, prompt):
    """Decisions count per token: B samples x (n_tokens - 1) steps."""
    _, cfg, _, params = tiny
    sc = SL.ServeConfig(capacity=3, queue_depth=2, c_thr=1.1)
    _, dev, _, host = _port_pair(params, cfg, _specs(1.1)[1], sc, prompt, 5)
    B = prompt.shape[0]
    for st in (dev.stats, host.stats):
        assert st.n_samples == B
        assert st.n_decisions == st.n_stage2 == B * 4
        assert st.n_exited == 0 and st.realized_q == 1.0
        assert st.as_dict()["decisions_per_sample"] == 4


def test_decode_ring_backpressure(tiny, prompt):
    """All-hard traffic through a ring smaller than the batch: the enqueue
    stalls (full buckets drain first), never drops, and stays bitwise equal
    to the host loop."""
    _, cfg, _, params = tiny
    sc = SL.ServeConfig(capacity=2, queue_depth=2, c_thr=1.1)
    assert sc.queue_depth * sc.capacity < prompt.shape[0]
    od, dev, oh, _ = _port_pair(params, cfg, _specs(1.1)[1], sc, prompt, 4)
    assert dev.stats.n_stalls > 0
    np.testing.assert_array_equal(od["tokens"], oh["tokens"])
    np.testing.assert_array_equal(od["logits"], oh["logits"])


def test_decode_all_hard_matches_unstaged_decode(tiny, prompt):
    """With nothing exiting, staged decode reproduces the plain full-depth
    decode loop."""
    _, cfg, _, params = tiny
    spec = _specs(1.1)[1]
    sc = SL.ServeConfig(capacity=prompt.shape[0], queue_depth=2, c_thr=1.1)
    out = serve_api.build(params, cfg, spec, sc, mode="decode",
                          device="cpu").generate(prompt, 4)
    bb = params["backbone"]
    S = prompt.shape[1]
    logits, caches = T.prefill(bb, cfg, _t(prompt), max_len=S + 4)
    want = [logits.argmax(-1).int().numpy()]
    for t in range(1, 4):
        logits, caches = T.decode_step(bb, cfg, _t(want[-1][:, None]),
                                       caches, S + t - 1)
        want.append(logits.argmax(-1).int().numpy())
        np.testing.assert_allclose(out["logits"][:, t], logits.numpy(),
                                   rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(out["tokens"], np.stack(want, 1))


@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_decode_exit_gap_cache_semantics(tiny, prompt, page_size):
    """Tokens that exit early leave zeros at their positions of the
    stage-2 cache, dense and paged alike."""
    _, cfg, _, params = tiny
    sc = SL.ServeConfig(capacity=3, queue_depth=2, c_thr=0.0)
    dev = serve_api.build(params, cfg, _specs(0.0)[1], sc, mode="decode",
                          page_size=page_size, device="cpu")
    S = prompt.shape[1]
    dev.generate(prompt, 4)
    if page_size is None:
        stores = [dev._rows["blocks"][0][k] for k in ("k", "v")]
    else:                        # gather every row's pages: the dense rows
        bt = dev._rows.long()
        stores = [p[:, bt].reshape((p.shape[0],) + tuple(bt.shape[:1])
                                   + (-1,) + tuple(p.shape[3:]))
                  .movedim(1, 0) for p in (dev._pool["blocks"][0][k]
                                           for k in ("k", "v"))]
    for leaf in stores:          # (B, n_sb, L, KH, hd)
        assert leaf[:, :, :S].any()
        assert not leaf[:, :, S:].any()
    assert dev.stats.n_stage2 == 0 and dev.stats.n_exited > 0


# ---------------------------------------------------------------------------
# the port against the JAX package: DecodeServer and SyncScheduler
# ---------------------------------------------------------------------------

def _first_near(logits: np.ndarray, conf_steps: np.ndarray, c_thr: float):
    """Per row, the first token index that is not compared: the top-2 gap
    of the logits that chose it, or the exit decision of the step that made
    those logits, is within NEAR. logits (B, T, V); conf_steps (T-1, B)."""
    B, Tn = logits.shape[:2]
    near = _top2_gap(logits) <= NEAR                        # (B, T)
    margin = np.abs(np.float32(c_thr) / conf_steps.astype(np.float64) - 1)
    near[:, 1:] |= (margin <= NEAR).T
    return np.where(near.any(1), near.argmax(1), Tn)


@pytest.mark.parametrize("q", [0.1, 0.3, 0.5])
def test_decode_server_matches_jax(tiny, q):
    jcfg, cfg, jparams, params = tiny
    prompt = np.random.default_rng(int(q * 10)).integers(
        0, cfg.vocab, (8, 6), dtype=np.int32)
    n_tok = 8
    conf0 = np.asarray(JSL.decode_step0_confidences(
        jparams, jcfg, _specs(0.5)[0], prompt, 6 + n_tok))
    c_thr = float(np.quantile(conf0, q))
    jspec, spec = _specs(c_thr)
    jsc = JSL.ServeConfig(capacity=3, queue_depth=2, c_thr=c_thr)
    sc = SL.ServeConfig(capacity=3, queue_depth=2, c_thr=c_thr)
    jsrv = JSL.DecodeServer(JSL.decode_stage_fns(jparams, jcfg, jspec), jsc)
    jsrv.conf_sink = []
    want = jsrv.generate(prompt, n_tok)
    srv = serve_api.build(params, cfg, spec, sc, mode="decode",
                          device="cpu")
    got = srv.generate(prompt, n_tok)
    conf = np.asarray(jsrv.conf_sink).reshape(n_tok - 1, 8)
    stop = _first_near(want["logits"], conf, c_thr)
    for b in range(8):
        np.testing.assert_array_equal(got["tokens"][b, :stop[b]],
                                      want["tokens"][b, :stop[b]])
        np.testing.assert_allclose(got["logits"][b, :stop[b]],
                                   want["logits"][b, :stop[b]],
                                   rtol=DEEP_TOL, atol=DEEP_TOL)
    assert stop.sum() >= 0.8 * 8 * n_tok
    if (stop == n_tok).all():
        for key in ("n_decisions", "n_exited", "n_stage2", "n_buckets",
                    "n_stalls", "ring_bytes_moved"):
            assert getattr(srv.stats, key) == getattr(jsrv.stats, key), key


N_TOKS = [7, 3, 5, 1, 7, 2]


def _requests(mod, prompt, arrivals=None):
    return [mod.Request(sample_id=i, prompt=prompt[i], n_tokens=n,
                        arrival_time=0.0 if arrivals is None
                        else float(arrivals[i]))
            for i, n in enumerate(N_TOKS)]


def test_sync_scheduler_matches_host_loop(tiny, prompt):
    """Batch formation over DecodeServer (a smaller tail batch included)
    gives the host loop's streams truncated per request, records latency,
    and counts real traffic only."""
    _, cfg, _, params = tiny
    sc = SL.ServeConfig(capacity=3, queue_depth=2, c_thr=0.9)
    spec = _specs(0.9)[1]
    oracle = serve_api.build(params, cfg, spec, sc, mode="decode",
                             host=True, device="cpu").generate(
                                 prompt, max(N_TOKS))
    sched = serve_api.build(params, cfg, spec, sc, mode="decode",
                            scheduler="sync", n_slots=4,
                            clock=sch.LogicalClock(), device="cpu")
    assert isinstance(sched, sch.SyncScheduler)
    for r in _requests(sch, prompt):
        sched.submit(r)
    res = sched.run()
    assert res == {i: [int(x) for x in oracle["tokens"][i][:n]]
                   for i, n in enumerate(N_TOKS)}
    assert sched.stats.n_finished == len(N_TOKS)
    assert sched.stats.n_samples == len(N_TOKS)
    assert not sched.stats.submit_times


def test_sync_scheduler_matches_jax_trace(tiny):
    """One Request trace with staggered arrivals under LogicalClock through
    both packages' SyncScheduler, at a threshold calibrated for q = 0.3:
    each request's stream equal up to its first near tie (most row-steps
    compared), the same clock, latencies and counters."""
    jcfg, cfg, jparams, params = tiny
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (6, 8),
                                               dtype=np.int32)
    arrivals = [0.0, 0.5, 0.5, 2.0, 7.0, 7.5]
    conf0 = np.asarray(JSL.decode_step0_confidences(
        jparams, jcfg, _specs(0.5)[0], prompt, 8 + max(N_TOKS)))
    c_thr = float(np.quantile(conf0, 0.3))
    jspec, spec = _specs(c_thr)
    jsrv = JSL.DecodeServer(JSL.decode_stage_fns(jparams, jcfg, jspec),
                            JSL.ServeConfig(capacity=3, queue_depth=2,
                                            c_thr=c_thr))
    jsrv.conf_sink = []
    batches = []                  # per static batch: (logits, step confs)
    jgen = jsrv.generate

    def generate(prompts, n):
        lo = len(jsrv.conf_sink)
        out = jgen(prompts, n)
        batches.append((np.asarray(out["logits"]), np.asarray(
            jsrv.conf_sink[lo:]).reshape(n - 1, len(prompts))))
        return out

    jsrv.generate = generate
    js = jx_sch.SyncScheduler(jsrv, n_slots=4, clock=jx_sch.LogicalClock())
    ps = serve_api.build(params, cfg, spec,
                         SL.ServeConfig(capacity=3, queue_depth=2,
                                        c_thr=c_thr),
                         mode="decode", scheduler="sync", n_slots=4,
                         clock=sch.LogicalClock(), device="cpu")
    for r in _requests(jx_sch, prompt, arrivals):
        js.submit(r)
    for r in _requests(sch, prompt, arrivals):
        ps.submit(r)
    want, got = js.run(), ps.run()
    assert set(got) == set(want) == set(range(6))
    # batches of 4 then 2 in arrival order; each row up to its first near
    # tie, from the JAX side's logits and confidences
    stops = np.concatenate([_first_near(lg, cf, c_thr)
                            for lg, cf in batches])
    n_cmp = 0
    for sid, n in enumerate(N_TOKS):
        k = min(int(stops[sid]), n)
        assert got[sid][:k] == want[sid][:k], sid
        n_cmp += k
    assert n_cmp >= 0.8 * sum(N_TOKS)
    assert 0 < ps.stats.n_exited < ps.stats.n_decisions
    assert ps.clock.now() == js.clock.now() == 7.5
    np.testing.assert_allclose(sorted(ps.stats.latencies),
                               sorted(js.stats.latencies))
    for key in ("n_samples", "n_decisions", "n_finished"):
        assert getattr(ps.stats, key) == getattr(js.stats, key), key


def test_validate_request_messages_match_jax():
    prompt = np.zeros(5, np.int32)
    cases = [(dict(n_tokens=0), {}), (dict(n_tokens=9), {"max_len": 10}),
             (dict(n_tokens=2), {"is_dup": lambda sid: True})]
    for req_kw, kw in cases:
        msgs = []
        for mod, api in ((jx_sch, jx_api), (sch, serve_api)):
            with pytest.raises(ValueError) as info:
                api.validate_request(mod.Request(3, prompt, **req_kw), **kw)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]
    serve_api.validate_request(sch.Request(3, prompt, 5), max_len=10)


def test_request_queue_matches_jax():
    prompt = np.zeros(4, np.int32)
    qs = [(api.RequestQueue(max_len=8), mod)
          for mod, api in ((jx_sch, jx_api), (sch, serve_api))]
    for q, mod in qs:
        for i, t in enumerate((0.0, 1.0, 2.0, 3.0)):
            q.append(mod.Request(i, prompt, 2, arrival_time=t))
        with pytest.raises(ValueError, match="duplicate sample id 2"):
            q.append(mod.Request(2, prompt, 2))
    (jq, _), (pq, _) = qs
    assert [r.sample_id for r in pq.revoke([1, 3])] == \
        [r.sample_id for r in jq.revoke([1, 3])] == [1, 3]
    assert pq.next_arrival() == jq.next_arrival() == 0.0
    assert pq.popleft().sample_id == jq.popleft().sample_id == 0
    assert len(pq) == len(jq) == 1 and 2 in pq and 0 not in pq


@pytest.mark.parametrize("rate", [float("inf"), 0.0, 3.5])
def test_poisson_arrivals_identical(rate):
    np.testing.assert_array_equal(sch.poisson_arrivals(16, rate, seed=2),
                                  jx_sch.poisson_arrivals(16, rate, seed=2))


def test_clocks_match_jax():
    for mod in (jx_sch, sch):
        c = mod.LogicalClock()
        c.advance_to(3.0)
        c.advance_to(1.0)
        assert c.now() == 3.0
        w = mod.Clock()
        w.advance_to(100.0)
        assert 100.0 <= w.now() < 101.0


def test_sync_scheduler_queue_surface(tiny, prompt):
    """Queue depth, the next arrival and revocation of queued requests,
    between static batches."""
    _, cfg, _, params = tiny
    sched = serve_api.build(params, cfg, _specs(0.5)[1],
                            SL.ServeConfig(capacity=2), mode="decode",
                            scheduler="sync", n_slots=2,
                            clock=sch.LogicalClock(), device="cpu")
    for r in _requests(sch, prompt, [0.0, 1.0, 1.0, 4.0, 5.0, 6.0]):
        sched.submit(r)
    assert sched.queue_len == 6 and sched.next_arrival() == 0.0
    assert sched.step() == "busy"
    assert sched.clock.now() == 1.0 and sched.next_arrival() == 1.0
    assert [r.sample_id for r in sched.queue.revoke([3, 5])] == [3, 5]
    assert sched.drain() is sched.results
    assert sorted(sched.results) == [0, 1, 2, 4]
    assert sched.step() == "idle" and sched.clock.now() == 5.0


def test_sync_scheduler_refuses_what_is_not_ported(tiny):
    _, cfg, _, params = tiny
    sc = SL.ServeConfig(capacity=2)
    spec = _specs(0.5)[1]
    sched = serve_api.build(params, cfg, spec, sc, mode="decode",
                            scheduler="sync", n_slots=2, device="cpu")
    with pytest.raises(NotImplementedError, match="continuous"):
        sched.request_migration(None)
    for kw in (dict(scheduler="continuous", n_slots=2, max_len=8),
               dict(scheduler="sync", n_slots=2, page_size=4, n_pages=8)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve_api.build(params, cfg, spec, sc, mode="decode",
                            device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="item 14"):
        serve_api.build(params, cfg, spec, sc, mode="decode",
                        scheduler="sync", n_slots=2, events=object(),
                        device="cpu")
    with pytest.raises(ValueError, match="n_slots"):
        serve_api.build(params, cfg, spec, sc, mode="decode",
                        scheduler="sync", device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_DECODE_ARGS = ["--smoke", "--mode", "decode", "--requests", "4",
                "--batch", "2", "--seq", "4", "--decode-tokens", "4"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue())


@pytest.fixture(scope="module")
def jax_decode_payload():
    return _run(jx_cli.main, _DECODE_ARGS)


@pytest.mark.parametrize("extra", [[], ["--page-size", "4"],
                                   ["--arrival-rate", "50"]],
                         ids=["dense", "paged", "poisson"])
def test_cli_decode_payload_matches_jax_keys(jax_decode_payload, extra):
    payload = _run(serve_cli.main, _DECODE_ARGS + ["--device", "cpu"]
                   + extra)
    assert set(payload) == set(jax_decode_payload)
    assert payload["mode"] == "decode" and payload["scheduler"] == "sync"
    assert payload["n_samples"] == 4 and payload["n_finished"] == 4
    assert payload["n_decisions"] == 4 * 3
    assert payload["goodput_tokens_per_s"] > 0
    if extra[:1] == ["--page-size"]:
        assert payload["cache_pages_total"] == 2 * 8 // 4   # batch 2, M 2
        assert payload["cache_hbm_bytes"] > 0
