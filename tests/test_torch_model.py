"""The port's model stages against the JAX package, on the CPU.

Configs are compared field for field. Layers, ``prefill`` + one
``decode_step``, ``stage1_prefill``, ``stage2_prefill`` and ``serve_batch``
run on ``tiny_cfg`` and on the smoke configs of qwen2-1.5b, qwen3-4b,
qwen1.5-4b and qwen2-7b with the JAX package's params carried across
by ``repro_torch.bridge``; inputs are made with numpy from a seed.

Tolerances: fp32 paths rtol 1e-5 / atol 2e-5 (the same arithmetic, summed
in another order by another library); bf16 layer outputs rtol/atol 2e-2
(one bf16 rounding, 2^-8 relative, may land on either side); integer
outputs, masks and counts exactly, with thresholds set off the decision
margin.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import ARCHS as JX_ARCHS  # noqa: E402
from repro.configs.archs import smoke_config as jx_smoke  # noqa: E402
from repro.core import conditional as jx_cond  # noqa: E402
from repro.core import early_exit as jx_ee  # noqa: E402
from repro.core import exit_decision as jx_ed  # noqa: E402
from repro.core.stage_mesh import stage2_capacity as jx_capacity  # noqa: E402
from repro.models import layers as jx_layers  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.archs import ARCHS, smoke_config  # noqa: E402
from repro_torch.core import conditional as cond  # noqa: E402
from repro_torch.core import early_exit as ee  # noqa: E402
from repro_torch.core import exit_decision as ed  # noqa: E402
from repro_torch.core.stage_mesh import stage2_capacity  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5
BF16_TOL = 2e-2


def port_cfg(jcfg) -> ArchConfig:
    """The port's ArchConfig with the JAX config's fields (dense family:
    no sub-configs)."""
    return ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})


def bridged(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


SMOKE_ARCHS = {"qwen2-smoke": "qwen2-1.5b",
               "qwen3-4b-smoke": "qwen3-4b",       # qk_norm, no qkv bias
               "qwen1.5-4b-smoke": "qwen1.5-4b",   # MHA, untied head
               "qwen2-7b-smoke": "qwen2-7b"}       # untied head


@pytest.fixture(scope="module", params=["tiny", *SMOKE_ARCHS])
def model(request, tiny_cfg):
    """(jax cfg, port cfg, jax spec, jax params, port params)."""
    jcfg = tiny_cfg if request.param == "tiny" else jx_smoke(
        JX_ARCHS[SMOKE_ARCHS[request.param]])
    jspec = jx_ee.default_spec(jcfg)
    jparams = jx_ee.init_ee_params(jax.random.PRNGKey(0), jcfg, jspec)
    return jcfg, port_cfg(jcfg), jspec, jparams, bridged(jparams)


def _tokens(cfg, n, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (n, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JX_ARCHS))
def test_arch_configs_match_jax(name):
    for jcfg, cfg in ((JX_ARCHS[name], ARCHS[name]),
                      (jx_smoke(JX_ARCHS[name]), smoke_config(ARCHS[name]))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
        assert cfg.n_superblocks == jcfg.n_superblocks
        assert cfg.default_exit_layers() == jcfg.default_exit_layers()
        assert str(cfg.act_dtype()) == "torch." + jcfg.act_dtype().name


def test_init_params_tree_matches_jax(model):
    """The port's own init builds the JAX package's tree: same structure,
    shapes and dtypes (the values come from another generator)."""
    jcfg, cfg, jspec, jparams, _ = model
    spec = ee.EarlyExitSpec(exit_layer=jspec.exit_layer)
    mine = ee.init_ee_params(cfg, spec, torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, mine,
                     is_leaf=lambda x: torch.is_tensor(x)))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype) == "torch." + w.dtype.name


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(smoke_config(ARCHS["mamba2-130m"]),
                      torch.Generator().manual_seed(0))


def test_bridge_keeps_bf16_bits():
    a = jax.random.normal(jax.random.PRNGKey(1), (3, 5)).astype(jnp.bfloat16)
    t = params_from_numpy({"x": [np.asarray(a)]}, "cpu")["x"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(11)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else \
        dict(rtol=BF16_TOL, atol=BF16_TOL)

    def pair(shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        j, t = jnp.asarray(a), torch.from_numpy(a)
        if dtype == "bfloat16":
            j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
        return j, t

    xj, xt = pair((2, 6, 32))
    sj, st = pair((32,))
    np.testing.assert_allclose(
        _np(layers.rmsnorm({"scale": st}, xt)),
        _np(jx_layers.rmsnorm({"scale": sj}, xj)), **tol)

    qj, qt = pair((2, 6, 4, 16))
    pos = np.arange(6, dtype=np.int32)[None]
    np.testing.assert_allclose(
        _np(layers.apply_rope(qt, torch.from_numpy(pos), 1e6)),
        _np(jx_layers.apply_rope(qj, jnp.asarray(pos), 1e6)), **tol)

    w = {k: pair(s, 0.2) for k, s in (("wi_gate", (32, 48)),
                                       ("wi_up", (32, 48)),
                                       ("wo", (48, 32)))}
    np.testing.assert_allclose(
        _np(layers.mlp({k: v[1] for k, v in w.items()}, xt)),
        _np(jx_layers.mlp({k: v[0] for k, v in w.items()}, xj, "swiglu")),
        **tol)

    tj, tt = pair((50, 32), 0.1)
    np.testing.assert_allclose(
        layers.unembed({"table": tt}, xt).numpy(),
        np.asarray(jx_layers.unembed({"table": tj}, xj)), **tol)

    kj, kt = pair((2, 6, 2, 16))
    vj, vt = pair((2, 6, 2, 16))
    np.testing.assert_allclose(
        _np(layers.blocked_attention(qt, kt, vt)),
        _np(jx_layers.blocked_attention(qj, kj, vj)), **tol)


# ---------------------------------------------------------------------------
# early-exit stages and the one-shot pipeline
# ---------------------------------------------------------------------------

def test_stages_match_jax(model):
    jcfg, cfg, jspec, jparams, params = model
    spec = ee.EarlyExitSpec(exit_layer=jspec.exit_layer, c_thr=jspec.c_thr)
    toks = _tokens(cfg, 4, 8, 1)
    jh, _, jlog, _ = jx_ee.stage1_prefill(jparams, jcfg, jspec,
                                          jnp.asarray(toks))
    h, caches, logits, _ = ee.stage1_prefill(params, cfg, spec,
                                             torch.from_numpy(toks))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    n_sb = jspec.exit_layer // cfg.pattern_len
    assert caches["blocks"][0]["k"].shape == (n_sb, 4, 8, cfg.n_kv_heads,
                                              cfg.resolved_head_dim)
    jfin, _ = jx_ee.stage2_prefill(jparams, jcfg, jspec, jh)
    fin, _ = ee.stage2_prefill(params, cfg, spec, h)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), rtol=RTOL,
                               atol=ATOL)
    # a stage-2 param slice gives the full tree's result, bit for bit
    _, p2 = ee.split_params(cfg, spec, params)
    fin2, _ = ee.stage2_prefill(p2, cfg, spec, h, presliced_params=True)
    assert torch.equal(fin2, fin)


def test_prefill_and_decode_step_match_jax(model):
    """The backbone alone: prefill of 6 tokens into caches of 8, then one
    decode step, logits and the new cache rows against the JAX package."""
    from repro.models import transformer as JT
    jcfg, cfg, _, jparams, params = model
    toks = _tokens(cfg, 3, 6, 4)
    jlog, jc, _ = JT.prefill(jparams["backbone"], jcfg, jnp.asarray(toks),
                             max_len=8)
    log, c = T.prefill(params["backbone"], cfg, torch.from_numpy(toks),
                       max_len=8)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    tok = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    jlog, jc = JT.decode_step(jparams["backbone"], jcfg, jnp.asarray(tok),
                              jc, jnp.int32(6))
    log, c = T.decode_step(params["backbone"], cfg, torch.from_numpy(tok), c,
                           6)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(c["blocks"][0][key].numpy(),
                                   np.asarray(jc["blocks"][0][key]),
                                   rtol=RTOL, atol=ATOL)


def _off_margin_threshold(conf: np.ndarray, rate: float) -> float:
    """A threshold that lets about ``rate`` of the rows exit, set in the
    widest gap between neighbouring confidences near that quantile, so both
    packages decide every row the same way."""
    c = np.sort(conf.astype(np.float64))
    k = min(max(int(round((1 - rate) * len(c))), 1), len(c) - 1)
    lo, hi = max(k - 3, 1), min(k + 3, len(c) - 1)
    j = max(range(lo, hi + 1), key=lambda i: c[i] - c[i - 1])
    return float((c[j] + c[j - 1]) / 2)


def test_serve_batch_matches_jax(model):
    jcfg, cfg, jspec, jparams, params = model
    toks = _tokens(cfg, 16, 8, 2)
    _, _, jlog, _ = jx_ee.stage1_prefill(jparams, jcfg, jspec,
                                         jnp.asarray(toks))
    c_thr = _off_margin_threshold(
        np.asarray(jx_ed.softmax_confidence(jlog)), 0.5)
    for cap in (16, 4):
        js = jx_ee.EarlyExitSpec(exit_layer=jspec.exit_layer, c_thr=c_thr)
        ps = ee.EarlyExitSpec(exit_layer=jspec.exit_layer, c_thr=c_thr)
        want = jx_ee.serve_batch(jparams, jcfg, js, jnp.asarray(toks),
                                 capacity=cap)
        got = ee.serve_batch(params, cfg, ps, torch.from_numpy(toks),
                             capacity=cap)
        np.testing.assert_array_equal(got["exit_mask"].numpy(),
                                      np.asarray(want["exit_mask"]))
        assert int(got["n_hard"]) == int(want["n_hard"])
        assert int(got["overflow"]) == int(want["overflow"])
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.asarray(want["logits"]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["confidence"].numpy(),
                                   np.asarray(want["confidence"]),
                                   rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# core helpers
# ---------------------------------------------------------------------------

def test_calibrate_threshold_matches_jax():
    conf = np.random.default_rng(4).random(101).astype(np.float32)
    for rate in (0.0, 0.1, 0.25, 0.5, 0.75, 1.0):
        assert ed.calibrate_threshold(torch.from_numpy(conf), rate) == \
            pytest.approx(jx_ed.calibrate_threshold(jnp.asarray(conf), rate),
                          rel=1e-7, abs=0)
    with pytest.raises(ValueError):
        ed.calibrate_threshold(torch.zeros(0), 0.5)
    with pytest.raises(ValueError):
        ed.calibrate_threshold(torch.from_numpy(conf), 1.5)
    x = np.random.default_rng(5).standard_normal((6, 40)).astype(np.float32)
    np.testing.assert_allclose(
        ed.softmax_confidence(torch.from_numpy(x)).numpy(),
        np.asarray(jx_ed.softmax_confidence(jnp.asarray(x))), rtol=RTOL)
    got = ed.decision_and_argmax(torch.from_numpy(x), 0.05)
    want = jx_ed.decision_and_argmax(jnp.asarray(x), 0.05)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("p_hard", [0.0, 0.5, 1.0])
def test_conditional_matches_jax(p_hard):
    rng = np.random.default_rng(int(p_hard * 10) + 3)
    hard = rng.random(12) < p_hard
    perm, n = cond.compact_indices(torch.from_numpy(hard))
    jperm, jn = jx_cond.compact_indices(jnp.asarray(hard))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(n) == int(jn)
    easy_ids = np.where(~hard, np.arange(12), -1).astype(np.int32)
    vals = rng.standard_normal((12, 3)).astype(np.float32)
    picked = [i for i in range(12) if hard[i]][:4]
    hard_ids = np.array(picked + [-1] * (8 - len(picked)), np.int32)
    hvals = rng.standard_normal((8, 3)).astype(np.float32)
    got = cond.exit_merge(12, torch.from_numpy(easy_ids),
                          torch.from_numpy(vals), torch.from_numpy(hard_ids),
                          torch.from_numpy(hvals))
    want = jx_cond.exit_merge(12, jnp.asarray(easy_ids), jnp.asarray(vals),
                              jnp.asarray(hard_ids), jnp.asarray(hvals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stage2_capacity_matches_jax():
    for batch in (1, 4, 8, 32, 100):
        for p in (0.0, 0.1, 0.25, 0.5, 1.0):
            assert stage2_capacity(batch, p) == jx_capacity(batch, p)
