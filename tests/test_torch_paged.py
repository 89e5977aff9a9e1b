"""The port's paged decode cache against the JAX package, on the CPU.

Bottom up: the plain version of the paged append + gather kernel
(``repro_torch/kernels/paged_attention/ref.py``, what the dispatch runs for
CPU tensors) against the JAX ``paged_gather_append_ref`` and the Pallas
body under ``interpret=True``; ``attention_decode`` dense and paged, with a
shared and a per-row step, against the JAX function; paged == dense inside
the port; the step-synchronous ``DecodeServer`` with a paged stage-2 cache
equal to the dense one and to the host loop, with its page gauges.

Tolerances: the kernel is pure data movement, so gathered pages and pools
match bit for bit (fp32 and bf16). ``attention_decode`` in fp32 against
JAX: rtol 1e-5, atol 2e-5 (the same arithmetic reduced in another order by
another library). Inside the port, paged and dense are compared bit for
bit: they go through one attention core with the same cache bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_gather_append_pallas, paged_gather_append_ref as jx_paged)
from repro.models import attention as JA  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import early_exit as ee  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_gather_append_cuda, paged_gather_append_ref)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.runtime import serve_api  # noqa: E402
from repro_torch.runtime import serve_loop as SL  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, B, M, page, n_pages, fa, fb):
    """Pools with a zero NULL page, each row owning a disjoint run of pages
    null-padded to a random prefix, positions inside the owned span (the
    cases of tests/test_paged.py, made with numpy)."""
    rng = np.random.default_rng(seed)
    a_pool = rng.standard_normal((n_pages, page) + fa).astype(np.float32)
    b_pool = rng.standard_normal((n_pages, page) + fb).astype(np.float32)
    a_pool[0] = 0
    b_pool[0] = 0
    a_new = rng.standard_normal((B,) + fa).astype(np.float32)
    b_new = rng.standard_normal((B,) + fb).astype(np.float32)
    bt = (1 + rng.permutation(n_pages - 1)[:B * M]).reshape(B, M)
    owned = rng.integers(1, M + 1, (B,))
    bt = np.where(np.arange(M)[None] < owned[:, None], bt, 0).astype(
        np.int32)
    pos = rng.integers(0, owned * page).astype(np.int32)
    return a_pool, b_pool, a_new, b_new, bt, pos


def _both(args, dtype):
    """Run the port's plain version (on copies: it updates the pools in
    place) and the JAX ref on the same numpy inputs, cast to ``dtype`` by
    each framework."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(a).astype(jd) if a.dtype == np.float32
             else jnp.asarray(a) for a in args]
    targs = [_t(a).to(td) if a.dtype == np.float32 else _t(a)
             for a in args]
    got = paged_gather_append_ref(*targs)
    return got, jargs, jx_paged(*jargs)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,M,page,fa,fb", [
    (4, 3, 4, (16,), (16,)),        # flattened GQA K/V rows (KH * hd)
    (2, 2, 8, (16,), (4,)),         # pools of two widths
    (6, 4, 2, (4,), (4,)),
])
def test_plain_kernel_matches_jax(B, M, page, fa, fb, dtype):
    n_pages = 1 + B * M + 3                          # +3 pages nobody owns
    args = _case(B * 7 + page, B, M, page, n_pages, fa, fb)
    got, jargs, want = _both(args, dtype)
    _assert_same(got, want)
    _assert_same(got, paged_gather_append_pallas(*jargs, interpret=True))
    assert not got[2][0].any() and not got[3][0].any()   # NULL page


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernel_sentinel_and_null_tail(dtype):
    """pos >= M * page (parked / flush rows) and a NULL tail entry append
    nothing: the pools come back unchanged, and page 0 stays zero."""
    B, M, page, n_pages = 3, 2, 4, 1 + 6
    a_pool, b_pool, a_new, b_new, bt, _ = _case(0, B, M, page, n_pages,
                                                (8,), (8,))
    bt[2] = [5, 0]                                   # tail page 1 is NULL
    pos = np.array([M * page, M * page + 3, page + 1], np.int32)
    args = (a_pool, b_pool, a_new, b_new, bt, pos)
    got, jargs, want = _both(args, dtype)
    _assert_same(got, want)
    _assert_same(got, paged_gather_append_pallas(*jargs, interpret=True))
    _assert_same(got[2:], jargs[:2])                  # pools unchanged


def test_plain_kernel_shared_page_sees_every_append():
    """A page read by several rows shows the append of the row whose tail
    it is: append every row, then gather (the JAX ref's order). The Pallas
    body merges a row's token into its own tail cell only, so it is held to
    the ref on disjoint tables alone (above)."""
    B, M, page = 3, 3, 4
    a_pool, b_pool, a_new, b_new, _, _ = _case(5, B, M, page, 1 + B * M,
                                               (7,), (5,))
    bt = np.array([[1, 2, 0], [1, 3, 0], [4, 0, 0]], np.int32)
    pos = np.array([5, 6, 2], np.int32)    # row 0 appends into page 2,
    got, _, want = _both((a_pool, b_pool, a_new, b_new, bt, pos),
                         "float32")        # row 1 into page 3, both read 1
    _assert_same(got, want)
    np.testing.assert_array_equal(got[0][1, 0].numpy(),
                                  got[0][0, 0].numpy())
    np.testing.assert_array_equal(got[0][0, 1, 1].numpy(), a_new[0])


def test_dispatch_flattens_feature_axes():
    """The dispatch takes (P, page, KH, hd) pools and restores the feature
    axes: the same bytes as the plain version on flattened rows."""
    B, M, page, n_pages = 2, 2, 4, 1 + 4
    args = _case(3, B, M, page, n_pages, (2, 4), (2, 4))
    targs = [_t(a) for a in args]
    got = dispatch.paged_gather_append(*[t.clone() for t in targs])
    flat = [targs[0].reshape(n_pages, page, -1),
            targs[1].reshape(n_pages, page, -1),
            targs[2].reshape(B, -1), targs[3].reshape(B, -1), targs[4],
            targs[5]]
    want = paged_gather_append_ref(*[t.clone() for t in flat])
    assert got[0].shape == (B, M, page, 2, 4)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)


def test_kernel_wrapper_refuses_cpu_tensors():
    args = [_t(a) for a in _case(1, 2, 2, 4, 5, (4,), (4,))]
    with pytest.raises(ValueError, match="CUDA"):
        paged_gather_append_cuda(*args)


# ---------------------------------------------------------------------------
# attention_decode: dense and paged, against JAX and against each other
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attn_setup():
    from repro.models.config import ArchConfig as JArchConfig
    kw = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=64, dtype="float32",
              param_dtype="float32")
    jcfg, cfg = JArchConfig(**kw), ArchConfig(**kw)
    jparams = JA.init_attention(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _identity_bt(B, max_len, page):
    """Row b owns pages [1 + b*M, 1 + (b+1)*M)."""
    M = max_len // page
    return 1 + np.arange(B * M, dtype=np.int32).reshape(B, M)


def _port_paged(cfg, B, max_len, page):
    bt = _identity_bt(B, max_len, page)
    return dict(A.init_paged_kv_cache(cfg, B, max_len, page, 1 + bt.size,
                                      "cpu"), bt=_t(bt))


def _paged_pair(jcfg, cfg, B, max_len, page):
    bt = _identity_bt(B, max_len, page)
    jc = dict(JA.init_paged_kv_cache(jcfg, B, max_len, page, 1 + bt.size),
              bt=jnp.asarray(bt))
    return jc, _port_paged(cfg, B, max_len, page)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_attention_decode_matches_jax(attn_setup, paged, per_row):
    jcfg, cfg, jparams, params = attn_setup
    B, max_len, page = 3, 16, 4
    if paged:
        jc, c = _paged_pair(jcfg, cfg, B, max_len, page)
    else:
        jc = JA.init_kv_cache(jcfg, B, max_len)
        c = A.init_kv_cache(cfg, B, max_len, "cpu")
    rng = np.random.default_rng(4)
    start = np.array([2, 5, 0], np.int32)
    for t in range(8):
        x = rng.standard_normal((B, 1, 32)).astype(np.float32)
        if per_row:
            jstep, step = jnp.asarray(start + t), _t(start + t)
        else:
            jstep, step = jnp.int32(2 + t), 2 + t
        jout, jc = JA.attention_decode(jparams, jcfg, jnp.asarray(x), jc,
                                       jstep)
        out, c = A.attention_decode(params, cfg, _t(x), c, step)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=RTOL, atol=ATOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]),
                                       rtol=RTOL, atol=ATOL)
    if paged:
        assert not c["k"][0].any()


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_attention_decode_paged_equals_dense_bitwise(attn_setup, per_row):
    _, cfg, _, params = attn_setup
    B, max_len, page = 3, 16, 4
    dense = A.init_kv_cache(cfg, B, max_len, "cpu")
    paged = _port_paged(cfg, B, max_len, page)
    rng = np.random.default_rng(9)
    start = np.array([2, 7, 4], np.int32)
    for t in range(10):
        x = _t(rng.standard_normal((B, 1, 32)).astype(np.float32))
        step = _t(start + t) if per_row else 2 + t
        out_d, dense = A.attention_decode(params, cfg, x, dense, step)
        out_p, paged = A.attention_decode(params, cfg, x, paged, step)
        assert torch.equal(out_d, out_p)


def test_decode_attention_matches_jax():
    """The length-masked entry of the shared decode core."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
            for _ in range(2))
    lens = np.array([1, 7, 10], np.int32)
    np.testing.assert_allclose(
        L.decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy(),
        np.asarray(JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens))),
        rtol=RTOL, atol=ATOL)


def test_windowed_layers_raise(attn_setup):
    _, cfg, _, params = attn_setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.init_kv_cache(cfg, 2, 8, "cpu", window=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.attention_decode(params, cfg, torch.zeros(2, 1, 32),
                           A.init_kv_cache(cfg, 2, 8, "cpu"), 0, window=4)


def test_paged_cache_needs_page_multiple(attn_setup):
    _, cfg, _, _ = attn_setup
    with pytest.raises(ValueError, match="multiple"):
        A.init_paged_kv_cache(cfg, 2, 10, 4, 5, "cpu")


# ---------------------------------------------------------------------------
# the step-synchronous server: paged == dense == host loop, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tiny_cfg, tiny_params, tiny_spec):
    cfg = ArchConfig(**{f: getattr(tiny_cfg, f)
                        for f in tiny_cfg.__dataclass_fields__})
    params = params_from_numpy(jax.tree.map(np.asarray, tiny_params), "cpu")
    spec = ee.EarlyExitSpec(exit_layer=tiny_spec.exit_layer,
                            c_thr=tiny_spec.c_thr)
    return cfg, spec, params


@pytest.fixture(scope="module")
def prompt(tiny_cfg):
    return np.random.default_rng(77).integers(0, tiny_cfg.vocab, (6, 6),
                                              dtype=np.int32)


@pytest.mark.parametrize("c_thr,cap,depth", [(0.7, 3, 2), (1.1, 2, 1)])
def test_sync_server_paged_bitwise(tiny, prompt, c_thr, cap, depth):
    """Mixed traffic, and all-hard traffic through a ring smaller than the
    batch (stalls and the fused dispatch's spill, on the paged payload)."""
    cfg, spec, params = tiny
    S, n_tok, page = prompt.shape[1], 10, 4
    sc = SL.ServeConfig(capacity=cap, queue_depth=depth, c_thr=c_thr)
    out_d = serve_api.build(params, cfg, spec, sc, mode="decode",
                            device="cpu").generate(prompt, n_tok)
    srv_p = serve_api.build(params, cfg, spec, sc, mode="decode",
                            page_size=page, device="cpu")
    out_p = srv_p.generate(prompt, n_tok)
    np.testing.assert_array_equal(out_d["tokens"], out_p["tokens"])
    np.testing.assert_array_equal(out_d["logits"], out_p["logits"])
    oracle = serve_api.build(params, cfg, spec, sc, mode="decode", host=True,
                             device="cpu").generate(prompt, n_tok)
    np.testing.assert_array_equal(oracle["tokens"], out_p["tokens"])
    np.testing.assert_array_equal(oracle["logits"], out_p["logits"])
    st = srv_p.stats
    M = (S + n_tok) // page
    assert st.cache_pages_total == st.cache_pages_in_use == 6 * M
    assert st.cache_page_size == page
    n_layers2 = cfg.n_layers - spec.exit_layer          # k and v pools each
    assert st.cache_hbm_bytes == 2 * n_layers2 * (6 * M + 1) * page * \
        cfg.n_kv_heads * cfg.resolved_head_dim * 4
    assert not srv_p._pool["blocks"][0]["k"][:, 0].any()   # NULL page
    if c_thr > 1:
        assert st.n_stalls > 0


def test_sync_server_paged_needs_page_multiple(tiny, prompt):
    cfg, spec, params = tiny
    srv = serve_api.build(params, cfg, spec, SL.ServeConfig(capacity=2),
                          mode="decode", page_size=4, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        srv.generate(prompt, 7)


def test_admit_pages_keeps_null_page_zero(tiny, prompt):
    """Admission writes many NULL table entries into page 0; each carries
    the dense tail's zeros, so page 0 stays zero, and every owned page
    holds its row's dense bytes."""
    cfg, spec, params = tiny
    fns = SL.decode_stage_fns(params, cfg, spec, page_size=4)
    _, caches = fns.prefill(torch.from_numpy(prompt[:3]), 16)
    _, rows = fns.split(caches)
    bt = torch.tensor([[1, 2, 0, 0], [3, 0, 0, 0], [4, 5, 6, 7]],
                      dtype=torch.int32)      # rows 0 and 1 own 8 and 4 slots
    for b, keep in ((0, 8), (1, 4)):
        for leaf in rows["blocks"][0].values():
            leaf[b, :, keep:] = 0             # what lies past them is zero
    pool = fns.admit_pages(fns.pool_init(rows, 8), rows, bt)
    for key in ("k", "v"):
        p, r = pool["blocks"][0][key], rows["blocks"][0][key]
        assert not p[:, 0].any()
        gathered = p[:, bt.long()].reshape((p.shape[0], 3, 16)
                                           + tuple(p.shape[3:]))
        assert torch.equal(gathered.movedim(1, 0), r)


def test_s2_paged_appends_in_place(tiny, prompt):
    """A paged stage-2 bucket appends into the pools it is given and hands
    the same storage back: no per-bucket copy of the pools."""
    cfg, spec, params = tiny
    fns = SL.decode_stage_fns(params, cfg, spec, page_size=4)
    _, caches = fns.prefill(torch.from_numpy(prompt[:3]), 16)
    _, rows = fns.split(caches)
    bt = 1 + torch.arange(12, dtype=torch.int32).reshape(3, 4)
    pool = fns.admit_pages(fns.pool_init(rows, 13), rows, bt)
    before = [leaf.clone() for leaf in pool["blocks"][0].values()]
    h = torch.randn(3, cfg.d_model, generator=torch.Generator().manual_seed(
        5)).to(cfg.act_dtype())
    step = torch.tensor([6, 7, 16], dtype=torch.int32)   # row 2: sentinel
    _, new_pool = fns.s2_paged(h, bt, step, pool)
    for old, leaf, got in zip(before, pool["blocks"][0].values(),
                              new_pool["blocks"][0].values()):
        assert got.data_ptr() == leaf.data_ptr()
        assert not torch.equal(leaf, old)
        changed = (leaf != old).flatten(3).any(-1)      # (n_sb, P, page)
        assert changed.nonzero()[:, 1:].unique(dim=0).tolist() == [
            [2, 2], [6, 3]]        # page bt[0, 1] row 2, page bt[1, 1] row 3
        assert not leaf[:, 0].any()


def test_build_paged_host_loop_raises(tiny):
    cfg, spec, params = tiny
    with pytest.raises(ValueError, match="host-loop"):
        serve_api.build(params, cfg, spec, SL.ServeConfig(capacity=2),
                        mode="decode", host=True, page_size=4, device="cpu")
    with pytest.raises(ValueError, match="decode-mode"):
        serve_api.build(params, cfg, spec, SL.ServeConfig(capacity=2),
                        page_size=4, device="cpu")
