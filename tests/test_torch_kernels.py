"""The port's kernel modules against the JAX package, on the CPU.

Each plain PyTorch version (``repro_torch/kernels/*/ref.py``), which is what
the dispatch layer runs for CPU tensors, is held against the JAX package's
``ref.py`` and against its Pallas kernel body run with ``interpret=True``,
on the edge cases of ``tests/test_kernels.py`` and
``tests/test_fused_dispatch.py``. Inputs are made with numpy from a seed
and handed to both packages.

Tolerances: integers, masks, ids, ring cursors and gathered/scattered rows
must match exactly (pure data movement). ``conf`` is an fp32 sum of
exponentials reduced in another order, so rtol 1e-5. Decisions compare
exactly on rows whose margin |c_thr * s - 1| exceeds 1e-4; rows inside the
margin are counted and may differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.exit_decision.kernel import exit_decision_pallas  # noqa: E402
from repro.kernels.exit_decision.ref import exit_decision_ref as jx_exit  # noqa: E402
from repro.kernels.fused_dispatch import fused_dispatch_pallas  # noqa: E402
from repro.kernels.fused_dispatch.ref import (  # noqa: E402
    compact_src as jx_compact_src, fused_dispatch_ref as jx_fused,
    ring_offsets as jx_ring_offsets)
from repro.kernels.gather_compact.kernel import gather_compact_pallas  # noqa: E402
from repro.kernels.gather_compact.ref import gather_compact_ref as jx_gather  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.exit_decision import (exit_decision_cuda,  # noqa: E402
                                               exit_decision_ref)
from repro_torch.kernels.fused_dispatch import (compact_src,  # noqa: E402
                                                fused_dispatch_ref,
                                                ring_offsets,
                                                scatter_merge_cuda,
                                                scatter_merge_ref,
                                                slot_src_map)
from repro_torch.kernels.gather_compact import (gather_compact_cuda,  # noqa: E402
                                                gather_compact_ref)

CONF_RTOL = 1e-5
MARGIN = 1e-4


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor (bf16 rounded
    once, by both frameworks, to nearest even)."""
    j = jnp.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _check_decision(got, want, c_thr):
    """(exit, pred, conf) of the port vs one of the JAX package."""
    e, p, c = (x.numpy() for x in got)
    we, wp, wc = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(p, wp)
    np.testing.assert_allclose(c, wc, rtol=CONF_RTOL, atol=0)
    s = 1.0 / wc.astype(np.float64)
    clear = np.abs(np.float32(c_thr) * s - 1.0) > MARGIN
    np.testing.assert_array_equal(e[clear], we[clear])
    return int((~clear).sum())


# ---------------------------------------------------------------------------
# exit decision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("vocab", [8, 100, 1000, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exit_decision_matches_jax(rows, vocab, dtype):
    rng = np.random.default_rng(rows * vocab)
    xj, xt = _pair((rng.standard_normal((rows, vocab)) * 4.0)
                   .astype(np.float32), dtype)
    for c_thr in (0.1, 0.5, 0.9, 0.99):
        got = exit_decision_ref(xt, c_thr)
        _check_decision(got, jx_exit(xj, c_thr), c_thr)
        _check_decision(got, exit_decision_pallas(xj, c_thr, interpret=True),
                        c_thr)


def test_exit_decision_ties_first_occurrence():
    """Equal maxima in two vocab tiles of the Pallas kernel: pred is the
    first, as in the kernel's strict cross-tile update."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5000)).astype(np.float32)
    x[:, 17] = x[:, 4500] = x.max(axis=1) + 1.0
    xj, xt = _pair(x, "float32")
    got = exit_decision_ref(xt, 0.5)
    _check_decision(got, exit_decision_pallas(xj, 0.5, interpret=True), 0.5)
    assert (got[1].numpy() == 17).all()


def test_exit_decision_extremes_and_uniform():
    x = np.array([[500.0, -500.0, 0.0], [90.0, 89.0, 88.0]], np.float32)
    e, p, c = exit_decision_ref(torch.from_numpy(x), 0.9)
    assert torch.isfinite(c).all() and int(p[0]) == 0 and bool(e[0])
    e, _, c = exit_decision_ref(torch.zeros(4, 10), 0.5)
    np.testing.assert_allclose(c.numpy(), 0.1, rtol=1e-6)
    assert not bool(e.any())


def test_exit_decision_op_leading_dims():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 64)).astype(np.float32))
    e, p, c = dispatch.exit_decision_op(x, 0.5)
    assert e.shape == p.shape == c.shape == (2, 3)
    e2, p2, c2 = exit_decision_ref(x.reshape(6, 64), 0.5)
    assert torch.equal(p.reshape(6), p2) and torch.equal(c.reshape(6), c2)


# ---------------------------------------------------------------------------
# gather compact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("feat", [1, 33])
@pytest.mark.parametrize("p_hard", [0.0, 0.3, 1.0])
def test_gather_compact_matches_jax(batch, feat, p_hard):
    rng = np.random.default_rng(batch * feat + 1)
    x = rng.standard_normal((batch, feat)).astype(np.float32)
    mask = rng.random(batch) < p_hard
    for capacity in sorted({max(1, batch // 2), batch}):
        got = gather_compact_ref(torch.from_numpy(x), torch.from_numpy(mask),
                                 capacity)
        for want in (jx_gather(jnp.asarray(x), jnp.asarray(mask), capacity),
                     gather_compact_pallas(jnp.asarray(x), jnp.asarray(mask),
                                           capacity, interpret=True)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
def test_gather_compact_dtypes(dtype):
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    mask = np.array([1, 0, 1, 0, 0, 1, 0, 0], bool)
    if dtype == "int32":
        xj, xt = jnp.asarray(x.astype(np.int32)), torch.from_numpy(
            x.astype(np.int32))
    else:
        xj, xt = _pair(x, dtype)
    s, ids, n = dispatch.gather_compact_op(xt, torch.from_numpy(mask), 4)
    ws, wids, wn = jx_gather(xj, jnp.asarray(mask), 4)
    assert s.dtype == xt.dtype and int(n) == int(wn) == 3
    np.testing.assert_array_equal(ids.numpy(), [0, 2, 5, -1])
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(ws.astype(jnp.float32)))


def test_gather_compact_op_keeps_feature_shape():
    x = torch.arange(24, dtype=torch.float32).reshape(6, 2, 2)
    mask = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.bool)
    s, ids, n = dispatch.gather_compact_op(x, mask, 6)
    assert s.shape == (6, 2, 2) and int(n) == 3
    np.testing.assert_array_equal(ids.numpy(), [1, 3, 4, -1, -1, -1])
    assert torch.equal(s[:3], x[[1, 3, 4]]) and torch.equal(s[3], x[0])


# ---------------------------------------------------------------------------
# fused dispatch: decision + compaction + in-ring scatter-merge
# ---------------------------------------------------------------------------

_RING_STATES = [(24, 0, 0), (24, 20, 5), (24, 7, 21), (8, 3, 8)]


def _case(seed, b=16, v=32, d=8):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3.0).astype(np.float32)
    payload = {"h": rng.standard_normal((b, d)).astype(np.float32),
               "cache": {"sid": rng.integers(0, 97, (b, 1), dtype=np.int32)},
               "step": rng.integers(0, 31, (b,), dtype=np.int32)}
    sample_ids = (np.arange(b, dtype=np.int32) * 3 + 1)
    active = rng.random(b) < 0.7
    return logits, payload, sample_ids, active


def _ring(seed, size, head, count, payload):
    rng = np.random.default_rng(seed)

    def junk(a):
        shape = (size,) + a.shape[1:]
        if a.dtype == np.float32:
            return rng.standard_normal(shape).astype(np.float32)
        return rng.integers(0, 89, shape, dtype=a.dtype)

    return {"data": {k: ({kk: junk(vv) for kk, vv in v.items()}
                         if isinstance(v, dict) else junk(v))
                     for k, v in payload.items()},
            "ids": rng.integers(-1, 50, (size,), dtype=np.int32),
            "head": np.int32(head % size), "count": np.int32(count)}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_ring_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_ring_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,head,count", _RING_STATES)
def test_fused_dispatch_matches_jax(size, head, count):
    logits, payload, sids, mask = _case(size * 7 + head * 3 + count)
    for c_thr in (0.0, 0.6, 1.1):
        for active in (None, mask):
            ring_np = _ring(5, size, head, count, payload)
            got = fused_dispatch_ref(
                torch.from_numpy(logits),
                None if active is None else torch.from_numpy(active),
                torch.from_numpy(sids), _to_torch(payload),
                _to_torch(ring_np), c_thr)
            for fn in (jx_fused, fused_dispatch_pallas):
                kw = {"interpret": True} if fn is fused_dispatch_pallas else {}
                want = fn(jnp.asarray(logits),
                          None if active is None else jnp.asarray(active),
                          jnp.asarray(sids), _to_jax(payload),
                          _to_jax(ring_np), c_thr, **kw)
                _assert_ring_equal(got[0], want[0])
                _check_decision(got[1:4], want[1:4], c_thr)
                for g, w in zip(got[4:], want[4:]):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("size,head,count", _RING_STATES)
def test_slot_map_scatter_equals_fused_ref(size, head, count):
    """The card's route (slot map + one scatter-merge per leaf) gives the
    ring the plain fused version gives; run here with the scatter-merge's
    plain version."""
    logits, payload, sids, mask = _case(size + head + count)
    ring_np = _ring(7, size, head, count, payload)
    want = fused_dispatch_ref(torch.from_numpy(logits), torch.from_numpy(mask),
                              torch.from_numpy(sids), _to_torch(payload),
                              _to_torch(ring_np), 0.6)
    ring = _to_torch(ring_np)
    hard = torch.from_numpy(mask) & ~want[1]
    src, n_hard = compact_src(hard)
    src_map, n_enq = slot_src_map(src, n_hard, ring["head"], ring["count"],
                                  size)
    tp = _to_torch(payload)
    for key in ("h", "step"):
        scatter_merge_ref(src_map, tp[key].reshape(16, -1),
                          ring["data"][key].view(size, -1))
    scatter_merge_ref(src_map, tp["cache"]["sid"], ring["data"]["cache"]["sid"])
    scatter_merge_ref(src_map, torch.from_numpy(sids)[:, None],
                      ring["ids"][:, None])
    ring["count"] = ring["count"] + n_enq
    _assert_ring_equal(ring, _np_tree(want[0]))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("p_hard", [0.0, 0.4, 1.0])
def test_compact_src_and_ring_offsets_match_jax(p_hard):
    rng = np.random.default_rng(int(p_hard * 10))
    hard = rng.random(20) < p_hard
    src, n_hard = compact_src(torch.from_numpy(hard))
    wsrc, wn = jx_compact_src(jnp.asarray(hard))
    np.testing.assert_array_equal(src.numpy(), np.asarray(wsrc))
    assert int(n_hard) == int(wn)
    for head, count, size in ((0, 0, 24), (20, 5, 24), (3, 8, 8)):
        idx, n_enq = ring_offsets(src, n_hard, torch.tensor(head),
                                  torch.tensor(count), size)
        widx, wenq = jx_ring_offsets(wsrc, wn, jnp.int32(head),
                                     jnp.int32(count), size)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
        assert int(n_enq) == int(wenq)


# ---------------------------------------------------------------------------
# routing: the CPU takes the plain versions, the kernels take CUDA only
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 8)
    mask = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        exit_decision_cuda(x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        gather_compact_cuda(x, mask, 2)
    with pytest.raises(ValueError, match="CUDA"):
        scatter_merge_cuda(torch.zeros(2, dtype=torch.int32), x, x.clone())
    assert exit_decision_cuda.launches == 0
    assert gather_compact_cuda.launches == 0
    assert scatter_merge_cuda.launches == 0


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        dispatch.exit_decision_op(torch.zeros(2, 8, device="meta"), 0.5)
