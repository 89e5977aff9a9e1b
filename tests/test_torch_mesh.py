"""The port's mesh prefill path against the JAX package on one device, on
the CPU: ``gloo`` ranks in fresh processes, one spawn per mesh shape.

Each rank builds the mesh (``launch/mesh.make_mesh``), checks by checksum
that every rank holds the same params, runs ``attention_core`` under the
mesh (the batch kind at B 4, the seq kind at B 1 x S 256, the shapes of
the JAX package's mesh attention test) and the prefill cell
(``launch/steps.make_prefill_cell``) on ``tiny_cfg`` at B 4 x S 64 (the
batch kind) and B 1 x S 256 (the seq kind), and writes what it got. The
test holds each rank against JAX ``blocked_attention`` and JAX
``serve_batch`` on one device, and the ranks against each other.

The rank bodies import neither JAX nor the JAX package; this module
imports JAX inside its tests only, so that a spawned rank, which imports
the module to find its function, stays light.

Tolerances: attention fp32 1e-5; logits rtol 1e-5 / atol 2e-5 (fp32, the
same arithmetic summed in another order); exit masks, n_hard and overflow
exactly, on thresholds set at least ``MARGIN`` off every row's
|c_thr * s - 1|; every rank's result identical to rank 0's.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M  # noqa: E402

MARGIN = 1e-4
P = 0.25        # the hard-sample probability the stage-2 capacity is set for
RTOL, ATOL = 1e-5, 2e-5
ATTN = {"batch": (4, 256), "seq": (1, 256)}      # (B, S), H 6, KH 2, D 32
CELLS = {"batch": (4, 64), "seq": (1, 256)}      # tiny_cfg tokens (B, S)
TIMEOUT_S = 180


def _rank_body(rank, world, shape, out_dir, cfg_fields, np_params, attn_in,
               cells):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core import early_exit as ee
    from repro_torch.launch import steps
    from repro_torch.models import attention, hints
    from repro_torch.models.config import ArchConfig

    # one thread a rank: the ranks share the cores, and the first call of
    # a vectorized op (exp) on several threads of a contended CPU has come
    # out up to 1e-4 off its later calls in this torch build
    torch.set_num_threads(1)
    mesh = M.make_mesh(shape, ("data", "model"))
    cfg = ArchConfig(**cfg_fields)
    params = params_from_numpy(np_params, "cpu")
    steps.assert_replicated(params)
    res = {"checksum": steps.params_checksum(params).numpy(),
           "coords": np.array([mesh.coords["data"], mesh.coords["model"]])}
    for name, (q, k, v) in attn_in.items():
        with hints.use_mesh(mesh):
            res[f"attn_kind_{name}"] = np.array(
                hints.attn_split(q.shape[1], q.shape[0])[0])
            o = attention.attention_core(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                causal=True, window=None, softcap=None)
        res[f"attn_{name}"] = o.numpy()
    for name, (toks, exit_layer, c_thr) in cells.items():
        spec = ee.EarlyExitSpec(exit_layer=exit_layer, c_thr=c_thr)
        cell = steps.make_prefill_cell(cfg, mesh, seq_len=toks.shape[1],
                                       global_batch=toks.shape[0], p=P,
                                       spec=spec)
        with hints.use_mesh(mesh):
            res[f"cell_kind_{name}"] = np.array(
                hints.attn_split(toks.shape[1], toks.shape[0])[0])
        out = cell.step_fn(params, torch.from_numpy(toks))
        for key, val in out.items():
            res[f"cell_{name}_{key}"] = val.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)],
                ids=lambda s: f"mesh{s[0]}x{s[1]}")
def mesh_run(request, tmp_path_factory, tiny_cfg):
    """Spawn the ranks of one mesh shape once; return (shape, per-rank
    results, the inputs, the JAX references)."""
    import jax
    import jax.numpy as jnp
    from repro.core import early_exit as jx_ee
    from repro.core import exit_decision as jx_ed
    from repro.core.stage_mesh import stage2_capacity
    from repro.models import layers as jx_layers

    shape = request.param
    rng = np.random.default_rng(17)
    attn_in, attn_ref = {}, {}
    for name, (B, S) in ATTN.items():
        q = rng.standard_normal((B, S, 6, 32)).astype(np.float32)
        k = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
        v = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
        attn_in[name] = (q, k, v)
        attn_ref[name] = np.asarray(jx_layers.blocked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))

    jspec0 = jx_ee.EarlyExitSpec(exit_layer=2, c_thr=0.5)
    jparams = jx_ee.init_ee_params(jax.random.PRNGKey(0), tiny_cfg, jspec0)
    cells, cell_ref = {}, {}
    for name, (B, S) in CELLS.items():
        toks = rng.integers(0, tiny_cfg.vocab, (B, S), dtype=np.int32)
        _, _, jlog, _ = jx_ee.stage1_prefill(jparams, tiny_cfg, jspec0,
                                             jnp.asarray(toks))
        conf = np.sort(np.asarray(jx_ed.softmax_confidence(jlog),
                                  np.float64))
        # B 4: a midpoint between neighbouring confidences, the one farthest
        # from every row, so some rows exit and some go on; B 1: twice the
        # row's confidence, so it goes to stage 2
        c_thr = float(conf[0] * 2) if B == 1 else float(
            max(((conf[i] + conf[i - 1]) / 2 for i in range(1, B)),
                key=lambda c: min(abs(c / x - 1) for x in conf)))
        assert all(abs(c_thr / x - 1) > MARGIN for x in conf)
        spec = jx_ee.EarlyExitSpec(exit_layer=2, c_thr=c_thr)
        want = jx_ee.serve_batch(jparams, tiny_cfg, spec, jnp.asarray(toks),
                                 capacity=stage2_capacity(B, P))
        cells[name] = (toks, 2, c_thr)
        cell_ref[name] = {k: np.asarray(want[k]) for k in
                          ("logits", "exit_mask", "n_hard", "overflow")}

    out_dir = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
    cfg_fields = {f.name: getattr(tiny_cfg, f.name)
                  for f in dataclasses.fields(tiny_cfg)}
    np_params = jax.tree.map(np.asarray, jparams)
    world = shape[0] * shape[1]
    M.run_ranks(_rank_body, world, backend="gloo",
                args=(shape, str(out_dir), cfg_fields, np_params, attn_in,
                      cells),
                timeout_s=TIMEOUT_S, init_timeout_s=60,
                rdzv_dir=str(out_dir))
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
    return shape, ranks, attn_ref, cell_ref


def test_ranks_hold_the_same_params_and_their_coordinates(mesh_run):
    shape, ranks, _, _ = mesh_run
    for r in ranks:
        np.testing.assert_array_equal(r["checksum"], ranks[0]["checksum"])
    coords = [tuple(r["coords"]) for r in ranks]
    assert coords == [np.unravel_index(i, shape) for i in range(len(ranks))]


@pytest.mark.parametrize("kind", sorted(ATTN))
def test_attention_core_on_mesh_matches_jax(mesh_run, kind):
    _, ranks, attn_ref, _ = mesh_run
    for r in ranks:
        assert str(r[f"attn_kind_{kind}"]) == kind
        np.testing.assert_allclose(r[f"attn_{kind}"], attn_ref[kind],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r[f"attn_{kind}"],
                                      ranks[0][f"attn_{kind}"])


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_prefill_cell_on_mesh_matches_jax_serve_batch(mesh_run, kind):
    _, ranks, _, cell_ref = mesh_run
    want = cell_ref[kind]
    for r in ranks:
        assert str(r[f"cell_kind_{kind}"]) == kind
        np.testing.assert_array_equal(r[f"cell_{kind}_exit_mask"],
                                      want["exit_mask"])
        assert int(r[f"cell_{kind}_n_hard"]) == int(want["n_hard"])
        assert int(r[f"cell_{kind}_overflow"]) == int(want["overflow"])
        np.testing.assert_allclose(r[f"cell_{kind}_logits"], want["logits"],
                                   rtol=RTOL, atol=ATOL)
        for key in ("logits", "exit_mask", "n_hard", "overflow"):
            np.testing.assert_array_equal(r[f"cell_{kind}_{key}"],
                                          ranks[0][f"cell_{kind}_{key}"])
    # the batch cell exits some rows and sends the others to stage 2; the
    # seq cell's one row runs stage 2 under the seq split too
    assert 0 < int(want["n_hard"]) < CELLS[kind][0] or kind == "seq"
    assert kind != "seq" or int(want["n_hard"]) == 1


def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    import torch.distributed as dist
    dist.barrier()                      # rank 0 waits for a rank that died


def test_run_ranks_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(RuntimeError, match=r"rank\(s\) failed"):
        M.run_ranks(_fail_on_rank_1, 2, backend="gloo", timeout_s=60,
                    init_timeout_s=30, rdzv_dir=str(tmp_path))


def _sleep(rank, world):
    import time
    time.sleep(120)


def test_run_ranks_kills_ranks_past_its_limit(tmp_path):
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        M.run_ranks(_sleep, 2, backend="gloo", timeout_s=10,
                    init_timeout_s=30, rdzv_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60
    assert not list(tmp_path.iterdir())          # rendezvous dir removed


def test_cells_not_ported_raise(tiny_cfg):
    from repro_torch.launch import steps
    for kind in ("train", "decode"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            steps.make_cell(tiny_cfg, None, {"kind": kind, "seq_len": 8,
                                             "global_batch": 4})
