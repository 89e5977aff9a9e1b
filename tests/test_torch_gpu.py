"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is false
(decided inside the test, never at import). On a machine with an NVIDIA GPU
and the CUDA toolkit run

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the shared conftest imports JAX, which such a machine
need not have). Integers, ids, rings and copied rows must match exactly;
``conf`` within rtol 1e-5 (fp32 sums in another order); decisions exactly
off the 1e-4 margin.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import early_exit as ee  # noqa: E402
from repro_torch.configs.archs import ARCHS, smoke_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.exit_decision import (exit_decision_cuda,  # noqa: E402
                                               exit_decision_ref)
from repro_torch.kernels.fused_dispatch import (fused_dispatch_cuda,  # noqa: E402
                                                fused_dispatch_ref)
from repro_torch.kernels.gather_compact import (gather_compact_cuda,  # noqa: E402
                                                gather_compact_ref)
from repro_torch.runtime import serve_api  # noqa: E402
from repro_torch.runtime import serve_loop as SL  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,vocab,dtype", [
    (32, 151936, torch.float32), (7, 4097, torch.bfloat16),
    (3, 100, torch.float16), (1, 8, torch.float32)])
def test_exit_decision_kernel(cuda, rows, vocab, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = (torch.randn(rows, vocab, generator=g, device=cuda) * 4).to(dtype)
    x[:, 0] = x[:, vocab - 1] = x.max(dim=1).values + 1   # tie: first wins
    for c_thr in (1e-9, 0.3, 0.9, 1.0):
        e, p, c = exit_decision_cuda(x, c_thr)
        we, wp, wc = exit_decision_ref(x, c_thr)
        assert torch.equal(p, wp) and bool((p == 0).all())
        torch.testing.assert_close(c, wc, rtol=1e-5, atol=0)
        clear = (np.float32(c_thr) / wc.double() - 1).abs() > 1e-4
        assert torch.equal(e[clear], we[clear])


@pytest.mark.parametrize("batch,feat,cap,dtype", [
    (32, 98304, 32, torch.bfloat16), (32, 98304, 4, torch.bfloat16),
    (64, 5, 64, torch.int32), (7, 33, 3, torch.bfloat16),
    (1000, 3, 100, torch.uint8)])
def test_gather_compact_kernel(cuda, batch, feat, cap, dtype):
    g = torch.Generator(device=cuda).manual_seed(batch)
    x = torch.randint(0, 100, (batch, feat), generator=g,
                      device=cuda).to(dtype)
    for p_hard in (0.0, 0.3, 1.0):
        mask = torch.rand(batch, generator=g, device=cuda) < p_hard
        got = gather_compact_cuda(x, mask, cap)
        want = gather_compact_ref(x, mask, cap)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("size,head,count", [(24, 0, 0), (24, 20, 5),
                                             (24, 7, 21), (8, 3, 8)])
def test_fused_dispatch_kernels(cuda, size, head, count):
    g = torch.Generator(device=cuda).manual_seed(size + head + count)
    logits = torch.randn(16, 64, generator=g, device=cuda) * 6
    payload = {"h": torch.randn(16, 3, 8, generator=g, device=cuda)
               .to(torch.bfloat16),
               "n": torch.randint(0, 9, (16,), generator=g, device=cuda,
                                  dtype=torch.int32)}
    active = torch.rand(16, generator=g, device=cuda) < 0.7
    sids = torch.arange(16, dtype=torch.int32, device=cuda) * 3 + 1

    def ring():
        return {"data": {"h": torch.ones(size, 3, 8, dtype=torch.bfloat16,
                                         device=cuda),
                         "n": torch.full((size,), 5, dtype=torch.int32,
                                         device=cuda)},
                "ids": torch.full((size,), -1, dtype=torch.int32,
                                  device=cuda),
                "head": torch.tensor(head, dtype=torch.int32, device=cuda),
                "count": torch.tensor(count, dtype=torch.int32,
                                      device=cuda)}

    got = fused_dispatch_cuda(logits, active, sids, payload, ring(), 0.3)
    want = fused_dispatch_ref(logits, active, sids, payload, ring(), 0.3)
    clear = (np.float32(0.3) / want[3].double() - 1).abs() > 1e-4
    if not bool(clear.all()):
        pytest.skip("a row sits on the decision margin")
    for a, b in ((got[0]["data"]["h"], want[0]["data"]["h"]),
                 (got[0]["data"]["n"], want[0]["data"]["n"]),
                 (got[0]["ids"], want[0]["ids"]),
                 (got[0]["count"], want[0]["count"]),
                 (got[1], want[1]), (got[2], want[2]), (got[4], want[4]),
                 (got[5], want[5])):
        assert torch.equal(a, b)


def test_server_on_card_matches_host_loop(cuda):
    """All-exit and all-hard thresholds (no row near the margin): the
    device server equals the host loop bit for bit, and every kernel of
    the path launched."""
    cfg = smoke_config(ARCHS["qwen2-1.5b"])
    spec0 = ee.default_spec(cfg)
    params = ee.init_ee_params(cfg, spec0,
                               torch.Generator(device=cuda).manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (24, 8),
                                             dtype=np.int32)
    for c_thr in (0.0, 1.0):
        spec = ee.EarlyExitSpec(exit_layer=spec0.exit_layer, c_thr=c_thr)
        sc = SL.ServeConfig(capacity=4, queue_depth=1, c_thr=c_thr)
        before = dispatch.exit_decision_cuda.launches
        dev_res = SL.serve_dataset(serve_api.build(params, cfg, spec, sc,
                                                   device=cuda), toks, 8)
        assert dispatch.exit_decision_cuda.launches == before + 3
        host_res = SL.serve_dataset(serve_api.build(
            params, cfg, spec, sc, host=True, device=cuda), toks, 8)
        assert set(dev_res) == set(host_res) == set(range(24))
        for sid in range(24):
            np.testing.assert_array_equal(dev_res[sid], host_res[sid])


@pytest.mark.parametrize("B,M,page,F,dtype", [
    (16, 8, 16, 256, torch.bfloat16),     # the serving path's shapes
    (4, 3, 4, 16, torch.float32), (3, 5, 2, 7, torch.bfloat16),
    (2, 2, 8, 3, torch.float32)])
def test_paged_gather_append_kernel(cuda, B, M, page, F, dtype):
    from repro_torch.kernels.paged_attention import (
        paged_gather_append_cuda, paged_gather_append_ref)
    g = torch.Generator(device=cuda).manual_seed(B * M + page)
    P = 1 + B * M + 2
    pools = [torch.randn(P, page, F, generator=g, device=cuda).to(dtype)
             for _ in range(2)]
    for p in pools:
        p[0] = 0
    new = [torch.randn(B, F, generator=g, device=cuda).to(dtype)
           for _ in range(2)]
    bt = (1 + torch.randperm(P - 1, generator=g, device=cuda)[:B * M]
          ).reshape(B, M).to(torch.int32)
    bt[0, M - 1] = 0                                  # a NULL tail entry
    bt[B - 1, 0] = bt[0, 0]                           # a page two rows read
    pos = torch.randint(0, M * page, (B,), generator=g, device=cuda,
                        dtype=torch.int32)
    pos[0] = (M - 1) * page + 1                       # appends into NULL
    if B > 2:
        pos[1] = M * page                             # the sentinel
    got = paged_gather_append_cuda(pools[0].clone(), pools[1].clone(),
                                   new[0], new[1], bt, pos)
    want = paged_gather_append_ref(pools[0].clone(), pools[1].clone(),
                                   new[0], new[1], bt, pos)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not got[2][0].any() and not got[3][0].any()


def test_paged_decode_server_on_card(cuda):
    """Smoke-size qwen2-1.5b: the paged DecodeServer equals the dense one
    and the host loop bit for bit, and launches the paged kernel once per
    stage-2 layer of every bucket."""
    from repro_torch.kernels.paged_attention import paged_gather_append_cuda
    cfg = smoke_config(ARCHS["qwen2-1.5b"])
    spec0 = ee.default_spec(cfg)
    params = ee.init_ee_params(cfg, spec0,
                               torch.Generator(device=cuda).manual_seed(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (6, 8),
                                               dtype=np.int32)
    spec = ee.EarlyExitSpec(exit_layer=spec0.exit_layer, c_thr=1.1)
    sc = SL.ServeConfig(capacity=4, queue_depth=1, c_thr=1.1)
    dense = serve_api.build(params, cfg, spec, sc, mode="decode",
                            device=cuda).generate(prompt, 8)
    before = paged_gather_append_cuda.launches
    srv = serve_api.build(params, cfg, spec, sc, mode="decode", page_size=4,
                          device=cuda)
    paged = srv.generate(prompt, 8)
    n_layers2 = cfg.n_layers - spec.exit_layer
    assert paged_gather_append_cuda.launches - before == \
        srv.stats.n_buckets * n_layers2
    host = serve_api.build(params, cfg, spec, sc, mode="decode", host=True,
                           device=cuda).generate(prompt, 8)
    for out in (dense, host):
        np.testing.assert_array_equal(out["tokens"], paged["tokens"])
        np.testing.assert_array_equal(out["logits"], paged["logits"])


# the flash kernel against its plain version: (rtol, atol) by dtype
FLASH_TOL = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,q_offset,window,dtype", [
    (4, 12, 2, 256, 256, 128, 0, None, torch.bfloat16),   # batch shard
    (1, 12, 2, 512, 1024, 128, 512, None, torch.bfloat16),  # seq shard
    (2, 4, 2, 200, 200, 64, 0, None, torch.float32),      # ragged tiles
    (1, 8, 1, 130, 130, 32, 0, 40, torch.float32),        # window
    (2, 6, 3, 70, 140, 16, 70, 33, torch.bfloat16),
    (1, 4, 2, 64, 128, 32, 256, 32, torch.float32),       # all rows masked
    (1, 4, 2, 64, 128, 32, 100, 32, torch.float32),       # rows 59.. masked
    (2, 8, 2, 96, 224, 32, 128, None, torch.bfloat16),    # bf16 D 32
    (2, 12, 2, 256, 256, 64, 0, None, torch.bfloat16),    # bf16 D 64
    (1, 12, 2, 201, 201, 128, 0, None, torch.bfloat16),   # 1206 rows: ragged
    (1, 12, 2, 300, 300, 64, 0, 100, torch.bfloat16),     # window mid-tile
    (1, 6, 1, 128, 512, 128, 384, 72, torch.bfloat16),    # and at an offset
    (1, 4, 2, 64, 128, 32, 100, 32, torch.bfloat16)])     # rows 59.. masked
def test_flash_attention_kernel(cuda, B, H, KH, Sq, Sk, D, q_offset, window,
                                dtype):
    """Against the plain version; q, k, v as strided (B, S, heads, D)
    views, as the model hands them over. Both sum in fp32 and differ in
    the order of the sums (in bf16 the kernel's products are exact bf16
    products on the tensor cores, p split into two bf16 halves): fp32
    within 2e-5; bf16 adds one rounding of the output, so each element
    within 2^-7 |want| (one bf16 ulp) + 1e-4. fp32 launches the FMA
    kernel and bf16 the tensor-core one, as the per-kernel counts show."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + q_offset)
    q, k, v = (torch.randn(B, s, n, D, generator=g, device=cuda).to(dtype)
               .transpose(1, 2) for s, n in ((Sq, H), (Sk, KH), (Sk, KH)))
    sym = "flash_fwd_mma" if dtype == torch.bfloat16 else "flash_fwd"
    before = dict(flash_attention_cuda.launches)
    got = flash_attention_cuda(q, k, v, q_offset, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == {**before, sym: before[sym] + 1}
    want = flash_attention_ref(q, k, v, q_offset, causal=True, window=window)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    masked = q_offset + torch.arange(Sq, device=cuda) - (Sk - 1) >= (
        window or Sk + Sq + q_offset)
    assert not got[:, :, masked].any()


@pytest.mark.parametrize("S,window", [(512, None), (200, None), (200, 50)])
def test_flash_attention_seq_split_bitwise(cuda, S, window):
    """bf16: the query rows split in two launches, at offsets 0 and S/2
    against all the keys (the mesh's sequence split), equal the same rows
    of one unsplit launch bit for bit, also where S/2 x 6 rows is not a
    multiple of the kernel's 64-row blocks (S 200)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(2, S, n, 128, generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2) for n in (12, 2, 2))
    whole = flash_attention_cuda(q, k, v, 0, window=window)
    h = S // 2
    lo = flash_attention_cuda(q[:, :, :h], k, v, 0, window=window)
    hi = flash_attention_cuda(q[:, :, h:], k, v, h, window=window)
    torch.cuda.synchronize()
    assert torch.equal(lo, whole[:, :, :h])
    assert torch.equal(hi, whole[:, :, h:])


def test_flash_attention_kernel_unaligned_views(cuda):
    """bf16 views whose base or strides are not 16-byte multiples (the
    kernel copies 16-byte chunks) give what contiguous inputs give."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device=cuda).manual_seed(2)
    big, kv = (torch.randn(2, 100, n, w, generator=g, device=cuda).to(
        torch.bfloat16) for n, w in ((6, 72), (4, 68)))
    q = big[..., 1:65].transpose(1, 2)            # base 2 bytes off
    k = kv[:, :, :2, :64].transpose(1, 2)         # head stride 136 bytes
    v = kv[:, :, 2:, :64].transpose(1, 2)         # and base 136 bytes off
    got = flash_attention_cuda(q, k, v, 0)
    want = flash_attention_cuda(*(t.contiguous() for t in (q, k, v)), 0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _mesh_rank(rank, world, out_dir):
    """A (data 1, model 2) mesh of two ranks on cuda:0: attention_core by
    batch and by query rows through the kernel, saved for the test."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import mesh as M
    from repro_torch.models import attention, hints
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = M.make_mesh((1, world), ("data", "model"))
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (B, S) in (("batch", (4, 256)), ("seq", (1, 512))):
        q = torch.randn(B, S, 12, 128, generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn(B, S, 2, 128, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        with hints.use_mesh(mesh):
            kind = hints.attn_split(S, B)[0]
            before = sum(flash_attention_cuda.launches.values())
            o = attention.attention_core(q, k, v, causal=True, window=None,
                                         softcap=None, use_kernel=True)
        torch.cuda.synchronize()
        out[name] = (kind,
                     sum(flash_attention_cuda.launches.values()) - before,
                     o.cpu(), q.cpu(), k.cpu(), v.cpu())
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def test_two_rank_gloo_mesh_on_one_card(cuda, tmp_path):
    """Two gloo ranks share the card: each runs its shard through the
    kernel once and both gather the same whole output, which equals the
    kernel's plain version on the whole input."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as M
    _build.library()                    # built once, before the ranks
    M.run_ranks(_mesh_rank, 2, backend="gloo", args=(str(tmp_path),),
                timeout_s=300, init_timeout_s=120, rdzv_dir=str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for name in ("batch", "seq"):
        kind, launches, o, q, k, v = ranks[0][name]
        assert kind == name
        want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)
        rtol, atol = FLASH_TOL[torch.bfloat16]
        torch.testing.assert_close(o.float(), want.float(), rtol=rtol,
                                   atol=atol)
        for r in ranks:
            assert r[name][0] == name and r[name][1] == 1
            assert torch.equal(r[name][2], o)
