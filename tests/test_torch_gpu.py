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
