"""The port's prefill attention against the JAX package, on the CPU.

* ``layers.blocked_attention`` (the memory-bounded plain path) against JAX
  ``blocked_attention``, with several kv blocks, a ragged last block, a
  q offset and a window; its largest allocation grows with S, not S^2.
* The flash-attention kernel's plain version (``flash_attention/ref.py``,
  what the CUDA kernel is held against on the card) against the Pallas
  kernel run in interpret mode and against ``mha_ref``, at the JAX
  package's kernel-test shapes and at shard shapes (Sq < Sk, q offset > 0,
  fully masked rows).
* ``hints.attn_split`` against the JAX package's on the same meshes.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: ``blocked_attention`` fp32 1e-5 (the same arithmetic summed in
another order), bf16 3e-2 (p rounds to bf16 before the PV product, and a
rounding may land on either side); the flash kernel's plain version 2e-3,
bf16 3e-2, the JAX package's own kernel-test tolerances.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import mha_ref  # noqa: E402
from repro.models import hints as jx_hints  # noqa: E402
from repro.models import layers as jx_layers  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_ref)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import hints  # noqa: E402
from repro_torch.models import layers  # noqa: E402

FLASH_TOL = 2e-3
BF16_TOL = 3e-2


def _pair(rng, shape, dtype="float32"):
    a = rng.standard_normal(shape).astype(np.float32)
    j, t = jnp.asarray(a), torch.from_numpy(a)
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# blocked_attention (the repair of the port's unbounded prefill attention)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("q_offset", [0, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [512, 1100, 2048])
def test_blocked_attention_matches_jax(seq, dtype, q_offset, window):
    rng = np.random.default_rng(seq + q_offset)
    qj, qt = _pair(rng, (1, seq, 4, 32), dtype)
    kj, kt = _pair(rng, (1, seq, 2, 32), dtype)
    vj, vt = _pair(rng, (1, seq, 2, 32), dtype)
    got = layers.blocked_attention(qt, kt, vt, window=window,
                                   q_offset=q_offset)
    want = jx_layers.blocked_attention(qj, kj, vj, window=window,
                                       q_offset=q_offset)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_blocked_attention_softcap_and_small_blocks_match_jax():
    """Blocks smaller than the sequence on both axes, a ragged last block
    of each, softcap, and G = 3 query heads a kv head."""
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (2, 300, 6, 16))
    kj, kt = _pair(rng, (2, 300, 2, 16))
    vj, vt = _pair(rng, (2, 300, 2, 16))
    kw = dict(q_block=64, kv_block=96, softcap=5.0)
    np.testing.assert_allclose(
        _np(layers.blocked_attention(qt, kt, vt, **kw)),
        _np(jx_layers.blocked_attention(qj, kj, vj, **kw)),
        rtol=1e-5, atol=1e-5)


def _largest_allocation(seq: int) -> int:
    """Largest single CPU allocation (bytes) of one blocked_attention call
    at (1, seq, 4, 32) heads over 2 kv heads, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seq)
    q = torch.from_numpy(rng.standard_normal((1, seq, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, seq, 2, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, seq, 2, 32), np.float32))
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        layers.blocked_attention(q, k, v)
    return max(e.self_cpu_memory_usage for e in prof.events())


def test_blocked_attention_memory_grows_with_s_not_s_squared():
    """Doubling S at most doubles (and a bit) the largest allocation; one
    (S, S) fp32 score block per head group would quadruple it."""
    small, large = _largest_allocation(1024), _largest_allocation(2048)
    assert small > 0
    assert large / small <= 2.5, (small, large)
    # one (S, S) score block of the two query heads of a kv head at 2048
    assert large < 2 * 2048 * 2048 * 4


def test_attention_core_without_a_mesh_is_blocked_attention():
    rng = np.random.default_rng(2)
    _, q = _pair(rng, (2, 64, 4, 16))
    _, k = _pair(rng, (2, 64, 2, 16))
    _, v = _pair(rng, (2, 64, 2, 16))
    assert hints.mesh() is None
    got = attention.attention_core(q, k, v, causal=True, window=None,
                                   softcap=None, use_kernel=True)
    assert torch.equal(got, layers.blocked_attention(q, k, v))


# ---------------------------------------------------------------------------
# the flash-attention kernel's plain version
# ---------------------------------------------------------------------------

def _flash_inputs(rng, B, H, KH, Sq, Sk, D, dtype="float32"):
    """q (B, H, Sq, D), k, v (B, KH, Sk, D) for both packages."""
    return (_pair(rng, (B, H, Sq, D), dtype), _pair(rng, (B, KH, Sk, D), dtype),
            _pair(rng, (B, KH, Sk, D), dtype))


def _check_flash(ins, q_offset=0, window=None, tol=FLASH_TOL):
    (qj, qt), (kj, kt), (vj, vt) = ins
    got = flash_attention_ref(qt, kt, vt, q_offset, causal=True,
                              window=window)
    want = flash_attention_pallas(qj, kj, vj, q_offset, causal=True,
                                  window=window, interpret=True)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("seq", [64, 128, 200, 384])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (8, 1)])
def test_flash_plain_matches_pallas_and_mha_ref(seq, heads, kv_heads):
    rng = np.random.default_rng(seq + heads)
    ins = _flash_inputs(rng, 2, heads, kv_heads, seq, seq, 32)
    got = _check_flash(ins)
    (qj, _), (kj, _), (vj, _) = ins
    np.testing.assert_allclose(_np(got), _np(mha_ref(qj, kj, vj)),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_plain_window_matches_pallas(window):
    rng = np.random.default_rng(window)
    ins = _flash_inputs(rng, 1, 2, 2, 256, 256, 32)
    got = _check_flash(ins, window=window)
    (qj, _), (kj, _), (vj, _) = ins
    np.testing.assert_allclose(_np(got), _np(mha_ref(qj, kj, vj,
                                                     window=window)),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


def test_flash_plain_bf16_matches_pallas():
    rng = np.random.default_rng(7)
    _check_flash(_flash_inputs(rng, 1, 2, 2, 128, 128, 64, "bfloat16"),
                 tol=BF16_TOL)


def test_flash_plain_vs_naive_softmax():
    """Independent oracle: the materialized softmax, in numpy."""
    rng = np.random.default_rng(3)
    (_, qt), (_, kt), (_, vt) = _flash_inputs(rng, 1, 2, 2, 128, 128, 16)
    q, k, v = qt.numpy(), kt.numpy(), vt.numpy()
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(16.0)
    s = np.where(np.tril(np.ones((128, 128), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    naive = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(flash_attention_ref(qt, kt, vt).numpy(),
                               naive, rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,q_offset,window,dtype", [
    (1, 4, 2, 128, 256, 32, 128, None, "float32"),    # seq shard 2 of 2
    (2, 6, 2, 64, 256, 16, 64, None, "float32"),      # shard 2 of 4
    (1, 4, 2, 100, 300, 64, 200, 64, "float32"),      # ragged, windowed
    (1, 6, 2, 128, 512, 128, 384, None, "bfloat16"),  # qwen2 heads, last
    (2, 8, 1, 96, 192, 32, 96, 40, "bfloat16"),
])
def test_flash_plain_shard_shapes_match_pallas(B, H, KH, Sq, Sk, D, q_offset,
                                               window, dtype):
    rng = np.random.default_rng(Sq + Sk + q_offset)
    ins = _flash_inputs(rng, B, H, KH, Sq, Sk, D, dtype)
    _check_flash(ins, q_offset, window,
                 FLASH_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("q_offset", [256, 100])
def test_flash_plain_fully_masked_rows_are_zero(q_offset):
    """Queries past the keys with a window: q_offset + row - (Sk - 1) >=
    window leaves a row no key; it outputs 0 (at offset 256 every row, at
    100 rows 59 on), as the Pallas kernel does."""
    rng = np.random.default_rng(q_offset)
    ins = _flash_inputs(rng, 1, 4, 2, 64, 128, 32)
    got = _check_flash(ins, q_offset, window=32)
    masked = torch.from_numpy(q_offset + np.arange(64) - 127 >= 32)
    assert masked.any()
    assert not got[:, :, masked].any()
    assert bool((got[:, :, ~masked].abs().sum(-1) > 0).all())


def test_flash_dispatch_picks_by_device():
    """A CPU tensor takes the plain version; the kernel wrapper takes CUDA
    tensors only and raises on a CPU one."""
    rng = np.random.default_rng(9)
    (_, qt), (_, kt), (_, vt) = _flash_inputs(rng, 1, 4, 2, 64, 64, 16)
    assert torch.equal(dispatch.flash_attention(qt, kt, vt, 0, causal=True,
                                                window=None),
                       flash_attention_ref(qt, kt, vt))
    before = dict(flash_attention_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(qt, kt, vt)
    assert flash_attention_cuda.launches == before


def test_flash_kernel_chunk_alignment():
    """The bf16 kernel copies 16-byte chunks. The wrapper hands it the
    model's (B, S, H, D) activations and their sequence shards as they
    are, and a contiguous copy, equal in value, of a view whose base or
    whose stride along a dim of more than one element is not a multiple of
    16 bytes."""
    from repro_torch.kernels.flash_attention.kernel import _chunk_aligned
    bf = torch.bfloat16
    x = torch.zeros(2, 100, 12, 128, dtype=bf).transpose(1, 2)
    shard = x[:, :, 50:]
    one = torch.zeros(64, dtype=bf).as_strided((1, 1, 4, 16), (7, 5, 16, 1))
    for t in (x, shard, one):
        assert _chunk_aligned(t) is t
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.standard_normal((2, 100, 6, 72),
                                               dtype=np.float32)).to(bf)
    kv = torch.from_numpy(rng.standard_normal((2, 100, 4, 68),
                                              dtype=np.float32)).to(bf)
    for t in (big[..., 1:65].transpose(1, 2),          # base 2 bytes off
              kv[:, :, :2, :64].transpose(1, 2),       # head stride 136 B
              kv[:, :, 2:, :64].transpose(1, 2)):      # and base 136 B off
        a = _chunk_aligned(t)
        assert a is not t and torch.equal(a, t)
        assert a.data_ptr() % 16 == 0 and a.is_contiguous()


# ---------------------------------------------------------------------------
# attn_split
# ---------------------------------------------------------------------------

def _duck_mesh(shape):
    axes = ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4), (1, 1), (4, 1)])
def test_attn_split_matches_jax(shape):
    """The same kind and batch axes as the JAX package's hints over a
    table of (B, S), on a duck-typed mesh that both read."""
    m = _duck_mesh(shape)
    table = [(b, s) for b in (1, 2, 3, 4, 8, 16, 32)
             for s in (64, 128, 200, 256, 512, 1024, 4096)]
    kinds = set()
    for b, s in table:
        with jx_hints.use_mesh(m):
            want = jx_hints.attn_split(s, b)
            want_sp = jx_hints.sp_axis(s, b)
            want_ax = jx_hints.batch_axes()
        with hints.use_mesh(m):
            got = hints.attn_split(s, b)
            assert hints.sp_axis(s, b) == want_sp
            assert hints.batch_axes() == want_ax
        assert got == want, (shape, b, s)
        kinds.add(None if got is None else got[0])
    assert hints.mesh() is None
    if shape[1] > 1:
        assert kinds == {"batch", "seq", None}
    else:
        assert kinds == {None}
