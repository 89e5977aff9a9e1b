"""Ambient distribution hints for model code (the port of
``repro/models/hints.py``).

The model code is mesh-agnostic; a cell builder (``launch/steps.py``)
publishes a mesh here (``launch/mesh.make_mesh``) so that attention can
split its work over the ranks when the mesh supports it. With no mesh set
(one device, the tests) every hint is a no-op. A mesh is anything with a
``shape`` mapping of axis name to size and ``axis_names``, as in the JAX
package. A mesh is published only for the span of a ``use_mesh`` block:
the JAX package's ``set_mesh`` (a global setter) and the switch of its
``use_mesh`` that turns the split attention off have no caller here.

Activations stay whole on every rank: the JAX package's ``constrain_seq``
(a sharding constraint on the residual stream) is not ported
(ROADMAP.md, Queue 1, item 6).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

_MESH = None


def mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(m):
    global _MESH
    old = _MESH
    _MESH = m
    try:
        yield
    finally:
        _MESH = old


def batch_axes() -> Tuple[str, ...]:
    if _MESH is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in _MESH.axis_names)


def sp_axis(seq_len: int, batch: int) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """If sequence-parallel attention applies: ("model", batch axes).
    Conditions: a 'model' axis of size > 1 exists, it divides S, each shard
    keeps at least 128 rows, and the batch divides the batch axes kept."""
    if _MESH is None:
        return None
    names = _MESH.axis_names
    if "model" not in names:
        return None
    m = _MESH.shape["model"]
    if m <= 1 or seq_len % m != 0 or seq_len // m < 128:
        return None
    return "model", _fit_batch_axes(batch)


def _fit_batch_axes(batch: int) -> Tuple[str, ...]:
    """Largest batch-axis subset whose size divides the batch (all batch
    axes, then each alone from the largest, then none)."""
    axes = batch_axes()
    cands = [axes] + [(a,) for a in sorted(
        axes, key=lambda a: -_MESH.shape[a])] + [()]
    for c in cands:
        nb = 1
        for a in c:
            nb *= _MESH.shape[a]
        if nb and batch % nb == 0:
            return c
    return ()


def attn_split(seq_len: int, batch: int):
    """How to split attention over the mesh:
      ("batch", baxes)  -- the batch divides (baxes + model): each rank
                           takes whole sequences, no K/V exchange;
      ("seq", baxes)    -- query rows split over 'model' with K/V whole,
                           each shard at its q offset (long prefill);
      None              -- one device, or a mesh too small: plain path.
    """
    if _MESH is None or "model" not in _MESH.axis_names:
        return None
    m = _MESH.shape["model"]
    if m <= 1:
        return None
    baxes = _fit_batch_axes(batch)
    nb = 1
    for a in baxes:
        nb *= _MESH.shape[a]
    if batch % max(nb * m, 1) == 0 and batch >= nb * m:
        return ("batch", baxes)
    sp = sp_axis(seq_len, batch)
    if sp is not None:
        return ("seq", sp[1])
    return None
