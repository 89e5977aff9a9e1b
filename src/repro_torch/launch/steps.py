"""Cell builders (the port of ``repro/launch/steps.py``, the prefill cell).

A cell is one (arch x shape kind) step function over a mesh
(``launch/mesh.make_mesh``). The port builds the prefill cell: the whole
ATHEENA pipeline of ``core/early_exit.serve_batch`` (stage 1, the exit
decision, conditional-buffer compaction, stage 2 on the hard slab, the
exit merge) with the mesh published to ``models/hints``, so that attention
splits over the ranks and runs its shards through the flash-attention
kernel. Params and tokens are whole on every rank (no FSDP: the JAX
package's ``launch/shardings.py`` is not ported), every rank computes the
same result, and the train and decode cells are not ported (ROADMAP.md,
Queue 1, item 6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core import early_exit as ee
from repro_torch.core.stage_mesh import stage2_capacity
from repro_torch.models import hints
from repro_torch.models.config import ArchConfig

PAPER_P = 0.25          # design-time hard-sample probability (paper IV-A)


@dataclass
class Cell:
    name: str
    kind: str
    step_fn: Callable
    meta: Dict[str, Any] = field(default_factory=dict)


def make_prefill_cell(cfg: ArchConfig, mesh, *, seq_len: int,
                      global_batch: int, p: float = PAPER_P,
                      spec: Optional[ee.EarlyExitSpec] = None) -> Cell:
    """``step_fn(params, tokens (global_batch, seq_len) int)`` runs
    ``serve_batch`` at the stage-2 capacity provisioned for ``p`` with the
    mesh published, and returns {logits, exit_mask, n_hard, overflow}."""
    spec = spec or ee.default_spec(cfg)
    capacity = stage2_capacity(global_batch, p)

    def serve_prefill(params, tokens: torch.Tensor):
        if tuple(tokens.shape) != (global_batch, seq_len):
            raise ValueError(f"prefill cell takes tokens ({global_batch}, "
                             f"{seq_len}), got {tuple(tokens.shape)}")
        with hints.use_mesh(mesh):
            out = ee.serve_batch(params, cfg, spec, tokens,
                                 capacity=capacity)
        return {"logits": out["logits"], "exit_mask": out["exit_mask"],
                "n_hard": out["n_hard"], "overflow": out["overflow"]}

    return Cell(name=cfg.name, kind="prefill", step_fn=serve_prefill,
                meta={"capacity": capacity, "exit_layer": spec.exit_layer,
                      "seq_len": seq_len, "global_batch": global_batch})


def make_train_cell(cfg: ArchConfig, mesh, **kw) -> Cell:
    raise NotImplementedError(
        "the train cell is not ported: ROADMAP.md Queue 1, item 6 (the "
        "mesh: shardings, FSDP, make_train_cell) and item 10 (training)")


def make_decode_cell(cfg: ArchConfig, mesh, **kw) -> Cell:
    raise NotImplementedError(
        "the decode cell is not ported: ROADMAP.md Queue 1, item 6 (the "
        "mesh: make_decode_cell)")


def make_cell(cfg: ArchConfig, mesh, shape: Dict[str, Any], **kw) -> Cell:
    kind = shape["kind"]
    builders = {"train": make_train_cell, "prefill": make_prefill_cell,
                "decode": make_decode_cell}
    if kind not in builders:
        raise ValueError(kind)
    return builders[kind](cfg, mesh, seq_len=shape["seq_len"],
                          global_batch=shape["global_batch"], **kw)


def params_checksum(params) -> torch.Tensor:
    """(sum, sum of squares) of every floating leaf in float64, on the
    leaves' device: equal on two ranks whose params are equal."""
    acc = None
    for t in _leaves(params):
        if not t.is_floating_point():
            continue
        x = t.double()
        part = torch.stack([x.sum(), (x * x).sum()])
        acc = part if acc is None else acc + part
    return acc


def assert_replicated(params, group=None) -> None:
    """Raise unless every rank of ``group`` (default: the world) holds the
    same params, by checksum."""
    mine = params_checksum(params)
    world = dist.get_world_size(group)
    all_ = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(all_, mine, group=group)
    if any(not torch.equal(a, all_[0]) for a in all_):
        raise RuntimeError(f"params differ across ranks: checksums "
                           f"{[a.tolist() for a in all_]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree
