"""Device meshes over a ``torch.distributed`` process group (the port of
``repro/launch/mesh.py``'s ``make_mesh``, ``batch_axes`` and
``axis_size``), and a launcher that runs one function on every rank.

A mesh names the ranks of an initialized process group by their
row-major coordinates in ``shape`` (rank r of the group takes coordinate
``np.unravel_index(r, shape)``). It holds the sub-groups that split
attention gathers over: the 'model' axis joined with each subset of the
batch axes, the ranks that differ only along those axes. ``gather``
all-gathers a per-rank shard over such a sub-group back into the whole
tensor.

The backend is the caller's choice at ``init_process_group`` (or
``run_ranks``): ``gloo`` where ranks share a card (NCCL refuses two ranks
on one device; gloo moves CUDA tensors through the host), ``nccl`` where
each rank has its own card.
"""
from __future__ import annotations

import datetime
import itertools
import multiprocessing
import os
import shutil
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Ranks of a process group laid out on named axes.

    ``shape``: {axis: size}; ``axis_names``: the axes in order; ``coords``:
    this rank's {axis: index}; ``model_group``: the sub-group of the ranks
    that share this rank's batch coordinates (the 'model' axis), over which
    split attention gathers its shards."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 group=None):
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} must pair up, names distinct")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self.group = group if group is not None else dist.group.WORLD
        self.ranks = dist.get_process_group_ranks(self.group)
        if len(self.ranks) != int(np.prod(shape)):
            raise ValueError(f"mesh {self.shape} needs {int(np.prod(shape))} "
                             f"ranks, the group has {len(self.ranks)}")
        self.rank = dist.get_rank()
        self.coords = self.coords_of(self.rank)
        # 'model' with each subset of the batch axes (what
        # hints._fit_batch_axes may keep), of more than one rank: every rank
        # of the group creates every sub-group, in the same order
        self._groups: Dict[Tuple[str, ...], Tuple[object, list]] = {}
        b_axes = batch_axes(self)
        for n in range(len(b_axes) + 1):
            for bsub in itertools.combinations(b_axes, n):
                sub = tuple(a for a in self.axis_names
                            if a in bsub or a == "model")
                if "model" not in sub or self.size(sub) == 1:
                    continue
                parts: Dict[tuple, list] = {}
                for r in self.ranks:
                    c = self.coords_of(r)
                    key = tuple(c[a] for a in self.axis_names if a not in sub)
                    parts.setdefault(key, []).append(r)
                for key in sorted(parts):
                    g = dist.new_group(sorted(parts[key]))
                    if self.rank in parts[key]:
                        self._groups[sub] = (
                            g, dist.get_process_group_ranks(g))

    def coords_of(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(self.ranks.index(rank),
                               tuple(self.shape[a] for a in self.axis_names))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """Row-major index of ``rank`` (default: this one) over ``axes``."""
        c = self.coords if rank is None else self.coords_of(rank)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    @property
    def model_group(self):
        entry = self._groups.get(tuple(a for a in self.axis_names
                                       if a == "model"))
        return None if entry is None else entry[0]

    def gather(self, x: torch.Tensor, batch_axes: Sequence[str] = (),
               seq_axes: Sequence[str] = ()) -> torch.Tensor:
        """All-gather per-rank shards of a (B, S, ...) tensor: shard
        (i, j) holds batch chunk i (row-major over ``batch_axes``) and
        sequence chunk j (over ``seq_axes``). Returns the whole tensor, the
        same on every rank of the sub-group."""
        b_axes, s_axes = tuple(batch_axes), tuple(seq_axes)
        axes = tuple(a for a in self.axis_names if a in b_axes + s_axes)
        if self.size(axes) == 1:
            return x
        group, members = self._groups[axes]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x, group=group)
        grid = {(self.index(b_axes, r), self.index(s_axes, r)): p
                for r, p in zip(members, parts)}
        return torch.cat([torch.cat([grid[i, j]
                                     for j in range(self.size(s_axes))],
                                    dim=1)
                          for i in range(self.size(b_axes))], dim=0)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              group=None) -> Mesh:
    """A mesh over ``group`` (default: the world) of an initialized
    process group; every rank of the world calls it, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (init_process_group, run_ranks)")
    return Mesh(shape, axes, group)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch splits over: ('pod', 'data') where present."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


# ---------------------------------------------------------------------------
# running a function on every rank
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, backend: str, init_file: str,
               init_timeout_s: float, args) -> None:
    dist.init_process_group(
        backend, init_method="file://" + init_file, rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=init_timeout_s))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *, backend: str, args=(),
              timeout_s: float = 180.0, init_timeout_s: float = 60.0,
              rdzv_dir: Optional[str] = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes
    (multiprocessing ``spawn``), each inside an initialized process group
    of ``backend`` that meets through a file in a new temporary directory
    (under ``rdzv_dir`` if given). ``fn`` must be importable by name.

    Raises if a rank exits non-zero (the others are then killed), or if
    the ranks have not all ended within ``timeout_s`` (all are killed);
    ``init_timeout_s`` bounds the rendezvous and every collective."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rdzv-", dir=rdzv_dir)
    init_file = os.path.join(tmp, "init")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init_file,
                               init_timeout_s, tuple(args)))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            bad = [f"rank {r} exit {c}" for r, c in enumerate(codes)
                   if c is not None and c != 0]
            if bad:
                raise RuntimeError(f"rank(s) failed: {', '.join(bad)}")
            running = [r for r, c in enumerate(codes) if c is None]
            if not running:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {running} still running after "
                                   f"{timeout_s:g} s")
            procs[running[0]].join(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
