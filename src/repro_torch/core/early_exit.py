"""Early-exit staging for LM backbones (the port of
``repro/core/early_exit.py``): the prefill stages, the one-token decode
stages and the cache split between them.

ATHEENA's CDFG form (Fig. 3): stage 1 = embed + layers [0, k) + exit head,
stage 2 = layers [k, N) + final head. The exit head is RMSNorm + the tied
unembedding. The exit decision and the conditional buffer between the
stages run through ``kernels.dispatch``: the CUDA kernels on the card,
their plain versions on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import conditional as cond
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import init_rmsnorm, rmsnorm, unembed


@dataclass(frozen=True)
class EarlyExitSpec:
    exit_layer: int            # stage boundary k (superblock-aligned)
    c_thr: float = 0.9         # Eq. (2) confidence threshold


def default_spec(cfg: ArchConfig, c_thr: float = 0.9) -> EarlyExitSpec:
    return EarlyExitSpec(exit_layer=cfg.default_exit_layers()[0], c_thr=c_thr)


def validate_boundary(cfg: ArchConfig, k: int) -> None:
    base = cfg.first_k_dense
    if not (base <= k <= cfg.n_layers):
        raise ValueError(f"exit layer {k} outside [{base}, {cfg.n_layers}]")
    if (k - base) % cfg.pattern_len != 0:
        raise ValueError(
            f"exit layer {k} must be superblock-aligned (pattern len "
            f"{cfg.pattern_len}, leading dense {base})")


def init_ee_params(cfg: ArchConfig, spec: EarlyExitSpec,
                   generator: torch.Generator) -> dict:
    """{backbone, exit_head} on ``generator.device``, drawn from
    ``generator``."""
    validate_boundary(cfg, spec.exit_layer)
    return {
        "backbone": T.init_params(cfg, generator),
        "exit_head": {"norm": init_rmsnorm((cfg.d_model,), cfg.p_dtype(),
                                           generator.device)},
    }


def exit_head(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Exit classifier: norm + tied unembedding -> fp32 logits."""
    hn = rmsnorm(params["exit_head"]["norm"], h, cfg.norm_eps)
    bb = params["backbone"]
    if cfg.tie_embeddings or "head" not in bb:
        return unembed(bb["embed"], hn)
    return hn.float() @ bb["head"].float()


def stage1_prefill(params, cfg: ArchConfig, spec: EarlyExitSpec,
                   tokens: torch.Tensor):
    """Stage 1: embed + layers [0, k) + exit head on the last position.
    Returns (hidden (B, S, d), caches_seg1, exit_logits (B, V), memory);
    memory is None (no encoder in the dense family)."""
    bb = params["backbone"]
    h = T.embed_tokens(bb, cfg, tokens)
    h, caches = T.run_layers(bb, cfg, h, 0, spec.exit_layer)
    return h, caches, exit_head(params, cfg, h[:, -1]), None


def _stage2_base_sb(cfg: ArchConfig, spec: EarlyExitSpec) -> int:
    return (spec.exit_layer - cfg.first_k_dense) // cfg.pattern_len


def stage2_prefill(params, cfg: ArchConfig, spec: EarlyExitSpec,
                   h: torch.Tensor, *, presliced_params: bool = False):
    """Stage 2: layers [k, N) + final head on the hard slab (C, S, d).
    Returns (logits (C, V), caches_seg2). ``presliced_params``: params is a
    stage-2 slice (``split_params``) whose 'blocks' start at the exit."""
    bb = params["backbone"]
    base = _stage2_base_sb(cfg, spec) if presliced_params else 0
    h, caches = T.run_layers(bb, cfg, h, spec.exit_layer, cfg.n_layers,
                             param_base_sb=base)
    return T.head(bb, cfg, h[:, -1]), caches


def stage1_decode(params, cfg: ArchConfig, spec: EarlyExitSpec,
                  token: torch.Tensor, caches, step):
    """One-token stage 1: embed + layers [0, k) against the stage-1 segment
    caches + exit head. Returns (hidden (B, 1, d), new caches, exit logits
    (B, V))."""
    bb = params["backbone"]
    h = T.embed_tokens(bb, cfg, token)
    h, ncaches = T.run_layers(bb, cfg, h, 0, spec.exit_layer, mode="decode",
                              caches=caches, step=step)
    return h, ncaches, exit_head(params, cfg, h[:, 0])


def stage2_decode(params, cfg: ArchConfig, spec: EarlyExitSpec,
                  h: torch.Tensor, caches, step, *, presliced: bool = True,
                  presliced_params: bool = False):
    """One-token stage 2 on the compacted hard slab h (C, 1, d). ``caches``
    is the stage-2 SEGMENT cache (``split_caches``) by default; its batch
    is the bucket's, not stage 1's. ``presliced_params`` marks a stage-2
    param slice (``split_params``). Returns (logits (C, V), new caches)."""
    bb = params["backbone"]
    base = _stage2_base_sb(cfg, spec) if presliced else 0
    pbase = _stage2_base_sb(cfg, spec) if presliced_params else 0
    h, ncaches = T.run_layers(bb, cfg, h, spec.exit_layer, cfg.n_layers,
                              mode="decode", caches=caches, step=step,
                              cache_base_sb=base, param_base_sb=pbase)
    return T.head(bb, cfg, h[:, 0]), ncaches


def split_caches(cfg: ArchConfig, spec: EarlyExitSpec, caches):
    """Slice a full-depth cache tree into its (stage1, stage2) segments at
    the exit's superblock, as ``run_layers`` slices. The 'blocks' leaves
    are views of the stacked leaves (no copy)."""
    k_sb = _stage2_base_sb(cfg, spec)

    def sl(tree, lo, hi):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: sl(v, lo, hi) for k, v in tree.items()}
        return tree[lo:hi]

    s1 = {"first": caches["first"],
          "blocks": tuple(sl(b, 0, k_sb) for b in caches["blocks"]),
          "rem": []}
    s2 = {"first": [],
          "blocks": tuple(sl(b, k_sb, None) for b in caches["blocks"]),
          "rem": caches["rem"]}
    return s1, s2


def split_params(cfg: ArchConfig, spec: EarlyExitSpec, params):
    """Split the EE param tree into (stage1, stage2) resident sets, as the
    JAX package does for its per-stage submeshes. Stage 1: embed, leading
    dense layers, superblocks [0, k_sb), exit head. Stage 2: superblocks
    [k_sb, N), remainder, final norm, and the unembedding both heads read.
    The superblock slices are views of the stacked leaves (no copy); pass
    ``presliced_params=True`` to ``stage2_prefill``."""
    bb = params["backbone"]
    k_sb = _stage2_base_sb(cfg, spec)

    def sl(tree, lo, hi):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: sl(v, lo, hi) for k, v in tree.items()}
        return tree[lo:hi]

    shared = ({"embed": bb["embed"]} if cfg.tie_embeddings or "head" not in bb
              else {"head": bb["head"]})
    bb1 = dict(shared, embed=bb["embed"], first=bb["first"], rem=[],
               blocks=tuple(sl(b, 0, k_sb) for b in bb["blocks"]))
    bb2 = dict(shared, first=[], rem=bb["rem"], final_norm=bb["final_norm"],
               blocks=tuple(sl(b, k_sb, None) for b in bb["blocks"]))
    return ({"backbone": bb1, "exit_head": params["exit_head"]},
            {"backbone": bb2})


def serve_batch(params, cfg: ArchConfig, spec: EarlyExitSpec,
                tokens: torch.Tensor, *, capacity: Optional[int] = None):
    """The whole EE pipeline on one batch: stage 1 for all, the exit
    decision, conditional-buffer compaction, stage 2 on the hard slab, exit
    merge by sample id. Returns a dict with the merged last-token logits,
    the exit mask, the exit logits, the confidences, n_hard and the
    overflow (hard rows past the capacity, which get no stage-2 answer)."""
    B = tokens.shape[0]
    sample_ids = torch.arange(B, dtype=torch.int32, device=tokens.device)
    h, _, exit_logits, _ = stage1_prefill(params, cfg, spec, tokens)
    exit_mask, _, conf = dispatch.exit_decision_op(exit_logits, spec.c_thr)
    cap = capacity if capacity is not None else B
    slab, slab_ids, n_hard = dispatch.gather_compact_op(h, ~exit_mask, cap)
    final_logits, _ = stage2_prefill(params, cfg, spec, slab)
    easy_ids = torch.where(exit_mask, sample_ids, -1)
    merged = cond.exit_merge(B, easy_ids, exit_logits, slab_ids,
                             final_logits)
    return {
        "logits": merged,
        "exit_mask": exit_mask,
        "exit_logits": exit_logits,
        "confidence": conf,
        "n_hard": n_hard,
        "overflow": torch.clamp(n_hard - cap, min=0),
    }
