"""Architecture registry: --arch <id> resolution for the port's entry
points."""
from __future__ import annotations

from repro_torch.configs.archs import ARCHS, smoke_config
from repro_torch.models.config import ArchConfig


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    return smoke_config(get_arch(name))


def list_archs():
    return sorted(ARCHS)
