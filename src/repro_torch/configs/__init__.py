"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

Holds the architectures the port serves so far (the dense family).
"""
from __future__ import annotations

from repro_torch.configs import qwen1_5_0_5b
from repro_torch.configs.base import ArchConfig, reduced

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in (qwen1_5_0_5b.CONFIG,)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(REGISTRY))
        raise KeyError(f"unknown arch {name!r}; known: {known}") from None


__all__ = ["REGISTRY", "ArchConfig", "get_config", "reduced"]
