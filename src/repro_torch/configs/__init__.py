"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

Holds the architectures the port serves so far (the dense family):
qwen1.5-0.5b; the untied ones, qwen2-72b, codeqwen1.5-7b and
phi3-mini-3.8b; and adaptor-bert-shaped, a fleet member at the paper's
BERT widths on qwen's template (``--fleet
qwen1.5-0.5b,adaptor-bert-shaped``).
"""
from __future__ import annotations

from repro_torch.configs import (adaptor_bert_shaped, codeqwen1_5_7b,
                                 phi3_mini_3_8b, qwen1_5_0_5b, qwen2_72b)
from repro_torch.configs.base import ArchConfig, reduced

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in (qwen1_5_0_5b.CONFIG, qwen2_72b.CONFIG,
                        codeqwen1_5_7b.CONFIG, phi3_mini_3_8b.CONFIG,
                        adaptor_bert_shaped.CONFIG)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(REGISTRY))
        raise KeyError(f"unknown arch {name!r}; known: {known}") from None


__all__ = ["REGISTRY", "ArchConfig", "get_config", "reduced"]
