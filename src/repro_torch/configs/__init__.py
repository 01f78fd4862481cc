"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

Holds the architectures the port serves so far: of the dense family
qwen1.5-0.5b; the untied ones, qwen2-72b, codeqwen1.5-7b and
phi3-mini-3.8b; and adaptor-bert-shaped, a fleet member at the paper's
BERT widths on qwen's template (``--fleet
qwen1.5-0.5b,adaptor-bert-shaped``); of the MoE family
granite-moe-1b-a400m and deepseek-v3-671b (MLA, ``--arch
deepseek-v3-671b``); and the paper's three evaluation networks, which
the register-driven engine runs (``core/adaptive.py``): adaptor-bert,
shallow-transformer and custom-encoder, of the encoder family.
"""
from __future__ import annotations

from repro_torch.configs import (adaptor_bert, adaptor_bert_shaped,
                                 codeqwen1_5_7b, custom_encoder,
                                 deepseek_v3_671b, granite_moe_1b_a400m,
                                 phi3_mini_3_8b,
                                 qwen1_5_0_5b, qwen2_72b,
                                 shallow_transformer)
from repro_torch.configs.base import (ArchConfig, EncDecConfig, MLAConfig,
                                      reduced)

# The paper's own evaluation networks (ADAPTOR §6, Table 1, Fig. 11).
PAPER_NETWORKS: tuple[ArchConfig, ...] = (
    adaptor_bert.CONFIG,
    shallow_transformer.CONFIG,
    custom_encoder.CONFIG,
)

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in (qwen1_5_0_5b.CONFIG, qwen2_72b.CONFIG,
                        codeqwen1_5_7b.CONFIG, phi3_mini_3_8b.CONFIG,
                        adaptor_bert_shaped.CONFIG,
                        granite_moe_1b_a400m.CONFIG,
                        deepseek_v3_671b.CONFIG, *PAPER_NETWORKS)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(REGISTRY))
        raise KeyError(f"unknown arch {name!r}; known: {known}") from None


__all__ = ["PAPER_NETWORKS", "REGISTRY", "ArchConfig", "EncDecConfig",
           "MLAConfig", "get_config", "reduced"]
