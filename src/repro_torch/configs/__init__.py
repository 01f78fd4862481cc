"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

Holds the architectures the port serves so far: of the dense family
qwen1.5-0.5b; the untied ones, qwen2-72b, codeqwen1.5-7b and
phi3-mini-3.8b; and adaptor-bert-shaped, a fleet member at the paper's
BERT widths on qwen's template (``--fleet
qwen1.5-0.5b,adaptor-bert-shaped``); of the MoE family granite-moe-1b-a400m and deepseek-v3-671b
(MLA, ``--arch deepseek-v3-671b``); of the vlm family phi-3-vision-4.2b
(``--arch phi-3-vision-4.2b``, its stub frontend zeros in serving); of
the ssm family falcon-mamba-7b (``--arch falcon-mamba-7b``, Mamba-1's
selective scan, attention-free); of the hybrid family recurrentgemma-2b (``--arch recurrentgemma-2b``, RG-LRU
and local attention); of the audio family whisper-medium (``--arch
whisper-medium``, an encoder over the stub frontend's frames and a decoder
with cross-attention, its frames zeros in serving); and
the paper's three evaluation networks, which the register-driven engine
runs (``core/adaptive.py``): adaptor-bert, shallow-transformer and
custom-encoder, of the encoder family.
"""
from __future__ import annotations

from repro_torch.configs import (adaptor_bert, adaptor_bert_shaped,
                                 codeqwen1_5_7b, custom_encoder,
                                 deepseek_v3_671b, falcon_mamba_7b,
                                 granite_moe_1b_a400m,
                                 phi3_mini_3_8b, phi_3_vision_4_2b,
                                 qwen1_5_0_5b, qwen2_72b,
                                 recurrentgemma_2b, shallow_transformer,
                                 whisper_medium)
from repro_torch.configs.base import (ArchConfig, EncDecConfig,
                                      FrontendConfig, HybridConfig,
                                      MLAConfig, SSMConfig, reduced)

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
                        deepseek_v3_671b.CONFIG, phi_3_vision_4_2b.CONFIG,
                        recurrentgemma_2b.CONFIG, falcon_mamba_7b.CONFIG,
                        whisper_medium.CONFIG, *PAPER_NETWORKS)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(REGISTRY))
        raise KeyError(f"unknown arch {name!r}; known: {known}") from None


__all__ = ["PAPER_NETWORKS", "REGISTRY", "ArchConfig", "EncDecConfig",
           "FrontendConfig", "HybridConfig", "MLAConfig", "SSMConfig",
           "get_config", "reduced"]
