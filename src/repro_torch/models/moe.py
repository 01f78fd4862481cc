"""The dense (non-expert) FFN of the reference's ``models/moe.py``
(``apply_ffn``); routed experts are ported with the MoE family."""
from __future__ import annotations

import torch

from repro_torch.models import layers


def apply_ffn(x: torch.Tensor, p, activation: str, mm: str) -> torch.Tensor:
    h = layers.apply_dense(x, p.w1, mm)
    if layers.is_gated(activation):
        h = layers.activate(layers.apply_dense(x, p.wg, mm), activation) * h
    else:
        h = layers.activate(h, activation)
    return layers.apply_dense(h, p.w2, mm)
