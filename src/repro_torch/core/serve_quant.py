"""Serving-time weight quantization (paper C6 applied to deployment).

The port's counterpart of the reference's ``core/serve_quant.py``: walks a
state dict of the port's ``Model`` and replaces eligible leaves with int8
values plus a float32 scale stored beside them under ``<name>_scale``:

* dense ``kernel``s ``[K, N]`` get per-column scales ``[1, N]`` (reduced
  over the contraction dim only);
* the embedding and untied ``lm_head`` tables ``[V, D]`` get per-row
  scales ``[V, 1]``.

Eligibility is the reference's, which measures the *stacked* leaf: the
reference keeps one ``[L, K, N]`` array per projection, the port one
``[K, N]`` module per layer, so a ``layers.<i>.`` kernel is compared with
``quant_min_size`` at ``L * K * N`` elements.  Per-column scales of a
stacked leaf are per-layer, so quantizing layer by layer gives the same
numbers.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from repro_torch.core.quant import DEFAULT_QUANT_MIN_SIZE, QTensor, quantize

SCALE_SUFFIX = "_scale"


def stacked_layers(names) -> int:
    """Number of ``layers.<i>.`` modules named in a state dict."""
    idx = [int(n.split(".")[1]) for n in names if n.startswith("layers.")]
    return max(idx) + 1 if idx else 0


def eligible(name: str, shape, num_layers: int,
             min_size: int = DEFAULT_QUANT_MIN_SIZE) -> str | None:
    """'kernel' / 'table' when the leaf ``name`` of ``shape`` is quantized
    (the reference's ``_eligible`` on the stacked leaf)."""
    kind = name.rsplit(".", 1)[-1]
    if kind not in ("kernel", "table") or len(shape) < 2:
        return None
    n = 1
    for d in shape:
        n *= d
    if name.startswith("layers."):
        n *= num_layers
    return kind if n >= min_size else None


def quantize_leaf(w: torch.Tensor, kind: str) -> QTensor:
    """Kernels ``[K, N]``: per-column scales ``[1, N]`` over the
    contraction dim; tables ``[V, D]``: per-row scales ``[V, 1]``."""
    return quantize(w, axis=-1 if kind == "kernel" else 0)


def quantize_params(params: Mapping[str, torch.Tensor],
                    min_size: int = DEFAULT_QUANT_MIN_SIZE
                    ) -> dict[str, torch.Tensor]:
    """A state dict with every eligible float leaf replaced by int8 values
    and its ``<name>_scale``.  Leaves that are already int8 (with their
    scales) pass through, so the call is idempotent."""
    layers = stacked_layers(params)
    out: dict[str, torch.Tensor] = {}
    for name, t in params.items():
        kind = eligible(name, t.shape, layers, min_size)
        if kind is None or not t.is_floating_point():
            out[name] = t
            continue
        q = quantize_leaf(t, kind)
        out[name] = q.values
        out[name + SCALE_SUFFIX] = q.scale
    return out
