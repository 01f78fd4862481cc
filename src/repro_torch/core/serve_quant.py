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
``quant_min_size`` at ``L * K * N`` elements, L the number of
``layers.<i>.`` modules (an enc-dec model's ``enc_layers.<i>.`` kernels
at the encoder's depth; an MoE model's main stack; its ``dense_prefix``
layers are unstacked leaves in the reference and are measured alone, as
is every layer of a hybrid model, which the reference keeps as a list:
its RG-LRU's ``in_x``, ``in_gate`` and ``out`` kernels included).
Per-column scales of a stacked leaf are per-layer, so quantizing layer by
layer gives the same numbers.  The expert and router leaves are not
named ``kernel``, so they stay float.

An MLA model's ``k_up`` and ``v_up`` kernels are eligible by the same
rule, but the absorbed attend contracts them as float weights: the
reference's ``_mla_attend`` reshapes the leaf and raises
``AttributeError`` on its ``QTensor`` (``src/repro/models/attention.py``
``_mla_attend``).  ``check_mla_quant`` refuses such a configuration with
a ``ValueError`` rather than serve something the reference cannot.
So does ``check_position_quant`` for a learned position table (the
decoder's ``pos_embed`` and an encoder's ``enc_pos_embed``): the size rule
quantizes it as a ``table``, and the reference's embedding calls
``.astype`` on the ``QTensor`` and raises ``AttributeError``.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from repro_torch.core.quant import DEFAULT_QUANT_MIN_SIZE, QTensor

SCALE_SUFFIX = "_scale"


def stacked_layers(names, prefix: str = "layers.") -> int:
    """Number of ``<prefix><i>.`` modules named in a state dict."""
    idx = [int(n.split(".")[1]) for n in names if n.startswith(prefix)]
    return max(idx) + 1 if idx else 0


def eligible(name: str, shape, num_layers: int,
             min_size: int = DEFAULT_QUANT_MIN_SIZE,
             enc_layers: int = 0) -> str | None:
    """'kernel' / 'table' when the leaf ``name`` of ``shape`` is quantized
    (the reference's ``_eligible`` on the stacked leaf); ``num_layers``
    is the count of ``layers.<i>.`` modules (``stacked_layers``),
    ``enc_layers`` that of an encoder's ``enc_layers.<i>.``."""
    kind = name.rsplit(".", 1)[-1]
    if kind not in ("kernel", "table") or len(shape) < 2:
        return None
    n = 1
    for d in shape:
        n *= d
    if name.startswith("layers."):
        n *= num_layers
    elif name.startswith("enc_layers."):
        n *= enc_layers
    return kind if n >= min_size else None


def mla_absorbed_leaves(cfg, min_size: int = DEFAULT_QUANT_MIN_SIZE
                        ) -> list[tuple[str, int]]:
    """The MLA up-projections (``k_up`` / ``v_up`` kernels of the main
    stack and of the dense prefix) that ``quant="int8"`` at ``min_size``
    would quantize, with the element count the size rule measures."""
    if cfg.mla is None:
        return []
    m, h = cfg.mla, cfg.num_heads
    k = cfg.moe.first_k_dense if cfg.moe is not None else 0
    out = []
    for leaf, width in (("k_up", m.qk_nope_head_dim), ("v_up", m.v_head_dim)):
        shape = (m.kv_lora_rank, h * width)
        for name, stack in ((f"dense_prefix.0.attn.{leaf}.kernel", 0),
                            (f"layers.0.attn.{leaf}.kernel",
                             cfg.num_layers - k)):
            if (stack or k) and eligible(name, shape, stack, min_size):
                n = shape[0] * shape[1] * max(stack, 1)
                out.append((name.replace(".0.", ".<i>."), n))
    return out


def check_mla_quant(cfg, min_size: int = DEFAULT_QUANT_MIN_SIZE) -> None:
    """Refuse int8 weights on an MLA model whose ``k_up`` or ``v_up`` the
    size rule would quantize (``mla_absorbed_leaves``)."""
    bad = mla_absorbed_leaves(cfg, min_size)
    if bad:
        names = ", ".join(f"{n} ({c} elements)" for n, c in bad)
        raise ValueError(
            f"{cfg.name}: quant='int8' at quant_min_size={min_size} would "
            f"quantize the MLA up-projections {names}, which the absorbed "
            "attend contracts as float weights; the reference cannot serve "
            "this configuration (its _mla_attend reshapes the QTensor and "
            "raises AttributeError, src/repro/models/attention.py:595), so "
            f"the port refuses it: set quant_min_size above "
            f"{max(c for _, c in bad)} or serve float weights")


def position_tables(cfg) -> list[tuple[str, int]]:
    """The learned position tables of ``cfg`` with their element counts:
    the decoder's ``pos_embed.table`` and an encoder's
    ``enc_pos_embed.table``."""
    if cfg.positional != "learned":
        return []
    out = [("pos_embed.table", cfg.max_position_embeddings * cfg.d_model)]
    if cfg.encdec is not None:
        out.append(("enc_pos_embed.table",
                    cfg.encdec.encoder_seq_len * cfg.d_model))
    return out


def check_position_quant(cfg, min_size: int = DEFAULT_QUANT_MIN_SIZE
                         ) -> None:
    """Refuse int8 weights where the size rule would quantize a learned
    position table (``position_tables``)."""
    bad = [(n, c) for n, c in position_tables(cfg)
           if eligible(n, (c, 1), 0, min_size)]
    if bad:
        names = ", ".join(f"{n} ({c} elements)" for n, c in bad)
        raise ValueError(
            f"{cfg.name}: quant='int8' at quant_min_size={min_size} would "
            f"quantize the learned position tables {names}, which the "
            "embedding adds as float rows; the reference cannot serve this "
            "configuration (its _embed_inputs and decode_step call .astype "
            "on the QTensor and raise AttributeError, "
            "src/repro/models/model.py:392 and :709), so the port refuses "
            f"it: set quant_min_size above {max(c for _, c in bad)} or "
            "serve float weights")


def quantize_leaf(w: torch.Tensor, kind: str) -> QTensor:
    """Kernels ``[..., K, N]``: per-(stack, column) scales ``[..., 1, N]``
    reduced over the contraction dim only (``[1, N]`` for one layer's
    kernel); tables ``[V, ...]``: per-row scales ``[V, 1, ...]`` (the
    reference's ``quantize_leaf``, so a fleet's stacked table rows take one
    scale per layer and column)."""
    w32 = w.float()
    dims = (-2,) if kind == "kernel" else tuple(range(1, w32.dim()))
    scale = w32.abs().amax(dim=dims, keepdim=True).clamp_min(1e-8) / 127.0
    return QTensor(torch.clamp(torch.round(w32 / scale), -127, 127)
                   .to(torch.int8), scale)


def quantize_params(params: Mapping[str, torch.Tensor],
                    min_size: int = DEFAULT_QUANT_MIN_SIZE,
                    layers: int | None = None) -> dict[str, torch.Tensor]:
    """A state dict with every eligible float leaf replaced by int8 values
    and its ``<name>_scale``.  Leaves that are already int8 (with their
    scales) pass through, so the call is idempotent.  ``layers``: what a
    ``layers.<i>.`` leaf's size is multiplied by (None: the stacked layers
    the dict names; 1 for a hybrid model, whose layers the reference keeps
    unstacked); an ``enc_layers.<i>.`` leaf's by the encoder layers the
    dict names."""
    layers = stacked_layers(params) if layers is None else layers
    enc = stacked_layers(params, "enc_layers.")
    out: dict[str, torch.Tensor] = {}
    for name, t in params.items():
        kind = eligible(name, t.shape, layers, min_size, enc)
        if kind is None or not t.is_floating_point():
            out[name] = t
            continue
        q = quantize_leaf(t, kind)
        out[name] = q.values
        out[name + SCALE_SUFFIX] = q.scale
    return out
