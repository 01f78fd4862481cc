"""Weights carried over from the JAX reference.

``from_jax_params(np_tree, cfg, device, dtype)`` takes the parameter
pytree of the reference's ``Model(cfg).init(key)`` with every leaf already
converted to a numpy array (the caller does that conversion; this module
imports no JAX) and returns a state dict of the port's ``Model``, so both
packages compute the same function.  The reference stacks the layers on a
leading axis; the port keeps one module per layer, so that axis is
unstacked into ``layers.<i>.`` (the ``num_layers - first_k_dense`` layers
of an MoE model's main stack).  An MoE model's dense prefix is a list of
unstacked layers in the reference; its ``j``-th entry becomes
``dense_prefix.<j>.``.  An MLA model's attention leaves (``attn.{q_down,
q_norm, q_up, kv_down, kv_norm, k_up, v_up, wo}``) carry over by the same
rule.  A hybrid model's layers are a list in the reference too (each a
dict of its kind's leaves: ``rglru.*`` or ``attn.*`` beside ``ln1``,
``ln2`` and ``ffn``), so they map leaf for leaf onto ``layers.<i>.``.  An
ssm model's layers are stacked like the dense family's: ``layers.ln`` and
``layers.ssm.{in_proj, conv_w, conv_b, x_proj, dt_proj (kernel and
bias), a_log, d_skip, out_proj}`` split on their leading axis.  An
enc-dec (audio) model stacks its encoder on a leading axis of
``encdec.num_encoder_layers``: ``enc_layers.*`` becomes
``enc_layers.<i>.`` (the dense layer's leaves), while its decoder layers
(``ln_cross`` and ``cross.{wq,wk,wv,wo}`` among them) unstack as
``layers.*`` do; ``enc_final_norm``, ``enc_pos_embed.table`` and the
decoder's ``pos_embed.table`` carry over by name.  The multi-token-prediction
head (``mtp``, DeepSeek-V3; the reference builds it unstacked) carries over
by name as ``mtp.{proj, norm_h, norm_e, layer.*}``: a trainable ``Model``
holds it, and a serving one, which never reads it, drops those leaves as
it loads.

``from_jax_train_state(np_state, cfg, device)`` maps the reference's
``TrainState`` (params, and ``opt`` with its ``step``, ``m`` and ``v``,
every leaf as numpy) onto the port's: the parameters as above, as f32
masters with ``requires_grad``, and the moments unstacked by the same
rule, in their dtype (bfloat16 moments stay bfloat16).  Every family's
state maps so, the hybrid's list of layers and the ssm's stacked ones
included.

A tree the reference has quantized (its ``serve_quant.quantize_params``)
holds ``QTensor`` leaves; after the numpy conversion each is a
``(values, scale)`` pair.  Its int8 values land under the leaf's name and
its float32 scale under ``<name>_scale``, unstacked like the float leaves,
so a test can hand both packages the same int8 weights.

``from_jax_axes(axes_tree, cfg)`` maps the reference's
``Model(cfg).axes()`` (its ``ParamBuilder`` "axes" mode: a tree of
``PartitionSpec`` leaves, each a tuple of logical axis names) onto the
port's names by the same rule: a stacked leaf's leading "layers" axis is
dropped as it unstacks, so the result reads like the port's
``Model.axes()``.

``from_jax_adaptive(np_tree, engine)`` takes the register-driven engine's
padded weights from the reference (its ``pack(...)`` or
``AdaptiveEngine.init(...)`` output, numpy leaves) and returns the
parameter tree of the port's ``AdaptiveEngine``: the same names and
stacked shapes, on the engine's device in its dtype, ready for its step.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.adaptive import unflatten
from repro_torch.core.serve_quant import SCALE_SUFFIX
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import TrainState


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        elif isinstance(val, list):          # the dense prefix's layers
            out.update(_flatten(dict(enumerate(val)), name + "."))
        elif isinstance(val, tuple):       # a QTensor: (int8 values, scale)
            values, scale = val
            out[name] = np.asarray(values)
            out[name + SCALE_SUFFIX] = np.asarray(scale)
        else:
            out[name] = np.asarray(val)
    return out


def _tensor(arr: np.ndarray, name: str, dtype: torch.dtype) -> torch.Tensor:
    """int8 values stay int8 and scales float32; float leaves take
    ``dtype``."""
    if arr.dtype == np.int8:
        return torch.from_numpy(np.array(arr))
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    return t if name.endswith(SCALE_SUFFIX) else t.to(dtype)


def from_jax_params(np_tree: Mapping, cfg: ArchConfig, device,
                    dtype: torch.dtype = torch.float32
                    ) -> dict[str, torch.Tensor]:
    """State dict of the port's ``Model(cfg)`` from the reference's params.

    ``dtype`` is the dtype of the returned float tensors (the parameter
    dtype); ``Model.load_state_dict`` casts dense kernels to the compute
    dtype.
    """
    flat = _flatten(np_tree)
    stacked = cfg.num_layers - (cfg.moe.first_k_dense if cfg.moe else 0)
    stacks = {"layers.": (stacked, "num_layers", cfg.num_layers)}
    if cfg.encdec is not None:
        n_enc = cfg.encdec.num_encoder_layers
        stacks["enc_layers."] = (n_enc, "num_encoder_layers", n_enc)
    out: dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        t = _tensor(arr, name, dtype)
        prefix = next((p for p in stacks if name.startswith(p)), None)
        if prefix is not None and cfg.hybrid is None:
            n, field, depth = stacks[prefix]
            if t.shape[0] != n:
                raise ValueError(f"{name}: leading axis {t.shape[0]} != "
                                 f"the {n} stacked layers of "
                                 f"{field}={depth}")
            rest = name[len(prefix):]
            for i in range(n):
                out[f"{prefix}{i}.{rest}"] = t[i].to(device).contiguous()
        else:
            out[name] = t.to(device)
    return out


def _stacks(cfg: ArchConfig) -> dict[str, int]:
    """The prefixes the reference stacks on a leading axis, each with
    its depth (none for a hybrid model, whose layers are a list)."""
    if cfg.hybrid is not None:
        return {}
    out = {"layers.": cfg.num_layers - (cfg.moe.first_k_dense
                                         if cfg.moe else 0)}
    if cfg.encdec is not None:
        out["enc_layers."] = cfg.encdec.num_encoder_layers
    return out


def from_jax_axes(axes_tree: Mapping, cfg: ArchConfig
                  ) -> dict[str, tuple]:
    """The port's ``Model.axes()`` from the reference's ``axes()`` tree
    (leaves: tuples of axis names, a ``PartitionSpec`` is one)."""
    flat: dict[str, tuple] = {}

    def walk(node, prefix: str) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = tuple(node)

    walk(axes_tree, "")
    stacks = _stacks(cfg)
    out: dict[str, tuple] = {}
    for name, axes in flat.items():
        prefix = next((p for p in stacks if name.startswith(p)), None)
        if prefix is None:
            out[name] = axes
            continue
        if axes[:1] != ("layers",):
            raise ValueError(f"{name}: a stacked leaf's axes {axes} do not "
                             "lead with 'layers'")
        for i in range(stacks[prefix]):
            out[f"{prefix}{i}.{name[len(prefix):]}"] = axes[1:]
    return out


def from_jax_train_state(np_state, cfg: ArchConfig, device) -> TrainState:
    """The port's ``TrainState`` from the reference's (numpy leaves):
    ``np_state.params`` as trainable f32 masters, ``np_state.opt``'s
    moments by the same names in their own dtype and its step as an int32
    scalar, all on ``device``."""
    params, opt = np_state
    moment = torch.bfloat16 if str(np.asarray(
        next(iter(_flatten(opt.m).values()))).dtype) == "bfloat16" \
        else torch.float32
    return TrainState(
        {n: t.requires_grad_(True) for n, t in from_jax_params(
            params, cfg, device).items()},
        AdamWState(torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                                device=device),
                   from_jax_params(opt.m, cfg, device, moment),
                   from_jax_params(opt.v, cfg, device, moment)))


def from_jax_adaptive(np_tree: Mapping, engine) -> dict:
    """The port's ``AdaptiveEngine`` parameter tree from the reference
    engine's padded weights (numpy leaves).  Names and shapes must be the
    engine's buffers' exactly: both packages stack the layers alike."""
    flat = _flatten(np_tree)
    bufs = dict(engine.named_buffers())
    if flat.keys() != bufs.keys():
        raise ValueError(
            "the reference tree does not match the engine's buffers: "
            f"missing {sorted(bufs.keys() - flat.keys())}, unexpected "
            f"{sorted(flat.keys() - bufs.keys())}")
    for name, arr in flat.items():
        if arr.shape != tuple(bufs[name].shape):
            raise ValueError(f"{name}: shape {arr.shape} != the engine's "
                             f"{tuple(bufs[name].shape)}")
    return unflatten({name: _tensor(arr, name, engine.opt.dtype)
                      .to(engine.device) for name, arr in flat.items()})
