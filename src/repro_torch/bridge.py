"""Weights carried over from the JAX reference.

``from_jax_params(np_tree, cfg, device, dtype)`` takes the parameter
pytree of the reference's ``Model(cfg).init(key)`` with every leaf already
converted to a numpy array (the caller does that conversion; this module
imports no JAX) and returns a state dict of the port's ``Model``, so both
packages compute the same function.  The reference stacks the layers on a
leading axis; the port keeps one module per layer, so that axis is
unstacked into ``layers.<i>.``.

A tree the reference has quantized (its ``serve_quant.quantize_params``)
holds ``QTensor`` leaves; after the numpy conversion each is a
``(values, scale)`` pair.  Its int8 values land under the leaf's name and
its float32 scale under ``<name>_scale``, unstacked like the float leaves,
so a test can hand both packages the same int8 weights.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.serve_quant import SCALE_SUFFIX


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
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
    out: dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        t = _tensor(arr, name, dtype)
        if name.startswith("layers."):
            if t.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: leading axis {t.shape[0]} != "
                                 f"num_layers={cfg.num_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.num_layers):
                out[f"layers.{i}.{rest}"] = t[i].to(device).contiguous()
        else:
            out[name] = t.to(device)
    return out
