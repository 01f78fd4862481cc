"""Weights carried over from the JAX reference.

``from_jax_params(np_tree, cfg, device, dtype)`` takes the parameter
pytree of the reference's ``Model(cfg).init(key)`` with every leaf already
converted to a numpy array (the caller does that conversion; this module
imports no JAX) and returns a state dict of the port's ``Model``, so both
packages compute the same function.  The reference stacks the layers on a
leading axis; the port keeps one module per layer, so that axis is
unstacked into ``layers.<i>.``.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def from_jax_params(np_tree: Mapping, cfg: ArchConfig, device,
                    dtype: torch.dtype = torch.float32
                    ) -> dict[str, torch.Tensor]:
    """State dict of the port's ``Model(cfg)`` from the reference's params.

    ``dtype`` is the dtype of the returned tensors (the parameter dtype);
    ``Model.load_state_dict`` casts dense kernels to the compute dtype.
    """
    flat = _flatten(np_tree)
    out: dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtype)
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
