"""Checkpoints: atomic, resumable, async (the reference's
``training/checkpoint.py`` on one device).

Layout (one directory per step):
    <dir>/step_00000123/
        arrays.npz          every leaf, keyed by its path: params/<name>,
                            opt/step, opt/m/<name>, opt/v/<name> for a
                            TrainState (a dict's keys for a dict)
        meta.json           step, data-stream state, anything the caller adds
        COMMITTED           written last; partial checkpoints are invisible

A save writes a directory of its own (``step_X.tmp<pid>_<thread>_<ns>``)
and renames it into place only after COMMITTED exists, so a failure in the
middle of a save never reaches the restore path.  The device-to-host
copy is taken in the call, so the snapshot is the state at the call;
with ``async_write`` the files are then written by a thread (join it)
while training goes on.  bfloat16 leaves are stored as float32 (exact)
and cast back on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.core.spec import _not_ported


def _leaves(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """{path: tensor} of a tensor, a dict or a NamedTuple (its fields by
    name) of those, nested."""
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): tree}
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if not isinstance(tree, Mapping):
        raise TypeError(f"{prefix or 'the state'}: a checkpoint holds "
                        f"tensors, dicts and NamedTuples, not {type(tree)}")
    out = {}
    for key, val in tree.items():
        out.update(_leaves(val, f"{prefix}{key}/"))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of it, so later in-place
    updates do not reach the snapshot)."""
    t = t.detach()
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.to("cpu", copy=True).numpy()


def save(directory: str, step: int, state: Any, *,
         meta: dict | None = None, keep: int = 3,
         async_write: bool = False) -> threading.Thread | None:
    """Write one checkpoint of ``state`` at ``step``; returns the writer
    thread with ``async_write``.  ``keep`` committed steps are kept (0:
    all)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    # unique tmp per call: an async writer and a later sync writer of the
    # same step never collide (the rename stays atomic either way)
    tmp = final + f".tmp{os.getpid()}_{threading.get_ident()}_{time.time_ns()}"
    # device -> host copy here, synchronously (a consistent snapshot)
    arrays = {k: _host(t) for k, t in _leaves(state).items()}

    def write():
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        try:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except OSError:
            # a concurrent writer of the same step won the rename; the
            # committed content is identical: drop this copy
            if os.path.exists(os.path.join(final, "COMMITTED")):
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                raise
        _gc(directory, keep)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _committed(directory: str) -> list[str]:
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and ".tmp" not in d
                  and os.path.exists(os.path.join(directory, d, "COMMITTED")))


def _gc(directory: str, keep: int) -> None:
    for d in _committed(directory)[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    """The newest committed step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _committed(directory)
    return int(steps[-1].split("_")[1]) if steps else None


def _rebuild(like: Any, leaves: dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(like, torch.Tensor):
        return leaves[prefix.rstrip("/")]
    if isinstance(like, tuple) and hasattr(like, "_asdict"):
        return type(like)(**{k: _rebuild(v, leaves, f"{prefix}{k}/")
                             for k, v in like._asdict().items()})
    return {k: _rebuild(v, leaves, f"{prefix}{k}/") for k, v in like.items()}


def restore(directory: str, step: int, like: Any,
            shardings: Any | None = None) -> tuple[Any, dict]:
    """(state, meta) of step ``step``, in the structure of ``like``: every
    leaf a new tensor of its ``like`` leaf's shape (checked), dtype,
    device and ``requires_grad``.  ``shardings`` (an elastic restore onto
    another mesh) is refused."""
    if shardings is not None:
        raise _not_ported("a sharded restore (shardings=...)", "item 16c")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for path, leaf in _leaves(like).items():
            arr = data[path]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint/param shape mismatch at {path}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            leaves[path] = torch.from_numpy(arr).to(
                device=leaf.device, dtype=leaf.dtype).requires_grad_(
                    leaf.requires_grad)
    return _rebuild(like, leaves), meta


def restore_latest(directory: str, like: Any,
                   shardings: Any | None = None) -> tuple[Any, dict] | None:
    step = latest_step(directory)
    if step is None:
        return None
    return restore(directory, step, like, shardings)
