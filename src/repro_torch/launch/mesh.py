"""The device list a mesh runs on (the reference's ``launch/mesh.py``).

``dev_devices(n)`` gives one torch device per rank of an ``n``-device
mesh: the visible CUDA devices in order, the one card repeated where the
mesh asks for more ranks than there are cards (only with
``allow_repeat=True``: ranks that share a card share its memory and its
time, so a caller asks for that), or the host's CPU where the caller
names it (``device="cpu"``).  ``mesh_device_count`` counts a mesh's
devices.

The reference's ``ensure_host_devices`` asks XLA for forced host-platform
devices before JAX starts; the port has no counterpart, since a torch
device list may name the host (or a card) any number of times.  Its
``make_production_mesh`` / ``make_dev_mesh`` build JAX meshes for the
dry-run (ROADMAP.md Queue 1 item 17b).
"""
from __future__ import annotations

import torch


def dev_devices(n: int, *, device: str | torch.device | None = None,
                allow_repeat: bool = False) -> list[torch.device]:
    """``n`` devices for the ranks of a mesh: ``device`` (the host, say)
    or the visible CUDA devices, repeated to ``n`` only where
    ``allow_repeat``; raises where there are fewer and repeats are not
    allowed, or where no CUDA device is visible and no ``device`` named."""
    if n < 1:
        raise ValueError(f"dev_devices needs n >= 1, got {n}")
    if device is not None:
        have = [torch.device(device)]
    elif torch.cuda.is_available():
        have = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "for the host")
    if n > len(have) and not allow_repeat:
        raise ValueError(
            f"a mesh of {n} devices on {len(have)} visible ({have}): pass "
            "allow_repeat=True to run several ranks on one device")
    return [have[i % len(have)] for i in range(n)]


def mesh_device_count(mesh) -> int:
    """Devices of a mesh: a ``MeshSpec`` (tp x dp) or a
    ``distributed.sharding.Mesh`` (the product of its axis sizes)."""
    if hasattr(mesh, "n_devices"):
        return mesh.n_devices
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n
