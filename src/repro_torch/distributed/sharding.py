"""Logical-axis sharding rules -> per-leaf mesh specs (DP/TP/EP/SP/FSDP).

The port's copy of the reference's ``distributed/sharding.py``, with no
JAX: a spec is a tuple of mesh-axis names (or None, or a tuple of names)
per dimension, trailing Nones dropped (``()`` is replicated), and a mesh
is its axis sizes plus a device list (``Mesh``).  The models name every
parameter's axes logically (``Model.axes()``: "embed", "heads", "ffn",
"vocab", ...); ``param_rules`` maps those names to mesh axes under a
``ShardingStrategy`` and ``resolve_spec`` resolves each leaf with the
reference's two rules: a dimension that does not divide its mesh extent
falls back to a whole copy, and a mesh axis is used by one dimension at
most.  ``kv_cache_shardings`` does the same for a decode cache (the
kv-head axis of K and V, the trailing kv-head axis of an int8 pool's
scale rows).

The reference hands these specs to GSPMD, which partitions the jitted
step and inserts its collectives.  The port's tensor-parallel step
(``models/tensor_parallel.py``) is explicit: one process holds every
rank's shard (``local_shard``) and runs the ranks' programs, so the
reference's ``active`` / ``constrain`` (GSPMD's in-graph activation
hints) and ``tree_param_shardings`` (a NamedSharding per leaf for
``device_put``) have no counterpart here; ``activation_rules`` stays as
the table of where the activations live.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes with their sizes, and the devices in row-major
    order over them (empty for an abstract mesh, which only resolves
    specs)."""

    axes: tuple[tuple[str, int], ...]
    devices: tuple = ()

    def __post_init__(self) -> None:
        n = 1
        for _, size in self.axes:
            n *= size
        if self.devices and len(self.devices) != n:
            raise ValueError(f"a mesh of {dict(self.axes)} takes {n} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, size in self.axes:
            n *= size
        return n

    def coords(self, index: int) -> dict[str, int]:
        """The axis coordinates of device ``index`` (row-major)."""
        out = {}
        for name, size in reversed(self.axes):
            out[name] = index % size
            index //= size
        return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: Spec = ()


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    """Which parallelism features are active and on which mesh axes."""

    dp_axes: tuple[str, ...] = ("data",)   # batch / gradient all-reduce
    tp_axis: str | None = "model"          # tensor parallel (heads/ffn/vocab)
    fsdp: bool = False                     # shard 'embed' of params over dp
    sp: bool = False                       # sequence-parallel activations
    ep_axis: str | None = None             # experts; defaults to tp_axis

    @property
    def expert_axis(self) -> str | None:
        return self.ep_axis or self.tp_axis


def strategy_for_mesh(mesh: Mesh, **kw) -> ShardingStrategy:
    """Default strategy: every non-'model' mesh axis is data-parallel."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    tp = "model" if "model" in mesh.axis_names else None
    return ShardingStrategy(dp_axes=dp, tp_axis=tp, **kw)


def param_rules(s: ShardingStrategy) -> dict[str, Any]:
    """Logical axis name -> mesh axes of a parameter; unlisted names are
    replicated."""
    tp = s.tp_axis
    return {
        "vocab": tp, "heads": tp, "kv_heads": tp, "ffn": tp,
        "experts": s.expert_axis, "dinner": tp, "lru": tp,
        "embed": s.dp_axes if s.fsdp else None,
        "q_lora": None, "kv_lora": None,
        "layers": None, "pos": None, "state": None,
    }


def activation_rules(s: ShardingStrategy) -> dict[str, Any]:
    """Where the activations live: the batch over the dp axes; with
    Megatron-SP the residual stream's tokens over the tp axis."""
    return {
        "batch": s.dp_axes,
        "seq": s.tp_axis if s.sp else None,
        "heads": s.tp_axis, "kv_heads": s.tp_axis, "ffn": s.tp_axis,
        "experts": s.expert_axis, "embed": None, "vocab": s.tp_axis,
        "dinner": s.tp_axis, "lru": s.tp_axis,
    }


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def resolve_spec(logical: tuple, shape: tuple[int, ...], rules: dict,
                 mesh: Mesh) -> Spec:
    """Translate a logical spec to mesh axes with the divisibility
    fallback; a mesh axis already used by an earlier dim is dropped."""
    out: list = []
    used: set[str] = set()
    names = tuple(logical) + (None,) * (len(shape) - len(logical))
    for dim, name in enumerate(names):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        ax_tuple = tuple(a for a in ax_tuple
                         if a in mesh.shape and a not in used)
        if not ax_tuple or shape[dim] % _axis_size(mesh, ax_tuple) != 0:
            out.append(None)
            continue
        used.update(ax_tuple)
        out.append(ax_tuple[0] if len(ax_tuple) == 1 else ax_tuple)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tp_mesh(devices) -> Mesh:
    """A ``(data=1, model=len(devices))`` mesh over an explicit device
    list: one serving replica's tensor-parallel group (the replica set's
    data parallelism lives on the host, ``serving.cluster``)."""
    devs = tuple(devices)
    if not devs:
        raise ValueError("tp_mesh needs at least one device")
    return Mesh((("data", 1), ("model", len(devs))), devs)


def kv_cache_shardings(mesh: Mesh, cache, strategy: ShardingStrategy):
    """Shardings for a decode cache, mirroring ``param_rules``' kv_heads
    rule with the same per-leaf divisibility fallback.

    A KV cache is recognized structurally (a NamedTuple whose first two
    fields are ``k`` / ``v``): the value leaves ``[L, rows, cols, n_kv,
    hd]`` shard the kv-head axis (-2) over the tp axis, int8 scale rows
    (the values' shape without hd) their trailing kv-head axis, and every
    other leaf (MLA latents, recurrent state) is replicated.  A kv-head
    count that does not divide the tp extent replicates that leaf."""
    tp = strategy.tp_axis
    tp_n = mesh.shape.get(tp, 1) if tp is not None else 1
    rep = NamedSharding(mesh)

    def axis_spec(leaf, axis: int) -> NamedSharding:
        nd = len(leaf.shape)
        if tp_n > 1 and nd > axis % nd and leaf.shape[axis] % tp_n == 0:
            return NamedSharding(mesh, (None,) * (axis % nd) + (tp,))
        return rep

    def walk(node):
        if node is None:
            return None
        fields = getattr(node, "_fields", None)
        if fields is not None and fields[:2] == ("k", "v"):
            return type(node)(
                axis_spec(node.k, -2), axis_spec(node.v, -2),
                *(None if s is None else axis_spec(s, -1)
                  for s in node[2:]))
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v) for v in node]
            return type(node)(*out) if fields is not None \
                else type(node)(out)
        return rep

    return walk(cache)


def batch_sharding(mesh: Mesh, strategy: ShardingStrategy,
                   ndim: int = 2) -> NamedSharding:
    """Tokens / targets [B, S, ...]: the batch over the dp axes."""
    dp = tuple(a for a in strategy.dp_axes if a in mesh.shape)
    spec = [dp if dp else None] + [None] * (ndim - 1)
    while spec and spec[-1] is None:
        spec.pop()
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh)


def _shards(mesh: Mesh, spec: Spec) -> int:
    n = 1
    for axes in spec:
        if axes is not None:
            n *= _axis_size(mesh, axes)
    return n


def per_device_bytes(tree: Mapping, mesh: Mesh,
                     shardings: Mapping) -> int:
    """Static estimate of per-device bytes of a flat tree (name -> a
    tensor or anything with ``shape`` and a torch ``dtype``) under its
    shardings (name -> ``NamedSharding``)."""
    total = 0
    for name, leaf in tree.items():
        n = 1
        for d in leaf.shape:
            n *= d
        size = leaf.dtype.itemsize
        total += n * size // max(_shards(mesh, shardings[name].spec), 1)
    return total


def local_shard(t, spec: Spec, mesh: Mesh, index: int):
    """Device ``index``'s block of ``t`` under ``spec``: each sharded
    dimension is cut into equal blocks, block ``i`` the device's
    coordinate on the dimension's axes (row-major over a tuple of axes).
    A view where ``t`` is a tensor."""
    coords = mesh.coords(index)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        n, block = 1, 0
        for a in names:
            block = block * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        size = t.shape[dim] // n
        t = t.narrow(dim, block * size, size)
    return t


def shard_shape(shape: tuple[int, ...], spec: Spec,
                mesh: Mesh) -> tuple[int, ...]:
    """The shape of one device's block of a leaf of ``shape``."""
    out = list(shape)
    for dim, axes in enumerate(spec):
        if axes is not None:
            out[dim] //= _axis_size(mesh, axes)
    return tuple(out)
