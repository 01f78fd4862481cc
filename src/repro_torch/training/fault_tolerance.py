"""Fault tolerance & elasticity: heartbeats, stragglers, re-mesh plans
(the port's own copy of the reference's pure-Python controller).

At 1000+ nodes the failure model is: hosts stop heartbeating (hard fail),
or keep heartbeating but fall behind (straggler).  The controller below is
deterministic and host-agnostic so the whole policy is unit-testable in
one process; on a real cluster the inputs come from the coordination
service and the output plan drives the re-initialization of
``torch.distributed`` and a restore onto the new mesh (the port restores
onto one device only so far: ``training.checkpoint.restore`` refuses
``shardings``, ROADMAP.md Queue 1 item 16c).

Policy:
* hard failure  -> shrink the data axis to the largest feasible size,
  restore the latest committed checkpoint onto the new mesh (elastic
  downscale); model-axis loss is fatal for TP-sharded weights, so model
  columns are only ever removed in whole data-slices.
* straggler     -> first mitigate in-band (the step itself is synchronous,
  so one slow host gates the step): re-assign its data shard and mark it
  for eviction at the next checkpoint boundary.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float = 0.0
    step_times: list[float] = field(default_factory=list)
    evicted: bool = False


@dataclass(frozen=True)
class ReMeshPlan:
    """What the controller decides after failures: the new mesh and the
    restart point."""

    old_mesh: tuple[int, ...]
    new_mesh: tuple[int, ...]
    axis_names: tuple[str, ...]
    restore_step: int
    dropped_hosts: tuple[int, ...]
    reason: str

    @property
    def new_device_count(self) -> int:
        return math.prod(self.new_mesh)


class ClusterMonitor:
    """Heartbeat + straggler tracking over deterministic, injected time."""

    def __init__(self, n_hosts: int, *, heartbeat_timeout: float = 60.0,
                 straggler_factor: float = 2.0, min_samples: int = 5):
        self.hosts = {i: HostState(i) for i in range(n_hosts)}
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.min_samples = min_samples

    def heartbeat(self, host_id: int, now: float) -> None:
        self.hosts[host_id].last_heartbeat = now

    def record_step(self, host_id: int, seconds: float) -> None:
        h = self.hosts[host_id]
        h.step_times.append(seconds)
        if len(h.step_times) > 50:
            h.step_times.pop(0)

    def dead_hosts(self, now: float) -> list[int]:
        return [i for i, h in self.hosts.items()
                if not h.evicted
                and now - h.last_heartbeat > self.heartbeat_timeout]

    def stragglers(self) -> list[int]:
        """Hosts whose median step time exceeds factor x cluster median."""
        med = {}
        for i, h in self.hosts.items():
            if h.evicted or len(h.step_times) < self.min_samples:
                continue
            ts = sorted(h.step_times)
            med[i] = ts[len(ts) // 2]
        if len(med) < 2:
            return []
        cluster = sorted(med.values())[len(med) // 2]
        return [i for i, m in med.items()
                if m > self.straggler_factor * cluster]

    def evict(self, host_id: int) -> None:
        self.hosts[host_id].evicted = True

    @property
    def live_count(self) -> int:
        return sum(1 for h in self.hosts.values() if not h.evicted)


def plan_remesh(mesh_shape: tuple[int, ...], axis_names: tuple[str, ...],
                devices_per_host: int, failed_hosts: list[int],
                last_checkpoint_step: int, *, data_axes: tuple[str, ...] =
                ("pod", "data"), reason: str = "host failure") -> ReMeshPlan:
    """Shrink data-parallel axes to fit the surviving device count.

    TP ('model') extent is preserved — model-sharded weights cannot lose
    columns.  The data extent is rounded down to the largest value such
    that the new mesh fits the surviving devices.
    """
    total = math.prod(mesh_shape)
    survivors = total - devices_per_host * len(failed_hosts)
    sizes = dict(zip(axis_names, mesh_shape))
    model = sizes.get("model", 1)
    fixed = model
    budget = survivors // fixed
    if budget < 1:
        raise RuntimeError("not enough survivors to keep the model axis; "
                           "full restart required")
    # greedily shrink the innermost data axis first, dropping 'pod' last
    new_sizes = dict(sizes)
    names_in_order = [a for a in axis_names if a in data_axes]
    while math.prod(new_sizes[a] for a in names_in_order) > budget:
        for a in reversed(names_in_order):
            if new_sizes[a] > 1:
                new_sizes[a] -= 1
                break
        else:
            break
    new_mesh = tuple(new_sizes[a] for a in axis_names)
    return ReMeshPlan(old_mesh=mesh_shape, new_mesh=new_mesh,
                      axis_names=axis_names,
                      restore_step=last_checkpoint_step,
                      dropped_hosts=tuple(failed_hosts), reason=reason)


@dataclasses.dataclass
class TrainController:
    """Glue: monitor -> plan -> (restore + recompile) decisions."""

    monitor: ClusterMonitor
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    devices_per_host: int
    last_checkpoint_step: int = 0

    def on_checkpoint(self, step: int) -> None:
        self.last_checkpoint_step = step

    def poll(self, now: float) -> ReMeshPlan | None:
        dead = self.monitor.dead_hosts(now)
        if dead:
            for h in dead:
                self.monitor.evict(h)
            return plan_remesh(self.mesh_shape, self.axis_names,
                               self.devices_per_host, dead,
                               self.last_checkpoint_step)
        slow = self.monitor.stragglers()
        if slow:
            for h in slow:
                self.monitor.evict(h)
            return plan_remesh(self.mesh_shape, self.axis_names,
                               self.devices_per_host, slow,
                               self.last_checkpoint_step,
                               reason="straggler eviction")
        return None
