"""Data-parallel serving replicas behind one admission queue.

The port's copy of the reference's ``serving/cluster.py``.  Tensor
parallelism lives inside one ``ServingEngine`` (its ``spec.mesh.tp`` ranks
share the fused step, ``models/tensor_parallel.py``); data parallelism
lives here: ``dp`` independent engines, each with ``MeshSpec(tp, 1)`` on
its own slice of the devices, with its own pool and prefix-cache
namespace, behind one host-side admission surface.  Nothing is split
across replicas: a request lives its whole life on the replica that
admitted it, so its stream is the single engine's (the same program and
lane arithmetic, fewer neighbours per pool).  A replica with tp = 1 runs
the spec's route, the hand-written kernels under ``"pallas"``; slices
may repeat a device (one card holds every replica).

The cluster stands in for a ``ServingEngine`` wherever only the public
serving surface is touched (``submit`` / ``step`` / ``queue`` /
``slot_req`` / ``events`` / ``stats`` / ``compilations`` /
``run_to_completion`` / ``load``), which is what ``harness.replay`` and
the metrics read.  Every replica's events are relayed onto the cluster's
bus under cluster uids and the cluster's logical clock (rounds of
replica steps), so ``reduce_events`` reads the merged log as it is.

Placement is by free capacity: each submit goes to the replica with the
most free pool blocks net of the blocks its queue already asks for (the
dense layout: free slots net of its queue's length); ties go to the
lowest replica index.  The router reads host state only, so placement,
and with it the whole replay, is deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.paging import blocks_for_tokens
from repro_torch.core.spec import MeshSpec, RuntimeSpec
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.events import EngineEvent, EventBus
from repro_torch.serving.sampling import SamplingParams


def _cluster_devices(mesh: MeshSpec, devices) -> list:
    need = mesh.n_devices
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(min(n, need))]
    devs = list(devices)
    if len(devs) < need:
        raise ValueError(
            f"mesh tp={mesh.tp} x dp={mesh.dp} needs {need} devices but "
            f"only {len(devs)} are visible; pass devices= with one device "
            f"per rank (launch.mesh.dev_devices({need}, allow_repeat=True) "
            "repeats one card)")
    return devs


class EngineCluster:
    """``spec.mesh.dp`` ``ServingEngine`` replicas, one admission queue.
    ``devices``: ``tp * dp`` torch devices, replica i taking ``devices[i
    * tp:(i + 1) * tp]`` (default: the CUDA devices, never the host);
    ``sampling``, ``seed`` and ``graphs`` go to every replica."""

    def __init__(self, spec: RuntimeSpec, *, devices=None,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 graphs: bool | None = None):
        mesh = spec.mesh
        devs = _cluster_devices(mesh, devices)
        self.spec = spec
        replica_spec = dataclasses.replace(spec,
                                           mesh=MeshSpec(tp=mesh.tp, dp=1))
        self.replicas: list[ServingEngine] = [
            ServingEngine(replica_spec, sampling=sampling, seed=seed,
                          graphs=graphs,
                          devices=devs[i * mesh.tp:(i + 1) * mesh.tp])
            for i in range(mesh.dp)]
        self.events = EventBus()
        self.stats: dict[str, int] = {"decode_steps": 0}
        self._uid = 0
        # per replica {replica uid -> cluster uid}; an entry lives from
        # submit to finish (across preemptions)
        self._maps: list[dict[int, int]] = [{} for _ in self.replicas]
        for i, eng in enumerate(self.replicas):
            eng.events.subscribe(self._relay(i))

    def _relay(self, idx: int):
        """Republish one replica's events under cluster uids and clock."""

        def cb(e: EngineEvent) -> None:
            if not self.events.active:
                return
            uid = self._maps[idx].get(e.uid)
            if uid is None:        # an event of a request not routed here
                return
            self.events.publish(EngineEvent(
                e.kind, uid, self.stats["decode_steps"], e.t, e.data))

        return cb

    def load(self, params, draft=None) -> None:
        """Install the same weights on every replica."""
        for eng in self.replicas:
            eng.load(params, draft=draft)

    def _place(self) -> int:
        """The replica with the most free capacity net of queued demand;
        ties to the lowest index."""
        best, best_score = 0, None
        for i, eng in enumerate(self.replicas):
            if eng.paging is not None:
                bs = eng.paging.block_size
                demand = sum(
                    blocks_for_tokens(len(r.prompt) + len(r.prefix), bs)
                    for r in eng.queue)
                score = eng.allocator.num_free - demand
            else:
                free = sum(r is None for r in eng.slot_req)
                score = free - len(eng.queue)
            if best_score is None or score > best_score:
                best, best_score = i, score
        return best

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               eos_id=None, sampling=None, model: int = 0) -> int:
        idx = self._place()
        eng = self.replicas[idx]
        # the replica publishes its "submit" event inside submit(), so the
        # uid mapping goes in first; every refusal raises before the
        # replica takes its uid, so the prediction is exact
        ruid = eng._uid + 1
        self._uid += 1
        self._maps[idx][ruid] = self._uid
        try:
            got = eng.submit(prompt, max_new_tokens=max_new_tokens,
                             eos_id=eos_id, sampling=sampling, model=model)
        except Exception:
            del self._maps[idx][ruid]
            self._uid -= 1
            raise
        if got != ruid:
            raise RuntimeError(f"replica {idx} gave uid {got}, not {ruid}")
        return self._uid

    @staticmethod
    def _busy(eng: ServingEngine) -> bool:
        return bool(eng.queue) or any(r is not None for r in eng.slot_req)

    def step(self) -> list[Request]:
        """One cluster round: every replica with work advances one fused
        step.  Returns the requests finished in the round, under cluster
        uids."""
        done: list[Request] = []
        stepped = False
        for i, eng in enumerate(self.replicas):
            if not self._busy(eng):
                continue
            stepped = True
            for req in eng.step():
                req.uid = self._maps[i].pop(req.uid)
                done.append(req)
        if stepped:
            self.stats["decode_steps"] += 1
        return done

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        done: list[Request] = []
        steps = 0
        while any(self._busy(eng) for eng in self.replicas):
            if steps >= max_steps:
                raise RuntimeError(
                    f"cluster did not drain within max_steps={max_steps}")
            done += self.step()
            steps += 1
        return done

    # the replay surface (harness.replay reads only these)
    @property
    def queue(self) -> list[Request]:
        return [r for eng in self.replicas for r in eng.queue]

    @property
    def slot_req(self) -> list[Request | None]:
        return [r for eng in self.replicas for r in eng.slot_req]

    @property
    def compilations(self) -> list[dict[str, int]]:
        """Each replica's compile counts (one capture per program on
        every replica)."""
        return [dict(eng.compilations) for eng in self.replicas]

    def replica_stats(self) -> list[dict[str, Any]]:
        return [dict(eng.stats) for eng in self.replicas]
