"""Checkpoints, resume, the fault-tolerance controller and the training
CLI of the port, on the CPU.

* The reference's three checkpoint tests on the port: a round trip of a
  granite-moe (reduced) state after 3 steps that trains on identically,
  an uncommitted step invisible to ``latest_step``, ``keep`` collecting
  old steps.
* Resume: k + 3 steps straight equal, bit for bit (losses and every
  leaf of the final state), k steps, a save, a restore into a fresh
  state and 3 more, the data stream restored from the checkpoint's meta.
* An ``async_write`` save is complete once its writer is joined;
  ``restore(shardings=...)`` places the leaves on the given mesh, and a
  shape mismatch is refused.
* The reference's three fault-tolerance tests on the port's controller,
  with every plan equal to the reference's on the same inputs.
* ``python -m repro_torch.launch.train --device cpu`` (reduced) for 6
  steps with checkpoints every 2; with the last removed, ``--resume``
  restarts from step 4 and writes a step 6 equal to the first, bit for
  bit.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro.training import fault_tolerance as jft
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.distributed import sharding
from repro_torch.launch.train import main as train_main
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import fault_tolerance as ft
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                             make_step_fn)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def _fixed_batch(cfg, b=4, s=32, seed=7):
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s + 1)))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _setup(name: str, oc: AdamWConfig):
    cfg = reduced(get_config(name))
    model = Model(cfg, device="cpu", trainable=True)
    state = init_state(model, torch.Generator().manual_seed(0), oc)
    return cfg, model, state, make_step_fn(model, TrainStepConfig(
        optimizer=oc))


def _leaves(state) -> dict[str, torch.Tensor]:
    return ckpt._leaves(state)


def _equal(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k].detach(), lb[k].detach()), k


def test_checkpoint_roundtrip_and_resume(tmp_path):
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    cfg, _, state, step = _setup("granite-moe-1b-a400m", oc)
    batch = _fixed_batch(cfg)
    for _ in range(3):
        state, _ = step(state, batch)
    ckpt.save(str(tmp_path), 3, state, meta={"data_state": {"step": 3}})
    got, meta = ckpt.restore_latest(str(tmp_path), state)
    assert meta["step"] == 3 and meta["data_state"]["step"] == 3
    _equal(state, got)
    assert all(p.requires_grad for p in got.params.values())
    # training continues identically after restore
    _, m_restored = step(got, batch)
    _, m_direct = step(state, batch)
    assert float(m_direct["loss"]) == float(m_restored["loss"])


def test_checkpoint_atomicity(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.ones(4)})
    # a partial (uncommitted) later step must be invisible
    os.makedirs(tmp_path / "step_00000002")
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_gc(tmp_path):
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, {"x": torch.ones(2)}, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]


def test_resume_is_bit_exact(tmp_path):
    """k + 3 straight steps = k steps, an async save, a restore into a
    fresh state and 3 more (the stream restored from the meta)."""
    k = 2
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                     moment_dtype=torch.bfloat16)
    cfg, _, state, step = _setup("qwen1.5-0.5b", oc)
    data = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                device="cpu")
    stream = SyntheticLMStream(**data)
    straight = []
    for i in range(k + 3):
        state, m = step(state, stream.next())
        straight.append(float(m["loss"]))
        if i + 1 == k:
            writer = ckpt.save(str(tmp_path), k, state, async_write=True,
                               meta={"data_state": stream.state()})
    writer.join(timeout=60)
    assert not writer.is_alive()
    _, _, fresh, step2 = _setup("qwen1.5-0.5b", oc)
    got, meta = ckpt.restore_latest(str(tmp_path), fresh)
    assert meta["step"] == k
    stream2 = SyntheticLMStream.restore(meta["data_state"], **data)
    resumed = straight[:k]
    for _ in range(3):
        got, m = step2(got, stream2.next())
        resumed.append(float(m["loss"]))
    assert resumed == straight
    _equal(state, got)
    assert got.opt.m["embed.table"].dtype == torch.bfloat16


def test_async_save_is_complete_after_join(tmp_path):
    state = {"w": torch.randn(64, 64), "step": torch.tensor(3)}
    at_call = state["w"].clone()
    writer = ckpt.save(str(tmp_path), 3, state, async_write=True)
    # the snapshot is the state at the call
    state["w"].add_(1.0)
    writer.join(timeout=60)
    assert not writer.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 3
    got, _ = ckpt.restore(str(tmp_path), 3, state)
    assert torch.equal(got["w"], at_call)
    assert not any(".tmp" in d for d in os.listdir(tmp_path))


def test_restore_refuses_shardings_and_checks_shapes(tmp_path):
    """The sharded restore (the name is the one the test had while the
    port refused ``shardings``): every leaf placed on the given mesh,
    each rank's block its own copy; a shape mismatch still refused."""
    x = torch.arange(8.0).reshape(4, 2)
    ckpt.save(str(tmp_path), 1, {"x": x})
    mesh = sharding.Mesh((("data", 2), ("model", 1)), ("cpu", "cpu"))
    sh = {"x": sharding.NamedSharding(mesh, ("data",))}
    got, meta = ckpt.restore(str(tmp_path), 1, {"x": torch.zeros(4, 2)},
                             shardings=sh)
    assert meta["step"] == 1 and got["x"].spec == ("data",)
    assert [s.tolist() for s in got["x"].shards] == [x[:2].tolist(),
                                                     x[2:].tolist()]
    assert torch.equal(sharding.assemble(got)["x"], x)
    # a Sharded ``like`` restores onto its own mesh
    again, _ = ckpt.restore(str(tmp_path), 1, got)
    assert again["x"].shards[1] is not got["x"].shards[1]
    assert torch.equal(again["x"].shards[1], x[2:])
    with pytest.raises(ValueError, match="shape mismatch at x"):
        ckpt.restore(str(tmp_path), 1, {"x": torch.ones(5)})


# ---------------------------------------------------------------------------
# Fault tolerance: the port's controller against the reference's
# ---------------------------------------------------------------------------
def _both(fn):
    """fn(module) run on the port's and the reference's controller; the
    plans (or None) as dicts, equal."""
    got, want = fn(ft), fn(jft)
    as_dict = lambda p: None if p is None else dataclasses.asdict(p)
    assert as_dict(got) == as_dict(want)
    return got


def test_heartbeat_failure_triggers_remesh():
    def run(mod):
        mon = mod.ClusterMonitor(n_hosts=8, heartbeat_timeout=30.0)
        ctl = mod.TrainController(mon, mesh_shape=(2, 16, 16),
                                  axis_names=("pod", "data", "model"),
                                  devices_per_host=4)
        for h in range(8):
            mon.heartbeat(h, now=0.0)
        ctl.on_checkpoint(1200)
        for h in range(7):
            mon.heartbeat(h, now=40.0)  # host 7 silent
        return ctl.poll(now=65.0)
    plan = _both(run)
    assert plan is not None and plan.dropped_hosts == (7,)
    assert plan.restore_step == 1200
    assert plan.new_mesh[2] == 16
    assert plan.new_device_count <= 512 - 4


def test_straggler_detection_and_eviction():
    def run(mod):
        mon = mod.ClusterMonitor(n_hosts=4, straggler_factor=2.0,
                                 min_samples=3)
        for h in range(4):
            mon.heartbeat(h, 0.0)
            for _ in range(5):
                mon.record_step(h, 1.0 if h != 2 else 5.0)
        assert mon.stragglers() == [2]
        ctl = mod.TrainController(mon, mesh_shape=(16, 16),
                                  axis_names=("data", "model"),
                                  devices_per_host=8)
        return ctl.poll(now=1.0)
    plan = _both(run)
    assert plan is not None and plan.reason == "straggler eviction"
    assert plan.new_mesh[1] == 16


def test_remesh_never_kills_model_axis():
    plan = _both(lambda mod: mod.plan_remesh(
        (2, 16, 16), ("pod", "data", "model"), devices_per_host=8,
        failed_hosts=[0, 1, 2], last_checkpoint_step=10))
    assert plan.new_mesh[2] == 16
    assert plan.new_device_count <= 512 - 24


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--seq", "16", "--steps",
            "6", "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir",
            str(tmp_path)]
    train_main(args)
    out = capsys.readouterr().out
    assert "step     6  loss" in out and out.rstrip().endswith("done")
    last = tmp_path / "step_00000006"
    with np.load(last / "arrays.npz") as f:
        want = {k: f[k] for k in f.files}
    # drop the last checkpoint: --resume restarts from step 4
    shutil.rmtree(last)
    train_main([*args, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step     5  loss" in out
    with np.load(last / "arrays.npz") as got:
        assert sorted(got.files) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
