"""The port's analytical autotuner (``repro_torch.harness.tune``) against
the reference's ``repro.harness.tune`` on the CPU.

The reference suite's cases (``tests/test_harness.py``'s tuner tests) run
through both tuners on the same device numbers: the port's
``DeviceProfile`` takes a ``GPUSpec`` built here from the reference
``V5E``'s fields.  Both must give the same ranking: summaries equal
key for key (floats to a relative 1e-12), scores and predictions alike,
and the winners' specs field for field; except the points the port's
spec drops (the tune docstring's list), checked as drops.  Also:
``RuntimeSpec.tuned == tune(...).spec``, ``naive_default`` at equal
memory, the int8 KV opt-in, speculation candidates with a draft, the
fleet's per-token bytes against ``DecodeFabric``, the mesh profiles
(more devices, cards per replica, an interconnect rate) ranked as the
reference ranks them, and ``serve --device cpu --tuned`` on reduced
qwen1.5-0.5b.
"""
import dataclasses
import importlib
import math

import pytest

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import reduced as ref_reduced
from repro.core import analytical as ref_an
from repro.core import spec as ref_spec
from repro_torch.configs import get_config, reduced
from repro_torch.core.analytical import H100, GPUSpec
from repro_torch.core.spec import (ExecutionSpec, MeshSpec, RuntimeSpec,
                                   maxima_for)
from repro_torch.harness import (DeviceProfile, WorkloadProfile,
                                 naive_default, shared_prefix_trace, tune)
from repro_torch.harness.tune import Candidate, _per_token_bytes, cache_bytes
from test_torch_threads import one_thread  # noqa: F401 (autouse)

# the modules (``repro.harness`` exports the function ``tune``)
ref_tune = importlib.import_module("repro.harness.tune")
ref_trace = importlib.import_module("repro.harness.trace")

REF_GPU = GPUSpec(name=ref_an.V5E.name, peak_flops=ref_an.V5E.peak_flops,
                  hbm_bw=ref_an.V5E.hbm_bw, link_bw=ref_an.V5E.ici_bw,
                  hbm_bytes=ref_an.V5E.hbm_bytes,
                  smem_bytes=ref_an.V5E.vmem_bytes,
                  mma_tile=ref_an.V5E.mxu_tile)
QWEN = "qwen1.5-0.5b"
REL = 1e-12


def _pair(name):
    return reduced(get_config(name)), ref_reduced(REF_REGISTRY[name])


def _devices(**kw):
    return DeviceProfile(gpu=REF_GPU, **kw), ref_tune.DeviceProfile(**kw)


def _same(mine, want):
    """The same ranked summaries, scores and predictions."""
    assert len(mine.ranked) == len(want.ranked) > 0
    assert mine.budget_bytes == want.budget_bytes
    for a, b in zip(mine.ranked, want.ranked):
        sa, sb = a.summary(), b.summary()
        assert sa.keys() == sb.keys()
        for k, v in sb.items():
            if isinstance(v, float):
                assert math.isclose(sa[k], v, rel_tol=REL), (k, sa[k], v)
            else:
                assert sa[k] == v, (k, sa, sb)
        for f in ("predicted_latency_s", "cache_bytes", "max_batch"):
            assert math.isclose(getattr(a, f), getattr(b, f), rel_tol=REL)
    assert mine.best is mine.ranked[0]


def _spec_fields(spec) -> dict:
    m, s = spec.memory, spec.scheduler
    return {"memory": dataclasses.astuple(m),
            "scheduler": dataclasses.astuple(s),
            "k": spec.speculation.k if spec.speculation else 0}


WORKLOADS = {
    "default": dict(),
    "bursty": dict(mean_prompt_len=20.0, max_prompt_len=40,
                   mean_new_tokens=6.0, burst_size=16),
    "prefix": dict(mean_prompt_len=30.0, max_prompt_len=48,
                   mean_new_tokens=4.0, burst_size=4,
                   shared_prefix_frac=0.8, shared_prefix_len=12),
}


@pytest.mark.parametrize("budget", [128 * 1024, 256 * 1024, None])
@pytest.mark.parametrize("work", sorted(WORKLOADS))
def test_tune_ranks_as_the_reference(budget, work):
    """The reference suite's geometry (reduced qwen1.5-0.5b, max_len 64)
    at its two pinned budgets and at the budget derived from the device's
    memory, on three workloads: the same ranking."""
    cfg, rcfg = _pair(QWEN)
    mine_dev, ref_dev = _devices(cache_budget_bytes=budget)
    w = WORKLOADS[work]
    mine = tune(cfg, mine_dev, WorkloadProfile(**w), max_len=64)
    want = ref_tune.tune(rcfg, ref_dev, ref_tune.WorkloadProfile(**w),
                         max_len=64)
    _same(mine, want)
    assert _spec_fields(mine.spec) == _spec_fields(want.spec)
    assert mine.spec.validate() is mine.spec and mine.spec.mesh == MeshSpec()
    assert cache_bytes(mine.spec) <= mine_dev.budget(cfg)
    scores = [c.score for c in mine.ranked]
    assert scores == sorted(scores, reverse=True)
    assert tune(cfg, mine_dev, WorkloadProfile(**w), max_len=64).spec \
        == mine.spec


def test_runtime_spec_tuned_matches_tune():
    cfg, _ = _pair(QWEN)
    device = DeviceProfile(cache_budget_bytes=128 * 1024)
    assert RuntimeSpec.tuned(cfg, device, max_len=64) \
        == tune(cfg, device, max_len=64).spec


def test_workload_profile_from_trace_reads_meta():
    t = shared_prefix_trace(16, n_families=2, prefix_len=12, shared_frac=0.8,
                            max_len=48, max_new=4, seed=2)
    rt = ref_trace.shared_prefix_trace(16, n_families=2, prefix_len=12,
                                       shared_frac=0.8, max_len=48,
                                       max_new=4, seed=2)
    w = WorkloadProfile.from_trace(t)
    assert dataclasses.astuple(w) == dataclasses.astuple(
        ref_tune.WorkloadProfile.from_trace(rt))
    assert w.shared_prefix_frac == 0.8 and w.shared_prefix_len == 12
    assert w.effective_prompt_len < w.mean_prompt_len
    cfg, rcfg = _pair(QWEN)
    mine_dev, ref_dev = _devices(cache_budget_bytes=256 * 1024)
    mine = tune(cfg, mine_dev, w, max_len=64)
    _same(mine, ref_tune.tune(rcfg, ref_dev,
                              ref_tune.WorkloadProfile.from_trace(rt),
                              max_len=64))
    assert any(c.spec.memory.prefix_cache for c in mine.ranked)


def test_naive_default_pays_equal_bytes():
    cfg, rcfg = _pair(QWEN)
    mine_dev, ref_dev = _devices(cache_budget_bytes=256 * 1024)
    tuned = tune(cfg, mine_dev, max_len=64).spec
    naive = naive_default(cfg, tuned)
    want = ref_tune.naive_default(
        rcfg, ref_tune.tune(rcfg, ref_dev, max_len=64).spec)
    assert dataclasses.astuple(naive.memory) == dataclasses.astuple(
        want.memory)
    assert naive.scheduler.policy == want.scheduler.policy == "auto"
    assert naive.memory.cache_layout == "dense"
    assert cache_bytes(naive) <= cache_bytes(tuned)
    per_row = cache_bytes(naive) // naive.memory.max_batch
    assert cache_bytes(tuned) - cache_bytes(naive) < per_row


def test_tune_int8_kv_is_opt_in():
    cfg, rcfg = _pair(QWEN)
    mine_dev, ref_dev = _devices(cache_budget_bytes=128 * 1024)
    assert tune(cfg, mine_dev, max_len=64).spec.memory.kv_dtype == "compute"
    mine = tune(cfg, mine_dev, max_len=64, allow_int8_kv=True)
    _same(mine, ref_tune.tune(rcfg, ref_dev, max_len=64, allow_int8_kv=True))
    assert any(c.spec.memory.kv_dtype == "int8" for c in mine.ranked)


@pytest.mark.parametrize("acceptance", [0.3, 0.9])
def test_tune_speculation_ranks_as_the_reference(acceptance):
    """A 1-layer draft at two acceptance rates: the spec_k points and
    their decode term's E(k, a) scaling, as the reference ranks them."""
    cfg, rcfg = _pair(QWEN)
    draft = dataclasses.replace(cfg, num_layers=1)
    rdraft = dataclasses.replace(rcfg, num_layers=1)
    mine_dev, ref_dev = _devices(cache_budget_bytes=256 * 1024)
    w = dict(draft_acceptance=acceptance)
    mine = tune(cfg, mine_dev, WorkloadProfile(**w), max_len=64, draft=draft)
    _same(mine, ref_tune.tune(rcfg, ref_dev, ref_tune.WorkloadProfile(**w),
                              max_len=64, draft=rdraft))
    assert any(c.spec.speculation is not None for c in mine.ranked)


def test_fleet_cache_accounting_matches_fabric():
    from repro_torch.serving.fabric import DecodeFabric

    cfg, rcfg = _pair(QWEN)
    cfg_b = dataclasses.replace(cfg, name=cfg.name + "-b", num_layers=1,
                                d_model=48, num_heads=3, num_kv_heads=3,
                                d_ff=96, vocab_size=96)
    maxima = maxima_for(cfg, cfg_b, seq_max=64)
    fab = DecodeFabric(maxima, 2, cfg, device="cpu")
    assert _per_token_bytes(cfg, "compute", maxima) \
        == fab.kv_bytes_per_token()
    assert _per_token_bytes(cfg, "compute", maxima) \
        >= _per_token_bytes(cfg, "compute", None)
    budget = 512 * 1024
    mine_dev, ref_dev = _devices(cache_budget_bytes=budget)
    rmax = ref_spec.maxima_for(rcfg, dataclasses.replace(
        rcfg, name=cfg_b.name, num_layers=1, d_model=48, num_heads=3,
        num_kv_heads=3, d_ff=96, vocab_size=96), seq_max=64)
    mine = tune(cfg, mine_dev, max_len=64, maxima=maxima)
    _same(mine, ref_tune.tune(rcfg, ref_dev, max_len=64, maxima=rmax))
    assert mine.spec.maxima is maxima
    assert cache_bytes(mine.spec) <= budget


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "whisper-medium"])
def test_tune_rejects_unsupported_family(name):
    """No per-token cache: both tuners raise."""
    cfg, rcfg = _pair(name)
    mine_dev, ref_dev = _devices(cache_budget_bytes=128 * 1024)
    with pytest.raises(ValueError, match="no per-token KV cache"):
        tune(cfg, mine_dev, max_len=64)
    with pytest.raises(ValueError, match="no per-token KV cache"):
        ref_tune.tune(rcfg, ref_dev, max_len=64)


def test_dropped_points_are_the_listed_ones():
    """The points the port's spec rejects and the reference's accepts:
    int8 weights that would quantize a learned position table (the
    reference ranks them, the port drops every one and raises on the
    empty grid); a fleet of a non-dense family."""
    cfg, rcfg = _pair("adaptor-bert")
    ex = dict(quant="int8", quant_min_size=1)
    mine_dev, ref_dev = _devices(cache_budget_bytes=256 * 1024)
    want = ref_tune.tune(rcfg, ref_dev, max_len=64,
                         execution=ref_spec.ExecutionSpec(**ex))
    assert want.ranked
    with pytest.raises(ValueError, match="no feasible configuration"):
        tune(cfg, mine_dev, max_len=64, execution=ExecutionSpec(**ex))
    # without int8 weights the encoder ranks as the reference does
    _same(tune(cfg, mine_dev, max_len=64),
          ref_tune.tune(rcfg, ref_dev, max_len=64))
    moe, rmoe = _pair("granite-moe-1b-a400m")
    with pytest.raises(ValueError, match="no feasible configuration"):
        tune(moe, mine_dev, max_len=64,
             maxima=maxima_for(moe, seq_max=64))
    assert ref_tune.tune(rmoe, ref_dev, max_len=64,
                         maxima=ref_spec.maxima_for(rmoe, seq_max=64)).ranked


@pytest.mark.parametrize("kw", [dict(n_devices=2), dict(n_chips=4),
                                dict(interconnect_gbps=25.0)])
def test_device_profile_refuses_a_mesh(kw):
    """What this profile was refused for until the mesh was ported (item
    13): more devices, more cards per replica and an interconnect rate
    now rank as the reference ranks them."""
    cfg, rcfg = _pair(QWEN)
    mine_dev, ref_dev = _devices(cache_budget_bytes=1 << 20, **kw)
    w = WORKLOADS["bursty"]
    _same(tune(cfg, mine_dev, WorkloadProfile(**w), max_len=64),
          ref_tune.tune(rcfg, ref_dev, ref_tune.WorkloadProfile(**w),
                        max_len=64))
    assert mine_dev.meshes() == tuple(
        MeshSpec(tp=m.tp, dp=m.dp) for m in ref_dev.meshes())


def test_default_profile_is_the_h100():
    cfg = get_config(QWEN)
    dev = DeviceProfile()
    assert dev.gpu is H100
    from repro_torch.core.analytical import weight_bytes
    assert dev.budget(cfg) == int(0.4 * (80 * 10**9 - weight_bytes(cfg)))
    res = tune(cfg, dev, max_len=512)
    assert isinstance(res.best, Candidate) and res.best.summary()["tp"] == 1
    assert cache_bytes(res.spec) <= res.budget_bytes


def test_serve_tuned_on_cpu(capsys):
    """``serve --tuned`` on reduced qwen1.5-0.5b: the tuned spec drives
    the demo mix; --fleet and --spec-k are refused beside it."""
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--tuned", "--requests", "3", "--max-len", "32",
          "--max-new", "4", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "tuned spec (NVIDIA H100 80GB HBM3, 700.00 W): " in out
    assert "on cpu: 3 requests, 12 tokens" in out
    for extra in (["--fleet", "qwen1.5-0.5b,adaptor-bert-shaped"],
                  ["--spec-k", "2"]):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", "--tuned", *extra])
        assert "--tuned" in capsys.readouterr().err
