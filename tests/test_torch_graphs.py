"""Each fused step of the port's engine as one CUDA graph, and its compile
accounting against the reference's.

On the CPU the engine runs eagerly (``graphs=True`` is refused there) and
``compilations`` must equal the reference engine's after the same
workload: 1 per program that ran, ``decode`` falling back to the mixed
step's count when the one-lane program never ran.

The ``cuda`` tests hold the graphs on the card: graphed and eager greedy
streams are equal (float and int8 weights), each program is captured once
across a drain, the launches the replays make (each graph's capture
counts x its replays) equal the eager engine's, a second ``load``
captures again, a step with a stochastic slot runs eagerly and counts,
and a capture that fails raises.  This module imports the reference only
inside its CPU test, so they run where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_graphs.py``.
"""
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec)
from repro_torch.kernels.counts import launch_counts
from repro_torch.models.model import Model
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampling import SamplingParams

CFG = reduced(get_config("qwen1.5-0.5b"))
PROMPTS = [[1, 2, 3], list(range(1, 9)), [4], list(range(2, 40, 3)),
           [7, 7, 7, 7, 7], list(range(1, 20))]
MEM = dict(cache_layout="paged", max_batch=4, max_len=64, block_size=8)


def _spec(quant=False, compute="fp32", mm="pallas", impl="pallas"):
    return RuntimeSpec(
        arch=CFG,
        execution=ExecutionSpec(matmul_backend=mm, paged_attn_impl=impl,
                                compute_dtype=compute,
                                quant="int8" if quant else "none",
                                quant_min_size=1),
        memory=MemorySpec(kv_dtype="int8" if quant else "compute", **MEM),
        scheduler=SchedulerSpec(chunk_size=8))


def test_engine_refuses_graphs_on_the_cpu():
    with pytest.raises(ValueError, match="graphs=True needs a CUDA device"):
        ServingEngine(_spec(), device="cpu", graphs=True)
    assert not ServingEngine(_spec(), device="cpu").graphs


@pytest.mark.parametrize("max_new", [None, 1, 5])
def test_compilations_match_reference_accounting(max_new):
    """Before any step, after a drain whose requests finish at their
    completing chunk (the one-lane decode never runs) and after a drain
    through both programs: the port's eager engine reports the
    reference's counts, in both spellings."""
    import jax

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.models.model import Model as JModel
    from repro.serving.engine import ServingEngine as JServingEngine
    from repro_torch.bridge import from_jax_params

    j_cfg = j_reduced(REGISTRY["qwen1.5-0.5b"])
    params = JModel(j_cfg).init(jax.random.PRNGKey(0))
    je = JServingEngine(j_spec.RuntimeSpec(
        arch=j_cfg, execution=j_spec.ExecutionSpec(compute_dtype="fp32"),
        memory=j_spec.MemorySpec(**MEM),
        scheduler=j_spec.SchedulerSpec(chunk_size=8)))
    je.load(params)
    te = ServingEngine(_spec(mm="xla", impl="gather"), device="cpu")
    te.load(from_jax_params(jax.tree.map(np.asarray, params), CFG, "cpu"))
    for eng in (je, te):
        if max_new is not None:
            for p in PROMPTS[:3]:
                eng.submit(p, max_new_tokens=max_new)
            eng.run_to_completion()
    want = dict(je.compilations)
    assert dict(te.compilations) == want == dict(te.compilations())
    assert want["decode"] == want["prefill"] == (max_new is not None)
    st = te.stats
    assert st["eager_steps"] == st["decode_steps"] == je.stats["decode_steps"]
    assert st["graph_captures"] == st["graph_replays"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _weights(quant=False):
    spec = _spec(quant)
    return Model.from_spec(spec, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0)).state_dict()


def _drain(eng, sampling=None):
    """Every prompt (request i stochastic when ``sampling[i]``), drained at
    sync_every=4; returns the streams and the kernel launches made: the
    wrappers' counts, less what the captures recorded, plus the replays'."""
    before = launch_counts()
    uids = {eng.submit(p, max_new_tokens=6,
                       sampling=sampling[i] if sampling else None): i
            for i, p in enumerate(PROMPTS)}
    done = eng.run_to_completion(sync_every=4)
    after = launch_counts()
    made = Counter({n: after[n] - before[n] for n in after})
    made.subtract(eng.captured_launches)
    made.update(eng.replayed_launches)
    assert len(done) == len(PROMPTS)
    return {uids[r.uid]: r.generated for r in done}, +made


def _engines(quant=False):
    params = _weights(quant)
    out = []
    for graphs in (True, False):
        eng = ServingEngine(_spec(quant), graphs=graphs)
        eng.load(params)
        out.append(eng)
    return params, out


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_graphed_streams_and_launches_equal_eager(quant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, (graphed, eager) = _engines(quant)
    g_streams, g_made = _drain(graphed)
    e_streams, e_made = _drain(eager)
    assert g_streams == e_streams
    assert g_made == e_made
    assert graphed.compilations == {"decode": 1, "prefill": 1,
                                    "prefill_buckets": 0}
    st = graphed.stats
    assert st["graph_captures"] == 2 and st["eager_steps"] == 0
    assert st["graph_replays"] == st["decode_steps"] - 2 > 0
    norms = 2 * CFG.num_layers + 1
    assert g_made["rmsnorm"] == norms * st["decode_steps"]


@pytest.mark.cuda
def test_second_load_captures_again():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, (graphed, eager) = _engines()
    first, _ = _drain(graphed)
    graphed.load(params)
    again, _ = _drain(graphed)
    assert graphed.compilations["prefill"] == 2
    assert graphed.compilations["decode"] == 2
    assert again == first == _drain(eager)[0]


@pytest.mark.cuda
def test_stochastic_steps_run_eagerly_and_count():
    """A step with a stochastic slot leaves the graph: the streams are the
    eager engine's, greedy and stochastic requests alike.  One of the
    first four requests is stochastic: the steps until its harvest run
    eagerly, and the greedy steps after it are captured and replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, (graphed, eager) = _engines()
    sp = [SamplingParams(temperature=0.9, top_k=20) if i == 2 else None
          for i in range(len(PROMPTS))]
    got, _ = _drain(graphed, sp)
    assert got == _drain(eager, sp)[0]
    st = graphed.stats
    assert st["eager_steps"] > 0 and st["graph_replays"] > 0
    assert st["decode_steps"] == (st["graph_captures"] + st["graph_replays"]
                                  + st["eager_steps"])


@pytest.mark.cuda
def test_a_capture_failure_raises():
    """A host sync planted in the step: the warm-up runs it, the capture
    cannot, and the engine raises with the cause instead of running the
    step eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng = ServingEngine(_spec())
    eng.load(_weights())
    sample = engine_mod.sample_per_slot

    def syncing(logits, *a):
        float(logits.sum())                 # a host read of device data
        return sample(logits, *a)

    eng.submit(PROMPTS[1], max_new_tokens=3)
    with mock.patch.object(engine_mod, "sample_per_slot", syncing), \
            pytest.raises(RuntimeError, match="capturing the fused mixed"):
        eng.step()
    assert eng.stats["graph_captures"] == 0
