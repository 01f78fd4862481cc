"""Host syncs per fused step and drain tokens/s, against another tree, on
a CUDA card (ROADMAP Queue 3 fault B).

``python src/repro_torch/launch/sync_probe.py --parent build/parent/src``
serves chip_smoke.py's phase 5 request mix (8 greedy requests of 24-400
prompt tokens, 16 new tokens each) through the full-width qwen1.5-0.5b
engine with every kernel selected, float weights and fully quantized, at
``sync_every`` 1 and 4, on fresh engines, after one untimed warm-up
drain: once timed (tokens/s of the drain, ending in
``torch.cuda.synchronize()``), and once with every
``_dispatch`` under ``torch.cuda.set_sync_debug_mode("warn")``, counting
the synchronizing CUDA calls each fused step makes.  Weights come from a
generator seeded 0, so both trees serve the same model.  Each tree runs
in a process of its own that imports ``repro_torch`` from that tree's
``src``, in the order parent, change, change, parent
(``matmul_probe.py``'s turns).  Printed: the card's name and power
limit, each run's tokens/s, fused steps and syncs per step, the tokens
each run shares with the first change run's streams, and in each process
the tokens its sync_every=4 streams share with its sync_every=1 ones; the
runs are written as JSON to ``build/sync_probe.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

from matmul_probe import (CHANGE_SRC, ORDER, build_trees, nvidia_smi,
                          run_worker)

OUT = Path("build/sync_probe.json")
PROMPT_LENS = (24, 57, 96, 150, 203, 260, 333, 400)
MAX_NEW = 16
SYNC_EVERY = (1, 4)


def worker() -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.spec import (ExecutionSpec, MemorySpec,
                                       RuntimeSpec, SchedulerSpec)
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    def spec(quant: bool) -> RuntimeSpec:
        return RuntimeSpec(
            arch=get_config("qwen1.5-0.5b"),
            execution=ExecutionSpec(matmul_backend="pallas",
                                    paged_attn_impl="pallas",
                                    compute_dtype="bf16",
                                    quant="int8" if quant else "none"),
            memory=MemorySpec(cache_layout="paged", max_batch=8, max_len=512,
                              block_size=16,
                              kv_dtype="int8" if quant else "compute"),
            scheduler=SchedulerSpec(chunk_size=16))

    params = Model.from_spec(spec(False), device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0)).state_dict()
    rs = np.random.default_rng(0)
    vocab = get_config("qwen1.5-0.5b").vocab_size
    prompts = [rs.integers(0, vocab, n).tolist() for n in PROMPT_LENS]

    def drain(quant: bool, k: int, count: bool):
        eng = ServingEngine(spec(quant), device="cuda")
        eng.load(params)
        uids = {eng.submit(p, max_new_tokens=MAX_NEW): i
                for i, p in enumerate(prompts)}
        dispatch, syncs = eng._dispatch, [0]

        def counted():
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    dispatch()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            # the debug mode's own notice names "synchronizing operations"
            syncs[0] += sum("called a synchronizing CUDA operation"
                            in str(w.message) for w in seen)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(eng, "_dispatch", counted) if count \
                else contextlib.nullcontext():
            done = eng.run_to_completion(sync_every=k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = eng.stats["decode_steps"]
        streams = {uids[r.uid]: r.generated for r in done}
        return dt, steps, syncs[0], [streams[i] for i in range(len(prompts))]

    drain(False, 1, count=False)      # warm-up: first launches, allocator
    out = {}
    for quant in (False, True):
        for k in SYNC_EVERY:
            dt, steps, _, streams = drain(quant, k, count=False)
            _, steps_c, syncs, _ = drain(quant, k, count=True)
            out[f"{'int8' if quant else 'float'} sync_every={k}"] = dict(
                tok_s=len(prompts) * MAX_NEW / dt, s=dt, steps=steps,
                syncs_per_step=syncs / steps_c, streams=streams)
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=False,
                    help="the other tree's src directory")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return 0
    nvidia_smi()
    trees = {"change": CHANGE_SRC}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    order = [t for t in ORDER if t in trees]
    build_trees(trees)
    runs = [(tree, run_worker(trees[tree], script=__file__))
            for tree in order]
    first = next(r for t, r in runs if t == "change")
    n_tok = len(PROMPT_LENS) * MAX_NEW
    print(f"{'run':<22} {'tree':<7} {'tok/s':>8} {'s':>7} {'steps':>6} "
          f"{'syncs/step':>10} {'same tokens as change #1':>26}")
    for key in first:
        for tree, r in runs:
            e = r[key]
            same = sum(a == b for s, f in zip(e["streams"],
                                              first[key]["streams"])
                       for a, b in zip(s, f))
            print(f"{key:<22} {tree:<7} {e['tok_s']:>8.2f} {e['s']:>7.3f} "
                  f"{e['steps']:>6} {e['syncs_per_step']:>10.2f} "
                  f"{same:>21}/{n_tok}")
    k1, k4 = SYNC_EVERY
    for path in ("float", "int8"):
        print(f"{path}: tokens sync_every={k4} shares with sync_every={k1}, "
              "per process: " + "  ".join(
                  f"{tree} " + str(sum(
                      a == b for s, f in zip(r[f"{path} sync_every={k4}"]
                                             ["streams"],
                                             r[f"{path} sync_every={k1}"]
                                             ["streams"])
                      for a, b in zip(s, f))) + f"/{n_tok}"
                  for tree, r in runs))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({t + str(i): r for i, (t, r)
                               in enumerate(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
