"""The norm kernels' rows timed against another tree, on a CUDA card.

``python src/repro_torch/launch/norm_probe.py --parent build/parent/src``
times ``rmsnorm`` and ``layernorm`` at every shape of
``timing.NORM_SHAPES`` (the serving steps and prefills of qwen1.5-0.5b,
qwen2-72b, adaptor_bert and whisper-medium; D 65, 3000 and 65536; an x
that starts one element past an aligned address), in bf16 and float32
with float32 parameters, under ``timing.Timer`` (median of single calls,
L2 flushed, the stream kept busy).  Each tree runs in a process of its
own that imports ``repro_torch`` from that tree's ``src``, in the order
parent, change, change, parent (``matmul_probe.py``'s turns).  Beside
each row: ``F.rms_norm`` / ``F.layer_norm`` (parameters in x's dtype;
never called by the port), ``y.copy_(x)`` (the same rows read and
written once: the rate a plain copy reaches), the byte bound, the
kernel's device microseconds from ``torch.profiler`` (20 calls), the
host's microseconds and PyTorch operators per call, and, once per
process, the Timer's floor: one launch of a 1-element fill under the
same Timer.  Every output is held against the plain version (bf16 2^-7,
f32 1e-5, of max|plain|); a shape a tree refuses prints "refused".  The
card's name and power limit and the table are printed, and the runs are
written as JSON to ``build/norm_probe.json``.

``--sweep`` times, in this tree only, every launch plan the kernel takes
at each shape (``norm_plan`` patched): one warp a row at 2, 4 or 8 warps
a CTA and each unit count that covers the row, several warps a row (up to
16) at each unit count, and the streaming path at 128, 256 and 512
threads: the measurements ``norm_plan`` is chosen from.  Run it as a
script: the worker processes import ``timing`` and ``matmul_probe`` from
this directory.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from matmul_probe import (CHANGE_SRC, ORDER, build_trees, column, host_cost,
                          kernel_us, nvidia_smi, run_worker)
from timing import (NORM_SHAPES, bound_ms, norm_calls, norm_cost, norm_err,
                    norm_operands)

REPS = 31
OUT = Path("build/norm_probe.json")
DTYPES = ("bfloat16", "float32")


def label(kernel: str, R: int, D: int, name: str, dt: str) -> str:
    return f"{kernel} {R}x{D} {dt[:4]} {name}"


def gate(out, ref) -> float:
    err, lim = norm_err(out, ref)
    if not err <= lim:
        raise AssertionError(f"err {err} > tol {lim}")
    return err


def worker() -> None:
    import torch

    from repro_torch.kernels import layernorm as ln
    from timing import Timer

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    timer = Timer(dev)
    tiny = torch.zeros(1, device=dev)
    result = {"timer floor": {"ms": timer(tiny.zero_, reps=REPS)}}
    for kernel, R, D, name, off in NORM_SHAPES:
        for dn in DTYPES:
            dt = getattr(torch, dn)
            x, params = norm_operands(g, dev, kernel, R, D, off, dt)
            run, plain, lib = norm_calls(ln, kernel, x, params)
            nbytes, flops = norm_cost(kernel, R, D, x.element_size(), 4)
            y = torch.empty_like(x)
            row = dict(library_ms=timer(lib, reps=REPS),
                       copy_ms=timer(lambda: y.copy_(x), reps=REPS),
                       bound_ms=bound_ms(nbytes, flops, torch.float32)[0])
            del y
            try:
                out = run()
            except ValueError as e:       # a width the tree refuses
                row.update(ms=None, refused=str(e))
            else:
                row.update(err=gate(out, plain()),
                           ms=timer(run, reps=REPS),
                           kernels_us=kernel_us(run, timer.flush))
                row["host_us"], row["ops"] = host_cost(run, timer)
                # the plan the wrapper launched (the parent records none)
                plan = getattr(getattr(ln, kernel), "last_plan", None)
                if plan is not None:
                    row["plan"] = list(plan)
            result[label(kernel, R, D, name, dn)] = row
            del x, params, run, plain, lib
            torch.cuda.empty_cache()
    print(json.dumps(result))


def candidate_plans(ln, chosen, R: int, D: int, dt, sms: int) -> list:
    """Every plan the kernel takes for [R, D] in ``dt`` in the units of
    ``chosen`` (the plan the wrapper launched), ``chosen`` first."""
    vector = chosen.vector
    units = D // (ln.unit_elems(dt) if vector else 1)
    plans = [chosen]
    for u in ln.REG_UNITS:
        if units <= 32 * u:
            for warps in (2, 4, 8):
                w = min(warps, R)
                plans.append(ln.NormPlan("warp", vector, u, 1, 32 * w, min(
                    math.ceil(R / w), sms * ln.resident_ctas("warp", 32 * w))))
        wpr = math.ceil(units / (32 * u))
        if 1 < wpr <= ln.MAX_ROW_WARPS:
            plans.append(ln.NormPlan("warps", vector, u, wpr, 32 * wpr, min(
                R, sms * ln.resident_ctas("warps", 32 * wpr))))
    for threads in (128, 256, 512):
        plans.append(ln.NormPlan("stream", vector, 0, threads // 32, threads,
                                 min(R, sms * ln.resident_ctas("stream",
                                                               threads))))
    return list(dict.fromkeys(plans))


def sweep() -> None:
    import torch
    from unittest import mock

    from repro_torch.kernels import layernorm as ln
    from timing import Timer

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    timer = Timer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {}
    for kernel, R, D, name, off in NORM_SHAPES:
        for dn in DTYPES:
            dt = getattr(torch, dn)
            x, params = norm_operands(g, dev, kernel, R, D, off, dt)
            run, plain, _ = norm_calls(ln, kernel, x, params)
            want = plain()
            gate(run(), want)
            chosen = getattr(ln, kernel).last_plan
            row = {"plan": list(chosen)}
            for plan in candidate_plans(ln, chosen, R, D, dt, sms):
                with mock.patch.object(ln, "norm_plan",
                                       lambda *a, p=plan: p):
                    gate(run(), want)
                    row[" ".join(map(str, plan))] = timer(run, reps=REPS)
            result[label(kernel, R, D, name, dn)] = row
            del x, params, run, plain, want
            torch.cuda.empty_cache()
    print(json.dumps(result))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=False,
                    help="the other tree's src directory")
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch plan at each shape instead")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sweep() if args.sweep else worker()
        return 0
    smi = nvidia_smi()
    if args.sweep:
        return print_sweep(smi)
    trees = {"change": CHANGE_SRC}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    order = [t for t in ORDER if t in trees]
    build_trees(trees)
    runs = [(tree, run_worker(trees[tree], script=__file__))
            for tree in order]
    print("Timer floor (one 1-element fill), ms: " + "  ".join(
        f"{t} {r['timer floor']['ms']:.4f}" for t, r in runs))
    print(f"{'row':<58} " + " ".join(f"{t:>9}" for t, _ in runs)
          + f" {'library':>9} {'copy':>9} {'bound':>9}  plan (change)")
    labels = [k for k in runs[0][1] if k != "timer floor"]
    for key in labels:
        rs = [r[key] for _, r in runs]
        line = f"{key:<58} " + " ".join(
            "  refused" if r["ms"] is None else f"{r['ms']:>9.4f}" for r in rs)
        line += "".join(f" {column(rs, k):>9}"
                        for k in ("library_ms", "copy_ms", "bound_ms"))
        plan = next((r.get("plan") for (t, _), r in zip(runs, rs)
                     if t == "change"), None)
        print(line + f"  {plan}")
    print("device us per call by kernel, host us / operators per call:")
    for key in labels:
        print(f"  {key:<58} " + "  ".join(
            f"{t} {r[key]['kernels_us']} {r[key]['host_us']:.1f} / "
            f"{r[key]['ops']}" for t, r in runs if r[key]["ms"] is not None))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"device": smi, "runs": runs}, indent=1))
    return 0


def print_sweep(smi: str) -> int:
    """The sweep's table: Timer us per call of each plan (layout, units,
    warps a row, threads, grid), the chosen one marked."""
    res = run_worker(CHANGE_SRC, "--sweep", script=__file__)
    for key, row in res.items():
        chosen = " ".join(map(str, row.pop("plan")))
        best = min(row, key=row.get)
        print(f"{key}: plan {chosen} {row[chosen] * 1e3:.2f} us, best "
              f"{best} {row[best] * 1e3:.2f} us")
        print("   " + "  ".join(f"[{p}] {ms * 1e3:.2f}"
                                for p, ms in row.items()))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.with_name("norm_sweep.json").write_text(
        json.dumps({"device": smi, "sweep": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
