"""The scans' kernels timed against another tree, on a CUDA card.

``python src/repro_torch/launch/scan_probe.py --parent build/parent/src``
times ``ssm_scan`` at every row of ``timing.SSM_SCAN_SHAPES`` (the rows of
``chip_smoke.py`` phase 2) and at falcon-mamba-7b's prefill buckets 64,
512 and 1024 at B = 1 (each three quarters full), and a training layer's
scans at every row of ``timing.SSM_BWD_SHAPES`` (phase 21's): its forward
(``SSMScanFn.forward``'s call: in a tree whose forward writes the
checkpoints, with them), its backward (from those checkpoints; a tree
without them re-runs the forward inside) and the two as one call, x bf16,
under ``timing.Timer`` (median of single calls, L2 flushed, the stream kept
busy).  Each tree runs in a process of its own that imports
``repro_torch`` from that tree's ``src`` (its kernels built in its own
``build/``), in the order parent, change, change, parent
(``matmul_probe.py``'s turns).  Every output is held bit for bit against
the tree's own plain version.  Beside each time: the byte bound
(``bound_ms``), the issue floor (``issue_floor_ms``: the kernel's float32
lane instructions at every lane's rate), the kernels' device microseconds
from ``torch.profiler`` (20 calls), and, once per tree, the ptxas report
(registers, static shared memory, spills) of every ``ssm_scan*`` kernel
with, for this tree, each kernel's dynamic shared memory
(``ssm_scan.smem_bytes``).  The card's name and power limit and the table
are printed, and the runs are written as JSON to
``build/scan_probe.json``.

It also times the RG-LRU recurrence's two kernels (``--only rglru``
alone): ``rglru_scan`` at every row of ``timing.RGLRU_SCAN_SHAPES`` (phase
2's) and at recurrentgemma-2b's 512-token prefill bucket three quarters
full, and ``rglru_scan_bwd`` at every row of ``timing.RGLRU_BWD_SHAPES``
(phase 21's), each bit for bit the tree's plain loop, beside its bound
(``rglru_scan_cost`` / ``rglru_bwd_cost``) and issue floor, with each
launch's plan, grid and dynamic shared memory (``rglru_scan.describe``)
and the ptxas report of every ``rglru_scan*`` kernel.

``--sweep`` times, in this tree only, every states-a-thread split the
forward kernel is built for at N 16 (``states_per_thread`` patched for the
forward; ``kernels/ssm_scan.py`` ``BUILT``) at the same rows, and every
RG-LRU plan (``rglru_plan`` patched: every C of ``rglru_scan.CHANNELS``
and tiles of 1024, 2048 and 4096 floats an operand, in each direction's
ring; those past a CTA's shared memory skipped): the measurements
``states_per_thread`` and ``rglru_plan`` are chosen from.
Run it as a script: the worker processes import ``timing`` and
``matmul_probe`` from this directory.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
from pathlib import Path

from matmul_probe import (CHANGE_SRC, ORDER, build_trees, kernel_us,
                          nvidia_smi, run_worker)
from timing import (RGLRU_BWD_SHAPES, RGLRU_SCAN_SHAPES, SSM_BWD_SHAPES,
                    SSM_SCAN_SHAPES, bound_ms, issue_floor_ms,
                    rglru_bwd_cost, rglru_scan_cost, ssm_bwd_cost,
                    ssm_operands, ssm_scan_cost)

REPS = 31
OUT = Path("build/scan_probe.json")
# falcon-mamba-7b's prefill buckets at B = 1, each three quarters full
BUCKETS = tuple((1, s, 8192, 16, (3 * s // 4,)) for s in (64, 512, 1024))
FWD_ROWS = SSM_SCAN_SHAPES + BUCKETS
# recurrentgemma-2b's 512-token prefill bucket at B = 1, three quarters full
RG_FWD_ROWS = RGLRU_SCAN_SHAPES + ((1, 512, 2560, (384,)),)
# the RG-LRU sweep's tiles (floats an operand, T = floats / C), at every C
# of ``rglru_scan.CHANNELS``
RG_SWEEP_FLOATS = (1024, 2048, 4096)


def fwd_label(B, S, Di, N, lens) -> str:
    return f"ssm_scan [{B}, {S}, {Di}, {N}] lengths {list(lens or [])}"


def train_label(B, S, Di, N) -> str:
    return f"training scan [{B}, {S}, {Di}, {N}]"


def rg_fwd_label(B, S, W, lens) -> str:
    return f"rglru_scan [{B}, {S}, {W}] lengths {list(lens or [])}"


def rg_bwd_label(B, S, W) -> str:
    return f"rglru_scan_bwd [{B}, {S}, {W}]"


def ptxas(log: Path, source: str) -> dict[str, list[int]]:
    """{kernel: [registers, static smem bytes, spill bytes]} of every
    kernel of ``source`` in the build log's ptxas report."""
    part = log.read_text().split(f"== {source}\n", 1)[1]
    part = part.split("\n== ", 1)[0]
    names = re.findall(r"Compiling entry function '(\w+)'", part)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    plain = dict(zip(names, (p.replace("(anonymous namespace)::", "")
                             .split("(")[0] for p in plain)))
    out, name, spill = {}, None, 0
    for line in part.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = plain.get(m.group(1), m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            sm = re.search(r"(\d+) bytes smem", line)
            out[name] = [int(m.group(1)), int(sm.group(1)) if sm else 0,
                         spill]
            name = None
    return out


def worker(sweep: bool, only: str | None) -> None:
    import torch

    from repro_torch.kernels import runtime
    from timing import Timer

    dev = torch.device("cuda")
    timer = Timer(dev)
    log = runtime.build().parent / "build.log"
    result = {"ptxas": {}}

    def timed(run, want, label, profile=True) -> dict:
        got = run()
        if not all(torch.equal(u, v) for u, v in zip(got, want, strict=True)):
            raise AssertionError(f"{label}: not bit for bit its plain loop")
        out = dict(ms=timer(run, reps=REPS))
        if profile:
            out["kernels_us"] = kernel_us(run, timer.flush)
        return out

    def costed(*costs) -> dict:
        """The bound and the issue floor of calls of these costs."""
        return dict(bound_ms=sum(bound_ms(nb, fl, torch.float32)[0]
                                 for nb, fl, _ in costs),
                    issue_ms=sum(issue_floor_ms(ln) for *_, ln in costs))

    for name, rows in (("ssm", ssm_rows), ("rglru", rglru_rows)):
        if only in (None, name):
            result["ptxas"].update(ptxas(log, f"{name}_scan.cu"))
            rows(sweep, dev, timed, costed, result)
    print(json.dumps(result))


def rglru_rows(sweep: bool, dev, timed, costed, result: dict) -> None:
    """``rglru_scan`` at ``RG_FWD_ROWS`` and ``rglru_scan_bwd`` at
    ``RGLRU_BWD_SHAPES``: the tree's plan, or with ``sweep`` every plan."""
    import torch
    from unittest import mock

    from repro_torch.kernels import rglru_scan as rg

    new = hasattr(rg, "rglru_plan")

    def plans(backward):
        if not sweep:
            return [("plan", None)]
        out = []
        for c in rg.CHANNELS:
            for t in sorted({min(256, max(8, f // c))
                             for f in RG_SWEEP_FLOATS}):
                plan = rg.RGLRUPlan(c, t)
                if rg.smem_bytes(plan, backward) <= rg.SMEM_LIMIT:
                    out.append((f"C {c} T {t}", plan))
        return out

    def patched(plan):
        if plan is None:
            return contextlib.nullcontext()
        return mock.patch.object(rg, "rglru_plan", lambda *a, **k: plan)

    def launch(B, S, W, backward) -> str:
        if not new:
            return "a thread per (row, channel), 128 a CTA"
        return rg.describe(rg._plan(B, S, W, backward), B, W, backward)

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for B, S, W, lens in RG_FWD_ROWS:
        a = torch.rand(B, S, W, generator=g, device=dev)
        gg = torch.randn(B, S, W, generator=g, device=dev)
        n = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                   device=dev)
        label = rg_fwd_label(B, S, W, lens)
        row = costed(rglru_scan_cost(B, S, W, lens))
        row["launch"] = launch(B, S, W, False)
        want = rg.rglru_scan_plain(a, gg, n)
        for key, plan in plans(False):
            with patched(plan):
                row[key] = timed(lambda: rg.rglru_scan(a, gg, n), want,
                                 f"{label} {key}", profile=not sweep)
        result[label] = row
        del a, gg, want
    for B, S, W in RGLRU_BWD_SHAPES:
        a, hs, dhs = (torch.rand(B, S, W, generator=g, device=dev),
                      torch.randn(B, S, W, generator=g, device=dev),
                      torch.randn(B, S, W, generator=g, device=dev))
        dh = torch.randn(B, W, generator=g, device=dev)
        label = rg_bwd_label(B, S, W)
        row = costed(rglru_bwd_cost(B, S, W))
        row["launch"] = launch(B, S, W, True)
        want = rg.rglru_scan_bwd_plain(a, hs, dhs, dh)
        for key, plan in plans(True):
            with patched(plan):
                row[key] = timed(lambda: rg.rglru_scan_bwd(a, hs, dhs, dh),
                                 want, f"{label} {key}", profile=not sweep)
        result[label] = row
        del a, hs, dhs, dh, want
        torch.cuda.empty_cache()


def ssm_rows(sweep: bool, dev, timed, costed, result: dict) -> None:
    """``ssm_scan`` at ``FWD_ROWS`` and a training layer's scans at
    ``SSM_BWD_SHAPES``: the tree's split, or with ``sweep`` every forward
    split built at N 16."""
    import torch
    from unittest import mock

    from repro_torch.kernels import ssm_scan as sm

    new = hasattr(sm, "smem_bytes")
    if new:
        result["dynamic smem"] = {
            f"{'bwd' if bw else 'fwd'} N {n} G {g}": sm.smem_bytes()(n, g, bw)
            for bw in (False, True)
            for n, gs in sm.BUILT["backward" if bw else "forward"].items()
            for g in gs}

    def splits(n):
        """(label, patch) of each forward split timed: the tree's own plan,
        or with ``sweep`` every split built for N 16."""
        if not sweep or n != 16:
            return [("plan", None)]
        return [(f"G {g}", g) for g in sm.BUILT["forward"][n]]

    def patched(g):
        if g is None:
            return contextlib.nullcontext()
        plan = sm.states_per_thread
        return mock.patch.object(
            sm, "states_per_thread",
            lambda n, backward=False, row_channels=0: plan(n, True)
            if backward else g)

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for B, S, Di, N, lens in FWD_ROWS:
        dt, x, b, c, a = ssm_operands(g, dev, B, S, Di, N)
        n = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                   device=dev)
        row = costed(ssm_scan_cost(B, S, Di, N, lens))
        want = sm.ssm_scan_plain(dt, x, b, c, a, n)
        for key, split in splits(N):
            with patched(split):
                row[key] = timed(lambda: sm.ssm_scan(dt, x, b, c, a, n),
                                 want, fwd_label(B, S, Di, N, lens))
        result[fwd_label(B, S, Di, N, lens)] = row
        del dt, x, b, c, a, want
        torch.cuda.empty_cache()
    # a training layer's scans: SSMScanFn.forward's call (the checkpoints
    # written where the tree has them), the backward from them, both
    ckpt_arg = (True,) if new else ()
    for B, S, Di, N in SSM_BWD_SHAPES:
        dt, x, b, c, a = ssm_operands(g, dev, B, S, Di, N)
        dy = torch.randn(B, S, Di, generator=g, device=dev)
        dh = torch.randn(B, Di, N, generator=g, device=dev)
        ops = (dt, x, b, c, a, dy, dh)
        fcost = ssm_scan_cost(B, S, Di, N, None, ckpt=new)
        bcost = ssm_bwd_cost(B, S, Di, N)
        label = train_label(B, S, Di, N)
        rows = {f"{label} forward": costed(fcost),
                f"{label} backward": costed(bcost),
                f"{label} forward + backward": costed(fcost, bcost)}
        want_f = sm.ssm_scan_plain(dt, x, b, c, a, None, *ckpt_arg)
        want_b = sm.ssm_scan_bwd_plain(*ops)

        def fwd():
            return sm._forward(dt, x, b, c, a, None, *ckpt_arg)

        for key, split in splits(N):
            with patched(split):
                ckpt = fwd()[2:]
                for part, run, want in (
                        ("forward", fwd, want_f),
                        ("backward", lambda: sm.ssm_scan_bwd(*ops, *ckpt),
                         want_b),
                        ("forward + backward",
                         lambda: sm.ssm_scan_bwd(*ops, *fwd()[2:]), want_b)):
                    rows[f"{label} {part}"][key] = timed(
                        run, want, f"{label} {part}")
                del ckpt
        result.update(rows)
        del ops, dt, x, b, c, a, dy, dh, want_f, want_b
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=False,
                    help="the other tree's src directory")
    ap.add_argument("--sweep", action="store_true",
                    help="time every forward split built at N 16 and every "
                         "RG-LRU plan instead")
    ap.add_argument("--only", choices=("ssm", "rglru"),
                    help="one scan family's kernels alone")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.sweep, args.only)
        return 0
    smi = nvidia_smi()
    trees = {"change": CHANGE_SRC}
    if args.parent is not None and not args.sweep:
        trees["parent"] = args.parent.resolve()
    order = [t for t in ORDER if t in trees] if len(trees) > 1 else ["change"]
    build_trees(trees)
    flags = (("--sweep",) if args.sweep else ()) + (
        ("--only", args.only) if args.only else ())
    runs = [(tree, run_worker(trees[tree], *flags, script=__file__))
            for tree in order]
    for tree, r in runs[:len(trees)]:
        print(f"ptxas ({tree}): " + "; ".join(
            f"{k} {v[0]} regs, {v[1]} B static smem, {v[2]} B spill"
            for k, v in r["ptxas"].items()))
        if "dynamic smem" in r:
            print(f"dynamic smem ({tree}): " + ", ".join(
                f"{k} {v} B" for k, v in r["dynamic smem"].items()))
    labels = [k for k in runs[0][1] if k not in ("ptxas", "dynamic smem")]
    for label in labels:
        for tree, r in runs[:len(trees)]:
            if "launch" in r[label]:
                print(f"launch ({tree}) {label}: {r[label]['launch']}")
    print(f"{'row':<52} {'time':<28} " + " ".join(
        f"{t:>9}" for t, _ in runs) + f" {'bound':>8} {'issue':>8}")
    for label in labels:
        rows = [r[label] for _, r in runs]
        mine = dict(runs)["change"][label]
        keys = dict.fromkeys(k for r in rows for k, v in r.items()
                             if isinstance(v, dict))
        for key in keys:
            ms = " ".join(f"{r[key]['ms']:>9.4f}" if key in r else
                          f"{'-':>9}" for r in rows)
            print(f"{label:<52} {key:<28} {ms} "
                  f"{mine['bound_ms']:>8.4f} {mine['issue_ms']:>8.4f}")
    print("device us per call by kernel:")
    for label in labels:
        for tree, r in runs:
            for key, v in r[label].items():
                if isinstance(v, dict) and "kernels_us" in v:
                    print(f"  {label} {key} ({tree}): {v['kernels_us']}")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    out = OUT.with_name("scan_sweep.json") if args.sweep else OUT
    out.write_text(json.dumps({"device": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
