"""The matmul kernels' rows timed against another tree, on a CUDA card.

``python src/repro_torch/launch/matmul_probe.py --parent build/parent/src``
times ``tiled_matmul`` at the six bf16 serving shapes (a decode step's 8
rows and a mixed step's 128 against qwen1.5-0.5b's 1024 x 1024, 1024 x
2816 and 2816 x 1024 weights), the library rows of ``chip_smoke.py``:
``ffn1`` (gelu, 512 x 768 -> 3072, adaptor_bert), ``ffn1_gated`` (swiglu,
128 x 1024 -> 2 x 2816), ``qkv_proj`` (MHA 128 x 1024 -> 3 x 1024 and GQA
128 x 8192 -> 8192 + 2 x 1024, qwen2-72b), and ``int8_matmul`` at the same
six serving shapes (bf16 out, the fully-quantized path's), with
``timing.Timer`` (median of single calls, L2 flushed, the stream kept
busy).  Each tree runs in a process of its own that imports
``repro_torch`` from that tree's ``src`` (the parent's kernels build in
its own ``build/``), in the order parent, change, change, parent, so the
two are compared on one card in turns; the library call beside each row
(``torch.matmul`` / ``torch.addmm``; for ``int8_matmul`` both
``torch._int_mm``, which refuses M <= 16, and the bf16 ``torch.matmul``
at the same shape) is timed in every process.  Each output is held
against the plain version (bf16: 2^-7 x max|plain|; ``int8_matmul``:
exact); the device time of each kernel a call launches (the loop and its
reduce apart) is read from ``torch.profiler`` over 20 calls, and the
host's cost of a call (microseconds to enqueue it, the median of 50 with
the stream held busy, and the PyTorch operators it dispatches) is
measured beside it.  The per-drain lines are estimates: the six serving
shapes' medians times the steps of ``chip_smoke.py``'s drains
(``DRAIN_STEPS``, the counts its phase 5 measures; the float and the
fully-quantized drain take the same steps).  The card's name and power
limit and a table are printed, and every run is written as JSON to
``build/matmul_probe.json``.

``--int8-sweep`` times, in this tree only, ``int8_matmul`` at the six
serving shapes at every BM (16, 32), BN (32, 64) and split count 1-16
(``int8_plan`` patched), with the host's cost of a call with and without
a split: the measurements ``int8_plan`` is chosen from.  Run it as a
script: the worker processes import ``timing`` from this directory.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

from timing import LAYER_MATMULS, STEP_ROWS

HERE = Path(__file__).resolve().parent
CHANGE_SRC = HERE.parents[1]
ORDER = ("parent", "change", "change", "parent")
REPS = 31
OUT = Path("build/matmul_probe.json")
# steps of chip_smoke.py's float drain (its phase 5 counts them from the
# attention launches) over qwen1.5-0.5b's 24 layers
DRAIN_STEPS = {"mixed": 31, "decode": 15}
LAYERS = 24


SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def serving_shapes():
    return [(m, k, n) for m in STEP_ROWS.values() for k, n in LAYER_MATMULS]


def rows():
    """(label, kernel name, shape) of each timed row."""
    out = [(f"tiled_matmul {m}x{k}x{n}", "tiled_matmul", (m, k, n))
           for m, k, n in serving_shapes()]
    out += [("ffn1 gelu 512x768->3072", "ffn1", (512, 768, 3072)),
            ("ffn1_gated swiglu 128x1024->2x2816", "ffn1_gated",
             (128, 1024, 2816)),
            ("qkv_proj MHA 128x1024->3x1024", "qkv_proj",
             (128, 1024, 1024, 1024)),
            ("qkv_proj GQA 128x8192->8192+2x1024", "qkv_proj",
             (128, 8192, 8192, 1024))]
    out += [(f"int8_matmul {m}x{k}x{n}", "int8_matmul", (m, k, n))
            for m, k, n in serving_shapes()]
    return out


def int8_operands(g, dev, m, k, n):
    import torch

    qx = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    qw = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    sx = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
    sw = torch.rand((1, n), generator=g, device=dev) * 0.05 + 1e-3
    return qx, qw, sx, sw


def int_mm_ms(timer, qx, qw):
    """``torch._int_mm``'s time, or None where it refuses the shape (it
    takes M > 16 only)."""
    import torch

    try:
        torch._int_mm(qx, qw)
    except RuntimeError:
        return None
    return timer(lambda: torch._int_mm(qx, qw), reps=REPS)


def kernel_us(fn, flush) -> dict[str, float]:
    """Device microseconds per call of each kernel ``fn`` launches (L2
    flushed before each call)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "")
            .replace("void ", "").split("(")[0][:40]:
            round(e.device_time_total / 20, 2) for e in prof.key_averages()
            if e.device_time_total and "elementwise" not in e.key
            and "fill" not in e.key.lower()}


def host_cost(fn, timer) -> tuple[float, int]:
    """Host microseconds to enqueue one call of ``fn`` (median of 50, the
    stream held busy by a spin kernel so no call waits for the device) and
    the PyTorch operators one call dispatches."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(20 / timer.ms_per_cycle))
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6, Count.n


def worker() -> None:
    import torch

    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import tiled_matmul as tm
    from repro_torch.kernels.ffn import (ffn1, ffn1_gated, ffn1_gated_plain,
                                         ffn1_plain)
    from repro_torch.kernels.qkv_proj import qkv_proj, qkv_proj_plain
    from timing import Timer, bound_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    timer = Timer(dev)
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    result = {}
    for label, name, shape in rows():
        m, k = shape[:2]
        x = rn(m, k)
        if name == "int8_matmul":
            result[label] = int8_row(i8, timer, g, dev, x, *shape)
            torch.cuda.empty_cache()
            continue
        if name == "tiled_matmul":
            w = rn(k, shape[2], scale=k ** -0.5)
            run, plain = (lambda: tm.tiled_matmul(x, w)), \
                (lambda: tm.tiled_matmul_plain(x, w))
            lib = lambda: torch.matmul(x, w)  # noqa: E731
            n_out, n_w = shape[2], shape[2]
        elif name == "ffn1":
            w = rn(k, shape[2], scale=k ** -0.5)
            b = 0.1 * torch.randn(shape[2], generator=g, device=dev)
            bl = b.to(bf)
            run, plain = (lambda: ffn1(x, w, b, "gelu")), \
                (lambda: ffn1_plain(x, w, b, "gelu"))
            lib = lambda: torch.addmm(bl, x, w)  # noqa: E731
            n_out, n_w = shape[2], shape[2]
        elif name == "ffn1_gated":
            w1, wg = rn(k, shape[2], scale=k ** -0.5), \
                rn(k, shape[2], scale=k ** -0.5)
            wc = torch.cat([w1, wg], dim=1)
            run, plain = (lambda: ffn1_gated(x, w1, wg, "swiglu")), \
                (lambda: ffn1_gated_plain(x, w1, wg, "swiglu"))
            lib = lambda: torch.matmul(x, wc)  # noqa: E731
            n_out, n_w = shape[2], 2 * shape[2]
        else:
            nq, nkv = shape[2:]
            ws = [rn(k, n, scale=k ** -0.5) for n in (nq, nkv, nkv)]
            wc = torch.cat(ws, dim=1)
            run, plain = (lambda: qkv_proj(x, *ws)), \
                (lambda: qkv_proj_plain(x, *ws))
            lib = lambda: torch.matmul(x, wc)  # noqa: E731
            n_out = n_w = nq + 2 * nkv
        out, ref = run(), plain()
        grid = tm.launched_grid() if hasattr(tm, "launched_grid") else None
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(out, ref))
        lim = 2 ** -7 * max(float(r.float().abs().max()) for r in ref)
        if not err <= lim:
            raise AssertionError(f"{label}: err {err} > tol {lim}")
        ms, lms = timer(run, reps=REPS), timer(lib, reps=REPS)
        bms, _ = bound_ms(2 * (m * k + k * n_w + m * n_out),
                          2 * m * k * n_w, bf)
        host_us, ops = host_cost(run, timer)
        result[label] = dict(ms=ms, library_ms=lms, bound_ms=bms, err=err,
                             grid=grid, host_us=host_us, ops=ops,
                             kernels_us=kernel_us(run, timer.flush))
        del out, ref
        torch.cuda.empty_cache()
    for kern, keys in (("tiled_matmul", ("ms", "library_ms")),
                       ("int8_matmul", ("ms", "bf16_ms"))):
        result[f"{kern} per drain, estimate"] = {key: LAYERS * sum(
            DRAIN_STEPS[step] * n * result[f"{kern} {m}x{k}x{nn}"][key]
            for step, m in STEP_ROWS.items()
            for (k, nn), n in LAYER_MATMULS.items()) for key in keys}
    print(json.dumps(result))


def int8_row(i8, timer, g, dev, x, m, k, n) -> dict:
    """One ``int8_matmul`` row (bf16 out): exact against the plain
    version, its time beside ``_int_mm``'s and the bf16 ``torch.matmul``'s
    (``x`` [m, k] bf16 against a [k, n] bf16 weight)."""
    import torch

    from timing import bound_ms

    qx, qw, sx, sw = int8_operands(g, dev, m, k, n)
    run = lambda: i8.int8_matmul(qx, sx, qw, sw)  # noqa: E731
    out = run()
    grid = i8.launched_grid() if hasattr(i8, "launched_grid") else None
    err = float((out.float() - i8.int8_matmul_plain(qx, sx, qw, sw)
                 .float()).abs().max())
    if err != 0:
        raise AssertionError(f"int8_matmul {m}x{k}x{n}: err {err} != 0")
    w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5) \
        .to(torch.bfloat16)
    bms, _ = bound_ms(m * k + k * n + 4 + 4 * n + 2 * m * n, 2 * m * k * n,
                      torch.int8)
    host_us, ops = host_cost(run, timer)
    return dict(ms=timer(run, reps=REPS), library_ms=int_mm_ms(timer, qx, qw),
                bf16_ms=timer(lambda: torch.matmul(x, w), reps=REPS),
                bound_ms=bms, err=err, grid=grid, host_us=host_us, ops=ops,
                kernels_us=kernel_us(run, timer.flush))


def planned(i8, plan):
    """``int8_matmul`` launched at ``plan`` (BM, BN, K ranges) instead of
    ``int8_plan``'s."""
    from unittest import mock

    return mock.patch.object(i8, "int8_plan", lambda M, K, N: plan)


def sweep() -> None:
    """``int8_matmul`` at the six serving shapes over BM, BN and split
    counts (this tree), with the host's cost of one call unsplit and
    split."""
    import torch

    from repro_torch.kernels import int8_matmul as i8
    from timing import Timer

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    timer = Timer(dev)
    result = {}
    for m, k, n in serving_shapes():
        qx, qw, sx, sw = int8_operands(g, dev, m, k, n)
        want = i8.int8_matmul_plain(qx, sx, qw, sw)
        run = lambda: i8.int8_matmul(qx, sx, qw, sw)  # noqa: E731
        row = {"plan": list(i8.int8_plan(m, k, n))}
        for bm in (16, 32):
            for bn in (32, 64):
                for s in SWEEP_SPLITS:
                    with planned(i8, (bm, bn, s)):
                        if not torch.equal(run(), want):
                            raise AssertionError(
                                f"int8_matmul {m}x{k}x{n} BM {bm} BN {bn} x "
                                f"{s} ranges: not exact")
                        row[f"{bm}x{bn} {s}"] = timer(run, reps=REPS)
        for s in (1, 4):
            with planned(i8, (32, 32, s)):
                row[f"host {s}"] = host_cost(run, timer)
        result[f"{m}x{k}x{n}"] = row
    print(json.dumps(result))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=False,
                    help="the other tree's src directory")
    ap.add_argument("--int8-sweep", action="store_true",
                    help="time int8_matmul over BM, BN and split counts "
                    "instead")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sweep() if args.int8_sweep else worker()
        return 0
    if args.int8_sweep:
        return print_sweep()
    trees = {"change": CHANGE_SRC}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    order = [t for t in ORDER if t in trees]
    smi = nvidia_smi()
    build_trees(trees)              # before any timing
    runs = [(tree, run_worker(trees[tree])) for tree in order]
    labels = list(runs[0][1])
    print(f"{'row':<36} " + " ".join(f"{t:>9}" for t, _ in runs)
          + f" {'library':>9} {'bf16 mm':>9} {'bound':>9}  grid (tiles, "
          "K ranges, smem B[, BN])")
    for label in labels:
        rs = [r[label] for _, r in runs]
        line = f"{label:<36} " + " ".join(f"{r['ms']:>9.4f}" for r in rs)
        for key in ("library_ms", "bf16_ms", "bound_ms"):
            line += f" {column(rs, key):>9}"
        if "grid" in rs[0]:
            line += "  " + str(next(r["grid"] for (t, _), r in zip(runs, rs)
                                    if t == "change"))
        print(line)
    print("host us to enqueue one call / PyTorch operators per call:")
    for label in labels:
        if "host_us" in runs[0][1][label]:
            print(f"  {label:<36} " + "  ".join(
                f"{t} {r[label]['host_us']:.1f} / {r[label]['ops']}"
                for t, r in runs))
    print("device us per call, by kernel (first change run):")
    change = next(r for t, r in runs if t == "change")
    for label in labels:
        if "kernels_us" in change[label]:
            print(f"  {label:<36} {change[label]['kernels_us']}")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"device": smi, "runs": runs}, indent=1))
    return 0


def column(rs: list[dict], key: str) -> str:
    """The median of one key over the runs: "-" where the row has no such
    number, "refused" where the library call refused the shape."""
    if key not in rs[0]:
        return "-"
    xs = sorted(r[key] for r in rs if r[key] is not None)
    return f"{xs[len(xs) // 2]:.4f}" if xs else "refused"


def nvidia_smi() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return smi


def env(src: Path) -> dict:
    return dict(os.environ, PYTHONPATH=str(src))


def build_trees(trees: dict[str, Path]) -> None:
    """Build every tree's kernels at once, each in its own ``build/``."""
    builds = [subprocess.Popen([sys.executable, "-c", "from repro_torch."
                                "kernels import runtime; runtime.build()"],
                               env=env(src)) for src in trees.values()]
    if any([p.wait() for p in builds]):
        raise RuntimeError("a kernel build failed")


def run_worker(src: Path, *flags: str, script: str = __file__) -> dict:
    """One worker process of ``script`` on the tree at ``src``; its JSON
    result."""
    out = subprocess.run([sys.executable, script, "--worker", *flags],
                         env=env(src), capture_output=True, text=True)
    if out.returncode:
        print(out.stdout, out.stderr, file=sys.stderr)
        raise RuntimeError(f"the worker on {src} failed")
    return json.loads(out.stdout.strip().splitlines()[-1])


def print_sweep() -> int:
    """The sweep's table: device us per call at each BN x split count."""
    smi = nvidia_smi()
    res = run_worker(CHANGE_SRC, "--int8-sweep")
    print("int8_matmul device us per call (bf16 out), BM x BN, K ranges:")
    for shape, row in res.items():
        (h1, o1), (h4, o4) = row["host 1"], row["host 4"]
        bm, bn, splits = row["plan"]
        print(f"{shape}: plan BM {bm} BN {bn} x {splits} ranges; host us / "
              f"operators per call: one range {h1:.1f} / {o1}, 4 ranges "
              f"{h4:.1f} / {o4}")
        for bm in (16, 32):
            for bn in (32, 64):
                print(f"  BM {bm} BN {bn}: " + "  ".join(
                    f"{s}: {row[f'{bm}x{bn} {s}'] * 1e3:.2f}"
                    for s in SWEEP_SPLITS))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.with_name("int8_sweep.json").write_text(
        json.dumps({"device": smi, "sweep": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
