"""The flash attention rows timed against another tree, on a CUDA card.

``python src/repro_torch/launch/flash_probe.py --parent build/parent/src``
times ``flash_attention`` at chip_smoke.py's flash shapes (the causal
qwen1.5-0.5b and qwen2-72b prompts, adaptor_bert, whisper-medium's cross
attention over 1500 frames, recurrentgemma-2b's local attention at hd
256 and a causal hd 512 prompt), in bf16 and float32, under
``timing.Timer`` (median of single calls, L2 flushed, the stream kept
busy).  Each tree runs in a process of its own that imports
``repro_torch`` from that tree's ``src``, in the order parent, change,
change, parent (``matmul_probe.py``'s turns).  Beside each row: SDPA's
time (never called by the port), the bound, the kernel's device
microseconds from ``torch.profiler`` (20 calls) and the grid the wrapper
launched.  Every output is held against the plain version at
chip_smoke.py's ``flash_limit``; a shape a tree refuses prints
"refused".  The card's name and power limit and the table are printed,
and the runs are written as JSON to ``build/flash_probe.json``.  Run it
as a script: the worker processes import ``timing`` and ``matmul_probe``
from this directory.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from matmul_probe import (CHANGE_SRC, ORDER, build_trees, column, kernel_us,
                          nvidia_smi, run_worker)
from timing import bound_ms

REPS = 31
OUT = Path("build/flash_probe.json")
DTYPES = ("bfloat16", "float32")
# (label, B, Sq, Skv, H, hd, causal): chip_smoke.py's timed flash rows
SHAPES = (("causal qwen1.5-0.5b prompt", 1, 512, 512, 16, 64, True),
          ("adaptor_bert", 8, 64, 64, 12, 64, False),
          ("cross whisper-medium", 1, 64, 1500, 16, 64, False),
          ("causal qwen2-72b prompt", 1, 512, 512, 64, 128, True),
          ("local recurrentgemma-2b", 1, 2048, 2048, 10, 256, True),
          ("causal hd 512", 1, 512, 512, 8, 512, True))


def worker() -> None:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from timing import Timer

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    timer = Timer(dev)
    result = {}
    for label, b, sq, skv, h, hd, causal in SHAPES:
        for dn in DTYPES:
            dt = getattr(torch, dn)
            q = torch.randn(b, sq, h, hd, generator=g, device=dev).to(dt)
            k, v = (torch.randn(b, skv, h, hd, generator=g, device=dev)
                    .to(dt) for _ in range(2))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            pairs = sum(min(i + 1, skv) for i in range(sq)) if causal \
                else sq * skv
            es = q.element_size()
            row = dict(
                library_ms=timer(lambda: torch.nn.functional
                                 .scaled_dot_product_attention(
                                     qt, kt, vt, is_causal=causal),
                                 reps=REPS),
                bound_ms=bound_ms((2 * b * sq + 2 * b * skv) * h * hd * es,
                                  4 * b * h * hd * pairs, dt)[0])

            def run():
                return fa.flash_attention(q, k, v, causal=causal)
            try:
                out = run()
            except ValueError as e:          # a shape the tree refuses
                row.update(ms=None, refused=str(e))
            else:
                want = fa.flash_attention_plain(q, k, v, causal=causal)
                lim = (2e-5 if dt == torch.float32 else 2 ** -7) \
                    * float(v.float().abs().max())
                if dt != torch.float32:
                    lim = min(lim, 2 ** -6 * float(want.float().abs().max()))
                err = float((out.float() - want.float()).abs().max())
                if not err <= lim:
                    raise AssertionError(f"{label} {dn}: err {err} > {lim}")
                row.update(err=err, ms=timer(run, reps=REPS),
                           kernels_us=kernel_us(run, timer.flush),
                           grid=list(fa.flash_attention.last_grid))
            result[f"{label} [{b},{sq}|{skv},{h},{hd}] {dn[:4]}"] = row
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    print(json.dumps(result))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=False,
                    help="the other tree's src directory")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return 0
    smi = nvidia_smi()
    trees = {"change": CHANGE_SRC}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    order = [t for t in ORDER if t in trees]
    build_trees(trees)
    runs = [(tree, run_worker(trees[tree], script=__file__))
            for tree in order]
    print(f"{'row':<52} " + " ".join(f"{t:>9}" for t, _ in runs)
          + f" {'SDPA':>9} {'bound':>9}  grid (change)")
    for key in runs[0][1]:
        rs = [r[key] for _, r in runs]
        line = f"{key:<52} " + " ".join(
            "  refused" if r["ms"] is None else f"{r['ms']:>9.4f}" for r in rs)
        line += "".join(f" {column(rs, k):>9}"
                        for k in ("library_ms", "bound_ms"))
        grid = next((r.get("grid") for (t, _), r in zip(runs, rs)
                     if t == "change"), None)
        print(line + f"  {grid}")
    print("device us per call by kernel:")
    for key in runs[0][1]:
        print(f"  {key:<52} " + "  ".join(
            f"{t} {r[key]['kernels_us']}" for t, r in runs
            if r[key]["ms"] is not None))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"device": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
