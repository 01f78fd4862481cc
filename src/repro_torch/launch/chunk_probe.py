"""Where the split walk's time goes, on a CUDA card.

``python src/repro_torch/launch/chunk_probe.py [--kernel decode|chunk]
[--hd 64] [--pairs bf16 int8 f32q f32] [--pattern ...] [--splits plan 1 2 4 8]``
runs ``paged_decode_attention`` (B 8, 16 heads of 64, 32 pool blocks of
16) and ``chunked_prefill_attention`` (the same at W 16): the serving
shape of ``chip_smoke.py`` phase 2, by default over a bf16 and an int8
pool (``--pairs``: bf16 q over a bf16 pool, bf16 q over an int8 pool, f32
q over a bf16 pool, f32 q over an f32 pool), for three patterns of
positions (the serving mix of lengths 1-512, every slot at its first
position or chunk, every slot at its last) and the wrapper's own
key-range plan beside fixed counts (by default 1, 2, 4 and 8), the walk
and the merge kernel timed apart.  ``--hd`` sets the head dim (a multiple
of 16 up to 128).  Each setting runs 20 calls under ``torch.profiler``
with the L2 cache flushed before each call, and the device time of each
kernel is printed per call, in microseconds, beside the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from unittest import mock

import torch

from repro_torch.kernels import chunked_prefill as cp
from repro_torch.kernels import paged_attention as pa

# lane-0 positions per slot: decode's query position (length - 1) or the
# chunk's first lane
PATTERNS = {
    "decode": {"serving": [0, 16, 99, 254, 255, 299, 510, 511],
               "first position": [0] * 8, "last position": [511] * 8},
    "chunk": {"serving": [0, 16, 48, 100, 203, 300, 400, 496],
              "first chunk": [0] * 8, "last chunk": [496] * 8},
}
CALLS = 20
# --pairs: (q dtype, pool dtype)
PAIRS = {"bf16": (torch.bfloat16, torch.bfloat16),
         "int8": (torch.bfloat16, torch.int8),
         "f32q": (torch.float32, torch.bfloat16),
         "f32": (torch.float32, torch.float32)}


def inputs(g, dev, pair, starts, W, hd, B=8, h=16, kv=16, bs=16, nblk=32):
    nb = B * nblk + 1
    q_dt, kv_dt = PAIRS[pair]
    if kv_dt == torch.int8:
        k, v = (torch.randint(-127, 128, (nb, bs, kv, hd), generator=g,
                              device=dev, dtype=torch.int8) for _ in range(2))
        sc = {n: torch.rand(nb, bs, kv, generator=g, device=dev) * 0.03 + 5e-3
              for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(nb, bs, kv, hd, generator=g, device=dev)
                .to(kv_dt) for _ in range(2))
        sc = {}
    tables = (torch.randperm(nb - 1, generator=g, device=dev) + 1) \
        .reshape(B, nblk).to(torch.int32)
    q = torch.randn(B, W, h, hd, generator=g, device=dev).to(q_dt)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    if W == 1:      # decode: q [B, h, hd] and lengths
        return (q[:, 0].contiguous(), k, v, tables, start + 1), sc
    return (q, k, v, tables, start), sc


def kernel_us(fn, flush) -> dict[str, float]:
    """Device microseconds per call of each kernel ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if "chunk_" in e.key:
            name = e.key.replace("(anonymous namespace)::", "")
            out[name.split("(")[0].removeprefix("void ").strip()] = t / CALLS
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("decode", "chunk"), nargs="+",
                    default=["decode", "chunk"])
    ap.add_argument("--hd", type=int, default=64)
    ap.add_argument("--pairs", choices=tuple(PAIRS), nargs="+",
                    default=["bf16", "int8"])
    ap.add_argument("--pattern", nargs="+",
                    help="position patterns to run (default: all)")
    ap.add_argument("--splits", nargs="+", default=["plan", "1", "2", "4", "8"],
                    help="'plan' and/or fixed key-range counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chunk_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"hd {args.hd}")
    print(f"{'kernel':>6} {'pattern':>14} {'pair':>5} {'splits':>7}  "
          "device us per call")
    for kernel in args.kernel:
        fn = pa.paged_decode_attention if kernel == "decode" \
            else cp.chunked_prefill_attention
        W = 1 if kernel == "decode" else 16
        for pattern, starts in PATTERNS[kernel].items():
            if args.pattern and pattern not in args.pattern:
                continue
            for pair in args.pairs:
                operands, sc = inputs(g, dev, pair, starts, W, args.hd)

                def call(operands=operands, sc=sc, fn=fn):
                    return fn(*operands, **sc)
                for splits in args.splits:
                    if splits == "plan":
                        us = kernel_us(call, flush)
                        label = f"plan {fn.last_grid[1]}"
                    else:
                        label = splits
                        with mock.patch.object(cp, "kv_splits",
                                               lambda *a, s=int(splits): s):
                            us = kernel_us(call, flush)
                    parts = ", ".join(f"{k} {v:.2f}" for k, v in us.items())
                    print(f"{kernel:>6} {pattern:>14} {pair:>5} {label:>7}  "
                          f"total {sum(us.values()):.2f}: {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
