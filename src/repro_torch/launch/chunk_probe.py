"""Where the chunked-prefill kernel's time goes, on a CUDA card.

``python src/repro_torch/launch/chunk_probe.py`` runs
``chunked_prefill_attention`` at the serving shape of ``chip_smoke.py``
phase 2 (B 8, W 16, 16 heads of 64, 32 pool blocks of 16) over a bf16 and
an int8 pool, for three patterns of lane-0 positions (the serving mix of
lengths 16-512, every slot at its first chunk, every slot at its last)
and the wrapper's own key-range plan beside fixed counts 1, 2, 4 and 8.
Each setting runs 20 calls under ``torch.profiler`` with the L2 cache
flushed before each call, and the device time of each kernel (the main
kernel, the merge) is printed per call, in microseconds, beside the
card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from unittest import mock

import torch

from repro_torch.kernels import chunked_prefill as cp

PATTERNS = {"serving": [0, 16, 48, 100, 203, 300, 400, 496],
            "first chunk": [0] * 8, "last chunk": [496] * 8}
CALLS = 20


def inputs(g, dev, pool, starts, B=8, W=16, h=16, kv=16, hd=64, bs=16,
           nblk=32):
    nb = B * nblk + 1
    if pool == "int8":
        k, v = (torch.randint(-127, 128, (nb, bs, kv, hd), generator=g,
                              device=dev, dtype=torch.int8) for _ in range(2))
        sc = {n: torch.rand(nb, bs, kv, generator=g, device=dev) * 0.03 + 5e-3
              for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(nb, bs, kv, hd, generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        sc = {}
    tables = (torch.randperm(nb - 1, generator=g, device=dev) + 1) \
        .reshape(B, nblk).to(torch.int32)
    q = torch.randn(B, W, h, hd, generator=g, device=dev).to(torch.bfloat16)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
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


def main() -> int:
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
    print(f"{'pattern':>12} {'pool':>5} {'splits':>6}  device us per call")
    for pattern, starts in PATTERNS.items():
        for pool in ("bf16", "int8"):
            args, sc = inputs(g, dev, pool, starts)
            def call(args=args, sc=sc):
                return cp.chunked_prefill_attention(*args, **sc)
            for splits in ("plan", 1, 2, 4, 8):
                if splits == "plan":
                    us = kernel_us(call, flush)
                    grid = cp.chunked_prefill_attention.last_grid
                    splits = f"plan {grid[1]}"
                else:
                    with mock.patch.object(cp, "kv_splits",
                                           lambda *a, s=splits: s):
                        us = kernel_us(call, flush)
                parts = ", ".join(f"{k} {v:.2f}" for k, v in us.items())
                print(f"{pattern:>12} {pool:>5} {splits:>6}  total "
                      f"{sum(us.values()):.2f}: {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
