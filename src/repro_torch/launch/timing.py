"""Device timing shared by ``chip_smoke.py`` and the launch probes.

``Timer`` gives the median device time of single calls of a function on a
CUDA card; ``bound_ms`` the least time the card could take for the same
work, from the bytes it must move and the operations it must do, at the
H100 SXM's published rates.  Nothing here runs on the host's clock.
``LAYER_MATMULS`` and ``STEP_ROWS`` are the serving path's bf16 matmul
shapes that ``chip_smoke.py`` and ``launch/matmul_probe.py`` both time.
"""
from __future__ import annotations

import statistics
import time

import torch

# each bf16 weight shape (K, N) of a qwen1.5-0.5b layer and its launches
# per fused step (wq, wk, wv, wo; w1, wg; w2), and the rows of a mixed step
# (8 sequences x a chunk of 16) and of a decode step (8 sequences)
LAYER_MATMULS = {(1024, 1024): 4, (1024, 2816): 2, (2816, 1024): 1}
STEP_ROWS = {"mixed": 128, "decode": 8}

HBM_BYTES_S = 3.35e12                  # H100 SXM device memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense bf16 tensor-core rate
              torch.float32: 67e12,    # float32 outside the tensor cores
              torch.int8: 1979e12}     # dense int8 tensor-core rate


class Timer:
    """Median device time of single calls, CUDA events around the call.

    Before each call the L2 cache is flushed (the serving path reads every
    weight and pool block cold: 24 layers of weights and the pool far
    exceed the 50 MB L2), and the stream is held busy by a spin kernel
    long enough for the host to enqueue the whole call, so the events
    measure the device's work and not the host's launch overhead."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        self.ms_per_cycle = s.elapsed_time(e) / 10_000_000

    def __call__(self, fn, reps: int = 15, warm: int = 3) -> float:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin = int((2 * host_ms + 0.2) / self.ms_per_cycle)
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


