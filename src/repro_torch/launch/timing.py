"""Device timing shared by ``chip_smoke.py`` and the launch probes.

``Timer`` gives the median device time of single calls of a function on a
CUDA card; ``bound_ms`` the least time the card could take for the same
work, from the bytes it must move and the operations it must do, at the
H100 SXM's published rates.  Nothing here runs on the host's clock.
``LAYER_MATMULS`` and ``STEP_ROWS`` are the serving path's bf16 matmul
shapes that ``chip_smoke.py`` and ``launch/matmul_probe.py`` both time,
``NORM_SHAPES`` the norm rows of ``chip_smoke.py`` and
``launch/norm_probe.py``, which both build them with ``norm_operands``,
``norm_calls`` and ``norm_err``; ``SSM_SCAN_SHAPES`` and
``SSM_BWD_SHAPES`` the selective scan's rows of ``chip_smoke.py`` and
``launch/scan_probe.py``, built with ``ssm_operands`` and costed with
``ssm_scan_cost`` / ``ssm_bwd_cost`` (bytes, operations and the issue
floor, ``issue_floor_ms``).
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

# (kernel, R, D, label, element offset of x from an aligned address): the
# serving steps and prefills of the configs the norms serve, then the
# widths and the start the kernel must take beyond them
NORM_SHAPES = (
    ("rmsnorm", 8, 1024, "qwen1.5-0.5b decode step", 0),
    ("rmsnorm", 128, 1024, "qwen1.5-0.5b mixed step", 0),
    ("rmsnorm", 32, 1024, "qwen1.5-0.5b speculative verify (k 3)", 0),
    ("rmsnorm", 128, 8192, "qwen2-72b mixed step", 0),
    ("rmsnorm", 16384, 1024, "qwen1.5-0.5b 16K-token prefill", 0),
    ("rmsnorm", 8192, 8192, "qwen2-72b 8K-token prefill", 0),
    ("rmsnorm", 128, 1536, "deepseek-v3 mixed step q_norm", 0),
    ("rmsnorm", 128, 512, "deepseek-v3 mixed step kv_norm", 0),
    ("rmsnorm", 8, 3072, "phi-3-vision-4.2b decode step", 0),
    ("rmsnorm", 1024, 3072, "phi-3-vision-4.2b 1024-token prefill", 0),
    ("rmsnorm", 8, 2560, "recurrentgemma-2b decode step", 0),
    ("rmsnorm", 3072, 2560, "recurrentgemma-2b 3072-token prefill", 0),
    ("layernorm", 512, 768, "adaptor_bert 8 x 64 tokens", 0),
    ("layernorm", 12000, 1024, "whisper-medium encoder 8 x 1500", 0),
    ("layernorm", 1500, 1024, "whisper-medium encoder 1500 frames", 0),
    ("layernorm", 8, 1024, "whisper-medium decode step", 0),
    *((k, r, d, label, off) for k in ("rmsnorm", "layernorm")
      for r, d, label, off in ((4096, 65, "ragged D 65", 0),
                               (128, 3000, "D 3000", 0),
                               (64, 65536, "D 65536", 0),
                               (128, 1024, "x one element past 16 B", 1))),
)

# a norm's gate, x max|plain|: float32 the order of sums, bfloat16 one
# rounding of the float32 result
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}

# ssm_scan's rows: (B, S, Di, N, lengths or None).  falcon-mamba-7b's
# 3072-token bucket holding a 2300-token prompt; two rows of a 300-token
# bucket; eight one-position rows, two of them past their length; the
# reduced config's width (d_inner 128, state 8); a Di past a CTA's
# channels (8200) and an S a multiple of neither the tile (32) nor the
# checkpoint stride (16)
SSM_SCAN_SHAPES = ((1, 3072, 8192, 16, (2300,)),
                   (2, 300, 8192, 16, (300, 123)),
                   (8, 1, 8192, 16, (1, 0, 1, 1, 0, 1, 1, 1)),
                   (2, 64, 128, 8, (64, 20)),
                   (2, 301, 8200, 16, (301, 157)))
# ssm_scan_bwd's rows (B, S, Di, N): falcon-mamba's width at a training
# batch, the reduced config's, and a ragged Di and S
SSM_BWD_SHAPES = ((4, 512, 8192, 16), (2, 64, 128, 8), (2, 83, 1000, 16))
# float32 lane instructions of the scans' arithmetic (expf is 8: seven
# FP32 / integer operations and one MUFU.EX2): a live forward (position,
# state) takes the discretization (1 + 8 + 2), the update (2) and the
# readout's product and its share of the tree's adds (2); one past its
# row's length the readout only; the backward's chunk recompute (13) and
# adjoint (15 products and sums, 4 tree adds)
SSM_LIVE_OPS, SSM_DEAD_OPS, SSM_BWD_OPS = 16, 2, 32
# H100 SXM: SMs, FP32 lanes an SM, boost clock (NVIDIA's data sheet)
SMS, SM_LANES, CLOCK_HZ = 132, 128, 1.98e9

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


def norm_cost(kernel: str, R: int, D: int, es: int, ps: int
              ) -> tuple[float, float]:
    """Bytes a norm must move (x read and y written once, gamma and, for
    layernorm, beta read once; ``es`` / ``ps`` their element sizes) and its
    float32 operations."""
    params = 1 if kernel == "rmsnorm" else 2
    return (2 * R * D * es + params * D * ps,
            (4 if kernel == "rmsnorm" else 8) * R * D)


def norm_operands(g, dev, kernel: str, R: int, D: int, off: int, dt
                  ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """x [R, D] in ``dt`` starting ``off`` elements past an aligned
    address, and the norm's float32 parameters: (gamma,) or (gamma, beta)."""
    x = (2 * torch.randn(R * D + off, generator=g, device=dev)
         + 0.5).to(dt)[off:].view(R, D)
    gam = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    bet = 0.1 * torch.randn(D, generator=g, device=dev)
    return x, ((gam,) if kernel == "rmsnorm" else (gam, bet))


def norm_calls(ln, kernel: str, x: torch.Tensor, params: tuple):
    """(kernel call, plain call, library call) of ``kernel`` on these
    operands; ``ln`` is a tree's ``repro_torch.kernels.layernorm``.  The
    library call, ``F.rms_norm`` / ``F.layer_norm`` (never called by the
    port), takes the parameters in x's dtype."""
    fn = torch.nn.functional
    d = x.shape[1]
    lib_p = tuple(p.to(x.dtype) for p in params)
    run, plain = getattr(ln, kernel), getattr(ln, f"{kernel}_plain")
    lib = (lambda: fn.rms_norm(x, (d,), *lib_p, ln.RMS_EPS)) \
        if kernel == "rmsnorm" \
        else (lambda: fn.layer_norm(x, (d,), *lib_p, ln.LN_EPS))
    return lambda: run(x, *params), lambda: plain(x, *params), lib


def norm_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """max|out - ref| and its limit, ``NORM_TOL`` x max|ref|."""
    err = float((out.float() - ref.float()).abs().max())
    return err, NORM_TOL[ref.dtype] * float(ref.float().abs().max())


def issue_floor_ms(lane_instr: float) -> float:
    """The least time the card's FP32 lanes take to issue ``lane_instr``
    instructions: every lane of every SM busy at the boost clock."""
    return lane_instr / (SMS * SM_LANES * CLOCK_HZ) * 1e3


def ssm_scan_cost(B: int, S: int, Di: int, N: int, lens, es: int = 2,
                  ckpt: bool = False) -> tuple[float, float, float]:
    """(bytes, float32 operations, lane instructions) of one ``ssm_scan``:
    dt (4 bytes), x (``es``) read and y (4) written a position and channel,
    b and c a position, a, the lengths and the last h once, and with
    ``ckpt`` (training's forward) the checkpoints written; 8 operations a
    live (position, channel, state) (exp counted once) and the readout's 2
    past a row's length."""
    live = B * S if lens is None else sum(min(v, S) for v in lens)
    nbytes = B * S * Di * (4 + es + 4) + 2 * B * S * N * 4 \
        + Di * N * 4 + B * Di * N * 4 + B * 4
    if ckpt:
        nbytes += B * -(-S // 16) * Di * N * 4
    states = Di * N
    return (nbytes, (6 * live + 2 * B * S) * states,
            (SSM_LIVE_OPS * live + SSM_DEAD_OPS * (B * S - live)) * states)


def ssm_bwd_cost(B: int, S: int, Di: int, N: int, es: int = 2
                 ) -> tuple[float, float, float]:
    """(bytes, float32 operations, lane instructions) of one
    ``ssm_scan_bwd`` from the forward's checkpoints: dt, x (``es``), dy
    read and ddt, dx written a position and channel, b, c, db, dc a
    position, a, dh, da and the checkpoints once; 6 operations a state for
    the forward h it needs and 21 for the adjoint."""
    nbytes = B * S * Di * (4 + es + 4 + 4 + es) + 4 * B * S * N * 4 \
        + 2 * Di * N * 4 + B * Di * N * 4 + B * -(-S // 16) * Di * N * 4
    work = B * S * Di * N
    return nbytes, 27 * work, SSM_BWD_OPS * work


def ssm_operands(g, dev, B: int, S: int, Di: int, N: int,
                 x_dtype=torch.bfloat16) -> tuple[torch.Tensor, ...]:
    """dt = softplus of a normal, x in ``x_dtype``, b and c normal,
    a = -exp(U(-1, 1)): the scan's operands at their ranges."""
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, Di, generator=g, device=dev))
    x = torch.randn(B, S, Di, generator=g, device=dev).to(x_dtype)
    b = torch.randn(B, S, N, generator=g, device=dev)
    c = torch.randn(B, S, N, generator=g, device=dev)
    a = -torch.exp(torch.rand(Di, N, generator=g, device=dev) * 2 - 1)
    return dt, x, b, c, a
