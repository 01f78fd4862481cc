"""Quantized matmul: the counterpart of the reference's Pallas
``int8_matmul`` and of ``quantized_dense`` in its ``kernels/ops.py``.

``int8_matmul(qx, sx, qw, sw, out_dtype)`` computes
``C[M, N] = float(sum_k qx[m, k] qw[k, n]) * (sx * sw[n])`` with an exact
integer accumulator, cast once to ``out_dtype``.  A CUDA tensor launches
the hand-written kernel of ``csrc/int8_matmul.cu``; a CPU tensor runs
``int8_matmul_plain``.  ``quantized_dense`` is the serving path: fold the
leading dims into rows, quantize the activations dynamically (one
per-tensor scale over *all* rows, dead lanes and idle slots included, as
the reference does), then the kernel.

The kernel's launch is planned here from the shapes (``int8_plan``): the
CTA's output tile (BM x BN) and, for products with few column tiles, a
split of K into ranges of whole 32-deep slices (``int8_k_ranges``).  Each
range's int32 partial sums go to a workspace the wrapper allocates, and a
reduce pass adds them and applies the epilogue.  Integer sums are exact in
any order, so the plan changes no bit of the result, and unlike the bf16
loop's ``k_splits`` it may use N.  ``int8_partials_plain`` and
``int8_reduce_plain`` are those two steps in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import QTensor, quantize_dynamic
from repro_torch.kernels import runtime

OUT_DTYPES = (torch.float32, torch.bfloat16)
K_SLICE = 32        # K of one mma.sync m16n8k32: ranges hold whole slices
WAVE = 128          # CTAs of about one wave on the H100's 132 SMs
MAX_SPLITS = 16     # K ranges at most
RANGE_MIN = 512     # K per range at least, where K is split


def int8_plan(M: int, K: int, N: int) -> tuple[int, int, int]:
    """(BM, BN, K ranges) of a launch, from the shapes alone.

    A CTA fills its ring at a bounded rate, so many small CTAs beat few
    large ones (``launch/matmul_probe.py --int8-sweep``): BM is 16 rows for
    M <= 16 and 32 above (a mixed step's 128 rows take 4 row tiles); BN is
    64 where that still gives about a wave of CTAs, else 32.  Every serving
    shape (a quarter wave of column tiles and up) measures fastest at one
    K range: a split adds a reduce pass and, on the host, a workspace and
    a launch.  So K is split only below a quarter wave of tiles, into as
    many ranges as bring the CTAs to a quarter wave, each at least
    ``RANGE_MIN`` deep."""
    bm = 16 if M <= 16 else 32
    rows = -(-M // bm)
    bn = 64 if -(-N // 64) * rows >= WAVE else 32
    tiles, quarter = -(-N // bn) * rows, WAVE // 4
    if tiles >= quarter:
        return bm, bn, 1
    return bm, bn, max(1, min(MAX_SPLITS, -(-quarter // tiles),
                              K // RANGE_MIN))


def int8_k_ranges(K: int, splits: int) -> list[tuple[int, int]]:
    """The K ranges [lo, hi) of a split: whole 32-deep slices, as even as
    the slice count allows, covering [0, K).  The kernel computes the same
    ranges from its grid index."""
    slices = -(-K // K_SLICE)
    return [(s * slices // splits * K_SLICE,
             min(K, (s + 1) * slices // splits * K_SLICE))
            for s in range(splits)]


def int8_partials_plain(qx: torch.Tensor, qw: torch.Tensor,
                        splits: int = 1) -> list[torch.Tensor]:
    """Each K range's int32 partial sum qx[:, lo:hi] @ qw[lo:hi], as the
    kernel writes it to the workspace.  PyTorch has no integer matmul on
    CUDA, so the sum is taken in float64: every partial sum is an integer
    below 2^53, so it is exact in any order."""
    return [(qx[:, lo:hi].double() @ qw[lo:hi].double()).to(torch.int32)
            for lo, hi in int8_k_ranges(qx.shape[1], splits)]


def int8_reduce_plain(parts: list[torch.Tensor], sx: torch.Tensor,
                      sw: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The reduce pass in plain PyTorch: the ranges' int32 partial sums
    added in order, the total converted to float32 once (the kernel's one
    rounding), then the epilogue ``acc * (sx * sw)``."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return (acc.float() * (sx.float() * sw.reshape(1, -1).float())) \
        .to(out_dtype)


def int8_matmul_plain(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                      sw: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the exact integer sum
    (one range: any split gives the same bits), the epilogue."""
    return int8_reduce_plain(int8_partials_plain(qx, qw), sx, sw, out_dtype)


# the C side writes each launch's output tiles, K ranges, dynamic shared
# memory bytes, BM and BN here
PLAN = (ctypes.c_int * 5)()


def launched_grid() -> tuple[int, int, int, int, int]:
    """(output tiles, K ranges, dynamic shared memory bytes, BM, BN) of the
    last kernel launch."""
    return tuple(PLAN)


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("int8_matmul", [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, ctypes.POINTER(i), p])


def int8_matmul(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                sw: torch.Tensor, *,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] ``out_dtype``, rescaled by the
    per-tensor activation scale ``sx`` (one float32 element) and the
    per-column weight scales ``sw`` (N float32 elements)."""
    if qx.dim() != 2 or qw.dim() != 2 or qx.shape[1] != qw.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(qx.shape)} @ "
                         f"{tuple(qw.shape)} do not form a matmul")
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f"int8_matmul: operands are {qx.dtype}, {qw.dtype}; "
                         "both must be int8")
    (M, K), N = qx.shape, qw.shape[1]
    if sx.numel() != 1 or sw.numel() != N or sx.dtype != torch.float32 \
            or sw.dtype != torch.float32:
        raise ValueError(f"int8_matmul: scales must be float32 with 1 and "
                         f"N={N} elements, got {tuple(sx.shape)} "
                         f"{sx.dtype} and {tuple(sw.shape)} {sw.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_matmul: out_dtype {out_dtype} not one of "
                         f"{OUT_DTYPES}")
    if all(t.device.type == "cpu" for t in (qx, sx, qw, sw)):
        return int8_matmul_plain(qx, sx, qw, sw, out_dtype)
    runtime.require_cuda("int8_matmul", qx, sx, qw, sw)
    runtime.require_contiguous("int8_matmul", qx=qx, qw=qw, sx=sx, sw=sw)
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=out_dtype, device=qx.device)
    bm, bn, splits = int8_plan(M, K, N)
    c = torch.empty((M, N), dtype=out_dtype, device=qx.device)
    ws = torch.empty(splits * M * N, dtype=torch.int32, device=qx.device) \
        if splits > 1 else None
    err = _kernel()(qx.data_ptr(), qw.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), c.data_ptr(),
                    None if ws is None else ws.data_ptr(), M, K, N,
                    runtime.DTYPE_CODES[out_dtype], bm, bn, splits, PLAN,
                    runtime.stream_handle(qx))
    runtime.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return c


int8_matmul.launches = 0


def quantized_dense(x: torch.Tensor, qw: QTensor) -> torch.Tensor:
    """Serving-path int8 dense: y[..., n] = x[..., k] w[k, n] through
    dynamic per-tensor activation quantization and ``int8_matmul``, in x's
    dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    qx = quantize_dynamic(x2)
    y = int8_matmul(qx.values.contiguous(), qx.scale, qw.values, qw.scale,
                    out_dtype=x.dtype)
    return y.reshape(*lead, qw.values.shape[1])
