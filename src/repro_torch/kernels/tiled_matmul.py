"""Tiled matmul: the counterpart of the reference's Pallas ``tiled_matmul``.

``tiled_matmul(a, b)`` computes ``C[M, N] = A[M, K] @ B[K, N]`` with a
float32 accumulator and the output in A's dtype.  A CUDA tensor launches
the hand-written kernel of ``csrc/tiled_matmul.cu``; a CPU tensor runs
``tiled_matmul_plain``.  ``matmul`` folds leading dims into rows, as the
reference's ``kernels/ops.py`` does.

The bf16 main loop (``csrc/mma_tile.cuh``, shared with ``ffn1``,
``ffn1_gated`` and ``qkv_proj``) splits K into ranges of whole 16-wide
slices so that a skinny product fills the card: ``k_splits`` (from M and
K alone, never the widths or the number of weights) and ``k_ranges``.
Each range's float32 partial sums go to a workspace the wrapper
allocates, and a reduce pass adds them in order 0..S-1 before the
epilogue.  ``matmul_partials_plain`` and ``reduce_partials_plain`` are
those two steps in plain PyTorch; the plain versions of the four kernels
take ``splits`` to sum in the same order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_DTYPES = (torch.float32, torch.bfloat16)
K_SLICE = 16        # K of one mma.sync m16n8k16: ranges hold whole slices
RANGE_MIN = 256     # K per range at least: enough slices to keep a ring busy


def k_splits(M: int, K: int) -> int:
    """How many K ranges a bf16 call takes, from M and K alone (so a
    product computed beside others, as in ``qkv_proj``, is summed exactly
    as the same product alone): K // 256, at most 8 for a decode step's
    M <= 16 rows, 4 for one tile of 128 rows, 2 for two, 1 from three."""
    cap = 8 if M <= 16 else 4 // -(-M // 128)
    return max(1, min(cap, K // RANGE_MIN))


def k_ranges(K: int, splits: int) -> list[tuple[int, int]]:
    """The K ranges [lo, hi) of a split: whole 16-wide slices, as even as
    the slice count allows, covering [0, K).  The kernel computes the same
    ranges from its grid index."""
    slices = -(-K // K_SLICE)
    return [(s * slices // splits * K_SLICE,
             min(K, (s + 1) * slices // splits * K_SLICE))
            for s in range(splits)]


def matmul_partials_plain(x: torch.Tensor, w: torch.Tensor,
                          splits: int) -> list[torch.Tensor]:
    """Each K range's float32 partial sum x[:, lo:hi] @ w[lo:hi], as the
    kernel writes it to the workspace."""
    return [x[:, lo:hi].float() @ w[lo:hi].float()
            for lo, hi in k_ranges(x.shape[1], splits)]


def reduce_partials_plain(parts: list[torch.Tensor]) -> torch.Tensor:
    """The reduce pass in plain PyTorch: the ranges' partial sums added in
    order 0..S-1 (float32); the epilogue then sees this sum."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                       splits: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 products and sums,
    output cast to A's dtype.  ``splits`` > 1 sums as the kernel's K split
    does: each range's partial sum, then the ranges in order."""
    return reduce_partials_plain(matmul_partials_plain(a, b, splits)) \
        .to(a.dtype)


def split_plan(x: torch.Tensor, widths: tuple[int, ...]
               ) -> tuple[int, torch.Tensor | None]:
    """The K ranges of a launch of the bf16 loop on ``x [M, K]`` against
    weights of the given widths, and the float32 workspace of their partial
    sums (splits * M * sum(widths); None without a split).  float32 calls
    run one range."""
    M, K = x.shape
    splits = k_splits(M, K) if x.dtype == torch.bfloat16 else 1
    ws = torch.empty(splits * M * sum(widths), dtype=torch.float32,
                     device=x.device) if splits > 1 else None
    return splits, ws


# the C side writes each launch's output tiles, K ranges and dynamic
# shared memory bytes here
PLAN = (ctypes.c_int * 3)()


def launched_grid() -> tuple[int, int, int]:
    """(output tiles, K ranges, dynamic shared memory bytes) of the last
    launch of the shared loop, by any of its four wrappers."""
    return tuple(PLAN)


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("tiled_matmul",
                        [p, p, p, i, i, i, i, p, i, ctypes.POINTER(i), p])


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N]; A and B share a dtype (float32 or
    bfloat16), are 2-D and contiguous."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not form a matmul")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(f"tiled_matmul: dtypes {a.dtype}, {b.dtype}; both "
                         f"must be one of {_DTYPES}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tiled_matmul_plain(a, b)
    runtime.require_cuda("tiled_matmul", a, b)
    runtime.require_contiguous("tiled_matmul", a=a, b=b)
    (M, K), N = a.shape, b.shape[1]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=a.dtype, device=a.device)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    splits, ws = split_plan(a, (N,))
    runtime.launch("tiled_matmul", _kernel(), a, a.data_ptr(), b.data_ptr(),
                   c.data_ptr(), M, K, N, runtime.DTYPE_CODES[a.dtype],
                   None if ws is None else ws.data_ptr(), splits, PLAN)
    tiled_matmul.launches += 1
    return c


tiled_matmul.launches = 0


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., n] = x[..., k] w[k, n] through ``tiled_matmul`` (leading dims
    folded into rows)."""
    lead = x.shape[:-1]
    y = tiled_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*lead, w.shape[1])
