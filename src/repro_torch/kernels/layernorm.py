"""Row norms: the counterpart of the reference's Pallas ``layernorm`` and
``rmsnorm``.

``layernorm(x, gamma, beta)`` and ``rmsnorm(x, gamma)`` normalise each row
of ``x [R, D]`` in float32 (the layernorm variance centred, as the Pallas
kernel computes it; eps 1e-5 and 1e-6, the reference's) and return x's
dtype.  ``gamma`` and ``beta`` are ``[D]`` in float32 or bfloat16 (both the
same), whatever x's dtype, as the reference casts them with
``astype(float32)``.  Any width is taken.  A CUDA tensor launches the
hand-written kernel of ``csrc/layernorm.cu`` on the launch plan of
``norm_plan``; a CPU tensor runs the plain version.  ``layernorm_plain``
and ``rmsnorm_plain`` are also the model's own norms
(``models/layers.py``), so the two share one copy of the arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime

_DTYPES = (torch.float32, torch.bfloat16)
LN_EPS, RMS_EPS = 1e-5, 1e-6          # the reference kernels' defaults

UNIT_BYTES = 16          # a vector unit: 8 bf16 or 4 float32 values
REG_UNITS = (1, 2, 4)    # units a thread holds of a row (compiled variants)
WARP_CTA_THREADS = 256   # a warp a row: 8 rows a CTA at once
ROW_THREADS = 512        # norm_regs: at most 16 warps a CTA
MAX_ROW_WARPS = 16       # warps that share a row in registers, at most
STREAM_THREADS = 512     # norm_stream: at most 16 warps a CTA
# __launch_bounds__(512, 1) caps a norm_regs thread at 65536 / 512 = 128
# registers, __launch_bounds__(512, 2) a norm_stream thread at 64, so at
# least REG_BUDGET // (cap x threads) CTAs fit on an SM
REG_BUDGET = 65536
REG_CAP = {"warp": 128, "warps": 128, "stream": 64}
SM_THREADS, SM_CTAS = 2048, 32   # Hopper's per-SM limits


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """The kernel's function in plain PyTorch (and the model's LayerNorm)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = RMS_EPS) -> torch.Tensor:
    """The kernel's function in plain PyTorch (and the model's RMSNorm)."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


class NormPlan(NamedTuple):
    """One launch of the norm kernel.  ``layout``: "warp" (a warp owns a
    row, ``threads`` / 32 rows a CTA at once), "warps" (``wpr`` warps own
    a row, the CTA is one row group) or "stream" (a CTA walks a row,
    reading it again from L2).  ``vector``: units of 16 bytes, else of one
    element.  ``units``: units a thread holds of a row (0 when
    streaming).  ``grid``: CTAs, each walking rows with a grid stride."""
    layout: str
    vector: bool
    units: int
    wpr: int
    threads: int
    grid: int

    @property
    def rows_per_cta(self) -> int:
        """Rows a CTA holds at once."""
        return self.threads // 32 if self.layout == "warp" else 1

    @property
    def code(self) -> int:
        """The kernel's layout code (csrc/layernorm.cu ``Layout``)."""
        return (self.layout == "stream") + 2 * (not self.vector)


def resident_ctas(layout: str, threads: int) -> int:
    """CTAs of ``threads`` that fit on one SM at the kernel's register cap
    (a lower bound of the occupancy: the compiled kernel may use fewer
    registers)."""
    return max(1, min(REG_BUDGET // (REG_CAP[layout] * threads),
                      SM_THREADS // threads, SM_CTAS))


def unit_elems(dtype: torch.dtype) -> int:
    """Values of ``dtype`` in one 16-byte unit."""
    return UNIT_BYTES // dtype.itemsize


@functools.lru_cache(maxsize=1024)
def norm_plan(R: int, D: int, dtype: torch.dtype, sms: int,
              vector: bool = True) -> NormPlan:
    """The launch plan of a norm over ``[R, D]`` in ``dtype`` on ``sms``
    SMs, from the shapes alone.  ``vector``: every row's units are 16-byte
    aligned (D a multiple of ``unit_elems``, x, y and the parameters on
    16-byte addresses); else units of one element.

    While the row groups fit in one wave of SMs x ``resident_ctas`` (a
    decode or a mixed step), a row is spread over as many warps as it
    needs at the fewest units a thread, up to ``MAX_ROW_WARPS``: the step
    is latency-bound, and a thread's share of the row is short.  Beyond a
    wave (a prefill), a warp owns a row wherever 4 units a thread cover it,
    else the fewest warps at 4 units, and the grid is one persistent wave.
    A row wider than ``MAX_ROW_WARPS`` warps of 4 units streams."""
    if R < 1 or D < 1:
        raise ValueError(f"norm_plan: empty [R={R}, D={D}]")
    n = unit_elems(dtype) if vector else 1
    if D % n:
        raise ValueError(f"norm_plan: D={D} is not a multiple of the "
                         f"{n}-value unit; pass vector=False")
    units = D // n
    fits = [(u, math.ceil(units / (32 * u))) for u in REG_UNITS
            if units <= 32 * u * MAX_ROW_WARPS]
    if not fits:
        threads = min(STREAM_THREADS, 32 * math.ceil(units / 32))
        return NormPlan("stream", vector, 0, threads // 32, threads,
                        min(R, sms * resident_ctas("stream", threads)))
    u, wpr = fits[0]
    if wpr > 1 and R <= sms * resident_ctas("warps", 32 * wpr):
        return NormPlan("warps", vector, u, wpr, 32 * wpr, R)
    u, wpr = fits[-1]
    if wpr == 1:
        u = next(v for v, _ in fits if units <= 32 * v)
        warps = min(WARP_CTA_THREADS // 32, R)
        return NormPlan("warp", vector, u, 1, 32 * warps, min(
            math.ceil(R / warps), sms * resident_ctas("warp", 32 * warps)))
    return NormPlan("warps", vector, u, wpr, 32 * wpr,
                    min(R, sms * resident_ctas("warps", 32 * wpr)))


def _check(name: str, x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [R, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype {x.dtype} not one of {_DTYPES}")
    for p in params:
        if p.shape != (x.shape[1],):
            raise ValueError(f"{name}: parameters must be [D={x.shape[1]}], "
                             f"got {tuple(p.shape)}")
        if p.dtype not in _DTYPES or p.dtype != params[0].dtype:
            raise ValueError(f"{name}: parameter dtypes "
                             f"{[q.dtype for q in params]}; they must be "
                             f"float32 or bfloat16, all one")


@functools.cache
def _kernels():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan = [i] * 5                      # layout, units, wpr, threads, grid
    return (runtime.bind("layernorm", [p, p, p, p, i, i, i, i, *plan, f, p]),
            runtime.bind("rmsnorm", [p, p, p, i, i, i, i, *plan, f, p]))


def _launch(wrapper, x: torch.Tensor, params: tuple, eps: float
            ) -> torch.Tensor:
    """Launch the kernel behind ``wrapper`` (layernorm or rmsnorm) on
    ``norm_plan``'s plan; count the launch and record the plan on it."""
    name = wrapper.__name__
    runtime.require_cuda(name, x, *params)
    runtime.require_contiguous(name, x=x, **{f"param{i}": t
                                             for i, t in enumerate(params)})
    R, D = x.shape
    y = torch.empty_like(x)
    if R == 0 or D == 0:
        return y
    ptrs = [t.data_ptr() for t in (x, *params, y)]
    vector = D % unit_elems(x.dtype) == 0 \
        and not any(p % UNIT_BYTES for p in ptrs)
    plan = norm_plan(R, D, x.dtype, runtime.sm_count(x.device), vector)
    fn = _kernels()[0 if name == "layernorm" else 1]
    err = fn(*ptrs, R, D, runtime.DTYPE_CODES[x.dtype],
             runtime.DTYPE_CODES[params[0].dtype], plan.code, plan.units,
             plan.wpr, plan.threads, plan.grid, eps, runtime.stream_handle(x))
    runtime.check(err, name)
    wrapper.launches += 1
    wrapper.last_plan = plan
    return y


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """Row-wise LayerNorm: x [R, D] -> [R, D] in x's dtype."""
    _check("layernorm", x, gamma, beta)
    if all(t.device.type == "cpu" for t in (x, gamma, beta)):
        return layernorm_plain(x, gamma, beta)
    return _launch(layernorm, x, (gamma, beta), LN_EPS)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Row-wise RMSNorm: x [R, D] -> [R, D] in x's dtype."""
    _check("rmsnorm", x, gamma)
    if all(t.device.type == "cpu" for t in (x, gamma)):
        return rmsnorm_plain(x, gamma)
    return _launch(rmsnorm, x, (gamma,), RMS_EPS)


layernorm.launches = 0
rmsnorm.launches = 0
layernorm.last_plan = None       # the NormPlan of the last launch
rmsnorm.last_plan = None
