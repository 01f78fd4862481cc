"""Row norms: the counterpart of the reference's Pallas ``layernorm`` and
``rmsnorm``.

``layernorm(x, gamma, beta)`` and ``rmsnorm(x, gamma)`` normalise each row
of ``x [R, D]`` in float32 (the layernorm variance centred, as the Pallas
kernel computes it; eps 1e-5 and 1e-6, the reference's) and return x's
dtype.  ``gamma`` and ``beta`` are
``[D]`` in float32 or in x's dtype (both the same).  A CUDA tensor
launches the hand-written kernel of ``csrc/layernorm.cu``; a CPU tensor
runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_DTYPES = (torch.float32, torch.bfloat16)
# the kernel holds a row in shared memory as float32 (227 KB per block)
MAX_D = 227 * 1024 // 4
LN_EPS, RMS_EPS = 1e-5, 1e-6          # the reference kernels' defaults


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    x32 = x.float()
    mu = x32.sum(-1, keepdim=True) / x.shape[-1]
    cent = x32 - mu
    var = (cent * cent).sum(-1, keepdim=True) / x.shape[-1]
    y = cent * torch.rsqrt(var + LN_EPS)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    x32 = x.float()
    var = (x32 * x32).sum(-1, keepdim=True) / x.shape[-1]
    return (x32 * torch.rsqrt(var + RMS_EPS) * gamma.float()).to(x.dtype)


def _check(name: str, x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [R, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype {x.dtype} not one of {_DTYPES}")
    for p in params:
        if p.shape != (x.shape[1],):
            raise ValueError(f"{name}: parameters must be [D={x.shape[1]}], "
                             f"got {tuple(p.shape)}")
        if p.dtype not in (torch.float32, x.dtype) \
                or p.dtype != params[0].dtype:
            raise ValueError(f"{name}: parameter dtypes "
                             f"{[q.dtype for q in params]}; they must be "
                             f"float32 or x's dtype {x.dtype}, all one")


@functools.cache
def _kernels():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return (runtime.bind("layernorm", [p, p, p, p, i, i, i, i, f, p]),
            runtime.bind("rmsnorm", [p, p, p, i, i, i, i, f, p]))


def _launch(wrapper, x: torch.Tensor, params: tuple, eps: float
            ) -> torch.Tensor:
    """Launch the kernel behind ``wrapper`` (layernorm or rmsnorm) and count
    the launch on it."""
    name = wrapper.__name__
    runtime.require_cuda(name, x, *params)
    runtime.require_contiguous(name, x=x, **{f"param{i}": t
                                             for i, t in enumerate(params)})
    R, D = x.shape
    if D > MAX_D:
        raise ValueError(f"{name}: rows of {D} elements exceed the kernel's "
                         f"{MAX_D} (one float32 row in shared memory)")
    y = torch.empty_like(x)
    if R == 0 or D == 0:
        return y
    fn = _kernels()[0 if name == "layernorm" else 1]
    err = fn(x.data_ptr(), *(t.data_ptr() for t in params), y.data_ptr(), R,
             D, runtime.DTYPE_CODES[x.dtype],
             int(params[0].dtype == torch.float32), eps,
             runtime.stream_handle(x))
    runtime.check(err, name)
    wrapper.launches += 1
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
