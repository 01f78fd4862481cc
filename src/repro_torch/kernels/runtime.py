"""Device resolution and the build-and-load of the port's CUDA kernels.

The counterpart of the reference's ``kernels/runtime.py`` platform
probe.  The kernels are CUDA C++ for Hopper (``sm_90a``) with a plain C
interface, under ``repro_torch/csrc/``.  At first use ``library()``
compiles every ``*.cu`` file with ``nvcc`` (one compiler process per
source, all started together), links them into one shared library, and
loads it with ``ctypes``.  The build lands in ``build/repro_torch/<hash>``
at the repository root, keyed by a hash of the sources and flags, so an
edited kernel rebuilds and an unchanged one is reused.  Nothing is built
when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

# cudaError_t / dtype codes shared with the C interface of csrc/*.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the given one, else the card.

    There is no silent host fallback: without a visible CUDA device the
    caller must ask for the CPU (the plain PyTorch path) explicitly.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return torch.device("cuda", torch.cuda.current_device())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels need the CUDA toolkit to build")
    return found


def _sources() -> tuple[list[Path], str]:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels unless this exact build exists; returns
    the shared library's path.  The compiler's register and shared-memory
    report is kept beside it in ``build.log``."""
    srcs, digest = _sources()
    out_dir = BUILD_ROOT / digest
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix=f"tmp-{digest}-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        logs.append(f"== build seconds: {time.perf_counter() - t0:.3f}\n")
        (tmp / "build.log").write_text("".join(logs))
        try:
            tmp.rename(out_dir)
        except OSError:
            # a concurrent build of the same sources won the rename
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bind(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """One C entry point of the library with its argument types declared
    (pointers and the stream as ``c_void_p``; returns ``cudaError_t``)."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every operand of a kernel launch must sit on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(
            f"{name}: tensors on {dev.type!r}; the kernel runs on CUDA "
            "tensors and the plain PyTorch version on CPU tensors")


def require_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
