"""Every kernel launch on its operands' device (ROADMAP Queue 3 fault G),
and the kernels at granite-moe-1b-a400m's serving shapes.

* On the host: each of the twelve wrappers reaches its C entry point only
  through ``kernels.runtime.launch``, the one guard that makes the
  operands' device current for the launch.  The wrappers run on ``meta``
  tensors with the CUDA-only checks patched out, ``runtime.bind`` hands
  out entry points that fail if called, and ``runtime.launch`` is
  replaced by a recorder: each call must record exactly its own kernel,
  with its operands' device, and count one launch.
* On the host: ``runtime.launch`` enters ``torch.cuda.device`` only where
  the operands' device differs from the current one, calls the entry
  inside it, and passes that device's current stream last.
* On the card (``cuda`` marker): with another device current
  (``torch.cuda.set_device``), each kernel on device 0 tensors equals its
  plain version.  It needs two devices and skips on one card.
* On the card: ``tiled_matmul`` and ``int8_matmul`` at granite's K/V
  width (M x 1024 x 512 for the decode and mixed steps), ``int8_matmul``
  bit-identical to its plain version; both paged walks at granite's 16
  heads over 8 kv heads of 64 (decode, and W 16) over bf16 and int8
  pools, NaN in the null block: bf16 out within one bf16 step of each
  output, 2^-7 x max(|out|, 1), f32 out over an int8 pool within 2e-5 (f32
  order of sums).

This module does not import the JAX reference, so it runs on the card:
``python -m pytest -q --noconftest -m cuda tests/test_torch_launch.py``.
"""
import contextlib
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunked_prefill as cp
from repro_torch.kernels import ffn as ffn_mod
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels import layernorm as ln
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import qkv_proj as qkv
from repro_torch.kernels import rglru_scan as scan
from repro_torch.kernels import runtime
from repro_torch.kernels import ssm_scan as sscan
from repro_torch.kernels import tiled_matmul as tm
from repro_torch.kernels.counts import LIVE_KV, launch_counts, wrappers

# the bound entry points, cached per module
ENTRY_CACHES = (tm._kernel, i8._kernel, pa._kernel, cp._kernel, fa._kernel,
                ffn_mod._kernels, qkv._kernel, ln._kernels, scan._kernel,
                sscan._kernel)


class _Entry:
    """A C entry point that must not be called outside ``runtime.launch``."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, *args):
        raise AssertionError(f"{self.name} launched outside runtime.launch")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _calls() -> dict:
    """One call of each wrapper on meta tensors, by kernel name."""
    B, h, kv, hd, nb, bs, nblk = 2, 4, 2, 64, 9, 16, 4
    i32 = dict(dtype=torch.int32)
    pool = (_meta(nb, bs, kv, hd), _meta(nb, bs, kv, hd),
            _meta(B, nblk, **i32), _meta(B, **i32))
    return {
        "tiled_matmul": lambda: tm.tiled_matmul(_meta(8, 64), _meta(64, 32)),
        "paged_decode_attention": lambda: pa.paged_decode_attention(
            _meta(B, h, hd), *pool),
        "chunked_prefill_attention": lambda: cp.chunked_prefill_attention(
            _meta(B, 4, h, hd), *pool),
        "int8_matmul": lambda: i8.int8_matmul(
            _meta(8, 64, dtype=torch.int8), _meta(1, dtype=torch.float32),
            _meta(64, 32, dtype=torch.int8), _meta(1, 32,
                                                   dtype=torch.float32)),
        "ffn1": lambda: ffn_mod.ffn1(_meta(8, 64), _meta(64, 32),
                                     _meta(32)),
        "ffn1_gated": lambda: ffn_mod.ffn1_gated(_meta(8, 64), _meta(64, 32),
                                                 _meta(64, 32)),
        "qkv_proj": lambda: qkv.qkv_proj(_meta(8, 64), _meta(64, 64),
                                         _meta(64, 32), _meta(64, 32)),
        "layernorm": lambda: ln.layernorm(_meta(8, 64), _meta(64),
                                          _meta(64)),
        "rmsnorm": lambda: ln.rmsnorm(_meta(8, 64), _meta(64)),
        "flash_attention": lambda: fa.flash_attention(
            _meta(1, 32, 2, 64), _meta(1, 32, 2, 64), _meta(1, 32, 2, 64)),
        "rglru_scan": lambda: scan.rglru_scan(
            _meta(B, 8, 64, dtype=torch.float32),
            _meta(B, 8, 64, dtype=torch.float32), _meta(B, **i32)),
        "ssm_scan": lambda: sscan.ssm_scan(
            _meta(B, 8, 64, dtype=torch.float32), _meta(B, 8, 64),
            _meta(B, 8, 16, dtype=torch.float32),
            _meta(B, 8, 16, dtype=torch.float32),
            _meta(64, 16, dtype=torch.float32), _meta(B, **i32)),
    }


def test_every_wrapper_launches_through_the_device_guard():
    launched = []

    def recorder(name, entry, t, *args):
        assert isinstance(entry, _Entry), name
        launched.append((name, entry.name, t.device.type))

    counts = launch_counts()
    for cache in ENTRY_CACHES:
        cache.cache_clear()
    try:
        with mock.patch.object(runtime, "bind", lambda name, argtypes:
                               _Entry(name)), \
                mock.patch.object(runtime, "launch", recorder), \
                mock.patch.object(runtime, "require_cuda",
                                  lambda *a: None), \
                mock.patch.object(runtime, "sm_count", lambda dev: 132), \
                mock.patch.object(cp, "resident_ctas", lambda *a: 2):
            calls = _calls()
            assert set(calls) == set(wrappers())
            for name, call in calls.items():
                before = launch_counts()[name]
                n = len(launched)
                call()
                assert launched[n:] == [(name, name, "meta")], name
                assert launch_counts()[name] == before + 1, name
    finally:
        for cache in ENTRY_CACHES:
            cache.cache_clear()
        for name, fn in wrappers().items():
            fn.launches = counts[name]
        for name in LIVE_KV:
            wrappers()[name].live_kv_launches = counts[f"{name}.live_kv"]


@pytest.mark.parametrize("current,switched", [(0, True), (1, False)])
def test_launch_switches_only_to_another_device(current, switched):
    """Operands on cuda:1: with device 0 current the entry runs inside
    ``torch.cuda.device(1)``; with device 1 current no switch is made.
    The stream is cuda:1's current one either way."""
    inside = []
    calls = []

    @contextlib.contextmanager
    def device(index):
        inside.append(index)
        yield
        inside.pop()

    def entry(*args):
        calls.append((args, list(inside)))
        return 0

    streams = {}

    def current_stream(dev):
        streams[dev] = types.SimpleNamespace(cuda_stream=700 + dev.index)
        return streams[dev]

    t = types.SimpleNamespace(device=torch.device("cuda", 1))
    with mock.patch.object(torch.cuda, "current_device", lambda: current), \
            mock.patch.object(torch.cuda, "device", device), \
            mock.patch.object(torch.cuda, "current_stream", current_stream):
        runtime.launch("kernel", entry, t, 3, 4)
    assert calls == [((3, 4, 701), [1] if switched else [])]
    assert not inside


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _bf16_close(got, want):
    """One bf16 step of each output: 2^-7 x max(|want|, 1)."""
    d = (got.float() - want.float()).abs() \
        / (2 ** -7 * want.float().abs().clamp_min(1))
    assert float(d.max()) <= 1.0, float(d.max())


def _paged(g, dev, B, W, h, kv, hd, pool, bs=16, nblk=32):
    """q [B, W, h, hd] bf16, a shuffled block table per slot over a pool
    of B * nblk blocks (row 0, the null block, NaN), lane-0 positions that
    end at most at the table's end."""
    nb = B * nblk + 1
    tables = (torch.randperm(B * nblk, generator=g, device=dev)
              .reshape(B, nblk) + 1).to(torch.int32)
    start = torch.randint(0, nblk * bs - W + 1, (B,), generator=g,
                          device=dev, dtype=torch.int32)
    q = torch.randn(B, W, h, hd, generator=g, device=dev).bfloat16()
    kw = {}
    if pool == "int8":
        k = torch.randint(-127, 128, (nb, bs, kv, hd), generator=g,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (nb, bs, kv, hd), generator=g,
                          device=dev, dtype=torch.int8)
        kw = {f"{n}_scale": torch.rand(nb, bs, kv, generator=g, device=dev)
              * 0.02 for n in "kv"}
        for s in kw.values():
            s[0] = float("nan")
    else:
        k = torch.randn(nb, bs, kv, hd, generator=g, device=dev).bfloat16()
        v = torch.randn(nb, bs, kv, hd, generator=g, device=dev).bfloat16()
        k[0] = v[0] = float("nan")
    return q, k, v, tables, start, kw


def _check_walks(g, dev, B, h, kv, hd, pool):
    for W in (1, 16):
        q, k, v, tables, start, kw = _paged(g, dev, B, W, h, kv, hd, pool)
        for qq in (q, q.float()) if pool == "int8" else (q,):
            if W == 1:
                qd = qq[:, 0].contiguous()
                got = pa.paged_decode_attention(qd, k, v, tables, start + 1,
                                                **kw)
                want = pa.paged_decode_attention_plain(qd, k, v, tables,
                                                       start + 1, **kw)
            else:
                got = cp.chunked_prefill_attention(qq, k, v, tables, start,
                                                   **kw)
                want = cp.chunked_prefill_attention_plain(qq, k, v, tables,
                                                          start, **kw)
            assert torch.isfinite(got).all()
            if qq.dtype == torch.bfloat16:
                _bf16_close(got, want)
            else:
                torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_cuda_kernels_launch_on_their_device_with_another_current():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a one-card machine has no "
                    "other device to make current)")
    runtime.build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.set_device(1)
    try:
        a = torch.randn(128, 1024, generator=g, device=dev).bfloat16()
        w = (torch.randn(1024, 512, generator=g, device=dev) / 32).bfloat16()
        _bf16_close(tm.tiled_matmul(a, w), tm.tiled_matmul_plain(a, w))
        qx = torch.randint(-127, 128, (128, 1024), generator=g, device=dev,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (1024, 512), generator=g, device=dev,
                           dtype=torch.int8)
        sx = torch.rand(1, generator=g, device=dev) * 1e-3
        sw = torch.rand(1, 512, generator=g, device=dev) * 1e-3
        assert torch.equal(i8.int8_matmul(qx, sx, qw, sw),
                           i8.int8_matmul_plain(qx, sx, qw, sw,
                                                torch.bfloat16))
        for pool in ("bf16", "int8"):
            _check_walks(g, dev, 8, 16, 8, 64, pool)
        x = torch.randn(128, 1024, generator=g, device=dev).bfloat16()
        gamma = torch.rand(1024, generator=g, device=dev) + 0.5
        _bf16_close(ln.rmsnorm(x, gamma), ln.rmsnorm_plain(x, gamma))
        _bf16_close(ln.layernorm(x, gamma, gamma - 1),
                    ln.layernorm_plain(x, gamma, gamma - 1))
        wg = (torch.randn(1024, 512, generator=g, device=dev) / 32).bfloat16()
        b1 = torch.zeros(512, device=dev).bfloat16()
        _bf16_close(ffn_mod.ffn1(a, w, b1, "gelu"),
                    ffn_mod.ffn1_plain(a, w, b1, "gelu"))
        _bf16_close(ffn_mod.ffn1_gated(a, w, wg),
                    ffn_mod.ffn1_gated_plain(a, w, wg))
        for got, want in zip(qkv.qkv_proj(a, w, wg, w),
                             qkv.qkv_proj_plain(a, w, wg, w), strict=True):
            _bf16_close(got, want)
        qf = torch.randn(1, 256, 4, 64, generator=g, device=dev).bfloat16()
        _bf16_close(fa.flash_attention(qf, qf, qf),
                    fa.flash_attention_plain(qf, qf, qf))
        sa = torch.rand(2, 64, 256, generator=g, device=dev)
        sg = torch.randn(2, 64, 256, generator=g, device=dev)
        sn = torch.tensor([64, 20], dtype=torch.int32, device=dev)
        for got, want in zip(scan.rglru_scan(sa, sg, sn),
                             scan.rglru_scan_plain(sa, sg, sn), strict=True):
            assert torch.equal(got, want)
        sdt = torch.rand(2, 40, 256, generator=g, device=dev)
        sb = torch.randn(2, 40, 16, generator=g, device=dev)
        sx = torch.randn(2, 40, 256, generator=g, device=dev).bfloat16()
        sa2 = -torch.rand(256, 16, generator=g, device=dev) * 3
        sn2 = torch.tensor([40, 17], dtype=torch.int32, device=dev)
        for got, want in zip(sscan.ssm_scan(sdt, sx, sb, sb, sa2, sn2),
                             sscan.ssm_scan_plain(sdt, sx, sb, sb, sa2, sn2),
                             strict=True):
            assert torch.equal(got, want)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 1
    finally:
        torch.cuda.set_device(0)


@pytest.mark.cuda
def test_cuda_kernels_at_granite_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    g = torch.Generator(device=dev).manual_seed(1)
    for M in (8, 128):
        a = torch.randn(M, 1024, generator=g, device=dev).bfloat16()
        w = (torch.randn(1024, 512, generator=g, device=dev) / 32).bfloat16()
        got = tm.tiled_matmul(a, w)
        _bf16_close(got, tm.tiled_matmul_plain(a, w))
        assert torch.equal(got, tm.tiled_matmul(a, w))
        qx = torch.randint(-127, 128, (M, 1024), generator=g, device=dev,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (1024, 512), generator=g, device=dev,
                           dtype=torch.int8)
        sx = torch.rand(1, generator=g, device=dev) * 1e-3
        sw = torch.rand(1, 512, generator=g, device=dev) * 1e-3
        for dt in (torch.bfloat16, torch.float32):
            assert torch.equal(i8.int8_matmul(qx, sx, qw, sw, out_dtype=dt),
                               i8.int8_matmul_plain(qx, sx, qw, sw, dt))
    for pool in ("bf16", "int8"):
        _check_walks(g, dev, 8, 16, 8, 64, pool)
