"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``), build the
   hand-written kernels from ``src/repro_torch/csrc`` and print the build
   time.
2. Hold each kernel against its plain PyTorch version on the card, on the
   same inputs, and time kernel, plain version, a PyTorch library call and
   the bound.  The serving kernels at the main path's shapes (bf16, f32,
   GQA n_rep > 1; for attention, lengths with partial last blocks and
   null-block table entries, the null block and the unseen tail of each
   sequence's last block filled with NaN so a read of them would show, and
   an int8 pool whose scales there are NaN).  ``int8_matmul`` must be
   bit-identical at the six serving shapes (bf16 and f32 out, each with
   the grid it launched and the bf16 ``torch.matmul`` time beside
   ``torch._int_mm``'s), at every plan of BM, BN and K ranges there, at
   ragged shapes and at a product whose plan splits K, which also runs
   once under ``set_sync_debug_mode("error")``.  The paged attention
   kernels also at the head dims and GQA widths of ROADMAP Queue 3 fault
   A (hd 96; GQA 8 x hd 128: decode, and chunk at W 16 and 32), both
   over fixed key-range counts, each case with the grid it launched, and
   one split call of each under ``set_sync_debug_mode("error")``; both
   with ``live_kv`` (the fleet's dead kv groups, NaN in their queries and
   pool rows) at the fleet's shape (16 heads of 64, groups 12-15 dead on
   every other slot) and at hd 96 and GQA 8 x hd 128, the dead groups'
   outputs bit-exact zeros at the planned and at 1 and 3 key ranges; the
   build prints the split walk's (both entry points')
   and the flash kernels' registers and spills, and those of every
   instantiation of the bf16 matmul loop (``mma_tile``, ``mma_reduce``),
   of the int8 kernel (``int8_mma``, ``int8_reduce``) and of the norms
   (``norm_regs``, ``norm_stream``), which must not spill.
   ``tiled_matmul`` at the six bf16 serving shapes (a decode and a mixed
   step against each weight shape), each with the grid it
   launched (tiles x K ranges) and its dynamic shared memory, a second
   run bit-equal to the first, and one split call under
   ``set_sync_debug_mode("error")``.  ``rmsnorm`` and ``layernorm`` at
   every shape of ``launch/timing.py``'s ``NORM_SHAPES`` (qwen1.5-0.5b's
   decode and mixed steps and a 16K-token prefill, qwen2-72b's mixed step
   and an 8K-token prefill, adaptor_bert, whisper-medium's encoder; D 65,
   3000 and 65536; an x one element past an aligned address), in bf16
   and f32, timed with float32 parameters and gated again with bfloat16
   ones, each with the plan it launched, after the Timer's floor (one
   launch of a 1-element fill).  The four other kernels of the kernel
   library (``ffn1``, ``ffn1_gated``, ``qkv_proj``,
   ``flash_attention``) at the full widths of qwen1.5-0.5b,
   qwen2-72b (GQA ``qkv_proj``), adaptor_bert and whisper-medium (cross
   attention over 1500 frames), in bf16 and f32; ``qkv_proj`` must equal
   three ``tiled_matmul`` launches bit for bit; the matmul rows print
   their grid and dynamic shared memory.  ``flash_attention`` also
   runs a causal qwen2-72b-width prompt (64 heads of 128) and, gated but
   not timed, two ragged head dims over 1000 keys; each flash shape
   prints its grid (CTAs, key ranges).
3. The kernel library entry point ``repro_torch.kernels.ops``: every
   function on CUDA tensors with leading batch dims, chained as one
   qwen1.5-0.5b-wide layer, each result against the plain versions; each
   of the six library kernels must launch (counts zeroed just before).
4. Full-width qwen1.5-0.5b (random weights from a fixed generator): one
   mixed step and one decode step on the paged pool through the kernels,
   through their plain versions and through the XLA-style gather path,
   with float weights over a bf16 pool and fully quantized (int8 weights,
   int8 pool).  At float32 compute the kernels' logits must agree with the
   plain versions' within 2e-2 * max|logits|, or within twice the distance
   that perturbing the plain attention outputs by 2^-19 (the kernels' own
   float32 error) makes, where that is larger: the fully quantized model
   carries last-bit changes across int8 rounding boundaries.  At bf16
   compute the distances are printed (there two valid orders of the sums
   already differ by bf16 rounding grown over 24 layers).  The plain
   versions replace every kernel, the norms included.  The PyTorch
   operators each step dispatches on the kernel path are counted, and
   again with the model's norms computed eagerly (``apply_norm`` on its
   ``"xla"`` branch, the route the norms took before they ran through
   their kernel), and both are printed.
5. Serve 8 greedy requests (prompts of 24-400 tokens, 16 new tokens each)
   through the full-width paged, chunked ``ServingEngine`` with every
   kernel selected, with float weights and fully quantized, each on a
   graphed engine (each fused program one CUDA graph, captured once) and
   an eager one: every request must finish, the graphed streams must
   equal the eager ones, ``compilations`` decode = prefill = 1 with no
   eager step, every kernel of each path must be launched in that path's
   run (the counts are zeroed just before it; a graphed drain's launches
   are the wrappers' counts less what the captures recorded plus each
   graph's capture counts times its replays) and as often as in the
   eager run, and ``rmsnorm`` 2L+1 = 49 times per fused step.  The
   graphed engine drains the mix once more on its captured graphs (warm)
   without a capture; a second fresh fully-quantized engine must repeat
   the streams.  Tokens/s, steps, captures, replays and eager steps are
   printed for every drain; the device's idle share (``torch.profiler``
   device time over wall time) and the PyTorch operators per fused step
   for a graphed engine's first drain, a warm one and an eager one.  A
   mixed step captured with ``keep_graph=True`` gives the census of its
   edges: each split ``tiled_matmul``'s reduce, a programmatic dependent
   launch, should be a programmatic edge.  The float run's steps,
   counted from its attention launches, times phase 2's per-call medians
   of the six ``tiled_matmul`` serving shapes give an estimate of the
   drain's matmul device time, printed against the same sum for
   ``torch.matmul``; the fully-quantized run's steps do the same for
   ``int8_matmul`` against the bf16 ``torch.matmul``.  Fault B's check
   (ROADMAP Queue 3): a graphed drain of each kernel path at
   ``sync_every=4`` with every fused step, the captures included, under
   ``set_sync_debug_mode("error")`` must make no host sync and wait for
   no staging buffer; the float streams must equal the sync_every=1
   drain's (the fully-quantized ones are reported: their one activation
   scale spans the rows of slots that finished but wait for a harvest).
   A plain-path engine serves the float requests and the share of
   identical tokens is reported.
6. The multi-topology fleet: one engine at ``maxima_for(qwen1.5-0.5b,
   adaptor-bert-shaped)`` (full widths: 24 layers, 16 heads of 64,
   d_model 1024, d_ff 3072, vocab 151936; random weights) serves the
   phase 5 request mix, requests alternating the members, through the
   paged kernels with ``live_kv``, over a bf16 pool on two graphed
   engines and an eager one and over an int8 pool on two graphed
   engines: every request finishes inside its member's vocab, the
   streams repeat, the graphed bf16 streams and launches equal the eager
   ones with one capture per program, ``live_kv`` launches number 24 per
   fused step, and the first bf16 drain holds fault B's check.
   Tokens/s, the table's bytes and the peak device memory are printed.
   Then one mixed and one decode step of the fabric at float32 compute,
   kernels against the gather path, within 2e-2 * max|logits|.
7. The rest of the dense family, whose embeddings are untied:
   phi3-mini-3.8b at full width and depth (32 layers, 32 heads of 96) and
   qwen2-72b at full width and 2 of its 80 layers (64 heads of 128 over 8
   kv heads), random weights: one mixed and one decode step at float32
   compute through the kernels within phase 4's gate of the plain
   versions (the untied ``lm_head``'s own float32 error is printed as a
   share of that distance), then the phase 5 request mix on a graphed
   and an eager engine with phase 5's gates, and the launches of the
   paged walks at hd 96 and at GQA 8 x hd 128.

The second line from the end is the JSON kernel table, the last line the
device summary.  Exits non-zero when no CUDA device is visible.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.spec import (ExecutionSpec, MemorySpec,  # noqa: E402
                                   RuntimeSpec, SchedulerSpec, maxima_for)
from repro_torch.core.quant import QTensor, quantize  # noqa: E402
from repro_torch.kernels import chunked_prefill as cp_mod  # noqa: E402
from repro_torch.kernels import int8_matmul as i8_mod  # noqa: E402
from repro_torch.kernels import ops, runtime  # noqa: E402
from repro_torch.kernels.counts import (LIVE_KV, launch_counts,  # noqa: E402
                                        wrappers)
from repro_torch.kernels import tiled_matmul as tm_mod  # noqa: E402
from repro_torch.kernels.chunked_prefill import (  # noqa: E402
    chunked_prefill_attention, chunked_prefill_attention_plain)
from repro_torch.kernels.ffn import (  # noqa: E402
    ffn1, ffn1_gated, ffn1_gated_plain, ffn1_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.int8_matmul import (  # noqa: E402
    int8_matmul, int8_matmul_plain)
from repro_torch.kernels import layernorm as ln_mod  # noqa: E402
from repro_torch.kernels.layernorm import (  # noqa: E402
    layernorm_plain, rmsnorm_plain)
from repro_torch.kernels.qkv_proj import qkv_proj, qkv_proj_plain  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.tiled_matmul import (  # noqa: E402
    tiled_matmul, tiled_matmul_plain)
from repro_torch.launch.timing import (  # noqa: E402
    LAYER_MATMULS, NORM_SHAPES, NORM_TOL, STEP_ROWS, Timer, bound_ms,
    norm_calls, norm_cost, norm_err, norm_operands)
from repro_torch.core import masking  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.fabric import REG_VOCAB, DecodeFabric  # noqa: E402

LOGIT_TOL = 2e-2                       # x max|logits|, bf16 reference tolerance
# relative size of the attention kernels' float32 summation-order error
# (phase 2 measures 1e-6 - 3e-6 on outputs of order 1): the perturbation
# whose effect on the logits is the floor of the phase 4 gate
ATTN_PERTURB = 2.0 ** -19
ENGINE = dict(max_batch=8, max_len=512, block_size=16, chunk=16)
PROMPT_LENS = (24, 57, 96, 150, 203, 260, 333, 400)
MAX_NEW = 16

KERNELS = wrappers()        # {kernel name: its wrapper}, the JSON's order
# the kernels each path must launch: the two serving paths and the kernel
# library entry point (``repro_torch.kernels.ops``); a kernel's JSON
# ``launches`` is its count on the first path listed with it (the
# attention kernels run on both serving paths)
PATH_KERNELS = {"float": ("tiled_matmul", "paged_decode_attention",
                          "chunked_prefill_attention", "rmsnorm"),
                "int8": ("int8_matmul", "paged_decode_attention",
                         "chunked_prefill_attention", "rmsnorm"),
                "ops": ("ffn1", "ffn1_gated", "qkv_proj", "layernorm",
                        "rmsnorm", "flash_attention"),
                # the multi-topology fleet: both with live_kv
                "fleet": ("paged_decode_attention",
                          "chunked_prefill_attention")}
SOURCES = {
    "tiled_matmul": ("src/repro_torch/csrc/tiled_matmul.cu",
                     "src/repro/kernels/tiled_matmul.py:56"),
    # the two attention entry points share the walk of split_walk.cuh
    "paged_decode_attention": ("src/repro_torch/csrc/split_walk.cuh",
                               "src/repro/kernels/paged_attention.py:179"),
    "chunked_prefill_attention": (
        "src/repro_torch/csrc/split_walk.cuh",
        "src/repro/kernels/chunked_prefill.py:173"),
    "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul.py:55"),
    "ffn1": ("src/repro_torch/csrc/ffn.cu", "src/repro/kernels/ffn.py:80"),
    "ffn1_gated": ("src/repro_torch/csrc/ffn.cu",
                   "src/repro/kernels/ffn.py:107"),
    "qkv_proj": ("src/repro_torch/csrc/qkv_proj.cu",
                 "src/repro/kernels/qkv_proj.py:75"),
    "layernorm": ("src/repro_torch/csrc/layernorm.cu",
                  "src/repro/kernels/layernorm.py:50"),
    "rmsnorm": ("src/repro_torch/csrc/layernorm.cu",
                "src/repro/kernels/layernorm.py:72"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:85"),
}
# full widths of the kernel library's shapes, from the JAX package's
# config files (kept here as constants; nothing of it is imported):
# qwen1.5-0.5b (configs/qwen1_5_0_5b.py): d_model 1024, 16 heads of 64,
#   d_ff 2816, swiglu, rmsnorm; one 128-row mixed step, one 512-token prompt
# qwen2-72b (configs/qwen2_72b.py): d_model 8192, 64 heads of 128, 8 kv
#   heads (K/V width 1024); one 512-token prompt
# adaptor_bert (configs/adaptor_bert.py, the paper's BERT-base variant):
#   d_model 768, 12 heads of 64, d_ff 3072, gelu, layernorm, sequence
#   length 64, here at batch 8 (512 rows)
# whisper-medium (configs/whisper_medium.py): 16 heads of 64 over the
#   encoder's 1500 frames (cross attention)
# each norm's JSON row: a qwen1.5-0.5b mixed step, an adaptor_bert batch
MAIN_NORM = {"rmsnorm": (128, 1024), "layernorm": (512, 768)}
QWEN = dict(rows=128, d=1024, ff=2816, heads=16, hd=64, prompt=512)
QWEN72 = dict(d=8192, kv_width=1024, heads=64, hd=128)
BERT = dict(batch=8, seq=64, d=768, ff=3072, heads=12, hd=64)
WHISPER = dict(frames=1500, heads=16, hd=64)


def print_ptxas(log: Path, source: str) -> dict[str, tuple[int, int, int]]:
    """Registers, static shared memory and spills of each kernel compiled
    from ``source``, read from the ptxas report (``-Xptxas -v``) in the
    build log; returns {kernel: (registers, smem bytes, spill bytes)}."""
    part = log.read_text().split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    names = re.findall(r"Compiling entry function '(\w+)'", part)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    plain = dict(zip(names, (n.replace("(anonymous namespace)::", "")
                             .split("(")[0] for n in plain)))
    print(f"ptxas, {source}:")
    report, name, spill = {}, None, (0, 0)
    for line in part.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = plain.get(m.group(1), m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            sm = re.search(r"(\d+) bytes smem", line)
            smem = int(sm.group(1)) if sm else 0
            print(f"  {name:<60} {m.group(1):>4} registers, {smem:>6} B "
                  f"static smem, spill stores {spill[0]} B, loads "
                  f"{spill[1]} B")
            report[name] = (int(m.group(1)), smem, sum(spill))
            name = None
    return report


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.float() - b.float()).abs()
    if not torch.isfinite(d).all():
        raise AssertionError("non-finite values in a kernel comparison")
    return float(d.max())


def flash_limit(v: torch.Tensor, plain_out: torch.Tensor) -> float:
    """The flash attention gate.  f32: 2e-5 x max|V| (order of sums).
    bf16: 2^-7 x max|V| (one rounding of the output, p rounded against
    another running max), and no more than 2^-6 x max|plain output|: over
    a long non-causal row the output is far smaller than V (about 0.2
    against 4.6 at 1500 keys), and a fault in the weights of the split
    ranges must not hide under V's scale."""
    lim = (2e-5 if v.dtype == torch.float32 else 2 ** -7) \
        * float(v.float().abs().max())
    if v.dtype != torch.float32:
        lim = min(lim, 2 ** -6 * float(plain_out.float().abs().max()))
    return lim


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def mma_grid(e: dict) -> str:
    """The launch of the shared bf16 / f32 loop just made (output tiles, K
    ranges, dynamic shared memory), recorded in ``e`` and as text."""
    tiles, splits, smem = tm_mod.launched_grid()
    e.update(ctas=tiles, splits=splits, smem_bytes=smem)
    return (f"grid {tiles} tiles x {splits} K ranges = {tiles * splits} "
            f"CTAs, {smem} B dynamic smem")


def check_matmul(timer, dev, g) -> dict:
    print("\n== tiled_matmul vs plain (C = A @ B, f32 accumulate)")
    print(f"{'M':>5} {'K':>5} {'N':>5} {'dtype':>9} {'err':>10} {'tol':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'torch_ms':>9} {'bound_ms':>9}")
    shapes = [(m, k, n, torch.bfloat16) for m in STEP_ROWS.values()
              for k, n in LAYER_MATMULS]
    shapes += [(128, 1024, 2816, torch.float32), (77, 300, 199, torch.bfloat16),
               (5, 1000, 67, torch.float32)]
    serving = {}
    for m, k, n, dt in shapes:
        a = torch.randn(m, k, generator=g, device=dev).to(dt)
        b = (torch.randn(k, n, generator=g, device=dev) / math.sqrt(k)).to(dt)
        out, ref = tiled_matmul(a, b), tiled_matmul_plain(a, b)
        e = {}
        grid = mma_grid(e)
        err = max_err(out, ref)
        # f32: summation order only; bf16: one rounding of the f32 sum
        tol = (1e-5 if dt == torch.float32 else 2 ** -7) \
            * float(ref.float().abs().max())
        if err > tol:
            raise AssertionError(f"tiled_matmul {m}x{k}x{n} {dt}: err {err} "
                                 f"> tol {tol}")
        if not torch.equal(out, tiled_matmul(a, b)):
            raise AssertionError(f"tiled_matmul {m}x{k}x{n} {dt}: a second "
                                 "run gave other bits")
        ms = timer(lambda: tiled_matmul(a, b))
        pms = timer(lambda: tiled_matmul_plain(a, b))
        lms = timer(lambda: torch.matmul(a, b))
        esz = a.element_size()
        bms, by = bound_ms((m * k + k * n + m * n) * esz, 2 * m * k * n, dt)
        print(f"{m:>5} {k:>5} {n:>5} {str(dt)[6:]:>9} {err:>10.3g} "
              f"{tol:>10.3g} {ms:>10.4f} {pms:>9.4f} {lms:>9.4f} {bms:>9.4f}"
              f"   {grid}")
        step = next((s for s, rows in STEP_ROWS.items() if rows == m), None)
        if dt == torch.bfloat16 and (k, n) in LAYER_MATMULS and step:
            serving[(m, k, n)] = dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms,
                shape=f"{step}-step M={m} K={k} N={n} bf16")
    # the wrapper never waits for the device (a split launch: workspace,
    # plan and reduce included)
    a = torch.randn(128, 1024, generator=g, device=dev).bfloat16()
    b = torch.randn(1024, 2816, generator=g, device=dev).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tiled_matmul(a, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if tm_mod.launched_grid()[1] < 2:
        raise AssertionError("tiled_matmul: the sync check took one K range")
    print(f"tiled_matmul under set_sync_debug_mode('error'): no host sync "
          f"({mma_grid({})})")
    rows = list(serving.values())
    main = next(e for e in rows if e["shape"].startswith("mixed-step M=128 "
                                                         "K=1024 N=2816"))
    return dict(main, other_shapes=[e for e in rows if e is not main],
                serving=serving)


def drain_estimate(name: str, serving: dict, layers: int, launches: dict,
                   lib_key: str, lib_name: str) -> None:
    """Print phase 2's per-call medians of kernel ``name``'s six serving
    shapes summed over the steps of a phase 5 drain, which are counted
    from its attention launches (a mixed step launches the chunk kernel
    once per layer, a decode step the decode kernel): an estimate of the
    drain's matmul device time, for the kernel, the library call under
    ``lib_key`` and the bound."""
    steps = {STEP_ROWS["mixed"]:
             launches["chunked_prefill_attention"] / layers,
             STEP_ROWS["decode"]: launches["paged_decode_attention"] / layers}
    total = {key: layers * sum(steps[m] * LAYER_MATMULS[(k, n)] * e[key]
                               for (m, k, n), e in serving.items())
             for key in ("ms", lib_key, "bound_ms")}
    n = layers * sum(LAYER_MATMULS.values()) * sum(steps.values())
    print(f"{name} per drain, an estimate (phase 2's per-call medians x "
          f"phase 5's {steps[STEP_ROWS['mixed']]:g} mixed + "
          f"{steps[STEP_ROWS['decode']]:g} decode steps x {layers} layers "
          f"= {n:g} launches; {name} launched {launches[name]}): kernel "
          f"{total['ms']:.3f} ms, {lib_name} {total[lib_key]:.3f} ms, bound "
          f"{total['bound_ms']:.3f} ms")


def i8_grid(e: dict) -> str:
    """The launch of ``int8_matmul`` just made (output tiles of BM x BN, K
    ranges, dynamic shared memory), recorded in ``e`` and as text."""
    tiles, splits, smem, bm, bn = i8_mod.launched_grid()
    e.update(ctas=tiles, splits=splits, smem_bytes=smem, bm=bm, bn=bn)
    return (f"grid {tiles} tiles of {bm}x{bn} x {splits} K ranges, {smem} B "
            "dynamic smem")


def check_int8_matmul(timer, dev, g) -> dict:
    """int8_matmul against its plain version (exact: the same integer sum
    and epilogue), gated on max_abs_err == 0: the six serving shapes in
    bf16 and f32 out, each also at every plan (BM 16 and 32, BN 32 and
    64, 1-16 K ranges) bit-equal to its planned call, ragged shapes, and
    a product whose plan splits K (also once under
    ``set_sync_debug_mode("error")``).  The library yardsticks are
    ``torch._int_mm`` (the integer product alone, without the scales),
    which refuses M <= 16 (printed, nothing is padded), and the bf16
    ``torch.matmul`` at the same shape."""
    print("\n== int8_matmul vs plain (int8 x int8 -> int32, x sx * sw[n])")
    print(f"{'M':>5} {'K':>5} {'N':>5} {'out':>9} {'err':>6} {'kernel_ms':>10} "
          f"{'plain_ms':>9} {'int_mm_ms':>10} {'bf16_mm':>9} {'bound_ms':>9}")
    bf, f32 = torch.bfloat16, torch.float32
    shapes = [(m, k, n, dt) for m in STEP_ROWS.values()
              for k, n in LAYER_MATMULS for dt in (bf, f32)]
    shapes += [(77, 300, 199, bf), (5, 1000, 67, f32), (8, 8192, 256, bf)]
    serving = {}
    for m, k, n, dt in shapes:
        qx = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        sx = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
        sw = torch.rand((1, n), generator=g, device=dev) * 0.05 + 1e-3
        run = lambda: int8_matmul(qx, sx, qw, sw, out_dtype=dt)  # noqa: E731
        plain = lambda: int8_matmul_plain(qx, sx, qw, sw, dt)  # noqa: E731
        out, e = run(), {}
        grid = i8_grid(e)
        err = max_err(out, plain())
        if err != 0:
            raise AssertionError(f"int8_matmul {m}x{k}x{n} {dt}: err {err} "
                                 "!= 0")
        step = next((s for s, rows in STEP_ROWS.items() if rows == m), None)
        serve = step is not None and (k, n) in LAYER_MATMULS
        if serve and dt == bf:
            slices = -(-k // i8_mod.K_SLICE)
            for plan in itertools.product(
                    (16, 32), (32, 64),
                    range(1, min(slices, i8_mod.MAX_SPLITS) + 1)):
                with mock.patch.object(i8_mod, "int8_plan",
                                       lambda M, K, N, p=plan: p):
                    got = int8_matmul(qx, sx, qw, sw)
                if not torch.equal(got, out):
                    raise AssertionError(f"int8_matmul {m}x{k}x{n}: plan "
                                         f"{plan} gave other bits")
        ms, pms = timer(run), timer(plain)
        try:
            torch._int_mm(qx, qw)
            lms = timer(lambda: torch._int_mm(qx, qw))
            lib = f"{lms:>10.4f}"
        except RuntimeError as exc:
            lms, lib = None, "refused"
            why = str(exc).splitlines()[0][:80]
        mm16 = None
        if serve:
            a = torch.randn(m, k, generator=g, device=dev).to(bf)
            w = (torch.randn(k, n, generator=g, device=dev)
                 / math.sqrt(k)).to(bf)
            mm16 = timer(lambda: torch.matmul(a, w))
        bms, by = bound_ms(m * k + k * n + 4 + 4 * n
                           + m * n * torch.empty((), dtype=dt).element_size(),
                           2 * m * k * n, torch.int8)
        print(f"{m:>5} {k:>5} {n:>5} {str(dt)[6:]:>9} {err:>6.3g} "
              f"{ms:>10.4f} {pms:>9.4f} {lib:>10} "
              f"{'-' if mm16 is None else f'{mm16:.4f}':>9} {bms:>9.4f}"
              f"   {grid}")
        if lms is None:
            print(f"      torch._int_mm refused M={m}: {why}")
        if serve and dt == bf:
            serving[(m, k, n)] = dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms, bf16_matmul_ms=mm16,
                shape=f"{step}-step M={m} K={k} N={n} bf16 out")
    # the wrapper never waits for the device (a split launch: workspace,
    # kernel and reduce; the last shape, 8 x 8192 x 256, splits K)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        int8_matmul(qx, sx, qw, sw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if i8_mod.launched_grid()[1] < 2:
        raise AssertionError("int8_matmul: the sync check took one K range")
    print(f"int8_matmul under set_sync_debug_mode('error'): no host sync "
          f"({i8_grid({})})")
    rows = list(serving.values())
    main = next(e for e in rows if e["shape"].startswith("mixed-step M=128 "
                                                         "K=1024 N=2816"))
    return dict(main, other_shapes=[e for e in rows if e is not main],
                serving=serving)


def paged_inputs(g, dev, B, W, h, kv, hd, q_dt, kv_dt, starts, bs=16,
                 nblk=32, live=None):
    """A pool with shuffled blocks per sequence, table entries past each
    sequence's reach at the null block, and NaN in the null block and in
    the unseen tail of each sequence's last live block (an int8 pool:
    random values, per-row scales, NaN scales there).  With ``live`` (the
    live kv groups of each sequence) also NaN in the queries of the dead
    groups and in their rows of the sequence's blocks.  Returns q, the
    pools, tables, start and the scales (None or a pair)."""
    nb = B * nblk + 1
    if kv_dt == torch.int8:
        k_pool, v_pool = (torch.randint(-127, 128, (nb, bs, kv, hd),
                                        generator=g, device=dev,
                                        dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand(nb, bs, kv, generator=g, device=dev) * 0.03
                       + 5e-3 for _ in range(2))
        poisoned = scales
    else:
        k_pool = torch.randn(nb, bs, kv, hd, generator=g, device=dev).to(kv_dt)
        v_pool = torch.randn(nb, bs, kv, hd, generator=g, device=dev).to(kv_dt)
        scales = None
        poisoned = (k_pool, v_pool)
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    tables = perm.reshape(B, nblk).to(torch.int32)
    for t in poisoned:
        t[0] = float("nan")
    for b, s in enumerate(starts):
        reach = min(s + W, nblk * bs)
        used = -(-reach // bs)
        tables[b, used:] = 0
        blk, off = int(tables[b, used - 1]), (reach - 1) % bs
        for t in poisoned:
            t[blk, off + 1:] = float("nan")
    q = torch.randn(B, W, h, hd, generator=g, device=dev).to(q_dt)
    for b, n in enumerate(live or ()):
        q[b, :, n * (h // kv):] = float("nan")
        for t in poisoned:
            t[tables[b].long(), :, n:] = float("nan")
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, tables, start, scales


def attn_case(timer, dev, g, name, q_dt, kv_dt, B, W, h, kv, hd, starts,
              label="", live=None) -> dict:
    """One paged attention kernel against its plain version on one input
    (``starts``: decode lengths less one, or the chunk's lane-0
    positions), timed beside SDPA and the bound; the grid it launched
    printed.  ``live``: the live kv groups of each sequence (``live_kv``),
    the dead groups' queries and pool rows NaN (``paged_inputs``); their
    outputs must be bit-exact zeros, also at 1 and 3 fixed key ranges,
    and the bound counts the live groups' rows alone."""
    decode = name == "paged_decode_attention"
    bs = 16
    q, kp, vp, tables, start, scales = paged_inputs(
        g, dev, B, W, h, kv, hd, q_dt, kv_dt, starts, live=live)
    sk = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
    live_t = None
    if live is not None:
        live_t = torch.tensor(live, dtype=torch.int32, device=dev)
        sk["live_kv"] = live_t
    if decode:
        q = q[:, 0].contiguous()
        lens = start + 1
        run = lambda: paged_decode_attention(  # noqa: E731
            q, kp, vp, tables, lens, **sk)
        plain = lambda: paged_decode_attention_plain(  # noqa: E731
            q, kp, vp, tables, lens, **sk)
        n_pos = [s + 1 for s in starts]
    else:
        run = lambda: chunked_prefill_attention(  # noqa: E731
            q, kp, vp, tables, start, **sk)
        plain = lambda: chunked_prefill_attention_plain(  # noqa: E731
            q, kp, vp, tables, start, **sk)
        n_pos = [min(s + W, 512) for s in starts]
    t_max = tables.shape[1] * bs
    out, ref = run(), plain()
    grid = KERNELS[name].last_grid
    # f32 out over an f32 pool: order of sums and exp only; over a bf16
    # pool p is rounded to bf16, and another order of the score sum (or
    # another running max: the chunk kernel's key ranges) can round a
    # probability a bf16 step (2^-8) the other way, which moves the output
    # by up to 2^-8 * max|V|; bf16 out: one bf16 rounding of each output,
    # a bf16 step of its own size, 2^-7 * max(|plain|, 1) per element
    # (tol prints the limit where the error comes closest to it, "of tol"
    # that closest error over its limit); f32 out over an int8 pool: the
    # f32 walk over the dequantized pool, order only
    def gate(got: torch.Tensor, what: str) -> tuple[float, float, float]:
        err = max_err(got, ref)
        if q_dt == torch.bfloat16:
            limit = 2 ** -7 * ref.float().abs().clamp_min(1)
            frac = (got.float() - ref.float()).abs() / limit
            worst = frac.flatten().argmax()
            tol = float(limit.flatten()[worst])
            frac = float(frac.flatten()[worst])
        else:
            tol = 2e-5 if kv_dt != torch.bfloat16 else \
                2 ** -8 * float(vp.float().nan_to_num().abs().max())
            frac = err / tol
        if frac > 1:
            raise AssertionError(f"{name} {label}{what} q={q_dt} "
                                 f"pool={kv_dt} h={h} kv={kv} hd={hd} "
                                 f"W={W}: err {err}, {frac} of the limit "
                                 f"{tol}")
        return err, frac, tol

    if live is not None:
        dead = cp_mod.apply_live_kv(torch.ones_like(ref), live_t, kv) == 0
        for splits in (None, 1, 3):
            with mock.patch.object(cp_mod, "kv_splits",
                                   (lambda *a, s=splits: s) if splits
                                   else cp_mod.kv_splits):
                got = run()
            if not torch.equal(got[dead], torch.zeros_like(got[dead])) \
                    or torch.signbit(got[dead]).any():
                raise AssertionError(f"{name} {label}: a dead kv group is "
                                     f"not exact zeros (splits {splits})")
            if splits:   # the live groups held to the same limit
                gate(got, f" ({splits} key ranges)")
    err, frac, tol = gate(out, "")
    pair = str(q_dt)[6:] + "/" + str(kv_dt)[6:]
    # library yardstick: SDPA on a pre-gathered, head-repeated view (an
    # int8 pool dequantized first; neither is timed)
    if scales is not None:
        kp_f = kp.float() * scales[0].nan_to_num()[..., None]
        vp_f = vp.float() * scales[1].nan_to_num()[..., None]
    else:
        kp_f, vp_f = kp.nan_to_num(), vp.nan_to_num()
    kg = kp_f[tables.long()].reshape(B, t_max, kv, hd)
    vg = vp_f[tables.long()].reshape(B, t_max, kv, hd)
    kg = kg.repeat_interleave(h // kv, dim=2).transpose(1, 2).to(q_dt)
    vg = vg.repeat_interleave(h // kv, dim=2).transpose(1, 2).to(q_dt)
    qs = q.reshape(B, W, h, hd).transpose(1, 2)
    lim = start[:, None] + torch.arange(W, device=dev)[None, :]
    mask = (torch.arange(t_max, device=dev)[None, None, :]
            <= lim[:, :, None])[:, None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qs, kg, vg, attn_mask=mask)
    if live is not None:
        # the dead groups' heads masked to zeros by torch.where
        alive = ~dead.reshape(B, W, h, hd).transpose(1, 2)
        sdpa_all = sdpa
        sdpa = lambda: torch.where(alive, sdpa_all(), 0.0)  # noqa: E731
    ms, pms, lms = timer(run), timer(plain), timer(sdpa)
    # K/V rows (and an int8 pool's scales) read once per sequence; each
    # lane's scores and PV products over the positions it sees; with
    # live_kv only the live groups' rows and heads (and live_kv itself)
    row = hd * kp.element_size() + (4 if scales is not None else 0)
    groups = live if live is not None else [kv] * B
    nbytes = (2 * sum(n * gb for n, gb in zip(n_pos, groups)) * row
              + 2 * q.numel() * q.element_size() + tables.numel() * 4
              + B * 4 + (B * 4 if live is not None else 0))
    seen = [sum(min(s + lane + 1, t_max) for lane in range(W)) for s in starts]
    # an int8 pool is attended in f32 (the reference's dequantized walk)
    bms, by = bound_ms(nbytes, 4 * sum(n * gb * (h // kv) for n, gb in
                                       zip(seen, groups)) * hd,
                       torch.float32 if kv_dt == torch.int8 else q_dt)
    print(f"{name:>26} {pair:>10} {h:>3}/{kv:<2} {err:>10.3g} {tol:>8.3g} "
          f"{ms:>10.4f} {pms:>9.4f} {lms:>9.4f} {bms:>9.4f} {frac:>7.3f} "
          f"{label}"
          + (f" grid {grid[0]} CTAs x {grid[1]} key ranges" if grid else ""))
    nums = dict(max_abs_err=err, of_tol=frac, ms=ms, plain_ms=pms,
                bound_ms=bms, bound_by=by, library_ms=lms,
                shape=f"B={B} W={W} h={h} kv={kv} hd={hd} bs=16 {pair}"
                      + (f" {label}" if label else "")
                      + (f" live_kv={live}" if live is not None else ""))
    if grid:
        nums.update(ctas=grid[0], splits=grid[1])
    return nums


# chunk lane-0 positions: the last lane reaches start + W - 1 <= 511
CHUNK_STARTS = {16: [0, 16, 48, 100, 203, 300, 400, 496],
                32: [0, 16, 48, 100, 203, 300, 400, 480]}
DECODE_LENS = [0, 16, 99, 254, 255, 299, 510, 511]


def check_attention(timer, dev, g) -> dict:
    """The paged attention kernels at the serving shape (bs=16, 32 blocks
    per slot; qwen1.5-0.5b widths) in every (q, pool) dtype pair and with
    GQA, then the head dims and GQA widths of ROADMAP Queue 3 fault A:
    phi3-mini's hd 96 (32 heads; decode and chunk) and qwen2-72b's GQA 8 x
    hd 128 (64 heads over 8; decode, and chunk at W 16 and 32).  Both
    kernels are also timed at the serving shape over fixed key-range
    counts, and one split call of each runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    print("\n== paged attention kernels vs plain (bs=16, 32 blocks/slot)")
    print(f"{'kernel':>26} {'q/pool':>10} {'h/kv':>6} {'err':>10} {'tol':>8} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'sdpa_ms':>9} {'bound_ms':>9} "
          f"{'of tol':>7}")
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    cases = [(bf, bf, 16, 16), (f32, bf, 16, 16), (f32, f32, 16, 16),
             (bf, bf, 16, 4), (f32, i8, 16, 16), (bf, i8, 16, 16)]
    entries = {}
    B, hd = 8, 64
    shape = {"paged_decode_attention": (1, DECODE_LENS),
             "chunked_prefill_attention": (ENGINE["chunk"], CHUNK_STARTS[16])}
    for name, (W, starts) in shape.items():
        for q_dt, kv_dt, h, kv in cases:
            nums = attn_case(timer, dev, g, name, q_dt, kv_dt, B, W, h, kv,
                             hd, starts)
            if (q_dt, kv_dt, h, kv) == cases[0]:
                entries[name] = dict(nums, other_shapes=[])
            elif (q_dt, kv_dt) == (bf, i8):
                entries[name]["int8_pool"] = nums
    # fault A: hd 96 (phi3-mini: 32 heads of 96, no GQA) and GQA 8 x hd 128
    # (qwen2-72b: 64 heads over 8 kv heads): decode, chunk at W 16 and 32
    print("fault A shapes (ROADMAP Queue 3):")
    qwen72 = "qwen2-72b GQA 8 x hd 128"
    for name, W, h, kv, hdf, label in (
            ("paged_decode_attention", 1, 32, 32, 96, "phi3-mini hd 96"),
            ("paged_decode_attention", 1, 64, 8, 128, qwen72),
            ("chunked_prefill_attention", 16, 32, 32, 96, "phi3-mini hd 96"),
            ("chunked_prefill_attention", 16, 64, 8, 128, f"{qwen72} W 16"),
            ("chunked_prefill_attention", 32, 64, 8, 128, f"{qwen72} W 32")):
        starts = DECODE_LENS if W == 1 else CHUNK_STARTS[W]
        for kv_dt in (bf, i8):
            nums = attn_case(timer, dev, g, name, bf, kv_dt, B, W, h, kv,
                             hdf, starts, label=label)
            entries[name]["other_shapes"].append(nums)
    # live_kv (the fleet's dead kv groups): at the fleet's shape (16 heads
    # of 64, one per kv group as the fabric packs them; groups 12-15 dead
    # on every other slot, as adaptor-bert-shaped's 12 heads leave them),
    # then at hd 96 and GQA 8 x hd 128
    print("live_kv (dead groups NaN in q and pool, outputs exact zeros; "
          "fixed key ranges 1 and 3 gated too):")
    for name, (W, starts) in shape.items():
        sub = []
        for h, kv, hdf, dead, label in (
                (16, 16, hd, 4, "fleet"),
                (32, 32, 96, 4, "phi3-mini hd 96"),
                (64, 8, 128, 2, qwen72)):
            live = [kv, kv - dead] * (B // 2)
            for kv_dt in (bf, i8):
                sub.append(attn_case(timer, dev, g, name, bf, kv_dt, B, W, h,
                                     kv, hdf, starts,
                                     label=f"live_kv {label}", live=live))
        entries[name]["live_kv"] = dict(sub[0], int8_pool=sub[1],
                                        other_shapes=sub[2:])
    # both kernels at the serving shape over fixed key-range counts; the
    # plan's own count (its wave: the walk's resident CTAs per SM from the
    # CUDA occupancy) among them
    print("fixed key-range counts at the serving shape:")
    for name, (W, starts) in shape.items():
        e = entries[name]
        e["fixed_splits"] = []
        for kv_dt, plan in ((bf, e["splits"]), (i8, e["int8_pool"]["splits"])):
            resident = cp_mod.resident_ctas(dev, bf, kv_dt, hd, 32, name)
            print(f"  {name}, pool {kv_dt}: {resident} resident CTAs per "
                  f"SM, the plan takes {plan} key ranges")
            for splits in sorted({1, 2, 3, 4, 8, plan}):
                with mock.patch.object(cp_mod, "kv_splits",
                                       lambda *a, s=splits: s):
                    nums = attn_case(timer, dev, g, name, bf, kv_dt, B, W,
                                     16, 16, hd, starts,
                                     label=f"splits={splits}")
                e["fixed_splits"].append(dict(pool=str(kv_dt)[6:],
                                              splits=splits, ms=nums["ms"]))
    # the wrappers never wait for the device (a split launch: workspace,
    # plan and merge included)
    for name, (W, starts) in shape.items():
        q, kp, vp, tables, start, _ = paged_inputs(g, dev, B, W, 16, 16, hd,
                                                   bf, bf, starts)
        args = (q[:, 0].contiguous(), kp, vp, tables, start + 1) \
            if W == 1 else (q, kp, vp, tables, start)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            KERNELS[name](*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        grid = KERNELS[name].last_grid
        if grid[1] < 2:
            raise AssertionError(f"{name}: the sync check took one key range")
        print(f"{name} under set_sync_debug_mode('error'): no host sync "
              f"(grid {grid})")
    return entries


def lib_check(timer, name: str, label: str, dt, run, plain, lib,
              nbytes: float, flops: float, peak_dt, tol: float | None,
              gate=None) -> dict:
    """One kernel of the library against its plain version: gated at
    ``tol`` x max|plain output| or, given ``gate``, at ``gate(plain
    output)``; then kernel, plain version and library call (None: no single
    PyTorch call) timed and printed beside the bound."""
    out, ref = run(), plain()
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(max_err(o, r) for o, r in zip(out, ref, strict=True))
    lim = gate(ref[0]) if gate is not None \
        else tol * max(float(r.float().abs().max()) for r in ref)
    if err > lim:
        raise AssertionError(f"{name} {label} {dt}: err {err} > tol {lim}")
    ms, pms = timer(run), timer(plain)
    lms = timer(lib) if lib is not None else None
    bms, by = bound_ms(nbytes, flops, peak_dt)
    lib_s = "none" if lms is None else f"{lms:.4f}"
    print(f"{name:>15} {label:>36} {str(dt)[6:]:>8} {err:>10.3g} "
          f"{lim:>10.3g} {ms:>10.4f} {pms:>9.4f} {lib_s:>9} "
          f"{bms:>9.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms, shape=f"{label} {str(dt)[6:]}")


def check_norms(timer, dev, g) -> dict:
    """``rmsnorm`` and ``layernorm`` against their plain versions at every
    shape of ``NORM_SHAPES`` (serving steps and prefills of qwen1.5-0.5b,
    qwen2-72b, adaptor_bert and whisper-medium; D 65, 3000 and 65536; an
    x one element past an aligned address), in bf16 and f32, timed with
    float32 parameters and gated again, untimed, with bfloat16 ones.
    Gates: ``NORM_TOL`` x max|plain| (f32 1e-5, the order of sums; bf16
    2^-7, one rounding of the f32 result).  Library yardsticks (never
    called by the port): ``F.rms_norm`` / ``F.layer_norm`` (parameters in
    x's dtype).  The Timer's floor, one launch of a 1-element fill, is
    printed first.  Each row prints the plan the wrapper launched."""
    floor = timer(torch.zeros(1, device=dev).zero_)
    print(f"\n== norms vs plain (kernels/layernorm.py's two TPU kernels); "
          f"Timer floor (one 1-element fill): {floor:.4f} ms")
    print(f"{'kernel':>15} {'shape':>36} {'dtype':>8} {'err':>10} {'tol':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'lib_ms':>9} {'bound_ms':>9}")
    rows = {"rmsnorm": [], "layernorm": []}
    for kernel, R, D, name, off in NORM_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x, params = norm_operands(g, dev, kernel, R, D, off, dt)
            run, plain, lib = norm_calls(ln_mod, kernel, x, params)
            e = lib_check(timer, kernel, f"{R}x{D} {name}", dt, run, plain,
                          lib, *norm_cost(kernel, R, D, x.element_size(), 4),
                          torch.float32, NORM_TOL[dt])
            e["plan"] = list(KERNELS[kernel].last_plan)
            # the same row with bfloat16 parameters, gated only
            run, plain, _ = norm_calls(ln_mod, kernel, x,
                                       tuple(p.bfloat16() for p in params))
            err, lim = norm_err(run(), plain())
            print(f"{'':>15} plan {e['plan']}; bf16 parameters: plan "
                  f"{list(KERNELS[kernel].last_plan)}, err {err:.3g} "
                  f"(tol {lim:.3g})")
            if err > lim:
                raise AssertionError(f"{kernel} {R}x{D} {dt} bf16 "
                                     f"parameters: err {err} > tol {lim}")
            if dt == torch.bfloat16 and off == 0 \
                    and (R, D) == MAIN_NORM[kernel]:
                rows[kernel].insert(0, e)
            else:
                rows[kernel].append(e)
            del x, params, run, plain
    return {k: dict(es[0], other_shapes=es[1:], timer_floor_ms=floor)
            for k, es in rows.items()}


def check_library(timer, dev, g) -> dict:
    """The other four kernels of the library entry point against their
    plain versions at full model widths, in bf16 and f32.  Gates: f32 at
    1e-5 x max|plain| (order of sums), bf16 at 2^-7 x max|plain| (one
    rounding of the f32 result); flash attention at ``flash_limit``;
    ``qkv_proj`` bit for bit against three ``tiled_matmul`` launches.
    Library yardsticks (never called by the port): ``torch.addmm``
    (product and bias, no activation), one ``torch.matmul`` against the
    concatenated weights, SDPA."""
    fn = torch.nn.functional
    print("\n== kernel library vs plain (kernels/ops.py's other TPU kernels)")
    print(f"{'kernel':>15} {'shape':>36} {'dtype':>8} {'err':>10} {'tol':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'lib_ms':>9} {'bound_ms':>9}")

    def rn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    entries = {}
    for dt in (torch.bfloat16, torch.float32):
        es = torch.empty((), dtype=dt).element_size()
        tol = 1e-5 if dt == torch.float32 else 2 ** -7
        main = dt == torch.bfloat16

        m, d = BERT["batch"] * BERT["seq"], BERT["d"]
        x = rn(m, d, dt=dt)

        # ffn1 relu / gelu: adaptor_bert, f32 bias
        f = BERT["ff"]
        w1 = rn(d, f, dt=dt, scale=d ** -0.5)
        b1 = 0.1 * torch.randn(f, generator=g, device=dev)
        b1_lib = b1.to(dt)
        for a in ("relu", "gelu"):
            e = lib_check(timer, "ffn1", f"{a} {m}x{d}->{f} adaptor_bert", dt,
                          lambda: ffn1(x, w1, b1, a),
                          lambda: ffn1_plain(x, w1, b1, a),
                          lambda: torch.addmm(b1_lib, x, w1),
                          (m * d + d * f + m * f) * es + f * 4, 2 * m * d * f,
                          dt, tol)
            print(f"{'':>15} {mma_grid(e)}")
            if main and a == "gelu":
                entries["ffn1"] = e

        # ffn1_gated swiglu / geglu: qwen1.5-0.5b
        m, d, f = QWEN["rows"], QWEN["d"], QWEN["ff"]
        x = rn(m, d, dt=dt)
        w1, wg = (rn(d, f, dt=dt, scale=d ** -0.5) for _ in range(2))
        w1g = torch.cat([w1, wg], dim=1)
        for a in ("swiglu", "geglu"):
            e = lib_check(timer, "ffn1_gated",
                          f"{a} {m}x{d}->2x{f} qwen1.5-0.5b", dt,
                          lambda: ffn1_gated(x, w1, wg, a),
                          lambda: ffn1_gated_plain(x, w1, wg, a),
                          lambda: torch.matmul(x, w1g),
                          (m * d + 2 * d * f + m * f) * es, 4 * m * d * f,
                          dt, tol)
            print(f"{'':>15} {mma_grid(e)}")
            if main and a == "swiglu":
                entries["ffn1_gated"] = e
        del w1, wg, w1g

        # qkv_proj: MHA at qwen1.5-0.5b, GQA at qwen2-72b (168 MB of bf16
        # weights), each bit for bit equal to three tiled_matmul launches
        for label, d, nq, nkv in (
                ("MHA qwen1.5-0.5b", QWEN["d"], QWEN["d"], QWEN["d"]),
                ("GQA qwen2-72b", QWEN72["d"], QWEN72["d"],
                 QWEN72["kv_width"])):
            x = rn(m, d, dt=dt)
            ws = [rn(d, n, dt=dt, scale=d ** -0.5) for n in (nq, nkv, nkv)]
            for o, w in zip(qkv_proj(x, *ws), ws, strict=True):
                if not torch.equal(o, tiled_matmul(x, w)):
                    raise AssertionError(f"qkv_proj {label} {dt} is not bit "
                                         "for bit three tiled_matmuls")
            wqkv = torch.cat(ws, dim=1)
            n = nq + 2 * nkv
            e = lib_check(timer, "qkv_proj",
                          f"{label} {m}x{d}->{nq}+2x{nkv}", dt,
                          lambda: qkv_proj(x, *ws),
                          lambda: qkv_proj_plain(x, *ws),
                          lambda: torch.matmul(x, wqkv),
                          (m * d + d * n + m * n) * es, 2 * m * d * n, dt,
                          tol)
            print(f"{'':>15} {mma_grid(e)}")
            if main and label.startswith("MHA"):
                entries["qkv_proj"] = e
            elif main:
                entries["qkv_proj"]["other_shapes"] = [e]
            del ws, wqkv

        # flash attention: one qwen1.5-0.5b prompt (causal), adaptor_bert
        # (non-causal), whisper-medium cross attention over 1500 frames,
        # one qwen2-72b-width prompt (causal, 64 heads of 128); the grid
        # (CTAs, key ranges) the wrapper launched beside each
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        flash = []
        for label, b, sq, skv, h, hd, causal in (
                ("causal qwen1.5-0.5b prompt", 1, QWEN["prompt"],
                 QWEN["prompt"], QWEN["heads"], QWEN["hd"], True),
                ("adaptor_bert", BERT["batch"], BERT["seq"], BERT["seq"],
                 BERT["heads"], BERT["hd"], False),
                ("cross whisper-medium", 1, 64, WHISPER["frames"],
                 WHISPER["heads"], WHISPER["hd"], False),
                ("causal qwen2-72b prompt", 1, QWEN["prompt"], QWEN["prompt"],
                 QWEN72["heads"], QWEN72["hd"], True)):
            q = rn(b, sq, h, hd, dt=dt)
            k, v = rn(b, skv, h, hd, dt=dt), rn(b, skv, h, hd, dt=dt)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            pairs = sum(min(i + 1, skv) for i in range(sq)) if causal \
                else sq * skv
            e = lib_check(
                timer, "flash_attention",
                f"{label} [{b},{sq}|{skv},{h},{hd}]", dt,
                lambda: flash_attention(q, k, v, causal=causal),
                lambda: flash_attention_plain(q, k, v, causal=causal),
                lambda: fn.scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=causal),
                (2 * b * sq + 2 * b * skv) * h * hd * es,
                4 * b * h * hd * pairs, dt, None,
                gate=lambda ref, v=v: flash_limit(v, ref))
            ctas, splits = flash_attention.last_grid
            print(f"{'':>15} grid: {ctas} CTAs x {splits} key ranges = "
                  f"{ctas * splits} CTAs on {sms} SMs")
            e.update(ctas=ctas, splits=splits)
            flash.append(e)
        # the kernel's contract beyond the timed shapes, gated only: a
        # ragged hd (80: padded to 96 in shared memory, 16-byte loads; 36:
        # element loads) over a split 1000-key walk
        for hd in (80, 36):
            q = rn(1, 64, 8, hd, dt=dt)
            k, v = rn(1, 1000, 8, hd, dt=dt), rn(1, 1000, 8, hd, dt=dt)
            want = flash_attention_plain(q, k, v, causal=False)
            err = max_err(flash_attention(q, k, v, causal=False), want)
            lim = flash_limit(v, want)
            print(f"{'flash_attention':>15} {f'ragged hd [1,64|1000,8,{hd}]':>36} "
                  f"{str(dt)[6:]:>8} {err:>10.3g} {lim:>10.3g}   (gated, "
                  f"not timed; {flash_attention.last_grid[1]} key ranges)")
            if err > lim:
                raise AssertionError(f"flash_attention ragged hd {hd} {dt}: "
                                     f"err {err} > tol {lim}")
        if main:
            entries["flash_attention"] = dict(flash[0], other_shapes=flash[1:])
        else:
            entries["flash_attention"]["f32_shapes"] = flash
    return entries


# ---------------------------------------------------------------------------
# phase 3: the kernel library entry point
# ---------------------------------------------------------------------------
def check_ops(dev, g) -> dict:
    """The kernel library entry point: every function of
    ``repro_torch.kernels.ops`` on CUDA tensors with leading batch dims,
    chained as one layer at qwen1.5-0.5b's widths over [8, 16, 1024] bf16
    (8 requests x 16 tokens; rmsnorm -> qkv_proj -> causal flash attention
    -> tiled_matmul -> residual -> layernorm -> ffn1_gated / ffn1 ->
    quantized_dense).  Each result is held against the plain versions on
    the same inputs (2^-7 x max|plain|; attention ``flash_limit``;
    ``quantized_dense`` exact).  The counts are zeroed just before and
    read just after; every kernel of the path must have launched."""
    print("\n== the kernel library entry point (repro_torch.kernels.ops): "
          f"one layer over [8, 16, {QWEN['d']}] bf16")
    for kfn in KERNELS.values():
        kfn.launches = 0
    dt, tol = torch.bfloat16, 2 ** -7
    B, S, d, f = 8, 16, QWEN["d"], QWEN["ff"]
    H, hd = QWEN["heads"], QWEN["hd"]

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    def check(name, got, want, shape, lim=None, exact=False):
        if tuple(got.shape) != shape:
            raise AssertionError(f"ops.{name}: shape {tuple(got.shape)} != "
                                 f"{shape}")
        err = max_err(got, want.reshape(got.shape))
        if lim is None:
            lim = 0.0 if exact else tol * float(want.float().abs().max())
        print(f"ops.{name:<16} {str(shape):>18} err {err:.3g} (tol {lim:.3g})")
        if err > lim:
            raise AssertionError(f"ops.{name}: err {err} > tol {lim}")

    x = rn(B, S, d)
    gam = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    bet = 0.1 * torch.randn(d, generator=g, device=dev)
    wq, wk, wv, wo = (rn(d, d, scale=d ** -0.5) for _ in range(4))
    w1, wg = rn(d, f, scale=d ** -0.5), rn(d, f, scale=d ** -0.5)
    b1 = 0.1 * torch.randn(f, generator=g, device=dev)
    qw2 = quantize(torch.randn(f, d, generator=g, device=dev) * f ** -0.5)

    h = ops.rmsnorm(x, gam)
    check("rmsnorm", h, rmsnorm_plain(flat(x), gam), (B, S, d))
    q, k, v = ops.qkv_proj(h, wq, wk, wv)
    for name, t, w in (("qkv_proj q", q, wq), ("qkv_proj k", k, wk),
                       ("qkv_proj v", v, wv)):
        check(name, t, tiled_matmul_plain(flat(h), w), (B, S, d))
    qa, ka, va = (t.reshape(B, S, H, hd) for t in (q, k, v))
    a = ops.flash_attention(qa, ka, va, causal=True)
    want = flash_attention_plain(qa, ka, va)
    check("flash_attention", a, want, (B, S, H, hd), flash_limit(va, want))
    o = ops.tiled_matmul(a.reshape(B, S, d), wo)
    check("tiled_matmul", o, tiled_matmul_plain(flat(a.reshape(B, S, d)), wo),
          (B, S, d))
    r = x + o
    n = ops.layernorm(r, gam, bet)
    check("layernorm", n, layernorm_plain(flat(r), gam, bet), (B, S, d))
    fg = ops.ffn1_gated(n, w1, wg, "swiglu")
    check("ffn1_gated", fg, ffn1_gated_plain(flat(n), w1, wg, "swiglu"),
          (B, S, f))
    f1 = ops.ffn1(n, w1, b1, "gelu")
    check("ffn1", f1, ffn1_plain(flat(n), w1, b1, "gelu"), (B, S, f))
    y = ops.quantized_dense(fg, qw2)
    qx = quantize(flat(fg), axis=None)
    check("quantized_dense", y,
          int8_matmul_plain(qx.values, qx.scale, qw2.values, qw2.scale, dt),
          (B, S, d), exact=True)
    counts = {name: kfn.launches for name, kfn in KERNELS.items()}
    print(f"launches on the ops path: {counts}")
    for name in PATH_KERNELS["ops"]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the ops path")
    return counts




# ---------------------------------------------------------------------------
# phase 4: full-width model steps, kernels vs plain path
# ---------------------------------------------------------------------------
def full_width_spec(kernels: bool, quant: bool = False,
                    arch: ArchConfig | None = None) -> RuntimeSpec:
    """The serving spec at full width (qwen1.5-0.5b unless ``arch``);
    ``quant`` serves fully quantized (int8 weights at the reference's
    default floor, int8 KV pool)."""
    impl = ("pallas", "pallas") if kernels else ("xla", "gather")
    return RuntimeSpec(
        arch=arch or get_config("qwen1.5-0.5b"),
        execution=ExecutionSpec(matmul_backend=impl[0],
                                paged_attn_impl=impl[1],
                                compute_dtype="bf16",
                                quant="int8" if quant else "none"),
        memory=MemorySpec(cache_layout="paged",
                          max_batch=ENGINE["max_batch"],
                          max_len=ENGINE["max_len"],
                          block_size=ENGINE["block_size"],
                          kv_dtype="int8" if quant else "compute"),
        scheduler=SchedulerSpec(chunk_size=ENGINE["chunk"]))


class OpCount(TorchDispatchMode):
    """Counts the PyTorch operators dispatched inside it (the host's work
    per step; the hand-written kernels' ctypes launches are not among
    them, their wrappers' output allocations are)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def eager_norms():
    """The model's norms on ``apply_norm``'s plain ``"xla"`` branch, every
    other kernel as selected."""
    apply_norm = layers_mod.apply_norm
    with mock.patch.object(layers_mod, "apply_norm",
                           lambda x, p, kind, mm: apply_norm(x, p, kind,
                                                             "xla")):
        yield


@contextlib.contextmanager
def plain_versions(perturb: float = 0.0):
    """Every kernel call of the model replaced by that kernel's plain
    PyTorch version, on the same CUDA tensors; ``perturb`` scales the
    attention outputs by (1 + perturb), a float32 error of the size the
    attention kernels' other order of sums makes."""
    def scaled(fn):
        return lambda *a, **k: fn(*a, **k) * (1.0 + perturb)
    with mock.patch.object(tm_mod, "tiled_matmul", tiled_matmul_plain), \
            mock.patch.object(i8_mod, "int8_matmul", int8_matmul_plain), \
            mock.patch.object(ln_mod, "rmsnorm", rmsnorm_plain), \
            mock.patch.object(ln_mod, "layernorm", layernorm_plain), \
            mock.patch.object(attn_mod, "paged_decode_attention",
                              scaled(paged_decode_attention_plain)), \
            mock.patch.object(attn_mod, "chunked_prefill_attention",
                              scaled(chunked_prefill_attention_plain)):
        yield


# the step paths of phase 4: (matmul backend, attention impl, context)
STEP_PATHS = {
    "kernels": (("pallas", "pallas"), contextlib.nullcontext),
    "kernels, norms eager": (("pallas", "pallas"), eager_norms),
    "plain versions": (("pallas", "pallas"), plain_versions),
    "plain, perturbed": (("pallas", "pallas"),
                         lambda: plain_versions(ATTN_PERTURB)),
    "xla + gather": (("xla", "gather"), contextlib.nullcontext)}


def unembed_exact(x: torch.Tensor, table) -> torch.Tensor:
    """``layers.unembed(x, table)`` in float64, 16384 vocab rows at a time
    (the float32 product's reference)."""
    xd = x.reshape(-1, x.shape[-1]).double()
    t = table.values.double() * table.scale.double() \
        if isinstance(table, QTensor) else table
    out = torch.cat([xd @ t[i:i + 16384].double().t()
                     for i in range(0, t.shape[0], 16384)], dim=1)
    return out.reshape(*x.shape[:-1], -1)


def check_model_steps(model: Model, dev, g, gate: bool,
                      paths=tuple(STEP_PATHS)) -> dict:
    """One mixed step (a 16-lane chunk, some slots partial) then one decode
    step, on fresh pools, along ``paths`` of ``STEP_PATHS``: the kernels,
    the kernels with the model's norms eager (``eager_norms``), the
    kernels' plain versions, those plain versions with the attention
    outputs perturbed by ``ATTN_PERTURB`` (relative), and the XLA-style
    path ``matmul_backend="xla"`` + ``paged_attn_impl="gather"`` (whose
    scores are rounded to the compute dtype before the softmax, as the
    reference's gather path does; under int8 weights it is another
    function, with no activation quantization).  Max and mean
    |difference| against the plain versions are printed, and the PyTorch
    operators each step of the kernel paths dispatches.  With ``gate``
    the kernels' max must stay within 2e-2 * max|logits|, or within twice
    the perturbed path's max where that is larger: with int8 activations
    (one per-tensor scale) a float32 last-bit difference moves values
    across rounding boundaries and grows over 24 layers, so the model's
    own sensitivity, not the kernels, sets the floor.  For a model with an
    untied ``lm_head`` the unembedding's own share of the kernels' logit
    distance is printed: the distance between its float32 product on the
    kernel path's final states and the same product in float64, over the
    kernels' distance from the plain versions.  Returns each step's
    kernels' distance and tolerance."""
    dt = str(model.compute_dtype)[6:]
    kind = "int8 weights + int8 pool" if model.quant == "int8" \
        else "float weights + bf16 pool"
    cfg = model.cfg
    print(f"\n== full-width {cfg.name} steps ({cfg.num_layers} layers), "
          f"{kind}, {dt} compute: |path - kernels' plain versions| "
          + ("(gated)" if gate else "(reported)"))
    paging = full_width_spec(True).memory.paging()
    B, W = ENGINE["max_batch"], ENGINE["chunk"]
    nblk = ENGINE["max_len"] // ENGINE["block_size"]
    tables = (torch.randperm(paging.num_blocks, generator=g, device=dev)
              .reshape(B, nblk) + 1).to(torch.int32)
    vocab = cfg.vocab_size
    toks = torch.randint(0, vocab, (B, W), generator=g, device=dev,
                         dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    n_live = torch.tensor([16, 16, 16, 16, 16, 9, 3, 1], dtype=torch.int32,
                          device=dev)
    dtoks = torch.randint(0, vocab, (B, 1), generator=g, device=dev,
                          dtype=torch.int32)
    live = torch.arange(W, device=dev)[None, :] < n_live[:, None]
    out, ops, heads = {}, {}, []
    unembed = layers_mod.unembed

    def recording(x, table):
        heads.append((x, table))
        return unembed(x, table)

    for path in paths:
        (mm, attn), ctx = STEP_PATHS[path]
        model.matmul_backend, model.paged_attn_impl = mm, attn
        cache = model.init_cache(paging)
        counts = (OpCount(), OpCount()) if path.startswith("kernels") \
            else (contextlib.nullcontext(),) * 2
        record = mock.patch.object(layers_mod, "unembed", recording) \
            if path == "kernels" else contextlib.nullcontext()
        with ctx(), record:
            with counts[0]:
                mixed = model.mixed_step(cache, toks, start, n_live, tables)
            with counts[1]:
                dec = model.decode_step(cache, dtoks, n_live.clone(), tables)
        if path.startswith("kernels"):
            ops[path] = [c.n for c in counts]
        out[path] = (mixed[live], dec)
        del cache
    model.matmul_backend, model.paged_attn_impl = "pallas", "pallas"
    print("PyTorch operators dispatched per step on the kernel path: "
          + "; ".join(f"{path}: mixed {n[0]}, decode {n[1]}"
                      for path, n in ops.items()))
    result = {}
    for i, step in enumerate(("mixed_step", "decode_step")):
        ref = out["plain versions"][i]
        floor = max_err(out["plain, perturbed"][i], ref)
        tol = max(LOGIT_TOL * float(ref.abs().max()), 2 * floor)
        line = (f"{step}: tol max({LOGIT_TOL} x max|logits|, 2 x perturbed) "
                f"= {tol:.4g}")
        for path in paths:
            if path == "plain versions":
                continue
            d = (out[path][i] - ref).abs()
            line += (f"; {path}: max {float(d.max()):.4g} "
                     f"mean {float(d.mean()):.4g}")
        print(line)
        err = max_err(out["kernels"][i], ref)
        result[step] = dict(err=err, tol=tol)
        if model.lm_head is not None:
            x, table = heads[i]
            exact = unembed_exact(x, table)
            exact = exact[live] if i == 0 else exact
            d_head = max_err(out["kernels"][i], exact)
            result[step]["lm_head"] = d_head
            print(f"  untied lm_head ({table.shape[0]} x {table.shape[1]}, "
                  f"f32 torch.matmul): its own float32 error {d_head:.4g} "
                  f"against float64 on the kernel path's final states, "
                  f"{d_head / err if err else float('nan'):.3g} of the "
                  f"kernels' distance {err:.4g}")
        if gate and err > tol:
            raise AssertionError(f"{cfg.name} {step} logits disagree: "
                                 f"{err} > {tol}")
    return result


def census_dependent_launches(params, dev, g) -> None:
    """ROADMAP Queue 1 item 7a: does a split matmul's reduce, launched as a
    programmatic dependent (``csrc/launch.cuh`` ``launch_dependent``),
    capture as a programmatic edge?  One full-width mixed step of the
    float kernel path is captured (``keep_graph=True``) and the graph's
    nodes and edges by type are read through libcuda's
    ``cuGraphGetEdges_v2``: each split ``tiled_matmul`` should give one
    programmatic edge (loop -> reduce)."""
    model = Model.from_spec(full_width_spec(True), device=dev)
    model.load_state_dict(params)
    paging = full_width_spec(True).memory.paging()
    B, W = ENGINE["max_batch"], ENGINE["chunk"]
    nblk = ENGINE["max_len"] // ENGINE["block_size"]
    tables = (torch.arange(B * nblk, device=dev).reshape(B, nblk) + 1) \
        .to(torch.int32)
    toks = torch.randint(0, model.cfg.vocab_size, (B, W), generator=g,
                         device=dev, dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    n_live = torch.full((B,), W, dtype=torch.int32, device=dev)
    cache = model.init_cache(paging)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.mixed_step(cache, toks, start, n_live, tables)
    torch.cuda.current_stream().wait_stream(side)
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        print("dependent launches under capture: torch.cuda.CUDAGraph takes "
              "no keep_graph here, so the census is not available")
        return
    before = tm_mod.tiled_matmul.launches
    with torch.cuda.graph(graph, stream=side):
        model.mixed_step(cache, toks, start, n_live, tables)
    matmuls = tm_mod.tiled_matmul.launches - before
    split = tm_mod.launched_grid()[1] > 1
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n_nodes, n_edges = ctypes.c_size_t(0), ctypes.c_size_t(0)
    get_edges = getattr(cuda, "cuGraphGetEdges_v2", None)
    if get_edges is None:
        print("dependent launches under capture: libcuda gives no "
              "cuGraphGetEdges_v2, so the census is not available")
        return
    for err in (cuda.cuGraphGetNodes(raw, None, ctypes.byref(n_nodes)),
                get_edges(raw, None, None, None, ctypes.byref(n_edges))):
        if err:
            raise AssertionError(f"the graph census failed: CUresult {err}")
    n = n_edges.value
    src, dst = (ctypes.c_void_p * n)(), (ctypes.c_void_p * n)()
    data = (ctypes.c_ubyte * (8 * n))()    # CUgraphEdgeData: 8 bytes each
    err = get_edges(raw, src, dst, data, ctypes.byref(n_edges))
    if err:
        raise AssertionError(f"cuGraphGetEdges_v2 failed: {err}")
    kinds = collections.Counter(data[8 * i + 2] for i in range(n))
    print(f"dependent launches under capture: a full-width mixed step "
          f"graph holds {n_nodes.value} nodes and {n} edges, "
          f"{kinds.get(1, 0)} programmatic and {kinds.get(0, 0)} default; "
          f"{matmuls} tiled_matmul launches captured, "
          f"{'each' if split else 'none'} split into a loop and its reduce")
    del graph, cache, model


# ---------------------------------------------------------------------------
# phase 5: the serving engine's main path
# ---------------------------------------------------------------------------
def zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in LIVE_KV:
        KERNELS[name].live_kv_launches = 0


def made_launches(eng, captured: dict, replayed: dict) -> dict[str, int]:
    """The kernel launches a drain on ``eng`` made, the counts zeroed just
    before it and ``captured`` / ``replayed`` the engine's tallies then:
    every wrapper's count (eager steps, capture warm-ups, and the launches
    each capture recorded but did not run), less what the drain's captures
    recorded, plus each graph's capture counts times its replays in the
    drain (``ServingEngine.replayed_launches``)."""
    counts = launch_counts()
    return {n: counts[n] - (eng.captured_launches[n] - captured[n])
            + (eng.replayed_launches[n] - replayed[n]) for n in counts}


def device_seconds(prof) -> float | None:
    """Device time of the kernels, copies and fills a ``torch.profiler``
    run traced, in seconds (None: it traced no device activity)."""
    us = sum(e.self_device_time_total for e in device_events(prof))
    return us / 1e6 if us else None


def device_events(prof) -> list:
    """The traced device activities (kernels, copies, fills), each name
    with its summed device time, longest first."""
    return sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)


def drain(eng, prompts, models=None, sync_every: int = 1,
          no_sync: bool = False, measure: str | None = None) -> dict:
    """Submit ``prompts`` (greedy, ``MAX_NEW`` tokens each; ``models``: the
    fleet member of each) and drain the engine; every request must finish
    with ``MAX_NEW`` tokens.  The kernel counts are zeroed just before the
    drain.  ``no_sync`` runs every fused step, captures included, under
    ``torch.cuda.set_sync_debug_mode("error")`` (ROADMAP Queue 3 fault
    B): a host sync in ``_dispatch`` raises, and no staging buffer may
    have waited.  ``measure``: "profile" traces the drain with
    ``torch.profiler`` (its device seconds), "ops" counts the PyTorch
    operators it dispatches.  Returns the streams, seconds, steps, the
    drain's share of the engine's stats, the engine's compilations and
    the launches made."""
    uids = {eng.submit(p, max_new_tokens=MAX_NEW,
                       model=0 if models is None else models[i]): i
            for i, p in enumerate(prompts)}
    dispatch = eng._dispatch

    def checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    meter = torch.profiler.profile(activities=act) if measure == "profile" \
        else OpCount() if measure == "ops" else contextlib.nullcontext()
    zero_counts()
    tallies = (collections.Counter(eng.captured_launches),
               collections.Counter(eng.replayed_launches))
    stats0 = dict(eng.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(eng, "_dispatch", checked) if no_sync \
            else contextlib.nullcontext(), meter:
        done = eng.run_to_completion(sync_every=sync_every)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(done) != len(prompts) or not all(r.done for r in done):
        raise AssertionError(f"{len(done)}/{len(prompts)} requests finished")
    streams = {uids[r.uid]: r.generated for r in done}
    if any(len(s) != MAX_NEW for s in streams.values()):
        raise AssertionError("a request stopped short of max_new_tokens")
    waits = sum(st.waits for st in eng._stages.values())
    if no_sync and waits:
        raise AssertionError(f"{waits} uploads waited for a staging buffer")
    stats = {k: v - stats0[k] for k, v in eng.stats.items()}
    out = dict(streams=streams, dt=dt, steps=stats["decode_steps"],
               stats=stats, compilations=dict(eng.compilations),
               launches=made_launches(eng, *tallies))
    if measure == "profile":
        out["device_s"] = device_seconds(meter)
        out["top"] = [(e.key, e.count, e.self_device_time_total / 1e3)
                      for e in device_events(meter)[:12]]
    elif measure == "ops":
        out["ops"] = meter.n
    return out


def serve(params, prompts, kernels: bool = True, quant: bool = False,
          graphs: bool = True, arch: ArchConfig | None = None,
          warm: bool = False, **kw) -> dict:
    """A fresh full-width engine (``graphs``: each fused program one CUDA
    graph, else eager) loads ``params`` and drains ``prompts``; ``warm``
    drains them once more on the same engine (its graphs captured) into
    ``out["warm"]``."""
    eng = ServingEngine(full_width_spec(kernels, quant, arch), device="cuda",
                        graphs=graphs)
    eng.load(params)
    out = drain(eng, prompts, **kw)
    if warm:
        out["warm"] = drain(eng, prompts, **kw)
    del eng
    return out


def drain_line(label: str, r: dict, n_tok: int) -> str:
    st = r["stats"]
    return (f"{label}: {n_tok} tokens in {r['dt']:.3f} s "
            f"({n_tok / r['dt']:.1f} tok/s), {r['steps']} fused steps; "
            f"{st['graph_captures']} captures, {st['graph_replays']} "
            f"replays, {st['eager_steps']} eager steps; compilations "
            f"decode {r['compilations']['decode']} prefill "
            f"{r['compilations']['prefill']}")


def check_graphed(label: str, runs: dict, kernels, layers: int,
                  n_tok: int) -> None:
    """Phase 5's graphed-against-eager gates on one path: both drains
    finish, the graphed streams equal the eager ones, each program was
    captured once (``compilations`` decode = prefill = 1) and no step ran
    eagerly, the launches the replays made equal the eager drain's, each
    kernel of ``kernels`` launched in both, and ``rmsnorm`` (where the
    path runs it) 2L+1 times per fused step."""
    g, e = runs["graphed"], runs["eager"]
    for mode, r in runs.items():
        print(drain_line(f"{label}, {mode}", r, n_tok))
        print(f"  launches {dict((n, c) for n, c in r['launches'].items() if c)}")
    same = sum(a == b for i in g["streams"]
               for a, b in zip(g["streams"][i], e["streams"][i]))
    print(f"  {label}: identical tokens graphed vs eager {same}/{n_tok}")
    if g["streams"] != e["streams"]:
        raise AssertionError(f"{label}: the graphed streams differ from the "
                             f"eager ones ({same}/{n_tok})")
    comp = g["compilations"]
    if comp["decode"] != 1 or comp["prefill"] != 1 \
            or g["stats"]["eager_steps"]:
        raise AssertionError(f"{label}: compilations {comp}, eager steps "
                             f"{g['stats']['eager_steps']}; want one capture "
                             "per program and no eager step")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"{label}: the graphed drain's launches "
                             f"{g['launches']} differ from the eager "
                             f"drain's {e['launches']}")
    for r in runs.values():
        for name in kernels:
            if r["launches"][name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{label} path")
        if "rmsnorm" in kernels and r["launches"]["rmsnorm"] \
                != (2 * layers + 1) * r["steps"]:
            raise AssertionError(
                f"rmsnorm launched {r['launches']['rmsnorm']} times in "
                f"{r['steps']} steps on the {label} path, not "
                f"{(2 * layers + 1) * r['steps']}")


def no_sync_line(params, prompts, quant: bool) -> dict:
    """Fault B's check on the card: a graphed kernel-path drain at
    sync_every=4 with every fused step, the captures included, under
    ``set_sync_debug_mode("error")``; it must run mixed and decode steps
    and give the sync_every=1 streams."""
    r = serve(params, prompts, quant=quant, sync_every=4, no_sync=True)
    counts = {n: r["launches"][n] for n in ("chunked_prefill_attention",
                                            "paged_decode_attention")}
    if not all(counts.values()):
        raise AssertionError(f"the sync check ran no mixed or no decode "
                             f"step: {counts}")
    mixed = counts["chunked_prefill_attention"] \
        // full_width_spec(True).arch.num_layers
    print(f"{'int8' if quant else 'float'} weights, graphed, sync_every=4, "
          f"every fused step under set_sync_debug_mode('error'): no host "
          f"sync, no staging wait; {r['steps']} steps ({mixed} mixed, "
          f"{r['stats']['graph_captures']} captures), {r['dt']:.3f} s")
    return r["streams"]


def host_and_device_line(label: str, make_engine, prompts,
                         timed: dict) -> None:
    """The device's idle share and the host's PyTorch operators per fused
    step, for a graphed engine's first drain (its two captures and their
    warm-ups included), a warm graphed engine's drain (replays only) and
    an eager drain.  Idle: 1 - the device seconds of the kernels, copies
    and fills that ``torch.profiler`` traced in a drain, over the wall
    seconds of the untimed traced drain and of the same drain untraced
    (``timed``: phase 5's drains).  Operators: ``OpCount`` over a drain."""
    counted, traced, eager = make_engine(True), make_engine(True), \
        make_engine(False)
    runs = {"graphed, first drain": timed["graphed"],
            "graphed, warm engine": timed["graphed"]["warm"],
            "eager": timed["eager"]}
    for mode, untraced in runs.items():
        o = drain(eager if mode == "eager" else counted, prompts,
                  measure="ops")
        p = drain(eager if mode == "eager" else traced, prompts,
                  measure="profile")
        if p["device_s"] is None:
            idle = "not measured (the profiler traced no device activity)"
        else:
            idle = (f"{1 - p['device_s'] / untraced['dt']:.3f} of the "
                    f"untraced drain's {untraced['dt']:.3f} s "
                    f"({p['device_s'] * 1e3:.1f} ms of device time; "
                    f"{1 - p['device_s'] / p['dt']:.3f} of the traced "
                    f"drain's {p['dt']:.3f} s)")
        print(f"{label}, {mode}: device idle {idle}; PyTorch operators "
              f"{o['ops']} over {o['steps']} fused steps = "
              f"{o['ops'] / o['steps']:.1f} per step")
        if mode == "graphed, warm engine" and p["device_s"]:
            print("  where the warm drain's device time goes (the 12 "
                  "longest by name: calls, ms, share):")
            for key, calls, ms in p["top"]:
                print(f"    {key[:90]:<90} {calls:>6} {ms:9.3f} "
                      f"{ms / (p['device_s'] * 1e3):6.1%}")


# ---------------------------------------------------------------------------
# phase 6: the multi-topology fleet
# ---------------------------------------------------------------------------
FLEET = ("qwen1.5-0.5b", "adaptor-bert-shaped")


def fleet_spec(kv_dtype: str, compute: str = "bf16") -> RuntimeSpec:
    """The fleet's spec: qwen1.5-0.5b's engine at ``maxima_for`` both
    members (512 positions), the paged kernels, float weights."""
    a, b = (get_config(n) for n in FLEET)
    return RuntimeSpec(
        arch=a, maxima=maxima_for(a, b, seq_max=ENGINE["max_len"]),
        execution=ExecutionSpec(paged_attn_impl="pallas",
                                compute_dtype=compute),
        memory=MemorySpec(cache_layout="paged",
                          max_batch=ENGINE["max_batch"],
                          max_len=ENGINE["max_len"],
                          block_size=ENGINE["block_size"],
                          kv_dtype=kv_dtype),
        scheduler=SchedulerSpec(chunk_size=ENGINE["chunk"]))


def fleet_drain(members, prompts, kv_dtype: str, graphs: bool = True,
                **kw) -> dict:
    """One fleet engine (both members added) drains the prompts, request i
    on member i % 2; every request must finish inside its member's vocab.
    Adds the table's bytes, the peak device memory above what was
    allocated before the engine and the ``live_kv`` launches to
    ``drain``'s result."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(fleet_spec(kv_dtype), max_models=len(members),
                        device="cuda", graphs=graphs)
    ids = [eng.add_model(p, c) for c, p in members]
    table_gb = DecodeFabric.table_bytes(eng.table) / 1e9
    models = [ids[i % len(ids)] for i in range(len(prompts))]
    out = drain(eng, prompts, models, **kw)
    for i, stream in out["streams"].items():
        vocab = members[models[i]][0].vocab_size
        if not all(0 <= t < vocab for t in stream):
            raise AssertionError(f"fleet request {i}: a token outside "
                                 f"member {models[i]}'s vocab {vocab}")
    out.update(table_gb=table_gb,
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
               live_kv=sum(out["launches"][f"{n}.live_kv"] for n in LIVE_KV))
    del eng
    torch.cuda.empty_cache()
    return out


def check_fleet_logits(members, dev, g) -> None:
    """One mixed step then one decode step of the full-width fabric at
    float32 compute, kernel path against gather path from the same empty
    float32 pool (slots alternate the members; chunks of 16 lanes, some
    partial): live lanes within 2e-2 * max|logits| over each slot's live
    vocab, the dead vocab lanes NEG_INF on both."""
    spec = fleet_spec("compute", "fp32")
    fab = DecodeFabric(spec.maxima, len(members), spec.arch,
                       compute_dtype=torch.float32, device=dev)
    table = fab.init_table()
    for m, (c, p) in enumerate(members):
        fab.insert_model(table, fab.pack_member(c, p), m)
    paging = spec.memory.paging()
    B, W = ENGINE["max_batch"], ENGINE["chunk"]
    nblk = ENGINE["max_len"] // ENGINE["block_size"]
    tables = (torch.randperm(paging.num_blocks, generator=g, device=dev)
              .reshape(B, nblk) + 1).to(torch.int32)
    topo = torch.tensor([fab.topo_row(members[b % 2][0], b % 2)
                         for b in range(B)], dtype=torch.int32, device=dev)
    vocab = topo[:, REG_VOCAB]
    toks = (torch.randint(0, 1 << 30, (B, W), generator=g, device=dev)
            % vocab[:, None]).to(torch.int32)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    n_live = torch.tensor([16, 16, 16, 16, 16, 9, 3, 1], dtype=torch.int32,
                          device=dev)
    out = {}
    for impl in ("pallas", "gather"):
        cache = fab.init_cache(paging)
        mixed = fab.mixed_step(table, cache, toks, start, n_live, topo,
                               tables, impl)
        dec = fab.decode_step(table, cache, toks[:, :1], n_live, topo,
                              tables, impl)
        out[impl] = (mixed, dec)
        del cache
    lanes = torch.arange(W, device=dev)[None, :] < n_live[:, None]
    vlive = torch.arange(spec.maxima.vocab, device=dev)[None, :] \
        < vocab[:, None]
    for i, step in enumerate(("mixed_step", "decode_step")):
        k, r = out["pallas"][i], out["gather"][i]
        live = (lanes if i == 0 else lanes[:, :1])[..., None] \
            & vlive[:, None, :]
        vdead = ~vlive[:, None, :].expand_as(k)
        if not ((k[vdead] == masking.NEG_INF).all()
                and (r[vdead] == masking.NEG_INF).all()):
            raise AssertionError(f"fleet {step}: a dead vocab lane is not "
                                 "NEG_INF")
        ref = r[live.expand_as(r)]
        err = max_err(k[live.expand_as(k)], ref)
        tol = LOGIT_TOL * float(ref.abs().max())
        print(f"fleet {step}, f32 compute, kernels vs gather: max "
              f"|diff| {err:.4g} (tol {LOGIT_TOL} x max|logits| = "
              f"{tol:.4g})")
        if err > tol:
            raise AssertionError(f"fleet {step} logits disagree: {err} > "
                                 f"{tol}")
    del table, fab


def check_fleet(dev, g, lengths) -> dict:
    """The full-width fleet: qwen1.5-0.5b and adaptor-bert-shaped (random
    weights from the generator) drain the phase 5 request mix, request i
    on member i % 2, over a bf16 pool on two graphed engines (the first at
    sync_every=4 with every fused step under
    ``set_sync_debug_mode("error")``) and an eager one, and over an int8
    pool on two graphed engines: the streams repeat, the graphed bf16
    streams equal the eager ones with one capture per program and the
    same launches, and every fleet step launches one attention kernel per
    layer with ``live_kv``, 24 a step.  Then the kernel-path logits
    against the gather path's at f32 compute.  Returns the first bf16
    drain's launches."""
    members = [(c, Model(c, device=dev).init(g).state_dict())
               for c in (get_config(n) for n in FLEET)]
    maxima = fleet_spec("compute").maxima
    print(f"\n== fleet: {' + '.join(FLEET)} in one engine, maxima heads "
          f"{maxima.heads_max} layers {maxima.layers_enc_max} d_model "
          f"{maxima.d_model_max} d_ff {maxima.d_ff_max} vocab "
          f"{maxima.vocab}; {len(lengths)} greedy requests x {MAX_NEW} new "
          "tokens, alternating members")
    rs = np.random.default_rng(1)
    prompts = [rs.integers(0, members[i % 2][0].vocab_size, n).tolist()
               for i, n in enumerate(lengths)]
    n_tok = len(prompts) * MAX_NEW
    first = None
    for kv_dtype in ("compute", "int8"):
        bf16 = kv_dtype == "compute"
        runs = [fleet_drain(members, prompts, kv_dtype,
                            **(dict(sync_every=4, no_sync=True)
                               if bf16 and i == 0 else {}))
                for i in range(2)]
        if bf16:
            runs.append(fleet_drain(members, prompts, kv_dtype,
                                    graphs=False))
        pool = "bf16" if bf16 else "int8"
        for i, r in enumerate(runs):
            want = maxima.layers_enc_max * r["steps"]
            mode = "eager" if i == 2 else "graphed"
            print(drain_line(f"fleet, {pool} pool, engine {i + 1} ({mode})",
                             r, n_tok)
                  + f"; live_kv launches {r['live_kv']} "
                  f"({maxima.layers_enc_max} x steps = {want}), decode "
                  f"{r['launches']['paged_decode_attention']} + chunk "
                  f"{r['launches']['chunked_prefill_attention']}; table "
                  f"{r['table_gb']:.3f} GB, peak {r['peak_gb']:.3f} GB "
                  "allocated above the members' weights"
                  + (" (sync_every=4, every step under "
                     "set_sync_debug_mode('error'): no host sync)"
                     if bf16 and i == 0 else ""))
            if r["live_kv"] != want:
                raise AssertionError(f"fleet live_kv launches {r['live_kv']}"
                                     f" != {want}: one per layer and step")
        same = sum(a == b for k in runs[0]["streams"]
                   for a, b in zip(runs[0]["streams"][k],
                                   runs[1]["streams"][k]))
        print(f"fleet, {pool} pool: identical tokens on the two graphed "
              f"engines {same}/{n_tok}")
        if runs[0]["streams"] != runs[1]["streams"]:
            raise AssertionError(f"the fleet's {pool}-pool streams differ "
                                 "between two fresh engines")
        if bf16:
            check_graphed("fleet, bf16 pool",
                          {"graphed": runs[1], "eager": runs[2]},
                          PATH_KERNELS["fleet"], maxima.layers_enc_max,
                          n_tok)
        first = first or runs[0]
    check_fleet_logits(members, dev, g)
    del members
    torch.cuda.empty_cache()
    return first["launches"]


# ---------------------------------------------------------------------------
# phase 7: the rest of the dense family (untied lm_head)
# ---------------------------------------------------------------------------
# (config, depth it runs at): phi3-mini at its full 32 layers; qwen2-72b
# at full width and 2 of its 80 layers (one card: ~1.76 G parameters of
# layers, ~7 GB at f32 compute, beside two f32 [152064, 8192] tables of
# 5 GB each).  codeqwen1.5-7b runs only in the CPU tests.
DENSE_FAMILY = (("phi3-mini-3.8b", None), ("qwen2-72b", 2))


def check_dense_family(dev, g, lengths) -> dict:
    """Each untied config at full width with random weights from the
    generator: one mixed and one decode step at f32 compute, the kernels
    against their plain versions within phase 4's gate (with the untied
    ``lm_head``'s share of the distance); then the phase 5 request mix
    drained by a graphed and an eager bf16 engine through the kernels:
    streams equal, one capture per program, launches equal, ``rmsnorm``
    2L+1 a step.  Prints the launches of the paged walks at the config's
    head shape (phi3-mini: 32 heads of 96; qwen2-72b: 64 of 128 over 8
    kv heads).  Returns {config: the graphed drain's launches}."""
    out = {}
    for name, depth in DENSE_FAMILY:
        cfg = get_config(name)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        hd, rep = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
        params = Model(cfg, device=dev).init(g).state_dict()
        n_params = sum(t.numel() for t in params.values())
        print(f"\n== dense family: {name} at full width, {cfg.num_layers} "
              f"of {get_config(name).num_layers} layers, {n_params / 1e9:.3f}"
              f" G parameters, {cfg.num_heads} heads of {hd} over "
              f"{cfg.num_kv_heads} kv heads (GQA {rep}), untied lm_head")
        zero_counts()
        model32 = Model(cfg, compute_dtype=torch.float32, device=dev)
        model32.load_state_dict(params)
        check_model_steps(model32, dev, g, gate=True,
                          paths=("kernels", "plain versions",
                                 "plain, perturbed"))
        steps_walks = {n: KERNELS[n].launches for n in (
            "paged_decode_attention", "chunked_prefill_attention")}
        del model32
        torch.cuda.empty_cache()
        rs = np.random.default_rng(2)
        prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
                   for n in lengths]
        n_tok = len(prompts) * MAX_NEW
        runs = {mode: serve(params, prompts, graphs=mode == "graphed",
                            arch=cfg) for mode in ("graphed", "eager")}
        check_graphed(name, runs, PATH_KERNELS["float"], cfg.num_layers,
                      n_tok)
        walks = {n: steps_walks[n] + runs["graphed"]["launches"][n]
                 for n in steps_walks}
        print(f"{name}: the paged walks at {cfg.num_heads} heads of {hd} "
              f"(GQA {rep}) launched decode {walks['paged_decode_attention']}"
              f", chunk {walks['chunked_prefill_attention']} times (the f32 "
              f"steps and the graphed drain)")
        out[name] = runs["graphed"]["launches"]
        del params, runs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = runtime.build()
    runtime.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({lib.parent / 'build.log'})")
    print_ptxas(lib.parent / "build.log", "flash_attention.cu")
    print_ptxas(lib.parent / "build.log", "chunked_prefill.cu")
    print_ptxas(lib.parent / "build.log", "paged_attention.cu")
    # the bf16 main loop (mma_tile, dynamic shared memory) and its reduce,
    # in each of the four wrappers' instantiations, the int8 kernel and
    # its reduce, and every instantiation of the norms: no spills
    for src, kern in (("tiled_matmul.cu", "mma_"), ("ffn.cu", "mma_"),
                      ("qkv_proj.cu", "mma_"), ("int8_matmul.cu", "int8_"),
                      ("layernorm.cu", "norm_")):
        spills = {k: v for k, v in
                  print_ptxas(lib.parent / "build.log", src).items()
                  if kern in k and v[2]}
        if spills:
            raise AssertionError(f"{src}: {kern}* instantiations spill: "
                                 f"{spills}")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    timer = Timer(dev)

    entries = {"tiled_matmul": check_matmul(timer, dev, g),
               "int8_matmul": check_int8_matmul(timer, dev, g)}
    entries.update(check_attention(timer, dev, g))
    entries.update(check_norms(timer, dev, g))
    entries.update(check_library(timer, dev, g))
    launches = {"ops": check_ops(dev, g)}

    model = Model.from_spec(full_width_spec(True), device=dev).init(g)
    params = model.state_dict()
    # gated at float32 compute: at bf16 any two valid orders of the sums
    # (the XLA-style path included) already differ by bf16 rounding that
    # grows over 24 layers, so the bf16 distances are printed beside it.
    # The fully quantized models take the same float weights, quantized as
    # they load.
    for quant in (False, True):
        qkw = dict(quant="int8", kv_dtype="int8") if quant else {}
        model32 = Model(model.cfg, compute_dtype=torch.float32, device=dev,
                        **qkw)
        model32.load_state_dict(params)
        check_model_steps(model32, dev, g, gate=True)
        del model32
        m16 = Model.from_spec(full_width_spec(True, quant), device=dev)
        m16.load_state_dict(params)
        check_model_steps(m16, dev, g, gate=False)
        del m16

    print("\n== serving: full-width qwen1.5-0.5b, paged + chunked, "
          f"{len(PROMPT_LENS)} greedy requests x {MAX_NEW} new tokens, "
          "each fused program one CUDA graph (graphed) and eager")
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, model.cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    layers = model.cfg.num_layers
    del model
    n_tok = len(prompts) * MAX_NEW
    streams, timed = {}, {}
    for path in ("float", "int8"):
        quant = path == "int8"
        timed[path] = {mode: serve(params, prompts, quant=quant,
                                   graphs=mode == "graphed",
                                   warm=mode == "graphed")
                       for mode in ("graphed", "eager")}
        check_graphed(f"kernels, {path} weights", timed[path],
                      PATH_KERNELS[path], layers, n_tok)
        # the same engine drains the mix again on its captured graphs
        cold, warm = timed[path]["graphed"], timed[path]["graphed"]["warm"]
        same = sum(a == b for i in warm["streams"]
                   for a, b in zip(warm["streams"][i], cold["streams"][i]))
        print(drain_line(f"kernels, {path} weights, graphed, warm engine "
                         "(a second drain)", warm, n_tok)
              + f"; identical tokens to the first drain {same}/{n_tok}"
              + ("" if path == "float" else " (reported, not gated: idle "
                 "slots' stale rows join the int8 activation scale)"))
        if warm["compilations"] != cold["compilations"] \
                or warm["stats"]["graph_captures"] \
                or warm["launches"] != cold["launches"]:
            raise AssertionError(
                f"kernels, {path} weights: the warm drain captured again "
                f"({warm['compilations']}, {warm['stats']}) or launched "
                f"otherwise ({warm['launches']})")
        if path == "float" and warm["streams"] != cold["streams"]:
            raise AssertionError("the warm float drain's streams differ")
        streams[path] = timed[path]["graphed"]["streams"]
        launches[path] = timed[path]["graphed"]["launches"]
    # fault B: no fused step waits for the device (sync_every=4), captures
    # included.  The float streams are those of the sync_every=1 drain
    # (rows are computed independently); the fully-quantized ones are
    # reported: one int8 activation scale spans all B x W rows, finished
    # slots' rows among them, and at sync_every=4 a finished slot waits up
    # to 3 steps for its harvest
    for path in ("float", "int8"):
        got = no_sync_line(params, prompts, path == "int8")
        same = sum(a == b for i in got
                   for a, b in zip(got[i], streams[path][i]))
        print(f"  identical tokens to the sync_every=1 drain: {same}/{n_tok}"
              + ("" if path == "float" else " (reported, not gated)"))
        if path == "float" and got != streams[path]:
            raise AssertionError("the float streams at sync_every=4 differ "
                                 "from those at sync_every=1")
    # the fully-quantized streams must repeat on a fresh engine: duplicate
    # pool writes of dead lanes (int8 values and scales) resolve to one row
    again = serve(params, prompts, quant=True)
    same = sum(a == b for i in again["streams"]
               for a, b in zip(streams["int8"][i], again["streams"][i]))
    print(f"kernels, int8 weights, a second fresh graphed engine: {n_tok} "
          f"tokens in {again['dt']:.3f} s; identical tokens to the first: "
          f"{same}/{n_tok}")
    if again["streams"] != streams["int8"]:
        raise AssertionError("the fully-quantized streams differ between "
                             f"two fresh engines ({same}/{n_tok} equal)")
    for path in ("float", "int8"):
        quant = path == "int8"

        def make_engine(graphs, quant=quant):
            eng = ServingEngine(full_width_spec(True, quant), device="cuda",
                                graphs=graphs)
            eng.load(params)
            return eng
        host_and_device_line(f"kernels, {path} weights", make_engine,
                             prompts, timed[path])
    census_dependent_launches(params, dev, g)
    drain_estimate("tiled_matmul", entries["tiled_matmul"]["serving"],
                   layers, launches["float"], "library_ms", "torch.matmul")
    drain_estimate("int8_matmul", entries["int8_matmul"]["serving"], layers,
                   launches["int8"], "bf16_matmul_ms", "bf16 torch.matmul")
    plain = serve(params, prompts, kernels=False)
    print(drain_line("plain, float weights", plain, n_tok))
    for other, s_other in (("plain float", plain["streams"]),
                           ("kernels int8", streams["int8"])):
        same = sum(a == b for i in s_other
                   for a, b in zip(streams["float"][i], s_other[i]))
        print(f"identical tokens kernels float vs {other}: {same}/{n_tok} "
              "(reported, not gated: near-ties and quantization may flip)")
    del params
    torch.cuda.empty_cache()

    launches["fleet"] = check_fleet(dev, g, PROMPT_LENS)
    for name in PATH_KERNELS["fleet"]:
        if launches["fleet"][name] <= 0:
            raise AssertionError(f"{name} was not launched on the fleet path")
        entries[name]["live_kv"]["launches"] = launches["fleet"][name]

    launches.update(check_dense_family(dev, g, PROMPT_LENS))

    table = []
    for name in KERNELS:
        src, replaces = SOURCES[name]
        e = entries[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": next(launches[p][name] for p in PATH_KERNELS
                                if name in PATH_KERNELS[p]),
               "launches_by_path": {p: launches[p][name] for p in launches},
               "max_abs_err": e["max_abs_err"], "ms": e["ms"],
               "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
               "bound_by": e["bound_by"], "library_ms": e["library_ms"],
               "shape": e["shape"]}
        for extra in ("int8_pool", "live_kv", "ctas", "splits", "smem_bytes",
                      "bm", "bn",
                      "bf16_matmul_ms", "other_shapes", "f32_shapes",
                      "fixed_splits", "plan", "timer_floor_ms"):
            if extra in e:
                row[extra] = e[extra]
        table.append(row)
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
