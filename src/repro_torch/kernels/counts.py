"""Every kernel wrapper's launch counts, read in one place.

Each wrapper adds one to its ``launches`` where it launches its kernel
(and the paged attention wrappers one to ``live_kv_launches`` for a call
with ``live_kv``).  Under CUDA graph capture a wrapper runs once and
records its launch into the graph, which later replays it without
calling the wrapper.  The serving engine reads ``launch_counts()`` around
each capture, so it knows each graph's launches per wrapper, and adds
them up per replay (``ServingEngine.replayed_launches``).
"""
from __future__ import annotations

from repro_torch.kernels import chunked_prefill as _cp
from repro_torch.kernels import ffn as _ffn
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _i8
from repro_torch.kernels import layernorm as _ln
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import qkv_proj as _qkv
from repro_torch.kernels import tiled_matmul as _tm

# the wrappers carrying a ``live_kv_launches`` count beside ``launches``
LIVE_KV = ("paged_decode_attention", "chunked_prefill_attention")


def wrappers() -> dict:
    """{kernel name: its wrapper}, read from the modules at call time."""
    return {"tiled_matmul": _tm.tiled_matmul,
            "paged_decode_attention": _pa.paged_decode_attention,
            "chunked_prefill_attention": _cp.chunked_prefill_attention,
            "int8_matmul": _i8.int8_matmul,
            "ffn1": _ffn.ffn1, "ffn1_gated": _ffn.ffn1_gated,
            "qkv_proj": _qkv.qkv_proj, "layernorm": _ln.layernorm,
            "rmsnorm": _ln.rmsnorm,
            "flash_attention": _fa.flash_attention}


def launch_counts() -> dict[str, int]:
    """Every wrapper's ``launches``, and ``<name>.live_kv`` for the
    ``live_kv_launches`` of the paged attention wrappers (0 for a name
    whose wrapper is patched out by its plain version)."""
    fns = wrappers()
    out = {name: getattr(fn, "launches", 0) for name, fn in fns.items()}
    out.update({f"{name}.live_kv": getattr(fns[name], "live_kv_launches", 0)
                for name in LIVE_KV})
    return out
