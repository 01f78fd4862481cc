"""Every kernel wrapper's launch counts, read in one place.

Each wrapper adds one to its ``launches`` where it launches its kernel
(and the paged attention wrappers one to ``live_kv_launches`` for a call
with ``live_kv``).  Under CUDA graph capture a wrapper runs once and
records its launch into the graph, which later replays it without
calling the wrapper.  The serving engine reads ``launch_counts()`` around
each capture, so it knows each graph's launches per wrapper, and adds
them up per replay (``ServingEngine.replayed_launches``).

``program_launches`` gives what one call of a model's program launches
under the hand-written kernels: a fused step over the paged pool or the
dense layout, or a bucketed B = 1 prefill, whose products take the
bucket's rows.
"""
from __future__ import annotations

from repro_torch.kernels import chunked_prefill as _cp
from repro_torch.kernels import ffn as _ffn
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _i8
from repro_torch.kernels import layernorm as _ln
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import qkv_proj as _qkv
from repro_torch.kernels import rglru_scan as _scan
from repro_torch.kernels import ssm_scan as _sscan
from repro_torch.kernels import tiled_matmul as _tm

# the wrappers carrying a ``live_kv_launches`` count beside ``launches``
LIVE_KV = ("paged_decode_attention", "chunked_prefill_attention")
# the programs of ``program_launches``
PROGRAMS = ("decode", "mixed", "prefill")


def wrappers() -> dict:
    """{kernel name: its wrapper}, read from the modules at call time."""
    return {"tiled_matmul": _tm.tiled_matmul,
            "paged_decode_attention": _pa.paged_decode_attention,
            "chunked_prefill_attention": _cp.chunked_prefill_attention,
            "int8_matmul": _i8.int8_matmul,
            "ffn1": _ffn.ffn1, "ffn1_gated": _ffn.ffn1_gated,
            "qkv_proj": _qkv.qkv_proj, "layernorm": _ln.layernorm,
            "rmsnorm": _ln.rmsnorm,
            "flash_attention": _fa.flash_attention,
            "rglru_scan": _scan.rglru_scan,
            "ssm_scan": _sscan.ssm_scan}


def launch_counts() -> dict[str, int]:
    """Every wrapper's ``launches``, and ``<name>.live_kv`` for the
    ``live_kv_launches`` of the paged attention wrappers (0 for a name
    whose wrapper is patched out by its plain version)."""
    fns = wrappers()
    out = {name: getattr(fn, "launches", 0) for name, fn in fns.items()}
    out.update({f"{name}.live_kv": getattr(fns[name], "live_kv_launches", 0)
                for name in LIVE_KV})
    return out


def program_launches(cfg, program: str, *, layout: str = "paged",
                     quant: bool = False) -> dict[str, int]:
    """The hand-written kernels' launches per call of ``program`` ("decode"
    | "mixed" | "prefill", one of ``PROGRAMS``) of a ``models.model.Model``
    of ``cfg`` under ``matmul_backend="pallas"`` and
    ``paged_attn_impl="pallas"``.

    Every layer's projections go through one matmul launch each (the
    ``int8_matmul`` under ``quant``, which assumes every projection's leaf
    is quantized, as at the served full widths; else ``tiled_matmul``):
    wq, wk, wv, wo and the FFN's w1, (wg,) w2 in a dense or vlm layer; an
    MoE layer's attention projections and its shared expert's (the routed
    experts are ``torch.bmm``); MLA's q_down, q_up, kv_down and wo, plus
    k_up and v_up in a prefill (the steps' absorbed attend contracts them
    as einsums).  ``rmsnorm``: ln1 and ln2 of every layer (MLA's q_norm
    and kv_norm too) and the final norm.  Attention walks: a GQA layer's
    decode step over the paged pool one ``paged_decode_attention``, its
    mixed step one ``chunked_prefill_attention``; none over the dense
    layout, in a prefill (plain attention, as the reference's XLA) or with
    MLA (the gather view, as the reference).

    A hybrid model (``cfg.hybrid``, dense layout and prefill or decode
    only) has two kinds of layer: an RG-LRU layer's in_x, in_gate and out
    and its FFN's products, a local-attention layer's wq, wk, wv, wo and
    its FFN's, each layer's ln1 and ln2, and a prefill's one
    ``rglru_scan`` per RG-LRU layer (decode updates h elementwise, as the
    reference); its local attention is plain PyTorch, as the reference's
    is XLA.

    An ssm model (``cfg.ssm``, dense layout and prefill or decode only)
    has no attention and no FFN: a layer's in_proj, x_proj, dt_proj and
    out_proj, its one norm, and a prefill's one ``ssm_scan`` (decode
    updates h elementwise, as the reference); plus the final norm.

    An audio model (``cfg.encdec``, dense layout and prefill or decode
    only) counts ``layernorm`` in place of ``rmsnorm``.  Its prefill runs
    the encoder (a layer's wq, wk, wv, wo, w1 and w2, its ln1 and ln2,
    then the final norm) and every decoder layer's self-attention
    projections, the cross-attention's wq and wo and its wk and wv over
    the encoder's rows, w1 and w2, and its ln1, ln_cross and ln2, then the
    final norm: 384 products and 122 norms at 24 + 24 layers.  A decode
    step reads the cross K/V from the cache: 8 products and 3 norms a
    decoder layer, plus the final norm (192 and 73).  The attends are
    plain PyTorch, as the reference's are XLA."""
    if program not in PROGRAMS:
        raise ValueError(f"program={program!r} is not one of {PROGRAMS}")
    L = cfg.num_layers
    gated = cfg.activation in ("swiglu", "geglu")
    ffn = 3 if gated else 2
    none = {"paged_decode_attention": 0, "chunked_prefill_attention": 0}
    if cfg.ssm is not None:
        return {"tiled_matmul": 0 if quant else 4 * L,
                "int8_matmul": 4 * L if quant else 0,
                "rmsnorm": L + 1, **none, "rglru_scan": 0,
                "ssm_scan": L if program == "prefill" else 0}
    if cfg.hybrid is not None:
        pat = cfg.hybrid.pattern
        rec = sum(pat[i % len(pat)] == "r" for i in range(L))
        mm = (3 + ffn) * rec + (4 + ffn) * (L - rec)
        return {"tiled_matmul": 0 if quant else mm,
                "int8_matmul": mm if quant else 0,
                "rmsnorm": 2 * L + 1, **none,
                "rglru_scan": rec if program == "prefill" else 0,
                "ssm_scan": 0}
    if cfg.encdec is not None:
        enc = cfg.encdec.num_encoder_layers if program == "prefill" else 0
        mm = (4 + ffn) * enc + (10 if program == "prefill" else 8) * L
        return {"tiled_matmul": 0 if quant else mm,
                "int8_matmul": mm if quant else 0, "rmsnorm": 0,
                "layernorm": (2 * enc + 1 if enc else 0) + 3 * L + 1,
                **none, "rglru_scan": 0, "ssm_scan": 0}
    k = cfg.moe.first_k_dense if cfg.moe is not None else 0
    if cfg.mla is not None:
        attn = 4 + (2 if program == "prefill" else 0)
    else:
        attn = 4
    if cfg.moe is not None:
        shared = ffn if cfg.moe.num_shared_experts else 0
        mm = attn * L + ffn * k + shared * (L - k)
    else:
        mm = (attn + ffn) * L
    norms = (4 if cfg.mla is not None else 2) * L + 1
    walk = L if (layout == "paged" and cfg.mla is None
                 and program != "prefill") else 0
    return {"tiled_matmul": 0 if quant else mm,
            "int8_matmul": mm if quant else 0,
            "rmsnorm": norms,
            "paged_decode_attention": walk if program == "decode" else 0,
            "chunked_prefill_attention": walk if program == "mixed" else 0,
            "rglru_scan": 0, "ssm_scan": 0}
