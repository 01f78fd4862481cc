"""Register-driven multi-topology decode fabric (the port of the
reference's ``serving/fabric.py``).

A padded maximal GQA causal LM whose decode and mixed steps run at
``Maxima`` shapes and serve a fleet of models: every batch slot may run a
different topology (heads, layers, d_model, d_ff, vocab) and a different
weight set, selected by register data.

* **model table**: every fleet member's weights are packed (KV heads
  replicated to the full head count, then zero-padded to the maxima) into
  row ``m`` of a ``[max_models, ...]`` table of device tensors.  Loading a
  model is a copy into its row.
* **topology registers**: a ``[B, N_REGS]`` int32 tensor rides in the
  engine's ``SlotState``; column ``REG_MODEL`` picks the table row, the
  rest are the live extents.  ``core.masking``'s per-slot variants keep
  dead lanes (heads, layers, d_model, d_ff, vocab) out of live compute.
* **structural template**: norm kind, activation, RoPE theta and the head
  dim are fixed when the fabric is built; ``check_member`` rejects models
  that would need another fabric.

Both cache layouts work, as in the reference: the paged pool and the dense
rows ``[L, B, max_len + 1, H, hd]`` (row ``max_len`` the spare that takes
the writes of dead lanes, see ``models/attention.py``), and ``prefill``
serves a fleet's bucketed admission (B = 1, one request).  The table holds
float weights or, under
``quant="int8"``, an int8 weight table: the planned leaves (``_quant_names``,
decided on the maxima-padded sizes) hold int8 values with float32 scales
per (layer, output column) for the kernels and per row for ``embed`` and
``lm_head`` (``QTensor`` leaves), dequantized into each product as the
reference's einsum takes them.  Under ``paged_attn_impl="pallas"`` attention
runs through the hand-written paged kernels with ``live_kv`` = the slot's
live heads: KV heads are replicated to the head count, so each head is its
own kv group and the padded heads' outputs are exact zeros.  The per-slot
products (``_mm``) are batched ``torch.bmm`` in float32, as the reference
leaves its einsum to XLA; the norms are the plain masked ones.  The pool
and the table are updated in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import (DEFAULT_COMPUTE_DTYPE,
                                      DEFAULT_PARAM_DTYPE, ArchConfig)
from repro_torch.core import masking
from repro_torch.core.kv_quant import CacheCodec, cache_put, gather_view
from repro_torch.core.paging import PagingConfig
from repro_torch.core.quant import DEFAULT_QUANT_MIN_SIZE, QTensor
from repro_torch.core.registers import Maxima
from repro_torch.core.serve_quant import quantize_leaf
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.attention import (KVCache, dense_write_slot,
                                         padded_store, paged_write_slot)
from repro_torch.models.layers import activate, apply_rope, is_gated

# Topology register columns (the per-slot register file).
REG_MODEL, REG_HEADS, REG_LAYERS, REG_DMODEL, REG_DFF, REG_VOCAB = range(6)
N_REGS = 6


@dataclasses.dataclass(frozen=True)
class FabricTemplate:
    """Structural choices fixed when the fabric is built: every fleet
    member must match them (they change the step, not register data)."""

    norm: str            # "rmsnorm" | "layernorm"
    activation: str      # swiglu | geglu | gelu | relu
    rope_theta: float
    head_dim: int        # the lane width; fixed across the fleet

    @classmethod
    def of(cls, arch: ArchConfig) -> "FabricTemplate":
        return cls(norm=arch.norm, activation=arch.activation,
                   rope_theta=arch.rope_theta,
                   head_dim=arch.resolved_head_dim)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure; a
    ``QTensor`` is two leaves, its values and its scales."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], QTensor):
        return QTensor(*(fn(*leaves) for leaves in zip(*trees)))
    return fn(*trees)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict (the fabric's weight table), a
    ``QTensor``'s values and scales included."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, QTensor):
        return list(tree)
    return [tree]


class DecodeFabric:
    """One decode / mixed step pair serving any dense-family topology
    within ``maxima`` from a ``max_models``-row weight table on
    ``device`` (the CUDA device unless ``device="cpu"``)."""

    def __init__(self, maxima: Maxima, max_models: int,
                 template: FabricTemplate | ArchConfig,
                 compute_dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE,
                 param_dtype: torch.dtype = DEFAULT_PARAM_DTYPE,
                 quant: str = "none",
                 quant_min_size: int = DEFAULT_QUANT_MIN_SIZE,
                 kv_dtype: str = "compute", device=None):
        if isinstance(template, ArchConfig):
            template = FabricTemplate.of(template)
        if template.head_dim != maxima.head_dim_max:
            raise ValueError(
                f"fabric head_dim {template.head_dim} != maxima.head_dim_max "
                f"{maxima.head_dim_max}: the lane width is fixed at "
                "synthesis (RoPE pairs by head_dim, so it cannot be a "
                "runtime register); synthesize at the fleet's common "
                "head_dim")
        if quant not in ("none", "int8"):
            raise ValueError(f"DecodeFabric quant={quant!r} is not one of "
                             "('none', 'int8')")
        self.mx = maxima
        self.max_models = max_models
        self.template = template
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.quant = quant
        self.quant_min_size = quant_min_size
        self.codec = CacheCodec(kv_dtype)
        self.hd = template.head_dim
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # Fleet membership
    # ------------------------------------------------------------------
    def check_member(self, arch: ArchConfig) -> None:
        """Reject models this fabric cannot serve, with the reason."""
        t = self.template
        if arch.family != "dense":
            raise ValueError(
                f"{arch.name}: multi-topology serving covers the dense GQA "
                f"family; family {arch.family!r} needs its own engine")
        for knob, want, got in (("norm", t.norm, arch.norm),
                                ("activation", t.activation, arch.activation),
                                ("positional", "rope", arch.positional)):
            if want != got:
                raise ValueError(
                    f"{arch.name}: {knob}={got!r} differs from the fabric's "
                    f"synthesized {knob}={want!r}; structural knobs are "
                    "frozen at compile time (re-synthesize a fabric with "
                    "the fleet's shared structure)")
        if arch.rope_theta != t.rope_theta:
            raise ValueError(
                f"{arch.name}: rope_theta={arch.rope_theta} differs from "
                f"the fabric's {t.rope_theta}")
        if arch.resolved_head_dim != self.hd:
            raise ValueError(
                f"{arch.name}: head_dim={arch.resolved_head_dim} != fabric "
                f"lane width {self.hd}; head_dim is not a runtime register")
        mx = self.mx
        over = [f"{n}={v} > {m}" for n, v, m in (
            ("heads", arch.num_heads, mx.heads_max),
            ("layers", arch.num_layers, mx.layers_enc_max),
            ("d_model", arch.d_model, mx.d_model_max),
            ("d_ff", arch.d_ff, mx.d_ff_max),
            ("vocab", arch.vocab_size, mx.vocab)) if v > m]
        if over:
            raise ValueError(
                f"{arch.name} exceeds the synthesized maxima "
                f"({'; '.join(over)}); re-synthesis (recompile) required")

    def topo_row(self, arch: ArchConfig, model_id: int) -> list[int]:
        """The slot register values for one fleet member."""
        return [model_id, arch.num_heads, arch.num_layers, arch.d_model,
                arch.d_ff, arch.vocab_size]

    def cache_namespace(self, arch: ArchConfig, model_id: int) -> tuple:
        """Prefix-trie namespace for one fleet member's KV blocks.

        Fleet members share ONE physical pool, but a prompt's KV is a
        function of the *model* that prefilled it: identical token
        prefixes under different members must never alias.  Keyed on the
        model id *and* the architecture name, so a table row reloaded
        with a different member (same id, new weights via
        ``insert_model``) still separates if the caller re-registers the
        engine's namespace map."""
        return ("fleet", model_id, arch.name)

    def _quant_names(self) -> frozenset:
        """Table leaves stored as int8 ``QTensor``s under quant='int8',
        decided on the maxima-padded sizes (the table's structure is
        shared by every member, so a small member may get int8 weights
        that its own ``quantize_params`` would leave float); leaves under
        ``quant_min_size`` stay float, biases and norms always do."""
        if self.quant != "int8":
            return frozenset()
        mx, L = self.mx, self.mx.layers_enc_max
        D, F, V, HO = (mx.d_model_max, mx.d_ff_max, mx.vocab,
                       mx.heads_max * self.hd)
        sizes = {"embed": V * D, "lm_head": V * D,
                 "wq": L * D * HO, "wk": L * D * HO, "wv": L * D * HO,
                 "wo": L * HO * D, "w1": L * D * F, "wg": L * D * F,
                 "w2": L * F * D}
        return frozenset(n for n, sz in sizes.items()
                         if sz >= self.quant_min_size)

    # ------------------------------------------------------------------
    # Model table
    # ------------------------------------------------------------------
    def _norm_shape(self, *lead: int) -> dict:
        p = {"scale": self._zeros(*lead, self.mx.d_model_max)}
        if self.template.norm == "layernorm":
            p["bias"] = self._zeros(*lead, self.mx.d_model_max)
        return p

    def _zeros(self, *shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.param_dtype, device=self.device)

    def init_table(self) -> dict:
        """The zeroed ``[max_models, ...]`` table, in the parameter dtype;
        under quant='int8' the planned leaves are int8 ``QTensor``s, their
        float32 scales ``[M, L, 1, Dout]`` (kernels) or ``[M, V, 1]``
        (``embed``, ``lm_head``)."""
        mx, M, L = self.mx, self.max_models, self.mx.layers_enc_max
        D, F, V, HO = (mx.d_model_max, mx.d_ff_max, mx.vocab,
                       mx.heads_max * self.hd)
        z = self._zeros
        qn = self._quant_names()

        def leaf(name, *shape, scale):
            if name not in qn:
                return z(*shape)
            return QTensor(
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.zeros(scale, dtype=torch.float32, device=self.device))

        def kern(name, *shape):
            return leaf(name, *shape, scale=(*shape[:-2], 1, shape[-1]))

        layers = {
            "ln1": self._norm_shape(M, L),
            "wq": kern("wq", M, L, D, HO), "bq": z(M, L, HO),
            "wk": kern("wk", M, L, D, HO), "bk": z(M, L, HO),
            "wv": kern("wv", M, L, D, HO), "bv": z(M, L, HO),
            "wo": kern("wo", M, L, HO, D),
            "ln2": self._norm_shape(M, L),
            "w1": kern("w1", M, L, D, F), "b1": z(M, L, F),
            "w2": kern("w2", M, L, F, D), "b2": z(M, L, D),
        }
        if is_gated(self.template.activation):
            layers["wg"] = kern("wg", M, L, D, F)
            layers["bg"] = z(M, L, F)
        return {"embed": leaf("embed", M, V, D, scale=(M, V, 1)),
                "lm_head": leaf("lm_head", M, V, D, scale=(M, V, 1)),
                "final_norm": self._norm_shape(M), "layers": layers}

    def pack_member(self, arch: ArchConfig,
                    params: dict[str, torch.Tensor]) -> dict:
        """A state dict of the port's ``Model(arch)`` (float weights, e.g.
        from ``bridge.from_jax_params`` or ``Model.init``) -> one
        zero-padded table row: KV weights replicated across the head group
        (so the step is uniform MHA over ``heads`` lanes), absent biases as
        exact zeros, the ``lm_head`` row the member's untied table or, when
        it ties its embeddings, the embedding table; under quant='int8'
        its planned leaves quantized (``_quantize_row``)."""
        self.check_member(arch)
        mx, L = self.mx, self.mx.layers_enc_max
        h, kv, hd = arch.num_heads, arch.num_kv_heads, self.hd
        rep = h // kv
        nl, D, F, HO = arch.num_layers, mx.d_model_max, mx.d_ff_max, \
            mx.heads_max * hd

        def pad(a: torch.Tensor, *shape: int) -> torch.Tensor:
            out = self._zeros(*shape)
            out[tuple(slice(0, s) for s in a.shape)] = a.to(
                self.device, self.param_dtype)
            return out

        def stacked(leaf: str, width: int | None = None) -> torch.Tensor:
            # [nl, ...] over the layers; an absent bias is zeros of width
            keys = [f"layers.{i}.{leaf}" for i in range(nl)]
            if keys[0] not in params:
                return torch.zeros((nl, width), dtype=self.param_dtype)
            return torch.stack([params[k].float() for k in keys])

        def rep_kv(w):  # [l, d, kv*hd] -> [l, d, h*hd] (head-grouped order)
            l_, d_ = w.shape[:2]
            return w.reshape(l_, d_, kv, 1, hd).expand(l_, d_, kv, rep, hd) \
                .reshape(l_, d_, h * hd)

        def rep_kv_b(b_):  # [l, kv*hd] -> [l, h*hd]
            l_ = b_.shape[0]
            return b_.reshape(l_, kv, 1, hd).expand(l_, kv, rep, hd) \
                .reshape(l_, h * hd)

        def norm_row(prefix: str, *shape: int, layers: bool = True) -> dict:
            get = stacked if layers else (lambda k: params[k].float())
            out = {"scale": pad(get(f"{prefix}.scale"), *shape)}
            if self.template.norm == "layernorm":
                out["bias"] = pad(get(f"{prefix}.bias"), *shape)
            return out

        a, f = "attn", "ffn"
        row_layers = {
            "ln1": norm_row("ln1", L, D),
            "wq": pad(stacked(f"{a}.wq.kernel"), L, D, HO),
            "bq": pad(stacked(f"{a}.wq.bias", h * hd), L, HO),
            "wk": pad(rep_kv(stacked(f"{a}.wk.kernel")), L, D, HO),
            "bk": pad(rep_kv_b(stacked(f"{a}.wk.bias", kv * hd)), L, HO),
            "wv": pad(rep_kv(stacked(f"{a}.wv.kernel")), L, D, HO),
            "bv": pad(rep_kv_b(stacked(f"{a}.wv.bias", kv * hd)), L, HO),
            "wo": pad(stacked(f"{a}.wo.kernel"), L, HO, D),
            "ln2": norm_row("ln2", L, D),
            "w1": pad(stacked(f"{f}.w1.kernel"), L, D, F),
            "b1": pad(stacked(f"{f}.w1.bias", arch.d_ff), L, F),
            "w2": pad(stacked(f"{f}.w2.kernel"), L, F, D),
            "b2": pad(stacked(f"{f}.w2.bias", arch.d_model), L, D),
        }
        if is_gated(self.template.activation):
            row_layers["wg"] = pad(stacked(f"{f}.wg.kernel"), L, D, F)
            row_layers["bg"] = pad(stacked(f"{f}.wg.bias", arch.d_ff), L, F)
        table = params["embed.table"]
        head = table if arch.tie_embeddings else params["lm_head.table"]
        return self._quantize_row({
            "embed": pad(table, mx.vocab, D),
            "lm_head": pad(head, mx.vocab, D),
            "final_norm": norm_row("final_norm", D, layers=False),
            "layers": row_layers})

    def _quantize_row(self, row: dict) -> dict:
        """Symmetric-int8-quantize the planned leaves of one packed row
        through the one quantizer (``core.serve_quant.quantize_leaf``:
        per-(layer, output column) scales for kernels, per-row for the
        vocab tables).  Zero padding moves no scale, so on leaves quantized
        on both sides a member's values equal its single-model ones on the
        live lanes."""
        qn = self._quant_names()
        for name in ("embed", "lm_head"):
            if name in qn:
                row[name] = quantize_leaf(row[name], "table")
        for name in ("wq", "wk", "wv", "wo", "w1", "w2", "wg"):
            if name in qn and name in row["layers"]:
                row["layers"][name] = quantize_leaf(row["layers"][name],
                                                    "kernel")
        return row

    @staticmethod
    def insert_model(table: dict, row: dict, model_id: int) -> dict:
        """Copy one packed row into the table in place (the weight
        write); returns the table."""
        _tree_map(lambda t, r: t[model_id].copy_(r), table, row)
        return table

    # ------------------------------------------------------------------
    # Capacity accounting
    # ------------------------------------------------------------------
    def kv_bytes_per_token(self) -> int:
        """Device bytes one cached token costs in this fabric's pool: the
        pool is provisioned at the maxima (``layers_enc_max`` layers x
        ``heads_max`` heads x the lane width), whatever member fills it."""
        per_row = self.codec.bytes_per_feature_row(self.hd,
                                                   self.compute_dtype)
        return 2 * self.mx.layers_enc_max * self.mx.heads_max * per_row

    @staticmethod
    def table_bytes(table: dict) -> int:
        """Resident device bytes of a packed weight table (all rows)."""
        return sum(t.numel() * t.element_size() for t in tree_leaves(table))

    # ------------------------------------------------------------------
    # Decode cache (maxima-shaped; both layouts)
    # ------------------------------------------------------------------
    def init_cache(self, paging: PagingConfig | None, *, batch: int = 0,
                   max_len: int = 0) -> KVCache:
        """The cache through the fabric's codec: with ``paging`` the pool
        ``[layers_enc_max, num_blocks + 1, block_size, heads_max, hd]``
        (pool row 0 is the null block), else the dense rows
        ``[layers_enc_max, batch, max_len + 1, heads_max, hd]``."""
        lead = (paging.pool_blocks, paging.block_size) if paging is not None \
            else (batch, max_len + 1)
        shape = (self.mx.layers_enc_max, *lead, self.mx.heads_max, self.hd)
        k, k_scale = self.codec.cache_tensors(shape, self.device)
        v, v_scale = self.codec.cache_tensors(shape, self.device)
        return KVCache(k, v, k_scale, v_scale)

    # ------------------------------------------------------------------
    # Masked compute
    # ------------------------------------------------------------------
    def _norm(self, x: torch.Tensor, p: dict,
              d_live: torch.Tensor) -> torch.Tensor:
        if self.template.norm == "rmsnorm":
            return masking.masked_rmsnorm_slots(x, p["scale"], d_live)
        return masking.masked_layernorm_slots(x, p["scale"], p["bias"],
                                              d_live)

    @staticmethod
    def _mm(x: torch.Tensor, w: torch.Tensor | QTensor,
            b: torch.Tensor | None = None) -> torch.Tensor:
        """Per-slot dense: x [B, S, Din] @ w [B, Din, Dout] (+ b [B, Dout]),
        the weights rounded to x's dtype and the product in float32 (the
        reference's einsum), cast back to x's dtype.  An int8 ``QTensor``
        is dequantized in x's dtype first, values times scales, as the
        reference rounds it."""
        if isinstance(w, QTensor):
            wb = w.values.to(x.dtype) * w.scale.to(x.dtype)
        else:
            wb = w.to(x.dtype)
        y = torch.bmm(x.float(), wb.float()).to(x.dtype)
        if b is not None:
            y = y + b.to(y.dtype)[:, None]
        return y

    def _embed_rows(self, table: dict, mid: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings gathered by (model row, token id); an int8
        table dequantized with its gathered per-row scales in the compute
        dtype."""
        emb, mid, tokens = table["embed"], mid.long(), tokens.long()
        if isinstance(emb, QTensor):
            return emb.values[mid, tokens].to(self.compute_dtype) \
                * emb.scale[mid, tokens].to(self.compute_dtype)
        return emb[mid, tokens].to(self.compute_dtype)

    def _qkv(self, xn: torch.Tensor, lp: dict, positions: torch.Tensor,
             he: torch.Tensor):
        """Masked QKV projections at maxima head lanes; ``he`` is the
        per-slot [B, 1, H, 1] live-head mask."""
        B, S = xn.shape[:2]
        shape = (B, S, self.mx.heads_max, self.hd)
        q = self._mm(xn, lp["wq"], lp["bq"]).reshape(shape) * he
        k = self._mm(xn, lp["wk"], lp["bk"]).reshape(shape) * he
        v = self._mm(xn, lp["wv"], lp["bv"]).reshape(shape) * he
        q = apply_rope(q, positions, self.template.rope_theta)
        k = apply_rope(k, positions, self.template.rope_theta)
        return q, k, v

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
        """Scores over live cache positions only: ``live`` is [B, S_kv], or
        [B, W, S_kv] per-lane masks (the mixed step)."""
        s = torch.einsum("bqhd,bkhd->bhqk", q, k.to(q.dtype)).float() \
            / math.sqrt(self.hd)
        m = live[:, None, None, :] if live.dim() == 2 else live[:, None]
        s = torch.where(m, s, masking.NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)

    def _ffn(self, xn: torch.Tensor, lp: dict,
             f_live: torch.Tensor) -> torch.Tensor:
        fm = masking.slot_mask(self.mx.d_ff_max, f_live, xn.dtype)[:, None]
        h1 = self._mm(xn, lp["w1"], lp["b1"])
        if is_gated(self.template.activation):
            h = activate(self._mm(xn, lp["wg"], lp["bg"]),
                         self.template.activation) * h1
        else:
            h = activate(h1, self.template.activation)
        return self._mm(h * fm, lp["w2"], lp["b2"])

    def _unembed(self, x: torch.Tensor, table: dict, mid: torch.Tensor,
                 d_live: torch.Tensor, v_live: torch.Tensor) -> torch.Tensor:
        """Float32 logits [B, S, V_max] against each slot's ``lm_head``
        row, the dead vocab lanes at NEG_INF so that sampling can never pick
        a token outside the slot's vocab.  The [B, V_max, D] float32 gather of the
        per-slot tables (an int8 one dequantized in float32) is the
        reference's."""
        mid = mid.long()
        xn = self._norm(x, _tree_map(lambda t: t[mid], table["final_norm"]),
                        d_live)
        lm = table["lm_head"]
        if isinstance(lm, QTensor):                            # [B, V, D]
            lmf = lm.values[mid].float() * lm.scale[mid]
        else:
            lmf = lm[mid].float()
        logits = torch.bmm(xn.float(), lmf.transpose(1, 2))
        vm = torch.arange(self.mx.vocab, device=x.device)[None, None, :] \
            < v_live[:, None, None]
        return torch.where(vm, logits, masking.NEG_INF)

    @staticmethod
    def _gather_layer(table: dict, mid: torch.Tensor, i: int) -> dict:
        """Per-slot weights of layer ``i``: [B, ...] gathered by model id."""
        mid = mid.long()
        return _tree_map(lambda t: t[mid, i], table["layers"])

    # ------------------------------------------------------------------
    # The fused steps
    # ------------------------------------------------------------------
    def _layers(self, table: dict, cache: KVCache, x: torch.Tensor,
                topo: torch.Tensor, positions: torch.Tensor, where: tuple,
                attend) -> torch.Tensor:
        """Every one of the ``layers_enc_max`` layers over x [B, S, D]: the
        new K/V rows written into the pool at ``where`` (in place), then
        ``attend(q, layer cache, live kv groups)``; layers past a slot's
        count leave its h as it was."""
        mid, h_live = topo[:, REG_MODEL], topo[:, REG_HEADS]
        l_live, d_live = topo[:, REG_LAYERS], topo[:, REG_DMODEL]
        f_live = topo[:, REG_DFF]
        B, S = x.shape[:2]
        he = masking.slot_mask(self.mx.heads_max, h_live)[:, None, :, None] \
            .to(self.compute_dtype)
        dm = masking.slot_mask(self.mx.d_model_max, d_live)[:, None] \
            .to(self.compute_dtype)
        live_kv = h_live.contiguous()
        for i in range(self.mx.layers_enc_max):
            c = cache.layer(i)
            lp = self._gather_layer(table, mid, i)
            xn = self._norm(x, lp["ln1"], d_live)
            q, k_new, v_new = self._qkv(xn, lp, positions, he)
            # one K/V row per write position ([B] decode, [B, W] lanes)
            rows = (*torch.broadcast_shapes(where[0].shape, where[1].shape),
                    *k_new.shape[2:])
            kq, ksc = self.codec.store(k_new.reshape(rows), c.k.dtype)
            vq, vsc = self.codec.store(v_new.reshape(rows), c.v.dtype)
            cache_put(c.k, c.k_scale, where, kq, ksc)
            cache_put(c.v, c.v_scale, where, vq, vsc)
            o = attend(q, c, live_kv)
            a = self._mm((o * he).reshape(B, S, -1), lp["wo"]) * dm
            h1 = x + a
            f = self._ffn(self._norm(h1, lp["ln2"], d_live), lp,
                          f_live) * dm
            x = torch.where((i < l_live)[:, None, None], h1 + f, x)
        return x

    def _inputs(self, table: dict, tokens: torch.Tensor,
                topo: torch.Tensor) -> torch.Tensor:
        emb = self._embed_rows(table, topo[:, REG_MODEL][:, None], tokens)
        return emb * masking.slot_mask(self.mx.d_model_max,
                                       topo[:, REG_DMODEL],
                                       emb.dtype)[:, None, :]

    @torch.no_grad()
    def prefill(self, table: dict, topo: torch.Tensor, tokens: torch.Tensor,
                max_len: int) -> tuple[torch.Tensor, KVCache]:
        """tokens [1, S] + registers topo [N_REGS] -> (masked logits [1, S,
        V_max], the cache ``[layers_enc_max, 1, max_len + 1, heads_max,
        hd]`` through the codec, rows from S on zeros): the fleet's
        bucketed prefill, the same masked math at S lanes with a causal
        mask (the reference's ``prefill``)."""
        mx = self.mx
        topo = topo[None]
        mid, h_live = topo[:, REG_MODEL], topo[:, REG_HEADS]
        l_live, d_live = topo[:, REG_LAYERS], topo[:, REG_DMODEL]
        S = tokens.shape[1]
        x = self._inputs(table, tokens, topo)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
        he = masking.slot_mask(mx.heads_max, h_live)[:, None, :, None] \
            .to(self.compute_dtype)
        dm = masking.slot_mask(mx.d_model_max, d_live)[:, None] \
            .to(self.compute_dtype)
        causal = (torch.arange(S, device=tokens.device)[None, :]
                  <= torch.arange(S, device=tokens.device)[:, None])
        ks, vs = [], []
        for i in range(mx.layers_enc_max):
            lp = self._gather_layer(table, mid, i)
            xn = self._norm(x, lp["ln1"], d_live)
            q, k, v = self._qkv(xn, lp, positions, he)
            o = self._attend(q, k, v, causal[None].expand(1, S, S)) * he
            a = self._mm(o.reshape(1, S, -1), lp["wo"]) * dm
            h1 = x + a
            f = self._ffn(self._norm(h1, lp["ln2"], d_live), lp,
                          topo[:, REG_DFF]) * dm
            x = torch.where((i < l_live)[:, None, None], h1 + f, x)
            ks.append(padded_store(self.codec, k, max_len + 1))
            vs.append(padded_store(self.codec, v, max_len + 1))
        kq, ksc = zip(*ks)
        vq, vsc = zip(*vs)
        stack = (lambda t: None if t[0] is None else torch.stack(t))
        cache = KVCache(*(stack(t) for t in (kq, vq, ksc, vsc)))
        return self._unembed(x, table, mid, d_live, topo[:, REG_VOCAB]), \
            cache

    @torch.no_grad()
    def decode_step(self, table: dict, cache: KVCache, tokens: torch.Tensor,
                    index: torch.Tensor, topo: torch.Tensor,
                    block_tables: torch.Tensor | None = None,
                    paged_attn_impl: str = "gather") -> torch.Tensor:
        """tokens [B, 1] at per-slot positions ``index`` [B] + per-slot
        registers topo [B, N_REGS] -> masked logits [B, 1, V_max]; the new
        K/V rows are written into ``cache`` in place: the pool through
        ``block_tables``, or with ``block_tables=None`` the dense rows
        (attended through the gather-style path, as in the reference)."""
        idx = index.to(torch.int32)
        if block_tables is None:
            s_max = cache.k.shape[2] - 1
            where = dense_write_slot(
                idx, torch.ones_like(idx, dtype=torch.bool), s_max)
            live = torch.arange(s_max, device=tokens.device)[None, :] \
                <= idx[:, None]
            attend = self._dense_attend(s_max, live)
        else:
            bs = cache.k.shape[2]
            t_max = block_tables.shape[1] * bs
            where = paged_write_slot(idx, block_tables, bs)
            if paged_attn_impl == "pallas":
                lengths = (idx + 1).clamp(max=t_max).to(torch.int32)

                def attend(q, c, live_kv):
                    return paged_decode_attention(
                        q[:, 0].contiguous(), c.k, c.v, block_tables,
                        lengths, live_kv=live_kv, k_scale=c.k_scale,
                        v_scale=c.v_scale)[:, None]
            elif paged_attn_impl == "gather":
                live = torch.arange(t_max, device=tokens.device)[None, :] \
                    <= idx[:, None]
                attend = self._gather_attend(block_tables, live)
            else:
                raise ValueError(
                    f"unknown paged_attn_impl {paged_attn_impl!r}")
        x = self._inputs(table, tokens, topo)
        x = self._layers(table, cache, x, topo, idx[:, None], where, attend)
        return self._unembed(x, table, topo[:, REG_MODEL],
                             topo[:, REG_DMODEL], topo[:, REG_VOCAB])

    @torch.no_grad()
    def mixed_step(self, table: dict, cache: KVCache, tokens: torch.Tensor,
                   start: torch.Tensor, n_live: torch.Tensor,
                   topo: torch.Tensor,
                   block_tables: torch.Tensor | None = None,
                   paged_attn_impl: str = "gather") -> torch.Tensor:
        """tokens [B, W] + per-slot registers topo [B, N_REGS] -> masked
        logits [B, W, V_max].

        The W-lane generalization of ``decode_step``: lane ``l`` of slot
        ``b`` sits at cache position ``start[b] + l`` and only the first
        ``n_live[b]`` lanes are real (a decoding slot uses one lane, a
        prefilling slot a chunk of its prompt, an idle slot none).  Chunk
        K/V are written before the attend (dead lanes into the null block
        or the dense rows' spare), so one causal-vs-cache mask covers the
        chunk and the prior cache.
        """
        W = tokens.shape[1]
        start = start.to(torch.int32)
        positions = start[:, None] + torch.arange(
            W, dtype=torch.int32, device=tokens.device)[None, :]
        lane_live = masking.lane_mask(W, n_live)
        if block_tables is None:
            s_max = cache.k.shape[2] - 1
            where = dense_write_slot(positions, lane_live, s_max)
            attend = self._dense_attend(
                s_max, masking.chunk_causal_mask(s_max, start, W))
        else:
            bs = cache.k.shape[2]
            t_max = block_tables.shape[1] * bs
            idx_w = torch.where(lane_live, positions, t_max)
            where = paged_write_slot(idx_w, block_tables, bs)
            if paged_attn_impl == "pallas":
                def attend(q, c, live_kv):
                    return chunked_prefill_attention(
                        q.contiguous(), c.k, c.v, block_tables, start,
                        live_kv=live_kv, k_scale=c.k_scale,
                        v_scale=c.v_scale)
            elif paged_attn_impl == "gather":
                attend = self._gather_attend(
                    block_tables, masking.chunk_causal_mask(t_max, start, W))
            else:
                raise ValueError(
                    f"unknown paged_attn_impl {paged_attn_impl!r}")
        x = self._inputs(table, tokens, topo)
        x = self._layers(table, cache, x, topo, positions, where, attend)
        return self._unembed(x, table, topo[:, REG_MODEL],
                             topo[:, REG_DMODEL], topo[:, REG_VOCAB])

    def _dense_attend(self, s_max: int, live: torch.Tensor):
        """The attend over one layer's dense rows (their first ``s_max``,
        read through the codec: as stored, or dequantized to q's dtype)."""
        def attend(q, c, live_kv):
            view = (lambda t, sc: self.codec.load(
                t[:, :s_max], None if sc is None else sc[:, :s_max],
                q.dtype))
            return self._attend(q, view(c.k, c.k_scale),
                                view(c.v, c.v_scale), live)
        return attend

    def _gather_attend(self, block_tables: torch.Tensor, live: torch.Tensor):
        """The XLA-style attend: the block-table gather of one layer's pool
        (dequantized to q's dtype) and ``_attend`` over ``live``."""
        def attend(q, c, live_kv):
            kg = gather_view(self.codec, c.k, c.k_scale, block_tables,
                             q.dtype)
            vg = gather_view(self.codec, c.v, c.v_scale, block_tables,
                             q.dtype)
            return self._attend(q, kg, vg, live)
        return attend
