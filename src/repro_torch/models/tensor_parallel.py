"""Tensor parallelism of the fused chunked step, driven from one process.

The counterpart of the reference's GSPMD lowering of ``spec.mesh.tp``
(its engine's ``_shard_arrays``: the parameters split by the logical-axis
rules, the cache on its kv-head axis).  The reference is single-
controller: one process drives the whole mesh and the compiler inserts
the collectives.  The port keeps that shape and writes the collectives
out: one process holds every rank's shard of the weights and of the pool
and runs the ranks' programs in turn, each on its rank's device.

* Each rank attends over its own query heads (its columns of ``wq``,
  ``wk``, ``wv`` and their biases, its kv heads' part of the pool) and
  multiplies by its rows of ``wo``; its FFN takes its columns of ``w1``
  / ``wg`` and its rows of ``w2``.
* The row-parallel partial sums [B, W, d] are added in fixed rank order
  (rank 0 + rank 1 + ...) on the first rank's device, where the residual
  stream, the norms, the slot state and the block tables live; ``w2``'s
  bias is added once, after the sum.
* The embedding lookup is the fixed-order sum of the ranks' masked
  lookups of their vocabulary rows (exactly one of them is not zero),
  and the logits are the ranks' vocabulary slices of the unembedding,
  concatenated in rank order before sampling.

Every leaf follows ``distributed.sharding.param_rules`` with its
divisibility fallback, resolved in whole heads (a rank never holds part
of a head): a leaf whose axis does not divide ``tp`` is whole on every
rank, and the step then takes rank 0's result of that part instead of a
sum, since every rank computed the same (each still writes its own whole
copy of the pool, as a replicated pool is written).  Where the kv heads
stay whole but the query heads split, each rank's query heads reach
their kv heads through ``attention.HeadShard.kv_map``.  The pool follows
``sharding.kv_cache_shardings``: K and V on the kv-head axis, an int8
pool's scale rows on their trailing kv-head axis.  Int8 weights are
quantized whole, as a single-device model quantizes them, before they are
cut, so a kernel's per-column scales split with its columns and stay
whole beside its rows.

The step runs the plain routes (``matmul_backend="xla"``,
``paged_attn_impl="gather"``: the reference's rule, ``core/spec.py``)
over the paged pool or the dense layout, for the dense and vlm families.
Ranks may share a device (one card, or the host in the tests): every
program of the step is then one stream's work, and one CUDA graph
captures it whole.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import (DEFAULT_COMPUTE_DTYPE,
                                      DEFAULT_PARAM_DTYPE, ArchConfig)
from repro_torch.core import serve_quant
from repro_torch.core.paging import PagingConfig
from repro_torch.core.quant import DEFAULT_QUANT_MIN_SIZE
from repro_torch.distributed import sharding
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.attention import HeadShard, KVCache
from repro_torch.models.model import Model, _frozen, _weight

TP_FAMILIES = ("dense", "vlm")
_MM = "xla"


class ShardedCache:
    """The tp ranks' caches: rank r's ``KVCache`` is ``ranks[r]``.
    Iterating yields every rank's tensors in rank order, so what acts on
    each tensor of a cache (``kv_quant.fork_block``, the engine's graph
    inputs) acts on every rank alike, on the same block ids."""

    def __init__(self, ranks: list[KVCache]):
        self.ranks = list(ranks)

    def __iter__(self):
        for cache in self.ranks:
            yield from cache


def _split(spec: tuple, dim: int) -> bool:
    return len(spec) > dim and spec[dim] is not None


class TPModel:
    """``Model(cfg)``'s fused steps over ``len(devices)`` tensor-parallel
    ranks, rank r on ``devices[r]`` (devices may repeat).  The engine's
    surface of ``Model``: ``load_state_dict`` (a whole state dict of the
    port's ``Model``, cut here), ``init_cache``, ``mixed_step`` and
    ``decode_step``."""

    def __init__(self, cfg: ArchConfig, devices, *,
                 param_dtype=DEFAULT_PARAM_DTYPE,
                 compute_dtype=DEFAULT_COMPUTE_DTYPE,
                 matmul_backend: str = "xla",
                 paged_attn_impl: str = "gather", quant: str = "none",
                 quant_min_size: int = DEFAULT_QUANT_MIN_SIZE,
                 kv_dtype: str = "compute"):
        if cfg.family not in TP_FAMILIES:
            raise ValueError(
                f"{cfg.name}: the tensor-parallel step serves the families "
                f"{TP_FAMILIES} (core/spec.py refuses the others)")
        if matmul_backend != _MM or paged_attn_impl != "gather":
            raise ValueError(
                "mesh.tp > 1 requires the XLA compute path "
                "(matmul_backend='xla', paged_attn_impl='gather')")
        self.cfg = cfg
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.tp = len(self.devices)
        self.compute_dtype = compute_dtype
        self.quant, self.quant_min_size = quant, quant_min_size
        self.mesh = sharding.tp_mesh(self.devices)
        self.strategy = sharding.strategy_for_mesh(self.mesh)
        kw = dict(param_dtype=param_dtype, compute_dtype=compute_dtype,
                  quant=quant, quant_min_size=quant_min_size,
                  kv_dtype=kv_dtype)
        # the whole model's structure and shapes, allocating nothing
        self._template = Model(cfg, device="meta", **kw)
        self.codec = self._template.codec
        self.specs = self._resolve()
        self.ranks = [self._rank(Model(cfg, device="meta", **kw), r)
                      for r in range(self.tp)]
        s = self.specs
        self.heads_split = _split(s["layers.0.attn.wq.kernel"], 1)
        kv_split = _split(s["layers.0.attn.wk.kernel"], 1)
        self.ffn_split = _split(s["layers.0.ffn.w1.kernel"], 1)
        self.vocab_split = _split(s["embed.table"], 0)
        self.head_split = _split(
            s["embed.table" if cfg.tie_embeddings else "lm_head.table"], 0)
        h, kv = cfg.num_heads, cfg.num_kv_heads
        self.heads: list[HeadShard] = []
        for r, dev in enumerate(self.devices):
            if not self.heads_split:
                self.heads.append(HeadShard(h, kv))
            elif kv_split:
                self.heads.append(HeadShard(h // self.tp, kv // self.tp))
            else:
                h_r = h // self.tp
                self.heads.append(HeadShard(h_r, kv, torch.tensor(
                    [(r * h_r + j) // (h // kv) for j in range(h_r)],
                    device=dev)))

    @classmethod
    def from_spec(cls, spec, devices) -> "TPModel":
        ex = spec.execution
        return cls(spec.arch, devices, param_dtype=ex.param_dtype,
                   compute_dtype=ex.compute_dtype,
                   matmul_backend=ex.matmul_backend,
                   paged_attn_impl=ex.paged_attn_impl, quant=ex.quant,
                   quant_min_size=ex.quant_min_size,
                   kv_dtype=spec.memory.kv_dtype)

    # ------------------------------------------------------------------
    # the shards
    # ------------------------------------------------------------------
    def _resolve(self) -> dict[str, tuple]:
        """Each leaf's mesh spec (the int8 scales' too): ``param_rules``
        on the leaf's logical axes, a heads / kv_heads dimension counted
        in whole heads."""
        rules = sharding.param_rules(self.strategy)
        hd = self.cfg.resolved_head_dim
        axes = self._template.axes()

        def one(names: tuple, shape) -> tuple:
            whole = tuple(d // hd if n in ("heads", "kv_heads") else d
                          for d, n in zip(shape, names))
            return sharding.resolve_spec(names, whole, rules, self.mesh)

        specs = {n: one(axes[n], p.shape)
                 for n, p in self._template.named_parameters()}
        for n, b in self._template.named_buffers():
            values = n[:-len(serve_quant.SCALE_SUFFIX)]
            specs[n] = one(serve_quant.scale_axes(
                axes[values], values.rpartition(".")[2]), b.shape)
        return specs

    def _rank(self, model: Model, r: int) -> Model:
        """``model`` (built on the meta device) with every leaf replaced by
        rank r's shard-shaped tensor on its device: a container of the
        rank's weights, read leaf by leaf by the step below."""
        dev = self.devices[r]
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner)
            shape = sharding.shard_shape(t.shape, self.specs[name], self.mesh)
            if isinstance(t, nn.Parameter):
                setattr(mod, leaf, _frozen(shape, t.dtype, dev))
            else:
                mod.register_buffer(leaf, torch.zeros(shape, dtype=t.dtype,
                                                      device=dev))
        model.device = dev
        return model

    @torch.no_grad()
    def load_state_dict(self, state_dict) -> None:
        """Cut a whole state dict of the port's ``Model`` into the ranks'
        shards (int8 weights quantized whole first, as ``Model`` does)."""
        if any(k.startswith("mtp.") for k in state_dict):
            state_dict = {k: v for k, v in state_dict.items()
                          if not k.startswith("mtp.")}
        if self.quant == "int8":
            state_dict = serve_quant.quantize_params(
                state_dict, self.quant_min_size,
                self._template._stacked_layers())
        for r, rank in enumerate(self.ranks):
            nn.Module.load_state_dict(rank, {
                n: sharding.local_shard(t, self.specs[n], self.mesh, r)
                if n in self.specs else t for n, t in state_dict.items()})

    def init_cache(self, paging: PagingConfig | None = None, *,
                   batch: int = 0, max_len: int = 0) -> ShardedCache:
        """Each rank's block of the cache ``Model.init_cache`` allocates
        (the paged pool, or the dense layout without ``paging``), as
        ``sharding.kv_cache_shardings`` cuts it."""
        whole = self._template.init_cache(paging, batch=batch,
                                          max_len=max_len)
        specs = sharding.kv_cache_shardings(self.mesh, whole, self.strategy)
        return ShardedCache([KVCache(*(
            None if t is None else torch.zeros(
                sharding.shard_shape(t.shape, sh.spec, self.mesh),
                dtype=t.dtype, device=dev)
            for t, sh in zip(whole, specs))) for dev in self.devices])

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _sum(self, parts: list[torch.Tensor], split: bool) -> torch.Tensor:
        """The ranks' partial results added in rank order on the first
        rank's device, or rank 0's where the part was not split."""
        if not split:
            return parts[0]
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(self.device)
        return out

    def _embed(self, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype: the fixed-order sum of
        the ranks' lookups of their own vocabulary rows (zeros for a token
        another rank holds), plus a learned position table's rows."""
        ranks = self.ranks if self.vocab_split else self.ranks[:1]
        parts = []
        for r, rank in enumerate(ranks):
            table = _weight(rank.embed, "table")
            t = tokens.to(rank.device)
            if self.vocab_split:
                n = rank.embed.table.shape[0]
                local = t - r * n
                inside = (local >= 0) & (local < n)
                rows = layers.embed(local.clamp(0, n - 1), table,
                                    self.compute_dtype)
                parts.append(torch.where(inside[..., None], rows, 0))
            else:
                parts.append(layers.embed(t, table, self.compute_dtype))
        x = self._sum(parts, self.vocab_split)
        lead = self.ranks[0]
        if lead.pos_embed is not None:
            idx = positions.clamp(max=self.cfg.max_position_embeddings - 1)
            x = x + lead.pos_embed.table[idx.long()].to(x.dtype)
        return x

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm, then each rank's vocabulary slice of the
        float32 logits, concatenated in rank order."""
        lead = self.ranks[0]
        xn = layers.apply_norm(x, lead.final_norm, self.cfg.norm, _MM)
        ranks = self.ranks if self.head_split else self.ranks[:1]
        outs = []
        for rank in ranks:
            head = rank.embed if rank.lm_head is None else rank.lm_head
            outs.append(layers.unembed(xn.to(rank.device),
                                       _weight(head, "table"))
                        .to(self.device))
        return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]

    def _ffn(self, i: int, hn: torch.Tensor) -> torch.Tensor:
        """Layer i's FFN: each rank's columns of w1 / wg, then its rows of
        w2, summed in rank order; w2's bias once."""
        act = self.cfg.activation
        ranks = self.ranks if self.ffn_split else self.ranks[:1]
        parts = []
        for rank in ranks:
            p, h = rank.layers[i].ffn, hn.to(rank.device)
            u = layers.apply_dense(h, p.w1, _MM)
            if p.wg is not None:
                u = layers.activate(layers.apply_dense(h, p.wg, _MM), act) * u
            else:
                u = layers.activate(u, act)
            parts.append(layers.apply_dense(u, p.w2, _MM, bias=False))
        y = self._sum(parts, self.ffn_split)
        bias = self.ranks[0].layers[i].ffn.w2.bias
        return y if bias is None else y + bias.to(y.dtype)

    def _layers(self, x: torch.Tensor, attend) -> torch.Tensor:
        """Every layer: the norm, the ranks' attention (``attend(r, i,
        hn)``, rank r's partial output on its device) summed, the FFN."""
        lead = self.ranks[0]
        for i in range(self.cfg.num_layers):
            blk = lead.layers[i]
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm, _MM)
            x = x + self._sum([attend(r, i, hn.to(self.devices[r]))
                               for r in range(self.tp)], self.heads_split)
            x = x + self._ffn(i, layers.apply_norm(x, blk.ln2,
                                                   self.cfg.norm, _MM))
        return x

    def _on_ranks(self, *tensors) -> list[tuple]:
        """The step's small inputs on each rank's device."""
        return [tuple(None if t is None else t.to(d) for t in tensors)
                for d in self.devices]

    @torch.no_grad()
    def mixed_step(self, cache: ShardedCache, tokens: torch.Tensor,
                   start: torch.Tensor, n_live: torch.Tensor,
                   block_tables: torch.Tensor | None = None,
                   prefill_lanes: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """``Model.mixed_step`` over the ranks: tokens [B, W] -> logits
        [B, W, V] on the first rank's device, every rank's pool written in
        place."""
        cfg = self.cfg
        positions = start[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device, dtype=start.dtype)[None, :]
        x = self._embed(tokens, positions)
        if cfg.frontend is not None and prefill_lanes is not None:
            fm = prefill_lanes[:, None, None] \
                & (positions < cfg.frontend.num_tokens)[..., None]
            x = x.masked_fill(fm, 0)
        per = self._on_ranks(start, n_live, block_tables)

        def attend(r: int, i: int, hn: torch.Tensor) -> torch.Tensor:
            st, nl, bt = per[r]
            p, c = self.ranks[r].layers[i].attn, cache.ranks[r].layer(i)
            if bt is None:
                return attn.gqa_mixed(hn, p, cfg, c, st, nl, mm=_MM,
                                      codec=self.codec, heads=self.heads[r])
            return attn.gqa_mixed_paged(hn, p, cfg, c, st, nl, bt,
                                        impl="gather", mm=_MM,
                                        codec=self.codec, heads=self.heads[r])

        return self._unembed(self._layers(x, attend))

    @torch.no_grad()
    def decode_step(self, cache: ShardedCache, tokens: torch.Tensor,
                    cache_index: torch.Tensor,
                    block_tables: torch.Tensor | None = None
                    ) -> torch.Tensor:
        """``Model.decode_step`` over the ranks: tokens [B, 1] at
        ``cache_index`` [B] -> logits [B, 1, V]."""
        cfg = self.cfg
        x = self._embed(tokens, cache_index[:, None])
        per = self._on_ranks(cache_index, block_tables)

        def attend(r: int, i: int, hn: torch.Tensor) -> torch.Tensor:
            idx, bt = per[r]
            p, c = self.ranks[r].layers[i].attn, cache.ranks[r].layer(i)
            if bt is None:
                return attn.gqa_decode(hn, p, cfg, c, idx, mm=_MM,
                                       codec=self.codec, heads=self.heads[r])
            return attn.gqa_decode_paged(hn, p, cfg, c, idx, bt,
                                         impl="gather", mm=_MM,
                                         codec=self.codec,
                                         heads=self.heads[r])

        return self._unembed(self._layers(x, attend))
