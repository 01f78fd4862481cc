"""The decoder LM of the port (the reference's ``Model`` for the families
``dense`` and ``moe``, with GQA or MLA attention): parameters, the paged
KV pool and the dense per-slot cache, ``forward``, ``decode_step`` and
``mixed_step``.

Parameters mirror the reference's pytree, one module per layer instead
of a stacked layer axis: ``embed.table``, ``final_norm.scale``,
``layers.<i>.{ln1, attn.{wq,wk,wv,wo}, ln2, ffn.{w1,wg,w2}}`` and, for a
model with untied embeddings, ``lm_head.table``.  An MoE model's layers
hold ``moe.{router, w1, wg, w2}`` (and ``moe.shared.{w1,wg,w2}`` with
shared experts) in place of ``ffn``, after a dense prefix of
``first_k_dense`` layers ``dense_prefix.<j>.…`` with FFNs of width
``dense_d_ff``; the prefix's layer j uses cache layer j, main layer i
cache layer ``first_k_dense + i``.  An MLA model (``cfg.mla``, DeepSeek-V3)
holds ``attn.{q_down, q_norm, q_up, kv_down, kv_norm, k_up, v_up, wo}``,
the reference's ``build_mla`` leaves, and caches latents (``MLACache``)
in place of K/V, paged or dense alike.  Dense kernels (``[d_in, d_out]``,
as the reference stores them), their biases and the expert weights are
kept in the compute dtype, cast once from the parameter dtype (the
reference casts them to x's dtype on every call: the same numbers);
norm scales, the router, the embedding table and MLA's ``k_up`` stay in
the parameter dtype, since the norms, the router, ``unembed`` and the
absorbed MLA query read them in float32.

With ``quant="int8"`` every eligible dense kernel and the embedding and
``lm_head`` tables (``core.serve_quant``) is held as int8 values with a float32 buffer beside
it, ``kernel_scale`` ``[1, d_out]`` or ``table_scale`` ``[vocab, 1]``; the
model quantizes float weights as they arrive (``init`` and
``load_state_dict``).  ``kv_dtype`` selects the KV pool's codec
(``core.kv_quant``).  int8 weights on an MLA model are refused where the
size rule would quantize ``k_up`` or ``v_up`` (``core.serve_quant``
``mla_absorbed_leaves``): the absorbed attend contracts them as float
weights, and the reference cannot serve that configuration.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import (DEFAULT_COMPUTE_DTYPE,
                                      DEFAULT_PARAM_DTYPE, ArchConfig)
from repro_torch.core import serve_quant
from repro_torch.core.kv_quant import FLOAT_CODEC, CacheCodec
from repro_torch.core.paging import PagingConfig
from repro_torch.core.quant import DEFAULT_QUANT_MIN_SIZE, QTensor
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe
from repro_torch.models.attention import KVCache, MLACache


def _frozen(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _to_int8(module: nn.Module, leaf: str) -> None:
    """Hold ``module.<leaf>`` (a dense ``kernel`` or the ``table``) as int8
    values plus its float32 ``<leaf>_scale`` buffer (per column of a
    kernel, per row of the table)."""
    w = getattr(module, leaf)
    shape = (1, w.shape[1]) if leaf == "kernel" else (w.shape[0], 1)
    setattr(module, leaf, _frozen(w.shape, torch.int8, w.device))
    module.register_buffer(leaf + serve_quant.SCALE_SUFFIX, torch.ones(
        shape, dtype=torch.float32, device=w.device))


def _weight(module: nn.Module, leaf: str) -> torch.Tensor | QTensor:
    """``module.<leaf>``, as a ``QTensor`` with its scales when int8."""
    w = getattr(module, leaf)
    if w.dtype != torch.int8:
        return w
    return QTensor(w, getattr(module, leaf + serve_quant.SCALE_SUFFIX))


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device):
        super().__init__()
        self.kernel = _frozen((d_in, d_out), dtype, device)
        self.bias = _frozen((d_out,), dtype, device) if bias else None


class Norm(nn.Module):
    def __init__(self, d: int, kind: str, dtype, device):
        super().__init__()
        self.scale = _frozen((d,), dtype, device)
        self.bias = _frozen((d,), dtype, device) if kind == "layernorm" \
            else None


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        self.wq = Dense(d, h * hd, cfg.qkv_bias, dtype, device)
        self.wk = Dense(d, kv * hd, cfg.qkv_bias, dtype, device)
        self.wv = Dense(d, kv * hd, cfg.qkv_bias, dtype, device)
        self.wo = Dense(h * hd, d, False, dtype, device)


class MLAttention(nn.Module):
    """Multi-head latent attention's projections (the reference's
    ``build_mla``; no biases).  ``k_up`` is kept in the parameter dtype:
    the absorbed attend reads it in float32, as the reference reads its
    float32 leaf."""

    def __init__(self, cfg: ArchConfig, param_dtype, dtype, device):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        self.q_down = Dense(d, m.q_lora_rank, False, dtype, device)
        self.q_norm = Norm(m.q_lora_rank, "rmsnorm", param_dtype, device)
        self.q_up = Dense(m.q_lora_rank, h * m.qk_head_dim, False, dtype,
                          device)
        self.kv_down = Dense(d, m.kv_lora_rank + m.qk_rope_head_dim, False,
                             dtype, device)
        self.kv_norm = Norm(m.kv_lora_rank, "rmsnorm", param_dtype, device)
        self.k_up = Dense(m.kv_lora_rank, h * m.qk_nope_head_dim, False,
                          param_dtype, device)
        self.v_up = Dense(m.kv_lora_rank, h * m.v_head_dim, False, dtype,
                          device)
        self.wo = Dense(h * m.v_head_dim, d, False, dtype, device)


class FFN(nn.Module):
    def __init__(self, cfg: ArchConfig, d_ff: int, bias: bool, dtype,
                 device):
        super().__init__()
        self.w1 = Dense(cfg.d_model, d_ff, bias, dtype, device)
        self.wg = Dense(cfg.d_model, d_ff, bias, dtype, device) \
            if layers.is_gated(cfg.activation) else None
        self.w2 = Dense(d_ff, cfg.d_model, bias, dtype, device)


class MoE(nn.Module):
    """The routed experts ``[E, d, f]`` / ``[E, f, d]`` and the router
    ``[d, E]`` (in the parameter dtype), plus a shared dense FFN of width
    ``num_shared_experts * shared_expert_d_ff`` (no biases)."""

    def __init__(self, cfg: ArchConfig, param_dtype, dtype, device):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        e, f = m.num_experts, m.expert_d_ff
        self.router = _frozen((d, e), param_dtype, device)
        self.w1 = _frozen((e, d, f), dtype, device)
        self.wg = _frozen((e, d, f), dtype, device) \
            if layers.is_gated(cfg.activation) else None
        self.w2 = _frozen((e, f, d), dtype, device)
        self.shared = FFN(cfg, m.num_shared_experts * m.shared_expert_d_ff,
                          False, dtype, device) \
            if m.num_shared_experts else None


class Block(nn.Module):
    """A decoder layer: the dense FFN of width ``d_ff`` (with biases in a
    layernorm model, as the paper's FFN) or, with ``moe``, the MoE
    block."""

    def __init__(self, cfg: ArchConfig, param_dtype, compute_dtype, device,
                 d_ff: int | None = None, moe_block: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, param_dtype, device)
        self.attn = MLAttention(cfg, param_dtype, compute_dtype, device) \
            if cfg.mla is not None else Attention(cfg, compute_dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, param_dtype, device)
        if moe_block:
            self.moe = MoE(cfg, param_dtype, compute_dtype, device)
        else:
            self.ffn = FFN(cfg, cfg.d_ff if d_ff is None else d_ff,
                           cfg.norm == "layernorm", compute_dtype, device)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.table = _frozen((vocab, d), dtype, device)


class Model(nn.Module):
    """A dense- or MoE-family causal LM.

    ``matmul_backend`` ("xla" | "pallas") and ``paged_attn_impl``
    ("gather" | "pallas") select the plain PyTorch paths or the
    hand-written kernels; ``quant`` ("none" | "int8") the serving weights
    and ``kv_dtype`` ("compute" | "int8") the KV pool's codec.
    ``device=None`` resolves to the CUDA device and raises without one;
    pass ``device="cpu"`` for the host.
    """

    def __init__(self, cfg: ArchConfig, *, param_dtype=DEFAULT_PARAM_DTYPE,
                 compute_dtype=DEFAULT_COMPUTE_DTYPE, matmul_backend: str = "xla",
                 paged_attn_impl: str = "gather", quant: str = "none",
                 quant_min_size: int = DEFAULT_QUANT_MIN_SIZE,
                 kv_dtype: str = "compute", device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe") \
                or (cfg.family == "moe") != (cfg.moe is not None) \
                or cfg.positional not in ("rope", "none"):
            raise ValueError(
                f"{cfg.name}: the port's Model serves the dense and moe "
                "families (an moe config with its MoEConfig) with rope (or "
                "no) positions (ROADMAP.md Queue 1 items 11-12)")
        cfg.validate()
        if quant not in ("none", "int8"):
            raise ValueError(f"quant={quant!r} is not one of ('none', 'int8')")
        if quant == "int8":
            serve_quant.check_mla_quant(cfg, quant_min_size)
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.matmul_backend = matmul_backend
        self.paged_attn_impl = paged_attn_impl
        self.quant = quant
        self.quant_min_size = quant_min_size
        self.codec = CacheCodec(kv_dtype)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, param_dtype, dev)
        # an MoE model: the dense prefix, then the MoE blocks
        k = cfg.moe.first_k_dense if cfg.moe is not None else 0
        self.dense_prefix = nn.ModuleList(
            Block(cfg, param_dtype, compute_dtype, dev,
                  d_ff=cfg.moe.dense_d_ff) for _ in range(k)) if k else None
        self.layers = nn.ModuleList(
            Block(cfg, param_dtype, compute_dtype, dev,
                  moe_block=cfg.moe is not None)
            for _ in range(cfg.num_layers - k))
        self.final_norm = Norm(cfg.d_model, cfg.norm, param_dtype, dev)
        # the untied unembedding [vocab, d_model] (the reference's
        # ``params["lm_head"]["table"]``); tied models unembed with the
        # embedding table
        self.lm_head = None if cfg.tie_embeddings else Embedding(
            cfg.vocab_size, cfg.d_model, param_dtype, dev)
        if quant == "int8":
            # expert and router leaves are not named kernel: they stay
            # float, as in the reference
            for name, prm in list(self.named_parameters()):
                leaf = serve_quant.eligible(name, prm.shape,
                                            len(self.layers), quant_min_size)
                if leaf is not None:
                    _to_int8(self.get_submodule(name.rpartition(".")[0]),
                             leaf)

    @classmethod
    def from_spec(cls, spec, device=None) -> "Model":
        """The model a ``core.spec.RuntimeSpec`` describes."""
        ex = spec.execution
        return cls(spec.arch, param_dtype=ex.param_dtype,
                   compute_dtype=ex.compute_dtype,
                   matmul_backend=ex.matmul_backend,
                   paged_attn_impl=ex.paged_attn_impl, quant=ex.quant,
                   quant_min_size=ex.quant_min_size,
                   kv_dtype=spec.memory.kv_dtype, device=device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights at the reference ``ParamBuilder``'s scales: dense
        kernels, the router and the experts normal / sqrt(fan_in) with
        fan_in = ``shape[-2]`` (d for an expert leaf ``[E, d, f]``), the
        embedding normal * 0.02, the untied ``lm_head`` table normal /
        sqrt(vocab) (the reference builds it with no scale, so its fan-in
        rule reads the table's first dim), biases zero, norm scales one.
        Draws come from ``generator`` on its own device, in the order of
        ``named_parameters``, rounded to the parameter dtype before any
        cast to the storage dtype (or before quantization, for an int8
        leaf)."""
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                prm.zero_()
            elif leaf == "scale":
                prm.fill_(1.0)
            else:
                std = 0.02 if name == "embed.table" \
                    else 1.0 / math.sqrt(max(prm.shape[-2], 1))
                x = torch.randn(prm.shape, generator=generator,
                                device=generator.device) * std
                if prm.dtype == torch.int8:
                    q = serve_quant.quantize_leaf(x.to(self.param_dtype), leaf)
                    prm.copy_(q.values)
                    self.get_buffer(name + serve_quant.SCALE_SUFFIX).copy_(
                        q.scale)
                else:
                    prm.copy_(x.to(self.param_dtype))
                # free the draw before the next one: at deepseek-v3's width
                # an expert leaf's float32 draw is 15 GB
                del x
        return self

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict``; a model serving int8 weights
        quantizes the float leaves it holds as int8 first
        (``core.serve_quant.quantize_params``; int8 leaves with their
        scales pass through)."""
        if self.quant == "int8":
            state_dict = serve_quant.quantize_params(state_dict,
                                                     self.quant_min_size)
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def init_cache(self, paging: PagingConfig) -> KVCache | MLACache:
        """The paged KV pool ``[layers, num_blocks + 1, block_size, kv, hd]``
        through the model's codec (pool row 0 is the null block): bf16
        values as the reference's float codec stores them, or int8 values
        with float32 ``k_scale``/``v_scale`` ``[layers, num_blocks + 1,
        block_size, kv]``.  An MLA model's pool is the latent pool
        ``[layers, num_blocks + 1, block_size, rank]`` and ``[..., rope]``
        (int8: scales ``[layers, num_blocks + 1, block_size]``)."""
        cfg = self.cfg
        if cfg.mla is not None:
            lead = (cfg.num_layers, paging.pool_blocks, paging.block_size)
            return MLACache(*self._latents(self.codec, lead))
        shape = (cfg.num_layers, paging.pool_blocks, paging.block_size,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        k, k_scale = self.codec.cache_tensors(shape, self.device)
        v, v_scale = self.codec.cache_tensors(shape, self.device)
        return KVCache(k, v, k_scale, v_scale)

    def _latents(self, codec: CacheCodec, lead: tuple[int, ...]) -> tuple:
        """(c_kv, k_rope, c_scale, r_scale) of an MLA cache whose leading
        dims are ``lead``."""
        m = self.cfg.mla
        c, cs = codec.cache_tensors((*lead, m.kv_lora_rank), self.device)
        r, rs = codec.cache_tensors((*lead, m.qk_rope_head_dim), self.device)
        return c, r, cs, rs

    def init_dense_cache(self, batch: int, max_len: int) -> KVCache | MLACache:
        """The dense per-slot cache ``[layers, batch, max_len + 1, kv, hd]``
        of a speculation draft (an MLA model's: the latents ``[layers,
        batch, max_len + 1, rank | rope]``): the float codec's storage
        (bf16, as the reference's dense cache), never int8 and never
        paged.  Row ``max_len`` is a spare that takes the writes of dead
        lanes and of positions past the end; no mask admits it."""
        cfg = self.cfg
        if cfg.mla is not None:
            return MLACache(*self._latents(FLOAT_CODEC,
                                           (cfg.num_layers, batch,
                                            max_len + 1)))
        shape = (cfg.num_layers, batch, max_len + 1, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        k, _ = FLOAT_CODEC.cache_tensors(shape, self.device)
        v, _ = FLOAT_CODEC.cache_tensors(shape, self.device)
        return KVCache(k, v)

    # ------------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed(tokens, _weight(self.embed, "table"),
                            self.compute_dtype)

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = layers.apply_norm(x, self.final_norm, self.cfg.norm,
                              self.matmul_backend)
        head = self.embed if self.lm_head is None else self.lm_head
        return layers.unembed(x, _weight(head, "table"))

    def _ffn_half(self, h: torch.Tensor, blk: Block) -> torch.Tensor:
        hn = layers.apply_norm(h, blk.ln2, self.cfg.norm,
                               self.matmul_backend)
        if hasattr(blk, "moe"):
            return h + moe.apply_moe(hn, blk.moe, self.cfg,
                                     self.matmul_backend)
        return h + moe.apply_ffn(hn, blk.ffn, self.cfg.activation,
                                 self.matmul_backend)

    def blocks(self) -> list[Block]:
        """Every layer in cache order: the dense prefix, then the main
        stack."""
        return [*(self.dense_prefix or ()), *self.layers]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward: tokens [B, S] -> logits [B, S, V]
        (float32)."""
        b_, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, device=tokens.device)[None, :] \
            .expand(b_, s)
        for blk in self.blocks():
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm,
                                   self.matmul_backend)
            fn = attn.gqa_attention if self.cfg.mla is None \
                else attn.mla_attention
            x = x + fn(hn, blk.attn, self.cfg, positions, self.matmul_backend)
            x = self._ffn_half(x, blk)
        return self._unembed(x)

    @torch.no_grad()
    def decode_step(self, cache: KVCache, tokens: torch.Tensor,
                    cache_index: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
        """tokens [B, 1] at per-slot positions ``cache_index`` [B] ->
        logits [B, 1, V]; the new K/V rows are written into ``cache`` in
        place."""
        x = self._embed(tokens)
        for i, blk in enumerate(self.blocks()):
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm,
                                   self.matmul_backend)
            if self.cfg.mla is not None:
                # the reference attends MLA through its gather route only
                o = attn.mla_decode_paged(
                    hn, blk.attn, self.cfg, cache.layer(i), cache_index,
                    block_tables, mm=self.matmul_backend, codec=self.codec)
            else:
                o = attn.gqa_decode_paged(
                    hn, blk.attn, self.cfg, cache.layer(i), cache_index,
                    block_tables, impl=self.paged_attn_impl,
                    mm=self.matmul_backend, codec=self.codec)
            x = x + o
            x = self._ffn_half(x, blk)
        return self._unembed(x)

    @torch.no_grad()
    def mixed_step(self, cache: KVCache, tokens: torch.Tensor,
                   start: torch.Tensor, n_live: torch.Tensor,
                   block_tables: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """Chunked-prefill/decode mixed step: tokens [B, W] -> logits
        [B, W, V].  Lane ``l`` of slot ``b`` sits at position
        ``start[b] + l``; only the first ``n_live[b]`` lanes are real (a
        decoding slot uses one, a prefilling slot up to a chunk, an idle
        slot none).  The cache is updated in place: the paged pool through
        ``block_tables``, or with ``block_tables=None`` the dense cache of
        ``init_dense_cache`` (a speculation draft's)."""
        x = self._embed(tokens)
        for i, blk in enumerate(self.blocks()):
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm,
                                   self.matmul_backend)
            if self.cfg.mla is not None and block_tables is None:
                o = attn.mla_mixed(hn, blk.attn, self.cfg, cache.layer(i),
                                   start, n_live, mm=self.matmul_backend)
            elif self.cfg.mla is not None:
                o = attn.mla_mixed_paged(
                    hn, blk.attn, self.cfg, cache.layer(i), start, n_live,
                    block_tables, mm=self.matmul_backend, codec=self.codec)
            elif block_tables is None:
                o = attn.gqa_mixed(hn, blk.attn, self.cfg, cache.layer(i),
                                   start, n_live, mm=self.matmul_backend)
            else:
                o = attn.gqa_mixed_paged(
                    hn, blk.attn, self.cfg, cache.layer(i), start, n_live,
                    block_tables, impl=self.paged_attn_impl,
                    mm=self.matmul_backend, codec=self.codec)
            x = x + o
            x = self._ffn_half(x, blk)
        return self._unembed(x)
