"""The model of the port (the reference's ``Model`` for the families
``dense``, ``vlm``, ``moe``, ``ssm``, ``hybrid``, ``audio`` and
``encoder``, with GQA or MLA attention, or none):
parameters, the paged KV pool and the dense per-slot cache, ``forward``,
``prefill``, ``decode_step`` and ``mixed_step``, and the training
``loss`` (``Model(..., trainable=True)``; ``training/``).  A model with
learned positions (``positional="learned"``) holds ``pos_embed.table``
``[max_position_embeddings, d_model]`` and adds row ``min(p,
max_position_embeddings - 1)`` to the embedding of position ``p``.

The vlm family is the dense family's parameters and compute with a stub
vision frontend (``cfg.frontend``): the first ``num_tokens`` positions of
a prompt carry precomputed patch embeddings (``forward`` / ``prefill``'s
``frontend`` [B, n, d_model]; zeros in serving) in place of their token
embeddings, and a mixed step zeroes the prompt lanes below
``num_tokens`` (``prefill_lanes``), as the reference's stub does.

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
in place of K/V, paged or dense alike.

The hybrid family (``cfg.hybrid``, RecurrentGemma) repeats its block
pattern over depth: an ``"r"`` layer holds the RG-LRU block
``layers.<i>.rglru.{in_x, in_gate, conv_w, conv_b, gate_in_w, gate_in_b,
gate_a_w, gate_a_b, a_param, out}`` (``models/rglru.py``), an ``"a"``
layer local attention ``layers.<i>.attn.{wq,wk,wv,wo}`` over a window;
both have ``ln1``, ``ln2`` and the FFN.  The reference keeps these layers
as a list, not stacked, so the size rule of int8 weights measures each
leaf alone.  Its decode state (``HybridCache``) stacks each kind's leaves:
the conv windows and h of the RG-LRU layers and the rolling K/V buffers
of the attention layers, dense only (the reference never pages it) and
never quantized; the bucketed prefill takes each prompt's real length
(``lengths``), so the pad up to its bucket leaves every state as the
unpadded prompt would.

The ssm family (``cfg.ssm``, falcon-mamba) has no attention and no FFN:
each layer is ``layers.<i>.ln`` and the Mamba-1 block
``layers.<i>.ssm.{in_proj, conv_w, conv_b, x_proj, dt_proj, a_log,
d_skip, out_proj}`` (``models/ssm.py``), stacked in the reference as the
dense family's are.  Its decode state is an ``SSMState`` with a leading
layer axis, dense only and never quantized; the bucketed prefill takes
each prompt's real length (``lengths``), as the hybrid's does.

The encoder family (the paper's networks: adaptor-bert,
shallow-transformer, custom-encoder) has the dense family's layers, with
biased FFNs under its ``layernorm`` and learned positions, and attends
without a causal mask (the reference's ``_is_causal``).  Its q/k/v width
is ``num_heads * resolved_head_dim`` (custom-encoder: 3 heads of 200 // 3
= 66, so 198), not ``d_model``.  It runs ``forward`` only: ``prefill``,
``decode_step`` and ``mixed_step`` raise the reference engine's refusal,
"encoder-only archs have no decode step".

The audio family (``cfg.encdec``, Whisper) is an encoder-decoder over the
stub frontend's frames (``frontend`` [B, encoder_seq_len, d_model]; zeros
in serving): the encoder adds ``enc_pos_embed.table`` to the frames and
runs ``enc_layers.<i>.`` (the dense layer, its attention non-causal),
then ``enc_final_norm``; each decoder layer ``layers.<i>.`` holds
``ln_cross`` and ``cross.{wq,wk,wv,wo}`` between its self-attention and
its FFN, and attends from its queries over K/V projected from the
encoder's output.  Its decode state is an ``EncDecCache``, dense only and
never quantized: the decoder's self K/V and the cross K/V of the
request's frames, computed once in the prefill.  In a serving model dense
kernels (``[d_in, d_out]``,
as the reference stores them), their biases and the expert weights are
kept in the compute dtype, cast once from the parameter dtype (the
reference casts them to x's dtype on every call: the same numbers);
norm scales, the router, the embedding table and MLA's ``k_up`` stay in
the parameter dtype, since the norms, the router, ``unembed`` and the
absorbed MLA query read them in float32.  A trainable model keeps every
leaf in the parameter dtype and casts on every call, as the reference.

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

import functools
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (DEFAULT_COMPUTE_DTYPE,
                                      DEFAULT_PARAM_DTYPE, ArchConfig)
from repro_torch.core import serve_quant
from repro_torch.core.kv_quant import FLOAT_CODEC, CacheCodec
from repro_torch.core.paging import PagingConfig
from repro_torch.core.quant import DEFAULT_QUANT_MIN_SIZE, QTensor
from repro_torch.core.spec import (CHUNKABLE_FAMILIES,
                                   KV_QUANTIZABLE_FAMILIES, PORTED_FAMILIES,
                                   check_encdec)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, rglru, ssm
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.rglru import LRUState
from repro_torch.models.ssm import SSMState

# RG-LRU and SSM leaves the init draws as the reference's ParamBuilder
# does: biases zero, the SSM's a_log and D skip ones, the RG-LRU's decay
# parameter uniform in [-1, 1)
_ZERO_LEAVES = ("bias", "conv_b", "gate_in_b", "gate_a_b")
_ONE_LEAVES = ("scale", "a_log", "d_skip")
# the reference engine's refusal of the encoder family, which the
# encoder's decode entry points give too
NO_DECODE = "encoder-only archs have no decode step"
# the training loss's extra terms at the reference's ModelOptions defaults
MTP_LOSS_WEIGHT = 0.3
MOE_AUX_WEIGHT = 0.01
REMAT_MODES = ("none", "full", "dots")
# what "dots" saves: the outputs of the matrix products (the counterpart
# of jax's dots_with_no_batch_dims_saveable); the rest is recomputed
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _check_trainable(cfg: ArchConfig, matmul_backend: str,
                     quant: str) -> None:
    """What a trainable model refuses, each with its reason."""
    if quant != "none":
        raise ValueError(f"{cfg.name}: training takes float weights, not "
                         f"quant={quant!r} (int8 weights are a serving "
                         "format)")
    if matmul_backend != "xla":
        raise ValueError(
            f"{cfg.name}: training runs matmul_backend='xla' only: no "
            "hand-written kernel of the products or the norms has a "
            "backward, and no Pallas kernel of the reference has a VJP")


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
    """``kernel`` [d_in, d_out] and its optional ``bias``; ``axes`` are the
    kernel's logical axis names (the reference's ``build_dense``), the
    bias taking the output's."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device,
                 axes: tuple):
        super().__init__()
        self.kernel = _frozen((d_in, d_out), dtype, device)
        self.bias = _frozen((d_out,), dtype, device) if bias else None
        self.axes = {"kernel": axes, "bias": axes[1:]}


class Norm(nn.Module):
    def __init__(self, d: int, kind: str, dtype, device,
                 axis: str = "embed"):
        super().__init__()
        self.scale = _frozen((d,), dtype, device)
        self.bias = _frozen((d,), dtype, device) if kind == "layernorm" \
            else None
        self.axes = {"scale": (axis,), "bias": (axis,)}


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        self.wq = Dense(d, h * hd, cfg.qkv_bias, dtype, device,
                        ("embed", "heads"))
        self.wk = Dense(d, kv * hd, cfg.qkv_bias, dtype, device,
                        ("embed", "kv_heads"))
        self.wv = Dense(d, kv * hd, cfg.qkv_bias, dtype, device,
                        ("embed", "kv_heads"))
        self.wo = Dense(h * hd, d, False, dtype, device, ("heads", "embed"))


class MLAttention(nn.Module):
    """Multi-head latent attention's projections (the reference's
    ``build_mla``; no biases).  ``k_up`` is kept in the parameter dtype:
    the absorbed attend reads it in float32, as the reference reads its
    float32 leaf."""

    def __init__(self, cfg: ArchConfig, param_dtype, dtype, device):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        self.q_down = Dense(d, m.q_lora_rank, False, dtype, device,
                            ("embed", "q_lora"))
        self.q_norm = Norm(m.q_lora_rank, "rmsnorm", param_dtype, device,
                           "q_lora")
        self.q_up = Dense(m.q_lora_rank, h * m.qk_head_dim, False, dtype,
                          device, ("q_lora", "heads"))
        self.kv_down = Dense(d, m.kv_lora_rank + m.qk_rope_head_dim, False,
                             dtype, device, ("embed", "kv_lora"))
        self.kv_norm = Norm(m.kv_lora_rank, "rmsnorm", param_dtype, device,
                            "kv_lora")
        self.k_up = Dense(m.kv_lora_rank, h * m.qk_nope_head_dim, False,
                          param_dtype, device, ("kv_lora", "heads"))
        self.v_up = Dense(m.kv_lora_rank, h * m.v_head_dim, False, dtype,
                          device, ("kv_lora", "heads"))
        self.wo = Dense(h * m.v_head_dim, d, False, dtype, device,
                        ("heads", "embed"))


class RGLRU(nn.Module):
    """The RG-LRU block's weights (the reference's ``build_rglru``): the
    value and gate branches and the output as ``Dense`` projections (no
    biases), the conv taps ``[4, w]`` and bias, the block-diagonal gates
    ``[heads, w / heads, w / heads]`` and biases, in the compute dtype, as
    the reference casts them to x's dtype; ``a_param`` ``[w]`` in the
    parameter dtype, read in float32."""

    def __init__(self, cfg: ArchConfig, param_dtype, dtype, device):
        super().__init__()
        d, w = cfg.d_model, rglru.width(cfg)
        nh = max(cfg.num_heads, 1)
        self.in_x = Dense(d, w, False, dtype, device, ("embed", "lru"))
        self.in_gate = Dense(d, w, False, dtype, device, ("embed", "lru"))
        self.conv_w = _frozen((rglru.CONV_K, w), dtype, device)
        self.conv_b = _frozen((w,), dtype, device)
        self.gate_in_w = _frozen((nh, w // nh, w // nh), dtype, device)
        self.gate_in_b = _frozen((w,), dtype, device)
        self.gate_a_w = _frozen((nh, w // nh, w // nh), dtype, device)
        self.gate_a_b = _frozen((w,), dtype, device)
        self.a_param = _frozen((w,), param_dtype, device)
        self.out = Dense(w, d, False, dtype, device, ("lru", "embed"))
        gate = ("heads", None, "lru")
        self.axes = {"conv_w": (None, "lru"), "conv_b": ("lru",),
                     "gate_in_w": gate, "gate_in_b": ("lru",),
                     "gate_a_w": gate, "gate_a_b": ("lru",),
                     "a_param": ("lru",)}


class SSM(nn.Module):
    """The Mamba-1 block's weights (the reference's ``build_ssm``): the
    four projections as ``Dense`` ones (``dt_proj`` with its bias), the
    conv taps ``[K, d_inner]`` and bias in the compute dtype, as the
    reference casts them to x's dtype; ``a_log`` ``[d_inner, state]`` and
    the D skip ``[d_inner]`` in the parameter dtype, read in float32."""

    def __init__(self, cfg: ArchConfig, param_dtype, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_inner, dt_rank, n = ssm.dims(cfg)
        self.in_proj = Dense(d, 2 * d_inner, False, dtype, device,
                             ("embed", "dinner"))
        self.conv_w = _frozen((cfg.ssm.conv_kernel, d_inner), dtype, device)
        self.conv_b = _frozen((d_inner,), dtype, device)
        self.x_proj = Dense(d_inner, dt_rank + 2 * n, False, dtype, device,
                            ("dinner", None))
        self.dt_proj = Dense(dt_rank, d_inner, True, dtype, device,
                             (None, "dinner"))
        self.a_log = _frozen((d_inner, n), param_dtype, device)
        self.d_skip = _frozen((d_inner,), param_dtype, device)
        self.out_proj = Dense(d_inner, d, False, dtype, device,
                              ("dinner", "embed"))
        self.axes = {"conv_w": (None, "dinner"), "conv_b": ("dinner",),
                     "a_log": ("dinner", "state"), "d_skip": ("dinner",)}


class SSMBlock(nn.Module):
    """An ssm-family layer: the norm ``ln`` and the Mamba-1 block."""

    def __init__(self, cfg: ArchConfig, param_dtype, compute_dtype, device):
        super().__init__()
        self.ln = Norm(cfg.d_model, cfg.norm, param_dtype, device)
        self.ssm = SSM(cfg, param_dtype, compute_dtype, device)


class HybridCache(NamedTuple):
    """The hybrid family's decode state, each kind's leaves stacked: the
    RG-LRU layers' conv windows ``[n_r, B, 3, w]`` (bf16) and states ``h``
    ``[n_r, B, w]`` (float32), the local-attention layers' rolling K and V
    ``[n_a, B, min(window, max_len), kv, hd]`` (bf16).  ``lru(j)`` and
    ``attn(j)`` are the j-th layer of a kind, as views."""

    conv: torch.Tensor
    h: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor

    def lru(self, j: int) -> LRUState:
        return LRUState(self.conv[j], self.h[j])

    def attn(self, j: int) -> KVCache:
        return KVCache(self.k[j], self.v[j])


class EncDecCache(NamedTuple):
    """The audio family's decode state, bf16 at any compute dtype (the
    reference's rule): each decoder layer's self K and V ``[L, B, max_len
    + 1, kv, hd]`` (row ``max_len`` the dense layout's spare) and its
    cross K and V ``[L, B, encoder_seq_len, kv, hd]``, projected from the
    encoder's output once per request.  ``self_attn(i)`` and ``cross(i)``
    are layer i's as views."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor

    def self_attn(self, i: int) -> KVCache:
        return KVCache(self.self_k[i], self.self_v[i])

    def cross(self, i: int) -> KVCache:
        return KVCache(self.cross_k[i], self.cross_v[i])


class FFN(nn.Module):
    def __init__(self, cfg: ArchConfig, d_ff: int, bias: bool, dtype,
                 device):
        super().__init__()
        self.w1 = Dense(cfg.d_model, d_ff, bias, dtype, device,
                        ("embed", "ffn"))
        self.wg = Dense(cfg.d_model, d_ff, bias, dtype, device,
                        ("embed", "ffn")) \
            if layers.is_gated(cfg.activation) else None
        self.w2 = Dense(d_ff, cfg.d_model, bias, dtype, device,
                        ("ffn", "embed"))


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
        self.axes = {"router": ("embed", "experts"),
                     "w1": ("experts", "embed", "ffn"),
                     "wg": ("experts", "embed", "ffn"),
                     "w2": ("experts", "ffn", "embed")}


class Block(nn.Module):
    """A decoder (or encoder) layer: the dense FFN of width ``d_ff`` (with
    biases in a layernorm model, as the paper's FFN) or, with ``moe``,
    the MoE block; a hybrid model's ``"r"`` layer mixes with the RG-LRU
    block in place of attention; an enc-dec decoder's layer (``cross``)
    has ``ln_cross`` and the cross-attention's projections between its
    attention and its FFN."""

    def __init__(self, cfg: ArchConfig, param_dtype, compute_dtype, device,
                 d_ff: int | None = None, moe_block: bool = False,
                 kind: str = "a", cross: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, param_dtype, device)
        if kind == "r":
            self.rglru = RGLRU(cfg, param_dtype, compute_dtype, device)
        elif cfg.mla is not None:
            self.attn = MLAttention(cfg, param_dtype, compute_dtype, device)
        else:
            self.attn = Attention(cfg, compute_dtype, device)
        if cross:
            self.ln_cross = Norm(cfg.d_model, cfg.norm, param_dtype, device)
            self.cross = Attention(cfg, compute_dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, param_dtype, device)
        if moe_block:
            self.moe = MoE(cfg, param_dtype, compute_dtype, device)
        else:
            self.ffn = FFN(cfg, cfg.d_ff if d_ff is None else d_ff,
                           cfg.norm == "layernorm", compute_dtype, device)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device,
                 axes: tuple = ("vocab", "embed")):
        super().__init__()
        self.table = _frozen((vocab, d), dtype, device)
        self.axes = {"table": axes}


class MTP(nn.Module):
    """DeepSeek-V3's multi-token-prediction head, depth 1 (the reference's
    ``_build_mtp``): ``proj`` ``[2 d, d]`` over the normed hidden state
    (``norm_h``) beside the normed embedding of the next token
    (``norm_e``), then one MoE ``layer``.  Training only: serving never
    reads it."""

    def __init__(self, cfg: ArchConfig, param_dtype, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.proj = Dense(2 * d, d, False, dtype, device, ("embed", "embed"))
        self.norm_h = Norm(d, cfg.norm, param_dtype, device)
        self.norm_e = Norm(d, cfg.norm, param_dtype, device)
        self.layer = Block(cfg, param_dtype, dtype, device, moe_block=True)


class Model(nn.Module):
    """A dense-, vlm-, MoE-, ssm-, hybrid- or audio-family causal LM (the
    audio family's decoder over its encoder's output), or an
    encoder-family network (non-causal, ``forward`` only).

    ``matmul_backend`` ("xla" | "pallas") and ``paged_attn_impl``
    ("gather" | "pallas") select the plain PyTorch paths or the
    hand-written kernels; ``quant`` ("none" | "int8") the serving weights
    and ``kv_dtype`` ("compute" | "int8") the KV pool's codec.
    ``device=None`` resolves to the CUDA device and raises without one;
    pass ``device="cpu"`` for the host.

    ``trainable=True`` builds the model ``loss`` trains: every float leaf
    an f32 master (``param_dtype``) with ``requires_grad``, cast to the
    compute dtype on every call as the reference casts it, and, for an
    MoE model with ``num_mtp_modules``, the multi-token-prediction head
    ``mtp.{proj, norm_h, norm_e, layer}`` (the reference's
    ``_build_mtp``; its parameters come last, so ``init`` draws every
    other leaf as for serving).  It refuses int8 weights and the
    ``"pallas"`` backend (no matmul or norm kernel has a backward).  The
    ssm and hybrid families train through their scans' backward kernels
    (``kernels/ssm_scan.py``, ``kernels/rglru_scan.py``), which run on
    any CUDA tensor whatever the backend.  ``remat`` ("none" | "full" |
    "dots") recomputes each layer in the backward: all of it, or all but
    its matrix products (the reference's
    ``dots_with_no_batch_dims_saveable``).
    """

    def __init__(self, cfg: ArchConfig, *, param_dtype=DEFAULT_PARAM_DTYPE,
                 compute_dtype=DEFAULT_COMPUTE_DTYPE, matmul_backend: str = "xla",
                 paged_attn_impl: str = "gather", quant: str = "none",
                 quant_min_size: int = DEFAULT_QUANT_MIN_SIZE,
                 kv_dtype: str = "compute", device=None,
                 trainable: bool = False, remat: str = "none"):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat={remat!r} is not one of {REMAT_MODES}")
        if trainable:
            _check_trainable(cfg, matmul_backend, quant)
        # a serving model stores its dense kernels in the compute dtype,
        # a trainable one its f32 masters
        store = param_dtype if trainable else compute_dtype
        if cfg.family not in PORTED_FAMILIES \
                or (cfg.family == "moe") != (cfg.moe is not None) \
                or (cfg.family == "ssm") != (cfg.ssm is not None) \
                or (cfg.family == "hybrid") != (cfg.hybrid is not None):
            raise ValueError(
                f"{cfg.name}: the port's Model serves the families "
                f"{PORTED_FAMILIES} (an moe config with its MoEConfig, an "
                "ssm one with its SSMConfig, a hybrid one with its "
                "HybridConfig) (ROADMAP.md Queue 1 items 11-12)")
        check_encdec(cfg)
        cfg.validate()
        if quant not in ("none", "int8"):
            raise ValueError(f"quant={quant!r} is not one of ('none', 'int8')")
        if quant == "int8":
            serve_quant.check_mla_quant(cfg, quant_min_size)
            serve_quant.check_position_quant(cfg, quant_min_size)
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
        # learned positions: the decoder's table (and an encoder's below)
        self.pos_embed = Embedding(cfg.max_position_embeddings, cfg.d_model,
                                   param_dtype, dev, ("pos", "embed")) \
            if cfg.positional == "learned" else None
        # an MoE model: the dense prefix, then the MoE blocks
        k = cfg.moe.first_k_dense if cfg.moe is not None else 0
        self.dense_prefix = nn.ModuleList(
            Block(cfg, param_dtype, store, dev,
                  d_ff=cfg.moe.dense_d_ff) for _ in range(k)) if k else None
        # a hybrid model's layers: (kind, index among that kind's layers)
        self.kinds: list[tuple[str, int]] = []
        if cfg.hybrid is not None:
            pat = cfg.hybrid.pattern
            for i in range(cfg.num_layers):
                kind = pat[i % len(pat)]
                self.kinds.append((kind, sum(kd == kind
                                             for kd, _ in self.kinds)))
        self.window = cfg.hybrid.attention_window if cfg.hybrid else None
        self.layers = nn.ModuleList(
            SSMBlock(cfg, param_dtype, store, dev)
            if cfg.ssm is not None else
            Block(cfg, param_dtype, store, dev,
                  moe_block=cfg.moe is not None,
                  kind=self.kinds[i][0] if self.kinds else "a",
                  cross=cfg.encdec is not None)
            for i in range(cfg.num_layers - k))
        self.final_norm = Norm(cfg.d_model, cfg.norm, param_dtype, dev)
        # an enc-dec model's encoder: its layers (non-causal attention),
        # final norm and frame position table
        self.enc_layers = self.enc_final_norm = self.enc_pos_embed = None
        if cfg.encdec is not None:
            self.enc_layers = nn.ModuleList(
                Block(cfg, param_dtype, store, dev)
                for _ in range(cfg.encdec.num_encoder_layers))
            self.enc_final_norm = Norm(cfg.d_model, cfg.norm, param_dtype,
                                       dev)
            self.enc_pos_embed = Embedding(cfg.encdec.encoder_seq_len,
                                           cfg.d_model, param_dtype, dev,
                                           ("pos", "embed"))
        # the untied unembedding [vocab, d_model] (the reference's
        # ``params["lm_head"]["table"]``); tied models unembed with the
        # embedding table
        self.lm_head = None if cfg.tie_embeddings else Embedding(
            cfg.vocab_size, cfg.d_model, param_dtype, dev)
        self.trainable, self.remat = trainable, remat
        self.mtp = MTP(cfg, param_dtype, store, dev) \
            if trainable and cfg.moe is not None and cfg.num_mtp_modules \
            else None
        if trainable:
            self.requires_grad_(True)
        if quant == "int8":
            # expert and router leaves are not named kernel: they stay
            # float, as in the reference
            for name, prm in list(self.named_parameters()):
                leaf = serve_quant.eligible(
                    name, prm.shape, self._stacked_layers(), quant_min_size,
                    len(self.enc_layers or ()))
                if leaf is not None:
                    _to_int8(self.get_submodule(name.rpartition(".")[0]),
                             leaf)

    def axes(self) -> dict[str, tuple]:
        """The logical axis names of every parameter leaf, by its name in
        the state dict (the reference's ``ParamBuilder`` "axes" mode under
        the port's names: one module per layer, so no leading "layers"
        axis).  ``distributed.sharding.resolve_spec`` maps them to a mesh;
        an int8 leaf's scale takes ``serve_quant.scale_axes``."""
        out = {}
        for name, _ in self.named_parameters():
            owner, _, leaf = name.rpartition(".")
            out[name] = self.get_submodule(owner).axes[leaf]
        return out

    def _stacked_layers(self) -> int:
        """What the int8 size rule multiplies a ``layers.<i>.`` leaf by:
        the layers the reference stacks into one leaf, or 1 for a hybrid
        model, whose layers it keeps as a list of unstacked leaves."""
        return 1 if self.cfg.hybrid is not None else len(self.layers)

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
        rule reads the table's first dim), biases zero, norm scales one;
        the RG-LRU's and the SSM's conv taps normal / sqrt(K) and the
        RG-LRU's gates by the fan-in rule (their contraction dim),
        ``a_param`` uniform in [-1, 1), the SSM's ``a_log`` and D skip
        one.
        Draws come from ``generator`` on its own device, in the order of
        ``named_parameters``, rounded to the parameter dtype before any
        cast to the storage dtype (or before quantization, for an int8
        leaf)."""
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZERO_LEAVES:
                prm.zero_()
            elif leaf in _ONE_LEAVES:
                prm.fill_(1.0)
            elif leaf == "a_param":
                x = torch.rand(prm.shape, generator=generator,
                               device=generator.device) * 2 - 1
                prm.copy_(x.to(self.param_dtype))
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
        scales pass through).  A model without the MTP head drops the
        ``mtp.*`` leaves a trained model or the bridge carries."""
        if self.mtp is None and any(k.startswith("mtp.") for k in state_dict):
            state_dict = {k: v for k, v in state_dict.items()
                          if not k.startswith("mtp.")}
        if self.quant == "int8":
            state_dict = serve_quant.quantize_params(
                state_dict, self.quant_min_size, self._stacked_layers())
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def init_cache(self, paging: PagingConfig | None = None, *,
                   batch: int = 0, max_len: int = 0
                   ) -> KVCache | MLACache | HybridCache | SSMState:
        """The decode cache through the model's codec: bf16 values as the
        reference's float codec stores them, or int8 values with float32
        scales (the values' shape without the last dim).

        With ``paging`` the paged pool ``[layers, num_blocks + 1,
        block_size, kv, hd]`` (pool row 0 is the null block); an MLA
        model's is the latent pool ``[layers, num_blocks + 1, block_size,
        rank]`` and ``[..., rope]``.  Without it the dense per-slot layout
        ``[layers, batch, max_len + 1, ...]`` (``init_dense_cache``; a
        hybrid model's ``HybridCache`` or an ssm model's ``SSMState``, which
        have no paged layout)."""
        if paging is None:
            return self.init_dense_cache(batch, max_len, self.codec)
        cfg = self.cfg
        if cfg.family not in ("dense", "vlm", "moe"):
            raise ValueError(
                f"paged KV cache unsupported for family {cfg.family!r} "
                "(SSM / rolling-window / enc-dec state is not paged)")
        lead = (cfg.num_layers, paging.pool_blocks, paging.block_size)
        if cfg.mla is not None:
            return MLACache(*self._latents(self.codec, lead))
        return self._kv(self.codec, lead)

    def _kv(self, codec: CacheCodec, lead: tuple[int, ...]) -> KVCache:
        shape = (*lead, self.cfg.num_kv_heads, self.cfg.resolved_head_dim)
        k, k_scale = codec.cache_tensors(shape, self.device)
        v, v_scale = codec.cache_tensors(shape, self.device)
        return KVCache(k, v, k_scale, v_scale)

    def _latents(self, codec: CacheCodec, lead: tuple[int, ...]) -> tuple:
        """(c_kv, k_rope, c_scale, r_scale) of an MLA cache whose leading
        dims are ``lead``."""
        m = self.cfg.mla
        c, cs = codec.cache_tensors((*lead, m.kv_lora_rank), self.device)
        r, rs = codec.cache_tensors((*lead, m.qk_rope_head_dim), self.device)
        return c, r, cs, rs

    def init_dense_cache(self, batch: int, max_len: int,
                         codec: CacheCodec = FLOAT_CODEC
                         ) -> KVCache | MLACache | HybridCache | SSMState:
        """The dense per-slot cache ``[layers, batch, max_len + 1, kv, hd]``
        (an MLA model's: the latents ``[layers, batch, max_len + 1, rank |
        rope]``) through ``codec``; by default the float codec's bf16
        storage, as a speculation draft's cache always is.  Row ``max_len``
        is a spare that takes the writes of dead lanes and of positions
        past the end (the reference drops them as out-of-bounds
        scatters); no mask admits it.  A hybrid model's is its
        ``HybridCache`` (rolling buffers of ``min(window, max_len)`` rows,
        no spare row), an ssm model's its ``SSMState`` ``[layers, batch,
        ...]`` (no positions at all), an audio model's its ``EncDecCache``
        (self rows as above, ``encoder_seq_len`` cross rows); no codec
        quantizes these."""
        if self.cfg.family not in KV_QUANTIZABLE_FAMILIES \
                and codec.quantized:
            # the reference's refusal of an int8 cache for recurrent state
            raise ValueError(
                f"kv_dtype='int8' is unsupported for family "
                f"{self.cfg.family!r} (only KV/latent attention caches are "
                "quantized); use kv_dtype='compute'")
        if self.cfg.ssm is not None:
            return ssm.ssm_init_state(self.cfg, batch, self.device,
                                      (self.cfg.num_layers,))
        if self.cfg.hybrid is not None:
            return self._hybrid_cache(batch, max_len)
        if self.cfg.encdec is not None:
            return EncDecCache(*(torch.zeros(
                (self.cfg.num_layers, batch, rows, self.cfg.num_kv_heads,
                 self.cfg.resolved_head_dim), dtype=torch.bfloat16,
                device=self.device) for rows in (
                    max_len + 1, max_len + 1,
                    self.cfg.encdec.encoder_seq_len,
                    self.cfg.encdec.encoder_seq_len)))
        lead = (self.cfg.num_layers, batch, max_len + 1)
        if self.cfg.mla is not None:
            return MLACache(*self._latents(codec, lead))
        return self._kv(codec, lead)

    def _hybrid_cache(self, batch: int, max_len: int) -> HybridCache:
        cfg = self.cfg
        n_r = sum(kind == "r" for kind, _ in self.kinds)
        conv, h = rglru.rglru_init_state(cfg, batch, self.device, (n_r,))
        shape = (len(self.kinds) - n_r, batch,
                 min(cfg.hybrid.attention_window, max_len),
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        return HybridCache(conv, h, torch.zeros(shape, dtype=torch.bfloat16,
                                                device=self.device),
                           torch.zeros(shape, dtype=torch.bfloat16,
                                       device=self.device))

    # ------------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor,
               frontend: torch.Tensor | None = None,
               positions: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings in the compute dtype, plus a learned position
        table's rows at ``positions`` (broadcastable to tokens' shape;
        clamped to the table); for a decoder-only model with a stub
        frontend, positions below ``frontend.shape[1]`` take its rows
        (cast to the compute dtype) instead."""
        x = layers.embed(tokens, _weight(self.embed, "table"),
                         self.compute_dtype)
        if self.pos_embed is not None:
            idx = positions.clamp(max=self.cfg.max_position_embeddings - 1)
            x = x + self.pos_embed.table[idx.long()].to(x.dtype)
        if frontend is not None and self.cfg.frontend is not None \
                and self.cfg.encdec is None:
            n = min(frontend.shape[1], x.shape[1])
            x[:, :n] = frontend[:, :n].to(x.dtype)
        return x

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

    def _encode(self, frontend: torch.Tensor | None) -> torch.Tensor:
        """The encoder over the stub frontend's frames [B, encoder_seq_len,
        d_model]: frames in the compute dtype plus the frame position
        table, the layers (non-causal attention), the final norm (the
        reference's ``_encode``).  Raises where the frames do not fill the
        table (the reference fails there with a broadcast error)."""
        cfg, mm = self.cfg, self.matmul_backend
        want = cfg.encdec.encoder_seq_len
        if frontend is None or frontend.shape[1] != want:
            got = "none" if frontend is None else frontend.shape[1]
            raise ValueError(
                f"{cfg.name}: the encoder takes encoder_seq_len={want} "
                f"frames (its position table's rows) and was given {got}; "
                "pass frontend [B, encoder_seq_len, d_model] (a stub "
                "frontend of cfg.frontend.num_tokens frames must equal it)")
        x = frontend.to(self.compute_dtype) \
            + self.enc_pos_embed.table.to(self.compute_dtype)[None]
        positions = torch.arange(want, device=x.device)[None, :]
        for blk in self.enc_layers:
            x = self._remat(self._enc_layer, x, blk, positions)
        return layers.apply_norm(x, self.enc_final_norm, cfg.norm, mm)

    def _enc_layer(self, x: torch.Tensor, blk: Block,
                   positions: torch.Tensor) -> torch.Tensor:
        hn = layers.apply_norm(x, blk.ln1, self.cfg.norm, self.matmul_backend)
        return self._ffn_half(x + attn.gqa_attention(
            hn, blk.attn, self.cfg, positions, self.matmul_backend,
            causal=False), blk)

    def _cross_kv(self, blk: Block, enc: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """A decoder layer's cross K and V [B, encoder_seq_len, kv, hd]
        from the encoder's output, in the compute dtype."""
        b_, se, _ = enc.shape
        shape = (b_, se, self.cfg.num_kv_heads, self.cfg.resolved_head_dim)
        mm = self.matmul_backend
        return (layers.apply_dense(enc, blk.cross.wk, mm).reshape(shape),
                layers.apply_dense(enc, blk.cross.wv, mm).reshape(shape))

    def _cross_half(self, x: torch.Tensor, blk: Block, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
        """x plus the cross-attention of its ``ln_cross`` norm over the
        cross K/V [B, encoder_seq_len, kv, hd] (the reference's
        ``_cross_attend``: every frame visible, plain attention)."""
        cfg, mm = self.cfg, self.matmul_backend
        hn = layers.apply_norm(x, blk.ln_cross, cfg.norm, mm)
        b_, s, _ = hn.shape
        q = layers.apply_dense(hn, blk.cross.wq, mm).reshape(
            b_, s, cfg.num_heads, cfg.resolved_head_dim)
        n_rep = cfg.num_heads // cfg.num_kv_heads
        o = attn.full_attention(q, attn.repeat_kv(k, n_rep),
                                attn.repeat_kv(v, n_rep), causal=False)
        return x + layers.apply_dense(o.reshape(b_, s, -1), blk.cross.wo, mm)

    def blocks(self) -> list[Block]:
        """Every layer in cache order: the dense prefix, then the main
        stack."""
        return [*(self.dense_prefix or ()), *self.layers]

    def _no_decode(self) -> None:
        """An encoder has no decode state: its decode entry points raise
        the reference engine's refusal."""
        if self.cfg.family == "encoder":
            raise ValueError(f"{self.cfg.name}: {NO_DECODE}")

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                frontend: torch.Tensor | None = None) -> torch.Tensor:
        """Full-sequence forward, causal but in an encoder: tokens [B, S]
        (and, for the vlm family, the stub frontend's [B, n, d_model]; for
        the audio family the encoder's frames [B, encoder_seq_len,
        d_model]) -> logits [B, S, V] (float32)."""
        return self._unembed(self._backbone(tokens, frontend))

    def _backbone(self, tokens: torch.Tensor,
                  frontend: torch.Tensor | None) -> torch.Tensor:
        """Embed + every layer -> the hidden states before the final norm
        [B, S, d] (the reference's ``_backbone``), each layer through
        ``_remat``; ``forward`` reads it without grad, ``loss`` with."""
        b_, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :] \
            .expand(b_, s)
        x = self._embed(tokens, frontend, positions)
        if self.cfg.encdec is not None:
            enc = self._encode(frontend)
            for blk in self.layers:
                x = self._remat(self._cross_layer, x, blk, positions, enc)
            return x
        for blk in self.blocks():
            x = self._remat(self._layer, x, blk, positions)
        return x

    def _remat(self, fn, x: torch.Tensor, *args) -> torch.Tensor:
        """``fn(x, *args)``, one layer; with grad on and ``remat`` set,
        under ``torch.utils.checkpoint`` (non-reentrant): "full" keeps
        only the layer's input, "dots" also its matrix products."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return fn(x, *args)
        kw = {} if self.remat == "full" else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
        return checkpoint(fn, x, *args, use_reentrant=False, **kw)

    def _layer(self, x: torch.Tensor, blk, positions: torch.Tensor
               ) -> torch.Tensor:
        """One layer of the full-sequence pass: an ssm layer's Mamba-1
        block, or the mixer (RG-LRU, MLA or GQA attention, causal but in
        an encoder, banded over a hybrid's window) and the FFN half."""
        cfg, mm = self.cfg, self.matmul_backend
        if cfg.ssm is not None:
            return x + ssm.ssm_forward(
                layers.apply_norm(x, blk.ln, cfg.norm, mm), blk.ssm, cfg, mm)
        hn = layers.apply_norm(x, blk.ln1, cfg.norm, mm)
        if hasattr(blk, "rglru"):
            o = rglru.rglru_forward(hn, blk.rglru, cfg, mm)
        elif cfg.mla is not None:
            o = attn.mla_attention(hn, blk.attn, cfg, positions, mm)
        else:
            o = attn.gqa_attention(hn, blk.attn, cfg, positions, mm,
                                   window=self.window,
                                   causal=cfg.family != "encoder")
        return self._ffn_half(x + o, blk)

    def _cross_layer(self, x: torch.Tensor, blk: Block,
                     positions: torch.Tensor, enc: torch.Tensor
                     ) -> torch.Tensor:
        """An enc-dec decoder layer: self-attention, the cross-attention
        over K/V projected from the encoder's output ``enc``, the FFN."""
        hn = layers.apply_norm(x, blk.ln1, self.cfg.norm, self.matmul_backend)
        x = x + attn.gqa_attention(hn, blk.attn, self.cfg, positions,
                                   self.matmul_backend)
        return self._ffn_half(self._cross_half(
            x, blk, *self._cross_kv(blk, enc)), blk)

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training loss (the reference's ``Model.loss``) of ``batch``:
        ``tokens`` and ``targets`` [B, S] (and ``frontend`` for the vlm
        and audio families, as ``forward`` takes it) -> (total, aux).  The
        cross-entropy of the logits, plus for the MoE family
        ``MOE_AUX_WEIGHT`` x the router balance term of the main stack's
        first layer over the embeddings, plus with the MTP head
        ``MTP_LOSS_WEIGHT`` x its cross-entropy.  ``aux`` holds
        ``xent``, ``load_balance``, ``mtp`` (where they apply) and
        ``total``, as float32 scalars on the model's device."""
        return combine_loss(self.loss_terms(batch), self.cfg)

    def loss_terms(self, batch: dict) -> dict:
        """The parts ``combine_loss`` makes the loss of: ``xent``; for the
        MoE family ``balance``, the balance term's (f, p)
        (``moe.balance_stats``), which data-parallel replicas average
        before the product; with the MTP head ``mtp``."""
        tokens, targets = batch["tokens"], batch["targets"]
        frontend = batch.get("frontend")
        x = self._backbone(tokens, frontend)
        terms = {"xent": _xent(self._unembed(x), targets)}
        if self.cfg.family == "moe" and MOE_AUX_WEIGHT:
            b_, s = tokens.shape
            positions = torch.arange(s, device=tokens.device)[None, :] \
                .expand(b_, s)
            terms["balance"] = moe.balance_stats(
                self._embed(tokens, frontend, positions),
                self.layers[0].moe.router, self.cfg.moe)
        if self.mtp is not None:
            terms["mtp"] = self._mtp_loss(x, targets)
        return terms

    def _mtp_loss(self, x: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
        """Multi-token prediction, depth 1, over the backbone's hidden
        states ``x``: h_t beside the embedding of token t + 1, the
        projection, one MoE layer, the shared unembedding, the
        cross-entropy against token t + 2 (the reference's
        ``roll(targets, -1)``: the last position wraps to the first)."""
        cfg, mm, mp = self.cfg, self.matmul_backend, self.mtp
        b_, s = targets.shape
        positions = torch.arange(s, device=targets.device)[None, :] \
            .expand(b_, s)
        e = layers.embed(targets, self.embed.table, self.compute_dtype)
        h = torch.cat([layers.apply_norm(x, mp.norm_h, cfg.norm, mm),
                       layers.apply_norm(e, mp.norm_e, cfg.norm, mm)], dim=-1)
        h = self._layer(layers.apply_dense(h, mp.proj, mm), mp.layer,
                        positions)
        return _xent(self._unembed(h), torch.roll(targets, -1, dims=1))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                frontend: torch.Tensor | None = None,
                lengths: torch.Tensor | None = None
                ) -> tuple[torch.Tensor,
                           KVCache | MLACache | HybridCache | SSMState]:
        """Prompt -> (logits [B, S, V] float32, the dense cache ready at
        index S): ``forward``'s math, with every layer's K/V (an MLA
        model's latents) stored through the codec into a fresh dense cache
        ``[layers, B, max_len + 1, ...]`` (rows from S on zeros; row
        ``max_len`` the spare of ``init_dense_cache``).  The dense, vlm,
        moe and hybrid branches of the reference's ``prefill``, with the
        MoE dense prefix's layers first.

        ``lengths`` ([B] int32 on the device, or None for S each) are the
        real positions of prompts right-padded up to S (a bucket).  A
        hybrid or ssm model's state is then the unpadded prompt's, ready at
        index ``lengths``: the RG-LRU and the selective scan keep h and
        take their conv windows from the last real rows, the rolling
        buffers hold the last real positions.
        An attention cache needs nothing of it: its rows past a prompt's
        length stay behind every mask until decode writes them.

        An audio model encodes ``frontend`` first and returns an
        ``EncDecCache``: each layer's cross K/V in bf16, while its own
        cross-attend reads them unrounded, as the reference's prefill."""
        self._no_decode()
        b_, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :] \
            .expand(b_, s)
        x = self._embed(tokens, frontend, positions)
        if self.cfg.encdec is not None:
            return self._encdec_prefill(x, positions, max_len, frontend)
        if self.cfg.hybrid is not None:
            return self._hybrid_prefill(x, positions, max_len, lengths)
        if self.cfg.ssm is not None:
            return self._ssm_prefill(x, lengths)
        fn = attn.gqa_prefill if self.cfg.mla is None else attn.mla_prefill
        per_layer = []
        for blk in self.blocks():
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm,
                                   self.matmul_backend)
            o, c = fn(hn, blk.attn, self.cfg, positions, max_len=max_len + 1,
                      mm=self.matmul_backend, codec=self.codec)
            x = self._ffn_half(x + o, blk)
            per_layer.append(c)
        cache = type(per_layer[0])(*(
            None if t[0] is None else torch.stack(t)
            for t in zip(*per_layer)))
        return self._unembed(x), cache

    def _hybrid_prefill(self, x: torch.Tensor, positions: torch.Tensor,
                        max_len: int, lengths: torch.Tensor | None
                        ) -> tuple[torch.Tensor, HybridCache]:
        """The reference's hybrid branch of ``prefill``: each layer's
        RG-LRU state or rolling buffer, stacked by kind."""
        mm, states = self.matmul_backend, {"r": [], "a": []}
        for blk, (kind, _) in zip(self.layers, self.kinds):
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm, mm)
            if kind == "r":
                o, st = rglru.rglru_prefill(hn, blk.rglru, self.cfg, mm,
                                            lengths)
            else:
                o, st = attn.gqa_prefill(
                    hn, blk.attn, self.cfg, positions, max_len=max_len,
                    mm=mm, window=self.window, lengths=lengths)
            x = self._ffn_half(x + o, blk)
            states[kind].append(st)
        conv, h = (torch.stack(t) for t in zip(*states["r"]))
        k = torch.stack([c.k for c in states["a"]])
        v = torch.stack([c.v for c in states["a"]])
        return self._unembed(x), HybridCache(conv, h, k, v)

    def _encdec_prefill(self, x: torch.Tensor, positions: torch.Tensor,
                        max_len: int, frontend: torch.Tensor | None
                        ) -> tuple[torch.Tensor, EncDecCache]:
        """The reference's enc-dec branch of ``prefill``: the encoder, then
        per decoder layer its self-attention (the self K/V stored in bf16),
        the cross K/V (the attend reads them as computed, the cache takes
        their bf16 rounding) and the FFN."""
        mm, enc, rows = self.matmul_backend, self._encode(frontend), []
        for blk in self.layers:
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm, mm)
            o, c = attn.gqa_prefill(hn, blk.attn, self.cfg, positions,
                                    max_len=max_len + 1, mm=mm)
            k, v = self._cross_kv(blk, enc)
            x = self._ffn_half(self._cross_half(x + o, blk, k, v), blk)
            rows.append((c.k, c.v, k.to(torch.bfloat16),
                         v.to(torch.bfloat16)))
        return self._unembed(x), EncDecCache(*(torch.stack(t)
                                               for t in zip(*rows)))

    def _ssm_prefill(self, x: torch.Tensor, lengths: torch.Tensor | None
                     ) -> tuple[torch.Tensor, SSMState]:
        """The reference's ssm branch of ``prefill``: each layer's state,
        stacked on a leading layer axis."""
        mm, states = self.matmul_backend, []
        for blk in self.layers:
            o, st = ssm.ssm_prefill(
                layers.apply_norm(x, blk.ln, self.cfg.norm, mm), blk.ssm,
                self.cfg, mm, lengths)
            x = x + o
            states.append(st)
        conv, h = (torch.stack(t) for t in zip(*states))
        return self._unembed(x), SSMState(conv, h)

    @torch.no_grad()
    def decode_step(self, cache: KVCache | MLACache | HybridCache | SSMState
                    | EncDecCache,
                    tokens: torch.Tensor,
                    cache_index: torch.Tensor,
                    block_tables: torch.Tensor | None = None
                    ) -> torch.Tensor:
        """tokens [B, 1] at per-slot positions ``cache_index`` [B] ->
        logits [B, 1, V]; the new K/V rows are written into ``cache`` in
        place: the paged pool through ``block_tables``, or with
        ``block_tables=None`` the dense cache of ``init_cache`` (a hybrid
        model's ``HybridCache``: h and the conv windows advance, the
        rolling buffers take the new rows; an ssm model's ``SSMState``:
        each layer's h and conv window advance; an audio model's
        ``EncDecCache``: the self rows take the new K/V, the cross rows
        are read as the prefill stored them)."""
        self._no_decode()
        x = self._embed(tokens, positions=cache_index[:, None])
        if self.cfg.family not in ("dense", "vlm", "moe") \
                and block_tables is not None:
            raise ValueError(f"paged decode unsupported for family "
                             f"{self.cfg.family!r}")
        if self.cfg.hybrid is not None:
            return self._hybrid_decode(cache, x, cache_index)
        if self.cfg.encdec is not None:
            mm = self.matmul_backend
            for i, blk in enumerate(self.layers):
                hn = layers.apply_norm(x, blk.ln1, self.cfg.norm, mm)
                x = x + attn.gqa_decode(hn, blk.attn, self.cfg,
                                        cache.self_attn(i), cache_index,
                                        mm=mm)
                c = cache.cross(i)
                x = self._ffn_half(self._cross_half(x, blk, c.k, c.v), blk)
            return self._unembed(x)
        if self.cfg.ssm is not None:
            mm = self.matmul_backend
            for i, blk in enumerate(self.layers):
                x = x + ssm.ssm_decode(
                    layers.apply_norm(x, blk.ln, self.cfg.norm, mm), blk.ssm,
                    self.cfg, SSMState(cache.conv[i], cache.h[i]), mm)
            return self._unembed(x)
        for i, blk in enumerate(self.blocks()):
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm,
                                   self.matmul_backend)
            c, mm = cache.layer(i), self.matmul_backend
            if self.cfg.mla is not None and block_tables is None:
                o = attn.mla_decode(hn, blk.attn, self.cfg, c, cache_index,
                                    mm=mm, codec=self.codec)
            elif self.cfg.mla is not None:
                # the reference attends MLA through its gather route only
                o = attn.mla_decode_paged(
                    hn, blk.attn, self.cfg, c, cache_index, block_tables,
                    mm=mm, codec=self.codec)
            elif block_tables is None:
                o = attn.gqa_decode(hn, blk.attn, self.cfg, c, cache_index,
                                    mm=mm, codec=self.codec)
            else:
                o = attn.gqa_decode_paged(
                    hn, blk.attn, self.cfg, c, cache_index, block_tables,
                    impl=self.paged_attn_impl, mm=mm, codec=self.codec)
            x = x + o
            x = self._ffn_half(x, blk)
        return self._unembed(x)

    def _hybrid_decode(self, cache: HybridCache, x: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
        mm = self.matmul_backend
        for blk, (kind, j) in zip(self.layers, self.kinds):
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm, mm)
            if kind == "r":
                o = rglru.rglru_decode(hn, blk.rglru, self.cfg, cache.lru(j),
                                       mm)
            else:
                o = attn.gqa_decode(hn, blk.attn, self.cfg, cache.attn(j),
                                    idx, mm=mm, window=self.window)
            x = self._ffn_half(x + o, blk)
        return self._unembed(x)

    @torch.no_grad()
    def mixed_step(self, cache: KVCache | MLACache, tokens: torch.Tensor,
                   start: torch.Tensor, n_live: torch.Tensor,
                   block_tables: torch.Tensor | None = None,
                   prefill_lanes: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """Chunked-prefill/decode mixed step: tokens [B, W] -> logits
        [B, W, V].  Lane ``l`` of slot ``b`` sits at position
        ``start[b] + l``; only the first ``n_live[b]`` lanes are real (a
        decoding slot uses one, a prefilling slot up to a chunk, an idle
        slot none).  The cache is updated in place: the paged pool through
        ``block_tables``, or with ``block_tables=None`` the dense cache of
        ``init_cache`` / ``init_dense_cache``.  ``prefill_lanes`` ([B]
        bool) marks the slots whose lanes are prompt tokens: for a model
        with a stub frontend their positions below ``num_tokens`` take the
        (zero) patch embeddings, as in the bucketed prefill.  A family
        whose prefill state is sequential (ssm, hybrid) is refused, with
        the reference's message; an encoder with the engine's."""
        self._no_decode()
        if self.cfg.family not in CHUNKABLE_FAMILIES:
            raise ValueError(
                f"mixed_step unsupported for family {self.cfg.family!r} "
                "(sequential prefill state); use the bucketed scheduler")
        positions = start[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device, dtype=start.dtype)[None, :]
        x = self._embed(tokens, positions=positions)
        if self.cfg.frontend is not None and prefill_lanes is not None:
            fm = prefill_lanes[:, None, None] \
                & (positions < self.cfg.frontend.num_tokens)[..., None]
            x = x.masked_fill(fm, 0)
        for i, blk in enumerate(self.blocks()):
            hn = layers.apply_norm(x, blk.ln1, self.cfg.norm,
                                   self.matmul_backend)
            c, mm = cache.layer(i), self.matmul_backend
            if self.cfg.mla is not None and block_tables is None:
                o = attn.mla_mixed(hn, blk.attn, self.cfg, c, start, n_live,
                                   mm=mm, codec=self.codec)
            elif self.cfg.mla is not None:
                o = attn.mla_mixed_paged(
                    hn, blk.attn, self.cfg, c, start, n_live, block_tables,
                    mm=mm, codec=self.codec)
            elif block_tables is None:
                o = attn.gqa_mixed(hn, blk.attn, self.cfg, c, start, n_live,
                                   mm=mm, codec=self.codec)
            else:
                o = attn.gqa_mixed_paged(
                    hn, blk.attn, self.cfg, c, start, n_live, block_tables,
                    impl=self.paged_attn_impl, mm=mm, codec=self.codec)
            x = x + o
            x = self._ffn_half(x, blk)
        return self._unembed(x)


def combine_loss(terms: dict, cfg: ArchConfig
                 ) -> tuple[torch.Tensor, dict]:
    """(total, aux) of ``Model.loss`` from its ``loss_terms``."""
    total = xent = terms["xent"]
    aux = {"xent": xent}
    if "balance" in terms:
        lb = moe.balance_term(*terms["balance"], cfg.moe)
        aux["load_balance"] = lb
        total = total + MOE_AUX_WEIGHT * lb
    if "mtp" in terms:
        aux["mtp"] = terms["mtp"]
        total = total + MTP_LOSS_WEIGHT * aux["mtp"]
    aux["total"] = total
    return total, aux


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32: logsumexp minus the gold logit (the
    reference's ``_xent``)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - gold).mean()
