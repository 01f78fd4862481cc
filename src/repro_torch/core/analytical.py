"""Analytical resource and latency model: the paper's §5 on an H100.

The paper models DSP/BRAM counts (Eq. 8, 25) and per-module pipelined-loop
latency (Eq. 9-39) as closed-form functions of the topology registers
(sequence length, heads, d_model, d_ff, layers) and the tile sizes.  The
reference (``repro.core.analytical``) re-derives them for its accelerator;
this is the port's copy of that arithmetic, function for function, with
its device spec replaced by a GPU's:

* per-module FLOP counts            (DSP MACs      -> tensor-core FLOPs)
* per-module HBM byte traffic       (BRAM loads    -> HBM -> shared memory)
* collective byte traffic           (NVLink; one card: not measured)
* a three-term roofline             (pipelined-loop latency -> max of terms)

The same arithmetic gives the same numbers for the same constants (the
CPU tests hold every function to the reference's at the reference's own
constants, which they build inside the test).  Like the paper's model it
is pre-execution arithmetic: it never touches a device.  ``chip_smoke.py``
phase 19b holds it against the card: Table 1's and Table 2's points, and
the ranking of four forwards, measured.

``H100`` is NVIDIA's data sheet for the H100 SXM (dense rates, no
sparsity, at its 700 W limit), the card every measurement of the port is
taken on: "NVIDIA H100 80GB HBM3, 700.00 W" as ``nvidia-smi`` prints it.
``GPUSpec.from_card`` takes the memory size, SM count and per-CTA shared
memory from a present card's ``torch.cuda.get_device_properties``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # only for type hints; avoid import cycle at runtime
    from repro_torch.configs.base import ArchConfig, ShapeSpec

# the card every figure below is the data sheet's for, as nvidia-smi
# prints its name and power limit
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


# ---------------------------------------------------------------------------
# Hardware constants
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GPUSpec:
    """One card's figures for the cost model and the tile planner.

    The defaults are NVIDIA's published H100 SXM figures (``CARD``); a
    card below its 700 W limit runs slower under load, so a measurement
    states its card's limit beside it.  ``link_bw`` is NVLink's rate in
    one direction (the data sheet's 900 GB/s is both directions); the
    machine the port runs on has one card, so no run has measured it
    (``link_measured``).  ``smem_bytes`` (the dynamic shared memory one
    CTA may hold) and ``n_sms`` take the place of the reference's
    on-chip planning budget for the tile planner (``core/tiling.py``),
    and ``mma_tile`` that of its systolic edge: 16, the K slice and row
    edge of the port's bf16 loop (``mma.sync`` m16n8k16,
    ``csrc/mma_tile.cuh``)."""

    name: str = CARD
    peak_flops: float = 989e12        # bf16 tensor-core FLOP/s (dense)
    int8_ops: float = 1979e12         # int8 tensor-core OP/s (dense)
    f32_flops: float = 67e12          # float32 FLOP/s outside tensor cores
    hbm_bw: float = 3.35e12           # HBM bytes/s
    link_bw: float = 450e9            # NVLink bytes/s, one direction
    link_measured: bool = False       # one card: never measured here
    hbm_bytes: int = 80 * 10**9       # 80 GB HBM3
    smem_bytes: int = 227 * 1024      # dynamic shared memory of one CTA
    n_sms: int = 132                  # streaming multiprocessors
    mma_tile: int = 16                # the bf16 loop's mma.sync edge

    @classmethod
    def from_card(cls, device=None) -> "GPUSpec":
        """The H100 figures with the present card's memory size, SM count
        and per-CTA shared memory (``torch.cuda.get_device_properties``)
        and its name; the rates stay the data sheet's."""
        import torch

        props = torch.cuda.get_device_properties(
            torch.device("cuda") if device is None else device)
        smem = getattr(props, "shared_memory_per_block_optin",
                       cls.smem_bytes)
        return cls(name=props.name, hbm_bytes=int(props.total_memory),
                   n_sms=int(props.multi_processor_count),
                   smem_bytes=int(smem))


H100 = GPUSpec()


# ---------------------------------------------------------------------------
# Parameter counts (paper Eq. 8/25 analogue: how much "fabric" a topology uses)
# ---------------------------------------------------------------------------
def _attention_params(cfg: "ArchConfig") -> int:
    """Per-layer attention parameter count, by family."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return 0
    if cfg.mla is not None:
        m = cfg.mla
        n = 0
        n += d * m.q_lora_rank + m.q_lora_rank  # q down + norm
        n += m.q_lora_rank * cfg.num_heads * m.qk_head_dim  # q up
        n += d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank  # kv down + norm
        n += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)  # kv up
        n += cfg.num_heads * m.v_head_dim * d  # out proj
        return n
    hd = cfg.resolved_head_dim
    n = d * cfg.num_heads * hd          # W_q
    n += 2 * d * cfg.num_kv_heads * hd  # W_k, W_v
    n += cfg.num_heads * hd * d         # W_o
    if cfg.qkv_bias:
        n += (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    return n


def _ffn_params(cfg: "ArchConfig", d_ff: int) -> int:
    d = cfg.d_model
    from repro_torch.models.layers import is_gated

    mats = 3 if is_gated(cfg.activation) else 2
    n = mats * d * d_ff
    if cfg.family in ("encoder", "audio") or cfg.activation in ("gelu", "relu"):
        # paper-style FFN carries biases
        n += d_ff + d
    return n


def _ssm_params(cfg: "ArchConfig") -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = s.dt_rank or math.ceil(d / 16)
    n = d * 2 * d_in                      # in_proj (x and gate branches)
    n += d_in * s.conv_kernel + d_in      # depthwise conv + bias
    n += d_in * (dt_rank + 2 * s.state_dim)  # x_proj -> (dt, B, C)
    n += dt_rank * d_in + d_in            # dt_proj
    n += d_in * s.state_dim + d_in        # A_log, D
    n += d_in * d                         # out_proj
    return n


def _rglru_params(cfg: "ArchConfig") -> int:
    h = cfg.hybrid
    d = cfg.d_model
    w = h.lru_width or d
    heads = max(cfg.num_heads, 1)
    blk = w // heads
    n = 2 * d * w                         # two input branches (x, gate)
    n += w * 4 + w                        # temporal conv (k=4) + bias
    n += 2 * heads * blk * blk + 2 * w    # block-diag input & recurrence gates
    n += w                                # a (recurrence) parameter
    n += w * d                            # out proj
    return n


def _moe_layer_params(cfg: "ArchConfig") -> tuple[int, int]:
    """(total, active) FFN params for one MoE layer."""
    m = cfg.moe
    from repro_torch.models.layers import is_gated

    mats = 3 if is_gated(cfg.activation) else 2
    per_expert = mats * cfg.d_model * m.expert_d_ff
    router = cfg.d_model * m.num_experts
    shared = m.num_shared_experts * mats * cfg.d_model * m.shared_expert_d_ff
    total = m.num_experts * per_expert + router + shared
    active = m.experts_per_token * per_expert + router + shared
    return total, active


def arch_param_count(cfg: "ArchConfig", active_only: bool = False) -> int:
    """Total (or activated) parameter count for an architecture."""
    d = cfg.d_model
    n = cfg.vocab_size * d                       # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d                  # unembedding
    if cfg.positional == "learned":
        n += cfg.max_position_embeddings * d

    def layer_params(kind: str) -> int:
        ln = 2 * d if cfg.norm == "layernorm" else d
        p = 2 * ln                               # pre-attn + pre-ffn norms
        if kind == "ssm":
            return p // 2 + _ssm_params(cfg)
        if kind == "rglru":
            return p + _rglru_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        if kind == "attn+moe":
            total, active = _moe_layer_params(cfg)
            return p + _attention_params(cfg) + (active if active_only else total)
        if kind == "attn+dense_ffn":
            dff = cfg.moe.dense_d_ff if (cfg.moe and cfg.moe.first_k_dense) else cfg.d_ff
            return p + _attention_params(cfg) + _ffn_params(cfg, dff)
        if kind == "cross":                      # enc-dec decoder layer
            ln3 = 3 * ln
            return ln3 + 2 * _attention_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        raise ValueError(kind)

    if cfg.family == "ssm":
        n += cfg.num_layers * layer_params("ssm")
    elif cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        for i in range(cfg.num_layers):
            kind = "rglru" if pat[i % len(pat)] == "r" else "attn+dense_ffn"
            n += layer_params(kind)
    elif cfg.family == "moe":
        k = cfg.moe.first_k_dense
        n += k * layer_params("attn+dense_ffn")
        n += (cfg.num_layers - k) * layer_params("attn+moe")
    elif cfg.encdec is not None:
        n += cfg.encdec.num_encoder_layers * layer_params("attn+dense_ffn")
        n += cfg.num_layers * layer_params("cross")
    else:
        n += cfg.num_layers * layer_params("attn+dense_ffn")

    if cfg.num_mtp_modules:
        # MTP: projection + one extra transformer layer per module (DeepSeek-V3)
        n += cfg.num_mtp_modules * (2 * d * d + layer_params("attn+moe" if cfg.moe else "attn+dense_ffn"))
    return n


# ---------------------------------------------------------------------------
# Per-module FLOPs (paper Eq. 11-39 analogue, module names kept)
# ---------------------------------------------------------------------------
def _mm(b_tokens: int, d_in: int, d_out: int) -> float:
    """FLOPs of a [tokens, d_in] @ [d_in, d_out] matmul."""
    return 2.0 * b_tokens * d_in * d_out


def attention_module_flops(cfg: "ArchConfig", batch: int, q_len: int,
                           kv_len: int) -> dict[str, float]:
    """FLOPs per attention layer, split by the paper's processing modules.

    QKV_PM -> 'qkv', QK_PM -> 'qk', softmax -> counted in 'qk'
    (elementwise, light), SV_PM -> 'sv', output projection -> 'out'.
    """
    d = cfg.d_model
    t = batch * q_len
    if cfg.mla is not None:
        m = cfg.mla
        qkv = _mm(t, d, m.q_lora_rank) + _mm(t, m.q_lora_rank, cfg.num_heads * m.qk_head_dim)
        qkv += _mm(t, d, m.kv_lora_rank + m.qk_rope_head_dim)
        qkv += _mm(t, m.kv_lora_rank, cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim))
        qk = 2.0 * batch * q_len * kv_len * cfg.num_heads * m.qk_head_dim
        sv = 2.0 * batch * q_len * kv_len * cfg.num_heads * m.v_head_dim
        out = _mm(t, cfg.num_heads * m.v_head_dim, d)
        return {"qkv": qkv, "qk": qk, "sv": sv, "out": out}
    hd = cfg.resolved_head_dim
    win = None
    if cfg.hybrid is not None:
        win = cfg.hybrid.attention_window
        kv_len = min(kv_len, win)
    qkv = _mm(t, d, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd)
    qk = 2.0 * batch * q_len * kv_len * cfg.num_heads * hd
    sv = 2.0 * batch * q_len * kv_len * cfg.num_heads * hd
    out = _mm(t, cfg.num_heads * hd, d)
    return {"qkv": qkv, "qk": qk, "sv": sv, "out": out}


def ffn_module_flops(cfg: "ArchConfig", tokens: int, d_ff: int) -> float:
    from repro_torch.models.layers import is_gated

    mats = 3 if is_gated(cfg.activation) else 2
    return mats * _mm(tokens, cfg.d_model, d_ff)


def ssm_module_flops(cfg: "ArchConfig", tokens: int) -> dict[str, float]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = s.dt_rank or math.ceil(d / 16)
    proj = _mm(tokens, d, 2 * d_in) + _mm(tokens, d_in, dt_rank + 2 * s.state_dim)
    proj += _mm(tokens, dt_rank, d_in) + _mm(tokens, d_in, d)
    conv = 2.0 * tokens * d_in * s.conv_kernel
    # selective scan: state update (2 mul + add) + output contraction per (ch, state)
    scan = 6.0 * tokens * d_in * s.state_dim
    return {"qkv": proj, "qk": conv, "sv": scan, "out": 0.0}


def rglru_module_flops(cfg: "ArchConfig", tokens: int) -> dict[str, float]:
    h = cfg.hybrid
    d = cfg.d_model
    w = h.lru_width or d
    heads = max(cfg.num_heads, 1)
    blk = w // heads
    proj = _mm(tokens, d, 2 * w) + _mm(tokens, w, d)
    gates = 2.0 * 2.0 * tokens * heads * blk * blk  # two block-diag gates
    conv = 2.0 * tokens * w * 4
    rec = 6.0 * tokens * w  # per-channel gated recurrence
    return {"qkv": proj, "qk": gates + conv, "sv": rec, "out": 0.0}


def step_flops(cfg: "ArchConfig", shape: "ShapeSpec") -> dict[str, float]:
    """Forward-pass FLOPs of one step, per module group, plus 'total'.

    For training shapes the caller multiplies by 3 (fwd + 2x bwd) — see
    ``train_multiplier``.  Decode shapes are one new token per sequence
    against a kv_len-deep cache.
    """
    B = shape.global_batch
    if shape.kind == "decode":
        q_len, kv_len = 1, shape.seq_len
    else:
        q_len = kv_len = shape.seq_len
    t = B * q_len
    d = cfg.d_model
    out: dict[str, float] = {"qkv": 0.0, "qk": 0.0, "sv": 0.0, "out": 0.0,
                             "ffn": 0.0, "router": 0.0, "norm": 0.0,
                             "embed": 0.0}

    def add_attn(n_layers: int, q: int, kv: int, cross: bool = False) -> None:
        f = attention_module_flops(cfg, B, q, kv)
        for k, v in f.items():
            out[k] += n_layers * v
        if cross:
            # cross-attention K/V comes from encoder output (kv fixed)
            pass

    def add_ffn(n_layers: int, tokens: int, d_ff: int) -> None:
        out["ffn"] += n_layers * ffn_module_flops(cfg, tokens, d_ff)

    if cfg.family == "ssm":
        f = ssm_module_flops(cfg, t)
        for k, v in f.items():
            out[k] += cfg.num_layers * v
    elif cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        n_r = sum(1 for i in range(cfg.num_layers) if pat[i % len(pat)] == "r")
        n_a = cfg.num_layers - n_r
        f = rglru_module_flops(cfg, t)
        for k, v in f.items():
            out[k] += n_r * v
        add_attn(n_a, q_len, kv_len)
        add_ffn(cfg.num_layers, t, cfg.d_ff)
    elif cfg.family == "moe":
        m = cfg.moe
        k_dense = m.first_k_dense
        add_attn(cfg.num_layers, q_len, kv_len)
        if k_dense:
            add_ffn(k_dense, t, m.dense_d_ff)
        n_moe = cfg.num_layers - k_dense
        out["router"] += n_moe * _mm(t, d, m.num_experts)
        out["ffn"] += n_moe * m.experts_per_token * ffn_module_flops(cfg, t, m.expert_d_ff)
        if m.num_shared_experts:
            out["ffn"] += n_moe * m.num_shared_experts * ffn_module_flops(cfg, t, m.shared_expert_d_ff)
    elif cfg.encdec is not None:
        enc_t = B * cfg.encdec.encoder_seq_len
        add_attn(cfg.encdec.num_encoder_layers, cfg.encdec.encoder_seq_len,
                 cfg.encdec.encoder_seq_len)
        add_ffn(cfg.encdec.num_encoder_layers, enc_t, cfg.d_ff)
        add_attn(cfg.num_layers, q_len, kv_len)              # decoder self-attn
        add_attn(cfg.num_layers, q_len, cfg.encdec.encoder_seq_len, cross=True)
        add_ffn(cfg.num_layers, t, cfg.d_ff)
    else:
        add_attn(cfg.num_layers, q_len, kv_len)
        add_ffn(cfg.num_layers, t, cfg.d_ff)

    out["norm"] += 8.0 * cfg.num_layers * t * d  # LN/RMSNorm + residuals (elementwise)
    out["embed"] += _mm(t, d, cfg.vocab_size) if shape.kind != "decode" else _mm(B, d, cfg.vocab_size)
    if cfg.num_mtp_modules and shape.kind == "train":
        f = attention_module_flops(cfg, B, q_len, kv_len)
        out["qkv"] += cfg.num_mtp_modules * (sum(f.values()) + _mm(t, 2 * d, d))
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def train_multiplier() -> float:
    """fwd + bwd FLOP multiplier (bwd ~ 2x fwd for matmul-dominated nets)."""
    return 3.0


def scan_undercount_correction(cfg: "ArchConfig", shape: "ShapeSpec") -> float:
    """FLOPs that a compiler's cost analysis of the reference's forward
    counts once instead of x trip-count (its non-layer ``lax.scan``s):
      * the SSM / RG-LRU time recurrence (train & prefill),
      * blockwise attention's query-block scan (S >= 8192 full attention).
    The reference's number, kept so that both packages agree on it; the
    port's forward runs these as loops and kernels, not scans.  Returns
    the missing forward FLOPs (x3 applied for train by the caller via
    ``train_multiplier``).
    """
    from repro_torch.models.attention import BLOCKWISE_THRESHOLD, QUERY_BLOCK

    if shape.kind == "decode":
        return 0.0  # single-step updates, no inner scans
    B, S = shape.global_batch, shape.seq_len
    t = B * S
    missing = 0.0
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        # scan body counted once (one timestep): missing (S-1)/S of it
        missing += 6.0 * t * d_in * s.state_dim * (S - 1) / S
    if cfg.family == "hybrid":
        w = cfg.hybrid.lru_width or cfg.d_model
        pat = cfg.hybrid.pattern
        n_r = sum(1 for i in range(cfg.num_layers) if pat[i % len(pat)] == "r")
        missing += n_r * 6.0 * t * w * (S - 1) / S
    if S >= BLOCKWISE_THRESHOLD and cfg.family not in ("ssm",):
        # blockwise attention: one query block counted, nb-1 missing
        if cfg.mla is not None:
            m = cfg.mla
            per_tok = 2.0 * S * cfg.num_heads * (m.qk_head_dim + m.v_head_dim)
        elif cfg.hybrid is not None:
            per_tok = 0.0  # hybrid uses windowed attention, not blockwise
        else:
            per_tok = 4.0 * S * cfg.num_heads * cfg.resolved_head_dim
        n_attn = cfg.num_layers
        if cfg.hybrid is not None:
            pat = cfg.hybrid.pattern
            n_attn = sum(1 for i in range(cfg.num_layers)
                         if pat[i % len(pat)] == "a")
        nb = -(-S // QUERY_BLOCK)
        missing += n_attn * B * S * per_tok * (nb - 1) / nb
    return missing


def model_flops(cfg: "ArchConfig", shape: "ShapeSpec") -> float:
    """The 6·N·D (dense) / 6·N_active·D (MoE) useful-FLOPs yardstick."""
    n = arch_param_count(cfg, active_only=True)
    n -= cfg.vocab_size * cfg.d_model  # embedding lookups are not matmul FLOPs
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# Memory footprints (paper Eq. 25 analogue)
# ---------------------------------------------------------------------------
def kv_cache_bytes(cfg: "ArchConfig", seq_len: int, batch: int,
                   dtype_bytes: int = 2) -> int:
    """Decode-time per-sequence state, by family (GQA/MLA/SSM/hybrid)."""
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        per_seq = d_in * s.state_dim + d_in * s.conv_kernel
        return cfg.num_layers * per_seq * batch * 4  # states kept in f32
    if cfg.mla is not None:
        m = cfg.mla
        per_tok = m.kv_lora_rank + m.qk_rope_head_dim
        return cfg.num_layers * seq_len * per_tok * batch * dtype_bytes
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        w = cfg.hybrid.lru_width or cfg.d_model
        win = min(cfg.hybrid.attention_window, seq_len)
        total = 0
        for i in range(cfg.num_layers):
            if pat[i % len(pat)] == "r":
                total += (w + w * 4) * 4  # LRU state + conv state, f32
            else:
                total += 2 * win * cfg.num_kv_heads * cfg.resolved_head_dim * dtype_bytes
        return total * batch
    kv = 2 * seq_len * cfg.num_kv_heads * cfg.resolved_head_dim
    n_self = cfg.num_layers
    total = n_self * kv * dtype_bytes
    if cfg.encdec is not None:  # cross-attention cache (encoder K/V)
        total += cfg.num_layers * 2 * cfg.encdec.encoder_seq_len * \
            cfg.num_kv_heads * cfg.resolved_head_dim * dtype_bytes
    return total * batch


def kv_bytes_per_token(cfg: "ArchConfig", kv_dtype: str = "compute") -> int:
    """Decode-cache bytes one cached token costs, across all layers.

    The per-token unit the autotuner sizes cache pools with: a dense
    cache holds ``max_batch * max_len`` of them, a paged pool
    ``num_blocks * block_size``.  ``kv_dtype="int8"`` accounts the
    ``core.kv_quant`` codec rows (int8 values + one f32 scale per
    (position, kv-head) row) instead of bf16 values.

    Only attention KV/latent caches have a per-token cost; recurrent
    families (SSM / RG-LRU hybrid) carry per-*sequence* state and the
    enc-dec cross cache is per-encoder-token — use
    :func:`kv_cache_bytes` for those.
    """
    if cfg.family in ("ssm", "hybrid") or cfg.encdec is not None:
        raise ValueError(
            f"family {cfg.family!r} has no per-token KV cache (its decode "
            "state is per-sequence or encoder-sided); use kv_cache_bytes")
    if cfg.mla is not None:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        per_layer = (width + 4) if kv_dtype == "int8" else 2 * width
        return cfg.num_layers * per_layer
    hd = cfg.resolved_head_dim
    per_row = (hd + 4) if kv_dtype == "int8" else 2 * hd
    return cfg.num_layers * 2 * cfg.num_kv_heads * per_row


def weight_bytes(cfg: "ArchConfig", dtype_bytes: int = 2) -> int:
    return arch_param_count(cfg) * dtype_bytes


def train_state_bytes(cfg: "ArchConfig") -> int:
    """bf16 params + f32 master + f32 m/v + bf16 grads (mixed-precision Adam)."""
    n = arch_param_count(cfg)
    return n * (2 + 4 + 4 + 4 + 2)


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds, for one (arch, shape, chips):
    compute at ``spec.peak_flops``, memory at ``spec.hbm_bw``, collective
    at ``spec.link_bw``."""

    t_compute: float
    t_memory: float
    t_collective: float
    flops: float              # analytical FLOPs (global)
    bytes_hbm: float          # HBM traffic (global)
    bytes_collective: float   # inter-chip traffic (global)
    n_chips: int
    spec: GPUSpec = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def compute_fraction(self) -> float:
        """Fraction of roofline: useful compute time / bound time."""
        return self.t_compute / max(self.t_total, 1e-30)

    def scaled(self, **kw) -> "RooflineTerms":
        return dataclasses.replace(self, **kw)


def roofline(flops: float, bytes_hbm: float, bytes_collective: float,
             n_chips: int, spec: GPUSpec = H100) -> RooflineTerms:
    return RooflineTerms(
        t_compute=flops / (n_chips * spec.peak_flops),
        t_memory=bytes_hbm / (n_chips * spec.hbm_bw),
        t_collective=bytes_collective / (n_chips * spec.link_bw),
        flops=flops, bytes_hbm=bytes_hbm, bytes_collective=bytes_collective,
        n_chips=n_chips, spec=spec,
    )


def analytical_step_seconds(cfg: "ArchConfig", shape: "ShapeSpec",
                            n_chips: int, spec: GPUSpec = H100,
                            dtype_bytes: int = 2, *,
                            tp: int = 1) -> RooflineTerms:
    """Closed-form roofline estimate (no compiler), paper-Table-2 style.

    ``tp`` sizes the tensor-parallel collective term explicitly: with
    ``tp > 1`` every layer pays two all-reduces of the activation slab
    (Megatron attention-out + FFN-out), each moving ``2(tp-1)/tp`` of
    the payload per chip over the interconnect.  ``tp=1`` keeps the
    reference's order-of-magnitude placeholder, so single-device rankings
    (held by chip_smoke.py phase 19b's calibration) are unchanged.
    """
    f = step_flops(cfg, shape)["total"]
    if shape.kind == "train":
        f *= train_multiplier()
    wb = weight_bytes(cfg, dtype_bytes)
    act = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len) \
        * cfg.d_model * dtype_bytes
    layers = cfg.num_layers + (cfg.encdec.num_encoder_layers if cfg.encdec else 0)
    bytes_hbm = wb + act * layers * 8  # weights once + activations per layer
    if shape.kind == "decode":
        bytes_hbm += kv_cache_bytes(cfg, shape.seq_len, shape.global_batch, dtype_bytes)
    if shape.kind == "train":
        bytes_hbm = 3 * wb + act * layers * 12
        coll = 2.0 * arch_param_count(cfg) * dtype_bytes  # grad all-reduce
    elif tp > 1:
        # serving TP: 2 ring all-reduces per layer over the activations
        coll = layers * 2.0 * act * 2.0 * (tp - 1) / tp
    else:
        coll = 2.0 * act  # TP activation collectives (order-of-magnitude)
    return roofline(f, bytes_hbm, coll, n_chips, spec)
