"""The port's configuration surface: ``RuntimeSpec`` and its parts.

A subset of the reference's ``core/spec.py`` with the same field names,
spellings and validation messages, so one spec means the same thing in
both packages:

* ``matmul_backend`` is ``"xla" | "pallas"`` and ``paged_attn_impl`` is
  ``"gather" | "pallas"``.  In the port ``"xla"`` / ``"gather"`` are the
  plain PyTorch paths and ``"pallas"`` selects the repository's own
  hand-written CUDA kernels (``repro_torch.kernels``), the counterparts
  of the reference's Pallas kernels.
* ``param_dtype`` / ``compute_dtype`` accept torch dtypes or the same
  string names (``"bf16"``, ``"fp32"``, ...).

What the port serves: the dense, vlm and moe families (GQA or
MLA attention; MLA on one model's engine, never in a fleet), the ssm
family (Mamba-1's selective scan), the hybrid family (RG-LRU and local
attention) and the audio family (an encoder over the stub frontend's
frames and a decoder with cross-attention), these three on the dense
layout, the bucketed scheduler and a float cache only (the reference's
rules), through the
dense per-slot cache or the paged pool (``MemorySpec.cache_layout``) and
the chunked or the bucketed scheduler (``SchedulerSpec.policy``, "auto"
resolving as the reference's engine does: ``RuntimeSpec.resolved_policy``),
with float or int8 weights (``quant``; refused where the size rule would
quantize an MLA up-projection or a learned position table, which the
reference cannot serve) and a float or int8 KV cache
(``MemorySpec.kv_dtype``), one model or a fleet of dense models within
``maxima`` (``maxima_for``; a fleet's int8 weights are its own int8
weight table), with or without the prefix cache (``MemorySpec.prefix_cache``,
paged and chunked only), and with or without speculative decoding
(``SpeculationSpec``, chunked only).  The encoder family (the paper's
networks) validates as the reference's does, with or without ``maxima``:
the paged layout and an int8 cache are refused, as for the other
families whose state is not a paged attention cache.  It has no decode
step, so ``ServingEngine`` refuses it with the reference's message; the
model runs its ``forward`` (``models/model.py``), and a spec with
``maxima`` is a topology of the register-driven engine
(``core/adaptive.py`` ``AdaptiveEngine.from_spec``), which it lowers to
the register file (``RuntimeSpec.registers``).

``mesh`` (``MeshSpec(tp, dp)``) maps one configuration onto devices, as
the reference's does: ``tp`` ranks share one fused chunked step
(``models/tensor_parallel.py``: q/k/v and FFN columns, ``wo`` / ``w2``
rows, the vocabulary and the pool's kv heads split by the logical-axis
rules of ``distributed/sharding.py``, each with its divisibility
fallback), and ``dp`` engine replicas sit behind one admission queue
(``serving/cluster.py`` ``EngineCluster``).  The tensor-parallel rules
are the reference's: no fleet, the plain routes only
(``matmul_backend="xla"``, ``paged_attn_impl="gather"``), the chunked
scheduler and the chunkable families; the port also refuses the MoE
family under ``tp > 1`` (ROADMAP.md Queue 1 item 13b).  ``violations``,
``fits_within``, ``capacity`` and ``maxima_for`` plan per device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.configs.base import (DEFAULT_COMPUTE_DTYPE,
                                      DEFAULT_PARAM_DTYPE, ArchConfig)
from repro_torch.core.kv_quant import KV_DTYPES
from repro_torch.core.paging import PagingConfig, blocks_for_tokens
from repro_torch.core.quant import DEFAULT_QUANT_MIN_SIZE
from repro_torch.core.serve_quant import (check_mla_quant,
                                          check_position_quant)
from repro_torch.core.registers import Maxima, TopologyRegisters, \
    registers_for

_MATMUL_BACKENDS = ("xla", "pallas")
_PAGED_ATTN_IMPLS = ("gather", "pallas")
_CACHE_LAYOUTS = ("dense", "paged")
_QUANT_MODES = ("none", "int8")
_SCHEDULER_POLICIES = ("auto", "chunked", "bucketed")

_DTYPE_ALIASES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp32": torch.float32, "f32": torch.float32, "float32": torch.float32,
    "fp16": torch.float16, "f16": torch.float16, "float16": torch.float16,
}

# The reference's families, all ported.
PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio",
                   "encoder")
# Families whose decode state is a genuine KV/latent cache (the reference's
# KV_QUANTIZABLE_FAMILIES) and whose prefill can be replayed through the
# fused chunked step (its CHUNKABLE_FAMILIES): attention caches are
# write-then-attend.
KV_QUANTIZABLE_FAMILIES = ("dense", "vlm", "moe")
CHUNKABLE_FAMILIES = ("dense", "vlm", "moe")


def check_encdec(cfg: ArchConfig) -> None:
    """A decoding config is of the audio family exactly when it has an
    ``EncDecConfig``: the encoder-decoder model is that family's, and no
    other decoding family builds an encoder."""
    if cfg.family != "encoder" and \
            (cfg.family == "audio") != (cfg.encdec is not None):
        has = "an" if cfg.encdec is not None else "no"
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} with {has} EncDecConfig: "
            "the audio family is the encoder-decoder one and needs its "
            "encdec, and no other decoding family takes one")


def _normalize_dtype(field_name: str, value):
    """Accept torch dtypes or their string names; reject non-float dtypes
    with the valid spellings in the message."""
    if isinstance(value, str):
        key = value.lower()
        if key not in _DTYPE_ALIASES:
            raise ValueError(
                f"ExecutionSpec.{field_name}={value!r} is not a recognized "
                f"dtype name; use one of {sorted(set(_DTYPE_ALIASES))}")
        return _DTYPE_ALIASES[key]
    if not isinstance(value, torch.dtype):
        raise ValueError(f"ExecutionSpec.{field_name}={value!r} is not a dtype")
    if not value.is_floating_point:
        raise ValueError(
            f"ExecutionSpec.{field_name}={value!r} must be a floating "
            "dtype (params/activations; int8 quantization is configured "
            "through quant= and MemorySpec.kv_dtype, not the dtypes)")
    return value


def _not_ported(what: str, item: str, hint: str = "") -> ValueError:
    return ValueError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md Queue 1 "
        f"{item}){hint}")


@dataclass(frozen=True)
class ExecutionSpec:
    """How the model computes: kernel routing and dtypes.

    ``matmul_backend="pallas"`` routes every dense projection through the
    hand-written ``tiled_matmul`` CUDA kernel (``int8_matmul`` for int8
    weights), ``paged_attn_impl="pallas"`` the paged attention through the
    hand-written ``paged_decode_attention`` / ``chunked_prefill_attention``
    kernels; the Pallas names are kept so a spec reads the same in the JAX
    reference and in the port.

    ``quant="int8"`` quantizes the serving weights: eligible dense kernels
    per column and the embedding table per row (``core.serve_quant``).
    Leaves below ``quant_min_size`` elements (counted over all layers, as
    the reference stacks them) stay float.
    """

    matmul_backend: str = "xla"      # "xla" | "pallas" (hand-written kernel)
    paged_attn_impl: str = "gather"  # "gather" | "pallas" (hand-written kernels)
    param_dtype: Any = DEFAULT_PARAM_DTYPE
    compute_dtype: Any = DEFAULT_COMPUTE_DTYPE
    quant: str = "none"              # "none" | "int8" (serving weights)
    quant_min_size: int = DEFAULT_QUANT_MIN_SIZE  # leaf-size quant floor

    def __post_init__(self) -> None:
        if self.matmul_backend not in _MATMUL_BACKENDS:
            raise ValueError(
                f"ExecutionSpec.matmul_backend={self.matmul_backend!r} is not "
                f"one of {_MATMUL_BACKENDS}")
        if self.paged_attn_impl not in _PAGED_ATTN_IMPLS:
            raise ValueError(
                f"ExecutionSpec.paged_attn_impl={self.paged_attn_impl!r} is "
                f"not one of {_PAGED_ATTN_IMPLS}")
        if self.quant not in _QUANT_MODES:
            raise ValueError(
                f"ExecutionSpec.quant={self.quant!r} is not one of "
                f"{_QUANT_MODES}")
        if self.quant_min_size < 0:
            raise ValueError(
                f"ExecutionSpec.quant_min_size={self.quant_min_size} must "
                "be >= 0 (elements below which a param leaf stays float)")
        object.__setattr__(self, "param_dtype",
                           _normalize_dtype("param_dtype", self.param_dtype))
        object.__setattr__(self, "compute_dtype",
                           _normalize_dtype("compute_dtype",
                                            self.compute_dtype))


@dataclass(frozen=True)
class MemorySpec:
    """How decode-time memory is provisioned: cache layout, pool geometry
    and the KV storage dtype (defaults as in the reference; the port serves
    ``cache_layout="paged"``).  ``kv_dtype="int8"`` stores the pool as
    int8 with one float32 scale per (position, kv head)
    (``core.kv_quant``)."""

    cache_layout: str = "dense"      # "dense" | "paged"
    max_batch: int = 8
    max_len: int = 512
    block_size: int = 16
    num_blocks: int | None = None    # None -> dense worst case
    kv_dtype: str = "compute"        # "compute" | "int8"
    prefix_cache: bool = False

    def __post_init__(self) -> None:
        if self.cache_layout not in _CACHE_LAYOUTS:
            raise ValueError(
                f"MemorySpec.cache_layout={self.cache_layout!r} is not one "
                f"of {_CACHE_LAYOUTS}")
        if self.prefix_cache and self.cache_layout != "paged":
            raise ValueError(
                "MemorySpec.prefix_cache=True requires cache_layout='paged' "
                "(prefix sharing maps physical pool blocks into multiple "
                "block tables; the dense layout has no blocks to share)")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"MemorySpec.kv_dtype={self.kv_dtype!r} is not one of "
                f"{KV_DTYPES}")
        if self.max_batch <= 0 or self.max_len <= 0:
            raise ValueError(
                f"MemorySpec needs positive max_batch/max_len, got "
                f"max_batch={self.max_batch} max_len={self.max_len}")
        if self.cache_layout == "paged":
            if self.block_size <= 0:
                raise ValueError(
                    f"MemorySpec.block_size must be positive, got "
                    f"{self.block_size}")
            if self.max_len % self.block_size:
                raise ValueError(
                    f"MemorySpec.block_size={self.block_size} must divide "
                    f"max_len={self.max_len} (the block tables address whole "
                    "blocks)")
            need = blocks_for_tokens(self.max_len, self.block_size)
            if self.num_blocks is not None and self.num_blocks < need:
                raise ValueError(
                    f"paged pool of {self.num_blocks} x {self.block_size}-"
                    f"token blocks holds {self.num_blocks * self.block_size} "
                    f"tokens < max_len={self.max_len}: one full-length "
                    f"request could never be admitted; use num_blocks >= "
                    f"{need} (or shrink max_len)")

    @property
    def resolved_num_blocks(self) -> int:
        if self.num_blocks is not None:
            return self.num_blocks
        return self.max_batch * (self.max_len // self.block_size)

    def paging(self) -> PagingConfig | None:
        """Lower to the pool geometry (None for the dense layout)."""
        if self.cache_layout != "paged":
            return None
        return PagingConfig(block_size=self.block_size,
                            num_blocks=self.resolved_num_blocks)


@dataclass(frozen=True)
class SchedulerSpec:
    """How the serving engine feeds work to the fused device step (the
    reference's fields and checks; ``token_budget=None`` resolves to
    ``4 * chunk_size``)."""

    policy: str = "auto"
    chunk_size: int = 16
    token_budget: int | None = None

    def __post_init__(self) -> None:
        if self.policy not in _SCHEDULER_POLICIES:
            raise ValueError(
                f"SchedulerSpec.policy={self.policy!r} is not one of "
                f"{_SCHEDULER_POLICIES}")
        if self.chunk_size <= 0:
            raise ValueError(
                f"SchedulerSpec.chunk_size must be positive, got "
                f"{self.chunk_size}")
        if self.token_budget is not None and \
                self.token_budget < self.chunk_size:
            raise ValueError(
                f"SchedulerSpec.token_budget={self.token_budget} < "
                f"chunk_size={self.chunk_size}: the scheduler could never "
                "grant a full chunk; raise token_budget or shrink "
                "chunk_size")

    @property
    def resolved_token_budget(self) -> int:
        if self.token_budget is not None:
            return self.token_budget
        return 4 * self.chunk_size

    def chunk_violations(self, memory: MemorySpec) -> list[str]:
        """Every way this scheduler cannot chunk against ``memory``'s
        geometry (empty = the chunked policy is well-formed)."""
        out = []
        if self.chunk_size > memory.max_len:
            out.append(
                f"chunk_size={self.chunk_size} > max_len={memory.max_len} "
                "(a chunk never exceeds the cache)")
        if memory.cache_layout == "paged" and \
                self.chunk_size % memory.block_size:
            out.append(
                f"chunk_size={self.chunk_size} is not a multiple of "
                f"block_size={memory.block_size} (chunk KV writes must "
                "stay block-aligned for the paged pool)")
        return out


@dataclass(frozen=True)
class SpeculationSpec:
    """Speculative decoding: a draft model proposes ``k`` tokens per fused
    step and the target verifies all ``k + 1`` positions in one
    chunk-shaped attend (lane ``j`` of the verify pass scores position
    ``index + j`` against the pool like a prefill chunk lane).

    * ``draft_model`` -- the proposer's architecture.  It decodes from its
      own private dense KV cache inside the same fused step, so it must
      share the target's token space: ``vocab_size`` must match the
      serving arch, or a fleet's ``maxima.vocab`` (checked by
      ``RuntimeSpec.validate``).
    * ``k`` -- draft tokens proposed per step; ``k + 1 <= chunk_size``.
    * ``greedy_accept=True`` -- accept proposal ``j + 1`` iff it equals the
      target argmax at lane ``j`` (cumulative), which keeps greedy streams
      token-identical to target-only decode.  ``False`` uses rejection
      sampling on the softened distributions (rows with temperature <= 0
      still take the greedy path).
    """

    draft_model: ArchConfig
    k: int = 3
    greedy_accept: bool = True

    def __post_init__(self) -> None:
        if not isinstance(self.draft_model, ArchConfig):
            raise ValueError(
                "SpeculationSpec.draft_model must be an ArchConfig, got "
                f"{type(self.draft_model).__name__}")
        self.draft_model.validate()
        if self.k < 1:
            raise ValueError(
                f"SpeculationSpec.k={self.k} must be >= 1 (propose at "
                "least one draft token per step)")
        if self.draft_model.family not in CHUNKABLE_FAMILIES:
            raise ValueError(
                f"SpeculationSpec.draft_model family "
                f"{self.draft_model.family!r} cannot draft: proposals ride "
                "the fused mixed step, which needs an attention KV cache "
                f"(families {CHUNKABLE_FAMILIES})")

    @property
    def horizon(self) -> int:
        """Positions a decoding slot may consume per fused step (the ``k``
        proposals plus the bonus / correction token)."""
        return self.k + 1


@dataclass(frozen=True)
class MeshSpec:
    """How one runnable configuration maps onto devices (the reference's
    ``MeshSpec``): ``tp`` ranks cooperate on one fused step (the q/k/v and
    FFN columns, the ``wo`` and ``w2`` rows, the vocabulary and the pool's
    kv-head axis split over them, block tables and slot state whole), and
    ``dp`` engine replicas sit behind one admission queue
    (``serving.cluster.EngineCluster``).  ``MeshSpec()`` is the
    single-device engine.

    Each leaf falls back to a whole copy per rank where its axis does not
    divide ``tp`` (``distributed.sharding``): ``kv_shards`` reports how
    many ways the pool's kv heads actually split."""

    tp: int = 1   # tensor-parallel ranks of each replica's fused step
    dp: int = 1   # data-parallel engine replicas behind one queue

    def __post_init__(self) -> None:
        if self.tp < 1 or self.dp < 1:
            raise ValueError(
                f"MeshSpec needs tp >= 1 and dp >= 1, got tp={self.tp} "
                f"dp={self.dp}")

    @property
    def n_devices(self) -> int:
        return self.tp * self.dp

    def kv_shards(self, arch: ArchConfig) -> int:
        """How many ways the cache's kv-head axis splits under ``tp``: the
        divisor of the per-device KV bytes.  MLA latents carry no kv-head
        axis and always replicate."""
        if arch.mla is not None:
            return 1
        kv = arch.num_kv_heads or arch.num_heads
        return self.tp if kv % self.tp == 0 else 1


@dataclass(frozen=True)
class MeshCapacity:
    """The mesh-aware capacity plan (``RuntimeSpec.capacity()``): what
    admission can hold, per device and across the replica set."""

    n_devices: int           # tp * dp
    max_concurrent: int      # dp * max_batch admission ceiling
    pool_tokens: int         # total KV tokens across all replicas
    kv_shards: int           # ways the kv-head axis splits (1 = replicated)
    cache_bytes_per_replica: int   # one replica's pool, summed over its tp
    per_device_cache_bytes: int    # cache_bytes_per_replica / kv_shards


@dataclass(frozen=True)
class RuntimeSpec:
    """One frozen description of a runnable configuration.

    ``maxima`` (a ``core.registers.Maxima``) selects multi-topology
    serving: one engine built at the maxima serves a fleet of models
    (``serving/fabric.py``), and the spec's own arch must fit them.
    ``speculation`` (a ``SpeculationSpec``) drafts and verifies inside the
    fused step of one model or of the fleet.  ``mesh`` (a ``MeshSpec``;
    None stands for its default, one device) is how many ranks share the
    fused step (``tp``) and how many engine replicas serve behind one
    queue (``dp``).
    """

    arch: ArchConfig
    execution: ExecutionSpec = field(default_factory=ExecutionSpec)
    memory: MemorySpec = field(default_factory=MemorySpec)
    scheduler: SchedulerSpec = field(default_factory=SchedulerSpec)
    maxima: Maxima | None = None
    speculation: SpeculationSpec | None = None
    mesh: MeshSpec = field(default_factory=MeshSpec)

    def __post_init__(self) -> None:
        if self.mesh is None:
            object.__setattr__(self, "mesh", MeshSpec())
        self.validate()

    def validate(self) -> "RuntimeSpec":
        cfg, mem = self.arch, self.memory
        cfg.validate()
        decodes = cfg.family != "encoder"
        if cfg.family not in PORTED_FAMILIES:
            raise _not_ported(f"family {cfg.family!r}", "items 11-12",
                              f"; the port serves the families "
                              f"{PORTED_FAMILIES}")
        check_encdec(cfg)
        if self.maxima is not None and cfg.mla is not None:
            raise ValueError(
                f"{cfg.name}: multi-topology serving covers the dense GQA "
                "family; an MLA model's latent cache and absorbed attend "
                "have no fleet weight table (ROADMAP.md Queue 1 item 11m "
                "serves MLA on its own engine)")
        if self.maxima is not None and decodes and cfg.family != "dense":
            # the reference fabric's membership check (check_member)
            raise ValueError(
                f"{cfg.name}: multi-topology serving covers the dense GQA "
                f"family; family {cfg.family!r} needs its own engine")
        self._validate_cache_family()
        if self.speculation is not None:
            # the reference's messages: the verify pass rides the fused
            # chunked step
            if self.scheduler.policy == "bucketed":
                raise ValueError(
                    "speculation requires the chunked scheduler: the "
                    "draft-propose / target-verify pass is fused into the "
                    "chunk-shaped mixed step (the bucketed path has no "
                    "multi-position attend); use policy='auto' or "
                    "'chunked'")
            bad = self.scheduler.chunk_violations(mem)
            if self.maxima is None and cfg.family not in CHUNKABLE_FAMILIES:
                bad.append(
                    f"family {cfg.family!r} has sequential prefill state "
                    "(the verify pass needs the fused chunked step)")
            if bad:
                raise ValueError(
                    "speculation requires a satisfiable chunked scheduler: "
                    + "; ".join(bad))
        self._validate_decode_state()
        if self.speculation is not None:
            self._validate_speculation()
        if self.execution.quant == "int8":
            # the reference's _mla_attend cannot contract a quantized
            # k_up / v_up, nor its embedding add a quantized position
            # table; a draft is quantized by the same rule
            for arch in (cfg, *((self.speculation.draft_model,)
                                if self.speculation is not None else ())):
                check_mla_quant(arch, self.execution.quant_min_size)
                check_position_quant(arch, self.execution.quant_min_size)
        self._validate_mesh()
        if self.maxima is not None:
            bad = self.violations(self.maxima)
            if bad:
                hint = ""
                if any(v.startswith("sequence=") for v in bad):
                    hint = (" (the spec's sequence bound is memory.max_len "
                            "— set memory=MemorySpec(max_len=...) to the "
                            "intended sequence length)")
                raise ValueError(
                    "spec does not fit its own maxima (re-synthesis "
                    "required): " + "; ".join(bad) + hint)
        return self

    def _validate_mesh(self) -> None:
        """The reference's rules for ``mesh.tp > 1``, with its messages,
        and the port's one more: the MoE family's experts on the tp axis
        are not ported (ROADMAP.md Queue 1 item 13b)."""
        if not isinstance(self.mesh, MeshSpec):
            raise ValueError("RuntimeSpec.mesh must be a MeshSpec, got "
                             f"{type(self.mesh).__name__}")
        if self.mesh.tp == 1:
            return
        cfg = self.arch
        if self.maxima is not None:
            raise ValueError(
                "mesh.tp > 1 is not supported in multi-topology (fleet) "
                "mode: the fabric's per-slot weight-table gathers are "
                "not sharded over the model axis; run fleet members as "
                "data-parallel replicas instead (MeshSpec(dp=...))")
        if self.execution.matmul_backend != "xla" or \
                self.execution.paged_attn_impl != "gather":
            raise ValueError(
                "mesh.tp > 1 requires the XLA compute path "
                "(matmul_backend='xla', paged_attn_impl='gather'): the "
                "Pallas kernels are single-device programs GSPMD cannot "
                "partition")
        if self.scheduler.policy == "bucketed":
            raise ValueError(
                "mesh.tp > 1 requires the chunked scheduler: the "
                "bucketed path stages B=1 prefill caches on the default "
                "device, which cannot mix with a mesh-sharded pool; use "
                "policy='auto' or 'chunked'")
        if cfg.family not in CHUNKABLE_FAMILIES:
            raise ValueError(
                f"mesh.tp > 1 is unsupported for family {cfg.family!r}: "
                "tensor parallelism requires the fused chunked step "
                f"(families {CHUNKABLE_FAMILIES})")
        if cfg.family == "moe":
            raise _not_ported(
                "the MoE family under tensor parallelism (mesh.tp > 1: "
                "experts on the tp axis)", "item 13b")

    def _validate_cache_family(self) -> None:
        """The reference's refusals of a paged or int8 KV cache for a
        family whose state is not a paged attention cache (the ssm
        family's scan state, the hybrid family's RG-LRU state and rolling
        buffers, the audio family's self and cross rows, and the encoder
        family, which has no decode state)."""
        cfg, mem = self.arch, self.memory
        if mem.cache_layout == "paged" and \
                cfg.family not in ("dense", "vlm", "moe"):
            raise ValueError(
                f"cache_layout='paged' is unsupported for family "
                f"{cfg.family!r} (SSM / rolling-window / enc-dec decode "
                "state is not paged); use cache_layout='dense'")
        if mem.kv_dtype == "int8" and \
                cfg.family not in KV_QUANTIZABLE_FAMILIES:
            raise ValueError(
                f"kv_dtype='int8' is unsupported for family {cfg.family!r}: "
                "only KV/latent attention caches are quantized "
                f"(families {KV_QUANTIZABLE_FAMILIES}); recurrent / "
                "rolling-window / enc-dec decode state keeps the compute "
                "dtype — use kv_dtype='compute'")

    def _validate_decode_state(self) -> None:
        """The cache layout and the scheduler of a decoding family, with
        the reference's checks and messages: an explicit ``"chunked"``
        must be satisfiable, and the prefix cache needs the chunked
        scheduler (explicit, or ``"auto"`` resolving to it; the reference
        raises the latter in its engine)."""
        mem, sched = self.memory, self.scheduler
        if mem.prefix_cache and sched.policy == "bucketed":
            raise ValueError(
                "prefix_cache=True requires the chunked scheduler: a "
                "cache-hit request resumes prefill mid-prompt, which only "
                "the fused chunked step supports (the bucketed path always "
                "replays the whole prompt); use policy='auto' or 'chunked'")
        if sched.policy == "chunked":
            # "auto" falls back to bucketed on these; an explicit chunked
            # request fails loudly at construction instead
            bad = sched.chunk_violations(mem)
            if self.maxima is None and \
                    self.arch.family not in CHUNKABLE_FAMILIES:
                bad.append(
                    f"family {self.arch.family!r} has sequential prefill "
                    "state (chunked prefill needs an attention KV cache)")
            if bad:
                raise ValueError(
                    "scheduler policy 'chunked' is not satisfiable: "
                    + "; ".join(bad))
        if mem.prefix_cache and self.resolved_policy != "chunked":
            raise ValueError(
                "prefix_cache=True requires the chunked scheduler, but "
                "policy 'auto' resolved to 'bucketed' for this spec "
                "(a cache-hit request resumes prefill mid-prompt, which "
                "only the fused chunked step supports); fix the chunk "
                "geometry so the chunked scheduler is satisfiable")

    @property
    def resolved_policy(self) -> str:
        """The scheduler the engine runs (the reference engine's rule):
        ``"auto"`` is ``"chunked"`` where the family is chunkable (a fleet
        always is) and the chunk geometry is satisfiable, else
        ``"bucketed"``."""
        sched = self.scheduler
        if sched.policy != "auto":
            return sched.policy
        chunkable = (self.maxima is not None
                     or self.arch.family in CHUNKABLE_FAMILIES) \
            and not sched.chunk_violations(self.memory)
        return "chunked" if chunkable else "bucketed"

    def _validate_speculation(self) -> None:
        """The reference's checks of a speculating spec: the verify lanes
        fit the fused step's chunk, and the draft shares the target's
        token space (a fleet's: the maxima's vocab).  (The chunked
        scheduler it needs is checked above.)"""
        sp = self.speculation
        if not isinstance(sp, SpeculationSpec):
            raise ValueError(
                "RuntimeSpec.speculation must be a SpeculationSpec, got "
                f"{type(sp).__name__}")
        chunk = min(self.scheduler.chunk_size, self.memory.max_len)
        if sp.horizon > chunk:
            raise ValueError(
                f"SpeculationSpec.k={sp.k} needs {sp.horizon} verify "
                f"lanes but the fused step has only chunk_size={chunk} "
                "(raise SchedulerSpec.chunk_size or lower k)")
        # a fleet verifies over the maxima's vocab lanes
        target_vocab = (self.maxima.vocab if self.maxima is not None
                        else self.arch.vocab_size)
        if sp.draft_model.vocab_size != target_vocab:
            raise ValueError(
                f"speculation draft vocab_size={sp.draft_model.vocab_size} "
                f"!= target vocab {target_vocab}: draft proposals are "
                "verified as target token ids, so the models must share a "
                "tokenizer space")

    def registers(self, sequence: int, layers_dec: int | None = None, *,
                  device: str | torch.device | None = None
                  ) -> TopologyRegisters:
        """Lower to the §3.12 register file on ``device`` (default: the
        card), identical to ``registers_for(self.arch, ...)``: one
        lowering, two spellings."""
        return registers_for(self.arch, sequence, layers_dec, device=device)

    def static_registers(self, sequence: int | None = None) -> dict[str, int]:
        """The register values as plain ints (for ceiling checks): an
        enc-dec arch's encoder depth is ``encdec.num_encoder_layers`` and
        its decoder depth ``num_layers``; every other arch has no decoder
        stack (layers_dec 0)."""
        cfg = self.arch
        return {
            "sequence": self.memory.max_len if sequence is None else sequence,
            "heads": cfg.num_heads,
            "layers_enc": (cfg.encdec.num_encoder_layers if cfg.encdec
                           else cfg.num_layers),
            "layers_dec": cfg.num_layers if cfg.encdec else 0,
            "embeddings": cfg.d_model,
            "hidden": cfg.d_ff,
            "out": cfg.vocab_size,
        }

    def violations(self, maxima: Maxima,
                   mesh: MeshSpec | None = None) -> list[str]:
        """Every way this spec exceeds ``maxima`` (empty = fits).

        Mesh-aware: under tensor parallelism each device holds only its
        shard, so heads, hidden and out (the vocabulary) are checked
        divided by ``tp`` where ``tp`` divides them (an indivisible one
        stays whole on every rank and is checked whole).  ``mesh=None``
        takes the spec's own."""
        mesh = self.mesh if mesh is None else mesh
        regs = self.static_registers()
        for k in ("heads", "hidden", "out"):
            regs[k] = _shard(regs[k], mesh.tp)
        lim = {"sequence": maxima.seq_max, "heads": maxima.heads_max,
               "layers_enc": maxima.layers_enc_max,
               "layers_dec": maxima.layers_dec_max,
               "embeddings": maxima.d_model_max, "hidden": maxima.d_ff_max,
               "out": maxima.out_max}
        out = [f"{k}={regs[k]} > {lim[k]}" for k in lim if regs[k] > lim[k]]
        if self.arch.resolved_head_dim > maxima.head_dim_max:
            out.append(f"head_dim={self.arch.resolved_head_dim} > "
                       f"{maxima.head_dim_max}")
        vocab = _shard(self.arch.vocab_size, mesh.tp)
        if vocab > maxima.vocab:
            out.append(f"vocab={vocab} > {maxima.vocab}")
        return out

    def fits_within(self, maxima: Maxima,
                    mesh: MeshSpec | None = None) -> bool:
        """True iff every live dimension fits the synthesized fabric
        (exact equality is a fit: the maxima topology itself runs); under
        a tensor-parallel mesh the per-device shard is what must fit."""
        return not self.violations(maxima, mesh)

    def capacity(self, mesh: MeshSpec | None = None) -> MeshCapacity:
        """What admission can hold on this spec's mesh (or ``mesh``): dp
        independent pools and slot sets, and each pool's kv-head axis
        split ``kv_shards`` ways over its tp ranks."""
        from repro_torch.core.analytical import kv_bytes_per_token
        mesh = self.mesh if mesh is None else mesh
        mem = self.memory
        per_replica_tokens = (
            mem.resolved_num_blocks * mem.block_size
            if mem.cache_layout == "paged" else mem.max_batch * mem.max_len)
        replica_bytes = int(per_replica_tokens * kv_bytes_per_token(
            self.arch, kv_dtype=mem.kv_dtype))
        shards = mesh.kv_shards(self.arch)
        return MeshCapacity(
            n_devices=mesh.n_devices,
            max_concurrent=mesh.dp * mem.max_batch,
            pool_tokens=mesh.dp * per_replica_tokens,
            kv_shards=shards,
            cache_bytes_per_replica=replica_bytes,
            per_device_cache_bytes=replica_bytes // shards)

    @staticmethod
    def tuned(arch: ArchConfig, device_profile=None, workload=None,
              **kw) -> "RuntimeSpec":
        """The predicted-best spec for ``arch`` on a card and workload,
        ranked by the ``core.analytical`` roofline model under a
        cache-memory budget.  Thin front door over
        ``repro_torch.harness.tune.tune`` (which also exposes the full
        ranking); see that module for the knobs ``**kw`` accepts
        (``max_len``, ``execution``, ``allow_int8_kv``, ``maxima``,
        ``draft``)."""
        from repro_torch.harness.tune import tune  # core must not import harness
        return tune(arch, device=device_profile, workload=workload,
                    **kw).spec


def _shard(dim: int, tp: int) -> int:
    """A tensor-parallel rank's share of a dimension: ``dim / tp`` where
    ``tp`` divides it, else all of it (the divisibility fallback)."""
    return dim // tp if tp > 1 and dim % tp == 0 else dim


def maxima_for(*archs: ArchConfig, seq_max: int,
               layers_dec_max: int | None = None,
               mesh: MeshSpec | None = None) -> Maxima:
    """The smallest fabric covering every arch: elementwise maxima, the
    'synthesis planning' step of multi-topology serving and of the
    register-driven engine.  An enc-dec arch contributes
    ``encdec.num_encoder_layers`` encoder and ``num_layers`` decoder
    layers; ``layers_dec_max`` overrides the decoder depth.  With
    ``mesh.tp > 1`` the fabric is the per-device one: each arch
    contributes its tp shard of heads, d_ff and the vocabulary (whole
    where tp does not divide them), the check ``fits_within(maxima,
    mesh)`` makes."""
    if not archs:
        raise ValueError("maxima_for needs at least one ArchConfig")
    tp = mesh.tp if mesh is not None else 1
    enc = [a.encdec.num_encoder_layers if a.encdec else a.num_layers
           for a in archs]
    dec = [a.num_layers if a.encdec else 0 for a in archs]
    return Maxima(
        seq_max=seq_max,
        heads_max=max(_shard(a.num_heads, tp) for a in archs),
        layers_enc_max=max(enc),
        layers_dec_max=(layers_dec_max if layers_dec_max is not None
                        else max(dec)),
        d_model_max=max(a.d_model for a in archs),
        d_ff_max=max(_shard(a.d_ff, tp) for a in archs),
        out_max=max(_shard(a.vocab_size, tp) for a in archs),
        head_dim_max=max(a.resolved_head_dim for a in archs),
        vocab=max(_shard(a.vocab_size, tp) for a in archs),
    )
