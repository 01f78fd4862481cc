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

What the port serves so far is the dense family through the paged pool
and the chunked scheduler, with float weights and a float KV cache.
Every other option of the reference is rejected at construction with
the ROADMAP.md queue item that ports it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.configs.base import (DEFAULT_COMPUTE_DTYPE,
                                      DEFAULT_PARAM_DTYPE, ArchConfig)
from repro_torch.core.paging import PagingConfig, blocks_for_tokens

_MATMUL_BACKENDS = ("xla", "pallas")
_PAGED_ATTN_IMPLS = ("gather", "pallas")
_CACHE_LAYOUTS = ("dense", "paged")
_QUANT_MODES = ("none", "int8")
_KV_DTYPES = ("compute", "int8")
_SCHEDULER_POLICIES = ("auto", "chunked", "bucketed")

_DTYPE_ALIASES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp32": torch.float32, "f32": torch.float32, "float32": torch.float32,
    "fp16": torch.float16, "f16": torch.float16, "float16": torch.float16,
}

# Families the port serves so far.
PORTED_FAMILIES = ("dense",)


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
    hand-written ``tiled_matmul`` CUDA kernel, ``paged_attn_impl="pallas"``
    the paged attention through the hand-written ``paged_decode_attention``
    / ``chunked_prefill_attention`` kernels; the Pallas names are kept so a
    spec reads the same in the JAX reference and in the port.
    """

    matmul_backend: str = "xla"      # "xla" | "pallas" (hand-written kernel)
    paged_attn_impl: str = "gather"  # "gather" | "pallas" (hand-written kernels)
    param_dtype: Any = DEFAULT_PARAM_DTYPE
    compute_dtype: Any = DEFAULT_COMPUTE_DTYPE
    quant: str = "none"              # "none" | "int8" (not ported yet)

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
        object.__setattr__(self, "param_dtype",
                           _normalize_dtype("param_dtype", self.param_dtype))
        object.__setattr__(self, "compute_dtype",
                           _normalize_dtype("compute_dtype",
                                            self.compute_dtype))


@dataclass(frozen=True)
class MemorySpec:
    """How decode-time memory is provisioned: cache layout, pool geometry
    and the KV storage dtype (defaults as in the reference; the port serves
    ``cache_layout="paged"`` with ``kv_dtype="compute"``)."""

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
        if self.kv_dtype not in _KV_DTYPES:
            raise ValueError(
                f"MemorySpec.kv_dtype={self.kv_dtype!r} is not one of "
                f"{_KV_DTYPES}")
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
class RuntimeSpec:
    """One frozen description of a runnable configuration.

    ``maxima``, ``speculation`` and ``mesh`` are the reference's fleet,
    speculative-decoding and mesh axes; the port accepts only their
    defaults (None) until they are ported.
    """

    arch: ArchConfig
    execution: ExecutionSpec = field(default_factory=ExecutionSpec)
    memory: MemorySpec = field(default_factory=MemorySpec)
    scheduler: SchedulerSpec = field(default_factory=SchedulerSpec)
    maxima: Any = None
    speculation: Any = None
    mesh: Any = None

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> "RuntimeSpec":
        cfg, ex, mem = self.arch, self.execution, self.memory
        cfg.validate()
        if cfg.family not in PORTED_FAMILIES:
            raise _not_ported(f"family {cfg.family!r}", "items 11-12",
                              "; the port serves family 'dense'")
        if ex.quant != "none":
            raise _not_ported(f"ExecutionSpec.quant={ex.quant!r}", "item 6")
        if mem.kv_dtype != "compute":
            raise _not_ported(f"MemorySpec.kv_dtype={mem.kv_dtype!r}",
                              "item 7")
        if self.maxima is not None:
            raise _not_ported("multi-topology serving (maxima=...)", "item 8")
        if mem.prefix_cache:
            raise _not_ported("MemorySpec.prefix_cache=True", "item 9")
        if self.speculation is not None:
            raise _not_ported("speculative decoding (speculation=...)",
                              "item 10")
        if mem.cache_layout != "paged":
            raise _not_ported(
                f"cache_layout={mem.cache_layout!r}", "item 12",
                "; use MemorySpec(cache_layout='paged')")
        if self.scheduler.policy == "bucketed":
            raise _not_ported("scheduler policy 'bucketed'", "item 12",
                              "; use policy='auto' or 'chunked'")
        bad = self.scheduler.chunk_violations(mem)
        if bad:
            # the reference's "auto" falls back to the bucketed scheduler
            # here; the port has only the chunked one
            raise ValueError(
                "scheduler policy 'chunked' is not satisfiable: "
                + "; ".join(bad))
        if self.mesh is not None:
            raise _not_ported("mesh serving (mesh=...)", "item 13")
        return self
