"""The KV-cache codec: quantize-on-write / dequantize-on-read decode state.

The port's counterpart of the reference's ``core/kv_quant.py``.  One
``CacheCodec`` policy object rules the paged pool:

* **compute** — values are stored in the compute dtype (bf16); the codec
  is the identity and no scale tensors exist.
* **int8**    — values are stored as symmetric int8 with one float32
  scale per cache row (per (position, kv head)), reduced over the
  trailing feature dim.  Scales live in tensors shaped like the values
  minus the feature dim (``[L, NB, bs, kv]`` for the pool) and ride the
  same block tables.

``encode``/``decode`` are the only quantization math, with the reference's
numbers: ``scale = max(amax, 1e-8) / 127`` and ``round(x / scale)``
(true division, half to even), clipped to +-127.  ``cache_put`` writes
values and scales **in place** (``index_put_``) where the reference
returns updated arrays from its donated step.

Storage cost per cached row of width ``d``: ``d`` bytes of int8 values +
4 bytes of scale, against ``2 d`` bytes of bf16 (68 against 128 bytes at
head_dim 64).
"""
from __future__ import annotations

import dataclasses

import torch

KV_DTYPES = ("compute", "int8")

# Keeps a zero row's scale finite; any value quantizes to 0 against it.
_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class CacheCodec:
    """Frozen per-engine policy: how cache rows are stored and recovered."""

    kv_dtype: str = "compute"

    def __post_init__(self) -> None:
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"CacheCodec.kv_dtype={self.kv_dtype!r} is not one of "
                f"{KV_DTYPES}")

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    def storage_dtype(self, compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.dtype:
        """dtype of the cache *values* tensors."""
        return torch.int8 if self.quantized else compute_dtype

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """float ``[..., d]`` -> (int8 values ``[..., d]``, float32 scales
        ``[...]``), symmetric per row: scale = amax(|row|) / 127."""
        x32 = x.float()
        scale = x32.abs().amax(dim=-1).clamp_min(_EPS) / 127.0
        q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale

    def decode(self, values: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """int8 values + per-row scales -> float ``[..., d]``."""
        return (values.float() * scale[..., None].float()).to(dtype)

    def store(self, x: torch.Tensor, store_dtype: torch.dtype
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Values (+ scales, or None) ready for the cache write."""
        if not self.quantized:
            return x.to(store_dtype), None
        return self.encode(x)

    def cache_tensors(self, shape: tuple[int, ...], device,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Zeroed (values, scales-or-None) for one cache tensor whose
        trailing dim is the quantized feature dim."""
        vals = torch.zeros(shape, dtype=self.storage_dtype(compute_dtype),
                           device=device)
        sc = torch.zeros(shape[:-1], dtype=torch.float32, device=device) \
            if self.quantized else None
        return vals, sc

    def bytes_per_feature_row(self, d: int,
                              compute_dtype: torch.dtype = torch.bfloat16
                              ) -> int:
        """Device bytes one cached row of width ``d`` costs."""
        if self.quantized:
            return d + 4                       # int8 values + f32 scale
        return d * torch.empty((), dtype=compute_dtype).element_size()


FLOAT_CODEC = CacheCodec("compute")


def last_writer(idx: tuple[torch.Tensor, torch.Tensor], block_size: int,
                num_blocks: int) -> torch.Tensor:
    """For each write row (row-major over ``idx``'s shape), the last row
    in that order with the same (block, offset) destination: the row a
    sequential loop of the writes leaves there.  On the device, with no
    host sync."""
    blk, off = torch.broadcast_tensors(*idx)
    dest = (blk * block_size + off).reshape(-1)
    rows = torch.arange(dest.numel(), device=dest.device)
    last = torch.full((num_blocks * block_size,), -1, dtype=torch.long,
                      device=dest.device)
    last.scatter_reduce_(0, dest, rows, reduce="amax")
    return last[dest]


def cache_put(values: torch.Tensor, scales: torch.Tensor | None, idx: tuple,
              new_vals: torch.Tensor, new_scales: torch.Tensor | None
              ) -> None:
    """Write codec-stored (values, scales) at ``idx`` in place — the one
    write primitive of the paged pool; scales are None end to end in
    compute mode.

    Rows may share a destination (dead lanes and idle slots all go to the
    null block), and ``index_put_`` picks no winner among duplicates on
    CUDA.  So every row first takes the values and scale of its
    destination's ``last_writer``: each destination then receives one
    row's bytes, values and scale from the same row, whatever order the
    device applies the writes in.  Live rows never share a destination,
    so what they write is unchanged."""
    lead = torch.broadcast_shapes(idx[0].shape, idx[1].shape)
    src = last_writer(idx, values.shape[1], values.shape[0])
    values.index_put_(idx, new_vals.flatten(0, len(lead) - 1)[src]
                      .reshape(new_vals.shape))
    if new_scales is not None:
        scales.index_put_(idx, new_scales.flatten(0, len(lead) - 1)[src]
                          .reshape(new_scales.shape))


def gather_view(codec: CacheCodec, values: torch.Tensor,
                scales: torch.Tensor | None, block_tables: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Block-table gather of one layer's pool ``[NB, bs, kv, hd]`` into the
    sequence-major ``[B, nblk * bs, kv, hd]`` view, dequantized to
    ``dtype`` on the way out (values as stored in compute mode)."""
    b_, nblk = block_tables.shape
    idx = block_tables.long()
    g = values[idx].reshape(b_, nblk * values.shape[1], *values.shape[2:])
    if not codec.quantized:
        return g
    sg = scales[idx].reshape(g.shape[:-1])
    return codec.decode(g, sg, dtype)
