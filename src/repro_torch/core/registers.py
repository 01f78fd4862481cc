"""Topology registers and synthesis-time maxima (the port's copy of the
reference's ``core/registers.py``, the paper's §3.12 register file).

On the FPGA the registers are AXI4-Lite words written by the MicroBlaze
before it asserts the start signal.  Here they are 0-dim int32 tensors on
the engine's device, read by an already-captured step: changing their
values never captures again, as reprogramming the register file never
re-synthesizes.  ``TopologyRegisters`` keeps the host ints it was written
from beside them, so an engine checks a topology against its ``Maxima``
and stages it into a captured graph without reading the device.

Registers (paper names kept):
  sequence    — live sequence length        (<= seq_max)
  heads       — live attention head count   (<= heads_max)
  layers_enc  — live encoder layer count    (<= layers_enc_max)
  layers_dec  — live decoder layer count    (<= layers_dec_max; 0 = enc-only)
  embeddings  — live d_model                (<= d_model_max)
  hidden      — live FFN hidden dim         (<= d_ff_max)
  out         — live output class count     (<= out_max)
plus one extension register for modern variants:
  kv_heads    — live KV head count (GQA); == heads for MHA models

A multi-topology serving engine is built once at the ``Maxima`` too; its
fleet members run inside them, selected per slot by register data
(``serving/fabric.py``).  ``core.spec.maxima_for`` plans them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import resolve_device

# the register file's order
REGISTERS = ("sequence", "heads", "layers_enc", "layers_dec", "embeddings",
             "hidden", "out", "kv_heads")


@dataclass(frozen=True, eq=False)
class TopologyRegisters:
    """The register file: ``file`` is one int32 tensor of the eight
    registers in ``REGISTERS``' order, and each register a 0-dim view of
    it; ``values`` holds the same ints on the host (None for a file that
    lives only on the device, as a captured step's static one)."""

    file: torch.Tensor
    values: tuple[int, ...] | None = None

    sequence = property(lambda self: self.file[0])
    heads = property(lambda self: self.file[1])
    layers_enc = property(lambda self: self.file[2])
    layers_dec = property(lambda self: self.file[3])
    embeddings = property(lambda self: self.file[4])
    hidden = property(lambda self: self.file[5])
    out = property(lambda self: self.file[6])
    kv_heads = property(lambda self: self.file[7])

    @property
    def head_dim(self) -> torch.Tensor:
        """d_k = embeddings / heads (paper §2.1), computed on the device."""
        return torch.div(self.embeddings, self.heads.clamp_min(1),
                         rounding_mode="floor")

    def static(self) -> dict[str, int]:
        """The registers as host ints (for ``Maxima.validate``)."""
        if self.values is None:
            raise ValueError("this register file has no host copy: it lives "
                             "only on the device")
        return dict(zip(REGISTERS, self.values))


def make_registers(*, sequence: int, heads: int, layers_enc: int,
                   layers_dec: int = 0, embeddings: int, hidden: int,
                   out: int = 0, kv_heads: int | None = None,
                   device: str | torch.device | None = None
                   ) -> TopologyRegisters:
    """Write the register file on ``device`` (default: the card).  On CUDA
    the eight ints go up from pinned memory by one asynchronous copy, so
    programming a topology never waits for the device."""
    device = resolve_device(device)
    values = (sequence, heads, layers_enc, layers_dec, embeddings, hidden,
              out if out else embeddings,
              kv_heads if kv_heads is not None else heads)
    values = tuple(int(v) for v in values)
    host = torch.tensor(values, dtype=torch.int32)
    if device.type == "cuda":
        file = host.pin_memory().to(device, non_blocking=True)
    else:
        file = host.to(device)
    return TopologyRegisters(file, values)


def registers_for(cfg: ArchConfig, sequence: int,
                  layers_dec: int | None = None, *,
                  device: str | torch.device | None = None
                  ) -> TopologyRegisters:
    """Program the register file for one architecture config (Alg. 18
    step 3).  An enc-dec config's encoder depth is
    ``encdec.num_encoder_layers`` and its decoder depth ``num_layers``."""
    return make_registers(
        sequence=sequence,
        heads=cfg.num_heads,
        layers_enc=(cfg.encdec.num_encoder_layers if cfg.encdec
                    else cfg.num_layers),
        layers_dec=(layers_dec if layers_dec is not None
                    else (cfg.num_layers if cfg.encdec else 0)),
        embeddings=cfg.d_model,
        hidden=cfg.d_ff,
        out=cfg.vocab_size,
        kv_heads=cfg.num_kv_heads,
        device=device,
    )


class Maxima(NamedTuple):
    """Synthesis-time maxima: the provisioned fabric, frozen at build."""

    seq_max: int
    heads_max: int
    layers_enc_max: int
    layers_dec_max: int
    d_model_max: int
    d_ff_max: int
    out_max: int
    head_dim_max: int
    vocab: int

    def validate(self, regs_static: dict) -> None:
        """Raise if a register value exceeds its synthesized maximum."""
        lim = {"sequence": self.seq_max, "heads": self.heads_max,
               "layers_enc": self.layers_enc_max,
               "layers_dec": self.layers_dec_max,
               "embeddings": self.d_model_max, "hidden": self.d_ff_max,
               "out": self.out_max}
        for k, mx in lim.items():
            v = regs_static.get(k)
            if v is not None and v > mx:
                raise ValueError(
                    f"register {k}={v} exceeds synthesized maximum {mx}; "
                    f"re-synthesis (recompile) required")
