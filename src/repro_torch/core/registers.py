"""Synthesis-time maxima of the register-driven fabric (the port's copy of
the reference's ``core/registers.py`` ``Maxima``).

A multi-topology engine is built once at these extents; every fleet member
runs inside them, selected per slot by register data
(``serving/fabric.py``).  ``core.spec.maxima_for`` plans them from a fleet.
"""
from __future__ import annotations

from typing import NamedTuple


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
