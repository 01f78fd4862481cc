"""Deterministic, sharded, checkpointable training streams (the
reference's ``data/pipeline.py``).

Properties the trainer relies on (all test-held):

* determinism   — a row is a pure function of (seed, step, global row):
  its draws come from numpy's Philox generator keyed by those three, with
  no global state;
* sharding      — hosts draw disjoint slices of the global batch, rows
  assigned by global id, so the union over hosts does not depend on how
  many there are;
* resumability  — ``state()`` is a small dict and ``restore`` (or the
  constructor) rebuilds the stream from it, so a restarted job sees the
  very batch it would have seen next;
* packing       — documents of geometric length are packed into rows of
  ``seq_len + 1`` tokens with an EOS between them (the LM pretraining
  layout); ``targets`` are ``tokens`` shifted by one.

The generator is numpy's, not ``jax.random``, so the tokens differ from
the reference's; the properties are the same.  Batches are int64
tensors on the stream's ``device`` (``None``: the CUDA device, raising
without one).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


def _philox(*key: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(np.random.SeedSequence(
        list(key))))


@dataclasses.dataclass
class SyntheticLMStream:
    """Synthetic packed-document LM stream (Zipf-ish token distribution)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    eos_id: int = 0
    step: int = 0
    mean_doc_len: int = 64
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.host_batch = self.global_batch // self.n_hosts
        self._device = resolve_device(self.device)

    def _pack_row(self, step: int, row: int) -> np.ndarray:
        """One row of ``seq_len + 1`` tokens: documents of geometric
        length (mean ``mean_doc_len``), each followed by EOS while room
        is left."""
        rng = _philox(self.seed, step, self.host_id * self.host_batch + row)
        out = np.empty(self.seq_len + 1, np.int64)
        pos = 0
        while pos <= self.seq_len:
            ln = int(rng.geometric(1.0 / self.mean_doc_len))
            ln = max(1, min(ln, self.seq_len + 1 - pos))
            # Zipf-flavoured tokens: square a uniform to skew to low ids
            u = rng.random(ln)
            out[pos: pos + ln] = 1 + (u ** 2 * (self.vocab_size - 2)) \
                .astype(np.int64)
            pos += ln
            if pos <= self.seq_len:
                out[pos] = self.eos_id
                pos += 1
        return out

    def next(self) -> dict[str, torch.Tensor]:
        arr = torch.from_numpy(np.stack([self._pack_row(self.step, r)
                                         for r in range(self.host_batch)]))
        self.step += 1
        arr = arr.to(self._device)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step,
                "host_id": self.host_id, "n_hosts": self.n_hosts}

    @classmethod
    def restore(cls, state: dict, **fixed) -> "SyntheticLMStream":
        return cls(**{**fixed, "seed": state["seed"], "step": state["step"],
                      "host_id": state["host_id"],
                      "n_hosts": state["n_hosts"]})


@dataclasses.dataclass
class MemorizationStream:
    """A small fixed corpus ``[n_rows, seq_len + 1]`` of ids in [1, vocab),
    cycled forever (the reference quickstart's convergence check)."""

    vocab_size: int
    seq_len: int
    batch: int
    seed: int = 0
    n_rows: int = 16
    step: int = 0
    device: str | torch.device | None = None

    def __post_init__(self):
        self.corpus = torch.from_numpy(_philox(self.seed).integers(
            1, self.vocab_size, (self.n_rows, self.seq_len + 1))).to(
                resolve_device(self.device))

    def next(self) -> dict[str, torch.Tensor]:
        idx = (self.step * self.batch
               + torch.arange(self.batch, device=self.corpus.device)) \
            % self.n_rows
        rows = self.corpus[idx]
        self.step += 1
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def restore(cls, state: dict, **fixed) -> "MemorizationStream":
        return cls(**{**fixed, "seed": state["seed"], "step": state["step"]})
