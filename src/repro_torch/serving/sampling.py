"""Per-slot token sampling: greedy / temperature / top-k / top-p.

The counterpart of the reference's ``sample_per_slot``: temperature,
top_k and top_p are [B] device tensors, and the filter arithmetic is the
reference's.  Random draws come from one ``torch.Generator`` per slot
instead of the reference's per-slot threefry key lanes, so a stochastic
stream is reproducible run to run (same seed, same trace) but does not
repeat the reference's bits.  Greedy rows are an exact argmax.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 -> greedy
    top_k: int = 0             # 0 -> disabled
    top_p: float = 1.0         # 1 -> disabled


def filtered_probs(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """[B, V] sampling distribution after temperature, top-k and top-p (the
    reference's composition: top-p over the top-k-filtered distribution)."""
    v = logits.shape[-1]
    x = logits.float() / temperature.clamp_min(1e-6)[:, None]
    sorted_x = x.sort(dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, top_k, v).clamp(1, v).long()
    kth = sorted_x.gather(1, (k_eff - 1)[:, None])
    x = torch.where(x < kth, -torch.inf, x)
    sorted_f = torch.where(sorted_x < kth, -torch.inf, sorted_x)
    probs = torch.softmax(sorted_f, dim=-1)
    cum = probs.cumsum(dim=-1)
    keep = cum - probs < top_p[:, None]
    cutoff = torch.where(keep, sorted_f, torch.inf).amin(-1, keepdim=True)
    x = torch.where(x < cutoff, -torch.inf, x)
    return torch.softmax(x, dim=-1)


def sample_per_slot(logits: torch.Tensor, temperature: torch.Tensor,
                    top_k: torch.Tensor, top_p: torch.Tensor,
                    generators: list[torch.Generator | None],
                    rows: torch.Tensor | None) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32.

    ``generators[b]`` is slot b's generator when its temperature is > 0
    and None for a greedy slot (the engine knows each slot's sampling
    parameters on the host), so an all-greedy batch costs one argmax.
    ``rows`` is the index of the stochastic slots on logits' device (None
    when there are none), which the caller keeps between calls and
    rebuilds only when its list of generators changes, so no call uploads
    it.

    A slot's draw is ``torch.multinomial(probs, 1, generator=g)``'s own for
    one sample: the argmax of probs / q with q ~ Exp(1) from ``g``, the
    same numbers drawn in the same order, without multinomial's check of
    probs, which reads a device value on the host and so waits for it.
    """
    toks = logits.argmax(dim=-1).to(torch.int32)
    live = [b for b, g in enumerate(generators) if g is not None]
    if not live:
        return toks
    probs = filtered_probs(logits[rows], temperature[rows], top_k[rows],
                           top_p[rows])
    drawn = torch.cat([
        (probs[i] / torch.empty_like(probs[i]).exponential_(
            1, generator=generators[b])).argmax(-1, keepdim=True)
        for i, b in enumerate(live)])
    toks[rows] = drawn.to(torch.int32)
    return toks
