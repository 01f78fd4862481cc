"""Per-slot token sampling: greedy / temperature / top-k / top-p, and the
accept / reject of speculative decoding.

The counterpart of the reference's ``sample_per_slot`` and
``speculative_accept``: temperature, top_k and top_p are [B] device
tensors, and the filter arithmetic is the reference's.  Random draws come
from one ``torch.Generator`` per slot instead of the reference's per-slot
threefry key lanes, so a stochastic stream is reproducible run to run
(same seed, same trace) but does not repeat the reference's bits.  Greedy
rows are an exact argmax.
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
    toks[rows] = draw_rows(probs, generators, live)
    return toks


def draw_rows(probs: torch.Tensor, generators: list[torch.Generator | None],
              live: list[int]) -> torch.Tensor:
    """One draw from each row of ``probs`` [n, V] (rows need not sum to
    one), row ``i`` from slot ``live[i]``'s generator: the argmax of
    probs / q with q ~ Exp(1), ``torch.multinomial``'s own draw for one
    sample without its host-side check.  -> [n] int32."""
    return torch.cat([
        (probs[i] / torch.empty_like(probs[i]).exponential_(
            1, generator=generators[b])).argmax(-1, keepdim=True)
        for i, b in enumerate(live)]).to(torch.int32)


def propose_per_slot(logits: torch.Tensor, temperature: torch.Tensor,
                     generators: list[torch.Generator | None],
                     rows: torch.Tensor | None) -> torch.Tensor:
    """A speculation draft's proposal per slot, logits [B, V] -> [B] int32:
    the argmax for greedy slots, a draw from the temperature-softened
    distribution (no top-k / top-p: the densities ``speculative_accept``
    takes in its accept ratio) for the stochastic ``rows``."""
    toks = logits.argmax(dim=-1).to(torch.int32)
    live = [b for b, g in enumerate(generators) if g is not None]
    if not live:
        return toks
    x = logits[rows].float() / temperature[rows].clamp_min(1e-6)[:, None]
    toks[rows] = draw_rows(torch.softmax(x, dim=-1), generators, live)
    return toks


def speculative_accept(target_logits: torch.Tensor, draft_toks: torch.Tensor,
                       draft_logits: torch.Tensor | None,
                       temperature: torch.Tensor,
                       generators: list[torch.Generator | None],
                       rows: torch.Tensor | None, greedy: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot accept / reject over one verify pass.

    ``target_logits`` [B, k+1, V]: lane ``j`` is the target distribution
    after the prefix plus draft tokens ``1..j``; ``draft_toks`` [B, k]
    the proposals, ``draft_toks[:, j]`` drawn from lane ``j`` of
    ``draft_logits`` [B, k, V] (None on the greedy path, which never reads
    it).  Returns ``(n_acc [B] i32, out [B, k+1] i32)``: ``out[:, :n_acc]``
    are the accepted proposals and ``out[:, n_acc]`` the bonus or
    correction token, so a slot emits ``n_acc + 1`` tokens.

    Greedy (``greedy=True``, or a slot at temperature <= 0): proposal
    ``j + 1`` is accepted iff it equals the target argmax at lane ``j``,
    cumulatively, and ``out`` is the per-lane argmax (the first maximum,
    as the reference's), so the stream is target-only greedy decode's.

    Stochastic (the slots of ``rows``: those at temperature > 0, each
    with its generator): accept
    while ``u * p_d(d) < p_t(d)`` on the temperature-softened
    distributions, u ~ U[0, 1) (k uniforms per slot), then draw the
    correction from the normalised residual ``max(p_t - p_d, 0)`` at the
    first rejected lane (``p_t`` itself at lane k when all k are
    accepted).  Per slot the draws come in one fixed order: the k
    uniforms, then the residual draw.
    """
    k = draft_toks.shape[1]
    g = target_logits.argmax(dim=-1).to(torch.int32)          # [B, k+1]
    match = (g[:, :k] == draft_toks).to(torch.int32)
    g_acc = match.cumprod(dim=1).sum(dim=1).to(torch.int32)
    live = [b for b, gen in enumerate(generators) if gen is not None]
    if greedy or not live:
        return g_acc, g
    t = temperature[rows].clamp_min(1e-6)[:, None, None]
    pt = torch.softmax(target_logits[rows].float() / t, dim=-1)
    pd = torch.softmax(draft_logits[rows].float() / t, dim=-1)
    d = draft_toks[rows].long()
    pt_d = pt[:, :k].gather(2, d[..., None])[..., 0]          # [n, k]
    pd_d = pd.gather(2, d[..., None])[..., 0]
    u = torch.stack([torch.rand(k, generator=generators[b],
                                device=target_logits.device)
                     for b in live])
    ok = (u * pd_d < pt_d).to(torch.int32)
    s_acc = ok.cumprod(dim=1).sum(dim=1)                      # [n]
    # the first rejected lane (lane k, where p_d is zero, when all k are
    # accepted)
    n = torch.arange(len(live), device=g.device)
    sel = s_acc.clamp(max=k)
    pd_pad = torch.nn.functional.pad(pd, (0, 0, 0, 1))
    resid = (pt[n, sel] - pd_pad[n, sel]).clamp_min(0)
    resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-20)
    bonus = draw_rows(resid, generators, live)
    jar = torch.arange(k + 1, device=g.device)[None, :]
    d_pad = torch.nn.functional.pad(draft_toks[rows], (0, 1))
    g_acc[rows] = s_acc.to(torch.int32)
    g[rows] = torch.where(jar < s_acc[:, None], d_pad,
                          torch.where(jar == s_acc[:, None], bonus[:, None],
                                      0)).to(torch.int32)
    return g_acc, g
