"""Mixture-of-experts FFN with capacity-bounded scatter dispatch (the
reference's ``models/moe.py``), and the dense FFN (``apply_ffn``).

* Routing is top-k over a float32 softmax of the router's logits, the
  selected probabilities renormalized and scaled by ``router_scale``;
  equal probabilities take the lower expert id first, as
  ``jax.lax.top_k`` does.
* Capacity is per sequence over the step's W lanes (``capacity``); dead
  lanes route too.  The slot positions within an expert come from an
  order-preserving cumsum over the flattened ``[W * k]`` slots, so a
  sequence's live lanes (its first lanes) claim capacity before its dead
  ones.  A slot past capacity is dropped: it lands in the trash row E of
  the ``[B, E + 1, C, d]`` buffer, which is discarded, and adds zero.
* The expert products are ``torch.bmm`` over the E experts with
  ``B * C`` rows each, so every expert's weights are read once a step;
  the reference computes them (and the router) with XLA einsums under
  every matmul backend.  Only the shared expert's dense projections go
  through backend ``mm``.
* Everything is sized by (B, W, E, C, k) and nothing is read on the
  host, so the dispatch replays inside a CUDA graph.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models import layers


def capacity(seq_len: int, m: MoEConfig) -> int:
    c = math.ceil(seq_len * m.experts_per_token / m.num_experts
                  * m.capacity_factor)
    return min(max(c, min(seq_len, 4)), seq_len)


def apply_ffn(x: torch.Tensor, p, activation: str, mm: str) -> torch.Tensor:
    h = layers.apply_dense(x, p.w1, mm)
    if layers.is_gated(activation):
        h = layers.activate(layers.apply_dense(x, p.wg, mm), activation) * h
    else:
        h = layers.activate(h, activation)
    return layers.apply_dense(h, p.w2, mm)


def route(x: torch.Tensor, router_w: torch.Tensor, m: MoEConfig
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing: (weights [..., k] float32, expert ids [..., k]
    int64).  A stable descending sort keeps the lower id first among
    equal probabilities."""
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = m.experts_per_token
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return m.router_scale * top_p, top_i


def _dispatch(x: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor,
              p, m: MoEConfig, activation: str, cap: int) -> torch.Tensor:
    """Expert dispatch of every sequence at once.  x: [B, S, d]; top_*:
    [B, S, k] -> [B, S, d] in x's dtype."""
    b_, s, d = x.shape
    k, e = m.experts_per_token, m.num_experts
    flat_e = top_i.reshape(b_, s * k)                    # expert of each slot
    flat_w = top_w.reshape(b_, s * k)
    # position of each slot within its expert (order-preserving)
    onehot = (flat_e[..., None] == torch.arange(e, device=x.device)
              ).to(torch.int32)                          # [B, S*k, E]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    flat_pos = pos.gather(2, flat_e[..., None])[..., 0]
    dropped = flat_pos >= cap
    e_idx = torch.where(dropped, e, flat_e)              # row E == trash
    c_idx = flat_pos.clamp(max=cap - 1).long()
    b_idx = torch.arange(b_, device=x.device)[:, None].expand(b_, s * k)
    # scatter token copies into the [B, E + 1, C, d] buffers: only the
    # trash row takes duplicate destinations
    src = x[:, :, None, :].expand(b_, s, k, d).reshape(b_, s * k, d)
    buf = x.new_zeros((b_, e + 1, cap, d))
    buf.index_put_((b_idx, e_idx, c_idx), src)
    # the expert FFNs, batched over E with B * C rows each
    rows = buf[:, :e].transpose(0, 1).reshape(e, b_ * cap, d)
    h = torch.bmm(rows, p.w1.to(x.dtype))
    if layers.is_gated(activation):
        g = torch.bmm(rows, p.wg.to(x.dtype))
        h = layers.activate(g, activation) * h
    else:
        h = layers.activate(h, activation)
    out = torch.bmm(h, p.w2.to(x.dtype)).reshape(e, b_, cap, d)
    # gather back and combine with the routing weights in x's dtype
    got = out.transpose(0, 1)[b_idx, e_idx.clamp(max=e - 1), c_idx]
    got = torch.where(dropped[..., None], 0.0, got) \
        * flat_w[..., None].to(x.dtype)
    return got.reshape(b_, s, k, d).sum(dim=2)


def apply_moe(x: torch.Tensor, p, cfg: ArchConfig, mm: str) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  Routed experts + optional shared
    expert (its projections through backend ``mm``)."""
    m = cfg.moe
    cap = capacity(x.shape[1], m)
    top_w, top_i = route(x, p.router, m)
    routed = _dispatch(x, top_w, top_i, p, m, cfg.activation, cap)
    if p.shared is not None:
        routed = routed + apply_ffn(x, p.shared, cfg.activation, mm)
    return routed


def load_balance_loss(x: torch.Tensor, router_w: torch.Tensor,
                      m: MoEConfig) -> torch.Tensor:
    """The auxiliary router balance term (Switch / GShard form, the
    reference's ``load_balance_loss``): E x sum_e f_e x p_e in float32,
    f_e the share of the top-k picks that expert e takes (over the
    probabilities, lower id first among ties, as ``route``) and p_e its
    mean softmax probability.  Only p carries a gradient."""
    e, k = m.num_experts, m.experts_per_token
    probs = torch.softmax(torch.matmul(x.float(), router_w.float()), dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    chosen = torch.zeros_like(probs).scatter_(-1, top_i, 1.0)
    f = chosen.reshape(-1, e).mean(dim=0) / k
    pbar = probs.reshape(-1, e).mean(dim=0)
    return e * torch.sum(f * pbar)
