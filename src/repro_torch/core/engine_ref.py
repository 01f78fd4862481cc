"""The register-driven engine's oracle (the port's copy of the reference's
``core/engine_ref.py``): one topology, unpadded.

Computes the paper's post-LN encoder/decoder (Eq. 1-7) directly at the
*live* sizes, with no masking or padding.  The engine's tests hold the
padded and masked engine's output, restricted to its live lanes, to this
oracle: idle fabric never reaches live compute.  It runs on whatever
device its network's tensors are on, so the card checks the engine
against it with nothing of the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def random_network(*, generator: torch.Generator, seq: int, d_model: int,
                   heads: int, d_ff: int, layers_enc: int,
                   layers_dec: int = 0, vocab: int = 1000,
                   out: int | None = None,
                   kv_heads: int | None = None) -> dict:
    """An unpadded post-LN network in engine-native weight naming, drawn
    from ``generator`` on its own device at the reference's scales
    (normal / sqrt(fan_in), biases x 0.1, embeddings and positions normal
    x 0.02, norms one and zero)."""
    kv_heads = kv_heads or heads
    head_dim = d_model // heads
    dev = generator.device

    def nrm(*s):
        return (torch.randn(s, generator=generator, device=dev)
                / math.sqrt(max(s[0], 1)))

    def attn() -> dict:
        return {
            "wq": nrm(d_model, heads * head_dim),
            "wk": nrm(d_model, kv_heads * head_dim),
            "wv": nrm(d_model, kv_heads * head_dim),
            "bq": nrm(heads * head_dim) * 0.1,
            "bk": nrm(kv_heads * head_dim) * 0.1,
            "bv": nrm(kv_heads * head_dim) * 0.1,
            "wo": nrm(heads * head_dim, d_model),
            "bo": nrm(d_model) * 0.1,
        }

    def layer(cross: bool = False) -> dict:
        p = {"attn": attn(),
             "ln1_g": torch.ones(d_model, device=dev),
             "ln1_b": torch.zeros(d_model, device=dev),
             "w1": nrm(d_model, d_ff), "b1": nrm(d_ff) * 0.1,
             "w2": nrm(d_ff, d_model), "b2": nrm(d_model) * 0.1,
             "ln2_g": torch.ones(d_model, device=dev),
             "ln2_b": torch.zeros(d_model, device=dev)}
        if cross:
            p["cross"] = attn()
            p["ln3_g"] = torch.ones(d_model, device=dev)
            p["ln3_b"] = torch.zeros(d_model, device=dev)
        return p

    out = out or d_model
    return {
        "seq": seq, "d_model": d_model, "heads": heads,
        "kv_heads": kv_heads, "head_dim": head_dim, "d_ff": d_ff,
        "vocab": vocab, "out": out,
        "embed": 0.02 * torch.randn(vocab, d_model, generator=generator,
                                    device=dev),
        "pos": 0.02 * torch.randn(seq, d_model, generator=generator,
                                  device=dev),
        "w_out": nrm(d_model, out),
        "b_out": torch.zeros(out, device=dev),
        "enc_layers": [layer() for _ in range(layers_enc)],
        "dec_layers": [layer(cross=True) for _ in range(layers_dec)],
    }


def slice_network(net: dict, *, d: int, h: int, f: int,
                  layers: int) -> dict:
    """An encoder ``net`` cut down to a smaller topology: its first ``d``
    lanes, ``h`` heads of d // h, ``f`` FFN lanes and ``layers`` layers.
    The oracle of a fabric that holds ``net`` but has a smaller topology
    selected (its idle lanes must not reach the live ones)."""
    hd_big, d_big, hd = net["head_dim"], net["d_model"], d // h
    h_big = net["heads"]

    def cut_in(w):
        return w.reshape(d_big, h_big, hd_big)[:d, :h, :hd].reshape(d, h * hd)

    def cut_b(b):
        return b.reshape(h_big, hd_big)[:h, :hd].reshape(-1)
    out = {**net, "d_model": d, "heads": h, "kv_heads": h, "head_dim": hd,
           "d_ff": f, "embed": net["embed"][:, :d], "pos": net["pos"][:, :d],
           "w_out": net["w_out"][:d], "dec_layers": [], "enc_layers": []}
    for lp in net["enc_layers"][:layers]:
        a = lp["attn"]
        out["enc_layers"].append({
            "attn": {"wq": cut_in(a["wq"]), "wk": cut_in(a["wk"]),
                     "wv": cut_in(a["wv"]),
                     "wo": a["wo"].reshape(h_big, hd_big, d_big)[:h, :hd, :d]
                     .reshape(h * hd, d),
                     "bq": cut_b(a["bq"]), "bk": cut_b(a["bk"]),
                     "bv": cut_b(a["bv"]), "bo": a["bo"][:d]},
            **{k: lp[k][:d] for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b",
                                      "b2")},
            "w1": lp["w1"][:d, :f], "b1": lp["b1"][:f],
            "w2": lp["w2"][:f, :d]})
    return out


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _act(x, kind: str):
    return F.gelu(x, approximate="none") if kind == "gelu" else F.relu(x)


def _mha(x, kv_src, a, heads, kv_heads, head_dim, *, causal=False):
    b_, s, _ = x.shape
    sk = kv_src.shape[1]
    rep = heads // kv_heads
    q = (x @ a["wq"] + a["bq"]).reshape(b_, s, heads, head_dim)
    k = (kv_src @ a["wk"] + a["bk"]).reshape(b_, sk, kv_heads, head_dim)
    v = (kv_src @ a["wv"] + a["bv"]).reshape(b_, sk, kv_heads, head_dim)
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s_ = torch.einsum("bqhe,bkhe->bhqk", q, k) / math.sqrt(head_dim)
    if causal:
        mask = torch.ones(s, sk, dtype=torch.bool, device=x.device).tril()
        s_ = torch.where(mask[None, None], s_, -1e30)
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bhqk,bkhe->bqhe", p, v).reshape(b_, s, heads * head_dim)
    return o @ a["wo"] + a["bo"]


def _layer(x, lp, heads, kv_heads, head_dim, act, *, causal=False,
           enc_out=None):
    a = _mha(x, x, lp["attn"], heads, kv_heads, head_dim, causal=causal)
    x = _ln(x + a, lp["ln1_g"], lp["ln1_b"])
    if enc_out is not None:
        c = _mha(x, enc_out, lp["cross"], heads, kv_heads, head_dim)
        x = _ln(x + c, lp["ln3_g"], lp["ln3_b"])
    f = _act(x @ lp["w1"] + lp["b1"], act) @ lp["w2"] + lp["b2"]
    return _ln(x + f, lp["ln2_g"], lp["ln2_b"])


def forward(net: dict, tokens: torch.Tensor, *, activation: str = "relu",
            tgt_tokens: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: [B, seq] (already at the live length).  -> [B, seq, out]."""
    h, kv, hd = net["heads"], net["kv_heads"], net["head_dim"]
    x = net["embed"][tokens] + net["pos"][: tokens.shape[1]][None]
    for lp in net["enc_layers"]:
        x = _layer(x, lp, h, kv, hd, activation)
    if net["dec_layers"]:
        y = net["embed"][tgt_tokens] + net["pos"][: tgt_tokens.shape[1]][None]
        for lp in net["dec_layers"]:
            y = _layer(y, lp, h, kv, hd, activation, causal=True, enc_out=x)
        x = y
    return x @ net["w_out"] + net["b_out"]
