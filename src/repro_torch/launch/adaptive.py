"""The paper's headline demo (Alg. 18) on the port: capture ONCE, run MANY
topologies, then the Fig. 8 heads sweep on the same capture.

One ``AdaptiveEngine`` is synthesized at the maxima of the paper's three
evaluation networks (``maxima_for(adaptor-bert, shallow-transformer,
custom-encoder)``: 12 layers, d_model 768, 12 heads, head dim 66, d_ff
3072, 30522 outputs, 64 positions).  The three networks run back to back,
each an ``ArchConfig`` in a ``RuntimeSpec`` that lowers to the register
file (``spec.registers``), with random weights from a seeded
``torch.Generator``; then the heads register sweeps h = 2..12 (d_model
64h, d_ff 256h).  Every output is held to the unpadded oracle
(``core/engine_ref.py``) within the reference test's tolerance, and the
script asserts ``capture_count() == 1``: one CUDA graph served them all.
Each line prints the call's time (host clock around a synchronized call),
its distance to the oracle and its live-FLOP fraction of the padded call.

    python -m repro_torch.launch.adaptive            # on the card
    python -m repro_torch.launch.adaptive --device cpu

On the CPU the step runs eagerly, on the reference example's
quarter-scale fabric (``examples/adaptive_serving.py``: d_model 192, 12
heads of 16, 4 layers, 1000 outputs), whose networks are the paper's
three scaled into it.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import PAPER_NETWORKS
from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine_ref
from repro_torch.core.adaptive import AdaptiveEngine, EngineOptions, pack
from repro_torch.core.registers import make_registers
from repro_torch.core.spec import MemorySpec, RuntimeSpec, maxima_for
from repro_torch.kernels.runtime import resolve_device

SEQ = 64
TOL = 2e-4          # x max|want|, with rtol 1e-3 (tests/test_adaptive.py)
FIG8_HEADS = (2, 4, 6, 8, 10, 12)


def call_cost(B: int, S: int, d: int, h: int, e: int, f: int,
              layers_enc: int, layers_dec: int, out: int,
              elem_bytes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call at these extents.  FLOPs: the products
    (the elementwise work, under 1% at the paper's widths, is not
    counted): per attention block Q/K/V, QKᵀ, PV and the output
    projection, per layer the FFN, a decoder layer's second (cross)
    attention block, the unembedding.  Bytes: every weight read once
    (the embedding table only in its B x S gathered rows), the int32
    tokens read and the logits written."""
    attn_w = 4 * d * h * e + 3 * h * e + d
    enc_w = attn_w + 2 * d * f + f + d + 4 * d
    dec_w = enc_w + attn_w + 2 * d
    weights = (layers_enc * enc_w + layers_dec * dec_w + d * out + out
               + S * d)
    attn = 2 * B * S * (3 * d * h * e + 2 * h * S * e + h * e * d)
    ffn = 4 * B * S * d * f
    flops = (layers_enc * (attn + ffn) + layers_dec * (2 * attn + ffn)
             + 2 * B * S * d * out)
    nbytes = (elem_bytes * (weights + B * S * d + B * S * out)
              + 4 * B * S * (2 if layers_dec else 1))
    return flops, nbytes


def padded_cost(engine: AdaptiveEngine, B: int, S: int) -> tuple[int, int]:
    """What the fabric computes and moves for any topology: every lane and
    layer (a provisioned decoder included)."""
    mx = engine.mx
    return call_cost(B, S, mx.d_model_max, mx.heads_max, mx.head_dim_max,
                     mx.d_ff_max, mx.layers_enc_max,
                     mx.layers_dec_max if engine.has_decoder else 0,
                     mx.out_max, engine.opt.dtype.itemsize)


def live_cost(regs: dict, B: int, elem_bytes: int) -> tuple[int, int]:
    """What the topology itself needs, at its live extents (its K/V
    weights counted at ``heads``, as the fabric holds them replicated)."""
    e = regs["embeddings"] // max(regs["heads"], 1)
    return call_cost(B, regs["sequence"], regs["embeddings"], regs["heads"],
                     e, regs["hidden"], regs["layers_enc"],
                     regs["layers_dec"], regs["out"], elem_bytes)


def _encoder(name: str, d_model: int, heads: int, d_ff: int, layers: int,
             act: str, vocab: int) -> ArchConfig:
    return ArchConfig(name=name, family="encoder", num_layers=layers,
                      d_model=d_model, num_heads=heads, num_kv_heads=heads,
                      d_ff=d_ff, vocab_size=vocab, activation=act,
                      norm="layernorm", positional="learned")


def networks(device: torch.device) -> tuple[list[ArchConfig], int]:
    """The paper's three networks and the head width of the sweep: at
    their own widths on the card; on the CPU scaled into the reference
    example's quarter-scale fabric."""
    if device.type == "cuda":
        return list(PAPER_NETWORKS), 64
    return [_encoder("adaptor-bert (quarter)", 192, 12, 768, 4, "gelu", 1000),
            _encoder("shallow-transformer (quarter)", 128, 8, 512, 2, "relu",
                     1000),
            _encoder("custom-encoder (quarter)", 48, 3, 192, 2, "relu",
                     1000)], 16


def run_topology(step, engine: AdaptiveEngine, net: dict, regs, act: str,
                 tokens: torch.Tensor) -> tuple[float, float]:
    """One call of the compiled step (seconds, host clock around a
    synchronized call) and its distance to the oracle over the live
    lanes, x max|want|; raises past the tolerance."""
    s, o = regs.static()["sequence"], regs.static()["out"]
    params = pack(engine, net)
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    out = step(params, regs, int(act == "gelu"), tokens)
    sync()
    dt = time.perf_counter() - t0
    got = out[:, :s, :o]
    want = engine_ref.forward(net, tokens[:, :s], activation=act)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-3, atol=TOL * scale):
        raise AssertionError(f"output {err:.3e} from the oracle, past "
                             f"{TOL} x {scale:.3e} (rtol 1e-3)")
    return dt, err / scale


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # f32 means f32: the oracle gate assumes no TF32 in the products
    torch.backends.cuda.matmul.allow_tf32 = False
    cfgs, head_width = networks(device)
    maxima = maxima_for(*cfgs, seq_max=SEQ)
    engine = AdaptiveEngine(maxima, EngineOptions(batch=1), device=device)
    step = engine.compile()
    g = torch.Generator(device=device).manual_seed(args.seed)
    padded = padded_cost(engine, 1, SEQ)[0]
    print(f"fabric on {device}: {maxima}; {padded / 1e9:.3f} GFLOP a call; "
          "torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    t_start = time.perf_counter()
    runs = []
    for cfg in cfgs:
        spec = RuntimeSpec(arch=cfg, maxima=maxima,
                           memory=MemorySpec(max_len=SEQ))
        assert spec.fits_within(maxima), spec.violations(maxima)
        regs = spec.registers(SEQ, device=device)   # Alg. 18 step 3
        net = engine_ref.random_network(
            generator=g, seq=SEQ, d_model=cfg.d_model, heads=cfg.num_heads,
            d_ff=cfg.d_ff, layers_enc=cfg.num_layers, vocab=cfg.vocab_size,
            out=cfg.vocab_size)
        runs.append((f"{cfg.name} heads={cfg.num_heads} d={cfg.d_model} "
                     f"L={cfg.num_layers}", net, regs, cfg.activation))
    top = maxima.layers_enc_max
    for h in FIG8_HEADS:                  # Fig. 8: the heads register
        d = head_width * h
        regs = make_registers(sequence=SEQ, heads=h, layers_enc=top,
                              embeddings=d, hidden=4 * d,
                              out=maxima.out_max, device=device)
        net = engine_ref.random_network(
            generator=g, seq=SEQ, d_model=d, heads=h, d_ff=4 * d,
            layers_enc=top, vocab=maxima.vocab, out=maxima.out_max)
        runs.append((f"fig8 heads={h:2d} d={d} L={top}", net, regs, "relu"))
    for label, net, regs, act in runs:
        tokens = torch.randint(0, net["vocab"], (1, SEQ), generator=g,
                               device=device)
        dt, err = run_topology(step, engine, net, regs, act, tokens)
        frac = live_cost(regs.static(), 1, 4)[0] / padded
        print(f"  {label:48s} {dt * 1e3:8.2f} ms  max|err| / max|want| "
              f"{err:.2e}  live-FLOP fraction {frac:.3f}")
    print(f"total wall {time.perf_counter() - t_start:.1f} s; captures = "
          f"{engine.capture_count()} (the paper's no-re-synthesis claim: "
          "must be 1)")
    assert engine.capture_count() == 1


if __name__ == "__main__":
    main()
