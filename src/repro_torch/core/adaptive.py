"""The register-driven engine: one capture, any topology within maxima (C1).

The port's copy of the reference's ``core/adaptive.py``.

FPGA flow (paper)                      | This module
---------------------------------------+----------------------------------
synthesize fabric at TS_MHA/TS_FFN     | ``AdaptiveEngine(maxima)`` +
maxima, ~36 h                          | ``engine.compile()``: one CUDA
                                       | graph, captured at the first call
write AXI-Lite topology registers      | pass ``TopologyRegisters`` values
start signal                           | call the compiled step (a replay)
different model, no re-synthesis       | different registers, **no capture**

The engine is a *padded maximal* post-LN transformer encoder/decoder, the
paper's exact domain (Eq. 1-7, BERT-style): every buffer is allocated at
the synthesis maxima; topologies smaller than the maxima leave lanes idle,
and ``core.masking`` keeps idle lanes from reaching live ones (the
counterpart of unused DSPs holding garbage that never reaches an output).
Every register is a device value inside the step: a dead layer passes its
input through by a device-side select, the decoder's output is selected
by ``layers_dec > 0`` on the device, and the attention scale and the
key length come from the registers by device arithmetic, so one captured
graph serves every register setting and a step never reads the device
from the host.

The products are ``torch.matmul`` calls, as the reference's are
``jnp.einsum``: no hand-written kernel lies on this path.  GELU is the
exact erf form.

Weight layout note: GQA models are packed by *replicating* KV weights
across the head group at load time (``pack``), so the runtime compute is
uniform MHA over ``heads`` lanes, the same trick the paper uses when it
maps any head count onto the fixed PE array.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections.abc import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import masking
from repro_torch.core.registers import Maxima, TopologyRegisters
from repro_torch.kernels.runtime import HostStage, resolve_device

# uploads in flight before one waits for its staging buffer
_STAGE_DEPTH = 16


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    batch: int = 1
    dtype: torch.dtype = torch.float32
    decoder: bool = False            # provision a decoder stack (layers_dec)
    pooled_output: bool = False      # [B, out] pooled vs [B, S, out] logits


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """A parameter tree as {dotted name: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: Mapping) -> dict:
    """{dotted name: leaf} as a nested parameter tree."""
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


class AdaptiveEngine(nn.Module):
    """One synthesized 'fabric' serving every topology within its maxima.

    Its buffers are the padded maximal weights, named as the reference's
    parameter tree flattens (``embed``, ``enc.attn.wq``, ...), with a
    leading ``[layers_max]`` axis on every ``enc.*`` / ``dec.*`` leaf, so a
    weight load is one ``copy_`` per leaf into storage that never moves.
    """

    def __init__(self, maxima: Maxima, options: EngineOptions | None = None,
                 *, device: str | torch.device | None = None):
        super().__init__()
        self.mx = maxima
        self.opt = options or EngineOptions()
        self.device = resolve_device(device)
        self._layout = self.build()
        self.has_decoder = "dec.ln1_g" in self._layout
        for name, (shape, _, _) in self._layout.items():
            *path, leaf = name.split(".")
            mod = self
            for p in path:
                if not hasattr(mod, p):
                    mod.add_module(p, nn.Module())
                mod = getattr(mod, p)
            mod.register_buffer(leaf, torch.zeros(
                shape, dtype=self.opt.dtype, device=self.device))
        self._loaded: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()
        self._step: CompiledStep | None = None

    @classmethod
    def from_spec(cls, spec, *, batch: int = 1, pooled_output: bool = False,
                  device: str | torch.device | None = None
                  ) -> "AdaptiveEngine":
        """Synthesize the fabric a ``core.spec.RuntimeSpec`` describes:
        maxima from ``spec.maxima`` (required: that IS the fabric), dtype
        from ``spec.execution``, decoder stack provisioned when the maxima
        have one.  Topologies are then selected per call with
        ``spec.registers(...)``, the one configuration surface."""
        if spec.maxima is None:
            raise ValueError(
                "AdaptiveEngine.from_spec needs spec.maxima — the fabric "
                "is synthesized at the maxima, not at one topology "
                "(build them with core.spec.maxima_for)")
        opts = EngineOptions(
            batch=batch, dtype=spec.execution.param_dtype,
            decoder=spec.maxima.layers_dec_max > 0,
            pooled_output=pooled_output)
        return cls(spec.maxima, opts, device=device)

    # ------------------------------------------------------------------
    # Parameter structure (synthesis-time buffers)
    # ------------------------------------------------------------------
    def build(self) -> dict[str, tuple[tuple[int, ...], str, float | None]]:
        """Every buffer: dotted name -> (shape, init, scale), as the
        reference's ``build`` declares them (init "normal" draws at
        ``scale``, or 1 / sqrt(fan_in) with fan_in = ``shape[-2]`` of the
        stacked shape when no scale is given)."""
        mx = self.mx
        d, h, e = mx.d_model_max, mx.heads_max, mx.head_dim_max

        def attn_block() -> dict:
            return {"wq": ((d, h, e), "normal"), "wk": ((d, h, e), "normal"),
                    "wv": ((d, h, e), "normal"), "bq": ((h, e), "zeros"),
                    "bk": ((h, e), "zeros"), "bv": ((h, e), "zeros"),
                    "wo": ((h, e, d), "normal"), "bo": ((d,), "zeros")}

        def layer(cross: bool = False) -> dict:
            p = {"attn": attn_block(),
                 "ln1_g": ((d,), "ones"), "ln1_b": ((d,), "zeros"),
                 "w1": ((d, mx.d_ff_max), "normal"),
                 "b1": ((mx.d_ff_max,), "zeros"),
                 "w2": ((mx.d_ff_max, d), "normal"), "b2": ((d,), "zeros"),
                 "ln2_g": ((d,), "ones"), "ln2_b": ((d,), "zeros")}
            if cross:
                p["cross"] = attn_block()
                p["ln3_g"] = ((d,), "ones")
                p["ln3_b"] = ((d,), "zeros")
            return p

        out = {"embed": ((mx.vocab, d), "normal", 0.02),
               "pos": ((mx.seq_max, d), "normal", 0.02),
               "w_out": ((d, mx.out_max), "normal", None),
               "b_out": ((mx.out_max,), "zeros", None)}
        stacks = {"enc": (mx.layers_enc_max, layer())}
        if self.opt.decoder and mx.layers_dec_max:
            stacks["dec"] = (mx.layers_dec_max, layer(cross=True))
        for stack, (n, tree) in stacks.items():
            for name, (shape, init) in flatten(tree).items():
                out[f"{stack}.{name}"] = ((n, *shape), init, None)
        return out

    def params(self) -> dict:
        """The buffers as the reference's parameter tree (a nested dict of
        the engine's own tensors: a call with it loads nothing)."""
        return unflatten(dict(self.named_buffers()))

    def init(self, generator: torch.Generator) -> dict:
        """Random weights at the reference ``ParamBuilder``'s scales,
        drawn from ``generator`` on its own device into the buffers in
        the order of ``build``; returns ``params()``."""
        bufs = dict(self.named_buffers())
        for name, (shape, init, scale) in self._layout.items():
            buf = bufs[name]
            if init == "zeros":
                buf.zero_()
            elif init == "ones":
                buf.fill_(1.0)
            else:
                if scale is None:
                    scale = 1.0 / math.sqrt(max(shape[-2], 1))
                buf.copy_(scale * torch.randn(shape, generator=generator,
                                              device=generator.device))
        self._loaded.clear()
        return self.params()

    def load(self, params: Mapping) -> None:
        """Copy a parameter tree into the buffers (the paper's
        weight-loading unit): one ``copy_`` per leaf, none for a leaf that
        is the buffer itself or the tensor this buffer last took."""
        flat = flatten(params)
        bufs = dict(self.named_buffers())
        if flat.keys() != bufs.keys():
            raise ValueError(
                "params do not match the fabric's buffers: missing "
                f"{sorted(bufs.keys() - flat.keys())}, unexpected "
                f"{sorted(flat.keys() - bufs.keys())}")
        for name, src in flat.items():
            buf = bufs[name]
            if src is buf or self._loaded.get(name) is src:
                continue
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(f"params[{name!r}] has shape "
                                 f"{tuple(src.shape)}, the fabric "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src)
            self._loaded[name] = src

    def buffer_ptrs(self) -> tuple[int, ...]:
        """Every buffer's device address (a captured graph reads them)."""
        return tuple(b.data_ptr() for b in self.buffers())

    # ------------------------------------------------------------------
    # Masked compute (Eq. 1-7 with live-lane masking)
    # ------------------------------------------------------------------
    def _activate(self, x: torch.Tensor, act_sel: torch.Tensor
                  ) -> torch.Tensor:
        """Runtime-selected activation unit (§3.4): 0 = ReLU, 1 = GELU
        (exact erf form); both are computed, the register selects."""
        x32 = x.float()
        return torch.where(act_sel == 1, F.gelu(x32, approximate="none"),
                           F.relu(x32)).to(x.dtype)

    def _mha(self, x: torch.Tensor, kv_src: torch.Tensor, w: dict,
             regs: TopologyRegisters, *, causal: bool) -> torch.Tensor:
        """Masked multi-head attention: QKV_PM -> QK_PM -> softmax -> SV_PM."""
        mx = self.mx
        h, e, d = mx.heads_max, mx.head_dim_max, mx.d_model_max
        hd_live = regs.head_dim
        he = masking.dim_mask(h, regs.heads, torch.bool)[:, None] \
            & masking.dim_mask(e, hd_live, torch.bool)[None, :]

        def proj(src, kernel, bias):            # [B, S, d] -> [B, h, S, e]
            y = (src @ kernel.reshape(d, h * e)).unflatten(-1, (h, e))
            return torch.where(he, y + bias, 0).transpose(1, 2)

        q = proj(x, w["wq"], w["bq"])
        k = proj(kv_src, w["wk"], w["bk"])
        v = proj(kv_src, w["wv"], w["bv"])
        scale = torch.rsqrt(hd_live.clamp_min(1).float())
        s = (q @ k.transpose(-1, -2)).float() * scale
        if causal:
            qpos = torch.arange(s.shape[-2], device=s.device)[:, None]
            kpos = torch.arange(s.shape[-1], device=s.device)[None, :]
            s = torch.where(kpos <= qpos, s, masking.NEG_INF)
        kv_live = regs.sequence  # kv length == live sequence for both stacks
        p = masking.masked_softmax(s, kv_live, axis=-1)
        o = torch.where(he, (p.to(v.dtype) @ v).transpose(1, 2), 0)
        a = o.flatten(-2) @ w["wo"].reshape(h * e, d)
        return a + w["bo"]

    def _ffn(self, x: torch.Tensor, w: dict, regs: TopologyRegisters,
             act_sel: torch.Tensor) -> torch.Tensor:
        f_live = masking.dim_mask(self.mx.d_ff_max, regs.hidden, torch.bool)
        f1 = torch.where(f_live, x @ w["w1"] + w["b1"], 0)
        f1 = torch.where(f_live, self._activate(f1, act_sel), 0)
        return f1 @ w["w2"] + w["b2"]

    def _layer(self, x: torch.Tensor, w: dict, regs: TopologyRegisters,
               act_sel: torch.Tensor, *, causal: bool,
               enc_out: torch.Tensor | None = None) -> torch.Tensor:
        d = regs.embeddings
        a = self._mha(x, x, w["attn"], regs, causal=causal)
        x = masking.masked_layernorm(x + a, w["ln1_g"], w["ln1_b"], d)
        if enc_out is not None:
            c = self._mha(x, enc_out, w["cross"], regs, causal=False)
            x = masking.masked_layernorm(x + c, w["ln3_g"], w["ln3_b"], d)
        f = self._ffn(x, w, regs, act_sel)
        return masking.masked_layernorm(x + f, w["ln2_g"], w["ln2_b"], d)

    def _embed(self, params: dict, tokens: torch.Tensor,
               regs: TopologyRegisters) -> torch.Tensor:
        x = params["embed"][tokens] + params["pos"][: tokens.shape[1]][None]
        x = masking.mask_lanes(x, regs.embeddings, axis=-1)
        return masking.mask_lanes(x, regs.sequence, axis=1)

    def _stack(self, x: torch.Tensor, stacked: dict, n_live: torch.Tensor,
               regs: TopologyRegisters, act_sel: torch.Tensor, *,
               causal: bool, enc_out: torch.Tensor | None = None
               ) -> torch.Tensor:
        n_max = next(iter(flatten(stacked).values())).shape[0]
        for i in range(n_max):
            w = _tree_map(lambda leaf, i=i: leaf[i], stacked)
            h2 = self._layer(x, w, regs, act_sel, causal=causal,
                             enc_out=enc_out)
            x = torch.where(n_live > i, h2, x)  # idle layers pass through
        return x

    # ------------------------------------------------------------------
    # The step (Alg. 18 body)
    # ------------------------------------------------------------------
    def serve_fn(self) -> Callable:
        """Returns f(params, regs, act_sel, tokens[, tgt_tokens]) -> logits,
        the eager step: ``params`` a tree of tensors on the engine's
        device, ``regs`` and the 0-dim ``act_sel`` device tensors."""
        opt = self.opt

        def step(params: dict, regs: TopologyRegisters,
                 act_sel: torch.Tensor, tokens: torch.Tensor,
                 tgt_tokens: torch.Tensor | None = None) -> torch.Tensor:
            x = self._embed(params, tokens, regs)
            x = self._stack(x, params["enc"], regs.layers_enc, regs,
                            act_sel, causal=False)
            if opt.decoder and "dec" in params:
                y = self._embed(params, tgt_tokens, regs)
                y = self._stack(y, params["dec"], regs.layers_dec, regs,
                                act_sel, causal=True, enc_out=x)
                x = torch.where(regs.layers_dec > 0, y, x)
            if opt.pooled_output:
                x = masking.masked_mean_pool(x, regs.sequence)[:, None]
            logits = x @ params["w_out"] + params["b_out"]
            return masking.mask_lanes(logits, regs.out, axis=-1)

        return step

    def compile(self) -> "CompiledStep":
        """'Synthesis': the step ``f(params, regs, act_sel, tokens[,
        tgt_tokens])`` whose every later topology is a register write.  On
        CUDA its first call at each static key (batch, sequence length,
        token dtype) captures one CUDA graph, and every later call stages
        the registers, ``act_sel`` and the tokens into that graph's static
        inputs and replays it; on the CPU it runs eagerly."""
        if self._step is None:
            self._step = CompiledStep(self)
        return self._step

    def capture_count(self) -> int:
        """The counterpart of the reference's ``trace_count``: the static
        keys the compiled step has met (on CUDA one captured graph each);
        it must stay 1 across topologies."""
        return 0 if self._step is None else len(self._step.keys)


@dataclasses.dataclass
class _Graph:
    """One captured step and its static inputs and output."""

    graph: torch.cuda.CUDAGraph
    regs: torch.Tensor           # [9] int32: the register file, act_sel
    tokens: torch.Tensor         # [B, S] int32
    tgt: torch.Tensor | None     # [B, S] int32, when a decoder is provisioned
    out: torch.Tensor
    ptrs: tuple[int, ...]        # the buffers' addresses at capture
    stage: HostStage


class CompiledStep:
    """``AdaptiveEngine.compile()``'s step (see there)."""

    def __init__(self, engine: AdaptiveEngine):
        self.engine = engine
        self.keys: set[tuple] = set()
        self._graphs: dict[tuple, _Graph] = {}
        self._stream: torch.cuda.Stream | None = None
        self._pool = None

    def __call__(self, params: Mapping, regs: TopologyRegisters, act_sel,
                 tokens: torch.Tensor,
                 tgt_tokens: torch.Tensor | None = None) -> torch.Tensor:
        eng = self.engine
        static = regs.static()
        eng.mx.validate(static)
        hd = static["embeddings"] // max(static["heads"], 1)
        if hd > eng.mx.head_dim_max:
            raise ValueError(
                f"register head_dim={hd} (embeddings // heads) exceeds "
                f"synthesized maximum {eng.mx.head_dim_max}; re-synthesis "
                "(recompile) required")
        decoder = eng.has_decoder
        if tgt_tokens is not None and tgt_tokens.shape != tokens.shape:
            raise ValueError(f"tgt_tokens {tuple(tgt_tokens.shape)} must "
                             f"match tokens {tuple(tokens.shape)}")
        if decoder and tgt_tokens is None:
            if static["layers_dec"] > 0:
                raise ValueError("layers_dec > 0 needs tgt_tokens")
            tgt_tokens = tokens          # read, then discarded by the select
        eng.load(params)
        key = (tokens.shape[0], tokens.shape[1], tokens.dtype)
        act = (act_sel if isinstance(act_sel, torch.Tensor)
               and act_sel.device.type == "cuda" else int(act_sel))
        if eng.device.type != "cuda":
            self.keys.add(key)
            regs_t = TopologyRegisters(regs.file.to(eng.device))
            act_t = torch.tensor(act, dtype=torch.int32, device=eng.device)
            return eng.serve_fn()(
                eng.params(), regs_t, act_t, torch.as_tensor(
                    tokens, device=eng.device),
                None if not decoder else torch.as_tensor(
                    tgt_tokens, device=eng.device))
        g = self._graphs.get(key)
        fresh = g is None
        if fresh:
            g = self._static_inputs(tokens.shape, decoder)
        self._stage(g, regs, act, tokens, tgt_tokens)
        if fresh:
            self._capture(g)
            self._graphs[key] = g
            self.keys.add(key)
        else:
            if eng.buffer_ptrs() != g.ptrs:
                raise RuntimeError("a fabric buffer moved since the capture; "
                                   "load weights with engine.load (copy_)")
            g.graph.replay()
        return g.out.clone()

    def _static_inputs(self, shape, decoder: bool) -> _Graph:
        dev = self.engine.device
        i32 = dict(dtype=torch.int32, device=dev)
        n = 9 + (2 if decoder else 1) * shape[0] * shape[1]
        return _Graph(graph=torch.cuda.CUDAGraph(),
                      regs=torch.zeros(9, **i32),
                      tokens=torch.zeros(shape, **i32),
                      tgt=torch.zeros(shape, **i32) if decoder else None,
                      out=None, ptrs=(), stage=HostStage(n, dev,
                                                         _STAGE_DEPTH))

    def _stage(self, g: _Graph, regs: TopologyRegisters, act, tokens,
               tgt_tokens) -> None:
        """Registers and act_sel go up from the host ints through pinned
        memory; tokens on the card are copied on the device, tokens on the
        host staged with the registers.  No host sync either way."""
        if isinstance(act, torch.Tensor):
            pairs = [(g.regs[:8], regs.values)]
            g.regs[8].copy_(act)
        else:
            pairs = [(g.regs, (*regs.values, act))]
        for dst, src in ((g.tokens, tokens), (g.tgt, tgt_tokens)):
            if dst is None:
                continue
            if isinstance(src, torch.Tensor) and src.device.type == "cuda":
                dst.copy_(src)
            else:
                pairs.append((dst, src))
        g.stage.put(*pairs)

    def _capture(self, g: _Graph) -> None:
        """Warm up (this call's own step, eager) and capture on a side
        stream, ordered after the staging on the current stream and
        before what follows there, without a host sync."""
        eng = self.engine
        dev = eng.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        step = eng.serve_fn()
        regs = TopologyRegisters(g.regs[:8])
        args = (eng.params(), regs, g.regs[8], g.tokens, g.tgt)
        side, current = self._stream, torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            step(*args)                          # the warm-up
            g.graph.capture_begin(pool=self._pool)
            try:
                g.out = step(*args)
            except Exception as err:
                try:
                    g.graph.capture_end()
                except RuntimeError:
                    pass                         # the capture was invalid
                raise RuntimeError("capturing the register-driven step as "
                                   f"a CUDA graph failed: {err}") from err
            g.graph.capture_end()
        current.wait_stream(side)
        g.ptrs = eng.buffer_ptrs()
        g.graph.replay()


# ---------------------------------------------------------------------------
# Weight packing: unpadded topology weights -> padded engine buffers
# ---------------------------------------------------------------------------
def pack(engine: AdaptiveEngine, net: dict) -> dict:
    """Pack an unpadded post-LN network (``engine_ref.random_network``,
    numpy or torch leaves) into fresh tensors shaped as the engine's
    buffers, on its device in its dtype: the paper's weight-loading units
    (§3.1-3.3), with KV weights replicated across the head group for GQA
    topologies.  Lanes and layers past the topology are zero."""
    mx, dev, dt = engine.mx, engine.device, engine.opt.dtype
    shapes = {n: s for n, (s, _, _) in engine.build().items()}
    d, h, hd = net["d_model"], net["heads"], net["head_dim"]
    kv = net.get("kv_heads", h)
    rep = h // kv

    def t(a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))
        return a.to(device=dev, dtype=dt)

    def pad_to(a, shape) -> torch.Tensor:
        a = t(a)
        out = torch.zeros(shape, dtype=dt, device=dev)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    def pack_attn(a: dict, shp: Callable) -> dict:
        def split(w_, n):                 # [d, n*hd] -> [d, n, hd]
            return t(w_).reshape(-1, n, hd)
        wk = split(a["wk"], kv).repeat_interleave(rep, dim=1)
        wv = split(a["wv"], kv).repeat_interleave(rep, dim=1)
        return {
            "wq": pad_to(split(a["wq"], h), shp("wq")),
            "wk": pad_to(wk, shp("wk")), "wv": pad_to(wv, shp("wv")),
            "bq": pad_to(t(a["bq"]).reshape(h, hd), shp("bq")),
            "bk": pad_to(t(a["bk"]).reshape(kv, hd)
                         .repeat_interleave(rep, 0), shp("bk")),
            "bv": pad_to(t(a["bv"]).reshape(kv, hd)
                         .repeat_interleave(rep, 0), shp("bv")),
            "wo": pad_to(t(a["wo"]).reshape(h, hd, d), shp("wo")),
            "bo": pad_to(a["bo"], shp("bo")),
        }

    def stack(name: str, layers: list) -> dict:
        def shp(leaf: str, sub: str = "") -> tuple[int, ...]:
            return shapes[f"{name}.{sub}{leaf}"][1:]
        packed = []
        for lp in layers:
            out = {"attn": pack_attn(lp["attn"],
                                     lambda k: shp(k, "attn."))}
            for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b",
                      "w1", "b1", "w2", "b2"):
                out[k] = pad_to(lp[k], shp(k))
            if "cross" in lp:
                out["cross"] = pack_attn(lp["cross"],
                                         lambda k: shp(k, "cross."))
                out["ln3_g"] = pad_to(lp["ln3_g"], shp("ln3_g"))
                out["ln3_b"] = pad_to(lp["ln3_b"], shp("ln3_b"))
            packed.append(flatten(out))
        flat = {}
        for leaf in (n[len(name) + 1:] for n in shapes
                     if n.startswith(name + ".")):
            full = torch.zeros(shapes[f"{name}.{leaf}"], dtype=dt,
                               device=dev)
            for i, lp in enumerate(packed):
                full[i] = lp[leaf]
            flat[leaf] = full
        return unflatten(flat)

    out = {k: pad_to(net[k], shapes[k])
           for k in ("embed", "pos", "w_out", "b_out")}
    out["enc"] = stack("enc", net["enc_layers"])
    if "dec.ln1_g" in shapes:
        out["dec"] = stack("dec", net.get("dec_layers") or [])
    return out
