"""The encoder family (the paper's networks: adaptor-bert,
shallow-transformer, custom-encoder) as a model of the port, against the
JAX reference's ``Model`` on the CPU.

The configs are ``reduced`` (2 layers, d_model 64, 4 heads of 16, vocab
128); custom-encoder keeps its odd widths, d_model 200 over 3 heads of
200 // 3 = 66 (``head_dim`` 0: q/k/v 198 wide).  Weights come from the
reference's ``Model(cfg).init(PRNGKey(0))`` through numpy and
``repro_torch.bridge.from_jax_params``; tokens from a numpy seed.
Checked, each with its tolerance:

* the bridge leaf for leaf (``layers.<i>.{ln1, attn, ln2, ffn}`` with the
  FFN's biases, ``pos_embed.table``, the untied ``lm_head``);
* ``forward`` (non-causal, learned positions) at f32 compute within 1e-5
  x max|logits| (other orders of float32 sums) and at bf16 within the
  reference's 2e-2 x max|logits|, on the plain route and on the kernels'
  plain versions (``matmul_backend="pallas"``), a sequence past the
  position table's end clamped as the reference clamps it;
* ``RuntimeSpec`` accepts an encoder without ``maxima`` and refuses the
  paged layout and an int8 cache with the reference's messages;
  ``ServingEngine`` refuses it with the reference engine's message, and
  ``prefill``, ``decode_step`` and ``mixed_step`` with the same reason;
* int8 weights follow the reference's size rule (``check_position_quant``
  refuses full-width adaptor-bert's 512 x 768 position table);
* ``program_launches(cfg, "forward")`` against the wrappers' calls: 6L
  ``tiled_matmul`` and 2L + 1 ``layernorm`` (and, for a decoder, a
  forward launches what its prefill does).
"""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import ExecutionSpec, MemorySpec, RuntimeSpec
from repro_torch.kernels import counts
from repro_torch.kernels import layernorm as ln_mod
from repro_torch.kernels import tiled_matmul as tm_mod
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

PAPER = ("adaptor-bert", "shallow-transformer", "custom-encoder")
# custom-encoder keeps its 200-wide model over 3 heads of 66
ODD = dict(d_model=200, num_heads=3, num_kv_heads=3, head_dim=0)
LOGIT_TOL = 2e-2        # x max|logits|, tests/test_decode_equivalence.py
FN_TOL = 1e-5           # x max|out|, float32 (other orders of sums)
SEQ = 24


def _overrides(name: str) -> dict:
    return ODD if name == "custom-encoder" else {}


@pytest.fixture(scope="module")
def ref():
    """Per network: the reference's reduced config, params, the port's
    state dict, seeded tokens and the reference's logits at f32 and bf16
    compute."""
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine

    nets = {}
    for i, name in enumerate(PAPER):
        j_cfg = j_reduced(REGISTRY[name], **_overrides(name))
        cfg = reduced(get_config(name), **_overrides(name))
        params = JModel(j_cfg).init(jax.random.PRNGKey(0))
        toks = np.random.RandomState(i).randint(
            0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
        want = {c: np.asarray(jax.jit(JModel(j_cfg, ModelOptions(
            compute_dtype=dt)).forward)(params,
                                        {"tokens": jnp.asarray(toks)}))
            for c, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16))}
        nets[name] = types.SimpleNamespace(
            cfg=cfg, j_cfg=j_cfg, params=params, toks=toks, want=want,
            sd=from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu"))
    return types.SimpleNamespace(jax=jax, jnp=jnp, nets=nets, spec=j_spec,
                                 model=JModel, options=ModelOptions,
                                 engine=JServingEngine)


def _model(net, dtype=torch.float32, **kw) -> Model:
    m = Model(net.cfg, compute_dtype=dtype, device="cpu", **kw)
    m.load_state_dict(net.sd)
    return m


def _close(want, got, rel):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert np.isfinite(got).all() and want.shape == got.shape
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def test_custom_encoder_widths():
    cfg = reduced(get_config("custom-encoder"), **ODD)
    assert cfg.family == "encoder" and cfg.resolved_head_dim == 66
    m = Model(cfg, device="meta")
    assert tuple(m.layers[0].attn.wq.kernel.shape) == (200, 198)
    assert tuple(m.layers[0].attn.wo.kernel.shape) == (198, 200)
    full = Model(get_config("custom-encoder"), device="meta")
    assert tuple(full.layers[0].attn.wk.kernel.shape) == (200, 198)
    assert full.pos_embed.table.shape == (512, 200)
    assert full.layers[0].ffn.w1.bias is not None   # layernorm: biased FFN


@pytest.mark.parametrize("name", PAPER)
def test_bridge_carries_every_leaf(ref, name):
    net = ref.nets[name]
    m = Model(net.cfg, device="cpu")
    assert set(net.sd) == set(m.state_dict())
    for k, t in net.sd.items():
        assert tuple(t.shape) == tuple(m.state_dict()[k].shape), k
    assert "pos_embed.table" in net.sd and "lm_head.table" in net.sd
    assert "layers.1.ffn.w2.bias" in net.sd


@pytest.mark.parametrize("mm", ["xla", "pallas"])
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("name", PAPER)
def test_forward_matches_reference(ref, name, compute, mm):
    """f32 within 1e-5 x max|logits|, bf16 within 2e-2 x max|logits|, on
    the plain route and on the kernels' plain versions."""
    net = ref.nets[name]
    dt = torch.float32 if compute == "fp32" else torch.bfloat16
    got = _model(net, dt, matmul_backend=mm).forward(
        torch.from_numpy(net.toks))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, SEQ, net.cfg.vocab_size)
    _close(net.want[compute], got, FN_TOL if compute == "fp32" else LOGIT_TOL)


def test_forward_is_not_causal(ref):
    """A change at the last position moves the first position's logits
    (an encoder attends both ways), and a sequence past the position
    table reuses its last row, as the reference clamps it."""
    net = ref.nets["adaptor-bert"]
    m = _model(net)
    toks = torch.from_numpy(net.toks)
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % net.cfg.vocab_size
    assert not torch.equal(m.forward(toks)[:, 0], m.forward(other)[:, 0])
    cfg = dataclasses.replace(net.cfg, max_position_embeddings=16)
    j_cfg = dataclasses.replace(net.j_cfg, max_position_embeddings=16)
    params = dict(net.params, pos_embed={
        "table": net.params["pos_embed"]["table"][:16]})
    want = ref.jax.jit(ref.model(j_cfg, ref.options(
        compute_dtype=ref.jnp.float32)).forward)(
            params, {"tokens": ref.jnp.asarray(net.toks)})
    short = Model(cfg, compute_dtype=torch.float32, device="cpu")
    short.load_state_dict(from_jax_params(
        ref.jax.tree.map(np.asarray, params), cfg, "cpu"))
    _close(want, short.forward(toks), FN_TOL)


def test_spec_takes_an_encoder_without_maxima(ref):
    cfg = ref.nets["adaptor-bert"].cfg
    j_cfg = ref.nets["adaptor-bert"].j_cfg
    spec = RuntimeSpec(arch=cfg, memory=MemorySpec(max_len=64))
    assert spec.validate() is spec and spec.maxima is None
    for kw in (dict(cache_layout="paged", max_len=64, block_size=16),
               dict(kv_dtype="int8", max_len=64)):
        with pytest.raises(ValueError) as mine:
            RuntimeSpec(arch=cfg, memory=MemorySpec(**kw))
        with pytest.raises(ValueError) as want:
            ref.spec.RuntimeSpec(arch=j_cfg, memory=ref.spec.MemorySpec(**kw))
        assert str(mine.value) == str(want.value)
        assert "family 'encoder'" in str(mine.value)


def test_engine_refuses_with_the_reference_message(ref):
    """The reference serves no encoder through its engine; the port's
    engine and the model's three decode entry points give its reason."""
    net = ref.nets["shallow-transformer"]
    with pytest.raises(ValueError) as want:
        ref.engine(ref.spec.RuntimeSpec(arch=net.j_cfg))
    with pytest.raises(ValueError) as mine:
        ServingEngine(RuntimeSpec(arch=net.cfg), device="cpu")
    assert str(mine.value) == str(want.value) \
        == "encoder-only archs have no decode step"
    m = _model(net)
    toks = torch.from_numpy(net.toks)
    one = torch.zeros(2, dtype=torch.int32)
    calls = {"prefill": lambda: m.prefill(toks, 32),
             "decode_step": lambda: m.decode_step(None, toks[:, :1], one),
             "mixed_step": lambda: m.mixed_step(None, toks, one, one)}
    for name, call in calls.items():
        with pytest.raises(ValueError,
                           match="encoder-only archs have no decode step"):
            call()


def test_int8_weights_follow_the_size_rule():
    """Full-width adaptor-bert's position table (512 x 768 = 393216
    elements) is past the default floor: the reference cannot add a
    quantized table, so the model and the spec refuse it; at a floor above
    it the weights are float and the model builds."""
    full = get_config("adaptor-bert")
    with pytest.raises(ValueError, match="pos_embed"):
        Model(full, quant="int8", device="meta")
    with pytest.raises(ValueError, match="pos_embed"):
        RuntimeSpec(arch=full, execution=ExecutionSpec(quant="int8"))
    cfg = reduced(full)
    m = Model(cfg, quant="int8", quant_min_size=512 * 64 + 1, device="cpu")
    assert all(t.dtype != torch.int8 for t in m.state_dict().values())


def _counting(calls: dict):
    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return mock.patch.object(mod, name, counted)
    return [wrap(tm_mod, "tiled_matmul"), wrap(ln_mod, "layernorm"),
            wrap(ln_mod, "rmsnorm")]


def _forward_calls(model, toks, program="forward") -> dict:
    calls: dict = {}
    patches = _counting(calls)
    for p in patches:
        p.start()
    try:
        if program == "forward":
            model.forward(toks)
        else:
            model.prefill(toks, toks.shape[1])
    finally:
        for p in patches:
            p.stop()
    return calls


@pytest.mark.parametrize("name", PAPER)
def test_forward_launches_count_the_wrappers(ref, name):
    net = ref.nets[name]
    L = net.cfg.num_layers
    want = counts.program_launches(net.cfg, "forward", layout="dense")
    assert (want["tiled_matmul"], want["layernorm"], want["rmsnorm"]) \
        == (6 * L, 2 * L + 1, 0)
    calls = _forward_calls(_model(net, matmul_backend="pallas"),
                           torch.from_numpy(net.toks))
    assert {n: calls.get(n, 0) for n in want if n != "int8_matmul"} \
        == {n: c for n, c in want.items() if n != "int8_matmul"}


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "whisper-medium"])
def test_a_decoders_forward_launches_its_prefill(name):
    """Beside the encoder: a decoder's forward launches what its prefill
    does (the same products and norms, no cache written)."""
    cfg = reduced(get_config(name))
    frontend = None
    if cfg.encdec is not None:
        frames = cfg.encdec.encoder_seq_len
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, num_tokens=frames))
        frontend = torch.zeros(1, frames, cfg.d_model)
    m = Model(cfg, device="cpu", matmul_backend="pallas").init(
        torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 8), dtype=torch.int32)
    want = counts.program_launches(cfg, "forward", layout="dense")
    assert want == counts.program_launches(cfg, "prefill", layout="dense")
    calls: dict = {}
    patches = _counting(calls)
    for p in patches:
        p.start()
    try:
        m.forward(toks, frontend)
    finally:
        for p in patches:
            p.stop()
    assert {n: calls.get(n, 0) for n in want if n != "int8_matmul"} \
        == {n: c for n, c in want.items() if n != "int8_matmul"}
