"""The register-driven engine in the port (the paper's claim C1) against
the JAX reference's ``core/adaptive.py``, ``core/engine_ref.py``,
``core/registers.py`` and the scalar helpers of ``core/masking.py``.

Inputs come from numpy seeds or the reference's PRNG keys and go through
numpy into both packages.  Checked:

* the six masking helpers at live extents 0, 1, a fraction and the
  maximum, within 1e-6;
* the paper's three configs field for field;
* ``make_registers``, ``registers_for`` and ``RuntimeSpec.registers``
  for the three networks and an enc-dec config, ``maxima_for`` and
  ``Maxima.validate``'s messages;
* ``pack`` leaf for leaf, exactly, on ``tests/test_adaptive.py``'s four
  topologies (GQA included), and ``from_jax_adaptive`` equal to it;
* ``engine_ref.forward`` within 1e-5 x max|out|;
* the engine on the reference's packed weights: the four topologies and
  the idle-lane case within 1e-4 x max|out| of the reference engine's
  ``compile()`` output and within the reference test's own tolerance of
  the oracle; the bf16 option within 2e-2 x max|out| of the reference's
  bf16 engine;
* NaN planted in dead weight lanes and dead layers never reaching a live
  output;
* the sequence of dispatched aten operators (name, shapes, scalars)
  identical across the four topologies: the CPU proof that one capture
  serves them; ``capture_count`` counting a new static key as the
  reference's jit cache counts a retrace;
* weight loads: one ``copy_`` per new leaf, none for leaves already
  loaded, buffers that never move;
* the spec's acceptance of an encoder with maxima, ``ServingEngine``'s
  refusal with the reference's message, and the launcher.

On the card (``cuda`` marker): one capture across topologies, graphed
outputs equal to eager ones bit for bit, buffer addresses stable across
loads, no host sync in a step.  The reference is imported only inside
fixtures, so those run where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_adaptive.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.bridge import from_jax_adaptive
from repro_torch.configs import PAPER_NETWORKS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine_ref, masking
from repro_torch.core.adaptive import (AdaptiveEngine, EngineOptions, flatten,
                                       pack)
from repro_torch.core.registers import (REGISTERS, Maxima, make_registers,
                                        registers_for)
from repro_torch.core.spec import MemorySpec, RuntimeSpec, maxima_for
from repro_torch.serving.engine import ServingEngine

# tests/test_adaptive.py's fabric and topologies
MX = Maxima(seq_max=32, heads_max=8, layers_enc_max=4, layers_dec_max=2,
            d_model_max=96, d_ff_max=192, out_max=100, head_dim_max=16,
            vocab=100)
TOPOLOGIES = [
    dict(seq=16, d_model=64, heads=4, d_ff=128, layers_enc=2, layers_dec=0,
         act="relu"),
    dict(seq=32, d_model=96, heads=8, d_ff=192, layers_enc=4, layers_dec=0,
         act="gelu"),                                  # the maxima topology
    dict(seq=24, d_model=48, heads=3, d_ff=96, layers_enc=3, layers_dec=2,
         act="relu"),                                  # enc-dec, odd heads
    dict(seq=16, d_model=64, heads=4, d_ff=128, layers_enc=2, layers_dec=0,
         act="relu", kv_heads=2),                      # GQA packing
]
PAPER = ("adaptor-bert", "shallow-transformer", "custom-encoder")
ENGINE_TOL = 1e-4            # x max|out|: the port against the reference
ORACLE_TOL = 2e-4            # x max|want|, rtol 1e-3 (tests/test_adaptive.py)
LEAK_TOL = 3e-4              # the reference's idle-lane test


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    if isinstance(tree, (int, float)):
        return tree
    return np.asarray(tree)


def _torch_net(net):
    """A reference network (numpy leaves) as the port's oracle takes it."""
    if isinstance(net, dict):
        return {k: _torch_net(v) for k, v in net.items()}
    if isinstance(net, list):
        return [_torch_net(v) for v in net]
    if isinstance(net, np.ndarray):
        return torch.from_numpy(np.array(net))
    return net


def _regs_kw(topo):
    return dict(sequence=topo["seq"], heads=topo["heads"],
                layers_enc=topo["layers_enc"],
                layers_dec=topo["layers_dec"], embeddings=topo["d_model"],
                hidden=topo["d_ff"], out=100,
                kv_heads=topo.get("kv_heads", topo["heads"]))


@pytest.fixture(scope="module")
def ref():
    """The reference's engine, oracle, registers and masking, its engine
    (and a bf16 one) at ``MX`` with a decoder, batch 2, and a cached
    maker of each topology's network, packed weights, tokens and the
    reference engine's and oracle's outputs."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import base as j_base
    from repro.core import engine_ref as j_ref
    from repro.core import masking as j_masking
    from repro.core import spec as j_spec
    from repro.core.adaptive import AdaptiveEngine as JEngine
    from repro.core.adaptive import EngineOptions as JOptions
    from repro.core.adaptive import pack as j_pack
    from repro.core.registers import Maxima as JMaxima
    from repro.core.registers import make_registers as j_make
    from repro.core.registers import registers_for as j_registers_for

    jmx = JMaxima(*MX)
    engines = {dt: JEngine(jmx, JOptions(batch=2, decoder=True, dtype=dt))
               for dt in (jnp.float32, jnp.bfloat16)}

    @functools.cache
    def case(i: int, dtype: str = "f32"):
        topo = TOPOLOGIES[i]
        eng = engines[jnp.float32 if dtype == "f32" else jnp.bfloat16]
        net = j_ref.random_network(
            jax.random.PRNGKey(i), vocab=100, out=100,
            **{k: v for k, v in topo.items() if k != "act"})
        packed = j_pack(eng, net)
        toks = jax.random.randint(jax.random.PRNGKey(100 + i),
                                  (2, MX.seq_max), 0, 100)
        tgt = jax.random.randint(jax.random.PRNGKey(200 + i),
                                 (2, MX.seq_max), 0, 100)
        act = 1 if topo["act"] == "gelu" else 0
        out = eng.compile()(packed, j_make(**_regs_kw(topo)), jnp.int32(act),
                            toks, tgt)
        s = topo["seq"]
        want = j_ref.forward(net, toks[:, :s], activation=topo["act"],
                             tgt_tokens=tgt[:, :s] if topo["layers_dec"]
                             else None)
        return types.SimpleNamespace(
            net=_np(net), packed=_np(packed), toks=np.array(toks),
            tgt=np.array(tgt), act=act,
            out=np.asarray(out.astype(jnp.float32)), want=np.asarray(want))

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=REGISTRY, base=j_base, ref=j_ref,
        masking=j_masking, spec=j_spec, maxima=JMaxima, make=j_make,
        registers_for=j_registers_for, engines=engines, pack=j_pack,
        case=case)


@pytest.fixture(scope="module")
def engine():
    return AdaptiveEngine(MX, EngineOptions(batch=2, decoder=True),
                          device="cpu")


def _run(engine, c, topo, params=None, tgt=True):
    step = engine.compile()
    regs = make_registers(**_regs_kw(topo), device="cpu")
    return step(from_jax_adaptive(c.packed, engine) if params is None
                else params, regs, c.act, torch.from_numpy(c.toks),
                torch.from_numpy(c.tgt) if tgt else None)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


# ---------------------------------------------------------------------------
# masking helpers, configs, registers, spec
# ---------------------------------------------------------------------------
HELPERS = ("dim_mask", "masked_layernorm", "masked_rmsnorm",
           "masked_softmax", "masked_mean_pool", "mask_lanes")


@pytest.mark.parametrize("helper", HELPERS)
@pytest.mark.parametrize("frac", [0.0, "one", 0.4, 1.0])
def test_masking_helpers_match_reference(ref, helper, frac):
    rs = np.random.default_rng(hash((helper, str(frac))) % 2 ** 32)
    d_max = 24
    live = 1 if frac == "one" else int(round(d_max * frac))
    x = (3 * rs.standard_normal((3, 5, d_max))).astype(np.float32)
    g = (1 + 0.1 * rs.standard_normal(d_max)).astype(np.float32)
    b = (0.1 * rs.standard_normal(d_max)).astype(np.float32)
    jm, jnp = ref.masking, ref.jnp
    jl, tl = jnp.int32(live), torch.tensor(live, dtype=torch.int32)
    xt, gt, bt = map(torch.from_numpy, (x, g, b))
    if helper == "dim_mask":
        want, got = jm.dim_mask(d_max, jl), masking.dim_mask(d_max, tl)
    elif helper == "masked_layernorm":
        want = jm.masked_layernorm(jnp.asarray(x), g, b, jl)
        got = masking.masked_layernorm(xt, gt, bt, tl)
    elif helper == "masked_rmsnorm":
        want = jm.masked_rmsnorm(jnp.asarray(x), g, jl)
        got = masking.masked_rmsnorm(xt, gt, live)       # a host int too
    elif helper == "masked_softmax":
        want = jm.masked_softmax(jnp.asarray(x), jl, axis=1)
        got = masking.masked_softmax(xt, tl, axis=1)
    elif helper == "masked_mean_pool":
        want = jm.masked_mean_pool(jnp.asarray(x), jnp.int32(min(live, 5)))
        got = masking.masked_mean_pool(xt, tl.clamp(max=5))
    else:
        want = jm.mask_lanes(jnp.asarray(x), jl, axis=-1)
        got = masking.mask_lanes(xt, live, axis=-1)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_masking_drops_non_finite_dead_lanes():
    """Where the reference multiplies by the mask, the port selects: a NaN
    or inf in a dead lane never reaches a live one."""
    x = torch.randn(2, 8)
    x[:, 5:] = float("nan")
    x[0, 7] = float("inf")
    for got in (masking.masked_layernorm(x, torch.ones(8), torch.zeros(8), 5),
                masking.masked_rmsnorm(x, torch.ones(8), 5),
                masking.masked_softmax(x, 5), masking.mask_lanes(x, 5)):
        assert torch.isfinite(got).all() and (got[:, 5:] == 0).all()


@pytest.mark.parametrize("name", PAPER)
def test_paper_configs_match_reference(ref, name):
    port, j = get_config(name), ref.registry[name]
    assert port.family == "encoder"
    mine = dataclasses.asdict(port)
    assert mine == {k: v for k, v in dataclasses.asdict(j).items()
                    if k in mine}
    assert port.resolved_head_dim == j.resolved_head_dim
    assert [c.name for c in PAPER_NETWORKS] == list(PAPER)


def test_encoder_exemption_is_the_references():
    ArchConfig(name="odd", family="encoder", num_layers=1, d_model=200,
               num_heads=3, num_kv_heads=3, d_ff=8, vocab_size=8)
    with pytest.raises(ValueError, match="not divisible by num_heads=3"):
        ArchConfig(name="odd", family="dense", num_layers=1, d_model=200,
                   num_heads=3, num_kv_heads=3, d_ff=8, vocab_size=8)


def _whisper_pair(ref):
    """The reference's whisper-medium (an enc-dec config) and the port's
    own, equal field for field."""
    j, port = ref.registry["whisper-medium"], get_config("whisper-medium")
    assert dataclasses.asdict(port) == dataclasses.asdict(j)
    return j, port


def _values(regs):
    return {k: int(getattr(regs, k)) for k in REGISTERS}


@pytest.mark.parametrize("name", [*PAPER, "whisper-medium"])
@pytest.mark.parametrize("layers_dec", [None, 3])
def test_registers_match_reference(ref, name, layers_dec):
    if name == "whisper-medium":
        j_cfg, cfg = _whisper_pair(ref)
    else:
        j_cfg, cfg = ref.registry[name], get_config(name)
    want = _values(ref.registers_for(j_cfg, 48, layers_dec))
    regs = registers_for(cfg, 48, layers_dec, device="cpu")
    assert _values(regs) == want == regs.static()
    assert regs.file.dtype == torch.int32 and regs.heads.dim() == 0
    assert int(regs.head_dim) == int(ref.registers_for(
        j_cfg, 48, layers_dec).head_dim)
    if name != "whisper-medium":
        mx = maxima_for(*(get_config(n) for n in PAPER), seq_max=64,
                        layers_dec_max=layers_dec)
        spec = RuntimeSpec(arch=cfg, maxima=mx,
                           memory=MemorySpec(max_len=64))
        assert _values(spec.registers(48, layers_dec, device="cpu")) == want
        j_spec = ref.spec.RuntimeSpec(
            arch=j_cfg, maxima=ref.maxima(*mx),
            memory=ref.spec.MemorySpec(max_len=64))
        assert spec.static_registers(48) == j_spec.static_registers(48)


def test_make_registers_matches_reference(ref):
    kw = dict(sequence=5, heads=6, layers_enc=2, embeddings=30, hidden=7)
    assert _values(make_registers(**kw, device="cpu")) == \
        _values(ref.make(**kw))
    kw.update(layers_dec=1, out=9, kv_heads=2)
    assert _values(make_registers(**kw, device="cpu")) == \
        _values(ref.make(**kw))


def test_maxima_for_follows_the_encdec_rule(ref):
    j_w, w = _whisper_pair(ref)
    paper = [get_config(n) for n in PAPER]
    j_paper = [ref.registry[n] for n in PAPER]
    for archs, j_archs in (([w], [j_w]), (paper, j_paper),
                           ([w, *paper], [j_w, *j_paper]),
                           ([get_config("qwen1.5-0.5b")],
                            [ref.registry["qwen1.5-0.5b"]])):
        for dec in (None, 5):
            assert tuple(maxima_for(*archs, seq_max=64,
                                    layers_dec_max=dec)) == \
                tuple(ref.spec.maxima_for(*j_archs, seq_max=64,
                                          layers_dec_max=dec))


@pytest.mark.parametrize("over", [dict(heads=16), dict(embeddings=1024),
                                  dict(layers_dec=3), dict(sequence=33)])
def test_maxima_validate_messages_match_reference(ref, over):
    MX.validate({"sequence": 32, "heads": 8})
    with pytest.raises(ValueError) as mine:
        MX.validate(over)
    with pytest.raises(ValueError) as want:
        ref.maxima(*MX).validate(over)
    assert str(mine.value) == str(want.value)
    assert "re-synthesis" in str(mine.value)


def test_spec_takes_the_paper_networks_with_maxima():
    paper = [get_config(n) for n in PAPER]
    mx = maxima_for(*paper, seq_max=64)
    assert mx == Maxima(seq_max=64, heads_max=12, layers_enc_max=12,
                        layers_dec_max=0, d_model_max=768, d_ff_max=3072,
                        out_max=30522, head_dim_max=66, vocab=30522)
    for cfg in paper:
        spec = RuntimeSpec(arch=cfg, maxima=mx, memory=MemorySpec(max_len=64))
        assert spec.fits_within(mx)
        eng = AdaptiveEngine.from_spec(spec, device="meta")
        assert eng.mx == mx and not eng.has_decoder
        with pytest.raises(ValueError,
                           match="encoder-only archs have no decode step"):
            ServingEngine(spec, device="cpu")
    with pytest.raises(ValueError, match="Queue 1 item 12f"):
        RuntimeSpec(arch=paper[0], memory=MemorySpec(max_len=64))
    with pytest.raises(ValueError, match="cache_layout='paged' is "
                                         "unsupported for family 'encoder'"):
        RuntimeSpec(arch=paper[0], maxima=mx,
                    memory=MemorySpec(cache_layout="paged", max_len=64))
    with pytest.raises(ValueError, match="does not fit its own maxima"):
        RuntimeSpec(arch=paper[0], maxima=mx._replace(heads_max=8),
                    memory=MemorySpec(max_len=64))


def test_entry_points_need_a_device_choice():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaptiveEngine(MX)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_registers(sequence=1, heads=1, layers_enc=1, embeddings=1,
                       hidden=1)


# ---------------------------------------------------------------------------
# pack, bridge, oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(TOPOLOGIES)))
def test_pack_matches_reference_leaf_for_leaf(ref, engine, i):
    c = ref.case(i)
    mine = {k: v.numpy() for k, v in flatten(pack(engine, c.net)).items()}
    bridged = flatten(from_jax_adaptive(c.packed, engine))
    want = flatten(c.packed)
    assert mine.keys() == want.keys() == bridged.keys() \
        == dict(engine.named_buffers()).keys()
    for k in want:
        assert mine[k].dtype == np.float32
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
        np.testing.assert_array_equal(bridged[k].numpy(), want[k],
                                      err_msg=k)


@pytest.mark.parametrize("i", range(len(TOPOLOGIES)))
def test_oracle_matches_reference(ref, i):
    c, topo = ref.case(i), TOPOLOGIES[i]
    s = topo["seq"]
    got = engine_ref.forward(
        _torch_net(c.net), torch.from_numpy(np.array(c.toks[:, :s])),
        activation=topo["act"],
        tgt_tokens=(torch.from_numpy(np.array(c.tgt[:, :s]))
                    if topo["layers_dec"] else None))
    _close(got.numpy(), c.want, 1e-5)


def test_random_network_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    net = engine_ref.random_network(generator=g, seq=8, d_model=200,
                                    heads=3, d_ff=64, layers_enc=2,
                                    layers_dec=1, vocab=50, kv_heads=1)
    assert net["head_dim"] == 66 and net["out"] == 200
    a = net["enc_layers"][0]["attn"]
    assert a["wq"].shape == (200, 198) and a["wk"].shape == (200, 66)
    assert a["wo"].shape == (198, 200) and "cross" in net["dec_layers"][0]
    again = engine_ref.random_network(
        generator=torch.Generator().manual_seed(0), seq=8, d_model=200,
        heads=3, d_ff=64, layers_enc=2, layers_dec=1, vocab=50, kv_heads=1)
    assert torch.equal(again["w_out"], net["w_out"])


# ---------------------------------------------------------------------------
# the engine against the reference engine and the oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(TOPOLOGIES)))
def test_engine_matches_reference_engine(ref, engine, i):
    c, topo = ref.case(i), TOPOLOGIES[i]
    out = _run(engine, c, topo).numpy()
    _close(out, c.out, ENGINE_TOL)
    s = topo["seq"]
    np.testing.assert_allclose(out[:, :s, :100], c.want,
                               atol=ORACLE_TOL * np.abs(c.want).max(),
                               rtol=1e-3)


@pytest.mark.parametrize("i", range(len(TOPOLOGIES)))
def test_bf16_engine_matches_reference_bf16_engine(ref, i):
    c, topo = ref.case(i, "bf16"), TOPOLOGIES[i]
    eng = AdaptiveEngine(MX, EngineOptions(batch=2, decoder=True,
                                           dtype=torch.bfloat16),
                         device="cpu")
    out = _run(eng, c, topo)
    assert out.dtype == torch.bfloat16
    _close(out.float().numpy(), c.out, 2e-2)


@pytest.mark.parametrize("i", [0, 3])
def test_pooled_output_matches_reference(ref, i):
    """``EngineOptions(pooled_output=True)``: the live positions' mean,
    then the unembedding, [B, 1, out]."""
    jnp = ref.jnp
    topo, c = TOPOLOGIES[i], ref.case(i)
    j_eng = type(ref.engines[jnp.float32])(
        ref.maxima(*MX), type(ref.engines[jnp.float32].opt)(
            batch=2, pooled_output=True))
    regs = _regs_kw(topo)
    packed = {k: v for k, v in c.packed.items() if k != "dec"}
    want = np.asarray(j_eng.compile()(
        ref.jax.tree.map(jnp.asarray, packed), ref.make(**regs),
        jnp.int32(c.act), jnp.asarray(c.toks)))
    eng = AdaptiveEngine(MX, EngineOptions(batch=2, pooled_output=True),
                         device="cpu")
    got = eng.compile()(from_jax_adaptive(packed, eng),
                        make_registers(**regs, device="cpu"), c.act,
                        torch.from_numpy(c.toks))
    assert got.shape == want.shape == (2, 1, 100)
    _close(got.numpy(), want, ENGINE_TOL)


def test_idle_lanes_do_not_leak(ref, engine):
    """The reference's idle-lane case: the maxima net loaded, a smaller
    topology selected (48 wide, 4 heads of 12, 2 of 4 layers)."""
    jax, jnp = ref.jax, ref.jnp
    j_eng = ref.engines[jnp.float32]
    big = ref.ref.random_network(jax.random.PRNGKey(0), seq=32, d_model=96,
                                 heads=8, d_ff=192, layers_enc=4, vocab=100,
                                 out=100)
    packed = ref.pack(j_eng, big)
    kw = dict(sequence=16, heads=4, layers_enc=2, layers_dec=0,
              embeddings=48, hidden=96, out=100)
    toks = jax.random.randint(jax.random.PRNGKey(5), (2, 32), 0, 100)
    want_eng = np.asarray(j_eng.compile()(packed, ref.make(**kw),
                                          jnp.int32(0), toks, toks))
    step = engine.compile()
    t_toks = torch.from_numpy(np.array(toks))
    got = step(from_jax_adaptive(_np(packed), engine),
               make_registers(**kw, device="cpu"), 0, t_toks, t_toks).numpy()
    _close(got, want_eng, ENGINE_TOL)
    sliced = engine_ref.slice_network(_torch_net(_np(big)), d=48, h=4,
                                      f=96, layers=2)
    want = engine_ref.forward(sliced, t_toks[:, :16]).numpy()
    np.testing.assert_allclose(got[:, :16, :100], want,
                               atol=LEAK_TOL * np.abs(want).max(), rtol=1e-3)


def _plant_nan(params: dict, *, d: int, h: int, e: int, f: int, out: int,
               seq: int, layers: int) -> None:
    """NaN in every lane no live output may read: the output lanes of each
    projection past the topology (heads, head dim, d_model, d_ff, out),
    the norms', embeddings' and positions' dead lanes, positions past the
    live sequence, and every leaf of the dead layers and of the unused
    decoder.  (A dead *input* row of a product is not among them: x's
    dead lanes are exact zeros there, and 0 x NaN is NaN in any product.)"""
    nan = float("nan")
    params["embed"][:, d:] = nan
    params["pos"][:, d:] = nan
    params["pos"][seq:] = nan
    params["w_out"][:, out:] = nan
    params["b_out"][out:] = nan
    for stack, live in (("enc", layers), ("dec", 0)):
        p = params[stack]
        for blk in [p["attn"]] + ([p["cross"]] if "cross" in p else []):
            for k in ("wq", "wk", "wv"):
                blk[k][..., h:, :] = nan
                blk[k][..., e:] = nan
            for k in ("bq", "bk", "bv"):
                blk[k][:, h:, :] = nan
                blk[k][..., e:] = nan
            blk["wo"][..., d:] = nan
            blk["bo"][:, d:] = nan
        for k, v in flatten(p).items():
            if k.endswith(("_g", "_b", "b2")):
                v[:, d:] = nan
        p["w1"][..., f:] = nan
        p["b1"][:, f:] = nan
        p["w2"][..., d:] = nan
        for v in flatten(p).values():
            v[live:] = nan


def test_nan_in_dead_lanes_and_layers_never_reaches_a_live_output(engine):
    g = torch.Generator().manual_seed(7)
    net = engine_ref.random_network(generator=g, seq=16, d_model=48,
                                    heads=4, d_ff=96, layers_enc=2,
                                    vocab=100, out=80)
    kw = dict(sequence=16, heads=4, layers_enc=2, embeddings=48, hidden=96,
              out=80)
    toks = torch.randint(0, 100, (2, 32), generator=g)
    step = engine.compile()
    regs = make_registers(**kw, device="cpu")
    clean = step(pack(engine, net), regs, 1, toks, toks)
    poisoned = pack(engine, net)
    _plant_nan(poisoned, d=48, h=4, e=12, f=96, out=80, seq=16, layers=2)
    assert sum(int(v.isnan().sum()) for v in flatten(poisoned).values()) \
        > 0.5 * sum(v.numel() for v in flatten(poisoned).values())
    got = step(poisoned, regs, 1, toks, toks)
    live = got[:, :16, :80]
    assert torch.isfinite(live).all()
    assert torch.equal(live, clean[:, :16, :80])
    want = engine_ref.forward(net, toks[:, :16], activation="gelu")
    _close(live.numpy(), want.numpy(), ORACLE_TOL)


# ---------------------------------------------------------------------------
# one program for every topology
# ---------------------------------------------------------------------------
class _Record(TorchDispatchMode):
    """Every dispatched aten operator with its arguments' shapes, dtypes
    and scalar values."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}

        def sig(a):
            if isinstance(a, torch.Tensor):
                return ("tensor", tuple(a.shape), a.dtype)
            if isinstance(a, (list, tuple)):
                return tuple(sig(x) for x in a)
            return a
        self.ops.append((str(func), sig(args),
                         sig(tuple(sorted(kwargs.items())))))
        return func(*args, **kwargs)


def test_one_operator_sequence_serves_every_topology(ref):
    """The step dispatches the same operators on the same shapes and
    scalars whatever the registers say: nothing in it branches on a
    register on the host, so one captured graph replays every topology."""
    eng = AdaptiveEngine(MX, EngineOptions(batch=2, decoder=True),
                         device="cpu")
    seqs = []
    for i, topo in enumerate(TOPOLOGIES):
        c = ref.case(i)
        params = from_jax_adaptive(c.packed, eng)
        with _Record() as rec:
            out = _run(eng, c, topo, params=params)
        _close(out.numpy(), c.out, ENGINE_TOL)
        seqs.append(rec.ops)
    assert len(seqs[0]) > 500
    for i, ops in enumerate(seqs[1:], 1):
        assert ops == seqs[0], f"topology {i} dispatches other operators"
    assert eng.capture_count() == 1


def test_capture_count_counts_keys_as_the_reference_retraces(ref):
    jnp = ref.jnp
    j_eng = ref.engines[jnp.float32]
    c = ref.case(0)
    topo = TOPOLOGIES[0]
    j_step = j_eng.compile()
    before = j_eng.trace_count()
    short = c.toks[:, :24]
    j_step(c.packed, ref.make(**_regs_kw(topo)), jnp.int32(0),
           jnp.asarray(short), jnp.asarray(short))
    eng = AdaptiveEngine(MX, EngineOptions(batch=2, decoder=True),
                         device="cpu")
    assert eng.capture_count() == 0
    _run(eng, c, topo)
    _run(eng, ref.case(1), TOPOLOGIES[1])
    assert eng.capture_count() == 1 == before
    eng.compile()(from_jax_adaptive(c.packed, eng),
                  make_registers(**_regs_kw(topo), device="cpu"), 0,
                  torch.from_numpy(short), torch.from_numpy(short))
    assert eng.capture_count() == 2 == j_eng.trace_count()


def test_step_refuses_what_the_fabric_cannot_hold(engine):
    step = engine.compile()
    toks = torch.zeros(2, 32, dtype=torch.int64)
    params = engine.params()
    with pytest.raises(ValueError, match="re-synthesis"):
        step(params, make_registers(sequence=8, heads=16, layers_enc=1,
                                    embeddings=96, hidden=8, device="cpu"),
             0, toks, toks)
    with pytest.raises(ValueError, match="head_dim=24 .* exceeds"):
        step(params, make_registers(sequence=8, heads=4, layers_enc=1,
                                    embeddings=96, hidden=8, device="cpu"),
             0, toks, toks)
    with pytest.raises(ValueError, match="layers_dec > 0 needs tgt_tokens"):
        step(params, make_registers(sequence=8, heads=8, layers_enc=1,
                                    layers_dec=1, embeddings=96, hidden=8,
                                    device="cpu"), 0, toks)


def test_encoder_only_call_needs_no_target(ref, engine):
    """A decoder-provisioned fabric runs an encoder-only topology without
    target tokens (the select discards the decoder)."""
    c, topo = ref.case(0), TOPOLOGIES[0]
    with_tgt = _run(engine, c, topo)
    without = _run(engine, c, topo, tgt=False)
    assert torch.equal(with_tgt, without)


class _Copies(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.n += func is torch.ops.aten.copy_.default
        return func(*args, **(kwargs or {}))


def test_weight_loads_copy_only_new_leaves():
    eng = AdaptiveEngine(MX, EngineOptions(batch=1), device="cpu")
    ptrs = eng.buffer_ptrs()
    n_leaves = len(ptrs)
    g = torch.Generator().manual_seed(1)
    own = eng.init(g)
    assert eng.buffer_ptrs() == ptrs
    net = engine_ref.random_network(generator=g, seq=8, d_model=32, heads=2,
                                    d_ff=16, layers_enc=1, vocab=100)
    a, b = pack(eng, net), pack(eng, net)
    for params, copies in ((own, 0), (a, n_leaves), (a, 0), (b, n_leaves),
                           (own, 0), (a, n_leaves)):
        with _Copies() as rec:
            eng.load(params)
        assert rec.n == copies
        assert eng.buffer_ptrs() == ptrs
    assert torch.equal(eng.enc.attn.wq, a["enc"]["attn"]["wq"])
    with pytest.raises(ValueError, match="missing"):
        eng.load({k: v for k, v in a.items() if k != "pos"})


def test_init_scales_match_the_reference_init():
    eng = AdaptiveEngine(MX, EngineOptions(batch=1, decoder=True),
                         device="cpu")
    p = eng.init(torch.Generator().manual_seed(0))
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    # stacked [L, d, h, e]: fan_in = shape[-2] = heads_max, as ParamBuilder
    assert abs(float(p["enc"]["attn"]["wq"].std()) * MX.heads_max ** 0.5
               - 1) < 0.05
    assert float(p["dec"]["ln3_g"].min()) == 1 == float(p["enc"]["ln1_g"]
                                                        .max())
    assert float(p["b_out"].abs().max()) == 0


def test_launch_adaptive_runs_on_cpu(capsys):
    from repro_torch.launch.adaptive import main
    main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "captures = 1" in out
    assert out.count("max|err|") == 9


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _topologies_on(dev, g):
    """(net, registers, act) of the four topologies, weights from ``g``."""
    out = []
    for topo in TOPOLOGIES:
        net = engine_ref.random_network(
            generator=g, vocab=100, out=100,
            **{k: v for k, v in topo.items() if k != "act"})
        out.append((net, make_registers(**_regs_kw(topo), device=dev),
                    topo))
    return out


@pytest.mark.cuda
def test_cuda_one_capture_serves_every_topology():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    eng = AdaptiveEngine(MX, EngineOptions(batch=2, decoder=True), device=dev)
    step, serve = eng.compile(), eng.serve_fn()
    ptrs = eng.buffer_ptrs()
    toks = torch.randint(0, 100, (2, MX.seq_max), generator=g, device=dev)
    tgt = torch.randint(0, 100, (2, MX.seq_max), generator=g, device=dev)
    for net, regs, topo in _topologies_on(dev, g):
        act = int(topo["act"] == "gelu")
        got = step(pack(eng, net), regs, act, toks, tgt)
        eager = serve(eng.params(), regs,
                      torch.tensor(act, dtype=torch.int32, device=dev),
                      toks, tgt)
        assert torch.equal(got, eager)
        s = topo["seq"]
        want = engine_ref.forward(
            net, toks[:, :s], activation=topo["act"],
            tgt_tokens=tgt[:, :s] if topo["layers_dec"] else None)
        torch.testing.assert_close(got[:, :s, :100], want, rtol=1e-3,
                                   atol=ORACLE_TOL * float(want.abs().max()))
        assert eng.buffer_ptrs() == ptrs
    assert eng.capture_count() == 1


@pytest.mark.cuda
def test_cuda_step_makes_no_host_sync():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    eng = AdaptiveEngine(MX, EngineOptions(batch=2, decoder=True), device=dev)
    step = eng.compile()
    toks = torch.randint(0, 100, (2, MX.seq_max), generator=g, device=dev)
    (net_a, regs_a, _), (net_b, regs_b, _) = _topologies_on(dev, g)[:2]
    a, b = pack(eng, net_a), pack(eng, net_b)
    first = step(a, regs_a, 0, toks, toks)             # the capture
    host_toks = toks.cpu()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(b, regs_b, 1, toks, toks)                 # a load and a replay
        again = step(a, regs_a, 0, host_toks, toks)    # tokens staged
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, first)
    assert eng.capture_count() == 1
