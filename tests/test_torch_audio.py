"""The audio family (whisper-medium: an encoder over the stub frontend's
frames and a decoder with cross-attention) in the port against the JAX
reference.

The reduced config is ``reduced("whisper-medium")`` with
``frontend.num_tokens`` set to ``encoder_seq_len`` (16) on both sides: the
shrink rule leaves the stub 8 frames for 16 encoder positions, and the
reference's engine, which feeds the stub's frames to the encoder, then
fails on a broadcast (ROADMAP.md Queue 3; checked below as a refusal).
Weights come from the reference's ``Model(cfg).init(PRNGKey(0))`` through
numpy and ``repro_torch.bridge``; inputs from numpy seeds.  Checked, each
with its tolerance:

* the config and ``reduced`` field for field, the bridge leaf for leaf
  over the stacked encoder and decoder layers;
* ``forward`` with random frames at f32 (1e-5 x max|logits|) and bf16
  compute (tests/test_decode_equivalence.py's 2e-2 x max|logits|);
* ``prefill`` + 5 ``decode_step``s at f32 against the reference's (1e-5 x
  max), the caches bf16 and the reference's (every element within one bf16
  step, nearly all bit for bit: the f32 products' last bits differ between
  the two libraries); prefill + decode against the reference's forward;
* engine greedy streams at f32 on prompts that are not a bucket's length,
  against the reference engine (streams, events, counters, compilations)
  and against the reference model's unpadded prefill + decode, on the
  plain path and the kernels' plain versions; the first token's logits of
  the port's bucketed prefill against the unpadded prefill's;
* ``matmul_backend="pallas"`` (the plain versions of ``tiled_matmul`` and
  ``layernorm`` on the CPU) against ``"xla"``;
* int8 weights where the size rule leaves the position tables float,
  leaf for leaf the reference's ``quantize_params`` and ``forward``;
* the refusals (paged, int8 KV, chunked, speculation, int8 position
  tables, the frames mismatch, family / encdec disagreeing), with the
  reference's messages where it has them; ``program_launches`` against the
  wrappers' calls; ``serve --model whisper-medium``;
* on the card (``cuda``-marked, skipped here): one CUDA graph per bucket
  and one of the decode program, graphed = eager, launches =
  ``program_launches``.
"""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import EncDecConfig
from repro_torch.core.paging import PagingConfig
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec,
                                   maxima_for)
from repro_torch.kernels import counts
from repro_torch.kernels import layernorm as ln_mod
from repro_torch.kernels import tiled_matmul as tm_mod
from repro_torch.models.model import EncDecCache, Model
from repro_torch.serving.engine import ServingEngine

NAME = "whisper-medium"
FRAMES = 16             # the reduced encoder_seq_len


def _fill(cfg):
    """The reduced config with its stub frontend filling the encoder."""
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, num_tokens=cfg.encdec.encoder_seq_len))


CFG = _fill(reduced(get_config(NAME)))
LOGIT_TOL = 2e-2        # x max|logits|, tests/test_decode_equivalence.py
FN_TOL = 1e-5           # x max|out|, float32 (other orders of sums)
MAX_LEN = 96            # buckets 32, 64, 96


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine

    j_cfg = _fill(j_reduced(REGISTRY[NAME]))
    params = JModel(j_cfg).init(jax.random.PRNGKey(0))
    sd = from_jax_params(jax.tree.map(np.asarray, params), CFG, "cpu")
    # one compiled f32 decode step for every unpadded stream
    decode = jax.jit(JModel(j_cfg, ModelOptions(
        compute_dtype=jnp.float32)).decode_step)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=REGISTRY, j_reduced=j_reduced,
        cfg=j_cfg, params=params, sd=sd, spec=j_spec, model=JModel,
        options=ModelOptions, engine=JServingEngine, decode=decode)


def _close(want, got, rel):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _bf16_rows(want, got: torch.Tensor) -> None:
    """bf16 cache rows: every element within one bf16 step of the
    reference's (the same float32 value rounded, up to the last bits of
    the products before it: 1e-6 x max|rows| where a value cancels to
    near zero), and nearly all bit for bit."""
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert want.shape == got.shape
    np.testing.assert_array_less(
        np.abs(want - got),
        2 ** -7 * np.abs(want) + 1e-6 * np.abs(want).max())
    assert (want == got).mean() >= 0.99


def _model(sd, compute=torch.float32, **kw):
    tm = Model(CFG, compute_dtype=compute, device="cpu", **kw)
    tm.load_state_dict(sd)
    return tm


def _jmodel(ref, compute=None):
    return ref.model(ref.cfg, ref.options(
        compute_dtype=ref.jnp.float32 if compute is None else compute))


def _frames(seed, b=2):
    return np.random.RandomState(seed).randn(b, FRAMES, CFG.d_model) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# config and bridge
# ---------------------------------------------------------------------------
def test_config_and_reduced_match_the_reference(ref):
    for port, j in ((get_config(NAME), ref.registry[NAME]),
                    (reduced(get_config(NAME)),
                     ref.j_reduced(ref.registry[NAME])), (CFG, ref.cfg)):
        jd = dataclasses.asdict(j)
        assert dataclasses.asdict(port) == {
            k: v for k, v in jd.items() if k in dataclasses.asdict(port)}
    full = get_config(NAME)
    assert (full.num_layers, full.encdec.num_encoder_layers, full.d_model,
            full.vocab_size, full.norm, full.positional, full.activation,
            full.source) == (24, 24, 1024, 51865, "layernorm", "learned",
                             "gelu", "arXiv:2212.04356")
    # the shrink rule, copied as it is: 2 encoder layers over 16 frames,
    # a stub of 8
    red = reduced(full)
    assert (red.encdec.num_encoder_layers, red.encdec.encoder_seq_len,
            red.frontend.num_tokens) == (2, 16, 8)
    spec = RuntimeSpec(arch=full)
    assert spec.resolved_policy == "bucketed"
    assert spec.memory.cache_layout == "dense"


def test_bridge_maps_encoder_and_decoder_leaf_for_leaf(ref):
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        else:
            flat[prefix[:-1]] = np.asarray(tree)
    walk(ref.params, "")
    assert {n for n in flat if not n.startswith(("layers.", "enc_layers."))
            } == {"embed.table", "pos_embed.table", "lm_head.table",
                  "final_norm.scale", "final_norm.bias",
                  "enc_final_norm.scale", "enc_final_norm.bias",
                  "enc_pos_embed.table"}
    assert {n for n in flat if n.startswith("layers.")} >= {
        f"layers.{leaf}" for leaf in (
            "ln_cross.scale", "ln_cross.bias", "cross.wq.kernel",
            "cross.wk.kernel", "cross.wv.kernel", "cross.wo.kernel",
            "ffn.w1.bias", "ffn.w2.bias")}
    for name, arr in flat.items():
        stack = name.split(".")[0]
        if stack in ("layers", "enc_layers"):
            n = CFG.num_layers if stack == "layers" \
                else CFG.encdec.num_encoder_layers
            assert arr.shape[0] == n
            for i in range(n):
                np.testing.assert_array_equal(
                    ref.sd[name.replace(f"{stack}.", f"{stack}.{i}.", 1)]
                    .numpy(), arr[i])
        else:
            np.testing.assert_array_equal(ref.sd[name].numpy(), arr)
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu")
    assert set(tm.state_dict()) == set(ref.sd)


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_forward_matches_reference(ref, compute):
    """Random frames and tokens: f32 within 1e-5 x max|logits|, bf16
    within 2e-2 x max|logits| (the reference's tolerance)."""
    jnp = ref.jnp
    tdt = torch.float32 if compute == "fp32" else torch.bfloat16
    jdt = jnp.float32 if compute == "fp32" else jnp.bfloat16
    rs = np.random.RandomState(1)
    toks = rs.randint(0, CFG.vocab_size, (2, 20)).astype(np.int32)
    fe = _frames(2)
    want = _jmodel(ref, jdt).forward(ref.params, {
        "tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)})
    got = _model(ref.sd, tdt).forward(torch.from_numpy(toks),
                                      torch.from_numpy(fe))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 20, 128)
    _close(want, got, FN_TOL if compute == "fp32" else LOGIT_TOL)


@pytest.fixture(scope="module")
def ref_steps(ref):
    """The reference's forward over 24 tokens with seeded frames, its
    prefill of the first 12 (max_len 32) and 5 decode steps after it, at
    f32."""
    jnp = ref.jnp
    jm = _jmodel(ref)
    toks = np.random.RandomState(7).randint(0, CFG.vocab_size, (2, 24)) \
        .astype(np.int32)
    fe = _frames(8)
    full = np.asarray(jm.forward(ref.params, {
        "tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)}))
    logits, cache = jm.prefill(ref.params, {
        "tokens": jnp.asarray(toks[:, :12]), "frontend": jnp.asarray(fe)},
        max_len=32)
    steps, caches = [np.asarray(logits)], [cache]
    for t in range(12, 17):
        lg, cache = ref.decode(ref.params, cache,
                               jnp.asarray(toks[:, t:t + 1]),
                               jnp.asarray(t, jnp.int32))
        steps.append(np.asarray(lg))
    caches.append(cache)
    return toks, fe, full, steps, caches


def test_prefill_and_decode_match_reference(ref, ref_steps):
    """``prefill`` and 5 ``decode_step``s within 1e-5 x max|logits| of the
    reference's; the ``EncDecCache`` rows bf16 and the reference's (the
    self rows after the prefill and after the steps, the cross rows the
    prefill wrote, which the steps leave as they are)."""
    toks, fe, _, steps, (j_pre, j_post) = ref_steps
    tm = _model(ref.sd)
    logits, cache = tm.prefill(torch.from_numpy(toks[:, :12]), 32,
                               torch.from_numpy(fe))
    assert isinstance(cache, EncDecCache)
    assert tuple(cache.self_k.shape) == (2, 2, 33, CFG.num_kv_heads, 16)
    assert tuple(cache.cross_k.shape) == (2, 2, FRAMES, CFG.num_kv_heads, 16)
    _close(steps[0], logits, FN_TOL)
    for mine, theirs in ((cache.self_k, j_pre["self"].k),
                         (cache.self_v, j_pre["self"].v),
                         (cache.cross_k, j_pre["cross"].k),
                         (cache.cross_v, j_pre["cross"].v)):
        _bf16_rows(theirs, mine[:, :, :np.asarray(theirs).shape[2]])
    cross = cache.cross_k.clone()
    for i, t in enumerate(range(12, 17)):
        lg = tm.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]),
                            torch.full((2,), t, dtype=torch.int32))
        _close(steps[i + 1], lg, FN_TOL)
    assert torch.equal(cache.cross_k, cross)
    _bf16_rows(j_post["self"].k, cache.self_k[:, :, :32])
    _bf16_rows(j_post["self"].v, cache.self_v[:, :, :32])


def test_prefill_then_decode_matches_forward(ref, ref_steps):
    """The counterpart of tests/test_decode_equivalence.py: prefill 12
    tokens, decode to 24; every step's logits against the reference's
    ``forward`` within 2e-2 x max|logits| (the caches are bf16)."""
    toks, fe, full, _, _ = ref_steps
    tol = LOGIT_TOL * float(np.abs(full).max())
    tm = _model(ref.sd)
    logits, cache = tm.prefill(torch.from_numpy(toks[:, :12]), 32,
                               torch.from_numpy(fe))
    assert float(np.abs(logits.numpy() - full[:, :12]).max()) < tol
    for t in range(12, 24):
        lg = tm.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]),
                            torch.full((2,), t, dtype=torch.int32))
        err = float(np.abs(lg[:, 0].numpy() - full[:, t]).max())
        assert err < tol, f"step {t}: {err} vs {tol}"


def test_kernel_plain_versions_match_the_plain_path(ref, ref_steps):
    """``matmul_backend="pallas"`` on the CPU (``tiled_matmul`` and
    ``layernorm`` as their plain versions): forward, prefill and two
    decode steps within 1e-5 x max|logits| of ``"xla"``, and every
    product and norm through the wrappers."""
    toks, fe, _, _, _ = ref_steps
    t, f = torch.from_numpy(toks), torch.from_numpy(fe)
    out = {}
    for mm in ("xla", "pallas"):
        tm = _model(ref.sd, matmul_backend=mm)
        res = [tm.forward(t, f)]
        logits, cache = tm.prefill(t[:, :12], 32, f)
        res.append(logits)
        for i in (12, 13):
            res.append(tm.decode_step(cache, t[:, i:i + 1],
                                      torch.full((2,), i, dtype=torch.int32)))
        out[mm] = res
    for a, b in zip(out["xla"], out["pallas"], strict=True):
        _close(a, b, FN_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _spec(pkg, arch, **kw):
    ex = dict(compute_dtype="fp32")
    ex.update(kw)
    return pkg.RuntimeSpec(
        arch=arch, execution=pkg.ExecutionSpec(**ex),
        memory=pkg.MemorySpec(max_batch=4, max_len=MAX_LEN),
        scheduler=pkg.SchedulerSpec(policy="bucketed"))


_PORT = types.SimpleNamespace(RuntimeSpec=RuntimeSpec,
                              ExecutionSpec=ExecutionSpec,
                              MemorySpec=MemorySpec,
                              SchedulerSpec=SchedulerSpec)


def _drain(eng, prompts, new):
    log = []
    eng.events.subscribe(log.append)
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    return [done[u] for u in uids], [(e.kind, e.uid, e.step, e.data)
                                     for e in log]


# prompts off every bucket length: the 10-token prompt of range(3, 13)
# (bucket 32), 21 tokens (32) and 45 (64), 6 greedy tokens each
PROMPTS = [list(range(3, 13)),
           np.random.RandomState(9).randint(0, 128, 21).tolist(),
           np.random.RandomState(10).randint(0, 128, 45).tolist()]
NEW = 6


def _unpadded(ref, prompt: list, new: int) -> tuple[list[int], np.ndarray]:
    """The reference model's greedy stream over the unpadded prompt with
    the zero frames (``prefill``, then ``decode_step``) and its first
    token's logits."""
    jnp = ref.jnp
    jm = _jmodel(ref)
    zeros = jnp.zeros((1, FRAMES, CFG.d_model), jnp.bfloat16)
    logits, cache = jm.prefill(ref.params, {"tokens": jnp.asarray([prompt]),
                                            "frontend": zeros},
                               max_len=MAX_LEN)
    first = np.asarray(logits[0, -1])
    out = [int(jnp.argmax(logits[0, -1]))]
    for i in range(new - 1):
        logits, cache = ref.decode(
            ref.params, cache, jnp.asarray([[out[-1]]], jnp.int32),
            jnp.asarray(len(prompt) + i, jnp.int32))
        out.append(int(jnp.argmax(logits[0, -1])))
    return out, first


@pytest.fixture(scope="module")
def gold(ref):
    """The reference engine's drain of ``PROMPTS`` (streams, events,
    counters, compilations) and the reference model's unpadded streams
    and first-token logits."""
    je = ref.engine(_spec(ref.spec, ref.cfg))
    je.load(ref.params)
    streams, events = _drain(je, PROMPTS, NEW)
    stats = {k: je.stats[k] for k in ("decode_steps", "prefill_tokens",
                                      "device_gets", "harvest_elems")}
    return types.SimpleNamespace(
        streams=streams, events=events, stats=stats,
        compilations=dict(je.compilations()),
        unpadded=[_unpadded(ref, p, NEW) for p in PROMPTS])


@pytest.mark.parametrize("mm", ["xla", "pallas"])
def test_engine_streams_match_the_reference_engine(ref, gold, mm):
    """Dense + bucketed at f32: streams, events, counters and
    ``compilations()`` equal the reference engine's, and the streams are
    the reference model's over the unpadded prompts (the decoder is
    causal, so the bucket's pad stays out), on the plain path and the
    kernels' plain versions."""
    te = ServingEngine(_spec(_PORT, CFG, matmul_backend=mm), device="cpu")
    te.load(ref.sd)
    assert te.scheduler == "bucketed" and te.paging is None
    assert isinstance(te.cache, EncDecCache)
    streams, events = _drain(te, PROMPTS, NEW)
    assert streams == gold.streams == [s for s, _ in gold.unpadded]
    assert gold.streams[0] == [103, 103, 103, 103, 115, 103]
    assert events == gold.events
    assert {k: te.stats[k] for k in gold.stats} == gold.stats
    assert dict(te.compilations) == gold.compilations


def test_first_token_logits_are_the_unpadded_prefills(ref, gold):
    """The port's bucketed prefill as the engine stages it (the prompt
    right-padded to its bucket, ``lengths``, the bf16 zero frames) gives
    the first token's logits of the reference's unpadded prefill within
    1e-5 x max|logits|."""
    tm = _model(ref.sd)
    zeros = torch.zeros(1, FRAMES, CFG.d_model, dtype=torch.bfloat16)
    for prompt, (_, want) in zip(PROMPTS, gold.unpadded):
        n = len(prompt)
        bucket = next(b for b in (32, 64, 96) if b >= n)
        toks = torch.tensor([prompt + [0] * (bucket - n)], dtype=torch.int32)
        logits, _ = tm.prefill(toks, MAX_LEN, zeros,
                               lengths=torch.tensor([n], dtype=torch.int32))
        _close(want, logits[0, n - 1], FN_TOL)


# ---------------------------------------------------------------------------
# what the family refuses
# ---------------------------------------------------------------------------
def _both_raise(j_call, t_call):
    with pytest.raises(ValueError) as j_err:
        j_call()
    with pytest.raises(ValueError) as t_err:
        t_call()
    assert str(t_err.value) == str(j_err.value)
    return str(t_err.value)


@pytest.mark.parametrize("case", ["paged", "int8_kv", "chunked",
                                  "speculation"])
def test_spec_refusals_are_the_references(ref, case):
    def kw(pkg, arch, draft):
        mem, sched, spec = {}, {}, None
        if case == "paged":
            mem = dict(cache_layout="paged", block_size=8)
        elif case == "int8_kv":
            mem = dict(kv_dtype="int8")
        elif case == "chunked":
            sched = dict(policy="chunked", chunk_size=8)
        else:
            spec = pkg.SpeculationSpec(draft_model=draft, k=2)
        return dict(arch=arch, memory=pkg.MemorySpec(max_len=64, **mem),
                    scheduler=pkg.SchedulerSpec(**sched), speculation=spec)
    j_draft = ref.j_reduced(ref.registry["qwen1.5-0.5b"])
    t_draft = reduced(get_config("qwen1.5-0.5b"))
    port = types.SimpleNamespace(MemorySpec=MemorySpec,
                                 SchedulerSpec=SchedulerSpec,
                                 SpeculationSpec=SpeculationSpec)
    msg = _both_raise(
        lambda: ref.spec.RuntimeSpec(**kw(ref.spec, ref.cfg, j_draft)),
        lambda: RuntimeSpec(**kw(port, CFG, t_draft)))
    assert "audio" in msg


def test_model_and_fleet_refusals_are_the_references(ref):
    """``mixed_step``, a paged cache, paged decode and an int8 cache raise
    the reference's messages; a fleet refuses the family with the
    reference fabric's (``check_member``)."""
    jm, tm = _jmodel(ref), _model(ref.sd)
    jnp = ref.jnp
    toks = np.zeros((2, 4), np.int32)
    _both_raise(lambda: jm.mixed_step(ref.params, None, jnp.asarray(toks),
                                      0, 4),
                lambda: tm.mixed_step(None, torch.from_numpy(toks),
                                      torch.zeros(2, dtype=torch.int32),
                                      torch.full((2,), 4,
                                                 dtype=torch.int32)))
    from repro.core.paging import PagingConfig as JPaging
    _both_raise(lambda: jm.init_cache(2, 32, paging=JPaging(8, 8)),
                lambda: tm.init_cache(PagingConfig(8, 8)))
    cache = tm.init_cache(batch=2, max_len=32)
    jcache = jm.init_cache(2, 32)
    _both_raise(
        lambda: jm.decode_step(ref.params, jcache, jnp.asarray(toks[:, :1]),
                               jnp.zeros(2, jnp.int32),
                               block_tables=jnp.zeros((2, 4), jnp.int32)),
        lambda: tm.decode_step(cache, torch.from_numpy(toks[:, :1]),
                               torch.zeros(2, dtype=torch.int32),
                               torch.zeros(2, 4, dtype=torch.int32)))
    j8 = ref.model(ref.cfg, ref.options(kv_dtype="int8"))
    t8 = Model(CFG, kv_dtype="int8", device="cpu")
    _both_raise(lambda: j8.init_cache(2, 32),
                lambda: t8.init_cache(batch=2, max_len=32))
    from repro.core.spec import maxima_for as j_maxima_for
    from repro.serving.fabric import DecodeFabric
    qwen = ref.j_reduced(ref.registry["qwen1.5-0.5b"])
    fabric = DecodeFabric(j_maxima_for(qwen, seq_max=64), 2, qwen)
    with pytest.raises(ValueError) as j_err:
        fabric.check_member(ref.cfg)
    with pytest.raises(ValueError) as t_err:
        RuntimeSpec(arch=CFG, maxima=maxima_for(CFG, seq_max=64),
                    memory=MemorySpec(max_len=64))
    assert str(t_err.value) == str(j_err.value)
    assert "family 'audio' needs its own engine" in str(t_err.value)


def test_int8_position_tables_are_refused(ref):
    """Finding 2: int8 weights at a size floor that reaches the learned
    position tables.  The reference quantizes ``pos_embed.table`` (512 x
    64 here) and fails on its ``.astype`` (AttributeError); the port's spec
    and model refuse it and name that error."""
    from repro.core.serve_quant import quantize_params
    jq = quantize_params(ref.params, 1)
    with pytest.raises(AttributeError):
        _jmodel(ref).forward(jq, {"tokens": ref.jnp.zeros((1, 4),
                                                          ref.jnp.int32),
                                  "frontend": ref.jnp.zeros(
                                      (1, FRAMES, CFG.d_model))})
    for make in (
            lambda: RuntimeSpec(arch=CFG, execution=ExecutionSpec(
                quant="int8", quant_min_size=1)),
            lambda: Model(CFG, quant="int8", quant_min_size=1,
                          device="cpu")):
        with pytest.raises(ValueError, match="AttributeError") as err:
            make()
        assert "pos_embed.table (32768 elements)" in str(err.value)
        assert "enc_pos_embed.table (1024 elements)" in str(err.value)
    # above the decoder's table, below neither: the encoder's alone is
    # small enough to stay float and the spec builds
    RuntimeSpec(arch=CFG, execution=ExecutionSpec(quant="int8",
                                                  quant_min_size=32769))
    with pytest.raises(ValueError, match=r"pos_embed.table \(4194304"):
        RuntimeSpec(arch=get_config(NAME), execution=ExecutionSpec(
            quant="int8", quant_min_size=4096 * 1024))


def test_int8_weights_below_the_position_tables_are_the_references(ref):
    """With position tables of 32 rows (``max_position_embeddings`` 32,
    2048 elements; the encoder's 1024) and a floor of 4096, int8 weights
    quantize the embedding and ``lm_head`` tables and every stacked kernel
    (the encoder's measured over its 2 layers, the decoder's over its 2)
    and leave the position tables float: every leaf equals the reference's
    ``quantize_params``, and ``forward`` matches the reference's within
    1e-5 x max|logits| at f32."""
    import jax

    from repro.core.serve_quant import quantize_params
    cfg = dataclasses.replace(CFG, max_position_embeddings=32)
    j_cfg = dataclasses.replace(ref.cfg, max_position_embeddings=32)
    params = ref.model(j_cfg).init(jax.random.PRNGKey(0))
    sd = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    tm = Model(cfg, compute_dtype=torch.float32, quant="int8",
               quant_min_size=4096, device="cpu")
    tm.load_state_dict(sd)
    jq = quantize_params(params, 4096)
    want = from_jax_params(jax.tree.map(np.asarray, jq), cfg, "cpu")
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    assert got["enc_layers.0.attn.wq.kernel"].dtype == torch.int8
    assert got["layers.1.cross.wk.kernel"].dtype == torch.int8
    assert got["pos_embed.table"].dtype == torch.float32
    toks = np.random.RandomState(4).randint(0, CFG.vocab_size, (2, 20)) \
        .astype(np.int32)
    fe = _frames(5)
    jm = ref.model(j_cfg, ref.options(compute_dtype=ref.jnp.float32))
    _close(jax.jit(jm.forward)(jq, {"tokens": ref.jnp.asarray(toks),
                                    "frontend": ref.jnp.asarray(fe)}),
           tm.forward(torch.from_numpy(toks), torch.from_numpy(fe)), FN_TOL)


def test_frames_that_do_not_fill_the_encoder_are_refused(ref):
    """Finding 1: the unmodified reduced config's stub gives 8 frames to 16
    encoder positions.  The reference's engine fails on a broadcast
    (TypeError); the port's raises a ValueError naming both numbers, as
    does ``forward`` without frames."""
    j_cfg = ref.j_reduced(ref.registry[NAME])
    je = ref.engine(_spec(ref.spec, j_cfg))
    je.load(ref.params)
    je.submit(PROMPTS[0], max_new_tokens=2)
    with pytest.raises(TypeError, match="incompatible shapes"):
        je.run_to_completion()
    raw = reduced(get_config(NAME))
    te = ServingEngine(_spec(_PORT, raw), device="cpu")
    te.load(ref.sd)
    te.submit(PROMPTS[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="encoder_seq_len=16 frames .* "
                                         "given 8"):
        te.run_to_completion()
    with pytest.raises(ValueError, match="given none"):
        _model(ref.sd).forward(torch.zeros(1, 4, dtype=torch.int32))


def test_family_and_encdec_must_agree():
    """An audio config without its EncDecConfig, and a decoder-only family
    with one, are refused by the spec and by the model."""
    qwen = reduced(get_config("qwen1.5-0.5b"))
    for cfg, words in (
            (dataclasses.replace(CFG, encdec=None),
             "family 'audio' with no EncDecConfig"),
            (dataclasses.replace(qwen, encdec=EncDecConfig(2, 16)),
             "family 'dense' with an EncDecConfig")):
        for make in (lambda: RuntimeSpec(arch=cfg),
                     lambda: Model(cfg, device="cpu")):
            with pytest.raises(ValueError, match=words):
                make()


# ---------------------------------------------------------------------------
# launch counts and the launcher
# ---------------------------------------------------------------------------
def test_program_launches_count_the_wrappers(ref):
    """One prefill and one decode step on the kernels' plain versions: the
    wrappers' calls equal ``program_launches`` (384 products and 122 norms
    a prefill, 192 and 73 a decode step at 24 + 24 layers; here 2 + 2)."""
    tm = _model(ref.sd, matmul_backend="pallas")
    toks = torch.randint(0, CFG.vocab_size, (2, 40), dtype=torch.int32)
    fe = torch.from_numpy(_frames(3))
    cache = tm.init_cache(batch=2, max_len=64)
    runs = {"prefill": lambda: tm.prefill(toks, 64, fe),
            "decode": lambda: tm.decode_step(
                cache, toks[:, :1], torch.full((2,), 40, dtype=torch.int32))}
    for program, run in runs.items():
        calls: dict = {}

        def wrap(mod, name):
            fn = getattr(mod, name)

            def counted(*a, **k):
                calls[name] = calls.get(name, 0) + 1
                return fn(*a, **k)
            return mock.patch.object(mod, name, counted)
        with wrap(tm_mod, "tiled_matmul"), wrap(ln_mod, "layernorm"), \
                wrap(ln_mod, "rmsnorm"):
            run()
        want = counts.program_launches(CFG, program, layout="dense")
        assert {n: calls.get(n, 0) for n in want} == want, program
        assert want["tiled_matmul"] == (32 if program == "prefill" else 16)
    full = get_config(NAME)
    for program, mm, norms in (("prefill", 384, 122), ("decode", 192, 73)):
        assert counts.program_launches(full, program, layout="dense") == {
            "tiled_matmul": mm, "int8_matmul": 0, "rmsnorm": 0,
            "layernorm": norms, "paged_decode_attention": 0,
            "chunked_prefill_attention": 0, "rglru_scan": 0, "ssm_scan": 0}


def test_launch_serve_whisper_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-new", "4",
          "--max-len", "64", "--model", NAME, "--temperature", "0",
          "--kernels", "pallas"])
    out = capsys.readouterr().out
    assert f"{NAME} on cpu: 3 requests, 12 tokens" in out
    assert "bucketed scheduler, dense cache" in out
    assert "8 frames raised to the encoder's 16 positions" in out
    assert "feeds 16 zero frames to the encoder" in out
    with pytest.raises(ValueError, match="cache_layout='paged' is "
                       "unsupported for family 'audio'"):
        main(["--device", "cpu", "--arch", NAME, "--cache-layout", "paged"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_one_graph_per_bucket_and_graphed_equals_eager_on_the_card():
    """Reduced whisper (frames filling the encoder) on the kernel path:
    prompts in buckets 32, 64 and 128: one capture per bucket and one of
    the decode program, replayed on a second drain; the streams are the
    eager engine's and the launches ``program_launches``'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas"),
        memory=MemorySpec(max_batch=4, max_len=128))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    sd = Model(CFG, device="cuda").init(g).state_dict()
    prompts = [list(range(1, n + 1)) for n in (5, 40, 70, 100, 12)]
    engines = []
    for graphs in (True, False):
        eng = ServingEngine(spec, device="cuda", graphs=graphs)
        eng.load(sd)
        engines.append(eng)
    graphed, eager = engines
    first = _drain(graphed, prompts, 6)[0]
    assert dict(graphed.compilations) == {"decode": 1, "prefill": 3,
                                          "prefill_buckets": 3}
    assert _drain(graphed, prompts, 6)[0] == first \
        == _drain(eager, prompts, 6)[0]
    assert graphed.stats["prefill_captures"] == 3
    assert graphed.stats["graph_captures"] == 1
