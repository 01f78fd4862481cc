"""The ssm family (falcon-mamba-7b: Mamba-1's selective scan) in the port
against the JAX reference.

Weights come from the reference's ``Model(cfg).init(PRNGKey(0))`` through
numpy and ``repro_torch.bridge``; both packages keep the conv state in
bf16 (the reference's rule).  Checked, each with its tolerance:

* the config and ``reduced`` field for field, the bridge leaf for leaf
  over the reference's stacked layers;
* ``ssm_scan_plain`` against the reference's scan (its ``_discretize``
  and the ``lax.scan`` step of ``ssm_forward``) on the same dt / b / c / x
  / a_log, h and y in float32, without and with ``lengths`` (a row past
  its length keeps h bit for bit; up to it, the reference's scan of the
  row's real positions);
* ``ssm_forward`` / ``ssm_prefill`` / ``ssm_decode`` against the
  reference's at f32 and bf16 compute, and a padded prefill of a layer
  against the reference's unpadded one;
* ``Model.forward``, ``prefill`` and ``decode_step`` against the
  reference's; prefill plus decode against the reference's ``forward``
  (tests/test_decode_equivalence.py's 2e-2 x max|logits|); the port's
  ``prefill(lengths=)`` of right-padded rows against the reference's
  unpadded prefill (state, conv tail and last logits);
* engine streams at f32 against the reference's unpadded prefill plus
  greedy ``decode_step`` for prompts off the bucket sizes (the reference's
  engine pads the prompt into its scan: a fault it has), and streams,
  events, stats and ``compilations()`` equal to the reference engine's on
  bucket-exact prompts, with float and int8 weights;
* the refusals, with the reference's messages; ``program_launches``
  against the wrappers' calls; ``serve --arch falcon-mamba-7b``;
* on the card (``cuda``-marked, skipped here): the scan kernel bit for bit
  its plain loop, and one CUDA graph per bucket with graphed = eager.
"""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PagingConfig
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec,
                                   maxima_for)
from repro_torch.kernels import counts
from repro_torch.kernels import int8_matmul as i8_mod
from repro_torch.kernels import layernorm as ln_mod
from repro_torch.kernels import ssm_scan as scan_mod
from repro_torch.kernels import tiled_matmul as tm_mod
from repro_torch.models import ssm
from repro_torch.models.model import Model
from repro_torch.models.ssm import SSMState
from repro_torch.serving.engine import ServingEngine

NAME = "falcon-mamba-7b"
CFG = reduced(get_config(NAME))
LOGIT_TOL = 2e-2        # x max|logits|, tests/test_decode_equivalence.py
FN_TOL = 1e-5           # x max|out|, float32 (other orders of sums)
BF16_TOL = 2e-2         # x max|out|, bf16 compute (a few bf16 roundings)
MAX_LEN = 96            # buckets 32, 64, 96


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.core.serve_quant import quantize_params
    from repro.models import ssm as j_ssm
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine

    j_cfg = j_reduced(REGISTRY[NAME])
    params = JModel(j_cfg).init(jax.random.PRNGKey(0))
    sd = from_jax_params(jax.tree.map(np.asarray, params), CFG, "cpu")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=REGISTRY, j_reduced=j_reduced,
        cfg=j_cfg, params=params, sd=sd, spec=j_spec, ssm=j_ssm,
        model=JModel, options=ModelOptions, engine=JServingEngine,
        quantize=quantize_params)


def _close(want, got, rel):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _model(sd, compute=torch.float32, **kw):
    tm = Model(CFG, compute_dtype=compute, device="cpu", **kw)
    tm.load_state_dict(sd)
    return tm


def _jmodel(ref, compute=None):
    return ref.model(ref.cfg, ref.options(
        compute_dtype=ref.jnp.float32 if compute is None else compute))


# ---------------------------------------------------------------------------
# config and bridge
# ---------------------------------------------------------------------------
def test_config_and_reduced_match_the_reference(ref):
    for port, j in ((get_config(NAME), ref.registry[NAME]),
                    (CFG, ref.cfg)):
        jd = dataclasses.asdict(j)
        assert dataclasses.asdict(port) == {
            k: v for k, v in jd.items() if k in dataclasses.asdict(port)}
    full = get_config(NAME)
    assert (full.num_layers, full.d_model, full.vocab_size, full.norm,
            full.positional, full.tie_embeddings) == (
        64, 4096, 65024, "rmsnorm", "none", False)
    assert ssm.dims(full) == (8192, 256, 16)
    assert ssm.dims(CFG) == (128, 8, 8) and CFG.ssm.conv_kernel == 4
    assert RuntimeSpec(arch=full).resolved_policy == "bucketed"
    assert RuntimeSpec(arch=full).memory.cache_layout == "dense"


def test_bridge_maps_the_stacked_layers_leaf_for_leaf(ref):
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        else:
            flat[prefix[:-1]] = np.asarray(tree)
    walk(ref.params, "")
    names = {n for n in flat if n.startswith("layers.")}
    assert names == {f"layers.{leaf}" for leaf in (
        "ln.scale", "ssm.in_proj.kernel", "ssm.conv_w", "ssm.conv_b",
        "ssm.x_proj.kernel", "ssm.dt_proj.kernel", "ssm.dt_proj.bias",
        "ssm.a_log", "ssm.d_skip", "ssm.out_proj.kernel")}
    for name, arr in flat.items():
        if name.startswith("layers."):
            for i in range(CFG.num_layers):
                np.testing.assert_array_equal(
                    ref.sd[name.replace("layers.", f"layers.{i}.")].numpy(),
                    arr[i])
        else:
            np.testing.assert_array_equal(ref.sd[name].numpy(), arr)
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu")
    assert set(tm.state_dict()) == set(ref.sd)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
def _scan_inputs(seed, b=2, s=13):
    rs = np.random.RandomState(seed)
    di, n = 16, 8
    dt = np.log1p(np.exp(rs.randn(b, s, di))).astype(np.float32)
    x = rs.randn(b, s, di).astype(np.float32)
    bm = rs.randn(b, s, n).astype(np.float32)
    cm = rs.randn(b, s, n).astype(np.float32)
    a_log = (rs.rand(di, n) * 2 - 1).astype(np.float32)
    return dt, x, bm, cm, a_log


def _ref_scan(ref, dt, x, bm, cm, a_log):
    """The reference's scan: its ``_discretize`` and the ``lax.scan`` step
    of ``ssm_forward`` (h = a_bar h + bx, y = einsum(h, c))."""
    jnp = ref.jnp
    a_bar, bx = ref.ssm._discretize(jnp.asarray(dt), jnp.asarray(bm),
                                    jnp.asarray(x), jnp.asarray(a_log))

    def step(h, inp):
        a_t, bx_t, c_t = inp
        h = a_t * h + bx_t
        return h, jnp.einsum("bdn,bn->bd", h, c_t)
    h0 = jnp.zeros((dt.shape[0], dt.shape[2], a_log.shape[1]), jnp.float32)
    h, ys = ref.jax.lax.scan(step, h0, (a_bar.transpose(1, 0, 2, 3),
                                        bx.transpose(1, 0, 2, 3),
                                        jnp.asarray(cm).transpose(1, 0, 2)))
    return np.asarray(ys).transpose(1, 0, 2), np.asarray(h)


def _port_scan(dt, x, bm, cm, a_log, lengths=None):
    a = -torch.exp(torch.from_numpy(a_log))
    t = [torch.from_numpy(v) for v in (dt, x, bm, cm)]
    return scan_mod.ssm_scan(*t, a, lengths)


def test_ssm_scan_plain_matches_the_reference_scan(ref):
    """h and y in float32 within 1e-5 x max (the readout's order of sums
    differs from the einsum's)."""
    inputs = _scan_inputs(11)
    want_y, want_h = _ref_scan(ref, *inputs)
    y, h = _port_scan(*inputs)
    _close(want_y, y.numpy(), FN_TOL)
    _close(want_h, h.numpy(), FN_TOL)


def test_ssm_scan_plain_with_lengths(ref):
    """Rows of 13 positions with lengths 13, 6 and 0: up to its length a
    row is the reference's scan of its real positions (1e-5 x max); past
    it h is kept bit for bit and y reads the kept h."""
    dt, x, bm, cm, a_log = _scan_inputs(12, b=3)
    n = torch.tensor([13, 6, 0], dtype=torch.int32)
    y, h = _port_scan(dt, x, bm, cm, a_log, n)
    full_y, full_h = _port_scan(dt, x, bm, cm, a_log)
    assert torch.equal(y[0], full_y[0]) and torch.equal(h[0], full_h[0])
    for b, m in ((1, 6),):
        want_y, want_h = _ref_scan(ref, *(v[b:b + 1, :m] for v in
                                          (dt, x, bm, cm)), a_log)
        _close(want_y, y[b:b + 1, :m].numpy(), FN_TOL)
        _close(want_h, h[b:b + 1].numpy(), FN_TOL)
        part_y, part_h = _port_scan(*(v[b:b + 1, :m] for v in
                                      (dt, x, bm, cm)), a_log)
        assert torch.equal(h[b], part_h[0])
        assert torch.equal(y[b, :m], part_y[0])
        c = torch.from_numpy(cm[b, m:])
        assert torch.equal(y[b, m:], scan_mod.readout(h[b][None], c[:, None]))
    assert torch.equal(h[2], torch.zeros_like(h[2]))
    assert torch.equal(y[2], torch.zeros_like(y[2]))


def test_ssm_scan_readout_order_and_checks():
    """The readout sums runs of 4 states in order, then the runs' partials
    pairwise, neighbours first; the wrapper refuses what the kernel does
    not take."""
    rs = np.random.RandomState(13)
    h = torch.from_numpy(rs.randn(3, 16).astype(np.float32))
    c = torch.from_numpy(rs.randn(3, 16).astype(np.float32))
    p = h * c
    part = [((p[:, 4 * j] + p[:, 4 * j + 1]) + p[:, 4 * j + 2])
            + p[:, 4 * j + 3] for j in range(4)]
    assert torch.equal(scan_mod.readout(h, c),
                       (part[0] + part[1]) + (part[2] + part[3]))
    dt, x, bm, cm, a_log = (torch.from_numpy(v) for v in _scan_inputs(14))
    with pytest.raises(ValueError, match="float32"):
        scan_mod.ssm_scan(dt.double(), x, bm, cm, a_log)
    with pytest.raises(ValueError, match="lengths must be"):
        scan_mod.ssm_scan(dt, x, bm, cm, a_log,
                          torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="state size N=12"):
        scan_mod.ssm_scan(dt, x, bm[..., :6].repeat(1, 1, 2),
                          cm[..., :6].repeat(1, 1, 2),
                          a_log[:, :6].repeat(1, 2))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_ssm_block_matches_reference(ref, compute):
    """``ssm_forward``, ``ssm_prefill`` (output, h, the bf16 conv tail) and
    ``ssm_decode`` of one layer: 1e-5 x max at f32, 2e-2 x max at bf16;
    the bf16 conv tail within one bf16 step at f32, equal rows at bf16."""
    jnp = ref.jnp
    tdt = torch.float32 if compute == "fp32" else torch.bfloat16
    jdt = jnp.float32 if compute == "fp32" else jnp.bfloat16
    tol = FN_TOL if compute == "fp32" else BF16_TOL
    jp = ref.jax.tree.map(lambda a: a[0], ref.params["layers"]["ssm"])
    tp = _model(ref.sd, tdt).layers[0].ssm
    rs = np.random.RandomState(3)
    x = rs.randn(2, 11, CFG.d_model).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    _close(ref.ssm.ssm_forward(xj, jp, ref.cfg),
           ssm.ssm_forward(xt, tp, CFG, "xla").float(), tol)
    want, jst = ref.ssm.ssm_prefill(xj, jp, ref.cfg)
    got, tst = ssm.ssm_prefill(xt, tp, CFG, "xla")
    _close(want, got.float(), tol)
    assert tst.conv.dtype == torch.bfloat16 and tst.h.dtype == torch.float32
    _close(np.asarray(jst.conv, np.float32), tst.conv.float(), 2 ** -7)
    _close(jst.h, tst.h, tol)
    xd = rs.randn(2, 1, CFG.d_model).astype(np.float32)
    want, jnew = ref.ssm.ssm_decode(jnp.asarray(xd, jdt), jp, ref.cfg, jst)
    got = ssm.ssm_decode(torch.from_numpy(xd).to(tdt), tp, CFG, tst, "xla")
    _close(want, got.float(), tol)
    _close(np.asarray(jnew.conv, np.float32), tst.conv.float(), 2 ** -7)
    _close(jnew.h, tst.h, tol)


def test_ssm_prefill_of_a_padded_prompt_is_the_unpadded_one(ref):
    """Rows right-padded to 16 positions with ``lengths`` 9 and 2 give the
    reference's state of the unpadded rows (h within 1e-5 x max, the conv
    window from the last real rows with zeros before position 0, bit for
    bit) and its outputs there (1e-5 x max)."""
    jp = ref.jax.tree.map(lambda a: a[1], ref.params["layers"]["ssm"])
    tp = _model(ref.sd).layers[1].ssm
    rs = np.random.RandomState(4)
    x = rs.randn(2, 16, CFG.d_model).astype(np.float32)
    lengths = torch.tensor([9, 2], dtype=torch.int32)
    out, st = ssm.ssm_prefill(torch.from_numpy(x), tp, CFG, "xla", lengths)
    for b, n in enumerate((9, 2)):
        want, jst = ref.ssm.ssm_prefill(ref.jnp.asarray(x[b:b + 1, :n]), jp,
                                        ref.cfg)
        _close(want, out[b:b + 1, :n], FN_TOL)
        _close(jst.h, st.h[b:b + 1], FN_TOL)
        np.testing.assert_array_equal(np.asarray(jst.conv, np.float32),
                                      st.conv[b:b + 1].float().numpy())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_steps(ref):
    """The reference's forward over 24 tokens, its prefill of the first 12
    and 4 decode steps after it, at f32."""
    jnp = ref.jnp
    jm = _jmodel(ref)
    rs = np.random.RandomState(7)
    toks = rs.randint(0, CFG.vocab_size, (2, 24)).astype(np.int32)
    full = np.asarray(jm.forward(ref.params, {"tokens": jnp.asarray(toks)}))
    logits, cache = jm.prefill(ref.params,
                               {"tokens": jnp.asarray(toks[:, :12])},
                               max_len=MAX_LEN)
    steps = [np.asarray(logits)]
    for t in range(12, 16):
        lg, cache = jm.decode_step(ref.params, cache,
                                   jnp.asarray(toks[:, t:t + 1]),
                                   jnp.asarray(t, jnp.int32))
        steps.append(np.asarray(lg))
    return toks, full, steps, cache


def test_model_forward_prefill_and_decode_match_reference(ref, ref_steps):
    """``forward`` and ``prefill`` within 1e-5 x max|logits| of the
    reference's, each decode step's logits and the final state within 1e-4
    x max (the steps read the bf16 conv state, as the reference's)."""
    toks, full, steps, jcache = ref_steps
    tm = _model(ref.sd)
    _close(full, tm.forward(torch.from_numpy(toks)), FN_TOL)
    logits, cache = tm.prefill(torch.from_numpy(toks[:, :12]), MAX_LEN)
    assert isinstance(cache, SSMState)
    assert tuple(cache.conv.shape) == (2, 2, 3, 128)
    assert tuple(cache.h.shape) == (2, 2, 128, 8)
    _close(steps[0], logits, FN_TOL)
    for i, t in enumerate(range(12, 16)):
        lg = tm.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]),
                            torch.full((2,), t, dtype=torch.int32))
        _close(steps[i + 1], lg, 1e-4)
    _close(jcache.h, cache.h, 1e-4)
    _close(np.asarray(jcache.conv, np.float32), cache.conv.float(), 2 ** -7)


def test_prefill_then_decode_matches_forward(ref, ref_steps):
    """The counterpart of tests/test_decode_equivalence.py: prefill 12
    tokens, decode to 24; every step's logits against the reference's
    ``forward`` within 2e-2 x max|logits| (the conv state is bf16)."""
    toks, full, _, _ = ref_steps
    tol = LOGIT_TOL * float(np.abs(full).max())
    tm = _model(ref.sd)
    logits, cache = tm.prefill(torch.from_numpy(toks[:, :12]), MAX_LEN)
    assert float(np.abs(logits.numpy() - full[:, :12]).max()) < tol
    for t in range(12, 24):
        lg = tm.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]),
                            torch.full((2,), t, dtype=torch.int32))
        err = float(np.abs(lg[:, 0].numpy() - full[:, t]).max())
        assert err < tol, f"step {t}: {err} vs {tol}"


def test_padded_model_prefill_is_the_unpadded_reference_prefill(ref):
    """``prefill(lengths=)`` of rows right-padded to 32 (real lengths 20
    and 5): each row's state (h within 1e-5 x max; the bf16 conv tail
    within one bf16 step, since the f32 product over the padded rows may
    differ from the unpadded one's in its last bit) and the logits of its
    last real token (1e-5 x max) are the reference's prefill of the
    unpadded row."""
    jnp = ref.jnp
    rs = np.random.RandomState(8)
    toks = rs.randint(0, CFG.vocab_size, (2, 32)).astype(np.int32)
    lengths = torch.tensor([20, 5], dtype=torch.int32)
    logits, cache = _model(ref.sd).prefill(torch.from_numpy(toks), MAX_LEN,
                                           lengths=lengths)
    jm = _jmodel(ref)
    for b, n in enumerate((20, 5)):
        jl, jc = jm.prefill(ref.params,
                            {"tokens": jnp.asarray(toks[b:b + 1, :n])},
                            max_len=MAX_LEN)
        _close(np.asarray(jl)[:, -1], logits[b:b + 1, n - 1], FN_TOL)
        _close(jc.h, cache.h[:, b:b + 1], FN_TOL)
        _close(np.asarray(jc.conv, np.float32),
               cache.conv[:, b:b + 1].float(), 2 ** -7)


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


def _port_engine(ref, **kw):
    eng = ServingEngine(_spec(_PORT, CFG, **kw), device="cpu")
    eng.load(ref.sd)
    return eng


def _drain(eng, prompts, new):
    log = []
    eng.events.subscribe(log.append)
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    return [done[u] for u in uids], [(e.kind, e.uid, e.step, e.data)
                                     for e in log]


def _ref_stream(ref, prompt: tuple, new: int) -> list[int]:
    """The reference model's greedy stream: ``prefill`` of the unpadded
    prompt, then ``decode_step``."""
    jnp = ref.jnp
    jm = _jmodel(ref)
    logits, cache = jm.prefill(ref.params, {"tokens": jnp.asarray([prompt])},
                               max_len=MAX_LEN)
    out = [int(jnp.argmax(logits[0, -1]))]
    for i in range(new - 1):
        logits, cache = jm.decode_step(
            ref.params, cache, jnp.asarray([[out[-1]]], jnp.int32),
            jnp.asarray(len(prompt) + i, jnp.int32))
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


# the reference engine's fault (ROADMAP.md Queue 3): this 10-token prompt
# in its 32-token bucket, 6 greedy tokens
PAD_PROMPT = list(range(3, 13))


@pytest.fixture(scope="module")
def gold(ref):
    """The reference model's unpadded streams: prompts of 10 and 21 tokens
    (bucket 32) and 45 (bucket 64), 6 new tokens each; and the fault's
    prompt."""
    rs = np.random.RandomState(9)
    prompts = [tuple(rs.randint(0, CFG.vocab_size, n).tolist())
               for n in (10, 21, 45)]
    return prompts, [_ref_stream(ref, p, 6) for p in prompts], \
        _ref_stream(ref, tuple(PAD_PROMPT), 6)


@pytest.mark.parametrize("mm", ["xla", "pallas"])
def test_engine_streams_are_the_unpadded_prefills(ref, gold, mm):
    """Streams over prompts that do not fill their bucket equal the
    reference model's over the unpadded prompts, on the gather path and
    the kernels' plain versions."""
    prompts, want, _ = gold
    got, _ = _drain(_port_engine(ref, matmul_backend=mm),
                    [list(p) for p in prompts], 6)
    assert got == want


def test_the_reference_engine_pads_its_scan(ref, gold):
    """The fault the port does not copy (ROADMAP.md, faults of the
    reference): the reference engine's stream of a 10-token prompt is its
    padded prefill's, not the unpadded one's; the port's is the latter."""
    je = ref.engine(_spec(ref.spec, ref.cfg))
    je.load(ref.params)
    j_stream = _drain(je, [PAD_PROMPT], 6)[0][0]
    assert j_stream != gold[2]
    assert _drain(_port_engine(ref), [PAD_PROMPT], 6)[0][0] == gold[2]


@pytest.mark.parametrize("mm,quant", [("xla", False), ("pallas", False),
                                      ("xla", True)])
def test_bucket_exact_prompts_match_the_reference_engine(ref, mm, quant):
    """Prompts of exactly 32 and 64 tokens (no pad): streams, events, the
    engine's counters and ``compilations()`` equal the reference engine's,
    float weights on the gather path and the kernels' plain versions, and
    int8 weights (``quant_min_size`` 1: every kernel and the tables)."""
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, CFG.vocab_size, n).tolist()
               for n in (32, 64, 32)]
    qkw = dict(quant="int8", quant_min_size=1) if quant else {}
    je = ref.engine(_spec(ref.spec, ref.cfg, **qkw))
    je.load(ref.params)
    te = _port_engine(ref, matmul_backend=mm, **qkw)
    if quant:
        assert te.model.layers[0].ssm.in_proj.kernel.dtype == torch.int8
        assert te.model.layers[1].ssm.dt_proj.kernel.dtype == torch.int8
    want, got = _drain(je, prompts, 5), _drain(te, prompts, 5)
    assert got == want
    for key in ("decode_steps", "prefill_tokens", "device_gets",
                "harvest_elems"):
        assert te.stats[key] == je.stats[key], key
    assert dict(te.compilations) == dict(je.compilations())
    assert te.scheduler == je.scheduler == "bucketed"


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
    assert "ssm" in msg
    auto = RuntimeSpec(arch=CFG, memory=MemorySpec(max_len=64))
    assert auto.resolved_policy == "bucketed"


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
    assert "family 'ssm' needs its own engine" in str(t_err.value)


# ---------------------------------------------------------------------------
# launch counts and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", [False, True])
def test_program_launches_count_the_wrappers(ref, quant):
    """One prefill and one decode step on the kernels' plain versions: the
    wrappers' calls equal ``program_launches`` (256 products, 65 norms and
    64 scans a prefill at full width; here 2 layers)."""
    qkw = dict(quant="int8", quant_min_size=1) if quant else {}
    tm = _model(ref.sd, matmul_backend="pallas", **qkw)
    toks = torch.randint(0, CFG.vocab_size, (2, 40), dtype=torch.int32)
    cache = tm.init_cache(batch=2, max_len=64)
    runs = {"prefill": lambda: tm.prefill(toks, 64),
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
        with wrap(tm_mod, "tiled_matmul"), wrap(i8_mod, "int8_matmul"), \
                wrap(ln_mod, "rmsnorm"), wrap(scan_mod, "ssm_scan"):
            run()
        want = counts.program_launches(CFG, program, layout="dense",
                                       quant=quant)
        assert {n: calls.get(n, 0) for n in want} == want, program
    full = get_config(NAME)
    for program, scans in (("prefill", 64), ("decode", 0)):
        assert counts.program_launches(full, program, layout="dense") == {
            "tiled_matmul": 256, "int8_matmul": 0, "rmsnorm": 65,
            "paged_decode_attention": 0, "chunked_prefill_attention": 0,
            "rglru_scan": 0, "ssm_scan": scans}


def test_launch_serve_falcon_mamba_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-new", "4",
          "--max-len", "64", "--model", NAME, "--temperature", "0",
          "--kernels", "pallas"])
    out = capsys.readouterr().out
    assert f"{NAME} on cpu: 3 requests, 12 tokens" in out
    assert "bucketed scheduler, dense cache" in out
    with pytest.raises(ValueError, match="cache_layout='paged' is "
                       "unsupported for family 'ssm'"):
        main(["--device", "cpu", "--arch", NAME, "--cache-layout", "paged"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_scan_kernel_is_its_plain_loop_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    for B, S, Di, N, lens, dt_x in (
            (1, 300, 8192, 16, [123], torch.bfloat16),
            (3, 17, 300, 16, [17, 0, 9], torch.float32),
            (2, 64, 128, 8, None, torch.float32),
            (2, 33, 96, 32, [33, 1], torch.bfloat16)):
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, Di, generator=g, device="cuda"))
        x = torch.randn(B, S, Di, generator=g, device="cuda").to(dt_x)
        b = torch.randn(B, S, N, generator=g, device="cuda")
        c = torch.randn(B, S, N, generator=g, device="cuda")
        a = -torch.exp(torch.rand(Di, N, generator=g, device="cuda") * 2 - 1)
        n = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                   device="cuda")
        before = scan_mod.ssm_scan.launches
        got = scan_mod.ssm_scan(dt, x, b, c, a, n)
        assert scan_mod.ssm_scan.launches == before + 1
        for u, v in zip(got, scan_mod.ssm_scan_plain(dt, x, b, c, a, n),
                        strict=True):
            assert torch.equal(u, v)


@pytest.mark.cuda
def test_one_graph_per_bucket_and_graphed_equals_eager_on_the_card():
    """Reduced falcon-mamba on the kernel path: prompts in buckets 32, 64
    and 128: one capture per bucket and one of the decode program,
    replayed on a second drain; the streams are the eager engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas"),
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
