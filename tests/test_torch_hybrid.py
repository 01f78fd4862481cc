"""The hybrid family (recurrentgemma-2b: RG-LRU and local attention) in the
port against the JAX reference.

Weights come from the reference's ``Model(cfg).init(PRNGKey(0))`` through
numpy and ``repro_torch.bridge``; compute is float32, and both packages
keep the rolling buffers in bf16 (the reference's rule).  Checked:

* the config and ``reduced`` field for field, the bridge leaf for leaf
  over the reference's per-layer list;
* ``rglru_forward`` / ``rglru_prefill`` / ``rglru_decode`` and
  ``local_attention`` against the reference's; ``rglru_scan``'s plain loop
  with ``lengths`` (a row past its length keeps h bit for bit), and the
  padded prefill of a layer against the reference's unpadded one;
* ``forward``, and prefill plus decode past the window (``max_len`` 96,
  window 32, prompts of 10, 40 and 70 tokens decoded to 90) against the
  reference's ``forward`` within 2e-2 x max|logits|
  (tests/test_decode_equivalence.py's tolerance);
* engine streams against the reference's ``Model.prefill`` of the
  unpadded prompt plus ``decode_step`` for prompts off the bucket sizes,
  one of them in a bucket longer than the window: the reference's engine
  pads the prompt into its recurrence and window, the port's does not;
* streams, events, stats and ``compilations()`` equal to the reference
  engine's for bucket-exact prompts (32 and 64 tokens), with float and
  int8 weights, on the gather path and (float) the kernels' plain
  versions;
* the refusals, with the reference's messages; ``program_launches``
  against the wrappers' calls; ``serve --arch recurrentgemma-2b``;
* ``rglru_plan``: every channel in one CTA, C dividing the CTA's threads,
  a grid of at least a CTA an SM where B x W allows, shared memory within
  a CTA's, the refusal of a plan no kernel takes;
* on the card (``cuda``-marked): one CUDA graph per bucket with graphed =
  eager, and both scan kernels bit for bit their plain loops under every
  plan the wrapper can choose, at ragged shapes and lengths, with an
  operand at storage offset 1, and without a host sync.
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
from repro_torch.kernels import rglru_scan as scan_mod
from repro_torch.kernels import tiled_matmul as tm_mod
from repro_torch.models import attention as attn
from repro_torch.models import rglru
from repro_torch.models.model import HybridCache, Model
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

NAME = "recurrentgemma-2b"
CFG = reduced(get_config(NAME))
LOGIT_TOL = 2e-2        # x max|logits|, tests/test_decode_equivalence.py
FN_TOL = 1e-5           # x max|out|, one layer at float32
MAX_LEN = 96            # buckets 32, 64, 96; the window is 32


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.core.serve_quant import quantize_params
    from repro.models import attention as j_attn
    from repro.models import rglru as j_rglru
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine

    j_cfg = j_reduced(REGISTRY[NAME])
    params = JModel(j_cfg).init(jax.random.PRNGKey(0))
    sd = from_jax_params(jax.tree.map(np.asarray, params), CFG, "cpu")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=REGISTRY, j_reduced=j_reduced,
        cfg=j_cfg, params=params, sd=sd, spec=j_spec, attn=j_attn,
        rglru=j_rglru, model=JModel, options=ModelOptions,
        engine=JServingEngine, quantize=quantize_params)


def _close(want, got, rel):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _model(sd, **kw):
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(sd)
    return tm


def _jmodel(ref):
    return ref.model(ref.cfg, ref.options(compute_dtype=ref.jnp.float32))


# ---------------------------------------------------------------------------
# config and bridge
# ---------------------------------------------------------------------------
def test_config_and_reduced_match_the_reference(ref):
    for port, j in ((get_config(NAME), ref.registry[NAME]),
                    (CFG, ref.cfg)):
        assert dataclasses.asdict(port) == {
            k: v for k, v in dataclasses.asdict(j).items()
            if k in dataclasses.asdict(port)}
    assert CFG.num_layers == 3 and CFG.hybrid.attention_window == 32 \
        and CFG.hybrid.lru_width == 0 and CFG.hybrid.pattern == ("r", "r",
                                                                 "a")
    full = get_config(NAME)
    assert (full.num_layers, full.d_model, full.hybrid.lru_width,
            full.num_heads, full.num_kv_heads, full.head_dim, full.d_ff,
            full.vocab_size, full.hybrid.attention_window) == (
        26, 2560, 2560, 10, 1, 256, 7680, 256000, 2048)


def test_bridge_maps_the_per_layer_list_leaf_for_leaf(ref):
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = np.asarray(tree)
    walk(ref.params, "")
    assert isinstance(ref.params["layers"], list)
    assert set(flat) == set(ref.sd)
    for name, arr in flat.items():
        np.testing.assert_array_equal(ref.sd[name].numpy(), arr)
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu")
    assert set(tm.state_dict()) == set(ref.sd)
    assert [k for k, _ in tm.kinds] == ["r", "r", "a"]
    assert hasattr(tm.layers[0], "rglru") and hasattr(tm.layers[2], "attn")


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _lru_pair(ref, i=0):
    return ref.params["layers"][i]["rglru"], _model(ref.sd).layers[i].rglru


def test_rglru_forward_prefill_and_decode_match_reference(ref):
    jp, tp = _lru_pair(ref)
    jnp = ref.jnp
    rs = np.random.RandomState(3)
    x = rs.randn(2, 11, CFG.d_model).astype(np.float32)
    want = ref.rglru.rglru_forward(jnp.asarray(x), jp, ref.cfg)
    got = rglru.rglru_forward(torch.from_numpy(x), tp, CFG, "xla")
    _close(want, got.numpy(), FN_TOL)
    want, jst = ref.rglru.rglru_prefill(jnp.asarray(x), jp, ref.cfg)
    got, tst = rglru.rglru_prefill(torch.from_numpy(x), tp, CFG, "xla")
    _close(want, got.numpy(), FN_TOL)
    assert tst.conv.dtype == torch.bfloat16 and tst.h.dtype == torch.float32
    _close(np.asarray(jst.conv, np.float32), tst.conv.float().numpy(), 2e-3)
    _close(jst.h, tst.h.numpy(), FN_TOL)
    xd = rs.randn(2, 1, CFG.d_model).astype(np.float32)
    want, jnew = ref.rglru.rglru_decode(jnp.asarray(xd), jp, ref.cfg, jst)
    got = rglru.rglru_decode(torch.from_numpy(xd), tp, CFG, tst, "xla")
    _close(want, got.numpy(), FN_TOL)
    _close(np.asarray(jnew.conv, np.float32), tst.conv.float().numpy(), 2e-3)
    _close(jnew.h, tst.h.numpy(), FN_TOL)


def test_rglru_prefill_of_a_padded_prompt_is_the_unpadded_one(ref):
    """Rows right-padded to 16 positions with ``lengths`` 9 and 2 give the
    reference's state of the unpadded rows (conv window from the last real
    rows, zeros before position 0) and its outputs there."""
    jp, tp = _lru_pair(ref, 1)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 16, CFG.d_model).astype(np.float32)
    lengths = torch.tensor([9, 2], dtype=torch.int32)
    out, st = rglru.rglru_prefill(torch.from_numpy(x), tp, CFG, "xla",
                                  lengths)
    for b, n in enumerate((9, 2)):
        want, jst = ref.rglru.rglru_prefill(ref.jnp.asarray(x[b:b + 1, :n]),
                                            jp, ref.cfg)
        _close(want, out[b:b + 1, :n].numpy(), FN_TOL)
        _close(jst.h, st.h[b:b + 1].numpy(), FN_TOL)
        np.testing.assert_array_equal(np.asarray(jst.conv, np.float32),
                                      st.conv[b:b + 1].float().numpy())


def test_rglru_scan_plain_keeps_h_past_each_length():
    rs = np.random.RandomState(5)
    a = torch.from_numpy(rs.rand(3, 12, 8).astype(np.float32))
    g = torch.from_numpy(rs.randn(3, 12, 8).astype(np.float32))
    n = torch.tensor([12, 5, 0], dtype=torch.int32)
    hs, h = scan_mod.rglru_scan(a, g, n)
    full, last = scan_mod.rglru_scan_plain(a, g)
    assert torch.equal(hs[0], full[0]) and torch.equal(h[0], last[0])
    # row 1: the recurrence up to position 4, then h kept bit for bit
    assert torch.equal(hs[1, :5], full[1, :5])
    assert torch.equal(hs[1, 5:], full[1, 4].expand(7, 8))
    assert torch.equal(h[1], full[1, 4])
    assert torch.equal(hs[2], torch.zeros(12, 8)) and torch.equal(
        h[2], torch.zeros(8))
    # the recurrence itself: two float32 operators a position
    ref_h = torch.zeros(8)
    for t in range(12):
        ref_h = a[0, t] * ref_h + g[0, t]
        assert torch.equal(full[0, t], ref_h)
    with pytest.raises(ValueError, match="float32"):
        scan_mod.rglru_scan(a.double(), g.double())
    with pytest.raises(ValueError, match="lengths must be"):
        scan_mod.rglru_scan(a, g, n.long())


@pytest.mark.parametrize("B, W, fwd_c, bwd_c", [
    (1, 2560, 16, 32), (2, 2560, 32, 64), (4, 2560, 64, 128),
    (8, 2560, 128, 128), (1, 2561, 16, 32), (3, 300, 8, 8), (2, 256, 8, 8),
    (1, 8, 8, 8), (1, 1, 8, 8), (1, 8192, 32, 64), (16, 64, 8, 8)])
def test_rglru_plan_covers_every_channel_once(B, W, fwd_c, bwd_c):
    """``rglru_plan`` at the serving shapes (recurrentgemma-2b's W 2560 at
    a prefill's one row, two rows and a training batch) and ragged ones: C
    is a built width dividing the CTA's 4C threads (32-512), the grid holds
    every channel in exactly one CTA, and it reaches the direction's
    target (a CTA an SM forward, half the SMs backward) wherever some
    built C can (the widest such C), else takes the narrowest; both
    directions' plans, fitted to short and long rows, keep C and leave
    room for two CTAs an SM."""
    for backward, want_c in ((False, fwd_c), (True, bwd_c)):
        plan = scan_mod.rglru_plan(B, W, backward)
        c = plan.channels
        assert c == want_c and c in scan_mod.CHANNELS
        assert plan.threads % c == 0 and 32 <= plan.threads <= 512
        gx, gy = plan.grid(B, W)
        assert gy == B and gx * c >= W > (gx - 1) * c
        ctas, floats = scan_mod.PLAN_TARGETS[backward]
        fits = [k for k in scan_mod.CHANNELS if -(-W // k) * B >= ctas]
        assert c == (fits[0] if fits else min(scan_mod.CHANNELS))
        assert gx * gy >= ctas or not fits
        assert plan.positions == min(256, floats // c)
        for S in (1, 7, 8, 9, 64, 300, 3072):
            fit = plan.fit(S)
            assert fit.channels == c
            assert fit.positions % 8 == 0 and 8 <= fit.positions <= 256
            assert fit.positions <= max(8, -(-S // 8) * 8)
            assert 0 < scan_mod.smem_bytes(fit, backward) \
                <= scan_mod.SMEM_LIMIT // 2
        assert plan.fit(3072) == plan


def test_rglru_plan_refusals_and_launch_text():
    """A plan no kernel takes is refused before any launch, with the plan
    in the message; ``describe`` gives the plan, grid and shared memory."""
    plan = scan_mod.rglru_plan(1, 2560)
    text = scan_mod.describe(plan, 1, 2560)
    assert f"C {plan.channels}, T {plan.positions}" in text
    assert "grid 160 x 1 CTAs of 64 threads" in text
    assert f"{scan_mod.smem_bytes(plan)} B dynamic smem" in text
    for bad in (plan._replace(channels=12),
                plan._replace(channels=128, positions=256)):
        with mock.patch.object(scan_mod, "rglru_plan",
                               lambda *a, bad=bad, **k: bad), \
                pytest.raises(ValueError, match="no kernel takes the plan"):
            scan_mod._plan(1, 3072, 2560, backward=True)


@pytest.mark.parametrize("s", [20, 32, 45, 70])
def test_local_attention_matches_reference(ref, s):
    rs = np.random.RandomState(s)
    q, k, v = (rs.randn(2, s, 4, 16).astype(np.float32) for _ in range(3))
    want = ref.attn.local_attention(*(ref.jnp.asarray(t) for t in (q, k, v)),
                                    32)
    got = attn.local_attention(*(torch.from_numpy(t) for t in (q, k, v)), 32)
    _close(want, got.numpy(), FN_TOL)


def test_rolling_prefill_and_decode_match_reference(ref):
    """One local-attention layer: the rolling buffer of a prefill longer
    than the window, then decode steps that wrap it; and a padded prefill
    with ``lengths`` whose buffer is the unpadded prompt's."""
    jnp = ref.jnp
    jp = ref.params["layers"][2]["attn"]
    tp = _model(ref.sd).layers[2].attn
    rs = np.random.RandomState(6)
    x = rs.randn(2, 45, CFG.d_model).astype(np.float32)
    pos = np.tile(np.arange(45, dtype=np.int32), (2, 1))
    want, jc = ref.attn.gqa_prefill(jnp.asarray(x), jp, ref.cfg,
                                    positions=jnp.asarray(pos), max_len=64,
                                    window=32)
    got, tc = attn.gqa_prefill(torch.from_numpy(x), tp, CFG,
                               torch.from_numpy(pos), max_len=64, mm="xla",
                               window=32)
    _close(want, got.numpy(), FN_TOL)
    assert tc.k.dtype == torch.bfloat16 and tuple(tc.k.shape) == jc.k.shape
    for jt, tt in ((jc.k, tc.k), (jc.v, tc.v)):
        _close(np.asarray(jt, np.float32), tt.float().numpy(), 2 ** -7)
    for idx in ([45, 45], [46, 80]):
        xd = rs.randn(2, 1, CFG.d_model).astype(np.float32)
        want, jc = ref.attn.gqa_decode(jnp.asarray(xd), jp, ref.cfg, jc,
                                       jnp.asarray(np.array(idx, np.int32)),
                                       window=32)
        got = attn.gqa_decode(torch.from_numpy(xd), tp, CFG, tc,
                              torch.tensor(idx, dtype=torch.int32), mm="xla",
                              window=32)
        # over the bf16 buffer the attend and wo run in bf16 (the
        # reference's dtype flow): a few bf16 roundings apart
        assert got.dtype == torch.bfloat16
        _close(np.asarray(want, np.float32), got.float().numpy(), 2 ** -6)
        for jt, tt in ((jc.k, tc.k), (jc.v, tc.v)):
            _close(np.asarray(jt, np.float32), tt.float().numpy(), 2 ** -7)
    # padded to 64 positions, lengths 40 and 10: the unpadded prefills'
    # buffers
    xp = rs.randn(2, 64, CFG.d_model).astype(np.float32)
    posp = np.tile(np.arange(64, dtype=np.int32), (2, 1))
    _, tc = attn.gqa_prefill(torch.from_numpy(xp), tp, CFG,
                             torch.from_numpy(posp), max_len=96, mm="xla",
                             window=32,
                             lengths=torch.tensor([40, 10], dtype=torch.int32))
    for b, n in enumerate((40, 10)):
        _, jc = ref.attn.gqa_prefill(
            jnp.asarray(xp[b:b + 1, :n]), jp, ref.cfg,
            positions=jnp.asarray(posp[b:b + 1, :n]), max_len=96, window=32)
        _close(np.asarray(jc.k, np.float32), tc.k[b:b + 1].float().numpy(),
               2 ** -7)
        _close(np.asarray(jc.v, np.float32), tc.v[b:b + 1].float().numpy(),
               2 ** -7)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_forward_matches_reference(ref):
    rs = np.random.RandomState(7)
    toks = rs.randint(0, CFG.vocab_size, (2, 70)).astype(np.int32)
    want = _jmodel(ref).forward(ref.params, {"tokens": ref.jnp.asarray(toks)})
    got = _model(ref.sd).forward(torch.from_numpy(toks))
    _close(want, got.numpy(), FN_TOL)


@pytest.mark.parametrize("P", [10, 40, 70])
def test_prefill_then_decode_past_the_window_matches_forward(ref, P):
    """The counterpart of tests/test_decode_equivalence.py past the
    window: prefill P tokens into a ``max_len`` 96 cache, decode to 90;
    every step's logits against the reference's ``forward``."""
    rs = np.random.RandomState(8)
    toks = rs.randint(0, CFG.vocab_size, (1, 90)).astype(np.int32)
    full = np.asarray(_jmodel(ref).forward(
        ref.params, {"tokens": ref.jnp.asarray(toks)}))
    tol = LOGIT_TOL * float(np.abs(full).max())
    tm = _model(ref.sd)
    logits, cache = tm.prefill(torch.from_numpy(toks[:, :P]), MAX_LEN)
    assert isinstance(cache, HybridCache)
    assert tuple(cache.conv.shape) == (2, 1, 3, CFG.d_model)
    assert tuple(cache.k.shape) == (1, 1, 32, CFG.num_kv_heads,
                                    CFG.resolved_head_dim)
    assert float(np.abs(logits.numpy() - full[:, :P]).max()) < tol
    for t in range(P, 90):
        lg = tm.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]),
                            torch.tensor([t], dtype=torch.int32))
        err = float(np.abs(lg[:, 0].numpy() - full[:, t]).max())
        assert err < tol, f"step {t}: {err} vs {tol}"


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
    prompt into a ``MAX_LEN`` cache, then ``decode_step``."""
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


def test_engine_streams_are_the_unpadded_prefills(ref):
    """Prompts of 10 (bucket 32), 40 (bucket 64, longer than the window)
    and 70 tokens (bucket 96): each stream is the reference model's over
    the unpadded prompt, on the gather path and the kernels' plain
    versions."""
    rs = np.random.RandomState(9)
    prompts = [tuple(rs.randint(0, CFG.vocab_size, n).tolist())
               for n in (10, 40, 70)]
    want = [_ref_stream(ref, p, 6) for p in prompts]
    for mm in ("xla", "pallas"):
        got, _ = _drain(_port_engine(ref, matmul_backend=mm),
                        [list(p) for p in prompts], 6)
        assert got == want, mm


def test_the_reference_engine_pads_its_recurrent_state(ref):
    """The fault the port does not copy (ROADMAP.md, faults of the
    reference): the reference engine's stream of a 10-token prompt is its
    padded prefill's, not the unpadded one's; the port's is the latter."""
    prompt = list(range(3, 13))
    je = ref.engine(_spec(ref.spec, ref.cfg))
    je.load(ref.params)
    j_stream = _drain(je, [prompt], 6)[0][0]
    gold = _ref_stream(ref, tuple(prompt), 6)
    assert j_stream != gold
    assert _drain(_port_engine(ref), [prompt], 6)[0][0] == gold


@pytest.mark.parametrize("mm,quant", [("xla", False), ("pallas", False),
                                      ("xla", True)])
def test_bucket_exact_prompts_match_the_reference_engine(ref, mm, quant):
    """Prompts of exactly 32 and 64 tokens (no pad): streams, events, the
    engine's counters and ``compilations()`` equal the reference engine's,
    float weights on the gather path and the kernels' plain versions, and
    int8 weights (``quant_min_size`` 1: every kernel and the table)."""
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, CFG.vocab_size, n).tolist()
               for n in (32, 64, 32)]
    qkw = dict(quant="int8", quant_min_size=1) if quant else {}
    je = ref.engine(_spec(ref.spec, ref.cfg, **qkw))
    je.load(ref.params)
    te = _port_engine(ref, matmul_backend=mm, **qkw)
    if quant:
        assert te.model.layers[0].rglru.in_x.kernel.dtype == torch.int8
        assert te.model.layers[2].attn.wq.kernel.dtype == torch.int8
    want, got = _drain(je, prompts, 5), _drain(te, prompts, 5)
    assert got == want
    for key in ("decode_steps", "prefill_tokens", "device_gets",
                "harvest_elems"):
        assert te.stats[key] == je.stats[key], key
    assert dict(te.compilations) == dict(je.compilations())
    assert te.scheduler == je.scheduler == "bucketed"


def test_int8_weights_quantize_each_layer_leaf_alone(ref):
    """The reference keeps the hybrid layers unstacked, so its size rule
    measures each kernel alone: at a floor between one layer's in_x
    (64 x 64) and the three layers' stacked size, the port quantizes what
    the reference does."""
    floor = 64 * 64 + 1
    q = ref.quantize(ref.params, floor)
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu", quant="int8",
               quant_min_size=floor)
    tm.load_state_dict(ref.sd)
    got = {n for n, t in tm.state_dict().items() if t.dtype == torch.int8}
    want = set()

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.")
        elif isinstance(tree, tuple) or type(tree).__name__ == "QTensor":
            want.add(prefix[:-1])
    walk(q, "")
    assert got == want and "layers.0.ffn.w1.kernel" in got
    assert "layers.0.rglru.in_x.kernel" not in got


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
    assert "hybrid" in msg
    auto = RuntimeSpec(arch=CFG, memory=MemorySpec(max_len=64))
    assert auto.resolved_policy == "bucketed"


def test_model_refusals_are_the_references(ref):
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
    with pytest.raises(ValueError, match="needs its own engine"):
        RuntimeSpec(arch=CFG, maxima=maxima_for(CFG, seq_max=64),
                    memory=MemorySpec(max_len=64))


# ---------------------------------------------------------------------------
# launch counts and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", [False, True])
def test_program_launches_count_the_wrappers(ref, quant):
    """One prefill and one decode step on the kernels' plain versions: the
    wrappers' calls equal ``program_launches`` (164 products, 53 norms
    and 18 scans a prefill at full width; here 3 layers)."""
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
                wrap(ln_mod, "rmsnorm"), wrap(scan_mod, "rglru_scan"):
            run()
        want = counts.program_launches(CFG, program, layout="dense",
                                       quant=quant)
        assert {n: calls.get(n, 0) for n in want} == want, program
    full = get_config(NAME)
    for program, scans in (("prefill", 18), ("decode", 0)):
        assert counts.program_launches(full, program, layout="dense") == {
            "tiled_matmul": 164, "int8_matmul": 0, "rmsnorm": 53,
            "paged_decode_attention": 0, "chunked_prefill_attention": 0,
            "rglru_scan": scans, "ssm_scan": 0}


def test_launch_serve_recurrentgemma_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-new", "4",
          "--max-len", "64", "--arch", NAME, "--temperature", "0",
          "--kernels", "pallas"])
    out = capsys.readouterr().out
    assert f"{NAME} on cpu: 3 requests, 12 tokens" in out
    assert "bucketed scheduler, dense cache" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_one_graph_per_bucket_and_graphed_equals_eager_on_the_card():
    """Reduced recurrentgemma on the kernel path: prompts in buckets 32,
    64 and 128 (two of them past the window): one capture per bucket and
    one of the decode program, replayed on a second drain; the streams are
    the eager engine's."""
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
    assert graphed.stats["prefill_replays"] == 7
    assert graphed.stats["graph_captures"] == 1


def _card_plans(backward: bool) -> list:
    """Every plan ``rglru_plan`` can return, and two plans that stress the
    ring: tiles of 8 positions (the ring wrapping every few tiles), and C 8
    with tiles of 32."""
    plans = {scan_mod.rglru_plan(b, w, backward) for b in (1, 2, 4, 8)
             for w in (8, 300, 2560, 2561, 8192)}
    plans |= {scan_mod.RGLRUPlan(16, 8), scan_mod.RGLRUPlan(8, 32)}
    return sorted(plans)


def _offset_one(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` at storage offset 1 (4 bytes past a
    16-byte boundary): the kernels' element path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.storage_offset() == 1 and out.is_contiguous()
    return out


# (B, S, W, lengths): S a multiple of no tile, W of no C (300) or not of 4
# (2561: the element path), S = 1 and 8 (rows of one tile) and 9, lengths
# 0, at a tile edge (256, 128, 64, 32: every plan's T) and past S
CARD_SCAN_ROWS = ((1, 300, 2560, [123]), (3, 17, 300, [17, 0, 9]),
                  (2, 64, 256, None), (8, 1, 2560, [1, 0, 1, 1, 0, 1, 1, 1]),
                  (2, 8, 2561, [8, 3]), (2, 9, 64, [9, 0]),
                  (4, 300, 2561, [128, 0, 400, 256]),
                  (2, 257, 300, [64, 32]))


@pytest.mark.cuda
def test_scan_kernel_is_its_plain_loop_on_the_card(monkeypatch):
    """hs and the last h bit for bit the plain loop's under every plan the
    wrapper can choose (``rglru_plan`` patched) at ragged S, W and
    lengths, with an operand at storage offset 1, and a launch under
    ``set_sync_debug_mode("error")`` (no host sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    for B, S, W, lens in CARD_SCAN_ROWS:
        a = torch.rand(B, S, W, generator=g, device="cuda")
        gg = torch.randn(B, S, W, generator=g, device="cuda")
        n = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                   device="cuda")
        want = scan_mod.rglru_scan_plain(a, gg, n)
        for plan in _card_plans(backward=False):
            monkeypatch.setattr(scan_mod, "rglru_plan",
                                lambda *a_, p_=plan, **k_: p_)
            for ops in ((a, gg), (_offset_one(a), gg), (a, _offset_one(gg))):
                before = scan_mod.rglru_scan.launches
                got = scan_mod.rglru_scan(*ops, n)
                assert scan_mod.rglru_scan.launches == before + 1
                for x, y in zip(got, want, strict=True):
                    assert torch.equal(x, y), (B, S, W, lens, plan)
    monkeypatch.undo()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = scan_mod.rglru_scan(a, gg, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_scan_backward_kernel_is_its_plain_loop_on_the_card(monkeypatch):
    """``rglru_scan_bwd`` bit for bit ``rglru_scan_bwd_plain`` (the same
    float32 operators a position, in the same order) under every plan the
    wrapper can choose, at ragged S and W, S = 1, with an operand at
    storage offset 1, and once under ``set_sync_debug_mode("error")``; the
    autograd path through ``rglru_scan`` launching the forward and the
    backward kernel once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    for B, S, W in ((1, 300, 2560), (3, 17, 300), (2, 64, 256),
                    (2, 129, 2561), (4, 1, 2560)):
        a = torch.rand(B, S, W, generator=g, device="cuda")
        gg = torch.randn(B, S, W, generator=g, device="cuda")
        dhs = torch.randn(B, S, W, generator=g, device="cuda")
        dh = torch.randn(B, W, generator=g, device="cuda")
        hs, _ = scan_mod.rglru_scan_plain(a, gg)
        want = scan_mod.rglru_scan_bwd_plain(a, hs, dhs, dh)
        for plan in _card_plans(backward=True):
            monkeypatch.setattr(scan_mod, "rglru_plan",
                                lambda *a_, p_=plan, **k_: p_)
            for ops in ((a, hs, dhs), (_offset_one(a), hs, dhs),
                        (a, _offset_one(hs), dhs), (a, hs, _offset_one(dhs))):
                before = scan_mod.rglru_scan_bwd.launches
                for x, y in zip(scan_mod.rglru_scan_bwd(*ops, dh), want,
                                strict=True):
                    assert torch.equal(x, y), (B, S, W, plan)
                assert scan_mod.rglru_scan_bwd.launches == before + 1
        monkeypatch.undo()
        ar, gr = a.clone().requires_grad_(), gg.clone().requires_grad_()
        seen = (scan_mod.rglru_scan.launches,
                  scan_mod.rglru_scan_bwd.launches)
        hs2, h2 = scan_mod.rglru_scan(ar, gr)
        got = torch.autograd.grad((hs2 * dhs).sum() + (h2 * dh).sum(),
                                  [ar, gr])
        assert (scan_mod.rglru_scan.launches,
                scan_mod.rglru_scan_bwd.launches) == (seen[0] + 1,
                                                      seen[1] + 1)
        for x, y in zip(got, want, strict=True):
            assert torch.equal(x, y)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = scan_mod.rglru_scan_bwd(a, hs, dhs, dh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)
