"""Speculative decoding in the port against the JAX reference.

The same weights (the reference's ``Model.init(PRNGKey(0))`` at
``reduced_cfg("qwen1.5-0.5b")``, bridged through numpy) go through both
packages:

* the dense-cache mixed attend ``attention.gqa_mixed`` (the draft's) with
  dead lanes, start offsets and live lanes past the cache end: at float32
  the output within 1e-4 x max|out| and the written cache rows within
  1e-5 (summation order only); at bf16 the output within 2e-2 x max|out|
  (the reference's bf16 tolerance) and the cache within one bf16 step;
  the model's dense ``mixed_step`` the same way (at float32 over float32
  caches in both packages; at bf16 its cache within 2e-2 x max|cache|,
  since a later layer's rows carry the earlier layers' bf16 rounding);
* ``speculative_accept``'s greedy branch bit for bit, ties planted;
* the stochastic branch: the emitted token's frequencies follow the
  target's softened distribution (the rejection-sampling identity) within
  4.5 standard errors, over 4000 draws at V = 8; two fresh engines replay;
* the engine at float32 compute over the serving layout's bf16 (or int8)
  pool: self-draft k = 3 over the draft's bf16 cache, a noisy and a
  1-layer draft over float32 draft caches in both packages (a draft that
  is not the target has near-ties that bf16 rounding may break either
  way), with the gather path and
  with the kernels as their plain versions (the reference's Pallas kernels
  in interpret mode; over an int8 pool its gather engine, since its Pallas
  engine diverges there): greedy streams, lifecycle events, fused steps,
  ``spec_steps`` and ``spec_accepted`` equal the reference's, and the
  streams equal the port's engine with speculation off; the prefix cache
  composition drains to ``used_blocks == cached_blocks``; int8 weights
  with a quantized draft; the validation messages;
* a fleet that speculates (the reference census's
  ``fleet-paged-spec-chunked``: a self-draft of member A, and member B, a
  1-layer "adaptor-bert-shaped" topology of vocab 96, in maxima): streams,
  events, fused steps, ``spec_steps`` and ``spec_accepted`` equal the
  reference fleet engine's bit for bit at float32 compute over bf16 and
  int8 pools, on the gather path and the kernels' plain versions (live_kv
  at W = 4 on the decode program), and with the fleet's int8 weight
  table; the draft's proposals for B's slots are rejected where they fall
  past B's vocab (NEG_INF logits there), and no token leaves it.

The compositions (prefix cache, int8 weights, stochastic replay), the
validation messages, the launcher and the fleet that speculates are in
tests/test_torch_speculative_fleet.py, which shares this module's
fixture and helpers (the file is split so that ``--dist loadfile``
spreads the two halves over two workers).

This module imports the JAX reference only inside its fixtures, so the
card test also runs where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_speculative.py``.
"""
import dataclasses
import types
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec, maxima_for)
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampling import (propose_per_slot,
                                          speculative_accept)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CFG = reduced(get_config("qwen1.5-0.5b"))
DRAFT1 = dataclasses.replace(CFG, num_layers=1)
# the fleet's second member (the reference census's fleet point)
MEMBER = dataclasses.replace(
    CFG, name="adaptor-bert-shaped", num_layers=1, d_model=48, num_heads=3,
    num_kv_heads=3, d_ff=96, vocab_size=96)
FLEET_MAXIMA = maxima_for(CFG, MEMBER, seq_max=64)
MEMBER_REQS = [([4, 5], 10), ([6, 7, 8], 8), ([80, 70, 60, 50], 6)]
# the reference suite's workload (tests/test_speculative.py)
REQS = [([1, 2, 3], 16), (list(range(9, 17)), 12), ([5, 4], 10)]
# the reference's near-tie-free workload for int8 serving
# (tests/test_kv_quant.py PROMPTS)
QUANT_REQS = [(p, 10) for p in ([1, 2, 3], [4, 5, 6, 7, 8, 9], [7] * 12,
                                [30, 31])]


@pytest.fixture(scope="module")
def ref():
    """The reference's init, its engine surface and the same weights
    bridged into a state dict of the port; also two drafts of both: the
    same architecture with seeded noise (0.3 x each kernel's std) on every
    layer's dense kernels (partly accepted), and a 1-layer one (the
    embedding, layer 0 and the final norm of the same weights)."""
    import jax

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.models import attention as j_attn
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving import sampling as j_sampling
    from repro.serving.engine import ServingEngine as JServingEngine
    from repro_torch.bridge import from_jax_params
    j_cfg = j_reduced(REGISTRY["qwen1.5-0.5b"])
    params = JModel(j_cfg).init(jax.random.PRNGKey(0))
    j_member = dataclasses.replace(
        j_cfg, name="adaptor-bert-shaped", num_layers=1, d_model=48,
        num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)
    member_params = JModel(j_member).init(jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, params)
    j_draft = dataclasses.replace(j_cfg, num_layers=1)
    j_draft_params = dict(params, layers=jax.tree.map(lambda a: a[:1],
                                                      params["layers"]))
    rs = np.random.RandomState(1)
    noisy_np = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.3 * a.std() * rs.randn(*a.shape).astype(
            a.dtype) if path[0].key == "layers"
        and path[-1].key == "kernel" else a, np_params)
    noisy = jax.tree.map(jax.numpy.asarray, noisy_np)
    sd = from_jax_params(np_params, CFG, "cpu")
    draft_sd = {k: v for k, v in sd.items()
                if not k.startswith("layers.") or k.startswith("layers.0.")}
    return types.SimpleNamespace(
        jax=jax, cfg=j_cfg, spec=j_spec, engine=JServingEngine,
        params=params, attn=j_attn, model=JModel, options=ModelOptions,
        sampling=j_sampling, draft_cfg=j_draft, draft_params=j_draft_params,
        sd=sd, draft_sd=draft_sd, noisy=noisy,
        noisy_sd=from_jax_params(noisy_np, CFG, "cpu"),
        member_cfg=j_member, member_params=member_params,
        member_sd=from_jax_params(jax.tree.map(np.asarray, member_params),
                                  MEMBER, "cpu"),
        maxima=j_spec.maxima_for(j_cfg, j_member, seq_max=64))


# ---------------------------------------------------------------------------
# (a) the dense-cache mixed attend, and the model's dense mixed step
# ---------------------------------------------------------------------------
S_MAX, W = 24, 6
# slot 0 a prompt chunk at 0; slot 1 one decode lane at 9; slot 2 idle;
# slot 3 a chunk at 20 whose last two live lanes fall past the cache end
START = np.array([0, 9, 5, 20], np.int32)
N_LIVE = np.array([6, 1, 0, 6], np.int32)


def _close(ref_out, got, rel):
    assert np.isfinite(got).all()
    err, scale = np.abs(ref_out - got).max(), np.abs(ref_out).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_gqa_mixed_matches_reference(ref, compute):
    jnp = ref.jax.numpy
    jdt = jnp.float32 if compute == "fp32" else jnp.bfloat16
    tdt = torch.float32 if compute == "fp32" else torch.bfloat16
    tm = Model(CFG, compute_dtype=tdt, device="cpu")
    tm.load_state_dict(ref.sd)
    lp = ref.jax.tree.map(lambda a: a[0], ref.params["layers"])["attn"]
    rs = np.random.RandomState(3)
    B, kv, hd = len(START), CFG.num_kv_heads, CFG.resolved_head_dim
    x = rs.randn(B, W, CFG.d_model).astype(np.float32)
    k0 = rs.randn(B, S_MAX, kv, hd).astype(np.float32)
    v0 = rs.randn(B, S_MAX, kv, hd).astype(np.float32)
    x_j = jnp.asarray(x).astype(jdt)
    jc = ref.attn.KVCache(jnp.asarray(k0).astype(jdt),
                          jnp.asarray(v0).astype(jdt), None, None)
    j_out, jc = ref.attn.gqa_mixed(x_j, lp, ref.cfg, jc, jnp.asarray(START),
                                   jnp.asarray(N_LIVE))
    spare = np.full((B, 1, kv, hd), np.nan, np.float32)   # never admitted
    tc = KVCache(torch.from_numpy(np.concatenate([k0, spare], 1)).to(tdt),
                 torch.from_numpy(np.concatenate([v0, spare], 1)).to(tdt))
    t_out = attn.gqa_mixed(torch.from_numpy(x).to(tdt), tm.layers[0].attn,
                           CFG, tc, torch.from_numpy(START),
                           torch.from_numpy(N_LIVE), mm="xla")
    live = np.arange(W)[None, :] < N_LIVE[:, None]
    j_np = np.asarray(j_out.astype(jnp.float32))[live]
    _close(j_np, t_out.float().numpy()[live],
           1e-4 if compute == "fp32" else 2e-2)
    for jp, tp, before in ((jc.k, tc.k, k0), (jc.v, tc.v, v0)):
        want = np.asarray(jp.astype(jnp.float32))
        got = tp[:, :S_MAX].float().numpy()
        if compute == "fp32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
        # the dead lanes and the lanes past the end wrote nothing there
        written = np.zeros((B, S_MAX), bool)
        for b in range(B):
            written[b, START[b]:min(START[b] + N_LIVE[b], S_MAX)] = True
        np.testing.assert_array_equal(
            got[~written], torch.from_numpy(before).to(tdt).float()
            .numpy()[~written])


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_dense_mixed_step_matches_reference(ref, compute):
    """The draft's route through ``Model.mixed_step`` (block_tables None):
    a prompt chunk with dead lanes, then one decode lane per slot, logits
    and the dense cache after each against the reference model's."""
    jnp = ref.jax.numpy
    jdt = jnp.float32 if compute == "fp32" else jnp.bfloat16
    tdt = torch.float32 if compute == "fp32" else torch.bfloat16
    jm = ref.model(ref.cfg, ref.options(compute_dtype=jdt))
    tm = Model(CFG, compute_dtype=tdt, device="cpu")
    tm.load_state_dict(ref.sd)
    jc = jm.init_cache(3, S_MAX)
    tc = tm.init_dense_cache(3, S_MAX)
    assert tuple(tc.k.shape) == (CFG.num_layers, 3, S_MAX + 1,
                                 CFG.num_kv_heads, CFG.resolved_head_dim)
    assert tc.k.dtype == torch.bfloat16 and tc.k_scale is None
    if compute == "fp32":
        # the tight check over float32 caches in both packages (over the
        # bf16 storage a last-bit difference can round a K/V element to
        # the neighbouring bf16 value in one package only)
        jc = ref.jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = KVCache(tc.k.float(), tc.v.float())
    rs = np.random.RandomState(4)
    toks = rs.randint(0, CFG.vocab_size, (3, 8)).astype(np.int32)
    rel = 1e-4 if compute == "fp32" else 2e-2
    for start, n_live in ((np.array([0, 0, 0]), np.array([8, 5, 0])),
                          (np.array([8, 5, 0]), np.array([1, 1, 0]))):
        start, n_live = start.astype(np.int32), n_live.astype(np.int32)
        w = int(n_live.max())
        jl, jc = jm.mixed_step(ref.params, jc, jnp.asarray(toks[:, :w]),
                               jnp.asarray(start), jnp.asarray(n_live))
        tl = tm.mixed_step(tc, torch.from_numpy(toks[:, :w]),
                           torch.from_numpy(start), torch.from_numpy(n_live))
        live = np.arange(w)[None, :] < n_live[:, None]
        _close(np.asarray(jl)[live], tl.numpy()[live], rel)
        for jp, tp in ((jc.k, tc.k), (jc.v, tc.v)):
            want = np.asarray(jp.astype(jnp.float32))
            got = tp[:, :, :S_MAX].float().numpy()
            if compute == "fp32":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            else:
                # layer 1's rows carry layer 0's bf16 rounding
                _close(want, got, 2e-2)


# ---------------------------------------------------------------------------
# (b) speculative_accept
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_accept_greedy_is_bit_identical(ref, seed):
    """Seeded logits with planted ties (two maxima in a lane: both take
    the first), proposals that match the target argmax for a random
    prefix; also rows at temperature 0 on the stochastic branch, which the
    greedy path serves."""
    jnp = ref.jax.numpy
    rs = np.random.RandomState(seed)
    B, k, V = 16, 3, 12
    tl = rs.randn(B, k + 1, V).astype(np.float32)
    for b in range(B):
        j = rs.randint(k + 1)
        top = tl[b, j].argmax()
        other = (top + 1 + rs.randint(V - 1)) % V
        tl[b, j, other] = tl[b, j, top]          # a tie: first max wins
    g = tl.argmax(-1)
    d = rs.randint(0, V, (B, k)).astype(np.int32)
    for b in range(B):
        n = rs.randint(k + 1)
        d[b, :n] = g[b, :n]
    dl = rs.randn(B, k, V).astype(np.float32)
    temp = np.zeros(B, np.float32)
    keys = ref.jax.random.split(ref.jax.random.PRNGKey(seed), B)
    for greedy in (True, False):
        j_n, j_out = ref.sampling.speculative_accept(
            jnp.asarray(tl), jnp.asarray(d), jnp.asarray(dl), keys,
            jnp.asarray(temp), greedy=greedy)
        t_n, t_out = speculative_accept(
            torch.from_numpy(tl), torch.from_numpy(d), torch.from_numpy(dl),
            torch.from_numpy(temp), [None] * B, None, greedy=greedy)
        assert t_n.dtype == t_out.dtype == torch.int32
        np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


def test_stochastic_accept_follows_the_target_distribution():
    """Rejection sampling emits lane 0's token from the target's softened
    distribution whatever the draft proposes: 4000 slots, each with its
    own generator, draw a proposal from the draft (``propose_per_slot``)
    and accept or correct it; the frequencies of ``out[:, 0]`` lie within
    4.5 standard errors (+ 1e-3) of p_t at every one of V = 8 tokens."""
    N, k, V, temp = 4000, 2, 8, 0.8
    rs = np.random.RandomState(0)
    t_row = torch.from_numpy(rs.randn(k + 1, V).astype(np.float32) * 1.5)
    d_row = torch.from_numpy(rs.randn(k, V).astype(np.float32) * 1.5)
    gens = [torch.Generator().manual_seed(1000 + i) for i in range(N)]
    rows = torch.arange(N)
    temps = torch.full((N,), temp)
    d_logits = d_row.expand(N, k, V).contiguous()
    d_toks = torch.stack([propose_per_slot(d_logits[:, j], temps, gens, rows)
                          for j in range(k)], dim=1)
    n_acc, out = speculative_accept(t_row.expand(N, k + 1, V), d_toks,
                                    d_logits, temps, gens, rows,
                                    greedy=False)
    assert 0 < float((n_acc > 0).float().mean()) < 1    # both branches ran
    p = torch.softmax(t_row[0] / temp, -1).numpy()
    freq = np.bincount(out[:, 0].numpy(), minlength=V) / N
    bound = 4.5 * np.sqrt(p * (1 - p) / N) + 1e-3
    assert (np.abs(freq - p) <= bound).all(), (freq, p, bound)


# ---------------------------------------------------------------------------
# (c) the engine
# ---------------------------------------------------------------------------
def _specs(ref, *, k, draft="self", kv="compute", mm="xla", impl="gather",
           ref_impl=None, prefix=False, quant="none", greedy_accept=True):
    mem = dict(max_batch=4, max_len=64, block_size=8, kv_dtype=kv,
               prefix_cache=prefix)
    qkw = dict(quant=quant, quant_min_size=1) if quant != "none" else {}
    j_draft, t_draft = (ref.draft_cfg, DRAFT1) if draft == "1-layer" \
        else (ref.cfg, CFG)
    j_sp = ref.spec.SpeculationSpec(draft_model=j_draft, k=k,
                                    greedy_accept=greedy_accept) if k else None
    t_sp = SpeculationSpec(draft_model=t_draft, k=k,
                           greedy_accept=greedy_accept) if k else None
    j = ref.spec.RuntimeSpec(
        arch=ref.cfg,
        execution=ref.spec.ExecutionSpec(
            matmul_backend=mm, paged_attn_impl=ref_impl or impl,
            compute_dtype="fp32", **qkw),
        memory=ref.spec.MemorySpec(cache_layout="paged", **mem),
        scheduler=ref.spec.SchedulerSpec(policy="chunked", chunk_size=8),
        speculation=j_sp)
    t = RuntimeSpec(
        arch=CFG,
        execution=ExecutionSpec(matmul_backend=mm, paged_attn_impl=impl,
                                compute_dtype="fp32", **qkw),
        memory=MemorySpec(cache_layout="paged", **mem),
        scheduler=SchedulerSpec(policy="chunked", chunk_size=8),
        speculation=t_sp)
    return j, t


def _engines(ref, *, draft="self", f32_draft_cache=False, **kw):
    j_spec, t_spec = _specs(ref, draft=draft, **kw)
    je = ref.engine(j_spec)
    te = ServingEngine(t_spec, device="cpu")
    if kw.get("k"):
        j_d, t_d = {"self": (ref.params, ref.sd),
                    "noisy": (ref.noisy, ref.noisy_sd),
                    "1-layer": (ref.draft_params, ref.draft_sd)}[draft]
        je.load(ref.params, draft=j_d)
        te.load(ref.sd, draft=t_d)
        if f32_draft_cache:
            # float32 draft caches in both packages: over the bf16 storage
            # a last-bit float32 difference can round a K/V element to the
            # neighbouring bf16 value in one package only, and a draft
            # that is not the target has near-ties in its argmax
            jnp = ref.jax.numpy
            je.draft_cache = ref.jax.tree.map(
                lambda a: a.astype(jnp.float32), je.draft_cache)
            te.draft_cache = KVCache(te.draft_cache.k.float(),
                                     te.draft_cache.v.float())
    else:
        je.load(ref.params)
        te.load(ref.sd)
    return je, te


def _drain(eng, reqs=REQS, waves=None):
    log = []
    eng.events.subscribe(log.append)
    streams = []
    for wave in waves or [reqs]:
        uids = [eng.submit(p, max_new_tokens=b) for p, b in wave]
        done = {r.uid: r.generated for r in eng.run_to_completion()}
        streams += [done[u] for u in uids]
    return streams, [(e.kind, e.uid, e.step, e.data) for e in log]


def _truncations(eng) -> Counter:
    """Count the blocks the engine hands back through truncation."""
    seen = Counter()
    truncate = eng.allocator.truncate

    def counting(blocks, keep):
        kept, zeros = truncate(blocks, keep)
        seen["blocks"] += len(blocks) - len(kept)
        return kept, zeros
    eng.allocator.truncate = counting
    return seen


PATHS = {"bf16-gather": ("compute", "xla", "gather", None),
         "bf16-kernels": ("compute", "pallas", "pallas", None),
         "int8-gather": ("int8", "xla", "gather", None),
         "int8-kernels": ("int8", "pallas", "pallas", "gather")}


@pytest.mark.parametrize("path,draft", [
    *((p, d) for d in ("self", "noisy") for p in PATHS),
    ("bf16-gather", "1-layer"), ("int8-kernels", "1-layer")])
def test_greedy_streams_match_reference(ref, path, draft):
    """k = 3: streams, events (``progress`` with ``accepted`` and
    ``spec_steps``), fused steps and the speculation stats equal the
    reference engine's; the streams equal the port's engine with
    speculation off, in fewer fused steps (the self-draft), on one program
    per kind.  The noisy draft is partly rejected and the 1-layer one
    rejected throughout at this size, so rollback hands blocks back."""
    kv, mm, impl, ref_impl = PATHS[path]
    je, te = _engines(ref, k=3, kv=kv, mm=mm, impl=impl, ref_impl=ref_impl,
                      draft=draft, f32_draft_cache=draft != "self")
    seen = _truncations(te)
    want, got = _drain(je), _drain(te)
    assert got == want
    for key in ("decode_steps", "spec_steps", "spec_accepted",
                "prefill_tokens"):
        assert te.stats[key] == je.stats[key], key
    assert te.compilations["decode"] == te.compilations["prefill"] == 1
    _, off = _engines(ref, k=0, kv=kv, mm=mm, impl=impl, ref_impl=ref_impl)
    plain = _drain(off)[0]
    assert got[0] == plain
    if draft == "self":
        assert te.draft_cache.k.dtype == torch.bfloat16   # never int8
        assert te.stats["spec_accepted"] > 0
        assert te.stats["decode_steps"] < off.stats["decode_steps"]
    else:
        assert te.stats["spec_accepted"] < 3 * te.stats["spec_steps"]
        assert seen["blocks"] > 0
    if draft == "noisy":
        assert te.stats["spec_accepted"] > 0
    s = te.memory_stats()
    assert s.used_blocks == 0 and te.allocator.num_free == s.total_blocks


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["self", "1-layer"])
def test_graphed_speculation_equals_eager(draft):
    """Both speculative programs as CUDA graphs, through the kernels: the
    streams and the speculation stats equal an eager engine's, each
    program is captured once and no step runs eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d_cfg = CFG if draft == "self" else DRAFT1
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas"),
        memory=MemorySpec(cache_layout="paged", max_batch=4, max_len=64,
                          block_size=8),
        scheduler=SchedulerSpec(chunk_size=8),
        speculation=SpeculationSpec(draft_model=d_cfg, k=3))
    params = Model(CFG, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0)).state_dict()
    draft_sd = {k: v for k, v in params.items()
                if not k.startswith("layers.") or k.startswith("layers.0.")} \
        if draft != "self" else params
    runs = []
    for graphs in (True, False):
        eng = ServingEngine(spec, graphs=graphs)
        eng.load(params, draft=draft_sd)
        uids = [eng.submit(p, max_new_tokens=b) for p, b in REQS]
        done = {r.uid: r.generated for r in eng.run_to_completion(
            sync_every=4)}
        runs.append(([done[u] for u in uids], eng.stats["spec_accepted"],
                     eng.stats["decode_steps"]))
        if graphs:
            assert eng.compilations["decode"] == 1
            assert eng.compilations["prefill"] == 1
            assert eng.stats["eager_steps"] == 0
    assert runs[0] == runs[1]
