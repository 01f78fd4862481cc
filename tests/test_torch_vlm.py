"""The vlm family in the port (phi-3-vision-4.2b) against the JAX reference
at its ``reduced`` config (a stub vision frontend of 8 patch tokens).

Weights come from the reference's ``Model(cfg).init(PRNGKey)`` and go
through numpy and ``repro_torch.bridge``; the frontend's patch embeddings
are seeded numpy arrays.  Checked:

* the port's config equals the reference's field for field, full and
  reduced (the frontend and its ``reduced`` rule: 8 tokens of 64);
* the bridge carries the dense family's leaves, leaf for leaf;
* ``Model.forward`` with the seeded frontend at float32 (1e-4 x
  max|logits|) and bfloat16 (the reference's 2e-2), and the frontend
  rule: positions below ``num_tokens`` take the frontend's rows, so their
  token ids do not move the logits;
* ``mixed_step`` with ``prefill_lanes`` whose lanes straddle position 8
  (a prompt lane below it is zeroed, a decode lane is not) against the
  reference's, over the paged pool and the dense layout;
* greedy engine streams, lifecycle events and step counts bit for bit
  against the reference engine at float32 compute, over bf16 and int8
  pools, on the gather route and through the kernels' plain versions, on
  the chunked and the bucketed scheduler;
* a self-draft at k = 2 (the draft's prompt pass zeroes the patch lanes
  too);
* a fleet refuses the family with the reference's message.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PagingConfig
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec, maxima_for)
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine

NAME = "phi-3-vision-4.2b"
FULL = get_config(NAME)
CFG = reduced(FULL)
N_FE = CFG.frontend.num_tokens                      # 8
STEP_TOL = 1e-4                   # x max|logits|, float32 compute and pool
BF16_TOL = 2e-2                   # tests/test_decode_equivalence.py:56
BS, NBLK, NUM_BLOCKS = 8, 4, 12
TABLES = np.array([[3, 1, 7, 0], [2, 9, 4, 11], [5, 6, 0, 0]], np.int32)
# prompts of 3-19 tokens: some end inside the patch positions, some past
PROMPTS = [[1, 2, 3], list(range(1, 12)), list(range(2, 40, 2)), [9] * 9]


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.core.paging import PagingConfig as JPagingConfig
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine

    @functools.cache
    def build():
        j_cfg = j_reduced(REGISTRY[NAME])
        params = JModel(j_cfg).init(jax.random.PRNGKey(5))
        sd = from_jax_params(jax.tree.map(np.asarray, params), CFG, "cpu")
        return j_cfg, params, sd

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=REGISTRY, reduced=j_reduced,
        model=JModel, options=ModelOptions, spec=j_spec,
        paging=JPagingConfig, engine=JServingEngine, build=build)


def _close(want, got, rel):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _inputs(B=2, S=12, seed=1):
    """Token ids and the stub frontend's patch embeddings [B, 8, d_model]
    (float32, rounded to bf16 as the reference suite's are)."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)
    fe = rs.randn(B, N_FE, CFG.d_model).astype(np.float32)
    fe = torch.from_numpy(fe).to(torch.bfloat16).float().numpy()
    return toks, fe


# ---------------------------------------------------------------------------
# config and bridge
# ---------------------------------------------------------------------------
def test_port_config_matches_reference(ref):
    for port, j in ((FULL, ref.registry[NAME]),
                    (CFG, ref.reduced(ref.registry[NAME]))):
        assert dataclasses.asdict(port) == {
            k: v for k, v in dataclasses.asdict(j).items()
            if k in dataclasses.asdict(port)}
    assert FULL.source == "hf:microsoft/Phi-3-vision-128k-instruct"
    assert (FULL.family, FULL.num_layers, FULL.d_model, FULL.num_heads,
            FULL.num_kv_heads, FULL.resolved_head_dim, FULL.d_ff,
            FULL.vocab_size) == ("vlm", 32, 3072, 32, 32, 96, 8192, 32064)
    assert (FULL.frontend.kind, FULL.frontend.num_tokens,
            FULL.frontend.feature_dim) == ("vision", 576, 3072)
    assert (CFG.frontend.num_tokens, CFG.frontend.feature_dim) == (8, 64)


def test_bridge_carries_the_dense_leaves(ref):
    """vlm's parameters are the dense family's (the reference's
    ``# dense / vlm / encoder`` branch): every leaf, bit for bit."""
    j_cfg, params, sd = ref.build()
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu")
    assert set(tm.state_dict()) == set(sd)
    assert not any("frontend" in n for n in sd)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(params)
    for name, arr in flat.items():
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(CFG.num_layers):
                np.testing.assert_array_equal(
                    sd[f"layers.{i}.{rest}"].numpy(), arr[i])
        else:
            np.testing.assert_array_equal(sd[name].numpy(), arr)
    tm.load_state_dict(sd)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_forward_with_frontend_matches_reference(ref, compute):
    j_cfg, params, sd = ref.build()
    jnp = ref.jnp
    jdt = jnp.float32 if compute == "fp32" else jnp.bfloat16
    tdt = torch.float32 if compute == "fp32" else torch.bfloat16
    jm = ref.model(j_cfg, ref.options(compute_dtype=jdt))
    tm = Model(CFG, compute_dtype=tdt, device="cpu")
    tm.load_state_dict(sd)
    toks, fe = _inputs()
    want = jm.forward(params, {"tokens": jnp.asarray(toks),
                               "frontend": jnp.asarray(fe, jnp.bfloat16)})
    got = tm.forward(torch.from_numpy(toks),
                     torch.from_numpy(fe).to(torch.bfloat16))
    _close(want, got.numpy(), STEP_TOL if compute == "fp32" else BF16_TOL)
    # without a frontend the reference embeds every token
    _close(jm.forward(params, {"tokens": jnp.asarray(toks)}),
           tm.forward(torch.from_numpy(toks)).numpy(),
           STEP_TOL if compute == "fp32" else BF16_TOL)


def test_frontend_positions_ignore_their_token_ids(ref):
    """The stub's rule: positions below num_tokens take the frontend's
    rows, so changing their token ids leaves forward's and prefill's
    logits bit for bit as they were."""
    _, _, sd = ref.build()
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(sd)
    toks, fe = _inputs(S=12)
    other = toks.copy()
    other[:, :N_FE] = (other[:, :N_FE] + 17) % CFG.vocab_size
    fe_t = torch.from_numpy(fe)
    a = tm.forward(torch.from_numpy(toks), fe_t)
    b = tm.forward(torch.from_numpy(other), fe_t)
    assert torch.equal(a, b)
    la, _ = tm.prefill(torch.from_numpy(toks), 16, fe_t)
    lb, _ = tm.prefill(torch.from_numpy(other), 16, fe_t)
    assert torch.equal(la, lb) and torch.equal(la, a)
    assert not torch.equal(a, tm.forward(torch.from_numpy(other)))


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_mixed_step_zeroes_prompt_lanes_below_the_patches(ref, layout):
    """Lanes of prefilling slots at positions < 8 carry the (zero) patch
    embeddings: slot 0's chunk covers 0-7, slot 1's straddles 8 (lanes at
    4-7 zeroed, 8-11 tokens), slot 2 decodes at position 6 (not zeroed);
    f32 compute over f32 caches, against the reference's mixed_step."""
    j_cfg, params, sd = ref.build()
    jnp = ref.jnp
    jm = ref.model(j_cfg, ref.options(compute_dtype=jnp.float32))
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(sd)
    rs = np.random.RandomState(2)
    toks = rs.randint(0, CFG.vocab_size, (3, 8)).astype(np.int32)
    start = np.array([0, 4, 6], np.int32)
    n_live = np.array([8, 8, 1], np.int32)
    lanes = np.array([True, True, False])
    if layout == "paged":
        jc = jm.init_cache(3, NBLK * BS, paging=ref.paging(BS, NUM_BLOCKS))
        tc = tm.init_cache(PagingConfig(BS, NUM_BLOCKS))
        kw = dict(block_tables=jnp.asarray(TABLES))
        tkw = dict(block_tables=torch.from_numpy(TABLES))
    else:
        jc = jm.init_cache(3, 32)
        tc = tm.init_cache(batch=3, max_len=32)
        kw, tkw = {}, {}
    jc = ref.jax.tree.map(lambda a: a.astype(jnp.float32), jc)
    tc = KVCache(tc.k.float(), tc.v.float())
    want, _ = jm.mixed_step(params, jc, jnp.asarray(toks),
                            jnp.asarray(start), jnp.asarray(n_live),
                            prefill_lanes=jnp.asarray(lanes), **kw)
    got = tm.mixed_step(tc, torch.from_numpy(toks), torch.from_numpy(start),
                        torch.from_numpy(n_live),
                        prefill_lanes=torch.from_numpy(lanes), **tkw)
    live = np.arange(8)[None, :] < n_live[:, None]
    _close(np.asarray(want)[live], got.numpy()[live], STEP_TOL)
    # without prefill_lanes no lane is zeroed: other logits
    tc2 = tm.init_cache(PagingConfig(BS, NUM_BLOCKS)) if layout == "paged" \
        else tm.init_cache(batch=3, max_len=32)
    plain = tm.mixed_step(KVCache(tc2.k.float(), tc2.v.float()),
                          torch.from_numpy(toks), torch.from_numpy(start),
                          torch.from_numpy(n_live), **tkw)
    assert not torch.allclose(plain[0], got[0])
    assert torch.equal(plain[2, 0], got[2, 0])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
# (kv dtype, matmul backend, port attention, reference attention): the
# reference's int8 Pallas engine is red, so its gather route is the oracle
PATHS = {"bf16-gather": ("compute", "xla", "gather", "gather"),
         "bf16-kernels": ("compute", "pallas", "pallas", "pallas"),
         "int8-gather": ("int8", "xla", "gather", "gather"),
         "int8-kernels": ("int8", "pallas", "pallas", "gather")}


def _engines(ref, path="bf16-gather", policy="auto", layout="paged",
             spec_k=0):
    kv, mm, impl, ref_impl = PATHS[path]
    j_cfg, params, sd = ref.build()
    mem = dict(cache_layout=layout, max_batch=3, max_len=32, block_size=8,
               kv_dtype=kv)
    je = ref.engine(ref.spec.RuntimeSpec(
        arch=j_cfg,
        execution=ref.spec.ExecutionSpec(matmul_backend=mm,
                                         paged_attn_impl=ref_impl,
                                         compute_dtype="fp32"),
        memory=ref.spec.MemorySpec(**mem),
        scheduler=ref.spec.SchedulerSpec(policy=policy, chunk_size=8),
        speculation=ref.spec.SpeculationSpec(draft_model=j_cfg, k=spec_k)
        if spec_k else None))
    te = ServingEngine(RuntimeSpec(
        arch=CFG,
        execution=ExecutionSpec(matmul_backend=mm, paged_attn_impl=impl,
                                compute_dtype="fp32"),
        memory=MemorySpec(**mem),
        scheduler=SchedulerSpec(policy=policy, chunk_size=8),
        speculation=SpeculationSpec(draft_model=CFG, k=spec_k)
        if spec_k else None), device="cpu")
    je.load(params, draft=params if spec_k else None)
    te.load(sd, draft=sd if spec_k else None)
    return je, te


def _drain(eng):
    log = []
    eng.events.subscribe(log.append)
    uids = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    return [done[u] for u in uids], [(e.kind, e.uid, e.step, e.data)
                                     for e in log]


def _same(je, te, keys=("decode_steps", "prefill_tokens")):
    want, got = _drain(je), _drain(te)
    assert all(len(s) == 6 for s in got[0])
    assert got == want
    for key in keys:
        assert te.stats[key] == je.stats[key], key
    assert dict(te.compilations) == dict(je.compilations())
    return got


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("policy", ["chunked", "bucketed"])
def test_greedy_streams_match_reference(ref, path, policy):
    _same(*_engines(ref, path=path, policy=policy))


def test_dense_layout_streams_match_reference(ref):
    """The bucketed scheduler over the dense layout (the reference's
    default): the frontend zeros enter through the B = 1 prefill."""
    je, te = _engines(ref, policy="bucketed", layout="dense")
    assert te.paging is None and te.scheduler == "bucketed"
    _same(je, te)


def test_self_draft_streams_match_reference(ref):
    """k = 2 over the paged pool: the draft's prompt pass takes the same
    prefill lanes; streams, events and the speculation stats equal the
    reference's, and the streams equal speculation off."""
    je, te = _engines(ref, spec_k=2)
    got = _same(je, te, keys=("decode_steps", "spec_steps",
                              "spec_accepted"))
    assert te.stats["spec_accepted"] > 0
    _, off = _engines(ref)
    assert _drain(off)[0] == got[0]


def test_fleet_refuses_the_family_with_the_reference_message(ref):
    mem = MemorySpec(cache_layout="paged", max_len=32, block_size=8)
    msg = ("multi-topology serving covers the dense GQA family; family "
           "'vlm' needs its own engine")
    with pytest.raises(ValueError, match=msg):
        RuntimeSpec(arch=CFG, maxima=maxima_for(CFG, seq_max=32), memory=mem)
    j_cfg, _, _ = ref.build()
    with pytest.raises(ValueError, match=msg):
        ref.engine(ref.spec.RuntimeSpec(
            arch=j_cfg, maxima=ref.spec.maxima_for(j_cfg, seq_max=32),
            memory=ref.spec.MemorySpec(cache_layout="paged", max_len=32,
                                       block_size=8)))
