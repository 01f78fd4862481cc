"""The rest of the dense family in the port: qwen2-72b, codeqwen1.5-7b and
phi3-mini-3.8b, whose embeddings are untied (an ``lm_head`` table of
their own), against the JAX reference at its ``reduced_cfg``.

Weights come from the reference's ``Model(cfg).init(PRNGKey)`` and go
through numpy and ``repro_torch.bridge``.  For each config:

* the port's config equals the reference's field for field;
* the bridge maps ``params["lm_head"]["table"]`` to ``lm_head.table``,
  exactly, and the port's state dict names are the reference's leaves;
* one mixed step then one decode step at float32 compute over a float32
  pool: logits within 1e-4 * max|logits| (float32 sums in another order
  and transcendental rounding only; the tolerance of
  tests/test_torch_model.py), through the gather path and through the
  kernels (their plain versions here, the reference's Pallas kernels in
  interpret mode);
* the greedy streams of a short engine drain at float32 compute are the
  reference engine's, token for token (gather, and the kernels' plain
  versions against the Pallas kernels in interpret mode);
* an untied fleet member's packed table row equals
  ``repro.serving.fabric``'s leaf for leaf, exactly: its ``lm_head`` row
  is the member's own table;
* under int8 weights the ``lm_head`` table is quantized as the
  reference's ``serve_quant`` quantizes it (per-row scales), exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_cfg
from repro.configs import REGISTRY
from repro.core import serve_quant as j_serve_quant
from repro.core import spec as j_spec
from repro.core.paging import PagingConfig as JPagingConfig
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions
from repro.serving import fabric as j_fabric
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PagingConfig
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, maxima_for)
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.serving import fabric as fab_mod
from repro_torch.serving.engine import ServingEngine

ARCHS = ["qwen2-72b", "codeqwen1.5-7b", "phi3-mini-3.8b"]
STEP_TOL = 1e-4                      # x max|logits|, f32 compute and pool
BS, NBLK, NUM_BLOCKS = 8, 4, 12
TABLES = np.array([[3, 1, 7, 0], [2, 9, 4, 11], [5, 0, 0, 0]], np.int32)
N_LIVE = np.array([8, 8, 5], np.int32)
PROMPTS = [[1, 2, 3], list(range(1, 12)), list(range(2, 30, 3))]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(reference config, port config, reference params, bridged state
    dict) of one untied architecture at the reduced size."""
    j_cfg = reduced_cfg(request.param)
    cfg = reduced(get_config(request.param))
    params = JModel(j_cfg).init(jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, params)
    return j_cfg, cfg, params, from_jax_params(np_params, cfg, "cpu")


def test_port_config_matches_reference(family):
    j_cfg, cfg, _, _ = family
    assert not cfg.tie_embeddings
    full = get_config(cfg.name)
    assert dataclasses.asdict(full) == {
        k: v for k, v in dataclasses.asdict(REGISTRY[cfg.name]).items()
        if k in dataclasses.asdict(full)}
    for field in dataclasses.asdict(cfg):
        if hasattr(j_cfg, field):
            assert getattr(cfg, field) == getattr(j_cfg, field), field


def test_bridge_maps_the_untied_lm_head(family):
    _, cfg, params, sd = family
    np.testing.assert_array_equal(sd["lm_head.table"].numpy(),
                                  np.asarray(params["lm_head"]["table"]))
    assert not torch.equal(sd["lm_head.table"], sd["embed.table"])
    tm = Model(cfg, compute_dtype=torch.float32, device="cpu")
    assert set(tm.state_dict()) == set(sd)
    tm.load_state_dict(sd)
    assert torch.equal(tm.lm_head.table, sd["lm_head.table"])


@pytest.mark.parametrize("mm,impl", [("xla", "gather"), ("pallas", "pallas")])
def test_steps_match_reference(family, mm, impl):
    """mixed_step (a chunk with partial slots) then decode_step, float32
    compute over a float32 pool, both packages on the same weights."""
    j_cfg, cfg, params, sd = family
    jm = JModel(j_cfg, ModelOptions(compute_dtype=jnp.float32,
                                    matmul_backend=mm, paged_attn_impl=impl))
    tm = Model(cfg, compute_dtype=torch.float32, matmul_backend=mm,
               paged_attn_impl=impl, device="cpu")
    tm.load_state_dict(sd)
    rs = np.random.RandomState(0)
    W = 8
    toks = rs.randint(0, cfg.vocab_size, (3, W)).astype(np.int32)
    start = np.zeros(3, np.int32)
    jc = jm.init_cache(3, NBLK * BS, paging=JPagingConfig(BS, NUM_BLOCKS))
    jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
    tc = tm.init_cache(PagingConfig(BS, NUM_BLOCKS))
    tc = KVCache(tc.k.float(), tc.v.float())
    jl, jc = jm.mixed_step(params, jc, jnp.asarray(toks), jnp.asarray(start),
                           jnp.asarray(N_LIVE),
                           block_tables=jnp.asarray(TABLES))
    tl = tm.mixed_step(tc, torch.from_numpy(toks), torch.from_numpy(start),
                       torch.from_numpy(N_LIVE), torch.from_numpy(TABLES))
    live = np.arange(W)[None, :] < N_LIVE[:, None]
    dtoks = rs.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jd, _ = jm.decode_step(params, jc, jnp.asarray(dtoks),
                           jnp.asarray(N_LIVE),
                           block_tables=jnp.asarray(TABLES))
    td = tm.decode_step(tc, torch.from_numpy(dtoks), torch.from_numpy(N_LIVE),
                        torch.from_numpy(TABLES))
    for ref, got in ((np.asarray(jl)[live], tl.numpy()[live]),
                     (np.asarray(jd), td.numpy())):
        assert np.isfinite(got).all()
        err, scale = np.abs(ref - got).max(), np.abs(ref).max()
        assert err <= STEP_TOL * scale, f"{err} > {STEP_TOL} x {scale}"


@pytest.mark.parametrize("mm,impl", [("xla", "gather"), ("pallas", "pallas")])
def test_greedy_streams_match_reference(family, mm, impl):
    j_cfg, cfg, params, sd = family
    mem = dict(cache_layout="paged", max_batch=3, max_len=32, block_size=8)
    je = JServingEngine(j_spec.RuntimeSpec(
        arch=j_cfg,
        execution=j_spec.ExecutionSpec(matmul_backend=mm,
                                       paged_attn_impl=impl,
                                       compute_dtype="fp32"),
        memory=j_spec.MemorySpec(**mem),
        scheduler=j_spec.SchedulerSpec(chunk_size=8)))
    je.load(params)
    te = ServingEngine(RuntimeSpec(
        arch=cfg,
        execution=ExecutionSpec(matmul_backend=mm, paged_attn_impl=impl,
                                compute_dtype="fp32"),
        memory=MemorySpec(**mem),
        scheduler=SchedulerSpec(chunk_size=8)), device="cpu")
    te.load(sd)
    streams = []
    for eng in (je, te):
        uids = {eng.submit(p, max_new_tokens=5): i
                for i, p in enumerate(PROMPTS)}
        done = eng.run_to_completion()
        streams.append({uids[r.uid]: r.generated for r in done})
    assert len(streams[1]) == len(PROMPTS)
    assert streams[1] == streams[0]
    assert te.stats["decode_steps"] == je.stats["decode_steps"]


def test_untied_fleet_member_row_matches_reference(family):
    j_cfg, cfg, params, sd = family
    j_fab = j_fabric.DecodeFabric(j_spec.maxima_for(j_cfg, seq_max=64), 1,
                                  j_cfg)
    t_fab = fab_mod.DecodeFabric(maxima_for(cfg, seq_max=64), 1, cfg,
                                 device="cpu")
    want = _flat(j_fab.pack_member(j_cfg, params))
    got = _flat(t_fab.pack_member(cfg, sd))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(got["lm_head"][:cfg.vocab_size],
                                  np.asarray(params["lm_head"]["table"]))


def test_int8_lm_head_matches_reference_serve_quant(family):
    """``lm_head.table`` under ``quant="int8"`` (floor 1, so the reduced
    table is eligible): the reference's per-row int8 values and scales."""
    _, cfg, params, sd = family
    tm = Model(cfg, quant="int8", quant_min_size=1, device="cpu")
    tm.load_state_dict(sd)
    q = j_serve_quant.quantize_params(params, 1)["lm_head"]["table"]
    assert tm.lm_head.table.dtype == torch.int8
    np.testing.assert_array_equal(tm.lm_head.table.numpy(),
                                  np.asarray(q.values))
    np.testing.assert_array_equal(tm.lm_head.table_scale.numpy(),
                                  np.asarray(q.scale))


def test_init_draws_lm_head_at_reference_scale():
    """The reference builds ``lm_head`` with no scale, so ``ParamBuilder``
    draws it normal / sqrt(fan_in) with fan_in = the table's first dim
    (the vocab); the embedding stays at 0.02."""
    cfg = dataclasses.replace(reduced(get_config("phi3-mini-3.8b")),
                              vocab_size=4096)
    sd = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    j_p = JModel(dataclasses.replace(reduced_cfg("phi3-mini-3.8b"),
                                     vocab_size=4096)).init(
        jax.random.PRNGKey(0))
    for std in (float(sd["lm_head.table"].std()),
                float(np.asarray(j_p["lm_head"]["table"]).std())):
        assert abs(std * 4096 ** 0.5 - 1) < 0.02
    assert abs(float(sd["embed.table"].std()) - 0.02) < 1e-3
