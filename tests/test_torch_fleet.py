"""The port's multi-topology fleet (``repro_torch.serving.fabric``) and the
paged attention kernels' ``live_kv`` option, against the JAX reference.

The fleet is the reference tests' (tests/test_multi_topology.py): member
A is the reduced qwen1.5-0.5b, member B a smaller "adaptor-bert-shaped"
topology on the same template (3 heads, 1 layer, d_model 48, d_ff 96,
vocab 96), both head_dim 16, in maxima for 64 positions over 8-token pool
blocks.  Weights come from the reference's init and are bridged into the
port (``bridge.from_jax_params``).

* ``pack_member`` gives the reference's table rows leaf for leaf, exactly.
* One ``decode_step`` and one ``mixed_step`` of the two fabrics on the
  same table and the same float32 pool agree within 1e-4 (float32 sums in
  another order; the reference's own fabric tolerance is 5e-2), and write
  the same pool rows.
* The port's fleet engine gives the reference fleet engine's greedy
  streams and lifecycle events, bit for bit: gather, and the kernels
  (their plain versions here; the reference's Pallas kernels in interpret
  mode) over a bf16 pool.  Over an int8 pool both port routes are held
  against the reference's gather engine: its int8-pool Pallas engine is
  known-red (tests/test_kv_quant.py
  test_int8_cache_pallas_kernels_match_gather).
* The mixed fleet gives the streams of one-member fleets.
* Both plain kernels with ``live_kv`` against the reference's Pallas
  kernels in interpret mode, at hd 16 (GQA 2) and 64, bf16 and int8
  pools, one and three key ranges, with NaN planted in the dead groups'
  queries and pool rows: exact zeros there.

The reference is imported inside fixtures, so the ``cuda`` tests also run
where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_fleet.py``.
"""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, maxima_for)
from repro_torch.kernels import chunked_prefill as cp
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import runtime
from repro_torch.models.attention import KVCache
from repro_torch.serving import fabric as fab_mod
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CFG_A = reduced(get_config("qwen1.5-0.5b"))
CFG_B = dataclasses.replace(
    CFG_A, name="adaptor-bert-shaped", num_layers=1, d_model=48,
    num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)
MAXIMA = maxima_for(CFG_A, CFG_B, seq_max=64)
MEM = dict(cache_layout="paged", max_batch=4, max_len=64, block_size=8)
PROMPTS_A = [[1, 2, 3], list(range(1, 12)), [7, 7, 7]]
PROMPTS_B = [[4, 5], list(range(2, 20, 2))]
STEP_TOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """The reference's fleet pieces and both members' weights, its params
    and the same weights bridged into state dicts of the port."""
    import jax

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.models.model import Model as JModel
    from repro.models.attention import KVCache as JKVCache
    from repro.serving import fabric as j_fabric
    from repro.serving.engine import ServingEngine as JServingEngine
    j_a = j_reduced(REGISTRY["qwen1.5-0.5b"])
    j_b = dataclasses.replace(
        j_a, name="adaptor-bert-shaped", num_layers=1, d_model=48,
        num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)
    params = (JModel(j_a).init(jax.random.PRNGKey(0)),
              JModel(j_b).init(jax.random.PRNGKey(1)))
    bridged = tuple(from_jax_params(jax.tree.map(np.asarray, p), c, "cpu")
                    for p, c in zip(params, (CFG_A, CFG_B)))
    return types.SimpleNamespace(
        jax=jax, spec=j_spec, fabric=j_fabric, engine=JServingEngine,
        KVCache=JKVCache,
        cfgs=(j_a, j_b), params=params, bridged=bridged,
        maxima=j_spec.maxima_for(j_a, j_b, seq_max=64))


def _flat(tree, prefix=""):
    """{dotted name: numpy array} of a nested dict (either package's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the fabric against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("member", [0, 1])
def test_pack_member_rows_equal_reference(ref, member):
    j_fab = ref.fabric.DecodeFabric(ref.maxima, 2, ref.cfgs[0])
    t_fab = fab_mod.DecodeFabric(MAXIMA, 2, CFG_A, device="cpu")
    cfg = (CFG_A, CFG_B)[member]
    want = _flat(j_fab.pack_member(ref.cfgs[member], ref.params[member]))
    got = _flat(t_fab.pack_member(cfg, ref.bridged[member]))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_capacity_accounting_matches_reference(ref, kv_dtype):
    """Pool bytes per cached token and the table's resident bytes."""
    j_fab = ref.fabric.DecodeFabric(ref.maxima, 2, ref.cfgs[0],
                                    kv_dtype=kv_dtype)
    t_fab = fab_mod.DecodeFabric(MAXIMA, 2, CFG_A, kv_dtype=kv_dtype,
                                 device="cpu")
    assert t_fab.kv_bytes_per_token() == j_fab.kv_bytes_per_token()
    assert t_fab.table_bytes(t_fab.init_table()) \
        == j_fab.table_bytes(j_fab.init_table())


def _fabrics(ref):
    """Both fabrics at float32 compute with both members in their tables."""
    j_fab = ref.fabric.DecodeFabric(ref.maxima, 2, ref.cfgs[0],
                                    compute_dtype=ref.jax.numpy.float32)
    j_table = j_fab.init_table()
    t_fab = fab_mod.DecodeFabric(MAXIMA, 2, CFG_A,
                                 compute_dtype=torch.float32, device="cpu")
    t_table = t_fab.init_table()
    for m in (0, 1):
        j_table = j_fab.insert_model(
            j_table, j_fab.pack_member(ref.cfgs[m], ref.params[m]), m)
        t_fab.insert_model(t_table, t_fab.pack_member((CFG_A, CFG_B)[m],
                                                      ref.bridged[m]), m)
    return j_fab, j_table, t_fab, t_table


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_fabric_steps_match_reference(ref, impl):
    """One mixed step (slots prefilling, decoding and idle, both members)
    then one decode step, on one float32 pool handed to both fabrics."""
    jnp = ref.jax.numpy
    j_fab, j_table, t_fab, t_table = _fabrics(ref)
    rs = np.random.RandomState(3)
    B, W, bs, nblk = 4, 8, 8, 8
    L, H, hd = MAXIMA.layers_enc_max, MAXIMA.heads_max, MAXIMA.head_dim_max
    pool = [rs.randn(L, B * nblk + 1, bs, H, hd).astype(np.float32)
            for _ in range(2)]
    tables = (rs.permutation(B * nblk) + 1).reshape(B, nblk).astype(np.int32)
    topo = np.asarray([t_fab.topo_row((CFG_A, CFG_B)[b % 2], b % 2)
                       for b in range(B)], np.int32)
    vocab = topo[:, fab_mod.REG_VOCAB]
    toks = (rs.randint(0, 1 << 20, (B, W)) % vocab[:, None]).astype(np.int32)
    start = np.asarray([0, 5, 17, 30], np.int32)
    n_live = np.asarray([8, 3, 1, 0], np.int32)
    index = start + n_live

    t_cache = KVCache(*(torch.from_numpy(p.copy()) for p in pool))
    j_cache = ref.KVCache(jnp.asarray(pool[0]), jnp.asarray(pool[1]), None,
                          None)
    t = torch.from_numpy
    got = t_fab.mixed_step(t_table, t_cache, t(toks), t(start), t(n_live),
                           t(topo), t(tables), paged_attn_impl=impl)
    want, j_cache = j_fab.mixed_step(
        j_table, j_cache, jnp.asarray(toks), jnp.asarray(start),
        jnp.asarray(n_live), jnp.asarray(topo), jnp.asarray(tables),
        paged_attn_impl=impl, interpret=True)
    live = np.arange(W)[None, :] < n_live[:, None]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=STEP_TOL, rtol=STEP_TOL)
    got = t_fab.decode_step(t_table, t_cache, t(toks[:, :1]), t(index),
                            t(topo), t(tables), paged_attn_impl=impl)
    want, j_cache = j_fab.decode_step(
        j_table, j_cache, jnp.asarray(toks[:, :1]), jnp.asarray(index),
        jnp.asarray(topo), jnp.asarray(tables), paged_attn_impl=impl,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=STEP_TOL, rtol=STEP_TOL)
    # dead vocab lanes are unsampleable
    assert float(got[1, :, CFG_B.vocab_size:].max()) < -1e30
    # the same pool rows written (block 0, the null block, takes the dead
    # lanes' writes in an order neither package fixes)
    for t_pool, j_pool in zip(t_cache[:2], j_cache[:2]):
        np.testing.assert_allclose(t_pool.numpy()[:, 1:],
                                   np.asarray(j_pool)[:, 1:],
                                   atol=STEP_TOL, rtol=STEP_TOL)


# ---------------------------------------------------------------------------
# the fleet engine against the reference's
# ---------------------------------------------------------------------------
def _drain(eng, members, only=None):
    """Submit the mixed workload (or one member's side of it), interleaved
    by prompt length, and drain; returns ({(member, prompt): stream},
    events)."""
    ids = {}
    for key, (cfg, params) in members.items():
        if only in (None, key):
            ids[key] = eng.add_model(params, cfg)
    want = [(k, p) for k in ids
            for p in {"a": PROMPTS_A, "b": PROMPTS_B}[k]]
    log = []
    eng.events.subscribe(log.append)
    uids = {}
    for key, p in sorted(want, key=lambda kp: len(kp[1])):
        uids[eng.submit(p, max_new_tokens=6, model=ids[key])] = (key, tuple(p))
    done = eng.run_to_completion()
    assert len(done) == len(want)
    return ({uids[r.uid]: r.generated for r in done},
            [(e.kind, e.uid, e.step, e.data) for e in log])


def _port_engine(impl="gather", kv_dtype="compute", **mem):
    return ServingEngine(RuntimeSpec(
        arch=CFG_A, maxima=MAXIMA,
        execution=ExecutionSpec(paged_attn_impl=impl, compute_dtype="fp32"),
        memory=MemorySpec(**{**MEM, "kv_dtype": kv_dtype, **mem}),
        scheduler=SchedulerSpec(chunk_size=8)), max_models=2, device="cpu")


@pytest.mark.parametrize("ref_impl,impl,kv_dtype", [
    ("gather", "gather", "compute"),
    ("pallas", "pallas", "compute"),
    ("gather", "gather", "int8"),
    ("gather", "pallas", "int8"),   # the reference's int8 Pallas engine is red
])
def test_fleet_streams_match_reference(ref, ref_impl, impl, kv_dtype):
    s = ref.spec
    je = ref.engine(s.RuntimeSpec(
        arch=ref.cfgs[0], maxima=ref.maxima,
        execution=s.ExecutionSpec(paged_attn_impl=ref_impl,
                                  compute_dtype="fp32"),
        memory=s.MemorySpec(**MEM, kv_dtype=kv_dtype),
        scheduler=s.SchedulerSpec(chunk_size=8)), max_models=2)
    want = _drain(je, {"a": (ref.cfgs[0], ref.params[0]),
                       "b": (ref.cfgs[1], ref.params[1])})
    te = _port_engine(impl, kv_dtype)
    got = _drain(te, {"a": (CFG_A, ref.bridged[0]),
                      "b": (CFG_B, ref.bridged[1])})
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert te.stats["decode_steps"] == je.stats["decode_steps"]
    for stream_key, stream in got[0].items():
        vocab = (CFG_A if stream_key[0] == "a" else CFG_B).vocab_size
        assert all(0 <= tok < vocab for tok in stream)


def test_mixed_fleet_equals_single_member_fleets(ref):
    """The headline claim (tests/test_multi_topology.py
    test_mixed_fleet_bit_identical_to_single_topology_engines): two
    members sharing batches stream what each streams alone, through the
    kernels' route."""
    members = {"a": (CFG_A, ref.bridged[0]), "b": (CFG_B, ref.bridged[1])}
    mixed, _ = _drain(_port_engine("pallas"), members)
    solo = {}
    for key in members:
        solo.update(_drain(_port_engine("pallas"), members, only=key)[0])
    assert mixed == solo


def test_fleet_engine_door_checks(ref):
    eng = _port_engine()
    eng.add_model(ref.bridged[0], CFG_A)
    with pytest.raises(ValueError, match="not loaded"):
        eng.submit([1, 2], model=1)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit([CFG_A.vocab_size + 5], model=0)
    with pytest.raises(ValueError, match="frozen at compile"):
        eng.add_model(ref.bridged[0], dataclasses.replace(
            CFG_A, name="ln-model", norm="layernorm"))
    with pytest.raises(ValueError, match="re-synthesis"):
        eng.add_model(ref.bridged[0], dataclasses.replace(
            CFG_A, name="big", d_model=128, d_ff=256))
    eng.add_model(ref.bridged[1], CFG_B)
    with pytest.raises(ValueError, match="model table full"):
        eng.add_model(ref.bridged[1], CFG_B)


REG_CASES = [  # (changes to member B, max_len, sequence=, validate refuses)
    pytest.param({}, 64, None, False, id="fits-exactly"),
    pytest.param({}, 128, 65, True, id="too-long"),
    pytest.param(dict(d_model=128, num_heads=8, num_kv_heads=8, d_ff=256,
                      num_layers=3, vocab_size=512), 64, None, True,
                 id="too-wide"),
    # head_dim is no register: validate passes what violations refuses
    pytest.param(dict(head_dim=32), 64, 64, False, id="head-dim"),
]


@pytest.mark.parametrize("change,max_len,sequence,refused", REG_CASES)
def test_register_checks_match_reference(ref, change, max_len, sequence,
                                         refused):
    """The ceiling checks against the reference's: ``static_registers``
    (also at an explicit ``sequence``), ``violations`` and
    ``fits_within`` of a spec without maxima, ``Maxima.validate`` (the
    same refusal or none), and ``maxima_for`` with ``layers_dec_max``."""
    mem = dict(cache_layout="paged", max_len=max_len, block_size=8)
    t_spec = RuntimeSpec(arch=dataclasses.replace(CFG_B, **change),
                         memory=MemorySpec(**mem))
    j_spec = ref.spec.RuntimeSpec(
        arch=dataclasses.replace(ref.cfgs[1], **change),
        memory=ref.spec.MemorySpec(**mem))
    regs = t_spec.static_registers(sequence)
    assert regs == j_spec.static_registers(sequence)
    assert t_spec.violations(MAXIMA) == j_spec.violations(ref.maxima)
    assert t_spec.fits_within(MAXIMA) == j_spec.fits_within(ref.maxima)
    raised = []
    for maxima in (MAXIMA, ref.maxima):
        try:
            maxima.validate(regs)
            raised.append(None)
        except ValueError as e:
            raised.append(str(e))
    assert raised[0] == raised[1]
    assert (raised[0] is not None) == refused
    assert t_spec.fits_within(MAXIMA) == (not change and max_len == 64)
    assert tuple(maxima_for(CFG_A, t_spec.arch, seq_max=max_len,
                            layers_dec_max=2)) == tuple(
        ref.spec.maxima_for(ref.cfgs[0], j_spec.arch, seq_max=max_len,
                            layers_dec_max=2))


# ---------------------------------------------------------------------------
# live_kv: the plain kernels against the reference's Pallas kernels
# ---------------------------------------------------------------------------
def _live_case(seed, W, h, kv, hd, pool, live):
    """q [B, W, h, hd] (W = 0: decode's [B, h, hd]) over a pool in random
    block order, sequence b at 9 + 11 b positions, NaN in the queries and
    the pool rows (an int8 pool: its scales) of the dead groups of each
    sequence's own blocks."""
    rs = np.random.RandomState(seed)
    B, bs, nblk = len(live), 8, 6
    nb = B * nblk + 1
    if pool == "int8":
        kp, vp = (rs.randint(-127, 128, (nb, bs, kv, hd)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rs.uniform(5e-3, 3e-2, (nb, bs, kv)).astype(np.float32)
                  for _ in range(2))
    else:
        kp, vp = (rs.randn(nb, bs, kv, hd).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    bt = (rs.permutation(nb - 1) + 1).reshape(B, nblk).astype(np.int32)
    pos = np.asarray([9 + 11 * b for b in range(B)], np.int32)
    q = rs.randn(B, max(W, 1), h, hd).astype(np.float32)
    n_rep = h // kv
    for b, n in enumerate(live):
        q[b, :, n * n_rep:] = np.nan
        for a in ((ks, vs) if pool == "int8" else (kp, vp)):
            a[bt[b], :, n:] = np.nan
    return (q if W else q[:, 0]), kp, vp, bt, pos, ks, vs


KV_CASES = [  # (hd, h, kv, live): hd 16 with GQA 2, hd 64 as the fleet's
    (16, 8, 4, [4, 2, 0, 3]),
    (64, 4, 4, [1, 4, 3, 0]),
]


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("hd,h,kv,live", KV_CASES)
@pytest.mark.parametrize("kernel", ["decode", "chunk"])
def test_live_kv_plain_kernels_match_pallas(ref, kernel, hd, h, kv, live,
                                            pool):
    jnp = ref.jax.numpy
    W = 0 if kernel == "decode" else 5
    q, kp, vp, bt, pos, ks, vs = _live_case(hd + W, W, h, kv, hd, pool, live)
    live = np.asarray(live, np.int32)
    v_max = float(np.nanmax(np.abs(vp.astype(np.float32))))
    if pool == "bf16":
        kp, vp = (jnp.asarray(a, jnp.bfloat16) for a in (kp, vp))
    jsc = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    if kernel == "decode":
        from repro.kernels.paged_attention import paged_decode_attention
        want = paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(pos + 1), live_kv=jnp.asarray(live),
            interpret=True, **jsc)
    else:
        from repro.kernels.chunked_prefill import chunked_prefill_attention
        want = chunked_prefill_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(pos), live_kv=jnp.asarray(live),
            interpret=True, **jsc)
    want = np.asarray(want.astype(jnp.float32))
    t = torch.from_numpy
    tq = t(q)
    tk, tv = (t(np.array(a.astype(jnp.float32) if pool == "bf16" else a))
              for a in (kp, vp))
    if pool == "bf16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
    sc = {} if ks is None else dict(k_scale=t(ks), v_scale=t(vs))
    tlive = t(live)
    if kernel == "decode":
        got = pa.paged_decode_attention(tq, tk, tv, t(bt), t(pos + 1),
                                        live_kv=tlive, **sc)
        q4, start = tq[:, None], t(pos)
    else:
        got = cp.chunked_prefill_attention(tq, tk, tv, t(bt), t(pos),
                                           live_kv=tlive, **sc)
        q4, start = tq, t(pos)
    # the kernel's split: three key ranges of partials, the merge, then the
    # dead groups zeroed as the merge writes them
    parts = [cp.chunked_prefill_partial_plain(q4, tk, tv, t(bt), start, lo,
                                              hi, **sc)
             for lo, hi in cp.kv_ranges(bt.shape[1], 3)]
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    split = cp.apply_live_kv(cp.merge_partials_plain(acc, m, l, q4.dtype),
                             tlive, kv)
    split = split[:, 0] if kernel == "decode" else split
    dead = (np.arange(h) // (h // kv))[None, :] >= live[:, None]   # [B, h]
    if kernel == "chunk":
        dead = np.broadcast_to(dead[:, None], q.shape[:3])
    # f32 q over a bf16 pool: a bf16 step of p (2^-8 x max|V|); over an
    # int8 pool the f32 walk, order of sums only
    tol = 2 ** -8 * v_max if pool == "bf16" else 1e-5
    for out in (got, split):
        out = out.numpy()
        assert (out[dead] == 0).all() and not np.signbit(out[dead]).any()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, want, atol=tol, rtol=0)
    assert (want[dead] == 0).all()


def test_live_kv_operands_are_checked():
    q, kp, vp, bt, pos, _, _ = _live_case(0, 3, 8, 4, 16, "f32", [4, 2, 0, 3])
    t = torch.from_numpy
    args = (t(q), t(kp), t(vp), t(bt), t(pos))
    good = torch.tensor([4, 2, 0, 3], dtype=torch.int32)
    assert torch.isfinite(cp.chunked_prefill_attention(
        *args, live_kv=good)).all()
    for bad in (good.long(), good[:3], torch.tensor([5, 0, 0, 0],
                                                    dtype=torch.int32),
                torch.tensor([-1, 0, 0, 0], dtype=torch.int32),
                torch.empty(4, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="live_kv"):
            cp.chunked_prefill_attention(*args, live_kv=bad)
        with pytest.raises(ValueError, match="live_kv"):
            pa.paged_decode_attention(args[0][:, 0].contiguous(), *args[1:4],
                                      args[4] + 1, live_kv=bad)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_live_kv_matches_plain_version():
    """Both kernels with ``live_kv`` at hd 16 (GQA 2) and 64, bf16 q over
    bf16 and int8 pools, at the planned key ranges and at 1 and 3 fixed
    ones: dead groups bit-exact zeros though they hold NaN, the live ones
    within the card's gates (chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    for kernel in ("decode", "chunk"):
        fn = pa.paged_decode_attention if kernel == "decode" \
            else cp.chunked_prefill_attention
        for hd, h, kv, live in KV_CASES:
            for pool in ("bf16", "int8"):
                W = 0 if kernel == "decode" else 5
                q, kp, vp, bt, pos, ks, vs = _live_case(
                    hd, W, h, kv, hd, "int8" if pool == "int8" else "f32",
                    live)
                t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
                tq = t(q).bfloat16()
                tk, tv = t(kp), t(vp)
                if pool == "bf16":
                    tk, tv = tk.bfloat16(), tv.bfloat16()
                sc = {} if ks is None else dict(k_scale=t(ks), v_scale=t(vs))
                lens = t(pos + 1) if kernel == "decode" else t(pos)
                tlive = torch.tensor(live, dtype=torch.int32, device=dev)
                want = (pa.paged_decode_attention_plain if kernel == "decode"
                        else cp.chunked_prefill_attention_plain)(
                    tq, tk, tv, t(bt), lens, live_kv=tlive, **sc)
                dead = cp.apply_live_kv(torch.ones_like(want), tlive, kv) == 0
                for splits in (None, 1, 3):
                    n = fn.live_kv_launches
                    with mock.patch.object(
                            cp, "kv_splits", (lambda *a, s=splits: s)
                            if splits else cp.kv_splits):
                        got = fn(tq, tk, tv, t(bt), lens, live_kv=tlive,
                                 **sc)
                    assert fn.live_kv_launches == n + 1
                    assert torch.equal(got[dead],
                                       torch.zeros_like(got[dead]))
                    assert not torch.signbit(got[dead]).any()
                    d = (got.float() - want.float()).abs() \
                        / (2 ** -7 * want.float().abs().clamp_min(1))
                    assert float(d.max()) <= 1.0, (kernel, hd, pool, splits)


@pytest.mark.cuda
def test_cuda_fleet_engine_serves():
    """The reduced fleet on the card through the paged kernels: every
    request finishes inside its member's vocab, and every step launched
    the attention kernels with ``live_kv`` once a layer (the engine's
    graphs: a wrapper counts its launch at capture, and each replay
    launches what its graph's capture recorded)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.models.model import Model
    eng = ServingEngine(RuntimeSpec(
        arch=CFG_A, maxima=MAXIMA,
        execution=ExecutionSpec(paged_attn_impl="pallas"),
        memory=MemorySpec(**MEM), scheduler=SchedulerSpec(chunk_size=8)),
        max_models=2)
    gen = torch.Generator(device="cuda")
    ids = [eng.add_model(Model(c, device="cuda").init(
        gen.manual_seed(i)).state_dict(), c)
        for i, c in enumerate((CFG_A, CFG_B))]
    counts = (pa.paged_decode_attention.live_kv_launches,
              cp.chunked_prefill_attention.live_kv_launches)
    uids = {eng.submit(p, max_new_tokens=6, model=ids[m]): m
            for m, ps in enumerate((PROMPTS_A, PROMPTS_B)) for p in ps}
    done = eng.run_to_completion()
    assert len(done) == len(uids)
    for r in done:
        vocab = (CFG_A, CFG_B)[uids[r.uid]].vocab_size
        assert len(r.generated) == 6 and all(0 <= t < vocab
                                             for t in r.generated)
    keys = [f"{n}.live_kv" for n in ("paged_decode_attention",
                                     "chunked_prefill_attention")]
    launched = (pa.paged_decode_attention.live_kv_launches - counts[0]
                + cp.chunked_prefill_attention.live_kv_launches - counts[1]
                - sum(eng.captured_launches[k] for k in keys)
                + sum(eng.replayed_launches[k] for k in keys))
    assert launched == MAXIMA.layers_enc_max * eng.stats["decode_steps"]
