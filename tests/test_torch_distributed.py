"""Distributed training of the port against the JAX reference, on the CPU.

Every rank is a device of ``["cpu"] * n``; the reference runs in-process
on the conftest's 8 host devices (its collectives and pipeline under
``shard_map``).  The reference's own bounds:

* ``ring_reduce_scatter`` bit for bit against the reference's on
  ``PRNGKey(0)``'s [8, 64] and a padded [8, 61]; ``ring_allreduce``,
  ``psum_scatter``, ``all_gather`` against the sum (1e-5);
* ``compressed_allreduce`` against the reference's on ``PRNGKey(3)``'s
  [8, 1000]: outputs and residuals within one quantization step, and the
  reference test's error-feedback decay over 30 rounds (a round under
  0.2, the 30-round time average under a third of it);
* ``wire_bytes``, ``init_ef_tree`` and ``bubble_fraction`` equal the
  reference's;
* the GPipe pipeline at S 8, D 16, 16 microbatches of 4: forward within
  1e-5 of the reference's ``make_pipelined_apply``, gradient within 1e-3
  of ``jax.grad`` of the sequential apply and of the reference's
  pipelined gradient (under ``jax.set_mesh`` + ``jax.jit``);
* the sharded step against the reference's single-device jitted step
  (the reference's sharded step raises at its embedding gather under this
  JAX, so it cannot be the oracle), on its test's inputs (reduced
  qwen1.5-0.5b, ``init_state(PRNGKey(0))`` through
  ``bridge.from_jax_train_state``, B 8 x S 9 tokens from ``PRNGKey(1)``,
  lr 1e-3, warmup 1), after one step: loss within 1e-3 and params within
  5e-3 on (data 4, model 2), (data 8, model 1), (data 1, model 2) and
  (data 4, model 2) under fsdp.

Port against port, at f32 compute, against the single-device step
(``F32_*``: the loss within 1e-5 relative, the assembled gradient within
1e-5 x max|g|, the params after two steps within 1e-4 = a tenth of lr;
at this size the largest gaps are 1e-6 x max|g| and 2e-5): the meshes
above and (2, 2); (1, 1) bit for bit at bf16; a scan family (reduced
falcon-mamba-7b) and the MoE family (reduced granite-moe-1b-a400m,
lossless capacity, its balance term in the loss) at (data 2, model 1);
``accum_steps=2`` on (2, 2); ``TPModel.loss`` against ``Model.loss``;
``donate=False`` leaves its input intact;
tp > 1 on a non-dense family and remat under tp name item 16e.
Checkpoints: saved at (2, 2), restored at (4, 1) and on one device, the
next step equals the uninterrupted run's.  A ``cuda``-marked case runs
(2, 1) on two distinct cards against the one card (skips below two).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression as comp
from repro_torch.distributed import pipeline as pp
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                             loss_and_grads, make_step_fn,
                                             make_train_step)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
REF_MESHES = {"data4-model2": ((4, 2), False), "data8-model1": ((8, 1), False),
              "data1-model2": ((1, 2), False),
              "data4-model2-fsdp": ((4, 2), True)}
F32_LOSS, F32_GRAD, F32_PARAMS = 1e-5, 1e-5, 1e-4
PP = dict(S=8, D=16, NM=16, MB=4)


def _mesh(data: int, model: int, devices=None) -> Mesh:
    devices = devices or ("cpu",) * (data * model)
    return Mesh((("data", data), ("model", model)), tuple(devices))


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _ranks(x: np.ndarray) -> list[torch.Tensor]:
    return [torch.from_numpy(np.array(row)) for row in x]


# ---------------------------------------------------------------------------
# The reference's collectives, compression and pipeline (8 host devices)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.distributed import collectives as jc
    from repro.distributed import compression as jcomp
    from repro.distributed import pipeline as jpp

    m8 = jax.make_mesh((8,), ("d",))
    out = types.SimpleNamespace(rs={})
    for n in (64, 61):
        x = jax.random.normal(jax.random.PRNGKey(0), (8, n))
        f = jax.jit(shard_map(
            lambda xs: jc.ring_reduce_scatter(xs[0], "d")[None], mesh=m8,
            in_specs=(P("d", None),), out_specs=P("d", None)))
        out.rs[n] = (_np(x), _np(f(x)))
    gs = jax.random.normal(jax.random.PRNGKey(3), (8, 1000))
    shard = (1000 + (-1000) % 8) // 8

    def one_round(g, resid):
        def body(gg, rr):
            o, s = jcomp.compressed_allreduce(
                gg[0], jcomp.EFState(rr[0]), "d")
            return o[None], s.residual[None]
        return jax.jit(shard_map(
            body, mesh=m8, in_specs=(P("d", None),) * 2,
            out_specs=(P("d", None),) * 2, check_rep=False))(g, resid)

    o, r = one_round(gs, jnp.zeros((8, shard)))
    out.comp = (_np(gs), _np(o), _np(r))
    out.jcomp, out.jpp = jcomp, jpp
    # the pipeline: forward, and the gradient of sum(out^2) through the
    # pipelined apply (under set_mesh + jit) and the sequential one
    S, D, NM, MB = PP["S"], PP["D"], PP["NM"], PP["MB"]
    ws = jax.random.normal(jax.random.PRNGKey(0), (S, D, D)) / jnp.sqrt(D)
    bs = jax.random.normal(jax.random.PRNGKey(1), (S, D)) * 0.1
    x = jax.random.normal(jax.random.PRNGKey(2), (NM, MB, D))
    mesh_pp = jax.make_mesh((S,), ("stage",))
    apply = jpp.make_pipelined_apply(lambda p, h: jnp.tanh(h @ p[0] + p[1]),
                                     mesh_pp, axis_name="stage")

    def seq(p, h):
        for i in range(S):
            h = jnp.tanh(h @ p[0][i] + p[1][i])
        return h

    with jax.set_mesh(mesh_pp):
        pipe_grad = jax.jit(jax.grad(
            lambda p: jnp.sum(apply(p, x) ** 2)))((ws, bs))
    out.pp = dict(
        ws=_np(ws), bs=_np(bs), x=_np(x),
        fwd=_np(jax.jit(apply)((ws, bs), x)),
        seq_grad=[_np(g) for g in jax.jit(jax.grad(
            lambda p: jnp.sum(seq(p, x) ** 2)))((ws, bs))],
        pipe_grad=[_np(g) for g in pipe_grad])
    return out


@pytest.mark.parametrize("n", [64, 61])
def test_ring_reduce_scatter_bit_for_bit(ref, n):
    x, want = ref.rs[n]
    got = coll.ring_reduce_scatter(_ranks(x))
    assert np.array_equal(torch.stack(got).numpy(), want)
    flat = np.pad(x.sum(0), (0, (-n) % 8)).reshape(8, -1)
    assert np.abs(torch.stack(got).numpy() - flat).max() < 1e-5


@pytest.mark.parametrize("n", [64, 61])
def test_allreduce_scatter_gather_against_the_sum(n):
    x = np.random.RandomState(n).randn(8, n).astype(np.float32)
    xs = _ranks(x)
    for got in coll.ring_allreduce(xs):
        assert np.abs(got.numpy() - x.sum(0)).max() < 1e-5
    rows = _ranks(np.random.RandomState(1).randn(8, 16, 3).astype(np.float32))
    want = np.stack([r.numpy() for r in rows]).sum(0)
    for i, got in enumerate(coll.psum_scatter(rows)):
        assert np.abs(got.numpy() - want[2 * i:2 * i + 2]).max() < 1e-5
    for got in coll.all_gather(rows):
        assert torch.equal(got, torch.cat(rows))
    # every rank's all-reduce holds the same bytes
    outs = coll.ring_allreduce(xs)
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_ppermute_moves_and_zero_fills():
    xs = [torch.full((2,), float(i)) for i in range(4)]
    got = coll.ppermute(xs, coll._ring_perm(4))
    assert [float(t[0]) for t in got] == [3.0, 0.0, 1.0, 2.0]
    got = coll.ppermute(xs, [(0, 2)])
    assert [float(t[0]) for t in got] == [0.0, 0.0, 0.0, 0.0]
    assert got[2] is not xs[0]
    assert coll.axis_size(xs) == 4


def test_compressed_allreduce_matches_reference(ref):
    gs, want_out, want_res = ref.comp
    shard = want_res.shape[1]
    out, res = comp.compressed_allreduce(
        _ranks(gs), [comp.init_ef_state((shard,)) for _ in range(8)])
    out = torch.stack(out).numpy()
    res = torch.stack([e.residual for e in res]).numpy()
    # one quantization step: each shard's scale, amax / 127
    owned = gs.mean(0).reshape(8, -1)
    step = np.abs(owned).max(1) / 127.0
    assert (np.abs(out[0].reshape(8, -1) - want_out[0].reshape(8, -1))
            <= step[:, None] * (1 + 1e-6)).all()
    assert (np.abs(res - want_res) <= step[:, None] * (1 + 1e-6)).all()
    assert all(np.array_equal(o, out[0]) for o in out)
    assert np.abs(out[0] - gs.mean(0)).max() < 0.01


def test_error_feedback_keeps_time_average_unbiased(ref):
    """The reference test's assertions on the port over 30 rounds."""
    gs = ref.comp[0]
    want = gs.mean(0)
    efs = [comp.init_ef_state((125,)) for _ in range(8)]
    acc, errs = np.zeros(1000), []
    for _ in range(30):
        out, efs = comp.compressed_allreduce(_ranks(gs), efs)
        acc = acc + (out[0].numpy() - want)
        errs.append(np.linalg.norm(acc) / (np.linalg.norm(want) + 1e-9))
    assert errs[0] < 0.2
    assert errs[-1] / 30.0 < errs[0] / 3


def test_tree_helpers_equal_reference(ref):
    jcomp, jpp = ref.jcomp, ref.jpp
    for n, d in ((10_000_000, 256), (1000, 8), (7, 3)):
        for c in (True, False):
            assert comp.wire_bytes(n, d, c) == jcomp.wire_bytes(n, d, c)
    for s, m in ((4, 12), (1, 8), (8, 16)):
        assert pp.bubble_fraction(s, m) == jpp.bubble_fraction(s, m)
    import jax
    shapes = {"a": (1000,), "b": (7, 3), "c": ()}
    want = jcomp.init_ef_tree(
        {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in shapes.items()},
        8)
    got = comp.init_ef_tree({k: torch.empty(v) for k, v in shapes.items()},
                            8)
    assert {k: tuple(v.residual.shape) for k, v in got.items()} == \
        {k: tuple(v.residual.shape) for k, v in want.items()}
    grads = [{"a": torch.full((10,), float(r))} for r in range(4)]
    outs, states = comp.compressed_allreduce_tree(
        grads, [comp.init_ef_tree({"a": grads[0]["a"]}, 4)
                for _ in range(4)])
    assert torch.allclose(outs[3]["a"], torch.full((10,), 1.5), atol=0.02)
    assert states[0]["a"].residual.shape == (3,)


def _pp_inputs(ref):
    p = ref.pp
    ws = torch.from_numpy(p["ws"]).requires_grad_(True)
    bs = torch.from_numpy(p["bs"]).requires_grad_(True)
    apply = pp.make_pipelined_apply(
        lambda prm, h: torch.tanh(h @ prm[0] + prm[1]),
        Mesh((("stage", PP["S"]),), ("cpu",) * PP["S"]))
    return ws, bs, apply((ws, bs), torch.from_numpy(p["x"]))


def test_pipeline_forward_matches_reference(ref):
    _, _, out = _pp_inputs(ref)
    assert np.abs(out.detach().numpy() - ref.pp["fwd"]).max() < 1e-5


def test_pipeline_gradient_matches_reference(ref):
    ws, bs, out = _pp_inputs(ref)
    got = torch.autograd.grad((out ** 2).sum(), (ws, bs))
    for want in (ref.pp["seq_grad"], ref.pp["pipe_grad"]):
        assert max(np.abs(g.numpy() - w).max()
                   for g, w in zip(got, want)) < 1e-3


def test_pipeline_refuses_a_second_axis():
    with pytest.raises(ValueError, match="one axis 'stage'"):
        pp.make_pipelined_apply(lambda p, h: h, _mesh(2, 2))


# ---------------------------------------------------------------------------
# The sharded step against the reference's single-device step
# ---------------------------------------------------------------------------
NAME = "qwen1.5-0.5b"
CFG = reduced(get_config(NAME))


@pytest.fixture(scope="module")
def ref_step():
    """The reference test's inputs and its single-device jitted step."""
    import jax
    from repro.models.model import Model as JModel
    from repro.training import optimizer as jopt
    from repro.training import train_step as jts
    from conftest import reduced_cfg

    jm = JModel(reduced_cfg(NAME))
    oc = jopt.AdamWConfig(**OPT)
    s0 = jts.init_state(jm, jax.random.PRNGKey(0), oc)
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 9), 0,
                              CFG.vocab_size)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    s1, m1 = jax.jit(jts.make_step_fn(jm, jts.TrainStepConfig(
        optimizer=oc)))(s0, batch)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return types.SimpleNamespace(
        s0=np_tree(s0), s1=np_tree(s1), loss=float(m1["loss"]),
        batch={k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def _state(np_state, device="cpu"):
    from repro_torch.bridge import from_jax_train_state
    return from_jax_train_state(np_state, CFG, device)


def _sharded(model, mesh, fsdp=False, **kw):
    return make_train_step(model, TrainStepConfig(
        optimizer=AdamWConfig(**OPT), **kw), mesh=mesh,
        strategy=sharding.strategy_for_mesh(mesh, fsdp=fsdp))


@pytest.mark.parametrize("mesh_id", list(REF_MESHES))
def test_sharded_step_matches_reference(ref_step, mesh_id):
    (data, model_n), fsdp = REF_MESHES[mesh_id]
    model = Model(CFG, device="cpu", trainable=True)
    step, st_sh, b_sh = _sharded(model, _mesh(data, model_n), fsdp)
    state = sharding.place(_state(ref_step.s0), st_sh)
    new, metrics = step(state, ref_step.batch)
    assert abs(float(metrics["loss"]) - ref_step.loss) < 1e-3
    want = _state(ref_step.s1).params
    got = sharding.assemble(new.params)
    assert max(float((got[n] - w).abs().max()) for n, w in want.items()) \
        < 5e-3
    if fsdp:    # the embed dimension and the moments split over data
        assert new.params["layers.0.attn.wq.kernel"].spec == ("data",
                                                              "model")
        assert new.opt.m["final_norm.scale"].shards[0].shape == (16,)


def test_one_by_one_mesh_is_the_single_step_bit_for_bit(ref_step):
    model = Model(CFG, device="cpu", trainable=True)
    single = make_step_fn(model, TrainStepConfig(
        optimizer=AdamWConfig(**OPT), donate=False))
    want, wm = single(_state(ref_step.s0), ref_step.batch)
    step, st_sh, _ = _sharded(model, _mesh(1, 1), donate=False)
    got, gm = step(sharding.place(_state(ref_step.s0), st_sh),
                   ref_step.batch)
    assert gm.keys() == wm.keys()
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    flat = ckpt._leaves(sharding.assemble(got))
    for k, w in ckpt._leaves(want).items():
        assert torch.equal(flat[k].detach(), w.detach()), k


# ---------------------------------------------------------------------------
# Port against port at f32
# ---------------------------------------------------------------------------
def _f32_setup(cfg, seed=0, b=8, s=8):
    model = Model(cfg, device="cpu", trainable=True,
                  compute_dtype=torch.float32)
    state = init_state(model, torch.Generator().manual_seed(seed),
                       AdamWConfig(**OPT))
    toks = torch.from_numpy(np.random.RandomState(seed + 1).randint(
        0, cfg.vocab_size, (b, s + 1)))
    return model, state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _copy(state):
    from repro_torch.training.train_step import _copy as copy
    return copy(state)


def _against_single(cfg, data, model_n, fsdp=False, accum=1, seed=0):
    """The sharded step against the single-device one at f32: loss and
    aux, the assembled gradient, the params after two steps."""
    model, s0, batch = _f32_setup(cfg, seed)
    single = make_step_fn(model, TrainStepConfig(
        optimizer=AdamWConfig(**OPT), accum_steps=accum, donate=False))
    step, st_sh, _ = _sharded(model, _mesh(data, model_n), fsdp,
                              accum_steps=accum)
    state = sharding.place(_copy(s0), st_sh)
    if accum == 1:
        wl, waux, wg = loss_and_grads(model, s0.params, batch)
        gl, gaux, gg = step.loss_and_grads(state, batch)
        assert waux.keys() == gaux.keys()
        for k in waux:
            assert abs(float(gaux[k]) - float(waux[k])) \
                <= F32_LOSS * abs(float(waux[k])), k
        gg = sharding.assemble(gg)
        scale = max(float(g.abs().max()) for g in wg.values())
        for n, g in wg.items():
            assert float((gg[n] - g).abs().max()) <= F32_GRAD * scale, n
    want, got = s0, state
    for _ in range(2):
        want, wm = single(want, batch)
        got, gm = step(got, batch)
        assert abs(float(gm["loss"]) - float(wm["loss"])) \
            <= F32_LOSS * abs(float(wm["loss"]))
    got = sharding.assemble(got.params)
    for n, w in want.params.items():
        assert float((got[n] - w).abs().max()) <= F32_PARAMS, n


@pytest.mark.parametrize("data,model_n,fsdp", [
    (2, 2, False), (4, 2, False), (8, 1, False), (1, 2, False),
    (4, 2, True)])
def test_sharded_step_matches_single_f32(data, model_n, fsdp):
    _against_single(CFG, data, model_n, fsdp)


def test_scan_family_data_parallel_matches_single():
    _against_single(reduced(get_config("falcon-mamba-7b")), 2, 1)


def test_moe_family_data_parallel_keeps_the_balance_term():
    """The balance term E x sum f p averages the replicas' f and p before
    the product: the loss, its load_balance aux and the gradients are
    the one device's (lossless capacity, so no replica drops a token
    the whole batch would keep)."""
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    _against_single(cfg, 2, 1)


def test_accum_steps_under_a_mesh():
    _against_single(CFG, 2, 2, accum=2)


def test_donate_false_leaves_the_input_intact():
    model, s0, batch = _f32_setup(CFG)
    step, st_sh, _ = _sharded(model, _mesh(2, 2), donate=False)
    state = sharding.place(s0, st_sh)
    before = {k: t.clone() for k, t in ckpt._leaves(
        sharding.assemble(state)).items()}
    new, _ = step(state, batch)
    after = ckpt._leaves(sharding.assemble(state))
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert int(sharding.assemble(new.opt.step)) == 1
    # donate=True updates the shards in place
    step, _, _ = _sharded(model, _mesh(2, 2))
    shard = state.params["embed.table"].shards[3]
    ref = shard.detach().clone()
    out, _ = step(state, batch)
    assert out.params["embed.table"].shards[3] is shard
    assert not torch.equal(shard.detach(), ref)


def test_tp_model_loss_is_the_model_loss():
    """``TPModel.loss`` over two ranks bound to their shards: the loss,
    its aux terms and the gradient of a split and of a whole leaf."""
    from repro_torch.models.tensor_parallel import TPModel
    from repro_torch.training.train_step import bound
    model, s0, batch = _f32_setup(CFG)
    want, waux = model.loss(batch)
    tpm = TPModel(CFG, ["cpu", "cpu"], compute_dtype=torch.float32,
                  trainable=True)
    shards = [{n: sharding.local_shard(t, tpm.specs[n], tpm.mesh, r)
               .detach().clone().requires_grad_(True)
               for n, t in s0.params.items()} for r in range(2)]
    with bound(tpm.ranks[0], shards[0]), bound(tpm.ranks[1], shards[1]):
        got, gaux = tpm.loss(batch)
    assert gaux.keys() == waux.keys()
    assert abs(float(got) - float(want)) <= F32_LOSS * float(want)
    wq, norm = "layers.0.attn.wq.kernel", "final_norm.scale"
    gw = torch.autograd.grad(want, [s0.params[wq], s0.params[norm]])
    gt = torch.autograd.grad(got, [shards[0][wq], shards[1][wq],
                                   shards[0][norm]], allow_unused=True)
    scale = float(gw[0].abs().max())
    assert float((torch.cat(gt[:2], 1) - gw[0]).abs().max()) \
        <= F32_GRAD * scale
    assert float((gt[2] - gw[1]).abs().max()) \
        <= F32_GRAD * float(gw[1].abs().max())


def test_refusals_name_their_items():
    moe = reduced(get_config("granite-moe-1b-a400m"))
    with pytest.raises(ValueError, match="Queue 1 item 16e"):
        _sharded(Model(moe, device="cpu", trainable=True), _mesh(1, 2))
    with pytest.raises(ValueError, match="item 16e"):
        _sharded(Model(CFG, device="cpu", trainable=True, remat="full"),
                 _mesh(2, 2))
    model, s0, batch = _f32_setup(CFG)
    step, _, _ = _sharded(model, _mesh(2, 1))
    with pytest.raises(TypeError, match="sharding.place"):
        step(s0, batch)


def test_place_assemble_and_shardings():
    mesh = _mesh(4, 2)
    model = Model(CFG, device="cpu", trainable=True)
    strat = sharding.strategy_for_mesh(mesh, fsdp=True)
    sh = sharding.tree_param_shardings(
        mesh, model.axes(), dict(model.named_parameters()), strat,
        head_dim=CFG.resolved_head_dim)
    assert sh["embed.table"].spec == ("model", "data")
    assert sh["layers.0.ffn.w2.kernel"].spec == ("model", "data")
    assert sh["final_norm.scale"].spec == ("data",)
    t = torch.arange(128 * 64.0).reshape(128, 64)
    x = sharding.place_leaf(t, sh["embed.table"])
    assert x.shards[3].shape == (64, 16)
    assert torch.equal(x.shards[3], t[64:, 16:32])
    assert torch.equal(sharding.assemble_leaf(x), t)
    assert sharding.owners(mesh, ("model",)) == [0, 1]
    assert sharding.axis_groups(mesh, "data") == [[0, 2, 4, 6],
                                                  [1, 3, 5, 7]]
    assert sharding.axis_groups(mesh, "model") == [[0, 1], [2, 3], [4, 5],
                                                   [6, 7]]
    dev = make_dev_mesh(device="cpu")
    assert dev.shape == {"data": 1, "model": 1} and dev.devices == (
        torch.device("cpu"),)


def test_checkpoint_moves_between_meshes(tmp_path):
    """Saved at (2, 2) after a step, restored at (4, 1) and on one device:
    the next step equals the uninterrupted run's, and the checkpoint's
    arrays are the assembled state's."""
    model, s0, batch = _f32_setup(CFG)
    step22, sh22, _ = _sharded(model, _mesh(2, 2))
    state = sharding.place(s0, sh22)
    state, _ = step22(state, batch)
    ckpt.save(str(tmp_path), 1, state)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as f:
        saved = {k: f[k] for k in f.files}
    whole = ckpt._leaves(sharding.assemble(state))
    assert saved.keys() == whole.keys()
    for k, v in whole.items():
        assert np.array_equal(saved[k], v.detach().numpy()), k
    straight, _ = step22(state, batch)
    want = sharding.assemble(straight.params)
    step41, sh41, _ = _sharded(model, _mesh(4, 1))
    like = init_state(Model(CFG, device="cpu", trainable=True,
                            compute_dtype=torch.float32),
                      torch.Generator().manual_seed(9), AdamWConfig(**OPT))
    got, meta = ckpt.restore(str(tmp_path), 1, like, shardings=sh41)
    assert meta["step"] == 1 and len(got.params["embed.table"].shards) == 4
    got, _ = step41(got, batch)
    one, _ = ckpt.restore(str(tmp_path), 1, like)
    one, _ = make_step_fn(model, TrainStepConfig(
        optimizer=AdamWConfig(**OPT)))(one, batch)
    for run in (sharding.assemble(got.params), one.params):
        for n, w in want.items():
            assert float((run[n].detach() - w).abs().max()) <= F32_PARAMS, n


# ---------------------------------------------------------------------------
# Two cards
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_data_parallel_on_two_cards_matches_one_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cfg = reduced(get_config(NAME))
    g = torch.Generator().manual_seed(0)
    host = Model(cfg, device="cpu", trainable=True,
                 compute_dtype=torch.float32)
    s0 = init_state(host, g, AdamWConfig(**OPT))
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (8, 9)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def run(devices):
        model = Model(cfg, device=devices[0], trainable=True,
                      compute_dtype=torch.float32)
        step, sh, _ = _sharded(model, _mesh(2, 1, devices))
        state, m = step(sharding.place(s0, sh), batch)
        return float(m["loss"]), sharding.assemble(state.params,
                                                   device="cpu")

    (l2, p2), (l1, p1) = run(["cuda:0", "cuda:1"]), run(["cuda:0"] * 2)
    assert l2 == l1
    for n in p1:
        assert torch.equal(p2[n], p1[n]), n
