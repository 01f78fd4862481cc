"""The port's trainer on qwen1.5-0.5b (reduced) against the JAX reference.

Weights and optimizer state go from the reference through numpy and
``repro_torch.bridge`` (``from_jax_params``, ``from_jax_train_state``);
batches are seeded numpy ids.  Both packages compute in float32 (the
reference's bf16 KV store plays no part: training has no cache):

* the loss within 1e-5 relative, every gradient leaf within 1e-4 x
  max|g_ref| (mapped by name through the bridge);
* one step from a state carried over at step 3 (three reference steps
  from init): the moments within 1e-4 x max of their own magnitude, and
  the update p' - p within ``UPDATE_TOL`` = 1e-2 x lr.  Why that bound:
  the update is lr x (m_hat / (sqrt(v_hat) + eps) + wd x p), and after
  three steps of one sign m_hat / sqrt(v_hat) is near 1 and moves by
  about twice an element's relative gradient error.  Most leaves' updates
  agree within 6e-5 x lr (a float32 ulp of p); K's bias, whose gradient
  is a sum that nearly cancels (a shift of every key cancels in the
  softmax up to RoPE's rotation), carries relative errors near 1e-3 and
  updates within 3e-3 x lr.  A step from step 0 is not compared: there
  the update is g / (|g| + eps), nearly sign(g), and last-bit noise of a
  gradient near zero flips whole updates;
* ``accum_steps=2`` against the reference's ``accum_steps=2`` from the
  same carried state, at the same bounds;
* remat "full" and "dots" against "none": the same loss and gradients,
  bit for bit (the recomputation repeats the forward's arithmetic), and
  "dots" recomputes no matrix product in the backward where "full" does;
* bf16 compute: the loss within 2e-2 x |loss| of the reference's bf16
  loss.

Port-only: the reference's memorization gate (the last of 60 losses
below half the first), the trained masters served by the port's CPU
``ServingEngine`` reproducing a memorized row (the reference quickstart's
check, at least 6 of 8 tokens), and ``donate=False`` leaving the state
it was given intact.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import reduced_cfg
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.bridge import from_jax_params, from_jax_train_state
from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec)
from repro_torch.data.pipeline import MemorizationStream
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                             loss_and_grads, make_step_fn)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


NAME = "qwen1.5-0.5b"
J_CFG = reduced_cfg(NAME)
CFG = reduced(get_config(NAME))
B, S = 4, 32
CARRY = 3                 # reference steps before the carried one
UPDATE_TOL = 1e-2         # x lr, on every element of p' - p
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _batch(seed: int = 7, b: int = B) -> dict[str, np.ndarray]:
    toks = np.random.RandomState(seed).randint(0, CFG.vocab_size,
                                               (b, S + 1))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _torch(batch: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """The reference model at f32 compute, its init state, its jitted
    value_and_grad and step, and the state after CARRY steps."""
    jm = JModel(J_CFG, ModelOptions(compute_dtype=jnp.float32))
    oc = jopt.AdamWConfig(**OPT)
    s0 = jts.init_state(jm, jax.random.PRNGKey(0), oc)
    step = jax.jit(jts.make_step_fn(jm, jts.TrainStepConfig(optimizer=oc)))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    s = s0
    for _ in range(CARRY):
        s, _ = step(s, batch)
    return types.SimpleNamespace(
        jm=jm, oc=oc, s0=s0, carried=s, step=step, batch=batch,
        vg=jax.jit(jax.value_and_grad(jm.loss, has_aux=True)))


def _model(**kw) -> Model:
    return Model(CFG, compute_dtype=kw.pop("compute_dtype", torch.float32),
                 device="cpu", trainable=True, **kw)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(a)


def _close_leaves(want: dict, got: dict, rel: float, what: str) -> None:
    assert want.keys() == got.keys()
    scale = max(float(v.abs().max()) for v in want.values())
    for n, w in want.items():
        err = float((w.float() - got[n].detach().float()).abs().max())
        assert err <= rel * scale, f"{what} {n}: {err} > {rel} x {scale}"


def test_loss_and_grads_match_reference(ref):
    (jl, jaux), jg = ref.vg(ref.s0.params, ref.batch)
    tm = _model()
    tm.load_state_dict(from_jax_params(_np(ref.s0.params), CFG, "cpu"))
    params = dict(tm.named_parameters())
    loss, aux, grads = loss_and_grads(tm, params, _torch(_batch()))
    assert aux.keys() == jaux.keys() == {"xent", "total"}
    for k in jaux:
        assert _rel(float(jaux[k]), float(aux[k])) <= 1e-5, k
    assert _rel(float(jl), float(loss)) <= 1e-5
    _close_leaves(from_jax_params(_np(jg), CFG, "cpu"), grads, 1e-4, "grad")


def _compare_step(want, got, lr: float) -> None:
    """A carried step's state: the moments at 1e-4 of their scale, the
    step, the update at UPDATE_TOL x lr."""
    w = from_jax_train_state(_np(want), CFG, "cpu")
    assert int(got.opt.step) == int(w.opt.step)
    _close_leaves(w.opt.m, got.opt.m, 1e-4, "m")
    _close_leaves(w.opt.v, got.opt.v, 1e-4, "v")
    for n, p in w.params.items():
        err = float((p.detach() - got.params[n].detach()).abs().max())
        assert err <= UPDATE_TOL * lr, f"param {n}: {err}"


def _carried_step(ref, accum: int):
    oc = ref.oc
    jstep = ref.step if accum == 1 else jax.jit(jts.make_step_fn(
        ref.jm, jts.TrainStepConfig(optimizer=oc, accum_steps=accum)))
    want, jm_ = jstep(ref.carried, ref.batch)
    tm = _model()
    state = from_jax_train_state(_np(ref.carried), CFG, "cpu")
    before = {n: p.detach().clone() for n, p in state.params.items()}
    got, m = make_step_fn(tm, TrainStepConfig(
        optimizer=AdamWConfig(**OPT), accum_steps=accum))(
            state, _torch(_batch()))
    lr = float(jm_["lr"])
    for k in ("loss", "lr", "grad_norm"):
        assert _rel(float(jm_[k]), float(m[k])) <= 1e-5, k
    _compare_step(want, got, lr)
    # the step moved the parameters by about lr
    moved = max(float((got.params[n].detach() - before[n]).abs().max())
                for n in before)
    assert moved > 0.1 * lr


def test_carried_step_matches_reference(ref):
    _carried_step(ref, 1)


def test_accumulation_matches_reference(ref):
    _carried_step(ref, 2)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_grads_mm(remat: str, weights: dict):
    tm = _model(remat=remat)
    tm.load_state_dict(weights)
    loss, _ = tm.loss(_torch(_batch()))
    params = list(tm.parameters())
    with _CountMM() as c:
        grads = torch.autograd.grad(loss, params)
    return loss, grads, c.n


def test_remat_matches_none(ref):
    weights = from_jax_params(_np(ref.s0.params), CFG, "cpu")
    loss, grads, mm = _loss_grads_mm("none", weights)
    for mode in ("full", "dots"):
        got, got_grads, got_mm = _loss_grads_mm(mode, weights)
        assert torch.equal(got, loss), mode
        assert all(torch.equal(a, b) for a, b in zip(grads, got_grads)), mode
        # "dots" saves the products; "full" runs every layer's again
        assert (got_mm == mm) if mode == "dots" else (got_mm > mm), \
            (mode, got_mm, mm)


def test_bf16_loss_tracks_reference(ref):
    jm = JModel(J_CFG, ModelOptions(compute_dtype=jnp.bfloat16))
    jl, _ = jax.jit(jm.loss)(ref.s0.params, ref.batch)
    tm = _model(compute_dtype=torch.bfloat16)
    tm.load_state_dict(from_jax_params(_np(ref.s0.params), CFG, "cpu"))
    with torch.no_grad():
        loss, _ = tm.loss(_torch(_batch()))
    assert _rel(float(jl), float(loss)) <= 2e-2


def _memorize(stream_batch, steps: int = 60):
    """The reference's memorization run (bf16 compute, lr 3e-3, warmup 5,
    no decay): (model, state, losses)."""
    tm = Model(CFG, device="cpu", trainable=True)
    oc = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=80,
                     weight_decay=0.0)
    gen = torch.Generator().manual_seed(0)
    state = init_state(tm, gen, oc)
    step = make_step_fn(tm, TrainStepConfig(optimizer=oc))
    losses = []
    for _ in range(steps):
        state, m = step(state, stream_batch())
        losses.append(float(m["loss"]))
    return tm, state, losses


def test_memorization_converges():
    batch = _torch(_batch(seed=7))
    _, _, losses = _memorize(lambda: batch)
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


def test_trained_masters_serve_a_memorized_row():
    stream = MemorizationStream(vocab_size=CFG.vocab_size, seq_len=32,
                                batch=4, n_rows=4, device="cpu")
    _, state, losses = _memorize(stream.next)
    assert losses[-1] < 0.5 * losses[0]
    eng = ServingEngine(RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(compute_dtype="bf16"),
        memory=MemorySpec(cache_layout="paged", max_batch=2, max_len=64,
                          block_size=8),
        scheduler=SchedulerSpec(chunk_size=8)), device="cpu")
    eng.load(state.params)
    row = stream.corpus[0].tolist()
    eng.submit(row[:8], max_new_tokens=8)
    (req,) = eng.run_to_completion()
    hits = sum(a == b for a, b in zip(req.generated, row[8:16]))
    assert hits >= 6, (req.generated, row[8:16])


def test_donate_false_leaves_the_state_intact():
    tm = _model()
    oc = AdamWConfig(**OPT)
    state = init_state(tm, torch.Generator().manual_seed(0), oc)
    snap = {n: p.detach().clone() for n, p in state.params.items()}
    new, _ = make_step_fn(tm, TrainStepConfig(optimizer=oc, donate=False))(
        state, _torch(_batch()))
    assert int(state.opt.step) == 0 and int(new.opt.step) == 1
    assert all(torch.equal(state.params[n], snap[n]) for n in snap)
    assert all(not t.any() for t in state.opt.m.values())
    assert any(not torch.equal(new.params[n], snap[n]) for n in snap)
    # the default donates: the state passed in is the state returned
    again, _ = make_step_fn(tm, TrainStepConfig(optimizer=oc))(
        new, _torch(_batch()))
    assert again.params["embed.table"] is new.params["embed.table"]
    assert int(new.opt.step) == 2
