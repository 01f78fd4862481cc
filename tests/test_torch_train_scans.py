"""The scans' backwards, and training the hybrid (recurrentgemma-2b) and
ssm (falcon-mamba-7b) families, against the JAX reference (reduced
configs, float32 compute on both sides; seeded numpy inputs).

* ``rglru_scan_bwd_plain`` against ``torch.autograd.grad`` through
  ``rglru_scan_plain``: bit for bit (the same two float32 operators a
  position; the adjoint's two-term sums commute), with ``dh`` of the last
  state.
* ``ssm_scan_bwd_plain`` against autograd through ``ssm_scan_plain``,
  with ``dh`` and x in float32 and bf16: every gradient within
  ``SUM_TOL`` = 2e-6 x max|g| (the sums over states, channels, rows and
  positions are taken in the kernel's orders, autograd's in its own; the
  per-element operators are the same), bf16 ``dx`` within one bf16 step.
* Both backwards against ``jax.vjp`` of a ``lax.scan`` written as the
  reference's ``step`` functions (``src/repro/models/rglru.py``,
  ``ssm.py``): within ``JAX_TOL`` = 1e-5 x max|g| (XLA's order of sums
  and its exp).
* ``Model.loss`` and every gradient leaf of both reduced families against
  ``jax.grad`` of the reference's ``Model.loss``: the loss within 1e-5
  relative, each leaf within 1e-4 x max|g_ref| (``check_loss`` of
  ``test_torch_train_families.py``).
* One ``make_step_fn`` step of each family from a state carried over at
  step 2, against the reference's step (``bridge.from_jax_train_state``;
  the bounds of ``test_torch_train.py``).
* The gradients bit for bit under remat "none", "full" and "dots", and
  the scans' forwards and backwards a step against ``kernels/counts.py``
  ``program_launches(cfg, "train")``.
* ``lengths`` with a gradient refused by both wrappers.
* ``python -m repro_torch.launch.train --model <family>`` (reduced, CPU)
  with ``--accum 2`` and checkpoints: a resumed run ends on the masters and
  moments of the uninterrupted one, bit for bit.

The file runs on one intra-op thread (``test_torch_threads.py``'s autouse
fixture, as every port test file).  The backward kernels' own tests (the
``cuda`` marker) are in ``test_torch_hybrid.py`` and ``test_torch_ssm.py``
beside the forward kernels'.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_cfg
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.bridge import from_jax_train_state
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import counts
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssm_scan as sm
from repro_torch.launch.train import main as train_main
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainStepConfig, loss_and_grads,
                                             make_step_fn)
from test_torch_train_families import batch_for, check_loss
from test_torch_threads import one_thread  # noqa: F401 (autouse)

FAMILIES = ("recurrentgemma-2b", "falcon-mamba-7b")
SUM_TOL = 2e-6            # x max|g|: the plain backward's orders of sums
JAX_TOL = 1e-5            # x max|g|: XLA's orders and exp
UPDATE_TOL = 1e-2         # x lr (test_torch_train.py's reason)
CARRY = 2                 # reference steps before the compared one
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _rglru_inputs(seed: int = 0, shape=(2, 37, 24)):
    rs = np.random.RandomState(seed)
    b, s, w = shape
    return (rs.uniform(0, 1, shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32),
            rs.randn(b, w).astype(np.float32))


def _ssm_inputs(seed: int = 0, shape=(2, 37, 40, 8)):
    """dt (softplus of a normal), x, b, c, a (-exp(U(-1, 1))), dy, dh."""
    rs = np.random.RandomState(seed)
    b_, s, di, n = shape
    dt = np.log1p(np.exp(rs.randn(b_, s, di))).astype(np.float32)
    return (dt, rs.randn(b_, s, di).astype(np.float32),
            rs.randn(b_, s, n).astype(np.float32),
            rs.randn(b_, s, n).astype(np.float32),
            (-np.exp(rs.uniform(-1, 1, (di, n)))).astype(np.float32),
            rs.randn(b_, s, di).astype(np.float32),
            rs.randn(b_, di, n).astype(np.float32))


def _close(want: torch.Tensor, got: torch.Tensor, tol: float, what: str):
    scale = float(want.float().abs().max())
    err = float((want.float() - got.float()).abs().max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def test_rglru_backward_is_autograd_of_the_plain_loop():
    a, g, dhs, dh = map(torch.from_numpy, _rglru_inputs())
    a.requires_grad_(True)
    g.requires_grad_(True)
    hs, h = rg.rglru_scan_plain(a, g)
    want = torch.autograd.grad((hs * dhs).sum() + (h * dh).sum(), [a, g])
    got = rg.rglru_scan_bwd_plain(a.detach(), hs.detach(), dhs, dh)
    assert all(torch.equal(w, x) for w, x in zip(want, got))
    # the wrapper's autograd path on the host is that backward
    hs2, h2 = rg.rglru_scan(a, g)
    fn = torch.autograd.grad((hs2 * dhs).sum() + (h2 * dh).sum(), [a, g])
    assert all(torch.equal(w, x) for w, x in zip(got, fn))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_ssm_backward_is_autograd_of_the_plain_loop(x_dtype):
    dt, x, b, c, a, dy, dh = map(torch.from_numpy, _ssm_inputs())
    x = x.to(x_dtype)
    ins = [t.requires_grad_(True) for t in (dt, x, b, c, a)]
    y, h = sm.ssm_scan_plain(*ins)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    got = sm.ssm_scan_bwd_plain(*(t.detach() for t in ins), dy, dh)
    for name, w, x_ in zip(("dt", "x", "b", "c", "a"), want, got):
        assert x_.dtype == w.dtype, name
        if name == "x" and x_dtype == torch.bfloat16:
            # each rounded once to bf16 from float32 sums in two orders
            step = w.float().abs() * 2.0 ** -7 + 1e-30
            assert bool(((w.float() - x_.float()).abs() <= step).all())
        else:
            _close(w, x_, SUM_TOL, name)
    y2, h2 = sm.ssm_scan(*ins)
    fn = torch.autograd.grad((y2 * dy).sum() + (h2 * dh).sum(), ins)
    assert all(torch.equal(p, q) for p, q in zip(got, fn))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_ssm_backward_from_the_forwards_checkpoints(x_dtype):
    """``ssm_scan_bwd_plain`` started from the plain forward's checkpoints
    (S = 37: a ragged last chunk) is bit for bit the call that re-runs the
    forward for them, and so is the wrapper given them."""
    dt, x, b, c, a, dy, dh = map(torch.from_numpy, _ssm_inputs(seed=2))
    x = x.to(x_dtype)
    *_, ckpt = sm.ssm_scan_plain(dt, x, b, c, a, checkpoints=True)
    assert ckpt.shape == (2, 3, 40, 8)
    want = sm.ssm_scan_bwd_plain(dt, x, b, c, a, dy, dh)
    for got in (sm.ssm_scan_bwd_plain(dt, x, b, c, a, dy, dh, ckpt),
                sm.ssm_scan_bwd(dt, x, b, c, a, dy, dh, ckpt)):
        for u, v in zip(got, want, strict=True):
            assert u.dtype == v.dtype and torch.equal(u, v)


def _jax_rglru_vjp(a, g, dhs, dh):
    """The reference's step, h = a_t h + g_t, under ``lax.scan``."""
    def scan(a, g):
        def step(h, inp):
            a_t, g_t = inp
            h = a_t * h + g_t
            return h, h
        h0 = jnp.zeros((a.shape[0], a.shape[2]), jnp.float32)
        h, hs = jax.lax.scan(step, h0, (a.transpose(1, 0, 2),
                                        g.transpose(1, 0, 2)))
        return hs.transpose(1, 0, 2), h
    _, vjp = jax.vjp(scan, a, g)
    return vjp((dhs, dh))


def _jax_ssm_vjp(dt, x, b, c, a, dy, dh):
    """The reference's discretization and step under ``lax.scan``."""
    def scan(dt, x, b, c, a):
        a_bar = jnp.exp(dt[..., None] * a)
        bx = dt[..., None] * b[..., None, :] * x[..., None]

        def step(h, inp):
            a_t, bx_t, c_t = inp
            h = a_t * h + bx_t
            return h, jnp.einsum("bdn,bn->bd", h, c_t)
        h0 = jnp.zeros(dh.shape, jnp.float32)
        h, ys = jax.lax.scan(step, h0, (a_bar.transpose(1, 0, 2, 3),
                                        bx.transpose(1, 0, 2, 3),
                                        c.transpose(1, 0, 2)))
        return ys.transpose(1, 0, 2), h
    _, vjp = jax.vjp(scan, dt, x, b, c, a)
    return vjp((dy, dh))


def test_rglru_backward_matches_jax_vjp():
    a, g, dhs, dh = _rglru_inputs(seed=1)
    want = _jax_rglru_vjp(*map(jnp.asarray, (a, g, dhs, dh)))
    a_t = torch.from_numpy(a)
    hs, _ = rg.rglru_scan_plain(a_t, torch.from_numpy(g))
    got = rg.rglru_scan_bwd(a_t, hs, torch.from_numpy(dhs),
                            torch.from_numpy(dh))
    for name, w, x_ in zip(("a", "g"), want, got):
        _close(torch.from_numpy(np.array(w)), x_, JAX_TOL, name)


def test_ssm_backward_matches_jax_vjp():
    ins = _ssm_inputs(seed=1)
    want = _jax_ssm_vjp(*map(jnp.asarray, ins))
    got = sm.ssm_scan_bwd(*map(torch.from_numpy, ins))
    for name, w, x_ in zip(("dt", "x", "b", "c", "a"), want, got):
        _close(torch.from_numpy(np.array(w)), x_, JAX_TOL, name)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_reference(name):
    aux, grads = check_loss(name)
    assert set(aux) == {"xent", "total"}
    # the scans' inputs reach their leaves
    leaf = "rglru.a_param" if name.startswith("recurrent") else "ssm.a_log"
    assert grads[f"layers.0.{leaf}"].abs().max() > 0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_leaves(want: dict, got: dict, rel: float, what: str) -> None:
    assert want.keys() == got.keys()
    scale = max(float(v.abs().max()) for v in want.values())
    for n, w in want.items():
        err = float((w.float() - got[n].detach().float()).abs().max())
        assert err <= rel * scale, f"{what} {n}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("name", FAMILIES)
def test_carried_step_matches_reference(name):
    j_cfg, cfg = reduced_cfg(name), reduced(get_config(name))
    jm = JModel(j_cfg, ModelOptions(compute_dtype=jnp.float32))
    oc = jopt.AdamWConfig(**OPT)
    step = jax.jit(jts.make_step_fn(jm, jts.TrainStepConfig(optimizer=oc)))
    batch = batch_for(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    carried = jts.init_state(jm, jax.random.PRNGKey(0), oc)
    for _ in range(CARRY):
        carried, _ = step(carried, jbatch)
    want, jmet = step(carried, jbatch)
    tm = Model(cfg, compute_dtype=torch.float32, device="cpu",
               trainable=True)
    state = from_jax_train_state(_np(carried), cfg, "cpu")
    before = {n: p.detach().clone() for n, p in state.params.items()}
    got, met = make_step_fn(tm, TrainStepConfig(
        optimizer=AdamWConfig(**OPT)))(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "lr", "grad_norm"):
        assert abs(float(jmet[k]) - float(met[k])) \
            <= 1e-5 * abs(float(jmet[k])), k
    w = from_jax_train_state(_np(want), cfg, "cpu")
    assert int(got.opt.step) == int(w.opt.step) == CARRY + 1
    _close_leaves(w.opt.m, got.opt.m, 1e-4, "m")
    _close_leaves(w.opt.v, got.opt.v, 1e-4, "v")
    lr = float(jmet["lr"])
    for n, p in w.params.items():
        err = float((p.detach() - got.params[n].detach()).abs().max())
        assert err <= UPDATE_TOL * lr, f"param {n}: {err}"
    moved = max(float((got.params[n].detach() - before[n]).abs().max())
                for n in before)
    assert moved > 0.1 * lr


def _counting(monkeypatch, calls: dict) -> None:
    """Count the scans' forward bodies and backward wrappers by kernel
    name (on the host they run the plain versions and count nothing)."""
    for mod, fwd, bwd in ((rg, "rglru_scan", "rglru_scan_bwd"),
                          (sm, "ssm_scan", "ssm_scan_bwd")):
        for attr, name in (("_forward", fwd), (bwd, bwd)):
            fn = getattr(mod, attr)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, attr, counted)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_modes_agree_and_count_the_scans(name, monkeypatch):
    cfg = reduced(get_config(name))
    tm = Model(cfg, compute_dtype=torch.float32, device="cpu",
               trainable=True).init(torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
    params = dict(tm.named_parameters())
    calls: dict = {}
    _counting(monkeypatch, calls)
    got = {}
    for mode in ("none", "full", "dots"):
        tm.remat = mode
        calls.clear()
        got[mode] = loss_and_grads(tm, params, batch)
        want = counts.program_launches(cfg, "train", remat=mode)
        assert {k: calls.get(k, 0) for k in want} == want, mode
    loss, _, grads = got["none"]
    for mode in ("full", "dots"):
        assert torch.equal(got[mode][0], loss), mode
        assert all(torch.equal(got[mode][2][n], g) for n, g in grads.items()), \
            mode


def test_program_launches_of_a_train_step():
    """At full depth: one forward and one backward a scan layer, one more
    forward under remat, all per microbatch; no other kernel."""
    hybrid, ssm_ = get_config("recurrentgemma-2b"), get_config(
        "falcon-mamba-7b")
    h = counts.program_launches(hybrid, "train")
    assert {k: v for k, v in h.items() if v} == {"rglru_scan": 18,
                                                  "rglru_scan_bwd": 18}
    s = counts.program_launches(ssm_, "train", remat="full", accum_steps=2)
    assert {k: v for k, v in s.items() if v} == {"ssm_scan": 256,
                                                  "ssm_scan_bwd": 128}
    q = counts.program_launches(get_config("qwen1.5-0.5b"), "train")
    assert set(q) == set(counts.wrappers()) and not any(q.values())


def test_lengths_with_a_gradient_are_refused():
    a, g, _, _ = map(torch.from_numpy, _rglru_inputs())
    n = torch.tensor([37, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="lengths with a gradient"):
        rg.rglru_scan(a.requires_grad_(True), g, n)
    dt, x, b, c, a_, _, _ = map(torch.from_numpy, _ssm_inputs())
    with pytest.raises(ValueError, match="lengths with a gradient"):
        sm.ssm_scan(dt, x.requires_grad_(True), b, c, a_, n)
    # without grad mode the serving path takes lengths as before
    with torch.no_grad():
        hs, _ = rg.rglru_scan(a, g, n)
    assert torch.equal(hs[1, 5:], hs[1, 4:5].expand(32, -1))


@pytest.mark.parametrize("name", FAMILIES)
def test_train_cli_runs_and_resumes_the_scan_families(name, tmp_path,
                                                       capsys):
    args = ["--device", "cpu", "--model", name, "--batch", "2", "--seq",
            "8", "--accum", "2", "--steps", "3", "--ckpt-every", "1",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    train_main(args)
    out = capsys.readouterr().out
    assert "step     3  loss" in out and out.rstrip().endswith("done")
    last = tmp_path / "step_00000003"
    with np.load(last / "arrays.npz") as f:
        want = {k: f[k] for k in f.files}
    # drop the last checkpoint: --resume restarts from step 2
    shutil.rmtree(last)
    train_main([*args, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     3  loss" in out
    with np.load(last / "arrays.npz") as got:
        assert sorted(got.files) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
