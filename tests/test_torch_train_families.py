"""The port's training loss across the families, against the JAX
reference (reduced configs, float32 compute on both sides).

For granite-moe-1b-a400m (the router balance term ``load_balance``),
phi-3-vision-4.2b (a seeded ``frontend`` in place of the first
positions' embeddings), whisper-medium (the encoder over seeded frames at
``encoder_seq_len``) and adaptor-bert (non-causal): the loss and every
aux term within 1e-5 relative, every gradient leaf within 1e-4 x
max|g_ref|, mapped by name through the bridge.  deepseek-v3's (MLA + MoE
+ MTP) is in ``test_torch_train_mtp.py``, which imports ``check_loss``.

For qwen2-72b, codeqwen1.5-7b, phi3-mini-3.8b, shallow-transformer and
custom-encoder, one port-only step (the reference's
``test_train_step_finite``): finite loss and gradient norm, parameters
moved.  What a trainable model refuses: int8 weights, the "pallas"
backend; and the sharded step (item 16c).  The ssm and hybrid families
train through their scans' backwards: ``test_torch_train_scans.py``, which
imports ``check_loss`` too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_cfg
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                             loss_and_grads, make_step_fn,
                                             make_train_step)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def batch_for(cfg, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    """Seeded numpy ids and targets (and frames / patch embeddings where
    the family takes a frontend), as the reference's smoke tests build
    them."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.encdec is not None:
        batch["frontend"] = rs.randn(b, cfg.encdec.encoder_seq_len,
                                     cfg.d_model).astype(np.float32)
    elif cfg.frontend is not None:
        batch["frontend"] = rs.randn(b, cfg.frontend.num_tokens,
                                     cfg.d_model).astype(np.float32)
    return batch


def check_loss(name: str) -> tuple[dict, dict]:
    """The reference's f32 loss, aux and gradients at its init weights
    against the port's on the same weights and batch; returns the port's
    (aux, grads)."""
    j_cfg, cfg = reduced_cfg(name), reduced(get_config(name))
    jm = JModel(j_cfg, ModelOptions(compute_dtype=jnp.float32))
    params = jm.init(jax.random.PRNGKey(0))
    batch = batch_for(cfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = Model(cfg, compute_dtype=torch.float32, device="cpu",
               trainable=True)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                       cfg, "cpu"))
    loss, aux, grads = loss_and_grads(
        tm, dict(tm.named_parameters()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux.keys() == jaux.keys()
    for k in ("total", *jaux):
        want = float(jl if k == "total" else jaux[k])
        got = float(loss if k == "total" else aux[k])
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    want = from_jax_params(jax.tree.map(np.asarray, jg), cfg, "cpu")
    assert want.keys() == grads.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        err = float((g - grads[n]).abs().max())
        assert err <= 1e-4 * scale, f"{name} grad {n}: {err} > 1e-4 x {scale}"
    return aux, grads


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "phi-3-vision-4.2b",
                                  "whisper-medium", "adaptor-bert"])
def test_loss_and_grads_match_reference(name):
    aux, grads = check_loss(name)
    if name.startswith("granite"):
        assert set(aux) == {"xent", "load_balance", "total"}
        # the balance term reaches the main stack's first router only
        assert grads["layers.0.moe.router"].abs().max() > 0


@pytest.mark.parametrize("name", ["qwen2-72b", "codeqwen1.5-7b",
                                  "phi3-mini-3.8b", "shallow-transformer",
                                  "custom-encoder"])
def test_train_step_finite(name):
    cfg = reduced(get_config(name))
    tm = Model(cfg, device="cpu", trainable=True)
    oc = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = init_state(tm, torch.Generator().manual_seed(0), oc)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, m = make_step_fn(tm, TrainStepConfig(optimizer=oc))(
        state, {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()})
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert any(not torch.equal(state.params[n], before[n]) for n in before)


@pytest.mark.parametrize("kw,match", [
    (dict(quant="int8"), "quant='int8'"),
    (dict(matmul_backend="pallas"), "no hand-written kernel"),
    (dict(remat="some"), "remat='some'")])
def test_trainable_model_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        Model(reduced(get_config("qwen1.5-0.5b")), device="cpu",
              trainable=True, **kw)


def test_serving_model_does_not_train_and_mesh_is_refused():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    with pytest.raises(ValueError, match="trainable=True"):
        init_state(Model(cfg, device="cpu"), torch.Generator(),
                   AdamWConfig())
    with pytest.raises(ValueError, match="item 16c"):
        make_train_step(Model(cfg, device="cpu", trainable=True),
                        TrainStepConfig(), mesh=object())
