"""The port's AdamW (``repro_torch.training.optimizer``) against the JAX
reference's (``repro.training.optimizer``).

* The reference's ``test_cosine_schedule_and_clip`` and
  ``test_adamw_decays_only_matrices``, mirrored.
* ``adamw_update`` on the same random parameters, gradients (clipped:
  their norm is past ``clip_norm``) and moments, at steps 1 and 7, with
  float32 and bfloat16 moments: the step, ``lr`` and ``grad_norm`` within
  1e-6 relative; parameters and float32 moments within 1e-6 relative +
  5e-7, a float32 ulp at the leaves' |x| < 4 (p - lr x update and the
  moments' sums round at their own scale; pow, sqrt and the clip's sum
  order differ in the last bit only); bfloat16
  moments within one bf16 ulp (2^-7 relative), since a last-bit float32
  difference can round to the neighbouring bf16 value.
* The decayed set equal to the reference's, leaf for leaf, for every
  reduced config of ``ASSIGNED + PAPER_NETWORKS``: the reference's
  parameter tree (``Model.abstract``, the init tree's structure without
  its draws) with each leaf marked by the reference's ``_is_decayed`` and
  carried onto the port's names by the bridge, against the port's
  ``is_decayed`` over a model's parameter names (a trainable model's,
  the MTP head included; a serving model's for the ssm and hybrid
  families, which do not train yet).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_cfg
from repro.configs import ASSIGNED, PAPER_NETWORKS
from repro.models.model import Model as JModel
from repro.training import optimizer as jopt
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update,
                                            clip_by_global_norm, cosine_lr,
                                            is_decayed)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def test_cosine_schedule_and_clip():
    oc = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                     min_lr_ratio=0.1)
    assert float(cosine_lr(0, oc)) == 0.0
    assert abs(float(cosine_lr(10, oc)) - 1.0) < 1e-6
    assert float(cosine_lr(torch.tensor(100, dtype=torch.int32), oc)) \
        == pytest.approx(0.1, 1e-3)
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0), 1e-4)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, 1e-4)


def test_adamw_decays_only_matrices():
    params = {"w": torch.ones((8, 8)), "bias": torch.ones((8,))}
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    oc = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                     total_steps=10)
    p2, _, _ = adamw_update(params, grads, adamw_init(params, oc), oc)
    assert float(p2["w"][0, 0]) < 1.0          # decayed
    assert float(p2["bias"][0]) == 1.0         # not decayed


# a nested tree with the leaf names of a model: matrices, biases, norm
# scales, a table, and a_log (decayed by the reference's rule)
SHAPES = {"embed": {"table": (50, 16)},
          "layers": {"attn": {"wq": {"kernel": (16, 24), "bias": (24,)}},
                     "ln1": {"scale": (16,)},
                     "ssm": {"a_log": (8, 4), "d_skip": (8,)}}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _random_tree(rs, positive=False):
    def leaf(shape):
        x = rs.randn(*shape).astype(np.float32)
        return np.abs(x) * 1e-3 if positive else x
    return jax.tree.map(leaf, SHAPES, is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("step", [1, 7])
def test_adamw_update_matches_reference(step, moments):
    rs = np.random.RandomState(step)
    params, grads = _random_tree(rs), _random_tree(rs)
    m, v = _random_tree(rs), _random_tree(rs, positive=True)
    jdt = jnp.float32 if moments == "f32" else jnp.bfloat16
    tdt = torch.float32 if moments == "f32" else torch.bfloat16
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    jcfg = jopt.AdamWConfig(moment_dtype=jdt, **kw)
    cfg = AdamWConfig(moment_dtype=tdt, **kw)
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), t)
    jp, jst, jmet = jopt.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jopt.AdamWState(jnp.int32(step - 1), cast(m), cast(v)), jcfg)
    torch_tree = lambda t, dt=torch.float32: {
        n: torch.from_numpy(np.asarray(a, np.float32)).to(dt)
        for n, a in _flat(t).items()}
    p, st, met = adamw_update(
        torch_tree(params), torch_tree(grads),
        AdamWState(torch.tensor(step - 1, dtype=torch.int32),
                   torch_tree(m, tdt), torch_tree(v, tdt)), cfg)
    assert int(st.step) == int(jst.step) == step
    for k in ("lr", "grad_norm"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-6)
    assert float(met["grad_norm"]) > cfg.clip_norm        # the clip acts
    for want, got, mom in ((jp, p, False), (jst.m, st.m, True),
                           (jst.v, st.v, True)):
        for n, w in _flat(want).items():
            w32 = np.asarray(jnp.asarray(w).astype(jnp.float32))
            g32 = got[n].float().numpy()
            if mom and moments == "bf16":
                np.testing.assert_allclose(g32, w32, rtol=2 ** -7, err_msg=n)
            else:
                np.testing.assert_allclose(g32, w32, rtol=1e-6, atol=5e-7,
                                           err_msg=n)


@pytest.mark.parametrize("name", [c.name for c in ASSIGNED + PAPER_NETWORKS])
def test_decayed_set_matches_reference(name):
    jm = JModel(reduced_cfg(name))
    flags = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape,
                                   float(jopt._is_decayed(path)), np.float32),
        jm.abstract())
    cfg = reduced(get_config(name))
    want = from_jax_params(flags, cfg, "cpu")
    trains = cfg.family not in ("ssm", "hybrid")
    names = [n for n, _ in Model(cfg, device="cpu",
                                 trainable=trains).named_parameters()]
    assert set(names) == set(want)
    for n in names:
        assert bool(want[n].min() == want[n].max() == is_decayed(n)), n
