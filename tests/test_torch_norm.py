"""The row norms: their launch plan, their plain versions against the JAX
reference, and the model's norms on the kernel path.

On the CPU:

* ``norm_plan`` at the shapes ``chip_smoke.py`` and
  ``launch/norm_probe.py`` time, and at R = 1, D = 65 and D = 65536: the
  layout follows (R, D), the units a row group holds cover the row, the
  grid never exceeds SMs x resident CTAs, and the row groups' grid-stride
  walks cover every row exactly once.
* The plain versions (what every wrapper runs on CPU tensors) against
  ``repro.kernels.ops`` in interpret mode where the port used to refuse:
  D = 65536 (past the old one-row-in-shared-memory limit), a bf16 gamma
  with a float32 x, and a view that starts at an odd element offset.
  Tolerances as in ``test_torch_ops.py``: float32 1e-5, bf16 2^-7 (one
  rounding of the output), of max|reference|.
* Under ``matmul_backend="pallas"`` the reduced qwen model sends its 2L+1
  norms per step (ln1 and ln2 of each layer, the final norm) through the
  ``rmsnorm`` wrapper, and its logits are bit for bit those of the plain
  norms.

The card tests (``cuda`` marker) hold one mixed step's launches and
logits on the kernel path; the kernels' own shapes are in
``test_torch_ops.py``'s kernel test.  The JAX reference is imported only
inside a fixture, so they also run where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_norm.py``.
"""
import dataclasses
import math
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PagingConfig
from repro_torch.kernels import layernorm as ln_mod
from repro_torch.kernels import ops, runtime
from repro_torch.models import layers
from repro_torch.models.model import Model

SMS = 132                               # an H100 SXM
CFG = reduced(get_config("qwen1.5-0.5b"))
CFG_LN = dataclasses.replace(CFG, norm="layernorm")
BS, NUM_BLOCKS, W = 8, 12, 8
TABLES = np.array([[3, 1, 7, 0], [2, 9, 4, 11], [5, 0, 0, 0]], np.int32)
N_LIVE = np.array([8, 8, 5], np.int32)
# relative error of the norms' plain outputs whose effect on the logits is
# the card test's gate: the float32 kernel's gate in the kernel test and in
# chip_smoke.py's phase 2 (1e-5 x max|plain|)
NORM_PERTURB = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The reference's public kernel API (interpret mode on the CPU)."""
    import jax.numpy as jnp

    from repro.kernels import ops as j_ops
    return types.SimpleNamespace(jnp=jnp, ops=j_ops)


def _rnd(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
PLAN_CASES = [(8, 1024), (128, 1024), (128, 8192), (16384, 1024),
              (8192, 8192), (512, 768), (12000, 1024), (4096, 65),
              (128, 3000), (64, 65536), (1, 1024), (1, 65), (1, 65536),
              (3, 96), (300, 4096)]


def _plan_rows(plan, R: int) -> list[list[int]]:
    """The rows each row group walks under ``plan``, in its order: group
    ``i`` of ``grid`` x ``rows_per_cta`` takes rows i, i + groups, ...
    (the kernel's grid stride, csrc/layernorm.cu)."""
    groups = plan.grid * plan.rows_per_cta
    return [list(range(i, R, groups)) for i in range(groups)]


@pytest.mark.parametrize("R,D", PLAN_CASES)
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vector", [True, False])
def test_norm_plan_covers_every_row_once(R, D, dt, vector):
    n = ln_mod.unit_elems(dt) if vector else 1
    if D % n:
        with pytest.raises(ValueError, match="vector=False"):
            ln_mod.norm_plan(R, D, dt, SMS, vector)
        return
    plan = ln_mod.norm_plan(R, D, dt, SMS, vector)
    units = D // n
    assert plan.vector == vector
    assert plan.threads % 32 == 0 and plan.grid >= 1
    assert plan.grid <= SMS * ln_mod.resident_ctas(plan.layout, plan.threads)
    if units > 32 * ln_mod.REG_UNITS[-1] * ln_mod.MAX_ROW_WARPS:
        assert plan.layout == "stream" and plan.units == 0
        assert plan.threads == min(ln_mod.STREAM_THREADS,
                                   32 * math.ceil(units / 32))
    else:
        assert plan.units in ln_mod.REG_UNITS
        # the row's units fit in the row group's registers
        assert units <= plan.units * 32 * plan.wpr
        if plan.layout == "warp":
            assert plan.wpr == 1
            assert plan.threads <= ln_mod.WARP_CTA_THREADS
            # the fewest units a thread that cover the row
            assert all(units > 32 * u for u in ln_mod.REG_UNITS
                       if u < plan.units)
        else:
            assert plan.layout == "warps"
            assert 1 < plan.wpr <= ln_mod.MAX_ROW_WARPS
            assert plan.threads == 32 * plan.wpr      # one row group a CTA
            assert plan.threads <= ln_mod.ROW_THREADS
            # no fewer warps would cover the row at these units
            assert units > plan.units * 32 * (plan.wpr - 1)
    walks = _plan_rows(plan, R)
    rows = [r for walk in walks for r in walk]
    assert sorted(rows) == list(range(R))            # each row exactly once
    # no row group is left idle while another walks two rows
    assert max(map(len, walks)) - min(map(len, walks)) <= 1


@pytest.mark.parametrize("R,D,dt,vector,want", [
    # a decode and a mixed step: one wave, the row spread over 4 warps of
    # one 16-byte unit each, a CTA per row
    (8, 1024, torch.bfloat16, True, ("warps", True, 1, 4, 128, 8)),
    (128, 1024, torch.bfloat16, True, ("warps", True, 1, 4, 128, 128)),
    (128, 8192, torch.bfloat16, True, ("warps", True, 2, 16, 512, 128)),
    # prefills: a persistent wave, a warp a row where 4 units cover it
    (16384, 1024, torch.bfloat16, True, ("warp", True, 4, 1, 256, 264)),
    (16384, 1024, torch.float32, True, ("warps", True, 4, 2, 64, 1056)),
    (8192, 8192, torch.bfloat16, True, ("warps", True, 4, 8, 256, 264)),
    (8192, 8192, torch.float32, True, ("warps", True, 4, 16, 512, 132)),
    # wider than 16 warps' registers: a CTA streams each row
    (64, 65536, torch.bfloat16, True, ("stream", True, 0, 16, 512, 64)),
    # element units: D 65, an unaligned start
    (1, 65, torch.float32, False, ("warps", False, 1, 3, 96, 1)),
    (4096, 65, torch.bfloat16, False, ("warp", False, 4, 1, 256, 264)),
    (128, 1024, torch.bfloat16, False, ("warps", False, 2, 16, 512, 128)),
])
def test_norm_plan_at_the_timed_shapes(R, D, dt, vector, want):
    assert tuple(ln_mod.norm_plan(R, D, dt, SMS, vector)) == want


# ---------------------------------------------------------------------------
# the plain versions against the reference, where the port used to refuse
# ---------------------------------------------------------------------------
def _close(got: torch.Tensor, want, dt) -> None:
    assert got.dtype == dt
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = 1e-5 if dt == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _pair(ref, a, dt):
    jdt = ref.jnp.bfloat16 if dt == torch.bfloat16 else ref.jnp.float32
    return ref.jnp.asarray(a, jdt), torch.from_numpy(a).to(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_norms_past_the_old_width_limit_match_reference(ref, dt):
    D = 65536                   # the old kernel refused D > 58112
    x = 2 * _rnd(50, 3, D) + 0.5
    g, b = 1 + 0.1 * _rnd(51, D), 0.1 * _rnd(52, D)
    jx, tx = _pair(ref, x, dt)
    jg, tg = _pair(ref, g, torch.float32)
    jb, tb = _pair(ref, b, torch.float32)
    _close(ops.rmsnorm(tx, tg), ref.ops.rmsnorm(jx, jg), dt)
    _close(ops.layernorm(tx, tg, tb), ref.ops.layernorm(jx, jg, jb), dt)


@pytest.mark.parametrize("D", [80, 1024])
def test_bf16_parameters_with_f32_x_match_reference(ref, D):
    """The reference casts every parameter with astype(float32), so a bf16
    gamma (and beta) with a float32 x is taken."""
    x = 2 * _rnd(53, 6, D) + 0.5
    g, b = 1 + 0.1 * _rnd(54, D), 0.1 * _rnd(55, D)
    jx, tx = _pair(ref, x, torch.float32)
    jg, tg = _pair(ref, g, torch.bfloat16)
    jb, tb = _pair(ref, b, torch.bfloat16)
    _close(ops.rmsnorm(tx, tg), ref.ops.rmsnorm(jx, jg), torch.float32)
    _close(ops.layernorm(tx, tg, tb), ref.ops.layernorm(jx, jg, jb),
           torch.float32)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3])
def test_view_at_an_odd_offset_matches_reference(ref, dt, offset):
    R, D = 7, 96
    flat = 2 * _rnd(56, R * D + offset) + 0.5
    g, b = 1 + 0.1 * _rnd(57, D), 0.1 * _rnd(58, D)
    x = torch.from_numpy(flat).to(dt)[offset:].view(R, D)
    assert x.is_contiguous() and x.storage_offset() == offset
    jx = ref.jnp.asarray(flat[offset:].reshape(R, D),
                         ref.jnp.bfloat16 if dt == torch.bfloat16
                         else ref.jnp.float32)
    jg, tg = _pair(ref, g, torch.float32)
    jb, tb = _pair(ref, b, torch.float32)
    _close(ln_mod.rmsnorm(x, tg), ref.ops.rmsnorm(jx, jg), dt)
    _close(ln_mod.layernorm(x, tg, tb), ref.ops.layernorm(jx, jg, jb), dt)


def test_model_norms_are_the_kernels_plain_versions():
    """One copy of the plain arithmetic: the model's norms are the
    wrappers' CPU path."""
    assert layers.rmsnorm is ln_mod.rmsnorm_plain
    assert layers.layernorm is ln_mod.layernorm_plain


# ---------------------------------------------------------------------------
# the model's norms on the kernel path (CPU: the wrapper's plain version)
# ---------------------------------------------------------------------------
def _model(cfg, dt, mm, device="cpu"):
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return Model(cfg, compute_dtype=dt, matmul_backend=mm,
                 paged_attn_impl="pallas" if mm == "pallas" else "gather",
                 device=device).init(g)


def _step(model, step: str, seed: int = 0) -> torch.Tensor:
    """One mixed step (a chunk with partial slots) or one decode step on a
    fresh pool; the live lanes' logits."""
    dev = model.device
    rs = np.random.RandomState(seed)
    cache = model.init_cache(PagingConfig(BS, NUM_BLOCKS))
    tables = torch.from_numpy(TABLES).to(dev)
    n_live = torch.from_numpy(N_LIVE).to(dev)
    if step == "mixed":
        toks = torch.from_numpy(rs.randint(0, model.cfg.vocab_size, (3, W))
                                .astype(np.int32)).to(dev)
        start = torch.zeros(3, dtype=torch.int32, device=dev)
        out = model.mixed_step(cache, toks, start, n_live, tables)
        return out[torch.arange(W, device=dev)[None, :] < n_live[:, None]]
    toks = torch.from_numpy(rs.randint(0, model.cfg.vocab_size, (3, 1))
                            .astype(np.int32)).to(dev)
    return model.decode_step(cache, toks, n_live, tables)


def _counting(name: str, calls: list):
    orig = getattr(ln_mod, name)

    def wrapped(*args):
        calls.append(tuple(args[0].shape))
        return orig(*args)
    return mock.patch.object(ln_mod, name, wrapped)


@pytest.mark.parametrize("cfg,kind", [(CFG, "rmsnorm"),
                                      (CFG_LN, "layernorm")])
@pytest.mark.parametrize("step", ["mixed", "decode"])
def test_kernel_path_routes_every_norm_through_the_wrapper(cfg, kind, step):
    L, rows = cfg.num_layers, 3 * (W if step == "mixed" else 1)
    for mm, want in (("pallas", 2 * L + 1), ("xla", 0)):
        calls = []
        with _counting(kind, calls):
            _step(_model(cfg, torch.bfloat16, mm), step)
        assert len(calls) == want, (mm, calls)
        assert all(c == (rows, cfg.d_model) for c in calls)  # [R, D] views


@pytest.mark.parametrize("cfg", [CFG, CFG_LN], ids=["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", ["mixed", "decode"])
def test_kernel_path_logits_equal_plain_norms_bit_for_bit(cfg, dt, step):
    """The same model under "pallas", its norms once through the wrapper
    (the plain version on CPU tensors, over [rows, D]) and once as the
    "xla" backend's plain function over [B, W, D]."""
    model = _model(cfg, dt, "pallas")
    got = _step(model, step, seed=1)
    orig = layers.apply_norm
    with mock.patch.object(layers, "apply_norm",
                           lambda x, p, kind, mm: orig(x, p, kind, "xla")):
        want = _step(model, step, seed=1)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the card (run where a CUDA device is present)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    runtime.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,kind", [(CFG, "rmsnorm"),
                                      (CFG_LN, "layernorm")])
def test_cuda_mixed_step_launches_the_norm_kernel(cuda, cfg, kind):
    """One mixed step under "pallas" launches the norm kernel 2L+1 times,
    and its float32 logits stay within twice the distance by which scaling
    the plain norms' outputs by (1 + ``NORM_PERTURB``) moves them from the
    same step with the plain norms (every other kernel runs in all three):
    the model amplifies float32 last bits (about 100x over two layers),
    while a gamma off by 1% moves the logits 1000x further."""
    model = _model(cfg, torch.float32, "pallas", device=cuda)
    kern = getattr(ln_mod, kind)
    before = kern.launches
    got = _step(model, "mixed", seed=2)
    assert kern.launches - before == 2 * cfg.num_layers + 1
    plain = getattr(ln_mod, f"{kind}_plain")
    with mock.patch.object(ln_mod, kind, plain):
        want = _step(model, "mixed", seed=2)
    with mock.patch.object(ln_mod, kind,
                           lambda *a: plain(*a) * (1 + NORM_PERTURB)):
        perturbed = _step(model, "mixed", seed=2)
    assert kern.launches - before == 2 * cfg.num_layers + 1
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all()
    assert err <= 2 * float((perturbed - want).abs().max())
