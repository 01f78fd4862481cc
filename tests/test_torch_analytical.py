"""The port's cost model (``repro_torch.core.analytical``) and tile planner
(``repro_torch.core.tiling``) on the CPU.

* Every function of ``core/analytical.py`` against the reference's
  ``repro.core.analytical``, for every config of the port's ``REGISTRY``
  (adaptor-bert-shaped, which the reference has no file for, rebuilt from
  its fields) at every reference ``ALL_SHAPES`` entry and at Table 1's and
  Table 2's points (``benchmarks/table1_throughput.py``,
  ``table2_analytical.py``).  The port's ``GPUSpec`` is built here from the
  reference ``V5E``'s fields, so that the same arithmetic meets the same
  constants; the port itself holds no number of that device.  Equal to a
  relative 1e-12; ``param_count`` and the other integers exactly.
* The H100 profile's figures and the reference planner's four invariants
  (``tests/test_quant_tiling.py``), restated for a CTA's shared memory:
  the plan fits the budget (or is the smallest legal plan) with tile edges
  multiples of 16; no fitting plan of the menu is faster; bigger tiles
  stream fewer HBM bytes; the paper's odd custom-encoder dims show the
  padding penalty where an aligned product shows none.
"""
import dataclasses
import math

import pytest

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro.core import analytical as ref_an
from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ALL_SHAPES, ShapeSpec
from repro_torch.core import analytical as an
from repro_torch.core import tiling
from test_torch_threads import one_thread  # noqa: F401 (autouse)

# the reference device's constants, as the port's spec type
REF_GPU = an.GPUSpec(name=ref_an.V5E.name, peak_flops=ref_an.V5E.peak_flops,
                     hbm_bw=ref_an.V5E.hbm_bw, link_bw=ref_an.V5E.ici_bw,
                     hbm_bytes=ref_an.V5E.hbm_bytes,
                     smem_bytes=ref_an.V5E.vmem_bytes,
                     mma_tile=ref_an.V5E.mxu_tile)
# Table 1: the three networks at sequence 64, batch 1 and 128; Table 2:
# (network, sequence, d_model) with d_ff 4 x d_model where d_model moves
TABLE1 = [(n, ShapeSpec(f"table1_b{b}", 64, b, "prefill"))
          for n in ("shallow-transformer", "custom-encoder", "adaptor-bert")
          for b in (1, 128)]
TABLE2 = [("adaptor-bert", 64, 768), ("adaptor-bert", 128, 768),
          ("adaptor-bert", 64, 512), ("shallow-transformer", 64, 512),
          ("custom-encoder", 64, 200)]
REL = 1e-12


def _ref_shape(s: ShapeSpec):
    return ref_base.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)


def _ref_cfg(cfg):
    """The reference's config of the same name, or one built from the
    port's fields (no sub-config) where the reference has none."""
    if cfg.name in ref_configs.REGISTRY:
        return ref_configs.REGISTRY[cfg.name]
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    assert all(fields[k] is None for k in ("moe", "mla", "ssm", "hybrid",
                                            "encdec", "frontend"))
    return ref_base.ArchConfig(**fields)


def _table2(name, seq, dm):
    cfg = get_config(name)
    if dm != cfg.d_model:
        cfg = dataclasses.replace(cfg, d_model=dm,
                                  head_dim=dm // cfg.num_heads, d_ff=4 * dm)
    return cfg, ShapeSpec("table2", seq, 1, "prefill")


def _close(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _close(a[k], b[k])
        return
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}
    assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0), (a, b)


def _points(cfg):
    """(cfg, shape) pairs: every reference shape, and the Table 1/2
    points of the config's own network."""
    pts = [(cfg, s) for s in ALL_SHAPES]
    pts += [(cfg, s) for n, s in TABLE1 if n == cfg.name]
    pts += [_table2(*row) for row in TABLE2 if row[0] == cfg.name]
    return pts


def _check_cfg_shape(cfg, shape):
    # a Table 2 variant moves the widths of its registry config
    rc = dataclasses.replace(_ref_cfg(cfg), d_model=cfg.d_model,
                             head_dim=cfg.head_dim, d_ff=cfg.d_ff)
    rs = _ref_shape(shape)
    _close(an.step_flops(cfg, shape), ref_an.step_flops(rc, rs))
    _close(an.model_flops(cfg, shape), ref_an.model_flops(rc, rs))
    _close(an.scan_undercount_correction(cfg, shape),
           ref_an.scan_undercount_correction(rc, rs))
    for tp in (1, 2):
        mine = an.analytical_step_seconds(cfg, shape, 1, REF_GPU, tp=tp)
        want = ref_an.analytical_step_seconds(rc, rs, 1, tp=tp)
        for f in ("t_compute", "t_memory", "t_collective", "flops",
                  "bytes_hbm", "bytes_collective", "t_total",
                  "compute_fraction"):
            _close(getattr(mine, f), getattr(want, f))
        assert mine.dominant == want.dominant and mine.n_chips == 1
    batch = shape.global_batch
    assert an.kv_cache_bytes(cfg, shape.seq_len, batch) \
        == ref_an.kv_cache_bytes(rc, shape.seq_len, batch)
    B, q, kv = batch, min(shape.seq_len, 512), shape.seq_len
    if cfg.family != "ssm":
        _close(an.attention_module_flops(cfg, B, q, kv),
               ref_an.attention_module_flops(rc, B, q, kv))
    _close(an.ffn_module_flops(cfg, B * q, cfg.d_ff),
           ref_an.ffn_module_flops(rc, B * q, rc.d_ff))
    if cfg.ssm is not None:
        _close(an.ssm_module_flops(cfg, B * q),
               ref_an.ssm_module_flops(rc, B * q))
    if cfg.hybrid is not None:
        _close(an.rglru_module_flops(cfg, B * q),
               ref_an.rglru_module_flops(rc, B * q))


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_every_function_matches_the_reference(name):
    cfg = get_config(name)
    rc = _ref_cfg(cfg)
    assert cfg.param_count() == rc.param_count()
    assert cfg.active_param_count() == rc.active_param_count()
    for active in (False, True):
        assert an.arch_param_count(cfg, active) \
            == ref_an.arch_param_count(rc, active)
    for db in (1, 2):
        assert an.weight_bytes(cfg, db) == ref_an.weight_bytes(rc, db)
    assert an.train_state_bytes(cfg) == ref_an.train_state_bytes(rc)
    for kv_dtype in ("compute", "int8"):
        try:
            want = ref_an.kv_bytes_per_token(rc, kv_dtype)
        except ValueError as exc:
            with pytest.raises(ValueError, match="no per-token KV cache"):
                an.kv_bytes_per_token(cfg, kv_dtype)
            assert "no per-token KV cache" in str(exc)
        else:
            assert an.kv_bytes_per_token(cfg, kv_dtype) == want
    for c, s in _points(cfg):
        _check_cfg_shape(c, s)


def test_roofline_and_multiplier_match_the_reference():
    assert an.train_multiplier() == ref_an.train_multiplier()
    for args in ((1e12, 3e9, 1e6, 1), (5e15, 8e11, 2e10, 4)):
        mine = an.roofline(*args, spec=REF_GPU)
        want = ref_an.roofline(*args)
        for f in ("t_compute", "t_memory", "t_collective", "t_total"):
            _close(getattr(mine, f), getattr(want, f))
        assert mine.dominant == want.dominant
        assert mine.scaled(n_chips=2).n_chips == 2


def test_shapes_are_the_reference_shapes():
    assert [dataclasses.astuple(s) for s in ALL_SHAPES] \
        == [dataclasses.astuple(s) for s in ref_base.ALL_SHAPES]
    assert [s.is_decode for s in ALL_SHAPES] \
        == [s.is_decode for s in ref_base.ALL_SHAPES]


def test_h100_profile_is_the_data_sheet():
    """The defaults are NVIDIA's H100 SXM figures, the card of every
    measurement ("NVIDIA H100 80GB HBM3, 700.00 W"); NVLink is unmeasured
    on a one-card machine."""
    h = an.H100
    assert h.name == an.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (h.peak_flops, h.int8_ops, h.f32_flops) == (989e12, 1979e12,
                                                       67e12)
    assert (h.hbm_bw, h.hbm_bytes) == (3.35e12, 80 * 10**9)
    assert (h.smem_bytes, h.n_sms, h.mma_tile) == (227 * 1024, 132, 16)
    assert not h.link_measured
    assert an.roofline(989e12, 0, 0, 1).t_compute == 1.0


# ---------------------------------------------------------------------------
# the tile planner: the reference's invariants over shared memory
# ---------------------------------------------------------------------------
PLAN_SHAPES = [(1, 1, 1), (8, 1024, 1024), (64, 200, 198), (64, 198, 200),
               (512, 768, 3072), (4096, 768, 768), (4096, 768, 3072),
               (4096, 200, 800), (8192, 8192, 8192), (77, 300, 199)]
BUDGETS = [None, 100 * 1024, 48 * 1024, 16 * 1024]


@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_plan_fits_shared_memory_budget(M, K, N):
    smallest = min(tiling.sweep(M, K, N), key=lambda p: p.smem_bytes)
    for budget in BUDGETS:
        p = tiling.plan_matmul(M, K, N, smem_budget=budget)
        lim = an.H100.smem_bytes if budget is None else budget
        assert p.smem_bytes <= lim or p == smallest
        assert p.bm % 16 == 0 and p.bn % 16 == 0 and p.bk % 16 == 0
        assert (p.bm, p.bk) in tiling.BK_OF_BM.items()
        assert p.stages in tiling.STAGE_MENU


@pytest.mark.parametrize("budget", BUDGETS[:3])
def test_plan_beats_or_ties_all_fitting_candidates(budget):
    """The planner's §3.10 objective: no fitting plan is faster."""
    lim = an.H100.smem_bytes if budget is None else budget
    for M, K, N in ((4096, 768, 3072), (64, 200, 198), (8, 1024, 1024)):
        best = tiling.plan_matmul(M, K, N, smem_budget=budget)
        for cand in tiling.sweep(M, K, N):
            if cand.smem_bytes <= lim:
                assert best.t_total <= cand.t_total + 1e-12


def test_bigger_tiles_less_hbm_traffic():
    """Fig. 13's monotonicity: growing bm / bn cuts re-streaming."""
    small = tiling.TilePlan(bm=16, bk=128, bn=32, stages=4, M=4096, K=4096,
                            N=4096)
    big = tiling.TilePlan(bm=128, bk=64, bn=64, stages=4, M=4096, K=4096,
                          N=4096)
    assert big.hbm_traffic < small.hbm_traffic
    assert big.smem_bytes > small.smem_bytes


def test_misaligned_occupancy_penalty():
    """The paper's odd custom-encoder dims (200 / 3 heads: 198 q/k/v
    columns) show the padding penalty the planner is built around."""
    odd = tiling.TilePlan(bm=128, bk=64, bn=64, stages=4, M=64, K=200, N=66)
    aligned = tiling.TilePlan(bm=128, bk=64, bn=64, stages=4, M=128, K=256,
                              N=128)
    assert odd.tc_occupancy < aligned.tc_occupancy
    assert aligned.tc_occupancy == 1.0


def test_footprint_is_the_kernels_ring():
    """``smem_bytes`` is ``csrc/mma_tile.cuh``'s ``MmaShape`` of one
    weight: stages x (BM x (BK + 8) + BK x (BN + 8)) bf16 elements."""
    want = {(16, 32): 58368, (16, 64): 91136, (128, 32): 94208,
            (128, 64): 110592}
    for (bm, bn), nbytes in want.items():
        p = tiling.TilePlan(bm=bm, bk=tiling.BK_OF_BM[bm], bn=bn, stages=4,
                            M=1, K=1, N=1)
        assert p.smem_bytes == nbytes <= 227 * 1024
    # the budgets re-pick the plan, as the paper re-picks per board
    plans = {b: dataclasses.astuple(tiling.plan_matmul(4096, 768, 3072,
                                                       smem_budget=b))[:4]
             for b in (227 * 1024, 100 * 1024, 48 * 1024)}
    assert len(set(plans.values())) == 3
    assert tiling.ModuleTiling(48 * 1024).ffn_plan(4096, 768, 3072) \
        .smem_bytes <= 48 * 1024
