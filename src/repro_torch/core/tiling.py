"""Tile-size planner: the paper's §3.9/§3.10 for a Hopper CTA's shared
memory (claims C2/C5).

The paper picks TS_MHA / TS_FFN at synthesis time by sweeping tile sizes
against (a) the BRAM/DSP fit and (b) the post-route frequency cliff.  The
reference (``repro.core.tiling``) plans its kernel's blocks against its
on-chip budget.  On the card the hard constraint is the shared memory one
CTA of the bf16 loop holds (``csrc/mma_tile.cuh``): its ``cp.async`` ring
of ``stages`` K steps of an A tile ``[bm, bk]`` and a W slice ``[bk,
bn]``, each row padded by 16 bytes.  The cost terms are (i) HBM
re-streaming when tiles are small, (ii) tensor-core lanes wasted on
padding where a dimension is not a multiple of its tile, and (iii) SMs
left idle where the output tiles fill the card's waves badly.

A plan is a point of the tile menu the loop can run: ``bm`` 16 (K steps
``bk`` 128) or 128 (``bk`` 64), ``bn`` 32 or 64, a ring of 3 or 4 stages.
``plan_matmul`` scores the menu under a shared-memory budget and returns
the operating point; ``sweep`` is the whole menu, the Fig. 5/9/13 data.
This is a model: the kernels keep choosing their own tiles
(``kernels/tiled_matmul.py`` ``split_plan``, the BM / BN rule of
``matmul_bf16``); ``chip_smoke.py`` phase 19b prints the planner's plans
for the Fig. 5 and Fig. 11 workloads beside the kernel's measured time.
Latencies come from ``core.analytical``'s ``GPUSpec`` (``H100``).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.analytical import H100, GPUSpec

ROW_PAD_BYTES = 16          # each staged row's pad (no bank conflicts)
BK_OF_BM = {16: 128, 128: 64}   # the loop's K step for each row tile
BN_MENU = (32, 64)
STAGE_MENU = (4, 3)         # a ring of 4 where it fits, else 3


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _ceil_div(x, m) * m


@dataclass(frozen=True)
class TilePlan:
    """One matmul tiling decision: C[M,N] = A[M,K] @ B[K,N] in (bm, bk,
    bn) tiles, K accumulated through a ring of ``stages`` K steps (paper
    Fig. 4)."""

    bm: int
    bk: int
    bn: int
    stages: int
    M: int
    K: int
    N: int
    dtype_bytes: int = 2

    @property
    def grid(self) -> tuple[int, int, int]:
        """(row tiles, column tiles, K steps)."""
        return (_ceil_div(self.M, self.bm), _ceil_div(self.N, self.bn),
                _ceil_div(self.K, self.bk))

    @property
    def tiles(self) -> int:
        gm, gn, _ = self.grid
        return gm * gn

    @property
    def smem_bytes(self) -> int:
        """The ring's footprint in one CTA: ``stages`` x (A tile + W
        slice), every row padded by ``ROW_PAD_BYTES``; the f32
        accumulators live in registers."""
        pad = ROW_PAD_BYTES // self.dtype_bytes
        stage = self.bm * (self.bk + pad) + self.bk * (self.bn + pad)
        return self.stages * stage * self.dtype_bytes

    @property
    def hbm_traffic(self) -> int:
        """Bytes streamed HBM -> shared memory for the whole matmul: A is
        re-read once per column tile, B once per row tile (the paper's
        tile 'replenish' count), C written once."""
        gm, gn, _ = self.grid
        a = self.M * self.K * self.dtype_bytes * gn
        b = self.K * self.N * self.dtype_bytes * gm
        c = self.M * self.N * self.dtype_bytes
        return a + b + c

    @property
    def tc_occupancy(self) -> float:
        """Fraction of tensor-core lanes doing useful work: each dimension
        over its padding to whole tiles, and each tile edge over the
        ``mma.sync`` edge it is built from (1 for every tile of the
        menu)."""
        eff = 1.0
        for blk, dim in ((self.bm, self.M), (self.bn, self.N),
                         (self.bk, self.K)):
            eff *= dim / (_round_up(dim, blk) * 1.0)
        edge = H100.mma_tile
        for blk in (self.bm, self.bn):
            eff *= min(blk, edge) / edge
        return eff

    def wave_occupancy(self, spec: GPUSpec = H100) -> float:
        """Fraction of the SMs the output tiles keep busy over their
        waves: tiles over the SMs their waves provide."""
        waves = _ceil_div(self.tiles, spec.n_sms)
        return self.tiles / (waves * spec.n_sms)

    def latency(self, spec: GPUSpec = H100) -> tuple[float, float]:
        """(t_compute, t_memory) seconds on one card, roofline style: the
        FLOPs at the tensor cores' peak scaled by both occupancies, the
        traffic at the HBM rate."""
        flops = 2.0 * self.M * self.K * self.N
        occ = self.tc_occupancy * self.wave_occupancy(spec)
        t_c = flops / (spec.peak_flops * max(occ, 1e-9))
        t_m = self.hbm_traffic / spec.hbm_bw
        return t_c, t_m

    @property
    def t_total(self) -> float:
        """The larger latency term on the H100 profile."""
        return max(self.latency())


def sweep(M: int, K: int, N: int, dtype_bytes: int = 2) -> list[TilePlan]:
    """Every plan of the menu (fit or not): the Fig. 5/9/13 sweep data."""
    return [TilePlan(bm=bm, bk=BK_OF_BM[bm], bn=bn, stages=st, M=M, K=K,
                     N=N, dtype_bytes=dtype_bytes)
            for bm in BK_OF_BM for bn in BN_MENU for st in STAGE_MENU]


def plan_matmul(M: int, K: int, N: int, dtype_bytes: int = 2,
                spec: GPUSpec = H100,
                smem_budget: int | None = None) -> TilePlan:
    """Pick (bm, bk, bn, stages) minimizing modeled latency under the
    shared-memory budget (``spec.smem_bytes`` by default).

    This is the §3.10 procedure: enumerate the menu, reject the plans that
    overflow the on-chip budget (BRAM there, a CTA's shared memory here),
    take the best modeled operating point (the first of the menu's order
    on a tie: the deeper ring, then the wider tile).  Where nothing fits,
    the smallest legal plan."""
    budget = spec.smem_bytes if smem_budget is None else smem_budget
    best, best_t = None, 0.0
    for plan in sweep(M, K, N, dtype_bytes):
        if plan.smem_bytes > budget:
            continue
        t = max(plan.latency(spec))
        if best is None or t < best_t:
            best, best_t = plan, t
    if best is None:
        best = min(sweep(M, K, N, dtype_bytes), key=lambda p: p.smem_bytes)
    return best


@dataclass(frozen=True)
class ModuleTiling:
    """ADAPTOR-style per-module tile plans (the paper's TS_MHA / TS_FFN)
    under one shared-memory budget (None: the spec's)."""

    smem_budget: int | None = None

    def mha_plan(self, seq: int, d_model: int, heads: int) -> TilePlan:
        hd = d_model // max(heads, 1)
        return plan_matmul(seq, d_model, heads * hd,
                           smem_budget=self.smem_budget)

    def ffn_plan(self, seq: int, d_model: int, d_ff: int) -> TilePlan:
        return plan_matmul(seq, d_model, d_ff, smem_budget=self.smem_budget)
