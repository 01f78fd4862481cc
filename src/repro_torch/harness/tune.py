"""Analytical autotuner: rank runtime configurations before running any.

This is the port of the reference's ``harness.tune``, the reproduction of
ADAPTOR's resource allocator (§5): the paper sizes tile counts and BRAM
partitions from a closed-form model of the target platform; here the same
``core.analytical`` roofline model, on an H100's figures (``H100``), sizes
the serving runtime's free knobs — cache layout (dense vs paged), pool
geometry (``block_size`` / ``num_blocks`` / ``max_batch``), scheduler
(``policy``, ``chunk_size`` / ``token_budget``), prefix caching, the int8
cache codec (``allow_int8_kv``) and speculation (``draft``) — under a
cache-memory budget, for a described workload.

The tuner is *pre-execution* arithmetic: it never builds an engine.  Its
objective is deliberately coarse — a queueing sketch on top of
``analytical_step_seconds`` — because ranking, not absolute seconds, is
what matters (``chip_smoke.py`` phase 19b holds exactly that on the card:
the model's ranking of four forwards matches their measured times).
Phase 19c replays a trace on the tuned spec's engine and on
``naive_default``'s.

The grid is the reference's, meshes included: ``DeviceProfile(n_devices=
n)`` enumerates every (tp, dp) divisor pair of ``n`` (``meshes()``), each
replica's geometry sized on its share of the budget, a tensor-parallel
replica's steps priced with ``analytical_step_seconds``' all-reduce term
at ``gpu.link_bw`` (NVLink's rate; ``interconnect_gbps`` overrides it),
and a replica set scored by the requests its ``dp`` replicas hold.

Like the reference, the tuner drops silently every candidate its
``RuntimeSpec`` rejects.  The port's spec rejects a few configurations
that the reference's accepts, so the port drops these points where the
reference ranks them:

* ``execution.quant="int8"`` on an MLA arch whose ``k_up`` / ``v_up`` the
  size rule would quantize, and on an arch whose learned position table
  it would quantize (``core.serve_quant`` ``check_mla_quant``,
  ``check_position_quant``: the reference cannot serve either; ROADMAP.md
  Queue 3);
* ``maxima`` (a fleet) with an MLA arch or an arch of another family
  than the dense one (the reference's fabric refuses these in its engine,
  the port's spec at construction);
* a mesh with ``tp > 1`` on an MoE arch (experts on the tp axis:
  ROADMAP.md Queue 1 item 13b).

Where that leaves no candidate, ``tune`` raises as the reference does on
an empty grid.

Front doors::

    spec = RuntimeSpec.tuned(arch, device_profile=DeviceProfile(...),
                             workload=WorkloadProfile.from_trace(trace))
    result = tune(arch, device=..., workload=...)   # ranked candidates
"""
from __future__ import annotations

import math
import dataclasses
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.analytical import (H100, GPUSpec,
                                         analytical_step_seconds,
                                         kv_bytes_per_token, weight_bytes)
from repro_torch.core.spec import (CHUNKABLE_FAMILIES, ExecutionSpec,
                                   MemorySpec, MeshSpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec)

# Enumerated knob grids.  Small on purpose: the analytical model makes
# each point ~free, but the run that *verifies* the winner is not.
_BLOCK_SIZES = (8, 16, 32)
_CHUNK_SIZES = (16, 32, 64)
_BUDGET_MULT = (2, 4, 8)
_SPEC_KS = (2, 4)            # draft depths searched (k=0 = no speculation)
_MAX_BATCH_CAP = 64          # host-side per-slot bookkeeping ceiling


def expected_accepted(k: int, a: float) -> float:
    """Expected tokens per speculative step at per-token acceptance ``a``:
    ``E(k, a) = sum_{i=0..k} a^i = (1 - a^{k+1}) / (1 - a)`` — the
    accepted prefix run plus the always-emitted bonus/correction token.
    Monotone in both arguments, ``1`` at ``a = 0`` (speculation never
    emits fewer tokens than plain decode), ``k + 1`` at ``a -> 1``."""
    a = min(max(a, 0.0), 0.999)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


@dataclass(frozen=True)
class DeviceProfile:
    """The target card, plus how much of its HBM the KV cache may use.
    ``cache_budget_bytes`` pins the budget directly (equal-memory
    comparisons do this); ``None`` derives it as ``cache_fraction`` of the
    HBM left after weights.

    ``gpu`` is the card's figures (``H100``, or ``GPUSpec.from_card()``
    for the present card's memory).  ``n_devices`` is the mesh surface:
    the tuner ranks every ``(tp, dp)`` divisor pair of it (``n_chips``
    keeps its meaning of cards per replica for the one-device ranking).
    ``interconnect_gbps`` overrides ``gpu.link_bw`` for the TP all-reduce
    term."""

    gpu: GPUSpec = H100
    n_chips: int = 1
    cache_fraction: float = 0.4
    cache_budget_bytes: int | None = None
    n_devices: int = 1
    interconnect_gbps: float | None = None

    @property
    def effective_gpu(self) -> GPUSpec:
        if self.interconnect_gbps is None:
            return self.gpu
        return dataclasses.replace(self.gpu,
                                   link_bw=self.interconnect_gbps * 1e9)

    def meshes(self) -> tuple[MeshSpec, ...]:
        """Every (tp, dp) divisor pair of ``n_devices``, tp ascending."""
        return tuple(MeshSpec(tp=tp, dp=self.n_devices // tp)
                     for tp in range(1, self.n_devices + 1)
                     if self.n_devices % tp == 0)

    def budget(self, arch: ArchConfig, dtype_bytes: int = 2) -> int:
        if self.cache_budget_bytes is not None:
            return self.cache_budget_bytes
        free = max(self.n_chips, self.n_devices) * self.gpu.hbm_bytes \
            - weight_bytes(arch, dtype_bytes)
        return max(int(self.cache_fraction * free), 0)


@dataclass(frozen=True)
class WorkloadProfile:
    """What the traffic looks like — the trace distilled to the moments
    the tuner's queueing sketch needs."""

    mean_prompt_len: float = 64.0
    max_prompt_len: int = 128
    mean_new_tokens: float = 8.0
    burst_size: int = 8              # peak simultaneous arrivals
    shared_prefix_frac: float = 0.0  # fraction of requests sharing a prefix
    shared_prefix_len: int = 0       # tokens of that shared prefix
    # expected per-token probability the target accepts a draft proposal
    # (workload-dependent: ~1 for greedy self-drafting, lower the further
    # the draft sits from the target); 0 keeps speculation out of the
    # candidate space
    draft_acceptance: float = 0.0

    @staticmethod
    def from_trace(trace) -> "WorkloadProfile":
        arrivals: dict[int, int] = {}
        for r in trace.requests:
            arrivals[r.arrival_step] = arrivals.get(r.arrival_step, 0) + 1
        meta = trace.meta
        return WorkloadProfile(
            mean_prompt_len=trace.mean_prompt_len,
            max_prompt_len=trace.max_prompt_len,
            mean_new_tokens=trace.mean_new_tokens,
            burst_size=max(arrivals.values()),
            shared_prefix_frac=meta.get("shared_frac", 0.0),
            shared_prefix_len=meta.get("prefix_len", 0))

    @property
    def effective_prompt_len(self) -> float:
        """Mean prompt tokens that must actually be prefilled once a
        prefix cache absorbs the shared span."""
        saved = self.shared_prefix_frac * min(self.shared_prefix_len,
                                              self.mean_prompt_len)
        return max(self.mean_prompt_len - saved, 1.0)


@dataclass(frozen=True)
class Candidate:
    """One scored configuration point."""

    spec: RuntimeSpec
    score: float                 # requests per predicted second (higher wins)
    predicted_latency_s: float
    predicted_ttft_s: float
    predicted_itl_s: float
    cache_bytes: int
    max_batch: int

    def summary(self) -> dict:
        m, s = self.spec.memory, self.spec.scheduler
        return {"tp": self.spec.mesh.tp, "dp": self.spec.mesh.dp,
                "cache_layout": m.cache_layout, "max_batch": m.max_batch,
                "block_size": m.block_size if m.cache_layout == "paged" else None,
                "num_blocks": m.resolved_num_blocks if m.cache_layout == "paged" else None,
                "kv_dtype": m.kv_dtype, "prefix_cache": m.prefix_cache,
                "policy": s.policy, "chunk_size": s.chunk_size,
                "token_budget": s.resolved_token_budget,
                "spec_k": self.spec.speculation.k
                if self.spec.speculation is not None else 0,
                "score": self.score, "cache_bytes": self.cache_bytes,
                "predicted_ttft_s": self.predicted_ttft_s,
                "predicted_itl_s": self.predicted_itl_s}


@dataclass(frozen=True)
class TuneResult:
    """The winner plus the full ranking (transparency for callers)."""

    spec: RuntimeSpec
    best: Candidate
    ranked: tuple[Candidate, ...]    # best first
    budget_bytes: int


def _per_token_bytes(arch: ArchConfig, kv_dtype: str, maxima) -> int:
    """Cache bytes per token: the arch's own geometry, or — under a
    fleet ``maxima`` — the maxima-shaped rows the shared pool actually
    allocates (``DecodeFabric.kv_bytes_per_token``: a small member in a
    big fabric still pays maxima-sized cache)."""
    if maxima is not None:
        hd = maxima.head_dim_max
        per_row = hd + 4 if kv_dtype == "int8" else 2 * hd
        return 2 * maxima.layers_enc_max * maxima.heads_max * per_row
    return kv_bytes_per_token(arch, kv_dtype)


def cache_bytes(spec: RuntimeSpec) -> int:
    """KV-cache bytes a spec provisions (the equal-memory yardstick).
    A speculative spec also pays for the draft's private dense cache —
    equal-memory comparisons must charge speculation its real rent."""
    per_tok = _per_token_bytes(spec.arch, spec.memory.kv_dtype, spec.maxima)
    m = spec.memory
    total = m.resolved_num_blocks * m.block_size * per_tok \
        if m.cache_layout == "paged" else m.max_batch * m.max_len * per_tok
    if spec.speculation is not None:
        total += m.max_batch * m.max_len * kv_bytes_per_token(
            spec.speculation.draft_model, "compute")
    return total


def _predict(arch: ArchConfig, cand: RuntimeSpec, device: DeviceProfile,
             workload: WorkloadProfile,
             dtype_bytes: int) -> tuple[float, float, float]:
    """(ttft_s, itl_s, latency_s) queueing sketch for one candidate.

    Coarse by design: decode cost from the roofline at the candidate's
    batch, prefill cost from the roofline at its per-step grant, queue
    effects from how many of a burst fit.  Monotone in the knobs that
    matter (bigger batch amortizes weight reads; bigger grants finish
    prompts in fewer steps but each step costs more; prefix caching
    shrinks the prompt work) — which is all a *ranking* objective needs.
    """
    gpu, tp = device.effective_gpu, cand.mesh.tp
    # one TP replica spans tp cards; n_chips keeps its meaning of cards
    # per replica for the one-device ranking
    chips = tp if tp > 1 else device.n_chips
    B = cand.memory.max_batch
    eff_prompt = workload.effective_prompt_len if cand.memory.prefix_cache \
        else workload.mean_prompt_len
    kv_depth = int(eff_prompt + workload.mean_new_tokens)
    t_decode = analytical_step_seconds(
        arch, ShapeSpec("tune_decode", kv_depth, B, "decode"),
        chips, gpu, dtype_bytes, tp=tp).t_total
    concurrent = max(1, min(B, workload.burst_size))
    if cand.scheduler.policy == "chunked":
        grant = min(cand.scheduler.resolved_token_budget,
                    max(int(eff_prompt), cand.scheduler.chunk_size))
        t_pre = analytical_step_seconds(
            arch, ShapeSpec("tune_chunk", grant, 1, "prefill"),
            chips, gpu, dtype_bytes, tp=tp).t_total
        t_mixed = t_decode + t_pre
        share = cand.scheduler.resolved_token_budget / concurrent
        ttft_steps = eff_prompt / max(share, 1.0)
        ttft = ttft_steps * t_mixed
        prefill_steps = concurrent * eff_prompt \
            / cand.scheduler.resolved_token_budget
        frac = prefill_steps / max(prefill_steps + workload.mean_new_tokens,
                                   1.0)
        t_dec_eff = t_decode
        if cand.speculation is not None:
            # speculative steady state: one fused step pays k one-lane
            # draft decodes plus the target's k+1-lane verify (the verify
            # is roofline-equivalent to a decode step — both stream the
            # same weights and KV, the extra query lanes are ~free) and
            # yields E(k, a) tokens
            sp = cand.speculation
            t_draft = analytical_step_seconds(
                sp.draft_model, ShapeSpec("tune_draft", kv_depth, B,
                                          "decode"),
                chips, gpu, dtype_bytes, tp=tp).t_total
            t_dec_eff = (sp.k * t_draft + t_decode) / expected_accepted(
                sp.k, workload.draft_acceptance)
        itl = frac * t_mixed + (1.0 - frac) * t_dec_eff
    else:
        # bucketed: one B=1 prefill dispatch per request, decode stalls
        # behind it, and a burst larger than the batch waits whole turns
        t_pre = analytical_step_seconds(
            arch, ShapeSpec("tune_prefill", max(int(eff_prompt), 1), 1,
                            "prefill"),
            chips, gpu, dtype_bytes, tp=tp).t_total
        waves = math.ceil(concurrent / B)
        ttft = waves * t_pre
        itl = t_decode + concurrent * t_pre / max(
            workload.mean_new_tokens * B, 1.0)
    latency = ttft + workload.mean_new_tokens * itl
    return ttft, itl, latency


def score(spec: RuntimeSpec, device: DeviceProfile,
          workload: WorkloadProfile) -> Candidate:
    """One spec scored as ``tune`` scores its candidates: the queueing
    sketch's predictions (``_predict``) and requests per predicted second
    (a spec ``tune`` did not propose too, such as ``naive_default``'s).
    The ``dp`` replicas drain ``dp`` queues at once: the replica set's
    throughput and cache scale with it, a request's latency does not."""
    dtype_bytes = 1 if spec.execution.quant == "int8" else 2
    ttft, itl, latency = _predict(spec.arch, spec, device, workload,
                                  dtype_bytes)
    dp = spec.mesh.dp
    return Candidate(spec=spec, score=dp * spec.memory.max_batch / latency,
                     predicted_latency_s=latency, predicted_ttft_s=ttft,
                     predicted_itl_s=itl, cache_bytes=dp * cache_bytes(spec),
                     max_batch=dp * spec.memory.max_batch)


def _candidates(arch: ArchConfig, workload: WorkloadProfile, max_len: int, budget: int,
                execution: ExecutionSpec, kv_dtypes: tuple[str, ...],
                maxima, mesh: MeshSpec = MeshSpec(),
                draft: ArchConfig | None = None) -> list[RuntimeSpec]:
    chunkable = arch.family in CHUNKABLE_FAMILIES
    pageable = arch.family in ("dense", "vlm", "moe")
    live_tokens = workload.effective_prompt_len + workload.mean_new_tokens
    # speculation variants ride every chunked point (k=0 is the point
    # itself); the spec's own validation prunes infeasible geometry
    # (horizon > chunk, vocab mismatch, non-chunkable draft)
    speculations: tuple[SpeculationSpec | None, ...] = (None,)
    if draft is not None and workload.draft_acceptance > 0.0:
        speculations += tuple(SpeculationSpec(draft_model=draft, k=kk)
                              for kk in _SPEC_KS)

    out: list[RuntimeSpec] = []

    def add(memory: MemorySpec, scheduler: SchedulerSpec) -> None:
        specs = speculations if scheduler.policy == "chunked" else (None,)
        for sp in specs:
            try:
                out.append(RuntimeSpec(arch=arch, maxima=maxima,
                                       execution=execution, memory=memory,
                                       scheduler=scheduler, mesh=mesh,
                                       speculation=sp))
            except ValueError:
                pass  # geometry the spec itself rejects is not a candidate

    for kv_dtype in kv_dtypes:
        per_tok = _per_token_bytes(arch, kv_dtype, maxima)
        # dense: every slot pre-pays max_len tokens
        dense_b = min(budget // (max_len * per_tok), _MAX_BATCH_CAP)
        if dense_b >= 1:
            mem = MemorySpec(cache_layout="dense", max_batch=int(dense_b),
                             max_len=max_len, kv_dtype=kv_dtype)
            add(mem, SchedulerSpec(policy="bucketed"))
            if chunkable:
                for chunk in _CHUNK_SIZES:
                    if chunk > max_len:
                        continue
                    for mult in _BUDGET_MULT:
                        add(mem, SchedulerSpec(policy="chunked",
                                               chunk_size=chunk,
                                               token_budget=mult * chunk))
        if not (pageable and chunkable):
            continue
        # paged: the pool holds live tokens, not worst-case rectangles
        pool_tokens = budget // per_tok
        for bs in _BLOCK_SIZES:
            if max_len % bs:
                continue
            num_blocks = pool_tokens // bs
            if num_blocks * bs < max_len:
                continue        # could never admit one full request
            # per-request block rounding means live_tokens understates
            # true occupancy; round up to whole blocks before dividing
            per_req = math.ceil(live_tokens / bs) * bs
            paged_b = int(min(pool_tokens // per_req, _MAX_BATCH_CAP))
            if paged_b < 1:
                continue
            num_blocks = min(num_blocks,
                             paged_b * math.ceil(max_len / bs) * 2)
            if num_blocks * bs * per_tok > budget:
                num_blocks = budget // (bs * per_tok)
            prefixes = (False, True) if workload.shared_prefix_frac > 0.0 \
                else (False,)
            for prefix in prefixes:
                mem = MemorySpec(cache_layout="paged", max_batch=paged_b,
                                 max_len=max_len, block_size=bs,
                                 num_blocks=int(num_blocks),
                                 kv_dtype=kv_dtype, prefix_cache=bool(prefix))
                for chunk in _CHUNK_SIZES:
                    if chunk % bs or chunk > max_len:
                        continue
                    for mult in _BUDGET_MULT:
                        add(mem, SchedulerSpec(policy="chunked",
                                               chunk_size=chunk,
                                               token_budget=mult * chunk))
    return out


def tune(arch: ArchConfig, device: DeviceProfile | None = None,
         workload: WorkloadProfile | None = None, *,
         max_len: int | None = None, execution: ExecutionSpec | None = None,
         allow_int8_kv: bool = False, maxima=None,
         draft: ArchConfig | None = None) -> TuneResult:
    """Rank candidate runtime configurations for ``arch`` and return the
    predicted-best under the device's cache-memory budget.

    ``allow_int8_kv`` gates the int8 cache codec into the search: it is
    numerics-changing (quantize-on-write), so the tuner only trades
    capacity against it when explicitly allowed.  ``execution`` (kernel
    backend, weight quant, dtypes) is passed through unsearched — kernel
    routing is measured separately and is workload-independent.

    ``draft`` adds speculative-decoding points (``spec_k`` in
    ``_SPEC_KS``) to the chunked candidates; their decode term is scaled
    by the analytical acceptance model ``expected_accepted(k,
    workload.draft_acceptance)``, so a workload that reports low draft
    agreement prices speculation out on its own.
    """
    device = device or DeviceProfile()
    workload = workload or WorkloadProfile()
    execution = execution or ExecutionSpec()
    if max_len is None:
        need = workload.max_prompt_len + int(workload.mean_new_tokens) * 2
        max_len = max(64, 1 << (need - 1).bit_length())
    dtype_bytes = 1 if execution.quant == "int8" else 2
    budget = device.budget(arch, dtype_bytes)
    kv_dtypes = ("compute", "int8") if (
        allow_int8_kv and arch.family in ("dense", "vlm", "moe")) \
        else ("compute",)
    cands: list[RuntimeSpec] = []
    for mesh in device.meshes():
        # the whole budget splits evenly across the dp replicas; each
        # candidate's geometry is one replica's
        cands += _candidates(arch, workload, max_len, budget // mesh.dp,
                             execution, kv_dtypes, maxima, mesh=mesh,
                             draft=draft)
    if not cands:
        raise ValueError(
            f"no feasible configuration for {arch.family!r} arch under a "
            f"{budget}-byte cache budget at max_len={max_len}: even one "
            "slot does not fit; raise the budget or shrink max_len")
    scored = [score(spec, device, workload) for spec in cands]
    # deterministic ranking: score desc, then the smaller provisioned
    # pool wins ties, then the summary repr as a total order
    scored.sort(key=lambda c: (-c.score, c.cache_bytes, repr(c.summary())))
    return TuneResult(spec=scored[0].spec, best=scored[0],
                      ranked=tuple(scored), budget_bytes=budget)


def naive_default(arch: ArchConfig, tuned: RuntimeSpec) -> RuntimeSpec:
    """The hand-picked baseline at *equal memory*: dense layout with the
    stock ``MemorySpec`` batch, shrunk or grown along ``max_batch`` until
    its cache pays the same bytes as ``tuned``'s pool (so any goodput
    win is allocation, not extra HBM)."""
    per_tok = _per_token_bytes(arch, "compute", tuned.maxima)
    m = tuned.memory
    b = max(cache_bytes(tuned) // (m.max_len * per_tok), 1)
    return RuntimeSpec(
        arch=arch, maxima=tuned.maxima, execution=tuned.execution,
        memory=MemorySpec(cache_layout="dense", max_batch=int(b),
                          max_len=m.max_len),
        scheduler=SchedulerSpec(policy="auto"))
