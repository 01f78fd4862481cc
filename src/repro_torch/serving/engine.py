"""Batched serving engine of the port: the chunked and the bucketed
scheduler over the paged KV pool or the dense per-slot cache.

The counterpart of the reference's ``serving/engine.py`` on its
single-topology and fleet paths.  The scheduler is ``spec.resolved_policy``
(``"auto"``: chunked where the chunk geometry allows it, else bucketed):

* **chunked** -- one fused mixed step advances every slot by up to W =
  ``chunk_size`` query lanes (prompt chunks for prefilling slots, the next
  token for decoding slots, nothing for idle ones); once no slot carries
  prompt work the one-lane decode step runs instead.  Both end in
  sampling, the token scatter and the finish flags.
* **bucketed** -- a new request is padded up to its prompt-length bucket
  (powers of two from 32 up to ``max_len``, ``_buckets``), prefilled at
  B = 1 (``Model.prefill``, or the fleet's ``DecodeFabric.prefill``) into
  a staging cache, which is copied into the slot's rows of the dense cache
  or, in whole blocks, into the slot's pool blocks; its first token is
  sampled on the device from the prefill's logits (``_admit_slot``).
  Every fused step is the one-lane decode.  The prompt's length goes up
  beside it as the prefill's device input ``lengths``, so one graph per
  bucket serves every length: a hybrid model's recurrent state and
  rolling buffers are the unpadded prompt's (the reference scans the pad
  and rolls it into the window; the port does not copy that).  An audio
  model's prefill also runs its encoder over the stub frontend's zero
  frames (the graph's constant input) and stores each layer's cross K/V
  in the slot's rows of its ``EncDecCache``, which every decode step then
  reads in place.

Cache layouts (``spec.memory.cache_layout``): ``"paged"``, the pooled
``[num_blocks + 1, block_size]`` blocks of ``core.paging`` with block-budget
admission and preemption; ``"dense"``, one ``[max_len + 1]`` row range per
slot (``Model.init_cache`` without paging: the spare row ``max_len`` takes
the writes of dead lanes and of positions past the end, which the
reference drops as out-of-bounds scatters; no mask admits it, so the
logits and streams are the reference's).

Per-slot state lives in device tensors (``SlotState``) and is updated in
place; the KV pool is written in place by the model.  The host keeps the
reference's discipline:

* block tables (paged layout) are uploaded only when the host changed
  them;
* one bulk ``.cpu()`` of the (done, count) vectors per sync;
* a second transfer only for the finished rows' token buffers, sliced to
  the longest finished stream.

Nothing between two syncs waits for the device, so ``sync_every=k`` lets
the host queue k fused steps ahead: block tables, chunk grants, the
stochastic rows' index and each admitted prompt (with its topology
registers and, for a bucketed admission into the pool, its block-table
row) go up through ``HostStage``'s pinned buffers as asynchronous copies
into device tensors that stay in place.

Each fused program is one CUDA graph (``graphs=True``, the default on a
CUDA device; the counterpart of the reference's
``strict_jit(..., donate_argnums=(1, 2))``), and so is each bucket's B = 1
prefill (the reference's one ``jax.jit`` per bucket; its outputs are the
graph's own tensors, read right after each replay): the first step of a
kind runs
eagerly on a side stream as the warm-up, is captured there once into a
graph pool the engine's graphs share, and every later step of that kind
replays the graph on the current stream, after the host work
(``HostStage`` uploads, grants, stats).  Every tensor the step reads stays
in place: the slot state, the pool, the block tables, the grants, the
stochastic rows' index and the fleet's table.  ``load`` drops the graphs
(it replaces the pool), as does any step that finds a captured tensor
replaced.  Only all-greedy steps are captured: a step with a stochastic
slot draws from that slot's host-side generator, so it runs eagerly and
counts in ``stats["eager_steps"]`` (a prefill samples outside its graph,
so it is always captured; ``stats["prefill_captures"]`` and
``["prefill_replays"]`` count those).  A capture that fails raises with
its cause; nothing falls back to eager quietly.  ``compilations`` counts
the captures per program (on an eager engine, 1 per program that ran),
with the reference's accounting.

Prefix cache (``MemorySpec(prefix_cache=True)``): admission looks the
prompt up in ``core.paging.PrefixCache``'s trie first (at most plen - 1
tokens: the last prompt token always runs, for its logits), maps the hit's
whole blocks into the slot's table (refcounted, shared with the other
holders) and starts its prefill at the hit length.  A hit that ends inside
a cached block forks that block's rows into the slot's first private block
(``kv_quant.fork_block``, a device copy queued on the current stream
before the next step) and drops the source.  A slot's whole prompt blocks
are registered in the trie right after the dispatch that completes its
prefill; releases decref, park trie-owned blocks at refcount zero, and
parked blocks are evicted oldest-first before any request is preempted.
A slot writes only at positions at or past its start, so never into a
block it shares.

Speculative decoding (``RuntimeSpec(speculation=SpeculationSpec(...))``):
a draft model (``load(params, draft=...)`` or ``load_draft``) rides the
same fused step with its own dense cache (``Model.init_dense_cache``, at
``max_batch x max_len``): on the mixed program it first takes the same
prompt chunks, then it proposes k tokens (k one-lane passes at ``index +
j``) and writes the last proposal's K/V; the target verifies ``[last,
d_1..d_k]`` as one chunk-shaped attend over the paged pool (W =
``chunk_size`` on the mixed program, W = k + 1 on the decode one), and
``sampling.speculative_accept`` keeps the accepted prefix plus the
bonus / correction token.  Rollback is an index rewind: ``index``
advances by the tokens kept, the rejected suffix's K/V lie past every
mask until the next step overwrites them.  The host reserves k + 1
positions per step for a decoding slot and at each sync hands back the
blocks past the slot's resident tokens (``_truncate_slot_blocks``:
``allocator.truncate``, then the prefix trie's ``park``, then ``free``).

Multi-topology serving: ``ServingEngine(spec, maxima=...)`` (or a spec
with ``maxima``) runs the register-driven ``serving.fabric`` at the maxima
instead of one fixed model.  ``add_model(params, arch)`` packs a
dense-family model into the fabric's weight table (int8 values and scales
under ``quant="int8"``), each slot carries its model's topology registers
in ``SlotState.topo``, and one fused step serves the mixed fleet;
``submit(..., model=id)`` picks the member.  A fleet speculates as one
model does: the draft (one ``Model`` at the maxima's vocab) proposes for
every slot and the fabric's ``mixed_step`` verifies, so a proposal
outside a small member's vocab meets a NEG_INF logit and is rejected.

Tensor parallelism (``spec.mesh.tp > 1``, the reference's mesh inside one
engine): ``devices=`` lists one torch device per rank, and ranks may share
a device (the one card runs tp = 2 so, and the host tests run ``["cpu"] *
2``); without it the engine takes the first ``tp`` CUDA devices, never the
host, and raises where there are fewer.  The model is then
``models.tensor_parallel.TPModel``: one process drives every rank, the
fused programs stay one capture each (on one shared card, one CUDA graph
over all ranks), and the slot state, the block tables and the host's
staging live on the first rank's device.  Ranks on distinct devices run
eagerly.  Data parallelism (``mesh.dp > 1``) is ``serving.cluster``'s
``EngineCluster``: one engine is one replica.

``ServingEngine(spec, device=None)`` runs on the CUDA device and raises
without one; pass ``device="cpu"`` for the host.  ``seed`` seeds the
per-request generators of stochastic sampling (a request's stream is a
function of ``seed`` and its uid).
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.kv_quant import fork_block
from repro_torch.core.paging import (NULL_BLOCK, BlockAllocator,
                                     FragmentationStats, PrefixCache,
                                     blocks_for_tokens)
from repro_torch.core.kv_quant import last_writer
from repro_torch.core.spec import RuntimeSpec
from repro_torch.kernels.counts import launch_counts
from repro_torch.kernels.runtime import HostStage, resolve_device
from repro_torch.models.model import Model
from repro_torch.models.tensor_parallel import TPModel
from repro_torch.serving.events import EngineEvent, EventBus
from repro_torch.serving.fabric import N_REGS, DecodeFabric, tree_leaves
from repro_torch.serving.events import now as _now
from repro_torch.serving.sampling import (SamplingParams, propose_per_slot,
                                          sample_per_slot,
                                          speculative_accept)

# decode_steps = graph_captures + graph_replays + eager_steps: a capture's
# step runs once eagerly as its warm-up; on an eager engine every step is
# an eager step.  A bucketed prefill is no fused step: its graphs count in
# prefill_captures and prefill_replays
_STAT_KEYS = ("decode_steps", "device_gets", "harvest_elems", "preemptions",
              "prefill_tokens", "max_step_prefill_tokens", "prefix_hits",
              "prefix_hit_tokens", "cow_forks", "prefix_evictions",
              "graph_captures", "graph_replays", "eager_steps",
              "prefill_captures", "prefill_replays",
              "spec_steps", "spec_accepted")
# uploads of tables, grants and sampling rows the host may queue ahead of
# the device before one waits for a staging buffer
_STAGE_DEPTH = 16


class Compilations(dict):
    """Compile-count mapping that is also callable, as the reference's:
    ``engine.compilations["decode"]`` and ``engine.compilations()["decode"]``
    read the same accounting."""

    def __call__(self) -> "Compilations":
        return self


def _buckets(max_len: int, smallest: int = 32) -> list[int]:
    """The bucketed scheduler's prompt-length buckets: powers of two from
    ``smallest`` below ``max_len``, then ``max_len``."""
    out, b = [], smallest
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


@dataclasses.dataclass
class StepGraph:
    """One captured program: the graph, the tensors it reads (held so that
    a replaced one is seen), the launches per kernel wrapper that its
    capture recorded, which each replay makes again, and the tensors it
    returns (a prefill's logits and staging cache; None for a fused step,
    which writes in place)."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple[torch.Tensor, ...]
    launches: dict[str, int]
    outputs: object = None


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None
    sampling: SamplingParams | None = None   # None -> engine default
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int | None = None
    # tokens generated before a preemption; on re-admission they extend
    # the prompt (recompute-resume) and still count against the budget
    prefix: list[int] = dataclasses.field(default_factory=list)
    # fleet member serving this request (multi-topology mode; 0 otherwise)
    model: int = 0


@dataclasses.dataclass
class SlotState:
    """All per-slot decode state, resident on the device."""

    last: torch.Tensor        # [B, 1] i32  token fed to the next decode step
    index: torch.Tensor       # [B]    i32  cache write position
    active: torch.Tensor      # [B]    bool slot is live (prefilling or decoding)
    done: torch.Tensor        # [B]    bool finished, not yet harvested/reused
    budget: torch.Tensor      # [B]    i32  max_new_tokens (incl. prefill token)
    count: torch.Tensor       # [B]    i32  tokens generated so far
    eos: torch.Tensor         # [B]    i32  eos id, -1 = none
    temp: torch.Tensor        # [B]    f32  sampling temperature (0 = greedy)
    top_k: torch.Tensor       # [B]    i32  top-k cutoff (0 = disabled)
    top_p: torch.Tensor       # [B]    f32  nucleus threshold (1 = disabled)
    # [B, max_len + 1] i32 generated tokens; column max_len is a spare
    # that takes the speculative step's writes of lanes it does not emit
    buf: torch.Tensor
    prompt_buf: torch.Tensor  # [B, max_len] i32 prompt tokens, chunk source
    prompt_len: torch.Tensor  # [B] i32 total prompt length
    pf_pos: torch.Tensor      # [B] i32 prompt tokens already in the cache
    topo: torch.Tensor        # [B, N_REGS] i32 topology registers (fleet)
    # speculative-decoding accounting (zeros when speculation is off)
    acc: torch.Tensor         # [B] i32 accepted draft tokens, cumulative
    spec_steps: torch.Tensor  # [B] i32 fused steps this slot spec-decoded in

    @classmethod
    def zeros(cls, batch: int, max_len: int, device) -> "SlotState":
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(last=z(batch, 1), index=z(batch),
                   active=z(batch, dtype=torch.bool),
                   done=z(batch, dtype=torch.bool), budget=z(batch),
                   count=z(batch), eos=z(batch) - 1,
                   temp=z(batch, dtype=torch.float32), top_k=z(batch),
                   top_p=z(batch, dtype=torch.float32) + 1.0,
                   buf=z(batch, max_len + 1),
                   prompt_buf=z(batch, max_len), prompt_len=z(batch),
                   pf_pos=z(batch), topo=z(batch, N_REGS), acc=z(batch),
                   spec_steps=z(batch))


def rank_devices(tp: int, devices=None, device=None) -> list[torch.device]:
    """The device of each of ``tp`` ranks: ``devices`` (one per rank,
    repeats allowed), else ``device`` for one rank, else the first ``tp``
    CUDA devices (never the host; fewer raise)."""
    if devices is not None:
        if device is not None:
            raise ValueError("pass device= (one rank) or devices= (one per "
                             "rank), not both")
        devs = [torch.device(d) for d in devices]
        if len(devs) < tp:
            raise ValueError(
                f"mesh.tp={tp} needs {tp} devices but only {len(devs)} "
                "were given; pass devices= with one device per rank "
                "(launch.mesh.dev_devices repeats one card)")
        return devs[:tp]
    if tp == 1:
        return [resolve_device(device)]
    if device is not None:
        raise ValueError(
            f"mesh.tp={tp} runs one rank per device: pass devices= (e.g. "
            f"['cpu'] * {tp} on the host, or launch.mesh.dev_devices({tp}, "
            f"allow_repeat=True) on one card), not device={device!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < tp:
        raise ValueError(
            f"mesh.tp={tp} needs {tp} devices but only {n} are visible; "
            "pass devices= with one device per rank "
            f"(launch.mesh.dev_devices({tp}, allow_repeat=True) repeats "
            "one card)")
    return [torch.device("cuda", i) for i in range(tp)]


class ServingEngine:
    _STEPS = ("mixed", "decode")        # the fused programs

    def __init__(self, spec: RuntimeSpec, *, maxima=None,
                 max_models: int = 4, device=None, devices=None,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 graphs: bool | None = None):
        if not isinstance(spec, RuntimeSpec):
            raise TypeError("ServingEngine expects a repro_torch.core.spec."
                            f"RuntimeSpec, got {type(spec).__name__}")
        if maxima is not None:
            spec = dataclasses.replace(spec, maxima=maxima)
        if spec.arch.family == "encoder":
            raise ValueError("encoder-only archs have no decode step")
        if spec.mesh.dp > 1:
            raise ValueError(
                f"spec.mesh.dp={spec.mesh.dp}: data parallelism is replica-"
                "level — construct serving.cluster.EngineCluster(spec) (one "
                "ServingEngine is a single replica; EngineCluster passes "
                "each replica its device slice via devices=)")
        self.devices = rank_devices(spec.mesh.tp, devices, device)
        self.device = self.devices[0]
        one_device = len(set(self.devices)) == 1
        if graphs is None:
            graphs = self.device.type == "cuda" and one_device
        if graphs and self.device.type != "cuda":
            raise ValueError(
                f"graphs=True needs a CUDA device (got {self.device}); the "
                "fused steps run eagerly on the host")
        if graphs and not one_device:
            raise ValueError(
                f"graphs=True captures one device's work; the ranks sit on "
                f"{self.devices} (pass graphs=False)")
        self.graphs = graphs
        self.spec = spec
        self.cfg: ArchConfig = spec.arch
        self.max_batch = spec.memory.max_batch
        self.max_len = spec.memory.max_len
        self.sampling = sampling
        self.seed = seed
        self.scheduler = spec.resolved_policy     # "chunked" | "bucketed"
        if spec.mesh.tp > 1 and self.scheduler != "chunked":
            raise ValueError(
                "mesh.tp > 1 requires the chunked scheduler, but policy "
                "'auto' resolved to 'bucketed' for this spec (the "
                "bucketed path stages B=1 prefill caches off-mesh); fix "
                "the chunk geometry so chunked is satisfiable")
        self.buckets = _buckets(self.max_len)
        self.chunk_size = min(spec.scheduler.chunk_size, self.max_len)
        self.token_budget = spec.scheduler.resolved_token_budget
        self.fabric: DecodeFabric | None = None
        self.model: Model | None = None
        if spec.maxima is not None:
            # multi-topology mode: one step at the maxima serves a fleet of
            # models selected by per-slot registers (add_model)
            ex = spec.execution
            if ex.matmul_backend != "xla":
                raise ValueError(
                    f"matmul_backend={ex.matmul_backend!r} is not yet "
                    "supported in multi-topology mode: the fabric's per-slot "
                    "weight gathers do not route through the tiled-kernel "
                    "backend (use the default 'xla'; for quantized fleet "
                    "serving use ExecutionSpec(quant='int8'): the fabric "
                    "packs an int8 weight table itself)")
            self.fabric = DecodeFabric(
                spec.maxima, max_models, self.cfg,
                compute_dtype=ex.compute_dtype, param_dtype=ex.param_dtype,
                quant=ex.quant, quant_min_size=ex.quant_min_size,
                kv_dtype=spec.memory.kv_dtype, device=self.device)
            self.fabric.check_member(self.cfg)
            self.fleet: list[ArchConfig | None] = [None] * max_models
            self._fleet_rows: list[list[int] | None] = [None] * max_models
        elif spec.mesh.tp > 1:
            self.model = TPModel.from_spec(spec, self.devices)
        else:
            self.model = Model.from_spec(spec, device=self.device)
        # speculation: the draft decodes from its own dense cache inside
        # the fused step; ``spec_horizon`` (k + 1) is the positions a
        # decoding slot may take per step, which block budgeting scales by
        sp = spec.speculation
        self.speculation = sp
        self.spec_horizon = 1 if sp is None else sp.horizon
        self.draft_model: Model | None = None
        self.draft_cache = None
        if sp is not None:
            ex = spec.execution
            self.draft_model = Model(
                sp.draft_model, param_dtype=ex.param_dtype,
                compute_dtype=ex.compute_dtype,
                matmul_backend=ex.matmul_backend,
                paged_attn_impl=ex.paged_attn_impl, quant=ex.quant,
                quant_min_size=ex.quant_min_size, device=self.device)

        self.paging = spec.memory.paging()
        self.allocator = self.prefix_cache = self.block_tables = None
        self.blocks_per_slot = 0
        if self.paging is not None:
            bs = self.paging.block_size
            if self.buckets[0] % bs:
                raise ValueError(
                    f"block_size={bs} must divide the smallest prefill "
                    f"bucket {self.buckets[0]}")
            self.allocator = BlockAllocator(self.paging)
            self.blocks_per_slot = self.max_len // bs
            self.block_tables = torch.zeros(
                (self.max_batch, self.blocks_per_slot), dtype=torch.int32,
                device=self.device)
            if spec.memory.prefix_cache:
                self.prefix_cache = PrefixCache(self.allocator)
        self._tables = [[NULL_BLOCK] * self.blocks_per_slot
                        for _ in range(self.max_batch)]
        self._slot_blocks: list[list[int]] = [[] for _ in range(self.max_batch)]
        self._tables_dirty = self.paging is not None
        # one-shot per occupancy: a slot's prompt blocks are registered in
        # the trie once its prefill completes
        self._reg_done = [False] * self.max_batch
        # host mirrors for block budgeting (exact at sync points; between
        # syncs ``_idx_ub`` is a per-step upper bound on the device index)
        self._plen = [0] * self.max_batch
        self._budget = [0] * self.max_batch
        self._idx_ub = [0] * self.max_batch
        self._admit_seq = [0] * self.max_batch
        self._seq = 0
        # chunked-prefill progress mirror: exact, the host grants every chunk
        self._pf = [0] * self.max_batch
        # per-slot generator for stochastic slots, None for greedy ones, and
        # the device index of those slots (rebuilt when the list changes)
        self._gens: list[torch.Generator | None] = [None] * self.max_batch
        self._rows_buf = torch.zeros(self.max_batch, dtype=torch.int32,
                                     device=self.device)
        self._rows_key: tuple[int, ...] = ()
        self._one_row = torch.zeros(1, dtype=torch.long, device=self.device)
        self._grants = torch.zeros(self.max_batch, dtype=torch.int32,
                                   device=self.device)
        # the bucketed admission's device inputs: each bucket's padded
        # prompt [1, bucket] and the prompt's length [1], the admitted
        # member's topology registers and the slot's block-table row
        # (paged), the stub frontend's zeros
        self._bucket_tokens: dict[int, torch.Tensor] = {}
        self._admit_len = torch.zeros(1, dtype=torch.int32,
                                      device=self.device)
        self._admit_topo = torch.zeros(N_REGS, dtype=torch.int32,
                                       device=self.device)
        self._admit_row = torch.zeros(self.blocks_per_slot, dtype=torch.int32,
                                      device=self.device)
        self._frontend = None
        if self.cfg.frontend is not None and self.fabric is None:
            self._frontend = torch.zeros(
                (1, self.cfg.frontend.num_tokens, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        self._stages = {
            "grants": HostStage(self.max_batch, self.device, _STAGE_DEPTH),
            "rows": HostStage(self.max_batch, self.device, _STAGE_DEPTH),
            # one admitted prompt, its length, its topology row and
            # block-table row
            "admit": HostStage(self.max_len + 1 + N_REGS
                               + self.blocks_per_slot,
                               self.device, 2 * self.max_batch)}
        if self.paging is not None:
            self._stages["tables"] = HostStage(self.block_tables.numel(),
                                               self.device, _STAGE_DEPTH)

        # the fleet's weight table exists before any model is loaded:
        # add_model only writes device data into it
        self.table = self.fabric.init_table() if self.fabric else None
        self.cache = self.fabric.init_cache(
            self.paging, batch=self.max_batch, max_len=self.max_len) \
            if self.fabric else None
        self.state = SlotState.zeros(self.max_batch, self.max_len, self.device)
        self.slot_req: list[Request | None] = [None] * self.max_batch
        self.queue: list[Request] = []
        self._uid = 0
        self.stats = dict.fromkeys(_STAT_KEYS, 0)
        self.events = EventBus()
        self._ft_emitted: set[int] = set()
        # the fused programs: their graphs (graphed engine), the captures
        # (graphed) or 1 once run (eager) per program, the pool and the
        # side stream of the captures, and the kernel launches the captures
        # recorded and the replays made (phase 5 of chip_smoke.py reads
        # them: a wrapper counts a launch at capture, not at replay)
        self._graphs: dict[str, StepGraph] = {}
        # "mixed", "decode" and one "prefill:<bucket>" per bucket used
        self._programs = dict.fromkeys(self._STEPS, 0)
        self._graph_pool = None
        self._graph_stream: torch.cuda.Stream | None = None
        self.captured_launches: collections.Counter = collections.Counter()
        self.replayed_launches: collections.Counter = collections.Counter()

    # ------------------------------------------------------------------
    def _emit(self, kind: str, uid: int, **data) -> None:
        if self.events.active:
            self.events.publish(EngineEvent(
                kind, uid, self.stats["decode_steps"], _now(), data))

    def _emit_first_token(self, uid: int) -> None:
        if self.events.active and uid not in self._ft_emitted:
            self._ft_emitted.add(uid)
            self.events.publish(EngineEvent(
                "first_token", uid, self.stats["decode_steps"], _now(), {}))

    def load(self, params, draft=None) -> None:
        """Install weights (a state dict of the port's ``Model``, e.g. from
        ``Model.init(...).state_dict()`` or ``bridge.from_jax_params``) and
        allocate the cache (the paged pool or the dense layout) through the
        spec's cache codec.  Under
        ``spec.execution.quant="int8"`` float weights are quantized here
        (the model's ``load_state_dict`` applies
        ``core.serve_quant.quantize_params`` at ``quant_min_size``), as the
        reference's ``load`` does.  Multi-topology mode: ``add_model`` for
        the engine's own architecture (float weights; the fabric quantizes
        its table rows).  ``draft`` installs the speculation draft's weights
        in the same call (``load_draft``)."""
        if draft is not None and self.speculation is None:
            raise ValueError(
                "load(draft=...) requires spec.speculation — construct the "
                "RuntimeSpec with speculation=SpeculationSpec(...)")
        if self.fabric is not None:
            self.add_model(params)
        else:
            self._graphs.clear()      # they read the pool this replaces
            self.model.load_state_dict(params)
            self.cache = self.model.init_cache(
                self.paging, batch=self.max_batch, max_len=self.max_len)
        if draft is not None:
            self.load_draft(draft)

    def load_draft(self, params) -> None:
        """Install the speculation draft's weights (a state dict of the
        port's ``Model(spec.speculation.draft_model)``; quantized as they
        load under ``quant="int8"``, as the target's) and allocate its
        private dense cache at ``max_batch x max_len``.  The draft's cache
        never pages and never quantizes: it is small, and rolling back a
        rejected suffix is an index rewind alone."""
        if self.speculation is None:
            raise ValueError(
                "load_draft requires spec.speculation — construct the "
                "RuntimeSpec with speculation=SpeculationSpec(...)")
        self._graphs.clear()      # they read the cache this call replaces
        self.draft_model.load_state_dict(params)
        self.draft_cache = self.draft_model.init_dense_cache(self.max_batch,
                                                             self.max_len)

    def add_model(self, params, arch: ArchConfig | None = None) -> int:
        """Pack one fleet member's weights (a state dict of the port's
        ``Model(arch)``) into the fabric's model table and return its model
        id (pass it to ``submit(..., model=id)``).  A copy into the table,
        never a new step."""
        if self.fabric is None:
            raise ValueError(
                "add_model requires multi-topology mode — construct the "
                "engine with ServingEngine(spec, maxima=...)")
        if isinstance(arch, RuntimeSpec):
            arch = arch.arch
        arch = arch or self.cfg
        mid = next((i for i, a in enumerate(self.fleet) if a is None), None)
        if mid is None:
            raise ValueError(
                f"model table full ({self.fabric.max_models} rows); "
                "construct the engine with a larger max_models")
        row = self.fabric.pack_member(arch, params)
        self.table = self.fabric.insert_model(self.table, row, mid)
        self.fleet[mid] = arch
        self._fleet_rows[mid] = self.fabric.topo_row(arch, mid)
        return mid

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               eos_id: int | None = None,
               sampling: SamplingParams | None = None,
               model: int = 0) -> int:
        if not prompt:
            raise ValueError("empty prompt: the engine needs at least one "
                             "token to condition on")
        if len(prompt) > self.max_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_len={self.max_len}")
        if len(prompt) == self.max_len and max_new_tokens > 1:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no cache position for "
                f"decode (max_len={self.max_len}); max_new_tokens must be 1")
        if self.paging is not None:
            need = blocks_for_tokens(len(prompt), self.paging.block_size)
            if need > self.paging.num_blocks:
                raise ValueError(
                    f"prompt needs {need} blocks but the pool has only "
                    f"{self.paging.num_blocks}; increase num_blocks")
        if self.fabric is not None:
            if not 0 <= model < len(self.fleet) or self.fleet[model] is None:
                loaded = [i for i, a in enumerate(self.fleet) if a is not None]
                raise ValueError(f"model id {model} is not loaded "
                                 f"(loaded ids: {loaded}); call add_model")
            vocab = self.fleet[model].vocab_size
            if not all(0 <= t < vocab for t in prompt):
                raise ValueError(
                    f"prompt contains token ids outside model {model}'s "
                    f"vocab [0, {vocab})")
        elif model != 0:
            raise ValueError("submit(model=...) requires multi-topology "
                             "mode (ServingEngine(spec, maxima=...))")
        else:
            vocab = self.cfg.vocab_size
            if not all(0 <= t < vocab for t in prompt):
                # an out-of-range id would index past the table, or, with
                # the vocabulary split over tp ranks, match no rank's rows
                raise ValueError(
                    f"prompt contains token ids outside vocab [0, {vocab})")
        self._uid += 1
        self.queue.append(Request(self._uid, list(prompt), max_new_tokens,
                                  eos_id, sampling, model=model))
        self._emit("submit", self._uid, prompt_len=len(prompt),
                   max_new_tokens=max_new_tokens, model=model)
        return self._uid

    # ------------------------------------------------------------------
    # device steps (in place on the pool and the slot state)
    # ------------------------------------------------------------------
    def _finish(self, st: SlotState, emit: torch.Tensor, toks: torch.Tensor,
                index: torch.Tensor) -> None:
        """Scatter the sampled tokens of emitting slots, advance counts and
        raise the finish flags (shared tail of both fused steps)."""
        rows = torch.arange(self.max_batch, device=self.device)
        pos = st.count.clamp(max=self.max_len - 1).long()
        st.buf[rows, pos] = torch.where(emit, toks, st.buf[rows, pos])
        count = st.count + emit.to(torch.int32)
        hit_eos = emit & (st.eos >= 0) & (toks == st.eos)
        finish = emit & (hit_eos | (count >= st.budget)
                         | (index >= self.max_len))
        st.last.copy_(torch.where(emit[:, None], toks[:, None], st.last))
        st.index.copy_(index)
        st.active &= ~finish
        st.done |= finish
        st.count.copy_(count)

    @torch.no_grad()
    def _decode_impl(self) -> None:
        """The one-lane fused step: decode -> sample -> scatter token ->
        advance indices/budgets -> raise done flags.  With speculation on
        the steady-state decode program is the speculative step with no
        prompt lanes (``decode_only``)."""
        if self.speculation is not None:
            self._spec_impl(None, decode_only=True)
            return
        st = self.state
        if self.fabric is not None:
            logits = self.fabric.decode_step(
                self.table, self.cache, st.last, st.index, st.topo,
                self.block_tables, self.spec.execution.paged_attn_impl)
        else:
            logits = self.model.decode_step(self.cache, st.last, st.index,
                                            self.block_tables)
        toks = sample_per_slot(logits[:, 0], st.temp, st.top_k, st.top_p,
                               self._gens, self._sample_rows())
        act = st.active
        self._finish(st, act, toks, st.index + act.to(torch.int32))

    @torch.no_grad()
    def _mixed_impl(self, chunk_len: torch.Tensor) -> None:
        """The fused mixed step of the chunked scheduler: every slot
        advances by up to W lanes (its next prompt chunk, its next decode
        token, or nothing), then samples and advances."""
        if self.speculation is not None:
            self._spec_impl(chunk_len, decode_only=False)
            return
        st = self.state
        W = self.chunk_size
        prefilling = chunk_len > 0
        decoding = st.active & (st.pf_pos >= st.prompt_len)
        n_live = torch.where(prefilling, chunk_len,
                             decoding.to(torch.int32))
        start = torch.where(prefilling, st.pf_pos, st.index)
        lanes = torch.arange(W, device=self.device, dtype=torch.int32)
        gidx = (start[:, None] + lanes[None, :]).clamp(max=self.max_len - 1)
        ptoks = st.prompt_buf.gather(1, gidx.long())
        dtoks = torch.nn.functional.pad(st.last, (0, W - 1))
        toks = torch.where(prefilling[:, None], ptoks, dtoks)
        if self.fabric is not None:
            logits = self.fabric.mixed_step(
                self.table, self.cache, toks, start, n_live, st.topo,
                self.block_tables, self.spec.execution.paged_attn_impl)
        else:
            logits = self.model.mixed_step(self.cache, toks, start, n_live,
                                           self.block_tables,
                                           prefill_lanes=prefilling)
        # sampling lane: a completing prompt's last live lane, else 0
        completes = prefilling & (st.pf_pos + chunk_len >= st.prompt_len)
        sel = torch.where(completes, chunk_len - 1, 0).long()
        rows = torch.arange(self.max_batch, device=self.device)
        toks_s = sample_per_slot(logits[rows, sel], st.temp, st.top_k,
                                 st.top_p, self._gens, self._sample_rows())
        st.pf_pos += torch.where(prefilling, chunk_len, 0)
        self._finish(st, decoding | completes, toks_s, st.index + n_live)

    @torch.no_grad()
    def _spec_impl(self, chunk_len: torch.Tensor | None,
                   decode_only: bool) -> None:
        """The speculative fused step (the reference's ``_spec_impl``):
        draft-propose -> target-verify -> accept / rollback, in place on
        the pool, the draft's dense cache and the slot state.

        Per decoding slot the draft proposes k tokens (one live lane per
        pass, at ``index + j``) and a write-only pass parks the last
        proposal's K/V at ``index + k``; the target scores ``[last, d_1 ..
        d_k]`` at ``index .. index + k`` in one W-lane pass through the
        cache (lanes past the cache end, ``n_spec``, are dead); the
        accepted prefix plus the bonus / correction token, cut by the
        budget and at an EOS, is emitted, and ``index`` advances by what
        was emitted.  ``decode_only`` is the steady-state specialisation:
        no prompt lanes, so no draft prompt pass and W = k + 1.  On the
        mixed program the draft first takes the same prompt chunks, and a
        completing prompt samples its first token from the verify pass's
        logits, as the plain mixed step does."""
        if self.draft_cache is None:
            raise ValueError("speculation needs the draft's weights: "
                             "load(params, draft=...) or load_draft(...)")
        st, dev = self.state, self.device
        B, k, L = self.max_batch, self.speculation.k, self.max_len
        greedy_mode = self.speculation.greedy_accept
        W = self.spec_horizon if decode_only else self.chunk_size
        rows_s = self._sample_rows()
        prefilling = torch.zeros(B, dtype=torch.bool, device=dev) \
            if decode_only else chunk_len > 0
        decoding = st.active & (st.pf_pos >= st.prompt_len)
        start = torch.where(prefilling, st.pf_pos, st.index)
        draft, d_cache = self.draft_model, self.draft_cache
        if not decode_only:
            # the draft's cache takes the prompt before it can propose (a
            # prefix-cache hit skips positions for the target only, as in
            # the reference: acceptance degrades over the reused span)
            lanes = torch.arange(W, device=dev, dtype=torch.int32)
            gidx = (start[:, None] + lanes[None, :]).clamp(max=L - 1)
            ptoks = st.prompt_buf.gather(1, gidx.long())
            draft.mixed_step(d_cache, ptoks, start,
                             torch.where(prefilling, chunk_len, 0),
                             prefill_lanes=prefilling)
        # k proposals, one live lane each (dead lanes write nothing that a
        # mask admits, so idle and prefilling slots keep their cache)
        dec1 = decoding.to(torch.int32)
        cur = st.last
        proposals, dlogits = [], []
        for j in range(k):
            dl = draft.mixed_step(d_cache, cur, st.index + j, dec1)[:, 0]
            d = dl.argmax(dim=-1).to(torch.int32) if greedy_mode \
                else propose_per_slot(dl, st.temp, self._gens, rows_s)
            proposals.append(d)
            dlogits.append(dl)
            cur = d[:, None]
        # the write-only pass: d_k's K/V at index + k, so a fully accepted
        # step leaves no hole in the draft's cache
        draft.mixed_step(d_cache, cur, st.index + k, dec1)
        d_toks = torch.stack(proposals, dim=1)                  # [B, k]
        d_logits = None if greedy_mode else torch.stack(dlogits, dim=1)
        ver = torch.cat([st.last, d_toks], dim=1)               # [B, k+1]
        toks = torch.nn.functional.pad(ver, (0, W - (k + 1)))
        n_spec = (L - st.index).clamp(0, k + 1)
        n_live = torch.where(decoding, n_spec, 0)
        if not decode_only:
            n_live = torch.where(prefilling, chunk_len, n_live)
            toks = torch.where(prefilling[:, None], ptoks, toks)
        if self.fabric is not None:
            # the fleet's verify: dead kv groups and vocab lanes masked per
            # slot (live_kv at W = k + 1 on the decode program)
            logits = self.fabric.mixed_step(
                self.table, self.cache, toks, start, n_live, st.topo,
                self.block_tables, self.spec.execution.paged_attn_impl)
        else:
            logits = self.model.mixed_step(self.cache, toks, start, n_live,
                                           self.block_tables,
                                           prefill_lanes=prefilling)
        n_acc, out = speculative_accept(logits[:, :k + 1], d_toks, d_logits,
                                        st.temp, self._gens, rows_s,
                                        greedy=greedy_mode)
        n_acc = torch.minimum(n_acc, (n_spec - 1).clamp(min=0))
        jar = torch.arange(k + 1, device=dev, dtype=torch.int32)[None, :]
        cand = (jar <= n_acc[:, None]) & decoding[:, None]
        room = st.count[:, None] + jar < st.budget[:, None]
        is_eos = (st.eos[:, None] >= 0) & (out == st.eos[:, None])
        stop = (cand & room & is_eos).to(torch.int32)
        # the emitted lanes are a prefix: the room and EOS cuts are
        # monotone in j
        valid = cand & room & (stop.cumsum(dim=1) - stop == 0)
        m = valid.sum(dim=1).to(torch.int32)
        # lanes not emitted write into buf's spare column L (a clamped
        # where-write would race a valid lane's at L - 1)
        st.buf.scatter_(1, torch.where(valid, st.count[:, None] + jar,
                                       L).long(), out)
        count = st.count + m
        index = st.index + torch.where(decoding, m, 0)
        last_dec = out.gather(1, (m - 1).clamp(min=0)[:, None].long())[:, 0]
        lastv = torch.where(decoding, last_dec, st.last[:, 0])
        emit = decoding
        hit_eos = stop.bool().any(dim=1)
        if not decode_only:
            completes = prefilling & (st.pf_pos + chunk_len >= st.prompt_len)
            sel = torch.where(completes, chunk_len - 1, 0).long()
            toks_s = sample_per_slot(
                logits[torch.arange(B, device=dev), sel], st.temp, st.top_k,
                st.top_p, self._gens, rows_s)
            st.buf.scatter_(1, torch.where(completes, count, L)[:, None]
                            .long(), toks_s[:, None])
            count = count + completes.to(torch.int32)
            index = index + torch.where(prefilling, chunk_len, 0)
            st.pf_pos += torch.where(prefilling, chunk_len, 0)
            lastv = torch.where(completes, toks_s, lastv)
            emit = emit | completes
            hit_eos = hit_eos | (completes & (st.eos >= 0)
                                 & (toks_s == st.eos))
        finish = emit & (hit_eos | (count >= st.budget) | (index >= L))
        st.last.copy_(lastv[:, None])
        st.index.copy_(index)
        st.active &= ~finish
        st.done |= finish
        st.count.copy_(count)
        st.acc += torch.where(decoding, (m - 1).clamp(min=0), 0)
        st.spec_steps += decoding.to(torch.int32)

    # ------------------------------------------------------------------
    # host-side control
    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Seat waiting requests in free slots (FCFS: the queue head waits
        for blocks rather than being overtaken), through the scheduler's
        admission: ``_admit_chunked`` or ``_admit_bucketed``."""
        if self.scheduler == "chunked":
            self._admit_chunked()
        else:
            self._admit_bucketed()

    def _admit_chunked(self) -> None:
        """Token-budget admission: seat a request by writing its prompt into
        the device-resident chunk source; the fused mixed step earns its
        first token once the scheduler has granted all its chunks."""
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            prompt = req.prompt + req.prefix
            plen = len(prompt)
            budget = req.max_new_tokens - len(req.prefix)
            start = 0
            if self.paging is not None:
                total = blocks_for_tokens(plen, self.paging.block_size)
                if self.prefix_cache is not None:
                    # look up before allocating: the hit's blocks are
                    # pinned (incref + unpark) so an eviction the
                    # allocation makes cannot reclaim them; the last prompt
                    # token always runs
                    hit = self.prefix_cache.lookup(
                        self._namespace(req.model), prompt, plen - 1)
                    self.prefix_cache.acquire(hit)
                    fresh = self._alloc_blocks(total - len(hit.blocks))
                    if fresh is None:
                        self.prefix_cache.release(hit)
                        break   # FCFS: the queue head waits for blocks
                    blocks = hit.blocks + fresh
                    start = hit.tokens
                    if hit.fork_block is not None:
                        # mid-block divergence: fork the partial source
                        # into the first private block, then unpin it
                        fork_block(self.cache, hit.fork_block, fresh[0])
                        self.prefix_cache.drop_fork_source(hit)
                        start += hit.fork_tokens
                        self.stats["cow_forks"] += 1
                    if start:
                        self.stats["prefix_hits"] += 1
                        self.stats["prefix_hit_tokens"] += start
                else:
                    blocks = self.allocator.alloc(total)
                    if blocks is None:
                        break   # FCFS: the queue head waits for blocks
                self._set_table(slot, blocks)
            self.queue.pop(0)
            st = self.state
            self._stages["admit"].put(
                (st.prompt_buf[slot], prompt + [0] * (self.max_len - plen)),
                (st.topo[slot], self._topo(req)))
            # positions below ``start`` (a prefix hit) are in the mapped
            # blocks already: prefill resumes there, as after a chunk
            self._seat(slot, req, plen, budget, start)
            st.last[slot] = 0
            for field, value in (("index", start), ("active", True),
                                 ("done", False), ("count", 0),
                                 ("pf_pos", start)):
                getattr(st, field)[slot] = value
            st.buf[slot].zero_()
            self._emit("admit", req.uid, slot=slot, cached_tokens=start)

    def _admit_bucketed(self) -> None:
        """Bucketed admission: pad the prompt up to its bucket, prefill it
        at B = 1 (``_prefill``), copy the staging cache into the slot's
        rows of the dense cache or, in whole blocks, into the slot's pool
        blocks (``_insert``), and sample the first token on the device from
        the prefill's logits (``_admit_slot``).  The prompt, its length,
        the topology registers and the block-table row go up through
        ``HostStage``."""
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            prompt = req.prompt + req.prefix
            plen = len(prompt)
            budget = req.max_new_tokens - len(req.prefix)
            bucket = next((b for b in self.buckets if b >= plen), None)
            if bucket is None:
                raise ValueError(
                    f"prompt length {plen} exceeds max_len={self.max_len}")
            blocks: list[int] | None = None
            if self.paging is not None:
                # block-budget admission: seat the request iff its prompt's
                # blocks are free now
                blocks = self.allocator.alloc(blocks_for_tokens(
                    plen, self.paging.block_size))
                if blocks is None:
                    break
            self.queue.pop(0)
            if bucket not in self._bucket_tokens:
                self._bucket_tokens[bucket] = torch.zeros(
                    (1, bucket), dtype=torch.int32, device=self.device)
            pairs = [(self._bucket_tokens[bucket],
                      prompt + [0] * (bucket - plen)),
                     (self._admit_len, [plen]),
                     (self._admit_topo, self._topo(req))]
            if blocks is not None:
                self._set_table(slot, blocks)
                pairs.append((self._admit_row, self._tables[slot]))
            self._stages["admit"].put(*pairs)
            logits, one = self._prefill(bucket)
            self._insert(one, slot, bucket)
            self._seat(slot, req, plen, budget, plen)
            self._admit_slot(slot, logits[:, plen - 1], plen, budget,
                             -1 if req.eos_id is None else req.eos_id)
            self._emit("admit", req.uid, slot=slot, cached_tokens=0)
            # the bucketed prefill samples the first token itself
            self._emit_first_token(req.uid)

    def _topo(self, req: Request) -> list[int]:
        """The slot's topology registers (zeros for one fixed model)."""
        return self._fleet_rows[req.model] if self.fabric is not None \
            else [0] * N_REGS

    def _set_table(self, slot: int, blocks: list[int]) -> None:
        self._slot_blocks[slot] = blocks
        self._tables[slot] = blocks + [NULL_BLOCK] * (
            self.blocks_per_slot - len(blocks))
        self._tables_dirty = True

    def _seat(self, slot: int, req: Request, plen: int, budget: int,
              start: int) -> None:
        """The per-slot fields both admissions set (the device's from host
        values, queued without a wait) and the host mirrors; ``start`` is
        where prefill resumes (a prefix hit's length, or ``plen`` once a
        bucketed prefill wrote the prompt)."""
        sp = req.sampling or self.sampling
        st = self.state
        for field, value in (
                ("budget", budget),
                ("eos", -1 if req.eos_id is None else req.eos_id),
                ("temp", sp.temperature), ("top_k", sp.top_k),
                ("top_p", sp.top_p), ("prompt_len", plen), ("acc", 0),
                ("spec_steps", 0)):
            getattr(st, field)[slot] = value
        self._gens[slot] = None
        if sp.temperature > 0:
            # one stream per request: a function of (seed, uid) alone
            g = torch.Generator(device=self.device)
            g.manual_seed(self.seed * 1_000_003 + req.uid)
            self._gens[slot] = g
        req.slot = slot
        self.slot_req[slot] = req
        self._plen[slot] = plen
        self._budget[slot] = budget
        # the token budget is charged only for the uncached suffix
        self._idx_ub[slot] = start
        self._pf[slot] = start
        self._reg_done[slot] = False
        self._seq += 1
        self._admit_seq[slot] = self._seq

    @torch.no_grad()
    def _prefill(self, bucket: int):
        """The B = 1 prefill of the staged prompt of ``bucket`` tokens ->
        (float32 logits [1, bucket, V], its staging cache with ``cache_len``
        rows + the spare: the bucket over the paged pool, ``max_len`` over
        the dense layout), one CUDA graph per bucket on a graphed engine;
        the prompt's staged length is the model's ``lengths``."""
        cache_len = bucket if self.paging is not None else self.max_len
        tokens = self._bucket_tokens[bucket]
        if self.fabric is not None:
            def impl():
                return self.fabric.prefill(self.table, self._admit_topo,
                                           tokens, cache_len)
            inputs = (tokens, self._admit_topo, *tree_leaves(self.table))
        else:
            def impl():
                return self.model.prefill(tokens, cache_len, self._frontend,
                                          lengths=self._admit_len)
            inputs = (tokens, self._admit_len)
        return self._run(f"prefill:{bucket}", impl, inputs=inputs)

    @torch.no_grad()
    def _insert(self, one, slot: int, bucket: int) -> None:
        """Copy a B = 1 staging cache into the engine's cache (the
        reference's ``_insert_impl`` / ``_insert_paged_impl``): every row
        into the slot's rows of the dense layout, or the bucket's rows in
        whole blocks into the slot's table row (the staged ``_admit_row``);
        chunks past the prompt's blocks go to the null block, each
        destination taking one row's bytes (``kv_quant.last_writer``)."""
        if self.paging is None:
            for g, o in zip(self.cache, one):
                if g is not None:
                    g[:, slot].copy_(o[:, 0])
            return
        bs = self.paging.block_size
        nchunks = bucket // bs
        blk = self._admit_row[:nchunks].long().repeat_interleave(bs)
        off = torch.arange(bs, device=self.device).repeat(nchunks)
        src = last_writer((blk, off), bs, self.paging.pool_blocks)
        for g, o in zip(self.cache, one):
            if g is not None:
                g[:, blk, off] = o[:, 0, src].to(g.dtype)

    @torch.no_grad()
    def _admit_slot(self, slot: int, last_logits: torch.Tensor, plen: int,
                    budget: int, eos: int) -> None:
        """Seat a prefilled request (the reference's ``_admit_slot_impl``):
        sample its first token from ``last_logits`` [1, V] on the device
        and set its slot's fields; a 1-token budget, a first token that is
        the eos, or a ``max_len`` prompt finish it at once."""
        st = self.state
        rows = None if self._gens[slot] is None else self._one_row
        first = sample_per_slot(last_logits, st.temp[slot:slot + 1],
                                st.top_k[slot:slot + 1],
                                st.top_p[slot:slot + 1], [self._gens[slot]],
                                rows)
        fin = ((first == eos) & (eos >= 0)) \
            | (budget <= 1 or plen >= self.max_len)
        st.last[slot] = first
        st.index[slot] = plen
        st.active[slot] = ~fin
        st.done[slot] = fin
        st.count[slot] = 1
        st.buf[slot].zero_()
        st.buf[slot, :1] = first
        st.pf_pos[slot] = plen
        st.topo[slot].copy_(self._admit_topo)

    def _grant_chunks(self) -> list[int]:
        """Up to ``token_budget`` prompt tokens per fused step, at most
        ``chunk_size`` per slot, split fairly across the prefilling slots;
        leftover budget goes FCFS by admission order."""
        grants = [0] * self.max_batch
        order = [s for s in sorted(self._occupied(),
                                   key=lambda t: self._admit_seq[t])
                 if self._pf[s] < self._plen[s]]
        if not order:
            return grants
        share = max(min(self.token_budget // len(order), self.chunk_size), 1)
        left = self.token_budget
        for cap in (share, self.chunk_size):   # fair pass, then leftovers
            for slot in order:
                rem = self._plen[slot] - self._pf[slot] - grants[slot]
                g = min(cap - grants[slot], rem, left)
                if g <= 0:
                    continue
                grants[slot] += g
                left -= g
        return grants

    def _occupied(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def _namespace(self, model: int):
        """Prefix-trie namespace of one request's KV blocks.  Fleet
        members share the physical pool but never a trie chain: a
        prompt's KV is a function of the model that prefilled it."""
        if self.fabric is not None:
            return self.fabric.cache_namespace(self.fleet[model], model)
        return 0

    def _alloc_blocks(self, n: int) -> list[int] | None:
        """``allocator.alloc`` with the LRU eviction tier behind it: when
        the free list cannot cover ``n``, parked blocks (unreferenced but
        in the trie) are evicted oldest-first before the caller falls back
        to preempting live requests."""
        got = self.allocator.alloc(n)
        if got is None and self.prefix_cache is not None:
            freed = self.prefix_cache.evict(n - self.allocator.num_free)
            if freed:
                self.stats["prefix_evictions"] += freed
                got = self.allocator.alloc(n)
        return got

    def _slot_token_cap(self, slot: int) -> int:
        """Most cache positions this slot can ever need (then it finishes)."""
        return min(self._plen[slot] + self._budget[slot] - 1, self.max_len)

    def _ensure_capacity(self, horizon: int) -> None:
        """Pre-reserve blocks so the next ``horizon`` fused steps cannot
        write outside a slot's blocks.  Oldest slots are served first; when
        the pool runs dry the most recently admitted slot is preempted.  A
        speculative step writes up to ``spec_horizon`` (k + 1) verify
        positions, so the window scales by it; the tails it over-reserves
        are handed back at the next sync (``_truncate_slot_blocks``).  The
        dense layout has nothing to reserve."""
        if self.paging is None:
            return
        bs = self.paging.block_size
        horizon *= self.spec_horizon
        for slot in sorted(self._occupied(),
                           key=lambda s: self._admit_seq[s]):
            if self.slot_req[slot] is None:   # preempted by an earlier turn
                continue
            if self._pf[slot] < self._plen[slot]:
                need_tokens = min(self._plen[slot] + horizon - 1,
                                  self._slot_token_cap(slot))
            else:
                need_tokens = min(self._idx_ub[slot] + horizon,
                                  self._slot_token_cap(slot))
            missing = blocks_for_tokens(need_tokens, bs) \
                - len(self._slot_blocks[slot])
            while missing > 0:
                got = self._alloc_blocks(missing)
                if got is not None:
                    n_have = len(self._slot_blocks[slot])
                    self._slot_blocks[slot] += got
                    self._tables[slot][n_have:n_have + len(got)] = got
                    self._tables_dirty = True
                    break
                victims = [s for s in self._occupied() if s != slot]
                if not victims:
                    raise RuntimeError(
                        f"paged pool exhausted: {missing} more blocks needed "
                        f"for slot {slot} with no other slot to preempt — "
                        f"num_blocks={self.paging.num_blocks} cannot hold one "
                        "full request; increase num_blocks")
                self._preempt(max(victims, key=lambda s: self._admit_seq[s]))

    def _release_slot_blocks(self, slot: int) -> None:
        """Release a slot's blocks and null its table row.  With the prefix
        cache this is a decref: blocks other requests map lose one
        reference, trie-owned blocks at refcount zero park in the LRU tier,
        and only unshared, uncached blocks return to the free list."""
        zeros = self.allocator.decref(self._slot_blocks[slot])
        if self.prefix_cache is not None:
            zeros = self.prefix_cache.park(zeros)
        self.allocator.free(zeros)
        self._slot_blocks[slot] = []
        self._tables[slot] = [NULL_BLOCK] * self.blocks_per_slot
        self._tables_dirty = True
        self._reg_done[slot] = False

    def _truncate_slot_blocks(self, slot: int, keep_tokens: int) -> None:
        """Roll back a slot's block tail after rejected speculation: the
        blocks past its first ``keep_tokens`` positions are handed back
        through ``allocator.truncate`` (a block another request maps loses
        one reference; a trie-owned one parks, never frees; the rest
        return to the free list), and the table tail is nulled so a later
        verify pass's masked overrun lands in the null block, never in a
        reassigned one."""
        keep = blocks_for_tokens(keep_tokens, self.paging.block_size)
        blocks = self._slot_blocks[slot]
        if keep >= len(blocks):
            return
        kept, zeros = self.allocator.truncate(blocks, keep)
        if self.prefix_cache is not None:
            zeros = self.prefix_cache.park(zeros)
        self.allocator.free(zeros)
        self._slot_blocks[slot] = kept
        self._tables[slot][keep:] = [NULL_BLOCK] * (self.blocks_per_slot
                                                    - keep)
        self._tables_dirty = True

    def _preempt(self, slot: int) -> None:
        """Recompute-preemption: bank the slot's generated tokens (one
        transfer), release its blocks (a decref where they are shared)
        and push the request back to the queue head; it resumes with
        prompt + banked tokens, through the trie where that hits."""
        req = self.slot_req[slot]
        st = self.state
        cap = min(self._budget[slot], self.max_len)
        row = torch.cat([st.count[slot:slot + 1], st.buf[slot, :cap]]).cpu()
        self.stats["device_gets"] += 1
        cnt = int(row[0])
        if cnt > 0:
            self.stats["harvest_elems"] += cnt
            req.prefix = req.prefix + row[1:cnt + 1].tolist()
        for field in ("active", "done", "count", "index", "prompt_len",
                      "pf_pos", "acc", "spec_steps"):
            getattr(st, field)[slot] = 0
        if self.paging is not None:
            self._release_slot_blocks(slot)
        self.slot_req[slot] = None
        self._pf[slot] = 0
        req.slot = None
        self.queue.insert(0, req)
        self.stats["preemptions"] += 1
        self._emit("preempt", req.uid, banked=len(req.prefix))

    def _sample_rows(self) -> torch.Tensor | None:
        """The device index of the stochastic slots (None: all greedy),
        uploaded again only when the host's list of generators changed."""
        key = tuple(b for b, g in enumerate(self._gens) if g is not None)
        if not key:
            return None
        if key != self._rows_key:
            self._stages["rows"].put((self._rows_buf[:len(key)], key))
            self._rows_key = key
        return self._rows_buf[:len(key)]

    # ------------------------------------------------------------------
    # the fused programs as CUDA graphs
    # ------------------------------------------------------------------
    @property
    def compilations(self) -> Compilations:
        """Compile-count accounting, the reference's: ``prefill`` and
        ``decode`` count the programs serving each role, here the captures
        of each program (on an eager engine, 1 for a program that ran).
        Under the chunked scheduler both name the ONE fused mixed step, and
        ``decode`` falls back to the mixed step's count when the one-lane
        program never ran; ``prefill_buckets`` stays 0.  Under the bucketed
        scheduler ``prefill`` = ``prefill_buckets`` = the buckets whose
        prefill ran."""
        buckets = sum(n for k, n in self._programs.items()
                      if k.startswith("prefill:"))
        if self.scheduler == "chunked":
            n = self._programs["mixed"]
            return Compilations(decode=self._programs["decode"] or n,
                                prefill=n, prefill_buckets=buckets)
        return Compilations(decode=self._programs["decode"], prefill=buckets,
                            prefill_buckets=buckets)

    def _graph_inputs(self) -> tuple[torch.Tensor, ...]:
        """Every tensor a fused step reads or writes apart from the
        target's weights, which ``load`` and ``add_model`` write in place:
        with speculation the draft's weights and dense cache too."""
        st, c = self.state, self.cache
        out = [getattr(st, f.name) for f in dataclasses.fields(st)]
        out += [t for t in c if t is not None]
        if self.table is not None:
            out += tree_leaves(self.table)
        if self.draft_model is not None:
            out += [*self.draft_model.parameters(),
                    *self.draft_model.buffers(),
                    *(t for t in self.draft_cache or () if t is not None)]
        if self.block_tables is not None:
            out.append(self.block_tables)
        return (*out, self._grants, self._rows_buf)

    def _run(self, kind: str, impl, *args, inputs=None):
        """Run one program of ``kind`` ("mixed" | "decode" | "prefill:<b>")
        and return what it returns: replay its graph, capture it on its
        first use, or run it eagerly (an eager engine, or a fused step with
        a stochastic slot).  ``inputs``: the tensors a prefill reads (a
        fused step's are ``_graph_inputs``)."""
        step = inputs is None
        if not self.graphs or (step and any(g is not None
                                            for g in self._gens)):
            out = impl(*args)
            if step:
                self.stats["eager_steps"] += 1
            if not self.graphs:
                self._programs[kind] = 1
            return out
        if step:
            inputs = self._graph_inputs()
        sg = self._graphs.get(kind)
        if sg is not None and (len(sg.inputs) != len(inputs) or not all(
                a is b for a, b in zip(sg.inputs, inputs))):
            self._graphs.clear()      # a captured tensor was replaced
            sg = None
        if sg is None:
            sg, out = self._capture(kind, impl, inputs, *args)
            self._graphs[kind] = sg
            self.stats["graph_captures" if step else "prefill_captures"] += 1
            return out
        sg.graph.replay()
        self.stats["graph_replays" if step else "prefill_replays"] += 1
        self.replayed_launches.update(sg.launches)
        return sg.outputs

    def _capture(self, kind: str, impl, inputs: tuple, *args
                 ) -> tuple[StepGraph, object]:
        """Warm up (this call's own run, eager) and capture program
        ``kind`` on the side stream, ordered after the uploads queued on
        the current stream and before what follows there, without a host
        sync; returns the graph and the warm-up's outputs.  A failed
        capture raises with its cause."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        if not self._graphs:
            # the pool lives as long as a graph holds it: after the graphs
            # were dropped the next capture starts a new one
            self._graph_pool = torch.cuda.graph_pool_handle()
        what = f"fused {kind} step" if kind in self._STEPS \
            else f"{kind} program"
        side, current = self._graph_stream, torch.cuda.current_stream(
            self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = impl(*args)                    # the warm-up is the call
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._graph_pool)
            try:
                outputs = impl(*args)
            except Exception as err:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass                         # the capture was invalid
                raise RuntimeError(
                    f"capturing the {what} as a CUDA graph failed: "
                    f"{err}") from err
            try:
                graph.capture_end()
            except RuntimeError as err:
                raise RuntimeError(
                    f"capturing the {what} as a CUDA graph failed: "
                    f"{err}") from err
        current.wait_stream(side)
        after = launch_counts()
        launches = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
        self.captured_launches.update(launches)
        self._programs[kind] = self._programs.get(kind, 0) + 1
        return StepGraph(graph, tuple(inputs), launches, outputs), out

    def _dispatch(self) -> None:
        """One fused step, queued without waiting for the device: the
        host work (uploads, grants, stats), then the step's program."""
        if self.paging is not None and self._tables_dirty:
            self._stages["tables"].put((self.block_tables, self._tables))
            self._tables_dirty = False
        if self.scheduler == "bucketed":
            # every slot holds its whole prompt already: the one-lane step
            self._run("decode", self._decode_impl)
            self.stats["decode_steps"] += 1
            for slot in self._occupied():
                self._idx_ub[slot] = min(self._idx_ub[slot] + 1,
                                         self._slot_token_cap(slot))
            return
        grants = self._grant_chunks()
        granted = sum(grants)
        if granted:
            self._stages["grants"].put((self._grants, grants))
            self._run("mixed", self._mixed_impl, self._grants)
        else:
            # steady state: the one-lane decode is the W == 1 special case
            # of the mixed step (same math, ~chunk_size x less query work)
            self._run("decode", self._decode_impl)
        self.stats["decode_steps"] += 1
        self.stats["prefill_tokens"] += granted
        self.stats["max_step_prefill_tokens"] = max(
            self.stats["max_step_prefill_tokens"], granted)
        for slot in self._occupied():
            if grants[slot]:
                self._pf[slot] += grants[slot]
                self._idx_ub[slot] = self._pf[slot]
                if self._pf[slot] >= self._plen[slot]:
                    # this dispatch's completing chunk sampled the first token
                    self._emit_first_token(self.slot_req[slot].uid)
            elif self._pf[slot] >= self._plen[slot]:
                # a speculative step can land up to k + 1 tokens: the
                # mirror is an upper bound until the next sync
                self._idx_ub[slot] = min(
                    self._idx_ub[slot] + self.spec_horizon,
                    self._slot_token_cap(slot))
        if self.prefix_cache is not None:
            self._register_prefixes()

    def _register_prefixes(self) -> None:
        """Register every slot whose prefill just completed: its whole
        prompt blocks enter the trie (an existing chain wins; the slot's
        duplicate block stays private and is freed at release).  Once per
        occupancy, right after the completing dispatch, so a later
        reader's step is ordered behind the writes on the stream."""
        bs = self.paging.block_size
        for slot in self._occupied():
            if self._reg_done[slot] or self._pf[slot] < self._plen[slot]:
                continue
            req = self.slot_req[slot]
            tokens = req.prompt + req.prefix
            n_full = len(tokens) // bs
            if n_full:
                self.prefix_cache.insert(self._namespace(req.model), tokens,
                                         self._slot_blocks[slot][:n_full])
            self._reg_done[slot] = True

    def _harvest(self) -> list[Request]:
        """One bulk transfer of the done/count vectors (with speculation,
        and of the acc/spec_steps ones); token buffers come over (one more
        transfer) only for slots that finished, sliced to the longest
        finished stream.  With speculation each decoding slot that is not
        done hands back the blocks past its resident tokens."""
        st = self.state
        spec = self.speculation is not None
        rows = [st.done.to(torch.int32), st.count]
        if spec:
            rows += [st.acc, st.spec_steps]
        dc = torch.stack(rows).cpu()
        self.stats["device_gets"] += 1
        done_h, count_h = dc[0].tolist(), dc[1].tolist()
        acc_h, ss_h = (dc[2].tolist(), dc[3].tolist()) if spec \
            else (None, None)
        occ = self._occupied()
        slots = [i for i in occ if done_h[i]]
        for i in occ:   # sync point: tighten the index upper bounds
            if self._pf[i] < self._plen[i]:
                self._idx_ub[i] = self._pf[i]
            else:
                self._idx_ub[i] = self._plen[i] + max(count_h[i] - 1, 0)
                if spec and self.paging is not None and not done_h[i]:
                    # rollback, host half: the dispatch loop reserved k + 1
                    # positions a step; the resident length is exact now
                    self._truncate_slot_blocks(i, self._idx_ub[i])
            if spec:
                self._emit("progress", self.slot_req[i].uid,
                           count=count_h[i], accepted=acc_h[i],
                           spec_steps=ss_h[i])
            else:
                self._emit("progress", self.slot_req[i].uid,
                           count=count_h[i])
        if not slots:
            return []
        maxc = max(count_h[i] for i in slots)
        bufs = st.buf[torch.tensor(slots, device=self.device), :maxc].cpu()
        self.stats["device_gets"] += 1
        self.stats["harvest_elems"] += len(slots) * maxc
        finished = []
        for row, i in zip(bufs.tolist(), slots):
            req = self.slot_req[i]
            req.generated = req.prefix + row[:count_h[i]]
            req.done = True
            if spec:
                self.stats["spec_accepted"] += acc_h[i]
                self.stats["spec_steps"] += ss_h[i]
            self.slot_req[i] = None
            self._gens[i] = None
            if self.paging is not None:
                self._release_slot_blocks(i)
            finished.append(req)
            self._emit("finish", req.uid, n_generated=len(req.generated))
        return finished

    def step(self) -> list[Request]:
        """Admit waiting requests, advance every active slot one step.
        Returns requests completed this step."""
        self._admit()
        if not self._occupied():
            return []
        self._ensure_capacity(1)
        self._dispatch()
        return self._harvest()

    def run_to_completion(self, max_steps: int = 10_000,
                          sync_every: int = 1) -> list[Request]:
        """Drain queue + slots; ``sync_every=k`` dispatches k fused steps
        back-to-back before each harvest sync."""
        done: list[Request] = []
        steps = 0
        while steps < max_steps:
            self._admit()
            if not self._occupied():
                break
            window = min(max(1, sync_every), max_steps - steps)
            self._ensure_capacity(window)
            for _ in range(window):
                self._dispatch()
                steps += 1
            done += self._harvest()
        return done

    def memory_stats(self) -> FragmentationStats:
        """Pool occupancy + fragmentation, with the blocks several requests
        map (``shared_blocks``) and those parked in the prefix trie
        (``cached_blocks``).  Exact at sync points; between syncs resident
        tokens are an upper bound.  The paged layout only, as the
        reference's."""
        if self.paging is None:
            raise ValueError("memory_stats requires cache_layout='paged'")
        self.allocator.set_used_tokens(
            sum(self._idx_ub[i] for i in self._occupied()))
        return self.allocator.stats()
