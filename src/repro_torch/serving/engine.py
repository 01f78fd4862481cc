"""Batched serving engine of the port: paged KV pool + chunked scheduler.

The counterpart of the reference's ``serving/engine.py`` on its
single-topology, paged, chunked path.  One fused mixed step advances every
slot by up to W = ``chunk_size`` query lanes (prompt chunks for
prefilling slots, the next token for decoding slots, nothing for idle
ones); once no slot carries prompt work the one-lane decode step runs
instead.  Both end in sampling, the token scatter and the finish flags.

Per-slot state lives in device tensors (``SlotState``) and is updated in
place; the KV pool is written in place by the model.  The host keeps the
reference's discipline:

* block tables are uploaded only when the host changed them;
* one bulk ``.cpu()`` of the (done, count) vectors per sync;
* a second transfer only for the finished rows' token buffers, sliced to
  the longest finished stream.

Nothing between two syncs waits for the device, so ``sync_every=k`` lets
the host queue k fused steps ahead: block tables, chunk grants, the
stochastic rows' index and each admitted prompt (with its topology
registers) go up through ``HostStage``'s pinned buffers as asynchronous
copies into device tensors that stay in place.

Each fused program is one CUDA graph (``graphs=True``, the default on a
CUDA device; the counterpart of the reference's
``strict_jit(..., donate_argnums=(1, 2))``): the first step of a kind runs
eagerly on a side stream as the warm-up, is captured there once into a
graph pool the engine's graphs share, and every later step of that kind
replays the graph on the current stream, after the host work
(``HostStage`` uploads, grants, stats).  Every tensor the step reads stays
in place: the slot state, the pool, the block tables, the grants, the
stochastic rows' index and the fleet's table.  ``load`` drops the graphs
(it replaces the pool), as does any step that finds a captured tensor
replaced.  Only all-greedy steps are captured: a step with a stochastic
slot draws from that slot's host-side generator, so it runs eagerly and
counts in ``stats["eager_steps"]``.  A capture that fails raises with its
cause; nothing falls back to eager quietly.  ``compilations`` counts the
captures per program (on an eager engine, 1 per program that ran), with
the reference's accounting.

Multi-topology serving: ``ServingEngine(spec, maxima=...)`` (or a spec
with ``maxima``) runs the register-driven ``serving.fabric`` at the maxima
instead of one fixed model.  ``add_model(params, arch)`` packs a
dense-family model into the fabric's weight table, each slot carries its
model's topology registers in ``SlotState.topo``, and one fused step
serves the mixed fleet; ``submit(..., model=id)`` picks the member.

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
from repro_torch.core.paging import (NULL_BLOCK, BlockAllocator,
                                     FragmentationStats, blocks_for_tokens)
from repro_torch.core.spec import RuntimeSpec
from repro_torch.kernels.counts import launch_counts
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.events import EngineEvent, EventBus
from repro_torch.serving.fabric import N_REGS, DecodeFabric, tree_leaves
from repro_torch.serving.events import now as _now
from repro_torch.serving.sampling import SamplingParams, sample_per_slot

# decode_steps = graph_captures + graph_replays + eager_steps: a capture's
# step runs once eagerly as its warm-up; on an eager engine every step is
# an eager step
_STAT_KEYS = ("decode_steps", "device_gets", "harvest_elems", "preemptions",
              "prefill_tokens", "max_step_prefill_tokens", "graph_captures",
              "graph_replays", "eager_steps")
# uploads of tables, grants and sampling rows the host may queue ahead of
# the device before one waits for a staging buffer
_STAGE_DEPTH = 16


class HostStage:
    """Host-to-device uploads of small int32 arrays that never wait for
    the device.  On CUDA the values go into one of ``depth`` pinned host
    buffers, taken in turn and allocated once, and each goes up by an
    asynchronous copy on the current stream into its device tensor.  A
    buffer is written again only once the copies that last read it have
    run (an event recorded after them); ``waits`` counts the uploads that
    had to wait for that.  On a CPU device there is nothing to pin: the
    values are copied in place."""

    def __init__(self, numel: int, device: torch.device, depth: int):
        self.waits = 0
        self._turn = 0
        self._bufs: list[torch.Tensor] = []
        self._events: list[torch.cuda.Event] = []
        if device.type == "cuda":
            self._bufs = [torch.empty(numel, dtype=torch.int32,
                                      pin_memory=True) for _ in range(depth)]
            self._events = [torch.cuda.Event() for _ in range(depth)]

    def put(self, *pairs: tuple[torch.Tensor, object]) -> None:
        """Each (dst, values) pair: ``values`` (ints, nested lists) into
        the int32 device tensor ``dst`` of the same number of elements."""
        srcs = [torch.as_tensor(v, dtype=torch.int32).reshape(d.shape)
                for d, v in pairs]
        if not self._bufs:
            for (dst, _), src in zip(pairs, srcs):
                dst.copy_(src)
            return
        i = self._turn
        self._turn = (i + 1) % len(self._bufs)
        event = self._events[i]
        if not event.query():
            self.waits += 1
            event.synchronize()
        at = 0
        for (dst, _), src in zip(pairs, srcs):
            staged = self._bufs[i][at:at + src.numel()].view(dst.shape)
            staged.copy_(src)
            dst.copy_(staged, non_blocking=True)
            at += src.numel()
        event.record(torch.cuda.current_stream(pairs[0][0].device))


class Compilations(dict):
    """Compile-count mapping that is also callable, as the reference's:
    ``engine.compilations["decode"]`` and ``engine.compilations()["decode"]``
    read the same accounting."""

    def __call__(self) -> "Compilations":
        return self


@dataclasses.dataclass
class StepGraph:
    """One captured fused program: the graph, the tensors it reads (held
    so that a replaced one is seen), and the launches per kernel wrapper
    that its capture recorded, which each replay makes again."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple[torch.Tensor, ...]
    launches: dict[str, int]


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
    buf: torch.Tensor         # [B, max_len] i32 generated tokens
    prompt_buf: torch.Tensor  # [B, max_len] i32 prompt tokens, chunk source
    prompt_len: torch.Tensor  # [B] i32 total prompt length
    pf_pos: torch.Tensor      # [B] i32 prompt tokens already in the cache
    topo: torch.Tensor        # [B, N_REGS] i32 topology registers (fleet)

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
                   buf=z(batch, max_len), prompt_buf=z(batch, max_len),
                   prompt_len=z(batch), pf_pos=z(batch),
                   topo=z(batch, N_REGS))


class ServingEngine:
    def __init__(self, spec: RuntimeSpec, *, maxima=None,
                 max_models: int = 4, device=None,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 graphs: bool | None = None):
        if not isinstance(spec, RuntimeSpec):
            raise TypeError("ServingEngine expects a repro_torch.core.spec."
                            f"RuntimeSpec, got {type(spec).__name__}")
        if maxima is not None:
            spec = dataclasses.replace(spec, maxima=maxima)
        self.device = resolve_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(
                f"graphs=True needs a CUDA device (got {self.device}); the "
                "fused steps run eagerly on the host")
        self.graphs = graphs
        self.spec = spec
        self.cfg: ArchConfig = spec.arch
        self.max_batch = spec.memory.max_batch
        self.max_len = spec.memory.max_len
        self.sampling = sampling
        self.seed = seed
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
                    "backend (use the default 'xla'; quantized fleet "
                    "serving, ExecutionSpec(quant='int8') with the fabric's "
                    "own int8 weight table, is ROADMAP.md Queue 1 item 8b)")
            self.fabric = DecodeFabric(
                spec.maxima, max_models, self.cfg,
                compute_dtype=ex.compute_dtype, param_dtype=ex.param_dtype,
                kv_dtype=spec.memory.kv_dtype, device=self.device)
            self.fabric.check_member(self.cfg)
            self.fleet: list[ArchConfig | None] = [None] * max_models
            self._fleet_rows: list[list[int] | None] = [None] * max_models
        else:
            self.model = Model.from_spec(spec, device=self.device)

        self.paging = spec.memory.paging()
        self.allocator = BlockAllocator(self.paging)
        self.blocks_per_slot = self.max_len // self.paging.block_size
        self._tables = [[NULL_BLOCK] * self.blocks_per_slot
                        for _ in range(self.max_batch)]
        self._slot_blocks: list[list[int]] = [[] for _ in range(self.max_batch)]
        self._tables_dirty = True
        self.block_tables = torch.zeros(
            (self.max_batch, self.blocks_per_slot), dtype=torch.int32,
            device=self.device)
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
        self._grants = torch.zeros(self.max_batch, dtype=torch.int32,
                                   device=self.device)
        self._stages = {
            "tables": HostStage(self.block_tables.numel(), self.device,
                                _STAGE_DEPTH),
            "grants": HostStage(self.max_batch, self.device, _STAGE_DEPTH),
            "rows": HostStage(self.max_batch, self.device, _STAGE_DEPTH),
            # one admitted prompt and its topology row per buffer
            "admit": HostStage(self.max_len + N_REGS, self.device,
                               2 * self.max_batch)}

        # the fleet's weight table exists before any model is loaded:
        # add_model only writes device data into it
        self.table = self.fabric.init_table() if self.fabric else None
        self.cache = self.fabric.init_cache(self.paging) if self.fabric \
            else None
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
        self._programs = {"mixed": 0, "decode": 0}
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

    def load(self, params) -> None:
        """Install weights (a state dict of the port's ``Model``, e.g. from
        ``Model.init(...).state_dict()`` or ``bridge.from_jax_params``) and
        allocate the paged pool through the spec's cache codec.  Under
        ``spec.execution.quant="int8"`` float weights are quantized here
        (the model's ``load_state_dict`` applies
        ``core.serve_quant.quantize_params`` at ``quant_min_size``), as the
        reference's ``load`` does.  Multi-topology mode: ``add_model`` for
        the engine's own architecture."""
        if self.fabric is not None:
            self.add_model(params)
            return
        self._graphs.clear()      # they read the pool this call replaces
        self.model.load_state_dict(params)
        self.cache = self.model.init_cache(self.paging)

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
        advance indices/budgets -> raise done flags."""
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
                                           self.block_tables)
        # sampling lane: a completing prompt's last live lane, else 0
        completes = prefilling & (st.pf_pos + chunk_len >= st.prompt_len)
        sel = torch.where(completes, chunk_len - 1, 0).long()
        rows = torch.arange(self.max_batch, device=self.device)
        toks_s = sample_per_slot(logits[rows, sel], st.temp, st.top_k,
                                 st.top_p, self._gens, self._sample_rows())
        st.pf_pos += torch.where(prefilling, chunk_len, 0)
        self._finish(st, decoding | completes, toks_s, st.index + n_live)

    # ------------------------------------------------------------------
    # host-side control
    # ------------------------------------------------------------------
    def _admit(self) -> None:
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
            blocks = self.allocator.alloc(
                blocks_for_tokens(plen, self.paging.block_size))
            if blocks is None:
                break   # FCFS: the queue head waits for blocks
            self._slot_blocks[slot] = blocks
            self._tables[slot] = blocks + [NULL_BLOCK] * (
                self.blocks_per_slot - len(blocks))
            self._tables_dirty = True
            self.queue.pop(0)
            sp = req.sampling or self.sampling
            st = self.state
            topo = self._fleet_rows[req.model] if self.fabric is not None \
                else [0] * N_REGS
            self._stages["admit"].put(
                (st.prompt_buf[slot], prompt + [0] * (self.max_len - plen)),
                (st.topo[slot], topo))
            for field, value in (
                    ("last", 0), ("index", 0), ("active", True),
                    ("done", False), ("budget", budget), ("count", 0),
                    ("eos", -1 if req.eos_id is None else req.eos_id),
                    ("temp", sp.temperature), ("top_k", sp.top_k),
                    ("top_p", sp.top_p), ("prompt_len", plen),
                    ("pf_pos", 0)):
                getattr(st, field)[slot] = value
            st.buf[slot].zero_()
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
            self._idx_ub[slot] = 0
            self._pf[slot] = 0
            self._seq += 1
            self._admit_seq[slot] = self._seq
            self._emit("admit", req.uid, slot=slot, cached_tokens=0)

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

    def _slot_token_cap(self, slot: int) -> int:
        """Most cache positions this slot can ever need (then it finishes)."""
        return min(self._plen[slot] + self._budget[slot] - 1, self.max_len)

    def _ensure_capacity(self, horizon: int) -> None:
        """Pre-reserve blocks so the next ``horizon`` fused steps cannot
        write outside a slot's blocks.  Oldest slots are served first; when
        the pool runs dry the most recently admitted slot is preempted."""
        bs = self.paging.block_size
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
                got = self.allocator.alloc(missing)
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
        self.allocator.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._tables[slot] = [NULL_BLOCK] * self.blocks_per_slot
        self._tables_dirty = True

    def _preempt(self, slot: int) -> None:
        """Recompute-preemption: bank the slot's generated tokens (one
        transfer), free its blocks and push the request back to the queue
        head; it resumes with prompt + banked tokens."""
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
                      "pf_pos"):
            getattr(st, field)[slot] = 0
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
        of each fused step (on an eager engine, 1 for a program that ran).
        Under the chunked scheduler both name the ONE fused mixed step, and
        ``decode`` falls back to the mixed step's count when the one-lane
        program never ran.  ``prefill_buckets`` (the bucketed scheduler's)
        stays 0."""
        n = self._programs["mixed"]
        return Compilations(decode=self._programs["decode"] or n,
                            prefill=n, prefill_buckets=0)

    def _graph_inputs(self) -> tuple[torch.Tensor, ...]:
        """Every tensor a fused step reads or writes apart from the
        weights, which ``load`` and ``add_model`` write in place."""
        st, c = self.state, self.cache
        out = [getattr(st, f.name) for f in dataclasses.fields(st)]
        out += [t for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None]
        if self.table is not None:
            out += tree_leaves(self.table)
        return (*out, self.block_tables, self._grants, self._rows_buf)

    def _run(self, kind: str, impl, *args) -> None:
        """Run one fused step of program ``kind`` ("mixed" | "decode"):
        replay its graph, capture it on its first all-greedy step, or run
        it eagerly (an eager engine, or a step with a stochastic slot)."""
        if not self.graphs or any(g is not None for g in self._gens):
            impl(*args)
            self.stats["eager_steps"] += 1
            if not self.graphs:
                self._programs[kind] = 1
            return
        sg = self._graphs.get(kind)
        if sg is not None and not all(
                a is b for a, b in zip(sg.inputs, self._graph_inputs())):
            self._graphs.clear()      # a captured tensor was replaced
            sg = None
        if sg is None:
            self._graphs[kind] = self._capture(kind, impl, *args)
            return
        sg.graph.replay()
        self.stats["graph_replays"] += 1
        self.replayed_launches.update(sg.launches)

    def _capture(self, kind: str, impl, *args) -> StepGraph:
        """Warm up (this step's own run, eager) and capture program
        ``kind`` on the side stream, ordered after the uploads queued on
        the current stream and before what follows there, without a host
        sync.  A failed capture raises with its cause."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        if not self._graphs:
            # the pool lives as long as a graph holds it: after the graphs
            # were dropped the next capture starts a new one
            self._graph_pool = torch.cuda.graph_pool_handle()
        side, current = self._graph_stream, torch.cuda.current_stream(
            self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            impl(*args)                          # the warm-up is the step
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._graph_pool)
            try:
                impl(*args)
            except Exception as err:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass                         # the capture was invalid
                raise RuntimeError(
                    f"capturing the fused {kind} step as a CUDA graph "
                    f"failed: {err}") from err
            try:
                graph.capture_end()
            except RuntimeError as err:
                raise RuntimeError(
                    f"capturing the fused {kind} step as a CUDA graph "
                    f"failed: {err}") from err
        current.wait_stream(side)
        after = launch_counts()
        launches = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
        self.captured_launches.update(launches)
        self.stats["graph_captures"] += 1
        self._programs[kind] += 1
        return StepGraph(graph, self._graph_inputs(), launches)

    def _dispatch(self) -> None:
        """One fused step, queued without waiting for the device: the
        host work (uploads, grants, stats), then the step's program."""
        if self._tables_dirty:
            self._stages["tables"].put((self.block_tables, self._tables))
            self._tables_dirty = False
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
                self._idx_ub[slot] = min(self._idx_ub[slot] + 1,
                                         self._slot_token_cap(slot))

    def _harvest(self) -> list[Request]:
        """One bulk transfer of the done/count vectors; token buffers come
        over (one more transfer) only for slots that finished, sliced to
        the longest finished stream."""
        st = self.state
        dc = torch.stack([st.done.to(torch.int32), st.count]).cpu()
        self.stats["device_gets"] += 1
        done_h, count_h = dc[0].tolist(), dc[1].tolist()
        occ = self._occupied()
        slots = [i for i in occ if done_h[i]]
        for i in occ:   # sync point: tighten the index upper bounds
            if self._pf[i] < self._plen[i]:
                self._idx_ub[i] = self._pf[i]
            else:
                self._idx_ub[i] = self._plen[i] + max(count_h[i] - 1, 0)
            self._emit("progress", self.slot_req[i].uid, count=count_h[i])
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
            self.slot_req[i] = None
            self._gens[i] = None
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
        """Pool occupancy + fragmentation.  Exact at sync points; between
        syncs resident tokens are an upper bound."""
        self.allocator.set_used_tokens(
            sum(self._idx_ub[i] for i in self._occupied()))
        return self.allocator.stats()
