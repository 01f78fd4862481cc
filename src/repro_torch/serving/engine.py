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

``ServingEngine(spec, device=None)`` runs on the CUDA device and raises
without one; pass ``device="cpu"`` for the host.  ``seed`` seeds the
per-request generators of stochastic sampling (a request's stream is a
function of ``seed`` and its uid).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.paging import (NULL_BLOCK, BlockAllocator,
                                     FragmentationStats, blocks_for_tokens)
from repro_torch.core.spec import RuntimeSpec
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.events import EngineEvent, EventBus
from repro_torch.serving.events import now as _now
from repro_torch.serving.sampling import SamplingParams, sample_per_slot

_STAT_KEYS = ("decode_steps", "device_gets", "harvest_elems", "preemptions",
              "prefill_tokens", "max_step_prefill_tokens")


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
                   prompt_len=z(batch), pf_pos=z(batch))


class ServingEngine:
    def __init__(self, spec: RuntimeSpec, *, device=None,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0):
        if not isinstance(spec, RuntimeSpec):
            raise TypeError("ServingEngine expects a repro_torch.core.spec."
                            f"RuntimeSpec, got {type(spec).__name__}")
        self.device = resolve_device(device)
        self.spec = spec
        self.cfg: ArchConfig = spec.arch
        self.max_batch = spec.memory.max_batch
        self.max_len = spec.memory.max_len
        self.sampling = sampling
        self.seed = seed
        self.chunk_size = min(spec.scheduler.chunk_size, self.max_len)
        self.token_budget = spec.scheduler.resolved_token_budget
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
        # per-slot generator for stochastic slots, None for greedy ones
        self._gens: list[torch.Generator | None] = [None] * self.max_batch

        self.cache = None
        self.state = SlotState.zeros(self.max_batch, self.max_len, self.device)
        self.slot_req: list[Request | None] = [None] * self.max_batch
        self.queue: list[Request] = []
        self._uid = 0
        self.stats = dict.fromkeys(_STAT_KEYS, 0)
        self.events = EventBus()
        self._ft_emitted: set[int] = set()

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
        allocate the paged pool."""
        self.model.load_state_dict(params)
        self.cache = self.model.init_cache(self.paging)

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               eos_id: int | None = None,
               sampling: SamplingParams | None = None) -> int:
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
        vocab = self.cfg.vocab_size
        if not all(0 <= t < vocab for t in prompt):
            raise ValueError(
                f"prompt contains token ids outside vocab [0, {vocab})")
        self._uid += 1
        self.queue.append(Request(self._uid, list(prompt), max_new_tokens,
                                  eos_id, sampling))
        self._emit("submit", self._uid, prompt_len=len(prompt),
                   max_new_tokens=max_new_tokens, model=0)
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
        logits = self.model.decode_step(self.cache, st.last, st.index,
                                        self.block_tables)
        toks = sample_per_slot(logits[:, 0], st.temp, st.top_k, st.top_p,
                               self._gens)
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
        logits = self.model.mixed_step(self.cache, toks, start, n_live,
                                       self.block_tables)
        # sampling lane: a completing prompt's last live lane, else 0
        completes = prefilling & (st.pf_pos + chunk_len >= st.prompt_len)
        sel = torch.where(completes, chunk_len - 1, 0).long()
        rows = torch.arange(self.max_batch, device=self.device)
        toks_s = sample_per_slot(logits[rows, sel], st.temp, st.top_k,
                                 st.top_p, self._gens)
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
            st.prompt_buf[slot].zero_()
            st.prompt_buf[slot, :plen] = torch.tensor(prompt,
                                                      dtype=torch.int32)
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

    def _dispatch(self) -> None:
        if self._tables_dirty:
            self.block_tables.copy_(torch.tensor(self._tables,
                                                 dtype=torch.int32))
            self._tables_dirty = False
        grants = self._grant_chunks()
        granted = sum(grants)
        if granted:
            self._mixed_impl(torch.tensor(grants, dtype=torch.int32,
                                          device=self.device))
        else:
            # steady state: the one-lane decode is the W == 1 special case
            # of the mixed step (same math, ~chunk_size x less query work)
            self._decode_impl()
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
