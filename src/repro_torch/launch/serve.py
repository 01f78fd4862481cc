"""Serving driver of the port: ``python -m repro_torch.launch.serve``.

Builds one ``core.spec.RuntimeSpec`` from the flags (the reference's
``launch/serve.py`` flags this port supports), starts the ``ServingEngine``
with random weights from a seeded generator, submits a demo request mix
and reports tokens/s and the host-traffic accounting.  ``--cache-layout``
is the reference's, ``dense`` by default (one row range per slot) or
``paged`` (the block pool, needed by ``--prefix-cache``); the scheduler is
the reference's ``"auto"``: chunked where the chunk geometry allows it
(``--chunk-size`` within ``--max-len`` and, paged, a multiple of
``--block-size``), else bucketed.

Runs on the CUDA device unless ``--device cpu`` is given.  ``--kernels
pallas`` routes every dense projection through the hand-written
``tiled_matmul`` kernel and ``--attn pallas`` the paged attention
through the hand-written decode and chunked-prefill kernels.  ``--quant
int8`` serves int8 weights (through the hand-written ``int8_matmul`` under
``--kernels pallas``) and ``--kv-dtype int8`` an int8 KV pool.  The
reference serves reduced configs in this driver; ``--full-width`` serves
the architecture at its published widths.  ``--arch`` takes any id of the
port's registry: qwen1.5-0.5b, the untied qwen2-72b, codeqwen1.5-7b and
phi3-mini-3.8b, adaptor-bert-shaped, granite-moe-1b-a400m,
deepseek-v3-671b, phi-3-vision-4.2b (its stub frontend's patch
positions take zeros, as in the reference), recurrentgemma-2b (the
hybrid family), falcon-mamba-7b (the ssm family; ``--model`` is the
same option) and whisper-medium (the audio family): these three on the
dense layout and the bucketed scheduler only, the reference's rule.
whisper-medium's stub frontend feeds zero frames to its encoder (no
request carries audio, as in the reference); the reduced config's stub
of 8 frames is raised to the encoder's 16 positions, which the reference's
reduced rule leaves unfilled (ROADMAP.md Queue 3), and the launcher prints
that note.  ``--prefix-cache`` shares
prompt-prefix KV blocks across requests (``core.paging.PrefixCache``) and
reports its hits, skipped tokens, copy-on-write forks and evictions.

``--spec-k K`` turns on speculative decoding: a draft (``--draft``, an
arch id of the registry at the target's width; by default the target's
own architecture and weights, a self-draft) proposes K tokens per fused
step and the target verifies K + 1 positions in one chunk-shaped attend;
the report gives the accepted draft tokens over the speculative steps.
A greedy mix (``--temperature 0``) accepts by argmax match, a sampled one
by rejection sampling.  With ``--fleet`` the draft proposes for every
member's slots (its vocab must be the fleet's largest; the default
self-draft is the first member with its weights).

On the card each fused program runs as one CUDA graph, captured on its
first all-greedy step and replayed after (a step with a stochastic slot
runs eagerly); ``--eager`` runs every step eagerly.  The report gives the
captures, replays and eager steps beside the engine's ``compilations``.

Multi-topology mode: ``--fleet qwen1.5-0.5b,adaptor-bert-shaped`` serves
several architectures of the port's registry from one fused step: the
shared maxima are planned with ``maxima_for``, each model is packed into
the fabric's weight table (``add_model``, random float weights from
generator seed ``--seed`` + its index), and the requests take the model
ids in turn.  ``--quant int8`` packs the fabric's int8 weight table
(``--quant-min-size`` is compared with the maxima-padded leaves);
``--kernels`` stays ``xla``, as the reference's fleet refuses the matmul
kernels.

Harness mode: ``--trace t.jsonl`` replays an on-disk trace
(``repro_torch.harness.trace``'s format, which the reference's files
share) through the engine instead of the demo mix and prints the reduced
TTFT / ITL / goodput metrics in engine steps and in wall milliseconds;
``--slo-ttft-steps N`` counts a request toward goodput only if its first
token lands within N steps.  The reference's ``--tuned`` (its analytical
autotuner) is refused until ROADMAP.md Queue 1 item 15.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", default="qwen1.5-0.5b")
    ap.add_argument("--fleet", default=None,
                    help="comma-separated architectures served together "
                         "by one multi-topology engine")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the architecture at its published widths "
                         "(default: the reduced test config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--sync-every", type=int, default=4,
                    help="fused steps dispatched between host syncs")
    ap.add_argument("--kernels", choices=("xla", "pallas"), default="xla",
                    help="matmul routing: PyTorch's product or the "
                         "hand-written tiled_matmul kernel")
    ap.add_argument("--attn", choices=("gather", "pallas"), default="gather",
                    help="paged attention: block-table gather + PyTorch, or "
                         "the hand-written paged kernels")
    ap.add_argument("--quant", choices=("none", "int8"), default="none",
                    help="serving-time weight quantization (int8 weights "
                         "through the hand-written int8_matmul under "
                         "--kernels pallas)")
    ap.add_argument("--quant-min-size", type=int, default=None,
                    help="param leaves under this many elements stay float")
    ap.add_argument("--kv-dtype", choices=("compute", "int8"),
                    default="compute",
                    help="KV-cache storage codec: bf16 values or "
                         "quantize-on-write int8 (~2x cache capacity)")
    ap.add_argument("--param-dtype", default=None,
                    help="parameter dtype by name, e.g. fp32 / bf16")
    ap.add_argument("--compute-dtype", default=None,
                    help="activation dtype by name, e.g. bf16 / fp32")
    ap.add_argument("--cache-layout", choices=("dense", "paged"),
                    default="dense")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged layout: tokens per KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged layout: pool size (default: dense worst "
                         "case)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV blocks across requests "
                         "(requires --cache-layout paged; rejected at spec "
                         "construction otherwise)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="prompt tokens per slot per fused step")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens proposed per "
                         "fused step (0 disables); the target verifies all "
                         "k+1 positions in one chunk-shaped attend")
    ap.add_argument("--draft", default=None,
                    help="draft arch id for --spec-k (default: the target "
                         "itself, i.e. self-draft; must share the target's "
                         "vocab / tokenizer space)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eager", action="store_true",
                    help="run every fused step eagerly (default on the "
                         "card: each fused program is one CUDA graph)")
    ap.add_argument("--trace", default=None,
                    help="replay this on-disk trace (repro_torch.harness."
                         "trace format) instead of the demo request mix and "
                         "print harness metrics")
    ap.add_argument("--slo-ttft-steps", type=int, default=None,
                    help="with --trace: count a request toward goodput only "
                         "if its first token lands within this many steps")
    ap.add_argument("--tuned", action="store_true",
                    help="the reference's analytical autotuner (not ported)")
    args = ap.parse_args(argv)
    if args.tuned:
        ap.error("--tuned (the analytical autotuner, harness/tune.py and "
                 "core/analytical.py) is not ported to repro_torch yet "
                 "(ROADMAP.md Queue 1 item 15); set the memory and "
                 "scheduler flags by hand")
    if args.slo_ttft_steps is not None and args.trace is None:
        ap.error("--slo-ttft-steps applies to a --trace replay")

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.spec import (ExecutionSpec, MemorySpec,
                                       RuntimeSpec, SchedulerSpec,
                                       SpeculationSpec, maxima_for)
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams

    names = args.fleet.split(",") if args.fleet else [args.arch]
    cfgs = [get_config(n) for n in names]
    if not args.full_width:
        cfgs = [reduced(c) for c in cfgs]
    notes = []
    for i, c in enumerate(cfgs):
        if c.encdec is not None:
            frames = c.encdec.encoder_seq_len
            if c.frontend.num_tokens != frames:
                notes.append(f"{c.name}: the reduced stub's "
                             f"{c.frontend.num_tokens} frames raised to the "
                             f"encoder's {frames} positions")
                cfgs[i] = dataclasses.replace(c, frontend=dataclasses.replace(
                    c.frontend, num_tokens=frames))
            notes.append(f"{c.name}: the stub audio frontend feeds {frames} "
                         "zero frames to the encoder (no request carries "
                         "audio); each prefill computes the request's cross "
                         "K/V once")
    cfg = cfgs[0]
    maxima = maxima_for(*cfgs, seq_max=args.max_len) if args.fleet else None
    speculation = draft_cfg = None
    if args.spec_k:
        draft_cfg = get_config(args.draft) if args.draft else cfg
        if args.draft and not args.full_width:
            draft_cfg = reduced(draft_cfg)
        # a sampled mix takes the rejection-sampling accept path; a greedy
        # one the exact argmax match
        speculation = SpeculationSpec(draft_model=draft_cfg, k=args.spec_k,
                                      greedy_accept=args.temperature <= 0.0)
    ex_kw = {}
    if args.param_dtype is not None:
        ex_kw["param_dtype"] = args.param_dtype
    if args.compute_dtype is not None:
        ex_kw["compute_dtype"] = args.compute_dtype
    if args.quant_min_size is not None:
        ex_kw["quant_min_size"] = args.quant_min_size
    spec = RuntimeSpec(
        arch=cfg, maxima=maxima,
        execution=ExecutionSpec(matmul_backend=args.kernels,
                                paged_attn_impl=args.attn, quant=args.quant,
                                **ex_kw),
        memory=MemorySpec(cache_layout=args.cache_layout,
                          max_batch=args.max_batch, max_len=args.max_len,
                          block_size=args.block_size,
                          num_blocks=args.num_blocks,
                          kv_dtype=args.kv_dtype,
                          prefix_cache=args.prefix_cache),
        scheduler=SchedulerSpec(chunk_size=args.chunk_size),
        speculation=speculation)
    device = resolve_device(args.device)
    sampling = SamplingParams(temperature=args.temperature, top_k=40)
    eng = ServingEngine(spec, max_models=len(cfgs), device=device,
                        sampling=sampling, seed=args.seed,
                        graphs=False if args.eager else None)
    ex = spec.execution
    model_ids = []
    for i, c in enumerate(cfgs):
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed + i)
        # a fleet packs float weights and quantizes its own table rows
        params = Model(c, param_dtype=ex.param_dtype,
                       compute_dtype=ex.compute_dtype,
                       quant="none" if args.fleet else ex.quant,
                       quant_min_size=ex.quant_min_size,
                       device=device).init(gen).state_dict()
        draft = None
        if draft_cfg is not None and i == 0:
            draft = params if draft_cfg == c else Model(
                draft_cfg, param_dtype=ex.param_dtype,
                compute_dtype=ex.compute_dtype, device=device).init(
                    gen.manual_seed(args.seed + 1)).state_dict()
        if args.fleet:
            model_ids.append(eng.add_model(params, c))
            if draft is not None:
                eng.load_draft(draft)
        else:
            eng.load(params, draft=draft)
            model_ids.append(0)
        del params, draft

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    if args.trace is not None:
        from repro_torch.harness import SLO, load_trace, replay
        trace = load_trace(args.trace)
        slo = (SLO(ttft_steps=args.slo_ttft_steps)
               if args.slo_ttft_steps is not None else None)
        t0 = time.perf_counter()
        res = replay(eng, trace, slo=slo)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        done, m = res.finished, res.metrics
        print(f"trace {trace.name!r} (seed {trace.seed}) on {name}: "
              f"{m.n_finished}/{m.n_requests} finished over {m.steps} fused "
              f"steps in {dt:.2f}s ({m.tokens_per_s:,.1f} tok/s)")
        print(f"  TTFT p50/p99 {m.ttft_steps_p50}/{m.ttft_steps_p99} steps "
              f"({_ms(m.ttft_s_p50)}/{_ms(m.ttft_s_p99)} ms)   ITL p50/p99 "
              f"{m.itl_steps_p50}/{m.itl_steps_p99} steps "
              f"({_ms(m.itl_s_p50)}/{_ms(m.itl_s_p99)} ms)")
        print(f"  peak concurrency {m.peak_concurrency}, "
              f"{m.n_preemptions} preemptions, {m.prefix_hits} prefix hits")
        if slo is not None:
            print(f"  SLO (ttft<={args.slo_ttft_steps} steps): "
                  f"{m.n_slo_met}/{m.n_requests} met, goodput "
                  f"{m.goodput_req_per_1k_steps:.1f} req/1k-steps "
                  f"({m.goodput_req_s:.2f} req/s)")
    else:
        rs = np.random.default_rng(7)
        for i in range(args.requests):
            mid = model_ids[i % len(model_ids)]
            plen = int(rs.integers(4, args.max_len // 2))
            eng.submit(rs.integers(0, cfgs[mid].vocab_size, plen).tolist(),
                       max_new_tokens=args.max_new, model=mid)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        done = eng.run_to_completion(sync_every=args.sync_every)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        total_new = sum(len(r.generated) for r in done)
        print(f"{'+'.join(names)} on {name}: {len(done)} requests, "
              f"{total_new} tokens in {dt:.2f}s ({total_new / dt:,.1f} "
              "tok/s)")
    st = eng.stats
    print(f"host traffic: {st['device_gets']} bulk transfers over "
          f"{st['decode_steps']} fused steps")
    print(f"{eng.scheduler} scheduler, {spec.memory.cache_layout} cache; "
          f"fused programs: {st['graph_captures']} CUDA graph captures, "
          f"{st['graph_replays']} replays, {st['eager_steps']} eager steps; "
          f"compilations {dict(eng.compilations)}")
    if spec.memory.cache_layout == "paged":
        s = eng.memory_stats()
        print(f"paged pool: {s.total_blocks} x {spec.memory.block_size}-"
              f"token blocks, {eng.stats['preemptions']} preemptions")
        if spec.memory.prefix_cache:
            print(f"prefix cache: {st['prefix_hits']} hits / "
                  f"{st['prefix_hit_tokens']} tokens skipped, "
                  f"{st['cow_forks']} CoW forks, {st['prefix_evictions']} "
                  f"evictions; {s.shared_blocks} shared + "
                  f"{s.cached_blocks} parked blocks resident")
    if args.spec_k:
        acc, ss = st["spec_accepted"], st["spec_steps"]
        mean = acc / ss if ss else 0.0
        print(f"speculation: k={args.spec_k} draft={draft_cfg.name}, "
              f"{acc} draft tokens accepted over {ss} speculative steps "
              f"(mean {mean:.2f}; ~{1 + mean:.2f} tokens/step per "
              "decoding slot)")
    if args.fleet:
        print(f"fleet: {names} served by one fused step")
    for note in notes:
        print(note)
    for r in done[:3]:
        print(f"  req {r.uid} (model {r.model}): prompt[:6]={r.prompt[:6]} "
              f"-> {r.generated[:10]}...")


def _ms(seconds: float | None) -> str:
    return "n/a" if seconds is None else f"{seconds * 1e3:.1f}"


if __name__ == "__main__":
    main()
