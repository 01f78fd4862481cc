"""Serving driver of the port: ``python -m repro_torch.launch.serve``.

Builds one ``core.spec.RuntimeSpec`` from the flags (the reference's
``launch/serve.py`` flags this port supports), starts the paged, chunked
``ServingEngine`` with random weights from a seeded generator, submits a
demo request mix and reports tokens/s and the host-traffic accounting.

Runs on the CUDA device unless ``--device cpu`` is given.  ``--kernels
pallas`` routes every dense projection through the hand-written
``tiled_matmul`` kernel and ``--attn pallas`` the paged attention
through the hand-written decode and chunked-prefill kernels.  ``--quant
int8`` serves int8 weights (through the hand-written ``int8_matmul`` under
``--kernels pallas``) and ``--kv-dtype int8`` an int8 KV pool.  The
reference serves reduced configs in this driver; ``--full-width`` serves
the architecture at its published widths.  ``--arch`` takes any id of the
port's registry: qwen1.5-0.5b, the untied qwen2-72b, codeqwen1.5-7b and
phi3-mini-3.8b, and adaptor-bert-shaped.

On the card each fused program runs as one CUDA graph, captured on its
first all-greedy step and replayed after (a step with a stochastic slot
runs eagerly); ``--eager`` runs every step eagerly.  The report gives the
captures, replays and eager steps beside the engine's ``compilations``.

Multi-topology mode: ``--fleet qwen1.5-0.5b,adaptor-bert-shaped`` serves
several architectures of the port's registry from one fused step: the
shared maxima are planned with ``maxima_for``, each model is packed into
the fabric's weight table (``add_model``, random weights from generator
seed ``--seed`` + its index), and the requests take the model ids in
turn.  Float weights only (the fleet's int8 weight table is ROADMAP.md
Queue 1 item 8b); ``--kernels`` stays ``xla``.
"""
from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
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
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block of the paged pool")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="pool size (default: the dense worst case)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="prompt tokens per slot per fused step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eager", action="store_true",
                    help="run every fused step eagerly (default on the "
                         "card: each fused program is one CUDA graph)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.spec import (ExecutionSpec, MemorySpec,
                                       RuntimeSpec, SchedulerSpec, maxima_for)
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams

    names = args.fleet.split(",") if args.fleet else [args.arch]
    cfgs = [get_config(n) for n in names]
    if not args.full_width:
        cfgs = [reduced(c) for c in cfgs]
    cfg = cfgs[0]
    maxima = maxima_for(*cfgs, seq_max=args.max_len) if args.fleet else None
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
        memory=MemorySpec(cache_layout="paged", max_batch=args.max_batch,
                          max_len=args.max_len, block_size=args.block_size,
                          num_blocks=args.num_blocks,
                          kv_dtype=args.kv_dtype),
        scheduler=SchedulerSpec(chunk_size=args.chunk_size))
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
        params = Model(c, param_dtype=ex.param_dtype,
                       compute_dtype=ex.compute_dtype, quant=ex.quant,
                       quant_min_size=ex.quant_min_size,
                       device=device).init(gen).state_dict()
        if args.fleet:
            model_ids.append(eng.add_model(params, c))
        else:
            eng.load(params)
            model_ids.append(0)
        del params

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
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{'+'.join(names)} on {name}: {len(done)} requests, {total_new} "
          f"tokens in {dt:.2f}s ({total_new / dt:,.1f} tok/s)")
    st = eng.stats
    print(f"host traffic: {st['device_gets']} bulk transfers over "
          f"{st['decode_steps']} fused steps")
    print(f"fused programs: {st['graph_captures']} CUDA graph captures, "
          f"{st['graph_replays']} replays, {st['eager_steps']} eager steps; "
          f"compilations {dict(eng.compilations)}")
    s = eng.memory_stats()
    print(f"paged pool: {s.total_blocks} x {spec.memory.block_size}-token "
          f"blocks, {eng.stats['preemptions']} preemptions")
    if args.fleet:
        print(f"fleet: {names} served by one fused step")
    for r in done[:3]:
        print(f"  req {r.uid} (model {r.model}): prompt[:6]={r.prompt[:6]} "
              f"-> {r.generated[:10]}...")


if __name__ == "__main__":
    main()
