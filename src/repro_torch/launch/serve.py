"""Serving driver of the port: ``python -m repro_torch.launch.serve``.

Builds one ``core.spec.RuntimeSpec`` from the flags (the reference's
``launch/serve.py`` flags this port supports), starts the paged, chunked
``ServingEngine`` with random weights from a seeded generator, submits a
demo request mix and reports tokens/s and the host-traffic accounting.

Runs on the CUDA device unless ``--device cpu`` is given.  ``--kernels
pallas`` routes every dense projection through the hand-written
``tiled_matmul`` kernel and ``--attn pallas`` the paged attention
through the hand-written decode and chunked-prefill kernels.  The
reference serves reduced configs in this driver; ``--full-width`` serves
the architecture at its published widths.
"""
from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
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
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.spec import (ExecutionSpec, MemorySpec,
                                       RuntimeSpec, SchedulerSpec)
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    ex_kw = {}
    if args.param_dtype is not None:
        ex_kw["param_dtype"] = args.param_dtype
    if args.compute_dtype is not None:
        ex_kw["compute_dtype"] = args.compute_dtype
    spec = RuntimeSpec(
        arch=cfg,
        execution=ExecutionSpec(matmul_backend=args.kernels,
                                paged_attn_impl=args.attn, **ex_kw),
        memory=MemorySpec(cache_layout="paged", max_batch=args.max_batch,
                          max_len=args.max_len, block_size=args.block_size,
                          num_blocks=args.num_blocks),
        scheduler=SchedulerSpec(chunk_size=args.chunk_size))
    device = resolve_device(args.device)
    sampling = SamplingParams(temperature=args.temperature, top_k=40)
    eng = ServingEngine(spec, device=device, sampling=sampling,
                        seed=args.seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    eng.load(Model.from_spec(spec, device=device).init(gen).state_dict())

    rs = np.random.default_rng(7)
    for _ in range(args.requests):
        plen = int(rs.integers(4, args.max_len // 2))
        eng.submit(rs.integers(0, cfg.vocab_size, plen).tolist(),
                   max_new_tokens=args.max_new)
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
    print(f"{cfg.name} on {name}: {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:,.1f} tok/s)")
    print(f"host traffic: {eng.stats['device_gets']} bulk transfers over "
          f"{eng.stats['decode_steps']} fused steps")
    s = eng.memory_stats()
    print(f"paged pool: {s.total_blocks} x {spec.memory.block_size}-token "
          f"blocks, {eng.stats['preemptions']} preemptions")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt[:6]={r.prompt[:6]} -> "
              f"{r.generated[:10]}...")


if __name__ == "__main__":
    main()
