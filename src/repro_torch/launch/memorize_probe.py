"""Memorization at full width, over learning rates and seeds, on the card:
``python src/repro_torch/launch/memorize_probe.py --lrs 3e-3 2e-3 1e-3``.

qwen1.5-0.5b at its published widths and all 24 layers (f32 masters,
bf16 compute) trains on the reference quickstart's corpus
(``MemorizationStream(n_rows=4, seq_len=32, batch=4)``) with its AdamW
(warmup 5, no decay, cosine over the steps) at each learning rate and
weight seed; then a graphed engine on the kernel path (paged, chunks of
16, ``tiled_matmul`` and the paged walks) serves the trained masters and
greedily continues each row's first 8 tokens.  Prints, per run, the
losses every 6 steps and the memorized tokens of each row out of 8:
what ``chip_smoke.py`` phase 20's learning rate is chosen from.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec)
from repro_torch.data.pipeline import MemorizationStream
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                             make_step_fn)

PROMPT = 8


def run(cfg, lr: float, seed: int, steps: int, dev) -> str:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = Model(cfg, device=dev, trainable=True)
    oc = AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps,
                     weight_decay=0.0)
    state = init_state(model, g, oc)
    step = make_step_fn(model, TrainStepConfig(optimizer=oc))
    stream = MemorizationStream(vocab_size=cfg.vocab_size, seq_len=32,
                                batch=4, n_rows=4, device=dev)
    losses = []
    for _ in range(steps):
        state, m = step(state, stream.next())
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    eng = ServingEngine(RuntimeSpec(
        arch=cfg,
        execution=ExecutionSpec(matmul_backend="pallas",
                                paged_attn_impl="pallas",
                                compute_dtype="bf16"),
        memory=MemorySpec(cache_layout="paged", max_batch=8, max_len=512,
                          block_size=16),
        scheduler=SchedulerSpec(chunk_size=16)), device=dev)
    eng.load(state.params)
    rows = stream.corpus.tolist()
    uids = {eng.submit(r[:PROMPT], max_new_tokens=PROMPT): i
            for i, r in enumerate(rows)}
    got = {uids[r.uid]: r.generated for r in eng.run_to_completion()}
    hits = [sum(a == b for a, b in zip(got[i], r[PROMPT:2 * PROMPT]))
            for i, r in enumerate(rows)]
    return (f"seed {seed} lr {lr:g}: losses "
            + " ".join(f"{x:.3f}" for x in losses[::6])
            + f" ... {losses[-1]:.4f}; memorized {hits} of {PROMPT}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", type=float, nargs="+",
                    default=[3e-3, 2e-3, 1e-3])
    ap.add_argument("--seeds", type=int, nargs="+", default=[20, 21, 22])
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config("qwen1.5-0.5b")
    for seed in args.seeds:
        for lr in args.lrs:
            t0 = time.perf_counter()
            line = run(cfg, lr, seed, args.steps, dev)
            print(f"{line}; {time.perf_counter() - t0:.1f} s", flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
