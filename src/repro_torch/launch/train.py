"""Training driver: ``python -m repro_torch.launch.train --arch <id>``
(``--model`` is the same flag).

The reference's ``launch/train.py`` on one device: the synthetic data
stream -> the train step -> checkpoints -> a resumable restart.  The
reduced config by default (``--full``: the published one), on the CUDA
device unless ``--device cpu`` is given (without a card the default
raises, as every entry point of the port does).  f32 master weights,
bf16 compute, AdamW with the reference's schedule (warmup over a
twentieth of ``--steps``); ``--remat`` recomputes each layer in the
backward.  Every family trains, the hybrid (recurrentgemma-2b) and ssm
(falcon-mamba-7b) ones through their scans' backward kernels on the card.
The synthetic stream carries tokens only, so an audio
model, whose encoder needs frames, is refused by its loss, as the
reference's driver fails on it.

Every ``--ckpt-every`` steps the state and the stream's position are
saved (asynchronously; the last save at the end is synchronous), and
``--resume`` restarts from the newest committed step with the batch that
step would have drawn next.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import REMAT_MODES, Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                             make_train_step)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) architecture config")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--remat", default="none", choices=REMAT_MODES)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    model = Model(cfg, device=device, trainable=True, remat=args.remat)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    step_fn = make_train_step(model, TrainStepConfig(optimizer=opt_cfg,
                                                     accum_steps=args.accum))
    data = dict(vocab_size=cfg.vocab_size, seq_len=args.seq,
                global_batch=args.batch, device=device)
    stream = SyntheticLMStream(**data)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_state(model, gen, opt_cfg)
    start_step = 0
    if args.resume and args.ckpt_dir:
        got = ckpt.restore_latest(args.ckpt_dir, state)
        if got is not None:
            state, meta = got
            start_step = meta["step"]
            stream = SyntheticLMStream.restore(meta["data_state"], **data)
            print(f"resumed from step {start_step}")

    writers = []
    t0 = time.time()
    for i in range(start_step, args.steps):
        state, metrics = step_fn(state, stream.next())
        if (i + 1) % args.log_every == 0 or i == start_step:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            tok_s = (i + 1 - start_step) * args.batch * args.seq / dt
            print(f"step {i + 1:5d}  loss {loss:7.4f}  "
                  f"lr {float(metrics['lr']):.2e}  {tok_s:,.0f} tok/s",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            writers.append(ckpt.save(args.ckpt_dir, i + 1, state,
                                     meta={"data_state": stream.state()},
                                     async_write=True))
    for w in writers:
        w.join()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state,
                  meta={"data_state": stream.state()})
    print("done")


if __name__ == "__main__":
    main()
