"""AdamW and its schedule (the reference's ``training/optimizer.py``).

The state is keyed by the model's parameter names (``layers.3.attn.wq.
kernel``): ``m`` and ``v`` are dicts of tensors beside the parameters,
in ``moment_dtype`` (bfloat16 halves the optimizer's memory), and
``step`` an int32 scalar on the parameters' device.  Every quantity the
update reads (the step, the learning rate, the bias corrections, the
gradient norm) stays on the device: a step reads nothing back to the
host.  ``adamw_update`` computes in float32 and writes the parameters
and moments in place, under ``no_grad``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

# the reference's ``_is_decayed`` list: a leaf whose name's last component
# holds any of these is not decayed (norm scales, biases, gate biases);
# everything else is, quirks included (``a_log`` holds none of them)
NO_DECAY = ("bias", "scale", "ln", "_g", "_b", "b1", "b2", "bq", "bk", "bv",
            "bo", "conv_b", "gate_in_b", "gate_a_b", "a_param", "d_skip")


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar
    m: dict[str, torch.Tensor]      # first moments, by parameter name
    v: dict[str, torch.Tensor]      # second moments, by parameter name


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: torch.dtype = torch.float32


def adamw_init(params: dict[str, torch.Tensor],
               cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device) for n, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def cosine_lr(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio * lr``, in float32;
    ``step`` a tensor (the result on its device) or an int."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (one norm a leaf,
    then the norm of those)."""
    norms = torch._foreach_norm([t.float() for t in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in grads.items()}, norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def is_decayed(name: str) -> bool:
    """Weight decay applies to matrices, not to norms or biases: the
    reference's rule over its last path key, which is the last component
    of the port's name."""
    last = name.rsplit(".", 1)[-1]
    return not any(t in last for t in NO_DECAY)


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: AdamWState,
                 cfg: AdamWConfig, grad_norm: torch.Tensor | None = None
                 ) -> tuple[dict[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step, in place: the gradients clipped to ``clip_norm``
    (scaled in place), the step advanced, the moments and parameters
    rewritten.  Returns (params, state, metrics) — the same tensors — with
    ``lr`` and ``grad_norm`` as device scalars.  The arithmetic is the
    reference's, leaf by leaf in float32, as multi-tensor (``_foreach``)
    operators over all leaves at once: a few dozen launches a step rather
    than ~14 for each of hundreds of leaves, with two parameter-sized
    float32 temporaries (and float32 copies of bfloat16 moments).

    ``grad_norm`` (on the parameters' device) replaces ``global_norm(
    grads)`` where the leaves are one rank's shards: the sharded step
    passes the norm of the whole logical gradient, so every shard clips
    by the one scale."""
    names = list(params)
    if grad_norm is None:
        grad_norm = global_norm(grads)
    g = [grads[n].float() for n in names]
    torch._foreach_mul_(g, _clip_scale(grad_norm, cfg.clip_norm))
    state.step.add_(1)
    step = state.step.float()
    lr = cosine_lr(step, cfg)
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    m = [state.m[n].float() for n in names]
    v = [state.v[n].float() for n in names]
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
    # update = (m / b1c) / (sqrt(v / b2c) + eps)  (+ wd p where decayed)
    denom = torch._foreach_div(v, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(m, b1c)
    torch._foreach_div_(upd, denom)
    del denom
    p32 = [params[n].float() for n in names]
    if cfg.weight_decay:
        dec = [i for i, n in enumerate(names) if is_decayed(n)]
        torch._foreach_add_([upd[i] for i in dec], [p32[i] for i in dec],
                            alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(p32, upd)
    # write back where a leaf is not float32 (float32 ones were updated
    # in place above)
    for out, new in ((params, p32), (state.m, m), (state.v, v)):
        cast = [(out[n], t) for n, t in zip(names, new) if out[n] is not t]
        if cast:
            torch._foreach_copy_(*map(list, zip(*cast)))
    return params, state, {"lr": lr, "grad_norm": grad_norm}
