"""Bit-for-bit comparison of the paged attention kernels' outputs between
two source trees.

``save`` runs ``paged_decode_attention`` and ``chunked_prefill_attention``
on a CUDA card at the serving shape of ``chip_smoke.py`` phase 2 (8
sequences, 32 pool blocks of 16 positions; decode lengths 1-512, chunks of
16 lanes from positions 0-496) in its six (q, pool, heads) cases, at head
dims 16, 32, 64, 96 and 128, on inputs made from a numpy seed, and saves
the outputs with the grid each launch took.  The chunk kernel runs at its
own key-range plan and at 1 and 3 ranges fixed, since the plan follows
the compiled walk's occupancy (its registers), which may differ between
two trees whose arithmetic is the same.  ``compare`` holds two saves
against each other with
``torch.equal``, counts the equal outputs per kernel and prints the
grids that differ; it fails if an output of a ``--require``d kernel
(default: both) differs.  The kernels come from whichever ``repro_torch``
is on the path, so the same script measures a parent tree and a change::

    PYTHONPATH=<parent>/src python src/repro_torch/launch/kernel_bits.py \\
        save parent.pt
    PYTHONPATH=src python src/repro_torch/launch/kernel_bits.py save new.pt
    python src/repro_torch/launch/kernel_bits.py compare parent.pt new.pt \\
        --require chunked_prefill_attention
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from unittest import mock

import numpy as np
import torch

KERNELS = ("paged_decode_attention", "chunked_prefill_attention")
# (q dtype, pool dtype, heads, kv heads): chip_smoke.py phase 2's cases
CASES = (("bf16", "bf16", 16, 16), ("f32", "bf16", 16, 16),
         ("f32", "f32", 16, 16), ("bf16", "bf16", 16, 4),
         ("f32", "int8", 16, 16), ("bf16", "int8", 16, 16))
HEAD_DIMS = (16, 32, 64, 96, 128)
LENGTHS = (1, 17, 100, 255, 256, 300, 511, 512)
CHUNK_STARTS = (0, 16, 48, 100, 203, 300, 400, 496)
CHUNK_W = 16
CHUNK_SPLITS = ("plan", 1, 3)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def outputs(seed: int = 0) -> tuple[dict, dict]:
    """Both kernels at every case, keyed by kernel, case and key ranges,
    and the grid of each launch where the tree records one."""
    from repro_torch.kernels import chunked_prefill as cp
    from repro_torch.kernels.paged_attention import paged_decode_attention
    dev = torch.device("cuda")
    B, bs, nblk = len(LENGTHS), 16, 32
    nb = B * nblk + 1
    out, grids = {}, {}
    for name in KERNELS:
        decode = name == "paged_decode_attention"
        reach = LENGTHS if decode else [s + CHUNK_W for s in CHUNK_STARTS]
        for hd in HEAD_DIMS:
            for q_dt, kv_dt, h, kv in CASES:
                rs = np.random.RandomState(seed + hd)
                if kv_dt == "int8":
                    k, v = (torch.from_numpy(rs.randint(-127, 128, (
                        nb, bs, kv, hd)).astype(np.int8)) for _ in range(2))
                    sc = {n: torch.from_numpy(rs.uniform(5e-3, 3e-2, (
                        nb, bs, kv)).astype(np.float32)).to(dev)
                        for n in ("k_scale", "v_scale")}
                else:
                    k, v = (torch.from_numpy(rs.randn(nb, bs, kv, hd).astype(
                        np.float32)).to(DTYPES[kv_dt]) for _ in range(2))
                    sc = {}
                tables = (rs.permutation(nb - 1) + 1).reshape(B, nblk)
                for b, n in enumerate(reach):
                    tables[b, -(-n // bs):] = 0
                tables = torch.from_numpy(tables.astype(np.int32)).to(dev)
                shape = (B, h, hd) if decode else (B, CHUNK_W, h, hd)
                q = torch.from_numpy(rs.randn(*shape).astype(np.float32))
                q = q.to(dev, DTYPES[q_dt])
                key = f"{name} hd{hd} q={q_dt} pool={kv_dt} h={h} kv={kv}"
                if decode:
                    out[key] = paged_decode_attention(
                        q, k.to(dev), v.to(dev), tables,
                        torch.tensor(LENGTHS, dtype=torch.int32, device=dev),
                        **sc).cpu()
                    grids[key] = getattr(paged_decode_attention,
                                         "last_grid", None)
                    continue
                start = torch.tensor(CHUNK_STARTS, dtype=torch.int32,
                                     device=dev)
                for splits in CHUNK_SPLITS:
                    fixed = contextlib.nullcontext() if splits == "plan" \
                        else mock.patch.object(cp, "kv_splits",
                                               lambda *a, s=splits: s)
                    with fixed:
                        o = cp.chunked_prefill_attention(
                            q, k.to(dev), v.to(dev), tables, start, **sc)
                    out[f"{key} splits={splits}"] = o.cpu()
                    grids[f"{key} splits={splits}"] = \
                        cp.chunked_prefill_attention.last_grid
    return out, grids


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("save").add_argument("path")
    cmp = sub.add_parser("compare")
    cmp.add_argument("a")
    cmp.add_argument("b")
    cmp.add_argument("--require", nargs="+", choices=KERNELS,
                     default=list(KERNELS))
    args = ap.parse_args(argv)
    if args.cmd == "save":
        if not torch.cuda.is_available():
            print("kernel_bits: no CUDA device is visible", file=sys.stderr)
            return 1
        out, grids = outputs()
        torch.save({"outputs": out, "grids": grids}, args.path)
        return 0
    sa, sb = torch.load(args.a), torch.load(args.b)
    a, b = sa["outputs"], sb["outputs"]
    if a.keys() != b.keys():
        print(f"kernel_bits: the saves hold other cases: {sorted(a)} vs "
              f"{sorted(b)}")
        return 1
    ok = True
    for name in KERNELS:
        keys = [k for k in a if k.split()[0] == name]
        same = [k for k in keys if torch.equal(a[k], b[k])]
        for k in keys:
            ga, gb = sa["grids"][k], sb["grids"][k]
            print(f"{k}: {'equal' if k in same else 'DIFFERENT'}"
                  + (f" (grids {ga} vs {gb})" if ga != gb else ""))
        print(f"{name}: {len(same)}/{len(keys)} outputs bit for bit equal"
              + ("" if name in args.require else " (not required)"))
        ok &= name not in args.require or len(same) == len(keys)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
