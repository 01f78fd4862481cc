"""Bit-for-bit comparison of a kernel's outputs between two source trees.

``save`` runs ``paged_decode_attention`` on a CUDA card at the serving
shape of ``chip_smoke.py`` phase 2 (8 sequences, 32 pool blocks of 16
positions, lengths 1-512) in its six (q, pool, heads) cases, at head dims
16, 32, 64 and 128, on inputs made from a numpy seed, and saves the
outputs.  ``compare`` holds two saves against each other with
``torch.equal``.  The kernels come from whichever ``repro_torch`` is on
the path, so the same script measures a parent tree and a change::

    PYTHONPATH=<parent>/src python src/repro_torch/launch/kernel_bits.py \\
        save parent.pt
    PYTHONPATH=src python src/repro_torch/launch/kernel_bits.py save new.pt
    python src/repro_torch/launch/kernel_bits.py compare parent.pt new.pt
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# (q dtype, pool dtype, heads, kv heads): chip_smoke.py phase 2's cases
CASES = (("bf16", "bf16", 16, 16), ("f32", "bf16", 16, 16),
         ("f32", "f32", 16, 16), ("bf16", "bf16", 16, 4),
         ("f32", "int8", 16, 16), ("bf16", "int8", 16, 16))
HEAD_DIMS = (16, 32, 64, 128)
LENGTHS = (1, 17, 100, 255, 256, 300, 511, 512)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def decode_outputs(seed: int = 0) -> dict[str, torch.Tensor]:
    """``paged_decode_attention`` at every case, keyed by case name."""
    from repro_torch.kernels.paged_attention import paged_decode_attention
    dev = torch.device("cuda")
    B, bs, nblk = len(LENGTHS), 16, 32
    nb = B * nblk + 1
    out = {}
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
            for b, n in enumerate(LENGTHS):
                tables[b, -(-n // bs):] = 0
            q = torch.from_numpy(rs.randn(B, h, hd).astype(np.float32))
            o = paged_decode_attention(
                q.to(dev, DTYPES[q_dt]), k.to(dev), v.to(dev),
                torch.from_numpy(tables.astype(np.int32)).to(dev),
                torch.tensor(LENGTHS, dtype=torch.int32, device=dev), **sc)
            out[f"hd{hd} q={q_dt} pool={kv_dt} h={h} kv={kv}"] = o.cpu()
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("save").add_argument("path")
    cmp = sub.add_parser("compare")
    cmp.add_argument("a")
    cmp.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        if not torch.cuda.is_available():
            print("kernel_bits: no CUDA device is visible", file=sys.stderr)
            return 1
        torch.save(decode_outputs(), args.path)
        return 0
    a, b = torch.load(args.a), torch.load(args.b)
    if a.keys() != b.keys():
        print(f"kernel_bits: the saves hold other cases: {sorted(a)} vs "
              f"{sorted(b)}")
        return 1
    same = [k for k in a if torch.equal(a[k], b[k])]
    for k in a:
        print(f"{k}: {'equal' if k in same else 'DIFFERENT'}")
    print(f"paged_decode_attention: {len(same)}/{len(a)} outputs bit for bit "
          "equal")
    return 0 if len(same) == len(a) else 1


if __name__ == "__main__":
    sys.exit(main())
