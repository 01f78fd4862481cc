"""What the port refuses, and the ROADMAP item each refusal names.

A fleet (``maxima=``) refuses int8 weights (its int8 weight table, item
8b), the dense layout and the bucketed scheduler (item 12) and the prefix
cache (item 9), and its engine refuses the matmul kernels as the
reference's does.  ``flash_attention``'s kernel puts B * H on its grid's
x dimension, so it refuses only what the grid cannot hold (ROADMAP Queue
3 fault D).  Untied embeddings are served (the dense family's parity
tests are in tests/test_torch_dense_family.py).
"""
import dataclasses

import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, maxima_for)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine

CFG = reduced(get_config("qwen1.5-0.5b"))
MAXIMA = maxima_for(CFG, seq_max=64)
PAGED = dict(cache_layout="paged", max_len=64, block_size=8)


def test_model_names_items_11_12_for_other_families():
    with pytest.raises(ValueError, match="Queue 1 items 11-12"):
        Model(dataclasses.replace(CFG, family="moe"), device="cpu")


@pytest.mark.parametrize("B,H,Sq,hd", [
    (1, 65536, 64, 64),          # B * H past 65535: the grid's x dimension
    (4096, 64, 1, 128),          # 262144 (b, h) pairs of one query each
    (1, 1, 65535 * 64, 16),      # the most query tiles the y dimension holds
])
def test_flash_grid_takes_what_its_grid_holds(B, H, Sq, hd):
    fa.check_grid(B, H, Sq, hd)


@pytest.mark.parametrize("B,H,Sq,hd", [
    (1, 1, 64, 256),             # recurrentgemma's hd (fault D, still open)
    (1, 1, 65535 * 64 + 1, 64),  # one query tile past the y dimension
    (2 ** 16, 2 ** 15, 1, 64),   # B * H = 2^31
])
def test_flash_grid_refuses_what_it_cannot_hold(B, H, Sq, hd):
    with pytest.raises(ValueError, match="flash_attention: the kernel takes"):
        fa.check_grid(B, H, Sq, hd)


@pytest.mark.parametrize("change,item", [
    (dict(execution=ExecutionSpec(quant="int8")), "item 8b"),
    (dict(memory=MemorySpec(max_len=64)), "item 12"),
    (dict(scheduler=SchedulerSpec(policy="bucketed")), "item 12"),
    (dict(memory=MemorySpec(prefix_cache=True, **PAGED)), "item 9"),
])
def test_fleet_refusals_name_their_items(change, item):
    kw = dict(arch=CFG, maxima=MAXIMA, memory=MemorySpec(**PAGED))
    with pytest.raises(ValueError, match=f"ROADMAP.md Queue 1 {item}"):
        RuntimeSpec(**{**kw, **change})


def test_fleet_refuses_the_matmul_kernels_as_the_reference_does():
    spec = RuntimeSpec(arch=CFG, maxima=MAXIMA, memory=MemorySpec(**PAGED),
                       execution=ExecutionSpec(matmul_backend="pallas"))
    with pytest.raises(ValueError, match="not yet supported in "
                                         "multi-topology mode"):
        ServingEngine(spec, device="cpu")


def test_fleet_spec_must_fit_its_own_maxima():
    with pytest.raises(ValueError, match="does not fit its own maxima"):
        RuntimeSpec(arch=CFG, maxima=maxima_for(CFG, seq_max=32),
                    memory=MemorySpec(**PAGED))
