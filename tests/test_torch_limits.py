"""What the port refuses, and the ROADMAP item each refusal names.

A fleet (``maxima=``) refuses a member of a family other than the dense
one with the reference's message and tensor parallelism with the
reference's (item 13 ported the mesh), and its engine
refuses the matmul kernels as the reference's does; it serves the dense layout and the bucketed scheduler
(tests/test_torch_bucketed.py), the prefix cache
(tests/test_torch_prefix.py), its own int8 weight table
(tests/test_torch_fleet_quant.py) and speculation
(tests/test_torch_speculative.py).  ``flash_attention``'s kernel
puts the (b, h) pairs, the column groups of any hd and the chunks of
65535 query tiles on its grid's x dimension, so it takes every hd and Sq
the reference takes and refuses only what the hardware's grid cannot hold
(2^31 CTAs on x).  Untied embeddings are served (the dense family's
parity tests are in tests/test_torch_dense_family.py).
"""
import dataclasses

import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, MeshSpec,
                                   RuntimeSpec, SchedulerSpec, maxima_for)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CFG = reduced(get_config("qwen1.5-0.5b"))
MAXIMA = maxima_for(CFG, seq_max=64)
PAGED = dict(cache_layout="paged", max_len=64, block_size=8)


def test_model_names_items_11_12_for_other_families():
    """Every family of the reference is a model of the port: the vlm
    family (tests/test_torch_vlm.py), the ssm (tests/test_torch_ssm.py),
    the audio (tests/test_torch_audio.py) and the encoder family
    (tests/test_torch_encoder.py) build; a config whose family and
    sub-config disagree, or a family the reference has not, is refused
    naming items 11-12."""
    Model(dataclasses.replace(get_config("phi-3-vision-4.2b"), num_layers=1,
                              d_model=64, num_heads=4, num_kv_heads=4,
                              head_dim=16, d_ff=128, vocab_size=128),
          device="cpu")
    Model(reduced(get_config("whisper-medium")), device="cpu")
    enc = Model(reduced(get_config("adaptor-bert")), device="cpu")
    assert enc.cfg.family == "encoder" and enc.pos_embed is not None
    for cfg in (dataclasses.replace(CFG, family="ssm"),
                dataclasses.replace(CFG, family="retnet")):
        with pytest.raises(ValueError, match="Queue 1 items 11-12"):
            Model(cfg, device="cpu")


@pytest.mark.parametrize("B,H,Sq,hd", [
    (1, 65536, 64, 64),          # B * H past 65535
    (4096, 64, 1, 128),          # 262144 (b, h) pairs of one query each
    (1, 1, 65535 * 64, 16),      # the most query tiles y once held
    (1, 1, 64, 256),             # recurrentgemma's hd (fault D)
    (1, 1, 65535 * 64 + 1, 64),  # one query tile past the old y limit
    (1, 8, 512, 512),            # hd 512: four column groups
    (1, 1, 64, 200),             # a ragged hd past 128
    (2 ** 15, 2 ** 16 - 1, 1, 64),   # 2^31 - 2^15 CTAs on x
    (1, 1, 64, 65536 * 128),     # 65536 column groups
])
def test_flash_grid_takes_what_its_grid_holds(B, H, Sq, hd):
    fa.check_grid(B, H, Sq, hd)


@pytest.mark.parametrize("B,H,Sq,hd", [
    (2 ** 16, 2 ** 15, 1, 64),   # B * H = 2^31
    (2 ** 15, 2 ** 15, 65536 * 64, 64),  # 2^30 pairs x 2 tile chunks
    (1, 2 ** 16, 1, 2 ** 15 * 128),  # 2^16 heads x 2^15 column groups
])
def test_flash_grid_refuses_what_it_cannot_hold(B, H, Sq, hd):
    with pytest.raises(ValueError, match="flash_attention: the kernel takes"):
        fa.check_grid(B, H, Sq, hd)


@pytest.mark.parametrize("change,match", [
    # the case keeps the id it had while the mesh was refused (item 13)
    pytest.param(dict(mesh=MeshSpec(tp=2)),
                 "mesh.tp > 1 is not supported in multi-topology",
                 id="change0-ROADMAP.md Queue 1 item 13"),
    (dict(arch=reduced(get_config("whisper-medium"))),
     "family 'audio' needs its own engine"),
])
def test_fleet_refusals_name_their_items(change, match):
    """Tensor parallelism is refused with the reference's message (the
    fabric's weight-table gathers are not sharded); an audio member with
    the reference fabric's (its ``check_member``)."""
    kw = dict(arch=CFG, maxima=MAXIMA, memory=MemorySpec(**PAGED))
    with pytest.raises(ValueError, match=match):
        RuntimeSpec(**{**kw, **change})


@pytest.mark.parametrize("change", [
    dict(memory=MemorySpec(max_len=64)),
    dict(scheduler=SchedulerSpec(policy="bucketed")),
])
def test_fleet_serves_the_dense_layout_and_the_bucketed_scheduler(change):
    """What item 12b lifted: a fleet on the dense layout (``"auto"``
    resolving to chunked) and a fleet on the bucketed scheduler."""
    kw = dict(arch=CFG, maxima=MAXIMA, memory=MemorySpec(**PAGED))
    spec = RuntimeSpec(**{**kw, **change})
    eng = ServingEngine(spec, max_models=2, device="cpu")
    assert eng.scheduler == spec.scheduler.policy.replace("auto", "chunked")
    assert (eng.paging is None) == (spec.memory.cache_layout == "dense")


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
