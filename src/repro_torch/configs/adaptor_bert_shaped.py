"""adaptor-bert-shaped — a fleet member at the paper's BERT widths.

The paper's primary evaluation network, adaptor-bert (§6; the reference's
``configs/adaptor_bert.py``: 12 layers, d_model 768, 12 heads of 64, d_ff
3072, vocab 30522), is an encoder with GELU and LayerNorm.  A fleet runs
one structural template, so this member takes adaptor-bert's widths on
qwen1.5-0.5b's template (rmsnorm, swiglu, RoPE theta 1e6, QKV bias, tied
embeddings), as the reference's multi-topology test builds its
"adaptor-bert-shaped" member on the reduced qwen template
(``tests/test_multi_topology.py``).  Beside qwen1.5-0.5b it differs on
every register the fabric adapts over: heads, layers, d_model, d_ff,
vocab.
"""
import dataclasses

from repro_torch.configs import qwen1_5_0_5b

CONFIG = dataclasses.replace(
    qwen1_5_0_5b.CONFIG,
    name="adaptor-bert-shaped",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3_072,
    vocab_size=30_522,
    head_dim=64,
    max_position_embeddings=512,
    source="paper §6 adaptor-bert widths on qwen1.5-0.5b's template",
)
