"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each module holds one kernel's wrapper (CUDA tensors launch the kernel
built from ``repro_torch/csrc``, CPU tensors run the plain version, any
other device raises), the plain version itself, and the wrapper's launch
count:

* serving path: ``tiled_matmul``, ``int8_matmul``, ``paged_attention``
  (``paged_decode_attention``), ``chunked_prefill``;
* the kernel library: ``layernorm`` (``layernorm``, ``rmsnorm``), ``ffn``
  (``ffn1``, ``ffn1_gated``), ``qkv_proj``, ``flash_attention``.

``ops`` is the public kernel API with the reference's names (leading dims
folded into rows); ``runtime`` builds and loads the library.
"""
