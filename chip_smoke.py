"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``), build the
   hand-written kernels from ``src/repro_torch/csrc`` and print the build
   time.
2. Hold each kernel against its plain PyTorch version on the card, on the
   same inputs, and time kernel, plain version, a PyTorch library call and
   the bound.  The serving kernels at the main path's shapes (bf16, f32,
   GQA n_rep > 1; for attention, lengths with partial last blocks and
   null-block table entries, the null block and the unseen tail of each
   sequence's last block filled with NaN so a read of them would show, and
   an int8 pool whose scales there are NaN).  ``int8_matmul`` must be
   bit-identical at the six serving shapes (bf16 and f32 out, each with
   the grid it launched and the bf16 ``torch.matmul`` time beside
   ``torch._int_mm``'s), at every plan of BM, BN and K ranges there, at
   ragged shapes and at a product whose plan splits K, which also runs
   once under ``set_sync_debug_mode("error")``.  The paged attention
   kernels also at the head dims and GQA widths of ROADMAP Queue 3 fault
   A (hd 96; GQA 8 x hd 128: decode, and chunk at W 16 and 32), both
   over fixed key-range counts, each case with the grid it launched, and
   one split call of each under ``set_sync_debug_mode("error")``; both
   with ``live_kv`` (the fleet's dead kv groups, NaN in their queries and
   pool rows) at the fleet's shape (16 heads of 64, groups 12-15 dead on
   every other slot) and at hd 96 and GQA 8 x hd 128, the dead groups'
   outputs bit-exact zeros at the planned and at 1 and 3 key ranges, and
   the chunk walk so at W = 4 (a speculating fleet's verify); both at the
   head dims of ROADMAP Queue 3 fault F, which run the walk's general
   bodies: recurrentgemma-2b's 10 heads over 1 kv head of 256 over bf16,
   f32 and int8 pools, hd 192 and the ragged hd 72 (16-byte bf16 rows)
   and 66 (4-byte rows) over bf16 and int8 pools, decode and chunk at W
   16, each with its column groups; the build prints the split walk's
   (both entry points')
   registers and spills, and those of every instantiation of the flash
   kernels (hd <= 128 and the column-group kernels past it), of the bf16
   matmul loop (``mma_tile``, ``mma_reduce``), of the int8 kernel
   (``int8_mma``, ``int8_reduce``) and of the norms (``norm_regs``,
   ``norm_stream``), which must not spill.
   ``tiled_matmul`` at the six bf16 serving shapes (a decode and a mixed
   step against each weight shape), each with the grid it
   launched (tiles x K ranges) and its dynamic shared memory, a second
   run bit-equal to the first, and one split call under
   ``set_sync_debug_mode("error")``.  ``rmsnorm`` and ``layernorm`` at
   every shape of ``launch/timing.py``'s ``NORM_SHAPES`` (qwen1.5-0.5b's
   decode and mixed steps and a 16K-token prefill, qwen2-72b's mixed step
   and an 8K-token prefill, adaptor_bert, whisper-medium's encoder; D 65,
   3000 and 65536; an x one element past an aligned address), in bf16
   and f32, timed with float32 parameters and gated again with bfloat16
   ones, each with the plan it launched, after the Timer's floor (one
   launch of a 1-element fill).  The four other kernels of the kernel
   library (``ffn1``, ``ffn1_gated``, ``qkv_proj``,
   ``flash_attention``) at the full widths of qwen1.5-0.5b,
   qwen2-72b (GQA ``qkv_proj``), adaptor_bert and whisper-medium (cross
   attention over 1500 frames), in bf16 and f32; ``qkv_proj`` must equal
   three ``tiled_matmul`` launches bit for bit; the matmul rows print
   their grid and dynamic shared memory.  ``flash_attention`` also
   runs a causal qwen2-72b-width prompt (64 heads of 128),
   recurrentgemma-2b's local attention (10 heads of 256 over a 2048
   window, causal) and a causal hd 512 prompt (ROADMAP Queue 3 fault D:
   column groups), with the kernels SDPA launches at hd 512; gated but
   not timed, three ragged head dims over 1000 keys (80, 36, 200) and,
   in bf16, one query tile past the old 65535-tile limit ([1, 65535 x 64
   + 1 | 64, 1, 32]); each flash shape prints its grid (query-tile CTAs
   x column groups x key ranges).
3. The kernel library entry point ``repro_torch.kernels.ops``: every
   function on CUDA tensors with leading batch dims, chained as one
   qwen1.5-0.5b-wide layer, each result against the plain versions; each
   of the six library kernels must launch (counts zeroed just before).
4. Full-width qwen1.5-0.5b (random weights from a fixed generator): one
   mixed step and one decode step on the paged pool through the kernels,
   through their plain versions and through the XLA-style gather path,
   with float weights over a bf16 pool and fully quantized (int8 weights,
   int8 pool).  At float32 compute the kernels' logits must agree with the
   plain versions' within 2e-2 * max|logits|, or within twice the distance
   that perturbing the plain attention outputs by 2^-19 (the kernels' own
   float32 error) makes, where that is larger: the fully quantized model
   carries last-bit changes across int8 rounding boundaries.  At bf16
   compute the distances are printed (there two valid orders of the sums
   already differ by bf16 rounding grown over 24 layers).  The plain
   versions replace every kernel, the norms included.  The PyTorch
   operators each step dispatches on the kernel path are counted, and
   again with the model's norms computed eagerly (``apply_norm`` on its
   ``"xla"`` branch, the route the norms took before they ran through
   their kernel), and both are printed.
5. Serve 8 greedy requests (prompts of 24-400 tokens, 16 new tokens each)
   through the full-width paged, chunked ``ServingEngine`` with every
   kernel selected, with float weights and fully quantized, each on a
   graphed engine (each fused program one CUDA graph, captured once) and
   an eager one: every request must finish, the graphed streams must
   equal the eager ones, ``compilations`` decode = prefill = 1 with no
   eager step, every kernel of each path must be launched in that path's
   run (the counts are zeroed just before it; a graphed drain's launches
   are the wrappers' counts less what the captures recorded plus each
   graph's capture counts times its replays) and as often as in the
   eager run, and ``rmsnorm`` 2L+1 = 49 times per fused step.  The
   graphed engine drains the mix once more on its captured graphs (warm)
   without a capture; a second fresh fully-quantized engine must repeat
   the streams.  Tokens/s, steps, captures, replays and eager steps are
   printed for every drain; the device's idle share (``torch.profiler``
   device time over wall time) and the PyTorch operators per fused step
   for a graphed engine's first drain, a warm one and an eager one.  A
   mixed step captured with ``keep_graph=True`` gives the census of its
   edges: each split ``tiled_matmul``'s reduce, a programmatic dependent
   launch, should be a programmatic edge.  The float run's steps,
   counted from its attention launches, times phase 2's per-call medians
   of the six ``tiled_matmul`` serving shapes give an estimate of the
   drain's matmul device time, printed against the same sum for
   ``torch.matmul``; the fully-quantized run's steps do the same for
   ``int8_matmul`` against the bf16 ``torch.matmul``.  Fault B's check
   (ROADMAP Queue 3): a graphed drain of each kernel path at
   ``sync_every=4`` with every fused step, the captures included, under
   ``set_sync_debug_mode("error")`` must make no host sync and wait for
   no staging buffer; the float streams must equal the sync_every=1
   drain's (the fully-quantized ones are reported: their one activation
   scale spans the rows of slots that finished but wait for a harvest).
   A plain-path engine serves the float requests and the share of
   identical tokens is reported.
6. The multi-topology fleet: one engine at ``maxima_for(qwen1.5-0.5b,
   adaptor-bert-shaped)`` (full widths: 24 layers, 16 heads of 64,
   d_model 1024, d_ff 3072, vocab 151936; random weights) serves the
   phase 5 request mix, requests alternating the members, through the
   paged kernels with ``live_kv``, over a bf16 pool on two graphed
   engines and an eager one and over an int8 pool on two graphed
   engines: every request finishes inside its member's vocab, the
   streams repeat, the graphed bf16 streams and launches equal the eager
   ones with one capture per program, ``live_kv`` launches number 24 per
   fused step, and the first bf16 drain holds fault B's check.  The same
   with the fabric's int8 weight table (ROADMAP Queue 1 item 8b; graphed
   = eager over both pools), which must take under 0.3 of the float
   table's bytes.  Tokens/s, the table's bytes and the peak device memory
   are printed.  Then one mixed and one decode step of the fabric at
   float32 compute, kernels against the gather path, within 2e-2 *
   max|logits|, with either table.
7. The rest of the dense family, whose embeddings are untied:
   phi3-mini-3.8b at full width and 8 of its 32 layers (32 heads of 96) and
   qwen2-72b at full width and 2 of its 80 layers (64 heads of 128 over 8
   kv heads), random weights: one mixed and one decode step at float32
   compute through the kernels within phase 4's gate of the plain
   versions (the untied ``lm_head``'s own float32 error is printed as a
   share of that distance), then the phase 5 request mix on a graphed
   and an eager engine with phase 5's gates, and the launches of the
   paged walks at hd 96 and at GQA 8 x hd 128.
8. The prefix cache with copy-on-write: full-width qwen1.5-0.5b (random
   weights), float weights, the kernel path, graphed, phase 5's engine
   geometry with a pool that preempts nobody.  A warm request (a
   320-token system prompt S + 8 tokens, 4 new) registers S's 20
   blocks; then 8 requests of 16 new tokens: six S + a distinct suffix
   (full-block hits of 320), one S[:312] + a tail diverging at 312 (a
   19-block hit and a copy-on-write fork of block 20's first 8 rows),
   one unrelated prompt (a miss); the same traffic with the cache off.
   Gates: 7 hits, 1 fork, 2232 cached tokens and exactly 2232 fewer
   prefill tokens; the fork's rows bit for bit in every layer right
   after it lands (over a bf16 and an int8 pool, scales included); each
   request's first token equal with the cache on and off over a bf16, an
   int8 and an f32 pool; whole f32 streams equal, or diverging only where
   the two tokens' f32 logits lie within phase 4's f32 distance (printed);
   graphed = eager (streams, one capture per program, launches); no host
   sync in a fused step or a fork at sync_every=4; a 40-block pool
   evicts parked blocks and keeps the first tokens; the fully-quantized
   drain's identical tokens printed.  Prefill tokens, the hit requests'
   TTFT (``admit`` to ``first_token`` events) and the wave's tokens/s are
   printed, cache on and off.  Inside phase 6, one graphed fleet engine
   with the prefix cache serves both members the same prompts: each hits
   only its own member's chain.
9. Speculative decoding (k = 3): full-width qwen1.5-0.5b at 5 of its
   24 layers (random weights; cut since phases 11, 12, 17 and 20 joined,
   for run time),
   the kernel path, graphed, phase 5's engine and request mix.
   (a) A self-draft (the target's own weights) against speculation off:
   f32 streams (float32 pools) equal, or diverging only where the two
   tokens' f32 logits lie within phase 4's f32 distance (printed); bf16
   identical tokens printed; fewer fused steps and accepted draft
   tokens; graphed = eager (streams, launches), one capture per program;
   the decode program's capture launches the chunk walk once a layer (the
   verify pass at W = 4) and the decode walk never, ``tiled_matmul`` and
   ``rmsnorm`` once per projection and norm of the target's pass and the
   draft's 4 (the mixed program: 5) passes; an eager drain's walks are
   one a layer a step, at W = 4 on the decode steps; no host sync in a
   fused step at sync_every=4.  (b) A 4-layer draft (the target's
   embedding, first 4 layers and final norm): the same stream, graph and
   launch gates; truncation hands blocks back; with the prefix cache on,
   the pool's used blocks are its parked ones after the drain and none
   leak.  (c)
   The fully quantized engine (int8 weights and pool, the draft
   quantized too): graphed = eager, the launches, a second fresh engine
   repeats the streams; identical tokens against speculation off
   printed.  Warm graphed tokens/s and fused steps for speculation off,
   the self-draft and the 4-layer draft; for both drafts the mean
   accepted length, tokens per step, device ms and the idle share
   (traced warm drain; speculation off is not traced).
   Phase 2 also holds the chunk walk at W = 4 (bf16 and int8 pools),
   ``tiled_matmul`` at the verify pass's 32 rows and ``rmsnorm`` at
   32 x 1024.  The self-draft engine's first drain prints its captures
   timed in parts (eager warm-up; capture and instantiation; first
   replay) beside its compilations, captures, replays and eager steps.
10. A fleet that speculates (ROADMAP Queue 1 item 10b): phase 6's fleet
   and mix with k = 3, qwen1.5-0.5b's weights drafting for both members,
   over a bf16 pool, graphed (first and warm drain) and eager, and graphed
   with the int8 weight table; the same fleet without speculation for
   tokens/s.  Gates: graphed = eager, one capture per program; the
   decode program's capture launches 24 chunk walks, each with
   ``live_kv`` (the verify at W = 4), and no decode walk, with either
   table; every eager walk with ``live_kv``; draft tokens accepted.
11. The MoE family (ROADMAP Queue 1 item 11): granite-moe-1b-a400m at
   full width (24 layers, 32 experts top-8, 16 heads over 8 kv heads of
   64, vocab 49155), random weights from the port's ``init``: one mixed
   and one decode step at f32 compute, the kernels against their plain
   versions within phase 4's gate, the plain versions routed as the
   kernel path was (an expert choice is discontinuous in the router's
   logits: a near-tie that the last bits break the other way moves the
   logits by a token's share of two experts), with the live tokens whose
   own routing differs between the paths printed; then the phase 5 mix
   with float weights and fully quantized (the experts and router stay
   float), each graphed (first and warm drain) and eager, with phase 5's
   gates and 96 matmul launches, 24 walks and 49 ``rmsnorm`` a fused
   step, a sync_every=4 drain under ``set_sync_debug_mode("error")`` and
   a second fresh fully-quantized engine repeating the streams; the warm
   float drain traced (device ms, idle share, the bf16 gemm kernels of
   the expert products against the expert weights' bytes at 3.35 TB/s,
   0.72 ms a step), the expert products also timed alone; and the
   self-draft speculating at k = 3 on granite cut to 4 of its 24 layers
   (run time; 8 until phase 20 joined), graphed and eager: graphed =
   eager, the decode program's capture one chunk walk a layer at W = 4
   (4) and no decode walk.
   Phase 2 holds ``tiled_matmul`` and ``int8_matmul`` (bit-identical)
   at granite's K/V width (8 and 128 x 1024 x 512) and both walks at 16
   heads over 8 kv heads of 64 (decode and W 16, bf16 and int8 pools).
12. The register-driven engine (ROADMAP Queue 1 item 14, the paper's
   claim C1) at the paper's full BERT widths, f32 with TF32 off, each
   fabric one CUDA graph.  Fabric E (``maxima_for`` adaptor-bert,
   shallow-transformer and custom-encoder at 64 positions: 12 heads, 12
   layers, d_model 768, d_ff 3072, head dim 66, 30522 outputs; batch 1)
   serves the three networks, adaptor-bert at 32 positions, a GQA-packed
   topology (12 heads over 4 kv heads) and the Fig. 8 heads sweep (h =
   2..12, d_model 64h, d_ff 256h); fabric D (a 12-layer decoder
   provisioned) two enc-dec topologies (adaptor-bert widths 12 + 12,
   shallow-transformer widths 2 + 2) and encoder-only adaptor-bert without
   target tokens; then fabric E at batch 8 and in bf16, engines of their
   own.  Random networks from the generator through the port's
   ``random_network`` and ``pack``.  Gates: each output's live lanes within
   2e-4 x max|want| (rtol 1e-3) of ``engine_ref.forward`` (bf16: printed),
   the idle-lane case (adaptor-bert loaded, a 6-head 6-layer topology
   selected) within 3e-4, one capture per engine, graphed = eager bit for
   bit, the weight buffers' addresses unchanged across loads, a topology
   switch with its weight load under ``set_sync_debug_mode("error")``, and
   no launch of a hand-written kernel.  Printed: per-call medians graphed
   and eager (``Timer``), the first call's seconds (warm-up, capture,
   replay), one weight load's time, each call's bound (products' FLOPs at
   67 TFLOP/s, bytes at 3.35 TB/s) and the Fig. 8 live-FLOP fractions.

13. The load harness (ROADMAP Queue 1 item 17a, ``repro_torch.harness``)
   on the card, printed after phase 5: ``bursty_trace`` (24 requests in
   bursts of 8 every 8 steps, prompts up to 383 tokens, 8-16 new tokens)
   replayed on a fresh graphed float engine of phase 5's spec (one capture
   per program it runs), again on the same warm engine (no capture) and on
   a fresh eager engine; ``poisson_trace`` (24 arrivals at 0.5 a step) on
   a fresh fully quantized graphed engine; inside phase 8
   ``shared_prefix_trace`` (two families of 320-token prefixes) on its
   graphed cache-on engine, inside phase 6 ``fleet_trace`` (16 requests
   over both members) on its float table's second graphed engine.  Gates:
   every request finishes; each uid has one ``submit``, ``first_token``
   and ``finish`` and admits - preempts = 1; ``deterministic_json()``
   graphed = eager; the warm replay's deterministic view keyed by trace
   rid (uids differ on one engine) = the first's; the prefix replay hits.
   Printed per replay: TTFT and ITL p50/p99 in steps and in ms, goodput
   per second under TTFT <= 64 steps, peak concurrency, preemptions,
   prefix hits, captures.
14. MLA (ROADMAP Queue 1 item 11m): deepseek-v3-671b at its published
   widths (d_model 7168, 128 heads, q_lora 1536, kv_lora 512, rope 64,
   v 128, 256 experts top-8 + 1 shared, vocab 129280), cut to 2 of 61
   layers and ``first_k_dense`` 3 -> 1 so that one dense layer (d_ff
   18432) and one MoE layer run.  (a) One mixed and one decode step at
   f32 compute (weights drawn in place, 55.8 GB), the kernels against
   their plain versions within phase 4's gate, the plain paths replaying
   the kernel path's expert ids, routing flips printed; (b) phase 5's mix
   in bf16 (27.9 GB of weights, at most two engines resident) over a bf16
   and over an int8 latent pool, each graphed (first and warm drain) and
   eager: phase 5's gates, 14 ``tiled_matmul`` and 9 ``rmsnorm`` launches
   a fused step and no paged walk (MLA attends through the gather view,
   as the reference does), the warm bf16-pool drain traced (device ms,
   idle share, the longest kernels), ``max_memory_allocated``.  Phase 2
   holds ``tiled_matmul`` at deepseek-v3's MLA and dense-prefix shapes
   (8 and 128 rows: 7168->1536, 1536->24576, 7168->576, 16384->7168,
   7168->18432, 18432->7168) and ``rmsnorm`` at 128 x 1536 and 128 x 512.

15. The vlm family, the dense layout and the bucketed scheduler (ROADMAP
   Queue 1 items 12a-12b): phi-3-vision-4.2b at its published widths and
   4 of its 32 layers (cut to 8 when phase 16 joined and to 4 when phase
   20 did, for run time), seeded
   random weights.  (a) At f32 compute, along the
   kernels, their plain versions and those perturbed (phase 4's gate): a
   mixed step whose prompt lanes straddle the 576 patch positions
   (``prefill_lanes``) and a decode step, over the paged pool and the
   dense layout, and ``Model.prefill`` of a 1024-token prompt with the
   zero frontend; then the frontend rule: other token ids below position
   576 leave the prefill's logits bit for bit.  (b) bf16, 8 greedy
   requests of 576 + 16-416 tokens x 16 new, max_batch 8, max_len 1024,
   blocks and chunks of 16, on three engines (paged + chunked, dense +
   bucketed, paged + bucketed), each graphed (first and warm drain, then
   a traced warm drain) and eager: graphed = eager streams, the warm drain
   captures nothing, one capture per program and per bucket, every
   drain's launches equal ``kernels/counts.py`` ``program_launches``;
   tok/s, device ms, idle share, peak memory.  Then 3 requests at f32
   compute over float32 pools on the three engines: first tokens equal
   on all three, the two bucketed engines' streams equal (the chunked
   engine's later tokens reported: the bucketed prefill stages the
   prompt's K/V in bf16, as the reference does).  (c) qwen1.5-0.5b on
   phase 5's mix on the bucketed scheduler over the dense layout and the
   paged pool (buckets 32-512) with (b)'s gates, and (b)'s f32 gate on
   the mix.  Phase 2 holds ``tiled_matmul`` and ``int8_matmul`` at
   phi-3-vision's widths (3072->3072, 3072->8192, 8192->3072 at M 8, 128
   and 1024) and at qwen's 512-row bucket, and ``rmsnorm`` at 8 and 1024
   x 3072.

16. The hybrid family (ROADMAP Queue 1 item 12c): recurrentgemma-2b at
   its published widths and 7 of its 26 layers (cut to 13 when phase 17
   joined and to 7 when phase 20 did, for run time; pattern r, r, a: 5
   RG-LRU and 2 local-attention layers, d_model and lru_width 2560, 10 heads
   over 1 kv head of 256, window 2048, GeGLU d_ff 7680, vocab 256000),
   seeded random weights.  (a) At f32 compute, the kernels against their
   plain versions (the plain loop in place of ``rglru_scan``) within
   phase 4's gate: ``Model.prefill`` of a 2300-token prompt (past the
   window: banded attention, wrapped rolling buffers) and 4 decode steps
   over its state; the prefill's launches equal ``program_launches``
   (44 ``tiled_matmul``, 15 ``rmsnorm``, 5 ``rglru_scan``); an explicit
   chunked spec and ``mixed_step`` refused, "auto" bucketed.  (b) bf16
   on dense + bucketed, max_batch 8, max_len 3072 (buckets 32-3072), 8
   greedy requests of 40-3000 tokens x 32 new, graphed (first, warm,
   traced warm) and eager: graphed = eager, one capture per bucket used
   (six) and one of the decode program, no mixed program, launches =
   ``program_launches``; tok/s, device ms by kernel, idle share, peak
   memory.  Phase 2 holds ``tiled_matmul`` and ``int8_matmul`` at
   recurrentgemma's widths (2560->2560, 2560->256, 2560->7680,
   7680->2560 at M 8 and 3072), ``rmsnorm`` at 8 and 3072 x 2560, and
   ``rglru_scan`` bit for bit its plain loop at [1, 3072, 2560] (2300
   real positions, and all), [8, 1, 2560] and [2, 300, 2560] with ragged
   lengths (``timing.RGLRU_SCAN_SHAPES``) and at the 512-token bucket
   three quarters full (its plain loop untimed), timed beside its bound
   (no library call computes it), each call's plan, grid and dynamic
   shared memory printed (``rglru_scan.describe``).

17. The ssm family (ROADMAP Queue 1 item 12d): falcon-mamba-7b at its
   published widths (``check_ssm``): f32 steps at 8 of 64 layers, bf16
   serving at 32 of 64 (all 64 until phase 20 joined; cut for run time)
   on dense + bucketed, a decode step and a prefill timed against their
   bounds; phase 2 holds ``ssm_scan`` bit for bit (``SSM_SCAN_SHAPES``,
   with a Di past a CTA's channels and an S off the tile and the
   checkpoint stride), timed beside its bound and issue floor.

18. The audio family (ROADMAP Queue 1 item 12e): whisper-medium at its
   published widths (``check_audio``), seeded random weights.  (a) At f32
   compute and 4 + 4 of its 24 + 24 layers, the kernel path against the
   plain route (``"xla"``, the same weights) within phase 4's gate:
   ``forward`` over 1500 seeded frames, a 40-token prefill in its
   64-token bucket with the stub's zero frames and 4 decode steps; the
   prefill's and a step's launches equal ``program_launches``; the paged
   layout, the chunked scheduler and ``mixed_step`` refused.  (b) bf16 at
   all 24 + 24 layers on dense + bucketed, 8 slots of 512, 8 greedy
   requests of 4-224 decoder tokens (four buckets) x 32 new, graphed
   (first, warm, traced) and eager: graphed = eager, one capture per
   bucket and one of the decode program, launches = ``program_launches``;
   tok/s, device ms by kernel, idle share, peak memory.  (d) A graphed
   8-slot decode step and an eager 256-token prefill against their
   bounds.  Phase 2 holds ``tiled_matmul`` at whisper's products (M 8
   and 1500) and ``layernorm`` at 8 and 1500 x 1024, the latter the
   layernorm row of the JSON table, whose launches are phase 18's.

19. The paper's encoders as models, the cost model, the tile planner and
   the autotuner (ROADMAP Queue 1 items 12f and 15's modules;
   ``check_encoder``).  (a) adaptor-bert (12 x 768, vocab 30522),
   shallow-transformer (2 x 512) and custom-encoder (2 x 200, 3 heads of
   66: 198-wide q/k/v, ragged products) at their published widths and
   depths, seeded weights: ``Model.forward`` of 8 x 64 tokens (adaptor-bert
   also 1 x 512) through the kernels against the plain route on the same
   weights at f32 compute within phase 4's gate, launches =
   ``program_launches(cfg, "forward")`` (6L ``tiled_matmul``, 2L + 1
   ``layernorm``), the bf16 distance printed, each bf16 forward eager and
   graphed beside its bound.  (b) ``core/analytical.py`` on the H100
   profile against graphed bf16 forwards: Table 1's points (64 tokens,
   batch 1 and 128) and Table 2's rows, measured beside predicted, the
   dominant term, the ratio, GFLOP/s and GFLOP/s/W at the printed power
   limit; gate: four qwen1.5-0.5b forwards (1-4 layers, 64-2048 tokens,
   predictions >= 2x apart) ranked as measured, Spearman rho >= 0.8; the
   tile planner's plans under 227, 100 and 48 KB for the Fig. 5 and
   Fig. 11 workloads beside ``tiled_matmul``'s measured ms.  (c)
   ``RuntimeSpec.tuned`` for full-width qwen1.5-0.5b on the card's
   ``DeviceProfile`` and phase 13's bursty trace, replayed on the tuned
   spec's graphed engine and on ``naive_default``'s: each summary,
   predicted against measured TTFT / ITL, tok/s; gates: the budget, every
   request finished, one capture per program.

20. Training on one card (ROADMAP Queue 1 item 16; ``check_train``),
   through ``torch.matmul`` as the reference trains through XLA dots: no
   product or norm kernel has a backward, and qwen's training steps launch
   no kernel (checked). (a) qwen1.5-0.5b at its widths and 2 of 24 layers,
   2 x 32 tokens, f32 with TF32 off: loss, aux and every gradient leaf
   against the same step on the host (1e-5 relative, 1e-4 x max|g|). (b)
   All 24 layers, f32 masters and bf16 compute, the reference quickstart's
   corpus (4 rows of 32) and AdamW (warmup 5, no decay) for 60 steps at lr
   2e-3 (the quickstart's 3e-3 can stall at full width; 2e-3 is the largest
   ``launch/memorize_probe.py`` tried that memorizes every row): every loss
   finite, the last below half the first; step ms and tok/s beside
   ``train_bound``; then the trained masters load into a graphed engine of
   phase 5's spec on the kernel path, which greedily continues each row's
   first 8 tokens: row 0 must give back at least 6 of its 8 (the "train"
   path's launches: ``tiled_matmul``, both walks, ``rmsnorm``). (d) An
   ``async_write`` checkpoint at step 10, restored into a fresh state on
   the card: its next 3 losses equal the run's bit for bit. (c) 8 x 128
   tokens: ``accum_steps`` 2 against 1 at the reference's gates, the step's
   time, remat "full" and "dots" against "none" (loss and grad norm within
   2e-2) with each mode's peak memory, "full" below "none". (e)
   granite-moe-1b-a400m at its widths and depth, 5 bf16 steps: finite,
   ``load_balance``, step ms, peak memory. (f) Training with "pallas" and
   int8 weights refused. Every time prints the card's name and power limit.

21. The scans' backwards (ROADMAP Queue 1 item 16b; ``check_train_scans``):
   (a) ``rglru_scan_bwd`` at [4, 512, 2560] and [1, 3072, 2560] and
   ``ssm_scan_bwd`` at [4, 512, 8192, 16] (x bf16), the reduced [2, 64,
   128, 8] and a ragged [2, 83, 1000, 16], each bit for bit its plain
   loop (the ssm's from the forward kernel's checkpoints, themselves the
   plain loop's h, and as the call that launches the forward for them),
   timed beside its bound and issue floor (the RG-LRU's with its plan,
   grid and dynamic shared memory), the ssm's training forward
   (with the checkpoints) and the pair as one call too.
   Then recurrentgemma-2b at its widths and 13 of its 26 layers (the
   pattern r, r, a kept) and falcon-mamba-7b at its widths and 8 of its 64
   (its full depth's f32 state needs the sharded step, item 16c): (b) at 2
   layers, f32 with TF32 off, loss and every gradient leaf against the
   same step on the host (phase 20a's gates); (c) 6 bf16 steps (f32
   masters, AdamW) on one fixed 4 x 128 batch of distinct tokens: the
   loss falls, each scan's forward and backward kernel launched as
   ``program_launches(cfg, "train")`` says and no other kernel, step ms
   and peak memory beside ``train_bound``; (d) a second run from the same
   seed repeats the losses, grad norms and the masters' checksum bit for
   bit; (e) the trained masters served by an eager dense + bucketed
   engine on the kernel path (``rglru_scan`` / ``ssm_scan``,
   ``tiled_matmul``, ``rmsnorm`` launched as ``program_launches`` says).

22. Mesh serving (ROADMAP Queue 1 item 13; ``check_mesh``): qwen1.5-0.5b
   at its widths, f32 compute over float32 pools, phase 5's mix on weights
   drawn once.  (c) One graphed engine on the plain route and one on the
   kernels; (a) a tp = 2 engine whose two ranks share the card
   (``launch.mesh.dev_devices(2, allow_repeat=True)``), graphed: each
   program one CUDA graph over both ranks, on the plain route (the
   reference's rule for tp > 1); (b) a dp = 2 ``EngineCluster`` of two
   graphed kernel-route replicas on the card.  Gates: (a) streams (c)'s
   plain tokens and (b) its kernel tokens (equal, or diverging only at a
   near-tie within phase 4's f32 distance, recomputed as phase 8 does),
   one capture per program per engine and replica, (a)'s warm drain no
   capture and the same streams, no kernel launched by (a), every kernel
   of phase 5's float path launched by (b) (counted from zero just before
   its drain).  Each rank's pool shape and the phase's seconds are
   printed with the card's name and power limit; no time is printed for
   the ranks or replicas, which share one card.

23. Distributed training (ROADMAP Queue 1 item 16c; ``check_distributed``),
   every rank on the one card, f32 with TF32 off.  (a) On 4 ranks: the
   ring reduce-scatter and all-reduce, ``psum_scatter``, ``all_gather``
   (a 4 MB gradient a rank and a ragged one) and three chained rounds of
   the int8 error-feedback all-reduce, each bit for bit the same schedule
   run on the host; the GPipe pipeline (4 stages, D 1024, 16 microbatches
   of 8) against the sequential apply, forward within 1e-5 and gradient
   within 1e-3 (the reference's bounds).  (b) qwen1.5-0.5b at its widths
   and 4 of its 24 layers on (data 2, model 2): the loss and the
   assembled gradient of the sharded step against the one-device step
   (1e-5 relative, 1e-4 x max|g|), two steps' losses (1e-5) and params
   (the reference's 5e-3; elements past 1e-4 counted), the step's ms
   beside the one device's and ``train_bound``.  (c) falcon-mamba-7b at
   its widths and 2 of its 64 layers on (data 2, model 1): the same
   gradient gates, and one step whose ``ssm_scan`` / ``ssm_scan_bwd``
   launches are ``program_launches(cfg, "train")`` on every replica (the
   "train_sharded" path).  (d) (b)'s state saved at (2, 2), restored at
   (4, 1), one step there against the uninterrupted (2, 2) run.  The
   phase's seconds and peak memory are printed with the card's name and
   power limit; ranks that share one card share its time, so no speed
   is claimed.

The second line from the end is the JSON kernel table, the last line the
device summary.  Exits non-zero when no CUDA device is visible.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, ShapeSpec  # noqa: E402
from repro_torch.core import analytical, tiling  # noqa: E402
from repro_torch.core.spec import (ExecutionSpec, MemorySpec,  # noqa: E402
                                   MeshSpec, RuntimeSpec, SchedulerSpec,
                                   SpeculationSpec, maxima_for)
from repro_torch.core.quant import QTensor, quantize  # noqa: E402
from repro_torch.kernels import chunked_prefill as cp_mod  # noqa: E402
from repro_torch.kernels import int8_matmul as i8_mod  # noqa: E402
from repro_torch.kernels import ops, runtime  # noqa: E402
from repro_torch.kernels.counts import (LIVE_KV, launch_counts,  # noqa: E402
                                        program_launches, wrappers)
from repro_torch.kernels import tiled_matmul as tm_mod  # noqa: E402
from repro_torch.kernels.chunked_prefill import (  # noqa: E402
    chunked_prefill_attention, chunked_prefill_attention_plain)
from repro_torch.kernels.ffn import (  # noqa: E402
    ffn1, ffn1_gated, ffn1_gated_plain, ffn1_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.int8_matmul import (  # noqa: E402
    int8_matmul, int8_matmul_plain)
from repro_torch.kernels import layernorm as ln_mod  # noqa: E402
from repro_torch.kernels.layernorm import (  # noqa: E402
    layernorm_plain, rmsnorm_plain)
from repro_torch.kernels.qkv_proj import qkv_proj, qkv_proj_plain  # noqa: E402
from repro_torch.kernels import rglru_scan as scan_mod  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_plain)
from repro_torch.kernels import ssm_scan as sscan_mod  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.tiled_matmul import (  # noqa: E402
    tiled_matmul, tiled_matmul_plain)
from repro_torch.launch.timing import (  # noqa: E402
    HBM_BYTES_S, LAYER_MATMULS, NORM_SHAPES, NORM_TOL, PEAK_FLOPS,
    RGLRU_BWD_SHAPES, RGLRU_SCAN_SHAPES, SSM_BWD_SHAPES, SSM_SCAN_SHAPES,
    STEP_ROWS, Timer, bound_ms, issue_floor_ms, norm_calls, norm_cost,
    norm_err, norm_operands, rglru_bwd_cost, rglru_scan_cost, ssm_bwd_cost,
    ssm_operands, ssm_scan_cost)
from repro_torch.core import engine_ref, masking  # noqa: E402
from repro_torch.core.adaptive import (AdaptiveEngine,  # noqa: E402
                                       EngineOptions, pack)
from repro_torch.core.registers import make_registers  # noqa: E402
from repro_torch.launch.adaptive import (FIG8_HEADS, live_cost,  # noqa: E402
                                         padded_cost)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.core.kv_quant import fork_block  # noqa: E402
from repro_torch import harness  # noqa: E402
from repro_torch.harness.tune import cache_bytes, score  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.cluster import EngineCluster  # noqa: E402
from repro_torch.models.tensor_parallel import ShardedCache  # noqa: E402
from repro_torch.launch.mesh import dev_devices  # noqa: E402
from repro_torch.serving.fabric import REG_VOCAB, DecodeFabric  # noqa: E402
from repro_torch.data.pipeline import (MemorizationStream,  # noqa: E402
                                       SyntheticLMStream)
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, global_norm  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainStepConfig, init_state, loss_and_grads, make_step_fn,
    make_train_step)
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.pipeline import make_pipelined_apply  # noqa: E402

LOGIT_TOL = 2e-2                       # x max|logits|, bf16 reference tolerance
# relative size of the attention kernels' float32 summation-order error
# (phase 2 measures 1e-6 - 3e-6 on outputs of order 1): the perturbation
# whose effect on the logits is the floor of the phase 4 gate
ATTN_PERTURB = 2.0 ** -19
ENGINE = dict(max_batch=8, max_len=512, block_size=16, chunk=16)
# phase 9: draft tokens per speculative step; the decode program's verify
# pass runs W = SPEC_K + 1 lanes, its projections M = 8 x (SPEC_K + 1) rows
SPEC_K = 3
SPEC_ROWS = ENGINE["max_batch"] * (SPEC_K + 1)
PROMPT_LENS = (24, 57, 96, 150, 203, 260, 333, 400)
MAX_NEW = 16
# granite-moe-1b-a400m (configs/granite_moe_1b_a400m.py): the K/V
# projections' width (8 kv heads of 64) against d_model 1024, and its
# attention (16 heads over 8 kv heads of 64, n_rep 2)
GRANITE_KV = (1024, 512)
GRANITE_ATTN = dict(h=16, kv=8, hd=64)
# deepseek-v3-671b (configs/deepseek_v3_671b.py): the bf16 products that
# its fused steps route through tiled_matmul, (K, N) -> name: MLA's
# q_down, q_up (128 heads x 192), kv_down (latent 512 + rope 64) and wo
# (128 heads x 128), and the dense prefix layer's FFN (d_ff 18432)
DEEPSEEK_MATMULS = {(7168, 1536): "q_down", (1536, 24576): "q_up",
                    (7168, 576): "kv_down", (16384, 7168): "wo",
                    (7168, 18432): "dense w1/wg", (18432, 7168): "dense w2"}

# phi-3-vision-4.2b (configs/phi_3_vision_4_2b.py): a layer's bf16 products,
# (K, N) -> name (32 heads of 96, d_ff 8192), at a decode step's 8 rows, a
# mixed step's 128 and a bucketed prefill's 1024 (phase 15); and
# qwen1.5-0.5b's layer products at its 512-token bucket's prefill (15c)
PHI3V_MATMULS = {(3072, 3072): "wq/wk/wv/wo", (3072, 8192): "w1/wg",
                 (8192, 3072): "w2"}
PHI3V_ROWS = {8: "decode-step", 128: "mixed-step", 1024: "1024-bucket prefill"}
QWEN_BUCKET_ROWS = 512
# recurrentgemma-2b (configs/recurrentgemma_2b.py): a layer's bf16
# products, (K, N) -> name (d_model and lru_width 2560, 10 heads over 1 kv
# head of 256, GeGLU d_ff 7680), at a decode step's 8 rows and the
# 3072-token bucket's prefill (phase 16)
RGEMMA_MATMULS = {(2560, 2560): "in_x/in_gate/out/wq/wo", (2560, 256): "wk/wv",
                  (2560, 7680): "w1/wg", (7680, 2560): "w2"}
RGEMMA_ROWS = {8: "decode-step", 3072: "3072-bucket prefill"}
# falcon-mamba-7b (configs/falcon_mamba_7b.py): a layer's bf16 products,
# (K, N) -> name (d_model 4096, d_inner 8192, dt_rank 256, state 16: x_proj
# N = 256 + 2 x 16 = 288 leaves a ragged 64-wide tile), at a decode step's
# 8 rows and the 3072-token bucket's prefill (phase 17)
FALCON_MATMULS = {(4096, 16384): "in_proj", (8192, 288): "x_proj",
                  (256, 8192): "dt_proj", (8192, 4096): "out_proj"}
FALCON_ROWS = {8: "decode-step", 3072: "3072-bucket prefill"}
# whisper-medium (configs/whisper_medium.py): a layer's bf16 products, (K,
# N) -> name (16 heads of 64, d_ff 4096), at a decode step's 8 rows and
# the encoder's 1500 frames (its layers and every decoder layer's cross
# K/V; phase 18)
WHISPER_MATMULS = {(1024, 1024): "wq/wk/wv/wo, cross", (1024, 4096): "w1",
                   (4096, 1024): "w2"}
WHISPER_ROWS = {8: "decode-step", 1500: "1500-frame encoder / cross K/V"}
# phase 19's encoder forwards (K, N): adaptor-bert, shallow-transformer and
# custom-encoder (3 heads of 66: wq/wk/wv 200 -> 198 and wo 198 -> 200, the
# loop's one-element load path) at one and at 8 sequences of 64 tokens
ENCODER_MATMULS = {(768, 768): "adaptor-bert wq/wk/wv/wo",
                   (768, 3072): "adaptor-bert w1",
                   (3072, 768): "adaptor-bert w2",
                   (512, 512): "shallow-transformer wq/wk/wv/wo",
                   (512, 2048): "shallow-transformer w1",
                   (2048, 512): "shallow-transformer w2",
                   (200, 198): "custom-encoder wq/wk/wv",
                   (198, 200): "custom-encoder wo",
                   (200, 800): "custom-encoder w1",
                   (800, 200): "custom-encoder w2"}
ENCODER_ROWS = {64: "1 x 64 forward", 512: "8 x 64 forward"}


def prefill_rows() -> dict[tuple[int, int, int], str]:
    """Phase 2's rows at phase 15's and 16's shapes: (M, K, N) -> label."""
    rows = {(m, k, n): f"phi-3-vision-4.2b {step} {name}"
            for m, step in PHI3V_ROWS.items()
            for (k, n), name in PHI3V_MATMULS.items()}
    rows.update({(m, k, n): f"recurrentgemma-2b {step} {name}"
                 for m, step in RGEMMA_ROWS.items()
                 for (k, n), name in RGEMMA_MATMULS.items()})
    rows.update({(QWEN_BUCKET_ROWS, k, n): "qwen1.5-0.5b 512-bucket prefill"
                 for k, n in LAYER_MATMULS})
    return rows


def falcon_rows() -> dict[tuple[int, int, int], str]:
    """Phase 2's ``tiled_matmul`` rows at phase 17's, 18's and 19's
    shapes."""
    rows = {(m, k, n): f"falcon-mamba-7b {step} {name}"
            for m, step in FALCON_ROWS.items()
            for (k, n), name in FALCON_MATMULS.items()}
    rows.update({(m, k, n): f"whisper-medium {step} {name}"
                 for m, step in WHISPER_ROWS.items()
                 for (k, n), name in WHISPER_MATMULS.items()})
    rows.update({(m, k, n): f"{name}, {step}"
                 for m, step in ENCODER_ROWS.items()
                 for (k, n), name in ENCODER_MATMULS.items()})
    return rows


KERNELS = wrappers()        # {kernel name: its wrapper}, the JSON's order
# the kernels each path must launch: the two serving paths and the kernel
# library entry point (``repro_torch.kernels.ops``); a kernel's JSON
# ``launches`` is its count on the first path listed with it (the
# attention kernels run on both serving paths)
PATH_KERNELS = {"float": ("tiled_matmul", "paged_decode_attention",
                          "chunked_prefill_attention", "rmsnorm"),
                "int8": ("int8_matmul", "paged_decode_attention",
                         "chunked_prefill_attention", "rmsnorm"),
                # phase 18: whisper-medium on dense + bucketed (its
                # attends are plain torch, as the reference's XLA); listed
                # before "ops" so that layernorm's JSON launches are the
                # serving path's
                "audio": ("tiled_matmul", "layernorm"),
                "ops": ("ffn1", "ffn1_gated", "qkv_proj", "layernorm",
                        "rmsnorm", "flash_attention"),
                # the multi-topology fleet: both with live_kv, float and
                # int8 weight tables; phase 10's speculating fleet verifies
                # through the chunk walk alone
                "fleet": ("paged_decode_attention",
                          "chunked_prefill_attention"),
                "fleet_int8": ("paged_decode_attention",
                               "chunked_prefill_attention"),
                "fleet_spec": ("chunked_prefill_attention",),
                # phase 8: the float path with the prefix cache on
                "prefix": ("tiled_matmul", "paged_decode_attention",
                           "chunked_prefill_attention", "rmsnorm"),
                # phase 9: speculative decoding (the verify pass runs the
                # chunk walk on the decode program too)
                "spec": ("tiled_matmul", "chunked_prefill_attention",
                         "rmsnorm"),
                "spec_int8": ("int8_matmul", "chunked_prefill_attention",
                              "rmsnorm"),
                # phase 11: granite-moe-1b-a400m, float and fully
                # quantized, and speculating with its self-draft
                "moe": ("tiled_matmul", "paged_decode_attention",
                        "chunked_prefill_attention", "rmsnorm"),
                "moe_int8": ("int8_matmul", "paged_decode_attention",
                             "chunked_prefill_attention", "rmsnorm"),
                "moe_spec": ("tiled_matmul", "chunked_prefill_attention",
                             "rmsnorm"),
                # phase 14: deepseek-v3's MLA (the latents attend through
                # the gather view, as in the reference), over a bf16 and
                # an int8 latent pool
                "mla": ("tiled_matmul", "rmsnorm"),
                "mla_int8_pool": ("tiled_matmul", "rmsnorm"),
                # phase 12: the register-driven engine computes with
                # torch.matmul, as the reference with jnp.einsum: no
                # hand-written kernel may launch there (checked)
                "adaptive": (),
                # phase 15: phi-3-vision on the three engines (the dense
                # layout attends as the reference's XLA: no walk; the
                # bucketed prefill's attention is plain torch), and qwen
                # on the bucketed scheduler over both layouts
                "vlm_chunked_paged": ("tiled_matmul",
                                      "paged_decode_attention",
                                      "chunked_prefill_attention",
                                      "rmsnorm"),
                "vlm_bucketed_dense": ("tiled_matmul", "rmsnorm"),
                "vlm_bucketed_paged": ("tiled_matmul",
                                       "paged_decode_attention", "rmsnorm"),
                "bucketed_dense": ("tiled_matmul", "rmsnorm"),
                "bucketed_paged": ("tiled_matmul", "paged_decode_attention",
                                   "rmsnorm"),
                # phase 16: recurrentgemma-2b on dense + bucketed (its
                # local attention is plain torch, as the reference's XLA;
                # every prefill runs the RG-LRU recurrence's kernel)
                "hybrid": ("tiled_matmul", "rmsnorm", "rglru_scan"),
                # phase 17: falcon-mamba-7b on dense + bucketed (no
                # attention; every prefill runs the selective scan's
                # kernel)
                "ssm": ("tiled_matmul", "rmsnorm", "ssm_scan"),
                # phase 19a: the paper's encoders' forwards (their attends
                # plain torch, as the reference's XLA)
                "encoder": ("tiled_matmul", "layernorm"),
                # phase 20: the trained qwen1.5-0.5b's masters served on
                # phase 5's kernel path (the training step itself runs
                # "xla" and launches none: checked)
                "train": ("tiled_matmul", "paged_decode_attention",
                          "chunked_prefill_attention", "rmsnorm"),
                # phase 21: recurrentgemma-2b and falcon-mamba-7b trained
                # (the products and norms "xla"; each scan's forward and
                # backward kernel), then their masters served on dense +
                # bucketed through the kernels
                "train_scans": ("rglru_scan", "rglru_scan_bwd", "ssm_scan",
                                "ssm_scan_bwd"),
                "scans_served": ("tiled_matmul", "rmsnorm", "rglru_scan",
                                 "ssm_scan"),
                # phase 22: the mesh; tp = 2 runs the plain routes (the
                # reference's rule: no kernel may launch there, checked),
                # the dp = 2 cluster's replicas the kernels
                "mesh_tp": (),
                "mesh_dp": ("tiled_matmul", "paged_decode_attention",
                            "chunked_prefill_attention", "rmsnorm"),
                # phase 23: the sharded train step of falcon-mamba-7b on
                # (data 2, model 1), each replica's scans on the card
                "train_sharded": ("ssm_scan", "ssm_scan_bwd")}
PREFIX_STATS = ("prefix_hits", "prefix_hit_tokens", "cow_forks",
                "prefix_evictions")
SOURCES = {
    "tiled_matmul": ("src/repro_torch/csrc/tiled_matmul.cu",
                     "src/repro/kernels/tiled_matmul.py:56"),
    # the two attention entry points share the walk of split_walk.cuh
    "paged_decode_attention": ("src/repro_torch/csrc/split_walk.cuh",
                               "src/repro/kernels/paged_attention.py:179"),
    "chunked_prefill_attention": (
        "src/repro_torch/csrc/split_walk.cuh",
        "src/repro/kernels/chunked_prefill.py:173"),
    "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul.py:55"),
    "ffn1": ("src/repro_torch/csrc/ffn.cu", "src/repro/kernels/ffn.py:80"),
    "ffn1_gated": ("src/repro_torch/csrc/ffn.cu",
                   "src/repro/kernels/ffn.py:107"),
    "qkv_proj": ("src/repro_torch/csrc/qkv_proj.cu",
                 "src/repro/kernels/qkv_proj.py:75"),
    "layernorm": ("src/repro_torch/csrc/layernorm.cu",
                  "src/repro/kernels/layernorm.py:50"),
    "rmsnorm": ("src/repro_torch/csrc/layernorm.cu",
                "src/repro/kernels/layernorm.py:72"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:85"),
    # no Pallas kernel: the reference's lax.scan in rglru_prefill
    "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                   "src/repro/models/rglru.py:124"),
    # no Pallas kernel: the reference's lax.scan in ssm_prefill
    "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/models/ssm.py:133"),
    # no Pallas kernel: jax.grad of the reference's lax.scans in
    # rglru_forward and ssm_forward (training)
    "rglru_scan_bwd": ("src/repro_torch/csrc/rglru_scan.cu",
                       "src/repro/models/rglru.py:104"),
    "ssm_scan_bwd": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/models/ssm.py:101"),
}
# full widths of the kernel library's shapes, from the JAX package's
# config files (kept here as constants; nothing of it is imported):
# qwen1.5-0.5b (configs/qwen1_5_0_5b.py): d_model 1024, 16 heads of 64,
#   d_ff 2816, swiglu, rmsnorm; one 128-row mixed step, one 512-token prompt
# qwen2-72b (configs/qwen2_72b.py): d_model 8192, 64 heads of 128, 8 kv
#   heads (K/V width 1024); one 512-token prompt
# adaptor_bert (configs/adaptor_bert.py, the paper's BERT-base variant):
#   d_model 768, 12 heads of 64, d_ff 3072, gelu, layernorm, sequence
#   length 64, here at batch 8 (512 rows)
# whisper-medium (configs/whisper_medium.py): 16 heads of 64 over the
#   encoder's 1500 frames (cross attention)
# each norm's JSON row: a qwen1.5-0.5b mixed step, whisper-medium's
# encoder over its 1500 frames (phase 18's serving path)
MAIN_NORM = {"rmsnorm": (128, 1024), "layernorm": (1500, 1024)}
QWEN = dict(rows=128, d=1024, ff=2816, heads=16, hd=64, prompt=512)
QWEN72 = dict(d=8192, kv_width=1024, heads=64, hd=128)
BERT = dict(batch=8, seq=64, d=768, ff=3072, heads=12, hd=64)
WHISPER = dict(frames=1500, heads=16, hd=64)
# recurrentgemma-2b (configs/recurrentgemma_2b.py): 10 heads of 256, local
# attention over a 2048-token window
RGEMMA = dict(window=2048, heads=10, hd=256)


def print_ptxas(log: Path, source: str) -> dict[str, tuple[int, int, int]]:
    """Registers, static shared memory and spills of each kernel compiled
    from ``source``, read from the ptxas report (``-Xptxas -v``) in the
    build log; returns {kernel: (registers, smem bytes, spill bytes)}."""
    part = log.read_text().split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    names = re.findall(r"Compiling entry function '(\w+)'", part)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    plain = dict(zip(names, (n.replace("(anonymous namespace)::", "")
                             .split("(")[0] for n in plain)))
    print(f"ptxas, {source}:")
    report, name, spill = {}, None, (0, 0)
    for line in part.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = plain.get(m.group(1), m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            sm = re.search(r"(\d+) bytes smem", line)
            smem = int(sm.group(1)) if sm else 0
            print(f"  {name:<60} {m.group(1):>4} registers, {smem:>6} B "
                  f"static smem, spill stores {spill[0]} B, loads "
                  f"{spill[1]} B")
            report[name] = (int(m.group(1)), smem, sum(spill))
            name = None
    return report


def flash_grid(e: dict) -> str:
    """The flash kernel's last launch (query-tile CTAs, column groups, key
    ranges), recorded in ``e`` and as text."""
    ctas, groups, splits = flash_attention.last_grid
    e.update(ctas=ctas, groups=groups, splits=splits)
    return (f"grid {ctas} query-tile CTAs x {groups} column groups x "
            f"{splits} key ranges = {ctas * groups * splits} CTAs")


def sdpa_kernels(q, k, v, causal: bool) -> str:
    """The device kernels one SDPA call launches (the backend PyTorch
    picks), read from a ``torch.profiler`` trace."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         is_causal=causal)
        torch.cuda.synchronize()
    names = [e.key for e in device_events(prof)]
    return ", ".join(n[:80] for n in names) or "(no device kernel traced)"


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.float() - b.float()).abs()
    if not torch.isfinite(d).all():
        raise AssertionError("non-finite values in a kernel comparison")
    return float(d.max())


def flash_limit(v: torch.Tensor, plain_out: torch.Tensor) -> float:
    """The flash attention gate.  f32: 2e-5 x max|V| (order of sums).
    bf16: 2^-7 x max|V| (one rounding of the output, p rounded against
    another running max), and no more than 2^-6 x max|plain output|: over
    a long non-causal row the output is far smaller than V (about 0.2
    against 4.6 at 1500 keys), and a fault in the weights of the split
    ranges must not hide under V's scale."""
    lim = (2e-5 if v.dtype == torch.float32 else 2 ** -7) \
        * float(v.float().abs().max())
    if v.dtype != torch.float32:
        lim = min(lim, 2 ** -6 * float(plain_out.float().abs().max()))
    return lim


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def mma_grid(e: dict) -> str:
    """The launch of the shared bf16 / f32 loop just made (output tiles, K
    ranges, dynamic shared memory), recorded in ``e`` and as text."""
    tiles, splits, smem = tm_mod.launched_grid()
    e.update(ctas=tiles, splits=splits, smem_bytes=smem)
    return (f"grid {tiles} tiles x {splits} K ranges = {tiles * splits} "
            f"CTAs, {smem} B dynamic smem")


def check_matmul(timer, dev, g) -> dict:
    print("\n== tiled_matmul vs plain (C = A @ B, f32 accumulate)")
    print(f"{'M':>5} {'K':>5} {'N':>5} {'dtype':>9} {'err':>10} {'tol':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'torch_ms':>9} {'bound_ms':>9}")
    shapes = [(m, k, n, torch.bfloat16) for m in STEP_ROWS.values()
              for k, n in LAYER_MATMULS]
    # phase 9's speculative decode step: the target's verify rows
    shapes += [(SPEC_ROWS, k, n, torch.bfloat16) for k, n in LAYER_MATMULS]
    # phase 11's granite-moe steps: the K/V projections, N = 512
    shapes += [(m, *GRANITE_KV, torch.bfloat16) for m in STEP_ROWS.values()]
    # phase 14's deepseek-v3 steps
    shapes += [(m, k, n, torch.bfloat16) for m in STEP_ROWS.values()
               for k, n in DEEPSEEK_MATMULS]
    # phase 15's phi-3-vision steps and prefills, qwen's 512 bucket, phase
    # 16's recurrentgemma, phase 17's falcon-mamba and phase 18's whisper
    extra = {**prefill_rows(), **falcon_rows()}
    shapes += [(*mkn, torch.bfloat16) for mkn in extra]
    shapes += [(128, 1024, 2816, torch.float32), (77, 300, 199, torch.bfloat16),
               (5, 1000, 67, torch.float32)]
    serving, more = {}, []
    for m, k, n, dt in shapes:
        a = torch.randn(m, k, generator=g, device=dev).to(dt)
        b = (torch.randn(k, n, generator=g, device=dev) / math.sqrt(k)).to(dt)
        out, ref = tiled_matmul(a, b), tiled_matmul_plain(a, b)
        e = {}
        grid = mma_grid(e)
        err = max_err(out, ref)
        # f32: summation order only; bf16: one rounding of the f32 sum
        tol = (1e-5 if dt == torch.float32 else 2 ** -7) \
            * float(ref.float().abs().max())
        if err > tol:
            raise AssertionError(f"tiled_matmul {m}x{k}x{n} {dt}: err {err} "
                                 f"> tol {tol}")
        if not torch.equal(out, tiled_matmul(a, b)):
            raise AssertionError(f"tiled_matmul {m}x{k}x{n} {dt}: a second "
                                 "run gave other bits")
        ms = timer(lambda: tiled_matmul(a, b))
        pms = timer(lambda: tiled_matmul_plain(a, b))
        lms = timer(lambda: torch.matmul(a, b))
        esz = a.element_size()
        bms, by = bound_ms((m * k + k * n + m * n) * esz, 2 * m * k * n, dt)
        print(f"{m:>5} {k:>5} {n:>5} {str(dt)[6:]:>9} {err:>10.3g} "
              f"{tol:>10.3g} {ms:>10.4f} {pms:>9.4f} {lms:>9.4f} {bms:>9.4f}"
              f"   {grid}")
        step = next((s for s, rows in STEP_ROWS.items() if rows == m), None)
        if dt == torch.bfloat16 and (m, k, n) in extra:
            more.append(dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms,
                shape=f"{extra[(m, k, n)]} M={m} K={k} N={n} bf16"))
        elif dt == torch.bfloat16 and (k, n) in LAYER_MATMULS and step:
            serving[(m, k, n)] = dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms,
                shape=f"{step}-step M={m} K={k} N={n} bf16")
        elif m == SPEC_ROWS and dt == torch.bfloat16:
            more.append(dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms,
                shape=f"speculative verify (k={SPEC_K}) M={m} K={k} N={n} "
                      "bf16"))
        elif (k, n) == GRANITE_KV and step:
            more.append(dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms,
                shape=f"granite-moe {step}-step wk/wv M={m} K={k} N={n} "
                      "bf16"))
        elif (k, n) in DEEPSEEK_MATMULS and step:
            more.append(dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms,
                shape=f"deepseek-v3 {step}-step {DEEPSEEK_MATMULS[(k, n)]} "
                      f"M={m} K={k} N={n} bf16"))
    # the wrapper never waits for the device (a split launch: workspace,
    # plan and reduce included)
    a = torch.randn(128, 1024, generator=g, device=dev).bfloat16()
    b = torch.randn(1024, 2816, generator=g, device=dev).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tiled_matmul(a, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if tm_mod.launched_grid()[1] < 2:
        raise AssertionError("tiled_matmul: the sync check took one K range")
    print(f"tiled_matmul under set_sync_debug_mode('error'): no host sync "
          f"({mma_grid({})})")
    rows = list(serving.values())
    main = next(e for e in rows if e["shape"].startswith("mixed-step M=128 "
                                                         "K=1024 N=2816"))
    return dict(main, other_shapes=[e for e in rows if e is not main]
                + more, serving=serving)


def drain_estimate(name: str, serving: dict, layers: int, launches: dict,
                   lib_key: str, lib_name: str) -> None:
    """Print phase 2's per-call medians of kernel ``name``'s six serving
    shapes summed over the steps of a phase 5 drain, which are counted
    from its attention launches (a mixed step launches the chunk kernel
    once per layer, a decode step the decode kernel): an estimate of the
    drain's matmul device time, for the kernel, the library call under
    ``lib_key`` and the bound."""
    steps = {STEP_ROWS["mixed"]:
             launches["chunked_prefill_attention"] / layers,
             STEP_ROWS["decode"]: launches["paged_decode_attention"] / layers}
    total = {key: layers * sum(steps[m] * LAYER_MATMULS[(k, n)] * e[key]
                               for (m, k, n), e in serving.items())
             for key in ("ms", lib_key, "bound_ms")}
    n = layers * sum(LAYER_MATMULS.values()) * sum(steps.values())
    print(f"{name} per drain, an estimate (phase 2's per-call medians x "
          f"phase 5's {steps[STEP_ROWS['mixed']]:g} mixed + "
          f"{steps[STEP_ROWS['decode']]:g} decode steps x {layers} layers "
          f"= {n:g} launches; {name} launched {launches[name]}): kernel "
          f"{total['ms']:.3f} ms, {lib_name} {total[lib_key]:.3f} ms, bound "
          f"{total['bound_ms']:.3f} ms")


def i8_grid(e: dict) -> str:
    """The launch of ``int8_matmul`` just made (output tiles of BM x BN, K
    ranges, dynamic shared memory), recorded in ``e`` and as text."""
    tiles, splits, smem, bm, bn = i8_mod.launched_grid()
    e.update(ctas=tiles, splits=splits, smem_bytes=smem, bm=bm, bn=bn)
    return (f"grid {tiles} tiles of {bm}x{bn} x {splits} K ranges, {smem} B "
            "dynamic smem")


def check_int8_matmul(timer, dev, g) -> dict:
    """int8_matmul against its plain version (exact: the same integer sum
    and epilogue), gated on max_abs_err == 0: the six serving shapes in
    bf16 and f32 out, each also at every plan (BM 16 and 32, BN 32 and
    64, 1-16 K ranges) bit-equal to its planned call, ragged shapes, and
    a product whose plan splits K (also once under
    ``set_sync_debug_mode("error")``).  The library yardsticks are
    ``torch._int_mm`` (the integer product alone, without the scales),
    which refuses M <= 16 (printed, nothing is padded), and the bf16
    ``torch.matmul`` at the same shape."""
    print("\n== int8_matmul vs plain (int8 x int8 -> int32, x sx * sw[n])")
    print(f"{'M':>5} {'K':>5} {'N':>5} {'out':>9} {'err':>6} {'kernel_ms':>10} "
          f"{'plain_ms':>9} {'int_mm_ms':>10} {'bf16_mm':>9} {'bound_ms':>9}")
    bf, f32 = torch.bfloat16, torch.float32
    shapes = [(m, k, n, dt) for m in STEP_ROWS.values()
              for k, n in (*LAYER_MATMULS, GRANITE_KV) for dt in (bf, f32)]
    # phase 15's phi-3-vision steps and prefills, qwen's 512 bucket (bf16
    # out); the last shape splits K for the sync check below
    extra = prefill_rows()
    shapes += [(*mkn, bf) for mkn in extra]
    shapes += [(77, 300, 199, bf), (5, 1000, 67, f32), (8, 8192, 256, bf)]
    serving, granite = {}, []
    for m, k, n, dt in shapes:
        qx = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        sx = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
        sw = torch.rand((1, n), generator=g, device=dev) * 0.05 + 1e-3
        run = lambda: int8_matmul(qx, sx, qw, sw, out_dtype=dt)  # noqa: E731
        plain = lambda: int8_matmul_plain(qx, sx, qw, sw, dt)  # noqa: E731
        out, e = run(), {}
        grid = i8_grid(e)
        err = max_err(out, plain())
        if err != 0:
            raise AssertionError(f"int8_matmul {m}x{k}x{n} {dt}: err {err} "
                                 "!= 0")
        step = next((s for s, rows in STEP_ROWS.items() if rows == m), None)
        serve = step is not None and (k, n) in (*LAYER_MATMULS, GRANITE_KV)
        if serve and dt == bf:
            slices = -(-k // i8_mod.K_SLICE)
            for plan in itertools.product(
                    (16, 32), (32, 64),
                    range(1, min(slices, i8_mod.MAX_SPLITS) + 1)):
                with mock.patch.object(i8_mod, "int8_plan",
                                       lambda M, K, N, p=plan: p):
                    got = int8_matmul(qx, sx, qw, sw)
                if not torch.equal(got, out):
                    raise AssertionError(f"int8_matmul {m}x{k}x{n}: plan "
                                         f"{plan} gave other bits")
        ms, pms = timer(run), timer(plain)
        try:
            torch._int_mm(qx, qw)
            lms = timer(lambda: torch._int_mm(qx, qw))
            lib = f"{lms:>10.4f}"
        except RuntimeError as exc:
            lms, lib = None, "refused"
            why = str(exc).splitlines()[0][:80]
        mm16 = None
        if serve or (m, k, n) in extra:
            a = torch.randn(m, k, generator=g, device=dev).to(bf)
            w = (torch.randn(k, n, generator=g, device=dev)
                 / math.sqrt(k)).to(bf)
            mm16 = timer(lambda: torch.matmul(a, w))
        bms, by = bound_ms(m * k + k * n + 4 + 4 * n
                           + m * n * torch.empty((), dtype=dt).element_size(),
                           2 * m * k * n, torch.int8)
        print(f"{m:>5} {k:>5} {n:>5} {str(dt)[6:]:>9} {err:>6.3g} "
              f"{ms:>10.4f} {pms:>9.4f} {lib:>10} "
              f"{'-' if mm16 is None else f'{mm16:.4f}':>9} {bms:>9.4f}"
              f"   {grid}")
        if lms is None:
            print(f"      torch._int_mm refused M={m}: {why}")
        if (m, k, n) in extra:
            granite.append(dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms, bf16_matmul_ms=mm16,
                shape=f"{extra[(m, k, n)]} M={m} K={k} N={n} bf16 out"))
        elif serve and dt == bf and (k, n) == GRANITE_KV:
            granite.append(dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms, bf16_matmul_ms=mm16,
                shape=f"granite-moe {step}-step wk/wv M={m} K={k} N={n} "
                      "bf16 out"))
        elif serve and dt == bf:
            serving[(m, k, n)] = dict(
                e, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms, bf16_matmul_ms=mm16,
                shape=f"{step}-step M={m} K={k} N={n} bf16 out")
    # the wrapper never waits for the device (a split launch: workspace,
    # kernel and reduce; the last shape, 8 x 8192 x 256, splits K)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        int8_matmul(qx, sx, qw, sw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if i8_mod.launched_grid()[1] < 2:
        raise AssertionError("int8_matmul: the sync check took one K range")
    print(f"int8_matmul under set_sync_debug_mode('error'): no host sync "
          f"({i8_grid({})})")
    rows = list(serving.values())
    main = next(e for e in rows if e["shape"].startswith("mixed-step M=128 "
                                                         "K=1024 N=2816"))
    return dict(main, other_shapes=[e for e in rows if e is not main]
                + granite, serving=serving)


def paged_inputs(g, dev, B, W, h, kv, hd, q_dt, kv_dt, starts, bs=16,
                 nblk=32, live=None):
    """A pool with shuffled blocks per sequence, table entries past each
    sequence's reach at the null block, and NaN in the null block and in
    the unseen tail of each sequence's last live block (an int8 pool:
    random values, per-row scales, NaN scales there).  With ``live`` (the
    live kv groups of each sequence) also NaN in the queries of the dead
    groups and in their rows of the sequence's blocks.  Returns q, the
    pools, tables, start and the scales (None or a pair)."""
    nb = B * nblk + 1
    if kv_dt == torch.int8:
        k_pool, v_pool = (torch.randint(-127, 128, (nb, bs, kv, hd),
                                        generator=g, device=dev,
                                        dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand(nb, bs, kv, generator=g, device=dev) * 0.03
                       + 5e-3 for _ in range(2))
        poisoned = scales
    else:
        k_pool = torch.randn(nb, bs, kv, hd, generator=g, device=dev).to(kv_dt)
        v_pool = torch.randn(nb, bs, kv, hd, generator=g, device=dev).to(kv_dt)
        scales = None
        poisoned = (k_pool, v_pool)
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    tables = perm.reshape(B, nblk).to(torch.int32)
    for t in poisoned:
        t[0] = float("nan")
    for b, s in enumerate(starts):
        reach = min(s + W, nblk * bs)
        used = -(-reach // bs)
        tables[b, used:] = 0
        blk, off = int(tables[b, used - 1]), (reach - 1) % bs
        for t in poisoned:
            t[blk, off + 1:] = float("nan")
    q = torch.randn(B, W, h, hd, generator=g, device=dev).to(q_dt)
    for b, n in enumerate(live or ()):
        q[b, :, n * (h // kv):] = float("nan")
        for t in poisoned:
            t[tables[b].long(), :, n:] = float("nan")
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, tables, start, scales


def attn_case(timer, dev, g, name, q_dt, kv_dt, B, W, h, kv, hd, starts,
              label="", live=None) -> dict:
    """One paged attention kernel against its plain version on one input
    (``starts``: decode lengths less one, or the chunk's lane-0
    positions), timed beside SDPA and the bound; the grid it launched
    printed.  ``live``: the live kv groups of each sequence (``live_kv``),
    the dead groups' queries and pool rows NaN (``paged_inputs``); their
    outputs must be bit-exact zeros, also at 1 and 3 fixed key ranges,
    and the bound counts the live groups' rows alone."""
    decode = name == "paged_decode_attention"
    bs = 16
    q, kp, vp, tables, start, scales = paged_inputs(
        g, dev, B, W, h, kv, hd, q_dt, kv_dt, starts, live=live)
    sk = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
    live_t = None
    if live is not None:
        live_t = torch.tensor(live, dtype=torch.int32, device=dev)
        sk["live_kv"] = live_t
    if decode:
        q = q[:, 0].contiguous()
        lens = start + 1
        run = lambda: paged_decode_attention(  # noqa: E731
            q, kp, vp, tables, lens, **sk)
        plain = lambda: paged_decode_attention_plain(  # noqa: E731
            q, kp, vp, tables, lens, **sk)
        n_pos = [s + 1 for s in starts]
    else:
        run = lambda: chunked_prefill_attention(  # noqa: E731
            q, kp, vp, tables, start, **sk)
        plain = lambda: chunked_prefill_attention_plain(  # noqa: E731
            q, kp, vp, tables, start, **sk)
        n_pos = [min(s + W, 512) for s in starts]
    t_max = tables.shape[1] * bs
    out, ref = run(), plain()
    grid = KERNELS[name].last_grid
    # f32 out over an f32 pool: order of sums and exp only; over a bf16
    # pool p is rounded to bf16, and another order of the score sum (or
    # another running max: the chunk kernel's key ranges) can round a
    # probability a bf16 step (2^-8) the other way, which moves the output
    # by up to 2^-8 * max|V|; bf16 out: one bf16 rounding of each output,
    # a bf16 step of its own size, 2^-7 * max(|plain|, 1) per element
    # (tol prints the limit where the error comes closest to it, "of tol"
    # that closest error over its limit); f32 out over an int8 pool: the
    # f32 walk over the dequantized pool, order only
    def gate(got: torch.Tensor, what: str) -> tuple[float, float, float]:
        err = max_err(got, ref)
        if q_dt == torch.bfloat16:
            limit = 2 ** -7 * ref.float().abs().clamp_min(1)
            frac = (got.float() - ref.float()).abs() / limit
            worst = frac.flatten().argmax()
            tol = float(limit.flatten()[worst])
            frac = float(frac.flatten()[worst])
        else:
            tol = 2e-5 if kv_dt != torch.bfloat16 else \
                2 ** -8 * float(vp.float().nan_to_num().abs().max())
            frac = err / tol
        if frac > 1:
            raise AssertionError(f"{name} {label}{what} q={q_dt} "
                                 f"pool={kv_dt} h={h} kv={kv} hd={hd} "
                                 f"W={W}: err {err}, {frac} of the limit "
                                 f"{tol}")
        return err, frac, tol

    if live is not None:
        dead = cp_mod.apply_live_kv(torch.ones_like(ref), live_t, kv) == 0
        for splits in (None, 1, 3):
            with mock.patch.object(cp_mod, "kv_splits",
                                   (lambda *a, s=splits: s) if splits
                                   else cp_mod.kv_splits):
                got = run()
            if not torch.equal(got[dead], torch.zeros_like(got[dead])) \
                    or torch.signbit(got[dead]).any():
                raise AssertionError(f"{name} {label}: a dead kv group is "
                                     f"not exact zeros (splits {splits})")
            if splits:   # the live groups held to the same limit
                gate(got, f" ({splits} key ranges)")
    err, frac, tol = gate(out, "")
    pair = str(q_dt)[6:] + "/" + str(kv_dt)[6:]
    # library yardstick: SDPA on a pre-gathered, head-repeated view (an
    # int8 pool dequantized first; neither is timed)
    if scales is not None:
        kp_f = kp.float() * scales[0].nan_to_num()[..., None]
        vp_f = vp.float() * scales[1].nan_to_num()[..., None]
    else:
        kp_f, vp_f = kp.nan_to_num(), vp.nan_to_num()
    kg = kp_f[tables.long()].reshape(B, t_max, kv, hd)
    vg = vp_f[tables.long()].reshape(B, t_max, kv, hd)
    kg = kg.repeat_interleave(h // kv, dim=2).transpose(1, 2).to(q_dt)
    vg = vg.repeat_interleave(h // kv, dim=2).transpose(1, 2).to(q_dt)
    qs = q.reshape(B, W, h, hd).transpose(1, 2)
    lim = start[:, None] + torch.arange(W, device=dev)[None, :]
    mask = (torch.arange(t_max, device=dev)[None, None, :]
            <= lim[:, :, None])[:, None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qs, kg, vg, attn_mask=mask)
    if live is not None:
        # the dead groups' heads masked to zeros by torch.where
        alive = ~dead.reshape(B, W, h, hd).transpose(1, 2)
        sdpa_all = sdpa
        sdpa = lambda: torch.where(alive, sdpa_all(), 0.0)  # noqa: E731
    ms, pms, lms = timer(run), timer(plain), timer(sdpa)
    # K/V rows (and an int8 pool's scales) read once per sequence; each
    # lane's scores and PV products over the positions it sees; with
    # live_kv only the live groups' rows and heads (and live_kv itself)
    row = hd * kp.element_size() + (4 if scales is not None else 0)
    groups = live if live is not None else [kv] * B
    nbytes = (2 * sum(n * gb for n, gb in zip(n_pos, groups)) * row
              + 2 * q.numel() * q.element_size() + tables.numel() * 4
              + B * 4 + (B * 4 if live is not None else 0))
    seen = [sum(min(s + lane + 1, t_max) for lane in range(W)) for s in starts]
    # an int8 pool is attended in f32 (the reference's dequantized walk)
    bms, by = bound_ms(nbytes, 4 * sum(n * gb * (h // kv) for n, gb in
                                       zip(seen, groups)) * hd,
                       torch.float32 if kv_dt == torch.int8 else q_dt)
    groups = cp_mod.col_groups(hd)[2]
    print(f"{name:>26} {pair:>10} {h:>3}/{kv:<2} {err:>10.3g} {tol:>8.3g} "
          f"{ms:>10.4f} {pms:>9.4f} {lms:>9.4f} {bms:>9.4f} {frac:>7.3f} "
          f"{label}"
          + (f" grid {grid[0]} CTAs ({groups} column groups) x {grid[1]} "
             "key ranges" if grid else ""))
    nums = dict(max_abs_err=err, of_tol=frac, ms=ms, plain_ms=pms,
                bound_ms=bms, bound_by=by, library_ms=lms,
                shape=f"B={B} W={W} h={h} kv={kv} hd={hd} bs=16 {pair}"
                      + (f" {label}" if label else "")
                      + (f" live_kv={live}" if live is not None else ""))
    if grid:
        nums.update(ctas=grid[0], groups=groups, splits=grid[1])
    return nums


# chunk lane-0 positions: the last lane reaches start + W - 1 <= 511
CHUNK_STARTS = {16: [0, 16, 48, 100, 203, 300, 400, 496],
                32: [0, 16, 48, 100, 203, 300, 400, 480],
                # phase 9's verify pass: lane 0 at each slot's index
                SPEC_K + 1: [0, 16, 99, 251, 252, 296, 400, 508]}
DECODE_LENS = [0, 16, 99, 254, 255, 299, 510, 511]


def check_attention(timer, dev, g) -> dict:
    """The paged attention kernels at the serving shape (bs=16, 32 blocks
    per slot; qwen1.5-0.5b widths) in every (q, pool) dtype pair and with
    GQA, then the head dims and GQA widths of ROADMAP Queue 3 fault A:
    phi3-mini's hd 96 (32 heads; decode and chunk) and qwen2-72b's GQA 8 x
    hd 128 (64 heads over 8; decode, and chunk at W 16 and 32), with
    ``live_kv``, and the head dims of fault F (the general walk:
    recurrentgemma-2b's MQA 10 x hd 256, hd 192, the ragged 72 and 66).
    Both kernels are also timed at the serving shape over fixed key-range
    counts, and one split call of each runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    print("\n== paged attention kernels vs plain (bs=16, 32 blocks/slot)")
    print(f"{'kernel':>26} {'q/pool':>10} {'h/kv':>6} {'err':>10} {'tol':>8} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'sdpa_ms':>9} {'bound_ms':>9} "
          f"{'of tol':>7}")
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    cases = [(bf, bf, 16, 16), (f32, bf, 16, 16), (f32, f32, 16, 16),
             (bf, bf, 16, 4), (f32, i8, 16, 16), (bf, i8, 16, 16)]
    entries = {}
    B, hd = 8, 64
    shape = {"paged_decode_attention": (1, DECODE_LENS),
             "chunked_prefill_attention": (ENGINE["chunk"], CHUNK_STARTS[16])}
    for name, (W, starts) in shape.items():
        for q_dt, kv_dt, h, kv in cases:
            nums = attn_case(timer, dev, g, name, q_dt, kv_dt, B, W, h, kv,
                             hd, starts)
            if (q_dt, kv_dt, h, kv) == cases[0]:
                entries[name] = dict(nums, other_shapes=[])
            elif (q_dt, kv_dt) == (bf, i8):
                entries[name]["int8_pool"] = nums
    # phase 9's speculative decode step verifies k + 1 = 4 lanes per slot:
    # 4 of a CTA's 16 query rows live (n_rep 1), over a bf16 and an int8
    # pool
    print(f"speculative verify (W = {SPEC_K + 1}; a speculating fleet's with "
          "live_kv, groups 12-15 dead on every other slot):")
    for live in (None, [16, 12] * (B // 2)):
        for kv_dt in (bf, i8):
            entries["chunked_prefill_attention"]["other_shapes"].append(
                attn_case(timer, dev, g, "chunked_prefill_attention", bf,
                          kv_dt, B, SPEC_K + 1, 16, 16, hd,
                          CHUNK_STARTS[SPEC_K + 1],
                          label=f"{'fleet ' if live else ''}speculative "
                                f"verify W {SPEC_K + 1}"
                                + (" live_kv" if live else ""), live=live))
    # fault A: hd 96 (phi3-mini: 32 heads of 96, no GQA) and GQA 8 x hd 128
    # (qwen2-72b: 64 heads over 8 kv heads): decode, chunk at W 16 and 32
    print("fault A shapes (ROADMAP Queue 3):")
    qwen72 = "qwen2-72b GQA 8 x hd 128"
    for name, W, h, kv, hdf, label in (
            ("paged_decode_attention", 1, 32, 32, 96, "phi3-mini hd 96"),
            ("paged_decode_attention", 1, 64, 8, 128, qwen72),
            ("chunked_prefill_attention", 16, 32, 32, 96, "phi3-mini hd 96"),
            ("chunked_prefill_attention", 16, 64, 8, 128, f"{qwen72} W 16"),
            ("chunked_prefill_attention", 32, 64, 8, 128, f"{qwen72} W 32")):
        starts = DECODE_LENS if W == 1 else CHUNK_STARTS[W]
        for kv_dt in (bf, i8):
            nums = attn_case(timer, dev, g, name, bf, kv_dt, B, W, h, kv,
                             hdf, starts, label=label)
            entries[name]["other_shapes"].append(nums)
    # phase 11's granite-moe: 16 heads over 8 kv heads of 64 (n_rep 2),
    # decode and chunk at W 16, over bf16 and int8 pools
    print("granite-moe-1b-a400m (16 heads over 8 kv heads of 64):")
    for name, (W, starts) in shape.items():
        for kv_dt in (bf, i8):
            entries[name]["other_shapes"].append(attn_case(
                timer, dev, g, name, bf, kv_dt, B, W, GRANITE_ATTN["h"],
                GRANITE_ATTN["kv"], GRANITE_ATTN["hd"], starts,
                label="granite-moe n_rep 2 x hd 64"))
    # live_kv (the fleet's dead kv groups): at the fleet's shape (16 heads
    # of 64, one per kv group as the fabric packs them; groups 12-15 dead
    # on every other slot, as adaptor-bert-shaped's 12 heads leave them),
    # then at hd 96 and GQA 8 x hd 128
    print("live_kv (dead groups NaN in q and pool, outputs exact zeros; "
          "fixed key ranges 1 and 3 gated too):")
    for name, (W, starts) in shape.items():
        sub = []
        for h, kv, hdf, dead, label in (
                (16, 16, hd, 4, "fleet"),
                (32, 32, 96, 4, "phi3-mini hd 96"),
                (64, 8, 128, 2, qwen72)):
            live = [kv, kv - dead] * (B // 2)
            for kv_dt in (bf, i8):
                sub.append(attn_case(timer, dev, g, name, bf, kv_dt, B, W, h,
                                     kv, hdf, starts,
                                     label=f"live_kv {label}", live=live))
        entries[name]["live_kv"] = dict(sub[0], int8_pool=sub[1],
                                        other_shapes=sub[2:])
    # fault F (ROADMAP Queue 3): the general walk (K rows staged at hd
    # rounded up to 16, 128-column groups) at recurrentgemma-2b's widths (10
    # heads over 1 kv head of 256) over bf16, f32 and int8 pools, at hd 192
    # and at the ragged hd 72 (16-byte bf16 rows) and 66 (4-byte bf16 rows)
    # over bf16 and int8 pools; decode (W = 1) and chunk (W = 16)
    print("fault F shapes (ROADMAP Queue 3; the general walk):")
    for name, (W, starts) in shape.items():
        sub = []
        for h, kv, hdf, pairs, label in (
                (RGEMMA["heads"], 1, RGEMMA["hd"], ((bf, bf), (f32, f32),
                                                   (bf, i8)),
                 "recurrentgemma-2b MQA 10 x hd 256"),
                (16, 4, 192, ((bf, bf), (bf, i8)), "hd 192"),
                (16, 16, 72, ((bf, bf), (bf, i8)), "ragged hd 72"),
                (16, 16, 66, ((bf, bf), (bf, i8)), "ragged hd 66")):
            for q_dt, kv_dt in pairs:
                sub.append(attn_case(timer, dev, g, name, q_dt, kv_dt, B, W,
                                     h, kv, hdf, starts,
                                     label=f"fault F {label}"))
        entries[name]["fault_f"] = sub
    # both kernels at the serving shape over fixed key-range counts; the
    # plan's own count (its wave: the walk's resident CTAs per SM from the
    # CUDA occupancy) among them
    print("fixed key-range counts at the serving shape:")
    for name, (W, starts) in shape.items():
        e = entries[name]
        e["fixed_splits"] = []
        for kv_dt, plan in ((bf, e["splits"]), (i8, e["int8_pool"]["splits"])):
            resident = cp_mod.resident_ctas(dev, bf, kv_dt, hd, 32, name)
            print(f"  {name}, pool {kv_dt}: {resident} resident CTAs per "
                  f"SM, the plan takes {plan} key ranges")
            for splits in sorted({1, 2, 3, 4, 8, plan}):
                with mock.patch.object(cp_mod, "kv_splits",
                                       lambda *a, s=splits: s):
                    nums = attn_case(timer, dev, g, name, bf, kv_dt, B, W,
                                     16, 16, hd, starts,
                                     label=f"splits={splits}")
                e["fixed_splits"].append(dict(pool=str(kv_dt)[6:],
                                              splits=splits, ms=nums["ms"]))
    # the wrappers never wait for the device (a split launch: workspace,
    # plan and merge included)
    for name, (W, starts) in shape.items():
        q, kp, vp, tables, start, _ = paged_inputs(g, dev, B, W, 16, 16, hd,
                                                   bf, bf, starts)
        args = (q[:, 0].contiguous(), kp, vp, tables, start + 1) \
            if W == 1 else (q, kp, vp, tables, start)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            KERNELS[name](*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        grid = KERNELS[name].last_grid
        if grid[1] < 2:
            raise AssertionError(f"{name}: the sync check took one key range")
        print(f"{name} under set_sync_debug_mode('error'): no host sync "
              f"(grid {grid})")
    return entries


def lib_check(timer, name: str, label: str, dt, run, plain, lib,
              nbytes: float, flops: float, peak_dt, tol: float | None,
              gate=None) -> dict:
    """One kernel of the library against its plain version: gated at
    ``tol`` x max|plain output| or, given ``gate``, at ``gate(plain
    output)``; then kernel, plain version and library call (None: no single
    PyTorch call) timed and printed beside the bound."""
    out, ref = run(), plain()
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(max_err(o, r) for o, r in zip(out, ref, strict=True))
    lim = gate(ref[0]) if gate is not None \
        else tol * max(float(r.float().abs().max()) for r in ref)
    if err > lim:
        raise AssertionError(f"{name} {label} {dt}: err {err} > tol {lim}")
    ms, pms = timer(run), timer(plain)
    lms = timer(lib) if lib is not None else None
    bms, by = bound_ms(nbytes, flops, peak_dt)
    lib_s = "none" if lms is None else f"{lms:.4f}"
    print(f"{name:>15} {label:>36} {str(dt)[6:]:>8} {err:>10.3g} "
          f"{lim:>10.3g} {ms:>10.4f} {pms:>9.4f} {lib_s:>9} "
          f"{bms:>9.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms, shape=f"{label} {str(dt)[6:]}")


def check_norms(timer, dev, g) -> dict:
    """``rmsnorm`` and ``layernorm`` against their plain versions at every
    shape of ``NORM_SHAPES`` (serving steps and prefills of qwen1.5-0.5b,
    qwen2-72b, adaptor_bert and whisper-medium; D 65, 3000 and 65536; an
    x one element past an aligned address), in bf16 and f32, timed with
    float32 parameters and gated again, untimed, with bfloat16 ones.
    Gates: ``NORM_TOL`` x max|plain| (f32 1e-5, the order of sums; bf16
    2^-7, one rounding of the f32 result).  Library yardsticks (never
    called by the port): ``F.rms_norm`` / ``F.layer_norm`` (parameters in
    x's dtype).  The Timer's floor, one launch of a 1-element fill, is
    printed first.  Each row prints the plan the wrapper launched."""
    floor = timer(torch.zeros(1, device=dev).zero_)
    print(f"\n== norms vs plain (kernels/layernorm.py's two TPU kernels); "
          f"Timer floor (one 1-element fill): {floor:.4f} ms")
    print(f"{'kernel':>15} {'shape':>36} {'dtype':>8} {'err':>10} {'tol':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'lib_ms':>9} {'bound_ms':>9}")
    rows = {"rmsnorm": [], "layernorm": []}
    for kernel, R, D, name, off in NORM_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x, params = norm_operands(g, dev, kernel, R, D, off, dt)
            run, plain, lib = norm_calls(ln_mod, kernel, x, params)
            e = lib_check(timer, kernel, f"{R}x{D} {name}", dt, run, plain,
                          lib, *norm_cost(kernel, R, D, x.element_size(), 4),
                          torch.float32, NORM_TOL[dt])
            e["plan"] = list(KERNELS[kernel].last_plan)
            # the same row with bfloat16 parameters, gated only
            run, plain, _ = norm_calls(ln_mod, kernel, x,
                                       tuple(p.bfloat16() for p in params))
            err, lim = norm_err(run(), plain())
            print(f"{'':>15} plan {e['plan']}; bf16 parameters: plan "
                  f"{list(KERNELS[kernel].last_plan)}, err {err:.3g} "
                  f"(tol {lim:.3g})")
            if err > lim:
                raise AssertionError(f"{kernel} {R}x{D} {dt} bf16 "
                                     f"parameters: err {err} > tol {lim}")
            if dt == torch.bfloat16 and off == 0 \
                    and (R, D) == MAIN_NORM[kernel]:
                rows[kernel].insert(0, e)
            else:
                rows[kernel].append(e)
            del x, params, run, plain
    return {k: dict(es[0], other_shapes=es[1:], timer_floor_ms=floor)
            for k, es in rows.items()}


# recurrentgemma-2b's 512-token prefill bucket, three quarters full: a
# bucketed prefill's scan beside timing.RGLRU_SCAN_SHAPES (its plain loop
# run once, untimed)
SCAN_BUCKET = (1, 512, 2560, (384,))


def check_scan(timer, dev, g) -> dict:
    """``rglru_scan`` against its plain loop, bit for bit (the same two
    float32 operators a position, in the same order), hs and the last h,
    at ``RGLRU_SCAN_SHAPES`` and ``SCAN_BUCKET``: a = U(0, 1) (the gates'
    range), g normal, ragged lengths; each call's plan, grid and dynamic
    shared memory printed.  Timed beside the bound (``rglru_scan_cost``:
    a and g read at each live position and hs written at every one,
    (2 x live + B x S) x W x 4 bytes; 2 operations a live position and
    channel at the float32 rate); no single PyTorch call
    computes a linear recurrence, so no library time."""
    print("\n== rglru_scan vs its plain loop (h_t = a_t h_{t-1} + g_t, "
          "float32; the reference's lax.scan, no Pallas kernel)")
    print(f"{'B':>3} {'S':>5} {'W':>5} {'lengths':>26} {'err':>6} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'bound_ms':>9}")
    rows = []
    own = torch.Generator(device=dev)
    own.manual_seed(3)
    for B, S, W, lens in RGLRU_SCAN_SHAPES + (SCAN_BUCKET,):
        # the bucket row from a generator of its own, so the later phases
        # draw from ``g`` as before
        gen = own if (B, S, W, lens) == SCAN_BUCKET else g
        a = torch.rand(B, S, W, generator=gen, device=dev)
        gg = torch.randn(B, S, W, generator=gen, device=dev)
        n = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                   device=dev)
        run = lambda: rglru_scan(a, gg, n)  # noqa: E731
        plain = lambda: rglru_scan_plain(a, gg, n)  # noqa: E731
        (hs, h), (phs, ph) = run(), plain()
        err = max(max_err(hs, phs), max_err(h, ph))
        if not (torch.equal(hs, phs) and torch.equal(h, ph)):
            raise AssertionError(f"rglru_scan [{B}, {S}, {W}] lengths "
                                 f"{lens}: not bit for bit its plain loop "
                                 f"(max err {err})")
        nbytes, flops, _ = rglru_scan_cost(B, S, W, lens)
        bms, by = bound_ms(nbytes, flops, torch.float32)
        ms = timer(run)
        pms = None if (B, S, W, lens) == SCAN_BUCKET \
            else timer(plain, reps=5, warm=1)
        launch = scan_mod.describe(scan_mod._plan(B, S, W, False), B, W)
        print(f"{B:>3} {S:>5} {W:>5} {str(lens):>26} {err:>6.3g} "
              f"{ms:>10.4f} {'-' if pms is None else f'{pms:.4f}':>9} "
              f"{bms:>9.4f}\n      {launch}")
        rows.append(dict(max_abs_err=err, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, library_ms=None,
                         launch=launch,
                         shape=f"[{B}, {S}, {W}] float32, lengths {lens}"))
        del a, gg, hs, phs
    return {"rglru_scan": dict(rows[0], other_shapes=rows[1:])}


def check_ssm_scan(timer, dev, g) -> dict:
    """``ssm_scan`` against its plain loop, bit for bit (the same float32
    operators a position, in the same order, the readout's tree of sums
    included), y and the last h, at ``SSM_SCAN_SHAPES`` (the last, a
    ragged Di and S, from a generator of its own so the others draw from
    ``g`` as before): dt = softplus of a normal, x bf16 (the serving
    path's compute dtype), b and c normal, a = -exp(U(-1, 1)), ragged
    lengths.  Timed beside the bound (``ssm_scan_cost``: dt, x read and y
    written a position and channel, b and c a position, a, lengths and
    the last h once; 8 float32 operations a live (position, channel,
    state), exp counted once, and the readout's 2 past a row's length, at
    the float32 rate) and the issue floor (the kernel's float32 lane
    instructions at every lane's rate).  No single PyTorch call computes a
    selective scan, so no library time."""
    print("\n== ssm_scan vs its plain loop (a_bar = exp(dt a), h = a_bar h + "
          "(dt b) x, y = h . c; float32, x bf16; the reference's lax.scan, "
          "no Pallas kernel)")
    print(f"{'B':>3} {'S':>5} {'Di':>5} {'N':>3} {'lengths':>26} {'err':>6} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'bound_ms':>9} "
          f"{'issue_ms':>9}")
    rows = []
    own = torch.Generator(device=dev)
    own.manual_seed(2)
    for k, (B, S, Di, N, lens) in enumerate(SSM_SCAN_SHAPES):
        gen = g if k < 4 else own
        dt, x, b, c, a = ssm_operands(gen, dev, B, S, Di, N)
        n = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                   device=dev)
        run = lambda: ssm_scan(dt, x, b, c, a, n)  # noqa: E731
        plain = lambda: ssm_scan_plain(dt, x, b, c, a, n)  # noqa: E731
        (y, h), (py, ph) = run(), plain()
        err = max(max_err(y, py), max_err(h, ph))
        if not (torch.equal(y, py) and torch.equal(h, ph)):
            raise AssertionError(f"ssm_scan [{B}, {S}, {Di}, {N}] lengths "
                                 f"{lens}: not bit for bit its plain loop "
                                 f"(max err {err})")
        nbytes, flops, lanes = ssm_scan_cost(B, S, Di, N, lens)
        bms, by = bound_ms(nbytes, flops, torch.float32)
        ims = issue_floor_ms(lanes)
        ms, pms = timer(run), timer(plain, reps=3, warm=1)
        print(f"{B:>3} {S:>5} {Di:>5} {N:>3} {str(lens):>26} {err:>6.3g} "
              f"{ms:>10.4f} {pms:>9.4f} {bms:>9.4f} {ims:>9.4f}")
        rows.append(dict(max_abs_err=err, ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, library_ms=None,
                         issue_floor_ms=ims,
                         shape=f"[{B}, {S}, {Di}, {N}] float32, x bf16, "
                               f"lengths {lens}"))
        del dt, x, b, c, y, py
    return {"ssm_scan": dict(rows[0], other_shapes=rows[1:])}


def check_library(timer, dev, g) -> dict:
    """The other four kernels of the library entry point against their
    plain versions at full model widths, in bf16 and f32.  Gates: f32 at
    1e-5 x max|plain| (order of sums), bf16 at 2^-7 x max|plain| (one
    rounding of the f32 result); flash attention at ``flash_limit``;
    ``qkv_proj`` bit for bit against three ``tiled_matmul`` launches.
    Library yardsticks (never called by the port): ``torch.addmm``
    (product and bias, no activation), one ``torch.matmul`` against the
    concatenated weights, SDPA."""
    fn = torch.nn.functional
    print("\n== kernel library vs plain (kernels/ops.py's other TPU kernels)")
    print(f"{'kernel':>15} {'shape':>36} {'dtype':>8} {'err':>10} {'tol':>10} "
          f"{'kernel_ms':>10} {'plain_ms':>9} {'lib_ms':>9} {'bound_ms':>9}")

    def rn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    entries = {}
    for dt in (torch.bfloat16, torch.float32):
        es = torch.empty((), dtype=dt).element_size()
        tol = 1e-5 if dt == torch.float32 else 2 ** -7
        main = dt == torch.bfloat16

        m, d = BERT["batch"] * BERT["seq"], BERT["d"]
        x = rn(m, d, dt=dt)

        # ffn1 relu / gelu: adaptor_bert, f32 bias
        f = BERT["ff"]
        w1 = rn(d, f, dt=dt, scale=d ** -0.5)
        b1 = 0.1 * torch.randn(f, generator=g, device=dev)
        b1_lib = b1.to(dt)
        for a in ("relu", "gelu"):
            e = lib_check(timer, "ffn1", f"{a} {m}x{d}->{f} adaptor_bert", dt,
                          lambda: ffn1(x, w1, b1, a),
                          lambda: ffn1_plain(x, w1, b1, a),
                          lambda: torch.addmm(b1_lib, x, w1),
                          (m * d + d * f + m * f) * es + f * 4, 2 * m * d * f,
                          dt, tol)
            print(f"{'':>15} {mma_grid(e)}")
            if main and a == "gelu":
                entries["ffn1"] = e

        # ffn1_gated swiglu / geglu: qwen1.5-0.5b
        m, d, f = QWEN["rows"], QWEN["d"], QWEN["ff"]
        x = rn(m, d, dt=dt)
        w1, wg = (rn(d, f, dt=dt, scale=d ** -0.5) for _ in range(2))
        w1g = torch.cat([w1, wg], dim=1)
        for a in ("swiglu", "geglu"):
            e = lib_check(timer, "ffn1_gated",
                          f"{a} {m}x{d}->2x{f} qwen1.5-0.5b", dt,
                          lambda: ffn1_gated(x, w1, wg, a),
                          lambda: ffn1_gated_plain(x, w1, wg, a),
                          lambda: torch.matmul(x, w1g),
                          (m * d + 2 * d * f + m * f) * es, 4 * m * d * f,
                          dt, tol)
            print(f"{'':>15} {mma_grid(e)}")
            if main and a == "swiglu":
                entries["ffn1_gated"] = e
        del w1, wg, w1g

        # qkv_proj: MHA at qwen1.5-0.5b, GQA at qwen2-72b (168 MB of bf16
        # weights), each bit for bit equal to three tiled_matmul launches
        for label, d, nq, nkv in (
                ("MHA qwen1.5-0.5b", QWEN["d"], QWEN["d"], QWEN["d"]),
                ("GQA qwen2-72b", QWEN72["d"], QWEN72["d"],
                 QWEN72["kv_width"])):
            x = rn(m, d, dt=dt)
            ws = [rn(d, n, dt=dt, scale=d ** -0.5) for n in (nq, nkv, nkv)]
            for o, w in zip(qkv_proj(x, *ws), ws, strict=True):
                if not torch.equal(o, tiled_matmul(x, w)):
                    raise AssertionError(f"qkv_proj {label} {dt} is not bit "
                                         "for bit three tiled_matmuls")
            wqkv = torch.cat(ws, dim=1)
            n = nq + 2 * nkv
            e = lib_check(timer, "qkv_proj",
                          f"{label} {m}x{d}->{nq}+2x{nkv}", dt,
                          lambda: qkv_proj(x, *ws),
                          lambda: qkv_proj_plain(x, *ws),
                          lambda: torch.matmul(x, wqkv),
                          (m * d + d * n + m * n) * es, 2 * m * d * n, dt,
                          tol)
            print(f"{'':>15} {mma_grid(e)}")
            if main and label.startswith("MHA"):
                entries["qkv_proj"] = e
            elif main:
                entries["qkv_proj"]["other_shapes"] = [e]
            del ws, wqkv

        # flash attention: one qwen1.5-0.5b prompt (causal), adaptor_bert
        # (non-causal), whisper-medium cross attention over 1500 frames,
        # one qwen2-72b-width prompt (causal, 64 heads of 128),
        # recurrentgemma-2b's local attention (hd 256) and hd 512 (both
        # past the old hd 128 limit: column groups); the grid (query-tile
        # CTAs x column groups x key ranges) the wrapper launched beside
        # each
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        flash = []
        for label, b, sq, skv, h, hd, causal in (
                ("causal qwen1.5-0.5b prompt", 1, QWEN["prompt"],
                 QWEN["prompt"], QWEN["heads"], QWEN["hd"], True),
                ("adaptor_bert", BERT["batch"], BERT["seq"], BERT["seq"],
                 BERT["heads"], BERT["hd"], False),
                ("cross whisper-medium", 1, 64, WHISPER["frames"],
                 WHISPER["heads"], WHISPER["hd"], False),
                ("causal qwen2-72b prompt", 1, QWEN["prompt"], QWEN["prompt"],
                 QWEN72["heads"], QWEN72["hd"], True),
                ("local recurrentgemma-2b", 1, RGEMMA["window"],
                 RGEMMA["window"], RGEMMA["heads"], RGEMMA["hd"], True),
                ("causal hd 512", 1, 512, 512, 8, 512, True)):
            q = rn(b, sq, h, hd, dt=dt)
            k, v = rn(b, skv, h, hd, dt=dt), rn(b, skv, h, hd, dt=dt)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            pairs = sum(min(i + 1, skv) for i in range(sq)) if causal \
                else sq * skv
            e = lib_check(
                timer, "flash_attention",
                f"{label} [{b},{sq}|{skv},{h},{hd}]", dt,
                lambda: flash_attention(q, k, v, causal=causal),
                lambda: flash_attention_plain(q, k, v, causal=causal),
                lambda: fn.scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=causal),
                (2 * b * sq + 2 * b * skv) * h * hd * es,
                4 * b * h * hd * pairs, dt, None,
                gate=lambda ref, v=v: flash_limit(v, ref))
            print(f"{'':>15} {flash_grid(e)} on {sms} SMs")
            if hd == 512 and main:
                print(f"{'':>15} SDPA at hd 512 runs "
                      f"{sdpa_kernels(qt, kt, vt, causal)}")
            flash.append(e)
        # the kernel's contract beyond the timed shapes, gated only: a
        # ragged hd (80: padded to 96 in shared memory, 16-byte loads; 36:
        # element loads; 200: two column groups, the second ragged) over a
        # split 1000-key walk
        for hd in (80, 36, 200):
            q = rn(1, 64, 8, hd, dt=dt)
            k, v = rn(1, 1000, 8, hd, dt=dt), rn(1, 1000, 8, hd, dt=dt)
            want = flash_attention_plain(q, k, v, causal=False)
            err = max_err(flash_attention(q, k, v, causal=False), want)
            lim = flash_limit(v, want)
            print(f"{'flash_attention':>15} {f'ragged hd [1,64|1000,8,{hd}]':>36} "
                  f"{str(dt)[6:]:>8} {err:>10.3g} {lim:>10.3g}   (gated, "
                  f"not timed; {flash_grid({})})")
            if err > lim:
                raise AssertionError(f"flash_attention ragged hd {hd} {dt}: "
                                     f"err {err} > tol {lim}")
        if main:
            # one query tile past the grid's old y limit of 65535 tiles
            # (fault D): 4 194 241 rows, 537 MB of q and o
            sq = 65535 * 64 + 1
            q = rn(1, sq, 1, 32, dt=dt)
            k, v = rn(1, 64, 1, 32, dt=dt), rn(1, 64, 1, 32, dt=dt)
            want = flash_attention_plain(q, k, v, causal=False)
            err = max_err(flash_attention(q, k, v, causal=False), want)
            lim = flash_limit(v, want)
            print(f"{'flash_attention':>15} {f'[1,{sq}|64,1,32]':>36} "
                  f"{str(dt)[6:]:>8} {err:>10.3g} {lim:>10.3g}   (gated, "
                  f"not timed; {flash_grid({})})")
            if err > lim:
                raise AssertionError(f"flash_attention Sq {sq}: err {err} "
                                     f"> tol {lim}")
            del q, k, v, want
        if main:
            entries["flash_attention"] = dict(flash[0], other_shapes=flash[1:])
        else:
            entries["flash_attention"]["f32_shapes"] = flash
    return entries


# ---------------------------------------------------------------------------
# phase 3: the kernel library entry point
# ---------------------------------------------------------------------------
def check_ops(dev, g) -> dict:
    """The kernel library entry point: every function of
    ``repro_torch.kernels.ops`` on CUDA tensors with leading batch dims,
    chained as one layer at qwen1.5-0.5b's widths over [8, 16, 1024] bf16
    (8 requests x 16 tokens; rmsnorm -> qkv_proj -> causal flash attention
    -> tiled_matmul -> residual -> layernorm -> ffn1_gated / ffn1 ->
    quantized_dense).  Each result is held against the plain versions on
    the same inputs (2^-7 x max|plain|; attention ``flash_limit``;
    ``quantized_dense`` exact).  The counts are zeroed just before and
    read just after; every kernel of the path must have launched."""
    print("\n== the kernel library entry point (repro_torch.kernels.ops): "
          f"one layer over [8, 16, {QWEN['d']}] bf16")
    for kfn in KERNELS.values():
        kfn.launches = 0
    dt, tol = torch.bfloat16, 2 ** -7
    B, S, d, f = 8, 16, QWEN["d"], QWEN["ff"]
    H, hd = QWEN["heads"], QWEN["hd"]

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    def check(name, got, want, shape, lim=None, exact=False):
        if tuple(got.shape) != shape:
            raise AssertionError(f"ops.{name}: shape {tuple(got.shape)} != "
                                 f"{shape}")
        err = max_err(got, want.reshape(got.shape))
        if lim is None:
            lim = 0.0 if exact else tol * float(want.float().abs().max())
        print(f"ops.{name:<16} {str(shape):>18} err {err:.3g} (tol {lim:.3g})")
        if err > lim:
            raise AssertionError(f"ops.{name}: err {err} > tol {lim}")

    x = rn(B, S, d)
    gam = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    bet = 0.1 * torch.randn(d, generator=g, device=dev)
    wq, wk, wv, wo = (rn(d, d, scale=d ** -0.5) for _ in range(4))
    w1, wg = rn(d, f, scale=d ** -0.5), rn(d, f, scale=d ** -0.5)
    b1 = 0.1 * torch.randn(f, generator=g, device=dev)
    qw2 = quantize(torch.randn(f, d, generator=g, device=dev) * f ** -0.5)

    h = ops.rmsnorm(x, gam)
    check("rmsnorm", h, rmsnorm_plain(flat(x), gam), (B, S, d))
    q, k, v = ops.qkv_proj(h, wq, wk, wv)
    for name, t, w in (("qkv_proj q", q, wq), ("qkv_proj k", k, wk),
                       ("qkv_proj v", v, wv)):
        check(name, t, tiled_matmul_plain(flat(h), w), (B, S, d))
    qa, ka, va = (t.reshape(B, S, H, hd) for t in (q, k, v))
    a = ops.flash_attention(qa, ka, va, causal=True)
    want = flash_attention_plain(qa, ka, va)
    check("flash_attention", a, want, (B, S, H, hd), flash_limit(va, want))
    o = ops.tiled_matmul(a.reshape(B, S, d), wo)
    check("tiled_matmul", o, tiled_matmul_plain(flat(a.reshape(B, S, d)), wo),
          (B, S, d))
    r = x + o
    n = ops.layernorm(r, gam, bet)
    check("layernorm", n, layernorm_plain(flat(r), gam, bet), (B, S, d))
    fg = ops.ffn1_gated(n, w1, wg, "swiglu")
    check("ffn1_gated", fg, ffn1_gated_plain(flat(n), w1, wg, "swiglu"),
          (B, S, f))
    f1 = ops.ffn1(n, w1, b1, "gelu")
    check("ffn1", f1, ffn1_plain(flat(n), w1, b1, "gelu"), (B, S, f))
    y = ops.quantized_dense(fg, qw2)
    qx = quantize(flat(fg), axis=None)
    check("quantized_dense", y,
          int8_matmul_plain(qx.values, qx.scale, qw2.values, qw2.scale, dt),
          (B, S, d), exact=True)
    counts = {name: kfn.launches for name, kfn in KERNELS.items()}
    print(f"launches on the ops path: {counts}")
    for name in PATH_KERNELS["ops"]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the ops path")
    return counts




# ---------------------------------------------------------------------------
# phase 4: full-width model steps, kernels vs plain path
# ---------------------------------------------------------------------------
def full_width_spec(kernels: bool, quant: bool = False,
                    arch: ArchConfig | None = None) -> RuntimeSpec:
    """The serving spec at full width (qwen1.5-0.5b unless ``arch``);
    ``quant`` serves fully quantized (int8 weights at the reference's
    default floor, int8 KV pool)."""
    impl = ("pallas", "pallas") if kernels else ("xla", "gather")
    return RuntimeSpec(
        arch=arch or get_config("qwen1.5-0.5b"),
        execution=ExecutionSpec(matmul_backend=impl[0],
                                paged_attn_impl=impl[1],
                                compute_dtype="bf16",
                                quant="int8" if quant else "none"),
        memory=MemorySpec(cache_layout="paged",
                          max_batch=ENGINE["max_batch"],
                          max_len=ENGINE["max_len"],
                          block_size=ENGINE["block_size"],
                          kv_dtype="int8" if quant else "compute"),
        scheduler=SchedulerSpec(chunk_size=ENGINE["chunk"]))


class OpCount(TorchDispatchMode):
    """Counts the PyTorch operators dispatched inside it (the host's work
    per step; the hand-written kernels' ctypes launches are not among
    them, their wrappers' output allocations are)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def eager_norms():
    """The model's norms on ``apply_norm``'s plain ``"xla"`` branch, every
    other kernel as selected."""
    apply_norm = layers_mod.apply_norm
    with mock.patch.object(layers_mod, "apply_norm",
                           lambda x, p, kind, mm: apply_norm(x, p, kind,
                                                             "xla")):
        yield


@contextlib.contextmanager
def plain_versions(perturb: float = 0.0):
    """Every kernel call of the model replaced by that kernel's plain
    PyTorch version, on the same CUDA tensors; ``perturb`` scales the
    attention outputs by (1 + perturb), a float32 error of the size the
    attention kernels' other order of sums makes."""
    def scaled(fn):
        return lambda *a, **k: fn(*a, **k) * (1.0 + perturb)
    with mock.patch.object(tm_mod, "tiled_matmul", tiled_matmul_plain), \
            mock.patch.object(i8_mod, "int8_matmul", int8_matmul_plain), \
            mock.patch.object(scan_mod, "rglru_scan", rglru_scan_plain), \
            mock.patch.object(sscan_mod, "ssm_scan", ssm_scan_plain), \
            mock.patch.object(ln_mod, "rmsnorm", rmsnorm_plain), \
            mock.patch.object(ln_mod, "layernorm", layernorm_plain), \
            mock.patch.object(attn_mod, "paged_decode_attention",
                              scaled(paged_decode_attention_plain)), \
            mock.patch.object(attn_mod, "chunked_prefill_attention",
                              scaled(chunked_prefill_attention_plain)):
        yield


# the step paths of phase 4: (matmul backend, attention impl, context)
STEP_PATHS = {
    "kernels": (("pallas", "pallas"), contextlib.nullcontext),
    "kernels, norms eager": (("pallas", "pallas"), eager_norms),
    "plain versions": (("pallas", "pallas"), plain_versions),
    "plain, perturbed": (("pallas", "pallas"),
                         lambda: plain_versions(ATTN_PERTURB)),
    "xla + gather": (("xla", "gather"), contextlib.nullcontext)}


def unembed_exact(x: torch.Tensor, table) -> torch.Tensor:
    """``layers.unembed(x, table)`` in float64, 16384 vocab rows at a time
    (the float32 product's reference)."""
    xd = x.reshape(-1, x.shape[-1]).double()
    t = table.values.double() * table.scale.double() \
        if isinstance(table, QTensor) else table
    out = torch.cat([xd @ t[i:i + 16384].double().t()
                     for i in range(0, t.shape[0], 16384)], dim=1)
    return out.reshape(*x.shape[:-1], -1)


# the live lanes of each slot in phase 4's mixed step
STEP_N_LIVE = (16, 16, 16, 16, 16, 9, 3, 1)


def check_model_steps(model: Model, dev, g, gate: bool,
                      paths=tuple(STEP_PATHS)) -> dict:
    """One mixed step (a 16-lane chunk, some slots partial) then one decode
    step, on fresh pools, along ``paths`` of ``STEP_PATHS``: the kernels,
    the kernels with the model's norms eager (``eager_norms``), the
    kernels' plain versions, those plain versions with the attention
    outputs perturbed by ``ATTN_PERTURB`` (relative), and the XLA-style
    path ``matmul_backend="xla"`` + ``paged_attn_impl="gather"`` (whose
    scores are rounded to the compute dtype before the softmax, as the
    reference's gather path does; under int8 weights it is another
    function, with no activation quantization).  Max and mean
    |difference| against the plain versions are printed, and the PyTorch
    operators each step of the kernel paths dispatches.  With ``gate``
    the kernels' max must stay within 2e-2 * max|logits|, or within twice
    the perturbed path's max where that is larger: with int8 activations
    (one per-tensor scale) a float32 last-bit difference moves values
    across rounding boundaries and grows over 24 layers, so the model's
    own sensitivity, not the kernels, sets the floor.  For a model with an
    untied ``lm_head`` the unembedding's own share of the kernels' logit
    distance is printed: the distance between its float32 product on the
    kernel path's final states and the same product in float64, over the
    kernels' distance from the plain versions.  Returns each step's
    kernels' distance and tolerance."""
    dt = str(model.compute_dtype)[6:]
    kind = "int8 weights + int8 pool" if model.quant == "int8" \
        else "float weights + bf16 pool"
    cfg = model.cfg
    print(f"\n== full-width {cfg.name} steps ({cfg.num_layers} layers), "
          f"{kind}, {dt} compute: |path - kernels' plain versions| "
          + ("(gated)" if gate else "(reported)"))
    paging = full_width_spec(True).memory.paging()
    B, W = ENGINE["max_batch"], ENGINE["chunk"]
    nblk = ENGINE["max_len"] // ENGINE["block_size"]
    tables = (torch.randperm(paging.num_blocks, generator=g, device=dev)
              .reshape(B, nblk) + 1).to(torch.int32)
    vocab = cfg.vocab_size
    toks = torch.randint(0, vocab, (B, W), generator=g, device=dev,
                         dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    n_live = torch.tensor(STEP_N_LIVE, dtype=torch.int32, device=dev)
    dtoks = torch.randint(0, vocab, (B, 1), generator=g, device=dev,
                          dtype=torch.int32)
    live = torch.arange(W, device=dev)[None, :] < n_live[:, None]
    out, ops, heads = {}, {}, []
    unembed = layers_mod.unembed

    def recording(x, table):
        heads.append((x, table))
        return unembed(x, table)

    for path in paths:
        (mm, attn), ctx = STEP_PATHS[path]
        model.matmul_backend, model.paged_attn_impl = mm, attn
        cache = model.init_cache(paging)
        counts = (OpCount(), OpCount()) if path.startswith("kernels") \
            else (contextlib.nullcontext(),) * 2
        record = mock.patch.object(layers_mod, "unembed", recording) \
            if path == "kernels" else contextlib.nullcontext()
        with ctx(), record:
            with counts[0]:
                mixed = model.mixed_step(cache, toks, start, n_live, tables)
            with counts[1]:
                dec = model.decode_step(cache, dtoks, n_live.clone(), tables)
        if path.startswith("kernels"):
            ops[path] = [c.n for c in counts]
        out[path] = (mixed[live], dec)
        del cache
    model.matmul_backend, model.paged_attn_impl = "pallas", "pallas"
    print("PyTorch operators dispatched per step on the kernel path: "
          + "; ".join(f"{path}: mixed {n[0]}, decode {n[1]}"
                      for path, n in ops.items()))
    result = {}
    for i, step in enumerate(("mixed_step", "decode_step")):
        ref = out["plain versions"][i]
        floor = max_err(out["plain, perturbed"][i], ref)
        tol = max(LOGIT_TOL * float(ref.abs().max()), 2 * floor)
        line = (f"{step}: tol max({LOGIT_TOL} x max|logits|, 2 x perturbed) "
                f"= {tol:.4g}")
        for path in paths:
            if path == "plain versions":
                continue
            d = (out[path][i] - ref).abs()
            line += (f"; {path}: max {float(d.max()):.4g} "
                     f"mean {float(d.mean()):.4g}")
        print(line)
        err = max_err(out["kernels"][i], ref)
        result[step] = dict(err=err, tol=tol)
        if model.lm_head is not None:
            x, table = heads[i]
            exact = unembed_exact(x, table)
            exact = exact[live] if i == 0 else exact
            d_head = max_err(out["kernels"][i], exact)
            result[step]["lm_head"] = d_head
            print(f"  untied lm_head ({table.shape[0]} x {table.shape[1]}, "
                  f"f32 torch.matmul): its own float32 error {d_head:.4g} "
                  f"against float64 on the kernel path's final states, "
                  f"{d_head / err if err else float('nan'):.3g} of the "
                  f"kernels' distance {err:.4g}")
        if gate and err > tol:
            raise AssertionError(f"{cfg.name} {step} logits disagree: "
                                 f"{err} > {tol}")
    return result


def census_dependent_launches(params, dev, g) -> None:
    """ROADMAP Queue 1 item 7a: does a split matmul's reduce, launched as a
    programmatic dependent (``csrc/launch.cuh`` ``launch_dependent``),
    capture as a programmatic edge?  One full-width mixed step of the
    float kernel path is captured (``keep_graph=True``) and the graph's
    nodes and edges by type are read through libcuda's
    ``cuGraphGetEdges_v2``: each split ``tiled_matmul`` should give one
    programmatic edge (loop -> reduce)."""
    model = Model.from_spec(full_width_spec(True), device=dev)
    model.load_state_dict(params)
    paging = full_width_spec(True).memory.paging()
    B, W = ENGINE["max_batch"], ENGINE["chunk"]
    nblk = ENGINE["max_len"] // ENGINE["block_size"]
    tables = (torch.arange(B * nblk, device=dev).reshape(B, nblk) + 1) \
        .to(torch.int32)
    toks = torch.randint(0, model.cfg.vocab_size, (B, W), generator=g,
                         device=dev, dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    n_live = torch.full((B,), W, dtype=torch.int32, device=dev)
    cache = model.init_cache(paging)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.mixed_step(cache, toks, start, n_live, tables)
    torch.cuda.current_stream().wait_stream(side)
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        print("dependent launches under capture: torch.cuda.CUDAGraph takes "
              "no keep_graph here, so the census is not available")
        return
    before = tm_mod.tiled_matmul.launches
    with torch.cuda.graph(graph, stream=side):
        model.mixed_step(cache, toks, start, n_live, tables)
    matmuls = tm_mod.tiled_matmul.launches - before
    split = tm_mod.launched_grid()[1] > 1
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n_nodes, n_edges = ctypes.c_size_t(0), ctypes.c_size_t(0)
    get_edges = getattr(cuda, "cuGraphGetEdges_v2", None)
    if get_edges is None:
        print("dependent launches under capture: libcuda gives no "
              "cuGraphGetEdges_v2, so the census is not available")
        return
    for err in (cuda.cuGraphGetNodes(raw, None, ctypes.byref(n_nodes)),
                get_edges(raw, None, None, None, ctypes.byref(n_edges))):
        if err:
            raise AssertionError(f"the graph census failed: CUresult {err}")
    n = n_edges.value
    src, dst = (ctypes.c_void_p * n)(), (ctypes.c_void_p * n)()
    data = (ctypes.c_ubyte * (8 * n))()    # CUgraphEdgeData: 8 bytes each
    err = get_edges(raw, src, dst, data, ctypes.byref(n_edges))
    if err:
        raise AssertionError(f"cuGraphGetEdges_v2 failed: {err}")
    kinds = collections.Counter(data[8 * i + 2] for i in range(n))
    print(f"dependent launches under capture: a full-width mixed step "
          f"graph holds {n_nodes.value} nodes and {n} edges, "
          f"{kinds.get(1, 0)} programmatic and {kinds.get(0, 0)} default; "
          f"{matmuls} tiled_matmul launches captured, "
          f"{'each' if split else 'none'} split into a loop and its reduce")
    del graph, cache, model


# ---------------------------------------------------------------------------
# phase 5: the serving engine's main path
# ---------------------------------------------------------------------------
def zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in LIVE_KV:
        KERNELS[name].live_kv_launches = 0


def made_launches(eng, captured: dict, replayed: dict) -> dict[str, int]:
    """The kernel launches a drain on ``eng`` made, the counts zeroed just
    before it and ``captured`` / ``replayed`` the engine's tallies then:
    every wrapper's count (eager steps, capture warm-ups, and the launches
    each capture recorded but did not run), less what the drain's captures
    recorded, plus each graph's capture counts times its replays in the
    drain (``ServingEngine.replayed_launches``)."""
    counts = launch_counts()
    return {n: counts[n] - (eng.captured_launches[n] - captured[n])
            + (eng.replayed_launches[n] - replayed[n]) for n in counts}


def device_events(prof) -> list:
    """The traced device activities (kernels, copies, fills), each name
    with its summed device time, longest first."""
    return sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)


def drain(eng, prompts, models=None, sync_every: int = 1,
          no_sync: bool = False, measure: str | None = None,
          max_new: int = MAX_NEW) -> dict:
    """Submit ``prompts`` (greedy, ``max_new`` tokens each; ``models``: the
    fleet member of each) and drain the engine; every request must finish
    with ``max_new`` tokens.  The kernel counts are zeroed just before the
    drain.  ``no_sync`` runs every fused step, captures included, under
    ``torch.cuda.set_sync_debug_mode("error")`` (ROADMAP Queue 3 fault
    B): a host sync in ``_dispatch`` raises, and no staging buffer may
    have waited.  ``measure``: "profile" traces the drain with
    ``torch.profiler`` (its device seconds), "ops" counts the PyTorch
    operators it dispatches.  Returns the streams, seconds, steps, the
    drain's share of the engine's stats, the engine's compilations and
    the launches made."""
    uids = {eng.submit(p, max_new_tokens=max_new,
                       model=0 if models is None else models[i]): i
            for i, p in enumerate(prompts)}
    dispatch = eng._dispatch

    def checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    meter = torch.profiler.profile(activities=act) if measure == "profile" \
        else OpCount() if measure == "ops" else contextlib.nullcontext()
    zero_counts()
    tallies = (collections.Counter(eng.captured_launches),
               collections.Counter(eng.replayed_launches))
    stats0 = dict(eng.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(eng, "_dispatch", checked) if no_sync \
            else contextlib.nullcontext(), meter:
        done = eng.run_to_completion(sync_every=sync_every)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(done) != len(prompts) or not all(r.done for r in done):
        raise AssertionError(f"{len(done)}/{len(prompts)} requests finished")
    streams = {uids[r.uid]: r.generated for r in done}
    if any(len(s) != max_new for s in streams.values()):
        raise AssertionError("a request stopped short of max_new_tokens")
    waits = sum(st.waits for st in eng._stages.values())
    if no_sync and waits:
        raise AssertionError(f"{waits} uploads waited for a staging buffer")
    stats = {k: v - stats0[k] for k, v in eng.stats.items()}
    out = dict(streams=streams, dt=dt, steps=stats["decode_steps"],
               stats=stats, compilations=dict(eng.compilations),
               launches=made_launches(eng, *tallies))
    if measure == "profile":
        # one pass over the trace (a 64-layer drain holds ~10^5 events)
        events = device_events(meter)
        us = sum(e.self_device_time_total for e in events)
        out["device_s"] = us / 1e6 if us else None
        out["kernels"] = [(e.key, e.count, e.self_device_time_total / 1e3)
                          for e in events]
        out["top"] = out["kernels"][:12]
    elif measure == "ops":
        out["ops"] = meter.n
    return out


def serve(params, prompts, kernels: bool = True, quant: bool = False,
          graphs: bool = True, arch: ArchConfig | None = None,
          warm: bool = False, **kw) -> dict:
    """A fresh full-width engine (``graphs``: each fused program one CUDA
    graph, else eager) loads ``params`` and drains ``prompts``; ``warm``
    drains them once more on the same engine (its graphs captured) into
    ``out["warm"]``."""
    eng = ServingEngine(full_width_spec(kernels, quant, arch), device="cuda",
                        graphs=graphs)
    eng.load(params)
    out = drain(eng, prompts, **kw)
    if warm:
        out["warm"] = drain(eng, prompts, **kw)
    del eng
    return out


def drain_line(label: str, r: dict, n_tok: int) -> str:
    st = r["stats"]
    return (f"{label}: {n_tok} tokens in {r['dt']:.3f} s "
            f"({n_tok / r['dt']:.1f} tok/s), {r['steps']} fused steps; "
            f"{st['graph_captures']} captures, {st['graph_replays']} "
            f"replays, {st['eager_steps']} eager steps; compilations "
            f"decode {r['compilations']['decode']} prefill "
            f"{r['compilations']['prefill']}")


def check_graphed(label: str, runs: dict, kernels, layers: int,
                  n_tok: int, norms: int | None = None) -> None:
    """Phase 5's graphed-against-eager gates on one path: both drains
    finish, the graphed streams equal the eager ones, each program was
    captured once (``compilations`` decode = prefill = 1) and no step ran
    eagerly, the launches the replays made equal the eager drain's, each
    kernel of ``kernels`` launched in both, and ``rmsnorm`` (where the
    path runs it) ``norms`` (default 2L+1) times per fused step."""
    norms = 2 * layers + 1 if norms is None else norms
    g, e = runs["graphed"], runs["eager"]
    for mode, r in runs.items():
        print(drain_line(f"{label}, {mode}", r, n_tok))
        print(f"  launches {dict((n, c) for n, c in r['launches'].items() if c)}")
    same = sum(a == b for i in g["streams"]
               for a, b in zip(g["streams"][i], e["streams"][i]))
    print(f"  {label}: identical tokens graphed vs eager {same}/{n_tok}")
    if g["streams"] != e["streams"]:
        raise AssertionError(f"{label}: the graphed streams differ from the "
                             f"eager ones ({same}/{n_tok})")
    comp = g["compilations"]
    if comp["decode"] != 1 or comp["prefill"] != 1 \
            or g["stats"]["eager_steps"]:
        raise AssertionError(f"{label}: compilations {comp}, eager steps "
                             f"{g['stats']['eager_steps']}; want one capture "
                             "per program and no eager step")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"{label}: the graphed drain's launches "
                             f"{g['launches']} differ from the eager "
                             f"drain's {e['launches']}")
    for r in runs.values():
        for name in kernels:
            if r["launches"][name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{label} path")
        if "rmsnorm" in kernels and r["launches"]["rmsnorm"] \
                != norms * r["steps"]:
            raise AssertionError(
                f"rmsnorm launched {r['launches']['rmsnorm']} times in "
                f"{r['steps']} steps on the {label} path, not "
                f"{norms * r['steps']}")


def no_sync_line(params, prompts, quant: bool) -> dict:
    """Fault B's check on the card: a graphed kernel-path drain at
    sync_every=4 with every fused step, the captures included, under
    ``set_sync_debug_mode("error")``; it must run mixed and decode steps
    and give the sync_every=1 streams."""
    r = serve(params, prompts, quant=quant, sync_every=4, no_sync=True)
    counts = {n: r["launches"][n] for n in ("chunked_prefill_attention",
                                            "paged_decode_attention")}
    if not all(counts.values()):
        raise AssertionError(f"the sync check ran no mixed or no decode "
                             f"step: {counts}")
    mixed = counts["chunked_prefill_attention"] \
        // full_width_spec(True).arch.num_layers
    print(f"{'int8' if quant else 'float'} weights, graphed, sync_every=4, "
          f"every fused step under set_sync_debug_mode('error'): no host "
          f"sync, no staging wait; {r['steps']} steps ({mixed} mixed, "
          f"{r['stats']['graph_captures']} captures), {r['dt']:.3f} s")
    return r["streams"]


def host_and_device_line(label: str, make_engine, prompts,
                         timed: dict) -> None:
    """The device's idle share and the host's PyTorch operators per fused
    step, for a graphed engine's first drain (its two captures and their
    warm-ups included), a warm graphed engine's drain (replays only) and
    an eager drain.  Idle: 1 - the device seconds of the kernels, copies
    and fills that ``torch.profiler`` traced in a drain, over the wall
    seconds of the untimed traced drain and of the same drain untraced
    (``timed``: phase 5's drains).  Operators: ``OpCount`` over a drain."""
    counted, traced, eager = make_engine(True), make_engine(True), \
        make_engine(False)
    runs = {"graphed, first drain": timed["graphed"],
            "graphed, warm engine": timed["graphed"]["warm"],
            "eager": timed["eager"]}
    for mode, untraced in runs.items():
        o = drain(eager if mode == "eager" else counted, prompts,
                  measure="ops")
        p = drain(eager if mode == "eager" else traced, prompts,
                  measure="profile")
        if p["device_s"] is None:
            idle = "not measured (the profiler traced no device activity)"
        else:
            idle = (f"{1 - p['device_s'] / untraced['dt']:.3f} of the "
                    f"untraced drain's {untraced['dt']:.3f} s "
                    f"({p['device_s'] * 1e3:.1f} ms of device time; "
                    f"{1 - p['device_s'] / p['dt']:.3f} of the traced "
                    f"drain's {p['dt']:.3f} s)")
        print(f"{label}, {mode}: device idle {idle}; PyTorch operators "
              f"{o['ops']} over {o['steps']} fused steps = "
              f"{o['ops'] / o['steps']:.1f} per step")
        if mode == "graphed, warm engine" and p["device_s"]:
            print("  where the warm drain's device time goes (the 12 "
                  "longest by name: calls, ms, share):")
            for key, calls, ms in p["top"]:
                print(f"    {key[:90]:<90} {calls:>6} {ms:9.3f} "
                      f"{ms / (p['device_s'] * 1e3):6.1%}")


# ---------------------------------------------------------------------------
# phase 13: the load harness on the card
# ---------------------------------------------------------------------------
# the traces' token ids lie in [1, HARNESS_VOCAB], inside every served
# vocab; their prompts and budgets fit phase 5's engine (512 positions,
# 16 new tokens at most)
HARNESS_VOCAB = 1000
HARNESS_SLO = harness.SLO(ttft_steps=64)


def harness_traces() -> dict:
    """Phase 13's traces: 24 requests in bursts of 8 every 8 steps, 24
    Poisson arrivals at 0.5 a step, 16 system-prompt requests over two
    320-token prefixes, 16 fleet requests over two members."""
    common = dict(max_len=ENGINE["max_len"], max_new=MAX_NEW,
                  vocab=HARNESS_VOCAB, seed=13)
    return {
        "bursty": harness.bursty_trace(24, burst_size=8, gap_steps=8,
                                       **common),
        "poisson": harness.poisson_trace(24, rate=0.5, **common),
        "shared-prefix": harness.shared_prefix_trace(
            16, n_families=2, prefix_len=SYSTEM_LEN, **common),
        "fleet": harness.fleet_trace(16, n_models=2, burst_size=8,
                                     gap_steps=8, **common)}


def rid_json(res) -> str:
    """``deterministic_json()`` with the per-request view keyed by trace
    rid: two replays on one engine assign other uids to the same
    requests."""
    d = res.metrics.deterministic()
    d["per_request"] = res.rid_metrics
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def harness_replay(label: str, eng, trace) -> dict:
    """Replay ``trace`` on ``eng`` (``harness.replay``, one fused step per
    host sync) and gate its lifecycle: every request finishes, and each
    uid has exactly one submit, first_token and finish with admits -
    preempts = 1.  Prints the metrics in steps and in wall milliseconds.
    Returns the replay, its seconds and the captures it made."""
    captures = eng.stats["graph_captures"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = harness.replay(eng, trace, slo=HARNESS_SLO)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = res.metrics
    if m.n_finished != len(trace) or len(res.finished) != len(trace):
        raise AssertionError(f"harness {label}: {m.n_finished}/{len(trace)} "
                             "requests finished")
    kinds = collections.defaultdict(collections.Counter)
    for e in res.events:
        kinds[e.uid][e.kind] += 1
    for uid, c in kinds.items():
        if (c["submit"], c["first_token"], c["finish"]) != (1, 1, 1) \
                or c["admit"] - c["preempt"] != 1:
            raise AssertionError(f"harness {label}: uid {uid}'s lifecycle "
                                 f"{dict(c)}")

    def ms(x):
        return "n/a" if x is None else f"{x * 1e3:.2f}"
    print(f"harness {label}: {len(trace)} requests, {m.total_new_tokens} "
          f"tokens over {m.steps} fused steps in {dt:.3f} s "
          f"({m.tokens_per_s:.1f} tok/s); TTFT p50/p99 {m.ttft_steps_p50}/"
          f"{m.ttft_steps_p99} steps ({ms(m.ttft_s_p50)}/{ms(m.ttft_s_p99)} "
          f"ms); ITL p50/p99 {m.itl_steps_p50}/{m.itl_steps_p99} steps "
          f"({ms(m.itl_s_p50)}/{ms(m.itl_s_p99)} ms); goodput "
          f"{m.goodput_req_s:.2f} req/s ({m.n_slo_met}/{m.n_requests} within "
          f"TTFT <= {HARNESS_SLO.ttft_steps} steps); peak concurrency "
          f"{m.peak_concurrency}; {m.n_preemptions} preemptions; "
          f"{m.prefix_hits} prefix hits; "
          f"{eng.stats['graph_captures'] - captures} captures")
    return dict(res=res, dt=dt,
                captures=eng.stats["graph_captures"] - captures,
                programs=sum(n > 0 for n in eng._programs.values()))


def check_harness(params) -> None:
    """Phase 13 on phase 5's full-width qwen1.5-0.5b: ``bursty`` on a fresh
    graphed float engine (it captures each program once), then again on
    the same warm engine (no capture; the rid-keyed deterministic view
    equals the first replay's) and on a fresh eager engine
    (``deterministic_json()`` equal to the graphed one's); ``poisson`` on
    a fresh fully quantized graphed engine.  The prefix and fleet replays
    run inside phases 8 and 6 on their engines."""
    t_start = time.perf_counter()
    traces = harness_traces()
    print(f"\n== load harness: full-width qwen1.5-0.5b (phase 5's engine "
          f"spec), SLO TTFT <= {HARNESS_SLO.ttft_steps} steps; bursty "
          f"{len(traces['bursty'])} requests (bursts of 8 every 8 steps, "
          f"prompts up to {traces['bursty'].max_prompt_len}), poisson "
          f"{len(traces['poisson'])} (0.5 a step)")
    runs = {}
    for mode in ("graphed", "eager"):
        eng = ServingEngine(full_width_spec(True), device="cuda",
                            graphs=mode == "graphed")
        eng.load(params)
        runs[mode] = harness_replay(f"bursty, float weights, {mode}", eng,
                                    traces["bursty"])
        if mode == "graphed":
            runs["warm"] = harness_replay(
                "bursty, float weights, graphed, warm engine", eng,
                traces["bursty"])
        del eng
        torch.cuda.empty_cache()
    first, warm, eager = runs["graphed"], runs["warm"], runs["eager"]
    if not 1 <= first["captures"] == first["programs"] or warm["captures"]:
        raise AssertionError(f"harness: captures first {first['captures']} "
                             f"for {first['programs']} programs run, warm "
                             f"{warm['captures']} (want one per program, "
                             "then none)")
    if eager["res"].metrics.deterministic_json() \
            != first["res"].metrics.deterministic_json():
        raise AssertionError("harness: the eager replay's deterministic "
                             "view differs from the graphed one's")
    if rid_json(warm["res"]) != rid_json(first["res"]):
        raise AssertionError("harness: the warm replay's deterministic view "
                             "differs from the first replay's")
    print("harness bursty: deterministic_json() graphed = eager; the warm "
          "replay's rid-keyed view = the first's; no capture when warm")
    eng = ServingEngine(full_width_spec(True, quant=True), device="cuda",
                        graphs=True)
    eng.load(params)
    harness_replay("poisson, int8 weights + int8 pool, graphed", eng,
                   traces["poisson"])
    del eng
    torch.cuda.empty_cache()
    print(f"phase 13 on phase 5's engines took "
          f"{time.perf_counter() - t_start:.1f} s")



# ---------------------------------------------------------------------------
# phase 6: the multi-topology fleet
# ---------------------------------------------------------------------------
FLEET = ("qwen1.5-0.5b", "adaptor-bert-shaped")


def fleet_spec(kv_dtype: str, compute: str = "bf16", quant: str = "none",
               spec: bool = False) -> RuntimeSpec:
    """The fleet's spec: qwen1.5-0.5b's engine at ``maxima_for`` both
    members (512 positions), the paged kernels, float weights or
    (``quant="int8"``) the fabric's int8 weight table; ``spec``:
    speculating with k = ``SPEC_K``, qwen1.5-0.5b drafting for both."""
    a, b = (get_config(n) for n in FLEET)
    return RuntimeSpec(
        arch=a, maxima=maxima_for(a, b, seq_max=ENGINE["max_len"]),
        execution=ExecutionSpec(paged_attn_impl="pallas",
                                compute_dtype=compute, quant=quant),
        memory=MemorySpec(cache_layout="paged",
                          max_batch=ENGINE["max_batch"],
                          max_len=ENGINE["max_len"],
                          block_size=ENGINE["block_size"],
                          kv_dtype=kv_dtype),
        scheduler=SchedulerSpec(chunk_size=ENGINE["chunk"]),
        speculation=SpeculationSpec(draft_model=a, k=SPEC_K) if spec
        else None)


def fleet_drain(members, prompts, kv_dtype: str, graphs: bool = True,
                quant: str = "none", spec: bool = False, warm: bool = False,
                trace=None, **kw) -> dict:
    """One fleet engine (both members added; ``spec``: member 0's weights
    as the draft too) drains the prompts, request i on member i % 2; every
    request must finish inside its member's vocab; ``warm`` drains them
    again on the same engine into ``out["warm"]``.  Adds the table's
    bytes, the peak device memory above what was allocated before the
    engine, the ``live_kv`` launches and the launches each capture
    recorded (``programs``) to ``drain``'s result; ``trace``: phase 13
    replays it on the engine after the drains (``out["harness"]``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(fleet_spec(kv_dtype, quant=quant, spec=spec),
                        max_models=len(members), device="cuda",
                        graphs=graphs)
    ids = [eng.add_model(p, c) for c, p in members]
    if spec:
        eng.load_draft(members[0][1])
    table_gb = DecodeFabric.table_bytes(eng.table) / 1e9
    models = [ids[i % len(ids)] for i in range(len(prompts))]
    out = drain(eng, prompts, models, **kw)
    for i, stream in out["streams"].items():
        vocab = members[models[i]][0].vocab_size
        if not all(0 <= t < vocab for t in stream):
            raise AssertionError(f"fleet request {i}: a token outside "
                                 f"member {models[i]}'s vocab {vocab}")
    out.update(table_gb=table_gb,
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
               live_kv=sum(out["launches"][f"{n}.live_kv"] for n in LIVE_KV),
               programs={k: sg.launches for k, sg in eng._graphs.items()})
    if warm:
        out["warm"] = drain(eng, prompts, models)
    if trace is not None:
        out["harness"] = harness_replay(
            f"fleet, {quant} table, {kv_dtype} pool, graphed (phase 6's "
            "engine)", eng, trace)
    del eng
    torch.cuda.empty_cache()
    return out


def check_fleet_logits(members, dev, g, quant: str = "none") -> None:
    """One mixed step then one decode step of the full-width fabric at
    float32 compute (``quant``: its weight table), kernel path against
    gather path from the same empty float32 pool (slots alternate the
    members; chunks of 16 lanes, some partial): live lanes within 2e-2 *
    max|logits| over each slot's live vocab, the dead vocab lanes NEG_INF
    on both."""
    spec = fleet_spec("compute", "fp32")
    fab = DecodeFabric(spec.maxima, len(members), spec.arch,
                       compute_dtype=torch.float32, quant=quant, device=dev)
    table = fab.init_table()
    for m, (c, p) in enumerate(members):
        fab.insert_model(table, fab.pack_member(c, p), m)
    paging = spec.memory.paging()
    B, W = ENGINE["max_batch"], ENGINE["chunk"]
    nblk = ENGINE["max_len"] // ENGINE["block_size"]
    tables = (torch.randperm(paging.num_blocks, generator=g, device=dev)
              .reshape(B, nblk) + 1).to(torch.int32)
    topo = torch.tensor([fab.topo_row(members[b % 2][0], b % 2)
                         for b in range(B)], dtype=torch.int32, device=dev)
    vocab = topo[:, REG_VOCAB]
    toks = (torch.randint(0, 1 << 30, (B, W), generator=g, device=dev)
            % vocab[:, None]).to(torch.int32)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    n_live = torch.tensor([16, 16, 16, 16, 16, 9, 3, 1], dtype=torch.int32,
                          device=dev)
    out = {}
    for impl in ("pallas", "gather"):
        cache = fab.init_cache(paging)
        mixed = fab.mixed_step(table, cache, toks, start, n_live, topo,
                               tables, impl)
        dec = fab.decode_step(table, cache, toks[:, :1], n_live, topo,
                              tables, impl)
        out[impl] = (mixed, dec)
        del cache
    lanes = torch.arange(W, device=dev)[None, :] < n_live[:, None]
    vlive = torch.arange(spec.maxima.vocab, device=dev)[None, :] \
        < vocab[:, None]
    for i, step in enumerate(("mixed_step", "decode_step")):
        k, r = out["pallas"][i], out["gather"][i]
        live = (lanes if i == 0 else lanes[:, :1])[..., None] \
            & vlive[:, None, :]
        vdead = ~vlive[:, None, :].expand_as(k)
        if not ((k[vdead] == masking.NEG_INF).all()
                and (r[vdead] == masking.NEG_INF).all()):
            raise AssertionError(f"fleet {step}: a dead vocab lane is not "
                                 "NEG_INF")
        ref = r[live.expand_as(r)]
        err = max_err(k[live.expand_as(k)], ref)
        tol = LOGIT_TOL * float(ref.abs().max())
        print(f"fleet {step}, f32 compute, {quant} weights, kernels vs "
              f"gather: max |diff| {err:.4g} (tol {LOGIT_TOL} x max|logits| "
              f"= {tol:.4g})")
        if err > tol:
            raise AssertionError(f"fleet {step} logits disagree: {err} > "
                                 f"{tol}")
    del table, fab


def check_fleet(dev, g, lengths) -> dict:
    """The full-width fleet: qwen1.5-0.5b and adaptor-bert-shaped (random
    weights from the generator) drain the phase 5 request mix, request i
    on member i % 2, with float weights and with the fabric's int8 weight
    table (ROADMAP Queue 1 item 8b), each over a bf16 pool on two graphed
    engines (the first at sync_every=4 with every fused step under
    ``set_sync_debug_mode("error")``) and an eager one, and over an int8
    pool on two graphed engines (and an eager one under the int8 table):
    the streams repeat, the graphed streams equal the eager ones with one
    capture per program and the same launches, and every fleet step
    launches one attention kernel per layer with ``live_kv``, 24 a step;
    the int8 table takes under 0.3 of the float table's bytes.  Then the
    kernel-path logits against the gather path's at f32 compute for both
    tables, the fleet's prefix drain and phase 10 (a fleet that
    speculates).  Returns the launches of the first bf16-pool drain of
    each table ("fleet", "fleet_int8") and phase 10's ("fleet_spec")."""
    members = [(c, Model(c, device=dev).init(g).state_dict())
               for c in (get_config(n) for n in FLEET)]
    maxima = fleet_spec("compute").maxima
    print(f"\n== fleet: {' + '.join(FLEET)} in one engine, maxima heads "
          f"{maxima.heads_max} layers {maxima.layers_enc_max} d_model "
          f"{maxima.d_model_max} d_ff {maxima.d_ff_max} vocab "
          f"{maxima.vocab}; {len(lengths)} greedy requests x {MAX_NEW} new "
          "tokens, alternating members")
    rs = np.random.default_rng(1)
    prompts = [rs.integers(0, members[i % 2][0].vocab_size, n).tolist()
               for i, n in enumerate(lengths)]
    n_tok = len(prompts) * MAX_NEW
    out, table_gb = {}, {}
    for quant, kv_dtype in (("none", "compute"), ("none", "int8"),
                            ("int8", "compute"), ("int8", "int8")):
        bf16 = kv_dtype == "compute"
        # phase 13: the fleet trace on the float table's second engine
        runs = [fleet_drain(members, prompts, kv_dtype, quant=quant,
                            trace=harness_traces()["fleet"]
                            if bf16 and quant == "none" and i == 1 else None,
                            **(dict(sync_every=4, no_sync=True)
                               if bf16 and i == 0 else {}))
                for i in range(2)]
        if bf16 or quant == "int8":
            runs.append(fleet_drain(members, prompts, kv_dtype, quant=quant,
                                    graphs=False))
        pool = "bf16" if bf16 else "int8"
        label = f"fleet, {'float' if quant == 'none' else 'int8'} table, " \
            f"{pool} pool"
        for i, r in enumerate(runs):
            want = maxima.layers_enc_max * r["steps"]
            mode = "eager" if i == 2 else "graphed"
            print(drain_line(f"{label}, engine {i + 1} ({mode})", r, n_tok)
                  + f"; live_kv launches {r['live_kv']} "
                  f"({maxima.layers_enc_max} x steps = {want}), decode "
                  f"{r['launches']['paged_decode_attention']} + chunk "
                  f"{r['launches']['chunked_prefill_attention']}; table "
                  f"{r['table_gb']:.3f} GB, peak {r['peak_gb']:.3f} GB "
                  "allocated above the members' weights"
                  + (" (sync_every=4, every step under "
                     "set_sync_debug_mode('error'): no host sync)"
                     if bf16 and i == 0 else ""))
            if r["live_kv"] != want:
                raise AssertionError(f"fleet live_kv launches {r['live_kv']}"
                                     f" != {want}: one per layer and step")
        same = sum(a == b for k in runs[0]["streams"]
                   for a, b in zip(runs[0]["streams"][k],
                                   runs[1]["streams"][k]))
        print(f"{label}: identical tokens on the two graphed engines "
              f"{same}/{n_tok}")
        if runs[0]["streams"] != runs[1]["streams"]:
            raise AssertionError(f"{label}: the streams differ between two "
                                 "fresh engines")
        if len(runs) == 3:
            check_graphed(label, {"graphed": runs[1], "eager": runs[2]},
                          PATH_KERNELS["fleet"], maxima.layers_enc_max,
                          n_tok)
        table_gb[quant] = runs[0]["table_gb"]
        key = "fleet" if quant == "none" else "fleet_int8"
        out.setdefault(key, runs[0]["launches"])
    ratio = table_gb["int8"] / table_gb["none"]
    print(f"fleet weight table: int8 {table_gb['int8']:.3f} GB against "
          f"float {table_gb['none']:.3f} GB ({ratio:.3f}: int8 values and "
          "float32 scales beside float biases and norms)")
    if ratio >= 0.3:
        raise AssertionError(f"the fleet's int8 table holds {ratio:.3f} of "
                             "the float table's bytes")
    for quant in ("none", "int8"):
        check_fleet_logits(members, dev, g, quant)
    check_prefix_fleet(members)
    out["fleet_spec"] = check_fleet_speculation(members, prompts, maxima)
    del members
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: a fleet that speculates
# ---------------------------------------------------------------------------
def check_fleet_speculation(members, prompts, maxima) -> dict:
    """The phase 6 fleet and request mix with k = ``SPEC_K`` and
    qwen1.5-0.5b's own weights drafting for both members, over a bf16
    pool, graphed (a first and a warm drain) and eager, and graphed once
    with the int8 weight table; the same fleet without speculation for
    tokens/s.  Gates: graphed = eager (streams, launches), one capture per
    program, no eager step; the decode program's capture launches the
    chunk walk 24 times, each with ``live_kv`` (the verify at W = k + 1),
    and the decode walk never; no drain launches the decode walk, every
    eager walk has ``live_kv``; draft tokens accepted.  Returns the
    graphed bf16 drain's launches."""
    L = maxima.layers_enc_max
    n_tok = len(prompts) * MAX_NEW
    t0 = time.perf_counter()
    print(f"\n== fleet speculation: {' + '.join(FLEET)}, k = {SPEC_K}, "
          f"{FLEET[0]} drafting for both members, the phase 6 mix, kernels")
    off = fleet_drain(members, prompts, "compute", warm=True)
    on = fleet_drain(members, prompts, "compute", spec=True, warm=True)
    on_e = fleet_drain(members, prompts, "compute", spec=True, graphs=False)
    q_on = fleet_drain(members, prompts, "compute", spec=True,
                       quant="int8")
    for label, r in (("speculation off", off), ("speculating", on)):
        for mode, d in (("first drain", r), ("warm engine", r["warm"])):
            print(drain_line(f"fleet, bf16 pool, {label}, graphed, {mode}",
                             d, n_tok))
        if r["warm"]["streams"] != r["streams"] \
                or r["warm"]["stats"]["graph_captures"]:
            raise AssertionError(f"fleet, {label}: the warm drain captured "
                                 "again or streamed otherwise")
    check_graphed("fleet speculation, bf16 pool",
                  {"graphed": on, "eager": on_e},
                  ("chunked_prefill_attention",), L, n_tok)
    for label, r in (("float table", on), ("int8 table", q_on)):
        print("  " + spec_rates(f"fleet speculation, {label}", r, n_tok))
        dec = r["programs"].get("decode", {})
        walks = (dec.get("chunked_prefill_attention", 0),
                 dec.get("chunked_prefill_attention.live_kv", 0),
                 dec.get("paged_decode_attention", 0))
        print(f"  fleet speculation, {label}: the decode program's capture "
              f"launches {walks[0]} chunk walks, {walks[1]} with live_kv, "
              f"{walks[2]} decode walks")
        if walks != (L, L, 0) or r["launches"]["paged_decode_attention"]:
            raise AssertionError(f"fleet speculation, {label}: decode "
                                 f"program walks {walks}, drain "
                                 f"{r['launches']}; want {L} chunk walks "
                                 "with live_kv and no decode walk")
        # the draft is member 0: its slots accept, member 1's rarely (its
        # slots bound the fused steps, so fewer steps are not gated)
        st = r["stats"]
        if st["spec_accepted"] <= 0 or st["spec_steps"] <= 0:
            raise AssertionError(f"fleet speculation, {label}: "
                                 f"{st['spec_accepted']} accepted over "
                                 f"{st['spec_steps']} speculating "
                                 "slot-steps")
    if on_e["live_kv"] != L * on_e["steps"]:
        raise AssertionError(f"fleet speculation, eager: {on_e['live_kv']} "
                             f"live_kv walks in {on_e['steps']} steps")
    same, n = same_tokens(q_on["streams"], on["streams"])
    print(f"fleet speculation: warm tok/s {n_tok / on['warm']['dt']:.1f} "
          f"against {n_tok / off['warm']['dt']:.1f} without speculation "
          f"({on['warm']['steps']} against {off['warm']['steps']} fused "
          f"steps); the int8 table's identical tokens to the float table's "
          f"{same}/{n} (reported); phase 10 took "
          f"{time.perf_counter() - t0:.1f} s")
    return on["launches"]


# ---------------------------------------------------------------------------
# phase 7: the rest of the dense family (untied lm_head)
# ---------------------------------------------------------------------------
# (config, depth it runs at): phi3-mini at 8 of its 32 layers (the
# untied lm_head and the hd 96 walk need no more; the cut keeps the run
# near its time once phases 6 and 10 grew); qwen2-72b at full width and 2
# of its 80 layers (one card: ~1.76 G parameters of layers, ~7 GB at f32
# compute, beside two f32 [152064, 8192] tables of 5 GB each).
# codeqwen1.5-7b runs only in the CPU tests.
DENSE_FAMILY = (("phi3-mini-3.8b", 8), ("qwen2-72b", 2))


def check_dense_family(dev, g, lengths) -> dict:
    """Each untied config at full width with random weights from the
    generator: one mixed and one decode step at f32 compute, the kernels
    against their plain versions within phase 4's gate (with the untied
    ``lm_head``'s share of the distance); then the phase 5 request mix
    drained by a graphed and an eager bf16 engine through the kernels:
    streams equal, one capture per program, launches equal, ``rmsnorm``
    2L+1 a step.  Prints the launches of the paged walks at the config's
    head shape (phi3-mini: 32 heads of 96; qwen2-72b: 64 of 128 over 8
    kv heads).  Returns {config: the graphed drain's launches}."""
    out = {}
    for name, depth in DENSE_FAMILY:
        cfg = get_config(name)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        hd, rep = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
        params = Model(cfg, device=dev).init(g).state_dict()
        n_params = sum(t.numel() for t in params.values())
        print(f"\n== dense family: {name} at full width, {cfg.num_layers} "
              f"of {get_config(name).num_layers} layers, {n_params / 1e9:.3f}"
              f" G parameters, {cfg.num_heads} heads of {hd} over "
              f"{cfg.num_kv_heads} kv heads (GQA {rep}), untied lm_head")
        zero_counts()
        model32 = Model(cfg, compute_dtype=torch.float32, device=dev)
        model32.load_state_dict(params)
        check_model_steps(model32, dev, g, gate=True,
                          paths=("kernels", "plain versions",
                                 "plain, perturbed"))
        steps_walks = {n: KERNELS[n].launches for n in (
            "paged_decode_attention", "chunked_prefill_attention")}
        del model32
        torch.cuda.empty_cache()
        rs = np.random.default_rng(2)
        prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
                   for n in lengths]
        n_tok = len(prompts) * MAX_NEW
        runs = {mode: serve(params, prompts, graphs=mode == "graphed",
                            arch=cfg) for mode in ("graphed", "eager")}
        check_graphed(name, runs, PATH_KERNELS["float"], cfg.num_layers,
                      n_tok)
        walks = {n: steps_walks[n] + runs["graphed"]["launches"][n]
                 for n in steps_walks}
        print(f"{name}: the paged walks at {cfg.num_heads} heads of {hd} "
              f"(GQA {rep}) launched decode {walks['paged_decode_attention']}"
              f", chunk {walks['chunked_prefill_attention']} times (the f32 "
              f"steps and the graphed drain)")
        out[name] = runs["graphed"]["launches"]
        del params, runs
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: the prefix cache with copy-on-write
# ---------------------------------------------------------------------------
SYSTEM_LEN = 320                      # the shared system prompt, 20 blocks
FORK_AT = 312                         # the fork request's divergence
SUFFIXES = (16, 29, 40, 55, 64, 80)   # the six full-block hits' suffixes


def prefix_traffic(vocab: int, seed: int = 8) -> tuple[list, list]:
    """The warm request (S + 8 tokens) and the wave of 8: six S + a
    distinct suffix, one S[:312] + a 40-token tail diverging at 312 (a
    19-block hit and a fork of block 20's first 8 tokens), one unrelated
    200-token prompt (a miss: its first token differs from S's)."""
    rs = np.random.default_rng(seed)
    system = rs.integers(0, vocab, SYSTEM_LEN).tolist()
    warm = system + rs.integers(0, vocab, 8).tolist()
    wave = [system + rs.integers(0, vocab, n).tolist() for n in SUFFIXES]
    tail = rs.integers(0, vocab, 40).tolist()
    tail[0] = (system[FORK_AT] + 1 + tail[0] % (vocab - 1)) % vocab
    wave.append(system[:FORK_AT] + tail)
    miss = rs.integers(0, vocab, 200).tolist()
    miss[0] = (system[0] + 1 + miss[0] % (vocab - 1)) % vocab
    wave.append(miss)
    return warm, wave


def prefix_spec(prefix: bool, kv_dtype: str = "compute",
                compute: str = "bf16", quant: bool = False,
                num_blocks: int | None = None) -> RuntimeSpec:
    """Phase 5's full-width kernel-path spec with the prefix cache on or
    off, over a ``kv_dtype`` pool at ``compute`` (``quant``: int8 weights
    and pool)."""
    spec = full_width_spec(True, quant)
    return dataclasses.replace(
        spec, execution=dataclasses.replace(spec.execution,
                                            compute_dtype=compute),
        memory=dataclasses.replace(spec.memory, prefix_cache=prefix,
                                   num_blocks=num_blocks,
                                   kv_dtype="int8" if quant else kv_dtype))


def prefix_drain(spec, params, traffic, graphs: bool = True,
                 sync_every: int = 1, no_sync: bool = False,
                 f32_pool: bool = False, trace=None) -> dict:
    """A fresh engine drains the warm request (4 new tokens), then the wave
    (16 new tokens each).  The kernel counts are zeroed before the warm
    request.  ``f32_pool``: the pool in float32 (installed before any
    step).  ``no_sync``: every fused step (the captures included) and
    every fork under ``set_sync_debug_mode("error")`` (the rest of
    admission writes each slot field from a host scalar, a blocking copy
    that this gate leaves out, as phase 5's does); otherwise each fork is
    checked right after it lands: the destination's first 8 rows equal
    the source's bit for bit in every layer, K, V and any scales.
    Returns ``drain``'s keys (streams and seconds of the wave; steps,
    stats and launches of both drains), the wave's steps, the admissions'
    cached tokens, each wave request's TTFT (its ``admit`` to its
    ``first_token`` event, host clock) and the forks; ``trace``: phase 13
    replays it on the engine after the wave (``out["harness"]``)."""
    warm, wave = traffic
    eng = ServingEngine(spec, device="cuda", graphs=graphs)
    eng.load(params)
    if f32_pool:
        eng.cache = attn_mod.KVCache(
            *(torch.zeros_like(t, dtype=torch.float32)
              for t in (eng.cache.k, eng.cache.v)))
    log, forks = [], []
    eng.events.subscribe(log.append)

    def fork(cache, src, dst):
        fork_block(cache, src, dst)
        forks.append(all(torch.equal(t[:, dst, :8], t[:, src, :8])
                         for t in (cache.k, cache.v, cache.k_scale,
                                   cache.v_scale) if t is not None))

    def checked(fn):
        def run(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    patches = [mock.patch.object(eng, "_dispatch", checked(eng._dispatch)),
               mock.patch.object(engine_mod, "fork_block",
                                 checked(fork_block))] \
        if no_sync else [mock.patch.object(engine_mod, "fork_block", fork)]
    zero_counts()
    tallies = (collections.Counter(eng.captured_launches),
               collections.Counter(eng.replayed_launches))
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        uid = eng.submit(warm, max_new_tokens=4)
        done = eng.run_to_completion(sync_every=sync_every)
        warm_stream = {r.uid: r.generated for r in done}[uid]
        steps0 = eng.stats["decode_steps"]
        uids = {eng.submit(p, max_new_tokens=MAX_NEW): i
                for i, p in enumerate(wave)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_to_completion(sync_every=sync_every)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if len(done) != len(wave) or len(warm_stream) != 4:
        raise AssertionError(f"{len(done)}/{len(wave)} wave requests "
                             "finished")
    streams = {uids[r.uid]: r.generated for r in done}
    if any(len(x) != MAX_NEW for x in streams.values()):
        raise AssertionError("a wave request stopped short of max_new")
    if no_sync and sum(st.waits for st in eng._stages.values()):
        raise AssertionError("an upload waited for a staging buffer")
    times = collections.defaultdict(dict)
    for e in log:
        times[e.uid][e.kind] = e
    ttft = {uids[u]: times[u]["first_token"].t - times[u]["admit"].t
            for u in uids}
    out = dict(streams=streams, warm=warm_stream, dt=dt,
               steps=eng.stats["decode_steps"],
               wave_steps=eng.stats["decode_steps"] - steps0,
               stats=dict(eng.stats),
               compilations=dict(eng.compilations),
               launches=made_launches(eng, *tallies), ttft=ttft, forks=forks,
               cached=[e.data["cached_tokens"] for e in log
                       if e.kind == "admit"], memory=eng.memory_stats())
    if trace is not None:
        out["harness"] = harness_replay(
            "shared-prefix, float weights, cache on, graphed (phase 8's "
            "engine)", eng, trace)
    del eng
    torch.cuda.empty_cache()
    return out


def same_tokens(a: dict, b: dict) -> tuple[int, int]:
    """(identical tokens, tokens) of two drains' wave streams."""
    n = sum(len(x) for x in a.values())
    return sum(x == y for i in a for x, y in zip(a[i], b[i])), n


def first_tokens_equal(label: str, on: dict, off: dict) -> None:
    firsts = [(on["streams"][i][0], off["streams"][i][0])
              for i in sorted(on["streams"])]
    same, n = same_tokens(on["streams"], off["streams"])
    print(f"{label}: first tokens cache on = off "
          f"{sum(a == b for a, b in firsts)}/{len(firsts)}; identical "
          f"tokens {same}/{n}")
    if any(a != b for a, b in firsts):
        raise AssertionError(f"{label}: a first token differs with the "
                             f"prefix cache on and off: {firsts}")


def logit_gap(model32: Model, seq: list[int], a: int, b: int) -> float:
    """|logit a - logit b| after ``seq``, at float32 compute over a
    float32 pool, the whole sequence one chunk of the plain path."""
    dev = model32.device
    paging = full_width_spec(True).memory.paging()
    cache = model32.init_cache(paging)
    cache = attn_mod.KVCache(cache.k.float(), cache.v.float())
    nblk = ENGINE["max_len"] // ENGINE["block_size"]
    tables = torch.arange(1, nblk + 1, dtype=torch.int32,
                          device=dev)[None]
    toks = torch.tensor([seq], dtype=torch.int32, device=dev)
    model32.matmul_backend, model32.paged_attn_impl = "xla", "gather"
    try:
        logits = model32.mixed_step(
            cache, toks, torch.zeros(1, dtype=torch.int32, device=dev),
            torch.tensor([len(seq)], dtype=torch.int32, device=dev), tables)
    finally:
        model32.matmul_backend, model32.paged_attn_impl = "pallas", "pallas"
    row = logits[0, len(seq) - 1]
    return float((row[a] - row[b]).abs())


def f32_streams_equal(params, traffic, on: dict, off: dict,
                      f32_dist: float, what: str = "cache",
                      arch: ArchConfig | None = None) -> None:
    """Whole f32 streams, ``what`` (the prefix cache, speculation) on
    against off: equal, or where a request diverges, the two tokens'
    logits at that step (recomputed in float32) lie within phase 4's f32
    distance of each other (a near-tie that a decode step and a mixed
    step, whose K-split plans differ, may break either way); the request
    is not compared past that step."""
    wave = traffic[1]
    same, n = same_tokens(on["streams"], off["streams"])
    print(f"f32 compute, f32 pool: identical tokens {what} on vs off "
          f"{same}/{n}")
    model32 = None
    for i in sorted(on["streams"]):
        a, b = on["streams"][i], off["streams"][i]
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        if model32 is None:
            model32 = Model(arch or get_config("qwen1.5-0.5b"),
                            compute_dtype=torch.float32, device="cuda")
            model32.load_state_dict(params)
        gap = logit_gap(model32, wave[i] + a[:t], a[t], b[t])
        print(f"  request {i} diverges at token {t}: {a[t]} vs {b[t]}, "
              f"their f32 logits {gap:.4g} apart (phase 4's f32 distance "
              f"{f32_dist:.4g})")
        if gap > f32_dist:
            raise AssertionError(f"f32 request {i} diverges at token {t} "
                                 f"with {what} on and off, and it is no "
                                 f"near-tie ({gap} > {f32_dist})")
    del model32
    torch.cuda.empty_cache()


def check_prefix(dev, g, f32_dist: float) -> dict:
    """Phase 8: full-width qwen1.5-0.5b (random weights), float weights,
    the kernel path, graphed, 16-token blocks, chunk 16, 8 slots, 512
    positions and a pool that preempts nobody; the warm request, then the
    wave (``prefix_traffic``), with the prefix cache on and off.  Gates:
    the stats (7 hits, 1 fork, 2232 cached tokens, prefill tokens 2232
    under the cache-off drain's), the fork bit for bit, first tokens on =
    off over a bf16 and an int8 pool, whole f32 streams on = off up to
    printed near-ties, graphed = eager (streams, one capture per program,
    launches), no host sync at sync_every=4 in a fused step (the
    captures included) or a fork, and evictions on a pool too small for the chain with first
    tokens equal to the cache-off drain's on that pool.  The fully
    quantized drain's share of identical tokens is printed.  Returns the
    graphed cache-on drain's launches."""
    params = Model(get_config("qwen1.5-0.5b"), device=dev).init(g) \
        .state_dict()
    traffic = prefix_traffic(get_config("qwen1.5-0.5b").vocab_size)
    hits = len(SUFFIXES) + 1
    cached = len(SUFFIXES) * SYSTEM_LEN + FORK_AT
    print(f"\n== prefix cache: full-width qwen1.5-0.5b, a {SYSTEM_LEN}-token "
          f"system prompt; the warm request, then {len(traffic[1])} "
          f"requests x {MAX_NEW} new tokens ({len(SUFFIXES)} full-block "
          f"hits, one fork at {FORK_AT}, one miss)")
    # phase 13: the shared-prefix trace on the graphed cache-on engine
    runs = {mode: prefix_drain(prefix_spec(mode != "off"), params, traffic,
                               graphs=mode != "eager",
                               trace=harness_traces()["shared-prefix"]
                               if mode == "on" else None)
            for mode in ("on", "off", "eager")}
    on, off = runs["on"], runs["off"]
    if on["harness"]["res"].metrics.prefix_hits <= 0:
        raise AssertionError("harness shared-prefix: no prefix hit")
    st = {k: on["stats"][k] for k in ("prefix_hits", "prefix_hit_tokens",
                                      "cow_forks", "prefix_evictions",
                                      "preemptions")}
    saved = off["stats"]["prefill_tokens"] - on["stats"]["prefill_tokens"]
    print(f"stats, cache on: {st}; admissions' cached tokens "
          f"{on['cached']}; prefill tokens on {on['stats']['prefill_tokens']}"
          f", off {off['stats']['prefill_tokens']} ({saved} fewer); pool "
          f"{on['memory']}")
    if (st["prefix_hits"], st["cow_forks"], st["prefix_hit_tokens"],
            saved, st["preemptions"], off["stats"]["preemptions"]) \
            != (hits, 1, cached, cached, 0, 0):
        raise AssertionError(f"prefix stats {st}, {saved} prefill tokens "
                             f"saved; want {hits} hits, 1 fork, {cached} "
                             "cached tokens saved, no preemption")
    print(f"the fork: destination rows 0-7 = the source's in every layer "
          f"(K, V): {on['forks']}")
    if on["forks"] != [True]:
        raise AssertionError(f"the copy-on-write fork: {on['forks']}")
    first_tokens_equal("float weights, bf16 pool", on, off)
    n_tok = len(traffic[1]) * MAX_NEW
    for mode in ("on", "off"):
        r = runs[mode]
        hit = [r["ttft"][i] * 1e3 for i in range(hits)]
        print(f"cache {mode}: wave {n_tok} tokens in {r['dt']:.3f} s "
              f"({n_tok / r['dt']:.1f} tok/s), {r['wave_steps']} fused "
              f"steps; "
              f"TTFT of the {hits} hit requests (admit -> first_token, "
              f"host clock) mean {np.mean(hit):.1f} ms, max "
              f"{max(hit):.1f} ms")
    check_graphed("prefix cache, float weights",
                  {"graphed": on, "eager": runs["eager"]},
                  PATH_KERNELS["prefix"], get_config("qwen1.5-0.5b")
                  .num_layers, n_tok)
    quiet = prefix_drain(prefix_spec(True), params, traffic, sync_every=4,
                         no_sync=True)
    print(f"cache on, graphed, sync_every=4, every fused step (the "
          f"captures) and the fork under set_sync_debug_mode('error'): no "
          f"host sync, no staging wait; {quiet['wave_steps']} wave steps, "
          f"{quiet['stats']['graph_captures']} captures")
    if quiet["streams"] != on["streams"] \
            or quiet["stats"]["cow_forks"] != 1:
        raise AssertionError("the sync_every=4 cache-on drain differs from "
                             "the sync_every=1 one")
    int8 = {mode: prefix_drain(prefix_spec(mode == "on", "int8"), params,
                               traffic) for mode in ("on", "off")}
    print(f"int8 pool, the fork rows and scales: {int8['on']['forks']}")
    if int8["on"]["forks"] != [True]:
        raise AssertionError(f"int8 pool fork: {int8['on']['forks']}")
    first_tokens_equal("float weights, int8 pool", int8["on"], int8["off"])
    f32 = {mode: prefix_drain(prefix_spec(mode == "on", compute="fp32"),
                              params, traffic, f32_pool=True)
           for mode in ("on", "off")}
    first_tokens_equal("f32 compute, f32 pool", f32["on"], f32["off"])
    f32_streams_equal(params, traffic, f32["on"], f32["off"], f32_dist)
    # a pool of 40 blocks: after the warm request 20 are free and S's 20
    # parked, so a 400-token miss admitted first (25 blocks) must evict
    small = ENGINE["max_len"] // ENGINE["block_size"] + 8
    rs = np.random.default_rng(10)
    miss = rs.integers(0, get_config("qwen1.5-0.5b").vocab_size, 400) \
        .tolist()
    miss[0] = traffic[1][-1][0]            # not S's first token
    tight = [traffic[0], [miss] + traffic[1][:-1]]
    ev = {mode: prefix_drain(prefix_spec(mode == "on", num_blocks=small),
                             params, tight) for mode in ("on", "off")}
    print(f"a {small}-block pool, a 400-token miss first: cache on evicted "
          f"{ev['on']['stats']['prefix_evictions']} parked blocks, "
          f"{ev['on']['stats']['prefix_hits']} hits, preemptions on "
          f"{ev['on']['stats']['preemptions']} / off "
          f"{ev['off']['stats']['preemptions']}")
    if ev["on"]["stats"]["prefix_evictions"] <= 0:
        raise AssertionError("the small pool evicted no parked block")
    first_tokens_equal(f"{small}-block pool", ev["on"], ev["off"])
    quant = {mode: prefix_drain(prefix_spec(mode == "on", quant=True),
                                params, traffic) for mode in ("on", "off")}
    same, n = same_tokens(quant["on"]["streams"], quant["off"]["streams"])
    print(f"int8 weights + int8 pool: identical tokens cache on vs off "
          f"{same}/{n} (reported: one activation scale spans all rows); "
          f"stats {[quant['on']['stats'][k] for k in PREFIX_STATS]}")
    del params
    torch.cuda.empty_cache()
    return on["launches"]


def check_prefix_fleet(members) -> None:
    """Phase 8 on the fleet: one graphed fleet engine with the prefix
    cache serves one warm request per member with the same tokens (the
    second may not hit the first's chain: namespaces), then three requests
    of the shared prompt per member, each of which hits its own member's
    20 blocks."""
    spec = fleet_spec("compute")
    spec = dataclasses.replace(spec, memory=dataclasses.replace(
        spec.memory, prefix_cache=True))
    eng = ServingEngine(spec, max_models=len(members), device="cuda")
    for c, p in members:
        eng.add_model(p, c)
    log = []
    eng.events.subscribe(log.append)
    vocab = min(c.vocab_size for c, _ in members)
    warm, wave = prefix_traffic(vocab, seed=9)
    for m in range(len(members)):
        drain(eng, [warm], models=[m])
    wave = wave[:3] * len(members)
    models = [i // 3 for i in range(len(wave))]
    r = drain(eng, wave, models=models)
    cached = [e.data["cached_tokens"] for e in log if e.kind == "admit"]
    print(f"fleet with the prefix cache: admissions' cached tokens "
          f"{cached} (members {[0, 1] + models}); {eng.stats['prefix_hits']}"
          f" hits, {r['dt']:.3f} s for the wave")
    if cached != [0, 0] + [SYSTEM_LEN] * len(wave):
        raise AssertionError(f"fleet prefix hits {cached}: a hit across "
                             "members, or a miss within one")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: speculative decoding
# ---------------------------------------------------------------------------
# phase 9's target: qwen1.5-0.5b at 4 of its 24 layers (cut to 12 when
# phase 11 joined, to 8 when phase 12 did, to 6 when phase 17 did, to 5
# when phase 20 did and to 4 when phase 23 did: the run stays near its
# time; every gate a layer carries stays)
SPEC_TARGET_LAYERS = 4
SPEC_DRAFT_LAYERS = 3     # (b)'s draft: the target's first 3 layers


def spec_spec(draft: ArchConfig | None, quant: bool = False,
              compute: str = "bf16", prefix: bool = False,
              arch: ArchConfig | None = None) -> RuntimeSpec:
    """Phase 5's full-width kernel-path spec (of ``arch``, else
    qwen1.5-0.5b) at ``compute`` (``quant``: int8 weights and pool;
    ``prefix``: the prefix cache on), speculating with k = ``SPEC_K`` and
    ``draft`` as the proposer's architecture, or not at all (``draft``
    None)."""
    spec = full_width_spec(True, quant, arch)
    return dataclasses.replace(
        spec, execution=dataclasses.replace(spec.execution,
                                            compute_dtype=compute),
        memory=dataclasses.replace(spec.memory, prefix_cache=prefix),
        speculation=None if draft is None
        else SpeculationSpec(draft_model=draft, k=SPEC_K))


def timed_captures(eng) -> list:
    """Wrap ``eng._capture`` so that each capture's parts are timed on the
    host clock, the device synchronised around each: the warm-up (the
    step's own eager run), the capture with the graph's instantiation,
    and the graph's first replay.  Returns the list the (part, seconds)
    pairs land in."""
    parts, capture = [], eng._capture

    def synced(label, fn, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        parts.append((label, time.perf_counter() - t))
        return out

    def timed(kind, impl, inputs, *args):
        calls = []

        def first_timed(*a):      # the warm-up is impl's first call
            calls.append(1)
            if len(calls) == 1:
                return synced(f"{kind} warm-up", impl, *a)
            return impl(*a)
        sg, out = synced(f"{kind} warm-up + capture + instantiation",
                         capture, kind, first_timed, inputs, *args)
        replay = sg.graph.replay

        def first_replay():
            sg.graph.replay = replay           # later replays untimed
            synced(f"{kind} first replay", replay)
        sg.graph.replay = first_replay
        return sg, out
    eng._capture = timed
    return parts


def spec_drain(params, prompts, draft=None, graphs: bool = True,
               warm: bool = False, f32_pool: bool = False,
               profile: bool = False, sync_every: int = 1,
               no_sync: bool = False, time_capture: bool = False,
               **kw) -> dict:
    """A fresh engine of ``spec_spec(**kw)`` (``draft``: the proposer's
    (architecture, state dict), None for speculation off) drains
    ``prompts`` (phase 5's ``drain`` at ``sync_every``, ``no_sync``);
    ``warm`` drains them again on the
    same engine into ``out["warm"]`` (``profile``: and once more traced,
    into ``out["traced"]``).  ``f32_pool``: the target's pool in float32,
    installed before any step.  Also returns the width W of every call of
    the chunk kernel's wrapper in the first drain (``widths``; a graphed
    engine calls it only while it warms up and captures), the blocks
    truncation handed back, the per-program launches each capture
    recorded, and the pool's occupancy after the drain.  ``time_capture``:
    the first drain's captures timed in parts (``timed_captures``, into
    ``out["capture_parts"]``)."""
    eng = ServingEngine(spec_spec(draft and draft[0], **kw), device="cuda",
                        graphs=graphs)
    eng.load(params, draft=draft and draft[1])
    parts = timed_captures(eng) if time_capture else None
    if f32_pool:
        eng.cache = attn_mod.KVCache(
            *(torch.zeros_like(t, dtype=torch.float32)
              for t in (eng.cache.k, eng.cache.v)))
    widths, cut = collections.Counter(), collections.Counter()
    walk, truncate = attn_mod.chunked_prefill_attention, \
        eng.allocator.truncate

    def counting_walk(q, *a, **k):
        widths[q.shape[1]] += 1
        return walk(q, *a, **k)

    def counting_truncate(blocks, keep):
        kept, zeros = truncate(blocks, keep)
        cut["blocks"] += len(blocks) - len(kept)
        return kept, zeros
    eng.allocator.truncate = counting_truncate
    with mock.patch.object(attn_mod, "chunked_prefill_attention",
                           counting_walk):
        out = drain(eng, prompts, sync_every=sync_every, no_sync=no_sync)
    if parts is not None:
        out["capture_parts"] = list(parts)
        del eng._capture                       # the class's again
    if warm:
        out["warm"] = drain(eng, prompts)
    if profile:
        out["traced"] = drain(eng, prompts, measure="profile")
    mem = eng.memory_stats()
    out.update(widths=dict(widths), truncated=cut["blocks"],
               programs={k: sg.launches for k, sg in eng._graphs.items()},
               memory=mem, free=eng.allocator.num_free)
    del eng
    torch.cuda.empty_cache()
    return out


def spec_rates(label: str, r: dict, n_tok: int) -> str:
    """Steps, acceptance and tokens per step of one speculative drain."""
    st = r["stats"]
    acc, ss = st["spec_accepted"], st["spec_steps"]
    mean = acc / ss if ss else 0.0
    return (f"{label}: {r['steps']} fused steps, {ss} slot-steps "
            f"speculating, {acc} draft tokens accepted (mean accepted "
            f"length {mean:.3f}; {1 + mean:.3f} tokens per decoding slot "
            f"per step; {n_tok / r['steps']:.3f} tokens per fused step)")


def check_spec_launches(label: str, r: dict, layers: int, draft_layers: int,
                        mm: str, mm_per_layer: int = 7) -> None:
    """The launches of a speculative engine: the decode program (its
    capture) runs the chunk walk once per layer (the verify pass at W =
    k + 1) and no decode walk, and its matmul kernel and ``rmsnorm`` once
    per projection / norm of the target's pass and of the draft's k + 1
    passes (k proposals, the write-only pass); the mixed program adds the
    draft's prompt pass.  An eager drain calls the walk at W = k + 1 on
    each decode step and at W = chunk on each mixed step: 24 a step."""
    for kind, passes in (("decode", SPEC_K + 1), ("mixed", SPEC_K + 2)):
        got = r["programs"].get(kind)
        if got is None:
            continue
        want = {mm: mm_per_layer * (layers + passes * draft_layers),
                "rmsnorm": 2 * layers + 1 + passes * (2 * draft_layers + 1),
                "chunked_prefill_attention": layers}
        have = {n: got.get(n, 0) for n in (*want, "paged_decode_attention")}
        print(f"  {label}, the {kind} program's capture: {have}")
        if any(have[n] != c for n, c in want.items()) \
                or have["paged_decode_attention"]:
            raise AssertionError(f"{label}: the {kind} program launched "
                                 f"{have}, want {want} and no decode walk")
    if r["launches"]["paged_decode_attention"]:
        raise AssertionError(f"{label}: the decode walk ran in a "
                             "speculative drain")


def spec_walk_widths(label: str, r: dict, layers: int) -> int:
    """An eager speculative drain's chunk walks by width: 24 at W = k + 1
    per decode step and 24 at W = chunk per mixed step, the steps all
    accounted for.  Returns the decode steps."""
    w = r["widths"]
    dec, mix = w.get(SPEC_K + 1, 0), w.get(ENGINE["chunk"], 0)
    print(f"  {label}, eager: chunk walks by width {w} over {r['steps']} "
          f"fused steps ({dec // layers} decode, {mix // layers} mixed)")
    if set(w) - {SPEC_K + 1, ENGINE["chunk"]} or dec % layers \
            or mix % layers or (dec + mix) // layers != r["steps"] \
            or not dec:
        raise AssertionError(f"{label}: chunk walks {w} over {r['steps']} "
                             f"steps; want {layers} a step, at W = "
                             f"{SPEC_K + 1} on the decode steps")
    return dec // layers


def check_speculation(dev, g, f32_dist: float) -> dict:
    """Phase 9: full-width qwen1.5-0.5b at ``SPEC_TARGET_LAYERS`` layers
    (random weights), the kernel path, graphed, phase 5's engine and
    request mix, k = ``SPEC_K``:
    (a) a self-draft against speculation off, (b) a 4-layer draft (the
    target's embedding, first 4 layers and final norm), (c) the fully
    quantized engine with the draft quantized too.  Gates: f32 streams
    equal to speculation off up to printed near-ties (a, b); fewer fused
    steps and accepted drafts (a); graphed = eager (streams, launches),
    one capture per program (a, b, c); the launches of each program
    (``check_spec_launches``) and the eager walks' widths; no host sync
    in a fused step at sync_every=4 (a); blocks handed back by truncation
    and, with the prefix cache on, a pool whose used blocks are the
    parked ones after the drain (b); a second fresh fully-quantized
    engine repeats the streams (c).  Returns the launches of (a)'s and
    (c)'s graphed drains."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              num_layers=SPEC_TARGET_LAYERS)
    L, Ld = cfg.num_layers, SPEC_DRAFT_LAYERS

    def drain9(*a, **kw):                # the target at its cut depth
        return spec_drain(*a, arch=cfg, **kw)
    params = Model(cfg, device=dev).init(g).state_dict()
    small = (dataclasses.replace(cfg, num_layers=Ld),
             {k: v for k, v in params.items()
              if not k.startswith("layers.") or int(k.split(".")[1]) < Ld})
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    n_tok = len(prompts) * MAX_NEW
    selfd = (cfg, params)
    t_start = time.perf_counter()
    print(f"\n== speculative decoding: full-width qwen1.5-0.5b at {L} of "
          f"{get_config('qwen1.5-0.5b').num_layers} layers, k = {SPEC_K}, "
          f"the phase 5 mix ({len(prompts)} requests x {MAX_NEW} new "
          "tokens), kernels, graphed")
    # speculation off is not traced (the trace of a drain takes tens of
    # seconds to read back; phase 5 traces the 24-layer engine)
    off = drain9(params, prompts, warm=True)
    on = drain9(params, prompts, selfd, warm=True, profile=True,
                    time_capture=True)
    # where a fresh self-draft engine's first drain goes (PERF.md §6, PR
    # 24's open question): its captures in parts, beside the drain
    st = on["stats"]
    cap_s = sum(t for k, t in on["capture_parts"] if "+" in k)
    print(f"self-draft, graphed, first drain: {on['dt']:.3f} s for "
          f"{on['steps']} fused steps; compilations {on['compilations']}, "
          f"{st['graph_captures']} captures, {st['graph_replays']} replays, "
          f"{st['eager_steps']} eager steps; its captures took "
          f"{cap_s:.3f} s ({cap_s / on['dt']:.1%} of the drain):")
    for part, secs in on["capture_parts"]:
        print(f"    {part:<48} {secs:9.3f} s")
    if st["eager_steps"] or st["graph_captures"] != 2 \
            or st["graph_replays"] != on["steps"] - 2:
        raise AssertionError(f"self-draft first drain: {st}; want two "
                             "captures and every other step a replay")
    on_e = drain9(params, prompts, selfd, graphs=False)
    four = drain9(params, prompts, small, warm=True, profile=True)
    four_e = drain9(params, prompts, small, graphs=False)
    for label, r in (("speculation off", off), ("self-draft", on),
                     (f"{Ld}-layer draft", four)):
        w = r["warm"]
        print(drain_line(f"{label}, graphed, first drain", r, n_tok))
        print(drain_line(f"{label}, graphed, warm engine", w, n_tok))
        if r is off:
            print("  speculation off, warm: not traced (phase 5 traces the "
                  "24-layer engine)")
        else:
            print("  " + spec_rates(label, w, n_tok))
            t = r["traced"]
            idle = "not measured (the profiler traced no device activity)" \
                if t["device_s"] is None else \
                (f"{1 - t['device_s'] / w['dt']:.3f} of the untraced warm "
                 f"drain's {w['dt']:.3f} s ({t['device_s'] * 1e3:.1f} ms of "
                 "device time)")
            print(f"  {label}, warm: device idle {idle}")
            if t["device_s"]:
                print("  where its device time goes (the 12 longest by "
                      "name: calls, ms, share):")
                for key, calls, ms in t["top"]:
                    print(f"    {key[:90]:<90} {calls:>6} {ms:9.3f} "
                          f"{ms / (t['device_s'] * 1e3):6.1%}")
        if w["streams"] != r["streams"] or w["stats"]["graph_captures"]:
            raise AssertionError(f"{label}: the warm drain captured again "
                                 "or streamed otherwise")
    for label, r, e, ld in (("self-draft", on, on_e, L),
                            (f"{Ld}-layer draft", four, four_e, Ld)):
        check_graphed(f"speculation, {label}", {"graphed": r, "eager": e},
                      ("tiled_matmul", "chunked_prefill_attention"), L,
                      n_tok)
        check_spec_launches(label, r, L, ld, "tiled_matmul")
        spec_walk_widths(label, e, L)
        same, n = same_tokens(r["streams"], off["streams"])
        print(f"  {label}, bf16: identical tokens speculation on vs off "
              f"{same}/{n} (reported; at bf16 a verify pass and a decode "
              "step may break a near-tie differently)")
    st = on["stats"]
    if st["spec_accepted"] <= 0 or on["steps"] >= off["steps"]:
        raise AssertionError(f"self-draft: {st['spec_accepted']} accepted, "
                             f"{on['steps']} fused steps against "
                             f"{off['steps']} with speculation off")
    print(f"{Ld}-layer draft: truncation handed back {four['truncated']} "
          "blocks in the first drain; (a) and (b) graphed and eager took "
          f"{time.perf_counter() - t_start:.1f} s")
    if four["truncated"] <= 0:
        raise AssertionError(f"the {Ld}-layer draft's rollback handed back "
                             "no block")
    # f32 streams: speculation on and off over float32 pools
    f32_off = drain9(params, prompts, compute="fp32", f32_pool=True)
    for label, d in (("self-draft", selfd), (f"{Ld}-layer draft", small)):
        r = drain9(params, prompts, d, compute="fp32", f32_pool=True)
        print("  " + spec_rates(f"{label}, f32", r, n_tok))
        f32_streams_equal(params, (None, prompts), r, f32_off, f32_dist,
                          arch=cfg,
                          what=f"speculation ({label})")
    print(f"  the f32 drains: {time.perf_counter() - t_start:.1f} s into "
          "phase 9")
    # fault B: no fused step waits for the device
    quiet = drain9(params, prompts, selfd, sync_every=4, no_sync=True)
    print(f"self-draft, graphed, sync_every=4, every fused step (the "
          f"captures) under set_sync_debug_mode('error'): no host sync, no "
          f"staging wait; {quiet['steps']} steps, "
          f"{quiet['stats']['graph_captures']} captures")
    if quiet["streams"] != on["streams"]:
        raise AssertionError("self-draft: the sync_every=4 streams differ "
                             "from the sync_every=1 ones")
    # the prefix cache on for the same traffic: rollback parks trie-owned
    # tails, and the pool holds only the parked chains after the drain
    pc = drain9(params, prompts, small, prefix=True)
    m = pc["memory"]
    print(f"{Ld}-layer draft with the prefix cache: {pc['truncated']} blocks "
          f"handed back by truncation; after the drain {m.used_blocks} used "
          f"= {m.cached_blocks} parked, {pc['free']} free of "
          f"{m.total_blocks}")
    if m.used_blocks != m.cached_blocks \
            or pc["free"] + m.cached_blocks != m.total_blocks \
            or pc["streams"] != four["streams"]:
        raise AssertionError(f"{Ld}-layer draft with the prefix cache: "
                             f"pool {m}, {pc['free']} free, or other "
                             "streams than without the cache")
    # (c) fully quantized: int8 weights and pool, the draft quantized too
    print(f"  (c) starts {time.perf_counter() - t_start:.1f} s into phase 9")
    q_on = drain9(params, prompts, selfd, quant=True)
    q_e = drain9(params, prompts, selfd, quant=True, graphs=False)
    check_graphed("speculation, fully quantized", {"graphed": q_on,
                                                   "eager": q_e},
                  ("int8_matmul", "chunked_prefill_attention"), L, n_tok)
    check_spec_launches("fully quantized", q_on, L, L, "int8_matmul")
    print("  " + spec_rates("fully quantized", q_on, n_tok))
    again = drain9(params, prompts, selfd, quant=True)
    if again["streams"] != q_on["streams"]:
        raise AssertionError("fully quantized speculation: the streams "
                             "differ between two fresh engines")
    q_off = drain9(params, prompts, quant=True)
    same, n = same_tokens(q_on["streams"], q_off["streams"])
    print(f"fully quantized: a second fresh engine repeats the streams; "
          f"identical tokens speculation on vs off {same}/{n} (reported: "
          "one activation scale spans every row of a step)")
    print(f"phase 9 took {time.perf_counter() - t_start:.1f} s")
    del params
    torch.cuda.empty_cache()
    return {"spec": on["launches"], "spec_int8": q_on["launches"]}


# ---------------------------------------------------------------------------
# phase 11: the MoE family (granite-moe-1b-a400m)
# ---------------------------------------------------------------------------
MOE = "granite-moe-1b-a400m"
# projections per layer through the matmul kernel (wq, wk, wv, wo; the
# router and experts are torch.matmul / torch.bmm, as XLA einsums are in
# the reference)
MOE_MATMULS = 4
# the speculative drain's depth: granite's first 4 of 24 layers, target
# and self-draft (8 until phase 20 joined; at full depth its eager drain
# alone takes ~14 s on one H100; the walks' and matmuls' counts a pass
# scale with L)
MOE_SPEC_LAYERS = 4


def route_flips(calls: list, layers: int) -> str:
    """The routing of ``check_model_steps``' kernel path against its plain
    versions' (``calls``: every ``moe.route`` call's expert ids, path by
    path, a mixed step's ``layers`` calls then a decode step's): live
    tokens whose set of experts differs, and whose ordered ids differ."""
    mask = torch.arange(ENGINE["chunk"])[None, :] \
        < torch.tensor(STEP_N_LIVE)[:, None]
    out = []
    for step, (lo, hi) in (("mixed", (0, layers)),
                           ("decode", (layers, 2 * layers))):
        sets = order = total = 0
        for a, b in zip(calls[0][lo:hi], calls[1][lo:hi], strict=True):
            a, b = a.cpu(), b.cpu()
            if step == "mixed":
                a, b = a[mask], b[mask]
            a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
            total += a.shape[0]
            order += int((a != b).any(dim=1).sum())
            sets += int((a.sort(dim=1).values != b.sort(dim=1).values)
                        .any(dim=1).sum())
        out.append(f"{step}: {sets} of {total} live token-layers route to "
                   f"another expert set ({order} in another order)")
    return "; ".join(out)


@contextlib.contextmanager
def replayed_routing(n_calls: int):
    """``moe.route`` patched for ``check_model_steps``' kernel path then its
    plain paths: the first ``n_calls`` calls (the kernel path's mixed and
    decode steps) route themselves, and each later call takes the expert
    ids of the call ``n_calls`` before it, weighted by its own
    probabilities.  Yields every call's expert ids (``route_flips``)."""
    calls = []
    route = moe_mod.route

    def replaying(x, w, m):
        weights, ids = route(x, w, m)
        calls.append(ids)
        i = len(calls) - 1
        if i < n_calls:                    # the kernel path routes itself
            return weights, ids
        ids = calls[i % n_calls]
        top = torch.softmax(x.float() @ w.float(), dim=-1).gather(-1, ids)
        return m.router_scale * top / top.sum(dim=-1, keepdim=True), ids
    with mock.patch.object(moe_mod, "route", replaying):
        yield calls


def expert_floor(cfg: ArchConfig) -> tuple[float, float]:
    """Bytes of the bf16 expert weights one fused step reads (every layer's
    w1, wg and w2, each once, whatever the lanes), and their time at
    3.35 TB/s in ms."""
    m = cfg.moe
    nbytes = cfg.num_layers * m.num_experts * 3 * cfg.d_model \
        * m.expert_d_ff * 2
    return nbytes, nbytes / 3.35e12 * 1e3


def expert_products_ms(timer, cfg: ArchConfig, dev, g) -> dict:
    """The three ``torch.bmm`` of one layer's experts (w1, wg, w2 over E
    experts of B x C rows) at a decode step's capacity (C = 1) and a
    mixed step's (C of W = 16), bf16, timed (L2 flushed), times the
    layers: a fused step's expert products."""
    m, d, f = cfg.moe, cfg.d_model, cfg.moe.expert_d_ff
    w1, wg = (torch.randn(m.num_experts, d, f, generator=g, device=dev)
              .bfloat16() for _ in range(2))
    w2 = torch.randn(m.num_experts, f, d, generator=g, device=dev).bfloat16()
    out = {}
    for step, W in (("decode", 1), ("mixed", ENGINE["chunk"])):
        rows = ENGINE["max_batch"] * moe_mod.capacity(W, m)
        x = torch.randn(m.num_experts, rows, d, generator=g,
                        device=dev).bfloat16()

        def products():
            h = torch.bmm(x, w1) * torch.bmm(x, wg)
            return torch.bmm(h, w2)
        out[step] = dict(rows=rows, ms=timer(products) * cfg.num_layers)
    return out


def check_moe(timer, dev, g) -> dict:
    """Phase 11: granite-moe-1b-a400m at full width (24 layers, 32 experts
    top-8 of width 512, 16 heads over 8 kv heads of 64, vocab 49155),
    random weights from the port's ``init``.  (a) One mixed and one
    decode step at f32 compute, the kernels against their plain versions
    within phase 4's gate, the plain paths replaying the kernel path's
    expert ids, the routing flips between the paths' own routing
    printed; (b)
    the phase 5 mix with float weights and fully quantized, each on a
    graphed engine (first and warm drain) and an eager one, with phase
    5's gates and 96 matmul launches, 24 walks and 49 ``rmsnorm`` a
    fused step, a sync_every=4 drain under
    ``set_sync_debug_mode("error")``, a second fresh fully-quantized
    engine repeating the streams; the warm float drain traced (device ms,
    idle share, the expert products' device time against the bytes of
    the expert weights at 3.35 TB/s); (c) speculation with the self-draft,
    k = ``SPEC_K``, at ``MOE_SPEC_LAYERS`` layers, graphed and eager:
    graphed = eager and the decode program's capture one chunk walk a
    layer at W = k + 1, no decode walk.
    Returns the launches of the graphed drains by path."""
    t_start = time.perf_counter()
    cfg = get_config(MOE)
    L = cfg.num_layers
    params = Model(cfg, device=dev).init(g).state_dict()
    n_params = sum(t.numel() for t in params.values())
    floor_bytes, floor_ms = expert_floor(cfg)
    print(f"\n== MoE family: {MOE} at full width, {L} layers, "
          f"{n_params / 1e9:.3f} G parameters, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.experts_per_token} of width {cfg.moe.expert_d_ff}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} kv heads of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}; capacity a "
          f"decode step {moe_mod.capacity(1, cfg.moe)}, a mixed step "
          f"{moe_mod.capacity(ENGINE['chunk'], cfg.moe)} of "
          f"{ENGINE['chunk'] * cfg.moe.experts_per_token} routed slots")
    # (a) f32 steps.  The expert choice is a discontinuous function of
    # the router's logits: where the kernel path's last bits move a token
    # across a near-tie of two experts, the logits jump by that token's
    # share of two experts' outputs.  So the plain paths route as the
    # kernel path did (its expert ids, in call order, with their own
    # probabilities as weights) and the gate holds the kernels on equal
    # routing; the tokens whose own routing differs are printed.
    model32 = Model(cfg, compute_dtype=torch.float32, device=dev)
    model32.load_state_dict(params)
    with replayed_routing(2 * L) as calls:
        check_model_steps(model32, dev, g, gate=True,
                          paths=("kernels", "plain versions",
                                 "plain, perturbed"))
    kernels, plain, perturbed = (calls[i:i + 2 * L]
                                 for i in range(0, 6 * L, 2 * L))
    print("  the plain paths above route as the kernel path did; their own "
          "routing (f32):")
    print("  kernels vs plain versions: " + route_flips([kernels, plain], L))
    print("  plain perturbed by 2^-19 vs plain: "
          + route_flips([perturbed, plain], L))
    del model32
    torch.cuda.empty_cache()
    print(f"  (a) took {time.perf_counter() - t_start:.1f} s")
    # (b) the phase 5 mix, float weights and fully quantized
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    n_tok = len(prompts) * MAX_NEW
    launches = {}
    for path in ("moe", "moe_int8"):
        quant = path == "moe_int8"
        label = f"{MOE}, {'int8' if quant else 'float'} weights"
        eng = ServingEngine(full_width_spec(True, quant, cfg), device="cuda",
                            graphs=True)
        eng.load(params)
        first = drain(eng, prompts)
        first["warm"] = drain(eng, prompts)
        traced = drain(eng, prompts, measure="profile") if not quant \
            else None
        del eng
        torch.cuda.empty_cache()
        runs = {"graphed": first, "eager": serve(params, prompts,
                                                 quant=quant, graphs=False,
                                                 arch=cfg)}
        check_graphed(label, runs, PATH_KERNELS[path], L, n_tok)
        warm = first["warm"]
        print(drain_line(f"{label}, graphed, warm engine", warm, n_tok))
        mm = PATH_KERNELS[path][0]
        for mode, r in (*runs.items(), ("warm", warm)):
            walks = r["launches"]["paged_decode_attention"] \
                + r["launches"]["chunked_prefill_attention"]
            want = {mm: MOE_MATMULS * L * r["steps"], "walks": L * r["steps"]}
            have = {mm: r["launches"][mm], "walks": walks}
            if have != want:
                raise AssertionError(f"{label}, {mode}: launches {have}, "
                                     f"want {want} ({r['steps']} steps)")
        print(f"  {label}: {MOE_MATMULS * L} {mm}, {L} walks and "
              f"{2 * L + 1} rmsnorm a fused step on every drain")
        if warm["streams"] != first["streams"] and not quant:
            raise AssertionError(f"{label}: the warm drain streamed "
                                 "otherwise")
        if warm["stats"]["graph_captures"] \
                or warm["launches"] != first["launches"]:
            raise AssertionError(f"{label}: the warm drain captured again or "
                                 "launched otherwise")
        if traced is not None:
            dev_s = traced["device_s"]
            if dev_s is None:
                print("  the profiler traced no device activity: device "
                      "time, idle share and the expert products not "
                      "measured")
            else:
                # cuBLAS's bf16 batched gemms (its Hopper "nvjet" kernels
                # name no dtype); no other cuBLAS call of the step is bf16
                gemms = [(k, c, t) for k, c, t in traced["kernels"]
                         if "nvjet" in k or ("gemm" in k and "bf16" in k)]
                ex_ms = sum(t for _, _, t in gemms)
                steps = traced["steps"]
                n_gemm, want_gemm = sum(c for _, c, _ in gemms), 3 * L * steps
                print(f"  the expert products' kernels: {n_gemm} launches "
                      f"({want_gemm} expected: 3 a layer a step)"
                      + ("" if n_gemm == want_gemm else " -- the attribution "
                         "below is not the expert products alone"))
                print(f"  {label}, graphed, warm engine, traced: "
                      f"{dev_s * 1e3:.1f} ms of device time over {steps} "
                      f"fused steps; idle {1 - dev_s / warm['dt']:.3f} of "
                      f"the untraced warm drain's {warm['dt']:.3f} s "
                      f"({1 - dev_s / traced['dt']:.3f} of the traced "
                      f"drain's {traced['dt']:.3f} s)")
                print(f"  expert products (the bf16 gemm kernels, "
                      f"torch.bmm): {ex_ms:.3f} ms = {ex_ms / steps:.4f} ms "
                      f"a step against the floor {floor_ms:.4f} ms a step "
                      f"({floor_bytes / 1e9:.3f} GB of bf16 expert weights "
                      f"at 3.35 TB/s); {ex_ms / (dev_s * 1e3):.1%} of the "
                      "device time; kernels counted: "
                      + ", ".join(f"{k[:70]} x{c}" for k, c, _ in gemms))
                print("  where the warm drain's device time goes (the 12 "
                      "longest by name: calls, ms, share):")
                for key, calls_n, ms in traced["top"]:
                    print(f"    {key[:90]:<90} {calls_n:>6} {ms:9.3f} "
                          f"{ms / (dev_s * 1e3):6.1%}")
        quiet = serve(params, prompts, quant=quant, arch=cfg, sync_every=4,
                      no_sync=True)
        same, n = same_tokens(quiet["streams"], first["streams"])
        print(f"  {label}, graphed, sync_every=4, every fused step under "
              f"set_sync_debug_mode('error'): no host sync, no staging "
              f"wait; {quiet['steps']} steps, {quiet['dt']:.3f} s; "
              f"identical tokens to sync_every=1 {same}/{n}"
              + (" (reported: the int8 activation scale spans finished "
                 "slots' rows)" if quant else ""))
        if not quant and quiet["streams"] != first["streams"]:
            raise AssertionError(f"{label}: the sync_every=4 streams differ")
        if quant:
            again = serve(params, prompts, quant=True, arch=cfg)
            if again["streams"] != first["streams"]:
                raise AssertionError(f"{label}: the streams differ between "
                                     "two fresh engines")
            print(f"  {label}: a second fresh graphed engine repeats the "
                  f"streams ({again['dt']:.3f} s)")
        launches[path] = first["launches"]
        print(f"  {label}: {time.perf_counter() - t_start:.1f} s into phase "
              "11")
    products = expert_products_ms(timer, cfg, dev, g)
    print("  expert products timed alone (bf16 torch.bmm x 3, L2 flushed, "
          f"x {L} layers): decode step {products['decode']['ms']:.4f} ms "
          f"({products['decode']['rows']} rows an expert), mixed step "
          f"{products['mixed']['ms']:.4f} ms ({products['mixed']['rows']} "
          f"rows an expert); floor {floor_ms:.4f} ms a step")
    # (c) speculation: the self-draft, target and draft at
    # MOE_SPEC_LAYERS layers
    t_spec = time.perf_counter()
    Ls = min(MOE_SPEC_LAYERS, L)
    cut = dataclasses.replace(cfg, num_layers=Ls)
    cut_params = {k: v for k, v in params.items()
                  if not k.startswith("layers.") or int(k.split(".")[1]) < Ls}
    selfd = (cut, cut_params)
    on = spec_drain(cut_params, prompts, selfd, warm=True, arch=cut)
    on_e = spec_drain(cut_params, prompts, selfd, graphs=False, arch=cut)
    label = f"{MOE} at {Ls} of {L} layers speculating, self-draft"
    print(drain_line(f"{label}, graphed, first drain", on, n_tok))
    print(drain_line(f"{label}, graphed, warm engine", on["warm"], n_tok))
    print("  " + spec_rates(label, on["warm"], n_tok))
    check_graphed(label, {"graphed": on, "eager": on_e},
                  ("tiled_matmul", "chunked_prefill_attention"), Ls, n_tok)
    check_spec_launches(label, on, Ls, Ls, "tiled_matmul", MOE_MATMULS)
    spec_walk_widths(label, on_e, Ls)
    print(f"  speculation took {time.perf_counter() - t_spec:.1f} s; phase "
          f"11 {time.perf_counter() - t_start:.1f} s")
    launches["moe_spec"] = on["launches"]
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 14: MLA (deepseek-v3-671b)
# ---------------------------------------------------------------------------
MLA = "deepseek-v3-671b"
# the cut: 2 of 61 layers and first_k_dense 3 -> 1, so that one dense
# layer (d_ff 18432) and one MoE layer (256 experts top-8 and the shared
# expert) run, both with MLA; 13.9 G parameters (55.8 GB at f32 compute,
# 27.9 GB at bf16), most of them the MoE layer's experts and the two
# [129280, 7168] tables: one model resident at a time
MLA_LAYERS, MLA_DENSE = 2, 1


def mla_cut() -> ArchConfig:
    cfg = get_config(MLA)
    return dataclasses.replace(cfg, num_layers=MLA_LAYERS,
                               moe=dataclasses.replace(
                                   cfg.moe, first_k_dense=MLA_DENSE))


def mla_step_launches(cfg: ArchConfig) -> dict[str, int]:
    """The hand-written kernels' launches per fused step of an MLA model
    under ``matmul_backend="pallas"`` (``models/attention.py``,
    ``models/moe.py``): every layer's q_down, q_up, kv_down and wo through
    ``tiled_matmul`` (the absorbed attend's k_up / v_up contractions are
    einsums, as in the reference), a dense layer's w1, wg, w2 and an MoE
    layer's shared expert's; ``rmsnorm`` for ln1, ln2, q_norm and kv_norm
    of every layer and the final norm.  No paged walk."""
    k, L = cfg.moe.first_k_dense, cfg.num_layers
    shared = 3 * (L - k) if cfg.moe.num_shared_experts else 0
    return {"tiled_matmul": 4 * L + 3 * k + shared, "rmsnorm": 4 * L + 1,
            "paged_decode_attention": 0, "chunked_prefill_attention": 0}


def init_in_place(model: Model, g) -> Model:
    """Random weights at ``Model.init``'s scales drawn straight into a
    float32 model's parameters: no full-size float32 temporary beside
    the 15 GB expert leaves."""
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            prm.zero_()
        elif leaf == "scale":
            prm.fill_(1.0)
        else:
            prm.normal_(0.0, 0.02 if name == "embed.table" else
                        1.0 / math.sqrt(max(prm.shape[-2], 1)), generator=g)
    return model


def check_mla(dev, g) -> dict:
    """Phase 14: deepseek-v3-671b at its published widths, cut to
    ``MLA_LAYERS`` of 61 layers with ``first_k_dense`` ``MLA_DENSE``.
    (a) One mixed and one decode step at f32 compute (its own random
    weights), the kernels against their plain versions within phase 4's
    gate, the plain paths replaying the kernel path's expert ids.  (b) The
    phase 5 mix in bf16 over a bf16 latent pool and over an int8 one, each
    graphed (first and warm drain) and eager: phase 5's gates, the
    launches a fused step makes (``mla_step_launches``) on every drain, no
    paged walk; the warm bf16-pool drain traced (device ms, idle share),
    and the peak device memory.  Returns the graphed drains' launches."""
    t_start = time.perf_counter()
    full, cfg = get_config(MLA), mla_cut()
    L, k, m = cfg.num_layers, cfg.moe.first_k_dense, cfg.mla
    per_step = mla_step_launches(cfg)
    print(f"\n== MLA: {MLA} at its published widths (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, q_lora {m.q_lora_rank}, kv_lora "
          f"{m.kv_lora_rank}, rope {m.qk_rope_head_dim}, v {m.v_head_dim}; "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.experts_per_token} + "
          f"{cfg.moe.num_shared_experts} shared, vocab {cfg.vocab_size}), "
          f"cut to {L} of {full.num_layers} layers and first_k_dense "
          f"{full.moe.first_k_dense} -> {k}: one dense layer (d_ff "
          f"{cfg.moe.dense_d_ff}) and one MoE layer; per fused step "
          f"{per_step['tiled_matmul']} tiled_matmul and "
          f"{per_step['rmsnorm']} rmsnorm launches, no paged walk")
    # (a) f32 steps, the plain paths routed as the kernel path was
    torch.cuda.empty_cache()
    model32 = init_in_place(Model(cfg, compute_dtype=torch.float32,
                                  device=dev), g)
    n_params = sum(t.numel() for t in model32.parameters())
    print(f"  {n_params / 1e9:.3f} G parameters "
          f"({torch.cuda.memory_allocated() / 1e9:.1f} GB at f32 compute)")
    with replayed_routing(2 * (L - k)) as calls:
        check_model_steps(model32, dev, g, gate=True,
                          paths=("kernels", "plain versions",
                                 "plain, perturbed"))
    n_route = 2 * (L - k)
    kernels, plain, perturbed = (calls[i:i + n_route]
                                 for i in range(0, 3 * n_route, n_route))
    print("  the plain paths above route as the kernel path did; their own "
          "routing (f32): kernels vs plain versions: "
          + route_flips([kernels, plain], L - k)
          + "; plain perturbed by 2^-19 vs plain: "
          + route_flips([perturbed, plain], L - k))
    del model32, calls, kernels, plain, perturbed
    torch.cuda.empty_cache()
    print(f"  (a) took {time.perf_counter() - t_start:.1f} s")
    # (b) the phase 5 mix in bf16, graphed and eager, bf16 and int8 pools
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    n_tok = len(prompts) * MAX_NEW
    torch.cuda.reset_peak_memory_stats()
    spec = full_width_spec(True, arch=cfg)
    launches, source = {}, None
    for path, kv in (("mla", "compute"), ("mla_int8_pool", "int8")):
        pspec = dataclasses.replace(spec, memory=dataclasses.replace(
            spec.memory, kv_dtype=kv))
        pool = "bf16" if kv == "compute" else "int8"
        label = f"{MLA} at {L} layers, bf16, {pool} latent pool"
        eng = ServingEngine(pspec, device="cuda", graphs=True)
        if source is None:
            eng.model.init(g)
            eng.load(eng.model.state_dict())
        else:
            eng.load(source.model.state_dict())
            del source
            torch.cuda.empty_cache()
        first = drain(eng, prompts)
        first["warm"] = drain(eng, prompts)
        traced = drain(eng, prompts, measure="profile") \
            if path == "mla" else None
        eager_eng = ServingEngine(pspec, device="cuda", graphs=False)
        eager_eng.load(eng.model.state_dict())
        runs = {"graphed": first, "eager": drain(eager_eng, prompts)}
        del eager_eng
        torch.cuda.empty_cache()
        check_graphed(label, runs, PATH_KERNELS[path], L, n_tok,
                      norms=per_step["rmsnorm"])
        warm = first["warm"]
        print(drain_line(f"{label}, graphed, warm engine", warm, n_tok))
        for mode, r in (*runs.items(), ("warm", warm)):
            have = {name: r["launches"][name] for name in per_step}
            want = {name: c * r["steps"] for name, c in per_step.items()}
            if have != want:
                raise AssertionError(f"{label}, {mode}: launches {have}, "
                                     f"want {want} ({r['steps']} steps)")
        if warm["stats"]["graph_captures"] or warm["streams"] \
                != first["streams"] or warm["launches"] != first["launches"]:
            raise AssertionError(f"{label}: the warm drain captured again or "
                                 "streamed or launched otherwise")
        print(f"  {label}: {per_step['tiled_matmul']} tiled_matmul and "
              f"{per_step['rmsnorm']} rmsnorm a fused step and no paged walk "
              "on every drain; warm "
              f"{n_tok / warm['dt']:.1f} tok/s")
        if traced is not None:
            dev_s = traced["device_s"]
            if dev_s is None:
                print("  the profiler traced no device activity: device "
                      "time and idle share not measured")
            else:
                print(f"  {label}, graphed, warm engine, traced: "
                      f"{dev_s * 1e3:.1f} ms of device time over "
                      f"{traced['steps']} fused steps; idle "
                      f"{1 - dev_s / warm['dt']:.3f} of the untraced warm "
                      f"drain's {warm['dt']:.3f} s "
                      f"({1 - dev_s / traced['dt']:.3f} of the traced "
                      f"drain's {traced['dt']:.3f} s)")
                print("  where the warm drain's device time goes (the 12 "
                      "longest by name: calls, ms, share):")
                for key, calls_n, ms in traced["top"]:
                    print(f"    {key[:90]:<90} {calls_n:>6} {ms:9.3f} "
                          f"{ms / (dev_s * 1e3):6.1%}")
        launches[path] = first["launches"]
        source = eng
        del eng
    del source
    torch.cuda.empty_cache()
    print(f"  max_memory_allocated over (b): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase 14 took "
          f"{time.perf_counter() - t_start:.1f} s")
    return launches



# ---------------------------------------------------------------------------
# phase 15: the vlm family (phi-3-vision-4.2b), the dense cache layout and
# the bucketed scheduler
# ---------------------------------------------------------------------------
VLM = "phi-3-vision-4.2b"
# phase 15a-b's depth: 4 of its 32 layers (cut to 8 when phase 16 joined
# and to 4 when phase 20 did, to keep the run well inside its limit;
# every gate a layer carries stays)
VLM_LAYERS = 4
VLM_ENGINE = dict(max_batch=8, max_len=1024, block_size=16, chunk=16)
# text tokens after the 576 patch positions: prompts of 592-992 tokens
VLM_TEXT = (16, 73, 130, 187, 244, 301, 358, 416)
# phase 15a's mixed step: lane 0 positions, live lanes and prompt slots;
# slot 0's chunk lies below position 576, slots 1-5 straddle it, slot 6
# starts at it, slot 7 decodes one lane at 580 (not a prompt lane)
VLM_START = (560, 565, 568, 570, 572, 575, 576, 580)
VLM_N_LIVE = (16, 16, 16, 16, 16, 16, 9, 1)
VLM_PREFILL = (True,) * 7 + (False,)
def vlm_cut() -> ArchConfig:
    """phi-3-vision-4.2b at its published widths and ``VLM_LAYERS``
    layers."""
    return dataclasses.replace(get_config(VLM), num_layers=VLM_LAYERS)


# phase 15b/15c's engines: (label, policy, layout)
BUCKETED_ENGINES = (("paged + chunked", "chunked", "paged"),
                    ("dense + bucketed", "bucketed", "dense"),
                    ("paged + bucketed", "bucketed", "paged"))


def vlm_spec(policy: str, layout: str, compute: str = "bf16",
             arch: ArchConfig | None = None,
             engine: dict = VLM_ENGINE) -> RuntimeSpec:
    """Phase 15's spec on the kernel path: phi-3-vision-4.2b at
    ``VLM_LAYERS`` layers (or ``arch``) at ``engine``'s geometry on
    ``policy`` over ``layout``."""
    return RuntimeSpec(
        arch=arch or vlm_cut(),
        execution=ExecutionSpec(matmul_backend="pallas",
                                paged_attn_impl="pallas",
                                compute_dtype=compute),
        memory=MemorySpec(cache_layout=layout,
                          max_batch=engine["max_batch"],
                          max_len=engine["max_len"],
                          block_size=engine["block_size"]),
        scheduler=SchedulerSpec(policy=policy, chunk_size=engine["chunk"]))


def vlm_steps(model: Model, dev, g) -> None:
    """Phase 15a on the f32 model: along the kernels, their plain versions
    and those perturbed by ``ATTN_PERTURB`` (``STEP_PATHS``), one mixed
    step whose prompt lanes straddle position 576 (``prefill_lanes``) and
    one decode step, over the paged pool and over the dense layout, and
    ``Model.prefill`` of a 1024-token prompt with the zero frontend; each
    within phase 4's gate of the plain versions.  Then the frontend rule
    on the kernel path: other token ids below position 576 leave the
    prefill's logits bit for bit as they were."""
    cfg = model.cfg
    n_fe = cfg.frontend.num_tokens
    B, W, L = VLM_ENGINE["max_batch"], VLM_ENGINE["chunk"], \
        VLM_ENGINE["max_len"]
    bs = VLM_ENGINE["block_size"]
    paging = vlm_spec("chunked", "paged").memory.paging()
    tables = (torch.randperm(paging.num_blocks, generator=g, device=dev)
              .reshape(B, L // bs) + 1).to(torch.int32)
    ids = lambda *shape: torch.randint(  # noqa: E731
        0, cfg.vocab_size, shape, generator=g, device=dev,
        dtype=torch.int32)
    toks, dtoks, prompt = ids(B, W), ids(B, 1), ids(1, L)
    start = torch.tensor(VLM_START, dtype=torch.int32, device=dev)
    n_live = torch.tensor(VLM_N_LIVE, dtype=torch.int32, device=dev)
    lanes = torch.tensor(VLM_PREFILL, device=dev)
    live = torch.arange(W, device=dev)[None, :] < n_live[:, None]
    fe = torch.zeros(1, n_fe, cfg.d_model, dtype=torch.bfloat16, device=dev)
    print(f"\n== {VLM} at its published widths ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_fe} patch positions), f32 compute: "
          "|kernels - plain versions| (gated)")
    paths = ("kernels", "plain versions", "plain, perturbed")
    out = {}
    for path in paths:
        _, ctx = STEP_PATHS[path]
        res = []
        with ctx():
            for layout in ("paged", "dense"):
                cache = model.init_cache(paging) if layout == "paged" \
                    else model.init_cache(batch=B, max_len=L)
                tb = tables if layout == "paged" else None
                mixed = model.mixed_step(cache, toks, start, n_live, tb,
                                         prefill_lanes=lanes)
                dec = model.decode_step(cache, dtoks, start + n_live, tb)
                res += [mixed[live], dec]
                del cache
            res.append(model.prefill(prompt, L, fe)[0])
        out[path] = res
    cases = ("paged mixed step (prefill lanes across 576)",
             "paged decode step", "dense mixed step", "dense decode step",
             "prefill of 1024 tokens, zero frontend")
    for i, case in enumerate(cases):
        ref = out["plain versions"][i]
        floor = max_err(out["plain, perturbed"][i], ref)
        tol = max(LOGIT_TOL * float(ref.abs().max()), 2 * floor)
        err = max_err(out["kernels"][i], ref)
        print(f"  {case}: kernels {err:.4g}, tol max({LOGIT_TOL} x "
              f"max|logits|, 2 x perturbed {floor:.3g}) = {tol:.4g}")
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{VLM} {case}: kernels {err} > {tol}")
    other = prompt.clone()
    other[:, :n_fe] = (other[:, :n_fe] + 1) % cfg.vocab_size
    same = torch.equal(model.prefill(other, L, fe)[0], out["kernels"][-1])
    print(f"  the frontend rule: other token ids at positions < {n_fe} give "
          f"the prefill's logits bit for bit: {same}")
    if not same:
        raise AssertionError(f"{VLM}: token ids below {n_fe} moved the "
                             "prefill's logits")


def bucketed_launches(cfg: ArchConfig, policy: str, layout: str,
                      r: dict, n_req: int) -> dict[str, int]:
    """The launches ``kernels/counts.py`` gives a drain ``r`` of ``n_req``
    requests: the bucketed scheduler's one prefill per request and its
    decode steps; the chunked scheduler's mixed steps (one chunk walk a
    layer) and decode steps."""
    pl = {p: program_launches(cfg, p, layout=layout)
          for p in ("decode", "mixed", "prefill")}
    if policy == "bucketed":
        calls = {"prefill": n_req, "decode": r["steps"]}
    else:
        mixed = r["launches"]["chunked_prefill_attention"] \
            // cfg.num_layers
        calls = {"mixed": mixed, "decode": r["steps"] - mixed}
    return {n: sum(c * pl[p][n] for p, c in calls.items())
            for n in pl["decode"]}


def bucketed_engine_line(label: str, cfg: ArchConfig, policy: str,
                         layout: str, runs: dict, n_req: int,
                         kernels, max_new: int = MAX_NEW) -> None:
    """Phase 15b/15c's (and 16b's) gates and lines on one engine: graphed
    (first and warm drain) = eager streams, the warm drain captured
    nothing, one capture per fused program and per bucket, and the
    launches of every drain equal ``bucketed_launches``."""
    g, e, warm = runs["graphed"], runs["eager"], runs["graphed"]["warm"]
    n_tok = n_req * max_new
    for mode, r in (("graphed, first drain", g), ("graphed, warm", warm),
                    ("eager", e)):
        st = r["stats"]
        print(f"  {label}, {mode}: {n_tok / r['dt']:.1f} tok/s "
              f"({r['dt']:.3f} s), {r['steps']} fused steps; captures "
              f"{st['graph_captures']} fused + {st['prefill_captures']} "
              f"prefill, replays {st['graph_replays']} + "
              f"{st['prefill_replays']}, {st['eager_steps']} eager steps; "
              f"compilations {r['compilations']}")
        want = bucketed_launches(cfg, policy, layout, r, n_req)
        have = {n: r["launches"][n] for n in want}
        print(f"    launches {have} (kernels/counts.py: {want})")
        if have != want:
            raise AssertionError(f"{label}, {mode}: launches {have} != "
                                 f"{want}")
        for name in kernels:
            if r["launches"][name] <= 0:
                raise AssertionError(f"{name} was not launched on {label}")
    if g["streams"] != e["streams"] or warm["streams"] != g["streams"]:
        raise AssertionError(f"{label}: the graphed streams differ from the "
                             "eager ones, or the warm drain's from the "
                             "first's")
    comp = g["compilations"]
    buckets = comp["prefill_buckets"]
    if comp["decode"] != 1 or (policy == "chunked" and comp["prefill"] != 1) \
            or (policy == "bucketed" and (comp["prefill"] != buckets
                                          or buckets < 1
                                          or g["stats"]["prefill_captures"]
                                          != buckets)) \
            or g["stats"]["eager_steps"] or warm["stats"]["graph_captures"] \
            or warm["stats"]["prefill_captures"]:
        raise AssertionError(f"{label}: compilations {comp}, first "
                             f"{g['stats']}, warm {warm['stats']}; want one "
                             "capture per program and per bucket")
    print(f"  {label}: graphed = eager streams ({n_tok} tokens); one capture "
          f"per program (decode {comp['decode']}, prefill {comp['prefill']}"
          f", buckets {buckets})")


def f32_streams(label: str, make_spec, params, prompts,
                max_new: int) -> None:
    """The three engines of ``BUCKETED_ENGINES`` at f32 compute over float32
    pools (the CPU parity tests' setting) drain ``prompts`` (greedy,
    ``max_new`` tokens each) on fresh graphed engines, one resident at a
    time.  Gates: every request's first token identical on all three (the
    prompt's forward is the same math: the chunked engine's chunks attend
    over the unrounded K/V of the float32 pool, as the bucketed prefill
    attends over its own), and the whole streams identical between the two
    bucketed engines (the same prefill, then decode over the same rows).
    The chunked engine's later tokens are reported against them: the
    bucketed prefill stages the prompt's K/V in bf16 (the reference's rule,
    ``gqa_prefill``), the chunked engine keeps them in float32, so its
    decode attends over other K/V."""
    got = {}
    for name, policy, layout in BUCKETED_ENGINES:
        eng = ServingEngine(make_spec(policy, layout), device="cuda")
        eng.load(params)
        eng.cache = type(eng.cache)(*(None if t is None else t.float()
                                      for t in eng.cache))
        uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        done = {r.uid: r.generated for r in eng.run_to_completion()}
        got[name] = [done[u] for u in uids]
        del eng
        torch.cuda.empty_cache()
    (chunked, a), (_, b), (_, c) = got.items()
    n = len(prompts) * max_new
    same = sum(x == y for s, t in zip(b, a) for x, y in zip(s, t))
    print(f"  {label}, f32 over float32 pools: first tokens "
          f"{[s[0] for s in a]} on all three: "
          f"{[s[0] for s in a] == [s[0] for s in b] == [s[0] for s in c]}; "
          f"{BUCKETED_ENGINES[1][0]} = {BUCKETED_ENGINES[2][0]}: {b == c}; "
          f"{chunked} vs the bucketed: identical tokens {same}/{n} "
          "(reported: bf16 staging of the prompt's K/V)")
    if not [s[0] for s in a] == [s[0] for s in b] == [s[0] for s in c]:
        raise AssertionError(f"{label}, f32: the first tokens differ between "
                             "the chunked and the bucketed engines")
    if b != c:
        raise AssertionError(f"{label}, f32: the two bucketed engines' "
                             "streams differ")


def vlm_serving(params, dev, g) -> dict:
    """Phase 15b: phi-3-vision-4.2b in bf16 (seeded random weights),
    ``VLM_ENGINE``'s geometry, 8 greedy requests of 576 patch positions +
    ``VLM_TEXT`` text tokens, ``MAX_NEW`` new tokens each, on the three
    engines of ``BUCKETED_ENGINES``, each graphed (first and warm drain,
    then a traced warm drain) and eager, one engine resident beside its
    eager twin; then a short f32 mix on all three.  Returns each graphed
    first drain's launches."""
    cfg = vlm_cut()
    rs = np.random.default_rng(15)
    prompts = [rs.integers(0, cfg.vocab_size, cfg.frontend.num_tokens + n)
               .tolist() for n in VLM_TEXT]
    print(f"\n== serving {VLM} in bf16: {len(prompts)} greedy requests of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens "
          f"({cfg.frontend.num_tokens} patch positions) x {MAX_NEW} new, "
          f"max_batch {VLM_ENGINE['max_batch']}, max_len "
          f"{VLM_ENGINE['max_len']}, blocks of {VLM_ENGINE['block_size']}, "
          f"chunks of {VLM_ENGINE['chunk']}, the kernel path")
    launches = {}
    for label, policy, layout in BUCKETED_ENGINES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        spec = vlm_spec(policy, layout)
        eng = ServingEngine(spec, device="cuda", graphs=True)
        eng.load(params)
        first = drain(eng, prompts)
        first["warm"] = drain(eng, prompts)
        traced = drain(eng, prompts, measure="profile")
        eager = ServingEngine(spec, device="cuda", graphs=False)
        eager.load(params)
        runs = {"graphed": first, "eager": drain(eager, prompts)}
        peak = torch.cuda.max_memory_allocated() / 1e9
        del eng, eager
        path = f"vlm_{policy}_{layout}"
        bucketed_engine_line(label, cfg, policy, layout, runs, len(prompts),
                             PATH_KERNELS[path])
        dev_s, warm = traced["device_s"], first["warm"]
        if dev_s is None:
            print("  the profiler traced no device activity: device time and "
                  "idle share not measured")
        else:
            idle = 1 - dev_s / warm["dt"]
            print(f"  {label}, warm drain traced: {dev_s * 1e3:.1f} ms of "
                  f"device time over {traced['steps']} fused steps; idle "
                  f"{idle:.3f} of the untraced warm drain's "
                  f"{warm['dt']:.3f} s "
                  f"({1 - dev_s / traced['dt']:.3f} of the traced drain's "
                  f"{traced['dt']:.3f} s)"
                  + ("; below 0: the traced kernels outlast the untraced "
                     "drain, the device is never idle" if idle < 0 else "")
                  + "; the 6 longest kernels:")
            for key, calls_n, ms in traced["top"][:6]:
                print(f"    {key[:90]:<90} {calls_n:>6} {ms:9.3f} "
                      f"{ms / (dev_s * 1e3):6.1%}")
        print(f"  {label}: max_memory_allocated {peak:.2f} GB (graphed and "
              "eager engines resident)")
        launches[path] = first["launches"]
    torch.cuda.empty_cache()
    return launches


def check_vlm(dev, g) -> dict:
    """Phase 15a and 15b on phi-3-vision-4.2b at its published widths and
    ``VLM_LAYERS`` of its 32 layers (``vlm_steps``, ``vlm_serving``), then
    15b's f32 gate on a short mix: the three engines' greedy streams
    identical."""
    t_start = time.perf_counter()
    cfg = vlm_cut()
    model32 = Model(cfg, compute_dtype=torch.float32, device=dev,
                    matmul_backend="pallas", paged_attn_impl="pallas")
    init_in_place(model32, g)
    n_params = sum(t.numel() for t in model32.parameters())
    print(f"\n== phase 15: {VLM} at {cfg.num_layers} of its 32 layers, "
          f"{n_params / 1e9:.3f} G parameters ({n_params * 2 / 1e9:.2f} GB "
          "in bf16)")
    vlm_steps(model32, dev, g)
    params = model32.state_dict()
    print(f"  (a) took {time.perf_counter() - t_start:.1f} s")
    launches = vlm_serving(params, dev, g)
    rs = np.random.default_rng(16)
    short = [rs.integers(0, cfg.vocab_size, cfg.frontend.num_tokens + n)
             .tolist() for n in (16, 130, 244)]
    f32_streams(f"{VLM}, 3 requests of {min(map(len, short))}-"
                f"{max(map(len, short))} tokens x 4 new",
                lambda p, lay: vlm_spec(p, lay, compute="fp32"), params,
                short, 4)
    del model32, params
    torch.cuda.empty_cache()
    print(f"  phase 15a-b took {time.perf_counter() - t_start:.1f} s")
    return launches


def check_bucketed_qwen(dev, g) -> dict:
    """Phase 15c: qwen1.5-0.5b on phase 5's spec and request mix with
    ``policy="bucketed"`` over the dense layout and the paged pool, each
    graphed (first and warm drain) and eager (``bucketed_engine_line``'s
    gates; prompts of 24-400 tokens fill buckets 32-512); then the mix at
    f32 compute on the chunked engine and both bucketed ones: identical
    streams."""
    t_start = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    params = Model(cfg, device=dev).init(g).state_dict()
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    print(f"\n== phase 15c: full-width {cfg.name} on the bucketed "
          f"scheduler, phase 5's mix ({len(prompts)} requests x {MAX_NEW} "
          "new), the kernel path")
    launches = {}
    for label, policy, layout in BUCKETED_ENGINES[1:]:
        spec = vlm_spec(policy, layout, arch=cfg, engine=ENGINE)
        eng = ServingEngine(spec, device="cuda", graphs=True)
        eng.load(params)
        first = drain(eng, prompts)
        first["warm"] = drain(eng, prompts)
        eager = ServingEngine(spec, device="cuda", graphs=False)
        eager.load(params)
        runs = {"graphed": first, "eager": drain(eager, prompts)}
        del eng, eager
        bucketed_engine_line(f"{cfg.name} {label}", cfg, policy, layout,
                             runs, len(prompts),
                             PATH_KERNELS[f"bucketed_{layout}"])
        comp = first["compilations"]
        print(f"  {cfg.name} {label}: warm graphed "
              f"{len(prompts) * MAX_NEW / first['warm']['dt']:.1f} tok/s; "
              f"captures: decode {comp['decode']}, one per bucket "
              f"({comp['prefill_buckets']} buckets, prompts of "
              f"{min(PROMPT_LENS)}-{max(PROMPT_LENS)} tokens)")
        launches[f"bucketed_{layout}"] = first["launches"]
    f32_streams(f"{cfg.name}, phase 5's mix",
                lambda p, lay: vlm_spec(p, lay, compute="fp32", arch=cfg,
                                        engine=ENGINE), params, prompts,
                MAX_NEW)
    del params
    torch.cuda.empty_cache()
    print(f"  phase 15c took {time.perf_counter() - t_start:.1f} s")
    return launches



# ---------------------------------------------------------------------------
# phase 16: the hybrid family (recurrentgemma-2b) on dense + bucketed
# ---------------------------------------------------------------------------
HYBRID = "recurrentgemma-2b"
# phase 16's depth: 7 of its 26 layers (cut to 13 when phase 17 joined and
# to 7 when phase 20 did, for run time; every kind of layer and gate
# stays: 5 RG-LRU and 2 local-attention layers)
HYBRID_LAYERS = 7
# 16a: a prefill past the 2048-token window, then decode steps
HYBRID_PREFILL, HYBRID_DECODE = 2300, 4
# 16b: the serving geometry and mix (buckets 32-3072; the prompts fill six
# of them: 64, 256, 512, 1024, 2048 and 3072)
HYBRID_ENGINE = dict(max_batch=8, max_len=3072)
HYBRID_PROMPTS = (40, 200, 512, 1000, 1500, 2047, 2300, 3000)
HYBRID_NEW = 32


def hybrid_cut() -> ArchConfig:
    return dataclasses.replace(get_config(HYBRID), num_layers=HYBRID_LAYERS)


def hybrid_spec(compute: str = "bf16", policy: str = "bucketed"
                ) -> RuntimeSpec:
    """Phase 16's spec on the kernel path: recurrentgemma-2b on the dense
    layout and the bucketed scheduler (the only path the reference allows
    the family)."""
    return RuntimeSpec(
        arch=hybrid_cut(),
        execution=ExecutionSpec(matmul_backend="pallas",
                                paged_attn_impl="pallas",
                                compute_dtype=compute),
        memory=MemorySpec(cache_layout="dense", **HYBRID_ENGINE),
        scheduler=SchedulerSpec(policy=policy))


def hybrid_steps(model: Model, dev, g) -> None:
    """Phase 16a on the f32 model: ``Model.prefill`` of a
    ``HYBRID_PREFILL``-token prompt (past the window: the local attention
    runs banded and the rolling buffers wrap) and ``HYBRID_DECODE`` decode
    steps over its state, along the kernels and their plain versions
    (``STEP_PATHS``; the plain loop in place of ``rglru_scan``), each
    within phase 4's gate, 2e-2 x max|logits| (the perturbed path is the
    plain one here: no paged walk runs); the kernel path's launches
    against ``program_launches``.  Then the chunked step has no way in:
    an explicit chunked spec and ``mixed_step`` raise, "auto" resolves to
    the bucketed scheduler."""
    cfg = model.cfg
    P, D = HYBRID_PREFILL, HYBRID_DECODE
    toks = torch.randint(0, cfg.vocab_size, (1, P + D), generator=g,
                         device=dev, dtype=torch.int32)
    print(f"\n== {HYBRID} at its published widths ({cfg.num_layers} layers "
          f"{''.join(cfg.hybrid.pattern)}..., d_model {cfg.d_model}, "
          f"lru_width {cfg.hybrid.lru_width}, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, window "
          f"{cfg.hybrid.attention_window}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), f32 compute: a {P}-token prefill + {D} "
          "decode steps, |kernels - plain versions| (gated)")
    out = {}
    for path in ("kernels", "plain versions"):
        _, ctx = STEP_PATHS[path]
        zero_counts()
        with ctx():
            logits, cache = model.prefill(toks[:, :P], P + D)
            res = [logits[0]]
            made = launch_counts()
            for t in range(P, P + D):
                res.append(model.decode_step(
                    cache, toks[:, t:t + 1],
                    torch.tensor([t], dtype=torch.int32, device=dev))[0, 0])
        out[path] = res
        del cache, logits
        if path == "kernels":
            want = program_launches(cfg, "prefill", layout="dense")
            have = {n: made[n] for n in want}
            print(f"  the kernel path's prefill launched {have} "
                  f"(kernels/counts.py: {want})")
            if have != want:
                raise AssertionError(f"{HYBRID} prefill: launches {have} != "
                                     f"{want}")
    cases = [f"prefill of {P} tokens"] + [f"decode step at {t}"
                                          for t in range(P, P + D)]
    for i, case in enumerate(cases):
        ref = out["plain versions"][i]
        tol = LOGIT_TOL * float(ref.abs().max())
        err = max_err(out["kernels"][i], ref)
        print(f"  {case}: kernels {err:.4g}, tol {LOGIT_TOL} x max|logits| "
              f"= {tol:.4g}")
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{HYBRID} {case}: kernels {err} > {tol}")
    try:
        hybrid_spec(policy="chunked")
    except ValueError as exc:
        print(f"  an explicit chunked spec is refused: {exc}")
    else:
        raise AssertionError(f"{HYBRID}: a chunked spec was accepted")
    try:
        model.mixed_step(None, toks[:, :1], toks[0, :1], toks[0, :1])
    except ValueError as exc:
        print(f"  mixed_step is refused: {exc}")
    else:
        raise AssertionError(f"{HYBRID}: mixed_step ran")
    if hybrid_spec(policy="auto").resolved_policy != "bucketed":
        raise AssertionError(f"{HYBRID}: 'auto' did not resolve to bucketed")


def hybrid_serving(params, dev, g) -> dict:
    """Phase 16b: recurrentgemma-2b in bf16 (seeded random weights) on
    dense + bucketed, ``HYBRID_ENGINE``'s geometry, 8 greedy requests of
    ``HYBRID_PROMPTS`` tokens x ``HYBRID_NEW`` new, graphed (first, warm,
    then a traced warm drain) and eager, both engines resident:
    ``bucketed_engine_line``'s gates (graphed = eager, one capture per
    bucket used and one of the decode program, launches =
    ``program_launches``), no mixed program; tok/s, device ms by kernel,
    idle share and the peak memory printed."""
    cfg = hybrid_cut()
    rs = np.random.default_rng(16)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in HYBRID_PROMPTS]
    buckets = engine_mod._buckets(HYBRID_ENGINE["max_len"])
    used = sorted({next(b for b in buckets if b >= n)
                   for n in HYBRID_PROMPTS})
    print(f"\n== serving {HYBRID} in bf16 on dense + bucketed: "
          f"{len(prompts)} greedy requests of {HYBRID_PROMPTS} tokens x "
          f"{HYBRID_NEW} new, max_batch {HYBRID_ENGINE['max_batch']}, "
          f"max_len {HYBRID_ENGINE['max_len']}, buckets {buckets} "
          f"({used} used), the kernel path")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spec = hybrid_spec()
    eng = ServingEngine(spec, device="cuda", graphs=True)
    eng.load(params)
    first = drain(eng, prompts, max_new=HYBRID_NEW)
    first["warm"] = drain(eng, prompts, max_new=HYBRID_NEW)
    traced = drain(eng, prompts, measure="profile", max_new=HYBRID_NEW)
    eager = ServingEngine(spec, device="cuda", graphs=False)
    eager.load(params)
    runs = {"graphed": first, "eager": drain(eager, prompts,
                                             max_new=HYBRID_NEW)}
    peak = torch.cuda.max_memory_allocated() / 1e9
    programs = dict(eng._programs)
    del eng, eager
    label = f"{HYBRID} dense + bucketed"
    bucketed_engine_line(label, cfg, "bucketed", "dense", runs, len(prompts),
                         PATH_KERNELS["hybrid"], max_new=HYBRID_NEW)
    if first["compilations"]["prefill_buckets"] != len(used) \
            or programs.get("mixed"):
        raise AssertionError(f"{label}: programs {programs}; want one "
                             f"capture per bucket of {used} and no mixed "
                             "program")
    warm = first["warm"]
    n_tok = len(prompts) * HYBRID_NEW
    print(f"  {label}: tok/s graphed first {n_tok / first['dt']:.1f}, warm "
          f"{n_tok / warm['dt']:.1f}, eager "
          f"{n_tok / runs['eager']['dt']:.1f}; {sum(HYBRID_PROMPTS)} prompt "
          f"tokens in {len(prompts)} prefills, {warm['steps']} decode steps")
    dev_s = traced["device_s"]
    if dev_s is None:
        print("  the profiler traced no device activity: device time and "
              "idle share not measured")
    else:
        idle = 1 - dev_s / warm["dt"]
        print(f"  {label}, warm drain traced: {dev_s * 1e3:.1f} ms of device "
              f"time; idle {idle:.3f} of the untraced warm drain's "
              f"{warm['dt']:.3f} s ({1 - dev_s / traced['dt']:.3f} of the "
              f"traced drain's {traced['dt']:.3f} s); the 10 longest "
              "kernels:")
        for key, calls_n, ms in traced["top"][:10]:
            print(f"    {key[:90]:<90} {calls_n:>6} {ms:9.3f} "
                  f"{ms / (dev_s * 1e3):6.1%}")
        scan = [(k, c, ms) for k, c, ms in traced["kernels"]
                if "rglru_scan" in k]
        print(f"  rglru_scan in the traced drain: {scan}")
    print(f"  {label}: max_memory_allocated {peak:.2f} GB (graphed and eager "
          f"engines resident; a {buckets[-1]}-token bucket's prefill returns "
          f"[1, {buckets[-1]}, {cfg.vocab_size}] float32 logits, "
          f"{buckets[-1] * cfg.vocab_size * 4 / 1e9:.2f} GB)")
    return {"hybrid": first["launches"]}


def check_hybrid(dev, g) -> dict:
    """Phase 16 on recurrentgemma-2b at its published widths and
    ``HYBRID_LAYERS`` of its 26 layers: 16a's f32 steps
    (``hybrid_steps``), then 16b's bf16 serving (``hybrid_serving``) from
    the same weights."""
    t_start = time.perf_counter()
    cfg = hybrid_cut()
    model32 = Model(cfg, compute_dtype=torch.float32, device=dev,
                    matmul_backend="pallas").init(g)
    n_params = sum(t.numel() for t in model32.parameters())
    layer_params = n_params - cfg.vocab_size * cfg.d_model
    print(f"\n== phase 16: {HYBRID}, {n_params / 1e9:.3f} G parameters "
          f"({layer_params / 1e9:.3f} G in the layers, "
          f"{layer_params * 2 / 1e9:.2f} GB in bf16)")
    hybrid_steps(model32, dev, g)
    print(f"  (a) took {time.perf_counter() - t_start:.1f} s")
    params = model32.state_dict()
    del model32
    launches = hybrid_serving(params, dev, g)
    del params
    torch.cuda.empty_cache()
    print(f"  phase 16 took {time.perf_counter() - t_start:.1f} s")
    return launches


SSM = "falcon-mamba-7b"
# 17a: an f32 prefill of a prompt past a bucket boundary (1100 real tokens
# in the 2048-token bucket, its length the prefill's ``lengths``), then
# decode steps, at full width and SSM_STEP_LAYERS of the 64 layers (the
# plain scan loop dispatches ~15 operators a position and layer)
SSM_PREFILL, SSM_BUCKET, SSM_DECODE = 1100, 2048, 4
SSM_STEP_LAYERS = 8
# 17b: 32 of the 64 layers (all 64 until phase 20 joined; cut for run
# time), phase 16's geometry and mix (buckets 32-3072)
SSM_LAYERS = 32
SSM_ENGINE = HYBRID_ENGINE
SSM_PROMPTS = HYBRID_PROMPTS
SSM_NEW = 32


def ssm_cut(layers: int) -> ArchConfig:
    return dataclasses.replace(get_config(SSM), num_layers=layers)


def ssm_spec(cfg: ArchConfig, compute: str = "bf16",
             policy: str = "bucketed", layout: str = "dense") -> RuntimeSpec:
    """Phase 17's spec on the kernel path: falcon-mamba-7b on the dense
    layout and the bucketed scheduler (the only path the reference allows
    the family)."""
    return RuntimeSpec(
        arch=cfg,
        execution=ExecutionSpec(matmul_backend="pallas",
                                paged_attn_impl="pallas",
                                compute_dtype=compute),
        memory=MemorySpec(cache_layout=layout, **SSM_ENGINE),
        scheduler=SchedulerSpec(policy=policy))


def ssm_steps(model: Model, dev, g) -> None:
    """Phase 17a on the f32 model: ``Model.prefill`` of ``SSM_PREFILL``
    real tokens right-padded to the ``SSM_BUCKET`` bucket (``lengths``, as
    the engine's bucketed admission stages it) and ``SSM_DECODE`` decode
    steps over its state, along the kernels and their plain versions
    (``STEP_PATHS``; the plain loop in place of ``ssm_scan``), each within
    phase 4's gate, 2e-2 x max|logits| (the real positions' logits); the
    kernel path's launches against ``program_launches``.  Then the spec
    refuses the paged layout and the chunked scheduler, ``mixed_step``
    raises, and "auto" resolves to the bucketed scheduler."""
    cfg = model.cfg
    P, S, D = SSM_PREFILL, SSM_BUCKET, SSM_DECODE
    toks = torch.randint(0, cfg.vocab_size, (1, P + D), generator=g,
                         device=dev, dtype=torch.int32)
    padded = torch.zeros(1, S, dtype=torch.int32, device=dev)
    padded[:, :P] = toks[:, :P]
    lengths = torch.tensor([P], dtype=torch.int32, device=dev)
    print(f"\n== {SSM} at its published widths ({cfg.num_layers} of 64 "
          f"layers, d_model {cfg.d_model}, d_inner "
          f"{cfg.ssm.expand * cfg.d_model}, state {cfg.ssm.state_dim}, conv "
          f"{cfg.ssm.conv_kernel}, dt_rank {cfg.ssm.dt_rank}, vocab "
          f"{cfg.vocab_size}), f32 compute: a prefill of {P} tokens in the "
          f"{S}-token bucket + {D} decode steps, |kernels - plain versions| "
          "(gated)")
    out = {}
    for path in ("kernels", "plain versions"):
        _, ctx = STEP_PATHS[path]
        zero_counts()
        with ctx():
            logits, cache = model.prefill(padded, S, lengths=lengths)
            res = [logits[0, :P]]
            made = launch_counts()
            for t in range(P, P + D):
                res.append(model.decode_step(
                    cache, toks[:, t:t + 1],
                    torch.tensor([t], dtype=torch.int32, device=dev))[0, 0])
        out[path] = res
        del cache, logits
        if path == "kernels":
            want = program_launches(cfg, "prefill", layout="dense")
            have = {n: made[n] for n in want}
            print(f"  the kernel path's prefill launched {have} "
                  f"(kernels/counts.py: {want})")
            if have != want:
                raise AssertionError(f"{SSM} prefill: launches {have} != "
                                     f"{want}")
    cases = [f"prefill of {P} in {S}"] + [f"decode step at {t}"
                                          for t in range(P, P + D)]
    for i, case in enumerate(cases):
        ref = out["plain versions"][i]
        tol = LOGIT_TOL * float(ref.abs().max())
        err = max_err(out["kernels"][i], ref)
        print(f"  {case}: kernels {err:.4g}, tol {LOGIT_TOL} x max|logits| "
              f"= {tol:.4g}")
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{SSM} {case}: kernels {err} > {tol}")
    for kw in (dict(policy="chunked"), dict(layout="paged")):
        try:
            ssm_spec(cfg, **kw)
        except ValueError as exc:
            print(f"  {kw} is refused: {exc}")
        else:
            raise AssertionError(f"{SSM}: a spec with {kw} was accepted")
    try:
        model.mixed_step(None, toks[:, :1], toks[0, :1], toks[0, :1])
    except ValueError as exc:
        print(f"  mixed_step is refused: {exc}")
    else:
        raise AssertionError(f"{SSM}: mixed_step ran")
    if ssm_spec(cfg, policy="auto").resolved_policy != "bucketed":
        raise AssertionError(f"{SSM}: 'auto' did not resolve to bucketed")


def ssm_serving(params, cfg: ArchConfig) -> dict:
    """Phase 17b: falcon-mamba-7b in bf16 (seeded random weights) on dense
    + bucketed, ``SSM_ENGINE``'s geometry, 8 greedy requests of
    ``SSM_PROMPTS`` tokens x ``SSM_NEW`` new, graphed (first, warm, then a
    traced warm drain) and eager, both engines resident:
    ``bucketed_engine_line``'s gates (graphed = eager, one capture per
    bucket used and one of the decode program, launches =
    ``program_launches``), no mixed program; tok/s, device ms by kernel,
    idle share and the peak memory printed."""
    rs = np.random.default_rng(17)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in SSM_PROMPTS]
    buckets = engine_mod._buckets(SSM_ENGINE["max_len"])
    used = sorted({next(b for b in buckets if b >= n) for n in SSM_PROMPTS})
    print(f"\n== serving {SSM} in bf16 on dense + bucketed, "
          f"{cfg.num_layers} layers: {len(prompts)} greedy requests of "
          f"{SSM_PROMPTS} tokens x {SSM_NEW} new, max_batch "
          f"{SSM_ENGINE['max_batch']}, max_len {SSM_ENGINE['max_len']}, "
          f"buckets {buckets} ({used} used), the kernel path")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spec = ssm_spec(cfg)
    eng = ServingEngine(spec, device="cuda", graphs=True)
    eng.load(params)
    eager = ServingEngine(spec, device="cuda", graphs=False)
    eager.load(params)
    t0 = time.perf_counter()
    first = drain(eng, prompts, max_new=SSM_NEW)
    first["warm"] = drain(eng, prompts, max_new=SSM_NEW)
    traced = drain(eng, prompts, measure="profile", max_new=SSM_NEW)
    runs = {"graphed": first, "eager": drain(eager, prompts,
                                             max_new=SSM_NEW)}
    print(f"  four drains took {time.perf_counter() - t0:.1f} s")
    peak = torch.cuda.max_memory_allocated() / 1e9
    programs = dict(eng._programs)
    del eng, eager
    label = f"{SSM} dense + bucketed"
    bucketed_engine_line(label, cfg, "bucketed", "dense", runs, len(prompts),
                         PATH_KERNELS["ssm"], max_new=SSM_NEW)
    if first["compilations"]["prefill_buckets"] != len(used) \
            or programs.get("mixed"):
        raise AssertionError(f"{label}: programs {programs}; want one "
                             f"capture per bucket of {used} and no mixed "
                             "program")
    warm = first["warm"]
    n_tok = len(prompts) * SSM_NEW
    print(f"  {label}: tok/s graphed first {n_tok / first['dt']:.1f}, warm "
          f"{n_tok / warm['dt']:.1f}, eager "
          f"{n_tok / runs['eager']['dt']:.1f}; {sum(SSM_PROMPTS)} prompt "
          f"tokens in {len(prompts)} prefills, {warm['steps']} decode steps")
    dev_s = traced["device_s"]
    if dev_s is None:
        print("  the profiler traced no device activity: device time and "
              "idle share not measured")
    else:
        idle = 1 - dev_s / warm["dt"]
        print(f"  {label}, warm drain traced: {dev_s * 1e3:.1f} ms of device "
              f"time; idle {idle:.3f} of the untraced warm drain's "
              f"{warm['dt']:.3f} s ({1 - dev_s / traced['dt']:.3f} of the "
              f"traced drain's {traced['dt']:.3f} s); the 12 longest "
              "kernels:")
        for key, calls_n, ms in traced["top"][:12]:
            print(f"    {key[:90]:<90} {calls_n:>6} {ms:9.3f} "
                  f"{ms / (dev_s * 1e3):6.1%}")
        scan = [(k, c, ms) for k, c, ms in traced["kernels"]
                if "ssm_scan" in k]
        print(f"  ssm_scan in the traced drain: {scan}")
    print(f"  {label}: max_memory_allocated {peak:.2f} GB (graphed and eager "
          f"engines resident with the source weights; a {buckets[-1]}-token "
          f"bucket's prefill returns [1, {buckets[-1]}, {cfg.vocab_size}] "
          f"float32 logits, {buckets[-1] * cfg.vocab_size * 4 / 1e9:.2f} GB)")
    return {"ssm": first["launches"]}


def ssm_step_times(model: Model, dev, g) -> None:
    """Phase 17c on the bf16 model at every layer: one decode step of
    ``SSM_ENGINE``'s 8 slots, captured as a CUDA graph and replayed, and
    one prefill of a 3072-token prompt (eager: it is device-bound), each
    timed by ``Timer`` (median, L2 flushed) beside its bound: the decode
    step's bytes (the bf16 layers, the f32 ``lm_head`` and the f32 states
    read and written once) at 3.35 TB/s; the prefill's products at 989
    TFLOP/s plus its f32 unembed of every lane at 67."""
    cfg, timer = model.cfg, Timer(dev)
    B, S = SSM_ENGINE["max_batch"], SSM_ENGINE["max_len"]
    d_inner = cfg.ssm.expand * cfg.d_model
    cache = model.init_cache(batch=B, max_len=S)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev,
                         dtype=torch.int32)
    idx = torch.full((B,), 100, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            model.decode_step(cache, toks, idx)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        model.decode_step(cache, toks, idx)
    dec_ms = timer(graph.replay)
    layer_bytes = sum(t.numel() * t.element_size() for n, t in
                      model.named_parameters() if n.startswith("layers."))
    state_bytes = sum(t.numel() * t.element_size() for t in cache)
    dec_bound, _ = bound_ms(layer_bytes + cfg.vocab_size * cfg.d_model * 4
                            + 2 * state_bytes, 0, torch.bfloat16)
    del graph, cache
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                           device=dev, dtype=torch.int32)
    pre_ms = timer(lambda: model.prefill(prompt, S), reps=3, warm=1)
    flops = 2 * S * cfg.num_layers * (
        cfg.d_model * 2 * d_inner + d_inner * (cfg.ssm.dt_rank
                                               + 2 * cfg.ssm.state_dim)
        + cfg.ssm.dt_rank * d_inner + d_inner * cfg.d_model)
    unembed = 2 * S * cfg.vocab_size * cfg.d_model
    pre_bound = bound_ms(0, flops, torch.bfloat16)[0] \
        + bound_ms(0, unembed, torch.float32)[0]
    print(f"  decode step, {B} slots, graphed: {dec_ms:.3f} ms; bound "
          f"{dec_bound:.3f} ms ({layer_bytes / 1e9:.2f} GB of layers, the "
          f"{cfg.vocab_size * cfg.d_model * 4 / 1e9:.2f} GB f32 lm_head, "
          f"{state_bytes / 1e9:.3f} GB of states read and written)")
    print(f"  {S}-token prefill, eager: {pre_ms:.3f} ms; bound "
          f"{pre_bound:.3f} ms ({flops / 1e12:.2f} TFLOP of layer products "
          f"at 989 TFLOP/s, {unembed / 1e12:.2f} TFLOP of f32 unembed at "
          f"67)")


def check_ssm(dev, g) -> dict:
    """Phase 17 on falcon-mamba-7b at its published widths: 17a's f32 steps
    at ``SSM_STEP_LAYERS`` layers (``ssm_steps``), then 17b's bf16 serving
    at ``SSM_LAYERS`` (``ssm_serving``), each from its own seeded weights,
    and 17c's decode step and prefill times (``ssm_step_times``)."""
    t_start = time.perf_counter()
    model32 = Model(ssm_cut(SSM_STEP_LAYERS), compute_dtype=torch.float32,
                    device=dev, matmul_backend="pallas").init(g)
    ssm_steps(model32, dev, g)
    del model32
    torch.cuda.empty_cache()
    print(f"  (a) took {time.perf_counter() - t_start:.1f} s")
    cfg = ssm_cut(SSM_LAYERS)
    model = Model(cfg, device=dev, matmul_backend="pallas").init(g)
    n_params = sum(t.numel() for t in model.parameters())
    tables = 2 * cfg.vocab_size * cfg.d_model
    print(f"\n== phase 17: {SSM} at depth {cfg.num_layers} of 64, "
          f"{n_params / 1e9:.3f} G parameters ({(n_params - tables) / 1e9:.3f}"
          f" G in the layers, {(n_params - tables) * 2 / 1e9:.2f} GB in "
          f"bf16; the untied f32 tables {tables * 4 / 1e9:.2f} GB)")
    params = model.state_dict()
    launches = ssm_serving(params, cfg)
    ssm_step_times(model, dev, g)
    del model, params
    torch.cuda.empty_cache()
    print(f"  phase 17 took {time.perf_counter() - t_start:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the audio family (whisper-medium)
# ---------------------------------------------------------------------------
AUDIO = "whisper-medium"
# 18a: f32 at 4 of the 24 encoder and 4 of the 24 decoder layers
AUDIO_STEP_LAYERS = 4
AUDIO_DECODE = 4
# 18b: every layer, dense + bucketed at 8 slots of 512 positions (buckets
# 32-512); decoder prompts of 4-224 tokens (whisper's prompt limit is half
# its 448-token decoder context) over four buckets, 32 new tokens each
AUDIO_ENGINE = dict(max_batch=8, max_len=512)
AUDIO_PROMPTS = (4, 17, 33, 60, 100, 150, 200, 224)
AUDIO_NEW = 32


def audio_cut(layers: int) -> ArchConfig:
    full = get_config(AUDIO)
    return dataclasses.replace(full, num_layers=layers, encdec=dataclasses
                               .replace(full.encdec,
                                        num_encoder_layers=layers))


def audio_spec(cfg: ArchConfig, policy: str = "bucketed",
               layout: str = "dense") -> RuntimeSpec:
    """Phase 18's spec on the kernel path: whisper-medium in bf16 on the
    dense layout and the bucketed scheduler (the only path the reference
    gives the family)."""
    return RuntimeSpec(
        arch=cfg, execution=ExecutionSpec(matmul_backend="pallas"),
        memory=MemorySpec(cache_layout=layout, **AUDIO_ENGINE),
        scheduler=SchedulerSpec(policy=policy))


def audio_steps(dev, g) -> None:
    """Phase 18a at f32 compute and ``AUDIO_STEP_LAYERS`` + as many
    encoder layers, seeded weights: the kernel path (``tiled_matmul``,
    ``layernorm``) against the plain route (``"xla"``, the same weights):
    ``forward`` of 64 tokens over 1500 seeded frames, then ``prefill`` of
    a 40-token prompt right-padded to its 64-token bucket with the zero
    frames (as the engine stages it) and ``AUDIO_DECODE`` decode steps,
    each within phase 4's gate, 2e-2 x max|logits| (the real positions'
    logits); the prefill's and a step's launches against
    ``program_launches``.  Then the spec refuses the paged layout and the
    chunked scheduler, ``mixed_step`` raises, "auto" resolves to the
    bucketed scheduler."""
    cfg = audio_cut(AUDIO_STEP_LAYERS)
    frames = cfg.encdec.encoder_seq_len
    kern = Model(cfg, compute_dtype=torch.float32, device=dev,
                 matmul_backend="pallas").init(g)
    plain = Model(cfg, compute_dtype=torch.float32, device=dev)
    plain.load_state_dict(kern.state_dict())
    P, S, D = 40, 64, AUDIO_DECODE
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=g, device=dev,
                         dtype=torch.int32)
    fe = torch.randn(1, frames, cfg.d_model, generator=g, device=dev)
    zeros = torch.zeros(1, frames, cfg.d_model, dtype=torch.bfloat16,
                        device=dev)
    padded = torch.zeros(1, S, dtype=torch.int32, device=dev)
    padded[:, :P] = toks[:, :P]
    lengths = torch.tensor([P], dtype=torch.int32, device=dev)
    print(f"\n== {AUDIO} at its published widths ({cfg.num_layers} + "
          f"{cfg.encdec.num_encoder_layers} of 24 + 24 layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.resolved_head_dim},"
          f" d_ff {cfg.d_ff}, {frames} frames, vocab {cfg.vocab_size}), f32 "
          f"compute: forward of {S} tokens over seeded frames, a prefill of "
          f"{P} tokens in the {S}-token bucket + {D} decode steps, |kernels "
          "- plain route| (gated)")
    out = {}
    for path, model in (("kernels", kern), ("plain route", plain)):
        zero_counts()
        res = [model.forward(toks, fe)[0]]
        fwd = launch_counts()
        zero_counts()
        logits, cache = model.prefill(padded, AUDIO_ENGINE["max_len"], zeros,
                                      lengths=lengths)
        res.append(logits[0, :P])
        made = launch_counts()
        for t in range(P, P + D):
            zero_counts()
            res.append(model.decode_step(cache, toks[:, t:t + 1], torch.tensor(
                [t], dtype=torch.int32, device=dev))[0, 0])
        step = launch_counts()
        out[path] = res
        del cache, logits
        if path == "kernels":
            for program, have_all in (("prefill", made), ("decode", step)):
                want = program_launches(cfg, program, layout="dense")
                have = {n: have_all[n] for n in want}
                print(f"  the kernel path's {program} launched {have} "
                      f"(kernels/counts.py: {want})")
                if have != want:
                    raise AssertionError(f"{AUDIO} {program}: launches "
                                         f"{have} != {want}")
            print(f"  forward launched tiled_matmul {fwd['tiled_matmul']}, "
                  f"layernorm {fwd['layernorm']}")
        elif any(made[n] or step[n] or fwd[n] for n in made):
            raise AssertionError(f"{AUDIO}: the plain route launched a "
                                 "kernel")
    cases = [f"forward of {S}", f"prefill of {P} in {S}"] + [
        f"decode step at {t}" for t in range(P, P + D)]
    for i, case in enumerate(cases):
        ref = out["plain route"][i]
        tol = LOGIT_TOL * float(ref.abs().max())
        err = max_err(out["kernels"][i], ref)
        print(f"  {case}: kernels {err:.4g}, tol {LOGIT_TOL} x max|logits| "
              f"= {tol:.4g}")
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{AUDIO} {case}: kernels {err} > {tol}")
    for kw in (dict(policy="chunked"), dict(layout="paged")):
        try:
            audio_spec(cfg, **kw)
        except ValueError as exc:
            print(f"  {kw} is refused: {exc}")
        else:
            raise AssertionError(f"{AUDIO}: a spec with {kw} was accepted")
    try:
        kern.mixed_step(None, toks[:, :1], toks[0, :1], toks[0, :1])
    except ValueError as exc:
        print(f"  mixed_step is refused: {exc}")
    else:
        raise AssertionError(f"{AUDIO}: mixed_step ran")
    if audio_spec(cfg, policy="auto").resolved_policy != "bucketed":
        raise AssertionError(f"{AUDIO}: 'auto' did not resolve to bucketed")


def audio_serving(params, cfg: ArchConfig) -> dict:
    """Phase 18b: whisper-medium in bf16 (seeded random weights) at every
    layer on dense + bucketed, ``AUDIO_ENGINE``'s geometry, 8 greedy
    requests of ``AUDIO_PROMPTS`` decoder tokens x ``AUDIO_NEW`` new (the
    frames the stub's zeros), graphed (first, warm, then a traced warm
    drain) and eager, both engines resident: ``bucketed_engine_line``'s
    gates (graphed = eager, one capture per bucket used and one of the
    decode program, launches = ``program_launches``), no mixed program;
    tok/s, device ms by kernel, idle share and the peak memory printed."""
    rs = np.random.default_rng(18)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in AUDIO_PROMPTS]
    buckets = engine_mod._buckets(AUDIO_ENGINE["max_len"])
    used = sorted({next(b for b in buckets if b >= n) for n in AUDIO_PROMPTS})
    print(f"\n== serving {AUDIO} in bf16 on dense + bucketed, "
          f"{cfg.num_layers} + {cfg.encdec.num_encoder_layers} layers: "
          f"{len(prompts)} greedy requests of {AUDIO_PROMPTS} decoder tokens "
          f"x {AUDIO_NEW} new over the stub's zero frames, max_batch "
          f"{AUDIO_ENGINE['max_batch']}, max_len {AUDIO_ENGINE['max_len']}, "
          f"buckets {buckets} ({used} used), the kernel path")
    if len(used) < 4:
        raise AssertionError(f"{AUDIO}: the mix uses buckets {used}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spec = audio_spec(cfg)
    eng = ServingEngine(spec, device="cuda", graphs=True)
    eng.load(params)
    eager = ServingEngine(spec, device="cuda", graphs=False)
    eager.load(params)
    t0 = time.perf_counter()
    first = drain(eng, prompts, max_new=AUDIO_NEW)
    first["warm"] = drain(eng, prompts, max_new=AUDIO_NEW)
    traced = drain(eng, prompts, measure="profile", max_new=AUDIO_NEW)
    runs = {"graphed": first, "eager": drain(eager, prompts,
                                             max_new=AUDIO_NEW)}
    print(f"  four drains took {time.perf_counter() - t0:.1f} s")
    peak = torch.cuda.max_memory_allocated() / 1e9
    programs = dict(eng._programs)
    cross = sum(t.numel() * t.element_size()
                for t in (eng.cache.cross_k, eng.cache.cross_v))
    del eng, eager
    label = f"{AUDIO} dense + bucketed"
    bucketed_engine_line(label, cfg, "bucketed", "dense", runs, len(prompts),
                         PATH_KERNELS["audio"], max_new=AUDIO_NEW)
    if first["compilations"]["prefill_buckets"] != len(used) \
            or programs.get("mixed"):
        raise AssertionError(f"{label}: programs {programs}; want one "
                             f"capture per bucket of {used} and no mixed "
                             "program")
    warm = first["warm"]
    n_tok = len(prompts) * AUDIO_NEW
    print(f"  {label}: tok/s graphed first {n_tok / first['dt']:.1f}, warm "
          f"{n_tok / warm['dt']:.1f}, eager "
          f"{n_tok / runs['eager']['dt']:.1f}; {len(prompts)} prefills "
          f"({sum(AUDIO_PROMPTS)} decoder prompt tokens, "
          f"{len(prompts)} x {cfg.encdec.encoder_seq_len} frames), "
          f"{warm['steps']} decode steps")
    dev_s = traced["device_s"]
    if dev_s is None:
        print("  the profiler traced no device activity: device time and "
              "idle share not measured")
    else:
        idle = 1 - dev_s / warm["dt"]
        print(f"  {label}, warm drain traced: {dev_s * 1e3:.1f} ms of device "
              f"time; idle {idle:.3f} of the untraced warm drain's "
              f"{warm['dt']:.3f} s ({1 - dev_s / traced['dt']:.3f} of the "
              f"traced drain's {traced['dt']:.3f} s); the 12 longest "
              "kernels:")
        for key, calls_n, ms in traced["top"][:12]:
            print(f"    {key[:90]:<90} {calls_n:>6} {ms:9.3f} "
                  f"{ms / (dev_s * 1e3):6.1%}")
        for name in ("mma_", "norm_"):
            rows = [(k, c, ms) for k, c, ms in traced["kernels"] if name in k]
            print(f"  {name}* in the traced drain: {len(rows)} kernels, "
                  f"{sum(c for _, c, _ in rows)} calls, "
                  f"{sum(ms for _, _, ms in rows):.3f} ms")
    print(f"  {label}: max_memory_allocated {peak:.2f} GB (graphed and eager "
          f"engines resident with the source weights; each engine's cross "
          f"rows {cross / 1e9:.3f} GB, {cross / 8e6:.1f} MB a slot)")
    return {"audio": first["launches"]}


def audio_step_times(model: Model, dev, g) -> None:
    """Phase 18d on the bf16 model at every layer: one decode step of
    ``AUDIO_ENGINE``'s 8 slots at position 100, captured as a CUDA graph
    and replayed, and one prefill of a 256-token bucket with the zero
    frames (eager: it is device-bound), each timed by ``Timer`` (median,
    L2 flushed) beside its bound.  The decode step is bounded by bytes:
    the decoder's layers, the f32 ``lm_head`` table, the 8 slots' cross
    rows and their self rows up to the position read once, the new self
    rows written, at 3.35 TB/s.  The prefill by operations: the encoder's
    products and attention over the frames, the cross K/V, the decoder's
    products, self- and cross-attention at 989 TFLOP/s, its f32 unembed of
    every lane at 67."""
    cfg, timer = model.cfg, Timer(dev)
    B, M = AUDIO_ENGINE["max_batch"], AUDIO_ENGINE["max_len"]
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    Le, F = cfg.encdec.num_encoder_layers, cfg.encdec.encoder_seq_len
    cache = model.init_cache(batch=B, max_len=M)
    pos = 100
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev,
                         dtype=torch.int32)
    idx = torch.full((B,), pos, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            model.decode_step(cache, toks, idx)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        model.decode_step(cache, toks, idx)
    dec_ms = timer(graph.replay)
    layer_bytes = sum(t.numel() * t.element_size() for n, t in
                      model.named_parameters() if n.startswith("layers."))
    cross_bytes = sum(t.numel() * t.element_size()
                      for t in (cache.cross_k, cache.cross_v))
    row = cfg.num_kv_heads * cfg.resolved_head_dim * 2
    self_bytes = 2 * L * B * (pos + 2) * row
    head = cfg.vocab_size * d * 4
    dec_bound, _ = bound_ms(layer_bytes + head + cross_bytes + self_bytes,
                            0, torch.bfloat16)
    del graph, cache
    S = 256
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                           device=dev, dtype=torch.int32)
    zeros = torch.zeros(1, F, d, dtype=torch.bfloat16, device=dev)
    pre_ms = timer(lambda: model.prefill(prompt, M, zeros), reps=3, warm=1)
    enc = 2 * F * Le * (4 * d * d + 2 * d * ff) + 4 * F * F * d * Le
    cross_kv = 2 * F * L * 2 * d * d
    dec = 2 * S * L * (6 * d * d + 2 * d * ff) + 2 * S * S * d * L \
        + 4 * S * F * d * L
    unembed = 2 * S * cfg.vocab_size * d
    pre_bound = bound_ms(0, enc + cross_kv + dec, torch.bfloat16)[0] \
        + bound_ms(0, unembed, torch.float32)[0]
    print(f"  decode step, {B} slots at position {pos}, graphed: "
          f"{dec_ms:.3f} ms; bound {dec_bound:.3f} ms "
          f"({layer_bytes / 1e9:.3f} GB of decoder layers, the "
          f"{head / 1e9:.3f} GB f32 lm_head, {cross_bytes / 1e9:.3f} GB of "
          f"cross rows, {self_bytes / 1e9:.4f} GB of self rows)")
    print(f"  {S}-token prefill (encoder over {F} frames included), eager: "
          f"{pre_ms:.3f} ms; bound {pre_bound:.3f} ms "
          f"({enc / 1e12:.3f} TFLOP encoder, {cross_kv / 1e12:.3f} cross "
          f"K/V, {dec / 1e12:.3f} decoder at 989 TFLOP/s, "
          f"{unembed / 1e12:.3f} TFLOP of f32 unembed at 67)")


def check_audio(dev, g) -> dict:
    """Phase 18 on whisper-medium at its published widths: 18a's f32
    steps at ``AUDIO_STEP_LAYERS`` + as many encoder layers
    (``audio_steps``), then 18b's bf16 serving at all 24 + 24 layers
    (``audio_serving``) and 18d's decode step and prefill times
    (``audio_step_times``), each from its own seeded weights.  (Phase 2
    holds 18c's kernels at whisper's shapes.)"""
    t_start = time.perf_counter()
    audio_steps(dev, g)
    torch.cuda.empty_cache()
    print(f"  (a) took {time.perf_counter() - t_start:.1f} s")
    cfg = get_config(AUDIO)
    model = Model(cfg, device=dev, matmul_backend="pallas").init(g)
    n_params = sum(t.numel() for t in model.parameters())
    print(f"\n== phase 18: {AUDIO} at depth {cfg.num_layers} + "
          f"{cfg.encdec.num_encoder_layers}, {n_params / 1e9:.3f} G "
          "parameters")
    params = model.state_dict()
    launches = audio_serving(params, cfg)
    audio_step_times(model, dev, g)
    del model, params
    torch.cuda.empty_cache()
    print(f"  phase 18 took {time.perf_counter() - t_start:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 19: the paper's encoders as models, the cost model, the tile planner
# and the autotuner on the card
# ---------------------------------------------------------------------------
# 19a: 8 sequences of 64 tokens (the paper's sequence length) on each
# network; adaptor-bert also one sequence of its 512 positions
ENC_RUNS = {"adaptor-bert": ((8, 64), (1, 512)),
            "shallow-transformer": ((8, 64),),
            "custom-encoder": ((8, 64),)}
# 19b: Table 1 (sequence 64, batch 1 and 128), Table 2's rows (network,
# sequence, d_model; d_ff 4 x d_model and head_dim d_model // heads where
# d_model moves: benchmarks/table2_analytical.py ROWS), the calibration's
# qwen1.5-0.5b points (layers, tokens), the planner's budgets and
# workloads (benchmarks/fig5_tilesize.py: BERT's MHA projection and FFN1
# at 4096 tokens; fig11_portability.py: custom-encoder at 64 tokens, and
# 64 sequences of them)
TABLE1_BATCHES = (1, 128)
TABLE2_ROWS = (("adaptor-bert", 64, 768), ("adaptor-bert", 128, 768),
               ("adaptor-bert", 64, 512), ("shallow-transformer", 64, 512),
               ("custom-encoder", 64, 200))
CAL_POINTS = ((1, 64), (3, 512), (3, 1024), (4, 2048))
CAL_RHO = 0.8
PLAN_BUDGETS = (227 * 1024, 100 * 1024, 48 * 1024)
PLAN_WORKLOADS = (("fig5 mha_proj", 4096, 768, 768),
                  ("fig5 ffn1", 4096, 768, 3072),
                  ("fig11 mha_proj", 64, 200, 198),
                  ("fig11 ffn1", 64, 200, 800),
                  ("fig11 ffn1_batched", 4096, 200, 800))


def capture_graph(fn):
    """``fn`` warmed on a side stream, then captured as a CUDA graph;
    returns the graph and the output tensors it writes on replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def forward_bound(model: Model, B: int, S: int) -> tuple[float, str]:
    """The least time a forward of B x S tokens could take: the products
    and the attends at 989 TFLOP/s (bf16), the float32 unembed at 67;
    against the bytes: every layer weight and the unembedding table read
    once, the tokens' embedding and position rows, the logits written
    (float32), at 3.35 TB/s."""
    cfg, T = model.cfg, B * S
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    qw = cfg.num_heads * cfg.resolved_head_dim
    kvw = cfg.num_kv_heads * cfg.resolved_head_dim
    ffn = (3 if layers_mod.is_gated(cfg.activation) else 2) * d * cfg.d_ff
    prods = 2 * T * L * (d * (qw + 2 * kvw) + qw * d + ffn)
    attend = 4 * B * S * S * qw * L
    unembed = 2 * T * d * V
    head = model.embed if model.lm_head is None else model.lm_head
    nbytes = sum(t.numel() * t.element_size() for n, t in
                 model.named_parameters() if n.startswith("layers.")) \
        + head.table.numel() * head.table.element_size() \
        + 2 * T * d * 4 + T * V * 4
    t_ops = (prods + attend) / PEAK_FLOPS[torch.bfloat16] \
        + unembed / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def encoder_forwards(timer, dev, g) -> dict:
    """Phase 19a: adaptor-bert, shallow-transformer and custom-encoder at
    their published widths and depths (``configs/*``; custom-encoder's 3
    heads of 200 // 3 = 66, so q/k/v 198 wide, ragged products), seeded
    weights.  ``Model.forward`` of ``ENC_RUNS``'s batches through the
    kernels (``matmul_backend="pallas"``) against the plain route on the
    same weights at float32 compute, gated at phase 4's 2e-2 x
    max|logits|; the launches against ``program_launches(cfg,
    "forward")`` (6L ``tiled_matmul``, 2L + 1 ``layernorm``; counts zeroed
    just before); then in bf16 the distance to the plain route printed,
    and the kernel route's forward timed eager and graphed (``Timer``,
    median, L2 flushed) beside its bound."""
    print("\n== phase 19a: the paper's encoders as models (published widths "
          "and depths, seeded weights): forward, kernels vs the plain route")
    launches = collections.Counter()    # every kernel's, over the forwards
    for name, runs in ENC_RUNS.items():
        cfg = get_config(name)
        kern = Model(cfg, compute_dtype=torch.float32, device=dev,
                     matmul_backend="pallas").init(g)
        sd = kern.state_dict()
        plain = Model(cfg, compute_dtype=torch.float32, device=dev)
        plain.load_state_dict(sd)
        k16 = Model(cfg, device=dev, matmul_backend="pallas")
        k16.load_state_dict(sd)
        p16 = Model(cfg, device=dev)
        p16.load_state_dict(sd)
        print(f"  {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads} heads of {cfg.resolved_head_dim}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}, "
              f"{sum(t.numel() for t in kern.parameters()) / 1e6:.1f} M "
              "parameters")
        for B, S in runs:
            toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                 device=dev, dtype=torch.int32)
            zero_counts()
            got = kern.forward(toks)
            made = launch_counts()
            want = program_launches(cfg, "forward", layout="dense")
            have = {n: made[n] for n in want}
            if have != want or not made["tiled_matmul"] \
                    or not made["layernorm"]:
                raise AssertionError(f"{name} {B}x{S} forward: launches "
                                     f"{have} != {want}")
            launches.update(made)
            ref = plain.forward(toks)
            tol = LOGIT_TOL * float(ref.abs().max())
            err = max_err(got, ref)
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"{name} {B}x{S} f32 forward: kernels "
                                     f"{err} > {tol}")
            g16 = k16.forward(toks)
            err16 = max_err(g16, p16.forward(toks))
            err16_32 = max_err(g16, ref)
            eager = timer(lambda: k16.forward(toks), reps=7, warm=2)
            graph, _ = capture_graph(lambda: k16.forward(toks))
            graphed = timer(graph.replay)
            bms, by = forward_bound(k16, B, S)
            print(f"  {name} {B} x {S}: f32 kernels vs plain {err:.4g} (tol "
                  f"{tol:.4g}); bf16 kernels vs bf16 plain {err16:.4g}, vs "
                  f"f32 plain {err16_32:.4g} (max|logits| "
                  f"{float(ref.abs().max()):.4g}); launches {have}; bf16 "
                  f"forward eager {eager:.4f} ms, graphed {graphed:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})")
            del graph, got, ref, g16
        del kern, plain, k16, p16, sd
        torch.cuda.empty_cache()
    return {"encoder": {n: launches[n] for n in made}}


def power_watts(smi: str) -> float:
    """The power limit of ``nvidia-smi``'s "name, limit W" line."""
    return float(smi.rsplit(",", 1)[1].split()[0])


def graphed_forward_ms(timer, model: Model, B: int, S: int, g) -> float:
    """Median device ms of a graphed forward of B x S seeded tokens."""
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), generator=g,
                         device=model.device, dtype=torch.int32)
    graph, _ = capture_graph(lambda: model.forward(toks))
    ms = timer(graph.replay, reps=9, warm=2)
    del graph
    return ms


def spearman(xs: list, ys: list) -> float:
    """Spearman's rank correlation (tests/test_analytical.py's)."""
    def ranks(vs):
        order = sorted(range(len(vs)), key=lambda i: vs[i])
        r = [0] * len(vs)
        for rank, i in enumerate(order):
            r[i] = rank
        return r
    rx, ry = ranks(xs), ranks(ys)
    n = len(xs)
    d2 = sum((a - b) ** 2 for a, b in zip(rx, ry))
    return 1.0 - 6.0 * d2 / (n * (n * n - 1))


def cost_model(timer, dev, g, watts: float) -> None:
    """Phase 19b: ``core/analytical.py`` (``H100``) against the card.
    Table 1's points (the three networks at 64 tokens, batch 1 and 128)
    and Table 2's rows (batch 1): a graphed bf16 forward on the kernel
    route (median of replays) beside ``analytical_step_seconds``, its
    dominant term, measured over predicted, GFLOP/s (``step_flops``) and
    GFLOP/s/W at the printed power limit.  Gate: the ranking of four
    qwen1.5-0.5b forwards at its published widths (``CAL_POINTS``, whose
    predictions are >= 2x apart) measured as predicted, Spearman rho >=
    0.8 (the reference's calibration test, on the card the profile
    describes).  Then the tile planner's plans and predicted us for the
    Fig. 5 and Fig. 11 workloads under three shared-memory budgets, beside
    the ``tiled_matmul`` kernel's measured ms at each shape."""
    print(f"\n== phase 19b: the cost model (core/analytical.py, "
          f"{analytical.H100.name} data sheet) against the card; bf16 "
          "forwards on the kernel route, graphed")
    print(f"  {'point':<42} {'measured_ms':>11} {'predicted_ms':>12} "
          f"{'dominant':>8} {'ratio':>7} {'GFLOP/s':>10} {'GFLOP/s/W':>9}")

    def row(label, model, B, S):
        shape = ShapeSpec(label, S, B, "prefill")
        pred = analytical.analytical_step_seconds(model.cfg, shape, 1,
                                                  analytical.H100)
        ms = graphed_forward_ms(timer, model, B, S, g)
        gflops = analytical.step_flops(model.cfg, shape)["total"] / 1e9
        rate = gflops / (ms / 1e3)
        print(f"  {label:<42} {ms:>11.4f} {pred.t_total * 1e3:>12.4f} "
              f"{pred.dominant:>8} {ms / (pred.t_total * 1e3):>7.2f} "
              f"{rate:>10.1f} {rate / watts:>9.2f}")
        return ms, pred.t_total * 1e3

    for name in PAPER_NETS:
        model = Model(get_config(name), device=dev,
                      matmul_backend="pallas").init(g)
        for B in TABLE1_BATCHES:
            row(f"table1 {name} {B} x 64", model, B, 64)
        del model
        torch.cuda.empty_cache()
    for name, S, dm in TABLE2_ROWS:
        cfg = get_config(name)
        if dm != cfg.d_model:
            cfg = dataclasses.replace(cfg, d_model=dm, d_ff=4 * dm,
                                      head_dim=dm // cfg.num_heads)
        model = Model(cfg, device=dev, matmul_backend="pallas").init(g)
        row(f"table2 {name} seq {S} d_model {dm}", model, 1, S)
        del model
    torch.cuda.empty_cache()
    qwen = get_config("qwen1.5-0.5b")
    predicted, measured = [], []
    for layers, S in CAL_POINTS:
        model = Model(dataclasses.replace(qwen, num_layers=layers),
                      device=dev, matmul_backend="pallas").init(g)
        ms, pred = row(f"calibration qwen {layers} layers x {S}", model, 1,
                       S)
        measured.append(ms)
        predicted.append(pred)
        del model
        torch.cuda.empty_cache()
    ps = sorted(predicted)
    if not all(b / a >= 2.0 for a, b in zip(ps, ps[1:])):
        raise AssertionError(f"calibration points not 2x apart: {predicted}")
    rho = spearman(predicted, measured)
    print(f"  calibration: Spearman rho of predicted vs measured {rho:.3f} "
          f"(gate >= {CAL_RHO})")
    if rho < CAL_RHO:
        raise AssertionError(f"the cost model ranks the forwards otherwise "
                             f"than the card: rho {rho} < {CAL_RHO}")
    print(f"  tile planner (core/tiling.py) under {PLAN_BUDGETS} B of "
          "shared memory: plan (bm, bk, bn, stages), smem B, predicted us; "
          "tiled_matmul's measured ms and launch at the shape")
    for label, M, K, N in PLAN_WORKLOADS:
        plans = []
        for budget in PLAN_BUDGETS:
            p = tiling.plan_matmul(M, K, N, smem_budget=budget)
            plans.append(f"{budget // 1024}K: ({p.bm}, {p.bk}, {p.bn}, "
                         f"{p.stages}) {p.smem_bytes} B {p.t_total * 1e6:.3f}"
                         " us")
        a = torch.randn(M, K, generator=g, device=dev).bfloat16()
        b = (torch.randn(K, N, generator=g, device=dev)
             / math.sqrt(K)).bfloat16()
        ms = timer(lambda: tiled_matmul(a, b))
        print(f"  {label} {M}x{K}x{N}: " + "; ".join(plans)
              + f" | tiled_matmul {ms:.4f} ms ({mma_grid({})})")


def tuner_on_card(dev, g) -> None:
    """Phase 19c: ``RuntimeSpec.tuned`` for qwen1.5-0.5b at full width on
    ``DeviceProfile`` read from the card (``GPUSpec.from_card``), its
    workload ``WorkloadProfile.from_trace`` of phase 13's bursty trace,
    the kernel route; the trace replayed on the tuned spec's graphed
    engine and on ``naive_default``'s (the dense layout at equal cache
    bytes, "auto").  Printed: each spec's ``summary()`` (the naive one
    scored as the tuner scores), predicted against measured TTFT and ITL,
    tok/s, a first replay (it captures) and a warm one on the same engine.
    Gates: the tuned spec within its budget, every replay finishes every
    request with each lifecycle once, each program captured once on the
    first replay (a bucketed engine's prefill buckets included) and none
    on the warm one."""
    trace = harness_traces()["bursty"]
    cfg = get_config("qwen1.5-0.5b")
    device = harness.DeviceProfile(gpu=analytical.GPUSpec.from_card(dev))
    workload = harness.WorkloadProfile.from_trace(trace)
    ex = ExecutionSpec(matmul_backend="pallas", paged_attn_impl="pallas",
                       compute_dtype="bf16")
    res = harness.tune(cfg, device, workload, execution=ex)
    tuned = res.spec
    if RuntimeSpec.tuned(cfg, device, workload, execution=ex) != tuned:
        raise AssertionError("RuntimeSpec.tuned differs from tune().spec")
    naive = harness.naive_default(cfg, tuned)
    print(f"\n== phase 19c: the autotuner on the card ({device.gpu.name}, "
          f"{device.gpu.hbm_bytes / 1e9:.2f} GB, {device.gpu.n_sms} SMs): "
          f"qwen1.5-0.5b at full width, {len(res.ranked)} candidates under "
          f"a {res.budget_bytes / 1e9:.3f} GB cache budget; workload from "
          f"the bursty trace ({len(trace)} requests, mean prompt "
          f"{workload.mean_prompt_len:.1f}, bursts of "
          f"{workload.burst_size}, {workload.mean_new_tokens:.1f} new)")
    if cache_bytes(tuned) > res.budget_bytes:
        raise AssertionError(f"the tuned spec's cache "
                             f"{cache_bytes(tuned)} B exceeds the "
                             f"budget {res.budget_bytes} B")
    model = Model(cfg, device=dev, matmul_backend="pallas").init(g)
    params = model.state_dict()
    del model
    for label, spec in (("tuned", tuned), ("naive_default", naive)):
        cand = score(spec, device, workload)
        print(f"  {label}: {cand.summary()}")
        eng = ServingEngine(spec, device="cuda", graphs=True)
        eng.load(params)
        runs = {}
        for run in ("first", "warm"):
            # a bucketed engine captures its prefills apart from its steps
            before = eng.stats["graph_captures"] \
                + eng.stats["prefill_captures"]
            runs[run] = harness_replay(f"19c {label}, graphed, {run}", eng,
                                       trace)
            runs[run]["captures"] = eng.stats["graph_captures"] \
                + eng.stats["prefill_captures"] - before
        if not 1 <= runs["first"]["captures"] == runs["first"]["programs"] \
                or runs["warm"]["captures"]:
            raise AssertionError(
                f"19c {label}: {runs['first']['captures']} captures for "
                f"{runs['first']['programs']} programs run, then "
                f"{runs['warm']['captures']} when warm (want one each, then "
                "none)")

        def ms(x):
            return "n/a" if x is None else f"{x * 1e3:.3f}"
        for run, r in runs.items():
            m = r["res"].metrics
            print(f"  {label}, {run}: predicted TTFT "
                  f"{cand.predicted_ttft_s * 1e3:.4g} ms, ITL "
                  f"{cand.predicted_itl_s * 1e3:.4g} ms; measured TTFT p50 "
                  f"{ms(m.ttft_s_p50)} ms, ITL p50 {ms(m.itl_s_p50)} ms; "
                  f"{m.tokens_per_s:.1f} tok/s ({eng.scheduler} scheduler, "
                  f"{spec.memory.cache_layout} cache, {r['captures']} "
                  "captures)")
        del eng
        torch.cuda.empty_cache()
    del params


def check_encoder(timer, dev, g, smi: str) -> dict:
    """Phase 19: 19a's forwards (``encoder_forwards``), 19b's cost model
    and planner against the card (``cost_model``), 19c's tuner
    (``tuner_on_card``)."""
    t_start = time.perf_counter()
    launches = encoder_forwards(timer, dev, g)
    print(f"  (a) took {time.perf_counter() - t_start:.1f} s")
    cost_model(timer, dev, g, power_watts(smi))
    print(f"  (a) + (b) took {time.perf_counter() - t_start:.1f} s")
    tuner_on_card(dev, g)
    print(f"  phase 19 took {time.perf_counter() - t_start:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the register-driven engine (the paper's claim C1)
# ---------------------------------------------------------------------------
# the paper's three evaluation networks (configs/adaptor_bert.py,
# shallow_transformer.py, custom_encoder.py) at its measurement point, 64
# positions
PAPER_NETS = ("adaptor-bert", "shallow-transformer", "custom-encoder")
ADAPTIVE_SEQ = 64
# tests/test_adaptive.py's gates: x max|want| with rtol 1e-3, and its
# idle-lane case's
ADAPTIVE_TOL, LEAK_TOL = 2e-4, 3e-4


@dataclasses.dataclass
class Topo:
    """One topology of a fabric: its unpadded network, registers and
    activation, and whether the call passes target tokens."""

    label: str
    net: dict
    regs: object
    act: str
    tgt: bool = False


def run_fabric(timer, eng, topos: list, g, batch: int, tol: float | None,
               label: str) -> dict:
    """Every topology of ``topos`` through one compiled step of ``eng``:
    its live lanes against the oracle (``tol`` x max|want|, rtol 1e-3;
    None: the distance printed only), the graphed output equal to the
    eager one bit for bit, the buffers' addresses unchanged, and the
    per-call median of each (``Timer``).  Gates one capture in all.
    Returns per-topology rows and the first call's seconds."""
    step, serve = eng.compile(), eng.serve_fn()
    ptrs = eng.buffer_ptrs()
    S = ADAPTIVE_SEQ
    padded, nbytes = padded_cost(eng, batch, S)
    pb, pby = bound_ms(nbytes, padded, torch.float32)
    print(f"\n== {label}: {eng.mx}, batch {batch}, {eng.opt.dtype}; a call "
          f"computes {padded / 1e9:.3f} GFLOP (products) and moves "
          f"{nbytes / 1e9:.4f} GB: bound {pb:.4f} ms ({pby}; 67 TFLOP/s f32, "
          "3.35 TB/s)")
    rows, first_s = [], None
    for t in topos:
        st = t.regs.static()
        s, o = st["sequence"], st["out"]
        vocab = t.net["vocab"]
        toks = torch.randint(0, vocab, (batch, S), generator=g, device=eng.device)
        tgt = (torch.randint(0, vocab, (batch, S), generator=g,
                             device=eng.device) if t.tgt else None)
        act = int(t.act == "gelu")
        params = pack(eng, t.net)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, t.regs, act, toks, tgt)
        torch.cuda.synchronize()
        if first_s is None:
            first_s = time.perf_counter() - t0
        want = engine_ref.forward(t.net, toks[:, :s], activation=t.act,
                                  tgt_tokens=tgt[:, :s] if t.tgt else None)
        got = out[:, :s, :o].float()
        scale = float(want.abs().max())
        err = max_err(got, want)
        if tol is not None and not torch.allclose(
                got, want, rtol=1e-3, atol=tol * scale):
            raise AssertionError(f"{label}, {t.label}: {err:.3e} from the "
                                 f"oracle, past {tol} x {scale:.3e} "
                                 "(rtol 1e-3)")
        act_t = torch.tensor(act, dtype=torch.int32, device=eng.device)
        tgt_e = tgt if tgt is not None else (toks if eng.has_decoder
                                             else None)

        def eager(t=t, act_t=act_t, toks=toks, tgt_e=tgt_e):
            return serve(eng.params(), t.regs, act_t, toks, tgt_e)
        if not torch.equal(eager(), out):
            raise AssertionError(f"{label}, {t.label}: the graphed output "
                                 "differs from the eager one")
        if eng.buffer_ptrs() != ptrs:
            raise AssertionError(f"{label}: a weight buffer moved")
        ms = timer(lambda: step(params, t.regs, act, toks, tgt))
        ms_e = timer(eager)
        live, live_bytes = live_cost(st, batch, eng.opt.dtype.itemsize)
        lb, lby = bound_ms(live_bytes, live, torch.float32)
        rows.append(dict(label=t.label, ms=ms, eager_ms=ms_e, err=err / scale,
                         frac=live / padded, live_bound=lb))
        print(f"  {t.label:44s} graphed {ms:.4f} ms, eager {ms_e:.4f} ms "
              f"(bound {pb:.4f}); max|err| / max|want| {err / scale:.2e}"
              f"{'' if tol is not None else ' (not gated)'}; live-FLOP "
              f"fraction {live / padded:.3f} (live bound {lb:.4f} ms, "
              f"{lby})")
    if eng.capture_count() != 1:
        raise AssertionError(f"{label}: {eng.capture_count()} captures, "
                             "one must serve every topology")
    print(f"  {label}: {len(topos)} topologies, captures = "
          f"{eng.capture_count()}; the first call (warm-up, capture, "
          f"replay) {first_s:.3f} s; buffers never moved")
    return {"rows": rows, "first_s": first_s, "bound_ms": pb,
            "captures": eng.capture_count()}


def trace_call(label: str, fn) -> None:
    """One call of ``fn`` traced by ``torch.profiler``: its device kernels,
    their summed device time, the products' share (cuBLAS gemm kernels)
    and the longest kernels by name."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    evs = device_events(prof)
    if not evs:
        print(f"  {label}: the profiler traced no device activity (not "
              "measured)")
        return
    us = sum(e.self_device_time_total for e in evs)
    gemm = sum(e.self_device_time_total for e in evs
               if "gemm" in e.key.lower() or "nvjet" in e.key)
    print(f"  {label}, traced: {sum(e.count for e in evs)} device "
          f"activities, {us / 1e3:.4f} ms of device time, of which the "
          f"products (cuBLAS gemm kernels) {gemm / 1e3:.4f} ms; the longest: "
          + "; ".join(f"{e.key[:60]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.4f} ms"
                      for e in evs[:4]))


def no_sync_switch(eng, a: Topo, b: Topo, g) -> None:
    """Two calls of ``eng``'s captured step that switch topology and load
    new weights (device tensors, ``copy_``), then tokens staged from the
    host, all under ``set_sync_debug_mode("error")``; the return to the
    first topology must repeat its output bit for bit."""
    step = eng.compile()
    pa, pb = pack(eng, a.net), pack(eng, b.net)
    vocab = min(a.net["vocab"], b.net["vocab"])
    toks = torch.randint(0, vocab, (1, ADAPTIVE_SEQ), generator=g,
                         device=eng.device)
    first = step(pa, a.regs, int(a.act == "gelu"), toks)
    host_toks = toks.cpu()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(pb, b.regs, int(b.act == "gelu"), toks)
        again = step(pa, a.regs, int(a.act == "gelu"), host_toks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(again, first):
        raise AssertionError("the topology switch under "
                             "set_sync_debug_mode('error') changed the output")
    print("  a topology switch with its weight load, and a call with host "
          "tokens, under set_sync_debug_mode('error'): no host sync")


def check_adaptive(timer, dev, g) -> dict:
    """Phase 12: the register-driven engine (ROADMAP Queue 1 item 14) at the
    paper's full BERT widths, each fabric one CUDA graph.  Fabric E
    (encoder-only, ``maxima_for`` the three networks at 64 positions,
    batch 1, f32) serves the three networks, adaptor-bert at 32 positions,
    a GQA-packed topology (12 heads over 4 kv heads) and the Fig. 8 heads
    sweep (h = 2..12, d_model 64h, d_ff 256h), each within
    ``ADAPTIVE_TOL`` of the port's oracle, then the idle-lane case
    (adaptor-bert loaded, 6 heads x 6 layers selected) within
    ``LEAK_TOL``; fabric D (a 12-layer decoder provisioned) serves two
    enc-dec topologies and encoder-only adaptor-bert without target
    tokens; then fabric E at batch 8 and in bf16 (its distance to the f32
    oracle printed).  Each: one capture, graphed = eager bit for bit,
    buffers never move, per-call medians graphed and eager, the bound;
    a topology switch under ``set_sync_debug_mode("error")``; the time of
    one weight load.  No hand-written kernel may launch on this path.
    Returns {"adaptive": launch counts}."""
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    print("\n== the register-driven engine (ROADMAP Queue 1 item 14): "
          "torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
          f"precision {torch.get_float32_matmul_precision()!r}")
    cfgs = [get_config(n) for n in PAPER_NETS]
    bert_cfg, shallow_cfg = cfgs[0], cfgs[1]
    S = ADAPTIVE_SEQ
    mx_e = maxima_for(*cfgs, seq_max=S)
    # adaptor-bert's widths, from which the GQA, Fig. 8, idle-lane and
    # enc-dec topologies are drawn
    D, H, F, L = (bert_cfg.d_model, bert_cfg.num_heads, bert_cfg.d_ff,
                  bert_cfg.num_layers)
    V = bert_cfg.vocab_size
    hd = D // H

    def net(d, h, f, le, ld=0, kv=None, vocab=V, out=V):
        return engine_ref.random_network(
            generator=g, seq=S, d_model=d, heads=h, d_ff=f, layers_enc=le,
            layers_dec=ld, vocab=vocab, out=out, kv_heads=kv)

    def regs(d, h, f, le, ld=0, kv=None):
        return make_registers(sequence=S, heads=h, layers_enc=le,
                              layers_dec=ld, embeddings=d, hidden=f, out=V,
                              kv_heads=kv, device=dev)

    specs = {c.name: RuntimeSpec(arch=c, maxima=mx_e,
                                 memory=MemorySpec(max_len=S)) for c in cfgs}
    paper = [Topo(f"{c.name} at {S}", net(c.d_model, c.num_heads, c.d_ff,
                                          c.num_layers, vocab=c.vocab_size,
                                          out=c.vocab_size),
                  specs[c.name].registers(S, device=dev), c.activation)
             for c in cfgs]
    bert = paper[0]
    e_topos = [*paper,
               Topo(f"adaptor-bert at {S // 2}", bert.net,
                    specs[bert_cfg.name].registers(S // 2, device=dev),
                    "gelu"),
               Topo(f"GQA {H} heads over {H // 3} kv heads, d {D}",
                    net(D, H, F, L, kv=H // 3),
                    regs(D, H, F, L, kv=H // 3), "gelu")]
    for h in FIG8_HEADS:
        if h > H:
            continue
        e_topos.append(Topo(
            f"fig8 heads {h}, d {hd * h}, d_ff {4 * hd * h}",
            net(hd * h, h, 4 * hd * h, L), regs(hd * h, h, 4 * hd * h, L),
            "relu"))
    zero_counts()
    eng_e = AdaptiveEngine(
        mx_e, EngineOptions(batch=1), device=dev)
    fab_e = run_fabric(timer, eng_e, e_topos, g, 1, ADAPTIVE_TOL,
                       "fabric E, encoder-only")
    step = eng_e.compile()
    toks = torch.randint(0, V, (1, S), generator=g, device=dev)
    act_t = torch.ones((), dtype=torch.int32, device=dev)
    params = pack(eng_e, bert.net)
    trace_call("adaptor-bert on fabric E, graphed",
               lambda: step(params, bert.regs, 1, toks))
    trace_call("adaptor-bert on fabric E, eager",
               lambda: eng_e.serve_fn()(eng_e.params(), bert.regs, act_t,
                                        toks))
    del params
    # the idle-lane case: adaptor-bert's weights loaded, a topology of half
    # its heads, width and depth selected; the oracle is adaptor-bert cut
    # down to it
    small = dict(d=D // 2, h=H // 2, f=F // 2, layers=L // 2)
    got = step(pack(eng_e, bert.net),
               regs(small["d"], small["h"], small["f"], small["layers"]), 1,
               toks)
    want = engine_ref.forward(engine_ref.slice_network(bert.net, **small),
                              toks,
                              activation="gelu")
    scale, err = float(want.abs().max()), max_err(got, want)
    if not torch.allclose(got, want, rtol=1e-3, atol=LEAK_TOL * scale):
        raise AssertionError(f"idle lanes leak: {err:.3e} past {LEAK_TOL} x "
                             f"{scale:.3e}")
    print(f"  idle lanes: adaptor-bert loaded, {small['h']} heads x "
          f"{small['layers']} layers x d {small['d']} selected: max|err| / "
          f"max|want| {err / scale:.2e} (gate {LEAK_TOL})")
    no_sync_switch(eng_e, paper[1], paper[2], g)
    pa = pack(eng_e, paper[0].net)
    pb = pack(eng_e, paper[1].net)
    load_ms = timer(lambda: (eng_e.load(pa), eng_e.load(pb))) / 2
    n_bytes = sum(b.numel() * b.element_size() for b in eng_e.buffers())
    print(f"  one weight load (a copy_ per leaf, {len(eng_e.buffer_ptrs())} "
          f"leaves, {n_bytes / 1e9:.4f} GB): {load_ms:.4f} ms (bound "
          f"{bound_ms(2 * n_bytes, 0, torch.float32)[0]:.4f} ms, read and "
          "write at 3.35 TB/s)")
    if eng_e.capture_count() != 1:
        raise AssertionError("fabric E captured again")
    del pa, pb
    # fabric D: a decoder as deep as adaptor-bert provisioned beside the
    # encoder
    mx_d = maxima_for(*cfgs, seq_max=S, layers_dec_max=L)
    eng_d = AdaptiveEngine(
        mx_d, EngineOptions(batch=1, decoder=True), device=dev)
    d_spec = RuntimeSpec(arch=bert_cfg, maxima=mx_d,
                         memory=MemorySpec(max_len=S))
    sd, sh, sf, sl = (shallow_cfg.d_model, shallow_cfg.num_heads,
                      shallow_cfg.d_ff, shallow_cfg.num_layers)
    d_topos = [
        Topo(f"enc-dec at adaptor-bert widths, {L} + {L}",
             net(D, H, F, L, L), regs(D, H, F, L, L), "gelu", tgt=True),
        Topo(f"enc-dec at shallow-transformer widths, {sl} + {sl}",
             net(sd, sh, sf, sl, sl), regs(sd, sh, sf, sl, sl), "relu",
             tgt=True),
        Topo("adaptor-bert encoder-only, no target", bert.net,
             d_spec.registers(S, device=dev), "gelu")]
    fab_d = run_fabric(timer, eng_d, d_topos, g, 1, ADAPTIVE_TOL,
                       "fabric D, decoder provisioned")
    del eng_d, d_topos
    # fabric E at batch 8 and in bf16: engines of their own
    eng_8 = AdaptiveEngine(
        mx_e, EngineOptions(batch=8), device=dev)
    fab_8 = run_fabric(timer, eng_8, paper, g, 8, ADAPTIVE_TOL,
                       "fabric E at batch 8")
    del eng_8
    eng_b = AdaptiveEngine(
        mx_e, EngineOptions(batch=1, dtype=torch.bfloat16),
        device=dev)
    fab_b = run_fabric(timer, eng_b, paper, g, 1, None,
                       "fabric E in bf16 against the f32 oracle")
    del eng_b
    counts = launch_counts()
    ran = {n: c for n, c in counts.items() if c}
    if ran:
        raise AssertionError("a hand-written kernel launched on the "
                             f"register-driven engine's path: {ran}")
    print("  fig8 (fabric E, batch 1, f32): heads, graphed ms, eager ms, "
          "live-FLOP fraction, live bound ms")
    for r in fab_e["rows"]:
        if r["label"].startswith("fig8"):
            print(f"    {r['label']:34s} {r['ms']:.4f} {r['eager_ms']:.4f} "
                  f"{r['frac']:.3f} {r['live_bound']:.4f}")
    print(f"  captures: fabric E {eng_e.capture_count()}, D "
          f"{fab_d['captures']}, batch 8 {fab_8['captures']}, bf16 "
          f"{fab_b['captures']}; first calls {fab_e['first_s']:.3f} / "
          f"{fab_d['first_s']:.3f} / {fab_8['first_s']:.3f} / "
          f"{fab_b['first_s']:.3f} s; no kernel of the library launched; "
          f"phase 12 took {time.perf_counter() - t_start:.1f} s")
    del eng_e
    torch.cuda.empty_cache()
    return {"adaptive": counts}


# ---------------------------------------------------------------------------
# phase 20: training on one card (ROADMAP Queue 1 item 16)
# ---------------------------------------------------------------------------
TRAIN = "qwen1.5-0.5b"
TRAIN_SEED = 20
TRAIN_GRAD_LAYERS = 2                 # (a): 2 of 24 layers at full width
TRAIN_GRAD_BATCH = (2, 32)
# (b): the reference quickstart's corpus, optimizer and 60 steps, but lr
# 2e-3: at full width the quickstart's 3e-3 can stall on a plateau (seed 22
# of launch/memorize_probe.py: loss 0.47 after 60 steps, row 0 4 of 8),
# where 2e-3, the largest it tried that does, memorizes every row of
# seeds 20-22
MEMORIZE = dict(n_rows=4, seq_len=32, batch=4)
MEMORIZE_OPT = dict(lr=2e-3, warmup_steps=5, total_steps=60,
                    weight_decay=0.0)
MEMORIZE_STEPS = 60
PROMPT_TOKENS = 8                     # greedy 8 from each row's first 8
CKPT_AT = 10                          # (d): the save's step in (b)'s run
TIMED_FROM = CKPT_AT + 4              # (b)'s step time: steps 15-60
ACCUM_BATCH = (8, 128)                # (c)
MOE_STEPS, MOE_BATCH = 5, (4, 128)    # (e)


def train_bound(model: Model, tokens: int) -> tuple[float, str]:
    """A train step's least time on the card: the larger of the
    arithmetic, 6 x (the parameters a token multiplies outside the
    embedding tables: an MoE layer's k of E experts) x tokens at the bf16
    peak plus the f32 unembedding's 6 x V x d x tokens at the f32 peak,
    and AdamW's bytes: each f32 parameter, m and v read and written and
    its gradient read (28 bytes a parameter) at the HBM rate."""
    cfg, n, n_mm = model.cfg, 0, 0
    for name, p in model.named_parameters():
        n += p.numel()
        if name.endswith("table"):
            continue
        frac = cfg.moe.experts_per_token / cfg.moe.num_experts \
            if ".moe.w" in name else 1.0
        n_mm += p.numel() * frac
    t_ops = 6 * n_mm * tokens / PEAK_FLOPS[torch.bfloat16] \
        + 6 * cfg.vocab_size * cfg.d_model * tokens \
        / PEAK_FLOPS[torch.float32]
    t_bytes = 28 * n / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def card_vs_host_grads(cfg: ArchConfig, batch_shape: tuple[int, int], g,
                       dev, label: str) -> None:
    """``cfg`` at f32 compute with TF32 off: the card's loss, aux and every
    gradient leaf against the same step on the host, on the same weights
    and batch; the CPU tests' gates (1e-5 relative, 1e-4 x
    max|g_host|)."""
    card = Model(cfg, compute_dtype=torch.float32, device=dev,
                 trainable=True).init(g)
    host = Model(cfg, compute_dtype=torch.float32, device="cpu",
                 trainable=True)
    host.load_state_dict({n: t.cpu() for n, t in card.state_dict().items()})
    B, S = batch_shape
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss, aux, grads = loss_and_grads(card, dict(card.named_parameters()),
                                          batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    h_loss, h_aux, h_grads = loss_and_grads(
        host, dict(host.named_parameters()),
        {k: v.cpu() for k, v in batch.items()})
    rel = {k: abs(float(aux[k]) - float(h_aux[k])) / abs(float(h_aux[k]))
           for k in h_aux}
    scale = max(float(t.abs().max()) for t in h_grads.values())
    errs = {n: float((grads[n].cpu() - t).abs().max())
            for n, t in h_grads.items()}
    worst = max(errs, key=errs.get)
    print(f"  {label}, {B} x {S} tokens, f32, TF32 off, card vs host: loss "
          f"{float(loss):.6f} / {float(h_loss):.6f}, relative "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (gate 1e-5); grads: worst {worst} {errs[worst]:.3e} = "
          f"{errs[worst] / scale:.2e} x max|g| {scale:.4f} (gate 1e-4), "
          f"{len(errs)} leaves")
    if max(rel.values()) > 1e-5 or errs[worst] > 1e-4 * scale:
        raise AssertionError(f"{label}: training gradients on the card "
                             "disagree with the host's")
    del card, host, grads, h_grads
    torch.cuda.empty_cache()


def train_grads(dev, g) -> None:
    """(a) qwen1.5-0.5b at its widths and 2 of 24 layers, f32 compute with
    TF32 off: the card's loss, aux and every gradient leaf against the
    same step on the host (``card_vs_host_grads``)."""
    cfg = dataclasses.replace(get_config(TRAIN), num_layers=TRAIN_GRAD_LAYERS)
    card_vs_host_grads(cfg, TRAIN_GRAD_BATCH, g, dev,
                       f"(a) {TRAIN} at its widths, {TRAIN_GRAD_LAYERS} of "
                       f"{get_config(TRAIN).num_layers} layers")


def memorize(dev, g, smi: str, tmp: str) -> dict:
    """(b) and (d): all 24 layers, f32 masters, bf16 compute, AdamW at the
    quickstart's settings over ``MemorizationStream``; an async checkpoint
    at step ``CKPT_AT``, restored into a fresh state on the card whose
    next 3 steps must repeat the run's losses bit for bit.  Then the
    trained masters are served by a graphed engine on the kernel path
    (phase 5's spec): greedy 8 from each row's first 8 tokens.  Returns
    the drain (its launches are the path's)."""
    cfg = get_config(TRAIN)
    model = Model(cfg, device=dev, trainable=True)
    oc = AdamWConfig(**MEMORIZE_OPT)
    state = init_state(model, g, oc)
    step = make_step_fn(model, TrainStepConfig(optimizer=oc))
    data = dict(vocab_size=cfg.vocab_size, device=dev, **MEMORIZE)
    stream = MemorizationStream(**data)
    zero_counts()
    losses, lb = [], []
    for i in range(MEMORIZE_STEPS):
        if i == TIMED_FROM:
            writer.join(timeout=600)
            if writer.is_alive():
                raise AssertionError("the checkpoint writer did not finish")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        state, m = step(state, stream.next())
        losses.append(m["loss"])
        if i + 1 == CKPT_AT:
            writer = ckpt.save(tmp, CKPT_AT, state, async_write=True,
                               meta={"data_state": stream.state()})
    torch.cuda.synchronize()
    n_timed = MEMORIZE_STEPS - TIMED_FROM
    step_ms = (time.perf_counter() - t0) / n_timed * 1e3
    peak = peak_gb()
    ran = {n: c for n, c in launch_counts().items() if c}
    if ran:
        raise AssertionError(f"the training step launched kernels: {ran}")
    losses = [float(x) for x in losses]
    tokens = MEMORIZE["batch"] * MEMORIZE["seq_len"]
    bound, by = train_bound(model, tokens)
    print(f"  (b) {TRAIN} at its widths and {cfg.num_layers} layers, f32 "
          f"masters, bf16 "
          f"compute, lr {oc.lr} warmup {oc.warmup_steps}, {MEMORIZE['n_rows']}"
          f" rows x {MEMORIZE['seq_len']}: losses "
          + " ".join(f"{x:.3f}" for x in losses[::6])
          + f" ... {losses[-1]:.4f}"
          f"; step {step_ms:.3f} ms ({tokens} tokens, steps {TIMED_FROM + 1}-"
          f"{MEMORIZE_STEPS}), {tokens / step_ms * 1e3:.0f} tok/s, bound "
          f"{bound:.3f} ms ({by}), {step_ms / bound:.1f}x; peak "
          f"{peak:.2f} GB; no hand-written kernel launched; {smi}")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"memorization failed: {losses[0]} -> "
                             f"{losses[-1]}")
    # (d): restore the step-CKPT_AT checkpoint into a fresh state
    fresh = Model(cfg, device=dev, trainable=True)
    like = init_state(fresh, g, oc)
    got, meta = ckpt.restore_latest(tmp, like)
    del like
    step2 = make_step_fn(fresh, TrainStepConfig(optimizer=oc))
    stream2 = MemorizationStream.restore(meta["data_state"], **data)
    resumed = []
    for _ in range(3):
        got, m = step2(got, stream2.next())
        resumed.append(float(m["loss"]))
    want = losses[CKPT_AT:CKPT_AT + 3]
    print(f"  (d) async save at step {meta['step']}, restored into a fresh "
          f"state on the card, 3 more steps: {resumed} against the run's "
          f"{want}: {'bit for bit' if resumed == want else 'DIFFER'}")
    if resumed != want:
        raise AssertionError("the resumed run's losses differ from the "
                             "uninterrupted run's")
    del got, fresh, step2
    # serve the trained masters through the kernels
    rows = stream.corpus.tolist()
    prompts = [r[:PROMPT_TOKENS] for r in rows]
    served = serve(state.params, prompts, max_new=PROMPT_TOKENS)
    hits = [sum(a == b for a, b in zip(served["streams"][i],
                                       r[PROMPT_TOKENS:2 * PROMPT_TOKENS]))
            for i, r in enumerate(rows)]
    print(f"  (b) the trained masters served by a graphed engine on the "
          f"kernel path: memorized tokens " + ", ".join(
              f"row {i} {h}/{PROMPT_TOKENS}" for i, h in enumerate(hits))
          + f" (gate: row 0 >= 6); launches {served['launches']}")
    if hits[0] < 6:
        raise AssertionError(f"row 0 reproduced {hits[0]} of 8 tokens")
    del state, model, step
    torch.cuda.empty_cache()
    return served


def accum_and_remat(dev, g, smi: str) -> None:
    """(c) 8 x 128 tokens, all 24 layers, bf16: ``accum_steps`` 2 against 1
    from one state at the reference's gates (loss within 0.05,
    parameters within 5e-2); the step's time at 1024 tokens; remat "full"
    and "dots" against "none" (loss and grad norm within 2e-2, bf16),
    each mode's peak memory, "full" below "none"."""
    cfg = get_config(TRAIN)
    B, S = ACCUM_BATCH
    model = Model(cfg, device=dev, trainable=True)
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    s0 = init_state(model, g, oc)
    batch = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=S,
                              global_batch=B, seed=1, device=dev).next()
    s1, m1 = make_step_fn(model, TrainStepConfig(optimizer=oc,
                                                 donate=False))(s0, batch)
    s2, m2 = make_step_fn(model, TrainStepConfig(
        optimizer=oc, accum_steps=2, donate=False))(s0, batch)
    dl = abs(float(m1["loss"]) - float(m2["loss"]))
    dp = max(float((s1.params[n] - s2.params[n]).detach().abs().max())
             for n in s1.params)
    print(f"  (c) accum_steps 2 vs 1 at {B} x {S}: loss "
          f"{float(m2['loss']):.4f}"
          f" / {float(m1['loss']):.4f} (|d| {dl:.2e}, gate 0.05), params "
          f"max |d| {dp:.2e} (gate 5e-2)")
    if not dl < 0.05 or not dp < 5e-2:
        raise AssertionError("accumulation moved the step")
    del s2
    # the step's time at 1024 tokens (donated, on s1)
    step = make_step_fn(model, TrainStepConfig(optimizer=oc))
    s1, _ = step(s1, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        s1, _ = step(s1, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    bound, by = train_bound(model, B * S)
    print(f"  (c) step at {B} x {S} = {B * S} tokens: {step_ms:.3f} ms, "
          f"{B * S / step_ms * 1e3:.0f} tok/s, bound {bound:.3f} ms ({by}), "
          f"{step_ms / bound:.1f}x; {smi}")
    del s1
    res = {}
    for mode in ("none", "full", "dots"):
        model.remat = mode
        # a first call pays the checkpoint machinery's one-time set-up
        loss_and_grads(model, s0.params, batch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(model, s0.params, batch)
        norm = float(global_norm(grads))
        ms = (time.perf_counter() - t0) * 1e3     # includes the norm's read
        res[mode] = (float(loss), norm, peak_gb() - base, peak_gb(), ms)
        del grads
    model.remat = "none"
    print(f"  (c) remat at {B} x {S}: " + "; ".join(
        f"{k} loss {v[0]:.5f} grad norm {v[1]:.5f} peak {v[3]:.2f} GB "
        f"(+{v[2]:.2f} over the state) loss + grads {v[4]:.1f} ms"
        for k, v in res.items()) + f"; {smi}")
    l0, n0 = res["none"][:2]
    for mode in ("full", "dots"):
        if abs(res[mode][0] - l0) > 2e-2 * abs(l0) \
                or abs(res[mode][1] - n0) > 2e-2 * n0:
            raise AssertionError(f"remat {mode!r} moved the loss or grads")
    if not res["full"][3] < res["none"][3]:
        raise AssertionError("remat 'full' did not lower the peak memory")
    del s0, model
    torch.cuda.empty_cache()


def train_moe(dev, g, smi: str) -> None:
    """(e) granite-moe-1b-a400m at its published widths and depth (f32
    masters, m and v: ~21 GB of state), bf16 compute, ``MOE_STEPS`` steps:
    finite losses, the balance term, peak memory, the step's time."""
    cfg = get_config(MOE)
    model = Model(cfg, device=dev, trainable=True)
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, g, oc)
    step = make_step_fn(model, TrainStepConfig(optimizer=oc))
    B, S = MOE_BATCH
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B, seed=2, device=dev)
    losses, lbs = [], []
    for i in range(MOE_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, stream.next())
        losses.append(m["loss"])
        lbs.append(m["load_balance"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (MOE_STEPS - 1) * 1e3
    losses, lbs = [float(x) for x in losses], [float(x) for x in lbs]
    bound, by = train_bound(model, B * S)
    n = sum(p.numel() for p in state.params.values())
    print(f"  (e) {MOE} at its widths and {cfg.num_layers} layers "
          f"({n / 1e9:.2f}"
          f" B parameters), bf16, {B} x {S}: losses "
          + " ".join(f"{x:.4f}" for x in losses) + ", load_balance "
          + " ".join(f"{x:.4f}" for x in lbs) + f"; step {step_ms:.3f} ms, "
          f"bound {bound:.3f} ms ({by}), {step_ms / bound:.1f}x; peak "
          f"{peak_gb():.2f} GB; {smi}")
    if not all(math.isfinite(x) for x in losses + lbs):
        raise AssertionError("granite-moe training went non-finite")
    del state, model, step
    torch.cuda.empty_cache()


def train_refusals(dev) -> None:
    """(f) What a trainable model refuses, before it allocates."""
    qwen = get_config(TRAIN)
    cases = (("matmul_backend='pallas'", qwen, dict(matmul_backend="pallas")),
             ("int8 weights", qwen, dict(quant="int8")))
    for label, cfg, kw in cases:
        try:
            Model(cfg, device=dev, trainable=True, **kw)
        except ValueError as e:
            print(f"  (f) {label} refused: {e}")
        else:
            raise AssertionError(f"training with {label} was not refused")


def check_train(dev, smi: str) -> dict:
    """Phase 20: training on one card (``train_grads``, ``memorize``,
    ``accum_and_remat``, ``train_moe``, ``train_refusals``); the serving
    of the trained weights is the path whose launches are returned.  Each
    part draws from a generator of its own seeded with ``TRAIN_SEED``, so
    its weights, and the memorization run they start, move neither when
    an earlier phase's depth does nor when another part changes."""
    t_start = time.perf_counter()

    def seeded() -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(TRAIN_SEED)
        return g

    print(f"\n== training: {TRAIN} and {MOE} on one card; {smi}")
    train_grads(dev, seeded())
    with tempfile.TemporaryDirectory() as tmp:
        served = memorize(dev, seeded(), smi, tmp)
    accum_and_remat(dev, seeded(), smi)
    train_moe(dev, seeded(), smi)
    train_refusals(dev)
    print(f"  phase 20 took {time.perf_counter() - t_start:.1f} s")
    return {"train": served["launches"]}


# phase 21: the scans' backwards, the kernels against their plain versions
# at timing.RGLRU_BWD_SHAPES and timing.SSM_BWD_SHAPES
SCAN_TRAIN_SEED = 21
# training at full width: recurrentgemma-2b at 13 of 26 layers (pattern r,
# r, a kept: 4 x 3 + 1; all 26 take ~64 GB with AdamW's temporaries),
# falcon-mamba-7b at 8 of 64 (its 116 GB of f32 state at full depth need
# the sharded step, item 16c)
SCAN_TRAIN = ((HYBRID, 13), (SSM, 8))
SCAN_GRAD_LAYERS = 2                   # card vs host gradients, f32
SCAN_GRAD_BATCH = (2, 32)
SCAN_BATCH = (4, 128)                  # one fixed batch of distinct tokens
SCAN_STEPS = 6
SCAN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20, weight_decay=0.0)
SCAN_SERVE = dict(max_batch=4, max_len=256)
SCAN_SERVE_PROMPTS = (16, 40, 100, 129)
SCAN_SERVE_NEW = 8


def check_scan_bwd(timer, dev, g) -> dict:
    """Both backward kernels against their plain versions, bit for bit
    (the plain versions repeat the kernels' float32 operators and, for the
    ssm's sums over channels, rows and positions, their orders), timed
    beside the bound: each input read once and each output written once
    at 3.35 TB/s against the float32 operations at 67 TFLOP/s.  The RG-LRU
    adjoint: a, hs, dhs read, da, dg written; 3 operations an element.
    The selective scan's (``ssm_bwd_cost``): dt, x (bf16), dy read and
    ddt, dx written a position and channel, b, c, db, dc a position, a,
    dh, da and the checkpoints once; 6 operations a state for the forward
    h it needs and 21 for the adjoint; beside it the issue floor.  Its
    ``ms`` is the backward kernel's call from the forward kernel's
    checkpoints (held bit for bit against the plain loop's h), the
    training path's; ``forward_ms`` times that forward (``SSMScanFn``'s,
    writing the checkpoints) and ``with_forward_ms`` the backward called
    without them, which launches that forward first: a training layer's
    two scans.  No single PyTorch call computes either, so no library
    time."""
    print("\n== phase 21 (a): the scans' backwards vs their plain loops "
          "(training; the reference's jax.grad of its lax.scans)")
    out = {}
    rows = []
    for B, S, W in RGLRU_BWD_SHAPES:
        a = torch.rand(B, S, W, generator=g, device=dev)
        hs = torch.randn(B, S, W, generator=g, device=dev)
        dhs = torch.randn(B, S, W, generator=g, device=dev)
        dh = torch.randn(B, W, generator=g, device=dev)
        run = lambda: scan_mod.rglru_scan_bwd(a, hs, dhs, dh)  # noqa: E731
        plain = lambda: scan_mod.rglru_scan_bwd_plain(  # noqa: E731
            a, hs, dhs, dh)
        got, want = run(), plain()
        err = max(max_err(x, y) for x, y in zip(got, want))
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"rglru_scan_bwd [{B}, {S}, {W}]: not bit "
                                 f"for bit its plain loop (max err {err})")
        nbytes, flops, _ = rglru_bwd_cost(B, S, W)
        bms, by = bound_ms(nbytes, flops, torch.float32)
        ms, pms = timer(run), timer(plain, reps=3, warm=1)
        launch = scan_mod.describe(scan_mod._plan(B, S, W, True), B, W, True)
        print(f"  rglru_scan_bwd [{B}, {S}, {W}] f32: bit for bit; kernel "
              f"{ms:.4f} ms, plain {pms:.4f}, bound {bms:.4f} ({by}), "
              f"{ms / bms:.1f}x; {launch}")
        rows.append(dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None, launch=launch,
                         shape=f"[{B}, {S}, {W}] float32"))
        del a, hs, dhs, dh, got, want
    out["rglru_scan_bwd"] = dict(rows[0], other_shapes=rows[1:])
    rows = []
    for B, S, Di, N in SSM_BWD_SHAPES:
        dt, x, b, c, a = ssm_operands(g, dev, B, S, Di, N)
        dy = torch.randn(B, S, Di, generator=g, device=dev)
        dh = torch.randn(B, Di, N, generator=g, device=dev)
        ops_ = (dt, x, b, c, a, dy, dh)
        # the training path: the forward kernel's checkpoints (h every
        # CHUNK positions) handed to the backward, both against the plain
        # versions
        ckpt = sscan_mod._forward(dt, x, b, c, a, None, True)[2]
        if not torch.equal(ckpt, ssm_scan_plain(dt, x, b, c, a,
                                                checkpoints=True)[2]):
            raise AssertionError(f"ssm_scan [{B}, {S}, {Di}, {N}]: the "
                                 "checkpoints are not the plain loop's h")
        fwd = lambda: sscan_mod._forward(  # noqa: E731
            dt, x, b, c, a, None, True)
        run = lambda: sscan_mod.ssm_scan_bwd(*ops_, ckpt)  # noqa: E731
        both = lambda: sscan_mod.ssm_scan_bwd(*ops_)  # noqa: E731
        plain = lambda: sscan_mod.ssm_scan_bwd_plain(*ops_)  # noqa: E731
        want = plain()
        err = 0.0
        for how, got in (("from the checkpoints", run()),
                         ("launching the forward", both())):
            err = max([err] + [max_err(u.float(), v.float())
                               for u, v in zip(got, want)])
            if not all(torch.equal(u, v) for u, v in zip(got, want)):
                raise AssertionError(f"ssm_scan_bwd [{B}, {S}, {Di}, {N}] "
                                     f"{how}: not bit for bit its plain "
                                     f"loop (max err {err})")
        nbytes, flops, lanes = ssm_bwd_cost(B, S, Di, N)
        bms, by = bound_ms(nbytes, flops, torch.float32)
        ims = issue_floor_ms(lanes)
        ms, fms, wms = timer(run), timer(fwd), timer(both)
        pms = timer(plain, reps=1, warm=0)
        print(f"  ssm_scan_bwd [{B}, {S}, {Di}, {N}] f32, x bf16: bit for "
              f"bit, from the forward's checkpoints and launching the "
              f"forward; kernel {ms:.4f} ms (training forward {fms:.4f}, "
              f"both {wms:.4f}), plain {pms:.4f}, bound {bms:.4f} ({by}), "
              f"{ms / bms:.1f}x, issue floor {ims:.4f}")
        rows.append(dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None, issue_floor_ms=ims,
                         forward_ms=fms, with_forward_ms=wms,
                         shape=f"[{B}, {S}, {Di}, {N}] float32, x bf16; "
                               f"ms: the backward alone, from the "
                               f"forward's checkpoints"))
        del ops_, dt, x, b, c, a, dy, dh, ckpt, want
    out["ssm_scan_bwd"] = dict(rows[0], other_shapes=rows[1:])
    return out


def scan_family_steps(model: Model, batch: dict, g) -> tuple:
    """``SCAN_STEPS`` steps from the weights ``g`` draws (in place) on the
    one fixed batch: (losses, grad norms, a checksum of the final masters,
    step ms over steps 2 on, peak GB, the launches of the run)."""
    oc = AdamWConfig(**SCAN_OPT)
    state = init_state(model, g, oc)
    step = make_step_fn(model, TrainStepConfig(optimizer=oc))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, norms = [], []
    for i in range(SCAN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (SCAN_STEPS - 1) * 1e3
    made = launch_counts()
    with torch.no_grad():
        check = float(sum(p.double().sum() for p in state.params.values()))
    return ([float(x) for x in losses], [float(x) for x in norms], check,
            step_ms, peak_gb(), made, state)


def serve_trained(params, cfg: ArchConfig) -> dict:
    """The trained masters served by an eager dense + bucketed engine on
    the kernel path (bf16): every request finishes, and the launches equal
    ``program_launches``' prefill per request and decode per step."""
    spec = RuntimeSpec(
        arch=cfg, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas",
                                          compute_dtype="bf16"),
        memory=MemorySpec(cache_layout="dense", **SCAN_SERVE),
        scheduler=SchedulerSpec(policy="bucketed"))
    eng = ServingEngine(spec, device="cuda", graphs=False)
    eng.load(params)
    rs = np.random.default_rng(21)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in SCAN_SERVE_PROMPTS]
    r = drain(eng, prompts, max_new=SCAN_SERVE_NEW)
    del eng
    want = bucketed_launches(cfg, "bucketed", "dense", r, len(prompts))
    have = {n: r["launches"][n] for n in want}
    print(f"  the trained masters served (eager dense + bucketed, bf16, "
          f"{len(prompts)} requests of {SCAN_SERVE_PROMPTS} tokens x "
          f"{SCAN_SERVE_NEW} new): {r['steps']} decode steps, launches "
          f"{ {n: c for n, c in have.items() if c} } (kernels/counts.py: "
          f"{ {n: c for n, c in want.items() if c} })")
    if have != want:
        raise AssertionError(f"{cfg.name} served: launches {have} != {want}")
    return r["launches"]


def train_scan_family(name: str, layers: int, dev, smi: str,
                      seeded) -> tuple[dict, dict]:
    """(b)-(e) for one family at its widths and ``layers`` layers:
    card vs host gradients at ``SCAN_GRAD_LAYERS``; ``SCAN_STEPS`` bf16
    steps (f32 masters) on one fixed batch of distinct tokens (no two
    embedding rows collide in the backward's index_add, so a run repeats
    bit for bit), the loss falling, the scans' launches =
    ``program_launches(cfg, "train")`` x steps and no other kernel, step
    ms and peak memory beside ``train_bound``; a second run from the same
    seed: losses, grad norms and the masters' checksum bit for bit; then
    the masters served back through the kernels.  Returns (the training
    run's launches, the serving drain's)."""
    full = get_config(name)
    card_vs_host_grads(dataclasses.replace(full, num_layers=SCAN_GRAD_LAYERS),
                       SCAN_GRAD_BATCH, seeded(), dev,
                       f"(b) {name} at its widths, {SCAN_GRAD_LAYERS} of "
                       f"{full.num_layers} layers")
    cfg = dataclasses.replace(full, num_layers=layers)
    model = Model(cfg, device=dev, trainable=True)
    n = sum(p.numel() for p in model.parameters())
    B, S = SCAN_BATCH
    perm = torch.randperm(cfg.vocab_size, generator=seeded(), device=dev)
    rows = perm[:B * (S + 1)].reshape(B, S + 1)
    batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
    runs, state = [], None
    for _ in range(2):
        del state                     # the first run's moments
        *run, state = scan_family_steps(model, batch, seeded())
        runs.append(run)
    bound, by = train_bound(model, B * S)
    losses, norms, check, step_ms, peak, made = runs[0]
    want = program_launches(cfg, "train")
    want = {k: v * SCAN_STEPS for k, v in want.items()}
    have = {k: made[k] for k in want}
    print(f"  (c) {name} at its widths and {layers} of {full.num_layers} "
          f"layers ({n / 1e9:.3f} B parameters), f32 masters, bf16, "
          f"{B} x {S} distinct tokens, lr {SCAN_OPT['lr']}: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step {step_ms:.3f} ms, {B * S / step_ms * 1e3:.0f} tok/s, "
          f"bound {bound:.3f} ms ({by}), {step_ms / bound:.1f}x; peak "
          f"{peak:.2f} GB; launches {({k: v for k, v in have.items() if v})} "
          f"(kernels/counts.py x {SCAN_STEPS}: "
          f"{({k: v for k, v in want.items() if v})}); {smi}")
    if have != want:
        raise AssertionError(f"{name} training: launches {have} != {want}")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} training: the loss did not fall "
                             f"({losses})")
    same = runs[1][:3] == runs[0][:3]
    print(f"  (d) a second run from the same seed: losses, grad norms and "
          f"the masters' checksum {check!r}: "
          f"{'bit for bit' if same else 'DIFFER'} (second run step "
          f"{runs[1][3]:.3f} ms)")
    if not same:
        raise AssertionError(f"{name}: two identical training runs differ: "
                             f"{runs[0][:3]} vs {runs[1][:3]}")
    served = serve_trained(state.params, cfg)
    del state, model
    torch.cuda.empty_cache()
    return made, served


def check_train_scans(timer, dev, smi: str) -> tuple[dict, dict]:
    """Phase 21: the scans' backwards (``check_scan_bwd``), then
    recurrentgemma-2b and falcon-mamba-7b trained at full width
    (``train_scan_family``).  Returns (the kernel table's entries, the
    launches of the paths "train_scans" and "scans_served")."""
    t_start = time.perf_counter()

    def seeded() -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(SCAN_TRAIN_SEED)
        return g

    entries = check_scan_bwd(timer, dev, seeded())
    print(f"\n== phase 21 (b)-(e): training the scan families on one card; "
          f"{smi}")
    trained, served = collections.Counter(), collections.Counter()
    for name, layers in SCAN_TRAIN:
        made, srv = train_scan_family(name, layers, dev, smi, seeded)
        trained.update({k: v for k, v in made.items() if "." not in k})
        served.update({k: v for k, v in srv.items() if "." not in k})
    print(f"  phase 21 took {time.perf_counter() - t_start:.1f} s")
    full = dict.fromkeys(KERNELS, 0)
    return entries, {"train_scans": {**full, **trained},
                     "scans_served": {**full, **served}}


# ---------------------------------------------------------------------------
# phase 22: mesh serving (ROADMAP Queue 1 item 13)
# ---------------------------------------------------------------------------
MESH_TP = 2                 # (a): two ranks of one engine share the card
MESH_DP = 2                 # (b): two replicas behind one queue


def mesh_spec(kernels: bool, mesh: MeshSpec) -> RuntimeSpec:
    """Phase 5's spec at f32 compute on ``mesh``: the plain routes, or
    the kernels (a tp 1 replica's)."""
    spec = full_width_spec(kernels)
    return dataclasses.replace(
        spec, execution=dataclasses.replace(spec.execution,
                                            compute_dtype="fp32"),
        mesh=mesh)


def float_pools(eng) -> None:
    """The engine's pool (every rank's) as float32 tensors, before its
    first step: the f32 streams then differ only by the order of the
    sums, not by the bf16 rounding of K and V that order can flip."""
    def f32(c):
        return type(c)(*(None if t is None else t.float() for t in c))
    if isinstance(eng.cache, ShardedCache):
        eng.cache = ShardedCache([f32(c) for c in eng.cache.ranks])
    else:
        eng.cache = f32(eng.cache)


def cluster_drain(cl, prompts) -> dict:
    """Submit ``prompts`` (greedy, ``MAX_NEW`` each) to a cluster and
    drain it; the kernel counts are zeroed just before, and the launches
    made are summed over the replicas as ``made_launches`` counts one
    engine's."""
    uids = {cl.submit(p, max_new_tokens=MAX_NEW): i
            for i, p in enumerate(prompts)}
    zero_counts()
    tallies = [(collections.Counter(e.captured_launches),
                collections.Counter(e.replayed_launches))
               for e in cl.replicas]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = cl.run_to_completion()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(done) != len(prompts) or \
            any(len(r.generated) != MAX_NEW for r in done):
        raise AssertionError(f"the cluster finished {len(done)}/"
                             f"{len(prompts)} requests, or short")
    made = launch_counts()
    for e, (cap, rep) in zip(cl.replicas, tallies):
        for n in made:
            made[n] += (e.replayed_launches[n] - rep[n]) \
                - (e.captured_launches[n] - cap[n])
    return dict(streams={uids[r.uid]: r.generated for r in done}, dt=dt,
                launches=made, compilations=cl.compilations,
                replica_steps=[s["decode_steps"]
                               for s in cl.replica_stats()])


def check_mesh(dev, g, f32_dist: float, smi: str) -> dict:
    """Phase 22: qwen1.5-0.5b at full width, f32 compute over float32
    pools, phase 5's mix and weights drawn once: (c) single graphed
    engines on the plain route and on the kernels; (a) a tp = 2 engine
    whose two ranks share the card (graphed: one CUDA graph per program
    over both ranks; the plain route, the reference's rule for tp > 1);
    (b) a dp = 2 ``EngineCluster`` of two graphed kernel-route replicas on
    the card.  Gates: (a) streams (c)'s plain-route tokens and (b) its
    kernel-route ones (equal, or diverging only at a near-tie within
    phase 4's f32 distance, recomputed as phase 8 does), one capture per
    program per engine and replica, (a)'s warm drain no capture and the
    same streams, no kernel launched under tp > 1 and every kernel of the
    path launched by (b).  Both ranks and both replicas share one card:
    no speed is printed for them."""
    t_start = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    params = Model(cfg, compute_dtype=torch.float32, device=dev).init(
        g).state_dict()
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    n_tok = len(prompts) * MAX_NEW
    print(f"\n== phase 22: mesh serving, full-width {cfg.name} at f32 "
          f"compute over float32 pools, phase 5's mix ({len(prompts)} "
          f"requests x {MAX_NEW} new); tp={MESH_TP} ranks and "
          f"dp={MESH_DP} replicas share one card ({smi})")
    base = {}
    for kernels in (False, True):
        eng = ServingEngine(mesh_spec(kernels, MeshSpec()), device="cuda")
        eng.load(params)
        float_pools(eng)
        r = drain(eng, prompts)
        base[kernels] = r
        print(f"  (c) one graphed engine, {'kernels' if kernels else 'plain'}"
              f" route: {r['steps']} fused steps, compilations "
              f"{r['compilations']}")
        del eng
    tp_devs = dev_devices(MESH_TP, allow_repeat=True)
    eng = ServingEngine(mesh_spec(False, MeshSpec(tp=MESH_TP)),
                        devices=tp_devs)
    eng.load(params)
    float_pools(eng)
    shapes = [[tuple(t.shape) for t in c if t is not None]
              for c in eng.cache.ranks]
    print(f"  (a) tp={MESH_TP} on {tp_devs}: each rank's pool (K, V) "
          f"{shapes}; heads split {eng.model.heads_split}, FFN split "
          f"{eng.model.ffn_split}, vocabulary split "
          f"{eng.model.vocab_split}")
    tp_run = drain(eng, prompts)
    warm = drain(eng, prompts)
    comp = tp_run["compilations"]
    print(f"  (a) {tp_run['steps']} fused steps, compilations {comp}, "
          f"captures {tp_run['stats']['graph_captures']}, warm drain "
          f"captures {warm['stats']['graph_captures']}, replays "
          f"{warm['stats']['graph_replays']}")
    if comp["decode"] != 1 or comp["prefill"] != 1 \
            or tp_run["stats"]["eager_steps"] \
            or warm["stats"]["graph_captures"] \
            or warm["streams"] != tp_run["streams"]:
        raise AssertionError(f"tp={MESH_TP}: compilations {comp}, stats "
                             f"{tp_run['stats']}, warm {warm['stats']}; "
                             "want one capture per program and a warm "
                             "drain that repeats the streams")
    if any(tp_run["launches"].values()):
        raise AssertionError(f"tp={MESH_TP} launched hand-written kernels: "
                             f"{tp_run['launches']}")
    del eng
    torch.cuda.empty_cache()
    cl = EngineCluster(mesh_spec(True, MeshSpec(dp=MESH_DP)),
                       devices=dev_devices(MESH_DP, allow_repeat=True))
    cl.load(params)
    for e in cl.replicas:
        float_pools(e)
    dp_run = cluster_drain(cl, prompts)
    print(f"  (b) dp={MESH_DP} cluster, kernel route: rounds per replica "
          f"{dp_run['replica_steps']}, compilations "
          f"{dp_run['compilations']}, launches "
          f"{ {n: c for n, c in dp_run['launches'].items() if c} }")
    for c in dp_run["compilations"]:
        if c["decode"] != 1 or c["prefill"] != 1:
            raise AssertionError(f"dp={MESH_DP}: a replica's compilations "
                                 f"{dp_run['compilations']}")
    if not all(dp_run["replica_steps"]):
        raise AssertionError("a replica of the cluster served nothing")
    del cl
    torch.cuda.empty_cache()
    # (a) against (c)'s plain route, (b) against its kernels
    for label, got, want in ((f"tp={MESH_TP}", tp_run, base[False]),
                             (f"dp={MESH_DP}", dp_run, base[True])):
        f32_streams_equal(params, (None, prompts), got, want, f32_dist,
                          what=label)
    for label, got, want in (("(a) vs (c) kernels", tp_run, base[True]),
                             ("(b) vs (c) plain", dp_run, base[False])):
        same, _ = same_tokens(got["streams"], want["streams"])
        print(f"  {label}: identical tokens {same}/{n_tok} (reported: the "
              "plain route and the kernels sum in other orders)")
    del params
    torch.cuda.empty_cache()
    print(f"  phase 22 took {time.perf_counter() - t_start:.1f} s ({smi})")
    full = dict.fromkeys(KERNELS, 0)
    return {"mesh_tp": {**full, **tp_run["launches"]},
            "mesh_dp": {**full, **dp_run["launches"]}}


# ---------------------------------------------------------------------------
# phase 23: distributed training (ROADMAP Queue 1 item 16c)
# ---------------------------------------------------------------------------
DIST_SEED = 23
DIST_RANKS = 4                         # (a): four ranks share the card
DIST_BUFFERS = (1 << 20, 1_000_003)    # (a): f32 elements a rank
DIST_PP = dict(S=4, D=1024, NM=16, MB=8)
DIST_QWEN_LAYERS = 4                   # (b), (d)
DIST_SSM_LAYERS = 2                    # (c)
DIST_BATCH = (4, 64)
DIST_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# the sharded step against one device at f32: the loss as the CPU tests
# gate it; the gradient at phase 20a / 21b's card gate, 1e-4 x max|g|
# (each replica's weight gradients sum over its own rows, then the
# replicas' sums are added: another order of the same sum, 1.4e-5 x
# max|g| at falcon-mamba's x_proj); the params at the reference's bound
DIST_TOL = dict(loss=1e-5, grad=1e-4, params=5e-3)


def dist_mesh(data: int, model: int) -> sharding.Mesh:
    return sharding.Mesh((("data", data), ("model", model)),
                         tuple(dev_devices(data * model, allow_repeat=True)))


def dist_collectives(dev, g) -> None:
    """(a) The collectives and the compressed all-reduce on 4 ranks of the
    card, bit for bit the same schedule on the host; the pipeline against
    the sequential apply on the card."""
    for n in DIST_BUFFERS:
        card = [torch.randn(n, generator=g, device=dev)
                for _ in range(DIST_RANKS)]
        host = [t.cpu() for t in card]
        fns = {"ring_reduce_scatter": coll.ring_reduce_scatter,
               "ring_allreduce": coll.ring_allreduce,
               "all_gather": coll.all_gather}
        if n % DIST_RANKS == 0:
            fns["psum_scatter"] = coll.psum_scatter
        same = {}
        for name, fn in fns.items():
            a, b = fn(card), fn(host)
            same[name] = all(x.device == t.device and torch.equal(x.cpu(), y)
                             for x, y, t in zip(a, b, card))
        shard = (n + (-n) % DIST_RANKS) // DIST_RANKS
        ef_c = [comp.init_ef_state((shard,), dev) for _ in card]
        ef_h = [comp.init_ef_state((shard,)) for _ in host]
        rounds = []
        for _ in range(3):
            out_c, ef_c = comp.compressed_allreduce(card, ef_c)
            out_h, ef_h = comp.compressed_allreduce(host, ef_h)
            rounds.append(all(torch.equal(x.cpu(), y)
                              for x, y in zip(out_c, out_h))
                          and all(torch.equal(x.residual.cpu(), y.residual)
                                  for x, y in zip(ef_c, ef_h)))
        mean = torch.stack(host).mean(0)
        err = float((out_h[0] - mean).abs().max())
        same["compressed_allreduce x3"] = all(rounds)
        print(f"  (a) {DIST_RANKS} ranks x {n} f32 on the card vs the host: "
              + ", ".join(f"{k} {'bit for bit' if v else 'DIFFER'}"
                          for k, v in same.items())
              + f"; the compressed mean within {err:.2e} of the mean")
        if not all(same.values()):
            raise AssertionError(f"collectives on the card differ from the "
                                 f"host's: {same}")
    S, D, NM, MB = (DIST_PP[k] for k in ("S", "D", "NM", "MB"))
    ws = (torch.randn(S, D, D, generator=g, device=dev) / math.sqrt(D)) \
        .requires_grad_(True)
    bs = (torch.randn(S, D, generator=g, device=dev) * 0.1) \
        .requires_grad_(True)
    x = torch.randn(NM, MB, D, generator=g, device=dev)
    mesh = sharding.Mesh((("stage", S),), tuple(dev_devices(
        S, allow_repeat=True)))
    apply = make_pipelined_apply(lambda p, h: torch.tanh(h @ p[0] + p[1]),
                                 mesh)

    def seq(h):
        for i in range(S):
            h = torch.tanh(h @ ws[i] + bs[i])
        return h

    out, want = apply((ws, bs), x), seq(x)
    got_g = torch.autograd.grad((out ** 2).sum(), (ws, bs))
    want_g = torch.autograd.grad((want ** 2).sum(), (ws, bs))
    fwd = float((out - want).detach().abs().max())
    grad = max(float((a - b).abs().max()) for a, b in zip(got_g, want_g))
    print(f"  (a) GPipe, {S} stages on the card, D {D}, {NM} microbatches "
          f"of {MB} (bubble {(S - 1) / (NM + S - 1):.3f}): forward within "
          f"{fwd:.2e} of the sequential apply (gate 1e-5), gradient "
          f"{grad:.2e} (gate 1e-3)")
    if fwd > 1e-5 or grad > 1e-3:
        raise AssertionError("the pipeline disagrees with the sequential "
                             "apply")


def dist_batch(cfg: ArchConfig, g, dev) -> dict:
    B, S = DIST_BATCH
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=dev)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def dist_grads(label: str, model: Model, state, step, placed,
               batch) -> None:
    """The sharded step's loss, aux and assembled gradient against the one
    device's at ``DIST_TOL``."""
    loss, aux, grads = loss_and_grads(model, state.params, batch)
    s_loss, s_aux, s_grads = step.loss_and_grads(placed, batch)
    s_grads = sharding.assemble(s_grads)
    rel = max(abs(float(s_aux[k]) - float(aux[k])) / abs(float(aux[k]))
              for k in aux)
    scale = max(float(t.abs().max()) for t in grads.values())
    errs = {n: float((s_grads[n] - t).abs().max()) for n, t in grads.items()}
    worst = max(errs, key=errs.get)
    print(f"  {label}: loss {float(s_loss):.6f} / {float(loss):.6f} one "
          f"device, aux within {rel:.2e} relative (gate "
          f"{DIST_TOL['loss']}); gradient: worst {worst} "
          f"{errs[worst] / scale:.2e} x max|g| {scale:.4f} (gate "
          f"{DIST_TOL['grad']}), {len(errs)} leaves")
    if rel > DIST_TOL["loss"] or errs[worst] > DIST_TOL["grad"] * scale:
        raise AssertionError(f"{label}: the sharded gradient disagrees")
    del grads, s_grads


def timed_step(step, state, batch) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    return state, m, (time.perf_counter() - t0) * 1e3


def dist_qwen(dev, g, smi: str, tmp: str) -> None:
    """(b) qwen1.5-0.5b at 4 of 24 layers on (data 2, model 2) against one
    device; (d) saved there, restored at (4, 1)."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              num_layers=DIST_QWEN_LAYERS)
    oc = AdamWConfig(**DIST_OPT)
    model = Model(cfg, compute_dtype=torch.float32, device=dev,
                  trainable=True)
    s0 = init_state(model, g, oc)
    batches = [dist_batch(cfg, g, dev) for _ in range(3)]
    mesh = dist_mesh(2, 2)
    step, st_sh, _ = make_train_step(model, TrainStepConfig(
        optimizer=oc, donate=False), mesh=mesh)
    single = make_step_fn(model, TrainStepConfig(optimizer=oc,
                                                 donate=False))
    placed = sharding.place(s0, st_sh)
    shapes = {n: tuple(placed.params[n].shards[3].shape)
              for n in ("embed.table", "layers.0.attn.wq.kernel",
                        "layers.0.ffn.w2.kernel", "final_norm.scale")}
    print(f"  (b) {cfg.name} at its widths, {DIST_QWEN_LAYERS} of 24 "
          f"layers, on (data 2, model 2) = {mesh.devices}; rank 3's "
          f"shards {shapes}")
    dist_grads("(b) the gradient", model, s0, step, placed, batches[0])
    want, got, ms = s0, placed, []
    for i in range(2):
        want, wm, w_ms = timed_step(single, want, batches[i])
        got, gm, g_ms = timed_step(step, got, batches[i])
        ms.append((g_ms, w_ms))
        rel = abs(float(gm["loss"]) - float(wm["loss"])) \
            / abs(float(wm["loss"]))
        if rel > DIST_TOL["loss"]:
            raise AssertionError(f"(b) step {i + 1}: loss {gm['loss']} vs "
                                 f"{wm['loss']}")
    params = sharding.assemble(got.params)
    errs = {n: float((params[n] - w.detach()).abs().max())
            for n, w in want.params.items()}
    past = sum(int(((params[n] - w.detach()).abs() > 1e-4).sum())
               for n, w in want.params.items())
    total = sum(w.numel() for w in want.params.values())
    bound, by = train_bound(model, DIST_BATCH[0] * DIST_BATCH[1])
    print(f"  (b) two steps: losses {float(gm['loss']):.6f} (one device "
          f"{float(wm['loss']):.6f}); params within "
          f"{max(errs.values()):.2e} (gate {DIST_TOL['params']}), "
          f"{past} of {total} elements past 1e-4; second step "
          f"{ms[1][0]:.1f} ms sharded, {ms[1][1]:.1f} ms on one device, "
          f"bound {bound:.3f} ms ({by}); {smi}")
    if max(errs.values()) > DIST_TOL["params"]:
        raise AssertionError("(b) the sharded params after two steps "
                             "disagree")
    del params, placed
    # (d) save at (2, 2), restore at (4, 1), one step against (2, 2)'s
    t0 = time.perf_counter()
    ckpt.save(tmp, 2, got)
    straight, sm = step(got, batches[2])
    step41, sh41, _ = make_train_step(model, TrainStepConfig(
        optimizer=oc), mesh=dist_mesh(4, 1))
    restored, meta = ckpt.restore(tmp, 2, want, shardings=sh41)
    restored, rm = step41(restored, batches[2])
    a, b = sharding.assemble(restored.params), sharding.assemble(
        straight.params)
    err = max(float((a[n] - b[n]).abs().max()) for n in a)
    rel = abs(float(rm["loss"]) - float(sm["loss"])) / abs(float(sm["loss"]))
    print(f"  (d) saved at (2, 2) after step {meta['step']}, restored at "
          f"(4, 1): the next step's loss within {rel:.2e} relative, params "
          f"within {err:.2e} of the uninterrupted run; save, step and "
          f"restore took {time.perf_counter() - t0:.1f} s")
    if rel > DIST_TOL["loss"] or err > DIST_TOL["params"]:
        raise AssertionError("(d) the restored run disagrees")


def dist_ssm(dev, g, smi: str) -> dict:
    """(c) falcon-mamba-7b at 2 of 64 layers on (data 2, model 1): the
    gradient against one device's, then one step's scan launches."""
    cfg = dataclasses.replace(get_config(SSM), num_layers=DIST_SSM_LAYERS)
    oc = AdamWConfig(**DIST_OPT)
    model = Model(cfg, compute_dtype=torch.float32, device=dev,
                  trainable=True)
    s0 = init_state(model, g, oc)
    batch = dist_batch(cfg, g, dev)
    step, st_sh, _ = make_train_step(model, TrainStepConfig(optimizer=oc),
                                     mesh=dist_mesh(2, 1))
    placed = sharding.place(s0, st_sh)
    dist_grads(f"(c) {cfg.name} at its widths, {DIST_SSM_LAYERS} of 64 "
               "layers, (data 2, model 1)", model, s0, step, placed, batch)
    zero_counts()
    _, m, ms = timed_step(step, placed, batch)
    made = launch_counts()
    want = {k: 2 * v for k, v in program_launches(cfg, "train").items()}
    have = {k: made[k] for k in want}
    print(f"  (c) one sharded step, loss {float(m['loss']):.6f}: launches "
          f"{ {k: v for k, v in have.items() if v} } (kernels/counts.py, "
          f"2 replicas: { {k: v for k, v in want.items() if v} }), "
          f"{ms:.1f} ms; {smi}")
    if have != want:
        raise AssertionError(f"(c) the sharded step's launches {have} != "
                             f"{want}")
    return made


def check_distributed(dev, smi: str) -> dict:
    """Phase 23: the collectives and the pipeline (a), the sharded train
    step of a dense (b) and an ssm (c) model, an elastic restore (d).
    Every rank shares the one card: no speed is claimed."""
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev)
    g.manual_seed(DIST_SEED)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"\n== phase 23: distributed training, every rank on the one "
          f"card, f32 with TF32 off; {smi}")
    try:
        dist_collectives(dev, g)
        with tempfile.TemporaryDirectory() as tmp:
            dist_qwen(dev, g, smi, tmp)
        torch.cuda.empty_cache()
        made = dist_ssm(dev, g, smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    print(f"  phase 23 took {time.perf_counter() - t_start:.1f} s, peak "
          f"{peak_gb():.2f} GB ({smi})")
    return {"train_sharded": {**dict.fromkeys(KERNELS, 0), **made}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = runtime.build()
    runtime.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({lib.parent / 'build.log'})")
    print_ptxas(lib.parent / "build.log", "chunked_prefill.cu")
    print_ptxas(lib.parent / "build.log", "paged_attention.cu")
    # the bf16 main loop (mma_tile, dynamic shared memory) and its reduce,
    # in each of the four wrappers' instantiations, the int8 kernel and
    # its reduce, every instantiation of the norms and of flash attention
    # (hd <= 128 and the column-group kernels past it): no spills
    for src, kern in (("flash_attention.cu", "flash_"),
                      ("tiled_matmul.cu", "mma_"), ("ffn.cu", "mma_"),
                      ("qkv_proj.cu", "mma_"), ("int8_matmul.cu", "int8_"),
                      ("layernorm.cu", "norm_"),
                      ("ssm_scan.cu", "ssm_scan_kernel"),
                      ("ssm_scan.cu", "ssm_scan_bwd"),
                      ("rglru_scan.cu", "rglru_scan")):
        spills = {k: v for k, v in
                  print_ptxas(lib.parent / "build.log", src).items()
                  if kern in k and v[2]}
        if spills:
            raise AssertionError(f"{src}: {kern}* instantiations spill: "
                                 f"{spills}")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    timer = Timer(dev)
    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        print(f"-- {phase} took {now - clock[-1]:.1f} s ({now - t0:.1f} s "
              "since the build began)")
        clock.append(now)

    entries = {"tiled_matmul": check_matmul(timer, dev, g),
               "int8_matmul": check_int8_matmul(timer, dev, g)}
    entries.update(check_attention(timer, dev, g))
    entries.update(check_norms(timer, dev, g))
    entries.update(check_library(timer, dev, g))
    entries.update(check_scan(timer, dev, g))
    entries.update(check_ssm_scan(timer, dev, g))
    lap("phase 2")
    launches = {"ops": check_ops(dev, g)}
    lap("phase 3")

    model = Model.from_spec(full_width_spec(True), device=dev).init(g)
    params = model.state_dict()
    # gated at float32 compute: at bf16 any two valid orders of the sums
    # (the XLA-style path included) already differ by bf16 rounding that
    # grows over 24 layers, so the bf16 distances are printed beside it.
    # The fully quantized models take the same float weights, quantized as
    # they load.
    for quant in (False, True):
        qkw = dict(quant="int8", kv_dtype="int8") if quant else {}
        model32 = Model(model.cfg, compute_dtype=torch.float32, device=dev,
                        **qkw)
        model32.load_state_dict(params)
        steps32 = check_model_steps(model32, dev, g, gate=True)
        if not quant:
            # phase 8's yardstick of a float32 near-tie
            f32_dist = max(r["err"] for r in steps32.values())
        del model32
        m16 = Model.from_spec(full_width_spec(True, quant), device=dev)
        m16.load_state_dict(params)
        check_model_steps(m16, dev, g, gate=False)
        del m16

    lap("phase 4")
    print("\n== serving: full-width qwen1.5-0.5b, paged + chunked, "
          f"{len(PROMPT_LENS)} greedy requests x {MAX_NEW} new tokens, "
          "each fused program one CUDA graph (graphed) and eager")
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, model.cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    layers = model.cfg.num_layers
    del model
    n_tok = len(prompts) * MAX_NEW
    streams, timed = {}, {}
    for path in ("float", "int8"):
        quant = path == "int8"
        timed[path] = {mode: serve(params, prompts, quant=quant,
                                   graphs=mode == "graphed",
                                   warm=mode == "graphed")
                       for mode in ("graphed", "eager")}
        check_graphed(f"kernels, {path} weights", timed[path],
                      PATH_KERNELS[path], layers, n_tok)
        # the same engine drains the mix again on its captured graphs
        cold, warm = timed[path]["graphed"], timed[path]["graphed"]["warm"]
        same = sum(a == b for i in warm["streams"]
                   for a, b in zip(warm["streams"][i], cold["streams"][i]))
        print(drain_line(f"kernels, {path} weights, graphed, warm engine "
                         "(a second drain)", warm, n_tok)
              + f"; identical tokens to the first drain {same}/{n_tok}"
              + ("" if path == "float" else " (reported, not gated: idle "
                 "slots' stale rows join the int8 activation scale)"))
        if warm["compilations"] != cold["compilations"] \
                or warm["stats"]["graph_captures"] \
                or warm["launches"] != cold["launches"]:
            raise AssertionError(
                f"kernels, {path} weights: the warm drain captured again "
                f"({warm['compilations']}, {warm['stats']}) or launched "
                f"otherwise ({warm['launches']})")
        if path == "float" and warm["streams"] != cold["streams"]:
            raise AssertionError("the warm float drain's streams differ")
        streams[path] = timed[path]["graphed"]["streams"]
        launches[path] = timed[path]["graphed"]["launches"]
    # fault B: no fused step waits for the device (sync_every=4), captures
    # included.  The float streams are those of the sync_every=1 drain
    # (rows are computed independently); the fully-quantized ones are
    # reported: one int8 activation scale spans all B x W rows, finished
    # slots' rows among them, and at sync_every=4 a finished slot waits up
    # to 3 steps for its harvest
    for path in ("float", "int8"):
        got = no_sync_line(params, prompts, path == "int8")
        same = sum(a == b for i in got
                   for a, b in zip(got[i], streams[path][i]))
        print(f"  identical tokens to the sync_every=1 drain: {same}/{n_tok}"
              + ("" if path == "float" else " (reported, not gated)"))
        if path == "float" and got != streams[path]:
            raise AssertionError("the float streams at sync_every=4 differ "
                                 "from those at sync_every=1")
    # the fully-quantized streams must repeat on a fresh engine: duplicate
    # pool writes of dead lanes (int8 values and scales) resolve to one row
    again = serve(params, prompts, quant=True)
    same = sum(a == b for i in again["streams"]
               for a, b in zip(streams["int8"][i], again["streams"][i]))
    print(f"kernels, int8 weights, a second fresh graphed engine: {n_tok} "
          f"tokens in {again['dt']:.3f} s; identical tokens to the first: "
          f"{same}/{n_tok}")
    if again["streams"] != streams["int8"]:
        raise AssertionError("the fully-quantized streams differ between "
                             f"two fresh engines ({same}/{n_tok} equal)")
    for path in ("float", "int8"):
        quant = path == "int8"

        def make_engine(graphs, quant=quant):
            eng = ServingEngine(full_width_spec(True, quant), device="cuda",
                                graphs=graphs)
            eng.load(params)
            return eng
        host_and_device_line(f"kernels, {path} weights", make_engine,
                             prompts, timed[path])
    census_dependent_launches(params, dev, g)
    drain_estimate("tiled_matmul", entries["tiled_matmul"]["serving"],
                   layers, launches["float"], "library_ms", "torch.matmul")
    drain_estimate("int8_matmul", entries["int8_matmul"]["serving"], layers,
                   launches["int8"], "bf16_matmul_ms", "bf16 torch.matmul")
    plain = serve(params, prompts, kernels=False)
    print(drain_line("plain, float weights", plain, n_tok))
    for other, s_other in (("plain float", plain["streams"]),
                           ("kernels int8", streams["int8"])):
        same = sum(a == b for i in s_other
                   for a, b in zip(streams["float"][i], s_other[i]))
        print(f"identical tokens kernels float vs {other}: {same}/{n_tok} "
              "(reported, not gated: near-ties and quantization may flip)")
    lap("phase 5")
    check_harness(params)
    lap("phase 13 (its replays on phase 5's engines; phases 6 and 8 "
        "replay their traces on theirs)")
    del params
    torch.cuda.empty_cache()

    launches.update(check_fleet(dev, g, PROMPT_LENS))
    lap("phases 6 and 10")
    for path in ("fleet", "fleet_int8", "fleet_spec"):
        for name in PATH_KERNELS[path]:
            if launches[path][name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path} "
                                     "path")
    for name in PATH_KERNELS["fleet"]:
        entries[name]["live_kv"]["launches"] = launches["fleet"][name]

    launches.update(check_dense_family(dev, g, PROMPT_LENS))
    lap("phase 7")
    launches["prefix"] = check_prefix(dev, g, f32_dist)
    lap("phase 8")
    launches.update(check_speculation(dev, g, f32_dist))
    lap("phase 9")
    launches.update(check_moe(timer, dev, g))
    lap("phase 11")
    launches.update(check_adaptive(timer, dev, g))
    lap("phase 12")
    launches.update(check_mla(dev, g))
    lap("phase 14")
    launches.update(check_vlm(dev, g))
    launches.update(check_bucketed_qwen(dev, g))
    lap("phase 15")
    launches.update(check_hybrid(dev, g))
    lap("phase 16")
    launches.update(check_ssm(dev, g))
    lap("phase 17")
    launches.update(check_audio(dev, g))
    lap("phase 18")
    launches.update(check_encoder(timer, dev, g, smi))
    lap("phase 19")
    launches.update(check_train(dev, smi))
    lap("phase 20")
    scan_entries, scan_launches = check_train_scans(timer, dev, smi)
    entries.update(scan_entries)
    launches.update(scan_launches)
    lap("phase 21")
    launches.update(check_mesh(dev, g, f32_dist, smi))
    lap("phase 22")
    launches.update(check_distributed(dev, smi))
    lap("phase 23")
    for path in ("prefix", "spec", "spec_int8", "moe", "moe_int8",
                 "moe_spec", "mla", "mla_int8_pool", "vlm_chunked_paged",
                 "vlm_bucketed_dense", "vlm_bucketed_paged",
                 "bucketed_dense", "bucketed_paged", "hybrid", "ssm",
                 "audio", "encoder", "train", "train_scans",
                 "scans_served", "mesh_dp", "train_sharded"):
        for name in PATH_KERNELS[path]:
            if launches[path][name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path} path")

    table = []
    for name in KERNELS:
        src, replaces = SOURCES[name]
        e = entries[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": next(launches[p][name] for p in PATH_KERNELS
                                if name in PATH_KERNELS[p]),
               "launches_by_path": {p: launches[p][name] for p in launches},
               "max_abs_err": e["max_abs_err"], "ms": e["ms"],
               "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
               "bound_by": e["bound_by"], "library_ms": e["library_ms"],
               "shape": e["shape"]}
        for extra in ("int8_pool", "live_kv", "fault_f", "ctas", "groups",
                      "splits",
                      "smem_bytes",
                      "bm", "bn",
                      "bf16_matmul_ms", "other_shapes", "f32_shapes",
                      "fixed_splits", "plan", "timer_floor_ms"):
            if extra in e:
                row[extra] = e[extra]
        table.append(row)
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
