#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit, no result line):

1. Build: every `src/repro_torch/csrc/*.cu` with nvcc for sm_90a, one
   process per source, all started together (timed as set-up).
2. Kernel against its plain version on the card: the paged-attention
   kernel (flash-decoding: each chain's pages split across blocks by
   `ops.split_plan`, the f32 partials folded in split order by a second
   launch) on the reference's five test shapes and the main path's shape
   (batch 8, 16/8 heads, head_dim 128, 16-token pages, 512-token chains),
   in f32 (TF32 off) and bf16, with empty slots and poisoned pages beyond
   the causal frontier (the output must not move by one bit). Tolerance:
   2e-5 in f32, 2e-2 in bf16 (the JAX reference kernel test's own).
3. Serving, the main path: `ServeEngine(kv_layout="paged",
   decode_kernel="cuda", prefill_mode="bulk")` on qwen3-1.7b at full width
   (28 layers, d_model 2048, 16/8 heads, head_dim 128, d_ff 6144, vocab
   151936, tied) in bf16, random weights from a seeded CUDA generator,
   serving 10 requests of 64-256 prompt tokens and 32 new tokens each: two
   share a prefix (radix reuse with copy-on-write), one samples with a
   seed. The kernel's launch count is reset just before and read just
   after: it must equal 28 x the decode dispatches.
4. The kernel against the dense-gather oracle at full width in f32: the
   same model served by decode_kernel="cuda" and "reference" in lockstep.
   Logits agree within 1e-3 (absolute) at every step; a greedy token may
   differ only where the oracle's top-2 logit gap is below that tolerance.
5. Timings at the main path's shape: the kernel, its plain version, the
   bound (bytes it must move / 3.35 TB/s, the H100's memory rate) and
   `scaled_dot_product_attention` over the pre-gathered dense view (a
   library yardstick, timed here only; the port never calls it). The
   kernel and SDPA are timed two ways: per call from Python (CUDA events
   around a loop of calls, which counts the host's dispatch once it is the
   longer: the `ms` and `library_ms` of the kernels line, as every run has
   reported them) and on the card alone (the calls captured in a CUDA
   graph and replayed: `card_ms` and `library_card_ms`); beside them the
   previous design's times per call (PERF.md's kernel table).
6. Where a greedy batch-8 paged decode step's time goes (torch.profiler),
   with the paged kernel's share (both its launches) of the step.
7. The flash-attention kernel against its plain version: the reference's
   five test shapes, qwen3-1.7b's prefill (B=1, S=256, 16/8 heads, hd 128)
   and recurrentgemma-9b's (B=1, S=2560, 16/1 heads, hd 256, window
   2048); f32 (TF32 off, the CUDA-core template) at 2e-5, bf16 (the
   tensor-core template: mma.sync with cp.async double buffering) at 2e-2.
8. The RG-LRU scan kernel (a chunked scan in one pass: 64-step tiles of
   128 channels, each tile's carry folded from the earlier tiles'
   aggregates in chunk order) against its plain version: the reference's
   three test shapes and recurrentgemma-9b's (1, 2560, 4096); f32 at 1e-4,
   bf16 inputs at 5e-2.
9. Serving on the dense layout: `ServeEngine(kv_layout="dense",
   prefill_mode="bulk", batch_slots=8, cache_len=512)` on qwen3-1.7b with
   attention_impl="pallas", bf16, phase 3's weights and requests. The
   flash kernel must launch 28 x the bulk prefills and the paged kernel
   not at all. Then, in f32, the same engine with "pallas" against "xla"
   in lockstep: prefill and decode logits within 1e-3, a greedy token may
   differ only where the "xla" run's top-2 gap is below that.
10. Serving recurrentgemma-9b at full width (38 layers, d_model 4096, 16/1
   heads, hd 256, lru width 4096, vocab 256000) on the dense layout in
   bf16 with attention_impl="pallas": `batch_slots=4, cache_len=2048`, six
   prompts of 64-512 tokens and one of 2560 (past the 2048 window: the
   ring wraps), 16 new tokens each, one sampled. The scan kernel must
   launch 26 x and the flash kernel 12 x the bulk prefills. A greedy
   batch-4 decode step and the 2,560-token bulk prefill are profiled, with
   the flash kernel's and the scan's shares of the prefill. Then the f32
   check of "pallas" against "xla" at full width, depth cut to one block
   plus the tail (r, r, a, r, r: 5 layers), as in phase 9.
11. Timings of the new kernels at their main-path shapes: kernel, plain
   version, bound (the larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s,
   the H100's dense bf16 tensor rate, for flash; bytes for the scan) and,
   for flash, `scaled_dot_product_attention` (causal with GQA, or an
   explicit window mask; timed here only, the port never calls it); flash
   and SDPA per call from Python and on the card alone, as in phase 5,
   beside the previous design's times; the scan's time per call and on
   the card alone, beside its previous design's (one thread per channel;
   PREVIOUS_SCAN_MS).
12. The SSD chunked-scan kernel against its plain version (the sequential
   recurrence): the reference's four test shapes, a ragged sequence (1,
   1000, 24 heads, hd 64, d_state 128) and mamba2-130m's 2,048-token
   prefill; f32 (TF32 off) at 2e-4, bf16 x/B/C at 5e-2 (the reference
   kernel test's own). Each case logs its route: bf16 tiles the tensor
   cores take run three passes on them (chunk states, carry, output),
   f32 and the rest the first design, on the CUDA cores.
13. Serving mamba2-130m at full width and depth (24 layers, d_model 768,
   24 SSM heads of hd 64, d_state 128, chunk 256, vocab 50280, tied) on
   the dense layout in bf16 with attention_impl="pallas": `batch_slots=8`,
   ten prompts of 64-1,024 tokens (300 and 777 among them: not multiples
   of the chunk, which the reference's Pallas route refuses) and one of
   2,048, 32 new tokens each, one sampled. The SSD kernel must launch 24 x
   the bulk prefills, every call on the tensor-core route, and no other
   kernel at all. A greedy batch-8 decode step and the 2,048-token bulk
   prefill are profiled, with the SSD kernel's share of the prefill. Then,
   in f32 at full depth, "pallas" against "xla" in lockstep, as in phase
   9.
14. Timings of the SSD kernel at the 2,048-token prefill (bf16 x/B/C, f32
   dt): kernel, plain version and bound (the larger of bytes / 3.35 TB/s
   and flops / 989 TFLOP/s, counting the score products over the visible
   pairs of the reference's 256-token chunks), per call and on the card
   alone, beside the first design's (PREVIOUS_SCAN_MS); no single PyTorch
   call computes SSD, so no library time.
15. Fused decode: phase 3's engine with `fused_tokens=8` on phase 3's bf16
   weights and requests. While every live slot is greedy a dispatch is one
   CUDA graph replay of 8 decode steps (captured at the first fused
   dispatch, after two eager warm-up runs that write only the null page);
   the sampled request's batches take single steps. The paged kernel must
   launch exactly 28 x (8 x (replays + warm-up runs) + single dispatches):
   a replay adds the launches its capture recorded. Logs ms per dispatch
   and per decode position beside phase 3's single step, and profiles a
   greedy batch-8 dispatch (device busy share of a replay). Then, in f32
   on phase 4's model, the fused greedy tokens must equal phase 4's
   single-step "cuda" tokens, except after a first divergence at a token
   whose top-2 logit gap in that run is below 1e-3.
16. Speculative decode, `spec_tokens=4`: with the n-gram drafter on phase
   3's bf16 weights and requests (the verify forward is a dense gather, no
   kernel: the paged kernel must launch exactly 28 x the single-step
   dispatches), then in f32 with depth cut to 4 layers, drafting with a
   `ModelDrafter` on the target's own weights: tokens against the single-
   step run under the top-2 rule, acceptance at least 0.9. Logs tokens
   per dispatch, acceptance and rollbacks.
17. Chunked prefill, `scheduler="chunked", chunk_budget=64` on phase 3's
   bf16 weights and requests: the paged kernel (the mixed step's decode
   rows, its second caller) must launch exactly 28 x (mixed + single
   dispatches). Logs ms per mixed dispatch and, with a 256-token prompt
   arriving among 7 decoding requests, the longest gap between two tokens
   of a decoding request, chunked and phased. Then the f32 tokens on phase
   4's model against its single-step run under the top-2 rule.
18. The gateway, synchronous: `Gateway.build(replicas=2, batch_slots=8,
   kv_layout="paged", policy="prefix-affinity", device="cuda")` (phase 3's
   engine settings on each replica, the paged read each engine's default:
   the kernel) on phase 3's bf16 weights and requests, submitted through
   `gw.submit` and driven by `gw.run()`. Every request must finish, the
   two prefix-sharing requests must land on one replica whose radix cache
   reports a hit, and the paged kernel must launch exactly 28 x the decode
   dispatches of both replicas. Logs tokens/s and the time to first token
   and between tokens (p50, p95) from the gateway's metrics. Then the
   launcher as a user starts it: `python -m repro_torch.launch.serve
   --arch qwen3-1.7b --kv-layout paged --decode-kernel pallas --replicas 2
   --requests 8 --workload synth` (reduced qwen3-1.7b, as the reference's
   launcher serves it) must exit 0 with its `[serve] N requests` line. In
   f32 on phase 4's model, each request's tokens through the gateway must
   equal a lone engine's under the top-2 rule.
19. The gateway with async replica workers (one thread per replica),
   `fused_tokens=8` and a chaos plan that crashes replica 0 at its 3rd
   dispatch, with a probation window short enough that it rejoins within
   the phase (0.05 s; the crashed requests wait 0.1 s before they are
   placed again, so some come back to it): its reset releases its fused
   graph, and it captures again while replica 1 replays its own (the
   capture is thread-local, on a stream of its own; the kernel's launch
   counts are per thread; each engine steps on a stream of its own).
   Greedy requests, bf16 as in phase 18, after a warm-up round in which
   each replica captures its graph: every request must finish, the crash
   must fire once, replica 0 must rejoin and capture again (replica 1
   not at all), replica 1 must run a fused dispatch while replica 0 captures
   (its first request decodes 320 tokens, to keep it replaying), and the
   paged kernel's launches must be exactly 28 x (8 x (replays + warm-up
   runs) + single dispatches) over both replicas. Logs captures, replays,
   the faults fired and the reintegration. In f32 (phase 3's request
   shapes, 32 new tokens each), its tokens must equal phase 18's
   synchronous run's under the top-2 rule.
20. Training, after phase 14: full-width, full-depth qwen3-1.7b in f32
   (TF32 off, attention_impl="xla", as the reference trains; seeded
   random weights) takes 8 AdamW steps under the launcher's warmup-cosine
   schedule on the synthetic token stream, 8 x 256 tokens a step: every
   loss finite, the last below the first. Logs each step's loss, grad norm
   and ms, the median step of steps 2-8, tokens/s, TFLOP/s as 6 N tokens
   per step, the peak device memory and a profiled step (device busy share,
   leading ops), beside the card's name and power limit. Then the first
   batch again from the same weights with microbatches=2 (loss within
   1e-3, params within the reference's own atol 5e-4 / rtol 5e-3) and with
   remat=True (loss and grad norm within 1e-5 relative, a lower peak).
21. Full-width qwen3-1.7b cut to 2 layers: three f32 steps on the card and
   on the CPU from the same weights and batches, loss and grad norm within
   1e-4 relative each step. Full-width, full-depth mamba2-130m trains 8
   steps (the SSD "xla" route's backward), loss falling; full-width
   recurrentgemma-9b at one pattern block (3 layers: 9.4 B parameters with
   AdamW's moments do not fit at full depth) trains 3 steps.
22. The kernels on the training path: forward_train with
   attention_impl="pallas" under no_grad on phase 21's trained models,
   logits within 1e-3 of "xla", each kernel launched exactly once per
   layer of its type; the same call with grad enabled refused
   (NotImplementedError: no kernel has a backward, as none of the
   reference's has), and each of the four wrappers refusing a gradient on
   CUDA tensors before it launches. Then `python -m
   repro_torch.launch.train --arch qwen3-1.7b --reduced --steps 20 --device
   cuda --ckpt-dir build/chip_smoke_train_ckpt` must exit 0 with its loss
   falling; its checkpoint (the reference's layout) is restored into the
   port's params and serves a request through the paged kernel.
23. The paper's layer-design sweep, after phase 22, on the sweep
   launcher's dataset (2,000 rows, 12 features, 4 classes), f32 with TF32
   off. A population block of 256 members (the scheduler's max_block) of
   the launcher's widest depth and width, 4 x 128 (relu: with
   ("relu", "tanh") the tanh before the output layer bounds the logits,
   and SGD at 1e12 stays finite, in the reference too), SGD with momentum
   0.9, learning rates drawn from the launcher's (1e-3, 3e-3), the last
   member at 1e12, 2 epochs (after a first block of 4 of them, which
   takes the first calls' set-up): every member but the last "ok", the
   last "failed" and frozen in-graph. Logs ms a step, tasks/s and a
   profiled step (device busy share). Eight of its members are each held
   against `dnn_train` on their payloads on the card: loss within 1e-5
   relative, accuracy within one test row, params within 1e-4 of each
   leaf's max.
   So is an 8-member AdamW block of ("relu", "tanh"), in loss and
   accuracy; its params' distance is logged, not bounded (Adam carries
   the batched and single GEMMs' one-ulp differences across a relu's
   boundary into whole updates: up to 7.1e-3 of a leaf's max). Then
   `python -m
   repro_torch.launch.sweep --n-tasks 256 --workers 2 --epochs 2` must
   exit 0 with "0 failed" and its four artifacts (both planes: blocks and
   queued tasks), and `lm_train` on reduced qwen3-1.7b through a `Worker`
   on the card must give a finite loss and report the "cuda" backend.
24. The MoE family, after phase 23: granite-moe-1b-a400m at full width and
   depth (24 layers, d_model 1024, 16/8 heads, hd 64, 32 experts top-8,
   expert d_ff 512, capacity factor 1.25, vocab 49155, tied) in bf16 on
   phase 3's engine and request set (its own vocabulary): the paged kernel
   must launch 24 x the decode dispatches; then `fused_tokens=8` (graph
   replays, launches 24 x (8 x (replays + warm-up runs) + single
   dispatches)); the dense layout with "pallas", whose flash kernel must
   launch 24 x the bulk prefills; a profiled greedy batch-8 decode step
   with the MoE FFNs' time at its shape on the card alone; and in f32 the
   paged kernel against the dense-gather oracle in lockstep, as in phase
   4, with the oracle's MoE on the GShard buffer path in every group, so
   that the lockstep also holds the grouped MoE experts kernel (phase 38)
   against the buffer path. A decode position is a group no entry of
   which can be dropped, so on every one of these paths each layer's MoE
   runs the grouped kernel in each decode step: its launches must be 24 x
   the decode steps (single, fused as the paged kernel's, dense; the f32
   run's "cuda" side), 0 on the oracle's side; the prompts (64-256 tokens)
   keep the buffer path. The MoE at S > C runs batched matrix products, as
   the reference's are einsums outside any Pallas kernel.
25. granite-moe-3b-a800m at full width and depth (32 layers, d_model 1536,
   24/8 heads, 40 experts top-8) in bf16: four requests on the paged path
   (launches 32 x the decode dispatches), then fused (at least one graph
   replay); the grouped MoE experts kernel 32 x the decode steps on both.
   Every other serving phase's model has no MoE: the grouped kernel must
   not launch there.
26. The encoder-decoder: seamless-m4t-large-v2 at full width and depth
   (24 encoder + 24 decoder layers, d_model 1024, 16/16 heads, d_ff 8192
   ReLU, vocab 256206, tied) in bf16 with "pallas": `forward_prefill` on
   two rows of 400 random encoder frames and a 64-token prompt, the caches
   (cross K/V included) copied into a dense cache, then 16 greedy tokens
   by `decode_step` over the cross caches. The flash kernel must launch 24
   x per prefill (the decoder's self-attention: the encoder and the
   cross-attention read densely, as the reference sends only causal
   self-attention to its kernel) and nothing in the decode. Then in f32 at
   full width, depth cut to 2 + 2 layers, "pallas" against "xla", the
   "pallas" run fed the "xla" run's tokens: logits within 1e-3 at the
   prefill and every step.
27. The modality prefix: pixtral-12b at full width and depth (40 layers,
   d_model 5120, 32/8 heads, hd 128, d_ff 14336, vocab 131072, untied) in
   bf16 with "pallas": `forward_prefill` on 1,024 random patch embeddings
   (a 512 x 512 image at 16-pixel patches) and 64 text tokens, then 16
   greedy tokens from position 1,088; flash launches 40 per prefill. Then
   the f32 check of phase 26 at depth 2.
28. Distribution, after phase 27, on a one-rank NCCL process group
   (`launch.distributed.initialize`) and a (1, 1, 1) ("pod", "data",
   "model") DeviceMesh on the card: `train_sharded` on phase 20's model,
   weights (the same seed) and batches, 8 steps of 8 x 256 tokens, f32 with
   TF32 off, under the same AdamW warmup-cosine schedule and rate as phase
   20's unsharded `build_lm_train_step`, whose losses are the oracle
   (within 1e-5 relative); every param and moment a DTensor on the card.
   Logs step ms (median of steps 2-8), peak memory and a profiled sharded
   step's device busy share beside phase 20's. Then phase 23's 256-member
   block with `mesh=` (population_axes ("data",)) against phase 23's
   results: the same statuses, losses within 1e-5 relative, accuracies
   within one test row. Then the dry-run CLI as two subprocesses, started
   together: qwen3-1.7b decode_32k on the (16, 16) production mesh and
   granite-moe-1b-a400m train_4k on (2, 16, 16) (fake process groups of
   256 and 512 ranks on the host, nothing allocated): exit 0 and
   flops_per_device > 0. The process group is destroyed at the end.
29. Tensor parallelism, after phase 28: two model ranks, each a process
   of its own on the one card (NCCL refuses two ranks on one device;
   gloo all-reduces CUDA tensors, first probed), joined by
   `tcp://127.0.0.1:<free port>` on a (1, 1, 2) ("pod", "data", "model")
   mesh: `train_sharded` on phase 20's model, weights and rate, 4 steps
   of 8 x 256 tokens, f32 with TF32 off, runs tensor parallel
   (`sharding.tp`: each rank its 8 of 16 query heads and 4 of 8 kv heads,
   half the FFN columns and half the vocabulary; the batch axes have size
   1, so every collective is an all-reduce and every shard is cut locally
   from the same seeded init). The oracle is the unsharded step on the
   same weights, batches and 4-step schedule, run first in this process
   (as in phases 30-34). Both ranks' losses within 1e-4 relative of its,
   exactly 4 x 28 + 5 model-axis all-reduces a step, and under no_grad
   each rank's attention_impl="pallas" forward on its local heads (28
   flash launches a rank) within 1e-3 of "xla", the logits (B, S, V/2).
   Logs each rank's step ms, per-rank peak memory (the set-up's and the
   steps') and rank 0's profiled step beside the unsharded run's. The
   ranks are joined with a timeout and killed if still alive.
30. Tensor parallelism for the MoE decoder, after phase 29, on phase 29's
   machinery (two ranks, gloo, (1, 1, 2), f32 with TF32 off, "xla"):
   granite-moe-1b-a400m at full width and depth (24 layers, d_model 1024,
   16/8 heads, 32 experts top-8, expert d_ff 512; its vocabulary of
   49,155 padded to 49,408, a multiple of 256 as the dry-run pads it, so
   two ranks split it), expert parallel (16 experts a rank; the routing,
   the capacity slots and the aux losses whole on each rank), 4 AdamW
   steps of 8 x 256 tokens. The oracle is the same seeded weights and
   batches through the unsharded step in this process on the card, run
   first: both ranks' losses within 1e-4 relative, exactly 5 x 24 + 5
   model-axis all-reduces a step, and each rank's "pallas" forward on its
   8 query / 4 kv heads (24 flash launches a rank) within 1e-3 of "xla".
   Logs step ms, rank 0's busy share, the per-rank peak beside the
   unsharded run's, and the dropped fraction.
31. The encoder-decoder, the same way: seamless-m4t-large-v2 at full width
   and depth (24 + 24 layers, d_model 1024, 16/16 heads, d_ff 8192, vocab
   256206), 4 steps of 4 rows of 400 stub encoder frames + 256 tokens;
   the encoder and every cross-attention split by heads, the encoder
   output sent into the split once: exactly 4 x 24 + 6 x 24 + 1 + 5
   all-reduces a step, flash on each rank's 8 heads in the decoder's
   self-attention only (24 launches a rank).
32. The MoE load balance on a data-parallel mesh under remat, after phase
   31: granite-moe-1b-a400m at full width, its depth cut to 4 layers, f32
   with TF32 off, remat on, the load-balance coefficient raised from 0.01
   to 1 (its gradient then weighs on the router's); two data ranks, each a
   process on the one card over gloo, on a (1, 2, 1) mesh (the gathered
   step: no model split). Step 1's gradients on 8 x 256 tokens (4 rows a
   rank), leaf by leaf within 1e-5 of each leaf's max of one device's on
   the whole batch (in each rank's process), the loss within 1e-4
   relative, and exactly 3 all-reduces over the data axis a layer (the
   means' forward, the checkpoint's recompute on autograd's own thread,
   the backward), the load balance within 1e-6 relative of one device's.
33. Tensor parallelism for the RG-LRU hybrid, after phase 32, on phase
   29's machinery (two model ranks, gloo, (1, 1, 2), f32 with TF32 off,
   "xla", the unsharded step run first in this process as the oracle):
   recurrentgemma-9b at full width (d_model 4096, lru width 4096, 16/1
   heads of 256, d_ff 12288, vocab 256000, tied), its depth cut to one
   pattern block (r, r, a) as phase 21 cuts it (1.71 B parameters: the
   full depth with AdamW's moments needs about 144 GB), 4 AdamW steps of
   8 x 256 tokens. Each rank runs its 2,048 of the 4,096 RG-LRU channels
   (the gates read the conv output gathered over the ranks), its 8 of 16
   query heads (the one kv head projected on both), half the FFN columns
   and half the vocabulary: both ranks' losses within 1e-4 relative,
   exactly 6 x 2 + 4 + 5 + 4 = 25 model-axis all-reduces a step (the
   last 4: wk and wv, stored split, gathered and their gradients
   reduced), and each
   rank's "pallas" forward on its channels and heads (2 RG-LRU scan and 1
   flash launches a rank) within 1e-3 of "xla".
34. Mamba2 the same way: mamba2-130m at full width and depth (24 layers,
   d_model 768, 24 SSM heads of 64, d_state 128, chunk 256, vocab 50280,
   tied), 4 steps of 8 x 512 tokens (every row crosses a chunk boundary,
   so the carried state is in the gradient). Each rank runs its 12 heads
   (their z, x and dt columns of the gathered in_proj and the one group's
   B/C, the conv, the SSD, the gated RMSNorm's sum of squares all-reduced
   over the ranks) and half the vocabulary: exactly 4 x 24 + 5 + 4 x 24
   = 197 all-reduces a step (in_proj and conv_w, stored split by
   contiguous columns, gathered and their gradients reduced in every
   layer), the "pallas" forward with 24 SSD launches a rank on 12 heads.
35. The serving steps tensor parallel, after phase 34, on phase 29's
   machinery (two model ranks, gloo, (1, 1, 2), f32 with TF32 off, the
   unsharded steps run first in this process as the oracle): qwen3-1.7b
   at full width and depth, 4 prompts of 256 tokens prefilled with
   attention_impl="pallas" (28 flash launches a rank, on its 8 query / 4
   kv heads) by `spmd.call_split` (the caches moved from the rank's kv
   heads to head_dim over "model" by all-reduce: gloo runs no all-to-all
   on CUDA tensors), handed into a 1,024-slot decode cache whose sequence
   is split 512/512 over the ranks (`serve.step.prefill_into_cache_split`),
   then 16 greedy decode steps on the unsharded run's tokens (each rank
   reads all heads over its slots, the partials merged). The tokens equal
   the unsharded run's except where its top-2 gap is below 1e-3, the
   logits of the prefill's last position, of every 8th step and of the
   last within 1e-3 (a second call on the same inputs: gloo stages every
   all-reduce of a CUDA tensor through the host, a few hundred ms a
   call), exactly 58 + 56 all-reduces in the
   prefill, 56 in the handoff and 4 x 28 + 2 a decode step, each rank's
   cache bytes exactly half the unsharded run's. Logs step ms and rank
   0's profiled step.
36. The same, 8 greedy steps each, for granite-moe-1b-a400m (its
   vocabulary padded to 49,408; expert parallel, the routing whole on
   each rank; 98 all-reduces a decode step) and seamless-m4t-large-v2
   (400 encoder frames a row, the cross caches split 200/200; 7 x 24 + 2
   a decode step).
37. The same for the recurrent families, 8 greedy steps each:
   recurrentgemma-9b at full width, one pattern block (r, r, a) deep as
   phase 33 cuts it (its decode ring of 1,024 slots split 512/512; each
   rank runs its 2,048 RG-LRU channels, 8 query heads and half the FFN
   and vocabulary), and mamba2-130m at full width and depth (each rank
   its 12 SSM heads). Each recurrent state stays whole on every rank
   (the reference's batch-only layout): the prefill gathers it, the
   handoff copies it, and a decode step cuts the rank's channels or heads
   out of it, steps them and gathers the new state, one all-reduce a
   layer. Exactly 14, 2 and 16 all-reduces (recurrentgemma: prefill,
   handoff, a decode step; its wk and wv gathered) and 122, 0 and 122
   (mamba2: in_proj and conv_w gathered in every layer); each rank's
   cache bytes half the attention cache's plus the whole states; launches
   a rank: flash 1 and the RG-LRU scan 2 (recurrentgemma), SSD 24 on the
   CUDA-core route (mamba2, f32). Phases 35-37 share one pair of rank
   processes. `tools/probe_tp.py --phases 35,36,37` runs 35-37 alone.
38. The grouped MoE experts kernel (csrc/moe_experts.cu: the one-block
   dispatch sort, then gate/up and down over each held expert's rows)
   against its plain version (MOE_CASES): at the benchmark cells' decode
   shapes in bf16, granite-moe-3b-a800m's (64 rows, 40 experts top-8, d
   1,536, ff 512) and granite-4.0-h-small's (64 rows, experts 0-35 of 72
   held, top-10, d 4,096, ff 768); at granite-moe-1b-a400m's (32 experts
   top-8, d 1,024, ff 512) at 64 rows and at phases 24-25's batch of 8
   rows (most experts 0-2 rows: the early exit and partial M tiles), and
   granite-moe-3b-a800m's at 8; and granite-moe-1b-a400m's at 8 rows in
   f32 (TF32 off), the CUDA-core route phase 24's f32 lockstep runs. The
   dispatch equals the plain stable sort exactly; the widest row's
   relative error stays within MOE_REL_TOL of the dtype (bf16 0.02, f32
   1e-5), which two planted faults of the plain version must exceed (an
   entry's row read from the next token's, an expert's rows run on the
   next expert's weights). Timed per call from Python, on the card alone (a CUDA graph),
   with the dispatch, beside the bound (the held experts' three matrices
   once / 3.35 TB/s) and the plain version. Runs after phase 12;
   `tools/probe_moe_experts.py` runs it alone.
39. The Mamba2 decode state step kernel (csrc/mamba_state.cu: each live
   slot's f32 state read once and written once in place, y = C h' in the
   same pass) against its plain version (MAMBA_STATE_CASES): docqa's
   decode step, granite-4.0-h-small's 128 heads of 64 x 128 over 64 slots
   with x, B and C bf16 views of the conv output laid out slot-minor, as
   the served decode's einsum gives it, every slot live and every other
   slot dead, and every slot live with a row-major conv output. h' within
   1e-6 of its largest value and y within 1e-5 of the row's sum of |C h'|
   (the card test's tolerances), a dead slot's state bit for bit and its
   y zero; a graph of the timed calls captures one launch a call
   (`mamba_state.launches` counts through `kernels.count_launch`). Timed
   on the card alone (a CUDA graph) beside the bound (each live slot's
   state read and written once, x, B, C and dt read once / 3.35 TB/s)
   and the plain version (three passes over the whole state). Runs after
   phase 38; `tools/probe_mamba_state.py` runs it alone.
40. granite-4.0-h-small at full width and depth (36 Mamba2 and 4 NoPE
   attention layers; HYBRID_HELD = 4 of its 72 experts held, which no
   count reads), bf16, "pallas", served on the paged layout with fused
   decode graphs of FUSED_TOKENS steps, as the benchmark's docqa cell
   serves it: phase 15's requests through `serve_variant`, whose counted
   run requires mamba_state == 36 x the decode steps (fused_tokens x
   (graph replays + warm-up runs) + single dispatches), paged_attention
   == 4 x the same, ssd_scan == 36 and flash_attention_paged == 4 x the
   bulk prefills, moe_experts == 40 x the decode steps, nothing else.
   Every other serving phase (3, 9, 10, 13, 15-17, 24-25) requires
   mamba_state == 0: none runs a Mamba2 layer on the paged layout. Runs
   after phase 39.

The last line of stdout is ``{"ok": true, "device": {...}}``; above it
stand the card's name and power limit and one JSON line with each
kernel's numbers (the SSD kernel's launches also by route, the paged
kernel's also by path).
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM f32, outside the tensor cores
BF16_TENSOR_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# flash attention: the reference's kernel test shapes (tests/test_kernels.py
# FA_CASES, Sq = Sk) and the two main paths': B, S, nh, nkv, hd, window
FLASH_CASES = [
    (2, 64, 4, 2, 32, None),
    (1, 128, 8, 1, 64, 32),
    (2, 32, 4, 4, 64, None),
    (1, 40, 2, 2, 16, None),
    (1, 64, 6, 2, 32, 16),
    (1, 256, 16, 8, 128, None),         # qwen3-1.7b prefill
    (1, 2560, 16, 1, 256, 2048),        # recurrentgemma-9b prefill
]
# the paged flash variant (the paged bulk prefill's read, no TPU
# counterpart) on its benchmark's tables: mistral-nemo-12b's heads over
# 4,352 positions, a 2,048-token document from position 0 and a 64-token
# question on a 4,000-token cached prefix; granite-moe-3b's over 2,048, a
# 512-token prompt from 0: S, start, n_tok, nh, nkv, hd, bs, nb
PAGED_FLASH_CASES = [
    (2048, 0, 2048, 32, 8, 128, 16, 272),
    (64, 4000, 64, 32, 8, 128, 16, 272),
    (512, 0, 512, 24, 8, 64, 16, 128),
]
# its bf16 check: the widest error of one (real row, head) output vector,
# |got - want| / |want| over head_dim; a sound kernel reads a few bf16
# roundings, a planted fault (one page read from the wrong block, or the
# causal mask one key late) tens of percent (PERF.md section 6, row 5)
PAGED_FLASH_REL_TOL = 0.02
# RG-LRU scan: the reference's (RGLRU_CASES) and recurrentgemma-9b's: B, S, C
SCAN_CASES = [(2, 32, 64), (1, 100, 130), (2, 16, 16), (1, 2560, 4096)]
# SSD scan: the reference's (tests/test_kernels.py SSD_CASES), a ragged
# sequence and mamba2-130m's 2,048-token prefill: b, s, h, p, g, n, chunk
SSD_CASES = [
    (2, 32, 4, 16, 1, 8, 8),
    (1, 64, 2, 8, 2, 16, 16),
    (2, 16, 4, 32, 1, 32, 16),
    (1, 128, 3, 16, 1, 8, 32),
    (1, 1000, 24, 64, 1, 128, 256),
    (1, 2048, 24, 64, 1, 128, 256),
]
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
LOGIT_TOL = 1e-3
FUSED_TOKENS = 8                   # phase 15's fused dispatch (and 19's)
CHUNK_BUDGET = 64                  # phase 17's chunks
SPEC_F32_LAYERS = 4                # phase 16's f32 check: depth cut to this
CRASH_PLAN = "crash@d2:r0"         # phase 19: replica 0's 3rd dispatch raises
PROBATION_S = 0.05                 # phase 19: then it rejoins after this,
RETRY_BACKOFF_S = 0.1              # before its requests are placed again;
LONG_TOKENS = 320                  # replica 1's long request meanwhile
LAUNCHER_TIMEOUT_S = 300
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 256    # phase 20
TRAIN_LR = 3e-4                    # the train launcher's default peak rate
CPU_LAYERS, CPU_BATCH, CPU_SEQ = 2, 2, 64          # phase 21, card vs CPU
CARD_CPU_REL = 1e-4                # its loss and grad-norm tolerance
RGEMMA_TRAIN_LAYERS = 3            # phase 21: one pattern block
EVAL_SEQ = 256                     # phase 22's "pallas" forward
LAUNCH_STEPS = 20                  # phase 22's train launcher run
# phase 23, the sweep: the launcher's dataset, widest design (4 x 128) and
# learning rates; a population block of the scheduler's max_block members
SWEEP_K = 256
SWEEP_HIDDEN = [128] * 4
SWEEP_LRS = (1e-3, 3e-3)
SWEEP_EPOCHS, SWEEP_BATCH = 2, 128
DIVERGENT_LR = 1e12                # the block's last member: frozen, failed
SWEEP_CHECKED = 8                  # members held against dnn_train
PLANES_REL, PARAM_TOL = 1e-5, 1e-4  # the CPU tests' member-vs-dnn_train
SWEEP_TASKS, SWEEP_WORKERS = 256, 2  # the launcher's run
# the reference's kernel test shapes (tests/test_paged_attention_kernel.py)
# and the main path's: B, nb, bs, nkv, rep, hd, tokens resident per slot
KERNEL_CASES = [
    (2, 4, 8, 2, 2, 32, (32, 32)),
    (2, 4, 8, 4, 1, 32, (32, 19)),
    (3, 4, 8, 1, 4, 64, (9, 1, 27)),
    (4, 3, 16, 2, 2, 32, (17, 0, 48, 0)),
    (1, 6, 8, 2, 3, 16, (41,)),
    (8, 32, 16, 8, 2, 128, (512, 300, 1, 0, 17, 256, 511, 64)),
]
MAIN_SHAPE = (8, 32, 16, 8, 2, 128, (512,) * 8)
# the previous design of each attention kernel, per call from Python on an
# H100 80GB HBM3 at 700 W (PERF.md's kernel table), logged beside this
# run's: (kernel ms, SDPA ms)
PREVIOUS_MS = {"paged_attention": (0.1426, 0.0246),
               (1, 256, 16, 8, 128, None): (0.0610, 0.0547),
               (1, 2560, 16, 1, 256, 2048): (2.9387, 0.5069)}
# the previous design of each scan (the RG-LRU walk of one thread per
# channel, the SSD kernel on the CUDA cores), per call from Python and on
# the card alone, on an H100 80GB HBM3 at 700 W (PERF.md's kernel table)
PREVIOUS_SCAN_MS = {"rglru_scan": (0.2711, 0.2701),
                    "ssd_scan": (0.9742, 0.9617)}


def log(msg: str):
    print(msg, flush=True)


def entry_name(mangled: str) -> str:
    """'paged_attention_split<bf16, 128, 2>' from the mangled name of a
    kernel that ptxas reports: the last name of its nested name, then, for
    a template, its dtype and integer arguments."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled
    name = None
    while True:
        found = re.match(r"(\d+)", rest)
        if not found:
            break
        start, end = len(found.group(1)), len(found.group(1)) + int(
            found.group(1))
        name, rest = rest[start:end], rest[end:]
    if name is None:
        return mangled
    found = re.match(r"I((?:13__nv_bfloat16|f)?(?:Li\d+E)*)E", rest)
    if not found:
        return name
    args = found.group(1)
    dtype = ["bf16"] if args.startswith("13__nv_bfloat16") else (
        ["f32"] if args.startswith("f") else [])
    ints = re.findall(r"Li(\d+)E", args)
    return f"{name}<{', '.join(dtype + ints)}>"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- kernels

def paged_case(B, nb, bs, nkv, rep, hd, fills, dtype, device, seed=SEED):
    """Kernel inputs: slot b holds fills[b] tokens (0 = empty slot, all-
    null table) in shuffled pool rows, plus one allocated-but-unwritten
    page past its frontier where the table has room (as the engine
    reserves a request's budget); pos[b] = fills[b] - 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    P = B * nb + 1
    kpool = torch.randn((P, bs, nkv, hd), generator=g, device=device)
    vpool = torch.randn((P, bs, nkv, hd), generator=g, device=device)
    q = torch.randn((B, nkv * rep, hd), generator=g, device=device)
    rows = (torch.randperm(P - 1, generator=g, device=device) + 1).tolist()
    table = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    for b in range(B):
        if fills[b] > 0:
            need = min(-(-fills[b] // bs) + 1, nb)
            table[b, :need] = [rows.pop() for _ in range(need)]
        pos[b] = max(fills[b] - 1, 0)
    return (q.to(dtype), kpool.to(dtype), vpool.to(dtype),
            torch.as_tensor(table, device=device),
            torch.as_tensor(pos, device=device))


def attendable_rows(table, pos, fills, P, bs):
    """(P, bs) bool: the pool rows some slot may attend (its pages up to
    and including position pos[b]); every other row is fair game for
    poison."""
    keep = torch.zeros((P, bs), dtype=torch.bool)
    tbl, ps = table.cpu().tolist(), pos.cpu().tolist()
    for b, f in enumerate(fills):
        if f == 0:
            continue
        p = ps[b]
        for j in range(p // bs):
            keep[tbl[b][j]] = True
        keep[tbl[b][p // bs], :p % bs + 1] = True
    return keep.to(table.device)


def check_kernel(device) -> dict:
    """Phase 2. Returns the largest error per dtype at the main shape."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in KERNEL_CASES:
            q, kp, vp, table, pos = paged_case(*case, dtype, device)
            out = paged_attention(q, kp, vp, table, pos, kernel="cuda")
            torch.cuda.synchronize()
            ref = paged_attention_ref(q, kp, vp, table, pos)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[dtype]
            bad = ((out.float() - ref.float()).abs()
                   > tol + tol * ref.float().abs()).sum().item()
            empty = [b for b, f in enumerate(case[6]) if f == 0]
            if bad or not torch.isfinite(out).all() or any(
                    out[b].abs().max().item() != 0 for b in empty):
                raise AssertionError(f"kernel vs plain {dtype} {case[:6]}: "
                                     f"max err {err} (tol {tol}), {bad} "
                                     "elements out of tolerance")
            # poison every pool row no slot may attend (pages past each
            # frontier, the rest of each frontier page, unused rows): the
            # output must not move by one bit
            keep = attendable_rows(table, pos, case[6], kp.shape[0], case[2])
            kp2 = kp.masked_fill(~keep[:, :, None, None], 1e4)
            vp2 = vp.masked_fill(~keep[:, :, None, None], -1e4)
            out2 = paged_attention(q, kp2, vp2, table, pos, kernel="cuda")
            if not torch.equal(out, out2):
                raise AssertionError(f"poison past the frontier leaked: "
                                     f"{dtype} {case[:6]}")
            log(f"  kernel {str(dtype):14s} B={case[0]} nb={case[1]} "
                f"bs={case[2]} nkv={case[3]} rep={case[4]} hd={case[5]}: "
                f"max abs err {err:.3g} (tol {tol})")
            if case == KERNEL_CASES[-1]:
                errs[dtype] = err
    return errs


def flash_inputs(B, S, nh, nkv, hd, dtype, device, seed=SEED):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((B, S, nh, hd), (B, S, nkv, hd),
                               (B, S, nkv, hd)))


def check_flash(device) -> dict:
    """Phase 7. Returns the largest error per dtype at recurrentgemma's
    shape (the last case)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            B, S, nh, nkv, hd, window = case
            q, k, v = flash_inputs(B, S, nh, nkv, hd, dtype, device)
            out = flash_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, window=window).float()
            diff = (out.float() - ref).abs()
            err, tol = diff.max().item(), TOL[dtype]
            bad = (diff > tol + tol * ref.abs()).sum().item()
            if bad or not torch.isfinite(out).all():
                raise AssertionError(f"flash kernel vs plain {dtype} {case}:"
                                     f" max err {err} (tol {tol}), {bad} "
                                     "elements out of tolerance")
            log(f"  flash {str(dtype):14s} B={B} S={S} nh={nh} nkv={nkv} "
                f"hd={hd} window={window}: max abs err {err:.3g} "
                f"(tol {tol})")
            errs[dtype] = err
    return errs


def scan_inputs(B, S, C, dtype, device, seed=SEED):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, C), generator=g, device=device))
    b = torch.randn((B, S, C), generator=g, device=device)
    return a.to(dtype), b.to(dtype)


def check_scan(device) -> dict:
    """Phase 8. Returns the largest error per dtype at recurrentgemma's
    shape (the last case)."""
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SCAN_CASES:
            a, b = scan_inputs(*case, dtype, device)
            y, h = rglru_scan(a, b)
            torch.cuda.synchronize()
            ref = rglru_ref(a, b)
            diff = (y - ref).abs()
            err, tol = diff.max().item(), SCAN_TOL[dtype]
            bad = (diff > tol + tol * ref.abs()).sum().item()
            if bad or not torch.equal(h, y[:, -1]) \
                    or not torch.isfinite(y).all():
                raise AssertionError(f"scan kernel vs plain {dtype} {case}: "
                                     f"max err {err} (tol {tol}), {bad} "
                                     "elements out of tolerance")
            log(f"  rglru_scan {str(dtype):14s} B,S,C={case}: max abs err "
                f"{err:.3g} (tol {tol})")
            errs[dtype] = err
    return errs


def ssd_inputs(b, s, h, p, g, n, dtype, device, seed=SEED):
    """x, B, C in `dtype`; dt = softplus(N(0,1)) * 0.1 and A = -exp(N(0,1)
    * 0.5) in f32, as the reference's kernel test draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = randn(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, h)) * 0.1
    A = -torch.exp(randn(h) * 0.5)
    return x, dt, A, randn(b, s, g, n).to(dtype), randn(b, s, g, n).to(dtype)


def check_ssd(device) -> dict:
    """Phase 12. Returns the largest error (y and final state) per dtype at
    mamba2-130m's shape (the last case)."""
    from repro_torch.kernels.ssd_scan.ops import route, ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES:
            args = ssd_inputs(*case[:6], dtype, device)
            which = route(args[0], args[3], args[4])
            y, st = ssd_scan(*args)
            torch.cuda.synchronize()
            ry, rst = ssd_ref(*args)
            tol, err, bad = SSD_TOL[dtype], 0.0, 0
            for out, ref in ((y.float(), ry), (st, rst)):
                diff = (out - ref).abs()
                err = max(err, diff.max().item())
                bad += (diff > tol + tol * ref.abs()).sum().item()
            if bad or y.dtype != dtype or not torch.isfinite(y).all() \
                    or not torch.isfinite(st).all():
                raise AssertionError(f"ssd kernel vs plain {dtype} {case}: "
                                     f"max err {err} (tol {tol}), {bad} "
                                     "elements out of tolerance")
            log(f"  ssd_scan {str(dtype):14s} b,s,h,p,g,n,chunk={case} "
                f"({which} route): max abs err {err:.3g} (tol {tol})")
            errs[dtype] = err
    return errs


# phase 38: (name, rows, experts routed, top_k, held, d, ff, dtype)
MOE_CASES = [
    ("granite-moe-3b decode", 64, 40, 8, 40, 1536, 512, torch.bfloat16),
    ("granite-4.0-h-small decode", 64, 72, 10, 36, 4096, 768,
     torch.bfloat16),
    ("granite-moe-1b decode", 64, 32, 8, 32, 1024, 512, torch.bfloat16),
    ("granite-moe-1b batch 8", 8, 32, 8, 32, 1024, 512, torch.bfloat16),
    ("granite-moe-3b batch 8", 8, 40, 8, 40, 1536, 512, torch.bfloat16),
    ("granite-moe-1b batch 8 f32", 8, 32, 8, 32, 1024, 512, torch.float32)]
# the widest row's relative error: bf16 rounds g, u, silu(g) and h as the
# plain version's ops do, but sums in another order; f32 sums in k order on
# the CUDA cores against the library's f32 product
MOE_REL_TOL = {torch.bfloat16: 0.02, torch.float32: 1e-5}


def moe_experts_inputs(case, device, seed=SEED):
    """Phase 38: tokens in the case's dtype routed to top_k distinct
    experts each (the top of random logits) and the held experts' weights
    drawn as `init_moe` draws them."""
    _, T, E, K, n, d, ff, dtype = case
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((T, E), generator=gen, device=device)
    flat_e = torch.sort(logits, dim=-1, descending=True,
                        stable=True).indices[:, :K].reshape(T * K)
    x = torch.randn((T, d), generator=gen, device=device).to(dtype)

    def uniform(shape, fan_in):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1)
                / fan_in ** 0.5).to(dtype)
    w = {"w_gate": uniform((n, d, ff), d), "w_up": uniform((n, d, ff), d),
         "w_down": uniform((n, ff, d), ff)}
    return x, flat_e.contiguous(), w


def moe_experts_errs(case, x, flat_e, w) -> dict:
    """Phase 38: the kernel's widest row error against the plain version
    over the held experts' entries ("err"), beside two planted faults of
    the plain version against itself: the first expert with rows reads
    its first entry's row from the next token ("row"), and runs its rows
    on the next expert's weights ("weights"). The dispatch must equal the
    plain stable sort, the entries of experts not held read exact zeros."""
    from repro_torch.kernels.moe_experts.ops import moe_dispatch, moe_experts
    from repro_torch.kernels.moe_experts.ref import (moe_dispatch_ref,
                                                     moe_experts_ref)
    from repro_torch.models.layers import ACTIVATIONS
    K, n = case[3], case[4]
    perm, off = moe_dispatch(flat_e, 0, n)
    perm_ref, off_ref = moe_dispatch_ref(flat_e, 0, n)
    if not (torch.equal(perm, perm_ref) and torch.equal(off, off_ref)):
        raise AssertionError(f"moe_dispatch {case[0]}: order differs from "
                             "the plain stable sort")
    got = moe_experts(x, perm, off, **w, top_k=K, act="silu")
    want = moe_experts_ref(x, perm, off, **w, top_k=K, act="silu")
    held = perm[:int(off[n])].long()
    if not bool((got[perm[int(off[n]):].long()] == 0).all()):
        raise AssertionError(f"moe_experts {case[0]}: an entry of an expert "
                             "not held reads other than zero")
    act = ACTIVATIONS["silu"]

    def expert(rows, k):
        return (act(rows @ w["w_gate"][k]) * (rows @ w["w_up"][k])) \
            @ w["w_down"][k]
    counts = (off[1:-1] - off[:-2]).tolist()
    e = next(i for i, c in enumerate(counts[:-1]) if c)
    lo, hi = int(off[e]), int(off[e + 1])
    i = int(perm[lo])
    row = want.clone()
    row[i] = expert(x[(i // K + 1) % x.shape[0]][None], e)[0]
    entries = perm[lo:hi].long()
    nxt = want.clone()
    nxt[entries] = expert(x[entries // K], e + 1)
    return {"err": row_rel_err(got[held], want[held]),
            "row": row_rel_err(row[held], want[held]),
            "weights": row_rel_err(nxt[held], want[held])}


def moe_experts_phase(device) -> list:
    """Phase 38: the check and the timings of each of MOE_CASES."""
    from repro_torch.kernels.moe_experts.ops import moe_dispatch, moe_experts
    from repro_torch.kernels.moe_experts.ref import moe_experts_ref
    out = []
    for case in MOE_CASES:
        name, T, E, K, n, d, ff, dtype = case
        tol = MOE_REL_TOL[dtype]
        x, flat_e, w = moe_experts_inputs(case, device)
        errs = moe_experts_errs(case, x, flat_e, w)
        if not errs["err"] <= tol < min(errs["row"], errs["weights"]):
            raise AssertionError(f"moe_experts {name}: relative errors "
                                 f"{errs} against the limit {tol}")
        perm, off = moe_dispatch(flat_e, 0, n)

        def kernel():
            return moe_experts(x, perm, off, **w, top_k=K, act="silu")

        def with_dispatch():
            p, o = moe_dispatch(flat_e, 0, n)
            return moe_experts(x, p, o, **w, top_k=K, act="silu")

        def plain():
            return moe_experts_ref(x, perm, off, **w, top_k=K, act="silu")
        bytes_ = 3 * n * d * ff * x.element_size()
        t = {"name": name, "rows": T, "dtype": str(dtype).split(".")[-1],
             "limit": tol, "ms": time_cuda(kernel, iters=50, warmup=5),
             "card_ms": time_graph(kernel, iters=20),
             "dispatch_card_ms": time_graph(with_dispatch, iters=20),
             "plain_ms": time_cuda(plain, iters=5, warmup=1),
             "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bytes": bytes_,
             **errs}
        log(f"  moe_experts {name} ({T} rows, {n} of {E} experts held, "
            f"top-{K}, d {d}, ff {ff}, {t['dtype']}): row rel err "
            f"{errs['err']:.3g} (limit {tol}; faults: row {errs['row']:.3g}, weights "
            f"{errs['weights']:.3g}); {t['ms']:.4f} ms a call, "
            f"{t['card_ms']:.4f} on the card ({t['dispatch_card_ms']:.4f} "
            f"with the dispatch), bound {t['bound_ms']:.4f} "
            f"({100 * t['bound_ms'] / t['card_ms']:.1f}% of it), plain "
            f"{t['plain_ms']:.4f}")
        out.append(t)
        del x, w
        torch.cuda.empty_cache()
    return out


# phase 39: (name, slots, heads, head dim, d_state, groups, live slots
# every `stride`, dtype of x, B and C, the conv output slot-minor)
MAMBA_STATE_CASES = [
    ("granite-4.0-h-small decode", 64, 128, 64, 128, 1, 1, torch.bfloat16,
     True),
    ("granite-4.0-h-small decode, half dead", 64, 128, 64, 128, 1, 2,
     torch.bfloat16, True),
    ("granite-4.0-h-small decode, row-major", 64, 128, 64, 128, 1, 1,
     torch.bfloat16, False)]
MAMBA_STATE_TOL = {"h": 1e-6, "y": 1e-5}


def mamba_state_phase(device) -> list:
    """Phase 39: the check and the timings of each of MAMBA_STATE_CASES."""
    from repro_torch import kernels
    from repro_torch.kernels.mamba_state.ops import mamba_state
    from repro_torch.kernels.mamba_state.ref import mamba_state_ref
    out = []
    for name, b, h, p, n, g, stride, dtype, minor in MAMBA_STATE_CASES:
        gen = torch.Generator(device=device).manual_seed(SEED)
        di, gn = h * p, g * n
        xBC = torch.randn((di + 2 * gn, b), generator=gen,
                          device=device).t() if minor else \
            torch.randn((b, di + 2 * gn), generator=gen, device=device)
        xBC = xBC.to(dtype, memory_format=torch.preserve_format)
        x = xBC[:, :di].reshape(b, h, p)
        B = xBC[:, di:di + gn].view(b, g, n)
        C = xBC[:, di + gn:].view(b, g, n)
        ssm = torch.randn((b, h, p, n), generator=gen, device=device)
        dt = torch.nn.functional.softplus(
            torch.randn((b, h), generator=gen, device=device) - 2.0)
        A = -torch.exp(torch.randn((h,), generator=gen, device=device))
        live = torch.arange(b, device=device) % stride == 0
        before, want = ssm.clone(), ssm.clone()
        want_y = mamba_state_ref(want, x, dt, A, B, C, live)
        y = mamba_state(ssm, x, dt, A, B, C, live)
        Ch = C.float().repeat_interleave(h // g, dim=1)
        scale = torch.einsum("bhpn,bhn->bhp", want.abs(), Ch.abs())
        errs = {"h": float((ssm[live] - want[live]).abs().max()
                           / want[live].abs().max()),
                "y": float(((y[live] - want_y[live]).abs()
                            / scale[live]).max())}
        if any(errs[k] > MAMBA_STATE_TOL[k] for k in errs) or \
                not torch.equal(ssm[~live], before[~live]) or \
                bool(y[~live].any()):
            raise AssertionError(f"mamba_state {name}: errors {errs} "
                                 f"against {MAMBA_STATE_TOL}, or a dead "
                                 "slot's state or y touched")

        def kernel():
            return mamba_state(ssm, x, dt, A, B, C, live)

        def plain():
            return mamba_state_ref(ssm, x, dt, A, B, C, live)
        captured = kernels.captured_here()
        card_ms = time_graph(kernel, iters=20)
        if kernels.captured_since(captured) != {mamba_state: 20}:
            raise AssertionError(f"mamba_state {name}: the graph of 20 "
                                 "calls captured "
                                 f"{kernels.captured_since(captured)}")
        n_live = int(live.sum())
        bytes_ = n_live * (2 * h * p * n * 4
                           + (di + 2 * gn) * xBC.element_size() + h * 4)
        t = {"name": name, "slots": b, "live": n_live, **errs,
             "ms": time_cuda(kernel, iters=50, warmup=5), "card_ms": card_ms,
             "plain_ms": time_cuda(plain, iters=5, warmup=1),
             "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bytes": bytes_}
        log(f"  mamba_state {name} ({n_live} of {b} slots live, {h} heads "
            f"of {p} x {n}, g {g}): h' rel err {errs['h']:.3g}, y "
            f"{errs['y']:.3g} (limits {MAMBA_STATE_TOL}); {t['ms']:.4f} ms "
            f"a call, {card_ms:.4f} on the card, bound {t['bound_ms']:.4f} "
            f"({100 * t['bound_ms'] / card_ms:.1f}% of it), plain "
            f"{t['plain_ms']:.4f}")
        out.append(t)
        del ssm, before, want
        torch.cuda.empty_cache()
    return out


HYBRID_HELD = 4          # phase 40: granite-4.0-h-small's experts held


def hybrid_config(dtype: str):
    """granite-4.0-h-small at full width and depth under "pallas", with
    HYBRID_HELD of its 72 experts held (the router still scores all 72;
    the launch counts read none of the experts' widths)."""
    import dataclasses
    from repro_torch.configs import get
    full = get("granite-4.0-h-small")
    return full.replace(dtype=dtype, param_dtype=dtype,
                        attention_impl="pallas",
                        moe=dataclasses.replace(full.moe,
                                                held_experts=HYBRID_HELD))


def hybrid_phase(device) -> dict:
    """Phase 40: granite-4.0-h-small served on the paged layout with fused
    decode graphs (the path of the benchmark's docqa cell), bf16; the
    counted run's every kernel checked by `serve_variant`."""
    cfg = hybrid_config("bfloat16")
    params = make_model(cfg, device)
    types = cfg.layer_types()
    log(f"  {numel(params) / 1e9:.3f} B parameters; {types.count('ssm')} "
        f"Mamba2 and {types.count('attn')} attention layers, "
        f"{HYBRID_HELD} of {cfg.moe.n_experts} experts held")
    eng = make_variant(params, cfg, device, fused_tokens=FUSED_TOKENS)
    fused = serve_variant(eng, make_requests(cfg))
    log_variant(fused)
    if fused["replays"] < 1:
        raise AssertionError("granite-4.0-h-small: no fused dispatch "
                             "replayed a graph")
    log(f"  mamba_state launches {fused['mamba_launches']} (= "
        f"{types.count('ssm')} Mamba2 layers x decode steps), ssd_scan "
        f"{fused['ssd_launches']} (x bulk prefills), moe_experts "
        f"{fused['moe_launches']}")
    del eng, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return fused


def time_cuda(fn, iters=200, warmup=20) -> float:
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(fn, iters=50, replays=5) -> float:
    """Mean ms per call on the card alone: `iters` calls captured in one
    CUDA graph and replayed, so the host's dispatch stays out of the time
    (a loop of calls from Python measures the host once the kernel is
    shorter than its dispatch)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def time_kernel(device) -> dict:
    """Phase 5 (kernel part): the main-path shape in bf16, every slot at
    the end of a 512-token chain. Six copies of the inputs (>50 MB, the
    L2 size) are cycled so each call finds its pages cold, as each of the
    28 layers does in a decode step."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         split_plan)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    sets = [paged_case(*MAIN_SHAPE, torch.bfloat16, device, seed=SEED + i)
            for i in range(6)]
    B, nb, bs, nkv, rep, hd, _ = MAIN_SHAPE
    nxt = cycle(sets)
    kernel_ms = time_cuda(lambda: paged_attention(*nxt(), kernel="cuda"))
    kernel_card_ms = time_graph(lambda: paged_attention(*nxt(),
                                                        kernel="cuda"))
    plain_ms = time_cuda(lambda: paged_attention_ref(*nxt()), iters=50)
    # library yardstick: SDPA over the dense view gathered beforehand (the
    # gather is not timed); every slot's chain is full, so no mask
    nxt_d = cycle([dense_view(q, kp, vp, table, MAIN_SHAPE)
                   for q, kp, vp, table, _ in sets])

    def sdpa():
        return F.scaled_dot_product_attention(*nxt_d(), enable_gqa=True)

    library_ms = time_cuda(sdpa)
    library_card_ms = time_graph(sdpa)
    # the bound, from what this data needs: q, the K/V rows up to each
    # slot's position, the table and positions, and the output
    q, kp, vp, table, pos = sets[0]
    elt = q.element_size()
    tokens = int((pos.long() + 1).sum())
    bytes_ = (2 * q.numel() * elt + 2 * tokens * nkv * hd * elt
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * tokens * nkv * rep * hd
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_card_ms": library_card_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops,
            "plan": split_plan(B, nkv, nb, bs)[:2]}


def dense_view(q, kp, vp, table, shape):
    """SDPA's inputs for a paged case: q as one query per head, K and V
    gathered from the pool into (B, nkv, nb * bs, hd)."""
    B, nb, bs, nkv, _, hd, _ = shape
    idx = table.long()
    k = kp[idx].reshape(B, nb * bs, nkv, hd).transpose(1, 2).contiguous()
    v = vp[idx].reshape(B, nb * bs, nkv, hd).transpose(1, 2).contiguous()
    return q[:, :, None, :], k, v


def cycle(sets):
    """A function returning the next of `sets` on each call."""
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(sets)
        return sets[it[0]]
    return nxt


def time_flash(device, case) -> dict:
    """Phase 11 (flash): one main-path shape in bf16. Three input sets
    (133 MB at recurrentgemma's shape, above the 50 MB L2) are cycled."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, S, nh, nkv, hd, window = case
    sets = [flash_inputs(B, S, nh, nkv, hd, torch.bfloat16, device,
                         seed=SEED + i) for i in range(3)]
    nxt = cycle(sets)
    kernel_ms = time_cuda(lambda: flash_attention(*nxt(), window=window),
                          iters=50, warmup=5)
    kernel_card_ms = time_graph(
        lambda: flash_attention(*nxt(), window=window), iters=20)
    plain_ms = time_cuda(lambda: attention_ref(*nxt(), window=window),
                         iters=5, warmup=1)
    # library yardstick: SDPA in its (B, heads, S, hd) layout, transposed
    # beforehand (not timed); the window as an explicit boolean mask
    pos = torch.arange(S, device=device)
    visible = pos[None, :] <= pos[:, None]
    if window is not None:
        visible &= pos[None, :] > pos[:, None] - window
    nxt_t = cycle([tuple(t.transpose(1, 2).contiguous() for t in s)
                   for s in sets])
    if window is None:
        def sdpa():
            return F.scaled_dot_product_attention(*nxt_t(), is_causal=True,
                                                  enable_gqa=True)
    else:
        def sdpa():
            return F.scaled_dot_product_attention(*nxt_t(), attn_mask=visible,
                                                  enable_gqa=True)
    library_ms = time_cuda(sdpa, iters=50, warmup=5)
    library_card_ms = time_graph(sdpa, iters=20)
    pairs = int(visible.sum())
    flops = 4 * hd * nh * pairs * B
    bytes_ = sum(t.numel() for t in sets[0]) * 2 + B * S * nh * hd * 2
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_card_ms": library_card_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops, "pairs": pairs}


def row_rel_err(got, want) -> float:
    """The widest relative error of one output vector: max over the rows
    and heads of |got - want| / |want|, the norms over head_dim."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return (diff / want.float().norm(dim=-1)).max().item()


def paged_flash_errs(case, q, kpool, vpool, table) -> dict:
    """The paged flash kernel's error against the plain gather on the real
    rows ("err"), beside two planted faults of the plain gather against
    itself: the middle page the rows attend read from its neighbour's
    block ("page"), and the causal mask one key late ("mask")."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_paged
    from repro_torch.kernels.flash_attention.ref import paged_prefill_ref
    _, start, n_tok, _, _, _, bs, _ = case
    want = paged_prefill_ref(q, kpool, vpool, table, start, n_tok)[:, :n_tok]
    got = flash_attention_paged(q, kpool, vpool, table, start, n_tok)
    col = (start + n_tok) // bs // 2
    misread = table.clone()
    misread[col] = table[col + 1]
    page = paged_prefill_ref(q, kpool, vpool, misread, start, n_tok)
    late = paged_prefill_ref(q, kpool, vpool, table, start + 1, n_tok)
    return {"err": row_rel_err(got[:, :n_tok], want),
            "page": row_rel_err(page[:, :n_tok], want),
            "mask": row_rel_err(late[:, :n_tok], want)}


def paged_flash_inputs(device, case, seed):
    """bf16 q (1, S, nh, hd), pools of the table's pages plus the null
    block, and a shuffled table of every non-null block."""
    S, _, _, nh, nkv, hd, bs, nb = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
    table = (torch.randperm(nb, generator=gen, device=device) + 1).to(
        torch.int32)
    return t(1, S, nh, hd), t(nb + 1, bs, nkv, hd), t(nb + 1, bs, nkv, hd), \
        table


def time_flash_paged(device, case) -> dict:
    """Phase 11 (paged flash): one paged bulk prefill read in bf16, against
    the plain gather it replaced. Its error must stay within
    PAGED_FLASH_REL_TOL, which both planted faults must exceed. Three
    input sets (q and both pools: 136 MB at the 2,048-token case, above
    the 50 MB L2) are cycled. The bound is the attention term of
    portbench/counts.py's `prefill_flops` (4 x heads x head_dim per
    attended (query, key) pair) at the tensor cores' peak, or the bytes
    the read needs (q, the K/V rows it attends, the table, the output),
    whichever is longer."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_paged
    from repro_torch.kernels.flash_attention.ref import paged_prefill_ref
    S, start, n_tok, nh, nkv, hd, bs, nb = case
    sets = [paged_flash_inputs(device, case, SEED + i) for i in range(3)]
    errs = paged_flash_errs(case, *sets[0])
    if not errs["err"] <= PAGED_FLASH_REL_TOL < min(errs["page"],
                                                    errs["mask"]):
        raise AssertionError(f"paged flash {case}: relative errors {errs} "
                             f"against the limit {PAGED_FLASH_REL_TOL}")
    nxt = cycle(sets)

    def kernel():
        return flash_attention_paged(*nxt(), start, n_tok)

    def plain():
        return paged_prefill_ref(*nxt(), start, n_tok)
    kernel_ms = time_cuda(kernel, iters=50, warmup=5)
    kernel_card_ms = time_graph(kernel, iters=20)
    plain_ms = time_cuda(plain, iters=5, warmup=1)
    attended = n_tok * start + n_tok * (n_tok + 1) // 2
    flops = 4 * nh * hd * attended
    bytes_ = (2 * S * nh * hd * 2 + 2 * (start + n_tok) * nkv * hd * 2
              + nb * 4)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops, **errs}


def time_scan(device) -> dict:
    """Phase 11 (scan): recurrentgemma's shape (1, 2560, 4096) with f32
    inputs, as the model's gates give them; three input sets (377 MB) are
    cycled."""
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    case = SCAN_CASES[-1]
    sets = [scan_inputs(*case, torch.float32, device, seed=SEED + i)
            for i in range(3)]
    nxt = cycle(sets)
    kernel_ms = time_cuda(lambda: rglru_scan(*nxt()), iters=50, warmup=5)
    kernel_card_ms = time_graph(lambda: rglru_scan(*nxt()), iters=20)
    plain_ms = time_cuda(lambda: rglru_ref(*nxt()), iters=3, warmup=1)
    B, S, C = case
    bytes_ = 3 * B * S * C * 4               # a, b read; y written
    flops = 2 * B * S * C
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "library_ms": None, "library_card_ms": None,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops}


def time_ssd(device) -> dict:
    """Phase 14: mamba2-130m's 2,048-token prefill shape, bf16 x/B/C and
    f32 dt as the model hands them over; eight input sets (60 MB, above the
    50 MB L2) are cycled."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.kernels.ssd_scan.ops import route
    b, s, h, p, g, n, q = SSD_CASES[-1]
    sets = [ssd_inputs(b, s, h, p, g, n, torch.bfloat16, device,
                       seed=SEED + i) for i in range(8)]
    nxt = cycle(sets)
    kernel_ms = time_cuda(lambda: ssd_scan(*nxt()), iters=50, warmup=5)
    kernel_card_ms = time_graph(lambda: ssd_scan(*nxt()), iters=20)
    plain_ms = time_cuda(lambda: ssd_ref(*nxt()), iters=3, warmup=1)
    # inputs read once, y (bf16) and the final state (f32) written once
    bytes_ = (sum(t.numel() * t.element_size() for t in sets[0])
              + b * s * h * p * 2 + b * h * p * n * 4)
    # per (chunk, head) of the reference's chunks: C.B^T and the score
    # product over the visible pairs (i >= j), the carried-state term and
    # the state update
    flops = 0
    for c0 in range(0, s, q):
        m = min(q, s - c0)
        flops += 2 * (m * (m + 1) // 2) * (n + p) + 4 * m * n * p
    flops *= b * h
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    return {"ms": kernel_ms, "card_ms": kernel_card_ms, "plain_ms": plain_ms,
            "library_ms": None, "library_card_ms": None,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "flops": flops,
            "route": route(sets[0][0], *sets[0][3:])}


# ----------------------------------------------------------------- serving

def full_config(dtype: str):
    from repro_torch.configs import get
    return get("qwen3-1.7b").replace(dtype=dtype, param_dtype=dtype)


def make_model(cfg, device, seed=SEED):
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_lm(gen, cfg)


def numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(numel(v) for v in tree)
    return tree.numel()


def make_requests(cfg, n=10, new_tokens=32, seed=SEED):
    """(prompt, sampling) pairs: prompts of 64-256 tokens; requests 0 and 1
    share their first 150 tokens (a partial page at 16-token pages, so the
    second admission copies a page on write); request 3 samples."""
    from repro_torch.serve.sampler import SamplingParams
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 257, n)
    if n > 1:
        lens[0], lens[1] = 200, 180
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist() for m in lens]
    if n > 1:
        prompts[1] = prompts[0][:150] + prompts[1][150:]
    sampling = [None] * n
    if n > 3:
        sampling[3] = SamplingParams(temperature=0.8, top_k=50, seed=7)
    return [(p, s, new_tokens) for p, s in zip(prompts, sampling)]


def make_engine(params, cfg, device, decode_kernel, batch_slots=8):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(params, cfg, kv_layout="paged",
                       decode_kernel=decode_kernel, prefill_mode="bulk",
                       batch_slots=batch_slots, cache_len=512,
                       block_size=16, device=device)


def serve(engine, requests) -> dict:
    """Phase 3's main path: admit, prefill, decode to the end. Returns what
    the checks and the timings need."""
    reqs = [engine.submit(p, max_new_tokens=n, sampling=s)
            for p, s, n in requests]
    fns = counters()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
    zero_paged_prefills()
    zero_moe_launches()
    zero_mamba_launches()
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    launches = fns["paged_attention"].launches
    others = {k: fn.launches for k, fn in fns.items() if fn.launches
              and k != "paged_attention"}
    if others:
        raise AssertionError(f"the paged path launched {others}")
    cfg = engine.cfg
    for r, (p, _, n) in zip(reqs, requests):
        if r.error is not None or not r.done or len(r.output) != n:
            raise AssertionError(f"request {r.request_id}: done={r.done} "
                                 f"error={r.error!r} tokens={len(r.output)}"
                                 f" of {n}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 "the vocabulary")
    decode = engine.step_times["decode"]
    prefill = engine.step_times["prefill"]
    if launches != cfg.n_layers * decode.n:
        raise AssertionError(f"kernel launches {launches} != {cfg.n_layers} "
                             f"layers x {decode.n} decode dispatches")
    prefill_launches = check_paged_prefills(cfg, prefill.n, "phase 3")
    moe = check_moe_launches(cfg, decode.n, "phase 3")
    mamba = check_mamba_launches(engine, decode.n, "phase 3")
    m = engine.cache_metrics
    if m.hits < 1 or m.cow_copies < 1:
        raise AssertionError(f"radix reuse did not run: {m.as_dict()}")
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    return {"requests": len(reqs), "launches": launches,
            "prefill_launches": prefill_launches, "moe_launches": moe,
            "mamba_launches": mamba, "decode_dispatches": decode.n,
            "decode_step_ms_mean": decode.total / decode.n,
            "decode_step_ms_p50": decode.percentile(50),
            "prefill_ms_mean": prefill.total / prefill.n,
            "decode_tokens_per_s": decode_tokens / (decode.total / 1e3),
            "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
            "wall_s": wall, "cache": m.as_dict(),
            "outputs": [r.output for r in reqs]}


def record_logits(engine) -> list:
    """Make the engine's greedy prefill and decode keep their logits (for
    the NaN checks and the lockstep comparisons): each call appends
    (kind, {request_id: (V,) f32 logits}) for the requests it serves, the
    live slots of a decode step or the slot being prefilled. The greedy
    token is the argmax of the same logits, as in the engine's own greedy
    closures. Returns the list."""
    rec = []

    def wrap(kind, logits_fn):
        def tok_fn(*args):
            logits, cache = logits_fn(*args)
            live = [s for s in range(engine.slots)
                    if engine.active[s] is not None]
            if kind == "prefill":     # the admitted slot has no token yet
                rows = {engine.active[s].request_id:
                        logits.reshape(-1, logits.shape[-1])[0]
                        for s in live if not engine.active[s].output}
            else:
                rows = {engine.active[s].request_id: logits[s] for s in live}
            rec.append((kind, {r: x.float().clone() for r, x in rows.items()}))
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        return tok_fn

    engine._decode_tok = wrap("decode", engine._decode_lg)
    engine._prefill_tok = wrap("prefill", engine._prefill_lg)
    return rec


def all_finite(rec) -> bool:
    return bool(rec) and all(bool(torch.isfinite(x).all())
                             for _, rows in rec for x in rows.values())


def compare_runs(rec_a, rec_b) -> dict:
    """Two greedy runs of the same traffic in lockstep (same admissions,
    same budgets, so call t of one is call t of the other), `rec_b` the
    oracle: every logits row within LOGIT_TOL, and a greedy token may
    differ only where the oracle's top-2 gap is below LOGIT_TOL (that
    request is compared no further)."""
    if len(rec_a) != len(rec_b):
        raise AssertionError("the two engines ran different step counts")
    max_diff = {"prefill": 0.0, "decode": 0.0}
    diverged, last = {}, 0.0
    for t, ((kind, ra), (kind_b, rb)) in enumerate(zip(rec_a, rec_b)):
        if kind != kind_b or set(ra) != set(rb):
            raise AssertionError(f"call {t}: the runs left lockstep")
        last = 0.0
        for rid, a in ra.items():
            b = rb[rid]
            if not torch.isfinite(a).all():
                raise AssertionError(f"non-finite {kind} logits at call {t}")
            if rid in diverged:
                continue
            d = (a - b).abs().max().item()
            max_diff[kind] = max(max_diff[kind], d)
            last = max(last, d)
            if d > LOGIT_TOL:
                raise AssertionError(f"call {t} ({kind}) request {rid}: "
                                     f"logits differ by {d} > {LOGIT_TOL}")
            if a.argmax() != b.argmax():
                top2 = torch.topk(b, 2).values
                gap = (top2[0] - top2[1]).item()
                if gap >= LOGIT_TOL:
                    raise AssertionError(f"call {t} request {rid}: greedy "
                                         "tokens differ with oracle top-2 "
                                         f"gap {gap}")
                diverged[rid] = (t, gap)
    return {"calls": len(rec_a),
            "steps": sum(k == "decode" for k, _ in rec_a),
            "max_abs_logit_diff": max(max_diff.values()),
            "max_abs_prefill_logit_diff": max_diff["prefill"],
            "max_abs_decode_logit_diff": max_diff["decode"],
            "last_step_max_abs_logit_diff": last,
            "diverged_requests": {str(k): v for k, v in diverged.items()}}


def lockstep(engines, requests, oracle_ctx=contextlib.nullcontext) -> dict:
    """Serve the same greedy `requests` through each of `engines` (the
    last is the oracle, run inside `oracle_ctx()`) with their logits
    recorded, and compare. Each run's grouped MoE experts launches are
    kept (`moe_launches`)."""
    recs, outs, moe = [], [], []
    for i, eng in enumerate(engines):
        recs.append(record_logits(eng))
        reqs = [eng.submit(p, max_new_tokens=n) for p, _, n in requests]
        sync(eng)
        zero_moe_launches()
        with (oracle_ctx() if i == len(engines) - 1
              else contextlib.nullcontext()):
            eng.run()
        sync(eng)
        moe.append(moe_launches())
        outs.append([r.output for r in reqs])
    out = compare_runs(*recs)
    out["moe_launches"] = moe
    out["identical_outputs"] = outs[0] == outs[1]
    out["outs"], out["rec"] = outs[0], recs[0]    # the first engine's run
    return out


def compare_to_oracle(params, cfg, device, requests,
                      moe_buffer=False) -> dict:
    """Phase 4: the same greedy traffic through decode_kernel="cuda" and
    "reference" in lockstep. With `moe_buffer` (phase 24) the oracle's MoE
    runs the GShard buffer path in every group, so that the grouped MoE
    experts kernel, which the "cuda" engine's decode steps launch in every
    layer, is held against the buffer path too; each side's launches of
    it are checked (`moe_launches`: "cuda", oracle)."""
    engines = [make_engine(params, cfg, device, kernel)
               for kernel in ("cuda", "reference")]
    out = lockstep(engines, requests, oracle_ctx=moe_buffer_path
                   if moe_buffer else contextlib.nullcontext)
    if moe_buffer:
        steps = engines[0].step_times["decode"].n
        want = [moe_want(cfg, steps), 0]
        if out["moe_launches"] != want:
            raise AssertionError(f"f32 lockstep: moe_experts launched "
                                 f"{out['moe_launches']} (cuda, oracle), "
                                 f"expected {want}")
    return out


# ------------------------------------------------------ dense-layout serving

def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    return {"paged_attention": paged_attention,
            "flash_attention": flash_attention, "rglru_scan": rglru_scan,
            "ssd_scan": ssd_scan}


def check_paged_prefills(cfg, prefills: int, what: str):
    """The paged bulk prefill's read launches the paged flash kernel once
    per attention layer per bulk prefill (its own counter, apart from
    `counters()`, whose checks stay as they were)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_paged
    n, n_attn = flash_attention_paged.launches, \
        cfg.layer_types().count("attn")
    if n != n_attn * prefills:
        raise AssertionError(f"{what}: flash_attention_paged launched {n}, "
                             f"expected {n_attn} attention layers x "
                             f"{prefills} bulk prefills")
    return n


def zero_paged_prefills():
    from repro_torch.kernels.flash_attention.ops import flash_attention_paged
    flash_attention_paged.launches = 0


def moe_launches() -> int:
    """The grouped MoE experts kernel's launch count (its own counter,
    apart from `counters()`, whose checks stay as they were)."""
    from repro_torch.kernels.moe_experts.ops import moe_experts
    return moe_experts.launches


def zero_moe_launches():
    from repro_torch.kernels.moe_experts.ops import moe_experts
    moe_experts.launches = 0


def moe_want(cfg, steps: int) -> int:
    """The grouped MoE experts kernel launches once per layer per decode
    step where the model's MoE takes the grouped path at a decode position
    (`models.moe.grouped`: no entry of the group can be dropped), and
    never in a model with no MoE. The prompts here (64-256 tokens) keep
    the buffer path, so the prefills launch none."""
    from repro_torch.models import moe as MOE
    return cfg.n_layers * steps if cfg.moe and MOE.grouped(cfg, 1) else 0


def check_moe_launches(cfg, steps: int, what: str) -> int:
    """The kernel's launches since `zero_moe_launches()` are `moe_want`'s."""
    n, want = moe_launches(), moe_want(cfg, steps)
    if n != want:
        raise AssertionError(f"{what}: moe_experts launched {n}, expected "
                             f"{want} ({cfg.n_layers} layers x {steps} "
                             "decode steps)" if cfg.moe else
                             f"{what}: moe_experts launched {n} in a model "
                             "with no MoE")
    return n


def mamba_launches() -> int:
    """The Mamba2 decode state step kernel's launch count (its own
    counter, apart from `counters()`, whose checks stay as they were)."""
    from repro_torch.kernels.mamba_state.ops import mamba_state
    return mamba_state.launches


def zero_mamba_launches():
    from repro_torch.kernels.mamba_state.ops import mamba_state
    mamba_state.launches = 0


def mamba_want(engine, steps: int) -> int:
    """The Mamba2 decode state step kernel launches once per Mamba2 layer
    per decode step of the paged layout under "pallas"
    (`models.mamba2.mamba2_decode_paged`), and never on the dense layout
    (`mamba2_decode`), in a prefill or in a model with no Mamba2 layer."""
    cfg = engine.cfg
    paged = engine.kv_layout == "paged" and cfg.attention_impl == "pallas"
    return cfg.layer_types().count("ssm") * steps if paged else 0


def check_mamba_launches(engine, steps: int, what: str) -> int:
    """The kernel's launches since `zero_mamba_launches()` are
    `mamba_want`'s."""
    n, want = mamba_launches(), mamba_want(engine, steps)
    if n != want:
        raise AssertionError(f"{what}: mamba_state launched {n}, expected "
                             f"{want} (the paged decode's Mamba2 layers x "
                             f"{steps} decode steps)")
    return n


@contextlib.contextmanager
def moe_buffer_path():
    """Every MoE group on the GShard buffer path (`models.moe.grouped`
    refused), as the port ran before the grouped experts: phase 24's f32
    oracle."""
    from repro_torch.models import moe as MOE
    grouped = MOE.grouped
    MOE.grouped = lambda *a, **k: False
    try:
        yield
    finally:
        MOE.grouped = grouped


def make_dense_engine(params, cfg, device, batch_slots, cache_len):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(params, cfg, kv_layout="dense", prefill_mode="bulk",
                       batch_slots=batch_slots, cache_len=cache_len,
                       device=device)


def serve_dense(engine, requests, per_prefill: dict) -> dict:
    """Phases 9, 10 and 13's main path: every launch count set to 0 just
    before the run and read just after; kernel k must have launched
    per_prefill[k] x the bulk prefills, every other kernel not at all."""
    reqs = [engine.submit(p, max_new_tokens=n, sampling=s)
            for p, s, n in requests]
    fns = counters()
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0
    zero_moe_launches()
    zero_mamba_launches()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    routes = {name: dict(fn.route_launches) for name, fn in fns.items()
              if hasattr(fn, "route_launches")}
    cfg = engine.cfg
    for r, (_, _, n) in zip(reqs, requests):
        if r.error is not None or not r.done or len(r.output) != n:
            raise AssertionError(f"request {r.request_id}: done={r.done} "
                                 f"error={r.error!r} tokens={len(r.output)}"
                                 f" of {n}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 "the vocabulary")
    decode = engine.step_times["decode"]
    prefill = engine.step_times["prefill"]
    for name, n in launches.items():
        want = per_prefill.get(name, 0) * prefill.n
        if n != want:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{per_prefill.get(name, 0)} x "
                                 f"{prefill.n} bulk prefills = {want}")
    moe = check_moe_launches(cfg, decode.n, "dense run")
    mamba = check_mamba_launches(engine, decode.n, "dense run")
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    return {"requests": len(reqs), "launches": launches,
            "moe_launches": moe, "mamba_launches": mamba,
            "route_launches": routes,
            "prefills": prefill.n, "decode_dispatches": decode.n,
            "prefill_ms_mean": prefill.total / prefill.n,
            "prefill_ms_max": prefill.vmax,
            "decode_step_ms_mean": decode.total / decode.n,
            "decode_tokens_per_s": decode_tokens / (decode.total / 1e3),
            "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
            "wall_s": wall}


def finite_round(engine, requests):
    """A short greedy round outside the counted run, logits recorded: the
    prefill and decode logits must be finite."""
    rec = record_logits(engine)
    for p, _, _ in requests:
        engine.submit(p, max_new_tokens=4)
    engine.run()
    if not all_finite(rec):
        raise AssertionError(f"{engine.cfg.arch_id}: non-finite logits")


def log_profile(prof: dict, what: str = "step"):
    if prof["busy_share"] is None:
        log(f"  {what} {prof['step_ms']:.3f} ms; device time not measured "
            "(the profiler recorded no device events)")
        return
    log(f"  {what} {prof['step_ms']:.3f} ms, device busy "
        f"{prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
        f"{prof['device_ops_per_step']:.0f} device ops per {what} "
        f"(kernels and copies)")
    for name, ms, count in prof["top"]:
        log(f"    {ms:8.4f} ms/{what}  x{count:<4d} {name}")


def log_share(prof: dict, kernel: str, what: str):
    """The device time of the ops whose name holds `kernel`, per `what` and
    as a share of the device's busy time and of the host-clock time."""
    if prof["busy_share"] is None:
        return
    ms = sum(t for k, t in prof["by_name"].items() if kernel in k)
    log(f"  {kernel}: {ms:.4f} ms per {what}, "
        f"{100 * ms / prof['device_ms']:.1f}% of the device's busy time, "
        f"{100 * ms / prof['step_ms']:.1f}% of the {what}'s "
        f"{prof['step_ms']:.3f} ms")


def log_timing(what: str, t: dict, previous: tuple, library: str):
    """Phases 5 and 11: a kernel's time per call from Python and on the
    card alone, beside the library call's and the previous design's (per
    call, as it was measured)."""
    log(f"  {what}: kernel {t['ms']:.4f} ms per call from Python (previous "
        f"design: {previous[0]:.4f}), {t['card_ms']:.4f} ms on the card "
        f"alone; {library} {t['library_ms']:.4f} ms per call (then: "
        f"{previous[1]:.4f}), {t['library_card_ms']:.4f} ms on the card "
        f"alone; kernel / {library} {t['ms'] / t['library_ms']:.3f} per "
        f"call, {t['card_ms'] / t['library_card_ms']:.3f} on the card")


def log_scan_timing(what: str, t: dict, previous: tuple):
    """Phases 11 and 14: a scan's time per call from Python and on the card
    alone beside the previous design's (PREVIOUS_SCAN_MS), its plain
    version's and its bound; no single PyTorch call computes a scan."""
    log(f"  {what}: kernel {t['ms']:.4f} ms per call from Python (previous "
        f"design: {previous[0]:.4f}), {t['card_ms']:.4f} ms on the card "
        f"alone (previous: {previous[1]:.4f}; {previous[1] / t['card_ms']:.2f}"
        f"x); plain {t['plain_ms']:.4f} ms, no library call, bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} bytes), "
        f"card / bound {t['card_ms'] / t['bound_ms']:.2f}")


def log_served(s: dict):
    log(f"  {s['requests']} requests, {s['prefills']} bulk prefills, "
        f"{s['decode_dispatches']} decode dispatches, launches "
        f"{s['launches']}")
    log(f"  prefill {s['prefill_ms_mean']:.3f} ms mean per request (max "
        f"{s['prefill_ms_max']:.3f}), decode step "
        f"{s['decode_step_ms_mean']:.3f} ms mean, "
        f"{s['decode_tokens_per_s']:.1f} decode tokens/s, "
        f"{s['tokens_per_s']:.1f} tokens/s end to end over "
        f"{s['wall_s']:.3f} s")


def log_lockstep(c: dict):
    log(f"  {c['steps']} lockstep decode steps, max |logit diff| prefill "
        f"{c['max_abs_prefill_logit_diff']:.3g}, decode "
        f"{c['max_abs_decode_logit_diff']:.3g} (tol {LOGIT_TOL}), greedy "
        f"divergences {c['diverged_requests']}, outputs identical: "
        f"{c['identical_outputs']}")


def rgemma_config(dtype: str, **kw):
    from repro_torch.configs import get
    return get("recurrentgemma-9b").replace(dtype=dtype, param_dtype=dtype,
                                            **kw)


def rgemma_requests(cfg, new_tokens=16, seed=SEED):
    """Six prompts of 64-512 tokens and one of 2560 (past the 2048
    window, so the ring wraps); request 2 samples with a seed."""
    from repro_torch.serve.sampler import SamplingParams
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(64, 513, 6)) + [2560]
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in lens]
    sampling = [None] * len(prompts)
    sampling[2] = SamplingParams(temperature=0.8, top_k=50, seed=7)
    return [(p, s, new_tokens) for p, s in zip(prompts, sampling)]


def mamba_config(dtype: str, **kw):
    from repro_torch.configs import get
    return get("mamba2-130m").replace(dtype=dtype, param_dtype=dtype, **kw)


def mamba_requests(cfg, new_tokens=32, seed=SEED):
    """Ten prompts of 64-1,024 tokens, the first two of 300 and 777 (not
    multiples of the 256-token chunk), and one of 2,048; request 4
    samples with a seed."""
    from repro_torch.serve.sampler import SamplingParams
    rng = np.random.default_rng(seed)
    lens = [300, 777] + list(rng.integers(64, 1025, 8)) + [2048]
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in lens]
    sampling = [None] * len(prompts)
    sampling[4] = SamplingParams(temperature=0.8, top_k=50, seed=7)
    return [(p, s, new_tokens) for p, s in zip(prompts, sampling)]


def profile_decode(engine, requests, steps=8) -> dict:
    """Phases 6, 9, 10 and 13: where a decode step's time goes, for a greedy
    batch filling every slot at full width."""
    engine.reset()
    for p, _, n in requests[:engine.slots]:
        # budget for every step below: no slot retires inside the window
        engine.submit(p, max_new_tokens=max(n, 2 * steps + 3))
    engine.step()                  # admission, prefill, first decode
    engine.step()
    return profile_steps(engine.step, steps)


def profile_prefill(engine, prompt, steps=3) -> dict:
    """Phases 10 and 13: where one greedy bulk prefill's time goes. Each step
    admits `prompt` with a budget of one token, so the engine prefills it
    and retires it in the same step, with no decode."""
    engine.reset()

    def prefill():
        engine.submit(prompt, max_new_tokens=1)
        engine.step()
    prefill()                      # warm-up
    return profile_steps(prefill, steps)


def profile_steps(fn, steps) -> dict:
    """Times `steps` calls of `fn` with the host clock, then the same
    number again under torch.profiler for the device-side breakdown (the
    profiler's own host overhead stays out of the step time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): a CPU op's self device
    # time repeats the time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return {"step_ms": step_ms, "device_ms": device_ms,
            "busy_share": device_ms / step_ms if events else None,
            "device_ops_per_step": sum(e.count for e in events) / steps,
            "top": [(e.key[:60], dev_us(e) / 1e3 / steps, e.count // steps)
                    for e in top],
            "by_name": {e.key: dev_us(e) / 1e3 / steps for e in events}}


# --------------------------------------------- fused, speculative, chunked

def make_variant(params, cfg, device, warm=True, **kw):
    """Phases 15-17's engine: phase 3's, plus one decode variant. With
    `warm`, four greedy requests of 24 new tokens run through it first (the
    fused graph's capture, first calls at new shapes), with no reset after
    them (a reset drops the graph); their step times are cleared."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, kv_layout="paged", decode_kernel="cuda",
                      prefill_mode="bulk", batch_slots=8, cache_len=512,
                      block_size=16, device=device, **kw)
    if warm:
        for p, _, _ in make_requests(cfg, n=4, seed=SEED + 1):
            eng.submit(p, max_new_tokens=24)
        eng.run()
        eng.step_times.clear()
    return eng


def serve_variant(engine, requests) -> dict:
    """Phases 15-17, 24-25 and 40's counted run: every launch count set to
    0 just before and read just after. The paged kernel must have launched
    the attention layers x (fused_tokens x (fused graph replays + its eager
    warm-up runs) + single-token dispatches + mixed dispatches) times,
    exactly (a replay adds the launches its capture recorded; the verify
    forward has none), the Mamba2 state step kernel the Mamba2 layers x
    the same decode steps (`mamba_want`), the SSD scan the Mamba2 layers x
    the bulk prefills under "pallas"; no other kernel at all. Outputs are
    checked as in phase 3."""
    reqs = [engine.submit(p, max_new_tokens=n, sampling=s)
            for p, s, n in requests]
    fns = counters()
    graph = engine._decode_fused
    replays0 = graph.replays if graph is not None else 0
    warm0 = graph.warmup_runs if graph is not None else 0
    before = [engine.spec_metrics, engine.scheduler_metrics,
              engine.cache_metrics.as_dict()]
    sync(engine)
    for fn in fns.values():
        fn.launches = 0
    zero_paged_prefills()
    zero_moe_launches()
    zero_mamba_launches()
    t0 = time.perf_counter()
    engine.run()
    sync(engine)
    wall = time.perf_counter() - t0
    cfg = engine.cfg
    for r, (_, _, n) in zip(reqs, requests):
        if r.error is not None or not r.done or len(r.output) != n:
            raise AssertionError(f"request {r.request_id}: done={r.done} "
                                 f"error={r.error!r} tokens={len(r.output)}"
                                 f" of {n}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 "the vocabulary")
    kinds = {k: h.n for k, h in engine.step_times.items()}
    replays = (graph.replays - replays0) if graph is not None else 0
    warmups = (graph.warmup_runs - warm0) if graph is not None else 0
    if replays != kinds.get("fused", 0):
        raise AssertionError(f"{kinds.get('fused', 0)} fused dispatches, "
                             f"{replays} graph replays")
    types = cfg.layer_types()
    n_attn, n_ssm = types.count("attn"), types.count("ssm")
    want = {k: 0 for k in fns}
    want["paged_attention"] = n_attn * (
        engine.fused_tokens * (replays + warmups) + kinds.get("decode", 0)
        + kinds.get("mixed", 0))
    if cfg.attention_impl == "pallas":
        want["ssd_scan"] = n_ssm * kinds.get("prefill", 0)
    launches = {k: fn.launches for k, fn in fns.items()}
    if launches != want:
        raise AssertionError(
            f"launches {launches}, expected {want}: paged_attention = "
            f"{n_attn} attention layers x ({engine.fused_tokens} x "
            f"({replays} replays + {warmups} warm-up runs) + "
            f"{kinds.get('decode', 0)} single + {kinds.get('mixed', 0)} "
            f"mixed dispatches), ssd_scan = {n_ssm} Mamba2 layers x "
            f"{kinds.get('prefill', 0)} bulk prefills")
    check_paged_prefills(cfg, kinds.get("prefill", 0), "variant run")
    steps = engine.fused_tokens * (replays + warmups) \
        + kinds.get("decode", 0)
    moe = check_moe_launches(cfg, steps, "variant run")
    mamba = check_mamba_launches(engine, steps, "variant run")
    times = {k: h.total / h.n for k, h in engine.step_times.items()}
    return {"requests": len(reqs), "launches": launches["paged_attention"],
            "moe_launches": moe, "mamba_launches": mamba,
            "ssd_launches": launches["ssd_scan"], "dispatches": kinds, "replays": replays, "warmups": warmups,
            "step_ms_mean": times, "wall_s": wall,
            "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
            "outputs": [r.output for r in reqs],
            "spec": counted(engine.spec_metrics, before[0]),
            "scheduler": counted(engine.scheduler_metrics, before[1]),
            "cache": counted(engine.cache_metrics.as_dict(), before[2])}


def counted(after, before):
    """An engine's counters over one run (the warm-up's taken off), with
    the rates taken again from them."""
    if after is None:
        return None
    out = {k: (v - before[k] if isinstance(v, int) and not isinstance(
        v, bool) and k not in ("spec_tokens", "chunk_budget") else v)
        for k, v in after.items()}
    if "tokens_drafted" in out:
        out["acceptance_rate"] = (out["tokens_accepted"]
                                  / max(out["tokens_drafted"], 1))
        out["tokens_per_dispatch"] = (out["tokens_emitted"]
                                      / max(out["dispatches"], 1))
    if "chunks_dispatched" in out:
        out["tokens_per_chunk"] = (out["prefill_tokens_chunked"]
                                   / max(out["chunks_dispatched"], 1))
    return out


def sync(engine):
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


def log_variant(s: dict):
    log(f"  {s['requests']} requests; dispatches by kind {s['dispatches']}; "
        f"paged kernel launches {s['launches']} (graph replays "
        f"{s['replays']}, warm-up runs {s['warmups']}); step ms mean by kind "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            s["step_ms_mean"].items()))
        + f"; {s['tokens_per_s']:.1f} tokens/s end to end over "
        f"{s['wall_s']:.3f} s")


def log_spec(spec: dict, cache: dict):
    log(f"  drafter {spec['drafter']}: {spec['dispatches']} verify "
        f"dispatches, {spec['tokens_per_dispatch']:.3f} tokens per dispatch "
        f"(all slots), acceptance {spec['acceptance_rate']:.4f} "
        f"({spec['tokens_accepted']} of {spec['tokens_drafted']} drafts), "
        f"{cache['rollbacks']} rollbacks of {spec['tokens_rolled_back']} "
        "tokens")


def greedy(requests, new_tokens=None):
    return [(p, None, n if new_tokens is None else new_tokens)
            for p, _, n in requests]


def tokens_by_request(rec) -> dict:
    """The logits behind each generated token of a `record_logits` run:
    {request_id: [logits of token 0 (prefill), token 1, ...]}."""
    out = {}
    for _, rows in rec:
        for rid, x in rows.items():
            out.setdefault(rid, []).append(x)
    return out


def match_tokens(outs, ref_outs, ref_rec) -> dict:
    """Phases 15-17's f32 token checks: `outs` must equal `ref_outs` (the
    single-step engine's, whose logits `ref_rec` recorded) request for
    request, except after a first divergence at a token whose logits'
    top-2 gap in the single-step run is below LOGIT_TOL."""
    logits = tokens_by_request(ref_rec)
    diverged = {}
    for rid, (a, b) in enumerate(zip(outs, ref_outs)):
        if a == b:
            continue
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if t >= len(b) or t >= len(a):
            raise AssertionError(f"request {rid}: {len(a)} tokens against "
                                 f"{len(b)}")
        top2 = torch.topk(logits[rid][t], 2).values
        gap = (top2[0] - top2[1]).item()
        if gap >= LOGIT_TOL:
            raise AssertionError(f"request {rid}: token {t} differs from "
                                 f"the single-step run's with its top-2 "
                                 f"gap {gap}")
        diverged[str(rid)] = (t, gap)
    return {"requests": len(outs), "diverged": diverged,
            "identical": not diverged}


def single_step_reference(params, cfg, device, requests) -> dict:
    """The single-token paged engine's greedy outputs and recorded logits
    for `requests` (phase 16's cut-depth model)."""
    eng = make_engine(params, cfg, device, "cuda")
    rec = record_logits(eng)
    reqs = [eng.submit(p, max_new_tokens=n) for p, _, n in requests]
    eng.run()
    return {"outs": [r.output for r in reqs], "rec": rec}


def profile_fused(engine, requests, steps=3) -> dict:
    """Phase 15: where a greedy batch-8 fused dispatch's time goes (one
    graph replay and the host's reconcile per engine step), every slot
    live with budget enough for every step."""
    engine.reset()
    n = engine.fused_tokens
    for p, _, _ in requests[:engine.slots]:
        engine.submit(p, max_new_tokens=1 + n * (2 + 2 * steps) + n)
    engine.step()                  # admission, prefills, the capture
    engine.step()
    return profile_steps(engine.step, steps)


def stall_gap(engine, requests, long_prompt) -> dict:
    """Phase 17: every slot but one decoding greedily, then `long_prompt`
    arrives. Returns the longest gap between two tokens of one decoding
    request (host clock, from its token of the step before the arrival to
    its token of the step that gives the long request its first token),
    the steps after the arrival, and the long request's wait for its first
    token."""
    engine.reset()
    for p, _, _ in requests[:engine.slots - 1]:
        engine.submit(p, max_new_tokens=64)
    while engine.pending_count() or (engine.scheduler is not None and
                                     engine.scheduler.has_prefill_work()):
        engine.step()
    stamps = {}
    engine.on_token = lambda req, tok: stamps.setdefault(
        req.request_id, []).append(time.perf_counter())
    try:
        engine.step()              # each decoding request's last token before
        longr = engine.submit(long_prompt, max_new_tokens=2)
        t0 = time.perf_counter()
        steps = 0
        while not longr.output:
            engine.step()
            steps += 1
    finally:
        engine.on_token = None
    gaps = [b - a for rid, ts in stamps.items() if rid != longr.request_id
            for a, b in zip(ts, ts[1:])]
    return {"max_gap_ms": max(gaps) * 1e3, "steps": steps,
            "first_token_ms": (stamps[longr.request_id][0] - t0) * 1e3}


# ----------------------------------------------------------------- gateway

def make_gateway(params, cfg, device, **kw):
    """Phases 18-19's fleet: two replicas with phase 3's engine settings
    (8 slots, 512-token chains of 16-token pages, bulk prefill), sharing
    the weights; the paged read is each engine's default, the kernel."""
    from repro_torch.gateway.gateway import Gateway
    return Gateway.build(params, cfg, replicas=2, batch_slots=8,
                         cache_len=512, kv_layout="paged", block_size=16,
                         prefill_mode="bulk", device=device, **kw)


def watch_fused(gw) -> dict:
    """Host-clock windows of each replica's fused-graph captures and fused
    dispatches, for phase 19's overlap count: {replica: {"captures":
    [(t0, t1)], "dispatches": [(t0, t1)]}}."""
    seen = {}
    for r in gw.replicas:
        eng, graph = r.engine, r.engine._decode_fused
        windows = seen[r.replica_id] = {"captures": [], "dispatches": []}

        def timed(fn, into):
            def wrapper(*args):
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    into.append((t0, time.perf_counter()))
            return wrapper
        graph._capture = timed(graph._capture, windows["captures"])
        eng._step_fused = timed(eng._step_fused, windows["dispatches"])
    return seen


def serve_gateway(gw, requests, chaos=None) -> dict:
    """Phases 18-19's counted run: every launch count set to 0 just before
    the requests are submitted and read after `gw.run()`. Summed over the
    replicas, the paged kernel must have launched n_layers x (fused_tokens
    x (graph replays + eager warm-up runs) + single-token dispatches)
    times, exactly, and no other kernel at all. Every request must finish
    with its tokens in the vocabulary. `chaos` is a fault plan armed for
    the run. The gateway is shut down when it returns."""
    from repro_torch.chaos import FaultInjector, parse_plan
    from repro_torch.gateway.metrics import percentile
    engines = [r.engine for r in gw.replicas]
    graphs = [e._decode_fused for e in engines]
    stats = ("captures", "replays", "warmup_runs")
    before = [{k: getattr(g, k) for k in stats} if g is not None else None
              for g in graphs]
    for e in engines:
        e.step_times.clear()
    inj = FaultInjector(parse_plan(chaos)).arm(gw) if chaos else None
    fns = counters()
    sync(engines[0])
    for fn in fns.values():
        fn.launches = 0
    zero_paged_prefills()
    t0 = time.perf_counter()
    handles = [gw.submit(p, max_new_tokens=n, sampling=s)
               for p, s, n in requests]
    try:
        gw.run()
    finally:
        # async workers may still be closing the books of their last step
        # (step times, replay counts): stop and join them before reading
        gw.shutdown()
        if inj is not None:
            inj.disarm()
    sync(engines[0])
    wall = time.perf_counter() - t0
    cfg = engines[0].cfg
    for h, (_, _, n) in zip(handles, requests):
        if h.status != "done" or len(h.output) != n:
            raise AssertionError(f"request {h.gid}: status {h.status} "
                                 f"error={h.error!r} tokens "
                                 f"{len(h.output)} of {n}")
        if not all(0 <= t < cfg.vocab_size for t in h.output):
            raise AssertionError(f"request {h.gid}: token out of the "
                                 "vocabulary")
    per_replica, want, prefills = [], 0, 0
    for e, g, b in zip(engines, graphs, before):
        kinds = {k: h.n for k, h in e.step_times.items()}
        prefills += kinds.get("prefill", 0)
        run = {k: getattr(g, k) - b[k] for k in stats} if g is not None \
            else dict.fromkeys(stats, 0)
        if run["replays"] != kinds.get("fused", 0):
            raise AssertionError(f"{kinds.get('fused', 0)} fused dispatches,"
                                 f" {run['replays']} graph replays")
        want += cfg.n_layers * (e.fused_tokens * (run["replays"]
                                                  + run["warmup_runs"])
                                + kinds.get("decode", 0))
        per_replica.append({"dispatches": kinds, **run,
                            "cache": e.cache_metrics.as_dict()})
    launches = {k: fn.launches for k, fn in fns.items()}
    if launches["paged_attention"] != want or any(
            n for k, n in launches.items() if k != "paged_attention"):
        raise AssertionError(f"launches {launches}, expected paged_attention "
                             f"{want} = {cfg.n_layers} x (fused_tokens x "
                             "(replays + warm-up runs) + single dispatches) "
                             f"over the replicas {per_replica}")
    prefill_launches = check_paged_prefills(cfg, prefills, "gateway run")
    summ = gw.summary()
    ttfts = [h.metrics.ttft for h in handles if h.metrics.ttft is not None]
    ttft_p95 = percentile(ttfts, 95)
    return {"requests": len(handles), "launches": launches["paged_attention"],
            "prefill_launches": prefill_launches,
            "replicas": per_replica, "wall_s": wall,
            "tokens_per_s": sum(len(h.output) for h in handles) / wall,
            "ttft_p50_ms": summ["ttft_p50_ms"],
            "ttft_p95_ms": None if ttft_p95 is None else ttft_p95 * 1e3,
            "itl_p50_ms": summ["itl_p50_ms"], "itl_p95_ms": summ["itl_p95_ms"],
            "retried": summ["retried"],
            "replica_ids": [h.replica_id for h in handles],
            "outputs": [h.output for h in handles],
            "fired": list(inj.fired) if inj is not None else []}


def log_gateway(s: dict):
    log(f"  {s['requests']} requests, {s['tokens_per_s']:.1f} tokens/s end "
        f"to end over {s['wall_s']:.3f} s; time to first token p50 "
        f"{s['ttft_p50_ms']:.3f} ms, p95 {s['ttft_p95_ms']:.3f} ms; between "
        f"tokens p50 {s['itl_p50_ms']:.3f} ms, p95 {s['itl_p95_ms']:.3f} ms; "
        f"{s['retried']} retried; paged kernel launches {s['launches']}, "
        f"paged flash (bulk prefill) launches {s['prefill_launches']}")
    for i, r in enumerate(s["replicas"]):
        log(f"  replica {i}: dispatches by kind {r['dispatches']}, graph "
            f"captures {r['captures']}, replays {r['replays']}, warm-up runs "
            f"{r['warmup_runs']}; cache hits {r['cache']['hits']}, tokens "
            f"reused {r['cache']['tokens_reused']}")


def warm_gateway(gw, cfg):
    """Phase 19's warm-up round, outside the counted run: two greedy
    requests, one on each replica (round-robin), so that each captures its
    fused graph; then the workers are stopped and joined (the counted run
    starts them again), so no late bookkeeping lands in its counts."""
    for p, _, _ in make_requests(cfg, n=2, seed=SEED + 1):
        gw.submit(p, max_new_tokens=24)
    try:
        gw.run()
    finally:
        gw.shutdown()


def check_reintegration(gw, s: dict, seen: dict, captures: list) -> int:
    """Phase 19: the crash fired once on replica 0, which rejoined and
    captured its graph again while replica 1 kept serving; `captures` is
    each replica's captures in the counted run. Returns how many of
    replica 1's fused dispatches overlapped replica 0's last capture on
    the host clock."""
    crashes = [e for e in s["fired"] if e["fault"] == "crash"]
    r0 = gw.replicas[0]
    if len(crashes) != 1 or r0.failures != 1 or r0.reintegrations != 1:
        raise AssertionError(f"faults fired {s['fired']}, replica 0 "
                             f"failures {r0.failures}, reintegrations "
                             f"{r0.reintegrations}")
    caps = [r["captures"] for r in s["replicas"]]
    if caps != captures:
        raise AssertionError(f"graph captures per replica {caps}, not "
                             f"{captures}")
    t0, t1 = seen[0]["captures"][-1]
    return sum(1 for a, b in seen[1]["dispatches"] if a < t1 and b > t0)


def run_launcher() -> list:
    """Phase 18: the serve launcher in a process of its own, as a user
    starts it. Returns its `[serve]` lines."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [x for x in [env.get("PYTHONPATH")] if x])
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3-1.7b", "--kv-layout", "paged", "--decode-kernel", "pallas",
           "--replicas", "2", "--requests", "8", "--workload", "synth"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=LAUNCHER_TIMEOUT_S)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[serve]")]
    if out.returncode != 0 or not any(
            re.match(r"\[serve\] \d+ requests, ", ln) for ln in lines):
        raise AssertionError(f"launcher exit {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return lines


# ----------------------------------------------------------------- training

def token_batches(cfg, n, batch, seq, device, seed=SEED) -> list:
    """n batches of the synthetic LM stream, made on the host before any
    timing and moved to the card."""
    from repro_torch.data.tokens import TokenStream
    stream = TokenStream(cfg.vocab_size, seq, batch, seed=seed)
    return [{k: torch.as_tensor(v, device=device)
             for k, v in stream.next_batch().items()} for _ in range(n)]


def lm_trainer(cfg, steps, microbatches=1):
    """(opt_init, step) with AdamW under the launcher's warmup-cosine
    schedule over `steps` steps."""
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import linear_warmup_cosine
    from repro_torch.train.step import build_lm_train_step
    opt_init, opt_update = adamw(
        linear_warmup_cosine(TRAIN_LR, steps // 10 + 1, steps))
    return opt_init, build_lm_train_step(cfg, opt_update,
                                         microbatches=microbatches)


def run_steps(step, params, opt, batches, on_first=None) -> dict:
    """Each batch one step, timed on the host clock up to the loss read (a
    sync); `on_first(params)` runs after the first step, untimed. Returns
    losses, grad norms, ms per step and the peak memory of the first step
    and of the run."""
    losses, norms, ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
        if i == 0:
            first_peak = torch.cuda.max_memory_allocated()
            if on_first is not None:
                on_first(params)
    return {"losses": losses, "grad_norms": norms, "ms": ms,
            "first_peak": first_peak,
            "peak": torch.cuda.max_memory_allocated(), "params": params,
            "opt": opt}


def check_falling(what: str, losses: list, require_fall=True):
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")
    if require_fall and not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")


def rel_close(what: str, a: float, b: float, rel: float):
    if not abs(a - b) <= rel * abs(b):
        raise AssertionError(f"{what}: {a!r} against {b!r}, beyond {rel} "
                             "relative")


def train_full(device, card: str) -> dict:
    """Phase 20: full-width, full-depth qwen3-1.7b trains in f32, then the
    same first batch with microbatches=2 and with remat=True."""
    from torch.utils._pytree import tree_leaves, tree_map
    cfg = full_config("float32")
    resident = torch.cuda.memory_allocated()       # earlier phases' leftovers
    params = make_model(cfg, device)
    n = numel(params)
    batches = token_batches(cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                            device)
    opt_init, step = lm_trainer(cfg, TRAIN_STEPS)
    first = {}

    def keep(p):
        first["params"] = tree_map(torch.clone, p)
    run = run_steps(step, params, opt_init(params), batches, keep)
    check_falling("phase 20", run["losses"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = float(np.median(run["ms"][1:]))
    out = {"params": n, "tokens": tokens, "losses": run["losses"],
           "grad_norms": run["grad_norms"], "ms": run["ms"],
           "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "tflops": 6 * n * tokens / step_ms / 1e9,
           "peak_gib": run["peak"] / 2**30,
           "first_peak_gib": run["first_peak"] / 2**30,
           "resident_gib": resident / 2**30, "card": card}
    state = {"params": run["params"], "opt": run["opt"]}

    def one_step():
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batches[1])
    out["profile"] = profile_steps(one_step, 1)
    del run, state
    torch.cuda.empty_cache()

    params = make_model(cfg, device)
    opt_init2, step2 = lm_trainer(cfg, TRAIN_STEPS, microbatches=2)
    out["mb2_loss"] = float(step2(params, opt_init2(params),
                                  batches[0])[2]["loss"])
    if not abs(out["mb2_loss"] - out["losses"][0]) < 1e-3:
        raise AssertionError(f"microbatches=2 loss {out['mb2_loss']} against "
                             f"{out['losses'][0]}")
    worst = 0.0
    for a, b in zip(tree_leaves(params), tree_leaves(first["params"])):
        # the reference's own tolerance (tests/test_train_integration.py)
        if not torch.allclose(a, b, atol=5e-4, rtol=5e-3):
            raise AssertionError("microbatches=2 params beyond atol 5e-4, "
                                 "rtol 5e-3 of microbatches=1's")
        worst = max(worst, float((a - b).abs().max()))
    out["mb2_max_param_diff"] = worst
    del params, first, a, b
    torch.cuda.empty_cache()

    cfg_r = cfg.replace(remat=True)
    params = make_model(cfg_r, device)
    opt_init3, step3 = lm_trainer(cfg_r, TRAIN_STEPS)
    remat = run_steps(step3, params, opt_init3(params), batches[:1])
    out["remat_loss"], out["remat_grad_norm"] = remat["losses"][0], \
        remat["grad_norms"][0]
    out["remat_peak_gib"] = remat["first_peak"] / 2**30
    rel_close("remat loss", out["remat_loss"], out["losses"][0], 1e-5)
    rel_close("remat grad norm", out["remat_grad_norm"],
              out["grad_norms"][0], 1e-5)
    if not out["remat_peak_gib"] < out["first_peak_gib"]:
        raise AssertionError(f"remat peak {out['remat_peak_gib']:.2f} GiB not "
                             f"below {out['first_peak_gib']:.2f} GiB")
    del params, remat
    torch.cuda.empty_cache()
    return out


def train_against_cpu(device) -> dict:
    """Phase 21, first part: full-width qwen3-1.7b cut to 2 layers, three
    f32 steps on the card and on the CPU from the same weights and
    batches."""
    from torch.utils._pytree import tree_map
    cfg = full_config("float32").replace(n_layers=CPU_LAYERS)
    params = make_model(cfg, device)
    cpu_params = tree_map(lambda p: p.to("cpu", copy=True), params)
    batches = token_batches(cfg, 3, CPU_BATCH, CPU_SEQ, device,
                            seed=SEED + 3)
    opt_init, step = lm_trainer(cfg, 3)
    card = run_steps(step, params, opt_init(params), batches)
    t0 = time.perf_counter()
    cpu_opt = opt_init(cpu_params)
    cpu = {"losses": [], "grad_norms": []}
    for b in batches:
        cpu_params, cpu_opt, m = step(cpu_params, cpu_opt,
                                      {k: v.cpu() for k, v in b.items()})
        cpu["losses"].append(float(m["loss"]))
        cpu["grad_norms"].append(float(m["grad_norm"]))
    cpu_s = time.perf_counter() - t0
    for i in range(3):
        rel_close(f"step {i + 1} loss, card against CPU",
                  card["losses"][i], cpu["losses"][i], CARD_CPU_REL)
        rel_close(f"step {i + 1} grad norm, card against CPU",
                  card["grad_norms"][i], cpu["grad_norms"][i], CARD_CPU_REL)
    return {"cfg": cfg, "params": card["params"], "card": card, "cpu": cpu,
            "cpu_s": cpu_s}


def train_family(cfg, device, steps, batch, seq, require_fall) -> dict:
    """Phase 21: a recurrent family trains on the card (f32, "xla")."""
    params = make_model(cfg, device)
    opt_init, step = lm_trainer(cfg, steps)
    run = run_steps(step, params, opt_init(params),
                    token_batches(cfg, steps, batch, seq, device,
                                  seed=SEED + 4))
    check_falling(f"phase 21 {cfg.arch_id}", run["losses"], require_fall)
    return {"cfg": cfg, "params": run["params"], "n": numel(params),
            "losses": run["losses"], "ms": run["ms"],
            "peak_gib": run["peak"] / 2**30}


def eval_pallas(model, device) -> dict:
    """Phase 22: forward_train under "pallas" (the kernels' forward) and
    no_grad against "xla" on a phase-21 model, every launch counted; then
    the same call with grad enabled must be refused."""
    from torch.utils._pytree import tree_map
    from repro_torch.models import transformer as T
    cfg, params = model["cfg"], model["params"]
    tokens = token_batches(cfg, 1, 2, EVAL_SEQ, device, seed=SEED + 5)[0]
    types = cfg.layer_types()
    want = {"flash_attention": types.count("attn"),
            "rglru_scan": types.count("rglru"), "ssd_scan": types.count("ssm"),
            "paged_attention": 0}
    fns = counters()
    with torch.no_grad():
        ref, _ = T.forward_train(params, cfg, tokens)
        for fn in fns.values():
            fn.launches = 0
        out, _ = T.forward_train(params, cfg.replace(attention_impl="pallas"),
                                 tokens)
        torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in fns.items()}
    if got != want:
        raise AssertionError(f"{cfg.arch_id}: launches {got}, expected {want}")
    err = float((out - ref).abs().max())
    if not err <= LOGIT_TOL:
        raise AssertionError(f"{cfg.arch_id}: 'pallas' logits {err} from "
                             f"'xla', beyond {LOGIT_TOL}")
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    first = {"attn": "flash_attention", "rglru": "rglru_scan",
             "ssm": "ssd_scan"}[types[0]]
    try:
        T.forward_train(live, cfg.replace(attention_impl="pallas"), tokens)
    except NotImplementedError as e:
        if first not in str(e):
            raise
        refused = str(e).split(" has no backward")[0]
    else:
        raise AssertionError(f"{cfg.arch_id}: a forward under grad ran "
                             "through the kernels")
    return {"arch": cfg.arch_id, "launches": got, "max_abs_logit_diff": err,
            "refused": refused}


def refuse_all(device) -> list:
    """Phase 22: each of the four wrappers, called on CUDA tensors that
    require a gradient with grad enabled, raises NotImplementedError and
    launches nothing."""
    fns = counters()
    g = torch.Generator(device).manual_seed(SEED)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device) \
            .requires_grad_()
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=device)
    pos = torch.tensor([20], dtype=torch.int32, device=device)
    calls = {
        "flash_attention": lambda f: f(r(1, 64, 4, 64), r(1, 64, 2, 64),
                                       r(1, 64, 2, 64)),
        "rglru_scan": lambda f: f(torch.rand(1, 64, 128, device=device)
                                  .requires_grad_(), r(1, 64, 128)),
        "ssd_scan": lambda f: f(r(1, 64, 2, 32),
                                torch.rand(1, 64, 2, device=device)
                                .requires_grad_(),
                                -torch.rand(2, device=device),
                                r(1, 64, 1, 32), r(1, 64, 1, 32)),
        "paged_attention": lambda f: f(r(1, 4, 64), r(3, 16, 2, 64),
                                       r(3, 16, 2, 64), table, pos),
    }
    refused = []
    for name, call in calls.items():
        before = fns[name].launches
        try:
            call(fns[name])
        except NotImplementedError:
            refused.append(name)
        else:
            raise AssertionError(f"{name} ran a call that needs a gradient")
        if fns[name].launches != before:
            raise AssertionError(f"{name} launched before refusing")
    return refused


def run_train_launcher(device) -> dict:
    """Phase 22: the train launcher in a process of its own, as a user
    starts it; its last checkpoint restored into the port's params and
    served on the card."""
    import os
    import shutil
    from repro_torch.configs import get
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import restore_train_state
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [x for x in [env.get("PYTHONPATH")] if x])
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-1.7b", "--reduced", "--steps", str(LAUNCH_STEPS),
           "--device", "cuda", "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=LAUNCHER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[train]")]
    found = re.match(r"\[train\] loss ([\d.]+) -> ([\d.]+) over", lines[-1]) \
        if lines else None
    if out.returncode != 0 or not found:
        raise AssertionError(f"train launcher exit {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    first, last = float(found.group(1)), float(found.group(2))
    check_falling("phase 22 launcher", [first, last])
    cfg = get("qwen3-1.7b", reduced=True)
    template = make_model(cfg, device)
    opt_init, _ = adamw(TRAIN_LR)
    params, opt = restore_train_state(str(ckpt), LAUNCH_STEPS, template,
                                      opt_init(template), cfg, device=device)
    if int(opt.step) != LAUNCH_STEPS:
        raise AssertionError(f"restored step {int(opt.step)}")
    shutil.rmtree(ckpt)
    fns = counters()
    fns["paged_attention"].launches = 0
    eng = make_engine(params, cfg, device, "cuda", batch_slots=2)
    prompt = np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, 24).tolist()
    eng.submit(prompt, max_new_tokens=8)
    (req,) = eng.run()
    if len(req.output) != 8 or fns["paged_attention"].launches < 1:
        raise AssertionError(f"served {req.output}, paged kernel launches "
                             f"{fns['paged_attention'].launches}")
    return {"lines": lines, "wall_s": wall, "first": first, "last": last,
            "served": req.output,
            "launches": fns["paged_attention"].launches}


def train_phases(device, card: str):
    """Phases 20-22, logged as they run; each raises on a failed check."""
    t_train = time.perf_counter()
    log(f"[20] training full-width, full-depth qwen3-1.7b in f32 (TF32 off, "
        f"attention_impl='xla'): AdamW, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens; card: {card}")
    tr = train_full(device, card)
    log(f"  {tr['params'] / 1e9:.3f} B parameters; loss "
        f"{' '.join(f'{x:.4f}' for x in tr['losses'])}")
    log(f"  grad norm {' '.join(f'{x:.4f}' for x in tr['grad_norms'])}")
    log(f"  step ms {' '.join(f'{x:.3f}' for x in tr['ms'])}")
    log(f"  step {tr['step_ms']:.3f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{tr['tokens_per_s']:.1f} tokens/s, {tr['tflops']:.2f} TFLOP/s "
        f"(6 N tokens per step), peak memory {tr['first_peak_gib']:.2f} GiB "
        f"in a step (max_memory_allocated over step 1, of which "
        f"{tr['resident_gib']:.2f} GiB were allocated by earlier phases; over "
        f"the run {tr['peak_gib']:.2f} GiB, with a copy of step 1's params "
        f"kept for the microbatch check); card: {card}")
    log("[20] where a train step's time goes (f32)")
    log_profile(tr["profile"], "train step")
    log(f"  microbatches=2 on the first batch: loss {tr['mb2_loss']:.6f} "
        f"against {tr['losses'][0]:.6f}, params within {tr['mb2_max_param_diff']:.3g} "
        f"(atol 5e-4, rtol 5e-3)")
    log(f"  remat=True on the first batch: loss {tr['remat_loss']:.6f}, grad "
        f"norm {tr['remat_grad_norm']:.6f}, first-step peak "
        f"{tr['remat_peak_gib']:.2f} GiB against {tr['first_peak_gib']:.2f}")

    log(f"[21] full-width qwen3-1.7b cut to {CPU_LAYERS} layers, f32: 3 steps "
        f"of {CPU_BATCH} x {CPU_SEQ} tokens on the card and on the CPU")
    q2 = train_against_cpu(device)
    for i in range(3):
        log(f"  step {i + 1}: loss {q2['card']['losses'][i]:.6f} card, "
            f"{q2['cpu']['losses'][i]:.6f} CPU; grad norm "
            f"{q2['card']['grad_norms'][i]:.6f} card, "
            f"{q2['cpu']['grad_norms'][i]:.6f} CPU (tol {CARD_CPU_REL} "
            "relative)")
    log(f"  card {' '.join(f'{x:.3f}' for x in q2['card']['ms'])} ms a step; "
        f"CPU {q2['cpu_s']:.1f} s for 3")
    log("[21] full-width, full-depth mamba2-130m, f32: 8 steps of 8 x 256 "
        "tokens (the SSD 'xla' route's backward)")
    m2 = train_family(mamba_config("float32"), device, 8, 8, 256, True)
    log(f"  {m2['n'] / 1e6:.1f} M parameters; loss "
        f"{' '.join(f'{x:.4f}' for x in m2['losses'])}; step ms "
        f"{' '.join(f'{x:.1f}' for x in m2['ms'])}; peak "
        f"{m2['peak_gib']:.2f} GiB")
    rg_cfg = rgemma_config("float32", n_layers=RGEMMA_TRAIN_LAYERS,
                           tail_pattern=())
    log(f"[21] full-width recurrentgemma-9b, one pattern block "
        f"{rg_cfg.layer_types()}, f32: 3 steps of 4 x 256 tokens")
    rg = train_family(rg_cfg, device, 3, 4, 256, False)
    log(f"  {rg['n'] / 1e9:.3f} B parameters; loss "
        f"{' '.join(f'{x:.4f}' for x in rg['losses'])}; step ms "
        f"{' '.join(f'{x:.1f}' for x in rg['ms'])}; peak "
        f"{rg['peak_gib']:.2f} GiB")

    log("[22] the kernels on the training path: forward_train under "
        "'pallas' and no_grad against 'xla' (f32), phase 21's models")
    evals = [eval_pallas(mdl, device) for mdl in (q2, m2, rg)]
    for e in evals:
        log(f"  {e['arch']}: launches {e['launches']}, max |logit diff| "
            f"{e['max_abs_logit_diff']:.3g} (tol {LOGIT_TOL}); with grad "
            f"enabled {e['refused']} refused the backward")
    del q2, m2, rg
    torch.cuda.empty_cache()
    log(f"  refused a gradient, launching nothing: {refuse_all(device)}")
    log(f"[22] the train launcher: python -m repro_torch.launch.train --arch "
        f"qwen3-1.7b --reduced --steps {LAUNCH_STEPS} --device cuda "
        "--ckpt-dir build/chip_smoke_train_ckpt")
    tl = run_train_launcher(device)
    for line in tl["lines"]:
        log(f"  {line}")
    log(f"  exit 0 after {tl['wall_s']:.1f} s; its checkpoint restored and "
        f"served {tl['served']} through the paged kernel "
        f"({tl['launches']} launches)")
    log(f"  phases 20-22 took {time.perf_counter() - t_train:.1f} s")
    return tr


# -------------------------------------------------------------------- sweep

class recording:
    """Within the block, `module.name` (a params draw) keeps every tree it
    returns: training updates those tensors in place, so afterwards they
    hold the trained params."""

    def __init__(self, module, name):
        self.module, self.name, self.trees = module, name, []

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def draw(*args):
            self.trees.append(self.fn(*args))
            return self.trees[-1]
        setattr(self.module, self.name, draw)
        return self.trees

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def sweep_dataset():
    """The sweep launcher's dataset: 2,000 rows, 12 features, 4 classes."""
    from repro_torch.data import pipeline, synthetic
    return pipeline.prepare(synthetic.classification_csv(2000, 12, 4,
                                                         seed=SEED),
                            "label", seed=SEED)


def sweep_block(optimizer, lrs, activations) -> list:
    from repro_torch.core.tasks import TaskSpec
    return [TaskSpec.make("chip_smoke", "dnn_train", {
        "hidden_sizes": SWEEP_HIDDEN, "activations": list(activations),
        "lr": lr, "optimizer": optimizer, "epochs": SWEEP_EPOCHS,
        "batch_size": SWEEP_BATCH, "dataset": "default", "seed": i})
        for i, lr in enumerate(lrs)]


def members_against_dnn_train(block, docs, stacked, ctx, picks,
                              param_tol=PARAM_TOL) -> dict:
    """Each picked member of a trained population against `dnn_train` on
    its payload on the card: loss within PLANES_REL relative, accuracy
    within one test row, params within `param_tol` of each leaf's max
    (measured, not bounded, where it is None)."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.core import executors
    n_test = ctx["datasets"]["default"].x_test.shape[0]
    worst = {"loss_rel": 0.0, "param": 0.0, "acc": 0.0}
    for i in picks:
        with recording(executors, "member_params") as single:
            m = executors.dnn_train(block[i].payload, ctx)
        pm = docs[i]["metrics"]
        rel = abs(pm["final_loss"] - m["final_loss"]) / abs(m["final_loss"])
        acc = abs(pm["accuracy"] - m["accuracy"])
        if rel > PLANES_REL or acc > 1 / n_test + 1e-6:
            raise AssertionError(
                f"member {i}: loss {pm['final_loss']} against dnn_train's "
                f"{m['final_loss']}, accuracy {pm['accuracy']} against "
                f"{m['accuracy']}")
        for p, q in zip(tree_leaves(stacked), tree_leaves(single[0])):
            d = float((p[i] - q).abs().max() / q.abs().max())
            if param_tol is not None and d > param_tol:
                raise AssertionError(f"member {i}: params {d:.3g} of the "
                                     f"leaf's max from dnn_train's")
            worst["param"] = max(worst["param"], d)
        worst["loss_rel"] = max(worst["loss_rel"], rel)
        worst["acc"] = max(worst["acc"], acc)
    return worst


def population_phase(device, ds) -> dict:
    """Phase 23, parts 1 and 2: a full block of SWEEP_K members, its last
    one divergent, then members against dnn_train; an 8-member AdamW block
    of the launcher's ("relu", "tanh") design against dnn_train too."""
    from repro_torch.core import population
    from repro_torch.core.executors import DeviceData
    ctx = {"datasets": {"default": ds}, "device": str(device)}
    rng = np.random.default_rng(SEED + 23)
    lrs = [float(x) for x in rng.choice(SWEEP_LRS, SWEEP_K - 1)]
    block = sweep_block("sgd", lrs + [DIVERGENT_LR], ("relu",))
    t0 = time.perf_counter()         # first calls: cuBLAS's batched GEMMs
    population.train_population(block[:4], ctx)
    first_s = time.perf_counter() - t0
    with recording(population, "population_params") as drawn:
        t0 = time.perf_counter()
        docs = population.train_population(block, ctx)
        wall = time.perf_counter() - t0
    statuses = [d["status"] for d in docs]
    if statuses[:-1] != ["ok"] * (SWEEP_K - 1) or statuses[-1] != "failed" \
            or docs[-1]["error"] != "diverged (frozen in-graph)":
        raise AssertionError(f"statuses {sorted(set(statuses[:-1]))} and "
                             f"{statuses[-1]!r} for the divergent member")
    accs = [d["metrics"]["accuracy"] for d in docs[:-1]]
    losses = [d["metrics"]["final_loss"] for d in docs[:-1]]
    if not (all(np.isfinite(accs)) and all(np.isfinite(losses))):
        raise AssertionError("a healthy member's loss or accuracy is not "
                             "finite")
    steps = SWEEP_EPOCHS * (ds.x_train.shape[0] // SWEEP_BATCH)
    picks = [int(i) for i in np.linspace(0, SWEEP_K - 2, SWEEP_CHECKED)]
    loop = docs[0]["metrics"]["wall_time_block"]    # data, steps, a sync
    out = {"first_s": first_s, "wall_s": wall, "loop_s": loop,
           "steps": steps, "ms_per_step": loop * 1e3 / steps,
           "tasks_per_s": SWEEP_K / wall, "acc_mean": float(np.mean(accs)),
           "loss_mean": float(np.mean(losses)),
           "divergent_loss": docs[-1]["metrics"]["final_loss"],
           "block": block, "docs": docs,
           "sgd_vs_dnn_train": members_against_dnn_train(
               block, docs, drawn[0], ctx, picks)}

    cfg = population._block_config(block, ds)
    lr_t = torch.tensor(lrs + [DIVERGENT_LR], device=device)
    params = population.population_params(list(range(SWEEP_K)), cfg, device)
    opt_init, opt_update = population.population_optimizer("sgd", lr_t)
    state = {"params": params, "opt": opt_init(params),
             "alive": torch.ones(SWEEP_K, dtype=torch.bool, device=device)}
    step = population.build_population_step(cfg, opt_update)
    batch = next(DeviceData(ds, SWEEP_BATCH, 1, device).batches(0))

    def one_step():
        state["params"], state["opt"], state["alive"], _ = step(
            state["params"], state["opt"], state["alive"], batch)
    one_step()
    out["profile"] = profile_steps(one_step, 3)
    del state, params

    adam = sweep_block("adam", [SWEEP_LRS[i % 2] for i in
                                range(SWEEP_CHECKED)], ("relu", "tanh"))
    with recording(population, "population_params") as drawn:
        t0 = time.perf_counter()
        adocs = population.train_population(adam, ctx)
        out["adam_wall_s"] = time.perf_counter() - t0
    if any(d["status"] != "ok" for d in adocs):
        raise AssertionError("an AdamW member failed")
    # Adam's update m / (sqrt(v) + eps) carries a one-ulp difference
    # between the batched and the single GEMM across a relu's boundary into
    # a whole update of a small-gradient weight: on the card up to 7.1e-3
    # of a leaf's max (PERF.md, section 6); SGD stays within 3e-7
    out["adam_vs_dnn_train"] = members_against_dnn_train(
        adam, adocs, drawn[0], ctx, range(SWEEP_CHECKED), param_tol=None)
    return out


def run_sweep_launcher() -> dict:
    """Phase 23, part 3: the sweep launcher in a process of its own."""
    import os
    import shutil
    out_dir = ROOT / "build" / "chip_smoke_sweep"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [x for x in [env.get("PYTHONPATH")] if x])
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--n-tasks",
           str(SWEEP_TASKS), "--workers", str(SWEEP_WORKERS), "--epochs",
           str(SWEEP_EPOCHS), "--out", str(out_dir)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=LAUNCHER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[sweep]")]
    done = [re.match(r"\[sweep\] (\d+)/(\d+) done \((\d+) failed\) in "
                     r"([\d.]+)s — ([\d.]+) tasks/s", ln) for ln in lines]
    done = [m for m in done if m]
    arts = ["fig5_time_vs_layers.txt", "f1_accuracy_vs_capacity.txt",
            "f3_activations.md", "summary.md"]
    if out.returncode != 0 or not done or done[0].group(3) != "0" \
            or done[0].group(1) != str(SWEEP_TASKS) \
            or not all((out_dir / a).is_file() for a in arts):
        raise AssertionError(f"sweep launcher exit {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    shutil.rmtree(out_dir)
    return {"lines": lines, "wall_s": wall,
            "tasks_per_s": float(done[0].group(5))}


def lm_train_on_a_worker(device) -> dict:
    """Phase 23, part 4: the LM executor through a Worker on the card, as
    the reference's test runs it (reduced qwen3-1.7b)."""
    from repro_torch.core import ResultStore, TaskQueue, TaskSpec, Worker
    q, rs = TaskQueue(), ResultStore()
    q.put(TaskSpec.make("chip_smoke", "lm_train", {
        "arch": "qwen3-1.7b", "steps": 3, "batch_size": 2, "seq_len": 16}))
    w = Worker("w0", q, rs, {"device": str(device)})
    w.run_until_empty()
    docs = rs.find("chip_smoke")
    if len(docs) != 1 or docs[0]["status"] != "ok" \
            or not np.isfinite(docs[0]["metrics"]["final_loss"]) \
            or w.status()["backend"] != "cuda":
        raise AssertionError(f"lm_train on a worker: {docs}, {w.status()}")
    return {"metrics": docs[0]["metrics"], "status": w.status()}


def sweep_phase(device, card: str):
    """Phase 23, logged as it runs; each part raises on a failed check."""
    t_sweep = time.perf_counter()
    ds = sweep_dataset()
    log(f"[23] a population block of {SWEEP_K} members, {len(SWEEP_HIDDEN)} "
        f"x {SWEEP_HIDDEN[0]} relu, SGD (momentum 0.9), lrs from {SWEEP_LRS} "
        f"and one at {DIVERGENT_LR:g}, {SWEEP_EPOCHS} epochs of "
        f"{ds.x_train.shape[0]} rows in batches of {SWEEP_BATCH}; f32, TF32 "
        f"off; card: {card}")
    pop = population_phase(device, ds)
    log(f"  a first block of 4 members (set-up) {pop['first_s']:.4f} s; "
        f"then train_population of {SWEEP_K} members {pop['wall_s']:.4f} s "
        f"({pop['tasks_per_s']:.1f} tasks/s), its training loop "
        f"{pop['loop_s']:.4f} s for {pop['steps']} steps "
        f"({pop['ms_per_step']:.4f} ms a step, the data's copy to the card "
        f"included); {SWEEP_K - 1} ok (mean accuracy {pop['acc_mean']:.4f}, "
        f"loss {pop['loss_mean']:.4f}), the divergent member failed (loss "
        f"{pop['divergent_loss']}) and was frozen in-graph")
    log("[23] where a population step's time goes")
    log_profile(pop["profile"], "step")
    w = pop["sgd_vs_dnn_train"]
    log(f"  {SWEEP_CHECKED} members against dnn_train on the card: loss "
        f"within {w['loss_rel']:.3g} relative (tol {PLANES_REL}), params "
        f"{w['param']:.3g} of a leaf's max (tol {PARAM_TOL}), accuracy "
        f"{w['acc']:.4f}")
    w = pop["adam_vs_dnn_train"]
    log(f"  AdamW, {SWEEP_CHECKED} members of ('relu', 'tanh') in "
        f"{pop['adam_wall_s']:.4f} s: against dnn_train loss within "
        f"{w['loss_rel']:.3g} relative (tol {PLANES_REL}), accuracy "
        f"{w['acc']:.4f}; params {w['param']:.3g} of a leaf's max "
        "(measured, not bounded)")
    log(f"[23] the sweep launcher: python -m repro_torch.launch.sweep "
        f"--n-tasks {SWEEP_TASKS} --workers {SWEEP_WORKERS} --epochs "
        f"{SWEEP_EPOCHS} --out build/chip_smoke_sweep")
    sl = run_sweep_launcher()
    for line in sl["lines"]:
        log(f"  {line}")
    log(f"  exit 0 after {sl['wall_s']:.1f} s; {sl['tasks_per_s']:.2f} "
        "tasks/s over both planes")
    log("[23] lm_train through a Worker on the card (reduced qwen3-1.7b)")
    lm = lm_train_on_a_worker(device)
    log(f"  loss {lm['metrics']['first_loss']:.4f} -> "
        f"{lm['metrics']['final_loss']:.4f} in {lm['metrics']['steps']} "
        f"steps; worker status {lm['status']}")
    log(f"  phase 23 took {time.perf_counter() - t_sweep:.1f} s")
    return pop

# ------------------------------------------------- the other families

FAMILY_FRAMES = 400                # phase 26: encoder frames per row
FAMILY_PROMPT = 64                 # phases 26-27: text tokens per row
FAMILY_NEW = 16                    # phases 26-27: greedy tokens per row
PIXTRAL_PATCHES = 1024             # phase 27: a 512 x 512 image, 16 px patches
FAMILY_F32_LAYERS = 2              # phases 26-27's f32 checks: decoder depth
MOE_PROFILE_BATCH = 8              # phase 24's profiled decode batch


def family_config(arch: str, dtype: str, **kw):
    from repro_torch.configs import get
    return get(arch).replace(dtype=dtype, param_dtype=dtype, **kw)


def moe_decode_ms(params, cfg, device, batch) -> float:
    """Phase 24: the MoE FFNs of every layer on one decode step's input
    shape ((batch, 1, d) random activations), on the card alone."""
    from repro_torch.models import moe as MOE
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((batch, 1, cfg.d_model), generator=gen, device=device,
                    dtype=torch.float32).to(cfg.activation_dtype)
    ffns = [lp["ffn"] for lp in params["layers"]]

    def run():
        for ffn in ffns:
            MOE.moe_ffn(ffn, cfg, x)
    return time_graph(run, iters=5)


def family_batch(cfg, device, rows, prefix=0, frames=0, seed=SEED) -> dict:
    """Phases 26-27's input: FAMILY_PROMPT random tokens a row, after
    `prefix` random patch embeddings (pixtral's stub vision encoder) or
    over `frames` random encoder frames (seamless' stub speech
    frontend), drawn from a seeded CUDA generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, FAMILY_PROMPT),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    for key, n in (("embeds", prefix), ("enc_embeds", frames)):
        if n:
            batch[key] = torch.randn((rows, n, cfg.d_model), generator=gen,
                                     device=device).to(cfg.activation_dtype)
    return batch


def prefill_decode(params, cfg, batch, new_tokens, forced=None) -> dict:
    """Phases 26-27's path: `forward_prefill` over `batch` (the tokens
    after a prefix of embeds, or beside an encoder's frames), its caches
    copied into a dense cache with room for `new_tokens` more (the cross
    K/V with them), then greedy `decode_step`s; with `forced` (B,
    new_tokens) those tokens are fed instead of the argmax (the f32
    checks' lockstep). Every launch count is set to 0 just before and
    read just after."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.step import prefill_into_cache
    toks = batch["tokens"]
    B, dev = toks.shape[0], toks.device
    n = toks.shape[1] + (batch["embeds"].shape[1] if "embeds" in batch
                         else 0)
    enc_len = batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0
    fns = counters()
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, nat = T.forward_prefill(params, cfg, batch)
    cache = prefill_into_cache(cfg, nat, T.init_cache(
        cfg, B, n + new_tokens, dev, enc_len=enc_len),
        torch.full((B,), n, device=dev))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {k: fn.launches for k, fn in fns.items()}
    rows = [logits[:, -1].float()]
    tok = rows[0].argmax(-1) if forced is None else forced[:, 0]
    out = [tok]
    t0 = time.perf_counter()
    for t in range(1, new_tokens):
        pos = torch.full((B,), n + t - 1, dtype=torch.int32, device=dev)
        lg, cache = T.decode_step(params, cfg, tok[:, None].to(torch.int32),
                                  pos, cache)
        rows.append(lg[:, 0].float())
        tok = rows[-1].argmax(-1) if forced is None else forced[:, t]
        out.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(new_tokens - 1, 1)
    tokens = torch.stack(out, dim=1)
    if not (all(bool(torch.isfinite(r).all()) for r in rows)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{cfg.arch_id}: non-finite logits")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.arch_id}: token out of the vocabulary")
    return {"prefill_logits": logits.float(), "rows": rows, "tokens": tokens,
            "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
            "prefill_launches": prefill_launches,
            "launches": {k: fn.launches for k, fn in fns.items()}}


def check_prefill_launches(run: dict, cfg):
    """The flash kernel once per decoder layer in the prefill (the
    encoder and the cross-attention stay on the dense path, as in the
    reference), nothing else, and nothing in the decode steps."""
    want = {k: 0 for k in run["launches"]}
    want["flash_attention"] = cfg.n_layers
    if run["prefill_launches"] != want or run["launches"] != want:
        raise AssertionError(f"{cfg.arch_id}: prefill launches "
                             f"{run['prefill_launches']}, after the decode "
                             f"{run['launches']}; expected {want}")


def f32_pallas_vs_xla(cfg32, device, batch) -> dict:
    """Phases 26-27's f32 check (TF32 off): the same inputs through
    "pallas" (the flash kernel in the prefill) and "xla", the "pallas"
    run fed the "xla" run's greedy tokens: every logits row within
    LOGIT_TOL, and a greedy token may differ only where the "xla" run's
    top-2 gap is below LOGIT_TOL."""
    params = make_model(cfg32, device)
    ref = prefill_decode(params, cfg32.replace(attention_impl="xla"), batch,
                         FAMILY_NEW)
    got = prefill_decode(params, cfg32.replace(attention_impl="pallas"),
                         batch, FAMILY_NEW, forced=ref["tokens"])
    check_prefill_launches(got, cfg32)
    d_pre = (got["prefill_logits"] - ref["prefill_logits"]).abs().max().item()
    d_dec = max((a - b).abs().max().item()
                for a, b in zip(got["rows"], ref["rows"]))
    if max(d_pre, d_dec) > LOGIT_TOL:
        raise AssertionError(f"{cfg32.arch_id} f32: |logit diff| prefill "
                             f"{d_pre}, decode {d_dec} > {LOGIT_TOL}")
    flips = []
    for t, (a, b) in enumerate(zip(got["rows"], ref["rows"])):
        for row in torch.nonzero(a.argmax(-1) != b.argmax(-1)).flatten():
            top2 = torch.topk(b[row], 2).values
            gap = (top2[0] - top2[1]).item()
            if gap >= LOGIT_TOL:
                raise AssertionError(f"{cfg32.arch_id} f32: step {t} row "
                                     f"{int(row)}: greedy tokens differ with "
                                     f"top-2 gap {gap}")
            flips.append((t, int(row), gap))
    return {"prefill": d_pre, "decode": d_dec, "flips": flips,
            "steps": len(got["rows"])}


def log_family_run(run: dict, rows: int):
    log(f"  prefill {run['prefill_ms']:.3f} ms ({rows} rows, the cache copy "
        f"included), decode step {run['decode_step_ms']:.3f} ms mean over "
        f"{len(run['rows']) - 1} steps; launches {run['launches']}")


def log_f32(c: dict, cfg32):
    log(f"  {cfg32.arch_id} f32 at depth {cfg32.n_layers}: max |logit diff| "
        f"prefill {c['prefill']:.3g}, decode {c['decode']:.3g} over "
        f"{c['steps']} steps (tol {LOGIT_TOL}); greedy flips {c['flips']}")


def granite_phase(device) -> dict:
    """Phase 24: granite-moe-1b-a400m at full width and depth, bf16, on
    the paged path (single, fused) and the dense "pallas" path, profiled,
    then the f32 paged kernel against the dense-gather oracle."""
    cfg = family_config("granite-moe-1b-a400m", "bfloat16")
    params = make_model(cfg, device)
    log(f"  {numel(params) / 1e9:.3f} B parameters ({cfg.moe.n_experts} "
        f"experts top-{cfg.moe.top_k}, expert d_ff {cfg.moe.expert_d_ff}, "
        f"capacity factor {cfg.moe.capacity_factor})")
    eng = make_engine(params, cfg, device, "cuda")
    warm = make_requests(cfg, n=4, new_tokens=4, seed=SEED + 1)
    for p, s, n in warm:
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    requests = make_requests(cfg)
    served = serve(eng, requests)
    log(f"  {served['requests']} requests, {served['decode_dispatches']} "
        f"decode dispatches, {served['launches']} paged kernel launches "
        f"(= {cfg.n_layers} x decode dispatches), cache hits "
        f"{served['cache']['hits']}, CoW copies "
        f"{served['cache']['cow_copies']}")
    log(f"  decode step {served['decode_step_ms_mean']:.3f} ms mean, "
        f"{served['decode_tokens_per_s']:.1f} decode tokens/s, prefill "
        f"{served['prefill_ms_mean']:.3f} ms mean, "
        f"{served['tokens_per_s']:.1f} tokens/s end to end over "
        f"{served['wall_s']:.3f} s")
    closures = eng._decode_tok, eng._prefill_tok
    finite_round(eng, requests[:8])
    eng._decode_tok, eng._prefill_tok = closures
    log(f"[24] where a greedy batch-{MOE_PROFILE_BATCH} decode step's time "
        "goes (bf16)")
    prof = profile_decode(eng, requests)
    log_profile(prof)
    log_share(prof, "paged_attention", "step")
    moe_ms = moe_decode_ms(params, cfg, device, MOE_PROFILE_BATCH)
    share = (f"{100 * moe_ms / prof['device_ms']:.1f}% of the step's device "
             "busy time" if prof["busy_share"] is not None
             else "the step's device time not measured")
    log(f"  the MoE FFNs of all {cfg.n_layers} layers at the step's shape "
        f"(batch {MOE_PROFILE_BATCH}, one token a row): {moe_ms:.4f} ms on "
        f"the card alone, {share}")
    del eng

    log(f"[24] fused decode, fused_tokens={FUSED_TOKENS} (bf16)")
    eng = make_variant(params, cfg, device, fused_tokens=FUSED_TOKENS)
    fused = serve_variant(eng, requests)
    log_variant(fused)
    if fused["replays"] < 1:
        raise AssertionError("granite: no fused dispatch replayed a graph")
    del eng

    log("[24] the dense layout, attention_impl='pallas' (bulk prefill "
        "through the flash kernel, bf16)")
    eng = make_dense_engine(params, cfg.replace(attention_impl="pallas"),
                            device, 8, 512)
    for p, s, n in warm:
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    dense = serve_dense(eng, requests, {"flash_attention": cfg.n_layers})
    log_served(dense)
    finite_round(eng, requests[:8])
    del eng, params
    torch.cuda.empty_cache()

    log("[24] the paged kernel against the dense-gather oracle, f32 (TF32 "
        "off)")
    cfg32 = family_config("granite-moe-1b-a400m", "float32")
    params32 = make_model(cfg32, device)
    oracle = compare_to_oracle(params32, cfg32, device,
                               make_requests(cfg32, n=8, new_tokens=16),
                               moe_buffer=True)
    log_lockstep(oracle)
    log(f"  grouped MoE experts launches {oracle['moe_launches'][0]} "
        f"(cuda, {cfg32.n_layers} x decode steps), "
        f"{oracle['moe_launches'][1]} (the oracle's buffer path)")
    del params32
    torch.cuda.empty_cache()
    return {"served": served, "fused": fused, "dense": dense,
            "profile": prof, "moe_ms": moe_ms, "oracle": oracle}


def granite3b_phase(device) -> dict:
    """Phase 25: granite-moe-3b-a800m at full width and depth, bf16, four
    requests on the paged path, single steps then fused."""
    cfg = family_config("granite-moe-3b-a800m", "bfloat16")
    params = make_model(cfg, device)
    log(f"  {numel(params) / 1e9:.3f} B parameters ({cfg.moe.n_experts} "
        f"experts top-{cfg.moe.top_k})")
    eng = make_engine(params, cfg, device, "cuda")
    for p, s, n in make_requests(cfg, n=2, new_tokens=4, seed=SEED + 1):
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    requests = make_requests(cfg, n=4)
    served = serve(eng, requests)
    log(f"  {served['requests']} requests, {served['decode_dispatches']} "
        f"decode dispatches, {served['launches']} paged kernel launches "
        f"(= {cfg.n_layers} x decode dispatches); decode step "
        f"{served['decode_step_ms_mean']:.3f} ms mean, prefill "
        f"{served['prefill_ms_mean']:.3f} ms mean")
    del eng
    log(f"[25] fused decode, fused_tokens={FUSED_TOKENS} (bf16, greedy)")
    eng = make_variant(params, cfg, device, fused_tokens=FUSED_TOKENS)
    fused = serve_variant(eng, greedy(requests))
    log_variant(fused)
    if fused["replays"] < 1:
        raise AssertionError("granite-3b: no fused dispatch replayed a graph")
    del eng, params
    torch.cuda.empty_cache()
    return {"served": served, "fused": fused}


def stub_input_phase(device, arch: str, rows: int, **stub) -> dict:
    """Phases 26-27: `arch` at full width and depth, bf16, "pallas", on
    `rows` rows of FAMILY_PROMPT tokens with its stub input (`frames=`
    encoder frames or a `prefix=` of patch embeddings), FAMILY_NEW greedy
    tokens; then the f32 check with the decoder (and an encoder) cut to
    FAMILY_F32_LAYERS layers."""
    cfg = family_config(arch, "bfloat16", attention_impl="pallas")
    t0 = time.perf_counter()
    params = make_model(cfg, device)
    log(f"  {numel(params) / 1e9:.3f} B parameters ({cfg.n_enc_layers} "
        f"encoder + {cfg.n_layers} decoder layers) made in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    batch = family_batch(cfg, device, rows, **stub)
    prefill_decode(params, cfg, batch, 2)            # first calls
    run = prefill_decode(params, cfg, batch, FAMILY_NEW)
    check_prefill_launches(run, cfg)
    log_family_run(run, rows)
    del params
    torch.cuda.empty_cache()
    cut = {"n_layers": FAMILY_F32_LAYERS}
    if cfg.is_encdec:
        cut["n_enc_layers"] = FAMILY_F32_LAYERS
    cfg32 = family_config(arch, "float32", **cut)
    f32 = f32_pallas_vs_xla(cfg32, device,
                            family_batch(cfg32, device, rows, **stub))
    log_f32(f32, cfg32)
    torch.cuda.empty_cache()
    return {"run": run, "f32": f32}


def family_phases(device, card: str) -> dict:
    """Phases 24-27, logged as they run; each raises on a failed check."""
    t_fam = time.perf_counter()
    log(f"[24] granite-moe-1b-a400m at full width, paged, bf16; card: {card}")
    granite = granite_phase(device)
    log("[25] granite-moe-3b-a800m at full width, paged, bf16")
    granite3b = granite3b_phase(device)
    log(f"[26] seamless-m4t-large-v2 at full width, bf16, 'pallas': "
        f"{FAMILY_FRAMES} encoder frames and a {FAMILY_PROMPT}-token prompt "
        f"a row, {FAMILY_NEW} greedy tokens")
    encdec = stub_input_phase(device, "seamless-m4t-large-v2", 2,
                              frames=FAMILY_FRAMES)
    log(f"[27] pixtral-12b at full width, bf16, 'pallas': {PIXTRAL_PATCHES} "
        f"patch embeddings and a {FAMILY_PROMPT}-token prompt, {FAMILY_NEW} "
        f"greedy tokens from position {PIXTRAL_PATCHES + FAMILY_PROMPT}")
    gc.collect()                   # what earlier phases left in cycles
    torch.cuda.empty_cache()
    prefix = stub_input_phase(device, "pixtral-12b", 1,
                              prefix=PIXTRAL_PATCHES)
    log(f"  phases 24-27 took {time.perf_counter() - t_fam:.1f} s")
    return {"granite": granite, "granite3b": granite3b, "encdec": encdec,
            "prefix": prefix}


# ----------------------------------------------------------------- main

# ------------------------------------------------------- distribution

SHARDED_REL = 1e-5                 # phase 28: sharded vs unsharded losses
DRYRUN_CASES = [("qwen3-1.7b", "decode_32k", []),
                ("granite-moe-1b-a400m", "train_4k", ["--multi-pod-only"])]
DRYRUN_TIMEOUT_S = 300


class timed_batches:
    """An iterator over `batches` that stamps the host clock (after a
    device sync) at each `next()`: `train_sharded` reads each logged loss
    before it asks for the next batch, so the stamps bound its steps."""

    def __init__(self, batches):
        self.batches, self.stamps = iter(batches), []

    def __iter__(self):
        return self

    def __next__(self):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        return next(self.batches)


def sharded_train(device, card, tr) -> dict:
    """Phase 28, part 1: train_sharded on a (1, 1, 1) mesh against phase
    20's unsharded run (the same weights, batches, schedule and rate)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils._pytree import tree_leaves
    from repro_torch.launch import distributed as D
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import linear_warmup_cosine
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import spmd
    cfg = full_config("float32")
    mesh = init_device_mesh(device.type, (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    batches = token_batches(cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                            device)
    data = timed_batches(batches)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    params, opt, losses = D.train_sharded(
        cfg, mesh, data, num_steps=TRAIN_STEPS, lr=TRAIN_LR, seed=SEED,
        log_every=1, verbose=False)
    torch.cuda.synchronize()
    ends = data.stamps[1:] + [time.perf_counter()]
    ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
    bad = [x for x in leaves if not (spmd.is_dtensor(x)
                                     and x.device.type == device.type)]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(leaves)} params and "
                             "moments are not DTensors on the card")
    for i, (a, b) in enumerate(zip(losses, tr["losses"])):
        rel_close(f"sharded step {i + 1} loss against the unsharded step",
                  a, b, SHARDED_REL)
    _, opt_update = adamw(linear_warmup_cosine(
        TRAIN_LR, max(TRAIN_STEPS // 10, 1), TRAIN_STEPS))
    p_specs = R.param_specs(cfg, params, mesh)
    step, b_specs = D.make_sharded_step(cfg, mesh, opt_update, p_specs, None,
                                        batches[0])
    state = {"params": params, "opt": opt}

    def one_step():
        state["params"], state["opt"], _ = step(
            state["params"], state["opt"],
            D.put_batch(mesh, b_specs, batches[1]))
    prof = profile_steps(one_step, 1)
    out = {"losses": losses, "ms": ms,
           "step_ms": float(np.median(ms[1:])) if len(ms) > 1 else ms[0],
           "peak_gib": peak / 2**30, "resident_gib": resident / 2**30,
           "n_leaves": len(leaves), "profile": prof}
    del params, opt, state, leaves
    torch.cuda.empty_cache()
    return out


def sharded_population(device, pop) -> dict:
    """Phase 28, part 2: phase 23's block with `mesh=` against phase 23's
    results."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import population
    mesh = init_device_mesh(device.type, (1,), mesh_dim_names=("data",))
    ctx = {"datasets": {"default": sweep_dataset()}, "device": str(device)}
    t0 = time.perf_counter()
    docs = population.train_population(pop["block"], ctx, mesh=mesh,
                                       population_axes=("data",))
    wall = time.perf_counter() - t0
    n_test = ctx["datasets"]["default"].x_test.shape[0]
    worst = 0.0
    for a, b in zip(docs, pop["docs"]):
        if a["status"] != b["status"]:
            raise AssertionError(f"{a['task_id']}: {a['status']} on the mesh, "
                                 f"{b['status']} in phase 23")
        if b["status"] != "ok":
            continue
        la, lb = a["metrics"]["final_loss"], b["metrics"]["final_loss"]
        rel_close(f"{a['task_id']} loss on the mesh", la, lb, SHARDED_REL)
        worst = max(worst, abs(la - lb) / abs(lb))
        if abs(a["metrics"]["accuracy"] - b["metrics"]["accuracy"]) \
                > 1.0 / n_test + 1e-9:
            raise AssertionError(f"{a['task_id']}: accuracy "
                                 f"{a['metrics']['accuracy']} against "
                                 f"{b['metrics']['accuracy']}")
    return {"wall_s": wall, "worst_rel": worst, "members": len(docs),
            "ok": sum(d["status"] == "ok" for d in docs)}


def run_dryrun_cli() -> list:
    """Phase 28, part 3: the dry-run CLI, each case in a process of its
    own, all started together (each is one host thread of Python); their
    output goes to build/chip_smoke_dryrun/<arch>__<shape>.log. A case
    still running at DRYRUN_TIMEOUT_S, or after another failed, is
    killed."""
    dest = Path("build") / "chip_smoke_dryrun"
    dest.mkdir(parents=True, exist_ok=True)
    procs, logs, ends = [], [], {}
    t0 = time.perf_counter()
    try:
        for arch, shape, extra in DRYRUN_CASES:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, *extra, "--out",
                   str(dest)]
            logs.append(open(dest / f"{arch}__{shape}.log", "w"))
            procs.append(subprocess.Popen(
                cmd, stdout=logs[-1], stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONPATH": str(SRC)}))
        while len(ends) < len(procs):
            for i, p in enumerate(procs):
                if i not in ends and p.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            if time.perf_counter() - t0 > DRYRUN_TIMEOUT_S:
                raise AssertionError(f"dryrun: {len(procs) - len(ends)} "
                                     f"case(s) still running after "
                                     f"{DRYRUN_TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    out = []
    for i, (arch, shape, extra) in enumerate(DRYRUN_CASES):
        if procs[i].returncode != 0:
            text = (dest / f"{arch}__{shape}.log").read_text()
            raise AssertionError(f"dryrun {arch} {shape} exit "
                                 f"{procs[i].returncode}: {text[-4000:]}")
        tag = "pod2" if "--multi-pod-only" in extra else "pod1"
        rec = json.loads((dest / f"{arch}__{shape}__{tag}.json").read_text())
        if not rec["flops_per_device"] > 0:
            raise AssertionError(f"dryrun {arch} {shape}: flops_per_device "
                                 f"{rec['flops_per_device']}")
        out.append({"arch": arch, "shape": shape, "mesh": tag,
                    "n_devices": rec["n_devices"], "wall_s": ends[i],
                    "flops_per_device": rec["flops_per_device"],
                    "collective_bytes_per_device":
                        rec["collective_bytes_per_device"],
                    "peak_bytes": rec["memory"]["peak_bytes"]})
    return out


def distribution_phase(device, card: str, tr: dict, pop: dict):
    """Phase 28, logged as it runs; each part raises on a failed check."""
    import torch.distributed as dist
    from repro_torch.launch import distributed as D
    t_dist = time.perf_counter()
    D.initialize(device=device.type)
    log(f"[28] train_sharded on a one-rank {dist.get_backend()} process "
        f"group, a (1, 1, 1) ('pod', 'data', 'model') mesh: full-width, "
        f"full-depth qwen3-1.7b in f32 (TF32 off), phase 20's weights and "
        f"batches, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens; card: {card}")
    sh = sharded_train(device, card, tr)
    log(f"  loss {' '.join(f'{x:.6f}' for x in sh['losses'])} (phase 20 "
        f"unsharded: {' '.join(f'{x:.6f}' for x in tr['losses'])}; tol "
        f"{SHARDED_REL} relative); {sh['n_leaves']} params and moments, "
        "every one a DTensor on the card")
    log(f"  step ms {' '.join(f'{x:.3f}' for x in sh['ms'])} (host clock "
        "between loss reads)")
    busy = sh["profile"]["busy_share"]
    busy20 = tr["profile"]["busy_share"]
    log(f"  step {sh['step_ms']:.3f} ms (median of steps 2-{TRAIN_STEPS}; "
        f"phase 20: {tr['step_ms']:.3f}), peak memory {sh['peak_gib']:.2f} "
        f"GiB over the run ({sh['resident_gib']:.2f} GiB resident before it"
        f"; phase 20: {tr['peak_gib']:.2f} GiB), device busy share "
        f"{busy if busy is None else round(busy, 4)} of a profiled sharded "
        f"step ({sh['profile']['step_ms']:.3f} ms; phase 20's "
        f"{busy20 if busy20 is None else round(busy20, 4)}); card: {card}")
    log("[28] where a sharded train step's time goes")
    log_profile(sh["profile"], "sharded train step")
    log(f"[28] phase 23's block of {SWEEP_K} members with mesh= (a ('data',)"
        f" mesh of 1), against phase 23's results")
    ps = sharded_population(device, pop)
    log(f"  {ps['members']} members ({ps['ok']} ok) in {ps['wall_s']:.4f} s "
        f"(phase 23: {pop['wall_s']:.4f} s); losses within "
        f"{ps['worst_rel']:.3g} relative (tol {SHARDED_REL}), the same "
        "statuses and accuracies")
    dist.destroy_process_group()
    log("[28] the dry-run CLI (fake process groups on the host)")
    for r in run_dryrun_cli():
        log(f"  {r['arch']} {r['shape']} {r['mesh']} ({r['n_devices']} "
            f"ranks): exit 0 in {r['wall_s']:.1f} s, flops/device "
            f"{r['flops_per_device']:.4g}, collective bytes/device "
            f"{r['collective_bytes_per_device']:.4g}, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  phase 28 took {time.perf_counter() - t_dist:.1f} s")


# ---------------------------------------------------- tensor parallelism

TP_RANKS = 2                       # phases 29-34: two model ranks
TP_REL = 1e-4                      # their losses against one process's
TP_TIMEOUT_S = 600
TP_FAMILY_STEPS = 4                # phases 29-31, 33-34: AdamW steps
TP_MAMBA_SEQ = 512                 # phase 34: two 256-token chunks a row
TP_VOCAB_PAD = 256                 # phase 30: 49155 -> 49408, as the
                                   # dry-run pads it (two ranks divide it)
SEAMLESS_ROWS, SEAMLESS_FRAMES, SEAMLESS_TOKENS = 4, 400, 256   # phase 31
DP_LAYERS = 4                      # phase 32: granite-moe-1b's depth cut
DP_GRAD_TOL = 1e-5                 # each leaf's gradient, of its max
DP_LB_REL = 1e-6                   # the load balance against one device's
SERVE_TP_ROWS, SERVE_TP_PROMPT = 4, 256    # phases 35-37: the prompts
SERVE_TP_SLOTS = 1024              # phases 35-37: decode slots, 512 a rank
SERVE_TP_FRAMES = 400              # phase 36: seamless' frames (200 a rank)
SERVE_TP_STEPS = {"qwen3-1.7b": 16, "granite-moe-1b-a400m": 8,
                  "seamless-m4t-large-v2": 8, "recurrentgemma-9b": 8,
                  "mamba2-130m": 8}                 # greedy decode steps
SERVE_TP_LOGITS_EVERY = 8          # a step's logits checked every 8th step
SERVE_TP_ARCHS = {35: ("qwen3-1.7b",),
                  36: ("granite-moe-1b-a400m", "seamless-m4t-large-v2"),
                  37: ("recurrentgemma-9b", "mamba2-130m")}
SERVE_TP_PATHS = {"qwen3-1.7b": "tp_serve_qwen3",        # the kernels line's
                  "granite-moe-1b-a400m": "tp_serve_granite_1b",
                  "seamless-m4t-large-v2": "tp_serve_seamless",
                  "recurrentgemma-9b": "tp_serve_rgemma",
                  "mamba2-130m": "tp_serve_mamba2"}


class peak_batches(timed_batches):
    """timed_batches that also reads and resets the peak device memory at
    each `next()`: `peaks[0]` is the set-up's (the full seeded init, then
    the shards), `peaks[i]` step i's up to its loss read."""

    def __init__(self, batches, device):
        super().__init__(batches)
        self.device, self.peaks = device, []

    def __next__(self):
        sync_device(self.device)
        self.stamps.append(time.perf_counter())
        self.peaks.append(peak_bytes(self.device, reset=True))
        return next(self.batches)


def sync_device(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device, reset=False) -> int:
    """The device's peak allocated bytes since the last reset (0 on the
    CPU, where a rehearsal runs)."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated()
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tp_config(phase: int):
    """The f32 model of a tensor-parallel phase: 29 qwen3-1.7b (phase 20's),
    30 granite-moe-1b-a400m (its vocabulary padded to TP_VOCAB_PAD), 31
    seamless-m4t-large-v2, 34 mamba2-130m, each at full width and depth;
    33 recurrentgemma-9b at full width, one pattern block deep (phase
    21's cut)."""
    if phase == 29:
        return full_config("float32")
    if phase == 30:
        return family_config("granite-moe-1b-a400m", "float32",
                             vocab_pad_to=TP_VOCAB_PAD)
    if phase == 33:
        return rgemma_config("float32", n_layers=RGEMMA_TRAIN_LAYERS,
                             tail_pattern=())
    if phase == 34:
        return mamba_config("float32")
    return family_config("seamless-m4t-large-v2", "float32")


def tp_batches(phase: int, cfg, device, n=None, rows=None, seq=None,
               seed=SEED) -> list:
    """A phase's training batches, the same in every process (the token
    stream; seamless' stub frames from a seeded CUDA generator): 8 x 256
    tokens for 29, 30 and 33, 4 rows of 400 frames + 256 tokens for 31,
    8 x 512 tokens for 34."""
    if phase == 31:
        rows = rows or SEAMLESS_ROWS
        out = token_batches(cfg, n or TP_FAMILY_STEPS, rows,
                            seq or SEAMLESS_TOKENS, device, seed=seed)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        for b in out:
            b["enc_embeds"] = torch.randn(
                (rows, SEAMLESS_FRAMES, cfg.d_model), generator=gen,
                device=device)
        return out
    return token_batches(cfg, n or TP_FAMILY_STEPS,
                         rows or TRAIN_BATCH,
                         seq or (TP_MAMBA_SEQ if phase == 34 else TRAIN_SEQ),
                         device, seed=seed)


def tp_want_reduces(phase: int, cfg) -> int:
    """The model-axis all-reduces of a step (one microbatch): 4 a dense
    layer, 5 an MoE layer (the attention's 2; the experts' output forward,
    their input's and the gate weights' copies backward), 4 an encoder
    layer and 6 a decoder layer with cross-attention, 1 for the encoder
    output, 6 an RG-LRU layer (the mixer's input backward, its conv
    output's gather forward and backward, its output forward; the MLP's
    2), 4 a Mamba2 layer (its input backward, the norm's sum of squares
    forward and backward, its output forward), plus the embedding's 1 and
    the logits' and loss's 4; and two for each leaf stored split over
    "model" that the step takes whole and uses inside the split (its
    gather, its gradient's reduction: recurrentgemma's wk and wv, each
    Mamba2 layer's in_proj and conv_w; `tp.leaf_gather_all_reduces`)."""
    from repro_torch.launch.shapes import params_shapes
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import tp as TP
    mesh = R.mesh_like((1, 1, TP_RANKS), ("pod", "data", "model"))
    gathers = TP.leaf_gather_all_reduces(
        cfg, params_shapes(cfg), mesh, TP.TensorParallel.build(cfg, mesh))
    if cfg.is_encdec:
        return 4 * cfg.n_enc_layers + 6 * cfg.n_layers + 1 + 5 + gathers
    per = {"attn": 5 if cfg.moe else 4, "rglru": 6, "ssm": 4}
    return sum(per[t] for t in cfg.layer_types()) + 5 + gathers


def tp_want_launches(cfg) -> dict:
    """The kernels a rank's "pallas" training forward launches: flash once
    per decoder attention layer, the RG-LRU scan per RG-LRU layer, SSD per
    Mamba2 layer."""
    types = cfg.layer_types()
    return {"flash_attention": types.count("attn"),
            "rglru_scan": types.count("rglru"),
            "ssd_scan": types.count("ssm")}


def tp_baseline(device, phase: int) -> dict:
    """Phases 30-31 and 33-34's oracle: the same seeded weights, batches,
    schedule and rate as `train_sharded`'s through the unsharded step in
    this process on the card."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import linear_warmup_cosine
    from repro_torch.train.step import build_lm_train_step
    cfg = tp_config(phase)
    batches = tp_batches(phase, cfg, device)
    n = len(batches)
    gc.collect()
    torch.cuda.empty_cache()
    sync_device(device)
    peak_bytes(device, reset=True)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = T.init_lm(gen, cfg)
    n_params = numel(params)
    opt_init, opt_update = adamw(linear_warmup_cosine(
        TRAIN_LR, max(n // 10, 1), n))
    step = build_lm_train_step(cfg, opt_update)
    opt = opt_init(params)
    losses, ms, dropped = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        dropped.append(float(m["dropped_frac"]))
    peak = peak_bytes(device)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "dropped_frac": dropped,
            "step_ms": float(np.median(ms[1:])), "peak_gib": peak / 2**30,
            "params": n_params}


def tp_rank(rank: int, port: int, out_dir: str, device_type: str,
            phase: int = 29):
    """Phases 29-37, one rank, in a process of its own (`tp_rank_run`;
    phase 32: `dp_rank_run`; a tuple of the serving phases 35-37:
    `serve_rank_run`). Writes rank<r>.json (its "error" on a
    failure) and exits non-zero on a failure."""
    import traceback
    out = {"rank": rank}
    run = dp_rank_run if phase == 32 else (
        serve_rank_run if isinstance(phase, tuple) else tp_rank_run)
    try:
        out.update(run(rank, port, torch.device(device_type), phase))
    except Exception:
        out["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if "error" in out:
        raise SystemExit(1)


def init_ranks(rank: int, port: int, device, mesh_shape: tuple):
    """A rank of phases 29-34 on the card: TF32 off, gloo (NCCL refuses
    two ranks on one device; gloo all-reduces CUDA tensors, probed here),
    a ("pod", "data", "model") mesh of `mesh_shape`."""
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from torch.distributed.device_mesh import init_device_mesh
    if device.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TP_RANKS, rank=rank)
    mesh = init_device_mesh(device.type, mesh_shape,
                            mesh_dim_names=("pod", "data", "model"))
    probe = torch.full((4,), float(rank + 1), device=device)
    dist.all_reduce(probe)
    want = float(sum(range(1, TP_RANKS + 1)))
    if probe.tolist() != [want] * 4:
        raise AssertionError(f"gloo all-reduce on {device}: "
                             f"{probe.tolist()}")
    return mesh


def tp_rank_run(rank: int, port: int, device, phase: int = 29) -> dict:
    """Phases 29-31 and 33-34: a (1, 1, 2) mesh, `train_sharded` on the
    phase's model, weights, batches and schedule, tensor parallel; a timed
    and a profiled step counting the model-axis all-reduces; then the
    "pallas" forward under no_grad on this rank's heads and channels
    against "xla", every kernel's launches counted."""
    import torch.distributed as dist
    mesh = init_ranks(rank, port, device, (1, 1, TP_RANKS))
    from torch.distributed.tensor import Replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten
    from repro_torch.launch import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import linear_warmup_cosine
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import spmd
    from repro_torch.sharding.tp import TensorParallel
    from repro_torch.train.step import build_lm_train_step
    try:
        cfg = tp_config(phase)
        batches = tp_batches(phase, cfg, device)
        n = len(batches)
        data = peak_batches(batches, device)
        sync_device(device)
        peak_bytes(device, reset=True)
        params, opt, losses = D.train_sharded(
            cfg, mesh, data, num_steps=n, lr=TRAIN_LR, seed=SEED,
            log_every=1, verbose=False)
        sync_device(device)
        ends = data.stamps[1:] + [time.perf_counter()]
        ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
        peaks = data.peaks + [peak_bytes(device)]

        tp = TensorParallel.build(cfg, mesh)
        _, opt_update = adamw(linear_warmup_cosine(
            TRAIN_LR, max(n // 10, 1), n))
        step = build_lm_train_step(cfg, opt_update, tp=tp)
        b_specs = R.batch_specs(cfg, batches[0], mesh)
        state = {"params": params, "opt": opt}

        def one_step():
            state["params"], state["opt"], state["m"] = step(
                state["params"], state["opt"],
                D.put_batch(mesh, b_specs, batches[1]))
        # rank 0 profiles (two calls of the step), rank 1 steps alongside
        prof = None
        if device.type == "cuda" and rank == 0:
            prof = profile_steps(one_step, 1)
        else:
            one_step()
            one_step()
        per_step = tp.all_reduces / 2
        mib_per_step = tp.all_reduce_bytes / 2 / 2**20
        dropped = float(state["m"]["dropped_frac"])
        params = state["params"]
        del opt, state

        leaves, spec = tree_flatten(params)
        inputs = tp_batches(phase, cfg, device, n=1, rows=2, seq=EVAL_SEQ,
                            seed=SEED + 5)[0]
        with torch.no_grad():
            local = tree_unflatten(spmd.split_params(
                leaves, R.leaf_paths(params), (Replicate(),) * mesh.ndim,
                tp), spec)
            ref, _ = T.forward_train(local, cfg, inputs, tp=tp)
            fns = counters()
            for fn in fns.values():
                fn.launches = 0
            got, _ = T.forward_train(
                local, cfg.replace(attention_impl="pallas"), inputs, tp=tp)
            sync_device(device)
        launches = {k: fn.launches for k, fn in fns.items()
                    if k != "paged_attention"}
        err = float((got - ref).abs().max())
        return {"losses": losses, "ms": ms,
                "peaks_gib": [p / 2**30 for p in peaks],
                "all_reduces_per_step": per_step,
                "all_reduce_mib_per_step": mib_per_step,
                "dropped_frac": dropped,
                "profile": None if prof is None else {
                    k: prof[k] for k in ("step_ms", "device_ms",
                                         "busy_share", "top")},
                "local_heads": tp.local_heads(cfg),
                "local_kv_heads": cfg.n_kv_heads // TP_RANKS if tp.kv
                else len(tp.kv_heads(cfg)),
                "local_lru": (cfg.rglru.lru_width // TP_RANKS if tp.lru
                              else None),
                "local_ssm_heads": (cfg.ssm.n_heads(cfg.d_model) // TP_RANKS
                                    if tp.ssm else None),
                "experts": tp.experts,
                "local_experts": (len(tp.local_experts(cfg)) if cfg.moe
                                  else None),
                "logits_shape": list(got.shape),
                "pallas_launches": launches, "pallas_max_abs_err": err}
    finally:
        dist.destroy_process_group()


def run_ranks(device, phase: int):
    """Phase `phase`'s TP_RANKS ranks (`tp_rank`), each a process on the
    one card, joined with a timeout and killed if still alive; (their
    results, the wall seconds). Raises if a rank failed."""
    import multiprocessing as mp
    out_dir = ROOT / "build" / "chip_smoke_tp"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("rank*.json"):
        f.unlink()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp_rank,
                         args=(r, port, str(out_dir), device.type, phase))
             for r in range(TP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(TP_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    ranks = []
    for r, p in enumerate(procs):
        path = out_dir / f"rank{r}.json"
        if not path.exists():
            raise AssertionError(f"phase {phase} rank {r}: no result (exit "
                                 f"code {p.exitcode}, {wall:.0f} s)")
        res = json.loads(path.read_text())
        if "error" in res or p.exitcode != 0:
            raise AssertionError(f"phase {phase} rank {r} (exit code "
                                 f"{p.exitcode}): {res.get('error')}")
        ranks.append(res)
    return ranks, wall


def tp_phase(device, card: str, base: dict, phase: int) -> dict:
    """Phases 29-31 and 33-34: two model ranks, each a process on the one
    card, train the phase's model tensor parallel; returns both ranks'
    results after the checks against `base` (`tp_baseline`'s: the
    unsharded run's losses)."""
    cfg = tp_config(phase)
    ranks, wall = run_ranks(device, phase)
    want_launches = tp_want_launches(cfg)
    want_reduces = tp_want_reduces(phase, cfg)
    for res in ranks:
        r = res["rank"]
        if len(res["losses"]) != len(base["losses"]):
            raise AssertionError(f"phase {phase} rank {r}: "
                                 f"{len(res['losses'])} losses")
        for i, (a, b) in enumerate(zip(res["losses"], base["losses"])):
            rel_close(f"phase {phase} rank {r} step {i + 1} loss against "
                      "the unsharded step's", a, b, TP_REL)
        if res["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"phase {phase}: the ranks logged other "
                                 "losses")
        if res["all_reduces_per_step"] != want_reduces:
            raise AssertionError(f"phase {phase} rank {r}: "
                                 f"{res['all_reduces_per_step']} model-axis "
                                 f"all-reduces a step, expected "
                                 f"{want_reduces}")
        if res["pallas_launches"] != want_launches:
            raise AssertionError(f"phase {phase} rank {r}: kernel launches "
                                 f"{res['pallas_launches']}, expected "
                                 f"{want_launches}")
        if not res["pallas_max_abs_err"] <= LOGIT_TOL:
            raise AssertionError(f"phase {phase} rank {r}: 'pallas' logits "
                                 f"{res['pallas_max_abs_err']} from 'xla', "
                                 f"beyond {LOGIT_TOL}")
        if res["logits_shape"][-1] * TP_RANKS != cfg.padded_vocab_size:
            raise AssertionError(f"phase {phase} rank {r}: logits "
                                 f"{res['logits_shape']}")
        if cfg.moe and res["experts"] != "expert":
            raise AssertionError(f"phase {phase} rank {r}: experts split "
                                 f"as {res['experts']}")
        if (cfg.rglru and res["local_lru"] is None) or \
                (cfg.ssm and res["local_ssm_heads"] is None):
            raise AssertionError(f"phase {phase} rank {r}: the recurrent "
                                 "mixer does not split")
    return {"ranks": ranks, "wall_s": wall, "card": card, "phase": phase,
            "want_reduces": want_reduces}


def dp_config():
    """Phase 32's model: granite-moe-1b-a400m at full width, f32, its depth
    cut to DP_LAYERS, remat on, the load-balance coefficient raised from
    0.01 to 1 (its gradient then weighs on the router's)."""
    import dataclasses
    cfg = family_config("granite-moe-1b-a400m", "float32")
    return cfg.replace(n_layers=DP_LAYERS, remat=True,
                       moe=dataclasses.replace(cfg.moe, load_balance_coef=1.0))


def dp_rank_run(rank: int, port: int, device, phase: int = 32) -> dict:
    """Phase 32: a (1, 2, 1) mesh (the batch split over "data", no model
    split). The unsharded step's gradients on the whole batch in this
    process, then the mesh step's on this rank's rows, counting the
    all-reduces over the data axis (`spmd._all_reduce_over`: forward and
    backward); each leaf's worst error against its max."""
    import torch.distributed as dist
    mesh = init_ranks(rank, port, device, (1, TP_RANKS, 1))
    from torch.utils._pytree import tree_leaves
    from repro_torch.launch import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import spmd
    from repro_torch.train.step import build_lm_train_step
    try:
        cfg = dp_config()
        batch = tp_batches(30, cfg, device, n=1)[0]
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = T.init_lm(gen, cfg)
        got = {}

        def record(grads, state, p):
            got["grads"] = tree_leaves(grads)
            return p, state, {}
        _, _, m1 = build_lm_train_step(cfg, record)(params, None, batch)
        want = got.pop("grads")

        opt_init, _ = adamw(1e-3)
        dp, opt, _, _ = D.shard_model(cfg, mesh, params, opt_init(params))
        step, b_specs = D.make_sharded_step(cfg, mesh, record, None, None,
                                            batch)
        plain, calls = spmd._all_reduce_over, []

        def counted(x, groups):
            calls.append(len(groups))
            return plain(x, groups)
        spmd._all_reduce_over = counted
        try:
            sync_device(device)
            t0 = time.perf_counter()
            _, _, m = step(dp, opt, D.put_batch(mesh, b_specs, batch))
            sync_device(device)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            spmd._all_reduce_over = plain
        names = ["/".join(map(str, p)) for p in R.leaf_paths(params)]
        errs = {}
        for name, a, b in zip(names, got["grads"], want):
            a = a.full_tensor()
            errs[name] = float((a - b).abs().max()
                               / b.abs().max().clamp_min(1e-30))
        return {"loss": float(m["loss"]), "one_device_loss": float(m1["loss"]),
                "load_balance": float(m["load_balance"]),
                "one_device_load_balance": float(m1["load_balance"]),
                "batch_all_reduces": len(calls),
                "groups_per_all_reduce": sorted(set(calls)),
                "errs": errs, "ms": ms}
    finally:
        dist.destroy_process_group()


def dp_phase(device, card: str) -> dict:
    """Phase 32: two data ranks train step 1 of `dp_config` under remat;
    every gradient, the loss and the load balance against one device's,
    and the count of data-axis all-reduces."""
    t0 = time.perf_counter()
    cfg = dp_config()
    log(f"[32] the MoE load balance on a data-parallel mesh under remat: "
        f"granite-moe-1b-a400m at full width, {DP_LAYERS} of its 24 "
        f"layers, f32 (TF32 off), 'xla', load-balance coefficient 1; "
        f"{TP_RANKS} data ranks (processes on the one card, gloo), a (1, "
        f"{TP_RANKS}, 1) mesh; step 1 on {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"against one device's; card: {card}")
    ranks, wall = run_ranks(device, 32)
    want_reduces = 3 * cfg.n_layers     # forward, recompute, backward
    for res in ranks:
        r = res["rank"]
        rel_close(f"phase 32 rank {r} loss against one device's",
                  res["loss"], res["one_device_loss"], TP_REL)
        rel_close(f"phase 32 rank {r} load balance against one device's",
                  res["load_balance"], res["one_device_load_balance"],
                  DP_LB_REL)
        if res["batch_all_reduces"] != want_reduces \
                or res["groups_per_all_reduce"] != [1]:
            raise AssertionError(
                f"phase 32 rank {r}: {res['batch_all_reduces']} data-axis "
                f"all-reduces over {res['groups_per_all_reduce']} groups, "
                f"expected {want_reduces} over one")
        bad = {k: v for k, v in res["errs"].items() if not v <= DP_GRAD_TOL}
        if bad:
            raise AssertionError(f"phase 32 rank {r}: gradients beyond "
                                 f"{DP_GRAD_TOL} of their max: {bad}")
        if not any(k.endswith("ffn/router") for k in res["errs"]):
            raise AssertionError(f"phase 32 rank {r}: no router gradient")
        worst = max(res["errs"], key=res["errs"].get)
        router = max(v for k, v in res["errs"].items()
                     if k.endswith("ffn/router"))
        log(f"  rank {r}: loss {res['loss']:.6f} (one device "
            f"{res['one_device_loss']:.6f}), load balance "
            f"{res['load_balance']:.6f} (one device "
            f"{res['one_device_load_balance']:.6f}); {len(res['errs'])} "
            f"gradients within {res['errs'][worst]:.3g} of their max "
            f"(worst {worst}; the router's {router:.3g}; tol {DP_GRAD_TOL})"
            f"; {res['batch_all_reduces']} data-axis all-reduces (expected "
            f"{want_reduces}); the step {res['ms']:.3f} ms")
    log(f"  phase 32 took {time.perf_counter() - t0:.1f} s")
    return {"ranks": ranks, "wall_s": wall}


def log_tp_phase(tp: dict, base: dict):
    """A tensor-parallel phase's lines."""
    card, phase = tp["card"], tp["phase"]
    for res in tp["ranks"]:
        ms = res["ms"]
        step_ms = float(np.median(ms)) if ms else float("nan")
        prof = res["profile"] or {}
        busy = prof.get("busy_share")
        log(f"  rank {res['rank']}: loss "
            f"{' '.join(f'{x:.6f}' for x in res['losses'])}")
        log(f"    step ms {' '.join(f'{x:.3f}' for x in ms)}; median of "
            f"steps 2-{len(ms) + 1} {step_ms:.3f} (unsharded, one process: "
            f"{base['step_ms']:.3f}); peak memory "
            f"{max(res['peaks_gib'][1:]):.2f} GiB over the steps, "
            f"{res['peaks_gib'][0]:.2f} GiB in the set-up (unsharded: "
            f"{base['peak_gib']:.2f} GiB); card: {card}")
        log(f"    {res['all_reduces_per_step']:.0f} model-axis all-reduces "
            f"a step (expected {tp['want_reduces']}; "
            f"{res['all_reduce_mib_per_step']:.1f} MiB); a profiled "
            f"step {prof.get('step_ms', float('nan')):.3f} ms, device busy "
            f"share {busy if busy is None else round(busy, 4)}")
        for name, t, n in prof.get("top", [])[:5]:
            log(f"      {t:9.3f} ms  x{n:<5d} {name}")
        if res["experts"] is not None:
            log(f"    experts split as {res['experts']!r}: "
                f"{res['local_experts']} a rank; dropped_frac of a step "
                f"{res['dropped_frac']:.6f}")
        where = [f"{res['local_heads']} query / {res['local_kv_heads']} kv "
                 "heads"] if res["local_heads"] else []
        if res["local_lru"]:
            where.append(f"{res['local_lru']} RG-LRU channels")
        if res["local_ssm_heads"]:
            where.append(f"{res['local_ssm_heads']} SSM heads")
        launched = {k: n for k, n in res["pallas_launches"].items() if n}
        log(f"    'pallas' forward under no_grad on {', '.join(where)}: "
            f"launches {launched}, logits {tuple(res['logits_shape'])} "
            f"within {res['pallas_max_abs_err']:.3g} of 'xla' (tol "
            f"{LOGIT_TOL})")
    log(f"  phase {phase} took {tp['wall_s']:.1f} s")


# ------------------------------------------ tensor-parallel serving (35-37)

def serve_tp_config(arch: str):
    """Phases 35-37's f32 model at full width, prefilled through the
    kernels ("pallas"); at full depth but recurrentgemma-9b, one pattern
    block deep (phase 33's cut); granite-moe-1b's vocabulary padded to a
    multiple of TP_VOCAB_PAD, as phase 30's (two ranks split it)."""
    if arch == "recurrentgemma-9b":
        return rgemma_config("float32", n_layers=RGEMMA_TRAIN_LAYERS,
                             tail_pattern=(), attention_impl="pallas")
    kw = {"vocab_pad_to": TP_VOCAB_PAD} if arch.startswith("granite") else {}
    return family_config(arch, "float32", attention_impl="pallas", **kw)


def serve_tp_batch(cfg, device) -> dict:
    """SERVE_TP_ROWS prompts of SERVE_TP_PROMPT tokens (and seamless'
    SERVE_TP_FRAMES stub encoder frames a row), drawn from numpy's
    generator: the same in every process."""
    rng = np.random.default_rng(SEED + 35)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_TP_ROWS, SERVE_TP_PROMPT)).astype(
            np.int32)).to(device)}
    if cfg.is_encdec:
        out["enc_embeds"] = torch.from_numpy((rng.standard_normal(
            (SERVE_TP_ROWS, SERVE_TP_FRAMES, cfg.d_model)) * 0.5).astype(
                np.float32)).to(device)
    return out


def serve_tp_cache(cfg, device, cache_len=None):
    """An empty decode cache of SERVE_TP_SLOTS slots (or `cache_len`)."""
    from repro_torch.models import transformer as T
    return T.init_cache(cfg, SERVE_TP_ROWS, cache_len or SERVE_TP_SLOTS,
                        device=device,
                        enc_len=SERVE_TP_FRAMES if cfg.is_encdec else 0)


def serve_tp_file(arch: str) -> Path:
    return ROOT / "build" / "chip_smoke_tp" / f"serve_{arch}.pt"


def tree_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    from repro_torch.sharding import spmd
    return sum(spmd.local(t).numel() * spmd.local(t).element_size()
               for t in tree_leaves(tree))


def state_bytes(cache) -> int:
    """The bytes of a decode cache's recurrent states (RG-LRU, Mamba2
    layers: no "k"), which stay whole on every rank."""
    return tree_bytes([c for c in cache if "k" not in c])


def serve_tp_oracle(device, arch: str) -> dict:
    """Phases 35-37's oracle: the unsharded steps in this process on the
    card on the ranks' seeded weights and prompts: the prefill through
    flash and its logits, `prefill_into_cache` into SERVE_TP_SLOTS slots,
    SERVE_TP_STEPS[arch] greedy decode steps and their logits. The tokens and
    logits go to a file for the ranks, whose steps take the oracle's
    tokens (so every step's logits compare)."""
    from repro_torch.serve import step as ST
    cfg = serve_tp_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    params = make_model(cfg, device)
    n_params = numel(params)
    batch = serve_tp_batch(cfg, device)
    with torch.no_grad():
        logits, nat = ST.build_prefill(cfg, return_logits=True)(params,
                                                                batch)
        cache = ST.prefill_into_cache(
            cfg, nat, serve_tp_cache(cfg, device),
            torch.full((SERVE_TP_ROWS,), SERVE_TP_PROMPT, device=device))
        del nat
        decode = ST.build_decode(cfg, return_logits=True)
        rows, ms = [logits], []
        for i in range(SERVE_TP_STEPS[arch]):
            pos = torch.full((SERVE_TP_ROWS,), SERVE_TP_PROMPT + i,
                             dtype=torch.int32, device=device)
            tok = rows[-1].argmax(-1).to(torch.int32)[:, None]
            sync_device(device)
            t0 = time.perf_counter()
            lg, cache = decode(params, tok, pos, cache)
            sync_device(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(lg)
    every = torch.stack(rows).cpu()                     # (steps + 1, B, V)
    top2 = every.topk(2, dim=-1).values
    serve_tp_file(arch).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"tokens": every.argmax(-1).to(torch.int32),
                "logits": every}, serve_tp_file(arch))
    out = {"tokens": every.argmax(-1).tolist(),
           "gaps": (top2[..., 0] - top2[..., 1]).tolist(),
           "cache_bytes": tree_bytes(cache),
           "state_bytes": state_bytes(cache), "ms": ms,
           "step_ms": float(np.median(ms[1:])), "params": n_params}
    del params, cache, every, rows
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_want_reduces(cfg, device) -> dict:
    """The model-axis collectives of phases 35-37's calls on two ranks (L
    attention layers, Le encoder layers, Lr RG-LRU layers, Lm Mamba2
    layers; c = 1 with cross-attention): the prefill (2 + c) L + 2 Le +
    4 Lr + 3 Lm + 2 + g all-reduces (the row-parallel outputs, an RG-LRU
    layer's conv gather and state gather, a Mamba2 layer's norm and state
    gather, the embedding, the greedy token; g one for each leaf stored
    split and taken whole: recurrentgemma's wk and wv, each Mamba2
    layer's in_proj and conv_w, `tp.leaf_gather_all_reduces`) and, where
    the kv heads split, 2 (1 + c) L moving its caches from the rank's kv
    heads to head_dim: on the card all-reduces (gloo runs no all-to-all
    on CUDA tensors), on the CPU all-to-alls ("prefill_moves"); the
    handoff TP_RANKS (1 + c) L (a recurrent state is copied whole); a
    decode step (4 + 3 c) L + 4 Lr + 3 Lm + 2 + g."""
    from repro_torch.launch.shapes import params_shapes
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import tp as TP
    mesh = R.mesh_like((1, 1, TP_RANKS), ("pod", "data", "model"))
    tp = TP.TensorParallel.build(cfg, mesh)
    g = TP.leaf_gather_all_reduces(cfg, params_shapes(cfg), mesh, tp,
                                   backward=False)
    types = cfg.layer_types()
    L, c = types.count("attn"), int(cfg.is_encdec)
    Le = cfg.n_enc_layers if c else 0
    rec = 4 * types.count("rglru") + 3 * types.count("ssm")
    moves = 2 * (1 + c) * L if tp.kv else 0
    card = device.type == "cuda"
    return {"prefill": (2 + c) * L + 2 * Le + rec + 2 + g + moves * card,
            "prefill_moves": 0 if card else moves,
            "handoff": TP_RANKS * (1 + c) * L,
            "decode": (4 + 3 * c) * L + rec + 2 + g}


def serve_rank_run(rank: int, port: int, device, phases: tuple) -> dict:
    """Phases 35-37, one rank of a (1, 1, 2) mesh, for each arch of the
    `phases`: the seeded weights laid out by the rules, the tensor-parallel
    greedy prefill through the kernels (their launches and all-reduces
    counted), `prefill_into_cache_split` into the decode cache (the
    attention caches' sequence split, a recurrent state whole), then
    SERVE_TP_STEPS[arch] greedy steps on the oracle's tokens (timed,
    all-reduces counted), the logits of the prefill's last position, of
    every SERVE_TP_LOGITS_EVERY-th step and of the last from a second call
    on the same inputs and a copy of the cache (a recurrent state steps
    at every call) against the oracle's (gloo stages every all-reduce of
    a CUDA tensor through the host, so each call costs a few hundred ms),
    and a profiled step on rank 0."""
    import torch.distributed as dist
    from torch.utils._pytree import tree_map
    mesh = init_ranks(rank, port, device, (1, 1, TP_RANKS))
    from repro_torch.launch import distributed as D
    from repro_torch.serve import step as ST
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import spmd
    from repro_torch.sharding import tp as TP
    out = {}
    try:
        for arch in [a for ph in phases for a in SERVE_TP_ARCHS[ph]]:
            cfg = serve_tp_config(arch)
            oracle = torch.load(serve_tp_file(arch))
            tp = TP.TensorParallel.build(cfg, mesh)
            stamps = [time.perf_counter()]
            full = make_model(cfg, device)
            params = R.distribute(mesh, full, R.param_specs(cfg, full, mesh))
            del full
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            batch = serve_tp_batch(cfg, device)
            dbatch = D.put_batch(mesh, R.batch_specs(cfg, batch, mesh), batch)
            nat_like = serve_tp_cache(cfg, "meta", SERVE_TP_PROMPT)
            for c in nat_like:
                c.pop("cross_pos", None)
            out_p = (R.P(R.batch_axes(mesh)),
                     R.prefill_cache_specs(cfg, nat_like, mesh))
            local_p = TP.prefill_local_specs(out_p, tp)
            fns = counters()
            for fn in fns.values():
                fn.launches = 0
            sync_device(device)
            stamps.append(time.perf_counter())
            with torch.no_grad():
                r0, m0 = tp.all_reduces, tp.all_to_alls
                first, nat = spmd.call_split(ST.build_prefill(cfg, tp=tp),
                                             (params, dbatch), out_p, tp,
                                             local_p)
                sync_device(device)
                prefill_reduces = tp.all_reduces - r0
                prefill_moves = tp.all_to_alls - m0
                launches = {k: fns[k].launches for k in
                            ("flash_attention", "rglru_scan", "ssd_scan")}
                stamps.append(time.perf_counter())
                lg, _ = spmd.call_split(
                    ST.build_prefill(cfg, return_logits=True, tp=tp),
                    (params, dbatch), out_p, tp, local_p)
                errs = {0: float((spmd.local(lg).cpu()
                                  - oracle["logits"][0]).abs().max())}
                del lg, _
                stamps.append(time.perf_counter())
                cache_g = serve_tp_cache(cfg, device)
                c_specs = R.cache_specs(cfg, cache_g, mesh)
                cache = R.distribute(mesh, cache_g, c_specs)
                del cache_g
                r0 = tp.all_reduces
                ST.prefill_into_cache_split(
                    cfg, nat, cache, torch.full((SERVE_TP_ROWS,),
                                                SERVE_TP_PROMPT), tp)
                handoff_reduces = tp.all_reduces - r0
                sync_device(device)
                stamps.append(time.perf_counter())
                del nat
                split = TP.cache_split(c_specs)
                greedy = ST.build_decode(cfg, tp=tp, split=split)
                with_logits = ST.build_decode(cfg, return_logits=True, tp=tp,
                                              split=split)
                pspec = R.P(R.batch_specs(cfg, {"t": batch["tokens"]},
                                          mesh)["t"][0])
                tokens, ms, reduces = [spmd.local(first).tolist()], [], set()
                steps = SERVE_TP_STEPS[arch]
                for i in range(steps):
                    t_in, pos = (D.put_batch(mesh, {"x": spec}, {"x": x})["x"]
                                 for spec, x in (
                        (R.P(pspec[0], None),
                         oracle["tokens"][i][:, None].to(device)),
                        (pspec, torch.full((SERVE_TP_ROWS,),
                                           SERVE_TP_PROMPT + i,
                                           dtype=torch.int32))))
                    if not (i % SERVE_TP_LOGITS_EVERY and i != steps - 1):
                        lg, _ = spmd.call_split(
                            with_logits, (params, t_in, pos,
                                          tree_map(torch.clone, cache)),
                            (pspec, c_specs), tp)
                        errs[i + 1] = float((spmd.local(lg).cpu()
                                             - oracle["logits"][i + 1]
                                             ).abs().max())
                        del lg, _
                    args = (params, t_in, pos, cache)
                    r0 = tp.all_reduces
                    sync_device(device)
                    t0 = time.perf_counter()
                    tok, cache = spmd.call_split(greedy, args,
                                                 (pspec, c_specs), tp)
                    sync_device(device)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    reduces.add(tp.all_reduces - r0)
                    tokens.append(spmd.local(tok).tolist())

                def one_step():
                    spmd.call_split(greedy, (params, t_in, pos, cache),
                                    (pspec, c_specs), tp)
                # rank 0 profiles (two calls), rank 1 steps alongside
                stamps.append(time.perf_counter())
                prof = None
                if device.type == "cuda" and rank == 0:
                    prof = profile_steps(one_step, 1)
                else:
                    one_step()
                    one_step()
                stamps.append(time.perf_counter())
            attn = next((c for c in cache if "k" in c), {})
            out[arch] = {
                "seconds": dict(zip(("set-up", "prefill", "prefill logits",
                                     "handoff", "decode", "profile"),
                                    np.diff(stamps).tolist())),
                "tokens": tokens, "logit_errs": errs, "ms": ms,
                "step_ms": float(np.median(ms[1:])),
                "reduces": {"prefill": prefill_reduces,
                            "prefill_moves": prefill_moves,
                            "handoff": handoff_reduces,
                            "decode": sorted(reduces)},
                "launches": launches,
                "cache_bytes": tree_bytes(cache),
                "local_slots": [spmd.local(attn[k]).shape[1] for k in
                                ("k", "cross_k") if k in attn],
                "profile": None if prof is None else {
                    k: prof[k] for k in ("step_ms", "device_ms",
                                         "busy_share", "top")}}
            del params, cache, oracle
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        return {"archs": out}
    finally:
        dist.destroy_process_group()


def serve_tp_phases(device, card: str, phases=(35, 36, 37)) -> dict:
    """Phases 35-37: each arch's unsharded oracle in this process, then two
    model ranks (processes on the one card over gloo, (1, 1, 2)) serve
    every arch of the phases tensor parallel, in one pair of processes;
    the checks against the oracles, and the log lines."""
    t0 = time.perf_counter()
    phases = tuple(phases)
    bases = {}
    for phase in phases:
        archs = SERVE_TP_ARCHS[phase]
        log(f"[{phase}] tensor-parallel serving: {', '.join(archs)} at full "
            f"width and depth"
            + (" (recurrentgemma one pattern block: r, r, a)"
               if phase == 37 else "")
            + f", f32 (TF32 off), {TP_RANKS} model ranks "
            f"(processes on the one card, gloo), a (1, 1, {TP_RANKS}) mesh; "
            f"{SERVE_TP_ROWS} prompts of {SERVE_TP_PROMPT} tokens"
            + (f" (seamless over {SERVE_TP_FRAMES} frames)"
               if phase == 36 else "")
            + " prefilled through the kernels ('pallas') on each rank's "
            + ("heads, RG-LRU channels and SSM heads (each recurrent state "
               "gathered whole)" if phase == 37 else "heads")
            + f", handed into {SERVE_TP_SLOTS} decode slots split "
            f"{SERVE_TP_SLOTS // TP_RANKS}/{SERVE_TP_SLOTS // TP_RANKS} over "
            f"the ranks, {', '.join(str(SERVE_TP_STEPS[a]) for a in archs)} "
            f"greedy steps on the unsharded run's tokens, the logits of "
            f"the prefill, every {SERVE_TP_LOGITS_EVERY}th step and the "
            f"last; card: {card}")
        for arch in archs:
            bases[arch] = b = serve_tp_oracle(device, arch)
            log(f"  {arch} unsharded, one process: {b['params'] / 1e9:.3f} B "
                f"parameters; decode step {b['step_ms']:.3f} ms (median of "
                f"steps 2-{SERVE_TP_STEPS[arch]}); cache {b['cache_bytes']} "
                f"bytes")
    ranks, wall = run_ranks(device, phases)
    for phase in phases:
        for arch in SERVE_TP_ARCHS[phase]:
            cfg = serve_tp_config(arch)
            base = bases[arch]
            want = serve_want_reduces(cfg, device)
            for res in ranks:
                r, got = res["rank"], res["archs"][arch]
                serve_tp_check(phase, arch, r, cfg, got, base, want)
                busy = (got["profile"] or {}).get("busy_share")
                log(f"  [{phase}] {arch} rank {r}: tokens as the unsharded "
                    f"run's (the prefill's and {SERVE_TP_STEPS[arch]} "
                    f"steps'); logits of steps "
                    f"{sorted(got['logit_errs'], key=int)} (0: the "
                    f"prefill's last position) within "
                    f"{max(got['logit_errs'].values()):.3g} (tol "
                    f"{LOGIT_TOL}); all-reduces: prefill "
                    f"{got['reduces']['prefill']}, handoff "
                    f"{got['reduces']['handoff']}, a decode step "
                    f"{got['reduces']['decode']} (expected {want}); "
                    f"launches {got['launches']}; cache "
                    f"{got['cache_bytes']} bytes a rank (unsharded "
                    f"{base['cache_bytes']}, of it recurrent states "
                    f"{base['state_bytes']}), slots a rank "
                    f"{got['local_slots']}")
                log("    seconds: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in got["seconds"].items()))
                log(f"    decode step ms {' '.join(f'{x:.3f}' for x in got['ms'])}"
                    f"; median of steps 2-{SERVE_TP_STEPS[arch]} "
                    f"{got['step_ms']:.3f} (unsharded {base['step_ms']:.3f})"
                    + ("" if got["profile"] is None else
                       f"; a profiled step {got['profile']['step_ms']:.3f} ms,"
                       f" device busy share {round(busy, 4)}"))
                for name, t, n in (got["profile"] or {}).get("top", [])[:5]:
                    log(f"      {t:9.3f} ms  x{n:<5d} {name}")
            serve_tp_file(arch).unlink()
    log(f"  phases {', '.join(map(str, phases))} took "
        f"{time.perf_counter() - t0:.1f} s (ranks {wall:.1f} s); card: {card}")
    return {"ranks": ranks, "bases": bases, "wall_s": wall}


def serve_tp_check(phase, arch, rank, cfg, got, base, want):
    """A rank's tokens against the unsharded run's (a token may differ
    only at a step whose unsharded top-2 gap is below LOGIT_TOL), its
    logits within LOGIT_TOL, its all-reduces exactly, half the attention
    caches' bytes and the whole recurrent states (the reference's
    layout), and the prefill's launches: flash once a decoder attention
    layer, the RG-LRU scan once an RG-LRU layer, SSD once a Mamba2
    layer."""
    where = f"phase {phase} {arch} rank {rank}"
    if len(got["tokens"]) != len(base["tokens"]):
        raise AssertionError(f"{where}: {len(got['tokens'])} tokens a row")
    for i, (row, want_row) in enumerate(zip(got["tokens"], base["tokens"])):
        for b, (t, w) in enumerate(zip(row, want_row)):
            if t != w and not base["gaps"][i][b] < LOGIT_TOL:
                raise AssertionError(f"{where}: step {i} row {b} token {t}, "
                                     f"the unsharded run's {w} (top-2 gap "
                                     f"{base['gaps'][i][b]:.3g})")
    if not max(got["logit_errs"].values()) <= LOGIT_TOL:
        raise AssertionError(f"{where}: logits {got['logit_errs']} from the "
                             f"unsharded run's, beyond {LOGIT_TOL}")
    if got["reduces"] != dict(want, decode=[want["decode"]]):
        raise AssertionError(f"{where}: all-reduces {got['reduces']}, "
                             f"expected {want} (a decode step)")
    states = base["state_bytes"]
    if (got["cache_bytes"] - states) * TP_RANKS \
            != base["cache_bytes"] - states:
        raise AssertionError(f"{where}: {got['cache_bytes']} cache bytes a "
                             f"rank, unsharded {base['cache_bytes']} (of it "
                             f"recurrent states {states})")
    if got["launches"] != tp_want_launches(cfg):
        raise AssertionError(f"{where}: launches {got['launches']}, "
                             f"expected {tp_want_launches(cfg)}")


def family_tp_phases(device, card: str, phases) -> dict:
    """Tensor-parallel phases (29-31, 33-34), logged as they run: each
    model's unsharded baseline in this process, then its two
    tensor-parallel ranks. Returns {phase: tp_phase's result with its
    "base"}."""
    out = {}
    what = {
        29: f"qwen3-1.7b at full width and depth, phase 20's weights and "
            f"rate, {TP_FAMILY_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
            f"tokens",
        30: f"granite-moe-1b-a400m at full width and depth (vocabulary "
            f"padded to a multiple of {TP_VOCAB_PAD}), expert parallel, "
            f"{TP_FAMILY_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens",
        31: f"seamless-m4t-large-v2 at full width and depth, "
            f"{TP_FAMILY_STEPS} steps of {SEAMLESS_ROWS} rows of "
            f"{SEAMLESS_FRAMES} encoder frames + {SEAMLESS_TOKENS} tokens",
        33: f"recurrentgemma-9b at full width, one pattern block (r, r, "
            f"a), the RG-LRU channels split, "
            f"{TP_FAMILY_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens",
        34: f"mamba2-130m at full width and depth, the SSM heads split, "
            f"{TP_FAMILY_STEPS} steps of {TRAIN_BATCH} x {TP_MAMBA_SEQ} "
            f"tokens"}
    for phase in phases:
        t0 = time.perf_counter()
        log(f"[{phase}] tensor parallelism: {what[phase]}; f32 (TF32 off), "
            f"'xla', {TP_RANKS} model ranks (processes on the one card, "
            f"gloo), a (1, 1, {TP_RANKS}) mesh; losses within {TP_REL} "
            f"relative of the unsharded step's in one process; card: {card}")
        base = tp_baseline(device, phase)
        log(f"  unsharded, one process: {base['params'] / 1e9:.3f} B "
            f"parameters; loss {' '.join(f'{x:.6f}' for x in base['losses'])}"
            f"; step ms {' '.join(f'{x:.3f}' for x in base['ms'])}; peak "
            f"{base['peak_gib']:.2f} GiB; dropped_frac "
            f"{' '.join(f'{x:.6f}' for x in base['dropped_frac'])}")
        tp = tp_phase(device, card, base, phase)
        log_tp_phase(tp, base)
        log(f"  phase {phase} with its baseline took "
            f"{time.perf_counter() - t0:.1f} s")
        out[phase] = {**tp, "base": base}
    return out


def main(device: str = "cuda") -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs only "
              "on a GPU", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no {SRC / 'repro_torch'}; run it from the "
              "repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build.build()
    log(f"[1] build: {len(logs)} source(s) compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        entry = name
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = entry_name(found.group(1))
            elif "registers" in line or "spill" in line:
                log(f"  {entry}: {line.strip()}")

    log("[2] kernel against its plain version")
    errs = check_kernel(device)
    log("[7] flash-attention kernel against its plain version")
    flash_errs = check_flash(device)
    log("[8] RG-LRU scan kernel against its plain version")
    scan_errs = check_scan(device)
    log("[12] SSD scan kernel against its plain version")
    ssd_errs = check_ssd(device)
    log("[38] grouped MoE experts kernel against its plain version, and "
        "its timings")
    moe_t = moe_experts_phase(device)
    log("[39] Mamba2 decode state step kernel against its plain version, "
        "and its timings")
    mamba_t = mamba_state_phase(device)
    log(f"[40] serving granite-4.0-h-small at full width and depth, bf16, "
        f"paged, fused_tokens={FUSED_TOKENS}")
    hybrid = hybrid_phase(device)

    log("[3] serving qwen3-1.7b at full width, bf16")
    cfg = full_config("bfloat16")
    params = make_model(cfg, device)
    eng = make_engine(params, cfg, device, "cuda")
    warm = make_requests(cfg, n=4, new_tokens=4, seed=SEED + 1)
    for p, s, n in warm:               # first calls: cuBLAS set-up etc.
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    requests = make_requests(cfg)
    served = serve(eng, requests)
    log(f"  {served['requests']} requests, {served['decode_dispatches']} "
        f"decode dispatches, {served['launches']} kernel launches, "
        f"{served['prefill_launches']} paged flash launches (= "
        f"{cfg.n_layers} x bulk prefills), cache "
        f"hits {served['cache']['hits']}, CoW copies "
        f"{served['cache']['cow_copies']}, tokens reused "
        f"{served['cache']['tokens_reused']}")
    log(f"  decode step {served['decode_step_ms_mean']:.3f} ms mean "
        f"(p50 <= {served['decode_step_ms_p50']:.1f} ms, a histogram "
        f"bucket bound), "
        f"{served['decode_tokens_per_s']:.1f} decode tokens/s, prefill "
        f"{served['prefill_ms_mean']:.3f} ms mean, "
        f"{served['tokens_per_s']:.1f} tokens/s end to end over "
        f"{served['wall_s']:.3f} s")
    # NaN check outside the counted run: a second, short round (which also
    # reuses the first round's cached prefixes) with its logits recorded
    closures = eng._decode_tok, eng._prefill_tok
    finite_round(eng, requests[:8])
    eng._decode_tok, eng._prefill_tok = closures

    log("[6] where a greedy batch-8 decode step's time goes (bf16)")
    prof = profile_decode(eng, requests)
    log_profile(prof)
    log_share(prof, "paged_attention", "step")
    del eng
    torch.cuda.empty_cache()

    log(f"[15] fused decode, fused_tokens={FUSED_TOKENS}, one CUDA graph "
        "replay a dispatch (bf16, phase 3's weights and requests)")
    eng = make_variant(params, cfg, device, fused_tokens=FUSED_TOKENS)
    fused = serve_variant(eng, requests)
    log_variant(fused)
    per_dispatch = fused["step_ms_mean"]["fused"]
    log(f"  {per_dispatch:.3f} ms per fused dispatch, "
        f"{per_dispatch / FUSED_TOKENS:.3f} ms per decode position, beside "
        f"phase 3's single step {served['decode_step_ms_mean']:.3f} ms "
        f"({served['decode_step_ms_mean'] * FUSED_TOKENS / per_dispatch:.2f}"
        "x)")
    log("[15] where a greedy batch-8 fused dispatch's time goes (bf16)")
    prof_f = profile_fused(eng, requests)
    log_profile(prof_f, "dispatch")
    log_share(prof_f, "paged_attention", "dispatch")
    del eng

    log("[16] speculative decode, spec_tokens=4, drafter='ngram' (bf16, "
        "phase 3's weights and requests)")
    eng = make_variant(params, cfg, device, spec_tokens=4, drafter="ngram")
    spec = serve_variant(eng, requests)
    log_variant(spec)
    log_spec(spec["spec"], spec["cache"])
    del eng

    log("[17] chunked prefill, chunk_budget=64 (bf16, phase 3's weights and "
        "requests)")
    eng = make_variant(params, cfg, device, scheduler="chunked",
                       chunk_budget=CHUNK_BUDGET)
    chunked = serve_variant(eng, requests)
    log_variant(chunked)
    log(f"  {chunked['step_ms_mean']['mixed']:.3f} ms per mixed dispatch; "
        f"scheduler {chunked['scheduler']}")
    long_prompt = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, 256).tolist()
    stall = {"chunked": stall_gap(eng, requests, long_prompt)}
    del eng
    eng = make_engine(params, cfg, device, "cuda")
    stall["phased"] = stall_gap(eng, requests, long_prompt)
    for name, g in stall.items():
        log(f"  {name}: a 256-token prompt arrives among 7 decoding "
            f"requests: longest gap between two tokens of a decoding "
            f"request {g['max_gap_ms']:.3f} ms, {g['steps']} steps to its "
            f"first token ({g['first_token_ms']:.3f} ms)")
    log(f"  (phase 3's bulk prefill: {served['prefill_ms_mean']:.3f} ms mean "
        "per request)")
    del eng
    torch.cuda.empty_cache()

    t_gateway = time.perf_counter()
    log("[18] the synchronous gateway: 2 replicas x 8 slots, prefix-affinity "
        "(bf16, phase 3's weights and requests)")
    gw = make_gateway(params, cfg, device, policy="prefix-affinity")
    gw_sync = serve_gateway(gw, requests)
    log_gateway(gw_sync)
    shared = set(gw_sync["replica_ids"][:2])
    if len(shared) != 1 or \
            gw_sync["replicas"][shared.pop()]["cache"]["hits"] < 1:
        raise AssertionError(f"the prefix-sharing requests went to replicas "
                             f"{gw_sync['replica_ids'][:2]} "
                             f"({gw_sync['replicas']})")
    log(f"  placements {gw_sync['replica_ids']}")
    del gw
    log("[18] the launcher: python -m repro_torch.launch.serve --arch "
        "qwen3-1.7b --kv-layout paged --decode-kernel pallas --replicas 2 "
        "--requests 8 --workload synth")
    t0 = time.perf_counter()
    for line in run_launcher():
        log(f"  {line}")
    log(f"  exit 0 after {time.perf_counter() - t0:.1f} s")

    log(f"[19] async replica workers, fused_tokens={FUSED_TOKENS}, chaos "
        f"{CRASH_PLAN!r}, probation {PROBATION_S} s (bf16, phase 3's weights "
        "and requests, greedy)")
    gw = make_gateway(params, cfg, device, fused_tokens=FUSED_TOKENS,
                      async_workers=True, probation_seconds=PROBATION_S,
                      retry_backoff_s=RETRY_BACKOFF_S)
    seen = watch_fused(gw)
    warm_gateway(gw, cfg)
    # request 1 (replica 1's first, by round-robin) decodes LONG_TOKENS, so
    # replica 1 is still replaying its graph when replica 0 captures again
    async_requests = greedy(requests)
    async_requests[1] = (async_requests[1][0], None, LONG_TOKENS)
    gw_async = serve_gateway(gw, async_requests, chaos=CRASH_PLAN)
    log_gateway(gw_async)
    overlap = check_reintegration(gw, gw_async, seen, [1, 0])
    if gw_async["replica_ids"][1] != 1 or overlap < 1:
        raise AssertionError(f"replica 1 (long request on replica "
                             f"{gw_async['replica_ids'][1]}) ran {overlap} "
                             "fused dispatches while replica 0 captured "
                             "again")
    recapture = seen[0]["captures"][-1]
    log(f"  faults fired {gw_async['fired']}; replica 0 failures "
        f"{gw.replicas[0].failures}, reintegrations "
        f"{gw.replicas[0].reintegrations}; its capture after rejoining took "
        f"{(recapture[1] - recapture[0]) * 1e3:.1f} ms, during which "
        f"replica 1 ran {overlap} fused dispatch(es)")
    log(f"  phases 18-19 in bf16 took {time.perf_counter() - t_gateway:.1f} s")
    del gw, seen
    torch.cuda.empty_cache()

    log("[9] serving qwen3-1.7b on the dense layout, bf16, "
        "attention_impl='pallas' (bulk prefill through the flash kernel)")
    cfg_d = cfg.replace(attention_impl="pallas")
    eng = make_dense_engine(params, cfg_d, device, 8, 512)
    for p, s, n in warm:
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    dense_q = serve_dense(eng, requests, {"flash_attention": cfg.n_layers})
    log_served(dense_q)
    finite_round(eng, requests[:8])
    log("[9] where a greedy batch-8 dense decode step's time goes (bf16)")
    log_profile(profile_decode(eng, requests))
    del eng, params
    torch.cuda.empty_cache()

    log("[4] kernel against the dense-gather oracle at full width, f32")
    cfg32 = full_config("float32")
    params32 = make_model(cfg32, device)
    oracle = compare_to_oracle(params32, cfg32, device,
                               make_requests(cfg32, n=8, new_tokens=16))
    log(f"  {oracle['steps']} lockstep steps, max |logit diff| "
        f"{oracle['max_abs_logit_diff']:.3g} (last step "
        f"{oracle['last_step_max_abs_logit_diff']:.3g}, tol {LOGIT_TOL}), "
        f"greedy divergences {oracle['diverged_requests']}, outputs "
        f"identical: {oracle['identical_outputs']}")

    f32_requests = make_requests(cfg32, n=8, new_tokens=16)
    log(f"[15] f32 (TF32 off, phase 4's model): fused_tokens={FUSED_TOKENS} "
        "tokens against phase 4's single-step 'cuda' run")
    eng = make_variant(params32, cfg32, device, warm=False,
                       fused_tokens=FUSED_TOKENS)
    fused32 = serve_variant(eng, greedy(f32_requests))
    log_variant(fused32)
    fused_match = match_tokens(fused32["outputs"], oracle["outs"],
                               oracle["rec"])
    log(f"  tokens: {fused_match}")
    del eng
    log("[17] f32 (TF32 off, phase 4's model): chunked, chunk_budget=64, "
        "against phase 4's single-step 'cuda' run")
    eng = make_variant(params32, cfg32, device, warm=False,
                       scheduler="chunked", chunk_budget=CHUNK_BUDGET)
    chunked32 = serve_variant(eng, greedy(f32_requests))
    log_variant(chunked32)
    chunk_match = match_tokens(chunked32["outputs"], oracle["outs"],
                               oracle["rec"])
    log(f"  tokens: {chunk_match}")
    del eng
    cut32 = cfg32.replace(n_layers=SPEC_F32_LAYERS)
    log(f"[16] f32 (TF32 off), depth cut to {cut32.n_layers} layers: "
        "spec_tokens=4 with a ModelDrafter on the target's own weights, "
        "against the single-step 'cuda' run")
    p_cut = make_model(cut32, device)
    spec_requests = greedy(f32_requests[:4])
    ref = single_step_reference(p_cut, cut32, device, spec_requests)
    from repro_torch.serve.draft import ModelDrafter
    eng = make_variant(p_cut, cut32, device, warm=False, spec_tokens=4,
                       drafter=ModelDrafter(p_cut, cut32, cache_len=512))
    spec32 = serve_variant(eng, spec_requests)
    log_variant(spec32)
    log_spec(spec32["spec"], spec32["cache"])
    spec_match = match_tokens(spec32["outputs"], ref["outs"], ref["rec"])
    log(f"  tokens: {spec_match}")
    if spec32["spec"]["acceptance_rate"] < 0.9:
        raise AssertionError(f"self-drafting acceptance "
                             f"{spec32['spec']['acceptance_rate']} < 0.9")
    del eng, p_cut, ref

    t_gateway = time.perf_counter()
    gw_requests = greedy(make_requests(cfg32, n=8, new_tokens=32))
    log("[18] f32 (TF32 off, phase 4's model): the synchronous gateway's "
        "tokens against a lone single-step engine's")
    lone = single_step_reference(params32, cfg32, device, gw_requests)
    gw = make_gateway(params32, cfg32, device, policy="prefix-affinity")
    recs = [record_logits(r.engine) for r in gw.replicas]
    gw_sync32 = serve_gateway(gw, gw_requests)
    log_gateway(gw_sync32)
    gw_sync_match = match_tokens(gw_sync32["outputs"], lone["outs"],
                                 lone["rec"])
    log(f"  tokens: {gw_sync_match}")
    del gw, lone
    log(f"[19] f32: async workers, fused_tokens={FUSED_TOKENS}, chaos "
        f"{CRASH_PLAN!r}: tokens against phase 18's synchronous run")
    gw = make_gateway(params32, cfg32, device, fused_tokens=FUSED_TOKENS,
                      async_workers=True, probation_seconds=PROBATION_S,
                      retry_backoff_s=RETRY_BACKOFF_S)
    seen = watch_fused(gw)
    gw_async32 = serve_gateway(gw, gw_requests, chaos=CRASH_PLAN)
    log_gateway(gw_async32)
    check_reintegration(gw, gw_async32, seen, [2, 1])
    gw_async_match = match_tokens(gw_async32["outputs"], gw_sync32["outputs"],
                                  recs[0] + recs[1])
    log(f"  tokens: {gw_async_match}")
    log(f"  phases 18-19 in f32 took {time.perf_counter() - t_gateway:.1f} s")
    del gw, seen, recs
    torch.cuda.empty_cache()

    log("[9] dense qwen3-1.7b at full width, f32: 'pallas' against 'xla'")
    dense_q32 = lockstep(
        [make_dense_engine(params32, cfg32.replace(attention_impl=impl),
                           device, 8, 512) for impl in ("pallas", "xla")],
        make_requests(cfg32, n=8, new_tokens=16))
    log_lockstep(dense_q32)
    del params32
    torch.cuda.empty_cache()

    log("[5] timings at the main path's shape (bf16, B=8, 16/8 heads, "
        "hd 128, 16-token pages, 512-token chains)")
    timing = time_kernel(device)
    log_timing("paged_attention", timing, PREVIOUS_MS["paged_attention"],
               "SDPA on the dense view")
    log(f"  plain version {timing['plain_ms']:.4f} ms, bound "
        f"{timing['bound_ms']:.4f} ms by {timing['bound_by']} "
        f"({timing['bytes']} bytes, {timing['flops']} flops)")
    log(f"  split plan {timing['plan'][0]} splits of {timing['plan'][1]} "
        "pages")

    log("[10] serving recurrentgemma-9b at full width on the dense layout, "
        "bf16, attention_impl='pallas'")
    cfg_r = rgemma_config("bfloat16", attention_impl="pallas")
    t0 = time.perf_counter()
    params = make_model(cfg_r, device)
    n_params = numel(params)
    log(f"  {n_params / 1e9:.3f} B parameters made in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    eng = make_dense_engine(params, cfg_r, device, 4, 2048)
    for p, s, n in rgemma_requests(cfg_r, new_tokens=2, seed=SEED + 1)[:4]:
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    r_requests = rgemma_requests(cfg_r)
    n_attn = cfg_r.layer_types().count("attn")
    dense_r = serve_dense(eng, r_requests, {
        "rglru_scan": cfg_r.n_layers - n_attn, "flash_attention": n_attn})
    log_served(dense_r)
    finite_round(eng, r_requests[-2:])
    log("[10] where a greedy batch-4 decode step's time goes (bf16)")
    log_profile(profile_decode(eng, r_requests))
    log(f"[10] where a greedy bulk prefill of {len(r_requests[-1][0])} "
        "tokens goes (bf16)")
    prof = profile_prefill(eng, r_requests[-1][0])
    log_profile(prof, "prefill")
    log_share(prof, "flash_attention", "prefill")
    log_share(prof, "rglru_scan", "prefill")
    del eng, params
    torch.cuda.empty_cache()

    cut = rgemma_config("float32", n_layers=5)
    log(f"[10] recurrentgemma-9b at full width, f32, depth cut to "
        f"{cut.n_layers} layers {cut.layer_types()}: 'pallas' against "
        "'xla'")
    params32 = make_model(cut, device)
    r32 = [(p, None, 8) for p, _, _ in rgemma_requests(cut)[-3:]]
    dense_r32 = lockstep(
        [make_dense_engine(params32, cut.replace(attention_impl=impl),
                           device, 4, 2048) for impl in ("pallas", "xla")],
        r32)
    log_lockstep(dense_r32)
    del params32
    torch.cuda.empty_cache()

    log("[11] timings of the new kernels at their main-path shapes (bf16 "
        "flash, f32 scan)")
    flash_t = {}
    for case in FLASH_CASES[-2:]:
        t = flash_t[case] = time_flash(device, case)
        log_timing(f"flash B,S,nh,nkv,hd,window={case}", t, PREVIOUS_MS[case],
                   "SDPA")
        log(f"  plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']} ({t['flops']} flops over {t['pairs']} "
            f"visible pairs at {BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s, "
            f"{t['bytes']} bytes)")
    paged_flash_t = {}
    for case in PAGED_FLASH_CASES:
        t = paged_flash_t[case] = time_flash_paged(device, case)
        log(f"  paged flash S,start,n_tok,nh,nkv,hd,bs,nb={case} (port "
            f"only, no TPU counterpart): kernel {t['ms']:.4f} ms per call "
            f"from Python, {t['card_ms']:.4f} ms on the card alone; plain "
            f"gather {t['plain_ms']:.4f} ms ({t['plain_ms'] / t['card_ms']:.1f}"
            f"x the card time); bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']} ({t['flops']} flops, {t['bytes']} bytes), card "
            f"/ bound {t['card_ms'] / t['bound_ms']:.2f}; widest row "
            f"error {t['err']:.3g} (limit {PAGED_FLASH_REL_TOL}; planted "
            f"faults: page misread {t['page']:.3g}, mask one late "
            f"{t['mask']:.3g})")
    scan_t = time_scan(device)
    log_scan_timing(f"rglru_scan B,S,C={SCAN_CASES[-1]}", scan_t,
                    PREVIOUS_SCAN_MS["rglru_scan"])
    flash_main = flash_t[FLASH_CASES[-1]]

    log("[13] serving mamba2-130m at full width on the dense layout, bf16, "
        "attention_impl='pallas'")
    cfg_m = mamba_config("bfloat16", attention_impl="pallas")
    params = make_model(cfg_m, device)
    log(f"  {numel(params) / 1e6:.1f} M parameters (padded vocab "
        f"{cfg_m.padded_vocab_size}; {cfg_m.param_count() / 1e6:.1f} M as "
        "the config counts them)")
    eng = make_dense_engine(params, cfg_m, device, 8, 4096)
    for p, s, n in mamba_requests(cfg_m, new_tokens=2, seed=SEED + 1)[:4]:
        eng.submit(p, max_new_tokens=n, sampling=s)
    eng.run()
    eng.reset()
    eng.step_times.clear()
    m_requests = mamba_requests(cfg_m)
    dense_m = serve_dense(eng, m_requests, {"ssd_scan": cfg_m.n_layers})
    log_served(dense_m)
    if dense_m["route_launches"]["ssd_scan"]["simt"]:
        raise AssertionError("a bf16 SSD call of the served prefills left the "
                             f"tensor-core route: "
                             f"{dense_m['route_launches']['ssd_scan']}")
    finite_round(eng, m_requests[-2:])
    log("[13] where a greedy batch-8 decode step's time goes (bf16)")
    log_profile(profile_decode(eng, m_requests))
    log(f"[13] where a greedy bulk prefill of {len(m_requests[-1][0])} "
        "tokens goes (bf16)")
    prof = profile_prefill(eng, m_requests[-1][0])
    log_profile(prof, "prefill")
    log_share(prof, "ssd_scan", "prefill")
    del eng, params
    torch.cuda.empty_cache()

    cfg_m32 = mamba_config("float32")
    log("[13] mamba2-130m at full width and depth, f32: 'pallas' against "
        "'xla'")
    params32 = make_model(cfg_m32, device)
    picked = mamba_requests(cfg_m32)
    m32 = [(p, None, 8) for p, _, _ in picked[:3] + picked[-1:]]
    dense_m32 = lockstep(
        [make_dense_engine(params32, cfg_m32.replace(attention_impl=impl),
                           device, 8, 4096) for impl in ("pallas", "xla")],
        m32)
    log_lockstep(dense_m32)
    del params32
    torch.cuda.empty_cache()

    log("[14] SSD kernel timings at mamba2-130m's 2,048-token prefill")
    ssd_t = time_ssd(device)
    log_scan_timing(f"ssd_scan b,s,h,p,g,n,chunk={SSD_CASES[-1]}", ssd_t,
                    PREVIOUS_SCAN_MS["ssd_scan"])
    log(f"  ({ssd_t['flops']} flops at {BF16_TENSOR_FLOPS / 1e12:.0f} "
        f"TFLOP/s; the {ssd_t['route']} route)")

    tr = train_phases(device, card)
    pop = sweep_phase(device, card)
    fam = family_phases(device, card)
    distribution_phase(device, card, tr, pop)
    tps = family_tp_phases(device, card, (29, 30, 31))
    dp_phase(device, card)
    tps.update(family_tp_phases(device, card, (33, 34)))
    served_tp = serve_tp_phases(device, card)
    g1, g3 = fam["granite"], fam["granite3b"]
    fam_flash = {"granite_dense": g1["dense"]["launches"]["flash_attention"],
                 "seamless": fam["encdec"]["run"]["launches"][
                     "flash_attention"],
                 "pixtral": fam["prefix"]["run"]["launches"][
                     "flash_attention"]}
    # each tensor-parallel phase's "pallas" forward: rank 0's launches
    tp_launches = {name: tps[ph]["ranks"][0]["pallas_launches"]
                   for ph, name in ((29, "qwen3"), (30, "granite_1b"),
                                    (31, "seamless"),
                                    (33, "recurrentgemma"), (34, "mamba2"))}
    fam_flash.update({f"tp_{name}": n["flash_attention"]
                      for name, n in tp_launches.items()
                      if n["flash_attention"]})
    # each tensor-parallel serving prefill: rank 0's launches, by kernel
    served_paths = {k: {SERVE_TP_PATHS[arch]: n["launches"][k]
                        for arch, n in served_tp["ranks"][0]["archs"].items()
                        if n["launches"][k]}
                    for k in ("flash_attention", "rglru_scan", "ssd_scan")}
    fam_flash.update(served_paths["flash_attention"])
    rglru_paths = {"recurrentgemma": dense_r["launches"]["rglru_scan"],
                   "tp_recurrentgemma":
                       tp_launches["recurrentgemma"]["rglru_scan"],
                   **served_paths["rglru_scan"]}
    ssd_paths = {"mamba2": dense_m["launches"]["ssd_scan"],
                 "tp_mamba2": tp_launches["mamba2"]["ssd_scan"],
                 **served_paths["ssd_scan"]}

    # the grouped MoE experts kernel: n_layers x the decode steps of each
    # MoE path (checked where each ran; every other path launched none)
    moe_paths = {"granite_1b": g1["served"]["moe_launches"],
                 "granite_1b_fused": g1["fused"]["moe_launches"],
                 "granite_1b_dense": g1["dense"]["moe_launches"],
                 "granite_1b_f32": g1["oracle"]["moe_launches"][0],
                 "granite_3b": g3["served"]["moe_launches"],
                 "granite_3b_fused": g3["fused"]["moe_launches"]}

    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:43",
        "launches": served["launches"],
        "max_abs_err": errs[torch.bfloat16],
        "launches_by_path": {"single": served["launches"],
                             "fused": fused["launches"],
                             "speculative": spec["launches"],
                             "chunked": chunked["launches"],
                             "gateway": gw_sync["launches"],
                             "gateway_async": gw_async["launches"],
                             "granite_1b": g1["served"]["launches"],
                             "granite_1b_fused": g1["fused"]["launches"],
                             "granite_3b": g3["served"]["launches"],
                             "granite_3b_fused": g3["fused"]["launches"]},
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "card_ms": timing["card_ms"],
        "library_card_ms": timing["library_card_ms"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": (dense_q["launches"]["flash_attention"]
                     + dense_r["launches"]["flash_attention"]
                     + sum(fam_flash.values())),
        "launches_by_path": {
            "qwen3_dense": dense_q["launches"]["flash_attention"],
            "recurrentgemma": dense_r["launches"]["flash_attention"],
            **fam_flash},
        "max_abs_err": flash_errs[torch.bfloat16],
        "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        "card_ms": flash_main["card_ms"],
        "library_card_ms": flash_main["library_card_ms"],
    }, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:25",
        "launches": sum(rglru_paths.values()),
        "launches_by_path": rglru_paths,
        "max_abs_err": scan_errs[torch.bfloat16],
        "ms": scan_t["ms"], "plain_ms": scan_t["plain_ms"],
        "bound_ms": scan_t["bound_ms"], "bound_by": scan_t["bound_by"],
        "library_ms": None, "card_ms": scan_t["card_ms"],
        "library_card_ms": None,
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:24",
        "launches": sum(ssd_paths.values()),
        "launches_by_path": ssd_paths,
        "route_launches": dense_m["route_launches"]["ssd_scan"],
        "max_abs_err": ssd_errs[torch.bfloat16],
        "ms": ssd_t["ms"], "plain_ms": ssd_t["plain_ms"],
        "bound_ms": ssd_t["bound_ms"], "bound_by": ssd_t["bound_by"],
        "library_ms": None, "card_ms": ssd_t["card_ms"],
        "library_card_ms": None,
    }, {
        "name": "moe_experts", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_experts.cu",
        "replaces": None, "launches": sum(moe_paths.values()),
        "launches_by_path": moe_paths,
        "max_rel_err": {dt: max(t["err"] for t in moe_t if t["dtype"] == dt)
                        for dt in ("bfloat16", "float32")},
        "by_shape": moe_t,
    }, {
        "name": "mamba_state", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_state.cu",
        "replaces": None, "launches": hybrid["mamba_launches"],
        "launches_by_path": {
            "granite_4_0_h_small_fused": hybrid["mamba_launches"]},
        "by_shape": mamba_t,
    }]
    log(f"kernels: paged_attention launches={served['launches']} "
        f"(decode dispatches {served['decode_dispatches']} x "
        f"{cfg.n_layers} layers); f32 max abs err "
        f"{errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g}; on "
        f"the fused path {fused['launches']} ({fused['replays']} replays, "
        f"{fused['warmups']} warm-up runs of {FUSED_TOKENS} steps, "
        f"{fused['dispatches'].get('decode', 0)} single dispatches), the "
        f"speculative {spec['launches']} "
        f"({spec['dispatches'].get('decode', 0)} single dispatches; the "
        f"verify has none), the chunked {chunked['launches']} "
        f"({chunked['dispatches'].get('mixed', 0)} mixed + "
        f"{chunked['dispatches'].get('decode', 0)} single dispatches); "
        f"through the gateway {gw_sync['launches']} (2 replicas, single "
        f"steps), with async workers {gw_async['launches']} (fused, a crash)"
        f"; granite-moe-1b {g1['served']['launches']} (single), "
        f"{g1['fused']['launches']} (fused), granite-moe-3b "
        f"{g3['served']['launches']} (single), {g3['fused']['launches']} "
        "(fused)")
    log(f"kernels: flash_attention launches="
        f"{kernels[1]['launches']} (qwen3 {dense_q['prefills']} prefills x "
        f"{cfg.n_layers} layers + recurrentgemma {dense_r['prefills']} "
        f"prefills x {n_attn} layers + {fam_flash}); f32 max abs err "
        f"{flash_errs[torch.float32]:.3g}, bf16 "
        f"{flash_errs[torch.bfloat16]:.3g}")
    long_t, suffix_t, granite_t = (paged_flash_t[c]
                                   for c in PAGED_FLASH_CASES)
    log(f"kernels: flash_attention_paged (port only, the paged bulk "
        f"prefill's read) launches={served['prefill_launches']} (phase 3's "
        f"bulk prefills x {cfg.n_layers} layers), through the gateway "
        f"{gw_sync['prefill_launches']} and "
        f"{gw_async['prefill_launches']}; on the card {long_t['card_ms']:.4f}"
        f" ms at 2,048 tokens from 0 (plain {long_t['plain_ms']:.4f}), "
        f"{suffix_t['card_ms']:.4f} ms at 64 on 4,000 (plain "
        f"{suffix_t['plain_ms']:.4f}), {granite_t['card_ms']:.4f} ms at "
        f"granite's 512 from 0 (plain {granite_t['plain_ms']:.4f})")
    log(f"kernels: rglru_scan launches={kernels[2]['launches']} "
        f"({dense_r['prefills']} prefills x {cfg_r.n_layers - n_attn} "
        f"layers + on tensor-parallel rank 0's channels {rglru_paths}); "
        f"f32 max abs err {scan_errs[torch.float32]:.3g}, bf16 "
        f"{scan_errs[torch.bfloat16]:.3g}")
    log(f"kernels: ssd_scan launches={kernels[3]['launches']} "
        f"({dense_m['prefills']} prefills x {cfg_m.n_layers} layers, by "
        f"route {kernels[3]['route_launches']}; + on tensor-parallel rank "
        f"0's heads {ssd_paths}); f32 "
        f"max abs err {ssd_errs[torch.float32]:.3g}, bf16 "
        f"{ssd_errs[torch.bfloat16]:.3g}")
    log(f"kernels: moe_experts launches={kernels[4]['launches']} (by path "
        f"{moe_paths}; the layers x the decode steps of each); widest row "
        f"rel err {kernels[4]['max_rel_err']}")
    log(f"kernels: mamba_state (port only, the paged decode's state step) "
        f"launches={hybrid['mamba_launches']} (granite-4.0-h-small fused, "
        f"its Mamba2 layers x the decode steps; 0 on every other path); "
        + "; ".join(f"{t['name']}: {t['card_ms']:.4f} ms on the card, "
                    f"bound {t['bound_ms']:.4f}, plain {t['plain_ms']:.4f}"
                    for t in mamba_t))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
