#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives only the port (``src/repro_torch``), on ``cuda:0``, in phases; any
failure propagates, so the script exits non-zero and prints no result.

  1. Environment: torch / CUDA versions and the card's name and power
     limit (``nvidia-smi``).
  2. Build: compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, in parallel) and loads them.
  3. Kernels against their plain PyTorch versions on the card, at the
     slice's shapes — the logreg leaf (32, 784), the MLP's leaves — and at
     one large shape, (32, 2^20), where the memory bound shows: int8, int4
     and int2 codes exactly equal, both from y as the slice passes it (the
     kernel's 16-byte vector instantiation) and from a copy of y at an odd
     offset (its scalar instantiation, timed beside the vector one as
     ``quantize_kernel odd view``), the fused update bit-equal in float32
     and to 1e-2 in bfloat16, dequant_mean to 1e-6. Each kernel is timed from a
     cold L2 (256 MB read before each launch, CUDA events around the
     launch alone; the median over 25 samples of 10) beside its bound
     (bytes it must move over the 3.35 TB/s of HBM, or its float32
     operations over 67 TFLOP/s, whichever is larger), the plain version's
     time and, for the fused update, the time of the one PyTorch call that
     computes the same function (``torch._fused_sgd_``, the op behind
     ``torch.optim.SGD(fused=True)``), held to the plain version first,
     all timed the same way; beside them, each kernel's time for one call
     as the caller sees it (events around the call) and its wrapper's
     host time a call (the host clock around 100 calls in a row, with no
     synchronisation between them). Then the update of each whole tree the slice
     steps — the logreg tree (one leaf) and the MLP tree (8 leaves, 3.0 M
     floats) — through ``tree_sgd_update_``, as the local step calls it:
     one launch, bit-equal to the plain version, timed beside its bound
     (20 B per element over 3.35 TB/s), the per-leaf launches it
     replaces, ``torch._fused_sgd_`` over the same leaf lists and the
     launch floor (a kernel that returns at once, ``torch.cuda._sleep(0)``),
     which every training kernel's row logs.
  4. The slice: the port against itself on a small input (the card's run
     against the CPU run on the same draws), then ``stl_sc`` + int8 at
     the full width of the paper's Table 1 convex model (logreg, d=784,
     n=11,791, N=32, B=32, η₁=0.5, T₁=512, k₁=16, IID) and on the MLP
     (width 96, depth 3, 8 leaves) over the streaming topology, each cut
     to 3 of its 11 stages (96 rounds, 3,584 local steps). The objective
     must be finite and fall below 0.9× its start, the comm ledger must
     equal the integer formula, and every kernel's launch count (reset to
     0 just before each run) must match the path: one fused update per
     local step, one quantize and one dequant_mean per leaf per round.
     A profile of 4 rounds of each model gives ms per local step, kernels
     per step, the device's busy share and each training kernel's device
     time per launch inside the step (L2 as the step leaves it).
  5. Flash attention against its plain version on the card at gemma2-27b's
     layer shapes, q (1, 4608, 32, 128) and k/v (1, 4608, 16, 128) in
     bfloat16 — local (window 4096, softcap 50), global (causal, softcap
     50), causal without softcap — qwen3-14b's causal layer (1, 4608,
     40/8, 128), a D = 256 causal shape (1, 4096, 16/8, 256), a ragged
     Sq = Sk = 1000 shape and a small float32 shape; with a softcap q is
     scaled by cap / 4, so that the scores reach about +-cap, and the
     cap-free attention must fail the tolerance (a control). bf16 is held to
     ``ref.py``'s tolerance (elementwise 5e-3 absolute plus 1e-2 relative,
     and each query row of each head to 1e-2 of its norm), float32 to 1e-5
     absolute plus as much relative; timed like phase 3, bound by its
     operations (4·B·H·D·pairs over 989 TFLOP/s bf16, 67 TFLOP/s float32)
     or bytes, printed with TFLOP/s, the share of the bound and the
     special-function (MUFU) floor, and at the causal shapes beside
     ``scaled_dot_product_attention`` (held to the plain version first;
     the port never calls it).
  6. Serving, small: the card's run of gemma2-27b's SMOKE config (2 layers
     L+G, window 64, float32) against the CPU run on the same weights, one
     80-token prompt through ``prefill`` and 8 decode steps, logits to
     1e-4.
  7. Serving at full width: gemma2-27b FULL (d_model 4608, vocab 256000,
     bfloat16, random weights from seed 0), its depth cut to 12 of 46
     layers (24 since phase 19 joined the script, 12 since phase 22 did:
     the run's time), behind
     ``ServeEngine`` with 4 slots of 6,144 tokens, 6 Poisson requests plus
     one 4,608-token prompt (the window bites in prefill, the local ring
     wraps in decode). Every request must complete, flash attention must
     launch 24 times per prefill, and the tokens must match the port's
     ``greedy_decode`` (first token exactly; later ones up to the first
     near-tie). Prints wall, tok/s, prefill and decode-step times, peak
     memory and a profile of one prefill and 4 decode steps.
  8. The SSD kernel against its plain version on the card (the plain
     chunked version first held to the sequential recurrence): mamba2-2.7b's
     layer at a 4,096-token prefill, (1, 4096, 80, 64) with N = 128 and
     chunk 256, its 4,000-token prompt (a 160-row last chunk), the Pallas
     test's grouped (2, 256, 4, 64) G = 2 shapes at chunk 64 and 128, all
     float32 within 3e-4 (absolute plus relative, y and the final state),
     and the layer with bf16 inputs within 5e-2 (the JAX package's
     tolerances); then the layer and a two-chunk shape from a non-zero
     initial state, held to the sequential recurrence from that state
     (``ssd_ref(initial_state=...)``) within 3e-4. Timed like phase 3,
     bound by the kernel's tensor-core scheme: its operations (the lower
     triangle's multiply-adds, each float32 product done as three bf16
     products, so three times the work over 989 TFLOP/s) or its bytes,
     whichever is larger; the float32
     CUDA-core figure (the same work over 67 TFLOP/s) is logged beside it.
     The layer call's kernels (its two passes and the zeroing of its sync
     flags) are profiled one by one, before any other profile of the run
     (see ``ssd_layer_kernels_ms``). No single PyTorch call computes the
     scan, so it has no library time.
  9. Serving, small: mamba2-2.7b's SMOKE config (2 layers, chunk 64,
     float32) on the card against the CPU, one 100-token prompt (a short
     last chunk) through ``prefill`` and 8 decode steps, logits to 1e-4.
 10. Serving at full width: mamba2-2.7b FULL (d_model 2560, 80 SSD
     heads, vocab 50280, bfloat16, random weights from seed 0), its depth
     cut to 16 of 64 layers (32 since phase 19 joined the script, 16
     since phase 22 did), behind
     ``ServeEngine`` with 8 slots of 6,144 tokens, 12 Poisson requests,
     one 4,000-token prompt with 24 outputs and a one-token prompt that
     lands in a used slot after the drain. Every request must
     complete, the SSD kernel must launch 16 times per multi-token
     prefill, and the tokens must match ``greedy_decode`` as in phase 7.
     Timed and profiled as phase 7.
 11. The adaptive period (``algo="adaptive"``): first the card's run
     against the CPU run on one small input and the same draws: logreg
     dense (the same round lengths in every stage, each step's replica
     divergence within 1e-5 relative, the history within 1e-5) and int8
     (the same round lengths, the history within 1e-4); the int8 MLP on
     three seeds, every block the card encoded bit-equal to the plain
     version on the card's own inputs, with the first round whose codes
     differ between the runs, how many differ and the history gap before
     and after it logged. Then Table 4's configuration at its full scale
     (logreg d=123, n=16,384, N=32, B=32, stl_sc's schedule with T1=512,
     k1=2 as the cap, η1=0.5, threshold 3e-4, int8 over Star), cut to 2 of
     its 6 stages (3 before phase 19 joined the script). The objective
     must fall below 0.9x its start, every
     round length must be within its stage's cap, and the launches must be
     one fused update per local step and one quantize and one dequant_mean
     per leaf per *triggered* round (counted from the rounds the backend
     ran).
 12. The event runtime, synchronous: Table 5's configuration at its full
     scale (logreg d=123, n=16,384, N=8, B=32, η1=0.5, stl_sc T1=256,
     k1=2, int8, 25% stragglers at 4x, 1 ms a local step, dropout 0.1),
     cut to 2 of its 6 stages (3 before phase 19), on
     ``runtime.EventBackend`` as
     ``runtime.run`` wires it: in the run's first masked round every
     dropped client's rows are, at the reduce, exactly as they were before
     the round, and the present clients' rows moved; launches as in
     phase 4; the modeled wall clock finite and larger than the same run's
     without stragglers (``runtime.run``; the history must be the same).
     Then Table 5's streaming axis at full size (the MLP, d=96, width 96,
     depth 3, 8 leaves, n=4,096, N=8, sync, dense): the streaming
     schedule's history and parameters bit-equal to the blocking
     schedule's, its modeled wall shorter.
 13. The event runtime, asynchronous: Table 5's ``stl_sc+async`` with
     ``staleness-int8`` messages in the same cohort, cut to 2 of 6 stages:
     one fused update per client local step and one quantize and one
     dequant_mean per leaf per merged upload, at rows = 1; merges a second
     of host wall, the median staleness, and the device's busy share from
     a short profile (taken after phase 4's profiles: a profiler session
     that follows the serving phases' profiles loses device events at its
     start). Then the three training kernels at the shapes phases 11-13
     gave them, held to their plain versions and timed as in phase 3: the
     one-row (1, M) blocks of the logreg leaf and the MLP's leaves, the
     stacked (32, 123) and (8, 123) logreg blocks, and the trees (Table
     4's and Table 5's stacked logreg trees, Table 5's stacked MLP tree,
     one client's logreg and MLP trees). Each cut is logged on a line of
     its own; phases 11-13 log their time.
 14. The two-level ``Hierarchical`` topology. Table 4's hierarchical row
     at its full scale (logreg d=123, n=16,384, N=32, B=32, stl_sc T1=512,
     k1=2, IID, "hier": a dense intra-pod hop and an int8 inter-pod hop
     over 2 pods), cut to 2 of its 6 stages (3 before phase 19), then the
     same with int8 on
     both hops: the comm ledger equal to the hop costs times the rounds
     and to the integer formula, one fused update per local step, one
     quantize and one dequant_mean per leaf per int8 hop message (per pod
     on the intra hop). On the card, dense∘dense ``Hierarchical`` equal
     to ``Star`` and "streaming-hier" equal to "hier" (int8 on both hops),
     bit for bit (stage 1). Then Table 5d on ``runtime.run`` (Table 5's
     MLP, 8 clients, 2 pods, int8 on both hops, billed downlink, 25%
     stragglers at 4x) under the blocking, streaming-uplink and streaming
     schedules: parameters bit-equal across the three, the leaf ledger's
     hops {intra_pod, inter_pod, downlink} summing to the run's bytes,
     the modeled walls logged. The blocks these rounds hand quantize and
     dequant_mean — one pod's (16, 123) and (4, 9,216), the pod means'
     (2, 123) and (2, 9,216) — are among phase 13's kernel shapes
     (``PATH_SHAPES``).
 15. Table 2's non-convex models at the paper's full width: the
     ResNet18 and VGG16 runs on the card against the CPU runs on the same
     draws (width 8, 16x16 and 32x32, 4 rounds); ResNet18 (width 64, 11.17 M parameters, 38
     leaves) on 8,192 32x32 images over 8 Non-IID clients, stl_nc1
     (eta1 0.005, T1 512, k1 8, 1/gamma 0.01), momentum 0.9, B=16, int8,
     cut to stage 1 (64 rounds, 512 local steps), 1 - train accuracy as
     the objective every 8 rounds; VGG16 (width 64, 30 leaves) for 16
     rounds (128 steps). The objective finite (and, for ResNet18, ending
     below its start: VGG16's does not fall within 16 rounds on the
     Non-IID split, so VGG16 is held to the CPU run instead, at width 8),
     one fused update per local step, one quantize and one dequant_mean
     per leaf per round. A profile of 4 rounds of the ResNet18 run (taken after
     phase 4's) gives ms per local step, kernels per step, the busy share
     and each training kernel's device time in the step. Then the three
     training kernels at the CNN's shapes, held to their plain versions
     and timed as in phase 3: ResNet18's largest leaf (8, 2,359,296), its
     head (8, 5,120), a scale (8, 64) and the whole stacked tree through
     ``tree_sgd_update_``. Convolutions run in float32 (TF32 off).
 16. Transformer training (``core/local_sgd.py``, ``StagewiseDriver``,
     the launcher's path). (a) The flash-attention autograd Function on
     the card at qwen3-14b's training layer (2, 1,024, 40/8, 128) in bf16,
     at 16b's layer (2, 64, 4/2, 64) in float32 and a float32 shape with a
     window and a softcap: the kernel route's
     output has a grad_fn and is held to the plain version as in phase 5;
     dq, dk, dv equal autograd through the plain version bit for bit;
     timed: the kernel's forward, the plain backward a layer runs, its
     bound (five products of 2·D FLOPs a visible pair, or bytes) and
     SDPA's forward + backward at the causal shape, held to the plain
     version first (output as phase 5, gradients within 2e-2 of their
     norm). (b) qwen3-14b SMOKE in float32, 2 clients, stl_sc 2 stages
     (24 local steps), the card against the CPU from one state on the
     same batches and sync draws, under dense Star, int8 Star and the
     two-level round (2 pods, dense + int8): stage results and ledgers
     equal, stage mean losses within 1e-4 (dense) and 1e-3 (int8)
     relative, each leaf's update (final − start) and moment within 1e-4
     (dense) and 2e-2 (int8) of its norm; launches: the flash forward
     twice a layer a client a step (forward and remat recompute), one
     fused update a client a step, one quantize and one dequant_mean a
     leaf a round. A control, the dense run with the flash output
     detached (no gradient reaches wq, wk, wv and the q/k norms), must
     fail the state check. (c) qwen3-14b at
     full width (d_model 5,120, 40/8 heads of 128, d_ff 17,408, vocab
     151,936 padded to 152,064, bf16, seed 0), depth cut to 2 of 40
     layers; 2 clients, 2 sequences of 1,024 tokens a client a step from
     ``make_token_stream`` (IID); stl_sc eta1 0.03, k1 4, T1 16, 2
     stages (48 local steps, 8 rounds), dense Star: the loss finite and
     the last stage's mean below the first's, the launches as in (b),
     the ledger equal to rounds x clients x the bf16 bytes of a replica;
     one client's fused update at the trained state (its 14 bf16 leaves,
     float32 moments, the real gradient in bf16 and in float32; one
     launch) bit-equal to the plain version, with its time and bound;
     ms a step against its bound (GEMMs and attention at 989 TFLOP/s),
     peak memory, a profile of 4 local steps (busy share; device time
     of the GEMMs, the flash forward, the plain attention backward, the
     fused update, the loss's log-softmax); then one stage of
     topology "streaming" from the same start, bit-equal to a blocking
     stage. Each cut is logged. Then the three training kernels at the
     (2, n) blocks 16b's int8 rounds hand them (each leaf size of qwen3
     SMOKE), as in phase 3.
 17. Mamba2 training, the launchers' flags and serving from a checkpoint.
     (a) The SSD autograd Function on the card at mamba2-2.7b's training
     layer (2, 1,024, 80, 64), N = 128, chunk 256, and at 17b's layer
     (2, 64, 8, 64), N = 32, chunk 64, float32 as ``apply_mamba2`` hands
     them over: the kernel route's y and final state have a grad_fn and
     are held to the plain version as in phase 8; dx, ddt, dA, dB, dC for
     one fixed dL/dy, from the backward kernel (one ``ssd_bwd`` launch),
     within 3e-4 of each gradient's largest magnitude of autograd through
     the plain version; timed there and at the benchmark cell's shape
     (4, 1,024, 80, 64): the kernel's forward, the backward kernel and
     the plain backward against the backward's bound (``ssd_bwd_work``).
     (b) mamba2-2.7b SMOKE as 16b
     runs qwen3 SMOKE (dense, int8, hier; the same limits; the SSD
     forward twice a layer a client a step), its control with the SSD
     output detached. (c) mamba2-2.7b at full width, its depth cut to 8
     of 64 layers (16 since phase 19, 8 since phase 22, for the run's
     time; bf16, seed 0),
     through ``launch/train.main`` with ``--profile
     --profile-dir --profile-calls 2 --trace --ckpt-out``: 2 clients, 2
     sequences of 1,024 tokens a client a step, stl_sc eta1 0.05, T1 8, k1
     4, 2 stages cut at 16 local steps: the loss finite and falling, the
     launches (SSD 32, its backward kernel 16 and fused update 2 a local
     step), the ledger, ms a
     step against its bound (GEMMs at 989 TFLOP/s, the scan at a third of
     it), peak memory, the skew table, device ms a step by kind over the
     profiler's 2 traced steps (GEMMs, SSD forward, the SSD backward,
     fused update, log-softmax) and the SSD backward's share;
     the trace, its .jsonl and the torch.profiler file checked; one
     client's fused update at the trained state as in 16c. (d) that
     checkpoint behind ``launch/serve.main(["--ckpt", ..., "--trace", ...,
     "--profile"])``: 4 requests, the restored params equal to the trained
     consensus (per-leaf sums), 16 SSD launches a multi-token prefill,
     tokens held to ``greedy_decode`` on the restored params. Then the
     training kernels at the (2, n) blocks 17b's int8 rounds hand them.
 18. MoE and MLA. (a) SMOKE in float32, the card against the CPU: an
     80-token prompt (past the 64-token windows) through ``prefill`` and
     8 decode steps of gemma3-12b, minicpm3-4b (MLA), phi3.5-moe (MoE),
     deepseek-v2 (MLA and MoE) and gemma2-27b with the int8 KV cache,
     logits to 1e-4; a MoE arch's expert assignment (experts, ranks,
     kept) equal in every layer call, the smallest top-k router margin
     logged; the int8 cache's codes apart only by one step where the
     runs' quotients lie within 5e-2 of a step of each other, and then
     the logits held with the CPU run on the card's codes. phi3.5-moe
     and minicpm3 SMOKE trained as 16b trains qwen3 (dense and int8
     Star, 16b's limits); a MoE arch whose runs route a token apart must
     first do so at near ties (router margin under 1e-3), and the state
     both runs reach at the last local step before that is held to 16b's
     limits; phi3.5's controls (flash output detached, and the router's
     gradient 5% off under int8 Star) must be refused.
     Flash at gemma3's local layer (1, 4,608, 16/8, 256, window 1,024)
     and phi3.5's training layer (2, 1,024, 32/8, 128) as phase 5; the
     zero-padded MLA call at deepseek's layer (1, 4,096, 128, 192/128 →
     256) and minicpm3's (96/64 → 128) against the plain attention on the
     unpadded dims, timed beside the unpadded work's bound and SDPA.
     (b) deepseek-v2-236b at full width (d_model 5,120, MLA with 128
     heads, 160 experts x 1,536 top-6 with 2 shared, dense layer 0, bf16,
     seed 0), depth cut to 4 of 60 layers (26.6 GB), behind
     ``ServeEngine`` with 4 slots of 4,096 tokens, 6 Poisson requests and
     a 3,000-token prompt, as phase 7 (4 flash launches a prefill, tokens
     held to ``greedy_decode``); prefill and decode-step ms beside the
     bounds the engine prices, peak memory, the share of assignments
     dropped by capacity at the 3,000-token prefill, and a profile of 4
     decode steps: device ms a step by the layer's parts (attention, the
     MoE layer and its ``moe.*`` ranges, the dense MLP, the rest) and the
     share of the wall a kernel runs. (c) gemma3-12b at full width
     (5:1 local:global, window 1,024), its depth cut to 12 of 48 layers
     (24 since phase 19 joined the script, 12 since phase 22 did),
     with the int8 KV cache behind ``ServeEngine`` (4 slots of 6,144, a
     4,608-token prompt), as phase 7; the first decode step after a
     2,000-token prompt within 2e-2 of the bf16 cache's largest logit;
     the caches' bytes, int8 against bf16; the decode profile as (b),
     with the int8 cache's dequantisation as a range of its own. (d) phi3.5-moe-42b-a6.6b at
     full width (16 experts x 6,400 top-2), depth cut to 2 of 32 layers,
     through ``launch/train.main`` (2 clients, 2 x 1,024 tokens a client
     a step, stl_sc eta1 0.03, T1 16, k1 4, 2 stages cut at 32 local
     steps, dense Star, ``--profile --profile-dir --profile-calls 2``):
     the loss finite and falling, the aux term, flash 8 and the fused
     update 4 launches a step, ms a step against the active FLOPs'
     bound, peak memory, device ms a step by kind (GEMMs, the ``moe.*``
     ranges and the MoE backward nodes, flash, the plain attention
     backward, the update), one client's update at the trained state as
     16c. Then the training kernels at the (2, n) blocks 18a's int8
     rounds hand them that 16b's did not.
 19. RG-LRU and the frontend archs. (a) SMOKE in float32, the card against
     the CPU: recurrentgemma-2b (R, R, L, window 64) with an 80-token
     prompt, internvl2-2b and musicgen-medium with 16 frontend embeddings
     (float32 from a seed) before a 24-token prompt, each through
     ``prefill`` and 8 decode steps, logits to 1e-4; on the card, a used
     cache row's prefill equal to a fresh one's, bit for bit (logits and
     recurrent states); recurrentgemma and musicgen (its batches carrying
     their bf16 frame embeddings) trained as 16b (dense and int8 Star,
     16b's limits). Flash at the phase's new shapes as phase 5:
     recurrentgemma's local layer (1, 4,608, 10/1, 256, window 2,048) and
     training layer (2, 1,024), internvl2's (1, 768, 16/8, 128) and
     musicgen's training layer (2, 1,280, 24/24, 64). (b)
     recurrentgemma-2b at full width (26 layers, d_model 2,560, lru 2,560,
     10/1 heads of 256, window 2,048, vocab 256,000, tied, bf16, seed 0),
     its depth cut to 13 layers since phase 22 joined the script, behind
     ``ServeEngine``, 4 slots of 6,144 tokens, 6 Poisson requests and a
     4,608-token prompt, as phase 7 (4 flash launches a prefill, tokens
     held to ``greedy_decode``); the bounds the engine
     prices, a slot's recurrent state against its attention cache in
     bytes, the decode profile with a ``layer.rglru`` range. (c)
     recurrentgemma-2b at full width, depth cut to 13 of 26 layers since
     phase 22 joined the script, through
     ``launch/train.main`` (``--profile --profile-dir --profile-calls 1
     --ckpt-out``; 2 clients, 2 x 1,024 tokens a client a step, stl_sc
     eta1 0.05, T1 8, k1 4, 2 stages cut at 16 local steps, dense Star):
     the loss finite and falling, flash 16 and the update 4 launches a step
     (the float32 ``a_param`` rows are a type group of their own), ms a
     step against its bound (``lm_step_work``), peak memory, device ms a
     step by kind, the RG-LRU scan's device ms at the training layer and
     a step (``rglru_scan_ms``), one client's update at the trained state
     as 16c; its checkpoint served as 17d. (d) internvl2-2b at full width,
     12 of 24 layers since phase 22 joined the script, behind
     ``ServeEngine``, 4 slots of 2,048 tokens, 6 Poisson
     requests, each with 256 patch embeddings of width 1,024 (float32 from
     a seed, bfloat16 on the card) and a prompt of 64-512 tokens: 12 flash
     launches a prefill, tokens held to ``greedy_decode(..., frontend=)``;
     the logits with the frontend differ from those without it, and the
     engine prices a frontend prefill with its 256 tokens. (e)
     musicgen-medium at full width, depth cut to 24 of 48 layers since
     phase 22 joined the script, through
     ``launch/train.main`` with frontend batches (2 clients, 2 x (256
     frames + 1,024 tokens), eta1 0.03, T1 8, k1 4, 16 local steps, dense
     Star, ``--profile``): the loss finite and falling, flash 96 and the
     update 2 launches a step, ms a step against its bound, peak memory.
     Then the training kernels at the (2, n) blocks 19a's int8 rounds hand them
     that earlier phases' did not.
 20. One ``{"kernels": [...]}`` summary line (all five kernels; launches
     summed over each path's measured run: phases 4 and 11-15's, the
     three card runs of 16b and 17b, the main runs of 16c and 17c and
     17d's serving run, 18a's four card training runs, 18b's and 18c's
     serving runs and 18d's main run, 19a's four card training runs,
     19b's, 19c's checkpoint's and 19d's serving runs and 19c's and 19e's
     main runs, phase 21's mesh runs and phase 22's card runs, not
     the comparison launches, the profiles or 16c's streaming check; the
     flash row carries phase 16a as ``train`` and 18a's padded MLA calls
     as ``mla_shapes``, the SSD row phase 17a),
     then the last line ``{"ok": true, "device": {...}}``.
 22. The five user examples (``examples_torch/``), each script's sections
     on the card at its own widths, run after phase 21 and before the
     summary: (a) quickstart's f* and its three runs held against the same
     sections on the CPU from the same draws (f* 1e-6 relative, histories
     1e-4, rounds to each gap equal, or one eval interval apart where both
     runs' records lie within 1e-6 of the target; the margin printed);
     (b) hierarchical_pods' three topologies and its driver section,
     whose own asserts hold the executed byte ledger to the tree totals;
     (c) federated_noniid's sections, the MLP's streaming uploads
     bit-equal to blocking on the card; (d) serve_batched whole, request 0
     held to ``greedy_decode``; (e) train_llm_stl --hundred-m at 160 local
     steps, its loss falling. Stages, rounds and steps are cut for the
     script's time, each cut logged; the update, quantize, dequant_mean
     and flash kernels must each launch in the phase's card runs.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM float32, outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 dense, tensor cores
# H100 SXM special-function rate: 16 ex2/tanh per clock per SM, at the
# clock the bf16 peak is quoted for (989 TFLOP/s = 132 SMs x 4,096 FLOP per
# clock x 1.83 GHz), so the two floors compare clock for clock
MUFU_OPS_PER_S = 132 * 16 * 1.83e9
TRAIN_KERNELS = ("fused_sgd_update", "quantize_kernel", "dequant_mean_kernel")
# A greedy pick whose top-2 logit gap is under this may flip between the
# engine's 4-slot decode and the single-request reference: their bfloat16
# products round differently, which moves a logit of magnitude 4-8 by a
# few of its bfloat16 steps (2^-5 there), so 8 steps' worth is the cut.
MARGIN_TOL = 0.25
N_CLIENTS = 32
SLICE_TOPOLOGY = {"logreg": "star", "mlp": "streaming"}
TIMING_REPS = 25
SLEEP_CYCLES = 10_000_000   # ~5 ms at the H100's ~2 GHz SM clock
L2_SCRUB_BYTES = 256 << 20  # read before a cold launch: 5x the 50 MB L2
# phase 3's shapes: the logreg leaf, the MLP's leaves (width 96, depth 3)
# and one large shape where the memory bound shows
PHASE3_SHAPES = {"logreg theta": (N_CLIENTS, 784),
                 "mlp w0": (N_CLIENTS, 784 * 96),
                 "mlp w1": (N_CLIENTS, 96 * 96),
                 "mlp b": (N_CLIENTS, 96),
                 "mlp out.w": (N_CLIENTS, 96),
                 "mlp out.b": (N_CLIENTS, 1),
                 "large": (N_CLIENTS, 1 << 20)}


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(torch, fn, reps: int = TIMING_REPS) -> float:
    """Median time of one call as the caller sees it on the card: CUDA
    events around each single call, so the wrapper's host-side work shows
    as device idle time (a launch-bound call is measured as such)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


def host_ms(torch, fn, calls: int = 100, reps: int = TIMING_REPS) -> float:
    """Median host time of one call: the host clock around ``calls`` calls
    made back to back with no synchronisation between them, over their
    count — the wrapper's own cost (checks, allocation, launch), since
    the device's queue absorbs the kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(samples) * 1e3


def device_ms(torch, fn, batch: int = 10, reps: int = TIMING_REPS,
              cold: bool = False) -> float:
    """Median device time of one call: ``reps`` samples, each a batch of
    calls queued behind a sleeping kernel so that they run back to back on
    the device. Warm: CUDA events around the batch, divided by its size;
    a call's inputs may sit in L2 from the call before. ``cold``: before
    each call a read of L2_SCRUB_BYTES evicts them, and events around the
    call alone time it, so a bound from the HBM rate bounds what is
    timed."""
    for _ in range(3):
        fn()
    scrub = (torch.empty(L2_SCRUB_BYTES // 4, device="cuda:0") if cold
             else None)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)   # holds the stream while we queue
        pairs = []
        for i in range(batch if cold else 1):
            if cold:
                scrub.sum()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(1 if cold else batch):
                fn()
            b.record()
            pairs.append((a, b))
        pairs[-1][1].synchronize()
        samples.append(sum(a.elapsed_time(b) for a, b in pairs) / batch)
    return statistics.median(samples)


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = F32_FLOPS):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def sgd_library(ps, ms, gs, *, eta, beta, wd=0.0):
    """The one PyTorch call computing the fused update (the op behind
    ``torch.optim.SGD(fused=True)``), in place on the lists of leaves ps
    and ms; timed beside the kernel, used nowhere in the port."""
    import torch
    torch._fused_sgd_(ps, gs, ms, weight_decay=wd, momentum=beta, lr=eta,
                      dampening=0.0, nesterov=False, maximize=False,
                      is_first_step=False)


def check_kernels(torch, shapes, floor_ms=None):
    """Phase 3: each kernel against its plain version, and its times;
    ``floor_ms``, the launch floor, is logged beside each row."""
    from repro_torch.kernels.fused_update.kernel import fused_sgd_update
    from repro_torch.kernels.fused_update.ref import sgd_update_ref
    from repro_torch.kernels.quantize.kernel import (dequant_mean_kernel,
                                                    quantize_kernel)
    from repro_torch.kernels.quantize.ops import compute_scale
    from repro_torch.kernels.quantize.ref import (dequant_mean_ref,
                                                 quantize_ref)

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for label, (N, M) in shapes.items():
        n = N * M
        p = torch.randn((N, M), generator=g, device=dev)
        m = torch.randn((N, M), generator=g, device=dev)
        gr = torch.randn((N, M), generator=g, device=dev)
        err_f = 0.0
        for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
            pk, mk, gk = p.to(dt), m.clone(), gr.to(dt)
            pr, mr = sgd_update_ref(pk, mk, gk, eta=0.05, beta=0.9, wd=1e-4)
            fused_sgd_update(pk, mk, gk, eta=0.05, beta=0.9, wd=1e-4)
            torch.cuda.synchronize()
            e = 0.0
            for got, ref in ((pk, pr), (mk, mr)):
                diff = (got.float() - ref.float()).abs()
                if not bool((diff <= tol + tol * ref.float().abs()).all()):
                    raise AssertionError(f"fused_sgd_update {label} {dt}: "
                                         f"max err {float(diff.max())}")
                e = max(e, float(diff.max()))
            if dt == torch.float32:
                # built with -fmad=false: the plain version's bits
                if e != 0.0:
                    raise AssertionError(f"fused_sgd_update {label}: not "
                                         f"bit-equal in float32 ({e})")
                err_f = e
        # the library call timed beside the kernel must compute the same
        # function: torch.optim.SGD(fused=True)'s op, dampening 0, no Nesterov
        pl, ml = p.clone(), m.clone()
        sgd_library([pl], [ml], [gr], eta=0.05, beta=0.9, wd=1e-4)
        pr, mr = sgd_update_ref(p, m, gr, eta=0.05, beta=0.9, wd=1e-4)
        torch.cuda.synchronize()
        lib_err = max(float((a - b).abs().max())
                      for a, b in ((pl, pr), (ml, mr)))
        if not lib_err <= 1e-5:
            raise AssertionError(f"torch._fused_sgd_ {label}: "
                                 f"max err {lib_err}")
        y = torch.randn((N, M), generator=g, device=dev) \
            * torch.rand((N, 1), generator=g, device=dev)
        rb = torch.randint(-2 ** 31, 2 ** 31, (N, M), dtype=torch.int32,
                           generator=g, device=dev)
        s = compute_scale(y, dim=1)
        # y at an odd offset of a flat buffer: its rows are not 16-byte
        # aligned, so quantize takes its scalar instantiation
        yv = torch.empty(n + 1, device=dev)[1:].view(N, M)
        yv.copy_(y)
        err_d = 0.0
        for bits in (8, 4, 2):
            qr = quantize_ref(y, rb, s[:, None], bits=bits)
            for how, yk in (("", y), (" odd view", yv)):
                q = quantize_kernel(yk, rb, s, bits=bits)
                torch.cuda.synchronize()
                if not torch.equal(q, qr):
                    raise AssertionError(
                        f"quantize{how} {label} int{bits}: "
                        f"{int((q != qr).sum())} codes differ")
            mean = dequant_mean_kernel(q, s, bits=bits)
            mr = dequant_mean_ref(q, s, bits=bits)
            torch.cuda.synchronize()
            e = float((mean - mr).abs().max())
            if not e <= 1e-6:
                raise AssertionError(f"dequant_mean {label} int{bits}: "
                                     f"max err {e}")
            err_d = max(err_d, e)

        # times: float32 update, int8 codes, at this shape
        pk, mk = p.clone(), m.clone()
        q = quantize_kernel(y, rb, s, bits=8)
        fns = {
            "fused_sgd_update": (
                lambda: fused_sgd_update(pk, mk, gr, eta=1e-6, beta=0.9),
                lambda: sgd_update_ref(p, m, gr, eta=1e-6, beta=0.9),
                lambda: sgd_library([pl], [ml], [gr], eta=1e-6, beta=0.9),
                bound_ms(20 * n, 4 * n), err_f),
            "quantize_kernel": (
                lambda: quantize_kernel(y, rb, s, bits=8),
                lambda: quantize_ref(y, rb, s[:, None], bits=8),
                None, bound_ms(9 * n + 4 * N, 6 * n), 0.0),
            "quantize_kernel odd view": (
                lambda: quantize_kernel(yv, rb, s, bits=8),
                lambda: quantize_ref(yv, rb, s[:, None], bits=8),
                None, bound_ms(9 * n + 4 * N, 6 * n), 0.0),
            "dequant_mean_kernel": (
                lambda: dequant_mean_kernel(q, s, bits=8),
                lambda: dequant_mean_ref(q, s, bits=8),
                None, bound_ms(n + 4 * N + 4 * M, 2 * n + N), err_d),
        }
        for name, (kf, pf, lf, (bms, by), err) in fns.items():
            ms, plain, call, host = (device_ms(torch, kf, cold=True),
                                     device_ms(torch, pf, cold=True),
                                     call_ms(torch, kf), host_ms(torch, kf))
            lib = (device_ms(torch, lf, cold=True) if lf is not None
                   else None)
            rows[(name, label)] = {"ms": ms, "plain_ms": plain,
                                   "call_ms": call, "host_ms": host,
                                   "library_ms": lib,
                                   "bound_ms": bms, "bound_by": by,
                                   "launch_floor_ms": floor_ms,
                                   "max_abs_err": err}
            lib_txt = "-" if lib is None else f"{lib * 1e3:.2f} us"
            floor_txt = ("" if floor_ms is None
                         else f", launch floor {floor_ms * 1e3:.2f} us")
            log(f"[kernels] {name:24s} {label:13s} ({N}, {M}): device "
                f"{ms * 1e3:8.2f} us, plain {plain * 1e3:8.2f} us, library "
                f"{lib_txt}, bound {bms * 1e3:8.3f} us ({by}){floor_txt}; "
                f"one call {call * 1e3:7.2f} us, host {host * 1e3:6.2f} us "
                f"a call; max_abs_err {err:.3g}")
    return rows


def launch_floor_ms(torch) -> float:
    """Device time of a kernel that returns at once (PyTorch's one-thread
    ``_sleep`` kernel asked for 0 cycles), timed as phase 3 times the
    training kernels: the floor under any launch."""
    return device_ms(torch, lambda: torch.cuda._sleep(0), cold=True)


def random_trees(torch, seed: int, models: dict) -> dict:
    """{label: (ps, ms, gs)}: random leaf lists on the card, from ``seed``,
    shaped as ``models`` ({label: (params, N)}) says: each leaf of
    ``params`` stacked N times, or as it is when N is None."""
    from repro_torch.utils.tree import tree_leaves

    g = torch.Generator(device="cuda:0").manual_seed(seed)
    trees = {}
    for label, (p0, N) in models.items():
        lead = () if N is None else (N,)
        rand = lambda: [torch.randn(lead + tuple(t.shape), generator=g,
                                    device="cuda:0")
                        for t in tree_leaves(p0)]
        trees[label] = (rand(), rand(), rand())
    return trees


def slice_trees(torch) -> dict:
    """The stacked (32, …) trees the slice's local steps update."""
    from repro_torch.models import logreg, mlp

    dev = torch.device("cuda:0")
    return random_trees(torch, 4, {
        "logreg tree": (logreg.init_params(784, device=dev), N_CLIENTS),
        "mlp tree": (mlp.init_params(784, width=96, depth=3, device=dev),
                     N_CLIENTS)})


def tree_update_ms(torch, ps, ms, gs) -> float:
    """Cold device time of one update of a whole tree through
    ``tree_sgd_update_``, as the local step calls it (in place on ps and
    ms)."""
    from repro_torch.kernels.fused_update.ops import tree_sgd_update_

    return device_ms(torch, lambda: tree_sgd_update_(ps, ms, gs, eta=1e-6,
                                                     beta=0.9), cold=True)


def check_trees(torch, floor_ms: float, trees=None) -> dict:
    """Phase 3, the trees: one launch updates a whole stacked (32, …) tree
    the slice's local steps update (logreg's one leaf, the MLP's 8),
    bit-equal to the plain version in float32; its device time beside its
    bound, the per-leaf launches it replaces, ``torch._fused_sgd_`` over
    the same leaf lists (held to the plain version first) and the launch
    floor. ``trees`` ({label: (ps, ms, gs)}, default ``slice_trees``):
    phases 11-13 pass theirs (``path_trees``)."""
    from repro_torch.kernels.fused_update.kernel import (
        fused_sgd_update, fused_sgd_update_leaves)
    from repro_torch.kernels.fused_update.ref import tree_sgd_update_ref

    rows = {}
    trees = slice_trees(torch) if trees is None else trees
    for label, (ps, ms, gs) in trees.items():
        n = sum(t.numel() for t in ps)
        want_p, want_m = tree_sgd_update_ref(ps, ms, gs, eta=0.05, beta=0.9,
                                             wd=1e-4)
        pk, mk = [t.clone() for t in ps], [t.clone() for t in ms]
        before = fused_sgd_update.launches
        fused_sgd_update_leaves(pk, mk, gs, eta=0.05, beta=0.9, wd=1e-4)
        torch.cuda.synchronize()
        if fused_sgd_update.launches != before + 1:
            raise AssertionError(f"{label}: "
                                 f"{fused_sgd_update.launches - before} "
                                 f"launches for one tree")
        if not all(torch.equal(a, b) for a, b in zip(pk + mk,
                                                     want_p + want_m)):
            err = max(float((a - b).abs().max())
                      for a, b in zip(pk + mk, want_p + want_m))
            raise AssertionError(f"fused_sgd_update {label}: not bit-equal "
                                 f"to the plain version (max err {err})")
        pl, ml = [t.clone() for t in ps], [t.clone() for t in ms]
        sgd_library(pl, ml, gs, eta=0.05, beta=0.9, wd=1e-4)
        torch.cuda.synchronize()
        lib_err = max(float((a - b).abs().max())
                      for a, b in zip(pl + ml, want_p + want_m))
        if not lib_err <= 1e-5:
            raise AssertionError(f"torch._fused_sgd_ {label}: max err "
                                 f"{lib_err}")

        def per_leaf():
            for p, m, gr in zip(pk, mk, gs):
                fused_sgd_update(p, m, gr, eta=1e-6, beta=0.9)

        kern = lambda: fused_sgd_update_leaves(pk, mk, gs, eta=1e-6,
                                               beta=0.9)
        ms_, leaf_ms, plain, lib, call = (
            tree_update_ms(torch, pk, mk, gs),
            device_ms(torch, per_leaf, cold=True),
            device_ms(torch, lambda: tree_sgd_update_ref(ps, ms, gs,
                                                         eta=1e-6, beta=0.9),
                      cold=True),
            device_ms(torch, lambda: sgd_library(pl, ml, gs, eta=1e-6,
                                                 beta=0.9), cold=True),
            call_ms(torch, kern))
        bms, by = bound_ms(20 * n, 4 * n)
        rows[label] = {"leaves": len(ps), "elements": n, "ms": ms_,
                       "per_leaf_ms": leaf_ms, "plain_ms": plain,
                       "library_ms": lib, "call_ms": call, "bound_ms": bms,
                       "bound_by": by, "launch_floor_ms": floor_ms,
                       "max_abs_err": 0.0}
        log(f"[kernels] fused_sgd_update {label} ({len(ps)} leaves, {n} "
            f"elements): device {ms_ * 1e3:8.2f} us in one launch, "
            f"{len(ps)} per-leaf launches {leaf_ms * 1e3:8.2f} us, plain "
            f"{plain * 1e3:8.2f} us, library {lib * 1e3:8.2f} us, bound "
            f"{bms * 1e3:8.3f} us ({by}), launch floor {floor_ms * 1e3:.2f} "
            f"us; one call {call * 1e3:7.2f} us; bit-equal to the plain "
            f"version")
    return rows


class HostKey:
    """A key whose draws are made on the CPU and handed to the card, so a
    run on the card and a run on the CPU see the same draws."""

    def __init__(self, key, device):
        self.key, self.device = key, device

    def split(self, n):
        return [HostKey(k, self.device) for k in self.key.split(n)]

    def fold_in(self, data):
        return HostKey(self.key.fold_in(data), self.device)

    def batch_indices(self, n_clients, batch, high):
        return self.key.batch_indices(n_clients, batch, high).to(self.device)

    def client_batch_indices(self, batch, high):
        return self.key.client_batch_indices(batch, high).to(self.device)

    def bits(self, shape):
        return self.key.bits(shape).to(self.device)


def small_reference_check(torch):
    """The card's run of the slice against the CPU run (plain versions) on
    one small input and the same draws. Tolerances as the CPU parity tests
    state them: 1e-5 dense (summation order), 1e-4 int8 (a code may flip
    at a floor() boundary)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.models import mlp
    from repro_torch.utils.rng import TorchKey

    x, y = make_binary_classification(n=256, d=32, seed=0)
    data = partition_iid(x, y, 4, seed=1)
    p0 = mlp.init_params(32, width=16, depth=3, seed=1)
    for reducer, tol in (("dense", 1e-5), ("int8", 1e-4)):
        cfg = TrainConfig(algo="stl_sc", eta1=0.5, T1=16, k1=4.0, n_stages=2,
                          batch_per_client=8, reducer=reducer,
                          topology="streaming")
        hist = {}
        for dev in ("cpu", "cuda"):
            xt, yt = (torch.from_numpy(a).to(dev) for a in (x, y))
            hist[dev] = [r.value for r in simulate.run(
                lambda p, b: mlp.loss_fn(p, b, 1e-3), p0,
                {k: torch.from_numpy(v) for k, v in data.items()}, cfg,
                lambda p: mlp.full_objective(p, xt, yt, 1e-3), device=dev,
                rng=HostKey(TorchKey(0), torch.device(dev)))]
        err = max(abs(a - b) for a, b in zip(hist["cpu"], hist["cuda"]))
        log(f"[reference] mlp {reducer}: card vs CPU over "
            f"{len(hist['cpu'])} records, max |diff| {err:.3g} (tol {tol})")
        if not (len(hist["cpu"]) == len(hist["cuda"]) and err <= tol):
            raise AssertionError(f"card run disagrees with the CPU run "
                                 f"({reducer}): {err}")


def slice_data():
    """The slice's dataset, at Table 1's size: (x (11791, 784), y)."""
    from repro_torch.data import make_binary_classification

    return make_binary_classification(n=11791, d=784, seed=0)


def make_slice(torch, model: str, x, y, n_stages: int = 3, **backend_kw):
    """The slice's full-width configuration: (engine, backend, params)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.data import partition_iid
    from repro_torch.engine import Engine
    from repro_torch.models import logreg, mlp

    dev = torch.device("cuda:0")
    n, d = x.shape
    lam = 1.0 / n
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in partition_iid(x, y, N_CLIENTS, seed=1).items()}
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    mod = logreg if model == "logreg" else mlp
    p0 = (logreg.init_params(d, device=dev) if model == "logreg"
          else mlp.init_params(d, width=96, depth=3, seed=0, device=dev))
    cfg = TrainConfig(algo="stl_sc", eta1=0.5, T1=512, k1=16.0,
                      n_stages=n_stages, iid=True, batch_per_client=32,
                      reducer="int8", topology=SLICE_TOPOLOGY[model], seed=0)
    engine = Engine(cfg.algo, cfg)
    backend = simulate.VmapSimulatorBackend(
        lambda p, b: mod.loss_fn(p, b, lam), p0, data,
        lambda p: mod.full_objective(p, xt, yt, lam), device=dev,
        **backend_kw)
    return engine, backend, p0


def run_slice(torch, model: str, x, y):
    """Phase 4: one full-width run of the port's main path."""
    from repro_torch import kernels
    from repro_torch.utils.tree import tree_leaves

    engine, backend, p0 = make_slice(torch, model, x, y)
    topology = SLICE_TOPOLOGY[model]
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    hist = engine.run(backend)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()

    rep = engine.report
    vals = [r.value for r in hist]
    leaves = [tuple(l.shape) for l in tree_leaves(p0)]
    per_client = sum(math.prod(s) + 4 for s in leaves)   # int8 + one scale
    log(f"[slice] {model} ({topology}, int8): rounds {rep.rounds_total}, "
        f"iterations {rep.iters_total}, wall {wall:.2f} s, objective "
        f"{vals[0]:.6f} -> {vals[-1]:.6f}, comm bytes "
        f"{rep.comm_bytes_total}, launches {counts}")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{model}: non-finite objective")
    if not vals[-1] < 0.9 * vals[0]:
        raise AssertionError(f"{model}: objective {vals[-1]} did not fall "
                             f"below 0.9 x {vals[0]}")
    if (rep.rounds_total, rep.iters_total) != (96, 3584):
        raise AssertionError(f"{model}: ran {rep.rounds_total} rounds, "
                             f"{rep.iters_total} iterations")
    expect = rep.rounds_total * N_CLIENTS * per_client
    if rep.comm_bytes_total != expect:
        raise AssertionError(f"{model}: ledger {rep.comm_bytes_total} != "
                             f"{expect}")
    if model == "logreg" and expect != 96 * 32 * (784 + 4):
        raise AssertionError("logreg ledger formula")
    # one fused update per local step for the whole tree; one quantize and
    # one dequant_mean per leaf per round
    want = {"fused_sgd_update": rep.iters_total,
            "quantize_kernel": rep.rounds_total * len(leaves),
            "dequant_mean_kernel": rep.rounds_total * len(leaves)}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{model}: launches {counts}, expected {want}")
    return counts, wall


def profile_slice(torch, model: str, x, y, rounds: int = 4) -> dict:
    """Phase 4b: where a round's time goes — torch.profiler over a few
    rounds of the slice (first stage, k = 16), after one warm-up run."""
    warm, warm_backend, _ = make_slice(torch, model, x, y, n_stages=1,
                                       max_rounds=1, chunk_rounds=1)
    warm.run(warm_backend)
    engine, backend, _ = make_slice(torch, model, x, y, n_stages=1,
                                    max_rounds=rounds, chunk_rounds=rounds)

    def run():
        engine.run(backend)
        return engine.report.iters_total, engine.report.rounds_total

    return profile_run(torch, model, run)


def busy_union_us(torch, prof) -> float:
    """µs in which at least one kernel ran: the union of the profile's
    device intervals (kernels that overlap count once, so the share
    cannot pass 100% as the sum over kernels can)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_run(torch, label: str, run) -> dict:
    """torch.profiler over ``run()`` (a few rounds, warmed up by the
    caller), which returns the (local steps, rounds) it ran. Returns ms
    per local step, kernels per step, the device's busy share (kernel
    times summed, and the time with any kernel running) and, for each
    training kernel, its launches and device µs per launch inside the
    step (``in_step``); only the wall without device events."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        steps, rounds = run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    out = {"steps": steps, "ms_per_step": wall * 1e3 / steps}
    if not kern:
        log(f"[profile] {label}: wall {wall * 1e3 / steps:.3f} ms per local "
            f"step; device time not measured (no CUDA events traced)")
        return out
    union_us = busy_union_us(torch, prof)
    out.update(kernels_per_step=n_kern / steps,
               busy_pct=100 * busy_us / (wall * 1e6),
               busy_union_pct=100 * union_us / (wall * 1e6), in_step={})
    log(f"[profile] {label}: {steps} local steps, {rounds}"
        f" rounds in {wall * 1e3:.1f} ms under the profiler: "
        f"{wall * 1e3 / steps:.3f} ms per step, {n_kern / steps:.1f} kernels "
        f"per step, device busy {busy_us / 1e3:.2f} ms summed over kernels "
        f"({100 * busy_us / (wall * 1e6):.1f}% of wall), "
        f"{union_us / 1e3:.2f} ms with any kernel running "
        f"({100 * union_us / (wall * 1e6):.1f}% of wall)")
    for name in TRAIN_KERNELS:
        hits = [e for e in kern if name in e.key]
        count = sum(e.count for e in hits)
        if count:
            us = sum(e.self_device_time_total for e in hits) / count
            out["in_step"][name] = {"launches": count, "us": us}
            log(f"[profile]   in the step: {name} {us:.2f} us per launch "
                f"(x{count})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CUDA]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:8.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")
    return out


def sdpa_library(torch, q, k, v):
    """The one PyTorch call computing causal GQA attention without softcap
    (``scaled_dot_product_attention``), in the port's (B, S, H, D) layout;
    timed beside the kernel, used nowhere in the port."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


# label: (B, S, H, KV, D, dtype, window, softcap); gemma2-27b's layers at
# its 4,608-token prefill, qwen3-14b's (40/8 heads) causal layer at the same
# length, one D = 256 shape, a ragged and a float32 shape
FLASH_CASES = {
    "local": (1, 4608, 32, 16, 128, "bf16", 4096, 50.0),
    "global": (1, 4608, 32, 16, 128, "bf16", None, 50.0),
    "causal": (1, 4608, 32, 16, 128, "bf16", None, None),
    "qwen3": (1, 4608, 40, 8, 128, "bf16", None, None),
    "d256": (1, 4096, 16, 8, 256, "bf16", None, None),
    "ragged": (1, 1000, 32, 16, 128, "bf16", None, 50.0),
    "f32": (2, 300, 8, 4, 128, "f32", 128, 50.0),
}


def check_flash(torch, cases=None):
    """Phase 5 (``FLASH_CASES``; phase 18a passes its own): flash attention
    against its plain version, and its times."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         bf16_mismatch)
    from repro_torch.launch.flops import _attn_pairs

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    rows = {}
    for label, (B, S, H, KV, D, dtn, window, cap) in (
            cases or FLASH_CASES).items():
        dt = {"bf16": bf, "f32": f32}[dtn]
        # with a softcap, q is scaled by cap / 4 so that the scores spread to
        # about +-cap, where cap * tanh(s / cap) bends away from s
        q = torch.randn((B, S, H, D), generator=g, device=dev)
        q = (q * (cap / 4 if cap else 1.0)).to(dt)
        k = torch.randn((B, S, KV, D), generator=g, device=dev).to(dt)
        v = torch.randn((B, S, KV, D), generator=g, device=dev).to(dt)
        kern = lambda: flash_attention(q, k, v, window=window, softcap=cap)
        plain = lambda: attention_ref(q, k, v, window=window,
                                      softcap=cap).to(dt)
        out, ref = kern(), plain()
        torch.cuda.synchronize()

        def mismatch(ref):
            if dt == bf:
                # ref.py's bf16 tolerance: elementwise |d| <= 5e-3 + 1e-2
                # |ref| and per (row, head) ||d|| <= 1e-2 ||ref||, as ratios
                err, elem, row = bf16_mismatch(out, ref)
                return (err, elem, row, f"elementwise {elem:.3f}, per-row "
                        f"{row:.3f} of tol")
            # f32: the same float32 products summed in another order
            diff = (out.float() - ref.float()).abs()
            elem = float((diff / (1e-5 + 1e-5 * ref.abs())).max())
            return (float(diff.max()), elem, None,
                    f"{elem:.3f} of 1e-5 + 1e-5 |ref|")

        err, elem, row, tol_txt = mismatch(ref)
        if not (elem <= 1.0 and (row is None or row <= 1.0)):
            raise AssertionError(f"flash_attention {label}: max err {err}, "
                                 f"{tol_txt}")
        if cap:
            # control: the cap-free attention must fail the same tolerance,
            # or these inputs could not tell a missing softcap
            c_err, c_elem, c_row, c_txt = mismatch(
                attention_ref(q, k, v, window=window))
            log(f"[flash] {label}: the cap-free attention is off by max err "
                f"{c_err:.3g}, {c_txt} (must exceed it)")
            if c_elem <= 1.0 and (c_row is None or c_row <= 1.0):
                raise AssertionError(f"flash_attention {label}: the softcap "
                                     f"control passed ({c_txt})")
        lib, lib_err = None, None
        if cap is None and window is None:
            lib_out = sdpa_library(torch, q, k, v)
            torch.cuda.synchronize()
            lib_err, lib_elem, lib_row = bf16_mismatch(lib_out, ref)
            log(f"[flash] SDPA against the plain version: max err "
                f"{lib_err:.3g}, elementwise {lib_elem:.3f}, per-row "
                f"{lib_row:.3f} of tol")
            if not (lib_elem <= 1.0 and lib_row <= 1.0):
                raise AssertionError(f"SDPA {label}: max err {lib_err}")
            lib = device_ms(torch, lambda: sdpa_library(torch, q, k, v),
                            batch=2, reps=10)
        del out, ref
        big = S > 2000
        ms = device_ms(torch, kern, batch=2 if big else 10,
                       reps=10 if big else TIMING_REPS)
        plain_ms = device_ms(torch, plain, batch=1 if big else 10,
                             reps=5 if big else TIMING_REPS)
        one = call_ms(torch, kern, reps=10 if big else TIMING_REPS)
        pairs = _attn_pairs(S, window, "prefill")
        n_flops = 4.0 * B * H * D * pairs
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bms, by = bound_ms(n_bytes, n_flops,
                           BF16_FLOPS if dt == bf else F32_FLOPS)
        # special-function floor: one exp2 per visible pair and head, one
        # more (tanh) with a softcap, at 16 per clock per SM; logged only,
        # as it rests on an assumed rate
        mufu = B * H * pairs * (2 if cap else 1) / MUFU_OPS_PER_S * 1e3
        rows[label] = {"shape": [B, S, H, KV, D], "dtype": str(dt),
                       "window": window, "softcap": cap, "ms": ms,
                       "plain_ms": plain_ms, "call_ms": one,
                       "library_ms": lib, "bound_ms": bms, "bound_by": by,
                       "of_bound": bms / ms,
                       "max_abs_err": err, "elem_of_tol": elem,
                       "row_of_tol": row, "tflops": n_flops / ms / 1e9}
        lib_txt = "-" if lib is None else f"{lib:.3f} ms (err {lib_err:.3g})"
        log(f"[flash] {label:6s} {tuple(q.shape)} kv {KV} {dt} window "
            f"{window} softcap {cap}: device {ms:.4f} ms, one call "
            f"{one:.4f} ms, plain {plain_ms:.3f} ms, library {lib_txt}, "
            f"bound {bms:.4f} ms ({by}; MUFU floor {mufu:.4f} ms), "
            f"{n_flops / ms / 1e9:.1f} TFLOP/s = {100 * bms / ms:.1f}% of "
            f"the bound; max_abs_err {err:.3g}, {tol_txt}")
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def ssd_work(b, S, H, P, G, N, chunk, elt, init=False):
    """(bytes, FLOPs) the SSD scan must move and compute at this shape.

    Bytes: x, B, C (``elt`` bytes each), dt and A read once, y written once
    in x's type, the float32 state written once (and, with ``init``, the
    float32 initial state read once). FLOPs, per chunk of q rows: C·Bᵀ
    once per group over the lower triangle (q(q+1)/2 pairs × N), the
    intra-chunk product over the same pairs × P per head, the state term of
    y (q × N × P per head; in the first chunk only from an initial state)
    and the state update (q × P × N per head); 2 FLOPs per multiply-add."""
    Q = min(chunk, S)
    flops = 0.0
    for c in range(-(-S // Q)):
        q = min(Q, S - c * Q)
        tri = q * (q + 1) / 2
        flops += 2.0 * b * (G * tri * N + H * tri * P
                            + (H * q * N * P if c or init else 0)
                            + H * q * P * N)
    n_bytes = (elt * (2 * b * S * H * P + 2 * b * S * G * N)
               + 4 * (b * S * H + H + (2 if init else 1) * b * H * P * N))
    return n_bytes, flops


def ssd_inputs(torch, g, b, S, H, P, G, N, dtype):
    """Phase 8's SSD inputs: x, dt, A, B, C drawn on the card from g."""
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda:0")
    return ((rn(b, S, H, P) * 0.5).to(dtype),
            torch.nn.functional.softplus(rn(b, S, H)) * 0.1,
            -torch.exp(rn(H) * 0.3), (rn(b, S, G, N) * 0.3).to(dtype),
            (rn(b, S, G, N) * 0.3).to(dtype))


def ssd_layer_kernels_ms(torch) -> dict:
    """Device time of each kernel of one SSD call at mamba2-2.7b's layer
    (after a warm-up), from torch.profiler: {kernel name: ms}; {} if no
    device event was traced. main() takes it before any other profile."""
    from repro_torch.kernels.ssd.kernel import ssd

    g = torch.Generator(device="cuda:0").manual_seed(3)
    args = ssd_inputs(torch, g, 1, 4096, 80, 64, 1, 128, torch.float32)
    ssd(*args, chunk=256)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ssd(*args, chunk=256)
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def off_by(pairs, tol):
    """(max |d|, max |d| / (tol + tol |ref|)) over (got, ref) pairs: the JAX
    package's tolerance rule for the SSD scan (tests/test_ssd_kernel.py)."""
    err, worst = 0.0, 0.0
    for got, ref in pairs:
        d = (got.float() - ref.float()).abs()
        err = max(err, float(d.max()))
        worst = max(worst, float((d / (tol + tol * ref.float().abs())).max()))
    return err, worst


def check_ssd(torch, passes_ms: dict, labels=None):
    """Phase 8: the SSD kernel against its plain version, and its times;
    ``passes_ms`` is ``ssd_layer_kernels_ms``'s profile of the layer call;
    ``labels``: the cases to run (default all)."""
    from repro_torch.kernels.ssd.kernel import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref

    g = torch.Generator(device="cuda:0").manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
    inputs = lambda *shape: ssd_inputs(torch, g, *shape)

    # the plain chunked version against the sequential recurrence first
    for shape, chunk in (((2, 256, 4, 64, 2, 32), 64),
                         ((1, 200, 4, 32, 2, 16), 64)):
        args = inputs(*shape, f32)
        (yc, sc), (yr, sr) = ssd_chunked_ref(*args, chunk), ssd_ref(*args)
        err = max(float((yc - yr).abs().max()), float((sc - sr).abs().max()))
        log(f"[ssd] plain chunked vs recurrence {shape} chunk {chunk}: max "
            f"err {err:.3g} (tol 3e-4)")
        if not err <= 3e-4:
            raise AssertionError(f"ssd_chunked_ref vs ssd_ref {shape}: {err}")

    # label: (b, S, H, P, G, N, chunk, dtype, from an initial state);
    # mamba2-2.7b's layer at a 4,096-token prefill, its 4,000-token prompt
    # (a 160-row last chunk), the Pallas test's grouped shapes, the layer
    # with bf16 inputs, and from a non-zero initial state the layer and a
    # short shape of two chunks
    cases = {
        "layer": (1, 4096, 80, 64, 1, 128, 256, f32, False),
        "ragged": (1, 4000, 80, 64, 1, 128, 256, f32, False),
        "g2_c64": (2, 256, 4, 64, 2, 32, 64, f32, False),
        "g2_c128": (2, 256, 4, 64, 2, 32, 128, f32, False),
        "bf16": (1, 4096, 80, 64, 1, 128, 256, bf, False),
        "layer_init": (1, 4096, 80, 64, 1, 128, 256, f32, True),
        "init_2chunk": (2, 300, 8, 64, 1, 128, 256, f32, True),
    }

    rows = {}
    for label, (b, S, H, P, G, N, chunk, dt_, init) in cases.items():
        if labels is not None and label not in labels:
            continue
        args = inputs(b, S, H, P, G, N, dt_)
        # an initial state as large as a chunk's own: it reaches y and the
        # final state. The keyword is passed only with a state, so that
        # tools/torch_chip_ab.py can time a checkout whose scan takes none
        h0 = (torch.randn((b, H, P, N), generator=g, device="cuda:0")
              if init else None)
        kw = {} if h0 is None else {"initial_state": h0}
        kern = lambda: ssd(*args, chunk=chunk, **kw)
        plain = lambda: ssd_chunked_ref(*args, chunk, **kw)
        (y, st), (yr, sr) = kern(), plain()
        if init:
            # held to the sequential recurrence from the same state, and the
            # plain chunked version first
            yc, sc = yr, sr
            yr, sr = ssd_ref(*args, initial_state=h0)
            e, w = off_by(((yc, yr), (sc, sr)), 3e-4)
            log(f"[ssd] {label}: plain chunked vs recurrence from the "
                f"initial state, max err {e:.3g}, {w:.3f} of tol 3e-4")
            if not w <= 1.0:
                raise AssertionError(f"ssd_chunked_ref {label}: {e}")
            del yc, sc
        torch.cuda.synchronize()
        tol = 3e-4 if dt_ == f32 else 5e-2
        err, worst = off_by(((y, yr), (st, sr)), tol)
        log(f"[ssd] {label:8s} {(b, S, H, P)} G {G} N {N} chunk {chunk} "
            f"{dt_}{' from an initial state' if init else ''}: max err "
            f"{err:.3g}, {worst:.3f} of tol {tol}")
        if not worst <= 1.0:
            raise AssertionError(f"ssd {label}: max err {err}")
        del y, st, yr, sr
        big = S > 1000
        ms = device_ms(torch, kern, batch=2 if big else 10,
                       reps=10 if big else TIMING_REPS)
        plain_ms = device_ms(torch, plain, batch=1 if big else 10,
                             reps=5 if big else TIMING_REPS)
        one = call_ms(torch, kern, reps=10 if big else TIMING_REPS)
        n_bytes, n_flops = ssd_work(b, S, H, P, G, N, chunk,
                                    args[0].element_size(), init)
        # the kernel's scheme: every product as three bf16 tensor-core ones
        bms, by = bound_ms(n_bytes, n_flops, BF16_FLOPS / 3)
        f32_ms = n_flops / F32_FLOPS * 1e3
        rows[label] = {"shape": [b, S, H, P, G, N], "chunk": chunk,
                       "dtype": str(dt_), "initial_state": init,
                       "ms": ms, "plain_ms": plain_ms,
                       "call_ms": one, "library_ms": None, "bound_ms": bms,
                       "bound_by": by, "max_abs_err": err,
                       "of_tol": worst, "tflops": n_flops / ms / 1e9}
        log(f"[ssd] {label:8s} device {ms:.4f} ms, one call {one:.4f} ms, "
            f"plain {plain_ms:.3f} ms, library none, bound {bms:.4f} ms "
            f"({by}: {n_flops / 1e9:.2f} GFLOP x 3 bf16 products, "
            f"{n_bytes / 1e6:.1f} MB; {100 * bms / ms:.1f}% of it; the "
            f"float32 work on the CUDA cores alone {f32_ms:.4f} ms), "
            f"{n_flops / ms / 1e9:.2f} TFLOP/s")
        if label == "layer":
            if not passes_ms:
                log("[ssd] per-kernel device time not measured (no CUDA "
                    "events traced)")
            for name, t in sorted(passes_ms.items(), key=lambda kv: -kv[1]):
                log(f"[ssd]   kernel {t:8.4f} ms  {name}")
            rows[label]["passes_ms"] = passes_ms
        del args, h0, kw
    torch.cuda.empty_cache()
    return rows


def recording_routes(calls: list, keep=lambda r, moe, params, x: r):
    """A patch of ``models/moe.route`` that appends ``keep(routing, moe
    config, router params, x)`` of each call to ``calls`` (the layer calls
    route through its module)."""
    from unittest import mock

    from repro_torch.models import moe as MOE

    route = MOE.route

    def rec(params, moe, x):
        r = route(params, moe, x)
        calls.append(keep(r, moe, params, x))
        return r

    return mock.patch.object(MOE, "route", rec)


def router_margins(torch, params, moe, x):
    """Each token's gap between its k-th and (k+1)-th router probability
    (the router's float32 product and softmax, as ``moe.route`` forms
    them): how close its assignment came to a tie."""
    probs = torch.softmax(x.float() @ params["w_router"], dim=-1)
    top = torch.topk(probs, moe.top_k + 1, dim=-1).values
    return top[..., moe.top_k - 1] - top[..., moe.top_k]


# A MoE layer's choice of experts is discrete: where the card's and the
# CPU's float32 sums (or an int8 code flipped between them) put a token's
# k-th and (k+1)-th router probabilities on different sides of a tie, the
# token's whole contribution moves from one expert's gradient to
# another's, the runs' weights part, and later tokens route apart at
# clearer margins. 16b's state limit then holds a MoE run only while its
# assignments agree. So where the runs route apart, the first layer call
# that does must do so at near ties of the CPU run (the k-th and (k+1)-th
# router probabilities within MOE_FLIP_MARGIN), and both runs are made
# again up to the last local step before that call (then one sync round):
# that state is held to 16b's limits. A fault on the card moves the state
# from the first step, before any token routes apart; the controls show
# that the check refuses one (``MOE_ROUTER_FAULT``).
MOE_FLIP_MARGIN = 1e-3
# 16b's state check, where a leaf's reading passes its limit in a run that
# routed nothing apart: the leaf may read up to this many times its order
# floor, the reading of the CPU run against itself on one thread (another
# float32 summation order, nothing else changed). A leaf whose whole update
# is a few dozen float32 steps of its parameters (recurrentgemma SMOKE's
# second ``w_i``: 71 at the median over 24 local steps; its moment 2e-6
# apart and its update 2.1e-4 apart between two CPU orders) reads above
# 16b's 1e-4 on any two orders.
ORDER_FLOOR_FACTOR = 2.0
# the MoE control: the router leaves' gradient 5% too large on the card,
# under int8 Star (the run whose tokens route apart), a fault small
# enough to flip near ties first
MOE_ROUTER_FAULT = 1.05


def recording_picks(torch, store: list):
    """``recording_routes`` keeping, on the host, each call's experts and
    each token's top-k margin (``router_margins``)."""
    def keep(r, moe, params, x):
        with torch.no_grad():
            return (r.idx.cpu(),
                    router_margins(torch, params, moe, x).cpu())

    return recording_routes(store, keep)


def picks_apart(torch, cfg, cpu, card, label) -> dict:
    """Where two runs' MoE layer calls (``recording_picks``) chose
    different experts: the calls, the first of them, the tokens, and the
    largest CPU-run margin at such a token; ``explains`` when some token
    was routed apart and every such token sat at a near tie."""
    if cfg.moe is None:
        return {"calls": 0, "explains": False}
    if len(cpu) != len(card):
        raise AssertionError(f"lm {label}: {len(cpu)} MoE calls on the CPU, "
                             f"{len(card)} on the card")
    calls, tokens, first, first_margin, worst = 0, 0, None, None, 0.0
    for i, ((ia, ma), (ib, _)) in enumerate(zip(cpu, card)):
        apart = (ia.sort(dim=-1).values != ib.sort(dim=-1).values).any(-1)
        if apart.any():
            calls += 1
            tokens += int(apart.sum())
            worst = max(worst, float(ma[apart].max()))
            if first is None:
                first, first_margin = i, float(ma[apart].max())
    out = {"calls": calls, "of_calls": len(cpu), "tokens": tokens,
           "first_call": first, "first_margin": first_margin,
           "max_margin_apart": worst,
           "explains": calls > 0 and first_margin < MOE_FLIP_MARGIN}
    if not calls:
        log(f"[lm-check] {cfg.name} {label}: the runs routed every token "
            f"alike in all {len(cpu)} MoE layer calls")
        return out
    log(f"[lm-check] {cfg.name} {label}: the runs routed {tokens} "
        f"token(s) apart in {calls} of {len(cpu)} MoE layer calls; the "
        f"first such call ({first}) at a CPU-run top-{cfg.moe.top_k} margin "
        f"of at most {first_margin:.3g} (a near tie: below "
        f"{MOE_FLIP_MARGIN}), the later ones at up to {worst:.3g}")
    return out


# The int8 KV cache rounds k and v to codes, so where the card's and the
# CPU's k or v differ by their float32 rounding (a few 1e-5 relative after
# two layers), a code whose x/scale sits near a rounding tie can land one
# step apart, and move that cache entry by a whole step (1/127 of the
# row's largest). Such a code is allowed where each run's code is its own
# x/scale rounded half to even (two such codes differ only where a tie
# lies between the quotients), the codes are one step apart and the two
# quotients within KV_GAP of a step of each other (set at about 3x the
# 0.0146 read in PR 22's chip runs); the logits are then held on the
# card's codes.
KV_GAP = 5e-2


def recording_quant(store: list, replay=None):
    """A patch of ``models/attention._quant`` that appends each call's
    (codes, scales, x/scale) on the host to ``store``; with ``replay`` (a
    list of (codes, scales)), each call returns the next of those
    instead, on the call's device."""
    from unittest import mock

    from repro_torch.models import attention as A

    quant = A._quant
    queue = list(replay) if replay is not None else None

    def rec(x):
        q, s = quant(x)
        store.append((q.cpu(), s.cpu(), (x.float() / s[..., None]).cpu()))
        if queue is not None:
            q, s = (t.to(x.device) for t in queue.pop(0))
        return q, s

    return mock.patch.object(A, "_quant", rec)


def codes_apart(torch, cpu, card, label) -> dict:
    """The int8 codes two runs' ``_quant`` calls made apart: how many, the
    largest step between them, and the largest gap between the runs'
    quotients x/scale at such a code; fails unless every code of each run
    is its own quotient rounded half to even (clipped to ±127), and each
    code apart is one step, its quotients within ``KV_GAP``."""
    if len(cpu) != len(card) or not cpu:
        raise AssertionError(f"{label}: {len(cpu)} quantisations on the CPU, "
                             f"{len(card)} on the card")
    apart, step, gap = 0, 0, 0.0
    for (qa, _, xa), (qb, _, xb) in zip(cpu, card):
        for q, x in ((qa, xa), (qb, xb)):
            if not torch.equal(q.int(), x.round().clamp(-127, 127).int()):
                raise AssertionError(f"{label}: a code is not its quotient "
                                     f"rounded half to even")
        d = qa.int() != qb.int()
        if d.any():
            apart += int(d.sum())
            step = max(step, int((qa.int() - qb.int()).abs().max()))
            gap = max(gap, float((xa[d] - xb[d]).abs().max()))
    n = sum(q.numel() for q, _, _ in cpu)
    log(f"[reference] {label}: {apart} of {n} int8 codes apart between the "
        f"card and the CPU, at most {step} step apart, their quotients "
        f"x/scale within {gap:.3g} of a step of each other (allowed: 1 "
        f"step, {KV_GAP})")
    if apart and not (step <= 1 and gap < KV_GAP):
        raise AssertionError(f"{label}: int8 codes apart by more than "
                             f"rounding's")
    return {"codes_apart": apart, "codes": n, "code_step": step,
            "quotient_gap": gap}


def serve_reference_check(torch, arch: str, n_prompt: int,
                          kv_quant: bool = False):
    """Phases 6, 9, 18a and 19a: ``arch``'s SMOKE config in float32 on the
    card against the CPU run (plain versions) on the same weights: an
    ``n_prompt``-token prompt (after a frontend arch's embeddings, float32
    from a seed) through ``prefill``, then 8 decode steps fed the CPU run's
    tokens. gemma2-27b's 80-token prompt is longer than its
    window of 64; mamba2-2.7b's 100-token prompt ends in a short chunk
    (chunk 64). Max logit difference 1e-4: float32 on both sides (TF32
    off), sums in another order through two layers, logits at most 30
    (gemma2, after the final softcap) or a few units (mamba2). A MoE
    arch's expert assignment (experts, ranks, kept) must be equal on both
    routes in every layer call; the smallest top-k router margin of the
    CPU run is logged beside it."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as TF
    from repro_torch.utils.tree import tree_map

    cfg = get_arch(arch, smoke=True).replace(dtype="float32",
                                             kv_quant=kv_quant)
    p_cpu = TF.init_params(cfg, seed=0, device="cpu")
    p_gpu = tree_map(lambda t: t.to("cuda:0"), p_cpu)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(1, n_prompt))).long()
    fe, n_fe = seeded_frontend(torch, cfg)
    runs = {}

    def run(dev, params, replay=None):
        routes, quants = [], []
        keep = lambda r, moe, p, x: (r, float(router_margins(
            torch, p, moe, x).min()))
        with recording_routes(routes, keep), \
                recording_quant(quants, replay):
            cache = TF.init_cache(cfg, 1, n_fe + n_prompt + 16, device=dev)
            logits, cache = TF.prefill(params, cfg, prompt.to(dev), cache,
                                       None if fe is None else fe.to(dev))
            steps = [logits[:, -1].cpu()]
            toks = runs["cpu"]["toks"] if "cpu" in runs else []
            for i in range(8):
                if "cpu" not in runs:
                    toks.append(torch.argmax(steps[-1], dim=-1)[:, None])
                logits, cache = TF.decode_step(params, cfg, toks[i].to(dev),
                                               cache)
                steps.append(logits[:, -1].cpu())
        return {"toks": toks, "logits": torch.stack(steps),
                "routes": routes, "quants": quants}

    for dev, params in (("cpu", p_cpu), ("cuda:0", p_gpu)):
        runs[dev] = run(dev, params)
    err = float((runs["cpu"]["logits"] - runs["cuda:0"]["logits"]).abs()
                .max())
    label = f"{arch}{' kv_quant' if kv_quant else ''}"
    out = {"max_abs_err": err}
    if kv_quant:
        codes = codes_apart(torch, runs["cpu"]["quants"],
                            runs["cuda:0"]["quants"], label)
        out.update(codes)
        if codes["codes_apart"]:
            # the CPU again, on the card's codes: both then attend over the
            # same cache, and the logits must meet the tolerance
            replay = run("cpu", p_cpu, [q[:2] for q in
                                        runs["cuda:0"]["quants"]])
            out["max_abs_err_unreplayed"] = err
            err = float((replay["logits"] - runs["cuda:0"]["logits"]).abs()
                        .max())
            out["max_abs_err"] = err
            log(f"[reference] {label}: the CPU run on the card's codes: max "
                f"|logit diff| {err:.3g} (without them {out['max_abs_err_unreplayed']:.3g})")
    if cfg.moe is not None:
        rc, rg = runs["cpu"]["routes"], runs["cuda:0"]["routes"]
        equal = len(rc) == len(rg) > 0 and all(
            torch.equal(getattr(a, f), getattr(b, f).cpu())
            for (a, _), (b, _) in zip(rc, rg) for f in ("idx", "rank", "keep"))
        margin = min(m for _, m in rc)
        log(f"[reference] {label}: expert assignment (experts, ranks, kept) "
            f"over {len(rc)} layer calls "
            f"{'equal' if equal else 'DIFFERS'} on the card and the CPU; "
            f"smallest top-{cfg.moe.top_k} router margin {margin:.3g}")
        if not equal:
            raise AssertionError(f"serve reference {label}: expert "
                                 f"assignment differs")
        out.update(assignment_equal=True, layer_calls=len(rc),
                   min_router_margin=margin)
    log(f"[reference] {label} smoke f32, "
        f"{f'{n_fe} frontend embeddings + ' if n_fe else ''}{n_prompt}-token "
        f"prompt + 8 decode steps: card vs CPU max |logit diff| {err:.3g} "
        f"(tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"serve reference {label}: card vs CPU {err}")
    return out


def seeded_frontend(torch, cfg):
    """A frontend arch's (1, n_fe, frontend_dim) float32 embeddings from a
    seed, and n_fe; (None, 0) for any other arch."""
    import numpy as np

    if cfg.frontend is None:
        return None, 0
    fe = np.random.RandomState(1).randn(1, cfg.n_frontend_tokens,
                                        cfg.frontend_dim)
    return torch.from_numpy(fe.astype(np.float32)), cfg.n_frontend_tokens


def kernel_layers(cfg, kname: str) -> int:
    """The layers of ``cfg`` whose multi-token call launches ``kname``
    once: the attention layers for flash attention, the Mamba2 layers for
    the SSD scan."""
    kinds = cfg.layer_kinds()
    if kname == "flash_attention":
        return sum(k in "GL" for k in kinds)
    return kinds.count("M")


# The two full-width serving cells: arch, slots, Poisson requests, the
# long prompt's length and outputs, the kernel each prefill launches once per
# layer, and whether a one-token prompt joins a used slot after the drain.
# Phase 18's cells add a depth cut (``layers``; since phase 19 joined the
# script, gemma2's, mamba2's and gemma3's cells are cut too, for the run's
# time, and since phase 22 did, to a quarter of their depth, with
# recurrentgemma's and internvl2's cut to half), the slots' length
# (``max_seq_len``, default 6,144) and the int8 KV cache (``kv_quant``);
# phase 19's frontend requests (``frontend``: each request carries its own
# embeddings, float32 from a seed, its prompt drawn in ``prompt_range``)
# and a long prompt used for the timings alone (``long_request`` False).
SERVE_CELLS = {
    "gemma2-27b": dict(n_slots=4, n_requests=6, long_len=4608, long_out=24,
                       kernel="flash_attention", one_token=False,
                       layers=12),
    "mamba2-2.7b": dict(n_slots=8, n_requests=12, long_len=4000, long_out=24,
                        kernel="ssd", one_token=True, layers=16),
    "deepseek-v2-236b": dict(n_slots=4, n_requests=6, long_len=3000,
                             long_out=16, kernel="flash_attention",
                             one_token=False, layers=4, max_seq_len=4096),
    "gemma3-12b": dict(n_slots=4, n_requests=4, long_len=4608, long_out=16,
                       kernel="flash_attention", one_token=False,
                       kv_quant=True, layers=12),
    "recurrentgemma-2b": dict(n_slots=4, n_requests=6, long_len=4608,
                              long_out=24, kernel="flash_attention",
                              one_token=False, layers=13),
    "internvl2-2b": dict(n_slots=4, n_requests=6, long_len=1024,
                         long_out=16, kernel="flash_attention",
                         one_token=False, max_seq_len=2048, frontend=True,
                         prompt_range=(64, 512), long_request=False,
                         layers=12),
}


def serve_full_width(torch, arch: str, extra=None):
    """Phases 7, 10, 18b, 18c, 19b and 19d: ``arch`` at full width behind
    ServeEngine. ``extra(torch, cfg, params, long_prompt, sched)``, where
    given, adds its checks' results to the returned dict."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as TF
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.series import SeriesRegistry
    from repro_torch.serve import (Request, SchedulerConfig, ServeEngine,
                                   TrafficConfig, generate_requests)
    from repro_torch.utils.tree import tree_leaves

    cell = SERVE_CELLS[arch]
    dev = torch.device("cuda:0")
    cfg = get_arch(arch).replace(kv_quant=cell.get("kv_quant", False))
    if cell.get("layers"):
        log(f"[cut] {arch} serving: full width, depth cut to "
            f"{cell['layers']} of {cfg.n_layers} layers")
        cfg = cfg.replace(n_layers=cell["layers"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = TF.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] {arch}: {n_params / 1e9:.2f} B params in {cfg.dtype}"
        f" made on the card in {time.monotonic() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    sched = SchedulerConfig(n_slots=cell["n_slots"],
                            max_seq_len=cell.get("max_seq_len", 6144))
    eng = ServeEngine(cfg, params, scheduler=sched)
    rate = 0.7 * sched.n_slots / eng.decode_step_s   # launch/serve's rule
    reqs = generate_requests(TrafficConfig(
        process="poisson", n_requests=cell["n_requests"],
        mean_prompt_len=512, max_prompt_len=2048, mean_out_len=16,
        max_out_len=32, seed=0, rate_rps=rate), cfg.vocab_size)
    n = len(reqs)
    if cell.get("frontend"):
        rng = np.random.RandomState(2)
        lo, hi = cell["prompt_range"]
        reqs = [dataclasses.replace(
            r, prompt=rng.randint(0, cfg.vocab_size, size=(
                int(rng.randint(lo, hi + 1)),)).astype(np.int32),
            frontend=rng.randn(cfg.n_frontend_tokens, cfg.frontend_dim)
            .astype(np.float32)) for r in reqs]
    long_prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(cell["long_len"],)).astype(np.int32)
    if cell.get("long_request", True):
        reqs.append(Request(id=n, arrival_s=reqs[2].arrival_s,
                            prompt=long_prompt, n_out=cell["long_out"]))
    if cell["one_token"]:
        # after every earlier request has drained (the modeled clock runs
        # prefills and decode steps one after another): lands in slot 0
        drained = max(r.arrival_s for r in reqs) + sum(
            eng.prefill_s(r) + r.n_out * eng.decode_step_s for r in reqs)
        reqs.append(Request(id=n + 1, arrival_s=drained,
                            prompt=np.array([11], np.int32), n_out=6))
    fe_txt = (f", each after {cfg.n_frontend_tokens} frontend embeddings"
              if cell.get("frontend") else "")
    log(f"[serve] requests (prompt, n_out): "
        f"{[(r.prompt_len, r.n_out) for r in reqs]}{fe_txt}"
        f"; rate {rate:.1f} rps, "
        f"modeled decode step {eng.decode_step_s * 1e3:.3f} ms")

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    report = eng.run(reqs, registry=MetricsRegistry(),
                     series=SeriesRegistry())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(r.tokens) for r in report.records)
    log(f"[serve] run: {report.n_prefills} prefills, {report.n_steps} decode"
        f" steps, {tokens} tokens in {wall:.2f} s wall ({tokens / wall:.2f} "
        f"tok/s measured, {report.modeled_tok_s:.1f} tok/s modeled), "
        f"modeled makespan {report.makespan_s:.4f} s, mean occupancy "
        f"{report.mean_occupancy:.2f}, peak memory {peak / 1e9:.2f} GB, "
        f"launches {counts}")
    if len(report.completed) != len(reqs) or any(
            len(r.tokens) != r.n_out for r in report.records):
        raise AssertionError(f"serve {arch}: not every request completed")
    kname = cell["kernel"]
    # a one-token prompt takes the decode branch: no kernel launch
    multi = sum(1 for r in reqs if r.prompt_len > 1 or r.frontend is not None)
    if report.n_prefills != len(reqs) or \
            counts[kname] != kernel_layers(cfg, kname) * multi:
        raise AssertionError(f"serve {arch}: {kname} launched "
                             f"{counts[kname]} times for {multi} "
                             f"multi-token prefills")
    if not math.isfinite(report.makespan_s) or report.makespan_s <= 0:
        raise AssertionError(f"serve {arch}: makespan {report.makespan_s}")
    if cell["one_token"]:
        rec = report.records[-1]
        used = [r.id for r in report.records[:-1] if r.slot == rec.slot
                and r.finish_s <= rec.admit_s]
        if not used:
            raise AssertionError(f"serve {arch}: the one-token prompt did "
                                 f"not land in a used slot")
        log(f"[serve] one-token request {rec.id} in slot {rec.slot}, used "
            f"before by requests {used}")

    compared, total = hold_to_greedy(torch, arch, params, cfg, reqs,
                                     report.records, sched.max_seq_len)
    log(f"[serve] tokens held to greedy_decode: {compared} of {total}")
    del eng
    torch.cuda.empty_cache()
    step = time_serve_steps(torch, cfg, params, sched, long_prompt)
    more = {} if extra is None else extra(torch, cfg, params, long_prompt,
                                          sched)
    return {"arch": arch, "wall_s": wall, "tok_s": tokens / wall,
            "tokens": tokens, "n_prefills": report.n_prefills,
            "n_steps": report.n_steps, "peak_gb": peak / 1e9,
            "makespan_s": report.makespan_s,
            "modeled_tok_s": report.modeled_tok_s,
            "tokens_compared": compared, "tokens_total": total,
            "launches": counts[kname], **step, **more}


def hold_to_greedy(torch, arch, params, cfg, reqs, records, max_seq_len):
    """Each request's served tokens against ``greedy_decode`` on the same
    params: the first token equal, each later one equal until the first
    whose top-2 logit gap is under ``MARGIN_TOL`` (a near tie the batched
    and the single-row products may break apart). Returns (tokens
    compared, tokens served)."""
    from repro_torch.core.serving import greedy_decode
    from repro_torch.utils.tree import tree_leaves

    dev = tree_leaves(params)[0].device
    compared = total = 0
    for r, rec in zip(reqs, records):
        prompt = torch.as_tensor(r.prompt[None], dtype=torch.long,
                                 device=dev)
        # a request's frontend goes to the card as bfloat16, as the engine
        # hands it over
        fe = (None if r.frontend is None else torch.as_tensor(
            r.frontend[None]).to(dev, torch.bfloat16))
        ref, margin = greedy_decode(params, cfg, prompt, r.n_out,
                                    max_seq_len, frontend=fe)
        ref, margin = ref[0].tolist(), margin[0].tolist()
        if rec.tokens[0] != ref[0]:
            raise AssertionError(f"serve {arch}: request {r.id} first token "
                                 f"{rec.tokens[0]} != greedy {ref[0]}")
        k = 1
        for i in range(1, r.n_out):
            if margin[i] < MARGIN_TOL:
                break
            if rec.tokens[i] != ref[i]:
                raise AssertionError(
                    f"serve {arch}: request {r.id} token {i}: "
                    f"{rec.tokens[i]} != greedy {ref[i]} at top-2 margin "
                    f"{margin[i]:.3f}")
            k += 1
        compared += k
        total += r.n_out
        log(f"[serve] request {r.id}: prompt {r.prompt_len}, slot "
            f"{rec.slot}, {k}/{r.n_out} tokens compared, equal to "
            f"greedy_decode (min margin {min(margin):.3f})")
    return compared, total


def time_serve_steps(torch, cfg, params, sched, long_prompt):
    """Host-clock times (synchronized) of a 512-token and the long prefill
    (a frontend arch's after its embeddings) and of the full-width decode
    step, then torch.profiler over one prefill and 4 decode steps: the top
    device ops."""
    from repro_torch.models import transformer as TF

    dev = torch.device("cuda:0")
    fe, _ = seeded_frontend(torch, cfg)
    fe = None if fe is None else fe.to(dev, torch.bfloat16)
    stacked = TF.init_cache(cfg, sched.n_slots, sched.max_seq_len, device=dev)
    toks = torch.zeros((sched.n_slots, 1), dtype=torch.long, device=dev)
    long_prompt = torch.as_tensor(long_prompt[None], dtype=torch.long,
                                  device=dev)
    n_long = long_prompt.shape[1]
    prompts = {512: long_prompt[:, :512], n_long: long_prompt}

    def prefill(n, slot=0):
        logits, _ = TF.prefill(params, cfg, prompts[n],
                               TF.cache_rows(stacked, slot, slot + 1), fe)
        return logits

    out = {}
    with torch.no_grad():
        for n in (512, n_long):
            prefill(n)                   # warm-up
            torch.cuda.synchronize()
            ts = []
            for _ in range(3):
                t0 = time.monotonic()
                prefill(n)
                torch.cuda.synchronize()
                ts.append(time.monotonic() - t0)
            out[f"prefill_{n}_ms"] = statistics.median(ts) * 1e3
        for slot in range(sched.n_slots):
            prefill(512, slot)
        TF.decode_step(params, cfg, toks, stacked)
        torch.cuda.synchronize()
        ts = []
        for _ in range(8):
            t0 = time.monotonic()
            TF.decode_step(params, cfg, toks, stacked)
            torch.cuda.synchronize()
            ts.append(time.monotonic() - t0)
        out["decode_step_ms"] = statistics.median(ts) * 1e3
        log(f"[serve] {cfg.name}: prefill 512 tokens "
            f"{out['prefill_512_ms']:.1f} ms, prefill {n_long} tokens "
            f"{out[f'prefill_{n_long}_ms']:.1f} ms, decode step "
            f"({sched.n_slots} slots) {out['decode_step_ms']:.2f} ms (host "
            f"clock, synchronized, median)")

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            prefill(512)
            for _ in range(4):
                TF.decode_step(params, cfg, toks, stacked)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if not kern:
        log(f"[profile] serve {cfg.name}: {wall * 1e3:.1f} ms; device time "
            f"not measured (no CUDA events traced)")
        return out
    log(f"[profile] serve {cfg.name}, one 512-token prefill + 4 decode "
        f"steps: wall "
        f"{wall * 1e3:.1f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / (wall * 1e6):.1f}% of "
        f"wall), {sum(e.count for e in kern)} kernels")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")
    out["profile_busy_ms"] = busy_us / 1e3
    out["profile_wall_ms"] = wall * 1e3
    return out


# -- phases 11-13: the adaptive period and the event runtime ----------------

# Phase 11: Table 4's configuration at its full scale
# (benchmarks/table4_comm_cost.py:49-72): logreg d=123, n=16,384, N=32,
# B=32, lambda 1e-3; "adaptive" (stl_sc's schedule, T1 = 2048 // 4, k1 = 2
# as the cap, eta1 = 0.5, threshold 3e-4), int8 over Star, 6 stages; run 2
# of them (3 before phase 19 joined the script: the run's time).
TABLE4 = {"n": 16384, "d": 123, "clients": 32, "T1": 512, "stages": 6,
          "run_stages": 2}
# Phases 12-13: Table 5's configuration at its full scale
# (benchmarks/table5_straggler.py:96-118, 196): logreg d=123, n=16,384, N=8,
# B=32, eta1 = 0.5, stl_sc with T1 = 1024 // 4 and k1 = 2 over 6 stages,
# int8, 25% stragglers at 4x, 1 ms a local step; dropout 0.1 (the masked
# round, and dropped async jobs). The sync run 2 of the 6 stages (3 before
# phase 19 joined the script), the async run 2.
TABLE5 = {"n": 16384, "d": 123, "clients": 8, "T1": 256, "stages": 6,
          "run_stages": 2, "async_stages": 2}
# Table 5's streaming axis at its full scale (table5_straggler.py:121-142):
# the MLP (d = 96, width 96, depth 3, 8 leaves) on n = 4,096, N = 8, sync
# (k = 1), dense, datacenter link
TABLE5_MLP = {"n": 4096, "d": 96, "width": 96, "depth": 3, "clients": 8}
# Phase 14: Table 4's hierarchical row at its full scale
# (benchmarks/table4_comm_cost.py:75-116): Table 4's logreg problem (d=123,
# n=16,384, N=32, B=32, lambda 1e-3), stl_sc with T1 = 2048 // 4 and k1 = 2
# over 6 stages, "hier": a dense intra-pod hop and an int8 inter-pod hop
# over 2 pods; then int8 on both hops. Table 5d's streaming∘hierarchical
# axis at its full size (table5_straggler.py:250-318): Table 5's MLP, sync,
# 2 pods, a billed downlink, 25% stragglers at 4x.
TABLE4_HIER = {"pods": 2, "run_stages": 2, "check_stages": 1}
# one client's upload of one leaf: the (1, M) blocks of the async path
# (the Table 4/5 logreg leaf, the Table 5 MLP's leaf sizes)
# then the stacked blocks phases 11-12 hand quantize and dequant_mean: the
# logreg leaf of Table 4's 32 clients and of Table 5's 8 (123 is not a
# multiple of 4, so every row goes through quantize's scalar instantiation)
PATH_SHAPES = {"logreg theta 1-row": (1, 123),
               "mlp w 1-row": (1, 96 * 96),
               "mlp b 1-row": (1, 96),
               "mlp out.b 1-row": (1, 1),
               "table4 logreg theta": (TABLE4["clients"], 123),
               "table5 logreg theta": (TABLE5["clients"], 123),
               # phase 14's two-level rounds: one pod's block on the
               # intra hop, the pod means' block on the inter hop (Table
               # 4's logreg leaf; Table 5d's largest MLP leaf)
               "table4 hier pod theta": (
                   TABLE4["clients"] // TABLE4_HIER["pods"], 123),
               "table4 hier inter theta": (TABLE4_HIER["pods"], 123),
               "table5d hier pod w": (
                   TABLE5["clients"] // TABLE4_HIER["pods"], 96 * 96),
               "table5d hier inter w": (TABLE4_HIER["pods"], 96 * 96)}


def log_cut(phase: str, what: str, run: int, of: int):
    log(f"[cut] {phase}: {what}, {run} of {of} stages")


def expect_launches(label: str, counts: dict, want: dict):
    """Fail unless every training kernel launched as the path says."""
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def probed(base):
    """``base`` (a backend class) recording each adaptive step's replica
    divergence (left on the device; the loop reads it anyway) and each
    stage's (k-cap, round lengths)."""

    class Probed(base):
        def setup(self, engine):
            super().setup(engine)
            self.divs, self.round_steps = [], []

        def _adaptive_fns(self, engine, b):
            step_fn, sync_fn = super()._adaptive_fns(engine, b)

            def step(*a):
                t, div = step_fn(*a)
                self.divs.append(div)
                return t, div
            return step, sync_fn

        def run_stage(self, stage, engine):
            status = super().run_stage(stage, engine)
            self.round_steps.append((stage.k, list(self._last_round_steps)))
            return status

    return Probed


def logreg_problem(torch, dev, n, d, clients, lam=1e-3):
    """Table 4/5's logreg problem on ``dev``: (loss, eval, p0, data)."""
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.models import logreg

    x, y = make_binary_classification(n=n, d=d, seed=0)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in partition_iid(x, y, clients, seed=1).items()}
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    return (lambda p, b: logreg.loss_fn(p, b, lam),
            lambda p: logreg.full_objective(p, xt, yt, lam),
            logreg.init_params(d, device=dev), data)


def check_objective(label: str, vals):
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{label}: non-finite objective")
    if not vals[-1] < 0.9 * vals[0]:
        raise AssertionError(f"{label}: objective {vals[-1]} did not fall "
                             f"below 0.9 x {vals[0]}")


def recording_int8(calls: list):
    """An int8 ``QuantizedMean`` that appends each leaf block it encodes
    to ``calls``, as (y, bits, scales, codes) on the block's device."""
    from repro_torch.comm.reducer import QuantizedMean
    from repro_torch.kernels.quantize import ops as Q

    class Recording(QuantizedMean):
        def _compress(self, y, rng, shards=None):
            assert shards is None, "recording_int8 runs on one device"
            scales = Q.compute_scale(y, dim=1)
            rbits = rng.bits(y.shape)
            q = Q.encode_leaf(y, rbits, scales, bits=self.bits)
            calls.append((y.clone(), rbits, scales.clone(), q))
            return Q.decode_mean_leaf(q, scales, bits=self.bits)

    return Recording(bits=8)


def adaptive_pair(torch, model: str, reducer, seed: int = 0):
    """The adaptive period on the CPU and on the card, on one small input
    and the same draws (key ``seed``): {device: (per-step divergences,
    per-stage (cap, round lengths), history values, encoded blocks)}."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.engine import Engine
    from repro_torch.models import mlp
    from repro_torch.utils.rng import TorchKey

    if model == "logreg":
        cfg = TrainConfig(algo="adaptive", eta1=0.5, T1=32, k1=4.0,
                          n_stages=3, batch_per_client=8, seed=0)
    else:   # the GPU tests' runtime MLP
        cfg = TrainConfig(algo="adaptive", eta1=0.5, T1=16, k1=4.0,
                          n_stages=2, batch_per_client=8, seed=0)
    out = {}
    for dev in ("cpu", "cuda"):
        tdev = torch.device(dev)
        if model == "logreg":
            loss, ev, p0, data = logreg_problem(torch, tdev, 512, 32, 4,
                                                lam=1e-2)
        else:
            x, y = make_binary_classification(n=256, d=32, seed=0)
            data = {k: torch.from_numpy(v).to(tdev)
                    for k, v in partition_iid(x, y, 4, seed=1).items()}
            xt, yt = torch.from_numpy(x).to(tdev), torch.from_numpy(y).to(tdev)
            p0 = mlp.init_params(32, width=16, depth=3, device=tdev)
            loss = lambda p, b: mlp.loss_fn(p, b, 1e-3)
            ev = lambda p, xt=xt, yt=yt: mlp.full_objective(p, xt, yt, 1e-3)
        calls = []
        red = recording_int8(calls) if reducer == "int8" else reducer
        backend = probed(simulate.VmapSimulatorBackend)(
            loss, p0, data, ev, device=dev,
            rng=HostKey(TorchKey(seed), tdev))
        hist = Engine(cfg.algo, cfg, reducer=red).run(backend)
        out[dev] = ([float(d) for d in backend.divs], backend.round_steps,
                    [r.value for r in hist], calls)
    return out


def adaptive_reference_check(torch):
    """Phase 11a: the adaptive period on the card against the CPU run on
    one small input and the same draws. Logreg dense: the same round
    lengths in every stage, each step's replica divergence within 1e-5
    relative, the history within 1e-5. Logreg int8: the same round
    lengths, the history within 1e-4. Then the int8 MLP on three seeds,
    whose history may part from the CPU's by more: every block the card
    encoded is bit-equal to the plain version on the card's own inputs
    (so the kernel is not at fault), and the log records, per seed, the
    first round whose codes differ between the two runs, how many codes
    differ, how far apart the encoded inputs were there, and the history
    gap before and after it."""
    from repro_torch.kernels.quantize.ref import quantize_ref

    for reducer, tol in (("dense", 1e-5), ("int8", 1e-4)):
        out = adaptive_pair(torch, "logreg", reducer)
        (dc, sc, hc, _), (dg, sg, hg, _) = out["cpu"], out["cuda"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(dg, dc))
        err = max(abs(a - b) for a, b in zip(hg, hc))
        log(f"[adaptive] logreg {reducer} card vs CPU: {len(dc)} steps, "
            f"{sum(len(s) for _, s in sc)} rounds, round lengths equal "
            f"{sg == sc}, divergence max rel diff {rel:.3g}, history max "
            f"|diff| {err:.3g} (tol {tol})")
        if sg != sc or len(dg) != len(dc) or not err <= tol \
                or (reducer == "dense" and not rel <= 1e-5):
            raise AssertionError(f"adaptive {reducer}: card run disagrees "
                                 f"with the CPU run (rounds equal: "
                                 f"{sg == sc}, {rel}, {err})")
    for seed in (0, 1, 2):
        out = adaptive_pair(torch, "mlp", "int8", seed)
        (_, sc, hc, qc), (_, sg, hg, qg) = out["cpu"], out["cuda"]
        for y, rb, sc_, q in qg:
            if not torch.equal(q, quantize_ref(y, rb, sc_[:, None], bits=8)):
                raise AssertionError(f"mlp int8 seed {seed}: quantize on "
                                     f"the card disagrees with the plain "
                                     f"version on the card's inputs")
        leaves = 8
        flips = [int((a[3] != b[3].cpu()).sum()) for a, b in zip(qc, qg)]
        first = next((i for i, f in enumerate(flips) if f), None)
        gap = [abs(a - b) for a, b in zip(hg, hc)]
        if first is None:
            log(f"[adaptive] mlp int8 seed {seed}: no code differs over "
                f"{len(qg)} blocks; history max |diff| {max(gap):.3g}")
            continue
        rnd = first // leaves + 1   # history record i is after round i
        dy = float((qc[first][0] - qg[first][0].cpu()).abs().max())
        log(f"[adaptive] mlp int8 seed {seed}: first differing codes in "
            f"round {rnd} (leaf {first % leaves}): {flips[first]} of "
            f"{qg[first][3].numel()} codes, encoded inputs max |diff| "
            f"{dy:.3g}; {sum(flips)} codes differ over {min(len(qc), len(qg))}"
            f" blocks; round lengths equal {sg == sc}; history max |diff| "
            f"before it {max(gap[:rnd], default=0.0):.3g}, after "
            f"{max(gap[rnd:], default=0.0):.3g}")


def run_adaptive(torch, dev="cuda:0"):
    """Phase 11: Table 4's adaptive run at full width, cut in stages."""
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.engine import Engine

    dev = torch.device(dev)
    t4 = TABLE4
    log_cut("phase 11", "Table 4 adaptive (logreg d=123, N=32, int8)",
            t4["run_stages"], t4["stages"])
    loss, ev, p0, data = logreg_problem(torch, dev, t4["n"], t4["d"],
                                        t4["clients"])
    cfg = TrainConfig(algo="adaptive", eta1=0.5, T1=t4["T1"], k1=2.0,
                      n_stages=t4["run_stages"], iid=True,
                      batch_per_client=32, reducer="int8", seed=0)
    engine = Engine(cfg.algo, cfg)
    backend = probed(simulate.VmapSimulatorBackend)(loss, p0, data, ev,
                                                    device=dev,
                                                    eval_every=64)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    hist = engine.run(backend)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    rep = engine.report
    vals = [r.value for r in hist]
    check_objective("adaptive", vals)
    rounds = sum(len(s) for _, s in backend.round_steps)
    by_cap = 0
    for (cap, steps), st in zip(backend.round_steps, engine.stages):
        if any(n > cap for n in steps) or sum(steps) != st.T:
            raise AssertionError(f"adaptive stage {st.s}: round lengths "
                                 f"{steps} against cap {cap}, T {st.T}")
        by_cap += sum(n == cap for n in steps[:-1])
        log(f"[adaptive] stage {st.s}: k-cap {cap}, {len(steps)} rounds, "
            f"{st.T / len(steps):.3f} steps a round")
    if (rounds, len(backend.divs)) != (rep.rounds_total, rep.iters_total):
        raise AssertionError(f"adaptive: {rounds} rounds recorded, "
                             f"{rep.rounds_total} run")
    # one fused update per local step; one quantize and one dequant_mean
    # per leaf (one) per *triggered* round
    expect_launches("adaptive", counts,
                    {"fused_sgd_update": rep.iters_total,
                     "quantize_kernel": rounds,
                     "dequant_mean_kernel": rounds})
    log(f"[adaptive] rounds {rounds} ({by_cap} ended at the cap, the rest "
        f"by the threshold or the stage's end), iterations "
        f"{rep.iters_total}, wall {wall:.2f} s ({wall * 1e3 / rep.iters_total:.3f}"
        f" ms a step), objective {vals[0]:.6f} -> {vals[-1]:.6f}, comm bytes "
        f"{rep.comm_bytes_total}, launches {counts}")
    return {"counts": counts, "wall_s": wall, "rounds": rounds,
            "iters": rep.iters_total, "objective": [vals[0], vals[-1]],
            "round_steps": [s for _, s in backend.round_steps]}


def masked_probe(base):
    """``base`` (a backend class) that watches the first round of its run
    in which a client drops: the parameters and moments before the round
    and at the round's reduce (after its k local steps, before the
    consensus overwrites them), in ``self.masked`` = (mask, before,
    at_reduce)."""
    from repro_torch.core import simulate
    from repro_torch.utils.tree import tree_leaves

    class Masked(base):
        masked = None

        def _round_fn(self, engine, k, b):
            inner = super()._round_fn(engine, k, b)

            def round_fn(carry, key_r, data, center, eta, mask=None):
                if self.masked is not None or mask is None or mask.all():
                    return inner(carry, key_r, data, center, eta, mask)
                leaves = tree_leaves(carry[0]) + tree_leaves(carry[1])
                before = [t.clone() for t in leaves]
                sync = simulate._sync_

                def seen(*a):
                    self.masked = (mask, before, [t.clone() for t in leaves])
                    return sync(*a)

                simulate._sync_ = seen
                try:
                    return inner(carry, key_r, data, center, eta, mask)
                finally:
                    simulate._sync_ = sync

            return round_fn

    return Masked


def check_masked(torch, backend):
    """Phase 12a: in the masked round ``masked_probe`` watched, every
    dropped client's rows are exactly as they were, and the present
    clients' rows moved."""
    if backend.masked is None:
        raise AssertionError("masked round: no client dropped in the run")
    mask, before, after = backend.masked
    drop = torch.from_numpy(~mask).to(before[0].device)
    for old, new in zip(before, after):
        if not torch.equal(old[drop], new[drop]):
            raise AssertionError("masked round: a dropped client's rows "
                                 "moved")
        if torch.equal(old[~drop], new[~drop]):
            raise AssertionError("masked round: the present clients did "
                                 "not move")
    log(f"[runtime] masked round: clients "
        f"{[i for i, m in enumerate(mask) if not m]} of {len(mask)} "
        f"dropped; their rows unchanged at the reduce, the others moved")


def run_runtime_sync(torch, dev="cuda:0"):
    """Phase 12: Table 5's synchronous runtime at full width (stl_sc, int8,
    stragglers, dropout through the masked round), then the MLP's
    streaming axis against its blocking twin."""
    from repro_torch import kernels, runtime
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.engine import Engine
    from repro_torch.models import mlp
    from repro_torch.utils.tree import tree_leaves

    dev = torch.device(dev)
    t5 = TABLE5
    log_cut("phase 12", "Table 5 stl_sc sync (logreg d=123, N=8, int8, "
            "25% stragglers at 4x, dropout 0.1)", t5["run_stages"],
            t5["stages"])
    loss, ev, p0, data = logreg_problem(torch, dev, t5["n"], t5["d"],
                                        t5["clients"])
    kw = dict(algo="stl_sc", eta1=0.5, T1=t5["T1"], k1=2.0,
              n_stages=t5["run_stages"], iid=True, batch_per_client=32,
              seed=0, reducer="int8", base_step_time_s=1e-3,
              dropout_rate=0.1)
    cfg = TrainConfig(straggler_frac=0.25, straggler_slowdown=4.0, **kw)
    # the run as runtime.run wires it, its backend watching the first
    # masked round
    engine = Engine(cfg.algo, cfg)
    backend = masked_probe(runtime.EventBackend)(loss, p0, data, ev,
                                                 device=dev, eval_every=16)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    history = engine.run(backend)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    rep = engine.report
    check_masked(torch, backend)
    vals = [r.value for r in history]
    check_objective("runtime sync", vals)
    expect_launches("runtime sync", counts,
                    {"fused_sgd_update": rep.iters_total,
                     "quantize_kernel": rep.rounds_total,
                     "dequant_mean_kernel": rep.rounds_total})
    dropped = sum(e[1] == "dropout" for e in backend.trace)
    wall_clock = backend.clock.now
    even = runtime.run(loss, p0, data, TrainConfig(**kw), ev, device=dev,
                       eval_every=16)
    if not (math.isfinite(wall_clock) and wall_clock > even.wall_clock_s):
        raise AssertionError(f"runtime sync: wall clock {wall_clock} "
                             f"with stragglers, {even.wall_clock_s} without")
    if [(r.round, r.value) for r in even.history] != \
            [(r.round, r.value) for r in history] or not dropped:
        raise AssertionError("runtime sync: stragglers moved the history, "
                             "or no client dropped")
    log(f"[runtime] sync: rounds {rep.rounds_total}, iterations "
        f"{rep.iters_total}, {dropped} client-rounds dropped, wall "
        f"{wall:.2f} s, modeled wall {wall_clock:.4f} s (without stragglers "
        f"{even.wall_clock_s:.4f} s, same history), objective "
        f"{vals[0]:.6f} -> {vals[-1]:.6f}, launches {counts}")
    launches = dict(counts)

    tm = TABLE5_MLP
    x, y = make_binary_classification(n=tm["n"], d=tm["d"], seed=0)
    mdata = {k: torch.from_numpy(v).to(dev)
             for k, v in partition_iid(x, y, tm["clients"], seed=1).items()}
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    mp0 = mlp.init_params(tm["d"], width=tm["width"], depth=tm["depth"],
                          seed=0, device=dev)
    n_leaves = len(tree_leaves(mp0))
    out = {}
    for sched in ("blocking", "streaming"):
        mcfg = TrainConfig(algo="sync", eta1=0.1, T1=32, n_stages=2,
                           batch_per_client=32, seed=0, reducer="dense",
                           upload_schedule=sched, comm_latency_s=1e-4,
                           comm_bandwidth_gbps=0.45, base_step_time_s=1e-3,
                           straggler_frac=0.25, straggler_slowdown=4.0)
        kernels.reset_launch_counts()
        out[sched] = runtime.run(
            lambda p, b: mlp.loss_fn(p, b, 1e-3), mp0, mdata, mcfg,
            lambda p: mlp.full_objective(p, xt, yt, 1e-3), device=dev,
            eval_every=16)
        torch.cuda.synchronize()
        mcounts = kernels.launch_counts()
        expect_launches(f"mlp {sched}", mcounts,
                        {"fused_sgd_update": out[sched].iters,
                         "quantize_kernel": 0, "dequant_mean_kernel": 0})
        for k in TRAIN_KERNELS:
            launches[k] += mcounts[k]
    blk, stm = out["blocking"], out["streaming"]
    same = ([(r.round, r.value) for r in blk.history]
            == [(r.round, r.value) for r in stm.history]
            and all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(blk.params), tree_leaves(stm.params))))
    if not same or not stm.wall_clock_s < blk.wall_clock_s:
        raise AssertionError(f"streaming mlp: bit-equal {same}, modeled "
                             f"wall {stm.wall_clock_s} against blocking "
                             f"{blk.wall_clock_s}")
    check_objective("streaming mlp", [r.value for r in stm.history])
    log(f"[runtime] mlp ({n_leaves} leaves, sync, dense): streaming history "
        f"and params bit-equal to blocking; modeled wall {stm.wall_clock_s:.4f}"
        f" s against {blk.wall_clock_s:.4f} s "
        f"({blk.wall_clock_s / stm.wall_clock_s:.3f}x), {stm.rounds} rounds")
    return {"launches": launches, "wall_s": wall,
            "modeled_wall_s": wall_clock,
            "modeled_wall_even_s": even.wall_clock_s,
            "streaming_s": stm.wall_clock_s, "blocking_s": blk.wall_clock_s,
            "objective": [vals[0], vals[-1]]}


def async_cfg(**kw):
    from repro_torch.configs.base import TrainConfig

    t5 = TABLE5
    return TrainConfig(algo="stl_sc+async", eta1=0.5, T1=t5["T1"], k1=2.0,
                       n_stages=t5["async_stages"], iid=True,
                       batch_per_client=32, seed=0, reducer="staleness-int8",
                       base_step_time_s=1e-3, straggler_frac=0.25,
                       straggler_slowdown=4.0, dropout_rate=0.1, **kw)


def run_runtime_async(torch, dev="cuda:0"):
    """Phase 13: Table 5's stl_sc+async with staleness-int8 messages, cut
    in stages: merges a second of host wall and the median staleness (the
    device's busy share comes from ``profile_runtime_async``)."""
    from repro_torch import kernels, runtime
    from repro_torch.obs.series import SeriesRegistry

    dev = torch.device(dev)
    t5 = TABLE5
    log_cut("phase 13", "Table 5 stl_sc+async (logreg d=123, N=8, "
            "staleness-int8, 25% stragglers at 4x, dropout 0.1)",
            t5["async_stages"], t5["stages"])
    loss, ev, p0, data = logreg_problem(torch, dev, t5["n"], t5["d"],
                                        t5["clients"])
    series = SeriesRegistry()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    res = runtime.run(loss, p0, data, async_cfg(), ev, device=dev,
                      eval_every=16, series=series)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    vals = [r.value for r in res.history]
    check_objective("runtime async", vals)
    # one fused update per client local step (dropped jobs' included);
    # one quantize and one dequant_mean per leaf (one) per merged upload
    expect_launches("runtime async", counts,
                    {"fused_sgd_update": res.iters,
                     "quantize_kernel": res.rounds,
                     "dequant_mean_kernel": res.rounds})
    drops = sum(e[1] == "drop" for e in res.trace)
    stale = series["runtime.merge_staleness"].values()
    median = statistics.median(stale)
    log(f"[runtime] async: {res.rounds} merges ({drops} jobs dropped), "
        f"{res.iters} client local steps, wall {wall:.2f} s: "
        f"{res.rounds / wall:.1f} merges a second of host wall; median "
        f"staleness {median:.4f} (max {max(stale):.4f}); modeled wall "
        f"{res.wall_clock_s:.4f} s, objective {vals[0]:.6f} -> "
        f"{vals[-1]:.6f}, launches {counts}")

    return {"launches": counts, "wall_s": wall, "merges": res.rounds,
            "merges_per_s": res.rounds / wall, "median_staleness": median,
            "modeled_wall_s": res.wall_clock_s,
            "objective": [vals[0], vals[-1]]}


def profile_runtime_async(torch, dev="cuda:0") -> dict:
    """Phase 13's profile: torch.profiler over a short run of phase 13's
    configuration (256 merges), after a warm-up run; the device's busy
    share of the wall and the top device ops."""
    from repro_torch import runtime

    dev = torch.device(dev)
    t5 = TABLE5
    loss, ev, p0, data = logreg_problem(torch, dev, t5["n"], t5["d"],
                                        t5["clients"])
    runtime.run(loss, p0, data, async_cfg(), ev, device=dev, eval_every=16,
                max_rounds=32)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        short = runtime.run(loss, p0, data, async_cfg(), ev, device=dev,
                            eval_every=16, max_rounds=256)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    out = {"merges": short.rounds, "local_steps": short.iters,
           "wall_ms": wall * 1e3}
    if not kern:
        log("[profile] async: device time not measured (no CUDA events "
            "traced)")
        return out
    out.update(busy_pct=100 * busy_us / (wall * 1e6),
               kernels=sum(e.count for e in kern))
    log(f"[profile] async: {short.rounds} merges, {short.iters} client "
        f"local steps in {wall * 1e3:.1f} ms under the profiler, "
        f"{out['kernels']} kernels, device busy {busy_us / 1e3:.2f} ms "
        f"({out['busy_pct']:.1f}% of wall)")
    for name in TRAIN_KERNELS:
        hits = [e for e in kern if name in e.key]
        count = sum(e.count for e in hits)
        if count:
            us = sum(e.self_device_time_total for e in hits) / count
            out.setdefault("in_run", {})[name] = {"launches": count,
                                                  "us": us}
            log(f"[profile]   in the run: {name} {us:.2f} us per launch "
                f"(x{count})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")
    return out


def path_trees(torch) -> dict:
    """The trees phases 11-13 update: the stacked Table 4 (32, 123) and
    Table 5 (8, 123) logreg trees, Table 5's stacked (8, …) MLP tree, and
    one client's unstacked trees (the async job's update)."""
    from repro_torch.models import logreg, mlp

    dev = torch.device("cuda:0")
    lr = logreg.init_params(TABLE4["d"], device=dev)
    tm = TABLE5_MLP
    mp = mlp.init_params(tm["d"], width=tm["width"], depth=tm["depth"],
                         device=dev)
    return random_trees(torch, 6, {
        "table4 logreg tree": (lr, TABLE4["clients"]),
        "table5 logreg tree": (lr, TABLE5["clients"]),
        "table5 mlp tree": (mp, tm["clients"]),
        "logreg client tree": (lr, None),
        "mlp client tree": (mp, None)})


# Phase 15: Table 2 at the paper's full width (table2_nonconvex.py:33-75,
# full mode, with the models' default width of 64 in place of the
# CPU-reduced 16): 32x32x3 images, 10 classes, n = 8,192, 8 Non-IID clients
# (label-sorted, iid_percent 0), B = 16, momentum 0.9, stl_nc1 with
# eta1 = 0.005, T1 = 512, k1 = 8, 1/gamma = 0.01, int8 rounds; 8 stages,
# cut to stage 1 (64 rounds, 512 local steps); VGG16 cut to 16 rounds.
# ResNet18 runs the whole stage because its 1 - train accuracy stays at
# chance (about 0.90) for the first 32 rounds on the Non-IID split and
# falls only after: at 32 rounds the falling-objective check was a coin
# toss over cuDNN's nondeterministic backward (0.8958 -> 0.8184 in one run,
# -> 0.9044 in the next), at 64 rounds it ended at 0.024-0.026 in each run.
TABLE2 = {"n": 8192, "hw": 32, "classes": 10, "clients": 8, "width": 64,
          "batch": 16, "T1": 512, "k1": 8.0, "stages": 8, "run_stages": 1,
          "resnet_rounds": 64, "vgg_rounds": 16, "eval_every": 8}
# the blocks the CNN's int8 round hands quantize and dequant_mean, and its
# update's leaves: ResNet18's largest leaf (the last 3x3x512x512 conv), the
# head's weight and a 64-channel scale, each stacked over the 8 clients
CNN_SHAPES = {"resnet18 conv 3x3x512x512": (TABLE2["clients"], 2359296),
              "resnet18 head_w": (TABLE2["clients"], 512 * 10),
              "resnet18 scale": (TABLE2["clients"], 64)}


def hier_logreg_run(torch, dev, topology, intra, inter, n_stages,
                    reset=True):
    """Table 4's hierarchical row (or its star twin), one run through
    ``simulate``'s engine: (engine, history, launch counts, wall s)."""
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.engine import Engine

    t4 = TABLE4
    loss, ev, p0, data = logreg_problem(torch, dev, t4["n"], t4["d"],
                                        t4["clients"])
    cfg = TrainConfig(algo="stl_sc", eta1=0.5, T1=t4["T1"], k1=2.0,
                      n_stages=n_stages, iid=True, batch_per_client=32,
                      seed=0, topology=topology, reducer=intra,
                      inter_reducer=inter, n_pods=TABLE4_HIER["pods"])
    engine = Engine(cfg.algo, cfg)
    backend = simulate.VmapSimulatorBackend(loss, p0, data, ev, device=dev,
                                            eval_every=64)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    hist = engine.run(backend)
    torch.cuda.synchronize()
    return (engine, backend, hist, kernels.launch_counts(),
            time.monotonic() - t0)


def run_hierarchical(torch, dev="cuda:0"):
    """Phase 14: the two-level topology. Table 4's hierarchical row at full
    scale (dense intra, int8 inter; then int8 on both), its comm ledger
    against the hop costs as integers and its launches; on the card,
    dense∘dense equal to Star and streaming-hier equal to hier, bit for
    bit; then Table 5d's three schedules on the event runtime."""
    from repro_torch.utils.tree import tree_leaves

    dev = torch.device(dev)
    t4, th = TABLE4, TABLE4_HIER
    P, N = th["pods"], t4["clients"]
    log_cut("phase 14", f"Table 4 stl_sc hier (logreg d=123, N=32, {P} pods)",
            th["run_stages"], t4["stages"])
    launches = {k: 0 for k in TRAIN_KERNELS}
    runs = {}
    for intra, inter in (("dense", "int8"), ("int8", "int8")):
        engine, backend, hist, counts, wall = hier_logreg_run(
            torch, dev, "hier", intra, inter, th["run_stages"])
        rep = engine.report
        vals = [r.value for r in hist]
        check_objective(f"hier {intra}+{inter}", vals)
        tpl = backend.init_params
        hops = engine.topology.hop_costs(tpl, N)
        d, n_leaves = t4["d"], len(tree_leaves(tpl))
        # the integer formula: every client's intra message, then one
        # inter message per pod (int8: one byte a coordinate + a scale)
        intra_msg = d * 4 if intra == "dense" else d + 4
        per_round = N * intra_msg + P * (d + 4)
        if not (sum(h.bytes for h in hops) == per_round
                and rep.comm_bytes_total == rep.rounds_total * per_round):
            raise AssertionError(f"hier {intra}+{inter}: ledger "
                                 f"{rep.comm_bytes_total}, hops "
                                 f"{[h.bytes for h in hops]}, formula "
                                 f"{rep.rounds_total} x {per_round}")
        encodes = n_leaves * (P * (intra == "int8") + 1)
        expect_launches(f"hier {intra}+{inter}", counts,
                        {"fused_sgd_update": rep.iters_total,
                         "quantize_kernel": encodes * rep.rounds_total,
                         "dequant_mean_kernel": encodes * rep.rounds_total})
        for k in TRAIN_KERNELS:
            launches[k] += counts[k]
        log(f"[hier] {intra}+{inter}: rounds {rep.rounds_total}, iterations "
            f"{rep.iters_total}, wall {wall:.2f} s "
            f"({wall * 1e3 / rep.iters_total:.3f} ms a step), objective "
            f"{vals[0]:.6f} -> {vals[-1]:.6f}, comm bytes "
            f"{rep.comm_bytes_total} = {rep.rounds_total} x {per_round} "
            f"(hops {[(h.hop, h.bytes) for h in hops]}), modeled comm "
            f"{rep.comm_time_s:.4f} s, launches {counts}")
        runs[f"{intra}+{inter}"] = {
            "rounds": rep.rounds_total, "iters": rep.iters_total,
            "wall_s": wall, "ms_per_step": wall * 1e3 / rep.iters_total,
            "comm_bytes": rep.comm_bytes_total,
            "objective": [vals[0], vals[-1]], "launches": counts}

    # bit-equality on the card, cut to stage 1
    log_cut("phase 14", "bit-equality runs (dense∘dense vs Star, "
            "streaming-hier vs hier)", th["check_stages"], t4["stages"])
    pairs = ((("hier", "dense", "dense"), ("star", "dense", "dense")),
             (("streaming-hier", "int8", "int8"), ("hier", "int8", "int8")))
    for a, b in pairs:
        out = []
        for topology, intra, inter in (a, b):
            engine, backend, hist, counts, _ = hier_logreg_run(
                torch, dev, topology, intra, inter, th["check_stages"])
            for k in TRAIN_KERNELS:
                launches[k] += counts[k]
            out.append(([(r.round, r.value) for r in hist],
                        tree_leaves(backend.params)))
        same = out[0][0] == out[1][0] and all(
            torch.equal(x, y) for x, y in zip(out[0][1], out[1][1]))
        log(f"[hier] {a[0]} {a[1]}+{a[2]} against {b[0]} {b[1]}+{b[2]}: "
            f"history and replicas bit-equal {same} over "
            f"{out[0][0][-1][0]} rounds")
        if not same:
            raise AssertionError(f"{a} is not bit-equal to {b} on the card")

    t5d = run_table5d(torch, dev)
    for k in TRAIN_KERNELS:
        launches[k] += t5d["launches"][k]
    return {"launches": launches, "table4": runs, "table5d": t5d}


def run_table5d(torch, dev):
    """Phase 14b: Table 5d's streaming∘hierarchical axis at its full size:
    Table 5's MLP over the streaming two-level int8 round (2 pods, billed
    downlink, 25% stragglers at 4x) under the blocking, streaming-uplink
    and streaming schedules. The parameters must be bit-equal across the
    three, the leaf ledger's hops {intra_pod, inter_pod, downlink} with
    bytes summing to the run's comm bytes; the modeled walls are logged."""
    from repro_torch import kernels, runtime
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import make_binary_classification, partition_iid
    from repro_torch.models import mlp
    from repro_torch.utils.tree import tree_leaves

    tm = TABLE5_MLP
    x, y = make_binary_classification(n=tm["n"], d=tm["d"], seed=0)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in partition_iid(x, y, tm["clients"], seed=1).items()}
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    p0 = mlp.init_params(tm["d"], width=tm["width"], depth=tm["depth"],
                         seed=0, device=dev)
    n_leaves, P = len(tree_leaves(p0)), TABLE4_HIER["pods"]
    launches = {k: 0 for k in TRAIN_KERNELS}
    res = {}
    for sched in ("blocking", "streaming-uplink", "streaming"):
        cfg = TrainConfig(algo="sync", eta1=0.1, T1=32, n_stages=2,
                          batch_per_client=32, seed=0, reducer="int8",
                          inter_reducer="int8", topology="streaming-hier",
                          n_pods=P, count_downlink=True,
                          upload_schedule=sched, comm_latency_s=1e-4,
                          comm_bandwidth_gbps=0.45, base_step_time_s=1e-3,
                          straggler_frac=0.25, straggler_slowdown=4.0)
        kernels.reset_launch_counts()
        r = res[sched] = runtime.run(
            lambda p, b: mlp.loss_fn(p, b, 1e-3), p0, data, cfg,
            lambda p: mlp.full_objective(p, xt, yt, 1e-3), device=dev,
            eval_every=16)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        encodes = n_leaves * (P + 1) * r.rounds
        expect_launches(f"table5d {sched}", counts,
                        {"fused_sgd_update": r.iters,
                         "quantize_kernel": encodes,
                         "dequant_mean_kernel": encodes})
        for k in TRAIN_KERNELS:
            launches[k] += counts[k]
        hops = {l["hop"] for l in r.leaf_ledger}
        total = sum(l["bytes"] for l in r.leaf_ledger)
        if hops != {"intra_pod", "inter_pod", "downlink"} \
                or total != r.comm_bytes:
            raise AssertionError(f"table5d {sched}: ledger hops {hops}, "
                                 f"{total} bytes against {r.comm_bytes}")
        check_objective(f"table5d {sched}", [h.value for h in r.history])
    blk = res["blocking"]
    for sched in ("streaming-uplink", "streaming"):
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(res[sched].params),
                       tree_leaves(blk.params))):
            raise AssertionError(f"table5d: {sched} params differ from "
                                 f"blocking")
    walls = {k: v.wall_clock_s for k, v in res.items()}
    log(f"[hier] table5d (MLP {n_leaves} leaves, int8+int8, {P} pods, "
        f"billed downlink, 4x stragglers): params bit-equal across the "
        f"three schedules over {blk.rounds} rounds; modeled wall blocking "
        f"{walls['blocking']:.4f} s, streaming-uplink "
        f"{walls['streaming-uplink']:.4f} s, streaming "
        f"{walls['streaming']:.4f} s (uplink-only "
        f"{walls['blocking'] / walls['streaming-uplink']:.3f}x, full "
        f"{walls['blocking'] / walls['streaming']:.3f}x); ledger hops "
        f"{sorted(hops)} sum to {blk.comm_bytes} bytes")
    return {"launches": launches, "modeled_wall_s": walls,
            "rounds": blk.rounds}


def cnn_problem(torch, dev, net, width, n, hw, clients, eval_kind="error"):
    """Table 2's problem: (loss, eval, p0, data) on ``dev``. ``eval_kind``
    "error" is 1 - train accuracy (the table's objective), "loss" the
    cross-entropy over the whole set (a smooth value for card-vs-CPU
    checks), both in chunks of 1,024 images; "none" a constant."""
    from repro_torch.data import make_multiclass_images, partition_paper
    from repro_torch.models import cnn

    x, y = make_multiclass_images(n=n, n_classes=TABLE2["classes"], hw=hw,
                                  seed=0)
    data = {k: torch.from_numpy(v).to(dev) for k, v in partition_paper(
        x, y, clients, iid_percent=0.0, seed=1).items()}
    if net == "resnet18":
        p0, strides = cnn.init_resnet18(0, n_classes=TABLE2["classes"],
                                        width=width, device=dev)
        fwd = lambda p, xb: cnn.apply_resnet18(p, strides, xb)
    else:
        p0 = cnn.init_vgg16(0, n_classes=TABLE2["classes"], width=width,
                            device=dev)
        fwd = cnn.apply_vgg16
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    def ev(p):
        if eval_kind == "none":      # a profile's run: no evaluation
            return torch.zeros((), device=dev)
        acc = torch.zeros((), device=dev)
        for i in range(0, n, 1024):
            logits = fwd(p, xt[i:i + 1024])
            if eval_kind == "error":
                acc += (logits.argmax(-1) == yt[i:i + 1024]).sum()
            else:
                acc += cnn.cross_entropy(logits, yt[i:i + 1024]) \
                    * logits.shape[0]
        return 1.0 - acc / n if eval_kind == "error" else acc / n

    return (lambda p, b: cnn.cross_entropy(fwd(p, b["x"]), b["y"]), ev, p0,
            data)


def cnn_engine(torch, dev, net, width, n, hw, clients, n_stages, *,
               eval_kind="error", **backend_kw):
    """Table 2's stl_nc1 int8 run on ``dev``: (engine, backend, p0)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import simulate
    from repro_torch.engine import Engine

    t2 = TABLE2
    loss, ev, p0, data = cnn_problem(torch, dev, net, width, n, hw, clients,
                                     eval_kind)
    cfg = TrainConfig(algo="stl_nc1", eta1=0.005, T1=t2["T1"], k1=t2["k1"],
                      n_stages=n_stages, gamma_inv=0.01, iid=False,
                      batch_per_client=t2["batch"], momentum=0.9,
                      reducer="int8", seed=0)
    engine = Engine(cfg.algo, cfg)
    backend = simulate.VmapSimulatorBackend(loss, p0, data, ev, device=dev,
                                            **backend_kw)
    return engine, backend, p0


def cnn_reference_check(torch):
    """Phase 15a: Table 2's runs on the card against the CPU runs on the
    same draws, at width 8 on 512 images over 8 clients — ResNet18 on
    16x16 images, VGG16 on 32x32 (its five pools need 32) — 4 rounds of
    stage 1 (32 local steps), the cross-entropy over the set as the
    objective: the first record within 1e-5, all within 1e-3 (the CPU
    parity tests' CNN tolerances, tests/test_torch_cnn.py)."""
    from repro_torch.utils.rng import TorchKey

    for net, hw in (("resnet18", 16), ("vgg16", 32)):
        hist = {}
        for dev in ("cpu", "cuda"):
            tdev = torch.device(dev)
            engine, backend, _ = cnn_engine(
                torch, tdev, net, 8, 512, hw, TABLE2["clients"], 1,
                eval_kind="loss", max_rounds=4, chunk_rounds=4,
                rng=HostKey(TorchKey(0), tdev))
            hist[dev] = [r.value for r in engine.run(backend)]
        c, g = hist["cpu"], hist["cuda"]
        err = max(abs(a - b) for a, b in zip(c, g))
        log(f"[cnn] {net} width 8 {hw}x{hw} card vs CPU: {len(c)} records, "
            f"max |diff| {err:.3g} (first {abs(c[0] - g[0]):.3g}; tol 1e-3, "
            f"first 1e-5)")
        if len(c) != len(g) or not err <= 1e-3 \
                or not abs(c[0] - g[0]) <= 1e-5:
            raise AssertionError(f"cnn {net}: card run disagrees with the "
                                 f"CPU run ({err})")


def profile_cnn(torch, dev="cuda:0", rounds: int = 4) -> dict:
    """Phase 15's profile (taken after phase 4's, before the serving
    phases'): ResNet18 at Table 2's full width, 4 rounds of stage 1
    (32 local steps) with no evaluation, after the run's setup and one
    warm-up round outside the profile (the first round's time, the
    convolutions' first use included, is logged)."""
    dev = torch.device(dev)
    t2 = TABLE2
    engine, backend, _ = cnn_engine(
        torch, dev, "resnet18", t2["width"], t2["n"], t2["hw"],
        t2["clients"], 1, eval_kind="none", max_rounds=1, chunk_rounds=1)
    t0 = time.monotonic()
    engine.run(backend)          # setup and the first round
    torch.cuda.synchronize()
    log(f"[time] resnet18's setup and first round (first use of its "
        f"convolutions): {time.monotonic() - t0:.1f} s")
    backend.chunk_rounds = rounds
    backend.max_rounds = backend.rounds_done + rounds

    def run():   # the same backend: no setup inside the profile
        status = backend.run_stage(engine.stages[0], engine)
        return status.iters, status.rounds

    return profile_run(torch, "resnet18 (Table 2, width 64)", run)


def run_cnn(torch, dev="cuda:0"):
    """Phase 15: Table 2's ResNet18 at full width for stage 1, then VGG16
    at full width for 16 rounds: the objective (1 - train accuracy)
    finite and ending below its start, one fused update per local step,
    one quantize and one dequant_mean per leaf per round."""
    from repro_torch import kernels
    from repro_torch.utils.tree import tree_leaves

    dev = torch.device(dev)
    t2 = TABLE2
    cnn_reference_check(torch)
    out = {"launches": {k: 0 for k in TRAIN_KERNELS}}
    for net in ("resnet18", "vgg16"):
        rounds = {"resnet18": t2["resnet_rounds"],
                  "vgg16": t2["vgg_rounds"]}[net]
        log(f"[cut] phase 15: Table 2 stl_nc1 {net} (width 64, N=8, int8), "
            f"{rounds} rounds of stage 1 of {t2['stages']}")
        kw = {"max_rounds": rounds, "chunk_rounds": rounds}
        engine, backend, p0 = cnn_engine(
            torch, dev, net, t2["width"], t2["n"], t2["hw"], t2["clients"],
            t2["run_stages"], eval_every=t2["eval_every"], **kw)
        n_leaves = len(tree_leaves(p0))
        n_params = sum(t.numel() for t in tree_leaves(p0))
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        hist = engine.run(backend)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = kernels.launch_counts()
        rep = engine.report
        vals = [r.value for r in hist]
        log(f"[cnn] {net}: {n_params} parameters in {n_leaves} leaves, "
            f"rounds {rep.rounds_total}, local steps {rep.iters_total}, wall "
            f"{wall:.2f} s ({wall * 1e3 / rep.iters_total:.3f} ms a step, "
            f"evaluations included), 1 - train accuracy "
            f"{[round(v, 4) for v in vals]}, comm bytes "
            f"{rep.comm_bytes_total}, launches {counts}")
        # VGG16's 1 - accuracy does not fall within 16 rounds on the
        # Non-IID split (0.8979 -> 0.9054 on an H100; its cross-entropy
        # rose too in a width-32 CPU run): that it falls is held on
        # ResNet18's 64 rounds; VGG16 is held to the CPU run
        # (cnn_reference_check)
        if not all(math.isfinite(v) for v in vals) or \
                (net == "resnet18" and not vals[-1] < vals[0]):
            raise AssertionError(f"{net}: objective {vals[0]} -> "
                                 f"{vals[-1]}: not finite or not lower")
        if rep.rounds_total != rounds or \
                rep.iters_total != rounds * int(t2["k1"]):
            raise AssertionError(f"{net}: {rep.rounds_total} rounds, "
                                 f"{rep.iters_total} steps")
        expect_launches(net, counts,
                        {"fused_sgd_update": rep.iters_total,
                         "quantize_kernel": n_leaves * rep.rounds_total,
                         "dequant_mean_kernel": n_leaves * rep.rounds_total})
        for k in TRAIN_KERNELS:
            out["launches"][k] += counts[k]
        out[net] = {"params": n_params, "leaves": n_leaves,
                    "rounds": rep.rounds_total, "iters": rep.iters_total,
                    "wall_s": wall, "ms_per_step": wall * 1e3 / rep.iters_total,
                    "objective": [vals[0], vals[-1]], "launches": counts}
    return out


def cnn_trees(torch) -> dict:
    """ResNet18's tree at full width, stacked over Table 2's 8 clients —
    the tree its local step updates (38 leaves, 89.3 M floats)."""
    from repro_torch.models import cnn

    p0, _ = cnn.init_resnet18(0, width=TABLE2["width"], device="cuda:0")
    return random_trees(torch, 7, {"resnet18 tree": (p0, TABLE2["clients"])})


# phase 16: transformer training. The flash cases of 16a: qwen3-14b's
# training layer (2 sequences of 1,024 tokens, 40/8 heads of 128) in bf16,
# 16b's layer (qwen3-14b SMOKE in float32: 2 sequences of 64 tokens, 4/2
# heads of 64, causal) and a small float32 shape with a window and a softcap
TRAIN_FLASH_CASES = {"qwen3 train": (2, 1024, 40, 8, 128, "bf16", None, None),
                     "qwen3 smoke f32": (2, 64, 4, 2, 64, "f32", None, None),
                     "f32 window softcap": (1, 200, 4, 2, 64, "f32", 64,
                                            30.0)}
# SDPA's gradients against the plain version's, both in bf16: each of dq,
# dk, dv within 2e-2 of the plain gradient's norm (the flash backward keeps
# P and dS in bf16; the plain version rounds only its outputs)
SDPA_GRAD_TOL = 2e-2
# 16b: qwen3-14b SMOKE in float32, the card against the CPU on the same
# draws; the stages' mean losses within the first relative tolerance
# (dense: cuBLAS and the f32 flash kernel sum in other orders; an int8 hop
# may flip a code where the two runs straddle a floor() boundary). The
# second holds each leaf of the final state: the parameters' updates
# (p_final − p_start) and the moments, card against CPU, each as the norm
# of the difference over the CPU's norm. A flipped code moves a few
# elements by a quantum (1/127 of a row's largest delta), by itself far
# under 1e-3 of a leaf's update; but it moves the next gradients, and the
# flips compound over the rounds, so an int8 run's state drifts from the
# other's by more than a dense run's. Each is about 7x the largest
# reading on an H100 (dense 1.3e-5, int8 3.0e-3); a leaf that does not
# train (its gradient dropped) is off by 1.
LM_CHECK = {"clients": 2, "batch": 2, "seq": 64, "T1": 8, "k1": 2.0,
            "stages": 2, "eta1": 0.05}
LM_CHECK_RUNS = {"dense star": (dict(reducer="dense"), 1e-4, 1e-4),
                 "int8 star": (dict(reducer="int8"), 1e-3, 2e-2),
                 "hier dense+int8": (dict(reducer="dense", topology="hier",
                                          n_pods=2, inter_reducer="int8"),
                                     1e-3, 2e-2)}
# 16c: qwen3-14b at full width, its depth cut to 2 of 40 layers. eta1
# 0.03: in a sweep of this configuration at 0.0025, 0.01, 0.03 and 0.1,
# most bf16 weights' steps rounded away at 0.0025 and the loss hardly
# moved; 0.03 is the middle of the rates under which it fell
QWEN3_TRAIN = {"layers": 2, "clients": 2, "batch": 2, "seq": 1024,
               "T1": 16, "k1": 4.0, "stages": 2, "eta1": 0.03,
               "profile_steps": 4}


def flash_train_case(torch, dev, B, S, H, KV, D, dt, window, cap, seed=11):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device=dev)
    q = (q * (cap / 4 if cap else 1.0)).to(dt)
    k, v, dout = (torch.randn(shape, generator=g, device=dev).to(dt)
                  for shape in ((B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    return q, k, v, dout


def check_flash_grad(torch) -> dict:
    """Phase 16a: the flash Function's gradients on the card. The kernel
    route's output has a grad_fn and is held to the plain version; its
    dq, dk, dv equal autograd through the plain version bit for bit. Times:
    the kernel's forward, the plain backward a layer takes (the
    Function's recompute and vector-Jacobian product), and, at the causal
    shape, SDPA's forward + backward (held to the plain version first)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         plain_attention)
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         bf16_mismatch)
    from repro_torch.launch.flops import _attn_pairs

    dev = torch.device("cuda:0")
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    rows = {}
    for label, (B, S, H, KV, D, dtn, window, cap) in \
            TRAIN_FLASH_CASES.items():
        dt = types[dtn]
        q, k, v, dout = flash_train_case(torch, dev, B, S, H, KV, D, dt,
                                         window, cap)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        n0 = FK.flash_attention.launches
        out = flash_attention(*ins, window=window, softcap=cap)
        grads = torch.autograd.grad(out, ins, dout, retain_graph=True)
        pins = [t.clone().requires_grad_() for t in (q, k, v)]
        plain = plain_attention(*pins, True, window, cap, None)
        pgrads = torch.autograd.grad(plain, pins, dout, retain_graph=True)
        torch.cuda.synchronize()
        if out.grad_fn is None or FK.flash_attention.launches != n0 + 1:
            raise AssertionError(f"flash {label}: the kernel route gave no "
                                 f"grad_fn or launched "
                                 f"{FK.flash_attention.launches - n0} times")
        equal = [torch.equal(a, b) for a, b in zip(grads, pgrads)]
        if not all(equal):
            raise AssertionError(f"flash {label}: dq/dk/dv bit-equal to the "
                                 f"plain route: {equal}")
        ref = attention_ref(q, k, v, window=window, softcap=cap)
        if dt == torch.bfloat16:
            err, elem, row = bf16_mismatch(out.detach(), ref)
            ok = elem <= 1.0 and row <= 1.0
        else:
            diff = (out.detach() - ref).abs()
            err = float(diff.max())
            elem, row = float((diff / (1e-5 + 1e-5 * ref.abs())).max()), None
            ok = elem <= 1.0
        if not ok:
            raise AssertionError(f"flash {label}: output off the plain "
                                 f"version: {err} ({elem}, {row} of tol)")
        big = S >= 1024
        fwd_ms = device_ms(torch, lambda: flash_attention(
            q, k, v, window=window, softcap=cap), batch=10)
        bwd_ms = device_ms(torch, lambda: torch.autograd.grad(
            out, ins, dout, retain_graph=True), batch=2 if big else 10,
            reps=10 if big else TIMING_REPS)
        pairs = _attn_pairs(S, window, "prefill")
        # the backward's least work: S = QK^T again, then dV, dP, dQ, dK:
        # five products of 2·D FLOPs per visible (query, key) pair and head
        n_flops = 10.0 * B * H * D * pairs
        n_bytes = (3 * q.numel() + 4 * k.numel()) * q.element_size()
        bms, by = bound_ms(n_bytes, n_flops,
                           BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        lib = None
        if window is None and cap is None:
            sins = [t.clone().requires_grad_() for t in (q, k, v)]
            so = sdpa_library(torch, *sins)
            sg = torch.autograd.grad(so, sins, dout)
            _, s_elem, s_row = bf16_mismatch(so.detach(), ref)
            s_rel = [float((a.float() - b.float()).norm() / b.float().norm())
                     for a, b in zip(sg, pgrads)]
            log(f"[flash-grad] SDPA against the plain version: output "
                f"{s_elem:.3f} / {s_row:.3f} of tol, gradients "
                f"{[round(r, 5) for r in s_rel]} of their norm (tol "
                f"{SDPA_GRAD_TOL})")
            if not (s_elem <= 1.0 and s_row <= 1.0
                    and max(s_rel) <= SDPA_GRAD_TOL):
                raise AssertionError(f"SDPA {label} off the plain version")

            def sdpa_fwd_bwd():
                outs = sdpa_library(torch, *sins)
                torch.autograd.grad(outs, sins, dout)

            lib = device_ms(torch, sdpa_fwd_bwd, batch=2, reps=10)
        rows[label] = {"shape": [B, S, H, KV, D], "dtype": dtn,
                       "window": window, "softcap": cap,
                       "grads_bit_equal": True, "max_abs_err": err,
                       "fwd_ms": fwd_ms, "plain_bwd_ms": bwd_ms,
                       "bwd_bound_ms": bms, "bwd_bound_by": by,
                       "sdpa_fwd_bwd_ms": lib}
        log(f"[flash-grad] {label} {(B, S, H, KV, D)} {dtn} window {window} "
            f"softcap {cap}: dq/dk/dv bit-equal to the plain route; output "
            f"max err {err:.3g}; kernel forward {fwd_ms:.4f} ms, plain "
            f"backward {bwd_ms:.4f} ms (its bound {bms:.4f} ms, {by}), "
            f"SDPA forward + backward "
            f"{'-' if lib is None else f'{lib:.4f} ms'}")
        del out, grads, plain, pgrads, ins, pins
    torch.cuda.empty_cache()
    return rows


def lm_train(torch, cfg, dev, state, tcfg, *, clients, batch, seq,
             rng=None, max_iters=None):
    """One ``StagewiseDriver`` run of the port's transformer training from
    ``state`` on ``dev``, over ``synthetic_batches`` (seed 0): the
    launcher's path. Returns the DriverState."""
    from repro_torch.core import local_sgd as LS
    from repro_torch.core.stl_sgd import StagewiseDriver
    from repro_torch.launch.train import synthetic_batches

    step, sync, _ = LS.build_train_steps(
        cfg, dev, reducer=tcfg.reducer,
        streaming=tcfg.topology == "streaming", rng=rng)
    if tcfg.topology == "hier":
        sync = LS.build_sync_step(tcfg.reducer, hierarchical=True,
                                  n_pods=tcfg.n_pods,
                                  inter_reducer=tcfg.inter_reducer, rng=rng)
    batches = synthetic_batches(cfg, clients, batch, seq, seed=0, device=dev)
    return StagewiseDriver(tcfg, step, sync).run(state, batches,
                                                 max_iters=max_iters)


def update_launches(ps, ms, gs) -> int:
    """The launches one ``tree_sgd_update_`` of these leaves makes: one a
    (p, m, g type) group and ``MAX_LEAVES`` leaves of it."""
    from collections import Counter

    from repro_torch.kernels.fused_update.kernel import MAX_LEAVES

    groups = Counter((p.dtype, m.dtype, g.dtype)
                     for p, m, g in zip(ps, ms, gs))
    return sum(-(-n // MAX_LEAVES) for n in groups.values())


def lm_launches(cfg, ds, clients: int, int8_messages: int) -> dict:
    """The training path's launches: the flash forward twice an attention
    layer a client a local step (the forward and its remat recompute), the
    SSD forward twice and its backward kernel once a Mamba2 layer a client
    a local step, the fused
    update's launches for a client's tree (one, or one a type group: a
    bf16 mamba2 keeps A_log, D and dt_bias in float32) a client a local
    step, one quantize and one dequant_mean a leaf a round for each int8
    message of a leaf (``int8_messages``)."""
    from repro_torch.utils.tree import tree_leaves

    ps = [t[0] for t in tree_leaves(ds.state["params"])]
    ms = [t[0] for t in tree_leaves(ds.state["opt"]["mu"])]
    n_leaves = len(ps)
    kinds = cfg.layer_kinds()
    per_layer = 2 * clients * ds.iters_total
    return {"flash_attention": per_layer * sum(k in "GL" for k in kinds),
            "ssd": per_layer * kinds.count("M"),
            "ssd_bwd": clients * ds.iters_total * kinds.count("M"),
            "fused_sgd_update": clients * ds.iters_total
            * update_launches(ps, ms, ps),
            "quantize_kernel": int8_messages * n_leaves * ds.rounds_total,
            "dequant_mean_kernel": int8_messages * n_leaves * ds.rounds_total}


def lm_path_shapes(arch: str = "qwen3-14b", label: str = "lm") -> dict:
    """The blocks the int8 rounds of 16b (17b for mamba2) hand quantize and
    dequant_mean: each leaf of ``arch``'s SMOKE config as (2, n) — two
    clients on the int8 Star, the two pod means on the two-level round's
    inter hop (its intra hop is dense, so no (1, n) pod block is
    quantized)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.utils.tree import tree_leaves

    cfg = get_arch(arch, smoke=True).replace(dtype="float32")
    p = transformer.to_grouped(transformer.init_params_shape(cfg), cfg)
    sizes = sorted({t.numel() for t in tree_leaves(p)})
    return {f"{label} smoke leaf {n}": (LM_CHECK["clients"], n)
            for n in sizes}


def check_lm_update(torch, cfg, state, q) -> dict:
    """Phases 16c and 17c: the fused update at the path's own shapes.
    Client 0's gradient at the trained state (``lm_loss`` on one of its
    batches), then one ``tree_sgd_update_`` on client 0's row views of the
    stacked bf16 leaves and their float32 moments — the launch each client
    makes each local step, every leaf in one launch a type group — against
    the plain version on clones of the same rows, bit for bit: with the gradient in bf16
    (the path's) and in float32 (the microbatch step's). The path's eta,
    momentum 0.9 and weight decay 1e-4, so every term runs. The launch's
    device time beside its bound (bytes)."""
    from repro_torch.core import local_sgd as LS
    from repro_torch.kernels.fused_update.kernel import fused_sgd_update
    from repro_torch.kernels.fused_update.ops import tree_sgd_update_
    from repro_torch.kernels.fused_update.ref import sgd_update_ref
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.utils.tree import tree_leaves, tree_map

    dev = tree_leaves(state["params"])[0].device
    rows_p = [t[0] for t in tree_leaves(state["params"])]
    rows_m = [t[0] for t in tree_leaves(state["opt"]["mu"])]
    batch = next(synthetic_batches(cfg, q["clients"], q["batch"], q["seq"],
                                   seed=2, device=dev))
    live_tree = tree_map(lambda t: t[0].detach().requires_grad_(),
                         state["params"])
    live = tree_leaves(live_tree)
    loss = LS.lm_loss(live_tree, cfg, tree_map(lambda x: x[0], batch))
    grads = [g.contiguous() for g in torch.autograd.grad(loss, live)]
    del live, live_tree, loss
    torch.cuda.empty_cache()
    eta, beta, wd = q["eta1"], 0.9, 1e-4
    n = sum(t.numel() for t in rows_p)
    out = {"leaves": len(rows_p), "elements": n}
    for label in ("bf16 g", "f32 g"):
        if label == "f32 g":
            grads = [g.float() for g in grads]
        p0 = [t.clone() for t in rows_p]
        m0 = [t.clone() for t in rows_m]
        n0 = fused_sgd_update.launches
        tree_sgd_update_(rows_p, rows_m, grads, eta=eta, beta=beta, wd=wd)
        torch.cuda.synchronize()
        launched = fused_sgd_update.launches - n0
        want = update_launches(rows_p, rows_m, grads)
        bad = []
        for i, leaf in enumerate(zip(p0, m0, grads, rows_p, rows_m)):
            # the plain version is elementwise: run it on pieces of the
            # flattened leaf, so that its float32 temporaries stay small
            # beside a 1.7 G-element stacked leaf
            pieces = zip(*(t.reshape(-1).split(1 << 26) for t in leaf))
            for p, m, g, got_p, got_m in pieces:
                wp, wm = sgd_update_ref(p, m, g, eta=eta, beta=beta, wd=wd)
                if not (torch.equal(got_p, wp) and torch.equal(got_m, wm)):
                    bad.append(i)
                    break
        del p0, m0
        torch.cuda.empty_cache()
        ms = device_ms(torch, lambda: tree_sgd_update_(
            rows_p, rows_m, grads, eta=1e-9, beta=beta), batch=1, reps=5)
        # p and m read and written, g read, each in its own type
        n_bytes = sum(p.numel() * (2 * p.element_size() + 2 * m.element_size()
                                   + g.element_size())
                      for p, m, g in zip(rows_p, rows_m, grads))
        bms, by = bound_ms(n_bytes, 4 * n)
        log(f"[lm-update] {cfg.name}: client 0's {len(rows_p)} leaves ({n} "
            f"elements; bf16, float32 moments), {label}: {launched} "
            f"launch(es), "
            f"{'bit-equal to the plain version' if not bad else f'leaves {bad} DIFFER'}"
            f"; device {ms:.3f} ms, bound {bms:.3f} ms ({by})")
        if launched != want or bad:
            raise AssertionError(f"fused update of the LM rows ({label}): "
                                 f"{launched} launches, leaves {bad} off "
                                 f"the plain version")
        out[label] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                      "bit_equal": True, "launches": launched}
    del grads
    torch.cuda.empty_cache()
    return out


def lm_leaf_diffs(torch, start, a, b) -> dict:
    """Per leaf of the final states ``a`` (the card's) and ``b`` (the
    CPU's), both from ``start``: {("params", path): ||Δa − Δb|| / ||Δb||}
    of the parameters' updates (Δ = final − start) and {("opt", path):
    ||a − b|| / ||b||} of the moments."""
    from repro_torch.utils.tree import tree_flatten_with_path

    def rel(x, y):
        d = float((x.cpu() - y).norm())
        n = float(y.norm())
        return d / n if n > 0 else d

    out = {}
    p0 = tree_flatten_with_path(start["params"])[0]
    for kind, ka, kb, k0 in (
            ("params", a["params"], b["params"], p0),
            ("opt", a["opt"], b["opt"], None)):
        la = tree_flatten_with_path(ka)[0]
        lb = tree_flatten_with_path(kb)[0]
        for i, ((path, x), (_, y)) in enumerate(zip(la, lb)):
            if k0 is not None:
                x, y = x.cpu() - k0[i][1], y - k0[i][1]
            out[(kind, path)] = rel(x, y)
    return out


def lm_state_diff(torch, start, a, b) -> dict:
    """``lm_leaf_diffs``' largest parameter update and moment readings,
    each with its leaf."""
    out = {}
    for kind in ("params", "opt"):
        worst = (0.0, None)
        for (k, path), r in lm_leaf_diffs(torch, start, a, b).items():
            if k == kind and r >= worst[0]:
                worst = (r, path)
        out[kind], out[kind + "_leaf"] = worst
    return out


def router_fault(torch):
    """A patch of the SGD update that scales the router leaves' gradient
    by ``MOE_ROUTER_FAULT`` before the update kernel reads it."""
    from unittest import mock

    from repro_torch.optim import sgd as SGD
    from repro_torch.utils.tree import tree_flatten_with_path

    update = SGD.tree_sgd_update_

    def wrong(params, mu, grads, **kw):
        for path, g in tree_flatten_with_path(grads)[0]:
            if "w_router" in path:
                g.mul_(MOE_ROUTER_FAULT)
        return update(params, mu, grads, **kw)

    return mock.patch.object(SGD, "tree_sgd_update_", wrong)


def train_reference_check(torch, arch: str = "qwen3-14b",
                          runs=tuple(LM_CHECK_RUNS),
                          control: bool = True) -> dict:
    """Phase 16b (17b for mamba2-2.7b): ``arch``'s SMOKE config (float32)
    trained on the card against the CPU from the same state, on the same
    batches and sync draws (``HostKey``), under dense Star, int8 Star and
    the two-level round (2 pods, dense + int8): stage results and ledgers
    equal, mean losses and each leaf of the final state (the parameters'
    updates, the moments) within ``LM_CHECK_RUNS``' tolerances (for a MoE
    arch whose runs route apart, the state before they do: see
    ``MOE_FLIP_MARGIN``), the launches of the path. Then a control: the
    dense run on the card again with the output of the layer's autograd
    Function — flash attention's, or the SSD scan's — detached from the
    graph (the fault such a Function repairs), which the state check must
    refuse; a MoE arch adds a second, the int8 run with the router's
    gradient off (``router_fault``). Phase 18a runs ``runs`` (dense and
    int8 Star), with the controls for a MoE arch only."""
    import contextlib
    from unittest import mock

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import local_sgd as LS
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.ssd import ops as SO
    from repro_torch.utils.rng import TorchKey
    from repro_torch.utils.tree import tree_map

    cfg = get_arch(arch, smoke=True).replace(dtype="float32")
    c = LM_CHECK
    base = LS.init_state(0, cfg, c["clients"], device="cpu")

    def run(dev, tcfg, picks=None, max_iters=None):
        d = torch.device(dev)
        state = {"params": tree_map(lambda t: t.to(d, copy=True),
                                    base["params"]),
                 "opt": tree_map(lambda t: t.to(d, copy=True), base["opt"]),
                 "step": 0}
        with recording_picks(torch, picks if picks is not None else []):
            return lm_train(torch, cfg, d, state, tcfg,
                            clients=c["clients"], batch=c["batch"],
                            seq=c["seq"], rng=HostKey(TorchKey(0), d),
                            max_iters=max_iters)

    def tcfg_of(kw):
        return TrainConfig(algo="stl_sc", eta1=c["eta1"], T1=c["T1"],
                           k1=c["k1"], n_stages=c["stages"], **kw)

    floors = {}   # id of a CPU run -> its leaves' order floors

    def held_to_order_floor(label, tcfg, state_tol, cpu, card, diff,
                            control):
        """Where a leaf misses ``state_tol``: the CPU run again on one
        thread (its float32 sums in another order, nothing else changed)
        gives each leaf's order floor, the reading of one CPU run against
        the other; each leaf of the card's run is then held to the larger
        of ``state_tol`` and ``ORDER_FLOOR_FACTOR`` times its floor. A
        control is held to the floors its run's check found, or to
        ``state_tol`` where that check needed none. (passed, reading)."""
        if id(cpu) not in floors:
            if control:
                return False, diff
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                again = run("cpu", tcfg)
            finally:
                torch.set_num_threads(n)
            floors[id(cpu)] = lm_leaf_diffs(torch, base, again.state,
                                            cpu.state)
        floor = floors[id(cpu)]
        card_leaf = lm_leaf_diffs(torch, base, card.state, cpu.state)
        over = {k: (r, floor[k]) for k, r in card_leaf.items()
                if r > max(state_tol, ORDER_FLOOR_FACTOR * floor[k])}
        worst = max(card_leaf, key=lambda k: card_leaf[k] / max(
            state_tol, ORDER_FLOOR_FACTOR * floor[k]))
        diff["order_floor"] = {
            "leaf": list(worst), "card": card_leaf[worst],
            "floor": floor[worst],
            "largest_floor": max(floor.values())}
        log(f"[lm-check] {cfg.name} {label}: over {state_tol} on "
            f"{sum(r > state_tol for r in card_leaf.values())} leaves; the "
            f"CPU on one thread against the CPU: the order floor; the "
            f"card's worst leaf against its floor {worst}: "
            f"{card_leaf[worst]:.3g} against {floor[worst]:.3g} (held to "
            f"max({state_tol}, {ORDER_FLOOR_FACTOR} x floor)): "
            f"{'held' if not over else f'refused on {len(over)} leaves'}")
        return not over, diff

    def held(label, tcfg, state_tol, cpu, card, picks, fault,
             control=False):
        """16b's state check of ``card`` against ``cpu`` (``fault`` the
        card run's patch): (passed, reading). A leaf over ``state_tol``
        in a run that routed no token apart is held to its order floor
        (``held_to_order_floor``)."""
        diff = lm_state_diff(torch, base, card.state, cpu.state)
        ok = diff["params"] <= state_tol and diff["opt"] <= state_tol
        flips = picks_apart(torch, cfg, picks["cpu"], picks["card"], label)
        if not flips["calls"]:
            if not ok:
                return held_to_order_floor(label, tcfg, state_tol, cpu,
                                           card, diff, control)
            return ok, diff
        diff.update(routing=flips)
        if not flips["explains"]:
            return False, diff
        per_step, rest = divmod(len(picks["cpu"]), cpu.iters_total)
        if rest:
            raise AssertionError(f"lm {label}: {len(picks['cpu'])} MoE "
                                 f"calls over {cpu.iters_total} steps")
        n = flips["first_call"] // per_step
        pre, pre_ok = {}, False
        if n:
            again = {"cpu": [], "card": []}
            a = run("cpu", tcfg, again["cpu"], max_iters=n)
            with fault():
                b = run("cuda:0", tcfg, again["card"], max_iters=n)
            torch.cuda.synchronize()
            pre = lm_state_diff(torch, base, b.state, a.state)
            same = len(again["cpu"]) == len(again["card"]) and all(
                torch.equal(x.sort(dim=-1).values, y.sort(dim=-1).values)
                for (x, _), (y, _) in zip(again["cpu"], again["card"]))
            pre_ok = same and pre["params"] <= state_tol \
                and pre["opt"] <= state_tol
            pre["routes_equal"] = same
        diff["before_apart"] = dict(steps=n, **pre)
        log(f"[lm-check] {cfg.name} {label}: both runs again to step {n}, "
            f"the last before the first routed-apart call"
            + (f" (routes {'equal' if pre['routes_equal'] else 'APART'}): "
               f"updates {pre['params']:.3g} ({pre['params_leaf']}), "
               f"moments {pre['opt']:.3g} ({pre['opt_leaf']}) of their "
               f"norm (tol {state_tol})" if n else
               ": no step before it to hold")
            + f": {'held' if pre_ok else 'refused'}")
        return pre_ok, diff

    launches, readings, cpus = {}, {}, {}
    for label in runs:
        kw, tol, state_tol = LM_CHECK_RUNS[label]
        tcfg = tcfg_of(kw)
        picks = {"cpu": [], "card": []}
        cpu = run("cpu", tcfg, picks["cpu"])
        kernels.reset_launch_counts()
        card = run("cuda:0", tcfg, picks["card"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        shape = [(r.stage, r.k, r.iters, r.rounds) for r in cpu.results]
        rel = max(abs(a.mean_loss / b.mean_loss - 1.0)
                  for a, b in zip(card.results, cpu.results))
        ok, diff = held(label, tcfg, state_tol, cpu, card, picks,
                        contextlib.nullcontext)
        log(f"[lm-check] {cfg.name} {label}: stages {shape}, mean losses card "
            f"{[round(r.mean_loss, 6) for r in card.results]} vs CPU "
            f"{[round(r.mean_loss, 6) for r in cpu.results]}, max rel diff "
            f"{rel:.3g} (tol {tol}); final state, card against CPU: "
            f"updates {diff['params']:.3g} ({diff['params_leaf']}), moments "
            f"{diff['opt']:.3g} ({diff['opt_leaf']}) of their norm (tol "
            f"{state_tol}{', or the state before the runs route apart' if 'routing' in diff else ''}); "
            f"ledger {card.comm_bytes_total} B, launches {counts}")
        if [(r.stage, r.k, r.iters, r.rounds) for r in card.results] != shape \
                or not rel <= tol:
            raise AssertionError(f"lm {label}: card against CPU: {rel}")
        if not ok:
            raise AssertionError(f"lm {label}: final state, card against "
                                 f"CPU: {diff}")
        if (card.comm_bytes_total, card.comm_time_s, card.leaf_ledger) != \
                (cpu.comm_bytes_total, cpu.comm_time_s, cpu.leaf_ledger):
            raise AssertionError(f"lm {label}: ledgers differ")
        want = lm_launches(cfg, card, c["clients"],
                           int(kw["reducer"] == "int8"
                               or kw.get("inter_reducer") == "int8"))
        expect_launches(f"lm {label}", counts, want)
        launches[label] = counts
        readings[label] = dict(loss_rel=rel, **diff)
        cpus[label] = (cpu, picks["cpu"])
        del card
    torch.cuda.empty_cache()
    if not control:
        return {"launches": launches, "readings": readings}

    # the controls, each a fault on the card that the state check must
    # refuse: a layer's Function output without a grad_fn (the fault the
    # autograd Functions repair); for a MoE arch, the router's gradient off
    if "M" in cfg.layer_kinds():
        fn, what = SO.SSD, "ssd"
        apply = fn.apply
        detached = lambda *a: tuple(t.detach() for t in apply(*a))
    else:
        fn, what = FO.FlashAttention, "flash"
        apply = fn.apply
        detached = lambda *a: apply(*a).detach()
    controls = [(f"{what} output detached", "dense star",
                 lambda: mock.patch.object(fn, "apply", detached))]
    if cfg.moe is not None:
        controls.append((f"router gradient x{MOE_ROUTER_FAULT}", "int8 star",
                         lambda: router_fault(torch)))
    for what, label, fault in controls:
        kw, tol, state_tol = LM_CHECK_RUNS[label]
        cpu, cpu_picks = cpus[label]
        picks = {"cpu": cpu_picks, "card": []}
        with fault():
            card = run("cuda:0", tcfg_of(kw), picks["card"])
        torch.cuda.synchronize()
        rel = max(abs(a.mean_loss / b.mean_loss - 1.0)
                  for a, b in zip(card.results, cpu.results))
        ok, diff = held(f"control {what}", tcfg_of(kw), state_tol, cpu,
                        card, picks, fault, control=True)
        log(f"[lm-check] {cfg.name} control, {what} ({label}): mean losses "
            f"max rel diff {rel:.3g} (tol {tol}), final state: updates "
            f"{diff['params']:.3g} ({diff['params_leaf']}), moments "
            f"{diff['opt']:.3g} ({diff['opt_leaf']}) of their norm (tol "
            f"{state_tol}): {'PASSED' if ok else 'refused'}")
        if ok:
            raise AssertionError(f"lm control: {what} passes the state "
                                 f"check: {diff}")
        readings[f"control {what}"] = dict(loss_rel=rel, **diff)
        del card
        torch.cuda.empty_cache()
    return {"launches": launches, "readings": readings}


def lm_matmul_params(cfg) -> tuple:
    """(matmul parameters of the whole model, of its layers): the weights
    every token multiplies (the embedding is a gather)."""
    from repro_torch.models.transformer import padded_vocab

    a = cfg.attention
    per_layer = (2 * cfg.d_model * a.n_heads * a.head_dim
                 + 2 * cfg.d_model * a.n_kv_heads * a.head_dim
                 + 3 * cfg.d_model * cfg.d_ff)
    layers = cfg.n_layers * per_layer
    return layers + cfg.d_model * padded_vocab(cfg), layers


def profile_lm(torch, cfg, dev, state, tcfg, q) -> dict:
    """Phase 16c's profile: torch.profiler over ``q["profile_steps"]``
    local steps and their round, after the run. Device time by kind: the
    cuBLAS GEMMs (the plain backward's products included), the flash
    forward, the plain attention backward (its ``obs/trace.layer`` range),
    the fused update and the loss's log-softmax."""
    from repro_torch.core import local_sgd as LS
    from repro_torch.launch.train import synthetic_batches

    step, sync, _ = LS.build_train_steps(cfg, dev)
    batches = synthetic_batches(cfg, q["clients"], q["batch"], q["seq"],
                                seed=1, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = q["profile_steps"]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            state, _ = step(state, next(batches), tcfg.eta1)
        state = sync(state)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    out = {"steps": n, "ms_per_step": wall * 1e3 / n}
    kinds = device_ms_by_kind(
        torch, prof, n, {"gemm": GEMM_KERNELS,
                         "flash_forward": ("flash_fwd",),
                         "fused_update": ("fused_sgd_update",),
                         "loss_log_softmax": ("LogSoftMax",)},
        {"attention_backward": "flash_attention.backward"})
    if kinds is None:
        log(f"[lm-profile] {wall * 1e3 / n:.2f} ms a local step; device "
            f"time not measured (no CUDA events traced)")
        return out
    union = busy_union_us(torch, prof) / 1e3
    out.update(busy_union_pct=100 * union / (wall * 1e3), **kinds)
    log(f"[lm-profile] {n} local steps and a round in {wall * 1e3:.1f} ms: "
        f"{wall * 1e3 / n:.2f} ms a step, {out['kernels_per_step']:.0f} "
        f"kernels a step, a kernel running {out['busy_union_pct']:.1f}% of "
        f"the wall; device ms a step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    out["by_kind_ms_per_step"].items())
        + " (the attention backward's products are among the GEMMs too)")
    for line in out.pop("top"):
        log(f"[lm-profile]   {line}")
    return out


# cuBLAS's GEMM kernels, by the names they carry on the H100
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def device_ms_by_kind(torch, prof, n: int, kinds: dict, ranges: dict):
    """A torch.profiler session's device time a step, over ``n`` steps:
    for each kind, the kernels whose names hold one of its patterns; for
    each ``ranges`` entry, the kernels launched inside that host range
    (an ``obs/trace.layer`` range of the program or a ``record_function``
    range: its device time, read on the host-side range).
    With the kernels a step, their device ms a step and the 8 largest
    kernels as log lines (``top``); None if no device event was traced."""
    avg = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # a record_function range shows on the device too, as a span over its
    # kernels: keep it out of the kernels
    kern = [e for e in avg if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]
    if not kern:
        return None
    ms = {k: sum(e.self_device_time_total for e in kern
                 if any(p in e.key for p in pats)) / 1e3 / n
          for k, pats in kinds.items()}
    for k, name in ranges.items():
        ms[k] = sum(e.device_time_total for e in avg
                    if e.key == name and e.device_type != cuda) / 1e3 / n
    top = [f"device {e.self_device_time_total / 1e3 / n:8.3f} ms a step "
           f"x{e.count / n:6.1f}  {e.key[:90]}"
           for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]]
    return {"kernels_per_step": sum(e.count for e in kern) / n,
            "kernel_ms_per_step": sum(e.self_device_time_total
                                      for e in kern) / 1e3 / n,
            "by_kind_ms_per_step": ms, "top": top}


def run_qwen3_training(torch, dev="cuda:0") -> dict:
    """Phase 16c: qwen3-14b at full width (2 of its 40 layers), bf16,
    random weights from seed 0; 2 clients, 2 sequences of 1,024 tokens a
    client a step (``make_token_stream``, IID); stl_sc, k1 4, T1 16, 2
    stages (48 local steps), dense Star, through the launcher's path. The
    loss finite and its last stage's mean below its first's, the launches
    of the path, the ledger equal to the integer formula. Then one stage
    of topology "streaming" from the same start, bit-equal to a blocking
    stage; a profile of 4 local steps."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import local_sgd as LS
    from repro_torch.utils.tree import tree_leaves

    dev = torch.device(dev)
    q = QWEN3_TRAIN
    full = get_arch("qwen3-14b")
    cfg = full.replace(n_layers=q["layers"])
    log(f"[cut] phase 16c: qwen3-14b at full width, depth cut to "
        f"{q['layers']} of {full.n_layers} layers; {q['stages']} stl_sc "
        f"stages")

    def tcfg(stages, topology="star"):
        return TrainConfig(algo="stl_sc", eta1=q["eta1"], T1=q["T1"],
                           k1=q["k1"], n_stages=stages, topology=topology)

    state = LS.init_state(0, cfg, q["clients"], device=dev)
    n_params = sum(t[0].numel() for t in tree_leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves([state["params"], state["opt"]])) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    ds = lm_train(torch, cfg, dev, state, tcfg(q["stages"]),
                  clients=q["clients"], batch=q["batch"], seq=q["seq"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r.mean_loss for r in ds.results]
    tokens = q["clients"] * q["batch"] * q["seq"]
    mm_all, mm_layers = lm_matmul_params(cfg)
    attn = cfg.attention
    pairs = q["seq"] * (q["seq"] + 1) // 2
    # GEMMs: forward + backward (6 FLOPs a parameter a token) and the
    # layers' remat forward (2); attention: the flash forward twice, the
    # backward (10·D a pair, as 16a)
    n_flops = (tokens * (6 * mm_all + 2 * mm_layers)
               + q["clients"] * q["batch"] * cfg.n_layers * attn.n_heads
               * attn.head_dim * pairs * (4 + 4 + 10))
    step_bound = n_flops / BF16_FLOPS * 1e3
    per_client = sum(t[0].numel() * t.element_size()
                     for t in tree_leaves(ds.state["params"]))
    log(f"[lm] qwen3-14b, {cfg.n_layers} layers: {n_params} parameters a "
        f"client, state {state_gb:.2f} GB; {ds.iters_total} local steps, "
        f"{ds.rounds_total} rounds in {wall:.2f} s "
        f"({wall * 1e3 / ds.iters_total:.2f} ms a step, rounds included; "
        f"bound {step_bound:.2f} ms a step: {n_flops / 1e12:.2f} TFLOP at "
        f"989 TFLOP/s); eta1 {q['eta1']}; stage mean losses "
        f"{[round(v, 4) for v in losses]}; peak memory {peak_gb:.2f} GB; "
        f"comm bytes {ds.comm_bytes_total}; launches {counts}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"qwen3 training: stage losses {losses}")
    if ds.comm_bytes_total != ds.rounds_total * q["clients"] * per_client:
        raise AssertionError(f"qwen3 training: ledger {ds.comm_bytes_total}")
    expect_launches("qwen3 training", counts,
                    lm_launches(cfg, ds, q["clients"], 0))
    out = {"params_per_client": n_params, "state_gb": state_gb,
           "iters": ds.iters_total, "rounds": ds.rounds_total,
           "wall_s": wall, "ms_per_step": wall * 1e3 / ds.iters_total,
           "bound_ms_per_step": step_bound, "eta1": q["eta1"],
           "stage_losses": losses, "peak_gb": peak_gb,
           "comm_bytes": ds.comm_bytes_total, "launches": counts}
    torch.cuda.empty_cache()
    out["update_check"] = check_lm_update(torch, cfg, ds.state, q)
    out["profile"] = profile_lm(torch, cfg, dev, ds.state, tcfg(1), q)
    del ds, state
    torch.cuda.empty_cache()

    # one stage of the per-leaf streaming round from the same start,
    # against one blocking stage
    finals = {}
    for topology in ("streaming", "star"):
        ds = lm_train(torch, cfg, dev, LS.init_state(0, cfg, q["clients"],
                                                     device=dev),
                      tcfg(1, topology), clients=q["clients"],
                      batch=q["batch"], seq=q["seq"])
        finals[topology] = ([r.mean_loss for r in ds.results],
                            [t.clone() for t in tree_leaves(
                                ds.state["params"])] if topology ==
                            "streaming" else tree_leaves(ds.state["params"]))
        if topology == "streaming":
            del ds
    equal = finals["streaming"][0] == finals["star"][0] and all(
        torch.equal(a, b) for a, b in zip(finals["streaming"][1],
                                          finals["star"][1]))
    log(f"[lm] one stage streaming against blocking: mean losses "
        f"{finals['streaming'][0]} / {finals['star'][0]}, params "
        f"{'bit-equal' if equal else 'DIFFER'}")
    if not equal:
        raise AssertionError("qwen3 training: streaming != blocking")
    out["streaming_bit_equal"] = True
    del finals, ds
    torch.cuda.empty_cache()
    return out



# phase 17: Mamba2 training. 17a's SSD cases, float32 as apply_mamba2 hands
# the scan its inputs: mamba2-2.7b's training layer (2 sequences of 1,024
# tokens, 80 heads of 64, N = 128, chunk 256) and 17b's (mamba2-2.7b SMOKE:
# 2 sequences of 64 tokens, 8 heads of 64, N = 32, chunk 64)
SSD_TRAIN_CASES = {"mamba2 train": (2, 1024, 80, 64, 1, 128, 256),
                   "mamba2 smoke": (2, 64, 8, 64, 1, 32, 64)}
# and the benchmark cell's (mamba2-2.7b.train.s1024: 4 rows of 1,024 tokens
# a client), where 17a times the backward kernel too
SSD_CELL_CASE = {"mamba2 cell": (4, 1024, 80, 64, 1, 128, 256)}
# 17c: mamba2-2.7b at full width through launch/train.main, its depth cut
# to 8 of 64 layers (16 since phase 19 joined the script, 8 since phase 22
# did: the run's time): 2
# clients, 2 sequences of 1,024 tokens a client a step, stl_sc T1 8, k1 4,
# 2 stages cut at 16 local steps (8 + 8, 3 rounds); the profiler traces 2
# train steps after a warm-up one (a whole run's trace would be gigabytes)
MAMBA2_TRAIN = {"layers": 8, "clients": 2, "batch": 2, "seq": 1024,
                "T1": 8, "k1": 4.0, "stages": 2, "steps": 16, "eta1": 0.05,
                "profile_calls": 2}
# 17d: the checkpoint 17c wrote, behind launch/serve.main
SERVE_CKPT = {"requests": 4, "slots": 4, "prompt_len": 300, "gen": 8,
              "max_seq_len": 2048}


def ssd_bwd_work(b, S, H, P, G, N, chunk, init=False):
    """(bytes, FLOPs) the SSD scan's vector-Jacobian product must move and
    compute at this shape, in float32: x, dt, A, B, C and dL/dy read once
    and the gradients of x, dt, A, B, C written once (with ``init`` the
    initial state read and its gradient written); twice the forward's
    FLOPs (``ssd_work``), since each multiply-add of the forward has one in
    the gradient of each of its two operands."""
    _, f = ssd_work(b, S, H, P, G, N, chunk, 4, init)
    elems = 2 * b * S * H * P + b * S * H + H + 2 * b * S * G * N
    n_bytes = 4 * (2 * elems + b * S * H * P + (2 * b * H * P * N if init
                                                else 0))
    return n_bytes, 2.0 * f


def check_ssd_grad(torch) -> dict:
    """Phase 17a: the SSD Function on the card at the training shapes and
    the benchmark cell's. The kernel route's y and final state have a
    grad_fn and are held to the plain version at phase 8's tolerance; for
    one fixed dL/dy, one backward launches the backward kernel once, and
    its dx, ddt, dA, dB and dC are finite and within 3e-4 of each
    gradient's largest magnitude of autograd through the plain version.
    Not bit for bit: the kernel computes the same float32 function in
    another order over split bf16 products (the Function's backward
    recomputed the plain version until it had a kernel). Times: the
    kernel's forward, the backward kernel and the plain backward (the
    recompute and vector-Jacobian product the Function ran before) against
    the backward's bound (``ssd_bwd_work``, phase 8's scheme of three bf16
    tensor-core products per float32 product, or bytes)."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ops import plain_ssd, ssd

    g = torch.Generator(device="cuda:0").manual_seed(5)
    rows = {}
    for label, (b, S, H, P, G, N, chunk) in {**SSD_TRAIN_CASES,
                                              **SSD_CELL_CASE}.items():
        args = ssd_inputs(torch, g, b, S, H, P, G, N, torch.float32)
        gy = torch.randn(args[0].shape, generator=g, device="cuda:0")
        ins = [t.clone().requires_grad_() for t in args]
        n0, m0 = SK.ssd.launches, SK.ssd_bwd.launches
        y, st = ssd(*ins, chunk=chunk)
        grads = torch.autograd.grad(y, ins, gy, retain_graph=True)
        pins = [t.clone().requires_grad_() for t in args]
        yp, sp = plain_ssd(*pins, chunk)
        pgrads = torch.autograd.grad(yp, pins, gy)
        torch.cuda.synchronize()
        if y.grad_fn is None or SK.ssd.launches != n0 + 1 or \
                SK.ssd_bwd.launches != m0 + 1:
            raise AssertionError(f"ssd {label}: the kernel route gave no "
                                 f"grad_fn or launched the forward "
                                 f"{SK.ssd.launches - n0} and the backward "
                                 f"{SK.ssd_bwd.launches - m0} times")
        gerr = {name: float((a - w).abs().max() / w.abs().max())
                for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"),
                                      grads, pgrads)}
        if not all(v <= 3e-4 for v in gerr.values()) or \
                not all(bool(torch.isfinite(a).all()) for a in grads):
            raise AssertionError(f"ssd {label}: dx/ddt/dA/dB/dC off the "
                                 f"plain route: {gerr}")
        err, worst = off_by(((y.detach(), yp.detach()),
                             (st.detach(), sp.detach())), 3e-4)
        if not worst <= 1.0:
            raise AssertionError(f"ssd {label}: forward off the plain "
                                 f"version: {err}")
        del yp, sp, pgrads
        big = S >= 1024
        fwd_ms = device_ms(torch, lambda: ssd(*args, chunk=chunk),
                           batch=2 if big else 10,
                           reps=10 if big else TIMING_REPS)
        bwd_ms = device_ms(torch, lambda: torch.autograd.grad(
            y, ins, gy, retain_graph=True), batch=2 if big else 10,
            reps=10 if big else TIMING_REPS)
        plain_ms = device_ms(torch, lambda: torch.autograd.grad(
            plain_ssd(*pins, chunk)[0], pins, gy), batch=1 if big else 10,
            reps=5 if big else TIMING_REPS)
        n_bytes, n_flops = ssd_bwd_work(b, S, H, P, G, N, chunk)
        bms, by = bound_ms(n_bytes, n_flops, BF16_FLOPS / 3)
        f32_ms = n_flops / F32_FLOPS * 1e3
        rows[label] = {"shape": [b, S, H, P, G, N], "chunk": chunk,
                       "grads_rel_err": gerr, "max_abs_err": err,
                       "of_tol": worst, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                       "plain_bwd_ms": plain_ms, "bwd_bound_ms": bms,
                       "bwd_bound_by": by, "bwd_bytes": n_bytes,
                       "bwd_flops": n_flops, "bwd_f32_cores_ms": f32_ms}
        log(f"[ssd-grad] {label} {(b, S, H, P)} G {G} N {N} chunk {chunk} "
            f"float32: dx/ddt/dA/dB/dC within "
            f"{max(gerr.values()):.2e} of their largest magnitudes of the "
            f"plain route (tol 3e-4), one ssd_bwd launch; forward max err "
            f"{err:.3g} ({worst:.3f} of tol 3e-4); kernel forward "
            f"{fwd_ms:.4f} ms; backward kernel {bwd_ms:.4f} ms against its "
            f"bound {bms:.4f} ms ({by}: {n_flops / 1e9:.2f} GFLOP x 3 bf16 "
            f"products, {n_bytes / 1e6:.1f} MB; on the CUDA cores alone "
            f"{f32_ms:.4f} ms), {100 * bms / bwd_ms:.1f}% of it; plain "
            f"backward {plain_ms:.3f} ms ({plain_ms / bwd_ms:.1f}x the "
            f"kernel's)")
        del y, st, grads, ins, pins, args, gy
        torch.cuda.empty_cache()
    return rows


def mamba2_step_work(cfg, q) -> dict:
    """The least work of one local step of 17c: the GEMMs' FLOPs (forward
    and backward, 6 a matmul parameter a token, and the layers' remat
    forward, 2) and the SSD scan's (the forward twice, the backward once,
    ``ssd_work`` / ``ssd_bwd_work`` at the training layer)."""
    from repro_torch.models.transformer import padded_vocab

    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    H = d_inner // ssm.head_dim
    d_in_proj = 2 * d_inner + 2 * ssm.n_groups * ssm.d_state + H
    layers = cfg.n_layers * (cfg.d_model * d_in_proj + d_inner * cfg.d_model)
    mm_all = layers + cfg.d_model * padded_vocab(cfg)
    tokens = q["clients"] * q["batch"] * q["seq"]
    gemm = tokens * (6 * mm_all + 2 * layers)
    shape = (q["batch"], q["seq"], H, ssm.head_dim, ssm.n_groups,
             ssm.d_state, ssm.chunk_size)
    scan = cfg.n_layers * q["clients"] * (
        2 * ssd_work(*shape, 4)[1] + ssd_bwd_work(*shape)[1])
    return {"gemm_flops": gemm, "scan_flops": scan,
            "bound_ms": (gemm / BF16_FLOPS + scan / (BF16_FLOPS / 3)) * 1e3}


def run_mamba2_training(torch, tmp: Path) -> dict:
    """Phase 17c: mamba2-2.7b at full width, its depth cut to 8 of 64
    layers (bf16, seed 0), through ``launch/train.main`` with
    ``--profile --profile-dir --profile-calls --trace --ckpt-out``: the
    loss finite and its last stage's mean below its first's, the
    launches of the path, the ledger equal to rounds x clients x a
    replica's bytes, ms a step (the median
    of the untraced train steps after the first) against its bound
    (``mamba2_step_work``), peak memory, the skew table, device ms a step
    by kind from the profiler's window and the plain SSD backward's share
    of the step; the Chrome trace parses and holds the train_step spans,
    its .jsonl round-trips through read_jsonl, the torch.profiler trace
    exists under the profile dir. Then one client's fused update at the
    trained state, as 16c checks it."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as TT
    from repro_torch.obs import read_jsonl
    from repro_torch.utils.tree import tree_leaves, tree_map

    q = MAMBA2_TRAIN
    full = get_arch("mamba2-2.7b")
    cfg = full.replace(n_layers=q["layers"])
    log(f"[cut] phase 17c: mamba2-2.7b at full width, depth cut to "
        f"{q['layers']} of {full.n_layers} layers")
    trace, prof_dir, ck = tmp / "train.json", tmp / "prof", tmp / "ck"
    argv = ["--arch", "mamba2-2.7b", "--layers", str(q["layers"]),
            "--clients", str(q["clients"]),
            "--batch", str(q["batch"]), "--seq", str(q["seq"]),
            "--algo", "stl_sc", "--eta1", str(q["eta1"]),
            "--T1", str(q["T1"]), "--k1", str(q["k1"]),
            "--stages", str(q["stages"]), "--steps", str(q["steps"]),
            "--profile", "--profile-dir", str(prof_dir),
            "--profile-calls", str(q["profile_calls"]),
            "--trace", str(trace), "--ckpt-out", str(ck)]
    log(f"[mamba2-train] launch.train.main {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    ds = TT.main(argv)
    torch.cuda.synchronize()
    t_end = time.monotonic()
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = ds.profile
    steps = [r for r in prof.records if r.name == "train_step"]
    untraced = [r.measured_s for r in steps[1:] if not r.attrs.get("traced")]
    ms_step = statistics.median(untraced) * 1e3
    work = mamba2_step_work(cfg, q)
    losses = [r.mean_loss for r in ds.results]
    n_params = sum(t[0].numel() for t in tree_leaves(ds.state["params"]))
    per_client = sum(t[0].numel() * t.element_size()
                     for t in tree_leaves(ds.state["params"]))
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(
        [ds.state["params"], ds.state["opt"]])) / 1e9
    log(f"[mamba2-train] mamba2-2.7b, {cfg.n_layers} layers: {n_params} "
        f"parameters a client, state {state_gb:.2f} GB; {ds.iters_total} "
        f"local steps, {ds.rounds_total} rounds; main() {t_end - t0:.2f} s "
        f"({t_end - steps[-1].t1:.2f} s after the last step: the skew "
        f"table, the trace and the checkpoint); {ms_step:.2f} ms a step "
        f"(median of {len(untraced)} untraced steps; the first "
        f"{steps[0].measured_s * 1e3:.1f} ms) against a {work['bound_ms']:.2f}"
        f" ms bound ({work['gemm_flops'] / 1e12:.2f} TFLOP of GEMMs at 989 "
        f"TFLOP/s, {work['scan_flops'] / 1e12:.2f} TFLOP of scan at a third "
        f"of it); eta1 {q['eta1']}; stage mean losses "
        f"{[round(v, 4) for v in losses]}; peak memory {peak_gb:.2f} GB; "
        f"comm bytes {ds.comm_bytes_total}; launches {counts}")
    for row in prof.skew_table():
        log(f"[mamba2-train] skew {row['name']:<12} calls {row['calls']:3d} "
            f"modeled {row['modeled_s']:.4e} s measured "
            f"{row['measured_s']:.4e} s skew {row['skew']:.2f}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"mamba2 training: stage losses {losses}")
    if ds.comm_bytes_total != ds.rounds_total * q["clients"] * per_client:
        raise AssertionError(f"mamba2 training: ledger {ds.comm_bytes_total}")
    expect_launches("mamba2 training", counts,
                    lm_launches(cfg, ds, q["clients"], 0))

    # the files the flags asked for
    events = json.load(open(trace))["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    n_step_spans = sum(e["name"] == "profile.train_step" for e in xs)
    spans = read_jsonl(str(trace) + "l")
    if n_step_spans != ds.iters_total or len(spans) != len(xs) or \
            [s.name for s in spans] != [e["name"] for e in xs]:
        raise AssertionError(f"mamba2 training: trace {n_step_spans} "
                             f"train_step spans, {len(xs)} events, "
                             f"{len(spans)} spans read back")
    ptrace = prof.trace_path
    if not ptrace or Path(ptrace).parent != prof_dir or \
            not Path(ptrace).stat().st_size:
        raise AssertionError(f"mamba2 training: no torch.profiler trace "
                             f"under {prof_dir}: {ptrace}")
    traced = [r.name for r in prof.records if r.attrs.get("traced")]
    n_traced = traced.count("train_step")
    kinds = device_ms_by_kind(
        torch, prof.profiler, n_traced,
        {"gemm": GEMM_KERNELS, "ssd_forward": ("ssd_cb_kernel",
                                               "ssd_chunk_kernel"),
         "fused_update": ("fused_sgd_update",),
         "loss_log_softmax": ("LogSoftMax",)},
        {"ssd_backward": "ssd.backward"})
    out = {"params_per_client": n_params, "state_gb": state_gb,
           "iters": ds.iters_total, "rounds": ds.rounds_total,
           "ms_per_step": ms_step, "first_step_ms":
           steps[0].measured_s * 1e3, **work, "eta1": q["eta1"],
           "stage_losses": losses, "peak_gb": peak_gb,
           "comm_bytes": ds.comm_bytes_total, "launches": counts,
           "skew_table": prof.skew_table(), "traced_calls": traced,
           "trace_spans": len(spans),
           "profile_trace_mb": Path(ptrace).stat().st_size / 1e6,
           "after_last_step_s": t_end - steps[-1].t1}
    if kinds is None:
        log("[mamba2-train] device time by kind not measured (no CUDA "
            "events traced)")
    else:
        by = kinds["by_kind_ms_per_step"]
        traced_ms = statistics.median(r.measured_s for r in steps
                                      if r.attrs.get("traced")) * 1e3
        window_ms = sum(r.measured_s for r in prof.records
                        if r.attrs.get("traced")) * 1e3
        busy = 100 * busy_union_us(torch, prof.profiler) / 1e3 / window_ms
        share = by["ssd_backward"] / traced_ms
        out.update(profile={k: v for k, v in kinds.items() if k != "top"},
                   traced_step_ms=traced_ms, busy_union_pct=busy,
                   ssd_backward_share=share)
        log(f"[mamba2-train] profile of {n_traced} traced train steps "
            f"({traced} traced; {traced_ms:.2f} ms a traced step, "
            f"{out['profile_trace_mb']:.1f} MB of trace): "
            f"{kinds['kernels_per_step']:.0f} kernels a step, a kernel "
            f"running {busy:.1f}% of the window, device "
            f"{kinds['kernel_ms_per_step']:.2f} ms a step; by kind: "
            + ", ".join(f"{k} {v:.3f}" for k, v in by.items())
            + f" ms a step; the SSD backward {100 * share:.1f}% of a "
            f"traced step")
        for line in kinds["top"]:
            log(f"[mamba2-train]   {line}")
    # per-leaf float64 sums of the consensus the checkpoint holds, for 17d
    # (before the update check, which steps client 0's rows in place)
    consensus = tree_map(lambda p: torch.mean(p, dim=0), ds.state["params"])
    out["consensus_sums"] = [float(t.double().sum())
                             for t in tree_leaves(consensus)]
    del consensus
    torch.cuda.empty_cache()
    out["update_check"] = check_lm_update(torch, cfg, ds.state, q)
    del ds, prof
    torch.cuda.empty_cache()
    return out


def serve_checkpoint(torch, ck: Path, tmp: Path, sums,
                     kname: str = "ssd") -> dict:
    """Phase 17d (19c): 17c's checkpoint (19c's) behind
    ``launch/serve.main(["--ckpt", ..., "--trace", ..., "--profile"])`` on
    the card: every request served, the restored params' per-leaf sums
    equal those of the consensus trained, ``kname`` launched once a layer
    of its kind a multi-token prefill (the SSD scan 8 times), each first
    token equal to ``greedy_decode``'s on the restored params (later ones
    up to a near tie, as phase 10), the serve trace parses."""
    from unittest import mock

    from repro_torch import kernels
    from repro_torch.launch import serve as TS
    from repro_torch.models import transformer as TF
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.tree import tree_leaves

    s = SERVE_CKPT
    strace = tmp / "serve.json"
    seen = {}
    run = ServeEngine.run

    def spy(self, requests, *a, **kw):
        seen["engine"], seen["requests"] = self, requests
        return run(self, requests, *a, **kw)

    argv = ["--ckpt", str(ck), "--trace", str(strace), "--profile",
            "--requests", str(s["requests"]), "--slots", str(s["slots"]),
            "--prompt-len", str(s["prompt_len"]), "--gen", str(s["gen"]),
            "--max-seq-len", str(s["max_seq_len"])]
    log(f"[serve-ckpt] launch.serve.main {' '.join(argv)}")
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    with mock.patch.object(ServeEngine, "run", spy):
        report = TS.main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    eng, reqs = seen["engine"], seen["requests"]
    got = [float(t.double().sum()) for t in tree_leaves(
        TF.to_grouped(eng.params, eng.cfg))]
    if got != sums:
        raise AssertionError("serve from the checkpoint: the restored "
                             "params differ from the trained consensus")
    multi = sum(1 for r in reqs if r.prompt_len > 1)
    log(f"[serve-ckpt] {eng.cfg.name} restored and served in {wall:.2f} s: "
        f"{len(report.completed)}/{len(reqs)} requests (prompts "
        f"{[r.prompt_len for r in reqs]}), {report.n_prefills} prefills, "
        f"{report.n_steps} decode steps; launches {counts}; the restored "
        f"params' per-leaf sums equal the trained consensus's")
    for row in report.profile.skew_table():
        log(f"[serve-ckpt] skew {row['name']:<17} calls {row['calls']:3d} "
            f"modeled {row['modeled_s']:.4e} s measured "
            f"{row['measured_s']:.4e} s skew {row['skew']:.2f}")
    if len(report.completed) != len(reqs) or \
            counts[kname] != kernel_layers(eng.cfg, kname) * multi:
        raise AssertionError(f"serve from the checkpoint: {counts[kname]} "
                             f"{kname} launches for {multi} multi-token "
                             f"prefills, {len(report.completed)} served")
    names = {e["name"] for e in json.load(open(strace))["traceEvents"]}
    if not {"serve_run", "decode_step", "profile.serve.prefill"} <= names:
        raise AssertionError(f"serve from the checkpoint: trace {names}")
    compared, total = hold_to_greedy(torch, f"{eng.cfg.name} (checkpoint)",
                                     eng.params, eng.cfg, reqs,
                                     report.records, s["max_seq_len"])
    log(f"[serve-ckpt] tokens held to greedy_decode: {compared} of {total}")
    out = {"wall_s": wall, "requests": len(reqs), "launches": counts[kname],
           "multi_token_prefills": multi, "tokens_compared": compared,
           "tokens_total": total, "skew_table": report.profile.skew_table()}
    del eng, seen, report
    torch.cuda.empty_cache()
    return out


def run_mamba2_phase(torch) -> dict:
    """Phase 17: 17a the SSD Function's gradients, 17b mamba2 SMOKE card
    against CPU, 17c mamba2-2.7b training at full width (8 of 64 layers),
    17d serving its checkpoint. The checkpoint and traces go to a temporary
    directory, removed at the end."""
    import tempfile

    out = {"ssd_grad": check_ssd_grad(torch),
           "check": train_reference_check(torch, "mamba2-2.7b")}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        train = run_mamba2_training(torch, tmp)
        sums = train.pop("consensus_sums")
        out["train"] = train
        out["serve"] = serve_checkpoint(torch, tmp / "ck", tmp, sums)
    return out


# phase 18: MoE and MLA. 18a's flash cases beside phase 5's: gemma3-12b's
# local layer (window 1,024, 16/8 heads of 256) at its 4,608-token prefill
# and phi3.5-moe's training layer (2 sequences of 1,024 tokens, 32/8 heads
# of 128); and the zero-padded MLA calls at deepseek-v2's layer (128 heads,
# q/k 128 + 64 → 256, v 128 → 256) and minicpm3-4b's (40 heads, 64 + 32 →
# 128, v 64 → 128) over 4,096 tokens, bf16
MOE_FLASH_CASES = {
    "gemma3 local": (1, 4608, 16, 8, 256, "bf16", 1024, None),
    "phi3.5 train": (2, 1024, 32, 8, 128, "bf16", None, None),
}
MLA_FLASH_CASES = {"deepseek-v2 mla": (1, 4096, 128, 192, 128),
                   "minicpm3 mla": (1, 4096, 40, 96, 64)}
# 18a's SMOKE checks: the serving path on the card against the CPU (80-token
# prompts past the 64-token windows), then 16b's training check (dense and
# int8 Star) on the two new trainable kinds of layer
MOE_SERVE_REFS = (("gemma3-12b", False), ("minicpm3-4b", False),
                  ("phi3.5-moe-42b-a6.6b", False), ("deepseek-v2-236b", False),
                  ("gemma2-27b", True))
MOE_TRAIN_REFS = ("phi3.5-moe-42b-a6.6b", "minicpm3-4b")
# 18c: the int8 cache's first decode step against the bf16 cache's, on one
# prompt past the window: the reference's bound (tests/test_variants.py)
KV_QUANT_TOL, KV_QUANT_PROMPT = 2e-2, 2000
# 18d: phi3.5-moe at full width, its depth cut to 2 of 32 layers, through
# launch/train.main; 16c's schedule and rate (T1 16, k1 4), 2 stages, the
# second cut at 16 of its 32 local steps (32 in all); the profiler traces
# 2 train steps after a warm-up one
PHI35_TRAIN = {"layers": 2, "clients": 2, "batch": 2, "seq": 1024,
               "T1": 16, "k1": 4.0, "stages": 2, "steps": 32, "eta1": 0.03,
               "profile_calls": 2}


def check_mla_flash(torch) -> dict:
    """Phase 18a: the zero-padded MLA call (``models/attention.
    _padded_flash``: q, k and v padded to the kernel's head dim, the scale
    of the unpadded q, the output cut back to v's dim) on the card against
    the plain attention on the unpadded dims (``attention.attend``), held
    to ref.py's bf16 tolerance as phase 5 holds flash. Timed like phase 5:
    the call (its padding copies included) and the kernel alone on the
    padded inputs, beside the unpadded work's bound (2·(Dqk + Dv) FLOPs a
    visible pair and head) and the padded work's, the plain version and
    SDPA on the unpadded dims (q/k and v of different widths)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import bf16_mismatch
    from repro_torch.launch.flops import _attn_pairs
    from repro_torch.models import attention as A

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    rows = {}
    for label, (B, S, H, dqk, dv) in MLA_FLASH_CASES.items():
        q, k = (torch.randn((B, S, H, dqk), generator=g, device=dev).to(bf)
                for _ in range(2))
        v = torch.randn((B, S, H, dv), generator=g, device=dev).to(bf)
        D = next(d for d in A.HEAD_DIMS if d >= max(dqk, dv))
        scale = 1.0 / math.sqrt(dqk)
        pos = torch.arange(S, device=dev)
        bias = A._mask_bias(pos, pos, None)
        call = lambda: A._padded_flash(q, k, v, D, window=None, softcap=None,
                                       scale=scale)
        plain = lambda: A.attend(q, k, v, bias, None, scale)
        out = call()
        ref = A.attend(q.float(), k.float(), v.float(), bias, None, scale)
        torch.cuda.synchronize()
        err, elem, row = bf16_mismatch(out, ref)
        if not (elem <= 1.0 and row <= 1.0 and out.shape == v.shape):
            raise AssertionError(f"padded MLA flash {label}: max err {err}, "
                                 f"{elem} / {row} of tol")
        del out
        pad = lambda t: torch.nn.functional.pad(t, (0, D - t.shape[-1]))
        qp, kp, vp = pad(q), pad(k), pad(v)
        kern_ms = device_ms(torch, lambda: flash_attention(
            qp, kp, vp, scale=scale), batch=2, reps=10)
        call_ms_ = device_ms(torch, call, batch=2, reps=10)
        plain_ms = device_ms(torch, plain, batch=1, reps=3)
        lib = lib_err = None
        lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=scale).transpose(1, 2)
        try:
            lib_out = lib_fn()
        except RuntimeError as e:   # a library limit, logged: not the port
            log(f"[mla-flash] SDPA takes no {dqk}/{dv} head dims here: {e}")
        else:
            lib_err, lib_elem, lib_row = bf16_mismatch(lib_out, ref)
            if not (lib_elem <= 1.0 and lib_row <= 1.0):
                raise AssertionError(f"SDPA {label}: max err {lib_err}")
            del lib_out
            lib = device_ms(torch, lib_fn, batch=2, reps=10)
        pairs = _attn_pairs(S, None, "prefill")
        work = 2.0 * B * H * pairs * (dqk + dv)
        padded = 4.0 * B * H * pairs * D
        n_bytes = (q.numel() + k.numel() + 2 * v.numel()) * 2
        bms, by = bound_ms(n_bytes, work, BF16_FLOPS)
        pms = padded / BF16_FLOPS * 1e3
        rows[label] = {"shape": [B, S, H, dqk, dv], "padded_to": D,
                       "ms": call_ms_, "kernel_ms": kern_ms,
                       "plain_ms": plain_ms, "library_ms": lib,
                       "bound_ms": bms, "bound_by": by,
                       "padded_bound_ms": pms, "max_abs_err": err,
                       "elem_of_tol": elem, "row_of_tol": row}
        log(f"[mla-flash] {label} {(B, S, H)} q/k {dqk} v {dv} padded to "
            f"{D}: the call {call_ms_:.4f} ms (the kernel alone "
            f"{kern_ms:.4f} ms), plain {plain_ms:.3f} ms, SDPA "
            f"{'-' if lib is None else f'{lib:.4f} ms'}; unpadded work's "
            f"bound {bms:.4f} ms ({by}), padded work's {pms:.4f} ms; max err "
            f"{err:.3g}, elementwise {elem:.3f}, per-row {row:.3f} of tol")
        del q, k, v, qp, kp, vp, ref
        torch.cuda.empty_cache()
    return rows


# 18b's and 18c's decode profile: device ms a step inside host ranges that
# the harness opens around each layer's attention (and the int8 cache's
# dequantisation inside it), its MoE layer and its dense MLP, beside the
# model's own ``moe.*`` ranges
DECODE_RANGES = {"attention": "layer.attention",
                 "attention.dequant": "layer.attention.dequant",
                 "moe": "layer.moe", "mlp": "layer.mlp",
                 "rglru": "layer.rglru",
                 "moe.route": "moe.route", "moe.dispatch": "moe.dispatch",
                 "moe.experts": "moe.experts", "moe.combine": "moe.combine"}
DECODE_PROFILE_STEPS = 4


def layer_ranges(torch):
    """Patches (one context) that open the ``DECODE_RANGES`` ranges of
    the layer's parts around ``attention.apply_attention``,
    ``attention._dequant``, ``moe.apply_moe``, ``rglru.apply_rglru`` and
    the transformer's dense ``apply_mlp``."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.models import attention as A
    from repro_torch.models import moe as MOE
    from repro_torch.models import rglru as RG
    from repro_torch.models import transformer as TF

    def ranged(fn, name):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    stack = ExitStack()
    for mod, attr, key in ((A, "apply_attention", "attention"),
                           (A, "_dequant", "attention.dequant"),
                           (MOE, "apply_moe", "moe"), (TF, "apply_mlp", "mlp"),
                           (RG, "apply_rglru", "rglru")):
        stack.enter_context(mock.patch.object(
            mod, attr, ranged(getattr(mod, attr), DECODE_RANGES[key])))
    return stack


def profile_decode(torch, cfg, params, sched, long_prompt) -> dict:
    """torch.profiler over ``DECODE_PROFILE_STEPS`` full-width decode
    steps of ``sched.n_slots`` slots, each slot after a 512-token prefill
    of the long prompt, one step first as a warm-up: device ms a step in
    each ``DECODE_RANGES`` range and outside the layers' parts
    (``other``: embedding, norms, the head), the kernels a step, and the
    share of the wall under the profiler in which a kernel ran
    (``busy_union_us``); the wall alone where no device event was traced."""
    from repro_torch.models import transformer as TF

    dev = torch.device("cuda:0")
    n = DECODE_PROFILE_STEPS
    stacked = TF.init_cache(cfg, sched.n_slots, sched.max_seq_len, device=dev)
    prompt = torch.as_tensor(long_prompt[None, :512], dtype=torch.long,
                             device=dev)
    toks = torch.zeros((sched.n_slots, 1), dtype=torch.long, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        for slot in range(sched.n_slots):
            TF.prefill(params, cfg, prompt,
                       TF.cache_rows(stacked, slot, slot + 1))
        TF.decode_step(params, cfg, toks, stacked)
        torch.cuda.synchronize()
        with layer_ranges(torch), \
                torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            for _ in range(n):
                TF.decode_step(params, cfg, toks, stacked)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    del stacked
    torch.cuda.empty_cache()
    out = {"steps": n, "wall_ms_per_step": wall * 1e3 / n}
    res = device_ms_by_kind(torch, prof, n, {}, DECODE_RANGES)
    if res is None:
        log(f"[profile] {cfg.name} decode: {wall * 1e3 / n:.2f} ms a step "
            f"under the profiler; device time not measured (no CUDA events "
            f"traced)")
        return out
    ms = res["by_kind_ms_per_step"]
    ms["other"] = res["kernel_ms_per_step"] - sum(
        ms[k] for k in ("attention", "moe", "mlp", "rglru"))
    att = [e for e in prof.events() if e.name == DECODE_RANGES["attention"]]
    traced = sum(1 for e in att if e.device_time_total > 0)
    busy = busy_union_us(torch, prof) / (wall * 1e6)
    out.update(kernels_per_step=res["kernels_per_step"],
               kernel_ms_per_step=res["kernel_ms_per_step"],
               ms_per_step_by_range=ms, busy_pct=100 * busy,
               attention_calls_traced=[traced, len(att)])
    log(f"[profile] {cfg.name} decode, {sched.n_slots} slots, {n} steps: "
        f"{wall * 1e3 / n:.2f} ms a step under the profiler, "
        f"{res['kernels_per_step']:.0f} kernels and "
        f"{res['kernel_ms_per_step']:.3f} ms of device time a step, a kernel "
        f"running {100 * busy:.1f}% of the wall; device ms a step by range: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; device events on {traced} of {len(att)} attention calls")
    for line in res["top"]:
        log(f"[profile]   {line}")
    return out


def deepseek_serve_extra(torch, cfg, params, long_prompt, sched) -> dict:
    """18b's extra readings: the prefill and decode-step bounds the
    serving engine prices (``launch/flops.py`` through ``DeviceModel``:
    a decode step reads every expert's weights, as the capacity buffers
    do), the share of assignments capacity dropped at the long prompt's
    prefill, layer by layer, and the decode profile
    (``profile_decode``)."""
    from repro_torch.models import transformer as TF

    n_long = len(long_prompt)
    bounds = serve_bounds(cfg, n_long, sched)
    routes = []
    dev = torch.device("cuda:0")
    with torch.no_grad(), recording_routes(routes):
        cache = TF.init_cache(cfg, 1, n_long, device=dev)
        TF.prefill(params, cfg, torch.as_tensor(long_prompt[None],
                                                dtype=torch.long, device=dev),
                   cache)
    dropped = [float((~r.keep).float().mean()) for r in routes]
    del cache, routes
    torch.cuda.empty_cache()
    log(f"[serve] {cfg.name}: bounds (launch/flops via DeviceModel) "
        + ", ".join(f"{k} {v:.3f}" for k, v in bounds.items())
        + f"; assignments dropped by capacity at the {n_long}-token "
        f"prefill, by MoE layer: {[round(d, 4) for d in dropped]}")
    return {**bounds, "dropped_share": dropped,
            "decode_profile": profile_decode(torch, cfg, params, sched,
                                             long_prompt)}


def gemma3_serve_extra(torch, cfg, params, long_prompt, sched) -> dict:
    """18c's extra readings: one prompt of ``KV_QUANT_PROMPT`` tokens (past
    the 1,024-token window) through prefill and one decode step with the
    int8 cache and with the bf16 cache on the same params: the first
    decode step's logits within ``KV_QUANT_TOL`` of the bf16 run's
    largest; the engine's caches' bytes, int8 against bf16; and the
    decode profile (``profile_decode``)."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as TF

    dev = torch.device("cuda:0")
    prompt = torch.as_tensor(long_prompt[None, :KV_QUANT_PROMPT],
                             dtype=torch.long, device=dev)
    firsts = []
    with torch.no_grad():
        for quant in (True, False):
            c = cfg.replace(kv_quant=quant)
            cache = TF.init_cache(c, 1, KV_QUANT_PROMPT + 8, device=dev)
            logits, cache = TF.prefill(params, c, prompt, cache)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            del logits
            logits, _ = TF.decode_step(params, c, tok, cache)
            firsts.append(logits.float())
            del cache, logits
    rel = float((firsts[0] - firsts[1]).abs().max() / firsts[1].abs().max())

    def cache_bytes(quant):
        c = cfg.replace(kv_quant=quant)
        return sum(t.numel() * t.element_size() for kind in c.layer_kinds()
                   for t in A.init_attention_cache(
                       c, kind == "L", sched.n_slots, sched.max_seq_len,
                       torch.bfloat16, device="meta").values())

    q8, b16 = cache_bytes(True), cache_bytes(False)
    log(f"[serve] {cfg.name} int8 KV cache: the first decode step after a "
        f"{KV_QUANT_PROMPT}-token prompt within {rel:.3g} of the bf16 "
        f"cache's largest logit (tol {KV_QUANT_TOL}); the engine's caches "
        f"({sched.n_slots} slots of {sched.max_seq_len}) {q8 / 1e9:.3f} GB "
        f"int8 + float32 scales against {b16 / 1e9:.3f} GB bf16 "
        f"({q8 / b16:.3f}x)")
    if not rel < KV_QUANT_TOL:
        raise AssertionError(f"gemma3 int8 KV cache: {rel} off the bf16 "
                             f"cache's logits")
    return {"kv_quant_rel": rel, "cache_bytes_int8": q8,
            "cache_bytes_bf16": b16,
            "decode_profile": profile_decode(torch, cfg, params, sched,
                                             long_prompt)}


def moe_step_work(cfg, q) -> dict:
    """The least work of one local step of 18d from the active parameters
    (``launch/flops.count_params``: attention, router, the top-k experts):
    the GEMMs' forward and backward (6 FLOPs an active matmul parameter a
    token) and the layers' remat forward (2), and attention as 16c counts
    it (the flash forward twice, the backward's 10·D a pair)."""
    from repro_torch.launch.flops import count_params
    from repro_torch.models.transformer import padded_vocab

    _, active = count_params(cfg)
    layers = active - cfg.d_model * padded_vocab(cfg)
    tokens = q["clients"] * q["batch"] * q["seq"]
    att = cfg.attention
    pairs = q["seq"] * (q["seq"] + 1) // 2
    gemm = tokens * (6 * active + 2 * layers)
    attn = (q["clients"] * q["batch"] * cfg.n_layers * att.n_heads
            * att.head_dim * pairs * (4 + 4 + 10))
    return {"gemm_flops": gemm, "attn_flops": attn,
            "bound_ms": (gemm + attn) / BF16_FLOPS * 1e3}


def range_device_ms(torch, prof, names, n: int, outside=None) -> float:
    """Device ms a step of the kernels launched inside the host ranges
    named in ``names`` (``obs/trace.layer`` ranges, record_function
    ranges, or the autograd engine's ``evaluate_function`` ranges of
    backward nodes), leaving out those nested in a range named
    ``outside``."""
    cuda = torch.autograd.DeviceType.CUDA
    total = 0.0
    for e in prof.events():
        if e.device_type == cuda or e.name not in names:
            continue
        p = e.cpu_parent
        while p is not None and p.name != outside:
            p = p.cpu_parent
        if p is None:
            total += e.device_time_total
    return total / 1e3 / n


def run_phi35_training(torch, tmp: Path) -> dict:
    """Phase 18d: phi3.5-moe at full width (d_model 4,096, 32/8 heads of
    128, 16 experts x 6,400 top-2, vocab 32,064, bf16, seed 0), depth cut
    to 2 of 32 layers, through ``launch/train.main`` with ``--profile
    --profile-dir --profile-calls 2``: 2 clients, 2 sequences of 1,024
    tokens a client a step, stl_sc eta1 0.03, k1 4, T1 16, 2 stages cut at
    32 local steps (16 + 16), dense Star. The loss finite and its last stage's mean
    below its first's, the aux term at the end, the launches (flash 8 and
    the fused update 4 a step: the bf16 leaves and the float32 routers
    are two type groups), the ledger, ms a step against its bound
    (``moe_step_work``), peak memory, device ms a step by kind over the
    profiler's window (GEMMs, the MoE ranges, flash, the plain attention
    backward, the update); then one client's fused update at the trained
    state as 16c checks it."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as TT
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import transformer as TF
    from repro_torch.utils.tree import tree_leaves, tree_map

    q = PHI35_TRAIN
    arch = "phi3.5-moe-42b-a6.6b"
    full = get_arch(arch)
    cfg = full.replace(n_layers=q["layers"])
    log(f"[cut] phase 18d: {arch} at full width, depth cut to "
        f"{q['layers']} of {full.n_layers} layers; {q['stages']} stl_sc "
        f"stages cut at {q['steps']} local steps (the second at half)")
    prof_dir = tmp / "phi35_prof"
    argv = ["--arch", arch, "--layers", str(q["layers"]),
            "--clients", str(q["clients"]), "--batch", str(q["batch"]),
            "--seq", str(q["seq"]), "--algo", "stl_sc",
            "--eta1", str(q["eta1"]), "--T1", str(q["T1"]),
            "--k1", str(q["k1"]), "--stages", str(q["stages"]),
            "--steps", str(q["steps"]), "--profile", "--profile-dir",
            str(prof_dir), "--profile-calls", str(q["profile_calls"])]
    log(f"[moe-train] launch.train.main {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    ds = TT.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = ds.profile
    steps = [r for r in prof.records if r.name == "train_step"]
    untraced = [r.measured_s for r in steps[1:] if not r.attrs.get("traced")]
    ms_step = statistics.median(untraced) * 1e3
    work = moe_step_work(cfg, q)
    losses = [r.mean_loss for r in ds.results]
    n_params = sum(t[0].numel() for t in tree_leaves(ds.state["params"]))
    per_client = sum(t[0].numel() * t.element_size()
                     for t in tree_leaves(ds.state["params"]))
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(
        [ds.state["params"], ds.state["opt"]])) / 1e9
    # the aux term at the end: client 0 on one batch, without grad
    dev = torch.device("cuda:0")
    batch = next(synthetic_batches(cfg, q["clients"], q["batch"], q["seq"],
                                   seed=3, device=dev))
    with torch.no_grad():
        _, aux = TF.forward(TF.layer_views(tree_map(
            lambda t: t[0], ds.state["params"]), cfg), cfg,
            batch["tokens"][0])
    aux = float(aux)
    del batch
    log(f"[moe-train] {arch}, {cfg.n_layers} layers: {n_params} parameters "
        f"a client, state {state_gb:.2f} GB; {ds.iters_total} local steps, "
        f"{ds.rounds_total} rounds; {ms_step:.2f} ms a step (median of "
        f"{len(untraced)} untraced steps; the first "
        f"{steps[0].measured_s * 1e3:.1f} ms) against a "
        f"{work['bound_ms']:.2f} ms bound ({work['gemm_flops'] / 1e12:.2f} "
        f"TFLOP of active GEMMs, {work['attn_flops'] / 1e12:.3f} TFLOP of "
        f"attention at 989 TFLOP/s); eta1 {q['eta1']}; stage mean losses "
        f"{[round(v, 4) for v in losses]} (the load-balance aux of client "
        f"0's last state {aux:.5f}, in the loss); peak memory "
        f"{peak_gb:.2f} GB; comm bytes {ds.comm_bytes_total}; launches "
        f"{counts}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0] or not math.isfinite(aux):
        raise AssertionError(f"phi3.5 training: stage losses {losses}, aux "
                             f"{aux}")
    if ds.comm_bytes_total != ds.rounds_total * q["clients"] * per_client:
        raise AssertionError(f"phi3.5 training: ledger {ds.comm_bytes_total}")
    want = lm_launches(cfg, ds, q["clients"], 0)
    if want["flash_attention"] != 8 * ds.iters_total or \
            want["fused_sgd_update"] != 4 * ds.iters_total:
        raise AssertionError(f"phi3.5 training: the path's launches {want} "
                             f"are not flash 8 and the update 4 a step")
    expect_launches("phi3.5 training", counts, want)
    out = {"params_per_client": n_params, "state_gb": state_gb,
           "iters": ds.iters_total, "rounds": ds.rounds_total,
           "ms_per_step": ms_step,
           "first_step_ms": steps[0].measured_s * 1e3, **work,
           "eta1": q["eta1"], "stage_losses": losses, "aux": aux,
           "peak_gb": peak_gb, "comm_bytes": ds.comm_bytes_total,
           "launches": counts, "skew_table": prof.skew_table()}
    n_traced = sum(1 for r in prof.records if r.attrs.get("traced")
                   and r.name == "train_step")
    kinds = device_ms_by_kind(
        torch, prof.profiler, n_traced,
        {"gemm": GEMM_KERNELS, "flash_forward": ("flash_fwd",),
         "fused_update": ("fused_sgd_update",),
         "loss_log_softmax": ("LogSoftMax",)},
        {"attention_backward": "flash_attention.backward",
         "moe_route_fwd": "moe.route", "moe_dispatch_fwd": "moe.dispatch",
         "moe_experts_fwd": "moe.experts", "moe_combine_fwd": "moe.combine"})
    if kinds is None:
        log("[moe-train] device time by kind not measured (no CUDA events "
            "traced)")
    else:
        node = "autograd::engine::evaluate_function: "
        by = kinds["by_kind_ms_per_step"]
        # the MoE layer's backward: its bmm nodes (the plain attention
        # backward's products, nested in its range, left out), the
        # dispatch's index_put and the combine's gather
        by["moe_experts_bwd"] = range_device_ms(
            torch, prof.profiler, {node + "BmmBackward0"}, n_traced,
            outside="flash_attention.backward")
        by["moe_dispatch_combine_bwd"] = range_device_ms(
            torch, prof.profiler, {node + "IndexPutBackward0",
                                   node + "GatherBackward0"}, n_traced,
            outside="flash_attention.backward")
        traced_ms = statistics.median(r.measured_s for r in steps
                                      if r.attrs.get("traced")) * 1e3
        window_ms = sum(r.measured_s for r in prof.records
                        if r.attrs.get("traced")) * 1e3
        busy = 100 * busy_union_us(torch, prof.profiler) / 1e3 / window_ms
        out.update(profile={k: v for k, v in kinds.items() if k != "top"},
                   traced_step_ms=traced_ms, busy_union_pct=busy)
        log(f"[moe-train] profile of {n_traced} traced train steps "
            f"({traced_ms:.2f} ms a traced step): "
            f"{kinds['kernels_per_step']:.0f} kernels a step, a kernel "
            f"running {busy:.1f}% of the window, device "
            f"{kinds['kernel_ms_per_step']:.2f} ms a step; by kind: "
            + ", ".join(f"{k} {v:.3f}" for k, v in by.items())
            + " ms a step (the _fwd ranges hold the forward and its remat "
            "recompute; the expert products are among the GEMMs too)")
        for line in kinds["top"]:
            log(f"[moe-train]   {line}")
    torch.cuda.empty_cache()
    out["update_check"] = check_lm_update(torch, cfg, ds.state, q)
    del ds, prof
    torch.cuda.empty_cache()
    return out


def run_moe_mla_phase(torch, floor) -> dict:
    """Phase 18: 18a the card against the CPU at SMOKE width (serving:
    gemma3, minicpm3, phi3.5-moe, deepseek-v2, gemma2 with the int8 KV
    cache; training: phi3.5-moe and minicpm3 under dense and int8 Star),
    flash at gemma3's and phi3.5's layers, the padded MLA calls; 18b
    deepseek-v2 served at full width (4 of 60 layers); 18c gemma3-12b at
    full width (12 of 48 layers) with the int8 KV cache; 18d phi3.5-moe trained at
    full width (2 of 32 layers). The training kernels at the (2, n) blocks
    18a's int8 rounds hand them that 16b's did not."""
    import tempfile

    from repro_torch.configs import get_arch

    out = {"serve_check": {}, "train_check": {}}
    for arch, kv_quant in MOE_SERVE_REFS:
        label = f"{arch}{' kv_quant' if kv_quant else ''}"
        out["serve_check"][label] = serve_reference_check(torch, arch, 80,
                                                          kv_quant)
    for arch in MOE_TRAIN_REFS:
        out["train_check"][arch] = train_reference_check(
            torch, arch, runs=("dense star", "int8 star"),
            control=get_arch(arch).moe is not None)
    out["flash"] = check_flash(torch, MOE_FLASH_CASES)
    out["mla_flash"] = check_mla_flash(torch)
    torch.cuda.empty_cache()
    out["serve_deepseek"] = serve_full_width(torch, "deepseek-v2-236b",
                                             deepseek_serve_extra)
    torch.cuda.empty_cache()
    out["serve_gemma3"] = serve_full_width(torch, "gemma3-12b",
                                           gemma3_serve_extra)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        out["train"] = run_phi35_training(torch, Path(d))
    torch.cuda.empty_cache()
    # the blocks 18a's int8 rounds hand quantize and dequant_mean that 16b's
    # did not
    seen = set(lm_path_shapes().values())
    shapes = {}
    for arch, label in zip(MOE_TRAIN_REFS, ("phi35", "minicpm3")):
        for key, shape in lm_path_shapes(arch, label).items():
            if shape not in seen:
                shapes[key] = shape
                seen.add(shape)
    out["path_rows"] = check_kernels(torch, shapes, floor)
    out["path_shapes"] = shapes
    return out


# phase 19: RG-LRU and the frontend archs. 19a's SMOKE checks: the serving
# path on the card against the CPU (recurrentgemma's 80-token prompt past
# its 64-token window; the frontend archs' 16 embeddings before a 24-token
# prompt), a used slot's prefill against a fresh one's, then 16b's training
# check (dense and int8 Star) on the RG-LRU arch and on a frontend arch
RG_SERVE_REFS = (("recurrentgemma-2b", 80), ("internvl2-2b", 24),
                 ("musicgen-medium", 24))
RG_TRAIN_REFS = ("recurrentgemma-2b", "musicgen-medium")
# flash at the shapes phase 19's paths give it: recurrentgemma's local
# layer (MQA, a group of 10 at D = 256, window 2,048) at the 4,608-token
# prefill and at its training layer (2 x 1,024 tokens), internvl2's layer at
# 256 patches + a 512-token prompt, musicgen's training layer (2 x (256
# frames + 1,024 tokens), 24/24 heads of 64)
RG_FLASH_CASES = {
    "recurrentgemma local": (1, 4608, 10, 1, 256, "bf16", 2048, None),
    "recurrentgemma train": (2, 1024, 10, 1, 256, "bf16", 2048, None),
    "internvl2 prefill": (1, 768, 16, 8, 128, "bf16", None, None),
    "musicgen train": (2, 1280, 24, 24, 64, "bf16", None, None),
}
# 19c: recurrentgemma-2b at full width through launch/train.main, its
# depth cut to 13 of 26 layers since phase 22 joined the script (the run's
# time), 17c's schedule (eta1 0.05, T1 8, k1 4, 2 stages cut at 16 local
# steps); the profiler traces one train step after a warm-up one
RG_TRAIN = {"layers": 13, "clients": 2, "batch": 2, "seq": 1024, "T1": 8,
            "k1": 4.0, "stages": 2, "steps": 16, "eta1": 0.05,
            "profile_calls": 1}
# 19e: musicgen-medium at full width with frontend batches (256 frames
# before 1,024 tokens), its depth cut to 24 of 48 layers since phase 22
# joined the script: 16c's rate and k1 (eta1 0.03, k1 4), T1 8 so that the
# 16 local steps span two stages, as 17c's do; no profiler window
# (``--profile`` alone: each step's time, synchronised)
MUSICGEN_TRAIN = {"layers": 24, "clients": 2, "batch": 2, "seq": 1024,
                  "T1": 8, "k1": 4.0, "stages": 2, "steps": 16, "eta1": 0.03,
                  "profile_calls": None}
# 19d: the logits of a prefill with the frontend and without it must differ
# by more than this share of the largest logit
FRONTEND_MOVES = 5e-2


def used_slot_check(torch, arch: str, n_prompt: int) -> dict:
    """Phase 19a: on the card, ``arch``'s SMOKE config (float32): row 1 of
    a two-row cache serves a prompt (a prefill, then 3 decode steps of both
    rows) and then takes a second prompt. Its prefill's logits, and the
    row's recurrent states and conv carries, equal those of a fresh
    one-row cache's prefill of the second prompt, bit for bit."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as TF

    dev = torch.device("cuda:0")
    cfg = get_arch(arch, smoke=True).replace(dtype="float32")
    params = TF.init_params(cfg, seed=0, device=dev)
    fe, n_fe = seeded_frontend(torch, cfg)
    fe = None if fe is None else fe.to(dev)
    rng = np.random.RandomState(3)
    first, second = (torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(1, n))).long().to(dev)
        for n in (n_prompt, n_prompt - 7))
    n_max = n_fe + n_prompt + 16
    with torch.no_grad():
        stacked = TF.init_cache(cfg, 2, n_max, device=dev)
        TF.prefill(params, cfg, first, TF.cache_rows(stacked, 1, 2), fe)
        toks = torch.full((2, 1), 5, dtype=torch.long, device=dev)
        for _ in range(3):
            TF.decode_step(params, cfg, toks, stacked)
        got, _ = TF.prefill(params, cfg, second,
                            TF.cache_rows(stacked, 1, 2), fe)
        fresh = TF.init_cache(cfg, 1, n_max, device=dev)
        want, _ = TF.prefill(params, cfg, second, fresh, fe)
    torch.cuda.synchronize()
    states = [(c, f) for kind, c, f in zip(cfg.layer_kinds(),
                                           stacked["layers"], fresh["layers"])
              if kind in "MR"]
    equal = torch.equal(got, want) and all(
        torch.equal(c[k][1:2], f[k]) for c, f in states for k in c)
    log(f"[reference] {arch} smoke f32 on the card: a used row's prefill "
        f"({second.shape[1]} tokens after {first.shape[1]} and 3 decode "
        f"steps) against a fresh cache's: logits"
        f"{' and recurrent states' if states else ''} "
        f"{'bit-equal' if equal else 'DIFFER'} (max |logit diff| "
        f"{float((got - want).abs().max()):.3g})")
    if not equal:
        raise AssertionError(f"{arch}: a used row's prefill differs from a "
                             f"fresh one's")
    return {"bit_equal": True, "recurrent_layers": len(states)}


def serve_bounds(cfg, n_long: int, sched) -> dict:
    """The prefill and decode-step bounds the serving engine prices
    (``launch/flops.py`` through ``DeviceModel``), in ms."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve import DeviceModel

    dm = DeviceModel()
    n_fe = cfg.n_frontend_tokens if cfg.frontend else 0
    out = {f"prefill_{n}_bound_ms": dm.step_time_s(
        cfg, ShapeConfig("p", n + n_fe, 1, "prefill")) * 1e3
        for n in (512, n_long)}
    out["decode_step_bound_ms"] = dm.step_time_s(
        cfg, ShapeConfig("d", sched.max_seq_len, sched.n_slots,
                         "decode")) * 1e3
    return out


def rg_serve_extra(torch, cfg, params, long_prompt, sched) -> dict:
    """19b's extra readings: the prefill and decode-step bounds, a slot's
    recurrent state (the R layers' conv carries and float32 states) in
    bytes against its attention cache (the local layers' window-long
    rings), and the decode profile (``profile_decode``)."""
    from repro_torch.models import attention as A
    from repro_torch.models import rglru as RG

    bounds = serve_bounds(cfg, len(long_prompt), sched)
    nbytes = lambda d: sum(t.numel() * t.element_size() for t in d.values())
    kinds = cfg.layer_kinds()
    state = kinds.count("R") * nbytes(RG.init_rglru_cache(
        cfg, 1, torch.bfloat16, device="meta"))
    attn = sum(nbytes(A.init_attention_cache(
        cfg, k == "L", 1, sched.max_seq_len, torch.bfloat16, device="meta"))
        for k in kinds if k in "GL")
    log(f"[serve] {cfg.name}: bounds (launch/flops via DeviceModel) "
        + ", ".join(f"{k} {v:.3f}" for k, v in bounds.items())
        + f"; a slot holds {state / 1e6:.3f} MB of recurrent state "
        f"({kinds.count('R')} RG-LRU layers) and {attn / 1e6:.3f} MB of "
        f"attention cache ({sum(k in 'GL' for k in kinds)} local layers, "
        f"rings of {cfg.attention.window})")
    return {**bounds, "recurrent_state_bytes_per_slot": state,
            "attention_cache_bytes_per_slot": attn,
            "decode_profile": profile_decode(torch, cfg, params, sched,
                                             long_prompt)}


def vlm_serve_extra(torch, cfg, params, long_prompt, sched) -> dict:
    """19d's extra readings: the bounds; the last position's logits of a
    64-token prefill with the 256 patch embeddings against one without
    them (they must differ by more than ``FRONTEND_MOVES`` of the largest
    logit: the frontend is not dropped); the engine's modeled prefill
    seconds of a frontend request equal the price of prompt + 256 tokens,
    above the text-only request's."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import transformer as TF
    from repro_torch.serve import DeviceModel, Request, ServeEngine

    dev = torch.device("cuda:0")
    fe, n_fe = seeded_frontend(torch, cfg)
    prompt = np.asarray(long_prompt[:64])
    lasts = []
    with torch.no_grad():
        for f in (fe.to(dev, torch.bfloat16), None):
            cache = TF.init_cache(cfg, 1, n_fe + 72, device=dev)
            logits, _ = TF.prefill(params, cfg, torch.as_tensor(
                prompt[None], dtype=torch.long, device=dev), cache, f)
            lasts.append(logits[0, -1, :cfg.vocab_size].float())
            del cache, logits
    moved = float((lasts[0] - lasts[1]).abs().max()
                  / lasts[1].abs().max())
    eng = ServeEngine(cfg, params, scheduler=sched)
    with_fe = Request(id=0, arrival_s=0.0, prompt=prompt, n_out=1,
                      frontend=fe[0].numpy())
    text = Request(id=1, arrival_s=0.0, prompt=prompt, n_out=1)
    want = DeviceModel().step_time_s(cfg, ShapeConfig(
        "serve_prefill", len(prompt) + n_fe, 1, "prefill"))
    priced = eng.prefill_s(with_fe)
    bounds = serve_bounds(cfg, len(long_prompt), sched)
    log(f"[serve] {cfg.name}: the first step's logits with the {n_fe} patch "
        f"embeddings against without them: max |diff| {moved:.3g} of the "
        f"largest logit (must exceed {FRONTEND_MOVES}); modeled prefill of "
        f"a {len(prompt)}-token request {priced * 1e3:.4f} ms with the "
        f"frontend ({len(prompt) + n_fe} tokens priced), "
        f"{eng.prefill_s(text) * 1e3:.4f} ms without; bounds "
        + ", ".join(f"{k} {v:.3f}" for k, v in bounds.items()))
    if not moved > FRONTEND_MOVES:
        raise AssertionError(f"{cfg.name}: the frontend moves the logits by "
                             f"{moved} only")
    if priced != want or not priced > eng.prefill_s(text):
        raise AssertionError(f"{cfg.name}: the engine prices a frontend "
                             f"prefill at {priced}, not {want}")
    return {**bounds, "frontend_moves_logits": moved,
            "prefill_s_with_frontend": priced,
            "prefill_s_text_only": eng.prefill_s(text)}


def lm_step_work(cfg, q) -> dict:
    """The least work of one local step of 19c / 19e: the GEMMs' forward
    and backward (6 FLOPs a matmul parameter a token: every layer's 2-D
    weights but the RG-LRU conv, the unembedding, the frontend projector
    over the frontend positions only) and the layers' remat forward (2),
    and attention as 16c counts it (the flash forward twice, the
    backward's 10·D a pair) over the window each layer sees; tokens
    include the frontend positions."""
    from repro_torch.launch.flops import _attn_pairs
    from repro_torch.models import transformer as TF
    from repro_torch.utils.tree import tree_flatten_with_path

    shapes = TF.init_params_shape(cfg)
    layers = sum(t.numel() for path, t in tree_flatten_with_path(
        shapes["layers"])[0] if t.dim() == 2 and "conv" not in path)
    head = shapes["embed" if cfg.tie_embeddings else "unembed"].numel()
    n_fe = cfg.n_frontend_tokens if cfg.frontend else 0
    proj = shapes["proj_frontend"].numel() if cfg.frontend else 0
    seqs = q["clients"] * q["batch"]
    S = n_fe + q["seq"]
    tokens = seqs * S
    gemm = tokens * (6 * (layers + head) + 2 * layers) \
        + seqs * n_fe * 6 * proj
    att = cfg.attention
    attn = sum(seqs * att.n_heads * att.head_dim * (4 + 4 + 10)
               * _attn_pairs(S, att.window if k == "L" else None, "prefill")
               for k in cfg.layer_kinds() if k in "GL")
    return {"gemm_flops": gemm, "attn_flops": attn,
            "bound_ms": (gemm + attn) / BF16_FLOPS * 1e3}


def rglru_scan_ms(torch, cfg, q) -> dict:
    """The RG-LRU scan at 19c's training layer (``batch`` x ``seq`` x
    lru, float32, r and i in (0, 1) as the sigmoids give them, a_param as
    the init): device ms of the forward (the doubling passes, under grad
    as training runs it) and of the forward and backward, against the
    forward's bound (xb, r and i read, h written, float32); and the scan's
    device ms a local step: each R layer of each client runs the forward
    twice (the forward and its remat recompute) and the backward once."""
    from repro_torch.models import rglru as RG

    dev = torch.device("cuda:0")
    B, S, W = q["batch"], q["seq"], cfg.rglru.lru_width or cfg.d_model
    g = torch.Generator(device=dev).manual_seed(5)
    xb, r, i = (torch.randn((B, S, W), generator=g, device=dev)
                for _ in range(3))
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    a_param = torch.full((W,), 4.0, device=dev)
    ins = [xb, r, i, a_param]
    for t in ins:
        t.requires_grad_()
    dh = torch.randn((B, S, W), generator=g, device=dev)

    def fwd():
        return RG._rg_lru_scan(xb, r, i, a_param)[0]

    def fwd_bwd():
        return torch.autograd.grad(fwd(), ins, dh)

    f_ms = device_ms(torch, fwd, batch=2, reps=5)
    fb_ms = device_ms(torch, fwd_bwd, batch=2, reps=5)
    n_r = cfg.layer_kinds().count("R")
    step = q["clients"] * n_r * (2 * f_ms + (fb_ms - f_ms))
    bms, by = bound_ms(4 * 4 * B * S * W, 0)
    log(f"[rg-train] the RG-LRU scan at ({B}, {S}, {W}) float32: forward "
        f"{f_ms:.3f} ms (bound {bms:.4f} ms, {by}), forward + backward "
        f"{fb_ms:.3f} ms; {step:.2f} ms a local step ({n_r} R layers x "
        f"{q['clients']} clients x (2 forwards + a backward))")
    return {"shape": [B, S, W], "fwd_ms": f_ms, "fwd_bwd_ms": fb_ms,
            "fwd_bound_ms": bms, "ms_per_step": step}


def run_train_main(torch, tmp: Path, arch: str, q: dict, tag: str,
                   ckpt: bool = False, update_check: bool = False) -> dict:
    """Phases 19c and 19e: ``arch`` at full width, its depth cut to
    ``q["layers"]`` (bf16, seed 0),
    through ``launch/train.main`` with ``--profile --profile-dir
    --profile-calls`` (and ``--ckpt-out``): 2 clients, 2 sequences of 1,024
    tokens a client a step (after a frontend arch's embeddings), dense
    Star. The loss finite and its last stage's mean below its first's, the
    launches (flash twice an attention layer a client a step, the update
    once a type group a client a step), the ledger, ms a step (the median
    of the untraced train steps after the first) against its bound
    (``lm_step_work``), peak memory, and where ``q["profile_calls"]``
    opens a profiler window, device ms a step by kind over it (GEMMs, the
    flash forward, the plain attention backward, the update, the loss's
    log-softmax); with ``update_check``,
    one client's update at the trained state as 16c checks it."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as TT
    from repro_torch.utils.tree import tree_leaves, tree_map

    full = get_arch(arch)
    cfg = full.replace(n_layers=q.get("layers", full.n_layers))
    argv = ["--arch", arch, "--layers", str(cfg.n_layers),
            "--clients", str(q["clients"]),
            "--batch", str(q["batch"]), "--seq", str(q["seq"]),
            "--algo", "stl_sc", "--eta1", str(q["eta1"]),
            "--T1", str(q["T1"]), "--k1", str(q["k1"]),
            "--stages", str(q["stages"]), "--steps", str(q["steps"]),
            "--profile"]
    if q["profile_calls"]:
        argv += ["--profile-dir", str(tmp / "prof"),
                 "--profile-calls", str(q["profile_calls"])]
    if ckpt:
        argv += ["--ckpt-out", str(tmp / "ck")]
    if cfg.n_layers != full.n_layers:
        log(f"[cut] {tag}: {arch} at full width, depth cut to "
            f"{cfg.n_layers} of {full.n_layers} layers")
    log(f"[{tag}] launch.train.main {' '.join(argv)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    ds = TT.main(argv)
    torch.cuda.synchronize()
    t_end = time.monotonic()
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = ds.profile
    steps = [r for r in prof.records if r.name == "train_step"]
    untraced = [r.measured_s for r in steps[1:] if not r.attrs.get("traced")]
    ms_step = statistics.median(untraced) * 1e3
    work = lm_step_work(cfg, q)
    losses = [r.mean_loss for r in ds.results]
    n_params = sum(t[0].numel() for t in tree_leaves(ds.state["params"]))
    per_client = sum(t[0].numel() * t.element_size()
                     for t in tree_leaves(ds.state["params"]))
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(
        [ds.state["params"], ds.state["opt"]])) / 1e9
    n_fe = cfg.n_frontend_tokens if cfg.frontend else 0
    log(f"[{tag}] {arch}, {cfg.n_layers} layers: {n_params} parameters a "
        f"client, state {state_gb:.2f} GB; {ds.iters_total} local steps, "
        f"{ds.rounds_total} rounds; main() {t_end - t0:.2f} s; "
        f"{ms_step:.2f} ms a step (median of {len(untraced)} untraced "
        f"steps; the first {steps[0].measured_s * 1e3:.1f} ms) against a "
        f"{work['bound_ms']:.2f} ms bound ({work['gemm_flops'] / 1e12:.2f} "
        f"TFLOP of GEMMs, {work['attn_flops'] / 1e12:.3f} TFLOP of "
        f"attention at 989 TFLOP/s; {n_fe} frontend + {q['seq']} tokens a "
        f"sequence); eta1 {q['eta1']}; stage mean losses "
        f"{[round(v, 4) for v in losses]}; peak memory {peak_gb:.2f} GB; "
        f"comm bytes {ds.comm_bytes_total}; launches {counts}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training: stage losses {losses}")
    if ds.comm_bytes_total != ds.rounds_total * q["clients"] * per_client:
        raise AssertionError(f"{arch} training: ledger "
                             f"{ds.comm_bytes_total}")
    want = lm_launches(cfg, ds, q["clients"], 0)
    per_step = {k: want[k] // ds.iters_total
                for k in ("flash_attention", "fused_sgd_update")}
    if per_step != q["launches_per_step"]:
        raise AssertionError(f"{arch} training: the path's launches "
                             f"{per_step} a step, not "
                             f"{q['launches_per_step']}")
    expect_launches(f"{arch} training", counts, want)
    out = {"params_per_client": n_params, "state_gb": state_gb,
           "iters": ds.iters_total, "rounds": ds.rounds_total,
           "ms_per_step": ms_step,
           "first_step_ms": steps[0].measured_s * 1e3, **work,
           "eta1": q["eta1"], "stage_losses": losses, "peak_gb": peak_gb,
           "comm_bytes": ds.comm_bytes_total, "launches": counts,
           "launches_per_step": per_step, "skew_table": prof.skew_table()}
    n_traced = sum(1 for r in prof.records if r.attrs.get("traced")
                   and r.name == "train_step")
    kinds = None if not n_traced else device_ms_by_kind(
        torch, prof.profiler, n_traced,
        {"gemm": GEMM_KERNELS, "flash_forward": ("flash_fwd",),
         "fused_update": ("fused_sgd_update",),
         "loss_log_softmax": ("LogSoftMax",)},
        {"attention_backward": "flash_attention.backward"})
    if kinds is None:
        why = "no CUDA events traced" if n_traced else "no profiler window"
        log(f"[{tag}] device time by kind not measured ({why})")
    else:
        by = kinds["by_kind_ms_per_step"]
        traced_ms = statistics.median(r.measured_s for r in steps
                                      if r.attrs.get("traced")) * 1e3
        window_ms = sum(r.measured_s for r in prof.records
                        if r.attrs.get("traced")) * 1e3
        busy = 100 * busy_union_us(torch, prof.profiler) / 1e3 / window_ms
        out.update(profile={k: v for k, v in kinds.items() if k != "top"},
                   traced_step_ms=traced_ms, busy_union_pct=busy)
        log(f"[{tag}] profile of {n_traced} traced train steps "
            f"({traced_ms:.2f} ms a traced step): "
            f"{kinds['kernels_per_step']:.0f} kernels a step, a kernel "
            f"running {busy:.1f}% of the window, device "
            f"{kinds['kernel_ms_per_step']:.2f} ms a step; by kind: "
            + ", ".join(f"{k} {v:.3f}" for k, v in by.items())
            + " ms a step (the attention backward's products are among "
            "the GEMMs too)")
        for line in kinds["top"]:
            log(f"[{tag}]   {line}")
    if ckpt:
        # per-leaf float64 sums of the consensus the checkpoint holds (before
        # the update check, which steps client 0's rows in place)
        consensus = tree_map(lambda p: torch.mean(p, dim=0),
                             ds.state["params"])
        out["consensus_sums"] = [float(t.double().sum())
                                 for t in tree_leaves(consensus)]
        del consensus
    torch.cuda.empty_cache()
    if update_check:
        out["update_check"] = check_lm_update(torch, cfg, ds.state, q)
    del ds, prof
    torch.cuda.empty_cache()
    return out


def run_rglru_frontend_phase(torch, floor) -> dict:
    """Phase 19: 19a the card against the CPU at SMOKE width (serving
    recurrentgemma-2b, internvl2-2b and musicgen-medium, a used slot's
    prefill; training recurrentgemma and musicgen under dense and int8
    Star), flash at the phase's new shapes; 19b recurrentgemma-2b served at
    full width (13 of 26 layers); 19c recurrentgemma-2b trained at full
    width (13 of 26 layers), then its checkpoint served; 19d internvl2-2b
    served with frontend requests (12 of 24 layers); 19e musicgen-medium
    trained with frontend batches (24 of 48 layers).
    The training kernels at the (2, n) blocks 19a's int8 rounds hand them
    that earlier phases did not."""
    import tempfile

    from repro_torch.configs import get_arch

    out = {"serve_check": {}, "used_slot": {}, "train_check": {}}
    t0 = time.monotonic()

    def lap(part):
        nonlocal t0
        log(f"[time] phase {part}: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()

    for arch, n_prompt in RG_SERVE_REFS:
        out["serve_check"][arch] = serve_reference_check(torch, arch,
                                                         n_prompt)
        out["used_slot"][arch] = used_slot_check(torch, arch, n_prompt)
    for arch in RG_TRAIN_REFS:
        out["train_check"][arch] = train_reference_check(
            torch, arch, runs=("dense star", "int8 star"),
            control=arch == "recurrentgemma-2b")
    out["flash"] = check_flash(torch, RG_FLASH_CASES)
    torch.cuda.empty_cache()
    lap("19a")
    out["serve_rg"] = serve_full_width(torch, "recurrentgemma-2b",
                                       rg_serve_extra)
    torch.cuda.empty_cache()
    lap("19b")
    cfg = get_arch("recurrentgemma-2b").replace(n_layers=RG_TRAIN["layers"])
    q = dict(RG_TRAIN, launches_per_step={
        "flash_attention": 2 * RG_TRAIN["clients"]
        * kernel_layers(cfg, "flash_attention"),
        "fused_sgd_update": 2 * RG_TRAIN["clients"]})
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        train = run_train_main(torch, tmp, "recurrentgemma-2b", q, "rg-train",
                               ckpt=True, update_check=True)
        sums = train.pop("consensus_sums")
        train["scan"] = rglru_scan_ms(torch, cfg, q)
        train["scan_share"] = train["scan"]["ms_per_step"] \
            / train["ms_per_step"]
        out["train_rg"] = train
        out["serve_ckpt"] = serve_checkpoint(torch, tmp / "ck", tmp, sums,
                                             "flash_attention")
    torch.cuda.empty_cache()
    lap("19c")
    out["serve_vlm"] = serve_full_width(torch, "internvl2-2b",
                                        vlm_serve_extra)
    torch.cuda.empty_cache()
    lap("19d")
    cfg = get_arch("musicgen-medium").replace(
        n_layers=MUSICGEN_TRAIN["layers"])
    q = dict(MUSICGEN_TRAIN, launches_per_step={
        "flash_attention": 2 * MUSICGEN_TRAIN["clients"] * cfg.n_layers,
        "fused_sgd_update": MUSICGEN_TRAIN["clients"]})
    with tempfile.TemporaryDirectory() as d:
        out["train_audio"] = run_train_main(torch, Path(d),
                                            "musicgen-medium", q,
                                            "audio-train")
    torch.cuda.empty_cache()
    lap("19e")
    # the blocks 19a's int8 rounds hand quantize and dequant_mean that the
    # earlier phases' did not
    seen = set(lm_path_shapes().values())
    for arch, label in zip(("mamba2-2.7b", "phi3.5-moe-42b-a6.6b",
                            "minicpm3-4b"), ("mamba2", "phi35", "minicpm3")):
        seen.update(lm_path_shapes(arch, label).values())
    shapes = {}
    for arch, label in zip(RG_TRAIN_REFS, ("rglru", "musicgen")):
        for key, shape in lm_path_shapes(arch, label).items():
            if shape not in seen:
                shapes[key] = shape
                seen.add(shape)
    out["path_rows"] = check_kernels(torch, shapes, floor)
    out["path_shapes"] = shapes
    return out


# phase 21: the mesh. 21a: qwen3-14b at full width, its depth cut to 2 of
# 40 layers as in 16c (2 clients, 2 sequences of 1,024 tokens a client a
# step), on make_host_mesh(1, 1) over NCCL: 4 local steps and a dense
# round, bit-equal to the same run through build_train_steps(cfg, dev)
# from the same state (kept in host memory between the runs: two states on
# the card would be 53 GB); an int8 round at SMOKE width (float32, 16b's
# batches) under the same bit-equality, its keys the same TorchKey. 21b:
# launch.dryrun for qwen3-14b x train_4k on the fake (16, 16) mesh (local
# and sync step, microbatch 1 for the script's time); nothing allocated;
# traced on fake CUDA tensors and on fake CPU ones, the records equal.
MESH_RUN = {"layers": 2, "clients": 2, "batch": 2, "seq": 1024, "steps": 4,
            "eta": 0.03, "smoke_steps": 4, "dryrun_microbatch": 1}
# 21a's top-k additions: the round at SMOKE width on the 1x1 mesh, bit-equal
# to the device route; the selection (comm/reducer.py::top_mask) timed
# alone on qwen3-14b's embedding leaf at full width, two clients' float32
# deltas, beside torch.topk, and held to a stable sort on a block with
# planted ties; launch.train.main with --reducer topk, blocking and
# streaming, against the same runs through build_train_steps(cfg, dev)
TOPK_RUN = {"frac": 0.1, "reps": 5, "tie_cols": 2 ** 20,
            "main": {"clients": 2, "seq": 32, "batch": 1, "T1": 4, "k1": 2,
                     "stages": 1, "steps": 4}}


def mesh_pair(torch, cfg, dev, host_state, batches, eta, mesh, **kw):
    """The same local steps and one round through the device route, then
    through the 1x1 mesh route, each from ``host_state`` copied to the
    card (``host_state`` is emptied once the second run has its copy: at
    full width the host holds at most the start and one final state).
    Returns per route its step times, round time and loss, the mesh run's
    launches (counters reset just before it) and the leaf paths where the
    two final states differ bit for bit."""
    from repro_torch import kernels
    from repro_torch.core import local_sgd as LS
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map

    def leaves(state):
        return tree_flatten_with_path({k: v for k, v in state.items()
                                       if k != "step"})[0]

    out, first = {}, None
    for route in ("device", "mesh"):
        state = tree_map(lambda t: t.to(dev, copy=True)
                         if torch.is_tensor(t) else t, host_state)
        where = dev
        if route == "mesh":
            host_state.clear()
            state = LS.place_state(state, mesh)
            where = mesh
        step, sync, _ = LS.build_train_steps(cfg, where, **kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        times = []
        for b in batches:
            t0 = time.monotonic()
            state, m = step(state, b, eta)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        t0 = time.monotonic()
        state = sync(state)
        torch.cuda.synchronize()
        out[route] = {"step_ms": times,
                      "sync_ms": (time.monotonic() - t0) * 1e3,
                      "loss": float(m["loss"]),
                      "launches": kernels.launch_counts()}
        final = leaves(LS.gather_state(state))
        if first is None:
            first = [(p, t.to("cpu", copy=True)) for p, t in final]
        else:
            out["diff"] = (["structure"] if [p for p, _ in first]
                           != [p for p, _ in final] else
                           [p for (p, a), (_, b) in zip(first, final)
                            if not torch.equal(a.to(b.device), b)])
        del state, final
        torch.cuda.empty_cache()
    return out


def topk_memory_reckoning(cfg, clients: int) -> dict:
    """Why 21a's top-k round runs at SMOKE width: the bytes a full-width
    round would hold (the state's shapes as meta tensors, nothing
    allocated)."""
    from repro_torch.core import local_sgd as LS
    from repro_torch.utils.tree import tree_leaves

    st = LS.init_state_shape(cfg, clients)
    state = sum(t.numel() * t.element_size()
                for t in tree_leaves([st["params"], st["opt"]]))
    per_client = sum(t[0].numel() for t in tree_leaves(st["params"]))
    embed = st["params"]["embed"].numel() * 4
    out = {"state_gb": state / 1e9, "ref_gb": per_client * 4 / 1e9,
           "res_gb": clients * per_client * 4 / 1e9,
           "embed_delta_gb": embed / 1e9}
    out["total_gb"] = (out["state_gb"] + out["ref_gb"] + out["res_gb"]
                       + 3 * out["embed_delta_gb"])
    return out


def run_topk_selection(torch, dev, smi: str) -> dict:
    """21a: ``top_mask`` on qwen3-14b's embedding leaf at full width, a
    (2, vocab x width) float32 block of normal draws (its k-th largest is
    tied: float32 normals of that count repeat), beside ``torch.topk`` on
    the same block (sorted, its default, and unsorted, the call inside
    ``top_mask``); every time the median of TOPK_RUN["reps"] calls,
    CUDA events around each (``call_ms``: host-side work shows as idle
    time). Then the kept set against a stable sort on a (2, 2^20)
    block with planted ties."""
    from repro_torch.comm.reducer import TopKMean, top_mask
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import padded_vocab

    q = TOPK_RUN
    cfg = get_arch("qwen3-14b")
    rows = padded_vocab(cfg)   # the embedding leaf's rows
    cols = rows * cfg.d_model
    k = TopKMean(frac=q["frac"])._k(cols)
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn((2, cols), generator=g, device=dev)
    keep = top_mask(torch.abs(y), k)
    kept = keep.sum(dim=1)
    a = torch.abs(y)
    lo = torch.where(keep, a, float("inf")).amin(dim=1)
    hi = torch.where(keep, -1.0, a).amax(dim=1)
    t = torch.topk(a, k, dim=1, sorted=False).values.amin(dim=1)
    ties = (a == t[:, None]).sum(dim=1)
    # of the elements tied at the k-th largest, the lower indices win: the
    # kept ones are a prefix of each row's tied positions
    prefix = []
    for r in range(2):
        tied_kept = keep[r, (a[r] == t[r]).nonzero()[:, 0]]
        prefix.append(bool(tied_kept[:int(tied_kept.sum())].all()))
    del keep, a
    if not (kept == k).all() or not (lo >= hi).all() or not all(prefix):
        raise AssertionError(f"21a top-k selection: kept {kept.tolist()} "
                             f"of k {k}, smallest kept {lo.tolist()}, "
                             f"largest dropped {hi.tolist()}, the kept ties "
                             f"a prefix of the row's {prefix}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = {"top_mask": call_ms(torch, lambda: top_mask(torch.abs(y), k),
                              q["reps"])}
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms["torch.topk sorted"] = call_ms(
        torch, lambda: torch.topk(torch.abs(y), k, dim=1), q["reps"])
    ms["torch.topk unsorted"] = call_ms(
        torch, lambda: torch.topk(torch.abs(y), k, dim=1, sorted=False),
        q["reps"])
    log(f"[mesh] 21a top-k selection, qwen3-14b's embedding leaf at full "
        f"width: a (2, {cols}) float32 block ({rows} x "
        f"{cfg.d_model}), k {k} a row, {ties.tolist()} elements a row equal "
        f"to the k-th largest; median ms of {q['reps']} calls: "
        + ", ".join(f"{n} {v:.2f}" for n, v in ms.items())
        + f"; top_mask's peak {peak:.2f} GB with the block; {smi}")
    del y
    torch.cuda.empty_cache()

    # planted ties: nine values, most magnitudes tied at the cut
    g = torch.Generator(device=dev).manual_seed(1)
    y = (torch.randint(-4, 5, (2, q["tie_cols"]), generator=g, device=dev)
         / 4).to(torch.float32)
    kt = TopKMean(frac=q["frac"])._k(q["tie_cols"])
    keep = top_mask(torch.abs(y), kt)
    order = torch.sort(torch.abs(y), dim=1, descending=True,
                       stable=True).indices[:, :kt]
    want = torch.zeros_like(keep).scatter_(1, order, True)
    same = bool(torch.equal(keep, want))
    log(f"[mesh] 21a top-k on a (2, {q['tie_cols']}) block with planted "
        f"ties (k {kt}): the kept indices {'equal' if same else 'DIFFER from'}"
        f" a stable sort's first k")
    if not same:
        raise AssertionError("21a top-k: the kept indices differ from a "
                             "stable sort's")
    return {"shape": [2, cols], "k": k, "ties_at_kth": ties.tolist(),
            "median_ms": ms, "top_mask_peak_gb": peak,
            "tie_block": [2, q["tie_cols"]], "tie_k": kt,
            "stable_sort_equal": same, "card": smi}


def run_topk_launcher(torch, dev) -> dict:
    """21a: ``launch.train.main`` with ``--reducer topk`` and with
    ``--topology streaming --reducer topk`` on the card (its 1x1 mesh),
    each against the same run through ``build_train_steps(cfg, dev)``:
    the same stages, rounds, ledger and losses, and the same final state
    bit for bit."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import local_sgd as LS
    from repro_torch.core.stl_sgd import StagewiseDriver
    from repro_torch.launch import train as TT
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.utils.tree import tree_flatten_with_path

    q = TOPK_RUN["main"]
    argv = ["--arch", "qwen3-14b", "--smoke", "--reducer", "topk"]
    for name, v in q.items():
        argv += [f"--{name}", str(v)]
    cfg = get_arch("qwen3-14b", smoke=True)
    out, launches = {}, {}
    for topo in ("star", "streaming"):
        kernels.reset_launch_counts()
        got = TT.main(argv + ["--topology", topo])
        for kname, v in kernels.launch_counts().items():
            launches[kname] = launches.get(kname, 0) + v
        tcfg = TrainConfig(algo="stl_sc", eta1=0.05, k1=q["k1"], T1=q["T1"],
                           n_stages=q["stages"], seed=0, reducer="topk",
                           topology=topo)
        state = LS.init_state(0, cfg, q["clients"], device=dev)
        train, sync, _ = LS.build_train_steps(cfg, dev, reducer="topk",
                                              streaming=topo == "streaming")
        batches = synthetic_batches(cfg, q["clients"], q["batch"], q["seq"],
                                    0, device=dev)
        want = StagewiseDriver(tcfg, train, sync).run(
            state, batches, max_iters=q["steps"])
        rows = [[(r.stage, r.k, r.iters, r.rounds) for r in ds.results]
                for ds in (got, want)]
        ledger = [ds.comm_bytes_total for ds in (got, want)]
        losses = [[r.mean_loss for r in ds.results] for ds in (got, want)]
        # the 1x1 mesh is bit-equal to the device route: params, moments,
        # and the reducer's ref and residuals
        final = [tree_flatten_with_path(LS.gather_state(ds.state))[0]
                 for ds in (got, want)]
        diff = (["structure"] if [p for p, _ in final[0]]
                != [p for p, _ in final[1]] else
                [p for (p, a), (_, b) in zip(*final)
                 if torch.is_tensor(a) and not torch.equal(a, b)])
        log(f"[mesh] 21a launch.train.main --reducer topk --topology {topo}"
            f": stages {rows[0]}, ledger {ledger[0]} B, losses {losses[0]};"
            f" through build_train_steps(cfg, dev): stages {rows[1]}, "
            f"ledger {ledger[1]} B, losses {losses[1]}; final states "
            + ("bit-equal" if not diff else f"DIFFER at {diff}"))
        if (rows[0] != rows[1] or ledger[0] != ledger[1]
                or losses[0] != losses[1] or diff
                or not all(math.isfinite(v) for v in losses[0])):
            raise AssertionError(f"21a launcher {topo}: {rows} {ledger} "
                                 f"{losses} {diff}")
        out[topo] = {"stages": rows[0], "ledger": ledger[0],
                     "losses": losses[0], "final_state_bit_equal": True}
        del got, want, state
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def run_mesh_phase(torch, dev="cuda:0") -> dict:
    """Phase 21: 21a the 1x1 mesh route against the device route at full
    width (dense) and at SMOKE width (int8, top-k), the top-k selection
    at full width and the launcher's top-k runs; 21b the dry run."""
    import itertools

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import local_sgd as LS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.utils.rng import TorchKey
    from repro_torch.utils.tree import tree_leaves, tree_map

    q = MESH_RUN
    dev = torch.device(dev)
    full = get_arch("qwen3-14b")
    cfg = full.replace(n_layers=q["layers"])
    log(f"[cut] phase 21a: qwen3-14b at full width, depth cut to "
        f"{q['layers']} of {full.n_layers} layers; {q['steps']} local steps "
        f"and one dense round")
    out = {}
    mesh = make_host_mesh(1, 1, device=dev)
    try:
        state = LS.init_state(0, cfg, q["clients"], device=dev)
        host = tree_map(lambda t: t.to("cpu") if torch.is_tensor(t) else t,
                        state)
        del state
        torch.cuda.empty_cache()
        batches = list(itertools.islice(synthetic_batches(
            cfg, q["clients"], q["batch"], q["seq"], seed=0, device=dev),
            q["steps"]))
        n_leaves = len(tree_leaves(host["params"]))
        torch.cuda.reset_peak_memory_stats()
        pair = mesh_pair(torch, cfg, dev, host, batches, q["eta"], mesh)
        diff = pair.pop("diff")
        launches = pair["mesh"]["launches"]
        want = {"flash_attention": 2 * q["layers"] * q["clients"]
                * q["steps"],
                "fused_sgd_update": q["clients"] * q["steps"],
                "quantize_kernel": 0, "dequant_mean_kernel": 0}
        med = {r: sorted(pair[r]["step_ms"][1:])[len(pair[r]["step_ms"][1:])
                                                // 2] for r in pair}
        log(f"[mesh] 21a qwen3-14b, {cfg.n_layers} layers, 1x1 mesh over "
            f"{dist.get_backend()}: {'bit-equal' if not diff else 'DIFFER'}"
            f" to the device route after {q['steps']} local steps and a "
            f"dense round; ms a step (device / mesh): "
            f"{[round(v, 2) for v in pair['device']['step_ms']]} / "
            f"{[round(v, 2) for v in pair['mesh']['step_ms']]}, median of "
            f"steps 2-{q['steps']} {med['device']:.2f} / {med['mesh']:.2f};"
            f" round {pair['device']['sync_ms']:.2f} / "
            f"{pair['mesh']['sync_ms']:.2f} ms; loss "
            f"{pair['device']['loss']:.6f} / {pair['mesh']['loss']:.6f}; "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; mesh "
            f"launches {launches}")
        if diff:
            raise AssertionError(f"phase 21a: the mesh route differs at "
                                 f"{diff[:5]}")
        expect_launches("phase 21a mesh", launches, want)
        out["full"] = {"bit_equal": True, "layers": cfg.n_layers,
                       "step_ms": {r: pair[r]["step_ms"] for r in pair},
                       "median_step_ms": med,
                       "sync_ms": {r: pair[r]["sync_ms"] for r in pair},
                       "launches": launches, "n_leaves": n_leaves}
        del pair, host
        torch.cuda.empty_cache()

        # the int8 round at SMOKE width (16b's configuration)
        scfg = get_arch("qwen3-14b", smoke=True).replace(dtype="float32")
        sstate = LS.init_state(0, scfg, LM_CHECK["clients"], device="cpu")
        sb = list(itertools.islice(synthetic_batches(
            scfg, LM_CHECK["clients"], LM_CHECK["batch"], LM_CHECK["seq"],
            seed=0, device=dev), q["smoke_steps"]))
        n_leaves = len(tree_leaves(sstate["params"]))
        spair = mesh_pair(torch, scfg, dev, sstate, sb, LM_CHECK["eta1"],
                          mesh, reducer="int8", rng=TorchKey(0, dev))
        sdiff = spair.pop("diff")
        swant = {"flash_attention": 2 * scfg.n_layers * LM_CHECK["clients"]
                 * q["smoke_steps"],
                 "fused_sgd_update": LM_CHECK["clients"] * q["smoke_steps"],
                 "quantize_kernel": n_leaves,
                 "dequant_mean_kernel": n_leaves}
        log(f"[mesh] 21a qwen3 SMOKE int8 round, 1x1 mesh: "
            f"{'bit-equal' if not sdiff else 'DIFFER'} to the device route "
            f"(params, moments, residuals); mesh launches "
            f"{spair['mesh']['launches']}")
        if sdiff:
            raise AssertionError(f"phase 21a int8: the mesh route differs at "
                                 f"{sdiff[:5]}")
        expect_launches("phase 21a int8 mesh", spair["mesh"]["launches"],
                        swant)
        out["smoke_int8"] = {"bit_equal": True,
                             "launches": spair["mesh"]["launches"]}
        out["launches"] = {k: launches[k] + spair["mesh"]["launches"][k]
                           for k in launches}
        del spair

        # the top-k round at SMOKE width: the full width does not fit
        t_topk = time.monotonic()
        smi = nvidia_smi_line()
        mem = topk_memory_reckoning(cfg, q["clients"])
        log(f"[cut] phase 21a top-k round at SMOKE width: at full width "
            f"({cfg.n_layers} layers) two clients' state is "
            f"{mem['state_gb']:.1f} GB, the round's float32 ref "
            f"{mem['ref_gb']:.1f} GB and residuals {mem['res_gb']:.1f} GB, "
            f"and the embedding leaf's float32 delta "
            f"({mem['embed_delta_gb']:.1f} GB) is held as y, |y| and deq: "
            f"{mem['total_gb']:.1f} GB before the step's own buffers, on a "
            f"card of 80 GB")
        sstate = LS.init_state(0, scfg, LM_CHECK["clients"], device="cpu")
        tpair = mesh_pair(torch, scfg, dev, sstate, sb, LM_CHECK["eta1"],
                          mesh, reducer="topk", rng=TorchKey(0, dev))
        tdiff = tpair.pop("diff")
        twant = dict(swant, quantize_kernel=0, dequant_mean_kernel=0)
        log(f"[mesh] 21a qwen3 SMOKE top-k round, 1x1 mesh: "
            f"{'bit-equal' if not tdiff else 'DIFFER'} to the device route "
            f"(params, moments, ref, residuals); round "
            f"{tpair['device']['sync_ms']:.2f} / "
            f"{tpair['mesh']['sync_ms']:.2f} ms (device / mesh); mesh "
            f"launches {tpair['mesh']['launches']}; {smi}")
        if tdiff:
            raise AssertionError(f"phase 21a top-k: the mesh route differs "
                                 f"at {tdiff[:5]}")
        expect_launches("phase 21a top-k mesh", tpair["mesh"]["launches"],
                        twant)
        out["smoke_topk"] = {"bit_equal": True, "memory": mem,
                             "sync_ms": {r: tpair[r]["sync_ms"]
                                         for r in ("device", "mesh")},
                             "launches": tpair["mesh"]["launches"]}
        for k in out["launches"]:
            out["launches"][k] += tpair["mesh"]["launches"][k]
        del tpair
        torch.cuda.empty_cache()
        out["topk_selection"] = run_topk_selection(torch, dev, smi)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # the launcher starts and ends its own world-1 group
    launcher = run_topk_launcher(torch, dev)
    for k in out["launches"]:
        out["launches"][k] += launcher["launches"].get(k, 0)
    out["topk_launcher"] = launcher
    log("[mesh] 21a the two-level round with a compressed intra hop "
        "(int8 or top-k) is not run here: its pod axis needs 2 ranks and "
        "this run has one card; the 4-process gloo cases of "
        "tests/test_torch_mesh.py hold it to the reference")
    log(f"[time] phase 21a top-k additions: "
        f"{time.monotonic() - t_topk:.1f} s")

    # 21b: the dry run on the fake (16, 16) mesh, traced on fake CUDA
    # tensors and again on fake CPU ones (a build without CUDA traces
    # those): the two records must agree
    t0 = time.monotonic()
    recs = {}
    for fdev in ("cuda", "cpu"):
        fmesh = make_production_mesh(device_type=fdev)
        try:
            allocated = torch.cuda.memory_allocated()
            recs[fdev] = dryrun.dryrun_cell(
                "qwen3-14b", "train_4k", fmesh, verbose=False,
                microbatch=q["dryrun_microbatch"],
                programs=["local_step", "sync_step"])
            if torch.cuda.memory_allocated() != allocated:
                raise AssertionError("phase 21b: the dry run allocated on "
                                     "the card")
        finally:
            dist.destroy_process_group()
    rec = recs["cuda"]
    for p in rec["programs"]:
        log(f"[mesh] 21b dry run qwen3-14b x train_4k on the fake (16, 16) "
            f"mesh, {p['program']} (microbatch {q['dryrun_microbatch']}): "
            f"per-rank peak {p['memory']['peak_bytes']} B, arguments "
            f"{p['memory']['argument_bytes']} B, {p['cost']['flops']:.4e} "
            f"FLOPs, link bytes by axis {p['collectives']['by_axes']}, "
            f"by kind {p['collectives']['by_kind']}, "
            f"kernels {p['kernels']}")
    same = recs["cpu"]["programs"] == rec["programs"]
    log(f"[mesh] 21b the trace on fake CPU tensors "
        f"{'equals' if same else 'DIFFERS from'} the trace on fake CUDA "
        f"tensors")
    if not same:
        raise AssertionError(f"phase 21b: CPU trace {recs['cpu']['programs']}"
                             f" against CUDA trace {rec['programs']}")
    local, sync = rec["programs"]
    if not (sum(v for k, v in local["collectives"]["by_axes"].items()
                if "data" in k) < 1e5
            < sum(v for k, v in sync["collectives"]["by_axes"].items()
                  if "data" in k)):
        raise AssertionError(f"phase 21b: client-axis traffic {rec}")
    out["dryrun"] = {"microbatch": q["dryrun_microbatch"],
                     "seconds": time.monotonic() - t0,
                     "programs": rec["programs"]}
    return out


# phase 22: the five user examples (``examples_torch/``), each script's
# sections on the card at its own widths, their gradient steps, stages,
# rounds and local steps cut for the script's time (each cut logged).
# The optimum of the three logreg examples: 1,000 of its 4,000 gradient
# steps (a host-bound 2 ms a step on the card)
EXAMPLE_GD_STEPS = 1000
# quickstart's runs, held against the same sections on the CPU
EXAMPLE_QS_CUTS = {"sync": {"max_rounds": 64}, "local": {"max_rounds": 32},
                   "stl_sc": {"n_stages": 1}}
# the gaps past the script's own target (1e-4, which the cut runs do not
# reach) at which the card's and the CPU's rounds to target are compared
EXAMPLE_GAPS = (3e-1, 1e-1, 3e-2, 1e-2, 3e-3, 1e-3)
# hierarchical_pods: the simulator comparison at 1 of its 8 stages, the
# driver section at 2 of its 4
EXAMPLE_HP_STAGES, EXAMPLE_HP_DRIVER_STAGES = 1, 2
# federated_noniid: its three algorithms cut as quickstart's; each reducer
# at 1 of 14 stages; the straggler runs at 32 rounds (merges when async);
# the MLP's blocking and streaming runs at 1 of 2 stages
EXAMPLE_FED_CUTS = EXAMPLE_QS_CUTS
EXAMPLE_FED_REDUCER_STAGES = 1
EXAMPLE_FED_STRAGGLER_CUTS = {"local": {"max_rounds": 32},
                              "stl_sc": {"max_rounds": 32}}
EXAMPLE_FED_STREAM_STAGES = 1
# train_llm_stl --hundred-m: 160 of its 200 local steps (the script checks
# that the loss falls from 150; at 150 the third stage has run 6 steps)
EXAMPLE_LM_STEPS = 160
EXAMPLE_KERNELS = TRAIN_KERNELS + ("flash_attention",)


def example_optimum(mod, prob, label):
    """An example's ``optimum`` section at ``EXAMPLE_GD_STEPS`` steps."""
    log(f"[cut] phase 22: {label} optimum, {EXAMPLE_GD_STEPS} of "
        f"{mod.GD_STEPS} gradient steps")
    return mod.optimum(prob, steps=EXAMPLE_GD_STEPS)


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cut_runs(label: str, runs, cuts, max_rounds: int):
    """An example's (name, kw) table with ``cuts`` applied, each cut
    logged: a list of (name, kw, max_rounds)."""
    out = []
    for name, kw in runs:
        cut = cuts[name]
        n = cut.get("n_stages", kw["n_stages"])
        if "n_stages" in cut:
            log_cut("phase 22", f"{label} {name}", n, kw["n_stages"])
        if "max_rounds" in cut:
            log(f"[cut] phase 22: {label} {name}: {cut['max_rounds']} of "
                f"its rounds")
        out.append((name, dict(kw, n_stages=n),
                    cut.get("max_rounds", max_rounds)))
    return out


def same_rounds_to_target(label, hists, fstars, gaps, eval_every) -> dict:
    """Rounds to each gap on the card and on the CPU: equal, or one eval
    interval apart where both runs' values at the earlier of the two
    records lie within 1e-6 of the target. Returns per gap both rounds
    and the margin: the least distance to the target of the records at
    or one interval before either crossing."""
    from repro_torch.core.simulate import rounds_to_target

    out = {}
    for gap in gaps:
        r = {d: rounds_to_target(h, fstars[d] + gap) for d, h in hists.items()}
        near = [abs(rec.value - fstars[d] - gap) for d, h in hists.items()
                for rec in h for x in r.values() if x is not None
                and 0 <= x - rec.round <= eval_every]
        out[str(gap)] = {**r, "margin": min(near) if near else None}
        a, b = r.values()
        if a == b:
            continue
        first = min(x for x in (a, b) if x is not None)
        at = [abs(rec.value - fstars[d] - gap) for d, h in hists.items()
              for rec in h if rec.round == first]
        if None in (a, b) or abs(a - b) != eval_every or max(at) > 1e-6:
            raise AssertionError(f"{label}: rounds to gap {gap}: {r}, "
                                 f"values at round {first} {at}")
    return out


def example_quickstart(torch, dev) -> dict:
    """22a: quickstart's optimum and its three runs on the card and on the
    CPU from the same draws (``HostKey``): f* within 1e-6 relative, the
    histories within 1e-4, rounds to each gap as ``same_rounds_to_target``
    holds them."""
    from repro_torch.utils.rng import TorchKey

    qs = load_example("quickstart")
    sides = {"card": dev, "cpu": torch.device("cpu")}
    probs = {s: qs.problem(d) for s, d in sides.items()}
    fstar, out = {}, {"runs": {}, "optimum_s": {}}
    for s in sides:
        t0 = time.monotonic()
        fstar[s] = example_optimum(qs, probs[s], f"quickstart ({s})")
        out["optimum_s"][s] = time.monotonic() - t0
    out["fstar"] = fstar
    log(f"[examples] 22a quickstart f* card {fstar['card']!r}, CPU "
        f"{fstar['cpu']!r} ({EXAMPLE_GD_STEPS} float32 gradient steps)")
    if abs(fstar["card"] - fstar["cpu"]) > 1e-6 * abs(fstar["cpu"]):
        raise AssertionError(f"phase 22a: f* {fstar}")
    for algo, kw, max_rounds in cut_runs("quickstart", qs.ALGOS,
                                         EXAMPLE_QS_CUTS, qs.MAX_ROUNDS):
        got = {s: qs.compare(probs[s], fstar[s], [(algo, kw)],
                             max_rounds=max_rounds, device=d,
                             rng=HostKey(TorchKey(0), d))[algo]
               for s, d in sides.items()}
        hists = {s: g[0] for s, g in got.items()}
        if [(r.round, r.iteration) for r in hists["card"]] != \
                [(r.round, r.iteration) for r in hists["cpu"]]:
            raise AssertionError(f"phase 22a {algo}: the records differ")
        err = max(abs(a.value - b.value)
                  for a, b in zip(hists["card"], hists["cpu"]))
        rounds = same_rounds_to_target(f"phase 22a {algo}", hists, fstar,
                                       (qs.TARGET,) + EXAMPLE_GAPS,
                                       qs.EVAL_EVERY)
        wall, iters = got["card"][2], hists["card"][-1].iteration
        log(f"[examples] 22a quickstart {algo}: {len(hists['card'])} "
            f"records, card vs CPU max |diff| {err:.3g} (tol 1e-4); rounds "
            f"to gap (card / CPU; margin): " + ", ".join(
                f"{g}: {m['card']} / {m['cpu']}; "
                + ("-" if m["margin"] is None else f"{m['margin']:.3g}")
                for g, m in rounds.items())
            + f"; {iters} local steps in {wall:.3f} s on the card, "
            f"{1e3 * wall / iters:.4f} ms a step")
        if not err <= 1e-4:
            raise AssertionError(f"phase 22a {algo}: card vs CPU {err}")
        out["runs"][algo] = {"max_abs_diff": err, "rounds_to_gap": rounds,
                             "iters": iters, "wall_s": wall,
                             "ms_per_step": 1e3 * wall / iters}
    return out


def example_pods(torch, dev) -> dict:
    """22b: hierarchical_pods on the card — the three topologies' summaries,
    then the driver section, whose own asserts hold the executed byte
    ledger to the tree totals (both cut in stages)."""
    hp = load_example("hierarchical_pods")
    prob = hp.problem(dev)
    fstar = example_optimum(hp, prob, "hierarchical_pods")
    log_cut("phase 22b", "hierarchical_pods simulator comparison",
            EXAMPLE_HP_STAGES, hp.SIM_SCHEDULE["n_stages"])
    sims = hp.compare(prob, fstar, schedule=dict(
        hp.SIM_SCHEDULE, n_stages=EXAMPLE_HP_STAGES), device=dev)
    log_cut("phase 22b", "hierarchical_pods driver",
            EXAMPLE_HP_DRIVER_STAGES, hp.DRIVER_SCHEDULE["n_stages"])
    ds, gap = hp.driver(prob, fstar, dict(
        hp.DRIVER_SCHEDULE, n_stages=EXAMPLE_HP_DRIVER_STAGES), device=dev)
    out = {"fstar": fstar, "summaries": {n: s for n, (_, s) in sims.items()},
           "final_gaps": {n: h[-1].value - fstar
                          for n, (h, _) in sims.items()},
           "driver": {"rounds": ds.rounds_total, "iters": ds.iters_total,
                      "comm_bytes": ds.comm_bytes_total,
                      "leaf_ledger": ds.leaf_ledger, "gap": gap}}
    for name, (hist, _) in sims.items():
        check_objective(f"phase 22b {name}", [h.value for h in hist])
    return out


def example_noniid(torch, dev) -> dict:
    """22c: federated_noniid on the card — ζ and the theory k₁, the three
    algorithms, the three reducers with their comm summaries, the
    straggler runs and the MLP's uploads; streaming bit-equal to blocking
    (every history value and the final parameters)."""
    import dataclasses

    from repro_torch.models import mlp
    from repro_torch.utils.tree import tree_leaves

    fed = load_example("federated_noniid")
    prob = fed.problem(dev)
    zeta, k1_hom, k1_non = fed.heterogeneity(prob)
    fstar = example_optimum(fed, prob, "federated_noniid")
    out = {"zeta": zeta, "theory_k1": [k1_hom, k1_non], "fstar": fstar}
    runs = cut_runs("federated_noniid", fed.ALGOS, EXAMPLE_FED_CUTS,
                    fed.MAX_ROUNDS)
    out["rounds_to_target"] = {}
    for algo, kw, max_rounds in runs:
        hist, r = fed.compare(prob, fstar, [(algo, kw)],
                              max_rounds=max_rounds, device=dev)[algo]
        check_objective(f"phase 22c {algo}", [h.value for h in hist])
        out["rounds_to_target"][algo] = r
    log_cut("phase 22c", "federated_noniid reducers",
            EXAMPLE_FED_REDUCER_STAGES, fed.REDUCER_SCHEDULE["n_stages"])
    reds = fed.reducers(prob, fstar, schedule=dict(
        fed.REDUCER_SCHEDULE, n_stages=EXAMPLE_FED_REDUCER_STAGES),
        device=dev)
    out["reducers"] = {r: s for r, (_, s) in reds.items()}
    strag = {}
    for algo, kw, max_rounds in cut_runs(
            "federated_noniid stragglers", fed.STRAGGLER_RUNS,
            EXAMPLE_FED_STRAGGLER_CUTS, None):
        strag.update(fed.stragglers(prob, fstar, [(algo, kw)],
                                    max_rounds=max_rounds, device=dev))
    out["stragglers"] = {f"{a} {m}": {"rounds": r.rounds,
                                      "wall_clock_s": r.wall_clock_s}
                         for (a, m), r in strag.items()}
    log_cut("phase 22c", "federated_noniid streaming",
            EXAMPLE_FED_STREAM_STAGES, fed.STREAM_CFG.n_stages)
    res = fed.streaming(prob, mlp.init_params(fed.D, seed=42, device=dev),
                        dataclasses.replace(
                            fed.STREAM_CFG,
                            n_stages=EXAMPLE_FED_STREAM_STAGES), device=dev)
    b, s = res["blocking"], res["streaming"]
    equal = [r.value for r in b.history] == [r.value for r in s.history] \
        and all(torch.equal(x, y) for x, y in zip(tree_leaves(b.params),
                                                   tree_leaves(s.params)))
    log(f"[examples] 22c streaming against blocking on the card: "
        f"{'bit-equal' if equal else 'DIFFERENT'} over "
        f"{len(b.history)} records and {len(tree_leaves(b.params))} leaves;"
        f" modeled wall {b.wall_clock_s!r} / {s.wall_clock_s!r} s")
    if not equal or not s.wall_clock_s < b.wall_clock_s:
        raise AssertionError("phase 22c: streaming against blocking")
    out["streaming"] = {"bit_equal": equal, "records": len(b.history),
                        "wall_clock_s": [b.wall_clock_s, s.wall_clock_s]}
    return out


def example_serve(torch, dev) -> dict:
    """22d: serve_batched whole on the card — its own check holds request
    0's tokens to ``greedy_decode`` on the card."""
    sb = load_example("serve_batched")
    cfg, params = sb.model(dev)
    engine, requests, report = sb.serve(cfg, params)
    sb.check_request0(cfg, params, requests, report)
    return {"completed": len(report.completed), "n_steps": report.n_steps,
            "n_prefills": report.n_prefills,
            "measured_wall_s": report.measured_wall_s,
            "measured_tok_s": report.measured_tok_s,
            "decode_step_s_modeled": engine.decode_step_s}


def example_train(torch, dev) -> dict:
    """22e: train_llm_stl --hundred-m at ``EXAMPLE_LM_STEPS`` of its 200
    local steps; from 150 the script's own check holds the last stage's
    mean loss below the first's."""
    tl = load_example("train_llm_stl")
    log(f"[cut] phase 22e: train_llm_stl --hundred-m at {EXAMPLE_LM_STEPS} "
        f"of its 200 local steps")
    cfg, batch, seq = tl.model_config(hundred_m=True)
    state = tl.init(cfg, 4, device=dev)   # the script's --clients
    ds, dt = tl.train(cfg, state, batch, seq, EXAMPLE_LM_STEPS, device=dev)
    losses = [r.mean_loss for r in ds.results]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"phase 22e: stage losses {losses}")
    return {"iters": ds.iters_total, "rounds": ds.rounds_total,
            "wall_s": dt, "tok_s": ds.iters_total * 4 * batch * seq / dt,
            "stage_losses": losses}


def run_examples_phase(torch, dev="cuda:0") -> dict:
    """Phase 22: the five examples' sections on the card (22a-e), each
    example's kernel launches counted from 0 over its card runs (the CPU
    runs of 22a launch none)."""
    from repro_torch import kernels

    dev = torch.device(dev)
    out, launches = {}, dict.fromkeys(EXAMPLE_KERNELS, 0)
    for name, run in (("quickstart", example_quickstart),
                      ("hierarchical_pods", example_pods),
                      ("federated_noniid", example_noniid),
                      ("serve_batched", example_serve),
                      ("train_llm_stl", example_train)):
        t0 = time.monotonic()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out[name] = run(torch, dev)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        out[name].update(launches=counts, seconds=time.monotonic() - t0)
        for k in EXAMPLE_KERNELS:
            launches[k] += counts[k]
        log(f"[examples] {name}: {out[name]['seconds']:.1f} s, launches "
            f"{counts}")
        torch.cuda.empty_cache()
    log(f"[examples] phase 22 launches {launches}")
    missing = [k for k, v in launches.items() if not v > 0]
    if missing:
        raise AssertionError(f"phase 22: {missing} never launched")
    out["launches"] = launches
    return out


def main() -> int:
    import torch

    # phase 1: environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {name}")
    smi = nvidia_smi_line()
    log(smi)

    # phase 2: build
    t_start = t0 = time.monotonic()
    build.library()
    log(f"[build] kernels built and loaded in "
        f"{time.monotonic() - t0:.2f} s ({build.build()})")

    # phase 3: kernels against their plain versions
    shapes = PHASE3_SHAPES
    floor = launch_floor_ms(torch)
    log(f"[kernels] launch floor: a kernel that returns at once takes "
        f"{floor * 1e3:.2f} us on the device")
    rows = check_kernels(torch, shapes, floor)
    trees = check_trees(torch, floor)
    # the SSD layer call's kernels, profiled before any other profile of
    # the run: a profiler session that follows a large one loses device
    # events at its start (after the serving phases' profiles, all of the
    # call's)
    ssd_passes = ssd_layer_kernels_ms(torch)

    # phase 4: the slice
    small_reference_check(torch)
    x, y = slice_data()
    launches = {}
    for model in ("logreg", "mlp"):
        counts, _ = run_slice(torch, model, x, y)
        for k in TRAIN_KERNELS:
            launches[k] = launches.get(k, 0) + counts[k]
    if launches["fused_sgd_update"] != 2 * 3584:
        raise AssertionError(f"fused_sgd_update launched "
                             f"{launches['fused_sgd_update']} times over the "
                             f"two runs, not one per local step (7168)")
    profiles = {model: profile_slice(torch, model, x, y)
                for model in ("logreg", "mlp")}
    # phase 13's and phase 15's profiles, taken here: a profiler session
    # that follows the serving phases' profiles loses device events at its
    # start
    async_profile = profile_runtime_async(torch)
    cnn_profile = profile_cnn(torch)
    torch.cuda.empty_cache()
    log(f"[time] phases 2-4: {time.monotonic() - t_start:.1f} s")

    # phases 5-7: flash attention, then the gemma2 serving path
    t0 = time.monotonic()
    flash = check_flash(torch)
    serve_reference_check(torch, "gemma2-27b", 80)
    torch.cuda.empty_cache()
    serve = serve_full_width(torch, "gemma2-27b")
    launches["flash_attention"] = serve["launches"]
    torch.cuda.empty_cache()
    log(f"[time] phases 5-7: {time.monotonic() - t0:.1f} s")

    # phases 8-10: the SSD kernel, then the mamba2 serving path
    t0 = time.monotonic()
    ssd_rows = check_ssd(torch, ssd_passes)
    serve_reference_check(torch, "mamba2-2.7b", 100)
    torch.cuda.empty_cache()
    serve_m = serve_full_width(torch, "mamba2-2.7b")
    launches["ssd"] = serve_m["launches"]
    torch.cuda.empty_cache()
    log(f"[time] phases 8-10: {time.monotonic() - t0:.1f} s")

    # phases 11-13: the adaptive period, then the event runtime
    t0 = time.monotonic()
    adaptive_reference_check(torch)
    adaptive = run_adaptive(torch)
    runtime_sync = run_runtime_sync(torch)
    runtime_async = run_runtime_async(torch)
    runtime_async["profile"] = async_profile
    # the kernels at the shapes phases 11-13 gave them, against their
    # plain versions: the blocks and the trees
    path_rows = check_kernels(torch, PATH_SHAPES, floor)
    path_tree_rows = check_trees(torch, floor, path_trees(torch))
    for part in (adaptive["counts"], runtime_sync["launches"],
                 runtime_async["launches"]):
        for k in TRAIN_KERNELS:
            launches[k] += part[k]
    log(f"[time] phases 11-13: {time.monotonic() - t0:.1f} s")

    # phase 14: the two-level topology (Table 4's hierarchical row, Table 5d)
    t0 = time.monotonic()
    hier = run_hierarchical(torch)
    log(f"[time] phase 14: {time.monotonic() - t0:.1f} s")

    # phase 15: Table 2's ResNet18 and VGG16 at full width, then the three
    # training kernels at the CNN's shapes, the whole stacked tree included
    t0 = time.monotonic()
    cnn_run = run_cnn(torch)
    cnn_run["profile"] = cnn_profile
    torch.cuda.empty_cache()
    cnn_rows = check_kernels(torch, CNN_SHAPES, floor)
    cnn_tree_rows = check_trees(torch, floor, cnn_trees(torch))
    torch.cuda.empty_cache()
    for part in (hier["launches"], cnn_run["launches"]):
        for k in TRAIN_KERNELS:
            launches[k] += part[k]
    log(f"[time] phase 15: {time.monotonic() - t0:.1f} s")

    # phase 16: transformer training — flash attention's gradients on the
    # card, qwen3 SMOKE card against CPU, qwen3-14b at full width
    t0 = time.monotonic()
    flash_grad = check_flash_grad(torch)
    lm_check = train_reference_check(torch)
    lm = run_qwen3_training(torch)
    lm["flash_grad"], lm["check"] = flash_grad, lm_check
    # the training kernels at the blocks 16b's int8 rounds hand them
    lm_shapes = lm_path_shapes()
    path_rows.update(check_kernels(torch, lm_shapes, floor))
    path_shapes = {**PATH_SHAPES, **lm_shapes}
    # the launches of 16b's three card runs and of 16c's main run
    for part in (*lm_check["launches"].values(), lm["launches"]):
        for k in (*TRAIN_KERNELS, "flash_attention"):
            launches[k] += part[k]
    log(f"[time] phase 16: {time.monotonic() - t0:.1f} s")

    # phase 17: Mamba2 training — the SSD Function's gradients on the card,
    # mamba2 SMOKE card against CPU, mamba2-2.7b at full width (8 of 64
    # layers) through launch/train, then serving its checkpoint
    t0 = time.monotonic()
    m2 = run_mamba2_phase(torch)
    m2_shapes = lm_path_shapes("mamba2-2.7b", "mamba2")
    path_rows.update(check_kernels(torch, m2_shapes, floor))
    path_shapes.update(m2_shapes)
    # the launches of 17b's three card runs, 17c's main run and 17d's
    # serving run
    for part in (*m2["check"]["launches"].values(),
                 m2["train"]["launches"]):
        for k in (*TRAIN_KERNELS, "ssd"):
            launches[k] += part[k]
    launches["ssd"] += m2["serve"]["launches"]
    log(f"[time] phase 17: {time.monotonic() - t0:.1f} s")

    # phase 18: MoE and MLA — SMOKE card against CPU (serving and
    # training), flash at the new layers and the padded MLA calls,
    # deepseek-v2 served and gemma3-12b served with the int8 KV cache at
    # full width, phi3.5-moe trained at full width
    t0 = time.monotonic()
    mm = run_moe_mla_phase(torch, floor)
    path_rows.update(mm.pop("path_rows"))
    path_shapes.update(mm.pop("path_shapes"))
    # the launches of 18a's card training runs, 18b's and 18c's serving
    # runs and 18d's main run
    for part in (*[v for c in mm["train_check"].values()
                   for v in c["launches"].values()],
                 mm["train"]["launches"]):
        for k in (*TRAIN_KERNELS, "flash_attention"):
            launches[k] += part[k]
    launches["flash_attention"] += (mm["serve_deepseek"]["launches"]
                                    + mm["serve_gemma3"]["launches"])
    log(f"[time] phase 18: {time.monotonic() - t0:.1f} s")

    # phase 19: RG-LRU and the frontend archs — SMOKE card against CPU
    # (serving, a used slot, training), flash at the new shapes,
    # recurrentgemma-2b served and trained at full width, half its depth
    # (and its checkpoint served), internvl2-2b served with frontend
    # requests (half its depth),
    # musicgen-medium trained with frontend batches
    t0 = time.monotonic()
    rg = run_rglru_frontend_phase(torch, floor)
    path_rows.update(rg.pop("path_rows"))
    path_shapes.update(rg.pop("path_shapes"))
    # the launches of 19a's card training runs, 19b's, 19c's checkpoint's
    # and 19d's serving runs, and 19c's and 19e's main runs
    for part in (*[v for c in rg["train_check"].values()
                   for v in c["launches"].values()],
                 rg["train_rg"]["launches"], rg["train_audio"]["launches"]):
        for k in (*TRAIN_KERNELS, "flash_attention"):
            launches[k] += part[k]
    launches["flash_attention"] += (rg["serve_rg"]["launches"]
                                    + rg["serve_ckpt"]["launches"]
                                    + rg["serve_vlm"]["launches"])
    log(f"[time] phase 19: {time.monotonic() - t0:.1f} s")

    # phase 21: the mesh — qwen3-14b on a 1x1 mesh over NCCL against the
    # device route (full width dense, SMOKE int8), then the dry run on the
    # fake (16, 16) mesh
    t0 = time.monotonic()
    mesh_run = run_mesh_phase(torch)
    for k in TRAIN_KERNELS + ("flash_attention",):
        launches[k] += mesh_run["launches"][k]
    log(f"[time] phase 21: {time.monotonic() - t0:.1f} s")

    # phase 22: the five user examples (examples_torch/) on the card
    t0 = time.monotonic()
    examples = run_examples_phase(torch)
    for k in EXAMPLE_KERNELS:
        launches[k] += examples["launches"][k]
    log(f"[time] phase 22: {time.monotonic() - t0:.1f} s")
    log(f"[time] phases 2-22: {time.monotonic() - t_start:.1f} s")

    # phase 20: summary
    meta = {
        "fused_sgd_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                             "src/repro/kernels/fused_update/kernel.py:33"),
        "quantize_kernel": ("src/repro_torch/kernels/csrc/quantize.cu",
                            "src/repro/kernels/quantize/kernel.py:65"),
        "dequant_mean_kernel": ("src/repro_torch/kernels/csrc/quantize.cu",
                                "src/repro/kernels/quantize/kernel.py:98"),
    }
    out = []
    for kname, (src, replaces) in meta.items():
        r = rows[(kname, "logreg theta")]
        big = rows[(kname, "large")]
        out.append({"name": kname, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[kname],
                    "max_abs_err": max(
                        [rows[(kname, s)]["max_abs_err"] for s in shapes]
                        + [path_rows[(kname, s)]["max_abs_err"]
                           for s in path_shapes]
                        + [cnn_rows[(kname, s)]["max_abs_err"]
                           for s in CNN_SHAPES]),
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "launch_floor_ms": floor,
                    "examples_launches": examples["launches"][kname],
                    "shape": [N_CLIENTS, 784],
                    "large": {"shape": list(shapes["large"]),
                              "ms": big["ms"], "plain_ms": big["plain_ms"],
                              "library_ms": big["library_ms"],
                              "bound_ms": big["bound_ms"]}})
        # phases 11-13's blocks: the async path's (1, M) ones, the
        # stacked logreg leaf of Tables 4 and 5; phase 14's; 16b's
        out[-1]["path_shapes"] = {
            label: {k: path_rows[(kname, label)][k]
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "launch_floor_ms", "call_ms",
                              "host_ms", "max_abs_err")}
            for label in path_shapes}
        # phase 15's blocks: ResNet18's largest leaf, its head, a scale
        out[-1]["cnn_shapes"] = {
            label: {k: cnn_rows[(kname, label)][k]
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "launch_floor_ms", "call_ms",
                              "host_ms", "max_abs_err")}
            for label in CNN_SHAPES}
        if kname == "fused_sgd_update":
            out[-1]["tree"] = trees   # each whole tree, one launch
            out[-1]["path_trees"] = path_tree_rows
            out[-1]["cnn_tree"] = cnn_tree_rows
            out[-1]["lm_client_tree"] = lm["update_check"]
            out[-1]["mamba2_client_tree"] = m2["train"]["update_check"]
            out[-1]["moe_client_tree"] = mm["train"]["update_check"]
            out[-1]["rglru_client_tree"] = rg["train_rg"]["update_check"]
        if kname == "quantize_kernel":   # the scalar instantiation
            out[-1]["odd_view"] = {
                label: {"ms": rows[("quantize_kernel odd view", label)]["ms"]}
                for label in shapes}
    g = flash["global"]   # gemma2-27b's global layer at the 4,608-token prefill
    out.append({"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
                "launches": launches["flash_attention"],
                "max_abs_err": max([r["max_abs_err"] for r in flash.values()]
                                   + [r["max_abs_err"]
                                      for r in flash_grad.values()]
                                   + [r["max_abs_err"] for r in
                                      mm["flash"].values()]
                                   + [r["max_abs_err"] for r in
                                      mm["mla_flash"].values()]
                                   + [r["max_abs_err"] for r in
                                      rg["flash"].values()]),
                "ms": g["ms"], "plain_ms": g["plain_ms"],
                "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                "library_ms": g["library_ms"], "shape": g["shape"],
                "shapes": {**flash, **mm["flash"], **rg["flash"]},
                "train": flash_grad,
                "mla_shapes": mm["mla_flash"],
                "examples_launches": examples["launches"]["flash_attention"],
                "train_launches": lm["launches"]["flash_attention"]
                + sum(v["flash_attention"]
                      for v in lm_check["launches"].values()),
                "moe_mla_launches": {
                    "serve_deepseek": mm["serve_deepseek"]["launches"],
                    "serve_gemma3": mm["serve_gemma3"]["launches"],
                    "train_phi35": mm["train"]["launches"]["flash_attention"],
                    "smoke_train": sum(
                        v["flash_attention"]
                        for c in mm["train_check"].values()
                        for v in c["launches"].values())},
                "rglru_frontend_launches": {
                    "serve_recurrentgemma": rg["serve_rg"]["launches"],
                    "serve_recurrentgemma_ckpt": rg["serve_ckpt"]["launches"],
                    "serve_internvl2": rg["serve_vlm"]["launches"],
                    "train_recurrentgemma":
                        rg["train_rg"]["launches"]["flash_attention"],
                    "train_musicgen":
                        rg["train_audio"]["launches"]["flash_attention"],
                    "smoke_train": sum(
                        v["flash_attention"]
                        for c in rg["train_check"].values()
                        for v in c["launches"].values())}})
    m = ssd_rows["layer"]  # mamba2-2.7b's layer at a 4,096-token prefill
    out.append({"name": "ssd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ssd.cu",
                "replaces": "src/repro/kernels/ssd/kernel.py:68",
                "launches": launches["ssd"],
                "max_abs_err": max([r["max_abs_err"]
                                    for r in ssd_rows.values()]
                                   + [r["max_abs_err"] for r in
                                      m2["ssd_grad"].values()]),
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": None, "shape": m["shape"], "shapes": ssd_rows,
                "train": m2["ssd_grad"],
                "train_launches": m2["train"]["launches"]["ssd"]
                + sum(v["ssd"] for v in m2["check"]["launches"].values())})
    log(json.dumps({"kernels": out, "slice_profile": profiles,
                    "serve": serve, "serve_mamba2": serve_m,
                    "adaptive": adaptive, "runtime_sync": runtime_sync,
                    "runtime_async": runtime_async, "hierarchical": hier,
                    "cnn": cnn_run, "lm_train": lm, "mamba2": m2,
                    "moe_mla": mm, "rglru_frontend": rg, "mesh": mesh_run,
                    "examples": examples, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
