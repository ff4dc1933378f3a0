#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``tnn_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this file.
It builds every kernel of the port from ``tnn_tpu_torch/csrc`` (one ``nvcc``
per source, all started together) and runs these phases, each printing its
numbers on its own line:

1. device: the card's name, the device count and its power limit;
2. kernel: the paged-attention kernel (K1) against its plain PyTorch
   version at the shapes of ``gpt2_small`` serving, with the tolerance
   stated and each call's split-KV count, and its time beside the plain
   version's, a library call's and the card's bound;
3. flash: the flash-attention forward (K4) and backward (K7) against their
   plain versions at the training shape and its variants and at
   ``flash_vit``'s (B=128, H=6, S=65, D=64, non-causal, bf16 and f32; and
   S=17, its shape under ``cli.dist_worker``'s 32 x 32 images),
   with their times at the training shape and at flash_vit's bf16 shape
   beside the plain versions', the library's and the bound, and the
   backward call's time split by kernel (delta pre-pass, K7, the zero-fill
   of dQ's f32 buffer, the casts, the GQA group sum);
4. serving: ``InferenceEngine`` serving full-width ``gpt2_small`` (seeded
   random weights) 8 requests through the paged path, with K1's launch
   count read over that run;
5. cli: ``python -m tnn_tpu_torch.cli.serve`` on two JSON lines;
6. training: ``tnn_tpu_torch.cli.train_gpt2`` trains full-width
   ``flash_gpt2_small`` for 30 steps on a seeded synthetic corpus, with K4's
   and K7's launch counts, its steady step time and a profiler window read
   over that run; then one step with the kernels against the same step
   with the plain versions, under bf16 and FP32;
7. train_cli: a byte-mode corpus from the card's Python stdlib, trained at
   two layers with sampling (``generate`` through K4's ``kv_offset`` form);
8. int8_kernel: the int8 paged-attention kernel (K2) against its plain
   version at the serving shapes, with times beside the plain version's,
   SDPA's on the gathered, dequantized K/V and the bound;
9. int8_matmul: the weight-only int8 matmul (K3) against its plain version
   at GPT-2 small's five matmul shapes at 512 rows, the head at the 8 rows
   the serving path gives it, and a ragged case, with each shape's body,
   tile (bf16 GPT-2 shapes must run the tensor-core body, as the
   profiler's kernel names show), the repeat equal bit for bit, times
   beside the plain version's, ``torch.mm``'s and the bound, and K3's time
   over the 49 calls of one 512-row int8 serving step, on the planned
   bodies and on the SIMT body alone;
10. serving_int8: the serving phase's traffic with ``kv_dtype="int8",
   quant_weights=True``: K2 and K3 launch counts, the float model's
   teacher-forced closeness gate and a decode profile; then the CLI with
   ``--kv-dtype int8 --quant-weights``;
11. flash_split (run after flash): the split backward, K5 (dQ) and K6 (dK,
   dV), against the plain backward in K7's 13 cases and llama_small's
   attention at S=4096; against K7 at S=32,768, where K5 must repeat its
   dQ bit for bit; all four flash kernels under a mask of 4 x 2^30 bytes;
   times at S=32,768 beside the plain version's at S=4096, SDPA's (forward
   beside K4, backward beside the others) and the bound, each backward
   call split by kernel (delta pre-pass, body, group sum), and K5 + K6
   beside K7 and SDPA's backward;
12. training_long (run after training): full-width ``flash_llama_small``
   (vocab 32,000) trained at B=1, S=32,768 for 6 AdamW steps and 2
   held-out batches, with K4 = 12 x 8, K5 = K6 = 12 x 6 and K7 = 0
   launches, falling loss, step time, MFU, peak memory and a profiled
   step, whose flash kernels must be the tensor-core bodies of K4, K5 and
   K6; then the same cell from the same weights on the same 3 batches
   with ``lm_head_chunk=8192`` and with remat "full", "dots" and
   "offload_dots" against none: steady step time, peak memory, the losses
   against none's (bounds at ``LONG_VARIANTS``), K4 = 12 x steps (twice
   that under remat) and K5 = K6 = 12 x steps. train_cli (7) also runs
   ``--arch llama`` at S=32,768, 2 layers, and ``flash_gpt2_small`` at
   B=8, S=1024 through the CLI with ``--fused-head-loss 8192`` against the
   default: peak memory, tokens/s and a falling loss curve of each.

13. decode_stack: the fused decode-stack kernel (K8) against its plain
   version at gpt2_small's width in 48 cases (B 1 and 2, T 1024, three
   positions, bf16 and f32, 1, 2, 4 and 8 MLP chunks), layer by layer,
   with the 12-layer launch equal to the chain of one-layer launches;
   its launch plan (each block's rows and ring stages, the kernel's own
   ring depth) and each case's split count; times beside the plain
   version's and the unfused int8 blocks', and the step split into its
   five phases by one stamped launch;
14. fused_generate: ``cli.gpt2_inference --fused`` and ``--int8`` (64
   tokens, tokens/s), ``fused_generate`` in process (K8 = 63 launches),
   its teacher-forced logits against the unfused int8 step, and kernels
   and aten ops per token of both;
15. serving_fused: ``InferenceEngine(..., quant_weights=True,
   decode_path="fused", max_batch_size=2)`` on 6 requests (lockstep pairs,
   then a ragged pair): K8 = lockstep steps, K3 = 48 x wide standard
   mixed steps, the closeness gate, steady decode profiles beside the
   paged paths, and the CLI with ``--decode-path fused``;
16. paged_stats: the paged kernels' stats form (K1s: out and each row's
   softmax max m and normalizer l) against its plain version in 36 cases
   (both page types, bf16 and f32, decode and ragged chunks, Dh 64 and
   128, block sizes 4 to 32, holes and dead rows), each also split
   round-robin over 2 and 4 tables and merged against unsharded K1 / K2;
   times at the serving decode shape beside K1's;
17. serving_sp: ``InferenceEngine(sp=2, sp_devices=["cuda:0", "cuda:0"])``
   serving full-width ``gpt2_small``: teacher-forced mixed-step logits
   against sp=1, a 900-token prompt refused at sp=1 on one shard's pool
   and served at sp=2, the serving traffic on the bf16 and int8 pools
   (K1s = 2 x 12 x paged model steps, K1 = K2 = 0), the standard path,
   steady decode profiles beside sp=1, and the CLI with ``--sp 2``.
18. serving_prefix_spec: K1 at the speculative verify shape (8 rows of
   q_len 5, kv 100-1000, bf16 and f32, MHA and GQA 4) against its plain
   version and timed beside SDPA and the bound, and K2 over pages that
   ``kv_pool.copy_blocks`` cloned; then full-width ``gpt2_small``: a
   512-token shared prefix with 8 tails, the cache on against off (bf16
   and FP32; ``prefill_tokens_saved`` = 7 x 512, the sharers' TTFT, model
   steps by program, K1 = 12 x paged steps), a full-cover hit's
   copy-on-write clone, the int8 pool and weights (K2, K3) and sp=2 (K1s);
   8 cyclic prompts with ``spec="ngram"`` against spec off on the paged
   and fused paths and one ``spec="draft"`` pass (acceptance, committed
   tokens per step, decode tokens/s); FP32 streams token-exact on
   tie-free prompts, bf16 ones without a divergence above a 1e-2 gap; the
   CLI on two identical lines and with ``--spec ngram``. Its launches join
   K1's, K2's, K3's, K1s' and K8's on the kernels line.
19. serving_overlap: the serving traffic through the overlapped loop with
   every pdecode step a CUDA graph replay, against synchronous eager
   steps, on the bf16 pool and on the int8 pool and weights: token-exact
   on every request (half of them sampled), the graph count and capture
   time, adopted speculative steps and rebuilds, host gap p50 / p99,
   decode tokens/s, and K1 (or K2) = 12 x paged dispatches = 12 x (paged
   steps + rebuilds); steady decode steps of both in ABBA windows with
   device busy, idle share and aten ops from a profiled window, and one
   staged step through the eager program and one replay, equal bit for
   bit; the fused path with overlap on (eager K8) against off; the CLI
   by default and with ``--no-overlap``, the same tokens. Its overlapped
   runs' launches join K1's, K2's and K3's on the kernels line. Every
   earlier serving phase's pdecode steps replay graphs too.
20. serving_whole_prompt: full-width ``gpt2_small`` (seeded) written with
   ``checkpoint.save_model`` and loaded back on the card bit for bit
   (save and load seconds); a BPE vocab trained on the card's stdlib
   text; the serving traffic with ``chunked_prefill=False`` (each prompt
   one prefill program, ``apply_cached`` over its padded width, then
   ``scatter_prefill``) on the bf16 pool against chunked prefill in ABBA
   order (TTFT p50 / p95, decode tokens/s, wall), one prefill program's
   time and device-busy time at each padded width the traffic used, on
   the int8 pool and
   weights (K2, K3 = 49 x prefills of more than 256 padded rows) and on
   ``flash_gpt2_small`` (K4 = 12 x prefills, in ``apply_cached``'s
   ``kv_offset`` form); K1 / K2 = 12 x pdecode dispatches; FP32 streams
   token-exact against synchronous eager steps (sampled requests
   included); bounded admission at ``max_queue_depth=2`` under "reject"
   and "block"; the CLI with ``--model-file``, ``--vocab`` and
   ``--no-chunked-prefill`` on text lines. Its runs' launches join K1's,
   K2's, K3's and K4's on the kernels line.

21. attention_int8_rope: ``generate`` (64 tokens after a 128-token prompt)
   over the per-model int8 contiguous cache (``kv_cache_dtype="int8"``)
   beside the float cache on full-width ``gpt2_small`` and
   ``flash_gpt2_small`` (K4 = 12 x 64 in its ``kv_offset`` form): tokens/s
   of each in the order float, int8, int8, float, the int8 greedy tokens
   against the float model teacher-forced
   over them (>= 75%, the reference's closeness gate); then
   ``apply_paged`` with RoPE on ``flash_llama_small``'s first layer (12 q
   / 4 kv heads, bf16), decode and chunk forms at per-row offsets, K1
   against the same layer's ``apply_cached`` within 2^-5 of the largest
   output (the share of that limit printed). Its K4 launches join the
   kernels line.
22. serving_supervised: the serving traffic under a started
   ``EngineSupervisor`` (the engine on its worker thread, overlap on):
   token-exact on all 8 streams against the same engine driven by the
   overlapped loop and against the same supervisor driven inline
   (``run_sync``), timed in the order A B C C B A; one staged pdecode step with a NaN row through the
   eager program and one graph replay, equal bit for bit, the guard down
   for that row only; the seeded ``CHAOS_PLAN`` (a NaN prefill chunk, a
   transient and a persistent decode fault, an allocation failure, a NaN
   row through the graph, one crash mid-traffic) at 2 rows a step on the
   bf16 pool, on the int8 pool and weights, and under FP32: the planned
   states and migrations, one terminal event per request, no leaked
   block; the untouched and the migrated greedy streams token-exact
   under FP32 on tie-free prompts (apart only at near-ties elsewhere),
   in bf16 and int8 their equal tokens and divergence gaps reported and
   the closeness gate held; the watchdog after a warm-up (one restart, a
   "watchdog" dump); the restart budget (FAILED, exit code 1, every
   request terminal); a drain mid-traffic (STOPPED, exit code 0, its
   duration) and a 1 ms drain deadline (TIMED_OUT stragglers); traced
   against untraced in ABBA order (the same tokens, step time, the Chrome
   trace's spans and instants by name); the CLI as a subprocess with
   ``--watchdog-s``, ``--flight-dir`` and ``--trace`` on text lines,
   ended by SIGTERM mid-stream and by EOF (one terminal event a line,
   exit code 0). Every paged run holds K1 (K2 on the int8 pool) = 12 x
   paged dispatches and K3 = 49 x steps of more than 256 rows; a crash or
   an injected fault fires on the host before any launch, so a crashed
   step launches nothing and dispatches nothing. The fault-free run's K1,
   the bf16 chaos run's K1 and the int8 chaos run's K2 and K3 join the
   kernels line.
23. serving_fleet: the replica fleet (``serving/router.py``), each
   replica an ``InferenceEngine`` with its own 512 x 16-block pool on
   ``cuda:0`` under its own ``EngineSupervisor`` worker, all sharing
   full-width ``gpt2_small``'s weights: the serving traffic on 2 replicas
   under ``Router.start()`` against one supervised engine and a router
   over one replica (bf16, in the order fleet, one, router, router, one,
   fleet: decode tokens/s, mean step time, the placements, bf16
   agreement and gaps) and FP32 (greedy streams token
   for token); two replicas started together, each one's staged pdecode
   step through its graph equal to its eager program bit for bit;
   ``kill_replica`` after 16 streamed tokens (FP32: migrated
   streams exact, nothing duplicated or dropped, the survivor's pool
   empty, the migrated streams' longest token gap); roles prefill +
   decode at a 256-token threshold, four 512-token prompts and two short
   ones, with the KV handoff and with recompute (FP32 exact; blocks
   shipped, the receiver's saved prefill, the first-to-second token gap),
   the wire's bytes and export / adopt ms per block on the bf16, f32 and
   int8 pools (the adopted blocks read back byte-equal) and the int8 pool
   and weights through the same fleet (K2, K3; the decode replica's
   adopted blocks byte-equal to the prefill replica's); the host tier on a
   64-block pool (64 MiB): a 512-token prefix evicted and asked for
   again, tier on against off (readmits, tokens saved, the return's TTFT,
   the demote cost per block, the host gap, a pdecode replay after the
   readmit equal to the eager program); ``fleet_prefix`` (a prefix on
   replica 0 pulled by a sharer on replica 1); hedging against
   ``slow_replica(1, 0.2)``; an autoscaler 1..3 under a burst of 24
   requests (the replica count over time, every request done once, device
   memory before and after the retired pools are released); ``cli.serve
   --replicas 2 --http 127.0.0.1:0`` (SSE, non-stream, one-at-a-time
   tokens against an in-process router, health, stats, /metrics with
   replica labels and buckets, cancel, SIGTERM: 503 while draining, exit
   0); ``cli.serve`` on stdin with ``--roles``, ``--host-tier-bytes``,
   ``--fleet-prefix`` and ``--compile-cache DIR`` twice (the second start
   runs no nvcc, the same tokens). Every fleet run holds K1 (K2) = 12 x
   the paged dispatches summed over its replicas and K3 = 49 x its wide
   steps; its K1, K2 and K3 join the kernels line.
24. training_loop (run after train_cli): ``train_model`` on full-width
   ``flash_gpt2_small`` (B=8, S=1024) from a ``TrainingConfig`` (AdamW
   and warmup-cosine from its dicts) over ``OpenWebTextDataLoader`` on a
   synthetic uint16 corpus: 2 epochs of 4 steps with validation, ``best/``
   and per-epoch ``block=False`` snapshots, K4 = 12 x (train + eval
   steps) and K7 = 12 x train steps; a blocking save, an async save and a
   restore timed with their bytes; then a run cut after 3 steps and
   resumed from its snapshot against two unbroken 6-step runs: the
   restored state byte-equal to the saved one, the losses within the
   unbroken runs' spread (``RESUME_SPREAD``). Its K4 and K7 join the
   kernels line.

25. serving_tp: tensor parallelism in one process, ``InferenceEngine(tp=N,
   tp_devices=["cuda:0"] * N)`` on full-width ``gpt2_small``: one mixed
   step's logits at tp = 2 and 4 against tp = 1 on the same KV (K1 = tp x
   12 a step; K2 on the int8 pool); the serving traffic at tp 1, 2 and 4
   under FP32 (greedy streams token-exact but at near-ties below 1e-3),
   at tp = 2 on the bf16 and int8 pools (agreement and divergence gaps
   reported), K1 (K2) = tp x 12 x paged dispatches; 8 cyclic prompts with
   ``spec="ngram"`` at tp = 2 against spec off at tp = 1; the traffic
   under a started supervisor at tp = 2 with a crash mid-traffic against
   one without (the migrated streams exact, the pool empty after); a
   512-token chain handed from a tp = 2 prefill replica to a tp = 1 decode
   replica (the adopted blocks byte-equal to the wire); steady decode at
   tp 1, 2 and 4 in the order 1 2 4 4 2 1 (step time, decode tokens/s,
   then a profiled window each: device busy, idle share, kernels a step);
   one staged pdecode step at tp = 2 through the eager program and one
   graph replay, equal bit for bit; a traced run with one
   ``serve.allreduce`` span a dispatch; the CLI with ``--tp 2
   --tp-devices cuda:0,cuda:0`` and its stderr line. Its bf16 K1 and int8
   K2 join the kernels line. Shards on one card measure code paths, not
   NCCL or peer bandwidth.
26. serving_moe: ``moe_gpt2_small`` (8 experts, top-2, seeded) written
   with ``save_model`` and loaded back bit for bit; the serving traffic on
   the paged path (K1 = 12 x paged dispatches) and the standard path;
   one mixed step's logits with K1 against the plain version (bf16 and
   FP32); three ``make_train_step`` steps at B=4, S=1024 (the loss finite,
   ``aux_loss`` positive, peak memory); under FP32 the overlapped graph
   path against synchronous eager steps, every request token for token;
   then ``gpt2_small(tie_embeddings=False)`` with ``quant_weights=True``
   through the traffic: K3 = 49 x wide steps (the int8 head among them),
   the closeness gate, and K3 on the head at 512 rows against its plain
   version. Its K1 and K3 join the kernels line.

27. training_image: the image stack at the zoo's published widths, seeded
   weights, every line with the card's name and power limit: (a)
   ``cli.trainer --model cifar100_wrn16_8 --dataset cifar100`` on synthetic
   CIFAR-100 binaries (5,120 train and 1,024 test records of class
   patterns plus noise) with ``configs/digits_wrn16_8.json``'s optimizer
   and scheduler at B=128 for 2 epochs (steady step time, images/s, peak
   memory, each epoch's mean loss, which must fall, validation accuracy,
   the best snapshot), then ``cli.inferencer`` on that snapshot (its
   accuracy equal to the trainer's best validation, samples/s); (b)
   ``train_model`` of the same model with ``cifar_train_pipeline().apply``
   as ``augment`` against none, from the same weights, in the order none,
   pipeline, pipeline, none (step times, the pipeline's own time and
   share); (c) ``flash_vit`` (64 x 64 x 3, B=128) through ``train_model``
   over 200 ``images.npy`` class folders, 6 steps and one held-out batch:
   K4 = 6 x (train + eval forwards), K7 = 6 x train steps, K5 = K6 = 0, a
   profiled step whose flash kernels are the tensor-core bodies; then one
   step with K4 / K7 against the same step with the plain versions, bf16
   and FP32 (loss and gradient bounds at ``VIT_STEP_TOLERANCE``); (d)
   ``resnet50_imagenet`` at 224 x 224 x 3, B=64, 3 steps (step time,
   images/s, peak memory, the stem's and its max pool's asymmetric pads);
   (e) ``cli.hardware_info``. flash_vit's launches join K4's and K7's on
   the kernels line.
28. training_parallel: parallel training with every mesh position on
   ``cuda:0`` (code paths, not interconnect): (A) ``cifar100_wrn16_8``
   at B=128 through ``train_model`` with ``{"pipe": 4}`` over 4
   microbatches against single-device ``grad_accum=4`` from the same
   weights, 3 SGD steps: FP32 (cuDNN's TF32 off, its deterministic
   algorithms on) loss within 1e-5
   relative at each step and every BatchNorm running statistic within
   1e-5 + 1e-5 |accum| of the single-device one (with the gap a second
   single-device run leaves beside it), bf16 loss within 2e-2 and the
   statistics' gap reported; then the README's ``cli.trainer --mesh
   data=2,pipe=4 --num-microbatches 8 --pipeline-virtual 2`` (8 stages)
   against the same command without ``--mesh``, 2 epochs of 10 steps on
   synthetic CIFAR-100 records: the loss falls, step time, images/s and
   peak memory of both; (B) ``flash_gpt2_small``'s widths at 6 layers
   (``PAR_LAYERS``: phases 28 and 29 cut the depth, since PR 24, for the
   script's time limit; B=8, S=1024, AdamW) through ``train_model`` at
   ``{"data": 2}`` and ``{"data": 2, "fsdp": 2}`` against no mesh, 3
   steps and one validation batch: FP32 loss within 1e-5, bf16 within
   2e-2, K4 = 6 x replicas x (3 + 1), K7 = 6 x replicas x 3, the step
   time of steps 1-2 (CUDA events) and each run's peak allocated memory;
   (C) a ``LayerBuilder`` LM at GPT-2 small's width (embedding 50257 x
   768, positional, 6 x ``flash_gpt_block(12)``, layernorm, dense 50257)
   through ``StagePipeline`` on 4 stages from ``partition_model``, 4
   microbatches of 2 x 1024, 5 AdamW steps on a repeating token stream:
   the loss falls, K4 = K7 = 6 x 4 a step; (D) one
   ``make_pipeline_train_step`` step at ``{"pipe": 4}`` over a float
   input (dense 768, 6 x ``flash_gpt_block(12)``, a 64-class head per
   position) against gradient accumulation from the same weights: K4 =
   K7 = 6 x 4. The mesh runs' K4 and K7 join the kernels line.
29. training_parallel_axes: tensor, sequence and expert parallelism and
   FSDP's parameter sharding, every position on ``cuda:0`` (code paths,
   not interconnect), 2 steps a run from the same seeded weights and
   batches; FP32 runs (SGD at lr 1, TF32 off) gate the loss gap per step
   against the single-device step at 1e-5 relative and each leaf's first
   update (its gradient) beyond the f32 rounding of the new weights at
   1e-3 of the largest entry of the single-device step's, the worst
   leaf's gap; bf16 runs (AdamW)
   report the loss gap. A planted fault (every LayerNorm scale's
   gradient doubled, as if a replicated leaf's gradient were summed over
   the two "model" positions) at ``{"model": 2}`` must fail the update
   gate. Every run logs its step time (CUDA events) and peak memory:
   ``flash_gpt2_small``'s widths at 6 layers (B=8, S=1024) at
   ``{"model": 2}``, ``{"model": 4}``, ``{"data": 2, "model": 2}`` (K4 =
   K7 = 6 x positions x 2) and
   ``{"data": 2, "model": 2, "seq": 2}`` with the ring (no kernel);
   ``flash_llama_small``'s widths at 6 layers (B=1) with Ulysses at seq 2
   and 4, bf16 at S = 32,768 (K4 = K5 = K6 = 6 x sp x 2, K5 and K6's
   tensor-core bodies in
   the profiled step) and FP32 at 4,096 (K7), and with the ring at seq 2
   and 4 (FP32 at 4,096, bf16 at 8,192); ``moe_gpt2_small`` (B=4) at
   ``{"data": 2}`` and ``{"data": 2, "expert": 4}``; the 6-layer GPT-2
   FP32 at ``{"data": 2, "fsdp": 2}`` equal to ``{"data": 4}`` bit for
   bit (the backward on K5 + K6, which repeat their bits: K7's dQ
   atomics do not; data 4 twice), with the bytes each position holds
   between steps beside
   ``{"data": 2}``'s; ``cli.trainer --mesh data=2,seq=2
   --seq-parallel-method ulysses`` on ``gpt2_tiny`` (the Ulysses body
   runs, and launches K4 on a model whose backend is "xla"). Its K4, K7,
   K5 and K6 launches join the kernels line.
30. native: the host runtime (``tnn_tpu_torch.native``) built from
   ``native/src`` into ``build/native`` (the phase fails if it does not
   load), each entry point against the port's numpy path on the same
   inputs, byte for byte, with both host times beside the card's name:
   the row gather and the fused normalize over a 50,000 x 32 x 32 x 3 u8
   set at B=128 (and the array loader's f32 gather), CIFAR-10 / CIFAR-100
   files and an MNIST CSV written from a seed, BPE encode of 1 MB of the
   stdlib's text with a vocab trained in the phase, 1,024-token windows
   of a 4 M-token file; PNG (written here) and JPEG (PIL) files decoded
   and resized to 64 x 64 against the numpy resize of the source pixels
   (PNG, within 1 count) and of PIL's decode (JPEG, mean < 1, max <= 9),
   and the image-folder loader against its PIL path;
31. distributed: a ``Coordinator`` in this process on the native
   transport drives two ``cli.dist_worker`` ranks on the one card, rank 0
   on a thread here and rank 1 a ``python -m`` process: full-width
   ``flash_vit`` on the worker's synthetic 32 x 32 x 3 images (S=17, the
   cut from flash_vit's 64 x 64), B=128, 2 epochs of 20 steps; a mid-run
   ``save_all`` whose two rank directories restore through
   ``Checkpoint``, the "done" barrier, the merged profile holding
   ``worker0`` and ``worker1``, an evaluation pass of 4 batches over the
   initial weights and three restored snapshots (the loss falls), rank 0's
   launches K4 = 6 x (40 + 16) and K7 = 6 x 40 (they join the kernels
   line); then rank 1 is killed, seen by ``wait_failed``, a new rank 1
   rejoins (``wait_alive``) and ``shutdown`` ends every live worker with
   exit code 0.
32. debug_guards: the engine's debug knobs on full-width ``gpt2_small``
   over the serving traffic (8 requests, prompts 16-768, 64 new tokens,
   512 x 16-token blocks, 8 rows): ``TNN_DEBUG_SYNC=1`` (the step under
   torch's sync-debug mode "error") against the guard off, token for
   token with no trip, on the paged path and the overlapped graph step
   (each in the order off, on, on, off: step times, K1 = 12 x paged
   dispatches a run) and with n-gram and draft-model speculation on
   cyclic prompts; ``_put_step`` planted as a blocking copy from pageable
   memory, whose request must FAIL with the "synchronizing" error naming
   the copy, and which decodes token-exact without the knob;
   ``TNN_POOL_DEBUG=1`` over staggered shared-prefix traffic against the
   knob off (tokens, saved prefill, step times); the int8 pages, int8
   weights, whole-prompt, sp = 2, tp = 2, MoE and fused (K8) programs
   under the guard once each, every trip printed with its line. Its
   launches join the kernels line.
33. tools: ``tools/torch_trace_step.py`` (``gpt2_decode`` and ``wrn``, 2
   traced steps each: the window, the device operations' total, the gap
   and the top 10 operations) and ``tools/torch_hbm_fit.py`` at the
   card's memory, with ``gpt2_small``'s train state built on the card
   beside the tool's exact bytes (``memory_allocated``, and
   ``max_memory_allocated`` while it was built).
34. distributed_data: the data plane across processes. A ``Coordinator``
   deploys configs with ``jax_coordinator`` to two ``cli.dist_worker``
   ranks on the one card (this script's ``--data-rank`` runner, which
   calls ``dist_worker.main`` once a deploy and records each step's loss
   and CUDA-event time, the gradient all-reduce's and the batch check's
   time, the flash launches and peak memory): they join one gloo group
   (ranks that share a card) and train one ``{"data": 2}`` model on
   CIFAR-100 files written from a seed, 1,280 train and 128 held-out
   records. (a) Full-width ``flash_vit`` (S = 17 at 32 x 32), B=128,
   bf16 AdamW, 2 epochs of 10 steps and one held-out batch an epoch:
   both ranks' losses equal at each step, their parameters equal by
   digest, K4 = 6 x (20 + 2) and K7 = 6 x 20 a rank (they join the
   kernels line), the loss gap to the in-process ``{"data": 2}`` mesh
   (``["cuda:0"] * 2``) on the same batches reported, with both step
   times; (b) ``cifar100_wrn16_8`` in FP32 under SGD, 2 x 5 steps: both
   ranks' BatchNorm statistics equal by digest and within rtol 1e-5 /
   atol 1e-6 of the in-process mesh's; (c) the FP32 gate: flash_vit in
   FP32 under SGD at lr 1 for 2 steps on K5 + K6
   (``TNN_FLASH_FUSED_BWD=0``), its losses and each leaf's first update
   equal bit for bit to the in-process mesh's (the group adds the same
   two values), and (d) the same with rank 1's gradient
   buffer doubled before the all-reduce, which must fail the gate; (e)
   ``"synthetic"`` data (seeded per rank), which both ranks refuse at the
   batch check, and (f) a ``{"pipe": 2, "model": 2}`` deploy, refused
   before its mesh is made with the message both packages' loops share
   ("pipeline runs compose with 'data' only").
35. distributed_axes: fsdp, model and seq across processes. Two ranks on
   the one card (this script's ``--axes-rank`` runner) join one gloo
   group once and run ``flash_gpt2_small``'s widths at ``PAR_LAYERS`` (6)
   of its 12 layers (768d/12h, vocab 50257, B=8, S=1024, batches from a
   seed; the depth cut for the script's time limit) through
   ``make_dp_train_step`` at ``{"fsdp": 2}``, ``{"model": 2}``,
   ``{"seq": 2}`` by the ring and by Ulysses, one position a rank, each
   layout also on the in-process mesh (``["cuda:0"] * 2``: its FP32
   gates while the ranks start, its bf16 runs after them). (a) The FP32
   gate: SGD at lr 1 for 2 steps on K5 + K6 (``TNN_FLASH_FUSED_BWD=0``,
   TF32 off): both ranks' losses and parameters equal by digest and bit for
   bit to the in-process mesh's, each leaf's first update within 1e-3 of
   the in-process one's (every sum across the ranks adds the same two
   values), and one planted fault (tensor parallelism's g summing the
   gradient in the backward too, at ``{"model": 2}``) failing the gate. (b)
   bf16 AdamW, 2 steps: the loss gap, the second step's time from CUDA
   events beside the in-process mesh's, the first step's collectives (ms
   and MB by kind), the bytes each position holds under fsdp beside the
   in-process ``{"data": 2}``, and peak memory a rank. (c) Each rank's K4 /
   K7 / K5 / K6 launches against PERF.md section 2's counts (6 a step a
   rank: under "model" one call over its H/2 heads; the ring runs no
   kernel), added to the kernels line. (d) One ``cli.dist_worker`` deploy
   of full-width ``flash_vit`` at ``{"fsdp": 2}`` through ``train_model``
   on CIFAR-100 files (B=128; the worker's loaders, as JAX's, take image
   sets): both ranks take 2 steps with equal losses, K4 = 2 x 6 x 2 (the
   ViT runs whole under FSDP's gathering checkpoint, its forward again in
   the backward) and K7 = 6 x 2, then refuse the first snapshot (a leaf
   sharded across the ranks, which JAX's ``device_get`` refuses too).
36. distributed_moe_pipe: MoE routing, the expert axis and pipelines
   across processes. Two ranks on the one card (this script's
   ``--moe-pipe-rank`` runner) join one gloo group once. Each layout
   runs on the ranks and, in each rank process, on the in-process mesh
   or pipeline of the same shape (``["cuda:0"] * 2``), which the rank
   holds itself against. (a) Full-width flash MoE GPT-2
   (``gpt2_small(moe_experts=8, backend="pallas")``: 12L/768d/12h,
   vocab 50257, 8 experts, top-2, B=4, S=1024) at ``{"data": 2}`` (the
   token gather crosses) and ``{"expert": 2}`` (the experts cross),
   one position a rank; (b) phase 28(D)'s float-input flash stack at
   full depth (dense 768, 12 ``flash_gpt_block(12)``, dense 64; 4
   microbatches of 2 x 1024) at ``{"pipe": 2}``, GPipe and interleaved
   (``virtual=2``). The FP32 gate (SGD at lr 1, 2 steps, K5 + K6, TF32
   off): both ranks' losses equal and each rank's parameters (every
   piece and stage it holds) and losses equal bit for bit to the
   in-process run's, each leaf's first update within 1e-3 of it; planted
   faults fail it: ``gather_sum`` where ``gather_keep`` belongs (MoE,
   ``{"data": 2}``) and a hop whose gradient is not returned (the
   pipeline). F8: one ``{"expert": 2}`` FP32 AdamW run with a binding
   ``grad_clip_norm``: the losses and each step's clip norm equal to the
   in-process run's on both ranks. bf16 AdamW, 2 steps a layout,
   reported: the loss gap to the in-process run (in this process after
   the ranks), the second step's CUDA-event time beside it, each
   collective's ms and MB a step, the bytes each position holds under
   ``"expert"`` beside ``"data"``, peak memory a rank. Each rank's K4 /
   K7 / K5 / K6 launches against PERF.md section 2's counts join the
   kernels line. (c) One ``cli.dist_worker`` deploy of
   ``cifar100_wrn16_8`` at ``{"pipe": 2}`` (flash_vit is no
   ``Sequential``, which neither package's partitioner splits): both
   ranks take 2 steps with equal losses, then refuse the first snapshot
   (the packed rows are sharded over "pipe" across the ranks).

``python3 chip_smoke.py --only serving_whole_prompt`` (any phase names,
comma-separated, without the ``phase_`` prefix) runs the device phase, the
build and those phases alone and prints no kernels line and no result.

The serving CLI runs of phases 5, 10, 15, 17, 18, 19 and 25 are queued
and started together before phase 31, which runs beside them
(``start_deferred_clis``, 9 at a time); after the last phase each is
checked and read by its phase's code (``finish_deferred_clis``).

Any failure raises and the script exits non-zero. Without a card, or
without the package beside it, it exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``; the one before it holds
the kernels' numbers as JSON.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,      # dense tensor-core rate
            "int8": 1979e12,         # dense int8 tensor-core rate
            "float32": 67e12}        # float32 outside the tensor cores
# kernel vs plain version, element by element:
#   |out - ref| <= atol + rtol * (|ref| + p.|v|),
# as (atol, rtol), where p.|v| is the plain version over |V|. Both sides
# round every p_j to the page dtype before the PV product (the kernel at its
# running max, the plain version after normalising), each within half an ulp
# (2^-8 relative in bf16), so their PV sums differ by at most 2^-7 p.|v|; the
# two roundings of the output add at most 2^-7 |ref|. f32 differs in
# summation order only.
TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 2 ** -7)}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# how often ``time_ms`` and ``per_token_profile`` profile a window that
# came back with no CUDA record (the profiler's loss, not the card's answer;
# three windows in a row came back empty once, K3's head8 in PR 24)
PROFILE_ATTEMPTS = 5


def time_ms(fn, iters: int = 50, warmup: int = 10):
    """Time of one ``fn()`` call: (device, events, per_name). ``device`` is
    the summed duration of the CUDA kernels ``torch.profiler`` records over
    ``iters`` calls, divided by ``iters``: the card's own time, without the
    host overhead between launches (None where the profiler records no
    device activity). ``events`` is CUDA-event time over ``iters`` calls
    after warm-up, which includes any host gap between them.

    The profiler can drop a kernel's record (one of three K5 launches at
    S=32,768 went missing once, which read as two thirds of its time), so
    ``device`` sums, per kernel name, the mean recorded duration times the
    launches a call makes, the name's records over ``iters`` rounded up;
    ``per_name`` maps each kernel name to its share of ``device``.

    The profiler has also once returned no device record at all for a
    whole window of 20 calls (a 512-row K3 call, which the same script
    profiled in full in the run before), so a window with none is
    profiled again, up to ``PROFILE_ATTEMPTS`` times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    events = t0.elapsed_time(t1) / iters
    by_name = {}
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name:
            break
    per_name = {n: sum(d) / len(d) * -(-len(d) // iters) / 1e3
                for n, d in by_name.items()}
    device = sum(per_name.values()) if per_name else None
    return device, events, per_name


# -- phase 1 ------------------------------------------------------------------

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[0] if smi else "",
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log("device", **info)
    return info


def build_kernels():
    """Build every kernel source at once: one nvcc per source, in parallel
    (each waits in its own subprocess). Meanwhile the CUDA context, cuBLAS
    and the profiler's device tracing start up, which would otherwise
    delay the first phase."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tnn_tpu_torch.ops import runtime

    names = sorted(p.stem for p in runtime.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        builds = [pool.submit(runtime.build, n) for n in names]
        host = pool.submit(timed_native_build)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            x = torch.ones(64, 64, device="cuda")
            (x @ x).sum().item()
        libs = [b.result() for b in builds]
        NATIVE_BUILD.update(host.result())
    log("build", seconds=round(time.perf_counter() - t0, 3),
        libraries=[str(x) for x in libs], native=NATIVE_BUILD)


# the native host runtime's build beside the kernels' (phase 30 reads it)
NATIVE_BUILD = {}


def timed_native_build():
    """``g++`` of the native runtime (``native.build_native``): its
    library and seconds."""
    from tnn_tpu_torch import native

    t0 = time.perf_counter()
    try:
        path = native.build_native()
    except (RuntimeError, OSError) as e:    # phase 30 fails on it
        return {"error": str(e)[-2000:]}
    return {"library": path, "seconds": time.perf_counter() - t0}


# -- phase 2 ------------------------------------------------------------------

def paged_case(seed, *, batch, q_lens, kv_lens, heads, kv_heads, head_dim,
               block_size, dtype, decode_form, holes=False, layers=12,
               layer=5):
    """Random pool pages + ragged block tables for one kernel call."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pages_per_row = [math.ceil(n / block_size) for n in kv_lens]
    nb = max(max(pages_per_row), 1)
    num_blocks = sum(pages_per_row) + 1 + 8
    perm = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((batch, nb), np.int32)   # scratch-padded, as the pool
    used = 0
    for i, n in enumerate(pages_per_row):
        tables[i, :n] = perm[used:used + n]
        used += n
        if holes and n > 2:
            tables[i, 1] = -1                  # a hole the kernel must skip
    dev = torch.device("cuda")
    shape = (layers, num_blocks, kv_heads, block_size, head_dim)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pages_k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pages_v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    qw = max(q_lens)
    q = torch.randn((batch, qw, heads, head_dim), generator=gen,
                    device=dev).to(dtype)
    args = dict(q=q[:, 0].contiguous() if decode_form else q,
                pages_k=pages_k, pages_v=pages_v,
                block_tables=torch.from_numpy(tables).to(dev),
                kv_lens=torch.tensor(kv_lens, dtype=torch.int32, device=dev),
                q_lens=None if decode_form else torch.tensor(
                    q_lens, dtype=torch.int32, device=dev),
                layer=layer)
    return args


def paged_work(args):
    """(bytes, operations) this call's data needs. Bytes: each live K/V
    position (below the row's kv_len, in no -1 hole) read once (int8 pages:
    one byte an element and a 4-byte scale per position and head), each
    live query token read and its output written once, the table entries
    the rows use and the lengths read once. Operations: the QK and PV
    products of every live query token with every live key it attends."""
    import numpy as np

    from tnn_tpu_torch.ops.paged_attention import QuantPages

    q, pk = args["q"], args["pages_k"]
    elem = q.element_size()
    quant = isinstance(pk, QuantPages)
    _, _, hkv, bs, dh = (pk.data if quant else pk).shape
    kv_row = dh + 4 if quant else dh * elem     # bytes per position, head
    h = q.shape[-2]
    kv = args["kv_lens"].tolist()
    ql = [1] * len(kv) if args["q_lens"] is None else args["q_lens"].tolist()
    live_kv = live_q = entries = keys = 0
    for row, n, m in zip(args["block_tables"].cpu().numpy(), kv, ql):
        used = row[:math.ceil(n / bs)]
        live = np.repeat(used >= 0, bs)[:n]
        seen = np.cumsum(live)   # live keys at or before each position
        live_kv += int(live.sum())
        live_q += m
        entries += len(used)
        keys += int(seen[n - m:n].sum())
    lens = len(kv) * (1 if args["q_lens"] is None else 2)
    nbytes = (live_kv * 2 * hkv * kv_row + live_q * 2 * h * dh * elem
              + 4 * (entries + lens))
    return nbytes, 4 * keys * h * dh


def paged_splits(args):
    """How many blocks share each row's table in this call
    (``plan_paged_splits`` on the call's shapes and the card's SMs)."""
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops import runtime

    q, pk = args["q"], args["pages_k"]
    hkv = (pk.data if isinstance(pk, pa.QuantPages) else pk).shape[2]
    return pa.plan_paged_splits(
        q.shape[0], 1 if q.ndim == 3 else q.shape[1], q.shape[-2], hkv,
        args["block_tables"].shape[1], runtime.sm_count(q.device))[0]


def sdpa_inputs(args):
    """The same attention as dense tensors for F.scaled_dot_product_attention:
    gathered contiguous K/V (B, H_kv, T, Dh) and a boolean mask."""
    import torch

    q, pk, pv = args["q"], args["pages_k"], args["pages_v"]
    layer, tables = args["layer"], args["block_tables"].long()
    qq = q[:, None] if q.ndim == 3 else q
    b, qw, h, dh = qq.shape
    _, _, hkv, bs, _ = pk.shape
    t = tables.shape[1] * bs
    k = pk[layer][tables.clamp_min(0)].transpose(1, 2).reshape(b, hkv, t, dh)
    v = pv[layer][tables.clamp_min(0)].transpose(1, 2).reshape(b, hkv, t, dh)
    kv = args["kv_lens"].long()
    ql = torch.ones_like(kv) if args["q_lens"] is None \
        else args["q_lens"].long()
    tpos = torch.arange(qw, device=q.device)
    kpos = torch.arange(t, device=q.device)
    mask = kpos[None, None, :] <= (kv - ql)[:, None, None] + tpos[None, :, None]
    mask = mask & (tables >= 0).repeat_interleave(bs, 1)[:, None, :]
    # rows with nothing to attend get one dummy key (their output is ignored)
    mask[..., 0] |= ~mask.any(-1)
    return (qq.transpose(1, 2).contiguous(), k.contiguous(), v.contiguous(),
            mask[:, None], h != hkv)


def paged_check(name, spec, args, phase="kernel"):
    """One K1 call against its plain version (the TOLERANCE note): logs
    the case and returns its max |error|; raises past the limit or on a
    row with no live query that is not exactly zero."""
    import torch

    from tnn_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    before = paged_attention.launches
    out = paged_attention(**args)
    torch.cuda.synchronize()
    if paged_attention.launches != before + 1:
        raise AssertionError(f"{name}: kernel did not launch")
    ref = paged_attention_reference(**args).float()
    ref_abs_v = paged_attention_reference(
        **{**args, "pages_v": args["pages_v"].abs()}).float()
    diff = (out.float() - ref).abs()
    atol, rtol = TOLERANCE[str(spec["dtype"]).split(".")[-1]]
    err = diff.max().item()
    # the largest share of its own limit any element uses (<= 1 passes)
    limit = atol + rtol * (ref.abs() + ref_abs_v)
    used = (diff / limit).max().item()
    # rows with no live query token must be exactly zero
    ql = spec["q_lens"]
    dead_nonzero = 0.0
    if not spec["decode_form"]:
        for bi, n in enumerate(ql):
            dead_nonzero = max(dead_nonzero,
                               out[bi, n:].float().abs().max().item()
                               if n < out.shape[1] else 0.0)
    for bi, n in enumerate(spec["kv_lens"]):
        if n == 0:
            dead_nonzero = max(dead_nonzero,
                               out[bi].float().abs().max().item())
    ok = math.isfinite(used) and used <= 1.0 and dead_nonzero == 0.0
    log(phase, case=name, splits=paged_splits(args), max_abs_err=err,
        atol=atol, rtol=rtol, limit_used=used,
        dead_rows_max=dead_nonzero, ok=ok)
    if not ok:
        raise AssertionError(
            f"paged_attention {name}: |err| exceeds {atol} + {rtol} "
            f"(|ref| + p.|v|) ({used:.3g} of the limit) or dead rows "
            f"{dead_nonzero}")
    return err


def paged_timing(args):
    """K1's device time on ``args`` beside the plain version's, SDPA's on
    the gathered K/V and the bound (bf16 rates)."""
    import torch.nn.functional as F

    from tnn_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    nbytes, ops = paged_work(args)
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[
        "bfloat16"])
    sq, sk, sv, smask, gqa = sdpa_inputs(args)
    runs = {"": lambda: paged_attention(**args),
            "plain_": lambda: paged_attention_reference(**args),
            "library_": lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=smask, enable_gqa=gqa)}
    timed = {"splits": paged_splits(args)}
    for prefix, fn in runs.items():
        device, events, per_name = time_ms(fn)
        # device time where the profiler saw the kernels, else events
        timed[prefix + "ms"] = events if device is None else device
        timed[prefix + "events_ms"] = events
        if prefix == "":   # the call's time by kernel
            timed["split_ms"] = {kernel_label(n): v
                                 for n, v in per_name.items()}
    timed.update(bound_ms=bound_ms, bytes=nbytes, ops=ops,
                 bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                 >= ops / PEAK_OPS["bfloat16"] else "operations")
    return timed


def phase_kernel(results):
    import torch

    from tnn_tpu_torch.ops.paged_attention import paged_attention

    bf16, f32 = torch.bfloat16, torch.float32
    rng_lens = [1000, 17, 512, 1, 333, 768, 64, 999]
    mixed_q = [64, 64, 40, 64, 1, 1, 1, 1]
    mixed_kv = [64, 448, 980, 704, 513, 100, 2, 1000]
    small = dict(heads=12, kv_heads=12, head_dim=64, block_size=16)
    cases = {
        "decode_bf16": dict(decode_form=True, q_lens=[1] * 8,
                            kv_lens=rng_lens, dtype=bf16, **small),
        "mixed_bf16": dict(decode_form=False, q_lens=mixed_q,
                           kv_lens=mixed_kv, dtype=bf16, **small),
        "decode_gqa4_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                 kv_lens=rng_lens, dtype=bf16, heads=12,
                                 kv_heads=4, head_dim=64, block_size=16),
        "mixed_gqa4_bf16": dict(decode_form=False, q_lens=mixed_q,
                                kv_lens=mixed_kv, dtype=bf16, heads=12,
                                kv_heads=4, head_dim=64, block_size=16),
        "holes_zero_len_bf16": dict(decode_form=False,
                                    q_lens=[64, 0, 1, 0, 30, 1, 64, 1],
                                    kv_lens=[300, 0, 200, 50, 90, 0, 64, 77],
                                    dtype=bf16, holes=True, **small),
        "decode_f32": dict(decode_form=True, q_lens=[1] * 8,
                           kv_lens=rng_lens, dtype=f32, **small),
        "decode_gqa4_f32": dict(decode_form=True, q_lens=[1] * 8,
                                kv_lens=rng_lens, dtype=f32, heads=12,
                                kv_heads=4, head_dim=64, block_size=16),
        "mixed_f32": dict(decode_form=False, q_lens=mixed_q,
                          kv_lens=mixed_kv, dtype=f32, holes=True, **small),
        "decode_hd128_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                  kv_lens=rng_lens, dtype=bf16, heads=6,
                                  kv_heads=6, head_dim=128, block_size=16),
        "mixed_hd128_f32": dict(decode_form=False, q_lens=mixed_q,
                                kv_lens=mixed_kv, dtype=f32, heads=6,
                                kv_heads=6, head_dim=128, block_size=16),
    }
    worst = 0.0
    for i, (name, spec) in enumerate(cases.items()):
        args = paged_case(100 + i, batch=8, **spec)
        worst = max(worst, paged_check(name, spec, args))

    # timing at the decode shape of the serving path (gpt2_small, B=8)
    timed = {}
    for name in ("decode_bf16", "mixed_bf16"):
        timed[name] = paged_timing(paged_case(7, batch=8, **cases[name]))
        log("kernel_time", case=name, **timed[name])
    paged_attention.launches = 0   # comparison launches do not count
    results["paged_attention"] = dict(max_abs_err=worst, **timed[
        "decode_bf16"])


# -- phase 3 ------------------------------------------------------------------
#
# K4 and K7 against their plain versions, element by element:
#   |got - ref| <= atol + rtol * (|ref| + mag),  (atol, rtol) as TOLERANCE,
# where mag is the same product taken over magnitudes. Forward O: mag =
# p.|v| (the plain forward over |V|): both sides round every p to the input
# dtype (the kernel at its running maximum, one 64-key tile at a time), each
# within 2^-8 relative in bf16, and round O. Backward: both sides recompute
# p from f32 logits that differ in summation order, so a rounding of p to
# bf16 may land one ulp (2^-7 relative) apart; dV = sum round(p) dO has mag
# = round(p)^T |dO|. ds = round(p (dP - delta) scale) may differ by one ulp
# of itself plus the f32 error of dP - delta, both within
# 2^-7 p scale (|dP| + |delta|) =: 2^-7 M, so dK and dQ have mag = M^T |Q|
# and M |K|; dQ's atomicAdd order changes only f32 roundings. GQA sums the
# per-head magnitudes too. The logsumexp is f32 on both sides: within
# 1e-5 + 1e-6 |ref|, and +inf on exactly the same rows, whose O and dQ are
# exactly 0.
LSE_TOL = (1e-5, 1e-6)


def flash_case(seed, *, b, h, hkv, sq, skv, d, dtype, causal, kv_offset=0,
               mask_groups=None):
    """Random inputs of one flash-attention call on the card, with the
    grouped int8 mask (one fully masked row) where ``mask_groups`` is
    "1", "B" or "BH"."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    mask = None
    if mask_groups is not None:
        shape = {"1": (1, 1, sq, skv), "B": (b, 1, sq, skv),
                 "BH": (b, h, sq, skv)}[mask_groups]
        full = torch.rand(shape, generator=gen, device=dev) > 0.25
        full[0, 0, 5] = False                    # a row with no live key
        mask = fa.norm_mask(full, b, h, sq, skv)
    return dict(q=randn(b, h, sq, d), k=randn(b, hkv, skv, d),
                v=randn(b, hkv, skv, d), do=randn(b, h, sq, d), mask=mask,
                causal=causal, kv_offset=kv_offset)


def flash_work(args):
    """(bytes, operations) of K4 and of K7 on these inputs. Bytes: each
    input read once and each output written once (forward: q, k, v, the
    mask, O and the f32 logsumexp; backward: q, k, v, O, dO, the
    logsumexp and the mask, then dQ, dK, dV). Operations: 2 D per product
    per live (query, key) pair of this run's mask, 2 products forward (QK,
    PV) and 5 backward."""
    from tnn_tpu_torch.ops import flash_attention as fa

    q, k = args["q"], args["k"]
    elem = q.element_size()
    pairs = int(fa._live(q, k, args["mask"], args["kv_offset"],
                         args["causal"]).sum())
    rows = q.shape[0] * q.shape[1] * q.shape[2]
    mask = 0 if args["mask"] is None else args["mask"].numel()
    qo, kv = q.numel() * elem, k.numel() * elem
    fwd = (2 * qo + 2 * kv + 4 * rows + mask, 4 * q.shape[-1] * pairs)
    bwd = (3 * qo + 2 * kv + 4 * rows + mask + qo + 2 * kv,
           10 * q.shape[-1] * pairs)
    return fwd, bwd


def backward_magnitudes(q, k, v, o, lse, do, *, causal, mask, kv_offset):
    """M^T |Q|, M |K| and round(p)^T |dO| (see the tolerance note)."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    scale = fa._scale(q, None)
    s, _ = fa._logits(q, k, mask, kv_offset, causal, scale)
    p = torch.exp(s - lse[..., None])
    del s
    g = q.shape[1] // k.shape[1]
    do32 = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do32,
                      v.repeat_interleave(g, dim=1).float())
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    m = p * scale * (dp.abs() + delta.abs())
    del dp
    mag_dq = torch.einsum("bhqk,bhkd->bhqd", m,
                          k.repeat_interleave(g, dim=1).float().abs())
    mag_dk = torch.einsum("bhqk,bhqd->bhkd", m, q.float().abs())
    mag_dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(),
                          do32.abs())
    b, h, skv, d = mag_dk.shape
    hkv = k.shape[1]
    mag_dk, mag_dv = (x.reshape(b, hkv, g, skv, d).sum(2)
                      for x in (mag_dk, mag_dv))
    return mag_dq, mag_dk, mag_dv


def _limit_used(got, ref, mag, dtype):
    atol, rtol = TOLERANCE[dtype]
    diff = (got.float() - ref.float()).abs()
    limit = atol + rtol * (ref.float().abs() + mag)
    return diff.max().item(), (diff / limit).max().item()


def flash_check(name, args):
    """One case: K4 and K7 once each, held against the plain versions."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    kw = dict(causal=args["causal"], mask=args["mask"],
              kv_offset=args["kv_offset"])
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    if (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) \
            != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"flash {name}: a kernel did not launch")
    dtype = str(q.dtype).split(".")[-1]
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
    mag_o = fa.flash_attention_reference(q, k, v.abs(), **kw)[0].float()
    errs = {"o": _limit_used(o, ref, mag_o, dtype)}
    del mag_o
    refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    mags = backward_magnitudes(q, k, v, o, lse, do, **kw)
    for gname, got, r, mag in zip(("dq", "dk", "dv"), grads, refs, mags):
        errs[gname] = _limit_used(got, r, mag, dtype)
    del refs, mags
    dead = torch.isinf(ref_lse)
    same_dead = bool(torch.equal(torch.isinf(lse), dead)
                     and (lse[dead] > 0).all())
    live_lse = (lse[~dead] - ref_lse[~dead]).abs()
    lse_used = (live_lse / (LSE_TOL[0] + LSE_TOL[1]
                            * ref_lse[~dead].abs())).max().item()
    dead_nonzero = max(o[dead].float().abs().max().item(),
                       grads[0][dead].float().abs().max().item()) \
        if dead.any() else 0.0
    worst = max(u for _, u in errs.values())
    ok = (math.isfinite(worst) and worst <= 1.0 and lse_used <= 1.0
          and same_dead and dead_nonzero == 0.0)
    log("flash", case=name, dtype=dtype, shape=list(q.shape),
        kv_heads=k.shape[1], skv=k.shape[2], causal=args["causal"],
        kv_offset=args["kv_offset"],
        mask_groups=None if args["mask"] is None else args["mask"].shape[0],
        **{f"{n}_max_abs_err": e for n, (e, _) in errs.items()},
        **{f"{n}_limit_used": u for n, (_, u) in errs.items()},
        lse_limit_used=lse_used, dead_rows=int(dead.sum()),
        dead_rows_max=dead_nonzero, ok=ok)
    if not ok:
        raise AssertionError(f"flash {name}: kernel vs plain outside the "
                             f"stated limit ({errs}, lse {lse_used}, dead "
                             f"rows {same_dead} / {dead_nonzero})")
    return errs["o"][0], max(errs[n][0] for n in ("dq", "dk", "dv"))


def flash_cases():
    """The flash cases: gpt2_small's training shape (B=8, H=12, S=1024,
    D=64) and its variants, flash_vit's (B=128, H=6, S=65, D=64) and
    flash_vit's under cli.dist_worker (S=17)."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    train = dict(b=8, h=12, hkv=12, sq=1024, skv=1024, d=64)
    return {
        "train_bf16": dict(train, dtype=bf16, causal=True),
        "noncausal_bf16": dict(train, dtype=bf16, causal=False),
        "gqa12_4_bf16": dict(train, hkv=4, dtype=bf16, causal=True),
        "hd128_6h_bf16": dict(train, h=6, hkv=6, d=128, dtype=bf16,
                              causal=True),
        "ragged1000_bf16": dict(train, sq=1000, skv=1000, dtype=bf16,
                                causal=True),
        "mask_g1_bf16": dict(train, b=4, dtype=bf16, causal=True,
                             mask_groups="1"),
        "mask_gB_bf16": dict(train, b=4, dtype=bf16, causal=False,
                             mask_groups="B"),
        "mask_gBH_bf16": dict(train, b=4, dtype=bf16, causal=True,
                              mask_groups="BH"),
        "offset_sq1_bf16": dict(train, sq=1, dtype=bf16, causal=True,
                                kv_offset=700),
        "offset_sq64_bf16": dict(train, sq=64, dtype=bf16, causal=True,
                                 kv_offset=960),
        "train_f32": dict(train, dtype=f32, causal=True),
        "noncausal_f32": dict(train, dtype=f32, causal=False),
        "gqa12_4_f32": dict(train, hkv=4, dtype=f32, causal=True),
        # flash_vit's attention: 64 patches and the class token, one partial
        # key tile in bf16 (128 keys) and two in f32 (64 keys)
        "vit_bf16": dict(b=128, h=6, hkv=6, sq=65, skv=65, d=64, dtype=bf16,
                         causal=False),
        "vit_f32": dict(b=128, h=6, hkv=6, sq=65, skv=65, d=64, dtype=f32,
                        causal=False),
        # flash_vit under cli.dist_worker's 32 x 32 synthetic images: 16
        # patches and the class token
        "dist_vit_bf16": dict(b=128, h=6, hkv=6, sq=17, skv=17, d=64,
                              dtype=bf16, causal=False),
        "dist_vit_f32": dict(b=128, h=6, hkv=6, sq=17, skv=17, d=64,
                             dtype=f32, causal=False),
    }


# the kernels of one backward call (K7, K5 or K6), by a part of their names:
# the delta pre-pass, the body (every "flash_bwd" kernel: the tensor-core
# one in bf16), dq_acc's zero-fill (K7), the GQA group sum of dK / dV (K7,
# K6; none where H = H_kv) and the copies that cast dQ (K7) and, under GQA,
# the group sum's operands
BWD_PARTS = (("flash_delta_kernel", "delta"), ("FillFunctor", "zero_fill"),
             ("reduce_kernel", "group_sum"), ("copy", "cast"))


def bwd_parts(per_name, body):
    """{part: ms per call} of a backward call's kernels, its body's time
    under ``body``."""
    parts = {}
    for name, ms in per_name.items():
        part = body if "flash_bwd" in name else next(
            (p for key, p in BWD_PARTS if key in name), name[:80])
        parts[part] = parts.get(part, 0.0) + ms
    return parts


def kernel_label(name):
    """A CUDA kernel's profiler name without its return type, namespace
    and arguments: ``flash_bwd_wgmma_kernel<64, false>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name[5:].split("(")[0] if name.startswith("void ") else \
        name.split("(")[0]


def phase_flash(results):
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    cases = flash_cases()
    worst_fwd = worst_bwd = 0.0
    for i, (name, spec) in enumerate(cases.items()):
        args = flash_case(200 + i, **spec)
        e_fwd, e_bwd = flash_check(name, args)
        worst_fwd, worst_bwd = max(worst_fwd, e_fwd), max(worst_bwd, e_bwd)
        del args
        torch.cuda.empty_cache()

    # times at the training shape (B=8, H=12, S=1024, D=64, bf16, causal),
    # the kernels line's, and at flash_vit's (B=128, H=6, S=65, non-causal)
    for case in ("train_bf16", "vit_bf16"):
        args = flash_case(7, **cases[case])
        for name, timed in flash_times(case, args, results["card"]).items():
            if case == "train_bf16":
                results[name] = dict(timed, max_abs_err=worst_fwd
                                     if name.endswith("fwd") else worst_bwd)
        del args
        torch.cuda.empty_cache()
    # comparison launches do not count
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0


def flash_times(case, args, card):
    """K4's and K7's times on one case's inputs beside the plain versions',
    SDPA's and the bound, each logged as a ``flash_time`` line; returns
    them by kernel."""
    import torch
    import torch.nn.functional as F

    from tnn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    causal = args["causal"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops) = flash_work(args)
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
    runs = {
        "flash_attention_fwd": (fwd_bytes, fwd_ops, {
            "": lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
            "plain_": lambda: fa.flash_attention_reference(q, k, v,
                                                           causal=causal),
            "library_": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)}),
        "flash_attention_bwd": (bwd_bytes, bwd_ops, {
            "": lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal),
            "plain_": lambda: fa.flash_attention_backward_reference(
                q, k, v, o, lse, do, causal=causal),
            "library_": lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), do, retain_graph=True)}),
    }
    out = {}
    for name, (nbytes, ops, fns) in runs.items():
        timed = {}
        for prefix, fn in fns.items():
            device, events, per_name = time_ms(fn, iters=20, warmup=3)
            timed[prefix + "ms"] = events if device is None else device
            timed[prefix + "events_ms"] = events
            if prefix == "" and name.endswith("bwd"):
                timed["split_ms"] = bwd_parts(per_name, "k7")
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        op_ms = 1e3 * ops / PEAK_OPS["bfloat16"]
        timed.update(bound_ms=max(byte_ms, op_ms), bytes=nbytes, ops=ops,
                     bound_by="bytes" if byte_ms >= op_ms else "operations")
        log("flash_time", kernel=name, case=case, shape=list(q.shape),
            causal=causal, card=card, **timed)
        out[name] = timed
    return out


# -- phase 4 ------------------------------------------------------------------

def mixed_logits_check(model, seed, tol, gate=True):
    """One ragged mixed step (prompt chunks beside decode rows over earlier
    KV) through ``GPT2.apply_paged`` with the kernel, then the same forward
    with the plain attention function on the same pages; returns the max
    |logit difference| over live positions and fails past ``tol`` of the
    largest logit. ``gate=False`` only reports it, with the share of live
    positions within ``tol`` (a MoE model in bf16: a rounding that moves a
    token's top-2 experts moves its logits by far more than a rounding)."""
    import numpy as np
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving.kv_pool import PagedKVPool

    dev = model.device
    bs, b, qw = 16, 8, 64
    starts = np.array([0, 0, 130, 700, 37, 512, 999, 3], np.int32)
    q_lens = np.array([64, 17, 64, 40, 1, 1, 1, 0], np.int32)
    pool = PagedKVPool(model.num_layers, model.num_kv_heads,
                       model.d_model // model.num_heads, 600, bs,
                       model.policy.compute_dtype, dev)
    nb = pool.blocks_for(model.max_len)
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        blocks = pool.alloc(pool.blocks_for(starts[i] + q_lens[i]))
        tables[i, :len(blocks)] = blocks
    gen = torch.Generator(device=dev).manual_seed(seed)
    for pages in (pool.pages_k, pool.pages_v):   # the rows' earlier KV
        pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, model.vocab_size, (b, qw),
                                         dtype=np.int32)).to(dev)
    args = [torch.from_numpy(x).to(dev) for x in (tables, starts, q_lens)]
    saved = (pool.pages_k.clone(), pool.pages_v.clone())
    with torch.no_grad():
        before = pa.paged_attention.launches
        kern = model.apply_paged(toks, pool.pages_k, pool.pages_v, *args)
        if pa.paged_attention.launches != before + model.num_layers:
            raise AssertionError("mixed step did not run the kernel per layer")
        pool.pages_k.copy_(saved[0])
        pool.pages_v.copy_(saved[1])
        kernel_fn = pa.paged_attention
        pa.paged_attention = pa.paged_attention_reference
        try:
            plain = model.apply_paged(toks, pool.pages_k, pool.pages_v, *args)
        finally:
            pa.paged_attention = kernel_fn
    live = torch.arange(qw, device=dev)[None, :] < args[2][:, None]
    err = (kern - plain).abs()[live]
    diff = err.max().item()
    scale = plain[live].abs().max().item()
    ok = math.isfinite(diff) and diff <= tol * scale
    within = (err <= tol * scale).all(dim=-1).float().mean().item()
    log("serving_logits", policy=model.policy.compute,
        moe_experts=getattr(model, "moe_experts", 0), max_abs_err=diff,
        max_abs_logit=scale, tolerance=tol * scale,
        share_of_positions_within=within, gated=gate,
        ok=ok if gate else None)
    if gate and not ok:
        raise AssertionError(f"mixed-step logits kernel vs plain: {diff} > "
                             f"{tol * scale}")


def serve_traffic(model, seed, num_requests=8, new_tokens=64,
                  eager_steps=False, **engine_kw):
    """One engine run over the smoke traffic, through the overlapped loop
    when ``engine_kw`` turns it on; returns (engine, rids).
    ``eager_steps`` runs pdecode steps eagerly instead of replaying their
    graph."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, num_blocks=512, block_size=16,
                             max_batch_size=8, chunk_size=64, seed=seed,
                             device=model.device, **engine_kw)
    engine._eager_steps = eager_steps
    rng = np.random.default_rng(seed)
    rids = []
    for i in range(num_requests):
        prompt = rng.integers(0, model.vocab_size, int(rng.integers(16, 769)))
        sampled = i % 2 == 1
        rids.append(engine.submit(
            prompt, new_tokens, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 0.0))
    engine.run_until_complete()
    return engine, rids


def steady_decode_engine(model, new_tokens, batch=8, prompts=None,
                         eager_steps=False, **engine_kw):
    """An engine with ``batch`` requests (``prompts``, or 500 random
    tokens each), past their prefill and first decode step, with
    ``new_tokens`` tokens each to decode."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, num_blocks=512, block_size=16,
                             max_batch_size=batch, chunk_size=64, seed=0,
                             device=model.device, **engine_kw)
    engine._eager_steps = eager_steps
    rng = np.random.default_rng(5)
    for i in range(batch):
        engine.submit(rng.integers(0, model.vocab_size, 500)
                      if prompts is None else prompts[i], new_tokens)
    while any(r.cache_len < r.prefill_len or not r.out_tokens
              for r in engine.requests.values()):
        engine.step()
    engine.step()
    return engine


def drive_step(engine):
    """One turn of the engine's drive loop: with ``overlap`` the
    overlapped loop's begin (unless a speculative step was adopted),
    speculate, deferred work, finish; else one synchronous step. Returns
    the committed step's events."""
    if not engine.overlap:
        return engine.step()
    if engine.in_flight is None:
        engine.begin_step()
    engine.try_speculate()
    engine.run_deferred()
    return engine.finish_step()


def profile_window(engine, steps):
    """``steps`` drive turns under the profiler: device-busy time per
    step (summed kernel durations, graph replays' kernels included), the
    kernels that take the most device time, the outermost aten ops and
    the kernels per step, the ops that take the most host self time, and
    the window's own wall time per step (slowed by the profiler)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            drive_step(engine)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = collections.Counter()
    host_self = collections.Counter()   # profiled host self time, us
    ops = kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            kernels += 1
            continue
        host_self[e.name[:40]] += e.self_cpu_time_total
        parent = e.cpu_parent
        ops += e.name.startswith("aten::") and not (
            parent is not None and parent.name.startswith("aten::"))
    return dict(
        device_busy_ms=sum(by_name.values()) / 1e3 / steps,
        aten_ops_per_step=ops / steps, kernels_per_step=kernels / steps,
        profiled_step_ms=profiled_ms,
        top_kernels_ms=[(n, t / 1e3 / steps)
                        for n, t in by_name.most_common(6)],
        top_host_self_ms=[(n, t / 1e3 / steps)
                          for n, t in host_self.most_common(8)])


def profile_decode_steps(model, steps=10, phase="serving_profile",
                         batch=8, prompts=None, new_tokens=None,
                         **engine_kw):
    """Steady decode steps of ``batch`` rows (driven by ``drive_step``, so
    an engine with ``overlap`` runs the overlapped loop): wall time per
    step without the profiler in three windows of ``steps`` steps (their
    median is the step time; their spread is the host's within one
    process), then ``profile_window`` over as many further steps. Idle
    share = 1 - busy / unprofiled step time: the profiler slows the host,
    so its own window's wall time is printed but not used. ``prompts`` and
    ``new_tokens`` (default 4 x steps + 8) set the requests; tokens per
    step counts what the steps emitted (more than the rows where
    speculative decoding accepts)."""
    import torch

    engine = steady_decode_engine(model, new_tokens or 4 * steps + 8, batch,
                                  prompts, **engine_kw)
    windows = []
    emitted = 0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            emitted += len(drive_step(engine)["tokens"])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / steps)
    step_ms = sorted(windows)[1]
    prof = profile_window(engine, steps)
    # host cost per op: the unprofiled step over the step's outermost
    # aten ops, which is what a path with more ops pays more of
    log(phase, decode_rows=batch,
        kv_len=500 if prompts is None else len(prompts[0]), step_ms=step_ms,
        tokens_per_step=emitted / (3 * steps),
        step_ms_windows=windows, profiled_step_ms=prof["profiled_step_ms"],
        device_busy_ms=prof["device_busy_ms"],
        idle_share=1.0 - prof["device_busy_ms"] / step_ms,
        aten_ops_per_step=prof["aten_ops_per_step"],
        kernels_per_step=prof["kernels_per_step"],
        step_us_per_op=step_ms * 1e3 / max(prof["aten_ops_per_step"], 1),
        top_kernels_ms=prof["top_kernels_ms"],
        top_host_self_ms=prof["top_host_self_ms"],
        program_steps=engine.stats()["program_steps"])


def host_ab(model, rounds=4, steps=5, launches=2000,
            phase="serving_int8_host_ab", paths=None, abba=False, spare=0):
    """Two decode paths' steady steps timed in alternating windows of
    ``steps`` steps (default: the bf16 path, then int8 pool and weights;
    ``abba`` reverses the order every other round), each round also
    timing ``launches`` back-to-back tiny kernel launches (the host's
    cost per launch at that moment), and one last round with Python's
    garbage collector off. If the second/first ratio holds while all
    three move together, the host's speed varies and each path pays for
    it per op; a ratio that moves alone is the second path's own. Steps
    are ``drive_step`` turns; ``spare`` more tokens a request leave the
    engines that many steady steps after the windows. Returns the
    engines and the rounds."""
    import gc

    import torch

    n = rounds + 1
    paths = paths or {"bf16": {}, "int8": INT8_SERVING}
    engines = {name: steady_decode_engine(model, n * steps + 8 + spare,
                                          **kw)
               for name, kw in paths.items()}
    first, second = paths
    probe = torch.zeros(1024, device=model.device)

    def window(fn, count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / count

    rows = []
    for r in range(n):
        if r == rounds:
            gc.disable()
        try:
            row = {"launch_us": window(lambda: probe.add_(1),
                                       launches) * 1e6}
            order = list(engines.items())
            if abba and r % 2:
                order.reverse()
            for name, eng in order:
                row[f"{name}_ms"] = window(lambda: drive_step(eng),
                                           steps) * 1e3
        finally:
            gc.enable()
        row["ratio"] = row[f"{second}_ms"] / row[f"{first}_ms"]
        rows.append(row)
    log(phase, steps_per_window=steps,
        launches_per_window=launches, rounds=rows[:rounds],
        gc_off=rows[rounds])
    return engines, rows


def phase_serving(results):
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops.paged_attention import paged_attention
    from tnn_tpu_torch.serving.scheduler import RequestState

    t0 = time.perf_counter()
    model = zoo.create("gpt2_small", device="cuda", seed=0)
    log("model", name="gpt2_small", policy=model.policy.compute,
        params=sum(p.numel() for p in model.parameters()),
        init_s=round(time.perf_counter() - t0, 3))
    serve_traffic(model, seed=1, num_requests=2, new_tokens=4)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    engine, rids = serve_traffic(model, seed=0)
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    stats = engine.stats()
    finished = [engine.result(r) for r in rids]
    bad = [r.rid for r in finished if r.state is not RequestState.FINISHED
           or len(r.out_tokens) != 64]
    expected = model.num_layers * engine.model_steps
    log("serving", requests=len(rids), finished=len(rids) - len(bad),
        kernel_launches=launches, model_steps=engine.model_steps,
        expected_launches=expected, wall_s=wall,
        ttft_ms_p50=stats["ttft_ms_p50"], ttft_ms_p95=stats["ttft_ms_p95"],
        decode_tok_per_s=stats["tok_per_s"],
        step_ms_mean=stats["step_latency_ms_mean"],
        steps=stats["steps"], preemptions=stats["preemptions"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if bad:
        raise AssertionError(f"requests not FINISHED with 64 tokens: {bad}")
    if launches != expected or launches == 0:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected num_layers x model steps = {expected}")
    results["launches"] = launches
    engine.check_invariants()

    # greedy decoding is deterministic: a second run gives the same tokens
    engine2, rids2 = serve_traffic(model, seed=0)
    greedy = [(a, b) for i, (a, b) in enumerate(zip(rids, rids2))
              if i % 2 == 0]
    same = all(engine.result(a).out_tokens == engine2.result(b).out_tokens
               for a, b in greedy)
    log("serving_repeat", greedy_requests=len(greedy), identical=same)
    if not same:
        raise AssertionError("two greedy runs gave different tokens")

    profile_decode_steps(model)
    mixed_logits_check(model, seed=3, tol=3e-2)
    del engine, engine2, model
    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    mixed_logits_check(fp32, seed=4, tol=1e-4)
    del fp32
    torch.cuda.empty_cache()


# -- phase 5 ------------------------------------------------------------------

CLI_LINES = [{"id": "greedy", "tokens": [464, 3616, 286, 1204, 318],
              "max_new_tokens": 8},
             {"id": "sampled", "tokens": list(range(100, 140)),
              "max_new_tokens": 6, "temperature": 0.8, "top_k": 50,
              "top_p": 0.95}]


# The serving CLI runs are queued where their phase asks for them and made
# together near the end of the run (``start_deferred_clis``, CLI_WORKERS at
# a time, beside the last phase): each process spends seconds
# reaching the card, and one after another they took a fifth of the run.
# Their checks, and each phase's own reading of the output (``then``), run
# after the last phase in queue order (``finish_deferred_clis``). All nine
# run at once: eight at a time left the ninth alone for a third of the
# wait.
CLI_WORKERS = 9
_DEFERRED_CLIS = []


def cli_check(flags=(), lines=CLI_LINES, then=None):
    """Queue the serving CLI on two JSON lines (ids "greedy" and
    "sampled", 8 and 6 new tokens), with ``flags`` added; ``then(proc)``
    reads the finished process."""
    _DEFERRED_CLIS.append((tuple(flags), list(lines), then))


def _cli_run(flags, lines):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_small", *flags],
        input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=600)
    return proc, time.perf_counter() - t0


def start_deferred_clis():
    """Start every queued CLI run, CLI_WORKERS at a time, on a pool of
    threads; ``finish_deferred_clis`` waits for them. The runs print
    nothing until then."""
    from concurrent.futures import ThreadPoolExecutor

    queue = list(_DEFERRED_CLIS)
    _DEFERRED_CLIS.clear()
    pool = ThreadPoolExecutor(max_workers=CLI_WORKERS)
    return queue, pool, [pool.submit(_cli_run, q[0], q[1]) for q in queue]


def finish_deferred_clis(started):
    """Wait for the runs ``start_deferred_clis`` started, then make each
    one's checks and ``then`` in queue order."""
    queue, pool, futures = started
    runs = [f.result() for f in futures]
    pool.shutdown()
    for (flags, _, then), (proc, seconds) in zip(queue, runs):
        events = [json.loads(x) for x in proc.stdout.splitlines()
                  if x.strip()]
        done = {e["id"]: e for e in events if e.get("event") == "done"}
        ok = (proc.returncode == 0 and set(done) == {"greedy", "sampled"}
              and len(done["greedy"]["tokens"]) == 8
              and len(done["sampled"]["tokens"]) == 6)
        log("cli", flags=list(flags), returncode=proc.returncode,
            done_events=len(done),
            token_events=sum(e.get("event") == "token" for e in events),
            seconds=round(seconds, 3), concurrent=min(len(queue),
                                                      CLI_WORKERS), ok=ok)
        if not ok:
            raise AssertionError(
                f"CLI run failed: rc {proc.returncode}\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        if then is not None:
            then(proc)


def phase_cli(results):
    cli_check()


# -- phase 6 ------------------------------------------------------------------

TRAIN_STEPS = 30
EVAL_STEPS = 10     # the trainer's held-out pass: 10 batches
TRAIN_ARGS = dict(batch=8, seq=1024, layers=12, d_model=768, heads=12)
# phases 28, 29 and 35's GPT-2 runs: TRAIN_ARGS' widths at half the depth,
# so the script stays within its time limit beside phase 36
PAR_LAYERS = 6
# one step with the kernels against the same step with the plain versions,
# from the same weights and batch (AdamW, lr 3e-4, no schedule): the loss
# within `loss` relative, and the parameter update (new - old over every
# parameter but the key bias, whose gradient is zero but for rounding and
# which Adam scales up to +-lr) with a cosine above `cos` to the plain one.
# Adam's first update is g / (|g| + eps) per element, so elements whose
# gradient is at rounding level flip sign; FP32 differs only in summation
# order, bf16 also in where p and ds are rounded.
STEP_TOLERANCE = {"float32": dict(loss=1e-5, cos=0.999),
                  "bfloat16": dict(loss=1e-3, cos=0.99)}
PEAK_BF16 = PEAK_OPS["bfloat16"]


def synthetic_corpus(path, vocab=50257, n_train=2_000_000, n_val=200_000,
                     seed=0):
    """uint16 tokens below ``vocab`` with structure to learn: one seeded
    256-token segment repeated, 10% of positions replaced by noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    segment = rng.integers(0, vocab, 256)

    def stream(n):
        toks = np.tile(segment, n // 256 + 1)[:n]
        noise = rng.random(n) < 0.1
        toks[noise] = rng.integers(0, vocab, int(noise.sum()))
        return toks.astype(np.uint16)

    stream(n_train).tofile(path / "train.bin")
    stream(n_val).tofile(path / "val.bin")
    (path / "meta.json").write_text(json.dumps({
        "mode": "synthetic", "vocab_size": vocab, "files": 0,
        "train_tokens": n_train, "val_tokens": n_val}))


def model_flops_per_step(layers, d_model, vocab, batch, seq):
    """6 x (weights in matmuls, the tied head included: 12 L d^2 + V d) per
    token, plus causal attention 6 L S d per token (QK and PV over S/2 keys
    on average, forward and the backward's twice as much)."""
    n = 12 * layers * d_model ** 2 + vocab * d_model
    return (6 * n + 6 * layers * seq * d_model) * batch * seq


def _flash_gpt2_small(policy=None, layers=None):
    """Seeded full-width flash_gpt2_small on the card (``layers`` of its
    blocks, by default all 12)."""
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.models.gpt2 import GPT2

    if layers is None:
        return zoo.create("flash_gpt2_small", device="cuda", seed=0,
                          policy=policy)
    return GPT2(num_layers=layers, d_model=TRAIN_ARGS["d_model"],
                num_heads=TRAIN_ARGS["heads"], backend="pallas",
                device="cuda", seed=0, policy=policy)


def _fresh_step(model):
    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.train import create_train_state, make_train_step

    opt = AdamW(lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)
    return create_train_state(model, opt), make_train_step(model, opt)


def _batch(loader, rng):
    import torch

    d, l = loader.random_windows(TRAIN_ARGS["batch"], rng)
    return (torch.from_numpy(d).cuda().long(),
            torch.from_numpy(l).cuda().long())


def step_kernel_vs_plain(model, loader):
    """One train step of ``model`` with K4/K7, then the same step with the
    plain versions swapped into the autograd Function, from the same
    weights."""
    import numpy as np
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    policy = model.policy
    state, step = _fresh_step(model)
    x, y = _batch(loader, np.random.default_rng(3))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, m = step(state, x, y)
    loss_k = float(m["loss"])
    kern = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    state, step = _fresh_step(model)
    saved = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_reference
    fa.flash_attention_bwd = fa.flash_attention_backward_reference
    try:
        _, m = step(state, x, y)
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved
    loss_p = float(m["loss"])
    d = model.d_model
    dk, dp = [], []
    for n, p in model.named_parameters():
        a, b = kern[n] - start[n], p.detach() - start[n]
        if n.endswith("qkv_bias"):
            a, b = torch.cat([a[:d], a[2 * d:]]), torch.cat([b[:d], b[2 * d:]])
        dk.append(a.flatten())
        dp.append(b.flatten())
    dk, dp = torch.cat(dk).double(), torch.cat(dp).double()
    cos = float(dk @ dp / (dk.norm() * dp.norm()))
    tol = STEP_TOLERANCE[policy.compute]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = math.isfinite(loss_k) and rel <= tol["loss"] and cos > tol["cos"]
    log("train_step_vs_plain", policy=policy.compute, loss_kernel=loss_k,
        loss_plain=loss_p, loss_rel_diff=rel, update_cosine=cos,
        update_norm=float(dk.norm()), tolerance=tol, ok=ok)
    del model, state, step, start, kern
    if not ok:
        raise AssertionError(f"{policy.compute} train step kernel vs plain: "
                             f"loss rel {rel}, update cosine {cos}")


class StepRecorder:
    """Wraps the trainer's step function: keeps every step's loss (on the
    device), CUDA events around the steady steps ``timed`` and a profiler
    window over the steps ``profiled`` (after the timed ones: the profiler
    slows the host; no window where the range is empty)."""

    def __init__(self, timed=range(10, 20), profiled=range(22, 24)):
        self.timed, self.profiled = timed, profiled
        self.losses, self.events, self.prof = [], [], None

    def wrap(self, make_train_step):
        def make(*a, **kw):
            step = make_train_step(*a, **kw)

            def run(state, x, y):
                import torch
                from torch.profiler import ProfilerActivity, profile

                i = len(self.losses)
                if self.profiled and i == self.profiled.start:
                    torch.cuda.synchronize()
                    self.prof = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                    self.prof.start()
                if i in self.timed:
                    self.events.append(torch.cuda.Event(enable_timing=True))
                    self.events[-1].record()
                state, m = step(state, x, y)
                self.losses.append(m["loss"])
                if i == self.timed[-1]:
                    self.events.append(torch.cuda.Event(enable_timing=True))
                    self.events[-1].record()
                if self.profiled and i == self.profiled[-1]:
                    torch.cuda.synchronize()
                    self.prof.stop()
                return state, m
            return run
        return make

    def step_ms(self):
        return self.events[0].elapsed_time(self.events[-1]) / len(self.timed)

    def kernel_labels(self):
        """The labels (``kernel_label``) of the profiled kernels."""
        import torch

        return sorted({kernel_label(e.name) for e in self.prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA})

    def device_ms(self):
        """Summed kernel durations per profiled step, by kernel name."""
        import collections

        import torch

        by_name = collections.Counter()
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name[:60]] += e.time_range.elapsed_us()
        n = len(self.profiled)
        return {k: v / 1e3 / n for k, v in by_name.items()}


def phase_training(results):
    import contextlib
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from tnn_tpu_torch.cli import train_gpt2
    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.data.token_stream import TokenStreamDataLoader
    from tnn_tpu_torch.ops import flash_attention as fa

    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        corpus.mkdir()
        synthetic_corpus(corpus)
        rec = StepRecorder()
        real_make = train_gpt2.make_train_step

        argv = ["--tokens", str(corpus), "--steps", str(TRAIN_STEPS),
                "--backend", "pallas", "--sample", "0",
                "--results", str(Path(tmp) / "results")]
        for key, value in TRAIN_ARGS.items():
            argv += [f"--{key.replace('_', '-')}", str(value)]
        train_gpt2.make_train_step = rec.wrap(real_make)
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        fa.flash_attention_bwd_dq.launches = 0
        fa.flash_attention_bwd_dkv.launches = 0
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):   # its progress
                out = train_gpt2.main(argv)
            wall = time.perf_counter() - t0
        finally:
            train_gpt2.make_train_step = real_make
        fwd, bwd = fa.flash_attention_fwd.launches, \
            fa.flash_attention_bwd.launches
        split = (fa.flash_attention_bwd_dq.launches,
                 fa.flash_attention_bwd_dkv.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [float(x) for x in rec.losses]
        layers = TRAIN_ARGS["layers"]
        want = (layers * (TRAIN_STEPS + EVAL_STEPS), layers * TRAIN_STEPS)
        finite = all(math.isfinite(x) for x in losses)
        falling = float(np.mean(losses[-5:])) < losses[0]
        # S=1024 is inside the fused backward's budget: K5 and K6 stay idle
        ok = (len(losses) == TRAIN_STEPS and finite and falling
              and (fwd, bwd) == want and split == (0, 0)
              and math.isfinite(out.get("val_loss", math.nan)))
        log("training", model="flash_gpt2_small", steps=TRAIN_STEPS,
            **TRAIN_ARGS, first_loss=losses[0],
            last5_mean_loss=float(np.mean(losses[-5:])), losses=losses,
            val_loss=out.get("val_loss"), cli_train_tok_per_s=out[
                "train_tok_per_s"], platform=out["platform"],
            fwd_launches=fwd, bwd_launches=bwd, expected_launches=list(want),
            split_launches=list(split), wall_s=wall, ok=ok)
        if not ok:
            raise AssertionError(
                f"training: {len(losses)} steps, finite {finite}, falling "
                f"{falling}, launches {(fwd, bwd)} vs {want}, K5/K6 {split}")
        results["flash_launches"] = {"flash_attention_fwd": fwd,
                                     "flash_attention_bwd": bwd}
        step_ms = rec.step_ms()
        kernels = rec.device_ms()
        busy = sum(kernels.values())
        tokens = TRAIN_ARGS["batch"] * TRAIN_ARGS["seq"]
        flops = model_flops_per_step(
            TRAIN_ARGS["layers"], TRAIN_ARGS["d_model"], 50257,
            TRAIN_ARGS["batch"], TRAIN_ARGS["seq"])
        log("train_profile", steps_timed=len(rec.timed), step_ms=step_ms,
            tokens_per_s=tokens / step_ms * 1e3, peak_mem_gb=peak,
            model_flops_per_step=flops,
            flops_formula="B*S*(6*(12*L*d^2 + V*d) + 6*L*S*d)",
            mfu=flops / (step_ms * 1e-3 * PEAK_BF16),
            device_busy_ms=busy, idle_share=1.0 - busy / step_ms,
            flash_kernels_ms=sum(t for n, t in kernels.items()
                                 if "flash" in n),
            top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
        loader = TokenStreamDataLoader(str(corpus / "train.bin"),
                                       TRAIN_ARGS["seq"])
        for policy in (dt.MIXED_BF16, dt.FP32):
            step_kernel_vs_plain(_flash_gpt2_small(policy), loader)
            torch.cuda.empty_cache()


# -- phase 7 ------------------------------------------------------------------

def phase_train_cli(results):
    import contextlib
    import sysconfig
    import tempfile
    from pathlib import Path

    import torch

    from tnn_tpu_torch.cli import prepare_corpus, train_gpt2
    from tnn_tpu_torch.ops import flash_attention as fa

    layers, steps, evals, sample = 2, 20, 10, 32
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):     # their progress
        corpus, res = Path(tmp) / "corpus", Path(tmp) / "results"
        t0 = time.perf_counter()
        meta = prepare_corpus.main([
            "--out", str(corpus), "--source",
            sysconfig.get_paths()["stdlib"], "--max-mb", "8"])
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        out = train_gpt2.main([
            "--tokens", str(corpus), "--steps", str(steps), "--batch", "8",
            "--seq", "256", "--layers", str(layers), "--d-model", "768",
            "--heads", "12", "--backend", "pallas", "--sample", str(sample),
            "--results", str(res)])
        fwd, bwd = fa.flash_attention_fwd.launches, \
            fa.flash_attention_bwd.launches
        saved = json.loads((res / "lm_gpt2_byte_pallas.json").read_text())
    # K4 on every train, held-out, prompt and decode forward (generate's
    # cached steps take its kv_offset form); K7 on every train backward
    want = (layers * (steps + evals + 1 + (sample - 1)), layers * steps)
    fields = {"metric", "backend", "platform", "model", "steps",
              "steps_per_call", "train_tok_per_s", "final_train_loss",
              "final_train_ppl", "curve", "val_loss", "val_ppl",
              "decode_tok_per_s", "sample"}
    ok = (saved == out and set(out) == fields
          and out["platform"] == torch.cuda.get_device_name(0)
          and all(math.isfinite(c["loss"]) for c in out["curve"])
          and math.isfinite(out["val_loss"]) and len(out["sample"]) > 0
          and out["decode_tok_per_s"] > 0 and (fwd, bwd) == want)
    log("train_cli", corpus_tokens=meta["train_tokens"],
        **{k: out.get(k) for k in ("final_train_loss", "val_loss",
                                   "train_tok_per_s", "decode_tok_per_s")},
        sample_chars=len(out.get("sample", "")), fwd_launches=fwd,
        bwd_launches=bwd, expected_launches=list(want),
        seconds=round(time.perf_counter() - t0, 3), ok=ok)
    if not ok:
        raise AssertionError(f"train CLI run failed: launches {(fwd, bwd)} "
                             f"vs {want}; {out}")
    train_cli_llama(fields)
    train_cli_fused_head(results)


FUSED_CLI_STEPS = 20       # 5 warm-up, 15 timed by CUDA events


def train_cli_fused_head(results):
    """``cli.train_gpt2`` at full width (flash_gpt2_small, B=8, S=1024, the
    synthetic corpus) with ``--fused-head-loss 8192`` against the default
    materialized loss: peak memory, tokens/s (the CLI's and from the steady
    steps' CUDA events) and each step's loss, finite and falling. K4 = 12
    x (train + held-out steps) and K7 = 12 x train steps in each run; they
    join the kernels line."""
    import contextlib
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from tnn_tpu_torch.cli import train_gpt2
    from tnn_tpu_torch.ops import flash_attention as fa

    layers, steps = TRAIN_ARGS["layers"], FUSED_CLI_STEPS
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        corpus.mkdir()
        synthetic_corpus(corpus, n_train=400_000, n_val=100_000)
        real_make = train_gpt2.make_train_step
        for name, flags in (("materialized", []),
                            ("fused_head_loss", ["--fused-head-loss",
                                                 "8192"])):
            rec = StepRecorder(timed=range(5, steps),
                               profiled=range(steps + 1, steps + 2))
            argv = ["--tokens", str(corpus), "--steps", str(steps),
                    "--backend", "pallas", "--sample", "0",
                    "--results", str(Path(tmp) / name)] + flags
            for key, value in TRAIN_ARGS.items():
                argv += [f"--{key.replace('_', '-')}", str(value)]
            train_gpt2.make_train_step = rec.wrap(real_make)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fa.flash_attention_fwd.launches = 0
            fa.flash_attention_bwd.launches = 0
            try:
                with contextlib.redirect_stdout(sys.stderr):
                    out = train_gpt2.main(argv)
            finally:
                train_gpt2.make_train_step = real_make
            k4, k7 = fa.flash_attention_fwd.launches, \
                fa.flash_attention_bwd.launches
            results["flash_launches"]["flash_attention_fwd"] += k4
            results["flash_launches"]["flash_attention_bwd"] += k7
            losses = [float(x) for x in rec.losses]
            step_ms = rec.step_ms()
            want = [layers * (steps + EVAL_STEPS), layers * steps]
            ok = (len(losses) == steps
                  and all(math.isfinite(v) for v in losses)
                  and float(np.mean(losses[-3:])) < losses[0]
                  and [k4, k7] == want and math.isfinite(out["val_loss"]))
            rows[name] = dict(
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                step_ms=step_ms,
                tokens_per_s=TRAIN_ARGS["batch"] * TRAIN_ARGS["seq"]
                / step_ms * 1e3,
                cli_train_tok_per_s=out["train_tok_per_s"], losses=losses,
                val_loss=out["val_loss"], launches=[k4, k7],
                expected_launches=want, ok=ok)
            log("train_cli_fused_head", run=name, **TRAIN_ARGS,
                **rows[name])
    first_rel = abs(rows["fused_head_loss"]["losses"][0]
                    - rows["materialized"]["losses"][0]) \
        / rows["materialized"]["losses"][0]
    log("train_cli_fused_head_memory",
        saving_gb=rows["materialized"]["peak_mem_gb"]
        - rows["fused_head_loss"]["peak_mem_gb"],
        f32_logits_and_grad_gb=2 * TRAIN_ARGS["batch"] * TRAIN_ARGS["seq"]
        * 50257 * 4 / 2**30, first_loss_rel=first_rel)
    if not all(r["ok"] for r in rows.values()) \
            or first_rel > LM_CHUNK_FIRST_REL:
        raise AssertionError(f"--fused-head-loss runs failed: {rows}")


def train_cli_llama(fields):
    """``cli.train_gpt2 --arch llama`` at S=32,768 (2 layers of
    llama_small's widths) on the stdlib byte corpus: K5 and K6 on every
    train backward, K7 never, K4 on every train, held-out, prompt and
    decode forward."""
    import contextlib
    import sysconfig
    import tempfile
    from pathlib import Path

    import torch

    from tnn_tpu_torch.cli import prepare_corpus, train_gpt2
    from tnn_tpu_torch.ops import flash_attention as fa

    layers, steps, evals, sample = 2, 3, 10, 8
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):     # their progress
        corpus, res = Path(tmp) / "corpus", Path(tmp) / "results"
        t0 = time.perf_counter()
        prepare_corpus.main([
            "--out", str(corpus), "--source",
            sysconfig.get_paths()["stdlib"], "--max-mb", "8"])
        for c in counters:
            c.launches = 0
        out = train_gpt2.main([
            "--tokens", str(corpus), "--arch", "llama", "--steps", str(steps),
            "--batch", "1", "--seq", str(LONG_SEQ), "--layers", str(layers),
            "--d-model", "768", "--heads", "12", "--kv-heads", "4",
            "--backend", "pallas", "--sample", str(sample),
            "--results", str(res)])
        launches = tuple(c.launches for c in counters)
        saved = json.loads((res / "lm_llama_byte_pallas.json").read_text())
    want = (layers * (steps + evals + 1 + (sample - 1)), 0, layers * steps,
            layers * steps)
    ok = (saved == out and set(out) == fields
          and out["metric"] == "llama_bytes_lm"
          and out["platform"] == torch.cuda.get_device_name(0)
          and all(math.isfinite(c["loss"]) for c in out["curve"])
          and math.isfinite(out["val_loss"]) and len(out["sample"]) > 0
          and launches == want)
    log("train_cli_llama", seq=LONG_SEQ, layers=layers,
        **{k: out.get(k) for k in ("platform", "final_train_loss",
                                   "val_loss", "train_tok_per_s",
                                   "decode_tok_per_s")},
        k4_k7_k5_k6_launches=list(launches), expected_launches=list(want),
        seconds=round(time.perf_counter() - t0, 3), ok=ok)
    if not ok:
        raise AssertionError(f"llama train CLI run failed: launches "
                             f"{launches} vs {want}; {out}")


# -- phase 24 -----------------------------------------------------------------
#
# ``train_model`` at full width: flash_gpt2_small, B=8, S=1024, the
# optimizer and schedule from a ``TrainingConfig``, ``OpenWebTextDataLoader``
# over a synthetic uint16 corpus. The resumed run cannot be held bit for
# bit against an unbroken one here: K7's dQ low bits vary from run to run
# (its bulk reduce-add). So the restored state (params, moments, step,
# generator, scheduler, loader cursor) must equal what was saved byte for
# byte, and the resumed steps' losses must lie within RESUME_SPREAD times
# the largest gap between two unbroken runs, or RESUME_FLOOR_REL of the
# loss where the two unbroken runs happen to agree.
LOOP_CONFIG = dict(epochs=2, batch_size=8, max_steps=4,
                   progress_print_interval=1,
                   optimizer={"type": "adamw", "lr": 3e-4,
                              "weight_decay": 0.01, "grad_clip_norm": 1.0},
                   scheduler={"type": "warmup_cosine", "warmup": 2,
                              "t_max": 8},
                   io_dtype="bfloat16", seed=0)
RESUME_STEPS = 6             # the unbroken runs; the cut one stops at 3
RESUME_SPREAD = 2.0
RESUME_FLOOR_REL = 1e-4


def phase_training_loop(results):
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from tnn_tpu_torch.checkpoint import Checkpoint
    from tnn_tpu_torch.data.token_stream import OpenWebTextDataLoader
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.train import (create_train_state, train_model,
                                     train_state_trees)
    from tnn_tpu_torch.utils.config import TrainingConfig

    train_logs_to_stderr()
    seq, batch = TRAIN_ARGS["seq"], LOOP_CONFIG["batch_size"]
    layers = TRAIN_ARGS["layers"]
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd)

    def run(tmp, name, validate=True, **kw):
        cfg = TrainingConfig().update({**LOOP_CONFIG,
                                       "snapshot_dir": str(tmp / name),
                                       **kw})
        train = OpenWebTextDataLoader(str(tmp / "train.bin"), seq)
        val = OpenWebTextDataLoader(str(tmp / "val.bin"), seq) \
            if validate else None
        model = _flash_gpt2_small()
        losses = []
        state, hist = train_model(
            model, cfg, train, val,
            metric_hook=lambda step, m: losses.append(m["loss"]))
        return model, state, hist, losses, train

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # two validation batches: 1024 + 16 tokens give 16 windows
        synthetic_corpus(tmp, n_train=400_000, n_val=seq + 2 * batch)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        model, state, hist, losses, train = run(tmp, "main")
        main_s = time.perf_counter() - t0
        k4, k7 = (c.launches for c in counters)
        results["flash_launches"]["flash_attention_fwd"] += k4
        results["flash_launches"]["flash_attention_bwd"] += k7
        steps = LOOP_CONFIG["epochs"] * LOOP_CONFIG["max_steps"]
        evals = LOOP_CONFIG["epochs"] * 2
        want = [layers * (steps + evals), layers * steps]
        snaps = sorted(os.listdir(tmp / "main"))
        ok = ([h["batches"] for h in hist] == [4, 4] and state.step == steps
              and [k4, k7] == want
              and all(math.isfinite(v) for v in losses)
              and all(math.isfinite(h["val_loss"]) for h in hist)
              and "best" in snaps and f"step_{steps}" in snaps)
        log("training_loop", model="flash_gpt2_small", batch=batch, seq=seq,
            epochs=len(hist), losses=losses,
            epoch_seconds=[h["epoch_seconds"] for h in hist],
            val_losses=[h["val_loss"] for h in hist], snapshots=snaps,
            launches=[k4, k7], expected_launches=want, wall_s=main_s, ok=ok)
        if not ok:
            raise AssertionError(f"train_model run failed: {hist}, "
                                 f"launches {[k4, k7]} vs {want}, {snaps}")
        shutil.rmtree(tmp / "main")     # 1.5 GB a snapshot: keep few

        # a blocking save, an async save (its return after the host copy,
        # then its write) and a restore, timed, with their bytes
        ckpt = Checkpoint(str(tmp / "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(state, model=model, loader=train)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "state.tnn"))
        t0 = time.perf_counter()
        ckpt.save(state, model=model, loader=train, best=True, block=False)
        async_return_s = time.perf_counter() - t0
        ckpt.wait()
        async_total_s = time.perf_counter() - t0
        fresh = create_train_state(model, state_optimizer(LOOP_CONFIG))
        t0 = time.perf_counter()
        fresh, _ = ckpt.restore(fresh, path=path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = trees_equal(train_state_trees(fresh), train_state_trees(state))
        log("training_loop_checkpoint", bytes=nbytes, save_s=save_s,
            async_return_s=async_return_s, async_total_s=async_total_s,
            restore_s=restore_s, restored_equal=same)
        del model, state, fresh, ckpt
        shutil.rmtree(tmp / "timed")
        torch.cuda.empty_cache()

        # mid-epoch resume against two unbroken runs
        one = dict(epochs=1, validate=False)
        unbroken = [run(tmp, f"unbroken{i}", max_steps=RESUME_STEPS, **one)[3]
                    for i in range(2)]
        for i in range(2):
            shutil.rmtree(tmp / f"unbroken{i}")
        torch.cuda.empty_cache()
        cut_model, cut, _, cut_losses, cut_train = run(
            tmp, "cut", max_steps=RESUME_STEPS // 2, **one)
        saved = train_state_trees(cut)
        saved_rng = cut.generator.get_state()
        cursor = cut_train.state_dict()["cursor"]
        del cut_model, cut
        torch.cuda.empty_cache()
        snap = str(tmp / "cut" / f"step_{RESUME_STEPS // 2}")
        # the restored state against the one the cut run ended with
        probe_model = _flash_gpt2_small()
        probe = create_train_state(probe_model, state_optimizer(LOOP_CONFIG))
        probe_train = OpenWebTextDataLoader(str(tmp / "train.bin"), seq)
        probe, _ = Checkpoint(snap).restore(probe, loader=probe_train)
        restored_equal = trees_equal(train_state_trees(probe), saved) \
            and torch.equal(probe.generator.get_state(), saved_rng)
        cursor_equal = probe_train.state_dict()["cursor"] == cursor
        del probe_model, probe
        torch.cuda.empty_cache()
        _, resumed, _, res_losses, _ = run(
            tmp, "resumed", max_steps=RESUME_STEPS // 2, resume=snap, **one)
        # the cut run and then the resumed one against the first unbroken
        spread = max(abs(a - b) for a, b in zip(*unbroken))
        joined = cut_losses + res_losses
        gaps = [abs(a - b) for a, b in zip(joined, unbroken[0])]
        bound = [max(RESUME_SPREAD * spread, RESUME_FLOOR_REL * abs(b))
                 for b in unbroken[0]]
        ok = (restored_equal and cursor_equal and resumed.step == RESUME_STEPS
              and len(joined) == RESUME_STEPS
              and all(g <= b for g, b in zip(gaps, bound)))
        log("training_loop_resume", unbroken_losses=unbroken,
            cut_losses=cut_losses, resumed_losses=res_losses,
            unbroken_spread=spread, gaps=gaps, bounds=bound,
            restored_equal=restored_equal, cursor=cursor,
            cursor_equal=cursor_equal, ok=ok)
        del resumed
        torch.cuda.empty_cache()
        if not (ok and same):
            raise AssertionError("train_model resume check failed")


def state_optimizer(cfg):
    from tnn_tpu_torch.nn import optimizers

    return optimizers.from_config(cfg["optimizer"])


def trees_equal(a, b):
    """Two ``train_state_trees``, key for key and byte for byte."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            trees_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b))


# -- phase 8 ------------------------------------------------------------------
#
# K2 against its plain version, element by element:
#   |out - ref| <= atol + rtol * |ref| + 1e-5 * p.|v|,  (atol, rtol) below,
# where p.|v| is the plain version over |V|. Both sides dequantize K/V to
# f32 and leave p unrounded (v is f32), so their f32 sums differ in order
# only, within 1e-5 p.|v|. A bf16 q is promoted to f32 exactly; the output
# is then rounded to bf16 on both sides from f32 values that may straddle a
# rounding point: one bf16 ulp, at most 2^-7 |ref|.
INT8_TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 2 ** -7)}


def quant_case(seed, **spec):
    """``paged_case`` with the pages quantized as the pool writes them."""
    from tnn_tpu_torch.ops import paged_attention as pa

    args = paged_case(seed, **spec)
    for name in ("pages_k", "pages_v"):
        args[name] = pa.QuantPages(*pa.quantize_kv_rows(args[name].float()))
    return args


def dequant_args(args):
    """The same call over pages dequantized to q's dtype (for SDPA)."""
    deq = {}
    for name in ("pages_k", "pages_v"):
        p = args[name]
        deq[name] = (p.data.float() * p.scale).to(args["q"].dtype)
    return {**args, **deq}


def phase_int8_kernel(results):
    import torch
    import torch.nn.functional as F

    from tnn_tpu_torch.ops import paged_attention as pa

    bf16, f32 = torch.bfloat16, torch.float32
    kv500 = [500, 17, 512, 1, 333, 499, 64, 510]
    mixed_q = [64, 64, 40, 64, 1, 1, 1, 1]
    mixed_kv = [64, 448, 980, 704, 513, 100, 2, 1000]
    small = dict(heads=12, kv_heads=12, head_dim=64, block_size=16)
    cases = {
        "decode_bf16": dict(decode_form=True, q_lens=[1] * 8,
                            kv_lens=[500] * 8, dtype=bf16, **small),
        "decode_ragged_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                   kv_lens=kv500, dtype=bf16, **small),
        "mixed_bf16": dict(decode_form=False, q_lens=mixed_q,
                           kv_lens=mixed_kv, dtype=bf16, **small),
        "decode_gqa4_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                 kv_lens=kv500, dtype=bf16, heads=12,
                                 kv_heads=4, head_dim=64, block_size=16),
        "mixed_gqa4_f32": dict(decode_form=False, q_lens=mixed_q,
                               kv_lens=mixed_kv, dtype=f32, heads=12,
                               kv_heads=4, head_dim=64, block_size=16),
        "holes_zero_len_bf16": dict(decode_form=False,
                                    q_lens=[64, 0, 1, 0, 30, 1, 64, 1],
                                    kv_lens=[300, 0, 200, 50, 90, 0, 64, 77],
                                    dtype=bf16, holes=True, **small),
        "decode_f32": dict(decode_form=True, q_lens=[1] * 8, kv_lens=kv500,
                           dtype=f32, **small),
        "mixed_holes_f32": dict(decode_form=False, q_lens=mixed_q,
                                kv_lens=mixed_kv, dtype=f32, holes=True,
                                **small),
        "decode_bs4_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                kv_lens=kv500, dtype=bf16, heads=12,
                                kv_heads=12, head_dim=64, block_size=4),
        "mixed_bs4_f32": dict(decode_form=False, q_lens=mixed_q,
                              kv_lens=mixed_kv, dtype=f32, heads=12,
                              kv_heads=12, head_dim=64, block_size=4),
        "decode_hd128_bf16": dict(decode_form=True, q_lens=[1] * 8,
                                  kv_lens=kv500, dtype=bf16, heads=6,
                                  kv_heads=6, head_dim=128, block_size=16),
        "mixed_hd128_f32": dict(decode_form=False, q_lens=mixed_q,
                                kv_lens=mixed_kv, dtype=f32, heads=6,
                                kv_heads=6, head_dim=128, block_size=16),
    }
    worst = 0.0
    for i, (name, spec) in enumerate(cases.items()):
        args = quant_case(300 + i, batch=8, **spec)
        before = (pa.paged_attention.launches,
                  pa.paged_attention.int8_launches)
        out = pa.paged_attention(**args)
        torch.cuda.synchronize()
        if (pa.paged_attention.launches, pa.paged_attention.int8_launches) \
                != (before[0], before[1] + 1):
            raise AssertionError(f"int8 {name}: K2 did not launch alone")
        ref = pa.paged_attention_reference(**args).float()
        v = args["pages_v"]
        ref_abs_v = pa.paged_attention_reference(**{
            **args, "pages_v": pa.QuantPages(v.data.abs(), v.scale)}).float()
        diff = (out.float() - ref).abs()
        atol, rtol = INT8_TOLERANCE[str(spec["dtype"]).split(".")[-1]]
        limit = atol + rtol * ref.abs() + 1e-5 * ref_abs_v
        used = (diff / limit).max().item()
        err = diff.max().item()
        dead_nonzero = 0.0
        if not spec["decode_form"]:
            for bi, n in enumerate(spec["q_lens"]):
                if n < out.shape[1]:
                    dead_nonzero = max(dead_nonzero,
                                       out[bi, n:].float().abs().max().item())
        for bi, n in enumerate(spec["kv_lens"]):
            if n == 0:
                dead_nonzero = max(dead_nonzero,
                                   out[bi].float().abs().max().item())
        ok = math.isfinite(used) and used <= 1.0 and dead_nonzero == 0.0
        log("int8_kernel", case=name, block_size=spec["block_size"],
            splits=paged_splits(args), max_abs_err=err, atol=atol, rtol=rtol,
            limit_used=used, dead_rows_max=dead_nonzero, ok=ok)
        if not ok:
            raise AssertionError(
                f"int8 paged_attention {name}: |err| exceeds {atol} + {rtol} "
                f"|ref| + 1e-5 p.|v| ({used:.3g} of the limit) or dead rows "
                f"{dead_nonzero}")
        worst = max(worst, err)

    timed = {}
    for name in ("decode_bf16", "mixed_bf16"):
        args = quant_case(7, batch=8, **cases[name])
        nbytes, ops = paged_work(args)
        bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                             ops / PEAK_OPS["bfloat16"])
        sq, sk, sv, smask, gqa = sdpa_inputs(dequant_args(args))
        runs = {"": lambda: pa.paged_attention(**args),
                "plain_": lambda: pa.paged_attention_reference(**args),
                "library_": lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=smask, enable_gqa=gqa)}
        timed[name] = {"splits": paged_splits(args)}
        for prefix, fn in runs.items():
            device, events, per_name = time_ms(fn)
            timed[name][prefix + "ms"] = events if device is None else device
            timed[name][prefix + "events_ms"] = events
            if prefix == "":   # the call's time by kernel
                timed[name]["split_ms"] = {kernel_label(n): v
                                           for n, v in per_name.items()}
        timed[name].update(bound_ms=bound_ms, bytes=nbytes, ops=ops,
                           bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                           >= ops / PEAK_OPS["bfloat16"] else "operations")
        log("int8_kernel_time", case=name, **timed[name])
    pa.paged_attention.int8_launches = 0   # comparison launches do not count
    results["paged_attention_int8"] = dict(max_abs_err=worst,
                                           **timed["decode_bf16"])


# -- phase 9 ------------------------------------------------------------------
#
# K3 against its plain version, element by element:
#   |got - ref| <= 1e-5 * mag + rtol * |ref|,  mag = |x| @ |dequant(W)|,
# rtol 0 for an f32 result and 2^-7 for a bf16 one. Both sides sum the same
# f32 products (int8 -> x's dtype is exact) in another order: for K up to
# 3072 the two sums differ by about sqrt(K) 2^-24 mag (3.3e-6 mag), within
# 1e-5 mag. A bf16 result rounds the two sums on each side of a rounding
# point at most one ulp apart, 2^-7 |ref|.
MATMUL_SHAPES = {   # (M, K, N, out f32): gpt2_small at 512 rows, the
    # head as the serving path calls it (8 last rows), and a ragged case
    "qkv": (512, 768, 2304, False), "out": (512, 768, 768, False),
    "fc": (512, 768, 3072, False), "proj": (512, 3072, 768, False),
    "head": (512, 768, 50257, True), "head8": (8, 768, 50257, True),
    "ragged": (300, 300, 130, False)}
# the kernel names of K3's two bodies (csrc/quant_matmul.cu)
K3_BODIES = {"wgmma": "int8_matmul_wgmma_kernel",
             "simt": "int8_matmul_kernel<"}


def k3_wide_step(dev):
    """The 49 K3 calls of one 512-row int8 serving step of gpt2_small
    (qkv, out, fc and proj in each of 12 layers, then the head on the 8
    rows the mixed step heads), on seeded weights: a function that makes
    them, for ``time_ms``."""
    import torch

    from tnn_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(449)
    calls = {}
    for name in ("qkv", "out", "fc", "proj", "head8"):
        m, k, n, head = MATMUL_SHAPES[name]
        iw = qm.quantize_int8(torch.randn((k, n), generator=gen, device=dev)
                              * 0.02)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        calls[name] = (x, iw, dict(n=n, k=k, out_dtype=torch.float32
                                   if head else None))
    step = [calls[s] for s in ("qkv", "out", "fc", "proj")] * 12 \
        + [calls["head8"]]
    return lambda: [qm.int8_matmul(x, iw.q, iw.scale, **kw)
                    for x, iw, kw in step]


def k3_check(name, x, iw, kw):
    """K3 once on ``x`` against its plain version, element by element at
    the limit above, and once more for the same bits; returns the log
    entry, raising on a breach."""
    import torch

    from tnn_tpu_torch.ops import quant_matmul as qm

    (m, k), n = x.shape, kw["n"]
    plan = qm.plan_int8_matmul(m, n, k, x.dtype)
    before = qm.int8_matmul.launches
    got = qm.int8_matmul(x, iw.q, iw.scale, **kw)
    torch.cuda.synchronize()
    if qm.int8_matmul.launches != before + 1:
        raise AssertionError(f"int8_matmul {name}: K3 did not launch")
    # each K sum runs in a fixed order: the same bits again
    repeat_equal = torch.equal(got, qm.int8_matmul(x, iw.q, iw.scale, **kw))
    ref = qm.int8_matmul_reference(x, iw.q, iw.scale, **kw).float()
    mag = x.float().abs() @ iw.dequant().abs()
    rtol = 0.0 if got.dtype == torch.float32 else 2 ** -7
    diff = (got.float() - ref).abs()
    used = (diff / (1e-5 * mag + rtol * ref.abs())).max().item()
    ok = math.isfinite(used) and used <= 1.0 \
        and tuple(got.shape) == (m, n) and repeat_equal
    entry = dict(case=name, m=m, k=k, n=n, out=str(got.dtype),
                 body=plan.body, tile_m=plan.tile_m,
                 blocks=plan.blocks(m, n), max_abs_err=diff.max().item(),
                 limit_used=used, repeat_equal=repeat_equal, ok=ok)
    if not ok:
        log("int8_matmul", **entry)
        raise AssertionError(f"int8_matmul {name}: |err| exceeds 1e-5 mag "
                             f"+ {rtol} |ref| ({used:.3g} of the limit), or "
                             f"the repeat differs ({repeat_equal})")
    return entry


def phase_int8_matmul(results):
    import torch

    from tnn_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    worst = 0.0
    for i, (shape, (m, k, n, head)) in enumerate(MATMUL_SHAPES.items()):
        gen = torch.Generator(device=dev).manual_seed(400 + i)
        iw = qm.quantize_int8(torch.randn((k, n), generator=gen, device=dev)
                              * 0.02)
        x32 = torch.randn((m, k), generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{shape}_{str(dtype).split('.')[-1]}"
            x = x32.to(dtype)
            out_dtype = torch.float32 if head else None
            kw = dict(n=n, k=k, out_dtype=out_dtype)
            plan = qm.plan_int8_matmul(m, n, k, dtype)
            entry = k3_check(name, x, iw, kw)
            worst = max(worst, entry["max_abs_err"])
            # time: the kernel, the plain version, and torch.mm of x with
            # the weight dequantized ahead (int8 -> x's dtype), then the scale
            wt = iw.q[:n, :k].to(dtype).t()
            sc = iw.scale[:n]
            odt = out_dtype or dtype
            mm_kw = {} if odt == dtype else {"out_dtype": odt}
            runs = {"": lambda: qm.int8_matmul(x, iw.q, iw.scale, **kw),
                    "plain_": lambda: qm.int8_matmul_reference(
                        x, iw.q, iw.scale, **kw),
                    "library_": lambda: (torch.mm(x, wt, **mm_kw)
                                         * sc).to(odt)}
            for prefix, fn in runs.items():
                device, events, per_name = time_ms(fn, iters=20, warmup=3)
                entry[prefix + "ms"] = events if device is None else device
                entry[prefix + "events_ms"] = events
                if prefix == "":
                    entry["kernels"] = sorted(kernel_label(kn)
                                              for kn in per_name)
            # the profiler saw the body the plan names (bf16 GPT-2 shapes:
            # the tensor cores; f32 and K % 8 != 0: SIMT)
            want = K3_BODIES[plan.body]
            if (dtype == torch.bfloat16 and shape != "ragged"
                    and plan.body != "wgmma") \
                    or not any(want in kn for kn in entry["kernels"]):
                log("int8_matmul", **entry)
                raise AssertionError(f"int8_matmul {name}: the plan {plan} "
                                     f"and the profiled kernels "
                                     f"{entry['kernels']} disagree")
            nbytes = (m * k * x.element_size() + n * k + 4 * n
                      + m * n * torch.empty((), dtype=odt).element_size())
            ops = 2 * m * n * k
            peak = PEAK_OPS[str(dtype).split(".")[-1]]
            byte_ms, op_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / peak
            entry.update(bound_ms=max(byte_ms, op_ms), bytes=nbytes, ops=ops,
                         bound_by="bytes" if byte_ms >= op_ms
                         else "operations")
            log("int8_matmul", **entry)
            if name == "qkv_bfloat16":
                results["int8_matmul"] = entry
            del wt
        del iw, x32
        torch.cuda.empty_cache()
    results["int8_matmul"]["max_abs_err"] = worst
    # K3's device time in one 512-row int8 serving step (49 calls): on the
    # bodies the plan picks, and on the SIMT body alone, which ran every
    # shape before the tensor-core body came (the same kernel, unchanged)
    step = k3_wide_step(dev)
    plan = qm.plan_int8_matmul
    try:
        for before in (False, True):
            if before:
                qm.plan_int8_matmul = lambda *a, **kw: qm.MatmulPlan(
                    "simt", qm.SIMT_TILE_M)
            step_ms, step_events, per_name = time_ms(step, iters=10,
                                                     warmup=2)
            log("int8_matmul_wide_step", calls=49, all_simt=before,
                ms=step_ms, events_ms=step_events,
                kernels={kernel_label(kn): v for kn, v in per_name.items()})
    finally:
        qm.plan_int8_matmul = plan
    qm.int8_matmul.launches = 0   # comparison launches do not count


# -- phase 10 -----------------------------------------------------------------

INT8_SERVING = dict(kv_dtype="int8", quant_weights=True)


def count_wide_steps(fn):
    """Run ``fn()`` counting the ragged mixed steps (``GPT2.apply_paged``
    calls) of more than ``W8A8_MAX_ROWS`` token rows, whose matmuls take
    K3; returns (fn's result, that count)."""
    from tnn_tpu_torch.models.gpt2 import GPT2
    from tnn_tpu_torch.ops.quant_matmul import W8A8_MAX_ROWS

    real = GPT2.apply_paged
    wide = [0]

    def apply_paged(self, toks, *a, **kw):
        wide[0] += toks.numel() > W8A8_MAX_ROWS
        return real(self, toks, *a, **kw)

    GPT2.apply_paged = apply_paged
    try:
        out = fn()
    finally:
        GPT2.apply_paged = real
    return out, wide[0]


def closeness_gate(model, engine, rids):
    """The float model, teacher-forced over the int8 engine's greedy
    sequences (tests/test_quant_serving.py:289-329): the chosen token is the
    argmax in >= 75% of positions and trails it by < 0.25 everywhere else.
    Returns (exact, total, largest margin)."""
    import torch

    exact = total = 0
    margins = []
    for rid in rids:
        req = engine.result(rid)
        seq = list(req.prompt) + list(req.out_tokens)
        with torch.inference_mode():
            logits = model(torch.tensor([seq], device=model.device))[0]
        plen = len(req.prompt)
        rows = logits[plen - 1:len(seq) - 1].double()
        chosen = torch.tensor(req.out_tokens, device=rows.device)
        best = rows.max(dim=-1).values
        picked = rows.gather(1, chosen[:, None])[:, 0]
        hit = rows.argmax(dim=-1) == chosen
        exact += int(hit.sum())
        total += len(chosen)
        margins += (best - picked)[~hit].tolist()
    return exact, total, max(margins, default=0.0)


def phase_serving_int8(results):
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops import quant_matmul as qm
    from tnn_tpu_torch.serving.scheduler import RequestState

    model = zoo.create("gpt2_small", device="cuda", seed=0)
    serve_traffic(model, seed=1, num_requests=2, new_tokens=4,
                  **INT8_SERVING)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    qm.int8_matmul.launches = 0
    t0 = time.perf_counter()
    (engine, rids), wide = count_wide_steps(
        lambda: serve_traffic(model, seed=0, **INT8_SERVING))
    wall = time.perf_counter() - t0
    k1, k2 = pa.paged_attention.launches, pa.paged_attention.int8_launches
    k3 = qm.int8_matmul.launches
    stats = engine.stats()
    steps = engine.model_steps
    want = {"k1": 0, "k2": model.num_layers * steps,
            "k3": (4 * model.num_layers + 1) * wide}
    bf16_bytes = 2 * model.num_layers * model.num_kv_heads * (
        model.d_model // model.num_heads) * 2
    finished = [engine.result(r) for r in rids]
    bad = [r.rid for r in finished if r.state is not RequestState.FINISHED
           or len(r.out_tokens) != 64]
    log("serving_int8", requests=len(rids), finished=len(rids) - len(bad),
        model_steps=steps, wide_steps=wide, k1_launches=k1, k2_launches=k2,
        k3_launches=k3, expected=want, wall_s=wall,
        ttft_ms_p50=stats["ttft_ms_p50"], ttft_ms_p95=stats["ttft_ms_p95"],
        decode_tok_per_s=stats["tok_per_s"],
        step_ms_mean=stats["step_latency_ms_mean"], steps=stats["steps"],
        preemptions=stats["preemptions"],
        kv_bytes_per_token=stats["kv_bytes_per_token"],
        kv_scale_bytes_per_token=stats["kv_scale_bytes_per_token"],
        bf16_kv_bytes_per_token=bf16_bytes,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if bad:
        raise AssertionError(f"int8 requests not FINISHED with 64 tokens: "
                             f"{bad}")
    if {"k1": k1, "k2": k2, "k3": k3} != want or wide == 0:
        raise AssertionError(f"int8 serving launches K1 {k1}, K2 {k2}, K3 "
                             f"{k3} over {steps} steps ({wide} wide); want "
                             f"{want}")
    if 2 * stats["kv_bytes_per_token"] != bf16_bytes \
            or not stats["quant_weights"] or stats["kv_dtype"] != "int8":
        raise AssertionError(f"int8 engine stats: {stats}")
    results["int8_launches"] = {"k2": k2, "k3": k3}
    engine.check_invariants()

    engine2, rids2 = serve_traffic(model, seed=0, **INT8_SERVING)
    greedy = [(a, b) for i, (a, b) in enumerate(zip(rids, rids2))
              if i % 2 == 0]
    same = all(engine.result(a).out_tokens == engine2.result(b).out_tokens
               for a, b in greedy)
    exact, total, worst = closeness_gate(model, engine,
                                         [a for a, _ in greedy])
    ok = same and exact >= 0.75 * total and worst < 0.25
    log("serving_int8_close", greedy_requests=len(greedy), identical=same,
        argmax_positions=exact, positions=total,
        argmax_share=exact / max(total, 1), worst_margin=worst, ok=ok)
    if not ok:
        raise AssertionError(f"int8 serving: repeat identical {same}, "
                             f"argmax {exact}/{total}, worst margin {worst}")
    del engine, engine2
    # the bf16 pool and weights at the same point of the process, beside
    # the int8 path, so that the two differ only in the path
    profile_decode_steps(model, phase="serving_int8_profile_bf16_beside")
    profile_decode_steps(model, phase="serving_int8_profile", **INT8_SERVING)
    host_ab(model)
    del model
    torch.cuda.empty_cache()
    cli_check(("--kv-dtype", "int8", "--quant-weights"))


# -- phase 11 -----------------------------------------------------------------
#
# K5 (dQ) and K6 (dK, dV) against the plain backward, element by element,
# with K7's limit (the note above phase 3): both recompute p and ds from f32
# logits and round them at the same points, and K5 sums dQ in registers
# where K7 adds it with atomicAdd, which changes only f32 roundings. At the
# long-context shape (B=1, H=12, H_kv=4, S=32,768, D=64, bf16, causal) the
# whole plain version does not fit (one (H, S, S) f32 tensor is 51.5 GB),
# but slices of it do, since the plain backward takes the kernels' own O
# and logsumexp: dQ of a block of 64 rows needs only those rows against
# every key (kv_offset = the block's first row), and dK/dV of a tile of 64
# keys only the rows from the tile's first on against those keys. So K5's
# dQ is held to the limit on the first, a middle and the last row block,
# and K6's dK/dV on the first key tile (the longest sum, all 32,768 rows),
# a middle and the last. K5 + K6 against K7 (relative L2 per gradient) is
# then a sanity reading within one bf16 unit, 2^-8. In bf16 all three run on
# the tensor cores. K6 is K7's body without the dQ products, so its dK and
# dV equal K7's bit for bit. K5 rounds p and ds at the same points as K7,
# but from p = exp2(fma(S, scale log2(e), -lse log2(e))) where K7 takes
# exp2((S scale - lse) log2(e)), and sums dQ over 128-key tiles where K7
# adds 64-key pieces into dq_acc in an order that changes from run to run;
# so a rounding of ds may land one bf16 unit apart. Read (NVIDIA H100 80GB
# HBM3, 700 W): dQ 1.9e-4, dK 0, dV 0.
LONG_SEQ = 32768
SPLIT_SEQ = 4096
LLAMA_ATTN = dict(b=1, h=12, hkv=4, d=64)   # llama_small's attention
LONG_TILE = 64                              # rows / keys of one plain slice
LONG_VS_K7_REL_L2 = 2.0 ** -8


def live_pairs(args):
    """Live (query, key) pairs of an unmasked call, from its shapes."""
    import torch

    q, k = args["q"], args["k"]
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    if args["mask"] is not None:
        raise ValueError("live_pairs counts unmasked calls")
    if not args["causal"]:
        return b * h * sq * skv
    rows = args["kv_offset"] + 1 + torch.arange(sq, dtype=torch.int64)
    return b * h * int(rows.clamp(0, skv).sum())


def split_work(args):
    """{kernel: (bytes, operations)} of K4, K5, K6 and K7 on these unmasked
    inputs. Bytes: K4 reads q, k, v and writes O and the f32 logsumexp;
    the backward kernels read q, k, v, O, dO and the logsumexp, then write
    dQ (K5), dK and dV (K6) or all three (K7), each once. Operations: 2 D
    per product per live pair; K4 takes two products (S, PV), K5 three (S,
    dP, dQ), K6 four (S, dP, dV, dK), K7 five."""
    q, k = args["q"], args["k"]
    elem = q.element_size()
    qo, kv = q.numel() * elem, k.numel() * elem
    rows = 4 * q.shape[0] * q.shape[1] * q.shape[2]
    reads = 3 * qo + 2 * kv + rows
    per_product = 2 * q.shape[-1] * live_pairs(args)
    return {"flash_attention_fwd_long": (2 * qo + 2 * kv + rows,
                                         2 * per_product),
            "flash_attention_bwd_dq": (reads + qo, 3 * per_product),
            "flash_attention_bwd_dkv": (reads + 2 * kv, 4 * per_product),
            "flash_attention_bwd_long": (reads + qo + 2 * kv,
                                         5 * per_product)}


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def split_check(name, args):
    """One case: K4, then K5, K6 and K7 once each, K5 and K6 held against
    the plain backward; returns ({gradient: (max |err|, share of the limit
    used)}, {gradient: relative L2 of K5/K6 to the plain version},
    {gradient: the same for K7})."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    kw = dict(causal=args["causal"], mask=args["mask"],
              kv_offset=args["kv_offset"])
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
    fused = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    if (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) != (before[0] + 1,
                                                    before[1] + 1):
        raise AssertionError(f"flash_split {name}: a kernel did not launch")
    dtype = str(q.dtype).split(".")[-1]
    refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    mags = backward_magnitudes(q, k, v, o, lse, do, **kw)
    errs, split_l2, fused_l2 = {}, {}, {}
    for gname, got, f, r, mag in zip(("dq", "dk", "dv"), (dq, dk, dv), fused,
                                     refs, mags):
        errs[gname] = _limit_used(got, r, mag, dtype)
        split_l2[gname], fused_l2[gname] = _rel_l2(got, r), _rel_l2(f, r)
    del refs, mags
    dead = torch.isinf(lse)
    dead_nonzero = dq[dead].float().abs().max().item() if dead.any() else 0.0
    worst = max(u for _, u in errs.values())
    ok = math.isfinite(worst) and worst <= 1.0 and dead_nonzero == 0.0
    log("flash_split", case=name, dtype=dtype, shape=list(q.shape),
        kv_heads=k.shape[1], skv=k.shape[2], causal=args["causal"],
        kv_offset=args["kv_offset"],
        mask_groups=None if args["mask"] is None else args["mask"].shape[0],
        **{f"{n}_max_abs_err": e for n, (e, _) in errs.items()},
        **{f"{n}_limit_used": u for n, (_, u) in errs.items()},
        split_rel_l2=split_l2, fused_rel_l2=fused_l2,
        dead_rows=int(dead.sum()), dead_rows_max=dead_nonzero, ok=ok)
    if not ok:
        raise AssertionError(f"flash_split {name}: kernel vs plain outside "
                             f"the stated limit ({errs}, dead rows "
                             f"{dead_nonzero})")
    return errs, split_l2, fused_l2


def long_plain_slices(args, o, lse, dq, dk, dv):
    """K5's dQ on the first, a middle and the last block of 64 rows, and
    K6's dK/dV on the first, a middle and the last tile of 64 keys, of an
    unmasked causal call at S=32,768, each against the plain backward of
    its slice (see the note above LONG_SEQ); returns ({check: max |err|},
    {check: share of the limit used})."""
    from tnn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    s, t = q.shape[2], LONG_TILE
    dtype = str(q.dtype).split(".")[-1]
    errs, used = {}, {}
    for r in (0, s // 2, s - t):
        rows = slice(r, r + t)
        sl = [x[:, :, rows] for x in (q, o, lse, do)]
        kw = dict(causal=True, mask=None, kv_offset=r)
        ref = fa.flash_attention_backward_reference(sl[0], k, v, sl[1],
                                                    sl[2], sl[3], **kw)[0]
        mag = backward_magnitudes(sl[0], k, v, sl[1], sl[2], sl[3], **kw)[0]
        errs[f"dq_rows_{r}"], used[f"dq_rows_{r}"] = _limit_used(
            dq[:, :, rows], ref, mag, dtype)
    for c in (0, s // 2, s - t):
        rows, keys = slice(c, s), slice(c, c + t)
        sl = [x[:, :, rows] for x in (q, o, lse, do)]
        sk, sv = k[:, :, keys], v[:, :, keys]
        refs = fa.flash_attention_backward_reference(
            sl[0], sk, sv, sl[1], sl[2], sl[3], causal=True)
        mags = backward_magnitudes(sl[0], sk, sv, sl[1], sl[2], sl[3],
                                   causal=True, mask=None, kv_offset=0)
        for name, got, ref, mag in (("dk", dk, refs[1], mags[1]),
                                    ("dv", dv, refs[2], mags[2])):
            key = f"{name}_keys_{c}"
            errs[key], used[key] = _limit_used(got[:, :, keys], ref, mag,
                                               dtype)
        del refs, mags
    return errs, used


def mask_past_2_31():
    """K4, K5, K6 and K7 under a grouped mask of 4 x 2^30 bytes (B=4, H=1,
    S=32,768, causal, bf16), whose last group starts past 2^31 and whose
    last rows end near 2^32: the last 64 rows of the last batch (O, lse
    and dQ) and its last 64 keys (dK, dV, which only those rows see)
    against the plain version of that slice (kv_offset S - 64), one row
    fully masked."""
    import torch

    from tnn_tpu_torch.ops import flash_attention as fa

    s, t = LONG_SEQ, 64
    args = flash_case(11, b=4, h=1, hkv=1, sq=s, skv=s, d=64,
                      dtype=torch.bfloat16, causal=True)
    mask = torch.ones((4, s, s), dtype=torch.int8, device="cuda")
    mask[3, :, 5::7] = 0
    mask[3, s - 10] = 0                        # a row with no live key
    q, k, v, do = args["q"], args["k"], args["v"], args["do"]
    kw = dict(causal=True, mask=mask, kv_offset=0)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
    fused = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    rows = slice(s - t, s)
    sq_, so, sdo = (x[3:, :, rows].contiguous() for x in (q, o, do))
    slse = lse[3:, :, rows].contiguous()
    skw = dict(causal=True, mask=mask[3:, rows].contiguous(),
               kv_offset=s - t)
    sk, sv = k[3:], v[3:]
    ref_o, ref_lse = fa.flash_attention_reference(sq_, sk, sv, **skw)
    mag_o = fa.flash_attention_reference(sq_, sk, sv.abs(), **skw)[0].float()
    refs = fa.flash_attention_backward_reference(sq_, sk, sv, so, slse, sdo,
                                                 **skw)
    mags = backward_magnitudes(sq_, sk, sv, so, slse, sdo, **skw)
    keys = slice(s - t, s)
    used = {"o": _limit_used(o[3:, :, rows], ref_o, mag_o, "bfloat16")[1]}
    for name, got, ref, mag in (
            ("dq", dq[3:, :, rows], refs[0], mags[0]),
            ("dq_k7", fused[0][3:, :, rows], refs[0], mags[0]),
            ("dk", dk[3:, :, keys], refs[1][:, :, keys], mags[1][:, :, keys]),
            ("dk_k7", fused[1][3:, :, keys], refs[1][:, :, keys],
             mags[1][:, :, keys]),
            ("dv", dv[3:, :, keys], refs[2][:, :, keys], mags[2][:, :, keys]),
            ("dv_k7", fused[2][3:, :, keys], refs[2][:, :, keys],
             mags[2][:, :, keys])):
        used[name] = _limit_used(got, ref, mag, "bfloat16")[1]
    dead = torch.isinf(lse[3, 0])
    dead_ok = (bool(dead[s - 10]) and int(dead.sum()) == 1
               and torch.equal(torch.isinf(slse), torch.isinf(ref_lse))
               and o[3, 0, s - 10].abs().max().item() == 0.0
               and dq[3, 0, s - 10].abs().max().item() == 0.0)
    worst = max(used.values())
    ok = math.isfinite(worst) and worst <= 1.0 and dead_ok
    log("flash_split_mask_2_32", mask_bytes=mask.numel(),
        last_group_offset=3 * s * s, limit_used=used, dead_row_ok=dead_ok,
        ok=ok)
    if not ok:
        raise AssertionError(f"mask past 2^31: {used}, dead row {dead_ok}")


def phase_flash_split(results):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tnn_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    # K7's cases at the training shape (flash_vit's take the fused path)
    cases = {k: v for k, v in flash_cases().items()
             if not k.startswith("vit_")}
    cases["llama_s4096_bf16"] = dict(LLAMA_ATTN, sq=SPLIT_SEQ, skv=SPLIT_SEQ,
                                     dtype=bf16, causal=True)
    worst_dq = worst_dkv = 0.0
    for i, (name, spec) in enumerate(cases.items()):
        args = flash_case(500 + i, **spec)
        errs, split_l2, fused_l2 = split_check(name, args)
        worst_dq = max(worst_dq, errs["dq"][0])
        worst_dkv = max(worst_dkv, errs["dk"][0], errs["dv"][0])
        del args
        torch.cuda.empty_cache()
    # the long-context shape: K5 and K6 against plain slices, K5 repeated,
    # and K5 + K6 against K7 as a sanity reading
    long = flash_case(9, **LLAMA_ATTN, sq=LONG_SEQ, skv=LONG_SEQ, dtype=bf16,
                      causal=True)
    q, k, v, do = long["q"], long["k"], long["v"], long["do"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    dq = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=True)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, o, lse, do, causal=True)
    fused = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    same = bool(torch.equal(dq, dq2))
    l2 = {n: _rel_l2(a, f) for n, a, f in zip(("dq", "dk", "dv"),
                                              (dq, dk, dv), fused)}
    finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    del dq2, fused
    slice_errs, slice_used = long_plain_slices(long, o, lse, dq, dk, dv)
    worst_dq = max([worst_dq] + [e for n, e in slice_errs.items()
                                 if n.startswith("dq")])
    worst_dkv = max([worst_dkv] + [e for n, e in slice_errs.items()
                                   if not n.startswith("dq")])
    worst_used = max(slice_used.values())
    ok = (same and finite and math.isfinite(worst_used) and worst_used <= 1.0
          and all(l2[n] <= LONG_VS_K7_REL_L2 for n in l2))
    log("flash_split_long", shape=list(q.shape), kv_heads=k.shape[1],
        plain_slices_max_abs_err=slice_errs,
        plain_slices_limit_used=slice_used,
        split_vs_fused_rel_l2=l2, split_vs_fused_limit=LONG_VS_K7_REL_L2,
        readings_at_4096={"split": split_l2, "fused": fused_l2},
        dq_bit_identical=same, finite=finite, ok=ok)
    if not ok:
        raise AssertionError(f"K5 + K6 at S={LONG_SEQ}: plain slices "
                             f"{slice_used}, vs K7 {l2} (limit "
                             f"{LONG_VS_K7_REL_L2}), repeat identical {same}")
    mask_past_2_31()
    torch.cuda.empty_cache()

    # times at the long-context shape; the plain backward at S=4096 (the
    # plain version of both K5 and K6), SDPA's backward at S=32,768 (all
    # three gradients in one call, the library's nearest function)
    small = flash_case(10, **LLAMA_ATTN, sq=SPLIT_SEQ, skv=SPLIT_SEQ,
                       dtype=bf16, causal=True)
    so, slse = fa.flash_attention_fwd(small["q"], small["k"], small["v"],
                                      causal=True)
    plain = (small["q"], small["k"], small["v"], so, slse, small["do"])
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                                 enable_gqa=True)

    def sdpa_fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

    fns = {
        "flash_attention_fwd_long": lambda: fa.flash_attention_fwd(
            q, k, v, causal=True),
        "plain_fwd": lambda: fa.flash_attention_reference(
            small["q"], small["k"], small["v"], causal=True),
        "library_fwd": sdpa_fwd,
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, o, lse, do, causal=True),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, o, lse, do, causal=True),
        "flash_attention_bwd_long": lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal=True),
        "plain": lambda: fa.flash_attention_backward_reference(
            *plain, causal=True),
        "library": lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                               retain_graph=True)}
    times, per_names = {}, {}
    bodies = {"flash_attention_bwd_dq": "k5", "flash_attention_bwd_dkv": "k6",
              "flash_attention_bwd_long": "k7"}
    for name, fn in fns.items():
        device, events, per_names[name] = time_ms(fn, iters=3, warmup=1)
        times[name] = (events if device is None else device, events)
    worst = {"flash_attention_bwd_dq": worst_dq,
             "flash_attention_bwd_dkv": worst_dkv}
    for name, (nbytes, ops) in split_work(long).items():
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        op_ms = 1e3 * ops / PEAK_OPS["bfloat16"]
        ref = "_fwd" if name.endswith("fwd_long") else ""
        timed = dict(ms=times[name][0], events_ms=times[name][1],
                     plain_ms=times["plain" + ref][0],
                     plain_events_ms=times["plain" + ref][1],
                     library_ms=times["library" + ref][0],
                     library_events_ms=times["library" + ref][1],
                     bound_ms=max(byte_ms, op_ms), bytes=nbytes, ops=ops,
                     bound_by="bytes" if byte_ms >= op_ms else "operations",
                     seq=LONG_SEQ, plain_seq=SPLIT_SEQ)
        if name in bodies:
            timed["split_ms"] = bwd_parts(per_names[name], bodies[name])
            timed["kernels"] = sorted(map(kernel_label, per_names[name]))
        log("flash_split_time", kernel=name, case="llama_s32768_bf16",
            **timed)
        if name in worst:     # K4 and K7 at this shape are logged only
            results[name] = dict(timed, max_abs_err=worst[name])
    # the pair against the two other ways to the same three gradients
    split = (times["flash_attention_bwd_dq"][0]
             + times["flash_attention_bwd_dkv"][0])
    log("flash_split_vs_fused", case="llama_s32768_bf16", k5_ms=times[
        "flash_attention_bwd_dq"][0], k6_ms=times[
            "flash_attention_bwd_dkv"][0], k5_k6_ms=split,
        k7_ms=times["flash_attention_bwd_long"][0],
        sdpa_bwd_ms=times["library"][0],
        k5_k6_over_k7=split / times["flash_attention_bwd_long"][0],
        k5_k6_over_sdpa=split / times["library"][0])
    # comparison launches do not count
    for wrapper in (fa.flash_attention_fwd, fa.flash_attention_bwd,
                    fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        wrapper.launches = 0
    del long, small, plain, q, k, v, do, o, lse, dq, dk, dv, lq, lk, lv
    del lib_out
    torch.cuda.empty_cache()


# -- phase 12 -----------------------------------------------------------------

LONG_TRAIN_STEPS = 6   # 2 warm-up, 3 timed, 1 profiled
LONG_EVAL_STEPS = 2


def llama_flops_per_step(model, batch, seq):
    """6 x (weights in matmuls, the tied head included: per layer the qkv
    projection d (d + 2 kv_d), the output d^2 and the SwiGLU 3 d hidden;
    V d) per token, plus causal attention 6 L S d per token (QK and PV over
    S/2 keys on average, forward and the backward's twice as much)."""
    d, kv_d = model.d_model, model.num_kv_heads * (
        model.d_model // model.num_heads)
    per_layer = d * (d + 2 * kv_d) + d * d + 3 * d * model.mlp_hidden
    n = model.num_layers * per_layer + model.vocab_size * d
    return (6 * n + 6 * model.num_layers * seq * d) * batch * seq


def phase_training_long(results):
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from tnn_tpu_torch.data.token_stream import TokenStreamDataLoader
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.nn.schedulers import WarmupCosineAnnealing
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.train import (create_train_state, make_eval_step,
                                     make_train_step)

    t0 = time.perf_counter()
    model = zoo.create("flash_llama_small", max_len=LONG_SEQ, device="cuda",
                       seed=0)
    init_s = time.perf_counter() - t0
    steps, evals = LONG_TRAIN_STEPS, LONG_EVAL_STEPS
    # the CLI's optimizer and schedule
    opt = AdamW(lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)
    sched = WarmupCosineAnnealing(warmup=max(10, steps // 20), t_max=steps)
    state = create_train_state(model, opt, seed=0)
    rec = StepRecorder(timed=range(2, steps - 1),
                       profiled=range(steps - 1, steps))
    step = rec.wrap(make_train_step)(model, opt, scheduler=sched)
    ev = make_eval_step(model, compute_accuracy=False)
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_corpus(Path(tmp), vocab=model.vocab_size)
        train = TokenStreamDataLoader(str(Path(tmp) / "train.bin"), LONG_SEQ)
        val = TokenStreamDataLoader(str(Path(tmp) / "val.bin"), LONG_SEQ)
        rng = np.random.default_rng(0)

        def batch(loader):
            d, l = loader.random_windows(1, rng)
            return (torch.from_numpy(d).cuda().long(),
                    torch.from_numpy(l).cuda().long())

        counters = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                    fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, *batch(train))
        val_losses = [float(ev(state, *batch(val))["loss"])
                      for _ in range(evals)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd, dq, dkv = (c.launches for c in counters)
        # the batches every variant below trains on
        variant_batches = [batch(train) for _ in range(LONG_VARIANT_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in rec.losses]
    layers = model.num_layers
    want = (layers * (steps + evals), 0, layers * steps, layers * steps)
    finite = all(math.isfinite(x) for x in losses + val_losses)
    falling = losses[-1] < losses[0]
    ok = finite and falling and (fwd, bwd, dq, dkv) == want
    log("training_long", model="flash_llama_small", batch=1, seq=LONG_SEQ,
        layers=layers, d_model=model.d_model, heads=model.num_heads,
        kv_heads=model.num_kv_heads, mlp_hidden=model.mlp_hidden,
        vocab=model.vocab_size, policy=model.policy.compute,
        init_s=init_s, steps=steps, losses=losses, val_losses=val_losses,
        k4_launches=fwd, k7_launches=bwd, k5_launches=dq, k6_launches=dkv,
        expected_launches=list(want), wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError(
            f"long training: finite {finite}, falling {falling}, launches "
            f"K4/K7/K5/K6 {(fwd, bwd, dq, dkv)} vs {want}")
    results["split_launches"] = {"flash_attention_bwd_dq": dq,
                                 "flash_attention_bwd_dkv": dkv}
    step_ms = rec.step_ms()
    kernels = rec.device_ms()
    busy = sum(kernels.values())
    flops = llama_flops_per_step(model, 1, LONG_SEQ)
    # which bodies ran: the profiled step's flash kernels by name; in bf16
    # K4, K5 and K6 take the tensor-core bodies and nothing else
    flash_bodies = [n for n in rec.kernel_labels() if n.startswith("flash_")]
    ran = {k: any(n.split("<")[0] == body for n in flash_bodies)
           for k, body in (("K4", "flash_fwd_wgmma_kernel"),
                           ("K5", "flash_bwd_dq_wgmma_kernel"),
                           ("K6", "flash_bwd_wgmma_kernel"))}
    simt = [n for n in flash_bodies if n.split("<")[0] in (
        "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_kernel")]
    log("training_long_profile", steps_timed=len(rec.timed), step_ms=step_ms,
        tokens_per_s=LONG_SEQ / step_ms * 1e3, peak_mem_gb=peak,
        model_flops_per_step=flops,
        flops_formula="B*S*(6*(L*(d*(d+2*kv_d) + d^2 + 3*d*hidden) + V*d)"
                      " + 6*L*S*d)",
        mfu=flops / (step_ms * 1e-3 * PEAK_BF16), device_busy_ms=busy,
        idle_share=1.0 - busy / step_ms,
        flash_kernels_ms={n: t for n, t in kernels.items() if "flash" in n},
        flash_bodies=flash_bodies, tensor_core_bodies_ran=ran,
        top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    if not all(ran.values()) or simt:
        raise AssertionError(f"long training's flash kernels {flash_bodies}: "
                             f"tensor-core bodies {ran}, SIMT bodies {simt}")
    del state, step, ev
    torch.cuda.empty_cache()
    training_long_variants(model, variant_batches, results)
    del model
    torch.cuda.empty_cache()


# The long-context step's memory knobs, each from the same weights on the
# same batches as "none" (AdamW, no accuracy): the chunked LM-head loss
# (``lm_head_chunk``) and three remat policies. Bounds (bf16 policy, f32
# logits both ways): the chunked loss equals the materialized one at the
# first step within LM_CHUNK_FIRST_REL (summation order only); later steps
# within LM_CHUNK_LATER_REL, as the two backwards round the logits'
# gradient at different points (the materialized product rounds it to
# bf16, the chunked one keeps it in f32); remat reruns the same kernels
# on the same values, so every loss within REMAT_REL of "none" (the
# split backward K5 + K6 is deterministic; 0 is what it should read).
LONG_VARIANT_STEPS = 3          # 1 warm-up, 2 timed
LONG_VARIANTS = (("none", {}), ("lm_head_chunk", {"lm_head_chunk": 8192}),
                 ("remat_full", {"remat": "full"}),
                 ("remat_dots", {"remat": "dots"}),
                 ("remat_offload_dots", {"remat": "offload_dots"}))
LM_CHUNK_FIRST_REL = 1e-4
LM_CHUNK_LATER_REL = 2e-2
REMAT_REL = 1e-3


def training_long_variants(model, batches, results):
    """The Llama cell with each of ``LONG_VARIANTS``: steady step time
    (CUDA events), peak memory, losses, K4 / K5 / K6 / K7 launches (K4
    twice a layer under remat: the backward runs the attention forward
    again) and which backward kernels ran."""
    import torch

    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.train import create_train_state, make_train_step

    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    layers, steps = model.num_layers, len(batches)
    rows = {}
    for name, kw in LONG_VARIANTS:
        model.load_state_dict(init)
        opt = AdamW(lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)
        state = create_train_state(model, opt, seed=0)
        step = make_train_step(model, opt, compute_accuracy=False, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        events, losses = [], []
        for i, (x, y) in enumerate(batches):
            if i == 1:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            state, m = step(state, x, y)
            losses.append(m["loss"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        torch.cuda.synchronize()
        k4, k7, k5, k6 = (c.launches for c in counters)
        remat = "remat" in kw
        want = (layers * steps * (2 if remat else 1), 0, layers * steps,
                layers * steps)
        losses = [float(v) for v in losses]
        rows[name] = dict(
            step_ms=events[0].elapsed_time(events[1]) / (steps - 1),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            losses=losses, launches=[k4, k7, k5, k6],
            expected_launches=list(want),
            backward_kernels=[n for n, c in (("flash_attention_bwd_dq", k5),
                                             ("flash_attention_bwd_dkv", k6),
                                             ("flash_attention_bwd", k7))
                              if c])
        results["flash_launches"]["flash_attention_fwd"] += k4
        split = results.setdefault("split_launches", {
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0})
        split["flash_attention_bwd_dq"] += k5
        split["flash_attention_bwd_dkv"] += k6
        del state, step, opt
    base = rows["none"]["losses"]
    fails = []
    for name, row in rows.items():
        rel = [abs(a - b) / abs(b) for a, b in zip(row["losses"], base)]
        if name == "lm_head_chunk":
            ok = rel[0] <= LM_CHUNK_FIRST_REL and max(rel) <= \
                LM_CHUNK_LATER_REL
        else:
            ok = max(rel) <= REMAT_REL
        ok = ok and all(math.isfinite(v) for v in row["losses"]) and \
            row["launches"] == row["expected_launches"]
        row.update(max_rel_to_none=max(rel), ok=ok)
        log("training_long_variant", variant=name, batch=1, seq=LONG_SEQ,
            tokens_per_s=LONG_SEQ / row["step_ms"] * 1e3, **row)
        if not ok:
            fails.append(name)
    log("training_long_memory", peak_mem_gb={
        n: r["peak_mem_gb"] for n, r in rows.items()},
        lm_head_chunk_saving_gb=rows["none"]["peak_mem_gb"]
        - rows["lm_head_chunk"]["peak_mem_gb"],
        f32_logits_and_grad_gb=2 * LONG_SEQ * model.vocab_size * 4 / 2**30,
        step_ms={n: r["step_ms"] for n, r in rows.items()})
    if fails:
        raise AssertionError(f"long training variants failed: {fails}")


# -- phase 13 -----------------------------------------------------------------
#
# K8 against its plain version. Both compute in f32 at the same rounding
# points, so they differ by summation order (LayerNorm's statistics, the
# attention sums): about 1e-7 relative. Where such a difference meets a tie
# of a rounding (a re-quantized activation's x / sx near k + 1/2, or a bf16
# cache row), one value moves to its other neighbour, and every later
# re-quantization of the stack can amplify that: over 12 layers one moved
# bf16 row ended 88 code steps away in one case of 48 (NVIDIA H100 80GB
# HBM3 at 700 W). So the stack is held against the plain
# version layer by layer:
#   * the L-layer launch equals the chain of L one-layer launches (f32
#     between them, the residual's own type) bit for bit;
#   * each one-layer launch, on the chain's input, against the plain
#     version on the same input and caches: per element
#       |k8 - plain| <= 1e-5 max|plain| + DECODE_FLIP_STEPS * U,
#     U the largest code step (``code_steps``: one int8 step of the input
#     times the largest weight it meets) of the matmuls that write the
#     residual (out, proj); on row t of the caches the same with U of qkv,
#     plus one unit of the cache dtype's rounding (2^-8 |plain| in bf16).
#     Within one layer a moved code still spreads through LN2, fc, GELU
#     and proj: the same run read at most 7.8 code steps in a layer, in 9
#     of its 576 layers; the limit is twice that, and at most
#     DECODE_MOVED_LAYERS of a case's 12 layers may leave the float term.
DECODE_T = 1024
DECODE_FLIP_STEPS = 16
DECODE_MOVED_LAYERS = 4


def decode_stack_inputs(model, *, batch, t, dtype, seed):
    """Seeded caches (N(0, 0.5^2), the scale of this model's k and v) and x
    from the model's own embedding of random tokens at position t."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (model.num_layers, batch, DECODE_T, model.d_model)
    kc = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
    vc = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)
    tok = torch.randint(0, model.vocab_size, (batch, 1), generator=gen,
                        device="cuda")
    with torch.inference_mode():
        x = model.wpe(model.wte(tok), offset=t)[:, 0].to(dtype).contiguous()
    return x, kc, vc


def decode_stack_bytes(model, batch, t, itemsize):
    """Bytes K8 must move: every int8 weight (12 D^2 a layer at F = 4D)
    and f32 vector (22 D) once, cache rows 0..t of K and V (row t is the
    write), x in and x_out."""
    d, f, n_layers = model.d_model, 4 * model.d_model, model.num_layers
    weights = n_layers * (4 * d * d + 2 * f * d + 4 * (14 * d + 2 * f))
    return (weights + n_layers * 2 * batch * (t + 1) * d * itemsize
            + 2 * batch * d * itemsize)


def decode_stack_case(stacks, heads, x, t, kc, vc, chunks):
    """One case: the L-layer launch, its repeat, the chain of one-layer
    launches and each layer against the plain version. Returns the
    reading."""
    import torch

    from tnn_tpu_torch.ops import decode_stack as ds

    n_layers = kc.shape[0]
    k0, v0 = kc.clone(), vc.clone()
    before = ds.fused_decode_stack.launches
    out, kc, vc = ds.fused_decode_stack(x, t, kc, vc, stacks,
                                        num_heads=heads, chunks=chunks)
    torch.cuda.synchronize()
    launched = ds.fused_decode_stack.launches - before
    others = all(torch.equal(a[:, :, :t], b[:, :, :t])
                 and torch.equal(a[:, :, t + 1:], b[:, :, t + 1:])
                 for a, b in ((kc, k0), (vc, v0)))
    k2, v2 = k0.clone(), v0.clone()
    again, k2, v2 = ds.fused_decode_stack(x, t, k2, v2, stacks,
                                          num_heads=heads, chunks=chunks)
    repeat = (torch.equal(again, out) and torch.equal(k2, kc)
              and torch.equal(v2, vc))
    cast = 2 ** -8 if kc.dtype == torch.bfloat16 else 0.0
    h = x.float()
    kch, vch = k0.clone(), v0.clone()
    used = row_used = err = row_err = code_steps = 0.0
    layers_past_float = 0
    for layer in range(n_layers):
        one = {k: v[layer:layer + 1] for k, v in stacks.items()}
        kr, vr = k0[layer:layer + 1].clone(), v0[layer:layer + 1].clone()
        steps = {}
        ref, kr, vr = ds.fused_decode_stack_reference(
            h, t, kr, vr, one, num_heads=heads, chunks=chunks,
            code_steps=steps)
        h, _, _ = ds.fused_decode_stack(h, t, kch[layer:layer + 1],
                                        vch[layer:layer + 1], one,
                                        num_heads=heads, chunks=chunks)
        diff = (h - ref).abs()
        floor = 1e-5 * ref.abs().max()
        u_res = max(steps["out"] + steps["proj"])
        used = max(used, (diff / (floor + DECODE_FLIP_STEPS * u_res))
                   .max().item())
        code_steps = max(code_steps, ((diff - floor) / u_res).max().item())
        err = max(err, diff.max().item())
        layers_past_float += bool((diff > floor).any())
        for got, want in ((kch, kr), (vch, vr)):
            g, w = got[layer, :, t].float(), want[0, :, t].float()
            e = (g - w).abs()
            lim = 1e-5 * w.abs().max() + cast * w.abs() \
                + DECODE_FLIP_STEPS * max(steps["qkv"])
            row_err = max(row_err, e.max().item())
            row_used = max(row_used, (e / lim).max().item())
    torch.cuda.synchronize()
    chain = (torch.equal(h.to(out.dtype), out) and torch.equal(kch, kc)
             and torch.equal(vch, vc))
    ok = (launched == 1 and bool(torch.isfinite(out).all()) and others
          and repeat and chain and used <= 1.0 and row_used <= 1.0
          and layers_past_float <= DECODE_MOVED_LAYERS)
    return dict(max_abs_err=err, limit_used=used, code_steps=code_steps,
                row_t_err=row_err,
                row_t_limit_used=row_used,
                layers_past_float=layers_past_float, chain_bit_for_bit=chain,
                other_rows_same=others, repeat_bit_for_bit=repeat, ok=ok)


def decode_stack_plan(model, blocks):
    """K8's launch plan at gpt2_small's width (shapes only): each block's
    rows and ring stages of every matrix, its weight bytes a layer, the
    kernel's own shared memory and ring depth at 1, 2 and 16 rows."""
    import torch

    from tnn_tpu_torch.ops import decode_stack as ds

    d, f, heads = model.d_model, 4 * model.d_model, model.num_heads
    plan = {"blocks": blocks, "barriers_per_step": ds.barriers_per_step(
        model.num_layers, 2)}
    share = [0] * blocks
    for name, (n_rows, row_bytes) in ds.matrix_shapes(d, f).items():
        ranges = ds.plan_partition(n_rows, blocks)
        rows = [r1 - r0 for r0, r1 in ranges]
        stages = [ds.plan_stages(r, row_bytes)[0] for r in rows]
        plan[name] = {"rows_per_block": [min(rows), max(rows)],
                      "row_bytes": row_bytes,
                      "stages_per_block": [min(stages), max(stages)]}
        for i, r in enumerate(rows):
            share[i] += r * row_bytes
    plan["share_bytes_per_layer"] = [min(share), max(share)]
    plan["smem"] = {}
    for batch, chunks in ((1, 2), (2, 2), (16, 8)):
        smem = ds.check_kernel_geometry(batch, d, f, chunks, d // heads,
                                        torch.bfloat16, blocks=blocks)
        plan["smem"][f"B{batch}_C{chunks}"] = {
            "bytes": smem, **ds.kernel_plan(batch, d, f, chunks, heads,
                                            blocks, smem)}
    return plan


def decode_stack_phases(ds, x, t, kc, vc, stacks, heads, chunks):
    """One K8 launch with stamps (block 0's %globaltimer after each grid
    barrier): ms per phase kind summed over the layers, and the whole."""
    import torch

    n_layers = kc.shape[0]
    stamps = torch.zeros(ds.barriers_per_step(n_layers, chunks) + 2,
                         dtype=torch.int64, device="cuda")
    for _ in range(3):           # warm, then the stamped launch read last
        ds.fused_decode_stack(x, t, kc, vc, stacks, num_heads=heads,
                              chunks=chunks, stamps=stamps)
    torch.cuda.synchronize()
    gaps = stamps.diff().double().cpu() / 1e6
    names = ("qkv", "attention", "out", "fc", "proj")
    out = {f"{n}_ms": float(gaps[i::5].sum()) for i, n in enumerate(names)}
    out["step_ms"] = float(gaps.sum())
    return out


def phase_decode_stack(results):
    import torch

    from tnn_tpu_torch.models import fused_decode, zoo
    from tnn_tpu_torch.nn.quant import quantize_for_decode
    from tnn_tpu_torch.ops import decode_stack as ds

    from tnn_tpu_torch.ops import runtime

    model = quantize_for_decode(zoo.create("gpt2_small", device="cuda",
                                           seed=0))
    stacks = fused_decode.stack_decode_weights(model)
    heads = model.num_heads
    blocks = runtime.sm_count("cuda")
    log("decode_stack_plan", **decode_stack_plan(model, blocks))
    failures = []
    worst = 0.0
    ncase = 0
    for batch in (1, 2):
        picked = fused_decode.pick_chunks(model.d_model, 4 * model.d_model,
                                          batch, DECODE_T)
        for dtype in (torch.bfloat16, torch.float32):
            for t in (0, DECODE_T // 2 - 1, DECODE_T - 1):
                for chunks in sorted({picked, 1, 2, 4, 8} - {None}):
                    ncase += 1
                    x, kc, vc = decode_stack_inputs(
                        model, batch=batch, t=t, dtype=dtype,
                        seed=1000 + ncase)
                    reading = decode_stack_case(stacks, heads, x, t, kc, vc,
                                                chunks)
                    log("decode_stack", case=ncase, batch=batch,
                        dtype=str(dtype).split(".")[-1], t=t, chunks=chunks,
                        picked=chunks == picked,
                        splits=ds.plan_splits(batch, heads, t, blocks)[0],
                        **reading)
                    worst = max(worst, reading["max_abs_err"],
                                reading["row_t_err"])
                    if not reading["ok"]:
                        failures.append(ncase)
                    del x, kc, vc
    if failures:
        raise AssertionError(f"decode_stack cases failed: {failures}")

    # times at the shape of the JSON line: B = 1, t = T - 1, bf16, the
    # reference's chunk count; beside them the unfused w8a8 blocks of the
    # same quantized model (GPTBlock.apply_cached: no single PyTorch call
    # computes the stack)
    batch, t, dtype = 1, DECODE_T - 1, torch.bfloat16
    chunks = fused_decode.pick_chunks(model.d_model, 4 * model.d_model,
                                      batch, DECODE_T)
    x, kc, vc = decode_stack_inputs(model, batch=batch, t=t, dtype=dtype,
                                    seed=7)
    dh = model.d_model // heads
    caches = [{"k": kc[i].view(batch, DECODE_T, heads, dh).transpose(1, 2),
               "v": vc[i].view(batch, DECODE_T, heads, dh).transpose(1, 2)}
              for i in range(model.num_layers)]

    def unfused():
        with torch.inference_mode():
            h = x[:, None]
            for blk, cache in zip(model.blocks, caches):
                h, _ = blk.apply_cached(h, cache, t)
        return h

    entry = {"batch": batch, "t": t, "dtype": "bfloat16", "chunks": chunks,
             "max_abs_err": worst}
    runs = {"": lambda: ds.fused_decode_stack(
                x, t, kc, vc, stacks, num_heads=heads, chunks=chunks),
            "plain_": lambda: ds.fused_decode_stack_reference(
                x, t, kc, vc, stacks, num_heads=heads, chunks=chunks),
            "unfused_": unfused}
    for prefix, fn in runs.items():
        device, events, _ = time_ms(fn, iters=20, warmup=3)
        entry[prefix + "ms"] = events if device is None else device
        entry[prefix + "events_ms"] = events
    # the same launch at t = 0, where attention reads one row: the rest of
    # the step (weights, row passes, grid barriers), at each chunk count:
    # the chunks share the fc and proj phases, so they add no barrier
    entry["t0_ms_by_chunks"] = {
        c: time_ms(lambda c=c: ds.fused_decode_stack(
            x, 0, kc, vc, stacks, num_heads=heads, chunks=c),
            iters=20, warmup=3)[0]
        for c in (1, 2, 4, 8)}
    # one stamped launch each at t = T - 1 and t = 0: block 0's clock after
    # every grid barrier splits the step into its five phases
    for tt in (t, 0):
        log("decode_stack_phases", batch=batch, t=tt, chunks=chunks,
            splits=ds.plan_splits(batch, heads, tt, blocks)[0],
            **decode_stack_phases(ds, x, tt, kc, vc, stacks, heads, chunks))
    nbytes = decode_stack_bytes(model, batch, t, 2)
    d, n_layers = model.d_model, model.num_layers
    int8_ops = n_layers * 2 * batch * 12 * d * d
    f32_ops = n_layers * 4 * batch * (t + 1) * d
    byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    op_ms = 1e3 * (int8_ops / PEAK_OPS["int8"] + f32_ops / PEAK_OPS["float32"])
    entry.update(bound_ms=max(byte_ms, op_ms), bytes=nbytes,
                 int8_ops=int8_ops, f32_ops=f32_ops,
                 bound_by="bytes" if byte_ms >= op_ms else "operations",
                 library_ms=None,
                 grid_syncs=ds.barriers_per_step(n_layers, chunks),
                 splits=ds.plan_splits(batch, heads, t, blocks)[0])
    log("decode_stack_time", **entry)
    results["fused_decode_stack"] = entry
    ds.fused_decode_stack.launches = 0   # comparison launches do not count
    del model, stacks, caches, x, kc, vc
    torch.cuda.empty_cache()


# -- phase 14 -----------------------------------------------------------------

PROMPT = "The meaning of life is"
GENERATE_TOKENS = 64


def generate_cli(flags):
    """``cli.gpt2_inference`` on full-width gpt2_small; returns its
    tokens/s line's numbers and the generated ids it prints."""
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.gpt2_inference", "-n",
         str(GENERATE_TOKENS), *flags], capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"gpt2_inference {flags} failed: rc "
                             f"{proc.returncode}\n{proc.stderr[-4000:]}")
    last = proc.stdout.strip().splitlines()[-1]       # "N tokens in X ms"
    words = last.split()
    ids = [ln for ln in proc.stdout.splitlines()
           if ln.startswith("generated ids:")][0]
    return {"tokens": int(words[0]), "ms": float(words[3]),
            "tok_per_s": float(words[5].strip("(")), "ids": ids}


def teacher_forced(model, stream, plen, chunks=None):
    """Per-step logits over a fixed token stream: the unfused int8 step
    (``apply_cached``) when ``chunks`` is None, else K8 (fused_generate's
    body)."""
    import torch

    from tnn_tpu_torch.models import fused_decode
    from tnn_tpu_torch.ops.decode_stack import fused_decode_stack

    caches = model.init_cache(1, stream.shape[1])
    out = []
    with torch.inference_mode():
        out.append(model.apply_cached(stream[:, :plen], caches, 0)[:, -1])
        if chunks is not None:
            stacks = fused_decode.decode_stacks(model)
            kc, vc = fused_decode.caches_to_stacked(caches)
        for pos in range(plen, stream.shape[1] - 1):
            tok = stream[:, pos:pos + 1]
            if chunks is None:
                out.append(model.apply_cached(tok, caches, pos)[:, -1])
                continue
            x = model.wpe(model.wte(tok), offset=pos)[:, 0].contiguous()
            x_out, kc, vc = fused_decode_stack(
                x, pos, kc, vc, stacks, num_heads=model.num_heads,
                chunks=chunks)
            out.append(model._head(x_out[:, None, :])[:, -1])
    return torch.stack(out, dim=1)[0].float()


def per_token_profile(fn, tokens):
    """Kernels and outermost aten ops per generated token of ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = ops = 0
        busy = 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels += 1
                busy += e.time_range.elapsed_us()
                continue
            parent = e.cpu_parent
            ops += e.name.startswith("aten::") and not (
                parent is not None and parent.name.startswith("aten::"))
        if kernels:
            break
    return {"kernels_per_token": kernels / tokens,
            "aten_ops_per_token": ops / tokens,
            "busy_ms_per_token": busy / 1e3 / tokens,
            "profiled_ms_per_token": wall * 1e3 / tokens}


def phase_fused_generate(results):
    import numpy as np
    import torch

    from tnn_tpu_torch.models import fused_decode, zoo
    from tnn_tpu_torch.models.gpt2 import generate
    from tnn_tpu_torch.nn.quant import quantize_for_decode
    from tnn_tpu_torch.ops import decode_stack as ds

    fused_cli = generate_cli(["--fused"])
    int8_cli = generate_cli(["--int8"])
    model = quantize_for_decode(zoo.create("gpt2_small", device="cuda",
                                           seed=0))
    prompt = torch.from_numpy(np.frombuffer(PROMPT.encode(), np.uint8)
                              .astype(np.int64))[None].to(model.device)
    plen = prompt.shape[1]
    fused_decode.fused_generate(model, prompt, 4)                # warm-up
    torch.cuda.synchronize()
    ds.fused_decode_stack.launches = 0
    t0 = time.perf_counter()
    toks = fused_decode.fused_generate(model, prompt, GENERATE_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ds.fused_decode_stack.launches
    again = fused_decode.fused_generate(model, prompt, GENERATE_TOKENS)
    chunks = fused_decode.pick_chunks(model.d_model, 4 * model.d_model, 1,
                                      plen + GENERATE_TOKENS)
    # fused against unfused int8, teacher-forced over the fused stream:
    # JAX's bound for its kernel (tests/test_fused_decode.py:62-63)
    stream = torch.cat([prompt, toks], dim=1)
    fused = teacher_forced(model, stream, plen, chunks)
    unfused = teacher_forced(model, stream, plen)
    rel = ((fused - unfused).abs().amax(dim=-1)
           / unfused.abs().amax(dim=-1)).max().item()
    agree = (fused.argmax(-1) == unfused.argmax(-1)).float().mean().item()
    n_prof = 16
    prof = {"fused": per_token_profile(
                lambda: fused_decode.fused_generate(model, prompt, n_prof),
                n_prof),
            "int8_unfused": per_token_profile(
                lambda: generate(model, prompt, n_prof), n_prof)}
    in_vocab = bool(((toks >= 0) & (toks < model.vocab_size)).all())
    ok = (launches == GENERATE_TOKENS - 1 and in_vocab
          and tuple(toks.shape) == (1, GENERATE_TOKENS)
          and torch.equal(toks, again) and rel < 0.05
          and fused_cli["tokens"] == int8_cli["tokens"] == GENERATE_TOKENS)
    log("fused_generate", prompt_tokens=plen, new_tokens=GENERATE_TOKENS,
        chunks=chunks, k8_launches=launches,
        expected_launches=GENERATE_TOKENS - 1, wall_ms=wall * 1e3,
        tok_per_s=GENERATE_TOKENS / wall, repeat_identical=torch.equal(
            toks, again), teacher_forced_rel=rel,
        teacher_forced_argmax_agree=agree, cli_fused=fused_cli,
        cli_int8=int8_cli, profile=prof, ok=ok)
    if not ok:
        raise AssertionError("fused_generate failed its checks")
    results["fused_generate_launches"] = launches
    del model
    torch.cuda.empty_cache()


# -- phase 15 -----------------------------------------------------------------

FUSED_SERVING = dict(quant_weights=True, decode_path="fused",
                     max_batch_size=2, num_blocks=512, block_size=16,
                     chunk_size=256)


def fused_traffic(model, seed, **engine_kw):
    """4 requests of 128-token prompts, admitted in pairs (equal lengths:
    every decode step lockstep), then 2 of 150 and 200 tokens (ragged
    offsets: standard decode steps, and 256-token chunks whose 512-row
    mixed steps take K3); 64 greedy tokens each. Returns (engine, rids)."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, seed=seed, device=model.device,
                             **FUSED_SERVING, **engine_kw)
    rng = np.random.default_rng(seed)
    rids = [engine.submit(rng.integers(0, model.vocab_size, n), 64)
            for n in (128, 128, 128, 128, 150, 200)]
    engine.run_until_complete()
    return engine, rids


def phase_serving_fused(results):
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops import decode_stack as ds
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops import quant_matmul as qm
    from tnn_tpu_torch.ops.quant_matmul import W8A8_MAX_ROWS
    from tnn_tpu_torch.serving.engine import InferenceEngine
    from tnn_tpu_torch.serving.scheduler import RequestState

    model = zoo.create("gpt2_small", device="cuda", seed=0)
    fused_traffic(model, seed=1)                                 # warm-up
    real = InferenceEngine._mixed_standard
    wide = [0]

    def mixed_standard(self, toks, *a):
        wide[0] += toks.numel() > W8A8_MAX_ROWS
        return real(self, toks, *a)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ds.fused_decode_stack.launches = 0
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    qm.int8_matmul.launches = 0
    InferenceEngine._mixed_standard = mixed_standard
    t0 = time.perf_counter()
    try:
        engine, rids = fused_traffic(model, seed=0)
    finally:
        InferenceEngine._mixed_standard = real
    wall = time.perf_counter() - t0
    k8, k3 = ds.fused_decode_stack.launches, qm.int8_matmul.launches
    k1, k2 = pa.paged_attention.launches, pa.paged_attention.int8_launches
    stats = engine.stats()
    steps = stats["program_steps"]
    bad = [r for r in rids if engine.result(r).state
           is not RequestState.FINISHED
           or len(engine.result(r).out_tokens) != 64]
    want_k3 = 4 * model.num_layers * wide[0]
    exact, total, worst = closeness_gate(model, engine, rids)
    ok = (not bad and k8 == steps.get("fdecode", 0) > 0
          and steps.get("decode", 0) > 0 and k1 == k2 == 0
          and k3 == want_k3 and wide[0] > 0
          and stats["decode_path"] == "fused"
          and exact >= 0.75 * total and worst < 0.25)
    log("serving_fused", requests=len(rids), finished=len(rids) - len(bad),
        chunks=engine._fused["chunks"], assembly_len=engine.assembly_len,
        program_steps=steps, k8_launches=k8, wide_steps=wide[0],
        k3_launches=k3, expected_k3=want_k3, k1_launches=k1,
        k2_launches=k2, wall_s=wall, ttft_ms_p50=stats["ttft_ms_p50"],
        ttft_ms_p95=stats["ttft_ms_p95"],
        decode_tok_per_s=stats["tok_per_s"],
        step_ms_mean=stats["step_latency_ms_mean"], steps=stats["steps"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        argmax_positions=exact, positions=total, worst_margin=worst, ok=ok)
    if not ok:
        raise AssertionError(f"fused serving failed its checks: {bad}")
    results["fused_launches"] = k8
    engine.check_invariants()
    del engine
    # steady decode at two rows: the fused path, the paged path on the same
    # int8 weights, and the int8 pool's paged path
    profile_decode_steps(model, phase="serving_fused_profile", batch=2,
                         **{k: FUSED_SERVING[k] for k in
                            ("quant_weights", "decode_path")})
    profile_decode_steps(model, phase="serving_fused_profile_paged_beside",
                         batch=2, quant_weights=True)
    profile_decode_steps(model, phase="serving_fused_profile_int8_beside",
                         batch=2, **INT8_SERVING)
    del model
    torch.cuda.empty_cache()
    def fused_summary(proc):
        summary = json.loads(proc.stderr.split("serve summary: ")[1])
        if summary["decode_path"] != "fused":
            raise AssertionError(f"CLI summary: {summary}")

    cli_check(("--quant-weights", "--decode-path", "fused",
               "--max-batch-size", "2"), then=fused_summary)


# -- phase 16 -----------------------------------------------------------------
#
# K1s (the paged kernels with return_stats) against the plain stats version
# (``paged_attention_reference(..., return_stats=True)``), element by
# element. out: K1's and K2's limits above (both normalize once, at the
# end). m: both take the max of the same f32 scores summed in another order,
# each within a few ulps of sum_d |q_d k_d| scale (about 7 at Dh 128 and
# N(0, 1) inputs: 1e-6), so |m - m_ref| <= 1e-5 (1 + |m_ref|). l =
# sum_j exp(s_j - m) moves by the error of s_j - m (2e-5 relative at most)
# and one rounding per page rescale (at most 63 pages: 4e-6), so |l - l_ref|
# <= 1e-4 l_ref. A row with no live key (kv_len 0, a padding token, every
# block a -1 hole) must read exactly (0, -1e30, 0), and only those rows.
#
# The merge check splits each row's blocks round-robin over 2 and over 4
# tables (-1 where another table holds the block, as the SP pool's local
# tables), runs K1s on each and combines the partials with
# ``softmax_merge.merge_shards``, against unsharded K1 (K2 over int8
# pages). Each side lies within K1's limit of the exact value, so the two
# lie within twice it: (1e-4, 2^-6) in bf16, (2e-5, 2e-5) in f32.
STATS_M_TOL = 1e-5
STATS_L_TOL = 1e-4
MERGE_TOLERANCE = {"float32": (2e-5, 2e-5), "bfloat16": (1e-4, 2 ** -6)}


def stats_cases():
    """{name: (int8 pages, paged_case spec, row made all -1 holes)}: both
    page types, bf16 and f32, decode (3-D q) and ragged chunks of up to 16
    tokens, Dh 64 and 128, block sizes 4 to 32, GQA, holes, a kv_len-0
    row, padding tokens and a q_len-0 row."""
    import torch

    decode_kv = [0, 17, 512, 1, 333, 499, 64, 510]
    ragged_q = [16, 16, 9, 16, 1, 1, 3, 0]
    ragged_kv = [16, 448, 980, 704, 513, 100, 3, 40]
    cases = {}
    for quant in (False, True):
        kind = "int8" if quant else "pages"
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            for bs in (4, 16, 32):
                mha = dict(heads=12, kv_heads=12, head_dim=64, block_size=bs,
                           dtype=dtype, holes=True)
                cases[f"{kind}_decode_{dn}_bs{bs}"] = (quant, dict(
                    decode_form=True, q_lens=[1] * 8, kv_lens=decode_kv,
                    **mha), 3)
                cases[f"{kind}_ragged_{dn}_bs{bs}"] = (quant, dict(
                    decode_form=False, q_lens=ragged_q, kv_lens=ragged_kv,
                    **mha), 5)
            cases[f"{kind}_ragged_gqa4_{dn}"] = (quant, dict(
                decode_form=False, q_lens=ragged_q, kv_lens=ragged_kv,
                heads=12, kv_heads=4, head_dim=64, block_size=16,
                dtype=dtype, holes=True), 5)
            cases[f"{kind}_decode_hd128_{dn}"] = (quant, dict(
                decode_form=True, q_lens=[1] * 8, kv_lens=decode_kv,
                heads=6, kv_heads=6, head_dim=128, block_size=8, dtype=dtype,
                holes=True), 3)
            cases[f"{kind}_ragged_hd128_{dn}"] = (quant, dict(
                decode_form=False, q_lens=ragged_q, kv_lens=ragged_kv,
                heads=6, kv_heads=6, head_dim=128, block_size=32,
                dtype=dtype), None)
    return cases


def split_tables(tables, n):
    """Round-robin split of block tables over ``n`` shards: shard s keeps
    positions j % n == s, -1 elsewhere."""
    import torch

    pos = torch.arange(tables.shape[1], device=tables.device)
    return [torch.where(pos % n == s, tables, -1).contiguous()
            for s in range(n)]


def stats_check(name, quant, spec, args):
    """One K1s case against the plain stats version, then the 2- and
    4-way merge against unsharded K1 / K2. Returns the reading."""
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops.softmax_merge import merge_shards

    counter = "int8_stats_launches" if quant else "stats_launches"
    before = getattr(pa.paged_attention, counter)
    out, m, l = pa.paged_attention(**args, return_stats=True)  # noqa: E741
    torch.cuda.synchronize()
    if getattr(pa.paged_attention, counter) != before + 1:
        raise AssertionError(f"stats {name}: K1s did not launch")
    ref, m_ref, l_ref = pa.paged_attention_reference(**args,
                                                     return_stats=True)
    v = args["pages_v"]
    abs_v = pa.QuantPages(v.data.abs(), v.scale) if quant else v.abs()
    ref_abs_v = pa.paged_attention_reference(
        **{**args, "pages_v": abs_v}).float()
    dt = str(spec["dtype"]).split(".")[-1]
    ref = ref.float()
    diff = (out.float() - ref).abs()
    if quant:
        atol, rtol = INT8_TOLERANCE[dt]
        limit = atol + rtol * ref.abs() + 1e-5 * ref_abs_v
    else:
        atol, rtol = TOLERANCE[dt]
        limit = atol + rtol * (ref.abs() + ref_abs_v)
    out_used = (diff / limit).max().item()
    dead = l_ref == 0
    live = ~dead
    m_used = ((m - m_ref).abs()[live]
              / (STATS_M_TOL * (1 + m_ref.abs()[live]))).max().item()
    l_used = ((l - l_ref).abs()[live]
              / (STATS_L_TOL * l_ref[live])).max().item()
    dead_exact = bool((m[dead] == -1e30).all() and (l[dead] == 0).all()
                      and (out.float()[dead.expand_as(out)] == 0).all()
                      and (l[live] > 0).all())
    # the merge over round-robin shards against the unsharded kernel
    base = pa.paged_attention(**args).float()
    matol, mrtol = MERGE_TOLERANCE[dt]
    merge_used = {}
    for n in (2, 4):
        parts = [pa.paged_attention(**{**args, "block_tables": t},
                                    return_stats=True)
                 for t in split_tables(args["block_tables"], n)]
        merged = merge_shards(*zip(*parts)).float()
        mlimit = matol + mrtol * (base.abs() + ref_abs_v)
        merge_used[n] = ((merged - base).abs() / mlimit).max().item()
    used = [out_used, m_used, l_used, *merge_used.values()]
    ok = all(math.isfinite(u) and u <= 1.0 for u in used) and dead_exact \
        and int(dead.sum()) > 0
    reading = dict(case=name, splits=paged_splits(args),
                   max_abs_err=diff.max().item(),
                   out_limit_used=out_used,
                   m_max_abs_err=(m - m_ref).abs()[live].max().item(),
                   m_limit_used=m_used,
                   l_max_rel_err=((l - l_ref).abs()[live]
                                  / l_ref[live]).max().item(),
                   l_limit_used=l_used, dead_rows=int(dead.sum()),
                   dead_exact=dead_exact, merge2_limit_used=merge_used[2],
                   merge4_limit_used=merge_used[4], ok=ok)
    log("paged_stats", **reading)
    if not ok:
        raise AssertionError(f"paged_attention stats {name} failed: "
                             f"{reading}")
    return reading


def phase_paged_stats(results):
    import torch
    import torch.nn.functional as F

    from tnn_tpu_torch.ops import paged_attention as pa

    worst = {False: 0.0, True: 0.0}
    for i, (name, (quant, spec, hole_row)) in enumerate(
            stats_cases().items()):
        make = quant_case if quant else paged_case
        args = make(500 + i, batch=8, **spec)
        if hole_row is not None:   # a live row whose blocks are all holes
            args["block_tables"][hole_row] = -1
        reading = stats_check(name, quant, spec, args)
        worst[quant] = max(worst[quant], reading["max_abs_err"])

    # time at the serving decode shape (gpt2_small heads, 8 rows, kv 500,
    # bf16): K1s beside K1 (K2 over int8 pages) in one call
    shape = dict(decode_form=True, q_lens=[1] * 8, kv_lens=[500] * 8,
                 heads=12, kv_heads=12, head_dim=64, block_size=16,
                 dtype=torch.bfloat16)
    for quant, key in ((False, "paged_attention_stats"),
                       (True, "paged_attention_int8_stats")):
        args = (quant_case if quant else paged_case)(7, batch=8, **shape)
        nbytes, ops = paged_work(args)
        q = args["q"]
        nbytes += 2 * 4 * q.shape[0] * q.shape[-2]   # m and l, f32
        bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                             ops / PEAK_OPS["bfloat16"])
        sq, sk, sv, smask, gqa = sdpa_inputs(dequant_args(args) if quant
                                             else args)
        runs = {"": lambda: pa.paged_attention(**args, return_stats=True),
                "nostats_": lambda: pa.paged_attention(**args),
                "plain_": lambda: pa.paged_attention_reference(
                    **args, return_stats=True),
                "library_": lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=smask, enable_gqa=gqa)}
        timed = {"splits": paged_splits(args)}
        for prefix, fn in runs.items():
            device, events, per_name = time_ms(fn)
            timed[prefix + "ms"] = events if device is None else device
            timed[prefix + "events_ms"] = events
            if prefix == "":   # the call's time by kernel
                timed["split_ms"] = {kernel_label(n): v
                                     for n, v in per_name.items()}
        timed.update(bound_ms=bound_ms, bytes=nbytes, ops=ops,
                     bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                     >= ops / PEAK_OPS["bfloat16"] else "operations")
        log("paged_stats_time", kernel=key, **timed)
        results[key] = dict(max_abs_err=worst[quant], **timed)
    # comparison launches do not count
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    pa.paged_attention.stats_launches = 0
    pa.paged_attention.int8_stats_launches = 0


# -- phase 17 -----------------------------------------------------------------
#
# Sequence-parallel serving of full-width gpt2_small at sp = 2, both shards
# on the one card (sp_devices cuda:0 twice: every SP code path, K1s
# included, without a second card). Limits:
# * teacher-forced mixed-step logits, sp = 2 against sp = 1 on the same KV
#   (a ragged step of prompt chunks and decode rows): under FP32 the only
#   difference is the reassociated softmax, about an ulp a layer, so 1e-4
#   of max|logit| (the FP32 kernel-vs-plain bound of phase 4); in bf16 each
#   shard rounds its partial output to bf16 before the merge, as K1 rounds
#   its own, so the kernel-vs-plain bf16 bound, 3e-2 of max|logit|;
# * greedy streams: identical to sp = 1's, or differing first at a token
#   where either engine's top-2 logit gap is below the near-tie bound: 1e-3,
#   or twice the largest bf16 logit difference the teacher-forced check
#   read, where that is larger (a flip needs the gap below the difference).
SP_DEVICES = ["cuda:0", "cuda:0"]
SP_LOGIT_TOL = {"fp32": 1e-4, "bf16": 3e-2}
NEAR_TIE = 1e-3


def gap_engine_class():
    """An InferenceEngine that keeps, per request, every emitted token's
    top-2 logit gap (the engine's own logits). It reads each step's logits
    on the host, which a graph replay does not expose, so its pdecode
    steps run eagerly."""
    from tnn_tpu_torch.serving.engine import InferenceEngine

    class GapEngine(InferenceEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gaps = {}
            self._eager_steps = True

        def _build(self, chunks, events):
            rec = super()._build(chunks, events)
            if rec is not None:
                self._rows = [r.rid for r in rec.get("rows",
                                                     rec.get("live"))]
            return rec

        def _sample(self, logits, step):
            top2 = logits.float().topk(2, dim=-1).values
            self._gap = (top2[:, 0] - top2[:, 1]).cpu()
            return super()._sample(logits, step)

        def step(self):
            events = super().step()
            for rid, _ in events["tokens"]:
                self.gaps.setdefault(rid, []).append(
                    float(self._gap[self._rows.index(rid)]))
            return events

    return GapEngine


def streams_agree(eng_a, rids_a, eng_b, rids_b, tie):
    """Greedy streams of two engines: (equal streams, near-tie
    divergences); raises on a divergence at a token whose gap is >= tie in
    both engines."""
    equal = flips = 0
    for ra, rb in zip(rids_a, rids_b):
        a, b = eng_a.result(ra).out_tokens, eng_b.result(rb).out_tokens
        if a == b:
            equal += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = min(eng_a.gaps[ra][i], eng_b.gaps[rb][i])
        if gap >= tie:
            raise AssertionError(f"greedy streams differ at token {i} with "
                                 f"top-2 gap {gap} >= {tie}: {a} vs {b}")
        flips += 1
    return equal, flips


def sp_logits_check(model, seed, tol, kv_dtype="f32"):
    """One ragged mixed step through the SP adapter over two shards of a
    pool, then through the model over the same KV laid out as one pool
    (the shards' pages side by side: global id = shard * N_l + local row).
    Returns the max |logit difference| over live positions; fails past
    ``tol`` of the largest logit."""
    import numpy as np
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving import step_build
    from tnn_tpu_torch.serving.kv_pool import PagedKVPool
    from tnn_tpu_torch.serving.sp import SPContext

    dev = model.device
    bs, b, qw = 16, 8, 64
    starts = np.array([0, 0, 130, 700, 37, 512, 959, 3], np.int32)
    q_lens = np.array([64, 17, 64, 40, 1, 1, 1, 0], np.int32)
    ctx = SPContext(model, 2, devices=SP_DEVICES)
    pool = PagedKVPool(model.num_layers, model.num_kv_heads,
                       model.d_model // model.num_heads, 1200, bs,
                       model.policy.compute_dtype, dev, kv_dtype=kv_dtype,
                       sp=2, devices=ctx.devices)
    nb = pool.blocks_for(model.max_len)
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        blocks = pool.alloc(pool.blocks_for(starts[i] + q_lens[i]))
        tables[i, :len(blocks)] = blocks
    gen = torch.Generator(device=dev).manual_seed(seed)
    for pages in pool.pages_k + pool.pages_v:   # the rows' earlier KV
        if kv_dtype == "int8":
            data, scale = pa.quantize_kv_rows(torch.randn(
                pages.data.shape, generator=gen, device=dev))
            pages.data.copy_(data)
            pages.scale.copy_(scale)
        else:
            pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))

    def joined(side):   # the shards' pages as one (L, N, ...) pool
        if kv_dtype == "int8":
            return pa.QuantPages(torch.cat([p.data for p in side], 1),
                                 torch.cat([p.scale for p in side], 1))
        return torch.cat(side, 1)

    one_k, one_v = joined(pool.pages_k), joined(pool.pages_v)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, model.vocab_size, (b, qw),
                                         dtype=np.int32)).to(dev)
    put = [torch.from_numpy(x).to(dev) for x in (tables, starts, q_lens)]
    local = [torch.from_numpy(t).to(dev) for t in step_build.shard_tables(
        tables, 2, pool.blocks_per_shard)]
    with torch.inference_mode():
        counts = (pa.paged_attention.stats_launches,
                  pa.paged_attention.int8_stats_launches)
        sharded = ctx.model.apply_paged(toks, pool.pages_k, pool.pages_v,
                                        local, put[1], put[2])
        after = (pa.paged_attention.stats_launches,
                 pa.paged_attention.int8_stats_launches)
        single = model.apply_paged(toks, one_k, one_v, *put)
    want = 2 * model.num_layers
    if sum(after) - sum(counts) != want:
        raise AssertionError(f"SP mixed step launched K1s "
                             f"{sum(after) - sum(counts)} times, want {want}")
    live = torch.arange(qw, device=dev)[None, :] < put[2][:, None]
    diff = (sharded - single).abs()[live].max().item()
    scale = single[live].abs().max().item()
    ok = math.isfinite(diff) and diff <= tol * scale
    log("serving_sp_logits", policy=model.policy.compute, kv_dtype=kv_dtype,
        max_abs_err=diff, max_abs_logit=scale, tolerance=tol * scale, ok=ok)
    if not ok:
        raise AssertionError(f"SP mixed-step logits against sp=1: {diff} > "
                             f"{tol * scale}")
    return diff


def sp_traffic(model, seed, num_requests=8, new_tokens=64, **engine_kw):
    """``serve_traffic`` on the gap-recording engine."""
    import numpy as np

    engine = gap_engine_class()(model, num_blocks=512, block_size=16,
                                max_batch_size=8, chunk_size=64, seed=seed,
                                device=model.device, **engine_kw)
    rng = np.random.default_rng(seed)
    rids = []
    for i in range(num_requests):
        prompt = rng.integers(0, model.vocab_size, int(rng.integers(16, 769)))
        sampled = i % 2 == 1
        rids.append(engine.submit(
            prompt, new_tokens, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 0.0))
    engine.run_until_complete()
    return engine, rids


def pool_shard_bytes(pool):
    """Bytes of one shard's K and V pages (and scales)."""
    from tnn_tpu_torch.ops.paged_attention import QuantPages

    total = 0
    for p in pool.shard_pages()[0]:
        for t in (p if isinstance(p, QuantPages) else (p,)):
            total += t.numel() * t.element_size()
    return total


def sp_run(model, tie, label, **kw):
    """sp = 1 then sp = 2 over the serving traffic; launch counts of the
    sp = 2 run (counts set to 0 just before it, read just after), its
    streams against sp = 1's. Returns the sp = 2 launch counts."""
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving.scheduler import RequestState

    eng1, rids1 = sp_traffic(model, seed=0, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    pa.paged_attention.stats_launches = 0
    pa.paged_attention.int8_stats_launches = 0
    t0 = time.perf_counter()
    eng2, rids2 = sp_traffic(model, seed=0, sp=2, sp_devices=SP_DEVICES,
                             **kw)
    wall = time.perf_counter() - t0
    counts = {"k1": pa.paged_attention.launches,
              "k2": pa.paged_attention.int8_launches,
              "k1s": pa.paged_attention.stats_launches,
              "k1s_int8": pa.paged_attention.int8_stats_launches}
    stats = eng2.stats()
    paged_steps = sum(stats["program_steps"].get(k, 0)
                      for k in ("mixed", "pdecode"))
    quant = kw.get("kv_dtype") == "int8"
    want = {"k1": 0, "k2": 0,
            "k1s": 0 if quant else 2 * model.num_layers * paged_steps,
            "k1s_int8": 2 * model.num_layers * paged_steps if quant else 0}
    bad = [r for r in rids2 if eng2.result(r).state
           is not RequestState.FINISHED
           or len(eng2.result(r).out_tokens) != 64]
    greedy = [i for i in range(len(rids2)) if i % 2 == 0]
    equal, flips = streams_agree(eng1, [rids1[i] for i in greedy], eng2,
                                 [rids2[i] for i in greedy], tie)
    ok = (not bad and counts == want and paged_steps > 0
          and stats["sp_degree"] == 2
          and stats["pool_blocks_per_shard"] == 256)
    log("serving_sp", run=label, requests=len(rids2),
        finished=len(rids2) - len(bad), model_steps=eng2.model_steps,
        program_steps=stats["program_steps"], launches=counts,
        expected=want, greedy_equal=equal, greedy_near_tie_flips=flips,
        near_tie=tie, wall_s=wall, ttft_ms_p50=stats["ttft_ms_p50"],
        ttft_ms_p95=stats["ttft_ms_p95"],
        decode_tok_per_s=stats["tok_per_s"],
        step_ms_mean=stats["step_latency_ms_mean"],
        sp1_step_ms_mean=eng1.stats()["step_latency_ms_mean"],
        preemptions=stats["preemptions"],
        pool_bytes_per_shard=pool_shard_bytes(eng2.pool),
        pool_bytes_sp1=pool_shard_bytes(eng1.pool),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, ok=ok)
    if not ok:
        raise AssertionError(f"SP serving {label}: launches {counts} (want "
                             f"{want}), unfinished {bad}, stats {stats}")
    eng2.check_invariants()
    return counts


def phase_serving_sp(results):
    import numpy as np
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving.engine import InferenceEngine

    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    sp_logits_check(fp32, seed=4, tol=SP_LOGIT_TOL["fp32"])
    del fp32
    torch.cuda.empty_cache()
    model = zoo.create("gpt2_small", device="cuda", seed=0)
    worst = max(sp_logits_check(model, seed=3, tol=SP_LOGIT_TOL["bf16"]),
                sp_logits_check(model, seed=5, tol=SP_LOGIT_TOL["bf16"],
                                kv_dtype="int8"))
    tie = max(NEAR_TIE, 2 * worst)
    sp_traffic(model, seed=1, num_requests=2, new_tokens=4, sp=2,
               sp_devices=SP_DEVICES)                            # warm-up

    # (a) the capability gate: a 900-token prompt on one shard's footprint
    # (32 blocks of 16) is refused at sp = 1 and serves at sp = 2 on 64
    rng = np.random.default_rng(11)
    long_prompt = rng.integers(0, model.vocab_size, 900)
    gate = dict(block_size=16, max_batch_size=8, chunk_size=64,
                device=model.device)
    refused = ""
    try:
        InferenceEngine(model, num_blocks=32, **gate).submit(long_prompt, 16)
    except ValueError as e:
        refused = str(e)
    gap_engine = gap_engine_class()
    eng_sp = gap_engine(model, num_blocks=64, sp=2, sp_devices=SP_DEVICES,
                        **gate)
    eng_ref = gap_engine(model, num_blocks=512, **gate)
    rid_sp, rid_ref = (e.submit(long_prompt, 16) for e in (eng_sp, eng_ref))
    for e in (eng_sp, eng_ref):
        e.run_until_complete()
    equal, flips = streams_agree(eng_ref, [rid_ref], eng_sp, [rid_sp], tie)
    ok = ("exceeds" in refused and eng_sp.pool.blocks_per_shard == 32
          and len(eng_sp.result(rid_sp).out_tokens) == 16)
    log("serving_sp_gate", prompt=len(long_prompt), sp1_refusal=refused,
        sp2_blocks_per_shard=eng_sp.pool.blocks_per_shard,
        sp2_max_seq_len=eng_sp.max_seq_len, tokens=len(
            eng_sp.result(rid_sp).out_tokens), equal_to_sp1_big_pool=equal,
        near_tie_flips=flips, ok=ok)
    if not ok:
        raise AssertionError(f"SP capability gate: {refused!r}")
    del eng_sp, eng_ref

    # (b) parity on the bf16 pool, (c) on the int8 pool; greedy streams
    # under FP32 too, where a flip needs a gap below 1e-3
    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    sp_run(fp32, NEAR_TIE, "fp32_model")
    del fp32
    torch.cuda.empty_cache()
    launches = sp_run(model, tie, "bf16_pool")
    launches_int8 = sp_run(model, tie, "int8_pool", kv_dtype="int8")
    results["sp_launches"] = {"stats": launches["k1s"],
                              "int8_stats": launches_int8["k1s_int8"]}

    # (d) a few steps of the standard path at sp = 2
    std = gap_engine_class()
    engines = [std(model, num_blocks=512, block_size=16, max_batch_size=8,
                   chunk_size=64, decode_path="standard",
                   device=model.device, **kw)
               for kw in ({}, dict(sp=2, sp_devices=SP_DEVICES))]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.vocab_size, n) for n in (40, 300)]
    before = pa.paged_attention.stats_launches
    rids = [[e.submit(p, 8) for p in prompts] for e in engines]
    for e in engines:
        e.run_until_complete()
    equal, flips = streams_agree(engines[0], rids[0], engines[1], rids[1],
                                 tie)
    steps = engines[1].stats()["program_steps"]
    ok = (engines[1].stats()["decode_path"] == "standard"
          and steps.get("decode", 0) > 0
          and pa.paged_attention.stats_launches == before)
    log("serving_sp_standard", program_steps=steps, greedy_equal=equal,
        near_tie_flips=flips, ok=ok)
    if not ok:
        raise AssertionError(f"SP standard path: {steps}")
    engines[1].check_invariants()
    del engines

    # steady decode at 8 rows, kv 500: sp = 1 and sp = 2 in alternating
    # windows (the host's speed moves within a process), then each path's
    # profile
    sp2 = dict(sp=2, sp_devices=SP_DEVICES)
    host_ab(model, phase="serving_sp_host_ab",
            paths={"sp1": {}, "sp2": sp2})
    profile_decode_steps(model, phase="serving_sp_profile", **sp2)
    profile_decode_steps(model, phase="serving_sp_profile_sp1_beside")
    del model
    torch.cuda.empty_cache()
    cli_check(("--sp", "2", "--sp-devices", ",".join(SP_DEVICES)))


# -- phase 18 -----------------------------------------------------------------
#
# The prefix cache and speculative decoding at gpt2_small's width (bf16 pool
# of 512 x 16-token blocks, 8 rows, 64-token chunks). A cache hit skips
# prefill but not exactness: a sharer's tail chunk starts at position 512
# in both runs (512 is a whole number of chunks). A verify row is a chunk
# where spec-off runs a decode row, so the step's q width, and with it K1's
# split plan and summation order, differs between the runs; under bf16 a
# near-tie may flip. So FP32 runs must be token-exact on every prompt whose
# cache-off stream is tie-free (each token its position's argmax in the
# model's own forward, beating the runner-up by more than NEAR_TIE); bf16
# runs report the share of equal tokens and fail on a divergence whose
# top-2 gap is above SPEC_FLIP_GAP.
PREFIX_LEN = 512
SPEC_FLIP_GAP = 1e-2
K1_VERIFY_KV = [100, 1000, 517, 333, 768, 250, 904, 640]


def shared_prefix_prompts(vocab, seed=21):
    """One 512-token system prefix, then 8 distinct tails of 16-64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, PREFIX_LEN)
    return [np.concatenate([prefix, rng.integers(0, vocab, int(n))])
            for n in rng.integers(16, 65, 8)]


def cyclic_prompts(vocab, seed=22):
    """8 prompts of 96 tokens, each a 3-token pattern repeated."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, vocab, 3), 32) for _ in range(8)]


def reset_launches():
    from tnn_tpu_torch.ops import decode_stack as ds
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops import quant_matmul as qm

    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    pa.paged_attention.stats_launches = 0
    pa.paged_attention.int8_stats_launches = 0
    qm.int8_matmul.launches = ds.fused_decode_stack.launches = 0


def read_launches():
    from tnn_tpu_torch.ops import decode_stack as ds
    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.ops import quant_matmul as qm

    return {"k1": pa.paged_attention.launches,
            "k2": pa.paged_attention.int8_launches,
            "k1s": pa.paged_attention.stats_launches,
            "k1s_int8": pa.paged_attention.int8_stats_launches,
            "k3": qm.int8_matmul.launches,
            "k8": ds.fused_decode_stack.launches}


def prefix_spec_run(model, prompts, stagger=False, **kw):
    """One engine over ``prompts`` (64 greedy tokens each), launches
    counted over it alone. ``stagger``: the first prompt steps until its
    512-token prefix is resident (and, with the cache on, published), then
    the other seven join. Returns (engine, rids, wall seconds, launches,
    wide mixed steps)."""
    import torch

    from tnn_tpu_torch.serving.engine import InferenceEngine

    cfg = dict(num_blocks=512, block_size=16, max_batch_size=8,
               chunk_size=64)
    engine = InferenceEngine(model, device=model.device, **{**cfg, **kw})

    def drive():
        rids = [engine.submit(prompts[0], 64)]
        if stagger:
            while engine.result(rids[0]).cache_len < PREFIX_LEN:
                engine.step()
        rids += [engine.submit(p, 64) for p in prompts[1:]]
        engine.run_until_complete()
        return rids

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rids, wide = count_wide_steps(drive)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    engine.check_invariants()
    return engine, rids, wall, launches, wide


def expected_launches(model, engine, wide):
    """K1 (K2 on an int8 pool) = layers x paged model steps, K1s = shards
    x that under SP; K3 = 49 x mixed steps of more than 256 rows; K8 = the
    fused path's lockstep steps."""
    st = engine.stats()
    steps = st["program_steps"]
    paged = sum(steps.get(k, 0) for k in ("mixed", "pdecode", "spec"))
    per = model.num_layers * paged * st["sp_degree"]
    quant = st["kv_dtype"] == "int8"
    sp = st["sp_degree"] > 1
    return {"k1": 0 if quant or sp else per,
            "k2": per if quant and not sp else 0,
            "k1s": per if sp and not quant else 0,
            "k1s_int8": per if sp and quant else 0,
            "k3": (4 * model.num_layers + 1) * wide if st["quant_weights"]
            else 0,
            "k8": steps.get("fdecode", 0)}


def emitted_gaps(model, prompt, out):
    """(top-2 logit gap, argmax) at each emitted token of ``out``, from
    the model's own forward over prompt + out."""
    import numpy as np
    import torch

    seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
    with torch.inference_mode():
        logits = model(torch.from_numpy(seq).to(model.device)[None])[
            0, len(prompt) - 1:].float()
    top2 = logits.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist(), logits.argmax(-1).tolist()


def compare_streams(model, prompts, ref, got, gate):
    """Greedy streams of a run against its reference run: the share of
    equal tokens and each divergence's top-2 gap in the model's forward
    over the common prefix. ``gate`` "exact" (FP32): token for token on
    every prompt whose reference stream is tie-free at NEAR_TIE; "flip"
    (bf16): no divergence at a gap above SPEC_FLIP_GAP; "report": none
    (paths whose numerics differ by design). Raises on a breach."""
    equal = total = tie_free = 0
    flips = []
    for p, a, b in zip(prompts, ref, got):
        a, b = list(a), list(b)
        total += len(a)
        equal += sum(x == y for x, y in zip(a, b))
        if gate == "exact":
            gaps, arg = emitted_gaps(model, p, a)
            if min(gaps) > NEAR_TIE and arg == a:
                tie_free += 1
                if a != b:
                    raise AssertionError(f"FP32 stream differs on a "
                                         f"tie-free prompt: {a} vs {b}")
        if a != b:
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            flips.append(emitted_gaps(model, p, a[:i + 1])[0][i])
            if gate == "flip" and flips[-1] > SPEC_FLIP_GAP:
                raise AssertionError(f"bf16 stream differs at token {i} "
                                     f"with top-2 gap {flips[-1]}")
    return {"equal_share": equal / max(total, 1), "tie_free_prompts":
            tie_free if gate == "exact" else None,
            "divergence_gaps": flips}


def run_fields(model, engine, rids, wall, launches, wide):
    """One run's log fields; raises unless every request finished with 64
    tokens and the launches are the expected ones."""
    from tnn_tpu_torch.serving.scheduler import RequestState

    st = engine.stats()
    want = expected_launches(model, engine, wide)
    bad = [r for r in rids if engine.result(r).state
           is not RequestState.FINISHED
           or len(engine.result(r).out_tokens) != 64]
    if bad or launches != want:
        raise AssertionError(f"unfinished {bad}; launches {launches}, "
                             f"want {want}; {st['program_steps']}")
    return dict(wall_s=wall, model_steps=engine.model_steps,
                program_steps=st["program_steps"], launches=launches,
                prefill_tokens=st["prefill_tokens"],
                prefill_tokens_saved=st["prefill_tokens_saved"],
                prefix_cows=st["prefix_cows"],
                prefix_hit_rate=st["prefix_hit_rate"],
                decode_tok_per_s=st["tok_per_s"],
                step_ms_mean=st["step_latency_ms_mean"],
                spec_acceptance_rate=st["spec_acceptance_rate"],
                mean_accepted_per_step=st["mean_accepted_per_step"],
                pool_evictable_blocks=st["pool_evictable_blocks"])


def sharer_ttft(engine, rids):
    ttft = sorted(engine.result(r).ttft_s * 1e3 for r in rids[1:])
    return {"sharer_ttft_ms_p50": ttft[len(ttft) // 2],
            "sharer_ttft_ms_p95": ttft[-1]}


def k1_verify_check(results):
    """K1 at the spec verify shape (8 rows of q_len 5, kv 100-1000) in bf16
    and f32, MHA and GQA 4, against its plain version, and timed beside
    SDPA and the bound; then K2 over pages copy_blocks cloned: the clone's
    table gives the source's output bit for bit."""
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving import kv_pool

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for kv_heads in (12, 4):
            spec = dict(decode_form=False, q_lens=[5] * 8,
                        kv_lens=K1_VERIFY_KV, dtype=dtype, heads=12,
                        kv_heads=kv_heads, head_dim=64, block_size=16)
            name = f"verify_{'mha' if kv_heads == 12 else 'gqa4'}_" \
                f"{str(dtype).split('.')[-1]}"
            worst = max(worst, paged_check(
                name, spec, paged_case(500 + kv_heads, batch=8, **spec),
                phase="kernel_verify"))
    spec = dict(decode_form=False, q_lens=[5] * 8, kv_lens=K1_VERIFY_KV,
                dtype=torch.bfloat16, heads=12, kv_heads=12, head_dim=64,
                block_size=16)
    timed = paged_timing(paged_case(7, batch=8, **spec))
    log("kernel_verify_time", case="verify_mha_bfloat16", **timed)

    args = quant_case(511, batch=8, **spec)
    tables = args["block_tables"]
    row = tables[1]                       # kv 1000: 63 blocks
    used = set(tables.flatten().tolist())
    spare = [b for b in range(args["pages_k"].data.shape[1])
             if b not in used][:8]
    src = row[:len(spare)].tolist()
    for pages in (args["pages_k"], args["pages_v"]):
        kv_pool.copy_blocks(pages, src, spare)
    cloned = tables.clone()
    cloned[1, :len(spare)] = torch.tensor(spare, device=tables.device)
    before = pa.paged_attention.int8_launches
    out = pa.paged_attention(**args)
    out_clone = pa.paged_attention(**{**args, "block_tables": cloned})
    torch.cuda.synchronize()
    ref = pa.paged_attention_reference(**{**args, "block_tables": cloned})
    same = torch.equal(out, out_clone)
    atol, rtol = INT8_TOLERANCE["bfloat16"]
    v = args["pages_v"]
    ref_abs_v = pa.paged_attention_reference(**{
        **args, "pages_v": pa.QuantPages(v.data.abs(), v.scale)}).float()
    limit = atol + rtol * ref.float().abs() + 1e-5 * ref_abs_v
    used_limit = ((out_clone.float() - ref.float()).abs() / limit).max()
    ok = (same and pa.paged_attention.int8_launches == before + 2
          and used_limit.item() <= 1.0 and len(spare) == 8)
    log("kernel_verify_cow_int8", cloned_blocks=len(spare),
        identical_to_source=same, limit_used=used_limit.item(), ok=ok)
    if not ok:
        raise AssertionError("K2 over copy_blocks clones: identical "
                             f"{same}, limit used {used_limit.item()}")
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    return worst, timed


def phase_serving_prefix_spec(results):
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo

    k1_verify_check(results)
    model = zoo.create("gpt2_small", device="cuda", seed=0)
    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    vocab = model.vocab_size
    shared = shared_prefix_prompts(vocab)
    cyclic = cyclic_prompts(vocab)
    # warm-up: the whole traffic once, so no measured run pays the
    # process's first allocations and library handles
    prefix_spec_run(model, shared, stagger=True, prefix_cache=False)
    added = dict.fromkeys(("k1", "k2", "k3", "k1s", "k8"), 0)

    def run(*a, **kw):
        """A counted run: its launches join the kernels line's."""
        out = prefix_spec_run(*a, **kw)
        for k in added:
            added[k] += out[3][k]
        return out

    def ab(m, prompts, on_kw, off_kw, repeat=False, **kw):
        """Off, then on; with ``repeat`` on and off again (ABBA: the host's
        speed moves within a process). Returns the first on and off runs
        and each run's wall time and decode tokens/s."""
        off = run(m, prompts, **kw, **off_kw)
        on = run(m, prompts, **kw, **on_kw)
        runs = [("off", off), ("on", on)]
        if repeat:
            runs += [("on", run(m, prompts, **kw, **on_kw)),
                     ("off", run(m, prompts, **kw, **off_kw))]
        reads = {f"{side}_{name}": [r[0].stats()[key] if key else r[2]
                                   for s_, r in runs if s_ == side]
                 for side in ("on", "off")
                 for name, key in (("wall_s", None),
                                   ("tok_per_s", "tok_per_s"))}
        return on, off, reads

    # (a) shared-prefix traffic: cache on against off, bf16 and FP32
    for label, m in (("bf16", model), ("fp32", fp32)):
        on, off, reads = ab(m, shared, {}, dict(prefix_cache=False),
                            repeat=label == "bf16", stagger=True)
        outs = [[e.result(r).out_tokens for r in rids]
                for e, rids, *_ in (off, on)]
        cmp = compare_streams(m, shared, outs[0], outs[1],
                              "exact" if label == "fp32" else "flip")
        saved = on[0].stats()["prefill_tokens_saved"]
        ok = saved == 7 * PREFIX_LEN
        log("prefix_shared", run=label, expected_saved=7 * PREFIX_LEN,
            on={**run_fields(m, *on), **sharer_ttft(*on[:2])},
            off={**run_fields(m, *off), **sharer_ttft(*off[:2])}, **cmp,
            abba=reads, ok=ok)
        if not ok:
            raise AssertionError(f"prefill_tokens_saved {saved}, want "
                                 f"{7 * PREFIX_LEN}")
        if label == "bf16":
            # a full-cover hit: the prefix alone forks 31 blocks and clones
            # the last, which its recomputed last token writes into
            eng = on[0]
            paged = ("mixed", "pdecode")
            steps = sum(eng.program_steps[k] for k in paged)
            rid = eng.submit(shared[0][:PREFIX_LEN], 16)
            reset_launches()
            eng.run_until_complete()
            counts = read_launches()
            steps = sum(eng.program_steps[k] for k in paged) - steps
            if counts["k1"] != model.num_layers * steps:
                raise AssertionError(f"full-cover hit: K1 {counts['k1']} "
                                     f"over {steps} paged steps")
            for k in added:
                added[k] += counts[k]
            ref = run(model, [shared[0][:PREFIX_LEN]], prefix_cache=False)
            cow_cmp = compare_streams(
                model, [shared[0][:PREFIX_LEN]],
                [ref[0].result(ref[1][0]).out_tokens[:16]],
                [eng.result(rid).out_tokens], "flip")
            cows = eng.stats()["prefix_cows"]
            log("prefix_cow", prefix_cows=cows,
                prefill_tokens_saved=eng.stats()["prefill_tokens_saved"],
                **cow_cmp)
            if cows != 1:
                raise AssertionError("the full-cover hit did not clone")
        del on, off

    # the int8 pool and weights (K2, K3), and sp = 2 on one card (K1s)
    for label, kw in (("int8", INT8_SERVING),
                      ("sp2", dict(sp=2, sp_devices=SP_DEVICES))):
        on = run(model, shared, stagger=True, **kw)
        saved = on[0].stats()["prefill_tokens_saved"]
        log("prefix_shared", run=label, on={**run_fields(model, *on),
                                            **sharer_ttft(*on[:2])},
            ok=saved == 7 * PREFIX_LEN)
        if saved != 7 * PREFIX_LEN:
            raise AssertionError(f"{label}: prefill_tokens_saved {saved}")
        del on

    # (b) spec traffic: ngram against spec off on the paged and the fused
    # paths; one draft-model pass (a random drafter accepts about nothing:
    # exactness is its gate)
    draft = zoo.create("gpt2_tiny", vocab_size=vocab, max_len=model.max_len,
                       device="cuda", seed=1)
    # the fused path's draft steps run the standard spec program, whose
    # numerics differ from K8's by design: the int8 closeness gate holds
    # it, as serving_fused's
    fused = dict(quant_weights=True, decode_path="fused", max_batch_size=2)
    for label, m, kw, gate in (("paged_bf16", model, {}, "flip"),
                               ("paged_fp32", fp32, {}, "exact"),
                               ("fused", model, fused, "report"),
                               ("draft_fp32", fp32, {}, "exact")):
        spec = dict(spec="draft", draft_model=draft) \
            if label.startswith("draft") else dict(spec="ngram")
        on, off, reads = ab(m, cyclic, dict(spec_k=4, **spec), {},
                            repeat=label == "paged_bf16", **kw)
        outs = [[e.result(r).out_tokens for r in rids]
                for e, rids, *_ in (off, on)]
        cmp = compare_streams(m, cyclic, outs[0], outs[1], gate)
        close = None
        if gate == "report":
            exact, total, worst = closeness_gate(m, on[0], on[1])
            close = {"argmax_share": exact / total, "worst_margin": worst}
            if exact < 0.75 * total or worst >= 0.25:
                raise AssertionError(f"{label}: closeness {close}")
        log("spec", run=label, spec=spec["spec"], on=run_fields(m, *on),
            off=run_fields(m, *off), closeness=close, abba=reads, **cmp)
        del on, off
    # steady steps of the cyclic traffic, spec on beside off: step time,
    # tokens a step, device busy time, aten ops and kernels a step
    for phase, kw in (("spec_profile", dict(spec="ngram", spec_k=4)),
                      ("spec_profile_off_beside", {})):
        profile_decode_steps(model, phase=phase, prompts=cyclic,
                             new_tokens=200, **kw)
    del draft, fp32, model
    torch.cuda.empty_cache()

    # (c) the CLI: two identical lines, then spec
    same = [{"id": "greedy", "tokens": list(range(300, 340)),
             "max_new_tokens": 8},
            {"id": "sampled", "tokens": list(range(300, 340)),
             "max_new_tokens": 6}]
    for flags, lines, key in ((("--block-size", "4"), same,
                               "prefix_indexed_blocks"),
                              (("--spec", "ngram", "--spec-k", "4"),
                               CLI_LINES, "spec_draft_tokens")):
        def read_gauges(proc, flags=flags, key=key):
            summary = json.loads(proc.stderr.split("serve summary: ")[1])
            gauges = {k: v for k, v in summary.items()
                      if k.startswith(("prefix", "spec", "pool_evictable",
                                       "mean_accepted",
                                       "prefill_tokens_saved"))}
            log("cli_gauges", flags=list(flags), **gauges)
            if key not in summary or (key == "prefix_indexed_blocks"
                                      and summary[key] < 10):
                raise AssertionError(f"CLI summary lacks {key}: {summary}")

        cli_check(flags, lines, then=read_gauges)

    results["launches"] += added["k1"]
    results["int8_launches"]["k2"] += added["k2"]
    results["int8_launches"]["k3"] += added["k3"]
    results["sp_launches"]["stats"] += added["k1s"]
    results["fused_launches"] += added["k8"]
    log("prefix_spec_launches", **added)


# -- phase 19 -----------------------------------------------------------------

OVERLAP_STEPS = 10      # steps per timed window of the steady A/B


def replay_vs_eager(engine):
    """One staged pdecode step of a steady engine through the eager
    program and through one replay of its captured graph, the generator
    at the same state before each: logits, bundle and the generator's
    state after must be equal bit for bit. The engine commits neither;
    both write the same K/V rows. A row whose next token opens a block
    first gets that block, as the engine's own step gives it
    (``_ensure_decode_capacity``), so the step writes into the row's own
    page; ``boundary_rows`` counts them."""
    import torch

    from tnn_tpu_torch.serving import step_build, step_graph
    from tnn_tpu_torch.serving.kv_pool import PagedKVPool

    running = list(engine.scheduler.running)
    bs = engine.pool.block_size
    boundary = sum(r.cache_len % bs == 0 for r in running)
    events = []
    engine._ensure_decode_capacity(events)
    if events or list(engine.scheduler.running) != running:
        raise AssertionError(f"replay check: growing the rows' tables "
                             f"preempted or failed a row: {events}")
    graph = engine._decode_graph()
    step = step_build.pack_decode(
        list(engine.scheduler.running), b=engine.scheduler.max_batch_size,
        nb=engine.blocks_per_seq, scratch=PagedKVPool.SCRATCH, paged=True,
        fused_available=False)
    # every other row samples, so the replay's draws are compared too
    step.temps[1::2], step.topks[1::2], step.topps[1::2] = 0.8, 50, 0.95
    arrays = step_graph.decode_arrays(step)
    state = engine.generator.get_state()
    with torch.inference_mode():
        views = step_build.split_inputs(
            step_graph.stage(arrays).to(engine.device), arrays)
        logits, bundle = engine._pdecode(*views)
        logits, bundle = logits.clone(), bundle.clone()
        drawn = engine.generator.get_state()
        engine.generator.set_state(state)
        graph.run(step_graph.stage(arrays))
        torch.cuda.synchronize()
    return {"logits_equal": torch.equal(graph.logits, logits),
            "bundle_equal": torch.equal(graph.bundle, bundle),
            "generator_equal": torch.equal(engine.generator.get_state(),
                                           drawn),
            "max_abs_logit_diff": (graph.logits.float()
                                   - logits.float()).abs().max().item(),
            "rows_sampled": int((step.temps > 0).sum()),
            "boundary_rows": boundary,
            "cache_len_mod_block": [r.cache_len % bs for r in running]}


def replay_times(engine, count=20):
    """The device time of one replay of the engine's pdecode graph on an
    idle card and of ``count`` replays back to back (CUDA events), and
    the host time one launch takes."""
    import torch

    graph = engine._decode_graph().graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    graph.replay()
    launch_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    one_ms = start.elapsed_time(end)
    start.record()
    for _ in range(count):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return {"replay_device_ms": one_ms,
            "replays_back_to_back_ms": start.elapsed_time(end) / count,
            "replay_launch_host_ms": launch_ms}


def overlap_traffic_pair(model, label, **kw):
    """The serving traffic through the overlapped loop with graphs (A) and
    through synchronous eager steps (B), after a short warm-up run of
    each, in the order A B B A: token-exact on every request of every run
    (half of them sampled), launches counted over each run against the
    identities (K1 or K2 = 12 x paged dispatches = 12 x (paged steps +
    rebuilds)). Returns the first A run's launches."""
    import torch

    for overlap in (True, False):       # first-use costs off the clock
        serve_traffic(model, seed=1, num_requests=2, new_tokens=4,
                      overlap=overlap, eager_steps=not overlap, **kw)
    runs, counted = [], None
    for name in ("overlap_graphs", "sync_eager", "sync_eager",
                 "overlap_graphs"):
        overlap = name == "overlap_graphs"
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        (engine, rids), wide = count_wide_steps(lambda: serve_traffic(
            model, seed=0, overlap=overlap, eager_steps=not overlap, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        st = engine.stats()
        steps = st["program_steps"]
        paged = sum(steps.get(k, 0) for k in ("mixed", "pdecode", "spec"))
        want = expected_launches(model, engine, wide)
        graph = next(iter(engine._graphs.values()), None)
        ok = (launches == want
              and paged == engine.model_steps + st["overlap_rebuilds"]
              and all(len(engine.result(r).out_tokens) == 64
                      for r in rids)
              and (not overlap or (st["graph_replays"] > 0
                                   and st["overlap_adopted"] > 0)))
        runs.append((engine, rids))
        counted = counted or launches
        log("serving_overlap_run", path=label, run=name, wall_s=wall,
            model_steps=engine.model_steps, program_steps=steps,
            launches=launches, expected_launches=want,
            step_graphs=st["step_graphs"], graph_replays=st["graph_replays"],
            capture_ms=None if graph is None else graph.capture_s * 1e3,
            overlap_adopted=st["overlap_adopted"],
            overlap_rebuilds=st["overlap_rebuilds"],
            host_gap_ms_p50=st["host_gap_ms_p50"],
            host_gap_ms_p99=st["host_gap_ms_p99"],
            decode_tok_per_s=st["tok_per_s"],
            step_ms_mean=st["step_latency_ms_mean"],
            ttft_ms_p50=st["ttft_ms_p50"], ok=ok)
        if not ok:
            raise AssertionError(f"{label} {name}: launches {launches}, "
                                 f"want {want}; {steps}; model steps "
                                 f"{engine.model_steps}; {st}")
    ref, ref_rids = runs[1]
    same = [[eng.result(a).out_tokens == ref.result(b).out_tokens
             for a, b in zip(rids, ref_rids)] for eng, rids in runs]
    log("serving_overlap_exact", path=label, runs=len(runs),
        requests=len(ref_rids), identical=[sum(x) for x in same],
        sampled_requests=len(ref_rids) // 2)
    if not all(all(x) for x in same):
        raise AssertionError(f"{label}: overlap with graphs differs from "
                             f"synchronous eager steps: {same}")
    return counted


def overlap_steady_ab(model, label, **kw):
    """Steady decode (8 rows, kv 500): the overlapped loop with graphs
    against synchronous eager steps in alternating windows (ABBA), then a
    profiled window of each: step time, device busy, idle share, aten
    ops and kernels per step, decode tokens/s."""
    paths = {"overlap_graphs": dict(overlap=True, **kw),
             "sync_eager": dict(eager_steps=True, **kw)}
    # spare tokens: the profiled window's steps are steady ones too
    engines, rows = host_ab(model, rounds=4, steps=OVERLAP_STEPS,
                            phase=f"serving_overlap_ab_{label}",
                            paths=paths, abba=True, spare=2 * OVERLAP_STEPS)
    out = {"path": label}
    for name, eng in engines.items():
        step_ms = sorted(r[f"{name}_ms"] for r in rows[:4])[1:3]
        step_ms = sum(step_ms) / 2
        prof = profile_window(eng, OVERLAP_STEPS)
        out[name] = dict(
            step_ms=step_ms, device_busy_ms=prof["device_busy_ms"],
            idle_share=1.0 - prof["device_busy_ms"] / step_ms,
            aten_ops_per_step=prof["aten_ops_per_step"],
            kernels_per_step=prof["kernels_per_step"],
            decode_tok_per_s=8 * 1e3 / step_ms,
            top_kernels_ms=prof["top_kernels_ms"][:4],
            top_host_self_ms=prof["top_host_self_ms"][:5])
        if name == "overlap_graphs":
            # last: both replay the graph outside the engine's stream of
            # steps, and the engine is not driven after them
            out["replay_vs_eager"] = replay_vs_eager(eng)
            out[name].update(replay_times(eng))
    log("serving_overlap_steady", **out)
    r = out["replay_vs_eager"]
    if not (r["logits_equal"] and r["bundle_equal"]
            and r["generator_equal"]):
        raise AssertionError(f"{label}: graph replay differs from the "
                             f"eager pdecode program: {r}")


def phase_serving_overlap(results):
    """The overlapped loop with pdecode graphs on the serving traffic (bf16
    pool, then int8 pool and weights), the steady A/B with replay against
    eager, the fused path with overlap on, and the CLI with and without
    --no-overlap."""
    import torch

    from tnn_tpu_torch.models import zoo

    model = zoo.create("gpt2_small", device="cuda", seed=0)
    for label, kw in (("bf16", {}), ("int8", INT8_SERVING)):
        # the overlapped run's launches join the kernels line
        added = overlap_traffic_pair(model, label, **kw)
        results["launches"] += added["k1"]
        results["int8_launches"]["k2"] += added["k2"]
        results["int8_launches"]["k3"] += added["k3"]
        overlap_steady_ab(model, label, **kw)
    # the fused path: eager K8 under the overlapped loop
    reset_launches()
    on, rids_on = fused_traffic(model, seed=0, overlap=True)
    k8_on = read_launches()["k8"]
    reset_launches()
    off, rids_off = fused_traffic(model, seed=0)
    k8_off = read_launches()["k8"]
    same = all(on.result(a).out_tokens == off.result(b).out_tokens
               for a, b in zip(rids_on, rids_off))
    log("serving_overlap_fused", identical=same, k8_overlap=k8_on,
        k8_sync=k8_off, fdecode_steps=on.stats()["program_steps"].get(
            "fdecode", 0), host_gap_ms_p50=on.stats()["host_gap_ms_p50"])
    if not same or k8_on != k8_off or k8_on == 0:
        raise AssertionError(f"fused path: overlap identical {same}, K8 "
                             f"{k8_on} against {k8_off}")
    del on, off
    torch.cuda.empty_cache()
    # the CLI: overlap on by default, --no-overlap the same tokens
    tokens = []

    def collect(proc):
        tokens.append({e["id"]: e["tokens"]
                       for e in map(json.loads, proc.stdout.splitlines())
                       if e.get("event") == "done"})
        if len(tokens) < 2:
            return
        log("serving_overlap_cli", identical=tokens[0] == tokens[1])
        if tokens[0] != tokens[1]:
            raise AssertionError(f"CLI --no-overlap differs: {tokens}")

    for flags in ((), ("--no-overlap",)):
        cli_check(flags, then=collect)


# -- phase 20 -----------------------------------------------------------------

WHOLE_PROMPT = dict(chunked_prefill=False, overlap=True)


def prefill_widths(fn):
    """Run ``fn()`` recording each whole-prompt prefill program's padded
    width; returns (fn's result, the widths)."""
    from tnn_tpu_torch.serving.engine import InferenceEngine

    real = InferenceEngine._prefill
    widths = []

    def _prefill(self, ids, length, tables, step):
        widths.append(int(ids.shape[1]))
        return real(self, ids, length, tables, step)

    InferenceEngine._prefill = _prefill
    try:
        out = fn()
    finally:
        InferenceEngine._prefill = real
    return out, widths


def read_all_launches():
    from tnn_tpu_torch.ops import flash_attention as fa

    return {**read_launches(), "k4": fa.flash_attention_fwd.launches}


def reset_all_launches():
    from tnn_tpu_torch.ops import flash_attention as fa

    reset_launches()
    fa.flash_attention_fwd.launches = 0


def whole_prompt_expected(model, engine, widths):
    """K1 (K2 on an int8 pool) = layers x pdecode dispatches; K3 = 49 x
    prefills wider than ``W8A8_MAX_ROWS`` (every matmul and the head run
    on all padded rows); K4 = layers x prefills on a flash model."""
    from tnn_tpu_torch.ops.quant_matmul import W8A8_MAX_ROWS

    st = engine.stats()
    per = model.num_layers * st["program_steps"].get("pdecode", 0)
    quant = st["kv_dtype"] == "int8"
    wide = sum(w > W8A8_MAX_ROWS for w in widths)
    return {"k1": 0 if quant else per, "k2": per if quant else 0,
            "k1s": 0, "k1s_int8": 0,
            "k3": (4 * model.num_layers + 1) * wide
            if st["quant_weights"] else 0, "k8": 0,
            "k4": model.num_layers * len(widths)
            if model.backend == "pallas" else 0}


def whole_prompt_run(model, label, run_name, **kw):
    """The serving traffic through one engine, launches counted over it
    alone and held against the identities; returns (engine, rids, log
    fields)."""
    import torch

    from tnn_tpu_torch.serving.scheduler import RequestState

    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    (engine, rids), widths = prefill_widths(
        lambda: serve_traffic(model, seed=0, **kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_all_launches()
    st = engine.stats()
    finished = all(engine.result(r).state is RequestState.FINISHED
                   and len(engine.result(r).out_tokens) == 64
                   for r in rids)
    want = whole_prompt_expected(model, engine, widths) \
        if not engine.chunked_prefill else None
    fields = dict(path=label, run=run_name, wall_s=wall,
                  ttft_ms_p50=st["ttft_ms_p50"],
                  ttft_ms_p95=st["ttft_ms_p95"],
                  decode_tok_per_s=st["tok_per_s"],
                  step_ms_mean=st["step_latency_ms_mean"],
                  prefills=st["prefills"],
                  prefill_ms_mean=st["prefill_ms_mean"],
                  prefill_widths=sorted(widths),
                  program_steps=st["program_steps"],
                  preemptions=st["preemptions"],
                  overlap_adopted=st["overlap_adopted"],
                  graph_replays=st["graph_replays"], launches=launches,
                  expected_launches=want,
                  ok=finished and (want is None or launches == want))
    log("serving_whole_prompt_run", **fields)
    if not fields["ok"]:
        raise AssertionError(f"{label} {run_name}: finished {finished}, "
                             f"launches {launches}, want {want}")
    engine.check_invariants()
    return engine, rids, fields


def prefill_times(engine, widths, iters=10):
    """One whole-prompt prefill program at each padded width, its table
    all scratch (the model forward, the sample and the scatter): CUDA
    event time per call, the summed kernel time per call (``time_ms``),
    the idle share between them, and the kernels that take the most
    device time."""
    import numpy as np
    import torch

    from tnn_tpu_torch.serving.engine import SampleInputs

    out = {}
    bs = engine.pool.block_size
    for w in sorted(set(widths)):
        ids, temps, topks, topps, poison, tables = engine._put_step(
            [np.zeros((1, w), np.int32), np.zeros(1, np.float32),
             np.zeros(1, np.int32), np.zeros(1, np.float32),
             np.zeros(1, np.float32)],
            np.zeros((1, w // bs), np.int32))
        step = SampleInputs(ids, temps, topks, topps, poison)
        with torch.inference_mode():
            device, events, per_name = time_ms(
                lambda: engine._prefill(ids, w, tables, step), iters=iters,
                warmup=3)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:3]
        out[w] = {"ms": events, "device_busy_ms": device,
                  "idle_share": None if device is None
                  else 1.0 - device / events,
                  "kernels": len(per_name),
                  "top_kernels_ms": [[n[:60], t] for n, t in top]}
    return out


def prefill_k4_checks(model, widths):
    """K4 (and K7) against the plain versions at the calls a whole-prompt
    prefill makes on ``model``: one row, every head, the padded width as
    both query and key length, causal at ``kv_offset`` 0, in the compute
    dtype; returns the worst forward |err|."""
    import torch

    worst = 0.0
    heads = model.num_heads
    for i, w in enumerate(sorted(set(widths))):
        args = flash_case(600 + i, b=1, h=heads, hkv=model.num_kv_heads,
                          sq=w, skv=w, d=model.d_model // heads,
                          dtype=model.policy.compute_dtype, causal=True,
                          kv_offset=0)
        worst = max(worst, flash_check(f"prefill_{w}", args)[0])
        del args
        torch.cuda.empty_cache()
    return worst


def prefill_k3_checks(model, widths):
    """K3 against its plain version at the 49 calls of each whole-prompt
    prefill wider than ``W8A8_MAX_ROWS`` on int8 gpt2_small: qkv, out, fc
    and proj, and the head with its f32 logits, at the padded width's
    rows in the compute dtype, on seeded weights; returns the worst
    |err|."""
    import torch

    from tnn_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    worst = 0.0
    for i, w in enumerate(sorted(w for w in set(widths)
                                 if w > qm.W8A8_MAX_ROWS)):
        gen = torch.Generator(device=dev).manual_seed(650 + i)
        for shape in ("qkv", "out", "fc", "proj", "head"):
            _, k, n, head = MATMUL_SHAPES[shape]
            iw = qm.quantize_int8(torch.randn((k, n), generator=gen,
                                              device=dev) * 0.02)
            x = torch.randn((w, k), generator=gen, device=dev).to(
                model.policy.compute_dtype)
            entry = k3_check(f"prefill_{w}_{shape}", x, iw, dict(
                n=n, k=k, out_dtype=torch.float32 if head else None))
            log("serving_whole_prompt_k3", **entry)
            worst = max(worst, entry["max_abs_err"])
            del iw, x
        torch.cuda.empty_cache()
    return worst


def model_file_round_trip(model, path, label="serving_whole_prompt_file"):
    """``save_model`` then ``load_model`` on the card: seconds of each and
    every weight equal bit for bit."""
    import os

    import torch

    from tnn_tpu_torch import checkpoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_model(path, model)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = checkpoint.load_model(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pairs = list(zip(model.jax_param_paths(), loaded.jax_param_paths()))
    exact = all(pa == pb and a.device.type == "cuda" and torch.equal(a, b)
                for (pa, a), (pb, b) in pairs)
    fields = dict(file_mb=os.path.getsize(path) / 1e6, save_s=save_s,
                  load_s=load_s, tensors=len(pairs), bit_exact=exact,
                  config_equal=loaded.get_config() == model.get_config())
    log(label, **fields)
    if not (exact and fields["config_equal"]):
        raise AssertionError(f".tnn round trip not bit-exact: {fields}")
    return loaded


def stdlib_vocab(path, max_bytes=120_000, vocab_size=400):
    """A BPE vocab trained on the card's Python stdlib text (the first
    ``max_bytes`` of its .py files), saved to ``path``."""
    import sysconfig

    from tnn_tpu_torch.cli.prepare_corpus import iter_files
    from tnn_tpu_torch.data.tokenizer import train_bpe

    texts = []
    for f in iter_files([sysconfig.get_paths()["stdlib"]], "*.py",
                        max_bytes):
        with open(f, encoding="utf-8", errors="ignore") as fh:
            texts.append(fh.read())
    t0 = time.perf_counter()
    tok = train_bpe(texts, vocab_size=vocab_size)
    tok.save(path)
    log("serving_whole_prompt_vocab", files=len(texts),
        chars=sum(map(len, texts)), vocab_size=tok.vocab_size,
        train_s=time.perf_counter() - t0)
    return tok


def admission_check(model):
    """``max_queue_depth=2``: "reject" refuses the 6 equal-priority
    submits past a full queue and serves the 2 queued; "block" steps the
    engine inside ``submit`` and serves all 8."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine
    from tnn_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                 RequestState)

    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, model.vocab_size, int(rng.integers(16, 257)))
               for _ in range(8)]
    out = {}
    for policy in ("reject", "block"):
        engine = InferenceEngine(model, num_blocks=512, block_size=16,
                                 max_batch_size=8, device=model.device,
                                 max_queue_depth=2, admission_policy=policy,
                                 **WHOLE_PROMPT)
        rids, rejected = [], 0
        for p in prompts:
            try:
                rids.append(engine.submit(p, 16))
            except AdmissionRejected:
                rejected += 1
        engine.run_until_complete()
        done = sum(engine.result(r).state is RequestState.FINISHED
                   for r in rids)
        out[policy] = dict(submitted=len(rids), rejected=rejected,
                           finished=done,
                           metrics_rejected=engine.stats()["rejected"])
    log("serving_whole_prompt_admission", **out)
    if out["reject"] != dict(submitted=2, rejected=6, finished=2,
                             metrics_rejected=6) or \
            out["block"] != dict(submitted=8, rejected=0, finished=8,
                                 metrics_rejected=0):
        raise AssertionError(f"bounded admission: {out}")


def whole_prompt_cli(model_path, vocab_path, tok):
    lines = [{"id": "text", "prompt": "def main(argv=None):\n    return",
              "max_new_tokens": 8},
             {"id": "sampled", "prompt": "import os\nimport sys\n",
              "max_new_tokens": 6, "temperature": 0.8, "top_k": 50}]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model-file",
         model_path, "--vocab", vocab_path, "--no-chunked-prefill"],
        input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=600)
    events = [json.loads(x) for x in proc.stdout.splitlines() if x.strip()]
    done = {e["id"]: e for e in events if e.get("event") == "done"}
    ok = (proc.returncode == 0 and set(done) == {"text", "sampled"}
          and len(done["text"]["tokens"]) == 8
          and len(done["sampled"]["tokens"]) == 6
          and all(e["text"] == tok.decode(e["tokens"])
                  for e in done.values())
          and '"prefills": 2' in proc.stderr)
    log("serving_whole_prompt_cli", returncode=proc.returncode,
        done_events=len(done),
        texts={k: e.get("text") for k, e in done.items()},
        seconds=round(time.perf_counter() - t0, 3), ok=ok)
    if not ok:
        raise AssertionError(f"whole-prompt CLI failed: rc "
                             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")


def phase_serving_whole_prompt(results):
    """The whole-prompt path on full-width gpt2_small: the .tnn round
    trip, a trained vocab, the traffic against chunked prefill (ABBA),
    prefill program times, the int8 pool and weights, flash_gpt2_small,
    K3 and K4 against their plain versions at the prefill calls' shapes,
    FP32 exactness against synchronous eager steps and against chunked
    prefill, bounded admission and the CLI on text lines."""
    import tempfile

    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo

    added = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}

    def count(fields):
        for k in added:
            added[k] += fields["launches"][k]

    with tempfile.TemporaryDirectory() as tmp:
        model = zoo.create("gpt2_small", device="cuda", seed=0)
        model_path, vocab_path = f"{tmp}/gpt2_small.tnn", f"{tmp}/vocab.bin"
        model = model_file_round_trip(model, model_path)
        tok = stdlib_vocab(vocab_path)
        # first-use costs off the clock, then whole-prompt (A) against
        # chunked prefill (B) in the order A B B A
        for chunked in (False, True):
            serve_traffic(model, seed=1, num_requests=2, new_tokens=4,
                          **{**WHOLE_PROMPT, "chunked_prefill": chunked})
        runs = {}
        for i, chunked in enumerate((False, True, True, False)):
            name = "chunked" if chunked else "whole_prompt"
            engine, rids, fields = whole_prompt_run(
                model, "bf16", f"{name}_{i}",
                **{**WHOLE_PROMPT, "chunked_prefill": chunked})
            runs.setdefault(name, []).append((engine, rids, fields))
            if not chunked and i == 0:
                count(fields)
        a, b = runs["whole_prompt"][0], runs["chunked"][0]
        greedy = [(x, y) for j, (x, y) in enumerate(zip(a[1], b[1]))
                  if j % 2 == 0]
        log("serving_whole_prompt_ab", **{
            name: {k: [f[2][k] for f in rs] for k in
                   ("wall_s", "ttft_ms_p50", "ttft_ms_p95",
                    "decode_tok_per_s")} for name, rs in runs.items()},
            greedy_equal_to_chunked=sum(
                a[0].result(x).out_tokens == b[0].result(y).out_tokens
                for x, y in greedy), greedy_requests=len(greedy))
        times = prefill_times(a[0], a[2]["prefill_widths"])
        log("serving_whole_prompt_prefill",
            **{str(w): t for w, t in times.items()})
        del runs, a, b
        torch.cuda.empty_cache()
        # int8 pool and weights: K2 every decode step, K3 in wide prefills
        _, _, fields = whole_prompt_run(model, "int8", "whole_prompt",
                                        **WHOLE_PROMPT, **INT8_SERVING)
        count(fields)
        if fields["launches"]["k3"] == 0:
            raise AssertionError("no prefill wider than 256 rows ran K3")
        k3_err = prefill_k3_checks(model, fields["prefill_widths"])
        admission_check(model)
        whole_prompt_cli(model_path, vocab_path, tok)
        del model
        torch.cuda.empty_cache()
    # flash_gpt2_small: K4 in every prefill, K1 in every decode step
    flash = zoo.create("flash_gpt2_small", device="cuda", seed=0)
    _, _, fields = whole_prompt_run(flash, "flash", "whole_prompt",
                                    **WHOLE_PROMPT)
    count(fields)
    if fields["launches"]["k4"] == 0:
        raise AssertionError("K4 never launched on flash_gpt2_small")
    k4_err = prefill_k4_checks(flash, fields["prefill_widths"])
    del flash
    torch.cuda.empty_cache()
    # FP32: whole-prompt with overlap and graphs against synchronous eager
    # steps (every request), and against chunked prefill, the path the
    # earlier phases hold against the plain model (greedy, tie-free)
    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    eng_a, rids_a, _ = whole_prompt_run(fp32, "fp32", "overlap_graphs",
                                        **WHOLE_PROMPT)
    eng_b, rids_b, _ = whole_prompt_run(
        fp32, "fp32", "sync_eager", eager_steps=True,
        **{**WHOLE_PROMPT, "overlap": False})
    eng_c, rids_c, _ = whole_prompt_run(
        fp32, "fp32", "chunked", **{**WHOLE_PROMPT, "chunked_prefill": True})
    same = [eng_a.result(x).out_tokens == eng_b.result(y).out_tokens
            for x, y in zip(rids_a, rids_b)]
    greedy = rids_a[::2]
    cmp = compare_streams(
        fp32, [eng_a.result(r).prompt for r in greedy],
        [eng_c.result(r).out_tokens for r in rids_c[::2]],
        [eng_a.result(r).out_tokens for r in greedy], "exact")
    log("serving_whole_prompt_exact", requests=len(same),
        identical=sum(same), sampled_requests=len(same) // 2,
        greedy_vs_chunked=cmp, sampled_equal_to_chunked=sum(
            eng_a.result(x).out_tokens == eng_c.result(y).out_tokens
            for x, y in zip(rids_a[1::2], rids_c[1::2])))
    if not all(same):
        raise AssertionError(f"FP32 whole-prompt streams differ between "
                             f"overlap with graphs and eager steps: {same}")
    # every greedy stream: token-exact on the tie-free ones (raised in
    # compare_streams), and elsewhere a divergence only at a near-tie
    if not cmp["tie_free_prompts"] or \
            any(g > NEAR_TIE for g in cmp["divergence_gaps"]):
        raise AssertionError(f"FP32 whole-prompt against chunked prefill: "
                             f"{cmp}")
    del fp32, eng_a, eng_b, eng_c
    torch.cuda.empty_cache()
    for name, err in (("flash_attention_fwd", k4_err),
                      ("int8_matmul", k3_err)):
        if name in results:
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)
    results["launches"] += added["k1"]
    results["int8_launches"]["k2"] += added["k2"]
    results["int8_launches"]["k3"] += added["k3"]
    results["flash_launches"]["flash_attention_fwd"] += added["k4"]
    log("serving_whole_prompt_launches", **added)


# -- phase 21 -----------------------------------------------------------------

INT8_CACHE_TOKENS = 64
INT8_CACHE_PROMPT = 128
# apply_paged with RoPE (K1) against apply_cached on a contiguous cache,
# bf16: both round K/V to bf16 and sum in f32, in other orders (the
# kernel split-KV, the plain path one softmax), and the outputs are bf16;
# the limit is 2^-5 of the largest |output|, 4 bf16 ulps at that scale
ROPE_LIMIT = 2 ** -5


def closeness_hits(model, prompt, out):
    """The float model over prompt + out (one forward): (positions where
    its argmax is the chosen token, positions)."""
    import torch

    seq = list(prompt) + list(out)
    with torch.inference_mode():
        logits = model(torch.tensor([seq], device=model.device))[0]
    rows = logits[len(prompt) - 1:len(seq) - 1]
    chosen = torch.tensor(list(out), device=rows.device)
    return int((rows.argmax(-1) == chosen).sum()), len(out)


def int8_cache_generate(name, prompt):
    """``generate`` over the float and the int8 contiguous cache of a
    seeded full-width zoo model, after one warm-up each, timed in the order
    float, int8, int8, float (CUDA-synchronized wall clock; tokens/s of
    each run); the int8 greedy tokens held against the float model
    teacher-forced over them (>= 75%); K4's launches in each run (12 x 64
    on a flash model: the prefill and 63 decode steps, each ``kv_offset``
    form, the same in every run). Returns one int8 run's K4 launches."""
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.models.gpt2 import generate
    from tnn_tpu_torch.ops import flash_attention as fa

    ids = torch.tensor(prompt, device="cuda")[None]
    models = {cache: zoo.create(name, device="cuda", seed=0,
                                kv_cache_dtype="int8" if cache == "int8"
                                else None) for cache in ("float", "int8")}
    for model in models.values():
        generate(model, ids, 4)                     # first-use costs
    fields = {"model": name, "float_tok_per_s": [], "int8_tok_per_s": []}
    toks, k4 = {}, {"float": set(), "int8": set()}
    for cache in ("float", "int8", "int8", "float"):
        torch.cuda.synchronize()
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        toks[cache] = generate(models[cache], ids,
                               INT8_CACHE_TOKENS)[0].tolist()
        torch.cuda.synchronize()
        fields[f"{cache}_tok_per_s"].append(
            INT8_CACHE_TOKENS / (time.perf_counter() - t0))
        k4[cache].add(fa.flash_attention_fwd.launches)
    model = models["float"]
    hit, total = closeness_hits(model, prompt, toks["int8"])
    fields.update(
        int8_over_float=sum(fields["int8_tok_per_s"])
        / sum(fields["float_tok_per_s"]),
        float_int8_equal_positions=sum(
            a == b for a, b in zip(toks["float"], toks["int8"])),
        closeness=hit / total, tokens=total,
        k4_launches={c: sorted(v) for c, v in k4.items()},
        cache_bytes_per_token=[
            2 * model.num_layers * model.d_model * 2,            # bf16
            2 * model.num_layers * (model.d_model + 4 * model.num_heads)])
    want_k4 = [model.num_layers * INT8_CACHE_TOKENS
               if model.backend == "pallas" else 0]
    fields["ok"] = (hit / total >= 0.75
                    and fields["k4_launches"] == {"float": want_k4,
                                                  "int8": want_k4})
    log("attention_int8_generate", **fields)
    if not fields["ok"]:
        raise AssertionError(f"int8 cache on {name}: {fields}")
    del models, model
    torch.cuda.empty_cache()
    return want_k4[0]


def rope_paged_check():
    """``MultiHeadAttention.apply_paged`` with RoPE on flash_llama_small's
    first layer (12 q / 4 kv heads, Dh 64, bf16): 8 rows of prior tokens
    (kv 100-900) written through the chunk form, then a decode token at
    per-row offsets (the decode form) and a ragged chunk (1-16 tokens a
    row, the chunk form), each against the same layer's ``apply_cached``
    over a contiguous cache holding the same tokens. K1 must launch."""
    import numpy as np
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops import paged_attention as pa

    model = zoo.create("flash_llama_small", device="cuda", seed=0)
    attn = model.blocks[0].attn
    cd = model.policy.compute_dtype
    rng = np.random.default_rng(21)
    b, bs, hkv, dh, d = 8, 16, attn.num_kv_heads, attn.head_dim, 768
    prior = rng.integers(100, 901, b)
    q, width, nb = 16, 960, 64        # 64 blocks of 16: 1024 positions
    tables = torch.arange(1, 1 + b * nb, dtype=torch.int32,
                          device="cuda").view(b, nb)
    pk = torch.zeros(1, 1 + b * nb, hkv, bs, dh, dtype=cd, device="cuda")
    pv = torch.zeros_like(pk)
    cache = attn.init_cache(b, nb * bs)
    x0 = torch.from_numpy(rng.normal(size=(b, width, d))).to(
        device="cuda", dtype=cd)
    lens = torch.from_numpy(prior).to(device="cuda", dtype=torch.int32)
    zero = torch.zeros(b, dtype=torch.int32, device="cuda")
    out = {}
    before = pa.paged_attention.launches
    with torch.inference_mode():
        attn.apply_paged(x0, pk, pv, tables, zero, q_lens=lens)
        attn.apply_cached(x0, cache, 0)
        x1 = torch.from_numpy(rng.normal(size=(b, 1, d))).to(
            device="cuda", dtype=cd)
        got = attn.apply_paged(x1, pk, pv, tables, lens)
        ref, _ = attn.apply_cached(x1, cache, lens)
        out["decode"] = (got.float(), ref.float())
        lens1 = lens + 1
        ql = torch.from_numpy(rng.integers(1, q + 1, b)).to(
            device="cuda", dtype=torch.int32)
        x2 = torch.from_numpy(rng.normal(size=(b, q, d))).to(
            device="cuda", dtype=cd)
        got = attn.apply_paged(x2, pk, pv, tables, lens1, q_lens=ql)
        ref, _ = attn.apply_cached(x2, cache, lens1)
        live = torch.arange(q, device="cuda")[None] < ql[:, None]
        out["chunk"] = (got.float()[live], ref.float()[live])
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches - before
    fields = {"layer": "flash_llama_small.h0", "heads": attn.num_heads,
              "kv_heads": hkv, "dtype": str(cd).replace("torch.", ""),
              "prior_kv": prior.tolist(), "k1_launches": launches}
    ok = launches == 3
    for form, (got, ref) in out.items():
        err = (got - ref).abs().max().item()
        limit = ROPE_LIMIT * ref.abs().max().item()
        fields[form] = {"max_abs_err": err, "limit": limit,
                        "share_of_limit": err / limit}
        ok = ok and math.isfinite(err) and err <= limit
    fields["ok"] = ok
    log("attention_rope_paged", **fields)
    if not ok:
        raise AssertionError(f"apply_paged with RoPE: {fields}")
    del model, pk, pv, cache
    torch.cuda.empty_cache()


def phase_attention_int8_rope(results):
    """The per-model int8 contiguous cache (``generate`` on gpt2_small and
    flash_gpt2_small, K4 in its ``kv_offset`` form on the flash model) and
    RoPE in ``apply_paged`` (K1 with GQA heads at the layer level)."""
    import numpy as np

    prompt = np.random.default_rng(20).integers(
        0, 50257, INT8_CACHE_PROMPT).tolist()
    int8_cache_generate("gpt2_small", prompt)
    k4 = int8_cache_generate("flash_gpt2_small", prompt)
    results["flash_launches"]["flash_attention_fwd"] += k4
    rope_paged_check()


# -- phase 22 -----------------------------------------------------------------

SUPERVISED_WAIT_S = 120.0     # the longest any wait of the phase may take


def traffic_requests(vocab, seed, num_requests=8, new_tokens=64):
    """The serving traffic's requests (``serve_traffic``'s prompts and
    sampling), as (prompt, max_new, submit kwargs)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_requests):
        prompt = rng.integers(0, vocab, int(rng.integers(16, 769)))
        sampled = i % 2 == 1
        out.append((prompt, new_tokens, dict(
            temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 0.0)))
    return out


def supervised_run(model, seed=0, plan=None, drain_after=None,
                   sup_kw=None, traced=False, threaded=True, **engine_kw):
    """The serving traffic under a started ``EngineSupervisor`` (the engine
    on its worker thread, overlap on): submit every request from this
    thread, wait for one terminal event each, drain, join. With
    ``drain_after`` the drain starts once that many token events arrived.
    Launches are counted over the run alone (wide mixed steps too).
    ``threaded=False`` drives the same supervisor inline (``run_sync``,
    then the drain) on this thread instead of starting its worker.
    Returns (engine, supervisor, rids, terminal events by rid, fields)."""
    import threading

    import numpy as np
    import torch

    from tnn_tpu_torch.serving.engine import InferenceEngine
    from tnn_tpu_torch.serving.supervisor import EngineSupervisor

    engine = InferenceEngine(
        model, num_blocks=512, block_size=16, seed=seed,
        device=model.device, overlap=True, faults=plan, trace=traced,
        **{"max_batch_size": 8, "chunk_size": 64, **engine_kw})
    reqs = traffic_requests(model.vocab_size, seed)
    events, tokens, done = [], [0], threading.Event()
    term, finish_steps, token_times = {}, {}, {}

    def sink(ev):                  # on the worker thread
        events.append(ev)
        if ev["event"] == "token":
            token_times.setdefault(ev["id"], []).append(time.perf_counter())
        if ev["event"] != "token":
            finish_steps[ev["id"]] = engine.step_seq
        if ev["event"] == "token":
            tokens[0] += 1
            if drain_after is not None and tokens[0] == drain_after:
                sup.request_drain("mid-traffic drain")
        elif ev["id"] in term:
            raise AssertionError(f"two terminal events for {ev['id']}")
        else:
            term[ev["id"]] = ev
            if len(term) == len(reqs):
                done.set()

    sup = EngineSupervisor(engine, event_sink=sink, restart_backoff_s=0.0,
                           idle_wait_s=0.005, **(sup_kw or {}))
    restart_s = []
    restart = sup._restart

    def timed_restart(reason):      # the crash recovery's own wall time
        t = time.perf_counter()
        restart(reason)
        restart_s.append(time.perf_counter() - t)

    sup._restart = timed_restart
    torch.cuda.synchronize()
    reset_all_launches()

    def drive():
        if not threaded:
            rids = [sup.submit(p, n, **kw) for p, n, kw in reqs]
            sup.run_sync()
            sup.request_drain("traffic done")
            sup.run_sync()
            return rids
        sup.start()
        # one command: every request is queued before the first step, as
        # serve_traffic queues them before run_until_complete
        rids = sup.execute(lambda: [sup.submit(p, n, **kw)
                                    for p, n, kw in reqs])
        if not done.wait(SUPERVISED_WAIT_S):
            raise AssertionError(f"terminal events: {len(term)} of "
                                 f"{len(reqs)} after {SUPERVISED_WAIT_S}s")
        sup.request_drain("traffic done")
        if not sup.join(SUPERVISED_WAIT_S):
            raise AssertionError("the supervisor did not stop")
        return rids

    t0 = time.perf_counter()
    rids, wide = count_wide_steps(drive)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_all_launches()
    engine.check_invariants()
    st = engine.stats()
    fields = dict(wall_s=wall, state=sup.state.value, exit_code=sup.exit_code,
                  restarts=sup.restarts, launches=launches,
                  expected_launches={**expected_launches(model, engine,
                                                         wide), "k4": 0},
                  program_steps=st["program_steps"],
                  graph_replays=st["graph_replays"],
                  step_ms_mean=st["step_latency_ms_mean"],
                  decode_tok_per_s=st["tok_per_s"],
                  ttft_ms_p50=st["ttft_ms_p50"],
                  pool_allocated=engine.pool.num_allocated,
                  terminal={k: sum(e["event"] == k for e in term.values())
                            for k in ("done", "error", "timeout",
                                      "cancelled")},
                  drain_duration_s=sup.drain_duration_s,
                  restart_ms=[t * 1e3 for t in restart_s],
                  finish_steps=[finish_steps[r] for r in rids],
                  # each request's longest wait between two of its tokens
                  token_gap_ms_max=[max(np.diff(token_times.get(r, [0, 0])),
                                        default=0.0) * 1e3 for r in rids])
    return engine, sup, rids, term, fields


def launches_hold(fields):
    return fields["launches"] == fields["expected_launches"]


# The chaos plan, placed on the traffic at 2 rows a step and 256-token
# chunks, whose schedule depends only on the prompt lengths (no stop
# tokens), so the same calls hit the same requests on any card and dtype:
# the second prefill chunk row is NaN (request 1 fails), decode call 3
# raises a transient fault (retried), the 14th allocation fails (request
# 3, at its first chunk), step 96 crashes (requests 4 and 5 migrate and
# finish), decode call 132 poisons row 0 of a pdecode graph step (request
# 6 fails), and decode calls 160 and 161 raise (the retry fails too: the
# running batch, request 7 alone, aborts). Requests 0 and 2 finish
# untouched.
CHAOS_PLAN = dict(seed=14, nan_prefill_calls=(2,),
                  decode_exc_calls=(3, 160, 161), transient_exc=True,
                  alloc_fail_calls=(14,), step_crash_calls=(96,),
                  nan_logit_calls=(132,))
CHAOS_STATES = ["finished", "failed", "finished", "failed", "finished",
                "finished", "failed", "failed"]
CHAOS_MIGRATED = [0, 0, 0, 0, 1, 1, 0, 0]


def chaos_run(model, label, exact, **engine_kw):
    """The traffic at 2 rows a step and 256-token chunks (the requests
    queue, so the batch abort leaves the rest of the traffic, and prefill
    steps have 512 rows: K3 on int8 weights), fault-free and under
    ``CHAOS_PLAN``: the planned request states and migrations, the plan's
    firings, one terminal event per request, invariants clean, no leaked
    block, the launch identities in both runs. The greedy streams of the
    requests no fault touched (0 and 2) and of the one the crash migrated
    (4), against the fault-free run: with ``exact`` (FP32) token for token,
    as the reference's CPU tests hold them (the tie-free prompts and each
    divergence's gap are reported too). In bf16 a fault
    changes which requests share a step, and with it the programs and
    shapes a request's tokens go through (a decode token in a mixed step
    or a pdecode graph; with int8 weights w8a8 or K3 by the step's rows),
    so rounding moves and greedy streams may part at a close logit gap:
    there the equal tokens and each divergence's gap are reported, and
    the streams are held by the closeness gate (the float model,
    teacher-forced over them, agrees at >= 75% of positions). Returns the
    chaos run's fields."""
    from tnn_tpu_torch.serving.faults import FaultPlan
    from tnn_tpu_torch.serving.scheduler import RequestState

    kw = dict(max_batch_size=2, chunk_size=256, **engine_kw)
    ref, _, ref_rids, ref_term, ref_fields = supervised_run(model, **kw)
    plan = FaultPlan(**CHAOS_PLAN)
    eng, sup, rids, term, fields = supervised_run(model, plan=plan, **kw)
    groups = {"untouched": [], "migrated": []}
    for i in range(0, len(rids), 2):            # the greedy requests
        req = eng.result(rids[i])
        if req.state is RequestState.FINISHED:
            groups["migrated" if req.migrations else "untouched"].append(i)
    hit = total = 0
    for name, idx in groups.items():
        got = [eng.result(rids[i]).out_tokens for i in idx]
        fields[f"{name}_greedy"] = idx
        fields[f"{name}_compare"] = compare_streams(
            model, [eng.result(rids[i]).prompt for i in idx],
            [ref.result(ref_rids[i]).out_tokens for i in idx], got,
            "exact" if exact else "report")
        for i, out in zip(idx, got):
            h, t = closeness_hits(model, eng.result(rids[i]).prompt, out)
            hit, total = hit + h, total + t
    fired = dict(plan.fired)
    fields.update(path=label, faults_fired=fired,
                  ref_steps=ref.step_seq, steps=eng.step_seq,
                  step_retries=eng.metrics.step_retries,
                  migrated_requests=eng.metrics.migrated_requests,
                  states=[eng.result(r).state.value for r in rids],
                  errors=[eng.result(r).error[:48] for r in rids],
                  migrations=[eng.result(r).migrations for r in rids],
                  closeness=hit / max(total, 1),
                  flight_records=len(sup.flight))
    near_ties_only = all(
        g <= NEAR_TIE for name in groups
        for g in fields[f"{name}_compare"]["divergence_gaps"])
    ok = (len(term) == len(rids) and fields["pool_allocated"] == 0
          and fields["states"] == CHAOS_STATES
          and fields["migrations"] == CHAOS_MIGRATED
          and groups == {"untouched": [0, 2], "migrated": [4]}
          and launches_hold(fields) and launches_hold(ref_fields)
          and sup.restarts == 1 and eng.metrics.step_retries == 2
          and fired == {"prefill.logits": 1, "decode": 3, "pool.alloc": 1,
                        "engine.step": 1, "decode.logits": 1}
          and fields["closeness"] >= 0.75
          and (not exact or (near_ties_only and all(
              fields[f"{name}_compare"]["equal_share"] == 1.0
              for name in groups)))
          and all(ref_term[r]["event"] == "done" for r in ref_rids))
    fields["ok"] = ok
    log("serving_supervised_chaos", ref_launches=ref_fields["launches"],
        **fields)
    if not ok:
        raise AssertionError(f"chaos run {label}: {fields}")
    return fields


def watchdog_check(model, tmp):
    """After a warm-up run on the same engine, a step delayed past
    ``watchdog_step_s`` trips the watchdog: one restart, a "watchdog"
    flight dump, every request still served."""
    import os

    from tnn_tpu_torch.serving.faults import FaultPlan
    from tnn_tpu_torch.serving.supervisor import EngineSupervisor

    plan = FaultPlan()
    serve = serve_traffic(model, seed=1, num_requests=2, new_tokens=4,
                          overlap=True, faults=plan)[0]
    events = []
    # the engine is warm (kernels built, its graph captured): arm now
    plan.step_delay_s, plan.step_delay_calls = 0.5, (
        plan.calls["engine.step"] + 6,)
    sup = EngineSupervisor(serve, event_sink=events.append,
                           restart_backoff_s=0.0, watchdog_step_s=0.25,
                           flight_dir=os.path.join(tmp, "watchdog"))
    rids = [sup.submit(p, n, **kw)
            for p, n, kw in traffic_requests(model.vocab_size, 2)]
    reset_all_launches()
    before = dict(serve.program_steps)
    sup.run_sync()
    launches = read_all_launches()
    term = {e["id"]: e for e in events if e["event"] != "token"}
    dumps = [os.path.basename(p) for p in sup.flight_dumps]
    paged = sum(serve.program_steps[k] - before.get(k, 0)
                for k in ("mixed", "pdecode", "spec"))
    fields = dict(restarts=sup.restarts, flight_dumps=dumps,
                  terminal=[term[r]["event"] for r in rids],
                  step_ms_max=max(serve.metrics.step_latency_s) * 1e3,
                  launches=launches, paged_dispatches=paged)
    fields["ok"] = (sup.restarts == 1 and dumps[:1] ==
                    ["flight_001_watchdog.jsonl"]
                    and fields["terminal"] == ["done"] * len(rids)
                    and launches["k1"] == model.num_layers * paged
                    and launches["k3"] == 0)
    log("serving_supervised_watchdog", **fields)
    if not fields["ok"]:
        raise AssertionError(f"watchdog: {fields}")


def restart_budget_check(model):
    """Three crashes against ``max_restarts=2``: FAILED, exit code 1,
    every request terminal (errors), the pool empty."""
    from tnn_tpu_torch.serving.faults import FaultPlan

    plan = FaultPlan(step_crash_calls=(8, 12, 16))
    eng, sup, rids, term, fields = supervised_run(
        model, plan=plan, sup_kw=dict(max_restarts=2))
    fields["ok"] = (sup.state.value == "failed" and sup.exit_code == 1
                    and sup.restarts == 3 and len(term) == len(rids)
                    and fields["pool_allocated"] == 0
                    and launches_hold(fields))
    log("serving_supervised_budget", **fields)
    if not fields["ok"]:
        raise AssertionError(f"restart budget: {fields}")


def drain_checks(model):
    """A drain mid-traffic: STOPPED, exit code 0, every request finished,
    ``drain_duration_s``; with a 1 ms drain deadline the stragglers time
    out."""
    runs = {}
    for name, sup_kw in (("drain", {}),
                         ("deadline_1ms", dict(drain_deadline_s=1e-3))):
        eng, sup, rids, term, fields = supervised_run(
            model, drain_after=40, sup_kw=sup_kw)
        runs[name] = fields
    a, b = runs["drain"], runs["deadline_1ms"]
    ok = (a["state"] == "stopped" and a["exit_code"] == 0
          and a["terminal"]["done"] == 8 and a["drain_duration_s"] > 0
          and b["state"] == "stopped" and b["exit_code"] == 0
          and b["terminal"]["timeout"] >= 1
          and b["terminal"]["done"] + b["terminal"]["timeout"] == 8
          and launches_hold(a) and launches_hold(b))
    log("serving_supervised_drain", ok=ok, **runs)
    if not ok:
        raise AssertionError(f"drain: {runs}")


def traced_ab(model, tmp):
    """The traffic traced (A) and untraced (B) in the order A B B A: the
    same tokens, step time and wall of each; the first traced run's
    Chrome trace written and its spans and instants counted by name."""
    import collections
    import os

    runs = []
    for traced in (True, False, False, True):
        eng, sup, rids, term, fields = supervised_run(model, traced=traced)
        runs.append((traced, eng, rids, fields))
    toks = [[e.result(r).out_tokens for r in rids] for _, e, rids, _ in runs]
    eng = runs[0][1]
    path = os.path.join(tmp, "trace.json")
    eng.profiler.to_chrome_trace(path)
    names = collections.Counter(
        (ev.name.split(" ")[0], ev.start == ev.end)
        for ev in eng.profiler.events)
    fields = dict(
        step_ms_mean={("traced" if t else "untraced") + f"_{i}":
                      f["step_ms_mean"] for i, (t, _, _, f) in
                      enumerate(runs)},
        wall_s=[f["wall_s"] for _, _, _, f in runs],
        identical=all(t == toks[0] for t in toks),
        trace_bytes=os.path.getsize(path),
        instants={n: c for (n, inst), c in sorted(names.items()) if inst},
        spans={n: c for (n, inst), c in sorted(names.items()) if not inst})
    fields["ok"] = fields["identical"] and all(
        launches_hold(f) for _, _, _, f in runs) and all(
        fields["instants"].get(n) for n in (
            "serve.submit", "serve.admit", "serve.prefill_chunk",
            "serve.first_token", "serve.finish", "serve.publish",
            "serve.host_gap", "sup.admit")) and all(
        fields["spans"].get(n) for n in ("serve.mixed", "serve.decode_paged",
                                         "serve.fetch", "serve.decode_spec"))
    log("serving_supervised_traced", **fields)
    if not fields["ok"]:
        raise AssertionError(f"traced against untraced: {fields}")


SUPERVISED_CLI_LINES = [{"id": i, "prompt": f"request {i}: the supervisor "
                         "drains", "max_new_tokens": 48} for i in range(4)]


def supervised_cli(tmp):
    """``cli.serve`` as a subprocess with ``--watchdog-s``, ``--flight-dir``
    and ``--trace`` on text lines: SIGTERM after the first token with stdin
    still open, then a run ended by EOF. Each accepted line gets one
    terminal event; both exit 0; the trace and the drain dump exist."""
    import os
    import signal
    import threading

    base = [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
            "gpt2_small", "--watchdog-s", "30"]
    out = {}
    for how in ("sigterm", "eof"):
        flight = os.path.join(tmp, f"cli_{how}")
        trace = os.path.join(tmp, f"cli_{how}.json")
        t0 = time.perf_counter()
        with open(os.path.join(tmp, f"cli_{how}.err"), "w+") as err:
            proc = subprocess.Popen(
                base + ["--flight-dir", flight, "--trace", trace],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                text=True)
            lines, first = [], threading.Event()

            def read():
                for line in proc.stdout:
                    lines.append(line)
                    first.set()

            reader = threading.Thread(target=read, daemon=True)
            reader.start()
            try:
                proc.stdin.write("".join(json.dumps(x) + "\n"
                                         for x in SUPERVISED_CLI_LINES))
                proc.stdin.flush()
                if not first.wait(300):
                    raise AssertionError(f"CLI ({how}): no event in 300 s")
                if how == "sigterm":
                    proc.send_signal(signal.SIGTERM)
                else:
                    proc.stdin.close()
                proc.wait(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
                if not proc.stdin.closed:
                    proc.stdin.close()
                reader.join(30)
            err.seek(0)
            stderr = err.read()
        events = [json.loads(x) for x in lines if x.strip()]
        term = collections_count(events)
        out[how] = dict(
            returncode=proc.returncode, seconds=time.perf_counter() - t0,
            terminal=term, tokens=sum(e["event"] == "token" for e in events),
            flight_dumps=sorted(os.listdir(flight))
            if os.path.isdir(flight) else [],
            trace=os.path.exists(trace),
            first_event=events[0]["event"] if events else None)
        ok = (proc.returncode == 0 and out[how]["trace"]
              and sorted(term) == list(range(len(SUPERVISED_CLI_LINES)))
              and all(v == 1 for v in term.values())
              and out[how]["flight_dumps"] == ["flight_001_drain.jsonl"])
        out[how]["ok"] = ok
        if not ok:
            log("serving_supervised_cli", **out)
            raise AssertionError(f"supervised CLI ({how}): {out[how]}\n"
                                 f"{stderr[-3000:]}")
    log("serving_supervised_cli", **out)


def collections_count(events):
    """{id: terminal events} over a CLI's event lines."""
    term = {}
    for e in events:
        if e.get("event") in ("done", "error", "timeout", "cancelled"):
            term[e["id"]] = term.get(e["id"], 0) + 1
    return term


def graph_poison_check(model):
    """One staged pdecode step with a NaN in row 0's poison column through
    the eager program and through one replay of the captured graph: equal
    bit for bit (the NaN row's logits included, compared as bits), the
    logit guard down for row 0 only."""
    import torch

    from tnn_tpu_torch.serving import step_build, step_graph
    from tnn_tpu_torch.serving.kv_pool import PagedKVPool

    engine = steady_decode_engine(model, 8, overlap=True)
    graph = engine._decode_graph()
    step = step_build.pack_decode(
        list(engine.scheduler.running), b=engine.scheduler.max_batch_size,
        nb=engine.blocks_per_seq, scratch=PagedKVPool.SCRATCH, paged=True,
        fused_available=False)
    step.poison[0] = float("nan")
    arrays = step_graph.decode_arrays(step)
    state = engine.generator.get_state()
    with torch.inference_mode():
        views = step_build.split_inputs(
            step_graph.stage(arrays).to(engine.device), arrays)
        logits, bundle = engine._pdecode(*views)
        logits, bundle = logits.clone(), bundle.clone()
        engine.generator.set_state(state)
        graph.run(step_graph.stage(arrays))
        torch.cuda.synchronize()
    fields = dict(
        logits_bits_equal=torch.equal(graph.logits.view(torch.int32),
                                      logits.view(torch.int32)),
        bundle_equal=torch.equal(graph.bundle, bundle),
        guard=bundle[1].tolist())
    fields["ok"] = (fields["logits_bits_equal"] and fields["bundle_equal"]
                    and fields["guard"] == [0] + [1] * (len(fields["guard"])
                                                        - 1))
    log("serving_supervised_graph_poison", **fields)
    if not fields["ok"]:
        raise AssertionError(f"poisoned replay against eager: {fields}")


def phase_serving_supervised(results):
    """The serving traffic under ``EngineSupervisor.start()``: fault-free
    against the overlapped loop (token-exact, sampled streams too), a NaN
    row through the pdecode graph against the eager program, one seeded
    fault plan on the bf16 pool, on the int8 pool and weights and under
    FP32, the watchdog after a warm-up, the restart budget, the drain
    (and a 1 ms drain deadline), traced against untraced (ABBA) and the
    supervised CLI (SIGTERM and EOF)."""
    import tempfile

    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo

    model = zoo.create("gpt2_small", device="cuda", seed=0)
    # first-use costs off the clock: kernels, one graph capture
    serve_traffic(model, seed=1, num_requests=2, new_tokens=4, overlap=True)
    # the supervised traffic on its worker thread (A), the overlapped loop
    # (B) and the same supervisor driven inline by run_sync (C), in the
    # order A B C C B A: where the supervisor's step time goes
    runs, sup_fields = {"supervised": [], "loop": [], "inline": []}, []
    for name in ("supervised", "loop", "inline", "inline", "loop",
                 "supervised"):
        if name != "loop":
            eng, _, rids, _, f = supervised_run(
                model, threaded=name == "supervised")
            sup_fields.append(f)
            runs[name].append((eng, rids, f["wall_s"]))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop, loop_rids = serve_traffic(model, seed=0, overlap=True)
            torch.cuda.synchronize()
            runs[name].append((loop, loop_rids, time.perf_counter() - t0))
    ref, ref_rids, _ = runs["loop"][0]
    same = [eng.result(a).out_tokens == ref.result(b).out_tokens
            for eng, rids, _ in runs["supervised"] + runs["inline"]
            for a, b in zip(rids, ref_rids)]
    fields = dict(sup_fields[0])
    fields.update(identical_to_loop=sum(same), requests=len(same),
                  sampled_requests=len(same) // 2, ab={
                      name: {"wall_s": [w for _, _, w in rs],
                             "step_ms_mean": [
                                 e.stats()["step_latency_ms_mean"]
                                 for e, _, _ in rs]}
                      for name, rs in runs.items()})
    fields["ok"] = len(same) == 32 and all(same) and all(
        launches_hold(f) and f["terminal"]["done"] == 8
        and f["state"] == "stopped" and f["exit_code"] == 0
        for f in sup_fields)
    log("serving_supervised_run", **fields)
    if not fields["ok"]:
        raise AssertionError(f"supervised against the loop: {fields}")
    results["launches"] += fields["launches"]["k1"]
    del runs, eng, loop
    graph_poison_check(model)
    bf16 = chaos_run(model, "bf16", exact=False)
    results["launches"] += bf16["launches"]["k1"]
    i8 = chaos_run(model, "int8", exact=False, **INT8_SERVING)
    results["int8_launches"]["k2"] += i8["launches"]["k2"]
    results["int8_launches"]["k3"] += i8["launches"]["k3"]
    if i8["launches"]["k3"] == 0:
        raise AssertionError("the int8 chaos run launched no K3")
    with tempfile.TemporaryDirectory() as tmp:
        watchdog_check(model, tmp)
        restart_budget_check(model)
        drain_checks(model)
        traced_ab(model, tmp)
        torch.cuda.empty_cache()
        supervised_cli(tmp)
    del model
    torch.cuda.empty_cache()
    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    chaos_run(fp32, "fp32", exact=True)
    del fp32
    torch.cuda.empty_cache()


# -- phase 23 -----------------------------------------------------------------

FLEET_ENGINE = dict(num_blocks=512, block_size=16, max_batch_size=8,
                    chunk_size=64)
FLEET_WAIT_S = 180.0          # the longest any wait of the phase may take
DISAGG_THRESHOLD = 256


class FleetSink:
    """A router's event sink (on the replicas' worker threads): every
    event, each stream's tokens and their arrival times, one terminal
    event per request (a second raises), ``done`` set when ``expect``
    terminals arrived, ``tokens_seen`` set at the ``token_mark``-th token
    event."""

    def __init__(self, expect, token_mark=None):
        import threading

        self.expect, self.token_mark = expect, token_mark
        self.streamed, self.times, self.term = {}, {}, {}
        self.tokens = 0
        self.done = threading.Event()
        self.tokens_seen = threading.Event()
        self.errors = []

    def __call__(self, ev):
        gid = ev["id"]
        if ev["event"] == "token":
            self.streamed.setdefault(gid, []).append(ev["token"])
            self.times.setdefault(gid, []).append(time.perf_counter())
            self.tokens += 1
            if self.token_mark is not None and \
                    self.tokens == self.token_mark:
                self.tokens_seen.set()
        elif gid in self.term:
            self.errors.append(f"two terminal events for {gid}")
        else:
            self.term[gid] = ev
            if len(self.term) >= self.expect:
                self.done.set()

    def exactly_once(self, gids):
        """Every request one terminal event, ``done``, with its streamed
        tokens equal to its final ones (none duplicated or dropped)."""
        return not self.errors and all(
            self.term.get(g, {}).get("event") == "done"
            and self.term[g]["tokens"] == self.streamed.get(g, [])
            for g in gids)

    def gap_ms(self, gid):
        t = self.times.get(gid, [])
        return max((b - a for a, b in zip(t, t[1:])), default=0.0) * 1e3


def fleet_engines(model, n, seed=0, **engine_kw):
    from tnn_tpu_torch.serving.engine import InferenceEngine
    from tnn_tpu_torch.serving.supervisor import EngineSupervisor

    kw = {**FLEET_ENGINE, "overlap": True, **engine_kw}
    engines = [InferenceEngine(model, seed=seed, device=model.device, **kw)
               for _ in range(n)]
    sups = [EngineSupervisor(e, restart_backoff_s=0.0, idle_wait_s=0.005)
            for e in engines]
    return engines, sups


def fleet_expected(model, engines, wide):
    """The launch identities summed over a fleet's engines (every engine
    that stepped, a killed one included); K3 = 49 x the fleet's wide
    mixed steps."""
    want = {}
    for e in engines:
        for k, v in expected_launches(model, e, 0).items():
            want[k] = want.get(k, 0) + v
    if engines[0].quant_weights:
        want["k3"] = (4 * model.num_layers + 1) * wide
    want["k4"] = 0
    return want


def fleet_run(model, reqs, n=2, *, router_kw=None, engine_kw=None,
              kill_after=None, before=None):
    """``reqs`` through a started ``Router`` over ``n`` supervised replicas
    (overlap on, pools of 512 x 16): submit all, wait for one terminal
    each, drain, join. ``kill_after``: once that many token events
    arrived, ``kill_replica`` the replica holding the most live streams.
    ``before(router)`` runs after the start, before the submits. Launches
    are counted over the run alone. Returns a dict of the run."""
    import torch

    from tnn_tpu_torch.serving.router import Router

    engines, sups = fleet_engines(model, n, **(engine_kw or {}))
    sink = FleetSink(len(reqs), token_mark=kill_after)
    # the monitor probes at the router's default interval (the CLI's)
    # unless a step asks for a faster one
    router = Router(sups, event_sink=sink, seed=0, **(router_kw or {}))
    torch.cuda.synchronize()
    reset_all_launches()
    out = {}

    def drive():
        router.start()
        if before is not None:
            before(router)
        out["t0"] = time.perf_counter()
        gids, placed = [], []
        for p, m, kw in reqs:
            gids.append(router.submit(p, m, **kw))
            rec = router._open.get(gids[-1])
            placed.append(None if rec is None else rec.replica)
        if kill_after is not None:
            if not sink.tokens_seen.wait(FLEET_WAIT_S):
                raise AssertionError("fleet: the kill mark never came")
            victim = max(router.replicas, key=lambda h: len(h.live))
            out["victim"] = victim.idx
            out["victim_streams"] = sorted(victim.live)
            router.kill_replica(victim.idx)
        if not sink.done.wait(FLEET_WAIT_S):
            raise AssertionError(f"fleet: {len(sink.term)} of {len(reqs)} "
                                 f"terminal events after {FLEET_WAIT_S}s")
        out["served_s"] = time.perf_counter() - out["t0"]
        router.request_drain("traffic done")
        if not router.join(FLEET_WAIT_S):
            raise AssertionError("fleet: the router did not stop")
        out["wall_s"] = time.perf_counter() - out["t0"]
        return gids, placed

    (gids, placed), wide = count_wide_steps(drive)
    torch.cuda.synchronize()
    launches = read_all_launches()
    st = router.stats()
    decode = sum(e.stats()["decode_tokens"] for e in engines)
    steps = [(e.stats()["steps"], e.stats()["step_latency_ms_mean"])
             for e in engines]
    out.update(
        router=router, engines=engines, sink=sink, gids=gids,
        fields=dict(
            placed=placed, state=router.state.value,
            exit_code=router.exit_code, launches=launches,
            expected_launches=fleet_expected(model, engines, wide),
            program_steps=[e.stats()["program_steps"] for e in engines],
            graph_replays=[e.stats()["graph_replays"] for e in engines],
            served_s=out["served_s"], wall_s=out["wall_s"],
            decode_tok_per_s=decode / out["wall_s"],
            step_ms_mean=sum(s * m for s, m in steps)
            / max(1, sum(s for s, _ in steps)),
            terminal={k: sum(e["event"] == k for e in sink.term.values())
                      for k in ("done", "error", "timeout", "cancelled")},
            exactly_once=sink.exactly_once(gids),
            migrated=st["migrated_requests"],
            router_retries=st["router_retries"],
            boundary_handoffs=st["boundary_handoffs"],
            handoff_fallbacks=st["handoff_fallbacks"],
            fleet_prefix_pulls=st["fleet_prefix_pulls"],
            hedges={k: st[k] for k in ("hedges_fired", "hedges_won",
                                       "hedges_cancelled")},
            degraded_ejections=st["degraded_ejections"]))
    out["fields"]["launches_hold"] = \
        launches == out["fields"]["expected_launches"]
    return out


def done_tokens(run, gids=None):
    sink = run["sink"]
    return [sink.term[g]["tokens"] for g in (gids or run["gids"])]


def single_run(model, reqs, **engine_kw):
    """``reqs`` through one engine (the fleet's engine settings, the
    overlapped loop); returns (engine, tokens per request, wall)."""
    import torch

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(model, seed=0, device=model.device,
                             **{**FLEET_ENGINE, "overlap": True,
                                **engine_kw})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [engine.submit(p, m, **kw) for p, m, kw in reqs]
    engine.run_until_complete()
    torch.cuda.synchronize()
    return engine, [engine.result(r).out_tokens for r in rids], \
        time.perf_counter() - t0


def greedy(reqs):
    return [i for i, (_, _, kw) in enumerate(reqs)
            if kw.get("temperature", 0.0) == 0.0]


def fleet_streams(model, reqs, ref, got, gate):
    idx = greedy(reqs)
    return compare_streams(model, [reqs[i][0] for i in idx],
                           [ref[i] for i in idx], [got[i] for i in idx],
                           gate)


def fleet_check(name, ok, fields):
    fields["ok"] = bool(ok)
    log(name, **fields)
    if not ok:
        raise AssertionError(f"{name}: {fields}")


def fleet_traffic_ab(model, fp32, results):
    """Step 1: the serving traffic on a fleet of 2 under ``Router.start()``
    against one supervised engine, bf16 in the order fleet, one, router
    over one replica, router over one, one, fleet (where the fleet's time
    goes: the router alone, then the second replica); then FP32 once
    each, greedy streams token for token."""
    reqs = traffic_requests(model.vocab_size, 0)
    arms = {"fleet": [], "single": [], "router1": []}
    for name in ("fleet", "single", "router1", "router1", "single",
                 "fleet"):
        if name != "single":
            run = fleet_run(model, reqs, n=2 if name == "fleet" else 1)
            arms[name].append(run)
        else:
            eng, _, rids, _, f = supervised_run(model)
            arms[name].append((eng, rids, f))
    ref_eng, ref_rids, _ = arms["single"][0]
    ref = [ref_eng.result(r).out_tokens for r in ref_rids]
    a = arms["fleet"][0]
    agree = fleet_streams(model, reqs, ref, done_tokens(a), "report")
    fields = dict(
        placements=[r["fields"]["placed"] for r in arms["fleet"]],
        fleet=[{k: r["fields"][k] for k in (
            "decode_tok_per_s", "step_ms_mean", "wall_s", "launches",
            "program_steps", "graph_replays", "terminal", "exactly_once",
            "launches_hold")} for r in arms["fleet"]],
        router1=[{k: r["fields"][k] for k in (
            "decode_tok_per_s", "step_ms_mean", "wall_s", "launches_hold")}
            for r in arms["router1"]],
        single=[{"decode_tok_per_s": e.stats()["decode_tokens"]
                 / f["wall_s"], "step_ms_mean": f["step_ms_mean"],
                 "wall_s": f["wall_s"]} for e, _, f in arms["single"]],
        bf16_agreement=agree)
    ok = all(r["fields"]["launches_hold"] and r["fields"]["exactly_once"]
             and r["fields"]["terminal"]["done"] == 8
             and r["fields"]["exit_code"] == 0
             and len(set(r["fields"]["placed"])) == 2
             for r in arms["fleet"]) and all(
        r["fields"]["launches_hold"] and r["fields"]["exactly_once"]
        for r in arms["router1"])
    fleet_check("serving_fleet_traffic", ok, fields)
    results["launches"] += sum(r["fields"]["launches"]["k1"]
                               for r in arms["fleet"] + arms["router1"])
    del arms
    # FP32: the fleet's greedy streams against one engine's
    _, fref, _ = single_run(fp32, reqs)
    run = fleet_run(fp32, reqs)
    exact = fleet_streams(fp32, reqs, fref, done_tokens(run), "exact")
    fleet_check("serving_fleet_fp32", run["fields"]["launches_hold"]
                and run["fields"]["exactly_once"], dict(
                    streams=exact, placed=run["fields"]["placed"],
                    launches=run["fields"]["launches"]))
    results["launches"] += run["fields"]["launches"]["k1"]
    return reqs, fref


def fleet_replay_check(model, results):
    """Two replicas started together, each capturing its pdecode graph on
    its own worker (captures serialized by ``step_graph._CAPTURE_LOCK``):
    once both stream, each replica's next staged step through the graph
    is equal to its eager program bit for bit (``replay_vs_eager`` on the
    replica's own worker, between steps: synchronous engines, so no step
    is in flight; a row whose next token opens a block gets it first, as
    the engine's step gives it)."""
    import numpy as np

    from tnn_tpu_torch.serving import step_graph
    from tnn_tpu_torch.serving.router import Router

    engines, sups = fleet_engines(model, 2, overlap=False)
    rng = np.random.default_rng(11)
    # prompts of 16k + 2 tokens: the check lands near a row's block
    # boundary (about 14 tokens in), where replay_vs_eager grows the
    # row's table first; boundary_rows says whether a check met one
    reqs = [(rng.integers(0, model.vocab_size, 66 + 16 * i), 48, {})
            for i in range(4)]
    sink = FleetSink(len(reqs), token_mark=12)
    router = Router(sups, event_sink=sink, seed=0, probe_interval_s=0.01)
    reset_all_launches()
    router.start()
    for p, m, kw in reqs:
        router.submit(p, m, **kw)
    if not sink.tokens_seen.wait(FLEET_WAIT_S):
        raise AssertionError("replay check: the replicas never streamed")

    def locked_check(engine):
        # replay_vs_eager synchronizes the device, which fails while the
        # other replica's worker is inside a capture: hold the capture
        # lock (reentrant: the check may capture the graph itself)
        with step_graph._CAPTURE_LOCK:
            return replay_vs_eager(engine)

    checks = [sup.execute(lambda e=e: locked_check(e))
              for e, sup in zip(engines, sups)]
    if not sink.done.wait(FLEET_WAIT_S):
        raise AssertionError("replay check: the traffic never finished")
    router.request_drain("check done")
    router.join(FLEET_WAIT_S)
    launches = read_all_launches()
    want = fleet_expected(model, engines, 0)
    # the checks' eager programs and replays launch K1 off the books of
    # program_steps: 12 each
    extra = 2 * model.num_layers * len(checks)
    fields = dict(checks=checks, graphs=[e.stats()["step_graphs"]
                                         for e in engines],
                  replays=[e.stats()["graph_replays"] for e in engines],
                  launches=launches, expected_k1=want["k1"] + extra,
                  exactly_once=sink.exactly_once(sorted(sink.term)))
    fleet_check("serving_fleet_replay",
                all(c["logits_equal"] and c["bundle_equal"]
                    and c["generator_equal"] for c in checks)
                and launches["k1"] == want["k1"] + extra
                and all(g == 1 for g in fields["graphs"])
                and fields["exactly_once"], fields)
    results["launches"] += launches["k1"]


def fleet_kill(fp32, reqs, fref, results):
    """Step 2: ``kill_replica`` mid-stream after 16 streamed tokens (FP32):
    the migrated streams token-exact, nothing duplicated or dropped, the
    survivor leaks no block; the longest token gap of the migrated
    streams."""
    run = fleet_run(fp32, reqs, kill_after=16)
    router, sink = run["router"], run["sink"]
    exact = fleet_streams(fp32, reqs, fref, done_tokens(run), "exact")
    victim = run["victim"]
    survivors = [e for i, e in enumerate(run["engines"]) if i != victim]
    for e in survivors:
        e.check_invariants()
    migrated = run["victim_streams"]
    fields = dict(victim=victim, migrated_streams=migrated,
                  migrated=run["fields"]["migrated"],
                  streams=exact, exactly_once=run["fields"]["exactly_once"],
                  survivor_pool_allocated=[e.pool.num_allocated
                                           for e in survivors],
                  migrated_token_gap_ms_max=[sink.gap_ms(g)
                                             for g in migrated],
                  released=[h.released for h in router.replicas],
                  launches=run["fields"]["launches"],
                  launches_hold=run["fields"]["launches_hold"])
    fleet_check("serving_fleet_kill",
                run["fields"]["exactly_once"] and migrated
                and run["fields"]["migrated"] >= len(migrated)
                and all(e.pool.num_allocated == 0 for e in survivors)
                and run["fields"]["launches_hold"], fields)
    results["launches"] += run["fields"]["launches"]["k1"]


def handoff_costs(model, label, **engine_kw):
    """One engine prefills a 512-token prompt; its chain is exported
    (``export_prefix``) and adopted by a second engine (``adopt_prefix``),
    both timed (the export is one synchronous copy to the host); the
    adopted blocks read back byte-equal to the wire."""
    import numpy as np
    import torch

    from tnn_tpu_torch.serving.engine import InferenceEngine

    kw = {**FLEET_ENGINE, **engine_kw}
    a = InferenceEngine(model, device=model.device, **kw)
    b = InferenceEngine(model, device=model.device, **kw)
    prompt = np.random.default_rng(31).integers(0, model.vocab_size, 512)
    a.submit(prompt, 1)
    a.run_until_complete()
    times = {"export": [], "adopt": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex = a.export_prefix(prompt)
        times["export"].append(time.perf_counter() - t0)
        fresh = InferenceEngine(model, device=model.device, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.adopt_prefix(ex)
        torch.cuda.synchronize()
        times["adopt"].append(time.perf_counter() - t0)
        del fresh
    b.adopt_prefix(ex)
    equal = all(
        all(np.array_equal(x, y) for x, y in zip(
            b.pool.export_blocks([b.prefix_cache.block_of(k)])[0], lv))
        for k, lv, _ in ex)
    blocks = len(ex)
    fields = dict(
        pool=label, blocks=blocks,
        wire_bytes_per_block=sum(x.nbytes for x in ex[0][1]),
        leaves=[str(x.dtype) for x in ex[0][1]],
        export_ms_per_block=[t * 1e3 / blocks for t in times["export"]],
        adopt_ms_per_block=[t * 1e3 / blocks for t in times["adopt"]],
        read_back_byte_equal=equal)
    return fields


def fleet_disagg(model, fp32, results):
    """Step 3: roles prefill + decode, threshold 256: four 512-token
    prompts and two short ones, FP32, with the KV handoff and without
    (recompute), token-exact against one engine; blocks shipped, the
    receiver's saved prefill, the long streams' first-to-second token gap;
    the wire's bytes and export / adopt ms per block on the bf16, f32 and
    int8 pools (the adopted int8 block byte-equal); the int8 pool and
    weights through the same fleet (K2, K3)."""
    import numpy as np

    rng = np.random.default_rng(23)
    reqs = [(rng.integers(0, model.vocab_size, 512), 32, {})
            for _ in range(4)]
    reqs += [(rng.integers(0, model.vocab_size, 64), 32, {})
             for _ in range(2)]
    _, ref, _ = single_run(fp32, reqs)
    rkw = dict(roles=["prefill", "decode"],
               disagg_prompt_threshold=DISAGG_THRESHOLD)
    out, ok = {}, True
    for kv in (True, False):
        run = fleet_run(fp32, reqs, router_kw=dict(rkw, handoff_kv=kv))
        recv, send = (e.stats() for e in run["engines"][::-1])
        long_gaps = [(t[1] - t[0]) * 1e3 for t in
                     (run["sink"].times[g] for g in run["gids"][:4])]
        f = run["fields"]
        out["kv" if kv else "recompute"] = dict(
            streams=fleet_streams(fp32, reqs, ref, done_tokens(run),
                                  "exact"),
            placed=f["placed"], boundary_handoffs=f["boundary_handoffs"],
            handoff_fallbacks=f["handoff_fallbacks"],
            exported_blocks=send["handoff_exported_blocks"],
            adopted_blocks=recv["handoff_adopted_blocks"],
            receiver_prefill_tokens_saved=recv["prefill_tokens_saved"],
            first_to_second_token_ms=long_gaps,
            launches=f["launches"], launches_hold=f["launches_hold"],
            exactly_once=f["exactly_once"])
        ok = ok and f["launches_hold"] and f["exactly_once"] \
            and f["boundary_handoffs"] == 4 \
            and f["placed"] == [0, 0, 0, 0, 1, 1]
        if kv:
            ok = ok and f["handoff_fallbacks"] == 0 \
                and recv["handoff_adopted_blocks"] > 0 \
                and recv["prefill_tokens_saved"] > 0
        results["launches"] += f["launches"]["k1"]
    costs = [handoff_costs(model, "bf16"), handoff_costs(fp32, "f32"),
             handoff_costs(model, "int8", kv_dtype="int8")]
    # K and V of one block over every layer and head (gpt2_small: 589,824
    # B bf16, 1,179,648 f32, 313,344 int8 with its f32 scales)
    page = model.num_layers * model.num_kv_heads * FLEET_ENGINE[
        "block_size"] * (model.d_model // model.num_heads)
    scales = model.num_layers * model.num_kv_heads * FLEET_ENGINE[
        "block_size"] * 4
    want_bytes = {"bf16": 2 * 2 * page, "f32": 2 * 4 * page,
                  "int8": 2 * (page + scales)}
    out["wire_bytes_expected"] = want_bytes
    ok = ok and all(c["wire_bytes_per_block"] == want_bytes[c["pool"]]
                    and c["read_back_byte_equal"] and c["blocks"] == 32
                    for c in costs)
    run = fleet_run(model, reqs, router_kw=rkw, engine_kw=INT8_SERVING)
    f = run["fields"]
    # the prefill replica's chain of each long prompt against the blocks
    # the decode replica adopted, leaf for leaf (int8 data and scales)
    send, recv = run["engines"]
    equal = []
    for p, _, _ in reqs[:4]:
        a, b = send.export_prefix(p), recv.export_prefix(p)
        equal.append(len(a) == len(b) == 32 and all(
            x[0] == y[0] and x[2] == y[2] and all(
                np.array_equal(u, v) for u, v in zip(x[1], y[1]))
            for x, y in zip(a, b)))
    out["int8_fleet"] = dict(launches=f["launches"],
                             expected=f["expected_launches"],
                             boundary_handoffs=f["boundary_handoffs"],
                             handoff_fallbacks=f["handoff_fallbacks"],
                             adopted_blocks_byte_equal=equal,
                             exactly_once=f["exactly_once"])
    ok = ok and f["launches_hold"] and f["exactly_once"] and all(equal) \
        and f["launches"]["k2"] > 0 and f["launches"]["k3"] > 0
    results["int8_launches"]["k2"] += f["launches"]["k2"]
    results["int8_launches"]["k3"] += f["launches"]["k3"]
    out["wire"] = costs
    fleet_check("serving_fleet_disagg", ok, out)


def tier_sequence(fp32, tier_bytes):
    """A 512-token prefix served, evicted by fillers of 480, 480 and 32
    tokens (the last pushes the prefix's first block out too: a readmit
    walk whose allocation reclaimed a still-resident first block would
    break its own chain, as in the JAX engine), then asked for again with
    another tail, one at a time on a 64-block pool (FP32); returns
    (engine, prompts, tokens, the return's TTFT, demote times, the
    replay-against-eager check)."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(fp32, num_blocks=64, block_size=16,
                             max_batch_size=8, chunk_size=64, seed=0,
                             device=fp32.device, overlap=True,
                             host_tier_bytes=tier_bytes)
    demotes = []
    if tier_bytes:
        hook = engine.pool.demote_hook

        def timed(blocks):
            t0 = time.perf_counter()
            hook(blocks)
            demotes.append((len(blocks), time.perf_counter() - t0))

        engine.pool.demote_hook = timed
    rng = np.random.default_rng(41)
    prefix = rng.integers(0, fp32.vocab_size, 512)
    prompts = [np.concatenate([prefix, rng.integers(0, fp32.vocab_size,
                                                    16)])]
    prompts += [rng.integers(0, fp32.vocab_size, n) for n in (480, 480, 32)]
    tokens = []
    for p in prompts:
        rid = engine.submit(p, 32)
        engine.run_until_complete()
        tokens.append(engine.result(rid).out_tokens)
    back = np.concatenate([prefix, rng.integers(0, fp32.vocab_size, 16)])
    rid = engine.submit(back, 32)
    # one token in: its next position, 528, opens a block, which
    # replay_vs_eager grows first as the engine's step would (a staged step
    # without it would write the scratch page the padded rows share)
    while len(engine.result(rid).out_tokens) < 1:
        engine.step()
    replay = replay_vs_eager(engine)
    engine.run_until_complete()
    tokens.append(engine.result(rid).out_tokens)
    engine.check_invariants()
    return engine, prompts + [back], tokens, \
        engine.result(rid).ttft_s * 1e3, demotes, replay


def fleet_tier(fp32):
    """Step 4: the host tier on one replica (64 blocks, 64 MiB of host
    RAM), tier on against off: the readmitted blocks, the tokens saved,
    the return's TTFT, token-exact streams, the demote cost per block,
    the host gap and step time; a pdecode replay after the readmit, its
    row at a block boundary, equal to the eager program."""
    on, prompts, got, ttft_on, demotes, replay = tier_sequence(fp32, 64 << 20)
    off, _, ref, ttft_off, _, replay_off = tier_sequence(fp32, 0)
    s_on, s_off = on.stats(), off.stats()
    blocks = sum(n for n, _ in demotes)
    fields = dict(
        streams=compare_streams(fp32, prompts, ref, got, "exact"),
        tier_demotions=s_on["tier_demotions"],
        tier_readmits=s_on["tier_readmits"],
        tier_bytes=s_on["tier_bytes"],
        prefill_tokens_saved={"on": s_on["prefill_tokens_saved"],
                              "off": s_off["prefill_tokens_saved"]},
        return_ttft_ms={"on": ttft_on, "off": ttft_off},
        demote_ms_per_block=sum(t for _, t in demotes) * 1e3
        / max(blocks, 1), demote_calls=len(demotes),
        host_gap_ms_mean={"on": s_on["host_gap_ms_mean"],
                          "off": s_off["host_gap_ms_mean"]},
        step_ms_mean={"on": s_on["step_latency_ms_mean"],
                      "off": s_off["step_latency_ms_mean"]},
        replay_after_readmit=replay)
    fleet_check("serving_fleet_tier",
                s_on["tier_readmits"] >= 32
                and s_on["prefill_tokens_saved"] >= 512
                > s_off["prefill_tokens_saved"]
                and replay["logits_equal"] and replay["bundle_equal"]
                and replay["generator_equal"] and replay["boundary_rows"] == 1
                and s_on["tier_corrupt_dropped"] == 0, fields)


def fleet_prefix_pull(fp32, results):
    """Step 5: ``fleet_prefix=True``: a 512-token prefix computed on
    replica 0 (the prefill role: 608 tokens, over the 600 threshold) is
    pulled by a sharer placed on replica 1 (544 tokens); token-exact
    against one engine."""
    import numpy as np

    rng = np.random.default_rng(51)
    prefix = rng.integers(0, fp32.vocab_size, 512)
    seeder = (np.concatenate([prefix, rng.integers(0, fp32.vocab_size,
                                                   96)]), 1, {})
    sharer = (np.concatenate([prefix, rng.integers(0, fp32.vocab_size,
                                                   32)]), 16, {})
    _, ref, _ = single_run(fp32, [seeder, sharer])

    def before(router):
        sink = router.event_sink
        sink.expect = 1
        router.submit(*seeder[:2])
        if not sink.done.wait(FLEET_WAIT_S):
            raise AssertionError("fleet prefix: the seeder never finished")
        router._refresh_prefix_dir()
        sink.done.clear()
        sink.expect = 2

    run = fleet_run(fp32, [sharer], router_kw=dict(
        roles=["prefill", "decode"], disagg_prompt_threshold=600,
        fleet_prefix=True), before=before)
    recv = run["engines"][1].stats()
    got = [run["sink"].term[g]["tokens"] for g in sorted(run["sink"].term)]
    fields = dict(
        fleet_prefix_pulls=run["fields"]["fleet_prefix_pulls"],
        adopted_blocks=recv["handoff_adopted_blocks"],
        receiver_prefill_tokens_saved=recv["prefill_tokens_saved"],
        placed=run["fields"]["placed"],
        streams=compare_streams(fp32, [seeder[0], sharer[0]], ref, got,
                                "exact"),
        launches_hold=run["fields"]["launches_hold"])
    fleet_check("serving_fleet_prefix",
                run["fields"]["fleet_prefix_pulls"] == 1
                and recv["handoff_adopted_blocks"] >= 32
                and recv["prefill_tokens_saved"] >= 512
                and run["fields"]["placed"] == [1]
                and run["fields"]["launches_hold"], fields)
    results["launches"] += run["fields"]["launches"]["k1"]


def fleet_hedge(model, results):
    """Step 6: hedging on a fleet of 2 with replica 1 slowed by 0.2 s a
    step (``slow_replica``) and ``hedge_ttft_s=0.05``: hedges fired and
    won, every stream exactly once."""
    import numpy as np

    rng = np.random.default_rng(61)
    reqs = [(rng.integers(0, model.vocab_size, 64), 16, {})
            for _ in range(4)]

    def before(router):
        # warm both replicas (their first decode steps capture graphs)
        sink = router.event_sink
        sink.expect = 2
        for _ in range(2):
            router.submit(rng.integers(0, model.vocab_size, 32), 2)
        if not sink.done.wait(FLEET_WAIT_S):
            raise AssertionError("hedge: the warm-up never finished")
        sink.done.clear()
        sink.expect = 6
        router.slow_replica(1, 0.2)

    run = fleet_run(model, reqs, router_kw=dict(
        hedge_ttft_s=0.05, hedge_budget=1.0, probe_interval_s=0.01),
        before=before)
    f = run["fields"]
    fields = dict(hedges=f["hedges"], placed=f["placed"],
                  degraded_ejections=f["degraded_ejections"],
                  migrated=f["migrated"], served_s=f["served_s"],
                  exactly_once=f["exactly_once"], terminal=f["terminal"],
                  launches=f["launches"], launches_hold=f["launches_hold"])
    fleet_check("serving_fleet_hedge",
                f["hedges"]["hedges_fired"] >= 1
                and f["hedges"]["hedges_won"] >= 1
                and f["exactly_once"] and f["launches_hold"], fields)
    results["launches"] += f["launches"]["k1"]


def fleet_autoscale(model, results):
    """Step 7: an autoscaler 1..3 over a started router under a burst of
    24 requests: the replica count over time, every request ``done`` once
    (zero-loss scale-down), device memory with the fleet at its largest
    and after the retired replicas gave their pools back."""
    import numpy as np
    import torch

    from tnn_tpu_torch.serving.autoscaler import Autoscaler
    from tnn_tpu_torch.serving.router import Router

    engines, sups = fleet_engines(model, 1)
    built = list(engines)

    def factory():
        e, s = fleet_engines(model, 1)
        built.extend(e)
        return s[0]

    rng = np.random.default_rng(71)
    reqs = [(rng.integers(0, model.vocab_size, int(rng.integers(64, 257))),
             32, {}) for _ in range(24)]
    sink = FleetSink(len(reqs))
    router = Router(sups, event_sink=sink, seed=0, probe_interval_s=0.01)
    scaler = Autoscaler(router, factory, min_replicas=1, max_replicas=3,
                        up_load=4.0, down_load=1.0, hysteresis_s=0.25,
                        cooldown_s=0.5)
    torch.cuda.synchronize()
    reset_all_launches()
    timeline, mem = [], {}

    def drive():
        router.start()
        scaler.start()
        t0 = time.perf_counter()
        gids = [router.submit(p, m, **kw) for p, m, kw in reqs]
        last = None
        while time.perf_counter() - t0 < FLEET_WAIT_S:
            n = router.num_active_replicas()
            if n != last:
                timeline.append((round(time.perf_counter() - t0, 3), n))
                last = n
            if n == 3 and "largest" not in mem:
                mem["largest"] = torch.cuda.memory_allocated()
            if sink.done.is_set() and n == 1 and all(
                    h.released for h in router.replicas if h.retired):
                break
            time.sleep(0.02)
        mem["after_retire"] = torch.cuda.memory_allocated()
        scaler.stop()
        router.request_drain("traffic done")
        if not router.join(FLEET_WAIT_S):
            raise AssertionError("autoscale: the router did not stop")
        return gids

    gids, wide = count_wide_steps(drive)
    torch.cuda.synchronize()
    launches = read_all_launches()
    want = fleet_expected(model, built, wide)
    st = scaler.stats()
    fields = dict(replicas_over_time=timeline, scaler=st,
                  exactly_once=sink.exactly_once(gids),
                  terminal={k: sum(e["event"] == k
                                   for e in sink.term.values())
                            for k in ("done", "error")},
                  memory_allocated_mb={k: v / 2 ** 20
                                       for k, v in mem.items()},
                  released=[h.released for h in router.replicas],
                  launches=launches, launches_hold=launches == want)
    fleet_check("serving_fleet_autoscale",
                st["scale_ups"] >= 1 and st["scale_downs"] >= 1
                and sink.exactly_once(gids) and launches == want
                and "largest" in mem
                and mem["after_retire"] < mem["largest"], fields)
    results["launches"] += launches["k1"]


def http_call(port, method, path, body=None, timeout=120):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def sse_stream(port, body, on_event=None, timeout=300):
    """POST /v1/generate with SSE; returns (status, events)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    events = []
    while True:
        line = resp.fp.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            ev = json.loads(line[6:])
            events.append(ev)
            if on_event is not None:
                on_event(ev)
            if ev.get("event") not in ("start", "token"):
                break
    conn.close()
    return resp.status, events


def prometheus_samples(text):
    types, samples = {}, []
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            types[name] = kind
        elif ln and not ln.startswith("#"):
            metric, value = ln.rsplit(" ", 1)
            labels = {}
            if "{" in metric:
                metric, _, rest = metric.partition("{")
                for pair in rest.rstrip("}").split(","):
                    k, _, v = pair.partition("=")
                    labels[k] = v.strip('"')
            samples.append((metric, labels, float(value)))
    return types, samples


HTTP_CLI_ENGINE = dict(num_blocks=64, block_size=16, max_batch_size=8,
                       chunk_size=64)


def fleet_http(model):
    """Step 8: ``cli.serve --replicas 2 --http 127.0.0.1:0`` as a
    subprocess: SSE on 4 concurrent requests and one non-stream request;
    one-at-a-time greedy tokens against an in-process router of the same
    engines; health, stats, /metrics (replica labels, histogram buckets),
    cancel; SIGTERM mid-stream: health 503 while draining, the stream
    done, exit code 0."""
    import signal
    import threading

    import numpy as np

    from tnn_tpu_torch.serving.router import Router

    rng = np.random.default_rng(81)
    prompts = [rng.integers(0, model.vocab_size, 32).tolist()
               for _ in range(4)]
    # the in-process router over the CLI's engine settings, one at a time
    engines, sups = fleet_engines(model, 2, **HTTP_CLI_ENGINE)
    sink = FleetSink(1)
    router = Router(sups, event_sink=sink, seed=0).start()
    want = []
    for i, p in enumerate(prompts):
        sink.expect = i + 1
        sink.done.clear()
        gid = router.submit(np.asarray(p), 16)
        if not sink.done.wait(FLEET_WAIT_S):
            raise AssertionError("http: the in-process router stalled")
        want.append(sink.term[gid]["tokens"])
    router.request_drain("reference done")
    router.join(FLEET_WAIT_S)
    del engines, sups, router
    out = {}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_small", "--replicas", "2", "--http", "127.0.0.1:0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        port = None
        t0 = time.perf_counter()
        for line in proc.stderr:
            lines.append(line)
            if "listening on http://" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        if port is None:
            raise AssertionError("http: no listening line: "
                                 + "".join(lines)[-3000:])
        out["start_s"] = time.perf_counter() - t0
        pump = threading.Thread(
            target=lambda: lines.extend(proc.stderr), daemon=True)
        pump.start()
        got = [sse_stream(port, {"tokens": p, "max_new_tokens": 16})
               for p in prompts]
        out["one_at_a_time_equal"] = [
            s == 200 and ev[-1]["event"] == "done"
            and ev[-1]["tokens"] == w
            and [e["token"] for e in ev if e["event"] == "token"] == w
            for (s, ev), w in zip(got, want)]
        conc = [None] * 4

        def stream(i):
            conc[i] = sse_stream(port, {"tokens": prompts[i],
                                        "max_new_tokens": 16})

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(FLEET_WAIT_S)
        out["concurrent_s"] = time.perf_counter() - t0
        out["concurrent_done"] = [c is not None and c[0] == 200
                                  and c[1][-1]["event"] == "done"
                                  for c in conc]
        status, _, body = http_call(port, "POST", "/v1/generate", {
            "tokens": prompts[0], "max_new_tokens": 16,
            "stream": False})
        out["nonstream"] = status == 200 and \
            json.loads(body)["tokens"] == want[0]
        out["health"] = http_call(port, "GET", "/v1/health")[0]
        st, _, stats = http_call(port, "GET", "/v1/stats")
        out["stats"] = {"status": st, **{k: json.loads(stats)[k] for k in (
            "router_replicas", "requests_finished", "router_retries")}}
        st, ctype, text = http_call(port, "GET", "/metrics")
        types, samples = prometheus_samples(text)
        out["metrics"] = dict(
            status=st, content_type=ctype, families=len(types),
            replica_labels=sorted({lb.get("replica", "")
                                   for _, lb, _ in samples}),
            ttft_buckets=sum(m == "tnn_serve_ttft_seconds_bucket"
                             for m, _, _ in samples),
            finished=sum(v for m, lb, v in samples
                         if m == "tnn_serve_requests_finished_total"
                         and lb.get("replica") in ("0", "1")))
        ids = []

        def take_id(ev):
            if ev["event"] == "start":
                ids.append(ev["id"])
                http_call(port, "POST", "/v1/cancel", {"id": ev["id"]})

        _, cev = sse_stream(port, {"tokens": prompts[1],
                                   "max_new_tokens": 400}, take_id)
        out["cancel"] = cev[-1]["event"]
        health_draining = []

        def on_token(ev):
            if ev["event"] == "token" and not health_draining:
                proc.send_signal(signal.SIGTERM)
                time.sleep(0.05)
                health_draining.append(
                    http_call(port, "GET", "/v1/health")[0])

        _, dev = sse_stream(port, {"tokens": prompts[2],
                                   "max_new_tokens": 400}, on_token)
        out["drain_stream"] = dev[-1]["event"]
        out["drain_stream_tokens"] = len(dev[-1].get("tokens", []))
        out["health_while_draining"] = health_draining
        out["returncode"] = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    m = out["metrics"]
    fleet_check("serving_fleet_http",
                all(out["one_at_a_time_equal"]) and all(
                    out["concurrent_done"]) and out["nonstream"]
                and out["health"] == 200 and m["status"] == 200
                and {"router", "0", "1"} <= set(m["replica_labels"])
                and m["ttft_buckets"] >= 14 and m["finished"] >= 9
                and out["cancel"] == "cancelled"
                and out["health_while_draining"] == [503]
                and out["drain_stream"] == "done"
                and out["drain_stream_tokens"] == 400
                and out["returncode"] == 0, out)


def fleet_cli_warm():
    """Step 9: ``cli.serve`` on stdin with ``--replicas 2 --roles
    prefill,decode --host-tier-bytes --fleet-prefix --compile-cache DIR``,
    twice with one new DIR: the first start builds the kernels into it,
    the second finds them (no nvcc) and gives the same tokens."""
    import os
    import tempfile

    import numpy as np

    rng = np.random.default_rng(91)
    lines = [{"id": 0, "tokens": rng.integers(0, 50257, 300).tolist(),
              "max_new_tokens": 16},
             {"id": 1, "tokens": rng.integers(0, 50257, 16).tolist(),
              "max_new_tokens": 16}]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):
            t0 = time.perf_counter()
            with open(os.path.join(tmp, "err"), "w+") as err:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "tnn_tpu_torch.cli.serve",
                     "--model", "gpt2_small", "--replicas", "2", "--roles",
                     "prefill,decode", "--disagg-prompt-threshold", "256",
                     "--host-tier-bytes", str(64 << 20), "--fleet-prefix",
                     "--compile-cache", os.path.join(tmp, "kernels")],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=err, text=True)
                events = []
                try:
                    proc.stdin.write("".join(json.dumps(x) + "\n"
                                             for x in lines))
                    proc.stdin.flush()
                    # stdin stays open until both are done: an EOF drains,
                    # and a draining fleet hands nothing off
                    for line in proc.stdout:
                        events.append(json.loads(line))
                        if sum(e["event"] == "done" for e in events) == 2:
                            break
                    proc.stdin.close()
                    proc.wait(timeout=300)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait(timeout=30)
                err.seek(0)
                stderr = err.read()
            cache = [x for x in stderr.splitlines()
                     if x.startswith("compile cache:")]
            runs.append(dict(
                returncode=proc.returncode,
                seconds=time.perf_counter() - t0, cache_lines=cache,
                done={e["id"]: e["tokens"] for e in events
                      if e["event"] == "done"},
                handoffs=next((json.loads(x.split(": ", 1)[1])[
                    "boundary_handoffs"] for x in stderr.splitlines()
                    if x.startswith("serve summary:")), None)))
            if proc.returncode != 0:
                log("serving_fleet_cli", runs=runs)
                raise AssertionError(stderr[-3000:])
    cold, warm = runs
    fleet_check("serving_fleet_cli",
                "(cold)" in cold["cache_lines"][0]
                and "nvcc ran 0 " not in cold["cache_lines"][-1]
                and "(warm," in warm["cache_lines"][0]
                and "nvcc ran 0 time(s)" in warm["cache_lines"][-1]
                and cold["done"] == warm["done"]
                and sorted(cold["done"]) == [0, 1]
                and cold["handoffs"] == 1, dict(runs=runs))


def phase_serving_fleet(results):
    """The replica fleet: the serving traffic on 2 replicas under
    ``Router.start()`` (against one engine, ABBA, and FP32 token-exact),
    a kill mid-stream, disaggregation with and without the KV handoff,
    the host tier, the fleet prefix directory, hedging, the autoscaler,
    HTTP and the CLI with a warm kernel cache."""
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo

    model = zoo.create("gpt2_small", device="cuda", seed=0)
    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    # first-use costs off the clock
    serve_traffic(model, seed=1, num_requests=2, new_tokens=4, overlap=True)
    reqs, fref = fleet_traffic_ab(model, fp32, results)
    fleet_replay_check(model, results)
    torch.cuda.empty_cache()
    fleet_kill(fp32, reqs, fref, results)
    torch.cuda.empty_cache()
    fleet_disagg(model, fp32, results)
    torch.cuda.empty_cache()
    fleet_tier(fp32)
    fleet_prefix_pull(fp32, results)
    torch.cuda.empty_cache()
    fleet_hedge(model, results)
    fleet_autoscale(model, results)
    del fp32
    torch.cuda.empty_cache()
    fleet_http(model)
    del model
    torch.cuda.empty_cache()
    fleet_cli_warm()


# -- phase 25 -----------------------------------------------------------------
#
# Tensor parallelism in one process: gpt2_small's heads, MLP columns and KV
# pool heads split over 2 and 4 shards, every shard on cuda:0 (the script
# needs one card). Every TP code path runs, K1 and K2 on per-shard
# pools included; nothing crosses cards, so NCCL and peer bandwidth are not
# measured. A paged dispatch launches K1 (K2 on the int8 pool) once a
# layer on each shard: tp x 12 a dispatch.

TP_DEGREES = (2, 4)


def tp_kw(tp):
    return {} if tp == 1 else dict(tp=tp, tp_devices=["cuda:0"] * tp)


def paged_dispatches(engine):
    steps = engine.stats()["program_steps"]
    return sum(steps.get(k, 0) for k in ("mixed", "pdecode", "spec"))


def tp_logits_check(model, tp, seed, tol, kv_dtype="f32"):
    """One ragged mixed step through the TP adapter over a tp-shard pool,
    then through the model over the same KV as one pool (the shards' heads
    side by side). Returns the max |logit difference| over live positions;
    fails past ``tol`` of the largest logit or unless K1 (K2) ran tp x 12
    times."""
    import numpy as np
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving.kv_pool import PagedKVPool
    from tnn_tpu_torch.serving.tp import TPContext

    dev = model.device
    bs, b, qw = 16, 8, 64
    starts = np.array([0, 0, 130, 700, 37, 512, 959, 3], np.int32)
    q_lens = np.array([64, 17, 64, 40, 1, 1, 1, 0], np.int32)
    ctx = TPContext(model, tp, devices=tp_kw(tp)["tp_devices"])
    pool = PagedKVPool(model.num_layers, model.num_kv_heads,
                       model.d_model // model.num_heads, 600, bs,
                       model.policy.compute_dtype, dev, kv_dtype=kv_dtype,
                       tp=tp, devices=ctx.devices)
    nb = pool.blocks_for(model.max_len)
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        blocks = pool.alloc(pool.blocks_for(starts[i] + q_lens[i]))
        tables[i, :len(blocks)] = blocks
    gen = torch.Generator(device=dev).manual_seed(seed)
    for pages in pool.pages_k + pool.pages_v:   # the rows' earlier KV
        if kv_dtype == "int8":
            data, scale = pa.quantize_kv_rows(torch.randn(
                pages.data.shape, generator=gen, device=dev))
            pages.data.copy_(data)
            pages.scale.copy_(scale)
        else:
            pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))

    def joined(side):   # the shards' heads as one (L, N, H_kv, ...) pool
        if kv_dtype == "int8":
            return pa.QuantPages(torch.cat([p.data for p in side], 2),
                                 torch.cat([p.scale for p in side], 2))
        return torch.cat(side, 2)

    one_k, one_v = joined(pool.pages_k), joined(pool.pages_v)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, model.vocab_size, (b, qw),
                                         dtype=np.int32)).to(dev)
    args = [torch.from_numpy(x).to(dev) for x in (tables, starts, q_lens)]
    counter = "int8_launches" if kv_dtype == "int8" else "launches"
    with torch.inference_mode():
        before = getattr(pa.paged_attention, counter)
        sharded = ctx.model.apply_paged(toks, pool.pages_k, pool.pages_v,
                                        *args)
        launched = getattr(pa.paged_attention, counter) - before
        single = model.apply_paged(toks, one_k, one_v, *args)
    want = tp * model.num_layers
    if launched != want:
        raise AssertionError(f"TP mixed step launched {counter} "
                             f"{launched} times, want {want}")
    live = torch.arange(qw, device=dev)[None, :] < args[2][:, None]
    diff = (sharded - single).abs()[live].max().item()
    scale = single[live].abs().max().item()
    ok = math.isfinite(diff) and diff <= tol * scale
    log("serving_tp_logits", tp=tp, policy=model.policy.compute,
        kv_dtype=kv_dtype, max_abs_err=diff, max_abs_logit=scale,
        tolerance=tol * scale, launches=launched, ok=ok)
    if not ok:
        raise AssertionError(f"TP mixed-step logits against tp=1: {diff} > "
                             f"{tol * scale}")
    return diff


def tp_traffic(model, tp, label, ref=None, tie=NEAR_TIE, **kw):
    """The serving traffic on the gap-recording engine (eager pdecode
    steps) at ``tp``, its launches counted over the run alone; with
    ``ref`` (engine, rids) its greedy streams against that run's. Returns
    (engine, rids, launches)."""
    import torch

    from tnn_tpu_torch.serving.scheduler import RequestState

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eng, rids = sp_traffic(model, seed=0, **tp_kw(tp), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    per = tp * model.num_layers * paged_dispatches(eng)
    quant = kw.get("kv_dtype") == "int8"
    want = {**{k: 0 for k in launches}, "k1": 0 if quant else per,
            "k2": per if quant else 0}
    bad = [r for r in rids if eng.result(r).state
           is not RequestState.FINISHED or len(eng.result(r).out_tokens)
           != 64]
    equal = flips = None
    if ref is not None:
        greedy_idx = range(0, len(rids), 2)
        equal, flips = streams_agree(ref[0], [ref[1][i] for i in greedy_idx],
                                     eng, [rids[i] for i in greedy_idx], tie)
    st = eng.stats()
    ok = (not bad and launches == want and per > 0
          and st["tp_degree"] == tp)
    log("serving_tp", run=label, tp=tp, requests=len(rids),
        finished=len(rids) - len(bad), program_steps=st["program_steps"],
        launches=launches, expected=want, greedy_equal=equal,
        greedy_near_tie_flips=flips, near_tie=tie, wall_s=wall,
        decode_tok_per_s=st["tok_per_s"],
        step_ms_mean=st["step_latency_ms_mean"],
        kv_bytes_per_token_per_shard=st["kv_bytes_per_token_per_shard"],
        pool_bytes_per_shard=pool_shard_bytes(eng.pool), ok=ok)
    if not ok:
        raise AssertionError(f"TP serving {label}: launches {launches} "
                             f"(want {want}), unfinished {bad}")
    eng.check_invariants()
    return eng, rids, launches


def check_streams(ref, ref_rids, eng, rids, tie):
    """``eng``'s streams against the gap engine ``ref``'s: (equal, near-tie
    flips); raises on a divergence where ``ref``'s gap is >= tie."""
    equal = flips = 0
    for ra, rb in zip(ref_rids, rids):
        a, b = ref.result(ra).out_tokens, eng.result(rb).out_tokens
        if a == b:
            equal += 1
            continue
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if i >= len(a) or ref.gaps[ra][i] >= tie:
            raise AssertionError(f"streams differ at token {i}: {a} vs {b}")
        flips += 1
    return equal, flips


def tp_spec(fp32):
    """8 cyclic prompts with ``spec="ngram"`` at tp=2 against spec off at
    tp=1 (FP32, the reference's gaps excusing only near-ties)."""
    from tnn_tpu_torch.serving.engine import InferenceEngine

    prompts = cyclic_prompts(fp32.vocab_size)
    gap_engine = gap_engine_class()
    cfg = dict(num_blocks=512, block_size=16, max_batch_size=8,
               chunk_size=64, device=fp32.device)
    ref = gap_engine(fp32, **cfg)
    ref_rids = [ref.submit(p, 64) for p in prompts]
    ref.run_until_complete()
    reset_launches()
    eng = InferenceEngine(fp32, spec="ngram", **cfg, **tp_kw(2))
    rids = [eng.submit(p, 64) for p in prompts]
    eng.run_until_complete()
    launches = read_launches()
    equal, flips = check_streams(ref, ref_rids, eng, rids, NEAR_TIE)
    st = eng.stats()
    want = 2 * fp32.num_layers * paged_dispatches(eng)
    ok = launches["k1"] == want and st["spec_acceptance_rate"] > 0
    log("serving_tp_spec", tp=2, equal=equal, near_tie_flips=flips,
        acceptance=st["spec_acceptance_rate"],
        mean_accepted_per_step=st["mean_accepted_per_step"],
        program_steps=st["program_steps"], k1=launches["k1"],
        expected_k1=want, decode_tok_per_s=st["tok_per_s"], ok=ok)
    if not ok:
        raise AssertionError(f"TP spec: K1 {launches['k1']} (want {want})")
    eng.check_invariants()


def tp_crash(fp32, ref):
    """The serving traffic under a started supervisor at tp=2 (FP32) with
    a crash mid-traffic against the same supervisor without one: every
    request finished, the greedy streams (the migrated ones among them)
    against the tp=1 gap run, the pool empty afterwards."""
    from tnn_tpu_torch.serving.faults import FaultPlan

    runs = {}
    for label, plan in (("clean", None),
                        ("crash", FaultPlan(step_crash_calls=(30,)))):
        engine, sup, rids, term, fields = supervised_run(
            fp32, plan=plan, **tp_kw(2))
        per = 2 * fp32.num_layers * paged_dispatches(engine)
        greedy_idx = list(range(0, len(rids), 2))
        ref_eng, ref_rids = ref
        equal = flips = 0
        for i in greedy_idx:
            a = ref_eng.result(ref_rids[i]).out_tokens
            b = list(term[rids[i]]["tokens"])
            if a == b:
                equal += 1
                continue
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            if j >= len(a) or ref_eng.gaps[ref_rids[i]][j] >= NEAR_TIE:
                raise AssertionError(f"TP {label}: stream {i} differs at "
                                     f"token {j}")
            flips += 1
        ok = (fields["terminal"]["done"] == len(rids)
              and fields["restarts"] == (plan is not None)
              and engine.pool.num_allocated == 0
              and fields["launches"]["k1"] == per)
        log("serving_tp_supervised", run=label, restarts=fields["restarts"],
            migrated=sum(engine.result(r).migrations > 0 for r in rids),
            greedy_equal=equal, near_tie_flips=flips,
            terminal=fields["terminal"], k1=fields["launches"]["k1"],
            expected_k1=per, pool_allocated=engine.pool.num_allocated,
            restart_ms=fields["restart_ms"], wall_s=fields["wall_s"], ok=ok)
        if not ok:
            raise AssertionError(f"TP supervised {label}: {fields}")
        runs[label] = engine
    return runs


def tp_handoff(fp32):
    """A tp=2 prefill replica's 512-token chain exported and adopted by a
    tp=1 decode replica: the adopted blocks read back byte-equal to the
    wire, and the receiver resumes on them."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    a = InferenceEngine(fp32, device=fp32.device, **FLEET_ENGINE,
                        **tp_kw(2))
    b = InferenceEngine(fp32, device=fp32.device, **FLEET_ENGINE)
    prompt = np.random.default_rng(31).integers(0, fp32.vocab_size, 512)
    a.submit(prompt, 1)
    a.run_until_complete()
    t0 = time.perf_counter()
    ex = a.export_prefix(prompt)
    export_s = time.perf_counter() - t0
    adopted = b.adopt_prefix(ex)
    equal = all(
        all(np.array_equal(x, y) for x, y in zip(
            b.pool.export_blocks([b.prefix_cache.block_of(k)])[0], lv))
        for k, lv, _ in ex)
    rid = b.submit(prompt, 8)
    b.run_until_complete()
    ok = (equal and adopted == len(ex) > 0
          and b.stats()["prefill_tokens_saved"] > 0
          and len(b.result(rid).out_tokens) == 8)
    log("serving_tp_handoff", blocks=len(ex), adopted=adopted,
        read_back_byte_equal=equal,
        wire_bytes_per_block=sum(x.nbytes for x in ex[0][1]),
        export_ms_per_block=export_s * 1e3 / max(len(ex), 1),
        receiver_prefill_tokens_saved=b.stats()["prefill_tokens_saved"],
        ok=ok)
    if not ok:
        raise AssertionError("TP handoff to tp=1 failed")


def tp_speed(model, steps=8):
    """Steady decode (8 rows, kv 500, graph replays) at tp 1, 2 and 4:
    step time in windows of ``steps`` in the order 1 2 4 4 2 1, then one
    profiled window each (device busy, idle share, kernels a step)."""
    import torch

    engines = {tp: steady_decode_engine(model, 4 * steps + 8 + 2 * steps,
                                        **tp_kw(tp))
               for tp in (1,) + TP_DEGREES}
    order = [1, 2, 4, 4, 2, 1]
    windows = {tp: [] for tp in engines}
    for tp in order:
        eng = engines[tp]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            drive_step(eng)
        torch.cuda.synchronize()
        windows[tp].append((time.perf_counter() - t0) * 1e3 / steps)
    rows = {}
    for tp, eng in engines.items():
        step_ms = sum(windows[tp]) / len(windows[tp])
        prof = profile_window(eng, steps)
        rows[tp] = dict(step_ms_windows=windows[tp], step_ms=step_ms,
                        decode_tok_per_s=8 * 1e3 / step_ms,
                        device_busy_ms=prof["device_busy_ms"],
                        idle_share=1.0 - prof["device_busy_ms"] / step_ms,
                        kernels_per_step=prof["kernels_per_step"],
                        aten_ops_per_step=prof["aten_ops_per_step"],
                        graph_replays=eng.stats()["graph_replays"],
                        top_kernels_ms=prof["top_kernels_ms"][:3])
    log("serving_tp_speed", order=order, steps_per_window=steps,
        rows={str(k): v for k, v in rows.items()})
    if any(rows[tp]["graph_replays"] == 0 for tp in rows):
        raise AssertionError("a TP engine ran no pdecode graph replay")
    return engines[2]


def tp_spans(model):
    """A traced tp=2 run: one ``serve.allreduce`` span a dispatch."""
    from tnn_tpu_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(model, num_blocks=512, block_size=16,
                          max_batch_size=8, chunk_size=64, trace=True,
                          device=model.device, **tp_kw(2))
    rng = __import__("numpy").random.default_rng(3)
    for n in (40, 300, 700):
        eng.submit(rng.integers(0, model.vocab_size, n), 16)
    eng.run_until_complete()
    spans = [e.name for e in eng.profiler.events
             if e.name.startswith("serve.allreduce")]
    dispatches = sum(eng.stats()["program_steps"].values())
    ok = (len(spans) == dispatches
          and set(spans) == {f"serve.allreduce tp=2 count="
                             f"{2 * model.num_layers}"})
    log("serving_tp_spans", spans=len(spans), dispatches=dispatches,
        names=sorted(set(spans)), ok=ok)
    if not ok:
        raise AssertionError(f"serve.allreduce spans {len(spans)} != "
                             f"dispatches {dispatches}")


def tp_cli():
    def read_line(proc):
        line = next((x for x in proc.stderr.splitlines()
                     if x.startswith("tensor parallel: tp=2")), "")
        ok = "6 head(s)/shard" in line and "B/token" in line
        log("serving_tp_cli", stderr_line=line, ok=ok)
        if not ok:
            raise AssertionError(
                f"TP CLI stderr line: {proc.stderr[-2000:]}")

    cli_check(("--tp", "2", "--tp-devices", "cuda:0,cuda:0"),
              then=read_line)


def phase_serving_tp(results):
    """TP in one process on full-width gpt2_small (module comment
    above)."""
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo

    fp32 = zoo.create("gpt2_small", device="cuda", seed=0, policy=dt.FP32)
    for tp in TP_DEGREES:
        tp_logits_check(fp32, tp, seed=4, tol=SP_LOGIT_TOL["fp32"])
    # (a) FP32 traffic at tp 1, 2, 4: greedy streams token-exact but at
    # near-ties (a top-2 gap below 1e-3 in either run)
    ref = sp_traffic(fp32, seed=0)
    for tp in TP_DEGREES:
        tp_traffic(fp32, tp, "fp32_model", ref=ref)
    tp_spec(fp32)
    tp_crash(fp32, ref)
    tp_handoff(fp32)
    del fp32, ref
    torch.cuda.empty_cache()
    # (b) bf16: the agreement and the divergences' gaps, reported
    model = zoo.create("gpt2_small", device="cuda", seed=0)
    worst = max(tp_logits_check(model, 2, seed=3, tol=SP_LOGIT_TOL["bf16"]),
                tp_logits_check(model, 2, seed=5, tol=SP_LOGIT_TOL["bf16"],
                                kv_dtype="int8"))
    tie = max(NEAR_TIE, 2 * worst)
    ref = sp_traffic(model, seed=0)
    _, _, k1 = tp_traffic(model, 2, "bf16_pool", ref=ref, tie=tie)
    ref8 = sp_traffic(model, seed=0, kv_dtype="int8")
    _, _, k2 = tp_traffic(model, 2, "int8_pool", ref=ref8, tie=tie,
                          kv_dtype="int8")
    results["launches"] += k1["k1"]
    results["int8_launches"]["k2"] += k2["k2"]
    del ref, ref8
    # (c) one staged pdecode step: the eager program and one graph replay
    eng = tp_speed(model)
    check = replay_vs_eager(eng)
    ok = check["logits_equal"] and check["bundle_equal"] \
        and check["generator_equal"]
    log("serving_tp_replay", tp=2, **check, ok=ok)
    if not ok:
        raise AssertionError(f"TP graph replay != eager step: {check}")
    del eng
    tp_spans(model)
    del model
    torch.cuda.empty_cache()
    tp_cli()


# -- phase 26 -----------------------------------------------------------------
#
# The LM family's gaps: moe_gpt2_small (8 experts, top-2, in every block;
# MoE has no TPU kernel, its dispatch, experts and combine are plain torch)
# served on the paged and standard paths and trained, and gpt2_small with
# an untied head under quant_weights, whose head takes K3 above 256 rows.

MOE_TRAIN = dict(batch=4, seq=1024, steps=3)


def moe_traffic_runs(model, label):
    """The serving traffic on the paged and the standard path, launches
    counted over each run: K1 = 12 x paged dispatches on the paged path,
    none on the standard one."""
    import torch

    from tnn_tpu_torch.serving.scheduler import RequestState

    out = {}
    for path in ("paged", "standard"):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        eng, rids = serve_traffic(model, seed=0, decode_path=path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = model.num_layers * paged_dispatches(eng)
        st = eng.stats()
        bad = [r for r in rids if eng.result(r).state
               is not RequestState.FINISHED]
        ok = not bad and launches["k1"] == want \
            and (want > 0) == (path == "paged")
        log("serving_moe", run=label, path=path, launches=launches,
            expected_k1=want, program_steps=st["program_steps"],
            wall_s=wall, decode_tok_per_s=st["tok_per_s"],
            step_ms_mean=st["step_latency_ms_mean"],
            ttft_ms_p50=st["ttft_ms_p50"], ok=ok)
        if not ok:
            raise AssertionError(f"MoE serving {path}: {launches}, {bad}")
        eng.check_invariants()
        out[path] = (eng, rids, launches)
    return out


def moe_overlap_exact(fp32):
    """FP32: the overlapped graph path against synchronous eager steps,
    every request (sampled ones too) token for token."""
    eng_a, rids_a = serve_traffic(fp32, seed=0, overlap=True)
    eng_b, rids_b = serve_traffic(fp32, seed=0, eager_steps=True)
    equal = sum(eng_a.result(a).out_tokens == eng_b.result(b).out_tokens
                for a, b in zip(rids_a, rids_b))
    st = eng_a.stats()
    ok = equal == len(rids_a) and st["graph_replays"] > 0
    log("serving_moe_overlap", equal=equal, requests=len(rids_a),
        graph_replays=st["graph_replays"],
        overlap_adopted=st["overlap_adopted"], ok=ok)
    if not ok:
        raise AssertionError(f"MoE overlapped graphs != eager: {equal}")


def moe_train(model):
    """Three ``make_train_step`` steps at B=4, S=1024: the loss finite,
    the aux loss positive, step time and peak memory."""
    import torch

    from tnn_tpu_torch.nn import optimizers
    from tnn_tpu_torch.train.step import create_train_state, make_train_step

    cfg = MOE_TRAIN
    gen = torch.Generator(device=model.device).manual_seed(0)
    opt = optimizers.AdamW(lr=1e-4)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, times = [], []
    for _ in range(cfg["steps"]):
        x = torch.randint(0, model.vocab_size, (cfg["batch"], cfg["seq"]),
                          generator=gen, device=model.device)
        t0 = time.perf_counter()
        state, m = step(state, x, torch.roll(x, -1, 1))
        rows.append((float(m["loss"]), float(m["aux_loss"])))
        times.append((time.perf_counter() - t0) * 1e3)
    ok = all(math.isfinite(l) and a > 0 for l, a in rows)
    log("serving_moe_train", batch=cfg["batch"], seq=cfg["seq"],
        losses=[r[0] for r in rows], aux_losses=[r[1] for r in rows],
        step_ms=times,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, ok=ok)
    if not ok:
        raise AssertionError(f"MoE training: {rows}")


def untied_head_check(model):
    """The untied int8 head on one 512-row hidden state: K3 against its
    plain version."""
    import torch

    x = torch.randn(512, model.d_model, device=model.device).to(
        model.policy.compute_dtype)
    iw = model.head.kernel
    entry = k3_check("untied_head_512", x, iw,
                     dict(n=iw.n, k=iw.k, out_dtype=torch.float32))
    log("serving_untied_head_k3", **entry)
    return entry


def untied_run(model):
    """The serving traffic on untied gpt2_small with quant_weights: K3 =
    49 x wide mixed steps (the head's included), K1 = 12 x paged
    dispatches, the float model's closeness gate."""
    import torch

    from tnn_tpu_torch.nn.quant import quantize_for_decode

    torch.cuda.synchronize()
    reset_launches()
    (eng, rids), wide = count_wide_steps(
        lambda: serve_traffic(model, seed=0, quant_weights=True))
    torch.cuda.synchronize()
    launches = read_launches()
    want_k3 = (4 * model.num_layers + 1) * wide
    want_k1 = model.num_layers * paged_dispatches(eng)
    greedy_rids = rids[::2]
    exact, total, margin = closeness_gate(model, eng, greedy_rids)
    ok = (launches["k3"] == want_k3 and wide > 0
          and launches["k1"] == want_k1 and exact >= 0.75 * total
          and margin < 0.25)
    log("serving_untied_quant", launches=launches, expected_k3=want_k3,
        expected_k1=want_k1, wide_steps=wide,
        head_int8=type(eng.model.head.kernel).__name__,
        closeness_exact=exact, closeness_total=total,
        closeness_margin_max=margin,
        decode_tok_per_s=eng.stats()["tok_per_s"], ok=ok)
    if not ok:
        raise AssertionError(f"untied quant serving: {launches}, K3 want "
                             f"{want_k3}, closeness {exact}/{total}")
    untied_head_check(quantize_for_decode(model))
    return launches


def phase_serving_moe(results):
    """MoE blocks and the untied head (module comment above)."""
    import os
    import tempfile

    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo

    t0 = time.perf_counter()
    model = zoo.create("moe_gpt2_small", device="cuda", seed=0)
    log("model", name="moe_gpt2_small", policy=model.policy.compute,
        params=sum(p.numel() for p in model.parameters()),
        bf16_weight_gb=sum(p.numel() for p in model.parameters()) * 2 / 1e9,
        init_s=round(time.perf_counter() - t0, 3))
    with tempfile.TemporaryDirectory() as tmp:
        model = model_file_round_trip(model, os.path.join(tmp, "moe.tnn"),
                                      label="serving_moe_file")
    serve_traffic(model, seed=1, num_requests=2, new_tokens=4)   # warm-up
    runs = moe_traffic_runs(model, "bf16")
    results["launches"] += runs["paged"][2]["k1"]
    del runs
    mixed_logits_check(model, seed=3, tol=3e-2, gate=False)
    moe_train(model)
    del model
    torch.cuda.empty_cache()
    fp32 = zoo.create("moe_gpt2_small", device="cuda", seed=0,
                      policy=dt.FP32)
    mixed_logits_check(fp32, seed=4, tol=1e-4)
    moe_overlap_exact(fp32)
    del fp32
    torch.cuda.empty_cache()
    untied = zoo.create("gpt2_small", device="cuda", seed=0,
                        tie_embeddings=False)
    launches = untied_run(untied)
    results["launches"] += launches["k1"]
    results["int8_launches"]["k3"] += launches["k3"]
    del untied
    torch.cuda.empty_cache()


# -- phase 27 -----------------------------------------------------------------

IMAGE_BATCH = 128
IMAGE_RECORDS = (5120, 1024)        # synthetic CIFAR-100 train / test records
IMAGE_EPOCHS = 2
IMAGE_TIMED, IMAGE_PROFILED = range(10, 30), range(32, 34)   # of 80 steps
AUG_STEPS = 12                      # per run of (b); the last 8 timed
VIT_CLASSES, VIT_PER_CLASS = 200, 4  # (c): 800 training images, 6 steps
VIT_LAYERS = 6
RESNET50_BATCH, RESNET50_STEPS = 64, 3
# (c) one flash_vit step with K4 / K7 against the same step with their plain
# versions, from the same weights and batch: the loss within `loss`
# relative and the gradient (every parameter's, concatenated) within `grad`
# relative L2. FP32 differs in summation order only; bf16 also in where the
# probabilities and the output are rounded (2^-8 relative each), through 6
# layers.
VIT_STEP_TOLERANCE = {"float32": dict(loss=1e-5, grad=1e-4),
                      "bfloat16": dict(loss=5e-3, grad=5e-2)}


def train_logs_to_stderr(name="tnn.train"):
    """Send the training loop's progress lines (or logger ``name``'s) to
    stderr: stdout carries the JSON lines."""
    import logging

    from tnn_tpu_torch.utils.logging import get_logger

    for h in logging.getLogger(get_logger(name)._log.name).handlers:
        if isinstance(h, logging.StreamHandler) \
                and not isinstance(h, logging.FileHandler):
            h.setStream(sys.stderr)


def cifar100_files(path, classes=100, seed=0, records=None):
    """CIFAR-100 ``train.bin`` and ``test.bin`` (coarse byte, fine byte,
    3072 CHW pixel bytes a record; ``records`` train / test, by default
    ``IMAGE_RECORDS``) of learnable synthetic images: each class a fixed
    random pattern, each record 0.6 of its class's pattern plus 0.4 of
    noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    patterns = rng.integers(0, 256, (classes, 3072))
    for name, n in zip(("train.bin", "test.bin"), records or IMAGE_RECORDS):
        fine = rng.integers(0, classes, n)
        pixels = 0.6 * patterns[fine] + 0.4 * rng.integers(0, 256, (n, 3072))
        records = np.concatenate(
            [(fine // 5)[:, None], fine[:, None], pixels], axis=1)
        records.astype(np.uint8).tofile(path / name)


def image_folders(path, classes, per_class, size, seed):
    """``<path>/class{c}/images.npy`` of uint8 (per_class, H, W, 3)
    images, each class a pattern plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = path / f"class{c:03d}"
        d.mkdir(parents=True)
        pattern = rng.integers(0, 256, size + (3,))
        noise = rng.integers(0, 256, (per_class,) + size + (3,))
        np.save(d / "images.npy", (0.6 * pattern + 0.4 * noise)
                .astype(np.uint8))


def reset_flash_launches():
    from tnn_tpu_torch.ops import flash_attention as fa

    for f in (fa.flash_attention_fwd, fa.flash_attention_bwd,
              fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        f.launches = 0


def image_trainer_cli(tmp, card):
    """(a): ``cli.trainer`` on full-width cifar100_wrn16_8 over the
    synthetic CIFAR-100 files, then ``cli.inferencer`` on its best
    snapshot."""
    import contextlib
    import json as json_lib

    import numpy as np
    import torch

    from tnn_tpu_torch.cli import inferencer, trainer
    from tnn_tpu_torch.train import loop

    data = tmp / "cifar100"
    data.mkdir()
    cifar100_files(data)
    with open(Path(__file__).resolve().parent / "configs"
              / "digits_wrn16_8.json") as f:
        ref = json_lib.load(f)
    cfg_path = tmp / "wrn.json"
    cfg_path.write_text(json_lib.dumps({
        "optimizer": ref["optimizer"], "scheduler": ref["scheduler"],
        "progress_print_interval": 40}))
    steps = IMAGE_RECORDS[0] // IMAGE_BATCH
    rec = StepRecorder(timed=IMAGE_TIMED, profiled=IMAGE_PROFILED)
    real = loop.make_train_step
    loop.make_train_step = rec.wrap(real)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            state, history = trainer.main([
                "--config", str(cfg_path), "--model", "cifar100_wrn16_8",
                "--dataset", "cifar100", "--data-path", str(data),
                "--epochs", str(IMAGE_EPOCHS), "--batch-size",
                str(IMAGE_BATCH), "--snapshot-dir", str(tmp / "snaps")])
        wall = time.perf_counter() - t0
    finally:
        loop.make_train_step = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in rec.losses]
    epoch_loss = [float(np.mean(losses[i * steps:(i + 1) * steps]))
                  for i in range(IMAGE_EPOCHS)]
    val = [h["val_accuracy"] for h in history]
    step_ms = rec.step_ms()
    kernels = rec.device_ms()
    busy = sum(kernels.values())
    best = tmp / "snaps" / "best" / "state.tnn"
    ok = (len(losses) == steps * IMAGE_EPOCHS
          and all(math.isfinite(x) for x in losses)
          and all(b < a for a, b in zip(epoch_loss, epoch_loss[1:]))
          and best.exists() and state.step == steps * IMAGE_EPOCHS)
    log("training_image_trainer", card=card, model="cifar100_wrn16_8",
        batch=IMAGE_BATCH, records=list(IMAGE_RECORDS), epochs=IMAGE_EPOCHS,
        optimizer=ref["optimizer"], scheduler=ref["scheduler"],
        steps_timed=len(rec.timed), step_ms=step_ms,
        images_per_s=IMAGE_BATCH / step_ms * 1e3, peak_mem_gb=peak,
        device_busy_ms=busy, idle_share=1.0 - busy / step_ms,
        top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:8],
        epoch_mean_loss=epoch_loss,
        epoch_last_loss=[h["train_loss"] for h in history],
        val_accuracy=val, val_loss=[h["val_loss"] for h in history],
        snapshot=str(best.relative_to(tmp)), wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError(f"image trainer: {len(losses)} steps, epoch "
                             f"losses {epoch_loss}, snapshot {best.exists()}")
    torch.cuda.synchronize()
    with contextlib.redirect_stdout(sys.stderr):
        out = inferencer.main(["--model-file", str(best), "--dataset",
                               "cifar100", "--data-path", str(data),
                               "--batch-size", str(IMAGE_BATCH)])
    # the best snapshot scores the test split as the trainer's validation
    # did, up to a prediction that cuDNN's algorithms round the other way
    ok = (out["samples"] == IMAGE_RECORDS[1]
          and abs(out["accuracy"] - max(val)) <= 2 / IMAGE_RECORDS[1])
    log("training_image_inferencer", card=card, **out,
        trainer_best_val_accuracy=max(val), ok=ok)
    if not ok:
        raise AssertionError(f"inferencer on the best snapshot: {out}, "
                             f"trainer's best {max(val)}")
    del state


def image_augment_ab(tmp, card):
    """(b): ``train_model`` on cifar100_wrn16_8 with the CIFAR pipeline
    as ``augment`` against none, from the same weights, in the order none,
    pipeline, pipeline, none."""
    import torch

    from tnn_tpu_torch.data.augmentation import cifar_train_pipeline
    from tnn_tpu_torch.data.datasets import CIFAR100DataLoader
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.train import loop, train_model
    from tnn_tpu_torch.utils.config import TrainingConfig

    model = zoo.create("cifar100_wrn16_8", device="cuda", seed=0)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loader = CIFAR100DataLoader(str(tmp / "cifar100"), train=True)
    pipe = cifar_train_pipeline()
    real = loop.make_train_step
    runs = {"none": [], "cifar_pipeline": []}
    for i, label in enumerate(("none", "cifar_pipeline", "cifar_pipeline",
                               "none")):
        model.load_state_dict(start)
        rec = StepRecorder(timed=range(4, AUG_STEPS), profiled=range(0))
        cfg = TrainingConfig().update({
            "epochs": 1, "batch_size": IMAGE_BATCH, "max_steps": AUG_STEPS,
            "optimizer": {"type": "sgd", "lr": 0.05, "momentum": 0.9},
            "snapshot_dir": str(tmp / f"aug{i}"), "seed": i})
        loop.make_train_step = rec.wrap(real)
        try:
            train_model(model, cfg, loader, augment=pipe.apply
                        if label == "cifar_pipeline" else None)
        finally:
            loop.make_train_step = real
        if not all(math.isfinite(float(x)) for x in rec.losses):
            raise AssertionError(f"augment A/B {label}: loss not finite")
        runs[label].append(rec.step_ms())
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = torch.rand((IMAGE_BATCH, 32, 32, 3), generator=gen,
                       device="cuda").to(torch.bfloat16)
    device, events, _ = time_ms(lambda: pipe.apply(gen, batch), iters=20,
                                warmup=3)
    none_ms = sum(runs["none"]) / 2
    aug_ms = sum(runs["cifar_pipeline"]) / 2
    pipe_ms = events if device is None else device
    log("training_image_augment", card=card, model="cifar100_wrn16_8",
        batch=IMAGE_BATCH, order="none, pipeline, pipeline, none",
        step_ms=runs, none_step_ms=none_ms, pipeline_step_ms=aug_ms,
        step_difference_share=(aug_ms - none_ms) / aug_ms,
        pipeline_alone_ms=pipe_ms, pipeline_alone_events_ms=events,
        pipeline_share=pipe_ms / aug_ms, ops=pipe.get_config())
    del model, start


def vit_step_vs_plain(policy):
    """One flash_vit forward and backward with K4 / K7, then the same with
    the plain versions swapped into the autograd Function, from the same
    weights and batch."""
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.nn import losses
    from tnn_tpu_torch.ops import flash_attention as fa

    model = zoo.create("flash_vit", device="cuda", seed=0, policy=policy)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((IMAGE_BATCH, 64, 64, 3), generator=gen, device="cuda")
    y = torch.randint(0, VIT_CLASSES, (IMAGE_BATCH,), generator=gen,
                      device="cuda")
    ce = losses.get("softmax_cross_entropy")

    def grads():
        model.zero_grad(set_to_none=True)
        loss = ce(model(x.to(policy.io_dtype), train=True), y)
        loss.backward()
        return float(loss.detach()), torch.cat([p.grad.double().flatten()
                                       for p in model.parameters()])

    loss_k, g_k = grads()
    saved = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_reference
    fa.flash_attention_bwd = fa.flash_attention_backward_reference
    try:
        loss_p, g_p = grads()
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved
    tol = VIT_STEP_TOLERANCE[policy.compute]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = float((g_k - g_p).norm() / g_p.norm())
    ok = math.isfinite(loss_k) and rel <= tol["loss"] \
        and grad_rel <= tol["grad"]
    return dict(policy=policy.compute, loss_kernel=loss_k,
                loss_plain=loss_p, loss_rel_diff=rel, grad_rel_l2=grad_rel,
                tolerance=tol, ok=ok)


def image_flash_vit(tmp, card, results):
    """(c): flash_vit through ``train_model`` over image folders, its
    launches and profile, then one step with the kernels against the plain
    versions under bf16 and FP32."""
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.data.datasets import ImageFolderDataLoader
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.train import loop, train_model
    from tnn_tpu_torch.utils.config import TrainingConfig

    image_folders(tmp / "vit_train", VIT_CLASSES, VIT_PER_CLASS, (64, 64),
                  seed=1)
    image_folders(tmp / "vit_val", VIT_CLASSES, 1, (64, 64), seed=2)
    train = ImageFolderDataLoader(str(tmp / "vit_train"), (64, 64))
    val = ImageFolderDataLoader(str(tmp / "vit_val"), (64, 64))
    model = zoo.create("flash_vit", device="cuda", seed=0)
    cfg = TrainingConfig().update({
        "epochs": 1, "batch_size": IMAGE_BATCH,
        "optimizer": {"type": "adamw", "lr": 1e-3, "weight_decay": 0.05},
        "snapshot_dir": str(tmp / "vit_snaps")})
    steps = len(train) // IMAGE_BATCH
    evals = len(val) // IMAGE_BATCH
    rec = StepRecorder(timed=range(1, 4), profiled=range(4, 6))
    real = loop.make_train_step
    loop.make_train_step = rec.wrap(real)
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    try:
        _, history = train_model(model, cfg, train, val)
    finally:
        loop.make_train_step = real
    k4, k7 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    split = (fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = (VIT_LAYERS * (steps + evals), VIT_LAYERS * steps)
    labels = rec.kernel_labels()
    flash = [n for n in labels if n.startswith("flash_")]
    bodies = {"K4": any(n.split("<")[0] == "flash_fwd_wgmma_kernel"
                        for n in flash),
              "K7": any(n.split("<")[0] == "flash_bwd_wgmma_kernel"
                        for n in flash)}
    simt = [n for n in flash if n.split("<")[0] in (
        "flash_fwd_kernel", "flash_bwd_kernel", "flash_bwd_dq_kernel")]
    losses = [float(x) for x in rec.losses]
    kernels = rec.device_ms()
    step_ms = rec.step_ms()
    busy = sum(kernels.values())
    ok = ((k4, k7) == want and split == (0, 0) and all(bodies.values())
          and not simt and len(losses) == steps
          and all(math.isfinite(x) for x in losses)
          and math.isfinite(history[0]["val_loss"]))
    log("training_image_vit", card=card, model="flash_vit",
        input=[64, 64, 3], batch=IMAGE_BATCH, seq=65, heads=6, head_dim=64,
        steps=steps, eval_steps=evals, losses=losses,
        val_loss=history[0]["val_loss"], k4_launches=k4, k7_launches=k7,
        expected_launches=list(want), split_launches=list(split),
        step_ms=step_ms, images_per_s=IMAGE_BATCH / step_ms * 1e3,
        peak_mem_gb=peak, device_busy_ms=busy, idle_share=1 - busy / step_ms,
        flash_bodies=flash, tensor_core_bodies_ran=bodies,
        flash_kernels_ms={n: t for n, t in kernels.items() if "flash" in n},
        top_kernels_ms=sorted(kernels.items(), key=lambda kv: -kv[1])[:8],
        ok=ok)
    if not ok:
        raise AssertionError(f"flash_vit: launches {(k4, k7)} vs {want}, "
                             f"K5/K6 {split}, bodies {bodies}, SIMT {simt}")
    results["flash_launches"]["flash_attention_fwd"] += k4
    results["flash_launches"]["flash_attention_bwd"] += k7
    del model
    for policy in (dt.MIXED_BF16, dt.FP32):
        fields = vit_step_vs_plain(policy)
        log("training_image_vit_vs_plain", card=card, **fields)
        if not fields["ok"]:
            raise AssertionError(f"flash_vit step kernel vs plain: {fields}")
        torch.cuda.empty_cache()


def image_resnet50(card):
    """(d): resnet50_imagenet at 224 x 224 x 3, three train steps."""
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.nn.optimizers import SGD
    from tnn_tpu_torch.train import create_train_state, make_train_step

    model = zoo.create("resnet50_imagenet", device="cuda", seed=0)
    opt = SGD(lr=0.025, momentum=0.9, weight_decay=1e-4)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((RESNET50_BATCH, 224, 224, 3), generator=gen,
                   device="cuda").to(torch.bfloat16)
    y = torch.randint(0, 1000, (RESNET50_BATCH,), generator=gen,
                      device="cuda")
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(RESNET50_STEPS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state, m = step(state, x, y)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
        losses.append(float(m["loss"]))
    steady = sum(times[1:]) / len(times[1:])
    stem, pool = model.layers[0], model.layers[3]
    ok = all(math.isfinite(x) for x in losses)
    log("training_image_resnet50", card=card, model="resnet50_imagenet",
        batch=RESNET50_BATCH, input=[224, 224, 3], step_ms=times,
        steady_step_ms=steady, images_per_s=RESNET50_BATCH / steady * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        losses=losses, stem_pads=stem.pads(224, 224),
        stem_pool_pads=pool.pads(112, 112), ok=ok)
    if not ok:
        raise AssertionError(f"resnet50_imagenet: losses {losses}")
    del model, state, step


def phase_training_image(results):
    import contextlib
    import io
    import json as json_lib
    import tempfile

    import torch

    from tnn_tpu_torch.cli import hardware_info

    train_logs_to_stderr()
    card = results["card"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        image_trainer_cli(tmp, card)
        torch.cuda.empty_cache()
        image_augment_ab(tmp, card)
        torch.cuda.empty_cache()
        image_flash_vit(tmp, card, results)
        torch.cuda.empty_cache()
    image_resnet50(card)
    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hardware_info.main(["--json"])
    info = json_lib.loads(out.getvalue())
    ok = bool(info["devices"]) and all(d["sm_count"] > 0 and d["power_limit"]
                                       for d in info["devices"])
    log("hardware_info", card=card, **info, ok=ok)
    if not ok:
        raise AssertionError(f"hardware_info: {info['devices']}")


# -- phase 28 -----------------------------------------------------------------
#
# Parallel training on one card: every mesh position is ``cuda:0``, so the
# runs drive every code path of the layouts (replicas in lockstep, global
# BatchNorm statistics, the collectives, the pipeline schedules and their
# hops) and measure no interconnect. (A) the pipelined WRN-16-8 against
# single-device gradient accumulation and the README's ``--mesh`` command;
# (B) flash_gpt2_small under data parallelism and FSDP; (C) a builder LM
# through ``StagePipeline``; (D) a float-input flash stack through the
# compiled pipeline.
PAR_BATCH, PAR_MB, PAR_STEPS = 128, 4, 3
PAR_TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # relative loss gap
PAR_CLI_RECORDS = (1280, 256)       # 10 train steps an epoch at B=128
PAR_CLI_MESH = ["--mesh", "data=2,pipe=4", "--num-microbatches", "8",
                "--pipeline-virtual", "2"]
# of the 20 steps: epoch 2's steady steps timed, then two profiled
PAR_CLI_TIMED, PAR_CLI_PROFILED = range(12, 18), range(18, 20)
PAR_LM_STEPS, PAR_LM_MB = 5, 4      # (C): 4 microbatches of 2 x 1024
PAR_LM_TIMED = range(1, PAR_STEPS)  # (B): the steps after the first
# (A), FP32: the running statistics element-wise, |pipe - accum| <=
# atol + rtol * |accum|
PAR_BN_ATOL, PAR_BN_RTOL = 1e-5, 1e-5
PAR_D_CLASSES = 64                  # (D): the per-position head's width


def par_wrn_run(data_dir, policy, mesh, tmp):
    """cifar100_wrn16_8 (seed 0) through ``train_model`` for PAR_STEPS
    steps: ``{"pipe": 4}`` over PAR_MB microbatches, or single-device
    gradient accumulation over as many: (losses, running statistics)."""
    import torch

    from tnn_tpu_torch.data.datasets import CIFAR100DataLoader
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.train import train_model
    from tnn_tpu_torch.utils.config import TrainingConfig

    model = zoo.create("cifar100_wrn16_8", device="cuda", seed=0,
                       policy=policy)
    cfg = {"epochs": 1, "batch_size": PAR_BATCH, "max_steps": PAR_STEPS,
           "progress_print_interval": 1, "shuffle": False,
           "optimizer": {"type": "sgd", "lr": 0.05, "momentum": 0.9},
           "io_dtype": policy.io, "snapshot_dir": str(tmp), "seed": 0}
    if mesh:
        cfg.update(mesh_axes={"pipe": 4}, num_microbatches=PAR_MB)
    else:
        cfg.update(gradient_accumulation_steps=PAR_MB)
    losses = []
    train_model(model, TrainingConfig().update(cfg),
                CIFAR100DataLoader(str(data_dir), train=True),
                metric_hook=lambda step, m: losses.append(m["loss"]),
                devices=["cuda:0"] * 4 if mesh else None)
    stats = torch.cat([b.detach().flatten() for _, b in
                       sorted(model.jax_state_paths())])
    del model
    torch.cuda.empty_cache()
    return losses, stats


def par_trainer_cli(data_dir, tmp, mesh):
    """The README's pipelined WRN through ``cli.trainer`` (every position
    on cuda:0), or the same command without ``--mesh``: history, peak
    memory, wall seconds and the steps' recorder (CUDA events over epoch
    2's steady steps, a profiled window after them)."""
    import contextlib

    import torch

    from tnn_tpu_torch.cli import trainer
    from tnn_tpu_torch.parallel import pipeline
    from tnn_tpu_torch.train import loop

    cfg = tmp / "wrn_par.json"
    cfg.write_text(json.dumps({"optimizer": {"type": "sgd", "lr": 0.05,
                                             "momentum": 0.9},
                               "progress_print_interval": 5}))
    args = ["--config", str(cfg), "--model", "cifar100_wrn16_8",
            "--dataset", "cifar100", "--data-path", str(data_dir),
            "--epochs", "2", "--batch-size", str(PAR_BATCH),
            "--snapshot-dir", str(tmp / ("cli_mesh" if mesh
                                         else "cli_plain"))]
    if mesh:
        args += PAR_CLI_MESH + ["--mesh-devices", ",".join(["cuda:0"] * 8)]
    rec = StepRecorder(timed=PAR_CLI_TIMED, profiled=PAR_CLI_PROFILED)
    real_pipe, real_step = (pipeline.make_pipeline_train_step,
                            loop.make_train_step)

    def make_pipe(*a, **kw):
        pipe, step_fn, init_fn = real_pipe(*a, **kw)
        return pipe, rec.wrap(lambda: step_fn)(), init_fn

    pipeline.make_pipeline_train_step = make_pipe
    loop.make_train_step = rec.wrap(real_step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            state, history = trainer.main(args)
    finally:
        pipeline.make_pipeline_train_step = real_pipe
        loop.make_train_step = real_step
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    return history, peak, wall, rec


def par_image(tmp, card):
    """(A)."""
    from tnn_tpu_torch.core import dtypes as dt

    data = tmp / "cifar100"
    data.mkdir()
    cifar100_files(data)
    import torch

    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.deterministic
    for policy in (dt.FP32, dt.MIXED_BF16):
        fp32 = policy.compute == "float32"
        # FP32 convs in float32: cuDNN's TF32 default rounds every input
        # to 10 mantissa bits, which turns the runs' 1e-7 parameter
        # differences (gradient summation order) into 1e-4 ones; and
        # deterministic algorithms: two single-device runs with cuDNN's
        # default ones differ by 2.9e-5 in the running statistics, as
        # much as the pipeline from either
        cudnn.allow_tf32 = not fp32
        cudnn.deterministic = fp32
        try:
            pipe_l, pipe_s = par_wrn_run(data, policy, True, tmp / "a_pipe")
            acc_l, acc_s = par_wrn_run(data, policy, False, tmp / "a_acc")
            # the same single-device run again: the gap cuDNN's own
            # run-to-run differences leave, beside the pipeline's
            rerun_s = par_wrn_run(data, policy, False, tmp / "a_rerun")[1] \
                if fp32 else None
        finally:
            cudnn.allow_tf32, cudnn.deterministic = saved
        rel = [abs(a - b) / abs(b) for a, b in zip(pipe_l, acc_l)]
        gap = (pipe_s - acc_s).abs()
        # each element against atol + rtol * |accum|: > 1 fails
        ratio = gap / (PAR_BN_ATOL + PAR_BN_RTOL * acc_s.abs())
        worst = int(ratio.argmax())
        tol = PAR_TOL[policy.compute]
        ok = (len(pipe_l) == len(acc_l) == PAR_STEPS
              and all(math.isfinite(x) for x in pipe_l)
              and max(rel) <= tol
              and (not fp32 or float(ratio.max()) <= 1.0))
        log("training_parallel_pipe_vs_accum", card=card,
            model="cifar100_wrn16_8", policy=policy.compute,
            batch=PAR_BATCH, microbatches=PAR_MB, mesh={"pipe": 4},
            devices=["cuda:0"] * 4, pipe_losses=pipe_l, accum_losses=acc_l,
            loss_rel_gap=rel, loss_tolerance=tol,
            batchnorm_elements=int(acc_s.numel()),
            batchnorm_max_abs_gap=float(gap.max()),
            batchnorm_max_abs=float(acc_s.abs().max()),
            batchnorm_worst_ratio=float(ratio.max()),
            batchnorm_worst_element=[float(pipe_s[worst]),
                                     float(acc_s[worst])],
            batchnorm_over_limit=int((ratio > 1.0).sum()),
            batchnorm_atol=PAR_BN_ATOL if fp32 else None,
            batchnorm_rtol=PAR_BN_RTOL if fp32 else None,
            accum_rerun_max_abs_gap=None if rerun_s is None
            else float((rerun_s - acc_s).abs().max()),
            cudnn_tf32=not fp32, cudnn_deterministic=fp32, ok=ok)
        if not ok:
            raise AssertionError(
                f"pipe vs grad accum ({policy.compute}): losses {pipe_l} "
                f"vs {acc_l}, BatchNorm worst |gap| / (atol + rtol|b|) "
                f"{float(ratio.max())}")
    small = tmp / "cifar100_small"
    small.mkdir()
    cifar100_files(small, records=PAR_CLI_RECORDS)
    runs = {}
    for mesh in (True, False):
        hist, peak, wall, rec = par_trainer_cli(small, tmp, mesh)
        step_ms = rec.step_ms()
        kernels = rec.device_ms()
        busy = sum(kernels.values())
        runs["mesh" if mesh else "plain"] = dict(
            epoch_loss=[h["train_loss"] for h in hist],
            val_loss=[h["val_loss"] for h in hist],
            batches=[h["batches"] for h in hist],
            epoch_seconds=[h["epoch_seconds"] for h in hist],
            step_ms=step_ms, images_per_s=PAR_BATCH / step_ms * 1e3,
            peak_mem_gb=peak, device_busy_ms=busy,
            idle_share=1.0 - busy / step_ms,
            top_kernels_ms=sorted(kernels.items(),
                                  key=lambda kv: -kv[1])[:6],
            wall_s=wall)
    # the trainer's epoch loss is the epoch's last step's: each must fall
    m = runs["mesh"]
    ok = (all(math.isfinite(x) for x in m["epoch_loss"])
          and m["epoch_loss"][1] < m["epoch_loss"][0]
          and m["batches"] == [PAR_CLI_RECORDS[0] // PAR_BATCH] * 2)
    log("training_parallel_readme_cli", card=card, model="cifar100_wrn16_8",
        command=["python", "-m", "tnn_tpu_torch.cli.trainer"]
        + PAR_CLI_MESH, batch=PAR_BATCH, records=list(PAR_CLI_RECORDS),
        stages=8, runs=runs,
        step_time_ratio=runs["mesh"]["step_ms"] / runs["plain"]["step_ms"],
        note="8 positions on one card: code paths, not interconnect",
        ok=ok)
    if not ok:
        raise AssertionError(f"README --mesh command: {runs['mesh']}")


def par_lm_run(tmp, policy, axes, counters):
    """flash_gpt2_small (seed 0) through ``train_model`` for PAR_STEPS
    steps and one validation batch under ``axes``: (losses, K4, K7,
    replicas, wall seconds, step ms, peak GiB). The step time is CUDA
    events over steps PAR_LM_TIMED; the peak is the run's allocated
    peak, the model's weights included."""
    import torch

    from tnn_tpu_torch import parallel
    from tnn_tpu_torch.data.token_stream import OpenWebTextDataLoader
    from tnn_tpu_torch.train import loop, train_model
    from tnn_tpu_torch.utils.config import TrainingConfig

    seq, batch = TRAIN_ARGS["seq"], TRAIN_ARGS["batch"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _flash_gpt2_small(policy, PAR_LAYERS)
    cfg = TrainingConfig().update({
        "epochs": 1, "batch_size": batch, "max_steps": PAR_STEPS,
        "progress_print_interval": 1, "shuffle": False,
        "optimizer": {"type": "adamw", "lr": 3e-4},
        "io_dtype": policy.io, "snapshot_dir": str(tmp / "b"), "seed": 0,
        "mesh_axes": axes})
    replicas = 1
    for v in axes.values():
        replicas *= v
    for c in counters:
        c.launches = 0
    rec = StepRecorder(timed=PAR_LM_TIMED, profiled=range(0))
    real_dp, real_step = parallel.make_dp_train_step, loop.make_train_step

    def make_dp(*a, **kw):
        step, place_state, place_batch = real_dp(*a, **kw)
        run = rec.wrap(lambda: step)()
        run.eval_step = step.eval_step
        return run, place_state, place_batch

    parallel.make_dp_train_step = make_dp
    loop.make_train_step = rec.wrap(real_step)
    losses = []
    t0 = time.perf_counter()
    try:
        train_model(model, cfg,
                    OpenWebTextDataLoader(str(tmp / "train.bin"), seq),
                    OpenWebTextDataLoader(str(tmp / "val.bin"), seq),
                    metric_hook=lambda step, m: losses.append(m["loss"]),
                    devices=["cuda:0"] * replicas if axes else None)
    finally:
        parallel.make_dp_train_step = real_dp
        loop.make_train_step = real_step
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    k4, k7 = (c.launches for c in counters)
    del model
    torch.cuda.empty_cache()
    return losses, k4, k7, replicas, wall, rec.step_ms(), peak


def par_lm(tmp, card, results):
    """(B)."""
    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.ops import flash_attention as fa

    seq, batch = TRAIN_ARGS["seq"], TRAIN_ARGS["batch"]
    layers = PAR_LAYERS
    synthetic_corpus(tmp, n_train=200_000, n_val=seq + batch)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    for policy in (dt.FP32, dt.MIXED_BF16):
        ref, _, _, _, _, ref_ms, ref_peak = par_lm_run(tmp, policy, {},
                                                       counters)
        for axes in ({"data": 2}, {"data": 2, "fsdp": 2}):
            losses, k4, k7, r, wall, step_ms, peak = par_lm_run(
                tmp, policy, axes, counters)
            results["flash_launches"]["flash_attention_fwd"] += k4
            results["flash_launches"]["flash_attention_bwd"] += k7
            want = [layers * r * (PAR_STEPS + 1), layers * r * PAR_STEPS]
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
            tol = PAR_TOL[policy.compute]
            ok = ([k4, k7] == want and len(losses) == PAR_STEPS
                  and all(math.isfinite(x) for x in losses)
                  and max(rel) <= tol)
            log("training_parallel_dp", card=card,
                model=f"flash_gpt2_small, {PAR_LAYERS} layers",
                policy=policy.compute, batch=batch, seq=seq, mesh=axes,
                devices=["cuda:0"] * r, losses=losses, no_mesh_losses=ref,
                loss_rel_gap=rel, loss_tolerance=tol, launches=[k4, k7],
                expected_launches=want, wall_s=wall,
                timed_steps=list(PAR_LM_TIMED), step_ms=step_ms,
                no_mesh_step_ms=ref_ms, peak_mem_gb=peak,
                no_mesh_peak_mem_gb=ref_peak, ok=ok)
            if not ok:
                raise AssertionError(f"{axes} ({policy.compute}): losses "
                                     f"{losses} vs {ref}, launches "
                                     f"{[k4, k7]} vs {want}")


def par_builder_lm(card, results):
    """(C): the builder LM through ``StagePipeline`` on 4 stages."""
    import numpy as np
    import torch

    from tnn_tpu_torch.nn.builder import LayerBuilder
    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.parallel import StagePipeline, partition_model

    seq, mb = TRAIN_ARGS["seq"], 2
    layers, width = PAR_LAYERS, TRAIN_ARGS["d_model"]
    b = LayerBuilder((seq,)).embedding(50257, width).positional_embedding()
    for _ in range(layers):
        b = b.flash_gpt_block(TRAIN_ARGS["heads"])
    model = b.layernorm().dense(50257).build(name="builder_lm")
    stages = partition_model(model, 4, (mb, seq))
    cuts = [len(s.layers) for s in stages]
    sp = StagePipeline(stages, AdamW(lr=1e-3), "softmax_cross_entropy",
                       devices=["cuda:0"] * 4)
    sp.init((mb, seq), torch.int64, seed=0)
    rng = np.random.default_rng(7)
    stream = np.tile(rng.integers(0, 50257, 256), 64)
    starts = rng.integers(0, len(stream) - seq - 1, PAR_LM_MB * mb)
    x = torch.tensor(np.stack([stream[s:s + seq] for s in starts]),
                     device="cuda")
    y = torch.tensor(np.stack([stream[s + 1:s + seq + 1] for s in starts]),
                     device="cuda")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    losses, times = [], []
    for _ in range(PAR_LM_STEPS):
        t0 = time.perf_counter()
        losses.append(float(sp.train_batch(x, y, PAR_LM_MB)))
        times.append((time.perf_counter() - t0) * 1e3)
    k4, k7 = (c.launches for c in counters)
    want = [layers * PAR_LM_MB * PAR_LM_STEPS] * 2
    results["flash_launches"]["flash_attention_fwd"] += k4
    results["flash_launches"]["flash_attention_bwd"] += k7
    ok = ([k4, k7] == want and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0])
    log("training_parallel_stage_pipeline", card=card,
        model="LayerBuilder LM (embedding 50257 x 768, positional, 12 x "
        "flash_gpt_block(12), layernorm, dense 50257)", stages=4,
        layers_per_stage=cuts, microbatches=PAR_LM_MB, microbatch=[mb, seq],
        losses=losses, step_ms=times, launches=[k4, k7],
        expected_launches=want, ok=ok)
    if not ok:
        raise AssertionError(f"StagePipeline LM: losses {losses}, "
                             f"launches {[k4, k7]} vs {want}")
    del sp, stages, model
    torch.cuda.empty_cache()


def par_compiled_pipeline(card, results):
    """(D): one ``make_pipeline_train_step`` step over a float-input flash
    stack at {"pipe": 4}, against single-device gradient accumulation from
    the same weights."""
    import torch

    from tnn_tpu_torch.nn.builder import LayerBuilder
    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.parallel import (make_mesh, make_pipeline_train_step,
                                        partition_model)
    from tnn_tpu_torch.train import create_train_state, make_train_step

    seq, mb, width = TRAIN_ARGS["seq"], 2, TRAIN_ARGS["d_model"]
    layers = PAR_LAYERS
    b = LayerBuilder((seq, width)).dense(width)
    for _ in range(layers):
        b = b.flash_gpt_block(TRAIN_ARGS["heads"])
    model = b.dense(PAR_D_CLASSES).build(name="flash_stack")
    model.init((seq, width), device="cuda", seed=0)
    stages = partition_model(model, 4, (mb, seq, width))
    mesh = make_mesh(pipe=4, devices=["cuda:0"] * 4)
    pipe, step_fn, init_fn = make_pipeline_train_step(
        stages, AdamW(lr=3e-4), mesh, (mb, seq, width),
        num_microbatches=PAR_MB, input_dtype=torch.bfloat16)
    pipe.load_from(model)
    state = init_fn(None)
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = PAR_MB * mb
    x = torch.randn((n, seq, width), generator=gen,
                    device="cuda").to(torch.bfloat16)
    y = torch.randint(0, PAR_D_CLASSES, (n, seq), generator=gen,
                      device="cuda")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step_fn(state, x, y)
    loss = float(m["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    k4, k7 = (c.launches for c in counters)
    results["flash_launches"]["flash_attention_fwd"] += k4
    results["flash_launches"]["flash_attention_bwd"] += k7
    opt = AdamW(lr=3e-4)
    ref_state, ref = make_train_step(model, opt, grad_accum=PAR_MB)(
        create_train_state(model, opt), x, y)
    ref_loss = float(ref["loss"])
    rel = abs(loss - ref_loss) / abs(ref_loss)
    want = [layers * PAR_MB] * 2
    ok = ([k4, k7] == want and math.isfinite(loss)
          and rel <= PAR_TOL["bfloat16"])
    log("training_parallel_compiled", card=card,
        model=f"dense {width} + {layers} x flash_gpt_block(12) + dense "
        f"{PAR_D_CLASSES} per position", mesh={"pipe": 4},
        devices=["cuda:0"] * 4, microbatches=PAR_MB,
        microbatch=[mb, seq, width], stage_layers=[len(s.layers)
                                                   for s in stages],
        buffer_dtype=str(pipe.buf_dtype), loss=loss,
        grad_accum_loss=ref_loss, loss_rel_gap=rel,
        loss_tolerance=PAR_TOL["bfloat16"], step_ms=step_ms,
        launches=[k4, k7], expected_launches=want, ok=ok)
    if not ok:
        raise AssertionError(f"compiled pipeline: loss {loss} vs "
                             f"{ref_loss}, launches {[k4, k7]} vs {want}")
    del pipe, state, model, ref_state
    torch.cuda.empty_cache()


def phase_training_parallel(results):
    import tempfile

    train_logs_to_stderr()
    card = results["card"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        par_image(tmp, card)
        par_lm(tmp, card, results)
    par_builder_lm(card, results)
    par_compiled_pipeline(card, results)


# -- phase 29: tensor, sequence and expert parallelism, FSDP parameters -------

PAX_STEPS = 2                       # steps a run; the last one timed
PAX_TOL = PAR_TOL                   # relative loss gap; bf16's reported
PAX_SGD_LR = 1.0                    # the FP32 gates' optimizer
PAX_UPDATE_TOL = 1e-3               # a leaf's first update, FP32
PAX_LONG_SEQ = LONG_SEQ             # Ulysses in bf16 (K5 + K6 at this S)
PAX_FP32_SEQ = 4096                 # the FP32 gates of the Llama runs
PAX_RING_SEQ = 8192                 # the ring in bf16 (f32 logits a block)
PAX_MOE_BATCH = 4
PAX_CLI_ARGS = ["--model", "gpt2_tiny", "--dataset", "openwebtext",
                "--mesh", "data=2,seq=2", "--seq-parallel-method", "ulysses",
                "--mesh-devices", "cuda:0,cuda:0,cuda:0,cuda:0",
                "--epochs", "1", "--batch-size", "4", "--device", "cuda"]


def pax_fp32():
    """FP32 with TF32 off (matmuls and cuDNN), restored on exit."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
    return ctx()


def pax_run(model, start, axes, batches, method="ring", profile=False,
            sgd=False, plant=None):
    """PAX_STEPS steps of ``model`` (AdamW; with ``sgd`` SGD at
    PAX_SGD_LR) from the weights ``start`` under ``axes`` (every position
    on cuda:0; {} is the single-device step): losses, the four flash
    wrappers' launches, the last step's time (CUDA events), the peak
    allocated memory over the run, each position's bytes between steps,
    with ``sgd`` each leaf's first update (its gradient times -lr) and,
    with ``profile``, the last step's flash kernel names. ``plant(layout)``
    plants a fault in the placed state (the update gate's own check)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    from tnn_tpu_torch import parallel
    from tnn_tpu_torch.nn.attention import ring_context
    from tnn_tpu_torch.nn.optimizers import SGD, AdamW
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.train import create_train_state, make_train_step

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = start[n].clone()
    opt = SGD(lr=PAX_SGD_LR) if sgd else AdamW(lr=3e-4)
    state = create_train_state(model, opt, seed=0)
    ctx = contextlib.nullcontext()
    if axes:
        n = 1
        for v in axes.values():
            n *= v
        mesh = parallel.make_mesh(**axes, devices=["cuda:0"] * n)
        step, place_state, _ = parallel.make_dp_train_step(
            model, opt, mesh, fsdp=axes.get("fsdp", 1) > 1,
            tp=axes.get("model", 1) > 1, ep=axes.get("expert", 1) > 1,
            compute_accuracy=False)
        state = place_state(state)
        if plant is not None:
            plant(state.layout)
        if axes.get("seq", 1) > 1:
            batch_axes = tuple(a for a in ("data", "fsdp")
                               if axes.get(a, 1) > 1)
            ctx = ring_context(mesh, batch_axis=batch_axes or None,
                               method=method)
    else:
        step = make_train_step(model, opt, compute_accuracy=False)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, names = [], []
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    held = update = None
    with ctx:
        for i, (x, y) in enumerate(batches[:PAX_STEPS]):
            last = i == PAX_STEPS - 1
            if last and axes:
                held = state.layout.position_bytes(state.opt_state)
            p = prof_ctx(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) \
                if last and profile else contextlib.nullcontext()
            with p:
                if last:
                    t0.record()
                state, m = step(state, x, y)
                if last:
                    t1.record()
                losses.append(float(m["loss"]))
            if i == 0 and sgd:
                now = state.layout.full_params() if axes else \
                    {n: p.detach() for n, p in model.named_parameters()}
                update = {n: now[n].float() - start[n].float()
                          for n in start}
                del now
            if last and profile:
                names = sorted({kernel_label(e.name) for e in p.events()
                                if e.device_type
                                == torch.autograd.DeviceType.CUDA
                                and "flash" in e.name})
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    out = dict(losses=losses, launches=launches,
               step_ms=t0.elapsed_time(t1),
               peak_gb=torch.cuda.max_memory_allocated() / 2**30,
               flash_kernels=names, update=update)
    if held is not None:
        out["bytes_per_position"] = {
            "x".join(map(str, c)): v for c, v in held.items()}
    del state, step
    torch.cuda.empty_cache()
    return out


def pax_batches(vocab, batch, seq, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(PAX_STEPS):
        ids = rng.integers(0, vocab, (batch, seq + 1))
        out.append((torch.from_numpy(ids[:, :-1]).cuda(),
                    torch.from_numpy(ids[:, 1:]).cuda()))
    return out


def pax_update_gap(update, ref, start):
    """The worst leaf's gap between two runs' first updates from the
    weights ``start``: per leaf, the largest |u - u_ref| beyond the two
    runs' own f32 rounding of the new weights (2^-22 |start + u_ref|), over
    max |u_ref|; (gap, leaf)."""
    worst = (0.0, None)
    for n, r in ref.items():
        rounding = (start[n].float() + r).abs() * 2.0 ** -22
        diff = ((update[n] - r).abs() - rounding).clamp_min(0).max().item()
        scale = r.abs().max().item()
        gap = diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
        if gap >= worst[0]:
            worst = (gap, n)
    return worst


def pax_compare(card, results, what, model, runs, ref_key, policy, tol,
                gate, start, extra=None):
    """Log each run beside the reference run; with ``gate`` fail past the
    relative loss gap ``tol`` or, for SGD runs, past PAX_UPDATE_TOL on the
    worst leaf's first update. Adds the runs' launches to the kernels
    line."""
    ref = runs[ref_key]
    bad = []
    for key, run in runs.items():
        if key == ref_key:
            continue
        rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   ref["losses"])]
        upd, leaf = (pax_update_gap(run["update"], ref["update"], start)
                     if ref["update"] is not None else (None, None))
        want = (extra or {}).get(key)
        ok = (all(math.isfinite(x) for x in run["losses"])
              and (not gate or max(rel) <= tol)
              and (not gate or upd is None or upd <= PAX_UPDATE_TOL)
              and (want is None or run["launches"] == want))
        log("training_parallel_axes", card=card, case=what, model=model,
            policy=policy, layout=key, losses=run["losses"],
            ref_losses=ref["losses"], loss_rel_gap=rel,
            loss_tolerance=tol if gate else None,
            optimizer="sgd" if ref["update"] is not None else "adamw",
            update_rel_gap=upd, update_worst_leaf=leaf,
            update_tolerance=PAX_UPDATE_TOL if upd is not None else None,
            launches_k4_k7_k5_k6=run["launches"],
            expected_launches=want, step_ms=run["step_ms"],
            ref_step_ms=ref["step_ms"], peak_mem_gb=run["peak_gb"],
            ref_peak_mem_gb=ref["peak_gb"],
            flash_kernels=run["flash_kernels"],
            bytes_per_position=run.get("bytes_per_position"),
            note="every position on cuda:0: code paths, not interconnect",
            ok=ok)
        if not ok:
            bad.append((key, rel, upd, leaf, run["launches"], want))
        fl = results["flash_launches"]
        fl["flash_attention_fwd"] += run["launches"][0]
        fl["flash_attention_bwd"] += run["launches"][1]
        sl = results.setdefault("split_launches", {
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0})
        sl["flash_attention_bwd_dq"] += run["launches"][2]
        sl["flash_attention_bwd_dkv"] += run["launches"][3]
    if bad:
        raise AssertionError(f"{what} ({policy}): {bad}")


def pax_gpt2_tp(card, results):
    """flash_gpt2_small's widths at PAR_LAYERS layers, B=8, S=1024:
    "model" 2 and 4, data x model, and data x model x seq (ring) against
    no mesh."""
    from tnn_tpu_torch.core import dtypes as dt

    seq, batch = TRAIN_ARGS["seq"], TRAIN_ARGS["batch"]
    layers = PAR_LAYERS
    layouts = {"model2": {"model": 2}, "model4": {"model": 4},
               "data2_model2": {"data": 2, "model": 2},
               "data2_model2_seq2_ring": {"data": 2, "model": 2, "seq": 2}}
    for policy in (dt.FP32, dt.MIXED_BF16):
        model = _flash_gpt2_small(policy, PAR_LAYERS)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        batches = pax_batches(model.vocab_size, batch, seq)
        fp32 = policy.compute == "float32"
        ctx = pax_fp32() if fp32 else contextlib.nullcontext()
        with ctx:
            runs = {"none": pax_run(model, start, {}, batches, sgd=fp32)}
            for key, axes in layouts.items():
                runs[key] = pax_run(model, start, axes, batches, sgd=fp32)
            if fp32:
                pax_gate_check(card, model, start, batches, runs["none"])
        # K4 / K7: the layers x the "model" positions x the data streams
        # each forward / backward; the ring runs no kernel
        want = {}
        for key, axes in layouts.items():
            pos = 0 if axes.get("seq", 1) > 1 else \
                axes["model"] * axes.get("data", 1)
            want[key] = [layers * pos * PAX_STEPS] * 2 + [0, 0]
        pax_compare(card, results, "gpt2_tensor_parallel",
                    f"flash_gpt2_small, {PAR_LAYERS} layers", runs, "none",
                    policy.compute, PAX_TOL[policy.compute],
                    policy.compute == "float32", start, want)
        del model, start
    import torch

    torch.cuda.empty_cache()


def pax_plant_norm_fault(layout):
    """The planted fault: every LayerNorm scale's gradient doubled at
    every position that holds it, as if a replicated leaf's gradient were
    summed over the "model" positions instead of taken once."""
    for c in layout.coords:
        for n, t in layout.held[c].items():
            if ".ln" in n or n.startswith("ln_f"):
                if n.endswith("scale"):
                    t.register_hook(lambda g: 2 * g)


def pax_gate_check(card, model, start, batches, ref):
    """The FP32 gates' own check: flash_gpt2_small at {"model": 2} with
    the planted fault must fail the update gate (its loss gaps logged
    beside)."""
    run = pax_run(model, start, {"model": 2}, batches, sgd=True,
                  plant=pax_plant_norm_fault)
    rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                               ref["losses"])]
    upd, leaf = pax_update_gap(run["update"], ref["update"], start)
    caught = upd > PAX_UPDATE_TOL
    log("training_parallel_axes_gate_check", card=card,
        model=f"flash_gpt2_small, {PAR_LAYERS} layers", policy="float32",
        layout="model2",
        fault="LayerNorm scale gradients doubled", loss_rel_gap=rel,
        loss_tolerance=PAX_TOL["float32"],
        loss_gate_caught=max(rel) > PAX_TOL["float32"],
        update_rel_gap=upd, update_worst_leaf=leaf,
        update_tolerance=PAX_UPDATE_TOL, update_gate_caught=caught,
        ok=caught)
    if not caught:
        raise AssertionError(f"the update gate passed a planted fault: "
                             f"{upd} at {leaf}")


def pax_llama_seq(card, results):
    """flash_llama_small's widths at PAR_LAYERS layers: Ulysses at seq 2
    and 4 (bf16 at S = 32,768, where K5 + K6 take the backward; FP32 gate
    at S = 4,096) and the ring at seq 2 and 4 (FP32 at S = 4,096, bf16 at
    S = 8,192)."""
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models.llama import Llama
    from tnn_tpu_torch.ops import flash_attention as fa

    for policy, seq, cases in (
            (dt.MIXED_BF16, PAX_LONG_SEQ, ("ulysses",)),
            (dt.FP32, PAX_FP32_SEQ, ("ulysses", "ring")),
            (dt.MIXED_BF16, PAX_RING_SEQ, ("ring",))):
        model = Llama(num_layers=PAR_LAYERS, d_model=TRAIN_ARGS["d_model"],
                      num_heads=TRAIN_ARGS["heads"], num_kv_heads=4,
                      backend="pallas", max_len=seq, device="cuda", seed=0,
                      policy=policy)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        batches = pax_batches(model.vocab_size, 1, seq)
        layers = model.num_layers
        long_bf16 = seq == PAX_LONG_SEQ
        ctx = pax_fp32() if policy.compute == "float32" else \
            contextlib.nullcontext()
        runs, want = {}, {}
        fp32 = policy.compute == "float32"
        with ctx:
            runs["none"] = pax_run(model, start, {}, batches,
                                   profile=long_bf16, sgd=fp32)
            for method in cases:
                for sp in (2, 4):
                    key = f"seq{sp}_{method}"
                    runs[key] = pax_run(model, start, {"seq": sp}, batches,
                                        method=method, profile=long_bf16,
                                        sgd=fp32)
                    if method == "ring":
                        want[key] = [0, 0, 0, 0]
                    else:
                        # one local attention a position a layer, over
                        # the position's heads and the whole sequence
                        n = layers * sp * PAX_STEPS
                        q = torch.empty(1, model.num_heads // sp, seq,
                                        model.d_model // model.num_heads,
                                        dtype=policy.compute_dtype,
                                        device="meta")
                        split = not fa.use_fused_bwd(q, q)
                        want[key] = [n, 0 if split else n,
                                     n if split else 0, n if split else 0]
        if long_bf16:
            for key, run in runs.items():
                if not key.startswith("seq"):
                    continue
                bodies = {b.split("<")[0] for b in run["flash_kernels"]}
                if not {"flash_bwd_dq_wgmma_kernel",
                        "flash_bwd_wgmma_kernel"} <= bodies:
                    raise AssertionError(
                        f"Ulysses {key} at S={seq}: K5 / K6 not in the "
                        f"profiled step: {run['flash_kernels']}")
        pax_compare(card, results, f"llama_seq_parallel_s{seq}",
                    f"flash_llama_small, {PAR_LAYERS} layers", runs, "none",
                    policy.compute,
                    PAX_TOL[policy.compute], policy.compute == "float32",
                    start, want)
        del model, start
        torch.cuda.empty_cache()


def pax_moe(card, results):
    """moe_gpt2_small at B=4, S=1024: data 2 and data 2 x expert 4 against
    no mesh (global routing: the same capacity and aux loss)."""
    import torch

    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.models import zoo

    seq = TRAIN_ARGS["seq"]
    for policy in (dt.FP32, dt.MIXED_BF16):
        model = zoo.create("moe_gpt2_small", device="cuda", seed=0,
                           policy=policy)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        batches = pax_batches(model.vocab_size, PAX_MOE_BATCH, seq)
        fp32 = policy.compute == "float32"
        ctx = pax_fp32() if fp32 else contextlib.nullcontext()
        with ctx:
            runs = {"none": pax_run(model, start, {}, batches, sgd=fp32)}
            for key, axes in (("data2", {"data": 2}),
                              ("data2_expert4", {"data": 2, "expert": 4})):
                runs[key] = pax_run(model, start, axes, batches, sgd=fp32)
        pax_compare(card, results, "moe_data_expert", "moe_gpt2_small",
                    runs, "none", policy.compute, PAX_TOL[policy.compute],
                    policy.compute == "float32", start)
        del model, start
        torch.cuda.empty_cache()


def pax_fsdp(card, results):
    """flash_gpt2_small FP32 at data 2 x fsdp 2 against data 4 (the
    replicated layout over the same positions, whose arithmetic the
    optimizer-state-only FSDP shared: bit for bit) and data 2 (memory).
    The backward takes K5 + K6 (``TNN_FLASH_FUSED_BWD=0``): K7 adds dQ
    with atomics, whose order changes its low bits run to run, while K5
    and K6 give the same bits on every run; data 4 runs twice to show
    that the path repeats itself."""
    import os

    from tnn_tpu_torch.core import dtypes as dt

    seq, batch = TRAIN_ARGS["seq"], TRAIN_ARGS["batch"]
    model = _flash_gpt2_small(dt.FP32, PAR_LAYERS)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = pax_batches(model.vocab_size, batch, seq)
    layouts = (("data4", {"data": 4}), ("data4_again", {"data": 4}),
               ("data2_fsdp2", {"data": 2, "fsdp": 2}),
               ("data2", {"data": 2}))
    saved = os.environ.get("TNN_FLASH_FUSED_BWD")
    os.environ["TNN_FLASH_FUSED_BWD"] = "0"
    try:
        with pax_fp32():
            runs = {key: pax_run(model, start, axes, batches)
                    for key, axes in layouts}
    finally:
        if saved is None:
            del os.environ["TNN_FLASH_FUSED_BWD"]
        else:
            os.environ["TNN_FLASH_FUSED_BWD"] = saved
    repeats = runs["data4_again"]["losses"] == runs["data4"]["losses"]
    bits = runs["data2_fsdp2"]["losses"] == runs["data4"]["losses"]
    layers = PAR_LAYERS
    want = {}
    for key, axes in layouts:
        n = layers * math.prod(axes.values()) * PAX_STEPS
        want[key] = [n, 0, n, n]
    launches_ok = all(r["launches"] == want[k] for k, r in runs.items())
    held = {k: max(v["params"] + v["moments"] for v in
                   r["bytes_per_position"].values()) / 2**30
            for k, r in runs.items()}
    ok = repeats and bits and launches_ok and \
        held["data2_fsdp2"] < held["data2"]
    log("training_parallel_axes_fsdp", card=card,
        model=f"flash_gpt2_small, {PAR_LAYERS} layers",
        policy="float32", batch=batch, seq=seq,
        losses={k: r["losses"] for k, r in runs.items()},
        fsdp_equals_data4_bit_for_bit=bits, data4_repeats_bit_for_bit=repeats,
        backward="K5 + K6 (TNN_FLASH_FUSED_BWD=0)",
        max_position_gb_between_steps=held,
        bytes_per_position={k: r["bytes_per_position"]
                            for k, r in runs.items()},
        peak_mem_gb={k: r["peak_gb"] for k, r in runs.items()},
        step_ms={k: r["step_ms"] for k, r in runs.items()},
        launches_k4_k7_k5_k6={k: r["launches"] for k, r in runs.items()},
        expected_launches=want,
        note="every position on cuda:0: code paths, not interconnect",
        ok=ok)
    sl = results.setdefault("split_launches", {
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0})
    for r in runs.values():
        results["flash_launches"]["flash_attention_fwd"] += r["launches"][0]
        results["flash_launches"]["flash_attention_bwd"] += r["launches"][1]
        sl["flash_attention_bwd_dq"] += r["launches"][2]
        sl["flash_attention_bwd_dkv"] += r["launches"][3]
    if not ok:
        raise AssertionError(f"FSDP: bit for bit {bits}, data 4 repeats "
                             f"{repeats}, launches {launches_ok}, held "
                             f"{held}")
    del model, start


def pax_cli(tmp, card, results):
    """``cli.trainer --mesh data=2,seq=2 --seq-parallel-method ulysses`` on
    gpt2_tiny over a synthetic token file: the flag reaches the run (the
    Ulysses body runs, and its local attention launches K4 on a model
    whose own backend is "xla")."""
    import torch

    from tnn_tpu_torch.cli import trainer
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.parallel import data_parallel

    # val.bin holds one batch of windows (one window a token past 1024)
    synthetic_corpus(tmp, n_train=200_000, n_val=1024 + 4)
    cfg = tmp / "pax_cli.json"
    cfg.write_text(json.dumps({"max_steps": 2, "progress_print_interval": 1,
                               "snapshot_dir": str(tmp / "pax_snaps")}))
    calls = [0]
    real = data_parallel.ulysses_attention_local

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    data_parallel.ulysses_attention_local = counted
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            state, history = trainer.main(
                PAX_CLI_ARGS + ["--config", str(cfg), "--data-path",
                                str(tmp / "train.bin")])
    finally:
        data_parallel.ulysses_attention_local = real
    wall = time.perf_counter() - t0
    k4, k7 = (c.launches for c in counters)
    results["flash_launches"]["flash_attention_fwd"] += k4
    results["flash_launches"]["flash_attention_bwd"] += k7
    ok = (state.step == 2 and calls[0] > 0 and k4 > 0 and k7 > 0
          and math.isfinite(history[0]["train_loss"]))
    log("training_parallel_axes_cli", card=card,
        command=["python", "-m", "tnn_tpu_torch.cli.trainer"]
        + PAX_CLI_ARGS, steps=state.step, ulysses_calls=calls[0],
        k4_launches=k4, k7_launches=k7, train_loss=history[0]["train_loss"],
        wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError(f"cli --seq-parallel-method ulysses: steps "
                             f"{state.step}, Ulysses calls {calls[0]}, K4 "
                             f"{k4}, K7 {k7}")
    del state
    torch.cuda.empty_cache()


def phase_training_parallel_axes(results):
    import tempfile

    train_logs_to_stderr()
    card = results["card"]
    pax_gpt2_tp(card, results)
    pax_llama_seq(card, results)
    pax_moe(card, results)
    pax_fsdp(card, results)
    with tempfile.TemporaryDirectory() as tmp:
        pax_cli(Path(tmp), card, results)


# -- phase 30 -----------------------------------------------------------------
#
# The native host runtime (``tnn_tpu_torch.native``): built from
# ``native/src`` into ``build/native``, then each entry point held byte for
# byte against the port's numpy path on the same inputs (the image decoders
# against PIL's decode and the numpy bilinear resize, within the stated
# limits), with both paths' host times.

NATIVE_ROWS = 50_000            # a CIFAR train set
NATIVE_BATCH = 128
NATIVE_MNIST_ROWS = 10_000      # MNIST's test CSV
NATIVE_BPE_BYTES = 1_000_000
NATIVE_BPE_TRAIN_BYTES = 40_000
NATIVE_BPE_VOCAB = 512
NATIVE_TOKENS = 4_000_000       # uint16 tokens in the token file
NATIVE_WINDOW = 1024
NATIVE_IMAGES = (48, 96)        # files of each format, their side
NATIVE_IMAGE_SIZE = (64, 64)
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)
# PIL / libjpeg against the native JPEG decoder: IDCT and chroma upsampling
# differ by a few counts between conforming decoders (tests/test_native.py)
JPEG_LIMIT = dict(mean=1.0, max=8)
RESIZE_LIMIT = 1                # the bilinear resize: float rounding


def host_ms(fn, repeats=5):
    """Median host-clock time of ``fn()`` over ``repeats`` calls, and the
    last result."""
    times, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


@contextlib.contextmanager
def numpy_path():
    """The port's numpy paths: ``native.available()`` is False inside."""
    from tnn_tpu_torch import native

    was = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = was


def native_case(card, name, native_fn, numpy_fn, equal, repeats=5, **fields):
    """Time both paths, hold their results equal; log one line."""
    nat_ms, got = host_ms(native_fn, repeats)
    with numpy_path():
        np_ms, ref = host_ms(numpy_fn, repeats)
    ok, detail = equal(got, ref)
    log("native", case=name, card=card, native_ms=nat_ms, numpy_ms=np_ms,
        speedup=np_ms / nat_ms if nat_ms else None, ok=ok, **detail,
        **fields)
    if not ok:
        raise AssertionError(f"native {name}: {detail}")


def same_bytes(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    ok = len(got) == len(ref) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and a.tobytes() == b.tobytes() for a, b in zip(got, ref))
    return ok, {"equal_bytes": ok}


def gather_normalize_numpy(src, idx, mean, std):
    """The fused normalize's arithmetic in numpy: x * a + b per channel,
    a = 1 / (255 std) and b = -mean / std in f32, as one fused
    multiply-add (one rounding: g++ contracts it under -march=native with
    FMA) and as a product and a sum (two roundings)."""
    import numpy as np

    a = np.float32(1.0) / (np.float32(255.0) * std)
    b = -mean / std
    x = src[idx]
    fused = (x.astype(np.float64) * a.astype(np.float64)
             + b.astype(np.float64)).astype(np.float32)
    return fused, x.astype(np.float32) * a + b


def same_bytes_as_either(got, ref):
    """``got`` equal byte for byte to one of the two roundings."""
    fused, two_step = ref
    for name, r in (("fused", fused), ("two_step", two_step)):
        if same_bytes(got, r)[0]:
            return True, {"equal_bytes": True, "rounding": name}
    return False, {"equal_bytes": False}


def write_png(path, img):
    """An 8-bit RGB PNG (filter 0 on every row) without PIL."""
    import struct
    import zlib

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + chunk(
            b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def native_images(tmp, card, rng):
    """A folder of PNG (written here) and JPEG (PIL, where it is
    installed) images of side ``NATIVE_IMAGES[1]``, decoded and resized to
    64 x 64 by the native runtime, against the source pixels (PNG is
    lossless) or PIL's decode (JPEG), each resized by the numpy bilinear
    resize; then the image-folder loader's batches native against its
    numpy / PIL path."""
    import numpy as np

    from tnn_tpu_torch import native
    from tnn_tpu_torch.data.datasets import (ImageFolderDataLoader,
                                             _resize_bilinear)

    try:
        from PIL import Image
    except ImportError:
        Image = None
    n, side = NATIVE_IMAGES
    y, x = np.mgrid[0:side, 0:side]
    srcs, pngs, jpgs = [], [], []
    for i in range(n):
        noise = rng.normal(0, 24, (side, side, 3))
        img = np.stack([x * 255 / side, y * 255 / side,
                        (x + y) * 127 / side + 40 * (i % 3)], -1) + noise
        img = np.clip(img, 0, 255).astype(np.uint8)
        srcs.append(img)
        d = tmp / "images" / f"class{i % 4}"
        d.mkdir(parents=True, exist_ok=True)
        pngs.append(str(d / f"{i:03d}.png"))
        write_png(pngs[-1], img)
        if Image is not None:
            jpgs.append(str(d / f"{i:03d}.jpg"))
            Image.fromarray(img).save(jpgs[-1], "JPEG", quality=90)
    size = NATIVE_IMAGE_SIZE
    t0 = time.perf_counter()
    out, ok = native.api.decode_image_batch(pngs, *size)
    png_ms = (time.perf_counter() - t0) * 1e3
    ref = _resize_bilinear(np.stack(srcs), size)
    png_err = int(np.abs(out.astype(int) - ref.astype(int)).max())
    fields = dict(png_files=n, png_native_ms=png_ms, png_max_err=png_err,
                  png_ok=bool(ok.all()), side=side, size=list(size))
    good = bool(ok.all()) and png_err <= RESIZE_LIMIT
    if jpgs:
        t0 = time.perf_counter()
        out, ok = native.api.decode_image_batch(jpgs, *size)
        fields["jpeg_native_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        full = np.stack([np.asarray(Image.open(p).convert("RGB"), np.uint8)
                         for p in jpgs])
        ref = _resize_bilinear(full, size)
        fields["jpeg_pil_numpy_ms"] = (time.perf_counter() - t0) * 1e3
        d = np.abs(out.astype(int) - ref.astype(int))
        fields.update(jpeg_files=len(jpgs), jpeg_ok=bool(ok.all()),
                      jpeg_mean_err=float(d.mean()),
                      jpeg_max_err=int(d.max()))
        good = good and bool(ok.all()) and d.mean() < JPEG_LIMIT["mean"] \
            and d.max() <= JPEG_LIMIT["max"] + RESIZE_LIMIT
        # the loader: native batches against its PIL path (another resize
        # filter: the difference is reported)
        loader = ImageFolderDataLoader(str(tmp / "images"), image_size=size)
        idx = np.arange(len(loader))
        nat_ms, (a, la) = host_ms(lambda: loader._get(idx), 3)
        with numpy_path():
            slow = ImageFolderDataLoader(str(tmp / "images"),
                                         image_size=size)
            pil_ms, (b, lb) = host_ms(lambda: slow._get(idx), 3)
        fields.update(loader_native_ms=nat_ms, loader_pil_ms=pil_ms,
                      loader_items=len(idx),
                      loader_max_err_vs_pil=float(np.abs(a - b).max()),
                      loader_native=loader._native_img,
                      loader_labels_equal=bool(np.array_equal(la, lb)))
        good = good and loader._native_img and np.array_equal(la, lb)
    else:
        fields["jpeg"] = "PIL is not installed: no JPEG writer"
    log("native", case="image_folder", card=card, ok=good, **fields)
    if not good:
        raise AssertionError(f"native image_folder: {fields}")


def phase_native(results):
    import tempfile

    import numpy as np

    from tnn_tpu_torch import native
    from tnn_tpu_torch.data import datasets, token_stream
    from tnn_tpu_torch.data.loader import ArrayDataLoader
    from tnn_tpu_torch.data.tokenizer import Tokenizer, train_bpe

    card = results["card"]
    if "library" not in NATIVE_BUILD or not native.available():
        raise AssertionError(f"native: the library did not build or load "
                             f"({NATIVE_BUILD})")
    log("native_build", card=card, **NATIVE_BUILD,
        sources=len(list(native.lib.SRC_DIR.glob("*.cpp"))))
    rng = np.random.default_rng(0)

    # batch assembly over a CIFAR-sized u8 set and its f32 copy
    src = rng.integers(0, 256, (NATIVE_ROWS, 32, 32, 3), dtype=np.uint8)
    idx = rng.integers(0, NATIVE_ROWS, NATIVE_BATCH)
    mean = np.asarray(CIFAR_MEAN, np.float32)
    std = np.asarray(CIFAR_STD, np.float32)
    shape = dict(rows=NATIVE_ROWS, batch=NATIVE_BATCH, sample=[32, 32, 3])
    native_case(card, "gather_rows_u8",
                lambda: native.api.gather_rows(src, idx),
                lambda: src[idx], same_bytes, repeats=20, **shape)
    native_case(card, "gather_normalize",
                lambda: native.api.gather_normalize(src, idx, mean, std),
                lambda: gather_normalize_numpy(src, idx, mean, std),
                same_bytes_as_either, repeats=20, **shape)
    data = src.astype(np.float32) / 255.0
    labels = rng.integers(0, 100, NATIVE_ROWS).astype(np.int32)
    fast = ArrayDataLoader(data, labels)
    with numpy_path():
        slow = ArrayDataLoader(data, labels)
    if not fast._native_gather or slow._native_gather:
        raise AssertionError("native: the array loader took the wrong path")
    native_case(card, "array_loader_f32", lambda: fast._get(idx),
                lambda: slow._get(idx), same_bytes, repeats=20, **shape)
    del data, fast, slow

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # CIFAR-10 (one 10,000-record batch file) and CIFAR-100 (train.bin)
        c10 = tmp / "data_batch_1.bin"
        np.concatenate([rng.integers(0, 10, (10_000, 1), dtype=np.uint8),
                        rng.integers(0, 256, (10_000, 3072),
                                     dtype=np.uint8)], 1).tofile(c10)
        native_case(card, "cifar10_parse",
                    lambda: datasets.load_cifar10_bin([str(c10)]),
                    lambda: datasets.load_cifar10_bin([str(c10)]),
                    same_bytes, repeats=2, records=10_000)
        c100 = tmp / "train.bin"
        np.concatenate([rng.integers(0, 20, (NATIVE_ROWS, 1), dtype=np.uint8),
                        rng.integers(0, 100, (NATIVE_ROWS, 1), dtype=np.uint8),
                        rng.integers(0, 256, (NATIVE_ROWS, 3072),
                                     dtype=np.uint8)], 1).tofile(c100)
        native_case(card, "cifar100_parse",
                    lambda: datasets.load_cifar100_bin(str(c100)),
                    lambda: datasets.load_cifar100_bin(str(c100)),
                    same_bytes, repeats=1, records=NATIVE_ROWS)
        # an MNIST CSV with its header line
        csv = tmp / "mnist_test.csv"
        rows = np.concatenate([rng.integers(0, 10, (NATIVE_MNIST_ROWS, 1)),
                               rng.integers(0, 256, (NATIVE_MNIST_ROWS,
                                                     784))], 1)
        with open(csv, "w") as f:
            f.write("label," + ",".join(f"p{i}" for i in range(784)) + "\n")
            np.savetxt(f, rows, fmt="%d", delimiter=",")
        native_case(card, "mnist_csv_parse",
                    lambda: datasets.load_mnist_csv(str(csv)),
                    lambda: datasets.load_mnist_csv(str(csv)),
                    same_bytes, repeats=1, records=NATIVE_MNIST_ROWS)

        # BPE: a vocab trained here on the stdlib's text, then ~1 MB encoded
        text = stdlib_text(NATIVE_BPE_BYTES + NATIVE_BPE_TRAIN_BYTES)
        t0 = time.perf_counter()
        train_bpe([text[:NATIVE_BPE_TRAIN_BYTES]],
                  vocab_size=NATIVE_BPE_VOCAB).save(str(tmp / "vocab.bin"))
        vocab_s = time.perf_counter() - t0
        body = text[NATIVE_BPE_TRAIN_BYTES:]
        tok = Tokenizer().load(str(tmp / "vocab.bin"))
        with numpy_path():
            plain = Tokenizer().load(str(tmp / "vocab.bin"))
        if tok._native is None or plain._native is not None:
            raise AssertionError("native: the tokenizer took the wrong path")
        native_case(card, "bpe_encode",
                    lambda: np.asarray(tok.encode(body), np.int32),
                    lambda: np.asarray(plain.encode(body), np.int32),
                    same_bytes, repeats=1, chars=len(body),
                    bytes=len(body.encode()), vocab=NATIVE_BPE_VOCAB,
                    vocab_train_s=vocab_s)

        # token windows: 1,024 tokens and their labels, a batch of 64
        tokens = tmp / "train.bin"
        rng.integers(0, 50257, NATIVE_TOKENS).astype(np.uint16).tofile(
            tokens)
        fast = token_stream.TokenStreamDataLoader(str(tokens), NATIVE_WINDOW)
        with numpy_path():
            slow = token_stream.TokenStreamDataLoader(str(tokens),
                                                      NATIVE_WINDOW)
        if fast._native_tokens is None or slow._native_tokens is not None:
            raise AssertionError("native: the token loader took the wrong "
                                 "path")
        starts = rng.integers(0, NATIVE_TOKENS - NATIVE_WINDOW, 64)
        native_case(card, "token_windows",
                    lambda: tuple(np.ascontiguousarray(a)
                                  for a in fast._get(starts)),
                    lambda: slow._get(starts), same_bytes, repeats=20,
                    tokens=NATIVE_TOKENS, window=NATIVE_WINDOW, batch=64)
        fast._native_tokens.close()

        native_images(tmp, card, rng)


def stdlib_text(nbytes):
    """The first ``nbytes`` of the Python stdlib's .py files, as text."""
    import sysconfig

    from tnn_tpu_torch.cli.prepare_corpus import iter_files

    parts, total = [], 0
    for f in iter_files([sysconfig.get_paths()["stdlib"]], "*.py", nbytes):
        with open(f, encoding="utf-8", errors="ignore") as fh:
            parts.append(fh.read())
        total += len(parts[-1])
        if total >= nbytes:
            break
    return "".join(parts)[:nbytes]


# -- phase 31 -----------------------------------------------------------------
#
# The control plane (``tnn_tpu_torch.distributed``, ``cli.dist_worker``): a
# coordinator in this process over the native transport drives two workers
# on the one card, rank 0 on a thread of this process (its K4 / K7 launches
# are this process's counters) and rank 1 a ``python -m
# tnn_tpu_torch.cli.dist_worker`` process. They train the zoo's full-width
# ``flash_vit`` (patch 8, 6 layers of H=6, D=64, 200 classes) on the worker's
# synthetic 32 x 32 x 3 images (its own input shape, not flash_vit's 64 x 64:
# S = 17), B=128, 2 epochs of 20 steps; a save mid-run restores through
# ``Checkpoint``; then rank 1 is killed and a new rank 1 rejoins.

DIST_CONFIG = dict(model_name="flash_vit", dataset_name="synthetic",
                   batch_size=128, epochs=2, progress_print_interval=5,
                   seed=0)
DIST_LAYERS = 6             # flash_vit's blocks: one K4 (and K7) each a step
DIST_SAVE_AFTER = 5         # rank 0's train steps before the save request
DIST_EVAL_BATCHES = 4       # the evaluation pass over each restored state


def dist_eval(model_name, state_dir, rank, fields, key):
    """Loss of ``state_dir``'s newest snapshot (the initial weights where
    None) on the first ``DIST_EVAL_BATCHES`` batches of ``rank``'s data;
    returns the K4 launches it made."""
    from tnn_tpu_torch.checkpoint import Checkpoint
    from tnn_tpu_torch.cli import dist_worker
    from tnn_tpu_torch.cli.trainer import create_model
    from tnn_tpu_torch.data.loader import ArrayDataLoader
    from tnn_tpu_torch.ops import flash_attention as fa
    from tnn_tpu_torch.train import create_train_state, evaluate, \
        make_eval_step
    from tnn_tpu_torch.utils.config import TrainingConfig

    cfg = TrainingConfig().update(dict(DIST_CONFIG, model_name=model_name))
    data = dist_worker.synthetic_loader(cfg, rank)
    n = DIST_EVAL_BATCHES * cfg.batch_size
    loader = ArrayDataLoader(data.data[:n], data.labels[:n])
    model = create_model(cfg, data.data_shape, "cuda")
    state = create_train_state(model, cfg.make_optimizer(), seed=cfg.seed)
    if state_dir is not None:
        state, meta = Checkpoint(str(state_dir)).restore(state)
        fields[f"{key}_step"] = int(meta["step"])
    before = fa.flash_attention_fwd.launches
    fields[f"{key}_loss"] = evaluate(make_eval_step(model, cfg.loss), state,
                                     loader, cfg.batch_size, cfg, "cuda")[
                                         "loss"]
    return fa.flash_attention_fwd.launches - before


def dist_run(tmp, fields, while_rejoining):
    """The coordinator's sequence; fills ``fields`` and returns rank 0's
    history, its (K4, K7) launches and ``while_rejoining()``'s result,
    called while the new rank 1 process starts."""
    import signal
    import threading

    from tnn_tpu_torch.cli import dist_worker
    from tnn_tpu_torch.distributed import Coordinator
    from tnn_tpu_torch.distributed.transport import NativeTransport
    from tnn_tpu_torch.ops import flash_attention as fa

    def rank1(name):
        out = open(tmp / f"{name}.log", "w")
        return subprocess.Popen(
            [sys.executable, "-m", "tnn_tpu_torch.cli.dist_worker",
             "--coordinator", addr, "--rank", "1"], stdout=out,
            stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent)

    coord = Coordinator(2)
    procs = []
    try:
        if not isinstance(coord._t, NativeTransport):
            raise AssertionError(f"distributed: the coordinator runs on "
                                 f"{type(coord._t).__name__}")
        addr = f"127.0.0.1:{coord.port()}"
        rank0 = {}

        def run_rank0():
            try:
                rank0["out"] = dist_worker.main(["--coordinator", addr,
                                                 "--rank", "0"])
            except BaseException as e:  # noqa: BLE001 — raised below
                rank0["error"] = e

        reset_flash_launches()
        t0 = time.perf_counter()
        thread = threading.Thread(target=run_rank0, daemon=True)
        thread.start()
        procs.append(rank1("rank1"))
        fields["ranks"] = coord.wait_for_workers(timeout=180)
        fields["join_s"] = time.perf_counter() - t0
        config = dict(DIST_CONFIG, ranks={
            str(r): {"snapshot_dir": str(tmp / f"snap{r}")} for r in (0, 1)})
        coord.deploy_config(config, timeout=60)
        coord.start_profiling()
        coord.barrier("start", timeout=600)
        t_start = time.perf_counter()
        deadline = t_start + 300
        while fa.flash_attention_bwd.launches < DIST_LAYERS * DIST_SAVE_AFTER:
            if time.perf_counter() > deadline or "error" in rank0:
                raise AssertionError(f"distributed: rank 0 made "
                                     f"{fa.flash_attention_bwd.launches} K7 "
                                     f"launches in 300 s: {rank0}")
            time.sleep(0.02)
        t_save = time.perf_counter()
        coord.save_all(str(tmp / "mid"), timeout=300)
        fields["save_all_s"] = time.perf_counter() - t_save
        coord.barrier("done", timeout=600)
        fields["train_s"] = time.perf_counter() - t_start
        launches = (fa.flash_attention_fwd.launches,
                    fa.flash_attention_bwd.launches)
        prof = coord.collect_profiles(timeout=60)
        fields["profile_sources"] = sorted({e.source for e in prof.events})
        fields["profile_events"] = len(prof.events)
        fields["mid_dirs"] = sorted(p.name for p in (tmp / "mid").iterdir())

        # rank 1 dies; a new rank 1 rejoins; every live worker shuts down
        procs[0].send_signal(signal.SIGKILL)
        fields["killed_rc"] = procs[0].wait(timeout=60)
        t_kill = time.perf_counter()
        coord.wait_failed(1, timeout=60)
        fields["failure_seen_s"] = time.perf_counter() - t_kill
        procs.append(rank1("rank1_rejoined"))
        beside = while_rejoining()
        coord.wait_alive(1, timeout=180)
        fields["rejoin_s"] = time.perf_counter() - t_kill
        coord.shutdown(timeout=60)
        thread.join(timeout=120)
        fields["rejoined_rc"] = procs[1].wait(timeout=120)
        fields["rank0_alive"] = thread.is_alive()
        if "error" in rank0:
            raise rank0["error"]
        fields["rank1_final"] = [line for line in (tmp / "rank1.log")
                                 .read_text().splitlines()
                                 if line.startswith("rank 1: trained")]
        return rank0["out"][1], launches, beside
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        coord.close()


def phase_distributed(results):
    import tempfile

    from tnn_tpu_torch.profiling import GlobalProfiler
    from tnn_tpu_torch.profiling import profiler as prof_mod

    card = results["card"]
    for name in ("tnn.train", "tnn.dist.coord", "tnn.dist.worker"):
        train_logs_to_stderr(name)
    fields = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            # the workers' own lines ("joined as rank 0/2") keep off stdout
            with contextlib.redirect_stdout(sys.stderr):
                history, (k4, k7), eval_k4 = dist_run(
                    tmp, fields, lambda: sum(dist_eval(
                        DIST_CONFIG["model_name"], d, r, fields, key)
                        for d, r, key in (
                            (None, 0, "init"),
                            (tmp / "mid" / "rank0", 0, "mid_rank0"),
                            (tmp / "mid" / "rank1", 1, "mid_rank1"),
                            (tmp / "snap0", 0, "final_rank0"))))
        finally:
            prof_mod.enable(False)
            GlobalProfiler.clear()
            GlobalProfiler.source = "main"
            for name in ("rank1", "rank1_rejoined"):
                path = tmp / f"{name}.log"
                if path.exists():
                    print(f"--- {name} ---\n" + path.read_text()[-4000:],
                          file=sys.stderr)
    steps = sum(h["batches"] for h in history)
    eval_steps = 4 * DIST_EVAL_BATCHES
    want = (DIST_LAYERS * steps, DIST_LAYERS * steps,
            DIST_LAYERS * eval_steps)
    fields.update(train_steps=steps, eval_steps=eval_steps,
                  epoch_losses=[h["train_loss"] for h in history],
                  k4_train=k4, k7_train=k7, k4_eval=eval_k4,
                  launches_expected=list(want),
                  step_ms=1e3 * fields["train_s"] / steps,
                  seconds=time.perf_counter() - t0)
    checks = {
        "native_transport": True,
        "ranks": fields["ranks"] == [0, 1],
        "mid_dirs": fields["mid_dirs"] == ["rank0", "rank1"],
        "mid_step": fields["mid_rank0_step"] > 0,
        "profiles": {"worker0", "worker1"} <= set(fields["profile_sources"]),
        "loss_falls": fields["final_rank0_loss"] < fields["init_loss"]
        and fields["mid_rank0_loss"] < fields["init_loss"],
        "launches": (k4, k7, eval_k4) == want,
        "killed": fields["killed_rc"] == -9,
        "shutdown": fields["rejoined_rc"] == 0 and not fields["rank0_alive"],
        "rank1_trained": len(fields["rank1_final"]) == 1,
    }
    ok = all(checks.values())
    log("distributed", card=card, model=DIST_CONFIG["model_name"],
        batch=DIST_CONFIG["batch_size"], attention_shape=[
            DIST_CONFIG["batch_size"], 6, 17, 64], checks=checks, ok=ok,
        **fields)
    if not ok:
        raise AssertionError(f"distributed: {checks}")
    results["flash_launches"]["flash_attention_fwd"] += k4 + eval_k4
    results["flash_launches"]["flash_attention_bwd"] += k7


# -- phase 34 -----------------------------------------------------------------
#
# The data plane across processes (module docstring, item 34). The ranks run
# ``dd_rank_main`` (``python3 chip_smoke.py --data-rank SPEC RANK``), which
# connects to each deploy's coordinator in turn through
# ``dist_worker.main``; the phase's own wrappers around the package's
# functions record what the worker does not print, and put the gate's
# fault in on rank 1.

DD_BATCH = 128
DD_STEPS = 10                 # the train file's batches: an epoch of (a)
DD_EPOCHS = 2
DD_WRN_STEPS = 5
DD_GATE_STEPS = 2
DD_FAULT = 2.0                # (d): rank 1's gradient buffer scale
DD_TIMED = 2                  # the steps of (a) an epoch before timing
DD_BN_TOL = dict(rtol=1e-5, atol=1e-6)


def dd_deploys(data):
    """(name, config, runner options) of the phase's deploys, in order."""
    base = dict(dataset_name="cifar100", dataset_path=str(data),
                batch_size=DD_BATCH, mesh_axes={"data": 2}, seed=0,
                progress_print_interval=10)
    vit = dict(base, model_name="flash_vit")
    gate = dict(vit, epochs=1, max_steps=DD_GATE_STEPS, io_dtype="float32",
                optimizer={"type": "sgd", "lr": 1.0})
    gate_opts = {"fp32": True, "split_bwd": True, "updates": True}
    return [
        ("main", dict(vit, epochs=DD_EPOCHS, optimizer={
            "type": "adamw", "lr": 1e-3, "weight_decay": 0.05}),
         {"val": True}),
        ("wrn", dict(base, model_name="cifar100_wrn16_8", epochs=2,
                     max_steps=DD_WRN_STEPS, io_dtype="float32",
                     optimizer={"type": "sgd", "lr": 0.1}),
         {"fp32": True, "buffers": True}),
        ("gate", gate, gate_opts),
        ("gate_fault", gate, dict(gate_opts, fault=DD_FAULT)),
        ("synthetic", dict(vit, dataset_name="synthetic", epochs=1,
                           max_steps=2), {"expect_error": True}),
        ("pipe_model", dict(vit, mesh_axes={"pipe": 2, "model": 2},
                            epochs=1, max_steps=2),
         {"expect_error": True}),
    ]


@contextlib.contextmanager
def dd_numerics(opts):
    """FP32 runs without TF32 and on cuDNN's deterministic algorithms;
    the split backward (K5 + K6) where asked."""
    import os

    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             os.environ.get("TNN_FLASH_FUSED_BWD"))
    if opts.get("fp32"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    if opts.get("split_bwd"):
        os.environ["TNN_FLASH_FUSED_BWD"] = "0"
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic \
            = saved[:2]
        if saved[2] is None:
            os.environ.pop("TNN_FLASH_FUSED_BWD", None)
        else:
            os.environ["TNN_FLASH_FUSED_BWD"] = saved[2]


@contextlib.contextmanager
def dd_recording(opts, rec):
    """The step wrapper (each step's loss and CUDA-event ms, the first
    step's update of every parameter), ``zoo.create`` under FP32 where
    asked, and ``train_model`` given the held-out file where asked; into
    ``rec``."""
    import torch

    from tnn_tpu_torch import train as train_pkg
    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.data import factory
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.parallel import data_parallel as dp
    from tnn_tpu_torch.parallel import process_group as pg

    real = (dp.DPTrainStep.__call__, zoo.create, train_pkg.train_model)
    rec.update(losses=[], step_ms=[])

    def call(step, state, data, labels):
        before = None
        if opts.get("updates") and not rec["losses"]:
            before = {n: p.detach().float().clone()
                      for n, p in step.model.named_parameters()}
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = real[0](step, state, data, labels)
        b.record()
        b.synchronize()
        rec["step_ms"].append(a.elapsed_time(b))
        rec["losses"].append(float(out[1]["loss"]))
        if before is not None:
            rec["start"] = before
            rec["update"] = {n: p.detach().float() - before[n]
                             for n, p in step.model.named_parameters()}
        return out

    def create(name, **kw):
        if opts.get("fp32"):
            kw["policy"] = dt.FP32
        rec["model"] = real[1](name, **kw)
        return rec["model"]

    def train_model(model, cfg, loader, *a, **kw):
        rec["backend"], rec["reason"] = pg.backend(), pg.backend_reason()
        if opts.get("val"):
            kw["val_loader"] = factory.create(cfg.dataset_name,
                                              cfg.dataset_path, train=False)
        state, history = real[2](model, cfg, loader, *a, **kw)
        rec["history"] = history
        return state, history

    dp.DPTrainStep.__call__, zoo.create, train_pkg.train_model = \
        call, create, train_model
    try:
        yield
    finally:
        dp.DPTrainStep.__call__, zoo.create, train_pkg.train_model = real


def dd_launches():
    from tnn_tpu_torch.ops import flash_attention as fa

    return [f.launches for f in (fa.flash_attention_fwd,
                                 fa.flash_attention_bwd,
                                 fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)]


def dd_rank_main(spec_path, rank):
    """One rank of phase 34: every deploy of the spec through
    ``dist_worker.main``, each one's record appended to the spec's
    output file as a JSON line."""
    import torch
    import torch.distributed as tdist

    from tnn_tpu_torch.cli import dist_worker
    from tnn_tpu_torch.parallel import process_group as pg

    spec = json.loads(Path(spec_path).read_text())
    out_path = Path(spec["out"]) / f"rank{rank}.jsonl"
    real_flat, real_check, real_reduce = pg.all_reduce_flat, \
        pg.assert_equal, tdist.all_reduce
    for d in spec["deploys"]:
        opts = d["opts"]
        rec = {"name": d["name"], "rank": rank, "allreduce_ms": [],
               "allreduce_bytes": 0, "check_ms": [],
               "collective_devices": {}}

        def flat(tensors, *a, **kw):
            if opts.get("fault") and rank == 1:
                tensors = [t * opts["fault"] for t in tensors]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = real_flat(tensors, *a, **kw)
            torch.cuda.synchronize()
            rec["allreduce_ms"].append(1e3 * (time.perf_counter() - t0))
            rec["allreduce_bytes"] = sum(t.numel() * t.element_size()
                                         for t in tensors)
            return got

        def check(value, what):
            t0 = time.perf_counter()
            try:
                return real_check(value, what)
            finally:
                rec["check_ms"].append((what, 1e3 * (time.perf_counter()
                                                     - t0)))

        def reduce(t, *a, **kw):
            devs = rec["collective_devices"]
            devs[str(t.device)] = devs.get(str(t.device), 0) + 1
            return real_reduce(t, *a, **kw)

        reset_flash_launches()
        torch.cuda.reset_peak_memory_stats()
        pg.all_reduce_flat, pg.assert_equal, tdist.all_reduce = \
            flat, check, reduce
        try:
            with dd_numerics(opts), dd_recording(opts, rec):
                dist_worker.main(["--coordinator", d["address"], "--rank",
                                  str(rank)])
        except Exception as e:  # noqa: BLE001 — a refusal's record
            if not opts.get("expect_error"):
                raise
            rec["error"] = f"{type(e).__name__}: {e}"
        finally:
            pg.all_reduce_flat, pg.assert_equal, tdist.all_reduce = \
                real_flat, real_check, real_reduce
        rec["launches"] = dd_launches()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        model = rec.pop("model", None)
        if model is not None and "error" not in rec:
            rec["param_digest"] = pg.digest(dict(model.named_parameters()))
            rec["buffer_digest"] = pg.digest(dict(model.named_buffers()))
            if opts.get("buffers") and rank == 0:
                torch.save({n: b.cpu() for n, b in model.named_buffers()},
                           Path(spec["out"]) / f"{d['name']}_buffers.pt")
        if "update" in rec:
            if rank == 0:
                torch.save({"update": {n: u.cpu() for n, u in
                                       rec["update"].items()},
                            "start": {n: t.cpu() for n, t in
                                      rec["start"].items()}},
                           Path(spec["out"]) / f"{d['name']}_update.pt")
            del rec["update"], rec["start"]
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        del model
        torch.cuda.empty_cache()
    return 0


def dd_in_process(name, config, opts):
    """The deploy on the in-process mesh of two positions on the card, in
    this process: its record (as a rank's) with the first update."""
    import torch

    from tnn_tpu_torch import train as train_pkg
    from tnn_tpu_torch.cli.trainer import create_model
    from tnn_tpu_torch.data import factory
    from tnn_tpu_torch.utils.config import TrainingConfig

    rec = {"name": name}
    cfg = TrainingConfig().update(config)
    reset_flash_launches()
    torch.cuda.reset_peak_memory_stats()
    with dd_numerics(opts), dd_recording(opts, rec):
        loader = factory.create(cfg.dataset_name, cfg.dataset_path,
                                train=True)
        model = create_model(cfg, loader.data_shape, "cuda")
        train_pkg.train_model(model, cfg, loader, devices=["cuda:0"] * 2)
    rec["launches"] = dd_launches()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    rec["buffers"] = {n: b.detach().cpu() for n, b in model.named_buffers()}
    for key in ("update", "start"):
        if key in rec:
            rec[key] = {n: t.cpu() for n, t in rec[key].items()}
    del rec["model"], model
    torch.cuda.empty_cache()
    return rec


def dd_free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dd_run_ranks(tmp, deploys, fields):
    """Both ranks through every deploy; returns each deploy's two records
    ({name: [rank 0's, rank 1's]}). A rank that dies fails the phase
    with its exit code and its log's tail."""
    from tnn_tpu_torch.distributed import Coordinator

    coords = [Coordinator(2) for _ in deploys]
    procs, logs = [], []
    try:
        spec = {"out": str(tmp), "deploys": [
            {"name": name, "opts": opts,
             "address": f"127.0.0.1:{c.port()}"}
            for (name, _, opts), c in zip(deploys, coords)]}
        (tmp / "spec.json").write_text(json.dumps(spec))
        for r in (0, 1):
            logs.append(tmp / f"data_rank{r}.log")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--data-rank", str(tmp / "spec.json"), str(r)],
                stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT,
                cwd=Path(__file__).resolve().parent))

        def alive():
            for r, p in enumerate(procs):
                if p.poll() is not None and p.returncode != 0:
                    raise AssertionError(
                        f"distributed_data: rank {r} exited "
                        f"{p.returncode}:\n{logs[r].read_text()[-3000:]}")

        t0 = time.perf_counter()
        for (name, config, opts), coord in zip(deploys, coords):
            alive()
            coord.wait_for_workers(timeout=300)
            if name == "main":
                fields["join_s"] = time.perf_counter() - t0
            config = dict(config, jax_coordinator=f"127.0.0.1:"
                          f"{dd_free_port()}", ranks={
                              str(r): {"snapshot_dir": str(
                                  tmp / f"{name}_snap{r}")} for r in (0, 1)})
            coord.deploy_config(config, timeout=120)
            coord.barrier("start", timeout=300)
            t_train = time.perf_counter()
            if opts.get("expect_error"):
                try:
                    coord.barrier("done", timeout=300)
                except RuntimeError as e:   # the ranks left: the refusal
                    fields[f"{name}_coordinator"] = str(e)
                else:
                    raise AssertionError(f"distributed_data: {name} passed "
                                         "the done barrier")
            else:
                coord.barrier("done", timeout=600)
                fields[f"{name}_wall_s"] = time.perf_counter() - t_train
                coord.shutdown(timeout=60)
            alive()
        for r, p in enumerate(procs):
            p.wait(timeout=300)
        alive()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for c in coords:
            c.close()
        for r, path in enumerate(logs):
            if path.exists():
                print(f"--- data rank {r} ---\n" + path.read_text()[-3000:],
                      file=sys.stderr)
    recs = {}
    for r in (0, 1):
        for line in (tmp / f"rank{r}.jsonl").read_text().splitlines():
            rec = json.loads(line)
            recs.setdefault(rec["name"], [None, None])[r] = rec
    return recs


def dd_mean(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def dd_median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def dd_timed(step_ms, steps_an_epoch):
    """The steps of each epoch after its first ``DD_TIMED``."""
    return [t for i, t in enumerate(step_ms)
            if i % steps_an_epoch >= DD_TIMED]


def dd_gate(rank_update, ref, start, rank_losses, ref_losses):
    """The FP32 gate: with one data position a rank the group adds the
    same two values as the in-process mesh, so the losses and every
    leaf's first update must be equal bit for bit; the gaps beside
    phase 29's bounds are reported."""
    rel = [abs(a - b) / abs(b) for a, b in zip(rank_losses, ref_losses)]
    upd, leaf = pax_update_gap(rank_update, ref["update"], start)
    import torch

    bit = len(rank_losses) == DD_GATE_STEPS and rank_losses == ref_losses \
        and all(torch.equal(rank_update[n], ref["update"][n])
                for n in ref["update"])
    return {"loss_rel_gap": rel, "update_rel_gap": upd, "worst_leaf": leaf,
            "within_phase29_bounds": max(rel) <= PAX_TOL["float32"]
            and upd <= PAX_UPDATE_TOL, "bit_equal": bit, "passes": bit}


def phase_distributed_data(results):
    import tempfile

    import torch

    card = results["card"]
    for name in ("tnn.train", "tnn.dist.coord", "tnn.dist.worker"):
        train_logs_to_stderr(name)
    fields = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "cifar100"
        data.mkdir()
        cifar100_files(data, records=(DD_BATCH * DD_STEPS, DD_BATCH))
        deploys = dd_deploys(data)
        with contextlib.redirect_stdout(sys.stderr):
            ranks = dd_run_ranks(tmp, deploys, fields)
            t_ref = time.perf_counter()
            refs = {name: dd_in_process(
                name, dict(config, snapshot_dir=str(tmp / f"{name}_ref")),
                opts) for name, config, opts in deploys
                    if name in ("main", "wrn", "gate")}
            fields["in_process_s"] = time.perf_counter() - t_ref
        gate_ref = torch.load(tmp / "gate_update.pt")
        ref_gate = {"update": refs["gate"]["update"]}
        start = refs["gate"]["start"]
        gate = dd_gate(gate_ref["update"], ref_gate, start,
                       ranks["gate"][0]["losses"], refs["gate"]["losses"])
        fault_upd = torch.load(tmp / "gate_fault_update.pt")["update"]
        fault = dd_gate(fault_upd, ref_gate, start,
                        ranks["gate_fault"][0]["losses"],
                        refs["gate"]["losses"])
        wrn_buffers = torch.load(tmp / "wrn_buffers.pt")
    main, wrn = ranks["main"], ranks["wrn"]
    ref_main, ref_wrn = refs["main"], refs["wrn"]
    layers = VIT_LAYERS
    train_steps = DD_STEPS * DD_EPOCHS
    eval_steps = DD_EPOCHS
    want = {"main": [layers * (train_steps + eval_steps),
                     layers * train_steps, 0, 0],
            "wrn": [0, 0, 0, 0],
            "gate": [layers * DD_GATE_STEPS, 0, layers * DD_GATE_STEPS,
                     layers * DD_GATE_STEPS],
            "synthetic": [0, 0, 0, 0], "pipe_model": [0, 0, 0, 0]}
    want["gate_fault"] = want["gate"]
    bn_gap = max(((a - wrn_buffers[n]).abs() / (DD_BN_TOL["atol"]
                  + DD_BN_TOL["rtol"] * wrn_buffers[n].abs())).max().item()
                 for n, a in ref_wrn["buffers"].items()
                 if a.is_floating_point())
    bn_bit = all(torch.equal(a, wrn_buffers[n])
                 for n, a in ref_wrn["buffers"].items())
    loss_gap = [abs(a - b) / abs(b) for a, b in zip(main[0]["losses"],
                                                    ref_main["losses"])]
    timed = dd_timed(main[0]["step_ms"], DD_STEPS)
    timed_ref = dd_timed(ref_main["step_ms"], DD_STEPS)
    per_step = {r: {"allreduce_ms": dd_median(rec["allreduce_ms"]),
                    "allreduce_calls": len(rec["allreduce_ms"]),
                    "allreduce_mb": rec["allreduce_bytes"] / 2**20,
                    "batch_check_ms": dd_median(
                        [t for w, t in rec["check_ms"]
                         if w == "the global batch"]),
                    "param_check_ms": [t for w, t in rec["check_ms"]
                                       if w == "the initial parameters"],
                    "checks": len(rec["check_ms"]),
                    "peak_gb": rec["peak_gb"]}
                for r, rec in enumerate(main)}
    refusal = {name: [rec.get("error") for rec in ranks[name]]
               for name in ("synthetic", "pipe_model")}
    checks = {
        "backend_gloo": all(rec.get("backend") == "gloo"
                            for name in ("main", "wrn", "gate")
                            for rec in ranks[name]),
        "cuda_buffers": all(any(k.startswith("cuda") for k in
                                rec["collective_devices"])
                            for rec in main),
        "losses_equal": all(len(ranks[name][0]["losses"]) > 0 and
                            ranks[name][0]["losses"] ==
                            ranks[name][1]["losses"]
                            for name in ("main", "wrn", "gate")),
        "main_steps": len(main[0]["losses"]) == train_steps
        and all(math.isfinite(x) for x in main[0]["losses"]),
        "params_equal": all(ranks[name][0]["param_digest"]
                            == ranks[name][1]["param_digest"]
                            for name in ("main", "wrn", "gate")),
        "val_equal": [h["val_loss"] for h in main[0]["history"]]
        == [h["val_loss"] for h in main[1]["history"]],
        "bn_equal_ranks": wrn[0]["buffer_digest"] == wrn[1]["buffer_digest"],
        "bn_vs_in_process": bn_gap <= 1.0,
        "gate_passes": gate["passes"],
        "fault_fails": not fault["passes"],
        "synthetic_refused": all(e and "the global batch differs across "
                                 "processes" in e
                                 for e in refusal["synthetic"]),
        "pipe_model_refused": all(
            e and "pipeline runs compose with 'data' only" in e
            for e in refusal["pipe_model"]),
        "launches": all(rec["launches"] == want[name]
                        for name, recs in ranks.items() for rec in recs),
    }
    ok = all(checks.values())
    fields.update(seconds=time.perf_counter() - t0)
    log("distributed_data", card=card, model="flash_vit",
        batch=DD_BATCH, attention_shape=[DD_BATCH // 2, 6, 17, 64],
        backend=main[0].get("backend"), backend_reason=main[0].get("reason"),
        collective_devices=[rec["collective_devices"] for rec in main],
        param_digests={name: [rec.get("param_digest") for rec in recs]
                       for name, recs in ranks.items()},
        losses=main[0]["losses"], in_process_losses=ref_main["losses"],
        bf16_loss_rel_gap_max=max(loss_gap), bf16_loss_rel_gap=loss_gap,
        val_loss=[h["val_loss"] for h in main[0]["history"]],
        val_accuracy=[h["val_accuracy"] for h in main[0]["history"]],
        step_ms=dd_mean(timed), in_process_step_ms=dd_mean(timed_ref),
        step_ms_rank1=dd_mean(dd_timed(main[1]["step_ms"], DD_STEPS)),
        timed_steps=len(timed), per_rank=per_step,
        in_process_peak_gb=ref_main["peak_gb"],
        launches={name: [rec["launches"] for rec in recs]
                  for name, recs in ranks.items()},
        launches_expected=want, wrn_losses=wrn[0]["losses"],
        wrn_in_process_losses=ref_wrn["losses"],
        wrn_bn_gap_over_bound=bn_gap, wrn_bn_bit_equal=bn_bit,
        bn_tolerance=DD_BN_TOL, gate=gate, gate_fault=fault,
        fault=f"rank 1's gradient buffer x {DD_FAULT} before the all-reduce",
        gate_losses=ranks["gate"][0]["losses"],
        gate_in_process_losses=refs["gate"]["losses"],
        update_tolerance=PAX_UPDATE_TOL, loss_tolerance=PAX_TOL["float32"],
        refusals=refusal, checks=checks, ok=ok, **fields)
    if not ok:
        raise AssertionError(f"distributed_data: {checks}")
    for rec in main + ranks["gate"] + ranks["gate_fault"]:
        k4, k7, dq, dkv = rec["launches"]
        results["flash_launches"]["flash_attention_fwd"] += k4
        results["flash_launches"]["flash_attention_bwd"] += k7
        split = results.setdefault("split_launches", {
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0})
        split["flash_attention_bwd_dq"] += dq
        split["flash_attention_bwd_dkv"] += dkv


# -- phase 35 -----------------------------------------------------------------
#
# fsdp, model and seq across processes (module docstring, item 35). The
# ranks (``python3 chip_smoke.py --axes-rank SPEC RANK``) join one gloo
# group and build their models while this process runs each layout's FP32
# gate on the in-process mesh and leaves its first update in the phase's
# directory; then the ranks run every layout in turn with the same seeds,
# checking themselves against those files, and last deploy
# ``cli.dist_worker`` once. The in-process bf16 runs come after the ranks,
# so no timed step shares the card.

DA_LAYOUTS = (("fsdp2", {"fsdp": 2}, None), ("model2", {"model": 2}, None),
              ("seq2_ring", {"seq": 2}, "ring"),
              ("seq2_ulysses", {"seq": 2}, "ulysses"))
DA_GATE_STEPS = 2             # (a): SGD at PAX_SGD_LR, FP32, K5 + K6
DA_BF16_STEPS = 2             # (b): AdamW; step 1's collectives, step 2 timed
DA_FAULT_LAYOUT = "model2"
DA_CLI_STEPS = 2
DA_CLI_BATCH = 128


def da_batches(vocab, n):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (TRAIN_ARGS["batch"],
                                      TRAIN_ARGS["seq"] + 1))
        out.append((torch.from_numpy(ids[:, :-1]).cuda(),
                    torch.from_numpy(ids[:, 1:]).cuda()))
    return out


def da_launches_expected(method, fp32, steps):
    """PERF.md section 2's counts for one rank (one position of the
    2-position mesh): PAR_LAYERS layers, one K4 a layer a step and one K7
    (bf16) or K5 and K6 (FP32); under "model" the call covers the rank's
    H/2 heads; the ring is plain torch and launches none."""
    n = 0 if method == "ring" else PAR_LAYERS * steps
    return [n, 0, n, n] if fp32 else [n, n, 0, 0]


@contextlib.contextmanager
def da_collectives(rec, names=None):
    """Each collective of ``parallel.process_group`` (``names``: its
    functions and the kinds they are counted as) timed (the card
    synchronized on both sides) into ``rec``: {kind: [ms, bytes, calls]}."""
    import torch

    from tnn_tpu_torch.parallel import process_group as pg

    names = names or {"_reduce_": "all_reduce", "all_gather": "all_gather",
                      "reduce_scatter": "reduce_scatter",
                      "_all_to_all": "all_to_all", "_exchange": "exchange"}
    real = {n: getattr(pg, n) for n in names}

    def wrap(n):
        def call(x, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[n](x, *a, **kw)
            torch.cuda.synchronize()
            row = rec.setdefault(names[n], [0.0, 0, 0])
            row[0] += 1e3 * (time.perf_counter() - t0)
            row[1] += x.numel() * x.element_size() if hasattr(x, "numel") \
                else sum(t.numel() * t.element_size() for t, _ in x)
            row[2] += 1
            return out
        return call

    for n in names:
        setattr(pg, n, wrap(n))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(pg, n, f)


def da_run(model, start, axes, method, batches, fp32, devices=None,
           fault=False, ref_update=None):
    """``make_dp_train_step`` of ``model`` from the weights ``start`` at
    ``axes`` (the process group's mesh, or ``devices``): FP32 SGD at
    PAX_SGD_LR, else bf16 AdamW; one step a batch. Returns the record:
    losses, launches, the last step's CUDA-event ms, peak memory, the
    bytes each position holds and, FP32,
    the first update (against ``ref_update``: the gap and whether every
    leaf is equal) or, bf16, the first step's collectives. FP32 also
    gives the final parameters' digest."""
    import torch

    from tnn_tpu_torch import parallel
    from tnn_tpu_torch.nn.attention import ring_context
    from tnn_tpu_torch.nn.optimizers import SGD, AdamW
    from tnn_tpu_torch.parallel import process_group as pg
    from tnn_tpu_torch.train import create_train_state

    marks = {"start": time.perf_counter()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = start[n].clone()
    opt = SGD(lr=PAX_SGD_LR) if fp32 else AdamW(lr=3e-4)
    state = create_train_state(model, opt, seed=0)
    mesh = parallel.make_mesh(**axes, devices=devices)
    step, place_state, _ = parallel.make_dp_train_step(
        model, opt, mesh, fsdp=axes.get("fsdp", 1) > 1,
        tp=axes.get("model", 1) > 1, compute_accuracy=False)
    state = place_state(state)
    torch.cuda.synchronize()
    marks["placed"] = time.perf_counter()
    ctx = ring_context(mesh, method=method) if method else \
        contextlib.nullcontext()
    reset_flash_launches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"losses": [], "collectives": {}}
    real_sum = pg.sum_forward
    if fault:       # g with the all-reduce's summing backward
        pg.sum_forward = lambda x, group=None: pg.all_reduce(x, group=group)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    try:
        with ctx:
            for i, (x, y) in enumerate(batches):
                last = i == len(batches) - 1
                watch = not fp32 and i == 0 and mesh.spans_processes
                if last:
                    rec["bytes_per_position"] = {
                        "x".join(map(str, c)): v for c, v in
                        state.layout.position_bytes(state.opt_state).items()}
                    t0.record()
                with (da_collectives(rec["collectives"]) if watch
                      else contextlib.nullcontext()):
                    state, m = step(state, x, y)
                if last:
                    t1.record()
                rec["losses"].append(float(m["loss"]))
                marks[f"step{i}"] = time.perf_counter()
                if i == 0 and fp32:
                    now = state.layout.full_params()
                    update = {n: now[n].float() - start[n].float()
                              for n in start}
                    del now
                    if ref_update is None:
                        rec["update"] = update
                    else:
                        gap, leaf = pax_update_gap(update, ref_update, start)
                        rec["update_gap"], rec["update_worst_leaf"] = \
                            gap, leaf
                        rec["update_equal"] = all(
                            torch.equal(update[n], ref_update[n])
                            for n in ref_update)
                    del update
                    torch.cuda.synchronize()
                    marks["update"] = time.perf_counter()
    finally:
        pg.sum_forward = real_sum
    torch.cuda.synchronize()
    rec["step_ms"] = t0.elapsed_time(t1)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    rec["launches"] = dd_launches()
    if fp32:
        rec["param_digest"] = pg.digest(state.layout.full_params())
    marks["end"] = time.perf_counter()
    names = list(marks)
    rec["seconds_by_part"] = {b: marks[b] - marks[a]
                              for a, b in zip(names, names[1:])}
    del state, step
    torch.cuda.empty_cache()
    return rec


def da_placed_bytes(model, start, axes, devices):
    """The bytes each position holds once an AdamW state is placed at
    ``axes`` (the moments exist from the start)."""
    import torch

    from tnn_tpu_torch import parallel
    from tnn_tpu_torch.nn.optimizers import AdamW
    from tnn_tpu_torch.train import create_train_state

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = start[n].clone()
    opt = AdamW(lr=3e-4)
    _, place_state, _ = parallel.make_dp_train_step(
        model, opt, parallel.make_mesh(**axes, devices=devices))
    state = place_state(create_train_state(model, opt, seed=0))
    out = {"x".join(map(str, c)): v for c, v in
           state.layout.position_bytes(state.opt_state).items()}
    state.layout.write_back(model)
    return out


def da_models(policies):
    from tnn_tpu_torch.core import dtypes as dt

    out = {}
    for key in policies:
        model = _flash_gpt2_small(dt.FP32 if key == "fp32" else
                                  dt.MIXED_BF16, PAR_LAYERS)
        out[key] = (model, {n: p.detach().clone()
                            for n, p in model.named_parameters()})
    return out


def da_rank_main(spec_path, rank):
    """One rank of phase 35: every layout in one process group, then the
    CLI deploy; one JSON line a run into the spec's output directory."""
    import os

    import torch

    from tnn_tpu_torch.cli import dist_worker
    from tnn_tpu_torch.parallel import process_group as pg

    spec = json.loads(Path(spec_path).read_text())
    tmp = Path(spec["out"])
    out_path = tmp / f"axes_rank{rank}.jsonl"

    def emit(rec):
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def step(name):     # what a hung rank was in (da_run_ranks)
        (tmp / f"axes_rank{rank}.step").write_text(name)

    t0 = time.perf_counter()
    pg.initialize(spec["address"], 2, rank, "cuda:0")
    joined = time.perf_counter() - t0
    models = da_models(("fp32", "bf16"))
    emit({"name": "group", "backend": pg.backend(),
          "reason": pg.backend_reason(), "join_s": joined,
          "models_s": time.perf_counter() - t0 - joined})
    vocab = models["fp32"][0].vocab_size
    gate_batches = da_batches(vocab, DA_GATE_STEPS)
    bf16_batches = da_batches(vocab, DA_BF16_STEPS)
    saved = os.environ.get("TNN_FLASH_FUSED_BWD")
    for key, axes, method in DA_LAYOUTS:
        step(f"{key}_waiting for the in-process update")
        ref_path = tmp / f"axes_ref_update_{key}.pt"
        t_wait = time.perf_counter()
        while not ref_path.exists():
            time.sleep(0.2)
        waited = time.perf_counter() - t_wait
        ref = torch.load(ref_path, map_location="cuda")
        loaded = time.perf_counter() - t_wait - waited
        os.environ["TNN_FLASH_FUSED_BWD"] = "0"
        try:
            with pax_fp32():
                runs = [("gate", {}), ("fault", {"fault": True})] \
                    if key == DA_FAULT_LAYOUT else [("gate", {})]
                for kind, kw in runs:
                    step(f"{key}_{kind}")
                    t_run = time.perf_counter()
                    rec = da_run(*models["fp32"], axes, method,
                                 gate_batches[:1] if kind == "fault"
                                 else gate_batches, True,
                                 ref_update=ref, **kw)
                    emit(dict(rec, name=f"{key}_{kind}", rank=rank,
                              seconds=time.perf_counter() - t_run,
                              ref_wait_s=waited, ref_load_s=loaded))
        finally:
            if saved is None:
                os.environ.pop("TNN_FLASH_FUSED_BWD", None)
            else:
                os.environ["TNN_FLASH_FUSED_BWD"] = saved
        del ref
        step(f"{key}_bf16")
        t_run = time.perf_counter()
        rec = da_run(*models["bf16"], axes, method, bf16_batches, False)
        emit(dict(rec, name=f"{key}_bf16", rank=rank,
                  seconds=time.perf_counter() - t_run))
    pg.shutdown()
    del models
    torch.cuda.empty_cache()
    # (d): the CLI deploy; its losses through the step, its refusal caught
    from tnn_tpu_torch.parallel import data_parallel as dp

    rec = {"name": "cli", "rank": rank, "losses": []}
    real_call = dp.DPTrainStep.__call__

    def call(step, state, data, labels):
        out = real_call(step, state, data, labels)
        rec["losses"].append(float(out[1]["loss"]))
        return out

    reset_flash_launches()
    dp.DPTrainStep.__call__ = call
    step("cli")
    t_run = time.perf_counter()
    try:
        dist_worker.main(["--coordinator", spec["cli_address"], "--rank",
                          str(rank)])
    except Exception as e:  # noqa: BLE001 — the snapshot's refusal
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        dp.DPTrainStep.__call__ = real_call
    rec["launches"] = dd_launches()
    rec["seconds"] = time.perf_counter() - t_run
    emit(rec)
    return 0


def da_in_process_gates(tmp):
    """Every layout's FP32 gate on the in-process mesh of two positions on
    the card: the records by name, each first update left in ``tmp`` for
    the ranks (written under another name, then renamed)."""
    import os

    import torch

    model, start = da_models(("fp32",))["fp32"]
    gate_batches = da_batches(model.vocab_size, DA_GATE_STEPS)
    recs = {}
    saved = os.environ.get("TNN_FLASH_FUSED_BWD")
    for key, axes, method in DA_LAYOUTS:
        os.environ["TNN_FLASH_FUSED_BWD"] = "0"
        try:
            with pax_fp32():
                rec = da_run(model, start, axes, method, gate_batches, True,
                             devices=["cuda:0"] * 2)
        finally:
            if saved is None:
                os.environ.pop("TNN_FLASH_FUSED_BWD", None)
            else:
                os.environ["TNN_FLASH_FUSED_BWD"] = saved
        path = tmp / f"axes_ref_update_{key}.pt"
        torch.save(rec.pop("update"), path.with_suffix(".part"))
        os.replace(path.with_suffix(".part"), path)
        recs[f"{key}_gate"] = rec
    del model, start
    torch.cuda.empty_cache()
    return recs


def da_in_process_bf16():
    """Every layout's bf16 run on the in-process mesh, and the bytes each
    position holds at ``{"data": 2}``."""
    import torch

    model, start = da_models(("bf16",))["bf16"]
    batches = da_batches(model.vocab_size, DA_BF16_STEPS)
    devices = ["cuda:0"] * 2
    recs = {f"{key}_bf16": da_run(model, start, axes, method, batches,
                                  False, devices=devices)
            for key, axes, method in DA_LAYOUTS}
    recs["data2_bytes"] = da_placed_bytes(model, start, {"data": 2}, devices)
    del model, start
    torch.cuda.empty_cache()
    return recs


def da_run_ranks(tmp, fields, meanwhile):
    """Both ranks through every layout and the CLI deploy (this process
    hosting the deploy's coordinator, running ``meanwhile()`` once the
    ranks are started); each rank's records by name."""
    from tnn_tpu_torch.distributed import Coordinator

    data = tmp / "cifar100"
    data.mkdir()
    cifar100_files(data, records=(DA_CLI_BATCH * DA_CLI_STEPS,
                                  DA_CLI_BATCH))
    coord = Coordinator(2)
    procs, logs = [], []
    try:
        spec = {"out": str(tmp), "address": f"127.0.0.1:{dd_free_port()}",
                "cli_address": f"127.0.0.1:{coord.port()}"}
        (tmp / "axes_spec.json").write_text(json.dumps(spec))
        for r in (0, 1):
            logs.append(tmp / f"axes_rank{r}.log")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--axes-rank", str(tmp / "axes_spec.json"), str(r)],
                stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT,
                cwd=Path(__file__).resolve().parent))
        t_gates = time.perf_counter()
        meanwhile()
        fields["in_process_gates_s"] = time.perf_counter() - t_gates

        def alive():
            for r, p in enumerate(procs):
                if p.poll() is not None and p.returncode != 0:
                    raise AssertionError(
                        f"distributed_axes: rank {r} exited "
                        f"{p.returncode}:\n{logs[r].read_text()[-3000:]}")

        def hung(limit):
            steps = [(tmp / f"axes_rank{r}.step").read_text()
                     if (tmp / f"axes_rank{r}.step").exists() else "start-up"
                     for r in (0, 1)]
            return AssertionError(f"distributed_axes: the ranks ran past "
                                  f"{limit} s in {steps}")

        deadline = time.perf_counter() + 600
        while True:     # the ranks join once their layouts are done
            try:
                coord.wait_for_workers(timeout=5)
                break
            except TimeoutError:
                alive()
                if time.perf_counter() > deadline:
                    raise hung(600)

        config = dict(
            model_name="flash_vit", dataset_name="cifar100",
            dataset_path=str(data), batch_size=DA_CLI_BATCH, epochs=1,
            max_steps=DA_CLI_STEPS, seed=0,
            mesh_axes={"fsdp": 2}, progress_print_interval=1,
            jax_coordinator=f"127.0.0.1:{dd_free_port()}",
            ranks={str(r): {"snapshot_dir": str(tmp / f"axes_snap{r}")}
                   for r in (0, 1)})
        t_cli = time.perf_counter()
        coord.deploy_config(config, timeout=120)
        coord.barrier("start", timeout=300)
        try:
            coord.barrier("done", timeout=300)
        except RuntimeError as e:   # the ranks left: the snapshot's refusal
            fields["cli_coordinator"] = str(e)
        fields["cli_wall_s"] = time.perf_counter() - t_cli
        for p in procs:
            try:
                p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                raise hung(300) from None
        alive()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        coord.close()
        for r, path in enumerate(logs):
            if path.exists():
                print(f"--- axes rank {r} ---\n" + path.read_text()[-3000:],
                      file=sys.stderr)
    recs = [{}, {}]
    for r in (0, 1):
        for line in (tmp / f"axes_rank{r}.jsonl").read_text().splitlines():
            rec = json.loads(line)
            recs[r][rec["name"]] = rec
    return recs


def phase_distributed_axes(results):
    import tempfile

    card = results["card"]
    for name in ("tnn.train", "tnn.dist.coord", "tnn.dist.worker"):
        train_logs_to_stderr(name)
    fields = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        refs = {}
        with contextlib.redirect_stdout(sys.stderr):
            t_ranks = time.perf_counter()
            ranks = da_run_ranks(
                tmp, fields, lambda: refs.update(da_in_process_gates(tmp)))
            fields["ranks_s"] = time.perf_counter() - t_ranks
            t_ref = time.perf_counter()
            refs.update(da_in_process_bf16())
            fields["in_process_bf16_s"] = time.perf_counter() - t_ref
    layouts, checks, bad = {}, {}, []
    for key, axes, method in DA_LAYOUTS:
        gate = [r[f"{key}_gate"] for r in ranks]
        bf16 = [r[f"{key}_bf16"] for r in ranks]
        ref_gate, ref_bf16 = refs[f"{key}_gate"], refs[f"{key}_bf16"]
        want = {kind: da_launches_expected(method, fp32, steps)
                for kind, fp32, steps in (("gate", True, DA_GATE_STEPS),
                                          ("bf16", False, DA_BF16_STEPS))}
        row = {
            "gate_losses": gate[0]["losses"],
            "gate_in_process_losses": ref_gate["losses"],
            "gate_update_gap": [g["update_gap"] for g in gate],
            "gate_update_worst_leaf": gate[0]["update_worst_leaf"],
            "bf16_losses": bf16[0]["losses"],
            "bf16_in_process_losses": ref_bf16["losses"],
            "bf16_loss_rel_gap": [abs(a - b) / abs(b) for a, b in
                                  zip(bf16[0]["losses"],
                                      ref_bf16["losses"])],
            "bf16_step_ms": [b["step_ms"] for b in bf16],
            "bf16_in_process_step_ms": ref_bf16["step_ms"],
            "collectives_step2": [
                {k: {"ms": v[0], "mb": v[1] / 2**20, "calls": v[2]}
                 for k, v in b["collectives"].items()} for b in bf16],
            "peak_gb_rank": [b["peak_gb"] for b in bf16],
            "peak_gb_in_process": ref_bf16["peak_gb"],
            "bytes_per_position": [b["bytes_per_position"] for b in bf16],
            "launches": {"gate": [g["launches"] for g in gate],
                         "bf16": [b["launches"] for b in bf16]},
            "launches_expected": want,
            "gate_seconds": [g["seconds"] for g in gate],
            "bf16_seconds": [b["seconds"] for b in bf16],
            "gate_seconds_by_part": gate[0]["seconds_by_part"],
            "gate_ref_wait_load_s": [gate[0]["ref_wait_s"],
                                     gate[0]["ref_load_s"]],
            "bf16_seconds_by_part": bf16[0]["seconds_by_part"]}
        checks[key] = {
            "gate_ranks_equal": gate[0]["losses"] == gate[1]["losses"]
            and gate[0]["param_digest"] == gate[1]["param_digest"],
            "gate_bit_equal": gate[0]["losses"] == ref_gate["losses"]
            and gate[0]["param_digest"] == ref_gate["param_digest"]
            and all(g["update_equal"] for g in gate),
            "gate_update": all(g["update_gap"] <= PAX_UPDATE_TOL
                               for g in gate),
            "bf16_ranks_equal": bf16[0]["losses"] == bf16[1]["losses"],
            "bf16_finite": all(math.isfinite(x) for x in
                               bf16[0]["losses"]),
            "launches": all(g["launches"] == want["gate"] for g in gate)
            and all(b["launches"] == want["bf16"] for b in bf16)}
        layouts[key] = row
        for rec in gate + bf16:
            k4, k7, dq, dkv = rec["launches"]
            results["flash_launches"]["flash_attention_fwd"] += k4
            results["flash_launches"]["flash_attention_bwd"] += k7
            split = results.setdefault("split_launches", {
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0})
            split["flash_attention_bwd_dq"] += dq
            split["flash_attention_bwd_dkv"] += dkv
    fault = [r[f"{DA_FAULT_LAYOUT}_fault"] for r in ranks]
    for f in fault:
        results["flash_launches"]["flash_attention_fwd"] += f["launches"][0]
        results["split_launches"]["flash_attention_bwd_dq"] += \
            f["launches"][2]
        results["split_launches"]["flash_attention_bwd_dkv"] += \
            f["launches"][3]
    checks["fault_fails_gate"] = all(
        f["update_gap"] > PAX_UPDATE_TOL and not f["update_equal"]
        for f in fault)
    fsdp_held = sum(ranks[0]["fsdp2_bf16"]["bytes_per_position"]
                    ["0x0x0x0x0"].values())
    data2_held = sum(refs["data2_bytes"]["0x0x0x0x0"].values())
    checks["fsdp_holds_less"] = fsdp_held < data2_held
    cli = [r["cli"] for r in ranks]
    # the lockstep runs the ViT whole under FSDP's gathering checkpoint,
    # so each backward runs its forward again: K4 twice a step
    cli_want = [2 * VIT_LAYERS * DA_CLI_STEPS, VIT_LAYERS * DA_CLI_STEPS,
                0, 0]
    checks["cli"] = (
        all(c.get("error") and "sharded over 'fsdp' across processes"
            in c["error"] for c in cli)
        and cli[0]["losses"] == cli[1]["losses"]
        and len(cli[0]["losses"]) == DA_CLI_STEPS
        and all(c["launches"] == cli_want for c in cli))
    checks["backend_gloo"] = all(r["group"]["backend"] == "gloo"
                                 for r in ranks)
    for c in cli:
        results["flash_launches"]["flash_attention_fwd"] += c["launches"][0]
        results["flash_launches"]["flash_attention_bwd"] += c["launches"][1]
    for key in layouts:
        bad += [f"{key}.{k}" for k, v in checks[key].items() if not v]
    bad += [k for k, v in checks.items() if v is False]
    ok = not bad
    fields.update(seconds=time.perf_counter() - t0)
    log("distributed_axes", card=card,
        model=f"flash_gpt2_small, {PAR_LAYERS} layers",
        cli_model="flash_vit", cli_batch=DA_CLI_BATCH,
        batch=TRAIN_ARGS["batch"], seq=TRAIN_ARGS["seq"],
        backend=ranks[0]["group"]["backend"],
        backend_reason=ranks[0]["group"]["reason"],
        join_s=[r["group"]["join_s"] for r in ranks],
        models_s=[r["group"]["models_s"] for r in ranks], layouts=layouts,
        fault="g (sum_forward) summing the gradient in the backward too, "
              f"at {DA_FAULT_LAYOUT}",
        fault_update_gap=[f["update_gap"] for f in fault],
        fault_worst_leaf=fault[0]["update_worst_leaf"],
        fault_losses=fault[0]["losses"],
        fault_launches=[f["launches"] for f in fault],
        update_tolerance=PAX_UPDATE_TOL,
        fsdp_bytes_position=ranks[0]["fsdp2_bf16"]["bytes_per_position"],
        data2_bytes_position=refs["data2_bytes"],
        cli_losses=[c["losses"] for c in cli],
        cli_errors=[c.get("error") for c in cli],
        cli_launches=[c["launches"] for c in cli],
        cli_launches_expected=cli_want,
        cli_seconds=[c["seconds"] for c in cli],
        checks=checks, failed=bad, ok=ok, **fields)
    if not ok:
        raise AssertionError(f"distributed_axes: {bad}")


# -- phase 36 -----------------------------------------------------------------
#
# MoE routing, the expert axis and pipelines across processes (module
# docstring, item 36). The ranks (``python3 chip_smoke.py --moe-pipe-rank
# SPEC RANK``) join one gloo group and run every layout; each rank also
# runs the layout's in-process mesh or pipeline on ``["cuda:0"] * 2`` and
# holds its own pieces and stages against it, so no gigabytes of updates
# travel between processes. This process hosts the CLI deploy's
# coordinator, then runs the in-process bf16 runs once the ranks are done.

MP_MOE_BATCH = 4              # B=8 would pass the phase's ~150 s budget
MP_MOE_EXPERTS = 8
MP_GATE_STEPS = 2             # FP32 SGD at PAX_SGD_LR, K5 + K6
MP_BF16_STEPS = 2             # AdamW; step 1's collectives, step 2 timed
MP_CLIP = 0.05                # F8's clip norm (the first norm is ~10x it)
MP_MOE_LAYOUTS = (("data2", {"data": 2}), ("expert2", {"expert": 2}))
MP_PIPE_LAYOUTS = (("pipe2", 1), ("pipe2_v2", 2))
MP_PIPE_MB, MP_PIPE_NUM_MB = 2, 4
MP_CLI_STEPS = 2
MP_CLI_BATCH = 128
MP_COLLECTIVES = {"_reduce_": "all_reduce", "_gather": "gather",
                  "reduce_scatter": "reduce_scatter", "p2p": "hop"}


def mp_moe_model(policy):
    from tnn_tpu_torch.models import gpt2

    return gpt2.gpt2_small(moe_experts=MP_MOE_EXPERTS, backend="pallas",
                           device="cuda", seed=0, policy=policy)


def mp_pipe_model(policy):
    """Phase 28(D)'s float-input flash stack at full depth."""
    from tnn_tpu_torch.nn.builder import LayerBuilder

    seq, width = TRAIN_ARGS["seq"], TRAIN_ARGS["d_model"]
    b = LayerBuilder((seq, width), policy=policy).dense(width)
    for _ in range(TRAIN_ARGS["layers"]):
        b = b.flash_gpt_block(TRAIN_ARGS["heads"])
    model = b.dense(PAR_D_CLASSES).build(name="flash_stack")
    model.init((seq, width), device="cuda", seed=0)
    return model


def mp_pipe_batches(dtype, n):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = MP_PIPE_MB * MP_PIPE_NUM_MB
    shape = (rows, TRAIN_ARGS["seq"], TRAIN_ARGS["d_model"])
    return [(torch.randn(shape, generator=gen, device="cuda").to(dtype),
             torch.randint(0, PAR_D_CLASSES, shape[:2], generator=gen,
                           device="cuda")) for _ in range(n)]


def mp_bits(t):
    """A checksum of a tensor's bits (equal tensors, equal sums)."""
    import torch

    t = t.detach().contiguous()
    view = {4: torch.int32, 2: torch.int16}[t.element_size()]
    return int(t.view(view).to(torch.int64).sum())


def mp_adamw(clip=None):
    """AdamW that records each update's clip norm (the norm of the whole
    tree: ``sq_norm`` where the layout gives it)."""
    import torch

    from tnn_tpu_torch.nn import optimizers as topt

    class Recording(topt.AdamW):
        def update(self, grads, state, params, lr_scale=1.0, sq_norm=None):
            norm = topt.global_norm(grads) if sq_norm is None else \
                torch.sqrt(sq_norm)
            self.norms.append(float(norm))
            return super().update(grads, state, params, lr_scale, sq_norm)

    opt = Recording(lr=3e-4, grad_clip_norm=clip)
    opt.norms = []
    return opt


def mp_held(kind, state, pipe=None):
    """What this process holds, by key: the mesh layout's pieces
    ("position/leaf") or the pipeline's stages ("stage/leaf")."""
    if kind == "pipe":
        return {f"{s}/{n}": p for s in range(pipe.L)
                if pipe.mine(s) is not None
                for n, p in pipe.mine(s).named_parameters()}
    lay = state.layout
    return {"x".join(map(str, c)) + "/" + n: t
            for c in lay.coords for n, t in lay.held[c].items()}


def mp_expected(kind, fp32, steps, attn):
    """PERF.md section 2's counts for one rank: one K4 per attention call
    and one K7 (bf16) or K5 and K6 (FP32) per backward; a MoE rank runs
    all 12 layers of its stream (under "expert" the stream's replicated
    math too), a pipeline rank its stages' blocks for every microbatch."""
    calls = attn * steps * (MP_PIPE_NUM_MB if kind == "pipe" else 1)
    return [calls, 0, calls, calls] if fp32 else [calls, calls, 0, 0]


def mp_run(kind, model, start, layout, batches, fp32, devices=None,
           fault=None, ref=None, clip=None, keep=None):
    """One run of ``kind`` ("moe": ``make_dp_train_step`` at the axes
    ``layout``; "pipe": ``make_pipeline_train_step`` at {"pipe": 2} with
    ``virtual=layout``) from the weights ``start``, over the process
    group (``devices`` None) or in process. FP32: SGD at PAX_SGD_LR (or,
    ``clip``, the recording AdamW), the first update kept (``ref`` None)
    or held against ``ref``'s, of the keys ``keep`` passes (by default
    all this process holds); bf16: AdamW, the first step's collectives.
    Returns the record."""
    import torch

    from tnn_tpu_torch import parallel
    from tnn_tpu_torch.nn.attention import MultiHeadAttention
    from tnn_tpu_torch.nn.optimizers import SGD
    from tnn_tpu_torch.parallel import pipeline as pl
    from tnn_tpu_torch.parallel import process_group as pg
    from tnn_tpu_torch.train import create_train_state

    marks = {"start": time.perf_counter()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = start[n].clone()
    opt = (mp_adamw(clip) if clip else SGD(lr=PAX_SGD_LR)) if fp32 \
        else mp_adamw()
    pipe = None
    if kind == "moe":
        mesh = parallel.make_mesh(**layout, devices=devices)
        step, place_state, _ = parallel.make_dp_train_step(
            model, opt, mesh, ep=layout.get("expert", 1) > 1,
            compute_accuracy=False)
        state = place_state(create_train_state(model, opt, seed=0))
        attn = TRAIN_ARGS["layers"]
    else:
        shape = (MP_PIPE_MB, TRAIN_ARGS["seq"], TRAIN_ARGS["d_model"])
        stages = parallel.partition_model(model, 2 * layout, shape)
        pipe, step, init = parallel.make_pipeline_train_step(
            stages, opt, parallel.make_mesh(pipe=2, devices=devices), shape,
            num_microbatches=MP_PIPE_NUM_MB, virtual=layout,
            input_dtype=torch.float32 if fp32 else torch.bfloat16)
        pipe.load_from(model)
        state = init(None)
        attn = sum(isinstance(m, MultiHeadAttention) for s in range(pipe.L)
                   if pipe.mine(s) is not None for m in pipe.mine(s).modules())
    before = {k: t.detach().clone() for k, t in
              mp_held(kind, state, pipe).items()
              if keep is None or keep(k)} if fp32 else None
    torch.cuda.synchronize()
    marks["placed"] = time.perf_counter()
    reset_flash_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"losses": [], "collectives": {}, "attention_calls": attn}
    real = {"gather_keep": pg.gather_keep, "backward": pl._Row.backward}
    if fault == "gather_sum":
        pg.gather_keep = pg.gather_sum
    elif fault == "hop":        # every hop's gradient dropped on the way back
        def backward(row, back, shape, dtype):
            def dropped(s, m, g):
                gx = back(s, m, g)
                return None if gx is None else torch.zeros_like(gx)
            return real["backward"](row, dropped, shape, dtype)
        pl._Row.backward = backward
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    spans = devices is None
    try:
        for i, (x, y) in enumerate(batches):
            last = i == len(batches) - 1
            watch = not fp32 and i == 0 and spans
            if last:
                t0.record()
            with (da_collectives(rec["collectives"], MP_COLLECTIVES) if watch
                  else contextlib.nullcontext()):
                state, m = step(state, x, y)
            if last:
                t1.record()
            rec["losses"].append(float(m["loss"]))
            marks[f"step{i}"] = time.perf_counter()
            if i == 0 and fp32:
                now = mp_held(kind, state, pipe)
                update = {k: now[k].float() - before[k].float()
                          for k in before}
                if ref is None:
                    rec["update"], rec["before"] = update, before
                else:
                    mine = {k: ref["update"][k] for k in update}
                    gap, leaf = pax_update_gap(update, mine, before)
                    rec["update_gap"], rec["update_worst_leaf"] = gap, leaf
                    rec["update_equal"] = all(torch.equal(update[k], mine[k])
                                              for k in update)
                del update, now
    finally:
        pg.gather_keep, pl._Row.backward = real["gather_keep"], \
            real["backward"]
    torch.cuda.synchronize()
    rec["step_ms"] = t0.elapsed_time(t1)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    rec["launches"] = dd_launches()
    rec["launches_expected"] = mp_expected(kind, fp32, len(batches), attn)
    held = mp_held(kind, state, pipe)
    rec["bits"] = {k: mp_bits(t) for k, t in held.items()}
    if kind == "moe":
        lay = state.layout
        rec["replicated_bits"] = {n: mp_bits(lay.held[lay.coords[0]][n])
                                  for n in lay.axis if lay.axis[n] is None}
        rec["bytes_per_position"] = {
            "x".join(map(str, c)): v for c, v in
            lay.position_bytes(state.opt_state).items()}
    else:
        rec["stages"] = [s for s in range(pipe.L) if pipe.mine(s) is not None]
    rec["norms"] = list(getattr(opt, "norms", []))
    if ref is not None:
        rec["bits_equal"] = all(ref["bits"][k] == v
                                for k, v in rec["bits"].items())
        rec["losses_equal"] = rec["losses"] == ref["losses"]
        rec["norms_equal"] = rec["norms"] == ref["norms"]
    marks["end"] = time.perf_counter()
    names = list(marks)
    rec["seconds_by_part"] = {b: marks[b] - marks[a]
                              for a, b in zip(names, names[1:])}
    if kind == "moe":
        state.layout.write_back(model)
    del state, step
    torch.cuda.empty_cache()
    return rec


def mp_keep(kind, layout, rank):
    """The keys of this rank's own pieces or stages in the in-process
    run of ``layout`` (one position a rank, 2 positions)."""
    if kind == "pipe":
        return lambda k: int(k.split("/")[0]) % 2 == rank
    (axis,) = layout
    at = ("data", "fsdp", "model", "seq", "expert").index(axis)
    return lambda k: int(k.split("/")[0].split("x")[at]) == rank


def mp_gates(kind, model, start, layouts, batches, emit, step, rank):
    """Every layout's FP32 gate: the in-process run, then the run across
    the ranks held against it, and the planted fault (1 step) against
    the first layout's; F8 for MoE (AdamW with a binding clip at
    ``{"expert": 2}``)."""
    import os

    saved = os.environ.get("TNN_FLASH_FUSED_BWD")
    os.environ["TNN_FLASH_FUSED_BWD"] = "0"
    try:
        with pax_fp32():
            for i, (key, layout) in enumerate(layouts):
                step(f"{key}_in_process")
                t_run = time.perf_counter()
                ref = mp_run(kind, model, start, layout, batches, True,
                             devices=["cuda:0"] * 2,
                             keep=mp_keep(kind, layout, rank))
                step(f"{key}_gate")
                rec = mp_run(kind, model, start, layout, batches, True,
                             ref=ref)
                emit(dict(rec, name=f"{key}_gate",
                          in_process_losses=ref["losses"],
                          in_process_launches=ref["launches"],
                          seconds=time.perf_counter() - t_run))
                if i == 0:
                    step(f"{key}_fault")
                    t_run = time.perf_counter()
                    rec = mp_run(kind, model, start, layout, batches[:1],
                                 True, ref=ref, fault="gather_sum"
                                 if kind == "moe" else "hop")
                    emit(dict(rec, name=f"{kind}_fault", layout=key,
                              seconds=time.perf_counter() - t_run))
                del ref
            if kind == "moe":
                step("f8")
                t_run = time.perf_counter()
                ref = mp_run(kind, model, start, {"expert": 2}, batches,
                             True, devices=["cuda:0"] * 2, clip=MP_CLIP,
                             keep=mp_keep(kind, {"expert": 2}, rank))
                rec = mp_run(kind, model, start, {"expert": 2}, batches,
                             True, ref=ref, clip=MP_CLIP)
                emit(dict(rec, name="f8", in_process_norms=ref["norms"],
                          in_process_losses=ref["losses"],
                          seconds=time.perf_counter() - t_run))
                del ref
    finally:
        if saved is None:
            os.environ.pop("TNN_FLASH_FUSED_BWD", None)
        else:
            os.environ["TNN_FLASH_FUSED_BWD"] = saved


def mp_rank_main(spec_path, rank):
    """One rank of phase 36: every layout in one process group, then the
    CLI deploy; one JSON line a run into the spec's output directory."""
    import torch

    from tnn_tpu_torch.cli import dist_worker
    from tnn_tpu_torch.core import dtypes as dt
    from tnn_tpu_torch.parallel import pipeline as pl
    from tnn_tpu_torch.parallel import process_group as pg

    spec = json.loads(Path(spec_path).read_text())
    tmp = Path(spec["out"])
    out_path = tmp / f"mp_rank{rank}.jsonl"

    def emit(rec):
        rec = {k: v for k, v in rec.items() if k not in ("update", "before")}
        with open(out_path, "a") as f:
            f.write(json.dumps(dict(rec, rank=rank)) + "\n")

    def step(name):     # what a hung rank was in (mp_run_ranks)
        (tmp / f"mp_rank{rank}.step").write_text(name)

    t0 = time.perf_counter()
    pg.initialize(spec["address"], 2, rank, "cuda:0")
    emit({"name": "group", "backend": pg.backend(),
          "reason": pg.backend_reason(), "join_s": time.perf_counter() - t0})
    for kind, layouts in (("moe", MP_MOE_LAYOUTS), ("pipe", MP_PIPE_LAYOUTS)):
        step(f"{kind}_models")
        t_models = time.perf_counter()
        if kind == "moe":
            model = mp_moe_model(dt.FP32)
            vocab = model.vocab_size
            gate = pax_batches(vocab, MP_MOE_BATCH, TRAIN_ARGS["seq"])[
                :MP_GATE_STEPS]
        else:
            model = mp_pipe_model(dt.FP32)
            gate = mp_pipe_batches(torch.float32, MP_GATE_STEPS)
        emit({"name": f"{kind}_models", "seconds":
              time.perf_counter() - t_models,
              "params": sum(p.numel() for p in model.parameters())})
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        mp_gates(kind, model, start, layouts, gate, emit, step, rank)
        del model, start, gate
        torch.cuda.empty_cache()
        model = mp_moe_model(dt.MIXED_BF16) if kind == "moe" else \
            mp_pipe_model(dt.MIXED_BF16)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        batches = pax_batches(vocab, MP_MOE_BATCH, TRAIN_ARGS["seq"])[
            :MP_BF16_STEPS] if kind == "moe" else \
            mp_pipe_batches(torch.bfloat16, MP_BF16_STEPS)
        for key, layout in layouts:
            step(f"{key}_bf16")
            t_run = time.perf_counter()
            rec = mp_run(kind, model, start, layout, batches, False)
            emit(dict(rec, name=f"{key}_bf16",
                      seconds=time.perf_counter() - t_run))
        del model, start, batches
        torch.cuda.empty_cache()
    pg.shutdown()
    # (c): the CLI deploy; its losses through the step, its refusal caught
    rec = {"name": "cli", "losses": []}
    real_make = pl.make_pipeline_train_step

    def make(*a, **kw):
        pipe, step_fn, init = real_make(*a, **kw)

        def recording(state, data, labels):
            state, m = step_fn(state, data, labels)
            rec["losses"].append(float(m["loss"]))
            return state, m

        rec["stages"] = [s for s in range(pipe.L)
                         if pipe.mine(s) is not None]
        return pipe, recording, init

    pl.make_pipeline_train_step = make
    step("cli")
    t_run = time.perf_counter()
    try:
        dist_worker.main(["--coordinator", spec["cli_address"], "--rank",
                          str(rank)])
    except Exception as e:  # noqa: BLE001 — the snapshot's refusal
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        pl.make_pipeline_train_step = real_make
    rec["seconds"] = time.perf_counter() - t_run
    emit(rec)
    return 0


def mp_run_ranks(tmp, fields):
    """Both ranks through every layout and the CLI deploy (this process
    hosting the deploy's coordinator); each rank's records by name."""
    from tnn_tpu_torch.distributed import Coordinator

    data = tmp / "cifar100"
    data.mkdir()
    cifar100_files(data, records=(MP_CLI_BATCH * MP_CLI_STEPS,
                                  MP_CLI_BATCH))
    coord = Coordinator(2)
    procs, logs = [], []
    try:
        spec = {"out": str(tmp), "address": f"127.0.0.1:{dd_free_port()}",
                "cli_address": f"127.0.0.1:{coord.port()}"}
        (tmp / "mp_spec.json").write_text(json.dumps(spec))
        for r in (0, 1):
            logs.append(tmp / f"mp_rank{r}.log")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--moe-pipe-rank", str(tmp / "mp_spec.json"), str(r)],
                stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT,
                cwd=Path(__file__).resolve().parent))

        def alive():
            for r, p in enumerate(procs):
                if p.poll() is not None and p.returncode != 0:
                    raise AssertionError(
                        f"distributed_moe_pipe: rank {r} exited "
                        f"{p.returncode}:\n{logs[r].read_text()[-3000:]}")

        def hung(limit):
            steps = [(tmp / f"mp_rank{r}.step").read_text()
                     if (tmp / f"mp_rank{r}.step").exists() else "start-up"
                     for r in (0, 1)]
            return AssertionError(f"distributed_moe_pipe: the ranks ran past "
                                  f"{limit} s in {steps}")

        deadline = time.perf_counter() + 600
        while True:     # the ranks join once their layouts are done
            try:
                coord.wait_for_workers(timeout=5)
                break
            except TimeoutError:
                alive()
                if time.perf_counter() > deadline:
                    raise hung(600)
        fields["layouts_s"] = time.perf_counter() - fields["t0"]
        config = dict(
            model_name="cifar100_wrn16_8", dataset_name="cifar100",
            dataset_path=str(data), batch_size=MP_CLI_BATCH, epochs=1,
            max_steps=MP_CLI_STEPS, seed=0, mesh_axes={"pipe": 2},
            num_microbatches=2, io_dtype="float32",
            optimizer={"type": "sgd", "lr": 0.1}, progress_print_interval=1,
            jax_coordinator=f"127.0.0.1:{dd_free_port()}",
            ranks={str(r): {"snapshot_dir": str(tmp / f"mp_snap{r}")}
                   for r in (0, 1)})
        t_cli = time.perf_counter()
        coord.deploy_config(config, timeout=120)
        coord.barrier("start", timeout=300)
        try:
            coord.barrier("done", timeout=300)
        except RuntimeError as e:   # the ranks left: the snapshot's refusal
            fields["cli_coordinator"] = str(e)
        fields["cli_wall_s"] = time.perf_counter() - t_cli
        for p in procs:
            try:
                p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                raise hung(300) from None
        alive()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        coord.close()
        for r, path in enumerate(logs):
            if path.exists():
                print(f"--- moe/pipe rank {r} ---\n"
                      + path.read_text()[-3000:], file=sys.stderr)
    recs = [{}, {}]
    for r in (0, 1):
        for line in (tmp / f"mp_rank{r}.jsonl").read_text().splitlines():
            rec = json.loads(line)
            recs[r][rec["name"]] = rec
    return recs


def mp_in_process_bf16():
    """Every layout's bf16 run on the in-process mesh or pipeline, and the
    bytes each position holds at ``{"data": 2}`` and ``{"expert": 2}``."""
    import torch

    from tnn_tpu_torch.core import dtypes as dt

    out = {}
    model = mp_moe_model(dt.MIXED_BF16)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = pax_batches(model.vocab_size, MP_MOE_BATCH,
                          TRAIN_ARGS["seq"])[:MP_BF16_STEPS]
    for key, axes in MP_MOE_LAYOUTS:
        out[f"{key}_bf16"] = mp_run("moe", model, start, axes, batches,
                                    False, devices=["cuda:0"] * 2)
    del model, start, batches
    torch.cuda.empty_cache()
    model = mp_pipe_model(dt.MIXED_BF16)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = mp_pipe_batches(torch.bfloat16, MP_BF16_STEPS)
    for key, virtual in MP_PIPE_LAYOUTS:
        out[f"{key}_bf16"] = mp_run("pipe", model, start, virtual, batches,
                                    False, devices=["cuda:0"] * 2)
    del model, start, batches
    torch.cuda.empty_cache()
    return out


def phase_distributed_moe_pipe(results):
    import tempfile

    card = results["card"]
    for name in ("tnn.train", "tnn.dist.coord", "tnn.dist.worker"):
        train_logs_to_stderr(name)
    t_phase = time.perf_counter()
    fields = {"t0": t_phase}
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(sys.stderr):
            ranks = mp_run_ranks(Path(tmp), fields)
            t_ref = time.perf_counter()
            refs = mp_in_process_bf16()
            fields["in_process_bf16_s"] = time.perf_counter() - t_ref
    layouts, checks = {}, {}
    for key, _ in MP_MOE_LAYOUTS + MP_PIPE_LAYOUTS:
        gate = [r[f"{key}_gate"] for r in ranks]
        bf16 = [r[f"{key}_bf16"] for r in ranks]
        ref = refs[f"{key}_bf16"]
        layouts[key] = {
            "gate_losses": gate[0]["losses"],
            "gate_in_process_losses": gate[0]["in_process_losses"],
            "gate_update_gap": [g["update_gap"] for g in gate],
            "gate_update_worst_leaf": gate[0]["update_worst_leaf"],
            "bf16_losses": [b["losses"] for b in bf16],
            "bf16_in_process_losses": ref["losses"],
            "bf16_loss_rel_gap": [abs(a - b) / abs(b) for a, b in
                                  zip(bf16[0]["losses"], ref["losses"])],
            "bf16_step_ms": [b["step_ms"] for b in bf16],
            "bf16_in_process_step_ms": ref["step_ms"],
            "collectives_step1": [
                {k: {"ms": v[0], "mb": v[1] / 2**20, "calls": v[2]}
                 for k, v in b["collectives"].items()} for b in bf16],
            "peak_gb_rank": [b["peak_gb"] for b in bf16],
            "peak_gb_in_process": ref["peak_gb"],
            "launches": {"gate": [g["launches"] for g in gate],
                         "bf16": [b["launches"] for b in bf16]},
            "launches_expected": {"gate": [g["launches_expected"]
                                           for g in gate],
                                  "bf16": [b["launches_expected"]
                                           for b in bf16]},
            "attention_calls": [g["attention_calls"] for g in gate],
            "gate_seconds": [g["seconds"] for g in gate],
            "bf16_seconds": [b["seconds"] for b in bf16],
            "gate_seconds_by_part": gate[0]["seconds_by_part"]}
        if "bytes_per_position" in bf16[0]:
            layouts[key]["bytes_per_position"] = [
                b["bytes_per_position"] for b in bf16]
        else:
            layouts[key]["stages"] = [b["stages"] for b in bf16]
        checks[key] = {
            "gate_ranks_equal": gate[0]["losses"] == gate[1]["losses"]
            and gate[0].get("replicated_bits") ==
            gate[1].get("replicated_bits"),
            "gate_bit_equal": all(g["losses_equal"] and g["bits_equal"]
                                  and g["update_equal"] for g in gate),
            "gate_update": all(g["update_gap"] <= PAX_UPDATE_TOL
                               for g in gate),
            "bf16_ranks_equal": bf16[0]["losses"] == bf16[1]["losses"],
            "bf16_finite": all(math.isfinite(x) for x in
                               bf16[0]["losses"]),
            "launches": all(r["launches"] == r["launches_expected"]
                            for r in gate + bf16)}
        for rec in gate + bf16:
            k4, k7, dq, dkv = rec["launches"]
            results["flash_launches"]["flash_attention_fwd"] += k4
            results["flash_launches"]["flash_attention_bwd"] += k7
            split = results.setdefault("split_launches", {
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0})
            split["flash_attention_bwd_dq"] += dq
            split["flash_attention_bwd_dkv"] += dkv
    faults = {kind: [r[f"{kind}_fault"] for r in ranks]
              for kind in ("moe", "pipe")}
    for kind, recs in faults.items():
        # the gate fails where any rank's update does (under "pipe" the
        # last stage's own update does not see the dropped gradient)
        checks[f"{kind}_fault_fails_gate"] = any(
            f["update_gap"] > PAX_UPDATE_TOL and not f["update_equal"]
            for f in recs)
        for f in recs:
            results["flash_launches"]["flash_attention_fwd"] += \
                f["launches"][0]
            results["split_launches"]["flash_attention_bwd_dq"] += \
                f["launches"][2]
            results["split_launches"]["flash_attention_bwd_dkv"] += \
                f["launches"][3]
    f8 = [r["f8"] for r in ranks]
    checks["f8"] = all(f["norms_equal"] and f["losses_equal"]
                       and f["bits_equal"] for f in f8) \
        and f8[0]["norms"] == f8[1]["norms"] \
        and all(n > MP_CLIP for n in f8[0]["norms"])
    for f in f8:
        results["flash_launches"]["flash_attention_fwd"] += f["launches"][0]
        results["split_launches"]["flash_attention_bwd_dq"] += \
            f["launches"][2]
        results["split_launches"]["flash_attention_bwd_dkv"] += \
            f["launches"][3]
    expert_held = sum(ranks[0]["expert2_bf16"]["bytes_per_position"]
                      ["0x0x0x0x0"].values())
    data_held = sum(ranks[0]["data2_bf16"]["bytes_per_position"]
                    ["0x0x0x0x0"].values())
    checks["expert_holds_less"] = expert_held < data_held
    cli = [r["cli"] for r in ranks]
    checks["cli"] = (
        all(c.get("error") and "sharded over 'pipe' across processes"
            in c["error"] for c in cli)
        and cli[0]["losses"] == cli[1]["losses"]
        and len(cli[0]["losses"]) == MP_CLI_STEPS
        and sorted(cli[0]["stages"] + cli[1]["stages"]) == [0, 1])
    checks["backend_gloo"] = all(r["group"]["backend"] == "gloo"
                                 for r in ranks)
    bad = [f"{k}.{kk}" for k, v in checks.items() if isinstance(v, dict)
           for kk, vv in v.items() if not vv]
    bad += [k for k, v in checks.items() if v is False]
    ok = not bad
    fields.pop("t0")
    log("distributed_moe_pipe", card=card,
        moe_model=f"gpt2_small(moe_experts={MP_MOE_EXPERTS}, "
                  f"backend='pallas'), top-2",
        moe_params=ranks[0]["moe_models"]["params"],
        moe_batch=MP_MOE_BATCH, seq=TRAIN_ARGS["seq"],
        moe_batch_note="B=4: B=8 would pass the phase's budget",
        pipe_model=f"dense {TRAIN_ARGS['d_model']} + "
                   f"{TRAIN_ARGS['layers']} x flash_gpt_block("
                   f"{TRAIN_ARGS['heads']}) + dense {PAR_D_CLASSES}",
        pipe_params=ranks[0]["pipe_models"]["params"],
        pipe_microbatches=[MP_PIPE_NUM_MB, MP_PIPE_MB],
        backend=ranks[0]["group"]["backend"],
        backend_reason=ranks[0]["group"]["reason"],
        join_s=[r["group"]["join_s"] for r in ranks],
        models_s={k: [r[f"{k}_models"]["seconds"] for r in ranks]
                  for k in ("moe", "pipe")},
        layouts=layouts,
        faults={"moe": "gather_sum where gather_keep belongs, at data2",
                "pipe": "every hop's gradient dropped, at pipe2"},
        fault_update_gap={k: [f["update_gap"] for f in v]
                          for k, v in faults.items()},
        fault_worst_leaf={k: v[0]["update_worst_leaf"]
                          for k, v in faults.items()},
        f8_norms=[f["norms"] for f in f8],
        f8_in_process_norms=f8[0]["in_process_norms"],
        f8_losses=[f["losses"] for f in f8],
        f8_in_process_losses=f8[0]["in_process_losses"], f8_clip=MP_CLIP,
        update_tolerance=PAX_UPDATE_TOL,
        expert_bytes_position=ranks[0]["expert2_bf16"]["bytes_per_position"],
        data_bytes_position=ranks[0]["data2_bf16"]["bytes_per_position"],
        cli_model="cifar100_wrn16_8", cli_batch=MP_CLI_BATCH,
        cli_losses=[c["losses"] for c in cli],
        cli_errors=[c.get("error") for c in cli],
        cli_stages=[c.get("stages") for c in cli],
        cli_seconds=[c["seconds"] for c in cli],
        checks=checks, failed=bad, ok=ok, **fields,
        seconds=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError(f"distributed_moe_pipe: {bad}")


# -- phase 32 -----------------------------------------------------------------
#
# The engine's debug guards on full-width gpt2_small: TNN_DEBUG_SYNC (the
# step under torch's sync-debug mode "error", serving/sync_guard.py) token
# for token against the guard off on the default paged path, n-gram and
# draft-model speculation and the overlapped graph step; a planted
# blocking put from pageable memory that must fail its request (and decode
# token-exact without the knob); TNN_POOL_DEBUG over staggered shared-
# prefix traffic; the other programs under the guard once each, every
# trip printed with the line that synchronized.

GUARD_REQUESTS = 8            # the serving traffic: PERF.md section 4
GUARD_TOKENS = 64
GUARD_OTHER_REQUESTS = 4      # each other program, trips only
GUARD_OTHER_TOKENS = 16


@contextlib.contextmanager
def knob_env(*names):
    """Each environment variable of ``names`` set to "1" while engines are
    made inside (the knobs are read at construction)."""
    import os

    old = {n: os.environ.get(n) for n in names}
    os.environ.update({n: "1" for n in names})
    try:
        yield
    finally:
        for n, v in old.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def guard_prompts(vocab, n=GUARD_REQUESTS, seed=0):
    """``serve_traffic``'s prompts: lengths 16-768 from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(16, 769)))
            for _ in range(n)]


def guard_run(model, prompts, knobs=(), new_tokens=GUARD_TOKENS,
              stagger=False, **engine_kw):
    """One engine over ``prompts`` (odd ones sampled, as the serving
    traffic) made under ``knobs``. ``stagger``: the first request steps
    until its 512-token prefix is resident before the rest join. Returns
    the engine and, per request, (state, tokens, error)."""
    import torch

    from tnn_tpu_torch.serving.engine import InferenceEngine

    cfg = dict(num_blocks=512, block_size=16, max_batch_size=8,
               chunk_size=64, seed=0)
    with knob_env(*knobs):
        engine = InferenceEngine(model, device=model.device,
                                 **{**cfg, **engine_kw})

    def submit(i, prompt):
        sampled = i % 2 == 1
        return engine.submit(
            prompt, new_tokens, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 0.0)

    rids = [submit(0, prompts[0])]
    if stagger:
        while engine.result(rids[0]).cache_len < PREFIX_LEN:
            engine.step()
    rids += [submit(i, p) for i, p in enumerate(prompts) if i]
    t0 = time.perf_counter()
    engine.run_until_complete()
    torch.cuda.synchronize()
    engine.wall_s = time.perf_counter() - t0
    engine.check_invariants()
    return engine, [(engine.result(r).state.value,
                     list(engine.result(r).out_tokens),
                     engine.result(r).error) for r in rids]


def guard_trips(out):
    """The distinct TNN_DEBUG_SYNC errors of a run's failed requests."""
    return sorted({err for _, _, err in out
                   if err and "TNN_DEBUG_SYNC" in err})


def guard_pair(label, model, prompts, card, order=(False, True), **kw):
    """The same traffic with the guard off and on in ``order`` (True: on):
    every request FINISHED in every run, token for token, no trip; the
    step times of each. Returns the engines in ``order`` and the first
    run's requests."""
    engines, outs = [], []
    for on in order:
        eng, out = guard_run(model, prompts, knobs=("TNN_DEBUG_SYNC",)
                             if on else (), **kw)
        engines.append(eng)
        outs.append(out)
    stats = [e.stats() for e in engines]
    on_eng = engines[order.index(True)]

    def times(key, on):
        return [x for x, o in zip(key, order) if o == on]
    step_ms = [st["step_latency_ms_mean"] for st in stats]
    fields = dict(
        card=card, program=label, requests=len(prompts),
        order=["on" if o else "off" for o in order],
        finished=[sum(st == "finished" for st, _, _ in o) for o in outs],
        token_exact=all([a[1] for a in o] == [b[1] for b in outs[0]]
                        for o in outs),
        trips=sorted({t for o in outs for t in guard_trips(o)}),
        armed=[e._sync_armed for e in engines],
        step_ms_off=times(step_ms, False), step_ms_guarded=times(step_ms,
                                                                 True),
        wall_s_off=times([e.wall_s for e in engines], False),
        wall_s_guarded=times([e.wall_s for e in engines], True),
        program_steps=on_eng.stats()["program_steps"],
        graph_replays=on_eng.stats()["graph_replays"],
        spec_acceptance=on_eng.stats().get("spec_acceptance_rate"),
        adopted=on_eng.metrics.overlap_adopted)
    log("debug_guards", **fields)
    if not (fields["armed"] == list(order) and fields["token_exact"]
            and fields["finished"] == [len(prompts)] * len(order)):
        raise AssertionError(f"TNN_DEBUG_SYNC on {label}: {fields}")
    return engines, outs[0]


def planted_blocking_put(self, arrays, tables=None):
    """``_put_step`` as a blocking copy from pageable memory."""
    import numpy as np
    import torch

    arrays = list(arrays) + ([tables] if tables is not None else [])
    return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in arrays]


def guard_plant(model, prompts, base, card):
    """The planted blocking put fails its request under the guard with a
    "synchroniz" error naming the copy; without the knob the same plant
    decodes the traffic token-exact."""
    import numpy as np

    from tnn_tpu_torch.serving.engine import InferenceEngine

    real = InferenceEngine._put_step
    InferenceEngine._put_step = planted_blocking_put
    try:
        eng, out = guard_run(model, [np.arange(5)], knobs=("TNN_DEBUG_SYNC",),
                             new_tokens=4)
        _, plain = guard_run(model, prompts)
    finally:
        InferenceEngine._put_step = real
    state, _, error = out[0]
    fields = dict(card=card, state=state, error=error,
                  pool_allocated=eng.pool.num_allocated,
                  unguarded_token_exact=[o[1] for o in plain]
                  == [o[1] for o in base])
    log("debug_guards_plant", **fields)
    if state != "failed" or "synchroniz" not in (error or "").lower() \
            or "planted_blocking_put" not in error \
            or not fields["unguarded_token_exact"] \
            or fields["pool_allocated"]:
        raise AssertionError(f"planted blocking put: {fields}")


def guard_pool_debug(model, card):
    """TNN_POOL_DEBUG=1 over staggered shared-prefix traffic with the
    prefix cache: token-exact against the knob off, the prefill it saved
    and both step times."""
    prompts = shared_prefix_prompts(model.vocab_size)
    off_eng, off = guard_run(model, prompts, stagger=True)
    on_eng, on = guard_run(model, prompts, knobs=("TNN_POOL_DEBUG",),
                           stagger=True)
    stats = (off_eng.stats(), on_eng.stats())
    fields = dict(card=card, debug=on_eng.pool.debug,
                  token_exact=[o[1] for o in off] == [o[1] for o in on],
                  finished=sum(st == "finished" for st, _, _ in on),
                  prefill_tokens_saved=stats[1]["prefill_tokens_saved"],
                  step_ms_off=stats[0]["step_latency_ms_mean"],
                  step_ms_pool_debug=stats[1]["step_latency_ms_mean"],
                  wall_s_off=off_eng.wall_s, wall_s_pool_debug=on_eng.wall_s)
    log("debug_guards_pool", **fields)
    if not (fields["debug"] and fields["token_exact"]
            and fields["finished"] == len(prompts)
            and fields["prefill_tokens_saved"] > 0):
        raise AssertionError(f"TNN_POOL_DEBUG: {fields}")


def guard_other_programs(model, card):
    """Every other program once under the guard: which tripped, on what
    line. A request may end FINISHED or FAILED by a trip, nothing else."""
    import numpy as np

    from tnn_tpu_torch.models import zoo

    prompts = guard_prompts(model.vocab_size, GUARD_OTHER_REQUESTS, seed=2)
    rng = np.random.default_rng(3)
    lockstep = [rng.integers(0, model.vocab_size, 128) for _ in range(4)]
    moe = zoo.create("moe_gpt2_small", device="cuda", seed=0)
    programs = [
        ("int8_pages", model, prompts, dict(kv_dtype="int8")),
        ("quant_weights", model, prompts, dict(quant_weights=True)),
        ("whole_prompt", model, prompts, dict(chunked_prefill=False)),
        ("sp2", model, prompts, dict(sp=2, sp_devices=SP_DEVICES)),
        ("tp2", model, prompts, tp_kw(2)),
        ("moe", moe, prompts, {}),
        ("fused", model, lockstep, dict(FUSED_SERVING, seed=0))]
    tripped = {}
    for label, m, ps, kw in programs:
        eng, out = guard_run(m, ps, knobs=("TNN_DEBUG_SYNC",),
                             new_tokens=GUARD_OTHER_TOKENS, **kw)
        trips = guard_trips(out)
        other = [(st, err) for st, _, err in out
                 if st != "finished" and not (err and "TNN_DEBUG_SYNC"
                                              in err)]
        log("debug_guards_program", card=card, program=label,
            armed=eng._sync_armed, tripped=bool(trips), trips=trips,
            finished=sum(st == "finished" for st, _, _ in out),
            requests=len(out), program_steps=eng.stats()["program_steps"])
        if other or not eng._sync_armed:
            raise AssertionError(f"{label} under the guard: {other}")
        tripped[label] = trips
    del moe
    return tripped


def phase_debug_guards(results):
    import torch

    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.serving import sync_guard

    card = results["card"]
    t0 = time.perf_counter()
    model = zoo.create("gpt2_small", device="cuda", seed=0)
    vocab = model.vocab_size
    prompts = guard_prompts(vocab)
    cyclic = cyclic_prompts(vocab)
    guard_run(model, prompts[:2], new_tokens=4)                # warm-up
    reset_launches()
    abba = (False, True, True, False)
    engines, base = guard_pair("paged", model, prompts, card, order=abba)
    k1 = read_launches()["k1"]
    want = [model.num_layers * paged_dispatches(e) for e in engines]
    log("debug_guards_launches", card=card, k1=k1, expected_per_run=want)
    if k1 != sum(want) or not all(want):
        raise AssertionError(f"K1 over the guard runs {k1}, expected "
                             f"12 x paged dispatches {want}")
    guard_pair("ngram", model, cyclic, card, spec="ngram", spec_k=4)
    overlap_eng = guard_pair("overlap_graph", model, prompts, card,
                             order=abba, overlap=True)[0][1]
    if not (overlap_eng.stats()["graph_replays"]
            and overlap_eng.metrics.overlap_adopted):
        raise AssertionError("the overlapped guard run replayed no graph "
                             "or adopted no speculative step")
    draft = zoo.create("gpt2_tiny", vocab_size=vocab, max_len=1024,
                       device="cuda", seed=1)
    # the drafter runs a prefill a row a step: half the traffic
    guard_pair("draft", model, cyclic[:4], card, spec="draft", spec_k=4,
               draft_model=draft)
    del draft
    guard_plant(model, prompts, base, card)
    guard_pool_debug(model, card)
    tripped = guard_other_programs(model, card)
    added = read_launches()
    log("debug_guards_summary", card=card, launches=added,
        programs_tripped=sorted(k for k, v in tripped.items() if v),
        mode=sync_guard.mode(), torch_mode=torch.cuda.get_sync_debug_mode(),
        seconds=round(time.perf_counter() - t0, 3))
    if sync_guard.mode() != "default" or torch.cuda.get_sync_debug_mode():
        raise AssertionError("the sync-debug mode stayed armed")
    results["launches"] += added["k1"]
    results["int8_launches"]["k2"] += added["k2"]
    results["int8_launches"]["k3"] += added["k3"]
    results["sp_launches"]["stats"] += added["k1s"]
    results["sp_launches"]["int8_stats"] += added["k1s_int8"]
    results["fused_launches"] += added["k8"]
    del model, engines, overlap_eng
    torch.cuda.empty_cache()


# -- phase 33 -----------------------------------------------------------------
#
# The port's chip tools: tools/torch_trace_step.py (gpt2_decode and wrn, 2
# traced steps each, the top 10 device operations) and tools/
# torch_hbm_fit.py (the card's memory as the default), with the small row's
# train state built on the card beside its exact bytes.

def tool_output(fn, *args):
    """``fn(*args)``'s return value and its printed lines."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args)
    return value, buf.getvalue().strip().splitlines()


def phase_tools(results):
    import tempfile

    import torch

    from tnn_tpu_torch import nn
    from tnn_tpu_torch.models import zoo
    from tnn_tpu_torch.train.step import create_train_state
    from tools import torch_hbm_fit, torch_trace_step

    card = results["card"]
    reset_all_launches()
    for what in ("gpt2_decode", "wrn"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ops, lines = tool_output(torch_trace_step.main, [
                "--what", what, "--steps", "2", "--top", "10", "--out",
                tmp])
        total = sum(ops.values())
        log("tools_trace_step", card=card, what=what, steps=2,
            window_ms=ops.window_us / 1e3, device_ops_ms=total / 1e3,
            idle_share=1 - total / ops.window_us, events=ops.events,
            seconds=round(time.perf_counter() - t0, 3), lines=lines)
        if not (ops.events and 0 < total <= ops.window_us):
            raise AssertionError(f"trace_step {what}: {ops.events} device "
                                 f"ops, {total} of {ops.window_us} us")
        torch.cuda.empty_cache()
    rows, lines = tool_output(torch_hbm_fit.main, [])
    exact = torch_hbm_fit.train_state_bytes(
        zoo.create("gpt2_small", max_len=1024, device="meta", seed=None),
        nn.AdamW(lr=1e-4))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = zoo.create("gpt2_small", max_len=1024, device="cuda", seed=0)
    state = create_train_state(model, nn.AdamW(lr=1e-4))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    log("tools_hbm_fit", card=card, lines=lines,
        hbm_gb=torch.cuda.get_device_properties(0).total_memory / 2**30,
        small_train_state_gb=rows[0]["train_state_GB"],
        small_exact_bytes=exact, small_held_on_card_bytes=held,
        small_max_memory_allocated_bytes=peak)
    if abs(held - exact) > 0.01 * exact:
        raise AssertionError(f"gpt2_small's train state holds {held} bytes "
                             f"on the card, the tool says {exact}")
    added = read_all_launches()
    results["launches"] += added["k1"]
    results["int8_launches"]["k3"] += added["k3"]
    results["flash_launches"]["flash_attention_fwd"] += added["k4"]
    del model, state
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import tnn_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tnn_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    phases = (phase_kernel, phase_flash, phase_flash_split,
              phase_serving, phase_cli, phase_training,
              phase_training_long, phase_train_cli, phase_training_loop,
              phase_int8_kernel,
              phase_int8_matmul, phase_serving_int8, phase_decode_stack,
              phase_fused_generate, phase_serving_fused,
              phase_paged_stats, phase_serving_sp,
              phase_serving_prefix_spec, phase_serving_overlap,
              phase_serving_whole_prompt, phase_attention_int8_rope,
              phase_serving_supervised, phase_serving_fleet,
              phase_serving_tp, phase_serving_moe, phase_training_image,
              phase_training_parallel, phase_training_parallel_axes,
              phase_native, phase_distributed, phase_debug_guards,
              phase_tools, phase_distributed_data,
              phase_distributed_axes, phase_distributed_moe_pipe)
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        only = [f"phase_{n}" for n in sys.argv[2].split(",")]
        phases = [p for p in phases if p.__name__ in only]
        if len(phases) != len(only):
            print(f"chip_smoke: unknown phase in {sys.argv[2]}",
                  file=sys.stderr)
            return 4
    t_start = time.perf_counter()
    info = phase_device()
    # the counters the later phases add to, as the earlier ones leave them
    results = {} if only is None else {
        "launches": 0, "int8_launches": {"k2": 0, "k3": 0},
        "sp_launches": {"stats": 0, "int8_stats": 0}, "fused_launches": 0,
        "flash_launches": {"flash_attention_fwd": 0,
                           "flash_attention_bwd": 0}}
    results["card"] = info["nvidia_smi"]
    build_kernels()
    # the control plane's phase runs beside the queued CLI processes: it
    # waits on processes of its own most of its time (phase 30 runs
    # before them: its host times would read the CLIs' load)
    beside_clis = (phase_distributed,)
    started = None
    for phase in sorted(phases, key=lambda p: p in beside_clis):
        if phase in beside_clis and started is None:
            t_clis = time.perf_counter()
            started = start_deferred_clis()
        t0 = time.perf_counter()
        phase(results)
        log("phase_seconds", name=phase.__name__,
            seconds=round(time.perf_counter() - t0, 3))
    if started is None:
        t_clis = time.perf_counter()
        started = start_deferred_clis()
    finish_deferred_clis(started)
    log("phase_seconds", name="deferred_clis",
        seconds=round(time.perf_counter() - t_clis, 3))
    log("total_seconds", seconds=round(time.perf_counter() - t_start, 3))
    if only is not None:
        return 0
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    flash = "tnn_tpu/ops/pallas/flash_attention.py"
    kernels = [{"name": "paged_attention", "route": "cuda",
                "source": "tnn_tpu_torch/csrc/paged_attention.cu",
                "replaces": "tnn_tpu/ops/pallas/paged_attention.py:203",
                "launches": results["launches"],
                **{k: results["paged_attention"][k] for k in keys}}]
    for name, line in (("flash_attention_fwd", 262),
                       ("flash_attention_bwd", 666)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "tnn_tpu_torch/csrc/flash_attention.cu",
                        "replaces": f"{flash}:{line}",
                        "launches": results["flash_launches"][name],
                        **{k: results[name][k] for k in keys}})
    kernels.append({"name": "paged_attention_int8", "route": "cuda",
                    "source": "tnn_tpu_torch/csrc/paged_attention.cu",
                    "replaces": "tnn_tpu/ops/pallas/paged_attention.py:115",
                    "launches": results["int8_launches"]["k2"],
                    **{k: results["paged_attention_int8"][k] for k in keys}})
    kernels.append({"name": "int8_matmul", "route": "cuda",
                    "source": "tnn_tpu_torch/csrc/quant_matmul.cu",
                    "replaces": "tnn_tpu/ops/pallas/quant_matmul.py:152",
                    "launches": results["int8_launches"]["k3"],
                    **{k: results["int8_matmul"][k] for k in keys}})
    for name, line in (("flash_attention_bwd_dq", 578),
                       ("flash_attention_bwd_dkv", 618)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "tnn_tpu_torch/csrc/flash_attention.cu",
                        "replaces": f"{flash}:{line}",
                        "launches": results["split_launches"][name],
                        **{k: results[name][k] for k in keys}})
    kernels.append({"name": "fused_decode_stack", "route": "cuda",
                    "source": "tnn_tpu_torch/csrc/decode_stack.cu",
                    "replaces": "tnn_tpu/ops/pallas/decode_stack.py:173",
                    "launches": results["fused_launches"],
                    **{k: results["fused_decode_stack"][k] for k in keys}})
    for name, launches in (("paged_attention_stats", "stats"),
                           ("paged_attention_int8_stats", "int8_stats")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "tnn_tpu_torch/csrc/paged_attention.cu",
                        "replaces": "tnn_tpu/ops/pallas/paged_attention.py:203",
                        "launches": results["sp_launches"][launches],
                        **{k: results[name][k] for k in keys}})
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data-rank"]:
        sys.exit(dd_rank_main(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--axes-rank"]:
        sys.exit(da_rank_main(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--moe-pipe-rank"]:
        sys.exit(mp_rank_main(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
