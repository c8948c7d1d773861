#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a), then runs these phases, each printing one JSON line; any failure
ends the run with a non-zero exit code and no result line:

1. ``device``  – card name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions, seconds the kernels took to build; for every
   instantiation of K3's (its input gradient's among them), K3's weight
   gradient's and K1's backward's wgmma kernels and of K1's,
   K2's, K4's, K5's and K5b's bf16 per-chunk mma.sync kernels its
   tensor-core instructions in the SASS (cuobjdump; it fails
   without them, or if an instantiation the sources launch is missing)
   and its registers and spills (ptxas -v); the registers and spills of
   every K5b kernel (the chunks' contributions to the chunk-end states,
   their scan, the per-chunk kernels) and the per-chunk kernels' shared
   memory, and the same of every K4b kernel (with its ordered sums); it
   fails on an atomic or a reduce in any K5b or K4b kernel.
2. ``kernels`` – every kernel against its plain PyTorch version ON THE
   CARD: flash_attention and decode_attention over the sweep of
   tests/test_kernels.py (2e-5 float32, 2e-2 bfloat16), moe_gemm over its
   sweep (1e-5 / 3e-2 relative) plus a strided [B, E, C, D] case,
   rwkv6_scan over its sweep (5e-4, finite under strong decay) plus an
   initial state and a bf16 sweep over every head dim (bf16 bars of
   scan_tols, float32 and bf16 outputs), mamba2_scan over its sweep (5e-4 on
   the output and the final state) plus an initial state and bf16 inputs;
   and each at the serving paths' own shapes (zamba2's attention at head
   dim 80; decode_attention also with its length as a device int32, which
   must give the int length's bits; mamba2_scan and rwkv6_scan with the
   float32 output the models ask for), where it is also timed, as the
   serving path calls it, beside its plain version, one PyTorch
   call computing the same function where there is one (yardstick only;
   the port never calls it) and the least time the card could take:
   ``ms`` per back-to-back wrapper call (CUDA events, host gaps
   included) and ``device_ms``, the kernels' own device time per call
   (torch.profiler), as ``library_device_ms`` the library call's: the
   mean over the whole ones of WINDOWS fenced one-call windows
   (``device_time``), ``device_windows`` of them; null where none was
   whole.
3. ``serve``   – the retrieve -> work_a, work_b -> merge workflow of
   examples/serve_workflow_torch.py: 8 queries, 2 virtual devices, FATE
   placements, qwen3-1.7b (28 layers) and glm4-9b (40 layers) at full
   width and depth, prompt 512, 32 generated tokens, random weights
   from a seeded generator.  The kernels' launch counts are zeroed just
   before and must equal what the recorded placements predict after.
   Each bundle's decode step is a captured CUDA graph (one per shard
   batch and max_len, captured in the warm-up pass); every decode step
   of the measured pass must be a replay, but the first of a shard run
   whose key that pass captured, and a replay adds to the counts what
   its capture launched.
4. ``parity``  – the first shard of the first stage again, teacher-forced
   with the eager decode loop at int positions, with the kernels and with
   the plain versions swapped in for them, on the card: max logit
   difference and greedy-token agreement, and the eager kernel path must
   reproduce the tokens the graphs served.
5. ``control_plane`` – measure, fit, schedule, on the first pair's
   bundles: the same workflow served at each (prompt, generated,
   queries) of CONTROL_RUNS ((128, 8, 8), (512, 32, 8), (1024, 16, 4))
   under FATE and under RoundRobin, each run held to the serve phase's
   checks (launch counts equal to what its placements call for, every
   decode step a replay, tokens inside the vocabulary); the engines'
   stage observations fitted into a calibration profile
   (``fit_profile`` at CONTROL_TIME_SCALE, each family's
   coefficients with its rmse, defaulted and collinear columns); the
   ten workflow families (instance 0, 16 queries) and the Poisson
   serving trace scheduled on this machine's host under FATE and the
   five baselines with the hand-set and with the fitted profile: FATE's
   makespan and P95 against RoundRobin per family and as geomeans, its
   solves' milliseconds, every executor invariant held, every workflow
   finished, every solve optimal; and a one-replica HTTP gateway on a
   loopback port fed a trace, whose fingerprint must equal a direct
   ``Scheduler`` run's.
6. ``serve_moe_rwkv`` – the same workflow with granite-moe-3b-a800m as
   "qwen-7b" and rwkv6-3b as "llama-8b", both at full width and depth
   with their published vocabularies, after the first phase's weights
   are freed: attention (K1, K2) launches only for granite, the grouped
   GEMM (K3) for its MoE layers, the RWKV6 scan (K5) for rwkv6's
   prefills.
7. ``parity_moe_rwkv`` – per new model, its first served shard
   teacher-forced with the kernels and with the plain versions: in bf16
   at full depth (the kernel path must reproduce the served tokens) and
   in float32 at full width with 4 layers (logits within 1e-3 of their
   largest magnitude, every greedy token equal; granite, whose random
   init saturates its attention, per layer, and the same cut model with
   its attention projections at 1 / sqrt(d) held to the whole-model bars
   under the kernel run's routing: ROADMAP H25).
8. ``serve_hybrid`` – the same workflow with zamba2-2.7b (54 Mamba2
   layers, one shared attention block at 9 sites, head dim 80) as
   "qwen-7b" and qwen3-1.7b as "llama-8b", at full width and depth with
   their published vocabularies, after the second pair's weights are
   freed: the Mamba2 scan (K4) launches once per layer at zamba2's
   prefills, K1 and K2 once per attention site.
9. ``parity_hybrid`` – zamba2's first served shard teacher-forced with
   the kernels and with the plain versions: in bf16 at full depth (the
   kernel path must reproduce the served tokens) and in float32 at full
   width with 7 layers, one attention site and one tail layer (logits
   within 1e-3 of their largest magnitude, every greedy token equal);
   every block's own difference reported beside both; both again with
   the attention projections at 1 / sqrt(d) (H25): the float32 model held
   to the same bars, the bf16 one's whole-model reading reported (the
   phase says why it is not gated).
10. ``serve_gemma3`` – the same workflow with gemma3-4b (34 layers, 29
   local with a sliding window of 1024 and 5 global, head dim 256, vocab
   262144) as "qwen-7b" and qwen3-1.7b as "llama-8b", at full width and
   depth, at a prompt of 2048 (twice the window), after the third pair's
   weights are freed: K1 binds the window on the local layers' prefill,
   which keep the last 1024 positions in a ring, and K2 decodes over the
   rings (1024 rows) and the global caches (2080); every cache must hold
   the rows its size calls for.
11. ``parity_gemma3`` – gemma3's first served shard teacher-forced with
   the kernels and with the plain versions: in bf16 at full depth (the
   kernel path must reproduce the served tokens) and in float32 at full
   width with its first six layers (five local, one global; logits
   within 1e-3 of their largest magnitude, every greedy token equal).
12. ``serve_deepseek`` – the same workflow with deepseek-v2-236b
   (multi-head latent attention: 128 heads, query/key head dim 128 + 64,
   value head dim 128, latent rank 512; 160 experts, top 6, and 2 shared
   experts; vocab 102400) as "qwen-7b" at full width, its depth cut from
   60 to 6 layers (the dense first layer and 5 MoE layers: 236 B
   parameters do not fit the card; the line's ``reduced`` says so), and
   qwen3-1.7b as "llama-8b", after the fourth pair's weights are freed:
   K1 launches once per layer at deepseek's prefill with D = 192 over
   Dv = 128, K3 three times per MoE layer at its prefill and every decode
   step, K2 never (the absorbed decode step is plain matrix products, as
   in the reference, inside the captured graph).
13. ``parity_deepseek`` – deepseek's first served shard teacher-forced
   with the kernels and with the plain versions: in bf16 at the served
   depth with the routing held as for granite (the kernel path must
   reproduce the served tokens), then, with the served weights freed, in
   float32 at full width with the dense layer and one MoE layer (every
   layer's update within 1e-3 of its magnitude, every greedy token equal
   under held routing).
14. ``serve_qwen15_llava`` – the same workflow with qwen1.5-4b (40 layers,
   d 2560, 20 / 20 heads of 128, q / k / v biases, vocab 151936) as
   "qwen-7b" and llava-next-mistral-7b (32 layers, d 4096, 32 / 8 heads
   of 128, d_ff 14336, vocab 32000) as "llama-8b", both published, at
   full width and depth, after deepseek's weights are freed; the engine
   passes llava no image embeddings, as the reference's does.
15. ``llava_image`` – llava's bundle from the phase before, through its
   ``DecodeGraphs.generate`` with seeded image embeddings [8, 576, 4096]
   in bf16 over the first 576 positions of prompts of 1024 tokens, 32
   tokens: one warm-up pass captures, then K1 32 times at the prefill and
   K2 32 x 31 times, every decode step a replay, bitwise the eager step;
   the same prompts without the embeddings must serve other tokens;
   prefill seconds, decode ms per replayed step beside the weights'
   bound, peak memory.
16. ``parity_qwen15_llava`` – per model its first served shard (and llava
   also llava_image's prompts with their embeddings) teacher-forced with
   the kernels and with the plain versions: in bf16 at full depth (the
   kernel path must reproduce the served tokens); in float32 at full
   width with 4 layers, every layer's update within 1e-3 of its
   magnitude at the random init (whose attention scores have a standard
   deviation of 128-256, ``score_std``), and logits within 1e-3 of their
   largest magnitude with every greedy token equal with the attention
   projections at 1 / sqrt(d).
17. ``whisper`` – whisper-small (12 encoder and 12 decoder layers, d 768,
   12 heads of 64, vocab 51865, 1500 frames) at full width and depth,
   after deepseek's weights are freed, through the model's own API (the
   serving engine passes no frames, as in the reference: ROADMAP H24):
   8 decoder prompts of 224 tokens and seeded random frames [8, 1500,
   768], 32 generated tokens through the bundle's decode graphs (one
   warm-up pass captures); K1 must launch 12 + 12 + 12 times at the
   prefill (the encoder's bidirectional self-attention, the decoder's
   causal self-attention and its cross-attention over the frames), K2
   24 times per decode step (the self cache, the cross K/V recomputed
   from the encoder's output as the reference does), every decode step
   a replay, bitwise the eager step; encode and prefill seconds, decode
   ms per replayed step beside the step's bound, tok/s, peak memory.
18. ``parity_whisper`` – the served batch teacher-forced with the kernels
   and with the plain versions: in bf16 at full depth (the kernel path
   must reproduce the served tokens), in float32 at full width with 2
   encoder and 2 decoder layers (every block's update within 1e-3 of its
   magnitude: the random init's attention scores saturate the softmax,
   see the phase), and the same float32 model with its attention
   projections drawn at 1 / sqrt(d) (logits within 1e-3 of their largest
   magnitude, every greedy token equal).
19. ``train_whisper`` – whisper-small at full width and depth (12 + 12
   layers, 335.7 M parameters) trained as ``train`` below, its decoder
   on train_4k's 4096 tokens a sequence (published whisper's decoder
   holds 448 positions; this repo's places them by rope) and its encoder
   on seeded frames [8, 1500, 768] in bf16 beside each step's tokens
   (``WithFrames``), split into the microbatches with them: per step K1
   288 and its backward 144 (36 attention calls a microbatch: 12
   encoder, 12 decoder self, 12 cross; twice forward under remat),
   nothing else; model FLOPs count the parameters that act on the frames
   over the frames (``encdec_train_flops``); frames/s beside tokens/s.
20. ``parity_train_whisper`` – ``parity_train`` for whisper with its
   frames, on the init with the attention projections at 1 / sqrt(d) (the
   random init saturates the encoder's softmax: H25): float32 at 12 + 12
   layers, bf16 at 12 + 12, the reference init's bf16 reading reported; a
   second kernel run bitwise; the Trainer drill at SMOKE whisper with its
   frames.
21. ``train`` – qwen3-1.7b (28 layers, d 2048, 16 / 8 heads of 128, vocab
   151936, tied embeddings, 1.72 B parameters) at full width and depth,
   after whisper's are freed, trained through the port's
   ``make_train_step`` with the reference's ``AdamWConfig()``: bf16
   compute over float32 masters, bf16 moments, remat, sequences of 4096
   (train_4k), 8 per step (cut from 256) in microbatches of 2 (cut from
   16; the line's ``reduced`` says so).  One warm-up step, then 4 steps:
   finite losses, the last below the first; K1's forward launches 28 x 4
   x 2 and its backward 28 x 4 times per step (remat runs each block's
   forward again in the backward), nothing else launches; step seconds,
   tokens/s, model FLOPs per second against 989 TFLOP/s, peak memory, and
   a digest of the final parameters and state (``state_digest``: each
   leaf's bits as integers, summed with position weights on the card).
22. ``parity_train`` – one microbatch's loss and gradients with K1 and
   its backward against autograd through the plain version: in float32
   at full width with 2 layers (the loss within 1e-5, every gradient
   leaf within 1e-3 of its largest magnitude) and in bf16 over float32
   masters at full depth (the loss and the global gradient norm within
   stated bars); a second kernel run whose gradients must be the first's
   bit for bit; then the ``Trainer`` on the card at SMOKE size: a run
   that fails at step 3, a restart whose restored parameters and moments
   equal the saved ones bit for bit and whose losses equal an
   uninterrupted run's.
23. ``train_graph`` – the train step as one captured CUDA graph
   (``training/graphs.py`` ``CapturedTrainStep``, the reference's jitted
   step): whisper-small (run right after ``parity_train_whisper``, before
   the dryrun phase's pricing child starts) and qwen3-1.7b at full size as
   ``train_whisper`` and ``train`` run them, the wrapper's first call on
   batch 0 (an eager step, then the capture) and 4 replays: the losses
   and the final digest must equal the eager phase's bit for bit, the
   launches, counted through the replays, ``train_launches``' prediction;
   step seconds, tok/s (frames/s), the capture's seconds, the peak above
   what was resident against the eager phase's.  Then granite (2 layers),
   gemma3 (6: five local, one global), deepseek (its dense layer), rwkv6
   (2) and zamba2 (6: one site of its shared attention) at full width, 4
   sequences of 4096 tokens a step in microbatches of 2: three eager
   steps and the wrapper's first call and two replays from the same
   seeded state, bitwise equal (``reduced`` names each cut).  With
   ``--profile`` one more replayed step of whisper and qwen3 traced.
24. ``train_moe`` – granite-moe-3b-a800m (d 1536, 24 / 8 heads of 64, 40
   experts top 8 of d_expert 512, vocab 49155, untied) at full width,
   its depth cut from 32 to 24 layers (``reduced`` says so, with the
   measured peak), after qwen3's are freed, trained as ``train`` (capacity
   1024 a sample, so 2048 rows an expert in a microbatch: K3's 128-row
   tile): per step K1 192, its backward 96, K3's forward 576 (three a
   layer and microbatch, twice under remat), its dX and dW kernels 288
   each, nothing else; model FLOPs counted on the active parameters (the
   routed experts' at top_k / num_experts).
25. ``parity_train_moe`` – ``parity_train`` for granite, K3 and its
   gradients among the kernels, the plain run held to the kernel run's
   routing in call order (remat routes twice a layer; the recompute must
   choose the forward's experts): float32 at full width with 2 layers,
   bf16 at 24; a second kernel run bitwise; the Trainer drill at SMOKE
   granite.
26. ``train_gemma3`` – gemma3-4b (d 2560, 8 / 4 heads of 256, d_ff 10240,
   vocab 262144, tied; a sliding window of 1024 on 5 of every 6 layers)
   at full width, its depth cut from 34 to 18 layers (15 local, 3 global;
   ``reduced`` says so, with the measured peak), after granite's are
   freed, trained as ``train``: per step K1 144 and its backward 72 (the
   column-split kernel at D = 256), 60 of them under the window, nothing
   else; model FLOPs count each local layer's attention over its window's
   pairs.
27. ``parity_train_gemma3`` – ``parity_train`` for gemma3: float32 at full
   width with its first 6 layers (5 local, 1 global), bf16 at 18; a
   second kernel run bitwise; the Trainer drill at SMOKE gemma3 with head
   dim 256 and a window of 128 over its 512 tokens.
28. ``train_deepseek`` – deepseek-v2-236b (d 5120, 128 heads of multi-head
   latent attention: query rank 1536, latent rank 512, query / key head
   dim 128 + 64, value head dim 128; vocab 102400, untied; dense d_ff
   12288) at full width, its depth cut from 60 to its dense first layer
   (``reduced`` says so, with the measured peak and what two layers would
   need), after gemma3's are freed, trained as ``train``: per step K1 8
   and its backward 4 (the kv-split kernel at (D, Dv) = (192, 128)),
   nothing else; model FLOPs count attention at 6 (D + Dv) a head and
   pair.
29. ``parity_train_deepseek`` – ``parity_train`` for deepseek at its one
   layer, float32 and bf16, on sequences of 2048 tokens (the plain
   attention's float32 score tensors over 128 heads would not fit at
   4096); a second kernel run bitwise; the Trainer drill at SMOKE deepseek
   with the published latent attention's head dims (its dense layer and
   two MoE layers: K1's backward at (192, 128) beside K3 and its
   gradients).
30. ``train_rwkv`` – rwkv6-3b (d 2560, 40 heads of 64, d_ff 8960, vocab
   65536, untied; 3.07 B parameters) at full width and depth (32 layers,
   under expandable segments; the line prints the depth and the peak),
   after deepseek's are freed, trained as ``train``: per step K5 256 (32
   layers x 4 microbatches, twice under remat) and K5b 512 (its four
   launches once a layer and microbatch), nothing else; model FLOPs count
   the WKV scan at three times ``rwkv_flops`` a layer.
31. ``parity_train_rwkv`` – ``parity_train`` for rwkv6 with K5 and K5b
   against the plain forward with the plain backward (``TRAIN_PLAIN``),
   on sequences of 1024 tokens (the plain scan runs one step per token):
   float32 at its first 8 layers (RWKV_F32_LAYERS; 32 before the run's
   budget cut it, ROADMAP H7); bf16 at 32 layers reported
   against TRAIN_BARS and held to them at RWKV_BF16_GATE_LAYERS (ROADMAP
   H30); a second kernel run bitwise at 32 layers; the Trainer drill at
   SMOKE rwkv6 (K5b at D = 16, chunk 4).
32. ``train_zamba2`` – zamba2-2.7b (54 Mamba2 layers of 80 heads of 64,
   state 64, chunk 128; one shared attention block of 32 heads of 80 at 9
   sites; d 2560, vocab 32000, untied) at full width and depth, under
   expandable segments, after rwkv6's are freed, trained as ``train``:
   per step K4 432 (54 layers x 4 microbatches, twice under remat), K4b
   864 (its four launches once a layer and microbatch), K1 36 and its
   backward 36 (the shared block, once a site and microbatch: remat does
   not recompute it), nothing else; model FLOPs count attention at the 9
   sites and the SSD scan at three times ``mamba_flops`` a layer; the
   parameters are counted from the tree.
33. ``parity_train_zamba2`` – ``parity_train`` for zamba2 with K4, K4b, K1
   and its backward against the plain forward with the plain backward of
   the scan (``TRAIN_PLAIN``) and autograd through the plain attention, on
   sequences of 512 tokens, with the attention projections at 1 / sqrt(d)
   (at the reference init the saturated shared attention makes the model
   chaotic at depth: ROADMAP H32): float32 at 18 layers, three sites of
   the shared block (ZAMBA2_F32_LAYERS; 54 before H7's cut); bf16 held to
   TRAIN_BARS at ZAMBA2_BF16_GATE_LAYERS (the first attention site), the
   reference init's bf16 reading there reported; bf16 at 54 layers run
   twice through the kernels, bitwise; the Trainer drill at SMOKE zamba2
   (K4b at (P, N) = (16, 8), chunk 4).  ``tools/kernel_probe.py
   mamba2-parity-split`` splits the reference init's bf16 reading between
   K4 and K4b.
34. ``dryrun`` – the meta-device dry run (``launch/dryrun.py``) held to the
   card: each train phase's exact configuration (its depth cut, 8 x 4096
   tokens in microbatches of 2, the whole step with AdamW) priced on a
   (1, 1) mesh by ``price_dryrun`` through ``launch.dryrun.price_cell``,
   in a one-thread child process on the CPU started before qwen3's
   train phase; its float32 masters and AdamW state must equal the state
   the phase built at every leaf in shape, dtype and bytes, and its
   priced total (the number the dry run's table prints) must lie within
   DRYRUN_TOL (10 %) of the phase's ``max_memory_allocated`` above what
   was allocated before the phase built its state; the same check for
   one qwen3-1.7b prefill of [8, 512] into a 512-row cache, measured
   here.  Each case prints both figures and the five largest storages
   live at the priced peak; the phase names the phases the pricing
   process overlapped.

The ``kernels`` phase also holds K1 with ``q_offset`` (query row i at
position q_offset + i) against its plain version: q [2, 512, 8, D] over
k, v [2, 1536, 2, D], at q_offset 0, Sk - Sq and Sq / 2, causal and under
a window of 1024, in both types, at D 64, 128 and 256 and at (192, 128);
and ``flash_attention_sp`` at 2 and 4 lanes against one K1 call at
qwen3's served shape and gemma3's (local and global), which must launch
once a lane, with whether the two are bitwise equal.  It also holds K1 and K2 at gemma3's head dim 256 and
prompt 2048 against their plain versions, timed: K1 on a local layer
(window 1024; the library call with a sliding mask) and a global one, K2
on a global cache of 2080 rows and a local ring of 1024; and K1 at
deepseek's prefill (q, k [8, 512, 128, 192], v [8, 512, 128, 128]; SDPA
beside it, whose flash backend takes the value head dim unlike the
query's; each K1 row names the backend SDPA took), K3 at deepseek's 160
experts, prefill and decode, and K1 and K2 at whisper's shapes: K1 on
the encoder (q, k, v [8, 1500, 12, 64], non-causal), the cross-attention
prefill (q [8, 224, 12, 64] over k, v [8, 1500, 12, 64]) and the
decoder's causal prefill ([8, 224, 12, 64]); K2 on the self cache
([8, 256, 12, 64], a device length) and the cross K/V ([8, 1500, 12, 64],
the int length 1500 a decode step passes); K1 and K2 at qwen1.5-4b's
served shapes (q, k, v [8, 512, 20, 128], causal, G = 1; its cache [8,
544, 20, 128]) and llava's at llava_image's prompt (q [8, 1024, 32, 128]
over k, v [8, 1024, 8, 128]; its cache [8, 1056, 8, 128]), timed in bf16
and held in float32.  And K1's backward
(``csrc/flash_attention_bwd.cu``) against its plain version, relative to
each gradient's largest magnitude (2e-5 float32, 2e-2 bf16): a sweep over
every head dim it takes, both types, the masks and ragged lengths, and,
timed beside the backward of SDPA, qwen3's training shape (q [2, 4096,
16, 128], k, v [2, 4096, 8, 128], causal) and its served prefill
([8, 512, 16, 128]), each called twice, which must give the same bits (the
wgmma kernel sums dq in a fixed order), with granite's training shape
(q [2, 4096, 24, 64], k, v [2, 4096, 8, 64]) beside them, and gemma3's
(q [2, 4096, 8, 256], k, v [2, 4096, 4, 256], causal), a local layer
(window 1024, beside SDPA's backward with the sliding mask) and a global
one, timed in bf16, called twice for the same bits, and held in float32;
and deepseek-v2's (q, k [2, 4096, 128, 192], v [2, 4096, 128, 128],
causal), timed in bf16 beside SDPA's backward, called twice for the same
bits and held to the plain version 16 heads at a time (G = 1, so each
head's gradients depend on its own head alone), and in float32 on 16 of
its heads.  And K3's
gradients against their plain versions (1e-5 / 3e-2 relative): dX (K3's
kernel reading w K-major) and dW (``csrc/moe_gemm_bwd.cu``) over a sweep
in both types (ragged C, D and F, C of one, the strided dispatch view,
deepseek's 160 experts of 5120 / 1536 with few rows), and, timed beside a
batched ``torch.matmul`` on contiguous [E, B*C, .] operands and called
twice for the same bits, at granite's training shapes: dX of the gate /
up projection (dy [2, 40, 1024, 512], w [40, 1536, 512]) and of the down
(dy [2, 40, 1024, 1536], w [40, 512, 1536]), dW of both (x [2, 40, 1024,
1536] with dy [.., 512]; x [.., 512] with dy [.., 1536]).  And K5 at
rwkv6-3b's training microbatch ([2, 4096, 40, 64], float32 out, timed),
and K5's backward, K5b (``csrc/rwkv6_scan_bwd.cu``), against
``rwkv6_scan_bwd_ref``, each gradient relative to its largest magnitude
(1e-4, dw 1e-3, bf16 dr / dk / dv 1e-2): at that shape as the model
calls it (bf16, no initial state, no final cotangent), timed and called
twice for the same bits, and at the served prefill's shape ([8, 512, 40,
64], with both), timed; each also in float32 and under strong decay (w =
1e-6) with an initial state and a final cotangent.  And K4 at zamba2-2.7b's
training microbatch ([2, 4096, 80, 64], bf16 column slices, float32 out,
timed), and K4's backward, K4b (``csrc/mamba2_scan_bwd.cu``), against
``mamba2_scan_bwd_ref``, each gradient relative to its largest magnitude
(1e-4, ddt and da_log 1e-3, bf16 dxh / db / dc 1e-2): at that shape as
the model calls it (bf16 column slices, no initial state, no final
cotangent), timed and called twice for the same bits, and at the served
prefill's shape ([8, 512, 80, 64], with both), timed; each also in float32
and under strong decay (dt a = -148 a step) with both.  And K1's backward
at zamba2's shared attention block's training shape (q, k, v [2, 4096,
32, 80], causal), timed in bf16 beside SDPA's backward and called twice
for the same bits.  And K1's backward at whisper-small's training shapes
(12 heads of 64, G = 1, microbatch 2): the encoder's bidirectional
self-attention over its 1500 frames, the decoder's causal self-attention
over 4096 tokens and its cross-attention (q [2, 4096, 12, 64] over k, v
[2, 1500, 12, 64], non-causal), timed in bf16 beside SDPA's backward,
called twice for the same bits, and held in float32.

Then one line ``{"kernels": [...]}`` with every kernel's numbers (its
``design``: ``wgmma`` for K3's, its gradients' and K1's backward's,
``mma.sync`` for K1's, K2's, K4's, K4b's, K5's and K5b's bf16 paths, which
the main path takes; K3's decode shape beside its prefill row, K2's
wrapper host time, K2's and K5's device kernels per call, and the device
time of each of the scans' backwards' four kernels), a ``total`` line
(with the seconds of the qwen1.5 / llava phases, the two whisper phases,
whisper's two train phases and all the train phases, the rwkv6 pair's and
the zamba2 pair's apart, and the seconds from the start
at which each phase line was printed), the nvidia-smi line, and
last ``{"ok": true,
"device": {...}}``.  There is no
CPU mode: without a CUDA device the script exits with code 1.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# device times (``device_time``): one profiler session of WINDOWS calls,
# each between two fence kernels of FENCE_CYCLES, then TAIL_FENCES more
# (a trace can hold back its last records: they fall on these); at most
# SESSIONS sessions until one holds a whole window
WINDOWS, TAIL_FENCES, FENCE_CYCLES, SESSIONS = 8, 8, 10_000, 3
FENCE_KERNEL = "spin_kernel"             # torch.cuda._sleep's
# the host's runtime and driver calls that queue work on the card: each
# has a device record of its correlation id
HOST_QUEUE_CALLS = ("LaunchKernel", "LaunchCooperativeKernel", "Memcpy",
                    "Memset")
# device kernels one counted launch of a wrapper runs, where not one: K1's
# backward in bf16 (the timed rows' type) its prep, main and dq kernels
# (csrc/flash_attention_bwd.cu, launch_bwd_passes); K4b's and K5b's
# wrappers count each of their kernels
KERNELS_A_LAUNCH = {"flash_attention_bwd": 3}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 logits of magnitude ~4 resolve to 2**-6; two runs whose attention
# outputs round differently drift by a few such steps over the layers.
# About twice the 0.047 measured on an H100 at these shapes.
PARITY_LOGIT_TOL = 0.1
PROMPT_LEN, GEN_LEN, NUM_QUERIES, N_DEVICES = 512, 32, 8, 2
# control_plane: the measured serves' (prompt, generated, queries), each
# under FATE and RoundRobin on the first serve phase's bundles; prompt and
# output lengths and the queries vary, so that the fit can tell base,
# prefill, decode and switch apart
CONTROL_RUNS = ((128, 8, 8), (512, 32, 8), (1024, 16, 4))
CONTROL_POLICIES = ("FATE", "RoundRobin")
# wall seconds on the card to one proxy second of the planner: the fitted
# profile prices stages in the card's own measured seconds
CONTROL_TIME_SCALE = 1.0
# the gateway's trace (explicit arrivals) and its cluster
CONTROL_GATEWAY_WORKFLOWS, CONTROL_GATEWAY_DEVICES = 6, 4
# gemma3's phase serves a prompt of twice its sliding window (1024), so
# that the window binds in K1 and the local layers' rings wrap
GEMMA_PROMPT_LEN = 2048
# gemma3 at full width, cut to its first global layer (5 local, 1 global)
# for the float32 parity
GEMMA_F32_LAYERS = 6
# deepseek-v2-236b at full width: 236 B parameters do not fit the card, so
# its depth is cut to the dense first layer, as published, and 5 MoE
# layers (21.25 B parameters, 42.5 GB in bf16); its float32 parity to the
# dense layer and one MoE layer (about 21 GB)
DEEPSEEK_LAYERS, DEEPSEEK_F32_LAYERS = 6, 2
# whisper-small's decoder prompt: its previous-text prompt holds at most
# 223 tokens and the start token (n_text_ctx 448); its float32 parity at
# full width with 2 encoder and 2 decoder layers
WHISPER_PROMPT_LEN, WHISPER_F32_LAYERS = 224, 2
# train_whisper: published whisper's decoder holds 448 positions (learned
# embeddings); this repo's model places them by rope, and the reference's
# train cell (train_4k) gives its decoder 4096 tokens, which the phase keeps
WHISPER_TRAIN_POSITIONS = ("4096 (train_4k): published whisper's decoder "
                           "holds 448 learned positions, this repo's model "
                           "uses rope and the reference's train cell 4096 "
                           "tokens")
# llava_image: the prompt whose first num_patches (576) positions the image
# embeddings replace, and 448 positions of text after them
LLAVA_PROMPT_LEN = 1024
# K1's backward, relative to each gradient's largest magnitude: float32 FMA
# sums in another order; bf16 p and ds rounded as product operands (the
# plain version keeps them float32) and rounded outputs
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K1's backward sweep: (B, Sq, Sk, H, KV), every (D, Dv) pair of
# _build.FLASH_HEAD_DIMS, the FLASH_MODES masks: a ragged tile,
# whisper's 1500 frames (23 x 64 + 28), Sq != Sk at G = 16, and B = 2 with
# Sq > Sk, both ragged, G = 2 (every query row keeps a key under the window)
BWD_SWEEP = [(1, 200, 200, 4, 2), (1, 1500, 1500, 2, 1), (1, 70, 200, 16, 1),
             (2, 250, 190, 8, 4)]
# the train phase: qwen3-1.7b at full width and depth at train_4k's
# sequence, its global batch cut from 256 to 8 and its microbatch from 16
# to 2 (resolve_microbatch has none at global batch 8 under 16: ROADMAP
# H26), so 4 accumulation steps; one warm-up step, then TRAIN_STEPS
TRAIN_GLOBAL_BATCH, TRAIN_MICROBATCH, TRAIN_STEPS = 8, 2, 4
# parity_train: float32 at full width with 2 layers, one microbatch (the
# loss to 1e-5 relative, each gradient leaf to 1e-3 of its largest
# magnitude); bf16 at full depth (the loss and the global gradient norm,
# relative, and each gradient leaf relative to its largest magnitude: the
# bf16 forward rounds p for P V and the backward recomputes p in float32,
# H19, over 28 layers).  The bf16 bars are about 4x the largest readings
# on an H100 over seeds 0-2: 2.0e-5, 1.28e-4 and 8.4e-3 (wq, k_norm)
TRAIN_F32_LAYERS, TRAIN_F32_LOSS_REL, TRAIN_F32_GRAD_REL = 2, 1e-5, 1e-3
# (loss, global norm, leaf) bars of the bf16 parity at the train depth.
# granite's, stated before its first run: qwen3's loss bar, twice its
# norm bar and 5/3 of its leaf bar, since K3's gradients round dX and dW
# to bf16 in every layer, beside K1's and its backward's roundings
# gemma3's, stated before its first run: granite's, since K1's backward
# at D = 256 sums its products over twice qwen3's columns and rounds p^T
# and ds^T to bf16 in every layer, under the window on 15 of 18 layers
# deepseek's, stated before its first run: gemma3's, since K1's backward
# at (192, 128) rounds p^T and ds^T to bf16 over 2.5x qwen3's columns a
# pair, with 128 heads summed into wo's gradient, and its one layer keeps
# the MLA projections' roundings beside K1's
# whisper's, stated before its first run: qwen3's, since its kernels are
# K1 and its backward alone, as qwen3's (at D = 64, G = 1, in 36 attention
# calls: 12 bidirectional over the frames, 12 causal, 12 cross)
# rwkv6's, stated before its first run: granite's, since K5's bf16
# forward splits its float32 factors into two bf16 terms (16 bits) where
# the plain forward keeps float32, in each of 32 layers, while K5b's first
# design worked in float32 and rounded dr, dk, dv to bf16 as the plain
# backward does (its bf16 per-chunk products now split their float32
# factors as K5's forward does; the bars are unchanged).  At 32 layers
# they did not hold (RWKV_BF16_GATE_LAYERS says where they gate)
TRAIN_BARS = {"parity_train": (1e-4, 5e-4, 3e-2),
              "parity_train_moe": (1e-4, 1e-3, 5e-2),
              "parity_train_gemma3": (1e-4, 1e-3, 5e-2),
              "parity_train_deepseek": (1e-4, 1e-3, 5e-2),
              "parity_train_rwkv": (1e-4, 1e-3, 5e-2),
              "parity_train_zamba2": (1e-4, 1e-3, 5e-2),
              "parity_train_whisper": (1e-4, 5e-4, 3e-2)}
# train_moe: granite-moe-3b-a800m at full width, its depth cut from 32 to
# 24 layers (2.63 B parameters): float32 masters, their gradient sums, bf16
# copies and moments take about 22 bytes a parameter (qwen3's 50.55 GB
# peak at 1.72 B), so 32 layers (3.45 B) would not fit the card's 80 GB
MOE_TRAIN_LAYERS = 24
# train_gemma3: gemma3-4b at full width, its depth cut from 34 to 18
# layers (15 local, 3 global: the deepest multiple of its 6-layer pattern
# that fits; 2.37 B parameters): at qwen3's and granite's 18-24 bytes a
# parameter and about 26 GB for a microbatch's 2 x 4096 x 262144 logits,
# 34 layers (3.88 B) would take about 100 GB.  Its float32 parity at
# GEMMA_F32_LAYERS (5 local, 1 global)
GEMMA_TRAIN_LAYERS = 18
# train_deepseek: deepseek-v2-236b at full width, its depth cut from 60 to
# its dense first layer (1.387 B parameters; ArchConfig.param_count's
# 1.575 B counts the layer's FFN twice): a second layer is an MoE layer of
# 3.97 B parameters (3.77 B in its 160 routed experts), and at about 22
# bytes a parameter its 5.359 B would need about 118 GB.  Its parity
# at that depth in both types, on a microbatch of DEEPSEEK_PARITY_SEQ
# tokens a sequence: the plain attention keeps float32 [2, 128, S, S]
# tensors (scores, masked scores, p, and dp, ds in the backward: 17.2 GB
# each at 4096, 86 GB, more than the card), 4.3 GB each at 2048
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_PARITY_SEQ = 1, 2048
# train_rwkv: rwkv6-3b at full width and depth (32 layers, 3.07 B
# parameters counted from the tree; about 22 bytes a parameter, 67.6 GB, was
# the estimate beside a microbatch's [2, 4096, 65536] logits and their
# gradient, 32 remat checkpoints of 42 MB and K5b's two [2, 40, 128, 64,
# 64] float32 buffers of 168 MB and its decay factors' [2, 40, 128, 64]
# of 2.6 MB; 64.6 GB measured).  Its parity on a
# microbatch of RWKV_PARITY_SEQ tokens a sequence: the plain forward is a
# loop of one step per token and the plain backward two more (about 150
# thousand launches a layer at 4096 tokens, 32 layers and remat's
# recompute in the bf16 run)
RWKV_PARITY_SEQ = 1024
# the float32 parities of rwkv6 and zamba2 cut in depth to keep the card's
# run under two thirds of its 900 s (ROADMAP H7): their plain scans run one
# step a token; rwkv6's to its first 8 layers, zamba2's to its first three
# sites of the shared attention block, 18 layers (each phase line's
# ``reduced``)
RWKV_F32_LAYERS, ZAMBA2_F32_LAYERS = 8, 18
# rwkv6's parity in float32 at the train depth, and its bf16 bars gated at
# RWKV_BF16_GATE_LAYERS (ROADMAP H30): at the reference init the two bf16
# runs drift apart with depth.  On an NVIDIA H100 80GB HBM3 at 700 W
# (parity_train_rwkv, seed 0): float32 at 32 layers 2.8e-5 of the worst
# leaf; bf16 at 2 layers 2.2e-2, at 32 layers 0.172 with the losses 1.46e-4
# apart, which the bars stated before the first run (TRAIN_BARS) do not
# hold.  tools/kernel_probe.py rwkv6-parity-split puts that on K5's bf16
# forward (its two-term products beside the plain float32 forward): at 32
# layers K5 alone 0.247 of the worst leaf, K5b alone 0.032 (on another
# microbatch).  The train depth's reading is reported beside the gate
RWKV_BF16_GATE_LAYERS = 2
# train_zamba2: zamba2-2.7b at full width and depth (54 Mamba2 layers, the
# shared attention block at 9 sites; about 2.42 B parameters counted from
# the tree, at about 22 bytes a parameter 53 GB, beside a microbatch's
# [2, 4096, 32000] logits, 54 remat checkpoints of 42 MB and the shared
# block's activations at its 9 sites, which remat does not recompute: 60-65
# GB predicted; PERF.md has the measured peak).  Its parity, stated before
# its first run: float32 at the full depth of 54 layers; bf16 held to
# TRAIN_BARS at ZAMBA2_BF16_GATE_LAYERS, the first attention site: K4's
# bf16 forward splits its float32 factors into two bf16 terms where the
# plain forward keeps float32 (H21), the form that made rwkv6's 32-layer
# bf16 reading drift beyond these bars (H30), and parity_hybrid already
# gates zamba2's bf16 served model block by block.  At the reference init
# neither held (ROADMAP H32): its shared attention has no q / k norm and
# saturates, as granite's does (H25), and the model amplifies any
# difference with depth.  tools/kernel_probe.py mamba2-parity-split puts
# the bf16 reading at 6 layers on K4's bf16 forward; K4b's share alone
# holds the bar.  With the attention projections at 1 / sqrt(d) both gates
# hold, so they take that init, as parity_train_moe's does, and the
# reference init is read in bf16 at the gate depth and reported; bf16 at
# 54 layers runs through the kernels alone (twice, bitwise).  Sequences of
# ZAMBA2_PARITY_SEQ tokens: the plain scan runs one step a token forward,
# again in remat's recompute, and back
ZAMBA2_PARITY_SEQ, ZAMBA2_BF16_GATE_LAYERS = 512, 6
# the Trainer drill's SMOKE config changed where the card path needs it:
# gemma3 at its published head dim, so that the drill runs K1's backward
# at D = 256, with a window shorter than its 512 tokens; deepseek at its
# published latent attention's head dims, (D, Dv) = (192, 128) (a dict
# value replaces fields of that sub-config)
DRILL_OVER = {"gemma3-4b": dict(head_dim=256, sliding_window=128),
              "deepseek-v2-236b": dict(mla=dict(
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128))}
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}      # relative
SCAN_TOL = 5e-4          # absolute, float32 outputs of the scans
SCAN_BF16_REL = 1e-2     # bf16 outputs: one rounding of the output
# K5b against its plain version, each gradient relative to its largest
# magnitude: float32 sums in another order, and the chunked form's
# exponentials of summed log decays against the plain version's products
# of decays; dw, a quotient by w, 1e-3; bf16 dr, dk, dv rounded once
SCAN_BWD_REL, SCAN_BWD_DW_REL, SCAN_BWD_BF16_REL = 1e-4, 1e-3, 1e-2
SCAN_BWD_LEAVES = ("dr", "dk", "dv", "dw", "dbonus", "dstate0")
# K4b against its plain version, on the same bars: dxh, db, dc and dstate0
# at SCAN_BWD_REL (bf16 dxh, db, dc at SCAN_BWD_BF16_REL, one rounding);
# ddt and da_log, sums over the pairs and the steps, at SCAN_BWD_DW_REL
MAMBA_BWD_LEAVES = ("dxh", "db", "dc", "ddt", "da_log", "dstate0")
# the kernels of one K5b and one K4b call, each launched once, by input
# type: the chunks' contributions, their scan, the per-chunk gradients
# (tensor cores for bf16, FMA for float32), the ordered sums
RWKV_BWD_CALL_KERNELS = {
    dt: ("rwkv6_bwd_local", "rwkv6_bwd_scan", chunk, "rwkv6_bwd_bonus")
    for dt, chunk in ((torch.bfloat16, "rwkv6_bwd_mma"),
                      (torch.float32, "rwkv6_bwd_chunk"))}
MAMBA_BWD_CALL_KERNELS = {
    dt: ("mamba2_bwd_local", "mamba2_bwd_scan", chunk, "mamba2_bwd_sum")
    for dt, chunk in ((torch.bfloat16, "mamba2_bwd_mma"),
                      (torch.float32, "mamba2_bwd_chunk"))}
# float32 parity at full width, cut to this many layers (the hybrid to
# one attention site, after 6 layers, plus a tail layer)
PARITY_F32_LAYERS, PARITY_F32_REL = 4, 1e-3
HYBRID_F32_LAYERS = 7
# bf16 hybrid at full depth: each block's kernel-vs-plain difference on
# the same input, relative to its output (a few bf16 rounding steps)
HYBRID_BF16_BLOCK_REL = 2 ** -6

FLASH_SWEEP = [(1, 128, 128, 4, 2, 64), (2, 256, 256, 4, 4, 32),
               (1, 64, 64, 8, 2, 128), (2, 100, 100, 4, 2, 64)]
FLASH_MODES = [(True, 0), (False, 0), (True, 64)]
# K1's q_offset (a sequence-parallel prefill lane, ROADMAP H2): (b, sq, sk,
# h, kv) with Sq < Sk, at each head-dim pair a model gives K1, causal and
# under gemma3's window of 1024, at q_offset 0, Sk - Sq and Sq / 2
OFFSET_SHAPE = (2, 512, 1536, 8, 2)
OFFSET_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
OFFSET_MODES = ((True, 0), (True, 1024))
SP_LANES = (2, 4)           # flash_attention_sp against one K1 call
DECODE_SWEEP = [512, 300, 17, 1]
MOE_SWEEP = [(4, 96, 160, 192), (2, 128, 64, 64), (8, 40, 100, 70)]
# K3's gradients: (B, or None for [E, C, D]; E, C, D, F) in both types, x
# the strided dispatch view: ragged C, D and F (the element-wise loaders),
# C of one, 128-row tiles, deepseek's 160 experts of d 5120 / d_expert
# 1536 with few rows
MOE_GRAD_SWEEP = [(None, 4, 96, 160, 192), (2, 8, 40, 100, 70),
                  (1, 3, 1, 7, 5), (2, 2, 300, 72, 136),
                  (1, 160, 4, 5120, 1536)]
RWKV_SWEEP = [(64, 16), (96, 32)]
MAMBA_SWEEP = [(64, 16), (128, 32), (32, 32)]     # tests/test_kernels.py
# the bf16 redesigns and the tensor-core instruction each must compile to
TENSOR_CORE_SASS = {"moe_gemm_wgmma_kernel": "HGMMA",
                    "moe_dw_wgmma_kernel": "HGMMA",
                    "moe_grad_tma_kernel": "HGMMA",
                    "flash_mma_kernel": "HMMA",
                    "flash_bwd_wgmma_kernel": "HGMMA",
                    "flash_bwd_colsplit_kernel": "HGMMA",
                    "flash_bwd_kvsplit_kernel": "HGMMA",
                    "decode_mma_kernel": "HMMA",
                    "mamba2_mma_kernel": "HMMA",
                    "rwkv6_mma_kernel": "HMMA",
                    "rwkv6_bwd_mma_kernel": "HMMA",
                    "mamba2_bwd_mma_kernel": "HMMA",
                    "mamba2_bwd_local_mma_kernel": "HMMA"}
# gemma3's head dim, deepseek-v2's (query/key, value) pair, K1's
# backward at qwen3's, granite's, gemma3's and deepseek's head dims, and
# K3's gradients
# (their first design, which operands a tensor map cannot take still run:
# dX on the 128-row tile, vector loader, w K-major; dW on the vector
# loader) and the persistent kernel that takes them at granite's training
# shapes (layout 0 dX, 1 dW; 2, K3's forward, for tools/kernel_probe.py):
# these instantiations must be among them
REQUIRED_SASS = ("flash_mma_kernel<256,256>", "decode_mma_kernel<256>",
                 "flash_mma_kernel<192,128>", "flash_bwd_wgmma_kernel<128>",
                 "flash_bwd_wgmma_kernel<64>",
                 "flash_bwd_colsplit_kernel<256>",
                 "flash_bwd_kvsplit_kernel<192,128>",
                 "moe_gemm_wgmma_kernel<128,1,1>", "moe_dw_wgmma_kernel<1>",
                 "moe_grad_tma_kernel<0>", "moe_grad_tma_kernel<1>",
                 "rwkv6_bwd_mma_kernel<64>", "mamba2_bwd_mma_kernel<64,64>",
                 "mamba2_bwd_local_mma_kernel<64,64>")
# the kernels fed by TMA, and the bulk-copy instructions each must hold
TMA_SASS = {"moe_grad_tma_kernel": ("UTMALDG", "UTMASTG")}
# the source and the launcher of each, whose calls `launcher<...>(a)` are
# its instantiations, and how many instantiations one such call makes
TENSOR_CORE_LAUNCHERS = {
    "moe_gemm_wgmma_kernel": ("moe_gemm.cu", "launch_wgmma", 1),
    "moe_dw_wgmma_kernel": ("moe_gemm_bwd.cu", "launch_dw_wgmma", 1),
    "moe_grad_tma_kernel": ("moe_gemm_grad.cu", "launch_grad", 1),
    "flash_mma_kernel": ("flash_attention.cu", "launch_flash_mma", 1),
    "flash_bwd_wgmma_kernel": ("flash_attention_bwd.cu", "launch_bwd_wgmma",
                               1),
    "flash_bwd_colsplit_kernel": ("flash_attention_bwd.cu",
                                  "launch_bwd_colsplit", 1),
    "flash_bwd_kvsplit_kernel": ("flash_attention_bwd.cu",
                                 "launch_bwd_kvsplit", 1),
    "decode_mma_kernel": ("decode_attention.cu", "launch_decode_mma", 1),
    "mamba2_mma_kernel": ("mamba2_scan.cu", "launch_scan_mma", 1),
    "rwkv6_mma_kernel": ("rwkv6_scan.cu", "launch_scan_mma", 1),
    "rwkv6_bwd_mma_kernel": ("rwkv6_scan_bwd.cu", "launch_chunk_mma", 1),
    "mamba2_bwd_mma_kernel": ("mamba2_scan_bwd.cu", "launch_chunks_mma", 1),
    "mamba2_bwd_local_mma_kernel": ("mamba2_scan_bwd.cu", "launch_states_mma",
                                    1),
}
# the kernel design each wrapper takes in bf16 at the main path's shape
# (the float32 paths of K1-K5 are FMA code)
BF16_DESIGN = {"flash_attention": "mma.sync",
               "flash_attention_bwd": "wgmma", "moe_gemm": "wgmma",
               "moe_gemm_dx": "wgmma+tma persistent",
               "moe_gemm_dw": "wgmma+tma persistent",
               "decode_attention": "mma.sync", "mamba2_scan": "mma.sync",
               "mamba2_scan_bwd": "mma.sync",
               "rwkv6_scan": "mma.sync", "rwkv6_scan_bwd": "mma.sync"}
# K5's bf16 sweep: (head dim, chunk, strong decay, initial state, output
# dtype), the chunk of the SMOKE config (4, one padded sub-chunk) to 64
RWKV_BF16_SWEEP = [(d, chunk, strong, state, out)
                   for d in (16, 32, 64, 128)
                   for chunk, strong, state, out in (
                       (4, False, True, torch.bfloat16),
                       (32, True, False, torch.float32),
                       (64, False, True, torch.float32))]
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
    # no TPU kernel: the reference differentiates K1's XLA twin
    "flash_attention_bwd": "src/repro/models/attention.py:68",
    "decode_attention": "src/repro/kernels/decode_attention.py:58",
    "moe_gemm": "src/repro/kernels/moe_gemm.py:39",
    # no TPU kernel: the reference differentiates the MoE layer's einsums
    # (src/repro/models/moe.py:104-109)
    "moe_gemm_dx": "src/repro/models/moe.py:104",
    "moe_gemm_dw": "src/repro/models/moe.py:104",
    "mamba2_scan": "src/repro/kernels/mamba2_scan.py:66",
    # no TPU kernel: the reference differentiates K4's XLA twin
    "mamba2_scan_bwd": "src/repro/models/ssm.py:62",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:66",
    # no TPU kernel: the reference differentiates K5's XLA twin
    "rwkv6_scan_bwd": "src/repro/models/rwkv.py:56",
}
# the source of each kernel (K3's gradients: the persistent kernel that
# takes them on the main path)
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}
SOURCES["moe_gemm_dx"] = SOURCES["moe_gemm_dw"] = \
    "src/repro_torch/kernels/csrc/moe_gemm_grad.cu"
NO_TPU_KERNEL = {
    "flash_attention_bwd": "no TPU kernel: the reference differentiates "
                           "K1's XLA twin",
    "moe_gemm_dx": "no TPU kernel: the reference differentiates "
                   "src/repro/models/moe.py:104-109",
    "moe_gemm_dw": "no TPU kernel: the reference differentiates "
                   "src/repro/models/moe.py:104-109",
    "mamba2_scan_bwd": "no TPU kernel: the Pallas scan has no backward "
                       "and the reference differentiates its XLA twin, "
                       "src/repro/models/ssm.py:62 (_ssd_chunked)",
    "rwkv6_scan_bwd": "no TPU kernel: the Pallas scan has no backward and "
                      "the reference differentiates its XLA twin, "
                      "src/repro/models/rwkv.py:56 (_wkv_chunked)"}
# the plain version a train parity run swaps in for a wrapper, where it is
# not ``<name>_ref``: K5's plain forward with K5b's plain backward, K4's
# with K4b's
TRAIN_PLAIN = {"rwkv6_scan": "rwkv6_scan_plain",
               "mamba2_scan": "mamba2_scan_plain"}


# seconds from the start of the run at which each phase line was printed
PHASE_END_S: dict = {}
T_START = time.perf_counter()
T_START_WALL = time.time()


def emit(obj: dict) -> None:
    if "phase" in obj:
        PHASE_END_S[obj["phase"]] = time.perf_counter() - T_START
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def randn(rng, shape, dtype):
    """Standard normal values drawn on the card by a ``torch.Generator``:
    ``rng`` itself, or one seeded from the numpy generator ``rng`` (a seed
    a call; drawing on the host was the ``kernels`` phase's largest
    cost)."""
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(device="cuda").manual_seed(
            int(rng.integers(2 ** 62)))
    return torch.randn(shape, generator=rng, device="cuda").to(dtype)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches (CUDA events;
    inputs stay warm in L2, as the serving path finds them)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fenced_windows(records, marks=None) -> list:
    """The windows of one fenced profiler session (``device_time``):
    ``records`` are its (correlation id, name, on the device,
    microseconds).  For each pair of consecutive fence kernels on the
    device, the device records (name, microseconds) whose ids lie between
    the two fences' and whose name holds one of ``marks`` (each one where
    ``marks`` is None); None for a window that is not whole, where the
    host queued a launch, copy or memset between the fences that has no
    device record (a lost fence leaves its own host record in the merged
    window).  Records that a trace delivers late from an earlier session
    have lower ids and fall outside every window.  Every window is None
    where a fence has no host record: the session's host records cannot
    be read."""
    fences = sorted(i for i, name, dev, _ in records
                    if dev and FENCE_KERNEL in name)
    host = {i for i, name, dev, _ in records
            if not dev and any(m in name for m in HOST_QUEUE_CALLS)}
    device = sorted((i, name, us) for i, name, dev, us in records
                    if dev and FENCE_KERNEL not in name)
    if not set(fences) <= host:
        return [None] * max(len(fences) - 1, 0)
    have = {i for i, _, _ in device}
    out = []
    for lo, hi in zip(fences, fences[1:]):
        if any(lo < i < hi and i not in have for i in host):
            out.append(None)
            continue
        out.append([(name, us) for i, name, us in device if lo < i < hi
                    and (marks is None or any(m in name for m in marks))])
    return out


def short_name(kernel: str) -> str:
    """``name<...>`` of "void (anonymous namespace)::name<...>(args)"."""
    return kernel.removeprefix("void ").replace(
        "(anonymous namespace)::", "").split("(")[0].strip()


def device_time(fn, marks=None, wrapper=None) -> dict:
    """Device milliseconds of one call of ``fn`` (torch.profiler, CUDA
    activity): the device's own time, without the host's gaps.  One
    session queues a fence kernel (``torch.cuda._sleep``), then WINDOWS
    times a call and a fence, then TAIL_FENCES more fences; the windows
    between fences are read by ``fenced_windows`` (the kernels whose name
    holds one of ``marks``, every kernel and copy of a library call where
    None).  With ``wrapper`` (the kernel's wrapper in ``ops``) a whole
    window must also hold as many marked kernels as the wrapper counts
    launches in one untraced call of ``fn``, times KERNELS_A_LAUNCH.  Up
    to SESSIONS sessions are run until one holds a whole window.  Returns
    ``ms``, the mean over the whole windows of their sum (None where none
    was whole), ``by_kernel`` (each kernel's short name: its mean) and
    ``windows``, how many were whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n0 = wrapper.launches if wrapper is not None else 0
    fn()
    torch.cuda.synchronize()
    expect = None if wrapper is None else (
        (wrapper.launches - n0) * KERNELS_A_LAUNCH.get(wrapper.__name__, 1))
    whole = []
    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(FENCE_CYCLES)
            for _ in range(WINDOWS):
                fn()
                torch.cuda._sleep(FENCE_CYCLES)
            for _ in range(TAIL_FENCES):
                torch.cuda._sleep(FENCE_CYCLES)
            torch.cuda.synchronize()
        records = [(e.id, e.name,
                    getattr(e, "device_type", None) == DeviceType.CUDA,
                    e.time_range.elapsed_us()) for e in prof.events()]
        whole = [w for w in fenced_windows(records, marks)
                 if w and (expect is None or len(w) == expect)]
        if whole:
            break
    each: dict = {}
    for w in whole:
        for name, us in w:
            key = short_name(name)
            each[key] = each.get(key, 0.0) + us / 1e3 / len(whole)
    return {"ms": sum(each.values()) if whole else None, "by_kernel": each,
            "windows": len(whole)}


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call of ``fn``, calls queued back to back
    and timed before the card catches up."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(byte_count: float, flops: float, dtype) -> tuple[float, str]:
    """Least milliseconds the card could take, and which limit sets it."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device(build_mod) -> tuple[dict, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    nvcc = build_mod.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    build_mod.load()                       # raises if the build fails
    info = {
        "phase": "device", "nvidia_smi": smi_line,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": ver[-2] if len(ver) >= 2 else " ".join(ver),
        "python": sys.version.split()[0],
        "build_seconds": round(build_mod.build_seconds, 2),
        "load_seconds": round(time.perf_counter() - t0, 2),
        "tensor_core_sass": tensor_core_check(build_mod),
        "rwkv6_scan_bwd_ptxas": ptxas_info(build_mod, BWD_SCAN_KERNELS),
        "mamba2_scan_bwd_ptxas": mamba_bwd_ptxas(build_mod),
        "kernel_sources": [str(p.relative_to(Path(__file__).parent))
                           for p in build_mod.sources()],
    }
    emit(info)
    return info, smi_line


def short_kernel_name(mangled: str, kernels=TENSOR_CORE_SASS):
    """``moe_gemm_wgmma_kernel<128,1>`` (``rwkv6_mma_kernel<64,float>``
    where a template argument is a type) for a mangled instantiation of
    one of ``kernels``, None for any other function."""
    import re
    token = re.compile(r"L[ib](\d+)E|(f)|\d+(__nv_bfloat16)")
    for kern in kernels:
        m = re.search(kern + r"I(.+?)EEv", mangled)
        if m:
            args = [n or ("float" if f else "bf16")
                    for n, f, _ in token.findall(m.group(1))]
            return f"{kern}<{','.join(args)}>"
    return None


# K5b's templated kernels: the chunks' contributions to the chunk-end
# states <D, T>, their scan <D>, the float32 per-chunk kernel <D> (FMA
# code) and the bf16 one <D> (mma.sync, also in TENSOR_CORE_SASS)
BWD_SCAN_KERNELS = ("rwkv6_bwd_local_kernel", "rwkv6_bwd_scan_kernel",
                    "rwkv6_bwd_chunk_kernel", "rwkv6_bwd_mma_kernel")


def sass_text(build_mod) -> str:
    """The library's SASS, read once a process: cuobjdump -sass of each
    of the build's objects, all started together (a dump of the whole
    library runs on one core), joined in the objects' order."""
    global _SASS
    if _SASS is None:
        lib = build_mod.build()
        cuobjdump = Path(build_mod.find_nvcc()).with_name("cuobjdump")
        objs = sorted(lib.parent.glob("*.o"))
        if not objs:
            fail(f"no objects beside {lib}")
        # each dump into a file of its own, so that none waits on a pipe
        outs = [tempfile.TemporaryFile(mode="w+") for _ in objs]
        procs = [subprocess.Popen([str(cuobjdump), "-sass", str(obj)],
                                  stdout=out, stderr=subprocess.STDOUT,
                                  text=True)
                 for obj, out in zip(objs, outs)]
        texts = []
        for proc, out in zip(procs, outs):
            rc = proc.wait(timeout=300)
            out.seek(0)
            texts.append(out.read())
            out.close()
            if rc != 0:
                fail(f"cuobjdump failed: {texts[-1].strip()[:500]}")
        _SASS = "\n".join(texts)
    return _SASS


_SASS = None


def atomic_instructions(sass: str, kernels) -> dict:
    """Per instantiation of ``kernels``, its atomic and reduce
    instructions in the SASS (ATOM*, RED, REDG, REDAS, bulk reduces; not
    REDUX, a warp's own sum): none is expected, as K5b sums in fixed
    orders."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = short_kernel_name(line, kernels)
            continue
        if cur is None or "*/" not in line:
            continue
        text = line.split("*/", 1)[1].split(";")[0].strip()
        if not text:
            continue
        words = text.split()
        op = words[1] if words[0].startswith("@") and len(words) > 1 \
            else words[0]
        base = op.split(".")[0]
        if base.startswith("ATOM") or base in ("RED", "REDG", "REDAS") \
                or "BLKRED" in base:
            out.setdefault(cur, []).append(" ".join(words))
    return out


def ptxas_info(build_mod, kernels) -> dict:
    """Registers and spill bytes (the build's ptxas -v log) of every
    instantiation of ``kernels`` (K5b's), the dynamic shared memory of
    K5b's per-chunk kernels (bf16 and float32) at rwkv6-3b's head dim and
    chunk, and the atomic or reduce instructions in their SASS, none of
    which may be there."""
    from repro_torch.kernels import rwkv6_scan as rs_mod
    out = ptxas_table(build_mod, kernels)
    # the contributions in both types, the scan and both per-chunk kernels
    # at every head dim
    if len(out) != 5 * len(rs_mod.HEAD_DIMS):
        fail(f"K5b's instantiations in the ptxas log: {sorted(out)}")
    atomics = atomic_instructions(sass_text(build_mod), kernels)
    if atomics:
        fail(f"atomic or reduce instructions in K5b's kernels: "
             f"{ {k: v[:3] for k, v in atomics.items()} }")
    return {"kernels": out, "atomic_instructions": 0,
            "mma_kernel_smem_bytes_d64_l32": rs_mod.bwd_smem_bytes(64, 32),
            "fma_kernel_smem_bytes_d64_l32": rs_mod.bwd_smem_bytes(
                64, 32, torch.float32)}


def ptxas_table(build_mod, kernels) -> dict:
    """Registers and spill bytes of every instantiation of ``kernels`` in
    the build's ptxas -v log."""
    import re
    log = (build_mod.build().parent / "build.log").read_text()
    out, cur = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            cur = short_kernel_name(line, kernels)
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in line:
            out[cur]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif cur and "registers" in line:
            out[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


# K4b's templated kernels: the chunks' contributions to the chunk-end
# states (FMA <T, P, N> for float32 and for bf16 at (16, 8); mma.sync <P, N>
# for bf16 at (64, 64)), their scan <P, N>, the per-chunk kernels (FMA
# <T, P, N>; mma.sync <P, N> for bf16 at (64, 64)) and the ordered sums <T>;
# the mma.sync ones are also in TENSOR_CORE_SASS
MAMBA_BWD_KERNELS = ("mamba2_bwd_local_kernel", "mamba2_bwd_local_mma_kernel",
                     "mamba2_bwd_scan_kernel", "mamba2_bwd_chunk_kernel",
                     "mamba2_bwd_mma_kernel", "mamba2_bwd_sum_kernel")
# their instantiations: the FMA contributions in float32 at both (P, N)
# pairs and in bf16 at (16, 8), the mma.sync ones at (64, 64), the scan at
# both pairs, the FMA per-chunk kernel in both types at both pairs, the
# mma.sync one at (64, 64), the sums in both types
MAMBA_BWD_INSTANTIATIONS = 3 + 1 + 2 + 4 + 1 + 2


def mamba_bwd_ptxas(build_mod) -> dict:
    """Registers and spill bytes of every instantiation of K4b's kernels
    (MAMBA_BWD_INSTANTIATIONS), the per-chunk kernels' dynamic shared
    memory at zamba2's dims, and the
    atomic or reduce instructions in their SASS, none of which may be
    there."""
    from repro_torch.kernels import mamba2_scan as ms_mod
    out = ptxas_table(build_mod, MAMBA_BWD_KERNELS)
    if len(out) != MAMBA_BWD_INSTANTIATIONS:
        fail(f"K4b's instantiations in the ptxas log: {sorted(out)}")
    atomics = atomic_instructions(sass_text(build_mod), MAMBA_BWD_KERNELS)
    if atomics:
        fail(f"atomic or reduce instructions in K4b's kernels: "
             f"{ {k: v[:3] for k, v in atomics.items()} }")
    return {"kernels": out, "atomic_instructions": 0,
            "mma_kernel_smem_bytes_p64_n64": ms_mod.bwd_smem_bytes(64, 64),
            "fma_kernel_smem_bytes_p64_n64": ms_mod.bwd_smem_bytes(
                64, 64, torch.float32)}


def expected_instantiations(build_mod) -> int:
    """How many instantiations of TENSOR_CORE_SASS's kernels the sources
    launch: the distinct template arguments of each launcher's calls."""
    import re
    n = 0
    for src, launcher, per_call in TENSOR_CORE_LAUNCHERS.values():
        text = (Path(build_mod.CSRC) / src).read_text()
        n += per_call * len(set(re.findall(launcher + r"<([^>]+)>\(a\)",
                                           text)))
    return n


def tensor_core_check(build_mod) -> dict:
    """Per instantiation of the bf16 redesigns: the count of its
    tensor-core instruction in the library's SASS and one such line (and,
    for TMA_SASS's kernels, the count of each of their bulk copies, none
    of which may be missing), and its registers and spill bytes from the
    build's ptxas -v log.  Every
    bulk reduce in the SASS must add float32 (K1's backward sums dq with
    ``cp.reduce.async.bulk .add.f32``; ptxas 12.9 compiled it to a 64-bit
    integer add in one instantiation where it sat in an out-of-line
    function), and each instantiation of K1's backward must hold one."""
    import re
    lib = build_mod.build()
    found, cur, bad_reduce = {}, None, []
    for line in sass_text(build_mod).splitlines():
        if "Function :" in line:
            cur = short_kernel_name(line)
            if cur:
                found[cur] = {"instruction": TENSOR_CORE_SASS[
                    cur.split("<")[0]], "count": 0, "example": None}
                for ins in TMA_SASS.get(cur.split("<")[0], ()):
                    found[cur][ins] = 0
        elif "UBLKRED" in line:
            if "UBLKRED.G.S.ADD.F32" not in line:
                bad_reduce.append(
                    line.split("*/", 1)[-1].split(";")[0].strip())
            if cur:
                found[cur]["bulk_reduce_f32"] = \
                    found[cur].get("bulk_reduce_f32", 0) + 1
        elif cur and found[cur]["instruction"] in line:
            found[cur]["count"] += 1
            if found[cur]["example"] is None:
                # "/*0a30*/  HGMMA.64x128x16.F32.BF16 ... ;  /* 0x... */"
                text = line.split("*/", 1)[-1].split("/*")[0]
                found[cur]["example"] = " ".join(text.split())
        elif cur:
            for ins in TMA_SASS.get(cur.split("<")[0], ()):
                found[cur][ins] += ins in line
    log = (lib.parent / "build.log").read_text()
    cur = None
    for line in log.splitlines():
        if "Function properties for" in line:
            cur = short_kernel_name(line)
        elif cur in found and "spill stores" in line:
            found[cur]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif cur in found and "registers" in line:
            found[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    if bad_reduce:
        fail(f"bulk reduce that does not add float32 in the SASS: "
             f"{bad_reduce[:4]}")
    no_sum = [k for k in found if k.startswith(("flash_bwd_wgmma_kernel",
                                                "flash_bwd_colsplit_kernel",
                                                "flash_bwd_kvsplit_kernel"))
              and not found[k].get("bulk_reduce_f32")]
    if no_sum:
        fail(f"no float32 bulk reduce (the dq sums) in {no_sum}")
    missing = [k for k, v in found.items() if not v["count"]]
    missing += [f"{k} ({ins})" for k, v in found.items()
                for ins in TMA_SASS.get(k.split("<")[0], ()) if not v[ins]]
    missing += [k for k in REQUIRED_SASS if k not in found]
    if len(found) != expected_instantiations(build_mod) or missing:
        fail(f"tensor-core instructions missing: found {sorted(found)}, "
             f"none in {missing}")
    return found


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def sdpa(q, k, v, causal, window=0):
    """One library call computing the same function on the same inputs
    (yardstick only): heads-first views, grouped-query mode; a sliding
    window as a boolean mask (causal and within ``window``)."""
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not window:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=True)
    qi = torch.arange(q.shape[1], device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (qi - ki < window) & ((qi >= ki) if causal else True)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True)


def attended_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs the mask keeps: the work of one (batch, head)."""
    qi = np.arange(sq)[:, None]
    ki = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), dtype=bool)
    if causal:
        keep &= qi >= ki
    if window:
        keep &= qi - ki < window
    return int(keep.sum())


# |output| bands for K1's error report: one bf16 step is 0.0156 in
# [2, 4) and 0.0313 in [4, 8), against the 2e-2 bar
ERR_BANDS = (0.0, 1.0, 2.0, 4.0, 8.0, float("inf"))


def err_by_band(out: torch.Tensor, want: torch.Tensor) -> dict:
    """Largest |want| and, per band of |want|, the element count, the
    largest error and the largest spacing of bf16 values in the band (at
    the bottom of the open last band)."""
    w = want.float()
    mag, err = w.abs(), (out.float() - w).abs()
    bands = {}
    for lo, hi in zip(ERR_BANDS, ERR_BANDS[1:]):
        sel = (mag >= lo) & (mag < hi)
        n = int(sel.sum())
        if n:
            bands[f"[{lo:g},{hi:g})"] = {
                "n": n, "max_abs_err": float(err[sel].max()),
                "bf16_step": (lo if hi == float("inf") else hi / 2)
                * 2.0 ** -7}
    return {"out_abs_max": float(mag.max()), "err_by_band": bands}


def sdpa_backend(kernels) -> str | None:
    """Which of SDPA's backends a call took, read from the names of the
    ``kernels`` its whole device-time windows held; None where they held
    none."""
    names = " ".join(kernels).lower()
    if not names:
        return None
    # cuDNN's kernel names hold "flash" too
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("fmha", "cutlass", "efficient"))):
        if any(m in names for m in marks):
            return backend
    return "math"


def device_fields(call, marks, wrapper, lib=None, sdpa=False) -> dict:
    """A timed row's device times (``device_time``): ``device_ms`` of
    ``call`` (its kernels named by ``marks``, counted by ``wrapper``),
    ``device_windows`` and ``device_ms_by_kernel``; with ``lib``, the
    library call's ``library_device_ms`` and ``library_windows``, and
    for an ``sdpa`` call the ``library_backend`` its kernels name."""
    dev = device_time(call, marks, wrapper)
    out = {"device_ms": dev["ms"], "device_windows": dev["windows"],
           "device_ms_by_kernel": dev["by_kernel"]}
    if lib is not None:
        got = device_time(lib)
        out.update(library_device_ms=got["ms"],
                   library_windows=got["windows"])
        if sdpa:
            out["library_backend"] = sdpa_backend(got["by_kernel"])
    return out


def flash_case(ops, ref, rng, shape, dtype, causal, window, timed=False,
               bands=False, dv=None, q_offset=0):
    """K1 on q [b, sq, h, d], k [b, sk, kv, d] and v [b, sk, kv, dv] (``dv``
    None: d), query row i at position ``q_offset + i``, against its plain
    version; ``timed``: also its times, the library call's and the
    bound."""
    b, sq, sk, h, kv, d = shape
    dv = dv or d
    q = randn(rng, (b, sq, h, d), dtype)
    k = randn(rng, (b, sk, kv, d), dtype)
    v = randn(rng, (b, sk, kv, dv), dtype)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    err = max_abs_err(out, want)
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "causal": causal, "window": window, "max_abs_err": err,
           "tol": TOL[dtype], "ok": bool(err < TOL[dtype])
           and bool(torch.isfinite(out.float()).all())}
    if dv != d:
        rec["value_head_dim"] = dv
    if q_offset:
        rec["q_offset"] = q_offset
    if bands:
        rec.update(err_by_band(out, want))
    if timed:
        pairs = attended_pairs(sq, sk, causal, window)
        b_ms, by = bound(nbytes(q, k, v, out),
                         2.0 * b * h * (d + dv) * pairs, dtype)
        call = lambda: ops.flash_attention(q, k, v, causal=causal,
                                           window=window)
        lib = sdpa(q, k, v, causal, window)
        rec.update(
            ms=time_ms(call),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window), iters=5, warmup=1),
            library_ms=time_ms(lib), bound_ms=b_ms, bound_by=by,
            **device_fields(call, ("flash_",), ops.flash_attention, lib,
                            sdpa=True))
    return rec


def sp_case(ops, attn_mod, rng, shape, dtype, window, n_sp) -> dict:
    """``flash_attention_sp`` at ``n_sp`` lanes (``n_sp`` K1 calls, lane i
    at ``q_offset = i * S / n_sp``) against one K1 call over the whole
    causal sequence: q [b, s, h, d], k and v [b, s, kv, d]; its launches
    and whether the two are bitwise equal (each 64-row query tile sees
    the same positions, key tiles and order either way)."""
    b, s, h, kv, d = shape
    q = randn(rng, (b, s, h, d), dtype)
    k, v = (randn(rng, (b, s, kv, d), dtype) for _ in range(2))
    whole = ops.flash_attention(q, k, v, causal=True, window=window)
    before = ops.flash_attention.launches
    lanes = attn_mod.flash_attention_sp(q, k, v, causal=True, window=window,
                                        n_sp=n_sp)
    launches = ops.flash_attention.launches - before
    torch.cuda.synchronize()
    err = max_abs_err(lanes, whole)
    return {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "window": window, "n_sp": n_sp, "launches": launches,
            "max_abs_err": err, "tol": TOL[dtype],
            "bitwise_equal": bool(torch.equal(lanes, whole)),
            "ok": bool(err < TOL[dtype]) and launches == n_sp}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def sdpa_bwd(q, k, v, dout, causal, window=0):
    """The backward of one library call computing the same function
    (yardstick only): grouped-query SDPA on heads-first views, a sliding
    window as a boolean mask, as :func:`sdpa`."""
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    if window:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (qi - ki < window) & ((qi >= ki) if causal else True)
        out = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
    else:
        out = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=True)
    dh = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), dh,
                                       retain_graph=True)


def flash_bwd_case(ops, ref, rng, shape, dtype, causal, window,
                   timed=False, dv=None, head_slice=0):
    """K1's backward on q [b, sq, h, d], k [b, sk, kv, d], v [b, sk, kv,
    dv] (``dv`` None: d), a seeded dO and K1's own output and log-sum-exp,
    against its plain version (BWD_TOL, relative to each gradient's
    largest magnitude); with ``head_slice`` (G = 1) the plain version runs
    on that many heads at a time, each head's gradients depending on its
    own head alone; ``timed``: also its times, the library's backward and
    the bound (five products over the attended pairs, three over D and two
    over Dv; q, k, v, o, dO, lse read and dq, dk, dv written once), and a
    second call that must give the same bits.  ``rng`` may be a
    ``torch.Generator`` on the card for operands of gigabytes."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    b, sq, sk, h, kv, d = shape
    dv = dv or d
    q = randn(rng, (b, sq, h, d), dtype)
    k = randn(rng, (b, sk, kv, d), dtype)
    v = randn(rng, (b, sk, kv, dv), dtype)
    do = randn(rng, (b, sq, h, dv), dtype)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)

    def call():
        return ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                       window=window)

    def plain(hs=slice(None)):
        return ref.flash_attention_bwd_ref(
            q[:, :, hs], k[:, :, hs], v[:, :, hs], o[:, :, hs],
            do[:, :, hs], lse[:, hs], causal=causal, window=window)

    got = call()
    torch.cuda.synchronize()
    if head_slice:
        assert h == kv, "head slices need G = 1"
        errs = []
        for h0 in range(0, h, head_slice):
            hs = slice(h0, h0 + head_slice)
            want = plain(hs)
            errs.append([(max_abs_err(g[:, :, hs], w),
                          float(w.float().abs().max()))
                         for g, w in zip(got, want)])
            del want
        # each gradient relative to its largest magnitude over all heads
        rels = [max(e[i][0] for e in errs) / max(e[i][1] for e in errs)
                for i in range(3)]
        abs_err = max(e[i][0] for e in errs for i in range(3))
    else:
        want = plain()
        rels = [rel_err(g, w) for g, w in zip(got, want)]
        abs_err = max(max_abs_err(g, w) for g, w in zip(got, want))
        del want
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "causal": causal, "window": window,
           "max_abs_err": abs_err,
           "rel_err_dq_dk_dv": rels, "tol": BWD_TOL[dtype],
           "ok": max(rels) < BWD_TOL[dtype] and finite}
    if dv != d:
        rec["value_head_dim"] = dv
    if head_slice:
        rec["plain_checked_by_head_slices_of"] = head_slice
    if timed:
        again = call()
        rec["repeat_bitwise"] = all(torch.equal(x, y)
                                    for x, y in zip(got, again))
        rec["ok"] = rec["ok"] and rec["repeat_bitwise"]
        del again
        pairs = attended_pairs(sq, sk, causal, window)
        b_ms, by = bound(nbytes(q, k, v, o, do, lse, *got),
                         2.0 * b * h * (3 * d + 2 * dv) * pairs, dtype)
        lib = sdpa_bwd(q, k, v, do, causal, window)
        # with head slices, the plain version on one, scaled to the heads
        hs = slice(0, head_slice) if head_slice else slice(None)
        rec.update(
            ms=time_ms(call),
            plain_ms=time_ms(lambda: plain(hs), iters=3, warmup=1)
            * h / (head_slice or h),
            library_ms=time_ms(lib), bound_ms=b_ms, bound_by=by,
            **device_fields(call, ("bwd_",), ops.flash_attention_bwd, lib,
                            sdpa=True))
        if head_slice:
            rec["plain_ms_from"] = f"{head_slice} heads x {h // head_slice}"
    return rec


def decode_case(ops, ref, rng, shape, dtype, cache_len, timed=False,
                device_length=True):
    """K2 at ``shape`` (b, s, h, kv, d) against its plain version, with
    the length as an int and as a device int32 (the same bits); ``timed``:
    also its times, with the length in the form the serving path passes
    (``device_length``: a self-attention cache's; an int for whisper's
    cross-attention, whose rows are all valid), the library call's and
    the bound."""
    b, s, h, kv, d = shape
    q = randn(rng, (b, 1, h, d), dtype)
    kc = randn(rng, (b, s, kv, d), dtype)
    vc = randn(rng, (b, s, kv, d), dtype)
    out = ops.decode_attention(q, kc, vc, cache_len)
    # the serving path's form: the length as a device int32, read by the
    # kernel when it runs; the grid does not depend on it, nor the bits
    length = torch.full((), cache_len, dtype=torch.int32, device="cuda")
    out_dev = ops.decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, kc, vc, cache_len)
    err = max_abs_err(out, want)
    same = bool(torch.equal(out, out_dev))
    rec = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "cache_len": cache_len, "max_abs_err": err, "tol": TOL[dtype],
           "device_length_bitwise_equal": same,
           "ok": bool(err < TOL[dtype]) and same
           and bool(torch.isfinite(out.float()).all())}
    if timed:
        valid = 2 * b * cache_len * kv * d * q.element_size()
        b_ms, by = bound(nbytes(q, out) + valid,
                         4.0 * b * h * d * cache_len, dtype)
        call = lambda: ops.decode_attention(
            q, kc, vc, length if device_length else cache_len)
        lib = sdpa(q, kc[:, :cache_len], vc[:, :cache_len], False)
        rec.update(
            cache_len_on_device=device_length, ms=time_ms(call, iters=50),
            host_us=host_us(call),
            plain_ms=time_ms(lambda: ref.decode_attention_ref(
                q, kc, vc, cache_len), iters=20),
            library_ms=time_ms(lib, iters=50), bound_ms=b_ms, bound_by=by,
            **device_fields(call, ("decode_",), ops.decode_attention, lib))
    return rec


def dispatch_view(rng, b, e, c, d, dtype):
    """x [B, E, C, D] as the MoE layer hands it to the grouped GEMM: a
    view of a [B, E*C + 1, D] dispatch buffer without its last
    (dropped-token) row, which is poisoned with NaN."""
    buf = randn(rng, (b, e * c + 1, d), dtype)
    buf[:, -1] = float("nan")
    return buf[:, :-1].view(b, e, c, d)


def moe_case(ops, ref, x, w, timed=False):
    out = ops.moe_gemm(x, w)
    torch.cuda.synchronize()
    want = ref.moe_gemm_ref(x, w)
    err = max_abs_err(out, want)
    rel = err / max(1e-6, float(want.float().abs().max()))
    dt = x.dtype
    rec = {"shape": [list(x.shape), list(w.shape)],
           "dtype": str(dt).split(".")[-1], "max_abs_err": err,
           "rel_err": rel, "tol": MOE_TOL[dt],
           "ok": bool(rel < MOE_TOL[dt])
           and bool(torch.isfinite(out.float()).all())}
    if timed:
        e, d = w.shape[0], w.shape[1]
        rows = x.numel() // (e * d)            # B * C rows per expert
        b_ms, by = bound(nbytes(x, w, out), 2.0 * e * rows * d * w.shape[2],
                         dt)
        # the library call takes the per-expert rows in one block, as
        # torch.bmm wants them (laid out before timing)
        xt = x.transpose(0, 1).reshape(e, rows, d).contiguous() \
            if x.dim() == 4 else x
        call, lib = lambda: ops.moe_gemm(x, w), lambda: torch.bmm(xt, w)
        rec.update(
            ms=time_ms(call),
            plain_ms=time_ms(lambda: ref.moe_gemm_ref(x, w), iters=5,
                             warmup=1),
            library_ms=time_ms(lib), bound_ms=b_ms, bound_by=by,
            **device_fields(call, ("moe_gemm",), ops.moe_gemm, lib),
            **wrapper_host_us(ops, x, w))
    return rec


def wrapper_host_us(ops, x, w, iters: int = 200) -> dict:
    """Host microseconds per K3 wrapper call (launches queued back to
    back, timed before the card catches up) and, for bf16, the share of
    them its tile and loader plan takes, with the strides and addresses
    it reads."""
    import importlib
    mg = importlib.import_module("repro_torch.kernels.moe_gemm")
    rec = {"host_us": host_us(lambda: ops.moe_gemm(x, w), iters),
           "plan_us": None}
    if x.dtype == torch.bfloat16:
        x4 = x if x.dim() == 4 else x.unsqueeze(0)
        b, e, c, d = x4.shape
        f = w.shape[2]
        t = time.perf_counter()
        for _ in range(iters * 10):
            mg.gemm_plan(b, e, c, d, f, x4.stride(), w.stride(),
                         x4.data_ptr(), w.data_ptr())
        rec["plan_us"] = (time.perf_counter() - t) / (iters * 10) * 1e6
    return rec


def moe_grad_case(ops, ref, kind, a, b, timed=False):
    """K3's input gradient (``kind`` "dx": a = dy, b = w) or weight
    gradient ("dw": a = x, b = dy) against its plain version (MOE_TOL,
    relative to the largest output); ``timed``: also a second call that
    must give the same bits, the times, the bound (2 E rows D F
    operations; the operands read and the output written once) and the
    library's batched ``torch.matmul`` on contiguous [E, B*C, .] operands
    (yardstick only), and the call must take the persistent kernel
    (``tma``)."""
    name = "moe_gemm_" + kind
    call = lambda: getattr(ops, name)(a, b)
    plain = lambda: getattr(ref, name + "_ref")(a, b)
    tma0 = getattr(ops, name).tma_launches
    out = call()
    torch.cuda.synchronize()
    tma = getattr(ops, name).tma_launches - tma0 == 1
    want = plain()
    err = max_abs_err(out, want)
    rel = err / max(1e-6, float(want.float().abs().max()))
    dt = a.dtype
    rec = {"kind": kind, "shape": [list(a.shape), list(b.shape)],
           "dtype": str(dt).split(".")[-1], "max_abs_err": err,
           "rel_err": rel, "tol": MOE_TOL[dt],
           "ok": bool(rel < MOE_TOL[dt])
           and bool(torch.isfinite(out.float()).all())}
    del want
    rec["tma"] = tma
    if timed:
        rec["repeat_bitwise"] = bool(torch.equal(out, call()))
        rec["ok"] = rec["ok"] and rec["repeat_bitwise"] and tma
        rows4 = (lambda t: t if t.dim() == 4 else t.unsqueeze(0))
        lead = rows4(a)
        e, rows = lead.shape[1], lead.shape[0] * lead.shape[2]
        flat = lambda t: rows4(t).transpose(0, 1).reshape(
            e, rows, t.shape[-1]).contiguous()
        if kind == "dx":
            dyc, w = flat(a), b
            lib = lambda: torch.matmul(dyc, w.transpose(1, 2))
            d, f, marker = w.shape[1], w.shape[2], "moe_grad_tma_kernel<0>"
        else:
            xc, dyc = flat(a), flat(b)
            lib = lambda: torch.matmul(xc.transpose(1, 2), dyc)
            d, f, marker = a.shape[-1], b.shape[-1], "moe_grad_tma_kernel<1>"
        b_ms, by = bound(nbytes(a, b, out), 2.0 * e * rows * d * f, dt)
        rec.update(
            ms=time_ms(call), plain_ms=time_ms(plain, iters=5, warmup=1),
            library_ms=time_ms(lib), bound_ms=b_ms, bound_by=by,
            **device_fields(call, (marker,), getattr(ops, name), lib))
    return rec


def rwkv_flops(b, s, h, d, chunk) -> float:
    """Float32 operations of the chunked scan (exp counted as one):
    inter-chunk product, pairwise scores with their exp, diagonal,
    intra-chunk product, state update."""
    pairs = chunk * (chunk - 1) / 2
    per_chunk = (2 * chunk * d * d + 5 * pairs * d + 3 * chunk * d
                 + 2 * (pairs + chunk) * d + 2 * chunk * d * d + 2 * d * d)
    return b * h * (s // chunk) * per_chunk


def scan_tols(dtype, want, wfin) -> tuple[float, float]:
    """Bars of a scan's output and final state: SCAN_TOL in float32; a
    bf16 output rounded once (SCAN_BF16_REL of its largest magnitude),
    its float32 state to SCAN_TOL of its own magnitude."""
    if dtype == torch.float32:
        return SCAN_TOL, SCAN_TOL
    return (SCAN_BF16_REL * float(want.float().abs().max()),
            SCAN_TOL * max(1.0, float(wfin.abs().max())))


def rwkv_case(ops, ref, rng, shape, chunk, dtype, *, strong_decay=False,
              state=False, out_dtype=None, timed=False):
    """``dtype`` of r, k, v (w float32); ``out_dtype`` None: the output in
    ``dtype``, the Pallas contract; the model asks for float32."""
    b, s, h, d = shape
    r = randn(rng, shape, dtype) * 0.5
    k = randn(rng, shape, dtype) * 0.5
    v = randn(rng, shape, dtype)
    w = (torch.full(shape, 1e-6, device="cuda") if strong_decay
         else torch.sigmoid(randn(rng, shape, torch.float32)))
    bonus = randn(rng, (h, d), torch.float32) * 0.1
    st0 = (randn(rng, (b, h, d, d), torch.float32) if state
           else torch.zeros((b, h, d, d), device="cuda"))
    call = lambda: ops.rwkv6_scan(r, k, v, w, bonus, chunk=chunk,
                                  state0=st0, out_dtype=out_dtype)
    out, fin = call()
    torch.cuda.synchronize()
    want, wfin = ref.rwkv6_scan_ref(r, k, v, w, bonus, state0=st0,
                                    out_dtype=out_dtype)
    err, fin_err = max_abs_err(out, want), max_abs_err(fin, wfin)
    tol, fin_tol = scan_tols(dtype, want, wfin)
    rec = {"shape": list(shape), "chunk": chunk,
           "dtype": str(dtype).split(".")[-1],
           "out_dtype": str(out.dtype).split(".")[-1],
           "strong_decay": strong_decay,
           "initial_state": state, "max_abs_err": err,
           "state_max_abs_err": fin_err, "tol": tol, "state_tol": fin_tol,
           "ok": bool(err < tol) and bool(fin_err < fin_tol)
           and bool(torch.isfinite(out.float()).all())}
    if timed:
        b_ms, by = bound(nbytes(r, k, v, w, bonus, st0, out, fin),
                         rwkv_flops(b, s, h, d, chunk), dtype)
        rec.update(
            ms=time_ms(call),
            **device_fields(call, ("rwkv6_",), ops.rwkv6_scan),
            plain_ms=time_ms(lambda: ref.rwkv6_scan_ref(
                r, k, v, w, bonus, state0=st0, out_dtype=out_dtype),
                iters=1, warmup=0),
            library_ms=None, library_device_ms=None, bound_ms=b_ms,
            bound_by=by)
    return rec


def rwkv_bwd_flops(b, s, h, d, chunk) -> float:
    """Operations of K5b's chunked backward (exp counted as one), as the
    design takes them, each product counted once (not its split terms):
    per chunk the two contributions to the chunk-end state and cotangent
    ([L, D]^T by [L, D], with their cumulative sums and factors) and the
    scan's step in each direction; the per-chunk products with S0, dE and
    k exp(tot - ci) ([L, D] by [D, D] each); P = do v^T, the scores (their
    exponentials), X and Y over the pairs and the diagonal; dv's pair sum;
    the factors, scalings and the decays' gradient per element."""
    pairs = chunk * (chunk - 1) / 2
    per_chunk = (2 * (2 * chunk * d * d + 3 * chunk * d) + 2 * 2 * d * d
                 + 3 * 2 * chunk * d * d
                 + 2 * (pairs + chunk) * d
                 + (3 * pairs + 2 * chunk) * d
                 + 2 * 2 * pairs * d
                 + 2 * (pairs + chunk) * d
                 + 12 * chunk * d)
    return b * h * (s // chunk) * per_chunk


def rwkv_bwd_case(ops, ref, rng, shape, chunk, dtype, *, strong_decay=False,
                  state=False, dstate=False, timed=False, repeat=False):
    """K5b on ``dtype`` r, k, v (float32 w and d out, as the model's float32
    output hands it back) against ``rwkv6_scan_bwd_ref``, each gradient
    relative to its largest magnitude; ``state``: an initial state,
    ``dstate``: a final state's cotangent (the model passes neither);
    ``repeat``: a second call must give the same bits."""
    b, s, h, d = shape
    r = randn(rng, shape, dtype) * 0.5
    k = randn(rng, shape, dtype) * 0.5
    v = randn(rng, shape, dtype)
    w = (torch.full(shape, 1e-6, device="cuda") if strong_decay
         else torch.sigmoid(randn(rng, shape, torch.float32)))
    bonus = randn(rng, (h, d), torch.float32) * 0.1
    dout = randn(rng, shape, torch.float32)
    st0 = randn(rng, (b, h, d, d), torch.float32) if state else None
    dst = randn(rng, (b, h, d, d), torch.float32) if dstate else None
    call = lambda: ops.rwkv6_scan_bwd(r, k, v, w, bonus, dout, chunk=chunk,
                                      state0=st0, dstate=dst)
    got = call()
    torch.cuda.synchronize()
    plain = lambda: ref.rwkv6_scan_bwd_ref(r, k, v, w, bonus, dout,
                                           state0=st0, dstate=dst)
    want = plain()
    bars = dict(zip(SCAN_BWD_LEAVES, (
        (SCAN_BWD_REL if dtype == torch.float32 else SCAN_BWD_BF16_REL,) * 3
        + (SCAN_BWD_DW_REL, SCAN_BWD_REL, SCAN_BWD_REL))))
    rel = {n: rel_err(g, x) for n, g, x in zip(SCAN_BWD_LEAVES, got, want)}
    rec = {"shape": list(shape), "chunk": chunk,
           "dtype": str(dtype).split(".")[-1],
           "strong_decay": strong_decay, "initial_state": state,
           "final_cotangent": dstate,
           "max_abs_err": max(max_abs_err(g, x) for g, x in zip(got, want)),
           "rel_err": rel, "tol": bars,
           "ok": all(rel[n] <= bars[n] for n in rel)
           and all(bool(torch.isfinite(g.float()).all()) for g in got)}
    del want
    if repeat:
        again = call()
        rec["repeat_bitwise"] = all(torch.equal(a, c)
                                    for a, c in zip(got, again))
        rec["ok"] = rec["ok"] and rec["repeat_bitwise"]
        del again
    if timed:
        b_ms, by = bound(nbytes(r, k, v, w, bonus, dout, *got,
                                *(x for x in (st0, dst) if x is not None)),
                         rwkv_bwd_flops(b, s, h, d, chunk), dtype)
        rec.update(
            ms=time_ms(call), **device_fields(
                call, RWKV_BWD_CALL_KERNELS[dtype], ops.rwkv6_scan_bwd),
            plain_ms=time_ms(plain, iters=1, warmup=0),
            library_ms=None, library_device_ms=None, bound_ms=b_ms,
            bound_by=by)
    return rec


def mamba_flops(b, s, h, p, n, chunk) -> float:
    """Operations of the chunked Mamba2 scan, pairs on and below
    the diagonal only (exp counted as one): the scores c . b once per
    (batch, chunk), since b and c are shared by every head; per head
    their decay and dt, the intra-chunk product with x, the carried
    state's contribution and its update."""
    pairs = chunk * (chunk + 1) / 2
    per_head = pairs * (3 + 2 * p) + 4 * chunk * p * n
    return b * (s // chunk) * (h * per_head + pairs * 2 * n)


def mamba_case(ops, ref, rng, shape, chunk, dtype, *, state=False,
               sliced=False, out_dtype=None, timed=False):
    """``sliced``: xh, b and c are column slices of one [B, S, H*P + 2N]
    tensor, as ``mamba2_forward`` hands them to the kernel.
    ``out_dtype`` None: y in ``dtype``, the Pallas contract; the model asks
    for float32."""
    b, s, h, p, n = shape
    if sliced:
        xbc = randn(rng, (b, s, h * p + 2 * n), dtype)
        xh = xbc[..., :h * p].view(b, s, h, p)
        bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        xh = randn(rng, (b, s, h, p), dtype)
        bm = randn(rng, (b, s, n), dtype)
        cm = randn(rng, (b, s, n), dtype)
    dt = torch.nn.functional.softplus(randn(rng, (b, s, h), torch.float32))
    a_log = randn(rng, (h,), torch.float32) * 0.5
    st0 = randn(rng, (b, h, p, n), torch.float32) if state else None
    call = lambda: ops.mamba2_scan(xh, bm, cm, dt, a_log, chunk=chunk,
                                   state0=st0, out_dtype=out_dtype)
    y, fin = call()
    torch.cuda.synchronize()
    want, wfin = ref.mamba2_scan_ref(xh, bm, cm, dt, a_log, state0=st0,
                                     out_dtype=out_dtype)
    err, fin_err = max_abs_err(y, want), max_abs_err(fin, wfin)
    tol, fin_tol = scan_tols(dtype, want, wfin)
    rec = {"shape": [list(xh.shape), list(bm.shape)], "chunk": chunk,
           "dtype": str(dtype).split(".")[-1],
           "out_dtype": str(y.dtype).split(".")[-1], "initial_state": state,
           "column_slices": sliced,
           "max_abs_err": err, "state_max_abs_err": fin_err, "tol": tol,
           "state_tol": fin_tol,
           "ok": bool(err <= tol) and bool(fin_err <= fin_tol)
           and bool(torch.isfinite(y.float()).all())}
    if timed:
        given = [st0] if st0 is not None else []
        b_ms, by = bound(nbytes(xh, bm, cm, dt, a_log, y, fin, *given),
                         mamba_flops(b, s, h, p, n, chunk), dtype)
        rec.update(
            ms=time_ms(call),
            **device_fields(call, ("mamba2_",), ops.mamba2_scan),
            plain_ms=time_ms(lambda: ref.mamba2_scan_ref(
                xh, bm, cm, dt, a_log, state0=st0, out_dtype=out_dtype),
                iters=1, warmup=0),
            library_ms=None, library_device_ms=None, bound_ms=b_ms,
            bound_by=by)
    return rec


def mamba_bwd_flops(b, s, h, p, n, chunk) -> float:
    """Operations of K4b's chunked backward at sub-chunks of ``chunk``
    steps (exp counted as one), as the design takes them, each product
    counted once: per chunk and head the two contributions to the
    chunk-end state and cotangent ([L, P]^T by [L, N]) and the scan's step
    in each direction; the state terms S0^T dy, dE^T x and dE b ([L, P] by
    [P, N] each); over the pairs on and below the diagonal dy . x, then
    dx, dc and db's pair sums, their decays and the gradient of dt a; the
    scores c . b once per (batch, chunk), shared by the heads."""
    pairs = chunk * (chunk + 1) / 2
    per_head = (2 * 2 * chunk * p * n + 2 * 2 * p * n
                + 3 * 2 * chunk * p * n
                + pairs * (2 * p + 2 * p + 2 * n + 2 * n + 10)
                + 12 * chunk)
    return b * (s // chunk) * (h * per_head + pairs * 2 * n)


def mamba_bwd_case(ops, ref, rng, shape, chunk, dtype, *, state=False,
                   dstate=False, sliced=False, strong_decay=False,
                   timed=False, repeat=False):
    """K4b on ``dtype`` xh, b, c (``sliced``: column slices of one
    [B, S, H*P + 2N] tensor, as ``mamba2_forward`` hands them over; float32
    dt and dy, as the model's float32 output hands it back) against
    ``mamba2_scan_bwd_ref``, each gradient relative to its largest
    magnitude; ``state``: an initial state, ``dstate``: a final state's
    cotangent (the model passes neither); ``strong_decay``: dt a = -148 a
    step; ``repeat``: a second call must give the same bits."""
    from repro_torch.kernels import mamba2_scan as ms_mod
    b, s, h, p, n = shape
    if sliced:
        xbc = randn(rng, (b, s, h * p + 2 * n), dtype)
        xh = xbc[..., :h * p].view(b, s, h, p)
        bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        xh = randn(rng, (b, s, h, p), dtype)
        bm = randn(rng, (b, s, n), dtype)
        cm = randn(rng, (b, s, n), dtype)
    if strong_decay:
        dt = torch.full((b, s, h), 20.0, device="cuda")
        a_log = torch.full((h,), 2.0, device="cuda")
    else:
        dt = torch.nn.functional.softplus(randn(rng, (b, s, h),
                                                torch.float32))
        a_log = randn(rng, (h,), torch.float32) * 0.5
    dy = randn(rng, (b, s, h, p), torch.float32)
    st0 = randn(rng, (b, h, p, n), torch.float32) if state else None
    dst = randn(rng, (b, h, p, n), torch.float32) if dstate else None
    call = lambda: ops.mamba2_scan_bwd(xh, bm, cm, dt, a_log, dy,
                                       chunk=chunk, state0=st0, dstate=dst)
    got = call()
    torch.cuda.synchronize()
    plain = lambda: ref.mamba2_scan_bwd_ref(xh, bm, cm, dt, a_log, dy,
                                            state0=st0, dstate=dst)
    want = plain()
    xbc_bar = SCAN_BWD_REL if dtype == torch.float32 else SCAN_BWD_BF16_REL
    bars = dict(zip(MAMBA_BWD_LEAVES, (xbc_bar,) * 3 + (
        SCAN_BWD_DW_REL, SCAN_BWD_DW_REL, SCAN_BWD_REL)))
    rel = {k: rel_err(g, x) for k, g, x in zip(MAMBA_BWD_LEAVES, got, want)}
    rec = {"shape": [list(xh.shape), list(bm.shape)], "chunk": chunk,
           "sub_chunk": ms_mod.bwd_chunk(chunk),
           "dtype": str(dtype).split(".")[-1], "column_slices": sliced,
           "strong_decay": strong_decay, "initial_state": state,
           "final_cotangent": dstate,
           "max_abs_err": max(max_abs_err(g, x) for g, x in zip(got, want)),
           "rel_err": rel, "tol": bars,
           "ok": all(rel[k] <= bars[k] for k in rel)
           and all(bool(torch.isfinite(g.float()).all()) for g in got)}
    del want
    if repeat:
        again = call()
        rec["repeat_bitwise"] = all(torch.equal(x, y)
                                    for x, y in zip(got, again))
        rec["ok"] = rec["ok"] and rec["repeat_bitwise"]
        del again
    if timed:
        b_ms, by = bound(nbytes(xh, bm, cm, dt, a_log, dy, *got,
                                *(x for x in (st0, dst) if x is not None)),
                         mamba_bwd_flops(b, s, h, p, n,
                                         ms_mod.bwd_chunk(chunk)), dtype)
        rec.update(
            ms=time_ms(call), **device_fields(
                call, MAMBA_BWD_CALL_KERNELS[dtype], ops.mamba2_scan_bwd),
            plain_ms=time_ms(plain, iters=1, warmup=0),
            library_ms=None, library_device_ms=None, bound_ms=b_ms,
            bound_by=by)
    return rec


def sweep_err(cases, field="max_abs_err"):
    return {dt: max(c[field] for c in cases if c["dtype"] == dt)
            for dt in sorted({c["dtype"] for c in cases})}


def phase_kernels(ops, ref, cfgs, moe_cfg, rwkv_cfg, mamba_cfg, gemma_cfg,
                  deepseek_cfg, whisper_cfg, qwen15_cfg, llava_cfg,
                  seed: int) -> dict:
    from repro_torch.models.moe import _capacity
    rng = np.random.default_rng(seed)
    seconds, t_lap = {}, time.perf_counter()

    def lap(name):
        nonlocal t_lap
        seconds[name] = time.perf_counter() - t_lap
        t_lap = time.perf_counter()

    flash_sweep, decode_sweep = [], []
    for shape in FLASH_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window in FLASH_MODES:
                flash_sweep.append(flash_case(ops, ref, rng, shape, dtype,
                                              causal, window))
    for clen in DECODE_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            decode_sweep.append(decode_case(ops, ref, rng, (2, 512, 8, 4, 64),
                                            dtype, clen))
    lap("k1_k2_sweeps")
    # the serving path's own shapes: a whole-batch stage and a 2-way shard
    flash_main, decode_main = {}, {}
    s_max = PROMPT_LEN + GEN_LEN
    for name, cfg in cfgs.items():
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        dt = getattr(torch, cfg.dtype)
        for nq in (NUM_QUERIES, NUM_QUERIES // N_DEVICES):
            timed = nq == NUM_QUERIES
            flash_main[f"{name}/nq{nq}"] = flash_case(
                ops, ref, rng, (nq, PROMPT_LEN, PROMPT_LEN, h, kv, d), dt,
                True, 0, timed=timed, bands=True)
            for clen in (PROMPT_LEN + 1, s_max):
                decode_main[f"{name}/nq{nq}/len{clen}"] = decode_case(
                    ops, ref, rng, (nq, s_max, h, kv, d), dt, clen,
                    timed=timed and clen == s_max)
    # gemma3 at head dim 256, at its served prompt: K1 on a local layer
    # (its sliding window binds) and on a global one; K2 on a global cache
    # of prompt + GEN_LEN rows and on a local layer's ring, full; timed in
    # the model's dtype, held to the plain version in float32 as well
    h, kv = gemma_cfg.num_heads, gemma_cfg.num_kv_heads
    d, w = gemma_cfg.resolved_head_dim, gemma_cfg.sliding_window
    g_len, g_max = GEMMA_PROMPT_LEN, GEMMA_PROMPT_LEN + GEN_LEN
    for dt in (getattr(torch, gemma_cfg.dtype), torch.float32):
        timed = dt == getattr(torch, gemma_cfg.dtype)
        tag = f"{gemma_cfg.name}/{{}}/nq{NUM_QUERIES}" + (
            "" if timed else "/float32")
        for kind, window in (("local", w), ("global", 0)):
            flash_main[tag.format(kind)] = flash_case(
                ops, ref, rng, (NUM_QUERIES, g_len, g_len, h, kv, d), dt,
                True, window, timed=timed, bands=timed)
        for kind, rows, clens in (("global", g_max, (g_len + 1, g_max)),
                                  ("local", w, (w,))):
            for clen in clens:
                decode_main[tag.format(kind) + f"/len{clen}"] = decode_case(
                    ops, ref, rng, (NUM_QUERIES, rows, h, kv, d), dt, clen,
                    timed=timed and clen == rows)
    # deepseek-v2's prefill: K1 with query/key dim 128 + 64 over value dim
    # 128, 128 heads of one group each, at the served prompt; timed in the
    # model's dtype (and at a 2-way shard), held in float32 as well
    ml = deepseek_cfg.mla
    dqk, h = ml.qk_nope_head_dim + ml.qk_rope_head_dim, deepseek_cfg.num_heads
    ds_dt = getattr(torch, deepseek_cfg.dtype)
    for nq, dt in ((NUM_QUERIES, ds_dt), (NUM_QUERIES // N_DEVICES, ds_dt),
                   (NUM_QUERIES, torch.float32)):
        timed = nq == NUM_QUERIES and dt == ds_dt
        key = f"{deepseek_cfg.name}/nq{nq}" + (
            "/float32" if dt == torch.float32 else "")
        flash_main[key] = flash_case(
            ops, ref, rng, (nq, PROMPT_LEN, PROMPT_LEN, h, h, dqk), dt, True,
            0, timed=timed, bands=timed, dv=ml.v_head_dim)
    # whisper-small (12 heads of 64, G = 1): K1 on the encoder's
    # bidirectional self-attention over its 1500 frames, on the decoder
    # prefill's cross-attention (224 queries over the frames) and its
    # causal self-attention; K2 on the decoder's self cache (prompt +
    # GEN_LEN rows, a device length) and on the cross K/V (1500 rows, the
    # int length a decode step passes); timed in the model's dtype, held
    # to the plain version in float32 as well
    h, kv = whisper_cfg.num_heads, whisper_cfg.num_kv_heads
    d, frames = whisper_cfg.resolved_head_dim, whisper_cfg.encoder_frames
    w_len, w_max = WHISPER_PROMPT_LEN, WHISPER_PROMPT_LEN + GEN_LEN
    for dt in (getattr(torch, whisper_cfg.dtype), torch.float32):
        timed = dt == getattr(torch, whisper_cfg.dtype)
        tag = f"{whisper_cfg.name}/{{}}/nq{NUM_QUERIES}" + (
            "" if timed else "/float32")
        for kind, sq, sk, causal in (("encoder", frames, frames, False),
                                     ("cross", w_len, frames, False),
                                     ("decoder", w_len, w_len, True)):
            flash_main[tag.format(kind)] = flash_case(
                ops, ref, rng, (NUM_QUERIES, sq, sk, h, kv, d), dt, causal,
                0, timed=timed, bands=timed)
        for kind, rows, on_device in (("self", w_max, True),
                                      ("cross", frames, False)):
            decode_main[tag.format(kind) + f"/len{rows}"] = decode_case(
                ops, ref, rng, (NUM_QUERIES, rows, h, kv, d), dt, rows,
                timed=timed, device_length=on_device)
    # qwen1.5-4b (20 / 20 heads of 128, G = 1) at the served prompt and
    # llava-next-mistral-7b (32 / 8 heads of 128) at llava_image's prompt
    # (576 image positions, then text): K1 causal, K2 over the cache of
    # prompt + GEN_LEN rows with its length on the device; timed in the
    # models' dtype, held to the plain version in float32 as well
    for cfg, plen in ((qwen15_cfg, PROMPT_LEN), (llava_cfg, LLAVA_PROMPT_LEN)):
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        for dt in (getattr(torch, cfg.dtype), torch.float32):
            timed = dt == getattr(torch, cfg.dtype)
            tag = f"{cfg.name}/nq{NUM_QUERIES}" + ("" if timed
                                                   else "/float32")
            flash_main[tag] = flash_case(
                ops, ref, rng, (NUM_QUERIES, plen, plen, h, kv, d), dt, True,
                0, timed=timed, bands=timed)
            rows = plen + GEN_LEN
            decode_main[f"{tag}/len{rows}"] = decode_case(
                ops, ref, rng, (NUM_QUERIES, rows, h, kv, d), dt, rows,
                timed=timed)
        torch.cuda.empty_cache()
    lap("k1_k2_served")
    # K1's q_offset against its plain version, and flash_attention_sp at
    # qwen3's and gemma3's served shapes against one K1 call
    b, sq, sk, h, kv = OFFSET_SHAPE
    offset_sweep = [flash_case(ops, ref, rng, (b, sq, sk, h, kv, d), dtype,
                               causal, window, dv=dv, q_offset=off)
                    for d, dv in OFFSET_DIMS
                    for dtype in (torch.float32, torch.bfloat16)
                    for causal, window in OFFSET_MODES
                    for off in (0, sk - sq, sq // 2)]
    from repro_torch.models import attention as attn_mod
    qcfg = cfgs["qwen3-1.7b"]
    sp_shapes = {
        qcfg.name: ((NUM_QUERIES, PROMPT_LEN, qcfg.num_heads,
                     qcfg.num_kv_heads, qcfg.resolved_head_dim), 0),
        **{f"{gemma_cfg.name}/{kind}": (
            (NUM_QUERIES, GEMMA_PROMPT_LEN, gemma_cfg.num_heads,
             gemma_cfg.num_kv_heads, gemma_cfg.resolved_head_dim), window)
           for kind, window in (("local", gemma_cfg.sliding_window),
                                ("global", 0))}}
    sp_main = {f"{name}/n_sp{n}": sp_case(ops, attn_mod, rng, shape,
                                          torch.bfloat16, window, n)
               for name, (shape, window) in sp_shapes.items()
               for n in SP_LANES}
    torch.cuda.empty_cache()
    lap("k1_q_offset")
    # K1's backward: a sweep over every (D, Dv) pair, both types, the masks
    # and ragged lengths; qwen3-1.7b's training shape (the train phase's
    # microbatch) and its served prefill, timed in bf16
    from repro_torch.kernels import _build
    bwd_sweep = [flash_bwd_case(ops, ref, rng, (b, sq, sk, h, kv, d), dtype,
                                causal, window, dv=dv)
                 for d, dv in _build.FLASH_HEAD_DIMS
                 for dtype in (torch.float32, torch.bfloat16)
                 for causal, window in FLASH_MODES
                 for b, sq, sk, h, kv in BWD_SWEEP]
    qcfg = cfgs["qwen3-1.7b"]
    h, kv, d = qcfg.num_heads, qcfg.num_kv_heads, qcfg.resolved_head_dim
    bwd_main = {
        f"{qcfg.name}/train": flash_bwd_case(
            ops, ref, rng, (TRAIN_MICROBATCH, train_seq_len(), train_seq_len(),
                            h, kv, d), torch.bfloat16, True, 0, timed=True),
        f"{qcfg.name}/nq{NUM_QUERIES}": flash_bwd_case(
            ops, ref, rng, (NUM_QUERIES, PROMPT_LEN, PROMPT_LEN, h, kv, d),
            torch.bfloat16, True, 0, timed=True)}
    # granite's training shape (G = 3, D = 64), the train_moe phase's
    h, kv = moe_cfg.num_heads, moe_cfg.num_kv_heads
    bwd_main[f"{moe_cfg.name}/train"] = flash_bwd_case(
        ops, ref, rng, (TRAIN_MICROBATCH, train_seq_len(), train_seq_len(),
                        h, kv, moe_cfg.resolved_head_dim), torch.bfloat16,
        True, 0, timed=True)
    # gemma3's training shape (G = 2, D = 256: the column-split kernel), the
    # train_gemma3 phase's: a local layer (its window) and a global one,
    # timed in bf16 beside SDPA's backward (masked for the local layer),
    # and held in float32
    h, kv = gemma_cfg.num_heads, gemma_cfg.num_kv_heads
    gshape = (TRAIN_MICROBATCH, train_seq_len(), train_seq_len(), h, kv,
              gemma_cfg.resolved_head_dim)
    for kind, window in (("local", gemma_cfg.sliding_window),
                         ("global", 0)):
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            bwd_main[f"{gemma_cfg.name}/train_{kind}"
                     + ("" if timed else "/float32")] = flash_bwd_case(
                ops, ref, rng, gshape, dtype, True, window, timed=timed)
            torch.cuda.empty_cache()
    # deepseek-v2's training shape (128 heads, G = 1, (D, Dv) = (192, 128):
    # the kv-split kernel), the train_deepseek phase's: timed in bf16
    # beside SDPA's backward and held to the plain version 16 heads at a
    # time (the whole plain backward would need about 70 GB), operands drawn
    # on the card; in float32 on 16 of its heads
    h = deepseek_cfg.num_heads
    dshape = (TRAIN_MICROBATCH, train_seq_len(), train_seq_len(), h, h, dqk)
    bwd_main[f"{deepseek_cfg.name}/train"] = flash_bwd_case(
        ops, ref, torch.Generator(device="cuda").manual_seed(seed), dshape,
        torch.bfloat16, True, 0, timed=True, dv=ml.v_head_dim, head_slice=16)
    torch.cuda.empty_cache()
    bwd_main[f"{deepseek_cfg.name}/train_16_heads/float32"] = flash_bwd_case(
        ops, ref, rng, dshape[:3] + (16, 16, dqk), torch.float32, True, 0,
        dv=ml.v_head_dim)
    torch.cuda.empty_cache()
    # whisper-small's training shapes (12 heads of 64, G = 1), the
    # train_whisper phase's microbatch: the encoder's bidirectional
    # self-attention over its frames, the decoder's causal self-attention
    # and its cross-attention (the decoder's tokens over the frames,
    # non-causal); timed in bf16 beside SDPA's backward, held in float32
    h, kv = whisper_cfg.num_heads, whisper_cfg.num_kv_heads
    d, seq = whisper_cfg.resolved_head_dim, train_seq_len()
    for kind, sq, sk, causal in (("encoder", frames, frames, False),
                                 ("decoder", seq, seq, True),
                                 ("cross", seq, frames, False)):
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            bwd_main[f"{whisper_cfg.name}/train_{kind}"
                     + ("" if timed else "/float32")] = flash_bwd_case(
                ops, ref, rng, (TRAIN_MICROBATCH, sq, sk, h, kv, d), dtype,
                causal, 0, timed=timed)
            torch.cuda.empty_cache()
    lap("k1b")
    # K3: the sweep, a strided batched case, the serving shapes
    moe_sweep = []
    for e, c, d, f in MOE_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            moe_sweep.append(moe_case(ops, ref, randn(rng, (e, c, d), dtype),
                                      randn(rng, (e, d, f), dtype)))
    for dtype in (torch.float32, torch.bfloat16):
        w_t = randn(rng, (5, 40, 72), dtype).transpose(1, 2)   # strided w
        moe_sweep.append(moe_case(ops, ref, dispatch_view(rng, 3, 5, 24, 72,
                                                          dtype), w_t))
    m, dm = moe_cfg.moe, moe_cfg.d_model
    dt = getattr(torch, moe_cfg.dtype)
    moe_main = {}
    for nq in (NUM_QUERIES, NUM_QUERIES // N_DEVICES):
        timed = nq == NUM_QUERIES
        cap = _capacity(PROMPT_LEN, moe_cfg)     # 128 for granite
        w_up = randn(rng, (m.num_experts, dm, m.d_expert), dt)
        w_down = randn(rng, (m.num_experts, m.d_expert, dm), dt)
        moe_main[f"prefill_up/nq{nq}"] = moe_case(
            ops, ref, dispatch_view(rng, nq, m.num_experts, cap, dm, dt),
            w_up, timed=timed)
        moe_main[f"prefill_down/nq{nq}"] = moe_case(
            ops, ref, randn(rng, (nq, m.num_experts, cap, m.d_expert), dt),
            w_down, timed=timed)
        moe_main[f"decode_up/nq{nq}"] = moe_case(
            ops, ref, dispatch_view(rng, nq, m.num_experts, 8, dm, dt),
            w_up, timed=timed)
        moe_main[f"decode_down/nq{nq}"] = moe_case(
            ops, ref, randn(rng, (nq, m.num_experts, 8, m.d_expert), dt),
            w_down, timed=timed)
        del w_up, w_down
    # deepseek-v2's 160 experts of d 5120 <-> 1536 at its prefill capacity
    # (24) and its decode capacity (8); the weights (2.5 GB each) drawn on
    # the card
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m, dm = deepseek_cfg.moe, deepseek_cfg.d_model
    w_up = randn(gen, (m.num_experts, dm, m.d_expert), ds_dt)
    w_down = randn(gen, (m.num_experts, m.d_expert, dm), ds_dt)
    for nq in (NUM_QUERIES, NUM_QUERIES // N_DEVICES):
        timed = nq == NUM_QUERIES
        for stage, cap in (("prefill", _capacity(PROMPT_LEN, deepseek_cfg)),
                           ("decode", _capacity(1, deepseek_cfg))):
            tag = f"{deepseek_cfg.name}/{stage}"
            moe_main[f"{tag}_up/nq{nq}"] = moe_case(
                ops, ref, dispatch_view(gen, nq, m.num_experts, cap, dm,
                                        ds_dt), w_up, timed=timed)
            moe_main[f"{tag}_down/nq{nq}"] = moe_case(
                ops, ref, randn(gen, (nq, m.num_experts, cap, m.d_expert),
                                ds_dt), w_down, timed=timed)
    del w_up, w_down
    torch.cuda.empty_cache()
    lap("k3")
    # K3's gradients: the sweep (deepseek's operands drawn on the card),
    # then granite's training shapes (microbatch 2 at capacity 1024: the
    # gate / up and the down projection), timed
    grad_sweep = []
    for b, e, c, d, f in MOE_GRAD_SWEEP:
        src = gen if e > 64 else rng
        for dtype in (torch.float32, torch.bfloat16):
            lead = (e, c) if b is None else (b, e, c)
            x = dispatch_view(src, b or 1, e, c, d, dtype)
            x = x if b else x[0]
            w = randn(src, (e, d, f), dtype) * d ** -0.5
            dy = randn(src, lead + (f,), dtype)
            grad_sweep += [moe_grad_case(ops, ref, "dx", dy, w),
                           moe_grad_case(ops, ref, "dw", x, dy)]
            del x, w, dy
    torch.cuda.empty_cache()
    m, dm = moe_cfg.moe, moe_cfg.d_model
    cap = _capacity(train_seq_len(), moe_cfg)      # 1024 for granite
    grad_main = {"moe_gemm_dx": {}, "moe_gemm_dw": {}}
    for proj, d, f in (("gate_up", dm, m.d_expert), ("down", m.d_expert, dm)):
        key = f"{moe_cfg.name}/train_{proj}"
        x = (dispatch_view(rng, TRAIN_MICROBATCH, m.num_experts, cap, d, dt)
             if proj == "gate_up" else
             randn(rng, (TRAIN_MICROBATCH, m.num_experts, cap, d), dt))
        w = randn(rng, (m.num_experts, d, f), dt) * d ** -0.5
        dy = randn(rng, (TRAIN_MICROBATCH, m.num_experts, cap, f), dt)
        grad_main["moe_gemm_dx"][key] = moe_grad_case(ops, ref, "dx", dy, w,
                                                      timed=True)
        grad_main["moe_gemm_dw"][key] = moe_grad_case(ops, ref, "dw", x, dy,
                                                      timed=True)
        del x, w, dy
    torch.cuda.empty_cache()
    lap("k3_grads")
    # K5: the sweep, an initial state, bf16 inputs, the serving shape
    rwkv_sweep = []
    for s_len, chunk in RWKV_SWEEP:
        for strong in (False, True):
            rwkv_sweep.append(rwkv_case(ops, ref, rng, (2, s_len, 2, 16),
                                        chunk, torch.float32,
                                        strong_decay=strong))
    rwkv_sweep.append(rwkv_case(ops, ref, rng, (2, 96, 3, 64), 32,
                                torch.float32, state=True))
    rwkv_sweep.append(rwkv_case(ops, ref, rng, (2, 96, 3, 64), 32,
                                torch.bfloat16, state=True))
    for d, chunk, strong, state, out_dt in RWKV_BF16_SWEEP:
        rwkv_sweep.append(rwkv_case(ops, ref, rng, (2, 128, 2, d), chunk,
                                    torch.bfloat16, strong_decay=strong,
                                    state=state, out_dtype=out_dt))
    # the serving shape as the model calls it: float32 output, timed
    hd = rwkv_cfg.rwkv.head_dim
    rshape = (NUM_QUERIES, PROMPT_LEN, rwkv_cfg.d_model // hd, hd)
    rwkv_main = {f"prefill/nq{NUM_QUERIES}": rwkv_case(
        ops, ref, rng, rshape, rwkv_cfg.rwkv.chunk,
        getattr(torch, rwkv_cfg.dtype), out_dtype=torch.float32,
        timed=True)}
    # K5b: the train_rwkv phase's microbatch ([2, 4096, 40, 64], chunk 32)
    # as the model calls it (bf16 r, k, v, no initial state, no final
    # cotangent), timed and called twice for the same bits; the served
    # prefill's shape with both ends, timed; each also in float32 and
    # under strong decay (w = 1e-6) with both ends
    rdt, chunk = getattr(torch, rwkv_cfg.dtype), rwkv_cfg.rwkv.chunk
    tshape = (TRAIN_MICROBATCH, train_seq_len()) + rshape[2:]
    rwkv_main[f"{rwkv_cfg.name}/train"] = rwkv_case(
        ops, ref, rng, tshape, chunk, rdt, out_dtype=torch.float32,
        timed=True)
    rwkv_bwd_main = {}
    for tag, shape in ((f"{rwkv_cfg.name}/train", tshape),
                       (f"prefill/nq{NUM_QUERIES}", rshape)):
        train = shape == tshape
        rwkv_bwd_main[tag] = rwkv_bwd_case(
            ops, ref, rng, shape, chunk, rdt, state=not train,
            dstate=not train, timed=True, repeat=train)
        rwkv_bwd_main[tag + "/float32"] = rwkv_bwd_case(
            ops, ref, rng, shape, chunk, torch.float32, state=True,
            dstate=True)
        rwkv_bwd_main[tag + "/strong_decay"] = rwkv_bwd_case(
            ops, ref, rng, shape, chunk, rdt, strong_decay=True, state=True,
            dstate=True)
        torch.cuda.empty_cache()
    lap("k5_k5b")
    # K4: the sweep, an initial state, bf16 inputs, the serving shape (in
    # the model's dtype with a float32 y, as the model calls it, timed; and
    # in float32 against the 5e-4 bar) on column-slice operands and a
    # carried state, as the model passes them
    mamba_sweep = [mamba_case(ops, ref, rng, (2, s_len, 3, 16, 8), chunk,
                              torch.float32)
                   for s_len, chunk in MAMBA_SWEEP]
    mamba_sweep.append(mamba_case(ops, ref, rng, (2, 256, 3, 64, 64), 128,
                                  torch.float32, state=True))
    mamba_sweep.append(mamba_case(ops, ref, rng, (2, 256, 3, 64, 64), 128,
                                  torch.bfloat16, state=True))
    sc = mamba_cfg.ssm
    nh = sc.expand * mamba_cfg.d_model // sc.head_dim
    mshape = (NUM_QUERIES, PROMPT_LEN, nh, sc.head_dim, sc.state_dim)
    mamba_main = {
        f"prefill/nq{NUM_QUERIES}": mamba_case(
            ops, ref, rng, mshape, sc.chunk, getattr(torch, mamba_cfg.dtype),
            state=True, sliced=True, out_dtype=torch.float32, timed=True),
        f"prefill_float32/nq{NUM_QUERIES}": mamba_case(
            ops, ref, rng, mshape, sc.chunk, torch.float32, state=True,
            sliced=True)}
    # K4 at the train_zamba2 phase's microbatch ([2, 4096, 80, 64], chunk
    # 128) as the model calls it, timed; K4b there as the model calls it
    # (bf16 column slices, no initial state, no final cotangent), timed and
    # called twice for the same bits; at the served prefill's shape with
    # both ends, timed; each also in float32 and under strong decay with
    # both ends
    mdt = getattr(torch, mamba_cfg.dtype)
    tshape = (TRAIN_MICROBATCH, train_seq_len()) + mshape[2:]
    mamba_main[f"{mamba_cfg.name}/train"] = mamba_case(
        ops, ref, rng, tshape, sc.chunk, mdt, sliced=True,
        out_dtype=torch.float32, timed=True)
    mamba_bwd_main = {}
    for tag, shape in ((f"{mamba_cfg.name}/train", tshape),
                       (f"prefill/nq{NUM_QUERIES}", mshape)):
        train = shape == tshape
        mamba_bwd_main[tag] = mamba_bwd_case(
            ops, ref, rng, shape, sc.chunk, mdt, state=not train,
            dstate=not train, sliced=True, timed=True, repeat=train)
        mamba_bwd_main[tag + "/float32"] = mamba_bwd_case(
            ops, ref, rng, shape, sc.chunk, torch.float32, state=True,
            dstate=True)
        mamba_bwd_main[tag + "/strong_decay"] = mamba_bwd_case(
            ops, ref, rng, shape, sc.chunk, mdt, state=True, dstate=True,
            sliced=True, strong_decay=True)
        torch.cuda.empty_cache()
    # K1's backward at the shared attention block's training shape (32
    # heads of 80, G = 1, padded to 128 in the wgmma kernel), timed in bf16
    # beside SDPA's backward, the plain version 16 heads at a time
    h, kv = mamba_cfg.num_heads, mamba_cfg.num_kv_heads
    bwd_main[f"{mamba_cfg.name}/train"] = flash_bwd_case(
        ops, ref, rng, (TRAIN_MICROBATCH, train_seq_len(), train_seq_len(),
                        h, kv, mamba_cfg.resolved_head_dim), mdt, True, 0,
        timed=True, head_slice=16)
    torch.cuda.empty_cache()
    lap("k4_k4b_zamba2_k1b")

    cases = (flash_sweep + decode_sweep + list(flash_main.values())
             + offset_sweep + list(sp_main.values())
             + list(decode_main.values()) + bwd_sweep
             + list(bwd_main.values()) + moe_sweep
             + list(moe_main.values()) + grad_sweep
             + list(grad_main["moe_gemm_dx"].values())
             + list(grad_main["moe_gemm_dw"].values()) + rwkv_sweep
             + list(rwkv_main.values()) + list(rwkv_bwd_main.values())
             + mamba_sweep
             + list(mamba_main.values()) + list(mamba_bwd_main.values()))
    bad = [c for c in cases if not c["ok"]]
    out = {
        "phase": "kernels", "ok": not bad, "n_cases": len(cases),
        "seconds": seconds,
        "flash_attention": {
            "sweep_cases": len(flash_sweep),
            "sweep_max_abs_err": sweep_err(flash_sweep),
            "main_path": flash_main,
            "q_offset_sweep": {
                "cases": len(offset_sweep),
                "max_abs_err": sweep_err(offset_sweep),
                "all": offset_sweep},
            "sequence_parallel": sp_main},
        "decode_attention": {
            "sweep_cases": len(decode_sweep),
            "sweep_max_abs_err": sweep_err(decode_sweep),
            "main_path": decode_main},
        "flash_attention_bwd": {
            "sweep_cases": len(bwd_sweep),
            "sweep_max_abs_err": sweep_err(bwd_sweep),
            "sweep_max_rel_err": {
                dt: max(max(c["rel_err_dq_dk_dv"]) for c in bwd_sweep
                        if c["dtype"] == dt)
                for dt in ("float32", "bfloat16")},
            "main_path": bwd_main},
        "moe_gemm": {
            "sweep_cases": len(moe_sweep),
            "sweep_rel_err": sweep_err(moe_sweep, "rel_err"),
            "main_path": moe_main},
        **{name: {
            "sweep_cases": sum(c["kind"] == name[-2:] for c in grad_sweep),
            "sweep_rel_err": sweep_err(
                [c for c in grad_sweep if c["kind"] == name[-2:]],
                "rel_err"),
            "main_path": grad_main[name]}
           for name in ("moe_gemm_dx", "moe_gemm_dw")},
        "rwkv6_scan": {
            "sweep_cases": len(rwkv_sweep),
            "sweep_max_abs_err": sweep_err(rwkv_sweep),
            "sweep_state_max_abs_err": sweep_err(rwkv_sweep,
                                                 "state_max_abs_err"),
            "main_path": rwkv_main},
        "rwkv6_scan_bwd": {
            "max_rel_err": {n: max(c["rel_err"][n]
                                   for c in rwkv_bwd_main.values())
                            for n in SCAN_BWD_LEAVES},
            "main_path": rwkv_bwd_main},
        "mamba2_scan": {
            "sweep_cases": len(mamba_sweep),
            "sweep_max_abs_err": sweep_err(mamba_sweep),
            "sweep_state_max_abs_err": sweep_err(mamba_sweep,
                                                 "state_max_abs_err"),
            "main_path": mamba_main},
        "mamba2_scan_bwd": {
            "max_rel_err": {k: max(c["rel_err"][k]
                                   for c in mamba_bwd_main.values())
                            for k in MAMBA_BWD_LEAVES},
            "main_path": mamba_bwd_main},
        "failed": bad,
    }
    emit(out)
    if bad:
        fail(f"{len(bad)} kernel case(s) disagree with the plain version")
    return out


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------


class RecordingPolicy:
    """Passes ``plan`` through and keeps the placements it returned."""

    def __init__(self, policy):
        self.policy = policy
        self.placements = []

    def plan(self, wf, state, ready):
        out = self.policy.plan(wf, state, ready)
        self.placements.extend(out)
        return out


def load_example():
    """The example module whose ``make_workflow`` defines the served DAG
    (one definition for the example and for this script)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / \
        "serve_workflow_torch.py"
    spec = importlib.util.spec_from_file_location("serve_workflow_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def no_launches() -> dict:
    """Every count of ``ops.counts()`` at 0."""
    from repro_torch.kernels import ops
    return dict.fromkeys(ops.counts(), 0)


def expected_launches(bundles, wf, placements,
                      prompt_len: int = PROMPT_LEN,
                      gen_len: int = GEN_LEN) -> dict:
    """Kernel launches the recorded placements call for: per shard run, a
    model that attends launches K1 once per layer at prefill and K2 once
    per layer at each of the gen_len - 1 decode steps (none for MLA, whose
    absorbed decode step is plain matrix products); an MoE model K3
    three times per MoE layer at prefill and at every decode step; an
    RWKV6 model K5 once per layer at prefill (its decode step is plain);
    a Mamba2 hybrid K4 once per layer at prefill (its decode step is
    plain), and K1, K2 as above once per attention site instead of per
    layer.  ``moe_gemm_decode_tile``: those K3 launches whose B*C rows
    per expert (queries of the shard times the capacity of the call)
    fall below the 128-row tile's threshold, every decode step at these
    shard sizes."""
    from repro_torch.kernels.moe_gemm import PREFILL_MIN_ROWS
    from repro_torch.models.moe import _capacity
    exp = no_launches()
    for p in placements:
        cfg = bundles[wf.stages[p.sid].model].cfg
        runs = sum(1 for n in p.shard_sizes if n)
        if cfg.rwkv is not None:
            exp["rwkv6_scan"] += cfg.num_layers * runs
            continue
        if cfg.ssm is not None:
            sites = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
            exp["mamba2_scan"] += cfg.num_layers * runs
            exp["flash_attention"] += sites * runs
            exp["decode_attention"] += sites * runs * (gen_len - 1)
            continue
        exp["flash_attention"] += cfg.num_layers * runs
        if cfg.attention != "mla":
            exp["decode_attention"] += cfg.num_layers * runs * (gen_len - 1)
        if cfg.moe is not None:
            gemms = 3 * (cfg.num_layers - cfg.moe_layer_start)
            exp["moe_gemm"] += gemms * runs * gen_len
            for n in p.shard_sizes:
                if n:
                    exp["moe_gemm_decode_tile"] += gemms * (
                        int(n * _capacity(prompt_len, cfg) < PREFILL_MIN_ROWS)
                        + (gen_len - 1) * int(
                            n * _capacity(1, cfg) < PREFILL_MIN_ROWS))
    return exp


def ring_and_global_rows(bundle, prompt_len: int) -> tuple[dict, list]:
    """Rows of the local (ring) and global caches of every decode key of a
    local/global bundle, how many of them were written, and what is wrong
    with them: after a stage every row of a local ring must hold data
    (the prompt is longer than the window), and a global cache every row
    up to the last decode step's position."""
    rows, problems = {}, []
    for (batch, max_len), slot in sorted(bundle.decoder.slots.items()):
        key = f"{batch}x{max_len}"
        rows[key] = {}
        for kind, want in (("local", min(bundle.cfg.sliding_window,
                                         max_len)),
                           ("global", max_len)):
            k = slot.cache[kind]["k"]
            live = k.abs().amax(dim=(0, 1, 3, 4)) > 0     # per row
            written = min(want, prompt_len + GEN_LEN - 1)
            rows[key][kind] = {"rows": int(k.shape[2]),
                               "rows_written": int(live.sum())}
            if k.shape[2] != want or int(live[:written].sum()) != written:
                problems.append(f"{key} {kind} cache: {k.shape[2]} rows "
                                f"({int(live.sum())} written), expected "
                                f"{want} ({written} written)")
    return rows, problems


def serve_checked(mods, bundles, wf, prompts, policy_name: str = "FATE",
                  prompt_len: int = PROMPT_LEN,
                  gen_len: int = GEN_LEN) -> dict:
    """Serve ``wf`` under ``policy_name`` twice, a warm-up pass (cuBLAS,
    the allocator, and the decode graphs of the keys the pass meets,
    captured at their first stage) and the measured pass, with the launch
    counts zeroed just before it.  Returns that pass's engine, policy,
    results, wall seconds, launch counts and the placements' expected
    ones, its stages, its decode graphs' replays and ``problems``: a
    stage not served, tokens of the wrong shape or outside the model's
    vocabulary, launch counts other than the placements call for, a
    decode step that was not a replay but the first of a shard run whose
    key the pass captured."""
    ops = mods["ops"]
    nq = wf.num_queries

    def run_once():
        engine = mods["ServingEngine"](bundles, n_devices=N_DEVICES,
                                       gen_len=gen_len,
                                       prompt_len=prompt_len)
        state = mods["fresh_state"](mods["homogeneous_cluster"](N_DEVICES))
        policy = RecordingPolicy(mods["make_policy"](policy_name))
        t = time.perf_counter()
        results = engine.run_workflow(wf, policy, state, prompts)
        torch.cuda.synchronize()
        return engine, policy, results, time.perf_counter() - t

    run_once()
    decoders = {name: b.decoder for name, b in bundles.items()}
    before = {name: (d.replays, d.eager_steps, d.captures)
              for name, d in decoders.items()}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    engine, policy, results, wall = run_once()
    counts = ops.counts()

    expect = expected_launches(bundles, wf, policy.placements, prompt_len,
                               gen_len)
    stages, problems = [], []
    for sid in wf.topo_order:
        if sid not in results:
            continue
        r = results[sid]
        toks = r.tokens_out
        v = bundles[r.model].cfg.vocab_size
        if tuple(toks.shape) != (nq, gen_len):
            problems.append(f"{sid}: tokens {tuple(toks.shape)}")
        elif int(toks.min()) < 0 or int(toks.max()) >= v:
            problems.append(f"{sid}: token ids outside [0, {v})")
        stages.append({"sid": sid, "model": r.model,
                       "arch": bundles[r.model].cfg.name,
                       "devices": list(r.device_ids),
                       "shards": [n for n in next(
                           p.shard_sizes for p in policy.placements
                           if p.sid == sid) if n],
                       "wall_s": r.wall_s,
                       "switched": r.switched, "prefix_hit": r.prefix_hit})
    if set(results) != set(wf.stages):
        problems.append(f"stages served: {sorted(results)}")
    for name, n in counts.items():
        if n != expect[name] or (expect[name] > 0 and n <= 0):
            problems.append(f"{name}: {n} launches, expected {expect[name]}")
    # every decode step ran as a graph replay, but the first of a shard
    # run whose (shard batch, max_len) key this run captured
    graphs = {}
    for name, d in decoders.items():
        replayed, eager, captured = (
            now - then for now, then in zip(
                (d.replays, d.eager_steps, d.captures), before[name]))
        steps = (gen_len - 1) * sum(
            1 for p in policy.placements if wf.stages[p.sid].model == name
            for n in p.shard_sizes if n)
        graphs[name] = {"keys": sorted(d.slots), "captured": captured,
                        "decode_steps_replayed": replayed,
                        "decode_steps_eager": eager, "decode_steps": steps}
        if replayed + eager != steps or eager != captured or not replayed:
            problems.append(f"{name}: {replayed} decode steps replayed and "
                            f"{eager} eager for {captured} captures, of "
                            f"{steps}")
    return {"engine": engine, "policy": policy, "results": results,
            "wall_s": wall, "launches": counts, "launches_expected": expect,
            "stages": stages, "decode_graphs": graphs, "problems": problems}


def phase_serve(mods, models: dict, seed: int, phase: str = "serve",
                prompt_len: int = PROMPT_LEN, reduced: dict | None = None,
                note: str = ""):
    """Serve the example's workflow with ``models`` = {served name:
    (config, weight seed)} at ``prompt_len`` (``serve_checked``); the
    launch counts must be what the placements call for, every kernel the
    models use launched at least once; a local/global model's ring and
    global caches must hold the rows their sizes call for.  ``reduced``
    names what was cut from a published config, and ``note`` what the
    engine does not pass a model, both printed on the phase's line."""
    t0 = time.perf_counter()
    bundles = {name: mods["ModelBundle"].create(name, cfg, seed=wseed)
               for name, (cfg, wseed) in models.items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # prompts drawn below the smallest vocabulary, so every model reads
    # them; each model's tokens are checked against its own vocabulary
    vocab = min(b.cfg.vocab_size for b in bundles.values())
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (NUM_QUERIES, prompt_len)))
    wf = mods["make_workflow"](NUM_QUERIES)
    run = serve_checked(mods, bundles, wf, prompts, prompt_len=prompt_len)
    policy, results, wall = run["policy"], run["results"], run["wall_s"]
    problems = run["problems"]
    cache_rows = {}
    for name, b in bundles.items():
        if b.cfg.local_global_pattern:
            cache_rows[name], bad = ring_and_global_rows(b, prompt_len)
            problems += [f"{name}: {x}" for x in bad]
    gen_tokens = len(wf.stages) * NUM_QUERIES * GEN_LEN
    out = {
        "phase": phase, "ok": not problems, "policy": "FATE",
        "models": {name: {"arch": b.cfg.name, "layers": b.cfg.num_layers,
                          "d_model": b.cfg.d_model, "dtype": b.cfg.dtype,
                          "vocab": b.cfg.vocab_size,
                          "params": sum(p.numel() for p in
                                        _tree_leaves(b.params))}
                   for name, b in bundles.items()},
        **({"reduced": reduced} if reduced else {}),
        **({"note": note} if note else {}),
        "queries": NUM_QUERIES, "virtual_devices": N_DEVICES,
        "prompt_len": prompt_len, "gen_len": GEN_LEN,
        "init_seconds": init_s, "stages": run["stages"],
        "workflow_wall_s": wall,
        "generated_tokens_per_s": gen_tokens / wall,
        "launches": run["launches"],
        "launches_expected": run["launches_expected"],
        "decode_graphs": run["decode_graphs"],
        **({"cache_rows": cache_rows} if cache_rows else {}),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "problems": problems,
    }
    emit(out)
    if problems:
        fail(f"{phase} phase failed: " + "; ".join(problems))
    return out, bundles, prompts, policy, results


# ---------------------------------------------------------------------------
# phase 5: control_plane
# ---------------------------------------------------------------------------


def phase_control_plane(mods, bundles, seed: int) -> dict:
    """Measure, fit, schedule: the example's workflow served on the card
    by the first serve phase's bundles at each (prompt, generated,
    queries) of CONTROL_RUNS under each policy of CONTROL_POLICIES, each
    run held to ``serve_checked``'s checks; the engines' observations
    fitted (``fit_profile``, CONTROL_TIME_SCALE); the ten workflow
    families and the Poisson serving trace scheduled on the card's host
    under FATE and the five baselines with the hand-set and with the
    fitted profile (``control_plane.schedule``: every executor invariant
    held, every workflow finished, every FATE solve optimal); and a
    one-replica gateway on a loopback port fed a trace over HTTP, whose
    fingerprint must equal a direct ``Scheduler`` run's.  A non-finite
    fitted coefficient fails the phase; FATE losing to RoundRobin does
    not."""
    cp = mods["control_plane"]
    t0 = time.perf_counter()
    vocab = min(b.cfg.vocab_size for b in bundles.values())
    runs, observations, problems = [], [], []
    launches = None
    for prompt_len, gen_len, nq in CONTROL_RUNS:
        prompts = torch.from_numpy(np.random.default_rng(
            seed + prompt_len).integers(0, vocab, (nq, prompt_len)))
        wf = mods["make_workflow"](nq)
        for pol in CONTROL_POLICIES:
            run = serve_checked(mods, bundles, wf, prompts, pol, prompt_len,
                                gen_len)
            tag = f"{pol} prompt {prompt_len} gen {gen_len} queries {nq}"
            problems += [f"{tag}: {x}" for x in run["problems"]]
            launches = {k: (launches or {}).get(k, 0) + n
                        for k, n in run["launches"].items()}
            obs = run["engine"].observations()
            observations += obs
            runs.append({
                "policy": pol, "prompt_len": prompt_len, "gen_len": gen_len,
                "queries": nq, "workflow_wall_s": run["wall_s"],
                "stages": [{k: st[k] for k in ("sid", "model", "shards",
                                               "wall_s", "switched",
                                               "prefix_hit")}
                           for st in run["stages"]],
                "observations": [[o.model, o.queries, o.switches,
                                  o.prefix_fraction, o.wall_s] for o in obs],
                "launches": {k: n for k, n in run["launches"].items() if n},
                "launches_expected": {
                    k: n for k, n in run["launches_expected"].items() if n},
                "decode_graphs": {
                    name: [g["decode_steps_replayed"],
                           g["decode_steps_eager"], g["captured"]]
                    for name, g in run["decode_graphs"].items()}})
    measure_s = time.perf_counter() - t0
    profile = mods["fit_profile"](observations,
                                  time_scale=CONTROL_TIME_SCALE)
    fit = cp.fit_summary(profile)
    problems += [f"fit {fam}: a coefficient is not finite"
                 for fam, f in fit.items() if not f["finite"]]
    t1 = time.perf_counter()
    schedules = {label: cp.schedule(cal)["summary"]
                 for label, cal in (("hand_set", None), ("fitted", profile))}
    for label, summary in schedules.items():
        problems += [f"{label}: {x}" for x in summary["problems"]]
    schedule_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    trace = mods["suites"].poisson_serving_trace(
        n_workflows=CONTROL_GATEWAY_WORKFLOWS, rate=6.0, seed=seed,
        num_queries=4)
    gateway = cp.gateway_parity(
        trace, mods["homogeneous_cluster"](CONTROL_GATEWAY_DEVICES),
        mods["SchedulerConfig"](policy="FATE", calibration=profile))
    if not gateway["match"]:
        problems.append(f"gateway fingerprint {gateway['http_fingerprint']}"
                        f" != direct {gateway['fingerprint']}")
    gateway_s = time.perf_counter() - t2
    fate_vs_rr = {label: {
        "batch_norm_ms": sm["batch"]["FATE"]["norm_ms"],
        "batch_norm_p95": sm["batch"]["FATE"]["norm_p95"],
        "serving_norm_ms": sm["serving"]["FATE"]["norm_ms"],
        "serving_norm_p95": sm["serving"]["FATE"]["norm_p95"],
        "solve_ms": {k: [v["mean_ms"], v["max_ms"], v["solves"],
                         v["all_optimal"]]
                     for k, v in sm["fate_solves"].items()}}
        for label, sm in schedules.items()}
    out = {
        "phase": "control_plane", "ok": not problems,
        "models": {name: b.cfg.name for name, b in bundles.items()},
        "runs": runs, "launches": launches,
        "observations_per_family": {
            fam: sum(o.family == fam for o in observations)
            for fam in sorted({o.family for o in observations})},
        "time_scale": CONTROL_TIME_SCALE, "fit": fit,
        "fate_vs_round_robin": fate_vs_rr, "schedules": schedules,
        "gateway": gateway,
        "seconds": {"measure": measure_s, "schedule": schedule_s,
                    "gateway": gateway_s,
                    "total": time.perf_counter() - t0},
        "problems": problems,
    }
    emit(out)
    if problems:
        fail("control_plane phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 4: parity
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_versions(ops, ref, names=None, plain=None):
    """Swap the plain versions in for the kernels' wrappers (all of them,
    or those ``names``): ``ref.<name>_ref``, or ``ref.<plain[name]>``."""
    saved = {name: getattr(ops, name) for name in (names or ops.KERNELS)}
    for name in saved:
        setattr(ops, name, getattr(ref, (plain or {}).get(name,
                                                          name + "_ref")))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def teacher_forced(bundle, shard, served, frames=None) -> torch.Tensor:
    """Logits of prefill (with an encoder-decoder model's ``frames``) and
    GEN_LEN - 1 decode steps fed the served tokens, so that two runs see
    the same inputs at every step."""
    model = bundle._model
    nq, plen = shard.shape
    cache = model.init_cache(nq, plen + GEN_LEN)
    logits, cache = model.prefill(bundle.params, shard, cache, frames)
    all_logits = [logits]
    for step in range(GEN_LEN - 1):
        logits, cache = model.decode_step(
            bundle.params, served[:, step: step + 1], cache,
            plen + step)
        all_logits.append(logits)
    return torch.cat(all_logits, dim=1).float()


@contextlib.contextmanager
def held_routing(moe_mod, log: list, stats=None):
    """With ``stats`` None, record every MoE layer's expert choice into
    ``log``; else replay them in order, counting in ``stats`` the routing
    decisions (token, layer) whose own top-k differs from the held one."""
    route = moe_mod.route
    held = iter(log)

    def recording(p, cfg, x, experts=None):
        gates, chosen = route(p, cfg, x)
        log.append(chosen)
        return gates, chosen

    def replaying(p, cfg, x, experts=None):
        chosen = next(held)
        own = route(p, cfg, x)[1]
        stats["decisions"] += own.numel() // own.shape[-1]
        stats["flipped"] += int((torch.sort(own, -1).values
                                 != torch.sort(chosen, -1).values)
                                .any(-1).sum())
        return route(p, cfg, x, experts=chosen)

    moe_mod.route = recording if stats is None else replaying
    try:
        yield
    finally:
        moe_mod.route = route


def agreement(kernel_logits, plain_logits) -> dict:
    k_tok, p_tok = kernel_logits.argmax(-1), plain_logits.argmax(-1)
    return {
        "max_logit_diff": float((kernel_logits - plain_logits).abs().max()),
        "greedy_tokens_agree": bool((k_tok == p_tok).all()),
        "greedy_token_agreement": float((k_tok == p_tok).float().mean()),
    }


def kernel_vs_plain(ops, ref, bundle, shard, served, moe_mod=None,
                    frames=None) -> dict:
    """Teacher-forced logits with the kernels, then with the plain
    versions.  For an MoE model (``moe_mod`` given) also a second plain
    run held to the kernel run's routing: a top-k choice flips under
    differences far below the kernels' tolerances, and one flip changes
    a token's FFN, so only the held run compares the kernels' arithmetic
    alone; the flips are counted."""
    log = []
    with (held_routing(moe_mod, log) if moe_mod is not None
          else contextlib.nullcontext()):
        kernel_logits = teacher_forced(bundle, shard, served, frames)
    with plain_versions(ops, ref):
        plain_logits = teacher_forced(bundle, shard, served, frames)
        if moe_mod is not None:
            stats = {"decisions": 0, "flipped": 0}
            with held_routing(moe_mod, log, stats):
                held_logits = teacher_forced(bundle, shard, served)
    torch.cuda.synchronize()
    out = {
        "arch": bundle.cfg.name, "layers": bundle.cfg.num_layers,
        "dtype": bundle.cfg.dtype, "queries": int(shard.shape[0]),
        "steps": GEN_LEN,
        **agreement(kernel_logits, plain_logits),
        "logit_abs_max": float(kernel_logits.abs().max()),
        "finite": bool(torch.isfinite(kernel_logits).all()),
        "kernel_path_reproduces_served_tokens":
            bool((kernel_logits.argmax(-1) == served).all()),
    }
    if moe_mod is not None:
        out["routing_held"] = {**agreement(kernel_logits, held_logits),
                               "routing_decisions": stats["decisions"],
                               "flipped_when_free": stats["flipped"]}
    return out


def swapped_alone(ops, ref, moe_mod, bundle, shard, served) -> dict:
    """Max logit difference, routing held, when only one kernel at a time
    is replaced by its plain version: where a whole-model difference
    comes from."""
    log = []
    with held_routing(moe_mod, log):
        kernel_logits = teacher_forced(bundle, shard, served)
    out = {}
    for name in ("flash_attention", "decode_attention", "moe_gemm"):
        stats = {"decisions": 0, "flipped": 0}
        with plain_versions(ops, ref, [name]), \
                held_routing(moe_mod, log, stats):
            logits = teacher_forced(bundle, shard, served)
        out[name] = float((logits - kernel_logits).abs().max())
    return out


def layerwise(ops, ref, moe_mod, bundle, shard, served,
              frames=None) -> dict:
    """Every layer of a DecoderLM run twice on the same input: with the
    kernels, and with the plain versions under the same routing (an MoE
    model's, ``moe_mod`` given).  The largest difference of the layer's
    update (its output less its input) relative to that update's largest
    magnitude, over the layers, the prefill (with a VLM's image
    embeddings, ``frames``) and every decode step.  The plain call writes
    the same cache rows again: the projections that fill them use no
    kernel."""
    model = bundle._model
    block = model._block
    worst = {"max_rel_update_diff": 0.0, "layer_calls": 0}
    hold = lambda log, stats=None: (
        held_routing(moe_mod, log, stats) if moe_mod is not None
        else contextlib.nullcontext())

    def checked(p, x, positions, **kw):
        log = []
        with hold(log):
            out, new_cache = block(p, x, positions, **kw)
        stats = {"decisions": 0, "flipped": 0}
        with plain_versions(ops, ref), hold(log, stats):
            plain, _ = block(p, x, positions, **kw)
        upd = (out - x).float()
        rel = float((plain.float() - out.float()).abs().max()) / max(
            1e-30, float(upd.abs().max()))
        worst["max_rel_update_diff"] = max(worst["max_rel_update_diff"],
                                           rel)
        worst["layer_calls"] += 1
        return out, new_cache

    model._block = checked
    try:
        teacher_forced(bundle, shard, served, frames)
    finally:
        del model._block
    return worst


def hybrid_layerwise(ops, ref, bundle, shard, served) -> dict:
    """Every block of a Mamba2Hybrid run twice on the same input: with the
    kernels, and with the plain versions.  Per kind of block, the largest
    difference of the two outputs relative to the largest magnitude of
    the block's update (output less input) and of its output, over the
    prefill and every decode step (a Mamba2 block reaches its kernel at
    prefill only).  In bf16 the output is the residual sum rounded once,
    so one rounding step there (2**-8 of the output) can be a large share
    of a small update.  The plain call of an attention block writes the
    same cache rows again: the projections that fill them use no
    kernel."""
    model = bundle._model
    ssm_block, attn_block = model._ssm_block, model._attn_block
    worst = {kind: {"rel_to_update": 0.0, "rel_to_output": 0.0}
             for kind in ("mamba2", "attention")}
    worst["block_calls"] = 0

    def note(kind, x, out, plain):
        diff = float((plain.float() - out.float()).abs().max())
        w = worst[kind]
        w["rel_to_update"] = max(w["rel_to_update"], diff / max(
            1e-30, float((out - x).float().abs().max())))
        w["rel_to_output"] = max(w["rel_to_output"], diff / max(
            1e-30, float(out.float().abs().max())))
        worst["block_calls"] += 1

    def checked_ssm(p, x, state, decode):
        out, new = ssm_block(p, x, state, decode)
        with plain_versions(ops, ref):
            plain, _ = ssm_block(p, x, state, decode)
        note("mamba2", x, out, plain)
        return out, new

    def checked_attn(p, x, positions, cache, cache_len):
        out = attn_block(p, x, positions, cache, cache_len)
        with plain_versions(ops, ref):
            plain = attn_block(p, x, positions, cache, cache_len)
        note("attention", x, out, plain)
        return out

    model._ssm_block, model._attn_block = checked_ssm, checked_attn
    try:
        teacher_forced(bundle, shard, served)
    finally:
        del model._ssm_block, model._attn_block
    return worst


def encdec_layerwise(ops, ref, bundle, shard, served, frames) -> dict:
    """Every encoder and decoder block of an EncDecLM run twice on the
    same input: with the kernels, and with the plain versions.  Per kind
    of block, the largest difference of the two outputs relative to the
    largest magnitude of the block's update (output less input), over
    the prefill and every decode step.  The plain call of a decoder
    block writes the same cache rows again: the projections that fill
    them use no kernel."""
    model = bundle._model
    enc_block, dec_block = model._enc_block, model._dec_block
    worst = {"encoder": 0.0, "decoder": 0.0, "block_calls": 0}

    def note(kind, x, out, plain):
        worst[kind] = max(worst[kind], float(
            (plain.float() - out.float()).abs().max()) / max(
            1e-30, float((out - x).float().abs().max())))
        worst["block_calls"] += 1

    def checked_enc(p, x, positions):
        out = enc_block(p, x, positions)
        with plain_versions(ops, ref):
            note("encoder", x, out, enc_block(p, x, positions))
        return out

    def checked_dec(p, x, *args):
        out = dec_block(p, x, *args)
        with plain_versions(ops, ref):
            note("decoder", x, out, dec_block(p, x, *args))
        return out

    model._enc_block, model._dec_block = checked_enc, checked_dec
    try:
        teacher_forced(bundle, shard, served, frames)
    finally:
        del model._enc_block, model._dec_block
    return worst


def first_shard(placements, wf, prompts, results, model: str):
    """The sid, prompts and served tokens of the first shard ``model``
    served (a stage's first non-empty shard takes its first queries)."""
    p = next(p for p in placements if wf.stages[p.sid].model == model)
    nq = next(n for n in p.shard_sizes if n)
    return p.sid, prompts[:nq].to("cuda"), results[p.sid].tokens_out[:nq]


@torch.inference_mode()
def phase_parity(mods, bundles, prompts, policy, results, wf) -> dict:
    ops, ref = mods["ops"], mods["ref"]
    first = policy.placements[0]
    model = wf.stages[first.sid].model
    sid, shard, served = first_shard(policy.placements, wf, prompts,
                                     results, model)
    out = {"phase": "parity", "stage": sid,
           **kernel_vs_plain(ops, ref, bundles[model], shard, served),
           "tol": PARITY_LOGIT_TOL}
    # the second check is deterministic: the same kernels on the same
    # inputs as the serve phase must give the tokens it served
    out["ok"] = (out["finite"] and out["max_logit_diff"] < PARITY_LOGIT_TOL
                 and out["kernel_path_reproduces_served_tokens"])
    emit(out)
    if not out["ok"]:
        fail("parity phase failed: kernels and plain versions disagree, "
             "or the kernel path does not reproduce the served tokens")
    return out


def whole_model_f32(rec: dict, held: bool = False) -> dict:
    """``rec`` (``kernel_vs_plain`` on a float32 model whose attention
    projections are at 1 / sqrt(d)) with its init and the whole model's
    float32 bars, those ROADMAP H25 adds beside the per-layer and
    per-block gates at the reference's init: logits within PARITY_F32_REL
    of their largest magnitude, every greedy token equal (``held``: of the
    plain run held to the kernel run's routing)."""
    got = rec["routing_held"] if held else rec
    tol = PARITY_F32_REL * rec["logit_abs_max"]
    return {**rec, "init": INIT_LABEL[attention_at_input_width], "tol": tol,
            "within_the_bars": rec["finite"] and got["max_logit_diff"] <= tol
            and got["greedy_tokens_agree"]}


@torch.inference_mode()
def phase_parity_moe_rwkv(mods, bundles, prompts, policy, results, wf,
                          seed: int) -> dict:
    """Per model: bf16 at full depth (gates: finite logits, the served
    tokens reproduced; the logit difference and greedy agreement are
    reported: one flipped top-8 routing choice changes a token's FFN),
    then float32 at full width and PARITY_F32_LAYERS layers (gates:
    logits within PARITY_F32_REL of their largest magnitude and every
    greedy token equal; for an MoE model, whose random weights amplify
    any difference several-fold per layer, every layer's update within
    PARITY_F32_REL of its magnitude on the same input and every greedy
    token equal under the kernel run's routing, with the whole-model
    numbers reported beside them; and the same cut model with its
    attention projections at 1 / sqrt(d), ``whole_model_f32``'s bars under
    the kernel run's routing: ROADMAP H25)."""
    ops, ref = mods["ops"], mods["ref"]
    out, problems = {"phase": "parity_moe_rwkv"}, []
    for name, bundle in bundles.items():
        sid, shard, served = first_shard(policy.placements, wf, prompts,
                                         results, name)
        moe_mod = mods["moe"] if bundle.cfg.moe is not None else None
        bf16 = kernel_vs_plain(ops, ref, bundle, shard, served, moe_mod)
        if not (bf16["finite"]
                and bf16["kernel_path_reproduces_served_tokens"]):
            problems.append(f"{bundle.cfg.name} bf16: logits not finite or "
                            f"served tokens not reproduced")
        cfg32 = dataclasses.replace(bundle.cfg, dtype="float32",
                                    num_layers=PARITY_F32_LAYERS)
        b32 = mods["ModelBundle"].create(name, cfg32, seed=seed + 7)
        f32 = kernel_vs_plain(ops, ref, b32, shard, served, moe_mod)
        if moe_mod is None:
            f32["tol"] = PARITY_F32_REL * f32["logit_abs_max"]
            ok = (f32["max_logit_diff"] <= f32["tol"]
                  and f32["greedy_tokens_agree"])
        else:
            # the model amplifies any difference several-fold per layer,
            # so the kernels are held to each layer's own update; the
            # greedy tokens to the end, under the kernel run's routing
            f32["swapped_alone_max_logit_diff"] = swapped_alone(
                ops, ref, moe_mod, b32, shard, served)
            f32["layerwise"] = layerwise(ops, ref, moe_mod, b32, shard,
                                         served)
            f32["tol"] = PARITY_F32_REL
            ok = (f32["layerwise"]["max_rel_update_diff"] <= f32["tol"]
                  and f32["routing_held"]["greedy_tokens_agree"])
        del b32
        if not (f32["finite"] and ok):
            problems.append(f"{cfg32.name} float32: kernels and plain "
                            f"versions differ beyond {f32['tol']} "
                            f"or greedy tokens differ")
        out[name] = {"stage": sid, "bf16_full_depth": bf16,
                     "float32_cut_depth": f32}
        if moe_mod is not None:
            # the same cut model with the attention projections at
            # 1 / sqrt(d) (ROADMAP H25): the whole model's bars, under the
            # kernel run's routing
            b32 = mods["ModelBundle"].create(name, cfg32, seed=seed + 7)
            attention_at_input_width(b32.params)
            r = whole_model_f32(kernel_vs_plain(ops, ref, b32, shard, served,
                                                moe_mod), held=True)
            del b32
            if not r["within_the_bars"]:
                problems.append(f"{cfg32.name} float32 ({r['init']}): the "
                                f"whole model beyond its bars")
            out[name]["float32_cut_depth_attention_at_input_width"] = r
    out["ok"] = not problems
    out["problems"] = problems
    emit(out)
    if problems:
        fail("parity_moe_rwkv phase failed: " + "; ".join(problems))
    return out


@torch.inference_mode()
def phase_parity_hybrid(mods, bundles, prompts, policy, results, wf,
                        seed: int) -> dict:
    """The hybrid, served as "qwen-7b": bf16 at full depth (gates: finite logits, the
    served tokens reproduced, each block's difference within
    HYBRID_BF16_BLOCK_REL of its output; the logit difference and greedy
    agreement are reported), then float32 at full width and HYBRID_F32_LAYERS
    layers (gates: logits within PARITY_F32_REL of their largest
    magnitude and every greedy token equal).  Beside both, each block's
    own difference on the same input (``hybrid_layerwise``): where the
    whole model's kernel and plain runs part, it tells a kernel that
    disagrees from a model that amplifies agreeing blocks' roundings.
    Both again with the attention projections at 1 / sqrt(d) (ROADMAP
    H25): the cut model in float32 gated on ``whole_model_f32``'s bars,
    the served weights so rescaled in bf16 at full depth reported."""
    ops, ref = mods["ops"], mods["ref"]
    name = "qwen-7b"
    bundle = bundles[name]
    sid, shard, served = first_shard(policy.placements, wf, prompts,
                                     results, name)
    problems = []
    bf16 = kernel_vs_plain(ops, ref, bundle, shard, served)
    bf16["layerwise"] = hybrid_layerwise(ops, ref, bundle, shard, served)
    bf16["block_tol"] = HYBRID_BF16_BLOCK_REL
    if not (bf16["finite"] and bf16["kernel_path_reproduces_served_tokens"]):
        problems.append(f"{bundle.cfg.name} bf16: logits not finite or "
                        f"served tokens not reproduced")
    for kind in ("mamba2", "attention"):
        if bf16["layerwise"][kind]["rel_to_output"] > HYBRID_BF16_BLOCK_REL:
            problems.append(f"{bundle.cfg.name} bf16: a {kind} block's "
                            f"kernel and plain outputs differ beyond "
                            f"{HYBRID_BF16_BLOCK_REL} of its output")
    cfg32 = dataclasses.replace(bundle.cfg, dtype="float32",
                                num_layers=HYBRID_F32_LAYERS)
    b32 = mods["ModelBundle"].create(name, cfg32, seed=seed + 7)
    f32 = kernel_vs_plain(ops, ref, b32, shard, served)
    f32["attention_sites"] = b32._model.n_attn
    f32["tol"] = PARITY_F32_REL * f32["logit_abs_max"]
    f32["layerwise"] = hybrid_layerwise(ops, ref, b32, shard, served)
    del b32
    if not (f32["finite"] and f32["max_logit_diff"] <= f32["tol"]
            and f32["greedy_tokens_agree"]):
        problems.append(f"{cfg32.name} float32: kernels and plain versions "
                        f"differ beyond {f32['tol']} or greedy tokens "
                        f"differ")
    # both again with the attention projections at 1 / sqrt(d) (ROADMAP
    # H25): the cut model in float32, with each block's difference beside,
    # held to the whole model's bars; the served weights so rescaled in
    # bf16 at full depth, whose whole-model reading is reported against
    # the parity phase's PARITY_LOGIT_TOL and not gated: it did not hold
    # (0.211, greedy agreement 0.85, each block within
    # HYBRID_BF16_BLOCK_REL of its output; seed 0 on an H100 80GB HBM3 at
    # 700 W)
    b_r = mods["ModelBundle"].create(name, bundle.cfg, seed=seed)
    attention_at_input_width(b_r.params)
    r = kernel_vs_plain(ops, ref, b_r, shard, served)
    del b_r
    torch.cuda.empty_cache()
    bf16_rescaled = {**r, "init": INIT_LABEL[attention_at_input_width],
                     "tol": PARITY_LOGIT_TOL,
                     "within_the_bars": r["finite"]
                     and r["max_logit_diff"] < PARITY_LOGIT_TOL}
    b_r = mods["ModelBundle"].create(name, cfg32, seed=seed + 7)
    attention_at_input_width(b_r.params)
    f32_rescaled = whole_model_f32(kernel_vs_plain(ops, ref, b_r, shard,
                                                   served))
    f32_rescaled["layerwise"] = hybrid_layerwise(ops, ref, b_r, shard,
                                                 served)
    del b_r
    if not f32_rescaled["within_the_bars"]:
        problems.append(f"{cfg32.name} float32 ({f32_rescaled['init']}): "
                        f"the whole model beyond its bars")
    out = {"phase": "parity_hybrid", "ok": not problems,
           name: {"stage": sid, "bf16_full_depth": bf16,
                  "float32_cut_depth": f32,
                  "bf16_full_depth_attention_at_input_width": bf16_rescaled,
                  "float32_cut_depth_attention_at_input_width":
                      f32_rescaled},
           "problems": problems}
    emit(out)
    if problems:
        fail("parity_hybrid phase failed: " + "; ".join(problems))
    return out


@torch.inference_mode()
def phase_parity_gemma3(mods, bundles, prompts, policy, results, wf,
                        seed: int) -> dict:
    """gemma3, served as "qwen-7b", its first served shard teacher-forced
    at int positions with the kernels and with the plain versions: in
    bf16 at full depth (gates: finite logits, the served tokens
    reproduced by the kernel path; the logit difference and greedy
    agreement are reported), then in float32 at full width and
    GEMMA_F32_LAYERS layers, five local and one global (gates: logits
    within PARITY_F32_REL of their largest magnitude and every greedy
    token equal)."""
    ops, ref = mods["ops"], mods["ref"]
    name = "qwen-7b"
    bundle = bundles[name]
    sid, shard, served = first_shard(policy.placements, wf, prompts,
                                     results, name)
    problems = []
    bf16 = kernel_vs_plain(ops, ref, bundle, shard, served)
    if not (bf16["finite"] and bf16["kernel_path_reproduces_served_tokens"]):
        problems.append(f"{bundle.cfg.name} bf16: logits not finite or "
                        f"served tokens not reproduced")
    cfg32 = dataclasses.replace(bundle.cfg, dtype="float32",
                                num_layers=GEMMA_F32_LAYERS)
    b32 = mods["ModelBundle"].create(name, cfg32, seed=seed + 7)
    f32 = kernel_vs_plain(ops, ref, b32, shard, served)
    f32["layer_kinds"] = "".join(b32._model.layer_kinds())
    f32["tol"] = PARITY_F32_REL * f32["logit_abs_max"]
    del b32
    if not (f32["finite"] and f32["max_logit_diff"] <= f32["tol"]
            and f32["greedy_tokens_agree"]):
        problems.append(f"{cfg32.name} float32: kernels and plain versions "
                        f"differ beyond {f32['tol']} or greedy tokens "
                        f"differ")
    out = {"phase": "parity_gemma3", "ok": not problems,
           name: {"stage": sid, "prompt_len": int(shard.shape[1]),
                  "bf16_full_depth": bf16, "float32_cut_depth": f32},
           "problems": problems}
    emit(out)
    if problems:
        fail("parity_gemma3 phase failed: " + "; ".join(problems))
    return out


@torch.inference_mode()
def phase_parity_deepseek(mods, bundles, prompts, policy, results, wf,
                          seed: int) -> dict:
    """deepseek-v2, served as "qwen-7b", its first served shard
    teacher-forced at int positions with the kernels and with the plain
    versions: in bf16 at the served depth, with a plain run held to the
    kernel run's routing as for granite (gates: finite logits, the served
    tokens reproduced by the kernel path; the logit differences and greedy
    agreement, routing free and held, are reported); then, with the served
    bundles freed, in float32 at full width and DEEPSEEK_F32_LAYERS layers,
    the dense one and one MoE layer (gates, as granite's: every layer's
    update within PARITY_F32_REL of its magnitude on the same input, and
    every greedy token equal under the kernel run's routing; the whole
    model's numbers are reported beside them)."""
    ops, ref, moe_mod = mods["ops"], mods["ref"], mods["moe"]
    name = "qwen-7b"
    bundle = bundles[name]
    sid, shard, served = first_shard(policy.placements, wf, prompts,
                                     results, name)
    problems = []
    bf16 = kernel_vs_plain(ops, ref, bundle, shard, served, moe_mod)
    if not (bf16["finite"] and bf16["kernel_path_reproduces_served_tokens"]):
        problems.append(f"{bundle.cfg.name} bf16: logits not finite or "
                        f"served tokens not reproduced")
    cfg32 = dataclasses.replace(bundle.cfg, dtype="float32",
                                num_layers=DEEPSEEK_F32_LAYERS)
    del bundle
    bundles.clear()             # the served weights (42.5 GB) go first
    gc.collect()
    torch.cuda.empty_cache()
    b32 = mods["ModelBundle"].create(name, cfg32, seed=seed + 7)
    f32 = kernel_vs_plain(ops, ref, b32, shard, served, moe_mod)
    f32["layerwise"] = layerwise(ops, ref, moe_mod, b32, shard, served)
    f32["tol"] = PARITY_F32_REL
    del b32
    if not (f32["finite"]
            and f32["layerwise"]["max_rel_update_diff"] <= f32["tol"]
            and f32["routing_held"]["greedy_tokens_agree"]):
        problems.append(f"{cfg32.name} float32: a layer's kernel and plain "
                        f"updates differ beyond {f32['tol']} or greedy "
                        f"tokens differ under held routing")
    out = {"phase": "parity_deepseek", "ok": not problems,
           name: {"stage": sid, "bf16_served_depth": bf16,
                  "float32_cut_depth": f32},
           "problems": problems}
    emit(out)
    if problems:
        fail("parity_deepseek phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# llava_image, parity_qwen15_llava
# ---------------------------------------------------------------------------


def llava_inputs(cfg, seed: int):
    """NUM_QUERIES prompts of LLAVA_PROMPT_LEN tokens and their image
    embeddings [NUM_QUERIES, num_patches, d] in bf16 (the reference's stub
    vision frontend: seeded random embeddings), on the card."""
    rng = np.random.default_rng(seed + 11)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (NUM_QUERIES, LLAVA_PROMPT_LEN))).to("cuda")
    embeds = randn(rng, (NUM_QUERIES, cfg.num_patches, cfg.d_model),
                   torch.bfloat16)
    return prompts, embeds


@torch.inference_mode()
def phase_llava_image(mods, bundle, seed: int):
    """llava-next-mistral-7b with image embeddings, which the serving
    engine does not pass (as the reference's does not): its bundle from
    serve_qwen15_llava, weights and decode graphs shared, through
    ``DecodeGraphs.generate`` on ``llava_inputs`` (the embeddings replace
    the prompt's first num_patches positions), held as
    ``checked_generate`` holds it: K1 once per layer at the prefill, K2
    once per layer at each decode step, every step a replay, bitwise the
    eager ones.  The same prompts without the embeddings must serve other
    tokens.  Prefill seconds, decode ms per replayed step beside the
    weights' bound and the cache's, peak memory."""
    cfg = bundle.cfg
    prompts, embeds = llava_inputs(cfg, seed)
    run, tokens, problems = checked_generate(mods, bundle, prompts, embeds)
    plain_tokens, _ = bundle.decoder.generate(prompts, GEN_LEN,
                                              run["max_len"])
    changed = not torch.equal(plain_tokens, tokens)
    if not changed:
        problems.append("the image embeddings do not change the tokens")
    kv_bytes = (2 * cfg.num_layers * NUM_QUERIES * run["max_len"]
                * cfg.num_kv_heads * cfg.resolved_head_dim
                * torch.finfo(getattr(torch, cfg.dtype)).bits // 8)
    out = {
        "phase": "llava_image", "ok": not problems,
        "model": {"arch": cfg.name, "layers": cfg.num_layers,
                  "d_model": cfg.d_model, "heads": cfg.num_heads,
                  "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
                  "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                  "params": sum(x.numel() for x in _tree_leaves(
                      bundle.params))},
        "image_positions": cfg.num_patches,
        "text_positions": LLAVA_PROMPT_LEN - cfg.num_patches,
        "note": "the bundle served by serve_qwen15_llava; the engine "
                "passes no image embeddings, so they go in here through "
                "the model's decode graphs",
        **run,
        "weights_bound_ms": weight_bytes(bundle) / HBM_BYTES_PER_S * 1e3,
        "cache_bound_ms": kv_bytes / HBM_BYTES_PER_S * 1e3,
        "image_embeddings_change_tokens": changed,
        "problems": problems,
    }
    emit(out)
    if problems:
        fail("llava_image phase failed: " + "; ".join(problems))
    return out, {"prompts": prompts, "embeds": embeds, "tokens": tokens}


@torch.inference_mode()
def phase_parity_qwen15_llava(mods, bundles, prompts, policy, results, wf,
                              image: dict, seed: int) -> dict:
    """Per model of serve_qwen15_llava, its first served shard, and for
    llava also llava_image's prompts with their image embeddings (``image``),
    teacher-forced at int positions with the kernels and with the plain
    versions: in bf16 at full depth (gates: finite logits, the served
    tokens reproduced by the kernel path; the logit difference, the
    greedy agreement and the first layer's ``score_std`` reported); in
    float32 at full width and PARITY_F32_LAYERS layers from the
    reference's init (gate: every layer's update within PARITY_F32_REL of
    its magnitude on the same input, ``layerwise``; the whole model's
    numbers reported: the init draws the projections at 1 / sqrt(heads)
    and saturates the softmax, ROADMAP H25) and with the attention
    projections at 1 / sqrt(d) (gates, as parity_whisper's: logits within
    PARITY_F32_REL of their largest magnitude, every greedy token
    equal)."""
    ops, ref = mods["ops"], mods["ref"]
    out, problems = {"phase": "parity_qwen15_llava"}, []
    for name, bundle in bundles.items():
        sid, shard, served = first_shard(policy.placements, wf, prompts,
                                         results, name)
        cases = {"served_shard": (shard, served, None)}
        if bundle.cfg.family == "vlm":
            cases["image_prompt"] = (image["prompts"], image["tokens"],
                                     image["embeds"])
        rec = {"stage": sid}
        for case, (toks, done, embeds) in cases.items():
            bf16 = kernel_vs_plain(ops, ref, bundle, toks, done,
                                   frames=embeds)
            bf16["score_std"] = decoder_score_std(bundle, toks, embeds)
            if not (bf16["finite"]
                    and bf16["kernel_path_reproduces_served_tokens"]):
                problems.append(f"{bundle.cfg.name} bf16 ({case}): logits "
                                f"not finite or served tokens not "
                                f"reproduced")
            rec[case] = {"prompt_len": int(toks.shape[1]),
                         "bf16_full_depth": bf16}
        cfg32 = dataclasses.replace(bundle.cfg, dtype="float32",
                                    num_layers=PARITY_F32_LAYERS)
        for init in (None, attention_at_input_width):
            b32 = mods["ModelBundle"].create(name, cfg32, seed=seed + 7)
            if init is not None:
                init(b32.params)
            for case, (toks, done, embeds) in cases.items():
                e32 = None if embeds is None else embeds.float()
                r = kernel_vs_plain(ops, ref, b32, toks, done, frames=e32)
                r["init"] = INIT_LABEL[init]
                r["score_std"] = decoder_score_std(b32, toks, e32)
                if init is None:
                    r["layerwise"] = layerwise(ops, ref, None, b32, toks,
                                               done, e32)
                    r["tol"] = PARITY_F32_REL
                    ok = r["layerwise"]["max_rel_update_diff"] <= r["tol"]
                else:
                    r = whole_model_f32(r)
                    ok = r["within_the_bars"]
                if not (r["finite"] and ok):
                    problems.append(f"{cfg32.name} float32 ({case}, "
                                    f"{r['init']} init): kernels and plain "
                                    f"versions differ beyond {r['tol']}")
                key = ("float32_cut_depth" if init is None
                       else "float32_cut_depth_attention_at_input_width")
                rec[case][key] = r
            del b32
            torch.cuda.empty_cache()
        out[name] = rec
    out["ok"], out["problems"] = not problems, problems
    emit(out)
    if problems:
        fail("parity_qwen15_llava phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# whisper, parity_whisper: whisper-small's encoder-decoder
# ---------------------------------------------------------------------------


def whisper_inputs(cfg, seed: int):
    """The decoder prompts [8, WHISPER_PROMPT_LEN] and the frames [8,
    encoder_frames, d] (the reference's stub conv frontend: seeded random
    embeddings), on the card."""
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (NUM_QUERIES, WHISPER_PROMPT_LEN))).to("cuda")
    frames = randn(rng, (NUM_QUERIES, cfg.encoder_frames, cfg.d_model),
                   getattr(torch, cfg.dtype))
    return prompts, frames


def generate_launches(cfg) -> dict:
    """Kernel launches of one ``DecodeGraphs.generate`` call: K1 at the
    prefill once per layer and K2 once per layer at each of the GEN_LEN - 1
    decode steps; for an encoder-decoder, K1 at the prefill once per
    encoder layer (bidirectional) and twice per decoder layer (causal
    self-attention, cross-attention over the frames), K2 at each decode
    step twice per decoder layer (the self cache, the cross K/V)."""
    exp = no_launches()
    exp["flash_attention"] = len(layer_kinds(cfg))
    per_step = 2 if cfg.family == "audio" else 1
    exp["decode_attention"] = per_step * cfg.num_layers * (GEN_LEN - 1)
    return exp


def seconds(fn, repeats: int = 3) -> float:
    """Mean wall seconds of ``fn`` over ``repeats`` synchronised calls."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(repeats):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / repeats


def checked_generate(mods, bundle, prompts, extra=None):
    """GEN_LEN tokens of ``prompts`` (with ``extra``, an encoder-decoder's
    frames or a VLM's image embeddings) through the bundle's
    ``DecodeGraphs.generate``: a warm-up pass that captures the key's
    graph, then the measured pass with the launch counts zeroed just
    before it, which must launch ``generate_launches`` and run every
    decode step as a replay; then the prefill (the mean of three calls)
    and the replayed steps timed, and the replayed steps held bitwise to
    the eager ones and to the served tokens.  Returns the line's fields,
    the served tokens and the problems."""
    ops, cfg, dec = mods["ops"], bundle.cfg, bundle.decoder
    nq, plen = prompts.shape
    max_len = plen + GEN_LEN
    dec.generate(prompts, GEN_LEN, max_len, extra)         # captures
    before = (dec.replays, dec.eager_steps, dec.captures)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    tokens, _ = dec.generate(prompts, GEN_LEN, max_len, extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.counts()
    peak = torch.cuda.max_memory_allocated()
    replayed, eager, captured = (now - then for now, then in zip(
        (dec.replays, dec.eager_steps, dec.captures), before))
    expect = generate_launches(cfg)
    problems = []
    if tuple(tokens.shape) != (nq, GEN_LEN) or \
            int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        problems.append(f"tokens {tuple(tokens.shape)} outside [0, "
                        f"{cfg.vocab_size})")
    for name, n in counts.items():
        if n != expect[name] or (expect[name] > 0 and n <= 0):
            problems.append(f"{name}: {n} launches, expected {expect[name]}")
    if (replayed, eager, captured) != (GEN_LEN - 1, 0, 0):
        problems.append(f"{replayed} decode steps replayed and {eager} "
                        f"eager, {captured} captures, in the measured pass")
    slot = dec.slot(nq, max_len)
    prefill_s = seconds(lambda: slot.prefill(prompts, extra))
    decode_s = seconds(lambda: [slot.replay() for _ in range(GEN_LEN - 1)],
                       repeats=1)
    slot.prefill(prompts, extra)
    replays = []
    for _ in range(GEN_LEN - 1):
        slot.replay()
        replays.append(slot.graph_logits.clone())
    graph_tokens = slot.tokens[:, plen:].clone()
    slot.prefill(prompts, extra)
    eager_logits = [slot.step().clone() for _ in range(GEN_LEN - 1)]
    bitwise = (all(torch.equal(a, b) for a, b in zip(replays, eager_logits))
               and torch.equal(slot.tokens[:, plen:], graph_tokens)
               and torch.equal(graph_tokens, tokens))
    if not bitwise:
        problems.append("replayed decode steps differ from the eager steps "
                        "or from the served tokens")
    if not all(bool(torch.isfinite(x.float()).all()) for x in eager_logits):
        problems.append("decode logits not finite")
    fields = {
        "queries": nq, "prompt_len": plen, "gen_len": GEN_LEN,
        "max_len": max_len, "generate_wall_s": wall,
        "generated_tokens_per_s": nq * GEN_LEN / wall,
        "prefill_s": prefill_s,
        "decode_ms_per_replayed_step": decode_s / (GEN_LEN - 1) * 1e3,
        "launches": counts, "launches_expected": expect,
        "decode_graphs": {"captured": captured,
                          "decode_steps_replayed": replayed,
                          "decode_steps_eager": eager,
                          "decode_steps": GEN_LEN - 1},
        "graph_equals_eager_bitwise": bitwise, "peak_memory_bytes": peak}
    return fields, tokens, problems


def whisper_step_bound(bundle, max_len: int) -> dict:
    """The least time of one decode step at B = NUM_QUERIES, from the
    code: operations, the cross K/V projected from ``enc_out`` in every
    layer (as the reference recomputes them) beside two flops per
    decoder and head weight per query and the two attentions; bytes, the
    weights the step reads, ``enc_out`` once and the self cache's valid
    rows at the last step, each read once."""
    cfg = bundle.cfg
    b, f, d, layers = NUM_QUERIES, cfg.encoder_frames, cfg.d_model, \
        cfg.num_layers
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    kvd = cfg.num_kv_heads * hd
    elt = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    w_bytes = weight_bytes(bundle)
    w_count = sum(x.numel() for k in ("decoder", "head")
                  for x in _tree_leaves(bundle.params[k]))
    cross_kv = 2 * 2 * b * f * d * kvd * layers
    flops = (cross_kv + 2 * b * w_count
             + 4 * b * h * hd * (f + max_len) * layers)
    byte_count = (w_bytes + b * f * d * elt
                  + 2 * layers * b * max_len * kvd * elt)
    ms, by = bound(byte_count, flops, getattr(torch, cfg.dtype))
    return {"ms": ms, "bound_by": by, "flops": flops,
            "cross_kv_flops": cross_kv, "bytes": byte_count,
            "weight_bytes": w_bytes}


@torch.inference_mode()
def phase_whisper(mods, cfg, seed: int):
    """whisper-small at full width and depth through the model's own API,
    as the reference serves it (its engine passes no frames, ROADMAP
    H24): NUM_QUERIES prompts of WHISPER_PROMPT_LEN tokens and their
    frames, GEN_LEN generated tokens through the bundle's
    ``DecodeGraphs.generate`` (the prefill eagerly, the decode steps as
    replays of the graph captured in a warm-up pass), held as
    ``checked_generate`` holds it; the encode (the mean of three calls) is
    timed apart."""
    t0 = time.perf_counter()
    bundle = mods["ModelBundle"].create("whisper", cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, frames = whisper_inputs(cfg, seed)
    run, tokens, problems = checked_generate(mods, bundle, prompts, frames)
    encode_s = seconds(lambda: bundle._model.encode(bundle.params, frames))
    out = {
        "phase": "whisper", "ok": not problems,
        "model": {"arch": cfg.name, "encoder_layers": cfg.encoder_layers,
                  "decoder_layers": cfg.num_layers, "d_model": cfg.d_model,
                  "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                  "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                  "vocab": cfg.vocab_size, "frames": cfg.encoder_frames,
                  "dtype": cfg.dtype,
                  "params": sum(x.numel() for x in _tree_leaves(
                      bundle.params))},
        "init_seconds": init_s, "encode_s": encode_s, **run,
        "decode_step_bound": whisper_step_bound(bundle, run["max_len"]),
        "problems": problems,
    }
    emit(out)
    if problems:
        fail("whisper phase failed: " + "; ".join(problems))
    return out, bundle, prompts, frames, tokens


def encoder_score_std(bundle, frames) -> float:
    """``score_std`` of the first encoder layer on the first query's
    frames."""
    x = frames[:1].to(getattr(torch, bundle.cfg.dtype)) \
        + bundle.params["pos_enc"][None]
    return score_std(bundle, x)


def decoder_score_std(bundle, tokens, embeds=None) -> float:
    """``score_std`` of a DecoderLM's first layer on the first query's
    prompt (its image embeddings in front, ``embeds``)."""
    x = bundle._model._embed_tokens(
        bundle.params, tokens[:1], None if embeds is None else embeds[:1])
    return score_std(bundle, x)


def score_std(bundle, x) -> float:
    """The standard deviation of the first layer's attention scores (over
    sqrt(head_dim)) on that layer's input ``x`` [1, S, d]: how far the
    random init saturates the softmax.  The first layer is the first
    stack of the tree with an ``attn`` block (an encoder-decoder's
    encoder)."""
    from repro_torch.models.attention import gqa_project_qkv
    from repro_torch.models.layers import rms_norm
    cfg = bundle.cfg
    stack = next(v for v in bundle.params.values()
                 if isinstance(v, dict) and "attn" in v)
    p = {k: v[0] for k, v in stack["attn"].items()}
    h = rms_norm(x, stack["ln_attn"][0], cfg.norm_eps)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, _ = gqa_project_qkv(p, cfg, h, pos)
    k = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return float(s.std()) * q.shape[-1] ** -0.5


def attention_at_input_width(params) -> None:
    """Rescale every GQA projection ``[layers, d, heads, hd]`` (the
    ``attn`` and ``cross`` blocks of every stack), drawn at 1 / sqrt(heads)
    by the init (the reference's fan-in axis), to 1 / sqrt(d), in place."""
    for key, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if key in ("attn", "cross") and "wq" in sub:
            for name in ("wq", "wk", "wv"):
                w = sub[name]
                w.mul_((w.shape[-2] / w.shape[-3]) ** 0.5)
        else:
            attention_at_input_width(sub)


# what a parity record says of its init (master_params' ``init``)
INIT_LABEL = {None: "the reference's",
              attention_at_input_width: "attention projections at "
                                        "1 / sqrt(d)"}


@torch.inference_mode()
def phase_parity_whisper(mods, bundle, prompts, frames, served,
                         seed: int) -> dict:
    """whisper's served batch teacher-forced at int positions with the
    kernels and with the plain versions.  The random init draws the GQA
    projections at 1 / sqrt(heads), so the encoder's attention scores
    have a standard deviation near 64 (``score_std``) and the softmax is
    one-hot: a difference of one rounding can pick another key, and the
    whole model amplifies it (measured: greedy agreement 0 in bf16 at
    full depth).  So, as for granite and deepseek, the kernels' own
    arithmetic is gated block by block.  In bf16 at full depth (gates:
    finite logits, the served tokens reproduced by the kernel path; the
    whole model's and each kind of block's differences are reported);
    in float32 at full width with WHISPER_F32_LAYERS encoder and decoder
    layers (gate: every block's update within PARITY_F32_REL, the whole
    model's numbers reported); and in float32 at the same depth with the
    projections drawn at 1 / sqrt(d), where the scores have a standard
    deviation near 1 (gates, as gemma3's: logits within PARITY_F32_REL of
    their largest magnitude, every greedy token equal)."""
    ops, ref = mods["ops"], mods["ref"]
    problems = []
    bf16 = kernel_vs_plain(ops, ref, bundle, prompts, served, frames=frames)
    bf16["score_std"] = encoder_score_std(bundle, frames)
    bf16["layerwise"] = encdec_layerwise(ops, ref, bundle, prompts, served,
                                         frames)
    if not (bf16["finite"] and bf16["kernel_path_reproduces_served_tokens"]):
        problems.append(f"{bundle.cfg.name} bf16: logits not finite or "
                        f"served tokens not reproduced")
    cfg32 = dataclasses.replace(bundle.cfg, dtype="float32",
                                num_layers=WHISPER_F32_LAYERS,
                                encoder_layers=WHISPER_F32_LAYERS)
    f32, frames32 = {}, frames.float()
    for init in ("random_init", "attention_at_input_width"):
        b32 = mods["ModelBundle"].create("whisper", cfg32, seed=seed + 7)
        if init != "random_init":
            attention_at_input_width(b32.params)
        r = kernel_vs_plain(ops, ref, b32, prompts, served, frames=frames32)
        r["encoder_layers"] = cfg32.encoder_layers
        r["score_std"] = encoder_score_std(b32, frames32)
        if init == "random_init":
            r["layerwise"] = encdec_layerwise(ops, ref, b32, prompts, served,
                                              frames32)
            r["tol"] = PARITY_F32_REL
            if not (r["finite"] and max(r["layerwise"]["encoder"],
                                        r["layerwise"]["decoder"])
                    <= r["tol"]):
                problems.append(f"{cfg32.name} float32: a block's kernel "
                                f"and plain updates differ beyond "
                                f"{r['tol']}")
        else:
            r["tol"] = PARITY_F32_REL * r["logit_abs_max"]
            if not (r["finite"] and r["max_logit_diff"] <= r["tol"]
                    and r["greedy_tokens_agree"]):
                problems.append(f"{cfg32.name} float32 ({init}): kernels "
                                f"and plain versions differ beyond "
                                f"{r['tol']} or greedy tokens differ")
        f32[init] = r
        del b32
    out = {"phase": "parity_whisper", "ok": not problems,
           "whisper": {"prompt_len": int(prompts.shape[1]),
                       "frames": int(frames.shape[1]),
                       "bf16_full_depth": bf16, "float32_cut_depth": f32},
           "problems": problems}
    emit(out)
    if problems:
        fail("parity_whisper phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# train, parity_train
# ---------------------------------------------------------------------------


def train_seq_len() -> int:
    """The sequence length of the reference's ``train_4k`` shape."""
    from repro_torch.configs.base import SHAPES
    return SHAPES["train_4k"].seq_len


def active_params(cfg, n_params: int) -> float:
    """The parameters a token goes through: all of them, but an MoE
    layer's routed experts only as top_k of num_experts (the capacity's
    padding is no model work); ``launch.analysis.active_params``."""
    from repro_torch.launch.analysis import active_params as of_tree
    return of_tree(cfg, n_params)


def layer_kinds(cfg) -> list[str]:
    """The model's attention layer kinds in execution order ('L' local,
    under the sliding window; 'G' global); none for RWKV6; for the Mamba2
    hybrid one global layer per site of its shared attention block (after
    every ``attn_every``-th Mamba2 layer); for an encoder-decoder one
    global kind per attention call, none under a window: each encoder
    layer's, then each decoder layer's self- and cross-attention."""
    from repro_torch.models.families import Mamba2Hybrid
    from repro_torch.models.transformer import DecoderLM
    if cfg.rwkv is not None:
        return []
    if cfg.family == "audio":
        return ["G"] * (cfg.encoder_layers + 2 * cfg.num_layers)
    if cfg.ssm is not None:
        return ["G"] * Mamba2Hybrid(cfg, device="cpu").n_attn
    return DecoderLM(cfg, device="cpu").layer_kinds()


def attention_head_dims(cfg) -> tuple[int, int]:
    """(D, Dv) of the model's attention: the query / key and the value
    head dim, (128 + 64, 128) for deepseek's latent attention, the head
    dim twice for the others."""
    if cfg.mla is not None:
        m = cfg.mla
        return m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x active parameters x tokens for
    the matrix products, and attention's products (QK^T over D and PV over
    Dv: 2 (D + Dv) flops a head and attended pair forward, twice that
    backward, so 6 (D + Dv)) over the pairs each layer's mask keeps: the
    causal pairs on a global layer, those within the sliding window on a
    local one (gemma3's).  For RWKV6, 6 x parameters x tokens and the
    WKV scan's operations (``rwkv_flops``) three times a layer: once
    forward, twice that backward, as the matrix products' 6 is 2 + 4.
    For the Mamba2 hybrid, 6 x parameters x tokens (the shared attention
    block's parameters once, as the tree holds them, although each of its
    sites runs them), attention over the causal pairs at each site of the
    shared block, and the SSD scan's operations (``mamba_flops``) three
    times a layer.  For an encoder-decoder (``encdec_train_flops``) the
    encoder's parameters over its frames and the decoder's over its
    tokens.  The forward that remat repeats is not counted."""
    if cfg.family == "audio":
        return encdec_train_flops(cfg, n_params, batch, seq)
    if cfg.rwkv is not None:
        hd = cfg.rwkv.head_dim
        scan = 3.0 * cfg.num_layers * rwkv_flops(
            batch, seq, cfg.d_model // hd, hd, cfg.rwkv.chunk)
        return 6.0 * n_params * batch * seq + scan
    pairs = {"G": attended_pairs(seq, seq, True, 0)}
    if cfg.sliding_window:
        pairs["L"] = attended_pairs(seq, seq, True, cfg.sliding_window)
    attn = 6.0 * sum(attention_head_dims(cfg)) * batch * cfg.num_heads * sum(
        pairs[kind] for kind in layer_kinds(cfg))
    scan = 0.0
    if cfg.ssm is not None:
        sc = cfg.ssm
        scan = 3.0 * cfg.num_layers * mamba_flops(
            batch, seq, sc.expand * cfg.d_model // sc.head_dim, sc.head_dim,
            sc.state_dim, sc.chunk)
    return 6.0 * active_params(cfg, n_params) * batch * seq + attn + scan


def frames_side_params(cfg) -> int:
    """An encoder-decoder's parameters that act on the encoder's frames,
    counted from its definitions: the encoder's stack, ``pos_enc`` and
    ``ln_enc``, and the decoder's cross-attention key and value
    projections, which project the encoder's output."""
    from repro_torch.models.families import EncDecLM
    defs = EncDecLM(cfg, device="cpu").param_defs()
    cross = defs["decoder"]["cross"]
    return sum(math.prod(d.shape) for d in _tree_leaves(
        {k: defs[k] for k in ("encoder", "pos_enc", "ln_enc")})
        + [cross["wk"], cross["wv"]])


def encdec_train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of an encoder-decoder over
    ``batch`` sequences of ``seq`` decoder tokens and
    ``cfg.encoder_frames`` frames each: 6 x the parameters that act on the
    frames (``frames_side_params``) x frames, 6 x the rest (the decoder's
    stack, the embedding, the head) x tokens, and attention's products at
    6 (D + Dv) a head and attended pair: frames x frames on each encoder
    layer (bidirectional), the causal pairs of the tokens on each decoder
    layer's self-attention and tokens x frames on its cross-attention.
    ``launch/analysis.py model_flops``, the reference's definition, counts
    every parameter over the decoder's tokens (ROADMAP queue 3)."""
    frames = cfg.encoder_frames
    enc = frames_side_params(cfg)
    pairs = (cfg.encoder_layers * attended_pairs(frames, frames, False, 0)
             + cfg.num_layers * (attended_pairs(seq, seq, True, 0)
                                 + attended_pairs(seq, frames, False, 0)))
    attn = 6.0 * sum(attention_head_dims(cfg)) * batch * cfg.num_heads * pairs
    return 6.0 * batch * (enc * frames + (n_params - enc) * seq) + attn


def train_launches(cfg, n_accum: int, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps of a decoder with
    ``cfg.remat``, per layer and microbatch: K1's forward once, and again
    in the backward's recompute; its backward once, under the sliding
    window on a local layer; in an MoE layer K3's
    forward three times (gate, up, down), again in the recompute, and its
    dX and dW kernels three times each (every rows count of these calls
    takes the 128-row tile, and every gradient the persistent kernel, as
    granite's training shapes do).  For RWKV6 per layer and microbatch K5
    once, and again in the recompute, and K5b's kernels once each
    (``rwkv6_scan.bwd_launches`` of the passes that r, k, v, w and bonus
    call for: no initial state), nothing else.  For the Mamba2 hybrid per
    Mamba2 layer and microbatch K4 once, and again in the recompute, and
    K4b's kernels once each (``mamba2_scan.bwd_launches`` of the passes
    that xh, b, c, dt and a_log call for: no initial state); per site of
    the shared attention block, which remat does not recompute, K1 and
    its backward once; nothing else.  For an encoder-decoder K1 and its
    backward as for a decoder layer once per attention call
    (``layer_kinds``): each encoder layer's, each decoder layer's self-
    and cross-attention."""
    from repro_torch.kernels import mamba2_scan as ms_mod
    from repro_torch.kernels import rwkv6_scan as rs_mod
    exp = no_launches()
    runs, fwd = n_accum * steps, 2 if cfg.remat else 1
    if cfg.rwkv is not None:
        exp["rwkv6_scan"] = cfg.num_layers * runs * fwd
        exp["rwkv6_scan_bwd"] = cfg.num_layers * runs * rs_mod.bwd_launches(
            rs_mod.bwd_passes((True,) * 5 + (False,)))
        return exp
    if cfg.ssm is not None:
        sites = len(layer_kinds(cfg))
        exp["mamba2_scan"] = cfg.num_layers * runs * fwd
        exp["mamba2_scan_bwd"] = cfg.num_layers * runs * ms_mod.bwd_launches(
            ms_mod.bwd_passes((True,) * 5 + (False,)))
        exp["flash_attention"] = exp["flash_attention_bwd"] = sites * runs
        return exp
    calls = len(layer_kinds(cfg)) if cfg.family == "audio" else \
        cfg.num_layers
    exp["flash_attention"] = calls * runs * fwd
    exp["flash_attention_bwd"] = calls * runs
    exp["flash_attention_bwd_window"] = layer_kinds(cfg).count("L") * runs
    if cfg.moe is not None:
        gemms = 3 * (cfg.num_layers - cfg.moe_layer_start) * runs
        exp["moe_gemm"] = gemms * fwd
        exp["moe_gemm_dx"] = exp["moe_gemm_dw"] = gemms
        exp["moe_gemm_dx_tma"] = exp["moe_gemm_dw_tma"] = gemms
    return exp


class WithFrames:
    """A token stream whose batches also carry an encoder-decoder model's
    frames, ``extra_embeds`` [batch, encoder_frames, d] in bf16 (the type
    of the reference's ``input_specs``), drawn on the batch's device from
    (seed, step): the reference's ``SyntheticTokens``, which the port
    copies, makes none, and its stub frontend's output is random
    embeddings.  ``batch_at`` takes the stream's arguments, so the
    ``Trainer`` reads it as it reads the stream."""

    def __init__(self, tokens, cfg, seed: int):
        self.tokens, self.cfg, self.seed = tokens, cfg, seed
        self.device = tokens.device

    def batch_at(self, step: int, device=None) -> dict:
        batch = self.tokens.batch_at(step, device)
        dev = batch["tokens"].device
        gen = torch.Generator(device=dev).manual_seed(int(
            np.random.SeedSequence((self.seed, step)).generate_state(1)[0]))
        batch["extra_embeds"] = torch.randn(
            (batch["tokens"].shape[0], self.cfg.encoder_frames,
             self.cfg.d_model), generator=gen, device=dev).bfloat16()
        return batch


def train_data(cfg, seq: int, batch: int, seed: int):
    """The train phases' stream: ``SyntheticTokens`` of ``batch``
    sequences of ``seq`` tokens a step, with the frames beside them for an
    encoder-decoder model (``WithFrames``)."""
    from repro_torch.training.data import DataConfig, SyntheticTokens
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch, seed=seed))
    return WithFrames(data, cfg, seed) if cfg.family == "audio" else data


def master_params(model, seed: int, init=None) -> dict:
    """The model's random init (a seeded generator on the card) as float32
    master parameters; ``init``, where given, changes them in place
    (``attention_at_input_width``)."""
    from repro_torch.training.tree import tree_map
    gen = torch.Generator(device="cuda").manual_seed(seed)
    masters = tree_map(lambda p: p.float(), model.init(gen))
    if init is not None:
        init(masters)
    return masters


def timed_steps(step_fn, trees: list, data, steps) -> tuple:
    """``step_fn`` over ``data``'s batches of ``steps``, ``trees`` (the
    parameters and the state) advanced in place: the losses and each
    step's seconds (host clock between synchronisations), as
    ``phase_train``'s loop times them.  The caller keeps no other
    reference to the trees, so that a step's inputs are freed once its
    outputs are made: the peak holds two states, not three."""
    losses, times = [], []
    for step in steps:
        batch = data.batch_at(step)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, trees[0], trees[1] = step_fn(*trees, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return losses, times


# elements of a leaf that ``state_digest`` reads at a time
DIGEST_CHUNK = 1 << 26


def state_digest(tree) -> dict:
    """Each leaf of ``tree`` by its path: its bits read as integers of its
    width (16 or 32 bits), each times its position plus one, summed in
    int64 on the card (the sum wraps; integer sums do not depend on their
    order).  A change of any one bit changes the sum: it moves the term by
    2^b (b < 32) times a position below 2^31, which is not 0 modulo
    2^64."""
    from repro_torch.training.tree import tree_paths
    ints = {2: torch.int16, 4: torch.int32}
    out = {}
    for path, x in tree_paths(tree):
        bits = x.detach().reshape(-1).view(ints[x.element_size()])
        total = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(0, bits.numel(), DIGEST_CHUNK):
            part = bits[i: i + DIGEST_CHUNK].long()
            total += (part * torch.arange(i + 1, i + 1 + part.numel(),
                                          device=x.device)).sum()
        out[path] = int(total)
    return out


def profile_train_step(step_fn, params, state, batch) -> dict:
    """One more train step traced with torch.profiler: the card's busy
    share of its wall, the device time by kind of kernel (K1's forward,
    its backward, K3's forward, dX and dW, the matrix products,
    elementwise kernels and copies, the rest) and K1's and K3's shares of
    the step's device time (K5's and K5b's for RWKV6, K4's and K4b's for
    the Mamba2 hybrid)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    step_fn(params, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(params, state, batch)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    dev = sum(r[0] for r in rows) / 1e6
    # K3's gradients: the persistent kernel's layouts 0 (dX) and 1 (dW); on
    # their first design dX is K3's kernel with a K-major w (its last
    # template argument)
    kinds = {"k5_forward": ("rwkv6_mma_kernel", "rwkv6_scan_kernel"),
             "k5_backward": ("rwkv6_bwd_",),
             "k4_forward": ("mamba2_mma_kernel", "mamba2_scan_kernel"),
             "k4_backward": ("mamba2_bwd_",),
             "k1_forward": ("flash_mma_kernel",),
             "k1_backward": ("bwd_",),
             "k3_dx": ("moe_grad_tma_kernel<0>",) + tuple(
                 f"moe_gemm_wgmma_kernel<{m}, {v}, true>"
                 for m in (64, 128) for v in ("true", "false")),
             "k3_forward": ("moe_gemm_wgmma_kernel",),
             "k3_dw": ("moe_grad_tma_kernel<1>", "moe_dw_"),
             "gemm": ("gemm", "nvjet", "cutlass", "sm90_xmma"),
             "elementwise_and_copies": ("elementwise", "copy", "reduce")}
    share = dict.fromkeys(kinds, 0.0)
    share["other"] = 0.0
    for us, _, name in rows:
        kind = next((k for k, marks in kinds.items()
                     if any(m in name for m in marks)), "other")
        share[kind] += us / 1e6
    return {"step_wall_s": wall, "device_s": dev,
            "device_busy_share": dev / wall,
            "device_s_by_kind": share,
            "k1_forward_share": share["k1_forward"] / dev,
            "k1_backward_share": share["k1_backward"] / dev,
            "k3_share": (share["k3_forward"] + share["k3_dx"]
                         + share["k3_dw"]) / dev,
            "k5_share": (share["k5_forward"] + share["k5_backward"]) / dev,
            "k4_share": (share["k4_forward"] + share["k4_backward"]) / dev,
            "top_device_time": [
                {"name": k[:80], "calls": n, "ms": us / 1e3}
                for us, n, k in rows[:10]]}


def phase_train(mods, cfg, seed: int, profile: bool = False,
                phase: str = "train", num_layers: int = 0,
                depth_note: str = "") -> dict:
    """``cfg`` at full width (qwen3-1.7b; granite-moe-3b-a800m as
    ``train_moe``, gemma3-4b as ``train_gemma3`` and deepseek-v2-236b as
    ``train_deepseek``, their depth cut to ``num_layers``, ``depth_note``
    saying why beside the measured peak; rwkv6-3b as ``train_rwkv`` and
    zamba2-2.7b as ``train_zamba2``, at their full depth, the peak
    printed) trained through the
    port's ``make_train_step`` with the reference's ``AdamWConfig()``:
    bf16 compute over float32 masters, bf16 moments, remat,
    TRAIN_GLOBAL_BATCH sequences of train_4k's length per step in
    microbatches of TRAIN_MICROBATCH.  One warm-up step (it builds and
    allocates), then TRAIN_STEPS steps of ``SyntheticTokens.batch_at(step)``
    with the launch counts zeroed just before: the losses must be finite
    and the last below the first, and the kernels must launch as
    ``train_launches`` predicts, nothing else, K1's backward under the
    sliding window once per local layer and microbatch, and every launch
    of K3's gradients on their persistent kernel.  Step seconds,
    tokens/s,
    model FLOPs (on active parameters) per second against 989 TFLOP/s,
    peak memory, and the final parameters' and state's ``state_digest``
    (``train_graph`` holds its replays to it); ``profile``: one more step
    traced."""
    ops, steps, opt = mods["ops"], mods["steps"], mods["opt"]
    from repro_torch.models.moe import _capacity
    from repro_torch.training.tree import tree_leaves
    full = cfg
    cfg = dataclasses.replace(cfg, microbatch=TRAIN_MICROBATCH,
                              num_layers=num_layers or cfg.num_layers)
    seq = train_seq_len()
    step_fn, model = steps.make_train_step(
        cfg, dp_size=1, global_batch=TRAIN_GLOBAL_BATCH,
        opt_cfg=opt.AdamWConfig(), device="cuda")
    n_accum = TRAIN_GLOBAL_BATCH // steps.resolve_microbatch(
        cfg, TRAIN_GLOBAL_BATCH, 1)
    resident = torch.cuda.memory_allocated()
    params = master_params(model, seed)
    n_params = sum(p.numel() for p in tree_leaves(params))
    state = opt.init_state(params)
    built = state_leaves({"params": params, "opt": state})
    data = train_data(cfg, seq, TRAIN_GLOBAL_BATCH, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, params, state = step_fn(params, state, data.batch_at(0))
    warm_loss = float(loss)
    warmup_s = time.perf_counter() - t
    ops.reset_launch_counts()
    losses, times = [], []
    for step in range(1, TRAIN_STEPS + 1):
        batch = data.batch_at(step)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, params, state = step_fn(params, state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = ops.counts()
    peak = torch.cuda.max_memory_allocated()
    expect = train_launches(cfg, n_accum, TRAIN_STEPS)
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}: not finite or not falling")
    if counts != expect:
        problems.append(f"launches {counts}, expected {expect}")
    step_s = sum(times) / len(times)
    flops = train_flops(cfg, n_params, TRAIN_GLOBAL_BATCH, seq)
    reduced = {"global_batch": f"256 -> {TRAIN_GLOBAL_BATCH}",
               "microbatch": f"{full.microbatch} -> {TRAIN_MICROBATCH}"}
    if cfg.num_layers != full.num_layers:
        reduced["num_layers"] = (
            f"{full.num_layers} -> {cfg.num_layers} (peak "
            f"{peak / 1e9:.2f} GB of the card's 80"
            + (f"; {depth_note}" if depth_note else "") + ")")
    out = {
        "phase": phase, "model": cfg.name,
        "shape": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                  "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                  "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                  "vocab": cfg.vocab_size, "seq_len": seq,
                  **({"experts": cfg.moe.num_experts,
                      "top_k": cfg.moe.top_k,
                      "d_expert": cfg.moe.d_expert,
                      "capacity": _capacity(seq, cfg)} if cfg.moe else {})},
        "params": n_params,
        "active_params": active_params(cfg, n_params),
        "dtype": f"{cfg.dtype} compute over float32 masters, bf16 moments",
        "remat": cfg.remat, "global_batch": TRAIN_GLOBAL_BATCH,
        "microbatch": TRAIN_MICROBATCH, "accum_steps": n_accum,
        "reduced": reduced,
        "warmup_loss": warm_loss, "warmup_s": warmup_s,
        "losses": losses, "step_s": times, "step_s_mean": step_s,
        "tokens_per_s": TRAIN_GLOBAL_BATCH * seq / step_s,
        "model_flops_per_step": flops,
        "model_tflops_per_s": flops / step_s / 1e12,
        "mfu_of_989_tflops": flops / step_s / PEAK_FLOPS[torch.bfloat16],
        "peak_gb": peak / 1e9,
        # what the step itself holds: the peak above what other phases
        # left allocated before this one built its parameters
        "resident_before_bytes": resident,
        "step_peak_bytes": peak - resident,
        "depth": f"{cfg.num_layers} of {full.num_layers} layers",
        "launches": counts, "launches_expected": expect,
        "digest": state_digest({"params": params, "opt": state}),
        "ok": not problems, "problems": problems,
    }
    if cfg.sliding_window:
        out["shape"].update(sliding_window=cfg.sliding_window,
                            layer_kinds="".join(layer_kinds(cfg)))
    if cfg.rwkv is not None:
        out["shape"].update(chunk=cfg.rwkv.chunk)
    if cfg.ssm is not None:
        sc = cfg.ssm
        out["shape"].update(
            ssm_heads=sc.expand * cfg.d_model // sc.head_dim,
            ssm_head_dim=sc.head_dim, state_dim=sc.state_dim, chunk=sc.chunk,
            attention_sites=len(layer_kinds(cfg)))
    if cfg.family == "audio":
        out["shape"].update(encoder_layers=cfg.encoder_layers,
                            frames=cfg.encoder_frames,
                            decoder_positions=WHISPER_TRAIN_POSITIONS)
        out["frames_per_s"] = TRAIN_GLOBAL_BATCH * cfg.encoder_frames / step_s
    if cfg.mla is not None:
        out["shape"].update(head_dims_qk_v=list(attention_head_dims(cfg)),
                            q_lora_rank=cfg.mla.q_lora_rank,
                            kv_lora_rank=cfg.mla.kv_lora_rank,
                            moe_layer_start=cfg.moe_layer_start)
    if profile:
        out["profile"] = profile_train_step(step_fn, params, state,
                                            data.batch_at(TRAIN_STEPS + 1))
    emit(out)
    if problems:
        fail(f"{phase} phase failed: " + "; ".join(problems))
    out["built_state"] = built       # for the dryrun phase, not printed
    return out


# ---------------------------------------------------------------------------
# train_graph: the train step as one captured CUDA graph
# ---------------------------------------------------------------------------


def graph_run(step_fn, params, state, data, steps: int) -> dict:
    """``CapturedTrainStep(step_fn)`` from ``params`` and ``state``: its
    first call on batch 0 (the eager step on the capture's stream, then the
    capture), then ``steps`` replays of batches 1 to ``steps``, the launch
    counts zeroed just before them.  The losses (the first call's first),
    the replays' seconds and launch counts, the first call's and the
    capture's seconds, the wrapper's tallies, the peak allocated and the
    wrapper with its statics (for a traced step)."""
    from repro_torch.kernels import ops
    from repro_torch.training.graphs import CapturedTrainStep
    graphed = CapturedTrainStep(step_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, params, state = graphed(params, state, data.batch_at(0))
    first = float(loss)
    first_s = time.perf_counter() - t
    ops.reset_launch_counts()
    # the statics: the wrapper returns the same trees at every call
    losses, times = timed_steps(graphed, [params, state], data,
                                range(1, steps + 1))
    counts = ops.counts()
    (slot,) = graphed.slots.values()
    return {"losses": [first] + losses, "step_s": times,
            "step_s_mean": sum(times) / len(times), "first_call_s": first_s,
            "capture_s": slot.capture_s, "launches": counts,
            "tallies": {"eager_steps": graphed.eager_steps,
                        "captures": graphed.captures,
                        "replays": graphed.replays},
            "peak": torch.cuda.max_memory_allocated(),
            "digest": state_digest({"params": params, "opt": state}),
            "graphed": graphed}


def graph_problems(run: dict, want_losses, want_digest, expect,
                   replays: int) -> list:
    """What ``graph_run``'s ``run`` got wrong: losses or digest not the eager
    run's bit for bit, launches not ``expect``, a step not replayed."""
    problems = []
    if run["losses"] != want_losses:
        problems.append(f"losses {run['losses']}, eager {want_losses}")
    bad = [k for k in want_digest if run["digest"].get(k) != want_digest[k]]
    if bad or set(run["digest"]) != set(want_digest):
        problems.append(f"state digest differs from the eager run's at "
                        f"{bad[:8]}")
    if run["launches"] != expect:
        problems.append(f"launches {run['launches']}, expected {expect}")
    if run["tallies"] != {"eager_steps": 1, "captures": 1,
                          "replays": replays}:
        problems.append(f"steps {run['tallies']}: not one eager step, one "
                        f"capture and {replays} replays")
    return problems


def graph_case(mods, cfg, seed: int, eager: dict,
               profile: bool = False) -> dict:
    """``cfg`` at full width and depth as ``phase_train`` trains it, its
    output ``eager``, through ``CapturedTrainStep`` (``graph_run``, the
    TRAIN_STEPS replays on batches 1-4): the losses and the final digest
    must equal the eager phase's bit for bit and the launches, all counted
    through replays, ``train_launches``' prediction.  Step seconds,
    tokens/s (frames/s), the first call's and the capture's seconds and the
    peak above what was resident against the eager phase's; ``profile``:
    one more replayed step traced."""
    steps, opt = mods["steps"], mods["opt"]
    cfg = dataclasses.replace(cfg, microbatch=TRAIN_MICROBATCH)
    seq = train_seq_len()
    step_fn, model = steps.make_train_step(
        cfg, dp_size=1, global_batch=TRAIN_GLOBAL_BATCH,
        opt_cfg=opt.AdamWConfig(), device="cuda")
    n_accum = TRAIN_GLOBAL_BATCH // steps.resolve_microbatch(
        cfg, TRAIN_GLOBAL_BATCH, 1)
    resident = torch.cuda.memory_allocated()
    params = master_params(model, seed)
    data = train_data(cfg, seq, TRAIN_GLOBAL_BATCH, seed)
    run = graph_run(step_fn, params, opt.init_state(params), data,
                    TRAIN_STEPS)
    del params
    expect = train_launches(cfg, n_accum, TRAIN_STEPS)
    problems = graph_problems(run, [eager["warmup_loss"]] + eager["losses"],
                              eager["digest"], expect, TRAIN_STEPS)
    step_s = run["step_s_mean"]
    out = {"model": cfg.name, "eager_phase": eager["phase"],
           "depth": f"{cfg.num_layers} of {cfg.num_layers} layers",
           "global_batch": TRAIN_GLOBAL_BATCH, "microbatch": TRAIN_MICROBATCH,
           "reduced": eager["reduced"],
           **{k: run[k] for k in ("losses", "step_s", "step_s_mean",
                                  "first_call_s", "capture_s", "launches",
                                  "tallies")},
           "eager_losses": [eager["warmup_loss"]] + eager["losses"],
           "eager_step_s_mean": eager["step_s_mean"],
           "step_s_over_eager": step_s / eager["step_s_mean"],
           "tokens_per_s": TRAIN_GLOBAL_BATCH * seq / step_s,
           "peak_gb": run["peak"] / 1e9,
           "step_peak_bytes": run["peak"] - resident,
           "eager_step_peak_bytes": eager["step_peak_bytes"],
           "peak_over_eager": (run["peak"] - resident)
           / eager["step_peak_bytes"],
           "launches_expected": expect,
           "digest_bitwise": run["digest"] == eager["digest"],
           "ok": not problems, "problems": problems}
    if cfg.family == "audio":
        out["frames_per_s"] = TRAIN_GLOBAL_BATCH * cfg.encoder_frames / step_s
    if profile:
        graphed = run["graphed"]
        out["profile"] = profile_train_step(
            graphed, graphed.params, graphed.opt_state,
            data.batch_at(TRAIN_STEPS + 1))
    return out


# the other families at full width and these depths, GRAPH_BATCH sequences
# of train_4k's length a step in microbatches of TRAIN_MICROBATCH: each
# depth keeps one of every kind of layer that brings a kernel to the step.
# granite's first two layers (K3, K3-dX / -dW on the persistent kernel);
# gemma3's first six (five local, one global: K1b at D = 256 under the
# window and not); deepseek's dense first layer (K1b at (192, 128));
# rwkv6's first two (K5, K5b); zamba2's first attn_every = 6 (one site of
# its shared attention block: K4, K4b, K1b at D = 80)
GRAPH_REDUCED = (("granite-moe-3b-a800m", 2), ("gemma3-4b", 6),
                 ("deepseek-v2-236b", 1), ("rwkv6-3b", 2),
                 ("zamba2-2.7b", 6))
GRAPH_BATCH, GRAPH_REPLAYS = 4, 2


def graph_reduced_case(mods, arch: str, layers: int, seed: int) -> dict:
    """``arch`` at full width and ``layers`` layers: GRAPH_REPLAYS + 1
    eager steps of ``make_train_step`` from the seeded state, then the
    same state through ``graph_run`` (the first call and GRAPH_REPLAYS
    replays); losses and the final digest bitwise equal, the replays'
    launches ``train_launches``' prediction; each way's step seconds."""
    from repro_torch.configs.archs import ARCHS
    steps, opt = mods["steps"], mods["opt"]
    full = ARCHS[arch]
    cfg = dataclasses.replace(full, microbatch=TRAIN_MICROBATCH,
                              num_layers=layers)
    seq = train_seq_len()
    step_fn, model = steps.make_train_step(
        cfg, dp_size=1, global_batch=GRAPH_BATCH, opt_cfg=opt.AdamWConfig(),
        device="cuda")
    n_accum = GRAPH_BATCH // steps.resolve_microbatch(cfg, GRAPH_BATCH, 1)
    data = train_data(cfg, seq, GRAPH_BATCH, seed)
    trees = [master_params(model, seed)]
    trees.append(opt.init_state(trees[0]))
    losses, times = timed_steps(step_fn, trees, data,
                                range(GRAPH_REPLAYS + 1))
    digest = state_digest({"params": trees[0], "opt": trees[1]})
    del trees
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    params = master_params(model, seed)
    run = graph_run(step_fn, params, opt.init_state(params), data,
                    GRAPH_REPLAYS)
    del params
    expect = train_launches(cfg, n_accum, GRAPH_REPLAYS)
    problems = graph_problems(run, losses, digest, expect, GRAPH_REPLAYS)
    return {"model": cfg.name, "eager_phase": None,
            "depth": f"{layers} of {full.num_layers} layers",
            "global_batch": GRAPH_BATCH, "microbatch": TRAIN_MICROBATCH,
            "reduced": {"num_layers": f"{full.num_layers} -> {layers}: one "
                                      f"of each kind of layer, for the "
                                      f"run's time (ROADMAP H7)",
                        "global_batch": f"256 -> {GRAPH_BATCH}",
                        "microbatch": f"{full.microbatch} -> "
                                      f"{TRAIN_MICROBATCH}"},
            **{k: run[k] for k in ("losses", "step_s", "step_s_mean",
                                   "first_call_s", "capture_s", "launches",
                                   "tallies")},
            "eager_losses": losses, "eager_step_s": times,
            # the eager steps after the first, which builds and allocates
            "eager_step_s_mean": sum(times[1:]) / len(times[1:]),
            "tokens_per_s": GRAPH_BATCH * seq / run["step_s_mean"],
            "peak_gb": run["peak"] / 1e9,
            "step_peak_bytes": run["peak"] - resident,
            "launches_expected": expect,
            "digest_bitwise": run["digest"] == digest,
            "ok": not problems, "problems": problems}


def phase_train_graph(cases: list) -> dict:
    """The ``train_graph`` line: every case (``graph_case``,
    ``graph_reduced_case``) and the launches of all their replays."""
    problems = [f"{c['model']}: {p}" for c in cases for p in c["problems"]]
    out = {"phase": "train_graph", "cases": cases,
           "launches": {k: sum(c["launches"][k] for c in cases)
                        for k in cases[0]["launches"]},
           "ok": not problems, "problems": problems}
    emit(out)
    if problems:
        fail("train_graph phase failed: " + "; ".join(problems))
    return out


@contextlib.contextmanager
def expandable_segments():
    """PyTorch's caching allocator with expandable segments (segments
    that grow page by page) while the block runs, the default after it.
    gemma3's microbatch frees and asks for blocks of 4 and 8 GiB (its
    [2, 4096, 262144] logits in bf16 and float32): with fixed segments its
    first train step at 18 layers ran out of memory with 55.4 GiB
    allocated and 16.2 GiB reserved but unusable (on an H100 80GB HBM3)."""
    settings = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    torch.cuda.empty_cache()
    settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        settings("expandable_segments:False")


def loss_and_grads(model, masters, batch, dtype):
    """The loss of ``batch`` and its gradients with respect to the float32
    ``masters``, every leaf of more than one dimension cast to ``dtype``
    inside the loss, as make_train_step takes them (a leaf the loss does
    not use, as an empty MoE stack's, gets zeros)."""
    from repro_torch.training.tree import (tree_leaves, tree_map,
                                           tree_unflatten)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(masters)]
    cast = lambda p: p.to(dtype) if p.dim() > 1 else p
    loss = model.train_loss(tree_map(cast, tree_unflatten(masters, leaves)),
                            batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach().float(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)]


def drill_cfg(arch: str):
    """``arch``'s SMOKE config with its ``DRILL_OVER`` changes."""
    from repro_torch.configs.archs import SMOKE
    cfg = SMOKE[arch]
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in DRILL_OVER.get(arch, {}).items()})


def trainer_drill(mods, seed: int, arch: str) -> dict:
    """The Trainer on the card at ``arch``'s SMOKE size (qwen3, granite:
    bf16 over float32 masters, K1 and its backward at head dim 16, which
    the backward's wgmma kernel takes padded to 64; sequences of 512
    tokens, so that 4 key tiles add into most query tiles' dq in its fixed
    order; granite's K3 and its gradients at 640 rows an expert; gemma3 at
    DRILL_OVER's head dim 256, the column-split kernel, under a window of
    128 on its local layers; deepseek's dense layer and two MoE layers at
    its published latent attention's head dims, K1's backward at (192,
    128) on the kv-split kernel beside K3 and its gradients): an
    uninterrupted run of 6 steps; a run that fails at step 3 after its
    emergency checkpoint; a restart whose restored parameters and moments
    must equal the saved ones bit for bit, and whose losses must equal the
    uninterrupted run's bit for bit (no operation of the step is known to
    vary from run to run on the card)."""
    import tempfile
    from repro_torch.training.trainer import TrainConfig, Trainer
    from repro_torch.training.tree import tree_paths
    steps, opt = mods["steps"], mods["opt"]
    cfg = drill_cfg(arch)
    step_fn, model = steps.make_train_step(
        cfg, dp_size=1, global_batch=4,
        opt_cfg=opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50),
        device="cuda")
    data = train_data(cfg, 512, 4, seed)

    def trainer(root):
        params = master_params(model, seed)
        return Trainer(cfg, step_fn, params, opt.init_state(params), data,
                       TrainConfig(steps=6, ckpt_every=2, ckpt_dir=root))

    with tempfile.TemporaryDirectory() as tmp:
        whole = trainer(f"{tmp}/whole").run()
        tr = trainer(f"{tmp}/cut")
        try:
            tr.run(fail_at=3)
            failed = False
        except RuntimeError:
            failed = True
        saved = tree_paths({"params": tr.params, "opt": tr.opt_state})
        tr2 = trainer(f"{tmp}/cut")
        restored_from = tr2.try_restore()
        restored = tree_paths({"params": tr2.params, "opt": tr2.opt_state})
        restore_bitwise = len(saved) == len(restored) and all(
            p == q and torch.equal(a, b)
            for (p, a), (q, b) in zip(saved, restored))
        report = trainer(f"{tmp}/cut").run()
    want = whole.losses[3:]
    diff = max(abs(a - b) / abs(b) for a, b in zip(report.losses, want))
    return {"arch": cfg.name, "steps": 6, "fail_at": 3, "failed": failed,
            "restored_from": restored_from,
            "restored_state_bitwise": restore_bitwise,
            "uninterrupted_losses": whole.losses,
            "resumed_losses": report.losses,
            "resumed_losses_bitwise": report.losses == want,
            "resumed_losses_max_rel_diff": diff,
            "ok": failed and restored_from == 2 and restore_bitwise
            and report.losses == want}


def f32_cut(cfg, layers: int) -> dict:
    """The ``reduced`` entry of a train parity whose float32 depth is cut
    below the train depth for the run's time (RWKV_F32_LAYERS)."""
    return {"float32_layers": f"{cfg.num_layers} -> {layers}: the card's "
                              f"run under two thirds of its 900 s (ROADMAP "
                              f"H7)"}


def phase_parity_train(mods, cfg, seed: int, phase: str = "parity_train",
                       num_layers: int = 0, f32_layers: int = 0,
                       seq: int = 0, seq_reason: str = "",
                       bf16_gate_layers: int = 0,
                       gate_init: dict | None = None,
                       reduced: dict | None = None) -> dict:
    """One microbatch's loss and gradients with the kernels (K1 with its
    log-sum-exp and its backward; for an MoE model K3 and its dX and dW
    kernels; for RWKV6 K5 and K5b; for the Mamba2 hybrid K4 and K4b beside
    K1 and its backward) against the plain versions
    (``plain_versions`` of flash_attention, and moe_gemm: autograd through
    the plain forwards; of rwkv6_scan and mamba2_scan: the plain forward
    with the plain backward, TRAIN_PLAIN),
    on the train phase's first microbatch: in float32 at full width with
    ``f32_layers`` layers (TRAIN_F32_LAYERS; gemma3 GEMMA_F32_LAYERS, five
    local layers and its first global one) (the loss within
    TRAIN_F32_LOSS_REL, each
    gradient leaf within TRAIN_F32_GRAD_REL of its largest magnitude), and
    in bf16 over float32 masters at the train phase's depth (the loss and
    the global gradient norm, relative, and each gradient leaf relative to
    its largest magnitude, within TRAIN_BARS[phase]), on sequences of
    ``seq`` tokens (train_4k's, but where the plain attention's memory
    binds: ``seq_reason``).  An MoE model's plain
    run is held to the kernel run's routing (``held_routing``, replayed in
    call order: the forward's, then remat's recompute in the backward);
    the flips a free plain run would make are counted, and the recompute
    must have chosen the forward's experts.  With ``bf16_gate_layers``
    (rwkv6: RWKV_BF16_GATE_LAYERS, H30) the bf16 reading at the train
    depth is reported and the bars hold the model cut to that many layers.
    ``gate_init`` maps a dtype to the init its gate takes instead of the
    reference's (``master_params`` applies it; each record names its
    init): granite has no q / k norm, so at the reference's init its
    attention saturates and 24 bf16 layers amplify the kernels' rounding
    chaotically (ROADMAP H25), and zamba2's shared attention at 9 sites
    does the same at depth (H32); their gates hold the attention
    projections drawn at 1 / sqrt(d) (``attention_at_input_width``), as
    parity_whisper does, and the reference init is read in bf16 at the
    gate depth and reported beside them (zamba2's bf16 gate depth is cut,
    ZAMBA2_BF16_GATE_LAYERS, so there the train depth is run through the
    kernels alone).  ``reduced`` names a cut of the float32 depth below the
    train depth, printed on the phase's line.  The bf16 run at the train
    depth is repeated through the kernels on the same microbatch, and the
    loss and gradients must equal the first's bit for bit.  Then the
    Trainer drill at SMOKE size."""
    ops, ref, moe_mod = mods["ops"], mods["ref"], mods["moe"]
    from repro_torch.models.families import build_model
    from repro_torch.training.tree import tree_paths
    loss_bar, norm_bar, grad_bar = TRAIN_BARS[phase]
    # MoE layers at the depths run here (deepseek's first layer is dense)
    is_moe = cfg.moe is not None and (num_layers or cfg.num_layers) > \
        cfg.moe_layer_start
    names = (["rwkv6_scan"] if cfg.rwkv is not None else
             ["mamba2_scan", "flash_attention"] if cfg.ssm is not None else
             ["flash_attention"] + (["moe_gemm"] if is_moe else []))
    seq = seq or train_seq_len()
    batch = train_data(cfg, seq, TRAIN_GLOBAL_BATCH, seed).batch_at(1)
    micro = {k: v[:TRAIN_MICROBATCH] for k, v in batch.items()}
    problems = []
    out = {"phase": phase, "model": cfg.name,
           "microbatch": [TRAIN_MICROBATCH, seq], "plain": names}
    if seq_reason:
        out["seq_len_reason"] = seq_reason
    if reduced:
        out["reduced"] = reduced

    def both(model, masters, dtype):
        """(kernel loss, grads), (plain loss, grads), launches, routing."""
        log, stats = [], {"decisions": 0, "flipped": 0}
        hold = lambda st=None: (held_routing(moe_mod, log, st) if is_moe
                                else contextlib.nullcontext())
        ops.reset_launch_counts()
        with hold():
            kern = loss_and_grads(model, masters, micro, dtype)
        counts = ops.counts()
        with plain_versions(ops, ref, names, TRAIN_PLAIN), hold(stats):
            plain = loss_and_grads(model, masters, micro, dtype)
        routing = None
        if is_moe:
            n = model.cfg.num_layers - model.cfg.moe_layer_start
            routing = {"route_calls": len(log), **stats,
                       "recompute_chose_the_forwards_experts":
                           len(log) == 2 * n and all(
                               torch.equal(log[i], log[2 * n - 1 - i])
                               for i in range(n))}
            if not routing["recompute_chose_the_forwards_experts"]:
                problems.append(f"{dtype}: remat's recompute routed "
                                f"otherwise than the forward")
        return kern, plain, counts, routing

    def compare(model, masters, dtype, layers):
        paths = [p for p, _ in tree_paths(masters)]
        (lk, gk), (lp, gp), counts, routing = both(model, masters, dtype)
        norm = lambda gs: float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                               for g in gs)))
        nk, np_ = norm(gk), norm(gp)
        leaf_rel = {p: rel_err(a, b) for p, a, b in zip(paths, gk, gp)
                    if b.numel()}
        rec = {"layers": layers, "loss_kernels": float(lk),
               "loss_plain": float(lp),
               "loss_rel_diff": float(abs(lk - lp) / abs(lp)),
               "grad_norm_kernels": nk, "grad_norm_plain": np_,
               "grad_norm_rel_diff": abs(nk - np_) / np_,
               "grad_rel_diff_max": max(leaf_rel.values()),
               "grad_rel_diff_worst_leaf": max(leaf_rel, key=leaf_rel.get),
               "finite": bool(torch.isfinite(lk)) and bool(np.isfinite(nk)),
               "launches": {k: n for k, n in counts.items() if n}}
        if routing is not None:
            rec["routing_held"] = routing
        del gp
        return rec, lk, gk

    gate_init = gate_init or {}
    train_layers = num_layers or cfg.num_layers
    gate_layers = bf16_gate_layers or train_layers
    within = lambda r: (r["finite"] and r["loss_rel_diff"] <= loss_bar
                        and r["grad_norm_rel_diff"] <= norm_bar
                        and r["grad_rel_diff_max"] <= grad_bar)

    def reading(layers, dtype, init=None, model=None):
        """``compare`` at ``layers`` from ``init`` (None: the reference's),
        with its model (``model``, where one of that depth is at hand)."""
        t = time.perf_counter()
        if model is None:
            model = build_model(dataclasses.replace(
                cfg, num_layers=layers, **({"dtype": "float32"}
                                           if dtype == torch.float32
                                           else {})), "cuda")
        rec, _, _ = compare(model, master_params(model, seed, init), dtype,
                            layers)
        torch.cuda.empty_cache()
        return {**rec, "init": INIT_LABEL[init],
                "seconds": time.perf_counter() - t}, model

    f32, model = reading(f32_layers or TRAIN_F32_LAYERS, torch.float32,
                         gate_init.get(torch.float32))
    f32["tol"] = {"loss": TRAIN_F32_LOSS_REL, "grad": TRAIN_F32_GRAD_REL}
    if not (f32["loss_rel_diff"] <= TRAIN_F32_LOSS_REL
            and f32["grad_rel_diff_max"] <= TRAIN_F32_GRAD_REL):
        problems.append(f"float32: loss or a gradient leaf beyond its bar "
                        f"({f32['loss_rel_diff']}, "
                        f"{f32['grad_rel_diff_max']})")
    out["float32_cut_depth"] = f32
    del model
    torch.cuda.empty_cache()

    # bf16 at the train depth from the reference init, then the same
    # microbatch again through the kernels: the same bits
    init16 = gate_init.get(torch.bfloat16)
    cut_gate = gate_layers != train_layers
    cfg = dataclasses.replace(cfg, num_layers=train_layers)
    model = build_model(cfg, "cuda")
    masters = master_params(model, seed)
    if init16 is not None and cut_gate:
        bf16 = None              # the reference init is read at the gate
        lk, gk = loss_and_grads(model, masters, micro, torch.bfloat16)
    else:
        bf16, lk, gk = compare(model, masters, torch.bfloat16, train_layers)
        bf16["init"] = INIT_LABEL[None]
    torch.cuda.empty_cache()
    l2, g2 = loss_and_grads(model, masters, micro, torch.bfloat16)
    repeat = bool(torch.equal(lk, l2)) and all(
        torch.equal(a, b) for a, b in zip(gk, g2))
    if not repeat:
        problems.append("bf16: a second gradient call gave other bits")
    del lk, gk, l2, g2, masters
    torch.cuda.empty_cache()
    if bf16 is None:
        out["bf16_train_depth_repeat"] = {"layers": train_layers,
                                          "repeat_bitwise": repeat}
    else:
        bf16["repeat_bitwise"] = repeat
    if init16 is not None or cut_gate:
        if bf16 is not None:
            out["bf16_train_depth_reported" if init16 is None else
                "bf16_train_depth_reference_init"] = {
                **bf16, "within_the_bars": within(bf16)}
        if cut_gate:
            del model
            torch.cuda.empty_cache()
            model = None
            if init16 is not None:
                out["bf16_gate_depth_reference_init"], model = reading(
                    gate_layers, torch.bfloat16)
        bf16, model = reading(gate_layers, torch.bfloat16, init16, model)
    bf16["tol"] = {"loss": loss_bar, "grad_norm": norm_bar,
                   "grad": grad_bar}
    if not within(bf16):
        problems.append(f"bf16: loss, gradient norm or a gradient leaf "
                        f"beyond its bar ({bf16['loss_rel_diff']}, "
                        f"{bf16['grad_norm_rel_diff']}, "
                        f"{bf16['grad_rel_diff_max']})")
    out["bf16_train_depth"] = bf16
    del model
    torch.cuda.empty_cache()

    out["trainer_drill"] = trainer_drill(mods, seed, cfg.name)
    if not out["trainer_drill"]["ok"]:
        problems.append("Trainer drill: restore or resumed losses differ")
    out["ok"], out["problems"] = not problems, problems
    emit(out)
    if problems:
        fail(f"{phase} phase failed: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# optional: where one stage's time goes (--profile)
# ---------------------------------------------------------------------------


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


def weight_bytes(bundle) -> int:
    """Bytes of the weights one decode step reads: every parameter, but
    the embedding table where the head is a matrix of its own (a step
    gathers B of its rows) and an encoder-decoder model's encoder (it runs
    at the prefill)."""
    params = bundle.params
    if bundle.cfg.family == "audio":
        params = {k: params[k] for k in ("decoder", "ln_f", "head")}
    skip = None if bundle.cfg.tie_embeddings else params.get("embed")
    return sum(nbytes(x) for x in _tree_leaves(params) if x is not skip)


def kernel_rows(prof) -> list:
    """(device us, calls, name) of every kernel (and copy) in a trace, the
    largest first: kernel rows only, since an operator's row repeats its
    kernels' time."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return sorted(rows, reverse=True)


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------

# the train phases' exact configurations, (phase, registry id, layers: 0
# for the full depth), which the dryrun phase prices on the meta device
TRAIN_PHASES = (("train", "qwen3-1.7b", 0),
                ("train_moe", "granite-moe-3b-a800m", MOE_TRAIN_LAYERS),
                ("train_gemma3", "gemma3-4b", GEMMA_TRAIN_LAYERS),
                ("train_deepseek", "deepseek-v2-236b", DEEPSEEK_TRAIN_LAYERS),
                ("train_rwkv", "rwkv6-3b", 0),
                ("train_zamba2", "zamba2-2.7b", 0),
                ("train_whisper", "whisper-small", 0))
DRYRUN_PREFILL = ("qwen3-1.7b", NUM_QUERIES, PROMPT_LEN)   # [8, 512]
DRYRUN_TOL = 0.10           # priced peak against the measured one


def dryrun_specs() -> list:
    """What the dryrun phase prices: each train phase's step whole
    (TRAIN_GLOBAL_BATCH sequences of train_4k's length in microbatches of
    TRAIN_MICROBATCH, its depth cut as the phase cuts it) and one
    prefill of DRYRUN_PREFILL's model at [NUM_QUERIES, PROMPT_LEN]."""
    specs = [{"phase": phase, "arch": arch, "kind": "train",
              "overrides": {"microbatch": TRAIN_MICROBATCH,
                            **({"num_layers": n} if n else {})},
              "seq": train_seq_len(), "rows": TRAIN_GLOBAL_BATCH,
              "microbatch": TRAIN_MICROBATCH}
             for phase, arch, n in TRAIN_PHASES]
    arch, rows, seq = DRYRUN_PREFILL
    specs.append({"phase": "prefill", "arch": arch, "kind": "prefill",
                  "overrides": {}, "seq": seq, "rows": rows,
                  "microbatch": rows})
    return specs


def state_leaves(tree, mesh=None, placements=None, prefix=()) -> dict:
    """path -> [shape, dtype, bytes] of every tensor of ``tree`` (dicts and
    named tuples); with a ``mesh``, of each leaf's shard under its
    ``placements`` (a tree of the same structure)."""
    if isinstance(tree, torch.Tensor):
        shape = tuple(tree.shape)
        if mesh is not None:
            from repro_torch.launch.mesh import local_shape
            shape = local_shape(mesh, shape, placements)
        return {"/".join(prefix): [list(shape), str(tree.dtype)[6:],
                                   math.prod(shape) * tree.element_size()]}
    named = not isinstance(tree, dict)
    out = {}
    for k in (tree._fields if named else tree):
        sub = getattr(tree, k) if named else tree[k]
        pl = placements if placements is None else (
            getattr(placements, k) if named else placements[k])
        out.update(state_leaves(sub, mesh, pl, prefix + (k,)))
    return out


def price_dryrun(specs: list) -> dict:
    """The dryrun phase's pricing, run on the CPU in a child process while
    the card runs the train phases: each spec priced on a (1, 1) mesh by
    ``launch.dryrun.price_cell``, the figure its per-cell table prints
    (its total, the weighted peak of the whole step traced on the meta
    device, and the five largest storages live there) and, for a train
    phase, its float32 masters and AdamW state leaf by leaf; and its
    window, ``time.time()`` at its start and end."""
    window = [time.time()]
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as mesh_mod
    out = {}
    with mesh_mod.fake_world(1):
        mesh = mesh_mod.make_test_mesh((1, 1))
        for sp in specs:
            cfg = dataclasses.replace(ARCHS[sp["arch"]], **sp["overrides"])
            shape = ShapeConfig(f"{sp['kind']}_{sp['seq']}", sp["seq"],
                                sp["rows"], sp["kind"])
            rec = dryrun.price_cell(cfg, shape, mesh)
            if sp["kind"] == "train":
                params, state, pspecs, sspecs = steps.abstract_train_state(cfg)
                rec["state"] = state_leaves(
                    {"params": params, "opt": state}, mesh,
                    {"params": mesh_mod.shardings_for(mesh, params, pspecs),
                     "opt": mesh_mod.shardings_for(mesh, state, sspecs)})
            out[sp["phase"]] = rec
    window.append(time.time())
    return {"cells": out, "window": window}


def start_pricing(specs: list) -> subprocess.Popen:
    """:func:`price_dryrun` in a child Python process on the CPU, on one
    thread (it shares the host with the phases it overlaps); its result
    is one JSON line on its standard output."""
    root = Path(__file__).resolve().parent
    code = ("import json, sys, torch; torch.set_num_threads(1); "
            "sys.path[:0] = sys.argv[1:3]; "
            "import chip_smoke; print(json.dumps(chip_smoke.price_dryrun("
            "json.loads(sys.argv[3]))))")
    return subprocess.Popen(
        [sys.executable, "-c", code, str(root), str(root / "src"),
         json.dumps(specs)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def stop_process(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def measured_prefill(steps, seed: int) -> tuple[int, bool]:
    """DRYRUN_PREFILL's model at full size, its random init in bf16, one
    prefill of [NUM_QUERIES, PROMPT_LEN] seeded tokens into a cache of
    PROMPT_LEN rows through ``make_prefill_step``: the peak of
    ``max_memory_allocated`` above what was allocated before the model's
    parameters, and whether the logits are finite."""
    from repro_torch.configs.archs import ARCHS
    arch, rows, seq = DRYRUN_PREFILL
    cfg = ARCHS[arch]
    step_fn, model = steps.make_prefill_step(cfg, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, seq),
                                     device="cuda", generator=gen),
             "cache": model.init_cache(rows, seq)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, _ = step_fn(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    finite = bool(torch.isfinite(logits.float()).all())
    del params, batch, logits
    return peak, finite


def dryrun_cases(priced: dict, measured: dict, built: dict):
    """(cases, problems) of the dryrun phase: per case of ``measured``
    (bytes), the ``priced`` total (``price_cell``'s record) against it,
    held to DRYRUN_TOL, and where the case built a state (``built``,
    ``state_leaves`` of the phase's trees), each priced leaf held to it
    in shape, dtype and bytes."""
    cases, problems = {}, []
    for phase, want in measured.items():
        pr = priced[phase]
        ratio = pr["total_bytes"] / want
        case = {"priced_total_gb": pr["total_bytes"] / 1e9,
                "measured_peak_gb": want / 1e9,
                "priced_over_measured": ratio,
                "within_tol": abs(ratio - 1.0) <= DRYRUN_TOL,
                "live_at_priced_peak": pr["trace"]["live_at_peak"],
                "priced_resident_gb": {
                    k: v / 1e9 for k, v in pr["resident_bytes"].items()},
                "priced_activation_peak_gb":
                    pr["activation_peak_bytes"] / 1e9,
                "trace_s": pr["trace_s"]}
        if not case["within_tol"]:
            problems.append(f"{phase}: priced total {ratio:.3f} of "
                            f"measured peak")
        if phase in built:
            have = json.loads(json.dumps(built[phase]))
            wrong = sorted(k for k in set(have) | set(pr["state"])
                           if have.get(k) != pr["state"].get(k))
            case.update(state_leaves=len(have), state_exact=not wrong,
                        state_mismatches=wrong[:5],
                        state_gb=sum(v[2] for v in have.values()) / 1e9)
            if wrong:
                problems.append(f"{phase}: {len(wrong)} state leaves "
                                f"priced unlike the built ones")
        cases[phase] = case
    return cases, problems


def overlapping_phases(window: list, start_wall: float) -> list:
    """The phases whose span (from the previous phase line to their own,
    ``PHASE_END_S``) meets ``window``, wall-clock seconds taken in
    another process, given this run's start ``start_wall``."""
    lo, hi = (t - start_wall for t in window)
    out, prev = [], 0.0
    for phase, end in PHASE_END_S.items():
        if prev < hi and end > lo:
            out.append(phase)
        prev = end
    return out


def phase_dryrun(mods, pricing: subprocess.Popen, train_outs: list,
                 seed: int) -> dict:
    """The meta-device dry run held to the card.  Per train phase: the
    state ``price_cell`` priced on a (1, 1) mesh (float32 masters and
    AdamW state, leaf by leaf) must equal the state the phase built in
    shape, dtype and bytes, and the total it priced for the phase's
    whole step (its microbatches, their accumulation, AdamW), the figure
    the dry run's table prints, must lie within DRYRUN_TOL of the
    ``max_memory_allocated`` the phase measured above what was allocated
    before it; the same check for one prefill of DRYRUN_PREFILL, measured
    here.  Each case prints both figures and the five largest storages
    live at the priced peak; the phase names the phases that ran while
    the pricing process did."""
    peak, finite = measured_prefill(mods["steps"], seed)
    torch.cuda.empty_cache()
    try:
        stdout, stderr = pricing.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        stop_process(pricing)
        fail("dryrun phase: the pricing process did not finish in 600 s")
    if pricing.returncode:
        fail(f"dryrun phase: the pricing process failed "
             f"(exit {pricing.returncode}):\n{stderr[-4000:]}")
    priced = json.loads(stdout.strip().splitlines()[-1])
    measured = {out["phase"]: out["step_peak_bytes"] for out in train_outs}
    measured["prefill"] = peak
    cases, problems = dryrun_cases(
        priced["cells"], measured,
        {o["phase"]: o["built_state"] for o in train_outs})
    if not finite:
        problems.append("prefill: logits not finite")
    out = {"phase": "dryrun", "mesh": [1, 1], "tolerance": DRYRUN_TOL,
           "prefill_shape": list(DRYRUN_PREFILL), "cases": cases,
           "pricing_window_s": [t - T_START_WALL for t in priced["window"]],
           "phases_overlapping_pricing": overlapping_phases(
               priced["window"], T_START_WALL),
           "ok": not problems, "problems": problems}
    emit(out)
    if problems:
        fail("dryrun phase failed: " + "; ".join(problems))
    return out


@torch.inference_mode()
def phase_profile(bundles, prompts, name: str, frames=None) -> dict:
    """One stage of model ``name`` (8 queries, one shard) run three ways in
    this process, each split into prefill and decode on the host clock:
    ``eager``, the decode loop of the model at Python int positions (the
    parity phases' path, and the engine's before its decode graphs);
    ``eager_device_position``, the bundle's decode step at its device
    position without the graph; ``graph``, the bundle's captured step
    replayed, as the serve phases run it.  Then the decode steps of
    ``eager`` and ``graph`` traced with torch.profiler: the share of the
    decode wall time in which the card was busy, the kernels that took
    most of the device time, and the launches per layer and step; and the
    prefill's device time against its untraced wall (it runs eagerly in
    every mode).  ``frames``: an encoder-decoder model's, for each
    prefill."""
    from torch.profiler import ProfilerActivity, profile

    bundle = bundles[name]
    model = bundle._model
    shard = prompts.to("cuda")
    plen = shard.shape[1]
    max_len = plen + GEN_LEN
    slot = bundle.decoder.slot(NUM_QUERIES, max_len)
    if slot.graph is None:
        bundle.decoder.generate(shard, GEN_LEN, max_len, frames)  # captures

    def eager(ctx):
        cache = model.init_cache(NUM_QUERIES, max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(bundle.params, shard, cache, frames)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with ctx:
            for step in range(GEN_LEN - 1):
                logits, cache = model.decode_step(bundle.params, tok, cache,
                                                  plen + step)
                tok = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    def static(ctx, graph: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot.prefill(shard, frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with ctx:
            for _ in range(GEN_LEN - 1):
                if graph:
                    slot.replay()
                else:
                    slot.step()
            torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    modes = {"eager": eager,
             "eager_device_position": lambda ctx: static(ctx, False),
             "graph": lambda ctx: static(ctx, True)}
    walls = {}
    for mode, fn in modes.items():
        fn(contextlib.nullcontext())                          # warm-up
    for mode, fn in modes.items():
        walls[mode] = fn(contextlib.nullcontext())
    step_ms = {mode: w[1] / (GEN_LEN - 1) * 1e3 for mode, w in walls.items()}
    traced = {}
    for mode in ("eager", "graph"):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _, decode_s = modes[mode](prof)
        rows = kernel_rows(prof)
        device_s = sum(r[0] for r in rows) / 1e6
        traced[mode] = {
            "decode_ms_per_step_traced": decode_s / (GEN_LEN - 1) * 1e3,
            "device_ms_per_step": device_s / (GEN_LEN - 1) * 1e3,
            "device_launches_per_step": sum(r[1] for r in rows)
            / (GEN_LEN - 1),
            # the traced wall carries the tracer's own cost; the share is
            # taken against the untraced one
            "device_busy_share": device_s / walls[mode][1],
            "top_device_time": [
                {"name": k[:80], "calls": n, "ms": us / 1e3,
                 "share": us / 1e6 / max(device_s, 1e-12)}
                for us, n, k in rows[:10]],
        }
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        model.prefill(bundle.params, shard,
                      model.init_cache(NUM_QUERIES, max_len), frames)
        torch.cuda.synchronize()
    prefill_dev_s = sum(r[0] for r in kernel_rows(prof)) / 1e6
    step_launches = traced["eager"]["device_launches_per_step"]
    out = {
        "phase": "profile",
        "stage": f"{bundle.cfg.name}, 8 queries, one shard, prompt {plen}",
        "decode_step_launches": step_launches,
        "decode_step_launches_per_layer":
            step_launches / bundle.cfg.num_layers,
        "prefill_s": {mode: w[0] for mode, w in walls.items()},
        "prefill_device_s": prefill_dev_s,
        "prefill_device_busy_share": prefill_dev_s / walls["eager"][0],
        "decode_ms_per_step": step_ms,
        "weights_bound_ms": weight_bytes(bundle) / HBM_BYTES_PER_S * 1e3,
        "graph_speedup": step_ms["eager"] / step_ms["graph"],
        # the profiler sees the kernels inside a replay (else the graph's
        # busy share would not be its own)
        "graph_trace_sees_kernels":
            traced["graph"]["device_launches_per_step"] >= step_launches,
        **{f"traced_{mode}": t for mode, t in traced.items()},
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------


def kernel_summary(kernels_out, serve_outs) -> dict:
    """One row per kernel: its time at the main shape (the first timed
    one: qwen3's for K1 and K2, qwen3's training shape for K1's backward,
    the gate/up projection at prefill for K3 and at granite's training
    microbatch for its gradients, zamba2's prefill for K4, rwkv6's prefill
    for K5, the training microbatches for K4b and K5b) and its launches summed over the serve phases and the train
    phases (``serve_outs``), with the other timed shapes and
    the launches per phase; for K3 also its decode gate/up shape with the
    launches of the 64-row tile that the serve phases counted, and the
    wrapper's host microseconds per call beside its plan's; for K2 the
    wrapper's host microseconds at each timed shape, timed with its
    length on the device as the serving path calls it; for K4 and K5 the
    output type they were timed with; each time with the number of
    whole windows it was read from."""
    main_key = {"flash_attention": "qwen3-1.7b",
                "flash_attention_bwd": "qwen3-1.7b/train",
                "decode_attention": "qwen3-1.7b",
                "moe_gemm": "prefill_up",
                "moe_gemm_dx": "granite-moe-3b-a800m/train_gate_up",
                "moe_gemm_dw": "granite-moe-3b-a800m/train_gate_up",
                "mamba2_scan": "prefill", "rwkv6_scan": "prefill",
                "mamba2_scan_bwd": "zamba2-2.7b/train",
                "rwkv6_scan_bwd": "rwkv6-3b/train"}
    rows = []
    for name in REPLACES:
        main = kernels_out[name]["main_path"]
        timed = {k: c for k, c in main.items() if "ms" in c}
        key = next(k for k in timed if k.startswith(main_key[name]))
        c = timed[key]
        fields = ("shape", "max_abs_err", "ms", "device_ms",
                  "device_windows", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "library_device_ms", "library_windows")
        launches = sum(o["launches"][name] for o in serve_outs)
        row = {
            "name": name, "route": "cuda",
            "design": (BF16_DESIGN.get(name, "fma")
                       if c["dtype"] == "bfloat16" else "fma"),
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches,
            "launches_by_phase": {o["phase"]: o["launches"][name]
                                  for o in serve_outs},
            "max_abs_err": max(x["max_abs_err"] for x in main.values()),
            "ms": c["ms"], "device_ms": c["device_ms"],
            "device_windows": c["device_windows"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "library_device_ms": c["library_device_ms"],
            "library_windows": c.get("library_windows"),
            "shape": c["shape"], "dtype": c["dtype"],
            "other_shapes": {k: {f: x[f] for f in fields + (
                "value_head_dim", "library_backend") if f in x}
                for k, x in timed.items() if k != key},
        }
        if name in NO_TPU_KERNEL:
            row["note"] = NO_TPU_KERNEL[name]
        if name == "flash_attention_bwd":
            row["max_rel_err"] = max(max(x["rel_err_dq_dk_dv"])
                                     for x in main.values())
        if name in ("moe_gemm_dx", "moe_gemm_dw"):
            row["max_rel_err"] = max(x["rel_err"] for x in main.values())
        if name in ("rwkv6_scan_bwd", "mamba2_scan_bwd"):
            row["max_rel_err"] = kernels_out[name]["max_rel_err"]
        if name == "moe_gemm":
            dkey = next(k for k in timed if k.startswith("decode_up"))
            row["decode"] = {
                **{f: timed[dkey][f] for f in fields},
                "launches": sum(o["launches"]["moe_gemm_decode_tile"]
                                for o in serve_outs)}
            row["host_us"] = {k: {f: timed[k][f]
                                  for f in ("host_us", "plan_us")}
                              for k in (key, dkey)}
        if name == "decode_attention":
            row["host_us"] = {k: x["host_us"] for k, x in timed.items()}
            row["cache_len_on_device"] = c["cache_len_on_device"]
        if name in ("mamba2_scan", "rwkv6_scan"):
            row["out_dtype"] = c["out_dtype"]
        if name in ("rwkv6_scan_bwd", "mamba2_scan_bwd"):
            row["device_ms_by_kernel"] = {
                k: x["device_ms_by_kernel"] for k, x in timed.items()}
        rows.append(row)
    return {"kernels": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after each serve phase, also run one stage of "
                         "each model with its decode steps eager and as "
                         "graph replays, split into prefill and decode, "
                         "and trace the decode steps with torch.profiler; "
                         "in the train phase, trace one more step")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "NVIDIA GPU and has no CPU mode")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.configs.archs import ARCHS
        from repro_torch.core.calibration import fit_profile
        from repro_torch.core.devices import homogeneous_cluster
        from repro_torch.core.executor import fresh_state
        from repro_torch.core.policies import make_policy
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.launch import steps
        from repro_torch.models import moe
        from repro_torch.training import optimizer as opt
        from repro_torch.core.scheduler import SchedulerConfig
        from repro_torch.serving import control_plane
        from repro_torch.serving.engine import ModelBundle, ServingEngine
        from repro_torch.workflowbench import suites
        make_workflow = load_example().make_workflow
    except (ImportError, OSError) as e:
        fail(f"cannot import the port from {Path(__file__).parent}: {e}")
    mods = dict(ops=ops, ref=ref, ModelBundle=ModelBundle,
                ServingEngine=ServingEngine, make_workflow=make_workflow,
                fresh_state=fresh_state, make_policy=make_policy,
                homogeneous_cluster=homogeneous_cluster, moe=moe,
                steps=steps, opt=opt, control_plane=control_plane,
                suites=suites, SchedulerConfig=SchedulerConfig,
                fit_profile=fit_profile)

    qwen = ARCHS["qwen3-1.7b"]
    glm = dataclasses.replace(ARCHS["glm4-9b"], vocab_size=qwen.vocab_size)
    granite, rwkv = ARCHS["granite-moe-3b-a800m"], ARCHS["rwkv6-3b"]
    zamba, gemma = ARCHS["zamba2-2.7b"], ARCHS["gemma3-4b"]
    deepseek = dataclasses.replace(ARCHS["deepseek-v2-236b"],
                                   num_layers=DEEPSEEK_LAYERS)
    whisper = ARCHS["whisper-small"]
    qwen15, llava = ARCHS["qwen1.5-4b"], ARCHS["llava-next-mistral-7b"]
    attn_cfgs = {"qwen3-1.7b": qwen, "glm4-9b": glm,
                 "granite-moe-3b-a800m": granite, "zamba2-2.7b": zamba}
    wf = make_workflow(NUM_QUERIES)

    t_all = T_START
    _, smi_line = phase_device(_build)
    kernels_out = phase_kernels(ops, ref, attn_cfgs, granite, rwkv, zamba,
                                gemma, deepseek, whisper, qwen15, llava,
                                args.seed)
    serve_out, bundles, prompts, policy, results = phase_serve(
        mods, {"qwen-7b": (qwen, args.seed), "llama-8b": (glm, args.seed + 1)},
        args.seed)
    if args.profile:
        phase_profile(bundles, prompts, "qwen-7b")
    phase_parity(mods, bundles, prompts, policy, results, wf)
    control_out = phase_control_plane(mods, bundles, args.seed)
    # free the first pair's weights: peak memory below is the second's
    del bundles, policy, results
    gc.collect()
    torch.cuda.empty_cache()
    serve2_out, bundles, prompts, policy, results = phase_serve(
        mods, {"qwen-7b": (granite, args.seed),
               "llama-8b": (rwkv, args.seed + 1)},
        args.seed, phase="serve_moe_rwkv")
    if args.profile:
        for name in bundles:
            phase_profile(bundles, prompts, name)
    phase_parity_moe_rwkv(mods, bundles, prompts, policy, results, wf,
                          args.seed)
    del bundles, policy, results
    gc.collect()
    torch.cuda.empty_cache()
    serve3_out, bundles, prompts, policy, results = phase_serve(
        mods, {"qwen-7b": (zamba, args.seed),
               "llama-8b": (qwen, args.seed + 1)},
        args.seed, phase="serve_hybrid")
    if args.profile:
        phase_profile(bundles, prompts, "qwen-7b")
    phase_parity_hybrid(mods, bundles, prompts, policy, results, wf,
                        args.seed)
    del bundles, policy, results
    gc.collect()
    torch.cuda.empty_cache()
    serve4_out, bundles, prompts, policy, results = phase_serve(
        mods, {"qwen-7b": (gemma, args.seed),
               "llama-8b": (qwen, args.seed + 1)},
        args.seed, phase="serve_gemma3", prompt_len=GEMMA_PROMPT_LEN)
    if args.profile:
        phase_profile(bundles, prompts, "qwen-7b")
    phase_parity_gemma3(mods, bundles, prompts, policy, results, wf,
                        args.seed)
    del bundles, policy, results
    gc.collect()
    torch.cuda.empty_cache()
    serve5_out, bundles, prompts, policy, results = phase_serve(
        mods, {"qwen-7b": (deepseek, args.seed),
               "llama-8b": (qwen, args.seed + 1)},
        args.seed, phase="serve_deepseek",
        reduced={"num_layers": f"{ARCHS['deepseek-v2-236b'].num_layers} -> "
                               f"{DEEPSEEK_LAYERS}"})
    if args.profile:
        phase_profile(bundles, prompts, "qwen-7b")
    phase_parity_deepseek(mods, bundles, prompts, policy, results, wf,
                          args.seed)
    del bundles, policy, results
    gc.collect()
    torch.cuda.empty_cache()
    t_qwen15_llava = time.perf_counter()
    serve6_out, bundles, prompts, policy, results = phase_serve(
        mods, {"qwen-7b": (qwen15, args.seed),
               "llama-8b": (llava, args.seed + 1)},
        args.seed, phase="serve_qwen15_llava",
        note="the engine passes llava no image embeddings, as the "
             "reference's does; llava_image passes them")
    if args.profile:
        for name in bundles:
            phase_profile(bundles, prompts, name)
    image_out, image = phase_llava_image(mods, bundles["llama-8b"],
                                         args.seed)
    phase_parity_qwen15_llava(mods, bundles, prompts, policy, results, wf,
                              image, args.seed)
    qwen15_llava_s = time.perf_counter() - t_qwen15_llava
    del bundles, policy, results, image
    gc.collect()
    torch.cuda.empty_cache()
    t_whisper = time.perf_counter()
    whisper_out, bundle, prompts, frames, served = phase_whisper(
        mods, whisper, args.seed)
    if args.profile:
        phase_profile({"whisper": bundle}, prompts, "whisper", frames)
    phase_parity_whisper(mods, bundle, prompts, frames, served, args.seed)
    whisper_s = time.perf_counter() - t_whisper
    del bundle, served
    gc.collect()
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    train_whisper_out = phase_train(mods, whisper, args.seed,
                                    profile=args.profile,
                                    phase="train_whisper")
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_train(
        mods, whisper, args.seed, phase="parity_train_whisper",
        f32_layers=whisper.num_layers,
        gate_init=dict.fromkeys((torch.float32, torch.bfloat16),
                                attention_at_input_width))
    gc.collect()
    torch.cuda.empty_cache()
    # whisper's host-bound step replayed before the pricing child starts
    graph_cases = [graph_case(mods, whisper, args.seed, train_whisper_out,
                              profile=args.profile)]
    whisper_train_s = time.perf_counter() - t_train
    gc.collect()
    torch.cuda.empty_cache()
    # the dryrun phase's meta-device pricing runs on the CPU meanwhile,
    # beside the train phases from qwen3's on, whose step times are the
    # card's (whisper's, the most host-bound, before it)
    pricing = start_pricing(dryrun_specs())
    atexit.register(stop_process, pricing)
    train_out = phase_train(mods, qwen, args.seed, profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_train(mods, qwen, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    t_graph = time.perf_counter()
    graph_cases.append(graph_case(mods, qwen, args.seed, train_out,
                                  profile=args.profile))
    for arch, layers in GRAPH_REDUCED:
        gc.collect()
        torch.cuda.empty_cache()
        graph_cases.append(graph_reduced_case(mods, arch, layers, args.seed))
    train_graph_out = phase_train_graph(graph_cases)
    graph_s = time.perf_counter() - t_graph
    gc.collect()
    torch.cuda.empty_cache()
    train_moe_out = phase_train(mods, granite, args.seed,
                                profile=args.profile, phase="train_moe",
                                num_layers=MOE_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_train(mods, granite, args.seed, phase="parity_train_moe",
                       num_layers=MOE_TRAIN_LAYERS,
                       gate_init={torch.bfloat16: attention_at_input_width})
    gc.collect()
    torch.cuda.empty_cache()
    with expandable_segments():
        train_gemma_out = phase_train(
            mods, gemma, args.seed, profile=args.profile,
            phase="train_gemma3", num_layers=GEMMA_TRAIN_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        phase_parity_train(mods, gemma, args.seed,
                           phase="parity_train_gemma3",
                           num_layers=GEMMA_TRAIN_LAYERS,
                           f32_layers=GEMMA_F32_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    full_deepseek = ARCHS["deepseek-v2-236b"]
    train_deepseek_out = phase_train(
        mods, full_deepseek, args.seed, profile=args.profile,
        phase="train_deepseek", num_layers=DEEPSEEK_TRAIN_LAYERS,
        depth_note="its first layer is dense; two layers, the second "
                   "MoE, hold 5.359 B parameters, about 118 GB at 22 bytes "
                   "a parameter")
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_train(
        mods, full_deepseek, args.seed, phase="parity_train_deepseek",
        num_layers=DEEPSEEK_TRAIN_LAYERS, f32_layers=DEEPSEEK_TRAIN_LAYERS,
        seq=DEEPSEEK_PARITY_SEQ,
        seq_reason="the plain attention's float32 [2, 128, S, S] tensors "
                   "(scores, masked scores, p, dp, ds) take 17.2 GB each at "
                   "4096, 86 GB in all; 4.3 GB each at 2048")
    gc.collect()
    torch.cuda.empty_cache()
    t_rwkv = time.perf_counter()
    with expandable_segments():
        train_rwkv_out = phase_train(
            mods, rwkv, args.seed, profile=args.profile, phase="train_rwkv")
        gc.collect()
        torch.cuda.empty_cache()
        phase_parity_train(
            mods, rwkv, args.seed, phase="parity_train_rwkv",
            f32_layers=RWKV_F32_LAYERS,
            bf16_gate_layers=RWKV_BF16_GATE_LAYERS, seq=RWKV_PARITY_SEQ,
            seq_reason="the plain scan runs one step per token forward and "
                       "two backward, about 150 thousand launches a layer "
                       "at 4096",
            reduced=f32_cut(rwkv, RWKV_F32_LAYERS))
    rwkv_s = time.perf_counter() - t_rwkv
    gc.collect()
    torch.cuda.empty_cache()
    t_zamba = time.perf_counter()
    with expandable_segments():
        train_zamba_out = phase_train(
            mods, zamba, args.seed, profile=args.profile,
            phase="train_zamba2")
        gc.collect()
        torch.cuda.empty_cache()
        phase_parity_train(
            mods, zamba, args.seed, phase="parity_train_zamba2",
            f32_layers=ZAMBA2_F32_LAYERS,
            bf16_gate_layers=ZAMBA2_BF16_GATE_LAYERS, seq=ZAMBA2_PARITY_SEQ,
            seq_reason="the plain scan runs one step per token forward, "
                       "again in remat's recompute, and back",
            reduced=f32_cut(zamba, ZAMBA2_F32_LAYERS),
            gate_init=dict.fromkeys((torch.float32, torch.bfloat16),
                                    attention_at_input_width))
    zamba_s = time.perf_counter() - t_zamba
    train_s = time.perf_counter() - t_train
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun(mods, pricing, [train_out, train_moe_out, train_gemma_out,
                                 train_deepseek_out, train_rwkv_out,
                                 train_zamba_out, train_whisper_out],
                 args.seed)
    emit(kernel_summary(kernels_out, [serve_out, control_out, serve2_out,
                                      serve3_out, serve4_out, serve5_out,
                                      serve6_out, image_out, whisper_out,
                                      train_whisper_out,
                                      train_out, train_graph_out,
                                      train_moe_out,
                                      train_gemma_out, train_deepseek_out,
                                      train_rwkv_out, train_zamba_out]))
    emit({"phase": "total", "seconds": time.perf_counter() - t_all,
          "qwen15_llava_phases_seconds": qwen15_llava_s,
          "whisper_phases_seconds": whisper_s,
          "whisper_train_phases_seconds": whisper_train_s,
          "train_graph_seconds_after_whisper_case": graph_s,
          "train_phases_seconds": train_s,
          "rwkv_train_phases_seconds": rwkv_s,
          "zamba2_train_phases_seconds": zamba_s,
          "phase_end_seconds": PHASE_END_S})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
