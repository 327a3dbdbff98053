#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA
H100. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs:

1. the device, and ``nvidia-smi --query-gpu=name,power.limit``;
2. the nvcc builds of the port's three CUDA sources, one nvcc per source, all
   started together, with their seconds and the ``-Xptxas -v`` register /
   shared-memory lines;
3. each decode-attention kernel against its plain PyTorch version on
   the card (B=8, cap=2048, H=12, Hkv=4, D=64; cursors across [0, 2047]
   with block edges, and a second set on and beside the split's
   256-position chunk edges (255, 256, 257, ...); window None, 256 and
   100 (across a chunk edge); the paged forms with
   page_size=64, a shuffled table with garbage past the live range and
   a parked row; the int8 form over pools quantized from the same seeded
   floats with the port's absmax_encode), float32 at atol 1e-4 and
   bfloat16 compared in float32 at atol 2e-2; the int8 matrix product
   against its plain version, exactly, at MNIST's three layer shapes and
   33x100x17, per-tensor and per-channel weight scales, float32 and
   bfloat16 out; its fused form quant_linear (the activation encode in
   the prologue, bias and ReLU in the epilogue) against its plain
   version, exactly, at the three layer shapes and 33x100x17, with and
   without bias and ReLU, float32 and bfloat16 out;
   then the paged cache write, float and int8 pools, with a parked row,
   run under torch's sync debug mode "error" (a write that read anything
   back to the host would raise) and held exactly against a plain
   reference;
4. the serving slice at full width in float32: GPTConfig.small() with
   seeded random weights serves 16 requests (prompts of 8-48 tokens,
   max_new=32) through BatchedDecoder(slots=8, capacity=2048), then
   again paged (pages=8*32+8, page_size=64), and paged once more with 8
   requests of 1200-1900 prompt tokens (long live contexts: every
   decode call walks several of the split's chunks). Each run has the
   launch counters set to 0 just before and read just after; a kernel
   of the path that never launched, or another decode kernel that did,
   fails the run. Every emitted token must sit within 1e-3 of its
   position's max logit when the request is re-run teacher-forced
   through _chunk_logits on a fresh cache. Then int8 KV: the same 16
   requests with kv_dtype="int8" (the int8 kernel launches at least once
   per layer per tick, the float paged kernel never), the pool bytes of
   both arms (int8 >= 3.5x smaller) and the outputs that agree with the
   float paged run (reported; untrained-model argmax ties); its gate is
   the JAX package's logit parity: a 37-token prefill and 6
   teacher-forced steps within 0.05 x the float pools' logit spread.
   Every arena is warmed through ``warm_step()`` and counted on its
   own; each run prints tokens/s, ms per tick, tokens per tick and host
   ms per tick token. Then the serving options at the same width, greedy,
   every float run held to the teacher-forced check and every run to its
   decode kernel's launches (at least layers x decode steps, no other
   decode kernel): ``[serve:multistep]`` decode_steps=4, contiguous and
   paged (tokens against the k=1 arena's, with the logit gap at a first
   difference; host syncs in each of 4 ticks counted with torch's sync
   debug mode, exactly one, the read of the token block, at k=4);
   ``[serve:prefix]`` prefix_cache=True, paged, float and int8: the 16
   prompts behind a shared 192-token prefix, against a cold run (at
   least 8 hits; no page leaked); ``[serve:chunked]`` prefill_chunk=64,
   contiguous and paged, the 8 long prompts interleaved with 8 short
   ones, against monolithic prefill (the longest gap between two tokens
   of a request); ``[serve:spec]`` gamma=4, contiguous and paged, the
   target as its own draft (acceptance > 0.7 per drafted token) and a
   2-layer draft of its width (seed 7); the draft's steps run the
   contiguous decode kernel, a paged target's admissions the paged one;
   ``[serve:handoff]`` prefill_export -> to_bytes -> from_bytes ->
   inject_prefilled, float and int8, 6 short and 2 long prompts, tokens
   equal to the same requests served directly; ``[serve:stream]`` 4
   requests with TokenStreams, one consumer reading nothing until the
   end (tokens equal the results); ``[serve:w8a16]``
   apply_weight_only_int8 on a copy of the model, its teacher-forced
   logits against the float model's within the JAX package's bound
   (relative norm < 0.03, argmax agreement > 0.9);
5. timing with CUDA events at the phase-3 shapes (float32, L2 flushed
   before each launch, as a decode tick finds the cache cold): kernel
   ms, plain-version ms, bytes and the memory/compute bound, and, as a
   yardstick the port never calls, torch's scaled_dot_product_attention
   on the same keys (the int8 row: on keys dequantized beforehand);
   the int8 kernel's ms beside the float paged kernel's;
6. int8 inference: MnistMLP(512, 256) with seeded weights through
   quantize_model, calibrate on 4 seeded (8, 784) batches, freeze and
   int8_swap (3 layers); with the counters at 0, one batch-8192 forward
   launches the fused quant_linear 3 times and nothing else (the
   kernels' record takes quant_linear's count from this run, and
   quant_matmul's from the int8 ResNet-50 below); then, with the counters at 0
   again, a check run sends the same batch through the public unfused
   entry points per layer (absmax_encode, quant_matmul, bias, ReLU: the
   JAX int8_linear's composition), which launches quant_matmul 3 times
   and must equal the fused forward exactly; the forward equals the
   same swapped model on the plain version exactly and lies within 0.1
   relative of the fake-quant float model; its ms beside the float32
   MnistMLP's; then both kernels
   timed at MNIST's three layer shapes against their plain versions and
   the yardsticks torch._int_mm plus the same scaling (and, for the
   fused form, the encode before it and bias and ReLU after it). Then
   ``[int8:resnet50]``: resnet50(1000), NHWC, seeded weights, through
   quantize_model, calibrate on 4 seeded (8, 3, 224, 224) batches,
   freeze and int8_swap (53 Conv2D and the head); with every counter at
   0, one batch-32 forward launches quant_matmul exactly 53 times (one
   per conv: its activations encoded, im2col in int8 into K16 columns,
   the weight packed once), quant_linear once and no other kernel, and
   equals the same forward on the plain versions exactly; its distance
   to the fake-quant model and its ms beside the float model's are
   printed. quant_matmul is checked exactly and timed at three of its
   im2col shapes (CONV_SHAPES: the stem 401408x147x64, a layer1 3x3
   100352x576x64, a layer4 3x3 1568x4608x512) against its plain version
   and torch._int_mm plus the same scaling, and its record rows are
   those (the first with the kernel's 53 launches, the others with
   their launches at their shape);
7. the three flash-attention kernels (forward, dq, dk/dv) against their
   plain versions on the card: o, lse, dq, dk and dv in float32 (atol
   1e-4) and bfloat16 compared in float32 (atol 2e-2), at the training
   shape (B=8, T=1024, H=12, Hkv=4, D=64, causal) and at each option the
   gate admits (non-causal; Hkv 12 and 1; window 256; a kv_mask with a
   padded tail and a row with no live key; Tq=512 against Tk=1024;
   Tq=64 and 192, where the 128-row blocks of the forward and dq run a
   short last tile; T=4096; D=128 and D=256); then with the options of
   packed rows and attention dropout (FLASH_OPTION_CASES: segment ids of
   rows packed with 16-T-token documents and a padding tail, dropout at
   p 0.1 and 0.5 from seeded (B, H) seeds, both with a kv_mask, causal
   and not, GQA, D 64 and 128), the same tolerances, both sides on the
   same seeds; then at Tq != Tk with dropout and a key mask
   (FLASH_CROSS_CASES: the NMT's cross-attention, 64 queries against a
   128-key memory with a padded tail and a row with no live key, p 0.1;
   192 against 320 keys, causal, GQA, p 0.5), where the dropout hash
   reads row i + (tk - tq);
8. the training slice at full width, bench_gpt's configuration:
   GPTConfig.small() with remat, max_position=1024, seeded weights (seed
   5, built anew for each policy), one (8, 1024) batch of seeded ids
   (seed 6), Adam(1e-3) through Trainer, under each mixed-precision
   policy in turn: float32 (``[train]``), mixed_bf16, bfloat16 and
   mixed_fp16 (``[train:<policy>]``; mixed_fp16 through
   amp.decorate(Adam), which scales the loss). First one forward_loss
   backward on the kernel path is held against the same weights with
   use_flash=False (plain attention on the card, in float32 on the
   operands the policy gives it), both under the policy with backward()
   after its scope (mixed_fp16 on the loss times the default 2^15 scale)
   (float32: loss 1e-4, grads 1e-3 of each parameter's largest; the half
   policies 2e-2 for both; under "bfloat16" the bfloat16 plain path's
   distance is reported too); then,
   with the launch counters set to 0, one training step must launch the
   flash forward 24 times (12 blocks + 12 remat recomputes), dq 12 and
   dk/dv 12 times, every launch in the policy's flash dtype (bfloat16
   under "bfloat16", float32 under the others, whose Linears cast their
   outputs back to float32); then 5 more steps, every loss finite and
   the last below the first, timed on the host clock after a
   synchronize, with peak memory, each half policy's distance from the
   float32 losses (reported), and mixed_fp16's final scale and skipped
   steps;
9. timing of the flash kernels at the training shape in float32 and in
   bfloat16 (L2 flushed): kernel and plain ms, the operation/byte bound
   (float32 as three TF32 passes, bfloat16 at the dense bf16 rate), and
   torch's scaled_dot_product_attention forward (and its backward alone,
   on a kept graph) as the yardstick; then the whole backward (delta, dq
   and dk/dv, as the training step runs it) beside that SDPA backward,
   on a line of its own. The float32 rows take their launches from the
   float32 step, the bfloat16 rows from the "bfloat16" policy's;
10. BERT-base pretraining at full width, BASELINE config 3
   (``[train:bert_base]``, bench.py:354, and ``[train:bert_packed]``,
   bench.py:560): BertConfig.base() (12 layers, hidden 768, 12 heads,
   vocab 30522, dropout 0.1), seeded weights (seed 15), batch 32,
   sequence 128, mixed_bf16, Adam(1e-3) through Trainer. bert_base's
   batch is bench.py's (numpy seed 0: ids over every position, MLM
   labels = the ids, NSP labels) through forward_fused_loss;
   bert_packed's packs documents of 16-128 tokens (numpy seed 0) with
   pack_sequences and runs forward_packed_loss with their segment ids.
   Check steps under mixed_bf16 and float32: the kernels against plain
   attention on the same weights and, the generator re-seeded before
   each pass, the same layer-dropout masks and attention seeds (the
   loss, and each grad relative to its parameter's largest plain grad;
   float32 within 1e-4 and 1e-3; mixed_bf16 within 2e-2, or within twice
   the distance of a second plain pass, attention in float64, from the
   first where that is larger: the bf16 Linears turn float32-rounding
   differences in attention into ~2e-2 in the q/k projections' grads,
   the noise floor of two correct computations; the key projections'
   biases, whose gradient is 0 in exact arithmetic, are reported, not
   gated); one step launches each flash kernel exactly 12 times, all
   float32; then 5 Adam steps, finite and falling, with ms per step,
   samples/s, tokens/s (packed: real tokens too) and peak memory;
11. the three flash kernels timed at BERT's shape (B=32, T=128, H=12,
   D=64, non-causal, p=0.1, the packed batch's segment ids; float32 as
   under mixed_bf16): kernel, plain and SDPA ms (SDPA with the
   block-diagonal boolean mask and dropout 0.1, a yardstick that draws
   its own masks), and the bound from this batch's live (same-segment)
   scores; the rows ``<kernel>[segments+dropout]`` take their launches
   from bert_packed's counted step;
12. the checkpointed loop at bench_gpt's full width (``[train:loop]``):
   GPTConfig.small() with remat, batch (8, 1024), mixed_bf16, Adam(1e-3),
   weights seed 5, one seeded batch a step, through TrainLoop with
   checkpoint_every=2 and max_to_keep=2 in a temporary directory
   (removed at the end). First two trainers of one seed take the same
   two steps: a step is bit-deterministic on the card when every state
   leaf and loss agree, and the resume gates are then equality (else
   twice the loss distance seen). Run A takes 6 steps; run B 4 steps,
   keeps a host copy of its state and is dropped; run C, a model of
   another seed, resumes B's checkpoint and runs to 6. Gates: C resumes
   at step 4 with a state equal to B's step-4 state bit for bit, B's
   losses and C's steps 5-6 meet the gate against A's, exactly 2
   committed steps are on disk, and every loop step launches the flash
   kernels 24/12/12 times, all float32. Printed: the checkpoint's bytes
   against 12 x the parameter count and its checksum algorithm, each
   periodic save's blocking ms, the snapshot and whole-write ms of three
   timed saves, bare train_step host ms without and with an async save
   in flight, resume_restore_ms, and TrainLoop's host ms per step with
   no periodic save and with prefetch=2 (its host wait per step), their
   losses gated against A's;
13. BERT-base resumed mid-run (``[train:bert_resume]``): the bert_base
   configuration of phase 10 (dropout 0.1, mixed_bf16) through
   TrainLoop, 4 steps uninterrupted, and 2 steps, a checkpoint and a
   model of another seed resuming to 4; the same determinism check and
   gate on the losses at steps 3-4 (the key restores, and the in-kernel
   dropout seeds follow it), 12/12/12 float32 launches a loop step;
14. ``[train:mnist]``, BASELINE config 1 (bench.py:45-110): MnistMLP(512,
   256) at batch 8192 through Trainer.train_steps(batch, 8) (the key
   split once a call, then 8 ways, as the JAX scan), and MnistCNN at
   batch 128 through train_step, Adam(1e-3), 5 calls each on one seeded
   batch: losses finite and falling, ms per step and examples/s;
15. ``[train:resnet50]``, BASELINE config 2 (bench.py:327-352): a check
   step of resnet50(1000) at B=2, 224 px, NHWC and NCHW, the card
   against the CPU on the same weights and batch, in float64 (loss 1e-4,
   each grad within 1e-3 of its parameter's largest CPU-grad entry, the
   BN buffers after the forward 1e-4) and in float32 (the same loss and
   buffer limits; each grad's distance from the float64 pass within
   twice the CPU float32's worst, at least 1e-3: pre-activations within
   float32's rounding of zero flip their ReLU masks between any two
   float32 passes, and float32 grads sit up to ~0.2 of a parameter's
   largest entry from float64 on either device; cuDNN with TF32 off);
   then the bench
   cell, b128, 224 px, all-zero labels, Adam(1e-3), mixed_bf16, 2 warm-up
   and 5 timed steps (each ending in a synchronize) in NHWC, then NCHW:
   losses finite and falling, ms per step, images/s and peak memory;
16. ``[train:deepfm]``, BASELINE config 5 (bench.py:2197-2226 deepfm,
   dense updates through Trainer, and :2106-2194 deepfm_sparse,
   row-sparse updates through sparse_minimize_fn): 26 fields, 13 dense
   features, embed 16, tower (400, 400, 400), batch 4096, the stream
   seeded 0, ids uniform over the vocab and dense features normal
   (numpy seed 0), labels ids[:, 0] % 2, Adam(1e-3). A check step at
   V=100k, the card against the CPU on the same weights and batch, in
   float64 (loss 1e-4, each grad within 1e-3 of its parameter's largest
   CPU-grad entry) and float32 (reported); two sparse Adam steps
   against two dense ones (Optimizer.minimize_fn) on the same ids, in
   float32: every touched row and every dense parameter within 1e-5,
   rows outside the batch bitwise unchanged in the parameters and both
   Adam moments, merge_rows under torch's sync debug mode "error", and
   whether two runs of one sparse step are bit-equal (reported). Then
   the bench's cells under mixed_bf16, dense and sparse at V = 100k,
   1M (DeepFMConfig.criteo()) and 10M: 3 warm-up and 5 timed steps
   (each ending in a synchronize), losses finite and falling, ms per
   step, examples/s, peak memory, the host syncs of one more step and
   the AUC over the batch after it; then dense ms over sparse ms at
   each vocab (the crossover, reported). DeepFM runs no hand kernel.
   Each of the new phases prints its seconds;
17. ``[train:nmt]``, BASELINE config 4 (bench.py:485-513):
   NMTConfig.base() (6+6 layers, d_model 512, 8 heads, FFN 2048, vocab
   32000, dropout 0.1, label smoothing 0.1), the stream seeded 0,
   forward_fused_loss, Adam(1e-3), mixed_bf16. Check steps under
   mixed_bf16 and float32 on a B=16 batch with 128-token sources with
   padded tails (row 0 all pad) and 64-token targets, so cross-attention
   runs the kernels at Tq != Tk with a key mask and dropout: the kernels
   against plain attention, the generator re-seeded before each pass
   (the limits of the BERT check steps; every pass of the kernels
   launches each flash kernel 18 times, the plain passes none); one
   bench step (B=64, src = tgt = 64, numpy seed 0) launches each flash
   kernel exactly 18 times, all float32 (6 encoder self-attentions, 6
   causal decoder self-attentions, 6 cross-attentions); 5 timed steps
   (finite, falling), target tokens/s, peak memory and the device's idle
   share (torch.profiler); B=256 reported;
18. ``[serve:nmt]``, bench.py:599-648: the same model in eval mode,
   greedy_decode_cached at B=32, src 64, max_len 64 in float32 launches
   the contiguous decode kernel exactly 6 x 64 times, all float32, and
   no paged kernel; each emitted token (up to a row's first eos) sits
   within 1e-3 of its position's max logit when the output re-runs
   teacher-forced through forward; a call makes no host sync (torch's
   sync debug mode); under mixed_bf16 greedy_decode_cached and
   greedy_decode (the bench's --no-kv-cache) are timed, their tokens
   compared (reported); beam_decode_cached (B=8, beam 4, max_len 64,
   float32): each returned score within 1e-3 of the teacher-forced sum
   of its sequence's log-probabilities up to its first eos;
19. ``[train:vit]``, bench.py:655 bench_vit: a check step of
   ViTConfig.base() at B=2, 224 px, NHWC, the card against the CPU on
   the same weights and images, float64 gated (loss 1e-4, each grad
   1e-3 of its parameter's largest CPU entry; the key biases, 0 in exact
   arithmetic, reported) and float32 reported; then b128, remat,
   mixed_bf16, Adam(1e-3) in NHWC (2 warm-up and 5 timed steps) and
   NCHW (1 and 3): losses finite and falling, images/s, peak memory; no
   flash launch (197 tokens is not a multiple of 64);
20. the three flash kernels timed at the NMT's training shape (B=64,
   T=64, H=8, D=64, key mask, dropout 0.1, float32) beside their plain
   versions and SDPA (printed only; the kernels' record keeps the GPT
   and BERT shapes);
21. ``[train:bert_moe]``, bench.py:443-483 bench_bert_moe:
   BertConfig.base() with dropout 0 and an 8-expert top-1 Switch FFN
   (capacity factor 1.25), the stream seeded 0, B=16, T=128, bench's
   make_batch (numpy seed 0), mixed_bf16, Adam(1e-3), the loss + 0.01 x
   the layers' aux losses. Check steps under mixed_bf16 and float32:
   the kernels against plain attention on the same weights, every pass
   routed as the plain pass routed (the tokens a pass would have sent
   elsewhere, its routing flips, counted with their largest
   router-probability gap), at BERT's limits (float32 1e-4 and 1e-3;
   mixed_bf16 2e-2 or twice the float64 noise floor); one step launches
   each flash kernel exactly 12 times, all float32; 5 timed steps,
   finite and falling, examples/s, idle share, peak memory and each
   layer's kept_fraction; B=32 (BASELINE.md:56's row) reported;
22. ``[train:gpt_moe]``: GPTConfig.small() with 8 experts (capacity
   factor 1.25, no remat: MoE with remat=True must raise
   InvalidArgumentError) at bench_gpt's (8, 1024), the same loss, policy
   and gates as 21 (check steps at B=4), 12/12/12 float32 flash
   launches a step;
23. ``[serve:moe]``: that model (float32, seed 0) serving the GPT
   serving cell's 16 requests through the contiguous and the paged
   arena: each arena's decode kernel launches at least layers x ticks,
   no other decode kernel; tokens/s and ms per tick; then the same arena
   recorded on the card and on the CPU (same weights, prompts, slots and
   admission order, so every tick routes the same tokens at the same
   capacity): every logit row within 1e-3 of the CPU's up to the first
   divergence, which must be a routing flip at a router-probability gap
   below 1e-4 or a differing token whose two candidates' CPU logits are
   within 2e-3 (near ties); the share of identical tokens and
   kept_fraction over the decode ticks reported;
24. ``[train:zoo]``, bench.py:2259-2365: vgg16 b64, alexnet b256,
   googlenet b128 (its aux heads in the loss) and se_resnext50 b64 NHWC
   (and an NCHW point), 224 px, 1000 classes, mixed_bf16, Adam(1e-3),
   all-zero labels: each model's check step at B=2, card against CPU
   (dropout at 0), float64 gated (loss 1e-4, each grad 1e-3 of its
   parameter's largest CPU entry) and float32 reported; 2 warm-up and 5
   timed steps, finite and falling, images/s and peak memory; no hand
   kernel launches;
25. ``[train:stacked_lstm]``, bench.py:2227-2256: vocab 5149, embed and
   hidden 512, 3 layers, T=100, lengths in [50, 100], labels
   ids[:, 0] % 2; the float64 check step at B=4 with padded rows, then
   B=64 and B=512 under mixed_bf16: finite and falling, examples/s, ms
   per step, device ops per step and the idle share (the loop over time
   is host-paced);
26. ``[train:recommender]``, the recommender book model at MovieLens-1M's
   widths (6041 users, 3953 movies, 2 genders, 7 ages, 21 jobs, 19
   categories, embed 32, fc 200) on synthetic batches from numpy
   (ratings uniform in [1, 5], 3 category ids a row): a check step at
   B=4, card against CPU, float64 gated (loss 1e-4, each grad 1e-3 of
   its parameter's largest CPU entry) and float32 reported; then B=256
   and B=8192 in float32, Adam(5e-3), 20 steps (2 untimed): losses
   finite and falling, |pred| <= 5 (up to float32 rounding, 5 x (1 +
   1e-6)), samples/s, ms per step, device ops per step and the idle
   share; no hand kernel launches;
27. ``[train:lora]``, bench_gpt's shape (GPTConfig.small(), remat,
   max_position 1024, one (8, 1024) batch, mixed_bf16, weights seed 5):
   the full-parameter step, then apply_lora(r=8, alpha=16,
   targets=("q_proj", "v_proj")) on a fresh model of the same seed with
   every other parameter frozen, Adam(5e-3) through Trainer on the
   adapters only, 10 steps. Gates: one LoRA step launches the flash
   forward, dq and dk/dv as often as the full-parameter step; every
   frozen weight bitwise unchanged; no frozen weight has a gradient and
   the optimizer holds state for the adapters only; a lora_b off zero;
   losses finite and falling. Printed: ms per step and peak memory of
   both. Then merge_lora: the merged model's logits (2 x 128 tokens,
   float32) within 2 x the adapted model's distance from a float64 CPU
   forward of it, plus 2e-5 (the JAX test's bound), of the adapted
   model's; the merged model serves 8 requests through the paged
   BatchedDecoder, the paged kernel launching exactly layers x (ticks +
   admissions) times and no other kernel, every token held to the
   teacher-forced check;
28. ``[train:word2vec]``, the NCE book model (tests/test_book_models.py:
   86-99): the mean of 4 context embeddings into NCE(log_uniform, 5
   negatives) at PTB's 10000-word vocabulary, embed 32, B=4096, target
   = sum of the context mod the vocabulary (numpy seed 0): a check step
   with custom_neg (exact), card against CPU, float64 gated and float32
   reported; then 20 Adam(5e-2) steps with keyed negatives: finite and
   falling, samples/s;
29. ``[ops:library]``: each family of the op library (tensor, math,
   reduction, loss, sampling, sequence, control flow, metrics) on the
   card against the same call on the CPU at small shapes (floats within
   1e-5 + 1e-5 relative, integers equal): gather, gather_nd, scatter
   (set and add), scatter_nd_add and multiplex with indices out of range
   (the JAX fill, clamp and drop results) and top_k and argsort on ties,
   all under torch's sync debug mode "error" (no host read, no device
   assert); a while_loop, scan, static_rnn, TensorArray and chunk_eval.
   The repaired faults run in the same sync-free family: cross_entropy
   and bpr_loss with labels out of range, sequence_reverse and
   sequence_pool("last") with lengths past T, linear_chain_crf,
   edit_distance and ctc_loss with labels and lengths out of range
   (NaN fills and clamps, as the JAX package's), float-to-int cast
   saturating at int8, uint8 and int32 (NaN and +-inf), and the gradients
   of the clipped and kinked ops at their kinks.
   Printed: the count of ops checked and the host syncs of the ops whose
   sizes or predicates are read from the data;
30. ``[train:ssd]``, MobileNet-SSD's head on PASCAL VOC (PaddlePaddle
   models, PaddleCV/ssd/mobilenet_ssd.py: MultiBoxHead over maps of
   19x19x512, 10x10x1024, 5x5x512, 3x3x256, 2x2x256 and 1x1x128, 300
   px, base 300, 21 classes, min sizes 60-285, max sizes [[], 150, ...,
   300], aspect ratios [2] then [2, 3], flip: 1917 priors) on feature
   maps from numpy (the repo has no MobileNet backbone) and 1-8 ground
   truth boxes an image padded to 8 with a mask, labels 1..20: the
   check step at B=2, float64 card against CPU gated (loss 1e-4, each
   grad 1e-3 of its parameter's largest CPU entry; float32 reported);
   B=32 float32, Adam(1e-3), 10 steps through Trainer on ssd_loss's
   mean: finite and falling, ms per step, device ops per step and the
   idle share; then detection_output(nms_threshold=0.45, nms_top_k=400,
   keep_top_k=200) on the trained head's outputs at B=32: in float64
   the card's labels and valid masks equal the CPU's on the same head
   outputs and its scores and boxes lie within 1e-5 + 1e-5 relative
   (float32 reported), the card's decode under sync debug "error" (no
   host read); ms and device ops per call; DetectionMAP over the
   decoded boxes (reported); no hand kernel launches;
31. ``[ops:detection]``, the other detection paths at their published
   sizes, float64, card against CPU (floats 1e-5 + 1e-5 relative,
   integers and masks equal) under sync debug "error": Faster R-CNN's
   RPN at 800 px, stride 16 (anchor_generator on a 50x50 map, sizes
   32-512, ratios 0.5/1/2: 37500 anchors; generate_proposals with
   pre_nms_top_n 6000, post_nms_top_n 1000, nms_thresh 0.7;
   rpn_target_assign against 8 gt boxes; roi_align (sampling 2) and
   roi_pool of 512 RoIs at 7x7 on a C=256, 50x50 map;
   generate_proposal_labels; distribute_fpn_proposals and
   collect_fpn_proposals over levels 2-5), R-FCN's psroi_pool (7x7
   bins, 21 classes), YOLOv3's 13x13 head over 416 px (yolo_box, 80
   classes, 3 of the standard 9 anchors; yolov3_loss and its gradient at
   B=8 with 50 padded gt boxes), matrix_nms (80 classes x 500 boxes) and
   box_decoder_and_assign (512 x 81 classes); ms and device ops per
   call; no hand kernel launches;
32. ``[train:slim]``, slim compression on bench_gpt's shape (float32,
   (8, 1024), no remat): a GPTConfig.small() teacher (seed 11) distilled
   into a 6-layer student of the same widths (seed 12) through
   slim.Compressor with Adam(1e-3), 4 seeded batches an epoch, 3
   epochs, eval_fn minus the LM loss on a held-out batch, and the
   strategies DistillationStrategy(Distiller(): T 4, soft 0.7, hard 0.3)
   on epochs 0-2 and UniformPruneStrategy(0.5, structured, axis=1 over
   the six blocks.*.ffn.gate.weight) from epoch 2 (a zero gate column
   kills its FFN channel). Gates: each step launches the flash forward
   exactly 18 times (teacher 12, student 6), dq and dk/dv 6 times each,
   all float32, and no other hand kernel; one distillation step with the
   kernels against the same step on plain attention (same weights and
   batch): loss 1e-4, each student grad 1e-3 of its parameter's largest
   plain-grad entry; the 12 distilled losses finite, the last below the
   first; the teacher bitwise unchanged, with no grad and no optimizer
   state; after each epoch from 2 every masked entry exactly 0 and
   Pruner.sparsity within 0.005 of 0.5. Then shrink_params slices each
   gate's dead columns with up (axis 1) and down (axis 0) into a GPT of
   intermediate_size kept: its logits on the held-out batch within 1e-4
   x the masked student's largest |logit| of the masked student's; the
   shrunk and the masked student each serve the 8 prompts [train:lora]
   serves through the paged BatchedDecoder (the paged kernel exactly
   layers x (ticks + admissions), no other kernel, the teacher-forced
   check); fake_quantize_range_abs_max, 12 calls at window_size=4 on
   seeded (4096, 768) activations, card against CPU: states equal,
   outputs within one grid step (scale / 127), the differing entries
   counted. Printed: ms per step, tokens/s, peak memory, each epoch's
   ms and the mask search's, the kept width, the idle share of a step,
   and decode tokens/s and ms per tick of both students.

Any failure exits non-zero. The line before the last is the kernels'
JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import itertools
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, float32
# outside the tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the flash rows' float32 bound: a float32-accurate product can run as
# three TF32 products on the tensor cores (3 x flops at 495 TFLOP/s, a
# third of the TF32 rate, 165 TFLOP/s of float32 work); the CUDA cores'
# 67 TFLOP/s is the bound of a kernel that does not use them
TF32_FLOPS, TF32_PASSES = 495e12, 3
B, CAP, H, HKV, D, PS = 8, 2048, 12, 4, 64, 64
PAGES = B * CAP // PS + 8
T_CONTIG = [0, 63, 64, 700, 1023, 1024, 1777, 2047]
T_PAGED = [0, 63, 64, 700, 1024, 1777, 2047, CAP]    # last row parked
# on and beside the split's chunk edges (256 positions a chunk)
T_EDGE = [255, 256, 257, 511, 512, 513, 1279, 1280]
T_EDGE_PAGED = [255, 256, 257, 511, 512, 513, 1279, CAP]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_ROWS = {
    "decode_attention": dict(
        replaces="paddle_tpu/ops/pallas/flash_decode.py:130 "
                 "(_decode_kernel, via flash_decode :280)"),
    "decode_attention_paged": dict(
        replaces="paddle_tpu/ops/pallas/flash_decode.py:137 "
                 "(_paged_kernel, via flash_decode_paged :157)"),
    "decode_attention_paged_quant": dict(
        replaces="paddle_tpu/ops/pallas/flash_decode.py:146 "
                 "(_paged_kernel_quant, via flash_decode_paged(k_scale=, "
                 "v_scale=) :157)"),
}
QMM_REPLACES = ("paddle_tpu/ops/pallas/quant_matmul.py:45 (_kernel, via "
                "quant_matmul :186)")
QLIN_REPLACES = ("paddle_tpu/ops/pallas/quant_matmul.py:45 (_kernel, via "
                 "quant_matmul :186, with the encode, bias and ReLU around "
                 "it in paddle_tpu/quant/int8.py int8_linear :34)")
INT8_PEAK_OPS = 1979e12       # H100 SXM dense int8 tensor-core peak
# MnistMLP(512, 256) at bench.py's mnist batch: (M, K, N) of its layers
MNIST_BATCH = 8192
MNIST_SHAPES = [(MNIST_BATCH, 784, 512), (MNIST_BATCH, 512, 256),
                (MNIST_BATCH, 256, 10)]
# ResNet-50's int8 im2col GEMMs at batch 32, 224 px, as (name, M, K, N):
# the stem (7x7x3 taps, K 147 padded to 160 for the kernel), a layer1
# 3x3 conv and a layer4 3x3 conv
CONV_BATCH = 32
CONV_SHAPES = [("stem", CONV_BATCH * 112 * 112, 147, 64),
               ("layer1_3x3", CONV_BATCH * 56 * 56, 576, 64),
               ("layer4_3x3", CONV_BATCH * 7 * 7, 4608, 512)]
# the convolutional training cells (bench.py:327-352 bench_resnet50; the
# MNIST cell, bench.py:45-110, at its steps_per_call)
RESNET_BATCH, RESNET_PX, RESNET_POLICY = 128, 224, "mixed_bf16"
RESNET_CHECK_TOL = (1e-4, 1e-3, 1e-4)      # loss, grads, BN buffers
MNIST_STEPS_PER_CALL, CNN_BATCH = 8, 128
# DeepFM CTR training, BASELINE config 5 (bench.py:2197-2226 bench_deepfm,
# dense updates through Trainer, and :2106-2194 bench_deepfm_sparse,
# row-sparse updates through sparse_minimize_fn): 26 fields, 13 dense
# features, embed 16, tower (400, 400, 400), batch 4096, Adam(1e-3),
# mixed_bf16 (bench.py:2962); the vocab at the bench's default, at
# DeepFMConfig.criteo() and at 10M, a sweep point of the bench's --vocab
DEEPFM_BATCH, DEEPFM_POLICY = 4096, "mixed_bf16"
DEEPFM_VOCABS = (100_000, 1_000_000, 10_000_000)
DEEPFM_CHECK_TOL = (1e-4, 1e-3)     # float64 check step: loss, grads
DEEPFM_SPARSE_TOL = 1e-5            # sparse against dense, float32
# the JAX package's int8-vs-float logit contract (tests/test_serving.py)
# and its int8-vs-fake-quant bound (tests/test_quant_matmul.py)
INT8_KV_SPREAD, INT8_MLP_REL = 0.05, 0.1
FLASH_ROWS = {
    "flash_attention_fwd": dict(
        replaces="paddle_tpu/ops/pallas/flash_attention.py:187 "
                 "(_fwd_kernel, via _fwd_call :398)"),
    "flash_attention_dq": dict(
        replaces="paddle_tpu/ops/pallas/flash_attention.py:422 "
                 "(_dq_kernel, via _bwd_call :637)"),
    "flash_attention_dkv": dict(
        replaces="paddle_tpu/ops/pallas/flash_attention.py:497 "
                 "(_dkv_kernel, via _bwd_call :687)"),
}
# the training path: bench_gpt (bench.py:411-440) at full width
TB, TT, TH, THKV = 8, 1024, 12, 4
# (B, Tq, Tk, H, Hkv, D, causal, window, kv_mask): the training shape
# first, then each option the flash gate admits, query lengths that are
# not a multiple of the D=64 dq block's 128 rows, and the training shape
# at four times the length (dk/dv's longest walk, 3 x 4096 query rows)
FLASH_CASES = [
    (TB, TT, TT, TH, THKV, D, True, None, False),
    (2, 512, 512, 12, 4, 64, False, None, False),
    (2, 512, 512, 12, 12, 64, True, None, False),
    (2, 512, 512, 12, 1, 64, True, None, False),
    (2, 1024, 1024, 4, 2, 64, True, 256, False),
    (2, 512, 512, 4, 2, 64, False, 256, False),
    (3, 512, 512, 4, 2, 64, True, None, True),
    (2, 512, 1024, 4, 2, 64, True, None, False),
    (2, 192, 320, 4, 2, 64, True, None, False),
    (2, 192, 256, 4, 2, 64, False, None, False),
    (2, 64, 192, 4, 2, 64, True, None, False),
    (2, 64, 128, 4, 2, 64, False, None, True),
    (1, 4096, 4096, TH, THKV, D, True, None, False),
    (2, 256, 256, 4, 2, 128, True, None, True),
    (2, 256, 256, 4, 2, 256, True, 100, False),
]
# float32: the forward's online softmax rescales in another order than
# the plain whole-row softmax, and the backward pair sums in another order
# on the tensor cores (the plain version's own float32 error, up to 4.6e-5
# from float64, is most of their gap); bfloat16: one bf16
# rounding of an output of magnitude < 4 is <= 1.6e-2
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_DTYPES = ("float32", "bfloat16")
# the training check step, kernels against plain attention on the same
# weights, as (loss atol, each gradient's limit relative to its
# parameter's largest plain-grad entry). float32: 1e-4 (float32 sums over
# 8192 rows of ~10.4) and 1e-3 (float32 attention summed in another
# order, carried back through 12 blocks). The half policies: 2e-2 for
# both, the bfloat16 tolerance: the attention difference can flip a half
# rounding in a Linear after it, which the float32 limits are too tight
# for
TRAIN_TOL = {"float32": (1e-4, 1e-3), "mixed_bf16": (2e-2, 2e-2),
             "bfloat16": (2e-2, 2e-2), "mixed_fp16": (2e-2, 2e-2)}
# the flash options on the card, (B, T, H, Hkv, D, causal, segments,
# dropout_p, kv_mask): segments, dropout at 0.1 and 0.5, both with a
# kv_mask, causal and not, GQA, D 64 and 128; the first is BERT's shape
FLASH_OPTION_CASES = [
    (32, 128, 12, 12, 64, False, True, 0.1, False),
    (4, 256, 12, 4, 64, True, True, 0.0, False),
    (4, 256, 12, 12, 64, False, False, 0.5, False),
    (4, 256, 12, 4, 64, True, False, 0.1, False),
    (4, 192, 8, 2, 64, False, True, 0.1, True),
    (4, 256, 12, 12, 64, True, True, 0.5, True),
    (3, 256, 8, 2, 128, True, True, 0.5, True),
    (3, 256, 8, 8, 128, False, True, 0.1, False),
]
OPT = "[segments+dropout]"
# the flash options at Tq != Tk, (B, Tq, Tk, H, Hkv, D, causal, dropout_p,
# kv_mask): the NMT's cross-attention (64 queries against a padded
# 128-key memory, with a padded tail and a row with no live key) and a
# causal GQA case; both the causal mask and the dropout hash read row
# i + (tk - tq)
FLASH_CROSS_CASES = [
    (8, 64, 128, 8, 8, 64, False, 0.1, True),
    (4, 192, 320, 8, 2, 64, True, 0.5, True),
]
# the Transformer NMT, BASELINE config 4: bench.py:485-513 (training, B=64,
# src = tgt = 64, mixed_bf16) and :599-648 (greedy decode, B=32, src 64,
# max_len 64); B=256 is BASELINE.md:59's batch, reported as a card point.
# The check steps: B=16, a 128-token source with padded tails (one row
# fully padded) against a 64-token target, so that cross-attention runs
# the kernels at Tq != Tk with a live key mask and dropout
NMT_B, NMT_T, NMT_BIG_B, NMT_POLICY = 64, 64, 256, "mixed_bf16"
NMT_CHECK_B, NMT_CHECK_SRC, NMT_CHECK_TGT = 16, 128, 64
NMT_DECODE_B, NMT_BEAM_B, NMT_BEAM_K = 32, 8, 4
# the decode kernel at the greedy decode's shape (cache capacity =
# max_len 64), held against its plain version at these cursors
NMT_DECODE_CAP, NMT_DECODE_T = 64, (0, 1, 63)
# ViT-B/16, bench.py:655 bench_vit: b128, 224 px, remat, mixed_bf16; the
# check step card against CPU in float64 (loss, each grad relative to its
# parameter's largest CPU entry)
VIT_B, VIT_POLICY = 128, "mixed_bf16"
VIT_CHECK_TOL = (1e-4, 1e-3)
# BERT pretraining, BASELINE config 3 (bench.py:354 bench_bert_base and
# :560 bench_bert_packed): BertConfig.base(), batch 32, sequence 128,
# mixed_bf16 (bench.py:2962), Adam(1e-3)
BB, BT, BERT_POLICY = 32, 128, "mixed_bf16"
# the checkpointed loop: bench_gpt's default policy (bench.py:2962)
LOOP_POLICY = "mixed_bf16"
# the Switch-MoE FFN: bench.py:443-483 bench_bert_moe (BertConfig.base(),
# dropout 0, 8 experts top-1, capacity factor 1.25, T=128, B=16 the
# bench's _cap and B=32 BASELINE.md:56's row) and gpt-moe
# (GPTConfig.small() with 8 experts, no remat, bench_gpt's (8, 1024); its
# check steps at B=4), mixed_bf16, Adam(1e-3), the loss + 0.01 x the
# layers' aux losses; [serve:moe] holds the card's arena to the CPU's
# logits within MOE_SERVE_TOL, and a routing flip to a router-probability
# gap below MOE_FLIP_GAP (a near tie)
MOE_EXPERTS, MOE_AUX, MOE_POLICY = 8, 0.01, "mixed_bf16"
BERT_MOE_B, BERT_MOE_BIG_B, BERT_MOE_T, GPT_MOE_CHECK_B = 16, 32, 128, 4
MOE_SERVE_TOL, MOE_FLIP_GAP = 1e-3, 1e-4
# the zoo, bench.py:2259-2365 (224 px, 1000 classes, the bench's batches
# and layouts, mixed_bf16), and the stacked LSTM, bench.py:2227-2256; the
# float64 check steps card against CPU: loss, grads (ResNet-50's rule)
ZOO_CELLS = (("vgg16", 64, "NCHW"), ("alexnet", 256, "NCHW"),
             ("googlenet", 128, "NCHW"), ("se_resnext50", 64, "NHWC"))
ZOO_POLICY = "mixed_bf16"
CHECK_TOL = (1e-4, 1e-3)
LSTM_VOCAB, LSTM_WIDTH, LSTM_LAYERS, LSTM_T = 5149, 512, 3, 100
LSTM_BATCHES, LSTM_CHECK_B, LSTM_POLICY = (64, 512), 4, "mixed_bf16"
# MovieLens-1M's widths (RecommenderNet's defaults), in field order
REC_FIELDS = (6041, 2, 7, 21, 3953, 19)
REC_BATCHES, REC_STEPS, REC_CHECK_B = (256, 8192), 20, 4
LORA_RANK, LORA_ALPHA, LORA_TARGETS = 8, 16, ("q_proj", "v_proj")
LORA_POLICY, LORA_STEPS = "mixed_bf16", 10
# word2vec at PTB's vocabulary
W2V_VOCAB, W2V_EMBED, W2V_CTX, W2V_NEG = 10000, 32, 4, 5
W2V_BATCH, W2V_CHECK_B, W2V_STEPS = 4096, 8, 20
# MobileNet-SSD's multi_box_head on PASCAL VOC (PaddlePaddle models,
# PaddleCV/ssd/mobilenet_ssd.py): six maps, 300 px, 21 classes, 1917
# priors; ground truth padded to SSD_G boxes an image
SSD_MAPS = ((512, 19), (1024, 10), (512, 5), (256, 3), (256, 2), (128, 1))
SSD_HEAD = dict(image_size=300, num_classes=21, base_size=300,
                min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
                max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
                aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5, flip=True,
                offset=0.5)
SSD_PRIORS, SSD_G = 1917, 8
SSD_CHECK_B, SSD_B, SSD_STEPS = 2, 32, 10
SSD_DECODE = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200)
DET_TOL = 1e-5            # card against CPU, float64: atol and rtol


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    """One nvcc per source, all started together."""
    from paddle_tpu_torch.ops.kernels import _build

    names = ("decode_attention", "flash_attention", "quant_matmul")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    log(f"[build] {len(names)} sources in {time.perf_counter() - t0:.2f} s "
        f"wall")
    for b in built:
        log(f"[build] {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if ("Compiling entry" in line or "Used" in line
                    or "spill" in line):
                log(f"[build]   {line.strip()}")


def kernel_inputs(torch, dtype, seed=0):
    from paddle_tpu_torch.quant.ops import absmax_encode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    q = rand(B, 1, H, D)
    k, v = rand(B, CAP, HKV, D), rand(B, CAP, HKV, D)
    kp, vp = rand(PAGES, PS, HKV, D), rand(PAGES, PS, HKV, D)
    n_log = CAP // PS
    table = torch.randperm(PAGES, generator=gen, device=dev)
    table = table[:B * n_log].reshape(B, n_log).to(torch.int32)
    # garbage past the live range (rows 0 and 1 are live on page 0 and
    # pages 0-1 only); out-of-pool ids must be clamped, never read
    table[0, 1:] = 10 ** 6
    table[1, 2:] = -5
    t_c = torch.tensor(T_CONTIG, dtype=torch.int32, device=dev)
    t_p = torch.tensor(T_PAGED, dtype=torch.int32, device=dev)
    # int8 pools quantized per vector from the same floats
    kq, ks = absmax_encode(kp.float(), axis=-1)
    vq, vs = absmax_encode(vp.float(), axis=-1)
    return dict(q=q, k=k, v=v, kp=kp, vp=vp, table=table, t_c=t_c,
                t_p=t_p, kq=kq, ks=ks[..., 0].contiguous(), vq=vq,
                vs=vs[..., 0].contiguous())


def quant_planes(x):
    return x["kq"], x["ks"], x["vq"], x["vs"]


def phase_kernels(torch, K):
    """Each kernel against its plain version; returns the float32 max
    abs error per kernel."""
    err = {name: 0.0 for name in KERNEL_ROWS}

    def hold(name, dname, what, got, want):
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        ok = e <= TOL[dname] and bool(torch.isfinite(got).all())
        log(f"[kernels] {name} {dname} {what}: max abs err {e:.3e} (atol "
            f"{TOL[dname]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version "
                             f"({dname}, {what})")
        if dname == "float32":
            err[name] = max(err[name], e)

    for dname, edges in itertools.product(("float32", "bfloat16"),
                                          (False, True)):
        x = kernel_inputs(torch, getattr(torch, dname))
        if edges:
            x["t_c"] = torch.tensor(T_EDGE, dtype=torch.int32,
                                    device="cuda")
            x["t_p"] = torch.tensor(T_EDGE_PAGED, dtype=torch.int32,
                                    device="cuda")
        for window in (None, 256, 100):
            pairs = {
                "decode_attention": (
                    K.decode_attention(x["q"], x["k"], x["v"], x["t_c"],
                                       window=window),
                    K.decode_attention_plain(x["q"], x["k"], x["v"],
                                             x["t_c"], window)),
                "decode_attention_paged": (
                    K.decode_attention_paged(x["q"], x["kp"], x["vp"],
                                             x["table"], x["t_p"],
                                             window=window),
                    K.decode_attention_paged_plain(
                        x["q"], x["kp"], x["vp"], x["table"], x["t_p"],
                        window)),
                "decode_attention_paged_quant": (
                    K.decode_attention_paged_quant(
                        x["q"], *quant_planes(x), x["table"], x["t_p"],
                        window=window),
                    K.decode_attention_paged_quant_plain(
                        x["q"], *quant_planes(x), x["table"], x["t_p"],
                        window)),
            }
            for name, (got, want) in pairs.items():
                hold(name, dname, f"{'chunk-edge' if edges else 'phase-3'} "
                     f"cursors window={window}", got, want)
    # the NMT's greedy_decode_cached shape: one 256-key chunk; the cursor
    # a Python int, as the model passes it, or one per row
    b, cap, h, d = NMT_DECODE_B, NMT_DECODE_CAP, 8, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = torch.tensor([NMT_DECODE_T[i % 3] for i in range(b)],
                        dtype=torch.int32, device="cuda")
    for dname in ("float32", "bfloat16"):
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda")
                   .to(getattr(torch, dname))
                   for shape in ((b, 1, h, d), (b, cap, h, d),
                                 (b, cap, h, d)))
        for t in (*NMT_DECODE_T, rows):
            cursor = f"per row {NMT_DECODE_T}" if torch.is_tensor(t) else t
            hold("decode_attention", dname, f"NMT shape (B={b}, cap={cap}, "
                 f"H=Hkv={h}, D={d}) t={cursor}",
                 K.decode_attention(q, k, v, t),
                 K.decode_attention_plain(q, k, v, t))
    return err


def qmm_operands(torch, m, k, n, gen):
    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    sa = torch.rand((), generator=gen, device="cuda") * 0.01
    return i8(m, k), i8(k, n), sa


def phase_qmm_kernels(torch, QM):
    """The int8 matrix product and its fused form against their plain
    versions, required exactly equal; returns the largest difference
    seen for each (0.0)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = worst_lin = 0.0
    for _, m, k, n in CONV_SHAPES:
        # the int8 conv's entry: the weight packed once, the im2col
        # already in K16 columns (the stem's 147 -> 160, zeros past K)
        a, b, sa = qmm_operands(torch, m, k, n, gen)
        k16 = -(-k // 16) * 16
        a16 = torch.zeros((m, k16), dtype=torch.int8, device="cuda")
        a16[:, :k] = a
        sb = torch.rand((n,), generator=gen, device="cuda") * 0.01
        w_packed = QM.pack_weight(b)
        want = QM.quant_matmul_plain(a, b, sa, sb)
        for what, got in (("quant_matmul", QM.quant_matmul(a, b, sa, sb)),
                          ("quant_matmul_packed", QM.quant_matmul_packed(
                              a16, w_packed, sa, sb))):
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            e = (got - want).abs().max().item()
            log(f"[kernels] {what} {m}x{k}x{n} (conv im2col, K padded to "
                f"{k16}) per-channel float32: max abs diff {e:.3e} (exact "
                f"required) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{what} disagrees with its plain version "
                                 f"at a conv shape")
            worst = max(worst, e)
        del a, a16, want
    for m, k, n in MNIST_SHAPES + [(33, 100, 17)]:
        a, b, sa = qmm_operands(torch, m, k, n, gen)
        for sb in (torch.rand((), generator=gen, device="cuda") * 0.01,
                   torch.rand((n,), generator=gen, device="cuda") * 0.01):
            for dt in (torch.float32, torch.bfloat16):
                got = QM.quant_matmul(a, b, sa, sb, out_dtype=dt)
                want = QM.quant_matmul_plain(a, b, sa, sb, out_dtype=dt)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                ok = torch.equal(got, want)
                log(f"[kernels] quant_matmul {m}x{k}x{n} "
                    f"{'per-channel' if sb.ndim else 'per-tensor'} "
                    f"{str(dt)[6:]}: max abs diff {e:.3e} (exact "
                    f"required) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("quant_matmul disagrees with its plain "
                                     "version")
                worst = max(worst, e)
        x = torch.randn(m, k, generator=gen, device="cuda") * 2
        a_scale = torch.tensor(3.0 / 127, device="cuda")
        w_scale = torch.rand((n,), generator=gen, device="cuda") * 0.01
        bias = torch.randn(n, generator=gen, device="cuda")
        w_packed = QM.pack_weight(b)
        for bb, relu, dt in itertools.product(
                (None, bias), (False, True), (torch.float32, torch.bfloat16)):
            got = QM.quant_linear(x, w_packed, a_scale, w_scale, bb, relu,
                                  out_dtype=dt)
            want = QM.quant_linear_plain(x, w_packed, a_scale, w_scale, bb,
                                         relu, out_dtype=dt)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            ok = torch.equal(got, want)
            log(f"[kernels] quant_linear {m}x{k}x{n} bias="
                f"{bb is not None} relu={relu} {str(dt)[6:]}: max abs diff "
                f"{e:.3e} (exact required) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("quant_linear disagrees with its plain "
                                 "version")
            worst_lin = max(worst_lin, e)
    return worst, worst_lin


def phase_paged_write(torch):
    """paged_kv.write_rows on the card, into float and into int8 pools,
    drops the parked row without a host sync and writes the live rows
    exactly where a plain loop does."""
    from paddle_tpu_torch.ops import paged_kv
    from paddle_tpu_torch.quant.ops import absmax_encode

    x = kernel_inputs(torch, torch.float32, seed=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    k_t = torch.randn(B, 1, HKV, D, generator=gen, device="cuda")

    def int8_planes(vec):
        q, s = absmax_encode(vec, axis=-1)
        return [q, s[..., 0]]

    arms = {"float": ([x["kp"]], [x["vp"]], lambda vec: [vec]),
            "int8": ([x["kq"], x["ks"]], [x["vq"], x["vs"]], int8_planes)}
    for arm, (k_planes, v_planes, encode) in arms.items():
        got_k = [p.clone() for p in k_planes]
        got_v = [p.clone() for p in v_planes]
        kp, vp = ((paged_kv.QuantizedPool(*g) if arm == "int8" else g[0])
                  for g in (got_k, got_v))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            paged_kv.write_rows(kp, vp, x["table"], x["t_p"], k_t, -k_t, PS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want_k = [p.clone() for p in k_planes]
        want_v = [p.clone() for p in v_planes]
        for b, t in enumerate(T_PAGED):
            if t >= CAP:                        # the parked row drops
                continue
            page = int(x["table"][b, t // PS])
            for want, vec in ((want_k, k_t[b, 0]), (want_v, -k_t[b, 0])):
                for plane, val in zip(want, encode(vec)):
                    plane[page, t % PS] = val
        if not all(torch.equal(g, w) for g, w in zip(got_k + got_v,
                                                      want_k + want_v)):
            raise SystemExit(f"paged write_rows ({arm} pools) disagrees "
                             "with its plain loop")
        log(f"[kernels] paged write_rows, {arm} pools: no host sync, parked "
            "row dropped, live rows exact")


def teacher_logits(torch, model, prompt, out):
    """Logits at the positions that predicted ``out`` when prompt + out
    re-run through _chunk_logits on a fresh cache: (len(out), V)."""
    seq = torch.as_tensor(list(prompt) + [int(x) for x in out],
                          device=model.device)
    caches = [blk.self_attn.init_cache(1, -(-len(seq) // 128) * 128)
              for blk in model.blocks]
    logits, _ = model._chunk_logits(seq[None], caches, 0)
    return logits[0, len(prompt) - 1:len(prompt) - 1 + len(out)].float()


def teacher_forced_check(torch, model, prompts, outs):
    """Every emitted token must be within 1e-3 of the max logit at its
    position when prompt + output re-run through _chunk_logits."""
    worst = 0.0
    with torch.inference_mode():
        for p, o in zip(prompts, outs):
            rows = teacher_logits(torch, model, p, o)
            if not bool(torch.isfinite(rows).all()):
                raise SystemExit("non-finite logits in the teacher-forced "
                                 "run")
            picked = rows[torch.arange(len(o)), torch.as_tensor(
                [int(x) for x in o], device=rows.device)]
            worst = max(worst, (rows.max(dim=-1).values - picked).max()
                        .item())
    if worst > 1e-3:
        raise SystemExit(f"teacher-forced check failed: an emitted token "
                         f"sits {worst:.3e} below its position's max logit")
    return worst


def decode_counts(K):
    return {name: getattr(K, name).launches for name in KERNEL_ROWS}


def mode_kernel(kw):
    return ("decode_attention_paged_quant" if kw.get("kv_dtype")
            else "decode_attention_paged" if kw.get("pages")
            else "decode_attention")


def serve(torch, K, model, prompts, max_new=32, streams=None, **kw):
    """One counted run through BatchedDecoder(slots=8, capacity=2048,
    **kw): warmed through warm_step(), the launch counters set to 0 just
    before run() and read just after. Returns a dict: dec, outs, reqs
    (the Request objects, for their token stamps), wall, launches."""
    from paddle_tpu_torch.serving import BatchedDecoder

    dec = BatchedDecoder(model, slots=8, capacity=CAP, device=model.device,
                         **kw)
    dec.warm_step()
    streams = streams or [None] * len(prompts)
    rids = [dec.submit(p, max_new, stream=s)
            for p, s in zip(prompts, streams)]
    reqs = list(dec.queue)
    torch.cuda.synchronize()
    for name in KERNEL_ROWS:
        getattr(K, name).launches = 0
    t0 = time.perf_counter()
    outs = dec.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decode_counts(K)
    outs = [outs[r] for r in rids]
    for o in outs:
        if o.shape != (max_new,) or o.min() < 0 or o.max() >= 32000:
            raise SystemExit(f"malformed output {o}")
    return dict(dec=dec, outs=outs, reqs=reqs, wall=wall,
                launches=launches)


def decode_steps_of(dec):
    """Decode steps the run's plain ticks took (a tick of k steps counts
    k), from the decoder's own tick accounting."""
    return dec.tick_capacity // dec.slots


def check_launches(tag, launches, need):
    """``need``: kernel -> least launches; every other decode kernel 0."""
    for name, n in launches.items():
        if n < need.get(name, 0) or (name not in need and n):
            raise SystemExit(f"{tag}: decode launches {launches}, needed "
                             f"{need} and no other decode kernel")


def run_line(run):
    """tokens/s, ms per tick, tokens per tick, host ms per tick-token."""
    dec = run["dec"]
    toks = sum(len(o) for o in run["outs"])
    return (f"{toks} tokens in {run['wall']:.3f} s: "
            f"{toks / run['wall']:.1f} tokens/s; {dec.tick_count} ticks, "
            f"{1e3 * dec.tick_seconds / dec.tick_count:.3f} ms per tick, "
            f"{dec.tick_tokens / dec.tick_count:.2f} tokens per tick, "
            f"{1e3 * dec.tick_seconds / dec.tick_tokens:.4f} host ms per "
            f"tick token")


def ms_per_token(dec):
    return 1e3 * dec.tick_seconds / dec.tick_tokens


def phase_serving(torch, K, model, prompts, mode, kw, max_new=32):
    """Serve the prompts through one arena with the launch counters at 0:
    its decode kernel must launch at least once per layer per tick, the
    other decode kernels never. Float arenas also hold every token to
    the teacher-forced check. Returns the outputs, the kernel's launches,
    the ticks and the run."""
    kernel = mode_kernel(kw)
    run = serve(torch, K, model, prompts, max_new, **kw)
    dec, outs, launches = run["dec"], run["outs"], run["launches"]
    check_launches(f"[serve:{mode}]", launches,
                   {kernel: model.cfg.num_layers * dec.tick_count})
    gap = ""
    if not kw.get("kv_dtype"):
        gap = (f"; teacher-forced worst gap "
               f"{teacher_forced_check(torch, model, prompts, outs):.2e}")
    lens = [len(p) for p in prompts]
    lo, hi = min(lens), max(lens) + max_new - 1
    split = ("every" if lo >= 256 and len(prompts) <= dec.slots
             else "no" if hi < 256 else "some")
    log(f"[serve:{mode}] {len(outs)} requests, {run_line(run)}; launches "
        f"{launches}{gap}; live keys per row {lo}-{hi}: {split} decode "
        f"call has a row of 256 or more")
    return outs, launches[kernel], dec.tick_count, run


def is_sync_warning(w) -> bool:
    """A warning of torch's sync debug mode about a synchronizing call;
    not the notice its first use in a process gives ("Synchronization
    debug mode is a prototype feature ..."), which a count taken in the
    first such window would otherwise include."""
    msg = str(w.message)
    return "synchroniz" in msg and "prototype feature" not in msg


def host_syncs_per_tick(torch, model, prompts, kw, k, ticks=4):
    """Synchronizing CUDA calls in each of ``ticks`` decode ticks of a full
    arena at decode_steps=k (torch's sync debug mode, counted as
    warnings): the tick's one host read of its token block is one."""
    import warnings

    from paddle_tpu_torch.serving import BatchedDecoder

    dec = BatchedDecoder(model, slots=8, capacity=CAP, device=model.device,
                         decode_steps=k, **kw)
    dec.warm_step()
    for p in prompts[:8]:
        dec.submit(p, 32)
    counts = []
    with torch.inference_mode():
        dec._admit()
        torch.cuda.synchronize()
        for _ in range(ticks):
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    dec._step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            counts.append(sum(map(is_sync_warning, got)))
    return counts


def phase_multistep(torch, K, model, prompts, base):
    """decode_steps=4, contiguous and paged: launches >= 4 x 12 a tick,
    teacher-forced, one host read a tick; tokens against the k=1 arena
    (``base``: mode -> (outs, run)), ms per token against k=1."""
    L = model.cfg.num_layers
    paged = dict(pages=B * 32 + 8, page_size=PS)
    for mode, kw in (("contiguous", {}), ("paged", paged)):
        tag = f"[serve:multistep] {mode}"
        outs1, run1 = base[mode]
        run = serve(torch, K, model, prompts, decode_steps=4, **kw)
        dec, outs = run["dec"], run["outs"]
        steps = decode_steps_of(dec)
        check_launches(tag, run["launches"], {mode_kernel(kw): L * steps})
        if run["launches"][mode_kernel(kw)] < 4 * L * dec.tick_count:
            raise SystemExit(f"{tag}: fewer than 4 x {L} launches a tick")
        gap = teacher_forced_check(torch, model, prompts, outs)
        same, diffs = 0, []
        with torch.inference_mode():
            for p, a, b in zip(prompts, outs1, outs):
                d = (a != b).nonzero()[0]
                if not len(d):
                    same += 1
                    continue
                i = int(d[0])
                rows = teacher_logits(torch, model, p, a[:i + 1])
                diffs.append((i, (rows[i, int(a[i])] - rows[i, int(b[i])])
                              .item()))
        syncs = {k: host_syncs_per_tick(torch, model, prompts, kw, k)
                 for k in (1, 4)}
        d1 = run1["dec"]
        log(f"{tag} 16 requests, {run_line(run)}; launches "
            f"{run['launches']} ({steps} decode steps); teacher-forced "
            f"worst gap {gap:.2e}; {same}/16 requests equal the k=1 "
            f"arena's (first differing position and k=1 - k=4 token logit "
            f"gap there: {diffs}); tick_tokens/tick_capacity "
            f"{dec.tick_tokens / dec.tick_capacity:.4f} (k=1 "
            f"{d1.tick_tokens / d1.tick_capacity:.4f}); host ms per tick "
            f"token {ms_per_token(dec):.4f} against k=1's "
            f"{ms_per_token(d1):.4f} ({ms_per_token(dec) / ms_per_token(d1):.3f}"
            f"x); host syncs per tick k=1 {syncs[1]}, k=4 {syncs[4]}")
        if syncs[4] != [1] * len(syncs[4]):
            raise SystemExit(f"{tag}: a k=4 tick made {syncs[4]} host "
                             "syncs, not the one read of its token block")
        del run, dec


def phase_prefix(torch, K, model, prompts):
    """prefix_cache=True, paged, float and int8: 16 requests of a shared
    192-token prefix plus the 8-48-token suffixes, against a cold run."""
    L = model.cfg.num_layers
    shared = torch.randint(1, 32000, (192,),
                           generator=torch.Generator().manual_seed(2))
    pp = [shared.tolist() + list(p) for p in prompts]
    pages = B * 32 + 8
    for kv in (None, "int8"):
        tag = f"[serve:prefix] {kv or 'float32'}"
        kw = dict(pages=pages, page_size=PS, kv_dtype=kv)
        cold = serve(torch, K, model, pp, **kw)
        hot = serve(torch, K, model, pp, prefix_cache=True, **kw)
        dec = hot["dec"]
        for run in (cold, hot):
            check_launches(tag, run["launches"], {
                mode_kernel(kw): L * decode_steps_of(run["dec"])})
        held = {int(i) for v in dec._prefix_registry.values() for i in v}
        free = dec._allocator.free_pages
        if free + len(held) != pages:
            raise SystemExit(f"{tag}: pages leaked: {free} free + "
                             f"{len(held)} held by the registry != {pages}")
        if dec.prefix_hits < 8:
            raise SystemExit(f"{tag}: {dec.prefix_hits} prefix hits of "
                             f"{dec.prefix_lookups} lookups, fewer than 8")
        gap = ""
        if kv is None:
            gap = (f"; teacher-forced worst gap "
                   f"{teacher_forced_check(torch, model, pp, hot['outs']):.2e}")
        same = sum(int((a == b).all()) for a, b in zip(cold["outs"],
                                                        hot["outs"]))
        log(f"{tag} prefix hits {dec.prefix_hits}/{dec.prefix_lookups} "
            f"lookups; {same}/16 requests equal the cold run's (near ties "
            f"reported, not gated); no page leaked ({len(held)} held by the "
            f"registry); hot: {run_line(hot)}; cold: {run_line(cold)}; "
            f"launches hot {hot['launches']}{gap}")
        del cold, hot, dec


def longest_gap(reqs):
    """The longest wait between two tokens of one request (s)."""
    return max(max(b - a for a, b in zip(r.t_tokens, r.t_tokens[1:]))
               for r in reqs)


def phase_chunked(torch, K, model, prompts, long_prompts):
    """prefill_chunk=64, contiguous and paged: the 8 long prompts
    interleaved with 8 short ones, against monolithic prefill."""
    L = model.cfg.num_layers
    mixed = [p for pair in zip(long_prompts, prompts[:8]) for p in pair]
    paged = dict(pages=B * 32 + 8, page_size=PS)
    for mode, kw in (("contiguous", {}), ("paged", paged)):
        tag = f"[serve:chunked] {mode}"
        mono = serve(torch, K, model, mixed, **kw)
        chunk = serve(torch, K, model, mixed, prefill_chunk=64, **kw)
        for run in (mono, chunk):
            check_launches(tag, run["launches"], {
                mode_kernel(kw): L * decode_steps_of(run["dec"])})
        gap = teacher_forced_check(torch, model, mixed, chunk["outs"])
        teacher_forced_check(torch, model, mixed, mono["outs"])
        same = sum(int((a == b).all()) for a, b in zip(mono["outs"],
                                                        chunk["outs"]))
        log(f"{tag} 16 requests (8 of {min(map(len, long_prompts))}-"
            f"{max(map(len, long_prompts))} prompt tokens); longest "
            f"inter-token gap of a request {1e3 * longest_gap(chunk['reqs']):.1f}"
            f" ms chunked against {1e3 * longest_gap(mono['reqs']):.1f} ms "
            f"monolithic; chunked: {run_line(chunk)}; monolithic: "
            f"{run_line(mono)}; {same}/16 equal; teacher-forced worst gap "
            f"{gap:.2e}; launches {chunk['launches']}")
        del mono, chunk


def phase_spec(torch, K, model, prompts, plain):
    """gamma=4, contiguous and paged, with the target as its own draft
    (A) and with a 2-layer GPTConfig.small()-width draft of seed 7 (B).
    The draft steps run the contiguous decode kernel (the draft's arena
    is contiguous); a paged target re-steps each prompt's last token
    through the paged kernel at admission."""
    import dataclasses

    from paddle_tpu_torch.models import gpt

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    small = gpt.GPTConfig.small()
    draft_b = gpt.GPTForCausalLM(dataclasses.replace(small, num_layers=2),
                                 device=model.device, generator=gen).eval()
    L, gamma = model.cfg.num_layers, 4
    paged = dict(pages=B * 32 + 8, page_size=PS)
    for dname, draft in (("self-draft", model), ("2-layer draft", draft_b)):
        for mode, kw in (("contiguous", {}), ("paged", paged)):
            tag = f"[serve:spec] {dname} {mode}"
            run = serve(torch, K, model, prompts, draft=draft, gamma=gamma,
                        **kw)
            dec = run["dec"]
            need = {"decode_attention": draft.cfg.num_layers * (gamma + 1)
                    * dec.spec_rounds}
            if kw:
                need["decode_attention_paged"] = L * len(prompts)
            check_launches(tag, run["launches"], need)
            gap = teacher_forced_check(torch, model, prompts, run["outs"])
            rate = dec.spec_accepted / (dec.spec_row_rounds * gamma)
            per_round = dec.spec_accepted / dec.spec_row_rounds
            if draft is model and rate <= 0.7:
                raise SystemExit(f"{tag}: self-draft acceptance {rate:.3f}"
                                 " <= 0.7 per drafted token")
            same = sum(int((a == b).all())
                       for a, b in zip(plain[mode][0], run["outs"]))
            log(f"{tag} {dec.spec_rounds} rounds, {dec.spec_row_rounds} row "
                f"rounds; acceptance {rate:.4f} per drafted token, "
                f"{per_round:.3f} accepted per round, "
                f"{1 + per_round:.3f} tokens per target call; "
                f"{run_line(run)}; host ms per tick token against the plain"
                f" arena's {ms_per_token(plain[mode][1]['dec']):.4f}; "
                f"{same}/16 requests equal the plain arena's; "
                f"teacher-forced worst gap {gap:.2e}; launches "
                f"{run['launches']}")
            del run, dec
    del draft_b


def phase_handoff(torch, K, model, prompts, long_prompts):
    """prefill_export on one paged decoder -> to_bytes -> from_bytes ->
    inject_prefilled into another, float and int8, against the same
    requests served directly by a decoder with the same options."""
    from paddle_tpu_torch.serving import BatchedDecoder, KVHandoff

    L = model.cfg.num_layers
    hp = list(prompts[:6]) + list(long_prompts[:2])
    for kv in (None, "int8"):
        tag = f"[serve:handoff] {kv or 'float32'}"
        kw = dict(pages=B * 32 + 8, page_size=PS, kv_dtype=kv)
        worker = BatchedDecoder(model, slots=8, capacity=CAP,
                                device=model.device, **kw)
        worker.warm_step()
        export_ms, wire, nbytes, handoffs = [], [], [], []
        for p in hp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = worker.prefill_export(p)
            export_ms.append(1e3 * (time.perf_counter() - t0))
            data = h.to_bytes()
            wire.append(len(data))
            nbytes.append(h.nbytes)
            handoffs.append(KVHandoff.from_bytes(data))
        del worker
        dec = BatchedDecoder(model, slots=8, capacity=CAP,
                             device=model.device, **kw)
        dec.warm_step()
        inject_ms = []
        plain_import = dec._import_handoff

        def timed_import(s, r):
            t0 = time.perf_counter()
            plain_import(s, r)
            torch.cuda.synchronize()
            inject_ms.append(1e3 * (time.perf_counter() - t0))

        dec._import_handoff = timed_import
        rids = [dec.inject_prefilled(h, 32) for h in handoffs]
        torch.cuda.synchronize()
        for name in KERNEL_ROWS:
            getattr(K, name).launches = 0
        got = dec.run()
        launches = decode_counts(K)
        got = [got[r] for r in rids]
        check_launches(tag, launches,
                       {mode_kernel(kw): L * decode_steps_of(dec)})
        direct = serve(torch, K, model, hp, **kw)["outs"]
        same = sum(int((a == b).all()) for a, b in zip(got, direct))
        if same != len(hp):
            raise SystemExit(f"{tag}: {same}/{len(hp)} injected requests "
                             "equal the directly served ones")
        gap = ""
        if kv is None:
            gap = (f"; teacher-forced worst gap "
                   f"{teacher_forced_check(torch, model, hp, got):.2e}")
        log(f"{tag} {len(hp)} prompts of {[len(p) for p in hp]} tokens: "
            f"{same}/{len(hp)} injected requests equal the directly served "
            f"ones; handoff nbytes {nbytes}, wire bytes {wire}; export ms "
            f"{[round(x, 3) for x in export_ms]}; inject (import at "
            f"admission) ms {[round(x, 3) for x in inject_ms]}; launches "
            f"{launches}{gap}")
        del dec, handoffs


def phase_stream(torch, K, model, prompts):
    """4 requests with TokenStreams: three consumers read as tokens
    arrive, the fourth (a 4-record buffer) reads nothing until run()
    has returned."""
    import threading

    from paddle_tpu_torch.serving import TokenStream

    streams = [TokenStream() for _ in range(3)] + [TokenStream(maxlen=4)]
    got = [None] * 4

    def consume(i):
        got[i] = [r["tok"] for r in streams[i] if "i" in r]

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(3)]
    for th in threads:
        th.start()
    kw = dict(pages=B * 32 + 8, page_size=PS)
    run = serve(torch, K, model, prompts[:4], streams=streams, **kw)
    for th in threads:
        th.join(timeout=60)
    consume(3)
    check_launches("[serve:stream]", run["launches"], {
        mode_kernel(kw): model.cfg.num_layers * decode_steps_of(run["dec"])})
    for i, (g, o) in enumerate(zip(got, run["outs"])):
        if g != o.tolist():
            raise SystemExit(f"[serve:stream] stream {i} delivered {g}, "
                             f"the result is {o.tolist()}")
    gap = teacher_forced_check(torch, model, prompts[:4], run["outs"])
    log(f"[serve:stream] 4 streams equal their results; the stalled "
        f"consumer's stream stalled {streams[3].stalled_s:.4f} s while the "
        f"arena ran on; {run_line(run)}; teacher-forced worst gap "
        f"{gap:.2e}; launches {run['launches']}")


def phase_w8a16(torch, K, model, prompts, float_run):
    """apply_weight_only_int8 on a copy of the model, served contiguous;
    its logits against the float model's on the float run's sequences."""
    import copy

    from paddle_tpu_torch.quant import apply_weight_only_int8

    wm = copy.deepcopy(model)
    wrapped = apply_weight_only_int8(wm)
    run = serve(torch, K, wm, prompts)
    check_launches("[serve:w8a16]", run["launches"], {
        "decode_attention": wm.cfg.num_layers * decode_steps_of(run["dec"])})
    gap = teacher_forced_check(torch, wm, prompts, run["outs"])
    num = den = 0.0
    agree = total = 0
    with torch.inference_mode():
        for p, o in zip(prompts, float_run["outs"]):
            f = teacher_logits(torch, model, p, o)
            w = teacher_logits(torch, wm, p, o)
            num += ((w - f) ** 2).sum().item()
            den += (f ** 2).sum().item()
            agree += int((w.argmax(-1) == f.argmax(-1)).sum())
            total += len(o)
    rel, frac = math.sqrt(num / den), agree / total
    toks = sum(len(o) for o in run["outs"])
    ftoks = sum(len(o) for o in float_run["outs"])
    log(f"[serve:w8a16] {len(wrapped)} Linears W8A16; {run_line(run)}; "
        f"{toks / run['wall']:.1f} tokens/s against float32's "
        f"{ftoks / float_run['wall']:.1f}; teacher-forced logits against "
        f"the float model: relative norm {rel:.5f} (limit 0.03), argmax "
        f"agreement {frac:.4f} (limit 0.9); teacher-forced worst gap "
        f"(against itself) {gap:.2e}; launches {run['launches']}")
    if rel >= 0.03 or frac <= 0.9:
        raise SystemExit("[serve:w8a16] logits leave the JAX package's "
                         "W8A16 bound")
    del wm, run


def phase_int8_logits(torch, model):
    """The JAX package's int8-KV logit contract at full width: a 37-token
    prompt prefilled into a float and an int8 pool, then 6 steps
    teacher-forced along the float argmax; every step's int8 logits
    within 0.05 x the float logits' spread."""
    from paddle_tpu_torch.serving import PagedKVPool

    attn0 = model.blocks[0].self_attn
    dev = model.device

    def mint(kv_dtype):
        al = PagedKVPool(2, PS, attn0.num_kv_heads, attn0.head_dim,
                         arrays=False, kv_dtype=kv_dtype, device=dev)
        table = torch.as_tensor(al.alloc(2), device=dev)[None]
        return [(al.empty_pool(), al.empty_pool()) for _ in model.blocks], \
            table

    (pf, tf), (pq, tq) = mint(None), mint("int8")
    prompt = torch.randint(1, 32000, (1, 37),
                           generator=torch.Generator().manual_seed(83))
    prompt = prompt.to(dev)
    with torch.inference_mode():
        lf, pf = model._chunk_logits_paged(prompt, pf, tf[0], 0)
        lq, pq = model._chunk_logits_paged(prompt, pq, tq[0], 0)
        spread = (lf.max() - lf.min()).item()
        worst = [(lq - lf).abs().max().item() / spread]
        tok = lf[:, -1].argmax(-1)
        for i in range(6):
            t = torch.full((1,), 37 + i, dtype=torch.int32, device=dev)
            lf, pf = model._step_logits_paged(tok, pf, tf, t)
            lq, pq = model._step_logits_paged(tok, pq, tq, t)
            worst.append((lq - lf).abs().max().item() / spread)
            tok = lf.argmax(-1)
    finite = bool(torch.isfinite(lq).all())
    log(f"[serve:paged-int8] logit parity: max |int8 - float| / spread "
        f"per step {[round(w, 6) for w in worst]} (spread {spread:.4f}, "
        f"limit {INT8_KV_SPREAD})")
    if not finite or max(worst) >= INT8_KV_SPREAD:
        raise SystemExit("int8 KV logits leave the float logits' band")
    return max(worst)


def time_ms(torch, fn, flush, n=50):
    """Mean CUDA-event time of ``fn`` over ``n`` launches, the L2 flushed
    (a 256 MB write) before each one. A 100k-cycle device sleep after
    the flush keeps the card busy while the host runs the wrapper, so
    the host's time before the first launch stays out of the window."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(100_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / n


def bound(live_keys, dname, vec_bytes, extra_bytes):
    """Least time (ms) for the live keys: bytes (each live K and V vector
    of ``vec_bytes`` read once, plus q, o, cursors and table) over the
    HBM rate, and operations (4*D flops per live key per query head)
    over the peak."""
    nbytes = live_keys * HKV * 2 * vec_bytes + extra_bytes
    flops = live_keys * H * 4 * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def phase_timing(torch, K, err, launches):
    import torch.nn.functional as F

    x = kernel_inputs(torch, torch.float32, seed=1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    item = 4
    live_c = sum(min(t, CAP - 1) + 1 for t in T_CONTIG)
    live_p = sum(min(t, CAP - 1) + 1 for t in T_PAGED)
    qo = 2 * B * H * D * item + B * 4
    pages_live = sum(min(t, CAP - 1) // PS + 1 for t in T_PAGED)

    q4 = x["q"].transpose(1, 2)                        # (B, H, 1, D)
    cols = torch.arange(CAP, device="cuda")

    def sdpa(k, v, t):
        mask = (cols[None, :] <= t[:, None].long())[:, None, None, :]
        return F.scaled_dot_product_attention(
            q4, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)

    kg = K.gather_pages(x["kp"], x["table"]).contiguous()
    vg = K.gather_pages(x["vp"], x["table"]).contiguous()
    kgq = K.dequantize_pages(x["kq"], x["ks"], x["table"]).contiguous()
    vgq = K.dequantize_pages(x["vq"], x["vs"], x["table"]).contiguous()
    cases = {
        "decode_attention": (
            lambda: K.decode_attention(x["q"], x["k"], x["v"], x["t_c"]),
            lambda: K.decode_attention_plain(x["q"], x["k"], x["v"],
                                             x["t_c"]),
            lambda: sdpa(x["k"], x["v"], x["t_c"]),
            live_c, D * item, qo),
        "decode_attention_paged": (
            lambda: K.decode_attention_paged(x["q"], x["kp"], x["vp"],
                                             x["table"], x["t_p"]),
            lambda: K.decode_attention_paged_plain(
                x["q"], x["kp"], x["vp"], x["table"], x["t_p"]),
            # the pages gathered beforehand (gather not timed): no one
            # library call attends over a page table
            lambda: sdpa(kg, vg, x["t_p"]),
            live_p, D * item, qo + pages_live * 4),
        "decode_attention_paged_quant": (
            lambda: K.decode_attention_paged_quant(
                x["q"], *quant_planes(x), x["table"], x["t_p"]),
            lambda: K.decode_attention_paged_quant_plain(
                x["q"], *quant_planes(x), x["table"], x["t_p"]),
            # the pages gathered and dequantized beforehand (not timed)
            lambda: sdpa(kgq, vgq, x["t_p"]),
            live_p, D + 4, qo + pages_live * 4),
    }
    rows = []
    for name, (kern, plain, lib, live, vec, extra) in cases.items():
        ms = time_ms(torch, kern, flush)
        plain_ms = time_ms(torch, plain, flush)
        lib_ms = time_ms(torch, lib, flush)
        bound_ms, bound_by, nbytes = bound(live, "float32", vec, extra)
        log(f"[time] {name} float32: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; {nbytes} bytes, "
            f"bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / ms:.1f}% of the bound")
        rows.append(dict(name=name, route="cuda",
                         source="paddle_tpu_torch/csrc/decode_attention.cu",
                         replaces=KERNEL_ROWS[name]["replaces"],
                         launches=launches[name], max_abs_err=err[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms))
    f_ms, q_ms = rows[1]["ms"], rows[2]["ms"]
    log(f"[time] paged decode at the same cursors: int8 pools {q_ms:.4f} "
        f"ms, float32 pools {f_ms:.4f} ms (int8 / float {q_ms / f_ms:.3f})")
    return rows


def unfused_forward(torch, QM, model, x):
    """The swapped MnistMLP's forward through the public unfused entry
    points, layer by layer, as the JAX package's int8_linear composes
    them: absmax_encode at the layer's scale, quant_matmul on the int8
    weight, the bias, then the layer's ReLU."""
    from paddle_tpu_torch.quant.ops import _encode_at

    h = x
    for layer in (model.fc1, model.fc2, model.fc3):
        a_scale, w_scale, _ = layer._kernel_operands()
        h = QM.quant_matmul(_encode_at(h, a_scale), layer.weight_int8,
                            a_scale, w_scale) + layer.linear_bias
        if layer.act == "relu":
            h = torch.relu(h)
    return h


def phase_int8_mnist(torch, QM):
    """PTQ of MnistMLP(512, 256) on the card and one batch-8192 int8
    forward, fused, then through the unfused public entry points as a
    check. Returns each wrapper's launches in the fused forward, the
    main path (quant_matmul: 0)."""
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.models.mnist import MnistMLP
    from paddle_tpu_torch.quant import int8 as int8_mod

    def mlp():
        return MnistMLP(512, 256, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(9)).eval()

    fmodel, model = mlp(), quant.quantize_model(mlp())
    rng = torch.Generator().manual_seed(10)
    calib = [torch.randn(8, 784, generator=rng).to("cuda")
             for _ in range(4)]
    x = torch.randn(MNIST_BATCH, 784, generator=rng).to("cuda")
    quant.calibrate(model, calib)
    with torch.no_grad():
        ref = model(x)                       # fake-quant float, eval
        swapped = quant.int8_swap(model, quant.freeze(model))
        if swapped != 3:
            raise SystemExit(f"int8_swap swapped {swapped} layers, not 3")
        model(x)                             # packs the weights once
        torch.cuda.synchronize()
        # the main path: the swapped model's forward
        QM.quant_matmul.launches = QM.quant_linear.launches = 0
        out = model(x)
        torch.cuda.synchronize()
        launches = {"quant_linear": QM.quant_linear.launches,
                    "quant_matmul": QM.quant_matmul.launches}
        # a check run, not a path: the public unfused entry points
        QM.quant_matmul.launches = QM.quant_linear.launches = 0
        unfused = unfused_forward(torch, QM, model, x)
        torch.cuda.synchronize()
        check_qmm = QM.quant_matmul.launches
        check_qlin = QM.quant_linear.launches
        int8_mod.quant_linear = QM.quant_linear_plain
        try:
            plain = model(x)
        finally:
            int8_mod.quant_linear = QM.quant_linear
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        exact = torch.equal(out, plain)
        same = torch.equal(out, unfused)
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                            device="cuda")
        int8_ms = time_ms(torch, lambda: model(x), flush, n=20)
        float_ms = time_ms(torch, lambda: fmodel(x), flush, n=20)
    log(f"[int8:mnist] MnistMLP(512, 256) PTQ: {swapped} layers swapped; "
        f"batch {MNIST_BATCH} forward launched quant_linear "
        f"{launches['quant_linear']} times and quant_matmul "
        f"{launches['quant_matmul']}; equals the plain-version path: "
        f"{exact}; check run through the unfused public entry points "
        f"(quant_matmul launched {check_qmm} times, quant_linear "
        f"{check_qlin}) gives the same logits: {same}; "
        f"max |int8 - fake-quant| / max |fake-quant| {rel:.3e} (limit "
        f"{INT8_MLP_REL}); forward {int8_ms:.4f} ms int8, {float_ms:.4f} ms "
        f"float32 (CUDA events, L2 flushed, mean of 20)")
    if not (launches == {"quant_linear": 3, "quant_matmul": 0}
            and check_qmm == 3 and check_qlin == 0 and exact and same and rel < INT8_MLP_REL
            and bool(torch.isfinite(out).all())
            and out.shape == (MNIST_BATCH, 10)):
        raise SystemExit("the int8 MnistMLP forward failed its checks")
    return launches


def gemm_bound(m, k, n, a_bytes, extra):
    """Least time (ms) of an int8 GEMM: bytes (A at a_bytes a value, B,
    the (N,) scale, ``extra`` more, the float32 output) over the HBM
    rate, and 2MNK operations over the int8 peak."""
    nbytes = a_bytes * m * k + k * n + 4 * n + extra + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / INT8_PEAK_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def phase_qmm_timing(torch, QM, errs, launches):
    """quant_matmul and quant_linear at MNIST's three layer shapes
    (per-channel scales, float32 out): kernel, plain version and the
    yardsticks torch._int_mm plus the same scaling (the fused form's:
    the encode before it, bias and ReLU after it). Returns the two
    kernels' rows, at layer 1."""
    from paddle_tpu_torch.quant.ops import _encode_at

    gen = torch.Generator(device="cuda").manual_seed(11)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = {}
    for m, k, n in MNIST_SHAPES:
        a, b, sa = qmm_operands(torch, m, k, n, gen)
        sa = sa.reshape(1)
        sb = torch.rand((n,), generator=gen, device="cuda") * 0.01
        x = torch.randn(m, k, generator=gen, device="cuda") * 2
        bias = torch.randn(n, generator=gen, device="cuda")
        w_packed = QM.pack_weight(b)
        # _int_mm takes N % 8 == 0: layer 3's B padded to 16 columns
        n8 = -(-n // 8) * 8
        b8 = torch.zeros((k, n8), dtype=torch.int8, device="cuda")
        b8[:, :n] = b
        pad = "" if n8 == n else f" (B padded to {n8} columns)"

        def library():
            return torch._int_mm(a, b8)[:, :n].float() * (sa * sb)[None, :]

        def library_linear():
            acc = torch._int_mm(_encode_at(x, sa), b8)[:, :n]
            return torch.relu(acc.float() * (sa * sb)[None, :] + bias)

        cases = {
            "quant_matmul": (
                lambda: QM.quant_matmul(a, b, sa, sb),
                lambda: QM.quant_matmul_plain(a, b, sa, sb), library, 1, 4,
                QMM_REPLACES),
            "quant_linear": (
                lambda: QM.quant_linear(x, w_packed, sa, sb, bias, True),
                lambda: QM.quant_linear_plain(x, w_packed, sa, sb, bias,
                                              True),
                library_linear, 4, 8, QLIN_REPLACES),
        }
        for name, (kern, plain, lib, a_bytes, extra, replaces) in \
                cases.items():
            if not torch.equal(lib(), kern()):
                raise SystemExit(f"the {name} yardstick computes another "
                                 "function")
            ms = time_ms(torch, kern, flush)
            plain_ms = time_ms(torch, plain, flush)
            lib_ms = time_ms(torch, lib, flush)
            bound_ms, bound_by, nbytes = gemm_bound(m, k, n, a_bytes, extra)
            log(f"[time] {name} {m}x{k}x{n} per-channel, float32 out: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, yardstick "
                f"{lib_ms:.4f} ms{pad}; {2 * m * n * k} int8 ops, {nbytes} "
                f"bytes, bound {bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / ms:.1f}% of the bound")
            if name not in rows:        # the row is layer 1's
                rows[name] = dict(
                    name=name, route="cuda",
                    source="paddle_tpu_torch/csrc/quant_matmul.cu",
                    replaces=replaces, launches=launches[name],
                    max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
    return [rows["quant_matmul"], rows["quant_linear"]]


def flash_inputs(torch, case, dtype, gen):
    """q, k, v, do and kv_mask for one flash case, on the card."""
    b, tq, tk, h, hkv, d, _, _, mask = case

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rand(b, tq, h, d), rand(b, tk, hkv, d), rand(b, tk, hkv, d)
    do = rand(b, tq, h, d)
    km = None
    if mask:
        km = torch.ones((b, tk), dtype=torch.bool, device="cuda")
        km[0, tk - 100:] = False        # a padded tail
        km[1, :] = False                # a row with no live key
    return q, k, v, do, km


def flash_kw(case, km):
    return dict(causal=case[6], scale=case[5] ** -0.5, window=case[7],
                kv_mask=km)


def phase_flash_kernels(torch, FK):
    """Each flash kernel against its plain version; returns the max abs
    error per dtype and kernel over every case."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    err = {dname: {name: 0.0 for name in FLASH_ROWS}
           for dname in FLASH_DTYPES}
    for case in FLASH_CASES:
        for dname in FLASH_DTYPES:
            q, k, v, do, km = flash_inputs(torch, case, getattr(torch, dname),
                                           gen)
            kw = flash_kw(case, km)
            o, lse = FK.flash_attention_fwd(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
            delta = delta.contiguous()
            dq = FK.flash_attention_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = FK.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
            o_p, lse_p = FK.flash_attention_fwd_plain(q, k, v, **kw)
            dq_p = FK.flash_attention_dq_plain(q, k, v, do, lse, delta, **kw)
            dk_p, dv_p = FK.flash_attention_dkv_plain(q, k, v, do, lse,
                                                      delta, **kw)
            torch.cuda.synchronize()
            e = {n: (a.float() - b.float()).abs().max().item()
                 for n, a, b in (("o", o, o_p), ("lse", lse, lse_p),
                                 ("dq", dq, dq_p), ("dk", dk, dk_p),
                                 ("dv", dv, dv_p))}
            finite = all(bool(torch.isfinite(x).all())
                         for x in (o, dq, dk, dv))
            ok = finite and max(e.values()) <= FLASH_TOL[dname]
            log(f"[flash] {case} {dname}: max abs err "
                + ", ".join(f"{n} {x:.3e}" for n, x in e.items())
                + f" (atol {FLASH_TOL[dname]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"a flash kernel disagrees with its plain "
                                 f"version at {case} {dname}")
            for name, x in (("flash_attention_fwd", max(e["o"], e["lse"])),
                            ("flash_attention_dq", e["dq"]),
                            ("flash_attention_dkv", max(e["dk"], e["dv"]))):
                err[dname][name] = max(err[dname][name], x)
    for case in FLASH_OPTION_CASES:
        for dname in FLASH_DTYPES:
            e = option_errors(torch, FK, case, getattr(torch, dname), gen)
            ok = max(e.values()) <= FLASH_TOL[dname]
            log(f"[flash] options {case} {dname}: max abs err "
                + ", ".join(f"{n} {x:.3e}" for n, x in e.items())
                + f" (atol {FLASH_TOL[dname]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"a flash kernel disagrees with its plain "
                                 f"version at {case} {dname}")
            for name, x in (("flash_attention_fwd", max(e["o"], e["lse"])),
                            ("flash_attention_dq", e["dq"]),
                            ("flash_attention_dkv", max(e["dk"], e["dv"]))):
                err[dname][name + OPT] = max(
                    err[dname].get(name + OPT, 0.0), x)
    # Tq != Tk with dropout and a key mask: the dropout hash's row offset
    for case in FLASH_CROSS_CASES:
        for dname in FLASH_DTYPES:
            e = option_errors(torch, FK, case, getattr(torch, dname), gen,
                              inputs=cross_option_inputs)
            ok = max(e.values()) <= FLASH_TOL[dname]
            log(f"[flash] Tq != Tk {case} {dname}: max abs err "
                + ", ".join(f"{n} {x:.3e}" for n, x in e.items())
                + f" (atol {FLASH_TOL[dname]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"a flash kernel disagrees with its plain "
                                 f"version at {case} {dname}")
            for name, x in (("flash_attention_fwd", max(e["o"], e["lse"])),
                            ("flash_attention_dq", e["dq"]),
                            ("flash_attention_dkv", max(e["dk"], e["dv"]))):
                err[dname][name] = max(err[dname][name], x)
    return err


def packed_segments(torch, b, t, gen):
    """(b, t) int32 segment ids of rows packed with documents of 16-t
    tokens, the last 5 positions a padding tail (segment 0)."""
    lens = torch.randint(16, t + 1, (b, t), generator=gen, device="cuda")
    ends = torch.cumsum(lens, 1)
    pos = torch.arange(t, device="cuda")
    seg = (pos[None, :, None] >= ends[:, None, :]).sum(-1) + 1
    seg[:, t - 5:] = 0
    return seg.to(torch.int32)


def flash_option_inputs(torch, case, dtype, gen, seg=None):
    """q, k, v, do and the keyword arguments of one option case, on the
    card (``seg``: these segment ids instead of fresh ones)."""
    b, t, h, hkv, d, causal, segs, p, mask = case

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (rand(b, t, h, d), rand(b, t, hkv, d), rand(b, t, hkv, d),
                   rand(b, t, h, d))
    km = seeds = None
    if segs and seg is None:
        seg = packed_segments(torch, b, t, gen)
    if mask:
        km = torch.ones((b, t), dtype=torch.bool, device="cuda")
        km[0, t - 50:] = False
    if p:
        seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, h), generator=gen,
                              device="cuda", dtype=torch.int32)
    return q, k, v, do, dict(causal=causal, scale=d ** -0.5, kv_mask=km,
                             segment_ids=seg if segs else None, seeds=seeds,
                             dropout_p=p)


def cross_option_inputs(torch, case, dtype, gen):
    """q, k, v, do and the keyword arguments of one FLASH_CROSS_CASES
    case (Tq != Tk), on the card: the kv_mask pads row 0's last 50 keys
    and all of row 1's."""
    b, tq, tk, h, hkv, d, causal, p, mask = case

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (rand(b, tq, h, d), rand(b, tk, hkv, d),
                   rand(b, tk, hkv, d), rand(b, tq, h, d))
    km = seeds = None
    if mask:
        km = torch.ones((b, tk), dtype=torch.bool, device="cuda")
        km[0, tk - 50:] = False
        km[1, :] = False
    if p:
        seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, h), generator=gen,
                              device="cuda", dtype=torch.int32)
    return q, k, v, do, dict(causal=causal, scale=d ** -0.5, kv_mask=km,
                             segment_ids=None, seeds=seeds, dropout_p=p)


def option_errors(torch, FK, case, dtype, gen, inputs=flash_option_inputs):
    """Max abs difference, in float32, of o, lse, dq, dk, dv between each
    kernel and its plain version on the same inputs and seeds."""
    q, k, v, do, kw = inputs(torch, case, dtype, gen)
    o, lse = FK.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = FK.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FK.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    o_p, lse_p = FK.flash_attention_fwd_plain(q, k, v, **kw)
    dq_p = FK.flash_attention_dq_plain(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = FK.flash_attention_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for x in (o, dq, dk, dv):
        if not bool(torch.isfinite(x).all()):
            raise SystemExit(f"non-finite flash output at {case}")
    return {n: (a.float() - b.float()).abs().max().item()
            for n, a, b in (("o", o, o_p), ("lse", lse, lse_p),
                            ("dq", dq, dq_p), ("dk", dk, dk_p),
                            ("dv", dv, dv_p))}


def flash_counts(FK, dtype=None):
    """Launches per flash wrapper: all of them, or those of the ``dtype``
    instance."""
    return {name: (getattr(FK, name).launches if dtype is None else
                   getattr(FK, name).dtype_launches.get(dtype, 0))
            for name in FLASH_ROWS}


def reset_flash_counts(FK):
    for name in FLASH_ROWS:
        getattr(FK, name).launches = 0
        getattr(FK, name).dtype_launches.clear()


def phase_training(torch, FK, policy="float32", f32_losses=None):
    """bench_gpt's step at full width under the mixed-precision
    ``policy``: the kernel path against plain attention on the same
    weights (both under the policy, backward() after the scope has
    closed), exact launch counts of the policy's flash instances in one
    step, then 5 Adam steps through Trainer(amp=policy) (mixed_fp16:
    amp.decorate(Adam), scaled). Returns the launches of the 6 steps by
    dtype, those of the counted step, and the 5 losses."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.core import policy_scope, set_policy
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import attention as TA
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train]" if policy == "float32" else f"[train:{policy}]"
    flash_dtype = (torch.bfloat16 if policy == "bfloat16"
                   else torch.float32)
    loss_atol, grad_rtol = TRAIN_TOL[policy]
    cfg = gpt.GPTConfig.small()
    cfg.max_position, cfg.remat = TT, True
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    model = gpt.GPTForCausalLM(cfg, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (TB, TT),
                        generator=torch.Generator().manual_seed(6))
    ids = ids.to("cuda")
    params = dict(model.named_parameters())
    torch.cuda.reset_peak_memory_stats()
    log(f"{tag} GPTConfig.small() remat, max_position {TT}, policy "
        f"{policy} (flash operands {flash_dtype}), "
        f"{sum(p.numel() for p in params.values())} float32 parameters; "
        f"batch ({TB}, {TT})")

    # 1. the kernel path against plain attention on the same weights. The
    # plain attention computes in float32 on the operands the policy
    # gives it and returns their dtype, as the kernels do: under
    # "bfloat16" the port's plain path (the JAX package's xla_attention)
    # rounds its scores, softmax and their grads to bfloat16 and sits
    # further from that than the kernels; its distance is reported
    model.train()
    xla = TA.xla_attention

    def plain_f32(q, k, v, **kw):
        return xla(q.float(), k.float(), v.float(), **kw).to(q.dtype)

    # float16 grads underflow without the loss scale (the Linears' output
    # grads are ~1e-6 here, below float16's normal range), so the
    # mixed_fp16 check scales as its trainer does; the ratios below do
    # not depend on the scale
    scale = 2.0 ** 15 if policy == "mixed_fp16" else 1.0  # decorate's
    passes = [("kernels", True, xla), ("plain", False, plain_f32)]
    if policy == "bfloat16":
        passes.append(("plain bfloat16", False, xla))
    grads, losses = {}, {}
    try:
        for name, use_flash, attention in passes:
            TA.xla_attention = attention
            for blk in model.blocks:
                blk.self_attn.use_flash = use_flash
            n0 = flash_counts(FK)
            with policy_scope(policy):
                loss = model.forward_loss(ids)
            (loss * scale).backward()
            launched = {k: v - n0[k] for k, v in flash_counts(FK).items()}
            if (min(launched.values()) == 0 if use_flash
                    else max(launched.values()) > 0):
                raise SystemExit(f"{tag} check step {name}: flash "
                                 f"launches {launched}")
            losses[name] = loss.item()
            grads[name] = {n: p.grad for n, p in params.items()}
            for p in params.values():
                p.grad = None
    finally:
        TA.xla_attention = xla
    for blk in model.blocks:
        blk.self_attn.use_flash = True

    def distance(a, b):
        """|loss a - loss b|, and the worst over parameters of max |grad
        a - grad b| / max |grad b|, with that parameter's name."""
        worst = max(((grads[a][n] - grads[b][n]).abs().max().item()
                     / max(grads[b][n].abs().max().item(), 1e-30), n)
                    for n in params)
        return abs(losses[a] - losses[b]), worst[0], worst[1]

    dloss, worst, where = distance("kernels", "plain")
    log(f"{tag} check step: loss kernels {losses['kernels']:.6f}, plain "
        f"{losses['plain']:.6f} (|diff| {dloss:.3e}, atol {loss_atol}); "
        f"worst grad diff / the parameter's max plain grad {worst:.3e} "
        f"({where}; limit {grad_rtol})")
    if "plain bfloat16" in grads:
        log(f"{tag} reported, not gated: the bfloat16 plain path against "
            f"the kernels (loss, worst grad) "
            f"{'%.3e, %.3e (%s)' % distance('kernels', 'plain bfloat16')}; "
            f"against the float32 plain path "
            f"{'%.3e, %.3e (%s)' % distance('plain bfloat16', 'plain')}")
    if not (dloss <= loss_atol and worst <= grad_rtol):
        raise SystemExit(f"{tag} the kernel path's loss or grads disagree "
                         "with plain attention")
    del grads

    # 2. launch counts of one step, 3. five more steps
    if policy == "mixed_fp16":
        opt = amp.decorate(optimizer.Adam(1e-3))     # sets the policy too
    else:
        opt = optimizer.Adam(1e-3)
    trainer = Trainer(model, opt,
                      lambda m, batch, g: (m.forward_loss(batch), {}),
                      amp=None if policy == "float32" else policy)
    torch.cuda.synchronize()
    reset_flash_counts(FK)
    trainer.train_step(ids)
    torch.cuda.synchronize()
    per_step = flash_counts(FK)
    of_dtype = flash_counts(FK, flash_dtype)
    want = {"flash_attention_fwd": 2 * cfg.num_layers,
            "flash_attention_dq": cfg.num_layers,
            "flash_attention_dkv": cfg.num_layers}
    log(f"{tag} launches in one step: {per_step}, of them "
        f"{str(flash_dtype)[6:]} {of_dtype} (want {want}, all "
        f"{str(flash_dtype)[6:]})")
    if per_step != want or of_dtype != want:
        raise SystemExit(f"{tag} a training step launched the flash "
                         f"kernels another number of times or in another "
                         f"dtype")
    losses, secs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(ids)
        losses.append(loss.item())             # synchronises
        secs.append(time.perf_counter() - t0)
    set_policy("float32")                      # amp.decorate's global set
    launches = {d: flash_counts(FK, getattr(torch, d))
                for d in FLASH_DTYPES}
    ms = 1e3 * sum(secs) / len(secs)
    log(f"{tag} 5 Adam steps: losses {[round(x, 6) for x in losses]}; "
        f"ms per step {[round(1e3 * x, 3) for x in secs]}, mean "
        f"{ms:.3f} ms, {TB * TT / (ms / 1e3):.1f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"over the 6 steps {launches}")
    if f32_losses is not None:
        log(f"{tag} distance from the float32 run's 5 losses (reported, "
            f"not gated): max "
            f"{max(abs(a - b) for a, b in zip(losses, f32_losses)):.3e}, "
            f"last {losses[-1] - f32_losses[-1]:+.3e}")
    if policy == "mixed_fp16":
        skipped = 6 - trainer.opt_state["inner"]["step"]
        log(f"{tag} final loss scale "
            f"{opt.current_scale(trainer.opt_state).item()}, skipped "
            f"steps {skipped} of 6")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise SystemExit(f"{tag} training losses not finite and falling: "
                         f"{losses}")
    return launches, per_step, losses


def bert_batch(torch, cfg, packed):
    """bench.py's batches, from numpy seed 0: bert_base (:380-387) ids
    over every position, MLM labels = the ids, NSP labels; bert_packed
    (:582-593) rows that pack_sequences fills with documents of 16-128
    tokens, the tokens their own MLM labels. Returns (the loss builder's
    batch tuple, the segment ids or None, the real tokens)."""
    import numpy as np

    from paddle_tpu_torch.data import pack_sequences

    rng = np.random.default_rng(0)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.long,
                               device="cuda")

    if not packed:
        ids = dev(rng.integers(0, cfg.vocab_size, (BB, BT)))
        nsp = dev(rng.integers(0, 2, (BB,)))
        return (ids, ids, nsp), None, BB * BT

    def docs():
        while True:
            n = int(rng.integers(16, BT + 1))
            yield rng.integers(3, cfg.vocab_size, n)

    b = next(iter(pack_sequences(docs, capacity=BT, batch_size=BB)()))
    tokens = dev(b["tokens"])
    seg = torch.as_tensor(b["segment_ids"], device="cuda")
    return ((tokens, dev(b["positions"]), seg, tokens), seg,
            int((seg > 0).sum()))


def bert_loss(model, batch, packed):
    return (model.forward_packed_loss(*batch) if packed
            else model.forward_fused_loss(*batch))


# a key projection's bias (self- or cross-attention) has a gradient of 0
# in exact arithmetic (a bias added to every key shifts a softmax row,
# which cancels): what a run computes there is rounding noise, reported
# and not gated
ZERO_GRAD = "k_proj.bias"


def grad_distance(grads, params, a, b):
    """The worst over parameters of max |grad a - grad b| / the
    parameter's largest grad in ``b``, with that parameter's name, for
    the gated parameters and for the ZERO_GRAD ones."""
    def worst(names):
        return max(((grads[a][n] - grads[b][n]).abs().max().item()
                    / max(grads[b][n].abs().max().item(), 1e-30), n)
                   for n in names) if names else (0.0, "none")

    return (worst([n for n in params if not n.endswith(ZERO_GRAD)]),
            worst([n for n in params if n.endswith(ZERO_GRAD)]))


def phase_bert(torch, FK, packed):
    """BERT-base pretraining at full width through Trainer: the kernel
    path against plain attention on the same weights and the same
    dropout masks (the generator re-seeded before each pass) under
    mixed_bf16 and float32, the exact launches of one step, then 5 Adam
    steps. Returns the launches of the counted step and the segment ids
    (packed) or None."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core import policy_scope, rng_scope
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention as TA
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train:bert_packed]" if packed else "[train:bert_base]"
    cfg = bert.BertConfig.base()
    model = bert.BertForPretraining(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(15))
    batch, seg, real = bert_batch(torch, cfg, packed)
    params = dict(model.named_parameters())
    mhas = [layer.self_attn for layer in model.bert.encoder.layers]
    torch.cuda.reset_peak_memory_stats()
    docs = ("" if seg is None else
            f", {int(seg.max(dim=1).values.sum())} documents, "
            f"{real} real tokens of {BB * BT}")
    log(f"{tag} BertConfig.base() ({cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads, vocab {cfg.vocab_size}, "
        f"dropout {cfg.dropout}), "
        f"{sum(p.numel() for p in params.values())} float32 parameters; "
        f"batch ({BB}, {BT}){docs}; policy {BERT_POLICY}")

    # 1. check steps: kernels against plain attention (xla_attention,
    # which hashes the same seeds), dropout on, the same masks. Under
    # mixed_bf16 a second plain pass computes attention in float64: two
    # correct computations whose attention differs only in float32
    # rounding, whose distance is the noise floor that the bf16 Linears
    # make of any such difference (on an H100 at 700 W it tops 2e-2 in
    # the q/k projections' grads at this configuration)
    model.train()
    xla = TA.xla_attention

    def plain64(q, k, v, **kw):
        return xla(q.double(), k.double(), v.double(), **kw).to(q.dtype)

    for policy in (BERT_POLICY, "float32"):
        loss_atol, grad_rtol = TRAIN_TOL[policy]
        passes = [("kernels", True, xla), ("plain", False, xla)]
        if policy != "float32":
            passes.append(("plain64", False, plain64))
        grads, losses = {}, {}
        for name, use_flash, attention in passes:
            TA.xla_attention = attention
            for mha in mhas:
                mha.use_flash = use_flash
            n0 = flash_counts(FK)
            gen = torch.Generator(device="cuda").manual_seed(16)
            try:
                with policy_scope(policy), rng_scope(gen):
                    loss = bert_loss(model, batch, packed)
            finally:
                TA.xla_attention = xla
            loss.backward()
            launched = {k: v - n0[k] for k, v in flash_counts(FK).items()}
            if (min(launched.values()) == 0 if use_flash
                    else max(launched.values()) > 0):
                raise SystemExit(f"{tag} check step {name}: flash launches "
                                 f"{launched}")
            losses[name] = loss.item()
            grads[name] = {n: (torch.zeros_like(p) if p.grad is None
                               else p.grad) for n, p in params.items()}
            for p in params.values():
                p.grad = None
        for mha in mhas:
            mha.use_flash = True
        (worst, where), (noise, nwhere) = grad_distance(
            grads, params, "kernels", "plain")
        dloss = abs(losses["kernels"] - losses["plain"])
        floor = ""
        if "plain64" in grads:
            # the limits: 2e-2, or twice the plain passes' own distance
            # where that is larger
            (f_worst, f_where), _ = grad_distance(grads, params, "plain64",
                                                  "plain")
            f_loss = abs(losses["plain64"] - losses["plain"])
            loss_atol = max(loss_atol, 2 * f_loss)
            grad_rtol = max(grad_rtol, 2 * f_worst)
            floor = (f"; the noise floor, plain float64 attention against "
                     f"plain: loss {f_loss:.3e}, worst grad {f_worst:.3e} "
                     f"({f_where}); limits max(2e-2, twice the floor)")
        log(f"{tag} check step {policy}: loss kernels "
            f"{losses['kernels']:.6f}, plain {losses['plain']:.6f} (|diff| "
            f"{dloss:.3e}, atol {loss_atol:.3e}); worst grad diff / the "
            f"parameter's max plain grad {worst:.3e} ({where}; limit "
            f"{grad_rtol:.3e}){floor}; the key biases, whose gradient is 0 "
            f"in exact arithmetic (reported, not gated): {noise:.3e} "
            f"({nwhere})")
        if not (dloss <= loss_atol and worst <= grad_rtol
                and math.isfinite(losses["kernels"])):
            raise SystemExit(f"{tag} the kernel path's loss or grads "
                             f"disagree with plain attention ({policy})")
        del grads

    # 2. launches of one step, 3. five more steps
    trainer = Trainer(model, optimizer.Adam(1e-3),
                      lambda m, b, g: (bert_loss(m, b, packed), {}),
                      amp=BERT_POLICY)
    torch.cuda.synchronize()
    reset_flash_counts(FK)
    trainer.train_step(batch)
    torch.cuda.synchronize()
    per_step = flash_counts(FK)
    f32 = flash_counts(FK, torch.float32)
    want = {name: cfg.num_layers for name in FLASH_ROWS}
    log(f"{tag} launches in one step: {per_step}, of them float32 {f32} "
        f"(want {want}, all float32)")
    if per_step != want or f32 != want:
        raise SystemExit(f"{tag} a training step launched the flash kernels "
                         f"another number of times or in another dtype")
    losses, secs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch)
        losses.append(loss.item())             # synchronises
        secs.append(time.perf_counter() - t0)
    ms = 1e3 * sum(secs) / len(secs)
    real_rate = ("" if seg is None else
                 f", {real / (ms / 1e3):.1f} real tokens/s")
    log(f"{tag} 5 Adam steps: losses {[round(x, 6) for x in losses]}; ms "
        f"per step {[round(1e3 * x, 3) for x in secs]}, mean {ms:.3f} ms, "
        f"{BB / (ms / 1e3):.1f} samples/s, {BB * BT / (ms / 1e3):.1f} "
        f"tokens/s{real_rate}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise SystemExit(f"{tag} training losses not finite and falling: "
                         f"{losses}")
    del trainer, model
    torch.cuda.empty_cache()
    return per_step, seg


def flash_timed(torch, FK, case, seed, mask_of, seg=None):
    """The three flash kernels on the inputs of one option case (float32,
    as under mixed_bf16): each kernel held against its plain version at
    FLASH_TOL, then kernel, plain and SDPA ms. SDPA, a yardstick never
    called by the port, gets the boolean mask ``mask_of(kw)`` and its own
    dropout (its masks differ; the work is the same); its backward rows
    time SDPA's whole backward. Returns {name: (ms, plain_ms, lib_ms,
    max abs err)}."""
    import torch.nn.functional as F

    p = case[7]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do, kw = flash_option_inputs(torch, case, torch.float32, gen,
                                          seg=seg)
    o, lse = FK.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    mask = mask_of(kw)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         dropout_p=p)
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                       dropout_p=p)

    def sdpa_bwd():
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    cases = {
        "flash_attention_fwd": (
            lambda: FK.flash_attention_fwd(q, k, v, **kw),
            lambda: FK.flash_attention_fwd_plain(q, k, v, **kw), sdpa_fwd),
        "flash_attention_dq": (
            lambda: FK.flash_attention_dq(q, k, v, do, lse, delta, **kw),
            lambda: FK.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                **kw), sdpa_bwd),
        "flash_attention_dkv": (
            lambda: FK.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
            lambda: FK.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                 **kw), sdpa_bwd),
    }
    res = {}
    for name, (kern, plain, lib) in cases.items():
        got, want = kern(), plain()
        got, want = ((x if isinstance(x, tuple) else (x,))
                     for x in (got, want))
        torch.cuda.synchronize()
        e = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want))
        if not (e <= FLASH_TOL["float32"]
                and all(bool(torch.isfinite(a).all()) for a in got)):
            raise SystemExit(f"{name} disagrees with its plain version at "
                             f"{case}: max abs err {e:.3e} (atol "
                             f"{FLASH_TOL['float32']})")
        res[name] = (time_ms(torch, kern, flush, n=20),
                     time_ms(torch, plain, flush, n=5),
                     time_ms(torch, lib, flush, n=20), e)
    return res


def phase_flash_option_timing(torch, FK, err, launches, seg):
    """The three flash kernels at BERT's shape with the packed batch's
    segment ids and dropout 0.1 (float32, as under mixed_bf16): kernel,
    plain and SDPA ms (SDPA with the block-diagonal mask), and the bound
    from the live (same-segment) scores."""
    case = (BB, BT, 12, 12, 64, False, True, 0.1, False)
    b, t, h, _, d = case[:5]
    same = (seg[:, None, :, None] == seg[:, None, None, :])
    timed = flash_timed(torch, FK, case, 17, lambda kw: same, seg=seg)
    # live scores: same-segment pairs of this batch, every head
    live = int(same.sum().item()) * h
    opnd = b * t * h * d * 4                 # one (B, T, H, D) float32
    row = b * h * t * 4
    extra = b * t * 4 + b * h * 4            # segment ids, seeds
    work = {"flash_attention_fwd": (4 * d, 4 * opnd + row + extra),
            "flash_attention_dq": (6 * d, 5 * opnd + 2 * row + extra),
            "flash_attention_dkv": (8 * d, 6 * opnd + 2 * row + extra)}
    rows = []
    for name, (flops_per_score, nbytes) in work.items():
        ms, plain_ms, lib_ms, e = timed[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = TF32_PASSES * live * flops_per_score / TF32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[time] {name}{OPT} float32 (B={b}, T={t}, H={h}, D={d}, "
            f"non-causal, p=0.1, packed segments: {live} live scores of "
            f"{b * h * t * t}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA with the block-diagonal mask and dropout 0.1 (a "
            f"yardstick: its own masks) {lib_ms:.4f} ms; "
            f"{live * flops_per_score} flops, {nbytes} bytes, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of "
            f"the bound; kernel against plain here {e:.3e}; "
            f"{launches[name]} launches per training step")
        rows.append(dict(name=name + OPT, route="cuda",
                         source="paddle_tpu_torch/csrc/flash_attention.cu",
                         replaces=FLASH_ROWS[name]["replaces"]
                         + " with has_segs and dropout_p > 0",
                         launches=launches[name], max_abs_err=err[name + OPT],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms))
    return rows


def phase_flash_timing(torch, FK, err, launches, per_step, dname):
    """The three flash kernels at the training shape in ``dname``
    (float32 or bfloat16): kernel, plain and SDPA ms, and the bound."""
    import torch.nn.functional as F

    case = FLASH_CASES[0]
    b, t, _, h, hkv, d = case[:6]
    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    q, k, v, do, _ = flash_inputs(torch, case, dtype, gen)
    kw = flash_kw(case, None)
    o, lse = FK.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    # the yardstick, never called by the port: one SDPA call, and its
    # backward alone on a kept graph
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)

    def sdpa_bwd():
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    live = b * h * t * (t + 1) // 2          # causal, Tq == Tk
    item = q.element_size()
    qo = b * t * h * d * item                # one (B, T, H, D) operand
    kv = b * t * hkv * d * item
    row = b * h * t * 4                      # lse or delta, float32
    # float32: three TF32 passes at the TF32 rate; bfloat16: one pass at
    # the dense bf16 tensor-core rate
    passes, rate = ((TF32_PASSES, TF32_FLOPS) if dname == "float32"
                    else (1, PEAK_FLOPS["bfloat16"]))
    suffix = "" if dname == "float32" else f"[{dname}]"
    cases = {
        "flash_attention_fwd": (
            lambda: FK.flash_attention_fwd(q, k, v, **kw),
            lambda: FK.flash_attention_fwd_plain(q, k, v, **kw), sdpa_fwd,
            4 * d, qo + 2 * kv + qo + row),
        "flash_attention_dq": (
            lambda: FK.flash_attention_dq(q, k, v, do, lse, delta, **kw),
            lambda: FK.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                **kw), sdpa_bwd,
            6 * d, 2 * qo + 2 * kv + 2 * row + qo),
        "flash_attention_dkv": (
            lambda: FK.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
            lambda: FK.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                 **kw), sdpa_bwd,
            8 * d, 2 * qo + 2 * kv + 2 * row + 2 * kv),
    }
    rows = []
    for name, (kern, plain, lib, flops_per_score, nbytes) in cases.items():
        ms = time_ms(torch, kern, flush, n=20)
        plain_ms = time_ms(torch, plain, flush, n=5)
        lib_ms = time_ms(torch, lib, flush, n=20)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = passes * live * flops_per_score / rate * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[time] {name} {dname} {case[:6]} causal: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; "
            f"{live * flops_per_score} flops, {nbytes} bytes, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of "
            f"the bound; {per_step[name]} launches per training step")
        rows.append(dict(name=name + suffix, route="cuda",
                         source="paddle_tpu_torch/csrc/flash_attention.cu",
                         replaces=FLASH_ROWS[name]["replaces"],
                         launches=launches[name], max_abs_err=err[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms))

    def whole_bwd():
        dl = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        FK.flash_attention_dq(q, k, v, do, lse, dl, **kw)
        FK.flash_attention_dkv(q, k, v, do, lse, dl, **kw)

    bwd_ms = time_ms(torch, whole_bwd, flush, n=20)
    lib_ms = time_ms(torch, sdpa_bwd, flush, n=20)
    log(f"[time] whole backward (delta + dq + dk/dv) {dname} "
        f"{case[:6]} causal: {bwd_ms:.4f} ms; SDPA backward {lib_ms:.4f} "
        f"ms ({bwd_ms / lib_ms:.3f}x)")
    return rows


def state_on_host(torch, trainer):
    """{path: host copy} of a trainer's whole state (checkpoint paths)."""
    import numpy as np

    from paddle_tpu_torch.checkpoint import _flatten

    return {path: (x.detach().to("cpu", copy=True) if torch.is_tensor(x)
                   else np.array(x))
            for path, x in _flatten(trainer.state())}


def states_equal(torch, a, b):
    """Paths whose values differ, bit for bit, between two host states."""
    import numpy as np

    if a.keys() != b.keys():
        return sorted(set(a) ^ set(b))
    return [p for p in a if not (
        torch.equal(a[p], b[p]) if torch.is_tensor(a[p])
        else np.array_equal(a[p], b[p]))]


def dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def step_determinism(torch, make, batches, tag):
    """Two trainers from the same seed take the same two steps: whether a
    step is bit-deterministic on the card (the losses and every state
    leaf equal), and otherwise the largest loss distance, whose double is
    the resume gates' limit."""
    runs, states = [], []
    for _ in range(2):
        trainer = make(None)
        runs.append([trainer.train_step(b)[0].item() for b in batches[:2]])
        states.append(state_on_host(torch, trainer))
        del trainer
        torch.cuda.empty_cache()
    diff = states_equal(torch, *states)
    dist = max(abs(a - b) for a, b in zip(*runs))
    exact = not diff and dist == 0.0
    log(f"{tag} determinism: two runs of 2 steps from one state: losses "
        f"{runs[0]} and {runs[1]}; state leaves that differ {len(diff)}"
        f"{' (' + ', '.join(diff[:3]) + ', ...)' if diff else ''}; "
        f"{'bit-deterministic: the resume gates are equality' if exact else 'not bit-deterministic: the resume gates are twice %.3e' % dist}")
    return 0.0 if exact else 2 * dist


def loop_counter(torch, FK, want, tag):
    """An on_step callback that records each step's loss, host ms (since
    the previous step's callback) and flash launches, all float32."""
    rec = {"losses": [], "ms": [], "bad": []}
    prev = {"t": time.perf_counter(), "n": flash_counts(FK),
            "f": flash_counts(FK, torch.float32)}

    def on_step(step, loss, metrics):
        now = time.perf_counter()
        n, f = flash_counts(FK), flash_counts(FK, torch.float32)
        per = {k: n[k] - prev["n"][k] for k in n}
        per32 = {k: f[k] - prev["f"][k] for k in f}
        if per != want or per32 != want:
            rec["bad"].append((step, per, per32))
        rec["losses"].append(loss.item())
        rec["ms"].append(1e3 * (now - prev["t"]))
        prev.update(t=time.perf_counter(), n=n, f=f)

    return rec, on_step


def check_losses(tag, what, got, want, gate):
    far = max(abs(a - b) for a, b in zip(got, want))
    log(f"{tag} {what}: {got} against {want} (max distance {far:.3e}, "
        f"limit {gate:.3e})")
    if not far <= gate:
        raise SystemExit(f"{tag} {what} disagree")


def phase_train_loop(torch, FK):
    """bench_gpt's configuration at full width through TrainLoop with
    checkpoints: run A 6 steps, run B 4 steps then dropped, run C a fresh
    model of another seed resuming B's step 4 to 6; the resume gates, the
    retention, the launches per loop step; then the checkpoint's size
    and times, the loop's overhead and prefetch."""
    import shutil
    import tempfile

    import paddle_tpu_torch
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.checkpoint import save_state
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import Trainer
    from paddle_tpu_torch.train_loop import TrainLoop

    tag = "[train:loop]"
    cfg = gpt.GPTConfig.small()
    cfg.max_position, cfg.remat = TT, True
    host = [torch.randint(0, cfg.vocab_size, (TB, TT),
                          generator=torch.Generator().manual_seed(60 + i))
            for i in range(6)]
    data = [b.to("cuda") for b in host]

    def make(seed):
        # the stream seeded as the weights are: a trainer's start key is
        # the stream's next key, so two trainers of one seed start alike
        paddle_tpu_torch.seed(5 if seed is None else seed)
        model = gpt.GPTForCausalLM(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(5 if seed is None else seed))
        return Trainer(model, optimizer.Adam(1e-3),
                       lambda m, batch, g: (m.forward_loss(batch), {}),
                       amp=LOOP_POLICY)

    want = {"flash_attention_fwd": 2 * cfg.num_layers,
            "flash_attention_dq": cfg.num_layers,
            "flash_attention_dkv": cfg.num_layers}
    gate = step_determinism(torch, make, data, tag)
    root = tempfile.mkdtemp(prefix="pt_smoke_ckpt_")
    try:
        # run A: 6 steps uninterrupted, checkpoints every 2, keep 2
        trainer = make(None)
        n_params = sum(p.numel() for p in trainer.params.values())
        rec_a, on_step = loop_counter(torch, FK, want, tag)
        loop_a = TrainLoop(trainer, f"{root}/a", checkpoint_every=2,
                           max_to_keep=2)
        # the blocking part of each periodic save, as the loop calls it
        blocking, save = [], loop_a.manager.save

        def timed_save(step, tree, **kw):
            t0 = time.perf_counter()
            save(step, tree, **kw)
            blocking.append((step, round(1e3 * (time.perf_counter() - t0),
                                         3)))

        loop_a.manager.save = timed_save
        loop_a.run(iter(data), on_step=on_step)
        kept = loop_a.manager.committed_steps()
        ck_bytes = dir_bytes(f"{root}/a/step_6")
        with open(f"{root}/a/step_6/manifest.json") as f:
            algo = next(iter(json.load(f)["checksums"].values())).split(
                ":")[0]
        log(f"{tag} GPTConfig.small() remat, {n_params} float32 "
            f"parameters, policy {LOOP_POLICY}, batch ({TB}, {TT}), one "
            f"seeded batch a step; run A: losses {rec_a['losses']}; host "
            f"ms per loop step {[round(x, 3) for x in rec_a['ms']]} (a "
            f"save after steps 2, 4, 6; each save's blocking ms (step, "
            f"ms) {blocking}); committed steps on disk {kept} "
            f"(max_to_keep 2)")
        log(f"{tag} checkpoint bytes {ck_bytes} (parameters and Adam's two "
            f"moments: 3 x 4 x {n_params} = {12 * n_params}); checksums "
            f"{algo}")
        if rec_a["bad"] or kept != [4, 6]:
            raise SystemExit(f"{tag} run A: launches {rec_a['bad']} or "
                             f"committed steps {kept}")

        # the save's blocking part (the host snapshot) and the whole write
        snap, total = [], []
        for i in range(3):
            t0 = time.perf_counter()
            handle = save_state(f"{root}/timed_{i}", trainer.state(),
                                async_save=True)
            snap.append(1e3 * (time.perf_counter() - t0))
            handle.join()
            total.append(1e3 * (time.perf_counter() - t0))
            shutil.rmtree(f"{root}/timed_{i}")
        # host ms per bare step, then with an async save in flight
        bare, busy = [], []
        for runs, saving in ((bare, False), (busy, True)):
            handle = (save_state(f"{root}/inflight", trainer.state(),
                                 async_save=True) if saving else None)
            for b in data[:3]:
                t0 = time.perf_counter()
                trainer.train_step(b)[0].item()
                runs.append(1e3 * (time.perf_counter() - t0))
            if handle is not None:
                handle.join()
        log(f"{tag} save: blocking snapshot ms {[round(x, 3) for x in snap]}"
            f", whole write ms {[round(x, 3) for x in total]}; bare "
            f"train_step host ms {[round(x, 3) for x in bare]}, with an "
            f"async save in flight {[round(x, 3) for x in busy]}")
        del trainer, loop_a
        shutil.rmtree(f"{root}/a")
        shutil.rmtree(f"{root}/inflight")
        torch.cuda.empty_cache()

        # run B: 4 steps, then a host copy of its state, then dropped
        trainer = make(None)
        rec_b, on_step = loop_counter(torch, FK, want, tag)
        TrainLoop(trainer, f"{root}/b", checkpoint_every=2,
                  max_to_keep=2).run(iter(data[:4]), on_step=on_step)
        saved = state_on_host(torch, trainer)
        del trainer
        torch.cuda.empty_cache()
        check_losses(tag, "run B's losses at steps 1-4 against run A's",
                     rec_b["losses"], rec_a["losses"][:4], gate)

        # run C: a model of another seed resumes step 4 and runs to 6
        trainer = make(7)
        loop_c = TrainLoop(trainer, f"{root}/b", checkpoint_every=2,
                           max_to_keep=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = loop_c.maybe_resume()
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        diff = states_equal(torch, state_on_host(torch, trainer), saved)
        rec_c, on_step = loop_counter(torch, FK, want, tag)
        loop_c.run(iter(data[4:]), num_steps=6, resume=False,
                   on_step=on_step)
        kept = loop_c.manager.committed_steps()
        log(f"{tag} run C: resumed_from {resumed}, resume_restore_ms "
            f"{restore_ms:.3f}; state leaves differing from B's step-4 "
            f"state {len(diff)} of {len(saved)}; committed steps {kept}")
        if resumed != 4 or diff or rec_b["bad"] or rec_c["bad"] or \
                kept != [4, 6]:
            raise SystemExit(f"{tag} resume: resumed_from {resumed}, "
                             f"differing {diff[:5]}, launches "
                             f"{rec_b['bad'] + rec_c['bad']}, kept {kept}")
        check_losses(tag, "run C's losses at steps 5-6 against run A's",
                     rec_c["losses"], rec_a["losses"][4:], gate)
        del trainer, loop_c, saved
        shutil.rmtree(f"{root}/b")
        torch.cuda.empty_cache()

        # the loop with no periodic save against the bare steps, then
        # prefetch=2 from host batches: the same losses as run A
        for name, batches, kw in (("no save", data, {}),
                                  ("prefetch=2", host, {"prefetch": 2})):
            trainer = make(None)
            rec_d, on_step = loop_counter(torch, FK, want, tag)
            loop_d = TrainLoop(trainer, f"{root}/d", checkpoint_every=0)
            loop_d.run(iter(batches), on_step=on_step, **kw)
            pf = loop_d.prefetcher
            steady = rec_d["ms"][1:]
            log(f"{tag} TrainLoop, {name}: host ms per loop step "
                f"{[round(x, 3) for x in rec_d['ms']]}; steps 2-6 mean "
                f"{sum(steady) / len(steady):.3f} against the bare "
                f"train_step's {sum(bare) / len(bare):.3f}"
                + ("" if pf is None else
                   f"; host wait per step "
                   f"{1e3 * pf.host_wait_s / pf.batches_staged:.3f} ms "
                   f"over {pf.batches_staged} batches"))
            check_losses(tag, f"{name} losses against run A's",
                         rec_d["losses"], rec_a["losses"], gate)
            if rec_d["bad"]:
                raise SystemExit(f"{tag} {name} launches {rec_d['bad']}")
            del trainer, loop_d
            shutil.rmtree(f"{root}/d")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_bert_resume(torch, FK):
    """bert_base (dropout 0.1, mixed_bf16) through TrainLoop: 4 steps
    uninterrupted, and 2 steps, a checkpoint, a model of another seed
    resuming to 4: the losses at steps 3-4 meet the determinism gate (the
    key restores, and the in-kernel dropout seeds follow it)."""
    import shutil
    import tempfile

    import paddle_tpu_torch
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import Trainer
    from paddle_tpu_torch.train_loop import TrainLoop

    tag = "[train:bert_resume]"
    cfg = bert.BertConfig.base()
    batch, _, _ = bert_batch(torch, cfg, packed=False)
    data = [batch] * 4

    def make(seed):
        paddle_tpu_torch.seed(15 if seed is None else seed)
        model = bert.BertForPretraining(
            cfg, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(15 if seed is None else seed))
        return Trainer(model, optimizer.Adam(1e-3),
                       lambda m, b, g: (bert_loss(m, b, False), {}),
                       amp=BERT_POLICY)

    want = {name: cfg.num_layers for name in FLASH_ROWS}
    gate = step_determinism(torch, make, data, tag)
    root = tempfile.mkdtemp(prefix="pt_smoke_bert_")
    try:
        rec_x, on_step = loop_counter(torch, FK, want, tag)
        TrainLoop(make(None), f"{root}/x", checkpoint_every=0).run(
            iter(data), on_step=on_step)
        torch.cuda.empty_cache()
        rec_y, on_step = loop_counter(torch, FK, want, tag)
        TrainLoop(make(None), f"{root}/y", checkpoint_every=2).run(
            iter(data[:2]), on_step=on_step)
        torch.cuda.empty_cache()
        rec_z, on_step = loop_counter(torch, FK, want, tag)
        loop_z = TrainLoop(make(16), f"{root}/y", checkpoint_every=2)
        loop_z.run(iter(data[2:]), num_steps=4, on_step=on_step)
        log(f"{tag} BertConfig.base(), batch ({BB}, {BT}), dropout "
            f"{cfg.dropout}, {BERT_POLICY}: uninterrupted losses "
            f"{rec_x['losses']}; resumed_from "
            f"{loop_z.history['resumed_from']}; host ms per loop step "
            f"{[round(x, 3) for x in rec_x['ms']]}")
        bad = rec_x["bad"] + rec_y["bad"] + rec_z["bad"]
        if loop_z.history["resumed_from"] != 2 or bad:
            raise SystemExit(f"{tag} resumed_from "
                             f"{loop_z.history['resumed_from']}, launches "
                             f"{bad}")
        check_losses(tag, "resumed losses at steps 3-4 against the "
                     "uninterrupted run's", rec_z["losses"],
                     rec_x["losses"][2:], gate)
        del loop_z
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_int8_resnet50(torch, QM, K, FK):
    """PTQ of resnet50(1000), NHWC, on the card: quantize_model, calibrate
    on 4 seeded (8, 3, 224, 224) batches, freeze, int8_swap (53 Conv2D
    and the head); with every counter at 0, one batch-32 forward must
    launch quant_matmul 53 times, quant_linear once and nothing else, and
    equal the same forward on the plain versions exactly. Returns the
    wrapper's launches and the launches at each shape of CONV_SHAPES."""
    import collections

    from paddle_tpu_torch import quant
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.quant import int8 as int8_mod

    def net():
        return resnet.resnet50(1000, data_format="NHWC", device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(12))

    fmodel, model = net().eval(), quant.quantize_model(net())
    rng = torch.Generator(device="cuda").manual_seed(13)
    calib = [torch.randn(8, 3, 224, 224, generator=rng, device="cuda")
             for _ in range(4)]
    x = torch.randn(CONV_BATCH, 3, 224, 224, generator=rng, device="cuda")
    quant.calibrate(model, calib)
    shapes = collections.Counter()
    real = int8_mod.quant_matmul_packed

    def spy(a, w, *args, **kw):
        shapes[(a.shape[0], a.shape[1], w.shape[0])] += 1
        return real(a, w, *args, **kw)

    with torch.no_grad():
        ref = model(x)                       # fake-quant float, eval
        swapped = quant.int8_swap(model, quant.freeze(model))
        if swapped != 54:
            raise SystemExit(f"int8_swap swapped {swapped} layers, not 53 "
                             "convs and the head")
        model(x)                             # packs the weights once
        torch.cuda.synchronize()
        # the main path: the swapped model's forward
        QM.quant_matmul.launches = QM.quant_linear.launches = 0
        for name in KERNEL_ROWS:
            getattr(K, name).launches = 0
        reset_flash_counts(FK)
        int8_mod.quant_matmul_packed = spy
        try:
            out = model(x)
            torch.cuda.synchronize()
        finally:
            int8_mod.quant_matmul_packed = real
        launches = {"quant_matmul": QM.quant_matmul.launches,
                    "quant_linear": QM.quant_linear.launches}
        others = (sum(decode_counts(K).values())
                  + sum(flash_counts(FK).values()))
        # the same forward on the plain versions (a check, not a path)
        int8_mod.quant_matmul_packed = lambda a, w, *r, **kw: \
            QM.quant_matmul_plain(a, w[:, :a.shape[1]].t(), *r, **kw)
        int8_mod.quant_linear = QM.quant_linear_plain
        try:
            plain = model(x)
        finally:
            int8_mod.quant_matmul_packed = real
            int8_mod.quant_linear = QM.quant_linear
        exact = torch.equal(out, plain)
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                            device="cuda")
        int8_ms = time_ms(torch, lambda: model(x), flush, n=10)
        float_ms = time_ms(torch, lambda: fmodel(x), flush, n=10)
    per_shape = {name: shapes[(m, -(-k // 16) * 16, n)]
                 for name, m, k, n in CONV_SHAPES}
    log(f"[int8:resnet50] resnet50(1000) NHWC PTQ: {swapped} layers "
        f"swapped; batch {CONV_BATCH} forward launched quant_matmul "
        f"{launches['quant_matmul']} times over {len(shapes)} shapes (at "
        f"{per_shape}), quant_linear {launches['quant_linear']}, other "
        f"kernels {others}; equals the plain-version forward: {exact}; "
        f"max |int8 - fake-quant| / max |fake-quant| {rel:.3e} (reported: "
        f"53 quantized layers at random weights); forward {int8_ms:.3f} ms "
        f"int8, {float_ms:.3f} ms float32 (CUDA events, L2 flushed, mean "
        f"of 10)")
    if not (launches == {"quant_matmul": 53, "quant_linear": 1}
            and others == 0 and exact and sum(shapes.values()) == 53
            and all(per_shape.values())
            and bool(torch.isfinite(out).all())
            and out.shape == (CONV_BATCH, 1000)):
        raise SystemExit("the int8 ResNet-50 forward failed its checks")
    return launches, per_shape


def phase_qmm_conv_timing(torch, QM, err, total, per_shape):
    """quant_matmul at ResNet-50's im2col shapes (CONV_SHAPES, per-channel
    scales, float32 out), through the int8 conv's entry (the weight
    packed once, A in K16 columns): kernel, plain version and the
    yardstick torch._int_mm plus the same scaling. The first row carries
    the kernel's name and its launches on the int8 ResNet-50 path; the
    others their shape and their launches at it."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for i, (name, m, k, n) in enumerate(CONV_SHAPES):
        a, b, sa = qmm_operands(torch, m, k, n, gen)
        sa = sa.reshape(1)
        sb = torch.rand((n,), generator=gen, device="cuda") * 0.01
        k16 = -(-k // 16) * 16
        a16 = torch.zeros((m, k16), dtype=torch.int8, device="cuda")
        a16[:, :k] = a
        w_packed = QM.pack_weight(b)
        b16 = torch.zeros((k16, n), dtype=torch.int8, device="cuda")
        b16[:k] = b

        def kern():
            return QM.quant_matmul_packed(a16, w_packed, sa, sb)

        def plain():
            return QM.quant_matmul_plain(a, b, sa, sb)

        def library():
            return torch._int_mm(a16, b16).float() * (sa * sb)[None, :]

        if not torch.equal(library(), kern()):
            raise SystemExit("the conv quant_matmul yardstick computes "
                             "another function")
        ms = time_ms(torch, kern, flush)
        plain_ms = time_ms(torch, plain, flush, n=10)
        lib_ms = time_ms(torch, library, flush)
        bound_ms, bound_by, nbytes = gemm_bound(m, k, n, 1, 0)
        log(f"[time] quant_matmul conv {name} {m}x{k}x{n} (K16 {k16}) "
            f"per-channel, float32 out: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, yardstick _int_mm {lib_ms:.4f} ms; "
            f"{2 * m * n * k} int8 ops, {nbytes} bytes, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of "
            f"the bound")
        rows.append(dict(
            name="quant_matmul" if i == 0 else f"quant_matmul@{name}",
            route="cuda", source="paddle_tpu_torch/csrc/quant_matmul.cu",
            replaces=QMM_REPLACES,
            launches=total if i == 0 else per_shape[name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms))
        del a, a16, b16
    return rows


def step_profile(torch, step, wall_ms, n=3):
    """Device busy ms per step (CUDA kernel and copy time under
    torch.profiler) over ``n`` steps, the idle share against the
    profiler-off wall time ``wall_ms`` per step, and the device ops per
    step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    return busy_ms, 1 - busy_ms / wall_ms, sum(e.count for e in events) / n


def timed_steps(torch, step, warm, n):
    """``warm`` untimed calls of ``step``, then ``n`` timed ones (each
    ending in a synchronize); ``step`` returns a loss, a tuple led by
    one, or None. Returns (every call's loss, the timed calls' ms)."""
    losses, secs = [], []
    for i in range(warm + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        if i >= warm:
            secs.append(time.perf_counter() - t0)
        if isinstance(out, tuple):
            out = out[0]
        if out is not None:
            losses.append(float(out))
    return losses, [1e3 * x for x in secs]


def finite_and_falling(losses):
    return (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0])


def phase_train_mnist(torch):
    """BASELINE config 1 on the card: MnistMLP(512, 256) at batch 8192
    through train_steps(batch, 8), bench.py's steps_per_call (the key
    split once a call, then 8 ways), and MnistCNN at batch 128, each with
    Adam(1e-3) over 5 calls on one seeded batch; losses finite and
    falling."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models import mnist as M
    from paddle_tpu_torch.parallel import Trainer

    gen = torch.Generator(device="cuda").manual_seed(20)
    cases = (
        ("MnistMLP(512, 256)", M.MnistMLP(512, 256, device="cuda",
                                          generator=gen),
         MNIST_BATCH, (784,), MNIST_STEPS_PER_CALL),
        ("MnistCNN", M.MnistCNN(device="cuda", generator=gen), CNN_BATCH,
         (1, 28, 28), 1))
    for name, model, bs, shape, k in cases:
        tr = Trainer.supervised(model, TO.Adam(1e-3), M.loss_fn)
        batch = {"x": torch.randn((bs,) + shape, generator=gen,
                                  device="cuda"),
                 "label": torch.randint(0, 10, (bs,), generator=gen,
                                        device="cuda")}
        losses, secs = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = (tr.train_steps(batch, k) if k > 1
                       else tr.train_step(batch))
            losses.append(float(loss))       # syncs
            secs.append((time.perf_counter() - t0) / k)
        ms = 1e3 * sorted(secs[1:])[len(secs[1:]) // 2]
        log(f"[train:mnist] {name} batch {bs}, Adam(1e-3), "
            f"{'train_steps(batch, %d)' % k if k > 1 else 'train_step'} x 5:"
            f" losses {[round(v, 6) for v in losses]}; ms per step "
            f"{[round(1e3 * v, 3) for v in secs]}, median after the first "
            f"{ms:.3f} ms, {bs / (ms / 1e3):.1f} examples/s; key "
            f"{tr._key.tolist()}")
        if not finite_and_falling(losses):
            raise SystemExit(f"[train:mnist] {name}: losses not finite and "
                             "falling")


def grads_and_buffers(torch, model, x, y):
    """Train-mode loss, every gradient and the BN buffers after the
    forward, as float64 CPU tensors."""
    from paddle_tpu_torch.models import resnet

    model.train()
    loss = resnet.loss_fn(model(x), y)
    loss.backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters()}
    bufs = {n: b.detach().double().cpu() for n, b in model.named_buffers()}
    return float(loss.detach()), grads, bufs


def rel_distance(a, b):
    """{name: max |a - b| / max |b|} over the gradients of two passes."""
    return {n: ((a[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)
                ).item() for n, g in b.items()}


def phase_train_resnet50(torch):
    """BASELINE config 2 on the card. A check step at B=2, 224 px in both
    layouts, the port on the card against the port on the CPU with the
    same weights and batch, in float64 and in float32. float64 is held to
    loss 1e-4, BN buffers 1e-4 and each grad within 1e-3 of its
    parameter's largest CPU-grad entry. float32 to the same loss and
    buffer limits; its grads cannot be: a pre-activation within
    float32's rounding of zero flips its ReLU mask between any two
    float32 passes, and each flip moves that gradient entry by its whole
    size (block15's entries by up to 0.84 of the largest), which every
    earlier layer inherits: the CPU's own float32 grads sit up to ~0.2
    of a parameter's largest entry from float64. So each float32
    grad's distance from the float64 pass is held to twice the CPU's
    worst (at least 1e-3): the card must be as accurate as the CPU. Then
    the JAX bench's cell:
    resnet50(1000), b128, 224 px, all-zero labels, Adam(1e-3),
    mixed_bf16, 2 warm-up and 5 timed steps, NHWC and NCHW; losses finite
    and falling."""
    import copy

    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.dtypes import Policy, policy_scope
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel import Trainer

    tol_loss, tol_grad, tol_buf = RESNET_CHECK_TOL
    f64 = Policy("float64", "float64", "float64")
    for fmt in ("NHWC", "NCHW"):
        cpu_gen = torch.Generator().manual_seed(21)
        cpu = resnet.resnet50(1000, data_format=fmt, device="cpu",
                              generator=cpu_gen)
        x = torch.randn(2, 3, 224, 224, generator=cpu_gen)
        y = torch.randint(0, 1000, (2,), generator=cpu_gen)
        runs = {}
        for dtype in ("float32", "float64"):
            for dev in ("cpu", "cuda"):
                model = copy.deepcopy(cpu).to(dev, getattr(torch, dtype))
                with policy_scope(f64 if dtype == "float64" else "float32"):
                    runs[dtype, dev] = grads_and_buffers(
                        torch, model, x.to(dev, getattr(torch, dtype)),
                        y.to(dev))
                del model
        ok, lines = True, []
        for dtype in ("float64", "float32"):
            got, want = runs[dtype, "cuda"], runs[dtype, "cpu"]
            dloss = abs(got[0] - want[0])
            dbuf = max((got[2][n] - b).abs().max().item()
                       for n, b in want[2].items())
            if dtype == "float64":
                d = rel_distance(got[1], want[1])
                worst = max(d, key=d.get)
                limit, what = tol_grad, f"{d[worst]:.3e} from the CPU's"
            else:
                exact = runs["float64", "cpu"][1]
                d = rel_distance(got[1], exact)
                cpu_d = max(rel_distance(want[1], exact).values())
                worst = max(d, key=d.get)
                limit = max(tol_grad, 2 * cpu_d)
                what = (f"{d[worst]:.3e} from float64 (the CPU's worst "
                        f"{cpu_d:.3e})")
            good = (dloss <= tol_loss and dbuf <= tol_buf
                    and d[worst] <= limit)
            ok &= good
            lines.append(
                f"{dtype}: loss {got[0]:.6f} vs {want[0]:.6f} (|diff| "
                f"{dloss:.3e}, limit {tol_loss}); worst grad {worst} "
                f"{what}, limit {limit:.3e}; worst BN buffer {dbuf:.3e} "
                f"(limit {tol_buf}) {'ok' if good else 'FAIL'}")
        log(f"[train:resnet50] check step {fmt} B=2 224 px, card against "
            f"CPU: " + "; ".join(lines))
        if not ok:
            raise SystemExit(f"[train:resnet50] {fmt} check step failed")
        del cpu, runs
    torch.cuda.empty_cache()
    for fmt in ("NHWC", "NCHW"):
        gen = torch.Generator(device="cuda").manual_seed(22)
        model = resnet.resnet50(1000, data_format=fmt, device="cuda",
                                generator=gen)
        tr = Trainer.supervised(model, TO.Adam(1e-3), resnet.loss_fn,
                                amp=RESNET_POLICY)
        batch = {"x": torch.randn(RESNET_BATCH, 3, RESNET_PX, RESNET_PX,
                                  generator=gen, device="cuda"),
                 "label": torch.zeros(RESNET_BATCH, dtype=torch.long,
                                      device="cuda")}
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = timed_steps(torch, lambda: tr.train_step(batch),
                                      2, 5)
        ms = sum(step_ms) / len(step_ms)
        log(f"[train:resnet50] {fmt} b{RESNET_BATCH} {RESNET_PX} px "
            f"{RESNET_POLICY} Adam(1e-3), all-zero labels: losses "
            f"{[round(v, 6) for v in losses]}; ms per timed step "
            f"{[round(v, 3) for v in step_ms]}, mean {ms:.3f} ms, "
            f"{RESNET_BATCH / (ms / 1e3):.1f} images/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if not finite_and_falling(losses):
            raise SystemExit(f"[train:resnet50] {fmt}: losses not finite "
                             "and falling")
        del tr, model, batch
        torch.cuda.empty_cache()


def deepfm_cell(torch, vocab, sparse, device="cuda"):
    """bench.py's DeepFM at ``vocab`` (the stream seeded 0, as the bench
    seeds it) and its batch (numpy seed 0: ids uniform over the vocab,
    dense features normal; the labels are ids[:, 0] % 2)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import deepfm as DF

    ptt.seed(0)
    cfg = DF.DeepFMConfig(total_vocab=vocab, num_fields=26, dense_dim=13,
                          embed_dim=16, embedding_axis=None,
                          sparse_grads=sparse)
    model = DF.DeepFM(cfg, device=device)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(
        0, vocab, (DEEPFM_BATCH, cfg.num_fields))).to(device)
    dense = torch.from_numpy(rng.normal(
        size=(DEEPFM_BATCH, cfg.dense_dim)).astype(np.float32)).to(device)
    return model, ids, dense


def deepfm_loss(model, ids, dense, params=None):
    """The bench's loss: sigmoid BCE of the logits against ids[:, 0] % 2,
    through ``functional_call`` when ``params`` are given."""
    from paddle_tpu_torch.models import deepfm as DF

    logits = (model(ids, dense) if params is None
              else model.functional_call(params, ids, dense)[0])
    return DF.loss_fn(logits, ids[:, 0] % 2)


def deepfm_check_step(torch):
    """The card against the CPU on the same weights and batch at the
    bench's vocab, float64 (gated: loss 1e-4, each grad within 1e-3 of
    its parameter's largest CPU-grad entry) and float32 (reported: the
    tower's ReLU masks flip at float32 rounding)."""
    import copy

    from paddle_tpu_torch.core.dtypes import Policy, policy_scope

    tol_loss, tol_grad = DEEPFM_CHECK_TOL
    cpu, ids, dense = deepfm_cell(torch, DEEPFM_VOCABS[0], False, "cpu")
    f64 = Policy("float64", "float64", "float64")
    runs = {}
    for dtype in ("float64", "float32"):
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(cpu).to(dev, getattr(torch, dtype))
            with policy_scope(f64 if dtype == "float64" else "float32"):
                loss = deepfm_loss(model, ids.to(dev),
                                   dense.to(dev, getattr(torch, dtype)))
            loss.backward()
            runs[dtype, dev] = (float(loss.detach()), {
                n: p.grad.detach().double().cpu()
                for n, p in model.named_parameters()})
            del model
    lines, ok = [], True
    for dtype in ("float64", "float32"):
        (gl, gg), (wl, wg) = runs[dtype, "cuda"], runs[dtype, "cpu"]
        d = rel_distance(gg, wg)
        worst = max(d, key=d.get)
        line = (f"{dtype}: loss {gl:.8f} vs {wl:.8f} (|diff| "
                f"{abs(gl - wl):.3e}), worst grad {worst} {d[worst]:.3e} "
                f"of its largest CPU entry")
        if dtype == "float64":
            good = abs(gl - wl) <= tol_loss and d[worst] <= tol_grad
            ok &= good
            line += " ok" if good else " FAIL"
        else:
            line += " (reported)"
        lines.append(line)
    log(f"[train:deepfm] check step V={DEEPFM_VOCABS[0]} b{DEEPFM_BATCH}, "
        f"card against CPU (limits: loss {tol_loss}, grads {tol_grad}): "
        + "; ".join(lines))
    if not ok:
        raise SystemExit("[train:deepfm] float64 check step failed")


def sync_count(torch, fn):
    """(fn(), the synchronizing CUDA calls it made): torch's sync debug
    mode, counted as warnings."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(map(is_sync_warning, got))


def deepfm_sparse_against_dense(torch):
    """sparse_minimize_fn against the dense step (Optimizer.minimize_fn)
    on the card, float32, from the same weights, two Adam(1e-3) steps on
    the same ids: every touched row and every dense parameter within
    1e-5; rows outside the batch bitwise unchanged in the parameters and
    in both Adam moments. Reported: whether two runs of one sparse step
    are bit-equal (the duplicate sums run through index_add_'s atomics).
    Gated: merge_rows makes no host sync (sync debug mode "error")."""
    from paddle_tpu_torch import optimizer as TO

    model, ids, dense = deepfm_cell(torch, DEEPFM_VOCABS[0], True)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    def fl(p, i, d):
        return deepfm_loss(model, i, d, p)

    init_fn, step_fn = TO.sparse_minimize_fn(model, fl, TO.Adam(1e-3))
    dstep = TO.Adam(1e-3).minimize_fn(fl)
    sp = {n: v.clone() for n, v in start.items()}
    dp = {n: v.clone() for n, v in start.items()}
    sst, dst = init_fn(sp), TO.Adam(1e-3).init(dp)
    for _ in range(2):
        step_fn(sp, sst, ids, dense)
        dstep(dp, dst, ids, dense)
    touched = torch.unique(ids)
    untouched = torch.ones(model.cfg.total_vocab, dtype=torch.bool,
                           device=ids.device)
    untouched[touched] = False
    worst, frozen = {}, True
    for n in sp:
        a, b = ((sp[n][touched], dp[n][touched]) if n in sst["sparse"]
                else (sp[n], dp[n]))
        worst[n] = (a - b).abs().max().item()
        if n in sst["sparse"]:
            frozen &= torch.equal(sp[n][untouched], start[n][untouched])
            for leaf in sst["sparse"][n].values():
                frozen &= not leaf[untouched].any().item()
    name = max(worst, key=worst.get)
    # two runs of one sparse step from the same state
    outs = []
    for _ in range(2):
        p = {n: v.clone() for n, v in start.items()}
        st = init_fn(p)
        loss, _, _ = step_fn(p, st, ids, dense)
        outs.append([loss] + list(p.values()) + [
            leaf for t in st["sparse"].values() for leaf in t.values()])
    bit_equal = all(torch.equal(a, b) for a, b in zip(*outs))
    from paddle_tpu_torch.optimizer.sparse import merge_rows

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        uids, _ = merge_rows(ids, torch.ones(ids.shape + (16,),
                                             device=ids.device),
                             model.cfg.total_vocab)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    distinct = int((uids < model.cfg.total_vocab).sum())
    log(f"[train:deepfm] sparse against dense, float32, 2 Adam(1e-3) steps "
        f"on the same ids ({distinct} distinct of {ids.numel()}): worst "
        f"{name} {worst[name]:.3e} (touched rows and dense parameters, "
        f"limit {DEEPFM_SPARSE_TOL}); untouched rows "
        f"{'bitwise unchanged' if frozen else 'MOVED'} in the parameters "
        f"and both Adam moments; merge_rows made no host sync; two runs of "
        f"one sparse step bit-equal: {bit_equal}")
    if worst[name] > DEEPFM_SPARSE_TOL or not frozen:
        raise SystemExit("[train:deepfm] sparse step disagrees with the "
                         "dense step")


def deepfm_timed_cell(torch, vocab, sparse):
    """The bench's cell: 3 warm-up and 5 timed steps, each ending in a
    synchronize; ms per step, examples/s, peak memory, the losses
    (finite and falling), the host syncs of one more step and the AUC
    over the batch after it."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.dtypes import policy_scope
    from paddle_tpu_torch.metrics import Auc
    from paddle_tpu_torch.parallel import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, ids, dense = deepfm_cell(torch, vocab, sparse)
    if sparse:
        def fl(p, i, d):
            with policy_scope(DEEPFM_POLICY):
                return deepfm_loss(model, i, d, p)

        init_fn, step_fn = TO.sparse_minimize_fn(model, fl, TO.Adam(1e-3))
        params = dict(model.named_parameters())
        state = init_fn(params)

        def step():
            return step_fn(params, state, ids, dense)[0]
    else:
        tr = Trainer(model, TO.Adam(1e-3),
                     lambda m, b, g: (deepfm_loss(m, *b), {}),
                     amp=DEEPFM_POLICY)

        def step():
            return tr.train_step((ids, dense))[0]
    losses, step_ms = timed_steps(torch, step, 3, 5)
    loss, syncs = sync_count(torch, step)
    losses.append(float(loss))
    with torch.no_grad(), policy_scope(DEEPFM_POLICY):
        probs = torch.sigmoid(model(ids, dense))
    auc = Auc()
    auc.update(probs, ids[:, 0] % 2)
    ms = sum(step_ms) / len(step_ms)
    kind = "sparse" if sparse else "dense"
    log(f"[train:deepfm] {kind} V={vocab} b{DEEPFM_BATCH} {DEEPFM_POLICY} "
        f"Adam(1e-3): losses {[round(v, 6) for v in losses]}; ms per timed "
        f"step {[round(v, 3) for v in step_ms]}, mean {ms:.3f} ms, "
        f"{DEEPFM_BATCH / (ms / 1e3):.1f} examples/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; host syncs "
        f"in one step {syncs}; AUC over the batch {auc.eval():.4f}")
    if not finite_and_falling(losses):
        raise SystemExit(f"[train:deepfm] {kind} V={vocab}: losses not "
                         "finite and falling")
    return ms


def phase_train_deepfm(torch):
    """BASELINE config 5 on the card: the float64 check step, the sparse
    step against the dense one, then the six timed cells (dense and
    sparse at each vocab) and the dense/sparse ratio at each vocab (the
    crossover, reported)."""
    deepfm_check_step(torch)
    deepfm_sparse_against_dense(torch)
    ratios = []
    for vocab in DEEPFM_VOCABS:
        d_ms = deepfm_timed_cell(torch, vocab, False)
        s_ms = deepfm_timed_cell(torch, vocab, True)
        ratios.append(f"V={vocab} {d_ms / s_ms:.3f}")
    log("[train:deepfm] dense ms / sparse ms per step: " + ", ".join(ratios))
    torch.cuda.empty_cache()


def nmt_model(torch, seed=0):
    """NMTConfig.base() on the card, its weights from the global stream
    seeded ``seed`` (bench.py seeds 0)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer as TR

    ptt.seed(seed)
    return TR.TransformerNMT(TR.NMTConfig.base(), device="cuda")


def nmt_batch(torch, cfg, b, ts, tt, seed=0, padded=False):
    """(src, tgt, labels) on the card from numpy seed ``seed``, ids in [3,
    vocab) as bench.py draws them (src first, then tgt; the labels are
    tgt). ``padded``: each source row keeps a random 25-100% prefix, the
    rest pad_id, and row 0 is all pad."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src = rng.integers(3, cfg.src_vocab, (b, ts))
    tgt = rng.integers(3, cfg.tgt_vocab, (b, tt))
    if padded:
        lens = rng.integers(ts // 4, ts + 1, (b, 1))
        src = np.where(np.arange(ts)[None, :] < lens, src, cfg.pad_id)
        src[0, :] = cfg.pad_id
    src, tgt = (torch.as_tensor(x, device="cuda") for x in (src, tgt))
    return src, tgt, tgt


def nmt_attentions(model):
    """Every MultiHeadAttention of the NMT: the encoder's, then each
    decoder block's self- and cross-attention."""
    out = [layer.self_attn for layer in model.encoder.layers]
    for layer in model.decoder.layers:
        out += [layer.self_attn, layer.cross_attn]
    return out


def phase_train_nmt(torch, FK):
    """BASELINE config 4 on the card: check steps (kernels against plain
    attention, the same weights and dropout masks) on a padded 128-token
    source against a 64-token target under mixed_bf16 and float32, the
    exact launches of one bench step, 5 timed Adam steps at B=64 with the
    device's idle share, and B=256 reported."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core import policy_scope, rng_scope
    from paddle_tpu_torch.ops import attention as TA
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train:nmt]"
    model = nmt_model(torch)
    cfg = model.cfg
    params = dict(model.named_parameters())
    mhas = nmt_attentions(model)
    log(f"{tag} NMTConfig.base() ({cfg.num_encoder_layers}+"
        f"{cfg.num_decoder_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, FFN {cfg.dim_feedforward}, vocab "
        f"{cfg.src_vocab}/{cfg.tgt_vocab}, dropout {cfg.dropout}, label "
        f"smoothing {cfg.label_smooth}), "
        f"{sum(p.numel() for p in params.values())} float32 parameters; "
        f"forward_fused_loss, Adam(1e-3), policy {NMT_POLICY}")
    # flash launches of one pass: every attention, forward and backward
    want = {name: len(mhas) for name in FLASH_ROWS}

    # 1. check steps, as [train:bert_base]'s: the generator re-seeded
    # before each pass, so the layer dropouts and the attention seeds
    # agree; under mixed_bf16 a plain pass in float64 gives the noise floor
    batch = nmt_batch(torch, cfg, NMT_CHECK_B, NMT_CHECK_SRC, NMT_CHECK_TGT,
                      seed=1, padded=True)
    live = (batch[0] != cfg.pad_id).sum(1)
    log(f"{tag} check batch ({NMT_CHECK_B}, src {NMT_CHECK_SRC}, tgt "
        f"{NMT_CHECK_TGT}): live source tokens per row "
        f"{live.tolist()} (row 0 all pad)")
    model.train()
    xla = TA.xla_attention

    def plain64(q, k, v, **kw):
        return xla(q.double(), k.double(), v.double(), **kw).to(q.dtype)

    for policy in (NMT_POLICY, "float32"):
        loss_atol, grad_rtol = TRAIN_TOL[policy]
        passes = [("kernels", True, xla), ("plain", False, xla)]
        if policy != "float32":
            passes.append(("plain64", False, plain64))
        grads, losses = {}, {}
        for name, use_flash, attention in passes:
            TA.xla_attention = attention
            for mha in mhas:
                mha.use_flash = use_flash
            n0 = flash_counts(FK)
            gen = torch.Generator(device="cuda").manual_seed(16)
            try:
                with policy_scope(policy), rng_scope(gen):
                    loss = model.forward_fused_loss(*batch)
            finally:
                TA.xla_attention = xla
            loss.backward()
            launched = {k: v - n0[k] for k, v in flash_counts(FK).items()}
            if launched != (want if use_flash else
                            {k: 0 for k in FLASH_ROWS}):
                raise SystemExit(f"{tag} check step {name}: flash launches "
                                 f"{launched}")
            losses[name] = loss.item()
            grads[name] = {n: p.grad for n, p in params.items()}
            for p in params.values():
                p.grad = None
        for mha in mhas:
            mha.use_flash = True
        (worst, where), (noise, nwhere) = grad_distance(
            grads, params, "kernels", "plain")
        dloss = abs(losses["kernels"] - losses["plain"])
        floor = ""
        if "plain64" in grads:
            (f_worst, f_where), _ = grad_distance(grads, params, "plain64",
                                                  "plain")
            f_loss = abs(losses["plain64"] - losses["plain"])
            loss_atol = max(loss_atol, 2 * f_loss)
            grad_rtol = max(grad_rtol, 2 * f_worst)
            floor = (f"; the noise floor, plain float64 attention against "
                     f"plain: loss {f_loss:.3e}, worst grad {f_worst:.3e} "
                     f"({f_where}); limits max(2e-2, twice the floor)")
        log(f"{tag} check step {policy}: loss kernels "
            f"{losses['kernels']:.6f}, plain {losses['plain']:.6f} (|diff| "
            f"{dloss:.3e}, atol {loss_atol:.3e}); worst grad diff / the "
            f"parameter's max plain grad {worst:.3e} ({where}; limit "
            f"{grad_rtol:.3e}){floor}; the key biases (0 in exact "
            f"arithmetic, reported): {noise:.3e} ({nwhere}); flash launches "
            f"a pass {want}")
        if not (dloss <= loss_atol and worst <= grad_rtol
                and math.isfinite(losses["kernels"])):
            raise SystemExit(f"{tag} the kernel path's loss or grads "
                             f"disagree with plain attention ({policy})")
        del grads

    # 2. the launches of one bench step, 3. five timed steps
    trainer = Trainer(model, optimizer.Adam(1e-3),
                      lambda m, b, g: (m.forward_fused_loss(*b), {}),
                      amp=NMT_POLICY)
    batch = nmt_batch(torch, cfg, NMT_B, NMT_T, NMT_T)
    torch.cuda.synchronize()
    reset_flash_counts(FK)
    trainer.train_step(batch)
    torch.cuda.synchronize()
    per_step = flash_counts(FK)
    f32 = flash_counts(FK, torch.float32)
    log(f"{tag} launches in one step: {per_step}, of them float32 {f32} "
        f"(want {want}, all float32: {cfg.num_encoder_layers} encoder "
        f"self-attentions, {cfg.num_decoder_layers} causal decoder "
        f"self-attentions, {cfg.num_decoder_layers} cross-attentions)")
    if per_step != want or f32 != want:
        raise SystemExit(f"{tag} a training step launched the flash kernels "
                         f"another number of times or in another dtype")
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(torch, lambda: trainer.train_step(batch), 0, 5)
    mean = sum(ms) / len(ms)
    busy, idle, _ = step_profile(torch, lambda: trainer.train_step(batch),
                                 mean)
    log(f"{tag} B={NMT_B} src={NMT_T} tgt={NMT_T}, 5 Adam steps: losses "
        f"{[round(x, 6) for x in losses]}; ms per step "
        f"{[round(x, 3) for x in ms]}, mean {mean:.3f} ms, "
        f"{NMT_B * NMT_T / (mean / 1e3):.1f} target tokens/s; device busy "
        f"{busy:.3f} ms per step, idle share {idle:.3f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not finite_and_falling(losses):
        raise SystemExit(f"{tag} training losses not finite and falling: "
                         f"{losses}")
    big = nmt_batch(torch, cfg, NMT_BIG_B, NMT_T, NMT_T, seed=2)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(torch, lambda: trainer.train_step(big), 1, 3)
    mean = sum(ms) / len(ms)
    log(f"{tag} B={NMT_BIG_B} (reported): losses "
        f"{[round(x, 6) for x in losses]}; ms per step "
        f"{[round(x, 3) for x in ms]}, mean {mean:.3f} ms, "
        f"{NMT_BIG_B * NMT_T / (mean / 1e3):.1f} target tokens/s; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{tag} B={NMT_BIG_B}: non-finite losses")
    del trainer, model, big, batch
    torch.cuda.empty_cache()
    return per_step


def shifted_input(torch, cfg, out):
    """The decoder input that produced ``out`` (B, T): bos, then out
    without its last token."""
    bos = torch.full_like(out[:, :1], cfg.bos_id)
    return torch.cat([bos, out[:, :-1]], dim=1)


def upto_first_eos(torch, cfg, out):
    """(B, T) bool: the positions up to and including each row's first
    eos (all of them where a row has none)."""
    is_end = out == cfg.eos_id
    t = out.shape[1]
    first = torch.where(is_end.any(1), torch.argmax(is_end.int(), 1), t - 1)
    return torch.arange(t, device=out.device)[None, :] <= first[:, None]


def phase_serve_nmt(torch, K, FK):
    """nmt_decode on the card (bench.py:599-648): greedy_decode_cached at
    B=32, src 64, max_len 64, held teacher-forced in float32 with exact
    decode-kernel launches and no host sync; both decoders timed under
    mixed_bf16; then beam_decode_cached (B=8, beam 4) with its scores
    held to a teacher-forced rescoring."""
    import numpy as np

    from paddle_tpu_torch.core import policy_scope

    tag = "[serve:nmt]"
    model = nmt_model(torch).eval()
    cfg = model.cfg
    L = cfg.num_decoder_layers
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.integers(3, cfg.src_vocab,
                                       (NMT_DECODE_B, 64)), device="cuda")
    names = ("decode_attention", "decode_attention_paged",
             "decode_attention_paged_quant")

    def reset():
        for n in names:
            getattr(K, n).launches = 0
            getattr(K, n).dtype_launches.clear()
        reset_flash_counts(FK)

    # 1. float32: the launches of one call, the teacher-forced check
    reset()
    out = model.greedy_decode_cached(src, max_len=64)
    torch.cuda.synchronize()
    got = {n: getattr(K, n).launches for n in names}
    f32 = K.decode_attention.dtype_launches.get(torch.float32, 0)
    need = L * 64
    log(f"{tag} greedy_decode_cached B={NMT_DECODE_B} src 64 max_len 64 "
        f"float32: decode launches {got}, of them float32 {f32} (want "
        f"{need} = {L} layers x 64 steps, no paged kernel); the encoder's "
        f"flash forward launches {FK.flash_attention_fwd.launches}")
    if (got["decode_attention"] != need or f32 != need
            or got["decode_attention_paged"]
            or got["decode_attention_paged_quant"]):
        raise SystemExit(f"{tag} the cached decode launched the decode "
                         f"kernels another number of times")
    with torch.inference_mode():
        logits = model(src, shifted_input(torch, cfg, out)).float()
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{tag} non-finite teacher-forced logits")
    picked = torch.gather(logits, 2, out[..., None])[..., 0]
    gap = logits.max(-1).values - picked
    live = upto_first_eos(torch, cfg, out)
    worst = gap[live].max().item()
    log(f"{tag} teacher-forced: the worst emitted token sits {worst:.3e} "
        f"below its position's max logit (limit 1e-3) over "
        f"{int(live.sum())} emitted positions; rows that emitted eos "
        f"{int((out == cfg.eos_id).any(1).sum())}")
    if worst > 1e-3:
        raise SystemExit(f"{tag} teacher-forced check failed")
    again, syncs = sync_count(
        torch, lambda: model.greedy_decode_cached(src, max_len=64))
    log(f"{tag} host syncs in one greedy_decode_cached call (encoder and "
        f"64 steps): {syncs}; tokens equal to the first call's: "
        f"{bool(torch.equal(again, out))}")
    if syncs != 0:
        raise SystemExit(f"{tag} the cached decode synchronises with the "
                         f"host")

    # 2. both decoders timed under mixed_bf16 (the bench's policy sweep);
    # the caches take the memory's dtype, float32 under mixed_bf16 (the
    # Linears' output dtype), so only the float32 decode instance runs
    reset()
    with policy_scope(NMT_POLICY):
        runs = {}
        for name, fn, n in (("cached", model.greedy_decode_cached, 5),
                            ("no-kv-cache", model.greedy_decode, 3)):
            outs = []
            _, ms = timed_steps(
                torch, lambda: outs.append(fn(src, max_len=64)), 1, n)
            runs[name] = (outs[-1], sum(ms) / len(ms))
            log(f"{tag} greedy {name} {NMT_POLICY} B={NMT_DECODE_B}: ms per "
                f"call {[round(x, 3) for x in ms]}, mean "
                f"{runs[name][1]:.3f} ms, "
                f"{NMT_DECODE_B * 64 / (runs[name][1] / 1e3):.1f} tokens/s")
    by_dtype = {str(k)[6:]: n for k, n in
                K.decode_attention.dtype_launches.items()}
    log(f"{tag} decode launches by dtype under {NMT_POLICY}: {by_dtype} "
        f"(want float32 only, {6 * need} over the 6 cached calls)")
    if by_dtype != {"float32": 6 * need}:
        raise SystemExit(f"{tag} the cached decode under {NMT_POLICY} ran "
                         f"another decode instance")
    a, b = runs["cached"][0], runs["no-kv-cache"][0]
    log(f"{tag} cached against no-kv-cache under {NMT_POLICY}: "
        f"{(a == b).float().mean().item():.4f} of tokens and "
        f"{int((a == b).all(1).sum())}/{NMT_DECODE_B} rows agree "
        f"(reported); cached is "
        f"{runs['no-kv-cache'][1] / runs['cached'][1]:.2f}x faster")

    # 3. beam search, float32: each returned score against the
    # teacher-forced sum of its sequence's log-probabilities
    src8 = src[:NMT_BEAM_B]
    k = NMT_BEAM_K
    res = []
    _, ms = timed_steps(torch, lambda: res.append(model.beam_decode_cached(
        src8, max_len=64, beam_size=k)), 1, 2)
    seqs, scores = res[-1]
    flat = seqs.reshape(NMT_BEAM_B * k, 64)
    with torch.inference_mode():
        logp = torch.log_softmax(model(
            src8.repeat_interleave(k, dim=0),
            shifted_input(torch, cfg, flat)).float(), -1)
    tok = torch.gather(logp, 2, flat[..., None])[..., 0]
    rescored = (tok * upto_first_eos(torch, cfg, flat)).sum(1)
    diff = (rescored.reshape(NMT_BEAM_B, k) - scores).abs().max().item()
    log(f"{tag} beam_decode_cached B={NMT_BEAM_B} beam {k} max_len 64 "
        f"float32: ms per call {[round(x, 3) for x in ms]}, mean "
        f"{sum(ms) / len(ms):.3f} ms; scores {scores[0].tolist()} (row 0); "
        f"worst |score - teacher-forced rescoring| {diff:.3e} (limit 1e-3)")
    if not (diff <= 1e-3 and bool(torch.isfinite(scores).all())):
        raise SystemExit(f"{tag} beam scores disagree with the "
                         f"teacher-forced rescoring")
    del model
    torch.cuda.empty_cache()


def phase_train_vit(torch, FK):
    """bench_vit on the card (bench.py:655): a check step of
    ViTConfig.base() at B=2, 224 px, NHWC, the card against the CPU on
    the same weights and images, float64 gated and float32 reported;
    then b128 with remat under mixed_bf16, NHWC (2 warm-up, 5 timed
    steps) and NCHW (1 and 3); no flash launch anywhere (197 tokens)."""
    import copy

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.dtypes import Policy, policy_scope
    from paddle_tpu_torch.models import vit as V
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train:vit]"
    reset_flash_counts(FK)
    tol_loss, tol_grad = VIT_CHECK_TOL
    f64 = Policy("float64", "float64", "float64")
    cpu_gen = torch.Generator().manual_seed(23)
    cfg = V.ViTConfig.base()
    cpu = V.ViT(cfg, device="cpu", generator=cpu_gen)
    x = torch.randn(2, 224, 224, 3, generator=cpu_gen)
    y = torch.randint(0, cfg.num_classes, (2,), generator=cpu_gen)
    runs = {}
    for dtype in ("float64", "float32"):
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(cpu).to(dev, getattr(torch, dtype))
            with policy_scope(f64 if dtype == "float64" else "float32"):
                loss = V.loss_fn(model(x.to(dev, getattr(torch, dtype))),
                                 y.to(dev))
            loss.backward()
            runs[dtype, dev] = (loss.item(), {
                n: p.grad.detach().double().cpu()
                for n, p in model.named_parameters()})
            del model
    lines, ok = [], True
    for dtype in ("float64", "float32"):
        got, want = runs[dtype, "cuda"], runs[dtype, "cpu"]
        ref = runs["float64", "cpu"][1]
        d = rel_distance(got[1], ref)
        gated = {n: v for n, v in d.items() if not n.endswith(ZERO_GRAD)}
        worst = max(gated, key=gated.get)
        noise = max(v for n, v in d.items() if n.endswith(ZERO_GRAD))
        dloss = abs(got[0] - want[0])
        good = dloss <= tol_loss and gated[worst] <= tol_grad
        if dtype == "float64":
            ok &= good
        lines.append(
            f"{dtype}: loss {got[0]:.6f} vs {want[0]:.6f} (|diff| "
            f"{dloss:.3e}); worst grad {worst} {gated[worst]:.3e} from the "
            f"CPU's float64; the key biases (0 in exact arithmetic) "
            f"{noise:.3e}" + (f" {'ok' if good else 'FAIL'}" if dtype ==
                              "float64" else " (reported)"))
    log(f"{tag} check step ViT-B/16 B=2 224 px NHWC, card against CPU "
        f"(float64 limits: loss {tol_loss}, grads {tol_grad}): "
        + "; ".join(lines))
    if not ok:
        raise SystemExit(f"{tag} float64 check step failed")
    del cpu, runs
    torch.cuda.empty_cache()
    for fmt, warm, n in (("NHWC", 2, 5), ("NCHW", 1, 3)):
        ptt.seed(0)
        cfg = V.ViTConfig.base()
        cfg.remat, cfg.layout = True, fmt
        model = V.ViT(cfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(24)
        shape = ((VIT_B, 224, 224, 3) if fmt == "NHWC"
                 else (VIT_B, 3, 224, 224))
        batch = (torch.randn(shape, generator=gen, device="cuda"),
                 torch.arange(VIT_B, device="cuda") % cfg.num_classes)
        tr = Trainer(model, TO.Adam(1e-3),
                     lambda m, b, g: (V.loss_fn(m(b[0]), b[1]), {}),
                     amp=VIT_POLICY)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(torch, lambda: tr.train_step(batch), warm,
                                 n)
        mean = sum(ms) / len(ms)
        log(f"{tag} {fmt} b{VIT_B} 224 px remat {VIT_POLICY} Adam(1e-3): "
            f"losses {[round(v, 6) for v in losses]}; ms per timed step "
            f"{[round(v, 3) for v in ms]}, mean {mean:.3f} ms, "
            f"{VIT_B / (mean / 1e3):.1f} images/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if not finite_and_falling(losses):
            raise SystemExit(f"{tag} {fmt}: losses not finite and falling")
        del tr, model, batch
        torch.cuda.empty_cache()
    launched = flash_counts(FK)
    log(f"{tag} flash launches over the phase: {launched} (want 0: 197 "
        f"tokens is not a multiple of 64)")
    if max(launched.values()):
        raise SystemExit(f"{tag} ViT's attention launched a flash kernel")


def phase_nmt_flash_timing(torch, FK):
    """The three flash kernels at the NMT's training shape (B=64, T=64,
    H=8, D=64, non-causal, a key mask, dropout 0.1, float32 as under
    mixed_bf16), each held against its plain version: kernel, plain and
    SDPA ms; printed only."""
    case = (NMT_B, NMT_T, 8, 8, 64, False, False, 0.1, True)
    b, t, h, _, d = case[:5]
    timed = flash_timed(torch, FK, case, 18,
                        lambda kw: kw["kv_mask"][:, None, None, :])
    for name, (ms, plain_ms, lib_ms, e) in timed.items():
        log(f"[time:nmt] {name} float32 (B={b}, T={t}, H={h}, D={d}, "
            f"non-causal, kv_mask, p=0.1): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA with the mask and dropout 0.1 (the "
            f"backward rows: SDPA's whole backward) {lib_ms:.4f} ms; "
            f"kernel against plain {e:.3e} (atol {FLASH_TOL['float32']})")


# ----- the Switch-MoE FFN, the CNN zoo and the stacked LSTM ----------------

@contextlib.contextmanager
def forced_routes(torch, record=None, forced=None):
    """Wrap the Switch FFN's router (paddle_tpu_torch/nn/moe.py
    ``_route``) for the block: each call's experts and, per token, the
    gap between its two largest router probabilities go to ``record``;
    with ``forced`` (an earlier pass's record, call by call) each call
    takes the forced experts, so that two passes route alike. Yields
    the list of (tokens whose own choice differed from the forced one,
    their gaps), one entry a call."""
    from paddle_tpu_torch.nn import moe

    orig = moe._route
    calls = None if forced is None else iter(forced)
    flips = []

    def route(x, router_w, top_k):
        logits, probs, top_i = orig(x, router_w, top_k)
        with torch.no_grad():
            top2 = torch.topk(probs, 2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
        if record is not None:
            record.append((top_i.detach(), gap))
        if calls is not None:
            want, _ = next(calls)
            flips.append(((top_i != want).any(-1), gap))
            top_i = want
        return logits, probs, top_i

    moe._route = route
    try:
        yield flips
    finally:
        moe._route = orig


def flip_summary(flips):
    """(tokens flipped over every call, the largest router-probability
    gap among them)."""
    n = sum(int(m.sum()) for m, _ in flips)
    gap = max((float(g[m].max()) for m, g in flips if bool(m.any())),
              default=0.0)
    return n, gap


def moe_aux(model):
    """MOE_AUX x the sum of the Switch FFNs' recorded aux losses."""
    return MOE_AUX * sum(v for k, v in model.named_buffers()
                         if k.endswith("ffn.aux_loss"))


def moe_check_steps(torch, FK, tag, model, mhas, loss_of):
    """The kernel path against plain attention on the same weights, under
    MOE_POLICY and float32, the routing of every pass forced to the
    plain pass's (so the gated distance is the attention's alone; the
    tokens each pass would have routed elsewhere, its routing flips, are
    counted and reported with their largest router-probability gap).
    Under MOE_POLICY a second plain pass, attention in float64, gives
    the noise floor: the limits are BERT's, 2e-2 or twice the floor
    where that is larger; float32's 1e-4 (loss) and 1e-3 (grads)."""
    from paddle_tpu_torch.core import policy_scope
    from paddle_tpu_torch.nn.layer import detach_buffers
    from paddle_tpu_torch.ops import attention as TA

    params = dict(model.named_parameters())
    xla = TA.xla_attention

    def plain64(q, k, v, **kw):
        return xla(q.double(), k.double(), v.double(), **kw).to(q.dtype)

    model.train()
    for policy in (MOE_POLICY, "float32"):
        loss_atol, grad_rtol = TRAIN_TOL[policy]
        passes = [("plain", False, xla), ("kernels", True, xla)]
        if policy != "float32":
            passes.append(("plain64", False, plain64))
        grads, losses, flips, routes = {}, {}, {}, []
        for name, use_flash, attention in passes:
            TA.xla_attention = attention
            for mha in mhas:
                mha.use_flash = use_flash
            n0 = flash_counts(FK)
            first = name == "plain"
            try:
                with forced_routes(torch, routes if first else None,
                                   None if first else routes) as fl, \
                        policy_scope(policy):
                    loss = loss_of(model)
            finally:
                TA.xla_attention = xla
            loss.backward()
            detach_buffers(model)
            launched = {k: v - n0[k] for k, v in flash_counts(FK).items()}
            if (min(launched.values()) == 0 if use_flash
                    else max(launched.values()) > 0):
                raise SystemExit(f"{tag} check step {name}: flash launches "
                                 f"{launched}")
            losses[name] = loss.item()
            grads[name] = {n: (torch.zeros_like(p) if p.grad is None
                               else p.grad) for n, p in params.items()}
            flips[name] = flip_summary(fl)
            for p in params.values():
                p.grad = None
        for mha in mhas:
            mha.use_flash = True
        (worst, where), (noise, nwhere) = grad_distance(
            grads, params, "kernels", "plain")
        dloss = abs(losses["kernels"] - losses["plain"])
        floor = ""
        if "plain64" in grads:
            (f_worst, f_where), _ = grad_distance(grads, params, "plain64",
                                                  "plain")
            f_loss = abs(losses["plain64"] - losses["plain"])
            loss_atol = max(loss_atol, 2 * f_loss)
            grad_rtol = max(grad_rtol, 2 * f_worst)
            floor = (f"; the noise floor, plain float64 attention against "
                     f"plain: loss {f_loss:.3e}, worst grad {f_worst:.3e} "
                     f"({f_where}), routing flips {flips['plain64'][0]} "
                     f"(largest gap {flips['plain64'][1]:.3e}); limits "
                     f"max(2e-2, twice the floor)")
        log(f"{tag} check step {policy} (routing forced to the plain "
            f"pass's): loss kernels {losses['kernels']:.6f}, plain "
            f"{losses['plain']:.6f} (|diff| {dloss:.3e}, atol "
            f"{loss_atol:.3e}); worst grad diff / the parameter's max plain "
            f"grad {worst:.3e} ({where}; limit {grad_rtol:.3e}); routing "
            f"flips of the kernel pass {flips['kernels'][0]} tokens over "
            f"{len(routes)} layers (largest router-probability gap among "
            f"them {flips['kernels'][1]:.3e}){floor}; the key biases "
            f"(reported): {noise:.3e} ({nwhere})")
        if not (dloss <= loss_atol and worst <= grad_rtol
                and math.isfinite(losses["kernels"])):
            raise SystemExit(f"{tag} the kernel path's loss or grads "
                             f"disagree with plain attention ({policy})")
        del grads, routes


def moe_train_cell(torch, FK, tag, model, batch, loss_of, per_example,
                   unit, layers, warm=0, n=5, counted=True):
    """Trainer(amp=MOE_POLICY) with Adam(1e-3) on ``batch``: with
    ``counted``, one step's flash launches (``layers`` of each, all
    float32), then ``warm`` + ``n`` timed steps (finite, falling when
    counted), the device's idle share, peak memory and each layer's
    kept_fraction after the last step."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.parallel import Trainer

    trainer = Trainer(model, optimizer.Adam(1e-3),
                      lambda m, b, g: (loss_of(m, b), {}), amp=MOE_POLICY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step = None
    if counted:
        reset_flash_counts(FK)
        trainer.train_step(batch)
        torch.cuda.synchronize()
        per_step = flash_counts(FK)
        f32 = flash_counts(FK, torch.float32)
        want = {name: layers for name in FLASH_ROWS}
        log(f"{tag} launches in one step: {per_step}, of them float32 {f32} "
            f"(want {want}, all float32)")
        if per_step != want or f32 != want:
            raise SystemExit(f"{tag} a training step launched the flash "
                             f"kernels another number of times or in "
                             f"another dtype")
    losses, ms = timed_steps(torch, lambda: trainer.train_step(batch), warm,
                             n)
    mean = sum(ms) / len(ms)
    busy, idle, ops = step_profile(torch, lambda: trainer.train_step(batch),
                                   mean, n=2)
    kept = [round(float(m.kept_fraction), 4) for m in model.modules()
            if type(m).__name__ == "SwitchFFN"]
    log(f"{tag} {n} Adam steps: losses {[round(x, 6) for x in losses]}; ms "
        f"per step {[round(x, 3) for x in ms]}, mean {mean:.3f} ms, "
        f"{per_example / (mean / 1e3):.1f} {unit}/s; device busy "
        f"{busy:.3f} ms per step, idle share {idle:.3f}, {ops:.0f} device "
        f"ops per step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"kept_fraction per layer {kept}")
    if not (all(math.isfinite(x) for x in losses)
            and (not counted or losses[-1] < losses[0])):
        raise SystemExit(f"{tag} training losses not finite and falling: "
                         f"{losses}")
    return per_step


def bert_moe_batch(torch, cfg, b):
    """bench_bert_moe's make_batch (numpy seed 0): ids, MLM labels (15%
    random ids, the rest -100), NSP labels."""
    import numpy as np

    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (b, BERT_MOE_T))
    mlm = np.where(rng.random((b, BERT_MOE_T)) < 0.15,
                   rng.integers(0, cfg.vocab_size, (b, BERT_MOE_T)), -100)
    nsp = rng.integers(0, 2, (b,))
    return tuple(torch.as_tensor(a, device="cuda") for a in (ids, mlm, nsp))


def phase_train_bert_moe(torch, FK):
    """bench_bert_moe at full width: check steps at B=16, one counted
    step (12/12/12 float32 flash launches), 5 timed steps; B=32
    reported."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import bert

    tag = "[train:bert_moe]"
    ptt.seed(0)
    cfg = bert.BertConfig.base()
    cfg.dropout, cfg.moe_experts = 0.0, MOE_EXPERTS
    model = bert.BertForPretraining(cfg, device="cuda")
    ffn = model.bert.encoder.layers[0].ffn
    log(f"{tag} BertConfig.base(), dropout 0, {MOE_EXPERTS} experts top-1, "
        f"capacity factor {ffn.capacity_factor} (capacity "
        f"{ffn.capacity(BERT_MOE_B * BERT_MOE_T)} of "
        f"{BERT_MOE_B * BERT_MOE_T} tokens), "
        f"{sum(p.numel() for p in model.parameters())} float32 parameters; "
        f"batch ({BERT_MOE_B}, {BERT_MOE_T}); policy {MOE_POLICY}; loss + "
        f"{MOE_AUX} x the aux losses")
    batch = bert_moe_batch(torch, cfg, BERT_MOE_B)

    def loss_of(m, b=batch):
        return m.forward_fused_loss(*b) + moe_aux(m)

    mhas = [layer.self_attn for layer in model.bert.encoder.layers]
    moe_check_steps(torch, FK, tag, model, mhas, loss_of)
    per_step = moe_train_cell(torch, FK, tag, model, batch, loss_of,
                              BERT_MOE_B, "examples", cfg.num_layers)
    big = bert_moe_batch(torch, cfg, BERT_MOE_BIG_B)
    moe_train_cell(torch, FK, f"{tag} B={BERT_MOE_BIG_B}", model, big,
                   loss_of, BERT_MOE_BIG_B, "examples", cfg.num_layers,
                   warm=1, n=3, counted=False)
    del model, batch, big
    torch.cuda.empty_cache()
    return per_step


def phase_train_gpt_moe(torch, FK):
    """GPTConfig.small() with 8 experts at bench_gpt's (8, 1024): MoE
    with remat raises the typed error; check steps at B=4; one counted
    step (12/12/12 float32 flash launches); 5 timed steps."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core import InvalidArgumentError
    from paddle_tpu_torch.models import gpt

    tag = "[train:gpt_moe]"
    cfg = gpt.GPTConfig.small()
    cfg.max_position, cfg.moe_experts, cfg.remat = TT, MOE_EXPERTS, True
    try:
        gpt.GPTForCausalLM(cfg, device="cuda")
    except InvalidArgumentError as e:
        log(f"{tag} moe_experts with remat=True raises "
            f"InvalidArgumentError: {e}")
    else:
        raise SystemExit(f"{tag} moe_experts with remat=True did not raise")
    cfg.remat = False
    ptt.seed(0)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    ffn = model.blocks[0].ffn
    s = TB * TT
    log(f"{tag} GPTConfig.small(), {MOE_EXPERTS} experts top-1, capacity "
        f"factor {ffn.capacity_factor}, no remat, "
        f"{sum(p.numel() for p in model.parameters())} float32 parameters; "
        f"batch ({TB}, {TT}): {s} tokens a layer, capacity "
        f"{ffn.capacity(s)}, dispatch/combine tensors ({s}, {MOE_EXPERTS}, "
        f"{ffn.capacity(s)}); policy {MOE_POLICY}; loss + {MOE_AUX} x the "
        f"aux losses; check steps at B={GPT_MOE_CHECK_B}")
    ids = torch.randint(0, cfg.vocab_size, (TB, TT),
                        generator=torch.Generator().manual_seed(6)).cuda()

    def loss_of(m, b=ids[:GPT_MOE_CHECK_B]):
        return m.forward_loss(b) + moe_aux(m)

    mhas = [blk.self_attn for blk in model.blocks]
    moe_check_steps(torch, FK, tag, model, mhas, loss_of)
    per_step = moe_train_cell(torch, FK, tag, model, ids, loss_of, s,
                              "tokens", cfg.num_layers)
    del model, ids
    torch.cuda.empty_cache()
    return per_step


@contextlib.contextmanager
def arena_trace(torch, events):
    """Each Switch FFN call of the block appends ("route", each token's
    expert, the gap between its two largest router probabilities, the
    call's tokens, its kept fraction) to ``events``, on the host."""
    from paddle_tpu_torch.nn import moe

    orig = moe.switch_moe

    def traced(x, router_w, *a, **kw):
        out = orig(x, router_w, *a, **kw)
        _, probs, top_i = moe._route(x, router_w, 1)
        top2 = torch.topk(probs, 2, dim=-1).values
        events.append(("route", top_i[:, 0].cpu(),
                       (top2[:, 0] - top2[:, 1]).cpu(), x.shape[0],
                       float(out[3])))
        return out

    moe.switch_moe = traced
    try:
        yield
    finally:
        moe.switch_moe = orig


def recorded_arena(torch, model, prompts, kw, events):
    """Serve ``prompts`` through BatchedDecoder(slots=8, capacity=CAP) on
    the model's device, appending each Switch FFN call (arena_trace) and
    each emitted token's ("pick", request, index, logit row, token) to
    ``events`` in order. Returns the outputs."""
    from paddle_tpu_torch.serving import BatchedDecoder

    class Recorder(BatchedDecoder):
        _admitting = None

        def _activate(self, s, r, logits, plen):
            self._admitting = s
            super()._activate(s, r, logits, plen)

        def _pick(self, logits, gens, poss, salt=0):
            out = super()._pick(logits, gens, poss, salt)
            if self._admitting is not None:    # one row: the new slot
                pairs, self._admitting = [(0, self._admitting)], None
            else:                              # a tick: row = slot
                pairs = [(s, s) for s in range(self.slots) if self.active[s]]
            rows, toks, pos = logits.float().cpu(), out.cpu(), poss.cpu()
            for row, s in pairs:
                r = self.owner[s]
                events.append(("pick", r.rid, int(pos[row]) - len(r.prompt),
                               rows[row], int(toks[row])))
            return out

    dec = Recorder(model, slots=8, capacity=CAP, device=model.device, **kw)
    rids = [dec.submit(p, 32) for p in prompts]
    with torch.inference_mode(), arena_trace(torch, events):
        outs = dec.run()
    return [outs[r] for r in rids]


def compare_arenas(cpu, card):
    """Walk the two runs' events while they agree: every logit row within
    MOE_SERVE_TOL of the CPU's, until the first routing flip (a token
    whose expert differs: its CPU router-probability gap must be below
    MOE_FLIP_GAP, a near tie) or the first differing token (its two
    candidates' CPU logits within 2 x MOE_SERVE_TOL: a near tie).
    Returns (rows compared, their worst distance, what ended the walk)."""
    rows, worst = 0, 0.0
    for i, (a, b) in enumerate(zip(cpu, card)):
        if a[0] != b[0] or (a[0] == "pick" and a[1:3] != b[1:3]):
            raise SystemExit(f"[serve:moe] the runs' events differ at {i}: "
                             f"{a[:3]} against {b[:3]}")
        if a[0] == "route":
            flipped = a[1] != b[1]
            if bool(flipped.any()):
                gap = float(a[2][flipped].max())
                if gap > MOE_FLIP_GAP:
                    raise SystemExit(f"[serve:moe] a routing flip at a "
                                     f"router-probability gap {gap:.3e}")
                return rows, worst, (f"a routing flip at event {i} "
                                     f"({int(flipped.sum())} tokens, "
                                     f"largest router-probability gap "
                                     f"{gap:.3e}: a near tie)")
            continue
        d = float((a[3] - b[3]).abs().max())
        worst, rows = max(worst, d), rows + 1
        if d > MOE_SERVE_TOL:
            raise SystemExit(f"[serve:moe] request {a[1]} token {a[2]}: "
                             f"logits {d:.3e} from the CPU run's")
        if a[4] != b[4]:
            gap = float(abs(a[3][a[4]] - a[3][b[4]]))
            return rows, worst, (f"request {a[1]} token {a[2]} at event {i} "
                                 f"(the CPU's logits of the two tokens "
                                 f"{gap:.3e} apart: a near tie)")
    return rows, worst, "none: every event agrees"


def phase_serve_moe(torch, K, prompts):
    """The gpt-moe model (seed 0, float32) served contiguous and paged:
    each arena's decode kernel launches at least layers x ticks, no
    other decode kernel; tokens/s and ms per tick from that run; then the
    same arena recorded on the card and on the CPU (the same weights,
    prompts, slots and admission order), compared by compare_arenas; the
    share of identical tokens and each differing request's first
    difference reported; kept_fraction per decode tick."""
    import copy

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import gpt

    ptt.seed(0)
    cfg = gpt.GPTConfig.small()
    cfg.moe_experts = MOE_EXPERTS
    model = gpt.GPTForCausalLM(cfg, device="cuda").eval()
    cpu_model = copy.deepcopy(model).cpu()
    layers = cfg.num_layers
    ffn = model.blocks[0].ffn
    log(f"[serve:moe] GPTConfig.small() with {MOE_EXPERTS} experts, "
        f"capacity factor {ffn.capacity_factor} (a decode tick routes 8 "
        f"slots' tokens at capacity {ffn.capacity(8)}), float32, "
        f"{sum(p.numel() for p in model.parameters())} parameters; "
        f"{len(prompts)} requests, max_new 32, 8 slots")
    for mode, kw in (("contiguous", {}),
                     ("paged", dict(pages=B * 32 + 8, page_size=PS))):
        tag = f"[serve:moe:{mode}]"
        run = serve(torch, K, model, prompts, **kw)
        check_launches(tag, run["launches"],
                       {mode_kernel(kw): layers * run["dec"].tick_count})
        log(f"{tag} {run_line(run)}; launches {run['launches']}")
        ev_card, ev_cpu = [], []
        card = recorded_arena(torch, model, prompts, kw, ev_card)
        t0 = time.perf_counter()
        host = recorded_arena(torch, cpu_model, prompts, kw, ev_cpu)
        cpu_s = time.perf_counter() - t0
        same_run = all(bool((a == b).all())
                       for a, b in zip(card, run["outs"]))
        rows, worst, end = compare_arenas(ev_cpu, ev_card)
        same = sum(int((a == b).sum()) for a, b in zip(card, host))
        total = sum(len(o) for o in card)
        firsts = []
        for rid, (a, b) in enumerate(zip(card, host)):
            diff = (a != b).nonzero()[0]
            if len(diff):
                firsts.append(f"{rid}@{int(diff[0])}")
        ticks = [e[4] for e in ev_card if e[0] == "route" and e[3] == 8]
        log(f"{tag} against the CPU run of the same arena ({cpu_s:.1f} s): "
            f"{rows} logit rows compared before the first divergence, "
            f"worst {worst:.3e} (limit {MOE_SERVE_TOL}); first divergence: "
            f"{end}; identical tokens {same}/{total} "
            f"({same / total:.3f}); requests differing (request@first "
            f"token) {firsts or 'none'}; the recorded card run equals the "
            f"counted one: {same_run}; kept_fraction over {len(ticks)} "
            f"decode-tick calls: mean {sum(ticks) / len(ticks):.4f}, min "
            f"{min(ticks):.4f}, {sum(k < 1 for k in ticks)} calls dropped "
            f"tokens")
        del run
    del model, cpu_model
    torch.cuda.empty_cache()


def zoo_model(name, fmt, device, generator):
    """(module, model) of a zoo cell at 1000 classes."""
    from paddle_tpu_torch.models import alexnet, googlenet, se_resnext, vgg

    kw = dict(device=device, generator=generator)
    if name == "vgg16":
        return vgg, vgg.vgg16(1000, **kw)
    if name == "alexnet":
        return alexnet, alexnet.alexnet(1000, **kw)
    if name == "googlenet":
        return googlenet, googlenet.googlenet(1000, **kw)
    return se_resnext, se_resnext.se_resnext50(1000, data_format=fmt, **kw)


def loss_and_grads(torch, loss_of, model):
    """Train-mode loss and every gradient, as float64 CPU tensors."""
    model.train()
    loss = loss_of(model)
    loss.backward()
    return float(loss.detach()), {
        n: (torch.zeros_like(p) if p.grad is None else p.grad).detach()
        .double().cpu() for n, p in model.named_parameters()}


def card_against_cpu(torch, tag, cpu_model, loss_of, inputs):
    """A check step by the ResNet-50 phase's rule: ``cpu_model`` copied
    to the card and to the CPU in float64 (gated: loss CHECK_TOL[0], each
    grad within CHECK_TOL[1] of its parameter's largest CPU entry) and
    float32 (reported), ``loss_of(model, *inputs)`` on each."""
    import copy

    from paddle_tpu_torch.core.dtypes import Policy, policy_scope

    tol_loss, tol_grad = CHECK_TOL
    f64 = Policy("float64", "float64", "float64")
    runs = {}
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(cpu_model).to(dev, dt)
            args = [a.to(dev, dt) if a.is_floating_point() else a.to(dev)
                    for a in inputs]
            with policy_scope(f64 if dtype == "float64" else "float32"):
                runs[dtype, dev] = loss_and_grads(
                    torch, lambda m: loss_of(m, *args), model)
            del model
    lines, ok = [], True
    for dtype in ("float64", "float32"):
        got, want = runs[dtype, "cuda"], runs[dtype, "cpu"]
        dloss = abs(got[0] - want[0])
        d = rel_distance(got[1], want[1])
        worst = max(d, key=d.get)
        good = dloss <= tol_loss and d[worst] <= tol_grad
        if dtype == "float64":
            ok = good
        lines.append(f"{dtype}: loss {got[0]:.6f} vs {want[0]:.6f} (|diff| "
                     f"{dloss:.3e}), worst grad {worst} {d[worst]:.3e} of "
                     f"its largest CPU entry "
                     + (f"(limits {tol_loss}, {tol_grad}) "
                        f"{'ok' if good else 'FAIL'}" if dtype == "float64"
                        else "(reported)"))
    log(f"{tag} check step, card against CPU: " + "; ".join(lines))
    if not ok:
        raise SystemExit(f"{tag} float64 check step failed")


def all_counts(FK, K, QM):
    """Launches per hand kernel: flash, decode and the int8 product."""
    return dict(flash_counts(FK), **decode_counts(K),
                quant_matmul=QM.quant_matmul.launches,
                quant_linear=QM.quant_linear.launches)


def all_launches(FK, K, QM):
    return sum(all_counts(FK, K, QM).values())


def phase_train_zoo(torch, FK, K, QM):
    """bench.py's zoo cells: each model's check step at B=2, 224 px
    (dropout at 0: the two devices' generators draw different masks),
    then b64/256/128/64 under ZOO_POLICY, 2 warm-up and 5 timed steps,
    all-zero labels (se_resnext50 NHWC, and an NCHW point); no hand
    kernel launches."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.parallel import Trainer

    n0 = all_launches(FK, K, QM)
    for name, b, fmt in ZOO_CELLS:
        tag = f"[train:zoo:{name}]"
        gen = torch.Generator().manual_seed(30)
        mod, cpu = zoo_model(name, fmt, "cpu", gen)
        for m in cpu.modules():
            if type(m).__name__ == "Dropout":
                m.p = 0.0
        x = torch.randn(2, 3, 224, 224, generator=gen)
        y = torch.randint(0, 1000, (2,), generator=gen)
        t0 = time.perf_counter()
        card_against_cpu(torch, f"{tag} {fmt} B=2 224 px", cpu,
                         lambda m, x, y: mod.loss_fn(m(x), y), [x, y])
        log(f"{tag} check step seconds {time.perf_counter() - t0:.1f}")
        del cpu
        for layout, warm, n in ((fmt, 2, 5),) + (
                (("NCHW", 1, 3),) if fmt == "NHWC" else ()):
            gen = torch.Generator(device="cuda").manual_seed(31)
            _, model = zoo_model(name, layout, "cuda", gen)
            tr = Trainer.supervised(model, TO.Adam(1e-3), mod.loss_fn,
                                    amp=ZOO_POLICY)
            batch = {"x": torch.randn(b, 3, 224, 224, generator=gen,
                                      device="cuda"),
                     "label": torch.zeros(b, dtype=torch.long,
                                          device="cuda")}
            torch.cuda.reset_peak_memory_stats()
            losses, ms = timed_steps(torch, lambda: tr.train_step(batch),
                                     warm, n)
            mean = sum(ms) / len(ms)
            log(f"{tag} {layout} b{b} 224 px {ZOO_POLICY} Adam(1e-3), "
                f"all-zero labels: losses {[round(v, 6) for v in losses]}; "
                f"ms per timed step {[round(v, 3) for v in ms]}, mean "
                f"{mean:.3f} ms, {b / (mean / 1e3):.1f} images/s; peak "
                f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                f"GiB")
            if not finite_and_falling(losses):
                raise SystemExit(f"{tag} losses not finite and falling")
            del tr, model, batch
            torch.cuda.empty_cache()
    launched = all_launches(FK, K, QM) - n0
    log(f"[train:zoo] hand-kernel launches over the zoo: {launched} "
        f"(want 0)")
    if launched:
        raise SystemExit("[train:zoo] a hand kernel launched on the zoo")


def lstm_batch(torch, b, device, seed=0):
    """bench_stacked_lstm's make_batch (numpy ``seed``): ids, lengths in
    [T/2, T], labels ids[:, 0] % 2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, LSTM_VOCAB, (b, LSTM_T)),
                          device=device)
    lengths = torch.as_tensor(rng.integers(LSTM_T // 2, LSTM_T + 1, (b,)),
                              device=device)
    return ids, lengths, ids[:, 0] % 2


def phase_train_stacked_lstm(torch, FK, K, QM):
    """bench model 6 at full width: the float64 check step at B=4 (padded
    rows), then B=64 and B=512 under LSTM_POLICY, 2 warm-up and 5 timed
    steps, with the device's idle share and ops per step."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models import stacked_lstm as SL
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train:stacked_lstm]"
    n0 = all_launches(FK, K, QM)
    gen = torch.Generator().manual_seed(32)
    cpu = SL.StackedLSTM(LSTM_VOCAB, LSTM_WIDTH, LSTM_WIDTH, LSTM_LAYERS,
                         device="cpu", generator=gen)
    ids, lengths, label = lstm_batch(torch, LSTM_CHECK_B, "cpu", seed=1)
    log(f"{tag} vocab {LSTM_VOCAB}, embed and hidden {LSTM_WIDTH}, "
        f"{LSTM_LAYERS} layers, T={LSTM_T}; check step lengths "
        f"{lengths.tolist()}")
    if not bool((lengths < LSTM_T).any()):
        raise SystemExit(f"{tag} the check batch has no padded row")
    card_against_cpu(torch, f"{tag} B={LSTM_CHECK_B}", cpu,
                     lambda m, i, n, y: SL.loss_fn(m(i, n), y),
                     [ids, lengths, label])
    del cpu
    for b in LSTM_BATCHES:
        ptt.seed(0)
        model = SL.StackedLSTM(LSTM_VOCAB, LSTM_WIDTH, LSTM_WIDTH,
                               LSTM_LAYERS, device="cuda")
        batch = lstm_batch(torch, b, "cuda")
        tr = Trainer(model, TO.Adam(1e-3),
                     lambda m, bt, g: (SL.loss_fn(m(bt[0], bt[1]), bt[2]),
                                       {}), amp=LSTM_POLICY)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(torch, lambda: tr.train_step(batch), 2, 5)
        mean = sum(ms) / len(ms)
        busy, idle, ops = step_profile(torch, lambda: tr.train_step(batch),
                                       mean, n=2)
        log(f"{tag} B={b} {LSTM_POLICY} Adam(1e-3): losses "
            f"{[round(v, 6) for v in losses]}; ms per timed step "
            f"{[round(v, 3) for v in ms]}, mean {mean:.3f} ms, "
            f"{b / (mean / 1e3):.1f} examples/s; device busy {busy:.3f} ms "
            f"per step, idle share {idle:.3f} (host-paced by "
            f"{mean / max(busy, 1e-9):.1f}x), {ops:.0f} device ops per step; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
            f"GiB")
        if not finite_and_falling(losses):
            raise SystemExit(f"{tag} B={b}: losses not finite and falling")
        del tr, model, batch
        torch.cuda.empty_cache()
    if all_launches(FK, K, QM) != n0:
        raise SystemExit(f"{tag} a hand kernel launched on the LSTM")


def rec_batch(torch, b, device, seed=0):
    """A MovieLens-1M-shaped batch from numpy ``seed``: user, gender, age,
    job and movie ids over REC_FIELDS, 3 category ids a row (0, the pad,
    is a real category and is summed), ratings uniform in [1, 5]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = (b,) * 5 + ((b, 3),)
    feats = [torch.as_tensor(rng.integers(0, n, shape), device=device)
             for n, shape in zip(REC_FIELDS, shapes)]
    rating = torch.as_tensor(rng.uniform(1.0, 5.0, b).astype(np.float32),
                             device=device)
    return feats, rating


def phase_train_recommender(torch, FK, K, QM):
    """The recommender at MovieLens-1M's widths: the float64 check step at
    B=4, then B=256 and B=8192 in float32, Adam(5e-3), 20 steps each,
    with |pred| <= 5, the device's idle share and ops per step."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models import recommender as RM
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train:recommender]"
    n0 = all_launches(FK, K, QM)
    cpu = RM.RecommenderNet(device="cpu",
                            generator=torch.Generator().manual_seed(40))
    log(f"{tag} RecommenderNet() at MovieLens-1M widths {REC_FIELDS}, "
        f"embed 32, fc 200: {sum(p.numel() for p in cpu.parameters())} "
        f"parameters")
    feats, rating = rec_batch(torch, REC_CHECK_B, "cpu", seed=1)
    card_against_cpu(torch, f"{tag} B={REC_CHECK_B}", cpu,
                     lambda m, *a: RM.loss_fn(m(*a[:6]), a[6]),
                     feats + [rating])
    del cpu
    for b in REC_BATCHES:
        ptt.seed(0)
        model = RM.RecommenderNet(device="cuda")
        batch = rec_batch(torch, b, "cuda")
        tr = Trainer(model, TO.Adam(5e-3),
                     lambda m, bt, g: (RM.loss_fn(m(*bt[0]), bt[1]), {}))
        losses, ms = timed_steps(torch, lambda: tr.train_step(batch), 2,
                                 REC_STEPS - 2)
        mean = sum(ms) / len(ms)
        busy, idle, ops = step_profile(torch, lambda: tr.train_step(batch),
                                       mean, n=2)
        with torch.no_grad():
            top = float(model(*batch[0]).abs().max())
        log(f"{tag} B={b} float32 Adam(5e-3), {REC_STEPS} steps: losses "
            f"{[round(v, 6) for v in losses]}; ms per timed step "
            f"{[round(v, 3) for v in ms]}, mean {mean:.3f} ms, "
            f"{b / (mean / 1e3):.1f} samples/s; device busy {busy:.3f} ms "
            f"per step, idle share {idle:.3f} (host-paced by "
            f"{mean / max(busy, 1e-9):.1f}x), {ops:.0f} device ops per "
            f"step; max |pred| after training {top:.6f}")
        if not finite_and_falling(losses):
            raise SystemExit(f"{tag} B={b}: losses not finite and falling")
        if not top <= 5.0 * (1 + 1e-6):
            raise SystemExit(f"{tag} B={b}: a prediction beyond 5")
        del tr, model, batch
        torch.cuda.empty_cache()
    if all_launches(FK, K, QM) != n0:
        raise SystemExit(f"{tag} a hand kernel launched on the recommender")


def lora_step_run(torch, FK, trainer, ids, n):
    """One counted step (the flash launches of a step), then ``n`` timed
    steps with peak memory. Returns (launches of the counted step, the
    n + 1 losses, the timed ms, peak GiB)."""
    torch.cuda.synchronize()
    reset_flash_counts(FK)
    first, _ = trainer.train_step(ids)
    torch.cuda.synchronize()
    per_step = flash_counts(FK)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(torch, lambda: trainer.train_step(ids), 0, n)
    return (per_step, [float(first)] + losses, ms,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_train_lora(torch, FK, K, QM, prompts):
    """LoRA fine-tuning at bench_gpt's shape against the full-parameter
    step of the same model, then merge_lora: logits against a float64
    CPU forward, and the merged model served paged (see the module
    docstring, phase 27)."""
    import copy

    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.dtypes import Policy, policy_scope
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train:lora]"
    cfg = gpt.GPTConfig.small()
    cfg.max_position, cfg.remat = TT, True
    ids = torch.randint(0, cfg.vocab_size, (TB, TT),
                        generator=torch.Generator().manual_seed(6)).to("cuda")

    def model_of_seed_5():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        return gpt.GPTForCausalLM(cfg, generator=gen)

    def builder(m, batch, g):
        return m.forward_loss(batch), {}

    # the full-parameter step at the same shape, for the launches, ms and
    # memory to hold the LoRA step against
    model = model_of_seed_5()
    tr = Trainer(model, TO.Adam(5e-3), builder, amp=LORA_POLICY)
    full_step, full_losses, full_ms, full_peak = lora_step_run(
        torch, FK, tr, ids, 5)
    del tr, model
    torch.cuda.empty_cache()

    model = model_of_seed_5()
    paths = tnn.apply_lora(model, r=LORA_RANK, alpha=LORA_ALPHA,
                           targets=LORA_TARGETS)
    lora = tnn.lora_parameters(model)
    for name, p in model.named_parameters():
        p.requires_grad_(name in lora)
    frozen = {k: v.detach().clone() for k, v in model.state_dict().items()
              if k not in lora}
    n_frozen = sum(v.numel() for v in frozen.values())
    n_lora = sum(p.numel() for p in lora.values())
    log(f"{tag} GPTConfig.small() remat, ({TB}, {TT}), {LORA_POLICY}: "
        f"apply_lora(r={LORA_RANK}, alpha={LORA_ALPHA}, "
        f"targets={LORA_TARGETS}) wrapped {len(paths)} projections; "
        f"{n_lora} adapter values train, {n_frozen} frozen")
    tr = Trainer(model, TO.Adam(5e-3), builder, amp=LORA_POLICY)
    per_step, losses, ms, peak = lora_step_run(torch, FK, tr, ids,
                                               LORA_STEPS - 1)
    mean, full_mean = sum(ms) / len(ms), sum(full_ms) / len(full_ms)
    log(f"{tag} launches in one step: LoRA {per_step}, full-parameter "
        f"{full_step}")
    log(f"{tag} {LORA_STEPS} Adam(5e-3) steps on the adapters: losses "
        f"{[round(v, 6) for v in losses]}; ms per timed step "
        f"{[round(v, 3) for v in ms]}, mean {mean:.3f} ms "
        f"({TB * TT / (mean / 1e3):.1f} tokens/s), peak memory "
        f"{peak:.2f} GiB; the full-parameter step: mean {full_mean:.3f} ms, "
        f"peak memory {full_peak:.2f} GiB, losses "
        f"{[round(v, 6) for v in full_losses]}")
    moved = max(float(p.detach().abs().max()) for k, p in lora.items()
                if k.endswith("lora_b"))
    changed = [k for k, v in model.state_dict().items()
               if k in frozen and not torch.equal(v, frozen[k])]
    graded = [n for n, p in model.named_parameters()
              if n not in lora and p.grad is not None]
    slots = tr.opt_state["leaf"]
    log(f"{tag} frozen weights changed: {len(changed)}; frozen weights "
        f"with a grad: {len(graded)}; optimizer slots {len(slots)} for "
        f"{len(lora)} adapters; largest |lora_b| {moved:.3e}")
    if per_step != full_step or min(per_step.values()) == 0:
        raise SystemExit(f"{tag} a LoRA step launched the flash kernels "
                         f"another number of times than the full step")
    if changed or graded or set(tr.params) != set(lora) or len(slots) != \
            len(lora):
        raise SystemExit(f"{tag} a frozen weight moved, took a grad or "
                         f"holds optimizer state")
    if not (moved > 0 and finite_and_falling(losses)):
        raise SystemExit(f"{tag} the adapters did not train")
    del tr, frozen
    torch.cuda.empty_cache()

    # merge_lora: the merged logits against the adapted ones, each held
    # to a float64 CPU forward of the adapted model
    model.eval()
    x = ids[:2, :128]
    f64 = Policy("float64", "float64", "float64")
    with torch.no_grad():
        adapted = model(x).float()
        ref_model = copy.deepcopy(model).to("cpu", torch.float64)
        with policy_scope(f64):
            ref = ref_model(x.cpu()).to("cuda")
        del ref_model
        merged = tnn.merge_lora(model)
        got = model(x).float()
    d_adapt = (adapted.double() - ref).abs().max().item()
    d_merge = (got.double() - ref).abs().max().item()
    d = (got - adapted).abs().max().item()
    bound = 2 * d_adapt + 2e-5
    log(f"{tag} merge_lora folded {len(merged)} adapters; logits of 2 x "
        f"128 tokens: merged against adapted {d:.3e}, adapted against "
        f"float64 CPU {d_adapt:.3e}, merged against float64 CPU "
        f"{d_merge:.3e} (bound 2 x {d_adapt:.3e} + 2e-5 = {bound:.3e})")
    if not (len(merged) == len(paths) and d <= bound and d_merge <= bound):
        raise SystemExit(f"{tag} the merged model's logits are off")
    serve_merged(torch, FK, K, QM, model, prompts[:8], tag)
    del model
    torch.cuda.empty_cache()


def serve_merged(torch, FK, K, QM, model, prompts, tag,
                 what="merged model"):
    """The merged model served paged: every counter at 0 just before
    run(), the paged kernel exactly layers x (ticks + admissions), no
    other kernel; tokens held to the teacher-forced check. Returns
    tokens/s and ms per tick."""
    from paddle_tpu_torch.serving import BatchedDecoder

    dec = BatchedDecoder(model, slots=8, capacity=CAP, device=model.device,
                         pages=B * 32 + 8, page_size=PS)
    dec.warm_step()
    rids = [dec.submit(p, 32) for p in prompts]
    torch.cuda.synchronize()
    for name in KERNEL_ROWS:
        getattr(K, name).launches = 0
    reset_flash_counts(FK)
    QM.quant_matmul.launches = QM.quant_linear.launches = 0
    t0 = time.perf_counter()
    outs = dec.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decode_counts(K)
    others = dict(flash_counts(FK), quant_matmul=QM.quant_matmul.launches,
                  quant_linear=QM.quant_linear.launches)
    outs = [outs[r] for r in rids]
    want = model.cfg.num_layers * (dec.tick_count + len(rids))
    gap = teacher_forced_check(torch, model, prompts, outs)
    toks = sum(len(o) for o in outs)
    log(f"{tag} {what} served {len(outs)} requests paged: {toks} "
        f"tokens in {wall:.3f} s ({toks / wall:.1f} tokens/s), "
        f"{dec.tick_count} ticks; launches {launches}, other kernels "
        f"{others} (want decode_attention_paged = {model.cfg.num_layers} x "
        f"({dec.tick_count} ticks + {len(rids)} admissions) = {want}, the "
        f"rest 0); teacher-forced worst gap {gap:.2e}")
    if launches["decode_attention_paged"] != want or any(
            n for k, n in launches.items() if k != "decode_attention_paged") \
            or any(others.values()):
        raise SystemExit(f"{tag} serving the {what} launched another "
                         f"kernel or another number of times")
    return toks / wall, 1e3 * dec.tick_seconds / dec.tick_count


def w2v_model(torch, device, generator=None):
    """The word2vec book model: the mean of the context embeddings into
    NCE(log_uniform, W2V_NEG negatives); forward -> the mean cost."""
    from paddle_tpu_torch import nn as tnn

    class W2V(tnn.Layer):
        def __init__(self):
            super().__init__()
            kw = dict(device=device, generator=generator)
            self.emb = tnn.Embedding(W2V_VOCAB, W2V_EMBED, **kw)
            self.nce = tnn.NCE(W2V_EMBED, W2V_VOCAB, num_neg_samples=W2V_NEG,
                               sampler="log_uniform", **kw)

        def forward(self, context, target, custom_neg=None):
            h = torch.mean(self.emb(context), dim=1)
            return torch.mean(self.nce(h, target, custom_neg=custom_neg))

    return W2V()


def w2v_batch(torch, b, device, seed=0):
    """Context ids uniform over the vocabulary (numpy ``seed``), the
    target their sum mod the vocabulary (the book test's corpus)."""
    import numpy as np

    ctx = np.random.default_rng(seed).integers(0, W2V_VOCAB, (b, W2V_CTX))
    return (torch.as_tensor(ctx, device=device),
            torch.as_tensor(ctx.sum(1) % W2V_VOCAB, device=device))


def phase_train_word2vec(torch, FK, K, QM):
    """word2vec with NCE at PTB's vocabulary: the exact check step
    (custom_neg), then 20 keyed steps at B=4096."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train:word2vec]"
    n0 = all_launches(FK, K, QM)
    cpu = w2v_model(torch, "cpu", torch.Generator().manual_seed(41))
    ctx, tgt = w2v_batch(torch, W2V_CHECK_B, "cpu", seed=1)
    neg = torch.as_tensor(np.random.default_rng(2).integers(
        0, W2V_VOCAB, (W2V_CHECK_B, W2V_NEG)))
    log(f"{tag} vocabulary {W2V_VOCAB}, embed {W2V_EMBED}, context "
        f"{W2V_CTX}, NCE(log_uniform, {W2V_NEG} negatives)")
    card_against_cpu(torch, f"{tag} B={W2V_CHECK_B} custom_neg", cpu,
                     lambda m, c, t, n: m(c, t, custom_neg=n),
                     [ctx, tgt, neg])
    del cpu
    ptt.seed(0)
    model = w2v_model(torch, "cuda")
    batch = w2v_batch(torch, W2V_BATCH, "cuda")
    tr = Trainer(model, TO.Adam(5e-2), lambda m, bt, g: (m(*bt), {}))
    losses, ms = timed_steps(torch, lambda: tr.train_step(batch), 2,
                             W2V_STEPS - 2)
    mean = sum(ms) / len(ms)
    log(f"{tag} B={W2V_BATCH} float32 Adam(5e-2), {W2V_STEPS} steps with "
        f"keyed negatives: losses {[round(v, 6) for v in losses]}; ms per "
        f"timed step {[round(v, 3) for v in ms]}, mean {mean:.3f} ms, "
        f"{W2V_BATCH / (mean / 1e3):.1f} samples/s")
    if not finite_and_falling(losses):
        raise SystemExit(f"{tag} losses not finite and falling")
    if all_launches(FK, K, QM) != n0:
        raise SystemExit(f"{tag} a hand kernel launched on word2vec")
    del tr, model, batch
    torch.cuda.empty_cache()


def kink_grads(x):
    """The gradient of each clipped or kinked op at the points ``x``
    (0, the clip bounds), where JAX splits a tie and abs has derivative
    +1 at 0."""
    import torch

    from paddle_tpu_torch import ops as O

    fns = (O.abs, O.relu6, O.brelu, O.hard_sigmoid, O.soft_relu,
           O.math.celu, O.math.hard_silu, O.math.sparse_sigmoid,
           lambda v: O.clip(v, -1.0, 1.0), O.l1_norm,
           lambda v: O.sigmoid_cross_entropy_with_logits(v, v * 0 + 0.3),
           lambda v: O.hinge_loss(v, (v > 0).to(v.dtype)),
           lambda v: O.loss.teacher_student_sigmoid_loss(v, v * 0 + 0.5))
    out = []
    for fn in fns:
        v = x.clone().requires_grad_(True)
        out.append(torch.autograd.grad(fn(v).sum(), v)[0])
    return tuple(out)


def ops_library_cases(torch):
    """The [ops:library] checks at small shapes from numpy seed 7: the
    indexing and search family as (name, fn, CPU inputs), run on the card
    under sync debug "error" on inputs moved there beforehand; the other
    families as (family, name, fn), ``fn(dev)`` the call on inputs moved
    by ``dev`` (``dev.device`` for the creation ops)."""
    import numpy as np

    from paddle_tpu_torch import metrics as MT
    from paddle_tpu_torch import ops as O

    rng = np.random.default_rng(7)

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    def i64(*vals):
        return torch.tensor(vals)

    x53, lens = f32(5, 3), i64(6, 3, 0, 4)
    ties = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0],
                         [0.0, 0.0, 5.0, 5.0, 0.0, -1.0]])
    tags = torch.as_tensor(rng.integers(0, 5, (3, 8)))
    tags2 = torch.where(torch.as_tensor(rng.random((3, 8)) < 0.7), tags,
                        torch.as_tensor(rng.integers(0, 5, (3, 8))))
    key = np.array([0, 11], np.uint32)
    seq = f32(4, 6, 2)
    gnd, upd4, upd43 = f32(3, 4, 2), f32(4), f32(4, 3)
    mx = [f32(4, 2), f32(4, 2), f32(4, 2)]
    idx_family = [
        ("gather out of range", O.gather, [x53, i64(0, 5, -1, -6)]),
        ("gather_nd out of range", O.gather_nd,
         [gnd, i64(3, 1, -1, 4, 7, -9).reshape(3, 2)]),
        ("scatter out of range", O.scatter,
         [x53, i64(1, 7, -1, -9), upd43]),
        ("scatter add duplicates",
         lambda x, i, u: O.scatter(x, i, u, overwrite=False),
         [x53, i64(1, 1, -1, 9), upd43]),
        ("scatter_nd_add out of range", O.scatter_nd_add,
         [seq[0], i64(0, 1, 3, 1, 9, 0, -1, 2).reshape(4, 2), upd4]),
        ("multiplex out of range",
         lambda i, a, b, c: O.multiplex(i, [a, b, c]),
         [i64(5, -1, -4, 1).reshape(4, 1)] + mx),
        ("top_k ties", lambda t: O.top_k(t, 4), [ties]),
        ("argsort ties descending",
         lambda t: O.argsort(t, descending=True), [ties]),
        ("argsort ties", O.argsort, [ties]),
        # the repaired faults: out-of-range labels and lengths (JAX's
        # NaN fill and clamp), saturating casts, gradients at kinks
        ("cross_entropy labels out of range", O.cross_entropy,
         [torch.softmax(f32(5, 4), -1), i64(0, 4, -1, -5, 2)]),
        ("bpr_loss labels out of range", O.bpr_loss,
         [f32(4, 3), i64(-1, 3, 0, -4).reshape(4, 1)]),
        ("sequence_reverse lengths past T", O.sequence_reverse,
         [seq, i64(8, 3, 0, 7)]),
        ("sequence_pool last, lengths past T",
         lambda x, n: O.sequence_pool(x, n, "last"), [seq, i64(8, 3, 0, 7)]),
        ("linear_chain_crf labels and lengths out of range",
         O.linear_chain_crf, [f32(3, 4, 5), f32(5, 5), torch.tensor(
             [[0, 1, 2, 3], [4, 5, 1, 2], [1, 1, -1, 2]]), i64(6, 4, 9)]),
        ("edit_distance lengths past Lr", O.edit_distance,
         [torch.as_tensor(rng.integers(0, 4, (3, 5))), i64(5, 3, 7),
          torch.as_tensor(rng.integers(0, 4, (3, 4))), i64(4, 9, 2)]),
        ("ctc_loss labels and lengths out of range",
         lambda lp, *a: O.ctc_loss(torch.log_softmax(lp, -1), *a),
         [f32(3, 6, 5), torch.tensor([[1, 2], [3, 7], [2, 2]]),
          i64(6, 9, 4), i64(2, 2, 3)]),
        ("cast saturating to int8, uint8, int32",
         lambda x: tuple(O.cast(x, d) for d in ("int8", "uint8", "int32")),
         [torch.tensor([-1.5, 300.7, -300.2, 3e9, float("nan"),
                        float("inf"), -float("inf")])]),
        ("gradients at kinks", kink_grads, [torch.tensor(
            [0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 3.0, -3.0, 6.0, 24.0, 40.0,
             15.0, -15.0])]),
    ]
    w, b, flat, bw = f32(10, 3), f32(10), f32(13, 2), f32(2, 3, 3)
    my = f32(12, 3)
    neg = torch.as_tensor(rng.integers(0, 10, (5, 4)))
    ids5 = i64(0, 7, 3, 9, 1)
    rest = [
        ("tensor", "creation", lambda d: (
            O.fill_constant((2, 3), 1.5, device=d.device),
            O.eye(3, 4, device=d.device), O.range(2, 11, 3, device=d.device),
            O.linspace(-1.0, 2.0, 7, device=d.device))),
        ("tensor", "shape ops", lambda d: (
            O.reshape(d(seq), [0, -1]), O.pad(d(x53), [1, 0, 2, 3]),
            O.tensor.strided_slice(d(seq), [1], [5], [0], [-2]),
            O.split(d(seq), [2, -1, 1], axis=1), O.expand(d(x53), (2, 1)),
            O.unstack(d(x53), 1), O.crop(d(seq), (2, 3, 1), (1, 2, 0)))),
        ("tensor", "keyed draws (moments to 0.1)", lambda d: torch.stack([
            O.uniform_random((20000,), key, device=d.device).mean(),
            O.gaussian_random((20000,), key, device=d.device).std(),
            O.truncated_gaussian_random((20000,), key,
                                        device=d.device).abs().max()]
            ).round(decimals=1)),
        ("math", "elementwise", lambda d: (
            O.elementwise_add(d(seq), d(seq[0]), axis=1),
            O.elementwise_mod(d(i64(-7, 7, -7, 7)), d(i64(3, -3, -3, 3))),
            O.elementwise_floordiv(d(i64(-7, 7, -7, 7)),
                                   d(i64(3, -3, -3, 3))),
            O.elementwise_pow(d(x53.abs()), d(x53)))),
        ("math", "products", lambda d: (
            O.matmul(d(seq), d(w[:2]), alpha=0.5),
            O.mul(d(seq), d(my)),
            O.bilinear_tensor_product(d(x53), d(w[:5]), d(bw), d(b[:2])),
            O.cos_sim(d(x53), d(w[:5])))),
        ("math", "utility", lambda d: (
            O.cumsum(d(seq), 1, exclusive=True, reverse=True),
            O.logsumexp(d(seq), 1), O.clip_by_norm(d(x53), 1.0),
            O.maxout(d(seq.reshape(2, 6, 4)), 3), O.isfinite(d(x53)),
            O.math.has_nan(d(x53)))),
        ("reduction", "reductions", lambda d: (
            O.reduce_sum(d(seq), [0, 2]), O.reduce_prod(d(x53.abs()), 1),
            O.reduce_max(d(seq)), O.reduce_any(d(x53) > 1), O.mean(d(seq)))),
        ("loss", "losses", lambda d: (
            O.cross_entropy(torch.softmax(d(x53), -1), d(i64(0, 2, 1, 1, 0))),
            O.bpr_loss(d(x53), d(i64(0, 2, 1, 1, 0).reshape(5, 1))),
            O.npair_loss(d(x53), d(w[:5]), d(i64(0, 1, 0, 2, 1))),
            O.loss.teacher_student_sigmoid_loss(d(b * 10), d(b - 1.5)),
            O.kldiv_loss(d(x53), d(x53.abs())),
            O.huber_loss(d(x53), d(w[:5])),
            O.loss.dice_loss(torch.softmax(d(x53), -1),
                             d(i64(0, 2, 1, 1, 0))))),
        ("sampling", "nce and hsigmoid", lambda d: (
            O.nce_loss(d(x53), d(ids5), d(w), d(b), sampler="log_uniform",
                       custom_neg=d(neg)),
            O.hsigmoid_loss(d(x53), d(ids5), d(w), d(b), num_classes=10))),
        ("sequence", "padded ops", lambda d: (
            O.sequence_pad(d(flat), d(lens), 6),
            O.sequence_pool(d(seq), d(lens), "max"),
            O.sequence_softmax(d(seq[..., 0]), d(lens)),
            O.sequence_reverse(d(seq), d(lens)),
            O.sequence_concat([d(seq), d(seq)], [d(lens), d(lens)]),
            O.sequence_enumerate(d(torch.arange(24).reshape(4, 6)), d(lens),
                                 3),
            O.sequence_scatter(d(seq[:, :5, 0]), d(
                i64(0, 0, 4, 9, 1, 3, 3, 3).reshape(4, 2)),
                d(seq[:, :2, 1]), d(i64(2, 2, 0, 1))),
            O.hash(d(i64(0, 1, -1, 2 ** 31 - 1)), 1000, 2),
            O.add_position_encoding(d(seq)))),
        ("sequence", "chunk_eval", lambda d: O.chunk_eval(
            d(tags), d(tags2), d(i64(8, 5, 0)), 2, "IOB")),
        ("control_flow", "compare and logical", lambda d: (
            O.less_than(d(x53), 0.1), O.logical_xor(d(x53) > 0,
                                                    d(x53) < 0.5))),
        ("control_flow", "scan", lambda d: O.scan(
            lambda c, x: (torch.tanh(c + x), c * x), d(x53[0]), d(x53),
            reverse=True)),
        ("control_flow", "static_rnn", lambda d: O.static_rnn(
            lambda x, h: (torch.tanh(x + h), torch.tanh(x + h)), d(seq),
            d(seq[:, 0]))),
        ("control_flow", "TensorArray", lambda d: O.TensorArray(
            4, (3,), device=d.device).write(1, d(x53[0])).write(
                d(i64(-1)), d(x53[1])).stack()),
        ("metrics", "metric ops", lambda d: (
            MT.mean_iou(d(tags), d(tags2), 5),
            MT.precision_recall(d(seq[:, :, 0]),
                                d(i64(0, 1, 2, 7)), 6)["macro_f1"],
            MT.positive_negative_pair(d(x53[:, 0].round()),
                                      d(tags[0, :5] % 3),
                                      d(tags[1, :5] % 2)))),
    ]
    return idx_family, rest


class _On:
    """Moves a tensor to ``device`` (a tensor's copy, so the CPU run's
    inputs stay as they are)."""

    def __init__(self, device):
        self.device = device

    def __call__(self, t):
        return t.to(self.device)


def ops_outputs_match(torch, a, b):
    """Every leaf of ``a`` (the card's) against ``b`` (the CPU's): floats
    within 1e-5 + 1e-5 relative (NaN where the CPU has NaN), the rest
    equal."""
    from paddle_tpu_torch.clip import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x = x.cpu() if torch.is_tensor(x) else torch.as_tensor(x)
        y = torch.as_tensor(y)
        if x.shape != y.shape:
            return False
        if y.is_floating_point():
            if not torch.allclose(x.to(y.dtype), y, rtol=1e-5, atol=1e-5,
                                  equal_nan=True):
                return False
        elif not torch.equal(x.to(y.dtype), y):
            return False
    return True


def phase_ops_library(torch):
    """Each op family on the card against the CPU (module docstring,
    phase 29), and the host syncs of the data-dependent ops."""
    import warnings

    from paddle_tpu_torch import ops as O

    tag = "[ops:library]"
    idx_family, rest = ops_library_cases(torch)
    cpu, card = _On("cpu"), _On("cuda")
    bad, per_family = [], {}
    on_card = [[a.to("cuda") for a in args] for _, _, args in idx_family]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [fn(*args) for (_, fn, _), args in zip(idx_family, on_card)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for (name, fn, args), out in zip(idx_family, got):
        if not ops_outputs_match(torch, out, fn(*args)):
            bad.append(name)
    per_family["tensor indexing and search, sync-free"] = len(idx_family)
    n_calls = len(idx_family)
    for family, name, fn in rest:
        want = fn(cpu)
        if not ops_outputs_match(torch, fn(card), want):
            bad.append(f"{family}: {name}")
        per_family[family] = per_family.get(family, 0) + 1
        n_calls += len(want) if isinstance(want, tuple) else 1

    def syncs(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum(map(is_sync_warning, seen))

    x = torch.randn(4, 6, device="cuda")
    lens = torch.tensor([6, 3, 0, 4], device="cuda")
    counts = {
        "where_index": syncs(lambda: O.tensor.where_index(x > 0)),
        "unique_with_counts": syncs(lambda: O.tensor.unique_with_counts(
            (x * 3).long())),
        "sequence_unpad": syncs(lambda: O.sequence_unpad(x[..., None],
                                                         lens)),
        "sequence_expand without rmax": syncs(lambda: O.sequence_expand(
            x, lens)),
        "while_loop of 5 iterations": syncs(lambda: O.while_loop(
            lambda v: v[0] < 5, lambda v: (v[0] + 1, v[1] * 2),
            (torch.zeros((), device="cuda"), x))),
        "scan of 4 steps": syncs(lambda: O.scan(
            lambda c, r: (c + r, c), x[0], x)),
        "chunk_eval": syncs(lambda: O.chunk_eval(
            (x > 0).long(), (x > 0.5).long(), lens, 1, "IOB")),
    }
    log(f"{tag} {len(idx_family) + len(rest)} card-against-CPU checks "
        f"covering {n_calls} op calls, by family {per_family}; mismatches: "
        f"{bad or 'none'}; host syncs a call: {counts}")
    if bad:
        raise SystemExit(f"{tag} card and CPU disagree on {bad}")


def ssd_features(torch, b, seed=0):
    """The six MobileNet-SSD feature maps (B, C, S, S) from numpy
    ``seed``: the repo has no MobileNet backbone, so the head's inputs
    are drawn, as the recommender's batches are."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, c, s, s)).astype(
        np.float32)) for c, s in SSD_MAPS]


def ssd_ground_truth(torch, b, seed=1):
    """Padded ground truth: 1-8 boxes an image in normalised [x1, y1,
    x2, y2] (sides 0.05-0.5), labels in 1..20, as (B, 8, 4), (B, 8) and
    a (B, 8) mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 0.5, (b, SSD_G, 2))
    wh = rng.uniform(0.05, 0.5, (b, SSD_G, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    label = rng.integers(1, 21, (b, SSD_G)).astype(np.int64)
    n = rng.integers(1, SSD_G + 1, (b,))
    mask = np.arange(SSD_G)[None, :] < n[:, None]
    return (torch.from_numpy(gt), torch.from_numpy(label),
            torch.from_numpy(mask))


def ssd_loss_of(model, *args):
    from paddle_tpu_torch.ops import detection as D

    feats, (gt, label, mask) = list(args[:6]), args[6:]
    loc, conf, pb, pv = model(feats)
    return D.ssd_loss(loc, conf, gt, label, pb, pv, mask).mean()


def decode_agreement(torch, got, want):
    """(labels and valid masks equal, the largest |card - CPU| less
    DET_TOL x |CPU| over the score and box columns) of two
    detection_output results, the card's and the CPU's."""
    go, gv = got[0].cpu().double(), got[1].cpu()
    wo, wv = want[0].double(), want[1]
    same = bool(torch.equal(gv, wv)) and bool(torch.equal(go[..., 0],
                                                          wo[..., 0]))
    excess = float((go[..., 1:] - wo[..., 1:]).abs().sub(
        DET_TOL * wo[..., 1:].abs()).max())
    return same, excess


def phase_train_ssd(torch, FK, K, QM):
    """The MobileNet-SSD head on PASCAL VOC (module docstring, phase
    30): the float64 check step, Trainer steps at B=32, the decode card
    against CPU with no host read, and DetectionMAP."""
    import copy

    from paddle_tpu_torch import metrics as MT
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core.dtypes import Policy, policy_scope
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.ops import detection as D
    from paddle_tpu_torch.parallel import Trainer

    tag = "[train:ssd]"
    n0 = all_launches(FK, K, QM)
    channels = [c for c, _ in SSD_MAPS]
    cpu = L.MultiBoxHead(channels, **SSD_HEAD, device="cpu",
                         generator=torch.Generator().manual_seed(50))
    log(f"{tag} MultiBoxHead over maps {SSD_MAPS}: priors per cell "
        f"{cpu.num_priors}, {sum(p.numel() for p in cpu.parameters())} "
        f"parameters")
    gt = ssd_ground_truth(torch, SSD_CHECK_B)
    card_against_cpu(torch, f"{tag} B={SSD_CHECK_B}", cpu, ssd_loss_of,
                     ssd_features(torch, SSD_CHECK_B) + list(gt))

    model = copy.deepcopy(cpu).to("cuda")
    del cpu
    feats = [f.to("cuda") for f in ssd_features(torch, SSD_B, seed=2)]
    gt = [t.to("cuda") for t in ssd_ground_truth(torch, SSD_B, seed=3)]
    with torch.no_grad():
        priors = model(feats)[2]
    if priors.shape != (SSD_PRIORS, 4):
        raise SystemExit(f"{tag} {tuple(priors.shape)} priors, not "
                         f"{SSD_PRIORS}")
    tr = Trainer(model, TO.Adam(1e-3),
                 lambda m, bt, g: (ssd_loss_of(m, *bt[0], *bt[1]), {}))
    batch = (feats, gt)
    losses, ms = timed_steps(torch, lambda: tr.train_step(batch), 2,
                             SSD_STEPS - 2)
    mean = sum(ms) / len(ms)
    busy, idle, ops = step_profile(torch, lambda: tr.train_step(batch),
                                   mean, n=2)
    log(f"{tag} B={SSD_B} float32 Adam(1e-3), {SSD_STEPS} steps: losses "
        f"{[round(v, 6) for v in losses]}; ms per timed step "
        f"{[round(v, 3) for v in ms]}, mean {mean:.3f} ms, "
        f"{SSD_B / (mean / 1e3):.1f} images/s; device busy {busy:.3f} ms "
        f"per step, idle share {idle:.3f}, {ops:.0f} device ops per step")
    if not finite_and_falling(losses):
        raise SystemExit(f"{tag} losses not finite and falling")

    # the decode: the trained head's outputs (the card's, copied to the
    # CPU), decoded on each device, in float64 (the head run under the
    # float64 policy) and in float32
    model.eval()
    f64 = Policy("float64", "float64", "float64")
    with torch.no_grad():
        m64 = copy.deepcopy(model).double()
        with policy_scope(f64):
            head64 = m64([f.double() for f in feats])
            cpu64 = copy.deepcopy(m64).cpu()([f.cpu().double()
                                              for f in feats])
        head32 = model(feats)
    head_gap = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(head64, cpu64))
    results = {}
    for name, head in (("float64", head64), ("float32", head32)):
        on_cpu = [t.cpu() for t in head]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                got = D.detection_output(*head, **SSD_DECODE)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        with torch.no_grad():
            want = D.detection_output(*on_cpu, **SSD_DECODE)
        results[name] = (got, decode_agreement(torch, got, want))
    same64, excess64 = results["float64"][1]
    same32, excess32 = results["float32"][1]

    def decode():
        with torch.no_grad():
            D.detection_output(*head32, **SSD_DECODE)

    _, dms = timed_steps(torch, decode, 1, 3)
    dmean = sum(dms) / len(dms)
    dbusy, didle, dops = step_profile(torch, decode, dmean, n=1)
    out, valid = results["float32"][0]
    metric = MT.DetectionMAP(num_classes=SSD_HEAD["num_classes"])
    for i in range(SSD_B):
        keep = valid[i]
        metric.update(out[i][keep, 2:], out[i][keep, 1],
                      out[i][keep, 0].long(), gt[0][i][gt[2][i]],
                      gt[1][i][gt[2][i]])
    log(f"{tag} decode {SSD_DECODE} at B={SSD_B}: float64 card against "
        f"CPU on the same head outputs: labels and valid masks "
        f"{'equal' if same64 else 'DIFFER'}, scores and boxes past "
        f"{DET_TOL} + {DET_TOL} relative by {excess64:.3e} (<= 0 "
        f"required); float32 (reported): labels and masks "
        f"{'equal' if same32 else 'differ'}, excess {excess32:.3e}; the "
        f"float64 head's outputs, card against CPU, {head_gap:.3e}; no "
        f"host read under "
        f"sync debug \"error\"; {int(valid.sum())} valid detections; "
        f"{dmean:.3f} ms per call (float32), {dops:.0f} device ops per "
        f"call, device busy {dbusy:.3f} ms, idle share {didle:.3f}; "
        f"DetectionMAP on the training batch after {SSD_STEPS} steps "
        f"{metric.eval():.6f} (reported)")
    if not same64 or excess64 > 0:
        raise SystemExit(f"{tag} the float64 decode differs card to CPU")
    if all_launches(FK, K, QM) != n0:
        raise SystemExit(f"{tag} a hand kernel launched on the SSD path")


def det_inputs(torch):
    """The [ops:detection] inputs (float64, numpy seed 8), on the CPU:
    Faster R-CNN's RPN at an 800 px image and stride 16 (a 50 x 50 map,
    15 anchors a cell, 8 ground-truth boxes, 512 RoIs on a C=256 map),
    R-FCN's 7 x 7 x 21 position-sensitive map, YOLOv3's 13 x 13 head
    over 416 px (80 classes, B=8, 50 padded gt boxes), 80 classes of
    500 candidates for matrix_nms, 512 RoIs x 81 classes for
    box_decoder_and_assign."""
    import numpy as np

    rng = np.random.default_rng(8)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    def boxes(n, scale):
        xy = rng.uniform(0.0, 0.8, (n, 2))
        wh = rng.uniform(0.02, 0.3, (n, 2))
        return t(np.concatenate([xy, xy + wh], 1) * scale)

    yolo_gt = np.concatenate([rng.uniform(0.05, 0.95, (8, 50, 2)),
                              rng.uniform(0.02, 0.5, (8, 50, 2))], -1)
    yolo_gt[:, 20:] = 0.0                         # padded slots
    return dict(
        rpn_scores=t(rng.normal(size=(37500,))),
        rpn_deltas=t(rng.normal(size=(37500, 4)) * 0.2),
        gt=boxes(8, 800.0), gt_classes=torch.from_numpy(
            rng.integers(1, 81, (8,))),
        feat=t(rng.normal(size=(256, 50, 50))),
        rois=boxes(512, 800.0), fpn_rois=boxes(1000, 800.0),
        fpn_scores=t(rng.uniform(size=(1000,))),
        rfcn=t(rng.normal(size=(1, 21 * 49, 50, 50))),
        yolo_x=t(rng.normal(size=(8, 255, 13, 13))),
        yolo_gt=t(yolo_gt), yolo_label=torch.from_numpy(
            rng.integers(0, 80, (8, 50))),
        nms_boxes=boxes(500, 1.0), nms_scores=t(rng.uniform(
            size=(80, 500))),
        dec_prior=boxes(512, 800.0), dec_var=t(np.tile(
            [0.1, 0.1, 0.2, 0.2], (512, 1))),
        dec_target=t(rng.normal(size=(512, 324))),
        dec_score=t(rng.uniform(size=(512, 81))))


YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]


def det_cases(torch):
    """(name, fn) of [ops:detection]: ``fn(inp, dev)`` runs the op on the
    inputs ``inp`` (already on ``dev``) and returns its outputs."""
    from paddle_tpu_torch import ops as O

    def anchors_of(dev):
        anchors, var = O.anchor_generator(
            (50, 50), [32.0, 64.0, 128.0, 256.0, 512.0], [0.5, 1.0, 2.0],
            (16.0, 16.0), dtype=torch.float64, device=dev)
        return anchors.reshape(-1, 4), var.reshape(-1, 4)

    def rpn(inp, dev):
        anchors, var = anchors_of(dev)
        props, ok = O.generate_proposals(
            inp["rpn_scores"], inp["rpn_deltas"], anchors, var, (800, 800),
            pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.7)
        return anchors, props, ok

    def yolo(inp, dev):
        x = inp["yolo_x"].clone().requires_grad_(True)
        img = torch.full((8, 2), 416, dtype=torch.int64, device=dev)
        boxes, scores = O.yolo_box(x, img, YOLO_ANCHORS[12:], 80, 0.01, 32)
        loss = O.yolov3_loss(x, inp["yolo_gt"], inp["yolo_label"],
                             anchors=YOLO_ANCHORS, anchor_mask=[6, 7, 8],
                             class_num=80, downsample_ratio=32)
        grad, = torch.autograd.grad(loss, x)
        return boxes.detach(), scores.detach(), loss.detach(), grad

    def fpn(inp, dev):
        masks, lvl = O.distribute_fpn_proposals(inp["fpn_rois"])
        multi = [inp["fpn_rois"][i::4] for i in range(4)]
        scores = [inp["fpn_scores"][i::4] for i in range(4)]
        return masks, lvl, O.collect_fpn_proposals(multi, scores,
                                                   post_nms_top_n=1000)

    return [
        ("anchor_generator + generate_proposals (RPN)", rpn),
        ("rpn_target_assign (8 gt boxes)", lambda inp, dev:
         O.rpn_target_assign(anchors_of(dev)[0], inp["gt"])),
        ("roi_align 512 x 7x7 (C=256)", lambda inp, dev: O.roi_align(
            inp["feat"], inp["rois"], output_size=(7, 7),
            spatial_scale=1 / 16, sampling_ratio=2)),
        ("roi_pool 512 x 7x7 (C=256)", lambda inp, dev: O.roi_pool(
            inp["feat"], inp["rois"], output_size=(7, 7),
            spatial_scale=1 / 16)),
        ("generate_proposal_labels", lambda inp, dev:
         O.generate_proposal_labels(inp["rois"], inp["gt"],
                                    inp["gt_classes"])),
        ("distribute_fpn_proposals + collect_fpn_proposals", fpn),
        ("psroi_pool (R-FCN)", lambda inp, dev: O.psroi_pool(
            inp["rfcn"], torch.cat([torch.zeros_like(inp["rois"][:, :1]),
                                    inp["rois"]], 1), output_size=(7, 7),
            spatial_scale=1 / 16)),
        ("yolo_box + yolov3_loss (13x13, 80 classes)", yolo),
        ("matrix_nms (80 x 500)", lambda inp, dev: O.matrix_nms(
            inp["nms_boxes"], inp["nms_scores"], keep_top_k=100,
            score_threshold=0.5)),
        ("box_decoder_and_assign (512 x 81)", lambda inp, dev:
         O.box_decoder_and_assign(inp["dec_prior"], inp["dec_var"],
                                  inp["dec_target"], inp["dec_score"])),
    ]


def det_outputs_match(torch, a, b):
    """Every leaf of ``a`` (the card's) against ``b`` (the CPU's):
    floats within DET_TOL + DET_TOL relative, the rest equal."""
    from paddle_tpu_torch.clip import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x = x.cpu()
        if x.shape != y.shape:
            return False
        if y.is_floating_point():
            if not torch.allclose(x, y, rtol=DET_TOL, atol=DET_TOL,
                                  equal_nan=True):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def phase_ops_detection(torch, FK, K, QM):
    """The other detection paths at their published sizes, card against
    CPU in float64 under sync debug "error" (module docstring, phase
    31), with ms and device ops per call."""
    tag = "[ops:detection]"
    n0 = all_launches(FK, K, QM)
    inp = det_inputs(torch)
    card = {k: v.to("cuda") for k, v in inp.items()}
    bad, lines = [], []
    for name, fn in det_cases(torch):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(card, "cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fn(inp, "cpu")
        cpu_s = time.perf_counter() - t0
        if not det_outputs_match(torch, got, want):
            bad.append(name)
        _, ms = timed_steps(torch, lambda: [fn(card, "cuda"), None][1], 0,
                            3)
        mean = sum(ms) / len(ms)
        _, _, ops = step_profile(torch, lambda: fn(card, "cuda"), mean, n=1)
        lines.append(f"{name} {mean:.3f} ms, {ops:.0f} ops (the CPU "
                     f"reference {cpu_s:.2f} s)")
    log(f"{tag} {len(lines)} paths, float64, card against CPU (floats "
        f"{DET_TOL} + {DET_TOL} relative, integers and masks equal), no "
        f"host read under sync debug \"error\"; mismatches: "
        f"{bad or 'none'}; per call: " + "; ".join(lines))
    if bad:
        raise SystemExit(f"{tag} card and CPU disagree on {bad}")
    if all_launches(FK, K, QM) != n0:
        raise SystemExit(f"{tag} a hand kernel launched")


SLIM_STUDENT_LAYERS, SLIM_EPOCHS, SLIM_BATCHES = 6, 3, 4
SLIM_TARGET, SLIM_TOL = 0.5, 0.005        # Pruner.sparsity's gate
RANGE_CALLS, RANGE_WINDOW = 12, 4


def slim_batch(torch, cfg, seed):
    """A seeded (TB, TT) token batch and its shifted labels, the last
    position ignored (-100)."""
    ids = torch.randint(0, cfg.vocab_size, (TB, TT),
                        generator=torch.Generator().manual_seed(seed))
    labels = torch.cat([ids[:, 1:], torch.full((TB, 1), -100)], 1)
    return ids.to("cuda"), labels.to("cuda")


def range_fake_quant_check(torch, tag):
    """fake_quantize_range_abs_max on the card against the CPU: RANGE_CALLS
    calls at RANGE_WINDOW on seeded activations of varying scale."""
    from paddle_tpu_torch.quant import ops as Q

    gen = torch.Generator().manual_seed(21)
    st = {d: Q.range_state_init(RANGE_WINDOW) for d in ("cpu", "cuda")}
    worst, differing = 0.0, 0
    for i in range(RANGE_CALLS):
        x = torch.randn(4096, 768, generator=gen) * (0.5 + (7 * i) % 5)
        out = {}
        for d in ("cpu", "cuda"):
            out[d], st[d] = Q.fake_quantize_range_abs_max(x.to(d), st[d])
        a, b = st["cuda"], st["cpu"]
        if not (torch.equal(a.scale.cpu(), b.scale)
                and torch.equal(a.scales_window.cpu(), b.scales_window)
                and torch.equal(a.step.cpu(), b.step)):
            raise SystemExit(f"{tag} the range fake-quant state differs "
                             f"card against CPU at call {i}")
        d = (out["cuda"].cpu() - out["cpu"]).abs()
        worst = max(worst, float(d.max()) / (float(b.scale) / 127))
        differing += int((d > 0).sum())
    log(f"{tag} fake_quantize_range_abs_max, {RANGE_CALLS} calls at "
        f"window_size={RANGE_WINDOW} on (4096, 768): states equal card "
        f"against CPU; outputs differ in {differing} entries, worst "
        f"{worst:.3f} grid steps (limit 1)")
    if worst > 1:
        raise SystemExit(f"{tag} the card's fake-quant outputs stray more "
                         f"than one grid step from the CPU's")


def phase_train_slim(torch, FK, K, QM, prompts):
    """Slim compression at bench_gpt's shape: distil, prune and shrink a
    GPT, then serve it (see the module docstring, phase 32)."""
    import copy

    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.models import gpt

    tag = "[train:slim]"
    reset_flash_counts(FK)
    cfg = gpt.GPTConfig.small()
    cfg.max_position, cfg.remat = TT, False
    scfg = copy.deepcopy(cfg)
    scfg.num_layers = SLIM_STUDENT_LAYERS

    def model(c, seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return gpt.GPTForCausalLM(c, generator=gen)

    teacher, student = model(cfg, 11).eval(), model(scfg, 12)
    batches = [slim_batch(torch, cfg, 30 + i) for i in range(SLIM_BATCHES)]
    held = slim_batch(torch, cfg, 40)
    tparams = dict(teacher.named_parameters())
    tkeep = {k: v.detach().clone() for k, v in tparams.items()}
    gates = [f"blocks.{i}.ffn.gate.weight" for i in range(scfg.num_layers)]

    def loss_fn(p, ids, labels, logits_only=False):
        if logits_only:
            return student.functional_call(p, ids)[0]
        return student.functional_call(p, ids, labels,
                                       method="forward_loss")[0]

    def teacher_apply(p, ids, labels):
        return teacher.functional_call(p, ids)[0]

    def eval_fn(p):
        with torch.no_grad():
            return -float(loss_fn(p, *held))

    losses = []

    class Recorded(slim.Distiller):
        def loss(self, *a, **kw):
            v = super().loss(*a, **kw)
            losses.append(v.detach())
            return v

    distill = slim.DistillationStrategy(teacher_apply, tparams, Recorded(),
                                        end_epoch=SLIM_EPOCHS)
    log(f"{tag} teacher GPTConfig.small() float32, "
        f"{sum(v.numel() for v in tparams.values())} parameters; student "
        f"{scfg.num_layers} layers of the same widths, "
        f"{sum(p.numel() for p in student.parameters())} parameters; "
        f"batches ({TB}, {TT}), Distiller() T 4, soft 0.7, hard 0.3")

    # 1. one distillation step with the kernels against plain attention
    ctx = slim.Context(dict(student.named_parameters()))
    distill.on_epoch_begin(ctx)
    distilled = ctx.loss_wrapper(loss_fn)
    mhas = [b.self_attn for m in (teacher, student) for b in m.blocks]
    result = {}
    for name, use_flash in (("kernels", True), ("plain", False)):
        for a in mhas:
            a.use_flash = use_flash
        p = {k: v.detach().requires_grad_() for k, v in ctx.params.items()}
        n0 = all_counts(FK, K, QM)
        loss = distilled(p, *batches[0])
        grads = torch.autograd.grad(loss, list(p.values()))
        launched = {k: v - n0[k] for k, v in all_counts(FK, K, QM).items()}
        if (min(launched[k] for k in FLASH_ROWS) == 0 if use_flash
                else any(launched.values())):
            raise SystemExit(f"{tag} check step {name}: launches "
                             f"{launched}")
        result[name] = (loss.item(), dict(zip(p, grads)))
    for a in mhas:
        a.use_flash = True
    losses.clear()
    (lk, gk), (lp, gp) = result["kernels"], result["plain"]
    worst, where = max((float((gk[n] - gp[n]).abs().max())
                        / max(float(gp[n].abs().max()), 1e-30), n)
                       for n in gp)
    log(f"{tag} check step: distilled loss kernels {lk:.6f}, plain "
        f"{lp:.6f} (|diff| {abs(lk - lp):.3e}, atol "
        f"{TRAIN_TOL['float32'][0]}); worst grad diff / the parameter's "
        f"max plain grad {worst:.3e} ({where}; limit "
        f"{TRAIN_TOL['float32'][1]})")
    if not (abs(lk - lp) <= TRAIN_TOL["float32"][0]
            and worst <= TRAIN_TOL["float32"][1]):
        raise SystemExit(f"{tag} the kernel path's distilled loss or grads "
                         f"disagree with plain attention")
    del result, gk, gp, ctx, distilled
    torch.cuda.empty_cache()

    # 2. the Compressor: every step counted and timed through the reader
    marks, epochs, checks = [], [], []

    def mark():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), all_counts(FK, K, QM)))

    def reader():
        for batch in batches:
            mark()
            yield batch
        mark()

    class Watch(slim.Strategy):
        """First in the list: stamps each epoch's start; checks the masks
        at each epoch's end."""

        def on_epoch_begin(self, c):
            torch.cuda.synchronize()
            epochs.append([time.perf_counter(), len(marks)])

        def on_epoch_end(self, c):
            if c.masks:
                zeros = all(bool((c.params[n][m == 0] == 0).all())
                            for n, m in c.masks.items())
                checks.append((c.epoch_id, zeros,
                               slim.Pruner.sparsity(c.params, c.masks)))

    prune = slim.UniformPruneStrategy(
        SLIM_TARGET, structured=True, axis=1, match=lambda n: n in gates,
        start_epoch=2)
    comp = slim.Compressor(dict(student.named_parameters()), TO.Adam(1e-3),
                           loss_fn, reader, eval_fn=eval_fn,
                           epochs=SLIM_EPOCHS,
                           strategies=[Watch(), distill, prune])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = comp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    want = {"flash_attention_fwd": cfg.num_layers + scfg.num_layers,
            "flash_attention_dq": scfg.num_layers,
            "flash_attention_dkv": scfg.num_layers}
    steps, step_ms = [], []
    for e, (start, first) in enumerate(epochs):
        span = marks[first:first + SLIM_BATCHES + 1]
        for (ta, ca), (tb, cb) in zip(span, span[1:]):
            steps.append({k: cb[k] - ca[k] for k in ca})
            step_ms.append(1e3 * (tb - ta))
        epochs[e] = (1e3 * (span[-1][0] - start),
                     1e3 * (span[0][0] - start))
    other_dtypes = {k: getattr(FK, k).launches
                    - getattr(FK, k).dtype_launches.get(torch.float32, 0)
                    for k in FLASH_ROWS}
    bad = [s for s in steps if {k: s[k] for k in FLASH_ROWS} != want
           or any(v for k, v in s.items() if k not in FLASH_ROWS)]
    mean = sum(step_ms) / len(step_ms)
    log(f"{tag} Compressor, {SLIM_EPOCHS} epochs of {SLIM_BATCHES} steps, "
        f"Adam(1e-3): distilled losses {[round(v, 4) for v in losses]}; "
        f"eval history {[round(v, 5) for v in ctx.eval_history]}; launches "
        f"a step {steps[0]} (want {want}, nothing else), flash launches "
        f"in this phase not float32 {other_dtypes}; {len(bad)} steps off")
    log(f"{tag} ms per step {[round(v, 3) for v in step_ms]}, mean "
        f"{mean:.3f} ms ({TB * TT / (mean / 1e3):.1f} tokens/s); epochs' "
        f"ms {[round(e[0], 1) for e in epochs]}, of which before the "
        f"first step (the strategies' epoch start: the mask search at "
        f"epoch 2) {[round(e[1], 1) for e in epochs]}; run {wall:.2f} s; "
        f"peak memory {peak:.2f} GiB")
    if bad or len(steps) != SLIM_EPOCHS * SLIM_BATCHES or any(
            other_dtypes.values()):
        raise SystemExit(f"{tag} a distillation step launched other kernels "
                         f"or another number of times: {bad[:2]}")
    if not (len(losses) == len(steps) and finite_and_falling(losses)):
        raise SystemExit(f"{tag} the distilled losses are not finite and "
                         f"falling: {losses}")
    changed = [k for k, v in tparams.items()
               if not torch.equal(v.detach(), tkeep[k]) or v.grad is not None]
    state_ptrs = {t.data_ptr() for leaf in ctx.opt_state["leaf"]
                  for t in leaf.values()}
    state_ptrs |= {t.data_ptr() for t in ctx.params.values()}
    shared = [k for k, v in tparams.items() if v.data_ptr() in state_ptrs]
    log(f"{tag} teacher: {len(changed)} parameters changed or with a grad, "
        f"{len(shared)} in the optimizer state or the student's params; "
        f"optimizer slots {len(ctx.opt_state['leaf'])} for "
        f"{len(ctx.params)} student parameters")
    if changed or shared or len(ctx.opt_state["leaf"]) != len(ctx.params):
        raise SystemExit(f"{tag} the teacher moved, took a grad or holds "
                         f"optimizer state")
    log(f"{tag} masks after each epoch from 2 (epoch, every masked entry "
        f"0, Pruner.sparsity): {checks} (target {SLIM_TARGET} +- "
        f"{SLIM_TOL})")
    if [c[0] for c in checks] != list(range(2, SLIM_EPOCHS)) or not all(
            z and abs(sp - SLIM_TARGET) <= SLIM_TOL for _, z, sp in checks):
        raise SystemExit(f"{tag} the masks did not hold or missed the "
                         f"target")

    # 3. the idle share of a distillation step (the Compressor's update on
    # copies, masks aside)
    p = {k: v.detach().clone() for k, v in ctx.params.items()}
    opt = TO.Adam(1e-3)
    state = opt.init(p)
    again = slim.Context(p)
    distill.on_epoch_begin(again)
    update = opt.minimize_fn(again.loss_wrapper(loss_fn))
    busy, idle, ops = step_profile(
        torch, lambda: update(p, state, *batches[0]), mean)
    log(f"{tag} a distillation step under torch.profiler: device busy "
        f"{busy:.3f} ms of {mean:.3f} ms, idle share {idle:.3f}, "
        f"{ops:.1f} device ops")
    del p, state, update, again
    torch.cuda.empty_cache()

    # 4. shrink: the dead gate columns out, with up and down
    kept = int((ctx.masks[gates[0]][0] != 0).sum())
    ratio = 1 - kept / scfg.intermediate_size
    plan = [(g, 1, [(g.replace("gate", "up"), 1),
                    (g.replace("gate", "down"), 0)]) for g in gates]
    small, idx = slim.shrink_params(ctx.params, plan, ratio)
    widths = {len(i) for i in idx.values()}
    ncfg = copy.deepcopy(scfg)
    ncfg.intermediate_size = kept
    shrunk = model(ncfg, 13).eval()
    shrunk.set_parameters(small)
    masked = student.eval()
    masked.set_parameters(ctx.params)
    with torch.no_grad():
        want_logits = masked(held[0])
        got = shrunk(held[0])
    scale = float(want_logits.abs().max())
    d = float((got - want_logits).abs().max())
    log(f"{tag} shrink_params at ratio 1 - {kept}/{scfg.intermediate_size}:"
        f" kept widths {sorted(widths)}; shrunk student "
        f"{sum(q.numel() for q in shrunk.parameters())} parameters; logits "
        f"on the held-out batch against the masked student's: max |diff| "
        f"{d:.3e} (limit 1e-4 x {scale:.3f})")
    if widths != {kept} or d > 1e-4 * scale:
        raise SystemExit(f"{tag} the shrunk student is not the masked one")
    del want_logits, got, teacher, tparams, tkeep, ctx, comp
    torch.cuda.empty_cache()

    # 5. serve both students paged
    rates = {}
    for name, m in (("masked", masked), ("shrunk", shrunk)):
        rates[name] = serve_merged(torch, FK, K, QM, m, prompts[:8], tag,
                                   f"the {name} student")
    log(f"{tag} decode: shrunk student {rates['shrunk'][0]:.1f} tokens/s, "
        f"{rates['shrunk'][1]:.3f} ms per tick; the unpruned (masked, "
        f"FFN {scfg.intermediate_size}) student "
        f"{rates['masked'][0]:.1f} tokens/s, {rates['masked'][1]:.3f} ms "
        f"per tick")
    range_fake_quant_check(torch, tag)
    del masked, shrunk, student
    torch.cuda.empty_cache()


def timed_phase(tag, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"{tag} phase seconds {time.perf_counter() - t0:.1f}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.kernels import decode_attention as K
    from paddle_tpu_torch.ops.kernels import flash_attention as FK
    from paddle_tpu_torch.ops.kernels import quant_matmul as QM
    from paddle_tpu_torch.serving import PagedKVPool

    # float32 matmuls in full float32 (no TF32), and half-precision
    # matmuls that reduce in float32 (XLA's accumulation), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {kind} x{count}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}, cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}")
    smi = nvidia_smi_line()
    log(smi)

    phase_build()
    err = phase_kernels(torch, K)
    qmm_err, qlin_err = phase_qmm_kernels(torch, QM)
    phase_paged_write(torch)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = gpt.GPTForCausalLM(gpt.GPTConfig.small(), generator=gen).eval()
    log(f"[model] GPTConfig.small() float32, "
        f"{sum(p.numel() for p in model.parameters())} parameters, built "
        f"in {time.perf_counter() - t0:.2f} s")
    rng = torch.Generator().manual_seed(1)
    lens = torch.randint(8, 49, (16,), generator=rng).tolist()
    prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist()
               for n in lens]
    launches = {}
    paged = dict(pages=B * 32 + 8, page_size=PS)
    outs_c, launches["decode_attention"], ticks_c, run_c = phase_serving(
        torch, K, model, prompts, "contiguous", {})
    outs_p, launches["decode_attention_paged"], ticks_p, run_p = \
        phase_serving(torch, K, model, prompts, "paged", paged)
    # the same paged path at long contexts, where the split walks more
    # than one live chunk per row (its launches stay out of the record)
    long_lens = torch.randint(1200, 1901, (8,), generator=rng).tolist()
    long_prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist()
                    for n in long_lens]
    phase_serving(torch, K, model, long_prompts, "paged-long", paged)
    agree = sum(int((a == b).all()) for a, b in zip(outs_c, outs_p))
    log(f"[serve] contiguous and paged agree on {agree}/16 requests; "
        f"launches per decode tick: contiguous "
        f"{launches['decode_attention'] / ticks_c:.2f}, paged "
        f"{launches['decode_attention_paged'] / ticks_p:.2f} (paged "
        f"includes one B=1 launch per layer per prefill)")
    outs_q, launches["decode_attention_paged_quant"], ticks_q, run_q = \
        phase_serving(torch, K, model, prompts, "paged-int8",
                      dict(paged, kv_dtype="int8"))
    dec_q = run_q.pop("dec")
    attn0 = model.blocks[0].self_attn
    float_bytes = PagedKVPool(paged["pages"], PS, attn0.num_kv_heads,
                              attn0.head_dim, arrays=False,
                              device="cuda").pool_nbytes
    int8_bytes = dec_q._allocator.pool_nbytes
    del dec_q
    agree = sum(int((a == b).all()) for a, b in zip(outs_p, outs_q))
    ratio = float_bytes / int8_bytes
    log(f"[serve:paged-int8] pool bytes per layer (K or V side): int8 "
        f"{int8_bytes}, float32 {float_bytes} ({ratio:.3f}x smaller, "
        f">= 3.5 required); {agree}/16 requests agree with the "
        f"float paged run (reported, not gated); launches per decode tick "
        f"{launches['decode_attention_paged_quant'] / ticks_q:.2f}")
    if ratio < 3.5:
        raise SystemExit("the int8 pool is not >= 3.5x smaller")
    phase_int8_logits(torch, model)
    # the serving options at the same width, each run counted on its own
    base = {"contiguous": (outs_c, run_c), "paged": (outs_p, run_p)}
    phase_multistep(torch, K, model, prompts, base)
    phase_prefix(torch, K, model, prompts)
    phase_chunked(torch, K, model, prompts, long_prompts)
    phase_spec(torch, K, model, prompts, base)
    phase_handoff(torch, K, model, prompts, long_prompts)
    phase_stream(torch, K, model, prompts)
    phase_w8a16(torch, K, model, prompts, run_c)
    del base, run_c, run_p
    torch.cuda.empty_cache()

    rows = phase_timing(torch, K, err, launches)
    del model
    torch.cuda.empty_cache()

    qmm_launches = phase_int8_mnist(torch, QM)
    conv_launches, per_shape = timed_phase(
        "[int8:resnet50]", phase_int8_resnet50, torch, QM, K, FK)
    torch.cuda.empty_cache()
    # quant_matmul's record is the int8 ResNet-50 path's, at its shapes
    # (the MNIST shapes are timed and logged beside them)
    qmm_rows = phase_qmm_timing(torch, QM, {"quant_matmul": qmm_err,
                                            "quant_linear": qlin_err},
                                qmm_launches)
    rows += phase_qmm_conv_timing(torch, QM, qmm_err,
                                  conv_launches["quant_matmul"], per_shape)
    rows += [r for r in qmm_rows if r["name"] == "quant_linear"]

    flash_err = phase_flash_kernels(torch, FK)
    # the float32 step's flash launches make the float32 rows' record,
    # the "bfloat16" policy's step the bfloat16 rows'
    f32_launches, f32_step, f32_losses = phase_training(torch, FK)
    phase_training(torch, FK, "mixed_bf16", f32_losses)
    bf16_launches, bf16_step, _ = phase_training(torch, FK, "bfloat16",
                                                 f32_losses)
    phase_training(torch, FK, "mixed_fp16", f32_losses)
    rows += phase_flash_timing(torch, FK, flash_err["float32"],
                               f32_launches["float32"], f32_step, "float32")
    rows += phase_flash_timing(torch, FK, flash_err["bfloat16"],
                               bf16_launches["bfloat16"], bf16_step,
                               "bfloat16")
    phase_bert(torch, FK, packed=False)
    packed_step, seg = phase_bert(torch, FK, packed=True)
    rows += phase_flash_option_timing(torch, FK, flash_err["float32"],
                                      packed_step, seg)
    phase_train_loop(torch, FK)
    phase_bert_resume(torch, FK)
    torch.cuda.empty_cache()
    timed_phase("[train:mnist]", phase_train_mnist, torch)
    timed_phase("[train:resnet50]", phase_train_resnet50, torch)
    timed_phase("[train:deepfm]", phase_train_deepfm, torch)
    timed_phase("[train:nmt]", phase_train_nmt, torch, FK)
    timed_phase("[serve:nmt]", phase_serve_nmt, torch, K, FK)
    timed_phase("[train:vit]", phase_train_vit, torch, FK)
    phase_nmt_flash_timing(torch, FK)
    timed_phase("[train:bert_moe]", phase_train_bert_moe, torch, FK)
    timed_phase("[train:gpt_moe]", phase_train_gpt_moe, torch, FK)
    timed_phase("[serve:moe]", phase_serve_moe, torch, K, prompts)
    timed_phase("[train:zoo]", phase_train_zoo, torch, FK, K, QM)
    timed_phase("[train:stacked_lstm]", phase_train_stacked_lstm, torch, FK,
                K, QM)
    timed_phase("[train:recommender]", phase_train_recommender, torch, FK, K,
                QM)
    timed_phase("[train:lora]", phase_train_lora, torch, FK, K, QM, prompts)
    timed_phase("[train:word2vec]", phase_train_word2vec, torch, FK, K, QM)
    timed_phase("[ops:library]", phase_ops_library, torch)
    timed_phase("[train:ssd]", phase_train_ssd, torch, FK, K, QM)
    timed_phase("[ops:detection]", phase_ops_detection, torch, FK, K, QM)
    timed_phase("[train:slim]", phase_train_slim, torch, FK, K, QM, prompts)
    log(f"[card] {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
