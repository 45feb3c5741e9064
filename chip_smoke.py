#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`time_r1_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):
1. build every kernel under time_r1_tpu_torch/csrc (one nvcc each, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes, in bf16 and f32, and time kernel, plain
   version and one library call (`scaled_dot_product_attention`, a yardstick
   the port never calls): K1-K3 (serving), B1, B2, S1, S2 (training), D1, D2,
   Q1, Q2 (quantized rollouts: caches in bf16/f32 and int8, a fully masked
   first prefix chunk, suffix lengths 0 and 199, Q1 at the 3B products at M
   = 1, 8, 16, 200, 256, the 7B products at M = 8 and a ragged shape, bf16
   on the tensor cores but for the ragged shape, Q2 at M = 1, 4, 7, 8, 16, 128 at the 3B widths, M = 7, 8 at
   the 7B widths and M = 3 at hid 256, inter 272, every case with its two
   phases apart and in bf16 also end to end), P1, P2 (continuous-batching decode: 4 slots of lengths 0,
   327, 1689, 2041 over a shuffled page table, page size 16, full slots, a
   dead slot with a stale table row, head dim 64), and the bf16 head's
   backward against the f32 cotangent. K1-K3, B1, B2, S1, S2 and D2 in bf16
   run the tensor-core kernels; besides the serving shapes K1 is checked (out and
   lse) at phase 5's B = 1 prompt forward (timed), head dims 64 and 80, G 1,
   non-causal, ragged Sq 200 over Skv 328 and all-masked rows, and K3 at S
   100 with a slice whose keys are all masked, S 2048, nh 1 and head dims 64
   and 128, every value finite; besides the training shapes B1/B2 are checked
   at q_offset 64, ragged Sq 200 over Skv 328, head dim 64, G 1, non-causal
   and a block of all-masked rows, and S1/S2 at P = 2 prompts of R = 4 rows,
   Lp 640 with Sc 384, Lp = Sc = 128, head dim 64, G 1 and a prompt whose
   bias masks every prefix key; K2 at head dims 64 and 128 and with fully
   dead windows; D2 at suffix lengths 0, 1 and 199 over bf16 and int8
   caches at the rollout's shape, the 7B rollout's N = 56 rows over 4 kv
   heads, 16 rollouts a prompt (N = 128, and 112 over 4 kv heads), head dim
   64, two prompts, Lp 1000 and 2000 and a fully masked first chunk; two B2 launches, two prefix dK/dV launches, two D2,
   two Q1 and two Q2 launches must each give bit-equal results, the wrappers of
   K1-K3, B1, B2, S1, S2 and D2 refuse f16 and head dim 96 (K1-K3, B1, B2,
   S1, S2 a misaligned q, K2 windows of 128 rows), Q1's f16 x, a w4 of the
   wrong width, f64 scales, a non-contiguous x and a misaligned bf16 x, and
   Q2's inter % 16 != 0, M > 128 and a hid beyond its shared memory; and
   K1, B1, B2, S1 and S2 at the 7B's head layout (28 q heads over 4 kv
   heads, G = 7) at phase 5's shapes, bf16, timed beside their bounds and
   one SDPA call (`attention_7b_cases`); and K1's forward and B1/B2 through
   its autograd at the full-row loss's shape (8 rows of 4096 over 2 kv heads,
   1982 left pad keys a row, masked keys after short completions), bf16 and
   f32, against the plain version's autograd (`full_row_attention_cases`);
3. end-to-end agreement at reduced depth: Qwen2.5-VL-3B widths with 2 decoder
   layers and 2 vision blocks, one 8-frame video request in f32, card
   (kernels) against CPU (plain versions);
3b. the same for one GRPO loss step (G = 4 fixed completions, fixed
   advantages, beta = 0.04 against a reference copy): loss, metrics and every
   gradient, card against CPU, with fix_vit and with fix_vit=False (the whole
   tower trains; K2/K3 must not launch inside the differentiated call); in
   f32 K1-K3, B1, B2, S1 and S2 run the FMA kernels only (in phases 3, 3c
   and 3d K1-K3 as well, and D2 in 3c);
3 (LoRA). the side-path forward (`Engine.set_lora_side`) against the merged
   tree's and card against CPU, and phase 3b's split loss with the adapters
   merged inside each remat-checkpointed layer: loss, metrics and every
   adapter gradient, card against CPU (`phase_reduced_lora`);
3c. the quantized G-way decode at reduced depth, int8 weights and int8 KV,
   then int4 weights: 16 teacher-forced steps, card (D2, Q2, Q1) against CPU
   (plain paths) on every step's logits, Q1 on its FMA kernel only;
3d. continuous batching at reduced depth (f32, one 8-frame video and four
   text requests through 2 slots): equal greedy tokens card against CPU for
   PagedEngine (P1), PagedEngine with int8 KV pages (P2) and
   ContinuousEngine, and paged against the bucket Engine on the card;
3e. the captured decode at reduced depth in bf16: replay against the eager
   loop (the loop functions' capture=False, `eager_decode` for PagedEngine)
   for Engine at G = 1, the G-way decode in bf16 (D2), over int8 weights and
   int8 KV (D2, Q2), over int4 weights and int8 KV (D2, Q1) and with LoRA
   side adapters over an int8 fused base and int8 KV (D2, no Q2),
   PagedEngine with bf16 pages (P1), with int8 weights and pages (P2, Q2)
   and with side adapters over bf16 pages (P1): greedy tokens and the KV
   written bit-equal, two sampled (T = 1.0) captured runs equal (their
   equality with the eager draws reported), and one replayed step's
   launches of each kernel by name (torch.profiler) equal to its per-layer
   count x 2 layers; the two LoRA cases then take a second adapter set,
   whose replay must equal its eager run and change the tokens;
3f. the evaluation entry point at reduced depth: `cli.evaluate.main` on the
   card and on the CPU from one native checkpoint, f32, two items of phase
   9's clip through Engine, PagedEngine and ContinuousEngine: equal jsonl
   records (greedy output_text, pred, target, qid), K1-K3 and P1 on their
   FMA kernels only;
4. the serving path at full size: Qwen2.5-VL-3B in bf16 with seeded random
   weights, two video requests, greedy decode of 128 tokens, with K1-K3's
   launch counts read around that one generate() call (exactly 36 K1, 28 K2
   and 4 K3 launches, all on the tensor cores);
5. the training path at full size: `GRPOTrainer` over the same model and a
   reference copy, one 32-frame video request, the default TrainConfig (G = 8,
   200 new tokens at T = 1.0, gradient accumulation 2), two `step_batch` calls
   (one optimizer update), with every kernel's launch count read around each;
   the G-way rollout decode runs D2 (36 launches per step, D1 none); each
   call runs exactly 108 K1 launches (rollout prefill, ref_logps, the loss),
   28 K2, 4 K3, 36 B1 and 72 B2 (prompt and own chunk), 72 S1 (ref_logps and
   the loss), 36 + 36 S2 (dq, prefix dK/dV) and 36 D2 a decode step, all on
   the tensor cores;
6. quantized rollouts at full size, once phase 5's model is freed: two
   `step_batch` calls with rollout_quantization="int8" (D2 and Q2 36 launches
   per decode step, D2 on the tensor cores over the int8 caches), then one
   `Engine(quantization="int4", kv_cache_quant=True).generate` at G = 8, 200
   tokens (Q1 144 and D2 36 per step, all on the tensor cores);
7. continuous-batching serving at full width and SERVE_LAYERS (4) decoder
   layers, once phase 6's model is freed: 12 requests (phase 4's two videos, ten text prompts of 200-1800 tokens),
   128 greedy tokens each, through 4 slots with 1024-token prefill chunks:
   PagedEngine (P1 on every decode step), PagedEngine with int8 weights and
   int8 KV pages (P2, Q2) and ContinuousEngine, every launch count checked;
8. the host input path at full size, once phase 7's model is freed: seeded
   raw uint8 frames at 360x640 stand in for the decoder (no video and no
   FFmpeg development files on the card's machine; the decode is held against
   the JAX package on the CPU), then the port's plan_frame_window,
   plan_video_shapes and resize_frames_bicubic, as fetch_video calls them,
   and its Qwen25VLProcessor over a character-level stand-in tokenizer on the
   3B's special ids: the resize on the card with TF32 requested (at most 1
   gray level off the host's, on under 1e-3 of the pixels), a 32 s clip at
   10 fps (64 frames at 196x392, 3136 video tokens) served through the
   trainer's engine at bucket 4096, greedy, 128 tokens, and two
   `step_batch([example])` calls with requests=None on a 4 s clip at 30 fps
   (8 frames at 364x644, 1196 video tokens, bucket 2048), prepare_requests
   inside host_preproc, the same requests prepared meanwhile on a worker
   thread and held bit-equal against a serial call; launch counts as in
   phase 5 (`step_batch_tc_launches`), all on the tensor cores;
9. a GRPO run from the command line, once phase 8's model is freed (it
   writes up to 26 GB under TMPDIR and refuses to start with less free):
   (a) Qwen2.5-VL-3B's seeded weights at CLI_LAYERS (2) decoder layers
   (phases 10 and 12 (d) too; launch counts below are at 36: L / 36 of
   them) through `save_hf_checkpoint` and `load_checkpoint`, bit-equal, with
   a config.json that reads back as written; (b)
   `time_r1_tpu_torch.cli.train.main` on that checkpoint
   with the CLI's defaults (remat "full", a reference copy), one epoch of 4
   examples of phase 8's 4 s clip (`Qwen25VLProcessor.from_pretrained`
   patched to StandInTokenizer, the decode to phase 8's frames): per
   `step_batch` exactly 144 K1, 108 S1 (phase 5's 108 and 72, and the loss's
   forward rerun in the backward), 36 B1, 72 B2, 36 + 36 S2, 28 K2, 4 K3
   and 36 D2 a decode step, all on the tensor cores; the lr of each update
   against the schedule, trainer_state.json, the epoch and final
   checkpoints, the final one reloaded bit-equal; (e) remat off and on in
   turns on that trainer; (c) at 3B widths and 2 decoder layers, a run
   saved with --save_only_model false and resumed from its native
   checkpoint (params, moments, accumulation, counts and global_step
   bit-equal; stopped at resumed + quota); (d) phase 3b's split batch in
   bf16 under each remat policy against none;
10. the TimeRFT sample-filtering loop, once phase 9's model is freed (it
   writes up to 32 GB under TMPDIR and deletes it): (a) one round of
   `time_r1_tpu_torch.cli.train_sf.main` on Qwen2.5-VL-3B from a native
   base checkpoint, the recipe's "0070_all", 4 examples of phase 9's clip
   (train for one early-stopped epoch, the smallest checkpoint, its
   self-eval through `cli.evaluate`, the difficulty merge, the filter):
   each stage's wall seconds, the eval's vision ms, prefill ms, decode
   ms/step and items/s, checkpoint load GB/s and the peak; per `step_batch`
   phase 9's launches, per eval item exactly 28 K2, 4 K3 and 36 K1 a
   prefill chunk, all on the tensor cores, summing to the round's; (b) two
   rounds at 3B widths with 2 decoder layers and "random_sample": round 1
   trains from round 0's smallest checkpoint on round 0's filtered json;
11. LoRA GRPO on Qwen2.5-VL-7B at LORA_7B_LAYERS (4) decoder layers (the
   counts below are at 28: L / 28 of them) over an int8 base, once phase
   10's model is freed (it writes up to 40 GB under TMPDIR and deletes it):
   (a) seeded bf16 7B weights through `save_hf_checkpoint`, then `cli.train.main` with
   the JAX package's single-chip 7B flags (`LORA_7B_FLAGS`: --use_peft
   --lora_r 16 --lora_alpha 32 --train_base_quantization int8
   --rollout_quantization int8, remat, fix_vit, G = 8, 200 tokens,
   accumulation 2) on 2 examples of phase 8's 4 s clip: the quantize pass
   (seconds, peaks), per `step_batch` exactly K1 112, S1 84, B1 28, B2 56,
   S2 28 + 28, K2 28, K3 4 and D2 28 a decode step, Q2 none (side adapters),
   all on the tensor cores, the base bit-unchanged, an adapter moved, the
   weight sync an adapter install under 50 ms, the saves (the int8 base and
   `lora_adapters.npz`) reloaded equal; (b) at 2 layers a bf16 base with
   int8 rollouts: the layer-at-a-time merge and quantize bit-equal to the
   whole tree's, Q2 on it; (c) at 2 layers a LoRA run resumed from its
   checkpoint equal bit for bit to an uninterrupted one;
12. full-parameter GRPO on Qwen2.5-VL-7B with the optimizer state in
   page-locked host memory, once phase 11's model is freed (it writes up to
   26 GB under TMPDIR and deletes it): (a) seeded bf16 7B weights and a
   reference copy under `GRPOTrainer` with offload_optimizer, remat, int8
   rollouts, beta 0.04, G = 8, 200 tokens, accumulation 2, 4 step_batch
   calls on 2 examples of phase 8's 4 s clip: MemAvailable above the state's
   bytes plus 8 GiB before it is pinned, what PyTorch's pinned allocator
   takes for a quarter of one tree's bytes (in a process of its own), then every
   offloaded leaf pinned
   with exactly its bytes, the peak under 79 GiB, a decoder weight moved and
   the ViT unchanged, per call exactly K1 112, S1 84, B1 28, B2 56, S2 28 +
   28, K2 28, K3 4, D2 and Q2 28 a decode step, all on the tensor cores; each
   update's streamed GB and GB/s; (b) at 2 layers of the 7B's widths, offload
   on against off over 4 micro-steps, bit-equal, for full parameters and for
   LoRA over the full-row loss; (c) the full-row loss
   (shared_prefix_loss=False) on the 3B at FULL_ROW_LAYERS (12) under remat:
   per call K1 4, B1 1 and B2 1 a layer, no S1 or S2, its train_step beside the split loss's on the same
   request, and at 2 layers in f32 the two losses and their gradients
   agreeing; (d) `cli.finetune.main` on the 3B (--beta 0.0 --use_grpo
   false) from `video.npz` files that `cli.preprocess_videos` wrote, the
   decoder never called, one update, a save;
13. data and context parallelism (`time_r1_tpu_torch/parallel/`), the ranks
   processes over gloo on the first card, given torchrun's environment
   variables after this process built the kernels (one pool of rank
   processes serves every spawn of phases 13-17, each job in a process group
   of its own: `RankPool`; the 3B of phases 13-16 has MESH_VISION_DEPTH (8)
   vision blocks, `mesh_3b`), a rank that fails or hangs failing the phase
   (`spawn_ranks`, `parallel_rank`): (a)
   ring attention over 2 and 4 ranks, contiguous and zig-zag causal and
   contiguous non-causal, bf16 and f32, at phase 2's full-row shape and at
   the 7B's heads (28 over 4), each rank's out, lse, dq, dk and dv against
   one call's K1 and B1/B2 over the whole sequence (bf16 at GRAD_TOL, f32 at
   1e-5 of max |one call|), K1, B1 and B2 launched exactly r + 1 (contiguous
   causal), n (non-causal) or 2n + 1 (zig-zag) times a rank, on the tensor
   cores in bf16, and in bf16 the ring's fwd+bwd time on each rank beside
   one call's and the bytes staged through host memory; (b) the
   context-parallel GRPO loss of Qwen2.5-VL-3B over 2 ranks (zig-zag, remat
   "full", phase 12 (c)'s request with 8 fixed completions, full rows
   padded to 512): one process's loss and gradients first, freed before the
   ranks start; the ranks' loss, metrics and every gradient against them at
   CP_LOSS_LAYERS in bf16 and at 2 layers in f32, K1 15 and B1, B2 5 a layer on
   each rank, each rank's peak; (c) at DP_LAYERS decoder layers of the 3B, a
   data-parallel `step_batch` on each of 2 ranks (its own example of phase
   8's clip, its own rollouts; the trainer FSDP over the two ranks, its
   optimizer state offloaded to arenas that pin each rank's blocks only)
   against one process's over both examples with
   the ranks' completions replayed (loss, gathered metrics, the update), then
   `cli.train.main` with --context_parallel_size 2 for 2 steps and its
   saves (B1 and B2 5 a layer a step on each rank). Where the machine shows
   two cards or more, (a) (over as many ranks as cards, up to 4) and (c) run
   again over NCCL, a card a rank, nothing staged;
14. sharded training (`parallel/sharding.py`, `fsdp.py`, `tensor.py`), 2
   ranks over gloo on the first card, as phase 13's: (d) the 3B's split GRPO
   loss step under remat "full" with a reference copy (beta 0.04), at
   SHARDED_LAYERS decoder layers in bf16 and 2 in f32, as FSDP (mesh 2x1, a
   group on each data rank) and as TP (1x2, 8 q over 1 kv head and 8 vision
   heads a rank), against one process's (computed first): the loss, metrics
   and every gradient gathered leaf by leaf (CP_BF16_TOL in bf16, the CPU
   tests' f32 tolerances), K1 and S1 3, B1 1, B2 2, S2 1 + 1 a layer and
   K2 28, K3 4 on each rank at its local heads, each rank's peak and the
   bytes staged through host memory; (e) at STEP_LAYERS layers: a TP
   `step_batch` with int8 rollouts (the gathered, quantized rollout copy
   bit-equal to one process's engine; D2 and Q2 a layer a decode step on
   model-rank 0 only; the ranks' rows, loss and weights equal) against one
   process's with the completions replayed (the gradient, through the first
   moments), and `cli.train.main --tensor_parallel_size 2` for 2 steps. Phase 2
   first holds K1, B1, B2, S1 and S2 at 8 q over 1 kv head and 7 over 1,
   and K2/K3 at 8 and 4 heads of 80. Where the machine shows two cards or
   more, (d) and (e) run again over NCCL;
15. generation over a mesh (`Engine(shard=...)`, `parallel/pipeline.py`),
   2 ranks over gloo on the first card, as phase 14's, after one process's
   references (its decode eager, as the mesh's): (a) the TP Engine over
   make_mesh(2) (8 q over 1 kv head, 8 vision heads and half the MLP width
   a rank) and (b) PPEngine over 2 stages (stage 0 the vision tower, the
   embedding, the head and 3 of 6 layers), each on phase 4's two video
   requests at G = 1 and the first at G = 8 (the TP Engine's shared-prefix
   decode, D2; PPEngine's expanded rows), and int8 weights (the TP Engine
   at G = 8 with the int8 KV cache, D2 and Q2; PPEngine at G = 1, Q2),
   MESH_NEW_TOKENS (16) greedy tokens, Qwen2.5-VL-3B at MESH_LAYERS (2) decoder layers in bf16
   and at 2 layers and 4 vision blocks in f32: the launches of K1, K2, K3,
   D2 and Q2 on each rank by the formula (`mesh_launches`), tensor-core in
   bf16, FMA in f32; the ranks' tokens equal; in f32 PPEngine's tokens and
   the TP Engine's without int8 equal one process's, every f32 prefill's
   logits within MESH_F32_TOL; the bf16 runs' logits within MESH_LOGIT_TOL
   of one process's where the prefixes agree, the f32 TP Engine's over int8
   within MESH_INT8_F32_TOL, the tokens that agree counted (in f32 the TP
   Engine also runs over int8 weights with an f32 KV cache, its tokens
   held: a witness that Q2's bf16 rounding, not the int8 KV cache, turns
   TP's f32 summation order into whole steps); decode
   ms a step, GB staged, the peak and the weights a rank holds; (c) at 3B widths and 2 layers in f32,
   `cli.evaluate.main` with --tensor_parallel_size 2 and with
   --pipeline_parallel_size 2, records equal to one process's, and
   `cli.demo.main --pipeline_parallel_size 2`, its answer one process's.
   Phase 2 first holds D2 at 8 q over 1 kv head and 7 over 1 (bf16 and int8
   caches, bf16 and f32) and Q2 at the 3B's tp-2 widths (hid 2048, inter
   5504) and the 7B's tp-4 (3584, 4736), M 1 and 8, and the sum of Q2 over
   each rank's block of a whole quantized MLP against Q2 over the whole one
   in f32 within Q2_PARTIAL_TOL (`tp_decode_quant_cases`).
   Where the machine shows two cards or more, (a)-(c) run again over NCCL.
   `scripts/check_parallel.py g`, 4 cards only: Qwen2.5-VL-7B at full depth
   served over NCCL at tp 4, 4 stages and 2x2, against one card's: at full
   depth in bf16 its prefill and decode logits where the prefixes agree
   within SEVEN_B_LOGIT_TOL; at SEVEN_B_F32_LAYERS in f32 its tokens equal
   and every logit within MESH_F32_TOL;
16. continuous batching over a mesh, in phase 15's spawn, after one
   process's references (eager): over make_mesh(2) `PagedEngine` with a
   bf16 pool (P1) and with int8 weights and int8 pages over a TP Engine's
   serving tree (P2, Q2), `ContinuousEngine` (its `mha_cached` step) on
   phase 7's stream cut to 8 requests (in f32 its first 8 text requests;
   4 slots, pages of 128, 1024-token prefill chunks), and the TP Engine over int4 weights at G = 1 and 8 (Q1
   at the rank's widths, D2) on the stream's first two text requests, MESH_NEW_TOKENS greedy tokens,
   Qwen2.5-VL-3B at CMESH_LAYERS (2) in bf16 and 2 layers in f32: the
   launches on each rank by the formula (`cmesh_launches`), the ranks'
   tokens equal, the f32 bf16-pool and slot engines' tokens equal one
   process's, every f32 admission's prefill logits within MESH_F32_TOL, the
   logits within MESH_LOGIT_TOL (bf16) or CMESH_F32_LIMITS (f32 over
   quantized weights) where the prefixes agree (`pick_errors`); (e)
   `cli.evaluate.main --tensor_parallel_size 2` with `scripts/test.sh`'s
   continuous int8 flags (CMESH_CLI_TP) and `--pipeline_parallel_size 2
   --use_continuous_batching` at 2 layers in f32, records equal to one
   process's. Phase 2 first holds P1 and P2 at 8 and 7 q over 1 kv head and
   Q1 at the 3B's tp-2 and the 7B's tp-4 products (`tp_paged_q1_cases`).
   `scripts/check_parallel.py i`, 4 cards only: Qwen2.5-VL-7B at full depth
   through `cli.evaluate` at tp 4 over NCCL with `scripts/test.sh`'s eval
   flags, int8 and int4, against one card's records;
17. tensor parallelism past the kv heads: 4 ranks over gloo on the first
   card, Qwen2.5-VL-3B at KVREP_LAYERS (2) decoder layers and its whole
   vision tower at tp 4, so that each of its 2 kv heads is replicated on 2
   ranks (4 q heads over the rank's 1 kv head, 4 vision heads), after one
   process's references (eager): (a) the TP Engine on two text requests
   and an 8-frame video at G = 1 (K1, K2, K3), on the two texts at G = 8
   (D2) and in f32 (FMA, the tokens equal one process's), (b) PagedEngine
   over int8 weights and int8 pages on four texts (P2, Q2 at inter 2752),
   KVREP_NEW_TOKENS greedy tokens: the launches by the formula
   (`kvrep_launches`) on each rank, the ranks' tokens equal, the bf16
   logits within MESH_LOGIT_TOL where the prefixes agree; (c) one bf16
   `step_batch` over a 1x4 mesh (DP_TOKENS a rollout): its launches by the
   formula, the loss, the gradient and the k/v leaves' gradient against one
   process's with the completions replayed, the k/v blocks bit-equal within
   each replica pair after the update. Phase 2 first holds K1, B1, B2, S1,
   S2, D2, P1 and P2 at 4 and 2 q over 1 kv head, K2/K3 at 2 heads, Q1 at
   the 3B's tp-4 products (down's K 2752 on the FMA kernel) and Q2 at inter
   2752 and 1376. `scripts/check_parallel.py j`, 4 cards only: the 3B at
   full depth through `cli.evaluate` (test.sh's flags) and `cli.train` at
   tp 4 over NCCL against one card's, then tp 8 over 8 gloo ranks on the
   first card;
18. the parity harness against HF transformers at full width: for
   Qwen2.5-VL-3B (tied head) and -7B (untied) at PARITY_LAYERS (2) decoder
   layers and PARITY_VISION_DEPTH (8) vision blocks (blocks 0-6 windowed,
   block 7 full), `Qwen2_5_VLForConditionalGeneration` initialised by
   transformers after a seed and written by `save_pretrained` in bf16
   (`hf_parity_checkpoint`), then `time_r1_tpu_torch.cli.parity.main` with
   --skip_demo --skip_benchmark on the card: activations "pass" (each
   layer, the logits within the harness's atol/rtol; "skip" fails), every
   layer's max |diff| printed, the bf16 argmax agreement, K2 7 and K3 1
   launches on the FMA kernels in the f32 forward and on the tensor cores
   in the bf16 one, K1 none (the prompt's 55 tokens are no multiple of
   128). `scripts/check_parity.py b`: both at full depth through `python -m
   time_r1_tpu_torch.cli.parity`.

From phase 3 on, every `Engine` and `PagedEngine` decode on the card is a
captured CUDA graph replayed once a step (`time_r1_tpu_torch/sampler/graph.py`;
ContinuousEngine stays eager), and the launch checks read the wrappers'
counters, which each replay advances by what its capture recorded. Phases 4,
5, 6 and 7 (a), (b) also time their decode eagerly and captured in turns
(4-6 over TURN_TOKENS a row, 7 over its stream);
phase 5 profiles 16 steady rollout steps of each (the device's idle share,
D2's launches by name).

The kernels' entries for K1, B1 and B2 also give phase 13 (b)'s launches
on each rank of the 3B's context-parallel loss step, and those of K1-K3, B1,
B2, S1 and S2 phase 14 (d)'s on rank 0 of each mesh
(`launches_sharded_loss_per_rank`); those of K1-K3, D2 and Q2 phase 15's in
each bf16 run of the TP Engine and of PPEngine, [rank 0, rank 1]
(`launches_tp_engine`, `launches_pp_engine`); those of K1-K3, P1, P2, Q1,
Q2 and D2 phase 16's, [rank 0, rank 1] (`launches_tp_paged`,
`launches_tp_continuous`, `launches_tp_int4`); those of phase 17's bf16
runs and step, [rank 0, ..., rank 3] (`launches_kv_replicated`); those of
K2 and K3 phase 18's, by model (`launches_parity`, `tc_launches_parity`);
and D2's,
Q2's, P1's, P2's and Q1's their TP-local cases under their tags.

The last three lines are the card's name and power limit (nvidia-smi), the
kernels JSON line and the result JSON line; the line before them gives the
script's total seconds. Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores (the FMA kernels)
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |kernel - plain| on valid rows
LOGIT_TOL = 2e-3  # phase 3: f32 last-position logits, card vs CPU


T0 = time.perf_counter()  # the process's start: every log line gives the seconds since


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}] {msg}", flush=True)


SPIN_CYCLES_PER_S = 2.0e9  # about the H100's SM clock; a longer spin than needed costs only time


def cuda_ms(fn, iters: int = 10, queued: bool = True) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events, after a
    warm-up). Queued: the launches wait behind a GPU spin that outlasts the
    host's time to issue them, so the events time the device work back to back
    and not the Python that issues it (a 20 us kernel behind a 100 us wrapper).
    queued=False times the calls as a caller issues them, host gaps included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(2.0 * iters * (time.perf_counter() - t0), 1.0) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak_flops: float = None) -> tuple[float, str]:
    """The larger of the operations' time at `peak_flops` (bf16's tensor-core
    peak unless given) and the bytes' at the memory rate, in ms."""
    t_ops, t_bytes = flops / (peak_flops or PEAK_BF16_FLOPS) * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1
def phase_build() -> None:
    import ctypes

    from time_r1_tpu_torch import kernels

    t0 = time.perf_counter()
    logs = kernels.build()
    log(f"[build] {len(logs)} sources rebuilt in {time.perf_counter() - t0:.1f} s")
    for stem, text in logs.items():
        func = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build] {stem} {func}: {line.strip()}")
    smem = kernels.bind("flash_attention_bwd", "t1_flash_bwd_tc_smem_bytes", [ctypes.c_int])
    log(f"[build] flash_attention_bwd tensor-core blocks (B1, B2, S2): dynamic shared memory "
        f"{smem(64)} bytes at head dim 64, {smem(128)} at 128")
    smem = kernels.bind("shared_prefix_attention", "t1_sp_fwd_tc_smem_bytes", [ctypes.c_int])
    log(f"[build] shared_prefix_attention tensor-core S1 blocks: dynamic shared memory "
        f"{smem(64)} bytes at head dim 64, {smem(128)} at 128")
    for stem, symbol, what in (("flash_attention", "t1_flash_attention_fwd_tc_smem_bytes", "K1"),
                               ("vision_attention", "t1_window_attention_rope_fwd_tc_smem_bytes",
                                "K2 (a window, its cos/sin staged once)"),
                               ("vision_attention", "t1_full_attention_rope_fwd_tc_smem_bytes", "K3 (with the rope)")):
        smem = kernels.bind(stem, symbol, [ctypes.c_int])
        log(f"[build] {stem} tensor-core {what} blocks: dynamic shared memory "
            f"{smem(64)} bytes at head dim 64, {smem(80)} at 80, {smem(128)} at 128")
    smem = kernels.bind("fused_mlp", "t1_fused_mlp_smem_bytes", [ctypes.c_int, ctypes.c_int])
    log(f"[build] fused_mlp Q2 blocks: dynamic shared memory {smem(8, 2048)} / {smem(8, 3584)} bytes at hid "
        f"2048 / 3584 and M <= 8, {smem(16, 2048)} / {smem(16, 3584)} above")
    smem = kernels.bind("decode_attention", "t1_decode_full_tc_smem_bytes", [ctypes.c_int, ctypes.c_int])
    log(f"[build] decode_attention tensor-core D2 blocks: dynamic shared memory {smem(0, 64)} / {smem(0, 128)} "
        f"bytes at head dim 64 / 128 over bf16 caches, {smem(1, 64)} / {smem(1, 128)} over int8")
    smem = kernels.bind("paged_attention", "t1_paged_tc_smem_bytes", [ctypes.c_int] * 4)
    log(f"[build] paged_attention tensor-core P1 / P2 blocks at 32 chunks of 1-4 tiles: dynamic shared memory "
        f"{[smem(0, 128, ct, 32) for ct in (1, 2, 4)]} / {[smem(1, 128, ct, 32) for ct in (1, 2, 4)]} bytes at "
        f"head dim 128, {[smem(0, 64, ct, 32) for ct in (1, 2, 4)]} / {[smem(1, 64, ct, 32) for ct in (1, 2, 4)]} "
        f"at 64")
    smem = kernels.bind("int4_matmul", "t1_int4_matmul_tc_smem", [ctypes.c_int, ctypes.c_int])
    for M in (8, 16):
        shapes = [f"K {K}: {smem(M, K) >> 20} x {'whole-row' if K <= 4096 else 'segment'} stages, "
                  f"{smem(M, K) & 0xFFFFF} bytes" for K in (2048, 3584, 11008, 18944)]
        log(f"[build] int4_matmul tensor-core Q1 blocks at M {'<= 8' if M == 8 else '> 8'}: {'; '.join(shapes)}")


# ---------------------------------------------------------------------------
# phase 2
def serving_grids():
    return [(16, 16, 28), (12, 20, 24)]  # 32 frames 224x392, 24 frames 280x336


def check_kernel(name, kernel, plain, library, make_inputs, valid, flops, nbytes, timed=True):
    """Kernel vs plain version in bf16 and f32 on the same inputs (the plain
    version computes in f32 on the kernel's inputs); times in bf16."""
    import torch

    def upcast(a):
        return a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a

    entry = {"name": name}
    for dtype in (torch.bfloat16, torch.float32):
        args = make_inputs(dtype)
        got = kernel(*args)
        want = plain(*[upcast(a) for a in args])
        torch.cuda.synchronize()
        err = (got.float() - want.float())[valid].abs().max().item()
        key = str(dtype).split(".")[-1]
        if not np.isfinite(err) or err > TOL[key]:
            raise AssertionError(f"{name} {key}: max |kernel - plain| = {err} > {TOL[key]}")
        entry["max_abs_err" if dtype is torch.bfloat16 else "max_abs_err_f32"] = err
        log(f"[kernels] {name} {key}: max |kernel - plain| on valid rows = {err:.3e} (tol {TOL[key]})")
        if dtype is torch.bfloat16 and timed:
            entry["ms"] = entry["kernel_ms"] = cuda_ms(lambda: kernel(*args))
            entry["plain_ms"] = cuda_ms(lambda: plain(*args), iters=3)
            lib = library(*args)
            entry["library_ms"] = cuda_ms(lib)
            entry["bound_ms"], entry["bound_by"] = bound(flops, nbytes)
            entry["tflops"] = flops / entry["ms"] / 1e9
            entry["bound_share"] = entry["bound_ms"] / entry["ms"]
            log(f"[kernels] {name}: {entry['ms']:.4f} ms (plain {entry['plain_ms']:.3f}, bound "
                f"{entry['bound_ms']:.4f} by {entry['bound_by']}, {entry['tflops']:.1f} TFLOP/s, "
                f"{100 * entry['bound_share']:.1f}% of the bound, library {entry['library_ms']:.4f})")
    entry["tol"], entry["tol_f32"] = TOL["bfloat16"], TOL["float32"]
    return entry


def phase_kernels() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = serving_attention_kernels(gen)
    vision_local_head_cases(gen, results)
    fwd_tc_edge_cases(gen, results["flash_attention"], results["full_attention_rope"])
    results.update(phase_train_kernels())
    attention_7b_cases(results)
    full_row_attention_cases(gen, results)
    results.update(phase_decode_quant_kernels())
    tp_decode_quant_cases(torch.Generator(device="cuda").manual_seed(9), results)
    results.update(phase_paged_kernels())
    tp_paged_q1_cases(torch.Generator(device="cuda").manual_seed(11), results)
    return results


def serving_attention_kernels(gen) -> dict:
    """K1, K2 and K3 against their plain versions at the serving path's
    shapes (phase 4), in bf16 (the tensor-core kernels) and f32 (FMA); times
    in bf16."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain
    from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, full_attention_rope_plain

    dev = torch.device("cuda")
    results = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # K1 at the prefill shape of phase 4: two left-padded prompts in a
    # 2048-token bucket, a 2176-slot cache (128 decode slots)
    B, Sq, Skv, H, Hkv, D = 2, 2048, 2176, 16, 2, 128
    for q_offset in (0, 128):
        kv_bias, valid, allowed, flops, nbytes = k1_work(B, Sq, Skv, H, Hkv, D, True, q_offset, (134, 486))

        def inputs(dtype, q_offset=q_offset, kv_bias=kv_bias):
            q, k, v = randn(B, Sq, H, D, dtype=dtype), randn(B, Skv, Hkv, D, dtype=dtype), randn(B, Skv, Hkv, D, dtype=dtype)
            return q, k, v, kv_bias, True, None, q_offset

        entry = check_kernel(
            "flash_attention", lambda *a: flash_attention_fwd(*a)[0],
            lambda *a: flash_attention_plain(*a)[0], k1_library(valid, allowed), inputs, valid,
            flops=flops, nbytes=nbytes, timed=q_offset == 0,
        )
        if q_offset == 0:  # the main path's shape: the entry that is timed
            results["flash_attention"] = entry
        else:  # the second chunk of a chunked prefill: checked, not timed
            results["flash_attention"][f"q_offset_{q_offset}"] = {
                k: entry[k] for k in ("max_abs_err", "max_abs_err_f32")
            }

    # K2 and K3 on the padded-window layout of the two phase-4 videos
    results.update(window_kernel(gen))
    vcfg, prep, _, cos, sin, key_bias = serving_vision_inputs()
    nh, hd = vcfg.num_heads, vcfg.head_dim
    n_slices, S = prep.full_gather.shape
    fg = torch.from_numpy(prep.full_gather).to(dev).long()
    pad = fg < 0
    fgs = fg.clamp_min(0).reshape(-1)
    full_bias = (key_bias[fgs].reshape(n_slices, S) + torch.where(pad, NEG_INF, 0.0)).contiguous()
    cos_f, sin_f = cos[fgs].reshape(n_slices, S, hd), sin[fgs].reshape(n_slices, S, hd)
    per_slice = (full_bias == 0).sum(1).double()
    live_f = (full_bias == 0).sum().item()  # live rows; -1 sentinels and dead patches excluded
    fbytes = 4 * live_f * nh * hd * 2 + 2 * live_f * hd * 4 + n_slices * S * 4

    def full_inputs(dtype):
        shape = (n_slices, S, nh, hd)
        return randn(*shape, dtype=dtype), randn(*shape, dtype=dtype), randn(*shape, dtype=dtype), cos_f, sin_f, full_bias

    def full_library(q, k, v, cos, sin, bias):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = bias[:, None, None, :].to(q.dtype)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    results["full_attention_rope"] = check_kernel(
        "full_attention_rope", full_attention_rope, full_attention_rope_plain, full_library,
        full_inputs, full_bias == 0, flops=4.0 * (per_slice**2).sum().item() * nh * hd, nbytes=fbytes,
    )
    return results


def vision_local_head_cases(gen, results: dict) -> None:
    """K2 and K3 at phase 14's TP-local vision heads (TP_VISION_HEADS of dim
    80, on the two phase-4 videos' layout) against their plain versions in
    bf16 and f32, timed in bf16 beside their bound and one SDPA call; each
    written to its kernel's entry as "tp_heads_<nh>"."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops.vision_attention import (
        full_attention_rope,
        full_attention_rope_plain,
        window_attention_rope,
        window_attention_rope_plain,
    )

    dev = torch.device("cuda")
    vcfg, prep, key_valid, cos, sin, key_bias = serving_vision_inputs()
    hd = vcfg.head_dim
    win = vcfg.window_patches**2 * vcfg.merge_unit
    P = key_valid.shape[0]
    per_win = key_valid.reshape(-1, win).sum(1).double()
    live = key_valid.sum().item()
    n_slices, S = prep.full_gather.shape
    fg = torch.from_numpy(prep.full_gather).to(dev).long()
    fgs = fg.clamp_min(0).reshape(-1)
    full_bias = (key_bias[fgs].reshape(n_slices, S) + torch.where(fg < 0, NEG_INF, 0.0)).contiguous()
    cos_f, sin_f = cos[fgs].reshape(n_slices, S, hd), sin[fgs].reshape(n_slices, S, hd)
    per_slice = (full_bias == 0).sum(1).double()
    live_f = (full_bias == 0).sum().item()
    for nh in TP_VISION_HEADS:
        def win_inputs(dtype, nh=nh):
            return tuple(torch.randn(P, nh, hd, generator=gen, device=dev).to(dtype) for _ in range(3)) + (
                cos, sin, key_bias, win)

        def win_library(q, k, v, cos, sin, key_bias, win, nh=nh):
            qt, kt, vt = (t.reshape(-1, win, nh, hd).transpose(1, 2) for t in (q, k, v))
            mask = key_bias.reshape(-1, 1, 1, win).to(q.dtype)
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        def full_inputs(dtype, nh=nh):
            return tuple(torch.randn(n_slices, S, nh, hd, generator=gen, device=dev).to(dtype)
                         for _ in range(3)) + (cos_f, sin_f, full_bias)

        def full_library(q, k, v, cos, sin, bias):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias[:, None, None, :].to(q.dtype))

        results["window_attention_rope"][f"tp_heads_{nh}"] = check_kernel(
            f"window_attention_rope at {nh} heads", window_attention_rope, window_attention_rope_plain, win_library,
            win_inputs, key_valid, flops=4.0 * (per_win**2).sum().item() * nh * hd,
            nbytes=4 * live * nh * hd * 2 + 2 * live * hd * 4 + P * 4)
        results["full_attention_rope"][f"tp_heads_{nh}"] = check_kernel(
            f"full_attention_rope at {nh} heads", full_attention_rope, full_attention_rope_plain, full_library,
            full_inputs, full_bias == 0, flops=4.0 * (per_slice**2).sum().item() * nh * hd,
            nbytes=4 * live_f * nh * hd * 2 + 2 * live_f * hd * 4 + n_slices * S * 4)


def serving_vision_inputs():
    """The two phase-4 videos' padded-window layout on the card: (vision
    config, prepared inputs, key_valid (P,), cos, sin (P, hd), key_bias (P,))."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, prepare_vision_inputs
    from time_r1_tpu_torch.models.qwen25vl.vision import vision_rope_tables
    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    vcfg = Qwen25VLConfig.qwen25vl_3b().vision
    prep = prepare_vision_inputs(serving_grids(), vcfg)
    key_valid = torch.from_numpy(prep.key_valid).to(dev)
    cos, sin = vision_rope_tables(vcfg, torch.from_numpy(prep.pos_hw).to(dev))
    return vcfg, prep, key_valid, cos, sin, torch.where(key_valid, 0.0, NEG_INF).float()


def window_kernel(gen) -> dict:
    """K2 against its plain version at the serving path's shape (phase 4's
    two videos: 236 windows of 64 rows, 16 heads of 80), in bf16 (the
    tensor-core kernel) and f32 (FMA), timed in bf16; then K2_TC_CASES and
    the refusals."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.vision_attention import window_attention_rope, window_attention_rope_plain

    dev = torch.device("cuda")
    vcfg, _, key_valid, cos, sin, key_bias = serving_vision_inputs()
    nh, hd = vcfg.num_heads, vcfg.head_dim
    win = vcfg.window_patches**2 * vcfg.merge_unit
    P = key_valid.shape[0]
    per_win = key_valid.reshape(-1, win).sum(1).double()
    # Bytes over live rows only, as the FLOPs count live (query, key) pairs:
    # q/k/v read and out written in bf16, cos/sin read in f32, and the bias
    # of every row read once. Dead rows are never keys and their outputs are dropped.
    live = key_valid.sum().item()
    vbytes = 4 * live * nh * hd * 2 + 2 * live * hd * 4 + P * 4

    def win_inputs(dtype):
        return tuple(torch.randn(P, nh, hd, generator=gen, device=dev).to(dtype) for _ in range(3)) + (
            cos, sin, key_bias, win)

    def win_library(q, k, v, cos, sin, key_bias, win):
        qt, kt, vt = (t.reshape(-1, win, nh, hd).transpose(1, 2) for t in (q, k, v))
        mask = key_bias.reshape(-1, 1, 1, win).to(q.dtype)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    entry = check_kernel(
        "window_attention_rope", window_attention_rope, window_attention_rope_plain, win_library,
        win_inputs, key_valid, flops=4.0 * (per_win**2).sum().item() * nh * hd, nbytes=vbytes,
    )
    k2_tc_edge_cases(gen, entry)
    return {"window_attention_rope": entry}


# K2 edge cases (bf16, tensor-core kernel): (windows of 64 rows, nh, hd, the
# windows whose keys are all dead); besides, 5% of the other keys are dead
# patches. A dead window's rows must stay finite.
K2_TC_CASES = {
    "head_dim_64": (8, 4, 64, (3,)),
    "head_dim_128": (8, 4, 128, ()),
    "dead_windows": (6, 16, 80, (0, 5)),
}


def k2_tc_edge_cases(gen, entry: dict) -> None:
    """bf16 K2 (the tensor-core kernel) at K2_TC_CASES against its plain
    version (f32 on the same inputs) at TOL, max abs error on live rows,
    every value finite; every launch on the tensor cores; then the wrapper
    must refuse f16, head dim 96, a misaligned q and windows of 128 rows."""
    import torch

    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops.vision_attention import window_attention_rope, window_attention_rope_plain

    dev = torch.device("cuda")
    tol = TOL["bfloat16"]
    entry["cases"] = {}
    n0, tc0 = window_attention_rope.launches, window_attention_rope.tc_launches
    for case, (n, nh, hd, dead_windows) in K2_TC_CASES.items():
        P = 64 * n
        q, k, v = (torch.randn(P, nh, hd, generator=gen, device=dev).bfloat16() for _ in range(3))
        theta = torch.rand(P, hd, generator=gen, device=dev) * 20.0
        dead = torch.rand(P, generator=gen, device=dev) < 0.05
        for w in dead_windows:
            dead[64 * w:64 * (w + 1)] = True
        bias = torch.where(dead, NEG_INF, 0.0).float()
        args = (q, k, v, theta.cos(), theta.sin(), bias, 64)
        out = window_attention_rope(*args)
        want = window_attention_rope_plain(q.float(), k.float(), v.float(), *args[3:])
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"window_attention_rope {case}: non-finite values")
        err = (out.float() - want)[~dead].abs().max().item()
        entry["cases"][case] = err
        log(f"[kernels] window_attention_rope {case}: max |kernel - plain| on live rows = {err:.3e}, every value "
            f"finite (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"window_attention_rope {case}: max |kernel - plain| = {err} > {tol}")
    runs = window_attention_rope.launches - n0
    if window_attention_rope.tc_launches - tc0 != runs:
        raise AssertionError(f"K2 bf16: {runs} launches, {window_attention_rope.tc_launches - tc0} on the tensor cores")
    vq = torch.randn(128, 4, 80, generator=gen, device=dev).bfloat16()
    cs, vb = torch.rand(128, 80, device=dev), torch.zeros(128, device=dev)
    v96 = torch.randn(128, 4, 96, generator=gen, device=dev).bfloat16()
    c96 = torch.rand(128, 96, device=dev)
    refused = {
        "float16": lambda: window_attention_rope(vq.half(), vq.half(), vq.half(), cs, cs, vb, 64),
        "head dim 96": lambda: window_attention_rope(v96, v96, v96, c96, c96, vb, 64),
        "q 2 bytes off 16-byte alignment": lambda: window_attention_rope(misaligned(vq), vq, vq, cs, cs, vb, 64),
        "windows of 128 rows": lambda: window_attention_rope(vq, vq, vq, cs, cs, vb, 128),
    }
    for what, call in refused.items():
        try:
            call()
        except ValueError as e:
            log(f"[kernels] window_attention_rope refuses {what}: {e}")
        else:
            raise AssertionError(f"window_attention_rope took {what}")


def k1_work(B, Sq, Skv, H, Hkv, D, causal, q_offset, pads, elt: int = 2):
    """K1's inputs and work at one shape with left pad keys per batch entry:
    (kv_bias (B, Skv), valid (B, Sq): rows that see a real key, allowed (B,
    Sq, Skv): the (row, key) pairs of valid rows, the FLOPs of those pairs,
    the bytes: live q read, out and lse written, each (entry, key) that a
    valid row reads once, the bias)."""
    import torch

    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    keys = torch.arange(Skv, device=dev)
    pad = torch.tensor(pads, device=dev)
    kv_bias = torch.where(keys[None] < pad[:, None], NEG_INF, 0.0).float()
    last = q_offset + torch.arange(Sq, device=dev) if causal else torch.full((Sq,), Skv - 1, device=dev)
    valid = last[None, :] >= pad[:, None]
    allowed = (keys[None, :] <= last[:, None])[None] & (kv_bias[:, None, :] == 0) & valid[:, :, None]
    live_q = valid.sum().item()
    live_kv = allowed.any(1).sum().item()
    nbytes = (2 * live_q * H * D + 2 * live_kv * Hkv * D) * elt + B * Skv * 4 + live_q * H * 4
    return kv_bias, valid, allowed, 4.0 * allowed.sum().item() * H * D, nbytes


def k1_library(valid, allowed):
    """The yardstick for K1: one SDPA call with the same mask (rows that see
    no key attend to every key)."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.attention import NEG_INF

    def library(q, k, v, kv_bias, causal, scale, q_offset):
        mask = torch.where(allowed | ~valid[:, :, None], 0.0, NEG_INF).to(q.dtype)[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    return library


# K1 edge cases (bf16, tensor-core kernel): (B, Sq, Skv, H, Hkv, D, causal,
# q_offset, left pad keys per batch entry). The first two are phase 4's
# prefill at both chunk offsets; `train_B1` is phase 5's prompt forward
# (timed: the K1 row's B = 1 time); a batch entry padded over all its keys
# has no row that sees a real key.
K1_EDGE_CASES = {
    "serving_q_offset_0": (2, 2048, 2176, 16, 2, 128, True, 0, (134, 486)),
    "serving_q_offset_128": (2, 2048, 2176, 16, 2, 128, True, 128, (134, 486)),
    "train_B1": (1, 2048, 2176, 16, 2, 128, True, 0, (134,)),
    "head_dim_64": (2, 256, 256, 8, 2, 64, True, 0, (20, 0)),
    "head_dim_80": (2, 256, 320, 8, 2, 80, True, 64, (0, 30)),
    "G1": (2, 192, 192, 4, 4, 128, True, 0, (0, 50)),
    "non_causal": (2, 256, 300, 16, 2, 128, False, 0, (10, 0)),
    "ragged_Sq200_Skv328": (2, 200, 328, 16, 2, 128, True, 128, (37, 0)),
    "all_masked_rows": (2, 256, 256, 16, 2, 128, True, 0, (150, 256)),
}

# K3 edge cases (bf16, tensor-core kernel): (n_slices, S, nh, hd, pad keys at
# the end of each slice); besides, 5% of the other keys are dead patches. A
# slice padded over its whole length has no live key: its rows must stay
# finite. JAX's kernel caps S at 1536 (a VMEM limit); the port's does not.
K3_EDGE_CASES = {
    "S100_ragged_dead_slice": (3, 100, 16, 80, (0, 17, 100)),
    "S2048": (1, 2048, 16, 80, (300,)),
    "nh1": (4, 480, 1, 80, (0, 0, 55, 200)),
    "head_dim_64": (2, 256, 4, 64, (0, 40)),
    "head_dim_128": (2, 256, 4, 128, (0, 40)),
}


def misaligned(t):
    """A contiguous copy of t that starts 2 bytes off 16-byte alignment."""
    import torch

    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def fwd_tc_edge_cases(gen, k1_entry: dict, k3_entry: dict) -> None:
    """bf16 K1 and K3 (the tensor-core kernels) against their plain versions
    (f32 on the same inputs) at TOL, max abs error on valid rows, for K1's out
    and lse; every value of every row must be finite. K1's B = 1 shape is
    timed. Then both wrappers must refuse f16, head dim 96 and a misaligned q."""
    import torch

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, full_attention_rope_plain

    dev = torch.device("cuda")
    tol = TOL["bfloat16"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def hold(entry, label, case, pairs, D):
        """(kernel, plain, valid-row mask) triples: the worst max abs error on
        valid rows, also over the tail columns 64..79 at D = 80."""
        errs, tail = [], None
        for got, want, valid in pairs:
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label} {case}: non-finite values")
            diff = (got.float() - want.float()).abs()
            errs.append(diff[valid].max().item())
            if D == 80 and got.dim() == 4:
                tail = diff[valid][..., 64:].max().item()
        err = max(errs)
        entry["cases"][case] = err
        entry["max_abs_err_cases"] = max(entry.get("max_abs_err_cases", 0.0), err)
        extra = "" if tail is None else f" (columns 64-79: {tail:.3e})"
        log(f"[kernels] {label} {case}: max |kernel - plain| on valid rows = {errs}{extra}, every value finite "
            f"(tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{label} {case}: max |kernel - plain| = {err} > {tol}")

    k1_entry["cases"], k3_entry["cases"] = {}, {}
    for case, (B, Sq, Skv, H, Hkv, D, causal, q_offset, pads) in K1_EDGE_CASES.items():
        bias, valid, allowed, flops, nbytes = k1_work(B, Sq, Skv, H, Hkv, D, causal, q_offset, pads)
        q, k, v = randn(B, Sq, H, D), randn(B, Skv, Hkv, D), randn(B, Skv, Hkv, D)
        args = (q, k, v, bias, causal, None, q_offset)
        out, lse = fa.flash_attention_fwd(*args)
        want, want_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), *args[3:])
        torch.cuda.synchronize()
        hold(k1_entry, "flash_attention", case, [(out, want, valid), (lse, want_lse, valid[:, None, :].expand(B, H, Sq))], D)
        if case == "train_B1":
            ms = cuda_ms(lambda: fa.flash_attention_fwd(*args))
            bound_ms, bound_by = bound(flops, nbytes)
            k1_entry["b1"] = dict(shape=[B, Sq, Skv, H, Hkv, D], pad=pads[0], ms=ms, bound_ms=bound_ms,
                                  bound_by=bound_by, tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
                                  library_ms=cuda_ms(k1_library(valid, allowed)(*args)))
            log(f"[kernels] flash_attention at B = 1 (phase 5's prompt forward): {ms:.4f} ms, bound "
                f"{bound_ms:.4f} by {bound_by}, {flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the "
                f"bound, library {k1_entry['b1']['library_ms']:.4f} ms")

    for case, (n, S, nh, hd, pads) in K3_EDGE_CASES.items():
        q, k, v = randn(n, S, nh, hd), randn(n, S, nh, hd), randn(n, S, nh, hd)
        theta = torch.rand(n, S, hd, generator=gen, device=dev) * 20.0
        cos, sin = theta.cos(), theta.sin()
        keys = torch.arange(S, device=dev)
        dead = (keys[None] >= S - torch.tensor(pads, device=dev)[:, None]) | (
            torch.rand(n, S, generator=gen, device=dev) < 0.05)
        bias = torch.where(dead, NEG_INF, 0.0).float()
        out = full_attention_rope(q, k, v, cos, sin, bias)
        want = full_attention_rope_plain(q.float(), k.float(), v.float(), cos, sin, bias)
        torch.cuda.synchronize()
        hold(k3_entry, "full_attention_rope", case, [(out, want, ~dead)], hd)

    # what the kernels do not take raises in the wrapper, never falls back
    B, S, H, Hkv, D = 1, 256, 16, 2, 128
    q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    bias = torch.zeros(B, S, device=dev)
    vq, vk, vv = randn(2, 64, 4, 80), randn(2, 64, 4, 80), randn(2, 64, 4, 80)
    cs, vb = torch.rand(2, 64, 80, device=dev), torch.zeros(2, 64, device=dev)
    d96 = [randn(1, S, H, 96), randn(1, S, Hkv, 96), randn(1, S, Hkv, 96)]
    v96 = [randn(2, 64, 4, 96) for _ in range(3)]
    refused = {
        "flash_attention": {
            "float16": lambda: fa.flash_attention_fwd(q.half(), k.half(), v.half(), bias),
            "head dim 96": lambda: fa.flash_attention_fwd(*d96, bias),
            "q 2 bytes off 16-byte alignment": lambda: fa.flash_attention_fwd(misaligned(q), k, v, bias),
        },
        "full_attention_rope": {
            "float16": lambda: full_attention_rope(vq.half(), vk.half(), vv.half(), cs, cs, vb),
            "head dim 96": lambda: full_attention_rope(*v96, torch.rand(2, 64, 96, device=dev),
                                                       torch.rand(2, 64, 96, device=dev), vb),
            "q 2 bytes off 16-byte alignment": lambda: full_attention_rope(misaligned(vq), vk, vv, cs, cs, vb),
        },
    }
    for name, calls in refused.items():
        for what, call in calls.items():
            try:
                call()
            except ValueError as e:
                log(f"[kernels] {name} refuses {what}: {e}")
            else:
                raise AssertionError(f"{name} took {what}")


# Gradient tolerances, as max |kernel - plain| / max |plain| over the output.
# f32: the kernels sum dK/dV over up to 64 (row, head) pairs x 2048 query rows,
# and dq over 2304 keys, in another order than the plain einsums; bf16: dq is
# stored in bf16 (relative spacing 2^-8), and the forward outputs likewise.
GRAD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def phase_train_kernels() -> dict:
    """B1, B2, S1 and S2 against their plain versions at the training step's
    shapes (the prompt forward of phase 5: one 2048-token prompt with 134 left
    pad keys; the split-loss chunk: 8 rows of 256 completion tokens over that
    prefix), in bf16 and f32; times in bf16."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    H, Hkv, D, pad = 16, 2, 128, 134
    G = H // Hkv

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def errors(got, want) -> tuple[float, float]:
        """(max |kernel - plain|, max over outputs of max |kernel - plain| / max |plain|)."""
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        diffs, rels = [], []
        for a, b in zip(got, want):
            diff, scale = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
            log(f"[kernels]   max |kernel - plain| {diff:.3e}, max |plain| {scale:.3e}, "
                f"max |kernel| {a.float().abs().max().item():.3e}")
            diffs.append(diff)
            rels.append(diff / max(scale, 1e-30))
        return max(diffs), max(rels)

    def check(name, kernel, plain, inputs, flops, nbytes, library):
        entry = {"name": name}
        for dtype in (torch.bfloat16, torch.float32):
            args = inputs(dtype)
            up = [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args]
            diff, err = errors(kernel(*args), plain(*up))
            torch.cuda.synchronize()
            key = str(dtype).split(".")[-1]
            if not np.isfinite(err) or err > GRAD_TOL[key]:
                raise AssertionError(f"{name} {key}: max |kernel - plain| / max |plain| = {err} > {GRAD_TOL[key]}")
            suffix = "" if dtype is torch.bfloat16 else "_f32"
            entry["max_abs_err" + suffix], entry["max_rel_err" + suffix] = diff, err
            log(f"[kernels] {name} {key}: max |kernel - plain| = {diff:.3e}, / max |plain| = {err:.3e} "
                f"(tol {GRAD_TOL[key]})")
            if dtype is torch.bfloat16:
                entry["ms"] = entry["kernel_ms"] = cuda_ms(lambda: kernel(*args))
                entry["plain_ms"] = cuda_ms(lambda: plain(*args), iters=3)
                entry["library_ms"] = library(*args) if library else None
                entry["bound_ms"], entry["bound_by"] = bound(flops, nbytes)
                entry["tflops"] = flops / entry["ms"] / 1e9
                entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entry["tol"], entry["tol_f32"] = GRAD_TOL["bfloat16"], GRAD_TOL["float32"]
        entry["tol_is"] = "on max_rel_err: max |kernel - plain| / max |plain| per output"
        log(f"[kernels] {name}: {entry['ms']:.3f} ms (plain {entry['plain_ms']:.3f}, bound "
            f"{entry['bound_ms']:.4f} by {entry['bound_by']}, {entry['tflops']:.1f} TFLOP/s, "
            f"{100 * entry['bound_share']:.1f}% of the bound, library {entry['library_ms']})")
        return entry

    def sdpa_times(q, k, v, mask):
        """(forward ms, forward + backward ms) of one SDPA call: the yardstick."""
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        g = torch.randn(qt.shape, generator=gen, device=dev).to(q.dtype)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        def fwd_bwd():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True).backward(g)

        return cuda_ms(fwd), cuda_ms(fwd_bwd)

    def grad_inputs(q, k, v, bias, do, valid_rows):
        """lse and delta from the plain forward (f32), dO zero on rows that see no key."""
        do = do * valid_rows[:, :, None, None]
        out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, True, None, 0)
        return do, lse, (do.float() * out.float()).sum(-1)

    results = {}
    # ---- B1, B2 at the prompt forward: q (1, 2048, 16, 128), k/v (1, 2048, 2, 128)
    S = 2048
    bias = torch.where(torch.arange(S, device=dev)[None] < pad, NEG_INF, 0.0).float()
    rows = torch.arange(S, device=dev)
    valid = (rows >= pad)[None].float()
    live = S - pad
    pairs = live * (live + 1) // 2  # per head: valid row i sees keys [pad, i]
    base = dict(q=randn(1, S, H, D), k=randn(1, S, Hkv, D), v=randn(1, S, Hkv, D), do=randn(1, S, H, D))

    def prompt_inputs(dtype):
        q, k, v = (base[n].to(dtype) for n in ("q", "k", "v"))
        do, lse, delta = grad_inputs(q, k, v, bias, base["do"], valid)
        return q, k, v, bias, do.to(dtype), lse, delta

    mask = torch.where((rows[None, :] <= rows[:, None]) & (rows[None, :] >= pad), 0.0, NEG_INF)
    mask = mask.to(torch.bfloat16)[None, None]
    t_fwd, t_fb = sdpa_times(*(base[n].to(torch.bfloat16) for n in ("q", "k", "v")), mask)
    io_rows = live * H * D * 2 * 2  # q and dO read (bf16)
    io_keys = live * Hkv * D * 2 * 2  # k and v read
    stats = live * H * 4 * 2  # lse and delta
    results["flash_bwd_dq"] = check(
        "flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, prompt_inputs,
        flops=6.0 * D * pairs * H, nbytes=io_rows + io_keys + stats + S * 4 + live * H * D * 2,
        library=lambda *a: t_fb - t_fwd,
    )
    results["flash_bwd_dq"]["library_is"] = "SDPA forward+backward minus forward: the whole of B1 + B2"
    results["flash_bwd_dkv"] = check(
        "flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, prompt_inputs,
        flops=8.0 * D * pairs * H, nbytes=io_rows + io_keys + stats + S * 4 + 2 * live * Hkv * D * 4,
        library=None,
    )
    results["flash_bwd_dkv"]["library_is"] = "in flash_bwd_dq's row (one SDPA backward covers B1 + B2)"
    results["flash_bwd_dkv"]["grid_blocks"] = (S // 64) * Hkv * fa.bwd_dkv_split(G, S, Hkv, 1)

    # ---- B2 at the own chunk of the split loss: q (8, 256, 16, 128), zero bias
    R, Sc = 8, 256
    own = dict(q=randn(R, Sc, H, D), k=randn(R, Sc, Hkv, D), v=randn(R, Sc, Hkv, D), do=randn(R, Sc, H, D))
    zero = torch.zeros(R, Sc, device=dev)

    def own_inputs(dtype):
        q, k, v = (own[n].to(dtype) for n in ("q", "k", "v"))
        do, lse, delta = grad_inputs(q, k, v, zero, own["do"], torch.ones(R, Sc, device=dev))
        return q, k, v, zero, do.to(dtype), lse, delta

    for dtype in (torch.bfloat16, torch.float32):
        args = own_inputs(dtype)
        diff, err = errors(fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*[a.float() for a in args]))
        key = str(dtype).split(".")[-1]
        log(f"[kernels] flash_bwd_dkv own chunk {key}: max |kernel - plain| = {diff:.3e}, "
            f"/ max |plain| = {err:.3e} (tol {GRAD_TOL[key]})")
        if not np.isfinite(err) or err > GRAD_TOL[key]:
            raise AssertionError(f"flash_bwd_dkv own chunk {key}: {err}")
        if dtype is torch.bfloat16:
            results["flash_bwd_dkv"]["own_chunk_ms"] = cuda_ms(lambda: fa.flash_bwd_dkv(*args))
            log(f"[kernels] flash_bwd_dkv own chunk: {results['flash_bwd_dkv']['own_chunk_ms']:.4f} ms")
    bwd_edge_cases(gen, results["flash_bwd_dq"], results["flash_bwd_dkv"])

    # ---- S1, S2 at the split-loss chunk: q (8, 256, 16, 128), prefix (1, 2048, 2, 128)
    P, Lp = 1, 2048
    pbias = torch.where(torch.arange(Lp, device=dev)[None] < pad, NEG_INF, 0.0).float()
    sp = dict(q=own["q"], kp=randn(P, Lp, Hkv, D), vp=randn(P, Lp, Hkv, D), ko=own["k"], vo=own["v"], do=own["do"])

    def sp_fwd_inputs(dtype):
        return tuple(sp[n].to(dtype) for n in ("q", "kp", "vp", "ko", "vo")) + (pbias,)

    def sp_bwd_parts(dtype):
        q, kp, vp, ko, vo, pb = sp_fwd_inputs(dtype)
        out, lse = fa.shared_prefix_plain(q.float(), kp.float(), vp.float(), ko.float(), vo.float(), pb)
        delta = (sp["do"].to(dtype).float() * out).sum(-1)
        return q, kp, vp, ko, vo, pb, sp["do"].to(dtype), lse, delta

    def sp_bwd(q, kp, vp, ko, vo, pb, do, lse, delta):
        return (fa.shared_prefix_bwd_dq(q, kp, vp, ko, vo, pb, do, lse, delta),
                *fa.shared_prefix_bwd_dkv(q, kp, vp, pb, do, lse, delta))

    def sp_bwd_plain(q, kp, vp, ko, vo, pb, do, lse, delta):
        return (fa.shared_prefix_bwd_dq_plain(q, kp, vp, ko, vo, pb, do, lse, delta),
                *fa.shared_prefix_bwd_dkv_plain(q, kp, vp, pb, do, lse, delta))

    live_p = Lp - pad
    own_pairs = Sc * (Sc + 1) // 2
    pre_pairs = Sc * live_p
    rows_io = R * Sc * H * D * 2
    keys_io = (live_p * Hkv * D * 2) * 2 + (R * Sc * Hkv * D * 2) * 2
    cat_k = torch.cat([sp["kp"].expand(R, -1, -1, -1), sp["ko"]], 1).to(torch.bfloat16)
    cat_v = torch.cat([sp["vp"].expand(R, -1, -1, -1), sp["vo"]], 1).to(torch.bfloat16)
    i = torch.arange(Sc, device=dev)
    cat_mask = torch.cat([pbias.expand(Sc, -1), torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF)], 1)
    cat_mask = cat_mask.to(torch.bfloat16)[None, None]
    s_fwd, s_fb = sdpa_times(sp["q"].to(torch.bfloat16), cat_k, cat_v, cat_mask)
    results["shared_prefix_fwd"] = check(
        "shared_prefix_fwd", lambda *a: fa.shared_prefix_fwd(*a)[0], lambda *a: fa.shared_prefix_plain(*a)[0],
        sp_fwd_inputs, flops=4.0 * D * (pre_pairs + own_pairs) * R * H,
        nbytes=2 * rows_io + keys_io + Lp * 4 + R * Sc * H * 4, library=lambda *a: s_fwd,
    )
    results["shared_prefix_fwd"]["library_is"] = "SDPA over [prefix repeated 8x | own chunk] with the mask"
    bwd = check(
        "shared_prefix_bwd", sp_bwd, sp_bwd_plain, sp_bwd_parts,
        flops=6.0 * D * (pre_pairs + own_pairs) * R * H + 8.0 * D * pre_pairs * R * H,
        nbytes=2 * (2 * rows_io + keys_io + R * Sc * H * 8) + rows_io + 2 * live_p * Hkv * D * 4,
        library=lambda *a: s_fb - s_fwd,
    )
    bwd["library_is"] = ("SDPA forward+backward minus forward over [prefix repeated | own chunk]:"
                         " also covers the own-chunk dK/dV that B2 computes")
    a = sp_bwd_parts(torch.bfloat16)
    bwd["ms_dq"] = cuda_ms(lambda: fa.shared_prefix_bwd_dq(*a))
    bwd["ms_dkv_prefix"] = cuda_ms(lambda: fa.shared_prefix_bwd_dkv(a[0], a[1], a[2], a[5], *a[6:]))
    # dq: S, dP and dS·K over both sources; the prefix dK/dV: S, dP, Pᵀ·dO and dSᵀ·Q over the prefix
    for part, ms, flops in (("dq", bwd["ms_dq"], 6.0 * D * (pre_pairs + own_pairs) * R * H),
                            ("dkv_prefix", bwd["ms_dkv_prefix"], 8.0 * D * pre_pairs * R * H)):
        bwd[f"tflops_{part}"] = flops / ms / 1e9
        bwd[f"bound_share_{part}"] = flops / PEAK_BF16_FLOPS * 1e3 / ms
    n_split = fa.bwd_dkv_split(G, Lp, Hkv, P, R)
    bwd["n_split_dkv_prefix"] = n_split
    bwd["grid_blocks_dkv_prefix"] = (Lp // 64) * Hkv * P * n_split
    log(f"[kernels] shared_prefix_bwd: dq {bwd['ms_dq']:.4f} ms ({bwd['tflops_dq']:.1f} TFLOP/s), prefix dK/dV "
        f"{bwd['ms_dkv_prefix']:.4f} ms with the fold ({bwd['tflops_dkv_prefix']:.1f} TFLOP/s; n_split {n_split}, "
        f"{bwd['grid_blocks_dkv_prefix']} blocks)")
    results["shared_prefix_bwd"] = bwd
    sp_edge_cases(gen, results["shared_prefix_fwd"], bwd)
    head_backward_check(gen)
    return results


# The 7B's attention layout (28 q heads over 4 kv heads: G = 7, head dim 128),
# which only phase 11 runs, at phase 5's shapes: K1, B1 and B2 at one
# 2048-token prompt with 134 left pad keys, S1 and S2 at 8 rows of 256
# completion tokens over that prefix.
ATTN_7B = dict(H=28, Hkv=4, D=128, S=2048, pad=134, R=8, Sc=256)


def attention_7b_cases(results: dict) -> None:
    """K1, B1, B2, S1 and S2 at the 7B's heads (ATTN_7B, "7B_G7") in bf16,
    then at phase 14's TP-local heads (TP_ATTN) in bf16 and f32
    (`attention_head_cases`)."""
    import torch

    attention_head_cases(results, ATTN_7B, "7B_G7", torch.bfloat16)
    for tag, shape in TP_ATTN.items():
        for dtype in (torch.bfloat16, torch.float32):
            attention_head_cases(results, shape, tag if dtype is torch.bfloat16 else f"{tag}_f32", dtype)


def attention_head_cases(results: dict, shape: dict, tag: str, dtype) -> None:
    """K1, B1, B2, S1 and S2 in `dtype` (bf16: the tensor-core kernels; f32:
    FMA) against their plain versions (f32 on the same inputs) at `shape`'s
    heads, at GRAD_TOL on max |kernel - plain| / max |plain| per output; each
    timed beside its bound and one SDPA call over the same keys and mask.
    Written to each kernel's entry as `tag`."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    H, Hkv, D, S, pad, R, Sc = (shape[k] for k in ("H", "Hkv", "D", "S", "pad", "R", "Sc"))
    key = str(dtype).split(".")[-1]
    tol = GRAD_TOL[key]
    elt = torch.finfo(dtype).bits // 8

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rel_err(got, want) -> float:
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        return max((a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
                   for a, b in zip(got, want))

    def sdpa(q, k, v, mask):
        """(forward ms, forward + backward ms) of one SDPA call with the mask."""
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        g = torch.randn(qt.shape, generator=gen, device=dev).to(q.dtype)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        def fwd_bwd():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True).backward(g)

        return cuda_ms(fwd), cuda_ms(fwd_bwd)

    def record(name, got, want, run, flops, nbytes, library_ms, library_is):
        err = rel_err(got, want)
        ms = cuda_ms(run)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS if dtype is torch.bfloat16 else PEAK_F32_FLOPS)
        row = dict(max_rel_err=err, tol=tol, ms=ms, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                   tflops=flops / ms / 1e9, library_ms=library_ms, library_is=library_is)
        results[name][tag] = row
        log(f"[kernels] {name} {tag} {key} (H {H}, Hkv {Hkv}, G {H // Hkv}): max |kernel - plain| / max "
            f"|plain| = {err:.3e} (tol {tol}); {ms:.4f} ms (bound {b_ms:.4f} by {b_by}, {row['tflops']:.1f} "
            f"TFLOP/s, {100 * row['bound_share']:.1f}% of the bound, library {library_ms})")
        if not np.isfinite(err) or err > tol:
            raise AssertionError(f"{name} {tag} {key}: {err} > {tol}")

    # K1, B1, B2: the prompt forward and its backward
    rows = torch.arange(S, device=dev)
    bias = torch.where(rows[None] < pad, NEG_INF, 0.0).float()
    q, k, v = randn(1, S, H, D), randn(1, S, Hkv, D), randn(1, S, Hkv, D)
    do = (randn(1, S, H, D).float() * (rows >= pad)[None, :, None, None]).to(dtype)
    up = (q.float(), k.float(), v.float())
    out, lse = fa.flash_attention_plain(*up, bias, True, None, 0)
    delta = (do.float() * out).sum(-1)
    _, _, _, k1_flops, k1_bytes = k1_work(1, S, S, H, Hkv, D, True, 0, (pad,), elt)
    mask = torch.where((rows[None, :] <= rows[:, None]) & (rows[None, :] >= pad), 0.0, NEG_INF)
    t_fwd, t_fb = sdpa(q, k, v, mask.to(dtype)[None, None])
    valid = (rows >= pad)[None]
    got_out, got_lse = fa.flash_attention_fwd(q, k, v, bias, True, None, 0)
    record("flash_attention", (got_out[valid], got_lse.transpose(1, 2)[valid]),
           (out[valid], lse.transpose(1, 2)[valid]), lambda: fa.flash_attention_fwd(q, k, v, bias, True, None, 0),
           k1_flops, k1_bytes, t_fwd, "SDPA forward, the same mask, GQA")
    live = S - pad
    pairs = live * (live + 1) // 2
    io = live * H * D * elt * 2 + live * Hkv * D * elt * 2 + live * H * 4 * 2 + S * 4
    args = (q, k, v, bias, do, lse, delta)
    upargs = (*up, bias, do.float(), lse, delta)
    record("flash_bwd_dq", fa.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*upargs), lambda: fa.flash_bwd_dq(*args),
           6.0 * D * pairs * H, io + live * H * D * elt, t_fb - t_fwd,
           "SDPA forward+backward minus forward: the whole of B1 + B2")
    record("flash_bwd_dkv", fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*upargs),
           lambda: fa.flash_bwd_dkv(*args), 8.0 * D * pairs * H, io + 2 * live * Hkv * D * 4, None,
           "in flash_bwd_dq's row (one SDPA backward covers B1 + B2)")

    # S1, S2: the split loss's completion chunk over the shared prefix
    qc, ko, vo, doc = randn(R, Sc, H, D), randn(R, Sc, Hkv, D), randn(R, Sc, Hkv, D), randn(R, Sc, H, D)
    fwd = (qc, k, v, ko, vo, bias)
    upf = (qc.float(), *up[1:], ko.float(), vo.float(), bias)
    out_c, lse_c = fa.shared_prefix_plain(*upf)
    delta_c = (doc.float() * out_c).sum(-1)
    i = torch.arange(Sc, device=dev)
    cat_mask = torch.cat([bias.expand(Sc, -1), torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF)], 1)
    s_fwd, s_fb = sdpa(qc, torch.cat([k.expand(R, -1, -1, -1), ko], 1), torch.cat([v.expand(R, -1, -1, -1), vo], 1),
                       cat_mask.to(dtype)[None, None])
    own_pairs, pre_pairs = Sc * (Sc + 1) // 2, Sc * live
    rows_io = R * Sc * H * D * elt
    keys_io = (live * Hkv * D * elt) * 2 + (R * Sc * Hkv * D * elt) * 2
    record("shared_prefix_fwd", fa.shared_prefix_fwd(*fwd)[0], out_c, lambda: fa.shared_prefix_fwd(*fwd),
           4.0 * D * (pre_pairs + own_pairs) * R * H, 2 * rows_io + keys_io + S * 4 + R * Sc * H * 4, s_fwd,
           "SDPA over [prefix repeated 8x | own chunk] with the mask, GQA")

    def s2():
        return (fa.shared_prefix_bwd_dq(*fwd, doc, lse_c, delta_c),
                *fa.shared_prefix_bwd_dkv(qc, k, v, bias, doc, lse_c, delta_c))

    want = (fa.shared_prefix_bwd_dq_plain(*upf, doc.float(), lse_c, delta_c),
            *fa.shared_prefix_bwd_dkv_plain(upf[0], upf[1], upf[2], bias, doc.float(), lse_c, delta_c))
    record("shared_prefix_bwd", s2(), want, s2,
           6.0 * D * (pre_pairs + own_pairs) * R * H + 8.0 * D * pre_pairs * R * H,
           2 * (2 * rows_io + keys_io + R * Sc * H * 8) + rows_io + 2 * live * Hkv * D * 4, s_fb - s_fwd,
           "SDPA forward+backward minus forward over [prefix repeated | own chunk]")
    row = results["shared_prefix_bwd"][tag]
    row["ms_dq"] = cuda_ms(lambda: fa.shared_prefix_bwd_dq(*fwd, doc, lse_c, delta_c))
    row["ms_dkv_prefix"] = cuda_ms(lambda: fa.shared_prefix_bwd_dkv(qc, k, v, bias, doc, lse_c, delta_c))
    row["n_split_dkv_prefix"] = fa.bwd_dkv_split(H // Hkv, S, Hkv, 1, R)
    log(f"[kernels] shared_prefix_bwd {tag} {key}: dq {row['ms_dq']:.4f} ms, prefix dK/dV "
        f"{row['ms_dkv_prefix']:.4f} ms (n_split {row['n_split_dkv_prefix']})")


# The full-row loss's attention (phase 12 (c)) at the 3B's heads: B·G = 8
# rows of T = 4096 (the bucket of phase 4's first prompt, 1914 tokens, plus a
# 200-token rollout). Every row is left-padded by T - prompt - max(comps) =
# 1982 keys, so its first 1982 query rows see no key; a completion shorter
# than the longest is followed by masked keys.
FULL_ROW_ATTN = dict(B=8, T=4096, H=16, Hkv=2, D=128, prompt=1914, comps=(200, 200, 37, 151, 200, 1, 99, 180))


def full_row_attention_cases(gen, results: dict, shape: dict = FULL_ROW_ATTN) -> None:
    """K1's forward and its backward through `flash_attention`'s autograd
    (B1's dq, B2's dk and dv) at the full-row loss's shape, in bf16 (the
    tensor-core kernels) and f32 (FMA), against flash_attention_plain and its
    autograd on the same inputs in f32, one row at a time, at GRAD_TOL on
    max |kernel - plain| / max |plain|: out and lse on the rows that see a
    key, every gradient whole (dO is zero on the rows that see none, as the
    loss gives it). Every value must be finite. Each entry gets "full_row":
    the errors and the bf16 times."""
    import torch

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = gen.device
    B, T, H, Hkv, D, P, comps = (shape[k] for k in ("B", "T", "H", "Hkv", "D", "prompt", "comps"))
    lead = T - P - max(comps)
    pos = torch.arange(T, device=dev)
    ends = torch.tensor([lead + P + c for c in comps], device=dev)
    bias = torch.where((pos[None] >= lead) & (pos[None] < ends[:, None]), 0.0, NEG_INF).float()
    valid = (pos >= lead)[None].expand(B, T)  # causal: row i sees key `lead` from i = lead on
    base = {n: torch.randn(s, generator=gen, device=dev) for n, s in (
        ("q", (B, T, H, D)), ("k", (B, T, Hkv, D)), ("v", (B, T, Hkv, D)), ("do", (B, T, H, D)))}
    base["do"] *= valid[:, :, None, None]
    # (valid row i, live key j <= i) pairs per head: row b's live keys are [lead, end_b)
    pairs = sum(int(torch.minimum(pos[lead:], ends[b] - 1).sub(lead - 1).sum()) for b in range(B))
    entries = {n: results[n].setdefault("full_row", dict(shape=[B, T, H, Hkv, D], lead=lead, comps=list(comps)))
               for n in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        q, k, v = (base[n].to(dtype).requires_grad_() for n in ("q", "k", "v"))
        do = base["do"].to(dtype)
        out, lse = fa.flash_attention_fwd(q.detach(), k.detach(), v.detach(), bias)
        fa.flash_attention(q, k, v, bias).backward(do)
        want = {n: [] for n in ("out", "lse", "dq", "dk", "dv")}
        for b in range(B):
            qb, kb, vb = (t.detach()[b:b + 1].float().requires_grad_() for t in (q, k, v))
            ob, lb = fa.flash_attention_plain(qb, kb, vb, bias[b:b + 1])
            ob.backward(do[b:b + 1].float())
            for n, t in (("out", ob), ("lse", lb), ("dq", qb.grad), ("dk", kb.grad), ("dv", vb.grad)):
                want[n].append(t.detach())
        want = {n: torch.cat(t) for n, t in want.items()}
        rows = {"out": valid[:, :, None, None].expand(B, T, H, D), "lse": valid[:, None, :].expand(B, H, T)}
        got = {"out": out, "lse": lse, "dq": q.grad, "dk": k.grad, "dv": v.grad}
        errs = {}
        for n, g in got.items():
            if not torch.isfinite(g).all():
                raise AssertionError(f"full-row {n} {key}: non-finite values")
            g, w = g.float(), want[n].float()
            if n in rows:
                g, w = g[rows[n]], w[rows[n]]
            diff = (g - w).abs().max().item()
            errs[n] = (diff, diff / max(w.abs().max().item(), 1e-30))
        torch.cuda.synchronize()
        for name, outs in (("flash_attention", ("out", "lse")), ("flash_bwd_dq", ("dq",)),
                           ("flash_bwd_dkv", ("dk", "dv"))):
            err = max(errs[n][1] for n in outs)
            entries[name][f"max_abs_err_{key}"] = max(errs[n][0] for n in outs)
            entries[name][f"max_rel_err_{key}"] = err
            log(f"[kernels] {name} full rows {key}: " + ", ".join(
                f"{n} max |kernel - plain| {errs[n][0]:.3e}, / max |plain| {errs[n][1]:.3e}" for n in outs)
                + f" (tol {GRAD_TOL[key]})")
            if not err <= GRAD_TOL[key]:
                raise AssertionError(f"{name} full rows {key}: max |kernel - plain| / max |plain| = {err} "
                                     f"> {GRAD_TOL[key]}")
        if dtype is torch.bfloat16:
            qd, kd, vd = q.detach(), k.detach(), v.detach()
            delta = (do.float() * out.float()).sum(-1)
            for name, call, flops in (
                    ("flash_attention", lambda: fa.flash_attention_fwd(qd, kd, vd, bias), 4.0 * D * pairs * H),
                    ("flash_bwd_dq", lambda: fa.flash_bwd_dq(qd, kd, vd, bias, do, lse, delta), 6.0 * D * pairs * H),
                    ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(qd, kd, vd, bias, do, lse, delta), 8.0 * D * pairs * H)):
                ms = cuda_ms(call)
                entries[name].update(ms=ms, tflops=flops / ms / 1e9, bound_share=flops / PEAK_BF16_FLOPS * 1e3 / ms)
                log(f"[kernels] {name} full rows: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s "
                    f"({100 * entries[name]['bound_share']:.1f}% of the bf16 peak)")
        del q, k, v, out, lse, want, got


# B1/B2 edge cases (bf16, tensor-core kernels): (B, Sq, Skv, H, Hkv, D,
# causal, q_offset, left pad keys per batch entry). Rows that see no key get a
# zero cotangent, as the training step gives them.
BWD_EDGE_CASES = {
    "q_offset_64": (1, 256, 320, 16, 2, 128, True, 64, (0,)),
    "ragged_Sq200_Skv328": (2, 200, 328, 16, 2, 128, True, 128, (37, 0)),
    "head_dim_64": (2, 256, 256, 8, 2, 64, True, 0, (20, 0)),
    "G1": (2, 192, 192, 4, 4, 128, True, 0, (0, 50)),
    "non_causal": (2, 256, 300, 16, 2, 128, False, 0, (10, 0)),
    "all_masked_rows": (2, 256, 256, 16, 2, 128, True, 0, (150, 256)),
}


def bwd_edge_cases(gen, dq_entry: dict, dkv_entry: dict) -> None:
    """B1 and B2 in bf16 against their plain versions (f32 on the same
    inputs) at the edges the main path and ring attention reach, at
    GRAD_TOL; then two B2 launches at the prompt shape must be bit-equal."""
    import torch

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    tol = GRAD_TOL["bfloat16"]
    dq_entry["cases"], dkv_entry["cases"] = {}, {}
    for case, (B, Sq, Skv, H, Hkv, D, causal, q_offset, pads) in BWD_EDGE_CASES.items():
        keys = torch.arange(Skv, device=dev)
        pad = torch.tensor(pads, device=dev)
        bias = torch.where(keys[None] < pad[:, None], NEG_INF, 0.0).float()
        last = q_offset + torch.arange(Sq, device=dev) if causal else torch.full((Sq,), Skv - 1, device=dev)
        valid = (last[None] >= pad[:, None]).float()  # (B, Sq): rows that see a key
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
        do = (torch.randn(B, Sq, H, D, generator=gen, device=dev) * valid[:, :, None, None]).bfloat16()
        out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, causal, None, q_offset)
        delta = (do.float() * out).sum(-1)
        args = (q, k, v, bias, do, lse, delta, causal, None, q_offset)
        up = (q.float(), k.float(), v.float(), bias, do.float(), lse, delta, causal, None, q_offset)
        check_case(dq_entry, "flash_bwd_dq", case, [(fa.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*up))], tol)
        check_case(dkv_entry, "flash_bwd_dkv", case, list(zip(fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*up))), tol)
    # bit-equality across launches at the prompt shape (n_split = 8: folded partials)
    S, H, Hkv, D = 2048, 16, 2, 128
    q, do = (torch.randn(1, S, H, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(1, S, Hkv, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    bias = torch.where(torch.arange(S, device=dev)[None] < 134, NEG_INF, 0.0).float()
    out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, True, None, 0)
    args = (q, k, v, bias, do, lse, (do.float() * out).sum(-1))
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    equal = all(torch.equal(a, b) for a, b in zip(first, second))
    dkv_entry["bit_equal_across_launches"] = equal
    log(f"[kernels] flash_bwd_dkv: two launches bit-equal: {equal} (n_split "
        f"{fa.bwd_dkv_split(H // Hkv, S, Hkv, 1)})")
    if not equal:
        raise AssertionError("flash_bwd_dkv: two launches on the same inputs differ")
    # what the kernels do not take raises in the wrapper, never falls back
    refused = {
        "float16": (q.half(), k.half(), v.half(), bias, do.half(), *args[5:]),
        "head dim 96": (q[..., :96].contiguous(), k[..., :96].contiguous(), v[..., :96].contiguous(), bias,
                        do[..., :96].contiguous(), *args[5:]),
        "q 2 bytes off 16-byte alignment": (q.flatten()[1: 1 + (S - 1) * H * D].view(1, S - 1, H, D), k, v,
                                             bias, do[:, 1:].contiguous(), lse[..., 1:].contiguous(),
                                             args[6][:, 1:]),
    }
    for what, bad in refused.items():
        for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
            try:
                fn(*bad)
            except ValueError as e:
                log(f"[kernels] {fn.__name__} refuses {what}: {e}")
            else:
                raise AssertionError(f"{fn.__name__} took {what}")


# S1/S2 edge cases (bf16, tensor-core kernels): (P, R, Lp, Sc, H, Hkv, D,
# left pad keys per prompt). Every shape is a multiple of 128, as `_sp_blocks`
# requires of the split loss. A prompt whose bias masks every prefix key still
# sees its own causal chunk.
SP_EDGE_CASES = {
    "P2_R4": (2, 4, 256, 128, 16, 2, 128, (0, 37)),
    "Lp640_Sc384": (1, 2, 640, 384, 16, 2, 128, (100,)),
    "Lp128_Sc128": (1, 2, 128, 128, 16, 2, 128, (0,)),
    "head_dim_64": (1, 2, 256, 128, 8, 2, 64, (5,)),
    "G1": (1, 3, 256, 128, 4, 4, 128, (20,)),
    "prefix_all_masked": (2, 2, 256, 128, 16, 2, 128, (256, 0)),
}


def sp_edge_cases(gen, fwd_entry: dict, bwd_entry: dict) -> None:
    """S1 and S2 in bf16 against their plain versions (f32 on the same
    inputs) at GRAD_TOL, at the shapes the split loss can reach beyond the
    main one; then two prefix dK/dV launches at the split-loss shape must be
    bit-equal, and the wrappers must refuse f16, head dim 96 and a misaligned q."""
    import torch

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    tol = GRAD_TOL["bfloat16"]
    fwd_entry["cases"], bwd_entry["cases"] = {}, {}

    def inputs(P, R, Lp, Sc, H, Hkv, D, pads):
        B = P * R
        shapes = ((B, Sc, H, D), (P, Lp, Hkv, D), (P, Lp, Hkv, D), (B, Sc, Hkv, D), (B, Sc, Hkv, D))
        q, kp, vp, ko, vo = (torch.randn(s, generator=gen, device=dev).bfloat16() for s in shapes)
        pb = torch.where(torch.arange(Lp, device=dev)[None] < torch.tensor(pads, device=dev)[:, None], NEG_INF, 0.0)
        do = torch.randn(B, Sc, H, D, generator=gen, device=dev).bfloat16()
        out, lse = fa.shared_prefix_plain(q.float(), kp.float(), vp.float(), ko.float(), vo.float(), pb.float())
        return (q, kp, vp, ko, vo, pb.float()), do, lse, (do.float() * out).sum(-1)

    for case, shape in SP_EDGE_CASES.items():
        fwd, do, lse, delta = inputs(*shape)
        up = tuple(t.float() for t in fwd)
        out, got_lse = fa.shared_prefix_fwd(*fwd)
        want, want_lse = fa.shared_prefix_plain(*up)
        check_case(fwd_entry, "shared_prefix_fwd", case, [(out, want), (got_lse, want_lse)], tol)
        (q, kp, vp, _, _, pb), (uq, ukp, uvp, _, _, _) = fwd, up
        got = (fa.shared_prefix_bwd_dq(*fwd, do, lse, delta), *fa.shared_prefix_bwd_dkv(q, kp, vp, pb, do, lse, delta))
        want = (fa.shared_prefix_bwd_dq_plain(*up, do.float(), lse, delta),
                *fa.shared_prefix_bwd_dkv_plain(uq, ukp, uvp, pb, do.float(), lse, delta))
        check_case(bwd_entry, "shared_prefix_bwd", case, list(zip(got, want)), tol)
    # bit-equality across launches at the split-loss shape (n_split = 8: folded partials)
    fwd, do, lse, delta = inputs(1, 8, 2048, 256, 16, 2, 128, (134,))
    q, kp, vp, ko, vo, pb = fwd
    args = (q, kp, vp, pb, do, lse, delta)
    first, second = fa.shared_prefix_bwd_dkv(*args), fa.shared_prefix_bwd_dkv(*args)
    equal = all(torch.equal(a, b) for a, b in zip(first, second))
    bwd_entry["bit_equal_across_launches"] = equal
    log(f"[kernels] shared_prefix_bwd_dkv: two launches bit-equal: {equal} (n_split {fa.bwd_dkv_split(8, 2048, 2, 1, 8)})")
    if not equal:
        raise AssertionError("shared_prefix_bwd_dkv: two launches on the same inputs differ")
    # what the kernels do not take raises in the wrapper, never falls back
    d96 = [t[..., :96].contiguous() for t in (q, kp, vp, ko, vo, do)]
    skew = q.flatten()[1: 1 + q.numel() - q[:, :1].numel()].view(8, 255, 16, 128)  # 2 bytes off 16
    refused = {
        "float16": ((q.half(), kp.half(), vp.half(), ko.half(), vo.half(), pb), do.half()),
        "head dim 96": ((*d96[:5], pb), d96[5]),
        "q 2 bytes off 16-byte alignment": ((skew, kp, vp, ko[:, 1:].contiguous(), vo[:, 1:].contiguous(), pb),
                                            do[:, 1:].contiguous()),
    }
    for what, (f, d) in refused.items():
        sc = f[0].shape[1]
        l, dl = lse[..., -sc:].contiguous(), delta[:, -sc:].contiguous()
        calls = {
            "shared_prefix_fwd": lambda: fa.shared_prefix_fwd(*f),
            "shared_prefix_bwd_dq": lambda: fa.shared_prefix_bwd_dq(*f, d, l, dl),
            "shared_prefix_bwd_dkv": lambda: fa.shared_prefix_bwd_dkv(f[0], f[1], f[2], f[5], d, l, dl),
        }
        for name, call in calls.items():
            try:
                call()
            except ValueError as e:
                log(f"[kernels] {name} refuses {what}: {e}")
            else:
                raise AssertionError(f"{name} took {what}")


def head_backward_check(gen) -> None:
    """The bf16 head's backward on the card against the product of the
    unrounded f32 cotangent (the JAX package's transpose keeps it in f32),
    taken in f64 and rounded to bf16: within one bf16 ulp of each output's
    scale. The cotangent has detail below bf16's spacing."""
    import torch

    from time_r1_tpu_torch.ops.quant import head_logits

    dev = torch.device("cuda")
    S, V, Hd = 64, 4096, 2048
    h = torch.randn(S, Hd, generator=gen, device=dev).bfloat16()
    w = (torch.randn(V, Hd, generator=gen, device=dev) * 0.05).bfloat16()
    base = torch.randn(S, V, generator=gen, device=dev).bfloat16().float()
    g = base + base.abs() * torch.rand(S, V, generator=gen, device=dev) * 2**-10
    hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    dh, dw = torch.autograd.grad(head_logits(hh, ww), (hh, ww), g)
    want_dh = (g.double() @ w.double()).to(torch.bfloat16)
    want_dw = (g.double().t() @ h.double()).to(torch.bfloat16)
    for name, got, want in (("dh", dh, want_dh), ("dw", dw, want_dw)):
        scale = want.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        err = (got.float() - want.float()).abs().max().item()
        log(f"[kernels] bf16 head backward {name}: max |card - f32-cotangent product| = {err:.3e}, "
            f"one bf16 ulp of the scale {scale:.3e} = {ulp:.3e}")
        if not err <= ulp:
            raise AssertionError(f"bf16 head backward {name}: {err} > {ulp}")


# D1/D2 tolerances, as max |kernel - plain| / max |plain|: D1's (acc, m, l) are
# f32 sums over 1914 live keys of the same f32 operands in another order; D2's
# output is stored in the activation dtype (bf16 spacing 2^-8).
DECODE_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Q1: the kernel scales the f32 sum and casts once; the plain version (the JAX
# package's reference) rounds the product to bf16 before the bf16 scale, so in
# bf16 the two differ by up to two bf16 roundings. Q2: both round x and the
# activation to bf16; the sums over 2048 and 11008 run in another order, which
# can move an activation across a bf16 rounding boundary.
QUANT_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def check_case(entry: dict, label: str, case: str, pairs, tol: float) -> None:
    """Hold one case's (kernel, plain) output pairs against each other: the
    absolute error and the relative one (max |kernel - plain| / max |plain|,
    the worst output), which the tolerance reads. The case's relative error
    goes to entry["cases"], the worst of both over the cases to
    entry["max_abs_err"] and entry["max_rel_err"]."""
    diffs = [(got.float() - want.float()).abs().max().item() for got, want in pairs]
    rels = [d / max(want.float().abs().max().item(), 1e-30) for d, (_, want) in zip(diffs, pairs)]
    if not np.isfinite(diffs + rels).all():
        raise AssertionError(f"{label} {case}: non-finite error {diffs}")
    abs_err, rel = max(diffs), max(rels)
    entry["cases"][case] = rel
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), abs_err)
    entry["max_rel_err"] = max(entry.get("max_rel_err", 0.0), rel)
    log(f"[kernels] {label} {case}: max |kernel - plain| = {abs_err:.3e}, / max |plain| = {rel:.3e} (tol {tol})")
    if rel > tol:
        raise AssertionError(f"{label} {case}: max |kernel - plain| / max |plain| = {rel} > {tol}")


def decode_base(gen, P, R, H, Hkv, D, Lp, Lo, pad) -> dict:
    """f32 operands of a G-way decode step in the port's token-major layouts:
    q (B, 1, H, D), the prefix (P, Lp, Hkv, D) with `pad` left-pad keys in
    its (P, Lp) bias, the suffix (B, Lo, Hkv, D), the new token (B, Hkv, D)."""
    import torch

    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    B = P * R

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    base = dict(q=randn(B, 1, H, D), kp=randn(P, Lp, Hkv, D), vp=randn(P, Lp, Hkv, D),
                ko=randn(B, Lo, Hkv, D), vo=randn(B, Lo, Hkv, D), kn=randn(B, Hkv, D), vn=randn(B, Hkv, D))
    base["bias"] = torch.where(torch.arange(Lp, device=dev)[None] < pad, NEG_INF, 0.0).float().expand(P, Lp).contiguous()
    base["P"], base["R"] = P, R
    return base


def decode_views(base: dict, dtype, int8: bool, lp: int | None = None) -> dict:
    """The decode path's layouts of `base`: q regrouped (P, Hkv, N, D);
    token-major caches handed over as head-major views; scales (..., Hkv)
    likewise. lp keeps the first lp prefix keys."""
    from time_r1_tpu_torch.ops.quant import quantize_kv

    P, R = base["P"], base["R"]
    _, _, H, D = base["q"].shape
    Hkv = base["kn"].shape[1]
    G = H // Hkv
    lp = base["kp"].shape[1] if lp is None else lp
    q = base["q"].to(dtype).reshape(P, R, Hkv, G, D).transpose(1, 2).reshape(P, Hkv, R * G, D)
    out = {"q": q, "kn": base["kn"].to(dtype), "vn": base["vn"].to(dtype), "bias": base["bias"][:, :lp].contiguous()}
    for n in ("kp", "vp", "ko", "vo"):
        src = base[n][:, :lp] if n in ("kp", "vp") else base[n]
        if int8:
            x8, s = quantize_kv(src)
            out[n], out[n + "_s"] = x8.transpose(1, 2), s.transpose(1, 2)
        else:
            out[n], out[n + "_s"] = src.to(dtype).transpose(1, 2), None
    return out


def d1_args(x):
    return x["q"], x["kp"], x["vp"], x["kp_s"], x["vp_s"], x["bias"]


def d2_args(x, own_len: int):
    """D2's arguments, the suffix length as the decode loop hands it over: a
    (1,) int32 in device memory."""
    import torch

    own = torch.full((1,), own_len, dtype=torch.int32, device=x["q"].device)
    return (x["q"], x["kp"], x["vp"], x["kp_s"], x["vp_s"], x["bias"], x["ko"], x["vo"], x["ko_s"], x["vo_s"],
            own, x["kn"], x["vn"])


# bf16 D2 edge cases (the tensor-core kernel): (P, R, H, Hkv, D, Lp, Lo, left
# pad keys), each over bf16 and int8 caches at suffix lengths 0, 1 and 199,
# two launches at 199 bit-equal. The 7B rollout's G = 7 (N = 56 rows, Hkv 4)
# runs on no other phase; R = 16 rollouts a prompt (N = 128 and, at G = 7,
# 112) take the prefix blocks' loop over 64-row tiles and the fold's over
# its row blocks; a pad of 300 masks the first chunk (256 keys) whole, 134
# the first two of its tiles (one per warpgroup); Lp 1000 ends in a partial
# tile and chunk.
D2_TC_CASES = {
    "7B rollout (N 56, Hkv 4)": (1, 8, 28, 4, 128, 2048, 256, 134),
    "16 rollouts (N 128)": (1, 16, 16, 2, 128, 2048, 256, 134),
    "7B, 16 rollouts (N 112, Hkv 4)": (1, 16, 28, 4, 128, 2048, 256, 134),
    "head dim 64": (1, 8, 16, 2, 64, 2048, 256, 134),
    "P 2 prompts of R 4": (2, 4, 16, 2, 128, 640, 256, 40),
    "pad 300, Lp 1000": (1, 8, 16, 2, 128, 1000, 256, 300),
}


def d2_tc_edge_cases(gen, d2: dict, phase2: dict) -> None:
    """bf16 D2 (the tensor-core kernel) at D2_TC_CASES against its plain
    version within DECODE_TOL; two launches at suffix 199 of each case and
    of phase 2's shape must be bit-equal; the wrapper must refuse f16 and
    head dim 96, and run on the tensor cores only."""
    import torch

    from time_r1_tpu_torch.ops import decode_attention as da

    tol = DECODE_TOL["bfloat16"]
    tc0 = da.shared_prefix_decode_full.tc_launches
    n0 = da.shared_prefix_decode_full.launches
    for case, (P, R, H, Hkv, D, Lp, Lo, pad) in D2_TC_CASES.items():
        base = decode_base(gen, P, R, H, Hkv, D, Lp, Lo, pad)
        for int8 in (False, True):
            x = decode_views(base, torch.bfloat16, int8)
            for own_len in (0, 1, 199):
                got = da.shared_prefix_decode_full(*d2_args(x, own_len))
                want = da.shared_prefix_decode_full_plain(*d2_args(x, own_len))
                label = f"{case}, {'int8' if int8 else 'bf16'} caches, suffix {own_len}"
                check_case(d2, "D2", label, [(got, want)], tol)
                if own_len == 199:
                    again = da.shared_prefix_decode_full(*d2_args(x, own_len))
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"D2 {label}: two launches differ")
                    log(f"[kernels] D2 {label}: two launches bit-equal")
    for int8 in (False, True):
        args = d2_args(decode_views(phase2, torch.bfloat16, int8), 199)
        a, b = da.shared_prefix_decode_full(*args), da.shared_prefix_decode_full(*args)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"D2 ({'int8' if int8 else 'bf16'} caches): two launches differ")
        log(f"[kernels] D2 {'int8' if int8 else 'bf16'} caches: two launches bit-equal")
    runs = da.shared_prefix_decode_full.launches - n0
    if da.shared_prefix_decode_full.tc_launches - tc0 != runs:
        raise AssertionError(f"D2 bf16: {runs} launches, {da.shared_prefix_decode_full.tc_launches - tc0} on the "
                             f"tensor cores")
    x = decode_views(phase2, torch.float16, False)
    b96 = decode_base(gen, 1, 2, 4, 2, 96, 256, 16, 0)
    refused = {"float16": lambda: da.shared_prefix_decode_full(*d2_args(x, 10)),
               "head dim 96": lambda: da.shared_prefix_decode_full(*d2_args(decode_views(b96, torch.bfloat16, False),
                                                                            10))}
    for what, call in refused.items():
        try:
            call()
        except ValueError as e:
            log(f"[kernels] shared_prefix_decode_full refuses {what}: {e}")
        else:
            raise AssertionError(f"shared_prefix_decode_full took {what}")


def phase_decode_quant_kernels() -> dict:
    """D1, D2, Q1 and Q2 against their plain versions at the quantized
    rollout's shapes; times in bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = decode_kernels(gen)
    out.update(quant_kernels(gen))
    return out


def decode_kernels(gen) -> dict:
    """D1 and D2 against their plain versions at the G-way rollout's shapes
    (one 2048-token prompt with 134 left-pad keys, G = 8 rows, the suffix
    cache of 256 slots), in bf16 and f32 activations, with caches in the
    activation dtype and in int8, and D2's tensor-core edge cases; times in
    bf16."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    H, Hkv, D, pad, P, R, Lp, Lo = 16, 2, 128, 134, 1, 8, 2048, 256
    G, B = H // Hkv, P * R
    N = R * G
    base = decode_base(gen, P, R, H, Hkv, D, Lp, Lo, pad)
    bias = base["bias"]

    def decode_inputs(dtype, int8: bool, lp: int = Lp):
        return decode_views(base, dtype, int8, lp)

    d1 = {"name": "shared_prefix_decode_attention", "cases": {}}
    d2 = {"name": "shared_prefix_decode_full", "cases": {}}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        for int8 in (False, True):
            x = decode_inputs(dtype, int8)
            case = f"{key}, {'int8' if int8 else key} caches"
            got, want = da.shared_prefix_decode_attention(*d1_args(x)), da.shared_prefix_decode_attention_plain(*d1_args(x))
            check_case(d1, "D1 (acc, m, l)", case, list(zip(got, want)), DECODE_TOL["float32"])
            for own_len in (0, 1, 199):
                got = da.shared_prefix_decode_full(*d2_args(x, own_len))
                want = da.shared_prefix_decode_full_plain(*d2_args(x, own_len))
                check_case(d2, "D2", f"{case}, suffix {own_len}", [(got, want)], DECODE_TOL[key])
    # a prefix of 2000 keys, which fits no TPU block and ends in a partial
    # 64-key tile: the decode step takes D2 at any prefix length
    for int8 in (False, True):
        x = decode_inputs(torch.bfloat16, int8, lp=2000)
        case = f"bfloat16, {'int8' if int8 else 'bfloat16'} caches, Lp 2000"
        got, want = da.shared_prefix_decode_attention(*d1_args(x)), da.shared_prefix_decode_attention_plain(*d1_args(x))
        check_case(d1, "D1 (acc, m, l)", case, list(zip(got, want)), DECODE_TOL["float32"])
        got, want = da.shared_prefix_decode_full(*d2_args(x, 199)), da.shared_prefix_decode_full_plain(*d2_args(x, 199))
        check_case(d2, "D2", f"{case}, suffix 199", [(got, want)], DECODE_TOL["bfloat16"])
    d2_tc_edge_cases(torch.Generator(device=dev).manual_seed(8), d2, base)
    d1["tol"] = d1["tol_f32"] = DECODE_TOL["float32"]
    d2["tol"], d2["tol_f32"] = DECODE_TOL["bfloat16"], DECODE_TOL["float32"]

    # times: bf16 activations, bf16 and int8 caches, suffix length 199 (the
    # step in the middle of a 200-token rollout)
    live, own = Lp - pad, 199
    cat_k = torch.cat([base["kp"].expand(B, -1, -1, -1), base["ko"][:, :own], base["kn"][:, None]], 1)
    cat_v = torch.cat([base["vp"].expand(B, -1, -1, -1), base["vo"][:, :own], base["vn"][:, None]], 1)
    cat_mask = torch.cat([bias.expand(B, -1), torch.zeros(B, own + 1, device=dev)], 1)[:, None, None, :]
    qt = base["q"].transpose(1, 2).to(torch.bfloat16)
    kt, vt = cat_k.transpose(1, 2).to(torch.bfloat16), cat_v.transpose(1, 2).to(torch.bfloat16)
    mk = cat_mask.to(torch.bfloat16)
    sdpa_full = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mk, enable_gqa=True), 50)
    kpt, vpt = (base[n].transpose(1, 2).to(torch.bfloat16) for n in ("kp", "vp"))
    qp = base["q"].to(torch.bfloat16).reshape(P, R, H, D).transpose(1, 2)
    mp = bias[:, None, None, :].to(torch.bfloat16)
    sdpa_prefix = cuda_ms(lambda: F.scaled_dot_product_attention(qp, kpt, vpt, attn_mask=mp, enable_gqa=True), 50)
    for int8 in (False, True):
        x = decode_inputs(torch.bfloat16, int8)
        kv_bytes = 1 if int8 else 2
        scale_bytes = 2 * 4 if int8 else 0
        io_q = P * Hkv * N * D * 2
        d1_bytes = (P * Hkv * live * (2 * D * kv_bytes + scale_bytes) + io_q + Lp * P * 4
                    + P * Hkv * N * (D + 2) * 4)
        d2_bytes = (P * Hkv * live * (2 * D * kv_bytes + scale_bytes) + B * Hkv * own * (2 * D * kv_bytes + scale_bytes)
                    + 2 * B * Hkv * D * 2 + 2 * io_q + Lp * P * 4)
        suffix = " int8" if int8 else ""
        for e, fn, plain, args, flops, nbytes, lib in (
            (d1, da.shared_prefix_decode_attention, da.shared_prefix_decode_attention_plain, d1_args(x),
             4.0 * D * N * live * P * Hkv, d1_bytes, sdpa_prefix),
            (d2, da.shared_prefix_decode_full, da.shared_prefix_decode_full_plain, d2_args(x, own),
             4.0 * D * (N * live * P * Hkv + B * H * (own + 1)), d2_bytes, sdpa_full),
        ):
            ms, plain_ms = cuda_ms(lambda: fn(*args), 50), cuda_ms(lambda: plain(*args), 10)
            call = cuda_ms(lambda: fn(*args), 50, queued=False)
            b_ms, b_by = bound(flops, nbytes)
            if int8:
                e.update(ms_int8=ms, call_ms_int8=call, plain_ms_int8=plain_ms, bound_ms_int8=b_ms, bound_by_int8=b_by)
            else:
                e.update(ms=ms, kernel_ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib)
            log(f"[kernels] {e['name']}{suffix}: {ms:.4f} ms on the device, {call:.4f} ms per call from Python "
                f"(plain {plain_ms:.3f}, bound {b_ms:.5f} by {b_by}, library {lib:.4f})")
    d1["library_is"] = "SDPA of the 64 query rows over the prefix, bf16"
    d2["library_is"] = "SDPA over [prefix repeated per row | live suffix | new token] with the mask, bf16"
    for e in (d1, d2):
        e["tol_is"] = "on max_rel_err and each of `cases`: max |kernel - plain| / max |plain|"
    return {d1["name"]: d1, d2["name"]: d2}


def quant_kernels(gen) -> dict:
    """Q1 (`q1_kernel`), then Q2 (`q2_kernel`)."""
    q1 = q1_kernel(gen)
    q2 = q2_kernel(gen)
    return {q1["name"]: q1, q2["name"]: q2}


# D2 and Q2 at phase 15's TP-local shapes: one kv head a rank (the 3B's 16 q
# over 2 kv at tp 2, G 8; the 7B's 28 over 4 at tp 4, G 7) at the G-way
# step's shape of `decode_kernels` (P, R, H, Hkv, D, Lp, Lo, left pad), and
# the MLP's inter / tp (the 3B's 11008 at tp 2, the 7B's 18944 at tp 4) at
# (hid, inter), M rows each
# the 3B at tp 4 and 8 (phase 17): one replicated kv head a rank under 4 and 2 q heads
TP_D2 = {"3B_tp2_G8": (1, 8, 8, 1, 128, 2048, 256, 134), "7B_tp4_G7": (1, 8, 7, 1, 128, 2048, 256, 134),
         "3B_tp4_G4": (1, 8, 4, 1, 128, 2048, 256, 134), "3B_tp8_G2": (1, 8, 2, 1, 128, 2048, 256, 134)}
TP_Q2 = {"3B_tp2": (2048, 5504), "7B_tp4": (3584, 4736), "3B_tp4": (2048, 2752), "3B_tp8": (2048, 1376)}
TP_Q2_ROWS = (1, 8)
# max |Σ_m Q2(x, rank m's block) − Q2(x, whole)| / max |Q2(x, whole)|, f32 x: gate, up and the bf16 activation are
# the same numbers in both (each a sum over hid), so only the order of down's f32 sums over inter differs
Q2_PARTIAL_TOL = 1e-5


def tp_decode_quant_cases(gen, results: dict) -> None:
    """D2 at TP_D2 over bf16 and int8 caches (bf16 and f32 activations,
    suffix lengths 0, 1, 199) and Q2 at TP_Q2 (M 1 and 8: bf16 end to end
    and both dtypes with their phases apart) against their plain versions;
    each timed in bf16 (D2 at suffix 199, Q2 at M 8) beside its bound, its
    plain version and one library call; written to the kernels' entries as
    their tags."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops import decode_attention as da
    from time_r1_tpu_torch.ops.fused_mlp import _launch as fused_mlp_launch
    from time_r1_tpu_torch.ops.fused_mlp import fused_mlp_int8, fused_mlp_int8_plain
    from time_r1_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    dev = torch.device("cuda")
    for tag, (P, R, H, Hkv, D, Lp, Lo, pad) in TP_D2.items():
        base = decode_base(gen, P, R, H, Hkv, D, Lp, Lo, pad)
        row = {"cases": {}}
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[-1]
            for int8 in (False, True):
                x = decode_views(base, dtype, int8)
                for own_len in (0, 1, 199):
                    got = da.shared_prefix_decode_full(*d2_args(x, own_len))
                    want = da.shared_prefix_decode_full_plain(*d2_args(x, own_len))
                    check_case(row, f"D2 {tag}", f"{key}, {'int8' if int8 else key} caches, suffix {own_len}",
                               [(got, want)], DECODE_TOL[key])
        B, N, own, live = P * R, R * (H // Hkv), 199, Lp - pad
        cat = {n: torch.cat([base[f"{n}p"].expand(B, -1, -1, -1), base[f"{n}o"][:, :own], base[f"{n}n"][:, None]], 1)
               .transpose(1, 2).to(torch.bfloat16) for n in ("k", "v")}
        mask = torch.cat([base["bias"].expand(B, -1), torch.zeros(B, own + 1, device=dev)], 1)[:, None, None, :]
        qt, mk = base["q"].transpose(1, 2).to(torch.bfloat16), mask.to(torch.bfloat16)
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, cat["k"], cat["v"], attn_mask=mk,
                                                                           enable_gqa=True), 50)
        for int8 in (False, True):
            args = d2_args(decode_views(base, torch.bfloat16, int8), own)
            kv, sc = (1, 8) if int8 else (2, 0)
            nbytes = (P * Hkv * live * (2 * D * kv + sc) + B * Hkv * own * (2 * D * kv + sc) + 2 * B * Hkv * D * 2
                      + 2 * P * Hkv * N * D * 2 + Lp * P * 4)
            b_ms, b_by = bound(4.0 * D * (N * live * P * Hkv + B * H * (own + 1)), nbytes)
            sfx = "_int8" if int8 else ""
            row.update({f"ms{sfx}": cuda_ms(lambda: da.shared_prefix_decode_full(*args), 50),
                        f"call_ms{sfx}": cuda_ms(lambda: da.shared_prefix_decode_full(*args), 50, queued=False),
                        f"plain_ms{sfx}": cuda_ms(lambda: da.shared_prefix_decode_full_plain(*args), 10),
                        f"bound_ms{sfx}": b_ms, f"bound_by{sfx}": b_by})
            log(f"[kernels] D2 {tag}{sfx} (H {H} over Hkv {Hkv}): {row[f'ms{sfx}']:.4f} ms on the device, "
                f"{row[f'call_ms{sfx}']:.4f} ms per call (plain {row[f'plain_ms{sfx}']:.3f}, bound {b_ms:.5f} by "
                f"{b_by}, library {row['library_ms']:.4f})")
        results["shared_prefix_decode_full"][tag] = row

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    for tag, (hid, inter) in TP_Q2.items():
        gu, dn = quantize_weight(randn(2 * inter, hid) * 0.02), quantize_weight(randn(hid, inter) * 0.02)
        row = {"cases": {}, "phases_apart": {}}
        for M in TP_Q2_ROWS:
            xf = randn(M, hid)
            for dtype in (torch.bfloat16, torch.float32):
                key = str(dtype).split(".")[-1]
                args = (xf.to(dtype), gu["q8"], gu["s"], dn["q8"], dn["s"])
                y, act = fused_mlp_launch(*args)
                case = f"M={M} hid={hid} inter={inter} {key}"
                row["phases_apart"][case] = q2_phases_apart(y, act, *args)
                if dtype is torch.bfloat16:
                    check_case(row, f"Q2 {tag}", case, [(y, fused_mlp_int8_plain(*args))], QUANT_TOL[key])
        M = TP_Q2_ROWS[-1]
        args = (randn(M, hid).to(torch.bfloat16), gu["q8"], gu["s"], dn["q8"], dn["s"])
        gud, dnd = dequantize_weight(gu, torch.bfloat16), dequantize_weight(dn, torch.bfloat16)

        def library():
            g, u = F.linear(args[0], gud).chunk(2, dim=-1)
            return F.linear(F.silu(g) * u, dnd)

        weight_bytes = 3 * inter * hid
        b_ms, b_by = bound(2.0 * M * hid * 3 * inter, weight_bytes + (2 * inter + hid) * 4 + 2 * M * hid * 2)
        row.update(ms=cuda_ms(lambda: fused_mlp_int8(*args), 50),
                   call_ms=cuda_ms(lambda: fused_mlp_int8(*args), 50, queued=False),
                   plain_ms=cuda_ms(lambda: fused_mlp_int8_plain(*args), 10), library_ms=cuda_ms(library, 50),
                   bound_ms=b_ms, bound_by=b_by, rows=M)
        row["weight_gbps"] = weight_bytes / row["ms"] / 1e6
        log(f"[kernels] Q2 {tag} (hid {hid}, inter {inter}, M {M}): {row['ms']:.4f} ms on the device "
            f"({row['weight_gbps']:.0f} GB/s of int8 weights, {100 * b_ms / row['ms']:.1f}% of the bound), "
            f"{row['call_ms']:.4f} ms per call (plain {row['plain_ms']:.3f}, bound {b_ms:.5f} by {b_by}, library "
            f"{row['library_ms']:.4f})")
        row["partial_sums"] = q2_partial_sums(gen, hid, inter, int(tag.split("_tp")[1]))
        results["fused_mlp_int8"][tag] = row


def q2_partial_sums(gen, hid: int, inter: int, tp: int) -> float:
    """The TP Engine's Q2 route on the card: a whole (hid, tp·inter) MLP
    quantized whole, each rank's block taken as `serving_layer` takes it
    (its gate and up rows with their scales, its columns of down with every
    scale whole), Q2 launched over each block and the partial sums added,
    against Q2 over the whole MLP; f32, M 8. Raises above Q2_PARTIAL_TOL."""
    import torch

    from time_r1_tpu_torch.ops.fused_mlp import fused_mlp_int8
    from time_r1_tpu_torch.ops.quant import quantize_weight

    width = tp * inter

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)

    gu, dn = quantize_weight(randn(2 * width, hid) * 0.02), quantize_weight(randn(hid, width) * 0.02)
    x = randn(TP_Q2_ROWS[-1], hid)
    whole = fused_mlp_int8(x, gu["q8"], gu["s"], dn["q8"], dn["s"])
    total = torch.zeros_like(whole)
    for m in range(tp):
        rows = torch.cat([torch.arange(m * inter, (m + 1) * inter), width + torch.arange(m * inter, (m + 1) * inter)])
        total += fused_mlp_int8(x, gu["q8"][rows].contiguous(), gu["s"][rows].contiguous(),
                                dn["q8"][:, m * inter:(m + 1) * inter].contiguous(), dn["s"])
    err = ((total - whole).abs().max() / whole.abs().max()).item()
    log(f"[kernels] Q2 partial sums over {tp} blocks of inter {inter} (hid {hid}, f32): {err:.3e} of the whole "
        f"MLP's max (limit {Q2_PARTIAL_TOL})")
    if not err <= Q2_PARTIAL_TOL:
        raise AssertionError(f"Q2 partial sums over {tp} blocks: {err} > {Q2_PARTIAL_TOL}")
    return err


# phase 16's kernels at the TP-local shapes: P1 / P2 at one kv head a rank (the 3B's 16 q over 2 kv heads at tp 2,
# G 8; the 7B's 28 over 4 at tp 4, G 7), 4 slots over a 2048-key prefix and at mixed lengths; Q1 at the rank's
# widths of the four int4 products (qkv and gate|up split along N, o and down along K), M 4 and 8
TP_PAGED = {"3B_tp2_G8": 8, "7B_tp4_G7": 7, "3B_tp4_G4": 4, "3B_tp8_G2": 2}
TP_PAGED_LENGTHS = {"prefix 2048": (2048,) * 4, "mixed": (0, 327, 1689, 2041)}
TP_Q1 = {
    "3B_tp2": {"qkv": (1280, 2048), "o": (2048, 1024), "gu": (11008, 2048), "down": (2048, 5504)},
    "7B_tp4": {"qkv": (1152, 3584), "o": (3584, 896), "gu": (9472, 3584), "down": (3584, 4736)},
    # the 3B at tp 4: q over its replicated kv head; down's K 2752 (2752 % 128 = 64) takes the FMA kernel
    "3B_tp4": {"qkv": (768, 2048), "o": (2048, 512), "gu": (5504, 2048), "down": (2048, 2752)},
}
TP_Q1_ROWS = (4, 8)


def tp_paged_q1_cases(gen, results: dict) -> None:
    """P1 and P2 at TP_PAGED's heads (one kv head, G 8 and 7) and
    TP_PAGED_LENGTHS, and Q1 at TP_Q1's products and TP_Q1_ROWS, against
    their plain versions in bf16 (the tensor-core kernels, each launch's
    route read from `.tc_launches`, two launches bit-equal) and f32 (the FMA
    kernels); each timed in bf16 (P1 / P2 at the 2048-key prefix, Q1 a
    layer's four products at M 8) beside its bound, its plain version and
    one library call (SDPA over the bf16 view; `F.linear` over dequantized
    weights); written to the kernels' entries as their tags."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops import paged_attention as pa
    from time_r1_tpu_torch.ops.int4_matmul import TC_K, UNIT, int4_matmul, int4_matmul_plain
    from time_r1_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    dev = torch.device("cuda")

    def upcast(args):
        return [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args]

    for tag, G in TP_PAGED.items():
        rows = {n: {"cases": {}} for n in PAGED_KERNELS}
        for label, lengths in TP_PAGED_LENGTHS.items():
            c = paged_case(gen, dev, lengths, 128, 16, 65, G=G, nkv=1)
            live = c["lengths"] > 0
            for dtype in (torch.bfloat16, torch.float32):
                key = str(dtype).split(".")[-1]
                p1 = (c["q"].to(dtype), c["kp"].to(dtype), c["vp"].to(dtype), c["table"], c["lengths"], c["P"])
                p2 = (c["q"].to(dtype), c["k8"], c["v8"], c["ks"], c["vs"], c["table"], c["lengths"], c["P"])
                for name, fn, plain, args in ((PAGED_KERNELS[0], pa.paged_prefix_attention,
                                               pa.paged_prefix_attention_plain, p1),
                                              (PAGED_KERNELS[1], pa.paged_prefix_attention_q8,
                                               pa.paged_prefix_attention_q8_plain, p2)):
                    n0, tc0 = fn.launches, fn.tc_launches
                    got, want = fn(*args), plain(*upcast(args))
                    torch.cuda.synchronize()
                    tc = dtype is torch.bfloat16
                    if (fn.launches - n0, fn.tc_launches - tc0) != (1, int(tc)):
                        raise AssertionError(f"{name} {tag} {label} {key}: {fn.launches - n0} launches, "
                                             f"{fn.tc_launches - tc0} on the tensor cores")
                    if tc and not all(torch.equal(x, y) for x, y in zip(got, fn(*args))):
                        raise AssertionError(f"{name} {tag} {label} {key}: two launches differ")
                    (acc, m, l), (acc_w, m_w, l_w) = got, want
                    check_case(rows[name], f"{name} {tag}", f"{label}, {key}",
                               [(acc, acc_w), (m[live], m_w[live]), (l, l_w)], PAGED_TOL[key])
        c = paged_case(gen, dev, TP_PAGED_LENGTHS["prefix 2048"], 128, 16, 65, G=G, nkv=1)
        S, nkv, _, D = c["q"].shape
        live_keys, view, idx = sum(c["lengths"].tolist()), c["table"].shape[1] * c["P"], c["table"].long()
        qt = c["q"].to(torch.bfloat16).reshape(S, nkv * G, 1, D)
        kt = c["kp"].to(torch.bfloat16)[:, idx].reshape(nkv, S, view, D).transpose(0, 1).repeat_interleave(G, dim=1)
        vt = c["vp"].to(torch.bfloat16)[:, idx].reshape(nkv, S, view, D).transpose(0, 1).repeat_interleave(G, dim=1)
        mask = torch.where(torch.arange(view, device=dev)[None] < c["lengths"][:, None], 0.0, -1e4)
        mask = mask.to(torch.bfloat16)[:, None, None, :]
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 50)
        small = S * nkv * G * D * 2 + c["table"].numel() * 4 + S * 4 + S * nkv * G * (D + 2) * 4
        for name, fn, plain, args, kv_bytes in (
            (PAGED_KERNELS[0], pa.paged_prefix_attention, pa.paged_prefix_attention_plain,
             (c["q"].to(torch.bfloat16), c["kp"].to(torch.bfloat16), c["vp"].to(torch.bfloat16), c["table"],
              c["lengths"], c["P"]), live_keys * nkv * D * 2 * 2),
            (PAGED_KERNELS[1], pa.paged_prefix_attention_q8, pa.paged_prefix_attention_q8_plain,
             (c["q"].to(torch.bfloat16), c["k8"], c["v8"], c["ks"], c["vs"], c["table"], c["lengths"], c["P"]),
             live_keys * nkv * (D * 2 + 8)),
        ):
            row = rows[name]
            b_ms, b_by = bound(4.0 * live_keys * nkv * G * D, kv_bytes + small)
            row.update(ms=cuda_ms(lambda: fn(*args), 50), call_ms=cuda_ms(lambda: fn(*args), 50, queued=False),
                       plain_ms=cuda_ms(lambda: plain(*args), 10), library_ms=sdpa, bound_ms=b_ms, bound_by=b_by)
            row["bound_share"] = b_ms / row["ms"]
            log(f"[kernels] {name} {tag} (G {G} over 1 kv head, 4 slots of 2048 keys): {row['ms']:.4f} ms on the "
                f"device ({100 * row['bound_share']:.1f}% of the bound {b_ms:.5f} by {b_by}), {row['call_ms']:.4f} "
                f"ms per call (plain {row['plain_ms']:.3f}, library {sdpa:.4f})")
            results[name][tag] = row

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    for tag, products in TP_Q1.items():
        row = {"cases": {}, "per_product": {}}
        weights = {name: quantize_weight(randn(N, K) * 0.02, bits=4) for name, (N, K) in products.items()}
        for name, (N, K) in products.items():
            w = weights[name]
            for M in TP_Q1_ROWS:
                xf = randn(M, K)
                for dtype in (torch.bfloat16, torch.float32):
                    key = str(dtype).split(".")[-1]
                    x = xf.to(dtype)
                    n0, tc0 = int4_matmul.launches, int4_matmul.tc_launches
                    got = int4_matmul(x, w["q4"], w["s"])
                    # bf16 takes the tensor cores where N % 16 and K % 128 allow (`ops/int4_matmul.py::check_args`)
                    tc = dtype is torch.bfloat16 and K % TC_K == 0 and N % UNIT == 0
                    if (int4_matmul.launches - n0, int4_matmul.tc_launches - tc0) != (1, int(tc)):
                        raise AssertionError(f"Q1 {tag} {name} M={M} {key}: {int4_matmul.launches - n0} launches, "
                                             f"{int4_matmul.tc_launches - tc0} on the tensor cores")
                    if tc and not torch.equal(got, int4_matmul(x, w["q4"], w["s"])):
                        raise AssertionError(f"Q1 {tag} {name} M={M}: two launches differ")
                    check_case(row, f"Q1 {tag}", f"{name} M={M} ({N}, {K}) {key}",
                               [(got, int4_matmul_plain(x, w["q4"], w["s"]))], QUANT_TOL[key])
        M = TP_Q1_ROWS[-1]
        sums = {k: 0.0 for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
        for name, (N, K) in products.items():
            w = weights[name]
            x = randn(M, K).to(torch.bfloat16)
            wd = dequantize_weight(w, torch.bfloat16)
            t = dict(ms=cuda_ms(lambda: int4_matmul(x, w["q4"], w["s"]), 50),
                     call_ms=cuda_ms(lambda: int4_matmul(x, w["q4"], w["s"]), 50, queued=False),
                     plain_ms=cuda_ms(lambda: int4_matmul_plain(x, w["q4"], w["s"]), 10),
                     library_ms=cuda_ms(lambda: F.linear(x, wd), 50))
            del wd
            t["bound_ms"], t["bound_by"] = bound(2.0 * M * N * K, N * K // 2 + N * 4 + M * K * 2 + M * N * 2)
            t["weight_gbps"] = N * K // 2 / t["ms"] / 1e6
            row["per_product"][f"M={M} {name}"] = t
            for k in sums:
                sums[k] += t[k]
            log(f"[kernels] int4_matmul {tag} {name} ({N}, {K}) M={M}: {t['ms']:.4f} ms on the device "
                f"({t['weight_gbps']:.0f} GB/s of int4 weights, {100 * t['bound_ms'] / t['ms']:.1f}% of the bound "
                f"{t['bound_ms']:.5f} by {t['bound_by']}), {t['call_ms']:.4f} ms per call, plain {t['plain_ms']:.3f}, "
                f"library {t['library_ms']:.4f}")
        row.update(sums, rows=M, bound_by="/".join(sorted({t["bound_by"] for t in row["per_product"].values()})),
                   bound_share=sums["bound_ms"] / sums["ms"])
        log(f"[kernels] int4_matmul {tag} M={M}, a layer's four products at the rank's widths: {sums['ms']:.4f} ms "
            f"({100 * row['bound_share']:.1f}% of the bound {sums['bound_ms']:.5f}; plain {sums['plain_ms']:.3f}, "
            f"library {sums['library_ms']:.4f})")
        results["int4_matmul"][tag] = row


# Q1's checks: the int4 decode products (N, K) of Qwen2.5-VL 3B at M = 1, 8,
# 16, 200 and 256 rows (the JAX package's threshold) and of 7B at M = 8, and
# a ragged shape outside the tensor-core rule (N % 16, K % 128), in bf16 and
# f32; times at 3B M = 1, 8 and 200 and at 7B M = 8, bf16.
Q1_SHAPES = {
    "3B": {"qkv": (2560, 2048), "o": (2048, 2048), "gu": (22016, 2048), "down": (2048, 11008)},
    "7B": {"qkv": (4608, 3584), "o": (3584, 3584), "gu": (37888, 3584), "down": (3584, 18944)},
}
Q1_CASES = ([(M, "3B", name) for M in (1, 8, 16, 200, 256) for name in Q1_SHAPES["3B"]]
            + [(8, "7B", name) for name in Q1_SHAPES["7B"]])
Q1_RAGGED = (3, 300, 1000)  # M, N, K
Q1_TIMED = [(M, "3B") for M in (8, 1, 200)] + [(8, "7B")]
Q1_BIT_EQUAL = [(8, "3B", "gu"), (16, "3B", "down"), (200, "3B", "qkv"), (8, "7B", "down")]


def q1_kernel(gen) -> dict:
    """Q1 against its plain version at `Q1_CASES` and the ragged shape, in
    bf16 (the tensor-core kernel, the ragged shape the FMA kernel) and f32
    (the FMA kernel), each launch's route read from `.tc_launches`; two bf16
    launches bit-equal; the refusals; device times at `Q1_TIMED` beside the
    bound, the library and PyTorch's sum over the same bytes."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain
    from time_r1_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    weights = {}

    def weight(N, K):
        if (N, K) not in weights:
            weights[(N, K)] = quantize_weight(randn(N, K) * 0.02, bits=4)
        return weights[(N, K)]

    def routed(x, w, tensor_cores: bool, label: str):
        n0, tc0 = int4_matmul.launches, int4_matmul.tc_launches
        y = int4_matmul(x, w["q4"], w["s"])
        if int4_matmul.launches - n0 != 1 or int4_matmul.tc_launches - tc0 != int(tensor_cores):
            raise AssertionError(f"Q1 {label}: {int4_matmul.launches - n0} launches, "
                                 f"{int4_matmul.tc_launches - tc0} on the tensor cores; want 1, {int(tensor_cores)}")
        return y

    q1 = {"name": "int4_matmul", "cases": {}, "per_product": {}}
    ragged = (Q1_RAGGED[0], "ragged", None)
    for M, model, name in Q1_CASES + [ragged]:
        N, K = Q1_SHAPES[model][name] if model != "ragged" else Q1_RAGGED[1:]
        w = weight(N, K)
        xf = randn(M, K)
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[-1]
            case = f"{model}{' ' + name if name else ''} M={M} ({N}, {K}) {key}"
            x = xf.to(dtype)
            got = routed(x, w, dtype is torch.bfloat16 and model != "ragged", case)
            check_case(q1, "Q1", case, [(got, int4_matmul_plain(x, w["q4"], w["s"]))], QUANT_TOL[key])
    for M, model, name in Q1_BIT_EQUAL:
        N, K = Q1_SHAPES[model][name]
        w = weight(N, K)
        x = randn(M, K).to(torch.bfloat16)
        if not torch.equal(int4_matmul(x, w["q4"], w["s"]), int4_matmul(x, w["q4"], w["s"])):
            raise AssertionError(f"Q1 {model} {name} M={M}: two launches differ")
        log(f"[kernels] Q1 {model} {name} M={M}: two launches bit-equal")
    w = weight(2048, 2048)
    x = randn(8, 2048).to(torch.bfloat16)
    bad = {
        "float16 x": (x.half(), w["q4"], w["s"]),
        "w4 of the wrong width": (x, w["q4"][:, :-16].contiguous(), w["s"]),
        "float64 scales": (x, w["q4"], w["s"].double()),
        "a non-contiguous x": (randn(2048, 8).to(torch.bfloat16).t(), w["q4"], w["s"]),
        "a misaligned bf16 x": (randn(8 * 2048 + 1).to(torch.bfloat16)[1:].view(8, 2048), w["q4"], w["s"]),
    }
    refused = []
    for what, args in bad.items():
        before = int4_matmul.launches
        try:
            int4_matmul(*args)
        except ValueError as e:
            refused.append(what)
            log(f"[kernels] Q1 refuses {what}: {e}")
        else:
            raise AssertionError(f"Q1 took {what}")
        if int4_matmul.launches != before:
            raise AssertionError("Q1 counted a refused launch")
    torch.cuda.synchronize()
    q1["refused"] = refused

    for M, model in Q1_TIMED:
        sums = {k: 0.0 for k in ("ms", "library_ms", "bound_ms", "read_yardstick_ms")}
        for name, (N, K) in Q1_SHAPES[model].items():
            w = weight(N, K)
            x = randn(M, K).to(torch.bfloat16)
            wd = dequantize_weight(w, torch.bfloat16)
            t = dict(ms=cuda_ms(lambda: int4_matmul(x, w["q4"], w["s"]), 50),
                     library_ms=cuda_ms(lambda: F.linear(x, wd), 50),
                     # one PyTorch reduction over the same packed bytes: the card's streaming rate as PyTorch sees it
                     read_yardstick_ms=cuda_ms(lambda: w["q4"].view(torch.float32).sum(), 50))
            if (M, model) == (8, "3B"):
                t["call_ms"] = cuda_ms(lambda: int4_matmul(x, w["q4"], w["s"]), 50, queued=False)
                t["plain_ms"] = cuda_ms(lambda: int4_matmul_plain(x, w["q4"], w["s"]), 10)
            del wd
            weight_bytes = N * K // 2
            t["bound_ms"], t["bound_by"] = bound(2.0 * M * N * K, weight_bytes + N * 4 + M * K * 2 + M * N * 2)
            t["weight_gbps"] = weight_bytes / t["ms"] / 1e6
            t["bound_share"] = t["bound_ms"] / t["ms"]
            q1["per_product"][f"{model} M={M} {name}"] = t
            for k in sums:
                sums[k] += t[k]
            log(f"[kernels] int4_matmul {model} {name} ({N}, {K}) M={M}: {t['ms']:.4f} ms on the device "
                f"({t['weight_gbps']:.0f} GB/s of int4 weights, {100 * t['bound_share']:.1f}% of the bound "
                f"{t['bound_ms']:.5f} by {t['bound_by']}), library {t['library_ms']:.4f}, PyTorch's sum over the "
                f"bytes {t['read_yardstick_ms']:.4f}"
                + (f", {t['call_ms']:.4f} per call from Python, plain {t['plain_ms']:.3f}" if "call_ms" in t else ""))
        log(f"[kernels] int4_matmul {model} M={M}, a layer's four products: {sums['ms']:.4f} ms (bound "
            f"{sums['bound_ms']:.5f}, {100 * sums['bound_ms'] / sums['ms']:.1f}%; library {sums['library_ms']:.4f}; "
            f"PyTorch's sums {sums['read_yardstick_ms']:.4f})")
        if (M, model) == (8, "3B"):
            q1.update(sums)
            q1["bound_by"] = "/".join(sorted({q1["per_product"][f"3B M=8 {n}"]["bound_by"] for n in Q1_SHAPES["3B"]}))
            for k in ("call_ms", "plain_ms"):
                q1[k] = sum(q1["per_product"][f"3B M=8 {n}"][k] for n in Q1_SHAPES["3B"])
        else:
            q1[f"layer_{model}_M{M}"] = sums
    q1["kernel_ms"] = q1["ms"]
    q1["times_are"] = "sums over one 3B layer's four products (qkv, o, gu, down) at M = 8, bf16 (tensor cores)"
    q1["library_is"] = "F.linear in bf16 over weights dequantized before timing (4x the weight bytes)"
    q1["tol"], q1["tol_f32"] = QUANT_TOL["bfloat16"], QUANT_TOL["float32"]
    q1["tol_is"] = "on max_rel_err and each of `cases`: max |kernel - plain| / max |plain|"
    return q1


# Q2's checks, (hid, inter, M): the 3B widths at the decode's M and past one
# 16-row pass, the 7B widths, and a shape only the port takes (inter 272 is
# no multiple of 64: a ragged last 64-deep block in phase B).
Q2_CASES = [(2048, 11008, M) for M in (1, 4, 7, 8, 16, 128)] + [(3584, 18944, 7), (3584, 18944, 8), (256, 272, 3)]


# Q2 is held with its two phases apart (`q2_phases_apart`) in every case, and
# in bf16 also end to end at QUANT_TOL. In f32 the end-to-end error is
# logged, not held: the function rounds each activation, an f32 sum over hid
# products, to bf16, so two right implementations that sum in other orders
# (the kernel and cuBLAS under the plain version) round some activations to
# neighbouring bf16 values (1 to 4 in 10^4 here, at every M); one step of
# a large activation moves an output by a few 1e-4 of the largest, past
# QUANT_TOL's 1e-4, and how many such flips a case has depends on its data.
Q2_FLIP_SHARE = 1e-3  # the most activations allowed one bf16 step off the plain version's


def q2_phases_apart(y, act, x, gu_q8, gu_s, down_q8, down_s) -> dict:
    """Q2's two phases held apart: phase A's bf16 activation against the
    plain version's f32 activation (each element within one bf16 step of it,
    plus the worst-case error of an f32 sum of hid products in any order,
    hid·2^-24·Σ|terms|, carried through silu(g)·u; at most Q2_FLIP_SHARE of
    them not the nearest bf16), and phase B's output against the plain down
    product over the kernel's own activation (QUANT_TOL: sums in another
    order, and in bf16 the output's rounding)."""
    import torch
    import torch.nn.functional as F

    hid, inter = x.shape[1], down_q8.shape[1]
    xb = x.to(torch.bfloat16).float()
    wg, wu = gu_q8[:inter].float(), gu_q8[inter:].float()
    sg, su = gu_s[:inter].reshape(-1), gu_s[inter:].reshape(-1)
    g, u = (xb @ wg.t()) * sg, (xb @ wu.t()) * su
    pre = F.silu(g) * u
    near = pre.to(torch.bfloat16).float()
    # the bf16 spacing at each value: the next bf16 after |near| (bits + 1), less |near|
    step = (near.abs().to(torch.bfloat16).view(torch.int16) + 1).view(torch.bfloat16).float() - near.abs()
    eps = hid * 2.0**-24
    bg, bu = eps * (xb.abs() @ wg.abs().t()) * sg, eps * (xb.abs() @ wu.abs().t()) * su
    slack = 1.1 * u.abs() * bg + F.silu(g).abs() * bu  # |silu'| <= 1.1
    got = act.float()
    off = got != near
    outside = ((got - pre).abs() >= step + slack).sum().item()
    share = off.float().mean().item()
    want = ((got @ down_q8.float().t()) * down_s.reshape(-1)).to(y.dtype)
    rel = (y.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    key = str(y.dtype).split(".")[-1]
    out = dict(activation_off_share=share, activation_outside=outside, down_rel_err=rel)
    if outside or share > Q2_FLIP_SHARE or not rel <= QUANT_TOL[key]:
        raise AssertionError(f"Q2 phases apart: {out} (share <= {Q2_FLIP_SHARE}, rel <= {QUANT_TOL[key]})")
    return out


def q2_kernel(gen) -> dict:
    """Q2 against its plain version at `Q2_CASES` in bf16 and f32, two
    launches bit-equal (one and two 8-row tiles a pass), the refusals
    (inter % 16, M > 128, hid beyond the block's shared memory) before any
    launch; device times at the 3B rollout shape (M = 8, bf16) and at 7B."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.fused_mlp import _launch as fused_mlp_launch
    from time_r1_tpu_torch.ops.fused_mlp import fused_mlp_int8, fused_mlp_int8_plain
    from time_r1_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    weights = {}

    def mlp(hid, inter):
        if (hid, inter) not in weights:
            weights[(hid, inter)] = (quantize_weight(randn(2 * inter, hid) * 0.02),
                                     quantize_weight(randn(hid, inter) * 0.02))
        return weights[(hid, inter)]

    q2 = {"name": "fused_mlp_int8", "cases": {}, "phases_apart": {}, "end_to_end_f32": {}}
    for hid, inter, M in Q2_CASES:
        gu, dn = mlp(hid, inter)
        xf = randn(M, hid)
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[-1]
            case = f"M={M} hid={hid} inter={inter} {key}"
            args = (xf.to(dtype), gu["q8"], gu["s"], dn["q8"], dn["s"])
            y, act = fused_mlp_launch(*args)
            q2["phases_apart"][case] = q2_phases_apart(y, act, *args)
            want = fused_mlp_int8_plain(*args)
            if dtype is torch.float32:  # logged, not held: see Q2_FLIP_SHARE
                rel = (y - want).abs().max().item() / want.abs().max().item()
                q2["end_to_end_f32"][case] = rel
                log(f"[kernels] Q2 {case}: max |kernel - plain| / max |plain| = {rel:.3e} (activation rounding "
                    f"flips; held with its phases apart)")
            else:
                check_case(q2, "Q2", case, [(y, want)], QUANT_TOL[key])
    gu, dn = mlp(2048, 11008)
    for M in (8, 16):
        args = (randn(M, 2048).to(torch.bfloat16), gu["q8"], gu["s"], dn["q8"], dn["s"])
        first, second = fused_mlp_int8(*args), fused_mlp_int8(*args)
        if not torch.equal(first, second):
            raise AssertionError(f"Q2 M={M}: two launches differ")
        log(f"[kernels] Q2 M={M}: two launches bit-equal")
    refused = []
    for M, hid, inter in ((8, 2048, 11000), (129, 2048, 11008), (16, 4736, 1024)):
        g2, d2 = (gu, dn) if (hid, inter) == (2048, 11008) else (
            {"q8": torch.zeros((2 * inter, hid), dtype=torch.int8, device=dev),
             "s": torch.ones((2 * inter, 1), device=dev)},
            {"q8": torch.zeros((hid, inter), dtype=torch.int8, device=dev), "s": torch.ones((hid, 1), device=dev)})
        before = fused_mlp_int8.launches
        try:
            fused_mlp_int8(randn(M, hid).to(torch.bfloat16), g2["q8"], g2["s"], d2["q8"], d2["s"])
        except ValueError as e:
            refused.append(f"M={M} hid={hid} inter={inter}")
            log(f"[kernels] Q2 refuses M={M} hid={hid} inter={inter}: {e}")
        else:
            raise AssertionError(f"Q2 took M={M} hid={hid} inter={inter}")
        if fused_mlp_int8.launches != before:
            raise AssertionError("Q2 counted a refused launch")
    torch.cuda.synchronize()
    q2["refused"] = refused

    def timings(hid, inter, M=8):
        gu, dn = mlp(hid, inter)
        args = (randn(M, hid).to(torch.bfloat16), gu["q8"], gu["s"], dn["q8"], dn["s"])
        gud, dnd = dequantize_weight(gu, torch.bfloat16), dequantize_weight(dn, torch.bfloat16)

        def library():
            g, u = F.linear(args[0], gud).chunk(2, dim=-1)
            return F.linear(F.silu(g) * u, dnd)

        t = dict(ms=cuda_ms(lambda: fused_mlp_int8(*args), 50),
                 call_ms=cuda_ms(lambda: fused_mlp_int8(*args), 50, queued=False),
                 plain_ms=cuda_ms(lambda: fused_mlp_int8_plain(*args), 10),
                 library_ms=cuda_ms(library, 50))
        weight_bytes = 3 * inter * hid
        t["bound_ms"], t["bound_by"] = bound(2.0 * M * hid * 3 * inter,
                                             weight_bytes + (2 * inter + hid) * 4 + 2 * M * hid * 2)
        t["weight_gbps"] = weight_bytes / t["ms"] / 1e6
        t["bound_share"] = t["bound_ms"] / t["ms"]
        log(f"[kernels] fused_mlp_int8 hid={hid} inter={inter} M={M}: {t['ms']:.4f} ms on the device "
            f"({t['weight_gbps']:.0f} GB/s of int8 weights, {100 * t['bound_share']:.1f}% of the bound), "
            f"{t['call_ms']:.4f} ms per call from Python (plain {t['plain_ms']:.3f}, bound {t['bound_ms']:.5f} by "
            f"{t['bound_by']}, library {t['library_ms']:.4f})")
        return t

    q2.update(timings(2048, 11008))
    q2["kernel_ms"] = q2["ms"]
    q2["at_7b"] = timings(3584, 18944)
    q2["library_is"] = "two F.linear in bf16 over weights dequantized before timing, silu between (2x the bytes)"
    q2["tol"], q2["tol_f32"] = QUANT_TOL["bfloat16"], QUANT_TOL["float32"]
    q2["tol_is"] = ("on max_rel_err and each of `cases` (bf16): max |kernel - plain| / max |plain|; every case "
                    "in bf16 and f32 with its phases apart (`phases_apart`, tol on down_rel_err)")
    return q2


# P1/P2 tolerances, as max |kernel - plain| / max |plain| per output: both sides
# sum the same f32 products of the same (bf16 or f32) operands, in another
# order, over up to 4096 keys.
PAGED_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def paged_case(gen, dev, lengths, P: int, max_pages: int, n_pages: int, stale_from: int | None = None,
               G: int = 8, D: int = 128, nkv: int = 2) -> dict:
    """One paged-attention input set: q (S, nkv, G, D), pages (nkv, n_pages,
    P, D) in f32 (cast per dtype by the caller), int8 pages and scales from
    them, and a page table whose live entries are a shuffle of pages 1.. (page
    0 is the engine's scratch sink; dead entries point at it). stale_from:
    slot 0 (length 0) takes that slot's table row, as a retired slot's stale
    row points at pages another slot owns."""
    import torch

    from time_r1_tpu_torch.ops.quant import quantize_kv

    S = len(lengths)
    need = [-(-n // P) for n in lengths]
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(P + sum(lengths))) + 1).tolist()
    assert sum(need) <= len(perm), "the pool holds every live page"
    table = torch.zeros((S, max_pages), dtype=torch.int32)
    at = 0
    for s, n in enumerate(need):
        table[s, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    if stale_from is not None:
        table[0] = table[stale_from]
    kp = torch.randn((nkv, n_pages, P, D), generator=gen, device=dev)
    vp = torch.randn((nkv, n_pages, P, D), generator=gen, device=dev)
    k8, ks = quantize_kv(kp)
    v8, vs = quantize_kv(vp)
    return dict(q=torch.randn((S, nkv, G, D), generator=gen, device=dev), kp=kp, vp=vp, k8=k8, v8=v8, ks=ks, vs=vs,
                table=table.to(dev), lengths=torch.tensor(lengths, dtype=torch.int32, device=dev), P=P)


def phase_paged_kernels() -> dict:
    """P1 and P2 against their plain versions: the phase-7 decode step's shape
    (4 slots, 2 kv heads, G = 8, hd 128, P = 128, 32-page table rows over a
    128-page pool, lengths 0, 327, 1689, 2041), then P = 16 with lengths 0, 37,
    300, every slot at its full 32·128 keys, a dead slot whose stale row
    points at another slot's pages, head dim 64 with G = 12 (more rows than
    the f32 route's 8 warps) and the 7B's G = 7 over 4 kv heads; q and pages
    in bf16 and f32 (P2: int8 pages, q in bf16 and f32). bf16 runs the
    tensor-core kernel (each launch's route read from `.tc_launches`; two
    launches bit-equal), f32 the FMA kernels only. An empty slot must end at
    exactly m = -1e30, l = 0, acc = 0. Times at the main shape in bf16."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = {
        "main": paged_case(gen, dev, (0, 327, 1689, 2041), 128, 32, 128),
        "P16": paged_case(gen, dev, (0, 37, 300), 16, 32, 128),
        "full": paged_case(gen, dev, (4096,) * 4, 128, 32, 129),
        "dead slot": paged_case(gen, dev, (0, 327, 1689, 2041), 128, 32, 128, stale_from=3),
        "hd 64, G 12": paged_case(gen, dev, (5, 0, 200), 32, 8, 32, G=12, D=64),
        "7B (Hkv 4, G 7)": paged_case(gen, dev, (0, 327, 1689, 2041), 128, 32, 128, G=7, nkv=4),
    }
    p1 = {"name": "paged_prefix_attention", "cases": {}}
    p2 = {"name": "paged_prefix_attention_q8", "cases": {}}

    def p1_args(c, dtype):
        return c["q"].to(dtype), c["kp"].to(dtype), c["vp"].to(dtype), c["table"], c["lengths"], c["P"]

    def p2_args(c, dtype):
        return c["q"].to(dtype), c["k8"], c["v8"], c["ks"], c["vs"], c["table"], c["lengths"], c["P"]

    def upcast(args):
        return [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args]

    for label, c in cases.items():
        live = c["lengths"] > 0
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[-1]
            for e, fn, plain, args in ((p1, pa.paged_prefix_attention, pa.paged_prefix_attention_plain, p1_args(c, dtype)),
                                       (p2, pa.paged_prefix_attention_q8, pa.paged_prefix_attention_q8_plain,
                                        p2_args(c, dtype))):
                n0, tc0 = fn.launches, fn.tc_launches
                (acc, m, l), (acc_w, m_w, l_w) = fn(*args), plain(*upcast(args))
                torch.cuda.synchronize()
                tc = dtype is torch.bfloat16  # bf16 on the tensor cores, f32 on the FMA kernels, every launch
                if (fn.launches - n0, fn.tc_launches - tc0) != (1, int(tc)):
                    raise AssertionError(f"{e['name']} {label} {key}: {fn.launches - n0} launches, "
                                         f"{fn.tc_launches - tc0} on the tensor cores")
                if tc:
                    again = fn(*args)
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip((acc, m, l), again)):
                        raise AssertionError(f"{e['name']} {label} {key}: two launches differ")
                # m over the live slots: an empty slot's -1e30 would swamp the scale
                check_case(e, e["name"], f"{label}, {key}", [(acc, acc_w), (m[live], m_w[live]), (l, l_w)],
                           PAGED_TOL[key])
                dead = ~live
                if not (torch.all(m[dead] == pa.NEG_INF) and torch.all(l[dead] == 0) and torch.all(acc[dead] == 0)):
                    raise AssertionError(f"{e['name']} {label} {key}: an empty slot is not at m = -1e30, l = 0, acc = 0")
    log("[kernels] P1/P2 bf16: every case on the tensor cores, two launches bit-equal; f32 on the FMA kernels")
    for e in (p1, p2):
        e["tol"], e["tol_f32"] = PAGED_TOL["bfloat16"], PAGED_TOL["float32"]
        e["tol_is"] = "on max_rel_err and each of `cases`: max |kernel - plain| / max |plain| per output (m over live slots)"

    # times at the main shape, bf16 q (and pages for P1)
    c = cases["main"]
    S, nkv, G, D = c["q"].shape
    lens = c["lengths"].tolist()
    live_keys = sum(lens)
    view = c["table"].shape[1] * c["P"]
    idx = c["table"].long()
    qt = c["q"].to(torch.bfloat16).reshape(S, nkv * G, 1, D)
    # the library yardstick: one SDPA over the pre-gathered contiguous view,
    # GQA expanded to 16 heads, with a length mask (gathered before timing)
    kt = c["kp"].to(torch.bfloat16)[:, idx].reshape(nkv, S, view, D).transpose(0, 1).repeat_interleave(G, dim=1)
    vt = c["vp"].to(torch.bfloat16)[:, idx].reshape(nkv, S, view, D).transpose(0, 1).repeat_interleave(G, dim=1)
    mask = torch.where(torch.arange(view, device=dev)[None] < c["lengths"][:, None], 0.0, -1e4)
    mask = mask.to(torch.bfloat16)[:, None, None, :]
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 50)
    out_bytes = S * nkv * G * (D + 2) * 4
    small = S * nkv * G * D * 2 + c["table"].numel() * 4 + S * 4 + out_bytes
    for e, fn, plain, args, kv_bytes in (
        (p1, pa.paged_prefix_attention, pa.paged_prefix_attention_plain, p1_args(c, torch.bfloat16),
         live_keys * nkv * D * 2 * 2),
        (p2, pa.paged_prefix_attention_q8, pa.paged_prefix_attention_q8_plain, p2_args(c, torch.bfloat16),
         live_keys * nkv * (D * 1 * 2 + 4 * 2)),
    ):
        ms, plain_ms = cuda_ms(lambda: fn(*args), 50), cuda_ms(lambda: plain(*args), 10)
        call = cuda_ms(lambda: fn(*args), 50, queued=False)
        b_ms, b_by = bound(4.0 * live_keys * nkv * G * D, kv_bytes + small)
        e.update(ms=ms, kernel_ms=ms, call_ms=call, plain_ms=plain_ms, library_ms=sdpa, bound_ms=b_ms, bound_by=b_by,
                 live_kv_bytes=kv_bytes)
        log(f"[kernels] {e['name']}: {ms:.4f} ms on the device, {call:.4f} ms per call from Python "
            f"(plain {plain_ms:.3f}, bound {b_ms:.5f} by {b_by}, library {sdpa:.4f})")
    p1["library_is"] = ("SDPA of the 16 query heads over the pre-gathered (4, 16, 4096, 128) bf16 view, GQA expanded, "
                        "length mask")
    p2["library_is"] = "P1's row: the same SDPA over the view dequantized to bf16 before timing"
    return {p1["name"]: p1, p2["name"]: p2}


# ---------------------------------------------------------------------------
# phases 3 and 4
def video_request(cfg, rng, frames: int, height: int, width: int, n_text: int = 120):
    from time_r1_tpu_torch.models.processor import patchify_video
    from time_r1_tpu_torch.sampler import Request

    pixels = rng.integers(0, 256, size=(frames, 3, height, width), dtype=np.uint8)
    patches, grid = patchify_video(pixels.astype(np.float32))
    n_vis = grid[0] * grid[1] * grid[2] // cfg.vision.merge_unit
    text = rng.integers(0, min(cfg.vision_start_token_id, cfg.text.vocab_size), size=n_text).tolist()
    ids = (text[: n_text // 2] + [cfg.vision_start_token_id] + [cfg.video_token_id] * n_vis
           + [cfg.vision_end_token_id] + text[n_text // 2:])
    return Request(input_ids=ids, patches=patches, grid_thw=grid, second_per_grid_t=1.0)


def to_device(tree, device, scale: float = 1.0):
    """A copy of a parameter tree on `device`, optionally scaled."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, scale) for v in tree]
    return (tree.detach() * scale).to(device) if scale != 1.0 else tree.detach().to(device, copy=True)


def phase_reduced_depth() -> None:
    import torch

    from time_r1_tpu_torch.sampler import Engine, SamplingParams

    cfg = reduced_config()
    torch.set_num_threads(os.cpu_count() or 1)
    params_cpu = reduced_params_cpu()
    params_gpu = to_device(params_cpu, torch.device("cuda"))
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    sp = SamplingParams(max_new_tokens=8, stop_token_ids=())
    out = {}
    for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = Engine(params, cfg, dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        reset_launches()
        logits = eng.last_token_logits([req])
        tokens = eng.generate([req], sp)[0]
        if device == "cuda":  # f32: K1 and K3 take the exact FMA kernels
            check_tc_route("reduced", read_launches(), {n: None for n in FWD_TC}, tensor_cores=False)
        out[device] = (logits, tokens)
        log(f"[reduced] {device}: {time.perf_counter() - t0:.1f} s, tokens {tokens}")
    (lg, tg), (lc, tc) = out["cuda"], out["cpu"]
    err = float(np.abs(lg - lc).max())
    log(f"[reduced] last-position logits: max |card - cpu| = {err:.3e} (tol {LOGIT_TOL}), "
        f"|logits| max {np.abs(lc).max():.3f}")
    if not np.isfinite(lg).all() or err > LOGIT_TOL:
        raise AssertionError(f"reduced-depth logits disagree: {err}")
    if tg != tc:
        raise AssertionError(f"greedy tokens differ: card {tg} cpu {tc}")


_REDUCED_CPU: list = []  # reduced_config()'s seeded f32 weights on the host, made once


def reduced_params_cpu() -> dict:
    """A copy of `init_params(reduced_config(), seed=0)` in f32 on the host:
    the phases that hold the card against the CPU, and the checkpoints
    phases 3f and 15 write, share one draw (5-8 s of host RNG a draw)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params

    if not _REDUCED_CPU:
        _REDUCED_CPU.append(init_params(reduced_config(), seed=0, device="cpu", dtype=torch.float32))
    return to_device(_REDUCED_CPU[0], torch.device("cpu"))


def reduced_config():
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    base = Qwen25VLConfig.qwen25vl_3b()
    return replace(
        base,
        vision=replace(base.vision, depth=2, fullatt_block_indexes=(1,)),
        text=replace(base.text, num_hidden_layers=2),
    )


# Phase 3b tolerance, max |card - cpu| / max |cpu| per gradient leaf (and for
# the loss and metrics): f32 on both sides, with sums in other orders in the
# attention kernels (up to 896 keys), in cuBLAS against the CPU's GEMMs over
# reductions 2048-11008 wide, and in the 151936-way log-softmax.
TRAIN_TOL = 1e-3


def phase_reduced_train() -> None:
    """One GRPO loss step at reduced depth, card (kernels) against CPU (plain),
    with the frozen ViT (fix_vit, the default) and with the whole tower
    trained (fix_vit=False: the differentiated tower runs off K2/K3, which
    have no backward; the reference forward still takes them)."""
    import torch

    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_split_batch
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps, grpo_value_and_grad, precompute_frozen_vision

    cfg = reduced_config()
    params_cpu = reduced_params_cpu()
    # the reference model: the same weights scaled, so that the KL term is not zero
    ref_cpu = to_device(params_cpu, torch.device("cpu"), scale=0.98)
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    rng = np.random.default_rng(2)
    eos = cfg.eos_token_id
    comps = [rng.integers(0, 151000, n).tolist() + ([eos] if i % 2 == 0 else []) for i, n in enumerate((20, 57, 101, 127))]
    group = {"prompt_ids": req.input_ids, "completions": comps,
             "advantages": np.array([1.0, -0.5, 0.25, -0.75], np.float32),
             "patches": req.patches, "grid_thw": req.grid_thw, "second_per_grid_t": 1.0}
    for fix_vit in (True, False):
        tag = "train-reduced" if fix_vit else "train-reduced fix_vit=False"
        hp = GRPOHyperParams(num_generations=4, beta=0.04, fix_vit=fix_vit)
        out = {}
        for device in ("cuda", "cpu"):
            dev = torch.device(device)
            params = to_device(params_cpu, dev)
            ref = ref_cpu if device == "cpu" else to_device(ref_cpu, dev)
            t0 = time.perf_counter()
            reset_launches()
            batch = build_grpo_split_batch(cfg, [group], dtype=torch.float32, device=dev)
            if fix_vit:
                batch = precompute_frozen_vision(params, cfg, batch)
            batch = batch._replace(ref_logps=compute_ref_logps(ref, cfg, hp, batch))
            before = read_launches()
            loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch)
            after = read_launches()
            if device == "cuda":  # f32: B1, B2, S1, S2 take the exact FMA kernels, never the tensor cores
                attention = [n for n in TC_KERNELS if n not in DECODE_KERNELS + PAGED_KERNELS + ("int4_matmul",)]
                check_tc_route(tag, after, {n: None for n in attention}, tensor_cores=False)
                vit = {n: (before[n], after[n]) for n in ("window_attention_rope", "full_attention_rope")}
                log(f"[{tag}] K2/K3 launches before / after the differentiated call: {vit}")
                if any(a != b or b <= 0 for b, a in vit.values()):  # the frozen blocks (or ref) ran them
                    raise AssertionError(f"{tag}: K2/K3 launches moved inside the loss or never ran: {vit}")
            out[device] = (float(loss), {k: float(v) for k, v in metrics.items()}, [g.cpu() for g in grads])
            log(f"[{tag}] {device}: {time.perf_counter() - t0:.1f} s, prompt {len(req.input_ids)} tokens, "
                f"Lp {batch.prompt_ids.shape[1]}, Lc {batch.comp_ids.shape[1]}, loss {float(loss):.6f}, "
                f"metrics {out[device][1]}")
        (lg, mg, gg), (lc, mc, gc) = out["cuda"], out["cpu"]
        worst = 0.0
        for g, c in zip(gg, gc):
            scale = c.abs().max().item()
            if scale > 0:
                worst = max(worst, (g - c).abs().max().item() / scale)
        live = sum(int(c.abs().max().item() > 0) for c in gc)
        loss_err = abs(lg - lc) / max(abs(lc), 1e-30)
        metric_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc)
        log(f"[{tag}] card vs cpu: loss {loss_err:.3e}, metrics {metric_err:.3e}, worst gradient leaf "
            f"{worst:.3e} of {len(gc)} ({live} non-zero; max |Δ| / max |g|, tol {TRAIN_TOL})")
        if not (np.isfinite(lg) and loss_err <= TRAIN_TOL and metric_err <= TRAIN_TOL and worst <= TRAIN_TOL):
            raise AssertionError(f"{tag}: card and CPU disagree")


def seeded_adapters(params, cfg, seed: int, fused: bool = False):
    """Decoder LoRA adapters (rank 16, alpha 32: the recipe's) over `params`,
    with B drawn too (N(0, 0.02), from `seed`) so that they change the
    function; (adapter tree, LoRAConfig)."""
    import torch

    from time_r1_tpu_torch.rl.lora import LoRAConfig, fused_splits_for, init_lora, lora_leaves

    lcfg = LoRAConfig(rank=16, alpha=32.0)
    lora = init_lora(params, lcfg, seed=seed, fused_splits=fused_splits_for(cfg.text) if fused else None)
    lora.pop("visual", None)
    leaves = lora_leaves(lora)
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed + 1000)
    for b in leaves[1::2]:
        b.copy_(torch.randn(b.shape, generator=gen, device=b.device) * 0.02)
    return lora, lcfg


def phase_reduced_lora() -> None:
    """Phase 3 for LoRA, at reduced depth, f32, card (kernels) against CPU
    (plain): (i) the side-path forward (`Engine.set_lora_side`: last-position
    logits and 8 greedy tokens) against the merged tree's and across the two
    devices; (ii) phase 3b's split loss with the decoder's adapters merged
    inside each remat-checkpointed layer (`grpo_loss(..., lora=)`), its
    metrics and every adapter gradient, card against CPU within TRAIN_TOL."""
    import torch

    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_split_batch, grpo_loss
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps, precompute_frozen_vision
    from time_r1_tpu_torch.rl.lora import lora_layers_tree, lora_leaves, merge_lora
    from time_r1_tpu_torch.sampler import Engine, SamplingParams

    cfg = reduced_config()
    params_cpu = reduced_params_cpu()
    lora_cpu, lcfg = seeded_adapters(params_cpu, cfg, seed=3)
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    sp = SamplingParams(max_new_tokens=8, stop_token_ids=())
    out = {}
    for device in ("cuda", "cpu"):
        dev = torch.device(device)
        params, lora = to_device(params_cpu, dev), to_device(lora_cpu, dev)
        side = Engine(params, cfg, dtype=torch.float32, device=device)
        side.set_lora_side(lora_layers_tree(lora)[0], lcfg.scaling)
        merged = Engine(merge_lora(params, lora, lcfg), cfg, dtype=torch.float32, device=device)
        base = Engine(params, cfg, dtype=torch.float32, device=device)
        out[device] = dict(side=side.last_token_logits([req]), merged=merged.last_token_logits([req]),
                           base=base.last_token_logits([req]), tokens=side.generate([req], sp)[0])
    g, c = out["cuda"], out["cpu"]
    errs = {"side vs merged (card)": float(np.abs(g["side"] - g["merged"]).max()),
            "side vs merged (cpu)": float(np.abs(c["side"] - c["merged"]).max()),
            "side card vs cpu": float(np.abs(g["side"] - c["side"]).max())}
    moved = float(np.abs(c["side"] - c["base"]).max())
    log(f"[lora-reduced] last-position logits: {errs} (tol {LOGIT_TOL}); the adapters move them by {moved:.3e}; "
        f"greedy tokens card {g['tokens']} cpu {c['tokens']}")
    if not all(np.isfinite(e) and e <= LOGIT_TOL for e in errs.values()) or moved <= 10 * LOGIT_TOL:
        raise AssertionError(f"phase 3 LoRA: side-path logits disagree ({errs}) or the adapters do nothing ({moved})")
    if g["tokens"] != c["tokens"]:
        raise AssertionError(f"phase 3 LoRA: side-path greedy tokens differ, card {g['tokens']} cpu {c['tokens']}")

    rng = np.random.default_rng(2)
    comps = [rng.integers(0, 151000, n).tolist() + ([cfg.eos_token_id] if i % 2 == 0 else [])
             for i, n in enumerate((20, 57, 101, 127))]
    group = {"prompt_ids": req.input_ids, "completions": comps,
             "advantages": np.array([1.0, -0.5, 0.25, -0.75], np.float32),
             "patches": req.patches, "grid_thw": req.grid_thw, "second_per_grid_t": 1.0}
    hp = GRPOHyperParams(num_generations=4, beta=0.04, fix_vit=True, gradient_checkpointing="full")
    res = {}
    for device in ("cuda", "cpu"):
        dev = torch.device(device)
        params, lora = to_device(params_cpu, dev), to_device(lora_cpu, dev)
        t0 = time.perf_counter()
        batch = precompute_frozen_vision(params, cfg, build_grpo_split_batch(cfg, [group], dtype=torch.float32,
                                                                             device=dev))
        batch = batch._replace(ref_logps=compute_ref_logps(params, cfg, hp, batch))  # the unmerged base
        leaves = lora_leaves(lora)
        for t in leaves:
            t.requires_grad_(True)
        loss, metrics = grpo_loss(params, cfg, hp, batch, lora=(lora_layers_tree(lora)[0], lcfg.scaling))
        grads = torch.autograd.grad(loss, leaves)
        res[device] = (loss.item(), {k: float(v) for k, v in metrics.items()}, [x.cpu() for x in grads])
        log(f"[lora-reduced] {device}: in-layer merged loss {loss.item():.6f}, metrics {res[device][1]}, "
            f"{len(leaves)} adapter leaves, {time.perf_counter() - t0:.1f} s")
    (lg, mg, gg), (lc, mc, gc) = res["cuda"], res["cpu"]
    worst = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(gg, gc))
    loss_err = abs(lg - lc) / max(abs(lc), 1e-30)
    metric_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc)
    zero = sum(int(b.abs().max().item() == 0) for b in gc)
    log(f"[lora-reduced] card vs cpu: loss {loss_err:.3e}, metrics {metric_err:.3e}, worst adapter gradient "
        f"{worst:.3e} of {len(gc)} ({zero} zero; max |Δ| / max |g|, tol {TRAIN_TOL}); kl {mc.get('kl')}")
    if zero or not (np.isfinite(lg) and loss_err <= TRAIN_TOL and metric_err <= TRAIN_TOL and worst <= TRAIN_TOL):
        raise AssertionError("phase 3 LoRA: the in-layer merged loss or its adapter gradients disagree")


def kernel_wrappers():
    """Every kernel wrapper of the port, by the name its phase-2 entry has
    (S2's two kernels count apart)."""
    from time_r1_tpu_torch.ops import decode_attention as da
    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.fused_mlp import fused_mlp_int8
    from time_r1_tpu_torch.ops.int4_matmul import int4_matmul
    from time_r1_tpu_torch.ops.paged_attention import paged_prefix_attention, paged_prefix_attention_q8
    from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, window_attention_rope

    return {
        "flash_attention": fa.flash_attention_fwd,
        "window_attention_rope": window_attention_rope,
        "full_attention_rope": full_attention_rope,
        "flash_bwd_dq": fa.flash_bwd_dq,
        "flash_bwd_dkv": fa.flash_bwd_dkv,
        "shared_prefix_fwd": fa.shared_prefix_fwd,
        "shared_prefix_bwd": fa.shared_prefix_bwd_dq,
        "shared_prefix_bwd_dkv": fa.shared_prefix_bwd_dkv,
        "shared_prefix_decode_attention": da.shared_prefix_decode_attention,
        "shared_prefix_decode_full": da.shared_prefix_decode_full,
        "int4_matmul": int4_matmul,
        "fused_mlp_int8": fused_mlp_int8,
        "paged_prefix_attention": paged_prefix_attention,
        "paged_prefix_attention_q8": paged_prefix_attention_q8,
    }


# wrappers that also count tensor-core launches (bf16); the rest of their
# launches ran the f32 FMA kernels
TC_KERNELS = ("flash_attention", "window_attention_rope", "full_attention_rope", "flash_bwd_dq", "flash_bwd_dkv",
              "shared_prefix_fwd", "shared_prefix_bwd", "shared_prefix_bwd_dkv", "shared_prefix_decode_full",
              "int4_matmul", "paged_prefix_attention", "paged_prefix_attention_q8")
FWD_TC = ("flash_attention", "window_attention_rope", "full_attention_rope")  # K1-K3: every serving and rollout path


def reset_launches() -> None:
    for name, fn in kernel_wrappers().items():
        fn.launches = 0
        if name in TC_KERNELS:
            fn.tc_launches = 0


def read_launches() -> dict:
    """Every wrapper's launches; for those of TC_KERNELS also `<name>_tc`,
    their tensor-core launches (the rest ran the FMA kernels)."""
    wrappers = kernel_wrappers()
    out = {name: fn.launches for name, fn in wrappers.items()}
    out.update({f"{name}_tc": wrappers[name].tc_launches for name in TC_KERNELS})
    return out


def check_tc_route(tag: str, launches: dict, want: dict, tensor_cores: bool) -> None:
    """Each kernel `name` of `want` (of TC_KERNELS) ran `want[name]` launches
    (None: at least one), all on the tensor-core kernels (bf16) or all on the
    f32 FMA kernels."""
    for name in want:
        n, tc = launches[name], launches[f"{name}_tc"]
        fma = n - tc
        log(f"[{tag}] {name}: {tc} tensor-core launches, {fma} FMA launches")
        if (want[name] is not None and n != want[name]) or n <= 0 or (fma if tensor_cores else tc) != 0:
            raise AssertionError(f"{tag}: {name} ran {tc} tensor-core and {fma} FMA launches, want "
                                 f"{want[name]} {'tensor-core' if tensor_cores else 'FMA'} launches only")


def phase_full_size() -> dict:
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.sampler import Engine, SamplingParams

    cfg = Qwen25VLConfig.qwen25vl_3b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[full] init_params 3B bf16 on the card: {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    reqs = [video_request(cfg, rng, 32, 224, 392), video_request(cfg, rng, 24, 280, 336)]
    log(f"[full] prompts: {[len(r.input_ids) for r in reqs]} tokens, grids {[r.grid_thw for r in reqs]}")
    eng = Engine(params, cfg, dtype=torch.bfloat16, device="cuda")
    eng.generate(reqs, SamplingParams(max_new_tokens=2, stop_token_ids=()))  # warm-up

    sp = SamplingParams(max_new_tokens=128)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(reqs, sp)
    total = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if k in SERVING_KEYS}
    check_tc_route("full", launches, vision_tc_launches(cfg) | {"flash_attention": cfg.text.num_hidden_layers},
                   tensor_cores=True)
    tm = eng.timings
    n_gen = sum(len(o) for o in out)
    log(f"[full] launches on the main path: {launches}")
    log(f"[full] vision {tm['vision_s'] * 1e3:.1f} ms, prefill {tm['prefill_s'] * 1e3:.1f} ms, "
        f"decode {tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step over {tm['decode_steps']} steps, "
        f"{n_gen} tokens generated, {n_gen / tm['decode_s']:.1f} tok/s in decode, "
        f"{total:.2f} s for the generate() call, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not all(len(o) >= 1 for o in out):
        raise AssertionError("a request produced no tokens")
    logits = eng.last_token_logits(reqs)
    if logits.shape != (2, cfg.text.vocab_size) or not np.isfinite(logits).all():
        raise AssertionError(f"bad last-position logits: shape {logits.shape}")
    log(f"[full] last-position logits finite; argmax {logits.argmax(-1).tolist()}, "
        f"first generated {[o[0] for o in out]}")
    turn = replace(sp, max_new_tokens=TURN_TOKENS)
    decode_both_ways("full", lambda: (eng.generate(reqs, turn), eng.timings)[1])
    return launches


SERVING_KERNELS = ("flash_attention", "window_attention_rope", "full_attention_rope")
SERVING_KEYS = SERVING_KERNELS + tuple(f"{n}_tc" for n in FWD_TC)  # phase 4's launch counts
TRAIN_KERNELS = SERVING_KERNELS + ("flash_bwd_dq", "flash_bwd_dkv", "shared_prefix_fwd", "shared_prefix_bwd",
                                   "shared_prefix_bwd_dkv", "shared_prefix_decode_full")
DECODE_KERNELS = ("shared_prefix_decode_attention", "shared_prefix_decode_full")  # per layer per G-way step
PAGED_KERNELS = ("paged_prefix_attention", "paged_prefix_attention_q8")  # per layer per paged decode step


def check_step_launches(tag: str, launches: dict, steps: int, layers: int, per_layer: dict) -> None:
    """Kernels that run on every decode step: exactly per_layer[name] x layers
    x steps launches; kernels at 0 per layer must not run."""
    for name, n in per_layer.items():
        if launches[name] != n * layers * steps:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, want {n} x {layers} x {steps}")


def vision_tc_launches(cfg) -> dict:
    """K2 and K3 launches of one vision-tower forward: one per window block
    and one per full-attention block."""
    n_full = len(cfg.vision.fullatt_block_indexes)
    return {"window_attention_rope": cfg.vision.depth - n_full, "full_attention_rope": n_full}


def step_batch_tc_launches(cfg, decode_steps: int) -> dict:
    """The tensor-core launches of one bf16 `step_batch`, per layer: K1 in
    the rollout prefill, ref_logps and the loss's prompt forward; B1 once; B2
    for the prompt and the own chunk; S1 in ref_logps and in the loss; S2's
    dq and prefix dK/dV once; D2 once per decode step. K2 and K3 in the
    rollout's vision tower."""
    layers = cfg.text.num_hidden_layers
    return vision_tc_launches(cfg) | {
        "flash_attention": 3 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": 2 * layers,
        "shared_prefix_fwd": 2 * layers, "shared_prefix_bwd": layers, "shared_prefix_bwd_dkv": layers,
        "shared_prefix_decode_full": layers * decode_steps}


def token_parity_reward(completions, **kwargs):
    """A stand-in reward that varies across the rows of a group (the share of
    odd token ids), so that the advantages are not zero: with random weights
    the timestamp and format rewards are 0 for every row."""
    out = []
    for text in completions:
        ids = [int(t) for t in text.split()]
        out.append(sum(t % 2 for t in ids) / max(len(ids), 1))
    return out


class IdsProcessor:
    """The trainer's processor stand-in: a completion decodes to its token ids
    as text (no tokenizer is in the repository)."""

    def batch_decode(self, seqs, skip_special_tokens=True):
        return [" ".join(str(int(t)) for t in s) for s in seqs]


def rollout_sampling(config, cfg):
    """`step_batch`'s rollout SamplingParams (G rows at the configured
    temperature and length), with no stop id, so every row runs the whole
    budget, and a fixed seed."""
    from time_r1_tpu_torch.sampler import SamplingParams

    return SamplingParams(temperature=config.temperature, max_new_tokens=config.max_completion_length,
                          stop_token_ids=(), num_return_sequences=config.num_generations, seed=0)


def decode_windows(eng, req, config, cfg) -> dict:
    """Phase 5's rollout decode after the two `step_batch` calls: its ms/step
    eager and captured in turns, then the device's idle share over 16 steady
    decode steps (steps 32-47, one host-check segment) of each, by
    torch.profiler (`settled_window`), with D2's launches by name there (36
    a step)."""
    sp = rollout_sampling(config, cfg)
    turn = replace(sp, max_new_tokens=TURN_TOKENS)
    out = {"in_turns": decode_both_ways("train rollout", lambda: (eng.generate([req], turn), eng.timings)[1])}
    L = cfg.text.num_hidden_layers
    for mode in ("eager", "captured"):
        def run(mode=mode):
            if mode == "eager":
                with eager_decode():
                    eng.generate([req], replace(sp, max_new_tokens=64))
            else:
                eng.generate([req], replace(sp, max_new_tokens=64))

        win, seen = settled_window(run, first=32, count=16)
        st = win.stats()
        d2 = win.kernels("decode_full_tc")
        log(f"[train] rollout decode, 16 steady steps {mode}: device span {st['span_ms']:.2f} ms, busy "
            f"{st['busy_ms']:.2f} ms, idle share {st['idle_share']:.4f}, {st['device_events']} device events "
            f"(windows' records {seen}), {d2} D2 launches by name; most device time: {win.top(8)}")
        if d2 != 16 * L:
            raise AssertionError(f"rollout window ({mode}): {d2} D2 launches by name, want {16 * L}")
        out[mode] = st
    return out


def phase_train_full_size() -> dict:
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.rl.grpo import trainable_leaves
    from time_r1_tpu_torch.utils.profiling import PhaseTimers
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    cfg = Qwen25VLConfig.qwen25vl_3b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"[train] init_params 3B bf16 and its reference copy on the card: {time.perf_counter() - t0:.1f} s")
    req = video_request(cfg, np.random.default_rng(0), 32, 224, 392)  # phase 4's first request
    config = TrainConfig(report_to="none")
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], token_parity_reward]
    trainer = GRPOTrainer(params, cfg, IdsProcessor(), rewards, config=config, ref_params=ref,
                          dtype=torch.bfloat16, device="cuda")
    example = {"problem": "a person opens a door", "solution": (2.0, 9.5), "durations": 32.0}
    before = [p.detach().clone() for p in trainable_leaves(params, config.fix_vit)]  # on the card: no host copy
    per_call = []
    for call in (1, 2):
        trainer.timers = PhaseTimers(sync=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        info = trainer.step_batch([example], [req])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = read_launches()
        metrics = trainer.pop_metrics()
        tm = trainer.engine.timings
        phases = {k: round(v["total_s"] * 1e3, 1) for k, v in trainer.timers.summary().items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_call.append(launches)
        log(f"[train] step_batch {call}: {total:.2f} s; phases (ms, synced) {phases}; rollout vision "
            f"{tm['vision_s'] * 1e3:.1f} ms, prefill {tm['prefill_s'] * 1e3:.1f} ms, decode "
            f"{tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step over {tm['decode_steps']} steps; "
            f"peak {peak:.2f} GiB allocated")
        log(f"[train] step_batch {call}: launches {launches}")
        log(f"[train] step_batch {call}: loss {info['loss']:.6f}, reward {info['reward']:.4f}, metrics {metrics}")
        if not (np.isfinite(info["loss"]) and np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
            raise AssertionError(f"step_batch {call}: loss {info['loss']} or grad_norm {metrics['grad_norm']}")
        for name in TRAIN_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"step_batch {call}: {name} was not launched")
        check_step_launches(f"step_batch {call}", launches, tm["decode_steps"], cfg.text.num_hidden_layers,
                            {"shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                             "int4_matmul": 0, "fused_mlp_int8": 0})
        check_tc_route(f"train step_batch {call}", launches, step_batch_tc_launches(cfg, tm["decode_steps"]),
                       tensor_cores=True)
    decode_windows(trainer.engine, req, config, cfg)
    changed = total_elems = 0
    for p, b in zip(trainable_leaves(params, config.fix_vit), before):
        changed += int((p.detach() != b).sum())
        total_elems += b.numel()
    del before
    log(f"[train] after one optimizer update (two micro-steps, lr {config.learning_rate}): {changed} of "
        f"{total_elems} trainable bf16 elements changed")
    return per_call[-1]


def phase_quant_full_size() -> dict:
    """Phase 6: quantized rollouts at full size, after phase 5 freed its model.
    Two `step_batch` calls with rollout_quantization="int8" (int8 weights, int8
    KV: D2 and Q2 on every decode step), then one int4 G = 8 `generate` (Q1 for
    the four projections of every layer, D2 over the int8 KV). Launch counts
    read around each call."""
    import gc

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.sampler import Engine, SamplingParams
    from time_r1_tpu_torch.utils.profiling import PhaseTimers
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    gc.collect()
    torch.cuda.empty_cache()
    cfg = Qwen25VLConfig.qwen25vl_3b()
    L = cfg.text.num_hidden_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"))
    req = video_request(cfg, np.random.default_rng(0), 32, 224, 392)  # phase 4's first request
    config = TrainConfig(report_to="none", rollout_quantization="int8")
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], token_parity_reward]
    t0 = time.perf_counter()
    trainer = GRPOTrainer(params, cfg, IdsProcessor(), rewards, config=config, ref_params=ref,
                          dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[quant] GRPOTrainer(rollout_quantization='int8') built (one int8 quantization pass) in "
        f"{time.perf_counter() - t0:.2f} s")
    example = {"problem": "a person opens a door", "solution": (2.0, 9.5), "durations": 32.0}
    out = {}
    for call in (1, 2):
        trainer.timers = PhaseTimers(sync=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        info = trainer.step_batch([example], [req])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = read_launches()
        metrics = trainer.pop_metrics()
        tm = trainer.engine.timings
        phases = {k: round(v["total_s"] * 1e3, 1) for k, v in trainer.timers.summary().items()}
        log(f"[quant] int8 step_batch {call}: {total:.2f} s; phases (ms, synced) {phases}; rollout vision "
            f"{tm['vision_s'] * 1e3:.1f} ms, prefill {tm['prefill_s'] * 1e3:.1f} ms, decode "
            f"{tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step over {tm['decode_steps']} steps; "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
        log(f"[quant] int8 step_batch {call}: launches {launches}")
        log(f"[quant] int8 step_batch {call}: loss {info['loss']:.6f}, reward {info['reward']:.4f}, "
            f"grad_norm {metrics['grad_norm']:.4f}")
        if not (np.isfinite(info["loss"]) and np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
            raise AssertionError(f"int8 step_batch {call}: loss {info['loss']} or grad_norm {metrics['grad_norm']}")
        check_step_launches(f"int8 step_batch {call}", launches, tm["decode_steps"], L,
                            {"shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                             "fused_mlp_int8": 1, "int4_matmul": 0})
        check_tc_route(f"int8 step_batch {call}", launches, step_batch_tc_launches(cfg, tm["decode_steps"]),
                       tensor_cores=True)
        out = {k: launches[k] for k in ("shared_prefix_decode_attention", "shared_prefix_decode_full",
                                        "fused_mlp_int8")}
    turn = replace(rollout_sampling(config, cfg), max_new_tokens=TURN_TOKENS)
    decode_both_ways("quant int8 rollout", lambda: (trainer.engine.generate([req], turn), trainer.engine.timings)[1])
    del trainer, ref
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = Engine(params, cfg, dtype=torch.bfloat16, device="cuda", quantization="int4", kv_cache_quant=True)
    del params
    torch.cuda.synchronize()
    log(f"[quant] Engine(quantization='int4', kv_cache_quant=True) built in {time.perf_counter() - t0:.2f} s")
    sp = SamplingParams(temperature=1.0, max_new_tokens=200, num_return_sequences=8, stop_token_ids=(), seed=0)
    eng.generate([req], SamplingParams(max_new_tokens=2, num_return_sequences=8, stop_token_ids=()))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rows = eng.generate([req], sp)
    total = time.perf_counter() - t0
    launches = read_launches()
    tm = eng.timings
    log(f"[quant] int4 generate (G = 8, 200 tokens): {total:.2f} s; vision {tm['vision_s'] * 1e3:.1f} ms, prefill "
        f"{tm['prefill_s'] * 1e3:.1f} ms, decode {tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step "
        f"over {tm['decode_steps']} steps; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    log(f"[quant] int4 generate: launches {launches}")
    check_step_launches("int4 generate", launches, tm["decode_steps"], L,
                        {"int4_matmul": 4, "shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                         "fused_mlp_int8": 0})
    check_tc_route("int4 generate", launches, vision_tc_launches(cfg) | {
        "flash_attention": L, "shared_prefix_decode_full": L * tm["decode_steps"],
        "int4_matmul": 4 * L * tm["decode_steps"]}, tensor_cores=True)
    if len(rows) != 8 or not all(len(r) == 200 for r in rows):
        raise AssertionError(f"int4 generate: rows of {[len(r) for r in rows]} tokens")
    turn = replace(sp, max_new_tokens=TURN_TOKENS)
    decode_both_ways("quant int4 generate", lambda: (eng.generate([req], turn), eng.timings)[1])
    out["int4_matmul"], out["int4_matmul_tc"] = launches["int4_matmul"], launches["int4_matmul_tc"]
    return out


# Phase 3c tolerances (the reasons in `phase_reduced_quant`): int8 carries Q2's
# bf16 roundings; int4 has none, and read 4.4e-4 on an H100, so 3e-3 leaves
# room for the int8-KV boundary flips and still sees a fault in the suffix.
QUANT_LOGIT_TOL = {"int8": 1e-2, "int4": 3e-3}


def teacher_forced_logits(eng, cfg, req, tokens: np.ndarray) -> list:
    """The G-way decode of `generate` with fixed tokens (G, steps): the
    prefill's last-position logits, then one per step, as numpy (G, V)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import forward_shared_decode, suffix_cache_zeros
    from time_r1_tpu_torch.ops.attention import NEG_INF

    G, steps = tokens.shape
    dev = eng.device
    with torch.no_grad():
        ids, mask, pos_ids, start, vis, S, _ = eng._pack([req], extra_len=0)
        first, prefix, _ = eng._prefill(ids, mask, pos_ids, vis, S, S)
        prefix = eng._maybe_quant_cache(prefix)
        bias = torch.where(torch.from_numpy(mask[:, :S] > 0).to(dev), 0.0, NEG_INF).float()
        suffix = suffix_cache_zeros(cfg.text, G, 128, dtype=eng.dtype, device=dev, quant=eng.kv_cache_quant)
        out = [first.float().cpu().numpy()]
        tok = torch.from_numpy(tokens).to(dev)
        for t in range(steps):
            pos3 = torch.full((3, G, 1), int(start[0]) + t, dtype=torch.long, device=dev)
            lg, suffix = forward_shared_decode(eng.params, cfg, tok[:, t:t + 1], pos3, prefix, suffix, bias)
            out.append(lg[:, -1].float().cpu().numpy())
    return out


def phase_reduced_quant() -> dict:
    """Phase 3c: the quantized G-way decode at reduced depth (3B widths, 2
    layers, 2 ViT blocks, f32 activations, int8 KV), int8 then int4 weights,
    16 teacher-forced steps of fixed tokens for G = 4 rows: the card (D2 with
    Q2 at int8, Q1 at int4) against the CPU (plain paths) on every step's
    logits. Tolerance, on max |card - cpu| / max |cpu| per step: at int8, Q2
    rounds x and the activation to bf16 where the CPU's unfused MLP stays f32
    (about 2^-9 of each value); in both runs the f32 K/V of card and CPU, equal
    to about 1e-6, can quantize to int8 values one apart where they sit at a
    rounding boundary."""
    import torch

    from time_r1_tpu_torch.sampler import Engine

    cfg = reduced_config()
    params_cpu = reduced_params_cpu()
    params_gpu = to_device(params_cpu, torch.device("cuda"))
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    G, steps = 4, 16
    tokens = np.random.default_rng(4).integers(0, 151000, size=(G, steps))
    errs = {}
    for quant in ("int8", "int4"):
        out = {}
        for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = Engine(params, cfg, dtype=torch.float32, device=device, quantization=quant, kv_cache_quant=True)
            reset_launches()
            t0 = time.perf_counter()
            out[device] = teacher_forced_logits(eng, cfg, req, tokens)
            launches = read_launches()
            log(f"[reduced-quant] {quant} {device}: {time.perf_counter() - t0:.1f} s, launches "
                f"{ {k: v for k, v in launches.items() if v} }")
            if device == "cuda":
                check_step_launches(f"reduced {quant}", launches, steps, cfg.text.num_hidden_layers,
                                    {"shared_prefix_decode_full": 1,
                                     "fused_mlp_int8": int(quant == "int8"), "int4_matmul": 4 * (quant == "int4")})
                fma_only = FWD_TC + DECODE_KERNELS[1:] + (("int4_matmul",) if quant == "int4" else ())
                check_tc_route(f"reduced {quant}", launches, {n: None for n in fma_only}, tensor_cores=False)
        per_step = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(out["cuda"], out["cpu"])]
        errs[quant] = max(per_step)
        finite = all(np.isfinite(a).all() for a in out["cuda"])
        log(f"[reduced-quant] {quant}: max |card - cpu| / max |cpu| per step {['%.2e' % e for e in per_step]}, "
            f"worst {errs[quant]:.3e} (tol {QUANT_LOGIT_TOL[quant]}); |logits| max {np.abs(out['cpu'][-1]).max():.3f}")
        if not finite or errs[quant] > QUANT_LOGIT_TOL[quant]:
            raise AssertionError(f"reduced-depth {quant} decode: card and CPU disagree ({errs[quant]})")
    return errs


def text_request(cfg, rng, n: int):
    """n prompt ids below the vision specials, drawn from rng."""
    from time_r1_tpu_torch.sampler import Request

    vocab = min(cfg.vision_start_token_id, cfg.text.vocab_size)
    return Request(input_ids=rng.integers(2, vocab, n).tolist())


def phase_reduced_serving() -> dict:
    """Phase 3d: continuous batching at reduced depth (3B widths, 2 layers, 2
    ViT blocks, f32), one 8-frame video request and four text requests
    through two slots (slots and pages recycle; 256-token prefill chunks, so
    the video's prompt streams in while a resident slot decodes). Greedy
    tokens must be equal, card against CPU, for PagedEngine (f32 pool, P1),
    PagedEngine with int8 KV pages (P2) and ContinuousEngine; on the card,
    the paged tokens must equal the bucket Engine's, and the int8-KV paged
    tokens the bucket Engine's over its int8 KV cache."""
    import torch

    from time_r1_tpu_torch.sampler import ContinuousEngine, Engine, PagedEngine, SamplingParams

    cfg = reduced_config()
    L = cfg.text.num_hidden_layers
    params_cpu = reduced_params_cpu()
    params_gpu = to_device(params_cpu, torch.device("cuda"))
    rng = np.random.default_rng(2)
    reqs = [video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)]
    reqs += [text_request(cfg, rng, n) for n in (37, 150, 290, 460)]
    sp = SamplingParams(max_new_tokens=8, stop_token_ids=())
    kw = dict(max_slots=2, max_len=1024, segment=4, prefill_chunk_tokens=256, dtype=torch.float32)
    engines = {
        "paged": lambda p, d: PagedEngine(p, cfg, page_size=128, device=d, **kw),
        "paged int8 KV": lambda p, d: PagedEngine(p, cfg, page_size=128, kv_cache_quant=True, device=d, **kw),
        "continuous": lambda p, d: ContinuousEngine(p, cfg, device=d, **kw),
    }
    kernel = {"paged": "paged_prefix_attention", "paged int8 KV": "paged_prefix_attention_q8", "continuous": None}
    out = {}
    for name, make in engines.items():
        got = {}
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = make(params, dev)
            reset_launches()
            t0 = time.perf_counter()
            got[dev] = eng.generate(reqs, sp)
            launches = {k: v for k, v in read_launches().items() if v}
            tm = eng.timings
            log(f"[serving-reduced] {name} {dev}: {time.perf_counter() - t0:.1f} s, {tm['segments']} segments "
                f"({tm['interleaved_segments']} inside admissions), launches {launches}")
            if dev == "cuda":  # f32: K1-K3 and P1/P2 on the FMA kernels only
                paged = {kernel[name]: L * tm["decode_steps"]} if kernel[name] else {}
                check_tc_route(f"serving-reduced {name}", read_launches(), {n: None for n in FWD_TC} | paged,
                               tensor_cores=False)
                for k in ("paged_prefix_attention", "paged_prefix_attention_q8"):
                    want = L * tm["decode_steps"] if k == kernel[name] else 0
                    if launches.get(k, 0) != want:
                        raise AssertionError(f"reduced {name}: {k} launched {launches.get(k, 0)} times, want {want}")
        log(f"[serving-reduced] {name}: tokens {got['cuda']}")
        if got["cuda"] != got["cpu"]:
            raise AssertionError(f"reduced {name}: greedy tokens differ, card {got['cuda']} cpu {got['cpu']}")
        out[name] = got["cuda"]
    for name, quant in (("paged", False), ("paged int8 KV", True)):
        bucket = Engine(params_gpu, cfg, dtype=torch.float32, device="cuda", kv_cache_quant=quant).generate(reqs, sp)
        if bucket != out[name]:
            raise AssertionError(f"reduced {name}: the bucket Engine gives {bucket}, paged {out[name]}")
    log("[serving-reduced] card == cpu for the three engines; paged == bucket Engine (f32 and int8 KV)")
    return out


# ---------------------------------------------------------------------------
# the captured decode (phase 3e) and its tools for phases 4-7


@contextmanager
def eager_decode():
    """Every decode loop run inside runs eagerly: the loops' own capture
    argument (`StepGraph(..., capture=False)`, which `decode_loop(...,
    capture=False)` also reaches) forced by a patch, so that the entry points
    a user calls can be held and timed against their captured runs. No entry
    point has such an option."""
    from time_r1_tpu_torch.sampler import graph

    init = graph.StepGraph.__init__

    def eager_init(self, step, device, generator=None, capture=True):
        init(self, step, device, generator, capture=False)

    graph.StepGraph.__init__ = eager_init
    try:
        yield
    finally:
        graph.StepGraph.__init__ = init


class WindowLost(AssertionError):
    """The profiler lost a `StepWindow`'s marker kernel."""


class StepWindow:
    """torch.profiler over decode steps [first, first + count) of the first
    loop run inside (steps as its `StepGraph` counts them, the eager first
    step included): the device's kernels by name, their busy time (the union
    of every device event's interval) and the device's idle share over the
    span from the first event's start to the last one's end.

    The profiler loses device records, most often the few nearest the moment
    it starts or stops, now and then more (seen on the H100: up to ~390 of
    ~31400), so it runs `margin` steps before and after the window, and the
    window itself is cut out by two marker kernels (`torch.cuda._sleep`), each
    launched on an idle device (synchronized) at one of its two step
    boundaries: an event of the window starts at or after the first marker
    and ends before the second one starts. A lost marker raises `WindowLost`
    on exit; `settled_window` reads only a window that lost nothing."""

    MARKER = "spin_kernel"

    def __init__(self, first: int, count: int, margin: int = 2):
        self.first, self.count = first, count
        self.start_at = max(first - margin, 2)  # after the loop's capture (at step 1)
        self.stop_at = first + count + margin
        self.prof = None
        self.marks = []
        self.events = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from time_r1_tpu_torch.sampler import graph

        self.run = run = graph.StepGraph.run
        win = self
        if self.start_at > self.first:
            raise ValueError(f"a window from step {self.first} starts before the loop's capture")

        def mark():
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            win.marks.append(True)

        def run_windowed(g, n):
            for _ in range(n):
                if g.steps == win.start_at and win.prof is None:
                    torch.cuda.synchronize()
                    win.prof = profile(activities=[ProfilerActivity.CUDA])
                    win.prof.start()
                if g.steps == win.first and win.prof is not None and not win.marks:
                    mark()
                run(g, 1)
                if g.steps == win.first + win.count and len(win.marks) == 1:
                    mark()
                if g.steps == win.stop_at and len(win.marks) == 2 and win.events is None:
                    win._stop()

        graph.StepGraph.run = run_windowed
        return self

    def _stop(self):
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        events = [(e.name, e.time_range.start, e.time_range.end) for e in self.prof.events()
                  if e.device_type.name == "CUDA"]
        marks = sorted(a for n, a, _ in events if self.MARKER in n)
        self.lost = None if len(marks) == 2 else f"the profiler saw {len(marks)} of the window's 2 marker kernels"
        self.events = [] if self.lost else [
            (n, a, b) for n, a, b in events if a >= marks[0] and b <= marks[1] and self.MARKER not in n]

    def __exit__(self, *exc):
        from time_r1_tpu_torch.sampler import graph

        graph.StepGraph.run = self.run
        if self.prof is not None and self.events is None and (exc[0] is not None or len(self.marks) < 2):
            self.prof.stop()
            self.events = []
        if exc[0] is not None:
            return
        if len(self.marks) < 2:
            raise AssertionError(f"the decode never reached step {self.first + self.count}")
        if self.events is None:  # the loop ended inside the trailing margin
            self._stop()
        if self.lost:
            raise WindowLost(self.lost)

    def kernels(self, name: str) -> int:
        """Device events whose name holds `name`."""
        return sum(name in n for n, _, _ in self.events)

    def top(self, n: int) -> list:
        """The n event names that took the most device time: (name cut to 60
        characters, events, ms)."""
        by = {}
        for name, a, b in self.events:
            count, us = by.get(name, (0, 0.0))
            by[name] = (count + 1, us + b - a)
        ranked = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
        return [(name[:60], count, round(us / 1e3, 3)) for name, (count, us) in ranked]

    def stats(self) -> dict:
        spans = sorted((a, b) for _, a, b in self.events)
        if not spans:
            raise AssertionError("the profiler saw no device work in the window")
        busy, end = 0.0, spans[0][0]
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        span = end - spans[0][0]
        return dict(steps=self.count, span_ms=span / 1e3, busy_ms=busy / 1e3, idle_share=1.0 - busy / span,
                    device_events=len(spans))


def settled_window(run, first: int, count: int, tries: int = 4) -> tuple:
    """`run()` (one decode) under a `StepWindow` until two windows saw the
    same number of device records; returns the later of those two and every
    window's count (a lost marker as None). The profiler loses records now
    and then (`StepWindow`), while a decode launches the same kernels on
    every run: two windows that lost nothing agree, two that each lost some
    almost never do. So a window's kernels by name are read only from a window
    that lost nothing, and a kernel missing from every run is still missing
    there."""
    seen = []
    for _ in range(tries):
        try:
            with StepWindow(first=first, count=count) as win:
                run()
        except WindowLost:
            seen.append(None)
            continue
        n = len(win.events)
        seen.append(n)
        if seen.count(n) == 2:
            return win, seen
    raise AssertionError(f"no two of {tries} profiler windows saw the same device records: {seen}")


TURN_TOKENS = 64  # phases 4-6: the tokens a row of each timed turn (the path's own 128 or 200 before the last cuts, PERF.md §4)


def decode_both_ways(tag: str, run) -> dict:
    """Time one call `run()` (a generate; it returns the engine's timings)
    eagerly (`eager_decode`) and captured, in turns (eager, captured), in one
    process: decode ms/step and the call's wall seconds for each. Phases 4-6
    time TURN_TOKENS a row, phase 7 its whole stream."""
    import torch

    out = {}
    for mode in ("eager", "captured"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "eager":
            with eager_decode():
                tm = run()
        else:
            tm = run()
        torch.cuda.synchronize()
        out[mode] = dict(decode_ms_per_step=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1),
                         decode_steps=tm["decode_steps"], wall_s=time.perf_counter() - t0)
    e, c = out["eager"], out["captured"]
    log(f"[{tag}] decode ms/step in turns: eager {e['decode_ms_per_step']:.2f}, captured "
        f"{c['decode_ms_per_step']:.2f} ({e['decode_ms_per_step'] / c['decode_ms_per_step']:.2f}x) over "
        f"{c['decode_steps']} steps; wall {e['wall_s']:.2f} / {c['wall_s']:.2f} s")
    return out


def engine_decode(eng, reqs, sp, capture: bool):
    """`Engine.generate`'s prefill and decode, with the decode loop's own
    capture argument: (tokens (rows, max_new) on the host, the decode's KV
    buffers after the loop, decode steps)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import suffix_cache_zeros
    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.sampler.engine import _round_up, decode_loop, decode_loop_shared

    G, dev = sp.num_return_sequences, eng.device
    gen = torch.Generator(device=dev).manual_seed(sp.seed if sp.seed is not None else 0)
    with torch.no_grad():
        if G > 1:
            ids, mask, pos_ids, start1, vis, S, _ = eng._pack(reqs, extra_len=0)
            first1, prefix, _ = eng._prefill(ids, mask, pos_ids, vis, S, S)
            prefix = eng._maybe_quant_cache(prefix)
            bias = torch.where(torch.from_numpy(mask[:, :S] > 0).to(dev), 0.0, NEG_INF).float()
            cache = suffix_cache_zeros(eng.cfg.text, len(reqs) * G, _round_up(sp.max_new_tokens, 128),
                                       dtype=eng.dtype, device=dev, quant=eng.kv_cache_quant)
            tokens, steps = decode_loop_shared(eng.params, eng.cfg, prefix, cache, first1.repeat_interleave(G, dim=0),
                                               torch.from_numpy(np.repeat(start1, G)).to(dev).long(), bias, sp, gen,
                                               capture=capture, lora_side=eng.lora_side)
        else:
            ids, mask, pos_ids, start, vis, S, max_len = eng._pack(reqs, extra_len=sp.max_new_tokens)
            first, cache, mask_t = eng._prefill(ids, mask, pos_ids, vis, S, max_len)
            cache = eng._maybe_quant_cache(cache)
            tokens, steps = decode_loop(eng.params, eng.cfg, cache, first, torch.from_numpy(start).to(dev).long(),
                                        mask_t, sp, gen, capture=capture, lora_side=eng.lora_side)
    buffers = [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]
    return tokens.cpu(), buffers, steps


# Phase 3e: (name, G, weight quantization, int8 KV, side-path LoRA, the
# kernels of its decode step and their launches a layer). "int8 base" is the
# LoRA trainer's rollout: an int8 decode-fused tree handed to the engine
# already quantized, with side adapters, under which Q2 does not run (0).
CAPTURED_ENGINE_CASES = (
    ("Engine G = 1, bf16", 1, None, False, False, {}),
    ("G-way bf16", 8, None, False, False, {"decode_full_tc": 1}),
    ("G-way int8 weights, int8 KV", 8, "int8", True, False, {"decode_full_tc": 1, "fused_mlp_tc": 1}),
    ("G-way int4 weights, int8 KV", 8, "int4", True, False, {"decode_full_tc": 1, "int4_mm_tc": 4}),
    ("G-way LoRA side path, int8 base, int8 KV", 8, "int8 base", True, True,
     {"decode_full_tc": 1, "fused_mlp_tc": 0}),
)
CAPTURED_PAGED_CASES = (
    ("PagedEngine, bf16 pages", None, False, False, {"paged_tc": 1}),
    ("PagedEngine, int8 weights, int8 pages", "int8", True, False, {"paged_tc": 1, "fused_mlp_tc": 1}),
    ("PagedEngine LoRA side path, bf16 pages", None, False, True, {"paged_tc": 1}),
)


def phase_captured_decode() -> dict:
    """Phase 3e: the captured decode at reduced depth (3B widths, 2 layers, 2
    ViT blocks, bf16, seeded random weights), held against the eager loop in
    eight configurations: `Engine` at G = 1, the G-way decode in bf16 (D2),
    over int8 weights and int8 KV (D2, Q2), over int4 weights and int8 KV
    (D2, Q1) and with side-path LoRA over an int8 fused base and int8 KV
    (D2, no Q2) through the loop functions' `capture` argument, and
    `PagedEngine` with bf16 pages (P1), with int8 weights and int8 pages
    (P2, Q2) and with side-path LoRA over bf16 pages (P1) through
    `eager_decode`. The two LoRA configurations then take a second adapter
    set: its replayed tokens must equal its eager run's and differ from the
    first set's (a capture replayed with the old adapters would not). Greedy, replayed tokens and the KV
    written must be bit-equal to the eager loop's; sampled at T = 1.0 two
    captured runs must be, and whether they equal the eager draws is
    reported. One replayed step is profiled: its launches of each kernel,
    by name, must be the step's per-layer count x 2 layers."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.ops.quant import quantize_params
    from time_r1_tpu_torch.sampler import Engine, PagedEngine, SamplingParams

    cfg = reduced_config()
    L = cfg.text.num_hidden_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    video = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    texts = [text_request(cfg, rng, n) for n in (37, 150, 290)]
    out = {}

    def hold(name, step_kernels, run, greedy, lora=None):
        """run(sp, mode) -> (tokens as lists, the KV written), mode "eager"
        or "captured". lora: (install(layers), (first set, second set)) of
        an engine whose first set is installed."""
        (te, be), (tc, bc) = run(greedy, "eager"), run(greedy, "captured")
        same = te == tc and all(torch.equal(a, b) for a, b in zip(be, bc))
        sampled = replace(greedy, temperature=1.0, seed=5)
        draws = [run(sampled, mode)[0] for mode in ("eager", "captured", "captured")]
        sampled_same, sampled_eager = draws[1] == draws[2], draws[0] == draws[1]
        win, seen = settled_window(lambda: run(greedy, "captured"), first=3, count=1)
        per_step = {k: win.kernels(k) for k in step_kernels}
        log(f"[captured] {name}: greedy replay == eager (tokens and KV bit-equal): {same}; sampled T = 1.0: "
            f"two captured runs equal {sampled_same}, captured == eager {sampled_eager}; one replayed step: "
            f"{per_step} launches by name, {len(win.events)} device events (windows' records {seen})")
        if not same:
            raise AssertionError(f"{name}: replayed greedy tokens or KV differ from the eager loop's")
        if lora is not None:  # a second adapter set, installed after the captures above
            set_side, (first_set, second_set) = lora
            set_side(second_set)
            (t2e, _), (t2c, _) = run(greedy, "eager"), run(greedy, "captured")
            set_side(first_set)
            log(f"[captured] {name}: a second adapter set: replay == eager {t2c == t2e}, tokens changed "
                f"{t2c != tc}")
            if t2c != t2e or t2c == tc:
                raise AssertionError(f"{name}: the second adapter set's replay differs from its eager run, or "
                                     "it left the tokens as they were (a stale capture)")
            out.setdefault(name, {})["second_set"] = dict(replay_equal_eager=t2c == t2e, changed=t2c != tc)
        if not sampled_same:
            raise AssertionError(f"{name}: two captured sampled runs differ")
        want = {k: n * L for k, n in step_kernels.items()}
        if per_step != want:
            raise AssertionError(f"{name}: one replayed step launched {per_step}, want {want}")
        out.setdefault(name, {}).update(
            greedy_equal=same, sampled_captured_equal=sampled_same, sampled_equal_eager=sampled_eager,
            step_kernels=per_step, step_device_events=len(win.events))

    def adapters(eng, base, fused):
        """Two seeded adapter sets over `base`, the first installed on eng:
        hold()'s `lora` argument."""
        from time_r1_tpu_torch.rl.lora import lora_layers_tree

        sets = [lora_layers_tree(seeded_adapters(base, cfg, seed, fused=fused)[0])[0] for seed in (11, 12)]
        eng.set_lora_side(sets[0], 2.0)
        return lambda layers: eng.set_lora_side(layers, 2.0), sets

    for name, G, quant, kvq, side, step_kernels in CAPTURED_ENGINE_CASES:
        base = quantize_params(params, bits=8, fuse=True) if quant == "int8 base" else params
        eng = Engine(base, cfg, dtype=torch.bfloat16, device="cuda",
                     quantization=None if quant == "int8 base" else quant, kv_cache_quant=kvq)
        lora = adapters(eng, base, fused=quant == "int8 base") if side else None

        def run_engine(sp, mode):
            tokens, kv, _ = engine_decode(eng, [video], sp, capture=mode == "captured")
            return tokens.tolist(), kv

        hold(name, step_kernels, run_engine, SamplingParams(max_new_tokens=24, stop_token_ids=(),
                                                            num_return_sequences=G), lora)
        del eng, base
    for name, quant, kvq, side, step_kernels in CAPTURED_PAGED_CASES:
        eng = PagedEngine(params, cfg, max_slots=2, max_len=1024, page_size=128, segment=16,
                          prefill_chunk_tokens=256, dtype=torch.bfloat16, quantization=quant, kv_cache_quant=kvq,
                          device="cuda")
        lora = adapters(eng, params, fused=False) if side else None

        def run_paged(sp, mode):
            if mode == "eager":
                with eager_decode():
                    return eng.generate([video] + texts, sp), []
            return eng.generate([video] + texts, sp), []

        hold(name, step_kernels, run_paged, SamplingParams(max_new_tokens=24, stop_token_ids=()), lora)
        del eng
    return out


LENGTH_MIX = (200, 450, 900, 1800)  # scripts/bench_serving.py:38


SERVE_LAYERS = 4  # phase 7's decoder depth: its 36 layers took 100 s (eager turns, ContinuousEngine) of the limit
# (12 until phase 17 came into it, 6 before the last cuts, PERF.md §4)


def stream_requests(cfg):
    """Phase 7's stream: phase 4's two video requests, then ten text requests
    whose lengths cycle through LENGTH_MIX, shuffled and drawn from seed 0 as
    scripts/bench_serving.py's build_requests does."""
    rng = np.random.default_rng(0)
    reqs = [video_request(cfg, rng, 32, 224, 392), video_request(cfg, rng, 24, 280, 336)]
    trng = np.random.default_rng(0)
    lens = [LENGTH_MIX[i % len(LENGTH_MIX)] for i in range(10)]
    trng.shuffle(lens)
    return reqs + [text_request(cfg, trng, int(n)) for n in lens]


def phase_serving_full_size() -> dict:
    """Phase 7: continuous-batching serving at full width, after phase 6 freed
    its model. Qwen2.5-VL-3B in bf16 with seeded random weights, its decoder
    cut to SERVE_LAYERS layers (the script's time limit); 12 requests
    (stream_requests), greedy, 128 new tokens with no stop ids; 4 slots,
    max_len 4096, pages of 128, segments of 16, 1024-token prefill chunks.
    (a) PagedEngine with a bf16 pool (P1); (b) PagedEngine with int8
    weights and int8 KV pages, scripts/bench_serving.py's default (P2, Q2);
    (c) ContinuousEngine over the same stream. Launch counts are checked
    exactly: P1/P2 L x 16 x segments, K1 L x the prefill chunks of the
    admissions, K2/K3 28/4 per admission that holds a video, Q2 L per step
    in (b), D1/D2 and the training kernels 0."""
    import gc

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.sampler import ContinuousEngine, PagedEngine, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    base = Qwen25VLConfig.qwen25vl_3b()
    cfg = replace(base, text=replace(base.text, num_hidden_layers=SERVE_LAYERS))
    L = cfg.text.num_hidden_layers
    n_full = len(cfg.vision.fullatt_block_indexes)
    n_window = cfg.vision.depth - n_full
    chunk = 1024
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    reqs = stream_requests(cfg)
    log(f"[serve] init_params bf16: {time.perf_counter() - t0:.1f} s; prompts {[len(r.input_ids) for r in reqs]} "
        f"tokens")
    sp = SamplingParams(max_new_tokens=128, stop_token_ids=())
    kw = dict(max_slots=4, max_len=4096, segment=16, prefill_chunk_tokens=chunk, dtype=torch.bfloat16, device="cuda")
    runs = (
        ("a", "PagedEngine, bf16 pool", lambda: PagedEngine(params, cfg, page_size=128, **kw)),
        ("b", "PagedEngine, int8 weights + int8 KV pages",
         lambda: PagedEngine(params, cfg, page_size=128, quantization="int8", kv_cache_quant=True, **kw)),
        ("c", "ContinuousEngine, bf16", lambda: ContinuousEngine(params, cfg, **kw)),
    )
    tokens, result = {}, {}
    for tag, what, make in runs:
        eng = make()
        eng.generate([reqs[-1]], replace(sp, max_new_tokens=2))  # warm-up: one short text request
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.generate(reqs, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        tm = eng.timings
        n_gen = sum(len(o) for o in out)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[serve] ({tag}) {what}: {wall:.2f} s wall, {n_gen} tokens, {n_gen / wall:.1f} tok/s; prefill "
            f"{tm['prefill_s']:.2f} s (vision {tm['vision_s']:.2f} s), decode {tm['decode_s']:.2f} s = "
            f"{tm['decode_s'] * 1e3 / tm['decode_steps']:.2f} ms/step over {tm['decode_steps']} steps, "
            f"{tm['segments']} segments ({tm['interleaved_segments']} inside admissions), peak {peak:.2f} GiB")
        log(f"[serve] ({tag}) admissions (rows, bucket, video) {tm['admissions']}")
        log(f"[serve] ({tag}) launches {launches}")
        if not all(len(o) == sp.max_new_tokens for o in out):
            raise AssertionError(f"({tag}): rows of {[len(o) for o in out]} tokens, want {sp.max_new_tokens} each")
        chunks = sum(-(-S // chunk) for _, S, _ in tm["admissions"])
        videos = sum(v for _, _, v in tm["admissions"])
        steps = L * tm["decode_steps"]
        want = {name: 0 for name in launches}
        want.update(flash_attention=L * chunks, window_attention_rope=n_window * videos,
                    full_attention_rope=n_full * videos)
        if tag == "a":
            want["paged_prefix_attention"] = steps
        if tag == "b":
            want["paged_prefix_attention_q8"] = steps
            want["fused_mlp_int8"] = steps
        tc = FWD_TC + {"a": PAGED_KERNELS[:1], "b": PAGED_KERNELS[1:], "c": ()}[tag]
        want.update({f"{n}_tc": want[n] for n in tc})  # bf16: every K1-K3 and P1/P2 launch on the tensor cores
        bad = {k: (launches[k], want[k]) for k in want if launches[k] != want[k]}
        if bad:
            raise AssertionError(f"({tag}): launches (got, want) {bad}")
        check_tc_route(f"serve ({tag})", launches, {n: want[n] for n in tc}, tensor_cores=True)
        if tag in ("a", "b") and tm["interleaved_segments"] < 1:
            raise AssertionError(f"({tag}): no segment ran inside an admission")
        tokens[tag] = out
        result[tag] = dict(launches=launches, wall_s=wall, tok_s=n_gen / wall, prefill_s=tm["prefill_s"],
                           vision_s=tm["vision_s"], decode_ms_per_step=tm["decode_s"] * 1e3 / tm["decode_steps"],
                           segments=tm["segments"], interleaved_segments=tm["interleaved_segments"], peak_gib=peak)
        if tag in ("a", "b"):  # the paged segments, captured; (c) stays eager
            result[tag]["in_turns"] = decode_both_ways(f"serve ({tag})", lambda: (eng.generate(reqs, sp),
                                                                                 eng.timings)[1])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = sum(a == c for a, c in zip(tokens["a"], tokens["c"]))
    prefix = [next((i for i, (x, y) in enumerate(zip(a, c)) if x != y), len(a)) for a, c in zip(tokens["a"], tokens["c"])]
    log(f"[serve] rows whose tokens agree, (a) paged vs (c) continuous: {same} of {len(reqs)}; tokens before the "
        f"first difference, per row: {prefix} (for information: bf16 rounds at other places in the two attention "
        f"routes)")
    result["a_vs_c"] = dict(rows_equal=same, common_prefix=prefix)
    log(f"[serve] summary {json.dumps(result)}")
    return result


# ---------------------------------------------------------------------------
# phase 8
INPUT_HW = (360, 640)  # the raw frames' size (the 360p the eval videos decode to)
# the stand-in decoder's clips: name -> (raw frames, fps, seed), and what
# TrainConfig's budget must make of them: (sampled frames, resized h x w,
# video tokens, prompt bucket)
INPUT_CLIPS = {
    "clip_32s_10fps": ((320, 10.0, 1), (64, (196, 392), 3136, 4096)),
    "clip_4s_30fps": ((120, 30.0, 2), (8, (364, 644), 1196, 2048)),
}
RESIZE_SHARE = 1e-3  # device vs host resize: at most 1 gray level, on under this share of the pixels


class StandInTokenizer:
    """A character-level tokenizer over Qwen2.5-VL-3B's ids (no tokenizer is
    in the repository), as tests/tiny_tokenizer.py is over the tiny config's:
    the special tokens map to the 3B's ids, printable ASCII to ids 3..97,
    anything else to id 98; every id decodes (one character of its own for
    the ids no string maps to), so sampled completions decode too."""

    chat_template = None

    def __init__(self, cfg):
        self.specials = {
            "<|vision_start|>": cfg.vision_start_token_id, "<|vision_end|>": cfg.vision_end_token_id,
            "<|image_pad|>": cfg.image_token_id, "<|video_pad|>": cfg.video_token_id,
            "<|im_start|>": 151644, "<|im_end|>": cfg.eos_token_id, "<|endoftext|>": cfg.pad_token_id,
        }
        self._rev = {v: k for k, v in self.specials.items()}

    def encode(self, s, add_special_tokens=False):
        out, i = [], 0
        while i < len(s):
            if s[i] == "<":
                tok = next((t for t in self.specials if s.startswith(t, i)), None)
                if tok is not None:
                    out.append(self.specials[tok])
                    i += len(tok)
                    continue
            c = ord(s[i])
            out.append(c - 32 + 3 if 32 <= c < 127 else 98)
            i += 1
        return out

    def decode(self, ids, skip_special_tokens=False):
        parts = []
        for t in ids:
            t = int(t)
            if t in self._rev:
                if not skip_special_tokens:
                    parts.append(self._rev[t])
            elif 3 <= t <= 97:
                parts.append(chr(t - 3 + 32))
            else:
                parts.append(chr(0x4E00 + t % 0x5000))
        return "".join(parts)


def char_parity_reward(completions, **kwargs):
    """A stand-in reward that varies across the rows of a group (the share of
    odd code points in the decoded text), so that the advantages are not zero."""
    return [sum(ord(c) % 2 for c in text) / max(len(text), 1) for text in completions]


class FrameLoader:
    """Phase 8's `video_loader`: seeded uint8 RGB frames at INPUT_HW stand in
    for the decoder (each sampled frame drawn from its clip's seed and index,
    as a decoder decodes only the sampled frames), then the port's own
    plan_frame_window, plan_video_shapes and resize_frames_bicubic: the same
    three calls as `video.pipeline.fetch_video`. `times` holds the host ms of
    the main thread's last call."""

    def __init__(self):
        self.times = {}

    @staticmethod
    def raw_frames(name: str, indices) -> np.ndarray:
        n, _, seed = INPUT_CLIPS[name][0]
        return np.stack([np.random.default_rng([seed, int(i)]).integers(0, 256, (*INPUT_HW, 3), dtype=np.uint8)
                         for i in indices])

    def __call__(self, ele: dict):
        import threading

        from time_r1_tpu_torch.utils.vision_math import VIDEO_MIN_PIXELS, plan_frame_window, plan_video_shapes
        from time_r1_tpu_torch.video.pipeline import resize_frames_bicubic

        n, fps, _ = INPUT_CLIPS[ele["video"]][0]
        t0 = time.perf_counter()
        plan = plan_frame_window(ele, total_frames=n, video_fps=fps)
        frames = self.raw_frames(ele["video"], plan.indices)
        t1 = time.perf_counter()
        out_h, out_w = plan_video_shapes(*INPUT_HW, nframes=len(frames), total_pixels=ele.get("total_pixels"),
                                         min_pixels=ele.get("min_pixels", VIDEO_MIN_PIXELS),
                                         max_pixels=ele.get("max_pixels"))
        frames = resize_frames_bicubic(frames, out_h, out_w)
        t2 = time.perf_counter()
        if threading.current_thread() is threading.main_thread():
            self.times = {"loader_ms": (t1 - t0) * 1e3, "resize_ms": (t2 - t1) * 1e3}
        return frames.transpose(0, 3, 1, 2).astype(np.float32), plan.sample_fps


class MainThreadTimed:
    """`inner` with its calls timed: each call from the main thread adds its
    host ms (after a device sync with `sync`) to times[key]; calls from other
    threads (the prefetch worker) pass through untimed. Other attributes are
    `inner`'s."""

    def __init__(self, inner, times: dict, key: str, sync: bool = False):
        self.inner, self.times, self.key, self.sync = inner, times, key, sync

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *args, **kwargs):
        import threading

        import torch

        if threading.current_thread() is not threading.main_thread():
            return self.inner(*args, **kwargs)
        t0 = time.perf_counter()
        out = self.inner(*args, **kwargs)
        if self.sync:
            torch.cuda.synchronize()
        self.times[self.key] = self.times.get(self.key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out


def resize_on_the_card(total_pixels: int, min_pixels: int) -> dict:
    """(b): the 32 s clip's sampled frames through the host's native resize
    and through `resize_frames_device` on the card with TF32 requested by the
    caller; at most 1 gray level apart, on under RESIZE_SHARE of the pixels.
    For information, the same two matmuls with TF32 on, as the device resize
    would be without its pin."""
    import torch

    from time_r1_tpu_torch.utils.vision_math import plan_frame_window, plan_video_shapes
    from time_r1_tpu_torch.video.resize import resize_frames_device, resize_frames_host, resize_weights

    name = "clip_32s_10fps"
    n, fps, _ = INPUT_CLIPS[name][0]
    plan = plan_frame_window({"total_pixels": total_pixels, "min_pixels": min_pixels}, n, fps)
    raw = FrameLoader.raw_frames(name, plan.indices)
    out_h, out_w = plan_video_shapes(*INPUT_HW, len(raw), total_pixels, min_pixels)
    t0 = time.perf_counter()
    resize_frames_host(raw[:1], out_h, out_w)  # first use: g++ builds the library
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = resize_frames_host(raw, out_h, out_w)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.backends.cuda.matmul.allow_tf32 = True  # the caller asks for TF32: the resize must not use it
    try:
        resize_frames_device(raw, out_h, out_w)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = resize_frames_device(raw, out_h, out_w).cpu().numpy()
        dev_ms = (time.perf_counter() - t0) * 1e3
        on_card = torch.from_numpy(raw).cuda()
        kernel_ms = cuda_ms(lambda: resize_frames_device(on_card, out_h, out_w), iters=10, queued=False)
        still_on = torch.backends.cuda.matmul.allow_tf32
        T, H, W, C = raw.shape
        wh = torch.tensor(resize_weights(H, out_h), device="cuda")
        ww = torch.tensor(resize_weights(W, out_w), device="cuda")
        y = torch.matmul(wh, on_card.float().reshape(T, H, W * C))
        y = torch.matmul(y.reshape(T * out_h, W, C).transpose(1, 2).reshape(-1, W), ww.t())
        tf32 = y.round_().clamp_(0, 255).to(torch.uint8).reshape(T, out_h, C, out_w).permute(0, 1, 3, 2).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    diff = np.abs(dev.astype(int) - host.astype(int))
    tf32_diff = np.abs(tf32.astype(int) - host.astype(int))
    out = dict(frames=list(raw.shape), to=[out_h, out_w], host_first_frame_with_build_ms=build_ms,
               host_native_ms=host_ms, device_ms_with_copies=dev_ms,
               device_ms_on_card=kernel_ms, max_diff=int(diff.max()), share_diff=float((diff > 0).mean()),
               tf32_max_diff=int(tf32_diff.max()), tf32_share_diff=float((tf32_diff > 0).mean()))
    log(f"[input] (b) resize of {raw.shape} uint8 to {out_h}x{out_w}: host native {host_ms:.1f} ms (its first "
        f"frame, with the library's g++ build, {build_ms:.1f} ms before); device "
        f"{dev_ms:.1f} ms with the copies, {kernel_ms:.3f} ms on the card from frames there; device vs host max "
        f"{out['max_diff']} gray, {out['share_diff']:.2e} of pixels differ (TF32 requested by the caller, still "
        f"on after: {still_on}); for information, TF32 matmuls: max {out['tf32_max_diff']}, "
        f"{out['tf32_share_diff']:.2e} of pixels")
    if not still_on:
        raise AssertionError("(b): resize_frames_device did not give the caller's TF32 setting back")
    if out["max_diff"] > 1 or out["share_diff"] >= RESIZE_SHARE:
        raise AssertionError(f"(b): device resize off the host's by {out['max_diff']} gray on "
                             f"{out['share_diff']:.2e} of pixels (bound 1, {RESIZE_SHARE})")
    return out


def same_requests(a, b) -> bool:
    """ids, grid and seconds per grid equal; patches bit-equal."""
    import torch

    return len(a) == len(b) and all(
        list(x.input_ids) == list(y.input_ids) and tuple(x.grid_thw) == tuple(y.grid_thw)
        and x.second_per_grid_t == y.second_per_grid_t and x.patches.dtype == y.patches.dtype
        and torch.equal(x.patches, y.patches) for x, y in zip(a, b))


def phase_input_path(card: str) -> dict:
    """Phase 8: the host input path at full size, after phase 7 freed its
    model. Qwen2.5-VL-3B in bf16 with seeded random weights and a reference
    copy under `GRPOTrainer`, whose video_loader is FrameLoader (seeded raw
    frames at 360x640 in place of the decoder: no video and no FFmpeg
    development files on the card's machine) and whose processor is the
    port's Qwen25VLProcessor over StandInTokenizer, at TrainConfig's budget:
    (a) the loader's two clips, planned as INPUT_CLIPS says; (b) the resize on
    the card against the host's; (c) the processor's video tokens, t·h·w/4 of
    the grid; (d) the 32 s clip served through `trainer.engine.generate`
    (greedy, 128 tokens, bucket 4096, after a 2-token warm-up), then two
    `step_batch([example])` calls on the 4 s clip with requests=None (bucket
    2048, prepare_requests inside host_preproc); while the first runs, a
    one-worker thread pool prepares the same example's requests, held against
    a serial `prepare_requests`; every launch count checked. Returns the
    second call's launches."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.sampler import SamplingParams
    from time_r1_tpu_torch.sampler.engine import PREFILL_CHUNK, _bucket
    from time_r1_tpu_torch.utils.profiling import PhaseTimers
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    gc.collect()
    torch.cuda.empty_cache()
    log("[input] no video file is decoded here (the repository holds no video, and this machine has no FFmpeg "
        "development files): seeded raw frames stand in for the decoder, whose decode is held against the JAX "
        "package on the CPU (tests/test_torch_video.py)")
    cfg = Qwen25VLConfig.qwen25vl_3b()
    L = cfg.text.num_hidden_layers
    config = TrainConfig(report_to="none")
    result = {"card": card, "resize": resize_on_the_card(config.total_pixels, config.min_pixels)}

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"))
    loader = FrameLoader()
    pre = {}  # host_preproc's processor and staging ms, main thread
    processor = Qwen25VLProcessor(StandInTokenizer(cfg), pad_token_id=cfg.pad_token_id,
                                  eos_token_id=cfg.eos_token_id)
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], char_parity_reward]
    trainer = GRPOTrainer(params, cfg, MainThreadTimed(processor, pre, "processor_ms"), rewards, config=config,
                          video_loader=loader, ref_params=ref, dtype=torch.bfloat16, device="cuda")
    trainer._stage = MainThreadTimed(trainer._stage, pre, "staging_ms", sync=True)
    torch.cuda.synchronize()
    log(f"[input] init_params 3B bf16, its reference copy and the trainer: {time.perf_counter() - t0:.1f} s")

    def example(name):
        n, fps, _ = INPUT_CLIPS[name][0]
        return {"problem": "a person opens a door", "solution": (1.0, 3.0), "durations": n / fps,
                "video_path": name}

    def prepare_checked(name):
        """(a) and (c): one example's request, planned and tokenized as INPUT_CLIPS says."""
        pre.clear()
        t0 = time.perf_counter()
        req = trainer.prepare_requests([example(name)])[0]
        ms = (time.perf_counter() - t0) * 1e3
        sampled, hw, tokens, bucket = INPUT_CLIPS[name][1]
        t, h, w = req.grid_thw
        n_vid = req.input_ids.count(cfg.video_token_id)
        got = (2 * t, (h * 14, w * 14), n_vid, _bucket(len(req.input_ids)))
        log(f"[input] (a, c) {name}: {sampled} sampled frames at {hw[0]}x{hw[1]}, grid {req.grid_thw}, "
            f"{n_vid} video tokens of {len(req.input_ids)}, bucket {got[3]}, patches {tuple(req.patches.shape)} "
            f"{req.patches.dtype} on {req.patches.device}; prepare_requests {ms:.1f} ms: {loader.times} {pre}")
        if got != (sampled, hw, tokens, bucket) or n_vid != t * h * w // 4:
            raise AssertionError(f"{name}: (frames, size, video tokens, bucket) {got}, want "
                                 f"{(sampled, hw, tokens, bucket)}; t*h*w/4 = {t * h * w // 4}")
        if req.patches.device.type != "cuda" or req.patches.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: patches not staged on the card in bf16")
        return req

    # (d) serving: the 32 s clip, greedy, 128 tokens
    req32 = prepare_checked("clip_32s_10fps")
    prepare_checked("clip_4s_30fps")
    sp = SamplingParams(max_new_tokens=128, stop_token_ids=())
    t0 = time.perf_counter()
    trainer.engine.generate([req32], replace(sp, max_new_tokens=2))  # warm-up, as phase 4
    torch.cuda.synchronize()
    log(f"[input] (d) warm-up generate of the 32 s clip (2 tokens, the trainer's first): "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = trainer.engine.generate([req32], sp)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_launches()
    tm = trainer.engine.timings
    chunks = -(-_bucket(len(req32.input_ids)) // PREFILL_CHUNK)
    serve = dict(vision_ms=tm["vision_s"] * 1e3, prefill_ms=tm["prefill_s"] * 1e3,
                 decode_ms_per_step=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1),
                 decode_steps=tm["decode_steps"], generate_s=total,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[input] (d) served the 32 s clip: vision {serve['vision_ms']:.1f} ms, prefill {serve['prefill_ms']:.1f} "
        f"ms, decode {serve['decode_ms_per_step']:.2f} ms/step over {tm['decode_steps']} steps, {total:.2f} s for "
        f"the generate() call, peak {serve['peak_gib']:.2f} GiB allocated")
    check_tc_route("input serve", launches, vision_tc_launches(cfg) | {"flash_attention": L * chunks},
                   tensor_cores=True)
    if len(out) != 1 or len(out[0]) != sp.max_new_tokens:
        raise AssertionError(f"input serve: rows of {[len(o) for o in out]} tokens, want {sp.max_new_tokens}")
    result["serve"] = serve

    # (d) training: two step_batch calls from frames, the first beside a prefetch worker
    calls = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        for call in (1, 2):
            trainer.timers = PhaseTimers(sync=True)
            pre.clear()
            loader.times = {}
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            ahead = pool.submit(trainer.prepare_requests, [example("clip_4s_30fps")]) if call == 1 else None
            t0 = time.perf_counter()
            info = trainer.step_batch([example("clip_4s_30fps")])
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            launches = read_launches()
            if ahead is not None:
                threaded = ahead.result(timeout=600)
            metrics = trainer.pop_metrics()
            tm = trainer.engine.timings
            phases = {k: round(v["total_s"] * 1e3, 1) for k, v in trainer.timers.summary().items()}
            split = {k: round(v, 1) for k, v in (loader.times | pre).items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"[input] step_batch {call} from frames: {total:.2f} s; phases (ms, synced) {phases}; host_preproc "
                f"split (ms) {split}; rollout vision {tm['vision_s'] * 1e3:.1f} ms, prefill "
                f"{tm['prefill_s'] * 1e3:.1f} ms, decode {tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} "
                f"ms/step over {tm['decode_steps']} steps; peak {peak:.2f} GiB allocated"
                + ("; a worker thread prepared the next requests meanwhile" if call == 1 else ""))
            log(f"[input] step_batch {call}: launches {launches}")
            log(f"[input] step_batch {call}: loss {info['loss']:.6f}, reward {info['reward']:.4f}, grad_norm "
                f"{metrics['grad_norm']:.4f}")
            if "host_preproc" not in phases:
                raise AssertionError(f"step_batch {call}: prepare_requests did not run in host_preproc")
            if not (np.isfinite(info["loss"]) and np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
                raise AssertionError(f"step_batch {call}: loss {info['loss']} or grad_norm {metrics['grad_norm']}")
            for name in TRAIN_KERNELS:
                if launches[name] <= 0:
                    raise AssertionError(f"step_batch {call} from frames: {name} was not launched")
            check_step_launches(f"input step_batch {call}", launches, tm["decode_steps"], L,
                                {"shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                                 "int4_matmul": 0, "fused_mlp_int8": 0})
            check_tc_route(f"input step_batch {call}", launches, step_batch_tc_launches(cfg, tm["decode_steps"]),
                           tensor_cores=True)
            calls.append(dict(step_s=total, phases_ms=phases, host_preproc_split_ms=split,
                              decode_ms_per_step=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1), peak_gib=peak))
    serial = trainer.prepare_requests([example("clip_4s_30fps")])
    if not same_requests(threaded, serial):
        raise AssertionError("requests prepared on the worker thread differ from a serial prepare_requests")
    log("[input] the worker thread's requests equal a serial prepare_requests (ids, grid, bf16 patches "
        "bit-equal)")
    result["step_batch"] = calls
    log(f"[input] summary on {card}: {json.dumps(result)}")
    del trainer, ref, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9
PHASE9_BYTES = 26e9  # what phase 9 writes at its peak (three 3B checkpoints of at most 7.5 GB), with room
# The decoder depth of the CLI phases (9, 10 and 12 (d): the 3B; 11: the 7B), cut so that the script, its
# phases 13 and 14 included, stays inside its time limit: their checks are of the entry points' plumbing, whose
# work per layer is the same at any depth (12, with phase 15 inside the limit too)
CLI_LAYERS = 2  # phases 9, 10 (a), 12 (d): 36 until phase 14, 18 until phase 15, 12 until phase 17, 6 before the
# last cuts (PERF.md §4)
LORA_7B_LAYERS = 4  # phase 11: 28 until phase 14, 14 until phase 17, 8 before the last cuts (PERF.md §4)


def cut_depth(cfg, layers: int):
    """cfg with its decoder cut to `layers` layers (full width)."""
    return replace(cfg, text=replace(cfg.text, num_hidden_layers=layers))


# Phases 13-16's vision tower: the 3B's first 8 blocks at full width (7 windowed, then a full-attention one, as the
# whole tower repeats them), so K2 and K3 run at every mesh layout. The whole tower (32) before the last cuts for
# the script's time limit (PERF.md §4): over gloo it was more than half of every gathered, staged or saved tree's
# bytes
MESH_VISION_DEPTH = 8


def mesh_3b(layers: int):
    """Qwen2.5-VL-3B at full width for phases 13-16: `layers` decoder layers
    and MESH_VISION_DEPTH vision blocks."""
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig.qwen25vl_3b()
    vision = replace(cfg.vision, depth=MESH_VISION_DEPTH, fullatt_block_indexes=(MESH_VISION_DEPTH - 1,))
    return replace(cut_depth(cfg, layers), vision=vision)
CLI_CLIP = "clip_4s_30fps"  # phase 8's training clip: 8 frames at 364x644, bucket 2048


def trees_equal(a, b) -> bool:
    """Same paths, dtypes, shapes and bits."""
    import torch

    from time_r1_tpu_torch.utils.checkpoint import flatten

    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape and torch.equal(fa[k], fb[k]) for k in fa)


def write_dataset(root: str, name: str, n: int) -> str:
    """A TimeRFT annotation file of n examples whose videos are placeholder
    files (cli_stand_ins' loader stands in for their decode), each with the
    qid that the SF loop's self-eval keys on."""
    items = []
    for i in range(n):
        video = os.path.join(root, f"{name}_{i}.mp4")
        with open(video, "wb") as f:
            f.write(b"placeholder")
        items.append({"video": video, "duration": 4.0, "timestamp": [0.5 + 0.25 * i, 2.5 + 0.25 * i],
                      "sentence": f"A person opens door number {i}.", "qid": f"{name}_{i}"})
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return path


@contextmanager
def cli_stand_ins(cfg):
    """What `cli.train.main` and `cli.evaluate.main` cannot have without a
    real checkpoint and video, patched for the block: the processor's
    tokenizer (StandInTokenizer, as the CPU tests patch `from_pretrained`
    with the tiny tokenizer), the video decode of the trainer and of
    `EvalDataset` (phase 8's seeded frames of CLI_CLIP), and a reward that
    varies across a group (random weights score 0 on the timestamp and
    format rewards). The trainer's phase timers sync, so that they are
    device times."""
    from time_r1_tpu_torch.cli import train as cli
    from time_r1_tpu_torch.data import eval_dataset
    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    loader = FrameLoader()
    saved = (Qwen25VLProcessor.__dict__["from_pretrained"], cli.video_loader, eval_dataset.fetch_video,
             os.environ.get("TIMER1_SYNC_TIMERS"))
    Qwen25VLProcessor.from_pretrained = classmethod(lambda cls, path, **kw: cls(
        StandInTokenizer(cfg), pad_token_id=cfg.pad_token_id, eos_token_id=cfg.eos_token_id))
    cli.video_loader = eval_dataset.fetch_video = lambda ele: loader({**ele, "video": CLI_CLIP})
    REWARD_FUNCS_REGISTRY["char_parity"] = char_parity_reward
    os.environ["TIMER1_SYNC_TIMERS"] = "1"
    try:
        yield cli
    finally:
        Qwen25VLProcessor.from_pretrained, cli.video_loader, eval_dataset.fetch_video = saved[:3]
        del REWARD_FUNCS_REGISTRY["char_parity"]
        if saved[3] is None:
            os.environ.pop("TIMER1_SYNC_TIMERS", None)
        else:
            os.environ["TIMER1_SYNC_TIMERS"] = saved[3]


@contextmanager
def gc_timed(times: list):
    """Append each of Python's garbage-collector passes in the block to
    `times` as (generation, ms)."""
    import gc

    start = []

    def callback(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            times.append((info["generation"], (time.perf_counter() - start.pop()) * 1e3))

    gc.callbacks.append(callback)
    try:
        yield times
    finally:
        gc.callbacks.remove(callback)


@contextmanager
def patched(cls, name: str, wrap):
    """cls.name (a class's or a module's attribute) replaced by wrap(original) for the block."""
    original = getattr(cls, name)
    setattr(cls, name, wrap(original))
    try:
        yield
    finally:
        setattr(cls, name, original)


def cli_args(cli, model: str, out: str, data: str, *extra):
    """The CLI's defaults (G = 8, 200 tokens, accumulation 2, remat "full",
    report_to tensorboard) for one epoch with half of it warmup, a save
    cadence that writes only the epoch's and the final directories, and the
    stand-in reward beside the recipe's two."""
    return cli.get_args(["--model_name_or_path", model, "--output_dir", out, "--train_data_path", data,
                         "--reward_funcs", "iou", "format", "char_parity", "--num_train_epochs", "1",
                         "--warmup_ratio", "0.5", "--save_steps", "1000", *extra])


def remat_step_launches(cfg, decode_steps: int) -> dict:
    """One bf16 `step_batch` under remat: phase 5's launches, and the loss's
    prompt forward (K1) and completion chunk (S1) once more a layer, rerun
    inside the backward."""
    layers = cfg.text.num_hidden_layers
    base = step_batch_tc_launches(cfg, decode_steps)
    return base | {"flash_attention": base["flash_attention"] + layers,
                   "shared_prefix_fwd": base["shared_prefix_fwd"] + layers}


def dir_bytes(path: str) -> int:
    """The bytes of the files directly in `path` (one checkpoint's)."""
    return sum(e.stat().st_size for e in os.scandir(path) if e.is_file())


def cli_hf_checkpoint(cfg, path: str) -> tuple:
    """(a): seeded weights through save_hf_checkpoint, with a config.json
    that from_hf_dict reads back as `cfg`, then load_checkpoint onto the
    card: bit-equal. Returns (bytes, write s, read s)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.models.qwen25vl.convert import config_to_hf_dict, load_checkpoint, save_hf_checkpoint

    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = save_hf_checkpoint(path, params, cfg)
    write_s = time.perf_counter() - t0
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf_dict(cfg), f)
    t0 = time.perf_counter()
    back, back_cfg = load_checkpoint(path)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if back_cfg != cfg:
        raise AssertionError("(a): config.json does not read back as the config written")
    if not trees_equal(back, params):
        raise AssertionError("(a): load_checkpoint of the HF checkpoint differs from the weights saved")
    return nbytes, write_s, read_s


def phase_cli_train(card: str) -> dict:
    """Phase 9: a GRPO run from the command line, after phase 8 freed its
    model. (a) Qwen2.5-VL-3B (bf16, seeded weights) through
    save_hf_checkpoint and load_checkpoint, bit-equal; (b) `cli.train.main`
    on that checkpoint with the CLI's defaults (remat "full"), one epoch of
    4 examples (4 step_batch calls, 2 updates, warmup half of them): every
    step's launches, the lr of each update against the schedule,
    trainer_state.json, the directories of the save cadence, and the final
    checkpoint reloaded bit-equal, then (e) remat off and on in turns on the
    same trainer (`remat_in_turns`); (c) at 3B widths and 2 decoder layers,
    a run saved with --save_only_model false and resumed (`cli_resume`);
    (d) the remat policies at that depth (`remat_parity`). Returns (b)'s
    launches, summed over the main() call."""
    import gc
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.rl import GRPOTrainer
    from time_r1_tpu_torch.utils.checkpoint import load_params

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="timer1_phase9_")
    free = shutil.disk_usage(root).free
    log(f"[cli] {root}: {free / 1e9:.1f} GB free; phase 9 writes up to {PHASE9_BYTES / 1e9:.0f} GB")
    if free < PHASE9_BYTES:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"phase 9 needs {PHASE9_BYTES / 1e9:.0f} GB under {root}, which has "
                             f"{free / 1e9:.1f} GB free: point TMPDIR at a larger disk")
    cfg = cut_depth(Qwen25VLConfig.qwen25vl_3b(), CLI_LAYERS)
    L = cfg.text.num_hidden_layers
    result = {"card": card}
    try:
        # (a) the HF loader
        hf = os.path.join(root, "hf")
        nbytes, write_s, read_s = cli_hf_checkpoint(cfg, hf)
        result["hf"] = dict(gb=nbytes / 1e9, write_s=write_s, read_s=read_s)
        log(f"[cli] (a) save_hf_checkpoint of the 3B: {nbytes / 1e9:.3f} GB in {write_s:.2f} s "
            f"({nbytes / 1e9 / write_s:.2f} GB/s); load_checkpoint onto the card {read_s:.2f} s "
            f"({nbytes / 1e9 / read_s:.2f} GB/s); bit-equal, config.json read back as written; {card}")
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the real entry point
        steps, saves, phases_seen = [], [], {}

        def timed_step(original):
            def step_batch(self, examples, requests=None):
                # phases since the last call returned: train()'s host_preproc_wait for this batch, then this call's
                phases0 = dict(phases_seen)
                before = read_launches()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = original(self, examples, requests=requests)
                torch.cuda.synchronize()
                after = read_launches()
                tm = self.engine.timings
                steps.append(dict(
                    step_s=time.perf_counter() - t0, loss=out["loss"],
                    launches={k: after[k] - before[k] for k in after}, decode_steps=tm["decode_steps"],
                    decode_ms_per_step=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1),
                    phases_ms={k: round((v - phases0.get(k, 0.0)) * 1e3, 1) for k, v in self.timers.totals.items()},
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30))
                phases_seen.update(self.timers.totals)
                return out
            return step_batch

        def timed_save(original):
            def save_checkpoint(self, path):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                original(self, path)
                saves.append(dict(dir=os.path.basename(path), gb=dir_bytes(path) / 1e9, s=time.perf_counter() - t0))
            return save_checkpoint

        out = os.path.join(root, "run")
        data = write_dataset(root, "train", 4)
        with cli_stand_ins(cfg) as cli, patched(GRPOTrainer, "step_batch", timed_step), \
                patched(GRPOTrainer, "save_checkpoint", timed_save), gc_timed([]) as gc_passes:
            args = cli_args(cli, hf, out, data)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            trainer = cli.main(args)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = read_launches()
        for i, st in enumerate(steps, start=1):
            log(f"[cli] (b) step_batch {i}: {st['step_s']:.2f} s, loss {st['loss']:.6f}; phases (ms, synced) "
                f"{st['phases_ms']}; decode {st['decode_ms_per_step']:.2f} ms/step over {st['decode_steps']} "
                f"steps; peak {st['peak_gib']:.2f} GiB allocated under remat; {card}")
            log(f"[cli] (b) step_batch {i}: launches {st['launches']}")
            check_step_launches(f"cli step_batch {i}", st["launches"], st["decode_steps"], L,
                                {"shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                                 "int4_matmul": 0, "fused_mlp_int8": 0})
            check_tc_route(f"cli step_batch {i}", st["launches"], remat_step_launches(cfg, st["decode_steps"]),
                           tensor_cores=True)
        for sv in saves:
            log(f"[cli] (b) save_checkpoint {sv['dir']}: {sv['gb']:.3f} GB in {sv['s']:.2f} s "
                f"({sv['gb'] / sv['s']:.2f} GB/s); {card}")
        want_lrs = [0.0, float(np.float32(args.learning_rate))]  # 2 updates; warmup int(2 * 0.5) = 1 of them
        ckpt_dirs = sorted(d for d in os.listdir(out) if d.startswith(("checkpoint-", "epoch-")))
        with open(os.path.join(out, "trainer_state.json")) as f:
            state = json.load(f)
        summary = trainer.timers.summary()
        wait = summary.get("host_preproc_wait", {})
        gc_ms = {g: round(sum(ms for gen, ms in gc_passes if gen == g), 1) for g in (0, 1, 2)}
        log(f"[cli] (b) Python's garbage collector during main(): {len(gc_passes)} passes, ms by generation "
            f"{gc_ms}")
        log(f"[cli] (b) main(): {main_s:.2f} s; {len(steps)} step_batch calls; lr per update "
            f"{trainer.optimizer.lrs} (want {want_lrs}); trainer_state {state}; checkpoint directories {ckpt_dirs}; "
            f"host_preproc_wait {wait} (phase 8's host_preproc: 110-145 ms a step); timers {summary}; {card}")
        if len(steps) != 4 or trainer.global_step != 4 or state != {"global_step": 4}:
            raise AssertionError(f"(b): {len(steps)} step_batch calls, global_step {trainer.global_step}, "
                                 f"trainer_state {state}; want 4")
        if trainer.optimizer.lrs != want_lrs or trainer.opt_state.count != 2:
            raise AssertionError(f"(b): lr per update {trainer.optimizer.lrs}, want {want_lrs}")
        if ckpt_dirs != ["epoch-1"] or [sv["dir"] for sv in saves] != ["epoch-1", "run"]:
            raise AssertionError(f"(b): checkpoints {ckpt_dirs}, saves {[sv['dir'] for sv in saves]}")
        if trainer.hp.gradient_checkpointing != "full" or not all(np.isfinite(st["loss"]) for st in steps):
            raise AssertionError("(b): remat is not the CLI's default, or a loss is not finite")
        if not trees_equal(load_params(out, device="cuda"), trainer.params):
            raise AssertionError("(b): the final checkpoint does not reload bit-equal to the trained weights")
        log("[cli] (b) the final checkpoint reloads bit-equal to the trained weights")
        for name in TRAIN_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"(b): {name} was not launched by main()")
        result["main"] = dict(main_s=main_s, steps=[{k: v for k, v in st.items() if k != "launches"} for st in steps],
                              saves=saves, host_preproc_wait=wait, lrs=trainer.optimizer.lrs, gc_ms=gc_ms)
        result["turns"] = remat_in_turns(trainer, cli.load_json_dataset_tg(data)[:1], card)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(hf, ignore_errors=True)

        result["resume"] = cli_resume(root, card)
        result["remat"] = remat_parity(card)
        log(f"[cli] summary on {card}: {json.dumps(result)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def remat_in_turns(trainer, examples, card: str) -> list:
    """(e) Remat's cost at full size, in one process: four more step_batch
    calls of (b)'s trainer with remat off, "full", "full", off (so that each
    setting takes one accumulating call and one that updates), with the
    train step rebuilt for each (a harness patch: the trainer keeps its
    policy for its life); train_step ms, the peak, and Python's garbage
    collector's ms in each."""
    import torch

    from time_r1_tpu_torch.rl.grpo import make_train_step
    from time_r1_tpu_torch.utils.profiling import PhaseTimers

    out = []
    for remat in (False, "full", "full", False):
        trainer.hp = replace(trainer.hp, gradient_checkpointing=remat)
        trainer._train_step = make_train_step(trainer.cfg, trainer.hp, trainer.optimizer)
        trainer.timers = PhaseTimers(sync=True)
        updates = trainer.opt_state.count
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with gc_timed([]) as passes:
            t0 = time.perf_counter()
            trainer.step_batch(examples)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        row = dict(remat=remat, update=trainer.opt_state.count > updates, step_s=step_s,
                   train_step_ms=trainer.timers.summary()["train_step"]["total_s"] * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, gc_ms=sum(ms for _, ms in passes))
        out.append(row)
        log(f"[cli] (e) remat {remat}: {row}; {card}")
    return out


def cli_resume(root: str, card: str) -> dict:
    """(c) at 3B widths and 2 decoder layers: a run of 3 examples saved with
    --save_only_model false (its accumulation window left open), then main()
    from that native checkpoint with --resume_from_checkpoint: the params,
    the optimizer state (moments, accumulation, counts) and global_step
    restored bit-equal before train() runs, and the run stopped at resumed +
    3 micro-steps."""
    import torch

    from time_r1_tpu_torch.rl import GRPOTrainer

    cfg = reduced_config()
    hf = os.path.join(root, "hf_2l")
    cli_hf_checkpoint(cfg, hf)
    data = write_dataset(root, "resume", 3)
    first_out, second_out = os.path.join(root, "first"), os.path.join(root, "second")
    held, restored = {}, {}

    def checked_restore(original):
        def load_checkpoint_state(self, path):
            original(self, path)
            restored.update(params=trees_equal(self.params, held["params"]),
                            opt=trees_equal(self.opt_state.tree(), held["opt"]), global_step=self.global_step)
        return load_checkpoint_state

    with cli_stand_ins(cfg) as cli:
        first = cli.main(cli_args(cli, hf, first_out, data, "--save_only_model", "false"))
        held.update(params=first.params, opt=first.opt_state.tree())
        with patched(GRPOTrainer, "load_checkpoint_state", checked_restore):
            t0 = time.perf_counter()
            second = cli.main(cli_args(cli, first_out, second_out, data, "--resume_from_checkpoint", first_out))
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t0
    out = dict(first=dict(global_step=first.global_step, updates=first.opt_state.count,
                          mini_step=first.opt_state.mini_step),
               restored=restored, final_step=second.global_step, updates=second.opt_state.count,
               resumed_main_s=resumed_s)
    log(f"[cli] (c) resumed from the first run's final checkpoint: {out}; {card}")
    if restored != {"params": True, "opt": True, "global_step": 3} or first.opt_state.mini_step != 1:
        raise AssertionError(f"(c): the state was not restored bit-equal: {restored}")
    if second.global_step != 6 or second.opt_state.count != 3:
        raise AssertionError(f"(c): the resumed run stopped at {second.global_step} after "
                             f"{second.opt_state.count} updates, want 6 and 3")
    return out


def remat_parity(card: str) -> dict:
    """(d) at 3B widths and 2 decoder layers, bf16 on the tensor cores: phase
    3b's split batch (4 fixed completions, fixed advantages, a reference
    copy) through grpo_loss and its gradients under each remat policy, each
    against no remat within phase 3b's tolerance (bit-equal expected: the
    kernels and cuBLAS are deterministic); K1 and S1 rerun once a layer
    under remat; the bytes the forward leaves allocated for the backward,
    and the peak above them."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_split_batch, grpo_loss
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps, precompute_frozen_vision, trainable_leaves

    cfg = reduced_config()
    L = cfg.text.num_hidden_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"), scale=0.98)
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    rng = np.random.default_rng(2)
    comps = [rng.integers(0, 151000, n).tolist() + ([cfg.eos_token_id] if i % 2 == 0 else [])
             for i, n in enumerate((20, 57, 101, 127))]
    group = {"prompt_ids": req.input_ids, "completions": comps,
             "advantages": np.array([1.0, -0.5, 0.25, -0.75], np.float32),
             "patches": req.patches, "grid_thw": req.grid_thw, "second_per_grid_t": 1.0}
    batch = build_grpo_split_batch(cfg, [group], dtype=torch.bfloat16, device=torch.device("cuda"))
    batch = precompute_frozen_vision(params, cfg, batch)
    batch = batch._replace(ref_logps=compute_ref_logps(ref, cfg, GRPOHyperParams(num_generations=4), batch))
    leaves = trainable_leaves(params, True)
    for p in leaves:
        p.requires_grad_(True)
    out, want = {}, None
    for remat in (False, "full", "dots", "dots_small"):
        hp = GRPOHyperParams(num_generations=4, beta=0.04, gradient_checkpointing=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        reset_launches()
        loss, _ = grpo_loss(params, cfg, hp, batch)
        residual = torch.cuda.memory_allocated() - m0
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        torch.cuda.synchronize()
        rerun = L if remat else 0
        check_tc_route(f"remat {remat}", read_launches(),
                       {"flash_attention": L + rerun, "shared_prefix_fwd": L + rerun, "flash_bwd_dq": L,
                        "flash_bwd_dkv": 2 * L, "shared_prefix_bwd": L, "shared_prefix_bwd_dkv": L},
                       tensor_cores=True)
        row = dict(loss=loss.detach().item(), residual_mib=residual / 2**20,
                   peak_above_mib=(torch.cuda.max_memory_allocated() - m0) / 2**20)
        if want is None:
            want = (row["loss"], grads)
        else:
            worst, same = 0.0, 0
            for g, w in zip(grads, want[1]):
                scale = w.float().abs().max().item()
                worst = max(worst, (g.float() - w.float()).abs().max().item() / scale if scale > 0 else 0.0)
                same += int(torch.equal(g, w))
            row.update(loss_err=abs(row["loss"] - want[0]) / max(abs(want[0]), 1e-30), worst_grad=worst,
                       bit_equal_leaves=f"{same}/{len(grads)}")
            if not (row["loss_err"] <= TRAIN_TOL and worst <= TRAIN_TOL):
                raise AssertionError(f"(d) remat {remat}: loss {row['loss_err']:.3e}, worst gradient leaf "
                                     f"{worst:.3e} against no remat (tol {TRAIN_TOL})")
        out[str(remat)] = row
        log(f"[cli] (d) remat {remat}: {row}; {card}")
    return out


# ---------------------------------------------------------------------------
# phases 3f and 10: the evaluation entry point and the TimeRFT sample-filtering loop
EVAL_PIXELS = (256 * 28 * 28, 16 * 28 * 28)  # phase 3f's total and min pixels: 8 frames at 168x308, 264 video tokens
PHASE10_BYTES = 32e9  # what phase 10 (a) writes at its peak (four 3B checkpoints of 7.5 GB), with room


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def native_checkpoint(path: str, params, cfg) -> int:
    """A checkpoint in the port's native format (what its trainer writes);
    returns the bytes written."""
    from time_r1_tpu_torch.models.qwen25vl.convert import NATIVE_CONFIG, config_to_plain_dict
    from time_r1_tpu_torch.utils.checkpoint import save_params

    nbytes = save_params(path, params)
    with open(os.path.join(path, NATIVE_CONFIG), "w") as f:
        json.dump(config_to_plain_dict(cfg), f)
    return nbytes


def phase_reduced_eval() -> dict:
    """Phase 3f: `cli.evaluate.main` at reduced depth (3B widths, 2 decoder
    layers, 2 ViT blocks), f32, on the card and on the CPU from one native
    checkpoint the port wrote (the engine built by the harness in f32; the
    CLI's own load is bf16), over two items of CLI_CLIP at a small pixel
    budget, through Engine, PagedEngine (--use_continuous_batching, two
    slots) and ContinuousEngine (--kv_block_size 0). The jsonl records must
    be equal, card against CPU (greedy output_text, pred, target, qid),
    and the three engines' records equal to each other; on the card f32
    runs K1-K3 (and P1) on their FMA kernels only."""
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.cli import evaluate
    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.models.qwen25vl.convert import load_checkpoint
    from time_r1_tpu_torch.sampler import Engine

    cfg = reduced_config()
    root = tempfile.mkdtemp(prefix="timer1_phase3f_")
    modes = {
        "Engine": ([], None),
        "PagedEngine": (["--use_continuous_batching", "--batch_size", "2", "--max_model_len", "2048"],
                        "paged_prefix_attention"),
        "ContinuousEngine": (["--use_continuous_batching", "--batch_size", "2", "--max_model_len", "2048",
                              "--kv_block_size", "0"], None),
    }
    out = {}
    try:
        ckpt = os.path.join(root, "ckpt")
        native_checkpoint(ckpt, reduced_params_cpu(), cfg)
        data = write_dataset(root, "eval", 2)
        with cli_stand_ins(cfg):
            for mode, (flags, paged) in modes.items():
                recs = {}
                for dev in ("cuda", "cpu"):
                    params, _ = load_checkpoint(ckpt, dtype=torch.float32, device=dev)
                    eng = Engine(params, cfg, dtype=torch.float32, device=dev)
                    args = evaluate.get_args([
                        "--model_base", ckpt, "--datasets", "tvgbench_filter", "--split", data,
                        "--output_dir", os.path.join(root, f"{mode}_{dev}"), "--use_r1_thinking_prompt",
                        "--max_new_tokens", "8", "--total_pixels", str(EVAL_PIXELS[0]),
                        "--min_pixels", str(EVAL_PIXELS[1]), "--num_workers", "0", *flags])
                    reset_launches()
                    t0 = time.perf_counter()
                    recs[dev] = read_jsonl(evaluate.main(args, eng, Qwen25VLProcessor.from_pretrained(ckpt),
                                                         device=dev))
                    log(f"[eval-reduced] {mode} {dev}: {time.perf_counter() - t0:.1f} s, launches "
                        f"{ {k: v for k, v in read_launches().items() if v} }")
                    if dev == "cuda":
                        want = {n: None for n in FWD_TC} | ({paged: None} if paged else {})
                        check_tc_route(f"eval-reduced {mode}", read_launches(), want, tensor_cores=False)
                log(f"[eval-reduced] {mode}: {[(r['qid'], r['output_text'][-24:], r['pred']) for r in recs['cuda']]}")
                if recs["cuda"] != recs["cpu"] or [r["qid"] for r in recs["cuda"]] != ["eval_0", "eval_1"]:
                    raise AssertionError(f"3f {mode}: the records differ, card {recs['cuda']} cpu {recs['cpu']}")
                out[mode] = recs["cuda"]
        if not out["Engine"] == out["PagedEngine"] == out["ContinuousEngine"]:
            raise AssertionError(f"3f: the engines' records differ: {out}")
        log("[eval-reduced] evaluate.main: card == cpu for Engine, PagedEngine and ContinuousEngine, "
            "and the three engines agree")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def stage_timed(stages: dict, key: str, fn):
    """fn with its wall seconds (synced) added to stages[key]."""
    import torch

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.synchronize()
            stages[key] = stages.get(key, 0.0) + time.perf_counter() - t0
    return timed


def eval_item_launches(cfg, prompt_len: int, chunk: int) -> dict:
    """The tensor-core launches of one eval item through Engine (G = 1): K2
    and K3 in its vision tower, K1 once a layer for each prefill chunk of its
    bucket; the G = 1 decode runs none of the port's kernels."""
    from time_r1_tpu_torch.sampler.engine import _bucket

    return vision_tc_launches(cfg) | {"flash_attention": cfg.text.num_hidden_layers * -(-_bucket(prompt_len) // chunk)}


def phase_sf_round(card: str) -> dict:
    """Phase 10: the TimeRFT sample-filtering loop through
    `cli.train_sf.main`, after phase 9 freed its model.
    (a) one round at Qwen2.5-VL-3B's full width and depth (bf16, seeded
    weights) from a native base checkpoint, the recipe's "0070_all", 4
    examples of CLI_CLIP: train (cli.train's defaults, remat "full", one
    early-stopped epoch: 4 step_batch calls), the round's smallest
    checkpoint, its self-eval on the round's data (cli.evaluate through
    Engine, 4 items, 128 greedy tokens), the difficulty merge and the
    filter. Wall seconds per stage, the eval's vision and prefill ms,
    decode ms/step and items/s, checkpoint load GB/s and the peak; exact
    tensor-core launches per step_batch (phase 9's) and per eval item (K2
    28, K3 4, K1 36 a prefill chunk), which must sum to the round's.
    (b) two rounds at 3B widths with 2 decoder layers and "random_sample":
    round 1 trains from round 0's smallest checkpoint on round 0's filtered
    json. Writes up to 32 GB under TMPDIR, refuses to start with less free,
    and deletes it all at the end. Returns (a)'s launches over the round."""
    import gc
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.cli import calc_difficulty, evaluate, train_sf
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer
    from time_r1_tpu_torch.sampler import TextEngine
    from time_r1_tpu_torch.sampler.engine import PREFILL_CHUNK  # evaluate's Engine prefills in chunks of this

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="timer1_phase10_")
    free = shutil.disk_usage(root).free
    log(f"[sf] {root}: {free / 1e9:.1f} GB free; phase 10 writes up to {PHASE10_BYTES / 1e9:.0f} GB")
    if free < PHASE10_BYTES:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"phase 10 needs {PHASE10_BYTES / 1e9:.0f} GB under {root}, which has "
                             f"{free / 1e9:.1f} GB free: point TMPDIR at a larger disk")
    cfg = cut_depth(Qwen25VLConfig.qwen25vl_3b(), CLI_LAYERS)
    L = cfg.text.num_hidden_layers
    result = {"card": card}
    try:
        base = os.path.join(root, "base")
        t0 = time.perf_counter()
        nbytes = native_checkpoint(base, init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16), cfg)
        log(f"[sf] (a) the 3B native base: {nbytes / 1e9:.3f} GB written in {time.perf_counter() - t0:.2f} s")
        gc.collect()
        torch.cuda.empty_cache()
        data = write_dataset(root, "train", 4)
        exp = os.path.join(root, "exp")
        stages, steps, items, loads = {}, [], [], []

        def timed_step(original):
            def step_batch(self, examples, requests=None):
                before = read_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = original(self, examples, requests=requests)
                torch.cuda.synchronize()
                after = read_launches()
                steps.append(dict(launches={k: after[k] - before[k] for k in after}, s=time.perf_counter() - t0,
                                  decode_steps=self.engine.timings["decode_steps"], loss=out["loss"]))
                return out
            return step_batch

        class ItemTimed(TextEngine):
            """evaluate's TextEngine, each generate (one item: batch size 1) with its launches and timings."""

            def generate(self, requests, **kw):
                before = read_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                texts = super().generate(requests, **kw)
                torch.cuda.synchronize()
                after = read_launches()
                tm = self.engine.timings
                items.append(dict(launches={k: after[k] - before[k] for k in after}, s=time.perf_counter() - t0,
                                  prompt_len=len(requests[0].input_ids), vision_ms=tm["vision_s"] * 1e3,
                                  prefill_ms=tm["prefill_s"] * 1e3, decode_steps=tm["decode_steps"],
                                  decode_ms_per_step=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1)))
                return texts

        def timed_load(fn):
            def load_checkpoint(path, *a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(path, *a, **kw)
                torch.cuda.synchronize()
                loads.append(dict(dir=os.path.basename(path), gb=dir_bytes(path) / 1e9, s=time.perf_counter() - t0))
                return out
            return load_checkpoint

        sf_args = train_sf.get_args(["--model_name_or_path", base, "--exp_dir", exp, "--initial_data", data,
                                     "--rounds", "1", "--k", "4", "--reward_funcs", "iou_v2", "format", "char_parity"])
        def timed(key):
            return lambda f: stage_timed(stages, key, f)

        with cli_stand_ins(cfg) as cli, patched(GRPOTrainer, "step_batch", timed_step), \
                patched(GRPOTrainer, "save_checkpoint", timed("save")), patched(cli, "main", timed("train")), \
                patched(cli, "load_checkpoint", timed_load), patched(evaluate, "load_checkpoint", timed_load), \
                patched(evaluate, "main", timed("evaluate")), patched(evaluate, "TextEngine", lambda _: ItemTimed), \
                patched(calc_difficulty, "merge", timed("merge")), patched(train_sf, "process_data_file", timed("filter")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            filtered = train_sf.main(sf_args)
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t0
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        stages["train"] -= stages["save"]  # train() saves inside cli.train.main: apart here
        log(f"[sf] (a) train_sf.main, one round: {round_s:.2f} s; stages (s) "
            f"{ {k: round(v, 2) for k, v in stages.items()} }; peak {peak:.2f} GiB allocated; {card}")
        for ld in loads:
            log(f"[sf] (a) load_checkpoint {ld['dir']}: {ld['gb']:.3f} GB in {ld['s']:.2f} s "
                f"({ld['gb'] / ld['s']:.2f} GB/s); {card}")
        for i, st in enumerate(steps, start=1):
            log(f"[sf] (a) step_batch {i}: {st['s']:.2f} s, loss {st['loss']:.6f}, {st['decode_steps']} decode steps, "
                f"launches { {k: v for k, v in st['launches'].items() if v} }; {card}")
            check_step_launches(f"sf step_batch {i}", st["launches"], st["decode_steps"], L,
                                {"shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                                 "int4_matmul": 0, "fused_mlp_int8": 0})
            check_tc_route(f"sf step_batch {i}", st["launches"], remat_step_launches(cfg, st["decode_steps"]),
                           tensor_cores=True)
        for i, it in enumerate(items, start=1):
            log(f"[sf] (a) eval item {i}: {it['prompt_len']} prompt tokens, vision {it['vision_ms']:.1f} ms, prefill "
                f"{it['prefill_ms']:.1f} ms, decode {it['decode_ms_per_step']:.2f} ms/step over {it['decode_steps']} "
                f"steps, {it['s']:.2f} s; launches { {k: v for k, v in it['launches'].items() if v} }; {card}")
            want = eval_item_launches(cfg, it["prompt_len"], PREFILL_CHUNK)
            check_tc_route(f"sf eval item {i}", it["launches"], want, tensor_cores=True)
            others = {k: v for k, v in it["launches"].items() if v and k.removesuffix("_tc") not in want}
            if others:
                raise AssertionError(f"sf eval item {i}: kernels beyond K1-K3 launched: {others}")
        summed = {k: sum(x["launches"][k] for x in steps + items) for k in launches}
        if summed != launches:
            raise AssertionError(f"(a): the round's launches {launches} are not its steps' and items' {summed}")
        round_dir = os.path.join(exp, "round_0")
        ckpt = train_sf.smallest_checkpoint(round_dir)
        eval_dir = os.path.join(round_dir, "filtering_epoch0")
        recs = read_jsonl(os.path.join(eval_dir, "tg_0_1.jsonl"))
        with open(os.path.join(eval_dir, "train_v4_cloud.json")) as f:  # merge's path joins an absolute eval_dir
            merged = json.load(f)
        with open(filtered) as f:
            kept = json.load(f)
        saved = sorted(d for d in os.listdir(round_dir) if d.startswith(("checkpoint-", "epoch-")))
        log(f"[sf] (a) checkpoints {saved}, the smallest {os.path.basename(ckpt)}; records {[(r['qid'], r['pred']) for r in recs]}; difficulties "
            f"{[d['difficulty'] for d in merged]}; {len(kept)} kept by 0070_all in {os.path.basename(filtered)}")
        if len(steps) != 4 or os.path.basename(ckpt) != "checkpoint-4" or len(items) != 4:
            raise AssertionError(f"(a): {len(steps)} step_batch calls, checkpoint {ckpt}, {len(items)} eval items")
        if [r["qid"] for r in recs] != [f"train_{i}" for i in range(4)] or \
                not all(isinstance(r["pred"], list) and len(r["pred"]) == 2 for r in recs):
            raise AssertionError(f"(a): self-eval records {recs}")
        if [d["qid"] for d in merged] != [r["qid"] for r in recs] or \
                not all(np.isfinite(d["difficulty"]) and 0 <= d["difficulty"] <= 100 for d in merged):
            raise AssertionError(f"(a): merged annotations {merged}")
        if not filtered.endswith("train_v4_cloud_0070_all.json") or \
                sorted(d["qid"] for d in kept) != sorted(d["qid"] for d in merged if 0 < d["difficulty"] <= 70):
            raise AssertionError(f"(a): the filter kept {kept}")
        if not all(np.isfinite(st["loss"]) for st in steps):
            raise AssertionError("(a): a loss is not finite")
        for name in TRAIN_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"(a): {name} was not launched by train_sf.main")
        n_eval = len(items)
        result["round"] = dict(round_s=round_s, stages=stages, peak_gib=peak, loads=loads,
                               step_s=[st["s"] for st in steps], items=[
            {k: v for k, v in it.items() if k != "launches"} for it in items],
            items_per_s=n_eval / stages["evaluate"])
        log(f"[sf] (a) evaluate: {n_eval} items in {stages['evaluate']:.2f} s ({n_eval / stages['evaluate']:.3f} "
            f"items/s, the checkpoint's load included); {card}")
        shutil.rmtree(exp, ignore_errors=True)
        shutil.rmtree(base, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        result["handoff"] = sf_handoff(root, card)
        log(f"[sf] summary on {card}: {json.dumps(result)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def sf_handoff(root: str, card: str) -> dict:
    """(b) two SF rounds at 3B widths with 2 decoder layers (2 ViT blocks),
    bf16, "random_sample", 2 examples: round 1 must train from round 0's
    smallest checkpoint on round 0's filtered json, which carries the
    difficulty and pred of round 0's self-eval (a spy on cli.train.get_args)."""
    import torch

    from time_r1_tpu_torch.cli import train_sf
    from time_r1_tpu_torch.models.qwen25vl import init_params

    cfg = reduced_config()
    base = os.path.join(root, "base_2l")
    native_checkpoint(base, init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16), cfg)
    data = write_dataset(root, "handoff", 2)
    exp = os.path.join(root, "exp_2l")
    consumed = []
    def spied(real):
        def get_args(argv=None):
            args = real(argv)
            consumed.append((args.train_data_path, args.model_name_or_path))
            return args
        return get_args

    with cli_stand_ins(cfg) as cli:
        with patched(cli, "get_args", spied):
            t0 = time.perf_counter()
            last = train_sf.main(train_sf.get_args([
                "--model_name_or_path", base, "--exp_dir", exp, "--initial_data", data, "--rounds", "2", "--k", "2",
                "--filter_task", "random_sample", "--eval_max_new_tokens", "16",
                "--reward_funcs", "iou_v2", "format", "char_parity"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    r0 = os.path.join(exp, "round_0")
    ckpt0 = train_sf.smallest_checkpoint(r0)
    with open(consumed[1][0]) as f:
        data1 = json.load(f)
    log(f"[sf] (b) two rounds at 2 layers: {wall:.2f} s; train got {consumed}; round 1's data "
        f"{[(d['qid'], d['difficulty']) for d in data1]}; last filtered {os.path.basename(last)}; {card}")
    if consumed[0] != (data, base) or consumed[1][1] != ckpt0 or not consumed[1][0].endswith("_random.json"):
        raise AssertionError(f"(b): the rounds trained from {consumed}; round 0's smallest checkpoint is {ckpt0}")
    if sorted(d["qid"] for d in data1) != ["handoff_0", "handoff_1"] or \
            not all("difficulty" in d and "pred" in d for d in data1):
        raise AssertionError(f"(b): round 1's data {data1}")
    if not any(f.endswith(".jsonl") for f in os.listdir(os.path.join(exp, "round_1", "filtering_epoch1"))):
        raise AssertionError("(b): round 1 left no self-eval")
    return dict(wall_s=wall, consumed=consumed)


# ---------------------------------------------------------------------------
# phase 11: LoRA GRPO on the 7B over an int8 base
PHASE11_BYTES = 40e9  # the 7B's HF checkpoint (16.6 GB) and two int8-base saves (~9 GB each), with room
# the JAX package's single-chip 7B recipe (README's "7B on one chip", scripts/posttrain/train_rl.sh's flags)
LORA_7B_FLAGS = ("--use_peft", "true", "--lora_r", "16", "--lora_alpha", "32", "--train_base_quantization", "int8",
                 "--rollout_quantization", "int8", "--gradient_checkpointing", "true", "--fix_vit", "true",
                 "--num_generations", "8", "--max_completion_length", "200", "--gradient_accumulation_steps", "2",
                 "--reward_funcs", "iou_v2", "format", "char_parity")


def base_hash(params) -> str:
    """sha256 of three leaves of an int8 fused base: the first layer's qkv
    values, the middle layer's gu scales, the last layer's down values."""
    import hashlib

    import torch

    layers = params["text"]["layers"]
    h = hashlib.sha256()
    for t in (layers[0]["qkv"]["q8"], layers[len(layers) // 2]["gu"]["s"], layers[-1]["down_w"]["q8"]):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def phase_lora_7b(card: str) -> dict:
    """Phase 11, once phase 10's model is freed. (a) Qwen2.5-VL-7B (seeded
    bf16 weights through save_hf_checkpoint) trained by `cli.train.main` with
    LORA_7B_FLAGS on 2 examples of phase 8's 4 s clip: the base quantized
    into the int8 fused layout one layer at a time (its seconds and the peaks
    around it), 2 step_batch calls (one update) whose rollouts run over that
    tree with side adapters: each call's launches against
    `remat_step_launches` at 28 layers (D2 a layer a decode step, Q2 none),
    all on the tensor cores; the base bit-unchanged (`base_hash`); an
    adapter B moved off 0; the weight sync an adapter install (under 50 ms
    from the second call on, Python's garbage-collector passes inside it
    left out and reported);
    the saves holding the int8 base and `lora_adapters.npz`, reloaded equal.
    (b) `lora_route_b`, (c) `lora_resume`. Returns (a)'s launches, summed
    over the main() call. Deletes what it wrote."""
    import gc
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.models.qwen25vl.convert import (
        LORA_FILE,
        config_to_hf_dict,
        load_lora_npz,
        lora_from_jax,
        save_hf_checkpoint,
    )
    from time_r1_tpu_torch.rl import GRPOTrainer
    from time_r1_tpu_torch.rl.lora import lora_leaves
    from time_r1_tpu_torch.utils.checkpoint import load_params

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="timer1_phase11_")
    free = shutil.disk_usage(root).free
    log(f"[lora] {root}: {free / 1e9:.1f} GB free; phase 11 writes up to {PHASE11_BYTES / 1e9:.0f} GB")
    if free < PHASE11_BYTES:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"phase 11 needs {PHASE11_BYTES / 1e9:.0f} GB under {root}, which has "
                             f"{free / 1e9:.1f} GB free: point TMPDIR at a larger disk")
    cfg = cut_depth(Qwen25VLConfig.qwen25vl_7b(), LORA_7B_LAYERS)
    L = cfg.text.num_hidden_layers
    result = {"card": card}
    try:
        t_phase = time.perf_counter()
        hf = os.path.join(root, "hf")
        params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = save_hf_checkpoint(hf, params, cfg)
        with open(os.path.join(hf, "config.json"), "w") as f:
            json.dump(config_to_hf_dict(cfg), f)
        result["hf"] = dict(gb=nbytes / 1e9, write_s=time.perf_counter() - t0)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[lora] (a) the 7B's seeded HF checkpoint: {nbytes / 1e9:.3f} GB in {result['hf']['write_s']:.2f} s")

        steps, saves, quant, hashes = [], [], {}, {}

        def timed_quant(original):
            def quantize_base_in_place(params, bits=8):
                torch.cuda.synchronize()
                quant["before_gib"] = torch.cuda.memory_allocated() / 2**30
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = original(params, bits=bits)
                torch.cuda.synchronize()
                quant.update(s=time.perf_counter() - t0, after_gib=torch.cuda.memory_allocated() / 2**30,
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                hashes["before"] = base_hash(out)
                return out
            return quantize_base_in_place

        def timed_step(original):
            def step_batch(self, examples, requests=None):
                before = read_launches()
                timers0 = dict(self.timers.totals)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = original(self, examples, requests=requests)
                torch.cuda.synchronize()
                after = read_launches()
                tm = self.engine.timings
                steps.append(dict(
                    step_s=time.perf_counter() - t0, loss=out["loss"],
                    launches={k: after[k] - before[k] for k in after}, decode_steps=tm["decode_steps"],
                    decode_ms_per_step=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1),
                    phases_ms={k: round((v - timers0.get(k, 0.0)) * 1e3, 1) for k, v in self.timers.totals.items()},
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    side_adapters=self.engine.lora_side is not None, shares_base=self.engine.params is self.params))
                return out
            return step_batch

        def timed_save(original):
            def save_checkpoint(self, path):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                original(self, path)
                saves.append(dict(dir=os.path.basename(path), gb=dir_bytes(path) / 1e9, s=time.perf_counter() - t0,
                                  lora_npz=os.path.exists(os.path.join(path, LORA_FILE))))
            return save_checkpoint

        syncs = []

        def timed_sync(original):
            def _sync_engine(self):
                torch.cuda.synchronize()
                with gc_timed([]) as passes:
                    t0 = time.perf_counter()
                    original(self)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                syncs.append(dict(ms=ms, gc_ms=sum(p for _, p in passes)))
            return _sync_engine

        out = os.path.join(root, "run")
        data = write_dataset(root, "train", 2)
        with cli_stand_ins(cfg) as cli, patched(cli, "quantize_base_in_place", timed_quant), \
                patched(GRPOTrainer, "step_batch", timed_step), patched(GRPOTrainer, "save_checkpoint", timed_save), \
                patched(GRPOTrainer, "_sync_engine", timed_sync):
            args = cli_args(cli, hf, out, data, *LORA_7B_FLAGS)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            trainer = cli.main(args)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = read_launches()
        hashes["after"] = base_hash(trainer.params)
        log(f"[lora] (a) quantize_base_in_place: {quant['s']:.2f} s; allocated {quant['before_gib']:.2f} GiB before "
            f"(the bf16 7B), {quant['after_gib']:.2f} GiB after (the int8 base), peak {quant['peak_gib']:.2f} GiB "
            f"during; {card}")
        for i, st in enumerate(steps, start=1):
            log(f"[lora] (a) step_batch {i}: {st['step_s']:.2f} s, loss {st['loss']:.6f}; phases (ms, synced) "
                f"{st['phases_ms']}; rollout decode {st['decode_ms_per_step']:.2f} ms/step over "
                f"{st['decode_steps']} steps; peak {st['peak_gib']:.2f} GiB allocated; {card}")
            log(f"[lora] (a) step_batch {i}: launches {st['launches']}")
            check_step_launches(f"lora step_batch {i}", st["launches"], st["decode_steps"], L,
                                {"shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                                 "int4_matmul": 0, "fused_mlp_int8": 0})
            check_tc_route(f"lora step_batch {i}", st["launches"], remat_step_launches(cfg, st["decode_steps"]),
                           tensor_cores=True)
            # the install's own time: the sync's wall time less Python's garbage-collector passes inside it (a
            # pass over the whole process's objects, up to ~80 ms in the whole script); from the second step
            # on, when the install is a copy into the engine's adapters (the first allocates them)
            sync = syncs[i - 1]
            install_ms = sync["ms"] - sync["gc_ms"]
            st.update(install_ms=install_ms, install_gc_ms=sync["gc_ms"])
            log(f"[lora] (a) step_batch {i}: the weight sync {sync['ms']:.1f} ms, of which garbage collection "
                f"{sync['gc_ms']:.1f} ms: the adapter install {install_ms:.1f} ms")
            if (i > 1 and install_ms >= 50.0) or not (st["side_adapters"] and st["shares_base"]):
                raise AssertionError(f"(a) step_batch {i}: adapter install {install_ms:.1f} ms, side adapters "
                                     f"{st['side_adapters']}, the engine shares the base {st['shares_base']}: "
                                     "want an adapter install under 50 ms over the base")
        for sv in saves:
            log(f"[lora] (a) save_checkpoint {sv['dir']}: {sv['gb']:.3f} GB in {sv['s']:.2f} s "
                f"({sv['gb'] / sv['s']:.2f} GB/s), {LORA_FILE} beside it: {sv['lora_npz']}; {card}")
        moved = sum(int(b.detach().abs().max().item() > 0) for b in lora_leaves(trainer.lora)[1::2])
        n_b = len(lora_leaves(trainer.lora)) // 2
        log(f"[lora] (a) main(): {main_s:.2f} s; base hash before {hashes['before'][:16]}, after "
            f"{hashes['after'][:16]}; {moved} of {n_b} adapter B matrices moved off 0; "
            f"{sum(t.numel() for t in lora_leaves(trainer.lora)) / 1e6:.1f} M adapter parameters; lr per update "
            f"{trainer.optimizer.lrs}; {card}")
        if len(steps) != 2 or trainer.global_step != 2 or trainer.opt_state.count != 1:
            raise AssertionError(f"(a): {len(steps)} step_batch calls, global_step {trainer.global_step}, "
                                 f"{trainer.opt_state.count} updates; want 2, 2, 1")
        if hashes["before"] != hashes["after"] or moved == 0 or trainer.ref_params is not trainer.params:
            raise AssertionError("(a): the base changed, no adapter moved, or the reference is not the base")
        if [sv["dir"] for sv in saves] != ["epoch-1", "run"] or not all(sv["lora_npz"] for sv in saves):
            raise AssertionError(f"(a): saves {saves}")
        if not trees_equal(load_params(out, device="cuda"), trainer.params):
            raise AssertionError("(a): the final checkpoint does not reload bit-equal to the int8 base")
        back = lora_from_jax(load_lora_npz(os.path.join(out, LORA_FILE)), cfg, device="cuda")
        if not trees_equal(back, {k: v for k, v in trainer.lora.items()}):
            raise AssertionError(f"(a): {LORA_FILE} does not load back equal to the trained adapters")
        log(f"[lora] (a) the final checkpoint reloads bit-equal: the int8 base, and the adapters from {LORA_FILE}")
        for name in TRAIN_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"(a): {name} was not launched by main()")
        result["main"] = dict(main_s=main_s, quantize=quant, steps=[{k: v for k, v in st.items() if k != "launches"}
                                                                   for st in steps], saves=saves,
                              adapter_params_m=sum(t.numel() for t in lora_leaves(trainer.lora)) / 1e6,
                              timers=trainer.timers.summary())
        del trainer, back
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(hf, ignore_errors=True)
        result["route_b"] = lora_route_b(card)
        result["resume"] = lora_resume(card)
        result["phase_s"] = time.perf_counter() - t_phase
        log(f"[lora] summary on {card}: {json.dumps(result)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def lora_route_b(card: str) -> dict:
    """(b) at 3B widths and 2 decoder layers: a bf16 base, use_peft and int8
    rollouts. One step_batch: its weight sync merges and quantizes one layer
    at a time (`rl/lora.py::merge_quantize`), bit-equal to quantizing the
    merged tree; the rollout runs Q2 on that int8 tree (a layer a decode
    step) and D2 over int8 caches."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.ops.quant import quantize_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.rl.lora import lora_leaves, merge_lora
    from time_r1_tpu_torch.utils.profiling import PhaseTimers

    cfg = reduced_config()
    L = cfg.text.num_hidden_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    config = TrainConfig(use_peft=True, lora_r=16, lora_alpha=32.0, rollout_quantization="int8", num_generations=8,
                         max_completion_length=64, gradient_accumulation_steps=1, gradient_checkpointing=True,
                         report_to="none", learning_rate=1e-4)
    tr = GRPOTrainer(params, cfg, IdsProcessor(), [token_parity_reward], config=config, device="cuda")
    tr.timers = PhaseTimers(sync=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    with torch.no_grad():
        for b in lora_leaves(tr.lora)[1::2]:
            b.copy_(torch.randn(b.shape, generator=gen, device="cuda") * 0.02)
        want = quantize_params(merge_lora(params, tr.lora, tr.lora_cfg), bits=8)
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    reset_launches()
    info = tr.step_batch([{"problem": "a door opens", "solution": (1.0, 2.0)}], [req])
    torch.cuda.synchronize()
    launches, steps = read_launches(), tr.engine.timings["decode_steps"]
    same = trees_equal(tr.engine.params, want)
    out = dict(loss=info["loss"], weight_sync_ms=tr.timers.summary()["weight_sync"]["total_s"] * 1e3,
               decode_steps=steps, fused_mlp_int8=launches["fused_mlp_int8"], merged_int8_bit_equal=same)
    log(f"[lora] (b) bf16 base, int8 rollouts: {out}; {card}")
    check_step_launches("lora route (b)", launches, steps, L, {"fused_mlp_int8": 1, "shared_prefix_decode_full": 1})
    if not same:
        raise AssertionError("(b): the engine's int8 tree differs from quantize_params(merge_lora(...))")
    return out


def lora_resume(card: str) -> dict:
    """(c) at 3B widths and 2 decoder layers over an int8 fused base (the 7B
    layout), LoRA with the optimizer state saved: 2 step_batch calls (one
    update), save, a fresh trainer resumed from it for 2 more (a second
    update) against one uninterrupted run of 4: adapters and optimizer state
    bit-equal. The rollouts are fixed completions (the sampling's seeds come
    from the trainer's own generator, which a resume starts over)."""
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.ops.quant import quantize_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig

    cfg = reduced_config()
    base = quantize_params(init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16), bits=8, fuse=True)
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    rng = np.random.default_rng(2)
    comps = [rng.integers(3, 151000, n).tolist() for n in (20, 57, 101, 127)]
    example = {"problem": "a door opens", "solution": (1.0, 2.0)}

    def trainer(out):
        config = TrainConfig(use_peft=True, lora_r=16, lora_alpha=32.0, num_generations=4, max_completion_length=128,
                             gradient_accumulation_steps=2, gradient_checkpointing=True, report_to="none",
                             learning_rate=1e-4, save_only_model=False, output_dir=out)
        tr = GRPOTrainer(base, cfg, IdsProcessor(), [token_parity_reward], config=config, device="cuda")
        tr.engine.generate = lambda reqs, sp: [list(c) for c in comps]
        return tr

    root = tempfile.mkdtemp(prefix="timer1_phase11c_")
    try:
        whole = trainer(root)
        for _ in range(4):
            whole.step_batch([example], [req])
        first = trainer(root)
        for _ in range(2):
            first.step_batch([example], [req])
        first.save_checkpoint(os.path.join(root, "ck"))
        resumed = trainer(root)
        resumed.load_checkpoint_state(os.path.join(root, "ck"))
        restored = trees_equal(resumed.lora, first.lora) and trees_equal(resumed.opt_state.tree(),
                                                                         first.opt_state.tree())
        for _ in range(2):
            resumed.step_batch([example], [req])
        torch.cuda.synchronize()
        out = dict(restored=restored, updates=resumed.opt_state.count,
                   adapters_equal=trees_equal(resumed.lora, whole.lora),
                   opt_state_equal=trees_equal(resumed.opt_state.tree(), whole.opt_state.tree()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[lora] (c) resumed LoRA run against an uninterrupted one: {out}; {card}")
    if out != dict(restored=True, updates=2, adapters_equal=True, opt_state_equal=True):
        raise AssertionError(f"(c): the resumed LoRA run is not the uninterrupted one bit for bit: {out}")
    return out


PHASE12_BYTES = 26e9  # (d): the 3B's input checkpoint and two saves of 7.5 GB each, with room
MEM_ROOM = 8 * 2**30  # host memory (a) leaves free beside the pinned optimizer state


def mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("/proc/meminfo has no MemAvailable")


# One tensor of n bytes from PyTorch's pinned allocator (pin_memory=True), in
# a process of its own so that its cached block goes when the process does;
# prints MemAvailable before and after it as JSON.
PINNED_PROBE = """
import json, sys, torch
def available():
    with open("/proc/meminfo") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("MemAvailable:"))
n = int(sys.argv[1])
torch.cuda.init()
before = available()
t = torch.empty(n, dtype=torch.uint8, pin_memory=True)
print(json.dumps(dict(pinned=t.is_pinned(), before=before, after=available())))
"""


def pinned_allocator_probe(nbytes: int, card: str) -> dict:
    """What PyTorch's pinned allocator takes from the host for one request of
    `nbytes` (a quarter of one optimizer tree of the 7B: pinning runs at ~1
    GB/s, and the rounding shows at any size), against the next power of
    two: the reason `HostArena` registers its own allocation instead."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", PINNED_PROBE, str(nbytes)], capture_output=True, text=True,
                         timeout=300, check=True)
    got = json.loads(run.stdout.strip().splitlines()[-1])
    if not got["pinned"]:
        raise AssertionError("pin_memory=True gave a tensor that is not pinned")
    taken = got["before"] - got["after"]
    res = dict(requested_gib=nbytes / 2**30, taken_gib=taken / 2**30, pow2_gib=2 ** (nbytes - 1).bit_length() / 2**30,
               s=time.perf_counter() - t0)
    log(f"[7b] PyTorch's pinned allocator, one pin_memory=True tensor of a quarter of one tree's bytes: "
        f"{res['requested_gib']:.2f} GiB "
        f"asked, MemAvailable down {res['taken_gib']:.2f} GiB (the next power of two: {res['pow2_gib']:.0f} GiB), "
        f"{res['s']:.1f} s with the process; {card}")
    return res


def offloaded_bytes(leaves, trees: int) -> int:
    """The host bytes of `trees` optimizer trees over `leaves` under offload
    (the leaves that `rl/optim.py::offloadable` selects)."""
    from time_r1_tpu_torch.rl.optim import offloadable

    return trees * sum(t.numel() * t.element_size() for t in leaves if offloadable(t))


def check_host_state(tag: str, state, leaves) -> None:
    """Every offloaded leaf of mu, nu and acc is a page-locked host view, and
    the arenas hold exactly their bytes."""
    trees = [n for n in ("mu", "nu", "acc") if getattr(state, n) is not None]
    for n in trees:
        for t, host in zip(getattr(state, n), state.offloaded):
            if host and not (t.device.type == "cpu" and t.is_pinned()):
                raise AssertionError(f"{tag}: an offloaded {n} leaf is on {t.device}, pinned {t.is_pinned()}")
            if not host and t.device.type != "cuda":
                raise AssertionError(f"{tag}: a small {n} leaf left the card")
    want = offloaded_bytes(leaves, len(trees))
    if state.host_bytes != want:
        raise AssertionError(f"{tag}: {state.host_bytes} bytes in the host arenas, want {want}")


def timed_updates(optimizer, updates: list):
    """Wrap `optimizer.update` (the instance's) to time each call between two
    device syncs and record the bytes it streamed."""
    import torch

    original = optimizer.update

    def update(params, grads, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(params, grads, state)
        state.wait()
        torch.cuda.synchronize()
        updates.append(dict(s=time.perf_counter() - t0, applied=out, **optimizer.last_stream))
        return out

    optimizer.update = update


def full_row_step_launches(cfg, decode_steps: int) -> dict:
    """One bf16 `step_batch` with the full-row loss under remat: K1 in the
    rollout prefill, the full-row reference forward, the loss's forward and
    its rerun in the backward; B1 and B2 once a layer; no S1 and no S2; D2
    once a layer a decode step; K2 and K3 in the rollout's vision tower."""
    layers = cfg.text.num_hidden_layers
    return vision_tc_launches(cfg) | {
        "flash_attention": 4 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
        "shared_prefix_decode_full": layers * decode_steps}


NO_SPLIT = ("shared_prefix_fwd", "shared_prefix_bwd", "shared_prefix_bwd_dkv")  # S1, S2: the split loss only


def plan_beside_peak(tag: str, n: int, peak_gib: float, offload: bool = True) -> None:
    """`parallel/plan.py`'s budget of the 7B step over n data devices (the
    rule table over the meta tree, no step run), logged beside a measured
    peak: the plan counts the parameters and gradients a device keeps, the
    peak adds the step's activations, the reference copy and the rollout's
    int8 copy and caches."""
    from time_r1_tpu_torch.parallel.plan import format_budget, plan_7b_train_step

    budget = plan_7b_train_step(n_devices=n, offload_optimizer=offload)
    for line in format_budget(budget).splitlines():
        log(f"[plan] {tag} {line}")
    log(f"[plan] {tag} the plan's steady state {budget['steady_state_per_device_gb']:.2f} GiB a device against the "
        f"measured peak {peak_gib:.2f} GiB ({peak_gib - budget['steady_state_per_device_gb']:.2f} GiB above it)")


def phase_full_param_7b(card: str) -> dict:
    """Phase 12, once phase 11's model is freed. (a) Full-parameter GRPO on
    Qwen2.5-VL-7B (bf16, seeded weights, a reference copy) with the
    optimizer state in page-locked host memory: `GRPOTrainer` with
    offload_optimizer, remat, int8 rollouts, beta 0.04, fix_vit, G = 8, 200
    tokens, accumulation 2, for 4 step_batch calls (2 updates) on 2 examples
    of phase 8's 4 s clip (FrameLoader's seeded frames, the processor over
    StandInTokenizer). Before the state is pinned, MemAvailable must exceed
    its bytes plus 8 GiB, and `pinned_allocator_probe` measures a quarter
    of one tree's bytes from PyTorch's pinned allocator. After: every offloaded leaf pinned on the host with
    exactly the offloaded bytes, the peak under 79 GiB, a decoder weight
    moved and the ViT blocks bit-unchanged, and per call exactly
    `remat_step_launches` at 28 layers with Q2 a layer a decode step, all on
    the tensor cores. Prints each call's seconds and phases, each update's
    streamed bytes and GB/s and share of train_step, the peak, and the
    pinned GiB beside MemAvailable before and after. (b) `offload_bit_equal`,
    (c) `full_row_3b`, (d) `finetune_3b`. Returns (a)'s launches, summed over
    its 4 calls, and (c)'s full-row ones."""
    import gc

    import torch

    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.rl.grpo import trainable_leaves
    from time_r1_tpu_torch.utils.profiling import PhaseTimers
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = Qwen25VLConfig.qwen25vl_7b()
    L = cfg.text.num_hidden_layers
    config = TrainConfig(offload_optimizer=True, gradient_checkpointing=True, rollout_quantization="int8", beta=0.04,
                         fix_vit=True, num_generations=8, max_completion_length=200, gradient_accumulation_steps=2,
                         report_to="none")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"))
    torch.cuda.synchronize()
    leaves = trainable_leaves(params, config.fix_vit)
    state_bytes = offloaded_bytes(leaves, 3)
    avail0 = mem_available()
    log(f"[7b] init_params 7B bf16 and its reference copy on the card: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; {sum(t.numel() for t in leaves) / 1e9:.3f} B "
        f"trainable parameters; the offloaded state {state_bytes / 2**30:.2f} GiB against MemAvailable "
        f"{avail0 / 2**30:.2f} GiB; {card}")
    if avail0 < state_bytes + MEM_ROOM:
        raise AssertionError(f"(a): MemAvailable {avail0 / 2**30:.2f} GiB is less than the offloaded state "
                             f"{state_bytes / 2**30:.2f} GiB plus {MEM_ROOM / 2**30:.0f} GiB")
    probe = pinned_allocator_probe(state_bytes // 12, card)
    avail0 = mem_available()
    processor = Qwen25VLProcessor(StandInTokenizer(cfg), pad_token_id=cfg.pad_token_id, eos_token_id=cfg.eos_token_id)
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], char_parity_reward]
    t0 = time.perf_counter()
    trainer = GRPOTrainer(params, cfg, processor, rewards, config=config, video_loader=FrameLoader(), ref_params=ref,
                          dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    avail1 = mem_available()
    pinned = trainer.opt_state.host_bytes
    log(f"[7b] GRPOTrainer(offload_optimizer=True) built in {build_s:.2f} s (the int8 rollout copy and the host "
        f"arenas): {pinned / 2**30:.2f} GiB pinned; MemAvailable {avail0 / 2**30:.2f} -> {avail1 / 2**30:.2f} GiB "
        f"(-{(avail0 - avail1) / 2**30:.2f}); {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the card")
    check_host_state("(a) built", trainer.opt_state, leaves)
    q_w = params["text"]["layers"][0]["q_w"]
    q_before = q_w.detach().clone()
    vit = [t.detach().cpu() for name in ("patch_embed", "blocks") for t in tree_leaves(params["visual"][name])]
    updates: list = []
    timed_updates(trainer.optimizer, updates)
    n, fps, _ = INPUT_CLIPS[CLI_CLIP][0]
    examples = [{"problem": f"a person opens door number {i}", "solution": (0.5 + i, 2.5 + i), "durations": n / fps,
                 "video_path": CLI_CLIP} for i in range(2)]
    calls, total = [], {}
    for call in range(4):
        trainer.timers = PhaseTimers(sync=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        n_updates = len(updates)
        t0 = time.perf_counter()
        info = trainer.step_batch([examples[call % 2]])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = read_launches()
        metrics = trainer.pop_metrics()
        tm = trainer.engine.timings
        phases = {k: round(v["total_s"] * 1e3, 1) for k, v in trainer.timers.summary().items()}
        st = dict(step_s=step_s, loss=info["loss"], phases_ms=phases, decode_steps=tm["decode_steps"],
                  decode_ms_per_step=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1),
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30, grad_norm=metrics["grad_norm"],
                  update=updates[n_updates] if len(updates) > n_updates else None)
        calls.append(st)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"[7b] (a) step_batch {call + 1}: {step_s:.2f} s, loss {info['loss']:.6f}, grad_norm "
            f"{metrics['grad_norm']:.4f}; phases (ms, synced) {phases}; rollout decode "
            f"{st['decode_ms_per_step']:.2f} ms/step over {tm['decode_steps']} steps; peak {st['peak_gib']:.2f} GiB "
            f"allocated; {card}")
        up = st["update"]
        if up is not None:
            share = up["s"] * 1e3 / phases["train_step"]
            log(f"[7b] (a) step_batch {call + 1}: the optimizer micro-step {up['s'] * 1e3:.1f} ms "
                f"({'an update' if up['applied'] else 'accumulation only'}): {up['h2d_bytes'] / 1e9:.3f} GB in "
                f"({up['h2d_bytes'] / 1e9 / up['s']:.2f} GB/s), {up['d2h_bytes'] / 1e9:.3f} GB out "
                f"({up['d2h_bytes'] / 1e9 / up['s']:.2f} GB/s), {share:.3f} of train_step")
        log(f"[7b] (a) step_batch {call + 1}: launches {launches}")
        if not (np.isfinite(info["loss"]) and np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
            raise AssertionError(f"(a) step_batch {call + 1}: loss {info['loss']}, grad_norm {metrics['grad_norm']}")
        check_step_launches(f"7b step_batch {call + 1}", launches, tm["decode_steps"], L,
                            {"shared_prefix_decode_full": 1, "fused_mlp_int8": 1, "shared_prefix_decode_attention": 0,
                             "int4_matmul": 0})
        check_tc_route(f"7b step_batch {call + 1}", launches, remat_step_launches(cfg, tm["decode_steps"]),
                       tensor_cores=True)
    avail2 = mem_available()
    check_host_state("(a) after 4 calls", trainer.opt_state, leaves)
    peak = max(st["peak_gib"] for st in calls)
    moved = not torch.equal(q_w, q_before)
    vit_same = all(torch.equal(t.detach().cpu(), b) for t, b in zip(
        (t for name in ("patch_embed", "blocks") for t in tree_leaves(params["visual"][name])), vit))
    log(f"[7b] (a) after 4 step_batch calls ({trainer.opt_state.count} updates): peak {peak:.2f} GiB allocated; "
        f"{pinned / 2**30:.2f} GiB pinned, MemAvailable {avail2 / 2**30:.2f} GiB (before the arenas "
        f"{avail0 / 2**30:.2f}); layer 0's q_w moved: {moved}; ViT blocks and patch embed bit-unchanged: "
        f"{vit_same}; {card}")
    plan_beside_peak("(a)", 1, peak)
    if trainer.opt_state.count != 2 or len(updates) != 4 or [u["applied"] for u in updates] != [False, True] * 2:
        raise AssertionError(f"(a): {trainer.opt_state.count} updates over {len(updates)} micro-steps")
    if peak >= 79.0 or not moved or not vit_same:
        raise AssertionError(f"(a): peak {peak:.2f} GiB (want < 79), decoder weight moved {moved}, ViT unchanged "
                             f"{vit_same}")
    result = dict(card=card, build_s=build_s, pinned_gib=pinned / 2**30, state_gib=state_bytes / 2**30,
                  pinned_allocator_probe=probe,
                  mem_available_gib=[avail0 / 2**30, avail1 / 2**30, avail2 / 2**30], peak_gib=peak,
                  calls=calls, timers=trainer.timers.summary())
    del trainer, ref, params, q_w, q_before, vit, leaves
    gc.collect()
    torch.cuda.empty_cache()
    result["mem_available_freed_gib"] = mem_available() / 2**30
    result["bit_equal"] = offload_bit_equal(card)
    full_row, result["full_row"] = full_row_3b(card)
    result["finetune"] = finetune_3b(card)
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"[7b] summary on {card}: {json.dumps(result)}")
    return {"full_param_7b": total, "full_row_3b": full_row}


def tree_leaves(tree) -> list:
    from time_r1_tpu_torch.utils.checkpoint import flatten

    return list(flatten(tree).values())


def leaves_equal(a, b) -> bool:
    """The two trees' leaves bit-equal in order, compared on the card a leaf
    at a time (an offloaded leaf is copied up from its pinned host memory)."""
    import torch

    dev = torch.device("cuda")
    return all(torch.equal(x.detach().to(dev), y.detach().to(dev)) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def offload_bit_equal(card: str) -> dict:
    """(b) Qwen2.5-VL-7B's widths at 2 decoder layers and 2 vision blocks,
    bf16: for full parameters, and for LoRA (rank 16) over the full-row loss,
    two trainers from the same weights, offload_optimizer on and off, on the
    same batch (fixed completions), 4 step_batch calls (2 updates at
    accumulation 2, lr 1e-4 so that the bf16 weights move): the trained
    tensors, moments, accumulation and counts bit-equal, the offloaded
    leaves pinned."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.rl.grpo import trainable_leaves
    from time_r1_tpu_torch.rl.lora import lora_leaves

    base = Qwen25VLConfig.qwen25vl_7b()
    cfg = replace(base, vision=replace(base.vision, depth=2, fullatt_block_indexes=(1,)),
                  text=replace(base.text, num_hidden_layers=2))
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    rng = np.random.default_rng(2)
    comps = [rng.integers(3, 151000, n).tolist() for n in (20, 57, 101, 127)]
    example = {"problem": "a door opens", "solution": (1.0, 2.0)}
    params0 = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    results = {}
    for tag, extra in (("full parameters", {}),
                       ("LoRA, full rows", dict(use_peft=True, lora_r=16, lora_alpha=32.0, shared_prefix_loss=False))):
        trainers = {}
        for offload in (True, False):
            config = TrainConfig(offload_optimizer=offload, num_generations=4, max_completion_length=128, beta=0.0,
                                 gradient_accumulation_steps=2, gradient_checkpointing=True, learning_rate=1e-4,
                                 report_to="none", **extra)
            tr = GRPOTrainer(to_device(params0, torch.device("cuda")), cfg, IdsProcessor(), [token_parity_reward],
                             config=config, dtype=torch.bfloat16, device="cuda")
            tr.engine.generate = lambda reqs, sp: [list(c) for c in comps]
            trainers[offload] = tr
        updates: list = []
        timed_updates(trainers[True].optimizer, updates)
        for _ in range(4):
            for tr in trainers.values():
                tr.step_batch([example], [req])
        on, off = trainers[True], trainers[False]
        lora = on.lora is not None
        trained = (lambda tr: tr.lora) if lora else (lambda tr: tr.params)
        check_host_state(f"(b) {tag}", on.opt_state, lora_leaves(on.lora) if lora else trainable_leaves(on.params, True))
        moved = (any(float(b.detach().abs().max()) > 0 for b in lora_leaves(on.lora)[1::2]) if lora else
                 not all(torch.equal(a, b) for a, b in zip(tree_leaves(on.params), tree_leaves(params0))))
        out = dict(trained_equal=leaves_equal(trained(on), trained(off)),
                   state_equal=leaves_equal(on.opt_state.tree(), off.opt_state.tree()),
                   updates=on.opt_state.count, moved=moved, host_gib=on.opt_state.host_bytes / 2**30,
                   update_ms=[round(u["s"] * 1e3, 1) for u in updates])
        log(f"[7b] (b) {tag}, 2 layers at the 7B's widths, offload on against off over 4 micro-steps: {out}; {card}")
        if not (out["trained_equal"] and out["state_equal"] and out["updates"] == 2 and moved):
            raise AssertionError(f"(b) {tag}: the offloaded run is not the device-resident one bit for bit: {out}")
        results[tag] = out
        del trainers, on, off
    return results


FULL_ROW_LAYERS = 12  # phase 12 (c)'s decoder depth: 36 before the last cuts for the time limit (PERF.md §4)


def full_row_3b(card: str) -> tuple:
    """(c) The full-row loss (shared_prefix_loss=False) on Qwen2.5-VL-3B at
    full width and FULL_ROW_LAYERS deep: phase 5's trainer (a reference copy, G = 8, 200
    tokens, accumulation 2) under remat "full", on phase 4's first request,
    two step_batch calls: each exactly `full_row_step_launches` (K1, B1, B2,
    D2, K2, K3) on the tensor cores and no S1 or S2; then two calls of the
    same trainer with the split loss, for train_step side by side. Then at 2
    layers in f32, the full-row and split losses and gradients on the same
    rollouts agree within tests/test_torch_full_row.py's tolerances. Returns
    (the first full-row call's launches, the numbers)."""
    import gc

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.utils.profiling import PhaseTimers
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    cfg = cut_depth(Qwen25VLConfig.qwen25vl_3b(), FULL_ROW_LAYERS)
    L = cfg.text.num_hidden_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"))
    req = video_request(cfg, np.random.default_rng(0), 32, 224, 392)  # phase 4's first request
    config = TrainConfig(shared_prefix_loss=False, gradient_checkpointing=True, report_to="none")
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], token_parity_reward]
    trainer = GRPOTrainer(params, cfg, IdsProcessor(), rewards, config=config, ref_params=ref, dtype=torch.bfloat16,
                          device="cuda")
    example = {"problem": "a person opens a door", "solution": (2.0, 9.5), "durations": 32.0}
    calls, first = [], None
    for call, split in enumerate((False, False, True, True)):
        trainer.c.shared_prefix_loss = split
        trainer.timers = PhaseTimers(sync=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        info = trainer.step_batch([example], [req])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = read_launches()
        metrics = trainer.pop_metrics()
        tm = trainer.engine.timings
        phases = {k: round(v["total_s"] * 1e3, 1) for k, v in trainer.timers.summary().items()}
        loss_name = "split" if split else "full-row"
        calls.append(dict(loss=loss_name, step_s=step_s, train_step_ms=phases["train_step"],
                          ref_logps_ms=phases.get("ref_logps"), peak_gib=torch.cuda.max_memory_allocated() / 2**30))
        log(f"[7b] (c) 3B step_batch {call + 1}, {loss_name} loss: {step_s:.2f} s; phases (ms, synced) {phases}; "
            f"peak {calls[-1]['peak_gib']:.2f} GiB; loss {info['loss']:.6f}, grad_norm {metrics['grad_norm']:.4f}; "
            f"{card}")
        log(f"[7b] (c) 3B step_batch {call + 1}: launches {launches}")
        if not (np.isfinite(info["loss"]) and np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
            raise AssertionError(f"(c) step_batch {call + 1}: loss {info['loss']}, grad_norm {metrics['grad_norm']}")
        if split:
            check_tc_route(f"3b split step_batch {call + 1}", launches, remat_step_launches(cfg, tm["decode_steps"]),
                           tensor_cores=True)
            continue
        check_step_launches(f"3b full-row step_batch {call + 1}", launches, 1, 1, {n: 0 for n in NO_SPLIT})
        check_tc_route(f"3b full-row step_batch {call + 1}", launches, full_row_step_launches(cfg, tm["decode_steps"]),
                       tensor_cores=True)
        first = first or launches
    full = [c["train_step_ms"] for c in calls if c["loss"] == "full-row"]
    split = [c["train_step_ms"] for c in calls if c["loss"] == "split"]
    log(f"[7b] (c) 3B train_step under remat 'full': full-row {full} ms, split {split} ms on the same request; "
        f"ratio of the second calls {full[1] / split[1]:.2f}; {card}")
    del trainer, ref, params
    gc.collect()
    torch.cuda.empty_cache()
    return first, dict(calls=calls, agreement=full_row_agreement(card))


def full_row_agreement(card: str) -> dict:
    """(c) at 3B widths and 2 decoder layers, f32 on the card (K1, B1, B2 on
    their FMA kernels): the full-row and split losses, metrics and every
    gradient on the same rollouts, within the CPU test's tolerances (loss
    rtol 2e-5 / atol 2e-6, metrics 2e-4 / 2e-5, gradients 5e-4 / 5e-5)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_batch_groups, build_grpo_split_batch
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps, grpo_value_and_grad, precompute_frozen_vision

    cfg = reduced_config()
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    ref = to_device(params, dev, scale=0.98)
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    rng = np.random.default_rng(2)
    eos = cfg.eos_token_id
    comps = [rng.integers(0, 151000, n).tolist() + ([eos] if i % 2 == 0 else []) for i, n in enumerate((20, 57, 101, 127))]
    group = {"prompt_ids": req.input_ids, "completions": comps,
             "advantages": np.array([1.0, -0.5, 0.25, -0.75], np.float32),
             "patches": req.patches, "grid_thw": req.grid_thw, "second_per_grid_t": 1.0}
    hp = GRPOHyperParams(num_generations=4, beta=0.04, fix_vit=True)
    out = {}
    for name, build in (("full", build_grpo_batch_groups), ("split", build_grpo_split_batch)):
        batch = precompute_frozen_vision(params, cfg, build(cfg, [group], dtype=torch.float32, device=dev))
        batch = batch._replace(ref_logps=compute_ref_logps(ref, cfg, hp, batch))
        reset_launches()
        loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch)
        launches = read_launches()
        if name == "full":
            check_step_launches("(c) f32 full-row loss", launches, 1, 1, {n: 0 for n in NO_SPLIT})
            check_tc_route("(c) f32 full-row loss", launches, {"flash_attention": None, "flash_bwd_dq": None,
                                                               "flash_bwd_dkv": None}, tensor_cores=False)
        out[name] = (float(loss), {k: float(v) for k, v in metrics.items()}, [g.detach() for g in grads])
    (lf, mf, gf), (ls, ms, gs) = out["full"], out["split"]
    np.testing.assert_allclose(ls, lf, rtol=2e-5, atol=2e-6)
    for k in mf:
        np.testing.assert_allclose(ms[k], mf[k], rtol=2e-4, atol=2e-5, err_msg=k)
    worst = 0.0
    for i, (a, b) in enumerate(zip(gs, gf)):  # on the card: np.testing.assert_allclose's rule, |a - b| <= atol + rtol |b|
        bad = int((~torch.isclose(a, b, rtol=5e-4, atol=5e-5, equal_nan=True)).sum())
        if bad:
            raise AssertionError(f"(c) gradient leaf {i}: {bad} of {a.numel()} elements beyond rtol 5e-4 / atol 5e-5")
        worst = max(worst, float((a - b).abs().max()))
    res = dict(loss_full=lf, loss_split=ls, worst_grad_abs_diff=worst, leaves=len(gf))
    log(f"[7b] (c) 2 layers, f32 on the card: full-row against split {res}; {card}")
    return res


def finetune_3b(card: str) -> dict:
    """(d) `cli.finetune.main` on Qwen2.5-VL-3B at full width and CLI_LAYERS
    deep (a native checkpoint of seeded weights) with the recipe's --beta 0.0
    --use_grpo false over a 2-item Charades-format json, whose video.npz
    files `cli.preprocess_videos.main` writes from phase 8's seeded frames
    (fetch_video patched to FrameLoader on CLI_CLIP). While main runs, the
    decode raises: the trainer must read the npz files. Checks one update, a
    final save that reloads equal, and no reference copy. Deletes what it
    wrote."""
    import gc
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.cli import finetune
    from time_r1_tpu_torch.cli import preprocess_videos
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.utils.checkpoint import load_params
    from time_r1_tpu_torch.video import pipeline

    cfg = cut_depth(Qwen25VLConfig.qwen25vl_3b(), CLI_LAYERS)
    root = tempfile.mkdtemp(prefix="timer1_phase12_")
    free = shutil.disk_usage(root).free
    log(f"[7b] (d) {root}: {free / 1e9:.1f} GB free; (d) writes up to {PHASE12_BYTES / 1e9:.0f} GB")
    try:
        if free < PHASE12_BYTES:
            raise AssertionError(f"(d) needs {PHASE12_BYTES / 1e9:.0f} GB under {root}, which has {free / 1e9:.1f} GB "
                                 "free: point TMPDIR at a larger disk")
        model = os.path.join(root, "base")
        params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        native_checkpoint(model, params, cfg)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        videos, pre = os.path.join(root, "videos"), os.path.join(root, "preprocessed")
        os.makedirs(videos)
        data = {}
        for i in range(2):
            with open(os.path.join(videos, f"clip{i}.mp4"), "wb") as f:
                f.write(b"placeholder")
            data[f"clip{i}"] = {"duration": 4.0, "timestamps": [[0.5 + i, 2.5 + i]],
                                "sentences": [f"A person opens door number {i}."]}
        ann = os.path.join(root, "charades.json")
        with open(ann, "w") as f:
            json.dump(data, f)
        loader = FrameLoader()
        with patched(pipeline, "fetch_video", lambda original: lambda ele: loader({**ele, "video": CLI_CLIP})):
            t0 = time.perf_counter()
            preprocess_videos.main(["--train_data_path", ann, "--video_folder", videos, "--output_dir", pre,
                                    "--num_workers", "1"])
            pre_s = time.perf_counter() - t0
        npz = {v: np.load(os.path.join(pre, v, "video.npz"))["video"].shape for v in data}
        log(f"[7b] (d) preprocess_videos: {pre_s:.2f} s for {len(npz)} videos, frames {npz}")
        if sorted(npz) != sorted(data) or any(s != (8, 3, 364, 644) for s in npz.values()):
            raise AssertionError(f"(d): video.npz frames {npz}, want (8, 3, 364, 644) for each of {sorted(data)}")

        def no_decode(original):
            def decode(*args, **kwargs):
                raise AssertionError("(d): the decoder ran: the trainer did not read video.npz")
            return decode

        out = os.path.join(root, "run")
        with cli_stand_ins(cfg), patched(pipeline, "fetch_video", no_decode), \
                patched(finetune, "video_loader", no_decode):
            reset_launches()
            t0 = time.perf_counter()
            trainer = finetune.main(["--model_name_or_path", model, "--output_dir", out, "--train_data_path", ann,
                                     "--video_folder", videos, "--preprocessed_data_path", pre, "--beta", "0.0",
                                     "--use_grpo", "false", "--num_train_epochs", "1", "--save_steps", "1000",
                                     "--reward_funcs", "iou", "format", "char_parity"])
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = read_launches()
        res = dict(main_s=main_s, preprocess_s=pre_s, global_step=trainer.global_step, updates=trainer.opt_state.count,
                   ref_params=trainer.ref_params is not None, saved=sorted(os.listdir(out)),
                   timers=trainer.timers.summary())
        same = trees_equal(load_params(out, device="cuda"), trainer.params)
        log(f"[7b] (d) cli.finetune.main: {res}; final checkpoint reloads bit-equal: {same}; launches {launches}; "
            f"{card}")
        if (trainer.global_step, trainer.opt_state.count, res["ref_params"], same) != (2, 1, False, True):
            raise AssertionError(f"(d): {res}, reload equal {same}: want 2 steps, 1 update, no reference copy")
        for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "shared_prefix_fwd", "shared_prefix_bwd"):
            if launches[name] <= 0:
                raise AssertionError(f"(d): {name} was not launched by main()")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)

# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 13
RING_SHAPES = {"3b": FULL_ROW_ATTN, "7b_heads": dict(FULL_ROW_ATTN, H=28, Hkv=4)}
RING_LAYOUTS = (("contiguous", True), ("zigzag", True), ("contiguous", False))
RING_TOL = {"bfloat16": GRAD_TOL["bfloat16"], "float32": 1e-5}  # max |ring - one call| / max |one call|
RING_SIZES = (2, 4)
PARALLEL_TIMEOUT = 300  # s: the parent's wait for one spawn of ranks (each takes 35-90 s)
CP_LAYOUT = "zigzag"  # the CLI's default --context_parallel_layout
CP_MULTIPLE = 2 * 2 * 128  # zig-zag over 2 ranks: trainer.py:647-649
DP_LAYERS = 2  # (c)'s decoder depth at 3B widths: two trainers share the card, the time limit holds
DP_TOKENS = 32  # the rollout length of `dp_trainer` (the default 200 until phase 17 came into the script's limit,
# 64 before the last cuts, PERF.md §4)
CP_LOSS_LAYERS = 2  # (b)'s bf16 depth (its 36 layers took 68 s of phase 13; 4 until phase 16 came into the script's
# time limit: the checks are per layer the same)
# (b) bf16 at CP_LOSS_LAYERS: loss and metrics within 2e-2 of the one-process values (1e-3 absolute floor);
# per gradient leaf ||ring - one|| / ||one|| under 0.25, over all leaves under 5e-2
CP_BF16_TOL = dict(loss=2e-2, metric=2e-2, floor=1e-3, leaf=0.25, whole=5e-2)
# (c) bf16 at DP_LAYERS: loss, gathered metrics and grad_norm within 2e-2 of one process's (1e-3 absolute
# floor); the update ||(w_dp - w0) - (w_one - w0)|| / ||w_one - w0|| under 5e-2
DP_TOL = dict(rel=2e-2, floor=1e-3, update=5e-2)


def ring_launches(layout: str, causal: bool, n: int, r: int) -> int:
    """K1 launches of one ring forward on rank r of n, and B1's and B2's in
    its backward: a skipped block launches nothing."""
    if layout == "zigzag":
        return 2 * n + 1
    return r + 1 if causal else n


class RankPool:
    """Rank processes over gloo, all on the first card, kept from one spawn
    to the next: each starts Python, PyTorch and its CUDA context once (7-11
    s a spawn on an H100 host) and then runs `parallel_rank` for every job
    it is given, a process group of the job's own each time. Worker r reads
    `w<r>.job<k>.json` in the pool's directory (a job, or a stop) and writes
    `w<r>.done<k>` with its exit code; a worker whose parent is gone exits."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="timer1_rank_pool_")
        self.procs: list = []
        self.jobs: list = []  # the next job's index, per worker

    def grow(self, world: int) -> None:
        here = os.path.dirname(os.path.abspath(__file__))
        first_card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=first_card)
        for r in range(len(self.procs), world):
            code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
                    f"sys.exit(chip_smoke.rank_worker({self.dir!r}, {r}))")
            logf = open(os.path.join(self.dir, f"w{r}.log"), "w")
            self.procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=logf,
                                               stderr=subprocess.STDOUT, cwd=here))
            logf.close()
            self.jobs.append(0)

    def post(self, r: int, msg: dict) -> int:
        """Hand worker r its next message; returns the message's index."""
        k = self.jobs[r]
        path = os.path.join(self.dir, f"w{r}.job{k}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(msg, f)
        os.replace(path + ".tmp", path)
        self.jobs[r] = k + 1
        return k

    def run(self, job: str, world: int, root: str, port: int, timeout: float) -> tuple:
        """The job on workers 0..world-1: (exit codes, None) or (codes so far,
        why it failed: a worker gone or the timeout)."""
        self.grow(world)
        ks = [self.post(r, dict(job=job, root=root, env=dict(
            RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))) for r in range(world)]
        codes: list = [None] * world
        t0 = time.perf_counter()
        while True:
            for r in range(world):
                done = os.path.join(self.dir, f"w{r}.done{ks[r]}")
                if codes[r] is None and os.path.exists(done):
                    with open(done) as f:
                        codes[r] = int(f.read())
            if all(c is not None for c in codes):
                return codes, None
            gone = [r for r in range(world) if codes[r] is None and self.procs[r].poll() is not None]
            if gone:
                return codes, f"worker(s) {gone} exited with {[self.procs[r].returncode for r in gone]}"
            if any(codes) or time.perf_counter() - t0 > timeout:
                # a failed rank leaves the others waiting in a collective
                return codes, f"a rank did not finish in {timeout} s" if not any(codes) else None
            time.sleep(0.05)

    def close(self, kill: bool = False) -> None:
        """Stop the workers (kill: at once) and remove the directory."""
        import shutil

        if not kill:
            for r, p in enumerate(self.procs):
                if p.poll() is None:
                    self.post(r, {"stop": True})
            for p in self.procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.procs = []
        shutil.rmtree(self.dir, ignore_errors=True)


_POOL: list = []  # the gloo rank pool, once made


def close_rank_pool(kill: bool = False) -> None:
    """Stop the gloo rank pool's workers, if any were started."""
    while _POOL:
        _POOL.pop().close(kill)


def rank_pool() -> RankPool:
    if not _POOL:
        import atexit

        _POOL.append(RankPool())
        atexit.register(close_rank_pool, True)
    return _POOL[0]


def rank_worker(pool_dir: str, r: int) -> int:
    """A pooled gloo rank (`RankPool`): PyTorch and the card once, then each
    job as a fresh process would see it (launch and staging counters at 0,
    the default seed, the peak memory reset, the cached blocks freed after),
    its output in the job's `rank<r>.log`."""
    import gc

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    import time_r1_tpu_torch.models  # noqa: F401  (imported once, not per job)
    import time_r1_tpu_torch.rl  # noqa: F401
    import time_r1_tpu_torch.sampler  # noqa: F401
    from time_r1_tpu_torch.parallel import comm, fsdp

    torch.cuda.init()
    seed = torch.initial_seed()
    parent = os.getppid()
    log(f"rank worker {r} ready: PyTorch and the card")
    k = 0
    while True:
        path = os.path.join(pool_dir, f"w{r}.job{k}.json")
        while not os.path.exists(path):
            if os.getppid() != parent:
                return 1
            time.sleep(0.02)
        with open(path) as f:
            msg = json.load(f)
        if msg.get("stop"):
            return 0
        os.environ.update(msg["env"])
        reset_launches()
        comm.staged_bytes = 0
        fsdp.layer_gathers = 0
        torch.manual_seed(seed)
        torch.cuda.reset_peak_memory_stats()
        sys.stdout.flush()
        sys.stderr.flush()
        saved = os.dup(1), os.dup(2)
        fd = os.open(os.path.join(msg["root"], f"rank{r}.log"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(fd)
        try:
            code = parallel_rank(msg["job"], msg["root"])
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            os.close(saved[0])
            os.close(saved[1])
        gc.collect()
        torch.cuda.empty_cache()
        if hasattr(torch._C, "_host_emptyCache"):
            torch._C._host_emptyCache()  # the pinned staging blocks the job cached
        log(f"rank worker {r}: job {k} ({msg['job']}) exit code {code}; "
            f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB still allocated")
        with open(os.path.join(pool_dir, f"w{r}.done{k}.tmp"), "w") as f:
            f.write(str(code))
        os.replace(os.path.join(pool_dir, f"w{r}.done{k}.tmp"), os.path.join(pool_dir, f"w{r}.done{k}"))
        if code:
            return code
        k += 1


def spawn_ranks(job: str, world: int, args: dict, card: str, nccl: bool = False,
                timeout: float = PARALLEL_TIMEOUT) -> list:
    """Run `parallel_rank(job)` in `world` processes with torchrun's
    environment (127.0.0.1, a free port): over gloo with the ranks all on
    the first card (`RankPool`'s workers, kept between spawns), or with
    `nccl` a card a rank (new processes; the machine shows `world` cards at
    least). Waits `timeout` s at most; a rank that fails or hangs is an
    error (the others are killed). Prints every rank's log, returns each
    rank's result."""
    import shutil
    import socket
    import tempfile

    root = tempfile.mkdtemp(prefix=f"timer1_phase13_{job}_")
    with open(os.path.join(root, "args.json"), "w") as f:
        json.dump(args, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    failed = None
    if nccl:
        procs = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
                    f"sys.exit(chip_smoke.parallel_rank({job!r}, {root!r}))")
            logf = open(os.path.join(root, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen([sys.executable, "-c", code], env=env, stdout=logf,
                                           stderr=subprocess.STDOUT, cwd=here), logf))
        try:
            for p, _ in procs:
                p.wait(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
        except subprocess.TimeoutExpired:
            failed = f"a rank did not finish in {timeout} s"
        finally:
            for p, logf in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                logf.close()
        codes = [p.returncode for p, _ in procs]
    else:
        pool = rank_pool()
        codes, failed = pool.run(job, world, root, port, timeout)
        if failed or any(codes):
            for r in range(world):
                with open(os.path.join(pool.dir, f"w{r}.log")) as f:
                    for line in f.read().splitlines():
                        log(f"[parallel worker {r}] {line}")
            close_rank_pool(kill=True)  # the next spawn starts new workers
    for r in range(world):
        log_path = os.path.join(root, f"rank{r}.log")
        if os.path.exists(log_path):
            with open(log_path) as f:
                for line in f.read().splitlines():
                    log(f"[parallel {job} rank {r}] {line}")
    if not nccl and _POOL:  # each worker's line after the job: what it still holds
        for r in range(world):
            with open(os.path.join(_POOL[0].dir, f"w{r}.log")) as f:
                log(f"[parallel worker {r}] {f.read().splitlines()[-1]}")
    route = "nccl, a card a rank" if nccl else "gloo on one card (pooled workers)"
    log(f"[parallel] {job}: {world} ranks over {route}, exit codes {codes}, {time.perf_counter() - t0:.1f} s; {card}")
    try:
        if failed or any(codes):
            raise AssertionError(f"ranks of {job}: {failed or f'exit codes {codes}'}")
        out = []
        for r in range(world):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def parallel_rank(job: str, root: str) -> int:
    """A phase-13 rank: join the group from torchrun's environment, run the
    job, write `rank<r>.json`; 1 on any failure (its traceback printed)."""
    import traceback

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.parallel import maybe_init_distributed

    rank = int(os.environ["RANK"])
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = maybe_init_distributed("cuda")
        log(f"rank {rank}/{dist.get_world_size()} on {dev} over {dist.get_backend()}; "
            f"{torch.cuda.device_count()} card(s) visible")
        with open(os.path.join(root, "args.json")) as f:
            args = json.load(f)
        result = {"ring": ring_job, "cp_loss": cp_loss_job, "dp": dp_job, "sharded": sharded_job,
                  "seven_b": seven_b_job, "mesh": mesh_job, "seven_b_serving": seven_b_serving_job,
                  "eval_7b": eval_7b_job, "kvrep": kvrep_job, "three_b_tp4": three_b_tp4_job}[job](args)
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        return 1


def _rel(got, want) -> float:
    """max |got - want| / max |want|; 0 over no elements (a shard of pad rows only)."""
    if want.numel() == 0:
        return 0.0
    return (got.float() - want.float()).abs().max().item() / max(want.float().abs().max().item(), 1e-30)


def ring_job(args: dict) -> dict:
    """(a) on each rank: for each shape, dtype and layout, the ring over 2
    ranks (the first two) and over 4 against one process's K1 and, through
    its autograd, B1/B2 over the whole sequence: this rank's out and lse (on
    the rows that see a key) and dq, dk, dv, the launches of the ring's
    forward and backward, and in bf16 the ring's fwd+bwd time on every rank
    of the group against the one call's on rank 0 alone, and the bytes
    staged through host memory."""
    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.parallel import ContextParallel, comm
    from time_r1_tpu_torch.parallel import ring_attention as ra

    rank = dist.get_rank()
    sizes = args["sizes"]
    groups = {n: dist.new_group(list(range(n))) for n in sizes}
    dev = torch.device("cuda")
    cases = []
    for shape_name, shape in RING_SHAPES.items():
        B, T, H, Hkv, D, P, comps = (shape[k] for k in ("B", "T", "H", "Hkv", "D", "prompt", "comps"))
        lead = T - P - max(comps)
        pos = torch.arange(T, device=dev)
        ends = torch.tensor([lead + P + c for c in comps], device=dev)
        bias = torch.where((pos[None] >= lead) & (pos[None] < ends[:, None]), 0.0, NEG_INF).float()
        valid = (pos >= lead)[None].expand(B, T)
        gen = torch.Generator(device=dev).manual_seed(13)  # the same inputs on every rank
        base = {n: torch.randn(s, generator=gen, device=dev) for n, s in (
            ("q", (B, T, H, D)), ("k", (B, T, Hkv, D)), ("v", (B, T, Hkv, D)), ("do", (B, T, H, D)))}
        base["do"] *= valid[:, :, None, None]
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[-1]
            q, k, v, do = (base[n].to(dtype) for n in ("q", "k", "v", "do"))
            for causal in (True, False):
                ref = {}
                ref["out"], ref["lse"] = fa.flash_attention_fwd(q, k, v, bias, causal)
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                fa.flash_attention(qg, kg, vg, bias, causal).backward(do)
                ref.update(dq=qg.grad, dk=kg.grad, dv=vg.grad)
                one_ms = None
                if dtype is torch.bfloat16:
                    dist.barrier()
                    if rank == 0:  # alone on the card
                        def one_call():
                            a, b_, c = (t.detach().requires_grad_() for t in (q, k, v))
                            fa.flash_attention(a, b_, c, bias, causal).backward(do)
                        one_ms = cuda_ms(one_call, iters=3, queued=False)
                    dist.barrier()
                for layout, lay_causal in RING_LAYOUTS:
                    if lay_causal != causal:
                        continue
                    for n in sizes:
                        if rank >= n:
                            dist.barrier()
                            continue
                        cp = ContextParallel(groups[n], layout)
                        idx = cp.index(T, dev)
                        ql, kl, vl, bl, dol = (t.index_select(1, idx).contiguous() for t in (q, k, v, bias, do))
                        reset_launches()
                        if layout == "zigzag":
                            out, lse = ra._zz_fwd(ql, kl, vl, bl, cp.group, D ** -0.5)
                        else:
                            out, lse = ra._ring_fwd(ql, kl, vl, bl, cp.group, causal, D ** -0.5)
                        torch.cuda.synchronize()
                        fwd = read_launches()
                        a, b_, c = (t.clone().requires_grad_() for t in (ql, kl, vl))
                        o = (ra.ring_flash_attention_zigzag(a, b_, c, bl, cp.group) if layout == "zigzag"
                             else ra.ring_flash_attention(a, b_, c, bl, cp.group, causal))
                        torch.cuda.synchronize()
                        reset_launches()
                        o.backward(dol)
                        torch.cuda.synchronize()
                        bwd = read_launches()
                        got = dict(out=out, lse=lse, dq=a.grad, dk=b_.grad, dv=c.grad)
                        vrows = valid.index_select(1, idx)
                        errs = {}
                        for name, g in got.items():
                            w = ref[name].index_select(2 if name == "lse" else 1, idx)
                            if not torch.isfinite(g).all():
                                raise AssertionError(f"ring {shape_name} {key} {layout} n={n}: {name} not finite")
                            if name == "out":
                                g, w = g[vrows], w[vrows]
                            elif name == "lse":
                                m = vrows[:, None, :].expand_as(g)
                                g, w = g[m], w[m]
                            errs[name] = _rel(g, w)
                        want = ring_launches(layout, causal, n, rank)
                        counts = {"flash_attention": fwd["flash_attention"], "flash_attention_tc": fwd["flash_attention_tc"],
                                  **{f: bwd[f] for f in ("flash_bwd_dq", "flash_bwd_dq_tc", "flash_bwd_dkv",
                                                          "flash_bwd_dkv_tc")}}
                        tc = dtype is torch.bfloat16
                        for f in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
                            if counts[f] != want or counts[f"{f}_tc"] != (want if tc else 0):
                                raise AssertionError(f"ring {shape_name} {key} {layout} n={n} rank {rank}: {f} ran "
                                                     f"{counts[f]} launches ({counts[f + '_tc']} tensor-core), want "
                                                     f"{want} {'tensor-core' if tc else 'FMA'}")
                        worst = max(errs.values())
                        if not worst <= RING_TOL[key]:
                            raise AssertionError(f"ring {shape_name} {key} {layout} n={n} rank {rank}: "
                                                 f"max |ring - one call| / max |one call| {errs} > {RING_TOL[key]}")
                        case = dict(shape=shape_name, dtype=key, layout=layout, causal=causal, n=n, rank=rank,
                                    errs=errs, launches=want, one_ms=one_ms)
                        if tc:
                            a, b_, c = (t.detach().requires_grad_() for t in (ql, kl, vl))
                            staged0 = comm.staged_bytes
                            dist.barrier(group=groups[n])
                            t0 = time.perf_counter()
                            for _ in range(3):
                                o = (ra.ring_flash_attention_zigzag(a, b_, c, bl, cp.group) if layout == "zigzag"
                                     else ra.ring_flash_attention(a, b_, c, bl, cp.group, causal))
                                o.backward(dol)
                            torch.cuda.synchronize()
                            case["ring_ms"] = (time.perf_counter() - t0) * 1e3 / 3
                            case["staged_mb"] = (comm.staged_bytes - staged0) / 3 / 2**20
                        log(f"ring {shape_name} {key} {layout} {'causal' if causal else 'non-causal'} n={n}: "
                            f"errs {', '.join(f'{k_} {e:.2e}' for k_, e in errs.items())} (tol {RING_TOL[key]}); "
                            f"K1/B1/B2 {want} launches each" + (" on the tensor cores" if tc else " (FMA)")
                            + (f"; fwd+bwd {case['ring_ms']:.2f} ms on this rank, {case['staged_mb']:.1f} MiB "
                               f"staged" if tc else ""))
                        cases.append(case)
                        dist.barrier()
                del ref, qg, kg, vg
    return {"cases": cases}


def cp_loss_groups(cfg):
    """(b)'s rollout group: phase 12 (c)'s request (phase 4's first: 32
    frames at 224x392, a 1914-token prompt) with G = 8 fixed completions of
    FULL_ROW_ATTN's lengths (those short of 200 end in EOS) and seeded
    advantages."""
    rng = np.random.default_rng(1)
    req = video_request(cfg, np.random.default_rng(0), 32, 224, 392)
    comps = []
    for n in FULL_ROW_ATTN["comps"]:
        toks = rng.integers(3, 97, n).tolist()
        comps.append(toks[:-1] + [cfg.eos_token_id] if n < 200 else toks)
    return [{"prompt_ids": req.input_ids, "completions": comps, "advantages": rng.normal(size=8).astype(np.float32),
             "patches": req.patches, "grid_thw": req.grid_thw, "second_per_grid_t": 1.0}]


def cp_loss_cases():
    """(b)'s two configurations: Qwen2.5-VL-3B (`mesh_3b`) at CP_LOSS_LAYERS
    decoder layers in bf16 (the tensor-core kernels), and at 2 in f32 (FMA),
    where the tolerances are tests/test_torch_sequence_parallel.py's."""
    return {"bf16": (mesh_3b(CP_LOSS_LAYERS), "bfloat16"), "f32_2_layers": (mesh_3b(2), "float32")}


def cp_loss_setup(cfg, dtype_name: str, cp=None):
    """Seeded weights (the same on every rank), the full-row batch padded to
    CP_MULTIPLE, the reference log-probs (the policy's own weights: the KL
    path runs, at 0) → (params, batch, hp)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_batch_groups
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps

    dtype = getattr(torch, dtype_name)
    params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
    batch = build_grpo_batch_groups(cfg, cp_loss_groups(cfg), dtype=dtype, pad_multiple=CP_MULTIPLE, device="cuda")
    hp = GRPOHyperParams(num_generations=8, beta=0.04, fix_vit=True, gradient_checkpointing="full")
    batch = batch._replace(ref_logps=compute_ref_logps(params, cfg, hp, batch, cp=cp))
    return params, batch, hp


def cp_loss_job(args: dict) -> dict:
    """(b) on each rank: the CP loss and gradients (`grpo_value_and_grad`
    with cp, remat "full") for each of cp_loss_cases, the launches against
    the ring's formula (15 K1 a layer: the reference forward, the loss's and
    its rerun under remat; 5 B1 and 5 B2 a layer), the peak; rank 0 holds
    the loss, metrics and every gradient against the one-process values the
    parent wrote."""
    import gc

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.parallel import ContextParallel, comm, data_group, make_mesh
    from time_r1_tpu_torch.rl.grpo import grpo_value_and_grad, trainable_leaves

    rank = dist.get_rank()
    cp = ContextParallel(data_group(make_mesh()), CP_LAYOUT)
    out = {}
    for tag, (cfg, dtype_name) in cp_loss_cases().items():
        L = cfg.text.num_hidden_layers
        torch.cuda.reset_peak_memory_stats()
        staged0 = comm.staged_bytes
        reset_launches()
        t0 = time.perf_counter()
        params, batch, hp = cp_loss_setup(cfg, dtype_name, cp)
        loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch, cp=cp)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {"flash_attention": 3 * (2 * 2 + 1) * L, "flash_bwd_dq": (2 * 2 + 1) * L,
                "flash_bwd_dkv": (2 * 2 + 1) * L}
        check_tc_route(f"cp loss {tag} rank {rank}", launches, want, tensor_cores=dtype_name == "bfloat16")
        res = dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()}, peak_gib=peak,
                   ref_and_step_s=step_s, staged_gb=(comm.staged_bytes - staged0) / 1e9,
                   launches={k: launches[k] for k in want},
                   checksum=float(sum(p.float().sum() for p in trainable_leaves(params, True)[:4])))
        log(f"cp loss {tag}: loss {res['loss']:.6f}; reference forward and loss step {step_s:.2f} s; peak "
            f"{peak:.2f} GiB on this rank; {res['staged_gb']:.2f} GB staged; launches {want} as the ring's formula")
        if rank == 0:
            ref = torch.load(args[tag], weights_only=False)
            if abs(ref["checksum"] - res["checksum"]) > 0:
                raise AssertionError(f"cp loss {tag}: the ranks' seeded weights differ from the parent's")
            res["vs_one_process"] = cp_against_one(tag, dtype_name, res, grads, ref)
        del params, batch, grads, loss
        gc.collect()
        torch.cuda.empty_cache()
        out[tag] = res
        dist.barrier()
    return out


def cp_against_one(tag: str, dtype_name: str, res: dict, grads, ref: dict, what: str = "cp loss") -> dict:
    """(b): the CP loss, metrics and gradients against one process's (and
    phase 14 (d)'s sharded ones, `what` naming the run; `grads` may be a
    generator of gathered gradients on the card)."""
    import torch

    errs = {"loss": abs(res["loss"] - ref["loss"]) / max(abs(ref["loss"]), CP_BF16_TOL["floor"])}
    for k, v in ref["metrics"].items():
        errs[f"metric {k}"] = abs(res["metrics"][k] - v) / max(abs(v), CP_BF16_TOL["floor"])
    leaf, num, den, worst = [], 0.0, 0.0, (0.0, -1)
    close = True
    for i, (g, w) in enumerate(zip(grads, ref["grads"])):
        g, w = g.float(), w.to(g.device).float()
        d = (g - w).norm().item()
        n = w.norm().item()
        num, den = num + d * d, den + n * n
        e = d / max(n, 1e-30)
        leaf.append(e)
        worst = max(worst, (e, i))
        if dtype_name == "float32":
            close &= bool(torch.allclose(g, w, rtol=8e-4, atol=8e-5))
    whole = (num / max(den, 1e-30)) ** 0.5
    log(f"{what} {tag} against one process: loss {res['loss']:.6f} vs {ref['loss']:.6f}; relative errors "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; gradients ||{what} - one|| / ||one|| over all leaves "
        f"{whole:.3e}, worst leaf {worst[0]:.3e} (#{worst[1]} of {len(leaf)}); one process's peak "
        f"{ref['peak_gib']:.2f} GiB")
    if dtype_name == "float32":
        ok = (abs(res["loss"] - ref["loss"]) <= 3e-6 + 3e-5 * abs(ref["loss"]) and close
              and all(abs(res["metrics"][k] - v) <= 3e-5 + 3e-4 * abs(v) for k, v in ref["metrics"].items()))
    else:
        t = CP_BF16_TOL
        ok = (errs["loss"] <= t["loss"] and all(v <= t["metric"] for k, v in errs.items() if k != "loss")
              and worst[0] <= t["leaf"] and whole <= t["whole"])
    if not ok:
        raise AssertionError(f"{what} {tag}: the loss/metrics/gradients disagree with one process's: "
                             f"{errs}, whole {whole}, worst leaf {worst}")
    return dict(errs=errs, grad_rel_whole=whole, grad_rel_worst_leaf=worst[0])


def cp_loss_reference(card: str) -> tuple:
    """(b) first, in this process: the one-process full-row loss and
    gradients of each cp_loss_cases configuration (no cp), to host memory
    and a file each; the card is freed before the ranks start. Returns
    ({tag: file}, root, {tag: one-process numbers})."""
    import gc
    import tempfile

    import torch

    from time_r1_tpu_torch.rl.grpo import grpo_value_and_grad, trainable_leaves

    root = tempfile.mkdtemp(prefix="timer1_phase13_ref_")
    files, numbers = {}, {}
    for tag, (cfg, dtype_name) in cp_loss_cases().items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, batch, hp = cp_loss_setup(cfg, dtype_name)
        loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        ref = dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()}, peak_gib=peak,
                   grads=[g.cpu() for g in grads],
                   checksum=float(sum(p.float().sum() for p in trainable_leaves(params, True)[:4])))
        files[tag] = os.path.join(root, f"{tag}.pt")
        torch.save(ref, files[tag])
        numbers[tag] = dict(loss=ref["loss"], peak_gib=peak, ref_and_step_s=step_s, T=int(batch.input_ids.shape[1]))
        log(f"[parallel] (b) one process, {tag}: full rows of {batch.input_ids.shape[1]} tokens, loss "
            f"{ref['loss']:.6f}; reference forward and loss step {step_s:.2f} s; peak {peak:.2f} GiB; {card}")
        del params, batch, grads, loss, ref
        gc.collect()
        torch.cuda.empty_cache()
    return files, root, numbers


def dp_trainer(cfg, mesh, out_dir: str, extra_rewards=(), **kw):
    """(c)'s trainer (and phase 14 (e)'s, phase 17 (c)'s): seeded bf16
    weights at cfg's depth and a reference copy, phase 8's clip through
    FrameLoader and the stand-in processor, the default TrainConfig but for
    one update a step_batch, lr 1e-3 (an AdamW step that moves bf16
    weights) and DP_TOKENS a rollout; `extra_rewards` beside its three."""
    import torch

    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"))
    loader = FrameLoader()
    config = TrainConfig(**{**dict(gradient_accumulation_steps=1, learning_rate=1e-3, report_to="none",
                                   output_dir=out_dir, max_completion_length=DP_TOKENS), **kw})
    processor = Qwen25VLProcessor(StandInTokenizer(cfg), pad_token_id=cfg.pad_token_id, eos_token_id=cfg.eos_token_id)
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], char_parity_reward, *extra_rewards]
    return GRPOTrainer(params, cfg, processor, rewards, config=config, ref_params=ref, dtype=torch.bfloat16,
                       video_loader=lambda ele: loader({**ele, "video": CLI_CLIP}), mesh=mesh, device="cuda")


DP_EXAMPLES = [{"problem": f"a person opens door number {i}", "solution": (0.5 + i, 2.5 + i), "durations": 4.0,
                "video_path": f"{CLI_CLIP}_{i}.mp4"} for i in range(2)]


def dp_job(args: dict) -> dict:
    """(c) on each rank: a data-parallel step_batch on this rank's example
    of phase 8's clip (its own rollouts; the trainer on the mesh is FSDP,
    its optimizer state offloaded: the arenas pin this rank's blocks only),
    then on rank 0 one process's
    step_batch over both examples with the ranks' completions replayed,
    against which the DP loss, gathered metrics and update are held; then
    `cli.train.main` with --context_parallel_size 2 for 2 step_batch calls
    and its saves."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.parallel import comm, make_mesh
    from time_r1_tpu_torch.rl.grpo import trainable_leaves

    rank = dist.get_rank()
    cfg = mesh_3b(DP_LAYERS)
    mesh = make_mesh()
    root = tempfile.mkdtemp(prefix=f"timer1_phase13_dp{rank}_")
    out = {"layers": DP_LAYERS}
    tr = dp_trainer(cfg, mesh, root, offload_optimizer=True)
    # the trainer holds its blocks (FSDP over the two ranks): the whole weights are gathered
    w0 = [p.detach().clone() for p in trainable_leaves(tr.gathered_params(), True)]
    recorded = []
    generate = tr.engine.generate

    def record(requests, sp):
        comps = generate(requests, sp)
        recorded.append(comps)
        return comps

    tr.engine.generate = record
    torch.cuda.reset_peak_memory_stats()
    staged0 = comm.staged_bytes
    reset_launches()
    t0 = time.perf_counter()
    info = tr.step_batch([DP_EXAMPLES[rank]])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = read_launches()
    metrics = tr.pop_metrics()
    blocks = trainable_leaves(tr.params, True)
    want_host = 2 * sum(b.numel() * b.element_size() for b, n in zip(blocks, tr._whole_numels)
                        if b.dim() >= 1 and n >= 1024)
    whole_host = 2 * sum(n * b.element_size() for b, n in zip(blocks, tr._whole_numels) if b.dim() >= 1 and n >= 1024)
    if tr.opt_state.host_bytes != want_host:
        raise AssertionError(f"dp: {tr.opt_state.host_bytes} bytes pinned, want this rank's blocks' {want_host}")
    log(f"dp (FSDP, offload_optimizer) rank {rank}: {want_host / 2**30:.3f} GiB pinned, the whole state's "
        f"{whole_host / 2**30:.3f} GiB")
    decode_steps = tr.engine.timings["decode_steps"]
    # under a mesh the rollout's ViT pass is not captured (as in JAX): the frozen blocks run again for the loss
    want = step_batch_tc_launches(cfg, decode_steps) | {k: 2 * v for k, v in vision_tc_launches(cfg).items()}
    check_tc_route(f"dp step_batch rank {rank}", launches, want, tensor_cores=True)
    out["dp"] = dict(loss=info["loss"], metrics=metrics, step_s=step_s, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     staged_gb=(comm.staged_bytes - staged0) / 1e9)
    log(f"dp step_batch on example {rank}: {step_s:.2f} s, loss {info['loss']:.6f}, gathered metrics {metrics}; "
        f"peak {out['dp']['peak_gib']:.2f} GiB on this rank; {out['dp']['staged_gb']:.2f} GB staged")
    whole = trainable_leaves(tr.gathered_params(), True)
    moved = [p.detach() - w for p, w in zip(whole, w0)]
    all_comps = [None] * dist.get_world_size()
    dist.all_gather_object(all_comps, recorded[0])
    digest = float(sum(p.detach().float().sum() for p in whole))
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, digest)
    if len(set(digests)) != 1:
        raise AssertionError(f"dp: the ranks' weights differ after the step ({digests})")
    del whole
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        one = dp_trainer(cfg, None, root)
        replay = [c for comps in all_comps for c in comps]
        one.engine.generate = lambda requests, sp: [list(c) for c in replay]
        one_info = one.step_batch(DP_EXAMPLES)
        one_metrics = one.pop_metrics()
        upd = [p.detach() - w for p, w in zip(trainable_leaves(one.params, True), w0)]
        num = sum(((a.float() - b.float()) ** 2).sum().item() for a, b in zip(moved, upd))
        den = sum((b.float() ** 2).sum().item() for b in upd)
        update_err = (num / max(den, 1e-30)) ** 0.5
        rel = {k: abs(metrics[k] - v) / max(abs(v), DP_TOL["floor"]) for k, v in one_metrics.items()}
        rel["loss"] = abs(info["loss"] - one_info["loss"]) / max(abs(one_info["loss"]), DP_TOL["floor"])
        log(f"dp against one process over both examples: loss {info['loss']:.6f} vs {one_info['loss']:.6f}; "
            f"relative errors {({k: f'{v:.2e}' for k, v in rel.items()})}; update ||dp - one|| / ||one|| "
            f"{update_err:.3e} (||one|| {den ** 0.5:.4f})")
        if set(one_metrics) != set(metrics) or max(rel.values()) > DP_TOL["rel"] or update_err > DP_TOL["update"]:
            raise AssertionError(f"dp: against one process {rel}, update {update_err}")
        out["vs_one_process"] = dict(rel=rel, update_err=update_err)
        del one
        gc.collect()
        torch.cuda.empty_cache()
    del moved, w0
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["cli"] = cp_cli_run(cfg, args, rank)
    return out


def cp_cli_run(cfg, args: dict, rank: int) -> dict:
    """(c): `cli.train.main` with --context_parallel_size 2 at (c)'s depth
    from the HF checkpoint the parent wrote, 2 examples of phase 8's clip
    (2 step_batch calls, one update, the epoch's save and the final one):
    per step on each rank exactly 5 B1 and 5 B2 a layer (zig-zag over 2
    ranks), and on rank 1, which does not roll out, 15 K1 a layer; the
    ranks' weights equal; trainer_state.json written once."""
    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.rl import GRPOTrainer
    from time_r1_tpu_torch.rl.grpo import trainable_leaves

    L = cfg.text.num_hidden_layers
    steps = []

    def counted(original):
        def step_batch(self, examples, requests=None):
            reset_launches()
            t0 = time.perf_counter()
            res = original(self, examples, requests=requests)
            torch.cuda.synchronize()
            steps.append(dict(s=time.perf_counter() - t0, loss=res["loss"], launches=read_launches()))
            return res
        return step_batch

    torch.cuda.reset_peak_memory_stats()
    with cli_stand_ins(cfg) as cli, patched(GRPOTrainer, "step_batch", counted):
        trainer = cli.main(cli_args(cli, args["hf"], args["out"], args["data"], "--context_parallel_size", "2"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, st in enumerate(steps, start=1):
        want = {"flash_bwd_dq": 5 * L, "flash_bwd_dkv": 5 * L} | ({"flash_attention": 15 * L} if rank == 1 else {})
        check_tc_route(f"cli cp step_batch {i} rank {rank}", st["launches"], want, tensor_cores=True)
        log(f"cli --context_parallel_size 2 step_batch {i}: {st['s']:.2f} s, loss {st['loss']:.6f}")
    digest = float(sum(p.detach().float().sum() for p in trainable_leaves(trainer.gathered_params(), True)))
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, digest)
    if len(set(digests)) != 1 or len(steps) != 2 or trainer.global_step != 2 or trainer._cp is None:
        raise AssertionError(f"cli cp: {len(steps)} steps, global_step {trainer.global_step}, digests {digests}")
    with open(os.path.join(args["out"], "trainer_state.json")) as f:
        if json.load(f) != {"global_step": 2}:
            raise AssertionError("cli cp: trainer_state.json is not global_step 2")
    log(f"cli --context_parallel_size 2: 2 step_batch calls, the ranks' weights equal, trainer_state.json "
        f"written; peak {peak:.2f} GiB on this rank")
    return dict(step_s=[st["s"] for st in steps], peak_gib=peak)


def phase_parallel(card: str, parts: str = "abc") -> dict:
    """Phase 13: data parallelism over processes and context parallelism, as
    2 or 4 ranks over gloo on the first card; where the machine shows two
    cards or more, (a) and (c) run again over NCCL, a card a rank. (a) ring
    attention (`ring_job`); (b) the CP GRPO loss and gradients at
    Qwen2.5-VL-3B full width and depth under remat over 2 ranks, against one
    process's, which runs first and is freed before the ranks start
    (`cp_loss_reference`, `cp_loss_job`); (c) data parallelism over 2 ranks
    against one process, then `cli.train.main` with --context_parallel_size
    2 (`dp_job`). `parts` picks among a, b and c. Returns (b)'s K1, B1 and B2
    launches on rank 0 of the 3B's loss step."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    log(f"[parallel] the machine shows {cards} card(s): the ranks run over gloo on the first"
        + (", then (a) and (c) again over NCCL, a card a rank" if cards >= 2 else "") + f"; {card}")
    result = {}
    if "a" in parts:
        ring_phase(card, RING_SIZES, nccl=False)
    t_a = time.perf_counter()
    if "b" in parts:
        result["cp_loss_3b_per_rank"] = cp_loss_phase(card)
    t_b = time.perf_counter()
    if "c" in parts:
        dp_phase(card, nccl=False)
    t_c = time.perf_counter()
    if cards >= 2:
        if "a" in parts:
            ring_phase(card, tuple(n for n in RING_SIZES if n <= cards), nccl=True)
        if "c" in parts:
            dp_phase(card, nccl=True)
    log(f"[parallel] phase 13: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, (c) {t_c - t_b:.1f} s"
        + (f", over NCCL {time.perf_counter() - t_c:.1f} s" if cards >= 2 else "") + f"; {card}")
    return result


def ring_phase(card: str, sizes: tuple, nccl: bool) -> None:
    """(a): max(sizes) ranks, each case over the first n of them."""
    ring = spawn_ranks("ring", max(sizes), {"sizes": list(sizes)}, card, nccl)
    cases = [c for r in ring for c in r["cases"]]
    for c in cases:
        if c["rank"] == 0 and c.get("ring_ms") is not None:
            peers = [x["ring_ms"] for x in cases if x["rank"] != 0 and all(
                x[k] == c[k] for k in ("shape", "dtype", "layout", "causal", "n"))]
            log(f"[parallel] (a) {c['shape']} {c['layout']} {'causal' if c['causal'] else 'non-causal'} n={c['n']}: "
                f"ring fwd+bwd {[round(x, 2) for x in [c['ring_ms'], *peers]]} ms by rank against one call's "
                f"{c['one_ms']:.2f} ms; {c['staged_mb']:.1f} MiB staged on rank 0; "
                f"{'nccl' if nccl else 'gloo'}; {card}")


def cp_loss_phase(card: str) -> dict:
    """(b): the one-process reference first, then 2 ranks; returns rank 0's
    K1, B1 and B2 launches of the 3B's loss step."""
    import shutil

    files, ref_root, one = cp_loss_reference(card)
    try:
        cp = spawn_ranks("cp_loss", 2, files, card)
    finally:
        shutil.rmtree(ref_root, ignore_errors=True)
    for tag in files:
        log(f"[parallel] (b) {tag}: peak {[round(r[tag]['peak_gib'], 2) for r in cp]} GiB by rank against one "
            f"process's {one[tag]['peak_gib']:.2f} GiB (phase 12 (c)'s whole step_batch at 36 layers: 43.16 GiB); reference "
            f"forward and loss step {[round(r[tag]['ref_and_step_s'], 2) for r in cp]} s by rank against "
            f"{one[tag]['ref_and_step_s']:.2f} s; {card}")
    return cp[0]["bf16"]["launches"]


def dp_phase(card: str, nccl: bool) -> None:
    """(c): the HF checkpoint and dataset of the CLI run, then 2 ranks."""
    import gc
    import shutil
    import tempfile

    import torch

    cfg = mesh_3b(DP_LAYERS)
    root = tempfile.mkdtemp(prefix="timer1_phase13_cli_")
    try:
        hf = os.path.join(root, "hf")
        cli_hf_checkpoint(cfg, hf)
        gc.collect()
        torch.cuda.empty_cache()
        data = write_dataset(root, "train", 2)
        dp = spawn_ranks("dp", 2, {"hf": hf, "data": data, "out": os.path.join(root, "run")}, card, nccl)
        if sorted(d for d in os.listdir(os.path.join(root, "run")) if d.startswith("epoch-")) != ["epoch-1"]:
            raise AssertionError("cli cp: no epoch-1 checkpoint")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[parallel] (c) dp step_batch at {DP_LAYERS} layers: peak {[round(r['dp']['peak_gib'], 2) for r in dp]} "
        f"GiB by rank; cli cp peak {[round(r['cli']['peak_gib'], 2) for r in dp]} GiB; "
        f"{'nccl' if nccl else 'gloo'}; {card}")


# Phase 14: sharded training (FSDP over "data", TP over "model"), 2 ranks over
# gloo on the first card; (d) and (e) again over NCCL where the machine shows
# several cards, and (f), the 7B over NCCL on 4 cards, from
# scripts/check_parallel.py only.
SHARDED_LAYERS = 2  # (d)'s bf16 depth (36, the 3B's full depth, costs FSDP 75 s a rank over gloo: PERF.md; 4 until
# phase 17 came into the script's time limit)
SHARDED_MESHES = {"fsdp": 1, "tp": 2}  # (d): the model dim of each 2-rank mesh (2x1, 1x2)
STEP_LAYERS = 2  # (e)'s decoder depth at 3B widths (two trainers share the card, the time limit holds)
SEVEN_B_TPS = (1, 2, 4)  # (f): 4x1, 2x2, 1x4 over 4 cards
SHARDED_TIMEOUT = 600  # s: the parent's wait for one spawn of phase 14's ranks
# K1, B1, B2, S1, S2 at the TP-local heads of phase 14's meshes: the 3B's 16
# q over 2 kv heads at tp 2, the 7B's 28 over 4 at tp 4 (one kv head a rank)
TP_ATTN = {"3B_tp2_G8": dict(ATTN_7B, H=8, Hkv=1), "7B_tp4_G7": dict(ATTN_7B, H=7, Hkv=1),
           "3B_tp4_G4": dict(ATTN_7B, H=4, Hkv=1), "3B_tp8_G2": dict(ATTN_7B, H=2, Hkv=1)}  # replicated kv heads
TP_VISION_HEADS = (8, 4, 2)  # K2, K3: the vision tower's 16 heads of 80 at tp 2, 4 and 8


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| over lists of tensors (on any devices)."""
    num = sum(((a.float().to(b.device) - b.float()) ** 2).sum().item() for a, b in zip(got, want))
    den = sum((b.float() ** 2).sum().item() for b in want)
    return (num / max(den, 1e-30)) ** 0.5


def row_spread_reward(completions, **kwargs):
    """A stand-in reward that differs on every row of a group (its index), so
    that the advantages are never all zero whatever the rollouts sampled."""
    return [float(i) for i in range(len(completions))]


def sharded_loss_groups(cfg):
    """(d)'s two rollout groups: phase 13 (b)'s (phase 12 (c)'s request with
    FULL_ROW_ATTN's completions) and a second one from other seeds (phase 4's
    second video request's frames, the same completion lengths)."""
    first = cp_loss_groups(cfg)[0]
    rng = np.random.default_rng(2)
    req = video_request(cfg, np.random.default_rng(3), 32, 224, 392)
    comps = []
    for n in FULL_ROW_ATTN["comps"][::-1]:
        toks = rng.integers(3, 97, n).tolist()
        comps.append(toks[:-1] + [cfg.eos_token_id] if n < 200 else toks)
    return [first, {"prompt_ids": req.input_ids, "completions": comps,
                    "advantages": rng.normal(size=8).astype(np.float32), "patches": req.patches,
                    "grid_thw": req.grid_thw, "second_per_grid_t": 1.0}]


def sharded_loss_cases():
    """(d)'s configurations: Qwen2.5-VL-3B at SHARDED_LAYERS in bf16
    (`mesh_3b`: the tensor-core kernels), and at 2 decoder layers and 4
    vision blocks (the last a full-attention one) in f32 (FMA)."""
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig.qwen25vl_3b()
    small = replace(cfg, text=replace(cfg.text, num_hidden_layers=2),
                    vision=replace(cfg.vision, depth=4, fullatt_block_indexes=(3,)))
    return {"bf16": (mesh_3b(SHARDED_LAYERS), "bfloat16"), "f32_2_layers": (small, "float32")}


def sharded_loss_step(cfg, dtype_name: str, groups, shard=None, group=None) -> tuple:
    """Seeded weights and a reference copy (the same weights: the KL path
    runs, at 0), as this rank's blocks under `shard`; the split batch of
    `groups`; the frozen ViT's pass, the reference log-probs and
    `grpo_value_and_grad` under remat "full" → (loss, metrics, grads, seconds,
    checksum of the first leaves)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_split_batch
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps, grpo_value_and_grad, precompute_frozen_vision

    dtype = getattr(torch, dtype_name)
    trees = []
    for _ in range(2):  # the policy, then its reference copy: each sharded before the next is made
        tree = init_params(cfg, seed=0, device="cuda", dtype=dtype)
        trees.append(tree if shard is None else shard.shard(tree))
        del tree
    params, ref = trees
    hp = GRPOHyperParams(num_generations=8, beta=0.04, fix_vit=True, gradient_checkpointing="full")
    batch = build_grpo_split_batch(cfg, groups, dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = precompute_frozen_vision(params, cfg, batch, shard)
    batch = batch._replace(ref_logps=compute_ref_logps(ref, cfg, hp, batch, shard=shard))
    loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch, group=group, shard=shard)
    torch.cuda.synchronize()
    return loss, metrics, grads, time.perf_counter() - t0


def sharded_loss_launches(cfg) -> dict:
    """(d)'s launches a rank, at its local heads: K1 and S1 in the reference
    forward, the loss and its rerun under remat; B1 once and B2 twice (the
    prompt, the own chunk), S2's two kernels once, a layer; K2/K3 in the
    frozen ViT's one pass."""
    L = cfg.text.num_hidden_layers
    return vision_tc_launches(cfg) | {
        "flash_attention": 3 * L, "shared_prefix_fwd": 3 * L, "flash_bwd_dq": L, "flash_bwd_dkv": 2 * L,
        "shared_prefix_bwd": L, "shared_prefix_bwd_dkv": L}


def sharded_loss_reference(card: str) -> tuple:
    """(d) first, in this process: one process's loss step for each case over
    the groups each mesh trains (FSDP: both groups, a data rank each; TP:
    the first, on both ranks), to a file each; the card is freed before the
    ranks start. Returns ({key: file}, root, {key: numbers})."""
    import gc
    import tempfile

    import torch

    root = tempfile.mkdtemp(prefix="timer1_phase14_ref_")
    files, numbers = {}, {}
    for tag, (cfg, dtype_name) in sharded_loss_cases().items():
        groups = sharded_loss_groups(cfg)
        for mesh, tp in SHARDED_MESHES.items():
            torch.cuda.reset_peak_memory_stats()
            loss, metrics, grads, step_s = sharded_loss_step(cfg, dtype_name, groups if tp == 1 else groups[:1])
            peak = torch.cuda.max_memory_allocated() / 2**30
            ref = dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()}, peak_gib=peak,
                       grads=[g.cpu() for g in grads])
            key = f"{mesh}_{tag}"
            files[key] = os.path.join(root, f"{key}.pt")
            torch.save(ref, files[key])
            numbers[key] = dict(loss=ref["loss"], peak_gib=peak, step_s=step_s)
            log(f"[sharded] (d) one process, {key}: loss {ref['loss']:.6f}; frozen ViT, reference forward and "
                f"loss step {step_s:.2f} s; peak {peak:.2f} GiB; {card}")
            del loss, grads, ref
            gc.collect()
            torch.cuda.empty_cache()
    return files, root, numbers


def sharded_loss_job(args: dict) -> dict:
    """(d) on each of 2 ranks, on each mesh of SHARDED_MESHES in turn (FSDP
    2x1, TP 1x2): the 3B's split loss step over this rank's blocks (FSDP: its
    data rank's group; TP: the first group on both), its launches against the
    formula at the local heads on the tensor cores (bf16) or FMA (f32), the
    peak, the bytes staged through host memory; then the gradients gathered
    leaf by leaf and, on rank 0, held with the loss and metrics against the
    one-process file at CP_BF16_TOL (bf16) or the CPU tests' f32 tolerances."""
    import gc

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.parallel import comm, fsdp, make_mesh
    from time_r1_tpu_torch.parallel.fsdp import gather_whole
    from time_r1_tpu_torch.parallel.sharding import ShardContext
    from time_r1_tpu_torch.rl.grpo import trainable_leaves

    rank = dist.get_rank()
    out = {}
    for (mesh_name, tp), (tag, (cfg, dtype_name)) in itertools.product(SHARDED_MESHES.items(),
                                                                       sharded_loss_cases().items()):
        mesh = make_mesh(tp)
        shard = ShardContext.build(mesh, init_params(cfg, device="meta", dtype=getattr(torch, dtype_name)))
        groups = sharded_loss_groups(cfg)
        groups = [groups[shard.data_rank]] if tp == 1 else groups[:1]
        torch.cuda.reset_peak_memory_stats()
        staged0 = comm.staged_bytes
        fsdp.layer_gathers = 0
        reset_launches()
        loss, metrics, grads, step_s = sharded_loss_step(cfg, dtype_name, groups, shard,
                                                         group=mesh.get_group("data") if shard.dp > 1 else None)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        staged = (comm.staged_bytes - staged0) / 1e9
        key = f"{mesh_name}_{tag}"
        check_tc_route(f"sharded loss {key} rank {rank}", launches, sharded_loss_launches(cfg),
                       tensor_cores=dtype_name == "bfloat16")
        res = dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()}, peak_gib=peak,
                   step_s=step_s, staged_gb=staged, layer_gathers=fsdp.layer_gathers,
                   launches={k: launches[k] for k in sharded_loss_launches(cfg)},
                   grad_block_gib=sum(g.numel() * g.element_size() for g in grads) / 2**30)
        log(f"sharded loss {key}: loss {res['loss']:.6f}; frozen ViT, reference forward and loss step {step_s:.2f} s; "
            f"peak {peak:.2f} GiB on this rank; {staged:.2f} GB staged; {fsdp.layer_gathers} layer gathers; "
            f"gradient blocks {res['grad_block_gib']:.2f} GiB; launches as the formula at "
            f"{cfg.text.num_attention_heads // tp} q over {cfg.text.num_key_value_heads // tp} kv heads")
        specs = trainable_leaves(shard.specs, True)
        gathered = (gather_whole(g, s, shard) for g, s in zip(grads, specs))
        if rank == 0:
            ref = torch.load(args[key], weights_only=False)
            res["vs_one_process"] = cp_against_one(key, dtype_name, res, gathered, ref, what="sharded loss")
            res["one_peak_gib"] = ref["peak_gib"]
            del ref
        else:
            for _ in gathered:
                pass
        del grads, loss, gathered
        gc.collect()
        torch.cuda.empty_cache()
        out[key] = res
        dist.barrier()
    return out


def sharded_step_job(args: dict) -> dict:
    """(e) on each of 2 ranks, at STEP_LAYERS of the 3B (FSDP with
    offload_optimizer is phase 13 (c)'s data-parallel trainer): (1) `step_batch` on a
    1x2 mesh with int8 rollouts (model-rank 0 rolls out over the gathered,
    quantized copy: D2 and Q2 a layer a decode step there and none on rank
    1), the loss equal and the rows bit-equal on both ranks, then on rank 0
    one process's `step_batch` with the completions replayed, against which
    the loss, the metrics and the update are held (DP_TOL); (2)
    `cli.train.main --tensor_parallel_size 2` for 2 step_batch calls."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.parallel import comm, make_mesh
    from time_r1_tpu_torch.rl.grpo import trainable_leaves
    from time_r1_tpu_torch.utils.checkpoint import flatten
    from time_r1_tpu_torch.utils.profiling import PhaseTimers

    rank = dist.get_rank()
    cfg = mesh_3b(STEP_LAYERS)
    L = STEP_LAYERS
    root = tempfile.mkdtemp(prefix=f"timer1_phase14_step{rank}_")
    out = {"layers": L}

    def digest(tr) -> float:
        whole = tr.gathered_params()
        return float(sum(p.detach().float().sum() for p in trainable_leaves(whole, True)))

    # (1) TP 1x2 with int8 rollouts
    mesh = make_mesh(2)
    tr = dp_trainer(cfg, mesh, root, extra_rewards=(row_spread_reward,), rollout_quantization="int8")
    tr.timers = PhaseTimers(sync=True)
    whole0 = tr.gathered_params(keep=rank == 0)  # every rank takes part in the gather; rank 0 keeps it
    # cloned: a leaf whole on every rank comes back as the trainer's own tensor, which the update moves
    w0 = [p.detach().clone() for p in trainable_leaves(whole0, True)] if rank == 0 else None
    del whole0
    recorded, rows, copy_digest = [], [], []
    if tr._rolls_out:
        generate = tr.engine.generate

        def record(requests, sp):
            # the gathered, quantized rollout copy as the rollout reads it (its
            # replicated leaves are the trainer's own, which the update moves)
            copy_digest.extend(float(t.float().sum()) for t in flatten(tr.engine.params).values())
            recorded.append(generate(requests, sp))
            return recorded[-1]

        tr.engine.generate = record
    from time_r1_tpu_torch.rl import trainer as trainer_mod

    build = trainer_mod.build_grpo_split_batch
    trainer_mod.build_grpo_split_batch = lambda *a, **kw: rows.append(build(*a, **kw)) or rows[-1]
    torch.cuda.reset_peak_memory_stats()
    staged0 = comm.staged_bytes
    reset_launches()
    t0 = time.perf_counter()
    info = tr.step_batch([DP_EXAMPLES[0]])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    trainer_mod.build_grpo_split_batch = build
    launches = read_launches()
    if tr._rolls_out:
        comps = recorded[0]
        log(f"tp step_batch rank {rank}: {len(comps)} rollouts of {[len(c) for c in comps]} tokens, "
            f"{len({t for c in comps for t in c})} distinct ids")
    metrics = tr.pop_metrics()
    phases = {k: round(v["total_s"] * 1e3, 1) for k, v in tr.timers.summary().items()}
    decode_steps = tr.engine.timings["decode_steps"] if tr._rolls_out else 0
    steps = [None, None]
    dist.all_gather_object(steps, decode_steps)
    n_steps = steps[0]
    rollout = step_batch_tc_launches(cfg, n_steps) | {k: 2 * v for k, v in vision_tc_launches(cfg).items()}
    if tr._rolls_out:
        want = rollout
        check_step_launches(f"tp step_batch rank {rank}", launches, n_steps, L,
                            {"shared_prefix_decode_full": 1, "fused_mlp_int8": 1})
    else:  # no rollout: the ref forward and the loss only; the frozen ViT once
        want = sharded_loss_launches(cfg) | {"flash_attention": 2 * L, "shared_prefix_fwd": 2 * L}
        if launches["shared_prefix_decode_full"] or launches["fused_mlp_int8"]:
            raise AssertionError(f"tp step_batch rank {rank}: a rank that does not roll out ran D2/Q2")
    check_tc_route(f"tp step_batch rank {rank}", launches, want, tensor_cores=True)
    batch = rows[0]
    row_digest = [float(t.float().sum()) for t in (batch.prompt_ids, batch.comp_ids, batch.comp_mask,
                                                   batch.advantages)]
    losses, digests = [None, None], [None, None]
    dist.all_gather_object(losses, (info["loss"], row_digest))
    dist.all_gather_object(digests, digest(tr))
    if losses[0] != losses[1] or digests[0] != digests[1]:
        raise AssertionError(f"tp step_batch: the ranks differ (loss and rows {losses}, weights {digests})")
    out["tp_int8"] = dict(step_s=step_s, loss=info["loss"], metrics=metrics, phases_ms=phases,
                          weight_sync_ms=phases.get("weight_sync"), decode_steps=n_steps,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          staged_gb=(comm.staged_bytes - staged0) / 1e9, rolls_out=tr._rolls_out)
    log(f"tp step_batch (1x2, int8 rollouts) rank {rank}: {step_s:.2f} s, loss {info['loss']:.6f}, phases (ms) "
        f"{phases}; peak {out['tp_int8']['peak_gib']:.2f} GiB; {out['tp_int8']['staged_gb']:.2f} GB staged; "
        f"{n_steps} decode steps; the ranks' loss, rows and weights equal")
    moved = None
    if rank == 0:
        moved = [p.detach() - w for p, w in zip(trainable_leaves(tr.gathered_params(), True), w0)]
    else:
        tr.gathered_params(keep=False)
    # the first moments, (1 - b1) times the clipped gradient: the step's gradient, gathered to rank 0's host
    mu = tr._gathered_opt_tree(keep=rank == 0)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        one = dp_trainer(cfg, None, root, extra_rewards=(row_spread_reward,), rollout_quantization="int8")
        one_copy = [float(t.float().sum()) for t in flatten(one.engine.params).values()]
        if one_copy != copy_digest:
            raise AssertionError("tp step_batch: the gathered int8 rollout copy differs from one process's")
        replay = [list(c) for c in recorded[0]]
        one.engine.generate = lambda requests, sp: [list(c) for c in replay]
        one_info = one.step_batch([DP_EXAMPLES[0]])
        one_metrics = one.pop_metrics()
        upd = [p.detach() - w for p, w in zip(trainable_leaves(one.params, True), w0)]
        update_err = rel_norm(moved, upd)
        grad_err = rel_norm(mu["mu"], one.opt_state.mu)
        rel = {k: abs(metrics[k] - v) / max(abs(v), DP_TOL["floor"]) for k, v in one_metrics.items()}
        rel["loss"] = abs(info["loss"] - one_info["loss"]) / max(abs(one_info["loss"]), DP_TOL["floor"])
        log(f"tp step_batch against one process: loss {info['loss']:.6f} vs {one_info['loss']:.6f}; relative "
            f"errors {({k: f'{v:.2e}' for k, v in rel.items()})}; gradient (the first moments) ||tp - one|| / "
            f"||one|| {grad_err:.3e}; update {update_err:.3e} (Adam's first step moves a weight by the sign of "
            f"its gradient, so the weights whose gradient is within bf16 noise of 0 may move either way)")
        if set(one_metrics) != set(metrics) or max(rel.values()) > DP_TOL["rel"] or grad_err > CP_BF16_TOL["whole"]:
            raise AssertionError(f"tp step_batch: against one process {rel}, gradient {grad_err}")
        out["tp_int8"]["vs_one_process"] = dict(rel=rel, grad_err=grad_err, update_err=update_err)
        del one, upd, moved, w0, mu
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    # (2) the CLI with --tensor_parallel_size 2
    out["cli"] = tp_cli_run(cfg, args, rank)

    shutil.rmtree(root, ignore_errors=True)
    return out


def tp_cli_run(cfg, args: dict, rank: int) -> dict:
    """(e): `cli.train.main --tensor_parallel_size 2` at (e)'s depth from the
    HF checkpoint the parent wrote, 2 examples of phase 8's clip (2
    step_batch calls, one update, the epoch's save and the final one): per
    step on rank 0 remat_step_launches (the rollout's ViT twice: under a mesh
    nothing is captured), on rank 1 the loss's alone; the ranks' weights
    equal; trainer_state.json written once."""
    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.rl import GRPOTrainer
    from time_r1_tpu_torch.rl.grpo import trainable_leaves

    L = cfg.text.num_hidden_layers
    steps = []

    def counted(original):
        def step_batch(self, examples, requests=None):
            reset_launches()
            t0 = time.perf_counter()
            res = original(self, examples, requests=requests)
            torch.cuda.synchronize()
            steps.append(dict(s=time.perf_counter() - t0, loss=res["loss"], launches=read_launches(),
                              decode_steps=self.engine.timings.get("decode_steps", 0) if self._rolls_out else 0))
            return res
        return step_batch

    torch.cuda.reset_peak_memory_stats()
    with cli_stand_ins(cfg) as cli, patched(GRPOTrainer, "step_batch", counted):
        trainer = cli.main(cli_args(cli, args["hf"], args["out"], args["data"], "--tensor_parallel_size", "2"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, st in enumerate(steps, start=1):
        if rank == 0:
            want = remat_step_launches(cfg, st["decode_steps"]) | {
                k: 2 * v for k, v in vision_tc_launches(cfg).items()}
        else:
            want = sharded_loss_launches(cfg)
        check_tc_route(f"cli tp step_batch {i} rank {rank}", st["launches"], want, tensor_cores=True)
        log(f"cli --tensor_parallel_size 2 step_batch {i}: {st['s']:.2f} s, loss {st['loss']:.6f}")
    whole = trainer.gathered_params()
    digest = float(sum(p.detach().float().sum() for p in trainable_leaves(whole, True)))
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, digest)
    if len(steps) != 2 or trainer.global_step != 2 or len(set(digests)) != 1 or trainer.tp != 2:
        raise AssertionError(f"cli tp: {len(steps)} steps, global_step {trainer.global_step}, digests {digests}")
    with open(os.path.join(args["out"], "trainer_state.json")) as f:
        if json.load(f) != {"global_step": 2}:
            raise AssertionError("cli tp: trainer_state.json is not global_step 2")
    log(f"cli --tensor_parallel_size 2: 2 step_batch calls, the ranks' weights equal, trainer_state.json written; "
        f"peak {peak:.2f} GiB on this rank")
    return dict(step_s=[st["s"] for st in steps], peak_gib=peak)


def seven_b_job(args: dict) -> dict:
    """(f) on each of 4 ranks, a card a rank (NCCL): Qwen2.5-VL-7B's full
    parameters with phase 12 (a)'s configuration but the optimizer state on
    the card (remat, int8 rollouts, beta 0.04 against a reference copy,
    fix_vit, G = 8, 200 tokens, accumulation 2), on each mesh of SEVEN_B_TPS
    in turn: 2 step_batch calls (one update) over phase 8's clip, each data
    rank its own example; the peak per rank, the seconds of each call and its
    weight_sync (the gather and quantization of the rollout copy)."""
    import gc

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.parallel import comm, make_mesh
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.utils.profiling import PhaseTimers
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    rank = dist.get_rank()
    cfg = Qwen25VLConfig.qwen25vl_7b()
    n, fps, _ = INPUT_CLIPS[CLI_CLIP][0]
    examples = [{"problem": f"a person opens door number {i}", "solution": (0.5 + i, 2.5 + i), "durations": n / fps,
                 "video_path": CLI_CLIP} for i in range(2)]
    out = {}
    for tp in args["tps"]:
        mesh = make_mesh(tp)
        d = mesh.get_local_rank("data")
        config = TrainConfig(gradient_checkpointing=True, rollout_quantization="int8", beta=0.04, fix_vit=True,
                             num_generations=8, max_completion_length=200, gradient_accumulation_steps=2,
                             report_to="none")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        ref = to_device(params, torch.device("cuda"))
        processor = Qwen25VLProcessor(StandInTokenizer(cfg), pad_token_id=cfg.pad_token_id,
                                      eos_token_id=cfg.eos_token_id)
        rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], char_parity_reward]
        trainer = GRPOTrainer(params, cfg, processor, rewards, config=config, video_loader=FrameLoader(),
                              ref_params=ref, dtype=torch.bfloat16, mesh=mesh, device="cuda")
        del params, ref
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() / 2**30
        calls = []
        for call in range(2):
            trainer.timers = PhaseTimers(sync=True)
            torch.cuda.reset_peak_memory_stats()
            staged0 = comm.staged_bytes
            t0 = time.perf_counter()
            info = trainer.step_batch([examples[(d + call) % 2]])
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            metrics = trainer.pop_metrics()
            phases = {k: round(v["total_s"] * 1e3, 1) for k, v in trainer.timers.summary().items()}
            st = dict(step_s=step_s, loss=info["loss"], phases_ms=phases, weight_sync_ms=phases.get("weight_sync"),
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30, grad_norm=metrics.get("grad_norm"),
                      staged_gb=(comm.staged_bytes - staged0) / 1e9)
            calls.append(st)
            log(f"[7b sharded] {mesh.size(0)}x{tp} step_batch {call + 1} rank {rank}: {step_s:.2f} s, loss "
                f"{info['loss']:.6f}; phases (ms, synced) {phases}; peak {st['peak_gib']:.2f} GiB")
            if not np.isfinite(info["loss"]):
                raise AssertionError(f"7b sharded {mesh.size(0)}x{tp}: loss {info['loss']}")
        out[f"{mesh.size(0)}x{tp}"] = dict(build_s=build_s, held_gib=held, calls=calls,
                                          updates=trainer.opt_state.count)
        if trainer.opt_state.count != 1:
            raise AssertionError(f"7b sharded {mesh.size(0)}x{tp}: {trainer.opt_state.count} updates")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def sharded_job(args: dict) -> dict:
    """Phase 14 on each of 2 ranks, in one spawn: (d) `sharded_loss_job`,
    then (e) `sharded_step_job`, as args["parts"] asks."""
    out = {}
    if "d" in args["parts"]:
        out["loss"] = sharded_loss_job(args)
    if "e" in args["parts"]:
        out["step"] = sharded_step_job(args)
    return out


def phase_sharded(card: str, parts: str = "de", nccl_only: bool = False) -> dict:
    """Phase 14: sharded training, 2 ranks over gloo on the first card, (d)
    and (e) in one spawn; where the machine shows several cards, again over
    NCCL, a card a rank (nccl_only: NCCL only). (d) the 3B's split loss step
    under remat with a reference copy, as FSDP (2x1) and as TP (1x2),
    against one process's, which runs first (`sharded_loss_reference`,
    `sharded_loss_job`); (e) `step_batch` over TP with int8 rollouts, `cli.train
    --tensor_parallel_size 2` from an HF checkpoint written here, FSDP with
    offload_optimizer (`sharded_step_job`); (f), only when asked and with 4
    cards: the 7B's full parameters over NCCL on 4x1, 2x2 and 1x4
    (`seven_b_job`). Returns (d)'s launches on rank 0 of each mesh."""
    import gc
    import shutil
    import tempfile

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    log(f"[sharded] the machine shows {cards} card(s): the ranks run over gloo on the first"
        + (", then (d) and (e) again over NCCL, a card a rank" if cards >= 2 else "") + f"; {card}")
    result = {}
    routes = ([] if nccl_only and cards >= 2 else [False]) + ([True] if cards >= 2 else [])
    de = "".join(p for p in parts if p in "de")
    files, ref_root, one = sharded_loss_reference(card) if "d" in de else ({}, None, {})
    root = tempfile.mkdtemp(prefix="timer1_phase14_cli_")
    try:
        args = dict(files, parts=de)
        if "e" in de:
            args["hf"] = os.path.join(root, "hf")
            cli_hf_checkpoint(mesh_3b(STEP_LAYERS), args["hf"])
            args["data"] = write_dataset(root, "train", 2)
            gc.collect()
            torch.cuda.empty_cache()
        for nccl in routes if de else ():
            route = "nccl" if nccl else "gloo"
            args["out"] = os.path.join(root, f"run_{route}")
            ranks = spawn_ranks("sharded", 2, args, card, nccl, timeout=SHARDED_TIMEOUT)
            for key in ranks[0].get("loss", {}):
                res = [r["loss"][key] for r in ranks]
                log(f"[sharded] (d) {key} over {route}: peak {[round(r['peak_gib'], 2) for r in res]} GiB by rank "
                    f"against one process's {one[key]['peak_gib']:.2f}; step {[round(r['step_s'], 2) for r in res]} s "
                    f"against {one[key]['step_s']:.2f}; {[round(r['staged_gb'], 2) for r in res]} GB staged; {card}")
                result.setdefault(f"{key}_{route}", res[0]["launches"])
            if "e" in de:
                if sorted(d for d in os.listdir(args["out"]) if d.startswith("epoch-")) != ["epoch-1"]:
                    raise AssertionError("cli tp: no epoch-1 checkpoint")
                step = [r["step"] for r in ranks]
                for part in ("tp_int8",):
                    log(f"[sharded] (e) {part} at {STEP_LAYERS} layers over {route}: step "
                        f"{[round(r[part]['step_s'], 2) for r in step]} s; peak "
                        f"{[round(r[part]['peak_gib'], 2) for r in step]} GiB; "
                        f"{[round(r[part]['staged_gb'], 2) for r in step]} GB staged by rank; {card}")
                log(f"[sharded] (e) weight_sync {step[0]['tp_int8']['weight_sync_ms']} ms on rank 0; cli tp peak "
                    f"{[round(r['cli']['peak_gib'], 2) for r in step]} GiB; {route}; {card}")
        if "f" in parts:
            if cards < 4:
                raise AssertionError(f"(f) needs 4 cards, the machine shows {cards}")
            ranks = spawn_ranks("seven_b", 4, {"tps": list(SEVEN_B_TPS)}, card, nccl=True, timeout=SHARDED_TIMEOUT)
            for mesh in ranks[0]:
                log(f"[sharded] (f) 7B {mesh} over nccl: build {[round(r[mesh]['build_s'], 1) for r in ranks]} s; "
                    f"held after build {[round(r[mesh]['held_gib'], 2) for r in ranks]} GiB; step_batch "
                    f"{[[round(c['step_s'], 2) for c in r[mesh]['calls']] for r in ranks]} s; weight_sync "
                    f"{[[c['weight_sync_ms'] for c in r[mesh]['calls']] for r in ranks]} ms; peak "
                    f"{[max(round(c['peak_gib'], 2) for c in r[mesh]['calls']) for r in ranks]} GiB by rank "
                    f"(phase 12 (a) on one card: 60.54 GiB with 42.80 GiB pinned, 4.1-6.1 s); {card}")
            plan_beside_peak("(f) 4x1", 4, max(c["peak_gib"] for r in ranks for c in r["4x1"]["calls"]),
                             offload=False)
            result["seven_b"] = ranks[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if ref_root is not None:
            shutil.rmtree(ref_root, ignore_errors=True)
    log(f"[sharded] phase 14 ({parts}): {time.perf_counter() - t0:.1f} s; {card}")
    return result

# ---------------------------------------------------------------------------
# phase 15: generation over a mesh (the TP Engine, PPEngine, the eval and demo CLIs)
MESH_LAYERS = 2  # (a), (b)'s bf16 decoder depth at 3B widths (two ranks and one process share the card; 12 until
# phase 16 came into the script's time limit, 6 until phase 17)
MESH_NEW_TOKENS = 16  # phases 15, 16 and (i): 64 until phase 17 came into the script's time limit, 32 before the
# last cuts (PERF.md §4)
# max |mesh - one process| / max |one process| of a row's logits where the two runs' prefixes are equal, for the
# runs held by their logits (`mesh_job`): in bf16 each row-parallel product's partial sums round to bf16 before
# the all-reduce adds them (2 a layer, compounding over MESH_LAYERS: 2.8e-2 at 12 layers on an H100); with int8
# weights Q2 rounds x and its activations to bf16, and the int8 KV cache each K/V vector to 1/127 of its scale,
# so an f32 rounding difference there moves a value by a whole step
MESH_LOGIT_TOL = 5e-2
# the f32 TP Engine over int8 weights, held like the bf16 runs by its logits where the prefixes agree. Readings on an
# H100: 2.90e-3 with the int8 KV cache (its tokens part from one process's at step 39), 2.23e-3 with an f32 one (the
# witness, its tokens all equal and held); both leave MESH_F32_TOL at the first decode step, the first through Q2,
# whose bf16 rounding of x turns TP's f32 summation order into whole bf16 steps (Q2's own partial sums over the
# ranks' blocks agree with the whole MLP's within Q2_PARTIAL_TOL: phase 2)
MESH_INT8_F32_TOL = 1e-2
# every f32 run's prefill logits (before any bf16 rounding or int8 KV read moves a value by a step): readings 1.8e-6
# to 3.7e-6 on an H100
MESH_F32_TOL = 1e-4
MESH_TIMEOUT = 400  # s: the parent's wait for phase 15's spawn
# (name, engine, G, quantization, int8 KV): the TP Engine over make_mesh(2) or PPEngine over 2 stages; G = 1
# serves phase 4's two video requests, G = 8 the first (the TP Engine's shared-prefix decode, D2; PPEngine
# expands the rows); the reference is one process's Engine with the same arguments
MESH_RUNS = (
    ("tp_g1", "tp", 1, None, False),
    ("tp_g8", "tp", 8, None, False),
    ("tp_int8_g8", "tp", 8, "int8", True),
    ("pp_g1", "pp", 1, None, False),
    ("pp_g8", "pp", 8, None, False),
    ("pp_int8_g1", "pp", 1, "int8", False),
    ("tp_int8w_g8", "tp", 8, "int8", False),  # f32 only: the witness, int8 weights over an f32 KV cache
)
MESH_REFS = {"g1": (1, None, False), "g8": (8, None, False), "int8_g8": (8, "int8", True),
             "int8_g1": (1, "int8", False), "int8w_g8": (8, "int8", False)}  # each mesh run's is its name's tail
MESH_F32_ONLY = ("tp_int8w_g8", "int8w_g8")  # runs and references made in f32 only


def mesh_ref_key(name: str) -> str:
    return name.split("_", 1)[1]


def mesh_cases():
    """(a), (b)'s configurations: Qwen2.5-VL-3B at MESH_LAYERS in bf16 (the
    tensor-core kernels, `mesh_3b`'s vision blocks), and at 2 decoder layers
    and 4 vision blocks (the last a full-attention one) in f32 (FMA)."""
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig.qwen25vl_3b()
    small = replace(cfg, text=replace(cfg.text, num_hidden_layers=2),
                    vision=replace(cfg.vision, depth=4, fullatt_block_indexes=(3,)))
    return {"bf16": (mesh_3b(MESH_LAYERS), "bfloat16"), "f32": (small, "float32")}


def mesh_requests(cfg, G: int) -> list:
    """Phase 4's two video requests (G = 1), or the first (G > 1)."""
    rng = np.random.default_rng(0)
    reqs = [video_request(cfg, rng, 32, 224, 392), video_request(cfg, rng, 24, 280, 336)]
    return reqs if G == 1 else reqs[:1]


def mesh_rows(G: int) -> int:
    """The rows whose logits a run records: both requests at G = 1; at G > 1
    the first (greedy: the G rows are alike)."""
    return 2 if G == 1 else 1


def mesh_sampling(G: int):
    from time_r1_tpu_torch.sampler import SamplingParams

    # no stop id: every row takes all MESH_NEW_TOKENS, so that the launches follow from the step count
    return SamplingParams(temperature=0.0, max_new_tokens=MESH_NEW_TOKENS, stop_token_ids=(), num_return_sequences=G)


def recording_pick(eng, store: list, rows=None) -> None:
    """The token choice (`_pick`) of eng (of a continuous engine's prefill
    engine, which picks for it) wrapped to append, where this rank has the
    logits, (logits, tokens) of each pick's first `rows` rows (None: all) to
    `store` on the host, the logits as f32: the prefill's last position,
    then each decode step."""
    inner = getattr(eng, "_prefill_engine", eng)
    original = inner._pick

    def _pick(gen, sp):
        pick = original(gen, sp)

        def recorded(logits, counts, like):
            tok = pick(logits, counts, like)
            if logits is not None:  # a copy: a decode loop writes into `tok` later
                store.append((logits[:rows].float().cpu().clone(), tok[:rows].cpu().clone()))
            return tok

        return recorded

    inner._pick = _pick


def picked_logits(store: list) -> list:
    """The logits of `recording_pick`'s entries."""
    return [lg for lg, _ in store]


def mesh_launches(cfg, kind: str, G: int, quant, kv: bool, stage: int, steps: int) -> dict:
    """One mesh run's launches on a rank: K2/K3 in one vision pass (the TP
    Engine on every rank at its heads; PPEngine on stage 0 only), K1 a layer
    of the rank's in the one prefill chunk, and a layer of the rank's every
    decode step: D2 in the TP Engine's G-way decode, Q2 with int8 weights
    (PPEngine's expanded rows decode through `mha_cached`: no D2)."""
    L = cfg.text.num_hidden_layers // (2 if kind == "pp" else 1)
    vision = vision_tc_launches(cfg) if kind == "tp" or stage == 0 else {n: 0 for n in vision_tc_launches(cfg)}
    out = vision | {"flash_attention": L, "shared_prefix_decode_full": L * steps if kind == "tp" and G > 1 else 0,
                    "fused_mlp_int8": L * steps if quant == "int8" else 0}
    return out


def mesh_reference(card: str) -> tuple:
    """(a), (b) first, in this process: one process's Engine for each
    configuration and each of MESH_REFS, its decode eager as the mesh's is
    (`eager_decode`), the tokens and (bf16 G = 1) each pick's logits to a
    file; then (c)'s one-process records. The card is freed before the
    ranks start. Returns ({key: file}, root, {key: numbers})."""
    import gc
    import tempfile

    import torch

    from time_r1_tpu_torch.cli import demo, evaluate
    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.sampler import Engine

    root = tempfile.mkdtemp(prefix="timer1_phase15_")
    files, numbers = {}, {}
    for tag, (cfg, dtype_name) in mesh_cases().items():
        dtype = getattr(torch, dtype_name)
        params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
        refs = {}
        for key, (G, quant, kv) in MESH_REFS.items():
            if tag != "f32" and key in MESH_F32_ONLY:
                continue
            eng = Engine(params, cfg, dtype=dtype, device="cuda", quantization=quant, kv_cache_quant=kv)
            store = []
            recording_pick(eng, store, mesh_rows(G))
            torch.cuda.reset_peak_memory_stats()
            with eager_decode():
                tokens = eng.generate(mesh_requests(cfg, G), mesh_sampling(G))
            tm = eng.timings
            refs[key] = dict(tokens=tokens, logits=picked_logits(store),
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1))
            numbers[f"{tag}_{key}"] = {k: refs[key][k] for k in ("peak_gib", "decode_ms")}
            log(f"[mesh] one process {tag} {key}: {[len(t) for t in tokens]} tokens, decode "
                f"{refs[key]['decode_ms']:.2f} ms/step (eager), peak {refs[key]['peak_gib']:.2f} GiB; {card}")
            del eng
        files[tag] = os.path.join(root, f"{tag}.pt")
        torch.save(refs, files[tag])
        del params, refs
        gc.collect()
        torch.cuda.empty_cache()

    # (c): the CLIs' one-process records, f32 at 2 decoder layers, from a native checkpoint
    cfg = reduced_config()
    ckpt = os.path.join(root, "ckpt")
    native_checkpoint(ckpt, reduced_params_cpu(), cfg)
    data = write_dataset(root, "eval", 2)
    with cli_stand_ins(cfg), mesh_cli_patches():
        eng = Engine(*evaluate.load_checkpoint(ckpt, device="cuda"), dtype=torch.float32, device="cuda")
        proc = Qwen25VLProcessor.from_pretrained(ckpt)
        recs = read_jsonl(evaluate.main(evaluate.get_args(mesh_eval_argv(ckpt, data, os.path.join(root, "one"))),
                                        eng, proc))
        pred = demo.main(demo.get_args(mesh_demo_argv(ckpt, os.path.join(root, "demo_one"))), eng, proc)
    files["cli"] = dict(ckpt=ckpt, data=data, records=recs, demo=list(pred), root=root)
    log(f"[mesh] (c) one process: {[(r['qid'], r['output_text'][-24:]) for r in recs]}; demo {pred}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # phase 16's references, made here so that its ranks run in this spawn
    files["cmesh"] = cmesh_reference(root, card)
    t0 = time.perf_counter()
    files["cmesh"].update(cli=files["cli"], cli_records=cmesh_cli_reference(files["cli"]))
    files["cmesh"]["seconds"] += time.perf_counter() - t0
    log(f"[mesh16] (e) one process {' '.join(CMESH_CLI_TP)}: "
        f"{[(r['qid'], r['output_text'][-24:]) for r in files['cmesh']['cli_records']]}")
    return files, root, numbers


@contextmanager
def mesh_cli_patches():
    """(c)'s harness, beside `cli_stand_ins`: the checkpoint read in f32
    (the CLIs read bf16; f32 tokens must equal one process's) and the demo's
    video decode from phase 8's seeded frames of CLI_CLIP."""
    import torch

    from time_r1_tpu_torch.cli import demo, evaluate

    loader = FrameLoader()

    def f32(load):
        return lambda path, dtype=torch.bfloat16, device="cuda": load(path, dtype=torch.float32, device=device)

    with patched(evaluate, "load_checkpoint", f32), patched(demo, "load_checkpoint", f32), \
            patched(demo, "fetch_video", lambda fetch: lambda ele: loader({**ele, "video": CLI_CLIP})):
        yield


def mesh_eval_argv(ckpt: str, data: str, out: str, *extra) -> list:
    return ["--model_base", ckpt, "--datasets", "tvgbench_filter", "--split", data, "--output_dir", out,
            "--use_r1_thinking_prompt", "--max_new_tokens", "8", "--total_pixels", str(EVAL_PIXELS[0]),
            "--min_pixels", str(EVAL_PIXELS[1]), "--num_workers", "0", *extra]


def mesh_demo_argv(ckpt: str, out: str, *extra) -> list:
    return ["--model_base", ckpt, "--video_path", CLI_CLIP, "--output_dir", out, "--max_new_tokens", "8",
            "--total_pixels", str(EVAL_PIXELS[0]), "--min_pixels", str(EVAL_PIXELS[1]), *extra]


def held_gib(tree) -> float:
    """The bytes of the storages a tree's tensors hold, each storage once
    (a view holds its whole base), in GiB."""
    import torch

    storages = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()

    walk(tree)
    return sum(storages.values()) / 2**30


def collective_ms(group, shape, dtype, n: int = 50) -> float:
    """Host ms of one `tensor.reduce_from_model` (the TP Engine's all-reduce
    after each row-parallel product) of a `shape` tensor, over n calls
    between two synchronizations."""
    import torch

    from time_r1_tpu_torch.parallel.tensor import reduce_from_model

    y = torch.ones(shape, dtype=dtype, device="cuda")
    for _ in range(5):
        reduce_from_model(y, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        reduce_from_model(y, group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def mesh_job(args: dict) -> dict:
    """Phase 15 on each of 2 ranks: (a) the TP Engine over make_mesh(2) and
    (b) PPEngine over 2 stages, each of MESH_RUNS in each of mesh_cases,
    against one process's file: the launches on this rank by the formula
    (`mesh_launches`), on the tensor cores in bf16 and FMA in f32; the ranks'
    tokens equal; in f32 PPEngine's tokens and the TP Engine's without int8
    equal one process's, as do the witness's (the f32 TP Engine over int8
    weights and an f32 KV cache), and every f32 prefill's logits within
    MESH_F32_TOL; the other runs' logits within MESH_LOGIT_TOL (bf16) or
    MESH_INT8_F32_TOL (the f32 TP Engine over int8) of one process's at
    positions whose prefixes are equal, the tokens that agree counted, and
    in f32 the first decode step whose logits leave MESH_F32_TOL; decode ms a step,
    the bytes staged, the peak and the weights the rank holds. Then (c)
    `mesh_cli_run`."""
    import gc

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.parallel import ShardContext, comm, make_mesh
    from time_r1_tpu_torch.parallel.pipeline import PPEngine
    from time_r1_tpu_torch.sampler import Engine

    rank = dist.get_rank()
    out = {}
    for tag, (cfg, dtype_name) in mesh_cases().items():
        dtype = getattr(torch, dtype_name)
        params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
        refs = torch.load(args[tag], weights_only=False)
        for name, kind, G, quant, kv in MESH_RUNS:
            if tag != "f32" and name in MESH_F32_ONLY:
                continue
            if kind == "tp":
                eng = Engine(params, cfg, dtype=dtype, device="cuda", quantization=quant, kv_cache_quant=kv,
                             shard=ShardContext.build(make_mesh(2), params))
                stage, held = 0, held_gib(eng.params)
            else:
                eng = PPEngine(params, cfg, n_stages=2, dtype=dtype, quantization=quant or "", device="cuda")
                stage, held = eng.stage, held_gib(eng.stage_params) + held_gib(eng.params or {})
            store = []
            recording_pick(eng, store, mesh_rows(G))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            staged0 = comm.staged_bytes
            reset_launches()
            tokens = eng.generate(mesh_requests(cfg, G), mesh_sampling(G))
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            staged = (comm.staged_bytes - staged0) / 1e9
            tm = eng.timings
            want = mesh_launches(cfg, kind, G, quant, kv, stage, tm["decode_steps"])
            check_tc_route(f"mesh {tag} {name} rank {rank}", launches,
                           {k: v for k, v in want.items() if k in TC_KERNELS and v}, tensor_cores=dtype_name == "bfloat16")
            bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
            if bad:
                raise AssertionError(f"mesh {tag} {name} rank {rank}: launches (got, want) {bad}")
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, tokens)
            if any(t != tokens for t in every):
                raise AssertionError(f"mesh {tag} {name}: the ranks' tokens differ")
            ref = refs[mesh_ref_key(name)]
            res = dict(decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1), decode_steps=tm["decode_steps"],
                       prefill_ms=tm["prefill_s"] * 1e3, vision_ms=tm["vision_s"] * 1e3, staged_gb=staged,
                       peak_gib=peak, held_gib=held, one_peak_gib=ref["peak_gib"], one_decode_ms=ref["decode_ms"],
                       launches={k: launches[k] for k in want})
            if kind == "tp":  # a decode step runs 2 a layer
                res["allreduce_ms"] = collective_ms(eng.shard.model_group, (len(tokens), 1, cfg.text.hidden_size),
                                                    dtype)
            agree = [next((i for i, (a, b) in enumerate(zip(t, r)) if a != b), min(len(t), len(r)))
                     for t, r in zip(tokens, ref["tokens"])]
            res["tokens_agree"] = agree
            # f32 holds the tokens where the mesh changes only the order of f32 sums (PP's stages: none; TP without
            # int8) and in the witness (TP over int8 weights, an f32 KV cache); bf16 and TP over int8 hold the
            # logits at positions whose prefixes agree
            order_only = dtype_name == "float32" and (kind == "pp" or quant is None)
            exact = dtype_name == "float32" and (kind == "pp" or not kv)
            if exact and tokens != ref["tokens"]:
                raise AssertionError(f"mesh {tag} {name}: f32 tokens differ from one process's (agree {agree})")
            if store:  # the ranks that sample or see the logits
                errs = []  # each pick's worst row error at a position whose prefix agrees
                for t, (got, want_l) in enumerate(zip(picked_logits(store), ref["logits"])):
                    rows = [b for b in range(got.shape[0]) if t <= agree[b]]
                    errs.append(max(((got[b] - want_l[b]).abs().max() / want_l[b].abs().max()).item() for b in rows)
                                if rows else 0.0)
                res["logit_rel_err"], res["prefill_logit_rel_err"] = max(errs), errs[0]
                limit = MESH_LOGIT_TOL if dtype_name == "bfloat16" else MESH_INT8_F32_TOL
                if dtype_name == "float32":
                    res["leaves_f32_at"] = next((t for t, e in enumerate(errs) if e > MESH_F32_TOL), None)
                    if not errs[0] <= MESH_F32_TOL:
                        raise AssertionError(f"mesh {tag} {name}: prefill logits {errs[0]} apart > {MESH_F32_TOL}")
                if not order_only and not res["logit_rel_err"] <= limit:
                    raise AssertionError(f"mesh {tag} {name}: logits {res['logit_rel_err']} apart > {limit}")
            log(f"mesh {tag} {name}: tokens agree with one process's for {agree} of {MESH_NEW_TOKENS} a row"
                + (f", logits {res['logit_rel_err']:.3e} apart (prefill's {res['prefill_logit_rel_err']:.3e})"
                   if "logit_rel_err" in res else "")
                + (f"; the logits leave {MESH_F32_TOL} at pick {res['leaves_f32_at']}" if "leaves_f32_at" in res else "")
                + f"; decode {res['decode_ms']:.2f} ms/step (one process eager {ref['decode_ms']:.2f}"
                + (f"; one all-reduce of a step {res['allreduce_ms']:.3f} ms" if "allreduce_ms" in res else "") + "); "
                f"{staged:.3f} GB staged; peak {peak:.2f} GiB (one process {ref['peak_gib']:.2f}); holds "
                f"{held:.2f} GiB of weights; launches {res['launches']}")
            out[f"{tag}_{name}"] = res
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        del params, refs
        gc.collect()
        torch.cuda.empty_cache()
    out["cli"] = mesh_cli_run(args["cli"], rank)
    out["cmesh"] = cmesh_job(args["cmesh"], rank)  # phase 16
    return out


def mesh_cli_run(args: dict, rank: int) -> dict:
    """(c) on each rank: `cli.evaluate.main --tensor_parallel_size 2`, then
    `--pipeline_parallel_size 2`, then `cli.demo.main
    --pipeline_parallel_size 2`, from the parent's f32 native checkpoint at 2
    decoder layers; rank 0's records and answer against one process's."""
    import torch

    from time_r1_tpu_torch.cli import demo, evaluate

    cfg = reduced_config()
    out = {}
    with cli_stand_ins(cfg), mesh_cli_patches():
        for flag in ("--tensor_parallel_size", "--pipeline_parallel_size"):
            t0 = time.perf_counter()
            path = evaluate.main(evaluate.get_args(mesh_eval_argv(
                args["ckpt"], args["data"], os.path.join(args["root"], flag.strip("-")), flag, "2")))
            torch.cuda.synchronize()
            out[flag] = time.perf_counter() - t0
            if rank == 0 and read_jsonl(path) != args["records"]:
                raise AssertionError(f"cli.evaluate {flag} 2: the records differ from one process's: "
                                     f"{read_jsonl(path)} against {args['records']}")
        pred = demo.main(demo.get_args(mesh_demo_argv(args["ckpt"], os.path.join(args["root"], "demo_pp"),
                                                      "--pipeline_parallel_size", "2")))
    if list(pred) != args["demo"]:
        raise AssertionError(f"cli.demo --pipeline_parallel_size 2 answered {pred}, one process {args['demo']}")
    log(f"cli.evaluate --tensor_parallel_size 2 {out['--tensor_parallel_size']:.1f} s and "
        f"--pipeline_parallel_size 2 {out['--pipeline_parallel_size']:.1f} s: "
        + ("records equal one process's" if rank == 0 else "rank 0 writes") + "; cli.demo --pipeline_parallel_size 2 "
        f"answers as one process")
    return out


# ---------------------------------------------------------------------------
# phase 16: continuous batching over a mesh (PagedEngine, ContinuousEngine and the int4 TP Engine over shards), run
# in phase 15's spawn against one process's engines made with phase 15's references
CMESH_LAYERS = 2  # the bf16 decoder depth at 3B widths (the f32 runs take mesh_cases' 2 layers; 6 until phase 17)
CMESH_REQUESTS = 8  # phase 7's stream cut to its first 8 requests: both videos and 6 texts
CMESH_CHUNK = 1024  # phase 7's prefill chunk: a video's 2048-token admission interleaves a segment
# (name, engine, G, quantization, int8 KV): the paged and slot engines over the stream, 4 slots; the TP Engine over
# int4 weights on the stream's first two text requests (G = 1: both; G = 8: the first), its vision tower being
# phase 15's (the TP vision tower over gloo stages ~3 GB a video)
CMESH_RUNS = (
    ("paged", "paged", 1, None, False),
    ("paged_int8", "paged", 1, "int8", True),
    ("continuous", "continuous", 1, None, False),
    ("int4_g1", "engine", 1, "int4", False),
    ("int4_g8", "engine", 8, "int4", False),
)
# f32 runs held by their tokens (only the order of f32 sums differs from one process's): the bf16 pool and the slot
# engine. The f32 runs over quantized weights are held by their logits where the prefixes agree, at their own limits:
# int8 as phase 15's TP int8 (Q2 rounds x to bf16); int4 at MESH_F32_TOL until a reading sets it (Q1's f32 route
# rounds nothing, so TP changes only the order of its sums)
CMESH_EXACT_F32 = ("paged", "continuous")
CMESH_F32_LIMITS = {"paged_int8": MESH_INT8_F32_TOL, "int4_g1": MESH_F32_TOL, "int4_g8": MESH_F32_TOL}
# (e): `scripts/test.sh`'s eval flags under TP (TP=2 CONTINUOUS=1 QUANT=int8 KV_DTYPE=int8, BATCH 2 here), and
# PP with the continuous-batching flag, which it ignores
CMESH_CLI_TP = ("--use_continuous_batching", "--kv_block_size", "128", "--quantization", "int8", "--kv_cache_dtype",
                "int8", "--batch_size", "2")


def cmesh_cases():
    """Phase 16's configurations: mesh_cases' with the bf16 decoder at
    CMESH_LAYERS."""
    cases = mesh_cases()
    return {"bf16": (cut_depth(cases["bf16"][0], CMESH_LAYERS), "bfloat16"), "f32": cases["f32"]}


def cmesh_engine(kind: str, params, cfg, dtype, quant, kv, shard=None):
    """A phase-16 engine, over `shard` or in one process."""
    from time_r1_tpu_torch.sampler import ContinuousEngine, Engine, PagedEngine

    kw = dict(dtype=dtype, device="cuda", shard=shard)
    cont = dict(max_slots=4, max_len=4096, segment=16, prefill_chunk_tokens=CMESH_CHUNK)
    if kind == "engine":
        return Engine(params, cfg, quantization=quant, kv_cache_quant=kv, **kw)
    if kind == "paged":
        return PagedEngine(params, cfg, page_size=128, quantization=quant, kv_cache_quant=kv, **cont, **kw)
    return ContinuousEngine(params, cfg, quantization=quant, **cont, **kw)


def cmesh_inputs(cfg, kind: str, G: int, dtype_name: str):
    """A run's requests and sampling: the stream's first CMESH_REQUESTS (in
    f32 its first CMESH_REQUESTS text requests: the TP vision tower in f32 is
    phase 15's), or for the TP Engine its first two text requests (G > 1:
    the first), MESH_NEW_TOKENS greedy tokens, no stop id."""
    stream = stream_requests(cfg)
    texts = [r for r in stream if r.patches is None]
    if kind == "engine":
        reqs = texts[:2 if G == 1 else 1]
    else:
        reqs = (stream if dtype_name == "bfloat16" else texts)[:CMESH_REQUESTS]
    return reqs, mesh_sampling(G)


@contextmanager
def recording_lives(lives: list, admitted: list):
    """The continuous engines' live slots at each decode step, appended to
    `lives` (a (slots,) bool each) before the step's pick: `PagedEngine`'s
    step receives them, `ContinuousEngine`'s are computed in its segment
    from the state it passes (`decode_segment`), at the pick. A dead slot's
    row is computed all the same, over stale state that may read another
    slot's pages: its logits are no output. `admitted` gets each admitted
    request's slot, in the order of the admissions' single-row picks."""
    from time_r1_tpu_torch.sampler import continuous, paged

    one_step, segment = paged._paged_one_step, continuous.decode_segment
    admits = paged.PagedEngine._admit_group, continuous.ContinuousEngine._admit_group

    def paged_admit(self, pool, allocator, admits_, *a, **kw):  # admits_: [(slot, req_idx, Request)], picked in order
        admitted.extend(slot for slot, _, _ in admits_)
        return admits[0](self, pool, allocator, admits_, *a, **kw)

    def slot_admit(self, state, admits_, *a, **kw):
        admitted.extend(slot for slot, _, _ in admits_)
        return admits[1](self, state, admits_, *a, **kw)

    def paged_step(params, pool, cfg, sp, last, start_pos, steps, live, *a, **kw):
        lives.append(live.cpu().clone())
        return one_step(params, pool, cfg, sp, last, start_pos, steps, live, *a, **kw)

    def slot_segment(params, state, cfg, n, sp, generator, active, max_steps, shard=None, pick=None):
        def live_pick(logits, counts, like):
            lives.append((active & ~state.done & (state.steps < max_steps)).cpu().clone())
            return pick(logits, counts, like)

        return segment(params, state, cfg, n, sp, generator, active, max_steps, shard=shard, pick=live_pick)

    paged._paged_one_step, continuous.decode_segment = paged_step, slot_segment
    paged.PagedEngine._admit_group, continuous.ContinuousEngine._admit_group = paged_admit, slot_admit
    try:
        yield
    finally:
        paged._paged_one_step, continuous.decode_segment = one_step, segment
        paged.PagedEngine._admit_group, continuous.ContinuousEngine._admit_group = admits


def pick_errors(store: list, ref: list, lives=None, admitted=None) -> tuple:
    """Each pick's max |got - one| / max |one| over the live rows whose
    every earlier pick agreed with one process's, and how many rows were
    compared; returns (errors, rows compared, the prefills' errors). lives:
    a continuous engine's live slots of each decode step and admitted the
    slot of each admission (`recording_lives`), where a single-row pick is
    an admission's first token (its prefix is the prompt) from the
    prefill's logits, and starts its slot's agreement; None: the `Engine`'s
    picks, every row live, the first from the prefill."""
    import torch

    agree, steps, slots = None, iter(lives or ()), iter(admitted or ())
    errs, firsts, compared = [], [], 0
    for i, ((got, tok), (want, tok_r)) in enumerate(zip(store, ref)):
        first = got.shape[0] == 1 if lives is not None else i == 0
        live = torch.ones(got.shape[0], dtype=torch.bool) if first or lives is None else next(steps)
        ok = live if first or agree is None else live & agree
        rows = [b for b in range(got.shape[0]) if ok[b]]
        compared += len(rows)
        err = max(((got[b] - want[b]).abs().max() / want[b].abs().max()).item() for b in rows) if rows else 0.0
        errs.append(err)
        if first:
            firsts.append(err)
        if first and lives is not None:  # the admitted slot's prefix: its prompt and this token
            if agree is None:
                agree = torch.ones(lives[0].shape[0] if lives else 1, dtype=torch.bool)
            agree[next(slots)] = bool(torch.equal(tok, tok_r))
        else:
            agree = (agree if agree is not None else torch.ones_like(live)) & ((tok == tok_r) | ~live)
    return errs, compared, firsts


def cmesh_launches(cfg, kind: str, G: int, quant, kv: bool, tm: dict, reqs: list) -> dict:
    """A phase-16 run's launches on a rank, from its timings and requests:
    K2/K3 a video admission (the TP Engine's text requests: none), K1 a
    layer per prefill chunk of CMESH_CHUNK (the TP Engine: one chunk, whose
    int4 products run Q1 too when its rows, prompts × bucket, are 256 at
    most), and a layer every decode step:
    P1 over a bf16 / f32 pool, P2 and Q2 over int8 weights and pages, Q1 for
    each of the four int4 products, D2 in the G-way decode; none of them in
    the slot engine's `mha_cached` step."""
    from time_r1_tpu_torch.sampler.engine import _bucket

    L, steps = cfg.text.num_hidden_layers, tm["decode_steps"]
    prefill_q1 = 0
    if kind == "engine":
        videos, chunks = 0, 1
        prefill_q1 = int(len(reqs) * _bucket(max(len(r.input_ids) for r in reqs)) <= 256)
    else:
        videos = sum(v for _, _, v in tm["admissions"])
        chunks = sum(-(-S // CMESH_CHUNK) for _, S, _ in tm["admissions"])
    out = {k: v * videos for k, v in vision_tc_launches(cfg).items()}
    out.update(flash_attention=L * chunks, paged_prefix_attention=0, paged_prefix_attention_q8=0, fused_mlp_int8=0,
               int4_matmul=0, shared_prefix_decode_full=0)
    if kind == "paged":
        out["paged_prefix_attention_q8" if kv else "paged_prefix_attention"] = L * steps
    if quant == "int8":
        out["fused_mlp_int8"] = L * steps
    if quant == "int4":
        out["int4_matmul"] = 4 * L * (steps + prefill_q1)
    if kind == "engine" and G > 1:
        out["shared_prefix_decode_full"] = L * steps
    return out


def cmesh_reference(root: str, card: str) -> dict:
    """Phase 16's one-process references, in the parent before phase 15's
    spawn: each of CMESH_RUNS in each of cmesh_cases, decoded eagerly as the
    mesh's (`eager_decode`), its tokens, its picks' logits and tokens, decode
    ms a step and peak to a file; then (e)'s records: `cli.evaluate` with
    CMESH_CLI_TP over an f32 int8 engine with an int8 KV cache, from phase
    15's checkpoint (the caller's `cli`). Returns {"file", "cli_records",
    "seconds"}."""
    import gc

    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params

    t0 = time.perf_counter()
    refs = {}
    for tag, (cfg, dtype_name) in cmesh_cases().items():
        dtype = getattr(torch, dtype_name)
        params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
        for name, kind, G, quant, kv in CMESH_RUNS:
            eng = cmesh_engine(kind, params, cfg, dtype, quant, kv)
            reqs, sp = cmesh_inputs(cfg, kind, G, dtype_name)
            store, lives, admitted = [], [], []
            recording_pick(eng, store, mesh_rows(G) if kind == "engine" else None)
            torch.cuda.reset_peak_memory_stats()
            with eager_decode(), recording_lives(lives, admitted):
                tokens = eng.generate(reqs, sp)
            tm = eng.timings
            refs[f"{tag}_{name}"] = dict(tokens=tokens, picks=store, lives=lives, admitted=admitted,
                                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                         decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1))
            log(f"[mesh16] one process {tag} {name}: {sum(len(t) for t in tokens)} tokens over {len(tokens)} rows, "
                f"decode {refs[f'{tag}_{name}']['decode_ms']:.2f} ms/step (eager), peak "
                f"{refs[f'{tag}_{name}']['peak_gib']:.2f} GiB; {card}")
            del eng
        del params
        gc.collect()
        torch.cuda.empty_cache()
    path = os.path.join(root, "cmesh.pt")
    torch.save(refs, path)
    return {"file": path, "seconds": time.perf_counter() - t0}


def cmesh_cli_reference(cli: dict) -> list:
    """(e)'s one-process records: `cli.evaluate` with CMESH_CLI_TP (no mesh)
    over an f32 engine with int8 weights and an int8 KV cache."""
    import gc

    import torch

    from time_r1_tpu_torch.cli import evaluate
    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.sampler import Engine

    cfg = reduced_config()
    with cli_stand_ins(cfg), mesh_cli_patches():
        params, ckpt_cfg = evaluate.load_checkpoint(cli["ckpt"], device="cuda")
        eng = Engine(params, ckpt_cfg, dtype=torch.float32, device="cuda", quantization="int8", kv_cache_quant=True)
        proc = Qwen25VLProcessor.from_pretrained(cli["ckpt"])
        recs = read_jsonl(evaluate.main(evaluate.get_args(mesh_eval_argv(
            cli["ckpt"], cli["data"], os.path.join(cli["root"], "one16"), *CMESH_CLI_TP)), eng, proc))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def cmesh_job(args: dict, rank: int) -> dict:
    """Phase 16 on each of 2 ranks: each of CMESH_RUNS in each of
    cmesh_cases over make_mesh(2) (the engines over the whole tree, the
    int8 paged engine over a TP Engine's serving tree as the eval builds
    it), against one process's: the launches on this rank by the formula
    (`cmesh_launches`; tensor cores in bf16, FMA in f32), the ranks' tokens
    equal; CMESH_EXACT_F32's f32 tokens equal one process's; every bf16 run's
    logits within MESH_LOGIT_TOL and the f32 quantized runs' within
    CMESH_F32_LIMITS where the prefixes agree, every f32 admission's prefill
    logits within MESH_F32_TOL; decode ms a step, bytes staged, the weights
    held and the peak. Then (e) `cmesh_cli_run`."""
    import gc

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.parallel import ShardContext, comm, make_mesh
    from time_r1_tpu_torch.sampler import Engine, PagedEngine

    t0 = time.perf_counter()
    refs = torch.load(args["file"], weights_only=False)
    out = {}
    for tag, (cfg, dtype_name) in cmesh_cases().items():
        dtype = getattr(torch, dtype_name)
        params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
        shard = ShardContext.build(make_mesh(2), params)
        for name, kind, G, quant, kv in CMESH_RUNS:
            if name == "paged_int8":  # the eval's route: the paged engine over its TP Engine's serving tree
                tree = Engine(params, cfg, dtype=dtype, device="cuda", quantization=quant, shard=shard).params
                eng = PagedEngine(tree, cfg, max_slots=4, max_len=4096, segment=16, prefill_chunk_tokens=CMESH_CHUNK,
                                  page_size=128, kv_cache_quant=kv, dtype=dtype, device="cuda", shard=shard)
                del tree
            else:
                eng = cmesh_engine(kind, params, cfg, dtype, quant, kv, shard)
            held = held_gib(eng.params)
            reqs, sp = cmesh_inputs(cfg, kind, G, dtype_name)
            store, lives, admitted = [], [], []
            recording_pick(eng, store, mesh_rows(G) if kind == "engine" else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            staged0 = comm.staged_bytes
            reset_launches()
            with recording_lives(lives, admitted):
                tokens = eng.generate(reqs, sp)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            tm = eng.timings
            label = f"mesh16 {tag} {name} rank {rank}"
            want = cmesh_launches(cfg, kind, G, quant, kv, tm, reqs)
            check_tc_route(label, launches, {k: v for k, v in want.items() if k in TC_KERNELS and v},
                           tensor_cores=dtype_name == "bfloat16")
            bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
            if bad:
                raise AssertionError(f"{label}: launches (got, want) {bad}")
            if any(len(t) != MESH_NEW_TOKENS for t in tokens):
                raise AssertionError(f"{label}: rows of {[len(t) for t in tokens]} tokens, want {MESH_NEW_TOKENS}")
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, tokens)
            if any(t != tokens for t in every):
                raise AssertionError(f"mesh16 {tag} {name}: the ranks' tokens differ")
            ref = refs[f"{tag}_{name}"]
            agree = [next((i for i, (a, b) in enumerate(zip(t, r)) if a != b), min(len(t), len(r)))
                     for t, r in zip(tokens, ref["tokens"])]
            if dtype_name == "float32" and name in CMESH_EXACT_F32 and tokens != ref["tokens"]:
                raise AssertionError(f"{label}: f32 tokens differ from one process's (agree {agree})")
            if kind != "engine" and not (admitted == ref["admitted"] and
                                         all(torch.equal(a, b) for a, b in zip(lives, ref["lives"]))):
                raise AssertionError(f"{label}: the live slots differ from one process's (no stop id: the schedule "
                                     f"follows from the lengths)")
            errs, compared, firsts = pick_errors(store, ref["picks"], *((lives, admitted) if kind != "engine" else ()))
            res = dict(decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1), decode_steps=tm["decode_steps"],
                       prefill_ms=tm["prefill_s"] * 1e3, staged_gb=(comm.staged_bytes - staged0) / 1e9,
                       peak_gib=peak, held_gib=held, one_peak_gib=ref["peak_gib"], one_decode_ms=ref["decode_ms"],
                       launches={k: launches[k] for k in want}, tokens_agree=agree, logit_rel_err=max(errs),
                       prefill_logit_rel_err=max(firsts), picks_compared=compared)
            limit = MESH_LOGIT_TOL if dtype_name == "bfloat16" else CMESH_F32_LIMITS.get(name)
            if dtype_name == "float32" and not res["prefill_logit_rel_err"] <= MESH_F32_TOL:
                raise AssertionError(f"{label}: prefill logits {res['prefill_logit_rel_err']} apart > {MESH_F32_TOL}")
            if limit is not None and not res["logit_rel_err"] <= limit:
                raise AssertionError(f"{label}: logits {res['logit_rel_err']} apart > {limit}")
            log(f"{label}: tokens agree with one process's for {agree} of {MESH_NEW_TOKENS}, logits "
                f"{res['logit_rel_err']:.3e} apart over {compared} rows of picks (the prefills' "
                f"{res['prefill_logit_rel_err']:.3e}); decode {res['decode_ms']:.2f} ms/step (one process eager "
                f"{ref['decode_ms']:.2f}); {res['staged_gb']:.3f} GB staged; peak {peak:.2f} GiB (one process "
                f"{ref['peak_gib']:.2f}); holds {held:.2f} GiB of weights; launches {res['launches']}")
            out[f"{tag}_{name}"] = res
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        del params, shard
        gc.collect()
        torch.cuda.empty_cache()
    out["cli"] = cmesh_cli_run(args, rank)
    out["seconds"] = time.perf_counter() - t0
    return out


def cmesh_cli_run(args: dict, rank: int) -> dict:
    """(e) on each rank: `cli.evaluate.main --tensor_parallel_size 2` with
    CMESH_CLI_TP, and `--pipeline_parallel_size 2 --use_continuous_batching`,
    from phase 15's f32 checkpoint at 2 decoder layers: rank 0's records
    against one process's with the same flags, and against phase 15's
    one-process records (the bucket engine's, which PP's equal)."""
    import torch

    from time_r1_tpu_torch.cli import evaluate

    cli = args["cli"]
    out = {}
    with cli_stand_ins(reduced_config()), mesh_cli_patches():
        for tag, extra, want in (("tp2", ("--tensor_parallel_size", "2", *CMESH_CLI_TP), args["cli_records"]),
                                 ("pp2", ("--pipeline_parallel_size", "2", "--use_continuous_batching"),
                                  cli["records"])):
            t0 = time.perf_counter()
            path = evaluate.main(evaluate.get_args(mesh_eval_argv(cli["ckpt"], cli["data"],
                                                                  os.path.join(cli["root"], f"{tag}_16"), *extra)))
            torch.cuda.synchronize()
            out[tag] = time.perf_counter() - t0
            if rank == 0 and read_jsonl(path) != want:
                raise AssertionError(f"cli.evaluate {' '.join(extra)}: the records differ from one process's: "
                                     f"{read_jsonl(path)} against {want}")
    log(f"[mesh16] (e) cli.evaluate --tensor_parallel_size 2 {' '.join(CMESH_CLI_TP)} {out['tp2']:.1f} s, "
        f"--pipeline_parallel_size 2 --use_continuous_batching {out['pp2']:.1f} s: "
        + ("records equal one process's" if rank == 0 else "rank 0 writes"))
    return out


def phase_mesh_serving(card: str, nccl_only: bool = False) -> dict:
    """Phases 15 and 16: generation over a mesh, 2 ranks over gloo on the
    first card (and again over NCCL, a card a rank, where the machine shows
    two or more; nccl_only: NCCL only): one process's references first
    (`mesh_reference`, phase 16's too), then phase 15's (a), (b), (c) and
    phase 16 in one spawn (`mesh_job`). Returns rank 0's and rank 1's
    launches of each bf16 run over gloo, phase 16's under "cmesh"."""
    import shutil

    import torch

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    files, root, one = mesh_reference(card)
    result = {}
    try:
        routes = ([] if nccl_only and cards >= 2 else [False]) + ([True] if cards >= 2 else [])
        for nccl in routes:
            route = "nccl" if nccl else "gloo"
            ranks = spawn_ranks("mesh", 2, files, card, nccl, timeout=MESH_TIMEOUT)
            for key in ranks[0]:
                if key in ("cli", "cmesh"):
                    continue
                res = [r[key] for r in ranks]
                log(f"[mesh] {key} over {route}: decode {[round(r['decode_ms'], 2) for r in res]} ms/step by rank "
                    f"(one process eager {res[0]['one_decode_ms']:.2f}"
                    + (f"; one all-reduce of a step {[round(r['allreduce_ms'], 3) for r in res]} ms"
                       if "allreduce_ms" in res[0] else "") + "); prefill "
                    f"{[round(r['prefill_ms'], 1) for r in res]} ms; {[round(r['staged_gb'], 3) for r in res]} GB "
                    f"staged; peak {[round(r['peak_gib'], 2) for r in res]} GiB (one process "
                    f"{res[0]['one_peak_gib']:.2f}); weights held {[round(r['held_gib'], 2) for r in res]} GiB; "
                    f"tokens agree {res[0]['tokens_agree']}"
                    + (f"; logits {res[0]['logit_rel_err']:.3e} apart" if "logit_rel_err" in res[0] else "")
                    + f"; {card}")
                if not nccl and key.startswith("bf16_"):
                    result[key] = res[0]["launches"]
                    result[f"{key}_rank1"] = res[1]["launches"]
            log(f"[mesh] (c) over {route}: evaluate tp 2 {ranks[0]['cli']['--tensor_parallel_size']:.1f} s, "
                f"pp 2 {ranks[0]['cli']['--pipeline_parallel_size']:.1f} s; the records and the demo's answer equal "
                f"one process's; {card}")
            cm = [r["cmesh"] for r in ranks]
            for key in cm[0]:
                if key in ("cli", "seconds"):
                    continue
                res = [c[key] for c in cm]
                log(f"[mesh16] {key} over {route}: decode {[round(r['decode_ms'], 2) for r in res]} ms/step by rank "
                    f"(one process eager {res[0]['one_decode_ms']:.2f}); prefill {[round(r['prefill_ms'], 1) for r in res]}"
                    f" ms; {[round(r['staged_gb'], 3) for r in res]} GB staged; peak "
                    f"{[round(r['peak_gib'], 2) for r in res]} GiB (one process {res[0]['one_peak_gib']:.2f}); weights "
                    f"held {[round(r['held_gib'], 2) for r in res]} GiB; tokens agree {res[0]['tokens_agree']}; logits "
                    f"{res[0]['logit_rel_err']:.3e} apart (prefills {res[0]['prefill_logit_rel_err']:.3e}); {card}")
                if not nccl and key.startswith("bf16_"):
                    result.setdefault("cmesh", {})[key] = [r["launches"] for r in res]
            seconds = files["cmesh"]["seconds"] + max(c["seconds"] for c in cm)
            log(f"[mesh16] phase 16 over {route}: {seconds:.1f} s (one process's references "
                f"{files['cmesh']['seconds']:.1f}, the ranks' {max(c['seconds'] for c in cm):.1f}); (e) tp 2 "
                f"{cm[0]['cli']['tp2']:.1f} s, pp 2 {cm[0]['cli']['pp2']:.1f} s; {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[mesh] phase 15: {time.perf_counter() - t0:.1f} s; {card}")
    return result


# (g): Qwen2.5-VL-7B served over 4 cards (NCCL): (mesh, pipeline stages, tp)
SEVEN_B_MESHES = (("tp4", 1, 4), ("pp4", 4, 1), ("tp2xpp2", 2, 2))
SEVEN_B_F32_LAYERS = 4  # (g)'s f32 decoder depth (4 vision blocks, the last a full-attention one), as phase 15's f32
# (g)'s bf16 logits at full depth against one card's where the prefixes agree: MESH_LOGIT_TOL scaled by the square
# root of the bf16 partial-sum roundings' count against phase 15's (28 layers × 2 all-reduces × 4 partial sums over
# 12 × 2 × 2: ×2.2). Reading on an H100 at tp 4: 5.68e-2. The f32 run at SEVEN_B_F32_LAYERS holds the tokens and
# every logit within MESH_F32_TOL: a fault in TP at the 7B's heads shows there, not under bf16's rounding
SEVEN_B_LOGIT_TOL = 1e-1


def seven_b_cases() -> dict:
    """(g)'s configurations: the 7B at full depth in bf16 (the tensor-core
    kernels, the peaks) and at SEVEN_B_F32_LAYERS in f32 (FMA)."""
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig.qwen25vl_7b()
    small = replace(cut_depth(cfg, SEVEN_B_F32_LAYERS), vision=replace(cfg.vision, depth=4, fullatt_block_indexes=(3,)))
    return {"bf16": (cfg, "bfloat16"), "f32": (small, "float32")}


def seven_b_serving_launches(cfg, stages: int, tp: int, rank: int) -> dict:
    """(g)'s launches on a rank: K1 a layer of its stage in the one prefill
    chunk, K2/K3 in one vision pass on every rank of the TP Engine and on
    stage 0's ranks of PPEngine; no decode kernel at G = 1."""
    vision = vision_tc_launches(cfg)
    if stages > 1 and rank // tp != 0:
        vision = {n: 0 for n in vision}
    return vision | {"flash_attention": cfg.text.num_hidden_layers // stages}


def seven_b_serving_job(args: dict) -> dict:
    """(g) on each of 4 ranks, a card a rank (NCCL): the 7B's seeded weights
    of each of seven_b_cases served on each of SEVEN_B_MESHES (the TP Engine
    at tp 4, 7 q over 1 kv head a rank; PPEngine at 4 stages; PPEngine at 2
    stages of tp 2), phase 4's two video requests, greedy, MESH_NEW_TOKENS:
    the launches by the formula (tensor cores in bf16, FMA in f32), the
    ranks' tokens equal, how many agree with one card's, the prefill's and
    each decode step's logits, on the ranks that hold them, against one
    card's where the prefixes agree: within SEVEN_B_LOGIT_TOL in bf16; in
    f32 the tokens equal and every logit within MESH_F32_TOL. Also the
    decode ms a step, the weights held and the peak a rank (the whole tree
    freed before the generate) against one card's."""
    import gc

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.parallel import ShardContext, make_mesh
    from time_r1_tpu_torch.parallel.pipeline import PPEngine
    from time_r1_tpu_torch.sampler import Engine

    rank = dist.get_rank()
    refs = torch.load(args["file"], weights_only=False)
    out = {}
    for tag, (cfg, dtype_name) in seven_b_cases().items():
        dtype, ref = getattr(torch, dtype_name), refs[tag]
        for mesh_name, stages, tp in SEVEN_B_MESHES:
            params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
            if stages == 1:
                eng = Engine(params, cfg, dtype=dtype, device="cuda", shard=ShardContext.build(make_mesh(tp), params))
            else:
                eng = PPEngine(params, cfg, n_stages=stages, dtype=dtype, tp=tp, device="cuda")
            del params
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() / 2**30
            store = []
            recording_pick(eng, store, 2)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            tokens = eng.generate(mesh_requests(cfg, 1), mesh_sampling(1))
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            name = f"{tag} {mesh_name} rank {rank}"
            want = seven_b_serving_launches(cfg, stages, tp, rank)
            check_tc_route(f"7b serving {name}", launches, {k: v for k, v in want.items() if v},
                           tensor_cores=dtype_name == "bfloat16")
            bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
            if bad:
                raise AssertionError(f"7b serving {name}: launches (got, want) {bad}")
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, tokens)
            if any(t != tokens for t in every):
                raise AssertionError(f"7b serving {tag} {mesh_name}: the ranks' tokens differ")
            agree = [next((i for i, (a, b) in enumerate(zip(t, r)) if a != b), min(len(t), len(r)))
                     for t, r in zip(tokens, ref["tokens"])]
            if dtype_name == "float32" and tokens != ref["tokens"]:
                raise AssertionError(f"7b serving {name}: f32 tokens differ from one card's (agree {agree})")
            tm = eng.timings
            res = dict(held_gib=held, peak_gib=peak, decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1),
                       prefill_ms=tm["prefill_s"] * 1e3, vision_ms=tm["vision_s"] * 1e3, tokens_agree=agree,
                       launches={k: launches[k] for k in want})
            if store:  # the ranks that see the logits: every TP rank, stage 0's under PP
                errs = [((got[b] - want_l[b]).abs().max() / want_l[b].abs().max()).item()
                        for t, (got, want_l) in enumerate(zip(picked_logits(store), ref["logits"])) for b in range(2)
                        if t <= agree[b]]
                res["logit_rel_err"], res["prefill_logit_rel_err"] = max(errs), max(errs[:2])
                limit = SEVEN_B_LOGIT_TOL if dtype_name == "bfloat16" else MESH_F32_TOL
                if not res["logit_rel_err"] <= limit:
                    raise AssertionError(f"7b serving {name}: logits {res['logit_rel_err']} apart > {limit}")
            if stages == 1:
                res["allreduce_ms"] = collective_ms(eng.shard.model_group, (2, 1, cfg.text.hidden_size), dtype)
            log(f"[7b serving] {name}: holds {held:.2f} GiB, peak {peak:.2f} GiB (one card {ref['peak_gib']:.2f}); "
                f"decode {res['decode_ms']:.2f} ms/step (one card eager {ref['decode_ms']:.2f}"
                + (f"; one all-reduce of a step {res['allreduce_ms']:.3f} ms" if "allreduce_ms" in res else "") + "); "
                f"prefill {res['prefill_ms']:.1f} ms; tokens agree with one card's for {agree} of {MESH_NEW_TOKENS}"
                + (f", logits {res['logit_rel_err']:.3e} apart where the prefixes agree (the prefill's "
                   f"{res['prefill_logit_rel_err']:.3e})" if "logit_rel_err" in res else ""))
            out[f"{tag}_{mesh_name}"] = res
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
    return out


def phase_mesh_7b(card: str) -> dict:
    """(g), on 4 cards only: one card's eager Engine over each of
    seven_b_cases first (its tokens, each pick's logits, peak and decode ms,
    to a file), then `seven_b_serving_job` over NCCL."""
    import gc
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.sampler import Engine

    cards = torch.cuda.device_count()
    if cards < 4:
        raise AssertionError(f"(g) needs 4 cards, the machine shows {cards}")
    t0 = time.perf_counter()
    refs = {}
    for tag, (cfg, dtype_name) in seven_b_cases().items():
        dtype = getattr(torch, dtype_name)
        eng = Engine(init_params(cfg, seed=0, device="cuda", dtype=dtype), cfg, dtype=dtype, device="cuda")
        store = []
        recording_pick(eng, store, 2)
        torch.cuda.reset_peak_memory_stats()
        with eager_decode():
            tokens = eng.generate(mesh_requests(cfg, 1), mesh_sampling(1))
        refs[tag] = dict(tokens=tokens, logits=picked_logits(store), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         decode_ms=eng.timings["decode_s"] * 1e3 / max(eng.timings["decode_steps"], 1))
        log(f"[7b serving] one card {tag}: peak {refs[tag]['peak_gib']:.2f} GiB, decode {refs[tag]['decode_ms']:.2f} "
            f"ms/step (eager); {card}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="timer1_7b_serving_")
    try:
        torch.save(refs, os.path.join(root, "refs.pt"))
        ranks = spawn_ranks("seven_b_serving", 4, {"file": os.path.join(root, "refs.pt")}, card, nccl=True,
                            timeout=SHARDED_TIMEOUT)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for key in ranks[0]:
        res, one = [r[key] for r in ranks], refs[key.split("_", 1)[0]]
        log(f"[7b serving] {key} over nccl: held {[round(r['held_gib'], 2) for r in res]} GiB, peak "
            f"{[round(r['peak_gib'], 2) for r in res]} GiB by rank (one card {one['peak_gib']:.2f}); decode "
            f"{[round(r['decode_ms'], 2) for r in res]} ms/step (one card eager {one['decode_ms']:.2f}"
            + (f"; one all-reduce of a step {[round(r['allreduce_ms'], 3) for r in res]} ms"
               if "allreduce_ms" in res[0] else "") + "); tokens agree "
            f"{res[0]['tokens_agree']}; logits {[round(r['logit_rel_err'], 7) for r in res if 'logit_rel_err' in r]} "
            f"apart by rank that holds them; {card}")
    log(f"[7b serving] (g): {time.perf_counter() - t0:.1f} s; {card}")
    return {"one": {tag: {k: v for k, v in r.items() if k not in ("tokens", "logits")} for tag, r in refs.items()},
            "ranks": ranks}


# (i): Qwen2.5-VL-7B at full depth served through `cli.evaluate` at tp 4 over NCCL (4 cards) with `scripts/test.sh`'s
# eval flags (TP=4 CONTINUOUS=1 QUANT=... KV_DTYPE=int8; BATCH 4 and 64 new tokens here, the script's 1024 would
# only lengthen the run), int8 and int4 weights, against one card's `cli.evaluate` with the same flags but TP
EVAL_7B_ITEMS = 4
EVAL_7B_FLAGS = ("--use_vllm_inference", "--use_continuous_batching", "--kv_block_size", "128", "--kv_cache_dtype",
                 "int8", "--batch_size", "4")
EVAL_7B_QUANTS = ("int8", "int4")


def eval_7b_argv(ckpt: str, data: str, out: str, quant: str, *extra) -> list:
    argv = mesh_eval_argv(ckpt, data, out, *EVAL_7B_FLAGS, "--quantization", quant, *extra)
    argv[argv.index("--max_new_tokens") + 1] = str(MESH_NEW_TOKENS)
    return argv


@contextmanager
def spied_generation_engine(store: list):
    """`cli.evaluate`'s generation engine, kept in `store` as it is made."""
    from time_r1_tpu_torch.cli import evaluate

    with patched(evaluate, "make_generation_engine",
                 lambda make: lambda *a, **kw: store.append(make(*a, **kw)) or store[-1]):
        yield


def eval_7b_run(args: dict, quant: str, tp: int) -> dict:
    """One `cli.evaluate.main` of (i) (tp 1: one card, in the parent), its
    records, the generation engine's decode ms a step, the weights it holds
    and the card's peak."""
    import torch

    from time_r1_tpu_torch.cli import evaluate
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    made: list = []
    extra = ("--tensor_parallel_size", str(tp)) if tp > 1 else ()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cli_stand_ins(Qwen25VLConfig.qwen25vl_7b()), spied_generation_engine(made):
        path = evaluate.main(evaluate.get_args(eval_7b_argv(args["ckpt"], args["data"],
                                                            os.path.join(args["root"], f"{quant}_tp{tp}"), quant,
                                                            *extra)))
    torch.cuda.synchronize()
    eng = made[0]
    tm = eng.timings
    return dict(records=read_jsonl(path) if os.path.exists(path) else None, seconds=time.perf_counter() - t0,
                decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1), decode_steps=tm["decode_steps"],
                prefill_s=tm["prefill_s"], held_gib=held_gib(eng.params),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def eval_7b_job(args: dict) -> dict:
    """(i) on each of 4 ranks, a card a rank (NCCL): `cli.evaluate.main`
    with --tensor_parallel_size 4 and EVAL_7B_FLAGS over each of
    EVAL_7B_QUANTS; rank 0's records against one card's (the output texts
    that agree counted: bf16 over 28 layers and 4-way partial sums may part
    at a near tie), the generation engine's decode ms a step, the weights
    held and the peak on every rank."""
    import gc

    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {}
    for quant in EVAL_7B_QUANTS:
        res = eval_7b_run(args, quant, 4)
        one = args["one"][quant]
        if rank == 0:
            if [r["qid"] for r in res["records"]] != [r["qid"] for r in one["records"]]:
                raise AssertionError(f"(i) {quant}: the records' qids differ from one card's")
            res["texts_equal"] = sum(a["output_text"] == b["output_text"] for a, b in zip(res["records"],
                                                                                           one["records"]))
            res["preds_equal"] = sum(a["pred"] == b["pred"] for a, b in zip(res["records"], one["records"]))
        log(f"[eval 7b] tp 4 {quant} rank {rank}: {res['seconds']:.1f} s; decode {res['decode_ms']:.2f} ms/step over "
            f"{res['decode_steps']} steps (one card {one['decode_ms']:.2f}); holds {res['held_gib']:.2f} GiB of "
            f"weights (one card {one['held_gib']:.2f}), peak {res['peak_gib']:.2f} GiB (one card "
            f"{one['peak_gib']:.2f})" + (f"; output texts equal to one card's {res['texts_equal']} of "
                                         f"{len(res['records'])}, preds {res['preds_equal']}" if rank == 0 else ""))
        if rank == 0:
            for r in res["records"]:
                log(f"[eval 7b] tp 4 {quant} record {r['qid']}: pred {r['pred']}, text {r['output_text'][-40:]!r}")
        out[quant] = {k: v for k, v in res.items() if k != "records"}
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def phase_eval_7b(card: str) -> dict:
    """(i), on 4 cards only: the 7B's seeded bf16 weights written as a native
    checkpoint, one card's `cli.evaluate.main` with EVAL_7B_FLAGS over each of
    EVAL_7B_QUANTS (the records, decode ms, weights and peak), then
    `eval_7b_job` over NCCL. Writes ~16 GB under TMPDIR, deleted at the
    end."""
    import gc
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params

    cards = torch.cuda.device_count()
    if cards < 4:
        raise AssertionError(f"(i) needs 4 cards, the machine shows {cards}")
    t0 = time.perf_counter()
    cfg = Qwen25VLConfig.qwen25vl_7b()
    root = tempfile.mkdtemp(prefix="timer1_eval_7b_")
    try:
        ckpt = os.path.join(root, "ckpt")
        nbytes = native_checkpoint(ckpt, init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16), cfg)
        gc.collect()
        torch.cuda.empty_cache()
        args = dict(ckpt=ckpt, data=write_dataset(root, "eval", EVAL_7B_ITEMS), root=root, one={})
        log(f"[eval 7b] native checkpoint {nbytes / 1e9:.2f} GB written in {time.perf_counter() - t0:.1f} s")
        for quant in EVAL_7B_QUANTS:
            one = eval_7b_run(args, quant, 1)
            args["one"][quant] = one
            log(f"[eval 7b] one card {quant}: {one['seconds']:.1f} s; decode {one['decode_ms']:.2f} ms/step over "
                f"{one['decode_steps']} steps; holds {one['held_gib']:.2f} GiB of weights, peak {one['peak_gib']:.2f} "
                f"GiB; {card}")
            for r in one["records"]:
                log(f"[eval 7b] one card {quant} record {r['qid']}: pred {r['pred']}, text {r['output_text'][-40:]!r}")
            gc.collect()
            torch.cuda.empty_cache()
        ranks = spawn_ranks("eval_7b", 4, args, card, nccl=True, timeout=SHARDED_TIMEOUT)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for quant in EVAL_7B_QUANTS:
        res = [r[quant] for r in ranks]
        log(f"[eval 7b] tp 4 {quant} over nccl: decode {[round(r['decode_ms'], 2) for r in res]} ms/step by rank "
            f"(one card {args['one'][quant]['decode_ms']:.2f}); held {[round(r['held_gib'], 2) for r in res]} GiB, "
            f"peak {[round(r['peak_gib'], 2) for r in res]} GiB (one card {args['one'][quant]['held_gib']:.2f}, "
            f"{args['one'][quant]['peak_gib']:.2f}); output texts equal {res[0]['texts_equal']} of {EVAL_7B_ITEMS}, "
            f"preds {res[0]['preds_equal']}; {card}")
    log(f"[eval 7b] (i): {time.perf_counter() - t0:.1f} s; {card}")
    return {"one": {q: {k: v for k, v in r.items() if k != "records"} for q, r in args["one"].items()},
            "ranks": ranks}


# ---------------------------------------------------------------------------
# phase 17: tensor parallelism past the kv heads (each kv head replicated on tp/nkv model ranks): the 3B's 2 kv
# heads at tp 4, 4 ranks over gloo on the first card, against one process's engines and step
KVREP_TP = 4
KVREP_LAYERS = 2  # the decoder depth at 3B widths, with the whole vision tower (4 ranks and one process share the card)
KVREP_NEW_TOKENS = 16  # 32 before the last cuts for the script's time limit (PERF.md §4)
KVREP_TIMEOUT = 300  # s: the parent's wait for phase 17's spawn
KVREP_VIDEO = (8, 224, 392)  # (a)'s video request: frames, height, width (448 video tokens)
KVREP_TEXTS = (180, 260, 150, 330)  # prompt lengths of the text requests (each prefill over 128 rows: no Q2 there)
# (name, engine, G, quantization, int8 KV, dtype): (a) the TP Engine on two texts and a video (G 1: K1, K2, K3) and on
# the two texts (G 8: D2 at the rank's 4 q heads over its 1 kv head), and in f32 on the two texts (FMA; the tokens
# held equal to one process's); (b) PagedEngine over int8 weights and int8 pages on four texts (P2, Q2 at inter 2752)
KVREP_RUNS = (
    ("engine_g1", "engine", 1, None, False, "bfloat16"),
    ("engine_g8", "engine", 8, None, False, "bfloat16"),
    ("paged_int8", "paged", 1, "int8", True, "bfloat16"),
    ("engine_g1_f32", "engine", 1, None, False, "float32"),
)


def kvrep_config(layers: int = KVREP_LAYERS):
    """Qwen2.5-VL-3B (16 q over 2 kv heads) cut to `layers` decoder layers, at full width and vision depth."""
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    return cut_depth(Qwen25VLConfig.qwen25vl_3b(), layers)


def kvrep_inputs(cfg, name: str, kind: str, G: int):
    """A run's requests and sampling: the texts of KVREP_TEXTS (the paged
    engine all four, the TP Engine the first two) and, for engine_g1, a
    video; KVREP_NEW_TOKENS greedy tokens, no stop id."""
    from time_r1_tpu_torch.sampler import SamplingParams

    rng = np.random.default_rng(17)
    texts = [text_request(cfg, rng, n) for n in KVREP_TEXTS]
    reqs = texts if kind == "paged" else texts[:2]
    if name == "engine_g1":
        reqs = reqs + [video_request(cfg, np.random.default_rng(18), *KVREP_VIDEO)]
    return reqs, SamplingParams(temperature=0.0, max_new_tokens=KVREP_NEW_TOKENS, stop_token_ids=(),
                                num_return_sequences=G)


def kvrep_launches(cfg, kind: str, G: int, quant, kv: bool, tm: dict, reqs: list) -> dict:
    """A run's launches on a rank (`cmesh_launches`), K2 and K3 in the TP
    Engine's one vision pass where a request holds a video."""
    want = cmesh_launches(cfg, kind, G, quant, kv, tm, reqs)
    if kind == "engine" and any(r.patches is not None for r in reqs):
        want.update(vision_tc_launches(cfg))
    return want


def kvrep_reference(card: str, tp: int, runs: tuple, layers: int) -> tuple:
    """One process's engines of `runs` at `layers` in the parent, decoded
    eagerly as the mesh's: tokens, picks (logits and tokens; G > 1 the first
    row), live slots, decode ms a step and peak, to a file; the card freed
    before the ranks start. Returns (file, root)."""
    import gc
    import tempfile

    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params

    root = tempfile.mkdtemp(prefix="timer1_phase17_")
    cfg, refs = kvrep_config(layers), {}
    for dtype_name in ("bfloat16", "float32"):
        todo = [r for r in KVREP_RUNS if r[0] in runs and r[5] == dtype_name]
        if not todo:
            continue
        dtype = getattr(torch, dtype_name)
        params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
        for name, kind, G, quant, kv, _ in todo:
            eng = cmesh_engine(kind, params, cfg, dtype, quant, kv)
            reqs, sp = kvrep_inputs(cfg, name, kind, G)
            store, lives, admitted = [], [], []
            recording_pick(eng, store, 1 if G > 1 else None)
            torch.cuda.reset_peak_memory_stats()
            with eager_decode(), recording_lives(lives, admitted):
                tokens = eng.generate(reqs, sp)
            tm = eng.timings
            refs[name] = dict(tokens=tokens, picks=store, lives=lives, admitted=admitted, held_gib=held_gib(eng.params),
                              peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                              decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1))
            log(f"[kvrep] one process {name} at {layers} layers: {sum(len(t) for t in tokens)} tokens over "
                f"{len(tokens)} rows, decode {refs[name]['decode_ms']:.2f} ms/step (eager), peak "
                f"{refs[name]['peak_gib']:.2f} GiB; {card}")
            del eng
        del params
        gc.collect()
        torch.cuda.empty_cache()
    path = os.path.join(root, "kvrep.pt")
    torch.save(refs, path)
    return path, root


def kv_block_digests(params: dict) -> list:
    """sha256 of each text layer's k/v leaves (this rank's blocks), in order."""
    import hashlib

    import torch

    return [hashlib.sha256(lp[k].detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()
            for lp in params["text"]["layers"] for k in ("k_w", "v_w", "k_b", "v_b")]


def kvrep_engines(args: dict, rank: int) -> dict:
    """(a), (b) on each rank: each of args' runs over make_mesh(tp) with the
    3B's kv heads replicated (tp/2 ranks a head), against one process's:
    the rank's heads (nh/tp q over one kv head, `local_heads`), the launches
    by the formula (tensor cores in bf16, FMA in f32), the ranks' tokens
    equal, the f32 tokens equal one process's and its prefill logits within
    MESH_F32_TOL, the bf16 logits within MESH_LOGIT_TOL where the prefixes
    agree; decode ms a step, bytes staged, the weights held and the peak."""
    import gc

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.models.qwen25vl.language import _heads
    from time_r1_tpu_torch.parallel import ShardContext, comm, make_mesh
    from time_r1_tpu_torch.parallel.tensor import local_heads

    tp, cfg = args["tp"], kvrep_config(args["layers"])
    refs = torch.load(args["file"], weights_only=False)
    out = {}
    for dtype_name in ("bfloat16", "float32"):
        todo = [r for r in KVREP_RUNS if r[0] in args["runs"] and r[5] == dtype_name]
        if not todo:
            continue
        dtype = getattr(torch, dtype_name)
        params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
        shard = ShardContext.build(make_mesh(tp), params).with_kv_heads(cfg.text.num_key_value_heads)
        m = shard.model_rank
        nh, nkv, kv_index, r = local_heads(cfg.text, tp, m)
        if (nh, nkv, kv_index, r) != (cfg.text.num_attention_heads // tp, 1, m // (tp // 2), tp // 2):
            raise AssertionError(f"kvrep rank {rank}: local heads {(nh, nkv, kv_index, r)} at tp {tp}")
        for name, kind, G, quant, kv, _ in todo:
            eng = cmesh_engine(kind, params, cfg, dtype, quant, kv, shard)
            inner = getattr(eng, "_prefill_engine", eng)
            if _heads(cfg.text, inner._text_shard)[:2] != (nh, 1):
                raise AssertionError(f"kvrep {name} rank {rank}: the engine runs {_heads(cfg.text, inner._text_shard)}")
            held = held_gib(eng.params)
            reqs, sp = kvrep_inputs(cfg, name, kind, G)
            store, lives, admitted = [], [], []
            recording_pick(eng, store, 1 if G > 1 else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            staged0 = comm.staged_bytes
            reset_launches()
            with recording_lives(lives, admitted):
                tokens = eng.generate(reqs, sp)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            tm = eng.timings
            label = f"kvrep tp {tp} {name} rank {rank}"
            want = kvrep_launches(cfg, kind, G, quant, kv, tm, reqs)
            check_tc_route(label, launches, {k: v for k, v in want.items() if k in TC_KERNELS and v},
                           tensor_cores=dtype_name == "bfloat16")
            bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
            if bad:
                raise AssertionError(f"{label}: launches (got, want) {bad}")
            if any(len(t) != KVREP_NEW_TOKENS for t in tokens):
                raise AssertionError(f"{label}: rows of {[len(t) for t in tokens]} tokens, want {KVREP_NEW_TOKENS}")
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, tokens)
            if any(t != tokens for t in every):
                raise AssertionError(f"kvrep tp {tp} {name}: the ranks' tokens differ")
            ref = refs[name]
            agree = [next((i for i, (a, b) in enumerate(zip(t, r)) if a != b), min(len(t), len(r)))
                     for t, r in zip(tokens, ref["tokens"])]
            if dtype_name == "float32" and tokens != ref["tokens"]:
                raise AssertionError(f"{label}: f32 tokens differ from one process's (agree {agree})")
            if kind != "engine" and not (admitted == ref["admitted"] and
                                         all(torch.equal(a, b) for a, b in zip(lives, ref["lives"]))):
                raise AssertionError(f"{label}: the live slots differ from one process's")
            res = dict(decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1), decode_steps=tm["decode_steps"],
                       prefill_ms=tm["prefill_s"] * 1e3, staged_gb=(comm.staged_bytes - staged0) / 1e9,
                       peak_gib=peak, held_gib=held, one_peak_gib=ref["peak_gib"], one_decode_ms=ref["decode_ms"],
                       one_held_gib=ref["held_gib"], launches={k: launches[k] for k in want}, tokens_agree=agree)
            if store:  # the rank that samples
                errs, compared, firsts = pick_errors(store, ref["picks"],
                                                     *((lives, admitted) if kind != "engine" else ()))
                res.update(logit_rel_err=max(errs), prefill_logit_rel_err=max(firsts), picks_compared=compared)
                if dtype_name == "float32" and not res["prefill_logit_rel_err"] <= MESH_F32_TOL:
                    raise AssertionError(f"{label}: prefill logits {res['prefill_logit_rel_err']} apart > "
                                         f"{MESH_F32_TOL}")
                if dtype_name == "bfloat16" and not res["logit_rel_err"] <= MESH_LOGIT_TOL:
                    raise AssertionError(f"{label}: logits {res['logit_rel_err']} apart > {MESH_LOGIT_TOL}")
            log(f"{label}: {nh} q heads over 1 kv head (kv head {kv_index}, on {r} ranks); tokens agree with one "
                f"process's for {agree} of {KVREP_NEW_TOKENS}"
                + (f", logits {res['logit_rel_err']:.3e} apart over {res['picks_compared']} rows of picks (the "
                   f"prefills' {res['prefill_logit_rel_err']:.3e})" if "logit_rel_err" in res else "")
                + f"; decode {res['decode_ms']:.2f} ms/step (one process eager {ref['decode_ms']:.2f}); "
                f"{res['staged_gb']:.3f} GB staged; peak {peak:.2f} GiB (one process {ref['peak_gib']:.2f}); holds "
                f"{held:.2f} GiB of weights (one process {ref['held_gib']:.2f}); launches {res['launches']}")
            out[name] = res
            del eng, inner
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        del params, shard
        gc.collect()
        torch.cuda.empty_cache()
    return out


def kvrep_step(args: dict, rank: int) -> dict:
    """(c) on each rank: one bf16 `step_batch` over a 1×tp mesh (the kv
    heads replicated, their gradients summed over the replicas): the
    launches by the formula (model rank 0 rolls out over the gathered copy),
    the loss and rows equal on every rank, the k/v blocks bit-equal within
    each replica group after the update and different across groups; then
    on rank 0 one process's `step_batch` with the completions replayed,
    against which the loss (DP_TOL) and the step's gradient (the first
    moments, gathered: all leaves, and the k/v leaves alone) are held
    (CP_BF16_TOL's whole)."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from time_r1_tpu_torch.parallel import comm, make_mesh
    from time_r1_tpu_torch.parallel.sharding import _map
    from time_r1_tpu_torch.rl import trainer as trainer_mod
    from time_r1_tpu_torch.rl.grpo import trainable_leaves

    tp, cfg = args["tp"], kvrep_config(args["layers"])
    L = cfg.text.num_hidden_layers
    root = tempfile.mkdtemp(prefix=f"timer1_phase17_step{rank}_")
    tr = dp_trainer(cfg, make_mesh(tp), root, extra_rewards=(row_spread_reward,))
    recorded, rows = [], []
    if tr._rolls_out:
        generate = tr.engine.generate
        tr.engine.generate = lambda requests, sp: recorded.append(generate(requests, sp)) or recorded[-1]
    build = trainer_mod.build_grpo_split_batch
    trainer_mod.build_grpo_split_batch = lambda *a, **kw: rows.append(build(*a, **kw)) or rows[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    staged0 = comm.staged_bytes
    reset_launches()
    t0 = time.perf_counter()
    info = tr.step_batch([DP_EXAMPLES[0]])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    trainer_mod.build_grpo_split_batch = build
    launches = read_launches()
    steps = [None] * tp
    dist.all_gather_object(steps, tr.engine.timings["decode_steps"] if tr._rolls_out else 0)
    n_steps = steps[0]
    if tr._rolls_out:
        want = step_batch_tc_launches(cfg, n_steps) | {k: 2 * v for k, v in vision_tc_launches(cfg).items()}
    else:  # no rollout: the ref forward and the loss only; the frozen ViT once
        want = sharded_loss_launches(cfg) | {"flash_attention": 2 * L, "shared_prefix_fwd": 2 * L}
        want["shared_prefix_decode_full"] = 0
    check_tc_route(f"kvrep step_batch rank {rank}", launches, {k: v for k, v in want.items() if v}, tensor_cores=True)
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"kvrep step_batch rank {rank}: launches (got, want) {bad}")
    batch = rows[0]
    row_digest = [float(t.float().sum()) for t in (batch.prompt_ids, batch.comp_ids, batch.comp_mask,
                                                   batch.advantages)]
    every = [None] * tp
    dist.all_gather_object(every, (info["loss"], row_digest, kv_block_digests(tr.params),
                                   tr.params["text"]["layers"][0]["k_w"].shape[0]))
    r = tp // cfg.text.num_key_value_heads
    for m in range(tp):
        if every[m][:2] != every[0][:2]:
            raise AssertionError(f"kvrep step_batch: rank {m}'s loss and rows differ from rank 0's")
        if every[m][3] != cfg.text.head_dim:
            raise AssertionError(f"kvrep step_batch: rank {m} holds {every[m][3]} k rows, not one whole head")
        if every[m][2] != every[m - m % r][2]:
            raise AssertionError(f"kvrep step_batch: rank {m}'s k/v blocks differ from their replica's on rank "
                                 f"{m - m % r} after the update")
    if every[0][2] == every[r][2]:
        raise AssertionError("kvrep step_batch: two kv heads' blocks are equal")
    res = dict(step_s=step_s, loss=info["loss"], decode_steps=n_steps,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, staged_gb=(comm.staged_bytes - staged0) / 1e9, launches={k: launches[k] for k in want},
               rolls_out=tr._rolls_out)
    log(f"kvrep step_batch (1x{tp}) rank {rank}: {step_s:.2f} s, loss {info['loss']:.6f}, {n_steps} decode steps; "
        f"peak {res['peak_gib']:.2f} GiB; {res['staged_gb']:.2f} GB staged; the ranks' loss and rows equal; the k/v "
        f"blocks bit-equal within each of the {cfg.text.num_key_value_heads} replica groups of {r}")
    paths = trainable_leaves(_map(tr.params, lambda path, x: path), tr.hp.fix_vit)
    kv_idx = [i for i, p in enumerate(paths) if p.rsplit("/", 1)[-1] in ("k_w", "v_w", "k_b", "v_b")]
    metrics = tr.pop_metrics()
    mu = tr._gathered_opt_tree(keep=rank == 0)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        one = dp_trainer(cfg, None, root, extra_rewards=(row_spread_reward,))
        replay = [list(c) for c in recorded[0]]
        one.engine.generate = lambda requests, sp: [list(c) for c in replay]
        one_info = one.step_batch([DP_EXAMPLES[0]])
        one_metrics = one.pop_metrics()
        grad_err = rel_norm(mu["mu"], one.opt_state.mu)
        kv_err = rel_norm([mu["mu"][i] for i in kv_idx], [one.opt_state.mu[i] for i in kv_idx])
        rel = {k: abs(metrics[k] - v) / max(abs(v), DP_TOL["floor"]) for k, v in one_metrics.items()}
        rel["loss"] = abs(info["loss"] - one_info["loss"]) / max(abs(one_info["loss"]), DP_TOL["floor"])
        log(f"kvrep step_batch against one process: loss {info['loss']:.6f} vs {one_info['loss']:.6f}; relative "
            f"errors {({k: f'{v:.2e}' for k, v in rel.items()})}; gradient (the first moments) ||tp - one|| / ||one|| "
            f"{grad_err:.3e}, the k/v leaves' {kv_err:.3e}")
        if set(one_metrics) != set(metrics) or max(rel.values()) > DP_TOL["rel"] or grad_err > CP_BF16_TOL["whole"] \
                or kv_err > CP_BF16_TOL["whole"]:
            raise AssertionError(f"kvrep step_batch: against one process {rel}, gradient {grad_err}, k/v {kv_err}")
        res["vs_one_process"] = dict(rel=rel, grad_err=grad_err, kv_grad_err=kv_err)
        del one, mu
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    shutil.rmtree(root, ignore_errors=True)
    return res


def kvrep_job(args: dict) -> dict:
    """Phase 17 (and `scripts/check_parallel.py j`'s tp-8 part) on each rank:
    `kvrep_engines`, then `kvrep_step` when asked."""
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {"engines": kvrep_engines(args, rank)}
    if args["step"]:
        out["step"] = kvrep_step(args, rank)
    return out


def phase_kv_replication(card: str, tp: int = KVREP_TP, runs: tuple = tuple(r[0] for r in KVREP_RUNS),
                         step: bool = True, layers: int = KVREP_LAYERS) -> dict:
    """Phase 17: the 3B past its 2 kv heads, tp ranks over gloo on the first
    card at `layers` decoder layers: one process's references
    (`kvrep_reference`), then `kvrep_job` in one spawn. Returns each bf16
    run's launches on every rank, and the step's under "step_batch"."""
    import shutil

    t0 = time.perf_counter()
    path, root = kvrep_reference(card, tp, runs, layers)
    try:
        ranks = spawn_ranks("kvrep", tp, dict(file=path, tp=tp, runs=list(runs), step=step, layers=layers), card,
                            timeout=KVREP_TIMEOUT)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {}
    for name in ranks[0]["engines"]:
        res = [r["engines"][name] for r in ranks]
        log(f"[kvrep] tp {tp} {name} over gloo: decode {[round(x['decode_ms'], 2) for x in res]} ms/step by rank (one "
            f"process eager {res[0]['one_decode_ms']:.2f}); prefill {[round(x['prefill_ms'], 1) for x in res]} ms; "
            f"{[round(x['staged_gb'], 3) for x in res]} GB staged; peak {[round(x['peak_gib'], 2) for x in res]} GiB "
            f"(one process {res[0]['one_peak_gib']:.2f}); weights {[round(x['held_gib'], 2) for x in res]} GiB (one "
            f"process {res[0]['one_held_gib']:.2f}); tokens agree {res[0]['tokens_agree']}"
            + (f"; logits {res[0]['logit_rel_err']:.3e} apart" if "logit_rel_err" in res[0] else "") + f"; {card}")
        if name in {r[0] for r in KVREP_RUNS if r[5] == "bfloat16"}:
            result[name] = [x["launches"] for x in res]
    if step:
        res = [r["step"] for r in ranks]
        log(f"[kvrep] tp {tp} step_batch over gloo: {[round(x['step_s'], 2) for x in res]} s by rank; peak "
            f"{[round(x['peak_gib'], 2) for x in res]} GiB; {[round(x['staged_gb'], 2) for x in res]} GB staged; "
            f"against one process {res[0]['vs_one_process']}; {card}")
        result["step_batch"] = [x["launches"] for x in res]
    log(f"[kvrep] phase 17 (tp {tp}, {layers} layers): {time.perf_counter() - t0:.1f} s; {card}")
    return result


# ---------------------------------------------------------------------------
# `scripts/check_parallel.py j`, asked for by name only: the 3B past its kv heads over 4 cards (NCCL) at full depth
# through the CLIs, and at tp 8 over 8 gloo ranks on one card
THREE_B_TP4_ITEMS = 4
# scripts/test.sh's eval flags at TP=4, and at TP=4 CONTINUOUS=1 QUANT=int8 KV_DTYPE=int8 (BATCH 4 here); the
# checkpoint read in f32 (`mesh_cli_patches`), so that the plain run's records equal one card's
THREE_B_TP4_EVALS = {
    "tp4": ("--use_vllm_inference", "--batch_size", "4"),
    "tp4_continuous_int8": ("--use_vllm_inference", "--batch_size", "4", "--use_continuous_batching", "--kv_block_size",
                            "128", "--quantization", "int8", "--kv_cache_dtype", "int8"),
}
THREE_B_TP4_EXACT = ("tp4",)  # f32, TP changes only the order of f32 sums: the records equal one card's
TP8_LAYERS = 2


def three_b_eval_run(args: dict, tag: str, tp: int) -> dict:
    """One `cli.evaluate.main` of j (tp 1: one card, in the parent): records,
    seconds, the generation engine's decode ms a step, weights and peak."""
    import torch

    from time_r1_tpu_torch.cli import evaluate
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    made: list = []
    extra = ("--tensor_parallel_size", str(tp)) if tp > 1 else ()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cli_stand_ins(Qwen25VLConfig.qwen25vl_3b()), mesh_cli_patches(), spied_generation_engine(made):
        argv = mesh_eval_argv(args["ckpt"], args["data"], os.path.join(args["root"], f"{tag}_tp{tp}"),
                              *THREE_B_TP4_EVALS[tag], *extra)
        argv[argv.index("--max_new_tokens") + 1] = str(MESH_NEW_TOKENS)
        path = evaluate.main(evaluate.get_args(argv))
    torch.cuda.synchronize()
    eng = made[0]
    tm = eng.timings
    return dict(records=read_jsonl(path) if os.path.exists(path) else None, seconds=time.perf_counter() - t0,
                decode_ms=tm["decode_s"] * 1e3 / max(tm["decode_steps"], 1), decode_steps=tm["decode_steps"],
                held_gib=held_gib(eng.params), peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def three_b_train_run(args: dict, tp: int) -> dict:
    """`cli.train.main` of j at full depth from the HF checkpoint (tp 1: one
    card): 2 step_batch calls (accumulation 2: one update, after both), each
    call's loss and seconds, the peak."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.rl import GRPOTrainer

    steps = []

    def counted(original):
        def step_batch(self, examples, requests=None):
            t0 = time.perf_counter()
            res = original(self, examples, requests=requests)
            torch.cuda.synchronize()
            steps.append(dict(s=time.perf_counter() - t0, loss=res["loss"]))
            return res
        return step_batch

    extra = ("--tensor_parallel_size", str(tp)) if tp > 1 else ()
    torch.cuda.reset_peak_memory_stats()
    cfg = Qwen25VLConfig.qwen25vl_3b()
    with cli_stand_ins(cfg) as cli, patched(GRPOTrainer, "step_batch", counted):
        trainer = cli.main(cli_args(cli, args["hf"], os.path.join(args["root"], f"train_tp{tp}"), args["train"],
                                    *extra))
    if len(steps) != 2 or trainer.global_step != 2:
        raise AssertionError(f"j: cli.train at tp {tp} ran {len(steps)} step_batch calls")
    out = dict(losses=[s["loss"] for s in steps], step_s=[s["s"] for s in steps],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del trainer
    return out


def three_b_tp4_job(args: dict) -> dict:
    """j on each of 4 ranks, a card a rank (NCCL): `cli.evaluate.main` with
    each of THREE_B_TP4_EVALS at --tensor_parallel_size 4 (rank 0's records
    against one card's: equal for THREE_B_TP4_EXACT, the qids equal and the
    agreeing texts counted for the int8 run), then `cli.train.main
    --tensor_parallel_size 4` (each step_batch's loss within DP_TOL of one
    card's: both calls roll out from the same initial weights)."""
    import gc

    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {}
    for tag in THREE_B_TP4_EVALS:
        res = three_b_eval_run(args, tag, 4)
        one = args["one"][tag]
        if rank == 0:
            if [r["qid"] for r in res["records"]] != [r["qid"] for r in one["records"]]:
                raise AssertionError(f"j {tag}: the records' qids differ from one card's")
            res["texts_equal"] = sum(a["output_text"] == b["output_text"]
                                     for a, b in zip(res["records"], one["records"]))
            if tag in THREE_B_TP4_EXACT and res["records"] != one["records"]:
                raise AssertionError(f"j {tag}: the records differ from one card's ({res['texts_equal']} texts equal)")
        log(f"[3b tp4] {tag} rank {rank}: {res['seconds']:.1f} s; decode {res['decode_ms']:.2f} ms/step over "
            f"{res['decode_steps']} steps (one card {one['decode_ms']:.2f}); holds {res['held_gib']:.2f} GiB of "
            f"weights (one card {one['held_gib']:.2f}), peak {res['peak_gib']:.2f} GiB (one card {one['peak_gib']:.2f})"
            + (f"; output texts equal to one card's {res['texts_equal']} of {len(res['records'])}"
               if rank == 0 else ""))
        out[tag] = {k: v for k, v in res.items() if k != "records"}
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    res = three_b_train_run(args, 4)
    one = args["one"]["train"]
    rel = [abs(a - b) / max(abs(b), DP_TOL["floor"]) for a, b in zip(res["losses"], one["losses"])]
    log(f"[3b tp4] cli.train --tensor_parallel_size 4 rank {rank}: losses {res['losses']} (one card {one['losses']}, "
        f"relative {[f'{x:.2e}' for x in rel]}); step_batch {[round(s, 2) for s in res['step_s']]} s (one card "
        f"{[round(s, 2) for s in one['step_s']]}); peak {res['peak_gib']:.2f} GiB (one card {one['peak_gib']:.2f})")
    if max(rel) > DP_TOL["rel"]:
        raise AssertionError(f"j: cli.train at tp 4, losses {res['losses']} against one card's {one['losses']}")
    out["train"] = dict(res, rel=rel)
    return out


def phase_three_b_tp4(card: str) -> dict:
    """j, on 4 cards: the 3B's seeded bf16 weights as a native checkpoint
    (eval) and an HF one (train), one card's runs (`three_b_eval_run` for
    each of THREE_B_TP4_EVALS, `three_b_train_run`), then
    `three_b_tp4_job` over NCCL; then tp 8 over 8 gloo ranks on the first
    card at TP8_LAYERS (`phase_kv_replication`: the TP Engine at G 8 and one
    step_batch). Writes ~24 GB under TMPDIR, deleted at the end."""
    import gc
    import shutil
    import tempfile

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params

    cards = torch.cuda.device_count()
    if cards < 4:
        raise AssertionError(f"j needs 4 cards, the machine shows {cards}")
    t0 = time.perf_counter()
    cfg = Qwen25VLConfig.qwen25vl_3b()
    root = tempfile.mkdtemp(prefix="timer1_3b_tp4_")
    try:
        ckpt = os.path.join(root, "ckpt")
        nbytes = native_checkpoint(ckpt, init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16), cfg)
        args = dict(ckpt=ckpt, data=write_dataset(root, "eval", THREE_B_TP4_ITEMS), root=root, one={},
                    hf=os.path.join(root, "hf"), train=write_dataset(root, "train", 2))
        cli_hf_checkpoint(cfg, args["hf"])
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[3b tp4] checkpoints written ({nbytes / 1e9:.2f} GB native) in {time.perf_counter() - t0:.1f} s")
        for tag in THREE_B_TP4_EVALS:
            one = three_b_eval_run(args, tag, 1)
            args["one"][tag] = one
            log(f"[3b tp4] one card {tag}: {one['seconds']:.1f} s; decode {one['decode_ms']:.2f} ms/step over "
                f"{one['decode_steps']} steps; holds {one['held_gib']:.2f} GiB of weights, peak {one['peak_gib']:.2f} "
                f"GiB; {card}")
            gc.collect()
            torch.cuda.empty_cache()
        args["one"]["train"] = three_b_train_run(args, 1)
        log(f"[3b tp4] one card cli.train: losses {args['one']['train']['losses']}, step_batch "
            f"{[round(s, 2) for s in args['one']['train']['step_s']]} s, peak {args['one']['train']['peak_gib']:.2f} "
            f"GiB; {card}")
        gc.collect()
        torch.cuda.empty_cache()
        ranks = spawn_ranks("three_b_tp4", 4, args, card, nccl=True, timeout=SHARDED_TIMEOUT)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for tag in THREE_B_TP4_EVALS:
        res = [r[tag] for r in ranks]
        log(f"[3b tp4] {tag} over nccl: decode {[round(x['decode_ms'], 2) for x in res]} ms/step by rank (one card "
            f"{args['one'][tag]['decode_ms']:.2f}); held {[round(x['held_gib'], 2) for x in res]} GiB, peak "
            f"{[round(x['peak_gib'], 2) for x in res]} GiB (one card {args['one'][tag]['held_gib']:.2f}, "
            f"{args['one'][tag]['peak_gib']:.2f}); texts equal {res[0]['texts_equal']} of {THREE_B_TP4_ITEMS}; {card}")
    log(f"[3b tp4] (j) 4 cards: {time.perf_counter() - t0:.1f} s; {card}")
    tp8 = phase_kv_replication(card, tp=8, runs=("engine_g8",), step=True, layers=TP8_LAYERS)
    return {"ranks": ranks, "tp8": tp8}


# ---------------------------------------------------------------------------
# phase 18
PARITY_LAYERS = 2  # the decoder depth of phase 18's checkpoints (36 / 28 at full depth: scripts/check_parity.py)
PARITY_VISION_DEPTH = 8  # blocks 0-6 windowed (K2), block 7 full attention (K3), as at 32 blocks
PARITY_MODELS = ("3b", "7b")  # the tied head and the untied one, which the HF loader reads apart
HF_TOP_LEVEL = ("image_token_id", "video_token_id", "vision_start_token_id", "vision_end_token_id",
                "bos_token_id", "eos_token_id", "pad_token_id", "tie_word_embeddings")


def parity_config(name: str, layers: int = None, vision_depth: int = None):
    """Qwen2.5-VL-3B or -7B at its published widths, its depths cut where
    given; the full-attention blocks kept are those below the cut."""
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig.qwen25vl_3b() if name == "3b" else Qwen25VLConfig.qwen25vl_7b()
    if layers is not None:
        cfg = replace(cfg, text=replace(cfg.text, num_hidden_layers=layers))
    if vision_depth is not None:
        full = tuple(i for i in cfg.vision.fullatt_block_indexes if i < vision_depth)
        cfg = replace(cfg, vision=replace(cfg.vision, depth=vision_depth, fullatt_block_indexes=full))
    return cfg


def hf_parity_checkpoint(cfg, path: str, seed: int = 0, device: str = "cuda") -> float:
    """transformers' Qwen2_5_VLForConditionalGeneration at `cfg`'s shapes,
    its weights drawn by transformers' own initialisation after
    torch.manual_seed(seed) on `device`, written by save_pretrained
    (safetensors) in bf16, the published checkpoints' dtype. The token ids
    and the head's tying also at the top level of config.json, where the
    published configs carry them (save_pretrained nests them under
    text_config). Returns the GB written."""
    import torch
    from transformers import Qwen2_5_VLConfig, Qwen2_5_VLForConditionalGeneration

    from time_r1_tpu_torch.models.qwen25vl.convert import config_to_hf_dict

    text = config_to_hf_dict(cfg)
    vision = text.pop("vision_config")
    top = {k: text[k] for k in HF_TOP_LEVEL}
    for k in ("architectures", "model_type", "torch_dtype"):
        text.pop(k)
    hf_cfg = Qwen2_5_VLConfig(text_config=text, vision_config=vision, **top)
    torch.manual_seed(seed)
    with torch.device(device):
        model = Qwen2_5_VLForConditionalGeneration(hf_cfg)
    model.to(device="cpu", dtype=torch.bfloat16).save_pretrained(path, safe_serialization=True)
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    cfg_path = os.path.join(path, "config.json")
    with open(cfg_path) as f:
        written = json.load(f)
    written.update(top)
    with open(cfg_path, "w") as f:
        json.dump(written, f)
    return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path)) / 1e9


def parity_run(card: str, name: str, cfg, ckpt: str, out_dir: str) -> dict:
    """`cli.parity.main` with --skip_demo --skip_benchmark on `ckpt` (at
    `cfg`) on the card, its launch counts read around it: the report's
    activations must pass ("skip" fails), K2 and K3 run once a windowed and
    a full block in the f32 forward (FMA) and in the bf16 one (tensor
    cores), K1 not at all."""
    from time_r1_tpu_torch.cli import parity

    reset_launches()
    t0 = time.perf_counter()
    rc = parity.main(parity.get_args(["--model_base", ckpt, "--output_dir", out_dir, "--skip_demo",
                                      "--skip_benchmark"]), device="cuda")
    seconds = time.perf_counter() - t0
    launches = read_launches()
    with open(os.path.join(out_dir, "parity_report.json")) as f:
        report = json.load(f)["activations"]
    status, detail = report["status"], report["detail"]
    for line in detail.splitlines():
        log(f"[parity {name}] {line}")
    if rc != 0 or status != "pass":
        raise AssertionError(f"phase 18 ({name}): cli.parity returned {rc}, activations {status!r}")
    full = len(cfg.vision.fullatt_block_indexes)
    for kname, n in (("window_attention_rope", cfg.vision.depth - full), ("full_attention_rope", full)):
        tc, all_ = launches[f"{kname}_tc"], launches[kname]
        log(f"[parity {name}] {kname}: {tc} tensor-core launches in the bf16 forward, {all_ - tc} FMA in the f32 one")
        if tc != n or all_ - tc != n:
            raise AssertionError(f"phase 18 ({name}): {kname} ran {tc} tensor-core and {all_ - tc} FMA launches, "
                                 f"want {n} of each")
    if launches["flash_attention"]:
        raise AssertionError(f"phase 18 ({name}): K1 launched {launches['flash_attention']} times")
    tokens = parity._fixed_prompt(cfg, (4, 6, 8)).shape[1]  # the harness's grid at the published patch width
    log(f"[parity {name}] flash_attention: 0 launches: the harness's prompt is {tokens} tokens, not a multiple of 128 "
        "(`_flash_eligible`, time_r1_tpu_torch/models/qwen25vl/language.py:213)")
    log(f"[parity {name}] cli.parity.main: {seconds:.1f} s; {card}")
    return {"launches": launches, "seconds": seconds, "detail": detail}


def phase_parity(card: str) -> dict:
    """Phase 18: the parity harness at full width. For the 3B and the 7B at
    PARITY_LAYERS decoder layers and PARITY_VISION_DEPTH vision blocks, an
    HF checkpoint that transformers wrote (`hf_parity_checkpoint`) through
    `cli.parity.main` on the card (`parity_run`). Writes ~5 GB under TMPDIR,
    deleted at the end."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    import transformers

    log(f"[parity] transformers {transformers.__version__} imported in {time.perf_counter() - t0:.1f} s")
    out = {}
    root = tempfile.mkdtemp(prefix="timer1_parity_")
    try:
        for name in PARITY_MODELS:
            t0 = time.perf_counter()
            cfg = parity_config(name, PARITY_LAYERS, PARITY_VISION_DEPTH)
            ckpt = os.path.join(root, name)
            gb = hf_parity_checkpoint(cfg, ckpt)
            log(f"[parity {name}] transformers wrote {gb:.2f} GB ({cfg.text.num_hidden_layers} decoder layers, "
                f"{cfg.vision.depth} vision blocks, tied head {cfg.text.tie_word_embeddings}) in "
                f"{time.perf_counter() - t0:.1f} s")
            out[name] = parity_run(card, name, cfg, ckpt, os.path.join(root, f"{name}_out"))
            shutil.rmtree(ckpt)
            torch.cuda.empty_cache()
            log(f"[parity {name}] {time.perf_counter() - t0:.1f} s with the checkpoint; {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def timed(phase, *args):
    """phase(*args), its seconds logged."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[env] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    # the training phase holds ~60 GB of live tensors of many sizes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import time_r1_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"[env] {card}")

    timed(phase_build)
    checks = timed(phase_kernels)
    for phase in (phase_reduced_depth, phase_reduced_train, phase_reduced_lora, phase_reduced_quant,
                  phase_reduced_serving, phase_captured_decode, phase_reduced_eval):
        timed(phase)
    launches = timed(phase_full_size)  # K1-K3: the serving path
    train_launches = timed(phase_train_full_size)  # B1, B2, S1, S2 (and D1/D2 in the rollout): the training path
    launches.update({k: v for k, v in train_launches.items() if k not in SERVING_KEYS})
    quant_launches = timed(phase_quant_full_size)  # D1, D2, Q2 (int8 step_batch), Q1 (int4 generate)
    serve = timed(phase_serving_full_size)  # P1 (a), P2 (b): continuous-batching serving
    input_launches = timed(phase_input_path, card)  # K1-K3, B1, B2, S1, S2, D2 from frames the processor made
    cli_launches = timed(phase_cli_train, card)  # the same kernels from `cli.train.main`, K1 and S1 rerun under remat
    sf_launches = timed(phase_sf_round, card)  # the same from `cli.train_sf.main`: a round's training and self-eval
    lora_launches = timed(phase_lora_7b, card)  # the same from `cli.train.main` on the 7B, LoRA over an int8 base
    full_param = timed(phase_full_param_7b, card)  # the 7B's full parameters, the state offloaded; the full-row loss
    parallel = timed(phase_parallel, card)  # ranks over gloo: ring attention (K1, B1, B2), the CP loss, DP, the CLI
    sharded = timed(phase_sharded, card)  # ranks over gloo: FSDP and TP loss steps, step_batch over TP, the CLI
    # ranks over gloo: the TP Engine, PPEngine, cli.evaluate / cli.demo (15); PagedEngine, ContinuousEngine and the
    # int4 TP Engine over the mesh, cli.evaluate with the recipe's eval flags (16)
    mesh = timed(phase_mesh_serving, card)
    # 4 ranks over gloo: the 3B's 2 kv heads at tp 4, each on 2 ranks: the TP Engine, PagedEngine, a step_batch (17)
    kvrep = timed(phase_kv_replication, card)
    parity = timed(phase_parity, card)  # cli.parity against HF transformers: the 3B and the 7B at full width (18)
    for tag, name in zip("ab", PAGED_KERNELS):
        quant_launches[name] = serve[tag]["launches"][name]
        quant_launches[f"{name}_tc"] = serve[tag]["launches"][f"{name}_tc"]

    jax_fa = "time_r1_tpu/ops/flash_attention.py"
    replaces = {
        "flash_attention": f"{jax_fa}:135",
        "window_attention_rope": "time_r1_tpu/ops/vision_attention.py:140",
        "full_attention_rope": "time_r1_tpu/ops/vision_attention.py:233",
        "flash_bwd_dq": f"{jax_fa}:325",
        "flash_bwd_dkv": f"{jax_fa}:368",
        "shared_prefix_fwd": f"{jax_fa}:575",
        "shared_prefix_bwd": f"{jax_fa}:739",
        "shared_prefix_decode_attention": "time_r1_tpu/ops/decode_attention.py:171",
        "shared_prefix_decode_full": "time_r1_tpu/ops/decode_attention.py:403",
        "int4_matmul": "time_r1_tpu/ops/int4_matmul.py:128",
        "fused_mlp_int8": "time_r1_tpu/ops/fused_mlp.py:85",
        "paged_prefix_attention": "time_r1_tpu/ops/paged_attention.py:163",
        "paged_prefix_attention_q8": "time_r1_tpu/ops/paged_attention.py:311",
    }
    csrc = "time_r1_tpu_torch/csrc"
    sources = {
        "flash_attention": f"{csrc}/flash_attention.cu",
        "window_attention_rope": f"{csrc}/vision_attention.cu",
        "full_attention_rope": f"{csrc}/vision_attention.cu",
        "flash_bwd_dq": f"{csrc}/flash_attention_bwd.cu",
        "flash_bwd_dkv": f"{csrc}/flash_attention_bwd.cu",
        "shared_prefix_fwd": f"{csrc}/shared_prefix_attention.cu",
        "shared_prefix_bwd": f"{csrc}/shared_prefix_attention.cu",
        "shared_prefix_decode_attention": f"{csrc}/decode_attention.cu",
        "shared_prefix_decode_full": f"{csrc}/decode_attention.cu",
        "int4_matmul": f"{csrc}/int4_matmul.cu",
        "fused_mlp_int8": f"{csrc}/fused_mlp.cu",
        "paged_prefix_attention": f"{csrc}/paged_attention.cu",
        "paged_prefix_attention_q8": f"{csrc}/paged_attention.cu",
    }
    kernels = []
    for name, entry in checks.items():
        kernels.append({
            **entry,
            "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "launches": quant_launches.get(name, launches[name]),
        })
    # K1, K3 (phase 4), B1, B2, S1, S2, D2 (phase 5), Q1 (phase 6's int4 generate), P1, P2 (phase 7 (a),
    # (b)): their tensor-core launches (all of them: no FMA launch there)
    for k in kernels:
        if k["name"] in TC_KERNELS:
            k["tc_launches"] = quant_launches.get(f"{k['name']}_tc", launches[f"{k['name']}_tc"])
    # S2 is two kernels (dq at :739, the prefix dK/dV at :769): its entry gives both counts
    s2 = next(k for k in kernels if k["name"] == "shared_prefix_bwd")
    s2["launches_dkv_prefix"] = launches["shared_prefix_bwd_dkv"]
    s2["tc_launches_dkv_prefix"] = launches["shared_prefix_bwd_dkv_tc"]
    s2["replaces_dkv_prefix"] = f"{jax_fa}:769"
    # D2 runs on both G-way paths: `launches` is the int8 step_batch's (phase
    # 6), this the bf16 step_batch's (phase 5). D1 runs on no path since D2
    # folds its prefix chunks itself: 0 launches, checked in phases 5 and 6.
    for k in kernels:
        if k["name"] in DECODE_KERNELS:
            k["launches_bf16_step_batch"] = launches[k["name"]]
        if k["name"] == "shared_prefix_decode_attention":
            k["on_main_path"] = False
        if k["name"] in TRAIN_KERNELS:  # phase 8's second step_batch, from video frames
            k["launches_from_frames"] = input_launches[k["name"]]
            k["launches_cli_train"] = cli_launches[k["name"]]  # phase 9's main(): 4 step_batch calls
            k["launches_sf_round"] = sf_launches[k["name"]]  # phase 10 (a): 4 step_batch calls, 4 eval items
    s2["launches_sf_round_dkv_prefix"] = sf_launches["shared_prefix_bwd_dkv"]
    for k in kernels:  # phase 11 (a): 2 step_batch calls of LoRA GRPO on the 7B (Q2: 0 under side adapters)
        if k["name"] in TRAIN_KERNELS or k["name"] == "fused_mlp_int8":
            k["launches_lora_7b"] = lora_launches[k["name"]]
    s2["launches_lora_7b_dkv_prefix"] = lora_launches["shared_prefix_bwd_dkv"]
    for k in kernels:  # phase 12: (a) 4 step_batch calls of the 7B's full parameters, (c) one full-row 3B call
        if k["name"] in TRAIN_KERNELS or k["name"] == "fused_mlp_int8":
            k["launches_full_param_7b"] = full_param["full_param_7b"][k["name"]]
            k["launches_full_row_3b"] = full_param["full_row_3b"][k["name"]]
    s2["launches_full_param_7b_dkv_prefix"] = full_param["full_param_7b"]["shared_prefix_bwd_dkv"]
    for k in kernels:  # phase 13 (b): the 3B's CP loss step on each of 2 ranks, zig-zag (2n + 1 = 5 a layer)
        if k["name"] in parallel["cp_loss_3b_per_rank"]:
            k["launches_cp_loss_3b_per_rank"] = parallel["cp_loss_3b_per_rank"][k["name"]]
    s2["launches_full_row_3b_dkv_prefix"] = full_param["full_row_3b"]["shared_prefix_bwd_dkv"]
    for k in kernels:  # phase 14 (d): the 3B's split loss step on each of 2 ranks, at the rank's local heads
        for key, counts in sharded.items():
            if k["name"] in counts:
                k.setdefault("launches_sharded_loss_per_rank", {})[key] = counts[k["name"]]
    s2["launches_sharded_loss_per_rank_dkv_prefix"] = {key: c["shared_prefix_bwd_dkv"] for key, c in sharded.items()}
    for k in kernels:  # phase 15: each bf16 run of the TP Engine and of PPEngine, [rank 0, rank 1]
        for kind in ("tp", "pp"):
            runs = {name: [mesh[f"bf16_{name}"][k["name"]], mesh[f"bf16_{name}_rank1"][k["name"]]]
                    for name, engine, *_ in MESH_RUNS
                    if engine == kind and name not in MESH_F32_ONLY and k["name"] in mesh[f"bf16_{name}"]}
            if any(any(v) for v in runs.values()):
                k[f"launches_{kind}_engine"] = runs
    cmesh = mesh["cmesh"]
    for k in kernels:  # phase 16: each bf16 run over the mesh, [rank 0, rank 1]
        for key, names in (("launches_tp_paged", ("paged", "paged_int8")), ("launches_tp_continuous", ("continuous",)),
                           ("launches_tp_int4", ("int4_g1", "int4_g8"))):
            runs = {n: [r[k["name"]] for r in cmesh[f"bf16_{n}"]] for n in names if k["name"] in cmesh[f"bf16_{n}"][0]}
            if any(any(v) for v in runs.values()):
                k[key] = runs
    for k in kernels:  # phase 17: each bf16 run at tp 4 over the 3B's replicated kv heads, [rank 0, ..., rank 3]
        runs = {n: [r[k["name"]] for r in ranks] for n, ranks in kvrep.items() if k["name"] in ranks[0]}
        if any(any(v) for v in runs.values()):
            k["launches_kv_replicated"] = runs
    for k in kernels:  # phase 18: cli.parity's f32 and bf16 forwards (K2, K3 FMA + tensor-core), by model
        if k["name"] in FWD_TC and any(r["launches"][k["name"]] for r in parity.values()):
            k["launches_parity"] = {m: r["launches"][k["name"]] for m, r in parity.items()}
            k["tc_launches_parity"] = {m: r["launches"][f"{k['name']}_tc"] for m, r in parity.items()}
    close_rank_pool()
    log(f"[env] chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all, the kernels' build included")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
