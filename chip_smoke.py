"""Smoke test of the PyTorch + CUDA port (llamagen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on a failed check (exit code != 0):

1. Build the CUDA kernels from `llamagen_tpu_torch/csrc` (nvcc, ctypes).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes: decode attention (K1) with bf16 and int8 caches at
   GPT-L's heads (16 x 64) and GPT-3B's (32 x 100), per-row positions,
   prefix padding and GQA, and the serving engine's shape (B 128, slot
   positions 0, 31, 32, 63, 575 and a finished slot at 576, three steps
   across flushes, each row to a tolerance of its own); the W8A16 matmul
   (K2) at the GPT-L and GPT-3B layer shapes and the int8 head, B 1, 16,
   128 and 80. Each prints its max error beside its tolerance and its median time beside the plain version's, its bound
   (bytes over 3.35 TB/s or flops over 989 TFLOP/s, from this run's
   inputs) and a PyTorch library call on the same inputs where one exists
   (CUDA graphs of one call per layer, so the 24 layers' buffers stream
   from memory as they do in a step): K1 int8 and bf16 at head_dim 64
   and int8 at 100, K2 at B 16 on all nine layer shapes and the GPT-L
   int8 head; K1 (int8, bf16) and K2 (five GPT-L shapes and the int8
   head) again at the engine's B 128.
3. The main path: GPT-L 384 px, random seeded weights with a random head,
   W8A16 + int8 KV cache, batch 8 + CFG 2.0, 576 tokens, then the VQ-16
   decoder to [8, 384, 384, 3]. The kernels' launch counters must read
   exactly 24 * 575 (K1) and 5 * 24 * 576 (K2). Then the same at GPT-3B
   (24 layers, 32 heads of 100), full width and depth.
4. The CLI (`llamagen_tpu_torch.cli.sample_c2i`) once at GPT-L 384 with
   bf16 weights and cache, from a random checkpoint in a temp directory.
5. A teacher-forced comparison of kernels against plain versions over 64
   decode steps at GPT-L: bf16, W8A16 + int8 KV, and grouped W4 + bf16 KV;
   the same at GPT-3B's width, 4 layers, 16 steps.
6. The W4A16 matmul (K3) against its plain version at every GPT-L layer
   shape, per channel and grouped g128, B 16 and 80, bf16 x; f32 x, B 1,
   17, 81 and 320 (the kernel's 8-row tiles and 96-row passes) and a
   ragged group (K = 320); times at all five shapes, B 16 and 80, beside
   the plain version, the bound and `torch._weight_int4pack_mm` (tinygemm)
   where this torch runs it.
7. Chunk attention (K5) against its plain version: C 1, 5 and 8, bf16 and
   f32 caches, per-row positions with 0, 7, 8 and 639 - C, GQA rep 2 and
   4, prefix padding, a backward position jump across two calls; times at
   C 5, 1 and 8 beside the plain version, the bound, SDPA with the same
   row mask, and the cache write + SDPA (K5 does both).
8. The W4 sampling path: GPT-L 384, grouped W4 + bf16 KV, batch 8 + CFG
   2.0, 576 tokens, VQ-16 decode; counters exactly 5 * 24 * 575 (K3:
   prefill takes the dequantised fallback) and 24 * 575 (K1). (Phase 5
   teacher-forces the W4 model too, with K1 + K3 and with their plain
   versions.)
9. The speculative path: bf16 GPT-L target cut to 12 layers, a W4 copy
   of it drafting (self-speculation), k = 4, batch 8 + CFG 4.0, sampled,
   576 tokens; counters exactly 12 * (k + 2) * rounds (K5) and 5 * 12 *
   (k + 1) * rounds (K3). Then the same at 6 layers through the CLIs (`tools quantize-ckpt
   --mode w4` writes the draft checkpoint, `sample_c2i
   --draft-gpt-model`), and a greedy f32 check: 64 tokens of
   `generate_speculative` equal `generate`'s for the same target, at
   GPT-L and at GPT-3B's width (2 layers: K5 and K1 at head_dim 100).
10. The training-attention kernels (K4: forward, dq, dk/dv) against their
   plain version (dense f32 scores, autograd) on the card: the GPT-L
   training shape [32, 576, 16, 64] bf16 (v a strided view, as the model
   gives it), [2, 577, 8, 128] f32 and bf16, head_dim 100 (padded to 128),
   a ragged S = 257, the bf16 kernels' tile edges S 1, 65 and 129 at
   head_dim 64 and 128, and the GPT-XL t2i training shape [32, 375, 20,
   64] bf16 (v strided: S 375 ends mid-tile). Each prints its errors
   beside its tolerance; the GPT-L and the t2i shapes print forward, dq
   and dk/dv times beside the plain version's, the bound and SDPA's
   forward and backward (GPT-L also the times of the design K4 had
   before).
11. The training path: the CLI (`llamagen_tpu_torch.cli.train_c2i`) at
   GPT-L 384, batch 32, N synthetic steps with the default dropouts and
   full remat. The first loss must be ln 16384 (the zeroed head), every
   loss and grad norm finite, `metrics.jsonl` must hold steps 1..N and the
   final checkpoint must exist; the K4 counters must read 2 * 24 * N
   (forward: once in the step, once in the remat recompute) and 24 * N for
   each backward kernel. Prints step time, samples/s, tokens/s, peak
   memory and model-FLOP utilisation. Then 4 steps with remat "save_attn",
   where K4's forward runs once per layer and step.
12. One full training step at GPT-L (random head, dropout off) with K4 and
   with its plain version on the same weights and batch, in bf16 and in
   f32 compute: the loss difference and each parameter's relative
   gradient difference against stated bounds.
13. The serving engine (`serve/engine.py`) at `bench.py`'s engine point:
   GPT-L 384, W8A16 layers and head + int8 KV, 64 pairs (128 rows), chunk
   64; 80 requests (16 reuse a slot) with per-request cfg 1.5 / 2.0 /
   4.0, two with top-k 1000. The first chunk runs under
   `torch.cuda.set_sync_debug_mode("error")` (no device-to-host read
   inside a chunk); counters exactly 24 * steps (K1) and 121 * steps (K2:
   five matmuls a layer and the head), steps counted by the host; every result 576 tokens in range, 8 of them
   decoded to finite [8, 384, 384, 3]; prints img/s, TTFT, TPOT and e2e
   p50 / p95.
14. Greedy f32 engine == `generate` at GPT-L (2 pairs, 64 tokens).
15. The serving app (`python -m llamagen_tpu_torch.cli.app --quantize
   int8`, GPT-B 256 px) in a subprocess on a free port: three `GET
   /generate` (256 x 256 PNGs) and `GET /stats` (3 completed).
16. The T5 caption encoder (`text/t5.py::T5Encoder`) at flan-t5-xl's
   widths, random weights: bf16 against f32 on the card, 4 x 120 ids with
   right-padded masks.
17. The t2i sampling path: GPT-XL 512 px width (120 caption tokens +
   1,024 image tokens) cut to 18 layers, bf16 weights and cache, 4
   captions left-padded by 0, 60, 100 and 119 + CFG 7.5, top-k 1000; K1
   with `prefix_pad` exactly 18 * 1023 times; the VQ-16 decoder to finite
   [4, 512, 512, 3].
18. The t2i serving engine at `tests/bench_t2i_engine.py`'s point (GPT-XL
   256 px, W8A16 layers and head + int8 KV, 8 pairs, 24 caption requests
   with pads in [0, 60)); the first admission and chunk under sync-debug
   "error"; the counters read around every admission prefill and every
   chunk: exactly 0 (K1) and 181 (K2) per admission, 36 (K1) and 181 (K2)
   per step; img/s, TTFT, TPOT and e2e.
19. Greedy f32 t2i engine == `generate(emb_masks=...)` (GPT-XL width, 2
   layers, W8A16 + int8 KV, 48 tokens across the flushes at 127 and 159).
20. The t2i speculative path: GPT-XL 512 cut to 4 layers, bf16 target, a
   W4 copy of it drafting, k 4, the 4 padded captions of phase 17 + CFG
   7.5, top-k 1000, 1,024 tokens; K5 with `prefix_pad` in every draft and
   verify step: counters exactly 4 * (k + 2) * rounds (K5) and 5 * 4 *
   (k + 1) * rounds (K3), K1 none.
21. Greedy f32 t2i speculative == `generate` (GPT-XL width, 2 layers, W4
   self-draft, k 4; K5 at 20 heads with `prefix_pad`, counted).
22. The t2i CLI (`llamagen_tpu_torch.cli.sample_t2i`) at its defaults.
23. The VQ-16 encoder and quantizer at full width, 32 x 256 px: f32 (TF32
   off) and bf16 times, the share of bf16 ids equal to f32's, the card's
   f32 ids equal to the port's CPU f32 ids on 2 images, the f32 encode ->
   decode round trip (finite PSNR / SSIM, codebook usage).
24. The tokenizer CLIs' batch functions (`extract_codes.encode_batch` in
   the plain, flip and ten-crop layouts, `reconstruction_vq`'s round
   trip and scores) on seeded uint8 crops: shapes, int16 codes, finite.
25. t2i training through `train/t2i.py::build_trainer`: GPT-XL 256 px,
   120 caption rows x 2048 left-padded by 0-119, one sample with valid 0,
   batch 32, bf16, full remat, the JAX CLI's dropouts, the frozen bf16
   VQ-16 encoding the images in the step, 10 steps; K4 counters exactly
   2 * 36 * N and 36 * N, the first loss ln 16384, all finite, the VQ
   weights bit-unchanged; s/step, samples/s, MFU and peak memory.
26. One t2i training step with K4 and with the plain attention (GPT-XL
   width, 4 layers), bf16 and f32, within phase 12's bounds.
27. The t2i training CLI (`llamagen_tpu_torch.cli.train_t2i
   --synthetic-steps 3`) at its defaults (GPT-XL, batch 256): counters
   2 * 36 * 3 and 36 * 3, the checkpoint written.
28. VQ-GAN tokenizer training through `train/vq.py::build_trainer`:
   VQ-16 at 256 px, batch 32, bf16 compute over f32 weights, per-block
   remat, a full-width random LPIPS, PatchGAN, hinge, l2, disc_start 0,
   EMA, 10 steps on seeded random images; then StyleGAN with the adaptive
   weight and dropout 0.1 for 3 steps. Every metric finite, the step
   counts, the adaptive weight finite and positive, the usage window
   shifted by each step's 8,192 ids, the EMA moved; s/step, img/s, peak
   memory, the first and last losses. The path runs no kernel of the port.
29. One f32 VQ-GAN step (TF32 off) at narrow width (VQ-8, ch 32, 32 px,
   batch 4, LPIPS, PatchGAN, the adaptive weight, dropout 0) from the same
   weights on the card and on the CPU: metrics, gradients and updated
   parameters within `VQ_CPU_BOUNDS`, the usage windows (the ids) equal.
30. The VQ-GAN CLI (`llamagen_tpu_torch.cli.train_vq --synthetic-steps 3
   --disc-start 0`) at its defaults (VQ-16, 256 px, batch 128, bf16,
   remat), LPIPS loaded from random state dicts in torchvision's and the
   reference's key layouts; the checkpoint loads into `VQModel(cfg,
   encoder=True)`; its log lines and peak memory.
31. Training across ranks at one NCCL rank (`python -m
   torch.distributed.run --standalone --nproc_per_node 1 chip_smoke.py
   --rank-worker world1 ...`: the process group is made at world size 1,
   so the sharded code runs): the c2i CLI of phase 11 with `--fsdp 1`
   (FSDP2), its losses and grad norms held to phase 11's (WORLD1_BOUNDS;
   bitwise is expected), its K4 counters exactly phase 11's, its step
   time and peak memory beside phase 11's; the final DCP checkpoint
   resumed for one step through `--resume` (step 11, K4 2 * 24, 24, 24);
   the rank-0 whole-model export loaded by `cli/common.py::load_gpt`.
32. GPT-XL t2i training of phase 25 sharded by FSDP2 at that rank, 3
   steps (120 caption rows, one sample with valid 0): its losses held to
   phase 25's first three, K4 2 * 36 * 3 and 36 * 3.
33. The VQ-16 VQ-GAN at 256 px, batch 32, PatchGAN with the adaptive
   weight and an entropy term of 0.1, 3 steps, one process then DP at
   that rank in the same process: the first step's losses held to one
   process's, step time and peak memory side by side.
34. Two ranks on the one card over gloo with CUDA tensors
   (`--rank-worker two_ranks`): GPT-L width cut to 4 layers, global batch
   16 (8 a rank), f32 compute, 3 steps under FSDP2 (`--fsdp 2`) and DDP
   (`--dp 2`), each rank's K4 counters exactly 2 * 4 * 3 and 4 * 3; then
   the VQ-16 VQ-GAN (f32, LPIPS, PatchGAN, adaptive weight, entropy) under
   DP; everything against one process on the same global batch
   (TWO_RANK_BOUNDS, VQ_CPU_BOUNDS, VQ_RATIO_BOUND; the usage window
   equal after the first step).
35. GPTQ + AWQ at GPT-L 384 width, 12 layers: `tools quantize-ckpt --mode
   w4 --method gptq --quantize-head` on the card (32 calibration samples;
   the CLI's default is 128), without and with `--awq`, each timed; every
   matrix of the first and the last layer with a smaller H-weighted error
   tr(dW^T H dW) than round-to-nearest's; layer 0's wqkv levels equal to
   the CPU port's walk on the same W and H (>= 99.9 %, scales 1e-5).
36. The speculative serving engine (`serve/spec_engine.py`): the W8A16
   target (layers and int8 head) of phase 35's weights, its GPTQ W4 g128
   self-draft, 8 pairs, k 4, bf16 caches, 12 requests (4 reuse a slot)
   with mixed cfg, temperature, top-k and two greedy rows; every
   admission and chunk under sync debug "error"; counters exactly K5
   rounds * 12 * (k + 2), K3 rounds * 5 * 12 * (k + 1), K2 rounds * (61 +
   k + 1) + admissions * 62; img/s, ms per round, tokens per round, the
   acceptance rate and the device's busy share over 4 rounds.
37. Greedy f32 speculative engine == `generate` (and == `ServeEngine`):
   c2i at GPT-L width, 2 layers, per-request cfg 1.5 / 2.0 / 4.0 / 3.0;
   t2i at GPT-XL width, 2 layers, pads 0 / 60 / 100 / 119.
38. InceptionV3 (`eval/inception.py`, pytorch-fid's keys, random weights
   loaded from a saved .pth) at full width: pool3 / spatial / logits of 4
   images of 256 px within 1e-4 of each output's largest |value| of the
   CPU port (f32, TF32 off); img/s over 256 images at batch 64.
39. The c2i FID sampler (`cli/sample_c2i_fid.py`) at GPT-L 384 -> 256 px,
   bf16 weights and cache, 32 labels + CFG 2.0 a block, 32 samples (one
   block, cut from two for the smoke's clock), a random checkpoint: K1
   (bf16 entry) exactly 24 * 575 launches and no other kernel, a [32,
   256, 256, 3] uint8 .npy, img/s and ms per step; under
   `torch.distributed.run --nproc_per_node 1` its rows equal the same
   32; one block at seed 1 (phase 40's reference batch).
40. `cli/evaluate.py` (random Inception) on phase 39's batch against the
   seed-1 block: IS, FID, sFID, precision and recall finite; seconds per
   part.
41. The t2i FID sampler (`cli/sample_t2i_fid.py`) at GPT-XL 256 px, a
   random checkpoint, `--random-t5`, 4 prompts of 2-21 words in one
   batch, CFG 7.5, top-k 1000: K1 with `prefix_pad` exactly 36 * 255
   launches and no other kernel, `result.jsonl` and PNGs; `ClipScorer`
   at ViT-B/32 width (random, a stub tokenizer) on them; `cli/
   evaluate_t2i.py`'s FID against phase 39's reference batch.
42. `cli/reconstruction_baseline.py` with the backends sd-vae (f8, ch
   128), taming (f16, 16384 codes) and cd (base 320, mult 1, 1, 2, 3, 4)
   on 8 images of 256 px from random checkpoints in their published
   layouts: PSNR / SSIM and seconds per image; sd-vae's and taming's
   roundtrips of 1 image within 1e-4 of the CPU port's.

43. Tensor parallelism, the kernels (`check_tp_kernels`): K1 (int8 and
   bf16 caches) at a tp-2 rank's heads, GPT-XXL's 12 (B 16, slot
   positions) and GPT-XL's 10 with the t2i pads; K2 at GPT-XXL tp 2's
   four shard shapes (B 16) and GPT-XL tp 2's wqkv shard at a 4-pair
   admission's 960 rows; K3 (per-shard g128) at GPT-XXL tp 2's shards;
   K4 at GPT-L tp 2's [16, 576, 8, 64]: each against its plain version
   (phase 2's tolerances), then timed beside it, its bound and its
   library call.
44. The TP slot engine in two gloo ranks sharing the card (`--rank-worker
   tp_serving`): GPT-XXL 384 width cut to 4 of 48 layers, tp 2, W8A16
   layers with a bf16 head + int8 KV, 8 pairs, 12 requests (4 reuse a
   slot) with mixed cfg 1.5 / 2.0 / 4.0 and temperature 1.0 / 0.7 /
   greedy; each rank's counters exactly 4 * steps (K1), 5 * 4 * steps
   (K2: a c2i admission runs no prefill, the bf16 head no K2), no K3 or
   K5; the tokens equal on both ranks; img/s, ms a step, each rank's
   device busy share of steps of the same engine, and the step's
   collectives timed alone (8 all-reduces and the logits' gather over
   gloo). Then the per-shard W4 engine (8 requests of 192 tokens): K3
   exactly 5 * 4 * steps, K2 none.
45. The t2i TP engine (GPT-XL 256 px width, 4 of 36 layers, W8A16 + bf16
   head + int8 KV, 4 pairs, CFG 7.5, the pads of phase 17): one batched
   admission prefill of the 4 pairs, as on one card, exactly 0 K1 and 5 *
   4 K2, each step 4 K1 (with `prefix_pad`) and 5 * 4 K2; tokens equal
   on both ranks. Then greedy f32 TP engine == the one-card `generate`
   at GPT-XXL width, 2 layers.
46. TP training (`--rank-worker tp_train`, two gloo ranks): GPT-L width
   cut to 4 layers, global batch 16, f32, 3 steps through `build_trainer`
   on a (1, 1, 2) mesh against one process (TWO_RANK_BOUNDS), K4 exactly
   2 * 4 * 3 and 4 * 3 per rank; then `cli/train_c2i.py --tp 2 --fsdp 1
   --backend gloo` (bf16) for 3 steps, the same counts, its whole-model
   export loaded by `load_gpt`; the step's logits gather ([16, 576, 8192]
   f32 a rank, `all_gather_into_tensor`) timed alone.
47. FSDP2 x TP at (1, 2, 2): four gloo ranks, one f32 step against one
   process's first (TWO_RANK_BOUNDS).
48. Checkpoints across layouts, riding phases 46-47's launches: the
   one-process run of phase 46's reference saves a `.pt` of step 2,
   which the two tp-2 ranks resume; they save a DCP directory of their
   own step 2, which the four (1, 2, 2) ranks and this process resume.
   Each load, made whole, equals the saved state bit for bit
   (parameters, both Adam moments, EMA, step); each resumed step 3
   matches the unbroken run's loss and grad norm within TWO_RANK_BOUNDS,
   with K4 exactly 2 * 4, 4 and 4 launches a rank; the seconds to save
   and to load and the GB on disk against the `.pt`'s are printed.

Phase 2 also holds K1 (bf16 and int8) and K5 at GPT-XL's 20 heads with the
t2i paths' positions and pads 0, 60, 96, 100 and 119 against their plain
versions, K2 at the GPT-XL shapes (B 16 and the admission's 1,920 rows),
and times them there; K1's bf16 entry at the FID samplers' shapes (c2i B
64, S 640; t2i B 8, S 384 with pads); and the int4 storage mode
(`bits=4`, plain PyTorch) at GPT-L's wqkv, its levels and product on the
card against the CPU's.

Comparisons run in bf16 (K4 also f32) with TF32 off for matmuls and
convolutions. The
last line is `{"ok": true, "device": {...}}`; the line before it is the
kernels' JSON record (K1-K5: launches on their path, errors, times, bound,
library time; then K1, K2 and K5 again at the t2i sampling shapes, K4 at
the t2i training shape, K2, K3 and K5 on the speculative engine's path,
K1 on the FID samplers' paths, K1, K2, K3 and K4 at the TP ranks'
shapes, and K4 on the step after a checkpoint resumed at tp 2), the one
before that the card's name and power limit.
Needs a CUDA device; runs nothing without one.
"""

import contextlib
import faulthandler
import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

BATCH, CFG_SCALE, TOKENS = 8, 2.0, 576
TRAIN_BATCH, TRAIN_STEPS = 32, 10
# t2i training: GPT-XL 256 px, 120 caption rows + 255 image tokens, 20
# heads of 64: K4's shape in every layer of the step
T2I_TRAIN_SHAPE = (TRAIN_BATCH, 120 + 255, 20, 64)
VQ_CPU_IMAGES = 2  # the f32 encode held to the CPU's on these images
H100_BF16_FLOPS = 989e12  # dense, NVIDIA's data sheet (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3, the same data sheet
SPEC_K, SPEC_CFG = 4, 4.0  # the sampling CLI's default --spec-k, --cfg-scale
# the speculative paths' depth (GPT-L has 24): the path, GPTQ + AWQ and
# the engine at 12; the speculative CLI at 6 (all 24 until the TP phases
# joined the smoke's clock)
SPEC_LAYERS, SPEC_CLI_LAYERS = 12, 6
# the t2i paths' depths (GPT-XL has 36; the speculative path had 18 and
# `generate` all 36 until the TP phases joined the smoke's clock)
T2I_SPEC_LAYERS, T2I_PATH_LAYERS = 4, 18
# bench.py's engine point (64 pairs, int8 head, chunk 64); 80 requests: a
# full wave and 16 that reuse a slot
ENGINE_PAIRS, ENGINE_REQUESTS, ENGINE_CHUNK = 64, 80, 64
ENGINE_ROWS = 2 * ENGINE_PAIRS  # cond + uncond rows of the engine's slots
# t2i: GPT-XL, 120 caption tokens of T5 width 2048; sampling at 512 px
# (1,024 tokens), 4 captions + CFG 7.5, top-k 1000 (the JAX CLI's
# defaults), left pads T2I_PADS; the engine at `tests/bench_t2i_engine.py`'s
# point: 256 px, W8A16 layers and head + int8 KV, 8 pairs, 24 requests
# with pads in [0, 60) from RandomState(0); admission prefills of up to 8
# pairs, 2 * 8 * 120 rows
T2I_T, T2I_CAPTION, T2I_BATCH, T2I_CFG, T2I_TOP_K = 120, 2048, 4, 7.5, 1000
T2I_PADS = (0, 60, 100, 119)
T2I_PAD_CASES = (0, 60, 96, 100, 119)  # the kernel checks' pads
T2I_ENGINE_PAIRS, T2I_ENGINE_REQUESTS, T2I_ENGINE_CHUNK = 8, 24, 64
T2I_ADMIT_ROWS = 2 * 8 * T2I_T
# VQ-GAN training: VQ-16 at 256 px, batch 32 (the CLI's is 128)
VQ_GAN_BATCH, VQ_GAN_STEPS, VQ_GAN_STYLEGAN_STEPS = 32, 10, 3
# card vs CPU f32 step: metrics (relative, absolute); gradients, as a share
# of the model's largest (f32 rounding puts a (leaky) ReLU input within a
# few ulps of 0 on the other slope now and then, and batch means of
# cancelling terms amplify it; tests/test_torch_train_vq.py measures it);
# parameters within 1 % of lr where the gradient is at least 10x that
# share of the largest, 2 lr (Adam's bound) elsewhere
VQ_CPU_BOUNDS = {"metric": (3e-4, 1e-6), "vq": 5e-3, "disc": 5e-2}
GPT_L_MATMULS = {"wqkv": (1024, 3072), "wo": (1024, 1024),
                 "w1": (1024, 2816), "w3": (1024, 2816), "w2": (2816, 1024)}
# GPTQ + AWQ and the speculative engine: GPT-L 384 width cut to
# SPEC_LAYERS layers (a zoo entry of this script's, SPEC_MODEL); GPTQ
# calibrates on GPTQ_CALIB random samples (the CLI's default is 128); the
# engine: a W8A16 target (layers and int8 head), its GPTQ W4 g128 copy
# drafting (int8 head), 8 pairs, k 4, bf16 caches, 12 requests (4 reuse a
# slot); the verify's layer matmuls take 2P * (k + 1) = 80 rows; K5's
# timing gives the pairs these positions (cond and uncond rows alike)
SPEC_MODEL, GPTQ_CALIB = f"GPT-L-{SPEC_LAYERS}", 32
SPEC_ENGINE_PAIRS, SPEC_ENGINE_REQUESTS = 8, 12
SPEC_ENGINE_ROWS = 2 * SPEC_ENGINE_PAIRS * (SPEC_K + 1)
SPEC_ENGINE_CACHE = 1 + TOKENS + (SPEC_K + 1) + 16  # the engine's rows
SPEC_ENGINE_POS = tuple(32 + 72 * i for i in range(SPEC_ENGINE_PAIRS))


def log(msg):
    print(msg, flush=True)


def graph_ms(calls, reps=5):
    """Median ms per call of `calls` (zero-arg callables, one per layer),
    captured in one CUDA graph and replayed, so no host overhead counts."""
    for fn in calls:  # warm up (allocator, first launches) outside capture
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in calls:
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over 3.35 TB/s and the operations over 989
    TFLOP/s (bf16 dense; H100 SXM data sheet, 700 W)."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def library_time(label, fn):
    """Median ms of one PyTorch library call (the yardstick, used nowhere in
    the port), or None, with the reason printed, where the installed torch
    does not run it on this card."""
    try:
        return fn()
    except (RuntimeError, AttributeError, NotImplementedError, TypeError,
            ValueError) as e:
        log(f"{label}: not available here ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:160]})")
        return None


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def attention_state(dev, b, h, h_kv, s, cache, seed, d=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    f_kv = h_kv * d
    bf = torch.bfloat16
    q = torch.randn(b, h * d, generator=g, device=dev).to(bf)
    kv_new = torch.randn(b, 2 * f_kv, generator=g, device=dev).to(bf)
    if cache == "bf16":
        kv = torch.randn(b, s, 2 * f_kv, generator=g, device=dev).to(bf)
        return q, kv_new, kv, {}
    kv = torch.randint(-127, 128, (b, s, 2 * f_kv), generator=g, device=dev,
                       dtype=torch.int8)
    extra = dict(
        kv_scale=(torch.rand(b, s, 2, generator=g, device=dev) * 0.02
                  + 1e-3).to(bf),
        tail=torch.randn(b, 32, 2 * f_kv, generator=g, device=dev).to(bf))
    return q, kv_new, kv, extra


def t2i_rows(dev, b, s, g):
    """Per-row positions and left pads as the t2i paths give them (120
    caption rows): positions in [120, S) with 120, 127 (int8 flush of tail
    rows [96, 128), pad rows among them), 128, 159 and S - 1 first; pads
    0, 60, 96 (every valid caption row in the int8 tail), 100 and 119 (one
    valid token) in turn."""
    pos = torch.randint(120, s, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    first = torch.tensor([120, 127, 128, 159, s - 1], dtype=torch.int32,
                         device=dev)[:b]
    pos[:len(first)] = first
    pads = torch.tensor([T2I_PAD_CASES[i % len(T2I_PAD_CASES)]
                         for i in range(b)], dtype=torch.int32, device=dev)
    return pos, pads


def check_decode_attention(dev):
    """K1 against decode_attention_ref: B 16, S 640, bf16 and int8 caches,
    GPT-L heads (16 x 64) and GPT-3B heads (32 x 100), positions around
    the int8 flush and the cache's end, per-row positions with prefix
    padding, GQA; GPT-XL's 20 heads x 64 with the t2i paths' positions and
    pads (`t2i_rows`) at their shapes (bf16: B 8, S 1152, 512 px `generate`;
    int8: B 16, S 384, the 256 px engine) and at B 4 (splits); output to 4
    bf16 ulps of its largest value, caches, scales and tails exactly. Then
    the times (`time_decode_attention`)."""
    from llamagen_tpu_torch.ops.attention import (decode_attention,
                                                  decode_attention_ref)
    worst = 0.0
    g = torch.Generator(device=dev).manual_seed(7)
    # (cache, pos, heads, kv heads, pad, head_dim, B, S)
    cases = ([("bf16", p, 16, 16, None, 64) for p in (0, 1, 127, 128, 575)]
             + [("int8", p, 16, 16, None, 64) for p in (0, 30, 31, 32, 575)]
             + [("bf16", "per-row", 16, 16, "pad", 64),
                ("int8", "per-row", 16, 16, "pad", 64),
                ("bf16", 300, 16, 4, None, 64),
                ("int8", 415, 16, 4, "pad", 64)]
             + [(c, p, 32, 32, None, 100) for c in ("bf16", "int8")
                for p in (31, 288, 575)]
             + [("int8", "per-row", 32, 32, "pad", 100),
                ("bf16", "per-row", 16, 16, "pad", 100)])
    cases = [c + (16, 640) for c in cases] + [
        ("bf16", "t2i", 20, 20, "t2i", 64, 8, 1152),
        ("bf16", "t2i", 20, 20, "t2i", 64, 4, 1152),
        ("int8", "t2i", 20, 20, "t2i", 64, 16, 384),
        ("int8", "t2i", 20, 20, "t2i", 64, 4, 384),
        # the FID samplers: c2i B 2 * 32 at S 640, t2i 256 px B 2 * 4
        ("bf16", "per-row", 16, 16, None, 64, 2 * FID_BATCH, 640),
        ("bf16", "t2i", 20, 20, "t2i", 64, 2 * len(FID_PROMPTS), 384)]
    for i, (cache, pos, h, h_kv, pad, d, b, s) in enumerate(cases):
        q, kv_new, kv, extra = attention_state(dev, b, h, h_kv, s, cache, i,
                                               d)
        pad_t = None
        if pos == "t2i":
            pos, pad_t = t2i_rows(dev, b, s, g)
        if pos == "per-row":
            pos = torch.randint(1, 576, (b,), generator=g, device=dev,
                                dtype=torch.int32)
            pos[:4] = torch.tensor([31, 63, 64, 575], device=dev)
        if pad == "pad":  # masked left padding, never past the row's position
            pad_t = torch.minimum(
                torch.randint(0, 40, (b,), generator=g, device=dev,
                              dtype=torch.int32),
                torch.as_tensor(pos, dtype=torch.int32, device=dev))
        kv_ref = kv.clone()
        extra_ref = {k: v.clone() for k, v in extra.items()}
        out = decode_attention(q, kv_new, kv, pos, h, prefix_pad=pad_t,
                               **extra)
        ref = decode_attention_ref(q, kv_new, kv_ref, pos, h,
                                   prefix_pad=pad_t, **extra_ref)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        # bf16 output of f32 sums taken in another order, p rounded to
        # bf16 for the product with v: 4 bf16 ulps of the largest output
        tol = 2 ** -6 * max(1.0, ref.float().abs().max().item())
        same = torch.equal(kv, kv_ref) and all(
            torch.equal(extra[k], extra_ref[k]) for k in extra)
        label = (f"K1 decode_attention {cache} cache, B {b}, S {s}, "
                 f"head_dim {d}, pos "
                 f"{'per-row' if torch.is_tensor(pos) else pos}, "
                 f"H/H_kv {h}/{h_kv}, prefix_pad "
                 f"{'no' if pad is None else pad}")
        log(f"{label}: max_abs_err {err:.3g} (tol {tol:.3g}, "
            f"{err / max(1.0, ref.float().abs().max().item()):.3g} of the "
            f"largest output), cache/scales/tail equal: {same}")
        if not (err <= tol and same):
            raise AssertionError(f"{label} disagrees with the plain version")
        worst = max(worst, err)
    worst = max(worst, check_decode_attention_engine(dev))
    timings = time_decode_attention(dev)
    timings.update(time_decode_attention(
        dev, shapes=(("int8", 16, 64), ("bf16", 16, 64)), b=ENGINE_ROWS))
    # the t2i paths: bf16 at 512 px (B 8, S 1152, mean position 632),
    # int8 in the 256 px engine (B 16, S 384, mean position 248)
    timings.update(time_decode_attention(
        dev, shapes=(("bf16", 20, 64),), b=2 * T2I_BATCH, s=1152, pos=632,
        pads=T2I_PADS, tag=" t2i"))
    timings.update(time_decode_attention(
        dev, shapes=(("int8", 20, 64),), b=2 * T2I_ENGINE_PAIRS, s=384,
        pos=248, pads=T2I_PADS, tag=" t2i"))
    # the FID samplers (bf16 caches): c2i GPT-L at B 64, S 640, mean
    # position 288; t2i GPT-XL 256 px at B 8, S 384, mean position 248
    timings.update(time_decode_attention(
        dev, shapes=(("bf16", 16, 64),), b=2 * FID_BATCH, tag=" fid"))
    timings.update(time_decode_attention(
        dev, shapes=(("bf16", 20, 64),), b=2 * len(FID_PROMPTS), s=384,
        pos=248, pads=T2I_PADS, tag=" t2i fid"))
    return worst, timings


def row_tolerance(ref):
    """[B, 1]: 4 bf16 ulps of each output row's own largest value (floor
    2^-20), so a row that averages many cache rows to small values is held
    as tightly as the pos-0 row that copies v_new."""
    return 2 ** -6 * ref.float().abs().amax(-1, keepdim=True) \
        .clamp_min(2 ** -14)


def check_decode_attention_engine(dev):
    """K1 at the serving engine's shape: B 128 (64 slot pairs, cond rows
    over uncond rows, both rows of a pair at one position), GPT-L heads,
    S 640, int8 and bf16 caches; slot positions spread as the engine
    spreads them (0, 31, 32, 63, 575 and a finished slot held at 576),
    three consecutive steps (31 and 63 flush at the first, 575 reaches 576,
    the finished slot stays). Every output row to 4 bf16 ulps of its own
    largest value (`row_tolerance`), caches, scales and tails exactly,
    after every step."""
    from llamagen_tpu_torch.ops.attention import (decode_attention,
                                                  decode_attention_ref)
    b, h, s = ENGINE_ROWS, 16, 640
    worst = 0.0
    for cache in ("int8", "bf16"):
        g = torch.Generator(device=dev).manual_seed(33)
        _, _, kv, extra = attention_state(dev, b, h, h, s, cache, 70)
        kv_ref = kv.clone()
        extra_ref = {k: v.clone() for k, v in extra.items()}
        slot_pos = torch.randint(1, 575, (b // 2,), generator=g, device=dev,
                                 dtype=torch.int32)
        slot_pos[:6] = torch.tensor([0, 31, 32, 63, 575, 576], device=dev)
        for step in range(3):
            pos = torch.cat([slot_pos, slot_pos])
            q, kv_new, _, _ = attention_state(dev, b, h, h, 1, "bf16",
                                              80 + step)
            out = decode_attention(q, kv_new, kv, pos, h, **extra)
            ref = decode_attention_ref(q, kv_new, kv_ref, pos, h,
                                       **extra_ref)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            tol = row_tolerance(ref)
            ratio = ((out.float() - ref.float()).abs() / tol).max().item()
            same = torch.equal(kv, kv_ref) and all(
                torch.equal(extra[k], extra_ref[k]) for k in extra)
            label = (f"K1 decode_attention at the engine's shape, {cache} "
                     f"cache, B {b}, slot positions 0/31/32/63/575/576+, "
                     f"step {step}")
            log(f"{label}: max_abs_err {err:.3g}, row tolerances "
                f"{tol.min().item():.3g}..{tol.max().item():.3g}, worst "
                f"error / its row's tolerance {ratio:.3g}, "
                f"cache/scales/tail equal: {same}")
            if not (ratio <= 1.0 and same):
                raise AssertionError(f"{label} disagrees with the plain "
                                     f"version")
            worst = max(worst, err)
            slot_pos = torch.where(slot_pos < 576, slot_pos + 1, slot_pos)
    return worst


def time_decode_attention(dev, full=True,
                          shapes=(("bf16", 16, 64), ("int8", 16, 64),
                                  ("int8", 32, 100)), b=16, s=640, pos=288,
                          pads=None, tag=""):
    """K1 per call at the main path's mean decode position (pos 288), B 16
    (128: the serving engine's rows, keys "... B128"), S 640, one buffer set
    per layer (24) as in a step, for each (cache, heads, head_dim) of
    `shapes`: by default int8 and bf16 caches at GPT-L's heads (16 x 64),
    an int8 cache at GPT-3B's (32 x 100). `s`, `pos` and `pads` (left pads
    taken by the rows in turn, as `prefix_pad`) give the t2i paths' calls
    (keys "... t2i"). With `full`, also the plain version, the bound and,
    on the bf16 cache, SDPA over the cache with the row mask (no library
    call reads an int8 cache with row scales)."""
    from llamagen_tpu_torch.ops.attention import (decode_attention,
                                                  decode_attention_ref)
    timings = {}
    pad_l = [0] * b if pads is None else [pads[i % len(pads)]
                                          for i in range(b)]
    pad_t = None if pads is None else torch.tensor(pad_l, dtype=torch.int32,
                                                   device=dev)
    for cache, h, d in shapes:
        key = (cache if d == 64 else f"{cache} d{d}") \
            + ("" if b == 16 else f" B{b}") + tag
        states = [attention_state(dev, b, h, h, s, cache, 100 + l, d)
                  for l in range(24)]
        ms = graph_ms([lambda st=st: decode_attention(
            st[0], st[1], st[2], pos, h, prefix_pad=pad_t, **st[3])
            for st in states])
        if not full:
            timings[key] = dict(ms=ms)
            log(f"K1 time, {cache} cache, B {b}, H {h} x {d}, pos {pos}: "
                f"kernel {ms:.4f} ms")
            continue
        plain = graph_ms([lambda st=st: decode_attention_ref(
            st[0], st[1], st[2], pos, h, prefix_pad=pad_t, **st[3])
            for st in states])
        # bytes one call must move: q, kv_new and out, each row's rows
        # [pad, pos] (int8: rows below bnd = pos - pos % 32 int8 with their
        # bf16 scales, rows [bnd, pos) from the bf16 tail, row pos from
        # kv_new), and the row it writes (cache or tail)
        q, kv_new, kv, extra = states[0]
        row = kv.shape[2]
        bnd = pos - pos % 32 if cache == "int8" else pos
        moved = nbytes(q, kv_new, q) + b * row * 2
        for pd in pad_l:
            lo = min(max(pd, bnd), pos)
            moved += max(0, bnd - pd) * row * kv.element_size() \
                + (pos - lo) * row * 2 \
                + (max(0, bnd - pd) * 4 if cache == "int8" else 0)
        bnd_ms, by = bound(moved, sum(4 * h * d * (pos + 1 - pd)
                                      for pd in pad_l))
        lib = None
        if cache == "bf16":  # SDPA over the cache with the row mask
            f = h * d
            qs = [st[0].view(b, h, 1, d) for st in states]
            ks = [st[2][..., :f].view(b, s, h, d).transpose(1, 2)
                  for st in states]
            vs = [st[2][..., f:].view(b, s, h, d).transpose(1, 2)
                  for st in states]
            cols = torch.arange(s, device=dev)
            mask = ((cols <= pos)[None, :] & (cols[None, :] >= torch.tensor(
                pad_l, device=dev)[:, None])).view(b, 1, 1, s)
            lib = library_time("K1 library (SDPA)", lambda: graph_ms(
                [lambda i=i: F.scaled_dot_product_attention(
                    qs[i], ks[i], vs[i], attn_mask=mask)
                 for i in range(len(states))]))
        timings[key] = dict(ms=ms, plain=plain, bound=bnd_ms, by=by,
                            library=lib)
        log(f"K1 time, {cache} cache, B {b}, H {h} x {d}, pos {pos}, S {s}"
            f"{'' if pads is None else f', prefix_pad {pads} in turn'}:"
            f" kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd_ms:.4f} "
            f"ms ({by}), SDPA "
            f"{'n/a (int8 cache)' if lib is None else f'{lib:.4f} ms'}")
        del states
    return timings


GPT_3B_MATMULS = {"3B wqkv": (3200, 9600), "3B wo": (3200, 3200),
                  "3B w1": (3200, 8704), "3B w2": (8704, 3200)}
# GPT-XL (the t2i model) with its int8 head; w3 has w1's shape
GPT_XL_MATMULS = {"XL wqkv": (1280, 3840), "XL wo": (1280, 1280),
                  "XL w1": (1280, 3584), "XL w2": (3584, 1280),
                  "XL head": (1280, 16384)}


def check_int8_matmul(dev):
    """K2 against int8_matmul_ref at the GPT-L, GPT-3B and GPT-XL layer
    shapes and the GPT-L and GPT-XL int8 heads, B 16, 1, 128 and 80 (the
    speculative engine's verify; bf16 x) and B 80 (f32 x), the GPT-XL
    layer shapes also at the t2i engine's
    admission prefill (2 * 8 pairs * 120 = 1,920 rows: 20 passes of 96;
    its head runs on the last position only): one bf16 ulp of the
    largest output, f32 1e-5 of it. Then the times (`time_int8_matmul`)."""
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     int8_matmul_ref,
                                                     quantize_weight)
    g = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    shapes = dict(GPT_L_MATMULS, head=(1024, 16384), **GPT_3B_MATMULS,
                  **GPT_XL_MATMULS)
    for name, (k, n) in shapes.items():
        w_q, w_s = quantize_weight(
            torch.randn(k, n, generator=g, device=dev) * 0.02)
        rows = ((16, torch.bfloat16), (1, torch.bfloat16),
                (ENGINE_ROWS, torch.bfloat16), (80, torch.float32),
                (SPEC_ENGINE_ROWS, torch.bfloat16))
        if name in GPT_XL_MATMULS and name != "XL head":
            rows += ((T2I_ADMIT_ROWS, torch.bfloat16),
                     (T2I_ADMIT_ROWS, torch.float32))
        for b, dtype in rows:
            x = torch.randn(b, k, generator=g, device=dev).to(dtype)
            out = int8_matmul(x, w_q, w_s)
            ref = int8_matmul_ref(x, w_q, w_s)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            # one rounding of f32 sums taken in another order: 1 bf16 ulp
            # of the largest output (f32: 1e-5 of it)
            rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
            tol = rel * ref.float().abs().max().item()
            log(f"K2 int8_matmul {name} [{b},{k}]x[{k},{n}] "
                f"{str(dtype)[6:]} x: max_abs_err {err:.3g} (tol {tol:.3g})")
            if not err <= tol:
                raise AssertionError(f"K2 {name} B={b} disagrees")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    check_int4_storage(dev)
    timings = time_int8_matmul(dev)
    timings.update(time_int8_matmul(dev, b=ENGINE_ROWS, shapes=dict(
        GPT_L_MATMULS, head=(1024, 16384))))
    # the t2i engine: 16 rows a step, 1,920 at an admission of 8 pairs
    timings.update(time_int8_matmul(dev, b=2 * T2I_ENGINE_PAIRS,
                                    shapes=GPT_XL_MATMULS, tag=" t2i"))
    timings.update(time_int8_matmul(dev, b=T2I_ADMIT_ROWS, shapes={
        k: v for k, v in GPT_XL_MATMULS.items() if k != "XL head"},
        tag=" t2i"))  # the admission's head runs on its last rows only
    # the speculative engine's verify: 2P * (k + 1) = 80 rows
    timings.update(time_int8_matmul(dev, b=SPEC_ENGINE_ROWS, shapes={
        "wqkv": GPT_L_MATMULS["wqkv"]}, tag=" spec"))
    return worst, timings


def check_int4_storage(dev):
    """The int4 storage mode (`quantize_gpt_params(..., bits=4)`, plain
    PyTorch) at GPT-L's wqkv, [16, 1024] x [1024, 3072] f32, TF32 off: the
    card's packed levels and group scales equal the CPU port's bit for
    bit, its `int4_matmul` within 1e-5 of the largest |value| of the
    CPU's."""
    from llamagen_tpu_torch.ops.quant_matmul import (int4_matmul,
                                                     quantize_weight_int4)
    g = torch.Generator().manual_seed(13)
    k, n = GPT_L_MATMULS["wqkv"]
    w = torch.randn(k, n, generator=g) * 0.02
    x = torch.randn(16, k, generator=g)
    p, s = quantize_weight_int4(w)
    pd, sd = quantize_weight_int4(w.to(dev))
    ref = int4_matmul(x, p, s)
    got = int4_matmul(x.to(dev), pd, sd).cpu()
    same = torch.equal(pd.cpu(), p) and torch.equal(sd.cpu(), s)
    err = (got - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item()
    log(f"int4 storage (bits=4, group 128) GPT-L wqkv [16,{k}]x[{k},{n}] "
        f"f32: levels and scales == CPU's {same}; int4_matmul max_abs_err "
        f"{err:.3g} (tol {tol:.3g})")
    if not same or not err <= tol:
        raise AssertionError("int4 storage: the card disagrees with the CPU")


def time_int8_matmul(dev, full=True, b=16, shapes=None, tag=""):
    """K2 per call at B 16 (128: the serving engine's rows, keys "... B128"),
    bf16 x, on `shapes` (default: the five GPT-L layer shapes, the GPT-L
    int8 head and the four GPT-3B layer shapes): one buffer set per layer
    (24), so the weights stream from memory as in a step. With `full`,
    also the plain version, the bound, `torch._weight_int8pack_mm`
    (torch's own W8A16 call) and bf16 `torch.matmul` on the dequantised
    weights (context). `tag` ends every key ("... t2i": the t2i engine's
    16 rows are not the main path's B 16)."""
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     int8_matmul_ref,
                                                     quantize_weight)
    g = torch.Generator(device=dev).manual_seed(12)
    timings = {}
    if shapes is None:
        shapes = dict(GPT_L_MATMULS, head=(1024, 16384), **GPT_3B_MATMULS)
    for name, (k, n) in shapes.items():
        layers = [quantize_weight(torch.randn(k, n, generator=g, device=dev)
                                  * 0.02) for _ in range(24)]
        x = torch.randn(b, k, generator=g, device=dev).to(torch.bfloat16)
        ms = graph_ms([lambda w=w: int8_matmul(x, *w) for w in layers])
        gbs = k * n / (ms * 1e-3) / 1e9
        if b != 16:
            name = f"{name} B{b}"
        name += tag
        if not full:
            timings[name] = dict(ms=ms)
            log(f"K2 time {name} [{b},{k}]x[{k},{n}]: kernel {ms:.4f} ms "
                f"({gbs:.0f} GB/s of int8 weights)")
            del layers
            continue
        plain = graph_ms([lambda w=w: int8_matmul_ref(x, *w) for w in layers])
        w_bf16 = [(wq.float() * ws).to(torch.bfloat16) for wq, ws in layers]
        bf16 = graph_ms([lambda w=w: x @ w for w in w_bf16])
        del w_bf16
        bnd_ms, by = bound(nbytes(layers[0][0], layers[0][1], x)
                           + b * n * 2, 2 * b * k * n)
        # torch's own W8A16 call: int8 weight [N, K], bf16 scales
        packed = [(wq.t().contiguous(), ws.to(torch.bfloat16))
                  for wq, ws in layers]
        lib = library_time(f"K2 library (torch._weight_int8pack_mm) {name}",
                           lambda: graph_ms(
                               [lambda w=w: torch._weight_int8pack_mm(x, *w)
                                for w in packed]))
        timings[name] = dict(ms=ms, plain=plain, bound=bnd_ms, by=by,
                             library=lib, bf16=bf16)
        log(f"K2 time {name} [{b},{k}]x[{k},{n}]: kernel {ms:.4f} ms "
            f"({gbs:.0f} GB/s of int8 weights), plain {plain:.4f} ms, "
            f"bound {bnd_ms:.4f} ms ({by}), torch._weight_int8pack_mm "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bf16 "
            f"torch.matmul {bf16:.4f} ms (context)")
        del layers, packed
    return timings


# ---------------------------------------------------------------------------
# Phases 3-5: the main path, the CLI, teacher forcing
# ---------------------------------------------------------------------------


def gpt_model(dev, seed=0, dtype=torch.bfloat16, name="GPT-L",
              n_layer=None):
    """A zoo GPT at 384 px (576 tokens), random seeded weights with a random
    head; `n_layer` cuts the depth (widths stay the zoo's)."""
    from llamagen_tpu_torch.config import gpt_config, replace
    from llamagen_tpu_torch.models import gpt
    cfg = gpt_config(name, block_size=576, cls_token_num=1)
    if n_layer is not None:
        cfg = replace(cfg, n_layer=n_layer)
    model = gpt.init_weights(
        gpt.Transformer(cfg, device=dev, dtype=dtype), seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():  # the reference init zeroes the head
        model.output.weight.normal_(0.0, 0.02, generator=g)
    return model.eval()


def run_main_path(dev, name="GPT-L"):
    """`generate` at 384 px, W8A16 layer weights + int8 KV, batch 8 + CFG
    2.0, 576 tokens, then the VQ-16 decoder: counters exactly 24 * 575
    (K1) and 5 * 24 * 576 (K2: prefill's matmuls run on it too)."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     quantize_gpt_params)
    model = quantize_gpt_params(gpt_model(dev, name=name))
    labels = torch.arange(BATCH, device=dev) * 100 % 1000
    kw = dict(cfg_scale=CFG_SCALE, compute_dtype=torch.bfloat16,
              cache_dtype=torch.int8)
    gen = torch.Generator(device=dev).manual_seed(0)
    generate(model, labels, max_new_tokens=40, generator=gen, **kw)  # warm
    torch.cuda.synchronize()

    decode_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.time()
    tokens = generate(model, labels, max_new_tokens=TOKENS, generator=gen,
                      **kw)
    torch.cuda.synchronize()
    secs = time.time() - t0
    k1, k2 = decode_attention.launches, int8_matmul.launches
    log(f"{'main path' if name == 'GPT-L' else 'sampling path'} ({name} "
        f"384, head_dim {model.cfg.head_dim}, W8A16 + int8 KV, batch "
        f"{BATCH} + CFG {CFG_SCALE}): {TOKENS} tokens in {secs:.3f} s = "
        f"{BATCH / secs:.3f} img/s, {1e3 * secs / TOKENS:.3f} ms/token step; "
        f"launches decode_attention {k1}, int8_matmul {k2}")
    n_layer = model.cfg.n_layer
    if k1 != n_layer * (TOKENS - 1) or k2 != 5 * n_layer * TOKENS:
        raise AssertionError(f"launch counts {k1}, {k2}: expected "
                             f"{n_layer * (TOKENS - 1)}, {5 * n_layer * TOKENS}")
    if tokens.shape != (BATCH, TOKENS) or tokens.min() < 0 \
            or tokens.max() >= model.cfg.vocab_size:
        raise AssertionError(f"bad tokens {tokens.shape}")
    del model

    vq_model = vq.init_weights(vq.VQModel(vq_config("VQ-16"), device=dev,
                                          dtype=torch.bfloat16))
    t0 = time.time()
    imgs = vq_model.decode_code(tokens.reshape(BATCH, 24, 24))
    torch.cuda.synchronize()
    log(f"VQ-16 decode_code -> {tuple(imgs.shape)} in {time.time() - t0:.3f} s")
    if imgs.shape != (BATCH, 384, 384, 3) or not torch.isfinite(imgs).all():
        raise AssertionError("VQ images are not finite [8, 384, 384, 3]")
    return {"decode_attention": k1, "int8_matmul": k2, "img_s": BATCH / secs}


def run_cli(dev):
    from llamagen_tpu_torch.cli import sample_c2i
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gpt_l_random.pt")
        torch.save(gpt_model(dev, seed=3).state_dict(), ckpt)
        out = os.path.join(tmp, "grid.png")
        t0 = time.time()
        res = sample_c2i.main([
            "--gpt-model", "GPT-L", "--gpt-ckpt", ckpt, "--image-size", "384",
            "--cfg-scale", str(CFG_SCALE), "--precision", "bf16",
            "--device", "cuda", "--out", out])
        secs = time.time() - t0
        png_ok = os.path.getsize(out) > 0
    n = res.images.shape[0]
    log(f"CLI sample_c2i (GPT-L 384, bf16 weights + cache, {n} images + "
        f"CFG): sampling {res.gen_seconds:.3f} s = {n / res.gen_seconds:.3f} "
        f"img/s, {1e3 * res.gen_seconds / TOKENS:.3f} ms/token step; whole "
        f"CLI {secs:.3f} s")
    if res.images.shape != (8, 384, 384, 3) \
            or not np.isfinite(res.images).all() or not png_ok \
            or res.tokens.min() < 0 or res.tokens.max() >= 16384:
        raise AssertionError("CLI output is not 8 finite 384 px images")


def run_teacher_forced(dev, name="GPT-L", n_layer=None, steps=64,
                       with_w4=True):
    """Kernels vs plain versions inside the model: same token inputs,
    `steps` decode steps, max |logit difference|; bf16, W8A16 + int8 KV
    (K1, K2) and grouped W4 + bf16 KV (K1, K3). Bound: 0.25 at GPT-L (bf16
    rounding noise through 24 layers, logits std ~0.6), and 0.4 of the
    logits' std where that is more (wider models have wider logits)."""
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops import attention, quant_matmul, w4_matmul
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, 16384, (steps, 2 * BATCH), generator=g,
                         device=dev)
    labels = torch.arange(2 * BATCH, device=dev) * 61 % 1000
    worst = {}
    paths = [("bf16", None, torch.bfloat16),
             ("W8A16 + int8 KV", quant_matmul.quantize_gpt_params,
              torch.int8)]
    if with_w4:
        paths.append(("W4 g128 + bf16 KV", w4_matmul.quantize_gpt_params_w4k,
                      torch.bfloat16))
    for label, quantize, cache_dtype in paths:
        model = gpt_model(dev, seed=9, name=name, n_layer=n_layer)
        if quantize is not None:
            quantize(model)
        runs = []
        for plain in (False, True):
            saved = (gpt.decode_attention, quant_matmul.int8_matmul,
                     quant_matmul.w4_matmul)
            if plain:
                gpt.decode_attention = attention.decode_attention_ref
                quant_matmul.int8_matmul = quant_matmul.int8_matmul_ref
                quant_matmul.w4_matmul = w4_matmul.w4_matmul_ref
            try:
                runs.append(_forced_logits(model, labels, toks, cache_dtype))
            finally:
                (gpt.decode_attention, quant_matmul.int8_matmul,
                 quant_matmul.w4_matmul) = saved
        diff = max(max_err(a, b) for a, b in zip(*runs))
        std = torch.stack(runs[1]).float().std().item()
        bound_ = max(0.25, 0.4 * std)
        agree = sum((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                    for a, b in zip(*runs)) / len(runs[0])
        log(f"teacher-forced {name} ({model.cfg.n_layer} layers, head_dim "
            f"{model.cfg.head_dim}) {label}, {steps} steps: max |logit "
            f"kernel - plain| {diff:.4g} (bound {bound_:.3g}, logits std "
            f"{std:.3g}), argmax agreement {agree:.4f}")
        if not diff <= bound_:
            raise AssertionError(f"teacher-forced {name} {label} exceeds "
                                 f"its bound")
        worst[label] = diff
        del model, runs
    return worst


def _forced_logits(model, labels, toks, cache_dtype):
    from llamagen_tpu_torch.config import find_multiple
    from llamagen_tpu_torch.models import gpt
    cfg = model.cfg
    dev = labels.device
    max_seq = find_multiple(1 + TOKENS, 128)
    b = labels.shape[0]
    if cache_dtype == torch.int8:
        stage = gpt.init_cache(cfg, b, 40, torch.bfloat16, dev)
        gpt.prefill(model, labels, stage)
        cache = gpt.quantize_cache(stage, cfg, max_seq)
        cache.tail = [c[:, :32].clone() for c in stage.kv]
    else:
        cache = gpt.init_cache(cfg, b, max_seq, cache_dtype, dev)
        gpt.prefill(model, labels, cache)
    return [gpt.decode_step(model, tok, 1 + i, cache)
            for i, tok in enumerate(toks)]


# ---------------------------------------------------------------------------
# Phases 6-9: W4 matmul (K3), chunk attention (K5), the W4 sampling path,
# speculative sampling
# ---------------------------------------------------------------------------


def w4_int4pack(blocks, scales, k):
    """pack_w4 blocks/scales (grouped, 128-row groups, K/2 a multiple of
    128) -> the operands of torch._weight_int4pack_mm (tinygemm): levels
    + 8 as uint4 [N, K] packed two per byte, bf16 (scale, zero = 0) per
    (K group, column). Its groups are contiguous K rows, which are
    pack_w4's groups half by half."""
    from llamagen_tpu_torch.ops.w4_matmul import _levels
    nb, k2, bn = blocks.shape
    lv = _levels(blocks).permute(1, 0, 2).reshape(k, nb * bn)  # [K, N]
    u4 = (lv.t() + 8).to(torch.int32).contiguous()             # [N, K]
    packed = torch._convert_weight_to_int4pack(
        (u4[:, ::2] << 4 | u4[:, 1::2]).to(torch.uint8).contiguous(), 8)
    sc = scales.permute(1, 0, 2).reshape(scales.shape[1], nb * bn)
    sz = torch.stack([sc, torch.zeros_like(sc)], dim=-1).to(torch.bfloat16)
    return packed, sz.contiguous()


def check_w4_matmul(dev):
    """K3 against w4_matmul_ref at every GPT-L layer shape, per channel and
    grouped g128, B 16 (decode, draft) and 80 (a k = 4 verify), bf16 x;
    plus f32 x, B 1, 17, 81 and 320 (the kernel's 8-row tiles and 96-row
    passes) and a ragged group (K = 320). Tolerance: one bf16 ulp (2^-7)
    of the largest output for bf16 x, 1e-5 of it for f32 x (the same f32
    products summed in another order). Then the times (`time_w4_matmul`)."""
    from llamagen_tpu_torch.ops.w4_matmul import (pack_w4, w4_matmul,
                                                  w4_matmul_ref)
    g = torch.Generator(device=dev).manual_seed(13)
    worst = 0.0
    cases = [(name, k, n, pc, b, torch.bfloat16)
             for name, (k, n) in GPT_L_MATMULS.items()
             for pc in (False, True) for b in (16, 80)]
    cases += [("wqkv", 1024, 3072, False, 16, torch.float32),
              ("w2", 2816, 1024, True, 80, torch.float32),
              ("wqkv", 1024, 3072, False, 1, torch.bfloat16),
              ("w1", 1024, 2816, False, 17, torch.bfloat16),
              ("w2", 2816, 1024, False, 81, torch.float32),
              ("wo", 1024, 1024, True, 320, torch.bfloat16),
              ("ragged", 320, 256, False, 16, torch.bfloat16),
              ("ragged", 320, 256, False, 16, torch.float32)]
    for name, k, n, pc, b, dtype in cases:
        blocks, scales = pack_w4(torch.randn(k, n, generator=g, device=dev)
                                 * 0.02, per_channel=pc)
        x = torch.randn(b, k, generator=g, device=dev).to(dtype)
        out = w4_matmul(x, blocks, scales)
        ref = w4_matmul_ref(x, blocks, scales)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
        tol = rel * ref.float().abs().max().item()
        label = (f"K3 w4_matmul {name} [{b},{k}]x[{k},{n}] "
                 f"{'per-channel' if pc else 'g128'} {str(dtype)[6:]} x")
        log(f"{label}: max_abs_err {err:.3g} (tol {tol:.3g}, "
            f"{err / max(tol, 1e-30) * rel:.3g} of the largest output)")
        if not (err <= tol and out.dtype == dtype):
            raise AssertionError(f"{label} disagrees with the plain version")
        worst = max(worst, err)
    return worst, time_w4_matmul(dev)


def time_w4_matmul(dev, full=True, shapes=None, bs=(16, 80)):
    """K3 per call at the five GPT-L layer shapes (or `shapes`), B 16 and
    80 (or `bs`): grouped g128 (the quantize_gpt_params_w4k defaults),
    bf16 x, enough buffer sets per shape (>= 24, >= 128 MB) that the
    weights stream from memory, not from the 50 MB L2. With `full`, also
    the plain version, the bound and `torch._weight_int4pack_mm`
    (tinygemm) on the same inputs."""
    from llamagen_tpu_torch.ops.w4_matmul import (pack_w4, w4_dequant,
                                                  w4_matmul, w4_matmul_ref)
    g = torch.Generator(device=dev).manual_seed(14)
    timings = {}
    for name, (k, n) in (shapes or GPT_L_MATMULS).items():
        sets = max(24, -(-128 * 2 ** 20 // (k * n // 2)))
        layers = [pack_w4(torch.randn(k, n, generator=g, device=dev) * 0.02)
                  for _ in range(sets)]
        for b in bs:
            x = torch.randn(b, k, generator=g, device=dev).to(torch.bfloat16)
            ms = graph_ms([lambda w=w: w4_matmul(x, *w) for w in layers])
            gbs = k * n / 2 / (ms * 1e-3) / 1e9
            if not full:
                timings[(name, b)] = dict(ms=ms)
                log(f"K3 time {name} [{b},{k}]x[{k},{n}] g128: kernel "
                    f"{ms:.4f} ms ({gbs:.0f} GB/s of packed weights)")
                continue
            plain = graph_ms([lambda w=w: w4_matmul_ref(x, *w)
                              for w in layers[:24]])
            bnd_ms, by = bound(nbytes(*layers[0], x) + b * n * 2,
                               2 * b * k * n)
            if b == 16:
                w_bf16 = [w4_dequant(*w).to(torch.bfloat16)
                          for w in layers[:24]]
                bf16 = graph_ms([lambda w=w: x @ w for w in w_bf16])
                del w_bf16

            def tinygemm():
                ops = [w4_int4pack(*w, k) for w in layers]
                y = torch._weight_int4pack_mm(x, ops[0][0], 128, ops[0][1])
                e = max_err(y, w4_matmul_ref(x, *layers[0]))
                log(f"K3 library (tinygemm) {name} B {b}: max |difference| "
                    f"from the plain version {e:.3g} (bf16 scales)")
                return graph_ms([lambda o=o: torch._weight_int4pack_mm(
                    x, o[0], 128, o[1]) for o in ops])
            lib = library_time(f"K3 library (torch._weight_int4pack_mm) "
                               f"{name} B {b}", tinygemm)
            timings[(name, b)] = dict(ms=ms, plain=plain, bound=bnd_ms,
                                      by=by, library=lib)
            log(f"K3 time {name} [{b},{k}]x[{k},{n}] g128: kernel {ms:.4f} "
                f"ms ({gbs:.0f} GB/s of packed weights, {sets} buffer "
                f"sets), plain {plain:.4f} ms, bound {bnd_ms:.4f} ms ({by})"
                f", torch._weight_int4pack_mm "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'}"
                + ("" if b != 16 else
                   f", bf16 torch.matmul on the dequantised weight "
                   f"{bf16:.4f} ms (context)"))
        del layers
    return timings


def chunk_state(dev, b, h, h_kv, s, c, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    f, f_kv = h * 64, h_kv * 64
    return (torch.randn(b, c, f, generator=g, device=dev).to(dtype),
            torch.randn(b, c, 2 * f_kv, generator=g, device=dev).to(dtype),
            torch.randn(b, s, 2 * f_kv, generator=g, device=dev).to(dtype))


def check_chunk_attention(dev):
    """K5 against chunk_decode_attention_ref: B 16, 16 heads x 64, S 640,
    C 1 (draft step), 5 (k = 4 verify) and 8, bf16 and f32 caches, per-row
    positions with 0, 7, 8 and 639 - C among them, GQA rep 2 and 4, prefix
    padding, and a backward position jump across two calls. The output to
    4 bf16 ulps of its largest value (f32: 1e-5), the cache rows below
    pos + C (and all others) exactly. Then the times
    (`time_chunk_attention`)."""
    from llamagen_tpu_torch.ops.chunk_attention import (
        chunk_decode_attention, chunk_decode_attention_ref)
    b, h, s = 16, 16, 640
    g = torch.Generator(device=dev).manual_seed(17)
    worst = 0.0

    def compare(label, q, kv_new, kv, pos, pad, h_kv, heads=h):
        kv_ref = kv.clone()
        out = chunk_decode_attention(q, kv_new, kv, pos, heads, pad)
        ref = chunk_decode_attention_ref(q, kv_new, kv_ref, pos, heads, pad)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        rel = 2 ** -6 if q.dtype == torch.bfloat16 else 1e-5
        tol = rel * max(1.0, ref.float().abs().max().item())
        same = torch.equal(kv, kv_ref)
        log(f"K5 {label}: max_abs_err {err:.3g} (tol {tol:.3g}), cache "
            f"equal: {same}")
        if not (err <= tol and same):
            raise AssertionError(f"K5 {label} disagrees with the plain "
                                 f"version")
        return err

    for i, (c, dtype, h_kv, padded) in enumerate(
            [(c, dt, 16, False) for c in (1, 5)
             for dt in (torch.bfloat16, torch.float32)]
            + [(5, torch.bfloat16, 8, False), (5, torch.bfloat16, 4, True),
               (1, torch.bfloat16, 16, True), (8, torch.bfloat16, 16, True)]):
        q, kv_new, kv = chunk_state(dev, b, h, h_kv, s, c, dtype, 40 + i)
        pos = torch.randint(0, s - c + 1, (b,), generator=g, device=dev,
                            dtype=torch.int32)
        pos[:4] = torch.tensor([0, 7, 8, s - 1 - c], device=dev)
        pad = None
        if padded:  # masked left padding, never past the row's position
            pad = torch.minimum(torch.randint(0, 40, (b,), generator=g,
                                              device=dev, dtype=torch.int32),
                                pos)
        label = (f"chunk_decode_attention C {c}, {str(dtype)[6:]} cache, "
                 f"H/H_kv {h}/{h_kv}, prefix_pad {'yes' if padded else 'no'}")
        worst = max(worst, compare(label, q, kv_new, kv, pos, pad, h_kv))

    # GPT-XL's 20 heads with the t2i paths' positions and pads: the
    # speculative 512 px shape (B 8 = 4 captions + CFG, S 1280), B 16, and
    # B 4 (80 blocks: split over the cache rows)
    for j, (c, bt) in enumerate(((5, 8), (1, 8), (5, 16), (5, 4), (8, 4))):
        st = 1280
        q, kv_new, kv = chunk_state(dev, bt, 20, 20, st, c, torch.bfloat16,
                                    70 + j)
        pos, pad = t2i_rows(dev, bt, st - c + 1, g)
        label = (f"chunk_decode_attention C {c}, bf16 cache, B {bt}, S {st},"
                 f" H/H_kv 20/20, t2i positions and prefix_pad")
        worst = max(worst, compare(label, q, kv_new, kv, pos, pad, 20,
                                   heads=20))

    # a backward jump: a verify chunk at 300, one token committed, the next
    # chunk at 301 over the rows the first one wrote (rows 301..304 redone)
    q, kv_new, kv = chunk_state(dev, b, h, h, s, 5, torch.bfloat16, 60)
    pos = torch.full((b,), 300, dtype=torch.int32, device=dev)
    compare("backward jump, call 1 at pos 300", q, kv_new, kv, pos, None, h)
    q2, kv2, _ = chunk_state(dev, b, h, h, s, 5, torch.bfloat16, 61)
    worst = max(worst, compare("backward jump, call 2 at pos 301", q2, kv2,
                               kv, pos + 1, None, h))
    timings = time_chunk_attention(dev)
    timings.update(time_chunk_attention(dev, cs=(5,), b=8, h=20, s=1280,
                                        pos=632, pads=T2I_PADS, tag=" t2i"))
    # the speculative engine's verify: 8 pairs at their own positions
    timings.update(time_chunk_attention(
        dev, cs=(SPEC_K + 1,), s=SPEC_ENGINE_CACHE, pos=SPEC_ENGINE_POS * 2,
        tag=" spec"))
    return worst, timings


def time_chunk_attention(dev, full=True, cs=(5, 1, 8), b=16, h=16, s=640,
                         pos=288, pads=None, tag=""):
    """K5 per call at the main path's mean position (pos 288), B 16, 16
    heads x 64, S 640, bf16, C 5, 1 and 8, one buffer set per layer; `b`,
    `h`, `s`, `pos` (an int, or one position per row: the speculative
    engine's slots) and `pads` (left pads taken by the rows in turn) give
    the other shapes (keys "<C><tag>"). With `full`, also the plain
    version, the bound, SDPA with the same row mask over the cache, and
    SDPA after the cache write it does not make (`kv[:, pos:pos + C] =
    kv_new`, K5's whole work)."""
    from llamagen_tpu_torch.ops.chunk_attention import (
        chunk_decode_attention, chunk_decode_attention_ref)
    timings = {}
    pad_l = [0] * b if pads is None else [pads[i % len(pads)]
                                          for i in range(b)]
    pad_t = None if pads is None else torch.tensor(pad_l, dtype=torch.int32,
                                                   device=dev)
    per_row = not isinstance(pos, int)
    pos_l = list(pos) if per_row else [pos] * b
    pos_t = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    kpos = pos_t if per_row else pos  # what the timed call is given
    where = "per-slot positions" if per_row else f"pos {pos}"
    for c in cs:
        key = c if not tag else f"{c}{tag}"
        states = [chunk_state(dev, b, h, h, s, c, torch.bfloat16, 100 + l)
                  for l in range(24)]
        ms = graph_ms([lambda st=st: chunk_decode_attention(
            st[0], st[1], st[2], kpos, h, pad_t) for st in states])
        if not full:
            timings[key] = dict(ms=ms)
            log(f"K5 time, C {c}, bf16 cache, B {b}, H {h}, {where}, S "
                f"{s}: kernel {ms:.4f} ms")
            del states
            continue
        plain = graph_ms([lambda st=st: chunk_decode_attention_ref(
            st[0], st[1], st[2], kpos, h, pad_t) for st in states])
        q, kv_new, kv = states[0]
        row = kv.shape[2] * kv.element_size()
        bnd_ms, by = bound(
            nbytes(q, kv_new, q)
            + sum((p + c - pd) * row for p, pd in zip(pos_l, pad_l))
            + b * c * row,
            sum(4 * h * 64 * c * (p + c - pd) for p, pd in zip(pos_l, pad_l)))
        f = h * 64
        qs = [st[0].view(b, c, h, 64).transpose(1, 2) for st in states]
        ks = [st[2][..., :f].view(b, s, h, 64).transpose(1, 2)
              for st in states]
        vs = [st[2][..., f:].view(b, s, h, 64).transpose(1, 2)
              for st in states]
        cols = torch.arange(s, device=dev)
        rows = pos_t.long()[:, None] + torch.arange(c, device=dev)  # [B, C]
        mask = ((cols[None, None, :] <= rows[:, :, None])
                & (cols[None, None, :] >= torch.tensor(
                    pad_l, device=dev)[:, None, None])).view(b, 1, c, s)
        lib = library_time("K5 library (SDPA)", lambda: graph_ms(
            [lambda i=i: F.scaled_dot_product_attention(
                qs[i], ks[i], vs[i], attn_mask=mask)
             for i in range(len(states))]))
        batch = torch.arange(b, device=dev)[:, None]

        def write_then_sdpa(i):
            if per_row:
                states[i][2][batch, rows] = states[i][1]
            else:
                states[i][2][:, pos:pos + c] = states[i][1]
            return F.scaled_dot_product_attention(qs[i], ks[i], vs[i],
                                                  attn_mask=mask)
        lib_write = library_time("K5 library (cache write + SDPA)",
                                 lambda: graph_ms(
                                     [lambda i=i: write_then_sdpa(i)
                                      for i in range(len(states))]))
        timings[key] = dict(ms=ms, plain=plain, bound=bnd_ms, by=by,
                            library=lib, library_write=lib_write)
        log(f"K5 time, C {c}, bf16 cache, B {b}, H {h}, {where}, S {s}"
            f"{'' if pads is None else f', prefix_pad {pads} in turn'}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd_ms:.4f} "
            f"ms ({by}), SDPA with the row mask over the cache "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}, the cache write "
            f"+ SDPA {'n/a' if lib_write is None else f'{lib_write:.4f} ms'}")
        del states, qs, ks, vs
    return timings


def run_w4_path(dev):
    """GPT-L 384, grouped W4 (quantize_gpt_params_w4k defaults) + bf16 KV,
    batch 8 + CFG 2.0, 576 tokens, then the VQ-16 decoder. Prefill runs
    rank-3 matmuls on the dequantised fallback, every decode step's five
    layer matmuls on K3: counters 5 * 24 * 575 (K3) and 24 * 575 (K1)."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.w4_matmul import (quantize_gpt_params_w4k,
                                                  w4_matmul)
    model = quantize_gpt_params_w4k(gpt_model(dev))
    labels = torch.arange(BATCH, device=dev) * 100 % 1000
    kw = dict(cfg_scale=CFG_SCALE, compute_dtype=torch.bfloat16,
              cache_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    generate(model, labels, max_new_tokens=40, generator=gen, **kw)  # warm
    torch.cuda.synchronize()

    decode_attention.launches = 0
    w4_matmul.launches = 0
    t0 = time.time()
    tokens = generate(model, labels, max_new_tokens=TOKENS, generator=gen,
                      **kw)
    torch.cuda.synchronize()
    secs = time.time() - t0
    k1, k3 = decode_attention.launches, w4_matmul.launches
    n_layer = model.cfg.n_layer
    log(f"W4 path (GPT-L 384, grouped W4A16 + bf16 KV, batch {BATCH} + CFG "
        f"{CFG_SCALE}): {TOKENS} tokens in {secs:.3f} s = "
        f"{BATCH / secs:.3f} img/s, {1e3 * secs / TOKENS:.3f} ms/token step; "
        f"launches w4_matmul {k3}, decode_attention {k1}")
    if k3 != 5 * n_layer * (TOKENS - 1) or k1 != n_layer * (TOKENS - 1):
        raise AssertionError(f"launch counts {k3}, {k1}: expected "
                             f"{5 * n_layer * (TOKENS - 1)}, "
                             f"{n_layer * (TOKENS - 1)}")
    if tokens.shape != (BATCH, TOKENS) or tokens.min() < 0 \
            or tokens.max() >= model.cfg.vocab_size:
        raise AssertionError(f"bad tokens {tokens.shape}")
    vq_model = vq.init_weights(vq.VQModel(vq_config("VQ-16"), device=dev,
                                          dtype=torch.bfloat16))
    imgs = vq_model.decode_code(tokens.reshape(BATCH, 24, 24))
    torch.cuda.synchronize()
    if imgs.shape != (BATCH, 384, 384, 3) or not torch.isfinite(imgs).all():
        raise AssertionError("W4 path images are not finite [8, 384, 384, 3]")
    log(f"W4 path VQ-16 decode -> {tuple(imgs.shape)}, finite")
    return {"w4_matmul": k3, "decode_attention": k1,
            "img_s": BATCH / secs}


def run_speculative(dev, n_layer=SPEC_LAYERS):
    """Self-speculation at GPT-L 384 width, cut to `n_layer` layers (as
    the speculative CLI is): the bf16 target, a grouped-W4 copy of it
    as the draft, k = 4, batch 8 + CFG 4.0, sampled, 576 tokens, bf16
    caches. Each round runs k + 1 draft steps (C = 1) and one verify
    (C = 5), all on K5: counters n_layer * (k + 2) * rounds (K5) and
    5 * n_layer * (k + 1) * rounds (K3, the draft's decode matmuls)."""
    import copy
    from llamagen_tpu_torch.ops.chunk_attention import chunk_decode_attention
    from llamagen_tpu_torch.ops.speculative import generate_speculative
    from llamagen_tpu_torch.ops.w4_matmul import (quantize_gpt_params_w4k,
                                                  w4_matmul)
    target = gpt_model(dev, seed=21, n_layer=n_layer)
    draft = quantize_gpt_params_w4k(copy.deepcopy(target))
    labels = torch.arange(BATCH, device=dev) * 100 % 1000
    kw = dict(k=SPEC_K, cfg_scale=SPEC_CFG, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    generate_speculative(target, draft, labels, max_new_tokens=16,
                         generator=gen, **kw)  # warm
    torch.cuda.synchronize()

    chunk_decode_attention.launches = 0
    w4_matmul.launches = 0
    t0 = time.time()
    tokens, rounds = generate_speculative(target, draft, labels,
                                          max_new_tokens=TOKENS,
                                          generator=gen, **kw)
    torch.cuda.synchronize()
    secs = time.time() - t0
    k5, k3 = chunk_decode_attention.launches, w4_matmul.launches
    log(f"speculative path (GPT-L 384 width, {n_layer} layers, bf16 target, "
        f"W4 g128 self-draft, k "
        f"{SPEC_K}, batch {BATCH} + CFG {SPEC_CFG}, sampled): {TOKENS} "
        f"tokens in {rounds} rounds = {TOKENS / rounds:.3f} tokens/round "
        f"({(TOKENS - 1) / rounds:.3f} after the prefill token), "
        f"{secs:.3f} s = {BATCH / secs:.3f} img/s, "
        f"{1e3 * secs / rounds:.3f} ms/round; launches "
        f"chunk_decode_attention {k5}, w4_matmul {k3}")
    want5 = n_layer * (SPEC_K + 2) * rounds
    want3 = 5 * n_layer * (SPEC_K + 1) * rounds
    if k5 != want5 or k3 != want3:
        raise AssertionError(f"launch counts {k5}, {k3}: expected {want5}, "
                             f"{want3}")
    if tokens.shape != (BATCH, TOKENS) or tokens.min() < 0 \
            or tokens.max() >= target.cfg.vocab_size \
            or not -(-(TOKENS - 1) // (SPEC_K + 1)) <= rounds <= TOKENS - 1:
        raise AssertionError(f"bad tokens {tuple(tokens.shape)} or rounds "
                             f"{rounds}")
    return {"chunk_decode_attention": k5, "w4_matmul": k3,
            "rounds": rounds, "img_s": BATCH / secs}


def run_spec_cli(dev):
    """The speculative path through its CLIs: a random checkpoint of GPT-L
    384 width at SPEC_CLI_LAYERS layers (all 24 until the TP phases joined
    the smoke's clock), `tools quantize-ckpt --mode w4` of it as the draft
    checkpoint, then `sample_c2i --draft-gpt-model` (k 4, CFG 4.0,
    bf16)."""
    from llamagen_tpu_torch.cli import sample_c2i, tools
    name = spec_model_entry(SPEC_CLI_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gpt_l_random.pt")
        draft = os.path.join(tmp, "gpt_l_random_w4.pt")
        torch.save(gpt_model(dev, seed=3, n_layer=SPEC_CLI_LAYERS)
                   .state_dict(), ckpt)
        tools.main(["quantize-ckpt", "--in", ckpt, "--out", draft,
                    "--mode", "w4", "--gpt-model", name,
                    "--image-size", "384", "--device", "cuda"])
        out = os.path.join(tmp, "grid.png")
        res = sample_c2i.main([
            "--gpt-model", name, "--gpt-ckpt", ckpt,
            "--draft-gpt-model", name, "--draft-gpt-ckpt", draft,
            "--spec-k", str(SPEC_K), "--image-size", "384",
            "--precision", "bf16", "--device", "cuda", "--out", out])
        png_ok = os.path.getsize(out) > 0
        draft_mb = os.path.getsize(draft) / 1e6
    n = res.images.shape[0]
    log(f"CLI speculative sample_c2i ({name} 384 bf16 target, W4 "
        f"checkpoint "
        f"of it as the draft, {draft_mb:.1f} MB, k {SPEC_K}, {n} images + "
        f"CFG {SPEC_CFG}): {res.rounds} rounds, {TOKENS / res.rounds:.3f} "
        f"tokens/round, sampling {res.gen_seconds:.3f} s = "
        f"{n / res.gen_seconds:.3f} img/s")
    if res.images.shape != (8, 384, 384, 3) or res.rounds is None \
            or not np.isfinite(res.images).all() or not png_ok \
            or res.tokens.min() < 0 or res.tokens.max() >= 16384:
        raise AssertionError("speculative CLI output is not 8 finite 384 px "
                             "images")


def run_spec_greedy_f32(dev, name="GPT-L", n_layer=None):
    """Greedy speculative decoding commits exactly the target's greedy
    chain: the model in f32 (f32 caches), a W4 copy as the draft, 64 tokens,
    batch 8 + CFG 2.0, against the port's `generate` on the same target
    (at GPT-3B's width: K5 and K1 at head_dim 100, in f32)."""
    import copy
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.speculative import generate_speculative
    from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
    target = gpt_model(dev, seed=31, dtype=torch.float32, name=name,
                       n_layer=n_layer)
    draft = quantize_gpt_params_w4k(copy.deepcopy(target))
    labels = torch.arange(BATCH, device=dev) * 37 % 1000
    kw = dict(max_new_tokens=64, cfg_scale=CFG_SCALE, sample_logits=False,
              compute_dtype=torch.float32)
    ref = generate(target, labels, cache_dtype=torch.float32, **kw)
    got, rounds = generate_speculative(target, draft, labels, k=SPEC_K, **kw)
    same = torch.equal(got, ref)
    log(f"greedy f32 {name} ({target.cfg.n_layer} layers, head_dim "
        f"{target.cfg.head_dim}), W4 self-draft, 64 tokens x {BATCH}: "
        f"speculative == generate: {same} ({rounds} rounds, "
        f"{len(torch.unique(ref))} distinct tokens)")
    if not same:
        bad = (got != ref).nonzero()[:5].tolist()
        raise AssertionError(f"greedy speculative tokens differ at {bad}")
    return rounds


# ---------------------------------------------------------------------------
# Phases 13-15: the serving engine, greedy engine == generate, the app
# ---------------------------------------------------------------------------


def run_engine(dev):
    """The serving engine at `bench.py`'s engine point: GPT-L 384, W8A16
    layers and head + int8 KV, 64 pairs, chunk 64; 80 requests (16 reuse a
    slot) with per-request cfg 1.5 / 2.0 / 4.0, two with top-k 1000, the
    rest unfiltered. The first chunk runs under
    `torch.cuda.set_sync_debug_mode("error")`: a device-to-host read
    inside a chunk fails. Counters exactly 24 * steps (K1) and 121 * steps
    (K2), steps counted by the host; 8 results through the VQ-16
    decoder."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     quantize_gpt_params)
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    model = quantize_gpt_params(gpt_model(dev, seed=51), quantize_head=True)
    kw = dict(num_pairs=ENGINE_PAIRS, chunk=ENGINE_CHUNK,
              compute_dtype=torch.bfloat16, cache_dtype=torch.int8)
    ServeEngine(model, max_new_tokens=16, **kw).generate(
        range(ENGINE_PAIRS))  # warm-up: allocator, first launches
    torch.cuda.synchronize()

    eng = ServeEngine(model, max_new_tokens=TOKENS, **kw)
    sps = [SamplingParams(cfg_scale=(1.5, 2.0, 4.0)[i % 3],
                          top_k=1000 if i in (5, 70) else 0)
           for i in range(ENGINE_REQUESTS)]
    decode_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.time()
    reqs = [eng.submit(i * 41 % 1000, sp=sp) for i, sp in enumerate(sps)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._admit_and_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng._harvest()
    eng.run_until_idle()
    torch.cuda.synchronize()
    secs = time.time() - t0
    k1, k2 = decode_attention.launches, int8_matmul.launches
    steps = eng.steps_run
    st = eng.stats()
    n_layer = model.cfg.n_layer
    log(f"serving engine (GPT-L 384, W8A16 layers and head + int8 KV, "
        f"{ENGINE_PAIRS} pairs, "
        f"chunk {ENGINE_CHUNK}, {ENGINE_REQUESTS} requests, cfg 1.5/2.0/4.0,"
        f" 2 with top-k 1000): {secs:.3f} s = "
        f"{ENGINE_REQUESTS / secs:.3f} img/s, {steps} steps = "
        f"{1e3 * secs / steps:.3f} ms/step; TTFT p50 {st['ttft_p50_s']:.4f}"
        f" s p95 {st['ttft_p95_s']:.4f} s, TPOT p50 {st['tpot_p50_s']:.5f} "
        f"s p95 {st['tpot_p95_s']:.5f} s, e2e p50 "
        f"{st['e2e_latency_p50_s']:.3f} s p95 {st['e2e_latency_p95_s']:.3f} "
        f"s; launches decode_attention {k1}, int8_matmul {k2}; first chunk "
        f"under sync debug mode 'error': no device-to-host read")
    log(f"serving engine stats: {json.dumps(st)}")
    if k1 != n_layer * steps or k2 != (5 * n_layer + 1) * steps:
        raise AssertionError(f"launch counts {k1}, {k2}: expected "
                             f"{n_layer * steps}, "
                             f"{(5 * n_layer + 1) * steps}")
    tokens = torch.tensor(np.stack([r.result for r in reqs]))
    if tokens.shape != (ENGINE_REQUESTS, TOKENS) or tokens.min() < 0 \
            or tokens.max() >= model.cfg.vocab_size \
            or st["completed"] != ENGINE_REQUESTS \
            or steps != 2 * TOKENS:
        raise AssertionError(f"bad engine results {tuple(tokens.shape)}, "
                             f"completed {st['completed']}, steps {steps}")
    del model, eng
    vq_model = vq.init_weights(vq.VQModel(vq_config("VQ-16"), device=dev,
                                          dtype=torch.bfloat16))
    imgs = vq_model.decode_code(tokens[:BATCH].to(dev).reshape(BATCH, 24, 24))
    torch.cuda.synchronize()
    if imgs.shape != (BATCH, 384, 384, 3) or not torch.isfinite(imgs).all():
        raise AssertionError("engine images are not finite [8, 384, 384, 3]")
    log(f"serving engine VQ-16 decode of {BATCH} results -> "
        f"{tuple(imgs.shape)}, finite")
    return {"decode_attention": k1, "int8_matmul": k2, "steps": steps,
            "img_s": ENGINE_REQUESTS / secs}


def run_engine_greedy_f32(dev):
    """Greedy engine tokens equal `generate`'s: GPT-L in f32 (f32 caches,
    K1's f32 entry), 2 pairs, 64 tokens, cfg 2.0, temperature 0. The
    engine's first token comes from a decode step at pos 0, `generate`'s
    from the prefill."""
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    model = gpt_model(dev, seed=61, dtype=torch.float32)
    labels = [207, 360, 387, 974]
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=64, chunk=16,
                      compute_dtype=torch.float32,
                      sampling_params=SamplingParams(cfg_scale=CFG_SCALE,
                                                     temperature=0.0))
    got = torch.tensor(eng.generate(labels))
    ref = generate(model, torch.tensor(labels, device=dev),
                   max_new_tokens=64, cfg_scale=CFG_SCALE,
                   sample_logits=False, compute_dtype=torch.float32,
                   cache_dtype=torch.float32).cpu()
    same = torch.equal(got, ref)
    log(f"greedy f32 GPT-L engine (2 pairs, 4 requests, 64 tokens) == "
        f"generate: {same} ({len(torch.unique(ref))} distinct tokens)")
    if not same:
        bad = (got != ref).nonzero()[:5].tolist()
        raise AssertionError(f"greedy engine tokens differ at {bad}")


def _png_size(png):
    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR":
        raise AssertionError("not a PNG")
    return int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big")


def run_app(dev):
    """`python -m llamagen_tpu_torch.cli.app` in a subprocess at its
    defaults (GPT-B 256 px, random weights, VQ-16, 4 slots) with
    `--quantize int8` on a free port: three `GET /generate` with other
    class, cfg and top-k, each a 256 x 256 PNG; `/stats` reports 3
    completed. The server is killed at the end whatever happens."""
    import socket
    import urllib.request
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "llamagen_tpu_torch.cli.app", "--quantize",
         "int8", "--port", str(port), "--no-gradio", "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.time()
        while True:  # up once /stats answers
            if proc.poll() is not None:
                raise AssertionError(f"the app exited {proc.returncode}: "
                                     f"{proc.stdout.read()[-2000:]}")
            try:
                with urllib.request.urlopen(f"{url}/stats", timeout=5):
                    break
            except OSError:
                if time.time() - t0 > 180:
                    raise AssertionError("the app did not start in 180 s")
                time.sleep(1)
        log(f"serving app up in {time.time() - t0:.1f} s")
        for q in ("class_id=207&cfg_scale=4.0",
                  "class_id=360&cfg_scale=1.5&top_k=100",
                  "class_id=974&cfg_scale=2.5&top_k=0&temperature=0.9"):
            t = time.time()
            with urllib.request.urlopen(f"{url}/generate?{q}",
                                        timeout=120) as r:
                kind, png = r.headers["Content-Type"], r.read()
            size = _png_size(png)
            log(f"GET /generate?{q}: {kind}, {len(png)} bytes, {size[0]} x "
                f"{size[1]}, {time.time() - t:.2f} s")
            if kind != "image/png" or size != (256, 256):
                raise AssertionError(f"/generate?{q} gave {kind} {size}")
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            st = json.loads(r.read())
        log(f"GET /stats: {json.dumps(st)}")
        if st["completed"] != 3 or st["running"] != 0:
            raise AssertionError(f"/stats reports {st}")
        if proc.poll() is not None:
            raise AssertionError(f"the app exited {proc.returncode}")
    finally:
        proc.kill()
        proc.wait(timeout=60)


# ---------------------------------------------------------------------------
# Phases 16-22: text-to-image (T5, sampling, the engine, greedy checks, CLI)
# ---------------------------------------------------------------------------


def t2i_model(dev, image_size, seed=0, dtype=torch.bfloat16, n_layer=None):
    """GPT-XL t2i (120 caption tokens, caption_dim 2048) at `image_size`,
    random seeded weights with a random head; `n_layer` cuts the depth."""
    from llamagen_tpu_torch.config import gpt_config, replace
    from llamagen_tpu_torch.models import gpt
    cfg = gpt_config("GPT-XL", block_size=(image_size // 16) ** 2,
                     cls_token_num=T2I_T, model_type="t2i",
                     caption_dim=T2I_CAPTION)
    if n_layer is not None:
        cfg = replace(cfg, n_layer=n_layer)
    model = gpt.init_weights(
        gpt.Transformer(cfg, device=dev, dtype=dtype), seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():  # the reference init zeroes the head
        model.output.weight.normal_(0.0, 0.02, generator=g)
    return model.eval()


def t2i_captions(dev, pads, seed, dtype=torch.bfloat16):
    """Random caption features [B, 120, 2048], left-padded (zero rows below
    each pad, as `left_pad_embeddings` leaves them), and masks [B, 120]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    caps = torch.randn(len(pads), T2I_T, T2I_CAPTION, generator=g,
                       device=dev)
    masks = torch.arange(T2I_T, device=dev)[None, :] \
        >= torch.tensor(pads, device=dev)[:, None]
    return (caps * masks[..., None]).to(dtype), masks


def run_t5_encoder(dev):
    """The port's T5 encoder at flan-t5-xl's widths (d_model 2048, 24
    layers, 32 heads x 64, d_ff 5120, gated-gelu, 32 buckets, vocab 32128),
    random weights at T5's init scales: 4 captions of 120 random ids with
    right-padded masks of 1, 7, 60 and 120 tokens, bf16 against the same
    weights in f32 on the card. Bounds (bf16 rounds every matmul input and
    the residual stream through 24 layers): relative Frobenius error <=
    2^-5, max |error| <= 2^-3 of the largest |output|. Prints the bf16
    encode time."""
    from llamagen_tpu_torch.text import t5
    cfg = t5.T5EncoderConfig()
    ref_model = t5.init_weights(t5.T5Encoder(cfg, device=dev,
                                             dtype=torch.float32)).eval()
    model = t5.T5Encoder(cfg, device=dev, dtype=torch.bfloat16).eval()
    model.load_state_dict(ref_model.state_dict())
    g = torch.Generator(device=dev).manual_seed(81)
    ids = torch.randint(0, cfg.vocab_size, (4, T2I_T), generator=g,
                        device=dev)
    mask = (torch.arange(T2I_T, device=dev)[None, :] < torch.tensor(
        [1, 7, 60, T2I_T], device=dev)[:, None]).long()
    ref = ref_model(ids, mask)
    out = model(ids, mask)
    torch.cuda.synchronize()
    del ref_model
    rel_fro = ((out.float() - ref).norm() / ref.norm()).item()
    rel_max = max_err(out, ref) / ref.abs().max().item()
    ms = cuda_ms(lambda: model(ids, mask), reps=3, calls=5)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"T5 encoder (flan-t5-xl widths, {n_params / 1e9:.3f}B params, "
        f"random weights), 4 captions x {T2I_T} ids, masks of 1/7/60/120: "
        f"bf16 vs f32 relative Frobenius error {rel_fro:.4g} (bound "
        f"{2 ** -5:.4g}), max error {rel_max:.4g} of the largest output "
        f"(bound {2 ** -3:.4g}); bf16 encode {ms:.3f} ms")
    if not (out.shape == (4, T2I_T, cfg.d_model)
            and torch.isfinite(out.float()).all()
            and rel_fro <= 2 ** -5 and rel_max <= 2 ** -3):
        raise AssertionError("the bf16 T5 encoder disagrees with f32")
    return {"ms": ms, "rel_fro": rel_fro}


def run_t2i_path(dev):
    """`generate` for t2i at 512 px: GPT-XL, bf16 weights and cache, 4
    captions left-padded by 0, 60, 100 and 119 + CFG 7.5, top-k 1000,
    1,024 tokens, then the VQ-16 decoder to [4, 512, 512, 3]; GPT-XL's
    widths at T2I_PATH_LAYERS layers. K1 runs with `prefix_pad` in every
    layer of every step: exactly n_layer * 1023 launches, K2 none (bf16
    weights)."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.quant_matmul import int8_matmul
    model = t2i_model(dev, 512, n_layer=T2I_PATH_LAYERS)
    caps, masks = t2i_captions(dev, T2I_PADS, seed=90)
    tokens_n = model.cfg.block_size
    kw = dict(emb_masks=masks, cfg_scale=T2I_CFG, top_k=T2I_TOP_K,
              compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    generate(model, caps, max_new_tokens=40, generator=gen, **kw)  # warm
    torch.cuda.synchronize()

    decode_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.time()
    tokens = generate(model, caps, max_new_tokens=tokens_n, generator=gen,
                      **kw)
    torch.cuda.synchronize()
    secs = time.time() - t0
    k1, k2 = decode_attention.launches, int8_matmul.launches
    n_layer = model.cfg.n_layer
    log(f"t2i sampling path (GPT-XL 512 width, {n_layer} layers, bf16 "
        f"weights + cache, "
        f"{T2I_BATCH} captions with pads {T2I_PADS} + CFG {T2I_CFG}, top-k "
        f"{T2I_TOP_K}): {tokens_n} tokens in {secs:.3f} s = "
        f"{T2I_BATCH / secs:.4f} img/s, {1e3 * secs / tokens_n:.3f} "
        f"ms/token step; launches decode_attention {k1}, int8_matmul {k2}")
    if k1 != n_layer * (tokens_n - 1) or k2 != 0:
        raise AssertionError(f"launch counts {k1}, {k2}: expected "
                             f"{n_layer * (tokens_n - 1)}, 0")
    if tokens.shape != (T2I_BATCH, tokens_n) or tokens.min() < 0 \
            or tokens.max() >= model.cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(tokens.shape)}")
    del model
    vq_model = vq.init_weights(vq.VQModel(vq_config("VQ-16"), device=dev,
                                          dtype=torch.bfloat16))
    t0 = time.time()
    imgs = vq_model.decode_code(tokens.reshape(T2I_BATCH, 32, 32))
    torch.cuda.synchronize()
    log(f"t2i VQ-16 decode_code -> {tuple(imgs.shape)} in "
        f"{time.time() - t0:.3f} s")
    if imgs.shape != (T2I_BATCH, 512, 512, 3) \
            or not torch.isfinite(imgs).all():
        raise AssertionError("t2i images are not finite [4, 512, 512, 3]")
    return {"decode_attention": k1, "img_s": T2I_BATCH / secs}


def t2i_engine_requests(n=T2I_ENGINE_REQUESTS):
    """`tests/bench_t2i_engine.py`'s requests: n random captions, each
    left-padded by a count in [0, 60) from RandomState(0)."""
    rng = np.random.RandomState(0)
    caps = rng.randn(n, T2I_T, T2I_CAPTION).astype(np.float32)
    masks = np.ones((n, T2I_T), bool)
    for i in range(n):
        pad = rng.randint(0, 60)
        masks[i, :pad] = False
        caps[i, :pad] = 0
    return caps, masks


def run_t2i_engine(dev):
    """The t2i serving engine at `tests/bench_t2i_engine.py`'s point:
    GPT-XL 256 px, W8A16 layers and head + int8 KV, 8 pairs, chunk 64, CFG
    7.5, 24 caption requests (three waves of 8 admitted in one prefill
    each). The first admission and chunk run under
    `torch.cuda.set_sync_debug_mode("error")`. The counters are read
    around each admission prefill and each chunk of steps: exactly 0 (K1)
    and 181 (K2: five matmuls a layer and the head) per admission, 36 (K1)
    and 181 (K2) per step, steps counted by the host; 4 results through
    the VQ-16 decoder."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     quantize_gpt_params)
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    model = quantize_gpt_params(t2i_model(dev, 256, seed=91),
                                quantize_head=True)
    caps, masks = t2i_engine_requests()
    tokens_n = model.cfg.block_size
    kw = dict(num_pairs=T2I_ENGINE_PAIRS, chunk=T2I_ENGINE_CHUNK,
              compute_dtype=torch.bfloat16, cache_dtype=torch.int8,
              sampling_params=SamplingParams(cfg_scale=T2I_CFG))
    ServeEngine(model, max_new_tokens=16, **kw).generate_t2i(
        caps[:T2I_ENGINE_PAIRS], masks[:T2I_ENGINE_PAIRS])  # warm-up
    torch.cuda.synchronize()

    eng = ServeEngine(model, max_new_tokens=tokens_n, **kw)
    # each admission prefill and each chunk of steps read the counters
    # before and after it: (K1, K2) launches per admission and per chunk
    per_admission, per_chunk = [], []

    def counted(fn, into):
        def call(*args):
            k1_0, k2_0 = decode_attention.launches, int8_matmul.launches
            out = fn(*args)
            into.append((args, decode_attention.launches - k1_0,
                         int8_matmul.launches - k2_0))
            return out
        return call

    eng._admit_fn = counted(eng._admit_fn, per_admission)
    eng.step_fn = counted(eng.step_fn, per_chunk)
    decode_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.time()
    reqs = [eng.submit_caption(c, m) for c, m in zip(caps, masks)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._admit_and_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng._harvest()
    eng.run_until_idle()
    torch.cuda.synchronize()
    secs = time.time() - t0
    k1, k2 = decode_attention.launches, int8_matmul.launches
    steps, admissions = eng.steps_run, eng.admissions
    st = eng.stats()
    n_layer = model.cfg.n_layer
    per = 5 * n_layer + 1
    # step_fn(state, n_steps, filters_off)
    chunk_steps = [args[-2] for args, _, _ in per_chunk]
    k1_adm = sum(a for _, a, _ in per_admission)
    k2_adm = sum(b for _, _, b in per_admission)
    k1_steps = sum(a for _, a, _ in per_chunk)
    k2_steps = sum(b for _, _, b in per_chunk)
    log(f"t2i serving engine (GPT-XL 256, W8A16 layers and head + int8 KV, "
        f"{T2I_ENGINE_PAIRS} pairs, chunk {T2I_ENGINE_CHUNK}, "
        f"{T2I_ENGINE_REQUESTS} captions, CFG {T2I_CFG}): {secs:.3f} s = "
        f"{T2I_ENGINE_REQUESTS / secs:.4f} img/s, {steps} steps = "
        f"{1e3 * secs / steps:.3f} ms/step (admissions included), "
        f"{admissions} admissions; TTFT p50 {st['ttft_p50_s']:.4f} s p95 "
        f"{st['ttft_p95_s']:.4f} s, TPOT p50 {st['tpot_p50_s']:.5f} s p95 "
        f"{st['tpot_p95_s']:.5f} s, e2e p50 {st['e2e_latency_p50_s']:.3f} s "
        f"p95 {st['e2e_latency_p95_s']:.3f} s; launches decode_attention "
        f"{k1}, int8_matmul {k2}; first admission and chunk under sync "
        f"debug mode 'error': no device-to-host read")
    log(f"t2i serving engine counters: {len(per_admission)} admission "
        f"prefills, (decode_attention, int8_matmul) launches each "
        f"{[(a, b) for _, a, b in per_admission]}; {len(per_chunk)} chunks "
        f"of {sum(chunk_steps)} steps, int8_matmul {k2_steps} = "
        f"{k2_steps / max(sum(chunk_steps), 1):g} a step, decode_attention "
        f"{k1_steps} = {k1_steps / max(sum(chunk_steps), 1):g} a step")
    log(f"t2i serving engine stats: {json.dumps(st)}")
    bad_adm = [(a, b) for _, a, b in per_admission if (a, b) != (0, per)]
    bad_chunk = [(n, a, b) for n, (_, a, b) in zip(chunk_steps, per_chunk)
                 if (a, b) != (n_layer * n, per * n)]
    if bad_adm or bad_chunk or len(per_admission) != admissions \
            or sum(chunk_steps) != steps or k1 != k1_adm + k1_steps \
            or k2 != k2_adm + k2_steps:
        raise AssertionError(
            f"launch counts: admissions (K1, K2) {bad_adm} (expected (0, "
            f"{per}) each), chunks (steps, K1, K2) {bad_chunk[:5]} (expected "
            f"({n_layer}, {per}) a step), totals {k1}, {k2}")
    tokens = torch.tensor(np.stack([r.result for r in reqs]))
    waves = -(-T2I_ENGINE_REQUESTS // T2I_ENGINE_PAIRS)
    if tokens.shape != (T2I_ENGINE_REQUESTS, tokens_n) or tokens.min() < 0 \
            or tokens.max() >= model.cfg.vocab_size \
            or st["completed"] != T2I_ENGINE_REQUESTS \
            or steps != waves * (tokens_n - 1) or admissions != waves:
        raise AssertionError(f"bad engine results {tuple(tokens.shape)}, "
                             f"completed {st['completed']}, steps {steps}, "
                             f"admissions {admissions}")
    del model, eng
    vq_model = vq.init_weights(vq.VQModel(vq_config("VQ-16"), device=dev,
                                          dtype=torch.bfloat16))
    imgs = vq_model.decode_code(tokens[:4].to(dev).reshape(4, 16, 16))
    torch.cuda.synchronize()
    if imgs.shape != (4, 256, 256, 3) or not torch.isfinite(imgs).all():
        raise AssertionError("t2i engine images are not finite")
    log(f"t2i serving engine VQ-16 decode of 4 results -> "
        f"{tuple(imgs.shape)}, finite")
    return {"decode_attention": k1, "int8_matmul": k2,
            "int8_matmul_steps": k2_steps,
            "int8_matmul_admissions": k2_adm, "steps": steps,
            "admissions": admissions,
            "img_s": T2I_ENGINE_REQUESTS / secs}


def run_t2i_engine_greedy_f32(dev):
    """Greedy t2i engine tokens equal `generate(emb_masks=...)`'s: GPT-XL
    width cut to 2 layers, f32 compute, W8A16 + int8 KV (K1's f32 entry,
    K2's f32 x), 2 pairs, 4 captions with pads 0, 60, 100 and 119 (the
    last two reusing slots), 48 tokens (positions 120-167: the flushes at
    127 and 159), CFG 7.5, temperature 0."""
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    model = quantize_gpt_params(t2i_model(dev, 256, seed=92,
                                          dtype=torch.float32, n_layer=2))
    caps, masks = t2i_captions(dev, T2I_PADS, seed=93, dtype=torch.float32)
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=48, chunk=16,
                      compute_dtype=torch.float32, cache_dtype=torch.int8,
                      sampling_params=SamplingParams(cfg_scale=T2I_CFG,
                                                     temperature=0.0))
    reqs = [eng.submit_caption(caps[0], masks[0])]
    eng._admit_and_step()  # the second slot starts a chunk later
    reqs += [eng.submit_caption(c, m) for c, m in zip(caps[1:], masks[1:])]
    eng.run_until_idle()
    got = torch.tensor(np.stack([r.result for r in reqs]))
    ref = generate(model, caps, emb_masks=masks, max_new_tokens=48,
                   cfg_scale=T2I_CFG, sample_logits=False,
                   compute_dtype=torch.float32,
                   cache_dtype=torch.int8).cpu()
    same = torch.equal(got, ref)
    log(f"greedy f32 t2i engine (GPT-XL width, 2 layers, W8A16 + int8 KV, "
        f"2 pairs, 4 captions, pads {T2I_PADS}, 48 tokens) == generate: "
        f"{same} ({len(torch.unique(ref))} distinct tokens, "
        f"{eng.admissions} admissions)")
    if not same:
        bad = (got != ref).nonzero()[:5].tolist()
        raise AssertionError(f"greedy t2i engine tokens differ at {bad}")


def run_t2i_speculative(dev):
    """The t2i speculative path at 512 px: GPT-XL cut to T2I_SPEC_LAYERS
    layers, bf16 weights and caches, a grouped-W4 copy of it drafting (self-speculation),
    k 4, 4 captions left-padded by 0, 60, 100 and 119 + CFG 7.5, top-k
    1000, sampled, 1,024 tokens. Each round runs k + 1 draft steps (C 1)
    and one verify (C 5), every one on K5 with `prefix_pad`: counters
    exactly layers * (k + 2) * rounds (K5) and 5 * layers * (k + 1) *
    rounds (K3, the draft's decode matmuls); K1 none."""
    import copy
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.chunk_attention import chunk_decode_attention
    from llamagen_tpu_torch.ops.speculative import generate_speculative
    from llamagen_tpu_torch.ops.w4_matmul import (quantize_gpt_params_w4k,
                                                  w4_matmul)
    target = t2i_model(dev, 512, seed=96, n_layer=T2I_SPEC_LAYERS)
    draft = quantize_gpt_params_w4k(copy.deepcopy(target))
    caps, masks = t2i_captions(dev, T2I_PADS, seed=97)
    tokens_n = target.cfg.block_size
    kw = dict(k=SPEC_K, emb_masks=masks, cfg_scale=T2I_CFG, top_k=T2I_TOP_K,
              compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    generate_speculative(target, draft, caps, max_new_tokens=16,
                         generator=gen, **kw)  # warm
    torch.cuda.synchronize()

    chunk_decode_attention.launches = 0
    w4_matmul.launches = 0
    decode_attention.launches = 0
    t0 = time.time()
    tokens, rounds = generate_speculative(target, draft, caps,
                                          max_new_tokens=tokens_n,
                                          generator=gen, **kw)
    torch.cuda.synchronize()
    secs = time.time() - t0
    k5, k3 = chunk_decode_attention.launches, w4_matmul.launches
    k1 = decode_attention.launches
    n_layer = target.cfg.n_layer
    log(f"t2i speculative path (GPT-XL 512 bf16 target, {n_layer} layers, "
        f"W4 g128 self-draft, "
        f"k {SPEC_K}, {T2I_BATCH} captions with pads {T2I_PADS} + CFG "
        f"{T2I_CFG}, top-k {T2I_TOP_K}, sampled): {tokens_n} tokens in "
        f"{rounds} rounds = {tokens_n / rounds:.3f} tokens/round, "
        f"{secs:.3f} s = {T2I_BATCH / secs:.4f} img/s, "
        f"{1e3 * secs / rounds:.3f} ms/round; launches "
        f"chunk_decode_attention {k5}, w4_matmul {k3}, decode_attention {k1}")
    want5 = n_layer * (SPEC_K + 2) * rounds
    want3 = 5 * n_layer * (SPEC_K + 1) * rounds
    if k5 != want5 or k3 != want3 or k1 != 0:
        raise AssertionError(f"launch counts {k5}, {k3}, {k1}: expected "
                             f"{want5}, {want3}, 0")
    if tokens.shape != (T2I_BATCH, tokens_n) or tokens.min() < 0 \
            or tokens.max() >= target.cfg.vocab_size \
            or not -(-(tokens_n - 1) // (SPEC_K + 1)) <= rounds \
            <= tokens_n - 1:
        raise AssertionError(f"bad tokens {tuple(tokens.shape)} or rounds "
                             f"{rounds}")
    return {"chunk_decode_attention": k5, "w4_matmul": k3,
            "rounds": rounds, "img_s": T2I_BATCH / secs}


def run_t2i_spec_greedy_f32(dev):
    """Greedy t2i speculative decoding commits `generate`'s tokens: GPT-XL
    width cut to 2 layers, f32 (f32 caches), a W4 copy drafting, k 4, 4
    captions with pads 0, 60, 100 and 119 + CFG 7.5, 48 tokens; K5 runs
    every draft and verify step at 20 heads with `prefix_pad`: exactly
    2 * (k + 2) * rounds launches."""
    import copy
    from llamagen_tpu_torch.ops.chunk_attention import chunk_decode_attention
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.speculative import generate_speculative
    from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
    target = t2i_model(dev, 256, seed=94, dtype=torch.float32, n_layer=2)
    draft = quantize_gpt_params_w4k(copy.deepcopy(target))
    caps, masks = t2i_captions(dev, T2I_PADS, seed=95, dtype=torch.float32)
    kw = dict(max_new_tokens=48, emb_masks=masks, cfg_scale=T2I_CFG,
              sample_logits=False, compute_dtype=torch.float32)
    ref = generate(target, caps, cache_dtype=torch.float32, **kw)
    chunk_decode_attention.launches = 0
    got, rounds = generate_speculative(target, draft, caps, k=SPEC_K, **kw)
    k5 = chunk_decode_attention.launches
    same = torch.equal(got, ref)
    log(f"greedy f32 t2i speculative (GPT-XL width, 2 layers, W4 "
        f"self-draft, k {SPEC_K}, pads {T2I_PADS}, 48 tokens) == generate: "
        f"{same} ({rounds} rounds, {len(torch.unique(ref))} distinct "
        f"tokens); launches chunk_decode_attention {k5}")
    if not same:
        bad = (got != ref).nonzero()[:5].tolist()
        raise AssertionError(f"greedy t2i speculative tokens differ at "
                             f"{bad}")
    if k5 != 2 * (SPEC_K + 2) * rounds:
        raise AssertionError(f"K5 launches {k5}, expected "
                             f"{2 * (SPEC_K + 2) * rounds}")
    return {"chunk_decode_attention": k5, "rounds": rounds}


def run_t2i_cli(dev):
    """`python -m llamagen_tpu_torch.cli.sample_t2i` at its defaults (GPT-XL
    256 px, bf16, the 4 demo prompts, CFG 7.5, top-k 1000, random weights;
    no --t5-path: random caption features) on the card."""
    from llamagen_tpu_torch.cli import sample_t2i
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "grid.png")
        t0 = time.time()
        res = sample_t2i.main(["--device", "cuda", "--out", out])
        secs = time.time() - t0
        png_ok = os.path.getsize(out) > 0
    n = res.images.shape[0]
    log(f"CLI sample_t2i (defaults: GPT-XL 256, bf16, {n} prompts + CFG "
        f"7.5, top-k 1000): sampling {res.gen_seconds:.3f} s = "
        f"{n / res.gen_seconds:.4f} img/s; whole CLI {secs:.3f} s")
    if res.images.shape != (4, 256, 256, 3) \
            or not np.isfinite(res.images).all() or not png_ok \
            or res.tokens.min() < 0 or res.tokens.max() >= 16384:
        raise AssertionError("t2i CLI output is not 4 finite 256 px images")


# ---------------------------------------------------------------------------
# Phases 35-37: GPTQ + AWQ, the speculative engine, greedy f32 engine
# ---------------------------------------------------------------------------


def spec_model_entry(n_layer=SPEC_LAYERS):
    """"GPT-L-{n_layer}" in the port's zoo (GPT-L's widths at `n_layer`
    layers), so that the CLIs take the cut model by name; returns the
    name."""
    from llamagen_tpu_torch import config
    name = f"GPT-L-{n_layer}"
    config.GPT_CONFIGS[name] = lambda **kw: config.replace(
        config.gpt_config("GPT-L", **kw), n_layer=n_layer)
    return name


def weighted_error(dw, h):
    """tr(dW^T H dW) in f64: a quantised matrix's error on the calibration
    inputs whose Hessian is h."""
    dw, h = dw.double(), h.double()
    return float(torch.einsum("kn,kj,jn->", dw, h, dw))


def run_gptq_awq(dev):
    """`tools quantize-ckpt --mode w4 --method gptq --quantize-head`
    (GPTQ_CALIB random calibration samples, g128) through the CLI on the
    card, on random GPT-L 384 weights at SPEC_LAYERS layers, without and
    with --awq; each run's seconds. Checks: every matrix of the first and
    the last layer has a smaller H-weighted error tr(dW^T H dW) than
    round-to-nearest at the same grid (H: the Hessian GPTQ's walk used,
    kept by `cmd_quantize_ckpt`);
    layer 0's wqkv levels on the card equal the CPU port's walk on the
    same W and H on >= 99.9 % of the entries and its scales within 1e-5
    relative (tests/test_torch_gptq.py's tolerances); the AWQ + GPTQ
    model's teacher-forced logits are finite. Returns the GPTQ model (the
    engine's W4 draft)."""
    import argparse
    from llamagen_tpu_torch.cli import tools
    from llamagen_tpu_torch.cli.common import load_gpt
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops import gptq
    from llamagen_tpu_torch.ops.w4_matmul import _levels, pack_w4, w4_dequant
    spec_model_entry()
    src = gpt_model(dev, seed=71, n_layer=SPEC_LAYERS)
    models, hess = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "src.pt")
        torch.save(src.state_dict(), ckpt)
        for awq in (False, True):
            path = os.path.join(tmp, "awq_gptq.pt" if awq else "gptq.pt")
            t0 = time.time()
            args = tools.parse_args(
                ["quantize-ckpt", "--in", ckpt, "--out", path, "--mode",
                 "w4", "--method", "gptq", "--quantize-head", "--gpt-model",
                 SPEC_MODEL, "--image-size", "384", "--calib-samples",
                 str(GPTQ_CALIB), "--device", "cuda"]
                + (["--awq"] if awq else []))
            # the plain GPTQ run keeps the Hessians its walk used
            tools.cmd_quantize_ckpt(args, hessians=None if awq else hess)
            torch.cuda.synchronize()
            log(f"CLI quantize-ckpt --method gptq{' --awq' if awq else ''} "
                f"(GPT-L 384 width, {SPEC_LAYERS} layers, g128, int8 head, "
                f"{GPTQ_CALIB} calibration samples; the CLI's default is "
                f"128): {time.time() - t0:.1f} s")
            models[awq] = load_gpt(path, SPEC_MODEL, 384, 16, torch.bfloat16,
                                   dev)
    model = models[False]
    for l in (0, SPEC_LAYERS - 1):
        for key, lin in gptq.layer_linears(model.layers[l]).items():
            w = gptq.layer_linears(src.layers[l])[key].weight.detach().t() \
                .float()
            err = weighted_error(
                w4_dequant(lin.weight_w4b, lin.weight_w4s) - w, hess[l][key])
            rtn = weighted_error(w4_dequant(*pack_w4(w)) - w, hess[l][key])
            log(f"GPTQ layer {l} {key}: tr(dW^T H dW) {err:.5g}, "
                f"round-to-nearest {rtn:.5g} ({err / rtn:.3f}x)")
            if not err < rtn:
                raise AssertionError(f"GPTQ's error at layer {l} {key} is "
                                     f"not below round-to-nearest's")
    lin = model.layers[0].attention.wqkv
    t0 = time.time()
    cpu_b, cpu_s = gptq.gptq_quantize_matrix(
        src.layers[0].attention.wqkv.weight.detach().t().float().cpu(),
        hess[0]["wqkv"].cpu())
    lv, cpu_lv = _levels(lin.weight_w4b).cpu(), _levels(cpu_b)
    differ = int((lv != cpu_lv).sum())
    rel = ((lin.weight_w4s.cpu() - cpu_s).abs() / cpu_s.abs()).max().item()
    log(f"GPTQ layer 0 wqkv, card vs the CPU port's walk on the same W and H"
        f" ({time.time() - t0:.1f} s on the CPU): {differ} of {lv.numel()} "
        f"levels differ (tol {int(1e-3 * lv.numel())}), scales max relative "
        f"difference {rel:.3g} (tol 1e-05)")
    if differ > 1e-3 * lv.numel() or not rel <= 1e-5:
        raise AssertionError("the card's GPTQ levels disagree with the CPU's")
    cond, tokens = tools.calibration_set(argparse.Namespace(
        calib_seed=0, calib_samples=4, calib_codes=None), model.cfg, dev)
    logits, _ = gpt.forward_train(models[True], cond, tokens[:, :-1],
                                  train=False, compute_dtype=torch.bfloat16)
    if not torch.isfinite(logits).all():
        raise AssertionError("the AWQ + GPTQ model's logits are not finite")
    log(f"AWQ + GPTQ model: teacher-forced logits {tuple(logits.shape)}, "
        f"finite")
    return model


def device_busy(fn, units):
    """fn() (units of work, ending in no synchronise) run twice: on the
    host clock, then under `torch.profiler`. (wall ms, device busy ms) per
    unit; busy = the union of the kernels' intervals (None where the
    profiler sees no kernel)."""
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3 / units
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return wall, (busy / 1e3 / units if spans else None)


def run_spec_engine(dev, draft):
    """The speculative engine: a W8A16 target (layers and int8 head; GPT-L
    384 width, SPEC_LAYERS layers, the weights phase 35 quantised) and its
    GPTQ W4 g128 self-draft (int8 head), 8 pairs, k 4, bf16 caches; 12
    requests (4 reuse a slot) with cfg 1.5 / 2.0 / 4.0, temperatures 1.0
    and 0.8, top-k 1000 on three and two greedy rows. Every admission and
    chunk runs under `torch.cuda.set_sync_debug_mode("error")`; the host
    reads n_generated once a chunk. Counters exactly: K5 rounds * L *
    (k + 2) (k + 1 draft steps at C 1 and the verify at C k + 1, each
    layer), K3 rounds * 5L * (k + 1) (the draft's layer matmuls at 2P
    rows), K2 rounds * (5L + 1 + k + 1) (the verify's layers at 2P(k + 1)
    rows and head, the draft's int8 head) + admissions * (5L + 2) (the
    target's prefill and head, the draft's head: the draft's W4 layers
    take the dequantised product at rank 3). Every request completes,
    every id in range. Prints img/s, ms per round, rounds, tokens per
    round and slot, the acceptance rate, and the device busy share of 4
    rounds at capacity."""
    from llamagen_tpu_torch.ops.chunk_attention import chunk_decode_attention
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     quantize_gpt_params)
    from llamagen_tpu_torch.ops.w4_matmul import w4_matmul
    from llamagen_tpu_torch.serve.engine import SamplingParams
    from llamagen_tpu_torch.serve.spec_engine import SpecEngine
    target = quantize_gpt_params(gpt_model(dev, seed=71, n_layer=SPEC_LAYERS),
                                 quantize_head=True)
    kw = dict(num_pairs=SPEC_ENGINE_PAIRS, k=SPEC_K,
              compute_dtype=torch.bfloat16)
    SpecEngine(target, draft, max_new_tokens=16, **kw).generate(
        range(SPEC_ENGINE_PAIRS))  # warm-up: allocator, first launches
    torch.cuda.synchronize()

    eng = SpecEngine(target, draft, max_new_tokens=TOKENS, **kw)
    sps = [SamplingParams(cfg_scale=(1.5, 2.0, 4.0)[i % 3],
                          temperature=0.0 if i in (2, 9) else (1.0, 0.8)[i % 2],
                          top_k=1000 if i in (1, 6, 11) else 0)
           for i in range(SPEC_ENGINE_REQUESTS)]
    int8_matmul.launches = w4_matmul.launches = 0
    chunk_decode_attention.launches = 0
    t0 = time.time()
    reqs = [eng.submit(i * 83 % 1000, sp=sp) for i, sp in enumerate(sps)]
    chunks = 0
    while not eng.pending.empty() \
            or any(r is not None for r in eng.slot_request):
        torch.cuda.set_sync_debug_mode("error")
        try:  # no device-to-host read in an admission or a chunk
            eng._admit()
            ran = eng._run_chunk()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if ran:
            eng._sync()
        eng._harvest()
        chunks += 1
    torch.cuda.synchronize()
    secs = time.time() - t0
    k2, k3, k5 = (int8_matmul.launches, w4_matmul.launches,
                  chunk_decode_attention.launches)
    rounds, adm, layers = eng.rounds, eng.admissions, SPEC_LAYERS
    st = eng.stats()
    log(f"speculative engine (GPT-L 384 width, {layers} layers, W8A16 target"
        f" + int8 head, GPTQ W4 g128 self-draft + int8 head, "
        f"{SPEC_ENGINE_PAIRS} pairs, k {SPEC_K}, bf16 caches, "
        f"{SPEC_ENGINE_REQUESTS} requests, cfg 1.5/2.0/4.0, 2 greedy, 3 "
        f"with top-k 1000): {secs:.3f} s = {SPEC_ENGINE_REQUESTS / secs:.3f}"
        f" img/s, {rounds} rounds in {chunks} chunks = "
        f"{1e3 * secs / rounds:.3f} ms/round, {adm} admissions, "
        f"{st['tokens_per_round_per_slot']:.3f} tokens/round/slot, "
        f"acceptance {st['acceptance_rate']:.3f}; TTFT p50 "
        f"{st['ttft_p50_s']:.3f} s, e2e p50 {st['e2e_latency_p50_s']:.3f} s;"
        f" launches int8_matmul {k2}, w4_matmul {k3}, chunk_decode_attention"
        f" {k5}; every admission and chunk under sync debug mode 'error'")
    log(f"speculative engine stats: {json.dumps(st)}")
    want = (rounds * (5 * layers + 1 + SPEC_K + 1) + adm * (5 * layers + 2),
            rounds * 5 * layers * (SPEC_K + 1),
            rounds * layers * (SPEC_K + 2))
    if (k2, k3, k5) != want:
        raise AssertionError(f"launch counts {(k2, k3, k5)}: expected "
                             f"{want}")
    tokens = np.stack([r.result for r in reqs])
    if tokens.shape != (SPEC_ENGINE_REQUESTS, TOKENS) or tokens.min() < 0 \
            or tokens.max() >= target.cfg.vocab_size \
            or st["completed"] != SPEC_ENGINE_REQUESTS:
        raise AssertionError(f"bad engine results {tokens.shape}, "
                             f"completed {st['completed']}")
    # the device's busy share over 4 rounds with every slot busy
    for i in range(SPEC_ENGINE_PAIRS):
        eng.submit(i * 7)
    eng._admit()
    wall, busy = device_busy(lambda: eng.step_fn(eng.state, 4, True), 4)
    log(f"speculative engine, 4 rounds at capacity: {wall:.3f} ms/round "
        f"wall, device busy "
        + ("not measured (no kernel in the profile)" if busy is None else
           f"{busy:.3f} ms/round = {100 * busy / wall:.1f} % busy, "
           f"{100 * (1 - busy / wall):.1f} % idle"))
    return {"int8_matmul": k2, "w4_matmul": k3, "chunk_decode_attention": k5,
            "rounds": rounds, "img_s": SPEC_ENGINE_REQUESTS / secs}


def run_spec_engine_greedy_f32(dev):
    """Greedy f32 engine tokens equal `generate`'s: c2i at GPT-L width cut
    to 2 layers, a W4 copy drafting, k 4, 2 pairs, 4 requests with cfg
    1.5 / 2.0 / 4.0 / 3.0 (the last two reuse slots), 64 tokens, against
    `generate` per request and the port's `ServeEngine` on the same
    requests; t2i at GPT-XL width cut to 2 layers, 4 captions padded by 0,
    60, 100 and 119, CFG 7.5, 48 tokens, against `generate(emb_masks=)`.
    K5's f32 entry at per-slot positions (and `prefix_pad`)."""
    import copy
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    from llamagen_tpu_torch.serve.spec_engine import SpecEngine
    f32 = dict(compute_dtype=torch.float32)
    target = gpt_model(dev, seed=81, dtype=torch.float32, n_layer=2)
    draft = quantize_gpt_params_w4k(copy.deepcopy(target))
    labels, scales = [207, 360, 387, 974], [1.5, 2.0, 4.0, 3.0]
    sps = [SamplingParams(cfg_scale=s, temperature=0.0) for s in scales]

    def serve(eng):
        reqs = [eng.submit(l, sp=sp) for l, sp in zip(labels, sps)]
        eng.run_until_idle()
        return np.stack([r.result for r in reqs])

    eng = SpecEngine(target, draft, num_pairs=2, max_new_tokens=64, k=SPEC_K,
                     **f32)
    got = serve(eng)
    base = serve(ServeEngine(target, num_pairs=2, max_new_tokens=64,
                             chunk=16, **f32))
    ref = np.stack([generate(target, torch.tensor([l], device=dev),
                             max_new_tokens=64, cfg_scale=s,
                             sample_logits=False, cache_dtype=torch.float32,
                             **f32)[0].cpu().numpy()
                    for l, s in zip(labels, scales)])
    same = np.array_equal(got, ref) and np.array_equal(got, base)
    log(f"greedy f32 speculative engine (GPT-L width, 2 layers, W4 "
        f"self-draft, k {SPEC_K}, 2 pairs, 4 requests, cfg {scales}, 64 "
        f"tokens) == generate == ServeEngine: {same} ({eng.rounds} rounds, "
        f"acceptance {eng.stats()['acceptance_rate']:.3f}, "
        f"{len(np.unique(ref))} distinct tokens)")
    if not same:
        raise AssertionError(f"greedy engine tokens differ: "
                             f"{np.argwhere(got != ref)[:5].tolist()}, "
                             f"{np.argwhere(got != base)[:5].tolist()}")

    target = t2i_model(dev, 256, seed=85, dtype=torch.float32, n_layer=2)
    draft = quantize_gpt_params_w4k(copy.deepcopy(target))
    caps, masks = t2i_captions(dev, T2I_PADS, seed=86, dtype=torch.float32)
    eng = SpecEngine(target, draft, num_pairs=2, max_new_tokens=48, k=SPEC_K,
                     sampling_params=SamplingParams(cfg_scale=T2I_CFG,
                                                    temperature=0.0), **f32)
    got = eng.generate_t2i(caps.cpu(), masks.cpu())
    ref = generate(target, caps, emb_masks=masks, max_new_tokens=48,
                   cfg_scale=T2I_CFG, sample_logits=False,
                   cache_dtype=torch.float32, **f32).cpu().numpy()
    same = np.array_equal(got, ref)
    log(f"greedy f32 t2i speculative engine (GPT-XL width, 2 layers, W4 "
        f"self-draft, 2 pairs, pads {T2I_PADS}, 48 tokens) == generate: "
        f"{same} ({eng.rounds} rounds, {eng.admissions} admissions, "
        f"{len(np.unique(ref))} distinct tokens)")
    if not same:
        raise AssertionError(f"greedy t2i engine tokens differ at "
                             f"{np.argwhere(got != ref)[:5].tolist()}")


# ---------------------------------------------------------------------------
# Phases 10-12: training attention (K4), the training CLI, one step vs plain
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps=5, calls=10):
    """Median ms per call of `fn()`: CUDA events around `calls` calls
    back to back (so the host's cost of each launch hides behind the
    device's work, as in a training step), `reps` times after one
    warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def attention_inputs(dev, shape, dtype, seed, strided_v=True):
    """q, k, v and an output gradient w; v strided as in the model (a view
    into the [B, S, 3F] wqkv output)."""
    b, s, h, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, w = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for _ in range(3))
    if strided_v:
        qkv = torch.randn(b, s, 3 * h * d, generator=g, device=dev).to(dtype)
        v = qkv[..., 2 * h * d:].reshape(shape)
    else:
        v = torch.randn(shape, generator=g, device=dev).to(dtype)
    return q, k, v, w


def attention_grads(fn, q, k, v, w):
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs, q.shape[-1] ** -0.5)
    out.backward(w)
    return [out.detach()] + [x.grad for x in xs]


def check_train_attention(dev):
    """K4 against its plain version. Errors are relative to the largest
    reference magnitude of each tensor: f32 1e-5 (sums in another order);
    bf16 1e-2 for o (1-2 bf16 ulps of the largest output) and 2e-2 for
    dq/dk/dv (p and ds are rounded to bf16 at other points: the kernel
    rounds ds as the TPU kernel does, the plain version's autograd rounds
    dp; delta = rowsum(do * o) carries o's rounding). Then the times at
    the GPT-L c2i training shape and at the GPT-XL t2i one."""
    from llamagen_tpu_torch.ops import train_attention as ta
    gpt_l_shape = (TRAIN_BATCH, TOKENS, 16, 64)
    cases = [(gpt_l_shape, torch.bfloat16, True),
             ((2, 577, 8, 128), torch.float32, True),
             ((2, 577, 8, 128), torch.bfloat16, False),
             ((2, 577, 8, 100), torch.bfloat16, False),
             ((4, 257, 12, 64), torch.bfloat16, True)]
    # the bf16 kernels' tile edges: 64-key tiles, 128 (forward) or 64
    # (backward) query rows, one row
    cases += [((3, s, 4, d), torch.bfloat16, True)
              for d in (64, 128) for s in (1, 65, 129)]
    # GPT-XL t2i training: S 375 ends mid-tile for the forward's 128 query
    # rows and the backward's 64; v's batch stride is 375 * 3840
    cases.append((T2I_TRAIN_SHAPE, torch.bfloat16, True))
    abs_err = {}
    for i, (shape, dtype, strided) in enumerate(cases):
        q, k, v, w = attention_inputs(dev, shape, dtype, 20 + i, strided)
        got = attention_grads(ta.causal_attention_padded, q, k, v, w)
        ref = attention_grads(ta.causal_attention_ref, q, k, v, w)
        torch.cuda.synchronize()
        rel = [max_err(a, r) / max(r.float().abs().max().item(), 1.0)
               for a, r in zip(got, ref)]
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        log(f"K4 causal_attention {list(shape)} {str(dtype)[6:]}"
            f"{' (v strided)' if strided else ''}: relative max err o "
            f"{rel[0]:.3g} (tol {tol:g}), dq {rel[1]:.3g}, dk {rel[2]:.3g}, "
            f"dv {rel[3]:.3g} (tol {2 * tol:g})")
        if not (rel[0] <= tol and max(rel[1:]) <= 2 * tol):
            raise AssertionError(f"K4 {shape} {dtype} disagrees")
        if shape in (gpt_l_shape, T2I_TRAIN_SHAPE):
            abs_err[shape] = {"fwd": max_err(got[0], ref[0]),
                              "dq": max_err(got[1], ref[1]),
                              "dkdv": max(max_err(got[2], ref[2]),
                                          max_err(got[3], ref[3]))}
        del got, ref
    t = time_train_attention(dev, gpt_l_shape, 30, "GPT-L training shape")
    log(f"K4 against the two-pass mma.sync design it replaced (0.596 "
        f"forward, 0.667 dq, 1.138 dk/dv ms on an NVIDIA H100 80GB HBM3 at "
        f"700 W, one call per pair of events): forward {t['fwd']:.4f} ms, "
        f"dq {t['dq']:.4f} + dk/dv {t['dkdv']:.4f} = "
        f"{t['dq'] + t['dkdv']:.4f} ms")
    t2i_t = time_train_attention(dev, T2I_TRAIN_SHAPE, 32,
                                 "GPT-XL t2i training shape")
    return abs_err[gpt_l_shape], t, abs_err[T2I_TRAIN_SHAPE], t2i_t


def time_train_attention(dev, shape, seed, label):
    """K4's forward, dq and dk/dv at one layer call's shape (bf16, v
    strided as in the model) beside the plain version, the bound and
    SDPA's forward and backward; returns the times and the kernels'
    record entries."""
    from llamagen_tpu_torch.ops import train_attention as ta
    b, s, h, d = shape
    q, k, v, w = attention_inputs(dev, shape, torch.bfloat16, seed)
    scale = d ** -0.5
    t = {}
    with torch.no_grad():
        t["fwd"] = cuda_ms(lambda: ta.train_attention_fwd(q, k, v, scale))
        t["plain_fwd"] = cuda_ms(
            lambda: ta.causal_attention_ref(q, k, v, scale))
        o, lse = ta.train_attention_fwd(q, k, v, scale)
        do = w.contiguous()
        t["dq"] = cuda_ms(lambda: ta.train_attention_dq(q, k, v, o, do, lse,
                                                        scale))
        _, delta = ta.train_attention_dq(q, k, v, o, do, lse, scale)
        t["dkdv"] = cuda_ms(lambda: ta.train_attention_dkdv(
            q, k, v, do, lse, delta, scale))
    t["fwd_bwd"] = cuda_ms(lambda: attention_grads(
        ta.causal_attention, q, k, v, w))
    t["plain_fwd_bwd"] = cuda_ms(lambda: attention_grads(
        ta.causal_attention_ref, q, k, v, w))
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = ta.causal_attention_ref(*xs, scale)
    t["plain_bwd"] = cuda_ms(lambda: torch.autograd.grad(
        out, xs, w, retain_graph=True))
    # torch's fused attention on the same inputs ([B, H, S, D] views)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with torch.no_grad():
        t["sdpa_fwd"] = library_time("K4 library (SDPA forward)",
                                     lambda: cuda_ms(
                                         lambda: F.scaled_dot_product_attention(
                                             qt, kt, vt, is_causal=True)))
    xs = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
    out_t = F.scaled_dot_product_attention(*xs, is_causal=True)
    t["sdpa_bwd"] = library_time("K4 library (SDPA backward)",
                                 lambda: cuda_ms(lambda: torch.autograd.grad(
                                     out_t, xs, w.transpose(1, 2),
                                     retain_graph=True)))
    # bounds per layer call: each input read once, each output written once;
    # one causal [S, S] x D product is 2 * B * H * D * S (S + 1) / 2 flops
    act = q.numel() * q.element_size()
    rowstat = b * h * s * 4  # lse or delta, f32
    prod = 2 * b * h * d * s * (s + 1) / 2
    bounds = {"fwd": bound(4 * act + rowstat, 2 * prod),
              "dq": bound(6 * act + 2 * rowstat, 3 * prod),
              "dkdv": bound(6 * act + 2 * rowstat, 4 * prod)}
    # the record's entries; no single library call computes dq or dk/dv
    # alone, and the plain version has no separate backward passes, so
    # both backward kernels stand beside the whole plain backward
    t["record"] = {
        key: dict(ms=t[key], plain=t["plain_fwd" if key == "fwd"
                                     else "plain_bwd"],
                  bound=bounds[key][0], by=bounds[key][1],
                  library=t["sdpa_fwd"] if key == "fwd" else None)
        for key in bounds}
    sdpa = {key: "n/a" if t[f"sdpa_{key}"] is None
            else f"{t[f'sdpa_{key}']:.4f}" for key in ("fwd", "bwd")}
    log(f"K4 bounds per layer call at {list(shape)} (ms, bound by): "
        f"{bounds}; SDPA forward {sdpa['fwd']} ms, SDPA backward (dq, dk, "
        f"dv together) {sdpa['bwd']} ms")
    log(f"K4 time, {label} {list(shape)} bf16 (v strided), per layer: "
        f"forward {t['fwd']:.4f} ms (plain {t['plain_fwd']:.3f}, bound "
        f"{bounds['fwd'][0]:.4f}, SDPA {sdpa['fwd']}), dq {t['dq']:.4f} ms, "
        f"dk/dv {t['dkdv']:.4f} ms (plain backward {t['plain_bwd']:.3f}, "
        f"SDPA backward {sdpa['bwd']}), forward + backward "
        f"{t['fwd_bwd']:.4f} ms (plain {t['plain_fwd_bwd']:.3f}); causal "
        f"QK^T + PV {2 * prod / 1e9:.1f} GFLOP = "
        f"{2 * prod / t['fwd'] / 1e9:.1f} TFLOP/s of useful forward work")
    return t


def k4_kernels():
    from llamagen_tpu_torch.ops import train_attention as ta
    return (ta.train_attention_fwd, ta.train_attention_dq,
            ta.train_attention_dkdv)


def path_gb(path):
    """The size of a file, or of every file under a directory, in GB."""
    if os.path.isfile(path):
        return os.path.getsize(path) / 1e9
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e9


def run_train_cli(dev, remat="full", steps=TRAIN_STEPS, args=(),
                  results_dir=None, label="training CLI"):
    """The training path through its CLI at GPT-L 384, batch 32. Under
    remat "full" K4's forward runs twice per layer and step (the step and
    the recompute), under "save_attn" once. `args` go to the CLI (a
    mesh); `results_dir` keeps the run's files (else a temp directory)."""
    from llamagen_tpu_torch.cli import train_c2i
    kernels = k4_kernels()
    with (tempfile.TemporaryDirectory() if results_dir is None
          else contextlib.nullcontext(results_dir)) as tmp:
        torch.cuda.reset_peak_memory_stats(dev)
        for f in kernels:
            f.launches = 0
        t0 = time.time()
        state = train_c2i.main([
            "--gpt-model", "GPT-L", "--image-size", "384",
            "--global-batch-size", str(TRAIN_BATCH),
            "--synthetic-steps", str(steps), "--log-every", "1",
            "--ckpt-every", "100000", "--results-dir", tmp,
            "--remat", remat, "--device", "cuda", *args])
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = {f.__name__: f.launches for f in kernels}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        recs = [json.loads(line)
                for line in open(os.path.join(tmp, "metrics.jsonl"))]
        recs = [r for r in recs if "loss" in r]
        # one process: a .pt; under a process group: a DCP directory
        ckpt = os.path.join(tmp, "checkpoints", f"step_{steps:08d}")
        ckpt = ckpt + ".pt" if os.path.exists(ckpt + ".pt") else ckpt
        ckpt_gb = path_gb(ckpt) if os.path.exists(ckpt) else 0
        n_params = sum(p.numel() for p in state.model.parameters())
        n_layer = state.model.cfg.n_layer
        del state
    step_s = statistics.median(1 / r["steps_per_sec"] for r in recs[2:])
    tokens = TRAIN_BATCH * TOKENS
    mfu = 6 * n_params * tokens / step_s / H100_BF16_FLOPS
    losses = [r["loss"] for r in recs]
    log(f"{label} (GPT-L 384, batch {TRAIN_BATCH}, {steps} steps, "
        f"bf16 compute, f32 master weights, AdamW + EMA, remat {remat}, "
        f"default dropouts): {secs:.1f} s in all; median step after warm-up "
        f"{step_s:.4f} s = {TRAIN_BATCH / step_s:.2f} samples/s = "
        f"{tokens / step_s:.0f} tokens/s; peak memory {peak:.2f} GiB; "
        f"MFU {100 * mfu:.2f} % (6 * {n_params / 1e6:.1f}M params * tokens "
        f"/ step time / 989 TFLOP/s); final checkpoint {ckpt_gb:.2f} GB")
    log(f"training losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in recs]}; K4 launches "
        f"{launches}")
    if abs(losses[0] - math.log(16384)) > 1e-3:
        raise AssertionError(f"first loss {losses[0]} is not ln 16384")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs):
        raise AssertionError("a loss or grad norm is not finite")
    if [r["step"] for r in recs] != list(range(1, steps + 1)) \
            or ckpt_gb == 0:
        raise AssertionError("metrics.jsonl or the checkpoint is incomplete")
    fwd_per_step = 2 if remat == "full" else 1
    want = {"train_attention_fwd": fwd_per_step * n_layer * steps,
            "train_attention_dq": n_layer * steps,
            "train_attention_dkdv": n_layer * steps}
    if launches != want:
        raise AssertionError(f"K4 launches {launches}, expected {want}")
    return launches, {"step_s": step_s, "peak_gib": peak, "mfu": mfu,
                      "losses": losses,
                      "grad_norms": [r["grad_norm"] for r in recs]}


def run_train_step_vs_plain(dev):
    """One full training step (loss, backward, clip, AdamW, EMA) at GPT-L
    with K4 and with its plain version, on the same weights and batch,
    dropout off, in bf16 and in f32 compute. Bounds, bf16: |loss
    difference| <= 1e-2 (logits carry ~2^-8 relative rounding, averaged
    over 18k tokens) and each parameter's ||g_kernel - g_plain|| /
    ||g_plain|| <= 5e-2 (the two attentions round p and ds at other
    points, and that noise passes through 24 bf16 layers); f32: 1e-4 and
    1e-3 (f32 sums in another order through 24 layers)."""
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.train import c2i
    cfg = gpt_config("GPT-L", block_size=TOKENS, cls_token_num=1,
                     class_dropout_prob=0.0, token_dropout_p=0.0,
                     resid_dropout_p=0.0, ffn_dropout_p=0.0)
    g = torch.Generator(device=dev).manual_seed(41)
    batch = c2i.Batch(
        labels=torch.randint(0, 1000, (TRAIN_BATCH,), generator=g,
                             device=dev),
        tokens=torch.randint(0, 16384, (TRAIN_BATCH, TOKENS), generator=g,
                             device=dev))
    return step_vs_plain(dev, "GPT-L", cfg, batch,
                         lambda dtype: c2i.make_train_step(
                             compute_dtype=dtype))


def step_vs_plain(dev, label, cfg, batch, make_step):
    """One step of `make_step(dtype)` on a seeded model of `cfg` with a
    random head, with K4 and with the plain attention, in bf16 and in f32
    compute (the bounds of `run_train_step_vs_plain`). Parameters that get
    no gradient (the t2i null caption with CFG dropout off) are left out."""
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops import train_attention as ta
    from llamagen_tpu_torch.train.train_state import (Optimizer,
                                                      init_train_state)
    worst = {}
    for dtype, (loss_bound, grad_bound) in ((torch.bfloat16, (1e-2, 5e-2)),
                                            (torch.float32, (1e-4, 1e-3))):
        runs = []
        for plain in (False, True):
            model = gpt.init_weights(gpt.Transformer(cfg, device=dev), seed=5)
            with torch.no_grad():  # a random head: every layer gets grads
                model.output.weight.normal_(0.0, 0.02, generator=torch
                                            .Generator(device=dev)
                                            .manual_seed(6))
            state = init_train_state(model, Optimizer(model), use_ema=True)
            step_fn = make_step(dtype)
            saved = gpt.causal_attention_padded
            if plain:
                gpt.causal_attention_padded = ta.causal_attention_ref
            try:
                t0 = time.time()
                state, m = step_fn(state, batch, 0)
                torch.cuda.synchronize()
                secs = time.time() - t0
            finally:
                gpt.causal_attention_padded = saved
            runs.append((m["loss"].item(), m["grad_norm"].item(), secs,
                         {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None}))
            del state, model, step_fn
        (lk, nk, sk, gk), (lp, np_, sp, gp) = runs
        if set(gk) != set(gp):
            raise AssertionError("K4 and the plain attention gave "
                                 "gradients to different parameters")
        rel = {n: ((gk[n].float() - gp[n].float()).norm()
                   / gp[n].float().norm().clamp_min(1e-30)).item()
               for n in gp}
        name = max(rel, key=rel.get)
        log(f"one {label} training step, {str(dtype)[6:]} compute, K4 vs "
            f"plain attention (dropout off): loss {lk:.6f} vs {lp:.6f} (|diff| "
            f"{abs(lk - lp):.3g}, bound {loss_bound:g}), grad norm {nk:.6f} "
            f"vs {np_:.6f}; worst relative gradient difference "
            f"{rel[name]:.3g} ({name}, bound {grad_bound:g}), median "
            f"{statistics.median(rel.values()):.3g}; first-step wall time "
            f"{sk:.2f} s vs {sp:.2f} s")
        if not (abs(lk - lp) <= loss_bound and rel[name] <= grad_bound):
            raise AssertionError(f"the {dtype} training step with K4 "
                                 f"disagrees with the plain version")
        worst[dtype] = (abs(lk - lp), rel[name])
        del runs, gk, gp
    return worst


# ---------------------------------------------------------------------------
# Phases 23-27: the tokenizer's encode side, t2i training
# ---------------------------------------------------------------------------


def vq_encoder_model(dev, dtype=torch.float32, seed=7):
    """The whole VQ-16 (encoder and quantizer too) at full width, seeded
    random weights."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.models import vq
    return vq.init_weights(vq.VQModel(vq_config("VQ-16"), device=dev,
                                      dtype=dtype, encoder=True),
                           seed=seed).eval()


def run_vq_encode(dev):
    """VQ-16 encode at full width, 32 random 256 px images (16 x 16 codes
    each). f32 (TF32 off: main() sets it for cuDNN too), timed; the ids of
    the first VQ_CPU_IMAGES images equal the port's own f32 encode on the
    CPU; bf16 (as the t2i training step runs it) timed, with the share of
    its ids equal to f32's; the f32 encode -> decode round trip with finite
    PSNR and SSIM (`eval/metrics.py`) and the codebook usage printed."""
    import copy

    from llamagen_tpu_torch.eval.metrics import (images_to_unit_range, psnr,
                                                 ssim)
    model = vq_encoder_model(dev)
    g = torch.Generator(device=dev).manual_seed(71)
    u8 = torch.randint(0, 256, (TRAIN_BATCH, 256, 256, 3), generator=g,
                       device=dev, dtype=torch.uint8)
    x = u8.float() / 127.5 - 1.0
    xb = x.to(torch.bfloat16)
    bf = copy.deepcopy(model).to(torch.bfloat16)
    with torch.no_grad():
        z_q, _, ids = model.encode(x)
        rec = model.decode(z_q)
        f32_ms = cuda_ms(lambda: model.encode(x), reps=3, calls=3)
        bids = bf.encode(xb)[2]
        bf16_ms = cuda_ms(lambda: bf.encode(xb), reps=3, calls=3)
        cpu = copy.deepcopy(model).cpu()
        t0 = time.time()
        cpu_ids = cpu.encode(x[:VQ_CPU_IMAGES].cpu())[2]
        cpu_s = time.time() - t0
    torch.cuda.synchronize()
    same_cpu = (cpu_ids == ids[:VQ_CPU_IMAGES].cpu()).sum().item()
    share = (bids == ids).float().mean().item()
    rec = rec.float().cpu().numpy()
    orig = u8.cpu().numpy().astype(np.float32) / 255.0
    ps = [psnr(a, images_to_unit_range(r)) for a, r in zip(orig, rec)]
    ss = [ssim(a, images_to_unit_range(r)) for a, r in zip(orig, rec)]
    usage = len(torch.unique(ids)) / model.cfg.codebook_size
    n_cpu = cpu_ids.numel()
    log(f"VQ-16 encode (full width, {TRAIN_BATCH} x 256 px -> 16 x 16 "
        f"codes, random weights): f32 {f32_ms:.3f} ms a batch, bf16 "
        f"{bf16_ms:.3f} ms; bf16 ids equal to f32's: {100 * share:.2f} %; "
        f"card f32 ids equal to the CPU's f32 ids on {VQ_CPU_IMAGES} images: "
        f"{same_cpu} of {n_cpu} (CPU encode {cpu_s:.1f} s)")
    log(f"VQ-16 f32 round trip: PSNR mean {np.mean(ps):.4f} dB, SSIM mean "
        f"{np.mean(ss):.4f} (random weights, noise images), codebook usage "
        f"{usage:.4f} ({len(torch.unique(ids))} codes)")
    if ids.shape != (TRAIN_BATCH, 16, 16) or rec.shape != (
            TRAIN_BATCH, 256, 256, 3) or bids.shape != ids.shape:
        raise AssertionError("VQ encode / decode shapes are wrong")
    if same_cpu != n_cpu:
        raise AssertionError("the card's f32 ids differ from the CPU's")
    if not (np.isfinite(rec).all() and np.isfinite(ps).all()
            and np.isfinite(ss).all()):
        raise AssertionError("the round trip is not finite")
    return {"f32_ms": f32_ms, "bf16_ms": bf16_ms, "share": share,
            "usage": usage}


def run_vq_cli_batches(dev):
    """The batch functions of the tokenizer CLIs on seeded uint8 crops
    with the CLIs' f32 VQ-16: `extract_codes.encode_batch` in the plain
    (16 crops), flip (8 images x 2) and ten-crop (4 images of 281 px x 10)
    layouts, int16 codes in range; `reconstruction_vq.roundtrip_batch` +
    `score` on 8 crops, finite."""
    from llamagen_tpu_torch.cli import extract_codes, reconstruction_vq
    model = vq_encoder_model(dev)
    rng = np.random.RandomState(72)
    imgs = list(rng.randint(0, 256, (16, 256, 256, 3), dtype=np.uint8))
    big = list(rng.randint(0, 256, (4, 281, 281, 3), dtype=np.uint8))
    out = {
        "plain": extract_codes.encode_batch(model, imgs, 1),
        "flip": extract_codes.encode_batch(
            model, [c for a in imgs[:8]
                    for c in extract_codes.crops_of(a, 256, "flip")], 2),
        "ten_crop": extract_codes.encode_batch(
            model, [c for a in big
                    for c in extract_codes.crops_of(a, 256, "ten_crop")],
            10)}
    want = {"plain": (16, 256), "flip": (8, 2, 256),
            "ten_crop": (4, 10, 256)}
    for key, codes in out.items():
        if codes.shape != want[key] or codes.dtype != np.int16 \
                or codes.min() < 0 or codes.max() >= 16384:
            raise AssertionError(f"extract_codes {key}: {codes.shape} "
                                 f"{codes.dtype}")
    same = (out["flip"][:, 0] == out["plain"][:8]).mean()
    t0 = time.time()
    rec, idx = reconstruction_vq.roundtrip_batch(model, imgs[:8])
    ps, ss, u8 = reconstruction_vq.score(imgs[:8], rec)
    secs = time.time() - t0
    log(f"tokenizer CLI batch functions: extract_codes shapes "
        f"{ {k: v.shape for k, v in out.items()} } int16; flip layout's "
        f"first crops equal the plain batch's codes: {100 * same:.2f} %; "
        f"reconstruction_vq round trip of 8 crops + scores {secs:.2f} s, "
        f"PSNR {np.mean(ps):.4f}, SSIM {np.mean(ss):.4f}")
    if rec.shape != (8, 256, 256, 3) or rec.dtype != np.float32 \
            or idx.shape != (8, 16, 16) or u8.dtype != np.uint8 \
            or not (np.isfinite(rec).all() and np.isfinite(ps).all()
                    and np.isfinite(ss).all()):
        raise AssertionError("reconstruction_vq's round trip is wrong")


def t2i_train_batch(dev, step, dtype=torch.float32):
    """One t2i training batch: 32 random 256 px images, 120 x 2048 caption
    features left-padded by 0 ... 119 rows (a pad each sample), sample 1
    with valid 0."""
    from llamagen_tpu_torch.train import t2i
    g = torch.Generator(device=dev).manual_seed(300 + step)
    images = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=g,
                        device=dev) * 2 - 1
    pads = [(j * 119 // (TRAIN_BATCH - 1) + 7 * step) % T2I_T
            for j in range(TRAIN_BATCH)]
    caps, masks = t2i_captions(dev, pads, 310 + step, dtype)
    valid = torch.ones(TRAIN_BATCH, device=dev)
    valid[1] = 0.0
    return t2i.T2IBatch(images, caps, masks.int(), valid)


def t2i_train_cfg(**kw):
    from llamagen_tpu_torch.config import gpt_config
    return gpt_config("GPT-XL", block_size=256, cls_token_num=T2I_T,
                      model_type="t2i", caption_dim=T2I_CAPTION, **kw)


def run_t2i_train(dev, steps=TRAIN_STEPS, mesh=None,
                  label="t2i training"):
    """GPT-XL t2i training through `train/t2i.py::build_trainer`: 256 px,
    120 caption rows, batch 32, bf16 compute, f32 master weights, AdamW +
    EMA, full remat, the JAX CLI's dropouts (class, token, resid, ffn
    0.1), the frozen VQ-16 in bf16 encoding the images inside the step.
    The K4 counters must read 2 * 36 * N (forward) and 36 * N (dq, dk/dv);
    the first loss ln 16384 (the zeroed head), every loss and grad norm
    finite; the VQ weights bit-unchanged with no .grad. With a `mesh`,
    sharded over it (`build_trainer(mesh=...)`)."""
    from llamagen_tpu_torch.train import t2i
    kernels = k4_kernels()
    cfg = t2i_train_cfg(class_dropout_prob=0.1, token_dropout_p=0.1,
                        resid_dropout_p=0.1, ffn_dropout_p=0.1)
    vq_model = vq_encoder_model(dev, torch.bfloat16)
    before = {k: v.clone() for k, v in vq_model.state_dict().items()}
    state, step_fn = t2i.build_trainer(cfg, vq_model, dev, mesh=mesh)
    n_params = sum(p.numel() for p in state.model.parameters())
    batches = [t2i_train_batch(dev, i) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels:
        f.launches = 0
    losses, norms, times = [], [], []
    for i in range(steps):
        t0 = time.time()
        state, m = step_fn(state, batches[i % 2], 0)
        losses.append(m["loss"].item())  # waits for the step
        norms.append(m["grad_norm"].item())
        times.append(time.time() - t0)
    launches = {f.__name__: f.launches for f in kernels}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    step_s = statistics.median(times[2:])
    positions = TRAIN_BATCH * (T2I_T + 255)
    mfu = 6 * n_params * positions / step_s / H100_BF16_FLOPS
    log(f"{label} (GPT-XL 256 px, {n_params / 1e6:.1f}M params, 120 "
        f"caption rows x 2048, batch {TRAIN_BATCH}, {steps} steps, bf16 "
        f"compute, full remat, dropouts 0.1, frozen bf16 VQ-16 encode in the "
        f"step): median step after warm-up {step_s:.4f} s = "
        f"{TRAIN_BATCH / step_s:.2f} samples/s; peak memory {peak:.2f} GiB; "
        f"MFU {100 * mfu:.2f} % (6 * params * {TRAIN_BATCH} * 375 positions "
        f"/ step time / 989 TFLOP/s; the VQ encode and attention not "
        f"counted); first two steps {times[0]:.2f}, {times[1]:.2f} s")
    log(f"{label} losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]}; K4 launches {launches}")
    if abs(losses[0] - math.log(16384)) > 1e-3:
        raise AssertionError(f"first loss {losses[0]} is not ln 16384")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError("a loss or grad norm is not finite")
    n_layer = cfg.n_layer
    want = {"train_attention_fwd": 2 * n_layer * steps,
            "train_attention_dq": n_layer * steps,
            "train_attention_dkdv": n_layer * steps}
    if launches != want:
        raise AssertionError(f"K4 launches {launches}, expected {want}")
    if any(p.grad is not None for p in vq_model.parameters()) or not all(
            torch.equal(v, before[k])
            for k, v in vq_model.state_dict().items()):
        raise AssertionError("the frozen VQ changed or got gradients")
    log("t2i training: the VQ weights are bit-unchanged, no .grad")
    del state, step_fn, vq_model, batches
    torch.cuda.empty_cache()
    return launches, {"step_s": step_s, "peak_gib": peak, "mfu": mfu,
                      "losses": losses, "grad_norms": norms}


def run_t2i_step_vs_plain(dev):
    """One t2i training step with K4 and with the plain attention at
    GPT-XL width cut to 4 layers (dropout off, a random head, the batch of
    `t2i_train_batch`), the frozen VQ-16 in the compute dtype; the bounds
    of `run_train_step_vs_plain`."""
    from llamagen_tpu_torch.config import replace
    from llamagen_tpu_torch.train import t2i
    cfg = replace(t2i_train_cfg(class_dropout_prob=0.0, token_dropout_p=0.0,
                                resid_dropout_p=0.0, ffn_dropout_p=0.0),
                  n_layer=4)
    vq32 = vq_encoder_model(dev)
    vqs = {torch.float32: vq32,
           torch.bfloat16: vq_encoder_model(dev, torch.bfloat16)}
    worst = step_vs_plain(dev, "GPT-XL t2i (4 layers)", cfg,
                          t2i_train_batch(dev, 0),
                          lambda dtype: t2i.make_train_step(
                              vqs[dtype], compute_dtype=dtype))
    del vqs, vq32
    torch.cuda.empty_cache()
    return worst


def run_t2i_train_cli(dev, steps=3):
    """`python -m llamagen_tpu_torch.cli.train_t2i --synthetic-steps 3
    --device cuda` at its defaults (GPT-XL 256 px, global batch 256, the
    synthetic caption window of 8 rows x 64), in this process: K4 counters
    2 * 36 * 3 and 36 * 3, finite losses, the first ln 16384, the final
    checkpoint written."""
    from llamagen_tpu_torch.cli import train_t2i
    from llamagen_tpu_torch.ops import train_attention as ta
    kernels = (ta.train_attention_fwd, ta.train_attention_dq,
               ta.train_attention_dkdv)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats(dev)
        for f in kernels:
            f.launches = 0
        t0 = time.time()
        state = train_t2i.main(["--synthetic-steps", str(steps),
                                "--device", "cuda", "--log-every", "1",
                                "--results-dir", tmp])
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = {f.__name__: f.launches for f in kernels}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        recs = [json.loads(line)
                for line in open(os.path.join(tmp, "metrics.jsonl"))]
        recs = [r for r in recs if "loss" in r]
        ckpt = os.path.join(tmp, "checkpoints", f"step_{steps:08d}.pt")
        ckpt_gb = os.path.getsize(ckpt) / 1e9 if os.path.exists(ckpt) else 0
        n_layer = state.model.cfg.n_layer
        del state
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in recs]
    log(f"CLI train_t2i (defaults: GPT-XL 256, batch 256, {steps} synthetic "
        f"steps): {secs:.1f} s in all, steps/s "
        f"{[round(r['steps_per_sec'], 3) for r in recs]}, "
        f"peak memory {peak:.2f} GiB, losses "
        f"{[round(x, 4) for x in losses]}, K4 launches {launches}; final "
        f"checkpoint {ckpt_gb:.2f} GB")
    want = {"train_attention_fwd": 2 * n_layer * steps,
            "train_attention_dq": n_layer * steps,
            "train_attention_dkdv": n_layer * steps}
    if launches != want or n_layer != 36:
        raise AssertionError(f"K4 launches {launches}, expected {want}")
    if len(losses) != steps or not np.isfinite(losses).all() \
            or abs(losses[0] - math.log(16384)) > 1e-3 or ckpt_gb == 0:
        raise AssertionError("train_t2i's losses or checkpoint are wrong")


def vq_gan_lpips(dev, seed=9):
    """A full-width LPIPS (VGG16 + heads) with seeded random weights."""
    from llamagen_tpu_torch.models import lpips
    return lpips.init_weights(lpips.LPIPS(device=dev), seed=seed)


def vq_gan_images(dev, step, b=VQ_GAN_BATCH, size=256):
    g = torch.Generator(device=dev).manual_seed(500 + step)
    return torch.rand(b, size, size, 3, generator=g, device=dev) * 2 - 1


def vq_gan_run(dev, label, cfg, loss_cfg, steps, batch=VQ_GAN_BATCH,
               mesh=None):
    """`steps` VQ-GAN steps, bf16 over f32 weights, remat, EMA: times,
    peak memory and the checks of phase 28 (with a `mesh`, data parallel
    over it)."""
    from llamagen_tpu_torch.train import vq as vq_train
    size = loss_cfg.image_size
    state, step_fn = vq_train.build_trainer(
        cfg, loss_cfg, dev, use_ema=True, lpips=vq_gan_lpips(dev),
        compute_dtype=torch.bfloat16, remat=True, mesh=mesh)
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    batches = [vq_gan_images(dev, i, batch, size) for i in range(2)]
    n_ids = batch * (size // cfg.downsample_factor) ** 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, hist = [], []
    for i in range(steps):
        before = state.usage_window.clone()
        t0 = time.time()
        state, m = step_fn(state, batches[i % 2])
        m = {k: v.item() for k, v in m.items()}  # waits for the step
        times.append(time.time() - t0)
        hist.append(m)
        w = state.usage_window
        if not torch.equal(w[:-n_ids], before[n_ids:]) or not (
                0 <= int(w.min()) and int(w.max()) < cfg.codebook_size):
            raise AssertionError(f"{label}: the usage window did not shift "
                                 f"by the step's {n_ids} ids")
        usage = len(torch.unique(w)) / cfg.codebook_size
        if abs(usage - m["codebook_usage"]) > 1e-6:
            raise AssertionError(f"{label}: usage {m['codebook_usage']} is "
                                 f"not the window's {usage}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    step_s = statistics.median(times[2:]) if steps > 3 else times[-1]
    moved = max((state.ema[k] - v).abs().max().item()
                for k, v in ema0.items())
    keys = ("gen_loss", "rec_loss", "perceptual_loss", "gen_adv_loss",
            "disc_loss", "disc_adaptive_weight", "codebook_usage")
    log(f"{label}: {steps} steps, median step {step_s:.4f} s = "
        f"{batch / step_s:.2f} img/s, first two steps "
        f"{times[0]:.2f}, {times[1]:.2f} s; peak memory {peak:.2f} GiB; "
        f"EMA moved by up to {moved:.3g}")
    for tag, m in (("first", hist[0]), ("last", hist[-1])):
        log(f"{label}: {tag} step " + ", ".join(
            f"{k} {m[k]:.5g}" for k in keys))
    if not all(np.isfinite(v) for m in hist for v in m.values()):
        raise AssertionError(f"{label}: a metric is not finite")
    if state.step != steps or moved <= 0:
        raise AssertionError(f"{label}: step {state.step}, EMA moved "
                             f"{moved}")
    if loss_cfg.disc_adaptive_weight and not all(
            0 < m["disc_adaptive_weight"] < 1e4 for m in hist):
        raise AssertionError(f"{label}: adaptive weight out of (0, 1e4)")
    if not all(m["disc_loss"] > 0 and m["perceptual_loss"] > 0
               for m in hist):
        raise AssertionError(f"{label}: a loss term is not live")
    del state, step_fn, batches
    torch.cuda.empty_cache()
    return {"step_s": step_s, "img_s": batch / step_s, "peak_gib": peak,
            "metrics": hist}


def run_vq_gan_train(dev, name="VQ-16", size=256, batch=VQ_GAN_BATCH,
                     **cfg_kw):
    """VQ-16 VQ-GAN training at 256 px, batch 32: PatchGAN, hinge, l2,
    disc_start 0 (every term and both updates live), 10 steps; then
    StyleGAN with the adaptive weight and dropout 0.1, 3 steps."""
    from llamagen_tpu_torch.config import replace, vq_config
    from llamagen_tpu_torch.train import vq as vq_train
    cfg = vq_config(name, **cfg_kw)
    out = vq_gan_run(dev, f"VQ-GAN ({name} {size} px, PatchGAN, batch "
                          f"{batch}, bf16, remat)", cfg,
                     vq_train.VQLossConfig(disc_start=0, image_size=size),
                     VQ_GAN_STEPS, batch)
    out["stylegan"] = vq_gan_run(
        dev, "VQ-GAN (StyleGAN, adaptive weight, dropout 0.1)",
        replace(cfg, dropout_p=0.1),
        vq_train.VQLossConfig(disc_start=0, disc_type="stylegan",
                              disc_adaptive_weight=True, image_size=size),
        VQ_GAN_STYLEGAN_STEPS, batch)
    return out


def _vq_grad_check(label, mod_a, mod_b, share, lr):
    """Gradients of mod_a (the card) against mod_b (the CPU) within
    `share` of mod_b's largest; parameters within 1 % of lr where the
    gradient is at least 10 x share of the largest, 2 lr elsewhere."""
    ref = dict(mod_b.named_parameters())
    gmax = max(p.grad.abs().max().item() for p in ref.values())
    worst = [0.0, 0.0]
    for name, p in mod_a.named_parameters():
        g, r = p.grad.cpu(), ref[name].grad
        worst[0] = max(worst[0], (g - r).abs().max().item() / gmax)
        diff = (p.detach().cpu() - ref[name].detach()).abs()
        big = r.abs() >= 10 * share * gmax
        if big.any():
            worst[1] = max(worst[1], diff[big].max().item() / lr)
        if diff.max().item() > 2 * lr * 1.001:
            raise AssertionError(f"{label} {name}: moved {diff.max():.3g}")
    if worst[0] > share or worst[1] > 1e-2:
        raise AssertionError(f"{label}: gradient {worst[0]:.3g} of the "
                             f"largest, parameters {worst[1]:.3g} lr")
    return worst


def run_vq_gan_vs_cpu(dev):
    """One f32 VQ-GAN step at narrow width from the same weights on the
    card and on the CPU (TF32 off): every metric, gradient and updated
    parameter within VQ_CPU_BOUNDS; the usage windows (the step's ids)
    equal."""
    import copy

    from llamagen_tpu_torch.config import replace, vq_config
    from llamagen_tpu_torch.train import vq as vq_train
    cfg = replace(vq_config("VQ-8"), ch=32, z_channels=64, codebook_size=64,
                  codebook_embed_dim=4)
    loss_cfg = vq_train.VQLossConfig(disc_start=0, disc_adaptive_weight=True,
                                     image_size=32)
    cpu = torch.device("cpu")
    lp = vq_gan_lpips(cpu)
    x = vq_gan_images(cpu, 0, b=4, size=32)
    out, weights = [], None
    for d in (cpu, dev):
        state, step_fn = vq_train.build_trainer(
            cfg, loss_cfg, d, lpips=copy.deepcopy(lp).to(d), seed=3)
        if weights is None:
            weights = [copy.deepcopy(m.state_dict())
                       for m in (state.model, state.disc)]
        else:  # the CPU's initial weights
            state.model.load_state_dict(weights[0])
            state.disc.load_state_dict(weights[1])
        t0 = time.time()
        state, m = step_fn(state, x.to(d))
        out.append((state, {k: v.item() for k, v in m.items()},
                    time.time() - t0))
    (cs, cm, ct), (gs, gm, gt) = out
    rel, atol = VQ_CPU_BOUNDS["metric"]
    worst_m = max(abs(gm[k] - v) / (abs(v) + atol / rel)
                  for k, v in cm.items())
    grads = {"vq": _vq_grad_check("VQ", gs.model, cs.model,
                                  VQ_CPU_BOUNDS["vq"], 1e-4),
             "disc": _vq_grad_check("discriminator", gs.disc, cs.disc,
                                    VQ_CPU_BOUNDS["disc"], 1e-4)}
    same_ids = torch.equal(gs.usage_window.cpu(), cs.usage_window)
    log(f"VQ-GAN f32 step, card vs CPU (VQ-8 ch 32, 32 px, batch 4, LPIPS, "
        f"PatchGAN, adaptive weight): metrics within {worst_m:.3g} of "
        f"{rel} relative; gradients / parameter updates VQ "
        f"{grads['vq'][0]:.3g} of the largest / {grads['vq'][1]:.3g} lr, "
        f"discriminator {grads['disc'][0]:.3g} / {grads['disc'][1]:.3g} lr; "
        f"ids equal: {same_ids}; card step {gt:.2f} s, CPU {ct:.2f} s")
    if worst_m > 1 or not same_ids:
        raise AssertionError("the card's f32 VQ-GAN step differs from the "
                             "CPU's")
    return grads


def _lpips_files(tmp):
    """Random LPIPS weights written as a torchvision vgg16 state dict
    (`features.{i}`) and the reference's `vgg.pth` heads."""
    from llamagen_tpu_torch.models import lpips
    sd = vq_gan_lpips(torch.device("cpu"), seed=5).state_dict()
    vgg = {f"features.{k.split('.', 3)[2]}.{k.split('.', 3)[3]}": v
           for k, v in sd.items() if k.startswith("net.")}
    assert len(vgg) == 2 * len(lpips.VGG16_CONVS)
    paths = (os.path.join(tmp, "vgg16.pth"), os.path.join(tmp, "vgg.pth"))
    torch.save(vgg, paths[0])
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")},
               paths[1])
    return paths


def run_vq_gan_cli(dev, steps=3, args=()):
    """`python -m llamagen_tpu_torch.cli.train_vq --synthetic-steps 3
    --disc-start 0` at its defaults (VQ-16, 256 px, batch 128, bf16,
    remat; `args` appended) with LPIPS from files, in this process: finite
    metrics, the checkpoint loads into VQModel(cfg, encoder=True)."""
    from llamagen_tpu_torch.cli import train_vq
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.utils.convert import load_torch_state_dict
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        vgg, lins = _lpips_files(tmp)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        state = train_vq.main(["--synthetic-steps", str(steps),
                               "--disc-start", "0", "--log-every", "1",
                               "--vgg-weights", vgg, "--lpips-lins", lins,
                               "--results-dir", tmp, *args])
        torch.cuda.synchronize()
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        cfg = state.model.cfg
        del state
        torch.cuda.empty_cache()
        for line in open(os.path.join(tmp, "log.txt")):
            log(f"  train_vq: {line.rstrip()}")
        recs = [json.loads(line)
                for line in open(os.path.join(tmp, "metrics.jsonl"))]
        recs = [r for r in recs if "gen_loss" in r]
        ckpt = os.path.join(tmp, "checkpoints", f"step_{steps:08d}.pt")
        tok = vq.VQModel(cfg, encoder=True)
        tok.load_state_dict(load_torch_state_dict(ckpt))  # every key
        n = sum(p.numel() for p in tok.parameters())
        ckpt_gb = os.path.getsize(ckpt) / 1e9
        del tok
    torch.cuda.empty_cache()
    log(f"CLI train_vq (defaults: VQ-16 256 px, batch 128, bf16, remat, "
        f"{steps} synthetic steps, LPIPS from files): {secs:.1f} s in all, "
        f"img/s {[round(r['samples_per_sec'], 2) for r in recs]}, peak "
        f"memory {peak:.2f} GiB; checkpoint {ckpt_gb:.2f} GB loads into "
        f"VQModel(encoder=True) ({n / 1e6:.1f}M params)")
    if len(recs) != steps or not all(
            np.isfinite(v) for r in recs for v in r.values()
            if isinstance(v, float)) or recs[-1]["disc_loss"] <= 0:
        raise AssertionError("train_vq's metrics are wrong")
    return {"peak_gib": peak, "img_s": recs[-1]["samples_per_sec"]}


# ---------------------------------------------------------------------------
# Training across ranks: torchrun subprocesses (phases 31-34)
# ---------------------------------------------------------------------------

# one process vs FSDP2 / DDP at one NCCL rank, same seed and batches, bf16:
# bitwise is expected (at one rank FSDP2 gathers and reduce-scatters by
# copying), the bound allows cuBLAS a kernel of another tiling on buffers
# that FSDP2 aligns otherwise: each loss within 1e-3 of it relatively
# (a quarter of a bf16 rounding), grad norms within 1e-2
WORLD1_BOUNDS = {"loss": 1e-3, "grad_norm": 1e-2}
# two gloo ranks sharing the card against one process on the same global
# batch: GPT-L width cut to 4 layers, global batch 16 (8 a rank), f32
# compute with TF32 off, 3 steps; the CPU tests' tolerances (loss and
# grad_norm 1e-5, parameters 1 % of the summed lr) times 10, for cuBLAS's
# other kernels at 8 rows than at 16; the VQ-GAN (VQ-16, 256 px, f32,
# LPIPS, PatchGAN, the adaptive weight and the entropy term): the first
# step's metrics within VQ_CPU_BOUNDS["metric"] and its usage window
# equal, but the adaptive weight (and gen_loss, which it scales) within
# 1e-2: it is the ratio of two gradient norms whose terms cancel through
# the discriminator's BatchNorm (the gradient of a batch mean of
# normalised values), so f32 sums in another order move it by 3.7e-4 on
# the CPU at 64 px (two thread counts, one process) and by 1.3e-3 at two
# ranks
TWO_RANK_LAYERS, TWO_RANK_BATCH, DIST_STEPS = 4, 16, 3
VQ_RATIO_BOUND = {"disc_adaptive_weight": 1e-2, "gen_loss": 1e-2}
TWO_RANK_LR = 1e-4
TWO_RANK_BOUNDS = {"loss": 1e-4, "grad_norm": 1e-4, "param_lr": 0.1}
DIST_VQ_ENTROPY = 0.1  # the entropy term's ratio in the VQ-GAN phases


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run_command(cmd, timeout):
    """(exit code, stdout, stderr) of a subprocess in its own session, run
    from the repo root; its whole group is killed if it outlives
    `timeout` (which then fails the phase)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
    return proc.returncode, out, err


def launch_ranks(nproc, worker, args, timeout=900):
    """`python -m torch.distributed.run --standalone --nproc_per_node nproc
    chip_smoke.py --rank-worker worker args`: every rank's JSON record
    (the file rank{r}.json it writes into `args["dir"]`; the ranks share
    one stdout, where long lines interleave). A launch that fails or
    outlives `timeout` fails the phase; its whole process group is
    killed."""
    rc, out, err = run_command(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), os.path.abspath(__file__),
         "--rank-worker", worker, json.dumps(args)], timeout)
    for line in out.splitlines():  # the ranks' own log lines
        log(f"  [{worker}] {line.strip()}")
    for line in err.splitlines():
        if "resumed" in line or "done at" in line:
            log(f"  [{worker}] {line.strip()}")
    if rc != 0:
        raise RuntimeError(f"{worker} at {nproc} ranks exited "
                           f"{rc}:\n{err[-6000:]}")
    recs = []
    for r in range(nproc):
        with open(os.path.join(args["dir"], f"rank{r}.json")) as f:
            recs.append(json.load(f))
    if [r["rank"] for r in recs] != list(range(nproc)):
        raise AssertionError(f"{worker}: rank records {recs}")
    return recs


def rank_worker(name, args):
    """One rank of a `launch_ranks` call: joins torchrun's process group
    (NCCL, or gloo with `args["backend"]`), runs the worker and writes
    its record to `args["dir"]`/rank{r}.json."""
    from llamagen_tpu_torch.parallel import distributed
    faulthandler.enable()  # a rank that crashes prints where
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.get("device", "cuda"))
    distributed.init_distributed(dev.type, args.get("backend"))
    dev = distributed.local_device(dev)
    rec = {"rank": distributed.rank(), "world": distributed.world_size(),
           "device": str(dev), "backend": torch.distributed.get_backend(),
           **RANK_WORKERS[name](dev, args)}
    with open(os.path.join(args["dir"], f"rank{rec['rank']}.json"),
              "w") as f:
        json.dump(rec, f)
    distributed.shutdown()


def _free():
    """Return the memory of what the caller deleted to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def world1_worker(dev, args):
    """Phases 31-33 at one NCCL rank: the c2i CLI under FSDP2 (--fsdp 1),
    its DCP checkpoint resumed for one step; t2i training under FSDP2;
    the VQ-GAN under DP, with its one-process run in this process."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.parallel.mesh import make_mesh
    from llamagen_tpu_torch.train import vq as vq_train
    out = {}
    c2i_dir = os.path.join(args["dir"], "c2i")
    launches, st = run_train_cli(dev, "full", TRAIN_STEPS, ["--fsdp", "1"],
                                 c2i_dir, "FSDP2 c2i CLI at one rank")
    ckpts = os.path.join(c2i_dir, "checkpoints")
    export = os.path.join(ckpts, f"step_{TRAIN_STEPS:08d}_model.pt")
    out["c2i"] = {**st, "launches": launches, "export": export,
                  "dcp_gb": path_gb(os.path.join(
                      ckpts, f"step_{TRAIN_STEPS:08d}")),
                  "export_gb": path_gb(export)}
    _free()
    from llamagen_tpu_torch.cli import train_c2i
    for f in k4_kernels():
        f.launches = 0
    t0 = time.time()
    state = train_c2i.main([
        "--gpt-model", "GPT-L", "--image-size", "384",
        "--global-batch-size", str(TRAIN_BATCH), "--log-every", "1",
        "--synthetic-steps", str(TRAIN_STEPS + 1), "--resume", ckpts,
        "--results-dir", os.path.join(args["dir"], "c2i_resume"),
        "--fsdp", "1", "--device", "cuda"])
    recs = [json.loads(line) for line in open(os.path.join(
        args["dir"], "c2i_resume", "metrics.jsonl")) if '"loss"' in line]
    out["resume"] = {"step": state.step, "s": time.time() - t0,
                     "losses": [r["loss"] for r in recs],
                     "launches": {f.__name__: f.launches
                                  for f in k4_kernels()}}
    del state
    _free()
    mesh = make_mesh(1, 1, 1, "cuda")
    launches, st = run_t2i_train(dev, DIST_STEPS, mesh,
                                 "FSDP2 t2i training at one rank")
    out["t2i"] = {**st, "launches": launches}
    _free()
    cfg = vq_config("VQ-16", entropy_loss_ratio=DIST_VQ_ENTROPY)
    loss_cfg = vq_train.VQLossConfig(disc_start=0, disc_adaptive_weight=True,
                                     image_size=256)
    label = "VQ-GAN (VQ-16 256 px, PatchGAN, adaptive weight, entropy 0.1)"
    out["vq_one"] = vq_gan_run(dev, f"{label}, one process", cfg, loss_cfg,
                               DIST_STEPS)
    out["vq"] = vq_gan_run(dev, f"{label}, DP at one rank", cfg, loss_cfg,
                           DIST_STEPS, mesh=make_mesh(-1, 1, 1, "cuda"))
    return out


def two_rank_setup(dev, mesh):
    """The trainer of `two_rank_c2i` (GPT-L width cut to TWO_RANK_LAYERS
    layers, f32 compute, full remat, dropout off, a random head built on
    the CPU; this rank's TP shard where the mesh's tp > 1) and its
    DIST_STEPS global batches of TWO_RANK_BATCH rows."""
    from llamagen_tpu_torch.config import gpt_config, replace
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.train import c2i
    cfg = replace(gpt_config("GPT-L", block_size=TOKENS, cls_token_num=1,
                             class_dropout_prob=0.0, token_dropout_p=0.0,
                             resid_dropout_p=0.0, ffn_dropout_p=0.0),
                  n_layer=TWO_RANK_LAYERS)
    g = torch.Generator().manual_seed(61)
    init = gpt.init_weights(gpt.Transformer(cfg), seed=0)
    with torch.no_grad():
        init.output.weight.normal_(0, 0.02, generator=g)
    state, step = c2i.build_trainer(
        cfg, dev, lr=TWO_RANK_LR, warmup_steps=1, ema_decay=0.9,
        compute_dtype=torch.float32, remat="full", mesh=mesh,
        weights=init.state_dict())
    del init
    batches = [c2i.Batch(
        torch.randint(0, 1000, (TWO_RANK_BATCH,), generator=g),
        torch.randint(0, 16384, (TWO_RANK_BATCH, TOKENS), generator=g))
        for _ in range(DIST_STEPS)]
    return state, step, batches


def two_rank_step(dev, mesh, state, step, batch):
    """One step on this rank's rows of `batch`: (loss, grad norm, s)."""
    from llamagen_tpu_torch.parallel.mesh import shard_batch
    from llamagen_tpu_torch.train import c2i
    t0 = time.time()
    if mesh is not None:
        batch = shard_batch(batch, mesh=mesh)
    state, m = step(state, c2i.Batch(batch.labels.to(dev),
                                     batch.tokens.to(dev)), 0)
    loss = m["loss"].item()  # waits for the step
    return loss, m["grad_norm"].item(), time.time() - t0


def two_rank_c2i(dev, mesh, path=None, steps=DIST_STEPS, ckpt=None):
    """`steps` steps of `two_rank_setup`'s trainer (this rank's rows with
    a mesh): losses, grad norms, K4 launches; the whole parameters (TP
    shards gathered) saved to `path` (rank 0). `ckpt` (dir, file): a
    checkpoint of the step-2 state saved into dir (`save_step`: a `.pt`
    in one process, else DCP; its seconds and GB), and the state made
    whole written to file (`whole_state_cpu`, rank 0) for the resumes to
    hold their loads against."""
    from llamagen_tpu_torch.utils import checkpoint
    state, step, batches = two_rank_setup(dev, mesh)
    for f in k4_kernels():
        f.launches = 0
    out = {"loss": [], "grad_norm": [], "step_s": []}
    for i, batch in enumerate(batches[:steps]):
        loss, norm, s = two_rank_step(dev, mesh, state, step, batch)
        out["loss"].append(loss)
        out["grad_norm"].append(norm)
        out["step_s"].append(s)
        log(f"c2i {'one process' if mesh is None else mesh} step {i}: "
            f"loss {loss:.6f}, {s:.3f} s")
        if ckpt is not None and state.step == 2:
            torch.cuda.synchronize()
            t0 = time.time()
            saved = checkpoint.save_step(ckpt[0], state.step, state)
            out["save_s"] = time.time() - t0
            out["ckpt_gb"] = path_gb(saved)
            whole = whole_state_cpu(state)
            if mesh is None or torch.distributed.get_rank() == 0:
                torch.save(whole, ckpt[1])
            del whole
    out["launches"] = {f.__name__: f.launches for f in k4_kernels()}
    if mesh is None:
        out["params"] = {k: v.detach().cpu()
                         for k, v in state.model.state_dict().items()}
    elif path is not None:
        full = whole_params_on_cpu(state.model)
        if state.model.tp_size > 1:
            from llamagen_tpu_torch.parallel.tp_decode import whole_tp_state
            full = whole_tp_state(state.model, full)
        if torch.distributed.get_rank() == 0:
            torch.save(full, path)
        del full
    del state
    _free()
    return out


def _whole_cpu(t):
    """A tensor whole on the CPU: an FSDP2 DTensor's dim-0 shards
    (`torch.chunk` sizes) gathered as CPU tensors over its mesh's group
    (see `whole_params_on_cpu`)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t.detach().cpu()
    group = t.device_mesh.get_group()
    size = torch.distributed.get_world_size(group)
    local = t.to_local().detach().cpu()
    rows = -(-t.shape[0] // size)
    padded = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype)
    padded[:local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in range(size)]
    torch.distributed.all_gather(parts, padded, group=group)
    return torch.cat(parts)[:t.shape[0]]


def whole_state_cpu(state):
    """A GPT train state made whole on the CPU, on every rank: the
    parameters, both Adam moments and the EMA by name (FSDP2 rows
    gathered over the fsdp group, TP shards by `whole_tp_state`, wqkv in
    [Q | K | V]) and the step."""
    from llamagen_tpu_torch.parallel.tp_decode import whole_tp_state
    model = state.model

    def whole(d):
        d = {n: _whole_cpu(t) for n, t in d.items()}
        if model.tp_size > 1:
            d = whole_tp_state(model, d)
        return d

    name = {id(p): n for n, p in model.named_parameters()}
    opt = state.optimizer.opt.state
    return {"params": whole(dict(model.named_parameters())),
            "ema": whole(state.ema),
            **{k: whole({name[id(p)]: s[k] for p, s in opt.items()})
               for k in ("exp_avg", "exp_avg_sq")},
            "step": state.step}


def resume_c2i(dev, mesh, ckpt_dir, saved_path, unbroken):
    """Phase 48 at one layout: `two_rank_setup`'s trainer at `mesh` (one
    process for None) resumes `ckpt_dir` (the seconds of the load); the
    loaded state made whole against `saved_path` bit for bit (parameters,
    both Adam moments, EMA, step); then step 3 (the third global batch)
    with the K4 counters set to 0 just before it: loss and grad norm
    against `unbroken` (the unbroken run's step-3 values), K4 launches."""
    from llamagen_tpu_torch.utils import checkpoint
    state, step, batches = two_rank_setup(dev, mesh)
    torch.cuda.synchronize()
    t0 = time.time()
    got, state = checkpoint.restore_latest(ckpt_dir, state, log=log)
    torch.cuda.synchronize()
    out = {"load_s": time.time() - t0, "step_loaded": got}
    loaded = whole_state_cpu(state)
    saved = torch.load(saved_path, weights_only=True)
    out["unequal"] = [] if loaded["step"] == saved["step"] else ["step"]
    for key in ("params", "exp_avg", "exp_avg_sq", "ema"):
        if loaded[key].keys() != saved[key].keys():
            out["unequal"].append(f"{key} names")
            continue
        out["unequal"] += [f"{key} {n}" for n, t in saved[key].items()
                           if not torch.equal(loaded[key][n], t)]
    del loaded, saved
    for f in k4_kernels():
        f.launches = 0
    loss, norm, s = two_rank_step(dev, mesh, state, step, batches[2])
    out.update(loss=loss, grad_norm=norm, step_s=s,
               launches={f.__name__: f.launches for f in k4_kernels()},
               rel={"loss": abs(loss / unbroken["loss"] - 1),
                    "grad_norm": abs(norm / unbroken["grad_norm"] - 1)})
    log(f"resumed at {'one process' if mesh is None else mesh}: load "
        f"{out['load_s']:.2f} s, unequal after the load "
        f"{out['unequal'][:4]}, step 3 loss {loss:.6f} (unbroken "
        f"{unbroken['loss']:.6f}), K4 {out['launches']}")
    del state
    _free()
    return out


def whole_params_on_cpu(model):
    """Every parameter whole on every rank, as CPU tensors (`_whole_cpu`).
    Over gloo, DTensor's own gather of CUDA shards (`full_tensor`,
    `get_model_state_dict(full_state_dict=True)`) crashes the process
    (SIGSEGV in its functional all-gather, torch 2.11)."""
    return {name: _whole_cpu(p) for name, p in model.named_parameters()}


def two_rank_vq(dev, mesh):
    """One VQ-16 VQ-GAN run of DIST_STEPS steps at 256 px, f32 compute,
    global batch TWO_RANK_BATCH (this rank's rows with a mesh): the
    metrics and a digest of the usage window after each step."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.parallel.mesh import shard_batch
    from llamagen_tpu_torch.train import vq as vq_train
    cfg = vq_config("VQ-16", entropy_loss_ratio=DIST_VQ_ENTROPY)
    loss_cfg = vq_train.VQLossConfig(disc_start=0, disc_adaptive_weight=True,
                                     image_size=256)
    state, step = vq_train.build_trainer(
        cfg, loss_cfg, dev, use_ema=True, lpips=vq_gan_lpips(dev),
        compute_dtype=torch.float32, remat=True, mesh=mesh)
    out = {"metrics": [], "window": [], "step_s": []}
    for i in range(DIST_STEPS):
        imgs = vq_gan_images(dev, 40 + i, TWO_RANK_BATCH)
        t0 = time.time()
        state, m = step(state, imgs if mesh is None else shard_batch(imgs))
        out["metrics"].append({k: v.item() for k, v in m.items()})
        out["step_s"].append(time.time() - t0)
        log(f"VQ-GAN {'one process' if mesh is None else mesh} step {i}: "
            f"gen_loss {out['metrics'][-1]['gen_loss']:.6f}, "
            f"{out['step_s'][-1]:.3f} s")
        out["window"].append(hashlib.sha1(
            state.usage_window.cpu().numpy().tobytes()).hexdigest())
    del state
    _free()
    return out


def two_rank_worker(dev, args):
    """Phase 34, one of two gloo ranks on the one card: c2i under FSDP2
    (--fsdp 2) and under DDP (--dp 2), then the VQ-GAN under DP."""
    from llamagen_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for name, dp, fsdp in (("fsdp2", 1, 2), ("dp2", 2, 1)):
        out[name] = two_rank_c2i(dev, make_mesh(dp, fsdp, 1, dev.type),
                                 os.path.join(args["dir"], f"{name}.pt"))
    out["vq"] = two_rank_vq(dev, make_mesh(-1, 1, 1, dev.type))
    return out


RANK_WORKERS = {"world1": world1_worker, "two_ranks": two_rank_worker}


def _rel(a, b):
    return max(abs(x / y - 1) for x, y in zip(a, b))


def _check_world1(label, got, ref):
    """Per-step losses and grad norms of a one-rank run against the
    one-process run's (WORLD1_BOUNDS)."""
    errs = {"loss": _rel(got["losses"], ref["losses"]),
            "grad_norm": _rel(got["grad_norms"], ref["grad_norms"])}
    same = got["losses"] == ref["losses"][:len(got["losses"])]
    log(f"{label}: losses {'bitwise equal to' if same else 'within'} the "
        f"one-process run's (max relative differences: loss "
        f"{errs['loss']:.3g}, grad norm {errs['grad_norm']:.3g}); step "
        f"{got['step_s']:.4f} s against {ref['step_s']:.4f} s "
        f"({100 * (got['step_s'] / ref['step_s'] - 1):+.2f} %), peak "
        f"{got['peak_gib']:.2f} GiB against {ref['peak_gib']:.2f}")
    for k, bound in WORLD1_BOUNDS.items():
        if errs[k] > bound:
            raise AssertionError(f"{label}: {k} differs by {errs[k]:.3g} "
                                 f"(bound {bound})")
    return {**errs, "bitwise": same,
            "gap": got["step_s"] / ref["step_s"] - 1}


def run_world1(dev, c2i_ref, t2i_ref):
    """Phases 31-33: `world1_worker` through torchrun at one NCCL rank,
    held against the one-process phases 11 (c2i CLI) and 25 (t2i) and the
    VQ-GAN run of the same process; the c2i DCP resume and the rank-0
    whole-model export through `load_gpt`."""
    from llamagen_tpu_torch.cli.common import load_gpt
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        (rec,) = launch_ranks(1, "world1", {"dir": tmp})
        log(f"world-1 launch: {time.time() - t0:.1f} s in all, on "
            f"{rec['device']} over {rec['backend']}")
        c2i, t2i = rec["c2i"], rec["t2i"]
        out = {"c2i": _check_world1("FSDP2 c2i CLI at one rank", c2i,
                                    c2i_ref),
               "t2i": _check_world1("FSDP2 t2i training at one rank", t2i,
                                    {k: (v[:DIST_STEPS] if k in (
                                        "losses", "grad_norms") else v)
                                     for k, v in t2i_ref.items()})}
        res = rec["resume"]
        n_layer = 24
        want = {"train_attention_fwd": 2 * n_layer,
                "train_attention_dq": n_layer,
                "train_attention_dkdv": n_layer}
        log(f"DCP checkpoint {c2i['dcp_gb']:.2f} GB, whole-model export "
            f"{c2i['export_gb']:.2f} GB; resumed run: step {res['step']}, "
            f"loss {res['losses']}, {res['s']:.1f} s, K4 {res['launches']}")
        if res["step"] != TRAIN_STEPS + 1 or len(res["losses"]) != 1 \
                or not np.isfinite(res["losses"][0]) \
                or res["launches"] != want:
            raise AssertionError(f"the DCP resume: {res}")
        model = load_gpt(c2i["export"], "GPT-L", 384, 16, torch.float32, dev)
        n = sum(p.numel() for p in model.parameters())
        finite = all(torch.isfinite(p).all() for p in model.parameters())
        log(f"load_gpt(whole-model export): {n / 1e6:.1f}M parameters, "
            f"finite {finite}")
        if not finite or abs(n - 342.9e6) > 0.1e6:
            raise AssertionError("the export did not load as GPT-L")
        del model
        _free()
    one, dp = rec["vq_one"], rec["vq"]
    errs = {k: abs(dp["metrics"][0][k] / one["metrics"][0][k] - 1)
            for k in ("gen_loss", "rec_loss", "vq_loss", "commit_loss",
                      "entropy_loss", "disc_loss")}
    log(f"VQ-GAN DP at one rank vs one process, first step: relative "
        f"differences {', '.join(f'{k} {v:.3g}' for k, v in errs.items())};"
        f" step {dp['step_s']:.4f} s against {one['step_s']:.4f} s "
        f"({100 * (dp['step_s'] / one['step_s'] - 1):+.2f} %), peak "
        f"{dp['peak_gib']:.2f} GiB against {one['peak_gib']:.2f}")
    if max(errs.values()) > WORLD1_BOUNDS["grad_norm"]:
        raise AssertionError(f"VQ-GAN at one rank: {errs}")
    if dp["metrics"][0]["entropy_loss"] == 0 or \
            not 0 < dp["metrics"][0]["disc_adaptive_weight"] < 1e4:
        raise AssertionError("VQ-GAN: the entropy term or the adaptive "
                             "weight is not live")
    out["vq"] = {"gap": dp["step_s"] / one["step_s"] - 1, **errs}
    return {**out, "launches": {"c2i": c2i["launches"],
                                "t2i": t2i["launches"]}}


def run_two_ranks(dev):
    """Phase 34: two gloo ranks on the one card (CUDA tensors), each
    launching K4 on its own rows, against one process on the same global
    batch (TWO_RANK_BOUNDS)."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        recs = launch_ranks(2, "two_ranks", {"dir": tmp, "backend": "gloo"})
        log(f"two-rank launch: {time.time() - t0:.1f} s")
        return check_two_ranks(dev, recs, tmp)


def check_two_ranks(dev, recs, tmp):
    """The two ranks' records (and their parameters in `tmp`) against one
    process's runs on `dev`."""
    ref = two_rank_c2i(dev, None)
    want = {"train_attention_fwd": 2 * TWO_RANK_LAYERS * DIST_STEPS,
            "train_attention_dq": TWO_RANK_LAYERS * DIST_STEPS,
            "train_attention_dkdv": TWO_RANK_LAYERS * DIST_STEPS}
    lr_sum = TWO_RANK_LR * (DIST_STEPS - 1)  # warmup 1: lr 0, lr, lr
    out = {}
    for name in ("fsdp2", "dp2"):
        params = torch.load(os.path.join(tmp, f"{name}.pt"),
                            weights_only=True)
        perr = max((params[k] - v).abs().max().item()
                   for k, v in ref["params"].items())
        del params
        errs = {"loss": max(_rel(r[name]["loss"], ref["loss"])
                            for r in recs),
                "grad_norm": max(_rel(r[name]["grad_norm"],
                                      ref["grad_norm"]) for r in recs),
                "param_lr": perr / lr_sum}
        log(f"two gloo ranks, c2i {name} (GPT-L width, "
            f"{TWO_RANK_LAYERS} layers, global batch {TWO_RANK_BATCH}, "
            f"f32): losses {[round(x, 6) for x in recs[0][name]['loss']]}"
            f" against {[round(x, 6) for x in ref['loss']]}; max "
            f"relative differences loss {errs['loss']:.3g}, grad norm "
            f"{errs['grad_norm']:.3g}; parameters within "
            f"{errs['param_lr']:.3g} of the summed lr; last step "
            f"{max(r[name]['step_s'][-1] for r in recs):.3f} s (slower "
            f"rank) against one process's {ref['step_s'][-1]:.3f} s; "
            f"K4 per rank {[r[name]['launches'] for r in recs]}")
        for r in recs:
            if r[name]["launches"] != want:
                raise AssertionError(f"{name} rank {r['rank']}: K4 "
                                     f"{r[name]['launches']}, want {want}")
        for k, bound in TWO_RANK_BOUNDS.items():
            if errs[k] > bound:
                raise AssertionError(f"two ranks {name}: {k} "
                                     f"{errs[k]:.3g} > {bound}")
        out[name] = errs
    del ref
    _free()
    vref = two_rank_vq(dev, None)
    rel, abs_ = VQ_CPU_BOUNDS["metric"]
    for r in recs:
        got = r["vq"]
        # each metric's difference as a share of its bound
        errs = {k: abs(got["metrics"][0][k] - v)
                / (VQ_RATIO_BOUND.get(k, rel) * abs(v) + abs_)
                for k, v in vref["metrics"][0].items()}
        worst = max(errs, key=errs.get)
        log(f"two gloo ranks, VQ-GAN rank {r['rank']}: first step's worst "
            f"metric {worst} at {errs[worst]:.3g} of its bound; "
            f"usage windows equal after step 1: "
            f"{got['window'][0] == vref['window'][0]}; later gen_loss "
            f"{[round(m['gen_loss'], 5) for m in got['metrics']]} against "
            f"{[round(m['gen_loss'], 5) for m in vref['metrics']]}; last "
            f"step {got['step_s'][-1]:.3f} s against one process's "
            f"{vref['step_s'][-1]:.3f} s")
        if errs[worst] > 1:
            raise AssertionError(f"two-rank VQ-GAN {worst}: "
                                 f"{got['metrics'][0][worst]} vs "
                                 f"{vref['metrics'][0][worst]}")
        if got["window"][0] != vref["window"][0]:
            raise AssertionError("two-rank VQ-GAN: the usage window differs")
    return out


# ---------------------------------------------------------------------------
# Phases 38-42: evaluation and the baseline tokenizers
# ---------------------------------------------------------------------------

# the JAX CLI docstring's cfg; one block of samples (the smoke's clock)
FID_BATCH, FID_SAMPLES, FID_CFG = 32, 32, 2.0
FID_PROMPTS = ["an owl", "a red double-decker bus in the rain",
               "two dogs asleep on an old sofa next to a reading lamp, oil "
               "painting",
               "a lighthouse on a cliff above a stormy sea at dusk, seen "
               "from a fishing boat, wide shot, dramatic light"]
TAMING_NAME = "vqgan_imagenet_f16_16384"
BASELINE_IMAGES = 8


def kernel_wrappers():
    """Every kernel wrapper of the port, by its counter's name."""
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.chunk_attention import chunk_decode_attention
    from llamagen_tpu_torch.ops.quant_matmul import int8_matmul
    from llamagen_tpu_torch.ops.w4_matmul import w4_matmul
    fns = (decode_attention, int8_matmul, w4_matmul, chunk_decode_attention,
           *k4_kernels())
    return {f.__name__: f for f in fns}


def zero_counters():
    for f in kernel_wrappers().values():
        f.launches = 0


def read_counters():
    return {name: f.launches for name, f in kernel_wrappers().items()}


def check_only_k1(label, counts, want):
    """K1 exactly `want` launches, every other kernel none."""
    others = {k: v for k, v in counts.items() if k != "decode_attention"}
    log(f"{label}: launches {counts}")
    if counts["decode_attention"] != want or any(others.values()):
        raise AssertionError(f"{label}: launches {counts}, expected "
                             f"decode_attention {want} and no other kernel")


def run_inception(dev):
    """Phase 38: InceptionV3 (pytorch-fid keys, random weights, loaded from
    a saved .pth) at full width: pool3 / spatial / logits of 4 images of
    256 px within 1e-4 of each output's largest |value| of the CPU port
    (f32, TF32 off); then img/s over 256 images at batch 64."""
    from llamagen_tpu_torch.eval import inception
    cpu = inception.FeatureExtractor(None, batch_size=4, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pt_inception.pth")
        torch.save({k: v for k, v in cpu.model.state_dict().items()
                    if "num_batches_tracked" not in k}, path)
        card = inception.FeatureExtractor(path, batch_size=64, device=dev)
    rng = np.random.RandomState(38)
    imgs = rng.randint(0, 256, (4, 256, 256, 3), np.uint8)
    for name, a, b in zip(("pool3", "spatial", "logits"),
                          card.features(imgs), cpu.features(imgs)):
        rel = np.abs(a - b).max() / np.abs(b).max()
        log(f"Inception {name} {a.shape}: card vs CPU {rel:.3g} of the "
            f"largest |value| (tol 1e-4)")
        if not (a.shape == b.shape and rel <= 1e-4):
            raise AssertionError(f"Inception {name} disagrees with the CPU")
    many = rng.randint(0, 256, (256, 256, 256, 3), np.uint8)
    card.features(many[:64])  # warm up (cuDNN's algorithms, the allocator)
    t0 = time.time()
    feats = card.features(many)
    secs = time.time() - t0
    if feats[0].shape != (256, 2048) or not np.isfinite(feats[0]).all():
        raise AssertionError("Inception pool3 is not finite [256, 2048]")
    log(f"Inception (f32, TF32 off, batch 64, 256 px -> 299): 256 images "
        f"in {secs:.3f} s = {256 / secs:.1f} img/s")
    return 256 / secs


def run_fid_sampler(dev, tmp):
    """Phase 39: `cli/sample_c2i_fid.py` at GPT-L 384 -> 256 px, bf16
    weights and cache, 32 labels a block, cfg 2.0, FID_SAMPLES samples
    from a random checkpoint: K1 exactly 24 * 575 launches a block and no
    other kernel, a [FID_SAMPLES, 256, 256, 3] uint8 .npy, img/s and ms
    per step. Then the same CLI under `torch.distributed.run
    --nproc_per_node 1` with 32 samples: its rows equal the first 32.
    Then one block at seed 1, the reference batch of phase 40."""
    from llamagen_tpu_torch.cli import sample_c2i_fid as fid_cli
    ckpt = os.path.join(tmp, "gpt_l_384.pt")
    torch.save(gpt_model(dev, seed=39).state_dict(), ckpt)
    args = ["--gpt-model", "GPT-L", "--gpt-ckpt", ckpt, "--image-size",
            "384", "--image-size-eval", "256", "--cfg-scale", str(FID_CFG),
            "--per-device-batch-size", str(FID_BATCH), "--device", "cuda"]
    gen_secs = []
    generate = fid_cli.generate

    def timed(*a, **kw):  # the sampling loop alone, device synchronised
        torch.cuda.synchronize()
        t = time.time()
        out = generate(*a, **kw)
        torch.cuda.synchronize()
        gen_secs.append(time.time() - t)
        return out

    fid_cli.generate = timed
    zero_counters()
    try:
        res = fid_cli.main(args + ["--num-samples", str(FID_SAMPLES),
                                   "--sample-dir", os.path.join(tmp, "c2i")])
    finally:
        fid_cli.generate = generate
    blocks = FID_SAMPLES // FID_BATCH
    check_only_k1("FID sampler", read_counters(), blocks * 24 * (TOKENS - 1))
    launches = read_counters()["decode_attention"]
    rows = np.load(res.path)
    if rows.shape != (FID_SAMPLES, 256, 256, 3) or rows.dtype != np.uint8 \
            or res.written != FID_SAMPLES or rows.std() == 0:
        raise AssertionError(f"FID sampler wrote {rows.shape} {rows.dtype}")
    ms_step = 1e3 * sum(gen_secs) / (len(gen_secs) * TOKENS)
    log(f"FID sampler CLI (GPT-L 384 -> 256, bf16, {FID_BATCH} labels + "
        f"CFG {FID_CFG} a block, {blocks} blocks): {res.seconds:.3f} s = "
        f"{FID_SAMPLES / res.seconds:.3f} img/s; sampling "
        f"{sum(gen_secs):.3f} s, {ms_step:.3f} ms per step; VQ decode + "
        f"resize + write {res.seconds - sum(gen_secs):.3f} s")

    t0 = time.time()
    rc, out, err = run_command(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m",
         "llamagen_tpu_torch.cli.sample_c2i_fid", *args, "--num-samples",
         str(FID_BATCH), "--sample-dir", os.path.join(tmp, "torchrun")],
        timeout=600)
    if rc != 0:
        raise RuntimeError(f"the FID sampler under torchrun exited {rc}:\n"
                           f"{err[-6000:]}")
    one_rank = np.load(os.path.join(tmp, "torchrun",
                                    os.path.basename(res.path)))
    same = np.array_equal(one_rank, rows[:FID_BATCH])
    log(f"FID sampler under torchrun at one rank ({FID_BATCH} samples, "
        f"{time.time() - t0:.1f} s with the launch): rows equal the "
        f"one-process run's first {FID_BATCH}: {same}; "
        f"{out.strip().splitlines()[-1]}")
    if not same:
        raise AssertionError("the one-rank rows differ from one process's")

    ref = fid_cli.main(args + ["--num-samples", str(FID_BATCH), "--seed",
                               "1", "--sample-dir", os.path.join(tmp, "ref")])
    return {"launches": launches, "path": res.path, "ref": ref.path,
            "img_s": FID_SAMPLES / res.seconds, "ms_step": ms_step}


def run_evaluate(dev, samples):
    """Phase 40: `cli/evaluate.py` (random Inception) on phase 39's batch
    against the seed-1 block: the five metrics finite, seconds per part."""
    from llamagen_tpu_torch.cli import evaluate
    t0 = time.time()
    res = evaluate.main([samples["ref"], samples["path"], "--device",
                         "cuda"])
    log(f"evaluate CLI ({FID_BATCH} reference and {FID_SAMPLES} sample "
        f"images, random Inception): {res.metrics}; seconds "
        f"{ {k: round(v, 3) for k, v in res.seconds.items()} }, whole CLI "
        f"{time.time() - t0:.3f}")
    if len(res.metrics) != 5 or not all(np.isfinite(v)
                                        for v in res.metrics.values()):
        raise AssertionError(f"evaluate metrics {res.metrics}")
    return res


class ClipStubTokenizer:
    """Token ids from each caption's crc32 in CLIP's vocabulary, ending
    with the end-of-text id 49407 (the highest), then padding: what
    `ClipScorer` asks of a tokenizer, without tokenizer files."""

    def __call__(self, texts, max_length=77, **kw):
        import zlib
        ids = np.full((len(texts), max_length), 49407, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            n = min(len(t.split()) + 2, max_length)
            ids[i, 0] = 49406
            ids[i, 1:n - 1] = np.random.RandomState(
                zlib.crc32(t.encode())).randint(1, 49406, size=(n - 2,))
            mask[i, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}


def run_t2i_fid(dev, tmp, ref_path):
    """Phase 41: `cli/sample_t2i_fid.py` at GPT-XL 256 px (random
    checkpoint, --random-t5, 4 prompts of 2 to 21 words in one batch, cfg
    7.5, top-k 1000): K1 exactly 36 * 255 launches a batch (`prefix_pad`)
    and no other kernel, `result.jsonl` and the PNGs. Then `ClipScorer` at
    ViT-B/32 width (random, the stub tokenizer) on those images and
    `cli/evaluate_t2i.py`'s FID against phase 39's reference batch."""
    from llamagen_tpu_torch.cli import evaluate_t2i, sample_t2i_fid
    from llamagen_tpu_torch.eval import clip
    ckpt = os.path.join(tmp, "gpt_xl_t2i_256.pt")
    torch.save(t2i_model(dev, 256, seed=41).state_dict(), ckpt)
    prompts = os.path.join(tmp, "prompts.jsonl")
    with open(prompts, "w") as f:
        for p in FID_PROMPTS:
            f.write(json.dumps({"caption": p}) + "\n")
    out = os.path.join(tmp, "t2i")
    zero_counters()
    res = sample_t2i_fid.main([
        "--prompt-file", prompts, "--gpt-model", "GPT-XL", "--gpt-ckpt",
        ckpt, "--image-size", "256", "--random-t5", "--cfg-scale",
        str(T2I_CFG), "--top-k", str(T2I_TOP_K), "--per-proc-batch-size",
        str(len(FID_PROMPTS)), "--sample-dir", out, "--device", "cuda"])
    check_only_k1("t2i FID sampler", read_counters(), 36 * 255)
    launches = read_counters()["decode_attention"]
    result = os.path.join(out, "result.jsonl")
    images, captions = evaluate_t2i.load_result_jsonl(result)
    if images.shape != (4, 256, 256, 3) or captions != FID_PROMPTS:
        raise AssertionError(f"t2i FID sampler wrote {images.shape}")
    log(f"t2i FID sampler CLI (GPT-XL 256, bf16, 4 prompts + CFG {T2I_CFG}, "
        f"top-k {T2I_TOP_K}): sampling {res.gen_seconds:.3f} s "
        f"({1e3 * res.gen_seconds / 256:.3f} ms per step), whole loop "
        f"{res.seconds:.3f} s = {4 / res.seconds:.3f} img/s")

    model = clip.init_weights(clip.CLIPModel())
    scorer = clip.ClipScorer(model=model, tokenizer=ClipStubTokenizer(),
                             device=dev)
    scorer.pair_scores(images, captions)  # warm up
    torch.cuda.synchronize()
    t0 = time.time()
    scores = scorer.pair_scores(images, captions)
    clip_secs = time.time() - t0
    cos = scorer.cosines(images, captions)
    log(f"CLIP score (ViT-B/32 width, random, f32): cosines "
        f"{np.round(cos, 4).tolist()}, pair scores (100 * max(cos, 0)) "
        f"{np.round(scores, 4).tolist()} in {clip_secs:.4f} s "
        f"({4 / clip_secs:.1f} pairs/s)")
    if scores.shape != (4,) or not (np.abs(cos) <= 1 + 1e-5).all() \
            or not np.array_equal(scores, 100.0 * np.maximum(cos, 0.0)):
        raise AssertionError(f"CLIP cosines {cos}, pair scores {scores}")
    t0 = time.time()
    ev = evaluate_t2i.main(["--result", result, "--ref-batch", ref_path,
                            "--device", "cuda"])
    log(f"evaluate_t2i (FID against {FID_BATCH} reference images, random "
        f"Inception): {ev} in {time.time() - t0:.3f} s")
    if not np.isfinite(ev["FID"]):
        raise AssertionError(f"evaluate_t2i {ev}")
    return {"launches": launches, "clip_s": clip_secs}


def taming_layout(sd, n):
    """The port's VQ keys -> taming's: `conv_blocks.{i}` -> encoder
    `down.{i}` / decoder `up.{n - 1 - i}`, `res` -> `block`, `mid.0/1/2`
    -> `mid.block_1/attn_1/block_2`."""
    import re
    out = {}
    for k, v in sd.items():
        for part in ("encoder", "decoder"):
            for src, dst in (("0", "block_1"), ("1", "attn_1"),
                             ("2", "block_2")):
                k = k.replace(f"{part}.mid.{src}.", f"{part}.mid.{dst}.")
        k = re.sub(r"encoder\.conv_blocks\.(\d+)\.res\.",
                   r"encoder.down.\1.block.", k)
        k = re.sub(r"encoder\.conv_blocks\.(\d+)\.", r"encoder.down.\1.", k)
        m = re.match(r"decoder\.conv_blocks\.(\d+)\.(res|attn|upsample)\.(.*)",
                     k)
        if m:
            kind = "block" if m.group(2) == "res" else m.group(2)
            k = f"decoder.up.{n - 1 - int(m.group(1))}.{kind}.{m.group(3)}"
        out[k] = v
    return out


def run_baselines(dev, tmp):
    """Phase 42: `cli/reconstruction_baseline.py` with the backends sd-vae
    (f8, ch 128), taming (f16, 16384 codes of 256) and cd (base 320, mult
    1, 1, 2, 3, 4, the sd-vae encoder) on 8 images of 256 px, from random
    checkpoints in their published layouts (LDM, taming, ConvUNetVAE):
    PSNR / SSIM and seconds per image each; sd-vae's and taming's
    roundtrips of 1 image within 1e-4 of the largest |value| of the CPU
    port's (f32, TF32 off)."""
    from PIL import Image

    from llamagen_tpu_torch.cli import reconstruction_baseline as rb
    from llamagen_tpu_torch.models import consistency_decoder as cdm
    from llamagen_tpu_torch.models import klvae, vq
    from llamagen_tpu_torch.utils import convert
    data = os.path.join(tmp, "val", "cls")
    os.makedirs(data)
    rng = np.random.RandomState(42)
    for i in range(BASELINE_IMAGES):  # smooth random images
        low = rng.randint(0, 256, (16, 16, 3), np.uint8)
        Image.fromarray(low).resize((256, 256), Image.BICUBIC).save(
            os.path.join(data, f"{i}.png"))
    vae_ckpt = os.path.join(tmp, "sd_vae.ckpt")
    torch.save({"state_dict": klvae.init_weights(
        klvae.AutoencoderKL()).state_dict()}, vae_ckpt)
    tcfg = convert.taming_vq_config(TAMING_NAME)
    taming = vq.init_weights(vq.VQModel(tcfg, encoder=True))
    with torch.no_grad():  # codes at the latents' scale (no near ties)
        taming.quantize.embedding.weight.normal_(
            0.0, 1.0, generator=torch.Generator().manual_seed(42))
    taming_ckpt = os.path.join(tmp, "vqgan_imagenet_f16_16384.ckpt")
    torch.save({"state_dict": taming_layout(taming.state_dict(),
                                            len(tcfg.decoder_ch_mult))},
               taming_ckpt)
    cd_ckpt = os.path.join(tmp, "consistency_decoder.pt")
    torch.save(cdm.init_weights(cdm.ConvUNetVAE()).state_dict(), cd_ckpt)
    del taming

    common = ["--data-path", os.path.join(tmp, "val"), "--image-size", "256",
              "--batch-size", str(BASELINE_IMAGES), "--device", "cuda"]
    results = {}
    for backend, extra in (("sd-vae", ["--ckpt", vae_ckpt]),
                           ("taming", ["--ckpt", taming_ckpt,
                                       "--taming-config", TAMING_NAME]),
                           ("cd", ["--ckpt", cd_ckpt, "--vae-ckpt",
                                   vae_ckpt])):
        t0 = time.time()
        res = rb.main(common + ["--backend", backend] + extra)
        log(f"reconstruction_baseline {backend}: {res['images']} images, "
            f"PSNR {res['psnr']:.4f}, SSIM {res['ssim']:.5f}, "
            f"{res['seconds_per_image']:.4f} s per image in the model; "
            f"whole CLI {time.time() - t0:.3f} s")
        if res["images"] != BASELINE_IMAGES or not (
                np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])):
            raise AssertionError(f"{backend}: {res}")
        results[backend] = res
        _free()

    img = np.array(Image.open(os.path.join(data, "0.png")))
    x = (img.astype(np.float32) / 127.5 - 1.0)[None]
    for backend, make in (
            ("sd-vae", lambda d: rb.sd_vae_roundtrip(vae_ckpt, None, d)),
            ("taming", lambda d: rb.taming_roundtrip(taming_ckpt,
                                                     TAMING_NAME, None, d))):
        card, cpu = make(dev)(x), make("cpu")(x)
        rel = np.abs(card - cpu).max() / np.abs(cpu).max()
        log(f"{backend} roundtrip of 1 image, card vs CPU: {rel:.3g} of the "
            f"largest |value| (tol 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"{backend}: the card's roundtrip differs "
                                 f"from the CPU's")
        _free()
    return results


# ---------------------------------------------------------------------------
# Phases 43-47: tensor parallelism (two or four gloo ranks on the one card)
# ---------------------------------------------------------------------------

# serving: GPT-XXL 384 px (24 heads of 64, ffn 4096), depth cut 48 -> 4 for
# the smoke's clock, tp 2: each rank 12 heads, its [16, S, 1536] int8 cache
TP, TP_MODEL, TP_LAYERS = 2, "GPT-XXL", 4
TP_PAIRS, TP_REQUESTS, TP_CHUNK = 8, 12, 64
# t2i: GPT-XL 256 px (10 heads a rank), depth cut 36 -> 4, 4 captions
# with phase 17's pads, admitted by one prefill (2 x 4 x 120 rows, K2)
TP_T2I_LAYERS, TP_T2I_PAIRS = 4, 4
TP_ADMIT_ROWS = 2 * TP_T2I_PAIRS * T2I_T
# the per-shard W4 engine: 8 requests of TP_W4_TOKENS tokens
TP_W4_TOKENS = 192
# the per-rank matmul shapes (K, N) of GPT-XXL at tp 2, and GPT-XL's wqkv
TP_XXL_MATMULS = {"XXL/2 wqkv": (1536, 2304), "XXL/2 wo": (768, 1536),
                  "XXL/2 w1": (1536, 2048), "XXL/2 w2": (2048, 1536)}
TP_XL_WQKV = {"XL/2 wqkv": (1280, 1920)}
# training: GPT-L width cut to 4 layers, global batch 16 (every rank of the
# TP group holds the 16 rows), 8 heads a rank: K4's shape in every layer
TP_TRAIN_SHAPE = (TWO_RANK_BATCH, TOKENS, 8, 64)
TP_TRAIN_MODEL = f"GPT-L-{TWO_RANK_LAYERS}"


def tp_train_model_entry():
    """TP_TRAIN_MODEL in the port's zoo (GPT-L's widths at TWO_RANK_LAYERS
    layers), so that the training CLI takes it by name."""
    from llamagen_tpu_torch import config
    config.GPT_CONFIGS[TP_TRAIN_MODEL] = lambda **kw: config.replace(
        config.gpt_config("GPT-L", **kw), n_layer=TWO_RANK_LAYERS)


def check_tp_kernels(dev):
    """K1, K2, K3 and K4 against their plain versions at the TP ranks'
    shapes (phase 2's tolerances): K1 with int8 and bf16 caches at GPT-XXL
    tp 2's 12 heads (B 16, slot positions) and GPT-XL tp 2's 10 heads with
    the t2i pads; K2 at GPT-XXL tp 2's four shard shapes, B 16, and GPT-XL
    tp 2's wqkv shard at an admission's 960 rows; K3 (per-shard g128)
    at GPT-XXL tp 2's shards, B 16; K4 at GPT-L tp 2's [16, 576, 8, 64].
    Then each one's time beside its plain version, bound and library
    call. Returns (worst errors, times)."""
    from llamagen_tpu_torch.ops.attention import (decode_attention,
                                                  decode_attention_ref)
    from llamagen_tpu_torch.ops import train_attention as ta
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     int8_matmul_ref,
                                                     quantize_weight)
    from llamagen_tpu_torch.ops.w4_matmul import (pack_w4, w4_matmul,
                                                  w4_matmul_ref)
    g = torch.Generator(device=dev).manual_seed(81)
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for i, (cache, h, b, s, t2i) in enumerate(
            [(c, 12, 2 * TP_PAIRS, 640, False) for c in ("int8", "bf16")]
            + [(c, 10, 2 * TP_T2I_PAIRS, 384, True)
               for c in ("int8", "bf16")]):
        q, kv_new, kv, extra = attention_state(dev, b, h, h, s, cache,
                                               200 + i)
        if t2i:
            pos, pad = t2i_rows(dev, b, s, g)
        else:
            pad = None
            pos = torch.randint(0, 577, (b,), generator=g, device=dev,
                                dtype=torch.int32)
            pos[:4] = torch.tensor([0, 31, 32, 576], device=dev)
        kv_ref = kv.clone()
        extra_ref = {k: v.clone() for k, v in extra.items()}
        out = decode_attention(q, kv_new, kv, pos, h, prefix_pad=pad,
                               **extra)
        ref = decode_attention_ref(q, kv_new, kv_ref, pos, h,
                                   prefix_pad=pad, **extra_ref)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = 2 ** -6 * max(1.0, ref.float().abs().max().item())
        same = torch.equal(kv, kv_ref) and all(
            torch.equal(extra[k], extra_ref[k]) for k in extra)
        log(f"K1 at a TP rank's shape: {cache} cache, B {b}, S {s}, {h} "
            f"heads{', t2i pads' if t2i else ''}: max_abs_err {err:.3g} "
            f"(tol {tol:.3g}), cache/scales/tail equal: {same}")
        if not (err <= tol and same):
            raise AssertionError(f"K1 TP {cache} {h} heads disagrees")
        worst["K1"] = max(worst["K1"], err)
    for name, (k, n) in {**TP_XXL_MATMULS, **TP_XL_WQKV}.items():
        w_q, w_s = quantize_weight(torch.randn(k, n, generator=g, device=dev)
                                   * 0.02)
        blocks, scales = pack_w4(torch.randn(k, n, generator=g, device=dev)
                                 * 0.02)
        for b in ((16,) if name in TP_XXL_MATMULS else (TP_ADMIT_ROWS,)):
            x = torch.randn(b, k, generator=g, device=dev).to(torch.bfloat16)
            pairs = [("K2", int8_matmul(x, w_q, w_s),
                      int8_matmul_ref(x, w_q, w_s))]
            if name in TP_XXL_MATMULS:
                pairs.append(("K3", w4_matmul(x, blocks, scales),
                              w4_matmul_ref(x, blocks, scales)))
            torch.cuda.synchronize()
            for kern, out, ref in pairs:
                err = max_err(out, ref)
                tol = 2 ** -7 * ref.float().abs().max().item()
                log(f"{kern} at a TP rank's shape: {name} [{b},{k}]x[{k},"
                    f"{n}] bf16 x: max_abs_err {err:.3g} (tol {tol:.3g})")
                if not err <= tol:
                    raise AssertionError(f"{kern} TP {name} disagrees")
                worst[kern] = max(worst[kern], err)
    q, k, v, w = attention_inputs(dev, TP_TRAIN_SHAPE, torch.bfloat16, 83)
    got = attention_grads(ta.causal_attention_padded, q, k, v, w)
    ref = attention_grads(ta.causal_attention_ref, q, k, v, w)
    rel = [max_err(a, r) / max(r.float().abs().max().item(), 1.0)
           for a, r in zip(got, ref)]
    log(f"K4 at a TP rank's shape {list(TP_TRAIN_SHAPE)} bf16 (v strided):"
        f" relative max err o {rel[0]:.3g} (tol 0.01), dq {rel[1]:.3g}, dk "
        f"{rel[2]:.3g}, dv {rel[3]:.3g} (tol 0.02)")
    if not (rel[0] <= 1e-2 and max(rel[1:]) <= 2e-2):
        raise AssertionError("K4 at the TP shape disagrees")
    worst["K4"] = {"fwd": max_err(got[0], ref[0]),
                   "dq": max_err(got[1], ref[1]),
                   "dkdv": max(max_err(got[2], ref[2]),
                               max_err(got[3], ref[3]))}
    del got, ref, q, k, v, w
    times = time_decode_attention(dev, shapes=(("int8", 12, 64),),
                                  b=2 * TP_PAIRS, tag=" tp")
    times.update(time_decode_attention(
        dev, shapes=(("int8", 10, 64),), b=2 * TP_T2I_PAIRS, s=384, pos=248,
        pads=T2I_PADS, tag=" tp t2i"))
    times.update(time_int8_matmul(dev, shapes=TP_XXL_MATMULS, tag=" tp"))
    times.update(time_int8_matmul(dev, b=TP_ADMIT_ROWS, shapes=TP_XL_WQKV,
                                  tag=" tp"))
    times.update(time_w4_matmul(dev, shapes={"XXL/2 wqkv": (1536, 2304)},
                                bs=(16,)))
    times["K4"] = time_train_attention(dev, TP_TRAIN_SHAPE, 84,
                                       "GPT-L tp 2 rank's training shape")
    return worst, times


def _tp_shard(model, mesh):
    from llamagen_tpu_torch.parallel.tp_decode import shard_tp_params
    return shard_tp_params(model, mesh.get_local_rank("tp"),
                           mesh["tp"].size(), mesh["tp"].get_group())


def _digest(tokens):
    return hashlib.sha1(np.ascontiguousarray(tokens, np.int64)
                        .tobytes()).hexdigest()


def time_all_reduces(dev, n_layer, rows, dim, vocab, reps=20):
    """ms of one step's collectives alone over the rank's group: 2 *
    n_layer all-reduces of [rows, dim] bf16 and the logits' gather ([rows,
    vocab / tp] f32 into [rows, vocab]), synchronised after each."""
    from llamagen_tpu_torch.parallel import collectives
    group = torch.distributed.group.WORLD
    x = torch.randn(rows, dim, device=dev).to(torch.bfloat16)
    y = torch.randn(rows, vocab // TP, device=dev)
    for _ in range(3):
        collectives.reduce_from_tp(x, group)
        collectives.gather_from_tp(y, group)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        for _ in range(2 * n_layer):
            collectives.reduce_from_tp(x, group)
        collectives.gather_from_tp(y, group)
        torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / reps


def time_train_gather(dev, reps=2):
    """ms of the TP training step's logits gather alone: [TWO_RANK_BATCH,
    TOKENS, vocab / tp] f32 on each rank into the whole vocabulary
    (`collectives.gather_from_tp`, `all_gather_into_tensor`)."""
    from llamagen_tpu_torch.parallel import collectives
    group = torch.distributed.group.WORLD
    y = torch.randn(TWO_RANK_BATCH, TOKENS, 16384 // TP, device=dev)
    collectives.gather_from_tp(y, group)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        collectives.gather_from_tp(y, group)
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / reps


def tp_engine_run(dev, mesh, model, label, cache_dtype, n_requests,
                  sps=None, tokens=TOKENS):
    """One TP engine run on the rank's shard `model`: a warm-up of 16
    tokens, then `n_requests` c2i requests (per-request SamplingParams
    `sps`) of `tokens` tokens through TP_PAIRS pairs; its counters, steps, img/s, ms a step, the tokens'
    digest, then (after the counters are read) the device's busy share of
    8 more steps of the same engine, whose slots keep stepping at the
    last position once they finish."""
    from llamagen_tpu_torch.serve.engine import ServeEngine
    kw = dict(num_pairs=TP_PAIRS, chunk=TP_CHUNK, mesh=mesh, tp=TP,
              compute_dtype=torch.bfloat16, cache_dtype=cache_dtype)
    ServeEngine(model, max_new_tokens=16, **kw).generate(range(TP_PAIRS))
    eng = ServeEngine(model, max_new_tokens=tokens, **kw)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.time()
    reqs = [eng.submit(i * 37 % 1000, sp=None if sps is None else sps[i])
            for i in range(n_requests)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts, steps = read_counters(), eng.steps_run
    result = np.stack([r.result for r in reqs])
    state = eng.state
    wall, busy = device_busy(lambda: eng.step_fn(state, 8), 8)
    out = {"counts": counts, "steps": steps, "s": secs,
           "img_s": n_requests / secs, "ms_step": 1e3 * secs / steps,
           "busy_wall_ms": wall, "busy_ms": busy,
           "digest": _digest(result),
           "in_range": bool(result.min() >= 0
                            and result.max() < model.cfg.vocab_size
                            and result.shape == (n_requests, tokens))}
    log(f"rank {torch.distributed.get_rank()} {label}: {secs:.3f} s = "
        f"{out['img_s']:.3f} img/s, {steps} steps = {out['ms_step']:.3f} "
        f"ms/step; a steady step {wall:.3f} ms wall, device busy "
        f"{busy if busy is None else round(busy, 3)} ms; launches {counts}")
    del eng, state
    return out


def tp_t2i_run(dev, mesh):
    """The t2i TP engine (GPT-XL 256 px width, TP_T2I_LAYERS layers, W8A16
    layers, bf16 head, int8 KV, TP_T2I_PAIRS pairs, CFG 7.5) on 4 captions
    with pads 0 / 60 / 100 / 119: counters read around each admission
    prefill and each chunk."""
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    model = _tp_shard(quantize_gpt_params(t2i_model(
        dev, 256, seed=93, n_layer=TP_T2I_LAYERS)), mesh)
    caps, masks = t2i_captions(dev, T2I_PADS, 94)
    eng = ServeEngine(model, max_new_tokens=model.cfg.block_size,
                      num_pairs=TP_T2I_PAIRS, chunk=TP_CHUNK, mesh=mesh,
                      tp=TP, compute_dtype=torch.bfloat16,
                      cache_dtype=torch.int8,
                      sampling_params=SamplingParams(cfg_scale=T2I_CFG))
    per_admission, per_chunk = [], []

    def counted(fn, into):
        def call(*args):
            before = read_counters()
            out = fn(*args)
            after = read_counters()
            into.append((args[-2] if into is per_chunk else 1,
                         {k: after[k] - before[k] for k in after}))
            return out
        return call

    eng._admit_fn = counted(eng._admit_fn, per_admission)
    eng.step_fn = counted(eng.step_fn, per_chunk)
    zero_counters()
    t0 = time.time()
    reqs = [eng.submit_caption(c, m) for c, m in zip(caps.float().cpu(),
                                                     masks.cpu())]
    eng.run_until_idle()
    torch.cuda.synchronize()
    secs = time.time() - t0
    tokens = np.stack([r.result for r in reqs])
    out = {"admissions": per_admission, "chunks": per_chunk,
           "counts": read_counters(), "steps": eng.steps_run,
           "n_admissions": eng.admissions, "s": secs,
           "digest": _digest(tokens), "n_layer": model.cfg.n_layer}
    log(f"rank {torch.distributed.get_rank()} t2i TP engine: {secs:.3f} s, "
        f"{eng.steps_run} steps, {eng.admissions} admission prefills; "
        f"launches {out['counts']}")
    return out


def tp_greedy_run(dev, mesh):
    """Greedy f32 TP engine == the one-card port `generate` at GPT-XXL
    width, 2 layers (f32 caches), 4 labels, 64 tokens, cfg 2.0; both on
    this rank's card."""
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    labels = [207, 360, 387, 974]
    whole = gpt_model(dev, seed=95, dtype=torch.float32, name=TP_MODEL,
                      n_layer=2)
    ref = generate(whole, torch.tensor(labels, device=dev),
                   max_new_tokens=64, cfg_scale=CFG_SCALE,
                   sample_logits=False, compute_dtype=torch.float32,
                   cache_dtype=torch.float32).cpu().numpy()
    eng = ServeEngine(_tp_shard(whole, mesh), num_pairs=2, max_new_tokens=64,
                      chunk=16, compute_dtype=torch.float32, mesh=mesh,
                      tp=TP, sampling_params=SamplingParams(
                          cfg_scale=CFG_SCALE, temperature=0.0))
    got = eng.generate(labels)
    return {"equal": bool((got == ref).all()), "digest": _digest(got),
            "distinct": int(len(np.unique(ref)))}


def tp_serving_worker(dev, args):
    """Phases 44-45, one of two gloo ranks on the card (tp 2): the GPT-XXL
    W8A16 + int8-KV engine with mixed cfg / temperature, the per-shard W4
    engine, the t2i engine, the greedy f32 check and the collectives'
    time."""
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.parallel.mesh import make_mesh
    from llamagen_tpu_torch.parallel.tp_decode import \
        quantize_gpt_params_w4k_tp
    from llamagen_tpu_torch.serve.engine import SamplingParams
    mesh = make_mesh(1, 1, TP, dev.type)
    out = {}
    model = _tp_shard(quantize_gpt_params(gpt_model(
        dev, seed=71, name=TP_MODEL, n_layer=TP_LAYERS)), mesh)
    sps = [SamplingParams(cfg_scale=(1.5, 2.0, 4.0)[i % 3],
                          temperature=0.0 if i % 4 == 3 else (1.0, 0.7)[i % 2])
           for i in range(TP_REQUESTS)]
    out["w8a16"] = tp_engine_run(
        dev, mesh, model, f"{TP_MODEL} tp {TP} W8A16 + int8 KV engine, "
        f"{TP_LAYERS} layers", torch.int8, TP_REQUESTS, sps)
    cfg = model.cfg
    del model
    _free()
    out["allreduce_ms"] = time_all_reduces(dev, TP_LAYERS, 2 * TP_PAIRS,
                                           cfg.dim, cfg.vocab_size)
    model = _tp_shard(quantize_gpt_params_w4k_tp(gpt_model(
        dev, seed=73, name=TP_MODEL, n_layer=TP_LAYERS), TP), mesh)
    out["w4"] = tp_engine_run(
        dev, mesh, model, f"{TP_MODEL} tp {TP} per-shard W4 engine, "
        f"{TP_LAYERS} layers, {TP_W4_TOKENS} tokens", torch.bfloat16,
        TP_PAIRS, tokens=TP_W4_TOKENS)
    del model
    _free()
    out["t2i"] = tp_t2i_run(dev, mesh)
    _free()
    out["greedy"] = tp_greedy_run(dev, mesh)
    return out


def run_tp_serving(dev):
    """Phases 44-45: `tp_serving_worker` in two gloo ranks on the card;
    tokens equal on both ranks, exact per-rank counters, greedy f32 ==
    the one-card `generate`."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        recs = launch_ranks(2, "tp_serving", {"dir": tmp, "backend": "gloo"})
        log(f"TP serving launch: {time.time() - t0:.1f} s")
    out = {}
    L = TP_LAYERS
    for name, want_k3, want_k2 in (("w8a16", 0, 5 * L), ("w4", 5 * L, 0)):
        for r in recs:
            got = r[name]
            want = {"decode_attention": L * got["steps"],
                    "int8_matmul": want_k2 * got["steps"],
                    "w4_matmul": want_k3 * got["steps"],
                    "chunk_decode_attention": 0}
            log(f"TP {name} engine rank {r['rank']}: launches {got['counts']}"
                f", expected {want} ({got['steps']} steps; a c2i admission "
                f"runs no prefill and the bf16 head no K2); device busy "
                f"{got['busy_ms']} of {got['busy_wall_ms']:.3f} ms a step")
            if any(got["counts"][k] != v for k, v in want.items()) \
                    or not got["in_range"]:
                raise AssertionError(f"TP {name} rank {r['rank']}: {got}")
        if recs[0][name]["digest"] != recs[1][name]["digest"]:
            raise AssertionError(f"TP {name}: the ranks' tokens differ")
        slow = max(recs, key=lambda r: r[name]["s"])[name]
        out[name] = {"launches": recs[0][name]["counts"],
                     "img_s": slow["img_s"], "ms_step": slow["ms_step"],
                     "busy": [(r[name]["busy_ms"], r[name]["busy_wall_ms"])
                              for r in recs]}
        log(f"TP {name} engine: tokens equal on both ranks; "
            f"{out[name]['img_s']:.3f} img/s, {out[name]['ms_step']:.3f} ms"
            f" a step (slower rank), busy share per rank "
            f"{[None if b is None else round(b / w, 4) for b, w in out[name]['busy']]}")
    ar = max(r["allreduce_ms"] for r in recs)
    out["allreduce_share"] = ar / out["w8a16"]["ms_step"]
    log(f"TP collectives of one step alone ({2 * L} all-reduces of "
        f"[{2 * TP_PAIRS}, 1536] bf16 + the logits' gather) over gloo "
        f"between the ranks sharing the card: {ar:.3f} ms = "
        f"{100 * out['allreduce_share']:.1f} % of the W8A16 engine's step")
    for r in recs:
        t = r["t2i"]
        L2 = t["n_layer"]
        # one prefill admits every pending pair, up to min(P, 8) at a time
        n_adm = -(-len(T2I_PADS) // min(TP_T2I_PAIRS, 8))
        bad = [c for _, c in t["admissions"]
               if (c["decode_attention"], c["int8_matmul"]) != (0, 5 * L2)]
        bad += [c for n, c in t["chunks"]
                if (c["decode_attention"], c["int8_matmul"])
                != (L2 * n, 5 * L2 * n)]
        log(f"TP t2i engine rank {r['rank']}: {t['n_admissions']} "
            f"admission prefills (K1, K2) "
            f"{[(c['decode_attention'], c['int8_matmul']) for _, c in t['admissions']]}"
            f" (expected {n_adm} of (0, {5 * L2}): one K2 per layer matmul "
            f"at {TP_ADMIT_ROWS} rows, W8A16 layers, bf16 head), "
            f"{t['steps']} steps at ({L2}, {5 * L2}) a step, {t['s']:.2f} s")
        if bad or t["n_admissions"] != n_adm \
                or len(t["admissions"]) != n_adm \
                or sum(n for n, _ in t["chunks"]) != t["steps"]:
            raise AssertionError(f"TP t2i rank {r['rank']}: {bad[:4]}")
    if recs[0]["t2i"]["digest"] != recs[1]["t2i"]["digest"]:
        raise AssertionError("TP t2i: the ranks' tokens differ")
    out["t2i"] = {"launches": recs[0]["t2i"]["counts"],
                  "admission_k2": sum(c["int8_matmul"] for _, c in
                                      recs[0]["t2i"]["admissions"])}
    for r in recs:
        log(f"greedy f32 {TP_MODEL}-width (2 layers) TP engine rank "
            f"{r['rank']} == one-card generate: {r['greedy']['equal']} "
            f"({r['greedy']['distinct']} distinct tokens)")
        if not r["greedy"]["equal"]:
            raise AssertionError("greedy f32 TP engine != generate")
    if recs[0]["greedy"]["digest"] != recs[1]["greedy"]["digest"]:
        raise AssertionError("greedy TP: the ranks' tokens differ")
    return out


def tp_train_worker(dev, args):
    """Phase 46, one of two gloo ranks (tp 2): GPT-L width at
    TWO_RANK_LAYERS layers, f32, 3 steps through `build_trainer` on a
    (1, 1, 2) mesh (its whole parameters saved by rank 0), then the
    training CLI `--tp 2 --fsdp 1 --backend gloo` (bf16, full remat) for
    3 synthetic steps with its whole-model export; and the step's logits
    gather timed alone."""
    from llamagen_tpu_torch.cli import train_c2i
    from llamagen_tpu_torch.parallel.mesh import make_mesh
    tp_train_model_entry()
    ck = args["ckpt"]
    mesh = make_mesh(1, 1, TP, dev.type)
    out = {"c2i": two_rank_c2i(dev, mesh, os.path.join(args["dir"], "tp.pt"),
                               ckpt=(ck["tp_dir"], ck["tp_saved"])),
           "gather_ms": time_train_gather(dev)}
    # phase 48: the one-process `.pt` of step 2 resumed at (1, 1, 2)
    out["resume_pt"] = resume_c2i(dev, mesh, ck["pt_dir"], ck["pt_saved"],
                                  ck["one_step3"])
    for f in k4_kernels():
        f.launches = 0
    t0 = time.time()
    state = train_c2i.main([
        "--gpt-model", TP_TRAIN_MODEL, "--image-size", "384",
        "--global-batch-size", str(TWO_RANK_BATCH), "--log-every", "1",
        "--synthetic-steps", str(DIST_STEPS), "--tp", str(TP), "--fsdp", "1",
        "--backend", "gloo", "--results-dir",
        os.path.join(args["dir"], "cli"), "--device", "cuda"])
    out["cli"] = {"step": state.step, "s": time.time() - t0,
                  "launches": {f.__name__: f.launches
                               for f in k4_kernels()}}
    return out


def tp_four_worker(dev, args):
    """Phase 47, one of four gloo ranks: one f32 step at (1, 2, 2), FSDP2
    over the fsdp pairs of each TP rank; then phase 48: phase 46's
    (1, 1, 2) DCP checkpoint of step 2 resumed at (1, 2, 2)."""
    from llamagen_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 2, TP, dev.type)
    out = {"c2i": two_rank_c2i(dev, mesh, steps=1)}
    ck = args["ckpt"]
    out["resume_tp"] = resume_c2i(dev, mesh, ck["tp_dir"], ck["tp_saved"],
                                  ck["tp_step3"])
    return out


RANK_WORKERS.update({"tp_serving": tp_serving_worker,
                     "tp_train": tp_train_worker,
                     "tp_four": tp_four_worker})


def run_tp_train(dev):
    """Phases 46-47: `tp_train_worker` in two gloo ranks, `tp_four_worker`
    in four, against one process (TWO_RANK_BOUNDS); K4 counters per rank
    exactly 2 * L * steps and L * steps; the CLI's export through
    `load_gpt`."""
    with tempfile.TemporaryDirectory() as tmp:
        return tp_train_phases(dev, tmp)


def tp_train_phases(dev, tmp):
    """`run_tp_train` with its files in `tmp`; phase 48 (checkpoints
    across layouts) rides on phases 46-47's launches: the one-process
    reference saves a `.pt` of step 2, which phase 46's (1, 1, 2) ranks
    resume for step 3; they save a DCP directory of their own step 2,
    which phase 47's (1, 2, 2) ranks and this process resume. Each load,
    made whole, must equal the saved state bit for bit, each resumed step
    3 the unbroken run's within TWO_RANK_BOUNDS, with K4 at 2 * L, L and L
    launches a rank."""
    from llamagen_tpu_torch.cli.common import load_gpt
    tp_train_model_entry()
    for d in ("r2", "r4"):
        os.makedirs(os.path.join(tmp, d))
    ck = {k: os.path.join(tmp, k) for k in ("pt_dir", "tp_dir")}
    ck.update(pt_saved=os.path.join(tmp, "pt_saved.pt"),
              tp_saved=os.path.join(tmp, "tp_saved.pt"))
    ref = two_rank_c2i(dev, None, ckpt=(ck["pt_dir"], ck["pt_saved"]))
    ck["one_step3"] = {"loss": ref["loss"][2],
                       "grad_norm": ref["grad_norm"][2]}
    L = TWO_RANK_LAYERS
    lr_sum = TWO_RANK_LR * (DIST_STEPS - 1)
    t0 = time.time()
    recs = launch_ranks(2, "tp_train", {"dir": os.path.join(tmp, "r2"),
                                        "backend": "gloo", "ckpt": ck})
    log(f"TP training launch: {time.time() - t0:.1f} s")
    params = torch.load(os.path.join(tmp, "r2", "tp.pt"),
                        weights_only=True)
    perr = max((params[k] - v).abs().max().item()
               for k, v in ref["params"].items())
    del params
    export = os.path.join(tmp, "r2", "cli", "checkpoints",
                          f"step_{DIST_STEPS:08d}_model.pt")
    model = load_gpt(export, TP_TRAIN_MODEL, 384, 16, torch.float32, dev)
    n = sum(p.numel() for p in model.parameters())
    finite = all(torch.isfinite(p).all() for p in model.parameters())
    del model
    errs = {"loss": max(_rel(r["c2i"]["loss"], ref["loss"]) for r in recs),
            "grad_norm": max(_rel(r["c2i"]["grad_norm"], ref["grad_norm"])
                             for r in recs),
            "param_lr": perr / lr_sum}
    log(f"TP training (GPT-L width, {L} layers, batch {TWO_RANK_BATCH}, "
        f"f32, tp 2): losses {[round(x, 6) for x in recs[0]['c2i']['loss']]}"
        f" against {[round(x, 6) for x in ref['loss']]}; max relative "
        f"differences loss {errs['loss']:.3g}, grad norm "
        f"{errs['grad_norm']:.3g}; parameters within {errs['param_lr']:.3g} "
        f"of the summed lr; last step "
        f"{max(r['c2i']['step_s'][-1] for r in recs):.3f} s (slower rank) "
        f"against one process's {ref['step_s'][-1]:.3f} s; K4 per rank "
        f"{[r['c2i']['launches'] for r in recs]}")
    gather = max(r["gather_ms"] for r in recs)
    log(f"TP training's logits gather alone ([{TWO_RANK_BATCH}, {TOKENS}, "
        f"{16384 // TP}] f32 a rank into the whole vocabulary, "
        f"all_gather_into_tensor over gloo between the ranks sharing the "
        f"card): {gather:.3f} ms = "
        f"{gather / 10 / max(r['c2i']['step_s'][-1] for r in recs):.1f} % "
        f"of the last TP step")
    want = {"train_attention_fwd": 2 * L * DIST_STEPS,
            "train_attention_dq": L * DIST_STEPS,
            "train_attention_dkdv": L * DIST_STEPS}
    for r in recs:
        for part in ("c2i", "cli"):
            if r[part]["launches"] != want:
                raise AssertionError(f"TP {part} rank {r['rank']}: K4 "
                                     f"{r[part]['launches']}, want {want}")
    for k, b in TWO_RANK_BOUNDS.items():
        if errs[k] > b:
            raise AssertionError(f"TP training: {k} {errs[k]:.3g} > {b}")
    log(f"TP training CLI (--tp 2, bf16, full remat, {DIST_STEPS} steps): "
        f"{max(r['cli']['s'] for r in recs):.1f} s, steps "
        f"{[r['cli']['step'] for r in recs]}, K4 per rank "
        f"{[r['cli']['launches'] for r in recs]}; load_gpt(whole-model "
        f"export): {n / 1e6:.1f}M parameters, finite {finite}")
    if not finite or [r["cli"]["step"] for r in recs] != [DIST_STEPS] * 2:
        raise AssertionError("the TP CLI run or its export")
    ck["tp_step3"] = {"loss": recs[0]["c2i"]["loss"][2],
                      "grad_norm": recs[0]["c2i"]["grad_norm"][2]}
    t0 = time.time()
    recs4 = launch_ranks(4, "tp_four", {"dir": os.path.join(tmp, "r4"),
                                        "backend": "gloo", "ckpt": ck})
    log(f"(1, 2, 2) launch: {time.time() - t0:.1f} s")
    errs4 = {"loss": max(abs(r["c2i"]["loss"][0] / ref["loss"][0] - 1)
                         for r in recs4),
             "grad_norm": max(abs(r["c2i"]["grad_norm"][0]
                                  / ref["grad_norm"][0] - 1) for r in recs4)}
    log(f"FSDP2 x TP (1, 2, 2), four gloo ranks, one step: loss "
        f"{recs4[0]['c2i']['loss'][0]:.6f} against {ref['loss'][0]:.6f}, "
        f"relative differences {errs4}; K4 per rank "
        f"{[r['c2i']['launches'] for r in recs4]}")
    want4 = {"train_attention_fwd": 2 * L, "train_attention_dq": L,
             "train_attention_dkdv": L}
    if any(errs4[k] > TWO_RANK_BOUNDS[k] for k in errs4) \
            or any(r["c2i"]["launches"] != want4 for r in recs4):
        raise AssertionError(f"(1, 2, 2): {errs4}")
    ckpt = check_resumes(dev, ck, ref, recs, recs4)
    return {"errs": errs, "errs4": errs4, "gather_ms": gather,
            "launches": recs[0]["cli"]["launches"], "ckpt": ckpt}


def check_resumes(dev, ck, ref, recs, recs4):
    """Phase 48's checks and lines: phase 46's DCP directory resumed in
    this process too; each resume bit-equal, within TWO_RANK_BOUNDS, with
    K4 at 2 * L, L and L; the seconds to save and to load, the GB on disk
    against the `.pt`'s, on the card named."""
    L = TWO_RANK_LAYERS
    one = resume_c2i(dev, None, ck["tp_dir"], ck["tp_saved"],
                     ck["tp_step3"])
    resumes = {f".pt -> (1, 1, 2) rank {r['rank']}": r["resume_pt"]
               for r in recs}
    resumes.update({f"DCP (1, 1, 2) -> (1, 2, 2) rank {r['rank']}":
                    r["resume_tp"] for r in recs4})
    resumes["DCP (1, 1, 2) -> one process"] = one
    want = {"train_attention_fwd": 2 * L, "train_attention_dq": L,
            "train_attention_dkdv": L}
    for label, r in resumes.items():
        log(f"phase 48 {label}: load {r['load_s']:.3f} s; loaded state == "
            f"saved bit for bit: {not r['unequal']}; step 3 relative "
            f"differences {r['rel']} (TWO_RANK_BOUNDS); K4 {r['launches']}")
        if r["unequal"] or r["step_loaded"] != 2 or r["launches"] != want \
                or any(r["rel"][k] > TWO_RANK_BOUNDS[k] for k in r["rel"]):
            raise AssertionError(f"phase 48 {label}: {r}")
    dcp_gb = recs[0]["c2i"]["ckpt_gb"]
    save_s = max(r["c2i"]["save_s"] for r in recs)
    log(f"phase 48 checkpoints (GPT-L width, {L} layers, f32 state with "
        f"both Adam moments and the EMA) on {card_line()}: one-process "
        f".pt save {ref['save_s']:.3f} s, {ref['ckpt_gb']:.4f} GB; DCP at "
        f"(1, 1, 2) save {save_s:.3f} s (slower rank), {dcp_gb:.4f} GB = "
        f"{dcp_gb / ref['ckpt_gb']:.4f} x the .pt; loads: .pt -> (1, 1, 2) "
        f"{max(r['resume_pt']['load_s'] for r in recs):.3f} s, DCP -> "
        f"(1, 2, 2) {max(r['resume_tp']['load_s'] for r in recs4):.3f} s, "
        f"DCP -> one process {one['load_s']:.3f} s (slower rank)")
    if dcp_gb > 1.05 * ref["ckpt_gb"]:
        raise AssertionError(f"DCP {dcp_gb} GB > 1.05 x {ref['ckpt_gb']}")
    return {"launches": recs[0]["resume_pt"]["launches"]}



def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    from llamagen_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    lib = _build.build()
    _build.load_library()
    log(f"kernel build: {time.time() - t0:.1f} s ({lib.name})")

    phases = {}

    def phase(name, fn):
        t = time.time()
        out = fn(dev)
        phases[name] = round(time.time() - t, 1)
        log(f"phase {name}: {phases[name]} s")
        return out

    k1_err, k1_t = phase("K1 checks", check_decode_attention)
    k2_err, k2_t = phase("K2 checks", check_int8_matmul)
    launches = phase("sampling main path", run_main_path)
    phase("GPT-3B sampling path", lambda d: run_main_path(d, "GPT-3B"))
    phase("sampling CLI", run_cli)
    phase("teacher forcing", run_teacher_forced)
    phase("teacher forcing, GPT-3B width",
          lambda d: run_teacher_forced(d, "GPT-3B", n_layer=4, steps=16))
    k3_err, k3_t = phase("K3 checks", check_w4_matmul)
    k5_err, k5_t = phase("K5 checks", check_chunk_attention)
    w4_launches = phase("W4 sampling path", run_w4_path)
    spec_launches = phase("speculative path", run_speculative)
    phase("speculative CLI", run_spec_cli)
    phase("greedy f32 speculative == generate", run_spec_greedy_f32)
    phase("greedy f32 speculative == generate, GPT-3B width",
          lambda d: run_spec_greedy_f32(d, "GPT-3B", n_layer=2))
    k4_err, k4_t, k4_t2i_err, k4_t2i_t = phase("K4 checks",
                                               check_train_attention)
    k4_launches, train_stats = phase("training CLI", run_train_cli)
    phase("training CLI, remat save_attn",
          lambda d: run_train_cli(d, "save_attn", 4))
    phase("training step vs plain", run_train_step_vs_plain)
    phase("serving engine", run_engine)
    phase("greedy f32 engine == generate", run_engine_greedy_f32)
    phase("serving app", run_app)
    phase("T5 encoder, flan-t5-xl widths", run_t5_encoder)
    t2i_launches = phase("t2i sampling path", run_t2i_path)
    t2i_engine = phase("t2i serving engine", run_t2i_engine)
    phase("greedy f32 t2i engine == generate", run_t2i_engine_greedy_f32)
    t2i_spec = phase("t2i speculative path", run_t2i_speculative)
    phase("greedy f32 t2i speculative == generate", run_t2i_spec_greedy_f32)
    phase("t2i sampling CLI", run_t2i_cli)
    phase("VQ-16 encode, full width", run_vq_encode)
    phase("tokenizer CLIs' batch functions", run_vq_cli_batches)
    t2i_train_launches, t2i_stats = phase("t2i training, GPT-XL",
                                          run_t2i_train)
    phase("t2i training step vs plain", run_t2i_step_vs_plain)
    phase("t2i training CLI", run_t2i_train_cli)
    phase("VQ-GAN training, VQ-16", run_vq_gan_train)
    phase("VQ-GAN f32 step, card vs CPU", run_vq_gan_vs_cpu)
    phase("VQ-GAN training CLI", run_vq_gan_cli)
    torch.cuda.empty_cache()  # the ranks' processes share the card
    phase("training across ranks, one NCCL rank",
          lambda d: run_world1(d, train_stats, t2i_stats))
    phase("training across ranks, two gloo ranks on the card", run_two_ranks)
    draft = phase("GPTQ + AWQ, GPT-L width", run_gptq_awq)
    spec_engine = phase("speculative engine",
                        lambda d: run_spec_engine(d, draft))
    del draft
    phase("greedy f32 speculative engine == generate",
          run_spec_engine_greedy_f32)
    _free()
    with tempfile.TemporaryDirectory() as tmp:
        phase("Inception, pytorch-fid layout, full width", run_inception)
        fid = phase("c2i FID sampler CLI, GPT-L 384",
                    lambda d: run_fid_sampler(d, tmp))
        phase("evaluate CLI", lambda d: run_evaluate(d, fid))
        t2i_fid = phase("t2i FID sampler, CLIP score, evaluate_t2i",
                        lambda d: run_t2i_fid(d, tmp, fid["ref"]))
        phase("baseline tokenizers: sd-vae, taming, cd",
              lambda d: run_baselines(d, tmp))
    tp_err, tp_t = phase("TP kernels at the ranks' shapes", check_tp_kernels)
    _free()  # the ranks' processes share the card
    tp_serve = phase("TP serving, two gloo ranks on the card",
                     run_tp_serving)
    tp_train = phase("TP training, two and four gloo ranks on the card",
                     run_tp_train)
    log(f"phase seconds: {phases}")

    def entry(name, source, replaces, launches_, err, t):
        """One kernel's record: bound_ms / bound_by from this run's inputs,
        every time measured in this run."""
        return {"name": name, "route": "cuda",
                "source": f"llamagen_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain"],
                "bound_ms": t["bound"], "bound_by": t["by"],
                "library_ms": t["library"]}

    k4 = "train_attention.cu"
    record = {"kernels": [
        entry("decode_attention", "decode_attention.cu",
              "llamagen_tpu/ops/attention.py:569",
              launches["decode_attention"], k1_err, k1_t["int8"]),
        entry("int8_matmul", "int8_matmul.cu",
              "llamagen_tpu/ops/quant_matmul.py:62",
              launches["int8_matmul"], k2_err, k2_t["wqkv"]),
        entry("w4_matmul", "w4_matmul.cu",
              "llamagen_tpu/ops/w4_matmul.py:315",
              w4_launches["w4_matmul"], k3_err, k3_t[("wqkv", 16)]),
        entry("train_attention_fwd", k4,
              "llamagen_tpu/ops/train_attention.py:195",
              k4_launches["train_attention_fwd"], k4_err["fwd"],
              k4_t["record"]["fwd"]),
        entry("train_attention_dq", k4,
              "llamagen_tpu/ops/train_attention.py:213",
              k4_launches["train_attention_dq"], k4_err["dq"],
              k4_t["record"]["dq"]),
        entry("train_attention_dkdv", k4,
              "llamagen_tpu/ops/train_attention.py:213",
              k4_launches["train_attention_dkdv"], k4_err["dkdv"],
              k4_t["record"]["dkdv"]),
        entry("chunk_decode_attention", "chunk_attention.cu",
              "llamagen_tpu/ops/chunk_attention.py:315",
              spec_launches["chunk_decode_attention"], k5_err, k5_t[5]),
        # the t2i slice's shapes: GPT-XL, 20 heads, prefix_pad
        entry("decode_attention [t2i 512 px: bf16 cache, B 8, 20 heads, "
              "prefix_pad]", "decode_attention.cu",
              "llamagen_tpu/ops/attention.py:569",
              t2i_launches["decode_attention"], k1_err, k1_t["bf16 B8 t2i"]),
        entry("decode_attention [t2i engine: int8 cache, B 16, 20 heads, "
              "prefix_pad]", "decode_attention.cu",
              "llamagen_tpu/ops/attention.py:569",
              t2i_engine["decode_attention"], k1_err, k1_t["int8 t2i"]),
        entry("int8_matmul [t2i engine step: GPT-XL wqkv, B 16]",
              "int8_matmul.cu", "llamagen_tpu/ops/quant_matmul.py:62",
              t2i_engine["int8_matmul_steps"], k2_err,
              k2_t["XL wqkv t2i"]),
        entry("int8_matmul [t2i admission: GPT-XL wqkv, B 1920]",
              "int8_matmul.cu", "llamagen_tpu/ops/quant_matmul.py:62",
              t2i_engine["int8_matmul_admissions"], k2_err,
              k2_t[f"XL wqkv B{T2I_ADMIT_ROWS} t2i"]),
        entry("chunk_decode_attention [t2i 512 px speculative: B 8, 20 "
              "heads, prefix_pad, C 5]",
              "chunk_attention.cu",
              "llamagen_tpu/ops/chunk_attention.py:315",
              t2i_spec["chunk_decode_attention"], k5_err, k5_t["5 t2i"]),
        # the t2i training slice: GPT-XL, 20 heads, S 375, v strided
        *(entry(f"{name} [t2i training: GPT-XL, B 32, S 375, 20 heads]", k4,
                f"llamagen_tpu/ops/train_attention.py:{line}",
                t2i_train_launches[name], k4_t2i_err[key],
                k4_t2i_t["record"][key])
          for name, key, line in (("train_attention_fwd", "fwd", 195),
                                  ("train_attention_dq", "dq", 213),
                                  ("train_attention_dkdv", "dkdv", 213))),
        # the speculative engine: K2 at the verify's 80 rows, K3 in the
        # GPTQ draft (pack_w4's layout: K3's B 16 g128 time), K5 at the
        # slots' own positions
        entry("int8_matmul [spec engine verify: GPT-L wqkv, "
              f"{SPEC_ENGINE_ROWS} rows]", "int8_matmul.cu",
              "llamagen_tpu/ops/quant_matmul.py:62",
              spec_engine["int8_matmul"], k2_err,
              k2_t[f"wqkv B{SPEC_ENGINE_ROWS} spec"]),
        entry("w4_matmul [spec engine draft: GPTQ g128, 16 rows]",
              "w4_matmul.cu", "llamagen_tpu/ops/w4_matmul.py:315",
              spec_engine["w4_matmul"], k3_err, k3_t[("wqkv", 16)]),
        entry(f"chunk_decode_attention [spec engine: per-slot positions, C "
              f"{SPEC_K + 1}]", "chunk_attention.cu",
              "llamagen_tpu/ops/chunk_attention.py:315",
              spec_engine["chunk_decode_attention"], k5_err,
              k5_t[f"{SPEC_K + 1} spec"]),
        # the evaluation slice: K1's bf16 entry in the FID samplers
        entry(f"decode_attention [c2i FID sampler: GPT-L 384, bf16 cache, "
              f"B {2 * FID_BATCH}]", "decode_attention.cu",
              "llamagen_tpu/ops/attention.py:569", fid["launches"], k1_err,
              k1_t[f"bf16 B{2 * FID_BATCH} fid"]),
        entry(f"decode_attention [t2i FID sampler: GPT-XL 256 px, bf16 "
              f"cache, B {2 * len(FID_PROMPTS)}, 20 heads, prefix_pad]",
              "decode_attention.cu", "llamagen_tpu/ops/attention.py:569",
              t2i_fid["launches"], k1_err,
              k1_t[f"bf16 B{2 * len(FID_PROMPTS)} t2i fid"]),
        # the TP slice: each kernel at a rank's shapes (rank 0's counts)
        entry(f"decode_attention [TP rank: {TP_MODEL} tp {TP}, int8 cache, "
              f"B {2 * TP_PAIRS}, 12 heads]", "decode_attention.cu",
              "llamagen_tpu/ops/attention.py:569",
              tp_serve["w8a16"]["launches"]["decode_attention"],
              tp_err["K1"], tp_t["int8 tp"]),
        entry(f"int8_matmul [TP rank: {TP_MODEL} tp {TP} wqkv shard "
              f"[1536, 2304], B 16]", "int8_matmul.cu",
              "llamagen_tpu/ops/quant_matmul.py:62",
              tp_serve["w8a16"]["launches"]["int8_matmul"], tp_err["K2"],
              tp_t["XXL/2 wqkv tp"]),
        entry(f"w4_matmul [TP rank: {TP_MODEL} tp {TP} per-shard wqkv g128, "
              f"B 16]", "w4_matmul.cu", "llamagen_tpu/ops/w4_matmul.py:315",
              tp_serve["w4"]["launches"]["w4_matmul"], tp_err["K3"],
              tp_t[("XXL/2 wqkv", 16)]),
        entry(f"decode_attention [TP t2i engine: GPT-XL tp {TP}, int8 cache,"
              f" B {2 * TP_T2I_PAIRS}, 10 heads, prefix_pad]",
              "decode_attention.cu", "llamagen_tpu/ops/attention.py:569",
              tp_serve["t2i"]["launches"]["decode_attention"], tp_err["K1"],
              tp_t[f"int8 B{2 * TP_T2I_PAIRS} tp t2i"]),
        entry(f"int8_matmul [TP t2i admission: GPT-XL tp {TP} wqkv "
              f"shard, {TP_ADMIT_ROWS} rows]", "int8_matmul.cu",
              "llamagen_tpu/ops/quant_matmul.py:62",
              tp_serve["t2i"]["admission_k2"], tp_err["K2"],
              tp_t[f"XL/2 wqkv B{TP_ADMIT_ROWS} tp"]),
        *(entry(f"{name} [TP rank: GPT-L tp {TP} training, B "
                f"{TWO_RANK_BATCH}, S {TOKENS}, 8 heads]", k4,
                f"llamagen_tpu/ops/train_attention.py:{line}",
                tp_train["launches"][name], tp_err["K4"][key],
                tp_t["K4"]["record"][key])
          for name, key, line in (("train_attention_fwd", "fwd", 195),
                                  ("train_attention_dq", "dq", 213),
                                  ("train_attention_dkdv", "dkdv", 213))),
        # checkpoints across layouts: the step after a one-process `.pt`
        # resumed at tp 2 (rank 0's counts)
        *(entry(f"{name} [resumed TP rank: GPT-L tp {TP} from a one-process"
                f" .pt, B {TWO_RANK_BATCH}, S {TOKENS}, 8 heads]", k4,
                f"llamagen_tpu/ops/train_attention.py:{line}",
                tp_train["ckpt"]["launches"][name], tp_err["K4"][key],
                tp_t["K4"]["record"][key])
          for name, key, line in (("train_attention_fwd", "fwd", 195),
                                  ("train_attention_dq", "dq", 213),
                                  ("train_attention_dkdv", "dkdv", 213))),
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:  # a rank of `launch_ranks`
        rank_worker(sys.argv[2], json.loads(sys.argv[3]))
    else:
        main()
