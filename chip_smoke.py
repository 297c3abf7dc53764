#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds, serves and trains on the GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card and
   times the kernel and the plain version beside the bound from bytes and
   operations: the serving kernels in bf16 at the qwen2.5-0.5b decode
   shapes (with ``F.rms_norm`` as a library yardstick, and
   ``torch.matmul`` of x@W0 beside the grouped forward as context; the
   grouped forward's bf16 tensor-core body with its plan per shape and its
   registers and spills (ptxas), and the SHA-256 of its f32 CUDA-core
   body's output at each shape; the RMSNorm forward's output SHA-256s at
   ``RMS_SHAPES``, which must equal ``RMS_FWD_SHA256``), the training
   kernels (LoRA forward, dx, dA/dB, RMSNorm backward) in bf16 and f32 at
   the training shapes, 192 rows (batch 4 x seq 48), the LoRA forward,
   dx and dA/dB also at the paper path's 256 rows (batch 1 x seq 256),
   with ``torch.matmul``'s time for the dominant x@W0 / g@W0^T product
   as context (for dA/dB two ``torch.mm`` of its row contractions' shapes;
   no single PyTorch call computes those functions), and the RMSNorm
   backward beside ``aten._fused_rms_norm_backward`` (``rms_bwd_library``)
   with its registers and spills (ptxas). The bf16 LoRA
   forwards and dx (over bf16, int8, int4 and nf4) and dA/dB, on tensor
   cores, carry their split of the work per shape (forward and dx: of the
   contraction; dA/dB: members, sub-runs, passes, row fragments) and
   dynamic shared memory (as the CUDA runtime holds them, or as dA/dB's
   plan sets it) and their registers and spills (ptxas).
3. Serves full-width qwen2.5-0.5b (24 layers, random weights from a seed)
   through ``repro_torch.launch.serve``: 8 slots in tiles of 2, 4 tenants,
   a store of 4, 8 requests of 8 prompt + 16 new tokens. The launch
   counters are zeroed just before and read just after; every decode step
   must launch the grouped kernel 7 x 24 = 168 times and the RMSNorm
   kernel 2 x 24 + 1 = 49 times.
4. Replays the first 4 steps (all prefill, so the inputs are fixed)
   through the kernels, through the plain functions, and through the plain
   functions in f32, and compares the logits.
5. Trains full-width qwen2.5-0.5b through ``repro_torch.launch.train``:
   engine mesp_cuda, batch 4 x seq 48, 4 SGD steps. The counters are zeroed
   just before and read just after; each step must launch exactly the
   counts of ``TRAIN_PER_STEP``, and every loss must be finite.
6. One ``value_and_grad`` on the same full-width weights with every LoRA B
   drawn nonzero, through the kernels, the plain (autograd) backend in
   bf16, and the plain backend in f32: the loss and each LoRA gradient
   leaf (relative L2) are compared in the logit check's scheme. Then the
   peak ``torch.cuda.max_memory_allocated`` of one ``value_and_grad`` for
   each engine (mesp_cuda, mesp, mebp, store_h): a measurement.
7. Holds the three flash-attention kernels (forward, dq, dk/dv) against
   their plain versions in bf16 and f32 at the training path's shape
   (B*H 14, B*Hkv 2, N 256, D 64, causal) and at edge cases (window,
   non-causal, ragged N, a row and a column past a tile, Nq != Nk, rows
   that see no key, G 1, 11, 12 and 16, D 40, 72 and 128, RoPE on and
   off), and times them at the path's shape beside their plain versions,
   ``F.scaled_dot_product_attention`` (forward, and forward plus backward)
   and the bound; the bf16 kernels' registers (ptxas) and dynamic shared
   memory (as the CUDA runtime holds it) go beside them.
8. Trains at the paper's setting through ``repro_torch.launch.train``:
   engine mesp_cuda, batch 1 x seq 256, 4 steps, counts zeroed just before
   and read just after (each step: ``PAPER_PER_STEP``, the flash kernels
   48 / 24 / 24 on top of step 5's counts); then 2 steps with
   ``--fuse-rope``, with the same counts and losses within ``LOSS_TOL`` of
   the unfused run. Then step 6's gradient comparison at batch 1 x seq 256,
   and the peak memory of one ``value_and_grad`` at that setting for each
   engine with remat on, and for mesp_cuda and mebp with remat off.
9. The quantized frozen base: holds the quantized LoRA kernels (int8
   forward and dx; packed forward and dx, int4 and nf4) against their plain
   versions in bf16 and f32 at the paper path's shapes (M 256), OLMoE's
   q, k, v, o (M 256, 2048 x 2048) and a ragged odd-K case, and times them
   beside their plain versions, the bound and ``torch.matmul`` of x@W0 (or
   g@W0^T) over the dequantized W0 as context.
   Then trains through ``repro_torch.launch.train --quantize int8`` and
   ``--quantize nf4`` (mesp_cuda, batch 1 x seq 256, 3 steps each, counts
   zeroed just before and read just after: ``quant_per_step``, the
   quantized forward and dx in place of the dense ones), compares loss and
   LoRA gradients with the plain backend over the same nf4 weights in bf16
   and f32, and prints the peak memory of one ``value_and_grad`` over the
   nf4 base per engine, remat on and off, beside what was allocated at the
   start.
10. Serving over a quantized frozen base: holds the quantized grouped
   kernels (``lora_grouped_q`` over int8, ``lora_grouped_q4`` over int4 and
   nf4) against their plain versions in bf16 and f32 at the decode shapes
   (8 slots in tiles of 2) and at the edges of ``GROUPED_Q_EDGES`` (odd K,
   ragged N, ranks 3 and 16, two row blocks, repeated slots, a bad gid
   that gives NaN rows), and times them beside their plain versions, the
   bound and ``torch.matmul`` of x@W0 over the dequantized W0 as context.
   Then serves step 3's trace through ``repro_torch.launch.serve
   --quantize int8`` and ``--quantize nf4``, counts zeroed just before and
   read just after each run (every decode step: 168 launches of the base's
   grouped kernel, 49 RMSNorm, 0 of the float grouped kernel), replays each
   run's first 4 steps as step 4 does over the same codes, and prints what
   ``init_params`` leaves allocated for a bf16, int8 and nf4 base beside
   ``serve/residency.serve_residency``'s modelled ``weights_mb``, and each
   run's peak.
11. MoE training over per-expert stacks: holds the three grouped training
   kernels (``lora_grouped_gemm``, ``lora_grouped_dx``,
   ``lora_grouped_dab``) against their plain versions in f32 and bf16 at
   the MoE path's shapes (E 64, C 40, (K, N) of gate/up and down, r 8) and
   at ``MOE_EDGES`` (C 13 padded to 16, a 72-row tile over two blocks, odd
   K and N, ranks 3 and 16, an empty group, a bad gid, a group split in
   two), and times them beside their plain versions, the bound and
   ``torch.bmm`` / ``torch.matmul`` of the expert product as context; and
   the bf16 forward's, dx's and dA/dB's registers and spills (ptxas) and
   dynamic shared memory (as the CUDA runtime holds it, or dA/dB's plan
   with its cluster's members) beside their figures; and
   the dense kernels on that path at its shapes, in f32 and bf16: the LoRA
   forward, dx and dA/dB at 256 rows x 2048 x 2048 (q, k, v, o), RMSNorm
   forward and backward over [256, 2048], flash attention at B*H 16, G 1,
   N 256, D 128.
   Then trains full-width OLMoE-1B-7B (16 layers, random weights from a
   seed) through ``repro_torch.launch.train --arch olmoe-1b-7b``: mesp_cuda,
   batch 1 x seq 256, 3 steps, counts zeroed just before and read just
   after (``MOE_PER_STEP``: grouped 96 / 48 / 48 a step). Then the loss and
   LoRA gradients against the plain backend in bf16 and f32
   (``compare_grads_moe``: routing differences per layer; gradients with
   the routing pinned to the kernel run's, at ``GRAD_TOL`` at
   ``MOE_GRAD_LAYERS`` layers; at full depth, the kernels run in f32, at
   ``GRAD_TOL`` from the plain f32 run, and in bf16, each MoE block's input
   of the plain bf16 run pinned to the kernel run's too, at cosine
   ``MOE_COS_FLOOR``),
   two bitwise-equal ``value_and_grad`` calls, and
   the peak memory of one ``value_and_grad`` for mesp_cuda, mesp and mebp,
   remat on and off.
12. MoE over a quantized base: holds the four quantized grouped training
   kernels (``lora_grouped_gemm_q`` / ``_q4``, ``lora_grouped_dx_q`` /
   ``_q4``) against their plain versions in f32 and bf16 over int8, int4
   and nf4 expert stacks at the MoE path's shapes and at ``MOE_EDGES`` (but
   the split group, which only dA/dB sees), and times them beside their
   plain versions, the bound and ``torch.bmm`` / ``torch.matmul`` over the
   dequantized stack as context (the bf16 forward's and dx's ptxas figures
   and dynamic shared memory per format beside them). Then trains full-width
   OLMoE-1B-7B through ``repro_torch.launch.train --arch olmoe-1b-7b
   --quantize nf4`` (3 steps) and ``--quantize int8`` (2 steps), counts
   zeroed just before and read just after each run (``moe_quant_per_step``:
   the quantized grouped forward 96 and dx 48, ``lora_grouped_dab`` 48, the
   quantized dense forward 128 and dx 61 a step, the float ones 0); the loss
   and LoRA gradients over the nf4 base against the plain backend over the
   same codes (``compare_grads_moe`` as in step 11), two bitwise-equal
   ``value_and_grad`` calls, what ``init_params`` leaves allocated and its
   peak for a bf16, int8 and nf4 base, and the peak memory of one
   ``value_and_grad`` over the nf4 base for mesp_cuda, mesp and mebp, remat
   on and off.
13. The standalone RoPE kernel (on no path of either package) and its
   VJP (the kernel at -sin) bit for bit against the plain rotation in f32
   and bf16 at [1, 256, 14, 64] (qwen2.5-0.5b's q), [1, 256, 16, 128]
   (OLMoE's) and an odd N, timed beside the plain rotation and the bound,
   with its registers and spills (ptxas).
14. The paper's §4.3 loop: one ``sequential_train_step`` (engine
   ``mesp_seq``) of full-width qwen2.5-0.5b at batch 1 x seq 256, bf16,
   every LoRA B drawn nonzero, under the ``cuda`` policy, counts zeroed
   just before and read just after (``PAPER_PER_STEP``, the production
   step's: every block recomputed in the reverse loop); the peak memory
   of one such step beside one ``mesp.train_step`` (Table 4's MeSP-seq
   row beside MeSP); in f32, its updated LoRA leaves against mesp_cuda's
   ``value_and_grad`` + SGD at ``GRAD_TOL`` (the updates, at
   ``CHECK_LR``), and whether they are equal bit for bit.
15. MeZO on the same model in f32: one dense ``spsa_grad`` at MeZO's eps
   under the ``cuda`` policy, counts zeroed just before and read just
   after (two probe forwards: ``ZO_PER_PROBE`` twice, no backward kernel);
   the projection (L+ - L-)/2eps at ``ZO_CHECK_EPS`` against
   <g_exact, z>, g_exact from mesp_cuda, within ``ZO_TOL`` ||g_exact||,
   beside the projection at eps 1e-2, 1e-3 and 1e-4, the f32 loss's
   rounding (the kernels' loss against the plain backend's) and z bit for
   bit on a second draw from its seed; Table 3 on the card
   (``zo.gradquality.probe``: global and per-layer cosine, sign agreement,
   relative error of mezo against mesp_cuda); Table 4's MeZO row: the
   bf16 peak of one mezo step beside one mesp_cuda step.
16. 2 steps of each new engine or optimizer through its registry builder
   under the policy the train CLI gives it (``NEW_RUNS``: mesp_seq, the
   five mezo*, mesp_cuda with sgd_momentum and with adamw) on one bf16
   full-width params tree: finite losses, moved LoRA leaves, every frozen
   leaf (and the given tree) bit for bit unchanged.
17. ``core/flash.py`` (the structured backend's chunked flash, plain
   PyTorch) against the flash kernels at ``CORE_FLASH_SHAPE``, chunk
   ``CORE_FLASH_CHUNK``, causal: out, dq, dk, dv in f32 and bf16 at the
   flash card tests' tolerances.
18. The production launcher (``launch.train.run``, what ``main`` runs:
   TrainSpec, the Trainer, the resilient loop) on full-width qwen2.5-0.5b,
   bf16, mesp_cuda, seq 256, each run with a checkpoint directory of its
   own under a temporary directory the phase deletes, counts zeroed just
   before and read just after each run: (a) 12 steps at batch 2 with
   telemetry, exactly 12 x ``PAPER_PER_STEP``, finite losses, LoRA leaves
   bit for bit the bare loop's, the median step and the run's peak beside
   the bare loop's; (b) the same with ``crash@6``: resumed, its LoRA
   leaves bit for bit (a)'s; (c) ``oom@3,corrupt@6,crash@6,nan@8,stall@10``
   with the stall and the watchdog sized from (a)'s step: every kind fired
   once, one straggler restart, a quarantine, a guard skip,
   ``halve_batch`` to batch 1, the kernels' counts for every step run;
   (d) a real ``torch.cuda.OutOfMemoryError`` at batch 4 under a
   ``set_per_process_memory_fraction`` cap between one step's peak at
   batch 4 and at batch 2, classified as an OOM and answered by
   ``halve_batch``; (e) ``--mem-budget-mb`` with 0.9 x the budget between
   the residency after a step over an int8 and over the bf16 base: the
   rungs and the residency after each, ending under the limit (or with
   the ladder exhausted), no rung leaving ``mesp_cuda`` and every step
   the kernels' counts of the format then in force; (f) MB a save, seconds a save and a restore
   (every ``sha256_16`` verified); (g) every record of (a) valid, the
   watermark's peak equal to ``max_memory_allocated`` over the run, the
   ``data_fetch`` and ``step`` spans, and a ``--profile on`` run's
   ``torch.profiler`` Chrome trace read by ``json.load``.
19. The rest of the dense catalog (``dense_catalog_phase``): (a) the
   flash kernels' 256 instance against their plain versions in f32 and
   bf16 at ``FLASH_D256_CASES`` (Gemma3-12B's two path shapes, B*H 16,
   B*Hkv 8, N 2048, D 256, causal, window 1024 and 0, RoPE on and off;
   ragged N, Nq != Nk, D 200, G 1), timed at both path shapes beside their
   plain versions, ``F.scaled_dot_product_attention`` (with the window's
   mask) and the bound, with the 256 instances' ptxas figures and dynamic
   shared memory; (b) the LoRA forward, dx, dA/dB and both RMSNorm kernels
   at Gemma3's five (K, N) and M 2048 (through ``check_training_kernels``),
   its grouped decode forward at those (K, N), M 8 in tiles of 2 over 4
   tenants (``check_grouped``), and its RMSNorm forward at decode, [8,
   3840] (``check_rmsnorm``); the kernels of (g)'s configs at their shapes,
   M 256 (``config_kernels``: dA/dB and both RMSNorm kernels, and the
   LoRA forward and dx, over nf4 for qwen2.5-32b); (c) full-width,
   full-depth gemma3-12b through
   ``launch.train``: mesp_cuda, bf16, batch 1 x seq 2048, 3 SGD steps,
   counts zeroed just before and read just after (``dense_per_step``:
   672 / 333 / 336 LoRA, 193 / 96 RMSNorm, 96 / 48 / 48 flash a step),
   finite losses, and the peak of one ``value_and_grad`` for mesp_cuda and
   mebp (remat on); (d) at full width and one group (5 local layers, 1
   global), every LoRA B nonzero (at ``b_scale_for``: the LoRA term at
   qwen2.5-0.5b's size), the loss and LoRA gradients through the kernels
   in bf16 and f32 against the plain backend in bf16 and f32
   (``compare_grads``; the f32 kernels within ``CATALOG_F32_GRAD_TOL``);
   (f) that group decoding ``RING_POSITIONS`` positions of a batch of 2
   through the per-slot caches (the local layers' rings wrap past 1,024),
   its logits against the forward's through the kernels and in f32 in the
   logit check's scheme; (e) full-width gemma3-12b served through
   ``launch.serve`` (8 slots in tiles of 2, 4 tenants, 8 requests of 8 +
   8 tokens; 336 grouped and 97 RMSNorm launches a decode step); (g)
   granite-8b and minitron-4b in bf16 and qwen2.5-32b over nf4, each at
   full size, 2 mesp_cuda steps at batch 1 x seq 256 with exact counts and
   finite losses, beside ``init_params``' peak and what it leaves.
20. Single-stream serving and the recurrent families (``recurrent_phase``):
   the LoRA forward, dx and dA/dB and both RMSNorm kernels at RWKV6-1.6B's
   and RecurrentGemma-2B's shapes, M 256 (``check_training_kernels``), the
   RMSNorm kernels at RWKV6's per-head group norm ([8192, 64]), the LoRA
   forward at M 4 (single-stream decode) at both families', OLMoE's
   attention (over nf4 too) and qwen2.5-0.5b's shapes, OLMoE's grouped
   forward over 64
   buffers of 32 rows (bf16 and nf4), the flash kernels at
   ``FLASH_G10_CASES`` (RecurrentGemma's MQA: G 10 at head dim 256, N 256,
   window 2048), each against its plain version and timed; (d)
   ``ops.lora_grouped_ragged`` at OLMoE's expert shapes in tiles of 8 rows
   over ``RAGGED_SIZES`` (empty groups among them) in bf16, int8 and nf4:
   its forward, dx and dA/dB kernels against their plain versions, and the
   op end to end (one launch of each, its output the kernel's). (a), (b)
   both models at full width and depth through ``launch.train``: mesp_cuda,
   bf16, 1 x 256, 3 steps with exact counts (``recurrent_per_step``), the
   peak of one ``value_and_grad`` for mesp_cuda and mebp, the loss and
   LoRA gradients at full width over ``RECURRENT_GRAD_LAYERS`` layers
   against the plain backend (``compare_grads``, B at ``b_scale_for``),
   and 64 positions decoded single-stream in f32 against the forward
   (``decode_vs_forward``; RWKV6's plain path also whole in f64, its
   decode within ``DECODE_F64_TOL`` of its forward). (c) single-stream serving through
   ``launch.serve`` (``SINGLE_STREAM_RUNS``: RWKV6, RecurrentGemma,
   OLMoE-1B-7B over bf16 and nf4, qwen2.5-0.5b with ``--adapters 0``; 4
   sequences, 16 steps), exact counts a step (``decode_per_step``), ms a
   step and tokens/s.
21. The ``vlm`` and ``audio`` families (``vlm_audio_phase``): (a) the
   LoRA forward, dx and dA/dB at Whisper-tiny's three (K, N) at M 256
   (the text) and 1,500 (the frames), the forward at single-stream
   decode's M 4 and 6,000 (the cross-attention's k, v over 4 x 1,500
   frames), the nf4 forward and dx at Whisper's training shapes, all
   three at InternVL2-1B's four (K, N) at M 512 (256 patch
   embeddings and 256 tokens), both RMSNorm kernels at [256, 384], [1,500,
   384] and [512, 896], and the flash kernels at ``FLASH_VA_CASES``
   (non-causal 1,500 x 1,500 and 256 x 1,500 over 6 heads, causal 256 at
   G 1, causal 512 at G 7), each against its plain version and timed;
   (b) InternVL2-1B (256 patch embeddings from the seed ahead of 256
   tokens) and Whisper-tiny (1,500 frames from the seed, 256 tokens), and
   Whisper over ``--quantize nf4``, at full width and depth, mesp_cuda,
   batch 1, the step built as ``launch.train`` builds it, with exact
   counts (``va_per_step``), finite losses, the loss and LoRA gradients
   of every layer (the encoder's too) against the plain backend in bf16
   and f32 (``compare_grads``, B at ``b_scale_for``), and the peak of one
   ``value_and_grad``; (c) 64 positions decoded single-stream in f32
   against the forward (``decode_vs_forward``; Whisper with
   ``cache["enc_out"]`` its own encoder's output over the forward's
   frames, InternVL on text alone); (d) ``launch.serve --arch
   internvl2-1b --adapters 4`` (continuous: 168 grouped and 49 RMSNorm
   launches a decode step) and ``--arch whisper-tiny`` single-stream (4
   sequences: 40 dense LoRA forward and 13 RMSNorm launches a step), ms a
   step and tokens/s.
22. The autotuner and the data axis: (a) ``autotune_phase`` sweeps
   (``kernels/autotune.autotune``) the bf16 dense forward and dx over a
   bf16 and an nf4 base at qwen2.5-0.5b's seven linears at M 256 and
   Gemma3-12B's MLP at M 2048 (every split the hard limits allow, 1..8)
   and the grouped decode body at qwen2.5-0.5b's serve shapes, M 8 (every
   split x bn 64 / 128), each candidate held against its plain version
   (a refused one fails the phase: all are within the entries' limits)
   and timed by CUDA graph replays; beside each shape the heuristic's
   and the winner's plans and ms (warm in the sweep, cold by
   ``_time_ms``), ``torch.matmul``'s and the bound. The winners go to a
   temporary file (never into the repo) and into a fresh cache; every
   swept shape must be answered with its winner by ``choose_blocks``, and
   relaunched with no plan must hit the cache and give the bits of the
   winner's explicit launch; a lookup's host cost is timed (a cached
   plan, the heuristic, a fixed plan). The cache is
   left empty, so every other phase runs the heuristic's plans. (b)
   ``data_parallel_phase``: an ``nccl`` process group of world size 1 on
   a free local port and an explicit data mesh of one rank; qwen2.5-0.5b
   at full width, mesp_cuda, 1 x 256, 3 steps through the Trainer with
   the mesh (exact counts) and without one, bit for bit; ``to_bf16`` and
   ``topk_sparsify`` on the card's LoRA gradients against the CPU's, bit
   for bit. Step 20's RWKV6 check also reads 10 plain and 3 kernel
   forwards with weights nudged one ulp, the kernel path with the group
   norm swapped for the structured norm and with the LoRA linears swapped
   for the structured ones, and the f32 LoRA forward kernel and cuBLAS
   against f64 at RWKV6's shapes (``lora_f32_accuracy``).
23. The model axis (``tensor_parallel_phase``): the kernels at a rank's
   TP-2 shard shapes of qwen2.5-0.5b (``TP_LINEARS``: q [896, 448], k and
   v [896, 64], o [448, 896], gate and up [896, 2,432], down [2,432, 896]
   at M 256, bf16 and over int8 and nf4; RMSNorm over a rank's 128 rows;
   flash at G 7 over one KV head) against their plain versions and
   timed (``tp_shapes`` in the ``{"kernels"}`` line); the single process's
   peak of one ``value_and_grad``; then, every kernel built here first,
   two processes on the one card in a ``gloo`` group of CUDA tensors, a
   (data 1, model 2) mesh (``tensor_parallel_worker``): 3 mesp_cuda steps
   of full-width qwen2.5-0.5b at 1 x 256 over a bf16 and an nf4 base,
   each rank's counts a step the single process's, the bytes handed to
   the model axis equal to ``tp_model_axis_bytes``; the LoRA gradients of
   one ``value_and_grad`` gathered whole against the single process's
   plain bf16 and f32 ones (``GRAD_TOL``; the kernels in f32 within
   ``CATALOG_F32_GRAD_TOL``); each rank's peak beside the single
   process's; whether gloo takes CUDA tensors in ``all_gather_into_
   tensor`` and ``reduce_scatter_tensor``. Two ranks on one card check
   the shard shapes and the collectives; their times are not a
   tensor-parallel speed.

Prints one ``{"build"}``, ``{"kernels": [...]}``, ``{"serve": ...}``,
``{"serve_quant": ...}``, ``{"train": ...}``, ``{"train_paper": ...}``,
``{"train_quant": ...}``, ``{"train_moe": ...}``,
``{"train_moe_quant": ...}``, ``{"train_seq": ...}``, ``{"zo": ...}``,
``{"train_engines": ...}`` (with the run's seconds),
``{"core_flash": ...}``, ``{"trainer": ...}``, ``{"dense_catalog":
...}``, ``{"recurrent": ...}``, ``{"vlm_audio": ...}``, ``{"autotune":
...}``, ``{"data_parallel": ...}`` and ``{"tensor_parallel": ...}`` line
each, the card's name and power limit, and
last ``{"ok": true, "device": ...}``. Any mismatch or exception exits
non-zero. Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if __name__ == "__main__":
    # the port of this checkout (a script that imports this module puts
    # the port it measures on its own path)
    sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import get_config  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12         # outside the tensor cores
L2_BYTES = 50 * 2**20

# every kernel a wrapper counts launches of (ops.launch_counts' names)
KERNEL_NAMES = (
    "lora_fused_fwd", "lora_dx", "lora_dab", "rmsnorm_fwd", "rmsnorm_bwd",
    "lora_grouped_fwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
    "lora_fused_q", "lora_dx_q", "lora_fused_q4", "lora_dx_q4",
    "lora_grouped_q", "lora_grouped_q4", "lora_grouped_gemm",
    "lora_grouped_dx", "lora_grouped_dab", "lora_grouped_gemm_q",
    "lora_grouped_gemm_q4", "lora_grouped_dx_q", "lora_grouped_dx_q4",
    "rope_fwd")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# method -> (forward, dx) kernel over that base
QUANT_KERNELS = {"int8": ("lora_fused_q", "lora_dx_q"),
                 "int4": ("lora_fused_q4", "lora_dx_q4"),
                 "nf4": ("lora_fused_q4", "lora_dx_q4")}


def dense_linears(cfg):
    """(K, N) -> LoRA linears of that shape in a layer of a dense config:
    q, k and v, o, gate and up, down."""
    d, q, kv = cfg.d_model, cfg.q_size, cfg.kv_size
    out = {}
    for s, n in (((d, q), 1), ((d, kv), 2), ((q, d), 1), ((d, cfg.d_ff), 2),
                 ((cfg.d_ff, d), 1)):
        out[s] = out.get(s, 0) + n
    return out


def decode_shapes(cfg):
    """(K, N) -> grouped decode launches a decode step of a dense config:
    one a LoRA linear of every layer."""
    return {s: n * cfg.n_layers for s, n in dense_linears(cfg).items()}


def dense_shapes_per_step(cfg):
    """{kernel: {(K, N): launches a step}} of a dense config's LoRA
    kernels: every block's forward twice (torch.utils.checkpoint recomputes
    it in the backward), its backward once, block 0's q/k/v without dx
    (they take the frozen embedding through the frozen ln1: no input
    gradient, ctx.needs_input_grad)."""
    d = cfg.d_model
    no_dx = {(d, cfg.q_size): 1}
    no_dx[(d, cfg.kv_size)] = no_dx.get((d, cfg.kv_size), 0) + 2
    L = cfg.n_layers
    lin = dense_linears(cfg)
    return {"lora_fused_fwd": {s: 2 * n * L for s, n in lin.items()},
            "lora_dx": {s: n * L - no_dx.get(s, 0) for s, n in lin.items()},
            "lora_dab": {s: n * L for s, n in lin.items()}}


def dense_per_step(cfg, seq, quantize="none"):
    """Launches of every kernel a training step of a dense config at
    ``seq`` tokens over a base in ``quantize``'s format: the LoRA kernels
    of ``dense_shapes_per_step``; the RMSNorm forward for ln1 and ln2 twice
    a block (recompute) and the final norm, its backward for ln2 of every
    block, ln1 of blocks 1.. (block 0's input needs no gradient) and the
    final norm; from 64 query rows the flash kernels (forward twice a
    block, backward once; below, attention takes the structured sdpa)."""
    L = cfg.n_layers
    fwd, dx = QUANT_KERNELS.get(quantize, ("lora_fused_fwd", "lora_dx"))
    per = {k: sum(v.values()) for k, v in dense_shapes_per_step(cfg).items()}
    want = {k: 0 for k in KERNEL_NAMES}
    want.update({fwd: per["lora_fused_fwd"], dx: per["lora_dx"],
                 "lora_dab": per["lora_dab"], "rmsnorm_fwd": 4 * L + 1,
                 "rmsnorm_bwd": 2 * L})
    if seq >= 64:
        want.update({"flash_fwd": 2 * L, "flash_bwd_dq": L,
                     "flash_bwd_dkv": L})
    return want


#: qwen2.5-0.5b (configs/qwen2_5_0_5b.py), the model of steps 2-18
QWEN = get_config("qwen2.5-0.5b")
M, BM, R, RANK = 8, 2, 4, 8           # decode: 8 slots, tile 2, 4 adapters
D_MODEL, D_FF, KV = QWEN.d_model, QWEN.d_ff, QWEN.kv_size
N_LAYERS = QWEN.n_layers
# (K, N) -> grouped launches per decode step: q,o / k,v / gate,up / down
GROUPED_SHAPES = decode_shapes(QWEN)
RMS_PER_STEP = 2 * N_LAYERS + 1
GROUPED_PER_STEP = sum(GROUPED_SHAPES.values())
# bf16 against the plain version on the same inputs: both sum in f32 and
# round once to bf16, so they may differ by one bf16 step of the output
# (2^-8 relative, doubled for a flip of h's rounding) plus a small absolute
# floor for outputs near zero
KERNEL_TOL = dict(rtol=2.0 ** -6, atol=1e-2)
# logits after 24 bf16 layers, relative to the logits' largest magnitude:
# the plain functions and the kernels round at different points (bf16
# products, h and the delta rounded apart, vs f32 sums rounded once) and the
# differences grow through the layers (about 0.035 measured on an H100
# 80GB HBM3 at 700 W).
# Both are also held against the plain functions in f32: the kernels may be
# no further from those than twice the plain bf16 functions are.
LOGIT_TOL = 0.1

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 48, 4
TM = TRAIN_BATCH * TRAIN_SEQ          # rows through every linear: 192
# (K, N) -> LoRA linears of that shape in a layer: q,o / k,v / gate,up / down
LINEARS = dense_linears(QWEN)
# launches per training step of each LoRA kernel at each (K, N)
TRAIN_SHAPES = dense_shapes_per_step(QWEN)
# below 64 query rows no flash launch; a dense base runs no quantized
# kernel, training no grouped one, no path the standalone RoPE kernel
TRAIN_PER_STEP = dense_per_step(QWEN, TRAIN_SEQ)
# the paper's setting, where attention runs the flash kernels
PAPER_BATCH, PAPER_SEQ, PAPER_STEPS, ROPE_STEPS = 1, 256, 4, 2
N_HEADS, N_KV_HEADS = QWEN.n_heads, QWEN.n_kv_heads
HEAD_DIM = QWEN.resolved_head_dim
PAPER_PER_STEP = dense_per_step(QWEN, PAPER_SEQ)
# the LoRA and norm launches do not depend on seq
FLASH_PER_STEP = {k: PAPER_PER_STEP[k] for k in FLASH_KERNELS}
# the quantized base at the paper's setting: --quantize runs, 3 steps each
QUANT_RUNS, QUANT_STEPS = ("int8", "nf4"), 3
QM = PAPER_BATCH * PAPER_SEQ          # rows through every linear: 256
# the ragged odd-K case of the quantized kernels' check: (M, K, N)
QUANT_RAGGED = (50, 97, 131)
# the serve phase's command (step 3), and its --quantize runs (step 10)
SERVE_CMD = ["--arch", "qwen2.5-0.5b", "--engine", "mesp_cuda", "--device",
             "cuda", "--batch", str(M), "--tile", str(BM), "--adapters", "4",
             "--store-capacity", "4", "--requests", "8", "--prompt-len", "8",
             "--max-new", "16", "--max-len", "32", "--seed", "0"]
SERVE_QUANT_RUNS = ("int8", "nf4")
# method -> the grouped kernel over that base
GROUPED_Q_KERNELS = {"int8": "lora_grouped_q", "int4": "lora_grouped_q4",
                     "nf4": "lora_grouped_q4"}
# the decode path's routing of 4 tiles (repeated, non-contiguous slots)
PATH_GID = (3, 0, 3, 1)
# edges of the quantized grouped kernels' check: (M, bm, K, N, R, r, gid)
GROUPED_Q_EDGES = {
    "odd_k_ragged_n": (8, 2, 97, 131, 4, 8, PATH_GID),
    "odd_k_wide": (8, 2, 4863, 896, 4, 8, PATH_GID),
    "n130_rank3": (8, 2, 896, 130, 4, 3, (1, 2, 3, 0)),
    "rank16": (8, 2, 896, 896, 4, 16, PATH_GID),
    "rows16": (16, 2, 896, 128, 4, 8, (3, 0, 3, 1, 2, 2, 0, 1)),
    "gid_repeated": (8, 2, 896, 4864, 4, 8, (2, 2, 0, 2)),
    "bad_gid": (8, 2, 896, 896, 4, 8, (3, 7, 0, -1)),
}

# MoE training: full-width OLMoE-1B-7B at the paper's batch 1 x seq 256
MOE_ARCH, MOE_STEPS = "olmoe-1b-7b", 3
MOE_L, MOE_E, MOE_D, MOE_F = 16, 64, 2048, 1024
# capacity: 256 tokens x top-8 / 64 experts x 1.25 = 40 slots an expert,
# one tile of bm = 40 rows each (ops.grouped_bm)
MOE_C = MOE_BM = 40
# (K, N) -> {kernel: launches a step}: gate and up (d -> d_expert), down
# (d_expert -> d); every block's forward twice (remat), its backward once
MOE_SHAPES = {
    (MOE_D, MOE_F): {"lora_grouped_gemm": 4 * MOE_L,
                     "lora_grouped_dx": 2 * MOE_L,
                     "lora_grouped_dab": 2 * MOE_L},
    (MOE_F, MOE_D): {"lora_grouped_gemm": 2 * MOE_L,
                     "lora_grouped_dx": MOE_L, "lora_grouped_dab": MOE_L},
}
MOE_PER_STEP = {
    **{k: 0 for k in KERNEL_NAMES},
    # q, k, v, o through the dense LoRA kernels; block 0's q/k/v take the
    # frozen embedding (no dx)
    "lora_fused_fwd": 2 * 4 * MOE_L, "lora_dx": 4 * MOE_L - 3,
    "lora_dab": 4 * MOE_L,
    "rmsnorm_fwd": 4 * MOE_L + 1, "rmsnorm_bwd": 2 * MOE_L,
    "flash_fwd": 2 * MOE_L, "flash_bwd_dq": MOE_L, "flash_bwd_dkv": MOE_L,
    **{k: sum(per[k] for per in MOE_SHAPES.values())
       for k in ("lora_grouped_gemm", "lora_grouped_dx",
                 "lora_grouped_dab")},
}
# depth of the MoE gradient check at GRAD_TOL: over 16 random layers even
# the plain bf16 gradients part from the f32 ones by more than 1 (relative
# L2), with or without the same routing (PERF.md)
MOE_GRAD_LAYERS = 2
# at 16 layers, with the routing and each MoE block's input pinned to the
# kernel run's: the least cosine similarity of a LoRA leaf's gradient
# through the kernels to the plain bf16 one. The sound kernels read 0.9984
# or more, the grouped forward with the last 16 of K left out 0.9938 or
# less (scripts/profile_torch_grad_floor.py, PERF.md)
MOE_COS_FLOOR = 0.996
# edges of the grouped training kernels' check: (M, bm, K, N, E, r, gid)
MOE_EDGES = {
    "c13_padded_to_bm16": (4 * 16, 16, MOE_D, MOE_F, 4, 8, (0, 1, 2, 3)),
    "bm72_two_row_blocks": (4 * 72, 72, MOE_F, MOE_D, 4, 8, (0, 1, 2, 3)),
    "odd_k_n": (3 * 40, 40, 97, 131, 3, 8, (0, 1, 2)),
    "rank3": (4 * 40, 40, MOE_D, MOE_F, 4, 3, (0, 1, 2, 3)),
    "rank16": (4 * 40, 40, MOE_F, MOE_D, 4, 16, (3, 2, 1, 0)),
    "ragged_empty_group": (6 * 40, 40, 300, 130, 4, 8, (0, 0, 2, 2, 2, 3)),
    "bad_gid": (4 * 40, 40, 256, 192, 4, 8, (0, 70, 1, -1)),
    "split_group": (4 * 40, 40, 256, 192, 3, 8, (1, 0, 1, 2)),
}

# MoE over a quantized base (step 12): method -> CLI steps
MOE_QUANT_RUNS = {"nf4": 3, "int8": 2}
# method -> the grouped (forward, dx) training kernel over that base
GROUPED_TRAIN_Q = {"int8": ("lora_grouped_gemm_q", "lora_grouped_dx_q"),
                   "int4": ("lora_grouped_gemm_q4", "lora_grouped_dx_q4"),
                   "nf4": ("lora_grouped_gemm_q4", "lora_grouped_dx_q4")}
# the forward and dx see no split group (only dA/dB's reduction does)
MOE_Q_EDGES = {k: v for k, v in MOE_EDGES.items() if k != "split_group"}
# the RMSNorm forward's shapes: decode, the paper path's, OLMoE's
RMS_SHAPES = {"decode": (8, 896), "train": (256, 896), "olmoe": (256, 2048)}
# SHA-256 of the RMSNorm forward's output at RMS_SHAPES (rmsnorm_fwd_sha256)
# as the kernel gave them on an H100 before its row loads moved into
# csrc/rownorm.cuh, which it shares with the backward: that move must leave
# its bits as they were
RMS_FWD_SHA256 = {
    "decode/float32":
        "482046cec33cdad0443b41c6dc6904623c10112a340f8ac0f4a0ce2699830503",
    "decode/bfloat16":
        "f3a96e579abdf26625e95e685c6701d670f59e1c7f7c492aee786ec6a10397e2",
    "train/float32":
        "bcd1c55e7d8445dcc75e94ae24cebd7aa34626e023ccdd1ff9182771e8bfd020",
    "train/bfloat16":
        "8d6745c56ae35fb9943c5981b1a08735cbb2407cd2613d974652f10575540704",
    "olmoe/float32":
        "6daaeec380c1071b0f9067bad9365af5bca7618f6805132867f59511820e713d",
    "olmoe/bfloat16":
        "e4d712e5d1a14110c494aebafa6d735b88a94824335b45c79af5bb37c0847377"}
# the standalone RoPE kernel's check (step 13): x [B, N, H, D]
ROPE_CASES = {"qwen": (1, 256, 14, 64), "olmoe": (1, 256, 16, 128),
              "odd_n": (1, 255, 16, 128)}


def moe_quant_per_step(method):
    """Launches per MoE step with ``--quantize method``: step 11's, with
    the quantized forward and dx in place of the float ones, dense (q, k,
    v, o) and grouped (the experts); dA/dB keep ``lora_dab`` and
    ``lora_grouped_dab``, which never read W0."""
    fwd, dx = QUANT_KERNELS[method]
    gfwd, gdx = GROUPED_TRAIN_Q[method]
    return {**MOE_PER_STEP, "lora_fused_fwd": 0, "lora_dx": 0,
            "lora_grouped_gemm": 0, "lora_grouped_dx": 0,
            fwd: MOE_PER_STEP["lora_fused_fwd"], dx: MOE_PER_STEP["lora_dx"],
            gfwd: MOE_PER_STEP["lora_grouped_gemm"],
            gdx: MOE_PER_STEP["lora_grouped_dx"]}


def quant_per_step(method):
    """Launches per step with ``--quantize method``: the paper path's, with
    the quantized forward and dx in place of the dense ones (dA/dB keep
    ``lora_dab``, which never reads W0)."""
    fwd, dx = QUANT_KERNELS[method]
    return {**PAPER_PER_STEP, "lora_fused_fwd": 0, "lora_dx": 0,
            fwd: TRAIN_PER_STEP["lora_fused_fwd"],
            dx: TRAIN_PER_STEP["lora_dx"]}


# flash kernels vs their plain versions: bf16 in KERNEL_TOL's scheme with
# the absolute floor relative to each output's largest magnitude (p and ds
# are rounded to bf16 from f32 values whose summation order differs, so a
# rounding may fall the other way); f32 summation order only. lse is f32 in
# both and must be exactly -1e30 on the same rows.
FLASH_F32_TOL = dict(rtol=1e-4, atol=1e-4)
LSE_TOL = dict(rtol=1e-4, atol=1e-4)
# (B*Hkv, G, Nq, Nk, D, causal, window, rope): the path's shape and edges
FLASH_CASES = {
    "path": (2, 7, 256, 256, 64, True, 0, False),
    "path_rope": (2, 7, 256, 256, 64, True, 0, True),
    "window32": (2, 7, 256, 256, 64, True, 32, False),
    "non_causal": (2, 7, 256, 256, 64, False, 0, True),
    "ragged300": (2, 7, 300, 300, 64, True, 0, True),
    "nq_ne_nk": (2, 7, 200, 136, 64, True, 0, False),
    "dead_rows": (2, 7, 384, 128, 64, True, 64, False),
    "G1": (14, 1, 256, 256, 64, True, 0, False),
    "d40": (2, 7, 256, 256, 40, True, 32, True),
    "d128": (2, 7, 256, 256, 128, True, 0, True),
    # the 128 instance with D padded to 80; one row and one column past a
    # tile; the parallel dk/dv group sum under a window
    "d72": (2, 7, 256, 256, 72, True, 0, True),
    "nk65": (2, 7, 65, 65, 64, True, 0, False),
    "G7_window_rope": (2, 7, 256, 256, 64, True, 48, True),
    # dk/dv clusters of 8 blocks of 2 members each; 11 and 12 members over
    # 8 blocks (shares of 1 or 2), the second in the 128 instance
    "G16": (1, 16, 130, 130, 64, True, 0, True),
    "G11": (1, 11, 96, 96, 40, False, 0, False),
    "G12_d128": (1, 12, 128, 128, 128, True, 0, True),
    # OLMoE-1B-7B at batch 1 x seq 256: 16 heads of 128, one a kv head
    "olmoe": (16, 1, 256, 256, 128, True, 0, False),
}
# B of the value_and_grad comparison: nonzero, at the size B reaches when
# fine-tuned from zero
B_SCALE = 0.02
# LoRA gradients, relative L2 per leaf, kernels vs the plain bf16 backend:
# both round in bf16 at different points through 24 layers and back (see
# PERF.md for the measured distances). Both are also held against the f32
# plain backend: the kernels may be no further from it than twice the plain
# bf16 backend is (plus 1e-3 for leaves where both are very close).
GRAD_TOL = 0.5
LOSS_TOL = 1e-2


def _check_close(got, want, tol, what):
    import torch
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    if not bool(torch.isfinite(got).all()) or \
            not bool(torch.isfinite(want).all()) or bool((err > lim).any()):
        raise AssertionError(f"{what}: max |err| {float(err.max())} over "
                             f"tolerance {tol}")
    return float(err.max())


def _cold_sets(make, nbytes):
    """Enough copies of one input set that cycling through them streams
    more than 3x the L2 cache, so every launch finds its inputs cold."""
    n = max(2, math.ceil(3 * L2_BYTES / nbytes))
    first = make()
    clone = lambda t: {k: v.clone() for k, v in t.items()} \
        if isinstance(t, dict) else t.clone()     # a quantized W0 leaf
    return [first] + [tuple(clone(t) for t in first) for _ in range(n - 1)]


def _time_ms(fn, sets, calls=2000):
    """Device time of one call: a CUDA graph of one call per input set,
    replayed until about ``calls`` calls, timed with CUDA events (host
    launch cost excluded)."""
    import torch
    # one side stream for every timing: cuBLAS keeps a workspace for each
    # stream it has run on until the process ends
    s = getattr(_time_ms, "stream", None)
    if s is None:
        s = _time_ms.stream = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for args in sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for args in sets:
            fn(*args)
    g.replay()
    torch.cuda.synchronize()
    reps = max(1, calls // len(sets))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(sets))


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _sha256(t):
    """SHA-256 of a tensor's bytes (bf16 as its 16-bit patterns)."""
    import hashlib
    import torch
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _f32_decode_sha256(torch, make, call):
    """SHA-256 of the f32 decode output (the CUDA-core body, whose bits
    must not change) on one input set ``make()`` draws."""
    out = call(*make())
    torch.cuda.synchronize()
    return _sha256(out)


def check_grouped(torch, lg, shapes=GROUPED_SHAPES, seed=1, calls=2000):
    """The grouped decode forward against its plain version at ``shapes``
    ((K, N) -> launches a decode step; M rows in tiles of BM over R
    tenants), timed in bf16 (``calls`` calls a timing) beside its plain
    version, x @ W0 and the bound. Returns [shape figures]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gid = torch.tensor([3, 0, 3, 1], dtype=torch.int32, device="cuda")
    used = int(torch.unique(gid).numel())
    out = []
    for (K, N), per_step in shapes.items():
        def make(dtype=torch.bfloat16):
            rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
            return (rn(M, K).to(dtype), (rn(K, N) * K ** -0.5).to(dtype),
                    (rn(R, K, RANK) * RANK ** -0.5).to(dtype),
                    (rn(R, RANK, N) * 0.05).to(dtype), gid.clone())
        args = make()
        got = lg.lora_grouped(*args, 2.0, bm=BM)
        torch.cuda.synchronize()
        want = lg.lora_grouped_ref(*args, 2.0, bm=BM)
        err = _check_close(got, want, KERNEL_TOL,
                           f"lora_grouped_fwd K={K} N={N}")
        nbytes = 2 * (M * K + K * N + used * (K * RANK + RANK * N) + M * N) \
            + 4 * gid.numel()
        flops = 2 * M * K * N + 2 * M * K * RANK + 2 * M * RANK * N
        bound, by = _bound_ms(nbytes, flops)
        sets = _cold_sets(make, nbytes)
        call = lambda *a: lg.lora_grouped(*a, 2.0, bm=BM)
        out.append({
            "K": K, "N": N, "M": M, "bm": BM, "R": R, "r": RANK,
            "launches_per_decode_step": per_step, "max_abs_err": err,
            "ms": _time_ms(call, sets, calls),
            "plain_ms": _time_ms(
                lambda *a: lg.lora_grouped_ref(*a, 2.0, bm=BM), sets, calls),
            "library_ms": None,
            # context: x @ W0 alone over the same bf16 W0
            "matmul_ms": _time_ms(lambda x, w, a, b, g: torch.matmul(x, w),
                                  sets, calls),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops, "plan_bf16": lg.decode_plan(M, K, N, RANK, bm=BM),
            "f32_sha256": _f32_decode_sha256(
                torch, lambda: make(torch.float32), call)})
        del sets
    return out


def check_rmsnorm(torch, rn, d=D_MODEL, launches=RMS_PER_STEP, seed=2,
                  calls=2000):
    """The RMSNorm forward at decode, [M, d] (``launches`` a decode step),
    against its plain version in bf16, timed warm beside its plain version,
    ``F.rms_norm`` and the bound. Returns [shape figures]."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make():
        return ((torch.randn(M, d, generator=gen, device="cuda") * 3
                 ).bfloat16(),
                torch.randn(d, generator=gen, device="cuda").bfloat16())
    args = make()
    got = rn.rmsnorm(*args, 1e-6)
    torch.cuda.synchronize()
    err = _check_close(got, rn.rmsnorm_ref(*args, 1e-6), KERNEL_TOL,
                       f"rmsnorm_fwd [{M}, {d}]")
    nbytes = 2 * (2 * M * d + d)
    bound, by = _bound_ms(nbytes, 4 * M * d)
    # warm: at decode the norm's input was written by the step just before
    sets = [args] * 256
    return [{"M": M, "d": d, "launches_per_decode_step": launches,
             "max_abs_err": err,
             "ms": _time_ms(lambda x, w: rn.rmsnorm(x, w, 1e-6), sets, calls),
             "plain_ms": _time_ms(lambda x, w: rn.rmsnorm_ref(x, w, 1e-6),
                                  sets, calls),
             "library_ms": _time_ms(
                 lambda x, w: F.rms_norm(x, (d,), w, 1e-6), sets, calls),
             "bound_ms": bound, "bound_by": by, "bytes": nbytes,
             "flops": 4 * M * d}]


def rmsnorm_fwd_sha256(torch, rn):
    """{"shape/dtype": SHA-256 of the RMSNorm forward's output} at
    ``RMS_SHAPES`` in f32 and bf16, on inputs that numpy draws from fixed
    seeds (the same on every machine)."""
    import numpy as np
    out = {}
    for i, (shape, (M_, d)) in enumerate(RMS_SHAPES.items()):
        rng = np.random.default_rng(70 + i)
        x = torch.from_numpy(rng.standard_normal((M_, d), np.float32) * 3)
        w = torch.from_numpy(rng.standard_normal(d, np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            y = rn.rmsnorm(x.to(dtype).cuda(), w.to(dtype).cuda(), 1e-6)
            out[f"{shape}/{str(dtype)[6:]}"] = _sha256(y)
    return out


def kernel_entry(name, source, replaces, tpu_kernel, shapes, launches,
                 steps, step="decode", path=None, **extra):
    """One kernel's line entry: figures per ``step`` (decode or train; each
    shape's per-launch figure times its launches per step), shapes in
    full. ``launches``: {path: launches in that path's run}; ``steps``:
    the steps of ``path``'s run (by default the serve run for decode, the
    seq-48 training run for train)."""
    key = f"launches_per_{step}_step"
    path = path or {"decode": "serve"}.get(step, step)

    def per_step(field):
        vals = [s[field] for s in shapes]
        if any(v is None for v in vals):
            return None
        return sum(v * s[key] for v, s in zip(vals, shapes))
    t_bytes = sum(s["bytes"] * s[key] for s in shapes) / HBM_BYTES_PER_S
    t_ops = sum(s["flops"] * s[key] for s in shapes) / BF16_FLOPS_PER_S
    err = max(s["max_abs_err"] for s in shapes)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": sum(launches.values()), "launches_by_path": launches,
            key: launches[path] / steps,
            "max_abs_err": err, "max_err": err, "tol": KERNEL_TOL,
            "unit": f"ms per {step} step, bf16: per-launch time x launches "
                    "per step, summed over shapes",
            "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
            "library_ms": per_step("library_ms"),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **extra, "shapes": shapes}


# ---------------------------------------------------------------- training


def _train_cases(torch, gen, dtype, M_, K, N):
    """make() of the inputs of the LoRA kernels at one training shape:
    x [M, K], w0 [K, N], a [K, r], b [r, N] (nonzero), g [M, N]."""
    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        return tuple(t.to(dtype) for t in (
            rn(M_, K), rn(K, N) * K ** -0.5, rn(K, RANK) * RANK ** -0.5,
            rn(RANK, N) * 0.1, rn(M_, N)))
    return make


def _close_scaled(got, want, tol, what):
    """_check_close with the absolute floor relative to the output's
    largest magnitude (at least 1): dA and dB are sums over all 192 rows,
    and in bf16 a rounding of h or dh that falls the other way on one row
    moves that row's outputs by about one step of h's rounding times B."""
    scale = max(1.0, float(want.float().abs().max()))
    return _check_close(got, want, dict(rtol=tol["rtol"],
                                        atol=tol["atol"] * scale), what)


TRAIN_KERNELS = ("lora_fused_fwd", "lora_dx", "lora_dab", "rmsnorm_bwd")


def rms_bwd_library(torch, x, w, g):
    """One PyTorch call that computes the RMSNorm backward's dx on ``x, w,
    g`` [M, d], as a yardstick (the port calls none): (its name, its input
    sets for ``_time_ms``, the call). ``aten._fused_rms_norm_backward`` with
    ``rstd`` made by ``aten._fused_rms_norm`` outside the timed call; where
    this PyTorch lacks it on the card, ``F.rms_norm``'s forward and backward
    through autograd."""
    import torch.nn.functional as F
    d, aten = x.shape[1], torch.ops.aten
    try:
        rstd = aten._fused_rms_norm(x, [d], w, 1e-6)[1]
        aten._fused_rms_norm_backward(g, x, [d], rstd, w, [True, False])
        torch.cuda.synchronize()
    except (AttributeError, NotImplementedError, RuntimeError):
        xr = x.detach().requires_grad_(True)
        return ("F.rms_norm forward and backward (autograd)",
                [(xr, w, g)] * 256,
                lambda x, w, g: torch.autograd.grad(
                    F.rms_norm(x, (d,), w, 1e-6), x, g)[0])
    return ("aten._fused_rms_norm_backward", [(x, w, g, rstd)] * 256,
            lambda x, w, g, r: aten._fused_rms_norm_backward(
                g, x, [d], r, w, [True, False])[0])


def check_training_kernels(torch, lf, rn, M_=TM, linears=None, d=D_MODEL,
                           rms_bwd=TRAIN_PER_STEP["rmsnorm_bwd"], seed=3,
                           kernels=TRAIN_KERNELS, n_calls=2000):
    """The LoRA training kernels and the RMSNorm backward (those of
    ``kernels``) against their plain versions at a path's shapes, in bf16
    and f32 (f32: summation order only, rtol = atol = 1e-4); times, bounds
    and the matmul context in bf16. ``M_`` rows through every linear;
    ``linears``: {(K, N): {kernel: launches a step}} (by default the seq-48
    training path's, whose counts the paper path's equal); the norm over
    [M_, d], ``rms_bwd`` launches a step; ``n_calls`` calls a timing.
    Returns {kernel: [shape figures]}."""
    if linears is None:
        linears = {s: {k: v[s] for k, v in TRAIN_SHAPES.items()}
                   for s in LINEARS}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {k: [] for k in kernels}
    f32_tol = dict(rtol=1e-4, atol=1e-4)
    calls = {
        "lora_fused_fwd": (lambda x, w, a, b, g: lf.lora_fused(x, w, a, b),
                           lambda x, w, a, b, g: lf.lora_fused_ref(
                               x, w, a, b),
                           lambda x, w, a, b, g: torch.matmul(x, w)),
        "lora_dx": (lambda x, w, a, b, g: lf.lora_dx(g, w, a, b),
                    lambda x, w, a, b, g: lf.lora_dx_ref(g, w, a, b),
                    lambda x, w, a, b, g: torch.matmul(g, w.T)),
        # context: the two row contractions' shapes, x^T [K, M] by [M, r]
        # and [r, M] by g [M, N] (no single call computes dA/dB)
        "lora_dab": (lambda x, w, a, b, g: lf.lora_dab(x, g, a, b),
                     lambda x, w, a, b, g: lf.lora_dab_ref(x, g, a, b),
                     lambda x, w, a, b, g: (torch.mm(x.T, g[:, :RANK]),
                                            torch.mm(x[:, :RANK].T, g))),
    }
    calls = {k: v for k, v in calls.items() if k in kernels}
    for (K, N), per in linears.items():
        errs = {}
        for dtype, tol in ((torch.float32, f32_tol),
                           (torch.bfloat16, KERNEL_TOL)):
            args = _train_cases(torch, gen, dtype, M_, K, N)()
            for name, (kern, plain, _) in calls.items():
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                if name != "lora_dab":
                    got, want = (got,), (want,)
                errs[(name, dtype)] = max(
                    _close_scaled(u, v, tol,
                                  f"{name} {dtype} M={M_} K={K} N={N}")
                    for u, v in zip(got, want))
        make = _train_cases(torch, gen, torch.bfloat16, M_, K, N)
        base = 2 * (M_ * K + K * N + K * RANK + RANK * N + M_ * N)
        sets = _cold_sets(make, base)
        for name, (kern, plain, mm) in calls.items():
            if name == "lora_dab":   # reads x, g, A, B; writes dA, dB
                nbytes = 2 * (M_ * K + M_ * N + 2 * (K * RANK + RANK * N))
                flops = 4 * M_ * RANK * (K + N)
            else:   # reads x (or g), W0, A, B; writes y (or dx)
                nbytes, flops = base, (2 * M_ * K * N
                                       + 2 * M_ * RANK * (K + N))
            bound, by = _bound_ms(nbytes, flops)
            out[name].append({
                "K": K, "N": N, "M": M_, "r": RANK,
                "launches_per_train_step": per[name],
                "max_abs_err": errs[(name, torch.bfloat16)],
                "max_abs_err_f32": errs[(name, torch.float32)],
                "ms": _time_ms(kern, sets, n_calls),
                "plain_ms": _time_ms(plain, sets, n_calls),
                "library_ms": None,
                "matmul_ms": _time_ms(mm, sets, n_calls) if mm else None,
                "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                "flops": flops})
    if "rmsnorm_bwd" not in kernels:
        return out

    def make_rms(dtype=torch.bfloat16):
        rn_ = lambda *s: torch.randn(s, generator=gen, device="cuda")
        return ((rn_(M_, d) * 3).to(dtype), rn_(d).to(dtype),
                rn_(M_, d).to(dtype))
    errs = {}
    for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-5)),
                       (torch.bfloat16, KERNEL_TOL)):
        x, w, g = make_rms(dtype)
        dx, dw = rn.rmsnorm_bwd(x, w, g, 1e-6)
        torch.cuda.synchronize()
        wdx, wdw = rn.rmsnorm_bwd_ref(x, w, g, 1e-6)
        errs[dtype] = max(
            _check_close(dx, wdx, tol, f"rmsnorm_bwd {dtype} [{M_}, {d}]"),
            _close_scaled(dw, wdw, tol, f"rmsnorm_bwd dw {dtype} [{M_}, {d}]"))
    nbytes = 2 * (3 * M_ * d + d)
    bound, by = _bound_ms(nbytes, 10 * M_ * d)
    # the path asks for no dw (no norm weight trains): time it that way
    bwd = lambda x, w, g: rn.rmsnorm_bwd(x, w, g, 1e-6, need_dw=False)
    plain = lambda x, w, g: rn.rmsnorm_bwd_ref(x, w, g, 1e-6)[0]
    sets = [make_rms()] * 256     # warm: g was just written by the step
    lib_op, lib_sets, lib = rms_bwd_library(torch, *sets[0])
    lib_err = float((lib(*lib_sets[0]).float()
                     - plain(*sets[0]).float()).abs().max())
    out["rmsnorm_bwd"].append({
        "M": M_, "d": d, "launches_per_train_step": rms_bwd,
        "max_abs_err": errs[torch.bfloat16],
        "max_abs_err_f32": errs[torch.float32],
        "ms": _time_ms(bwd, sets, n_calls),
        "plain_ms": _time_ms(plain, sets, n_calls),
        "library_ms": _time_ms(lib, lib_sets, n_calls), "library_op": lib_op,
        "library_max_abs_err": lib_err, "bound_ms": bound, "bound_by": by,
        "bytes": nbytes, "flops": 10 * M_ * d})
    return out


def rmsnorm_train_shape(torch, rn, M_=TM, d=D_MODEL,
                        launches=TRAIN_PER_STEP["rmsnorm_fwd"], seed=4,
                        calls=2000):
    """The RMSNorm forward at a training shape [M_, d] (by default the
    seq-48 path's [192, 896]) against its plain version in f32 (rtol = atol
    = 1e-5) and bf16; times in bf16, warm."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-5)),
                       (torch.bfloat16, KERNEL_TOL)):
        x = (torch.randn(M_, d, generator=gen, device="cuda") * 3).to(dtype)
        w = torch.randn(d, generator=gen, device="cuda").to(dtype)
        errs[dtype] = _check_close(
            rn.rmsnorm(x, w, 1e-6), rn.rmsnorm_ref(x, w, 1e-6), tol,
            f"rmsnorm_fwd {dtype} [{M_}, {d}]")
    nbytes = 2 * (2 * M_ * d + d)
    bound, by = _bound_ms(nbytes, 4 * M_ * d)
    sets = [(x, w)] * 256
    return {"M": M_, "d": d, "launches_per_train_step": launches,
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32],
            "ms": _time_ms(lambda x, w: rn.rmsnorm(x, w, 1e-6), sets, calls),
            "plain_ms": _time_ms(lambda x, w: rn.rmsnorm_ref(x, w, 1e-6),
                                 sets, calls),
            "library_ms": _time_ms(
                lambda x, w: F.rms_norm(x, (d,), w, 1e-6), sets, calls),
            "bound_ms": bound, "bound_by": by}


# ------------------------------------------------------ quantized base

#: calls per timing of a quantized kernel or its plain version (each call
#: at the path's shapes takes a fraction of a millisecond)
QUANT_CALLS = 400


def _quant_cases(torch, quant, gen, dtype, method, M, K, N):
    """make() of the quantized kernels' inputs at one shape: x [M, K], the
    codes and scale of a random W0 [K, N] in ``method``'s format, a [K, r],
    b [r, N] (nonzero), g [M, N], and W0 dequantized to ``dtype`` (the
    operand of the matmul context)."""
    key = "q" if method == "int8" else "q4"

    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        leaf = quant.quantize_leaf(rn(K, N) * K ** -0.5, method)
        return (rn(M, K).to(dtype), leaf[key], leaf["scale"],
                (rn(K, RANK) * RANK ** -0.5).to(dtype),
                (rn(RANK, N) * 0.1).to(dtype), rn(M, N).to(dtype),
                quant.maybe_dequant(leaf, dtype))
    return make


def _quant_calls(torch, lq, lp4, method):
    """{kernel: (kernel, plain version, matmul context)}, each a call on
    the inputs of ``_quant_cases``."""
    if method == "int8":
        fwd, dx = lq.lora_fused_q, lq.lora_dx_q
        fwd_ref, dx_ref = lq.lora_fused_q_ref, lq.lora_dx_q_ref
    else:
        fwd, dx, fwd_ref, dx_ref = (
            functools.partial(f, method=method) for f in (
                lp4.lora_fused_q4, lp4.lora_dx_q4, lp4.lora_fused_q4_ref,
                lp4.lora_dx_q4_ref))
    f, d = QUANT_KERNELS[method]
    return {f: (lambda x, q, s, a, b, g, w: fwd(x, q, s, a, b),
                lambda x, q, s, a, b, g, w: fwd_ref(x, q, s, a, b),
                lambda x, q, s, a, b, g, w: torch.matmul(x, w)),
            d: (lambda x, q, s, a, b, g, w: dx(g, q, s, a, b),
                lambda x, q, s, a, b, g, w: dx_ref(g, q, s, a, b),
                lambda x, q, s, a, b, g, w: torch.matmul(g, w.T))}


def _quant_errors(torch, quant, calls, gen, method, M_, K, N):
    """The quantized kernels of ``calls`` (``_quant_calls``) against their
    plain versions at [M_, K] x [K, N] in f32 (summation order only, rtol =
    atol = 1e-4) and bf16. Returns {(kernel, dtype): max |err|}."""
    errs = {}
    for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)),
                       (torch.bfloat16, KERNEL_TOL)):
        args = _quant_cases(torch, quant, gen, dtype, method, M_, K, N)()
        for name, (kern, plain, _) in calls.items():
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            errs[(name, dtype)] = _close_scaled(
                got, want, tol, f"{name} {method} {dtype} M={M_} K={K} N={N}")
    return errs


def _quant_figures(torch, quant, calls, gen, method, M_, K, N, errs,
                   launches, n_calls=QUANT_CALLS):
    """{kernel: its figures at one shape}: bf16 times (cold) of the kernel,
    its plain version and the matmul context, bound and ``errs``;
    ``launches``: {kernel: launches a step}."""
    # reads x (or g), the codes, the scale, A and B; writes y (dx)
    codes = K * N if method == "int8" else (K + 1) // 2 * N
    nbytes = 2 * M_ * (K + N) + codes + 4 * N + 2 * (K * RANK + RANK * N)
    flops = 2 * M_ * K * N + 2 * M_ * RANK * (K + N)
    bound, by = _bound_ms(nbytes, flops)
    sets = _cold_sets(_quant_cases(torch, quant, gen, torch.bfloat16, method,
                                   M_, K, N), nbytes)
    return {name: {
        "K": K, "N": N, "M": M_, "r": RANK, "method": method,
        "launches_per_train_step": launches[name],
        "max_abs_err": errs[(name, torch.bfloat16)],
        "max_abs_err_f32": errs[(name, torch.float32)],
        "ms": _time_ms(kern, sets, n_calls),
        "plain_ms": _time_ms(plain, sets, n_calls),
        "library_ms": None, "matmul_ms": _time_ms(mm, sets, n_calls),
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops}
        for name, (kern, plain, mm) in calls.items()}


def check_quant_kernels(torch, quant, lq, lp4):
    """The quantized LoRA kernels against their plain versions for int8,
    int4 and nf4, in f32 (summation order only, rtol = atol = 1e-4) and
    bf16, at the paper path's shapes (M 256), OLMoE-1B-7B's q, k, v, o
    (M 256, 2048 x 2048) and the ragged odd-K case; times, bounds and the
    matmul context in bf16 at the paths' shapes. Returns ({(kernel,
    method): [shape figures]}, {(kernel, method): ragged-case errors},
    {(kernel, method): [OLMoE shape figures]})."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    # OLMoE's shape draws from its own generator: the others draw their
    # inputs as before it was added
    gen_moe = torch.Generator(device="cuda").manual_seed(13)
    figures, ragged, moe = {}, {}, {}
    for method in QUANT_KERNELS:
        calls = _quant_calls(torch, lq, lp4, method)
        for name in calls:
            figures[(name, method)] = []
            moe[(name, method)] = []
        for M_, K, N in [(QM, K, N) for K, N in LINEARS] + [
                QUANT_RAGGED, (QM, MOE_D, MOE_D)]:
            olmoe = (K, N) == (MOE_D, MOE_D)
            g_ = gen_moe if olmoe else gen
            errs = _quant_errors(torch, quant, calls, g_, method, M_, K, N)
            if (M_, K, N) == QUANT_RAGGED:
                for name in calls:
                    ragged[(name, method)] = {
                        "M": M_, "K": K, "N": N,
                        "max_abs_err": errs[(name, torch.bfloat16)],
                        "max_abs_err_f32": errs[(name, torch.float32)]}
                continue
            dense = {name: "lora_fused_fwd" if name.startswith("lora_fused")
                     else "lora_dx" for name in calls}
            launches = {name: moe_quant_per_step(method)[name] if olmoe
                        else TRAIN_SHAPES[dense[name]][(K, N)]
                        for name in calls}
            for name, f in _quant_figures(torch, quant, calls, g_, method,
                                          M_, K, N, errs, launches).items():
                (moe if olmoe else figures)[(name, method)].append(f)
    return figures, ragged, moe


# -------------------------------------------- serving over a quantized base


def _grouped_q_cases(torch, quant, gen, dtype, method, M_, K, N, R_, r,
                     gid):
    """make() of the quantized grouped kernels' inputs: x [M, K], the codes
    and scale of a random W0 [K, N] in ``method``'s format, a [R, K, r],
    b [R, r, N] (nonzero), gid, and W0 dequantized to ``dtype`` (the
    operand of the matmul context)."""
    key = "q" if method == "int8" else "q4"
    g = torch.tensor(gid, dtype=torch.int32, device="cuda")

    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        leaf = quant.quantize_leaf(rn(K, N) * K ** -0.5, method)
        return (rn(M_, K).to(dtype), leaf[key], leaf["scale"],
                (rn(R_, K, r) * r ** -0.5).to(dtype),
                (rn(R_, r, N) * 0.05).to(dtype), g.clone(),
                quant.maybe_dequant(leaf, dtype))
    return make


def _grouped_q_calls(torch, lg, method, bm):
    """(kernel, plain version, matmul context), each a call on the inputs
    of ``_grouped_q_cases``."""
    if method == "int8":
        kern, plain = lg.lora_grouped_q, lg.lora_grouped_q_ref
    else:
        kern, plain = (functools.partial(f, method=method) for f in (
            lg.lora_grouped_q4, lg.lora_grouped_q4_ref))
    return (lambda x, q, s, a, b, g, w: kern(x, q, s, a, b, g, 2.0, bm=bm),
            lambda x, q, s, a, b, g, w: plain(x, q, s, a, b, g, 2.0, bm=bm),
            lambda x, q, s, a, b, g, w: torch.matmul(x, w))


def check_nf4_codebook_rounding(torch, quant, lg, lp4):
    """In bf16 the kernel rounds nf4's codebook to bf16 before the product,
    as the reference's ``_unpack_tile`` does. With A = B = 0 at the widest
    decode shape its output must lie nearer the plain version (rounded
    codebook) than a product over the f32 codebook, which a kernel that
    skipped the rounding would match instead: the mean absolute difference
    to the first under a quarter of that to the second. Returns both."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    K, N = 896, 4864
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rn(M, K).to(torch.bfloat16)
    leaf = quant.quantize_leaf(rn(K, N) * K ** -0.5, "nf4")
    a = torch.zeros(R, K, RANK, dtype=torch.bfloat16, device="cuda")
    b = torch.zeros(R, RANK, N, dtype=torch.bfloat16, device="cuda")
    g = torch.tensor(PATH_GID, dtype=torch.int32, device="cuda")
    args = (x, leaf["q4"], leaf["scale"], a, b, g, 2.0)
    got = lg.lora_grouped_q4(*args, bm=BM, method="nf4").float()
    rounded = lg.lora_grouped_q4_ref(*args, bm=BM, method="nf4").float()
    w32 = lp4.unpack_weights(leaf["q4"], "nf4", torch.float32, K)
    unrounded = ((x.float() @ w32) * leaf["scale"]).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    out = {"mean_abs_diff_rounded": float((got - rounded).abs().mean()),
           "mean_abs_diff_unrounded": float((got - unrounded).abs().mean())}
    if not 4 * out["mean_abs_diff_rounded"] < out["mean_abs_diff_unrounded"]:
        raise AssertionError(f"lora_grouped_q4 nf4 bf16: the output is not "
                             f"nearer the bf16-rounded codebook: {out}")
    return out


def check_grouped_quant(torch, quant, lg):
    """The quantized grouped kernels against their plain versions for int8,
    int4 and nf4, in f32 (summation order only, rtol = atol = 1e-4) and
    bf16, at the decode shapes and the edges of ``GROUPED_Q_EDGES``: rows
    of a gid outside [0, R) must be NaN in both, the others close. Times,
    bounds and the matmul context in bf16 at the decode shapes. Returns
    ({method: [shape figures]}, {method: {edge: errors}})."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    f32_tol = dict(rtol=1e-4, atol=1e-4)
    figures, edges = {}, {}
    for method, name in GROUPED_Q_KERNELS.items():
        figures[method], edges[method] = [], {}
        cases = {(K, N): (M, BM, K, N, R, RANK, PATH_GID)
                 for K, N in GROUPED_SHAPES}
        cases.update(GROUPED_Q_EDGES)
        for case, (M_, bm, K, N, R_, r, gid) in cases.items():
            kern, plain, mm = _grouped_q_calls(torch, lg, method, bm)
            bad = torch.tensor([not 0 <= t < R_ for t in gid],
                               device="cuda").repeat_interleave(bm)
            errs = {}
            for dtype, tol in ((torch.float32, f32_tol),
                               (torch.bfloat16, KERNEL_TOL)):
                args = _grouped_q_cases(torch, quant, gen, dtype, method, M_,
                                        K, N, R_, r, gid)()
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                what = f"{name} {method} {dtype} {case}"
                for t in (got, want):
                    if not torch.equal(torch.isnan(t).all(1), bad):
                        raise AssertionError(f"{what}: NaN rows "
                                             f"{torch.isnan(t).all(1)}, "
                                             f"expected {bad}")
                errs[dtype] = _close_scaled(got[~bad], want[~bad], tol, what)
            if case not in GROUPED_SHAPES:
                edges[method][case] = {
                    "M": M_, "bm": bm, "K": K, "N": N, "R": R_, "r": r,
                    "gid": list(gid), "max_abs_err": errs[torch.bfloat16],
                    "max_abs_err_f32": errs[torch.float32]}
                continue
            # reads x, the codes, the scale, the A and B of the slots in use
            # and gid; writes y
            codes = K * N if method == "int8" else (K + 1) // 2 * N
            nbytes = 2 * M_ * K + codes + 4 * N \
                + 2 * len(set(gid)) * (K * r + r * N) + 2 * M_ * N \
                + 4 * len(gid)
            flops = 2 * M_ * K * N + 2 * M_ * K * r + 2 * M_ * r * N
            bound, by = _bound_ms(nbytes, flops)
            sets = _cold_sets(_grouped_q_cases(
                torch, quant, gen, torch.bfloat16, method, M_, K, N, R_, r,
                gid), nbytes)
            figures[method].append({
                "K": K, "N": N, "M": M_, "bm": bm, "R": R_, "r": r,
                "method": method,
                "launches_per_decode_step": GROUPED_SHAPES[(K, N)],
                "max_abs_err": errs[torch.bfloat16],
                "max_abs_err_f32": errs[torch.float32],
                "ms": _time_ms(kern, sets),
                "plain_ms": _time_ms(plain, sets, QUANT_CALLS),
                "library_ms": None, "matmul_ms": _time_ms(mm, sets),
                "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                "flops": flops,
                "plan_bf16": lg.decode_plan(M_, K, N, r, bm=bm),
                "f32_sha256": _f32_decode_sha256(torch, _grouped_q_cases(
                    torch, quant, gen, torch.float32, method, M_, K, N, R_,
                    r, gid), kern)})
            del sets
    return figures, edges


def _lora_bytes(tree, key=None):
    """Bytes of a parameter tree's LoRA factors (its a/b leaves)."""
    if isinstance(tree, dict):
        return sum(_lora_bytes(v, k) for k, v in tree.items())
    return tree.numel() * tree.element_size() if key in ("a", "b") else 0


def base_memory(torch, cfg):
    """Per base format (bf16, int8, nf4): what ``init_params`` leaves
    allocated on the card and the most it held while it ran, the bytes of
    its tensors, of its frozen ones (all but the LoRA factors) and of the
    seven linears' W0 (codes, scales and codebook), beside
    ``serve_residency``'s modelled ``weights_mb`` and ``total_mb`` with no
    adapter and no page resident (MB of 2^20 bytes)."""
    from repro_torch.core import quant
    from repro_torch.serve.residency import serve_residency
    out = {}
    for method in ("none",) + SERVE_QUANT_RUNS:
        fmt = quant.weights_format(method)
        modelled = serve_residency(cfg, rank=cfg.lora.rank,
                                   resident_adapters=0, kv_pages=0,
                                   page_size=16, batch=M, weights_fmt=fmt)
        out[fmt] = {**init_memory(torch, cfg, method),
                    "modelled_weights_mb": modelled["weights_mb"],
                    "modelled_weights_bytes": modelled["weights_mb"] * 2**20,
                    "modelled_total_mb": modelled["total_mb"]}
    return out


def init_memory(torch, cfg, method):
    """What ``init_params(cfg, quantize=method)`` leaves allocated on the
    card and the most it held while it ran (bytes above what was allocated
    before), the bytes of its tensors, of its frozen ones (all but the LoRA
    factors) and of its ``w`` leaves (codes, scales and codebooks)."""
    from repro_torch.core import quant
    from repro_torch.models import model as model_lib
    _release(torch)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        quantize=method)
    torch.cuda.synchronize()
    out = {"allocated_bytes": torch.cuda.memory_allocated() - before,
           "init_peak_bytes": torch.cuda.max_memory_allocated() - before,
           "params_bytes": quant.tree_bytes(p),
           "frozen_bytes": quant.tree_bytes(p) - _lora_bytes(p),
           "linear_w0_bytes": quant.tree_bytes(p, frozen_base=True)}
    del p
    return out


# ------------------------------------------------------- flash attention


def _flash_inputs(torch, gen, dtype, BHkv, G, nq, nk, D):
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda") * 0.7
    return tuple(t.to(dtype) for t in (rn(BHkv * G, nq, D), rn(BHkv, nk, D),
                                       rn(BHkv, nk, D), rn(BHkv * G, nq, D)))


def check_flash(torch, fa, rope_tables):
    """The flash kernels against their plain versions on every case of
    ``FLASH_CASES`` in f32 and bf16 (the backward's plain version from the
    kernel's own out and lse), dk/dv's bits on a repeated call; then their
    times in bf16 at the Qwen path's shape and at OLMoE's. Returns
    ({kernel: [Qwen shape figures]}, {kernel: OLMoE shape figures})."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = _flash_errors(torch, fa, rope_tables, gen, FLASH_CASES)
    qwen = _flash_times(torch, fa, gen, errs, FLASH_CASES["path"],
                        FLASH_PER_STEP)
    olmoe = _flash_times(torch, fa, gen, errs, FLASH_CASES["olmoe"],
                         {k: MOE_PER_STEP[k] for k in FLASH_PER_STEP})
    return qwen, {k: v[0] for k, v in olmoe.items()}


def _flash_errors(torch, fa, rope_tables, gen, cases):
    """The flash kernels against their plain versions on every case of
    ``cases`` in f32 and bf16 (the backward's plain version from the
    kernel's own out and lse), dk/dv's bits on a repeated call. Returns
    {(kernel, dtype): the largest error}."""
    errs = {(n, d): 0.0 for n in FLASH_PER_STEP
            for d in (torch.float32, torch.bfloat16)}
    for case, (BHkv, G, nq, nk, D, causal, window, rope) in cases.items():
        tabs = tuple(t.cuda() for t in rope_tables(
            torch.arange(nq), 10000.0, D)) if rope else None
        kw = dict(causal=causal, window=window, q_per_kv=G)
        for dtype in (torch.float32, torch.bfloat16):
            tol = FLASH_F32_TOL if dtype == torch.float32 else KERNEL_TOL
            what = f"{case} {dtype}"
            q, k, v, g = _flash_inputs(torch, gen, dtype, BHkv, G, nq, nk, D)
            out, lse = fa.flash_attention_fwd(q, k, v, tabs, return_lse=True,
                                              **kw)
            delta, gq = fa.bwd_delta(g, out), g.to(dtype)
            dq = fa.flash_bwd_dq(q, k, v, gq, lse, delta, tabs, **kw)
            dk, dv = fa.flash_bwd_dkv(q, k, v, gq, lse, delta, tabs, **kw)
            dk2, dv2 = fa.flash_bwd_dkv(q, k, v, gq, lse, delta, tabs, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                raise AssertionError(f"flash_bwd_dkv {what}: repeated "
                                     "calls differ")
            wout, wlse = fa.flash_attention_fwd_ref(q, k, v, tabs,
                                                    return_lse=True, **kw)
            if not torch.equal(lse == fa.NEG_INF, wlse == fa.NEG_INF):
                raise AssertionError(f"flash_fwd {what}: rows without a key "
                                     "differ from the plain version's")
            e = max(_close_scaled(out, wout, tol, f"flash_fwd out {what}"),
                    _check_close(lse, wlse, LSE_TOL, f"flash_fwd lse {what}"))
            errs[("flash_fwd", dtype)] = max(errs[("flash_fwd", dtype)], e)
            wdq = fa.flash_bwd_dq_ref(q, k, v, gq, lse, delta, tabs, **kw)
            e = _close_scaled(dq, wdq, tol, f"flash_bwd_dq {what}")
            errs[("flash_bwd_dq", dtype)] = max(errs[("flash_bwd_dq", dtype)],
                                                e)
            wdk, wdv = fa.flash_bwd_dkv_ref(q, k, v, gq, lse, delta, tabs,
                                            **kw)
            e = max(_close_scaled(dk, wdk, tol, f"flash_bwd_dkv dk {what}"),
                    _close_scaled(dv, wdv, tol, f"flash_bwd_dkv dv {what}"))
            errs[("flash_bwd_dkv", dtype)] = max(
                errs[("flash_bwd_dkv", dtype)], e)
    return errs


def _flash_times(torch, fa, gen, errs, shape, per_step, n_calls=2000):
    """The flash kernels' figures at ``shape`` (a ``FLASH_CASES`` tuple:
    Nq query rows over Nk keys, causal or not), bf16, with ``per_step``
    launches a step and the errors of ``_flash_errors``, ``n_calls`` calls
    a timing; warm: q, k, v were just written by the q/k/v linears, g by
    the o linear's backward."""
    import torch.nn.functional as F
    BHkv, G, N, Nk, D, causal, window, _ = shape
    BH = BHkv * G
    kw = dict(causal=causal, window=window, q_per_kv=G)
    q, k, v, g = _flash_inputs(torch, gen, torch.bfloat16, BHkv, G, N, Nk, D)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    delta = fa.bwd_delta(g, out)
    sets = [(q, k, v, g, lse, delta)] * 64
    # the pairs this mask leaves (the work depends on it) and the bytes of
    # each input read once and each output written once
    qp, kp = torch.arange(N)[:, None], torch.arange(Nk)[None]
    ok = qp >= kp if causal else torch.ones(N, Nk, dtype=torch.bool)
    if window:
        ok &= qp - kp < window
    pairs = BH * int(ok.sum())
    tile, kv, rows = 2 * BH * N * D, 2 * BHkv * Nk * D, 4 * BH * N
    work = {"flash_fwd": (2 * tile + 2 * kv + rows, 4 * D * pairs),
            "flash_bwd_dq": (3 * tile + 2 * kv + 2 * rows, 6 * D * pairs),
            "flash_bwd_dkv": (2 * tile + 4 * kv + 2 * rows, 8 * D * pairs)}
    calls = {
        "flash_fwd": (
            lambda q, k, v, g, l, d: fa.flash_attention_fwd(
                q, k, v, return_lse=True, **kw),
            lambda q, k, v, g, l, d: fa.flash_attention_fwd_ref(
                q, k, v, return_lse=True, **kw)),
        "flash_bwd_dq": (
            lambda q, k, v, g, l, d: fa.flash_bwd_dq(q, k, v, g, l, d, **kw),
            lambda q, k, v, g, l, d: fa.flash_bwd_dq_ref(q, k, v, g, l, d,
                                                         **kw)),
        "flash_bwd_dkv": (
            lambda q, k, v, g, l, d: fa.flash_bwd_dkv(q, k, v, g, l, d, **kw),
            lambda q, k, v, g, l, d: fa.flash_bwd_dkv_ref(q, k, v, g, l, d,
                                                          **kw)),
    }
    # the library yardstick, never called on the path: one PyTorch call,
    # forward, and forward plus backward through autograd
    q4, g4 = (t.view(1, -1, N, D) for t in (q, g))
    k4, v4 = (t.view(1, -1, Nk, D) for t in (k, v))
    mask = ok.cuda() if window else None     # a window takes a mask
    lib_fwd = lambda q, k, v, g: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    leaves = tuple(t.detach().clone().requires_grad_(True)
                   for t in (q4, k4, v4))

    def lib_fwd_bwd(q, k, v, g):
        return torch.autograd.grad(lib_fwd(q, k, v, g), (q, k, v), g)
    library = {"fwd_ms": _time_ms(lib_fwd, [(q4, k4, v4, g4)] * 64,
                                  n_calls),
               "fwd_bwd_ms": _time_ms(lib_fwd_bwd, [(*leaves, g4)] * 64,
                                      n_calls)}
    figures = {}
    for name, (kern, plain) in calls.items():
        nbytes, flops = work[name]
        bound, by = _bound_ms(nbytes, flops)
        figures[name] = [{
            "BH": BH, "BHkv": BHkv, "N": N, "Nk": Nk, "D": D,
            "causal": causal,
            "window": window, "dtype": "bfloat16",
            "launches_per_train_step": per_step[name],
            "max_abs_err": errs[(name, torch.bfloat16)],
            "max_abs_err_f32": errs[(name, torch.float32)],
            "ms": _time_ms(kern, sets, n_calls),
            "plain_ms": _time_ms(plain, sets, n_calls),
            "library_ms": library["fwd_ms"] if name == "flash_fwd" else None,
            "library_fwd_bwd_ms": library["fwd_bwd_ms"],
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops, "smem_bytes_bf16": _launched_smem(name, D)}]
    return figures


def _launched_smem(name, D):
    """The dynamic shared memory (bytes) of the bf16 kernel ``name``'s last
    launch at head dim ``D``, as the CUDA runtime holds it for the
    kernel."""
    import ctypes
    from repro_torch.kernels import _build
    lib = "flash_fwd" if name == "flash_fwd" else "flash_bwd"
    fn = _build.function(lib, name + "_smem",
                         [_build.C_INT, ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(-1)
    _build.check(lib, fn(D, ctypes.byref(n)), f"{name}_smem")
    return n.value


def _with_b(torch, tree, gen, scale=B_SCALE):
    """``tree`` with every LoRA B redrawn nonzero from ``gen`` at ``scale``
    (B = 0 at init would leave dA and the h@B term untested)."""
    if isinstance(tree, list):     # a hybrid's tail
        return [_with_b(torch, v, gen, scale) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _with_b(torch, v, gen, scale)
        elif k == "b":
            out[k] = (torch.randn(v.shape, generator=gen, device=v.device)
                      * scale).to(v.dtype)
        else:
            out[k] = v
    return out


def _grad_leaves(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        out = {}
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            out.update(_grad_leaves(v, f"{prefix}/{k}"))
        return out
    return {} if tree is None else {prefix: tree.float()}


def _grad_runs(torch, cfg, params, batch, quantize="none", wrap=None,
               f32_kernels=False):
    """One value_and_grad through the kernels, the plain backend in bf16
    and the plain backend in f32 (and with ``f32_kernels`` the kernels in
    f32), on the same (bf16-valued) weights, whose frozen base is in the
    ``quantize`` format; ``wrap(name, run)`` runs each (by default
    ``run()``). Returns ({run: loss}, {run: {leaf: grad}})."""
    import dataclasses
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.core import mesp
    # the f32 copy is made for its run and freed after it
    f32 = dataclasses.replace(cfg, dtype="float32")
    runs = {"kernels": ("cuda", cfg, lambda: params),
            "plain": ("plain", cfg, lambda: params),
            "f32": ("plain", f32, lambda: _f32(params))}
    if f32_kernels:
        runs["kernels_f32"] = ("cuda", f32, lambda: _f32(params))
    wrap = wrap or (lambda name, run: run())
    loss, grads = {}, {}
    for name, (backend, c, make) in runs.items():
        l, g = wrap(name, lambda: mesp.value_and_grad(
            make(), c, batch, policy=ExecutionPolicy(
                backend=backend, device="cuda", quantize=quantize)))
        loss[name], grads[name] = float(l), _grad_leaves(g)
        if not math.isfinite(loss[name]) or not all(
                bool(torch.isfinite(t).all()) for t in grads[name].values()):
            raise AssertionError(f"{name}: non-finite loss or gradient")
    return loss, grads


def _distances(torch, loss, grads):
    """The loss and the per-leaf relative L2 distances between the runs of
    ``_grad_runs``, with the worst leaf of each pair."""
    rel = lambda u, v: float(torch.linalg.vector_norm(u - v)
                             / torch.linalg.vector_norm(v))
    leaves = {}
    for path in grads["f32"]:
        k, p, f = (grads[n][path] for n in ("kernels", "plain", "f32"))
        leaves[path] = {"kernels_vs_plain": rel(k, p),
                        "kernels_vs_f32": rel(k, f),
                        "plain_vs_f32": rel(p, f),
                        "cos": {"kernels_vs_plain": _cos(torch, k, p),
                                "kernels_vs_f32": _cos(torch, k, f),
                                "plain_vs_f32": _cos(torch, p, f)}}
        if "kernels_f32" in grads:
            kf = grads["kernels_f32"][path]
            leaves[path]["kernels_f32_vs_f32"] = rel(kf, f)
            leaves[path]["cos"]["kernels_f32_vs_f32"] = _cos(torch, kf, f)
    loss_err = {"kernels_vs_plain": abs(loss["kernels"] - loss["plain"]),
                "kernels_vs_f32": abs(loss["kernels"] - loss["f32"]),
                "plain_vs_f32": abs(loss["plain"] - loss["f32"])}
    worst = {k: max(e[k] for e in leaves.values()) for k in
             next(iter(leaves.values())) if k != "cos"}
    return {"loss": loss, "loss_abs_err": loss_err, "worst": worst,
            "leaves": leaves}


def _cos(torch, u, v):
    """Cosine similarity of two gradients, 0 where either is zero."""
    nu, nv = torch.linalg.vector_norm(u), torch.linalg.vector_norm(v)
    if not float(nu) or not float(nv):
        return 0.0
    return float(torch.sum(u.double() * v.double()) / (nu.double()
                                                        * nv.double()))


def _check_loss(d):
    if d["loss_abs_err"]["kernels_vs_plain"] > LOSS_TOL * abs(
            d["loss"]["f32"]):
        raise AssertionError(f"losses differ: {d['loss']} (rtol {LOSS_TOL})")


def _check_grads(d, grad_tol=GRAD_TOL, n_leaves=14):
    """Per leaf, kernels vs plain bf16 within ``grad_tol`` and no further
    from f32 than twice the plain bf16 backend (+1e-3); the loss within
    ``LOSS_TOL``; ``n_leaves`` LoRA leaves (a dense model's 7 linears)."""
    bad = {path: e for path, e in d["leaves"].items()
           if e["kernels_vs_plain"] > grad_tol
           or e["kernels_vs_f32"] > 2 * e["plain_vs_f32"] + 1e-3}
    if bad or len(d["leaves"]) != n_leaves:
        raise AssertionError(
            f"LoRA gradients: kernels vs plain bf16 over {grad_tol}, or "
            f"further from f32 than twice the plain bf16 backend: {bad}; "
            f"all leaves: {d['leaves']}")
    _check_loss(d)


def compare_grads(torch, cfg, params, batch, quantize="none",
                  f32_tol=None, n_leaves=14):
    """The loss and LoRA gradients of the kernels against the plain backend
    in bf16 and f32 (``_grad_runs``), checked: per leaf, kernels vs plain
    bf16 within ``GRAD_TOL`` and no further from f32 than twice the plain
    bf16 backend (+1e-3); the loss within ``LOSS_TOL``; with ``f32_tol``
    also the kernels in f32 within ``f32_tol`` of the plain f32 run
    (``_check_f32_kernels``)."""
    d = _distances(torch, *_grad_runs(torch, cfg, params, batch, quantize,
                                      f32_kernels=f32_tol is not None))
    _check_grads(d, n_leaves=n_leaves)
    if f32_tol is not None:
        _check_f32_kernels(d, f32_tol)
    return d


def _top_k_patched(moe_lib, run, replay=None):
    """``run()`` with ``moe_lib.top_k`` wrapped: the expert ids of every
    call are kept, and with ``replay`` (the ids of an earlier run, in call
    order) each call takes those ids in place of its own choice, its
    weights gathered from its own probabilities. Returns (run's result,
    the ids)."""
    ids, top_k, queue = [], moe_lib.top_k, iter(replay or ())

    def patched(probs, k):
        if replay is None:
            vals, idx = top_k(probs, k)
        else:
            idx = next(queue)
            vals = probs.gather(-1, idx)
        ids.append(idx.detach().clone())
        return vals, idx
    moe_lib.top_k = patched
    try:
        out = run()
    finally:
        moe_lib.top_k = top_k
    if replay is not None and len(ids) != len(replay):
        raise AssertionError(f"{len(ids)} routings replayed, {len(replay)} "
                             "recorded")
    return out, ids


def _check_cosines(d):
    """Per leaf, the kernels' gradient at cosine ``MOE_COS_FLOOR`` or more
    from the plain bf16 one; the loss within ``LOSS_TOL``."""
    bad = {path: e["cos"] for path, e in d["leaves"].items()
           if e["cos"]["kernels_vs_plain"] < MOE_COS_FLOOR}
    if bad or len(d["leaves"]) != 14:
        raise AssertionError(
            f"LoRA gradients: kernels vs plain bf16 at cosine under "
            f"{MOE_COS_FLOOR}: {bad}; all leaves: {d['leaves']}")
    _check_loss(d)


def _check_f32_kernels(d, tol=GRAD_TOL):
    """Per leaf, the kernels' gradient in f32 within ``tol`` (relative L2)
    of the plain f32 one: the two differ in summation order alone, so at
    full depth, where bf16's roundings have grown into gradients of their
    own, this still tells a right gradient from a wrong one."""
    bad = {path: e["kernels_f32_vs_f32"] for path, e in d["leaves"].items()
           if not e["kernels_f32_vs_f32"] <= tol}
    if bad or len(d["leaves"]) != 14:
        raise AssertionError(
            f"LoRA gradients: f32 kernels vs plain f32 over {tol}: "
            f"{bad}; all leaves: {d['leaves']}")


def _blocks_pinned(run, replay=None):
    """``run()`` with every MoE block's input recorded in call order (the
    forward's, then each remat recompute's), or, given ``replay``, each
    replaced in value by the recorded one of the same call, its gradient
    passed through unchanged. Returns (the result, the inputs)."""
    from repro_torch.models import model as model_lib
    block = model_lib.moe_block
    xs, queue = [], None if replay is None else iter(replay)

    def pinned(bp, x, cfg, **kw):
        if queue is None:
            xs.append(x.detach().clone())
        else:
            x = x + (next(queue).to(x.dtype) - x).detach()
        return block(bp, x, cfg, **kw)
    model_lib.moe_block = pinned
    try:
        out = run()
    finally:
        model_lib.moe_block = block
    if queue is not None and next(queue, None) is not None:
        raise AssertionError("fewer MoE blocks ran than were recorded")
    return out, xs


def grads_moe(torch, moe_lib, cfg, params, batch, grad_tol=None,
              quantize="none"):
    """The runs of ``compare_grads_moe`` and their distances, unchecked but
    for the routing of each recompute (``routing_differences``). Two bf16
    implementations route some tokens to other experts, and with random
    weights a moved token moves others layer by layer (``PERF.md``). So:
    (1) each run routes freely, and the routing differences per layer are
    counted (``free_routing``); (2) every run takes the kernel run's expert
    ids (its weights from its own router probabilities), so the gradients
    differ by arithmetic alone. With ``grad_tol`` None (full depth) the
    kernels also run in f32, and every MoE block of the plain bf16 run takes
    the bf16 kernel run's block input as its value (``_blocks_pinned``), so
    each block's gradient differs by its own arithmetic alone: unpinned, a
    bf16 rounding that falls the other way in one layer grows layer by
    layer until two right bf16 paths are about unrelated (the plain bf16
    gradients at cosine 0.007-0.2 from the f32 ones). The f32 runs keep
    their own block inputs, so the f32 kernels answer for all the layers.
    The frozen base is in the ``quantize`` format."""
    ids, xs = {}, {}

    def free(name, run):
        out, ids[name] = _top_k_patched(moe_lib, run)
        return out

    def pin(name, run):
        route = lambda: _top_k_patched(moe_lib, run, ids["kernels"])[0]
        if grad_tol is not None or name not in ("kernels", "plain"):
            return route()
        if name == "kernels":
            out, xs["kernels"] = _blocks_pinned(route)
            return out
        return _blocks_pinned(route, xs["kernels"])[0]
    loose = _distances(torch, *_grad_runs(torch, cfg, params, batch,
                                          quantize, wrap=free))
    loose["routing"] = routing_differences(torch, ids, cfg.n_layers)
    pinned = _distances(torch, *_grad_runs(
        torch, cfg, params, batch, quantize, wrap=pin,
        f32_kernels=grad_tol is None))
    return {**pinned, "layers": cfg.n_layers, "grad_tol": grad_tol,
            "f32_kernels_tol": GRAD_TOL if grad_tol is None else None,
            "cos_floor": MOE_COS_FLOOR if grad_tol is None else None,
            "routing_pinned_to": "kernels",
            "bf16_block_inputs_pinned_to": "kernels" if grad_tol is None
            else None, "free_routing": loose}


def compare_grads_moe(torch, moe_lib, cfg, params, batch, grad_tol=None,
                      quantize="none"):
    """``compare_grads`` for an MoE model, over the runs of ``grads_moe``:
    the freely routed losses within ``LOSS_TOL``; with ``grad_tol`` the
    pinned gradients as ``_check_grads`` checks them; with ``grad_tol``
    None (full depth) the f32 kernels against the plain f32 run at
    ``GRAD_TOL`` (``_check_f32_kernels``, every layer's error carried
    through the rest) and the bf16 kernels against the plain bf16 run,
    block inputs pinned, at cosine ``MOE_COS_FLOOR`` (``_check_cosines``)."""
    d = grads_moe(torch, moe_lib, cfg, params, batch, grad_tol, quantize)
    _check_loss(d["free_routing"])
    if grad_tol is not None:
        _check_grads(d, grad_tol)
    else:
        _check_f32_kernels(d)
        _check_cosines(d)
    return d


def _release(torch):
    """Free what earlier phases left for the collector (the timing graphs
    and their inputs), so a peak reads the phase's own memory."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()


ENGINE_NAMES = ("mesp_cuda", "mesp", "mebp", "store_h")


def peak_memory(torch, cfg, params, batch, runs=None, quantize="none"):
    """Peak allocated bytes of one value_and_grad per (engine, remat) of
    ``runs`` (by default each engine with remat on) over a frozen base in
    the ``quantize`` format, and above what was allocated before it
    (weights, batch). Keys: the engine, with "/remat_off" appended when
    remat is off."""
    from repro_torch.api.engines import ENGINES
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.core import mesp
    out = {}
    for engine, remat in runs or [(e, True) for e in ENGINE_NAMES]:
        _release(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, grads = mesp.value_and_grad(
            params, cfg, batch,
            policy=ExecutionPolicy(backend=ENGINES[engine], device="cuda",
                                   remat=remat, quantize=quantize))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        key = engine if remat else f"{engine}/remat_off"
        out[key] = {"peak_bytes": peak, "above_start_bytes": peak - base,
                    "start_bytes": base}
        del loss, grads
    return out


def _f32(tree):
    """Floating leaves in f32; a quantized leaf's integer codes stay as
    they are (the f32 run dequantizes the same bytes to f32)."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):     # a hybrid's tail
        return [_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def compare_logits(torch, cfg, params, steps=4, quantize="none"):
    """The first ``steps`` steps (all prefill: fixed inputs) through the
    kernels, through the plain functions, and through the plain functions
    in f32 on the same (bf16-valued) params and adapters, whose frozen base
    is in the ``quantize`` format (the f32 run dequantizes the same codes
    to f32). Returns the worst relative differences {kernels vs plain,
    kernels vs f32, plain vs f32}, each over the f32 logits' largest
    magnitude."""
    import dataclasses
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.launch.serve import request_trace
    from repro_torch.serve import (AdapterStore, ContinuousBatcher,
                                   synthetic_adapters)
    uids = [f"tenant{i}" for i in range(4)]
    adapters = {u: synthetic_adapters(params, i) for i, u in enumerate(uids)}
    runs = {"cuda": (cfg, params, adapters),
            "structured": (cfg, params, adapters),
            "f32": (dataclasses.replace(cfg, dtype="float32"), _f32(params),
                    {u: _f32(t) for u, t in adapters.items()})}
    logits = {}
    for name, (c, p, ads) in runs.items():
        backend = "cuda" if name == "cuda" else "structured"
        bat = ContinuousBatcher(
            c, AdapterStore(p, capacity=4), slots=M, tile=BM, max_len=32,
            page_size=16,
            policy=ExecutionPolicy(backend=backend, device="cuda",
                                   quantize=quantize))
        for u in uids:
            bat.register_adapter(u, ads[u])
        for req in request_trace(8, uids, 8, 16):
            bat.submit(req)
        logits[name] = []
        for _ in range(steps):
            bat.step()
            got = bat.last_logits.float().clone()
            if got.shape != (M, 1, cfg.vocab) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name}: bad logits {tuple(got.shape)}")
            logits[name].append(got)
        del bat
    worst = {"kernels_vs_plain": 0.0, "kernels_vs_f32": 0.0,
             "plain_vs_f32": 0.0}
    for s in range(steps):
        ref = logits["f32"][s]
        scale = float(ref.abs().max())
        rel = lambda u, v: float((u - v).abs().max()) / scale
        step = {"kernels_vs_plain": rel(logits["cuda"][s],
                                        logits["structured"][s]),
                "kernels_vs_f32": rel(logits["cuda"][s], ref),
                "plain_vs_f32": rel(logits["structured"][s], ref)}
        if step["kernels_vs_plain"] > LOGIT_TOL:
            raise AssertionError(f"step {s}: kernels and plain functions "
                                 f"differ: {step} (tolerance {LOGIT_TOL})")
        if step["kernels_vs_f32"] > 2 * step["plain_vs_f32"] + 1e-3:
            raise AssertionError(f"step {s}: the kernels are further from "
                                 f"the f32 logits than the plain bf16 "
                                 f"functions: {step}")
        worst = {k: max(worst[k], v) for k, v in step.items()}
    return worst


# ------------------------------------------ MoE training over expert stacks

#: calls per timing of a grouped training kernel or its plain version (a
#: kernel call at the path's shapes takes 0.05 to 1 ms, a plain one
#: several: each gathers every tile's W0 and widens it to f32)
MOE_CALLS = 200
#: the bf16 grouped forward's W0 formats by their ``wfmt::WFmt`` values
#: (``csrc/wfmt.cuh``), as ``lora_grouped_gemm_smem`` takes them and the
#: kernel's template arguments show them in the build log
TC_FORMATS = {"dense": 0, "int8": 1, "int4": 2, "nf4": 3}


def _moe_cases(torch, gen, dtype, M_, K, N, E, r, gid):
    """make() of the grouped training kernels' inputs: x [M, K], W0 [E, K, N],
    a [E, K, r], b [E, r, N] (nonzero), g [M, N], gid int32 on the card."""
    gid = torch.tensor(gid, dtype=torch.int32, device="cuda")

    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        return tuple(t.to(dtype) for t in (
            rn(M_, K), rn(E, K, N) * K ** -0.5, rn(E, K, r) * r ** -0.5,
            rn(E, r, N) * 0.1, rn(M_, N))) + (gid.clone(),)
    return make


def _moe_calls(torch, lg, bm):
    """{kernel: (kernel, plain version, product context or None)}, each a
    call on the inputs of ``_moe_cases`` with tiles of ``bm`` rows."""
    def per_expert(t, w):      # [M, ·] rows as [E, M / E, ·]
        return t.view(w.shape[0], -1, t.shape[1])
    return {
        "lora_grouped_gemm": (
            lambda x, w, a, b, g, gid: lg.lora_grouped_gemm(
                x, w, a, b, gid, 2.0, bm=bm),
            lambda x, w, a, b, g, gid: lg.lora_grouped_gemm_ref(
                x, w, a, b, gid, 2.0, bm=bm),
            lambda x, w, a, b, g, gid: torch.bmm(per_expert(x, w), w)),
        "lora_grouped_dx": (
            lambda x, w, a, b, g, gid: lg.lora_grouped_dx(
                g, w, a, b, gid, 2.0, bm=bm),
            lambda x, w, a, b, g, gid: lg.lora_grouped_dx_ref(
                g, w, a, b, gid, 2.0, bm=bm),
            lambda x, w, a, b, g, gid: torch.matmul(per_expert(g, w), w.mT)),
        # context: per expert, the two row contractions' shapes
        "lora_grouped_dab": (
            lambda x, w, a, b, g, gid: lg.lora_grouped_dab(
                x, g, a, b, gid, 2.0, bm=bm),
            lambda x, w, a, b, g, gid: lg.lora_grouped_dab_ref(
                x, g, a, b, gid, 2.0, bm=bm),
            lambda x, w, a, b, g, gid: (
                torch.bmm(per_expert(x, w).mT, per_expert(g, w)[..., :RANK]),
                torch.bmm(per_expert(x, w)[..., :RANK].mT,
                          per_expert(g, w))))}


def _moe_errors(torch, lg, make_for, bm, what):
    """Each grouped training kernel against its plain version on the inputs
    of ``make_for(dtype)``, in f32 (summation order only: 1e-5 relative,
    the absolute floor relative to the output's largest magnitude) and in
    bf16 (``KERNEL_TOL``, floored the same way). NaN must fall on the same
    entries in both. Returns {(kernel, dtype name): max |err|}."""
    errs = {}
    for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-5)),
                       (torch.bfloat16, KERNEL_TOL)):
        args = make_for(dtype)()
        for name, (kern, plain, _) in _moe_calls(torch, lg, bm).items():
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            if name != "lora_grouped_dab":
                got, want = (got,), (want,)
            worst = 0.0
            for u, v in zip(got, want):
                if not torch.equal(u.isnan(), v.isnan()):
                    raise AssertionError(f"{name} {what} {dtype}: NaN on "
                                         "other entries than the plain "
                                         "version's")
                ok = ~v.isnan()
                if bool(ok.any()):
                    worst = max(worst, _close_scaled(
                        u[ok], v[ok], tol, f"{name} {what} {dtype}"))
            errs[(name, str(dtype).split(".")[-1])] = worst
    return errs


def check_grouped_train(torch, lg):
    """The three grouped training kernels against their plain versions in
    f32 and bf16 at the MoE path's shapes (E 64, C 40: M 2,560 rows in tiles
    of 40; (K, N) of gate/up and of down; r 8) and at ``MOE_EDGES``; times,
    bounds and the batched-product context in bf16 at the path's shapes,
    inputs cold. Returns ({kernel: [shape figures]}, {edge: errors})."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    figures = {k: [] for k in ("lora_grouped_gemm", "lora_grouped_dx",
                               "lora_grouped_dab")}
    path_gid = [e for e in range(MOE_E) for _ in range(MOE_C // MOE_BM)]
    M_, r = MOE_E * MOE_C, RANK
    for (K, N), per in MOE_SHAPES.items():
        errs = _moe_errors(
            torch, lg, lambda dt: _moe_cases(torch, gen, dt, M_, K, N, MOE_E,
                                             r, path_gid), MOE_BM,
            f"K={K} N={N}")
        T = len(path_gid)
        stacks = MOE_E * (K * N + K * r + r * N)
        work = {   # (bytes: inputs once, outputs once; FLOPs)
            "lora_grouped_gemm": (2 * (M_ * K + stacks + M_ * N) + 4 * T,
                                  2 * M_ * K * N + 2 * M_ * r * (K + N)),
            "lora_grouped_dx": (2 * (M_ * N + stacks + M_ * K) + 4 * T,
                                2 * M_ * K * N + 2 * M_ * r * (K + N)),
            "lora_grouped_dab": (
                2 * (M_ * (K + N) + 2 * MOE_E * r * (K + N)) + 4 * T,
                4 * M_ * r * (K + N))}
        make = _moe_cases(torch, gen, torch.bfloat16, M_, K, N, MOE_E, r,
                          path_gid)
        sets = _cold_sets(make, 2 * (stacks + M_ * (K + N)))
        for name, (kern, plain, mm) in _moe_calls(torch, lg,
                                                  MOE_BM).items():
            nbytes, flops = work[name]
            bound, by = _bound_ms(nbytes, flops)
            figures[name].append({
                "K": K, "N": N, "M": M_, "E": MOE_E, "C": MOE_C, "bm": MOE_BM,
                "r": r, "launches_per_train_step": per[name],
                "max_abs_err": errs[(name, "bfloat16")],
                "max_abs_err_f32": errs[(name, "float32")],
                "ms": _time_ms(kern, sets, MOE_CALLS),
                "plain_ms": _time_ms(plain, sets, MOE_CALLS),
                "library_ms": None,
                "matmul_ms": _time_ms(mm, sets, MOE_CALLS) if mm else None,
                "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                "flops": flops})
        del sets
    edges = {}
    for case, (M_, bm, K, N, E, r, gid) in MOE_EDGES.items():
        errs = _moe_errors(
            torch, lg, lambda dt: _moe_cases(torch, gen, dt, M_, K, N, E, r,
                                             gid), bm, case)
        edges[case] = {"M": M_, "bm": bm, "K": K, "N": N, "E": E, "r": r,
                       "gid": list(gid),
                       **{f"{k}/{d}": v for (k, d), v in errs.items()}}
    return figures, edges


def grouped_tc_figures(build, formats, bm=MOE_BM, body="fwd"):
    """The bf16 grouped forward's (``body`` "fwd") or dx's ("dx") build and
    launch figures for each W0 format of ``formats``: registers and spills
    of each instance (``MF`` m16 row fragments), parsed from this run's
    ``nvcc -Xptxas -v`` log, and the dynamic shared memory (bytes) that the
    CUDA runtime holds for the instance of tiles of ``bm`` rows after its
    last launch (``lora_grouped_gemm_smem``, ``lora_grouped.dx_plan``)."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import lora_grouped as lg
    fn = _build.function("lora_grouped_train", "lora_grouped_gemm_smem",
                         [_build.C_INT, _build.C_INT,
                          ctypes.POINTER(ctypes.c_int)])
    ptx, smem = {}, {}
    for fmt in formats:
        ptx[fmt] = {}
        for kern, figs in build["lora_grouped_train"]["ptxas"].items():
            m = re.search(rf"grouped_{body}_tcILi(\d)ELN4wfmt4WFmtE(\d)E",
                          kern)
            if m and int(m.group(2)) == TC_FORMATS[fmt]:
                ptx[fmt][f"MF{m.group(1)}"] = figs
        if not ptx[fmt]:
            raise AssertionError(f"no ptxas figures for the bf16 grouped "
                                 f"{body} over {fmt} in the build log")
        if body == "dx":
            plan = lg.dx_plan(torch.bfloat16,
                              "none" if fmt == "dense" else fmt, bm=bm)
            if not plan["tensor_cores"]:
                raise AssertionError(f"the bf16 grouped dx over {fmt} does "
                                     f"not run on tensor cores: {plan}")
            smem[fmt] = plan["smem_bytes"]
            continue
        n = ctypes.c_int(-1)
        _build.check("lora_grouped_train",
                     fn(TC_FORMATS[fmt], bm, ctypes.byref(n)),
                     "lora_grouped_gemm_smem")
        smem[fmt] = n.value
    return {"ptxas_bf16": ptx, "smem_bytes_bf16": smem,
            "smem_bm": bm}


def decode_tc_figures(build, fmt):
    """The bf16 decode body's registers and spills (``BN``: its column
    tile, 32 or 64) over W0 format ``fmt`` ("dense", "int8", "int4",
    "nf4"), parsed from this run's ``nvcc -Xptxas -v`` log of
    ``lora_grouped_fwd``."""
    ptx = {}
    for kern, figs in build["lora_grouped_fwd"]["ptxas"].items():
        m = re.search(r"decode_fwd_tcILi(\d+)ELN4wfmt4WFmtE(\d)E", kern)
        if m and int(m.group(2)) == TC_FORMATS[fmt]:
            ptx[f"BN{m.group(1)}"] = figs
    if not ptx:
        raise AssertionError(f"no ptxas figures for the bf16 decode body "
                             f"over {fmt} in the build log")
    return ptx


# the dense forward's and dx's libraries by base format (lora_fused's
# forward_plan / dx_plan names)
DENSE_TC_LIBS = {"fwd": {"none": "lora_fused_fwd", "int8": "lora_quant",
                         "int4": "lora_pack4", "nf4": "lora_pack4"},
                 "dx": {"none": "lora_dx", "int8": "lora_quant",
                        "int4": "lora_pack4", "nf4": "lora_pack4"}}


def dab_tc_figures(build, lib, plans):
    """The bf16 dA/dB body's build and launch figures: registers and spills
    of each instance (``RM``: the rank rounded up to 8, 16 or 32), parsed
    from this run's ``nvcc -Xptxas -v`` log of ``lib``, and ``plans``, its
    plan at each shape ({shape: ``dab_plan``}: members C of a cluster,
    sub-runs S, passes Q, row fragments, slabs, dynamic shared memory,
    workspace and counts)."""
    ptx = {}
    for kern, figs in build[lib]["ptxas"].items():
        m = re.search(r"dab_tcILi(\d+)E", kern)
        if m:
            ptx[f"RM{m.group(1)}"] = figs
    if not ptx:
        raise AssertionError(f"no ptxas figures for the bf16 dA/dB body in "
                             f"{lib}'s build log")
    return {"ptxas_bf16": ptx, "plan_bf16": plans}


def dense_tc_figures(build, lf, methods, shapes, body="fwd"):
    """The bf16 dense forward's (``body`` "fwd") or dx's ("dx") build and
    launch figures over each base format of ``methods`` ("none": bf16):
    registers and spills of each instance (``MF`` m16 row fragments),
    parsed from this run's ``nvcc -Xptxas -v`` log, and at each (M, K, N)
    of ``shapes`` its split of the contraction (the blocks of a tile's
    cluster: K in the forward, N in dx) and the dynamic shared memory
    (bytes) the CUDA runtime holds for the instance that M selects
    (``lora_fused.forward_plan`` / ``dx_plan``)."""
    ptx, plan = {}, {}
    planner = lf.forward_plan if body == "fwd" else lf.dx_plan
    for method in methods:
        fmt = TC_FORMATS["dense" if method == "none" else method]
        ptx[method] = {}
        for kern, figs in build[DENSE_TC_LIBS[body][method]]["ptxas"].items():
            m = re.search(rf"dense_{body}_tcILi(\d)ELN4wfmt4WFmtE(\d)E", kern)
            if m and int(m.group(2)) == fmt:
                ptx[method][f"MF{m.group(1)}"] = figs
        if not ptx[method]:
            raise AssertionError(f"no ptxas figures for the bf16 dense "
                                 f"{body} over {method} in the build log")
        plan[method] = {f"{M_}x{K}x{N}": planner(M_, K, N, method)
                        for M_, K, N in shapes}
    return {"ptxas_bf16": ptx, "plan_bf16": plan}


def routing_differences(torch, ids, layers):
    """From the expert ids of every routing of each run ({run: ids in call
    order}; a run routes every layer in the forward, then again, in
    reverse, as remat recomputes each block): fails unless every recompute
    routed exactly as its forward did, and returns per layer how many
    (token, k) choices differ between the runs."""
    fwd = {}
    for run, calls in ids.items():
        if len(calls) != 2 * layers:
            raise AssertionError(f"{run}: {len(calls)} routings, expected "
                                 f"{2 * layers}")
        fwd[run], again = calls[:layers], calls[layers:][::-1]
        if not all(torch.equal(u, v) for u, v in zip(fwd[run], again)):
            raise AssertionError(f"{run}: a block's recompute routed "
                                 "otherwise than its forward")
    diff = lambda a, b: [int((u != v).sum()) for u, v in zip(fwd[a], fwd[b])]
    return {"choices_per_layer": fwd["kernels"][0].numel(),
            "recompute_identical": True,
            "kernels_vs_plain": diff("kernels", "plain"),
            "kernels_vs_f32": diff("kernels", "f32"),
            "plain_vs_f32": diff("plain", "f32")}


# ------------------------------------------ MoE over a quantized base


def _moe_q_cases(torch, quant, gen, dtype, method, M_, K, N, E, r, gid):
    """make() of the quantized grouped training kernels' inputs: x [M, K],
    the codes and scale of a random W0 [E, K, N] in ``method``'s format,
    a [E, K, r], b [E, r, N] (nonzero), g [M, N], gid int32 on the card,
    and W0 dequantized to ``dtype`` (the operand of the product context)."""
    key = "q" if method == "int8" else "q4"
    gid = torch.tensor(gid, dtype=torch.int32, device="cuda")

    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        leaf = quant.quantize_leaf(rn(E, K, N) * K ** -0.5, method)
        return (rn(M_, K).to(dtype), leaf[key], leaf["scale"],
                (rn(E, K, r) * r ** -0.5).to(dtype),
                (rn(E, r, N) * 0.1).to(dtype), rn(M_, N).to(dtype),
                gid.clone(), quant.maybe_dequant(leaf, dtype))
    return make


def _moe_q_calls(torch, lg, method, bm):
    """{kernel: (kernel, plain version, product context)}, each a call on
    the inputs of ``_moe_q_cases`` with tiles of ``bm`` rows."""
    if method == "int8":
        fwd, dx = lg.lora_grouped_gemm_q, lg.lora_grouped_dx_q
        fwd_ref, dx_ref = lg.lora_grouped_gemm_q_ref, lg.lora_grouped_dx_q_ref
    else:
        fwd, dx, fwd_ref, dx_ref = (
            functools.partial(f, method=method) for f in (
                lg.lora_grouped_gemm_q4, lg.lora_grouped_dx_q4,
                lg.lora_grouped_gemm_q4_ref, lg.lora_grouped_dx_q4_ref))

    def per_expert(t, w):      # [M, ·] rows as [E, M / E, ·]
        return t.view(w.shape[0], -1, t.shape[1])
    f, d = GROUPED_TRAIN_Q[method]
    return {
        f: (lambda x, q, s, a, b, g, gid, w: fwd(x, q, s, a, b, gid, 2.0,
                                                 bm=bm),
            lambda x, q, s, a, b, g, gid, w: fwd_ref(x, q, s, a, b, gid, 2.0,
                                                     bm=bm),
            lambda x, q, s, a, b, g, gid, w: torch.bmm(per_expert(x, w), w)),
        d: (lambda x, q, s, a, b, g, gid, w: dx(g, q, s, a, b, gid, 2.0,
                                                bm=bm),
            lambda x, q, s, a, b, g, gid, w: dx_ref(g, q, s, a, b, gid, 2.0,
                                                    bm=bm),
            lambda x, q, s, a, b, g, gid, w: torch.matmul(per_expert(g, w),
                                                          w.mT))}


def check_grouped_quant_train(torch, quant, lg):
    """The quantized grouped training kernels against their plain versions
    for int8, int4 and nf4, in f32 (summation order only, 1e-4 relative,
    the absolute floor relative to the output's largest magnitude) and bf16
    (``KERNEL_TOL``, floored the same way), at the MoE path's shapes (E 64,
    C 40, gate/up and down, r 8) and ``MOE_Q_EDGES``; NaN on the same rows
    as the plain version (a bad gid). Times, bounds and the product context
    in bf16 at the path's shapes, inputs cold. Returns ({(kernel, method):
    [shape figures]}, {(kernel, method): {edge: errors}})."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    f32_tol = dict(rtol=1e-4, atol=1e-4)
    path_gid = [e for e in range(MOE_E) for _ in range(MOE_C // MOE_BM)]
    cases = {(K, N): (MOE_E * MOE_C, MOE_BM, K, N, MOE_E, RANK, path_gid)
             for K, N in MOE_SHAPES}
    cases.update(MOE_Q_EDGES)
    figures, edges = {}, {}
    for method in GROUPED_TRAIN_Q:
        for name in GROUPED_TRAIN_Q[method]:
            figures[(name, method)], edges[(name, method)] = [], {}
        for case, (M_, bm, K, N, E, r, gid) in cases.items():
            calls = _moe_q_calls(torch, lg, method, bm)
            errs = {}
            for dtype, tol in ((torch.float32, f32_tol),
                               (torch.bfloat16, KERNEL_TOL)):
                args = _moe_q_cases(torch, quant, gen, dtype, method, M_, K,
                                    N, E, r, gid)()
                for name, (kern, plain, _) in calls.items():
                    got, want = kern(*args), plain(*args)
                    torch.cuda.synchronize()
                    what = f"{name} {method} {dtype} {case}"
                    if not torch.equal(got.isnan(), want.isnan()):
                        raise AssertionError(f"{what}: NaN on other entries "
                                             "than the plain version's")
                    ok = ~want.isnan().all(1)
                    errs[(name, dtype)] = _close_scaled(got[ok], want[ok],
                                                        tol, what)
            if case not in MOE_SHAPES:
                for name in calls:
                    edges[(name, method)][case] = {
                        "M": M_, "bm": bm, "K": K, "N": N, "E": E, "r": r,
                        "gid": list(gid),
                        "max_abs_err": errs[(name, torch.bfloat16)],
                        "max_abs_err_f32": errs[(name, torch.float32)]}
                continue
            # reads x (or g), the codes, the scale, A, B and gid; writes y
            # (or dx)
            codes = E * (K * N if method == "int8" else (K + 1) // 2 * N)
            nbytes = 2 * M_ * (K + N) + codes + 4 * E * N \
                + 2 * E * (K * r + r * N) + 4 * len(gid)
            flops = 2 * M_ * K * N + 2 * M_ * r * (K + N)
            bound, by = _bound_ms(nbytes, flops)
            sets = _cold_sets(_moe_q_cases(torch, quant, gen, torch.bfloat16,
                                           method, M_, K, N, E, r, gid),
                              nbytes)
            for name, (kern, plain, mm) in calls.items():
                dense = "lora_grouped_gemm" if name.startswith(
                    "lora_grouped_gemm") else "lora_grouped_dx"
                figures[(name, method)].append({
                    "K": K, "N": N, "M": M_, "E": E, "C": MOE_C, "bm": bm,
                    "r": r, "method": method,
                    "launches_per_train_step": MOE_SHAPES[(K, N)][dense],
                    "max_abs_err": errs[(name, torch.bfloat16)],
                    "max_abs_err_f32": errs[(name, torch.float32)],
                    "ms": _time_ms(kern, sets, MOE_CALLS),
                    "plain_ms": _time_ms(plain, sets, MOE_CALLS // 2),
                    "library_ms": None,
                    "matmul_ms": _time_ms(mm, sets, MOE_CALLS),
                    "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                    "flops": flops})
            del sets
    return figures, edges


def check_rope(torch, rope):
    """The standalone RoPE kernel and its VJP (the kernel at -sin, through
    ``rope_apply``'s autograd) bit for bit against the plain rotation in
    f32 and bf16 at ``ROPE_CASES``; times in bf16 beside the plain
    rotation and the bound. Returns {case: figures}."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for case, (B, N, H, D) in ROPE_CASES.items():
        cos, sin = rope.rope_tables(torch.arange(N, device="cuda"), 1e6, D)

        def make(dtype=torch.bfloat16):
            return (torch.randn(B, N, H, D, generator=gen,
                                device="cuda").to(dtype), cos, sin)
        for dtype in (torch.float32, torch.bfloat16):
            x, _, _ = make(dtype)
            g = make(dtype)[0]
            xr = x.clone().requires_grad_(True)
            y = rope.rope_apply(xr, cos, sin)
            (dx,) = torch.autograd.grad(y, xr, g)
            torch.cuda.synchronize()
            if not torch.equal(y, rope.rope_fwd_ref(x, cos, sin)) or \
                    not torch.equal(dx, rope.rope_fwd_ref(g, cos, -sin)):
                raise AssertionError(f"rope_fwd {case} {dtype}: not bit for "
                                     "bit the plain rotation")
        # reads x and both tables, writes y; 4 products and 2 sums a pair
        nbytes = 2 * 2 * B * N * H * D + 2 * 4 * N * (D // 2)
        flops = 6 * B * N * H * (D // 2)
        bound, by = _bound_ms(nbytes, flops)
        sets = _cold_sets(make, nbytes)
        out[case] = {"B": B, "N": N, "H": H, "D": D, "bitwise": True,
                     "max_abs_err": 0.0,
                     "ms": _time_ms(rope.rope_fwd, sets),
                     "plain_ms": _time_ms(rope.rope_fwd_ref, sets),
                     "library_ms": None, "bound_ms": bound, "bound_by": by,
                     "bytes": nbytes, "flops": flops}
        del sets
    return out


# ------------------------------------------------------------ steps 14-17
# the paper's other training engines (``mesp_seq``, the ``mezo*`` family,
# ``sgd_momentum`` / ``adamw``) and the structured backend's chunked flash

#: the paper's lr, for the steps whose peak memory is read
SEQ_LR = 1e-4
#: the f32 check of mesp_seq's update against mesp_cuda's: an lr of 1 makes
#: the update the gradient itself, well above the f32 rounding of p
CHECK_LR = 1.0
#: 2 steps of each new engine: an lr at which bf16 LoRA leaves move
ENGINES_LR = 1e-2
#: (engine, optimizer) of the {"train_engines"} phase
NEW_RUNS = (("mesp_seq", "sgd"), ("mezo", "sgd"), ("mezo_sparse", "sgd"),
            ("mezo_lowrank", "sgd"), ("mezo_block", "sgd"),
            ("mezo_avg4", "sgd"), ("mesp_cuda", "sgd_momentum"),
            ("mesp_cuda", "adamw"))
ZO_SEED, ZO_EPS = 0, 1e-3
#: |(L+ - L-)/2eps - <g_exact, z>| <= ZO_TOL * ||g_exact|| (f32), held at
#: ZO_CHECK_EPS: at MeZO's eps (1e-3) the perturbation's norm eps·||z|| is
#: 2.1 at this width and the central difference's truncation alone is about
#: ||g_exact|| (the projection converges on <g, z> as eps shrinks, PERF.md)
ZO_TOL, ZO_CHECK_EPS = 0.05, 1e-5
#: two probe forwards of the full model: forward kernels only
ZO_PER_PROBE = {"lora_fused_fwd": 7 * N_LAYERS,
                "rmsnorm_fwd": RMS_PER_STEP,
                "flash_fwd": N_LAYERS}
#: core/flash.py against the flash kernels: (B, H, Hkv, N, D), chunk
CORE_FLASH_SHAPE, CORE_FLASH_CHUNK = (1, N_HEADS, N_KV_HEADS, 2048,
                                      HEAD_DIM), 512


def _lora_leaves(tree, prefix="", lora=True):
    """{path: leaf} of the LoRA factors ('a'/'b') of a params tree, or with
    ``lora=False`` of its other (frozen) leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_lora_leaves(v, f"{prefix}/{k}", lora))
        elif (k in ("a", "b")) == lora:
            out[f"{prefix}/{k}"] = v
    return out


def _peak(torch, fn):
    """Peak allocated bytes of ``fn()`` above what was allocated before."""
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return {"peak_bytes": peak, "above_start_bytes": peak - base,
            "start_bytes": base}


def _check_counts(counts, want, what):
    want = {**{k: 0 for k in counts}, **want}
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected "
                             f"{want}")


def train_seq(torch, cfg, params, batch):
    """One ``sequential_train_step`` (paper §4.3) under the ``cuda`` policy
    at the paper's setting, counts zeroed just before and read just after
    (``PAPER_PER_STEP``, the production step's); its peak memory beside
    one ``mesp.train_step`` (mesp_cuda); in f32, its updated LoRA leaves
    against mesp_cuda's value_and_grad + SGD at ``GRAD_TOL`` (the updates,
    at ``CHECK_LR``), and whether they are equal bit for bit."""
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.core import mesp
    from repro_torch.kernels import ops
    pol = ExecutionPolicy(backend="cuda", device="cuda")
    _release(torch)
    ops.reset_launch_counts()
    new, loss = mesp.sequential_train_step(params, cfg, batch, SEQ_LR,
                                           policy=pol)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    _check_counts(counts, PAPER_PER_STEP, "mesp_seq")
    if not math.isfinite(float(loss)):
        raise AssertionError(f"mesp_seq: loss {float(loss)}")
    if not all(bool(torch.isfinite(t).all())
               for t in _lora_leaves(new).values()):
        raise AssertionError("mesp_seq: non-finite LoRA leaves")
    del new
    peaks = {
        "mesp_seq": _peak(torch, lambda: mesp.sequential_train_step(
            params, cfg, batch, SEQ_LR, policy=pol)),
        "mesp_cuda": _peak(torch, lambda: mesp.train_step(
            params, cfg, batch, SEQ_LR, policy=pol))}

    f32, p32 = dataclasses.replace(cfg, dtype="float32"), _f32(params)
    seq, seq_loss = mesp.sequential_train_step(p32, f32, batch, CHECK_LR,
                                               policy=pol)
    prod, prod_loss = mesp.train_step(p32, f32, batch, CHECK_LR, policy=pol)
    before, s, p = (_lora_leaves(t) for t in (p32, seq, prod))
    rel = {k: float(torch.linalg.vector_norm(s[k] - p[k])
                    / torch.linalg.vector_norm(p[k] - before[k]))
           for k in before}
    bitwise = all(torch.equal(s[k], p[k]) for k in before) and \
        torch.equal(seq_loss, prod_loss)
    if max(rel.values()) > GRAD_TOL or len(rel) != 14:
        raise AssertionError(f"mesp_seq f32 updates differ from mesp_cuda's "
                             f"over {GRAD_TOL}: {rel}")
    del seq, prod, p32, s, p, before
    return {"loss": float(loss), "launches": counts,
            "launches_per_step": PAPER_PER_STEP, "lr": SEQ_LR,
            "peak_memory_one_step": peaks,
            "f32_vs_mesp_cuda": {"lr": CHECK_LR, "rel_l2": rel,
                                 "worst": max(rel.values()),
                                 "bitwise": bitwise,
                                 "loss": [float(seq_loss),
                                          float(prod_loss)]}}


def zo_check(torch, cfg, params, batch):
    """In f32, one dense ``spsa_grad`` at MeZO's ``ZO_EPS`` under the
    ``cuda`` policy, counts zeroed just before and read just after (two
    probe forwards: forward kernels only); the projection (L+ - L-)/2eps
    at ``ZO_CHECK_EPS`` against <g_exact, z>, g_exact from mesp_cuda,
    within ``ZO_TOL`` ||g_exact||, beside the projection at other eps and
    the f32 loss's rounding (the kernels' loss against the plain
    backend's), and z bit for bit on a second draw from its seed; Table 3
    (``gradquality.probe``, mezo against mesp_cuda, at ``ZO_EPS``); then
    Table 4's MeZO row: the bf16 peak of one mezo step beside one
    mesp_cuda step (registry builders, cuda policy)."""
    import types
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.api.registry import get_engine
    from repro_torch.core import mesp
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizers
    from repro_torch.zo import estimator, gradquality
    from repro_torch.zo.samplers import DenseSampler
    pol = ExecutionPolicy(backend="cuda", device="cuda")
    f32, p32 = dataclasses.replace(cfg, dtype="float32"), _f32(params)
    _release(torch)
    l_exact, g = mesp.value_and_grad(p32, f32, batch, policy=pol)
    g = _lora_leaves(g)
    train, _ = model_lib.split_params(p32)
    z = _lora_leaves(DenseSampler().sample(ZO_SEED, train))
    replay = _lora_leaves(DenseSampler().sample(ZO_SEED, train))
    if not all(torch.equal(z[k], replay[k]) for k in z):
        raise AssertionError("DenseSampler: two draws from one seed differ "
                             "on the card")
    del replay
    dot = lambda u, v: sum(float(torch.sum(u[k].double() * v[k].double()))
                           for k in u)
    zz = dot(z, z)
    ops.reset_launch_counts()
    loss, est = estimator.spsa_grad(p32, f32, batch, ZO_SEED, eps=ZO_EPS,
                                    policy=pol)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    _check_counts(counts, {k: 2 * v for k, v in ZO_PER_PROBE.items()},
                  "spsa_grad")
    by_eps = {str(ZO_EPS): dot(_lora_leaves(est), z) / zz}   # est = proj·z
    for eps in (1e-2, 1e-4, ZO_CHECK_EPS):
        _, est = estimator.spsa_grad(p32, f32, batch, ZO_SEED, eps=eps,
                                     policy=pol)
        by_eps[str(eps)] = dot(_lora_leaves(est), z) / zz
    del est
    proj = by_eps[str(ZO_CHECK_EPS)]
    g_z, g_norm = dot(g, z), math.sqrt(dot(g, g))
    err = abs(proj - g_z)
    if not all(map(math.isfinite, by_eps.values())) or \
            err > ZO_TOL * g_norm:
        raise AssertionError(f"spsa_grad: projection {proj} at eps "
                             f"{ZO_CHECK_EPS} against <g, z> {g_z}, |g| "
                             f"{g_norm} (tol {ZO_TOL}); by eps {by_eps}")
    plain = float(model_lib.loss_fn(p32, f32, batch, policy=ExecutionPolicy(
        backend="plain", device="cuda")))
    rounding = abs(float(l_exact) - plain)
    del z, g
    table3 = gradquality.probe("mezo", p32, f32, batch, ZO_SEED,
                               reference="mesp_cuda", policy=pol)
    del p32
    peaks = {}
    for name in ("mezo", "mesp_cuda"):
        opt = optimizers.make_optimizer("sgd", SEQ_LR)
        step = get_engine(name).build_step(
            types.SimpleNamespace(seed=ZO_SEED, optimizer="sgd", lr=SEQ_LR),
            cfg, opt, pol)
        peaks[name] = _peak(torch, lambda: step(params, opt.init(params),
                                                batch))
    return {"dtype": "float32", "layers": cfg.n_layers, "eps": ZO_EPS,
            "seed": ZO_SEED, "loss": float(loss),
            "loss_exact": float(l_exact), "check_eps": ZO_CHECK_EPS,
            "proj": proj, "g_dot_z": g_z, "g_norm": g_norm, "abs_err": err,
            "tol": ZO_TOL * g_norm, "proj_by_eps": by_eps,
            "seed_replay_bitwise": True,
            "loss_rounding_vs_plain": rounding,
            "loss_rounding_in_proj": {e: rounding / (2 * float(e))
                                      for e in by_eps},
            "launches": counts, "gradient_quality": table3,
            "peak_memory_one_step_bf16": peaks}


def train_engines(torch, cfg, params, batch):
    """2 steps of each of ``NEW_RUNS`` through its registry builder, under
    the policy the train CLI gives it, on one bf16 params tree: the
    losses finite, the LoRA leaves moved, every frozen leaf and the given
    tree bit for bit unchanged."""
    import time
    import types
    from repro_torch.api.engines import ENGINES
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.api.registry import get_engine
    from repro_torch.optim import optimizers
    lora0 = {k: v.clone() for k, v in _lora_leaves(params).items()}
    frozen0 = _lora_leaves(params, lora=False)
    out = {}
    for engine, optimizer in NEW_RUNS:
        _release(torch)
        pol = ExecutionPolicy(backend=ENGINES[engine], device="cuda")
        opt = optimizers.make_optimizer(optimizer, ENGINES_LR)
        step = get_engine(engine).build_step(types.SimpleNamespace(
            seed=0, optimizer=optimizer, lr=ENGINES_LR), cfg, opt, pol)
        p, s, losses, secs = params, opt.init(params), [], []
        for _ in range(2):
            t0 = time.monotonic()
            p, s, loss = step(p, s, batch)
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t0)
            losses.append(float(loss))
        what = f"{engine} --optimizer {optimizer}"
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{what}: losses {losses}")
        lora, frozen = _lora_leaves(p), _lora_leaves(p, lora=False)
        moved = sum(not torch.equal(lora[k], lora0[k]) for k in lora0)
        if not moved or not all(bool(torch.isfinite(t).all())
                                for t in lora.values()):
            raise AssertionError(f"{what}: LoRA leaves did not move")
        if frozen.keys() != frozen0.keys() or not all(
                torch.equal(frozen[k], frozen0[k]) for k in frozen0):
            raise AssertionError(f"{what}: a frozen leaf changed")
        if not all(torch.equal(v, lora0[k])
                   for k, v in _lora_leaves(params).items()):
            raise AssertionError(f"{what}: the given params changed")
        out[f"{engine}/{optimizer}"] = {
            "backend": pol.backend, "losses": losses, "seconds": secs,
            "lora_leaves_moved": moved}
        del p, s
    return out


def check_core_flash(torch, ops, flash):
    """``core/flash.py`` (the structured backend's chunked flash, plain
    PyTorch) against the flash kernels (``ops.sdpa``) at
    ``CORE_FLASH_SHAPE``, chunk ``CORE_FLASH_CHUNK``, causal: out, dq, dk
    and dv in f32 at ``FLASH_F32_TOL`` and bf16 at ``KERNEL_TOL`` (the
    flash card tests' tolerances), the floor scaled by the output's
    largest magnitude."""
    B, H, Hkv, N, D = CORE_FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(17)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda") * 0.7
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_F32_TOL if dtype == torch.float32 else KERNEL_TOL
        q, k, v, g = (t.to(dtype) for t in (rn(B, H, N, D), rn(B, Hkv, N, D),
                                            rn(B, Hkv, N, D),
                                            rn(B, H, N, D)))
        runs = {}
        for name, fn in (("kernels", lambda a, b, c: ops.sdpa(
                a, b, c, causal=True)),
                         ("core_flash", lambda a, b, c: flash.flash_attention(
                             a, b, c, 0, True, CORE_FLASH_CHUNK,
                             CORE_FLASH_CHUNK))):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = fn(*ins)
            runs[name] = (o.detach(), *torch.autograd.grad(o, ins, g))
        torch.cuda.synchronize()
        what = str(dtype).split(".")[-1]
        out[what] = {n: _close_scaled(c, w, tol, f"core.flash {n} {what}")
                     for n, c, w in zip(("out", "dq", "dk", "dv"),
                                        runs["core_flash"], runs["kernels"])}
        out[what]["tol"] = tol
    return {"shape": {"B": B, "H": H, "Hkv": Hkv, "N": N, "D": D},
            "chunk": CORE_FLASH_CHUNK, "causal": True, "max_abs_err": out}


def ptxas(log):
    """{kernel (mangled name): its registers, spills and static shared
    memory} from ``nvcc -Xptxas -v``'s log."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )(\S+?)'?$",
                      ln.strip())
        if m:
            fn = m.group(1)
        elif fn and ("registers" in ln or "spill" in ln):
            out[fn] = (out.get(fn, "") + " " + ln.split(":")[-1].strip()
                       ).strip()
    return out



# ---------------------------------------------------- step 18: the Trainer
#: the Trainer phase: full-width qwen2.5-0.5b, bf16, mesp_cuda, seq 256
BARE_CMD = ["--arch", "qwen2.5-0.5b", "--engine", "mesp_cuda", "--device",
            "cuda", "--seq", str(PAPER_SEQ), "--seed", "0"]
TRAINER_CMD = BARE_CMD + ["--quiet"]
TRAINER_BATCH, TRAINER_STEPS, TRAINER_CKPT_EVERY = 2, 12, 4
#: (c): the stall is this many times (a)'s median step, the watchdog's
#: factor is STALL_FACTOR, its limit 1: the stall alone forces a restart
STALL_STEPS, STALL_FACTOR = 12, 8.0
#: (d): a real CUDA OOM at batch OOM_BATCH under a cap between one step's
#: peak at OOM_BATCH and at half of it
OOM_BATCH, OOM_STEPS = 4, 6
#: (e): steps of the proactive walk (two samples a rung; on the card the
#: walk is halve_batch, then quantize_int8, which ends under the limit)
PRESSURE_STEPS = 10
#: (g): steps of the profiled run
PROFILE_STEPS = 2
MIB = 2 ** 20


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else (xs[len(xs) // 2 - 1]
                                                   + xs[len(xs) // 2]) / 2


def _lora_equal(torch, a, b):
    la, lb = _lora_leaves(a), _lora_leaves(b)
    return la.keys() == lb.keys() and len(la) == 14 and all(
        torch.equal(la[k], lb[k]) for k in la)


def _one_step_memory(torch, cfg, batch, quantize="none"):
    """One bare mesp_cuda step at ``batch`` x PAPER_SEQ on fresh weights:
    its peak ``max_memory_allocated`` and the ``memory_allocated`` after
    it, with the state the loop keeps (params, optimizer state) alive."""
    from repro_torch.api.registry import get_engine
    from repro_torch.api.spec import TrainSpec
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizers
    spec = TrainSpec(engine="mesp_cuda", quantize=quantize, batch=batch,
                     seq=PAPER_SEQ)
    opt = optimizers.make_optimizer("sgd", spec.lr)
    step = get_engine("mesp_cuda").build_step(spec, cfg, opt, spec.policy())
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model_lib.init_params(cfg, generator=gen, quantize=quantize)
    state = opt.init(params)
    data = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(cfg.vocab, PAPER_SEQ, batch, seed=0)).items()}
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    params, state, loss = step(params, state, data)
    float(loss)
    torch.cuda.synchronize()
    out = {"peak_bytes": torch.cuda.max_memory_allocated(),
           "after_step_bytes": torch.cuda.memory_allocated()}
    del params, state, loss, data
    _release(torch)
    return out


def _events(path):
    from repro_torch.telemetry.events import read_jsonl
    return read_jsonl(path) if Path(path).exists() else []


def trainer_phase(torch, cfg):
    """Step 18: the production launcher (``launch.train.run``, what
    ``main`` runs) on full-width qwen2.5-0.5b, bf16, mesp_cuda, seq 256,
    each run with a checkpoint directory of its own under a temporary
    directory that the phase deletes. (a) a clean run with telemetry, its
    launch counts, step times and peak beside the bare loop's; (b) the same
    run crashed at step 6 and resumed: its LoRA leaves bit for bit (a)'s;
    (c) a chaos plan; (d) a real CUDA OOM under a memory cap, answered by
    halve_batch; (e) the proactive ladder under ``--mem-budget-mb``; (f)
    checkpoint sizes and times; (g) the telemetry checks."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer, save_checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import fault_tolerance as ft
    from repro_torch.telemetry.events import validate_record
    t_phase = time.monotonic()
    root = Path(tempfile.mkdtemp(prefix="repro_torch_trainer_"))
    out = {}
    base = TRAINER_CMD + ["--batch", str(TRAINER_BATCH), "--ckpt-interval",
                          str(TRAINER_CKPT_EVERY)]

    def launch(name, argv):
        """One launcher run, counts zeroed just before and read just
        after, the peak over the run; returns (result, counts, peak)."""
        _release(torch)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        res = train_cli.run(argv + ["--ckpt-dir", str(root / name)])
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        res.metrics["run_seconds"] = time.monotonic() - t0
        return res, counts, peak

    def want(n_steps):
        return {k: v * n_steps for k, v in PAPER_PER_STEP.items()}

    try:
        # (a) the bare loop at the same shape first (only its LoRA leaves
        # kept), then the clean run with telemetry: counts, finite losses,
        # figures
        _release(torch)
        torch.cuda.reset_peak_memory_stats()
        bare = train_cli.train(BARE_CMD + [
            "--batch", str(TRAINER_BATCH), "--steps", str(TRAINER_STEPS)])
        bare_peak = torch.cuda.max_memory_allocated()
        bare_ms = [1e3 * s for s in bare["seconds"]]
        bare_lora = {k: v.clone() for k, v in
                     _lora_leaves(bare.pop("params")).items()}
        del bare
        tdir = root / "telemetry_a"
        res_a, counts, peak_a = launch("a", base + [
            "--steps", str(TRAINER_STEPS), "--telemetry", "on",
            "--telemetry-dir", str(tdir)])
        _check_counts(counts, want(TRAINER_STEPS), "trainer (a)")
        losses = [h.loss for h in res_a.history]
        if len(losses) != TRAINER_STEPS or \
                not all(map(math.isfinite, losses)):
            raise AssertionError(f"trainer (a): losses {losses}")
        step_ms = [1e3 * h.seconds for h in res_a.history]
        lora_a = _lora_leaves(res_a.params)
        if lora_a.keys() != bare_lora.keys() or len(lora_a) != 14 or \
                not all(torch.equal(v, bare_lora[k])
                        for k, v in lora_a.items()):
            raise AssertionError("trainer (a): the Trainer's LoRA leaves "
                                 "differ from the bare loop's")
        del bare_lora, lora_a
        # (g) on (a): every record validates; the watermark's peak is the
        # allocator's over the same window; span totals
        recs = _events(tdir / "events.jsonl")
        bad = [(r.get("kind"), validate_record(r)) for r in recs
               if validate_record(r)]
        kinds = sorted({r["kind"] for r in recs})
        if not recs or bad or not {"run", "step", "checkpoint",
                                   "watermark"} <= set(kinds):
            raise AssertionError(f"trainer (g): records {kinds}, "
                                 f"invalid {bad[:3]}")
        wm = res_a.metrics["watermark"]
        if wm["source"] != "device_stats" or \
                wm["measured_peak_mb"] != round(peak_a / MIB, 3):
            raise AssertionError(f"trainer (g): watermark {wm} against "
                                 f"max_memory_allocated {peak_a / MIB} MB")
        spans = res_a.metrics["spans"]
        out["a_clean"] = {
            "steps": TRAINER_STEPS, "batch": TRAINER_BATCH,
            "losses": losses, "launches": counts,
            "launches_per_step": PAPER_PER_STEP,
            "step_ms": step_ms, "median_step_ms": _median(step_ms[1:]),
            "bare_train_step_ms": bare_ms,
            "bare_median_step_ms": _median(bare_ms[1:]),
            "run_peak_bytes": peak_a, "bare_run_peak_bytes": bare_peak,
            "lora_equal_to_bare": True,
            "run_seconds": res_a.metrics["run_seconds"]}
        out["g_telemetry"] = {
            "records": len(recs), "kinds": kinds, "all_valid": True,
            "watermark": wm, "max_memory_allocated_mib": peak_a / MIB,
            "spans": {k: spans[k] for k in ("data_fetch", "step",
                                            "checkpoint") if k in spans},
            "events_by_kind": res_a.metrics["events_by_kind"]}

        # (f) checkpoint figures from (a)'s newest checkpoint
        ck = Checkpointer(str(root / "a"))
        newest = root / "a" / f"step_{TRAINER_STEPS:08d}"
        mb = sum(f.stat().st_size for f in newest.iterdir()) / 1e6
        n_arrays = len(ck.read_manifest(TRAINER_STEPS)["arrays"])
        del res_a
        _release(torch)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        restored = ck.restore_latest(device="cuda")
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        t0 = time.monotonic()
        save_checkpoint(str(root / "f"), TRAINER_STEPS, restored["params"],
                        restored["opt_state"], restored["data_state"])
        save_s = time.monotonic() - t0
        a_params = restored["params"]
        del restored
        shutil.rmtree(root / "f")
        out["f_checkpoint"] = {
            "mb_per_save": mb, "arrays": n_arrays, "save_s": save_s,
            "restore_s": restore_s, "restore_verified_sha256_16": n_arrays,
            "saves_in_a": sorted(p.name for p in (root / "a").iterdir())}

        # (b) crash at 6, resumed: (a)'s LoRA leaves bit for bit
        res_b, counts, _ = launch("b", base + [
            "--steps", str(TRAINER_STEPS), "--inject-faults", "crash@6"])
        fc = res_b.fault_counts
        _check_counts(counts, want(len(res_b.history)), "trainer (b)")
        if fc["step_failures"] != 1 or fc["steps_replayed"] <= 0 or \
                res_b.history[-1].step != TRAINER_STEPS:
            raise AssertionError(f"trainer (b): counters {fc}")
        if not _lora_equal(torch, res_b.params, a_params):
            diff = [k for k, v in _lora_leaves(res_b.params).items()
                    if not torch.equal(v, _lora_leaves(a_params)[k])]
            raise AssertionError(f"trainer (b): the resumed run's LoRA "
                                 f"leaves differ from (a)'s: {diff[:4]}")
        out["b_resume"] = {"fault_counts": fc, "launches": counts,
                           "executed_steps": len(res_b.history),
                           "lora_bitwise_equal_to_a": True,
                           "run_seconds": res_b.metrics["run_seconds"]}
        del res_b, a_params
        shutil.rmtree(root / "a"), shutil.rmtree(root / "b")

        # (c) the chaos plan, the stall sized from (a)'s step time
        stall_s = STALL_STEPS * out["a_clean"]["median_step_ms"] / 1e3
        plan = f"oom@3,corrupt@6,crash@6,nan@8,stall@10:{stall_s:.3f}"
        res_c, counts, _ = launch("c", base + [
            "--steps", str(TRAINER_STEPS), "--inject-faults", plan,
            "--straggler-factor", str(STALL_FACTOR), "--straggler-limit",
            "1"])
        fc = res_c.fault_counts
        executed = (len(res_c.history) + fc["guard_skips"]
                    + fc["straggler_restarts"])
        _check_counts(counts, want(executed), "trainer (c)")
        if res_c.history[-1].step != TRAINER_STEPS or fc["injected"] != {
                "oom": 1, "corrupt": 1, "crash": 1, "nan": 1, "stall": 1} \
                or fc["straggler_restarts"] != 1 \
                or fc["ckpt_quarantines"] < 1 or fc["guard_skips"] < 1 \
                or res_c.degradations != ["halve_batch"] \
                or res_c.final_spec.batch != 1 \
                or not all(math.isfinite(h.loss) for h in res_c.history):
            raise AssertionError(f"trainer (c): {plan}: counters {fc}, "
                                 f"rungs {res_c.degradations}, final batch "
                                 f"{res_c.final_spec.batch}")
        out["c_chaos"] = {"plan": plan, "straggler_factor": STALL_FACTOR,
                          "fault_counts": fc, "degradations":
                          res_c.degradations, "final_batch": 1,
                          "executed_steps": executed, "launches": counts,
                          "losses": [h.loss for h in res_c.history],
                          "run_seconds": res_c.metrics["run_seconds"]}
        del res_c
        shutil.rmtree(root / "c")

        # (d) a real CUDA OOM: one step's peak at OOM_BATCH and at half
        # of it, a cap between the two, then OOM_STEPS steps under it
        mem = {b: _one_step_memory(torch, cfg, b)
               for b in (OOM_BATCH, OOM_BATCH // 2)}
        hi, lo = (mem[b]["peak_bytes"] for b in (OOM_BATCH, OOM_BATCH // 2))
        cap = (hi + lo) // 2
        total = torch.cuda.get_device_properties(0).total_memory
        seen = []
        real_is_oom = ft.is_oom_error

        def classify(e):
            seen.append((type(e).__name__, real_is_oom(e)))
            return seen[-1][1]

        _release(torch)
        torch.cuda.set_per_process_memory_fraction(cap / total)
        ft.is_oom_error = classify
        try:
            res_d, counts, peak_d = launch("d", TRAINER_CMD + [
                "--batch", str(OOM_BATCH), "--steps", str(OOM_STEPS),
                "--ckpt-interval", str(TRAINER_CKPT_EVERY)])
        finally:
            ft.is_oom_error = real_is_oom
            torch.cuda.set_per_process_memory_fraction(1.0)
        fc = res_d.fault_counts
        if seen != [("OutOfMemoryError", True)] or fc["oom_events"] != 1 \
                or res_d.degradations != ["halve_batch"] or fc["injected"] \
                or res_d.history[-1].step != OOM_STEPS \
                or res_d.final_spec.batch != OOM_BATCH // 2:
            raise AssertionError(f"trainer (d): failures seen {seen}, "
                                 f"counters {fc}, rungs "
                                 f"{res_d.degradations}")
        # the steps run, plus what the failed batch-4 step launched
        # before its allocation failed: at most one step's launches
        partial = {k: counts[k] - v for k, v in
                   want(len(res_d.history)).items()}
        if any(not 0 <= n <= PAPER_PER_STEP[k] for k, n in partial.items()):
            raise AssertionError(f"trainer (d): launch counts {counts} for "
                                 f"{len(res_d.history)} steps and one "
                                 "failed step")
        out["d_real_oom"] = {
            "one_step_peak_bytes": {str(b): m["peak_bytes"]
                                    for b, m in mem.items()},
            "cap_bytes": cap, "fraction": cap / total,
            "failures_seen": seen, "fault_counts": fc,
            "degradations": res_d.degradations,
            "final_batch": res_d.final_spec.batch,
            "run_peak_bytes": peak_d, "launches": counts,
            "launches_of_the_failed_step": partial,
            "run_seconds": res_d.metrics["run_seconds"]}
        del res_d
        shutil.rmtree(root / "d")

        # (e) proactive: 0.9 x budget between the residency after a step
        # over an int8 base and over the bf16 base
        after = {q: _one_step_memory(torch, cfg, TRAINER_BATCH, q)
                 ["after_step_bytes"] for q in ("none", "int8")}
        limit_mb = (after["none"] + after["int8"]) / 2 / MIB
        budget_mb = limit_mb / 0.9
        tdir_e = root / "telemetry_e"
        res_e, counts, _ = launch("e", base + [
            "--steps", str(PRESSURE_STEPS), "--mem-budget-mb",
            repr(budget_mb), "--telemetry", "on", "--telemetry-dir",
            str(tdir_e)])
        fc = res_e.fault_counts
        recs = _events(tdir_e / "events.jsonl")
        marks = [(r["step"], r["measured_mb"]) for r in recs
                 if r["kind"] == "watermark"]
        rungs = [(r["step"], r["rung"], r["engine"], r["quantize"],
                  r["batch"]) for r in recs if r["kind"] == "degrade"]
        after_rung = [{"rung": name, "engine": eng, "quantize": q,
                       "batch": b, "residency_mb_after": next(
                           (m for s, m in marks if s > step), None)}
                      for step, name, eng, q, b in rungs]
        ended_under = bool(marks) and marks[-1][1] < limit_mb
        exhausted = not ended_under and res_e.degradations and \
            fc["watermark_triggers"] > len(res_e.degradations)
        if fc["oom_events"] or fc["watermark_triggers"] < 1 or \
                fc["guard_skips"] or fc["straggler_restarts"] or \
                res_e.history[-1].step != PRESSURE_STEPS or \
                not (ended_under or exhausted):
            raise AssertionError(f"trainer (e): counters {fc}, rungs "
                                 f"{after_rung}, limit {limit_mb} MiB, "
                                 f"last sample {marks[-1:]}")
        # every rung keeps the kernels: the engine stays mesp_cuda on the
        # card, and each step launched the kernel counts of the format in
        # force at that step (a rung at step s takes effect from step s)
        if any(eng != "mesp_cuda" for _, _, eng, _, _ in rungs):
            raise AssertionError(f"trainer (e): a rung left mesp_cuda: "
                                 f"{after_rung}")
        starts = [(0, "none")] + [(st, q) for st, _, _, q, _ in rungs]
        ends = [st for st, _ in starts[1:]] + [PRESSURE_STEPS]
        want_e = {k: 0 for k in counts}
        for (st, q), end in zip(starts, ends):
            per = PAPER_PER_STEP if q == "none" else quant_per_step(q)
            for k, v in per.items():
                want_e[k] += v * (end - st)
        _check_counts(counts, want_e, "trainer (e)")
        out["e_proactive"] = {
            "after_step_bytes": after, "budget_mib": budget_mb,
            "limit_mib": limit_mb, "rungs": after_rung,
            "degradations": res_e.degradations,
            "final_spec": {k: getattr(res_e.final_spec, k) for k in
                           ("engine", "quantize", "batch", "seq")},
            "samples_mib": marks, "ended_under_limit": ended_under,
            "fault_counts": fc, "launches": counts,
            "launches_match_each_rungs_kernels": True,
            "run_seconds": res_e.metrics["run_seconds"]}
        del res_e
        shutil.rmtree(root / "e")

        # (g) --profile on: a torch.profiler Chrome trace json.load reads
        tdir_g = root / "telemetry_g"
        res_g, counts, _ = launch("g", base + [
            "--steps", str(PROFILE_STEPS), "--telemetry", "on",
            "--telemetry-dir", str(tdir_g), "--profile", "on"])
        _check_counts(counts, want(PROFILE_STEPS), "trainer (g) profile")
        trace = tdir_g / "profile" / "trace.json"
        with open(trace) as fh:
            doc = json.load(fh)
        names = [e.get("name", "") for e in doc.get("traceEvents", [])]
        on_card = [e for e in doc.get("traceEvents", [])
                   if e.get("cat") == "kernel"]
        if not names:
            raise AssertionError(f"trainer (g): profile {trace} is empty")
        out["g_telemetry"]["profile"] = {
            "events": len(names), "device_kernels": len(on_card),
            "bytes": Path(trace).stat().st_size}
        del res_g
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.monotonic() - t_phase
    return out



# ------------------------------- step 19: the rest of the dense catalog
#: Gemma3-12B (configs/gemma3_12b.py): 48 layers, d 3840, 16 q heads over 8
#: kv heads of 256, d_ff 15360, windows (1024,) * 5 + (0,), vocab 262,144
GEMMA_ARCH, GEMMA_SEQ, GEMMA_STEPS = "gemma3-12b", 2048, 3
GEMMA_GROUP = 6                       # one period: 5 local layers, 1 global
# (B*Hkv, G, Nq, Nk, D, causal, window, rope): Gemma3's two path shapes at
# batch 1 x seq 2048 (a local layer's window of 1024 masks keys) and the
# 256 instance's edges: ragged N, Nq != Nk, D 200 (padded to 208), G 1
FLASH_D256_CASES = {
    "gemma3_local": (8, 2, 2048, 2048, 256, True, 1024, False),
    "gemma3_global": (8, 2, 2048, 2048, 256, True, 0, False),
    "gemma3_global_rope": (8, 2, 2048, 2048, 256, True, 0, True),
    "d256_ragged300": (2, 2, 300, 300, 256, True, 0, True),
    "d256_nq_ne_nk": (2, 2, 200, 136, 256, True, 0, False),
    "d200_window48_rope": (2, 2, 256, 256, 200, True, 48, True),
    "d256_G1": (4, 1, 256, 256, 256, False, 0, False),
}
#: calls a timing at the catalog's shapes (a call takes 0.1-10 ms)
CATALOG_CALLS = 200
#: the serve run: 8 slots in tiles of 2, 4 tenants, 8 requests of 8 + 8
GEMMA_SERVE_CMD = ["--arch", GEMMA_ARCH, "--engine", "mesp_cuda", "--device",
                   "cuda", "--batch", str(M), "--tile", str(BM), "--adapters",
                   "4", "--store-capacity", "4", "--requests", "8",
                   "--prompt-len", "8", "--max-new", "8", "--max-len", "32",
                   "--seed", "0"]
#: ring decode against the forward: one group, batch 2, past the window
RING_BATCH, RING_POSITIONS = 2, 1100
#: the other dense configs: arch -> (base format, steps) at 1 x 256
CATALOG_RUNS = {"granite-8b": ("none", 2), "minitron-4b": ("none", 2),
                "qwen2.5-32b": ("nf4", 2)}
#: step 19 (d): the f32 kernels' LoRA gradients against the plain f32
#: ones over one Gemma3 group, relative L2 per leaf. The two differ in
#: summation order alone; GRAD_TOL, set for bf16, would pass faults that
#: move a leaf by a quarter (PERF.md: the sound reading and those of faults
#: planted by scripts/profile_torch_grad_floor.py --model gemma3)
CATALOG_F32_GRAD_TOL = 1e-3


def check_flash_d256(torch, fa, rope_tables, build):
    """Step 19 (a): the flash kernels' 256 instance against their plain
    versions on ``FLASH_D256_CASES`` in f32 and bf16, then timed in bf16
    at Gemma3's two path shapes (a local layer, window 1024, 40 of the 48
    launches a step; a global one, 8) beside their plain versions,
    ``F.scaled_dot_product_attention`` and the bound, with the 256
    instances' registers and spills (ptxas) and the bf16 kernels' dynamic
    shared memory. Returns {kernel: [figures at the two shapes]}."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    errs = _flash_errors(torch, fa, rope_tables, gen, FLASH_D256_CASES)
    L = 48
    out = {k: [] for k in FLASH_PER_STEP}
    for case, layers_ in (("gemma3_local", L * 5 // 6),
                          ("gemma3_global", L // 6)):
        per = {"flash_fwd": 2 * layers_, "flash_bwd_dq": layers_,
               "flash_bwd_dkv": layers_}
        figs = _flash_times(torch, fa, gen, errs, FLASH_D256_CASES[case],
                            per, CATALOG_CALLS)
        for name, (f,) in figs.items():
            lib = "flash_fwd" if name == "flash_fwd" else "flash_bwd"
            f["case"] = case
            f["ptxas_256"] = {k: v for k, v in build[lib]["ptxas"].items()
                              if "Li256E" in k}
            out[name].append(f)
    return out


def check_quant_shapes(torch, quant, lq, lp4, method, shapes, per_step,
                       M_=QM, seed=29):
    """The quantized LoRA forward and dx of ``method`` against their plain
    versions in f32 and bf16 at ``shapes`` ((K, N), M_ rows), timed in bf16
    beside their plain versions, the bound and ``torch.matmul`` over the
    dequantized W0. ``per_step``: {kernel: {(K, N): launches a step}}.
    Returns {kernel: [shape figures]}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = _quant_calls(torch, lq, lp4, method)
    out = {name: [] for name in calls}
    for K, N in shapes:
        errs = _quant_errors(torch, quant, calls, gen, method, M_, K, N)
        figs = _quant_figures(torch, quant, calls, gen, method, M_, K, N,
                              errs, {n: per_step[n][(K, N)] for n in calls},
                              CATALOG_CALLS)
        for name, f in figs.items():
            out[name].append(f)
    return out


def config_kernels(torch, lf, rn, lq, lp4, quant, cfg, method, seed):
    """The kernels of a dense config's training step (step 19 (g)) against
    their plain versions at its shapes, ``QM`` rows: the LoRA dA/dB and the
    RMSNorm backward (``check_training_kernels``) and forward
    (``rmsnorm_train_shape``) at [QM, d]; over a bf16 base the LoRA
    forward and dx, over a quantized one ``method``'s forward and dx
    (``check_quant_shapes``). Returns {kernel: [shape figures]}."""
    per, lin = dense_shapes_per_step(cfg), dense_linears(cfg)
    kernels = TRAIN_KERNELS if method == "none" else ("lora_dab",
                                                      "rmsnorm_bwd")
    out = check_training_kernels(
        torch, lf, rn, QM, {s: {k: v[s] for k, v in per.items()}
                            for s in lin},
        cfg.d_model, 2 * cfg.n_layers, seed=seed, kernels=kernels,
        n_calls=CATALOG_CALLS)
    if method != "none":
        fwd, dx = QUANT_KERNELS[method]
        out.update(check_quant_shapes(
            torch, quant, lq, lp4, method, lin,
            {fwd: per["lora_fused_fwd"], dx: per["lora_dx"]}, seed=seed + 1))
    out["rmsnorm_fwd"] = [rmsnorm_train_shape(
        torch, rn, QM, cfg.d_model, 4 * cfg.n_layers + 1, seed=seed + 2,
        calls=CATALOG_CALLS)]
    return out


def b_scale_for(cfg):
    """B of a wider model's gradient and decode checks: ``B_SCALE`` times
    sqrt(896 / d_model), so that the LoRA term s (x A) B, which grows as
    sqrt(d_model) with A ~ N(0, 1/r) and B fixed, has qwen2.5-0.5b's size
    (where ``GRAD_TOL`` and ``LOGIT_TOL`` were set). At B_SCALE itself the
    term dominates Gemma3's layers and the random model turns chaotic: the
    plain bf16 gradients stand 0.63-0.92 from the f32 ones (PERF.md)."""
    return B_SCALE * (D_MODEL / cfg.d_model) ** 0.5


def _train_run(torch, ops, train_cli, argv, want, what):
    """One ``launch.train.train`` run, counts zeroed just before and read
    just after, checked against ``want`` (launches a step); losses finite.
    Returns (the run, its counts, its peak above the start)."""
    _release(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = train_cli.train(argv)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    steps = int(argv[argv.index("--steps") + 1])
    _check_counts(counts, {k: v * steps for k, v in want.items()}, what)
    if len(run["losses"]) != steps or \
            not all(map(math.isfinite, run["losses"])):
        raise AssertionError(f"{what}: losses {run['losses']}")
    secs = run["seconds"]
    run["figures"] = {
        "steps": steps, "losses": run["losses"], "seconds": secs,
        "ms_per_step": 1e3 * sum(secs[1:]) / max(1, len(secs) - 1),
        "first_step_ms": 1e3 * secs[0], "launches": counts,
        "launches_per_step": want,
        "run_peak_above_start_bytes": torch.cuda.max_memory_allocated()
        - base}
    return run, counts


def ring_decode_check(torch, cfg, params):
    """Step 19 (f): one group of Gemma3 (5 local layers, 1 global) decodes
    ``RING_POSITIONS`` positions of a batch of 2 through the per-slot
    caches (the local layers' rings of 1,024 slots wrap past 1,024) with
    the kernels (the grouped decode forward over a store of one tenant,
    RMSNorm), and its logits are held against the forward's in the logit
    check's scheme: the forward through the kernels (bf16) and plainly in
    f32; per position, each difference over the f32 logits' largest
    magnitude; the decode no further than ``LOGIT_TOL`` from the kernels'
    forward, nor further from f32 than twice the kernels' forward is (+1e-3),
    over all positions and over those past the window."""
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.models import model as model_lib
    from repro_torch.serve import AdapterStore
    pol = ExecutionPolicy(backend="cuda", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (RING_BATCH, RING_POSITIONS),
                         generator=gen, device="cuda")
    with torch.no_grad():
        fwd = model_lib.forward(params, cfg, toks, policy=pol)
        f32_cfg = dataclasses.replace(cfg, dtype="float32")
        f32 = model_lib.forward(_f32(params), f32_cfg, toks,
                                policy=ExecutionPolicy(backend="plain",
                                                       device="cuda"))
    _release(torch)
    store = AdapterStore(params, capacity=1)
    store.acquire("t", params)
    cache = model_lib.init_cache(cfg, RING_BATCH, RING_POSITIONS,
                                 device="cuda")
    shapes = {k: tuple(v["k"].shape) for k, v in cache["groups"].items()}
    tiles = torch.zeros(1, dtype=torch.int32, device="cuda")
    dec = torch.empty_like(fwd)
    t0 = time.monotonic()
    for t in range(RING_POSITIONS):
        dec[:, t] = model_lib.decode_step(store.params, cfg, cache,
                                          toks[:, t:t + 1], policy=pol,
                                          adapter_tiles=tiles)[0][:, 0]
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError("ring decode: non-finite logits")
    scale = f32.abs().amax((0, 2))                      # per position
    rel = lambda u, v: (u - v).abs().amax((0, 2)) / scale
    d = {"decode_vs_forward": rel(dec, fwd), "decode_vs_f32": rel(dec, f32),
         "forward_vs_f32": rel(fwd, f32)}
    window = cfg.window_pattern[0]
    worst = {part: {k: float(v[sl].max()) for k, v in d.items()}
             for part, sl in (("all", slice(None)),
                              ("past_window", slice(window, None)))}
    for part, w in worst.items():
        if w["decode_vs_forward"] > LOGIT_TOL or \
                w["decode_vs_f32"] > 2 * w["forward_vs_f32"] + 1e-3:
            raise AssertionError(f"ring decode ({part}): {w} (tolerance "
                                 f"{LOGIT_TOL}, and at most twice the "
                                 "forward's distance from f32)")
    return {"layers": cfg.n_layers, "batch": RING_BATCH,
            "positions": RING_POSITIONS, "cache_k_shapes": shapes,
            "worst": worst, "logits_tol": LOGIT_TOL,
            "decode_seconds": seconds}


def dense_catalog_phase(torch, build, ops, fa, lf, lg, rn, lq, lp4, quant,
                        rope_tables, train_cli, serve_cli):
    """Step 19: Gemma3-12B's flash instance, its training kernels' shapes,
    its training and serving at full width and depth, its gradients and
    ring decode at one group; granite-8b, minitron-4b and qwen2.5-32b
    (nf4) training. Every run's counts zeroed just before and read just
    after it. Returns (figures, {path: counts}, {kernel: shape figures})."""
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as model_lib
    t_phase = time.monotonic()
    cfg = get_config(GEMMA_ARCH)
    fig, counts = {}, {}
    M_ = GEMMA_SEQ
    # (a) flash at head dim 256; (b) the training kernels at Gemma3's
    # shapes, M 2048, and its decode kernels at M 8
    shapes = check_flash_d256(torch, fa, rope_tables, build)
    per = dense_shapes_per_step(cfg)
    shapes.update(check_training_kernels(
        torch, lf, rn, M_, {s: {k: v[s] for k, v in per.items()}
                            for s in dense_linears(cfg)},
        cfg.d_model, 2 * cfg.n_layers, seed=31, n_calls=CATALOG_CALLS))
    shapes["rmsnorm_fwd"] = [rmsnorm_train_shape(
        torch, rn, M_, cfg.d_model, 4 * cfg.n_layers + 1, seed=32,
        calls=CATALOG_CALLS)] + check_rmsnorm(
        torch, rn, cfg.d_model, 2 * cfg.n_layers + 1, seed=33,
        calls=CATALOG_CALLS)
    shapes["lora_grouped_fwd"] = check_grouped(
        torch, lg, decode_shapes(cfg), seed=34, calls=CATALOG_CALLS)
    for figs in shapes.values():
        for f in figs:
            f["arch"] = GEMMA_ARCH
    # (g)'s configs' kernels at their shapes, M 256 (qwen2.5-32b over nf4;
    # its dA/dB at K or N 27,648 in 16-member clusters: a member's slice of
    # 8 does not fit shared memory)
    for i, (arch, (method, _)) in enumerate(CATALOG_RUNS.items()):
        for name, figs in config_kernels(
                torch, lf, rn, lq, lp4, quant, get_config(arch), method,
                seed=40 + 4 * i).items():
            for f in figs:
                f["arch"] = arch
            shapes.setdefault(name, []).extend(figs)
    fig["kernel_checks_seconds"] = time.monotonic() - t_phase

    # (c) training at full width and depth, 1 x 2048, 3 steps
    argv = ["--arch", GEMMA_ARCH, "--engine", "mesp_cuda", "--device",
            "cuda", "--batch", "1", "--seq", str(GEMMA_SEQ), "--steps",
            str(GEMMA_STEPS), "--seed", "0"]
    run, counts["train_gemma3"] = _train_run(
        torch, ops, train_cli, argv, dense_per_step(cfg, GEMMA_SEQ),
        GEMMA_ARCH)
    fig["train"] = run["figures"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _with_b(torch, run["params"], gen)
    del run
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(cfg.vocab, GEMMA_SEQ, 1, seed=0)).items()}
    fig["train"]["params_bytes"] = quant.tree_bytes(params)
    fig["train"]["peak_memory_one_value_and_grad"] = peak_memory(
        torch, cfg, params, batch, [("mesp_cuda", True), ("mebp", True)])
    del params
    _release(torch)

    # (d) gradients at full width, one group (5 local layers, 1 global)
    cut = dataclasses.replace(cfg, n_layers=GEMMA_GROUP)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _with_b(torch, model_lib.init_params(cut, generator=gen), gen,
                     b_scale_for(cut))
    fig["b_scale_checks"] = b_scale_for(cut)
    fig["grads_one_group"] = compare_grads(torch, cut, params, batch,
                                           f32_tol=CATALOG_F32_GRAD_TOL)
    fig["grads_one_group"]["f32_kernels_tol"] = CATALOG_F32_GRAD_TOL
    del batch

    # (f) ring decode against the forward, the same group
    fig["ring_decode"] = ring_decode_check(torch, cut, params)
    del params
    _release(torch)

    # (e) serving at full width and depth
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_cli.serve(GEMMA_SERVE_CMD)
    counts["serve_gemma3"] = ops.launch_counts()
    torch.cuda.synchronize()
    steps = out["steps"] + out["warmup_steps"]
    _check_counts(counts["serve_gemma3"], {
        "lora_grouped_fwd": 7 * cfg.n_layers * steps,
        "rmsnorm_fwd": (2 * cfg.n_layers + 1) * steps},
        f"{GEMMA_ARCH} serve, {steps} decode steps")
    if out["tokens"] != 8 * 8 or out["requests"] != 8:
        raise AssertionError(f"{GEMMA_ARCH} serve: {out['requests']} "
                             f"requests / {out['tokens']} tokens, expected "
                             "8 / 64")
    fig["serve"] = {
        "requests": out["requests"], "tokens": out["tokens"],
        "steps": out["steps"], "warmup_steps": out["warmup_steps"],
        "seconds": out["seconds"], "tok_s": out["tokens"] / out["seconds"],
        "ms_per_step": 1e3 * out["seconds"] / out["steps"],
        "launches": counts["serve_gemma3"],
        "launches_per_step": {"lora_grouped_fwd": 7 * cfg.n_layers,
                              "rmsnorm_fwd": 2 * cfg.n_layers + 1},
        "params_bytes": out["params_bytes"],
        "allocated_at_start": start,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del out
    _release(torch)

    # (g) the other dense configs at full size, 2 steps at 1 x 256
    fig["configs"] = {}
    for arch, (method, nsteps) in CATALOG_RUNS.items():
        c = get_config(arch)
        init = init_memory(torch, c, method)
        argv = ["--arch", arch, "--engine", "mesp_cuda", "--device", "cuda",
                "--batch", str(PAPER_BATCH), "--seq", str(PAPER_SEQ),
                "--steps", str(nsteps), "--seed", "0", "--quantize", method]
        run, counts[f"train_{arch}"] = _train_run(
            torch, ops, train_cli, argv, dense_per_step(c, PAPER_SEQ, method),
            f"{arch} --quantize {method}")
        fig["configs"][arch] = {"layers": c.n_layers, "quantize": method,
                                **run["figures"], "init": init}
        del run
    fig["seconds"] = time.monotonic() - t_phase
    return fig, counts, shapes


# ---------- step 20: single-stream serving and the recurrent families
#: RWKV6-1.6B (configs/rwkv6_1_6b.py): 24 attention-free layers, d 2048,
#: 32 WKV heads of 64, d_ff 7168, vocab 65,536; RecurrentGemma-2B
#: (configs/recurrentgemma_2b.py): 26 layers in R, R, A order (8 groups and
#: a tail of two recurrent blocks), d 2560, RG-LRU 2560 wide, MQA (10 q
#: heads over 1 kv head of 256, window 2048), d_ff 7680, vocab 256,000
RWKV_ARCH, RG_ARCH = "rwkv6-1.6b", "recurrentgemma-2b"
RECURRENT_ARCHS = (RWKV_ARCH, RG_ARCH)
RECURRENT_STEPS = 3
#: layers of the full-width gradient check: RWKV6 2; RecurrentGemma one
#: R, R, A group and a tail of two (every block kind and the tail list)
RECURRENT_GRAD_LAYERS = {RWKV_ARCH: 2, RG_ARCH: 5}
#: LoRA leaves of those cuts: 8 linears a RWKV6 layer; 3 a recurrent
#: block, 7 an attention block, over l0, l1, l2 and the two tail blocks
RECURRENT_GRAD_LEAVES = {RWKV_ARCH: 16, RG_ARCH: 38}
#: flash at RecurrentGemma's shape (B*Hkv 1, G 10: the first G above a
#: cluster of 8 at head dim 256, split unevenly over the members; N 256,
#: causal, window 2048) and a ragged RoPE edge at G 10
FLASH_G10_CASES = {
    "recurrentgemma": (1, 10, 256, 256, 256, True, 2048, False),
    "g10_ragged_rope": (2, 10, 200, 200, 256, True, 0, True),
}
#: single-stream serving: 4 sequences, 16 timed decode steps (and one
#: warmup step), a cache of 32 positions
SS_BATCH, SS_STEPS, SS_MAX_LEN = 4, 16, 32
SINGLE_STREAM_RUNS = {
    RWKV_ARCH: ["--arch", RWKV_ARCH], RG_ARCH: ["--arch", RG_ARCH],
    "olmoe-1b-7b": ["--arch", "olmoe-1b-7b"],
    "olmoe-1b-7b/nf4": ["--arch", "olmoe-1b-7b", "--quantize", "nf4"],
    "qwen2.5-0.5b/adapters0": ["--arch", "qwen2.5-0.5b", "--adapters", "0"],
}
#: decode against the forward, f32, full width: positions, batch, and the
#: largest |logit difference| over the largest |logit| (summation order)
DECODE_POSITIONS, DECODE_BATCH, DECODE_F32_TOL = 64, 2, 1e-3
#: the same of RWKV6's plain path run whole in f64, the witness that the
#: decode code is right at full width (f64 rounding, magnified as f32's
#: is, stays far below this)
DECODE_F64_TOL = 1e-8
#: forwards of RWKV6's plain f32 path with every weight moved one f32 ulp
#: up or down at random, each read against the f64 forward: the spread
#: that f32 rounding alone gives the f32 runs' distance from f64; and as
#: many of the kernel path's, for its own spread
DECODE_SPREAD_SAMPLES = 10
DECODE_KERNEL_SPREAD_SAMPLES = 3
#: the ragged grouped op at OLMoE's expert shapes (d 2048 -> d_expert 1024,
#: rank 8), tiles of 8 rows: groups interleaved with empty ones, and 64
#: ragged groups, every fifth empty
RAGGED_K, RAGGED_N, RAGGED_BM = 2048, 1024, 8
RAGGED_SIZES = {"interleaved": (8, 0, 13, 0, 2),
                "olmoe64": tuple(0 if g % 5 == 0 else 1 + (7 * g) % 41
                                 for g in range(64))}
RAGGED_FORMATS = ("none", "int8", "nf4")
#: method -> the grouped (forward, dx) kernels over that expert stack
GROUPED_ROWS_KERNELS = {"none": ("lora_grouped_gemm", "lora_grouped_dx"),
                        "int8": GROUPED_TRAIN_Q["int8"],
                        "nf4": GROUPED_TRAIN_Q["nf4"]}


def recurrent_layers(cfg):
    """[(kind, remat)] of a recurrent config's layers in order: "rwkv", or
    a hybrid's pattern letter; ``remat``: the layer runs under
    torch.utils.checkpoint (a hybrid's tail does not)."""
    if cfg.family == "ssm":
        return [("rwkv", True)] * cfg.n_layers
    pat = cfg.hybrid.pattern
    grouped = cfg.n_layers // len(pat) * len(pat)
    return [(pat[i % len(pat)], i < grouped) for i in range(cfg.n_layers)]


def recurrent_layer_linears(cfg, kind):
    """[(K, N)] of a layer's LoRA linears, and how many of the first read
    the frozen embedding through the frozen norm when the layer is layer 0
    (no input gradient, so no dx): RWKV6 r, k, v, g, o and the channel
    mix's k, v, r; a recurrent block x_proj, gate_proj, out_proj; an
    attention block q, k, v, o, gate, up, down."""
    d = cfg.d_model
    if kind == "rwkv":
        return [(d, d)] * 5 + [(d, cfg.d_ff), (cfg.d_ff, d), (d, d)], 4
    if kind == "R":
        w = cfg.hybrid.lru_width or d
        return [(d, w), (d, w), (w, d)], 2
    q, kv, f = cfg.q_size, cfg.kv_size, cfg.d_ff
    return [(d, q), (d, kv), (d, kv), (q, d), (d, f), (d, f), (f, d)], 3


def recurrent_shapes_per_step(cfg):
    """{kernel: {(K, N): launches}} of the LoRA kernels in a mesp_cuda
    training step: each linear's forward twice under remat (once in a
    hybrid's tail), its dA/dB once, its dx once but in layer 0's linears
    that read the embedding."""
    out = {k: {} for k in ("lora_fused_fwd", "lora_dx", "lora_dab")}
    for i, (kind, remat) in enumerate(recurrent_layers(cfg)):
        lin, no_dx = recurrent_layer_linears(cfg, kind)
        for j, s in enumerate(lin):
            for name, n in (("lora_fused_fwd", 2 if remat else 1),
                            ("lora_dab", 1),
                            ("lora_dx", 0 if i == 0 and j < no_dx else 1)):
                out[name][s] = out[name].get(s, 0) + n
    return out


def _layer_norms(kind):
    """RMSNorm calls of a layer's forward: RWKV6 ln1, the group norm, ln2;
    a recurrent block its ln; an attention block ln1, ln2."""
    return {"rwkv": 3, "R": 1}.get(kind, 2)


def recurrent_per_step(cfg, seq):
    """Launches of every kernel in a mesp_cuda training step of RWKV6 or
    RecurrentGemma at ``seq`` tokens: ``recurrent_shapes_per_step``'s LoRA
    kernels; the RMSNorm forward of every norm twice under remat (once in
    the tail) and the final norm; its backward of every norm but layer 0's
    first (its input is the embedding), and the final norm; from 64 query
    rows the flash kernels a local-attention layer (forward twice, backward
    once)."""
    want = {k: 0 for k in KERNEL_NAMES}
    want.update({k: sum(v.values())
                 for k, v in recurrent_shapes_per_step(cfg).items()})
    layers = recurrent_layers(cfg)
    want["rmsnorm_fwd"] = 1 + sum((2 if remat else 1) * _layer_norms(kind)
                                  for kind, remat in layers)
    want["rmsnorm_bwd"] = sum(_layer_norms(kind) for kind, _ in layers)
    attn = [remat for kind, remat in layers if kind == "A"]
    if seq >= 64 and attn:
        want.update({"flash_fwd": sum(2 if r else 1 for r in attn),
                     "flash_bwd_dq": len(attn), "flash_bwd_dkv": len(attn)})
    return want


def decode_per_step(cfg, quantize="none"):
    """Launches of every kernel in one single-stream decode step (a forward
    at one position: every LoRA linear once through the dense kernels, an
    MoE's experts through the grouped forward, every norm once; Whisper's
    decoder blocks 10 linears and 3 norms each)."""
    want = {k: 0 for k in KERNEL_NAMES}
    fwd = QUANT_KERNELS.get(quantize, ("lora_fused_fwd",))[0]
    L = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        layers = recurrent_layers(cfg)
        want[fwd] = sum(len(recurrent_layer_linears(cfg, k)[0])
                        for k, _ in layers)
        want["rmsnorm_fwd"] = 1 + sum(_layer_norms(k) for k, _ in layers)
    elif cfg.family == "moe":
        grouped = {"none": "lora_grouped_gemm", "int8": GROUPED_TRAIN_Q[
            "int8"][0]}.get(quantize, GROUPED_TRAIN_Q["nf4"][0])
        want.update({fwd: 4 * L, grouped: 3 * L, "rmsnorm_fwd": 2 * L + 1})
    elif cfg.family == "audio":
        want.update({fwd: 10 * L, "rmsnorm_fwd": 3 * L + 1})
    else:
        want.update({fwd: 7 * L, "rmsnorm_fwd": 2 * L + 1})
    return want


def _grouped_rows_calls(torch, lg, method, bm):
    """{kernel: (kernel, plain version)} of the grouped forward, dx and
    dA/dB over packed rows in tiles of ``bm``, W0 stacks in ``method``'s
    format, on the inputs of ``_grouped_rows_cases``."""
    if method == "none":
        fwd, dx = lg.lora_grouped_gemm, lg.lora_grouped_dx
        fwd_ref, dx_ref = lg.lora_grouped_gemm_ref, lg.lora_grouped_dx_ref
        pre = lambda w: (w,)
    else:
        pre = lambda w: (w["q"] if "q" in w else w["q4"], w["scale"])
        if method == "int8":
            fwd, dx = lg.lora_grouped_gemm_q, lg.lora_grouped_dx_q
            fwd_ref, dx_ref = (lg.lora_grouped_gemm_q_ref,
                               lg.lora_grouped_dx_q_ref)
        else:
            fwd, dx, fwd_ref, dx_ref = (
                functools.partial(f, method=method) for f in (
                    lg.lora_grouped_gemm_q4, lg.lora_grouped_dx_q4,
                    lg.lora_grouped_gemm_q4_ref, lg.lora_grouped_dx_q4_ref))
    f, d = GROUPED_ROWS_KERNELS[method]
    return {
        f: (lambda x, w, a, b, g, gid: fwd(x, *pre(w), a, b, gid, 2.0, bm=bm),
            lambda x, w, a, b, g, gid: fwd_ref(x, *pre(w), a, b, gid, 2.0,
                                               bm=bm)),
        d: (lambda x, w, a, b, g, gid: dx(g, *pre(w), a, b, gid, 2.0, bm=bm),
            lambda x, w, a, b, g, gid: dx_ref(g, *pre(w), a, b, gid, 2.0,
                                              bm=bm)),
        "lora_grouped_dab": (
            lambda x, w, a, b, g, gid: lg.lora_grouped_dab(x, g, a, b, gid,
                                                           2.0, bm=bm),
            lambda x, w, a, b, g, gid: lg.lora_grouped_dab_ref(
                x, g, a, b, gid, 2.0, bm=bm))}


def _grouped_rows_cases(torch, quant, gen, dtype, method, sizes, bm, K, N):
    """make() of packed ragged rows for the grouped kernels: x [M, K] and
    g [M, N] with each group's padding rows zero (as ``lora_grouped_ragged``
    packs them), W0 [E, K, N] in ``method``'s format, a, b (nonzero), gid
    int32 on the card (``kernels/tiling.py``)."""
    from repro_torch.kernels import tiling
    E = len(sizes)
    gid_np, offs = tiling.grouped_schedule(sizes, bm)
    gid = torch.from_numpy(gid_np).cuda()
    M_ = int(offs[-1])

    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        live = torch.zeros(M_, 1, device="cuda")
        for e, s in enumerate(sizes):
            live[int(offs[e]):int(offs[e]) + s] = 1
        w = rn(E, K, N) * K ** -0.5
        w = w.to(dtype) if method == "none" else quant.quantize_leaf(w,
                                                                     method)
        return ((rn(M_, K) * live).to(dtype), w,
                (rn(E, K, RANK) * RANK ** -0.5).to(dtype),
                (rn(E, RANK, N) * 0.1).to(dtype), (rn(M_, N) * live).to(dtype),
                gid)
    return make, M_


def check_grouped_rows(torch, quant, lg, method, sizes, bm, K, N, per=None,
                       seed=20, kernels=None):
    """The grouped forward, dx and dA/dB (those of ``kernels``) over
    ``sizes`` packed in tiles of ``bm``, W0 stacks in ``method``'s format,
    against their plain versions in f32 (summation order: 1e-5 relative
    over a float stack, 1e-4 over codes, floored at the output's largest
    magnitude) and bf16 (``KERNEL_TOL``); times beside the plain versions
    and the bound (the live rows' bytes and operations) in bf16, inputs
    cold. ``per``: {kernel: launches a step}. Returns {kernel: [figure]}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = _grouped_rows_calls(torch, lg, method, bm)
    if kernels is not None:
        calls = {k: v for k, v in calls.items() if k in kernels}
    errs = {}
    f32_tol = dict(rtol=1e-5, atol=1e-5) if method == "none" else \
        dict(rtol=1e-4, atol=1e-4)
    for dtype, tol in ((torch.float32, f32_tol), (torch.bfloat16, KERNEL_TOL)):
        make, M_ = _grouped_rows_cases(torch, quant, gen, dtype, method,
                                       sizes, bm, K, N)
        args = make()
        for name, (kern, plain) in calls.items():
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            if name != "lora_grouped_dab":
                got, want = (got,), (want,)
            errs[(name, dtype)] = max(
                _close_scaled(u, v, tol, f"{name} {method} {dtype} "
                              f"{len(sizes)} groups bm={bm}")
                for u, v in zip(got, want))
    make, M_ = _grouped_rows_cases(torch, quant, gen, torch.bfloat16, method,
                                   sizes, bm, K, N)
    E, rows, T = len(sizes), sum(sizes), M_ // bm
    wbytes = {"none": 2 * K * N, "int8": K * N + 4 * N,
              "nf4": (K + 1) // 2 * N + 4 * N}[method]
    live = sum(1 for s in sizes if s)       # stacks the tiles read
    stacks = live * (wbytes + 2 * RANK * (K + N))
    sets = _cold_sets(make, E * wbytes + 2 * M_ * (K + N))
    out = {}
    for name, (kern, plain) in calls.items():
        if name == "lora_grouped_dab":
            nbytes = 2 * (rows * (K + N) + 2 * live * RANK * (K + N)) + 4 * T
            flops = 4 * rows * RANK * (K + N)
        else:
            nbytes = 2 * rows * (K + N) + stacks + 4 * T
            flops = 2 * rows * K * N + 2 * rows * RANK * (K + N)
        bound, by = _bound_ms(nbytes, flops)
        out[name] = [{
            "K": K, "N": N, "M": M_, "rows": rows, "E": E, "bm": bm,
            "r": RANK, "method": method, "groups": list(sizes),
            "launches_per_step": (per or {}).get(name),
            "max_abs_err": errs[(name, torch.bfloat16)],
            "max_abs_err_f32": errs[(name, torch.float32)],
            "ms": _time_ms(kern, sets, CATALOG_CALLS),
            "plain_ms": _time_ms(plain, sets, CATALOG_CALLS),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "flops": flops}]
    return out


def check_ragged_op(torch, quant, ops, lg, method, sizes):
    """``ops.lora_grouped_ragged`` end to end on the card, bf16, through
    autograd: counts zeroed just before and read just after (one grouped
    forward, one dx, one dA/dB); its output bit for bit the forward
    kernel's on the packed rows, unpacked; finite gradients. Returns the
    counts."""
    from repro_torch.kernels import tiling
    gen = torch.Generator(device="cuda").manual_seed(21)
    make, _ = _grouped_rows_cases(torch, quant, gen, torch.bfloat16, method,
                                  sizes, RAGGED_BM, RAGGED_K, RAGGED_N)
    _, w, a, b, _, _ = make()
    x = torch.randn(sum(sizes), RAGGED_K, generator=gen,
                    device="cuda").bfloat16().requires_grad_(True)
    a, b = a.requires_grad_(True), b.requires_grad_(True)
    ops.reset_launch_counts()
    y = ops.lora_grouped_ragged(x, sizes, w, a, b, 2.0, bm=RAGGED_BM)
    grads = torch.autograd.grad((y.float() ** 2).sum(), (x, a, b))
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    torch.cuda.synchronize()
    fwd, dx = GROUPED_ROWS_KERNELS[method]
    if counts != {fwd: 1, dx: 1, "lora_grouped_dab": 1}:
        raise AssertionError(f"lora_grouped_ragged {method} {len(sizes)} "
                             f"groups: launches {counts}")
    kern = _grouped_rows_calls(torch, lg, method, RAGGED_BM)[fwd][0]
    gid = torch.from_numpy(tiling.grouped_schedule(sizes, RAGGED_BM)[0]).cuda()
    want = tiling.unpack_ragged_rows(kern(
        tiling.pack_ragged_rows(x.detach(), sizes, RAGGED_BM), w, a.detach(),
        b.detach(), None, gid), sizes, RAGGED_BM)
    if not torch.equal(y.detach(), want) or not all(
            bool(torch.isfinite(t).all()) for t in grads):
        raise AssertionError(f"lora_grouped_ragged {method}: output not the "
                             "kernel's, or non-finite gradients")
    return counts


def _decode_and_forward(torch, cfg, params, toks, pol, frames=None):
    """(forward logits, the logits of ``DecodeServer`` decoding ``toks``
    one position a step) of the model on ``pol``'s backend; an audio
    model's forward over ``frames``, its decode with ``cache["enc_out"]``
    its own encoder's output over them."""
    from repro_torch.launch.serve import DecodeServer
    from repro_torch.models import model as model_lib
    extra = {} if frames is None else {"enc_frames": frames}
    with torch.no_grad():
        fwd = model_lib.forward(params, cfg, toks, policy=pol, **extra)
    server = DecodeServer(cfg, params, toks.shape[0], toks.shape[1], pol)
    if frames is not None:
        with torch.no_grad():
            server.cache["enc_out"] = model_lib._encoder_forward(
                params, cfg, frames, pol)
    dec = torch.empty_like(fwd)
    for t in range(toks.shape[1]):
        server.step(toks[:, t:t + 1])
        dec[:, t] = server.last_logits[:, 0]
    torch.cuda.synchronize()
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{cfg.name} decode ({pol.backend}, "
                             f"{cfg.dtype}): non-finite logits")
    return fwd, dec


def lora_f32_accuracy(torch, cfg, gen, M_=DECODE_BATCH * DECODE_POSITIONS):
    """The f32 LoRA forward kernel and its plain version (``torch.matmul``
    in f32, TF32 off) against the same product in f64 at ``cfg``'s linear
    shapes, M_ rows: each one's largest |error| over the largest |f64
    output| (the summation's rounding alone)."""
    from repro_torch.kernels import lora_fused as lf
    out = {}
    for K, N in sorted({(cfg.d_model, cfg.d_model), (cfg.d_model, cfg.d_ff),
                        (cfg.d_ff, cfg.d_model)}):
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        x, w, a, b = (rn(M_, K), rn(K, N) * K ** -0.5,
                      rn(K, RANK) * RANK ** -0.5,
                      rn(RANK, N) * b_scale_for(cfg))
        xd, wd, ad, bd = (t.double() for t in (x, w, a, b))
        want = xd @ wd + 2.0 * ((xd @ ad) @ bd)     # the f64 product
        got, plain = lf.lora_fused(x, w, a, b), lf.lora_fused_ref(x, w, a, b)
        scale = float(want.abs().max())
        err = lambda y: float((y.double() - want).abs().max()) / scale
        out[f"{K}x{N}"] = {"kernel": err(got), "plain": err(plain)}
    return out


def decode_vs_forward(torch, cfg):
    """The model in f32 at full width (every LoRA B nonzero at
    ``b_scale_for``) decoding ``DECODE_POSITIONS`` positions of a batch of
    ``DECODE_BATCH`` single-stream (the launcher's ``DecodeServer``)
    against its forward, through the kernels and, on the same weights,
    through the plain structured path: per position the largest |logit
    difference| over the largest |logit|. The two differ in f32 summation
    order alone, and a deep random RWKV6 magnifies that (its group norm
    meets rows near its eps; ROADMAP §3), so the kernels' worst may be no
    more than twice the plain path's, or ``DECODE_F32_TOL``. For RWKV6 the
    plain path also runs whole in f64 on the same weights: its decode must
    stand within ``DECODE_F64_TOL`` of its forward (the decode code shared
    by both f32 runs is right at full width, and their distance is
    rounding), and both f32 runs' forward and decode are read against the
    f64 forward, beside ``DECODE_SPREAD_SAMPLES`` plain f32 forwards of
    weights moved one ulp (the spread rounding alone gives). An audio
    model decodes against its own encoder's output over ``FRAMES_STD``
    frames from the seed, the forward over the same frames."""
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.models import model as model_lib
    from repro_torch.tree import tree_map
    f32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = _with_b(torch, model_lib.init_params(f32, generator=gen), gen,
                     b_scale_for(cfg))
    toks = torch.randint(0, cfg.vocab, (DECODE_BATCH, DECODE_POSITIONS),
                         generator=gen, device="cuda")
    frames = None
    if cfg.family == "audio":
        frames = torch.randn(DECODE_BATCH, cfg.encdec.encoder_seq,
                             cfg.d_model, generator=gen,
                             device="cuda") * FRAMES_STD
    out = {"positions": DECODE_POSITIONS, "batch": DECODE_BATCH,
           "tol": DECODE_F32_TOL}
    rel = lambda u, v, scale: ((u.double() - v.double()).abs().amax((0, 2))
                               / scale).tolist()
    ref = None
    if cfg.family == "ssm":
        p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                       params)
        t0 = time.monotonic()
        ref, dec = _decode_and_forward(
            torch, dataclasses.replace(cfg, dtype="float64"), p64, toks,
            ExecutionPolicy(backend="plain", device="cuda"))
        scale = float(ref.abs().max())
        per_pos = rel(dec, ref, scale)
        out["f64"] = {"worst_rel": max(per_pos), "per_position_rel": per_pos,
                      "largest_logit": scale, "tol": DECODE_F64_TOL,
                      "seconds": time.monotonic() - t0}
        del p64, dec
        _release(torch)
    for name, backend in (("kernels", "cuda"), ("plain", "structured")):
        fwd, dec = _decode_and_forward(
            torch, f32, params, toks,
            ExecutionPolicy(backend=backend, device="cuda"), frames)
        scale = float(fwd.abs().max())
        per_pos = rel(dec, fwd, scale)
        out[name] = {"worst_rel": max(per_pos), "per_position_rel": per_pos,
                     "largest_logit": scale}
        if ref is not None:
            r64 = float(ref.abs().max())
            for what, got in (("forward", fwd), ("decode", dec)):
                per_pos = rel(got, ref, r64)
                out[name][f"{what}_vs_f64_rel"] = max(per_pos)
                out[name][f"{what}_vs_f64_per_position_rel"] = per_pos
        del fwd, dec
    if ref is not None:
        r64 = float(ref.abs().max())
        inf = torch.tensor(math.inf, device="cuda")
        for key, backend, n in (
                ("rounding_spread", "structured", DECODE_SPREAD_SAMPLES),
                ("kernels_rounding_spread", "cuda",
                 DECODE_KERNEL_SPREAD_SAMPLES)):
            pol = ExecutionPolicy(backend=backend, device="cuda")
            out[f"{key}_forward_vs_f64_rel"] = []
            out[f"{key}_per_position_rel"] = []
            for i in range(n):
                g = torch.Generator(device="cuda").manual_seed(100 + i)
                nudged = tree_map(lambda t: torch.nextafter(t, torch.where(
                    torch.rand(t.shape, generator=g, device="cuda") < 0.5,
                    inf, -inf)) if t.is_floating_point() else t, params)
                with torch.no_grad():
                    fwd = model_lib.forward(nudged, f32, toks, policy=pol)
                per_pos = rel(fwd, ref, r64)
                out[f"{key}_forward_vs_f64_rel"].append(max(per_pos))
                out[f"{key}_per_position_rel"].append(per_pos)
                del nudged, fwd
        # the kernel path with the per-head group norm's #13 / #14 swapped
        # for the structured path's norm (every other op still a kernel):
        # whether the norm kernels' rounding order sets the kernels' reading
        from repro_torch.models import layers as layers_lib
        from repro_torch.models import rwkv6 as rwkv_lib
        norm, hd = layers_lib.norm, cfg.resolved_head_dim

        def group_norm_plain(p, x, cfg_, *, policy):
            if p.ndim == 1 and p.shape[0] == hd and x.shape[-1] == hd:
                policy = dataclasses.replace(policy, backend="structured")
            return norm(p, x, cfg_, policy=policy)

        rwkv_lib.layers.norm = group_norm_plain
        try:
            with torch.no_grad():
                fwd = model_lib.forward(params, f32, toks,
                                        policy=ExecutionPolicy(
                                            backend="cuda", device="cuda"))
        finally:
            rwkv_lib.layers.norm = norm
        per_pos = rel(fwd, ref, r64)
        out["kernels_plain_group_norm"] = {
            "forward_vs_f64_rel": max(per_pos),
            "forward_vs_f64_per_position_rel": per_pos}
        del fwd
        # the kernel path with every LoRA linear on the structured path
        # instead (the norms still kernels): whether the f32 LoRA kernels'
        # summation sets the reading
        lin = layers_lib.apply_linear

        def linear_structured(p, x, *args, policy, **kw):
            return lin(p, x, *args, policy=dataclasses.replace(
                policy, backend="structured"), **kw)

        rwkv_lib.layers.apply_linear = linear_structured
        try:
            with torch.no_grad():
                fwd = model_lib.forward(params, f32, toks,
                                        policy=ExecutionPolicy(
                                            backend="cuda", device="cuda"))
        finally:
            rwkv_lib.layers.apply_linear = lin
        per_pos = rel(fwd, ref, r64)
        out["kernels_structured_lora"] = {
            "forward_vs_f64_rel": max(per_pos),
            "forward_vs_f64_per_position_rel": per_pos}
        del fwd
        out["lora_f32_vs_f64"] = lora_f32_accuracy(torch, cfg, gen)
    if ref is not None and out["f64"]["worst_rel"] > DECODE_F64_TOL:
        raise AssertionError(f"{cfg.name}: decode against the forward in "
                             f"f64 {out['f64']['worst_rel']} (limit "
                             f"{DECODE_F64_TOL}): a decode fault")
    worst = out["kernels"]["worst_rel"]
    if worst > max(DECODE_F32_TOL, 2 * out["plain"]["worst_rel"]):
        raise AssertionError(f"{cfg.name}: decode against the forward in "
                             f"f32 {worst}, the plain path's "
                             f"{out['plain']['worst_rel']}")
    del params, ref, frames
    _release(torch)
    return out


def recurrent_phase(torch, build, ops, fa, lf, lg, rn, lq, lp4, quant,
                    rope_tables, train_cli, serve_cli):
    """Step 20: the kernels at the recurrent families' and single-stream
    decode's shapes, flash at G 10, the ragged grouped op; RWKV6-1.6B and
    RecurrentGemma-2B training at full width and depth with their
    gradients and decode against the forward; single-stream serving. Every
    run's counts zeroed just before and read just after it. Returns
    (figures, {path: counts}, {kernel: shape figures})."""
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as model_lib
    t_phase = time.monotonic()
    fig, counts, shapes = {}, {}, {}

    def add(figs, **tags):
        for name, fs in figs.items():
            for f in fs:
                f.update(tags)
            shapes.setdefault(name, []).extend(fs)

    # the kernels at the two families' shapes: LoRA at M 256 (training)
    # and at M SS_BATCH (single-stream decode), the norms at their widths
    # (RWKV6's group norm: rows of 64, B * N * H of them)
    for i, arch in enumerate(RECURRENT_ARCHS):
        cfg = get_config(arch)
        per = recurrent_shapes_per_step(cfg)
        step = recurrent_per_step(cfg, PAPER_SEQ)
        add(check_training_kernels(
            torch, lf, rn, QM, {s: {k: v[s] for k, v in per.items()}
                                for s in per["lora_fused_fwd"]},
            cfg.d_model, step["rmsnorm_bwd"], seed=50 + 4 * i,
            n_calls=CATALOG_CALLS), arch=arch, path="train")
        add({"rmsnorm_fwd": [rmsnorm_train_shape(
            torch, rn, QM, cfg.d_model, step["rmsnorm_fwd"], seed=51 + 4 * i,
            calls=CATALOG_CALLS)]}, arch=arch, path="train")
        dec = {s: {"lora_fused_fwd": n} for s, n in
               recurrent_shapes_per_step(cfg)["lora_dab"].items()}
        add(check_training_kernels(
            torch, lf, rn, SS_BATCH, dec, seed=52 + 4 * i,
            kernels=("lora_fused_fwd",), n_calls=CATALOG_CALLS),
            arch=arch, path="single_stream")
    rw = get_config(RWKV_ARCH)
    gm_rows = PAPER_SEQ * rw.n_heads
    add(check_training_kernels(
        torch, lf, rn, gm_rows, {}, rw.resolved_head_dim, rw.n_layers,
        seed=60, kernels=("rmsnorm_bwd",), n_calls=CATALOG_CALLS),
        arch=RWKV_ARCH, path="train", norm="group")
    add({"rmsnorm_fwd": [rmsnorm_train_shape(
        torch, rn, gm_rows, rw.resolved_head_dim, 2 * rw.n_layers, seed=61,
        calls=CATALOG_CALLS)]}, arch=RWKV_ARCH, path="train", norm="group")
    # OLMoE's single-stream decode: q, k, v, o at M SS_BATCH in bf16 and
    # over nf4; the experts' grouped forward over E 64 buffers of the
    # SS_BATCH rows' capacity (8 a row), one tile each
    moe = get_config("olmoe-1b-7b")
    d, L = moe.d_model, moe.n_layers
    add(check_training_kernels(
        torch, lf, rn, SS_BATCH, {(d, d): {"lora_fused_fwd": 4 * L}},
        seed=62, kernels=("lora_fused_fwd",), n_calls=CATALOG_CALLS),
        arch="olmoe-1b-7b", path="single_stream")
    add(check_quant_shapes(torch, quant, lq, lp4, "nf4", [(d, d)],
                           {"lora_fused_q4": {(d, d): 4 * L},
                            "lora_dx_q4": {(d, d): 0}}, M_=SS_BATCH,
                           seed=63), arch="olmoe-1b-7b",
        path="single_stream")
    # qwen2.5-0.5b's single-stream decode (--adapters 0): every dense
    # LoRA linear at M SS_BATCH, at each of its (K, N)
    add(check_training_kernels(
        torch, lf, rn, SS_BATCH, {s: {"lora_fused_fwd": n} for s, n in
                                  decode_shapes(QWEN).items()},
        seed=65, kernels=("lora_fused_fwd",), n_calls=CATALOG_CALLS),
        arch=QWEN.name, path="single_stream")
    C = SS_BATCH * 8
    for method in ("none", "nf4"):
        fwd = GROUPED_ROWS_KERNELS[method][0]
        for K, N, n in ((d, moe.moe.d_expert, 2 * L),
                        (moe.moe.d_expert, d, L)):
            add(check_grouped_rows(
                torch, quant, lg, method, (C,) * moe.moe.n_experts, C, K, N,
                {fwd: n}, seed=64, kernels=(fwd,)), arch="olmoe-1b-7b",
                path="single_stream")
    # (b) flash at G 10, D 256
    gen = torch.Generator(device="cuda").manual_seed(20)
    errs = _flash_errors(torch, fa, rope_tables, gen, FLASH_G10_CASES)
    rg = get_config(RG_ARCH)
    rg_step = recurrent_per_step(rg, PAPER_SEQ)
    for name, fs in _flash_times(
            torch, fa, gen, errs, FLASH_G10_CASES["recurrentgemma"],
            {k: rg_step[k] for k in FLASH_KERNELS}, CATALOG_CALLS).items():
        for f in fs:
            f["G"] = 10
            f["ptxas_256"] = {k: v for k, v in build[
                "flash_fwd" if name == "flash_fwd" else "flash_bwd"][
                "ptxas"].items() if "Li256E" in k}
        add({name: fs}, arch=RG_ARCH, path="train")
    # (d) the ragged grouped op at OLMoE's expert shapes, bm 8
    fig["ragged"] = {}
    for method in RAGGED_FORMATS:
        for case, sizes in RAGGED_SIZES.items():
            add(check_grouped_rows(torch, quant, lg, method, sizes,
                                   RAGGED_BM, RAGGED_K, RAGGED_N,
                                   seed=70), path=f"ragged_{case}")
            counts[f"ragged_{method}_{case}"] = check_ragged_op(
                torch, quant, ops, lg, method, sizes)
        fig["ragged"][method] = {
            c: counts[f"ragged_{method}_{c}"] for c in RAGGED_SIZES}
    fig["kernel_checks_seconds"] = time.monotonic() - t_phase
    _release(torch)

    # (a), (b) training at full width and depth, 1 x 256, 3 steps; the
    # peak of one value_and_grad; gradients at full width over a few layers
    fig["train"] = {}
    for arch in RECURRENT_ARCHS:
        cfg = get_config(arch)
        argv = ["--arch", arch, "--engine", "mesp_cuda", "--device", "cuda",
                "--batch", str(PAPER_BATCH), "--seq", str(PAPER_SEQ),
                "--steps", str(RECURRENT_STEPS), "--seed", "0"]
        run, counts[f"train_{arch}"] = _train_run(
            torch, ops, train_cli, argv, recurrent_per_step(cfg, PAPER_SEQ),
            arch)
        f = {"layers": cfg.n_layers, **run["figures"]}
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = _with_b(torch, run["params"], gen)
        del run
        batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
            make_batch_iterator(cfg.vocab, PAPER_SEQ, PAPER_BATCH,
                                seed=0)).items()}
        f["params_bytes"] = quant.tree_bytes(params)
        f["peak_memory_one_value_and_grad"] = peak_memory(
            torch, cfg, params, batch, [("mesp_cuda", True), ("mebp", True)])
        del params
        _release(torch)
        cut = dataclasses.replace(cfg, n_layers=RECURRENT_GRAD_LAYERS[arch])
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = _with_b(torch, model_lib.init_params(cut, generator=gen),
                         gen, b_scale_for(cut))
        f["b_scale_checks"] = b_scale_for(cut)
        f["grads"] = compare_grads(torch, cut, params, batch,
                                   n_leaves=RECURRENT_GRAD_LEAVES[arch])
        f["grads"]["layers"] = cut.n_layers
        del params, batch
        _release(torch)
        f["decode_vs_forward_f32"] = decode_vs_forward(torch, cfg)
        fig["train"][arch] = f

    # (c) single-stream serving through the launcher
    fig["serve"] = {}
    for key, extra in SINGLE_STREAM_RUNS.items():
        argv = extra + ["--engine", "mesp_cuda", "--device", "cuda",
                        "--batch", str(SS_BATCH), "--steps", str(SS_STEPS),
                        "--max-len", str(SS_MAX_LEN), "--seed", "0"]
        method = extra[extra.index("--quantize") + 1] \
            if "--quantize" in extra else "none"
        _release(torch)
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = serve_cli.serve(argv)
        counts[f"single_stream_{key}"] = c = ops.launch_counts()
        torch.cuda.synchronize()
        per = decode_per_step(out["cfg"], method)
        steps = out["steps"] + out["warmup_steps"]
        _check_counts(c, {k: v * steps for k, v in per.items()},
                      f"single-stream {key}, {steps} decode steps")
        if out["mode"] != "single_stream" or out["tokens"] != \
                SS_BATCH * SS_STEPS:
            raise AssertionError(f"single-stream {key}: {out['mode']}, "
                                 f"{out['tokens']} tokens")
        fig["serve"][key] = {
            "layers": out["cfg"].n_layers, "quantize": method,
            "batch": SS_BATCH, "steps": out["steps"],
            "warmup_steps": out["warmup_steps"], "seconds": out["seconds"],
            "tok_s": out["tok_s"], "ms_per_step": out["ms_per_step"],
            "launches": c, "launches_per_step": {k: v for k, v in
                                                 per.items() if v},
            "params_bytes": out["params_bytes"],
            "allocated_at_start": start,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del out
    fig["seconds"] = time.monotonic() - t_phase
    return fig, counts, shapes


# ---------- step 21: the vlm and audio families
#: InternVL2-1B (configs/internvl2_1b.py): qwen2.5-0.5b's backbone shapes
#: (24 layers, d 896, 14/2 heads of 64, d_ff 4864) without qkv bias,
#: untied, vocab 151,655, and 256 patch embeddings ahead of the text;
#: Whisper-tiny (configs/whisper_tiny.py): 4 encoder layers over 1,500
#: frames, 4 decoder layers, d 384, 6 heads of 64 (G 1), d_ff 1,536, vocab
#: 51,865, untied
VLM_ARCH, AUDIO_ARCH = "internvl2-1b", "whisper-tiny"
#: text tokens a training sample (InternVL: after its 256 patch embeddings,
#: 512 rows; Whisper: beside its 1,500 frames); steps a run, and over nf4
VA_TEXT, VA_STEPS, VA_NF4_STEPS = 256, 3, 2
#: std of the random patch embeddings and frame embeddings
FRONTEND_STD, FRAMES_STD = 0.02, 1.0
#: flash at the two families' shapes (B*Hkv, G, Nq, Nk, D, causal, window,
#: rope): Whisper's encoder (1,500 keys: 23 tiles of 64 and a tail of 28,
#: masked only by the key count, since nothing causal hides it), its
#: cross-attention (256 queries over the 1,500 frames), its decoder, all
#: at 6 heads (a key read past Nk would land on the next head's keys);
#: InternVL at 512 rows, G 7
FLASH_VA_CASES = {
    "whisper_encoder": (6, 1, 1500, 1500, 64, False, 0, False),
    "whisper_cross": (6, 1, VA_TEXT, 1500, 64, False, 0, False),
    "whisper_decoder": (6, 1, VA_TEXT, VA_TEXT, 64, True, 0, False),
    "internvl": (2, 7, 512, 512, 64, True, 0, False),
}
#: InternVL served continuously: 8 slots in tiles of 2, 4 tenants
VLM_SERVE_CMD = ["--arch", VLM_ARCH, "--engine", "mesp_cuda", "--device",
                 "cuda", "--batch", "8", "--tile", "2", "--adapters", "4",
                 "--store-capacity", "4", "--requests", "8", "--prompt-len",
                 "8", "--max-new", "8", "--max-len", "32", "--seed", "0"]


def audio_shapes_per_step(cfg, text, batch=1):
    """{kernel: {(M, K, N): launches}} of Whisper's LoRA kernels in a
    mesp_cuda training step at ``text`` tokens over the encoder's frames:
    an encoder block's q, k, v, o, up, down at M = batch x frames; a
    decoder block's q, k, v, o, the cross-attention's q and o at M = batch
    x text, its k and v at M = batch x frames (they read the encoder's
    output), up and down at M = batch x text. Each linear's forward twice
    (remat), its dA/dB once, its dx once but for the q, k, v of encoder
    layer 0 and decoder layer 0 (they read the frames or the embedding,
    with their sinusoid, through a frozen norm: no input gradient)."""
    d, f = cfg.d_model, cfg.d_ff
    mt, me = batch * text, batch * cfg.encdec.encoder_seq
    enc = [(me, d, d)] * 4 + [(me, d, f), (me, f, d)]
    dec = [(mt, d, d)] * 4 + [(mt, d, d), (me, d, d), (me, d, d),
                              (mt, d, d), (mt, d, f), (mt, f, d)]
    out = {k: {} for k in ("lora_fused_fwd", "lora_dx", "lora_dab")}
    for n_layers, lin in ((cfg.encdec.encoder_layers, enc),
                          (cfg.n_layers, dec)):
        for i in range(n_layers):
            for j, s in enumerate(lin):
                for name, n in (("lora_fused_fwd", 2), ("lora_dab", 1),
                                ("lora_dx", 0 if i == 0 and j < 3 else 1)):
                    out[name][s] = out[name].get(s, 0) + n
    return out


def audio_per_step(cfg, text, quantize="none"):
    """Launches of every kernel in a mesp_cuda training step of Whisper at
    ``text`` tokens over a base in ``quantize``'s format:
    ``audio_shapes_per_step``'s LoRA kernels; the RMSNorm forward of an
    encoder block's ln1, ln2 and a decoder block's ln1, lnx, ln2 twice
    (remat), enc_norm and the final norm once; its backward of every norm
    but the first of each stack (its input is the frames' or the
    embedding's); the flash kernels for every attention whose queries
    number 64 or more (the encoder's over the frames, the decoder's self-
    and cross-attention over the text: forward twice, backward once)."""
    E, L = cfg.encdec.encoder_layers, cfg.n_layers
    fwd, dx = QUANT_KERNELS.get(quantize, ("lora_fused_fwd", "lora_dx"))
    per = {k: sum(v.values())
           for k, v in audio_shapes_per_step(cfg, text).items()}
    want = {k: 0 for k in KERNEL_NAMES}
    want.update({fwd: per["lora_fused_fwd"], dx: per["lora_dx"],
                 "lora_dab": per["lora_dab"],
                 "rmsnorm_fwd": 2 * (2 * E + 3 * L) + 2,
                 "rmsnorm_bwd": 2 * E + 3 * L})
    attn = (E if cfg.encdec.encoder_seq >= 64 else 0) + \
        (2 * L if text >= 64 else 0)
    if attn:
        want.update({"flash_fwd": 2 * attn, "flash_bwd_dq": attn,
                     "flash_bwd_dkv": attn})
    return want


def va_per_step(cfg, quantize="none"):
    """A training step's launches of either family at ``VA_TEXT`` tokens:
    InternVL's are a dense model's over 256 + ``VA_TEXT`` rows."""
    if cfg.family == "audio":
        return audio_per_step(cfg, VA_TEXT, quantize)
    return dense_per_step(cfg, cfg.frontend_tokens + VA_TEXT, quantize)


def family_inputs(torch, cfg, batch, gen):
    """The family's input from ``gen`` in ``cfg.dtype``: InternVL's patch
    embeddings [batch, 256, d] (std ``FRONTEND_STD``), Whisper's frames
    [batch, 1500, d] (std ``FRAMES_STD``)."""
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        return {"frontend_embeds": (torch.randn(
            batch, cfg.frontend_tokens, cfg.d_model, generator=gen,
            device="cuda") * FRONTEND_STD).to(dt)}
    return {"enc_frames": (torch.randn(
        batch, cfg.encdec.encoder_seq, cfg.d_model, generator=gen,
        device="cuda") * FRAMES_STD).to(dt)}


def train_with_inputs(torch, ops, cfg, quantize, steps, want, what):
    """``steps`` mesp_cuda steps of ``cfg`` at full width and depth, batch
    1 x ``VA_TEXT`` tokens of the data pipeline beside the family's input
    from the seed (``family_inputs``), the step built as ``launch.train``
    builds it (its TrainSpec, the registry's mesp_cuda, SGD; its data
    pipeline yields tokens only, as the reference's); counts zeroed just
    before and read just after, checked against ``want`` a step; losses
    finite. Returns (figures, the trained params, the last batch)."""
    from repro_torch.api.registry import get_engine
    from repro_torch.api.spec import TrainSpec
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizers, schedules
    spec = TrainSpec.from_cli_args([
        "--arch", cfg.name, "--engine", "mesp_cuda", "--device", "cuda",
        "--batch", "1", "--seq", str(VA_TEXT), "--steps", str(steps),
        "--seed", "0", "--quantize", quantize])
    opt = optimizers.make_optimizer(spec.optimizer,
                                    schedules.constant(spec.lr))
    step_fn = get_engine(spec.engine).build_step(spec, cfg, opt,
                                                 spec.policy())
    _release(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(spec.seed)
    params = model_lib.init_params(cfg, generator=gen, quantize=quantize)
    state = opt.init(params)
    data = make_batch_iterator(cfg.vocab, VA_TEXT, 1, seed=spec.seed)
    extra = family_inputs(torch, cfg, 1, gen)
    losses, secs = [], []
    ops.reset_launch_counts()
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).long().cuda()
                 for k, v in next(data).items()}
        batch.update(extra)
        t0 = time.monotonic()
        params, state, loss = step_fn(params, state, batch)
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        losses.append(float(loss))
    counts = ops.launch_counts()
    _check_counts(counts, {k: v * steps for k, v in want.items()}, what)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}")
    return {"steps": steps, "losses": losses, "seconds": secs,
            "ms_per_step": 1e3 * sum(secs[1:]) / max(1, len(secs) - 1),
            "first_step_ms": 1e3 * secs[0], "launches": counts,
            "launches_per_step": want,
            "run_peak_above_start_bytes": torch.cuda.max_memory_allocated()
            - base}, params, batch


def vlm_audio_phase(torch, build, ops, fa, lf, lg, rn, lq, lp4, quant,
                    rope_tables, train_cli, serve_cli):
    """Step 21: the kernels at InternVL2-1B's and Whisper-tiny's shapes;
    both trained at full width and depth with their gradients, peak memory
    and decode against the forward; InternVL served continuously and
    Whisper single-stream. Every run's counts zeroed just before and read
    just after it. Returns (figures, {path: counts}, {kernel: shape
    figures})."""
    t_phase = time.monotonic()
    fig, counts, shapes = {}, {}, {}
    vlm, audio = get_config(VLM_ARCH), get_config(AUDIO_ARCH)

    def add(figs, **tags):
        for name, fs in figs.items():
            for f in fs:
                f.update(tags)
            shapes.setdefault(name, []).extend(fs)

    # (a) the LoRA training kernels at Whisper's three (K, N), M 256 (the
    # text) and M 1,500 (the frames), and the nf4 forward and dx there
    # (its --quantize nf4 run); the forward at single-stream
    # decode's M 4 and 6,000 (the cross-attention's k, v over 4 x 1,500
    # frames); InternVL's four (K, N) at M 512; the norms at their rows
    d, T = audio.d_model, audio.encdec.encoder_seq
    per = audio_shapes_per_step(audio, VA_TEXT)
    step = audio_per_step(audio, VA_TEXT)
    for i, M_ in enumerate((VA_TEXT, T)):
        lin = {(K, N): {k: v.get((M_, K, N), 0) for k, v in per.items()}
               for (m, K, N) in per["lora_fused_fwd"] if m == M_}
        rows = {VA_TEXT: 3 * audio.n_layers,
                T: 2 * audio.encdec.encoder_layers}
        add(check_training_kernels(
            torch, lf, rn, M_, lin, d, rows[M_], seed=80 + 3 * i,
            n_calls=CATALOG_CALLS), arch=AUDIO_ARCH, path="train")
        add(check_quant_shapes(
            torch, quant, lq, lp4, "nf4", list(lin),
            {"lora_fused_q4": {s: n["lora_fused_fwd"]
                               for s, n in lin.items()},
             "lora_dx_q4": {s: n["lora_dx"] for s, n in lin.items()}},
            M_=M_, seed=82 + 3 * i), arch=AUDIO_ARCH, path="train_nf4")
        fwd_rows = {VA_TEXT: 2 * 3 * audio.n_layers + 1,
                    T: 2 * 2 * audio.encdec.encoder_layers + 1}
        add({"rmsnorm_fwd": [rmsnorm_train_shape(
            torch, rn, M_, d, fwd_rows[M_], seed=81 + 3 * i,
            calls=CATALOG_CALLS)]}, arch=AUDIO_ARCH, path="train")
    if sum(f["launches_per_train_step"] for f in shapes["rmsnorm_bwd"]) \
            != step["rmsnorm_bwd"] or sum(
                f["launches_per_train_step"] for f in shapes["rmsnorm_fwd"]) \
            != step["rmsnorm_fwd"]:
        raise AssertionError("step 21: RMSNorm rows do not sum to a step")
    L = audio.n_layers
    dec = {(d, d): {"lora_fused_fwd": 6 * L}, (d, audio.d_ff):
           {"lora_fused_fwd": L}, (audio.d_ff, d): {"lora_fused_fwd": L}}
    add(check_training_kernels(
        torch, lf, rn, SS_BATCH, dec, seed=86, kernels=("lora_fused_fwd",),
        n_calls=CATALOG_CALLS), arch=AUDIO_ARCH, path="single_stream")
    add(check_training_kernels(
        torch, lf, rn, SS_BATCH * T, {(d, d): {"lora_fused_fwd": 2 * L}},
        seed=87, kernels=("lora_fused_fwd",), n_calls=CATALOG_CALLS),
        arch=AUDIO_ARCH, path="single_stream")
    vrows = vlm.frontend_tokens + VA_TEXT
    vper = dense_shapes_per_step(vlm)
    vstep = va_per_step(vlm)
    add(check_training_kernels(
        torch, lf, rn, vrows, {s: {k: v[s] for k, v in vper.items()}
                               for s in dense_linears(vlm)},
        vlm.d_model, vstep["rmsnorm_bwd"], seed=88, n_calls=CATALOG_CALLS),
        arch=VLM_ARCH, path="train")
    add({"rmsnorm_fwd": [rmsnorm_train_shape(
        torch, rn, vrows, vlm.d_model, vstep["rmsnorm_fwd"], seed=89,
        calls=CATALOG_CALLS)]}, arch=VLM_ARCH, path="train")
    # flash: non-causal over 1,500 keys, 256 x 1,500, and the causal paths
    gen = torch.Generator(device="cuda").manual_seed(90)
    errs = _flash_errors(torch, fa, rope_tables, gen, FLASH_VA_CASES)
    enc, dec_attn = audio.encdec.encoder_layers, audio.n_layers
    for case, n in (("whisper_encoder", enc), ("whisper_cross", dec_attn),
                    ("whisper_decoder", dec_attn),
                    ("internvl", vlm.n_layers)):
        per_step = {"flash_fwd": 2 * n, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n}
        add(_flash_times(torch, fa, gen, errs, FLASH_VA_CASES[case],
                         per_step, CATALOG_CALLS),
            arch=AUDIO_ARCH if case.startswith("whisper") else VLM_ARCH,
            path="train", case=case)
    fig["kernel_checks_seconds"] = time.monotonic() - t_phase
    _release(torch)

    # (b) training at full width and depth, 1 x 256 text tokens; the
    # gradients against the plain backend in bf16 and f32, every layer (the
    # encoder's leaves too); the peak of one value_and_grad
    fig["train"] = {}
    runs = ((VLM_ARCH, vlm, "none", VA_STEPS, 14),
            (AUDIO_ARCH, audio, "none", VA_STEPS, 32),
            (f"{AUDIO_ARCH}/nf4", audio, "nf4", VA_NF4_STEPS, 32))
    for key, cfg, method, steps, n_leaves in runs:
        f, params, batch = train_with_inputs(
            torch, ops, cfg, method, steps, va_per_step(cfg, method), key)
        counts[f"train_{key}"] = f["launches"]
        f["layers"] = cfg.n_layers
        f["rows"] = {"text": VA_TEXT, **{
            k: list(v.shape[1:]) for k, v in batch.items()
            if k in ("frontend_embeds", "enc_frames")}}
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = _with_b(torch, params, gen, b_scale_for(cfg))
        f["b_scale_checks"] = b_scale_for(cfg)
        f["params_bytes"] = quant.tree_bytes(params)
        f["grads"] = compare_grads(torch, cfg, params, batch, method,
                                   n_leaves=n_leaves)
        engines = [("mesp_cuda", True), ("mebp", True)]
        if cfg.family == "audio" and method == "none":
            # mesp: core/flash.py's chunks over the 1,500 frames (1,024 +
            # 476, non-causal)
            engines.append(("mesp", True))
        f["peak_memory_one_value_and_grad"] = peak_memory(
            torch, cfg, params, batch, engines, method)
        del params, batch
        _release(torch)
        fig["train"][key] = f

    # (c) decode against the forward in f32, 64 positions: Whisper against
    # its own encoder's output, InternVL on text alone
    fig["decode_vs_forward_f32"] = {
        VLM_ARCH: decode_vs_forward(torch, vlm),
        AUDIO_ARCH: decode_vs_forward(torch, audio)}

    # (d) serving: InternVL continuous (the grouped decode forward), Whisper
    # single-stream (the dense LoRA forward; its cross k/v at M 4 x 1,500)
    fig["serve"] = {}
    for key, argv in (
            (VLM_ARCH, VLM_SERVE_CMD),
            (AUDIO_ARCH, ["--arch", AUDIO_ARCH, "--engine", "mesp_cuda",
                          "--device", "cuda", "--batch", str(SS_BATCH),
                          "--steps", str(SS_STEPS), "--max-len",
                          str(SS_MAX_LEN), "--seed", "0"])):
        _release(torch)
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = serve_cli.serve(argv)
        counts[f"serve_{key}"] = c = ops.launch_counts()
        torch.cuda.synchronize()
        cfg = out["cfg"]
        steps = out["steps"] + out["warmup_steps"]
        if out["mode"] == "continuous":
            per = {"lora_grouped_fwd": 7 * cfg.n_layers,
                   "rmsnorm_fwd": 2 * cfg.n_layers + 1}
            want_tokens = 8 * 8
        else:
            per = {k: v for k, v in decode_per_step(cfg).items() if v}
            want_tokens = SS_BATCH * SS_STEPS
        _check_counts(c, {k: v * steps for k, v in per.items()},
                      f"{key} serve ({out['mode']}), {steps} decode steps")
        if out["tokens"] != want_tokens or out["mode"] != (
                "continuous" if cfg.family == "vlm" else "single_stream"):
            raise AssertionError(f"{key} serve: {out['mode']}, "
                                 f"{out['tokens']} tokens")
        fig["serve"][key] = {
            "mode": out["mode"], "layers": cfg.n_layers,
            "requests": out["requests"], "tokens": out["tokens"],
            "steps": out["steps"], "warmup_steps": out["warmup_steps"],
            "seconds": out["seconds"], "tok_s": out["tok_s"],
            "ms_per_step": out["ms_per_step"], "launches": c,
            "launches_per_step": per, "params_bytes": out["params_bytes"],
            "allocated_at_start": start,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del out
    fig["seconds"] = time.monotonic() - t_phase
    return fig, counts, shapes


# ---------------------------------------------------------------------------
# step 22: the autotuner (kernels/autotune.py) and the data axis
# ---------------------------------------------------------------------------

GEMMA_MLP = get_config("gemma3-12b")
#: the dense sweep's shapes: (model, M) -> {linears: (K, N)}: qwen2.5-0.5b's
#: seven linears at the paper's 256 rows, Gemma3-12B's MLP at 1 x 2048
AUTOTUNE_DENSE = {
    ("qwen2.5-0.5b", QM): {"q,o": (D_MODEL, D_MODEL), "k,v": (D_MODEL, KV),
                           "gate,up": (D_MODEL, D_FF),
                           "down": (D_FF, D_MODEL)},
    ("gemma3-12b", 2048): {"gate,up": (GEMMA_MLP.d_model, GEMMA_MLP.d_ff),
                           "down": (GEMMA_MLP.d_ff, GEMMA_MLP.d_model)},
}
AUTOTUNE_FORMATS = ("none", "nf4")
#: each candidate: a warm-up launch (checked against the plain version),
#: then this many rounds of autotune.LAUNCHES_PER_ROUND launches
AUTOTUNE_REPEATS = 3
#: the cold timings' calls: about AUTOTUNE_MS of launches each, 20 to 400
AUTOTUNE_MS, AUTOTUNE_CALLS = 40.0, 400
#: lookups timed a case for the host cost of ``choose_blocks``
LOOKUP_CALLS = 20000
#: the data-parallel phase: qwen2.5-0.5b at 1 x 256, mesp_cuda, 3 steps
DP_STEPS = 3
#: the compression check's top-k fraction
DP_TOPK = 0.05


def _dense_sweep_cases(torch, quant, gen, method, M_, K, N):
    """make() of one dense shape's bf16 inputs: x, W0 as the format stores
    it (bf16 W0 and a dummy scale, or nf4's q4 and scale), a, b, g, and W0
    in bf16 (the matmul context's operand)."""
    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        w = rn(K, N) * K ** -0.5
        if method == "none":
            w = w.to(torch.bfloat16)
            codes, scale, dense = w, torch.ones(1, device="cuda"), w
        else:
            leaf = quant.quantize_leaf(w, method)
            codes, scale = leaf["q4"], leaf["scale"]
            dense = quant.maybe_dequant(leaf, torch.bfloat16)
        return (rn(M_, K).to(torch.bfloat16), codes, scale,
                (rn(K, RANK) * RANK ** -0.5).to(torch.bfloat16),
                (rn(RANK, N) * 0.1).to(torch.bfloat16),
                rn(M_, N).to(torch.bfloat16), dense)
    return make


def _dense_sweep_call(lf, lp4, method, body):
    """(op, kernel(*args, split=None), plain(*args), matmul(*args)) of the
    dense bf16 forward or dx over ``method``'s base, on
    ``_dense_sweep_cases``' inputs."""
    import torch
    if method == "none":
        fwd = lambda x, q, s, a, b, g, w, split=None: lf.lora_fused(
            x, q, a, b, split=split)
        dx = lambda x, q, s, a, b, g, w, split=None: lf.lora_dx(
            g, q, a, b, split=split)
        fref = lambda x, q, s, a, b, g, w: lf.lora_fused_ref(x, q, a, b)
        dref = lambda x, q, s, a, b, g, w: lf.lora_dx_ref(g, q, a, b)
        ops = ("lora_fused", "lora_dx")
    else:
        fwd = lambda x, q, s, a, b, g, w, split=None: lp4.lora_fused_q4(
            x, q, s, a, b, method=method, split=split)
        dx = lambda x, q, s, a, b, g, w, split=None: lp4.lora_dx_q4(
            g, q, s, a, b, method=method, split=split)
        fref = lambda x, q, s, a, b, g, w: lp4.lora_fused_q4_ref(
            x, q, s, a, b, method=method)
        dref = lambda x, q, s, a, b, g, w: lp4.lora_dx_q4_ref(
            g, q, s, a, b, method=method)
        ops = ("lora_fused_q4", "lora_dx_q4")
    if body == "fwd":
        return ops[0], fwd, fref, \
            lambda x, q, s, a, b, g, w: torch.matmul(x, w)
    return ops[1], dx, dref, \
        lambda x, q, s, a, b, g, w: torch.matmul(g, w.T)


def _sweep_figures(torch, tune, op, kern, plain, mm, make, dims, nbytes,
                   flops, candidates, heuristic):
    """One sweep: ``autotune.autotune`` over ``candidates`` (each held
    against the plain version at KERNEL_TOL, the absolute floor scaled to
    the output's largest magnitude; a candidate refused at launch fails
    the phase, as every one is within the entries' hard limits and so a
    plan the heuristic may choose), then the heuristic's and the winner's
    plans and x @ W0 (or g @ W0^T) timed cold (``_time_ms``) beside the
    bound."""
    args = make()
    want = plain(*args)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.float().abs().max()))
    tol = dict(rtol=KERNEL_TOL["rtol"], atol=KERNEL_TOL["atol"] * scale)
    best = tune.autotune(op, lambda plan: kern(*args, plan),
                         candidates=candidates, dtype=torch.bfloat16,
                         repeats=AUTOTUNE_REPEATS, want=want, tol=tol,
                         **dims)
    refused = [p for p, ms in tune.LAST_SWEEP["times"] if ms is None]
    if refused:     # every candidate here is within the entries' limits
        raise AssertionError(f"autotune: {op} at {dims} refused the plans "
                             f"{refused}, which the heuristic may choose")
    sweep = [{"plan": p, "ms": ms} for p, ms in tune.LAST_SWEEP["times"]]
    warm = {json.dumps(p, sort_keys=True): ms
            for p, ms in tune.LAST_SWEEP["times"]}
    sets = _cold_sets(make, nbytes)
    bound, by = _bound_ms(nbytes, flops)
    calls = int(max(20, min(AUTOTUNE_CALLS, AUTOTUNE_MS / max(
        ms for _, ms in tune.LAST_SWEEP["times"]))))
    out = {**dims, "op": op, "candidates": len(candidates), "sweep": sweep,
           "heuristic": heuristic,
           "heuristic_warm_ms": warm[json.dumps(heuristic, sort_keys=True)],
           "heuristic_ms": _time_ms(lambda *a: kern(*a, heuristic), sets,
                                    calls),
           "winner": best,
           "winner_warm_ms": warm[json.dumps(best, sort_keys=True)],
           "winner_ms": _time_ms(lambda *a: kern(*a, best), sets, calls),
           "matmul_ms": _time_ms(mm, sets, calls), "cold_calls": calls,
           "bound_ms": bound, "bound_by": by, "bytes": nbytes,
           "flops": flops}
    del sets
    return out


def _lookup_us(torch, tune, op, dims):
    """µs a ``choose_blocks`` call of ``op`` at ``dims`` by the host
    clock, over ``LOOKUP_CALLS`` calls."""
    t0 = time.perf_counter()
    for _ in range(LOOKUP_CALLS):
        tune.choose_blocks(op, torch.bfloat16, **dims)
    return 1e6 * (time.perf_counter() - t0) / LOOKUP_CALLS


def autotune_phase(torch, lf, lp4, lg, quant):
    """Step 22 (a): the measured autotuner on the card. Sweeps the bf16
    dense forward and dx over a bf16 and an nf4 base at
    ``AUTOTUNE_DENSE``'s shapes (every split 1..8 the hard limits allow)
    and the grouped decode body at qwen2.5-0.5b's serve shapes, M 8 (every
    split x bn 64 / 128), each candidate held against the plain version;
    saves the winners to a temporary file (never into the repo), loads
    them into a fresh cache, checks that ``choose_blocks`` answers each
    shape with its winner, relaunches every swept shape with no explicit
    plan and checks that each launch hit the cache and gave the bits of a
    launch given the winner's plan. Then times the host cost of a lookup
    (a cached plan, the heuristic, a fixed plan). The cache is left empty,
    so the phases' plans stay the heuristic's."""
    import tempfile
    from repro_torch.kernels import autotune as tune
    tune.clear_cache()
    gen = torch.Generator(device="cuda").manual_seed(22)
    dense, relaunch = [], []
    for (model, M_), shapes in AUTOTUNE_DENSE.items():
        for linears, (K, N) in shapes.items():
            for method in AUTOTUNE_FORMATS:
                make = _dense_sweep_cases(torch, quant, gen, method, M_, K,
                                          N)
                wbytes = 2 * K * N if method == "none" else \
                    (K + 1) // 2 * N + 4 * N
                nbytes = 2 * (M_ * K + K * RANK + RANK * N + M_ * N) + wbytes
                flops = 2 * M_ * K * N + 2 * M_ * RANK * (K + N)
                for body in ("fwd", "dx"):
                    op, kern, plain, mm = _dense_sweep_call(lf, lp4, method,
                                                            body)
                    call = lambda *a, _k=kern: _k(*a[:-1], split=a[-1][
                        "split"])
                    dims = {"M": M_, "K": K, "N": N}
                    limit = tune.dense_split_limit(K if body == "fwd" else N)
                    cands = [{"split": s} for s in range(1, limit + 1)]
                    fig = _sweep_figures(
                        torch, tune, op, call, plain, mm, make, dims, nbytes,
                        flops, cands, tune._heuristic(op, dims,
                                                      torch.bfloat16))
                    dense.append({"model": model, "linears": linears,
                                  "format": method, "body": body, **fig})
                    relaunch.append((op, kern, make, dims, fig["winner"]))
    decode = []
    gid = torch.tensor(PATH_GID, dtype=torch.int32, device="cuda")
    used = int(torch.unique(gid).numel())
    for (K, N) in GROUPED_SHAPES:
        def make(K=K, N=N):
            rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
            return ((rn(M, K)).to(torch.bfloat16),
                    (rn(K, N) * K ** -0.5).to(torch.bfloat16),
                    (rn(R, K, RANK) * RANK ** -0.5).to(torch.bfloat16),
                    (rn(R, RANK, N) * 0.05).to(torch.bfloat16), gid.clone())
        kern = lambda x, w, a, b, g, plan=None: lg.lora_grouped(
            x, w, a, b, g, 2.0, bm=BM, plan=plan)
        plain = lambda x, w, a, b, g: lg.lora_grouped_ref(x, w, a, b, g, 2.0,
                                                          bm=BM)
        mm = lambda x, w, a, b, g: torch.matmul(x, w)
        dims = {"M": M, "K": K, "N": N, "r": RANK, "bm": BM}
        nk = -(-K // lg.DECODE_KD)
        cands = [{"split": s, "bn": bn}
                 for s in range(1, min(lg.DECODE_MAX_SPLIT, nk) + 1)
                 for bn in (64, 128)]
        nbytes = 2 * (M * K + K * N + used * (K * RANK + RANK * N) + M * N) \
            + 4 * gid.numel()
        flops = 2 * M * K * N + 2 * M * RANK * (K + N)
        fig = _sweep_figures(torch, tune, "lora_grouped", kern, plain, mm,
                             make, dims, nbytes, flops, cands,
                             tune._heuristic("lora_grouped", dims,
                                             torch.bfloat16))
        decode.append({"model": "qwen2.5-0.5b", "body": "decode",
                       "format": "none", **fig})
        relaunch.append(("lora_grouped", kern, make, dims, fig["winner"]))

    # the winners through a file into a fresh cache, then hit on relaunch
    path = Path(tempfile.mkdtemp(prefix="repro_torch_autotune_")) / \
        f"{tune.backend_generation()}.json"
    tune.save_cache(str(path))
    saved = json.loads(path.read_text())
    tune.clear_cache()
    loaded = tune.load_cache(str(path))
    if loaded != len(relaunch) or len(saved) != len(relaunch):
        raise AssertionError(f"autotune: {len(relaunch)} sweeps, {loaded} "
                             f"plans loaded from {len(saved)} saved")
    for op, kern, make, dims, best in relaunch:
        chosen = tune.choose_blocks(op, torch.bfloat16, **dims)
        if chosen != best:
            raise AssertionError(f"autotune: {op} at {dims} chooses "
                                 f"{chosen}, the cache holds {best}")
    hits0 = tune.cache_stats()["cache_hit"]
    for op, kern, make, dims, best in relaunch:
        args = make()
        got = kern(*args)                       # no plan: the cache's
        explicit = kern(*args, best) if op == "lora_grouped" else \
            kern(*args, split=best["split"])
        torch.cuda.synchronize()
        if not torch.equal(got, explicit):
            raise AssertionError(f"autotune: {op} at {dims} launched "
                                 f"other bits than the cached {best}")
    hits = tune.cache_stats()["cache_hit"] - hits0
    if hits != len(relaunch):
        raise AssertionError(f"autotune: {hits} cache hits on "
                             f"{len(relaunch)} relaunches")
    counters = tune.cache_stats()
    # the host cost of a dispatch's lookup: a cached plan, the heuristic,
    # a fixed plan (µs a call by the host clock, LOOKUP_CALLS calls)
    op, _, _, dims, _ = relaunch[0]
    lookup_us = {"cache_hit": _lookup_us(torch, tune, op, dims)}
    tune.clear_cache()
    lookup_us["heuristic"] = _lookup_us(torch, tune, op, dims)
    lookup_us["fixed"] = _lookup_us(torch, tune, "rmsnorm",
                                    {"M": QM, "d": D_MODEL})
    path.unlink()
    path.parent.rmdir()
    return {"dense": dense, "decode": decode, "saved_plans": len(saved),
            "loaded_plans": loaded, "relaunch_cache_hits": hits,
            "generation": tune.backend_generation(),
            "counters": counters, "lookup_us": lookup_us,
            "lookup_calls": LOOKUP_CALLS, "repeats": AUTOTUNE_REPEATS,
            "launches_per_round": tune.LAUNCHES_PER_ROUND}


def data_parallel_phase(torch, ops, cfg):
    """Step 22 (b): the data axis on the card. An ``nccl`` process group of
    world size 1 (a free local port) and an explicit data mesh of one rank;
    qwen2.5-0.5b at full width trains ``DP_STEPS`` ``mesp_cuda`` steps at 1
    x 256 through the Trainer with the mesh (exact launch counts) and
    through the same Trainer with none: losses and LoRA state bit for bit.
    Then ``to_bf16`` and ``topk_sparsify`` (with error feedback) on the
    mesh run's LoRA gradients as CUDA tensors, against their CPU results,
    bit for bit."""
    import socket
    import tempfile
    import torch.distributed as dist
    from repro_torch.api.spec import TrainSpec
    from repro_torch.api.trainer import Trainer
    from repro_torch.core import mesp
    from repro_torch.optim import compression
    from repro_torch.runtime import elastic
    from repro_torch.tree import tree_leaves, tree_map
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        spec = TrainSpec(arch=cfg.name, engine="mesp_cuda", device="cuda",
                         batch=PAPER_BATCH, seq=PAPER_SEQ, steps=DP_STEPS,
                         seed=0, lr=ENGINES_LR,
                         ckpt_dir=tempfile.mkdtemp(prefix="repro_torch_dp_"))
        runs = {}
        for name, mesh in (("mesh", elastic.make_mesh_from_devices([0], 1)),
                           ("no_mesh", None)):
            _release(torch)
            tr = Trainer.from_spec(spec, mesh=mesh)
            params, opt = tr.shard_state(*tr.init_state())
            data = tr.make_data()
            losses, secs = [], []
            ops.reset_launch_counts()
            for _ in range(DP_STEPS):
                batch = next(data)       # this rank's rows
                t0 = time.monotonic()
                params, opt, loss = tr.step_fn(params, opt, batch)
                torch.cuda.synchronize()
                secs.append(time.monotonic() - t0)
                losses.append(float(loss))
            counts = ops.launch_counts()
            want = {k: v * DP_STEPS for k, v in PAPER_PER_STEP.items()}
            _check_counts(counts, {**{k: 0 for k in counts}, **want},
                          f"data_parallel {name}")
            runs[name] = {"losses": losses, "seconds": secs,
                          "launches": counts, "lora": _lora_leaves(params),
                          "dp": tr.dp, "batch": batch, "params": params}
            if name == "no_mesh":
                break
            del params, opt
        m, n = runs["mesh"], runs["no_mesh"]
        if m["losses"] != n["losses"] or any(
                not torch.equal(a, b) for a, b in zip(m["lora"].values(),
                                                      n["lora"].values())):
            raise AssertionError(f"data_parallel: a mesh of one rank is not "
                                 f"no mesh bit for bit: {m['losses']} vs "
                                 f"{n['losses']}")
        if m["dp"].size != 1 or m["dp"].bytes_all_reduced != 0:
            raise AssertionError("data_parallel: one rank all-reduced "
                                 f"{m['dp'].bytes_all_reduced} bytes")
        # compression on the card against the CPU on a step's gradients
        batch = {k: torch.from_numpy(v).long().cuda()
                 for k, v in n["batch"].items()}
        _, grads = mesp.value_and_grad(n["params"], cfg, batch,
                                       policy=spec.policy())
        cpu = tree_map(lambda t: None if t is None else t.cpu(), grads)
        b16 = compression.to_bf16(grads)
        same = lambda u, v: all(torch.equal(a.cpu(), b) for a, b in zip(
            tree_leaves(u), tree_leaves(v)))
        comp = {"bf16_bitwise": same(b16, compression.to_bf16(cpu)),
                "f32_round_trip_bitwise": same(
                    compression.from_bf16(b16),
                    compression.from_bf16(compression.to_bf16(cpu)))}
        err_g = err_c = None
        sent_ok = True
        for _ in range(3):
            sg, err_g = compression.topk_sparsify(grads, DP_TOPK, err_g)
            sc, err_c = compression.topk_sparsify(cpu, DP_TOPK, err_c)
            sent_ok = sent_ok and same(sg, sc) and same(err_g, err_c)
        comp["topk_bitwise"] = sent_ok
        comp["topk_frac"] = DP_TOPK
        comp["sent_nonzero"] = int(sum(int((t != 0).sum())
                                       for t in tree_leaves(sg)))
        if not all(comp[k] for k in ("bf16_bitwise",
                                     "f32_round_trip_bitwise",
                                     "topk_bitwise")):
            raise AssertionError(f"data_parallel: compression on the card "
                                 f"differs from the CPU: {comp}")
    finally:
        dist.destroy_process_group()
    return {"backend": "nccl", "world_size": 1, "mesh": {"data": 1,
                                                          "model": 1},
            "steps": DP_STEPS, "losses": m["losses"],
            "seconds_mesh": m["seconds"], "seconds_no_mesh": n["seconds"],
            "launches": m["launches"], "bitwise_vs_no_mesh": True,
            "bytes_all_reduced": 0, "compression": comp}


# ----------------------------------------------------- step 23: model axis

#: the model axis of step 23: two ranks on the one card over gloo
TP = 2
TP_STEPS = 3
TP_RUNS = ("none", "nf4")
TP_FLAG = "--tensor-parallel-rank"
#: seconds the two ranks may take together
TP_TIMEOUT = 420
#: one rank's part of qwen2.5-0.5b's layer at TP 2: 7 q heads over 1 KV
#: head, d_ff 2,432 (its linears are the kernels' shard shapes)
TP_SHARD = dataclasses.replace(QWEN, n_heads=QWEN.n_heads // TP,
                               n_kv_heads=QWEN.n_kv_heads // TP,
                               d_ff=QWEN.d_ff // TP)
TP_LINEARS = dense_linears(TP_SHARD)
TP_SHAPES = dense_shapes_per_step(TP_SHARD)
# flash on a rank: B*Hkv 1, G 7, N 256, D 64, causal
TP_FLASH = (1, N_HEADS // TP, PAPER_SEQ, PAPER_SEQ, HEAD_DIM, True, 0, False)


def tp_partial_numel(cfg):
    """LoRA elements whose gradient each rank holds a part of: A of q, k,
    v, gate and up, B of o and down (``models/parallel.partial_lora``)."""
    r, d = cfg.lora.rank, cfg.d_model
    return cfg.n_layers * r * (5 * d + 2 * d)


def tp_model_axis_bytes(cfg, tokens, mp, sp, partial, act):
    """Bytes a rank hands to the model axis in one remat step of the dense
    family (the derivation of ``tests/test_torch_tensor_parallel.py``):
    sums travel in f32 over the whole [tokens, d], gathers in the
    activations' type (``act`` bytes) over [tokens / mp, d]; a block's
    forward collectives run twice (the recompute stops after the down
    linear, skipping its sum), its backward ones once; block 0's ln1
    output needs no gradient; then the embedding's sum, the head's gather
    and its gradient's sum, the loss's two all-reduces and the partial
    LoRA leaves in f32."""
    d, L = cfg.d_model, cfg.n_layers
    whole = tokens * d * 4
    if sp:
        ag = tokens // mp * d * act
        fwd, bwd, head = 2 * (ag + whole), 2 * (whole + ag), ag + whole
    else:
        fwd = bwd = 2 * whole
        head = whole
    return (L * (fwd + (fwd - whole) + bwd) - whole + whole + head
            + 3 * tokens * 4 + 4 * partial)


def tp_kernel_figures(torch, lf, rn, lq, lp4, fa, quant, rope_tables):
    """The kernels of a rank's TP-2 step against their plain versions at
    the shard shapes, timed (bf16): the LoRA forward, dx and dA/dB at M
    256 over ``TP_LINEARS``, the quantized forward and dx over int8 and
    nf4 there, RMSNorm forward and backward over a rank's 128 rows, flash
    at G 7 over one KV head. Returns {kernel: [shape figures]}."""
    lin = {s: {k: v[s] for k, v in TP_SHAPES.items()} for s in TP_LINEARS}
    out = check_training_kernels(torch, lf, rn, QM, lin, seed=41, kernels=(
        "lora_fused_fwd", "lora_dx", "lora_dab"))
    rows = QM // TP
    out.update(check_training_kernels(
        torch, lf, rn, rows, {}, D_MODEL, PAPER_PER_STEP["rmsnorm_bwd"],
        seed=42, kernels=("rmsnorm_bwd",)))
    out["rmsnorm_fwd"] = [rmsnorm_train_shape(
        torch, rn, rows, D_MODEL, PAPER_PER_STEP["rmsnorm_fwd"], seed=43)]
    for method in ("int8", "nf4"):
        fwd, dx = QUANT_KERNELS[method]
        out.update(check_quant_shapes(
            torch, quant, lq, lp4, method, TP_LINEARS,
            {fwd: TP_SHAPES["lora_fused_fwd"], dx: TP_SHAPES["lora_dx"]},
            seed=44))
    gen = torch.Generator(device="cuda").manual_seed(45)
    errs = _flash_errors(torch, fa, rope_tables, gen, {"tp": TP_FLASH})
    out.update(_flash_times(torch, fa, gen, errs, TP_FLASH, FLASH_PER_STEP))
    return out


def _gloo_cuda_ops(torch, dist):
    """Whether this gloo group takes CUDA tensors in the all-gather and
    reduce-scatter of ``runtime/elastic.ModelParallel``: "ok" or the
    error each raised (a record: the phase's steps have used both by
    then, and a refusal there fails the phase)."""
    out = {}
    x = torch.arange(4, dtype=torch.float32, device="cuda") + dist.get_rank()
    calls = {"all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
        torch.empty(8, device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device="cuda"), x)}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:   # recorded, not a phase
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def tensor_parallel_worker(rank, port, out_dir):
    """One rank of step 23 (``python chip_smoke.py --tensor-parallel-rank
    R PORT DIR``, started by ``tensor_parallel_phase``): a gloo group of 2
    over CUDA tensors on card 0, the Trainer on a (data 1, model 2) mesh.
    For each base of ``TP_RUNS``: ``TP_STEPS`` mesp_cuda steps of
    qwen2.5-0.5b at 1 x 256 with the counts zeroed just before and read
    just after (each step: the single process's), the bytes handed to the
    model axis against ``tp_model_axis_bytes``. Over the bf16 base: one
    ``value_and_grad``'s LoRA gradients on step 8's weights and batch
    (every B drawn nonzero), gathered whole, against the single process's plain bf16 and f32 ones (rank 0
    runs those) in bf16 and with the kernels in f32; the peak of one
    ``value_and_grad`` with remat on and off. Writes rank_<R>.json."""
    import datetime
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.api.spec import TrainSpec
    from repro_torch.api.trainer import Trainer
    from repro_torch.core import mesp
    from repro_torch.data import make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import elastic
    rank = int(rank)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=TP, timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    cfg = QWEN
    tokens = PAPER_BATCH * PAPER_SEQ
    res = {"rank": rank, "runs": {}}
    for method in TP_RUNS:
        spec = TrainSpec(arch=cfg.name, engine="mesp_cuda", device="cuda",
                         batch=PAPER_BATCH, seq=PAPER_SEQ, steps=TP_STEPS,
                         seed=0, lr=ENGINES_LR, quantize=method,
                         model_parallel=TP,
                         ckpt_dir=tempfile.mkdtemp(prefix="repro_torch_tp_"))
        tr = Trainer.from_spec(spec)
        if tr.mesh.shape != {"data": 1, "model": TP} or not tr.policy.sp:
            raise AssertionError(f"tensor_parallel: mesh {tr.mesh.shape}, "
                                 f"sp {tr.policy.sp}")
        # every rank draws the whole model from the seed and keeps its part
        params, opt = tr.place_state(*tr.init_state())
        _release(torch)
        state_bytes = torch.cuda.memory_allocated()
        data = tr.make_data()
        losses, secs = [], []
        want = PAPER_PER_STEP if method == "none" else quant_per_step(method)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        tr.tp.bytes_model_axis = 0
        for _ in range(TP_STEPS):
            batch = next(data)
            t0 = time.monotonic()
            params, opt, loss = tr.step_fn(params, opt, batch)
            losses.append(float(loss))
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t0)
        counts = ops.launch_counts()
        _check_counts(counts, {k: v * TP_STEPS for k, v in want.items()},
                      f"tensor_parallel rank {rank} {method}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"tensor_parallel {method}: losses "
                                 f"{losses}")
        per_step = tr.tp.bytes_model_axis / TP_STEPS
        partial = tp_partial_numel(cfg)
        want_bytes = tp_model_axis_bytes(cfg, tokens, TP, True, partial, 2)
        if per_step != want_bytes:
            raise AssertionError(f"tensor_parallel {method}: "
                                 f"{per_step} bytes a step to the model "
                                 f"axis, derived {want_bytes}")
        res["runs"][method] = {
            "losses": losses, "seconds": secs, "launches": counts,
            "bytes_model_axis_per_step": per_step,
            "bytes_model_axis_derived": want_bytes,
            "partial_lora_bytes_per_step": 4 * partial,
            "state_bytes": state_bytes}
        if method == "none":
            # the peak of one value_and_grad above the rank's state
            res["peak_memory_one_value_and_grad"] = {
                "mesp_cuda" if remat else "mesp_cuda/remat_off": _peak(
                    torch, lambda: mesp.value_and_grad(
                        params, cfg, {k: torch.from_numpy(v).long().cuda()
                                      for k, v in batch.items()},
                        policy=dataclasses.replace(tr.policy, remat=remat)))
                for remat in (True, False)}
        del params, opt
        if method != "none":
            continue
        # gradients: the TP kernels (bf16, and in f32) vs one process, on
        # step 8's weights (B drawn on from the init's generator) and batch
        gen = torch.Generator(device="cuda").manual_seed(0)
        W = _with_b(torch, model_lib.init_params(cfg, generator=gen), gen)
        batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
            make_batch_iterator(cfg.vocab, PAPER_SEQ, PAPER_BATCH,
                                seed=0)).items()}
        pspec = tr.param_specs()
        f32 = dataclasses.replace(cfg, dtype="float32")

        def tp_run(c, whole):
            loss, g = mesp.value_and_grad(
                elastic.place_tree(whole, tr.mesh, pspec), c, batch,
                policy=tr.policy)
            return float(loss), _grad_leaves(elastic.gather_tree(
                g, tr.mesh, pspec, tr.tp.group))
        loss, grads = {}, {}
        loss["kernels"], grads["kernels"] = tp_run(cfg, W)
        loss["kernels_f32"], grads["kernels_f32"] = tp_run(f32, _f32(W))
        if rank == 0:     # the single process's plain runs, no collective
            one = _grad_runs(torch, cfg, W, batch)
            for name in ("plain", "f32"):
                loss[name] = one[0][name]
                grads[name] = one[1][name]
            d = _distances(torch, loss, grads)
            # the single process's kernels on the same inputs, beside them
            d["single_process_worst"] = _distances(torch, *one)["worst"]
            _check_grads(d)
            _check_f32_kernels(d, CATALOG_F32_GRAD_TOL)
            res["grads_vs_single_process"] = d
            del one
        # nothing of the check outlives it: the next run's state_bytes
        del W, loss, grads
        _release(torch)
    res["gloo_cuda"] = _gloo_cuda_ops(torch, dist)
    dist.barrier()
    dist.destroy_process_group()
    Path(out_dir, f"rank_{rank}.json").write_text(json.dumps(res))
    return 0


def tensor_parallel_phase(torch, lf, rn, lq, lp4, fa, quant, rope_tables):
    """Step 23: the model axis. The kernels at a rank's TP-2 shard shapes
    (``tp_kernel_figures``); the single process's peak of one mesp_cuda
    ``value_and_grad`` (remat on and off); then two ranks on the one card
    over gloo (``tensor_parallel_worker``), every kernel built here first,
    so the two never run ``nvcc`` into one directory. The two ranks check
    themselves and fail the phase on any miss. Returns (figure, {kernel:
    [TP shape figures]}, {run: rank 0's launch counts})."""
    import os
    import socket
    import tempfile
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as model_lib
    t0 = time.monotonic()
    shapes = tp_kernel_figures(torch, lf, rn, lq, lp4, fa, quant,
                               rope_tables)
    t_kernels = time.monotonic() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model_lib.init_params(QWEN, generator=gen)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(QWEN.vocab, PAPER_SEQ, PAPER_BATCH,
                            seed=0)).items()}
    single = peak_memory(torch, QWEN, params, batch,
                         runs=[("mesp_cuda", True), ("mesp_cuda", False)])
    del params, batch
    _release(torch)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="repro_torch_tp_ranks_")
    logs = [open(Path(out_dir, f"stderr_{r}"), "w+") for r in range(TP)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), TP_FLAG, str(r),
         str(port), out_dir], stdout=subprocess.DEVNULL, stderr=logs[r],
        env=dict(os.environ)) for r in range(TP)]
    t1 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() - t1 > TP_TIMEOUT:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    tails = []
    for r, log in enumerate(logs):
        log.seek(0)
        tails.append(f"--- rank {r} rc={procs[r].returncode}\n"
                     + log.read()[-4000:])
        log.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("tensor_parallel: a rank failed\n"
                             + "\n".join(tails))
    ranks = [json.loads(Path(out_dir, f"rank_{r}.json").read_text())
             for r in range(TP)]
    r0 = ranks[0]
    fig = {
        "mesh": {"data": 1, "model": TP}, "backend": "gloo (CUDA tensors)",
        "ranks_on_one_card": TP, "steps": TP_STEPS,
        "runs": {m: {**r0["runs"][m], "losses_rank1":
                     ranks[1]["runs"][m]["losses"]} for m in TP_RUNS},
        "grads_vs_single_process": r0["grads_vs_single_process"],
        "grad_tol": GRAD_TOL, "f32_kernels_tol": CATALOG_F32_GRAD_TOL,
        "b_scale": B_SCALE,
        "peak_memory_one_value_and_grad": {
            "rank0": r0["peak_memory_one_value_and_grad"],
            "rank1": ranks[1]["peak_memory_one_value_and_grad"],
            "single_process": single},
        "state_bytes": {m: [r["runs"][m]["state_bytes"] for r in ranks]
                        for m in TP_RUNS},
        "gloo_cuda": r0["gloo_cuda"], "kernel_figures_seconds": t_kernels,
        "ranks_seconds": time.monotonic() - t1,
        "note": "two ranks share one card over gloo: a check of the "
                "shard shapes and the collectives, not a tensor-parallel "
                "speed"}
    for m in TP_RUNS:
        if ranks[1]["runs"][m]["losses"] != r0["runs"][m]["losses"]:
            raise AssertionError(f"tensor_parallel {m}: the ranks' losses "
                                 f"differ: {fig['runs'][m]}")
    return fig, shapes, {m: r0["runs"][m]["launches"] for m in TP_RUNS}


def main() -> int:
    t_start = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.core import flash as core_flash
    from repro_torch.core import mesp
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_fused as lf
    from repro_torch.core import quant
    from repro_torch.kernels import lora_grouped as lg
    from repro_torch.kernels import lora_pack4 as lp4
    from repro_torch.kernels import lora_quant as lq
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rope
    from repro_torch.kernels.rope import rope_tables
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import moe as moe_lib
    from repro_torch.serve.residency import serve_residency

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _build.build_all()
    build = {}
    for stem, info in _build.BUILD_INFO.items():
        log = Path(info["log"]).read_text() if info["log"] else ""
        build[stem] = {"seconds": info["seconds"], "ptxas": ptxas(log)}
    print(json.dumps({"build": build}))

    grouped = check_grouped(torch, lg)
    rms = check_rmsnorm(torch, rn)
    rms_sha = rmsnorm_fwd_sha256(torch, rn)
    if rms_sha != RMS_FWD_SHA256:
        raise AssertionError(f"rmsnorm_fwd output bits {rms_sha} differ "
                             f"from before the shared row loads: "
                             f"{RMS_FWD_SHA256}")
    training = check_training_kernels(torch, lf, rn)
    # the LoRA forward and dx at the paper path's 256 rows (the same
    # launches a step as at seq 48)
    paper_lora = check_training_kernels(
        torch, lf, rn, QM, seed=12, kernels=("lora_fused_fwd",))
    paper_lora.update(check_training_kernels(
        torch, lf, rn, QM, seed=14, kernels=("lora_dx",)))
    paper_lora.update(check_training_kernels(
        torch, lf, rn, QM, seed=15, kernels=("lora_dab",)))
    rms_train = rmsnorm_train_shape(torch, rn)
    # the dense kernels at the MoE path's shapes: q, k, v, o (2048 x 2048)
    # at 256 rows, the norms over [256, 2048]
    moe_dense = check_training_kernels(
        torch, lf, rn, QM, {(MOE_D, MOE_D): {
            k: MOE_PER_STEP[k] for k in ("lora_fused_fwd", "lora_dx",
                                         "lora_dab")}},
        MOE_D, MOE_PER_STEP["rmsnorm_bwd"], seed=10)
    moe_dense["rmsnorm_fwd"] = [rmsnorm_train_shape(
        torch, rn, QM, MOE_D, MOE_PER_STEP["rmsnorm_fwd"], seed=11)]
    flash, flash_moe = check_flash(torch, fa, rope_tables)
    qfig, qragged, qmoe = check_quant_kernels(torch, quant, lq, lp4)
    gq_fig, gq_edges = check_grouped_quant(torch, quant, lg)
    nf4_rounding = check_nf4_codebook_rounding(torch, quant, lg, lp4)
    moe_fig, moe_edges = check_grouped_train(torch, lg)
    mq_fig, mq_edges = check_grouped_quant_train(torch, quant, lg)
    rope_fig = check_rope(torch, rope)

    # the main path: counts zeroed just before, read just after
    _release(torch)
    serve_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_cli.serve(SERVE_CMD)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = out["steps"] + out["warmup_steps"]
    want = {**{k: 0 for k in counts},
            "lora_grouped_fwd": GROUPED_PER_STEP * steps,
            "rmsnorm_fwd": RMS_PER_STEP * steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want} for "
                             f"{steps} decode steps")
    if out["tokens"] != 8 * 16 or out["requests"] != 8:
        raise AssertionError(f"served {out['requests']} requests / "
                             f"{out['tokens']} tokens, expected 8 / 128")

    logit_err = compare_logits(torch, out["cfg"], out["params"])
    serve_peak, cfg = peak, out["cfg"]
    del out["params"], out["batcher"]

    # the main path over a quantized base: counts zeroed just before, read
    # just after each run
    squant, scounts, ssteps = {}, {}, {}
    for method in SERVE_QUANT_RUNS:
        _release(torch)
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        run = serve_cli.serve(SERVE_CMD + ["--quantize", method])
        scounts[method] = ops.launch_counts()
        torch.cuda.synchronize()
        rpeak, rend = (torch.cuda.max_memory_allocated(),
                       torch.cuda.memory_allocated())
        ssteps[method] = run["steps"] + run["warmup_steps"]
        want = {**{k: 0 for k in scounts[method]},
                GROUPED_Q_KERNELS[method]: GROUPED_PER_STEP * ssteps[method],
                "rmsnorm_fwd": RMS_PER_STEP * ssteps[method]}
        if scounts[method] != want:
            raise AssertionError(f"--quantize {method}: launch counts "
                                 f"{scounts[method]}, expected {want} for "
                                 f"{ssteps[method]} decode steps")
        if run["tokens"] != 8 * 16 or run["requests"] != 8:
            raise AssertionError(f"--quantize {method}: served "
                                 f"{run['requests']} requests / "
                                 f"{run['tokens']} tokens, expected 8 / 128")
        bat = run["batcher"]
        squant[method] = {
            "requests": run["requests"], "tokens": run["tokens"],
            "steps": run["steps"], "warmup_steps": run["warmup_steps"],
            "seconds": run["seconds"],
            "tok_s": run["tokens"] / run["seconds"],
            "ms_per_step": 1e3 * run["seconds"] / run["steps"],
            "launches": scounts[method],
            "launches_per_step": {k: v / ssteps[method]
                                  for k, v in scounts[method].items() if v},
            "weights_fmt": run["weights_fmt"],
            "base_bytes": run["base_bytes"],
            "params_bytes": run["params_bytes"],
            "allocated_at_start": start, "max_memory_allocated": rpeak,
            "allocated_at_end": rend,
            "modelled_at_end": serve_residency(
                cfg, rank=cfg.lora.rank, resident_adapters=bat.store.resident,
                kv_pages=bat.alloc.counters["peak_pages"],
                page_size=bat.alloc.page_size, batch=M,
                weights_fmt=run["weights_fmt"]),
            "logits_max_rel_err": compare_logits(
                torch, run["cfg"], run["params"], quantize=method)}
        del run, bat
    base_mem = base_memory(torch, cfg)
    for method, fig in squant.items():
        fig["init_peak_bytes"] = base_mem[fig["weights_fmt"]]["init_peak_bytes"]

    # the training path: counts zeroed just before, read just after
    ops.reset_launch_counts()
    tr = train_cli.train([
        "--arch", "qwen2.5-0.5b", "--engine", "mesp_cuda", "--device",
        "cuda", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--steps", str(TRAIN_STEPS), "--seed", "0"])
    tcounts = ops.launch_counts()
    twant = {k: v * TRAIN_STEPS for k, v in TRAIN_PER_STEP.items()}
    if tcounts != twant:
        raise AssertionError(f"training launch counts {tcounts}, expected "
                             f"{twant} for {TRAIN_STEPS} steps")
    if len(tr["losses"]) != TRAIN_STEPS or \
            not all(map(math.isfinite, tr["losses"])):
        raise AssertionError(f"training losses {tr['losses']}")
    del tr["params"]

    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as model_lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _with_b(torch, model_lib.init_params(cfg, generator=gen), gen)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                            seed=0)).items()}
    grads = compare_grads(torch, cfg, params, batch)
    peaks = peak_memory(torch, cfg, params, batch)

    # the paper's setting: counts zeroed just before, read just after each
    # run, first as the CLI runs by default, then with --fuse-rope
    paper_cmd = ["--arch", "qwen2.5-0.5b", "--engine", "mesp_cuda",
                 "--device", "cuda", "--batch", str(PAPER_BATCH), "--seq",
                 str(PAPER_SEQ), "--seed", "0"]
    paper, pcounts = {}, {}
    for run, nsteps, extra in (("paper", PAPER_STEPS, []),
                               ("paper_rope", ROPE_STEPS, ["--fuse-rope"])):
        _release(torch)
        ops.reset_launch_counts()
        paper[run] = train_cli.train(paper_cmd + ["--steps", str(nsteps)]
                                     + extra)
        pcounts[run] = ops.launch_counts()
        del paper[run]["params"]
        pwant = {k: v * nsteps for k, v in PAPER_PER_STEP.items()}
        if pcounts[run] != pwant:
            raise AssertionError(f"{run}: launch counts {pcounts[run]}, "
                                 f"expected {pwant} for {nsteps} steps")
        if len(paper[run]["losses"]) != nsteps or \
                not all(map(math.isfinite, paper[run]["losses"])):
            raise AssertionError(f"{run}: losses {paper[run]['losses']}")
    rope_err = [abs(u - w) / abs(w) for u, w in zip(
        paper["paper_rope"]["losses"], paper["paper"]["losses"])]
    if max(rope_err) > LOSS_TOL:
        raise AssertionError(f"--fuse-rope losses {paper['paper_rope']} "
                             f"differ from {paper['paper']} over {LOSS_TOL}")
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(cfg.vocab, PAPER_SEQ, PAPER_BATCH,
                            seed=0)).items()}
    paper_grads = compare_grads(torch, cfg, params, batch)
    paper_peaks = peak_memory(
        torch, cfg, params, batch,
        [(e, True) for e in ENGINE_NAMES]
        + [("mesp_cuda", False), ("mebp", False)])
    del params, batch

    # the quantized base at the paper's setting: counts zeroed just before,
    # read just after each run
    qruns, qcounts = {}, {}
    for method in QUANT_RUNS:
        _release(torch)
        ops.reset_launch_counts()
        run = train_cli.train(paper_cmd + ["--steps", str(QUANT_STEPS),
                                           "--quantize", method])
        qcounts[method] = ops.launch_counts()
        qwant = {k: v * QUANT_STEPS for k, v in quant_per_step(method).items()}
        if qcounts[method] != qwant:
            raise AssertionError(f"--quantize {method}: launch counts "
                                 f"{qcounts[method]}, expected {qwant} for "
                                 f"{QUANT_STEPS} steps")
        if len(run["losses"]) != QUANT_STEPS or \
                not all(map(math.isfinite, run["losses"])):
            raise AssertionError(f"--quantize {method}: losses "
                                 f"{run['losses']}")
        qsecs = run["seconds"]
        qruns[method] = {
            "losses": run["losses"], "seconds": qsecs,
            "ms_per_step": 1e3 * sum(qsecs[1:]) / max(1, len(qsecs) - 1),
            "first_step_ms": 1e3 * qsecs[0], "launches": qcounts[method],
            "launches_per_step": quant_per_step(method),
            "params_bytes": quant.tree_bytes(run["params"]),
            "frozen_base_bytes": quant.tree_bytes(run["params"],
                                                  frozen_base=True)}
        del run
    _release(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    qparams = _with_b(torch, model_lib.init_params(
        cfg, generator=gen, quantize="nf4"), gen)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(cfg.vocab, PAPER_SEQ, PAPER_BATCH,
                            seed=0)).items()}
    quant_grads = compare_grads(torch, cfg, qparams, batch, "nf4")
    quant_peaks = peak_memory(
        torch, cfg, qparams, batch,
        [(e, True) for e in ("mesp_cuda", "mesp", "mebp")]
        + [(e, False) for e in ("mesp_cuda", "mesp", "mebp")], "nf4")
    quant_params_bytes = {
        "params_bytes": quant.tree_bytes(qparams),
        "frozen_base_bytes": quant.tree_bytes(qparams, frozen_base=True)}
    del qparams, batch

    # MoE training: full-width OLMoE-1B-7B at batch 1 x seq 256, counts
    # zeroed just before, read just after
    _release(torch)
    ops.reset_launch_counts()
    mrun = train_cli.train(["--arch", MOE_ARCH, "--engine", "mesp_cuda",
                            "--device", "cuda", "--batch", str(PAPER_BATCH),
                            "--seq", str(PAPER_SEQ), "--steps",
                            str(MOE_STEPS), "--seed", "0"])
    mcounts = ops.launch_counts()
    mwant = {k: v * MOE_STEPS for k, v in MOE_PER_STEP.items()}
    if mcounts != mwant:
        raise AssertionError(f"{MOE_ARCH}: launch counts {mcounts}, expected "
                             f"{mwant} for {MOE_STEPS} steps")
    if len(mrun["losses"]) != MOE_STEPS or \
            not all(map(math.isfinite, mrun["losses"])):
        raise AssertionError(f"{MOE_ARCH}: losses {mrun['losses']}")
    mcfg, msecs = mrun["cfg"], mrun["seconds"]
    moe_params_bytes = quant.tree_bytes(mrun["params"])
    del mrun["params"]
    _release(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mparams = _with_b(torch, model_lib.init_params(mcfg, generator=gen), gen)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(mcfg.vocab, PAPER_SEQ, PAPER_BATCH,
                            seed=0)).items()}
    moe_grads = compare_grads_moe(torch, moe_lib, mcfg, mparams, batch)
    repeat = [mesp.value_and_grad(mparams, mcfg, batch,
                                  policy=ExecutionPolicy(backend="cuda",
                                                         device="cuda"))
              for _ in range(2)]
    (l1, g1), (l2, g2) = repeat
    g1, g2 = _grad_leaves(g1), _grad_leaves(g2)
    if not torch.equal(l1, l2) or g1.keys() != g2.keys() or not all(
            torch.equal(g1[k], g2[k]) for k in g1):
        raise AssertionError(f"{MOE_ARCH}: two value_and_grad calls differ")
    del repeat, g1, g2
    moe_peaks = peak_memory(
        torch, mcfg, mparams, batch,
        [(e, True) for e in ("mesp_cuda", "mesp", "mebp")]
        + [(e, False) for e in ("mesp_cuda", "mesp", "mebp")])
    del mparams
    # the gradients at GRAD_TOL, at full width and a depth where the plain
    # bf16 gradients still follow the f32 ones
    _release(torch)
    cut = dataclasses.replace(mcfg, n_layers=MOE_GRAD_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    moe_grads_cut = compare_grads_moe(
        torch, moe_lib, cut,
        _with_b(torch, model_lib.init_params(cut, generator=gen), gen),
        batch, GRAD_TOL)

    # MoE over a quantized base: counts zeroed just before, read just
    # after each run
    mq_runs, mq_counts = {}, {}
    for method, nsteps in MOE_QUANT_RUNS.items():
        _release(torch)
        ops.reset_launch_counts()
        run = train_cli.train(["--arch", MOE_ARCH, "--engine", "mesp_cuda",
                               "--device", "cuda", "--batch",
                               str(PAPER_BATCH), "--seq", str(PAPER_SEQ),
                               "--steps", str(nsteps), "--seed", "0",
                               "--quantize", method])
        mq_counts[method] = ops.launch_counts()
        want = {k: v * nsteps for k, v in moe_quant_per_step(method).items()}
        if mq_counts[method] != want:
            raise AssertionError(f"{MOE_ARCH} --quantize {method}: launch "
                                 f"counts {mq_counts[method]}, expected "
                                 f"{want} for {nsteps} steps")
        if len(run["losses"]) != nsteps or \
                not all(map(math.isfinite, run["losses"])):
            raise AssertionError(f"{MOE_ARCH} --quantize {method}: losses "
                                 f"{run['losses']}")
        qsecs = run["seconds"]
        mq_runs[method] = {
            "steps": nsteps, "losses": run["losses"], "seconds": qsecs,
            "ms_per_step": 1e3 * sum(qsecs[1:]) / max(1, len(qsecs) - 1),
            "first_step_ms": 1e3 * qsecs[0], "launches": mq_counts[method],
            "launches_per_step": moe_quant_per_step(method),
            "params_bytes": quant.tree_bytes(run["params"]),
            "frozen_base_bytes": quant.tree_bytes(run["params"],
                                                  frozen_base=True)}
        del run
    _release(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mq_params = _with_b(torch, model_lib.init_params(
        mcfg, generator=gen, quantize="nf4"), gen)
    mq_grads = compare_grads_moe(torch, moe_lib, mcfg, mq_params, batch,
                                 quantize="nf4")
    pol = ExecutionPolicy(backend="cuda", device="cuda", quantize="nf4")
    (l1, g1), (l2, g2) = [mesp.value_and_grad(mq_params, mcfg, batch,
                                              policy=pol) for _ in range(2)]
    g1, g2 = _grad_leaves(g1), _grad_leaves(g2)
    if not torch.equal(l1, l2) or g1.keys() != g2.keys() or not all(
            torch.equal(g1[k], g2[k]) for k in g1):
        raise AssertionError(f"{MOE_ARCH} nf4: two value_and_grad calls "
                             "differ")
    del g1, g2
    mq_peaks = peak_memory(
        torch, mcfg, mq_params, batch,
        [(e, True) for e in ("mesp_cuda", "mesp", "mebp")]
        + [(e, False) for e in ("mesp_cuda", "mesp", "mebp")], "nf4")
    del mq_params
    _release(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mq_grads_cut = compare_grads_moe(
        torch, moe_lib, cut, _with_b(torch, model_lib.init_params(
            cut, generator=gen, quantize="nf4"), gen), batch, GRAD_TOL,
        "nf4")
    del batch
    moe_init = {quant.weights_format(m): init_memory(torch, mcfg, m)
                for m in ("none", "int8", "nf4")}

    # the paper's other engines on qwen2.5-0.5b at batch 1 x seq 256; each
    # main path's counts zeroed just before and read just after it
    _release(torch)
    t_new = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _with_b(torch, model_lib.init_params(cfg, generator=gen), gen)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(cfg.vocab, PAPER_SEQ, PAPER_BATCH,
                            seed=0)).items()}
    phase_s = {}
    for phase, fn in (("train_seq", train_seq), ("zo", zo_check),
                      ("train_engines", train_engines)):
        t0 = time.monotonic()
        phase_s[phase] = (fn(torch, cfg, params, batch),
                          time.monotonic() - t0)
    del params, batch
    _release(torch)
    t0 = time.monotonic()
    phase_s["core_flash"] = (check_core_flash(torch, ops, core_flash),
                             time.monotonic() - t0)
    (seq_fig, zo_fig, engines_fig, core_flash_fig), new_s = zip(
        *phase_s.values())
    new_seconds = time.monotonic() - t_new

    # the production launcher around the step: every run's counts zeroed
    # just before and read just after it, inside the phase
    trainer_fig = trainer_phase(torch, cfg)

    # the rest of the dense catalog: every run's counts zeroed just before
    # and read just after it, inside the phase
    catalog, ccounts, cshapes = dense_catalog_phase(
        torch, build, ops, fa, lf, lg, rn, lq, lp4, quant, rope_tables,
        train_cli, serve_cli)

    # single-stream serving and the recurrent families: every run's counts
    # zeroed just before and read just after it, inside the phase
    recurrent, rcounts, rshapes = recurrent_phase(
        torch, build, ops, fa, lf, lg, rn, lq, lp4, quant, rope_tables,
        train_cli, serve_cli)

    # the vlm and audio families: every run's counts zeroed just before
    # and read just after it, inside the phase
    vlm_audio, vcounts, vshapes = vlm_audio_phase(
        torch, build, ops, fa, lf, lg, rn, lq, lp4, quant, rope_tables,
        train_cli, serve_cli)

    # step 22: the autotuner's sweeps (the cache left empty after them, so
    # every phase above and below runs the heuristic's plans), then the
    # data axis over nccl at world size 1 (counts zeroed just before each
    # run and read just after it, inside the phase)
    t22 = time.monotonic()
    autotune_fig = autotune_phase(torch, lf, lp4, lg, quant)
    t22b = time.monotonic()
    _release(torch)
    dp_fig = data_parallel_phase(torch, ops, cfg)
    autotune_fig["seconds"] = t22b - t22
    dp_fig["seconds"] = time.monotonic() - t22b

    # step 23: the model axis, two ranks on the one card (each rank's
    # counts zeroed just before and read just after each run, inside it)
    t23 = time.monotonic()
    _release(torch)
    tp_fig, tp_shapes, tp_counts = tensor_parallel_phase(
        torch, lf, rn, lq, lp4, fa, quant, rope_tables)
    tp_fig["seconds"] = time.monotonic() - t23

    paths = lambda k: {**{p: c[k] for p, c in ccounts.items()},
                       **{p: c.get(k, 0) for p, c in rcounts.items()},
                       **{p: c.get(k, 0) for p, c in vcounts.items()},
                       "serve": counts[k],
                       **{f"serve_{m}": c[k] for m, c in scounts.items()},
                       "train": tcounts[k],
                       **{run: c[k] for run, c in pcounts.items()},
                       **{f"train_{m}": c[k] for m, c in qcounts.items()},
                       "train_moe": mcounts[k],
                       **{f"train_moe_{m}": c[k]
                          for m, c in mq_counts.items()},
                       **{f"tensor_parallel_{m}": c[k]
                          for m, c in tp_counts.items()}}
    def with_moe(e, moe_shapes):
        """``e`` with the kernel's figures at the MoE path's shapes (each
        per launch, with its launches a step), their errors in its own."""
        e["train_moe_shapes"] = moe_shapes
        e["max_abs_err"] = e["max_err"] = max(
            [e["max_abs_err"]] + [s_["max_abs_err"] for s_ in moe_shapes])
        return e
    train_entry = lambda name, cu, line, fn: with_moe(kernel_entry(
        name, f"src/repro_torch/csrc/{cu}", line, fn, training[name],
        paths(name), TRAIN_STEPS, step="train",
        matmul_ms=sum((s.get("matmul_ms") or 0.0)
                      * s["launches_per_train_step"]
                      for s in training[name]) or None), moe_dense[name])
    flash_entry = lambda name, cu, line, fn: with_moe(kernel_entry(
        name, f"src/repro_torch/csrc/{cu}", line, fn, flash[name],
        paths(name), PAPER_STEPS, step="train", path="paper",
        train_step=f"batch {PAPER_BATCH} x seq {PAPER_SEQ}",
        library_fwd_bwd_ms=flash[name][0]["library_fwd_bwd_ms"] * N_LAYERS,
        tol_f32=FLASH_F32_TOL,
        ptxas_bf16={f: v for f, v in build[cu[:-3]]["ptxas"].items()
                    if f"{name}_tc" in f}), [flash_moe[name]])


    def quant_entry(name, cu, line, fn, method):
        shapes = qfig[(name, method)]
        extra = {}
        if method == "nf4":     # the same kernel body over int4 codes
            int4 = qfig[(name, "int4")]
            extra = {"int4_shapes": int4, "int4_ms": sum(
                s["ms"] * s["launches_per_train_step"] for s in int4),
                "int4_max_abs_err": max(s["max_abs_err"] for s in int4),
                "ragged_int4": qragged[(name, "int4")]}
        e = kernel_entry(
            name, f"src/repro_torch/csrc/{cu}", line, fn, shapes,
            paths(name), QUANT_STEPS, step="train", path=f"train_{method}",
            train_step=f"batch {PAPER_BATCH} x seq {PAPER_SEQ}, --quantize "
                       f"{method}", method=method,
            matmul_ms=sum(s["matmul_ms"] * s["launches_per_train_step"]
                          for s in shapes),
            ragged=qragged[(name, method)], **extra)
        # OLMoE-1B-7B's q, k, v, o over the same base (M 256, 2048 x 2048)
        moe_shapes = {m: qmoe[(name, m)] for m in (
            ("int4", "nf4") if method == "nf4" else (method,))}
        e["train_moe_shapes"] = moe_shapes[method]
        if method == "nf4":
            e["int4_train_moe_shapes"] = moe_shapes["int4"]
        e["max_abs_err"] = e["max_err"] = max(
            [e["max_abs_err"], qragged[(name, method)]["max_abs_err"]]
            + [f["max_abs_err"] for v in moe_shapes.values() for f in v]
            + ([extra["int4_max_abs_err"],
                extra["ragged_int4"]["max_abs_err"]] if extra else []))
        e.update(dense_tc_figures(
            build, lf, tuple(moe_shapes), [(QM, K, N) for K, N in LINEARS]
            + [QUANT_RAGGED, (QM, MOE_D, MOE_D)],
            "fwd" if name.startswith("lora_fused") else "dx"))
        return e

    def grouped_q_entry(name, line, fn, method):
        shapes, edges = gq_fig[method], gq_edges[method]
        extra = {}
        if method == "nf4":     # the same kernel body over int4 codes
            int4 = gq_fig["int4"]
            extra = {"int4_shapes": int4, "int4_ms": sum(
                s["ms"] * s["launches_per_decode_step"] for s in int4),
                "int4_max_abs_err": max(
                    [s["max_abs_err"] for s in int4]
                    + [v["max_abs_err"] for v in gq_edges["int4"].values()]),
                "edges_int4": gq_edges["int4"],
                "bf16_codebook_rounding": nf4_rounding}
        if method == "nf4":
            extra["ptxas_bf16_int4"] = decode_tc_figures(build, "int4")
        e = kernel_entry(
            name, "src/repro_torch/csrc/lora_grouped_fwd.cu", line, fn,
            shapes, paths(name), ssteps[method], path=f"serve_{method}",
            method=method, decode_step=f"serve --quantize {method}",
            matmul_ms=sum(s["matmul_ms"] * s["launches_per_decode_step"]
                          for s in shapes), edges=edges,
            ptxas_bf16=decode_tc_figures(build, method), **extra)
        e["max_abs_err"] = e["max_err"] = max(
            [e["max_abs_err"]] + [v["max_abs_err"] for v in edges.values()]
            + ([extra["int4_max_abs_err"]] if extra else []))
        return e

    def moe_entry(name, line, fn):
        shapes, err = moe_fig[name], 0.0
        for edge in moe_edges.values():
            err = max([err] + [v for k, v in edge.items()
                               if k.startswith(name + "/")])
        e = kernel_entry(
            name, "src/repro_torch/csrc/lora_grouped_train.cu", line, fn,
            shapes, paths(name), MOE_STEPS, step="train", path="train_moe",
            train_step=f"{MOE_ARCH}, batch {PAPER_BATCH} x seq {PAPER_SEQ}",
            matmul_ms=sum((s_["matmul_ms"] or 0.0)
                          * s_["launches_per_train_step"]
                          for s_ in shapes) or None,
            tol_f32=dict(rtol=1e-5, atol=1e-5), edges=moe_edges)
        e["max_abs_err"] = e["max_err"] = max(e["max_abs_err"], err)
        if name in ("lora_grouped_gemm", "lora_grouped_dx"):
            e.update(grouped_tc_figures(
                build, ("dense",), body="fwd" if name.endswith("gemm")
                else "dx"))
        else:
            e.update(dab_tc_figures(build, "lora_grouped_train", {
                f"{K}x{N}": lg.dab_plan(MOE_E * MOE_C, K, N, MOE_E, RANK,
                                        bm=MOE_BM) for K, N in MOE_SHAPES}))
        return e

    def moe_q_entry(name, line, fn, method):
        shapes = mq_fig[(name, method)]
        edges = mq_edges[(name, method)]
        extra = {}
        if method == "nf4":     # the same kernel body over int4 codes
            int4 = mq_fig[(name, "int4")]
            extra = {"int4_shapes": int4, "int4_ms": sum(
                s_["ms"] * s_["launches_per_train_step"] for s_ in int4),
                "int4_max_abs_err": max(
                    [s_["max_abs_err"] for s_ in int4]
                    + [v["max_abs_err"]
                       for v in mq_edges[(name, "int4")].values()]),
                "edges_int4": mq_edges[(name, "int4")]}
        e = kernel_entry(
            name, "src/repro_torch/csrc/lora_grouped_train.cu", line, fn,
            shapes, paths(name), MOE_QUANT_RUNS[method], step="train",
            path=f"train_moe_{method}",
            train_step=f"{MOE_ARCH}, batch {PAPER_BATCH} x seq {PAPER_SEQ}, "
                       f"--quantize {method}", method=method,
            matmul_ms=sum(s_["matmul_ms"] * s_["launches_per_train_step"]
                          for s_ in shapes),
            tol_f32=dict(rtol=1e-4, atol=1e-4), edges=edges, **extra)
        e["max_abs_err"] = e["max_err"] = max(
            [e["max_abs_err"]] + [v["max_abs_err"] for v in edges.values()]
            + ([extra["int4_max_abs_err"]] if extra else []))
        e.update(grouped_tc_figures(
            build, ("int8",) if method == "int8" else ("int4", "nf4"),
            body="fwd" if name.startswith("lora_grouped_gemm") else "dx"))
        return e

    head = rope_fig["olmoe"]
    rope_entry = {
        "name": "rope_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rope.cu",
        "replaces": "src/repro/kernels/rope.py:92",
        "tpu_kernel": "src/repro/kernels/rope.py:rope_fwd / rope_apply "
                      "(_rope_kernel :63; VJP :112-123)",
        "launches": sum(paths("rope_fwd").values()),
        "launches_by_path": paths("rope_fwd"), "on_main_path": False,
        "max_abs_err": 0.0, "max_err": 0.0, "bitwise": True,
        "unit": "ms per launch, bf16, x [1, 256, 16, 128] (OLMoE's q at "
                "seq 256)",
        "ms": head["ms"], "plain_ms": head["plain_ms"], "library_ms": None,
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "ptxas": build["rope"]["ptxas"], "shapes": rope_fig}

    def paper_entry(name, cu, line, fn, body):
        """The bf16 dense LoRA forward's, dx's or dA/dB's entry: the seq-48
        path's shapes (M 192), with the paper path's (M 256) and OLMoE's
        beside them, and the tensor-core body's figures."""
        e = train_entry(name, cu, line, fn)
        paper_shapes = paper_lora[name]
        e["paper_shapes"] = paper_shapes
        e["paper_step"] = f"batch {PAPER_BATCH} x seq {PAPER_SEQ}"
        for key in ("ms", "plain_ms", "matmul_ms"):
            e[f"paper_{key}"] = sum(f[key] * f["launches_per_train_step"]
                                    for f in paper_shapes)
        e["max_abs_err"] = e["max_err"] = max(
            [e["max_abs_err"]] + [f["max_abs_err"] for f in paper_shapes])
        shapes = [(f["M"], f["K"], f["N"]) for f in training[name]
                  + paper_shapes + moe_dense[name]]
        if body == "dab":
            e.update(dab_tc_figures(build, "lora_dab", {
                f"{M_}x{K}x{N}": lf.dab_plan(M_, K, N, RANK)
                for M_, K, N in shapes}))
        else:
            e.update(dense_tc_figures(build, lf, ("none",), shapes, body))
        return e

    kernels = [
        kernel_entry("lora_grouped_fwd",
                     "src/repro_torch/csrc/lora_grouped_fwd.cu",
                     "src/repro/kernels/lora_grouped.py:183",
                     "src/repro/kernels/lora_grouped.py:lora_grouped "
                     "(_grouped_fwd_kernel :69)", grouped,
                     paths("lora_grouped_fwd"), steps,
                     matmul_ms=sum(s_["matmul_ms"]
                                   * s_["launches_per_decode_step"]
                                   for s_ in grouped),
                     ptxas_bf16=decode_tc_figures(build, "dense")),
        grouped_q_entry("lora_grouped_q",
                        "src/repro/kernels/lora_grouped.py:205",
                        "src/repro/kernels/lora_grouped.py:lora_grouped_q "
                        "(_grouped_fwd_q_kernel :91)", "int8"),
        grouped_q_entry("lora_grouped_q4",
                        "src/repro/kernels/lora_grouped.py:227",
                        "src/repro/kernels/lora_grouped.py:lora_grouped_q4 "
                        "(_grouped_fwd_q4_kernel :114, lora_pack4.py "
                        "_unpack_tile :54)", "nf4"),
        with_moe(kernel_entry(
            "rmsnorm_fwd", "src/repro_torch/csrc/rmsnorm_fwd.cu",
            "src/repro/kernels/rmsnorm.py:26",
            "src/repro/kernels/rmsnorm.py:rmsnorm (_rmsnorm_kernel :19)",
            rms, paths("rmsnorm_fwd"), steps, train_shape=rms_train,
            sha256=rms_sha, sha256_before_rownorm=RMS_FWD_SHA256),
            moe_dense["rmsnorm_fwd"]),
        paper_entry("lora_fused_fwd", "lora_fused_fwd.cu",
                    "src/repro/kernels/lora_fused.py:87",
                    "src/repro/kernels/lora_fused.py:lora_fused "
                    "(_lora_fused_kernel :39)", "fwd"),
        paper_entry("lora_dx", "lora_dx.cu",
                    "src/repro/kernels/lora_fused.py:146",
                    "src/repro/kernels/lora_fused.py:lora_dx "
                    "(_lora_dx_kernel :106)", "dx"),
        paper_entry("lora_dab", "lora_dab.cu",
                    "src/repro/kernels/lora_fused.py:225",
                    "src/repro/kernels/lora_fused.py:lora_dab "
                    "(_lora_dab_kernel :175)", "dab"),
        dict(train_entry("rmsnorm_bwd", "rmsnorm_bwd.cu",
                         "src/repro/kernels/rmsnorm.py:61",
                         "src/repro/kernels/rmsnorm.py:rmsnorm_bwd "
                         "(_rmsnorm_bwd_kernel :48)"),
             ptxas=build["rmsnorm_bwd"]["ptxas"]),
        flash_entry("flash_fwd", "flash_fwd.cu",
                    "src/repro/kernels/flash_attention.py:216",
                    "src/repro/kernels/flash_attention.py:"
                    "flash_attention_fwd (_fwd_kernel :92)"),
        flash_entry("flash_bwd_dq", "flash_bwd.cu",
                    "src/repro/kernels/flash_attention.py:488",
                    "src/repro/kernels/flash_attention.py:"
                    "flash_attention_bwd (_bwd_dq_kernel :260)"),
        flash_entry("flash_bwd_dkv", "flash_bwd.cu",
                    "src/repro/kernels/flash_attention.py:488",
                    "src/repro/kernels/flash_attention.py:"
                    "flash_attention_bwd (_bwd_dkv_kernel :318)"),
        quant_entry("lora_fused_q", "lora_quant.cu",
                    "src/repro/kernels/lora_quant.py:93",
                    "src/repro/kernels/lora_quant.py:lora_fused_q "
                    "(_lora_fused_q_kernel :41)", "int8"),
        quant_entry("lora_dx_q", "lora_quant.cu",
                    "src/repro/kernels/lora_quant.py:158",
                    "src/repro/kernels/lora_quant.py:lora_dx_q "
                    "(_lora_dx_q_kernel :114)", "int8"),
        quant_entry("lora_fused_q4", "lora_pack4.cu",
                    "src/repro/kernels/lora_pack4.py:125",
                    "src/repro/kernels/lora_pack4.py:lora_fused_q4 "
                    "(_lora_fused_q4_kernel :71, _unpack_tile :54)", "nf4"),
        quant_entry("lora_dx_q4", "lora_pack4.cu",
                    "src/repro/kernels/lora_pack4.py:197",
                    "src/repro/kernels/lora_pack4.py:lora_dx_q4 "
                    "(_lora_dx_q4_kernel :148)", "nf4"),
        moe_entry("lora_grouped_gemm", "src/repro/kernels/lora_grouped.py:183",
                  "src/repro/kernels/lora_grouped.py:lora_grouped, Ew = E "
                  "(_grouped_fwd_kernel :69, _w_index :56)"),
        moe_entry("lora_grouped_dx", "src/repro/kernels/lora_grouped.py:373",
                  "src/repro/kernels/lora_grouped.py:lora_grouped_dx "
                  "(_grouped_dx_kernel :254, _grouped_dh :361)"),
        moe_entry("lora_grouped_dab", "src/repro/kernels/lora_grouped.py:501",
                  "src/repro/kernels/lora_grouped.py:lora_grouped_dab "
                  "(_grouped_dab_kernel :444)"),
        moe_q_entry("lora_grouped_gemm_q",
                    "src/repro/kernels/lora_grouped.py:205",
                    "src/repro/kernels/lora_grouped.py:lora_grouped_q, "
                    "Ew = E (_grouped_fwd_q_kernel :91)", "int8"),
        moe_q_entry("lora_grouped_gemm_q4",
                    "src/repro/kernels/lora_grouped.py:227",
                    "src/repro/kernels/lora_grouped.py:lora_grouped_q4, "
                    "Ew = E (_grouped_fwd_q4_kernel :114, lora_pack4.py "
                    "_unpack_tile :54)", "nf4"),
        moe_q_entry("lora_grouped_dx_q",
                    "src/repro/kernels/lora_grouped.py:394",
                    "src/repro/kernels/lora_grouped.py:lora_grouped_dx_q "
                    "(_grouped_dx_q_kernel :275)", "int8"),
        moe_q_entry("lora_grouped_dx_q4",
                    "src/repro/kernels/lora_grouped.py:417",
                    "src/repro/kernels/lora_grouped.py:lora_grouped_dx_q4 "
                    "(_grouped_dx_q4_kernel :297)", "nf4"),
        rope_entry,
    ]
    # each kernel's figures at the catalog's shapes beside its own (Gemma3:
    # flash at head dim 256, the training kernels at M 2048; qwen2.5-32b's
    # MLP over nf4), their errors in its own
    for e in kernels:
        for key, by_name in (("catalog_shapes", cshapes),
                             ("recurrent_shapes", rshapes),
                             ("vlm_audio_shapes", vshapes),
                             ("tp_shapes", tp_shapes)):
            figs = by_name.get(e["name"])
            if figs:
                e[key] = figs
                e["max_abs_err"] = e["max_err"] = max(
                    [e["max_abs_err"]] + [f["max_abs_err"] for f in figs])
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": {
        "arch": "qwen2.5-0.5b", "dtype": "bfloat16", "slots": M, "tile": BM,
        "tenants": 4, "requests": out["requests"], "tokens": out["tokens"],
        "steps": out["steps"], "warmup_steps": out["warmup_steps"],
        "seconds": out["seconds"], "tok_s": out["tokens"] / out["seconds"],
        "ms_per_step": 1e3 * out["seconds"] / out["steps"],
        "max_memory_allocated": serve_peak,
        "allocated_at_start": serve_start, "launches": counts,
        "logits_max_rel_err": logit_err, "logits_tol": LOGIT_TOL,
        "device": name}}))
    print(json.dumps({"serve_quant": {
        "arch": "qwen2.5-0.5b", "dtype": "bfloat16", "slots": M, "tile": BM,
        "tenants": 4, "runs": squant,
        "bf16": {"ms_per_step": 1e3 * out["seconds"] / out["steps"],
                 "max_memory_allocated": serve_peak,
                 "allocated_at_start": serve_start,
                 "init_peak_bytes": base_mem["bf16"]["init_peak_bytes"]},
        "base_memory": base_mem, "logits_tol": LOGIT_TOL, "device": name}}))
    secs = tr["seconds"]
    print(json.dumps({"train": {
        "arch": "qwen2.5-0.5b", "engine": "mesp_cuda", "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "losses": tr["losses"], "seconds": secs,
        "ms_per_step": 1e3 * sum(secs[1:]) / max(1, len(secs) - 1),
        "first_step_ms": 1e3 * secs[0], "launches": tcounts,
        "launches_per_step": TRAIN_PER_STEP, "grads_vs_plain": grads,
        "grad_tol": GRAD_TOL, "loss_tol": LOSS_TOL, "b_scale": B_SCALE,
        "peak_memory_one_value_and_grad": peaks, "device": name}}))
    psecs = paper["paper"]["seconds"]
    print(json.dumps({"train_paper": {
        "arch": "qwen2.5-0.5b", "engine": "mesp_cuda", "dtype": "bfloat16",
        "batch": PAPER_BATCH, "seq": PAPER_SEQ, "steps": PAPER_STEPS,
        "losses": paper["paper"]["losses"], "seconds": psecs,
        "ms_per_step": 1e3 * sum(psecs[1:]) / max(1, len(psecs) - 1),
        "first_step_ms": 1e3 * psecs[0], "launches": pcounts["paper"],
        "launches_per_step": PAPER_PER_STEP,
        "fuse_rope": {"steps": ROPE_STEPS,
                      "losses": paper["paper_rope"]["losses"],
                      "seconds": paper["paper_rope"]["seconds"],
                      "loss_rel_err": rope_err,
                      "launches": pcounts["paper_rope"]},
        "grads_vs_plain": paper_grads, "grad_tol": GRAD_TOL,
        "loss_tol": LOSS_TOL, "b_scale": B_SCALE,
        "peak_memory_one_value_and_grad": paper_peaks, "device": name}}))
    print(json.dumps({"train_quant": {
        "arch": "qwen2.5-0.5b", "engine": "mesp_cuda", "dtype": "bfloat16",
        "batch": PAPER_BATCH, "seq": PAPER_SEQ, "steps": QUANT_STEPS,
        "runs": qruns, "nf4": {
            **quant_params_bytes, "grads_vs_plain": quant_grads,
            "grad_tol": GRAD_TOL, "loss_tol": LOSS_TOL, "b_scale": B_SCALE,
            "peak_memory_one_value_and_grad": quant_peaks},
        "device": name}}))
    print(json.dumps({"train_moe": {
        "arch": MOE_ARCH, "engine": "mesp_cuda", "dtype": "bfloat16",
        "layers": MOE_L, "experts": MOE_E, "top_k": mcfg.moe.top_k,
        "capacity": MOE_C, "batch": PAPER_BATCH, "seq": PAPER_SEQ,
        "steps": MOE_STEPS, "losses": mrun["losses"], "seconds": msecs,
        "ms_per_step": 1e3 * sum(msecs[1:]) / max(1, len(msecs) - 1),
        "first_step_ms": 1e3 * msecs[0], "launches": mcounts,
        "launches_per_step": MOE_PER_STEP, "params_bytes": moe_params_bytes,
        "grads_vs_plain": moe_grads,
        f"grads_vs_plain_{MOE_GRAD_LAYERS}_layers": moe_grads_cut,
        "grad_tol": GRAD_TOL, "loss_tol": LOSS_TOL, "b_scale": B_SCALE,
        "repeat_bitwise": True,
        "peak_memory_one_value_and_grad": moe_peaks, "device": name}}))
    print(json.dumps({"train_moe_quant": {
        "arch": MOE_ARCH, "engine": "mesp_cuda", "dtype": "bfloat16",
        "layers": MOE_L, "experts": MOE_E, "batch": PAPER_BATCH,
        "seq": PAPER_SEQ, "runs": mq_runs, "nf4": {
            "grads_vs_plain": mq_grads,
            f"grads_vs_plain_{MOE_GRAD_LAYERS}_layers": mq_grads_cut,
            "grad_tol": GRAD_TOL, "loss_tol": LOSS_TOL, "b_scale": B_SCALE,
            "repeat_bitwise": True,
            "peak_memory_one_value_and_grad": mq_peaks},
        "init_memory": moe_init, "device": name}}))
    print(json.dumps({"train_seq": {
        "arch": "qwen2.5-0.5b", "engine": "mesp_seq", "dtype": "bfloat16",
        "batch": PAPER_BATCH, "seq": PAPER_SEQ, "b_scale": B_SCALE,
        "grad_tol": GRAD_TOL, **seq_fig, "seconds": new_s[0],
        "device": name}}))
    print(json.dumps({"zo": {
        "arch": "qwen2.5-0.5b", "engine": "mezo", "batch": PAPER_BATCH,
        "seq": PAPER_SEQ, "b_scale": B_SCALE, **zo_fig,
        "seconds": new_s[1], "device": name}}))
    print(json.dumps({"train_engines": {
        "arch": "qwen2.5-0.5b", "dtype": "bfloat16", "batch": PAPER_BATCH,
        "seq": PAPER_SEQ, "lr": ENGINES_LR, "runs": engines_fig,
        "seconds": new_s[2], "new_phases_seconds": new_seconds,
        "run_seconds": time.monotonic() - t_start, "device": name}}))
    print(json.dumps({"core_flash": {**core_flash_fig, "seconds": new_s[3],
                                     "device": name}}))
    print(json.dumps({"trainer": {
        "arch": "qwen2.5-0.5b", "engine": "mesp_cuda", "dtype": "bfloat16",
        "seq": PAPER_SEQ, **trainer_fig, "mib": MIB, "device": name,
        "power": smi}}))
    print(json.dumps({"dense_catalog": {
        "arch": GEMMA_ARCH, "engine": "mesp_cuda", "dtype": "bfloat16",
        "batch": 1, "seq": GEMMA_SEQ, "grad_tol": GRAD_TOL,
        "loss_tol": LOSS_TOL, "b_scale": B_SCALE, **catalog, "device": name,
        "power": smi, "run_seconds": time.monotonic() - t_start}}))
    print(json.dumps({"recurrent": {
        "archs": list(RECURRENT_ARCHS), "engine": "mesp_cuda",
        "dtype": "bfloat16", "batch": PAPER_BATCH, "seq": PAPER_SEQ,
        "grad_tol": GRAD_TOL, "loss_tol": LOSS_TOL, **recurrent,
        "device": name, "power": smi,
        "run_seconds": time.monotonic() - t_start}}))
    print(json.dumps({"vlm_audio": {
        "archs": [VLM_ARCH, AUDIO_ARCH], "engine": "mesp_cuda",
        "dtype": "bfloat16", "batch": 1, "text": VA_TEXT,
        "grad_tol": GRAD_TOL, "loss_tol": LOSS_TOL, **vlm_audio,
        "device": name, "power": smi,
        "run_seconds": time.monotonic() - t_start}}))
    print(json.dumps({"autotune": {
        **autotune_fig, "dtype": "bfloat16", "device": name, "power": smi}}))
    print(json.dumps({"data_parallel": {
        "arch": cfg.name, "engine": "mesp_cuda", "dtype": "bfloat16",
        "batch": PAPER_BATCH, "seq": PAPER_SEQ, **dp_fig, "device": name,
        "power": smi, "run_seconds": time.monotonic() - t_start}}))
    print(json.dumps({"tensor_parallel": {
        "arch": "qwen2.5-0.5b", "engine": "mesp_cuda", "dtype": "bfloat16",
        "batch": PAPER_BATCH, "seq": PAPER_SEQ, **tp_fig, "device": name,
        "power": smi, "run_seconds": time.monotonic() - t_start}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == TP_FLAG:
        sys.exit(tensor_parallel_worker(*sys.argv[2:5]))
    sys.exit(main())
