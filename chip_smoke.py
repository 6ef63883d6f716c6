#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (wavenet_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout, on a GPU

Phases, each printing JSON lines; any failure exits non-zero:

1. Device and build: the card's name and power limit (nvidia-smi), then
   the ``sampler_decode``, ``sampler_cluster`` (float32, bf16,
   local-conditioning and bf16 local-conditioning modes, four libraries),
   ``sampler_tiles`` (float32
   and bf16 modes, two libraries), the seven bf16-ring libraries of the
   three (``*_ring16``), ``fused_stack``, ``fused_stack_mma``,
   ``fused_stack_carry``, ``dilated_layer`` and probe kernels built from
   ``wavenet_torch/csrc``, one nvcc each, in parallel, with their ptxas
   lines.
2. The three decode kernels against plain, teacher-forced, at full width
   (the paper config at b1, the gc config at b1, b4, b64, b120, b128, b256
   and b512), with
   seeded non-zero biases: prefill ~3.5k random codes, teacher-force 256
   more steps, and hold each kernel's logits, ring and causal state
   against ``decode_reference`` on the card (rtol 1e-4, atol 1e-4:
   another summation order over K <= 512), and at B <= 4 against the
   parallel ``forward_codes``. ``sampler_decode`` runs at every case,
   ``sampler_cluster`` at every case where ``cluster_plan`` routes to it,
   ``sampler_tiles`` where ``tile_plan`` does (gc b128, b256, b512), each
   pinned; their teacher-forced codes are equal. Times a decode step of
   the kernels and of the plain version in the same run (paper b1, gc b1,
   gc b64, gc b120: cluster and decode; gc b128, b256, b512: tiles and
   decode), and checks that the kernel the route takes is the fastest at
   each.
3. Sampling exactness on the route as it stands (``kernel="auto"``): a
   512-step free run, replayed by ``decode_reference`` teacher-forced on
   its codes with the same Philox noise (>= 99.9% equal, every mismatch a
   near-tie), same-seed runs bitwise equal, rows independent of the batch
   size; prints which kernel served.
4. Serving (the main path of generation): ``GenerationService`` behind
   a localhost HTTP server answers /healthz, /generate at b1 (paper and
   gc config) and /generate_batch at b64 and b512; the launch counts show
   which kernel served every request (the cluster kernel at b1 and b64,
   the tiles kernel at b512), and CUDA events around each launch give the
   seconds of a request spent in the kernel (``decode_s``).
5. Training (the main path of training), through the fused stack's two
   kernel pairs (``fused_stack_mma``: 3xTF32 on the tensor cores, routed
   at the paper/gc width R = D = 32 and the wide width 64; ``fused_stack``:
   FP32 cores, the narrower widths): each forward and backward against
   the plain versions at the paper and gc configs, b8 x (receptive field
   + 16,000) audio, ``fused_stack_mma`` alone at the wide config (b8, the
   causal layer of uniform amplitudes), and
   ``fused_stack`` also at the tiny config (R = D = 16), b2 x (receptive
   field + 4,000), the shape of its train CLI run below (forward
   within 1e-4 * max|ref| + 1e-5, gradients within 2e-3 * max|ref| +
   2e-4: another summation order, and the backward rebuilds each layer's
   input by subtraction), bitwise-equal repeated calls, timed in
   turns beside their bounds under the FP32 and the 3xTF32 peak with the
   device ms of a call by kernel (the route must take the faster in each
   direction); one gc and one wide train step
   fused against plain (loss within 1e-5, gradients within the
   tolerances above; the device time by kernel family), then
   ``python -m wavenet_torch.cli.train --use_pallas_stack`` on a
   synthesised 109-speaker corpus, decoded by the native C++ library
   (``wavenet_torch.data.native``): 8 steps with finite, falling loss and
   the routed kernels launched every step (the ``kernels`` line's
   launches are this run's), checkpoints 4 and 8, a resume to 10 (its 2
   launches of each counted apart), a ``GenerationService`` that serves
   from the last checkpoint, and 2 steps of the tiny config on
   ``fused_stack``. bf16 (``compute_dtype="bfloat16"``): the bf16 mode of
   ``fused_stack_mma`` at gc and wide b8 and of ``fused_stack`` at tiny b8
   (the route's kernel at each width), each forward layer from the kernel's own
   input to it against the plain bf16 layer (worst point within 2**-5,
   mean within 1e-4 of max |ref|), and the whole forward and backward
   against the plain bf16 versions on the scale of their distance from
   the plain float32 versions (mean error within the mean gap, the worst
   within 1.5x the worst gap), bitwise
   repeatable, timed in turns with the float32 mode beside its bound at
   the bf16 peak; a paper b8 train step at bf16, plain and fused, against
   the float32 step (loss within 1e-3 relative, gradients within 0.25 of
   max |ref|) with its device breakdown; and the gc train CLI at
   ``--compute_dtype bfloat16 --use_pallas_stack``, 8 steps, the bf16
   mode launched every step (its ``kernels`` rows' launches), and the
   tiny config's at b8 x 16,000, 4 steps on ``fused_stack``'s bf16 mode,
   losses falling. Last, the
   wide config's train CLI (scalar input, R = D = 64), 4 steps each at
   float32 and bfloat16, with ``--use_pallas_stack`` (``fused_stack_mma``
   at width 64 every step, launches counted from 0; the f32 run resumed
   for a fifth step) and without it, finite and falling losses, the
   rates (``train_cli_wide`` rows). Then LC training: ``python -m
   wavenet_torch.cli.train --lc_channels 80 --lc_hop 200`` at the paper
   config, b8 x 16,000, on a synthesised corpus with log-mel sidecars
   (``wavenet_torch.features``), 4 steps each with the frame windows
   upsampled on the card (the default), with ``--lc_host_upsample`` and
   with ``--use_pallas_stack``: finite, falling losses, the first step's
   equal across the three within 1e-5, and no stack kernel launched (LC
   takes the plain route, as in JAX). The wide config at R = D = 128,
   at R = 128, D = 64 and at R = 48, D = 128 (ragged tiles) trains one
   step each on ``fused_stack_tiled``.
5t. The sharded config's stack (80 layers, R = D = 256:
   ``fused_stack_tiled``, tiled products whose weights stream through
   shared memory): forward and backward in both modes at the train shape
   b1 x (receptive field + 16,000 - 1) against the plain versions (f32
   within the tolerances of phase 5 and per slice, bf16 each forward
   layer on its own input and the whole on the bf16 gap's scale),
   bitwise-equal repeats, timed in turns (f32, bf16, bf16, f32) beside
   their bounds at the 3xTF32 and the bf16 peak with the plain versions'
   times; then the train CLI on a written ``sharded_params.json`` with
   ``--use_pallas_stack --batch_size 1 --sample_size 16000``, 4 steps at
   float32 and 4 at bfloat16, finite losses, every stack call on the
   tiled kernel's mode (its ``kernels`` rows' launches, counted from 0).
5r. Kernel 5 at R != D on ``fused_stack_tiled``: the wide config's depth
   and length (30 layers, S = 1024, scalar input) at (R, D) = (128, 64)
   and (64, 128) (whole tiles) and (6, 16) (ragged tiles, every edge
   checked), b8 x (receptive field + 16,000 - 1),
   checked and timed as phase 5t (both modes against the plain versions,
   bitwise repeats, turns f32, bf16, bf16, f32); the train CLI at
   (128, 64), b8 x 16,000, 4 steps each dtype, finite losses, every stack
   call on the tiled mode (the ``fused_stack_tiled_r_ne_d*`` rows'
   launches, counted from 0). Then the sharded config's generation, where
   the JAX ladder's TPU VMEM budget offers no Pallas rung and the port's
   route (``decode_route``) runs ``sampler_decode``: the generate CLI at
   b1 x 64 on it (one launch, counted from 0; the server's route is
   ``tests/test_torch_gpu.py``'s
   ``test_sharded_generation_runs_sampler_decode``), the kernel at full
   depth against ``decode_reference`` at b1 and b4 in both weight modes,
   and each route's step (``sampler_decode``, the scan sampler) at b1 and
   b64 over 200 steps behind a spin.
6. Generation, at full width: kernel 4's route (``decode_sequential``:
   a receptive field of random codes, or amplitudes for the scalar-input
   wide config, stepped from a zero ring, then 256 sampled steps) at the
   paper and wide configs, b1 and b64 on ``sampler_decode`` and b1 and
   the largest routed batch of b64, b32 and b16 on ``sampler_cluster``,
   each pinned,
   against ``decode_reference`` replaying the kernel's inputs
   (logits of every step and a window, rtol 1e-4 and atol 1e-4; sampled
   codes as in phase 3; same-seed runs and b1 against row 0 of b64
   bitwise); the wide config through the prefill route the same way and
   timed (both kernels at b1 and at the largest batch the route sends
   to the cluster kernel, the routed one the faster), with a probe of the kernel's own next amplitude (``next_amp``)
   against ``decode_amp`` on the card; then ``python -m wavenet_torch.cli.generate`` from phase 5's gc
   checkpoint (b1 and b64 x 16,000 samples, b128 x 4,000 on the tiles
   kernel, ``--save_every`` equal to the single run, ``--wav_seed``,
   ``--fast_generation false``) and from
   seeded paper and wide checkpoints (the scalar-input wide one in
   ``--save_every`` segments too, equal to its single run); last, the
   main path of kernel 4: ``generate_cuda(prefill=False)`` three times
   per case, its launches counted from 0 (its ``kernels`` rows). Every
   CLI run and main-path case prints the kernel that served it, and the
   phase checks that the native decoder was loaded.
6b. bf16-weight generation (TPU kernels 1-4 at ``weight_dtype=bfloat16``):
   the bf16 modes of ``sampler_cluster`` (paper b1, gc b64),
   ``sampler_tiles`` (gc b128, b512, paper b525: the route's bf16 range
   b121-b525) and ``sampler_decode`` (gc b1, b128, b512), pinned,
   teacher-forced over 32 steps from a prefilled state, in one launch
   (counted under ``cluster_bf16`` / ``tiles_bf16`` / ``decode_bf16``;
   same-seed repeats bitwise) and one step a launch from the kernel's own
   state (bitwise the one launch),
   each step held against bf16 ``decode_reference`` from that state on the
   scale of bf16's own gap from float32 (``kernels.bf16_hold``: each row's
   median error within 0.05 of its median gap, the mean within 0.2 of the
   mean gap, the worst within 4x the worst gap: another float32 sum order
   flips a few bf16 roundings); step times of each bf16 kernel and of the
   float32 route's kernel at the shape in turns, with the plain version's
   and the bound at 2-byte weights (bf16-operand products at the bf16
   peak); kernel 4's route at paper b1 the same way; then the main path,
   ``python -m wavenet_torch.cli.generate --sampler_precision bfloat16``
   from phase 5's gc checkpoint at b1 and b64 x 16,000 (the cluster
   kernel's bf16 mode), b128 x 4,000 (the tiles kernel's) and b600 x 1,000
   (``sampler_decode``'s, above the tiles range), its launches counted from
   0; last, ``generate_with_fallback`` (the CLI's fast path) on a bf16
   config object, bitwise the float32 config's.
6c. Local conditioning (the LC row of TPU kernels 1 and 2) at the JAX
   bench's ``lc`` config, ``paper_config(lc_channels=80)``, seeded LC
   weights and biases: the LC modes of ``sampler_cluster`` (paper-LC b1
   and the top of the cluster plan's range) and ``sampler_decode`` (b64,
   b512), pinned, from an LC prefill, teacher-forced over 32 steps on a
   uniform(-1, 1) stream against ``decode_reference(lc=)`` (phase 2's
   tolerance; b1 also against ``forward_codes``), same-seed repeats
   bitwise, counted under ``cluster_lc`` / ``decode_lc``, and timed in
   turns with the same kernel without LC; the bench's ``lc`` row,
   ``generate_cuda`` at b1 x 16,000 (samples/s); then the main path, its
   launches counted from 0: a ``GenerationService`` from a params file
   with ``lc_channels: 80`` answers /generate with 80 log-mel frames of a
   synthesized sound (``wavenet_torch.features``) at ``lc_hop`` 200 (other
   frames give another waveform; seconds and ``decode_s``), and ``python
   -m wavenet_torch.cli.generate --lc_channels 80 --lc_file ... --lc_hop
   200`` at b1 x 16,000, b64 x 4,000 (``--save_every`` equal to the single
   run) and b256 x 2,000 (``sampler_decode``'s LC mode).
6d. Local conditioning at bf16 weights (the LC row of TPU kernels 1 and 2
   at ``weight_dtype=bfloat16``), at 6c's config and weights: the bf16 LC
   modes of ``sampler_cluster`` (paper-LC b1, b64 and the top of the
   cluster plan's range) and ``sampler_decode`` (b256, b512), pinned, from
   an LC prefill, teacher-forced over 32 steps on a uniform(-1, 1) stream
   in one launch (same-seed repeats bitwise, counted under
   ``cluster_bf16_lc`` / ``decode_bf16_lc``) and one step a launch from the
   kernel's own state (bitwise the one launch), each step held against
   bf16 ``decode_reference(lc=)`` with 6b's limits (``kernels.bf16_hold``);
   step times in turns with the float32 LC mode and the bf16 mode without
   LC of the same kernel, the plain version's and the bound at 2-byte
   weights; then the main path, its launches counted from 0: ``python -m
   wavenet_torch.cli.generate --lc_channels 80 --lc_file ... --lc_hop 200
   --sampler_precision bfloat16`` at b1 x 16,000, b64 x 4,000
   (``--save_every`` equal to the single run) and b256 x 2,000.
6e. The bf16 ring (TPU kernels 1-3 at ``state_dtype=bfloat16``): the
   bf16-ring mode of each kernel at each weight type, pinned at the main
   path's shapes (``sampler_cluster`` at paper b1 and paper-LC b1,
   ``sampler_tiles`` at gc b128 and b512, ``sampler_decode`` at gc b600
   and paper-LC b256), from a prefill whose ring is rounded to bf16,
   teacher-forced over 16 steps in one launch (same-seed repeats bitwise,
   counted under the ``_ring16`` names) and one step a launch from the
   kernel's own state (bitwise the one launch), each step held against
   ``decode_reference`` from that state: at float32 weights the logits
   within rtol 1e-4, atol 1e-5 and the written rows bitwise but for
   ``bf16_hold.hold_ring16``'s flips, at bf16 weights both on
   ``bf16_hold``'s gap rule; one step of each timed in turns with the same
   mode at a float32 ring (float32, bf16, bf16, float32 ring), each
   launch queued behind a ``torch.cuda._sleep`` spin, beside the plain
   version's step and the bound at 2-byte ring rows; then the main path,
   its launches counted from 0: ``generate_cuda(state_dtype=bfloat16)``
   at each weight type at paper b1 x 16,000, gc b512 x 4,000, gc b600 x
   1,000, paper-LC b1 x 4,000 and b256 x 1,000, and ``prefill=False`` at
   paper b1 x 4,000, each repeated bitwise with the same seed.
7. The retired training stacks (TPU kernels 6-8; 6-7 also at bf16), at
   the paper and gc configs' full width, b8 x (receptive field + 16,000):
   the ``fused_stack_carry`` kernel behind generations v1 and v2 (a wavefront
   across time tiles on the grid ``carry_plan`` sizes, printed with the
   card's resident blocks; 3xTF32 on the tensor cores) against the
   plain versions (phase 5's tolerances and per-slice check), bitwise
   repeatable in both directions, and against kernel 5, each call timed
   beside its bound under the 3xTF32 peak and kernel 5's two kernels'
   times; (d) the carry kernel's bf16 mode (TPU kernels 6-7 at
   kernel_dtype bf16: one bf16 ``mma.sync`` pass a product, bf16 fg and z
   records) at the same shapes: each forward layer on its own input, the
   forward without z (v1) and with it (v2) and the backward against the
   plain bf16 versions on the scale of bf16's distance from float32 (5's
   rule), bitwise repeatable, timed in turns with the float32 mode beside
   its bound at the bf16 peak and kernel 5's bf16 times; then the main path
   of this slice: 4 Adam steps of the gc config through
   ``train_lib.make_train_step`` at ``pallas_stack_version`` 1 and 2, from
   the same params and batches as 4 version-3 steps, at float32 (first
   loss within 1e-5, later within 1e-4 relative) and at bf16 (every loss
   within bf16's own gap, version 3's largest bf16-to-float32 distance;
   the bf16 mode launched every step), finite and falling, the carry
   kernel's launches counted from 0 by mode; last, (c) the
   ``dilated_layer`` kernel in both modes (3xTF32, or one bf16 pass a
   product; its grid printed beside the library's resident blocks) at
   each distinct dilation against its plain versions (bf16 on bf16's gap),
   its backward bitwise repeatable, timed in turns (f32, bf16, bf16, f32)
   beside its bounds under the 3xTF32 and the bf16 peak, and a 30-call
   ``fused_dilated_layer`` stack under autograd in each mode, its
   launches counted from 0 by mode: at float32 against kernel 5, at bf16
   each call on its own input and the whole against the plain bf16 layer
   stack, its distance from kernel 5's bf16 mode recorded; then kernel 8
   at (64, 64), (48, 128) and (256, 256) on ``fused_stack_tiled``'s layer
   entries (gc b8 length, dilation 4) in both modes against its plain
   versions, bitwise repeatable, timed, the op's launches counted from 0.
   (e) The v1 stack where the carry kernel is not built, on kernel 5's
   kernels (the wide config b8 on ``mma``, the sharded config b1 on the
   tiled kernel's v1 entries): forward and backward against v1's plain
   versions in each mode (f32 at phase 5's tolerances, bf16 on bf16's
   gap), bitwise kernel 5's own launches on the same inputs, repeats
   bitwise, timed beside the plain versions; then 3 Adam steps at
   versions 3 and 1 in each dtype, v1's losses against v3's by the rules
   above, launches ``v1_mma`` / ``v1_tiled`` counted from 0.

8. The probes (TPU kernels 9-10): the r2 and r2b tools' kernels on the
   FP32 cores (``fwd_bisect``) and on the tensor cores
   (``fwd_bisect_mma``: ``fused_stack_mma``'s forward with parts masked,
   at the paper and wide configs; r2b's core math in one launch), every
   variant at float32 and bf16 against its plain version, timed beside
   its bound (FP32 / bf16 peak on the FP32 cores, 3xTF32 / bf16 on the
   tensor cores), the tensor-core ones repeated bitwise and their
   ``full`` and ``rolled`` bitwise ``fused_stack.forward(kernel="mma")``;
   the r3 decode-step bisect on the cluster kernel (``b1_bisect_cluster``,
   the kernel b1 generation runs, its ``full`` bitwise
   ``decode_sequential(kernel="cluster")`` and timed in turns with it, its
   phase clock by CTA) and on ``sampler_decode``'s step, each mode replayed
   by its kernel's plain version; the r4 matvec forms on the cluster
   kernel (``matvec_probe_cluster``: ns a product from one CTA, ns a
   hand-off) and with weights in L2; then the main path, each tool's own
   ``main`` (r2 at both configs), launches counted from 0, every variant
   of each kernel launched.
9. The bench (``python -m wavenet_torch.bench``'s rows, ``bench.run`` at
   ``bench.SHORT``: generation at 2,000 samples and one rep, the scan
   rows at 200, two train steps, the train CLI's ten), its decode
   launches counted from 0: every
   number of the payload finite and positive, each generation row served
   by the kernel that the route takes on this card (the cluster kernel,
   its bf16 and LC modes, the tiles kernel's bf16 mode at b128-b512),
   and the compact line with every key of the JAX bench's non-null in at
   most 1,900 characters. The ``kernels`` rows of those kernels carry the
   run's launches (``launches_bench``).
10. Scoring and speculative decoding (plain PyTorch, as the JAX package
   runs them in XLA, but for the scored forward at ``use_pallas_stack``):
   ``sample.extend_state`` at the paper config from a prefill of 3,500
   codes, one 64-code window against 64 ``sampler_step`` calls on the card
   (logits, ring and causal register within rtol 1e-4, atol 1e-4 at v = 64
   and a partial v; the state given is not written); ``score.log_likelihood``
   at the paper and gc configs, b1 x 16,000 uniform(-1, 1) samples,
   one-shot, streaming in 4,096-code windows and one-shot at
   ``use_pallas_stack`` (``fused_stack_mma``'s forward, its launches counted
   from 0), held against each other within the CPU tests' tolerances
   (per sample atol 1e-4; totals rtol 1e-5 and atol 1e-3, streaming atol
   1e-4); ``python -m wavenet_torch.score`` from phase 5's gc checkpoint on
   two synthesised wavs (one past ``--streaming_chunk 8192``) with
   ``--gc_from_filename``, its totals against the library's one-shot
   scorer; a ``GenerationService`` with a draft at the paper config (the
   target's npz, then a lightly perturbed copy) answering /generate at b1
   x 1,024 with k = 8 (well-formed codes, every proposal accepted from the
   identical draft, no decode kernel launched, /generate_batch refused);
   ``python -m wavenet_torch.cli.generate --draft_checkpoint`` from the gc
   checkpoint at b1 x 400 and in ``--save_every 100`` segments (equal to
   the single run); ``distill.distill_draft`` at the tiny config for 4
   steps (finite loss, the draft on the card). Prints the scored audio s
   per wall s, the speculative samples/s and the mean accepted length.
11. Parallelism on ``torch.distributed`` at a world size of 1 over NCCL
   (one card; collectives over several devices are held on the CPU over
   gloo, tests/test_torch_sharding.py) and the server's flags: (a) the
   train CLI at the gc config on phase 5's corpus, b8 x 16,000, with
   ``--coordinator_address 127.0.0.1:<free port> --num_processes 1
   --process_id 0``, plain and with ``--use_pallas_stack``
   (``fused_stack_mma``, its launches counted from 0): its losses bitwise
   the one-process CLI's from the same seed (a plain run here, phase 5's
   first steps for the fused one; the mean of one rank is exact); (b)
   ``make_time_sharded_grad_fn`` with one time rank against ``loss_fn``'s
   loss and gradients at the gc config, b2 x (receptive field + 4,000)
   (loss within rtol 1e-5, each gradient within 1e-4 of its max |ref|:
   another summation order); (c) ``sample.generate_sharded`` against
   ``sample.generate`` at the gc config, b4 x 32: equal codes; (d) a
   ``GenerationService`` from ``--checkpoint`` (phase 5's gc logdir)
   under ``--sampler auto`` (the reply names the CUDA route, one decode
   launch) and ``--sampler scan`` (the reply names ``scan``, no launch).

The line before the last holds the kernels' numbers; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a GPU or
outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth,
# non-tensor-core FP32 and dense bf16 tensor-core. The bf16 peak is the
# least time of a product whose two operands are bf16, though the decode
# kernels and the probes multiply them on the FP32 cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

PREFILL = 3500
TEACHER_STEPS = 256
FREE_STEPS = 512
SERVE_BATCH_SIZES = (1, 64, 512)
# Phase 2's (config, batch) cases; those the server's batch sizes are
# timed on, with the decode steps of one timed launch.
# gc b120 is the top of the cluster kernel's range on an H100 (15 clusters
# of 8 rows).
# gc b128, b256 and b512 run the tiles kernel (the server's
# /generate_batch shapes).
TEACHER_CASES = (("paper", 1), ("gc", 1), ("gc", 4), ("gc", 64), ("gc", 120),
                 ("gc", 128), ("gc", 256), ("gc", 512))
TIMED_STEPS = {("paper", 1): 2048, ("gc", 1): 2048, ("gc", 64): 1024,
               ("gc", 120): 1024, ("gc", 128): 1024, ("gc", 256): 512,
               ("gc", 512): 512}
KERNELS = ("sampler_decode", "sampler_cluster", "sampler_cluster_bf16",
           "sampler_cluster_lc", "sampler_cluster_lc_bf16", "sampler_tiles",
           "sampler_tiles_bf16", "sampler_decode_ring16",
           "sampler_cluster_ring16", "sampler_cluster_bf16_ring16",
           "sampler_cluster_lc_ring16", "sampler_cluster_lc_bf16_ring16",
           "sampler_tiles_ring16", "sampler_tiles_bf16_ring16",
           "fused_stack", "fused_stack_mma", "fused_stack_tiled",
           "fused_stack_carry", "dilated_layer")
# The decode kernels by the name their wrappers count them under.
DECODE_SOURCES = {"decode": "sampler_decode", "cluster": "sampler_cluster",
                  "tiles": "sampler_tiles"}
# Phase 6: kernel 4's route (sequential, from a zero ring).
SEQ_CASES = (("paper", 1), ("paper", 64), ("wide", 1), ("wide", 64))
SEQ_SAMPLES, SEQ_WINDOW, SEQ_TIMED_SAMPLES = 256, 300, 1024
GEN_SAMPLES = 16000
# Phase 5: the JAX package's train_b8 shape (bench.py).
TRAIN_BATCH, TRAIN_SAMPLES = 8, 16000
TRAIN_STEPS, RESUME_STEPS = 8, 10
# Phase 11: the steps of each multi-process train CLI run (one dispatch of
# phase 5's run), and the shapes of its time-sharded and sharded sampling
# checks.
PARALLEL_STEPS = 4
TIMESHARD_BATCH, TIMESHARD_SAMPLES = 2, 4000
SHARDED_GEN_BATCH, SHARDED_GEN_STEPS = 4, 32
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
# The two stack kernels ("mma": csrc/fused_stack_mma.cu, 3xTF32 on the
# tensor cores; "simt": csrc/fused_stack.cu, FP32 cores), the peak each
# one's bound is taken at, and the rounds of (simt, mma, mma, simt).
STACK_ROUTES = ("simt", "mma")
STACK_PEAK = {"simt": "fp32", "mma": "tf32x3"}
STACK_TIMED_ROUNDS = 3
# Phase 5's run of the train CLI on fused_stack.cu, which keeps the widths
# below 32: the repo's tiny config (10 layers, R = D = 16), its steps,
# batch and sample size; phase 5 checks and times the kernel at that shape.
NARROW_STEPS, NARROW_BATCH, NARROW_SAMPLES = 2, 2, 4000
# Its run at --compute_dtype bfloat16 (fused_stack.cu's bf16 mode), at the
# train shape b8 x 16,000, long enough for the loss to fall.
NARROW_BF16_STEPS = 4
# Phase 5's stack shapes: config, batch, samples and the kernels timed.
STACK_CASES = (("paper", TRAIN_BATCH, TRAIN_SAMPLES, STACK_ROUTES),
               ("gc", TRAIN_BATCH, TRAIN_SAMPLES, STACK_ROUTES),
               ("tiny", NARROW_BATCH, NARROW_SAMPLES, ("simt",)),
               ("wide", TRAIN_BATCH, TRAIN_SAMPLES, ("mma",)))
# Phase 5's wide train CLI runs (R = D = 64, scalar input: fused_stack_mma
# at width 64): steps and steps a dispatch of each, fused and plain, f32
# and bf16.
WIDE_STEPS, WIDE_STEPS_PER_DISPATCH = 4, 2
# Each layer's (or batch row's) slice of a gradient, against its own
# max |ref|; the measured worst over whole tensors is ~1e-6.
SLICE_RTOL = 1e-4
# fused_stack_mma's bf16 mode against its plain bf16 version, in the working
# type. Another float32 summation order flips a few bf16 roundings, and
# every later layer carries a flip on, so over the 30 layers the two bf16
# results drift apart by as much as bf16 lies from float32: at gc b8 y lay
# 0.69 of the plain bf16 version's mean distance from float32 (chip call
# 2, PR 11). So (1) each layer is held apart, from the kernel's own input
# to that layer (rebuilt from its bf16 z records, no flip carried): the
# layer's fg and z records within BF16_LAYER_MAX_RTOL of its max |ref| at
# the worst point and BF16_LAYER_MEAN_RTOL on average, y within the
# float32 forward tolerance of the rebuilt output; and (2) the whole
# outputs and gradients against the plain bf16 versions on the scale of
# their distance from the plain float32 versions: the mean error within
# BF16_MEAN_RATIO of the mean gap, the worst within BF16_MAX_RATIO of the
# worst gap. An indexing or rounding fault lies O(1) of the values away.
BF16_LAYER_MAX_RTOL, BF16_LAYER_MEAN_RTOL = 2.0 ** -5, 1e-4
BF16_MEAN_RATIO, BF16_MAX_RATIO = 1.0, 1.5
# Phase 7 (c)'s bf16 layer stack (kernel 8 rounds the residual, and its
# VJP the residual's gradient, to bf16 at each of the 30 calls) drifts
# from the plain bf16 layer stack further than kernel 5's does: on an H100
# its dbd (30 x 32 sums) lay 0.72 / 0.76 of the gap (mean, worst) in one
# draw of the inputs and 1.06 / 1.96 in another. Each call is held by
# BF16_MEAN_RATIO and BF16_MAX_RATIO on its own input and cotangents; the
# whole stack only within these multiples of the gap (mean, worst).
LAYER_STACK_SANITY = (3.0, 5.0)
# A bf16 train step's loss against the float32 one on the same batch, and
# each gradient within this share of its float32 max |ref|: bf16 rounds
# every product's operands (2**-8 relative). At the paper config, b2 x
# (rf + 2,000), on the CPU the bf16 loss lay 3.0e-5 (plain) / 3.2e-5
# (fused) of itself from float32 and the gradients at most 0.068 / 0.042
# of their max (causal_filter); a fault moves them by O(1).
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-3, 0.25
# Phase 6b: the decode kernels' bf16 modes (config, batch, kernel pinned),
# teacher-forced over a short window and held step by step on the scale of
# bf16's own distance from float32 (``kernels.bf16_hold`` states the
# limits and why). Each case's steps of one timed launch. The tiles cases
# are the route's at bf16 (b121-b525); sampler_decode is pinned at the same
# shapes, since it still serves b526+.
BF16_TEACHER_CASES = (("paper", 1, "cluster"), ("gc", 64, "cluster"),
                      ("gc", 128, "tiles"), ("gc", 512, "tiles"),
                      ("paper", 525, "tiles"),
                      ("gc", 1, "decode"), ("gc", 128, "decode"),
                      ("gc", 512, "decode"))
BF16_TEACHER_STEPS = 32
BF16_TIMED_STEPS = {("paper", 1): 2048, ("gc", 64): 1024, ("gc", 1): 1024,
                    ("gc", 128): 1024, ("gc", 512): 512, ("paper", 525): 512}
# Kernel 4's route at bf16: a short forced prefix, then sampled steps.
BF16_SEQ_PREFIX, BF16_SEQ_SAMPLES = 16, 16
# The bf16 generate CLI's runs (label, batch, samples, the kernel that the
# route takes, as launches_by counts it), and the samples of the runs from
# a bf16 config.
BF16_CLI_RUNS = (("b1", 1, GEN_SAMPLES, "cluster_bf16"),
                 ("b64", 64, GEN_SAMPLES, "cluster_bf16"),
                 ("b128", 128, 4000, "tiles_bf16"),
                 ("b600", 600, 1000, "decode_bf16"))
BF16_CONFIG_SAMPLES = 4000
# Phase 6c: local conditioning at the JAX bench's ``lc`` config
# (paper_config(lc_channels=80), bench.py:114-117), 80 log-mels at a
# 200-sample hop. The pinned cases (kernel, batch; "top" is the largest
# batch the cluster plan takes): the main path's shapes (the cluster
# kernel at b1 and b64, sampler_decode at b256) and the ends of each
# kernel's range; their teacher-forced steps and the steps of one timed
# launch; the CLI's runs (label, batch, samples, extra flags, the LC
# kernel the route takes and its launches).
LC_CHANNELS, LC_HOP = 80, 200
LC_CASES = (("cluster", 1), ("cluster", 64), ("cluster", "top"),
            ("decode", 64), ("decode", 256), ("decode", 512))
LC_TEACHER_STEPS = 32
LC_TIMED_STEPS = {1: 2048, 64: 1024, 256: 512, 512: 512}
LC_CLI_RUNS = (("b1", 1, GEN_SAMPLES, [], "cluster_lc", 1),
               ("b64", 64, 4000, [], "cluster_lc", 1),
               ("b64_save_every", 64, 4000, ["--save_every", "1000"],
                "cluster_lc", 4),
               ("b256", 256, 2000, [], "decode_lc", 1))
LC_SOURCES = {"cluster": "sampler_cluster_lc", "decode": "sampler_decode_lc"}
# Phase 6d: local conditioning at bf16 weights, at phase 6c's config. The
# pinned cases (kernel, batch; "top" as in LC_CASES), teacher-forced over
# LC_TEACHER_STEPS and timed at LC_TIMED_STEPS; the bf16 CLI's runs (as
# LC_CLI_RUNS).
LC_BF16_CASES = (("cluster", 1), ("cluster", 64), ("cluster", "top"),
                 ("decode", 256), ("decode", 512))
LC_BF16_CLI_RUNS = (("b1", 1, GEN_SAMPLES, [], "cluster_bf16_lc", 1),
                    ("b64", 64, 4000, [], "cluster_bf16_lc", 1),
                    ("b64_save_every", 64, 4000, ["--save_every", "1000"],
                     "cluster_bf16_lc", 4),
                    ("b256", 256, 2000, [], "decode_bf16_lc", 1))
LC_BF16_SOURCES = {"cluster": "sampler_cluster_lc_bf16",
                   "decode": "sampler_decode_lc_bf16"}
# Phase 6e: the bf16 ring. The pinned cases (kernel, config, batch; "lc"
# is phase 6c's paper-LC config), each at both weight types, held one step
# a launch over RING16_STEPS steps (float32 weights: logits within
# RING16_TOL, a float32 step's tolerance, since a ring row is stored after
# it is read); their timed steps a launch, each launch behind a spin of
# RING16_SPIN cycles (~25 ms on an H100, time for the host to queue it);
# the main path's generate_cuda runs (config, batch, samples, prefill).
RING16_CASES = (("cluster", "paper", 1), ("tiles", "gc", 128),
                ("tiles", "gc", 512), ("decode", "gc", 600),
                ("cluster", "lc", 1), ("decode", "lc", 256))
RING16_STEPS = 16
RING16_TOL = dict(rtol=1e-4, atol=1e-5)
RING16_TIMED_STEPS = {1: 2048, 128: 1024, 256: 512, 512: 512, 600: 512}
RING16_SPIN = 50_000_000
RING16_GEN = (("paper", 1, GEN_SAMPLES, True), ("gc", 512, 4000, True),
              ("gc", 600, 1000, True), ("lc", 1, 4000, True),
              ("lc", 256, 1000, True), ("paper", 1, 4000, False))
# The TPU kernel each bf16-ring mode's row stands for, by its case.
RING16_REPLACES = {
    ("cluster", 1): "wavenet_tpu/kernels/sampler.py:234",
    ("tiles", 128): "wavenet_tpu/kernels/sampler.py:1308",
    ("tiles", 512): "wavenet_tpu/kernels/sampler_packed.py:142",
    ("decode", 600): "wavenet_tpu/kernels/sampler.py:1308",
    ("decode", 256): "wavenet_tpu/kernels/sampler.py:1308"}
# Phase 5's LC training check: the train CLI's steps a run, and the
# speakers of its corpus (two 2-second utterances each, log-mel sidecars).
LC_TRAIN_STEPS, LC_TRAIN_SPEAKERS = 4, 4
# Phase 5t: the sharded config's train CLI runs on fused_stack_tiled (batch,
# samples, steps of each dtype) and the speakers of their corpus (two
# 2-second utterances each).
TILED_BATCH, TILED_SAMPLES, TILED_STEPS, TILED_SPEAKERS = 1, 16000, 4, 4
# Phase 5r: the widths (R, D) at the wide config's depth and length that
# kernel 5 takes on fused_stack_tiled at R != D: two multiples of 64 (the
# kernel's whole-tile mode) and one that is not (every edge checked, 4
# bytes a copy; R = 6 puts the rows off 16 bytes and D = 16 makes a block
# mask half of its filter and gate pairs; (48, 128) cost 25 s more on an
# H100 and runs in phase 5's one-step CLI instead); and its train CLI runs
# at the first (steps of each dtype, at the train shape, on a corpus of
# two 2-second utterances a speaker).
RAGGED_WIDTHS = ((128, 64), (64, 128), (6, 16))
RAGGED_STEPS, RAGGED_SPEAKERS = 4, 8
# Phase 5r: the samples of the sharded config's generate CLI run, on the
# scan sampler.
SHARDED_GEN_SAMPLES = 64
# Phase 5r's decode at the sharded config, at full depth: sampler_decode
# held teacher-forced at these batches and steps, then each route's step
# (sampler_decode, the scan sampler) timed at SHARDED_TIMED_BATCHES over
# SHARDED_TIMED_STEPS steps (decode, scan, decode), queued behind a spin
# of SPIN_CYCLES (~0.25 s at an H100's ~1.98 GHz) so that the host's
# launches run ahead of the card.
SHARDED_HOLD_BATCHES, SHARDED_HOLD_STEPS = (1, 4), 32
SHARDED_TIMED_BATCHES, SHARDED_TIMED_STEPS = (1, 64), 200
SPIN_CYCLES = 500_000_000
# Phase 7: Adam steps per pallas_stack_version on the retired stacks.
CARRY_TRAIN_STEPS = 4
# Phase 7 (e): the retired v1 stack where the carry kernel is not built,
# on kernel 5's kernels: (config, batch, samples, the kernel v1's route
# takes), V1_STEPS Adam steps a version and dtype.
V1_CASES = (("wide", TRAIN_BATCH, TRAIN_SAMPLES, "mma"),
            ("sharded", TILED_BATCH, TILED_SAMPLES, "tiled"))
V1_STEPS = 3
# Phase 7 (c): kernel 8 at widths the layer kernel is not built for, on
# fused_stack_tiled's layer entries, at the gc config's train shape.
LAYER_WIDE = ((64, 64), (48, 128), (256, 256))
LAYER_WIDE_DILATION = 4
# Phase 9: the bench's generation rows by payload key (config, batch, bf16
# weights, LC, the wrapper that the row's route launches), the main
# payload's and each config row's.
BENCH_GEN_ROWS = {
    "gen_samples_per_s_b1_paper": ("paper", 1, False, False, "decode"),
    "gen_samples_per_s_b1_sequential_vmem":
        ("paper", 1, False, False, "decode_sequential"),
    "gen_samples_per_s_b8_prefill_f32": ("paper", 8, False, False, "decode"),
    "gen_samples_per_s_b64_prefill_f32":
        ("paper", 64, False, False, "decode"),
    **{f"gen_samples_per_s_b{B}_{rate}_bf16w":
       ("paper", B, True, False, "decode")
       for B in (64, 128, 256, 512) for rate in ("device", "prefill")},
}
BENCH_CONFIG_GEN_ROWS = {"gc": ("gc", 1, False, False, "decode"),
                         "wide": ("wide", 1, False, False, "decode"),
                         "lc": ("lc", 1, False, True, "decode")}
KERNELS = KERNELS + ("fwd_bisect", "fwd_bisect_mma", "b1_bisect",
                     "matvec_probe", "b1_bisect_cluster",
                     "b1_bisect_cluster_bf16", "matvec_probe_cluster")
# Phase 8: the probes. Steps of one b1_bisect launch (checked and timed)
# and of the tool's own run; steps of one matvec_probe launch (timed) and
# of the one held against its plain version.
R3_STEPS, R3_MAIN_STEPS, R3_SEED = 2048, 1024, 7
R4_STEPS, R4_CHECK_STEPS = 4000, 256
# Phase 10: scoring and speculative decoding (see the docstring). The
# draft of the perturbed service is the target plus SPEC_PERTURB x each
# tensor's std of Gaussian noise, the JAX end-to-end test's aligned draft.
# Its runs are host-bound (~55-80 samples/s on an H100): at 2,048 server
# and 2,000 CLI samples phase 10 took 172 s and the script 1,061 s of its
# 1,200 s limit, at 1,024 (one server bucket) and 800 in four segments
# 82 s and 868 s (chip runs of the tree that cut them).
EXTEND_K, EXTEND_PARTIAL_V = 64, 23
EXTEND_RTOL, EXTEND_ATOL = 1e-4, 1e-4
SCORE_SAMPLES, SCORE_CHUNK, SCORE_CLI_CHUNK = 16000, 4096, 8192
SCORE_CLI_SAMPLES = (4000, 12000)
SCORE_PER_SAMPLE_ATOL, SCORE_TOTAL_RTOL, SCORE_TOTAL_ATOL = 1e-4, 1e-5, 1e-3
SCORE_STREAM_ATOL = 1e-4
SPEC_SAMPLES, SPEC_K, SPEC_PERTURB = 1024, 8, 0.01
SPEC_CLI_SAMPLES, SPEC_CLI_SAVE_EVERY = 800, 200
DISTILL_STEPS, DISTILL_CLIPS, DISTILL_CLIP_SAMPLES = 4, 2, 2000
# The r3 probe's kernels, the routed one (cluster, on an H100) first; rounds
# of the cluster probe's `full` in turns with the production launch; how
# far a CTA's phases may fall short of its step loop (the loop's overhead).
R3_KERNELS, R3_TURNS, PHASE_SUM_RTOL = ("cluster", "decode"), 3, 0.05
# bf16 operands against their plain version: another summation order flips
# some bf16 roundings (2**-8 relative) and 30 layers carry them on (~0.3%
# of the values' mean, up to ~5% of max |ref| at a point); an indexing
# fault is O(1).
PROBE_BF16_RTOL, PROBE_BF16_MEAN_RTOL = 1e-1, 1e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def causal_rows(c) -> int:
    """Rows of the causal layer's weights: (kw_in - 1) * C_in + C_in."""
    from wavenet_torch.kernels.sampler import causal_width
    return causal_width(c) + c.input_channels


def lc_macs_per_row_step(c) -> int:
    """An LC config's extra products a row and step: lc_t @ lc_w[l] for
    every layer, C_lc x 2D each."""
    if not c.lc_enabled:
        return 0
    return c.num_layers * c.lc_channels * 2 * c.dilation_channels


def flops_per_row_step(c) -> int:
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    return 2 * (causal_rows(c) * R + L * (4 * R * D + D * R + D * S)
                + S * S + S * Q + lc_macs_per_row_step(c))


def chain_flops_per_row_step(c) -> int:
    """The layer chain's share of ``flops_per_row_step``: the filter/gate
    ``[past | current]``, dense and skip products."""
    L, R, D, S = (c.num_layers, c.residual_channels, c.dilation_channels,
                  c.skip_channels)
    return 2 * L * (4 * R * D + D * R + D * S)


def ops_seconds_per_row_step(c, wbytes: int = 4,
                             round_chain: bool = True) -> float:
    """Least time of one row's products for one step, each at its
    operands' peak: FP32 at float32 weights (``wbytes`` 4). At bf16
    weights (2) a product whose activation operand is rounded has two bf16
    operands and goes at the bf16 peak; that is every product but the
    layer chain's where ``round_chain`` is false (the b1 prefill route's
    float32 chain), which goes at FP32."""
    total = flops_per_row_step(c)
    if wbytes == 4:
        return total / FP32_FLOPS
    f32 = 0 if round_chain else chain_flops_per_row_step(c)
    return (total - f32) / BF16_FLOPS + f32 / FP32_FLOPS


def weight_bytes(c, wbytes: int = 4) -> int:
    """Bytes of the decode's weights: the matmul weights (an LC config's
    ``lc_w`` among them) at ``wbytes`` each (4, or 2 in the bf16 mode), the
    biases at 4."""
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    return (wbytes * (causal_rows(c) * R + L * (4 * R * D + D * R + D * S)
                      + S * S + S * Q + lc_macs_per_row_step(c))
            + 4 * (L * R + 2 * S + Q))


def bound_per_step(c, B: int, steps: int, wbytes: int = 4,
                   round_chain: bool = True, ring_bytes: int = 4):
    """Least time per step of one decode launch: every input read once and
    every output written once (weights at ``wbytes`` each, per-row adds,
    ring (``ring_bytes`` an element: 2 for a bf16 ring) and causal in and
    out, forced in, codes out, an LC config's stream of B x C_lc floats a
    step in), or its operations at their peaks
    (``ops_seconds_per_row_step``)."""
    L, D, Q = c.num_layers, c.dilation_channels, c.quantization_channels
    state = B * (ring_bytes * sum(c.dilations) * c.residual_channels
                 + 4 * Q)
    lc_stream = 4 * B * (c.lc_channels or 0) * steps
    nbytes = (weight_bytes(c, wbytes) + 4 * L * B * 2 * D + 2 * state + 4 * B
              + 4 * B * steps + lc_stream)
    t_bytes = nbytes / HBM_BYTES_PER_S / steps
    t_ops = ops_seconds_per_row_step(c, wbytes, round_chain) * B
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def sequential_bound_per_step(c, B: int, n_forced: int, n_total: int,
                              wbytes: int = 4):
    """Least time per step of one sequential launch (kernel 4's route):
    the weights (``wbytes`` each), per-row adds and forced prefix read once
    and the codes written once (the zero state is the kernel's own), or
    its operations at their peaks (the chain rounded at every B)."""
    from wavenet_torch.kernels.sampler import chain_rounded
    L, D = c.num_layers, c.dilation_channels
    nbytes = (weight_bytes(c, wbytes) + 4 * L * B * 2 * D + 4 * B * n_forced
              + 4 * B * n_total)
    t_bytes = nbytes / HBM_BYTES_PER_S / n_total
    t_ops = ops_seconds_per_row_step(c, wbytes,
                                     chain_rounded("sequential", B)) * B
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def weight_stream_bound_per_step(c, B: int):
    """Least time per step of a decode that reads every weight from device
    memory once per step (none kept on chip across steps), or its FP32
    operations at peak."""
    t_bytes = weight_bytes(c) / HBM_BYTES_PER_S
    t_ops = flops_per_row_step(c) * B / FP32_FLOPS
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def seeded_params(c, seed: int, device):
    """``init_params`` with seeded non-zero biases. ``init_params`` sets
    every bias to 0 and a trained checkpoint's are not, so without them
    no bias term of the kernel would be compared."""
    import torch
    from wavenet_torch.models.wavenet import init_params
    p = init_params(seed, c, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for k in sorted(p):
        if k.endswith("_bias"):
            p[k] = 0.1 * torch.randn(p[k].shape, generator=gen)
    return {k: v.to(device) for k, v in p.items()}


def cuda_ms(fn, reps: int = 1) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def randn_cuda(rng, *shape):
    """N(0, 1) float32 of ``shape`` drawn on the card from a generator
    seeded by ``rng``: the stack phases' cotangents hold up to hundreds of
    millions of values, which numpy takes seconds to draw."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(int(rng.randint(2**31)))
    return torch.randn(shape, generator=gen, device="cuda")


def setup(c, B: int, rng, seed_len: int, extra: int):
    """Seeded random seed codes (and GC ids) on the card."""
    import torch
    codes = torch.as_tensor(rng.randint(0, c.quantization_channels,
                                        (B, seed_len + extra)),
                            dtype=torch.int32, device="cuda")
    gc_ids = (torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                              device="cuda") if c.gc_enabled else None)
    return codes, gc_ids


def phase_teacher_forced(cfgs, params, rng, gpu):
    """The decode kernels, pinned, against the plain version: results by
    (kernel, config, batch)."""
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.wavenet import embed_gc, forward_codes

    results = {}
    for name, B in TEACHER_CASES:
        c, p = cfgs[name], params[name]
        plan = ks.device_plan(c, B)
        tplan = ks.device_tile_plan(c, B)
        kernels = (("decode",) + (("cluster",) if plan else ())
                   + (("tiles",) if tplan else ()))
        codes, gc_ids = setup(c, B, rng, PREFILL, TEACHER_STEPS)
        gc_emb = None if gc_ids is None else embed_gc(p, c, gc_ids)
        carry = ks.prefill_carry(p, c, codes[:, :PREFILL], gc_ids)
        packed = ks.pack_sampler_weights(p, c, B, gc_emb)
        forced = codes[:, PREFILL - 1:PREFILL - 1 + TEACHER_STEPS].contiguous()
        ring_r, causal_r = carry.ring.clone(), carry.causal.clone()
        codes_r, lg_r = ks.decode_reference(packed, c, ring_r, causal_r,
                                            forced, TEACHER_STEPS,
                                            carry.t_abs, 11,
                                            collect_logits=True)
        full = (forward_codes(p, c, codes[:, :PREFILL - 1 + TEACHER_STEPS],
                              gc_emb, head_from=PREFILL - 1)
                if B <= 4 else None)
        timed = (name, B) in TIMED_STEPS
        if timed:
            n_plain = 8
            rp, cp = carry.ring.clone(), carry.causal.clone()
            ms_p = cuda_ms(lambda: ks.decode_reference(
                packed, c, rp, cp, forced[:, :1].contiguous(), n_plain, 0,
                5)) / n_plain
        emitted = {}
        for kernel in kernels:
            ring_k, causal_k = carry.ring.clone(), carry.causal.clone()
            codes_k, lg_k = ks.decode(packed, c, ring_k, causal_k, forced,
                                      TEACHER_STEPS, carry.t_abs, 11,
                                      collect_logits=True, kernel=kernel)
            torch.cuda.synchronize()
            where = f"{DECODE_SOURCES[kernel]} {name} B={B}"
            err = (lg_k - lg_r).abs().max().item()
            check(torch.isfinite(lg_k).all().item(),
                  f"{where}: non-finite logits")
            check(torch.allclose(lg_k, lg_r, rtol=1e-4, atol=1e-4),
                  f"{where}: kernel logits differ from decode_reference "
                  f"(max |d| {err})")
            check(torch.allclose(ring_k, ring_r, rtol=1e-4, atol=1e-4),
                  f"{where}: ring state differs")
            check(torch.equal(causal_k, causal_r), f"{where}: causal differs")
            check(torch.equal(codes_k[:, :-1], forced[:, 1:]),
                  f"{where}: forced codes not emitted")
            emitted[kernel] = codes_k
            row = {"phase": "teacher_forced", "kernel": DECODE_SOURCES[kernel],
                   "config": name, "batch": B, "steps": TEACHER_STEPS,
                   "max_abs_err_vs_plain": err}
            if kernel != "decode":
                row["plan"] = (plan if kernel == "cluster" else
                               tplan)._asdict()
            if full is not None:
                err_f = (lg_k - full).abs().max().item()
                check(torch.allclose(lg_k, full, rtol=1e-4, atol=1e-4),
                      f"{where}: kernel logits differ from forward_codes "
                      f"(max |d| {err_f})")
                row["max_abs_err_vs_forward"] = err_f
            if timed:
                steps = TIMED_STEPS[(name, B)]
                fk = forced[:, :1].contiguous()
                ms_k = cuda_ms(lambda: ks.decode(
                    packed, c, ring_k, causal_k, fk, steps, 0, 5,
                    kernel=kernel)) / steps
                bound, by = bound_per_step(c, B, steps)
                ws_bound, ws_by = weight_stream_bound_per_step(c, B)
                row.update(ms_per_step=ms_k, plain_ms_per_step=ms_p,
                           bound_ms_per_step=bound, bound_by=by,
                           weight_stream_bound_ms_per_step=ws_bound,
                           weight_stream_bound_by=ws_by, timed_steps=steps)
                results[(kernel, name, B)] = dict(
                    config=name, max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                    bound_ms=bound, bound_by=by)
            row["gpu"] = gpu
            emit(row)
        for kernel in emitted:
            check(torch.equal(emitted[kernel], emitted["decode"]),
                  f"{name} B={B}: {DECODE_SOURCES[kernel]}'s teacher-forced "
                  "codes differ from sampler_decode's")
        if timed and len(kernels) > 1:
            check_route_is_faster(results, name, B, kernels[-1])
    return results


def check_route_is_faster(timed, name, B, routed: str) -> None:
    """The kernel the route takes at (name, B) is the fastest of those the
    same run timed there (keys (kernel, name, B))."""
    ms = {k: timed[(k, name, B)]["ms"] for k in DECODE_SOURCES
          if (k, name, B) in timed}
    for other, t in ms.items():
        check(other == routed or ms[routed] < t,
              f"{name} B={B}: the route takes {DECODE_SOURCES[routed]} "
              f"({ms[routed]:.5f} ms/step), {DECODE_SOURCES[other]} is "
              f"faster ({t:.5f})")


def phase_sampling(c, params, rng):
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.wavenet import embed_gc

    B, seed = 64, 1234
    codes, gc_ids = setup(c, B, rng, PREFILL, 0)
    carry = ks.prefill_carry(params, c, codes, gc_ids)
    packed = ks.pack_sampler_weights(params, c, B, embed_gc(params, c, gc_ids))
    last = carry.last[:, None].contiguous()

    def run(n_rows):
        # A copy: decode updates the ring in place.
        ring = carry.ring[:, :n_rows].clone(
            memory_format=torch.contiguous_format)
        causal = carry.causal[:n_rows].clone()
        pk = packed._replace(layer_add=packed.layer_add[:, :n_rows]
                             .contiguous())
        out, _ = ks.decode(pk, c, ring, causal, last[:n_rows].contiguous(),
                           FREE_STEPS, carry.t_abs, seed)
        return out, ring, causal

    before = dict(ks.decode.launches_by)
    k64, ring64, _ = run(B)
    served = {k: v - before.get(k, 0)
              for k, v in ks.decode.launches_by.items()
              if v != before.get(k, 0)}
    k4a, ring4a, causal4a = run(4)
    k4b, ring4b, causal4b = run(4)
    check(torch.equal(k4a, k4b) and torch.equal(ring4a, ring4b)
          and torch.equal(causal4a, causal4b),
          "same-seed kernel runs differ")
    check(torch.equal(k64[:4], k4a), "rows 0-3 of B=64 differ from B=4")
    check(torch.equal(ring64[:, :4], ring4a), "ring rows depend on B")

    # Replay on the plain version, teacher-forced on the kernel's codes.
    n = 4
    ring_r = carry.ring[:, :n].clone(memory_format=torch.contiguous_format)
    causal_r = carry.causal[:n].clone()
    pk = packed._replace(layer_add=packed.layer_add[:, :n].contiguous())
    forced = torch.cat([last[:n], k4a[:, :-1]], dim=1).contiguous()
    _, lg_r = ks.decode_reference(pk, c, ring_r, causal_r, forced,
                                  FREE_STEPS, carry.t_abs, seed,
                                  collect_logits=True)
    noise = ks.gumbel_noise(seed, n, carry.t_abs, FREE_STEPS,
                            c.quantization_channels, "cuda")
    scores = lg_r * 1.0 + noise.transpose(0, 1)
    top2 = scores.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    ref = scores.argmax(dim=-1).to(torch.int32)
    match = ref == k4a
    rate = match.float().mean().item()
    worst = margin[~match].max().item() if (~match).any() else 0.0
    check(rate >= 0.999, f"only {rate:.5f} of sampled codes match")
    check(worst < 1e-4, f"a mismatch sits at a top-2 margin of {worst}")
    emit({"phase": "sampling", "batch": n, "steps": FREE_STEPS,
          "b64_served_by": {DECODE_SOURCES[k]: v for k, v in served.items()},
          "match_rate": rate, "mismatches": int((~match).sum().item()),
          "max_mismatch_margin": worst, "bitwise_repeat": True,
          "rows_independent_of_batch": True})


def start_server(service):
    from http.server import ThreadingHTTPServer
    from wavenet_torch.serve import make_handler
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def launch_events(ks):
    """CUDA events around every decode launch made inside the block (on
    the stream each launch runs on): the list of (start, end) pairs."""
    import torch
    events, launch = [], ks._launch

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out
    ks._launch = timed
    try:
        yield events
    finally:
        ks._launch = launch


def phase_serving(cfgs, gpu):
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.params import save_npz
    from wavenet_torch.serve import GenerationService

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_smoke_")
    services = {}
    for name, c in cfgs.items():
        npz = os.path.join(tmp, f"{name}.npz")
        save_npz(npz, seeded_params(c, 7, "cpu"))
        js = os.path.join(tmp, f"{name}.json")
        with open(js, "w") as f:
            json.dump(c.to_json_dict(), f)
        services[name] = GenerationService(
            npz, js, c.gc_channels, c.gc_cardinality, warm_samples=256,
            device="cuda")
    servers = {k: start_server(s) for k, s in services.items()}
    Q = cfgs["paper"].quantization_channels
    launches = {}
    try:
        with urllib.request.urlopen(servers["paper"][1] + "/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and "CUDA" in health["sampler"],
              f"healthz: {health}")
        requests = [
            ("paper", "/generate", {"samples": 16000, "seed": 1,
                                    "format": "codes"}, 1),
            ("gc", "/generate", {"samples": 16000, "seed": 2, "gc_id": 7,
                                 "format": "codes"}, 1),
            ("paper", "/generate_batch", {"samples": 16000, "batch": 64,
                                          "seed": 3}, 64),
            ("paper", "/generate_batch", {"samples": 4000, "batch": 512,
                                          "seed": 4}, 512),
        ]
        ks.decode.launches = 0          # the main path's count starts here
        ks.decode.launches_by.clear()
        for name, path, payload, B in requests:
            before = ks.decode.launches
            before_by = dict(ks.decode.launches_by)
            with launch_events(ks) as events:
                t = time.perf_counter()
                body = post(servers[name][1] + path, payload)
                dt = time.perf_counter() - t
            torch.cuda.synchronize()
            decode_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
            n = payload["samples"]
            codes = body["codes"]
            rows = [codes] if B == 1 else codes
            check(len(rows) == B and all(len(r) == n for r in rows),
                  f"{path} b{B}: wrong response shape")
            flat = [v for r in rows for v in r]
            check(min(flat) >= 0 and max(flat) < Q, f"{path}: codes range")
            check(len(set(flat)) > 8, f"{path}: degenerate codes")
            delta = ks.decode.launches - before
            check(delta == 1, f"{path} b{B}: {delta} kernel launches")
            kernel = [k for k, v in ks.decode.launches_by.items()
                      if v != before_by.get(k, 0)][0]
            launches[B] = launches.get(B, 0) + delta
            emit({"phase": "serving", "config": name, "endpoint": path,
                  "batch": B, "samples": n, "seconds": dt,
                  "samples_per_s": B * n / dt, "kernel_launches": delta,
                  "kernel": DECODE_SOURCES[kernel], "decode_s": decode_s,
                  "outside_decode_s": dt - decode_s, "gpu": gpu})
        launches["by_kernel"] = dict(ks.decode.launches_by)
    finally:
        for httpd, _ in servers.values():
            httpd.shutdown()
            httpd.server_close()
    return launches


def median_cuda_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    import numpy as np
    return float(np.median([cuda_ms(fn) for _ in range(reps)]))


def within(got, ref, rtol: float, atol: float):
    """(max |got - ref|, that over max |ref|, whether it is within
    rtol * max|ref| + atol)."""
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    return err, err / scale if scale else err, err <= rtol * scale + atol


def worst_slice(got, ref, lead: int):
    """The largest max |got - ref| / max |ref| over the slices that the
    first ``lead`` dimensions index (a layer, a batch row): an error
    confined to one small slice hides under a whole-tensor limit."""
    n = 1
    for s in ref.shape[:lead]:
        n *= s
    err = (got - ref).reshape(n, -1).abs().amax(dim=1)
    scale = ref.reshape(n, -1).abs().amax(dim=1)
    # An all-zero slice must come out exactly zero.
    rel = (err / scale).nan_to_num(nan=0.0, posinf=float("inf"))
    return rel.max().item()


def hold(row, label, got, ref, rtol, atol, lead=None):
    """Check ``got`` against ``ref`` within rtol * max|ref| + atol (and,
    with ``lead``, each slice of the first ``lead`` dimensions within
    SLICE_RTOL of its own max |ref|); record the errors in ``row``."""
    import torch
    where = f"{row['config']} {label}"
    check(torch.isfinite(got).all().item(), f"{where}: non-finite output")
    err, rel, ok = within(got, ref, rtol, atol)
    row[f"max_abs_err_{label}"] = err
    row[f"max_rel_err_{label}"] = rel
    check(ok, f"{where}: differs from its reference by {err} ({rel} of "
          "max |ref|)")
    if lead:
        srel = worst_slice(got, ref, lead)
        row[f"max_slice_rel_err_{label}"] = srel
        check(srel <= SLICE_RTOL, f"{where}: a slice differs by {srel} of "
              "its max |ref|")
    return err


# Per-slice leading dimensions of the stack gradients (dx per batch row,
# the weights per layer, dadd per layer and row).
GRAD_LEADS = (1, 1, 1, 2, 1)
GRAD_NAMES = ("dx", "dw_fg", "dwd", "dadd", "dbd")


def stack_inputs(c, params, rng, B: int = TRAIN_BATCH,
                 samples: int = TRAIN_SAMPLES):
    """The stack's input and packed weights for a train batch of B rows of
    ``samples`` (the train CLI's shape): the causal layer of random codes,
    as ``forward_codes`` computes it, or of uniform(-1, 1) amplitudes for
    scalar input, as ``forward`` does."""
    import torch
    import torch.nn.functional as F
    from wavenet_torch.kernels.fused_stack import pack_stack_weights
    from wavenet_torch.models.wavenet import embed_gc
    from wavenet_torch.ops.conv import causal_conv_padded
    T = c.receptive_field + samples - 1
    codes, gc_ids = setup(c, B, rng, T, 0)
    w = params["causal_filter"]
    if c.scalar_input:
        amp = torch.as_tensor(rng.uniform(-1, 1, (B, T, 1)).astype("float32"),
                              device="cuda")
        x = causal_conv_padded(amp, w, dilation=1)
    else:
        x = F.embedding(codes.long(), w[1])
        x[:, 1:] += F.embedding(codes[:, :-1].long(), w[0])
    gc_emb = None if gc_ids is None else embed_gc(params, c, gc_ids)
    w_fg, wd, add, bd = pack_stack_weights(params, c, gc_emb, B)
    return (x.contiguous(), w_fg.contiguous(), wd.contiguous(),
            add.contiguous(), bd.contiguous())


def phase_stack_kernels(cfgs, params, rng, gpu):
    """Both fused-stack kernels ("mma": 3xTF32 tensor cores, "simt": FP32
    cores) against the plain versions, bitwise repeatable, timed in turns
    (simt, mma, mma, simt) in each direction beside their bounds under the
    FP32 and the 3xTF32 peak, with the device ms of one call by kernel; the
    route must take the faster. At the paper and gc configs, b8, both
    kernels; at the tiny config, at the tiny train CLI run's shape, the
    simt kernel that the route gives it; at the wide config (R = D = 64),
    b8, the mma kernel, the only one built at that width."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.models.config import tiny_config
    from wavenet_torch.utils.flops import (H100_FP32_FLOPS,
                                           H100_TF32X3_FLOPS, bound_ms,
                                           fused_stack_cost)

    cfgs = dict(cfgs, tiny=tiny_config())
    params = dict(params, tiny=seeded_params(cfgs["tiny"], 3, "cuda"))
    results = {}
    for name, B, samples, routes in STACK_CASES:
        c = cfgs[name]
        L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
        args = stack_inputs(c, params[name], rng, B, samples)
        T = args[0].shape[1]
        dy = torch.as_tensor(rng.randn(B, T, R).astype("float32"),
                             device="cuda")
        dz = randn_cuda(rng, B, T, L * D)
        w_fg, wd, _, bd = args[1:]
        out_p = fs.fused_stack_forward_reference(*args, c)
        y, fg = out_p[0], out_p[1]
        grads_p = fs.fused_stack_backward_reference(y, dy, fg, dz, w_fg, wd,
                                                    bd, c)
        routed = fs.stack_kernel_plan(c)
        check(routed in routes, f"{name}: the route takes {routed}, which "
              f"phase 5 does not time there")
        row = {"phase": "train_stack", "config": name, "batch": B,
               "positions": T, "routed": routed, "gpu": gpu}
        worst = {}
        for k in routes:
            out_k = [fs.forward(*args, c, kernel=k) for _ in range(2)]
            grads_k = [fs.backward(y, dy, fg, dz, w_fg, wd, bd, c, kernel=k)
                       for _ in range(2)]
            torch.cuda.synchronize()
            worst[("fwd", k)] = max(
                hold(row, f"{n}_{k}", a, b, FWD_RTOL, FWD_ATOL)
                for n, a, b in zip(("y", "fg", "z"), out_k[0], out_p))
            worst[("bwd", k)] = max(
                hold(row, f"{n}_{k}", a, b, GRAD_RTOL, GRAD_ATOL, lead)
                for n, a, b, lead in zip(GRAD_NAMES, grads_k[0], grads_p,
                                         GRAD_LEADS))
            for kind, pair in (("forward", out_k), ("backward", grads_k)):
                check(all(torch.equal(a, b) for a, b in zip(*pair)),
                      f"{name} {k}: two {kind} calls on the same inputs "
                      "differ")
            row[f"bitwise_repeat_{k}"] = True
            del out_k, grads_k

        timed = {
            "fwd": (lambda k: fs.forward(*args, c, kernel=k),
                    lambda: fs.fused_stack_forward_reference(*args, c)),
            "bwd": (lambda k: fs.backward(y, dy, fg, dz, w_fg, wd, bd, c,
                                          kernel=k),
                    lambda: fs.fused_stack_backward_reference(
                        y, dy, fg, dz, w_fg, wd, bd, c)),
        }
        for kind, (kern, plain) in timed.items():
            flops, nbytes = fused_stack_cost(c, B, T, backward=kind == "bwd")
            bounds = {"fp32": bound_ms(flops, nbytes, H100_FP32_FLOPS),
                      "tf32x3": bound_ms(flops, nbytes, H100_TF32X3_FLOPS)}
            ms = {k: [] for k in routes}
            for _ in range(STACK_TIMED_ROUNDS):
                for k in routes + routes[::-1]:
                    ms[k].append(cuda_ms(lambda: kern(k)))
            ms = {k: float(np.median(v)) for k, v in ms.items()}
            ms_p = median_cuda_ms(plain)
            check(all(ms[routed] <= v for v in ms.values()),
                  f"{name} {kind}: the route takes {routed} "
                  f"({ms[routed]:.5f} ms), the other kernel is faster "
                  f"({ms})")
            row.update({f"{kind}_plain_ms": ms_p, f"{kind}_flops": flops,
                        f"{kind}_bytes": nbytes})
            for label, (bound, by) in bounds.items():
                row[f"{kind}_bound_ms_{label}"] = bound
                row[f"{kind}_bound_by_{label}"] = by
            for k in routes:
                bound, by = bounds[STACK_PEAK[k]]
                trace = device_breakdown(lambda: kern(k))
                row.update({
                    f"{kind}_ms_{k}": ms[k],
                    f"{kind}_gflop_per_s_{k}": flops / ms[k] / 1e6,
                    f"{kind}_device_ms_by_kernel_{k}":
                        trace["by_kernel"] if trace else
                        "not measured (no device events)"})
                results[(name, kind, k)] = dict(
                    config=name, batch=B, positions=T,
                    max_abs_err=worst[(kind, k)], ms=ms[k], plain_ms=ms_p,
                    bound_ms=bound, bound_by=by,
                    bound_ms_fp32=bounds["fp32"][0],
                    bound_ms_tf32x3=bounds["tf32x3"][0])
        emit(row)
        del args, dy, dz, out_p, grads_p
        torch.cuda.empty_cache()
    return results


def hold_bf16(row, label, got, ref, ref32):
    """A bf16-mode output against its plain bf16 version ``ref``, on the
    scale of the plain bf16 version's distance from the plain float32 one
    ``ref32``: the mean error within BF16_MEAN_RATIO of the mean gap, the
    worst within BF16_MAX_RATIO of the worst gap; both recorded in
    ``row``."""
    import torch
    got, ref, ref32 = got.float(), ref.float(), ref32.float()
    where = f"{row['config']} bf16 {label}"
    check(torch.isfinite(got).all().item(), f"{where}: non-finite output")
    scale = ref.abs().max().item()
    err, gap = (got - ref).abs(), (ref - ref32).abs()
    mx, mean = err.max().item(), err.mean().item()
    gmx, gmean = gap.max().item(), gap.mean().item()
    row[f"max_abs_err_{label}"] = mx
    row[f"max_rel_err_{label}"] = mx / scale
    row[f"mean_rel_err_{label}"] = mean / scale
    row[f"bf16_gap_max_rel_{label}"] = gmx / scale
    row[f"bf16_gap_mean_rel_{label}"] = gmean / scale
    check(mean <= BF16_MEAN_RATIO * gmean and mx <= BF16_MAX_RATIO * gmx,
          f"{where}: differs from its plain bf16 version by {mx} at worst "
          f"and {mean} on average, where the plain bf16 version lies {gmx} "
          f"and {gmean} from float32")
    return mx


def teacher_forced_bf16(row, c16, args, y_k, fg_k, z_k):
    """Each layer of the bf16 mode's forward from the kernel's own input to
    that layer, rebuilt from its bf16 z records (which are the operands the
    kernel multiplied): the plain bf16 layer's fg and z records against
    the kernel's, per layer, and y against the rebuilt output; the worst
    layer's errors recorded in ``row``."""
    import torch
    import torch.nn.functional as F
    x, w_fg, wd, add, bd = args
    D, T = c16.dilation_channels, x.shape[1]

    def r(t):
        return t.to(torch.bfloat16).float()

    w_fg_r, wd_r = r(w_fg), r(wd)
    worst = {}
    for l, d in enumerate(c16.dilations):
        past = F.pad(x, (0, 0, d, 0))[:, :T]
        fg = r(torch.cat([past, x], dim=-1)) @ w_fg_r[l] + add[l][:, None]
        z = torch.tanh(fg[..., :D]) * torch.sigmoid(fg[..., D:])
        zk = z_k[..., D * l:D * (l + 1)].float()
        for name, ref, got in (("fg", fg, fg_k[..., 2 * D * l:2 * D * (l + 1)]),
                               ("z", z, zk)):
            ref, got = r(ref), got.float()
            scale = ref.abs().max().item()
            err = (got - ref).abs()
            mx, mean = err.max().item() / scale, err.mean().item() / scale
            w = worst.setdefault(name, [0.0, 0.0, -1])
            if mx > w[0]:
                w[0], w[2] = mx, l
            w[1] = max(w[1], mean)
        x = (x + zk @ wd_r[l]) + bd[l]
    err, rel, ok = within(y_k, x, FWD_RTOL, FWD_ATOL)
    row["layer_y_max_rel_err"] = rel
    where = f"{row['config']} bf16"
    check(ok, f"{where}: y differs from the output rebuilt from the "
          f"kernel's own z records by {err} ({rel} of max |ref|)")
    for name, (mx, mean, l) in worst.items():
        row[f"layer_max_rel_err_{name}"] = mx
        row[f"layer_mean_rel_err_{name}"] = mean
        check(mx <= BF16_LAYER_MAX_RTOL and mean <= BF16_LAYER_MEAN_RTOL,
              f"{where} layer {l}: the kernel's {name} record differs from "
              f"the plain bf16 layer on its own input by {mx} of max |ref| "
              f"at worst ({mean} on average at worst)")


def phase_stack_bf16(name, c, params, rng, gpu):
    """TPU kernel 5 at kernel_dtype bf16 on the kernel the route takes at
    the ``name`` config: fused_stack_mma's bf16 mode at gc (R = D = 32)
    and wide (64), fused_stack.cu's at tiny (16); b8 x (receptive field +
    16,000): each forward layer on its own
    input (``teacher_forced_bf16``), and forward and backward against the
    plain bf16 versions on the scale of bf16's own distance from the
    plain float32 versions (BF16_MEAN_RATIO, BF16_MAX_RATIO); bitwise-equal
    repeats; timed
    in turns with the same kernel's float32 mode (f32, bf16, bf16, f32)
    beside its bound at the bf16 peak with 2-byte records (the simt
    kernel's bound at the FP32 peak too, since it multiplies on the FP32
    cores); the device ms of a call by kernel."""
    import dataclasses
    import numpy as np
    import torch
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.utils.flops import (H100_BF16_FLOPS, H100_FP32_FLOPS,
                                           bound_ms, fused_stack_cost)

    c16 = dataclasses.replace(c, compute_dtype="bfloat16")
    route = "simt" if c.residual_channels < 32 else "mma"
    check(fs.stack_kernel_plan(c16) == route == fs.stack_kernel_plan(c),
          f"the bf16 route does not take {fs._SOURCES[route]} at the {name} "
          "width")
    B = TRAIN_BATCH
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    args = stack_inputs(c, params, rng, B, TRAIN_SAMPLES)
    T = args[0].shape[1]
    w_fg, wd, _, bd = args[1:]
    dy = torch.as_tensor(rng.randn(B, T, R).astype("float32"), device="cuda")
    dz = randn_cuda(rng, B, T, L * D).to(torch.bfloat16)
    out_p = fs.fused_stack_forward_reference(*args, c16)
    y, fg = out_p[0], out_p[1]
    grads_p = fs.fused_stack_backward_reference(y, dy, fg, dz, w_fg, wd, bd,
                                                c16)
    dz32 = dz.float()
    out32 = fs.fused_stack_forward_reference(*args, c)
    y32, fg32 = out32[0], out32[1]
    grads32 = fs.fused_stack_backward_reference(y32, dy, fg32, dz32, w_fg, wd,
                                                bd, c)
    row = {"phase": "train_stack_bf16", "config": name, "batch": B,
           "positions": T, "kernel": fs.launch_key(route, c16), "gpu": gpu}
    out_k = [fs.forward(*args, c16) for _ in range(2)]
    grads_k = [fs.backward(y, dy, fg, dz, w_fg, wd, bd, c16)
               for _ in range(2)]
    torch.cuda.synchronize()
    check(out_k[0][1].dtype == torch.bfloat16
          and out_k[0][2].dtype == torch.bfloat16, "the bf16 mode's records "
          "are not bf16")
    teacher_forced_bf16(row, c16, args, *out_k[0])
    worst = {"fwd": max(hold_bf16(row, n, a, b, r) for n, a, b, r in
                        zip(("y", "fg", "z"), out_k[0], out_p, out32)),
             "bwd": max(hold_bf16(row, n, a, b, r) for n, a, b, r in
                        zip(GRAD_NAMES, grads_k[0], grads_p, grads32))}
    for kind, pair in (("forward", out_k), ("backward", grads_k)):
        check(all(torch.equal(a, b) for a, b in zip(*pair)),
              f"{name} bf16: two {kind} calls on the same inputs differ")
    row["bitwise_repeat"] = True
    del out_k, grads_k, grads32

    timed = {
        "fwd": (lambda m: fs.forward(*args, c16 if m == "bf16" else c),
                lambda: fs.fused_stack_forward_reference(*args, c16)),
        "bwd": (lambda m: (fs.backward(y, dy, fg, dz, w_fg, wd, bd, c16)
                           if m == "bf16" else
                           fs.backward(y32, dy, fg32, dz32, w_fg, wd, bd, c)),
                lambda: fs.fused_stack_backward_reference(
                    y, dy, fg, dz, w_fg, wd, bd, c16)),
    }
    results = {}
    modes = ("f32", "bf16")
    for kind, (kern, plain) in timed.items():
        flops, nbytes = fused_stack_cost(c16, B, T, backward=kind == "bwd")
        bound, by = bound_ms(flops, nbytes, H100_BF16_FLOPS)
        bound32, by32 = bound_ms(flops, nbytes, H100_FP32_FLOPS)
        ms = {m: [] for m in modes}
        for _ in range(STACK_TIMED_ROUNDS):
            for m in modes + modes[::-1]:
                ms[m].append(cuda_ms(lambda: kern(m)))
        ms = {m: float(np.median(v)) for m, v in ms.items()}
        ms_p = median_cuda_ms(plain)
        trace = device_breakdown(lambda: kern("bf16"))
        row.update({
            f"{kind}_ms_bf16": ms["bf16"], f"{kind}_ms_f32_mode": ms["f32"],
            f"{kind}_plain_ms": ms_p, f"{kind}_flops": flops,
            f"{kind}_bytes": nbytes, f"{kind}_bound_ms_bf16": bound,
            f"{kind}_bound_by_bf16": by, f"{kind}_bound_ms_fp32": bound32,
            f"{kind}_bound_by_fp32": by32,
            f"{kind}_device_ms_by_kernel_bf16":
                trace["by_kernel"] if trace else
                "not measured (no device events)"})
        results[kind] = dict(config=name, batch=B, positions=T,
                             max_abs_err=worst[kind], ms=ms["bf16"],
                             f32_mode_ms=ms["f32"], plain_ms=ms_p,
                             bound_ms=bound, bound_by=by,
                             bound_ms_fp32=bound32, bound_by_fp32=by32)
    emit(row)
    del args, dy, dz, dz32, out_p, grads_p, out32, y32, fg32
    torch.cuda.empty_cache()
    return results


STACK_KERNELS = ("fwd_layer_kernel", "bwd_da_kernel", "bwd_dx_kernel",
                 "fwd_mma_kernel", "bwd_da_mma_kernel", "bwd_dx_mma_kernel",
                 "reduce_partials_kernel", "tiled_kernel", "reduce_kernel")


def kernel_base_name(name: str) -> str:
    """The kernel's own name in a device event's demangled name, e.g.
    ``fwd_layer_kernel`` of ``void (anonymous namespace)::
    fwd_layer_kernel<32u, 32u>(float const*, ...)``."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0].split("::")[-1].split()
    return head[-1] if head else name


def device_breakdown(fn):
    """Device time of one call of ``fn`` by kernel family and by kernel
    (``by_kernel``; the tiled stack's one kernel by the product it runs,
    e.g. ``tiled_kernel:bwdgateop``), the count of
    the fused stack's device kernels in it (``stack_kernels``), and the
    device's busy time against the wall time of the call (the profiler
    adds host overhead, so the idle share is an upper bound), from a
    ``torch.profiler`` trace. None when the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = [(e.name.lower(), e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    fam = {"fused_stack_ms": 0.0, "gemm_ms": 0.0, "optimizer_ms": 0.0,
           "other_ms": 0.0}
    stack_kernels = 0
    by_kernel = {}
    for name, start, end in spans:
        ms = (end - start) / 1e3
        base = kernel_base_name(name)
        op = re.search(r"tiled_kernel<[^,]*, (?:\(anonymous namespace\)::)?"
                       r"(\w+)", name)
        key = f"{base}:{op.group(1)}" if op else base
        by_kernel[key] = by_kernel.get(key, 0.0) + ms
        if base in STACK_KERNELS:
            fam["fused_stack_ms"] += ms
            stack_kernels += 1
        elif "gemm" in name or "nvjet" in name:   # nvjet: cuBLASLt's bf16 GEMMs
            fam["gemm_ms"] += ms
        elif "multi_tensor" in name or "adam" in name:
            fam["optimizer_ms"] += ms
        else:
            fam["other_ms"] += ms
    busy_us, end_us = 0.0, None
    for _, start, end in sorted(spans, key=lambda x: x[1]):
        if end_us is None or start >= end_us:
            busy_us += end - start
            end_us = end
        elif end > end_us:
            busy_us += end - end_us
            end_us = end
    return dict(fam, kernels=len(spans), stack_kernels=stack_kernels,
                by_kernel=by_kernel,
                device_busy_ms=busy_us / 1e3,
                wall_ms=wall_ms, idle_share=1.0 - busy_us / 1e3 / wall_ms)


def phase_train_step(name, c, params, rng, gpu):
    """One b8 train step of the ``name`` config (gc; wide: the stack at
    width 64) with the fused stack against the plain one: the loss and
    every gradient, the step times and the device breakdown."""
    import dataclasses
    import torch
    from wavenet_torch import train_lib as tl
    from wavenet_torch.models.wavenet import loss_fn

    B, n = TRAIN_BATCH, c.receptive_field + TRAIN_SAMPLES
    t = torch.arange(n, device="cuda", dtype=torch.float32) / c.sample_rate
    freqs = torch.as_tensor(rng.uniform(100, 400, (B, 1)).astype("float32"),
                            device="cuda")
    audio = 0.5 * torch.sin(2 * 3.14159265 * freqs * t) + 0.05 * torch.as_tensor(
        rng.randn(B, n).astype("float32"), device="cuda")
    gc_ids = (torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                              device="cuda") if c.gc_enabled else None)
    from wavenet_torch.kernels import fused_stack as fs
    out = {}
    by_before = (dict(fs.forward.launches_by), dict(fs.backward.launches_by))
    for fused in (True, False):
        cfg = dataclasses.replace(c, use_pallas_stack=fused)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        loss, _ = loss_fn(leaves, cfg, audio, gc_ids)
        loss.backward()
        state = tl.train_state_from_params(params,
                                           tl.make_optimizer("adam", 1e-3))
        step = tl.make_train_step(cfg)
        step(state, audio, gc_ids)                       # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, m = step(state, audio, gc_ids)
            m["loss"].item()
            times.append(1e3 * (time.perf_counter() - t0))
        out[fused] = (loss.item(), {k: v.grad for k, v in leaves.items()},
                      sorted(times)[1],
                      device_breakdown(
                          lambda: step(state, audio, gc_ids)[1]["loss"].item()))
        del state, leaves
        torch.cuda.empty_cache()
    stack_by = {kind: {k: n - before.get(k, 0) for k, n in now.items()
                       if n > before.get(k, 0)}
                for kind, before, now in zip(
                    ("fwd", "bwd"), by_before,
                    (fs.forward.launches_by, fs.backward.launches_by))}
    routed = fs.stack_kernel_plan(c)
    check(set(stack_by["fwd"]) == {routed} and set(stack_by["bwd"]) == {routed},
          f"{name} train step: the fused stack ran {stack_by}, not the "
          f"routed {routed}")
    (lf, gf, ms_f, bd_f), (lp, gp, ms_p, bd_p) = out[True], out[False]
    check(abs(lf - lp) <= 1e-5 * abs(lp),
          f"{name} train step: fused loss {lf} differs from plain {lp}")
    worst = 0.0
    for k in sorted(gp):
        err, rel, ok = within(gf[k], gp[k], GRAD_RTOL, GRAD_ATOL)
        check(ok, f"{name} train step: gradient {k} differs (max |d| {err})")
        worst = max(worst, rel)
    emit({"phase": "train_step", "config": name, "batch": B,
          "audio_samples": n, "loss_fused": lf, "loss_plain": lp,
          "max_grad_err_over_max_ref": worst, "step_ms_fused": ms_f,
          "stack_launches_by": stack_by,
          "step_ms_plain": ms_p,
          "device_fused": bd_f or "not measured (no device events)",
          "device_plain": bd_p or "not measured (no device events)",
          "gpu": gpu})


def phase_train_step_bf16(c, params, rng, gpu):
    """A train step at compute_dtype bfloat16 at the paper config, b8 x
    (receptive field + 16,000) (the JAX bench's train_b8 shape, bf16 as its
    row), plain (bf16 cuBLAS GEMMs, reduced-precision reductions off) and
    fused (fused_stack_mma's bf16 mode): each loss within BF16_LOSS_RTOL
    and each gradient within BF16_GRAD_RTOL of max |ref| of the float32
    plain step's; the step ms and the device breakdown (stack, GEMMs,
    Adam, other)."""
    import dataclasses
    import torch
    from wavenet_torch import train_lib as tl
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.models.wavenet import loss_fn, matmul_precision

    B, n = TRAIN_BATCH, c.receptive_field + TRAIN_SAMPLES
    t = torch.arange(n, device="cuda", dtype=torch.float32) / c.sample_rate
    freqs = torch.as_tensor(rng.uniform(100, 400, (B, 1)).astype("float32"),
                            device="cuda")
    audio = 0.5 * torch.sin(2 * 3.14159265 * freqs * t) + 0.05 * torch.as_tensor(
        rng.randn(B, n).astype("float32"), device="cuda")

    def loss_and_grads(cfg):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        with matmul_precision(cfg):
            loss, _ = loss_fn(leaves, cfg, audio)
            loss.backward()
        return loss.item(), {k: v.grad for k, v in leaves.items()}

    loss32, g32 = loss_and_grads(dataclasses.replace(c,
                                                     use_pallas_stack=False))
    row = {"phase": "train_step_bf16", "config": "paper", "batch": B,
           "audio_samples": n, "loss_f32_plain": loss32, "gpu": gpu}
    for fused in (True, False):
        label = "fused" if fused else "plain"
        cfg = dataclasses.replace(c, use_pallas_stack=fused,
                                  compute_dtype="bfloat16")
        before = (dict(fs.forward.launches_by), dict(fs.backward.launches_by))
        loss, grads = loss_and_grads(cfg)
        check(loss == loss and abs(loss - loss32) <= BF16_LOSS_RTOL * loss32,
              f"bf16 {label} step: loss {loss} against float32 {loss32}")
        worst = 0.0
        for k in sorted(g32):
            err, rel, ok = within(grads[k], g32[k], BF16_GRAD_RTOL, 0.0)
            check(ok and torch.isfinite(grads[k]).all().item(),
                  f"bf16 {label} step: gradient {k} differs from float32 "
                  f"by {err} ({rel} of max |ref|)")
            worst = max(worst, rel)
        state = tl.train_state_from_params(params,
                                           tl.make_optimizer("adam", 1e-3))
        step = tl.make_train_step(cfg)
        step(state, audio)                               # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, m = step(state, audio)
            m["loss"].item()
            times.append(1e3 * (time.perf_counter() - t0))
        trace = device_breakdown(lambda: step(state, audio)[1]["loss"].item())
        ran = {kind: {k: v - b.get(k, 0) for k, v in now.items()
                      if v > b.get(k, 0)}
               for kind, b, now in zip(("fwd", "bwd"), before,
                                       (fs.forward.launches_by,
                                        fs.backward.launches_by))}
        want = {"mma_bf16": 6} if fused else {}
        check(ran["fwd"] == want and ran["bwd"] == want,
              f"bf16 {label} step: the stack kernels ran {ran}, not {want}")
        row.update({f"loss_{label}": loss,
                    f"max_grad_err_over_max_f32_ref_{label}": worst,
                    f"step_ms_{label}": sorted(times)[1],
                    f"stack_launches_by_{label}": ran,
                    f"device_{label}": trace or
                    "not measured (no device events)"})
        del state, grads
        torch.cuda.empty_cache()
    emit(row)


def synth_corpus(root: str, speakers: int = 109, utterances: int = 2,
                 seconds: float = 2.0, sr: int = 16000) -> None:
    """p<speaker>_<utt>.wav: seeded sines plus noise, 16-bit PCM."""
    import numpy as np
    from wavenet_torch.audio import write_wav
    rng = np.random.RandomState(0)
    t = np.arange(int(sr * seconds)) / sr
    for spk in range(speakers):
        for utt in range(utterances):
            f0 = rng.uniform(80, 400)
            x = (0.5 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6))
                 + 0.02 * rng.randn(t.size))
            write_wav(os.path.join(root, f"p{spk}_{utt:03d}.wav"), x, sr)


def tee_main(main_fn, argv):
    """``main_fn(argv)`` in this process (so that the kernels' launch
    counts see it), its output echoed and returned with the wall seconds
    it took."""

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    buf = Tee()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    seconds = time.perf_counter() - t
    check(rc == 0, f"{main_fn.__module__} exited {rc}")
    return buf.getvalue(), seconds


def run_cli(argv):
    """``wavenet_torch.cli.train.main(argv)`` in this process: its
    output."""
    from wavenet_torch.cli import train as cli
    return tee_main(cli.main, argv)[0]


def phase_train_cli(c, wide, gpu):
    """The main path of training: the train CLI with --use_pallas_stack
    (the routed stack kernel), its resume and a server from its last
    checkpoint; then a short run of the tiny config (R = D = 16:
    ``fused_stack.cu``) and one at --compute_dtype bfloat16 (its bf16
    mode, b8 x 16,000); then the gc run at --compute_dtype bfloat16
    (``fused_stack_mma``'s bf16 mode); last, the ``wide`` config (R = D =
    64, scalar input) at float32 and at bfloat16, fused (``fused_stack_mma``
    at width 64; the f32 run also resumed) and plain, in turns."""
    import numpy as np
    from wavenet_torch import train_lib as tl
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.config import tiny_config
    from wavenet_torch.serve import GenerationService
    from wavenet_torch.utils.flops import train_step_flops

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_train_")
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    synth_corpus(corpus)
    pfile = os.path.join(tmp, "wavenet_params.json")
    with open(pfile, "w") as f:
        json.dump(c.to_json_dict(), f)
    logdir = os.path.join(tmp, "logdir")
    argv = ["--data_dir", corpus, "--wavenet_params", pfile,
            "--logdir", logdir, "--gc_channels", str(c.gc_channels),
            "--use_pallas_stack", "--batch_size", str(TRAIN_BATCH),
            "--sample_size", str(TRAIN_SAMPLES), "--checkpoint_every", "4",
            "--steps_per_dispatch", "4", "--seed", "0",
            "--device", "cuda"]

    from wavenet_torch.data import native
    check(native.available(), "the native data library did not load")
    decoded = native.read_wav.calls
    routed = fs.stack_kernel_plan(c)
    fs.forward.launches = fs.backward.launches = 0   # the main path
    fs.forward.launches_by.clear()
    fs.backward.launches_by.clear()
    t0 = time.perf_counter()
    out = run_cli(argv + ["--num_steps", str(TRAIN_STEPS)])
    seconds = time.perf_counter() - t0
    decoded = native.read_wav.calls - decoded
    check(decoded > 0, "the train CLI's reader decoded no file natively")
    launches = {"fwd": fs.forward.launches, "bwd": fs.backward.launches}
    launches_by = {"fwd": dict(fs.forward.launches_by),
                   "bwd": dict(fs.backward.launches_by)}
    check(all(v == {routed: TRAIN_STEPS} for v in launches_by.values()),
          f"the train CLI ran the stack kernels {launches_by}, not "
          f"{routed} every step")
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    losses = [float(ln.split("loss = ")[1].split(",")[0]) for ln in lines]
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} loss lines")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches["fwd"] == TRAIN_STEPS and launches["bwd"] == TRAIN_STEPS,
          f"fused_stack launches {launches}, expected one of each per step")
    for step in (4, TRAIN_STEPS):
        check(os.path.isdir(os.path.join(logdir, f"ckpt-{step}")),
              f"no ckpt-{step}")
    # Steady-state rate: the last dispatch's steps (the first pays the
    # start-up), from the CLI's own sec/step in its metrics.jsonl.
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        sec_per_step = [r["value"] for r in map(json.loads, f)
                        if r["tag"] == "sec_per_step"][-1]
    aps = TRAIN_BATCH * (c.receptive_field + TRAIN_SAMPLES) / \
        c.sample_rate / sec_per_step
    flops = train_step_flops(c, TRAIN_BATCH, TRAIN_SAMPLES)
    emit({"phase": "train_cli", "config": "gc", "batch": TRAIN_BATCH,
          "sample_size": TRAIN_SAMPLES, "steps": TRAIN_STEPS,
          "losses": losses, "seconds": seconds,
          "sec_per_step_last": sec_per_step, "audio_sec_per_s": aps,
          "model_tflop_per_s": flops / sec_per_step / 1e12,
          "fused_stack_fwd_launches": launches["fwd"],
          "fused_stack_bwd_launches": launches["bwd"],
          "stack_kernel": routed, "stack_launches_by": launches_by,
          "native_decoder": native.library_path(),
          "files_decoded_natively": decoded, "gpu": gpu})

    # The resume is a run of its own: its launches are counted apart.
    fs.forward.launches = fs.backward.launches = 0
    fs.forward.launches_by.clear()
    fs.backward.launches_by.clear()
    out = run_cli(argv + ["--num_steps", str(RESUME_STEPS)])
    check(f"Restored model from step {TRAIN_STEPS}" in out,
          "the rerun did not restore from the last checkpoint")
    check(f"step {RESUME_STEPS} - loss = " in out, "the rerun did not train")
    resumed = {"fwd": fs.forward.launches, "bwd": fs.backward.launches}
    n = RESUME_STEPS - TRAIN_STEPS
    check(resumed["fwd"] == n and resumed["bwd"] == n
          and fs.forward.launches_by[routed] == n
          and fs.backward.launches_by[routed] == n,
          f"fused_stack launches in the resume {resumed}, expected {n} "
          f"each of {routed}")
    check(tl.latest_checkpoint_step(logdir) == RESUME_STEPS,
          "no checkpoint of the resumed run")

    service = GenerationService(
        os.path.join(logdir, f"ckpt-{RESUME_STEPS}", "params.npz"), pfile,
        c.gc_channels, c.gc_cardinality, warm_samples=0, device="cuda")
    httpd, url = start_server(service)
    try:
        before = ks.decode.launches
        body = post(url + "/generate", {"samples": 1000, "seed": 5,
                                        "gc_id": 3, "format": "codes"})
    finally:
        httpd.shutdown()
        httpd.server_close()
    codes = body["codes"]
    check(len(codes) == 1000 and 0 <= min(codes)
          and max(codes) < c.quantization_channels,
          "the trained model's /generate answer is malformed")
    check(ks.decode.launches == before + 1, "/generate did not launch the "
          "decode kernel")
    emit({"phase": "train_resume_serve", "restored_from": TRAIN_STEPS,
          "steps": RESUME_STEPS, "generated": len(codes),
          "resume_fused_stack_fwd_launches": resumed["fwd"],
          "resume_fused_stack_bwd_launches": resumed["bwd"], "gpu": gpu})

    # The FP32-core kernel keeps the widths below 32: the train CLI at the
    # repo's tiny config (R = D = 16) runs it every step, at the shape
    # phase 5 checks and times it.
    narrow = tiny_config()
    check(fs.stack_kernel_plan(narrow) == "simt",
          "the route does not send R = D = 16 to fused_stack.cu")
    nfile = os.path.join(tmp, "tiny_params.json")
    with open(nfile, "w") as f:
        json.dump(narrow.to_json_dict(), f)
    nargv = ["--data_dir", corpus, "--wavenet_params", nfile,
             "--logdir", os.path.join(tmp, "tiny"), "--use_pallas_stack",
             "--batch_size", str(NARROW_BATCH), "--sample_size",
             str(NARROW_SAMPLES),
             "--num_steps", str(NARROW_STEPS), "--checkpoint_every",
             str(NARROW_STEPS), "--seed", "0", "--device", "cuda"]
    fs.forward.launches_by.clear()
    fs.backward.launches_by.clear()
    out = run_cli(nargv)
    narrow_by = {"fwd": dict(fs.forward.launches_by),
                 "bwd": dict(fs.backward.launches_by)}
    check(all(v == {"simt": NARROW_STEPS} for v in narrow_by.values()),
          f"the tiny train CLI ran the stack kernels {narrow_by}, not "
          f"simt every step")
    check(f"step {NARROW_STEPS} - loss = " in out, "the tiny train CLI run "
          "did not train")
    emit({"phase": "train_cli_narrow", "config": "tiny",
          "residual_channels": narrow.residual_channels,
          "batch": NARROW_BATCH, "sample_size": NARROW_SAMPLES,
          "steps": NARROW_STEPS, "stack_launches_by": narrow_by, "gpu": gpu})
    # The same config at --compute_dtype bfloat16 and the train shape: the
    # bf16 mode of fused_stack.cu every step, counted from 0.
    nbdir = os.path.join(tmp, "tiny_bf16")
    nbargv = ["--data_dir", corpus, "--wavenet_params", nfile,
              "--logdir", nbdir, "--use_pallas_stack",
              "--compute_dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
              "--sample_size", str(TRAIN_SAMPLES),
              "--num_steps", str(NARROW_BF16_STEPS), "--checkpoint_every",
              str(NARROW_BF16_STEPS), "--seed", "0", "--device", "cuda"]
    fs.forward.launches_by.clear()                     # the tiny bf16 path
    fs.backward.launches_by.clear()
    t0 = time.perf_counter()
    out = run_cli(nbargv)
    nbseconds = time.perf_counter() - t0
    narrow_bf16_by = {"fwd": dict(fs.forward.launches_by),
                      "bwd": dict(fs.backward.launches_by)}
    check(all(v == {"simt_bf16": NARROW_BF16_STEPS}
              for v in narrow_bf16_by.values()),
          f"the tiny bf16 train CLI ran the stack kernels {narrow_bf16_by}, "
          "not simt_bf16 every step")
    nblosses = [float(ln.split("loss = ")[1].split(",")[0])
                for ln in out.splitlines() if ln.startswith("step ")]
    check(len(nblosses) == NARROW_BF16_STEPS
          and all(x == x and abs(x) != float("inf") for x in nblosses)
          and nblosses[-1] < nblosses[0],
          f"tiny bf16 train CLI losses {nblosses}: not "
          f"{NARROW_BF16_STEPS} finite, falling values")
    with open(os.path.join(nbdir, "metrics.jsonl")) as f:
        nbsec = [r["value"] for r in map(json.loads, f)
                 if r["tag"] == "sec_per_step"][-1]
    emit({"phase": "train_cli_narrow_bf16", "config": "tiny",
          "residual_channels": narrow.residual_channels,
          "batch": TRAIN_BATCH, "sample_size": TRAIN_SAMPLES,
          "steps": NARROW_BF16_STEPS, "losses": nblosses,
          "seconds": nbseconds, "sec_per_step_last": nbsec,
          "audio_sec_per_s": TRAIN_BATCH * (narrow.receptive_field
                                            + TRAIN_SAMPLES)
          / narrow.sample_rate / nbsec,
          "stack_launches_by": narrow_bf16_by, "gpu": gpu})

    # bf16: the gc run again at --compute_dtype bfloat16, a logdir of its
    # own; the stack runs fused_stack_mma's bf16 mode every step.
    blogdir = os.path.join(tmp, "logdir_bf16")
    bargv = [a if a != logdir else blogdir for a in argv] + [
        "--compute_dtype", "bfloat16", "--num_steps", str(TRAIN_STEPS)]
    fs.forward.launches_by.clear()                      # the bf16 path
    fs.backward.launches_by.clear()
    t0 = time.perf_counter()
    out = run_cli(bargv)
    bseconds = time.perf_counter() - t0
    bf16_by = {"fwd": dict(fs.forward.launches_by),
               "bwd": dict(fs.backward.launches_by)}
    check(all(v == {"mma_bf16": TRAIN_STEPS} for v in bf16_by.values()),
          f"the bf16 train CLI ran the stack kernels {bf16_by}, not "
          "mma_bf16 every step")
    blosses = [float(ln.split("loss = ")[1].split(",")[0])
               for ln in out.splitlines() if ln.startswith("step ")]
    check(len(blosses) == TRAIN_STEPS
          and all(x == x and abs(x) != float("inf") for x in blosses)
          and blosses[-1] < blosses[0],
          f"bf16 train CLI losses {blosses}: not {TRAIN_STEPS} finite, "
          "falling values")
    with open(os.path.join(blogdir, "metrics.jsonl")) as f:
        bsec = [r["value"] for r in map(json.loads, f)
                if r["tag"] == "sec_per_step"][-1]
    with np.load(os.path.join(blogdir, f"ckpt-{TRAIN_STEPS}",
                              "params.npz")) as z:
        check({z[k].dtype for k in z.files} == {np.dtype(np.float32)},
              "the bf16 run's checkpoint holds non-float32 params")
    emit({"phase": "train_cli_bf16", "config": "gc", "batch": TRAIN_BATCH,
          "sample_size": TRAIN_SAMPLES, "steps": TRAIN_STEPS,
          "losses": blosses, "seconds": bseconds, "sec_per_step_last": bsec,
          "audio_sec_per_s": TRAIN_BATCH * (c.receptive_field
                                            + TRAIN_SAMPLES)
          / c.sample_rate / bsec,
          "audio_sec_per_s_f32": aps, "stack_launches_by": bf16_by,
          "gpu": gpu})

    # The wide config: fused_stack_mma at width 64 every fused step, each
    # run's launches counted from 0; the plain route beside it in the same
    # process (a rate of its own, not a yardstick of the kernel).
    check(fs.stack_kernel_plan(wide) == "mma", "the route does not send "
          "R = D = 64 to fused_stack_mma")
    wfile = os.path.join(tmp, "wide_params.json")
    with open(wfile, "w") as f:
        json.dump(wide.to_json_dict(), f)
    wide_by = {}
    for dtype in ("float32", "bfloat16"):
        for fused in (True, False):
            label = f"{dtype}_{'fused' if fused else 'plain'}"
            wlogdir = os.path.join(tmp, f"wide_{label}")
            wargv = ["--data_dir", corpus, "--wavenet_params", wfile,
                     "--logdir", wlogdir, "--batch_size", str(TRAIN_BATCH),
                     "--sample_size", str(TRAIN_SAMPLES),
                     "--checkpoint_every", str(WIDE_STEPS_PER_DISPATCH),
                     "--steps_per_dispatch", str(WIDE_STEPS_PER_DISPATCH),
                     "--compute_dtype", dtype, "--seed", "0",
                     "--device", "cuda"] + (["--use_pallas_stack"]
                                            if fused else [])
            fs.forward.launches_by.clear()             # this run's path
            fs.backward.launches_by.clear()
            t0 = time.perf_counter()
            out = run_cli(wargv + ["--num_steps", str(WIDE_STEPS)])
            wseconds = time.perf_counter() - t0
            by = {"fwd": dict(fs.forward.launches_by),
                  "bwd": dict(fs.backward.launches_by)}
            key = "mma" if dtype == "float32" else "mma_bf16"
            want = {key: WIDE_STEPS} if fused else {}
            check(all(v == want for v in by.values()),
                  f"the wide {label} train CLI ran the stack kernels {by}, "
                  f"not {want}")
            wlosses = [float(ln.split("loss = ")[1].split(",")[0])
                       for ln in out.splitlines() if ln.startswith("step ")]
            check(len(wlosses) == WIDE_STEPS
                  and all(x == x and abs(x) != float("inf") for x in wlosses)
                  and wlosses[-1] < wlosses[0],
                  f"wide {label} train CLI losses {wlosses}: not "
                  f"{WIDE_STEPS} finite, falling values")
            check(os.path.isdir(os.path.join(wlogdir, f"ckpt-{WIDE_STEPS}")),
                  f"wide {label}: no ckpt-{WIDE_STEPS}")
            with open(os.path.join(wlogdir, "metrics.jsonl")) as f:
                wsec = [r["value"] for r in map(json.loads, f)
                        if r["tag"] == "sec_per_step"][-1]
            row = {"phase": "train_cli_wide", "config": "wide",
                   "compute_dtype": dtype, "use_pallas_stack": fused,
                   "batch": TRAIN_BATCH, "sample_size": TRAIN_SAMPLES,
                   "steps": WIDE_STEPS, "losses": wlosses,
                   "seconds": wseconds, "sec_per_step_last": wsec,
                   "audio_sec_per_s": TRAIN_BATCH * (wide.receptive_field
                                                     + TRAIN_SAMPLES)
                   / wide.sample_rate / wsec,
                   "stack_launches_by": by, "gpu": gpu}
            if fused:
                wide_by[dtype] = by
            if fused and dtype == "float32":   # the resume, counted apart
                fs.forward.launches_by.clear()
                fs.backward.launches_by.clear()
                out = run_cli(wargv + ["--num_steps", str(WIDE_STEPS + 1)])
                check(f"Restored model from step {WIDE_STEPS}" in out
                      and f"step {WIDE_STEPS + 1} - loss = " in out,
                      "the wide rerun did not restore and train")
                check(fs.forward.launches_by == {"mma": 1}
                      and fs.backward.launches_by == {"mma": 1},
                      "the wide resume's stack launches: "
                      f"{dict(fs.forward.launches_by)}, "
                      f"{dict(fs.backward.launches_by)}")
                row["resumed_to"] = WIDE_STEPS + 1
            emit(row)
    w128_by = phase_train_cli_w128(wide, corpus, tmp, gpu)
    return ({"main": launches_by, "narrow": narrow_by, "bf16": bf16_by,
             "narrow_bf16": narrow_bf16_by,
             "wide": wide_by["float32"], "wide_bf16": wide_by["bfloat16"],
             "w128": w128_by["w128"], "w128_d64": w128_by["w128_d64"],
             "w48_d128": w128_by["w48_d128"]},
            os.path.join(logdir, f"ckpt-{RESUME_STEPS}"), pfile)


def tiled_stack_check(name, c32, B, samples, rng, gpu):
    """TPU kernel 5 on ``csrc/fused_stack_tiled.cu`` at the ``name``
    config ``c32`` (float32; the kernel the route takes there), at the
    train CLI's shape B x (receptive field + ``samples`` - 1): in each
    mode, forward and backward against the plain versions (f32 within the
    tolerances of phase 5, each gradient's layer or row slice within
    SLICE_RTOL; bf16 each forward layer on its own input, then the whole
    on the scale of bf16's distance from the plain float32 versions),
    bitwise-equal repeats, timed in turns (f32, bf16, bf16, f32) beside the
    bounds at the 3xTF32 and the bf16 peak, the plain versions' times and
    the device ms of a call by kernel; one ``stack_tiled`` row. Returns
    {(mode, kind): the kernels line's numbers}."""
    import dataclasses
    import numpy as np
    import torch
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.utils.flops import (H100_BF16_FLOPS,
                                           H100_TF32X3_FLOPS, bound_ms,
                                           fused_stack_cost)

    c16 = dataclasses.replace(c32, compute_dtype="bfloat16")
    cfg = {"f32": c32, "bf16": c16}
    peak = {"f32": H100_TF32X3_FLOPS, "bf16": H100_BF16_FLOPS}
    L = c32.num_layers
    R, D = c32.residual_channels, c32.dilation_channels
    check(all(fs.stack_kernel_plan(c) == "tiled" for c in cfg.values()),
          f"the route does not send {name} (R = {R}, D = {D}) to "
          "fused_stack_tiled")
    args = stack_inputs(c32, seeded_params(c32, 5, "cuda"), rng, B, samples)
    T = args[0].shape[1]
    w_fg, wd, _, bd = args[1:]
    dy = torch.as_tensor(rng.randn(B, T, R).astype("float32"), device="cuda")
    # dz in bf16's values, so that the float32 gradients are the bf16
    # gradients' yardstick on the same cotangent.
    dz = randn_cuda(rng, B, T, L * D).to(torch.bfloat16)
    dz32 = dz.float()
    row = {"phase": "stack_tiled", "config": name, "batch": B,
           "positions": T, "layers": L, "residual_channels": R,
           "dilation_channels": D, "gpu": gpu}
    out32 = fs.fused_stack_forward_reference(*args, c32)
    g32 = fs.fused_stack_backward_reference(out32[0], dy, out32[1], dz32,
                                            w_fg, wd, bd, c32)
    worst = {}
    out_k = [fs.forward(*args, c32) for _ in range(2)]
    torch.cuda.synchronize()
    worst[("f32", "fwd")] = max(
        hold(row, f"{n}_f32", a, b, FWD_RTOL, FWD_ATOL)
        for n, a, b in zip(("y", "fg", "z"), out_k[0], out32))
    check(all(torch.equal(a, b) for a, b in zip(*out_k)),
          f"{name} f32: two forward calls on the same inputs differ")
    del out_k
    g_k = [fs.backward(out32[0], dy, out32[1], dz32, w_fg, wd, bd, c32)
           for _ in range(2)]
    torch.cuda.synchronize()
    worst[("f32", "bwd")] = max(
        hold(row, f"{n}_f32", a, b, GRAD_RTOL, GRAD_ATOL, lead)
        for n, a, b, lead in zip(GRAD_NAMES, g_k[0], g32, GRAD_LEADS))
    check(all(torch.equal(a, b) for a, b in zip(*g_k)),
          f"{name} f32: two backward calls on the same inputs differ")
    del g_k
    torch.cuda.empty_cache()

    out16 = fs.fused_stack_forward_reference(*args, c16)
    out_k = [fs.forward(*args, c16) for _ in range(2)]
    torch.cuda.synchronize()
    check(out_k[0][1].dtype == out_k[0][2].dtype == torch.bfloat16,
          "the tiled bf16 mode's records are not bf16")
    teacher_forced_bf16(row, c16, args, *out_k[0])
    worst[("bf16", "fwd")] = max(
        hold_bf16(row, n, a, b, r) for n, a, b, r in
        zip(("y", "fg", "z"), out_k[0], out16, out32))
    check(all(torch.equal(a, b) for a, b in zip(*out_k)),
          f"{name} bf16: two forward calls on the same inputs differ")
    del out_k
    y16, fg16 = out16[0], out16[1]
    g16 = fs.fused_stack_backward_reference(y16, dy, fg16, dz, w_fg, wd, bd,
                                            c16)
    g_k = [fs.backward(y16, dy, fg16, dz, w_fg, wd, bd, c16)
           for _ in range(2)]
    torch.cuda.synchronize()
    worst[("bf16", "bwd")] = max(
        hold_bf16(row, n, a, b, r) for n, a, b, r in
        zip(GRAD_NAMES, g_k[0], g16, g32))
    check(all(torch.equal(a, b) for a, b in zip(*g_k)),
          f"{name} bf16: two backward calls on the same inputs differ")
    row["bitwise_repeat"] = True
    del g_k, g16, g32, out16
    torch.cuda.empty_cache()

    y32, fg32 = out32[0], out32[1]
    calls = {
        "fwd": lambda m: fs.forward(*args, cfg[m]),
        "bwd": lambda m: (fs.backward(y32, dy, fg32, dz32, w_fg, wd, bd,
                                      c32) if m == "f32" else
                          fs.backward(y16, dy, fg16, dz, w_fg, wd, bd, c16)),
    }
    plain = {
        "fwd": lambda m: fs.fused_stack_forward_reference(*args, cfg[m]),
        "bwd": lambda m: (fs.fused_stack_backward_reference(
            y32, dy, fg32, dz32, w_fg, wd, bd, c32) if m == "f32" else
            fs.fused_stack_backward_reference(y16, dy, fg16, dz, w_fg, wd,
                                              bd, c16)),
    }
    modes = ("f32", "bf16")
    results = {}
    for kind in ("fwd", "bwd"):
        ms = {m: [] for m in modes}
        for _ in range(STACK_TIMED_ROUNDS):
            for m in modes + modes[::-1]:
                ms[m].append(cuda_ms(lambda: calls[kind](m)))
        for m in modes:
            flops, nbytes = fused_stack_cost(cfg[m], B, T,
                                             backward=kind == "bwd")
            bound, by = bound_ms(flops, nbytes, peak[m])
            t = float(np.median(ms[m]))
            ms_p = median_cuda_ms(lambda: plain[kind](m), reps=3)
            trace = device_breakdown(lambda: calls[kind](m))
            row.update({
                f"{kind}_ms_{m}": t, f"{kind}_plain_ms_{m}": ms_p,
                f"{kind}_flops": flops, f"{kind}_bytes_{m}": nbytes,
                f"{kind}_bound_ms_{m}": bound, f"{kind}_bound_by_{m}": by,
                f"{kind}_share_of_bound_{m}": bound / t,
                f"{kind}_device_ms_by_kernel_{m}":
                    trace["by_kernel"] if trace else
                    "not measured (no device events)"})
            results[(m, kind)] = dict(
                config=name, batch=B, positions=T, residual_channels=R,
                dilation_channels=D, max_abs_err=worst[(m, kind)], ms=t,
                plain_ms=ms_p, bound_ms=bound, bound_by=by)
    emit(row)
    del args, dy, dz, dz32, out32, y32, fg32, y16, fg16
    torch.cuda.empty_cache()
    return results


def tiled_train_cli(name, c32, B, samples, steps, speakers, gpu):
    """The main path of the tiled stack: the train CLI on a written
    ``<name>_params.json`` with ``--use_pallas_stack``, ``steps`` steps at
    float32 and at bfloat16 (B x ``samples``, a synthesised corpus of
    ``speakers``), finite losses, every stack call on the tiled kernel's
    mode (counted from 0 in each run). One step a dispatch, so that each
    step has its own time (the CLI's default dispatch of 4 steps would
    time them together, the first step's warm-up included): the rate is
    the median of the steps between the first, which warms up, and the
    last, whose time only waits out work already queued. Returns {mode:
    launches_by}."""
    import dataclasses
    import numpy as np
    from wavenet_torch.kernels import fused_stack as fs
    tmp = tempfile.mkdtemp(prefix=f"wavenet_torch_{name}_")
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    synth_corpus(corpus, speakers=speakers)
    pfile = os.path.join(tmp, f"{name}_params.json")
    with open(pfile, "w") as f:
        json.dump(c32.to_json_dict(), f)
    launches = {}
    for m, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        logdir = os.path.join(tmp, f"logdir_{m}")
        fs.forward.launches_by.clear()
        fs.backward.launches_by.clear()
        t0 = time.perf_counter()
        out = run_cli(["--data_dir", corpus, "--wavenet_params", pfile,
                       "--logdir", logdir, "--use_pallas_stack",
                       "--batch_size", str(B), "--sample_size", str(samples),
                       "--num_steps", str(steps),
                       "--steps_per_dispatch", "1",
                       "--checkpoint_every", str(steps),
                       "--compute_dtype", dtype, "--seed", "0",
                       "--device", "cuda"])
        seconds = time.perf_counter() - t0
        by = {"fwd": dict(fs.forward.launches_by),
              "bwd": dict(fs.backward.launches_by)}
        key = fs.launch_key(
            "tiled", dataclasses.replace(c32, compute_dtype=dtype))
        want = {key: steps}
        check(all(v == want for v in by.values()),
              f"the {name} {dtype} train CLI ran the stack kernels {by}, "
              f"not {want}")
        losses = [float(ln.split("loss = ")[1].split(",")[0])
                  for ln in out.splitlines() if ln.startswith("step ")]
        check(len(losses) == steps
              and all(x == x and abs(x) != float("inf") for x in losses),
              f"{name} {dtype} train CLI losses {losses}: not {steps} "
              "finite values")
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            secs = [r["value"] for r in map(json.loads, f)
                    if r["tag"] == "sec_per_step"]
        sec = float(np.median(secs[1:-1]))
        launches[m] = by
        emit({"phase": f"train_cli_{name}", "config": name,
              "residual_channels": c32.residual_channels,
              "dilation_channels": c32.dilation_channels,
              "compute_dtype": dtype, "batch": B, "sample_size": samples,
              "steps": steps, "losses": losses, "seconds": seconds,
              "sec_per_step": secs, "sec_per_step_median": sec,
              "audio_sec_per_s": B * (c32.receptive_field + samples)
              / c32.sample_rate / sec,
              "stack_launches_by": by, "gpu": gpu})
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_stack_tiled(rng, gpu):
    """Phase 5t: the sharded config's stack (80 layers, R = D = 256) on
    ``fused_stack_tiled`` at the train CLI's shape b1 x (receptive field +
    16,000 - 1), then that train CLI, 4 steps a dtype. Returns
    ({(mode, kind): the kernels line's numbers}, {mode: launches_by})."""
    from wavenet_torch.models.config import sharded_config
    c32 = sharded_config()
    results = tiled_stack_check("sharded", c32, TILED_BATCH, TILED_SAMPLES,
                                rng, gpu)
    launches = tiled_train_cli("sharded", c32, TILED_BATCH, TILED_SAMPLES,
                               TILED_STEPS, TILED_SPEAKERS, gpu)
    return results, launches


def phase_stack_ragged(wide, rng, gpu):
    """Phase 5r: TPU kernel 5 at R != D on ``fused_stack_tiled`` (ragged
    edges: widths the route takes there), at the wide config's depth and
    length (30 layers, S = 1024, scalar input) and the train shape b8 x
    (receptive field + 16,000 - 1), at each of RAGGED_WIDTHS: the checks
    and times of ``tiled_stack_check``; then the train CLI at the first
    of them, 4 steps a dtype. Returns ({(R, D, mode, kind): the kernels
    line's numbers}, {mode: launches_by})."""
    import dataclasses
    results = {}
    for R, D in RAGGED_WIDTHS:
        c = dataclasses.replace(wide, residual_channels=R,
                                dilation_channels=D)
        for (m, kind), v in tiled_stack_check(
                f"wide_r{R}_d{D}", c, TRAIN_BATCH, TRAIN_SAMPLES, rng,
                gpu).items():
            results[(R, D, m, kind)] = v
    R, D = RAGGED_WIDTHS[0]
    c = dataclasses.replace(wide, residual_channels=R, dilation_channels=D)
    launches = tiled_train_cli(f"wide_r{R}_d{D}", c, TRAIN_BATCH,
                               TRAIN_SAMPLES, RAGGED_STEPS, RAGGED_SPEAKERS,
                               gpu)
    return results, launches


def phase_train_cli_w128(wide, corpus, tmp, gpu):
    """The wide config at R = D = 128, at R = 128, D = 64 (R != D in whole
    tiles) and at R = 48, D = 128 (ragged tiles, every edge checked)
    trains one step each on fused_stack_tiled (counted from 0). Returns
    {label: launches_by}."""
    import dataclasses
    from wavenet_torch.kernels import fused_stack as fs
    runs = {}
    for R, D in ((128, 128), (128, 64), (48, 128)):
        label = f"w{R}" if R == D else f"w{R}_d{D}"
        bfile = os.path.join(tmp, f"{label}_params.json")
        with open(bfile, "w") as f:
            json.dump(dataclasses.replace(wide, residual_channels=R,
                                          dilation_channels=D)
                      .to_json_dict(), f)
        fs.forward.launches_by.clear()
        fs.backward.launches_by.clear()
        out = run_cli(["--data_dir", corpus, "--wavenet_params", bfile,
                       "--logdir", os.path.join(tmp, label),
                       "--batch_size", "1", "--sample_size", "4000",
                       "--num_steps", "1", "--use_pallas_stack", "--seed",
                       "0", "--device", "cuda"])
        by = {"fwd": dict(fs.forward.launches_by),
              "bwd": dict(fs.backward.launches_by)}
        check(all(v == {"tiled": 1} for v in by.values())
              and "step 1 - loss = " in out,
              f"the train CLI at R = {R}, D = {D} ran the stack kernels "
              f"{by}, not one tiled launch each way")
        emit({"phase": "train_cli_w128", "residual_channels": R,
              "dilation_channels": D, "stack_launches_by": by, "gpu": gpu})
        runs[label] = by
    return runs


def phase_sharded_generation(gpu):
    """Phase 5r's generation at the sharded config (80 layers, R = D =
    256), where the JAX ladder's TPU VMEM budget offers no Pallas rung and
    the port's route (``decode_route``, from the card's opt-in shared
    memory) runs ``sampler_decode`` at every batch: the generate CLI (b1 x
    SHARDED_GEN_SAMPLES) on that route, its decode launches counted from
    0; at full depth ``sampler_decode`` against ``decode_reference``
    teacher-forced for SHARDED_HOLD_STEPS steps at each of
    SHARDED_HOLD_BATCHES in both weight modes (float32 at the decode
    tolerances, bf16 one step a launch by ``bf16_hold``); and the step
    time of each route at SHARDED_TIMED_BATCHES over SHARDED_TIMED_STEPS
    steps from a prefilled state, behind a spin: ``sampler_decode`` (one
    launch) against the scan sampler (``sample.generate_codes``). Returns
    the kernels line's numbers."""
    import numpy as np
    import torch
    from wavenet_torch import sample as tsample
    from wavenet_torch.kernels import bf16_hold
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.config import sharded_config
    from wavenet_torch.sampler_select import sampler_attempts

    t0 = time.perf_counter()
    c = sharded_config()
    route = {B: ks.device_decode_route(c, B)
             for B in SHARDED_HOLD_BATCHES + SHARDED_TIMED_BATCHES}
    check(set(route.values()) == {"decode"} and sampler_attempts(c),
          f"the sharded config's decode route is {route}, not "
          "sampler_decode")
    tmp = tempfile.mkdtemp(prefix="wavenet_torch_sharded_gen_")
    params = seeded_params(c, 9, "cpu")
    root = os.path.join(tmp, "ckpt")
    pfile = write_checkpoint(root, c, params)
    ks.decode.launches = ks.decode_sequential.launches = 0  # this path
    ks.decode.launches_by.clear()
    wav = os.path.join(tmp, "sharded.wav")
    out, seconds = run_generate_cli(
        [root, "--wavenet_params", pfile, "--samples",
         str(SHARDED_GEN_SAMPLES), "--wav_out_path", wav, "--seed", "1",
         "--device", "cuda"])
    check("Using CUDA (prefill + " in out and "Finished generating." in out,
          "the sharded generate CLI did not run a decode kernel")
    read_wavs(wav, 1, SHARDED_GEN_SAMPLES)
    launched = (ks.decode.launches, ks.decode_sequential.launches,
                dict(ks.decode.launches_by))
    check(launched == (1, 0, {"decode": 1}),
          f"sharded generation launched {launched}, not sampler_decode once")
    row = {"phase": "sharded_generation", "sampler": "sampler_decode",
           "samples": SHARDED_GEN_SAMPLES, "cli_seconds": seconds,
           "cli_samples_per_s": SHARDED_GEN_SAMPLES / seconds,
           "decode_launches_by": launched[2], "gpu": gpu}
    shutil.rmtree(tmp, ignore_errors=True)
    row["seconds_cli"] = time.perf_counter() - t0

    params = {k: v.to("cuda") for k, v in params.items()}
    rng = np.random.RandomState(21)
    err = 0.0
    for B in SHARDED_HOLD_BATCHES:
        codes, _ = setup(c, B, rng, 70, SHARDED_HOLD_STEPS)
        carry = ks.prefill_carry(params, c, codes[:, :70], None)
        pk32 = ks.pack_sampler_weights(params, c, B, None)
        pk16 = ks.pack_sampler_weights(params, c, B, None,
                                       weight_dtype=torch.bfloat16)
        forced = codes[:, 69:69 + SHARDED_HOLD_STEPS].contiguous()
        n = forced.shape[1]
        rk, ck = carry.ring.clone(), carry.causal.clone()
        rr, cr = carry.ring.clone(), carry.causal.clone()
        _, lk = ks.decode(pk32, c, rk, ck, forced, n, carry.t_abs, 3,
                          collect_logits=True, kernel="decode")
        _, lr = ks.decode_reference(pk32, c, rr, cr, forced, n,
                                    carry.t_abs, 3, collect_logits=True)
        torch.cuda.synchronize()
        for label, a, b in (("logits", lk, lr), ("ring", rk, rr)):
            e = (a - b).abs().max().item()
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                  f"sharded b{B} sampler_decode {label}: {e} from "
                  "decode_reference")
            row[f"max_abs_err_{label}_b{B}"] = e
            err = max(err, e)

        def step(ring, causal, x, t):
            return ks.decode(pk16, c, ring, causal, x, 1, t, 3,
                             collect_logits=True, kernel="decode")[1]

        rc = ks.chain_rounded("decode", B)
        ring, causal = carry.ring.clone(), carry.causal.clone()
        got = bf16_hold.stepwise(c, pk16, pk32, ring, causal, forced,
                                 carry.t_abs, 3, rc, step)
        torch.cuda.synchronize()
        if not rc:      # b1: the chain float32, the tight rule
            row[f"bf16_b{B}"] = bf16_hold.hold(f"sharded bf16 b{B}",
                                               *got[:3])
            bf16_hold.hold(f"sharded bf16 b{B} ring", *got[3:])
        else:
            # 80 rounded layers: held as far as the plain version lies
            # from itself summed on the CPU (bf16_hold's docstring).
            ring, causal = carry.ring.clone(), carry.causal.clone()
            cpu = bf16_hold.stepwise(c, pk16, pk32, ring, causal, forced,
                                     carry.t_abs, 3, rc,
                                     bf16_hold.cpu_launch(c, pk16, 3, rc))
            for i, what in ((0, ""), (3, " ring")):
                kern = bf16_hold.ratios(*got[i:i + 3])
                plain = bf16_hold.ratios(*cpu[i:i + 3])
                limits = bf16_hold.hold_as_plain(
                    f"sharded bf16 b{B}{what}", kern, plain)
                row[f"bf16_b{B}{what.replace(' ', '_')}"] = {
                    "kernel": kern, "plain_cpu": plain, "limits": limits}
            del cpu
        del carry, pk32, pk16, rk, rr, ring, got
    torch.cuda.empty_cache()
    row["seconds_held"] = time.perf_counter() - t0 - row["seconds_cli"]

    # Each route's step, behind a spin that lets the host queue its work.
    n = SHARDED_TIMED_STEPS
    times = {}
    for B in SHARDED_TIMED_BATCHES:
        codes, _ = setup(c, B, rng, 70, n)
        carry = ks.prefill_carry(params, c, codes[:, :70], None)
        pk = ks.pack_sampler_weights(params, c, B, None)
        first = codes[:, 69:70].contiguous()
        x0 = tsample._featurize(codes[:, 69], c)
        for name in ("decode", "scan", "decode"):
            if name == "decode":
                ring, causal = carry.ring.clone(), carry.causal.clone()
                fn = (lambda: ks.decode(pk, c, ring, causal, first, n,
                                        carry.t_abs, 3, kernel="decode"))
            else:
                st = tsample.prefill_state(params, c, codes[:, :69])
                key = torch.Generator(device="cuda").manual_seed(3)
                fn = (lambda: tsample.generate_codes(
                    params, c, st, x0, n, key))
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            times.setdefault((name, B), []).append(cuda_ms_unsynced(fn) / n)
        del carry, pk, ring, causal, st
        torch.cuda.empty_cache()
    for (name, B), v in times.items():
        row[f"{name}_ms_per_step_b{B}"] = float(np.mean(v))
    for B in SHARDED_TIMED_BATCHES:
        row[f"decode_speedup_over_scan_b{B}"] = (
            row[f"scan_ms_per_step_b{B}"] / row[f"decode_ms_per_step_b{B}"])
    bound, by = bound_per_step(c, 1, n)
    row.update({"seconds": time.perf_counter() - t0,
                "bound_ms_per_step_b1": bound, "bound_by_b1": by,
                "weight_stream_bound_ms_per_step":
                    weight_stream_bound_per_step(c, 1)[0]})
    emit(row)
    return dict(launches=launched[2]["decode"], max_abs_err=err,
                ms=row["decode_ms_per_step_b1"],
                plain_ms=row["scan_ms_per_step_b1"], bound_ms=bound,
                bound_by=by, ms_b64=row["decode_ms_per_step_b64"],
                scan_ms_b64=row["scan_ms_per_step_b64"])


def cuda_ms_unsynced(fn) -> float:
    """CUDA-event ms of ``fn`` queued now, without a synchronize first
    (so that work queued behind a spin is timed from the spin's end)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_lc_train(gpu):
    """Phase 5's LC training check: ``python -m wavenet_torch.cli.train
    --lc_channels 80 --lc_hop 200`` (in this process) at the paper config,
    b8 x 16,000, on a synthesised corpus with log-mel sidecars
    (``wavenet_torch.features``), LC_TRAIN_STEPS steps each: the frame
    windows upsampled on the card (the default), ``--lc_host_upsample``,
    and ``--use_pallas_stack``. Losses finite and falling, the first step's
    equal across the runs within 1e-5 (the same batches; the two upsamples
    give the same stream), and no stack kernel launched: LC takes the
    plain route, as in JAX."""
    from wavenet_torch.features import write_sidecars
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.models.config import paper_config

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_lc_train_")
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    synth_corpus(corpus, speakers=LC_TRAIN_SPEAKERS)
    write_sidecars(corpus, 16000, LC_CHANNELS, LC_HOP, log=lambda _: None)
    pfile = os.path.join(tmp, "wavenet_params.json")
    with open(pfile, "w") as f:
        json.dump(dict(paper_config().to_json_dict(), sample_rate=16000), f)
    argv = ["--data_dir", corpus, "--wavenet_params", pfile,
            "--lc_channels", str(LC_CHANNELS), "--lc_hop", str(LC_HOP),
            "--batch_size", str(TRAIN_BATCH), "--sample_size",
            str(TRAIN_SAMPLES), "--num_steps", str(LC_TRAIN_STEPS),
            "--checkpoint_every", str(LC_TRAIN_STEPS), "--seed", "0",
            "--device", "cuda"]
    first = {}
    for label, extra in (("device_upsample", []),
                         ("host_upsample", ["--lc_host_upsample"]),
                         ("use_pallas_stack", ["--use_pallas_stack"])):
        fs.forward.launches = fs.backward.launches = 0
        fs.forward.launches_by.clear()
        fs.backward.launches_by.clear()
        logdir = os.path.join(tmp, label)
        t0 = time.perf_counter()
        out = run_cli(argv + ["--logdir", logdir] + extra)
        seconds = time.perf_counter() - t0
        losses = [float(ln.split("loss = ")[1].split(",")[0])
                  for ln in out.splitlines() if ln.startswith("step ")]
        check(len(losses) == LC_TRAIN_STEPS
              and all(x == x and abs(x) != float("inf") for x in losses)
              and losses[-1] < losses[0],
              f"LC train CLI ({label}) losses {losses}: not "
              f"{LC_TRAIN_STEPS} finite, falling values")
        stack = (fs.forward.launches, fs.backward.launches)
        check(stack == (0, 0), f"LC train CLI ({label}) launched the stack "
              f"kernels {stack}: LC takes the plain route")
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            sec = [r["value"] for r in map(json.loads, f)
                   if r["tag"] == "sec_per_step"][-1]
        first[label] = losses[0]
        emit({"phase": "train_cli_lc", "run": label, "config": "paper_lc",
              "lc_channels": LC_CHANNELS, "lc_hop": LC_HOP,
              "batch": TRAIN_BATCH, "sample_size": TRAIN_SAMPLES,
              "losses": losses, "seconds": seconds, "sec_per_step_last": sec,
              "stack_launches": list(stack), "gpu": gpu})
    spread = max(first.values()) - min(first.values())
    check(spread <= 1e-5, f"LC train CLI first-step losses {first} differ "
          "by more than 1e-5")
    emit({"phase": "train_cli_lc", "first_step_losses": first,
          "spread": spread, "gpu": gpu})


def seq_prefix(c, B: int, rng):
    """A receptive field of random inputs: codes, or amplitudes in scalar
    mode."""
    import torch
    if c.scalar_input:
        x = rng.uniform(-0.9, 0.9, (B, c.receptive_field)).astype("float32")
        return torch.as_tensor(x, device="cuda")
    return torch.as_tensor(rng.randint(0, c.quantization_channels,
                                       (B, c.receptive_field)),
                           dtype=torch.int32, device="cuda")


def replay_inputs(c, first, codes_k):
    """``first`` [B, n] forced inputs, then the inputs a kernel run fed
    itself from its sampled ``codes_k`` (decoded in scalar mode)."""
    import torch
    from wavenet_torch.kernels import sampler as ks
    sampled = codes_k[:, first.shape[1] - 1:-1]
    nxt = (ks.decode_amp(sampled, c.quantization_channels)
           if c.scalar_input else sampled)
    return torch.cat([first, nxt.to(first.dtype)], dim=1).contiguous()


def sampled_codes_match(c, lg_r, codes_k, seed: int, step0: int, n: int):
    """The kernel's last ``n`` sampled codes against the argmax of the
    plain version's logits plus the same Philox noise: (match rate,
    mismatches, largest top-2 margin at a mismatch)."""
    from wavenet_torch.kernels import sampler as ks
    B = codes_k.shape[0]
    noise = ks.gumbel_noise(seed, B, step0, n, c.quantization_channels,
                            "cuda")
    scores = lg_r[:, -n:] + noise.transpose(0, 1)
    top2 = scores.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    match = scores.argmax(dim=-1).to(codes_k.dtype) == codes_k[:, -n:]
    worst = margin[~match].max().item() if (~match).any() else 0.0
    rate = match.float().mean().item()
    check(rate >= 0.999, f"only {rate:.5f} of sampled codes match")
    check(worst < 1e-4, f"a mismatch sits at a top-2 margin of {worst}")
    return rate, int((~match).sum().item()), worst


def phase_sequential(cfgs, params, rng, gpu):
    """Kernel 4's route on each decode kernel, pinned, against the plain
    version at a batch (b64; the cluster kernel at the largest of b64, b32
    and b16 that its plan routes) and b1 against row 0, replaying the kernel's
    inputs; times the plain replay. Results by (kernel, config, batch)."""
    import torch
    from wavenet_torch.kernels import sampler as ks

    results = {}
    for name in ("paper", "wide"):
        c, p = cfgs[name], params[name]
        seed = 21
        prefix64 = seq_prefix(c, 64, rng)
        n_forced = prefix64.shape[1]
        n_total = n_forced - 1 + SEQ_SAMPLES
        pk1 = ks.pack_sampler_weights(p, c, 1)
        cluster_b = next((b for b in (64, 32, 16) if ks.device_plan(c, b)),
                         None)
        for kernel, B in (("decode", 64), ("cluster", cluster_b)):
            if B is None:
                continue
            where = f"{DECODE_SOURCES[kernel]} {name}"
            prefix = prefix64[:B].contiguous()
            pkb = ks.pack_sampler_weights(p, c, B)
            codesb, lgb = ks.decode_sequential(pkb, c, prefix, n_total, seed,
                                               collect_logits=True,
                                               kernel=kernel)
            again, win = ks.decode_sequential(pkb, c, prefix, n_total, seed,
                                              collect_logits=SEQ_WINDOW,
                                              kernel=kernel)
            codes1, lg1 = ks.decode_sequential(pk1, c, prefix[:1].contiguous(),
                                               n_total, seed,
                                               collect_logits=True,
                                               kernel=kernel)
            forced = replay_inputs(c, prefix, codesb)
            ring, causal = ks.zero_state(c, B, "cuda")
            out = []
            plain_ms = cuda_ms(lambda: out.append(ks.decode_reference(
                pkb, c, ring, causal, forced, n_total, 0, seed,
                collect_logits=True))) / n_total
            codes_r, lg_r = out[0]
            # The plain version at b1, over the first steps of the inputs.
            ring1, causal1 = ks.zero_state(c, 1, "cuda")
            plain_ms1 = cuda_ms(lambda: ks.decode_reference(
                pk1, c, ring1, causal1, forced[:1].contiguous(), 64, 0,
                seed)) / 64
            torch.cuda.synchronize()
            check(torch.isfinite(lgb).all().item(),
                  f"{where}: non-finite logits")
            errb = (lgb - lg_r).abs().max().item()
            err1 = (lg1 - lg_r[:1]).abs().max().item()
            check(torch.allclose(lgb, lg_r, rtol=1e-4, atol=1e-4),
                  f"{where} b{B}: sequential logits differ from the plain "
                  f"version (max |d| {errb})")
            check(torch.allclose(lg1, lg_r[:1], rtol=1e-4, atol=1e-4),
                  f"{where} b1: sequential logits differ (max |d| {err1})")
            check(torch.equal(codesb, again), f"{where}: same-seed runs differ")
            check(torch.equal(win, lgb[:, -SEQ_WINDOW:]),
                  f"{where}: the logits window is not the tail of the run")
            check(torch.equal(codes1, codesb[:1]),
                  f"{where}: b1 codes differ from row 0 of b{B}")
            check(torch.equal(codesb[:, :-1], codes_r[:, :-1]),
                  f"{where}: emitted codes differ from the plain replay")
            rate, bad, worst = sampled_codes_match(c, lg_r, codesb, seed,
                                                   n_forced - 1, SEQ_SAMPLES)
            emit({"phase": "sequential", "kernel": DECODE_SOURCES[kernel],
                  "config": name, "batch": B, "forced": n_forced,
                  "steps": n_total, "max_abs_err_batch": errb,
                  "max_abs_err_b1": err1, "sampled_match_rate": rate,
                  "mismatches": bad, "max_mismatch_margin": worst,
                  "bitwise_repeat": True, "b1_equals_row0": True,
                  "window": SEQ_WINDOW, "plain_ms_per_step": plain_ms,
                  "plain_ms_per_step_b1": plain_ms1, "gpu": gpu})
            for b, err, ms in ((1, err1, plain_ms1), (B, errb, plain_ms)):
                results[(kernel, name, b)] = dict(max_abs_err=err,
                                                  plain_ms=ms)
            del lgb, lg1, lg_r, win
            torch.cuda.empty_cache()
    return results


def phase_wide_prefill(c, params, rng, gpu):
    """The wide config through the prefill route: prefill a receptive
    field of amplitudes, decode 256 sampled steps, replay on the plain
    version; then time a decode step at b1 and b64."""
    import torch
    from wavenet_torch.kernels import sampler as ks

    B, seed = 64, 23
    carry = ks.prefill_carry(params, c, seq_prefix(c, B, rng))
    pk = ks.pack_sampler_weights(params, c, B)
    first = carry.last[:, None].contiguous()
    rk, ck = carry.ring.clone(), carry.causal.clone()
    codes_k, lg_k = ks.decode(pk, c, rk, ck, first, SEQ_SAMPLES, carry.t_abs,
                              seed, collect_logits=True)
    rr, cr = carry.ring.clone(), carry.causal.clone()
    t = time.perf_counter()
    codes_r, lg_r = ks.decode_reference(pk, c, rr, cr,
                                        replay_inputs(c, first, codes_k),
                                        SEQ_SAMPLES, carry.t_abs, seed,
                                        collect_logits=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t) / SEQ_SAMPLES
    err = (lg_k - lg_r).abs().max().item()
    check(torch.allclose(lg_k, lg_r, rtol=1e-4, atol=1e-4),
          f"wide prefill route: logits differ (max |d| {err})")
    check(torch.allclose(rk, rr, rtol=1e-4, atol=1e-4),
          "wide prefill route: ring state differs")
    check(torch.allclose(ck, cr, rtol=0, atol=1e-6),
          "wide prefill route: causal register differs")
    rate, bad, worst = sampled_codes_match(c, lg_r, codes_k, seed,
                                           carry.t_abs, SEQ_SAMPLES)
    row = {"phase": "wide_prefill", "batch": B, "prefill": c.receptive_field,
           "steps": SEQ_SAMPLES, "max_abs_err": err,
           "sampled_match_rate": rate, "mismatches": bad,
           "max_mismatch_margin": worst, "plain_ms_per_step": plain_ms}
    timed = {}
    cases = [(1, "decode"), (64, "decode")]
    routed = [b for b in range(1, B + 1) if ks.device_plan(c, b)]
    if routed:
        top = routed[-1]
        cases += [(1, "cluster"), (top, "cluster"), (top, "decode")]
        row["top_routed_batch"] = top
    for b, kernel in cases:
        pkb = pk._replace(layer_add=pk.layer_add[:, :b].contiguous())
        ring = carry.ring[:, :b].clone(memory_format=torch.contiguous_format)
        causal = carry.causal[:b].clone()
        fb = first[:b].contiguous()
        ms = median_cuda_ms(lambda: ks.decode(
            pkb, c, ring, causal, fb, SEQ_TIMED_SAMPLES, carry.t_abs, 5,
            kernel=kernel), reps=3) / SEQ_TIMED_SAMPLES
        bound, by = bound_per_step(c, b, SEQ_TIMED_SAMPLES)
        key = f"b{b}_{DECODE_SOURCES[kernel]}"
        row.update({f"ms_per_step_{key}": ms,
                    f"bound_ms_per_step_{key}": bound,
                    f"bound_by_{key}": by})
        timed[(kernel, "wide", b)] = dict(ms=ms, bound_ms=bound, bound_by=by)
    if routed:
        for b in sorted({1, top}):
            check_route_is_faster(timed, "wide", b, "cluster")
    row.update(next_amp_probe(c, params))
    row["gpu"] = gpu
    emit(row)
    return timed


def next_amp_probe(c, params, n: int = 2048):
    """One sampled step of ``n`` rows at a flat temperature: the kernel's
    own amplitude for each sampled code (``next_amp``, what a resumed
    segment starts from) against ``decode_amp`` recomputed on the card by
    PyTorch. Reported, not checked: the port resumes from the former."""
    import torch
    from wavenet_torch.kernels import sampler as ks
    pk = ks.pack_sampler_weights(params, c, n)
    ring, causal = ks.zero_state(c, n, "cuda")
    amp = torch.empty(n, device="cuda")
    codes, _ = ks.decode(pk, c, ring, causal, torch.zeros((n, 1),
                         device="cuda"), 1, 0, 29, temperature=1e3,
                         next_amp=amp)
    host = ks.decode_amp(codes[:, 0], c.quantization_channels)
    check(torch.isfinite(amp).all().item(), "next_amp: non-finite")
    differ = codes[:, 0][host != amp]
    return {"next_amp_codes_seen": len(torch.unique(codes)),
            "next_amp_codes_where_host_decode_differs":
                len(torch.unique(differ)),
            "next_amp_max_abs_diff": (host - amp).abs().max().item()}


def run_generate_cli(argv):
    """``wavenet_torch.cli.generate.main(argv)`` in this process:
    (output, wall seconds)."""
    from wavenet_torch.cli import generate as cli
    return tee_main(cli.main, argv)


def read_wavs(path: str, B: int, n: int):
    """The int16 samples of the CLI's wav (or its ``-<i>`` files)."""
    import numpy as np
    from scipy.io import wavfile
    root, ext = os.path.splitext(path)
    paths = [path] if B == 1 else [f"{root}-{i}{ext}" for i in range(B)]
    rows = []
    for p in paths:
        check(os.path.getsize(p) == 44 + 2 * n, f"{p}: wrong size")
        rows.append(wavfile.read(p)[1])
    x = np.stack(rows)
    check(len(np.unique(x)) > 8, f"{path}: degenerate audio")
    return x


def write_checkpoint(root: str, c, params) -> str:
    """A port checkpoint (``ckpt-0/``) and params JSON of ``params``."""
    from wavenet_torch import train_lib as tl
    tl.save_checkpoint(root, tl.train_state_from_params(
        params, tl.make_optimizer("adam", 1e-3)))
    pfile = os.path.join(root, "wavenet_params.json")
    with open(pfile, "w") as f:
        json.dump(c.to_json_dict(), f)
    return pfile


def phase_generate_cli(cfgs, params, gc_ckpt, gc_pfile, gpu):
    """The generate CLI: phase 5's gc checkpoint at b1 and b64, in
    segments, from a seed wav and on the slow path; seeded paper and
    wide checkpoints. Every fast run launches ``decode`` once per
    segment and ``decode_sequential`` never."""
    import numpy as np
    from wavenet_torch.audio import write_wav
    from wavenet_torch.kernels import sampler as ks

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_generate_")
    seed_wav = os.path.join(tmp, "seed.wav")
    t = np.arange(8000) / 16000.0
    write_wav(seed_wav, 0.5 * np.sin(2 * np.pi * 220.0 * t)
              + 0.1 * np.sin(2 * np.pi * 1500.0 * t), 16000)
    ckpts = {"gc": (gc_ckpt, gc_pfile,
                    ["--gc_channels", str(cfgs["gc"].gc_channels),
                     "--gc_cardinality", str(cfgs["gc"].gc_cardinality),
                     "--gc_id", "5"])}
    for name in ("paper", "wide"):
        root = os.path.join(tmp, name)
        ckpts[name] = (root, write_checkpoint(root, cfgs[name],
                                              params[name]), [])
    runs = [  # (label, model, batch, samples, extra flags, decode launches)
        ("b1", "gc", 1, GEN_SAMPLES, [], 1),
        ("b64", "gc", 64, GEN_SAMPLES, [], 1),
        ("b128", "gc", 128, 4000, [], 1),
        ("save_every", "gc", 1, GEN_SAMPLES, ["--save_every", "4000"], 4),
        ("wav_seed", "gc", 1, 4000, ["--wav_seed", seed_wav], 1),
        ("slow", "gc", 1, 36, ["--fast_generation", "false"], 0),
        ("paper_b1", "paper", 1, 4000, [], 1),
        ("wide_b1", "wide", 1, 4000, [], 1),
        ("wide_save_every", "wide", 1, 4000, ["--save_every", "1000"], 4),
        ("wide_b64", "wide", 64, 4000, [], 1),
    ]
    from wavenet_torch.data import native
    check(native.available() and os.path.exists(native.library_path()),
          "the native data library is not loaded")
    ks.decode.launches = ks.decode_sequential.launches = 0  # the main path
    ks.decode.launches_by.clear()
    wavs, rates = {}, {}
    for label, model, B, n, extra, want in runs:
        ckpt, pfile, gc_flags = ckpts[model]
        wav = os.path.join(tmp, f"{label}.wav")
        before = ks.decode.launches
        before_by = dict(ks.decode.launches_by)
        out, seconds = run_generate_cli(
            [ckpt, "--wavenet_params", pfile, "--samples", str(n),
             "--batch_size", str(B), "--wav_out_path", wav, "--seed", "1",
             "--device", "cuda"] + gc_flags + extra)
        check("Finished generating." in out, f"{label}: no finish line")
        wavs[label] = read_wavs(wav, B, n)
        delta = ks.decode.launches - before
        check(delta == want, f"{label}: {delta} decode launches, "
              f"expected {want}")
        rates[label] = B * n / seconds
        served = {DECODE_SOURCES[k]: v - before_by.get(k, 0)
                  for k, v in ks.decode.launches_by.items()
                  if v != before_by.get(k, 0)}
        emit({"phase": "generate_cli", "run": label, "config": model,
              "batch": B, "samples": n, "seconds": seconds,
              "samples_per_s": rates[label], "decode_launches": delta,
              "served_by": served, "gpu": gpu})
    for label in ("", "wide_"):
        check((wavs[f"{label}save_every"] == wavs[f"{label}b1"]).all(),
              f"{label}--save_every segments differ from the single run")
    check(ks.decode_sequential.launches == 0,
          "the CLI took the sequential route")
    launches = dict(ks.decode.launches_by)
    emit({"phase": "generate_cli", "decode_launches": ks.decode.launches,
          "decode_launches_by_kernel": {DECODE_SOURCES[k]: v
                                        for k, v in launches.items()},
          "native_decoder": native.library_path(),
          "save_every_equals_one_run": True,
          "wide_save_every_equals_one_run": True,
          "samples_per_s_b1": rates["b1"], "samples_per_s_b64": rates["b64"],
          "gpu": gpu})
    return launches


def phase_sequential_main_path(cfgs, params, rng, gpu):
    """Kernel 4's main path: ``generate_cuda(prefill=False)`` three times
    per case (the same seed: bitwise equal codes), a receptive field of
    random inputs then 1,024 samples; the median launch time per step."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import sampler as ks

    results = {}
    ks.decode_sequential.launches = 0          # the main path starts here
    ks.decode_sequential.launches_by.clear()
    for name, B in SEQ_CASES:
        c, p = cfgs[name], params[name]
        prefix = seq_prefix(c, B, rng)
        n_total = prefix.shape[1] - 1 + SEQ_TIMED_SAMPLES
        before = ks.decode_sequential.launches
        before_by = dict(ks.decode_sequential.launches_by)
        outs, times = [], []
        for _ in range(3):
            times.append(cuda_ms(lambda: outs.append(ks.generate_cuda(
                p, c, SEQ_TIMED_SAMPLES, seed=31, batch_size=B,
                seed_codes=prefix, prefill=False))))
        codes = outs[0]
        check(all(torch.equal(codes, o) for o in outs[1:]),
              f"{name} b{B}: same-seed runs differ")
        check(codes.shape == (B, SEQ_TIMED_SAMPLES)
              and 0 <= codes.min().item()
              and codes.max().item() < c.quantization_channels
              and len(torch.unique(codes)) > 8,
              f"{name} b{B}: malformed codes")
        launches = ks.decode_sequential.launches - before
        kernel, = [k for k, v in ks.decode_sequential.launches_by.items()
                   if v != before_by.get(k, 0)]
        ms = float(np.median(times)) / n_total
        bound, by = sequential_bound_per_step(c, B, prefix.shape[1], n_total)
        results[(name, B)] = dict(launches=launches, ms=ms, bound_ms=bound,
                                  bound_by=by, kernel=kernel)
        emit({"phase": "sequential_main_path", "config": name, "batch": B,
              "kernel": DECODE_SOURCES[kernel],
              "steps": n_total, "launches": launches, "ms_per_step": ms,
              "ms_per_step_runs": [x / n_total for x in times],
              "bound_ms_per_step": bound, "bound_by": by,
              "samples_per_s": B * n_total / (float(np.median(times)) / 1e3),
              "gpu": gpu})
    total = ks.decode_sequential.launches
    check(total == 3 * len(SEQ_CASES),
          f"decode_sequential launched {total} times on its main path")
    return results


def bf16_packed(packed):
    """``packed`` with its six matmul weights in bf16: what
    ``pack_sampler_weights(..., weight_dtype=torch.bfloat16)`` stores."""
    import torch
    from wavenet_torch.kernels import sampler as ks
    return packed._replace(**{k: getattr(packed, k).to(torch.bfloat16)
                              for k in ks.WEIGHT_FIELDS})


def phase_bf16_decode(cfgs, params, rng, gpu):
    """The bf16 modes of the decode kernels (TPU kernels 1-4 at
    weight_dtype=bfloat16), pinned: a teacher-forced window in one launch
    (same-seed repeats bitwise; counted under the bf16 names), the same
    window one step a launch from the kernel's own state (bitwise the one
    launch) held step by step against bf16 ``decode_reference``, then
    step times of the bf16 and the float32 route in turns; last, kernel
    4's route at paper b1. Results by (kernel, config, batch)."""
    import torch
    from wavenet_torch.kernels import bf16_hold
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.wavenet import embed_gc

    results = {}
    for name, B, kernel in BF16_TEACHER_CASES:
        c, p = cfgs[name], params[name]
        where = f"{DECODE_SOURCES[kernel]} bf16 {name} B={B}"
        n = BF16_TEACHER_STEPS
        codes, gc_ids = setup(c, B, rng, PREFILL, n)
        carry = ks.prefill_carry(p, c, codes[:, :PREFILL], gc_ids)
        pk32 = ks.pack_sampler_weights(
            p, c, B, None if gc_ids is None else embed_gc(p, c, gc_ids))
        pk16 = bf16_packed(pk32)
        forced = codes[:, PREFILL - 1:PREFILL - 1 + n].contiguous()
        runs = []
        for _ in range(2):
            ring, causal = carry.ring.clone(), carry.causal.clone()
            before = dict(ks.decode.launches_by)
            out = ks.decode(pk16, c, ring, causal, forced, n, carry.t_abs,
                            11, collect_logits=True, kernel=kernel)
            torch.cuda.synchronize()
            ran = {k: v - before.get(k, 0)
                   for k, v in ks.decode.launches_by.items()
                   if v != before.get(k, 0)}
            check(ran == {f"{kernel}_bf16": 1},
                  f"{where}: launches counted as {ran}")
            runs.append(out + (ring, causal))
        (codes_k, lg_k, ring_k, causal_k), again = runs
        check(all(torch.equal(a, b) for a, b in zip(runs[0], again)),
              f"{where}: same-seed runs differ")
        check(torch.equal(codes_k[:, :-1], forced[:, 1:]),
              f"{where}: forced codes not emitted")

        def step(ring, causal, x, t):
            return ks.decode(pk16, c, ring, causal, x, 1, t, 11,
                             collect_logits=True, kernel=kernel)[1]

        ring, causal = carry.ring.clone(), carry.causal.clone()
        rule = ks.chain_rounded("decode", B)
        lg_s, lg16, lg32, rk, r16, r32 = bf16_hold.stepwise(
            c, pk16, pk32, ring, causal, forced, carry.t_abs, 11, rule, step)
        check(torch.equal(lg_s, lg_k) and torch.equal(ring, ring_k)
              and torch.equal(causal, causal_k),
              f"{where}: one step a launch differs from one launch")
        held = bf16_hold.hold(where, lg_s, lg16, lg32)
        held_ring = bf16_hold.hold(f"{where} ring", rk, r16, r32)
        # The whole window against the plain version run on its own:
        # reported, since a rounding flip carries on through the ring.
        ring, causal = carry.ring.clone(), carry.causal.clone()
        _, lg_w = ks.decode_reference(pk16, c, ring, causal, forced, n,
                                      carry.t_abs, 11, collect_logits=True)
        window_err = (lg_k - lg_w).abs()
        # Step times in turns: this bf16 kernel, the float32 route's kernel
        # at the same shape (cluster or tiles), and the plain bf16 version.
        steps = BF16_TIMED_STEPS[(name, B)]
        f32_kernel = ("cluster" if ks.device_plan(c, B) else
                      "tiles" if ks.device_tile_plan(c, B) else "decode")
        fk = forced[:, :1].contiguous()
        ring, causal = carry.ring.clone(), carry.causal.clone()
        timed = {"bf16": [], "f32": []}
        for wt in ("f32", "bf16", "bf16", "f32"):
            pk, k = (pk16, kernel) if wt == "bf16" else (pk32, f32_kernel)
            timed[wt].append(cuda_ms(lambda: ks.decode(
                pk, c, ring, causal, fk, steps, 0, 5, kernel=k)) / steps)
        rp, cp = carry.ring.clone(), carry.causal.clone()
        n_plain = 8
        plain_ms = cuda_ms(lambda: ks.decode_reference(
            pk16, c, rp, cp, fk, n_plain, 0, 5)) / n_plain
        bound, by = bound_per_step(c, B, steps, wbytes=2, round_chain=rule)
        ms = float(min(timed["bf16"]))
        results[(kernel, name, B)] = dict(
            max_abs_err=held["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, f32_route_ms=float(min(timed["f32"])),
            f32_route_kernel=DECODE_SOURCES[f32_kernel])
        emit({"phase": "bf16_decode", "kernel": DECODE_SOURCES[kernel],
              "mode": "bf16", "config": name, "batch": B, "steps": n,
              "round_chain": rule,
              "max_abs_err_vs_plain": held["max_abs_err"],
              "err_over_bf16_gap": {k: v for k, v in held.items()
                                    if k != "max_abs_err"},
              "ring_err_over_bf16_gap": {k: v for k, v in held_ring.items()
                                         if k != "max_abs_err"},
              "window_max_abs_err": window_err.max().item(),
              "window_median_err": window_err.median().item(),
              "bf16_gap_mean": (lg16 - lg32).abs().mean().item(),
              "stepwise_equals_one_launch": True, "bitwise_repeat": True,
              "launches_by": f"{kernel}_bf16", "ms_per_step": ms,
              "ms_per_step_runs": timed["bf16"],
              "f32_route_kernel": DECODE_SOURCES[f32_kernel],
              "f32_route_ms_per_step_runs": timed["f32"],
              "plain_ms_per_step": plain_ms, "bound_ms_per_step": bound,
              "bound_by": by, "timed_steps": steps, "gpu": gpu})
        del runs, lg_k, lg_s, lg16, lg32, lg_w, rk, r16, r32
        torch.cuda.empty_cache()

    # Kernel 4's route at bf16 (the chain rounded at every B, b1 included):
    # paper b1 from a zero ring over a short random prefix, on the routed
    # kernel; the kernel's inputs replayed one step a launch, each step
    # against the plain version from the kernel's own state.
    c, p = cfgs["paper"], params["paper"]
    prefix = seq_prefix(c, 1, rng)[:, :BF16_SEQ_PREFIX].contiguous()
    n_total = BF16_SEQ_PREFIX - 1 + BF16_SEQ_SAMPLES
    pk32 = ks.pack_sampler_weights(p, c, 1)
    pk16 = bf16_packed(pk32)
    before = dict(ks.decode_sequential.launches_by)
    codes_k, lg_k = ks.decode_sequential(pk16, c, prefix, n_total, 21,
                                         collect_logits=True)
    again, _ = ks.decode_sequential(pk16, c, prefix, n_total, 21)
    torch.cuda.synchronize()
    ran = {k: v - before.get(k, 0)
           for k, v in ks.decode_sequential.launches_by.items()
           if v != before.get(k, 0)}
    check(ran == {"cluster_bf16": 2},
          f"bf16 sequential paper b1: launches counted as {ran}")
    check(torch.equal(codes_k, again), "bf16 sequential: same-seed runs "
          "differ")

    rule = ks.chain_rounded("sequential", 1)

    def step(ring, causal, x, t):
        return ks._launch(pk16, c, ring, causal, x, 1, t, 21, 1.0, True,
                          route="sequential")[1]

    ring, causal = ks.zero_state(c, 1, "cuda")
    lg_s, lg16, lg32, rk, r16, r32 = bf16_hold.stepwise(
        c, pk16, pk32, ring, causal, replay_inputs(c, prefix, codes_k), 0, 21,
        rule, step)
    check(torch.equal(lg_s, lg_k), "bf16 sequential: one step a launch "
          "differs from the route's one launch")
    held = bf16_hold.hold("bf16 sequential paper b1", lg_s, lg16, lg32)
    held_ring = bf16_hold.hold("bf16 sequential paper b1 ring", rk, r16,
                               r32)
    # One timed launch of the route, SEQ_TIMED_SAMPLES sampled steps after
    # the prefix (phase 6's length), and the plain version's step.
    n_timed = BF16_SEQ_PREFIX - 1 + SEQ_TIMED_SAMPLES
    ms = cuda_ms(lambda: ks.decode_sequential(pk16, c, prefix, n_timed,
                                              21)) / n_timed
    ring, causal = ks.zero_state(c, 1, "cuda")
    plain_ms = cuda_ms(lambda: ks.decode_reference(
        pk16, c, ring, causal, prefix, 8, 0, 21, round_chain=rule)) / 8
    bound, by = sequential_bound_per_step(c, 1, BF16_SEQ_PREFIX, n_timed,
                                          wbytes=2)
    results[("sequential", "paper", 1)] = dict(
        max_abs_err=held["max_abs_err"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, launches=sum(ran.values()))
    emit({"phase": "bf16_sequential", "kernel": "sampler_cluster",
          "mode": "bf16", "config": "paper", "batch": 1,
          "forced": BF16_SEQ_PREFIX, "steps": n_total,
          "max_abs_err_vs_plain": held["max_abs_err"],
          "err_over_bf16_gap": {k: v for k, v in held.items()
                                if k != "max_abs_err"},
          "ring_err_over_bf16_gap": {k: v for k, v in held_ring.items()
                                     if k != "max_abs_err"},
          "stepwise_equals_one_launch": True, "bitwise_repeat": True,
          "launches_by": ran, "ms_per_step": ms, "timed_steps": n_timed,
          "plain_ms_per_step": plain_ms, "bound_ms_per_step": bound,
          "bound_by": by, "gpu": gpu})
    return results


def phase_bf16_generate(cfgs, params, gc_ckpt, gc_pfile, gpu):
    """The main path of bf16-weight generation: ``python -m
    wavenet_torch.cli.generate --sampler_precision bfloat16`` from phase
    5's gc checkpoint at b1 and b64 x 16,000 (the cluster kernel's bf16
    mode), b128 x 4,000 (the tiles kernel's) and b600 x 1,000
    (``sampler_decode``'s), its launches counted from 0; then generation
    from a config whose ``compute_dtype`` is bfloat16, which runs at
    float32 as in the JAX package:
    ``generate_with_fallback`` (the CLI's fast path) on such a config
    object, bitwise the float32 config's. The CLI itself cannot reach one:
    the params format, as the JAX package's, has no ``compute_dtype``."""
    import dataclasses
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.sampler_select import generate_with_fallback

    c = cfgs["gc"]
    tmp = tempfile.mkdtemp(prefix="wavenet_torch_bf16_")
    gc_flags = ["--gc_channels", str(c.gc_channels), "--gc_cardinality",
                str(c.gc_cardinality), "--gc_id", "5"]

    ks.decode.launches = ks.decode_sequential.launches = 0  # the main path
    ks.decode.launches_by.clear()
    ks.decode_sequential.launches_by.clear()
    rates = {}
    for label, B, n, want in BF16_CLI_RUNS:
        before = dict(ks.decode.launches_by)
        wav = os.path.join(tmp, f"{label}.wav")
        out, seconds = run_generate_cli(
            [gc_ckpt, "--wavenet_params", gc_pfile, "--samples", str(n),
             "--batch_size", str(B), "--wav_out_path", wav, "--seed", "1",
             "--device", "cuda", "--sampler_precision", "bfloat16"]
            + gc_flags)
        check("Finished generating." in out, f"{label}: no finish line")
        check("bf16 weights" in out, f"{label}: not the bf16 sampler")
        read_wavs(wav, B, n)
        ran = {k: v - before.get(k, 0)
               for k, v in ks.decode.launches_by.items()
               if v != before.get(k, 0)}
        check(ran == {want: 1}, f"{label}: launched {ran}, not {want}")
        rates[label] = B * n / seconds
        emit({"phase": "generate_cli_bf16", "run": label, "config": "gc",
              "batch": B, "samples": n, "seconds": seconds,
              "samples_per_s": rates[label], "served_by": ran, "gpu": gpu})
    launches = dict(ks.decode.launches_by)
    check(ks.decode_sequential.launches == 0,
          "the bf16 CLI took the sequential route")

    # A bf16 config object prefills and decodes at float32.
    p = params["gc"]
    c16 = dataclasses.replace(c, compute_dtype="bfloat16")
    ids = torch.full((64,), 5, dtype=torch.int64, device="cuda")
    same = {}
    for precision in ("float32", "bfloat16"):
        got = [generate_with_fallback(
            p, cfg, BF16_CONFIG_SAMPLES, seed=3, batch_size=64, gc_ids=ids,
            precision=precision, log=lambda _: None)[0] for cfg in (c, c16)]
        same[precision] = torch.equal(got[0], got[1])
        check(same[precision], f"generation from a bf16 config at "
              f"{precision} weights differs from the float32 config's")
    emit({"phase": "generate_cli_bf16", "decode_launches_by_kernel":
          {k: v for k, v in launches.items()},
          "bf16_config_equals_f32_config": same,
          "samples_per_s_b1": rates["b1"], "samples_per_s_b64": rates["b64"],
          "samples_per_s_b128": rates["b128"],
          "samples_per_s_b600": rates["b600"], "gpu": gpu})
    return launches


def lc_params(c, seed: int, device):
    """``seeded_params`` of an LC config with its LC weights perturbed
    from the seed too (the biases non-zero as there)."""
    import torch
    p = seeded_params(c, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 2)
    for k in ("lc_filter", "lc_gate"):
        p[k] = p[k] + 0.05 * torch.randn(p[k].shape, generator=gen)
    return {k: v.to(device) for k, v in p.items()}


def mel_frames(seconds: float, f0: float, sr: int = 16000):
    """80 standardized log-mel frames at a 200-sample hop of a synthesized
    voiced sound (a harmonic series on ``f0`` with a slow vibrato), made by
    the port's ``features.log_mel_spectrogram``."""
    import numpy as np
    from wavenet_torch.features import log_mel_spectrogram
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * f0 * (t + 0.002 * np.sin(2 * np.pi * 5 * t))
    x = sum(0.3 / k * np.sin(k * phase) for k in range(1, 9))
    mel = log_mel_spectrogram(x.astype(np.float32), sr, LC_CHANNELS, LC_HOP)
    return (mel - mel.mean(0)) / np.maximum(mel.std(0), 1e-6)


def phase_lc_decode(c, p, rng, gpu):
    """The LC modes of ``sampler_cluster`` and ``sampler_decode``, pinned
    (LC_CASES): an LC prefill, then a teacher-forced window in one launch
    against ``decode_reference(lc=)`` (phase 2's tolerance; at b1 also
    against the parallel ``forward_codes``), same-seed repeats bitwise,
    counted under ``<kernel>_lc``; then step times in turns with the same
    kernel without LC at the same batch, the plain version's step and the
    bound. Results by (kernel, batch)."""
    import dataclasses
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.wavenet import forward_codes

    c0 = dataclasses.replace(c, lc_channels=None)
    top = max(B for B in range(1, 257) if ks.device_plan(c, B) is not None)
    check(ks.device_plan(c, top + 1) is None and ks.device_tile_plan(
        c, top + 1) is None, f"paper-LC b{top + 1}: not sampler_decode")
    results = {}
    n = LC_TEACHER_STEPS
    for kernel, B in LC_CASES:
        B = top if B == "top" else B
        where = f"{LC_SOURCES[kernel]} paper-LC B={B}"
        codes, _ = setup(c, B, rng, PREFILL, n)
        stream = torch.as_tensor(
            rng.uniform(-1, 1, (B, PREFILL - 1 + n, LC_CHANNELS)),
            dtype=torch.float32, device="cuda")
        carry = ks.prefill_carry(p, c, codes[:, :PREFILL],
                                 lc=stream[:, :PREFILL - 1])
        packed = ks.pack_sampler_weights(p, c, B)
        forced = codes[:, PREFILL - 1:PREFILL - 1 + n].contiguous()
        lc = stream[:, PREFILL - 1:].transpose(0, 1).contiguous()
        ring_r, causal_r = carry.ring.clone(), carry.causal.clone()
        _, lg_r = ks.decode_reference(packed, c, ring_r, causal_r, forced, n,
                                      carry.t_abs, 11, collect_logits=True,
                                      lc=lc)
        runs = []
        for _ in range(2):
            ring, causal = carry.ring.clone(), carry.causal.clone()
            before = dict(ks.decode.launches_by)
            out = ks.decode(packed, c, ring, causal, forced, n, carry.t_abs,
                            11, collect_logits=True, kernel=kernel, lc=lc)
            torch.cuda.synchronize()
            ran = {k: v - before.get(k, 0)
                   for k, v in ks.decode.launches_by.items()
                   if v != before.get(k, 0)}
            check(ran == {f"{kernel}_lc": 1},
                  f"{where}: launches counted as {ran}")
            runs.append(out + (ring, causal))
        (codes_k, lg_k, ring_k, causal_k), again = runs
        check(all(torch.equal(a, b) for a, b in zip(runs[0], again)),
              f"{where}: same-seed runs differ")
        err = (lg_k - lg_r).abs().max().item()
        check(torch.isfinite(lg_k).all().item(), f"{where}: non-finite")
        check(torch.allclose(lg_k, lg_r, rtol=1e-4, atol=1e-4),
              f"{where}: logits differ from decode_reference (max |d| {err})")
        check(torch.allclose(ring_k, ring_r, rtol=1e-4, atol=1e-4),
              f"{where}: ring state differs")
        check(torch.equal(causal_k, causal_r), f"{where}: causal differs")
        check(torch.equal(codes_k[:, :-1], forced[:, 1:]),
              f"{where}: forced codes not emitted")
        err_f = None
        if B == 1:
            full = forward_codes(p, c, codes[:, :PREFILL - 1 + n],
                                 head_from=PREFILL - 1, lc=stream)
            err_f = (lg_k - full).abs().max().item()
            check(torch.allclose(lg_k, full, rtol=1e-4, atol=1e-4),
                  f"{where}: logits differ from forward_codes ({err_f})")
        # Step times in turns: without LC, with, with, without.
        steps = LC_TIMED_STEPS.get(B, 1024)
        fk = forced[:, :1].contiguous()
        lc_t = torch.as_tensor(rng.uniform(-1, 1, (steps, B, LC_CHANNELS)),
                               dtype=torch.float32, device="cuda")
        ring, causal = carry.ring.clone(), carry.causal.clone()
        timed = {"lc": [], "no_lc": []}
        for mode in ("no_lc", "lc", "lc", "no_lc"):
            cfg, stream_t = (c, lc_t) if mode == "lc" else (c0, None)
            timed[mode].append(cuda_ms(lambda: ks.decode(
                packed, cfg, ring, causal, fk, steps, 0, 5, kernel=kernel,
                lc=stream_t)) / steps)
        rp, cp = carry.ring.clone(), carry.causal.clone()
        n_plain = 8
        plain_ms = cuda_ms(lambda: ks.decode_reference(
            packed, c, rp, cp, fk, n_plain, 0, 5, lc=lc_t[:n_plain])) / n_plain
        bound, by = bound_per_step(c, B, steps)
        ms = float(min(timed["lc"]))
        results[(kernel, B)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, no_lc_ms=float(min(timed["no_lc"])))
        plan = ks.device_plan(c, B) if kernel == "cluster" else None
        emit({"phase": "lc_decode", "kernel": LC_SOURCES[kernel],
              "config": "paper_lc", "batch": B, "steps": n,
              "plan": plan._asdict() if plan else None,
              "max_abs_err_vs_plain": err, "max_abs_err_vs_forward": err_f,
              "bitwise_repeat": True, "launches_by": f"{kernel}_lc",
              "ms_per_step": ms, "ms_per_step_runs": timed["lc"],
              "no_lc_ms_per_step_runs": timed["no_lc"],
              "lc_over_no_lc": ms / results[(kernel, B)]["no_lc_ms"],
              "plain_ms_per_step": plain_ms, "bound_ms_per_step": bound,
              "bound_by": by, "timed_steps": steps, "gpu": gpu})
        del runs, lg_k, lg_r, stream, lc, lc_t
        torch.cuda.empty_cache()
    results["top"] = top
    return results


def phase_lc_generate(c, p, gpu):
    """The JAX bench's ``lc`` generation row: ``generate_cuda`` on
    paper-LC at b1 x 16,000, the prefill route, a uniform(-1, 1) stream
    from a seed (bench.py:149-150); samples/s."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import sampler as ks

    rng = np.random.RandomState(5)
    lc = torch.as_tensor(rng.uniform(-1, 1, (1, GEN_SAMPLES, LC_CHANNELS)),
                         dtype=torch.float32, device="cuda")
    ks.generate_cuda(p, c, 256, seed=1, lc=lc[:, :256])     # warm
    torch.cuda.synchronize()
    before = dict(ks.decode.launches_by)
    t = time.perf_counter()
    codes = ks.generate_cuda(p, c, GEN_SAMPLES, seed=1, lc=lc)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    ran = {k: v - before.get(k, 0) for k, v in ks.decode.launches_by.items()
           if v != before.get(k, 0)}
    check(ran == {"cluster_lc": 1}, f"lc generation launched {ran}")
    check(tuple(codes.shape) == (1, GEN_SAMPLES)
          and 0 <= codes.min().item() and codes.max().item() < 256
          and len(torch.unique(codes)) > 8, "lc generation: bad codes")
    rate = GEN_SAMPLES / seconds
    emit({"phase": "lc_generate", "config": "paper_lc", "batch": 1,
          "samples": GEN_SAMPLES, "seconds": seconds, "samples_per_s": rate,
          "served_by": ran, "gpu": gpu})
    return rate


def phase_lc_main_path(c, p, gpu):
    """The main path of LC generation, its launches counted from 0: a
    ``GenerationService`` from a params file with ``lc_channels: 80``
    answers /generate with 80 log-mel frames (``features.py`` of a
    synthesized sound) at ``lc_hop`` 200, 16,000 samples, and other frames
    give another waveform; then ``python -m wavenet_torch.cli.generate
    --lc_channels 80 --lc_file ... --lc_hop 200`` (LC_CLI_RUNS), a
    ``--save_every`` run equal to the single run."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.params import save_npz
    from wavenet_torch.serve import GenerationService

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_lc_")
    npz = os.path.join(tmp, "paper_lc.npz")
    save_npz(npz, {k: v.cpu() for k, v in p.items()})
    js = os.path.join(tmp, "paper_lc.json")
    with open(js, "w") as f:
        json.dump(dict(c.to_json_dict(), sample_rate=16000), f)
    frames = {f0: mel_frames(GEN_SAMPLES / 16000, f0) for f0 in (110, 220)}
    ks.decode.launches = ks.decode_sequential.launches = 0  # the main path
    ks.decode.launches_by.clear()
    service = GenerationService(npz, js, warm_samples=256, device="cuda")
    check("local conditioning" in service.sampler_name,
          f"LC service runs {service.sampler_name}")
    httpd, url = start_server(service)
    served = {}
    try:
        for f0, fr in frames.items():
            before = dict(ks.decode.launches_by)
            with launch_events(ks) as events:
                t = time.perf_counter()
                body = post(url + "/generate", {
                    "samples": GEN_SAMPLES, "seed": 3, "format": "codes",
                    "lc": fr.tolist(), "lc_hop": LC_HOP})
                dt = time.perf_counter() - t
            torch.cuda.synchronize()
            decode_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
            codes = body["codes"]
            check(len(codes) == GEN_SAMPLES and len(set(codes)) > 8,
                  f"/generate with LC frames ({f0} Hz): bad response")
            ran = {k: v - before.get(k, 0)
                   for k, v in ks.decode.launches_by.items()
                   if v != before.get(k, 0)}
            check(ran == {"cluster_lc": 1}, f"LC request launched {ran}")
            served[f0] = codes
            emit({"phase": "lc_serving", "config": "paper_lc",
                  "endpoint": "/generate", "frames": list(fr.shape),
                  "lc_hop": LC_HOP, "f0_hz": f0, "samples": GEN_SAMPLES,
                  "seconds": dt, "samples_per_s": GEN_SAMPLES / dt,
                  "decode_s": decode_s, "outside_decode_s": dt - decode_s,
                  "served_by": ran, "gpu": gpu})
    finally:
        httpd.shutdown()
        httpd.server_close()
    check(served[110] != served[220],
          "other LC frames gave the same waveform")

    feats = os.path.join(tmp, "f.lc.npy")
    np.save(feats, frames[220])
    ckpt = os.path.join(tmp, "ckpt")
    pfile = write_checkpoint(ckpt, c, p)
    wavs, rates = {}, {}
    for label, B, n, extra, want, count in LC_CLI_RUNS:
        wav = os.path.join(tmp, f"{label}.wav")
        before = dict(ks.decode.launches_by)
        out, seconds = run_generate_cli(
            [ckpt, "--wavenet_params", pfile, "--samples", str(n),
             "--batch_size", str(B), "--wav_out_path", wav, "--seed", "1",
             "--device", "cuda", "--lc_channels", str(LC_CHANNELS),
             "--lc_file", feats, "--lc_hop", str(LC_HOP)] + extra)
        check("Finished generating." in out, f"LC CLI {label}: no finish")
        check("local conditioning" in out, f"LC CLI {label}: not the LC "
              "sampler")
        wavs[label] = read_wavs(wav, B, n)
        ran = {k: v - before.get(k, 0)
               for k, v in ks.decode.launches_by.items()
               if v != before.get(k, 0)}
        check(ran == {want: count}, f"LC CLI {label}: launched {ran}")
        rates[label] = B * n / seconds
        emit({"phase": "generate_cli_lc", "run": label, "config": "paper_lc",
              "batch": B, "samples": n, "seconds": seconds,
              "samples_per_s": rates[label], "served_by": ran, "gpu": gpu})
    check((wavs["b64_save_every"] == wavs["b64"]).all(),
          "LC --save_every segments differ from the single run")
    check(ks.decode_sequential.launches == 0,
          "LC serving or the CLI took the sequential route")
    launches = dict(ks.decode.launches_by)
    check(set(launches) == {"cluster_lc", "decode_lc"},
          f"the LC main path launched {launches}")
    emit({"phase": "generate_cli_lc", "launches_by_kernel": launches,
          "save_every_equals_one_run": True,
          "other_frames_change_the_waveform": True,
          "samples_per_s": rates, "gpu": gpu})
    return launches


def phase_lc_bf16_decode(c, p, rng, gpu):
    """The bf16 LC modes of ``sampler_cluster`` and ``sampler_decode``
    (TPU kernels 1 and 2 with has_lc at weight_dtype=bfloat16), pinned
    (LC_BF16_CASES): an LC prefill, then a teacher-forced window in one
    launch (same-seed repeats bitwise; counted under
    ``<kernel>_bf16_lc``) and one step a launch from the kernel's own state
    (bitwise the one launch), each step held against bf16
    ``decode_reference(lc=)`` from that state on the scale of bf16's gap
    from float32 (``kernels.bf16_hold``); then step times in turns with
    the float32 LC mode and the bf16 mode without LC of the same kernel,
    the plain version's step and the bound at 2-byte weights. Results by
    (kernel, batch)."""
    import dataclasses
    import torch
    from wavenet_torch.kernels import bf16_hold
    from wavenet_torch.kernels import sampler as ks

    c0 = dataclasses.replace(c, lc_channels=None)
    top = max(B for B in range(1, 257) if ks.device_plan(c, B) is not None)
    results = {}
    n = LC_TEACHER_STEPS
    for kernel, B in LC_BF16_CASES:
        B = top if B == "top" else B
        where = f"{LC_BF16_SOURCES[kernel]} paper-LC B={B}"
        key = f"{kernel}_bf16_lc"
        codes, _ = setup(c, B, rng, PREFILL, n)
        stream = torch.as_tensor(
            rng.uniform(-1, 1, (B, PREFILL - 1 + n, LC_CHANNELS)),
            dtype=torch.float32, device="cuda")
        carry = ks.prefill_carry(p, c, codes[:, :PREFILL],
                                 lc=stream[:, :PREFILL - 1])
        pk32 = ks.pack_sampler_weights(p, c, B)
        pk16 = ks.pack_sampler_weights(p, c, B, weight_dtype=torch.bfloat16)
        forced = codes[:, PREFILL - 1:PREFILL - 1 + n].contiguous()
        lc = stream[:, PREFILL - 1:].transpose(0, 1).contiguous()
        runs = []
        for _ in range(2):
            ring, causal = carry.ring.clone(), carry.causal.clone()
            before = dict(ks.decode.launches_by)
            out = ks.decode(pk16, c, ring, causal, forced, n, carry.t_abs,
                            11, collect_logits=True, kernel=kernel, lc=lc)
            torch.cuda.synchronize()
            ran = {k: v - before.get(k, 0)
                   for k, v in ks.decode.launches_by.items()
                   if v != before.get(k, 0)}
            check(ran == {key: 1}, f"{where}: launches counted as {ran}")
            runs.append(out + (ring, causal))
        (codes_k, lg_k, ring_k, causal_k), again = runs
        check(all(torch.equal(a, b) for a, b in zip(runs[0], again)),
              f"{where}: same-seed runs differ")
        check(torch.equal(codes_k[:, :-1], forced[:, 1:]),
              f"{where}: forced codes not emitted")

        def step(ring, causal, x, t):
            i = t - carry.t_abs
            return ks.decode(pk16, c, ring, causal, x, 1, t, 11,
                             collect_logits=True, kernel=kernel,
                             lc=lc[i:i + 1])[1]

        ring, causal = carry.ring.clone(), carry.causal.clone()
        rule = ks.chain_rounded("decode", B, lc=True)
        lg_s, lg16, lg32, rk, r16, r32 = bf16_hold.stepwise(
            c, pk16, pk32, ring, causal, forced, carry.t_abs, 11, rule, step,
            lc=lc)
        check(torch.equal(lg_s, lg_k) and torch.equal(ring, ring_k)
              and torch.equal(causal, causal_k),
              f"{where}: one step a launch differs from one launch")
        held = bf16_hold.hold(where, lg_s, lg16, lg32)
        held_ring = bf16_hold.hold(f"{where} ring", rk, r16, r32)
        # The whole window against the plain version run on its own:
        # reported, since a rounding flip carries on through the ring.
        ring, causal = carry.ring.clone(), carry.causal.clone()
        _, lg_w = ks.decode_reference(pk16, c, ring, causal, forced, n,
                                      carry.t_abs, 11, collect_logits=True,
                                      lc=lc)
        window_err = (lg_k - lg_w).abs()
        # Step times in turns: the float32 LC mode, the bf16 LC mode and
        # the bf16 mode without LC of the same kernel, each twice.
        steps = LC_TIMED_STEPS.get(B, 1024)
        fk = forced[:, :1].contiguous()
        lc_t = torch.as_tensor(rng.uniform(-1, 1, (steps, B, LC_CHANNELS)),
                               dtype=torch.float32, device="cuda")
        ring, causal = carry.ring.clone(), carry.causal.clone()
        modes = {"f32_lc": (pk32, c, lc_t), "bf16_lc": (pk16, c, lc_t),
                 "bf16": (pk16, c0, None)}
        timed = {m: [] for m in modes}
        for mode in ("f32_lc", "bf16_lc", "bf16", "bf16", "bf16_lc",
                     "f32_lc"):
            pk, cfg, stream_t = modes[mode]
            timed[mode].append(cuda_ms(lambda: ks.decode(
                pk, cfg, ring, causal, fk, steps, 0, 5, kernel=kernel,
                lc=stream_t)) / steps)
        rp, cp = carry.ring.clone(), carry.causal.clone()
        n_plain = 8
        plain_ms = cuda_ms(lambda: ks.decode_reference(
            pk16, c, rp, cp, fk, n_plain, 0, 5,
            lc=lc_t[:n_plain])) / n_plain
        bound, by = bound_per_step(c, B, steps, wbytes=2, round_chain=rule)
        ms = float(min(timed["bf16_lc"]))
        res = results[(kernel, B)] = dict(
            max_abs_err=held["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by,
            f32_lc_ms=float(min(timed["f32_lc"])),
            bf16_ms=float(min(timed["bf16"])))
        emit({"phase": "lc_bf16_decode", "kernel": LC_BF16_SOURCES[kernel],
              "mode": "bf16_lc", "config": "paper_lc", "batch": B,
              "steps": n, "round_chain": rule,
              "max_abs_err_vs_plain": held["max_abs_err"],
              "err_over_bf16_gap": {k: v for k, v in held.items()
                                    if k != "max_abs_err"},
              "ring_err_over_bf16_gap": {k: v for k, v in held_ring.items()
                                         if k != "max_abs_err"},
              "window_max_abs_err": window_err.max().item(),
              "window_median_err": window_err.median().item(),
              "bf16_gap_mean": (lg16 - lg32).abs().mean().item(),
              "stepwise_equals_one_launch": True, "bitwise_repeat": True,
              "launches_by": key, "ms_per_step": ms,
              "ms_per_step_runs": timed["bf16_lc"],
              "f32_lc_ms_per_step_runs": timed["f32_lc"],
              "bf16_no_lc_ms_per_step_runs": timed["bf16"],
              "over_f32_lc": ms / res["f32_lc_ms"],
              "over_bf16_no_lc": ms / res["bf16_ms"],
              "plain_ms_per_step": plain_ms, "bound_ms_per_step": bound,
              "bound_by": by, "timed_steps": steps, "gpu": gpu})
        del runs, lg_k, lg_s, lg16, lg32, lg_w, rk, r16, r32, stream, lc
        del lc_t
        torch.cuda.empty_cache()
    return results


def phase_lc_bf16_main_path(c, p, gpu):
    """The main path of LC generation at bf16 weights, its launches
    counted from 0: ``python -m wavenet_torch.cli.generate --lc_channels 80
    --lc_file ... --lc_hop 200 --sampler_precision bfloat16``
    (LC_BF16_CLI_RUNS: the cluster kernel's bf16 LC mode at b1 x 16,000
    and b64, a ``--save_every`` run equal to the single run, and
    ``sampler_decode``'s at b256)."""
    import numpy as np
    from wavenet_torch.kernels import sampler as ks

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_lc_bf16_")
    feats = os.path.join(tmp, "f.lc.npy")
    np.save(feats, mel_frames(GEN_SAMPLES / 16000, 220))
    ckpt = os.path.join(tmp, "ckpt")
    pfile = write_checkpoint(ckpt, c, p)
    ks.decode.launches = ks.decode_sequential.launches = 0  # the main path
    ks.decode.launches_by.clear()
    ks.decode_sequential.launches_by.clear()
    wavs, rates = {}, {}
    for label, B, n, extra, want, count in LC_BF16_CLI_RUNS:
        wav = os.path.join(tmp, f"{label}.wav")
        before = dict(ks.decode.launches_by)
        out, seconds = run_generate_cli(
            [ckpt, "--wavenet_params", pfile, "--samples", str(n),
             "--batch_size", str(B), "--wav_out_path", wav, "--seed", "1",
             "--device", "cuda", "--lc_channels", str(LC_CHANNELS),
             "--lc_file", feats, "--lc_hop", str(LC_HOP),
             "--sampler_precision", "bfloat16"] + extra)
        check("Finished generating." in out, f"LC bf16 CLI {label}: no "
              "finish")
        check("bf16 weights, local conditioning" in out,
              f"LC bf16 CLI {label}: not the bf16 LC sampler")
        wavs[label] = read_wavs(wav, B, n)
        ran = {k: v - before.get(k, 0)
               for k, v in ks.decode.launches_by.items()
               if v != before.get(k, 0)}
        check(ran == {want: count}, f"LC bf16 CLI {label}: launched {ran}")
        rates[label] = B * n / seconds
        emit({"phase": "generate_cli_lc_bf16", "run": label,
              "config": "paper_lc", "batch": B, "samples": n,
              "seconds": seconds, "samples_per_s": rates[label],
              "served_by": ran, "gpu": gpu})
    check((wavs["b64_save_every"] == wavs["b64"]).all(),
          "LC bf16 --save_every segments differ from the single run")
    check(ks.decode_sequential.launches == 0,
          "the LC bf16 CLI took the sequential route")
    launches = dict(ks.decode.launches_by)
    check(set(launches) == {"cluster_bf16_lc", "decode_bf16_lc"},
          f"the LC bf16 main path launched {launches}")
    emit({"phase": "generate_cli_lc_bf16", "launches_by_kernel": launches,
          "save_every_equals_one_run": True, "samples_per_s": rates,
          "gpu": gpu})
    return launches


def ring16_key(kernel: str, bf16: bool, lc: bool) -> str:
    """The name a bf16-ring launch is counted under: the kernel, "_bf16"
    at bf16 weights, "_lc" with LC, then "_ring16"."""
    return (kernel + ("_bf16" if bf16 else "") + ("_lc" if lc else "")
            + "_ring16")


def phase_ring16_decode(cfgs, params, c_lc, p_lc, rng, gpu):
    """The bf16-ring modes of the decode kernels (TPU kernels 1-3 at
    state_dtype=bfloat16), pinned (RING16_CASES) at each weight type: a
    prefill whose ring is rounded to bf16, then a teacher-forced window in
    one launch (same-seed repeats bitwise; counted under the ``_ring16``
    name) and one step a launch from the kernel's own state (bitwise the
    one launch), each step held against ``decode_reference`` from that
    state (float32 weights: logits within RING16_TOL, rows by
    ``bf16_hold.hold_ring16``; bf16 weights: both by ``bf16_hold.hold``);
    then one step timed in turns with the same mode at a float32 ring,
    the plain version's step and the bound at 2-byte ring rows. Results by
    launch name."""
    import torch
    from wavenet_torch.kernels import bf16_hold
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.wavenet import embed_gc

    results = {}
    n = RING16_STEPS
    for kernel, name, B in RING16_CASES:
        c, p = (c_lc, p_lc) if name == "lc" else (cfgs[name], params[name])
        lc_on = c.lc_enabled
        codes, gc_ids = setup(c, B, rng, PREFILL, n)
        stream = lc = lc_t = None
        steps = RING16_TIMED_STEPS[B]
        if lc_on:
            stream = torch.as_tensor(
                rng.uniform(-1, 1, (B, PREFILL - 1 + n, LC_CHANNELS)),
                dtype=torch.float32, device="cuda")
            lc = stream[:, PREFILL - 1:].transpose(0, 1).contiguous()
            lc_t = torch.as_tensor(
                rng.uniform(-1, 1, (steps, B, LC_CHANNELS)),
                dtype=torch.float32, device="cuda")
        carry = ks.prefill_carry(
            p, c, codes[:, :PREFILL], gc_ids,
            lc=None if stream is None else stream[:, :PREFILL - 1])
        ring16 = carry.ring.to(torch.bfloat16)
        gc_emb = None if gc_ids is None else embed_gc(p, c, gc_ids)
        forced = codes[:, PREFILL - 1:PREFILL - 1 + n].contiguous()
        pk32 = ks.pack_sampler_weights(p, c, B, gc_emb)
        rule = ks.chain_rounded("decode", B, lc_on)
        for bf16 in (False, True):
            pk = (ks.pack_sampler_weights(p, c, B, gc_emb,
                                          weight_dtype=torch.bfloat16)
                  if bf16 else pk32)
            key = ring16_key(kernel, bf16, lc_on)
            where = f"sampler_{key} {name} B={B}"
            runs = []
            for _ in range(2):
                ring, causal = ring16.clone(), carry.causal.clone()
                before = dict(ks.decode.launches_by)
                out = ks.decode(pk, c, ring, causal, forced, n, carry.t_abs,
                                11, collect_logits=True, kernel=kernel,
                                lc=lc)
                torch.cuda.synchronize()
                ran = {k: v - before.get(k, 0)
                       for k, v in ks.decode.launches_by.items()
                       if v != before.get(k, 0)}
                check(ran == {key: 1}, f"{where}: launches counted as {ran}")
                runs.append(out + (ring, causal))
            (codes_k, lg_k, ring_k, causal_k), again = runs
            check(all(torch.equal(a, b) for a, b in zip(runs[0], again)),
                  f"{where}: same-seed runs differ")
            check(ring_k.dtype == torch.bfloat16, f"{where}: ring type")
            check(torch.equal(codes_k[:, :-1], forced[:, 1:]),
                  f"{where}: forced codes not emitted")

            def step(ring, causal, x, t):
                i = t - carry.t_abs
                return ks.decode(pk, c, ring, causal, x, 1, t, 11,
                                 collect_logits=True, kernel=kernel,
                                 lc=None if lc is None else lc[i:i + 1])[1]

            ring, causal = ring16.clone(), carry.causal.clone()
            lg_s, lg16, lg32, rk, r16, r32 = bf16_hold.stepwise(
                c, pk, pk32 if bf16 else pk, ring, causal, forced,
                carry.t_abs, 11, rule, step, lc=lc)
            check(torch.equal(lg_s, lg_k) and torch.equal(ring, ring_k)
                  and torch.equal(causal, causal_k),
                  f"{where}: one step a launch differs from one launch")
            held = None
            if bf16:
                held = bf16_hold.hold(where, lg_s, lg16, lg32)
                rows = bf16_hold.hold(f"{where} ring", rk, r16, r32)
                err = held["max_abs_err"]
            else:
                err = (lg_s - lg16).abs().max().item()
                check(torch.allclose(lg_s, lg16, **RING16_TOL),
                      f"{where}: logits differ from decode_reference "
                      f"(max |d| {err})")
                rows = bf16_hold.hold_ring16(f"{where} ring", rk, r16)
            # One step in turns: the same mode at a float32 and a bf16
            # ring, each launch behind a spin that lets the host queue it.
            fk = forced[:, :1].contiguous()
            timed = {torch.float32: [], torch.bfloat16: []}
            for dt in (torch.float32, torch.bfloat16, torch.bfloat16,
                       torch.float32):
                ring = carry.ring.to(dt, copy=True)
                causal = carry.causal.clone()
                torch.cuda.synchronize()
                torch.cuda._sleep(RING16_SPIN)
                timed[dt].append(cuda_ms_unsynced(lambda: ks.decode(
                    pk, c, ring, causal, fk, steps, carry.t_abs, 5,
                    kernel=kernel, lc=lc_t)) / steps)
            n_plain = min(4, steps)
            rp, cp = ring16.clone(), carry.causal.clone()
            plain_ms = cuda_ms(lambda: ks.decode_reference(
                pk, c, rp, cp, fk, n_plain, carry.t_abs, 5,
                lc=None if lc_t is None else lc_t[:n_plain])) / n_plain
            bound, by = bound_per_step(c, B, steps, wbytes=2 if bf16 else 4,
                                       round_chain=rule, ring_bytes=2)
            ms = float(min(timed[torch.bfloat16]))
            f32_ms = float(min(timed[torch.float32]))
            results.setdefault(key, {})[(name, B)] = dict(
                kernel=kernel, max_abs_err=err, ms=ms, f32_ring_ms=f32_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                rows=rows)
            emit({"phase": "ring16_decode", "kernel": f"sampler_{kernel}",
                  "mode": key, "config": name, "batch": B, "steps": n,
                  "round_chain": rule, "max_abs_err_vs_plain": err,
                  "logits_err_over_bf16_gap": held,
                  "ring_rows": rows, "stepwise_equals_one_launch": True,
                  "bitwise_repeat": True, "ms_per_step": ms,
                  "ms_per_step_runs": timed[torch.bfloat16],
                  "f32_ring_ms_per_step_runs": timed[torch.float32],
                  "over_f32_ring": ms / f32_ms,
                  "plain_ms_per_step": plain_ms, "bound_ms_per_step": bound,
                  "bound_by": by, "timed_steps": steps, "gpu": gpu})
            del runs, lg_k, lg_s, lg16, lg32, rk, r16, r32, ring, causal
        del carry, ring16, pk32, pk, stream, lc, lc_t
        torch.cuda.empty_cache()
    return results


def phase_ring16_main_path(cfgs, params, c_lc, p_lc, rng, gpu):
    """The main path of generation at a bf16 ring, its launches counted
    from 0: ``generate_cuda(state_dtype=torch.bfloat16)`` at each weight
    type at RING16_GEN's shapes (the prefill route: the prefilled ring
    rounded once; ``prefill=False``: a zero bf16 ring), each run twice with
    the same seed (bitwise equal), its codes in range and its last logits
    finite; then, outside the count, paper b1 at a float32 ring, whose
    logits the bf16 ring's must not equal. Returns the launches by name."""
    import torch
    from wavenet_torch.kernels import sampler as ks

    seqs = {}
    for name, B, n, prefill in RING16_GEN:
        c = c_lc if name == "lc" else cfgs[name]
        if c.lc_enabled and (name, B) not in seqs:
            seqs[(name, B)] = torch.as_tensor(
                rng.uniform(-1, 1, (B, n, LC_CHANNELS)), dtype=torch.float32,
                device="cuda")
    counters = (ks.decode, ks.decode_sequential)
    for f in counters:                       # the main path
        f.launches = 0
        f.launches_by.clear()
    rates, last = {}, {}
    for name, B, n, prefill in RING16_GEN:
        c, p = (c_lc, p_lc) if name == "lc" else (cfgs[name], params[name])
        ids = (torch.arange(B, device="cuda") % c.gc_cardinality
               if c.gc_enabled else None)
        for wt in (torch.float32, torch.bfloat16):
            label = (f"{name}_b{B}_{n}_{'prefill' if prefill else 'seq'}_"
                     f"{'bf16' if wt == torch.bfloat16 else 'f32'}")
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs.append(ks.generate_cuda(
                    p, c, n, 7, B, gc_ids=ids, collect_logits=8,
                    weight_dtype=wt, prefill=prefill,
                    lc=seqs.get((name, B)), state_dtype=torch.bfloat16))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            (codes, lg), (codes2, lg2) = runs
            check(torch.equal(codes, codes2) and torch.equal(lg, lg2),
                  f"bf16-ring generation {label}: same-seed runs differ")
            check(codes.shape == (B, n) and int(codes.min()) >= 0
                  and int(codes.max()) < c.quantization_channels
                  and torch.isfinite(lg).all().item(),
                  f"bf16-ring generation {label}: codes out of range or "
                  "logits not finite")
            rates[label] = B * n / seconds
            last[label] = lg
            emit({"phase": "ring16_generate", "run": label, "config": name,
                  "batch": B, "samples": n, "prefill": prefill,
                  "seconds": seconds, "samples_per_s": rates[label],
                  "distinct_codes": int(torch.unique(codes).numel()),
                  "gpu": gpu})
    launches = {f.__name__: dict(f.launches_by) for f in counters}
    merged = {}
    for by in launches.values():
        for k, v in by.items():
            merged[k] = merged.get(k, 0) + v
    want = {ring16_key(kernel, bf16, name == "lc")
            for kernel, name, _ in RING16_CASES for bf16 in (False, True)}
    check(set(merged) == want,
          f"the bf16-ring main path launched {merged}, not {sorted(want)}")
    # Outside the count: the float32 ring at paper b1 moves the logits.
    c, p = cfgs["paper"], params["paper"]
    _, lg32 = ks.generate_cuda(p, c, GEN_SAMPLES, 7, 1, collect_logits=8)
    check(not torch.equal(lg32, last[f"paper_b1_{GEN_SAMPLES}_prefill_f32"]),
          "bf16-ring generation equals the float32 ring's")
    emit({"phase": "ring16_generate", "launches_by_kernel": launches,
          "samples_per_s": rates, "gpu": gpu})
    return merged


def phase_carry_stacks(cfgs, params, rng, gpu):
    """Phase 7 (a): the carry kernel behind v1 and v2 (a wavefront across
    time tiles on the grid that ``carry_plan`` sizes from the card's
    resident blocks; 3xTF32 on the tensor cores) against the plain
    versions and against kernel 5, bitwise repeatable in both directions,
    each call timed beside kernel 5's two kernels."""
    import torch
    from wavenet_torch.experiments import fused_stack as fs1
    from wavenet_torch.experiments import fused_stack2 as fs2
    from wavenet_torch.kernels import fused_stack as fs3
    from wavenet_torch.utils.flops import (H100_TF32X3_FLOPS, bound_ms,
                                           fused_stack_cost)

    results = {}
    for name in ("paper", "gc"):
        c = cfgs[name]
        L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
        args = stack_inputs(c, params[name], rng)
        B, T = args[0].shape[:2]
        dy = torch.as_tensor(rng.randn(B, T, R).astype("float32"),
                             device="cuda")
        dz = randn_cuda(rng, B, T, L * D)
        w_fg, wd, _, bd = args[1:]
        y1, fg1 = fs1.fused_stack_forward(*args, c)
        y2, fg2, z2 = fs2.fused_stack2_forward(*args, c)
        again = fs2.fused_stack2_forward(*args, c)
        yp, fgp, zp = fs2.fused_stack2_forward_reference(*args, c)
        y5, _, z5 = fs3.forward(*args, c)
        g1 = fs1.fused_stack_backward(yp, fgp, dz, dy, w_fg, wd, bd, c)
        g2 = fs2.fused_stack2_backward(yp, dy, fgp, dz, w_fg, wd, bd, c)
        gp = fs2.fused_stack2_backward_reference(yp, dy, fgp, dz, w_fg, wd,
                                                 bd, c)
        g5 = fs3.backward(yp, dy, fgp, dz, w_fg, wd, bd, c)
        torch.cuda.synchronize()
        row = {"phase": "carry_stack", "config": name, "batch": B,
               "positions": T, "gpu": gpu}
        for kind, backward in (("fwd", False), ("bwd", True)):
            resident, plan = fs1.device_carry_plan(c, B, backward)
            row[f"plan_{kind}"] = {"resident_blocks": resident,
                                   "nchunk": plan.nchunk,
                                   "grid": list(plan.grid),
                                   "tiles": -(-T // fs1.CARRY_TILE)}
        err = {"fwd_v1": max(hold(row, "y_v1", y1, yp, FWD_RTOL, FWD_ATOL),
                             hold(row, "fg_v1", fg1, fgp, FWD_RTOL,
                                  FWD_ATOL)),
               "fwd_v2": max(hold(row, "y_v2", y2, yp, FWD_RTOL, FWD_ATOL),
                             hold(row, "fg_v2", fg2, fgp, FWD_RTOL,
                                  FWD_ATOL),
                             hold(row, "z_v2", z2, zp, FWD_RTOL, FWD_ATOL)),
               "bwd": 0.0}
        for label, a, b, lead in zip(GRAD_NAMES, g1, gp, GRAD_LEADS):
            b = b.reshape(a.shape)
            err["bwd"] = max(err["bwd"], hold(row, label, a, b, GRAD_RTOL,
                                              GRAD_ATOL, lead))
        # One kernel behind both wrappers, sums in a fixed order.
        check(torch.equal(y1, y2) and torch.equal(fg1, fg2)
              and all(torch.equal(a, b) for a, b in zip((y2, fg2, z2),
                                                       again)),
              f"{name}: two forward calls on the same inputs differ")
        check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
              f"{name}: two backward calls on the same inputs differ")
        row["bitwise_repeat_forward"] = True
        row["bitwise_repeat_backward"] = True
        # Kernel 5 computes the same map by another design.
        hold(row, "y_vs_kernel5", y2, y5, FWD_RTOL, FWD_ATOL)
        hold(row, "z_vs_kernel5", z2, z5, FWD_RTOL, FWD_ATOL)
        for label, a, b, lead in zip(GRAD_NAMES, g1, g5, GRAD_LEADS):
            hold(row, f"{label}_vs_kernel5", a.reshape(b.shape), b,
                 GRAD_RTOL, GRAD_ATOL, lead)
        timed = {
            "fwd_v1": (lambda: fs1.fused_stack_forward(*args, c),
                       lambda: fs1.fused_stack_forward_reference(*args, c),
                       False),
            "fwd_v2": (lambda: fs2.fused_stack2_forward(*args, c),
                       lambda: fs2.fused_stack2_forward_reference(*args, c),
                       False),
            "bwd": (lambda: fs2.fused_stack2_backward(yp, dy, fgp, dz, w_fg,
                                                      wd, bd, c),
                    lambda: fs2.fused_stack2_backward_reference(
                        yp, dy, fgp, dz, w_fg, wd, bd, c), True),
        }
        for kind, (kern, plain, backward) in timed.items():
            flops, nbytes = fused_stack_cost(c, B, T, backward=backward,
                                             emit_z=kind != "fwd_v1")
            # The carry kernel multiplies in 3xTF32 on the tensor cores.
            bound, by = bound_ms(flops, nbytes, H100_TF32X3_FLOPS)
            ms_k, ms_p = median_cuda_ms(kern), median_cuda_ms(plain)
            row.update({f"{kind}_ms": ms_k, f"{kind}_plain_ms": ms_p,
                        f"{kind}_bound_ms": bound, f"{kind}_bound_by": by})
            results[(name, kind)] = dict(max_abs_err=err[kind], ms=ms_k,
                                         plain_ms=ms_p, bound_ms=bound,
                                         bound_by=by)
        for k in STACK_ROUTES:
            row[f"kernel5_{k}_fwd_ms"] = median_cuda_ms(
                lambda: fs3.forward(*args, c, kernel=k))
            row[f"kernel5_{k}_bwd_ms"] = median_cuda_ms(
                lambda: fs3.backward(yp, dy, fgp, dz, w_fg, wd, bd, c,
                                     kernel=k))
        emit(row)
        del args, dy, dz, y1, fg1, y2, fg2, z2, again, yp, fgp, zp, y5, z5
        del g1, g2, gp, g5
        torch.cuda.empty_cache()
    return results


def phase_carry_bf16(cfgs, params, rng, gpu):
    """Phase 7 (d): the carry kernel's bf16 mode (TPU kernels 6-7 at
    kernel_dtype bf16) behind v1 (without z) and v2 (with z), at the paper
    and gc configs, b8 x (receptive field + 16,000): each forward layer on
    its own input (``teacher_forced_bf16``, on v2's records), forward and
    backward against the plain bf16 versions on the scale of bf16's own
    distance from the plain float32 versions (``hold_bf16``), v1's y and
    fg bitwise v2's, bitwise-equal repeats; each call timed in turns with
    the float32 mode (f32, bf16, bf16, f32) beside its bound at the bf16
    peak with 2-byte records, with kernel 5's bf16 mode's times."""
    import dataclasses
    import numpy as np
    import torch
    from wavenet_torch.experiments import fused_stack as fs1
    from wavenet_torch.experiments import fused_stack2 as fs2
    from wavenet_torch.kernels import fused_stack as fs3
    from wavenet_torch.utils.flops import (H100_BF16_FLOPS, bound_ms,
                                           fused_stack_cost)

    results = {}
    for name in ("paper", "gc"):
        c = cfgs[name]
        c16 = dataclasses.replace(c, compute_dtype="bfloat16")
        L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
        args = stack_inputs(c, params[name], rng)
        B, T = args[0].shape[:2]
        w_fg, wd, _, bd = args[1:]
        dy = torch.as_tensor(rng.randn(B, T, R).astype("float32"),
                             device="cuda")
        dz = randn_cuda(rng, B, T, L * D).to(torch.bfloat16)
        dz32 = dz.float()
        yp, fgp, zp = out_p = fs2.fused_stack2_forward_reference(*args, c16)
        out32 = fs2.fused_stack2_forward_reference(*args, c)
        gp = fs2.fused_stack2_backward_reference(yp, dy, fgp, dz, w_fg, wd,
                                                 bd, c16)
        g32 = fs2.fused_stack2_backward_reference(out32[0], dy, out32[1],
                                                  dz32, w_fg, wd, bd, c)
        y1, fg1 = fs1.fused_stack_forward(*args, c16)
        out_k = [fs2.fused_stack2_forward(*args, c16) for _ in range(2)]
        g1 = fs1.fused_stack_backward(yp, fgp, dz, dy, w_fg, wd, bd, c16)
        g2 = [fs2.fused_stack2_backward(yp, dy, fgp, dz, w_fg, wd, bd, c16)
              for _ in range(2)]
        torch.cuda.synchronize()
        row = {"phase": "carry_stack_bf16", "config": name, "batch": B,
               "positions": T, "kernel": "carry_bf16", "gpu": gpu}
        for kind, backward in (("fwd", False), ("bwd", True)):
            resident, plan = fs1.device_carry_plan(c16, B, backward)
            row[f"plan_{kind}"] = {"resident_blocks": resident,
                                   "nchunk": plan.nchunk,
                                   "grid": list(plan.grid)}
        check(fg1.dtype == out_k[0][1].dtype == out_k[0][2].dtype
              == torch.bfloat16, f"{name}: the carry kernel's bf16 records "
              "are not bf16")
        teacher_forced_bf16(row, c16, args, *out_k[0])
        fwd = max(hold_bf16(row, n, a, b, r) for n, a, b, r in
                  zip(("y", "fg", "z"), out_k[0], out_p, out32))
        err = {"fwd_v1": fwd, "fwd_v2": fwd,
               "bwd": max(hold_bf16(row, n, a, b, r) for n, a, b, r in
                          zip(GRAD_NAMES, g1, gp, g32))}
        check(torch.equal(y1, out_k[0][0]) and torch.equal(fg1, out_k[0][1]),
              f"{name} bf16: v1's y and fg differ from v2's")
        check(all(torch.equal(a, b) for a, b in zip(*out_k)),
              f"{name} bf16: two forward calls on the same inputs differ")
        check(all(torch.equal(a, b) for a, b in zip(g1, g2[0]))
              and all(torch.equal(a, b) for a, b in zip(*g2)),
              f"{name} bf16: two backward calls on the same inputs differ")
        row["bitwise_repeat"] = True
        del out_k, g1, g2, gp, g32

        y32, fg32 = out32[0], out32[1]
        timed = {
            "fwd_v1": (lambda m: fs1.fused_stack_forward(
                *args, c16 if m == "bf16" else c),
                lambda: fs2.fused_stack2_forward_reference(*args, c16),
                lambda: fs3.forward(*args, c16), False, False),
            "fwd_v2": (lambda m: fs2.fused_stack2_forward(
                *args, c16 if m == "bf16" else c),
                lambda: fs2.fused_stack2_forward_reference(*args, c16),
                lambda: fs3.forward(*args, c16), False, True),
            "bwd": (lambda m: (
                fs2.fused_stack2_backward(yp, dy, fgp, dz, w_fg, wd, bd, c16)
                if m == "bf16" else fs2.fused_stack2_backward(
                    y32, dy, fg32, dz32, w_fg, wd, bd, c)),
                lambda: fs2.fused_stack2_backward_reference(
                    yp, dy, fgp, dz, w_fg, wd, bd, c16),
                lambda: fs3.backward(yp, dy, fgp, dz, w_fg, wd, bd, c16),
                True, True),
        }
        modes = ("f32", "bf16")
        for kind, (kern, plain, k5, backward, emit_z) in timed.items():
            flops, nbytes = fused_stack_cost(c16, B, T, backward=backward,
                                             emit_z=emit_z)
            bound, by = bound_ms(flops, nbytes, H100_BF16_FLOPS)
            ms = {m: [] for m in modes}
            for _ in range(STACK_TIMED_ROUNDS):
                for m in modes + modes[::-1]:
                    ms[m].append(cuda_ms(lambda: kern(m)))
            ms = {m: float(np.median(v)) for m, v in ms.items()}
            ms_p, ms_5 = median_cuda_ms(plain), median_cuda_ms(k5)
            row.update({f"{kind}_ms_bf16": ms["bf16"],
                        f"{kind}_ms_f32_mode": ms["f32"],
                        f"{kind}_plain_ms": ms_p,
                        f"{kind}_kernel5_bf16_ms": ms_5,
                        f"{kind}_flops": flops, f"{kind}_bytes": nbytes,
                        f"{kind}_bound_ms_bf16": bound,
                        f"{kind}_bound_by_bf16": by})
            results[(name, kind)] = dict(
                max_abs_err=err[kind], ms=ms["bf16"], f32_mode_ms=ms["f32"],
                plain_ms=ms_p, kernel5_bf16_ms=ms_5, bound_ms=bound,
                bound_by=by)
        emit(row)
        del args, dy, dz, dz32, out_p, out32, yp, fgp, zp, y32, fg32, y1, fg1
        torch.cuda.empty_cache()
    return results


def train_batches(c, rng, n_steps: int):
    """``n_steps`` b8 batches of seeded sines plus noise, and GC ids."""
    import torch
    B, n = TRAIN_BATCH, c.receptive_field + TRAIN_SAMPLES
    t = torch.arange(n, device="cuda", dtype=torch.float32) / c.sample_rate
    out = []
    for _ in range(n_steps):
        freqs = torch.as_tensor(rng.uniform(100, 400, (B, 1)).astype(
            "float32"), device="cuda")
        noise = torch.as_tensor(rng.randn(B, n).astype("float32"),
                                device="cuda")
        ids = torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                              device="cuda")
        out.append((0.5 * torch.sin(2 * 3.14159265 * freqs * t)
                    + 0.05 * noise, ids))
    return out


def phase_carry_train(c, params, rng, gpu):
    """Phase 7 (b), the main path of this slice: Adam steps through
    ``train_lib.make_train_step`` with ``pallas_stack_version`` 1 and 2,
    from the same params and batches as version 3's steps, at float32 and
    at bf16 (``compute_dtype="bfloat16"``: the carry kernel's bf16 mode
    behind v1 and v2, kernel 5's behind v3). Each version's losses against
    version 3's: at float32 within 1e-5 (first) and 1e-4 relative; at bf16
    within bf16's own gap, the largest distance of version 3's bf16 losses
    from its float32 ones over the steps (another float32 sum order flips
    bf16 roundings, and v1 returns a z rounded once more, as in JAX: the
    CPU tests measure v1 at ~0.25 of that gap from v3 in both packages).
    Returns each wrapper's launches by dtype, counted from 0 on its
    version's run."""
    import dataclasses
    import numpy as np
    from wavenet_torch import train_lib as tl
    from wavenet_torch.experiments import fused_stack as fs1
    from wavenet_torch.experiments import fused_stack2 as fs2

    batches = train_batches(c, rng, CARRY_TRAIN_STEPS)
    wrappers = (fs1.fused_stack_forward, fs1.fused_stack_backward,
                fs2.fused_stack2_forward, fs2.fused_stack2_backward)
    n = CARRY_TRAIN_STEPS
    losses, times, launches = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        key = "carry_bf16" if dtype == "bfloat16" else "carry"
        for version in (3, 1, 2):
            cfg = dataclasses.replace(c, use_pallas_stack=True,
                                      pallas_stack_version=version,
                                      compute_dtype=dtype)
            state = tl.train_state_from_params(
                params, tl.make_optimizer("adam", 1e-3))
            step = tl.make_train_step(cfg)
            for w in wrappers:
                w.launches = 0                     # the main path starts
                w.launches_by.clear()
            run = (dtype, version)
            losses[run], times[run] = [], []
            for audio, ids in batches:
                t0 = time.perf_counter()
                _, m = step(state, audio, ids)
                losses[run].append(m["loss"].item())
                times[run].append(1e3 * (time.perf_counter() - t0))
            launches[run] = [w.launches_by[key] for w in wrappers]
            check([w.launches for w in wrappers] == launches[run],
                  f"{dtype} v{version}: carry launches in another mode: "
                  f"{[dict(w.launches_by) for w in wrappers]}")
            del state
        check(launches[(dtype, 1)] == [n, n, 0, 0]
              and launches[(dtype, 2)] == [0, 0, n, n]
              and launches[(dtype, 3)] == [0, 0, 0, 0],
              f"{dtype}: carry kernel launches "
              f"{ {v: launches[(dtype, v)] for v in (3, 1, 2)} }, expected "
              f"{n} forward and {n} backward per version")
    for version in (1, 2):
        got, want = losses[("float32", version)], losses[("float32", 3)]
        check(all(np.isfinite(got)), f"v{version}: non-finite loss {got}")
        check(got[-1] < got[0], f"v{version}: loss did not fall: {got}")
        check(abs(got[0] - want[0]) <= 1e-5 * abs(want[0]),
              f"v{version}: first loss {got[0]} against version 3's "
              f"{want[0]}")
        check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(got, want)),
              f"v{version}: losses {got} against version 3's {want}")
    l16_3, l32_3 = losses[("bfloat16", 3)], losses[("float32", 3)]
    gap = max(abs(a - b) for a, b in zip(l16_3, l32_3))
    bf16_dist = {}
    for version in (3, 1, 2):
        got = losses[("bfloat16", version)]
        check(all(np.isfinite(got)), f"bf16 v{version}: non-finite loss "
              f"{got}")
        check(got[-1] < got[0], f"bf16 v{version}: loss did not fall: {got}")
        dist = max(abs(a - b) for a, b in zip(got, l16_3))
        bf16_dist[f"v{version}"] = dist
        check(dist <= gap, f"bf16 v{version}: losses {got} lie {dist} from "
              f"version 3's bf16 losses {l16_3}, beyond bf16's own gap "
              f"{gap} (version 3 at float32: {l32_3})")
    runs = [(d, v) for d in ("float32", "bfloat16") for v in (3, 1, 2)]
    tag = {"float32": "", "bfloat16": "_bf16"}
    emit({"phase": "carry_train", "config": "gc", "batch": TRAIN_BATCH,
          "audio_samples": c.receptive_field + TRAIN_SAMPLES,
          "losses": {f"v{v}{tag[d]}": losses[(d, v)] for d, v in runs},
          "step_ms": {f"v{v}{tag[d]}": times[(d, v)] for d, v in runs},
          "step_ms_median_after_first": {
              f"v{v}{tag[d]}": float(np.median(times[(d, v)][1:]))
              for d, v in runs},
          "bf16_gap_of_v3": gap, "bf16_loss_distance_from_v3": bf16_dist,
          "launches": {f"v{v}_{k}{tag[d]}": launches[(d, v)][i]
                       for d in ("float32", "bfloat16")
                       for v, k, i in ((1, "fwd", 0), (1, "bwd", 1),
                                       (2, "fwd", 2), (2, "bwd", 3))},
          "gpu": gpu})
    return {("bf16" if d == "bfloat16" else "f32"): {
        "fwd_v1": launches[(d, 1)][0], "fwd_v2": launches[(d, 2)][2],
        "bwd": launches[(d, 1)][1] + launches[(d, 2)][3]}
        for d in ("float32", "bfloat16")}


def v1_stack_check(name, c32, B, samples, kernel, rng, gpu):
    """The retired v1 stack at the ``name`` config (where the carry kernel
    is not built) on the kernel 5 kernel its route takes (``kernel``), at
    the train shape B x (receptive field + ``samples`` - 1), in each mode:
    v1's forward (y, fg) and backward against v1's plain versions on the
    same inputs (f32 within phase 5's tolerances and slices; bf16 on the
    scale of bf16's distance from the plain float32 versions), bitwise
    equal to kernel 5's own launches on those inputs, repeats bitwise
    equal; each direction timed beside v1's bound (no z record written)
    and the plain version's time. One ``v1_stack`` row; returns {(mode,
    kind): the kernels line's numbers}."""
    import dataclasses
    import torch
    from wavenet_torch.experiments import fused_stack as fs1
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.utils.flops import (H100_BF16_FLOPS,
                                           H100_TF32X3_FLOPS, bound_ms,
                                           fused_stack_cost)

    t0 = time.perf_counter()
    c16 = dataclasses.replace(c32, compute_dtype="bfloat16")
    cfg = {"f32": c32, "bf16": c16}
    peak = {"f32": H100_TF32X3_FLOPS, "bf16": H100_BF16_FLOPS}
    L, R, D = c32.num_layers, c32.residual_channels, c32.dilation_channels
    check(all(fs1.v1_kernel_plan(c) == kernel for c in cfg.values()),
          f"v1's route does not send {name} to {kernel}")
    args = stack_inputs(c32, seeded_params(c32, 6, "cuda"), rng, B, samples)
    T = args[0].shape[1]
    w_fg, wd, _, bd = args[1:]
    # dz in bf16's values, so that the float32 gradients are the bf16
    # gradients' yardstick on the same cotangent.
    dy = randn_cuda(rng, B, T, R)
    dz = randn_cuda(rng, B, T, L * D).to(torch.bfloat16).float()
    row = {"phase": "v1_stack", "config": name, "kernel": kernel,
           "batch": B, "positions": T, "layers": L, "gpu": gpu}
    ref32 = {}
    results = {}
    for m, c in cfg.items():
        y_p, fg_p = fs1.fused_stack_forward_reference(*args, c)
        g_p = fs1.fused_stack_backward_reference(y_p, fg_p, dz, dy, w_fg, wd,
                                                 bd, c)
        out = [fs1.fused_stack_forward(*args, c) for _ in range(2)]
        g = [fs1.fused_stack_backward(y_p, fg_p, dz, dy, w_fg, wd, bd, c)
             for _ in range(2)]
        torch.cuda.synchronize()
        err = {}
        if m == "f32":
            err["fwd"] = max(hold(row, f"{n}_f32", a, b, FWD_RTOL, FWD_ATOL)
                             for n, a, b in zip(("y", "fg"), out[0],
                                                (y_p, fg_p)))
            err["bwd"] = max(
                hold(row, f"{n}_f32", a.reshape(b.shape), b, GRAD_RTOL,
                     GRAD_ATOL, lead)
                for n, a, b, lead in zip(GRAD_NAMES, g[0], g_p, GRAD_LEADS))
            ref32 = {"fwd": (y_p, fg_p), "bwd": g_p}
        else:
            err["fwd"] = max(hold_bf16(row, n, a, b, r) for n, a, b, r in
                             zip(("y", "fg"), out[0], (y_p, fg_p),
                                 ref32["fwd"]))
            err["bwd"] = max(hold_bf16(row, n, a, b, r) for n, a, b, r in
                             zip(GRAD_NAMES, g[0], g_p, ref32["bwd"]))
        y5, fg5, _ = fs.forward(*args, c, kernel=kernel)
        g5 = fs.backward(y_p, dy, fg_p, dz, w_fg, wd, bd, c, kernel=kernel)
        torch.cuda.synchronize()
        check(torch.equal(out[0][0], y5) and torch.equal(out[0][1], fg5)
              and all(torch.equal(a.reshape(b.shape), b)
                      for a, b in zip(g[0], g5)),
              f"{name} v1 {m}: outputs differ from kernel 5's {kernel}")
        check(all(torch.equal(a, b) for a, b in zip(*out))
              and all(torch.equal(a, b) for a, b in zip(*g)),
              f"{name} v1 {m}: two calls on the same inputs differ")
        del out, g, g5, y5, fg5
        calls = {"fwd": lambda: fs1.fused_stack_forward(*args, c),
                 "bwd": lambda: fs1.fused_stack_backward(
                     y_p, fg_p, dz, dy, w_fg, wd, bd, c)}
        plain = {"fwd": lambda: fs1.fused_stack_forward_reference(*args, c),
                 "bwd": lambda: fs1.fused_stack_backward_reference(
                     y_p, fg_p, dz, dy, w_fg, wd, bd, c)}
        for kind in ("fwd", "bwd"):
            t = median_cuda_ms(calls[kind], reps=3)
            t_p = median_cuda_ms(plain[kind], reps=3)
            flops, nbytes = fused_stack_cost(c, B, T, backward=kind == "bwd",
                                             emit_z=False)
            bound, by = bound_ms(flops, nbytes, peak[m])
            row.update({f"{kind}_ms_{m}": t, f"{kind}_plain_ms_{m}": t_p,
                        f"{kind}_bound_ms_{m}": bound,
                        f"{kind}_bound_by_{m}": by})
            results[m, kind] = dict(
                config=name, batch=B, positions=T, ms=t, bound_ms=bound,
                bound_by=by, max_abs_err=err[kind], plain_ms=t_p)
        del y_p, fg_p, g_p
        torch.cuda.empty_cache()
    row.update({"bitwise_kernel5": True, "bitwise_repeat": True,
                "seconds": time.perf_counter() - t0})
    emit(row)
    del args, dy, dz, ref32
    torch.cuda.empty_cache()
    return results


def v1_batches(c, rng, B: int, samples: int, n_steps: int):
    """``n_steps`` batches of B rows of seeded sines plus noise, rf +
    ``samples`` long, and GC ids (None without GC)."""
    import torch
    n = c.receptive_field + samples
    t = torch.arange(n, device="cuda", dtype=torch.float32) / c.sample_rate
    out = []
    for _ in range(n_steps):
        freqs = torch.as_tensor(rng.uniform(100, 400, (B, 1)).astype(
            "float32"), device="cuda")
        noise = torch.as_tensor(rng.randn(B, n).astype("float32"),
                                device="cuda")
        ids = (torch.as_tensor(rng.randint(0, c.gc_cardinality, (B,)),
                               device="cuda") if c.gc_enabled else None)
        out.append((0.5 * torch.sin(2 * 3.14159265 * freqs * t)
                    + 0.05 * noise, ids))
    return out


def phase_v1_train(rng, gpu):
    """Phase 7 (e), the main path of v1 at full width: at each of
    V1_CASES, V1_STEPS Adam steps through ``train_lib.make_train_step``
    with ``pallas_stack_version`` 1 and 3, from the same params and
    batches, at float32 and at bf16; each v1 run's losses against v3's by
    ``phase_carry_train``'s rules (finite, and the last below the first;
    f32: the first within 1e-5 and every step within 1e-4 relative; bf16:
    every step within bf16's own gap, the largest distance of v3's bf16
    losses from its float32 ones), every v1 stack call on its route's
    kernel (``launches_by`` "v1_<kernel>[_bf16]", counted from 0) and none
    counted on kernel 5's wrappers; the middle step timed. Returns
    {(config, mode): {"fwd": launches, "bwd": launches}}."""
    import dataclasses
    import numpy as np
    import torch
    from wavenet_torch import train_lib as tl
    from wavenet_torch.experiments import fused_stack as fs1
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.models.config import sharded_config, wide_config

    cfgs = {"wide": wide_config(), "sharded": sharded_config()}
    wrappers = (fs1.fused_stack_forward, fs1.fused_stack_backward,
                fs.forward, fs.backward)
    out = {}
    for name, B, samples, kernel in V1_CASES:
        c = cfgs[name]
        params = seeded_params(c, 7, "cuda")
        batches = v1_batches(c, rng, B, samples, V1_STEPS)
        losses, times = {}, {}
        for dtype in ("float32", "bfloat16"):
            for version in (3, 1):
                cfg = dataclasses.replace(c, use_pallas_stack=True,
                                          pallas_stack_version=version,
                                          compute_dtype=dtype)
                state = tl.train_state_from_params(
                    params, tl.make_optimizer("adam", 1e-3))
                step = tl.make_train_step(cfg)
                for w in wrappers:
                    w.launches = 0                 # the main path starts
                    w.launches_by.clear()
                run = (dtype, version)
                losses[run], times[run] = [], []
                for audio, ids in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, audio, ids)
                    losses[run].append(m["loss"].item())
                    times[run].append(1e3 * (time.perf_counter() - t0))
                del state, step
                torch.cuda.empty_cache()
                n1 = [dict(w.launches_by) for w in wrappers[:2]]
                n3 = [w.launches for w in wrappers[2:]]
                if version == 1:
                    key = fs.launch_key(f"v1_{kernel}", cfg)
                    check(n1 == [{key: V1_STEPS}] * 2 and n3 == [0, 0],
                          f"{name} {dtype} v1: stack launches {n1}, kernel "
                          f"5 counted {n3}; expected {V1_STEPS} {key} "
                          "each way")
                    out[name, "bf16" if dtype == "bfloat16" else "f32"] = {
                        "fwd": n1[0][key], "bwd": n1[1][key]}
                else:
                    check(n3 == [V1_STEPS] * 2, f"{name} {dtype} v3: "
                          f"kernel 5 launches {n3}")
        got, want = losses[("float32", 1)], losses[("float32", 3)]
        check(all(np.isfinite(got)), f"{name} v1: non-finite loss {got}")
        check(got[-1] < got[0], f"{name} v1: loss did not fall: {got}")
        check(abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
              and all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(got, want)),
              f"{name} v1: losses {got} against version 3's {want}")
        l16_3 = losses[("bfloat16", 3)]
        gap = max(abs(a - b) for a, b in zip(l16_3, want))
        got16 = losses[("bfloat16", 1)]
        dist = max(abs(a - b) for a, b in zip(got16, l16_3))
        check(all(np.isfinite(got16)), f"{name} bf16 v1: non-finite loss "
              f"{got16}")
        check(got16[-1] < got16[0], f"{name} bf16 v1: loss did not fall: "
              f"{got16}")
        check(dist <= gap, f"{name} bf16 v1: losses {got16} lie {dist} from "
              f"version 3's bf16 losses {l16_3}, beyond bf16's own gap "
              f"{gap} (version 3 at float32: {want})")
        tag = {"float32": "", "bfloat16": "_bf16"}
        emit({"phase": "v1_train", "config": name, "batch": B,
              "audio_samples": c.receptive_field + samples,
              "kernel": kernel,
              "losses": {f"v{v}{tag[d]}": losses[(d, v)] for d, v in losses},
              "step_ms": {f"v{v}{tag[d]}": times[(d, v)] for d, v in times},
              "middle_step_ms": {f"v{v}{tag[d]}": times[(d, v)][1]
                                 for d, v in times},
              "bf16_gap_of_v3": gap, "bf16_loss_distance_v1_from_v3": dist,
              "launches": {f"{k}_{m}": v for (n_, m), r in out.items()
                           if n_ == name for k, v in r.items()},
              "gpu": gpu})
        del params, batches
        torch.cuda.empty_cache()
    return out


def phase_dilated_layer_wide(c, rng, gpu):
    """Phase 7 (c) at the widths the layer kernel is not built for: kernel
    8 on ``fused_stack_tiled``'s layer entries at each of LAYER_WIDE, at
    the gc config's train shape (b8 x receptive field + 16,000 - 1),
    dilation LAYER_WIDE_DILATION, in each mode: forward and backward
    against the plain versions (bf16 by the layer's rule, on bf16's gap
    from the plain float32 versions), repeats bitwise equal, timed in
    turns (f32, bf16, bf16, f32) beside the plain versions and the bounds;
    then the op (``fused_dilated_layer`` under autograd) once a mode, its
    launches counted from 0. Returns {(R, D, mode, kind): the kernels
    line's numbers}."""
    import numpy as np
    import torch
    from wavenet_torch.experiments import dilated_layer as dl
    from wavenet_torch.utils.flops import (H100_BF16_FLOPS,
                                           H100_TF32X3_FLOPS, bound_ms,
                                           dilated_layer_cost)

    B, T, d = TRAIN_BATCH, c.receptive_field + TRAIN_SAMPLES - 1, \
        LAYER_WIDE_DILATION
    modes = {"f32": torch.float32, "bf16": torch.bfloat16}
    peak = {"f32": H100_TF32X3_FLOPS, "bf16": H100_BF16_FLOPS}
    names = ("y", "z", "dx_local", "dpast", "dw", "dwd", "dadd", "dbd")
    out = {}
    for R, D in LAYER_WIDE:
        check(dl.layer_kernel_plan(R, D) == "tiled",
              f"the layer route does not send ({R}, {D}) to the tiled "
              "kernel")

        def rn(*shape, scale=1.0):
            return randn_cuda(rng, *shape) * scale

        ws = lambda fan: 0.3 * min(1.0, (32 / fan) ** 0.5)  # noqa: E731
        lay = (rn(B, T, R, scale=0.5), rn(2, R, 2 * D, scale=ws(R)),
               rn(D, R, scale=ws(D)), rn(B, 2 * D, scale=0.1),
               rn(1, R, scale=0.1))
        dy, dz = rn(B, T, R), rn(B, T, D)
        row = {"phase": "dilated_layer_wide", "config": f"gc r{R} d{D}",
               "batch": B, "positions": T, "dilation": d, "gpu": gpu}
        refs = {}
        worst = {}
        for m, cd in modes.items():
            yz = [dl.forward(*lay, d, cd) for _ in range(2)]
            g = [dl.backward(*lay[:4], dy, dz, d, cd) for _ in range(2)]
            refs[m] = (dl.fused_dilated_layer_reference(
                *lay, d, compute_dtype=cd)
                + dl.fused_dilated_layer_backward_reference(
                    *lay[:4], dy, dz, d, compute_dtype=cd))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(*yz))
                  and all(torch.equal(a, b) for a, b in zip(*g)),
                  f"dilated_layer ({R}, {D}) {m}: two calls differ")
            got = tuple(yz[0]) + tuple(g[0])
            if m == "f32":
                errs = [hold(row, n, a, b, FWD_RTOL if i < 2 else GRAD_RTOL,
                             FWD_ATOL if i < 2 else GRAD_ATOL)
                        for i, (n, a, b) in enumerate(zip(names, got,
                                                          refs[m]))]
            else:
                hrow = {"config": row["config"]}
                errs = [hold_bf16(hrow, n, a, b, r) for n, a, b, r in
                        zip(names, got, refs[m], refs["f32"])]
                row.update({f"{k}_bf16": v for k, v in hrow.items()
                            if k != "config"})
            worst[m, "fwd"], worst[m, "bwd"] = max(errs[:2]), max(errs[2:])
            del yz, g
        row["bitwise_repeat"] = True
        for kind in ("fwd", "bwd"):
            t = {m: [] for m in modes}
            for m in ("f32", "bf16", "bf16", "f32"):
                cd = modes[m]
                fn = ((lambda: dl.forward(*lay, d, cd)) if kind == "fwd" else
                      (lambda: dl.backward(*lay[:4], dy, dz, d, cd)))
                t[m].append(median_cuda_ms(fn, reps=3))
            flops, nbytes = dilated_layer_cost(R, D, B, T,
                                               backward=kind == "bwd")
            for m, cd in modes.items():
                tp = median_cuda_ms(
                    (lambda: dl.fused_dilated_layer_reference(
                        *lay, d, compute_dtype=cd)) if kind == "fwd" else
                    (lambda: dl.fused_dilated_layer_backward_reference(
                        *lay[:4], dy, dz, d, compute_dtype=cd)), reps=3)
                bound, by = bound_ms(flops, nbytes, peak[m])
                ms = float(np.mean(t[m]))
                row.update({f"{kind}_ms_{m}": ms, f"{kind}_plain_ms_{m}": tp,
                            f"{kind}_bound_ms_{m}": bound,
                            f"{kind}_bound_by_{m}": by})
                out[R, D, m, kind] = dict(max_abs_err=worst[m, kind], ms=ms,
                                          plain_ms=tp, bound_ms=bound,
                                          bound_by=by)
        for m, cd in modes.items():
            dl.forward.launches = dl.backward.launches = 0   # the main path
            dl.forward.launches_by.clear()
            dl.backward.launches_by.clear()
            leaves = [t.clone().requires_grad_(True) for t in lay]
            y, z = dl.fused_dilated_layer(*leaves, d, compute_dtype=cd)
            ((y * dy).sum() + (z * dz).sum()).backward()
            torch.cuda.synchronize()
            by = {"fwd": dict(dl.forward.launches_by),
                  "bwd": dict(dl.backward.launches_by)}
            want = {f"tiled_{m}": 1}
            check(by == {"fwd": want, "bwd": want},
                  f"dilated_layer ({R}, {D}) {m} op launched {by}")
            row[f"op_launches_{m}"] = by
            for kind in ("fwd", "bwd"):
                out[R, D, m, kind]["launches"] = by[kind][f"tiled_{m}"]
            del leaves, y, z
        emit(row)
        del lay, dy, dz, refs
        torch.cuda.empty_cache()
    return out


def phase_dilated_layer(c, params, rng, gpu):
    """Phase 7 (c): kernel 8 in each mode (3xTF32, or one bf16 pass a
    product) at each distinct dilation against its plain versions (bf16:
    on bf16's gap from the plain float32 versions), its backward bitwise
    repeatable, timed in turns (f32, bf16, bf16, f32); then a stack of
    ``fused_dilated_layer`` calls under autograd in each mode, its launches
    counted from 0 by mode: at float32 against kernel 5, at bf16 against
    the plain bf16 layer stack, with its distance from kernel 5's bf16
    mode recorded (another function: kernel 8 rounds the residual to bf16
    at every layer, as its TPU wrapper does, kernel 5 keeps it float32)."""
    import dataclasses
    import numpy as np
    import torch
    from wavenet_torch.experiments import dilated_layer as dl
    from wavenet_torch.kernels import fused_stack as fs3
    from wavenet_torch.utils.flops import (H100_BF16_FLOPS,
                                           H100_TF32X3_FLOPS, bound_ms,
                                           dilated_layer_cost)

    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    x, w_fg, wd, add, bd = stack_inputs(c, params, rng)
    B, T = x.shape[:2]
    dy = torch.as_tensor(rng.randn(B, T, R).astype("float32"), device="cuda")
    dz = randn_cuda(rng, B, T, L * D)
    row = {"phase": "dilated_layer", "config": "gc", "batch": B,
           "positions": T, "gpu": gpu}
    modes = {"f32": torch.float32, "bf16": torch.bfloat16}
    # The grid of each mode and direction: resident blocks, chunks a row,
    # tiles a chunk (the library's count, held against the pure mirror).
    lib = dl._lib()
    for mode, cd in modes.items():
        for kind, backward in (("fwd", False), ("bwd", True)):
            n, tl = dl.device_layer_tiling(backward, B, T, R, D, cd)
            check(tl.nchunk == lib.dilated_layer_nchunk(
                int(backward), B, T, R, D, int(mode == "bf16")),
                f"dilated_layer {mode} {kind}: layer_tiling differs from "
                "the library")
            key = f"plan_{kind}" + ("" if mode == "f32" else "_bf16")
            row[key] = {"resident_blocks": n, "nchunk": tl.nchunk,
                        "tiles_per_chunk": tl.tiles_per_chunk}
    err = {(k, m): 0.0 for k in ("fwd", "bwd") for m in modes}
    ms = {(k, m): [] for k in ("fwd", "bwd", "fwd_plain", "bwd_plain")
          for m in modes}
    names = ("dx_local", "dpast", "dw", "dwd", "dadd", "dbd")
    for d in sorted(set(c.dilations)):
        l = c.dilations.index(d)
        lay = (x, w_fg[l].view(2, R, 2 * D), wd[l], add[l], bd[l])
        dzl = dz[..., D * l:D * (l + 1)].contiguous()
        refs = {}
        for mode, cd in modes.items():
            y, z = dl.forward(*lay, d, cd)
            yp, zp = dl.fused_dilated_layer_reference(*lay, d,
                                                      compute_dtype=cd)
            g = dl.backward(*lay[:4], dy, dzl, d, cd)
            again = dl.backward(*lay[:4], dy, dzl, d, cd)
            gp = dl.fused_dilated_layer_backward_reference(
                *lay[:4], dy, dzl, d, compute_dtype=cd)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(g, again)),
                  f"dilated_layer {mode} d={d}: two backward calls differ")
            refs[mode] = (yp, zp) + tuple(gp)
            sfx = f"_d{d}" + ("" if mode == "f32" else "_bf16")
            if mode == "f32":
                err["fwd", mode] = max(
                    err["fwd", mode],
                    hold(row, f"y{sfx}", y, yp, FWD_RTOL, FWD_ATOL),
                    hold(row, f"z{sfx}", z, zp, FWD_RTOL, FWD_ATOL))
                for label, a, b in zip(names, g, gp):
                    err["bwd", mode] = max(err["bwd", mode], hold(
                        row, f"{label}{sfx}", a, b, GRAD_RTOL, GRAD_ATOL))
            else:
                hrow = {"config": f"gc layer d={d}"}
                err["fwd", mode] = max(
                    err["fwd", mode],
                    hold_bf16(hrow, "y", y, yp, refs["f32"][0]),
                    hold_bf16(hrow, "z", z, zp, refs["f32"][1]))
                for i, (label, a, b) in enumerate(zip(names, g, gp)):
                    err["bwd", mode] = max(err["bwd", mode], hold_bf16(
                        hrow, label, a, b, refs["f32"][2 + i]))
                # The worst output of the dilation, over its max |ref|.
                for key in ("max_rel_err", "mean_rel_err"):
                    row[f"{key}{sfx}"] = max(
                        v for k, v in hrow.items() if k.startswith(key))
            del y, z, g, again, gp
        # Timed in turns: f32, bf16, bf16, f32 in each direction.
        for kind in ("fwd", "bwd"):
            t = {m: [] for m in modes}
            for m in ("f32", "bf16", "bf16", "f32"):
                cd = modes[m]
                fn = ((lambda: dl.forward(*lay, d, cd)) if kind == "fwd" else
                      (lambda: dl.backward(*lay[:4], dy, dzl, d, cd)))
                t[m].append(median_cuda_ms(fn))
            for m in modes:
                ms[kind, m].append(float(np.mean(t[m])))
        for m, cd in modes.items():
            ms["fwd_plain", m].append(median_cuda_ms(
                lambda: dl.fused_dilated_layer_reference(
                    *lay, d, compute_dtype=cd)))
            ms["bwd_plain", m].append(median_cuda_ms(
                lambda: dl.fused_dilated_layer_backward_reference(
                    *lay[:4], dy, dzl, d, compute_dtype=cd)))
        del refs
    row["bitwise_repeat_backward"] = True
    row.update({f"{k}_ms_per_dilation" + ("" if m == "f32" else "_bf16"): v
                for (k, m), v in ms.items()})

    class PlainLayer(torch.autograd.Function):
        """The op with its plain versions on the card (the bf16 stack's
        reference: the VJP that the kernel and the TPU wrapper form, which
        autograd of the plain forward is not)."""

        @staticmethod
        def forward(ctx, x_, w_, wd_, add_, bd_, d_, cd_):
            ctx.save_for_backward(x_, w_, wd_, add_)
            ctx.d, ctx.cd = d_, cd_
            return dl.fused_dilated_layer_reference(x_, w_, wd_, add_, bd_,
                                                    d_, compute_dtype=cd_)

        @staticmethod
        def backward(ctx, gy, gz):
            dxl, dp, *grads = dl.fused_dilated_layer_backward_reference(
                *ctx.saved_tensors, gy.contiguous(), gz.contiguous(), ctx.d,
                compute_dtype=ctx.cd)
            return (dl._shift_left_add(dxl, dp, ctx.d), *grads, None, None)

    # The 30-call stack under autograd, in each mode; with ``inputs``, each
    # call's input is appended to it, keeping its gradient.
    def layer_stack(fn, cd, inputs=None):
        leaves = [t.clone().requires_grad_(True) for t in (x, w_fg, wd, add,
                                                            bd)]
        lx, lw, lwd, ladd, lbd = leaves
        cur, zs = lx, []
        for l, d in enumerate(c.dilations):
            if inputs is not None:
                if l:
                    cur.retain_grad()
                inputs.append(cur)
            cur, z = fn(cur, lw[l].view(2, R, 2 * D), lwd[l], ladd[l],
                        lbd[l], d, cd)
            zs.append(z)
        zcat = torch.cat(zs, dim=-1)
        ((cur * dy).sum() + (zcat * dz).sum()).backward()
        torch.cuda.synchronize()
        return [cur.detach(), zcat.detach()] + [t.grad for t in leaves]

    y5, fg5, z5 = fs3.forward(x, w_fg, wd, add, bd, c)
    g5 = fs3.backward(y5, dy, fg5, dz, w_fg, wd, bd, c)
    stack_names = ("y", "z") + GRAD_NAMES
    launches = {}
    for mode, cd in modes.items():
        dl.forward.launches = dl.backward.launches = 0   # the main path
        dl.forward.launches_by.clear()
        dl.backward.launches_by.clear()
        xs = []
        got = layer_stack(dl.fused_dilated_layer, cd, xs)
        launches[mode] = {"fwd": dl.forward.launches,
                          "bwd": dl.backward.launches}
        by = {"fwd": dict(dl.forward.launches_by),
              "bwd": dict(dl.backward.launches_by)}
        check(launches[mode] == {"fwd": L, "bwd": L}
              and by == {"fwd": {mode: L}, "bwd": {mode: L}},
              f"dilated_layer {mode} launches {launches[mode]} ({by}) on a "
              f"{L}-layer stack")
        row["stack_launches" + ("" if mode == "f32" else "_bf16")] = by
        if mode == "f32":
            got32 = got
            hold(row, "stack_y_vs_kernel5", got[0], y5, FWD_RTOL, FWD_ATOL)
            hold(row, "stack_z_vs_kernel5", got[1], z5, FWD_RTOL, FWD_ATOL)
            for label, t, b, lead in zip(GRAD_NAMES, got[2:], g5,
                                         GRAD_LEADS):
                hold(row, f"stack_{label}_vs_kernel5", t, b, GRAD_RTOL,
                     GRAD_ATOL, lead)
            continue
        # Each call, forward and backward, on the stack's own input and
        # cotangents to it, against the plain bf16 versions (the tight
        # check: a whole stack carries every rounding flip on to later
        # layers, forward and backward).
        xs.append(got[0])
        worst = {}
        for l, d in enumerate(c.dilations):
            lay = (xs[l].detach(), w_fg[l].view(2, R, 2 * D), wd[l], add[l])
            gy = xs[l + 1].grad if l + 1 < L else dy
            gz = dz[..., D * l:D * (l + 1)]
            refs = []
            for t in (cd, torch.float32):
                yz = dl.fused_dilated_layer_reference(*lay, bd[l], d,
                                                      compute_dtype=t)
                dxl, dp, *gw = dl.fused_dilated_layer_backward_reference(
                    *lay, gy, gz, d, compute_dtype=t)
                refs.append(list(yz) + [dl._shift_left_add(dxl, dp, d)]
                            + gw)
            mine = [xs[l + 1].detach(), got[1][..., D * l:D * (l + 1)],
                    xs[l].grad, got[3][l].view(2, R, 2 * D), got[4][l],
                    got[5][l], got[6][l]]
            lrow = {"config": f"gc layer stack, layer {l}"}
            for label, a, r16, r32 in zip(stack_names, mine, *refs):
                hold_bf16(lrow, label, a, r16, r32)
            for key, v in lrow.items():
                if key.startswith(("max_rel_err", "mean_rel_err")):
                    worst[key] = max(worst.get(key, 0.0), v)
        row.update({f"stack_bf16_layer_{k}": v for k, v in worst.items()})
        del xs, refs, mine
        # The whole stack against the plain bf16 layer stack, on the scale
        # of bf16's gap from float32: recorded, and held only to
        # LAYER_STACK_SANITY (a fault of a call is O(1) of the values and
        # shows in the per-call check above).
        plain = layer_stack(PlainLayer.apply, cd)
        for label, a, b, r32 in zip(stack_names, got, plain, got32):
            dev, gap = (a - b).abs(), (b - r32).abs()
            ratios = (dev.mean().item() / gap.mean().item(),
                      dev.max().item() / gap.max().item())
            row[f"stack_bf16_{label}_err_over_gap_mean_max"] = ratios
            check(torch.isfinite(a).all().item()
                  and all(r <= q for r, q in zip(ratios, LAYER_STACK_SANITY)),
                  f"gc bf16 layer stack {label}: {ratios} of bf16's gap from "
                  f"the plain bf16 layer stack (mean, max), beyond "
                  f"{LAYER_STACK_SANITY}")
        # Kernel 5's bf16 mode on the same inputs: the distance recorded,
        # on the scale of kernel 5's own bf16 gap from float32.
        c16 = dataclasses.replace(c, compute_dtype="bfloat16")
        y16, fg16, z16 = fs3.forward(x, w_fg, wd, add, bd, c16)
        g16 = fs3.backward(y16, dy, fg16, dz.to(torch.bfloat16), w_fg, wd,
                           bd, c16)
        for label, a, k16, k32 in zip(stack_names, got,
                                      [y16, z16.float()] + list(g16),
                                      [y5, z5] + list(g5)):
            scale = k16.abs().max().item()
            row[f"stack_bf16_{label}_vs_kernel5_bf16_max_rel"] = (
                (a - k16).abs().max().item() / scale)
            row[f"stack_bf16_{label}_vs_kernel5_bf16_mean_rel"] = (
                (a - k16).abs().mean().item() / scale)
            row[f"kernel5_bf16_{label}_gap_mean_rel"] = (
                (k16 - k32).abs().mean().item() / scale)
        del plain, y16, fg16, z16, g16
    emit(row)
    out = {}
    for mode in modes:
        for kind in ("fwd", "bwd"):
            flops, nbytes = dilated_layer_cost(R, D, B, T,
                                               backward=kind == "bwd")
            # The f32 mode multiplies in 3xTF32 on the tensor cores, the
            # bf16 mode in one bf16 pass; both read and write float32.
            bound, by = bound_ms(flops, nbytes, H100_TF32X3_FLOPS
                                 if mode == "f32" else H100_BF16_FLOPS)
            out[kind, mode] = dict(
                launches=launches[mode][kind], max_abs_err=err[kind, mode],
                ms=float(np.mean(ms[kind, mode])),
                plain_ms=float(np.mean(ms[f"{kind}_plain", mode])),
                f32_mode_ms=float(np.mean(ms[kind, "f32"])),
                bound_ms=bound, bound_by=by)
    del got32
    torch.cuda.empty_cache()
    return out


def probe_hold(row, label, got, ref, bf16: bool) -> float:
    """A probe's output against its plain version: within phase 5's
    forward tolerance at float32; at bf16 within PROBE_BF16_RTOL of max
    |ref| and, on the mean, PROBE_BF16_MEAN_RTOL of mean |ref|. Records
    the errors in ``row``."""
    import torch
    got, ref = got.float(), ref.float()
    where = " ".join(str(row[k]) for k in ("probe", "kernel", "config",
                                           "variant", "mode", "tile",
                                           "dtype") if k in row)
    where = f"{where} {label}"
    check(torch.isfinite(got).all().item(), f"{where}: non-finite output")
    rtol, atol = (PROBE_BF16_RTOL, 0.0) if bf16 else (FWD_RTOL, FWD_ATOL)
    err, rel, ok = within(got, ref, rtol, atol)
    row[f"max_abs_err_{label}"] = err
    row[f"max_rel_err_{label}"] = rel
    check(ok, f"{where}: differs from its plain version by {err} ({rel} "
          "of max |ref|)")
    if bf16:
        mean = ((got - ref).abs().mean() / ref.abs().mean()).item()
        row[f"mean_rel_err_{label}"] = mean
        check(mean <= PROBE_BF16_MEAN_RTOL, f"{where}: mean error {mean} "
              "of mean |ref|")
    return err


def probe_bound(flops: float, nbytes: float, peak: float):
    """(bound ms, "bytes" or "operations") at the operations' ``peak``."""
    from wavenet_torch.utils.flops import bound_ms
    return bound_ms(flops, nbytes, peak, HBM_BYTES_PER_S)


def simt_peak(bf16: bool) -> float:
    """The peak of the FP32-core probes: FP32, or the bf16 one for bf16
    operands (rows 9a/9b, 10)."""
    return BF16_FLOPS if bf16 else FP32_FLOPS


def mma_peak(bf16: bool) -> float:
    """The peak of the tensor-core probes (rows 9c/9d): 3xTF32, or bf16."""
    from wavenet_torch.utils.flops import H100_BF16_FLOPS, H100_TF32X3_FLOPS
    return H100_BF16_FLOPS if bf16 else H100_TF32X3_FLOPS


def fwd_bisect_cost(c, B: int, T: int, variant: str, bf16: bool):
    """(FLOPs, bytes) of one r2 variant call: both products of every layer
    (every variant runs them), x in and y out in float32, the weights in
    the operand type, the adds, and the fg and z records where written."""
    from wavenet_torch.tools import r2_fwd_bisect as r2
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    rows, esz = B * T, 2 if bf16 else 4
    flops = 2.0 * rows * L * (2 * R * 2 * D + D * R)
    nbytes = (8.0 * rows * R + esz * L * (4 * R * D + D * R)
              + 4 * L * (B * 2 * D + R))
    if r2.writes_records(variant):
        nbytes += esz * rows * L * 3 * D
    return flops, nbytes


def fwd_bisect2_cost(c, B: int, T: int, variant: str, bf16: bool):
    """(FLOPs, bytes) of one r2b variant launch: its products (act_only:
    four operations an element a layer), x in and y out, its weights."""
    L, R, D = c.num_layers, c.residual_channels, c.dilation_channels
    rows, esz = B * T, 2 if bf16 else 4
    if variant == "act_only":
        return 4.0 * rows * L * R, 8.0 * rows * R
    if variant.startswith("fat"):
        k, n = 2 * R + 2 * D, 2 * D + R
        return 2.0 * rows * L * k * n, 8.0 * rows * R + esz * L * k * n
    per = 4 * R * D + D * R
    return 2.0 * rows * L * per, 8.0 * rows * R + esz * L * per


def phase_fwd_bisect(cfgs, params, rng, gpu):
    """Phase 8 (a): the stack's forward by r2 variant and its core math by
    r2b variant, b8 x (rf + 16,000) (r2 on phase 5's stack inputs), each
    variant at float32 and bf16 against its plain version and timed: on
    the FP32 cores (TPU kernels 9a, 9b) at the paper config, ``full`` at
    float32 bitwise kernel 5's forward; on the tensor cores (9c at the
    paper and wide configs, 9d at the paper config), each repeated
    bitwise, ``full`` and ``rolled`` bitwise ``fused_stack.forward(kernel=
    "mma")`` in both modes, bounds under 3xTF32 and bf16."""
    import dataclasses

    import torch
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.tools import DTYPE_NAMES
    from wavenet_torch.tools import r2_fwd_bisect as r2
    from wavenet_torch.tools import r2_fwd_bisect2 as r2b

    c = cfgs["paper"]
    args = stack_inputs(c, params["paper"], rng)
    B, T = args[0].shape[:2]
    want = fs.forward(*args, c, kernel="simt")
    got = r2.fwd_bisect(*args, c, "full", kernel="simt")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "fwd_bisect full (float32) differs from kernel 5's forward")
    emit({"phase": "probe", "probe": "r2_fwd_bisect", "config": "paper",
          "kernel": "simt", "full_f32_bitwise_kernel5": True, "gpu": gpu})
    del got, want
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt, bf16 = DTYPE_NAMES[dtype], dtype == torch.bfloat16
        for v in r2.VARIANTS:
            row = {"phase": "probe", "probe": "r2_fwd_bisect",
                   "kernel": "simt", "config": "paper", "variant": v,
                   "dtype": dt, "batch": B, "positions": T}
            got = r2.fwd_bisect(*args, c, v, dtype, kernel="simt")
            ref = r2.fwd_bisect_reference(*args, c, v, dtype, kernel="simt")
            torch.cuda.synchronize()
            err = max(probe_hold(row, n, a, b, bf16) for n, a, b in
                      zip(("y", "fg", "z"), got, ref) if a is not None)
            del got, ref
            ms = median_cuda_ms(lambda: r2.fwd_bisect(*args, c, v, dtype,
                                                      kernel="simt"))
            plain = median_cuda_ms(lambda: r2.fwd_bisect_reference(
                *args, c, v, dtype, kernel="simt"), reps=3)
            flops, nbytes = fwd_bisect_cost(c, B, T, v, bf16)
            bound, by = probe_bound(flops, nbytes, simt_peak(bf16))
            row.update(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                       flops=flops, bytes=nbytes, gpu=gpu)
            emit(row)
            results[f"{v}_{dt}"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain, bound_ms=bound,
                                         bound_by=by)
            torch.cuda.empty_cache()
    del args
    # 9c: fused_stack_mma's forward with parts masked, at both widths.
    for name, sfx in (("paper", ""), ("wide", "_w64")):
        cw = cfgs[name]
        args = stack_inputs(cw, params[name], rng)
        B, T = args[0].shape[:2]
        for dtype in (torch.bfloat16, torch.float32):
            dt, bf16 = DTYPE_NAMES[dtype], dtype == torch.bfloat16
            cm = dataclasses.replace(cw, compute_dtype="bfloat16") if bf16 \
                else cw
            want = fs.forward(*args, cm, kernel="mma")
            for v in ("full", "rolled"):
                got = r2.fwd_bisect(*args, cw, v, dtype, kernel="mma")
                torch.cuda.synchronize()
                check(all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in zip(got, want)),
                      f"fwd_bisect mma {v} {dt} ({name}) differs from "
                      "fused_stack.forward(kernel='mma')")
                del got
            emit({"phase": "probe", "probe": "r2_fwd_bisect",
                  "kernel": "mma", "config": name, "dtype": dt,
                  "full_rolled_bitwise_stack_mma": True, "gpu": gpu})
            del want
            for v in r2.VARIANTS:
                row = {"phase": "probe", "probe": "r2_fwd_bisect",
                       "kernel": "mma", "config": name, "variant": v,
                       "dtype": dt, "batch": B, "positions": T}
                got = r2.fwd_bisect(*args, cw, v, dtype, kernel="mma")
                again = r2.fwd_bisect(*args, cw, v, dtype, kernel="mma")
                torch.cuda.synchronize()
                check(all(a is None or torch.equal(a, b)
                          for a, b in zip(got, again)),
                      f"fwd_bisect mma {v} {dt} ({name}): repeats differ")
                del again
                ref = r2.fwd_bisect_reference(*args, cw, v, dtype,
                                              kernel="mma")
                torch.cuda.synchronize()
                err = max(probe_hold(row, n, a, b, bf16) for n, a, b in
                          zip(("y", "fg", "z"), got, ref) if a is not None)
                del got, ref
                ms = median_cuda_ms(lambda: r2.fwd_bisect(
                    *args, cw, v, dtype, kernel="mma"))
                plain = median_cuda_ms(lambda: r2.fwd_bisect_reference(
                    *args, cw, v, dtype, kernel="mma"), reps=1)
                flops, nbytes = fwd_bisect_cost(cw, B, T, v, bf16)
                bound, by = probe_bound(flops, nbytes, mma_peak(bf16))
                row.update(bitwise_repeat=True, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, flops=flops,
                           bytes=nbytes, gpu=gpu)
                emit(row)
                results[f"mma_{v}_{dt}{sfx}"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=by)
                torch.cuda.empty_cache()
        del args
    args = r2b.inputs(c, TRAIN_BATCH, TRAIN_SAMPLES, "cuda")
    B, T = args[0].shape[:2]
    for kernel in ("simt", "mma"):
        peak = simt_peak if kernel == "simt" else mma_peak
        pre = "" if kernel == "simt" else "mma_"
        for dtype in (torch.bfloat16, torch.float32):
            dt, bf16 = DTYPE_NAMES[dtype], dtype == torch.bfloat16
            for v in r2b.VARIANTS:
                for tile in sorted(r2b.TILES):
                    row = {"phase": "probe", "probe": "r2_fwd_bisect2",
                           "kernel": kernel, "config": "paper", "variant": v,
                           "tile": tile, "rows_per_block": r2b.TILES[tile],
                           "dtype": dt, "batch": B, "positions": T}
                    got = r2b.fwd_bisect2(*args, v, tile, dtype, kernel)
                    if kernel == "mma":
                        again = r2b.fwd_bisect2(*args, v, tile, dtype,
                                                kernel)
                        torch.cuda.synchronize()
                        check(torch.equal(got, again), f"fwd_bisect2 mma {v} "
                              f"{tile} {dt}: repeats differ")
                        row["bitwise_repeat"] = True
                    ref = r2b.fwd_bisect2_reference(*args, v, tile, dtype,
                                                    kernel)
                    torch.cuda.synchronize()
                    err = probe_hold(row, "y", got, ref, bf16)
                    ms = median_cuda_ms(lambda: r2b.fwd_bisect2(
                        *args, v, tile, dtype, kernel))
                    plain = median_cuda_ms(lambda: r2b.fwd_bisect2_reference(
                        *args, v, tile, dtype, kernel),
                        reps=3 if kernel == "simt" else 1)
                    flops, nbytes = fwd_bisect2_cost(c, B, T, v, bf16)
                    bound, by = probe_bound(flops, nbytes, peak(bf16))
                    row.update(ms=ms, plain_ms=plain, bound_ms=bound,
                               bound_by=by, gpu=gpu)
                    emit(row)
                    results[f"{pre}{v}_{tile}_{dt}"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bound, bound_by=by)
    return results


def b1_bisect_cost(c, mode: str, bf16: bool, n_steps: int):
    """(FLOPs, bytes) per step of one b1_bisect launch: the products the
    mode keeps, and the weights and adds read, the zero state in and out,
    the first code in and the codes out once per launch."""
    L, R, D, S, Q = (c.num_layers, c.residual_channels, c.dilation_channels,
                     c.skip_channels, c.quantization_channels)
    macs = {"feat": causal_rows(c) * R, "fg": L * 4 * R * D,
            "dense": L * D * R, "skip": L * D * S, "head": S * S + S * Q}
    off = {"no_skip": {"skip"}, "no_dense": {"dense"}, "no_fg": {"fg"},
           "no_head": {"head"}, "no_feat": {"feat"},
           "mm_only": {"skip", "head"}}.get(mode, set())
    flops = 2.0 * sum(v for k, v in macs.items() if k not in off)
    esz = 2 if bf16 else 4
    w = causal_rows(c) * R + L * (4 * R * D + D * R + D * S) + S * S + S * Q
    adds = L * (2 * D + R) + 2 * S + Q
    state = sum(c.dilations) * R + Q
    nbytes = esz * w + 4 * adds + 8 * state + 4 + 4 * n_steps
    return flops, nbytes / n_steps


def phase_b1_bisect(c, params, gpu):
    """Phase 8 (b): the b1 decode step by r3 mode (TPU kernel 10a) at the
    paper config on both kernels (the cluster kernel on the route's plan,
    row 10c, and sampler_decode's step, row 10a), float32 and bf16 weights:
    R3_STEPS steps from a zero state, three launches (bitwise equal), the
    codes replayed by the kernel's plain version (its order of sums) under
    the same Philox noise (>= 99.9% equal; its logits within phase 5's
    forward tolerance, or the bf16 one), ``full`` bitwise
    ``decode_sequential(kernel=<the same>)``'s codes; ms per step. The
    cluster kernel's ``full`` is timed in turns with the production launch
    (the clock's cost), and its phase clock read by CTA (one
    ``phase_cycles`` row per weight type)."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.tools import DTYPE_NAMES
    from wavenet_torch.tools import r3_b1_bisect as r3

    Q, n = c.quantization_channels, R3_STEPS
    plan = ks.device_plan(c, 1)
    check(plan is not None, "paper b1: no cluster plan on this card")
    first = torch.full((1, 1), Q // 2, dtype=torch.int32, device="cuda")
    noise = ks.gumbel_noise(R3_SEED, 1, 0, n, Q, "cuda")[:, 0]
    results = {}
    for kernel in R3_KERNELS:
        kplan = plan if kernel == "cluster" else None
        for dtype in (torch.float32, torch.bfloat16):
            dt, bf16 = DTYPE_NAMES[dtype], dtype == torch.bfloat16
            pk = ks.pack_sampler_weights(params, c, 1, weight_dtype=dtype)
            seq, _ = ks.decode_sequential(pk, c, first, n, R3_SEED,
                                          kernel=kernel)
            for mode in r3.MODES:
                row = {"phase": "probe", "probe": "r3_b1_bisect",
                       "kernel": kernel, "config": "paper", "mode": mode,
                       "dtype": dt, "steps": n}
                if kplan is not None:
                    row["plan"] = list(kplan)

                def launch(**kw):
                    return r3.b1_bisect(pk, c, mode, n, R3_SEED,
                                        kernel=kernel, **kw)

                codes, lg_k = launch(collect_logits=True)
                outs = []
                times = [cuda_ms(lambda: outs.append(launch()))
                         for _ in range(3)]
                check(all(torch.equal(codes, o) for o in outs),
                      f"b1_bisect {kernel} {mode} {dt}: same-seed launches "
                      "differ")
                row["bitwise_repeat"] = True
                check(0 <= codes.min().item() and codes.max().item() < Q,
                      f"b1_bisect {kernel} {mode} {dt}: codes out of range")
                if mode == "full":
                    check(torch.equal(codes, seq), f"b1_bisect {kernel} full "
                          f"({dt}) differs from decode_sequential")
                    row["bitwise_decode_sequential"] = True
                # The plain version teacher-forced on the kernel's inputs.
                lg = r3.b1_bisect_logits(
                    pk, c, mode, torch.cat([first, codes[:, :-1]], 1),
                    kernel=kernel, plan=kplan)
                err = probe_hold(row, "logits", lg_k, lg, bf16)
                lg = lg[0] if mode == "no_sample" else lg[0] + noise
                top2 = lg.topk(2, dim=-1).values
                match = lg.argmax(dim=-1) == codes[0].long()
                rate = match.float().mean().item()
                margin = (top2[:, 0] - top2[:, 1])[~match]
                check(rate >= 0.999, f"b1_bisect {kernel} {mode} {dt}: only "
                      f"{rate} of the codes equal the plain replay's")
                ms = float(np.median(times)) / n
                plain = cuda_ms(lambda: r3.b1_bisect_reference(
                    pk, c, mode, 2, R3_SEED, kernel=kernel,
                    plan=kplan)) / 2
                flops, nbytes = b1_bisect_cost(c, mode, bf16, n)
                bound, by = probe_bound(flops, nbytes, simt_peak(bf16))
                row.update(match_rate=rate, mismatches=int((~match).sum()),
                           max_mismatch_margin=margin.max().item()
                           if len(margin) else 0.0,
                           distinct_codes=len(torch.unique(codes)),
                           ms_per_step=ms,
                           ms_per_step_runs=[t / n for t in times],
                           plain_ms_per_step=plain, bound_ms_per_step=bound,
                           bound_by=by, gpu=gpu)
                res = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by)
                if kernel == "cluster" and mode == "full":
                    res.update(b1_cluster_turns_and_clock(
                        c, pk, plan, dtype, launch, row, gpu))
                emit(row)
                key = f"{mode}_{dt}"
                results[key if kernel == "decode" else f"cluster_{key}"] = res
    return results


def b1_cluster_turns_and_clock(c, pk, plan, dtype, launch, row, gpu):
    """The cluster probe's ``full`` (``launch``) in turns with the
    production launch of the same steps (production, probe, probe,
    production, R3_TURNS times), recorded in ``row``; then one launch with
    its phase clock read, emitted as a ``phase_cycles`` row whose phases
    add up to each CTA's step loop within PHASE_SUM_RTOL."""
    import numpy as np
    import torch
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.tools import DTYPE_NAMES
    from wavenet_torch.tools import r3_b1_bisect as r3

    n = R3_STEPS
    first = torch.full((1, 1), c.quantization_channels // 2,
                       dtype=torch.int32, device="cuda")

    def production():
        ks.decode_sequential(pk, c, first, n, R3_SEED, kernel="cluster")

    prod, probe = [], []
    for _ in range(R3_TURNS):
        prod.append(cuda_ms(production) / n)
        probe.extend(cuda_ms(launch) / n for _ in range(2))
        prod.append(cuda_ms(production) / n)
    cost = float(np.median(probe)) / float(np.median(prod)) - 1.0
    row.update(production_ms_per_step=float(np.median(prod)),
               turns_production=prod, turns_probe=probe, clock_cost=cost)
    r3.b1_bisect_phase_cycles(plan.CS, dtype)          # zero the clock
    ms = cuda_ms(launch) / n
    phases, steps = r3.b1_bisect_phase_cycles(plan.CS, dtype)
    per = phases.astype(np.float64) / n
    loop = steps.astype(np.float64) / n
    for k in range(plan.CS):
        check(abs(per[k].sum() - loop[k]) <= PHASE_SUM_RTOL * loop[k],
              f"phase clock CTA {k}: phases {per[k].sum()} against its step "
              f"{loop[k]}")
    # The last CTA's timeline: its wait holds the chain of the CTAs before.
    last = per[-1]
    chain = last[:r3.PHASES.index("dense_sync") + 1].sum()
    head = last[r3.PHASES.index("barrier1"):].sum()
    clock = {"phase": "probe", "probe": "phase_cycles",
             "kernel": "cluster", "dtype": DTYPE_NAMES[dtype],
             "plan": list(plan), "steps": n, "ms_per_step": ms,
             "clocks_per_ms": float(loop.max() / ms),
             "step_clocks": loop.tolist(),
             "clocks_per_step": {f"cta{k}": dict(zip(r3.PHASES,
                                                     per[k].tolist()))
                                 for k in range(plan.CS)},
             "chain_share_of_last_cta_step": float(chain / loop[-1]),
             "head_share_of_last_cta_step": float(head / loop[-1]),
             "phases_sum_within": PHASE_SUM_RTOL, "gpu": gpu}
    emit(clock)
    return {"production_ms": float(np.median(prod)), "clock_cost": cost,
            "step_clocks": float(loop.max())}


def phase_matvec_probe(gpu):
    """Phase 8 (c): the product forms (TPU kernel 10b) at the tool's
    C = 64 and L = 60, on 4 x orthogonal weights, on both kernels (the
    cluster form, row 10d, on the fewest CTAs that hold the weights; the
    L2 form, row 10b): each mode against its plain version over
    R4_CHECK_STEPS steps, timed over R4_STEPS. The cluster rows also give
    ns a product (a one-CTA launch of r4.ONE_CTA_L products) and ns a
    hand-off ((a step - L products) / CS)."""
    import numpy as np
    import torch
    from wavenet_torch.tools import r4_matvec_probe as r4

    C, L = r4.C, r4.L
    w = r4.orthogonal_weights(L, C).cuda()
    wt = w.transpose(1, 2).contiguous()
    w1, wt1 = w[:r4.ONE_CTA_L].contiguous(), wt[:r4.ONE_CTA_L].contiguous()
    cs = r4.cluster_split(L, C, r4.cluster_smem_optin())[0]
    results = {}
    for kernel in r4.KERNELS:
        for mode in r4.MODES:
            row = {"phase": "probe", "probe": "r4_matvec_probe",
                   "kernel": kernel, "config": "C64", "mode": mode, "C": C,
                   "L": L}
            got = r4.matvec_probe(w, wt, mode, R4_CHECK_STEPS, kernel)
            ref = r4.matvec_probe_reference(w, wt, mode, R4_CHECK_STEPS)
            torch.cuda.synchronize()
            err = hold(row, "x", got, ref, 1e-4, 1e-7)
            times = [cuda_ms(lambda: r4.matvec_probe(w, wt, mode, R4_STEPS,
                                                     kernel))
                     for _ in range(3)]
            ms = float(np.median(times)) / R4_STEPS
            plain = cuda_ms(lambda: r4.matvec_probe_reference(w, wt, mode,
                                                              4)) / 4
            flops = L * (2.0 * C * C + (C / 2 if mode.endswith("tanh")
                                        else 0))
            nbytes = (4.0 * L * C * C * (2 if mode.startswith("vpu") else 1)
                      + 4 * C)
            bound, by = probe_bound(flops, nbytes / R4_STEPS,
                                    simt_peak(False))
            row.update(ms_per_step=ms, ns_per_product=1e6 * ms / L,
                       plain_ms_per_step=plain, bound_ms_per_step=bound,
                       bound_by=by, steps=R4_STEPS, gpu=gpu)
            res = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                       bound_ms=bound, bound_by=by)
            if kernel == "cluster":
                got1 = r4.matvec_probe(w1, wt1, mode, R4_CHECK_STEPS,
                                       kernel, cs=1)
                ref1 = r4.matvec_probe_reference(w1, wt1, mode,
                                                 R4_CHECK_STEPS)
                torch.cuda.synchronize()
                hold(row, "x_one_cta", got1, ref1, 1e-4, 1e-7)
                one = float(np.median([cuda_ms(lambda: r4.matvec_probe(
                    w1, wt1, mode, R4_STEPS, kernel, cs=1))
                    for _ in range(3)])) / R4_STEPS / r4.ONE_CTA_L
                handoff = (ms - L * one) / cs
                row.update(cs=cs, ns_per_product=1e6 * one,
                           ns_per_product_one_cta_L=r4.ONE_CTA_L,
                           ns_per_handoff=1e6 * handoff)
                res.update(cs=cs, ns_per_product=1e6 * one,
                           ns_per_handoff=1e6 * handoff)
            emit(row)
            results[mode if kernel == "decode" else f"cluster_{mode}"] = res
    return results


def phase_probe_main_path(gpu):
    """Phase 8 (d), the main path of this slice: the four probe tools as a
    user runs them (``python -m wavenet_torch.tools.<name>``, here their
    ``main`` in this process; r2 also at ``--config wide``), each
    wrapper's launches counted from 0. Returns the launches by wrapper and
    key, in all and by run."""
    from wavenet_torch.tools import r2_fwd_bisect as r2
    from wavenet_torch.tools import r2_fwd_bisect2 as r2b
    from wavenet_torch.tools import r3_b1_bisect as r3
    from wavenet_torch.tools import r4_matvec_probe as r4

    wrappers = {"fwd_bisect": r2.fwd_bisect, "fwd_bisect2": r2b.fwd_bisect2,
                "b1_bisect": r3.b1_bisect, "matvec_probe": r4.matvec_probe}
    for fn in wrappers.values():           # the main path starts here
        fn.launches = 0
        fn.launches_by.clear()
    runs = (("r2_fwd_bisect", r2.main, []),
            ("r2_fwd_bisect --config wide", r2.main, ["--config", "wide"]),
            ("r2_fwd_bisect2", r2b.main, []),
            ("r3_b1_bisect", r3.main, ["--steps", str(R3_MAIN_STEPS)]),
            ("r3_b1_bisect --bf16", r3.main,
             ["--steps", str(R3_MAIN_STEPS), "--bf16"]),
            ("r4_matvec_probe", r4.main, ["--steps", str(R4_STEPS)]))
    seconds, by_run = {}, {}
    for label, main_fn, argv in runs:
        before = {k: dict(fn.launches_by) for k, fn in wrappers.items()}
        t = time.perf_counter()
        rc = main_fn(argv)
        seconds[label] = time.perf_counter() - t
        check(rc == 0, f"{label} exited {rc}")
        by_run[label] = {k: {key: n - before[k].get(key, 0)
                             for key, n in fn.launches_by.items()
                             if n > before[k].get(key, 0)}
                         for k, fn in wrappers.items()}
    launches = {k: dict(fn.launches_by) for k, fn in wrappers.items()}
    want = {"fwd_bisect": [f"{p}{v}_{d}" for p in ("", "mma_")
                           for v in r2.VARIANTS for d in ("bf16", "f32")],
            "fwd_bisect2": [f"{p}{v}_{t}_{d}" for p in ("", "mma_")
                            for v, t in r2b.MAIN_CASES
                            for d in ("bf16", "f32")],
            "b1_bisect": [f"{k}{m}_{d}" for k in ("", "cluster_")
                          for m in r3.MODES for d in ("bf16", "f32")],
            "matvec_probe": [f"{k}{m}" for k in ("", "cluster_")
                             for m in r4.MODES]}
    for k, keys in want.items():
        missing = [key for key in keys if not launches[k].get(key)]
        check(not missing, f"{k}: no launch of {missing} on the main path")
    wide = by_run["r2_fwd_bisect --config wide"]["fwd_bisect"]
    missing = [f"mma_{v}_{d}" for v in r2.VARIANTS for d in ("bf16", "f32")
               if not wide.get(f"mma_{v}_{d}")]
    check(not missing, f"fwd_bisect: no launch of {missing} at the wide "
          "config on the main path")
    emit({"phase": "probe_main_path", "seconds": seconds,
          "launches": launches, "launches_by_run": by_run, "gpu": gpu})
    return launches, by_run


def routed_decode(c, B: int, bf16: bool, lc: bool) -> str:
    """The decode kernel (and mode) that ``kernel="auto"`` launches for
    ``c`` at batch B on this card, as ``launches_by`` names it."""
    import torch
    from wavenet_torch.kernels import sampler as ks
    kernel = ("cluster" if ks.device_plan(c, B) else
              "tiles" if ks.device_tile_plan(
                  c, B, weight_dtype=torch.bfloat16 if bf16
                  else torch.float32) else "decode")
    return kernel + ("_bf16" if bf16 else "") + ("_lc" if lc else "")


def positive_numbers(obj, where: str = "payload"):
    """Every number under ``obj`` is finite and positive, and no value is
    null."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            positive_numbers(v, f"{where}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            positive_numbers(v, f"{where}[{i}]")
    elif isinstance(obj, bool) or isinstance(obj, str):
        return
    else:
        check(isinstance(obj, (int, float)) and obj == obj
              and 0 < obj < float("inf"), f"{where} = {obj!r}")


def phase_bench(gpu):
    """Phase 9: the bench (``wavenet_torch.bench.run``) on the card at
    short length (``bench.SHORT``: generation at 2,000 samples and one
    rep, the scan rows at 200, two train steps, the train CLI's ten), the
    decode counts set to 0
    just before. Every number of its payload finite and positive; each
    generation row served by the kernel the route takes on this card, and
    every one of those kernels launched in the run; the compact line built
    from it has every key of the JAX bench's non-null, in at most 1,900
    characters. Returns the run's launches by kernel."""
    import collections
    from wavenet_torch import bench
    from wavenet_torch.kernels import sampler as ks

    ks.decode.launches = ks.decode_sequential.launches = 0  # the main path
    ks.decode.launches_by.clear()
    ks.decode_sequential.launches_by.clear()
    t0 = time.perf_counter()
    payload, parts = bench.run(bench.SHORT, "cuda")
    seconds = time.perf_counter() - t0
    launches = (collections.Counter(ks.decode.launches_by)
                + collections.Counter(ks.decode_sequential.launches_by))
    extra = payload["extra"]
    positive_numbers({k: v for k, v in payload.items() if k != "extra"})
    positive_numbers(extra, "extra")
    rows = [(key, extra["decode_kernels"][key], spec)
            for key, spec in BENCH_GEN_ROWS.items()]
    rows += [(f"configs.{name}", extra["configs"][name]["decode_kernels"][
        "gen_samples_per_s_b1_prefill"], spec)
        for name, spec in BENCH_CONFIG_GEN_ROWS.items()]
    calls = 1 + bench.SHORT.gen_reps        # the warm-up and the reps
    for key, served, (name, B, bf16, lc, wrapper) in rows:
        want = routed_decode(bench._make_config(name), B, bf16, lc)
        reps = calls if "prefill_bf16w" not in key else 1 + max(
            1, bench.SHORT.gen_reps - 1)
        check(served == {wrapper: {want: reps}},
              f"bench row {key} was served by {served}, not {want} "
              f"({wrapper}, {reps} launches)")
    routed = {want for _, _, spec in rows
              for want in [routed_decode(bench._make_config(spec[0]),
                                         *spec[1:4])]}
    check(all(launches.get(k) for k in routed),
          f"the bench launched {dict(launches)}, not every one of {routed}")
    line = bench.compact_line(**parts)
    compact = json.loads(line)
    check(len(line) <= bench.COMPACT_LIMIT and "gen_b64" in compact["extra"],
          f"the compact line takes {len(line)} characters")
    positive_numbers(compact, "compact")
    emit({"phase": "bench", "scale": extra["scale"], "seconds": seconds,
          "seconds_by_part": extra["seconds_by_part"],
          "compact_chars": len(line), "launches_by_kernel": dict(launches),
          "gpu": gpu})
    emit({"phase": "bench_payload", "payload": payload, "gpu": gpu})
    emit({"phase": "bench_compact", "compact": compact, "gpu": gpu})
    return dict(launches)


def close_row(row, label, got, ref, rtol, atol):
    """Check ``got`` against ``ref`` elementwise, |got - ref| <= atol +
    rtol |ref| (the CPU tests' ``assert_allclose``); record the largest
    error in ``row``."""
    import torch
    where = f"{row['config']} {label}"
    got, ref = got.double(), ref.double()
    check(torch.isfinite(got).all().item(), f"{where}: non-finite output")
    err = (got - ref).abs()
    row[f"max_abs_err_{label}"] = err.max().item()
    excess = (err - atol - rtol * ref.abs()).max().item()
    check(excess <= 0, f"{where}: differs from its reference by "
          f"{err.max().item()} (over the limit by {excess})")
    return err.max().item()


def phase_extend_state(c, params, rng, gpu):
    """``extend_state`` at full width: one window from a prefilled state
    against the same steps of ``sampler_step``, on the card."""
    import torch
    from wavenet_torch import sample as ts

    codes = torch.as_tensor(
        rng.randint(0, c.quantization_channels, (1, PREFILL + EXTEND_K)),
        dtype=torch.int32, device="cuda")
    win = codes[:, PREFILL:]
    st = ts.prefill_state(params, c, codes[:, :PREFILL])
    ring0 = st.layer_bufs.clone()

    def steps():
        s = st._replace(layer_bufs=st.layer_bufs.clone())
        logits, states = [], {}
        with torch.no_grad():
            for j in range(EXTEND_K):
                s, lg = ts.sampler_step(params, c, s,
                                        ts._featurize(win[:, j], c))
                logits.append(lg)
                if j + 1 == EXTEND_PARTIAL_V:
                    states[j + 1] = s._replace(
                        layer_bufs=s.layer_bufs.clone())
        states[EXTEND_K] = s
        return torch.stack(logits, 1), states

    ref, states = steps()
    row = {"phase": "extend_state", "config": "paper", "batch": 1,
           "prefill": PREFILL, "k": EXTEND_K}
    for v in (EXTEND_PARTIAL_V, EXTEND_K):
        lg, new = ts.extend_state(params, c, st, win, valid_len=v)
        check(new.t == states[v].t == PREFILL + v, f"extend_state v={v}: t")
        hold(row, f"logits_v{v}", lg, ref, EXTEND_RTOL, EXTEND_ATOL)
        hold(row, f"ring_v{v}", new.layer_bufs, states[v].layer_bufs,
             EXTEND_RTOL, EXTEND_ATOL)
        hold(row, f"causal_v{v}", new.causal_buf, states[v].causal_buf,
             EXTEND_RTOL, EXTEND_ATOL)
    check(torch.equal(st.layer_bufs, ring0),
          "extend_state wrote the state it was given")
    row["extend_ms"] = median_cuda_ms(
        lambda: ts.extend_state(params, c, st, win))
    row["steps_ms"] = median_cuda_ms(steps, reps=3)
    row["gpu"] = gpu
    emit(row)
    return row


def phase_scoring(cfgs, params, rng, gpu):
    """``score.log_likelihood`` at b1 x SCORE_SAMPLES at the paper and gc
    configs: one-shot, streaming, and one-shot at ``use_pallas_stack``
    (``fused_stack_mma``'s forward), against each other."""
    import dataclasses
    import numpy as np
    import torch
    from wavenet_torch import score
    from wavenet_torch.kernels import fused_stack as fs

    rows = {}
    for name in ("paper", "gc"):
        c, p = cfgs[name], params[name]
        audio = torch.as_tensor(
            rng.uniform(-1, 1, (1, SCORE_SAMPLES)).astype(np.float32),
            device="cuda")
        gc = torch.tensor([5], device="cuda") if c.gc_enabled else None
        cp = dataclasses.replace(c, use_pallas_stack=True)
        check(fs.stack_kernel_plan(cp) == "mma",
              f"{name}: the stack route is not fused_stack_mma")
        row = {"phase": "scoring", "config": name, "batch": 1,
               "samples": SCORE_SAMPLES, "chunk": SCORE_CHUNK}
        one = score.log_likelihood(p, c, audio, gc)
        stream = score.log_likelihood_streaming(p, c, audio, gc,
                                                chunk=SCORE_CHUNK)
        fs.forward.launches = 0          # the scoring route's count
        fs.forward.launches_by.clear()
        fused = score.log_likelihood(p, cp, audio, gc)
        torch.cuda.synchronize()
        row["stack_launches_by"] = dict(fs.forward.launches_by)
        check(fs.forward.launches_by.get("mma", 0) > 0,
              f"{name}: scoring at use_pallas_stack launched "
              f"{dict(fs.forward.launches_by)}, not fused_stack_mma")
        close_row(row, "per_sample_fused", fused["logp_per_sample"],
                  one["logp_per_sample"], 0.0, SCORE_PER_SAMPLE_ATOL)
        close_row(row, "total_fused", fused["total_logp"],
                  one["total_logp"], SCORE_TOTAL_RTOL, SCORE_TOTAL_ATOL)
        close_row(row, "total_streaming", stream["total_logp"],
                  one["total_logp"], SCORE_TOTAL_RTOL, SCORE_STREAM_ATOL)
        bits = one["bits_per_sample"].item()
        check(np.isfinite(bits) and bits > 0, f"{name}: bits {bits}")
        row["bits_per_sample"] = bits
        row["total_logp"] = one["total_logp"].item()
        for key, fn in (
                ("one_shot", lambda: score.log_likelihood(p, c, audio, gc)),
                ("streaming", lambda: score.log_likelihood_streaming(
                    p, c, audio, gc, chunk=SCORE_CHUNK)),
                ("fused", lambda: score.log_likelihood(p, cp, audio, gc))):
            ms = median_cuda_ms(fn, reps=3)
            row[f"{key}_ms"] = ms
            row[f"{key}_audio_s_per_s"] = (SCORE_SAMPLES / 16000.0) / (
                ms / 1e3)
        row["gpu"] = gpu
        emit(row)
        rows[name] = row
    return rows


def phase_score_cli(c, gc_ckpt, gc_pfile, gpu):
    """``python -m wavenet_torch.score`` from phase 5's gc checkpoints (a
    directory of ``ckpt-STEP``) on two wavs named by speaker, one past
    ``--streaming_chunk``; its totals against the library's one-shot
    scorer."""
    import numpy as np
    import torch
    from wavenet_torch import score
    from wavenet_torch.audio import read_wav, write_wav
    from wavenet_torch.train_lib import restore_params_only

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_score_")
    wavs, spk = [], (5, 7)
    rng = np.random.RandomState(3)
    for i, n in enumerate(SCORE_CLI_SAMPLES):
        t = np.arange(n) / 16000.0
        x = (0.4 * np.sin(2 * np.pi * (180.0 + 60 * i) * t)
             + 0.05 * rng.randn(n))
        path = os.path.join(tmp, f"p{spk[i]}_{i:03d}.wav")
        write_wav(path, x, 16000)
        wavs.append(path)
    check(SCORE_CLI_SAMPLES[-1] > SCORE_CLI_CHUNK > SCORE_CLI_SAMPLES[0],
          "the score CLI's files do not straddle --streaming_chunk")
    out, seconds = tee_main(score.main, [
        gc_ckpt] + wavs + [
        "--wavenet_params", gc_pfile, "--gc_channels", str(c.gc_channels),
        "--gc_cardinality", str(c.gc_cardinality), "--gc_from_filename",
        "--streaming_chunk", str(SCORE_CLI_CHUNK), "--device", "cuda"])
    lines = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith("{")]
    check(len(lines) == 2, f"score CLI printed {len(lines)} result lines")
    params = restore_params_only(gc_ckpt, device="cuda")
    row = {"phase": "score_cli", "config": "gc", "files": len(lines),
           "seconds": seconds, "audio_s_per_s":
               sum(SCORE_CLI_SAMPLES) / 16000.0 / seconds}
    for i, res in enumerate(lines):
        check(set(res) == {"file", "samples", "total_logp",
                           "bits_per_sample", "nll_nats_per_sample"},
              f"score CLI fields {sorted(res)}")
        check(res["samples"] == SCORE_CLI_SAMPLES[i] and
              np.isfinite(res["total_logp"]) and res["bits_per_sample"] > 0,
              f"score CLI line {res}")
        audio, _ = read_wav(wavs[i], 16000)
        ref = score.log_likelihood(
            params, c, torch.as_tensor(audio, device="cuda")[None],
            torch.tensor([spk[i]], device="cuda"))["total_logp"].item()
        err = abs(res["total_logp"] - ref)
        # The CLI prints totals to 3 decimals.
        check(err <= SCORE_TOTAL_RTOL * abs(ref) + SCORE_TOTAL_ATOL + 5e-4,
              f"score CLI {res['file']}: {res['total_logp']} against the "
              f"one-shot {ref}")
        row[f"total_logp_{i}"] = res["total_logp"]
        row[f"max_abs_err_total_{i}"] = err
        row[f"streamed_{i}"] = SCORE_CLI_SAMPLES[i] > SCORE_CLI_CHUNK
    row["gpu"] = gpu
    emit(row)
    return row


def phase_speculative_serving(c, gpu):
    """A ``GenerationService`` with a draft at the paper config (the
    target's npz, then a perturbed copy): /generate at b1 x SPEC_SAMPLES.
    ``speculative.generate_speculative`` is wrapped to record each call's
    (segments, accepted, emitted); the codes it returns are its own."""
    import torch
    from wavenet_torch import speculative as sp
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.params import save_npz
    from wavenet_torch.serve import GenerationService

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_spec_")
    p = seeded_params(c, 7, "cpu")
    gen = torch.Generator().manual_seed(17)
    npzs = {"identical": os.path.join(tmp, "target.npz"),
            "perturbed": os.path.join(tmp, "perturbed.npz")}
    save_npz(npzs["identical"], p)
    save_npz(npzs["perturbed"], {
        k: v + SPEC_PERTURB * (v.std() if v.numel() > 1 else 0.0)
        * torch.randn(v.shape, generator=gen) for k, v in p.items()})
    js = os.path.join(tmp, "paper.json")
    with open(js, "w") as f:
        json.dump(c.to_json_dict(), f)
    Q = c.quantization_channels
    stats = []
    real = sp.generate_speculative

    def recording(*args, **kwargs):
        codes, st = real(*args, return_stats=True, **kwargs)
        stats.append(st)
        return codes

    rows = {}
    sp.generate_speculative = recording
    try:
        for label, draft in npzs.items():
            svc = GenerationService(
                npzs["identical"], js, warm_samples=0, device="cuda",
                draft_params_npz=draft, speculative_k=SPEC_K)
            check(svc.sampler_name == f"speculative (k={SPEC_K})",
                  f"sampler_name {svc.sampler_name}")
            try:
                svc.generate_batch(16, batch=2)
                check(False, "/generate_batch with a draft did not raise")
            except ValueError:
                pass
            httpd, url = start_server(svc)
            try:
                ks.decode.launches = 0
                ks.decode.launches_by.clear()
                del stats[:]
                t = time.perf_counter()
                body = post(url + "/generate", {
                    "samples": SPEC_SAMPLES, "seed": 3, "format": "codes"})
                dt = time.perf_counter() - t
            finally:
                httpd.shutdown()
                httpd.server_close()
            codes = body["codes"]
            check(len(codes) == SPEC_SAMPLES and min(codes) >= 0
                  and max(codes) < Q and len(set(codes)) > 8,
                  f"speculative {label}: malformed codes")
            check(ks.decode.launches == 0,
                  f"speculative {label}: {ks.decode.launches} decode "
                  "launches (the JAX server runs none)")
            check(len(stats) == 1, f"speculative {label}: {len(stats)} "
                  "calls of generate_speculative")
            n_seg, n_acc, n_out = stats[0]
            acceptance = n_acc / (n_seg * SPEC_K)
            if label == "identical":
                check(n_acc == n_seg * SPEC_K, "the identical draft was "
                      f"refused {n_seg * SPEC_K - n_acc} proposals")
            rows[label] = {
                "phase": "speculative_serving", "config": "paper",
                "draft": label, "k": SPEC_K, "batch": 1,
                "samples": SPEC_SAMPLES, "seconds": dt,
                "samples_per_s": SPEC_SAMPLES / dt, "segments": n_seg,
                "accepted": n_acc, "emitted": n_out,
                "acceptance": acceptance,
                "mean_accepted_length": n_acc / n_seg,
                "samples_per_pass": n_out / n_seg,
                "decode_launches": ks.decode.launches, "gpu": gpu}
            emit(rows[label])
    finally:
        sp.generate_speculative = real
    return rows


def phase_speculative_cli(c, gc_ckpt, gc_pfile, gpu):
    """``python -m wavenet_torch.cli.generate --draft_checkpoint`` from
    phase 5's gc checkpoints (a directory of ``ckpt-STEP``; the draft is
    the same checkpoint): b1 x SPEC_CLI_SAMPLES, then in ``--save_every``
    segments, equal."""
    from wavenet_torch.kernels import sampler as ks

    tmp = tempfile.mkdtemp(prefix="wavenet_torch_spec_cli_")
    wavs, rows = {}, {}
    for label, extra in (("single", []),
                         ("save_every", ["--save_every",
                                         str(SPEC_CLI_SAVE_EVERY)])):
        wav = os.path.join(tmp, f"{label}.wav")
        ks.decode.launches = 0
        out, seconds = run_generate_cli(
            [gc_ckpt, "--wavenet_params", gc_pfile, "--samples",
             str(SPEC_CLI_SAMPLES), "--wav_out_path", wav, "--seed", "1",
             "--gc_channels", str(c.gc_channels), "--gc_cardinality",
             str(c.gc_cardinality), "--gc_id", "5", "--draft_checkpoint",
             gc_ckpt, "--speculative_k", str(SPEC_K), "--device", "cuda"]
            + extra)
        check("Finished generating." in out, f"{label}: no finish line")
        check(ks.decode.launches == 0, f"{label}: decode launched")
        wavs[label] = read_wavs(wav, 1, SPEC_CLI_SAMPLES)
        rows[label] = {"phase": "speculative_cli", "config": "gc",
                       "run": label, "samples": SPEC_CLI_SAMPLES,
                       "seconds": seconds,
                       "samples_per_s": SPEC_CLI_SAMPLES / seconds}
        if label == "single":
            m = re.search(r"(\d+) segments, draft acceptance ([\d.]+)%",
                          out)
            check(m is not None and float(m.group(2)) == 100.0,
                  "the CLI's identical draft was not fully accepted")
            rows[label]["segments"] = int(m.group(1))
        else:
            check(out.count("partial wav updated") >= 1,
                  "--save_every wrote no partial wav")
    check((wavs["save_every"] == wavs["single"]).all(),
          "--save_every segments with a draft differ from the single run")
    for row in rows.values():
        row.update({"save_every_equals_one_run": True, "gpu": gpu})
        emit(row)
    return rows


def phase_distill(gpu):
    """``distill.distill_draft`` at the tiny config, a few steps on the
    card."""
    import math
    import torch
    from wavenet_torch.distill import distill_draft
    from wavenet_torch.models.config import tiny_config

    c = tiny_config()
    dc = tiny_config(dilations=(1, 2, 4, 8, 16, 32))
    p = seeded_params(c, 3, "cuda")
    key = torch.Generator(device="cuda").manual_seed(0)
    t = time.perf_counter()
    dp, loss = distill_draft(p, c, dc, key, n_clips=DISTILL_CLIPS,
                             clip_samples=DISTILL_CLIP_SAMPLES,
                             steps=DISTILL_STEPS)
    seconds = time.perf_counter() - t
    check(math.isfinite(loss), f"distill loss {loss}")
    check(all(v.is_cuda for v in dp.values()), "the draft is not on the card")
    row = {"phase": "distill", "config": "tiny", "steps": DISTILL_STEPS,
           "clips": DISTILL_CLIPS, "clip_samples": DISTILL_CLIP_SAMPLES,
           "loss": loss, "seconds": seconds, "gpu": gpu}
    emit(row)
    return row


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def counts_apart(*wrappers):
    """Zero the wrappers' launch counts for the block, then put back what
    they held before it (later phases read their own counts)."""
    saved = [(w.launches, dict(w.launches_by)) for w in wrappers]
    for w in wrappers:
        w.launches = 0
        w.launches_by.clear()
    try:
        yield
    finally:
        for w, (n, by) in zip(wrappers, saved):
            w.launches = n
            w.launches_by.clear()
            w.launches_by.update(by)


def logged_losses(logdir: str):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == "loss"]


def phase_parallel(c, gc_ckpt, gc_pfile, gpu):
    """Phase 11 (see the docstring): the train CLI over an NCCL group of
    one, the time-sharded gradients, generate_sharded, and the server from
    --checkpoint under --sampler auto and scan."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from wavenet_torch.kernels import fused_stack as fs
    from wavenet_torch.kernels import sampler as ks
    from wavenet_torch.models.wavenet import loss_fn
    from wavenet_torch.parallel import (
        initialize_multihost, make_global_mesh, make_time_sharded_grad_fn)
    from wavenet_torch.sample import generate, generate_sharded
    from wavenet_torch.serve import GenerationService

    t0 = time.perf_counter()
    logdir5 = os.path.dirname(os.path.normpath(gc_ckpt))
    corpus = os.path.join(os.path.dirname(logdir5), "corpus")
    tmp = tempfile.mkdtemp(prefix="wavenet_torch_parallel_")
    base = ["--data_dir", corpus, "--wavenet_params", gc_pfile,
            "--gc_channels", str(c.gc_channels), "--batch_size",
            str(TRAIN_BATCH), "--sample_size", str(TRAIN_SAMPLES),
            "--checkpoint_every", "4", "--steps_per_dispatch", "4",
            "--seed", "0", "--device", "cuda", "--num_steps",
            str(PARALLEL_STEPS)]
    out = {"phase": "parallel", "world_size": 1, "config": "gc",
           "batch": TRAIN_BATCH, "steps": PARALLEL_STEPS}
    parts = {}
    lap = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - lap[0]
        lap[0] = now

    # (a) The train CLI over NCCL, plain and fused, against one process.
    routed = fs.stack_kernel_plan(c)
    for fused in (False, True):
        flags = ["--use_pallas_stack"] if fused else []
        tag = "fused" if fused else "plain"
        if fused:    # phase 5's run: the same flags, seed and batches
            single = logged_losses(logdir5)[:PARALLEL_STEPS]
        else:
            run_cli(base + flags + ["--logdir", os.path.join(tmp, tag)])
            single = logged_losses(os.path.join(tmp, tag))
            part("cli_one_process_plain")
        dp_dir = os.path.join(tmp, "dp_" + tag)
        with counts_apart(fs.forward, fs.backward):
            text = run_cli(base + flags + [
                "--logdir", dp_dir, "--coordinator_address",
                f"127.0.0.1:{free_port()}", "--num_processes", "1",
                "--process_id", "0"])
            by = {"fwd": dict(fs.forward.launches_by),
                  "bwd": dict(fs.backward.launches_by)}
        check(not dist.is_initialized(),
              "the train CLI left its process group")
        dp = logged_losses(dp_dir)
        check(f"step {PARALLEL_STEPS} - loss = " in text,
              f"the {tag} multi-process CLI did not train")
        check(dp == single, f"the {tag} multi-process CLI's losses {dp} are "
              f"not the one-process CLI's {single}")
        want = {routed: PARALLEL_STEPS} if fused else {}
        check(by["fwd"] == want and by["bwd"] == want,
              f"the {tag} multi-process CLI ran the stack kernels {by}, "
              f"not {want}")
        out.update({f"losses_{tag}": dp, f"one_process_losses_{tag}": single,
                    f"bitwise_{tag}": True, f"stack_launches_by_{tag}": by})
        part(f"cli_nccl_{tag}")

    # (b), (c): one NCCL process, its meshes.
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    part("nccl_init")
    try:
        out["backend"] = dist.get_backend()
        check(out["backend"] == "nccl", f"backend {out['backend']}")
        params = seeded_params(c, 11, "cuda")
        rng = np.random.RandomState(11)
        B, T = TIMESHARD_BATCH, c.receptive_field + TIMESHARD_SAMPLES
        audio = torch.as_tensor(rng.uniform(-1, 1, (B, T)),
                                dtype=torch.float32, device="cuda")
        gc_ids = torch.as_tensor(rng.randint(0, c.gc_cardinality, B),
                                 device="cuda")
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "time"))
        fn = make_time_sharded_grad_fn(c, mesh, 0.01, time_axis="time",
                                       data_axis="data")
        (total, _), grads = fn(params, audio, gc_ids)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        ref, _ = loss_fn(leaves, c, audio, gc_ids, 0.01)
        ref.backward()
        loss_err = abs(float(total) - float(ref.detach())) / abs(
            float(ref.detach()))
        grad_err = max(float((grads[k] - v.grad).abs().max()
                             / v.grad.abs().max().clamp_min(1e-30))
                       for k, v in leaves.items())
        check(loss_err <= 1e-5, f"time-sharded loss off by {loss_err}")
        check(grad_err <= 1e-4, f"time-sharded gradients off by {grad_err}")
        out.update({"timeshard_loss_rel_err": loss_err,
                    "timeshard_grad_max_rel_err": grad_err})
        part("timeshard")

        mesh = make_global_mesh()
        key = torch.Generator(device="cuda")
        codes = generate_sharded(params, c, SHARDED_GEN_STEPS,
                                 key.manual_seed(5), mesh, SHARDED_GEN_BATCH,
                                 gc_ids=gc_ids.repeat(2))
        ref_codes = generate(params, c, SHARDED_GEN_STEPS, key.manual_seed(5),
                             batch_size=SHARDED_GEN_BATCH,
                             gc_ids=gc_ids.repeat(2))
        check(torch.equal(codes, ref_codes),
              "generate_sharded's codes are not sample.generate's")
        out["generate_sharded_equal"] = True
        part("generate_sharded")
    finally:
        dist.destroy_process_group()
    part("nccl_destroy")

    # (d) The server from --checkpoint, on both samplers.
    for sampler in ("auto", "scan"):
        service = GenerationService(
            None, gc_pfile, c.gc_channels, c.gc_cardinality,
            checkpoint=logdir5, sampler=sampler, warm_samples=0,
            device="cuda")
        part(f"server_{sampler}_start")
        httpd, url = start_server(service)
        try:
            with counts_apart(ks.decode):
                body = post(url + "/generate", {"samples": 1000, "seed": 5,
                                                "gc_id": 3,
                                                "format": "codes"})
                by = dict(ks.decode.launches_by)
        finally:
            httpd.shutdown()
            httpd.server_close()
        codes = body["codes"]
        check(len(codes) == 1000 and 0 <= min(codes)
              and max(codes) < c.quantization_channels
              and len(set(codes)) > 8,
              f"--sampler {sampler}: malformed /generate answer")
        if sampler == "scan":
            check(body["sampler"] == "scan" and not by,
                  f"--sampler scan ran {body['sampler']}, launches {by}")
        else:
            check("CUDA" in body["sampler"] and sum(by.values()) == 1,
                  f"--sampler auto ran {body['sampler']}, launches {by}")
        out.update({f"server_{sampler}_sampler": body["sampler"],
                    f"server_{sampler}_decode_launches_by": by})
        part(f"server_{sampler}_request")
    out.update({"seconds": time.perf_counter() - t0, "seconds_by_part": parts,
                "gpu": gpu})
    emit(out)
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "wavenet_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(wavenet_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np
    from wavenet_torch.kernels import _build
    from wavenet_torch.models.config import (
        gc_config, paper_config, sharded_config, tiny_config, wide_config)

    # Phase 1: device and build (one nvcc per source, all at once).
    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu, flush=True)
    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))   # re-raises a failed build
    for name in KERNELS:
        info = _build.BUILD_INFO[name]
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name,
              "seconds": time.perf_counter() - t,
              "nvcc_seconds": info["seconds"], "ptxas": regs,
              "torch": torch.__version__, "cuda": torch.version.cuda})

    # Phase 2: kernel against plain, teacher-forced.
    cfgs = {"paper": paper_config(), "gc": gc_config()}
    params = {name: seeded_params(c, i, "cuda")
              for i, (name, c) in enumerate(cfgs.items())}
    rng = np.random.RandomState(0)
    measured = phase_teacher_forced(cfgs, params, rng, gpu)

    # Phase 3: sampling exactness.
    phase_sampling(cfgs["gc"], params["gc"], rng)

    # Phase 4: serving, the main path of generation.
    launches = phase_serving(cfgs, gpu)
    missing = [B for B in SERVE_BATCH_SIZES if not launches.get(B)]
    check(not missing, f"no kernel launch at batch sizes {missing}")
    check(launches["by_kernel"].get("cluster")
          and launches["by_kernel"].get("tiles"),
          f"serving launched {launches['by_kernel']}: not the cluster "
          "kernel (b1, b64) and the tiles kernel (b512)")

    # Phase 5: training, the main path of training (the wide config's
    # through fused_stack_mma at width 64 too).
    gen_cfgs = dict(cfgs, wide=wide_config())
    gen_params = dict(params, wide=seeded_params(gen_cfgs["wide"], 2,
                                                 "cuda"))
    stack = phase_stack_kernels(gen_cfgs, gen_params, rng, gpu)
    bf16_cfgs = dict(gen_cfgs, tiny=tiny_config())
    bf16_params = dict(gen_params, tiny=seeded_params(bf16_cfgs["tiny"], 3,
                                                      "cuda"))
    stack_bf16 = {name: phase_stack_bf16(name, bf16_cfgs[name],
                                         bf16_params[name], rng, gpu)
                  for name in ("gc", "wide", "tiny")}
    for name in ("gc", "wide"):
        phase_train_step(name, gen_cfgs[name], gen_params[name], rng, gpu)
    phase_train_step_bf16(cfgs["paper"], params["paper"], rng, gpu)
    train_launches, gc_ckpt, gc_pfile = phase_train_cli(
        cfgs["gc"], gen_cfgs["wide"], gpu)
    t5lc = time.perf_counter()
    phase_lc_train(gpu)
    emit({"phase": "lc_training", "seconds": time.perf_counter() - t5lc,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 5t: the sharded config's stack on fused_stack_tiled.
    t5t = time.perf_counter()
    tiled, tiled_launches = phase_stack_tiled(rng, gpu)
    emit({"phase": "sharded_training", "seconds": time.perf_counter() - t5t,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 5r: kernel 5 at R != D on fused_stack_tiled (ragged tiles),
    # and the sharded config's generation on sampler_decode, timed beside
    # the scan sampler.
    t5r = time.perf_counter()
    ragged, ragged_launches = phase_stack_ragged(gen_cfgs["wide"], rng, gpu)
    sharded_gen = phase_sharded_generation(gpu)
    emit({"phase": "ragged_training", "seconds": time.perf_counter() - t5r,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 6: generation, kernel 4's route and the generate CLI.
    seq = phase_sequential(gen_cfgs, gen_params, rng, gpu)
    wide_timed = phase_wide_prefill(gen_cfgs["wide"], gen_params["wide"],
                                    rng, gpu)
    gen_launches = phase_generate_cli(gen_cfgs, gen_params, gc_ckpt,
                                      gc_pfile, gpu)
    check(all(gen_launches.get(k) for k in DECODE_SOURCES),
          f"the generate CLI launched {gen_launches}: not all three "
          "decode kernels")
    seq_main = phase_sequential_main_path(gen_cfgs, gen_params, rng, gpu)

    # Phase 6b: bf16-weight generation (TPU kernels 1-4 at bf16 weights).
    t6b = time.perf_counter()
    bf16_dec = phase_bf16_decode(cfgs, params, rng, gpu)
    bf16_launches = phase_bf16_generate(cfgs, params, gc_ckpt, gc_pfile,
                                        gpu)
    emit({"phase": "bf16_generation", "seconds": time.perf_counter() - t6b,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 6c: local conditioning (the LC row of TPU kernels 1 and 2).
    t6c = time.perf_counter()
    c_lc = paper_config(lc_channels=LC_CHANNELS)
    p_lc = lc_params(c_lc, 13, "cuda")
    lc_dec = phase_lc_decode(c_lc, p_lc, rng, gpu)
    lc_rate = phase_lc_generate(c_lc, p_lc, gpu)
    lc_launches = phase_lc_main_path(c_lc, p_lc, gpu)
    emit({"phase": "lc_generation", "seconds": time.perf_counter() - t6c,
          "samples_per_s_b1": lc_rate,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 6d: local conditioning at bf16 weights.
    t6d = time.perf_counter()
    lc_bf16_dec = phase_lc_bf16_decode(c_lc, p_lc, rng, gpu)
    lc_bf16_launches = phase_lc_bf16_main_path(c_lc, p_lc, gpu)
    emit({"phase": "lc_bf16_generation",
          "seconds": time.perf_counter() - t6d,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 6e: the bf16 ring (TPU kernels 1-3 at state_dtype=bfloat16).
    t6e = time.perf_counter()
    ring16 = phase_ring16_decode(cfgs, params, c_lc, p_lc, rng, gpu)
    ring16_launches = phase_ring16_main_path(cfgs, params, c_lc, p_lc, rng,
                                             gpu)
    emit({"phase": "ring16_generation", "seconds": time.perf_counter() - t6e,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 7: the retired training stacks (TPU kernels 6-8).
    t7 = time.perf_counter()
    carry = phase_carry_stacks(cfgs, params, rng, gpu)
    carry_bf16 = phase_carry_bf16(cfgs, params, rng, gpu)
    carry_launches = phase_carry_train(cfgs["gc"], params["gc"], rng, gpu)
    layer = phase_dilated_layer(cfgs["gc"], params["gc"], rng, gpu)
    layer_wide = phase_dilated_layer_wide(cfgs["gc"], rng, gpu)
    # Phase 7 (e): the retired v1 stack at full width.
    t7e = time.perf_counter()
    v1 = {}
    for name, B, samples, kernel in V1_CASES:
        c = gen_cfgs["wide"] if name == "wide" else sharded_config()
        for (m, kind), v in v1_stack_check(name, c, B, samples, kernel,
                                           rng, gpu).items():
            v1[name, m, kind] = v
    v1_launches = phase_v1_train(rng, gpu)
    emit({"phase": "v1_full_width", "seconds": time.perf_counter() - t7e,
          "script_seconds": time.perf_counter() - t_start})
    emit({"phase": "retired_stacks", "seconds": time.perf_counter() - t7,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 8: the probes (TPU kernels 9-10).
    t8 = time.perf_counter()
    r2_res = phase_fwd_bisect(gen_cfgs, gen_params, rng, gpu)
    r3_res = phase_b1_bisect(cfgs["paper"], params["paper"], gpu)
    r4_res = phase_matvec_probe(gpu)
    probe_launches, probe_runs = phase_probe_main_path(gpu)
    emit({"phase": "probes", "seconds": time.perf_counter() - t8,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 9: the bench (every row at short length).
    t9 = time.perf_counter()
    bench_launches = phase_bench(gpu)
    emit({"phase": "bench", "seconds": time.perf_counter() - t9,
          "script_seconds": time.perf_counter() - t_start})

    # Phase 10: scoring and speculative decoding.
    t10 = time.perf_counter()
    phase_extend_state(cfgs["paper"], params["paper"], rng, gpu)
    scoring = phase_scoring(cfgs, params, rng, gpu)
    # The score CLI and --draft_checkpoint read a directory of ckpt-STEP
    # checkpoints (the latest), as the JAX package's do: phase 5's logdir.
    gc_logdir = os.path.dirname(os.path.normpath(gc_ckpt))
    phase_score_cli(cfgs["gc"], gc_logdir, gc_pfile, gpu)
    spec = phase_speculative_serving(cfgs["paper"], gpu)
    phase_speculative_cli(cfgs["gc"], gc_logdir, gc_pfile, gpu)
    phase_distill(gpu)
    emit({"phase": "scoring_and_speculative",
          "seconds": time.perf_counter() - t10,
          "scored_audio_s_per_s": {
              f"{name}_{key}": scoring[name][f"{key}_audio_s_per_s"]
              for name in scoring
              for key in ("one_shot", "streaming", "fused")},
          "speculative_samples_per_s": {
              k: v["samples_per_s"] for k, v in spec.items()},
          "mean_accepted_length": {
              k: v["mean_accepted_length"] for k, v in spec.items()},
          "script_seconds": time.perf_counter() - t_start, "gpu": gpu})

    # Phase 11: parallelism (NCCL, world size 1) and the server's flags.
    parallel = phase_parallel(cfgs["gc"], gc_ckpt, gc_pfile, gpu)
    emit({"phase": "parallel_done", "seconds": parallel["seconds"],
          "script_seconds": time.perf_counter() - t_start})

    # library_ms is null: no single PyTorch call computes a decode step.
    # The cluster and tiles rows' launches are their kernel's on the serving
    # path (phase 4: the cluster kernel at b1 and b64, the tiles kernel at
    # b512); sampler_decode's are on the generate CLI's path (phase 6: its
    # wide b64 run), since serving no longer takes it. The times of every
    # kernel are phase 2's, pinned, in this run.
    served = launches["by_kernel"]
    kernels = []
    m = measured[("cluster", "paper", 1)]
    row = {"name": "sampler_cluster", "route": "cuda",
           "source": "wavenet_torch/csrc/sampler_cluster.cu",
           "replaces": "wavenet_tpu/kernels/sampler.py:234",
           "config": "paper", "batch": 1, "launches": served["cluster"],
           "max_abs_err": max(v["max_abs_err"] for k, v in measured.items()
                              if k[0] == "cluster"),
           "ms": m["ms"], "plain_ms": m["plain_ms"],
           "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
           "library_ms": None, "unit": "per decode step (paper b1)"}
    for key, name, B in (("gc_b1", "gc", 1), ("gc_b64", "gc", 64),
                         ("gc_b120", "gc", 120)):
        mk = measured[("cluster", name, B)]
        row.update({f"ms_{key}": mk["ms"], f"bound_ms_{key}": mk["bound_ms"],
                    f"plain_ms_{key}": mk["plain_ms"],
                    f"sampler_decode_ms_{key}":
                        measured[("decode", name, B)]["ms"]})
    for kernel, name, B in sorted(wide_timed):
        if kernel == "cluster":
            mk = wide_timed[(kernel, name, B)]
            row.update({f"ms_wide_b{B}": mk["ms"],
                        f"bound_ms_wide_b{B}": mk["bound_ms"],
                        f"sampler_decode_ms_wide_b{B}":
                            wide_timed[("decode", name, B)]["ms"]})
    row["gpu"] = gpu
    kernels.append(row)
    replaces = {("paper", 1): "wavenet_tpu/kernels/sampler.py:234",
                ("gc", 64): "wavenet_tpu/kernels/sampler.py:1308",
                ("gc", 512): "wavenet_tpu/kernels/sampler_packed.py:142"}
    for (name, B), where in replaces.items():
        m = measured[("decode", name, B)]
        kernels.append({
            "name": f"sampler_decode_b{B}", "route": "cuda",
            "source": "wavenet_torch/csrc/sampler_decode.cu",
            "replaces": where, "config": name, "batch": B,
            "launches": gen_launches["decode"],
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "unit": "per decode step", "pinned": True,
            "gpu": gpu})
    # The tiles kernel (TPU kernels 2 and 3 redesigned), pinned in phase 2
    # at the server's batch shapes; b512 is the route's serving shape.
    for B, where in ((128, "wavenet_tpu/kernels/sampler.py:1308"),
                     (256, "wavenet_tpu/kernels/sampler.py:1308"),
                     (512, "wavenet_tpu/kernels/sampler_packed.py:142")):
        m = measured[("tiles", "gc", B)]
        kernels.append({
            "name": f"sampler_tiles_b{B}", "route": "cuda",
            "source": "wavenet_torch/csrc/sampler_tiles.cu",
            "replaces": where, "config": "gc", "batch": B,
            "launches": served["tiles"], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "unit": "per decode step",
            "sampler_decode_ms": measured[("decode", "gc", B)]["ms"],
            "gpu": gpu})
    # library_ms is null: no single PyTorch call computes a dilated stack
    # (or its VJP); cuDNN's dilated conv covers one layer's taps only. Each
    # kernel's row is measured (phase 5) at the shape of the train CLI run
    # whose route takes it, and its launches are that run's: fused_stack_mma
    # at gc b8 (the main run), fused_stack at the tiny config's b2 run. Its
    # bound is at the peak of its products' type (FP32 cores, or 3xTF32 on
    # the tensor cores). The simt rows also carry phase 5's gc b8 timing,
    # where the route's two kernels are compared; the mma rows its wide b8
    # timing (width 64) and the wide f32 CLI run's launches.
    for k, src, run in (("simt", "fused_stack", "narrow"),
                        ("mma", "fused_stack_mma", "main")):
        for kind, line in (("fwd", 105), ("bwd", 276)):
            m = stack[("tiny" if k == "simt" else "gc", kind, k)]
            row = {
                "name": f"{src}_{kind}", "route": "cuda",
                "source": f"wavenet_torch/csrc/{src}.cu",
                "replaces": f"wavenet_tpu/kernels/fused_stack3.py:{line}",
                "config": m["config"], "batch": m["batch"],
                "positions": m["positions"],
                "launches": train_launches[run][kind].get(k, 0),
                "launches_on": f"train CLI, {m['config']}",
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"],
                "bound_ms_fp32": m["bound_ms_fp32"],
                "bound_ms_tf32x3": m["bound_ms_tf32x3"], "library_ms": None,
                "unit": "per call (one train step's stack)", "gpu": gpu}
            if k == "simt":
                g = stack[("gc", kind, k)]
                row.update({"ms_gc_b8": g["ms"], "bound_ms_gc_b8":
                            g["bound_ms"], "plain_ms_gc_b8": g["plain_ms"],
                            "max_abs_err_gc_b8": g["max_abs_err"],
                            "mma_ms_gc_b8": stack[("gc", kind, "mma")]["ms"]})
            else:   # width 64: phase 5's wide b8 and the wide CLI run
                w = stack[("wide", kind, k)]
                row.update({"ms_wide_b8": w["ms"],
                            "bound_ms_wide_b8": w["bound_ms"],
                            "bound_by_wide_b8": w["bound_by"],
                            "plain_ms_wide_b8": w["plain_ms"],
                            "max_abs_err_wide_b8": w["max_abs_err"],
                            "launches_wide": train_launches["wide"][kind]
                            .get(k, 0)})
            kernels.append(row)
    # fused_stack_mma's forward on the scoring route (phase 10): the
    # launches of each scored config's one-shot call at use_pallas_stack.
    for row in kernels:
        if row["name"] == "fused_stack_mma_fwd":
            row["launches_scoring"] = {
                name: r["stack_launches_by"].get("mma", 0)
                for name, r in scoring.items()}
            row["scoring_ms_paper_b1_16000"] = scoring["paper"]["fused_ms"]
    # fused_stack_mma's bf16 mode (kernel 5 at kernel_dtype bf16): phase 5's
    # gc b8 check and timing, the launches of the bf16 train CLI run, and
    # the same at wide b8 and the wide bf16 CLI run (width 64); its bound
    # at the bf16 peak with 2-byte records. library_ms is null for the
    # reason above.
    for kind, line in (("fwd", 105), ("bwd", 276)):
        m, w = stack_bf16["gc"][kind], stack_bf16["wide"][kind]
        kernels.append({
            "name": f"fused_stack_mma_bf16_{kind}", "route": "cuda",
            "source": "wavenet_torch/csrc/fused_stack_mma.cu",
            "replaces": f"wavenet_tpu/kernels/fused_stack3.py:{line}",
            "mode": "bf16", "config": m["config"], "batch": m["batch"],
            "positions": m["positions"],
            "launches": train_launches["bf16"][kind].get("mma_bf16", 0),
            "launches_on": "train CLI, gc, --compute_dtype bfloat16",
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "f32_mode_ms": m["f32_mode_ms"],
            "ms_wide_b8": w["ms"], "bound_ms_wide_b8": w["bound_ms"],
            "bound_by_wide_b8": w["bound_by"],
            "plain_ms_wide_b8": w["plain_ms"],
            "f32_mode_ms_wide_b8": w["f32_mode_ms"],
            "max_abs_err_wide_b8": w["max_abs_err"],
            "launches_wide": train_launches["wide_bf16"][kind].get(
                "mma_bf16", 0),
            "library_ms": None,
            "unit": "per call (one train step's stack)", "gpu": gpu})
    # fused_stack.cu's bf16 mode (kernel 5 at kernel_dtype bf16, R = D = 8
    # and 16): phase 5's tiny b8 check and timing, the launches of the tiny
    # bf16 train CLI run; its bound at the bf16 peak with 2-byte records
    # (and at the FP32 peak, where it multiplies). library_ms is null for
    # the reason above.
    for kind, line in (("fwd", 105), ("bwd", 276)):
        m = stack_bf16["tiny"][kind]
        kernels.append({
            "name": f"fused_stack_bf16_{kind}", "route": "cuda",
            "source": "wavenet_torch/csrc/fused_stack.cu",
            "replaces": f"wavenet_tpu/kernels/fused_stack3.py:{line}",
            "mode": "bf16", "config": m["config"], "batch": m["batch"],
            "positions": m["positions"],
            "launches": train_launches["narrow_bf16"][kind].get(
                "simt_bf16", 0),
            "launches_on": "train CLI, tiny, --compute_dtype bfloat16",
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "bound_ms_fp32": m["bound_ms_fp32"],
            "bound_by_fp32": m["bound_by_fp32"],
            "f32_mode_ms": m["f32_mode_ms"], "library_ms": None,
            "unit": "per call (one train step's stack)", "gpu": gpu})
    # The bf16 modes (phase 6b): times pinned at each case in this run,
    # launches those of the bf16 generate CLI runs (the cluster kernel at
    # gc b1 and b64, the tiles kernel at b128, sampler_decode at b600); the
    # bound with the weights at 2 bytes and the products of two bf16
    # operands at the bf16 peak. library_ms is null for the reason above.
    for kernel, src, head, others in (
            ("cluster", "sampler_cluster", ("paper", 1), (("gc", 64),)),
            ("decode", "sampler_decode", ("gc", 128),
             (("gc", 1), ("gc", 512)))):
        m = bf16_dec[(kernel,) + head]
        row = {"name": f"{src}_bf16", "route": "cuda",
               "source": f"wavenet_torch/csrc/{src}"
                         + ("_bf16.cu" if kernel == "cluster" else ".cu"),
               "replaces": "wavenet_tpu/kernels/sampler.py:234, :1308, "
                           ":1057; wavenet_tpu/kernels/sampler_packed.py:142"
                           " (weight_dtype=bfloat16)",
               "mode": "bf16", "config": head[0], "batch": head[1],
               "launches": bf16_launches.get(f"{kernel}_bf16", 0),
               "launches_on": "generate CLI, gc, --sampler_precision "
                              "bfloat16",
               "max_abs_err": max(v["max_abs_err"] for k, v in
                                  bf16_dec.items() if k[0] == kernel),
               "ms": m["ms"], "plain_ms": m["plain_ms"],
               "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
               "f32_route_ms": m["f32_route_ms"],
               "f32_route_kernel": m["f32_route_kernel"],
               "library_ms": None, "unit": "per decode step", "gpu": gpu}
        for name, B in others:
            mk = bf16_dec[(kernel, name, B)]
            key = f"{name}_b{B}"
            row.update({f"ms_{key}": mk["ms"],
                        f"bound_ms_{key}": mk["bound_ms"],
                        f"plain_ms_{key}": mk["plain_ms"],
                        f"f32_route_ms_{key}": mk["f32_route_ms"]})
        kernels.append(row)
    # The tiles kernel's bf16 mode (TPU kernels 2 and 3 at bf16 weights,
    # redesigned), one row per shape of the TPU kernel it replaces; its f32
    # mode and sampler_decode's bf16 mode at the same shape in this run.
    for B, where, others in (
            (128, "wavenet_tpu/kernels/sampler.py:1308", ()),
            (512, "wavenet_tpu/kernels/sampler_packed.py:142",
             (("paper", 525),))):
        m = bf16_dec[("tiles", "gc", B)]
        row = {"name": f"sampler_tiles_bf16_b{B}", "route": "cuda",
               "source": "wavenet_torch/csrc/sampler_tiles_bf16.cu",
               "replaces": f"{where} (weight_dtype=bfloat16)",
               "mode": "bf16", "config": "gc", "batch": B,
               "launches": bf16_launches.get("tiles_bf16", 0),
               "launches_on": "generate CLI, gc b128, --sampler_precision "
                              "bfloat16",
               "max_abs_err": m["max_abs_err"], "ms": m["ms"],
               "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
               "bound_by": m["bound_by"], "f32_route_ms": m["f32_route_ms"],
               "f32_route_kernel": m["f32_route_kernel"],
               "sampler_decode_bf16_ms": bf16_dec[("decode", "gc", B)]["ms"],
               "library_ms": None, "unit": "per decode step", "gpu": gpu}
        for name, Bo in others:
            mk = bf16_dec[("tiles", name, Bo)]
            key = f"{name}_b{Bo}"
            row.update({f"ms_{key}": mk["ms"],
                        f"bound_ms_{key}": mk["bound_ms"],
                        f"plain_ms_{key}": mk["plain_ms"],
                        f"max_abs_err_{key}": mk["max_abs_err"],
                        f"f32_route_ms_{key}": mk["f32_route_ms"]})
        kernels.append(row)
    # Kernel 4's route at bf16 (phase 6b): the cluster kernel's bf16 mode
    # from a zero ring at paper b1; its launches are the phase's two
    # (the generate CLI takes the prefill route).
    m = bf16_dec[("sequential", "paper", 1)]
    kernels.append({
        "name": "sampler_cluster_bf16_sequential_paper_b1", "route": "cuda",
        "source": "wavenet_torch/csrc/sampler_cluster_bf16.cu",
        "replaces": "wavenet_tpu/kernels/sampler.py:1057 "
                    "(weight_dtype=bfloat16)",
        "mode": "bf16", "config": "paper", "batch": 1,
        "launches": m["launches"], "launches_on": "decode_sequential, "
        "phase 6b", "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None,
        "unit": "per decode step", "gpu": gpu})
    # The LC modes (phase 6c): times pinned in this run at paper-LC, in
    # turns with the same kernel without LC; launches those of the LC main
    # path (serving and the generate CLI: the cluster kernel at b1 and
    # b64, sampler_decode at b256). The head batch is the main path's
    # first shape of the kernel; the other pinned batches follow as
    # ``<key>_b<B>``. The bound counts the LC products at FP32, lc_w's
    # bytes and the stream's B x C_lc floats a step. library_ms is null
    # for the reason above.
    for kernel, line, head in (("cluster", 234, 1), ("decode", 1308, 256)):
        m = lc_dec[(kernel, head)]
        src = ("sampler_cluster_lc.cu" if kernel == "cluster"
               else "sampler_decode.cu")
        row = {
            "name": LC_SOURCES[kernel], "route": "cuda",
            "source": f"wavenet_torch/csrc/{src}",
            "replaces": f"wavenet_tpu/kernels/sampler.py:{line} (has_lc)",
            "mode": "lc", "config": "paper_lc", "batch": head,
            "launches": lc_launches.get(f"{kernel}_lc", 0),
            "launches_on": "LC serving b1 and the LC generate CLI",
            "max_abs_err": max(v["max_abs_err"] for k, v in lc_dec.items()
                               if k != "top" and k[0] == kernel),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "no_lc_ms": m["no_lc_ms"], "library_ms": None,
            "unit": "per decode step", "gpu": gpu}
        for (k, B), mo in sorted(
                (k, v) for k, v in lc_dec.items()
                if k != "top" and k[0] == kernel and k[1] != head):
            row.update({f"{key}_b{B}": mo[key] for key in
                        ("ms", "bound_ms", "plain_ms", "no_lc_ms")})
        kernels.append(row)
    # The LC modes at bf16 weights (phase 6d): times pinned in this run at
    # paper-LC, in turns with the float32 LC mode and the bf16 mode without
    # LC of the same kernel; launches those of the bf16 LC generate CLI
    # (the cluster kernel at b1 and b64, sampler_decode at b256). The bound
    # at 2-byte weights, lc_w's included, with the products of two bf16
    # operands (the LC row always, the chain unless b1) at the bf16 peak.
    # library_ms is null for the reason above.
    for kernel, line, head in (("cluster", 234, 1), ("decode", 1308, 256)):
        m = lc_bf16_dec[(kernel, head)]
        src = ("sampler_cluster_lc_bf16.cu" if kernel == "cluster"
               else "sampler_decode.cu")
        row = {
            "name": LC_BF16_SOURCES[kernel], "route": "cuda",
            "source": f"wavenet_torch/csrc/{src}",
            "replaces": f"wavenet_tpu/kernels/sampler.py:{line} (has_lc, "
                        "weight_dtype=bfloat16)",
            "mode": "bf16_lc", "config": "paper_lc", "batch": head,
            "launches": lc_bf16_launches.get(f"{kernel}_bf16_lc", 0),
            "launches_on": "the LC generate CLI at --sampler_precision "
                           "bfloat16",
            "max_abs_err": max(v["max_abs_err"]
                               for k, v in lc_bf16_dec.items()
                               if k[0] == kernel),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "f32_lc_ms": m["f32_lc_ms"], "bf16_no_lc_ms": m["bf16_ms"],
            "library_ms": None, "unit": "per decode step", "gpu": gpu}
        for (k, B), mo in sorted(
                (k, v) for k, v in lc_bf16_dec.items()
                if k[0] == kernel and k[1] != head):
            row.update({f"{key}_b{B}": mo[key] for key in
                        ("ms", "bound_ms", "plain_ms", "f32_lc_ms",
                         "bf16_ms", "max_abs_err")})
        kernels.append(row)
    # The bf16-ring modes (phase 6e): one row a mode, its time pinned in
    # this run at its main-path shape (the last of its RING16_CASES), in
    # turns with the same mode at a float32 ring, the other shape's beside
    # it; launches those of phase 6e's main path. The bound counts the
    # ring's rows at 2 bytes. library_ms is null for the reason above.
    for key, by_case in sorted(ring16.items()):
        (name, B), m = list(by_case.items())[-1]
        kernel, lc = m["kernel"], key.endswith("_lc_ring16")
        bf16 = "_bf16" in key
        lib = ("sampler_decode" if kernel == "decode" else
               f"sampler_{kernel}{'_lc' if lc else ''}"
               f"{'_bf16' if bf16 else ''}") + "_ring16"
        row = {
            "name": f"sampler_{key}", "route": "cuda",
            "source": f"wavenet_torch/csrc/{lib}.cu",
            "replaces": RING16_REPLACES[(kernel, B)]
            + " (state_dtype=bfloat16)",
            "mode": key, "config": name, "batch": B,
            "launches": ring16_launches.get(key, 0),
            "launches_on": "generate_cuda(state_dtype=bfloat16)",
            "max_abs_err": max(v["max_abs_err"] for v in by_case.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "f32_ring_ms": m["f32_ring_ms"], "library_ms": None,
            "unit": "per decode step", "gpu": gpu}
        for (other, Bo), mo in by_case.items():
            if (other, Bo) != (name, B):
                row.update({f"{k}_b{Bo}": mo[k] for k in (
                    "ms", "f32_ring_ms", "plain_ms", "bound_ms",
                    "bound_by")})
        kernels.append(row)
    # Kernel 4's route: the decode kernel that the route takes, launched
    # from a zero ring. Its library_ms is null for the reason above.
    for name, B in SEQ_CASES:
        used = seq_main[(name, B)]["kernel"]
        m = dict(seq[(used, name, B)], **seq_main[(name, B)])
        src = DECODE_SOURCES[used]
        kernels.append({
            "name": f"{src}_sequential_{name}_b{B}",
            "route": "cuda", "source": f"wavenet_torch/csrc/{src}.cu",
            "replaces": "wavenet_tpu/kernels/sampler.py:1057",
            "config": name, "batch": B, "launches": m["launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "unit": "per decode step", "gpu": gpu})
    # The retired stacks (phase 7). library_ms is null for the reason of
    # rows 4-5: no single PyTorch call computes a gated stack or layer or
    # its VJP.
    carry_replaces = {
        "fwd_v1": "wavenet_tpu/experiments/fused_stack.py:69",
        "fwd_v2": "wavenet_tpu/experiments/fused_stack2.py:85",
        "bwd": "wavenet_tpu/experiments/fused_stack.py:170, "
               "wavenet_tpu/experiments/fused_stack2.py:200"}
    for kind, where in carry_replaces.items():
        m = carry[("gc", kind)]
        kernels.append({
            "name": f"fused_stack_carry_{kind}", "route": "cuda",
            "source": "wavenet_torch/csrc/fused_stack_carry.cu",
            "replaces": where, "config": "gc", "batch": TRAIN_BATCH,
            "launches": carry_launches["f32"][kind],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "unit": "per call (one train step's stack)", "gpu": gpu})
    # The carry kernel's bf16 mode (phase 7 (d)), at kernel_dtype bf16: its
    # launches are the bf16 steps' of phase 7 (b); its bound at the bf16
    # peak with 2-byte records.
    for kind, where in carry_replaces.items():
        m = carry_bf16[("gc", kind)]
        kernels.append({
            "name": f"fused_stack_carry_bf16_{kind}", "route": "cuda",
            "source": "wavenet_torch/csrc/fused_stack_carry.cu",
            "replaces": where, "mode": "bf16", "config": "gc",
            "batch": TRAIN_BATCH,
            "launches": carry_launches["bf16"][kind],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "f32_mode_ms": m["f32_mode_ms"],
            "kernel5_bf16_ms": m["kernel5_bf16_ms"],
            "ms_paper_b8": carry_bf16[("paper", kind)]["ms"],
            "unit": "per call (one train step's stack)", "gpu": gpu})
    # Kernel 8 (phase 7 (c)) in each mode: the mean over the gc config's
    # distinct dilations; launches those of the 30-call autograd stack of
    # that mode; the bf16 mode's bound at the bf16 peak (its bytes are the
    # float32 mode's: it reads and writes float32).
    for mode in ("f32", "bf16"):
        for kind, line in (("fwd", 68), ("bwd", 82)):
            m = layer[kind, mode]
            row = {
                "name": "dilated_layer_" + ("" if mode == "f32" else
                                            "bf16_") + kind,
                "route": "cuda",
                "source": "wavenet_torch/csrc/dilated_layer.cu",
                "replaces": f"wavenet_tpu/experiments/dilated_layer.py:{line}",
                "config": "gc", "batch": TRAIN_BATCH,
                "launches": m["launches"], "max_abs_err": m["max_abs_err"],
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": None, "unit": "per call (one layer)",
                "gpu": gpu}
            if mode == "bf16":
                row.update({"mode": "bf16", "f32_mode_ms": m["f32_mode_ms"],
                            "launches_on": "30-call fused_dilated_layer "
                                           "stack at bf16, phase 7 (c)"})
            kernels.append(row)
    # Kernel 8 at the widths the layer kernel lacks (phase 7 (c)), on
    # fused_stack_tiled's layer entries: the (256, 256) numbers, the other
    # widths' beside them; launches those of the op's call in each mode.
    for mode in ("f32", "bf16"):
        for kind, line in (("fwd", 68), ("bwd", 82)):
            m = layer_wide[256, 256, mode, kind]
            row = {
                "name": f"dilated_layer_tiled_{mode}_{kind}",
                "route": "cuda",
                "source": "wavenet_torch/csrc/fused_stack_tiled.cu",
                "replaces": f"wavenet_tpu/experiments/dilated_layer.py:{line}",
                "config": "gc length, R = D = 256", "batch": TRAIN_BATCH,
                "mode": mode, "launches": m["launches"],
                "launches_on": "fused_dilated_layer under autograd, phase "
                               "7 (c)",
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": None,
                "unit": "per call (one layer)", "gpu": gpu}
            for R, D in LAYER_WIDE[:-1]:
                w = layer_wide[R, D, mode, kind]
                row.update({f"{k}_r{R}_d{D}": w[k] for k in (
                    "ms", "plain_ms", "bound_ms", "max_abs_err",
                    "launches")})
            kernels.append(row)
    # The retired v1 stack where the carry kernel is not built (phase 7
    # (e)): kernel 5's mma kernel at wide b8 and the tiled kernel's v1
    # entries (no z record) at sharded b1, in each mode: max_abs_err
    # against v1's plain versions, plain_ms theirs, ms and the bound v1's
    # own, on the same inputs (v1_stack_check); launches those of the v1
    # train steps. library_ms is null, as for kernel 5's.
    for name, B, samples, kernel in V1_CASES:
        for mode in ("f32", "bf16"):
            for kind, line in (("fwd", 69), ("bwd", 170)):
                m = v1[name, mode, kind]
                kernels.append({
                    "name": f"v1_{kernel}_{mode}_{kind}", "route": "cuda",
                    "source": ("wavenet_torch/csrc/fused_stack_mma.cu"
                               if kernel == "mma" else
                               "wavenet_torch/csrc/fused_stack_tiled.cu"),
                    "replaces":
                        f"wavenet_tpu/experiments/fused_stack.py:{line}",
                    "config": name, "batch": B, "positions": m["positions"],
                    "mode": mode,
                    "launches": v1_launches[name, mode][kind],
                    "launches_on": f"make_train_step v1, {name}, phase 7 "
                                   "(e)",
                    "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                    "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "bound_by": m["bound_by"], "library_ms": None,
                    "unit": "per call (one train step's stack)",
                    "gpu": gpu})
    # sampler_decode at the sharded config (phase 5r): the step at b1 and
    # b64 beside the scan sampler's (plain_ms: the scan sampler, the route
    # it replaced there); launches those of the generate CLI's run.
    kernels.append({
        "name": "sampler_decode_sharded", "route": "cuda",
        "source": "wavenet_torch/csrc/sampler_decode.cu",
        "replaces": "wavenet_tpu/kernels/sampler.py:234",
        "config": "sharded", "batch": 1,
        "launches": sharded_gen["launches"],
        "launches_on": "generate CLI, sharded b1, phase 5r",
        "max_abs_err": sharded_gen["max_abs_err"], "ms": sharded_gen["ms"],
        "plain_ms": sharded_gen["plain_ms"],
        "plain_is": "the scan sampler's step",
        "bound_ms": sharded_gen["bound_ms"],
        "bound_by": sharded_gen["bound_by"],
        "ms_b64": sharded_gen["ms_b64"],
        "plain_ms_b64": sharded_gen["scan_ms_b64"], "library_ms": None,
        "unit": "per decode step", "gpu": gpu})
    # The probes (phase 8): one row per probe kernel, the other variants
    # on the phase's "probe" lines. library_ms is null: no single PyTorch
    # call computes a gated layer stack, a decode step or a dependent
    # chain of matvecs. The tensor-core rows (fwd_bisect_mma.cu) count the
    # launches of the tool run at their config; the others all of phase
    # 8 (d)'s. The cluster rows carry the production launch's step in
    # turns and the clock's cost (r3), or ns a product and a hand-off (r4).
    r2_unit = "per call (30 layer launches)"
    probe_rows = (
        ("fwd_bisect_full_bf16", "fwd_bisect", "full_bf16", r2_res,
         "fwd_bisect.cu", "tools/r2_fwd_bisect.py:178", r2_unit),
        ("fwd_bisect_full_f32", "fwd_bisect", "full_f32", r2_res,
         "fwd_bisect.cu", "tools/r2_fwd_bisect.py:178", r2_unit),
        ("fwd_bisect2_fat_1t", "fwd_bisect2", "fat_1t_1024_bf16", r2_res,
         "fwd_bisect.cu", "tools/r2_fwd_bisect2.py:108", "per call"),
        ("fwd_bisect_mma_full_f32", "fwd_bisect", "mma_full_f32", r2_res,
         "fwd_bisect_mma.cu", "tools/r2_fwd_bisect.py:178", r2_unit),
        ("fwd_bisect_mma_full_bf16", "fwd_bisect", "mma_full_bf16", r2_res,
         "fwd_bisect_mma.cu", "tools/r2_fwd_bisect.py:178", r2_unit),
        ("fwd_bisect_mma_full_f32_w64", "fwd_bisect", "mma_full_f32_w64",
         r2_res, "fwd_bisect_mma.cu", "tools/r2_fwd_bisect.py:178",
         r2_unit),
        ("fwd_bisect_mma_full_bf16_w64", "fwd_bisect", "mma_full_bf16_w64",
         r2_res, "fwd_bisect_mma.cu", "tools/r2_fwd_bisect.py:178",
         r2_unit),
        ("fwd_bisect2_mma_fat_1t", "fwd_bisect2", "mma_fat_1t_1024_bf16",
         r2_res, "fwd_bisect_mma.cu", "tools/r2_fwd_bisect2.py:108",
         "per call"),
        ("b1_bisect_full_f32", "b1_bisect", "full_f32", r3_res,
         "b1_bisect.cu", "tools/r3_b1_bisect.py:158", "per decode step"),
        ("b1_bisect_full_bf16", "b1_bisect", "full_bf16", r3_res,
         "b1_bisect.cu", "tools/r3_b1_bisect.py:158", "per decode step"),
        ("b1_bisect_cluster_full_f32", "b1_bisect", "cluster_full_f32",
         r3_res, "b1_bisect_cluster.cu", "tools/r3_b1_bisect.py:158",
         "per decode step"),
        ("b1_bisect_cluster_full_bf16", "b1_bisect", "cluster_full_bf16",
         r3_res, "b1_bisect_cluster_bf16.cu", "tools/r3_b1_bisect.py:158",
         "per decode step"),
        ("matvec_probe_mxu", "matvec_probe", "mxu", r4_res,
         "matvec_probe.cu", "tools/r4_matvec_probe.py:96",
         "per step (60 chained products)"),
        ("matvec_probe_vpu", "matvec_probe", "vpu", r4_res,
         "matvec_probe.cu", "tools/r4_matvec_probe.py:96",
         "per step (60 chained products)"),
        ("matvec_probe_cluster_mxu", "matvec_probe", "cluster_mxu", r4_res,
         "matvec_probe_cluster.cu", "tools/r4_matvec_probe.py:96",
         "per step (60 chained products)"),
        ("matvec_probe_cluster_vpu", "matvec_probe", "cluster_vpu", r4_res,
         "matvec_probe_cluster.cu", "tools/r4_matvec_probe.py:96",
         "per step (60 chained products)"),
    )
    for name, wrapper, key, res, src, where, unit in probe_rows:
        m = res[key]
        config, run = "paper", None
        if src == "fwd_bisect_mma.cu":
            wide = key.endswith("_w64")
            config = "wide" if wide else "paper"
            run = probe_runs[{"fwd_bisect": "r2_fwd_bisect",
                              "fwd_bisect2": "r2_fwd_bisect2"}[wrapper]
                             + (" --config wide" if wide else "")][wrapper]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"wavenet_torch/csrc/{src}", "replaces": where,
            "config": config, "variant": key,
            "launches": (probe_launches[wrapper][key] if run is None
                         else run.get(key.removesuffix("_w64"), 0)),
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None, "unit": unit,
            "gpu": gpu, **{k: m[k] for k in (
                "production_ms", "clock_cost", "step_clocks", "cs",
                "ns_per_product", "ns_per_handoff") if k in m}})
    # The decode kernels that the bench's generation rows launch (phase 9),
    # with that run's launches beside the main path's.
    for row in kernels:
        key = {"sampler_cluster": "cluster",
               "sampler_cluster_bf16": "cluster_bf16",
               "sampler_tiles_bf16_b128": "tiles_bf16",
               "sampler_tiles_bf16_b512": "tiles_bf16",
               "sampler_decode_bf16": "decode_bf16",
               "sampler_cluster_lc": "cluster_lc"}.get(row["name"])
        if key is not None:
            row["launches_bench"] = bench_launches.get(key, 0)
    # fused_stack_tiled (kernel 5 at R = D = 128 and up): phase 5t's
    # sharded b1 check and timing in each mode, the launches of that mode's
    # sharded train CLI run (and of phase 5's w128 run, f32); its bound at
    # the 3xTF32 or the bf16 peak. library_ms is null for the reason above.
    for m, suffix in (("f32", ""), ("bf16", "_bf16")):
        for kind, line in (("fwd", 105), ("bwd", 276)):
            t = tiled[(m, kind)]
            row = {
                "name": f"fused_stack_tiled{suffix}_{kind}", "route": "cuda",
                "source": "wavenet_torch/csrc/fused_stack_tiled.cu",
                "replaces": f"wavenet_tpu/kernels/fused_stack3.py:{line}",
                "mode": m, "config": t["config"], "batch": t["batch"],
                "positions": t["positions"],
                "launches": tiled_launches[m][kind].get(
                    "tiled" + suffix, 0),
                "launches_on": f"train CLI, sharded, {m}",
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "unit": "per call (one train step's stack)", "gpu": gpu}
            if m == "f32":
                row["launches_w128"] = train_launches["w128"][kind].get(
                    "tiled", 0)
            kernels.append(row)
    # fused_stack_tiled at R != D: phase 5r's wide-depth b8 check and
    # timing in each mode at the first of RAGGED_WIDTHS (the others'
    # numbers beside them; "edges" names the kernel's edge mode at each),
    # the launches of that mode's train CLI run at that width (and of phase
    # 5's one-step runs at R = 128, D = 64 and R = 48, D = 128, f32).
    R0, D0 = RAGGED_WIDTHS[0]
    for m, suffix in (("f32", ""), ("bf16", "_bf16")):
        for kind, line in (("fwd", 105), ("bwd", 276)):
            t = ragged[(R0, D0, m, kind)]
            row = {
                "name": f"fused_stack_tiled_r_ne_d{suffix}_{kind}",
                "route": "cuda",
                "source": "wavenet_torch/csrc/fused_stack_tiled.cu",
                "replaces": f"wavenet_tpu/kernels/fused_stack3.py:{line}",
                "mode": m, "config": t["config"], "batch": t["batch"],
                "positions": t["positions"], "residual_channels": R0,
                "dilation_channels": D0,
                "launches": ragged_launches[m][kind].get("tiled" + suffix,
                                                         0),
                "launches_on": f"train CLI, {t['config']}, {m}",
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "unit": "per call (one train step's stack)", "gpu": gpu,
                "edges": {f"r{R}_d{D}": "checked" if R % 64 or D % 64
                          else "whole" for R, D in RAGGED_WIDTHS}}
            for R, D in RAGGED_WIDTHS[1:]:
                o = ragged[(R, D, m, kind)]
                row.update({f"{k}_r{R}_d{D}": o[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by")})
            if m == "f32":
                for label in ("w128_d64", "w48_d128"):
                    row[f"launches_{label}"] = train_launches[label][
                        kind].get("tiled", 0)
            kernels.append(row)
    idle = [row["name"] for row in kernels if not row["launches"]]
    check(not idle, f"kernels launched no time on their main path: {idle}")
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
