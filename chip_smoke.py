#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths (llama3.2-3b, deepseek-v2-236b,
mamba2-130m, jamba-1.5-large-398b, stablelm-12b) and its training paths
(gpt2-350m, mamba2-130m, deepseek-v2-236b, stablelm-12b) on one NVIDIA
card.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   hand-written kernels from ``src/repro_torch/kernels/csrc``: each
   kernel's registers, spills and static shared memory from the ptxas log
   and its tensor-core instructions from ``cuobjdump -sass`` (every bf16
   attention, SSD scan, SSD gradient and MLA decode body at every width
   must have some, and the attention and SSD gradient kernels and the
   norm no atomics);
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it and at edge cases (window, GQA, sq != sk,
   float32, ragged tails, two fully masked splits of each decode kernel's
   own size, an all-invalid row,
   the MLA decode at deepseek-v2's widths and at its smoke config's, each
   decode call's kernels traced, the
   forward attention at the MLA head dims 192 and 48, the backward at
   one rank's shape of gpt2-7b at t=2 (16 heads of 128), the SSD scan at
   mamba2-130m's prefill, at a 32k prompt, at a ragged length, at b=1
   lengths of several segments, one ending inside a segment, in float32
   and at its smoke widths; jamba's attention forward at 64 query and 8 KV
   heads, its GQA decode at 8 query heads a KV head and its SSD scan at
   256 heads), the attention backward also against autograd through the
   plain forward and run twice for bit-identical gradients, the SSD
   gradient at mamba2-130m's training shape (with and without a gradient
   on the final state, bf16 and float32), at a ragged length, at b=4 and
   at the smoke widths, also against autograd through the plain scan and
   run twice for bit-identical gradients, with its scratch bytes and
   grid at the training shape; the RMSNorm kernel at llama's prefill
   and decode, Mamba2's gated norms and stablelm's width, in float32 and
   with a float32 scale, 8 rows alone required equal to the same rows in
   a batch; the variants at the wide head dims:
   the attention forward at 160 (stablelm-12b's prefill, a window, sq !=
   sk, float32), its backward at 160 and 192 (stablelm-12b's and
   deepseek-v2's MLA training shapes, GQA with a window, also against
   autograd, run twice, rows with no key, sq != sk, float32) and the
   GQA decode at 160 (stablelm-12b's decode, two whole splits masked, an
   all-invalid row, non-finite masked slots, float32); each with its time,
   the plain version's,
   one PyTorch library call's (none computes the SSD scan or its gradient)
   and the card's bound for the same work;
(s) the serverless front door (``repro_torch.core.serverless``: MARP
   predicts, HAS places, the lifecycle engine owns the job) on a cluster
   of one H100-80G: whole stablelm-12b at batch 8 x 1024 must come back
   queued with plans of two devices or more only, and llama3.2-3b's
   serving submission (batch 8, cache 544) must start; its plan's
   ``pred_bytes`` is printed beside phase 3's peaks;
3. llama3.2-3b at full width in bfloat16 with random weights from a seed:
   (a) batch prefill + greedy decode -- the serving path, run with the
   launch counts set to 0 just before and read just after, then a
   torch.profiler trace of one prefill and one decode step for the
   device's busy time and idle share and the largest kernels; (b) its
   logits against the same path on the plain versions; (c) 16 requests
   through the continuous and the disaggregated batchers, each request's
   tokens required equal to its per-request greedy decoding -- for the
   first request that leaves it (before the phase fails),
   a probe re-runs both up to that token with the decode step's
   sub-layers, norms, attention, MoE and Mamba2 functions hooked and
   prints the first output of that request's row that differs between
   the batch and the request alone, with its shapes and kernels -- and
   one decode step alone against the same step as a row of a batch of 8;
   the peak device memory of the whole run and of the decode steps alone
   beside the serving plan's ``pred_bytes`` from (s) (reported, not
   required);
4. deepseek-v2-236b at its published widths and 4 of its 60 layers (all
   60 do not fit one card), bf16 weights with a float32 router, random
   from a seed: the same (a) serving run and trace, through MLA prefill
   (flash attention at head dim 192) and the absorbed MLA decode kernel;
   (b) layer 0's MLA output, prefill and first decode step, against the
   plain versions, then the whole model's logits and the share of routing
   choices the two paths agree on; (c) the two batchers;
5. mamba2-130m at full width and depth (24 Mamba2 layers, d_model 768,
   24 SSD heads of 64, state 128), bf16 with float32 A_log/D/dt_bias,
   random from a seed: the same (a) serving run and trace, through the
   ``ssd_scan`` kernel once a layer a prefill (the decode step is plain
   PyTorch, as in the JAX package); (a') one timed prefill of one 32,768-
   token prompt; (b) layer 0's mixer output and final SSD state, then the
   whole model's prefill and first decode logits, against the plain path;
   (c) the two batchers;
6. jamba-1.5-large-398b at its published widths, one block of 8 of its 72
   layers (Mamba2 at 0-3 and 5-7, GQA at 4; MoE on 1, 3, 5, 7, dense
   SwiGLU on the even layers) and 8 of its 16 experts, top-2 kept (the
   whole block at 16 experts does not fit one card), bf16 with float32
   router and A_log/D/dt_bias: the same (a) serving run and trace,
   through the attention forward, the GQA decode and ``ssd_scan``; (a')
   one timed prefill of one 32,768-token prompt; (b) layer 4's attention
   (prefill and first decode step) and layer 0's mixer output and final
   SSD state against the plain path, then the whole model's logits and the
   share of routing choices the two paths agree on, and the logits with
   two faults put in on purpose (two MoE sub-layers swapped, the SSD state
   dropped at the prompt's half), which the logits' limit must catch;
   (c) the two batchers;
7. gpt2-350m at full width (24 layers, bf16 params, fp32 Adam state) --
   the training path, ``repro_torch.launch.train.train`` with global batch
   8, sequence 1024, microbatch 1 and block remat, 1 warm-up + 12 timed
   steps with the launch counts set to 0 just before and read just after,
   after the cell was submitted through ``serverless.submit`` to a cluster
   of one H100-80G (the job must be running on plan d=1 t=1, its
   ``pred_bytes`` equal to the JAX package's prediction, and the cell
   trains under that plan's batch, sequence and ZeRO stage; after step 1
   the peak must not exceed ``pred_bytes``, and the job is released and
   must end done -- were the peak over, the out-of-memory report's replan
   is printed before the phase fails):
   step time, tokens/s, MFU, peak device memory over step 1, the loss
   falling; the port's own peak prediction
   (``repro_torch.core.memory_model.exact_peak_bytes``, required equal to
   the JAX package's, and the observed peak required not above it), its
   accuracy and the paper formula's, and the sample's memory feedback
   plane answers (``core.memtrace``); a torch.profiler trace of one step;
   one microbatch's loss and grad norm against the plain versions;
8. mamba2-130m at full width and depth, trained as gpt2-350m is (the
   same traffic), through ``ssd_scan``, its gradient ``ssd_scan_bwd`` and
   ``adam_update``;
9. stablelm-12b whole (40 layers, d_model 5120, 32/8 heads of 160), bf16,
   random from a seed: the same (a), (b) and (c) as llama's, through the
   attention forward and the GQA decode at head dim 160, with the peak
   device memory of the whole run and of the decode steps alone beside
   the port's serving prediction (``serve_peak_bytes``, required equal to
   the JAX package's);
10. deepseek-v2-236b at its published widths, 4 of its 60 layers and 16
   of its 160 routed experts (top-6 and both shared experts kept), trained
   as gpt2-350m is, through the attention forward and backward at head dim
   192 and ``adam_update``: MFU on the active parameters, and the share of
   routing choices the kernel and plain paths agree on;
11. stablelm-12b at its published widths and 8 of its 40 layers, trained
   as gpt2-350m is, through the attention forward and backward at head
   dim 160 and ``adam_update``;
(m) Fig 6 on the card: the ten plans of ``repro_torch.launch.memcheck``
   (gpt2-350m and gpt2-7b at full width under the JAX package's (d, t)
   plans and batches) at ZeRO 1, each as rank 0 of its plan under
   PyTorch's fake process group -- the sharded train step on the rank's
   own shards, through the attention forward and backward on its H/t
   heads (gpt2-7b's at head dim 128), RMSNorm and ``adam_update`` -- one
   line each with the peak, both predictions and both accuracies, then
   the mean accuracy beside the paper's 0.92.  It fails on an
   out-of-memory and on a rank-0 state that is not its specs' shards.
(f) the sharded step for the MLA, MoE and Mamba2 families, as (m) runs
   the Fig 6 combos (``FAMILY_PLANS``: deepseek-v2-236b whole on (16,16)
   at ZeRO 3 -- 8 MLA heads of 192 and 10 of 160 experts a rank --, one
   8-layer block of jamba-1.5-large-398b on (4,8) at ZeRO 1 and 3 -- 2
   experts, 8/1 attention heads, 32 SSM heads a rank -- and mamba2-130m
   whole on (2,4) at ZeRO 1 and 3 -- its per-head and per-channel vectors
   gathered over data on the stacked layer axis -- and on (1,8)): one
   line a plan with the peak, both predictions and accuracies and
   whether the peak stays under the exact one (reported, not required).
   It fails on an out-of-memory, on a rank-0 state that is not its
   specs' shards and on a plan that never launched its attention forward
   and backward, SSD scan and gradient, Adam or RMSNorm.  Phase 2 holds
   each of these plans' new local shapes against its plain version and
   times it (the attention forward and backward at 8 and 16 heads of 192
   and at 8 query heads on 1 KV head of 128, the SSD scan and gradient at
   32, 6 and 3 heads).  The logits of a head sharded over the vocabulary
   (t divides V) stay each model rank's V/t columns, reduced to the loss by
   the vocabulary-parallel cross-entropy, in this phase and (m), (q), (p).
(q) the head_dim / seq fallback (``SEQ_PLANS``): rank 0 of the (16, 16)
   train_4k plan (s = 4,096, global batch 16, ZeRO 3 above 20e9
   parameters, else 1) of stablelm-12b, llama3.2-3b, mixtral-8x22b,
   jamba-1.5-large-398b (all 72 layers and 16 experts), starcoder2-7b,
   musicgen-medium and llava-next-34b, whole at published widths, whose
   head counts do not divide t = 16; stablelm-12b and jamba also as rank
   15, whose 256 query rows sit at offset 3,840.  As (f): one line a run
   with the peak beside both predictions (reported, not required) and
   beside the same rank's peak when every model rank gathered the whole
   vocabulary's logits (``SEQ_GATHERED_PEAK``, a constant); it
   fails on an out-of-memory, on a state that is not the rank's specs'
   shards, on a plan that never launched the attention forward and
   backward, Adam, RMSNorm (jamba: the SSD scan and gradient), and on a
   rank-15 run that never launched the attention forward and backward at
   a nonzero offset.  Phase 2 holds the local shapes (``SEQ_ATTENTION``:
   256 query rows against 4,096 keys at offsets 0 and 3,840, stablelm's
   D=160 and G=4, jamba's G=8, musicgen's D=64 and G=1, starcoder2-7b's
   G=9; starcoder2-7b's last rank at s=8,192 under its 4,096-key window;
   float32 at D=64 and 160) against the plain versions, forward and
   backward, the backward run twice for bit-identical gradients and with
   dK and dV exactly zero on every key no local query reaches, and times
   each bf16 shape beside its bound, its plain version and SDPA.
(p) the pod axis (``POD_PLANS``): rank 0 of the two-pod (2, 16, 16)
   train_4k plan (s = 4,096, global batch 32: one row a data shard over
   the 32 pod-major data ranks) of llama3.2-3b (ZeRO 1: the head_dim /
   seq fallback, a vocabulary-sharded tied head) and deepseek-v2-236b
   (ZeRO 3: MLA by head, expert-parallel MoE, each leaf gathered over the
   32 data shards), whole at published widths and depth.  One line a plan
   with the peak beside both predictions and whether it stays under
   (reported, not required); it fails on an out-of-memory, on a state
   that is not rank 0's specs' shards and on a plan that never launched
   the attention forward and backward, Adam or RMSNorm.  Phase 2 holds
   deepseek-v2's new local attention shape (8 heads of 192 over s =
   4,096) against its plain versions and times it.
(v) sharded serving (``SERVE_PLANS``): rank 0 of the (16, 16) serving
   plans of llama3.2-3b (decode_32k on the head_dim / seq fallback, whose
   decode moves each layer's cache to 2,048 slots of every column and
   merges the ranks' partial results by their log-sum-exp, and
   prefill_32k), deepseek-v2-236b (decode_32k: MLA on 8 heads, MoE, the
   latent cache replicated over the model axis, weights over data too)
   and jamba-1.5-large-398b (long_500k: the one row's cache split over the
   data axes, 32,768 slots a rank; also as rank 15), whole at published
   widths and depth, through ``repro_torch.launch.memcheck.run_serve``:
   one line a plan with the peak beside ``serve_peak_bytes`` and its
   accuracy (reported, not required); it fails on an out-of-memory, on
   logits not at the rank's shape or not finite, and on a plan that never
   launched its decode kernel (``flash_decode_gqa`` or
   ``flash_decode_mla``), on a prefill ``flash_attention``, or RMSNorm.
   Phase 2 holds ``flash_decode_gqa(..., return_lse=True)`` at the decode
   plans' local shapes (2,048 slots of head dim 128; 24/8 and 64/8
   heads) against its plain versions (out and log-sum-exp, the output
   without the flag the float32 one rounded once, a rank with no valid
   slot giving 0 and -inf) and times it beside its bound and SDPA; and
   the two other kernels at their phase (v) shapes (``SERVE_KERNELS``):
   ``flash_decode_mla`` at deepseek-v2's rank (8 rows, 8 heads, 32,768
   latent slots) and ``flash_attention`` at llama3.2-3b's prefill rank (2
   rows, 2,048 query rows at offset 0 over 32,768 keys), each against its
   plain version and timed beside its bound and SDPA.

(d) The dry run against the card (``repro_torch.launch.dryrun``): rank
   0's dry-run peak of each of phase (m)'s ten plans and each phase (v)
   plan (the step traced on the meta device, the kernels' wrappers
   allocating what they allocate here and launching nothing), plus the
   row's ``base_bytes``, beside the peak (m) or (v) measured in this run;
   each must lie within 10% of it, and the dry run must launch nothing.
   The stand-ins' launch plans (``kernels.meta``: the GQA decode's split,
   the MLA decode's plan, the SSD scan's segments, the SM count) must
   equal the card's own at the main paths' shapes.
(o) Per-op timing and the run report on the card: with the metrics'
   ``op_timing`` on, llama3.2-3b's serving cell (8 requests through the
   continuous batcher, ``launch.serve``) and two gpt2-350m training
   steps (``launch.train.train``); the trace and metrics exported and
   ``repro_torch.obs.report`` of them printed.  Each ``ops_s/<op>``
   histogram must hold as many samples as ``ops/<op>`` counts, and the
   attention forward and backward, the GQA decode, RMSNorm and Adam must
   have launched.  Its op times are host times: the call's check,
   allocation and launch, not the kernel's run.

Every training cell (7, 8, 10, 11) is started through (s)'s front door
as gpt2-350m's is, and its peak over step 1 must equal the one-device
path's (``ONE_DEVICE_PEAK``) to the byte.  The script sets the caching allocator's expandable segments as the entry
points do (``repro_torch.launch.configure_allocator``).  Each phase prints
its wall time.  Then one JSON line of per-kernel numbers and, last, the
JSON result line.
Any failed check raises and the script exits non-zero.  Without a CUDA
card, or without the repository around it, it exits non-zero and prints
no result.

    python3 chip_smoke.py --ab OTHER_CHECKOUT

times the redesigned kernels (``ssd_scan_bwd`` at mamba2-130m's training
shape and at b=2 of a ragged 1,000 rows, ``ssd_scan`` at the b=8 prefill
and at 32k, ``flash_decode_gqa`` and ``flash_decode_mla`` at their decode
shapes) in
another checkout of the repository and in this one, in turns (other,
this, this, other), each in a process of its own that builds its own
tree's kernels (``--time-kernels``, with ``--src`` naming the tree), and
prints each turn's times.

    python3 chip_smoke.py --mla-splits

times ``flash_decode_mla`` at deepseek-v2's decode shape, and at b=4 and
b=1 of its cache, at every split count from one to nine (``mla_splits``).

    python3 chip_smoke.py --alloc-peaks

prints each training cell's peak device memory over step 1 with the
allocator's expandable segments off and on, one process each
(``--train-peak ARCH``).
"""
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = (sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv
       else os.path.join(ROOT, "src"))
sys.path.insert(0, SRC)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# (bytes/s, bf16 dense FLOP/s, fp32 non-tensor FLOP/s) from NVIDIA's data
# sheets, by nvidia-smi name
PEAKS = {"H100 80GB HBM3": (3.35e12, 989e12, 67e12),     # SXM5
         "H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12)}
BF16_TOL, FP32_TOL = 2e-2, 2e-5
# The attention backward against its plain versions: max|d| <= tol *
# max|ref| per gradient, tol as the forward's -- bf16: both round their
# float32 sums to bf16 once (2^-8 relative steps), and the kernel's D_i is
# rowsum(dO O) from the bf16 output where autograd's is exact; fp32: the
# sums run in other orders.
# Adam against its plain version: the JAX package's kernel tolerance.
ADAM_ATOL, ADAM_RTOL = 1e-6, 1e-5
# Training kernel path against the plain path over one full-width
# microbatch: the forward kernel rounds p to bf16 before PV where the plain
# version keeps float32 (mamba2: the SSD scan's bf16 products and the
# chunking differ), and 24 layers carry those one-step bf16 differences
# into the loss (a mean over 1023 tokens, which averages them) and into
# every gradient (the grad norm is dominated by the largest).  A wrong
# mask, head mapping, decay or gradient term moves either by its own scale.
LOSS_RTOL, GNORM_RTOL = 1e-2, 5e-2
# The JAX package's exact_peak_bytes(cfg, 8, 1024, d=1, t=1, zero=1,
# microbatch=1) for the training cells (cfg cut as TRAIN_CUTS says): the
# port's own prediction (repro_torch.core.memory_model) and the pred_bytes
# of the plan the port's MARP gives the cell on one H100 must equal it, and
# the card's peak over step 1 must not exceed it -- MARP places a job by the
# prediction, so a peak above it is an out-of-memory on a real cluster.
# The training cells' peaks over step 1 on an NVIDIA H100 80GB HBM3 before
# the sharded step existed (chip_smoke.py's own runs, equal in every run):
# the one-device path must stay byte for byte what it was.
ONE_DEVICE_PEAK = {"gpt2-350m": 7_615_967_744, "mamba2-130m": 4_256_577_024,
                   "deepseek-v2-236b": 67_179_781_120,
                   "stablelm-12b": 65_401_494_016}
JAX_PREDICTED_PEAK = {"gpt2-350m": 8_691_153_715, "mamba2-130m": 4_841_272_883,
                      "deepseek-v2-236b": 70_503_875_379,
                      "stablelm-12b": 67_480_961_843}
TRAIN_PARAMS = {"gpt2-350m": 353_503_232, "mamba2-130m": 167_598_528,
                "deepseek-v2-236b": 3_344_552_960,
                "stablelm-12b": 3_250_672_640}
# deepseek-v2's training cell: 4 of its 60 layers (the serving cell's) and
# 16 of its 160 routed experts, top-6 and both shared experts kept, so a
# token sees the published per-token work (2,400,834,560 active parameters
# of 3,344,552,960, by the JAX package's counts).  The port holds ~20 B a
# parameter in a step (bf16 param, fp32 master, m, v, gradient sum and a
# microbatch's bf16 gradients): ~67 GB before activations, where all 160
# experts would need ~520 GB.
# stablelm-12b's training cell: 8 of its 40 layers at published widths
# (32/8 heads of 160, d_model 5120, d_ff 13824): 3,250,672,640 parameters,
# predicted 67,480,961,843 B by the JAX model above; all 40 layers are
# predicted 245.7 GB, and the card's training peaks have run at 0.88-0.95
# of the prediction, so 8 layers fit its 80 GB (6 would be 56.3 GB).
TRAIN_CUTS = {"deepseek-v2-236b": dict(num_layers=4, num_experts=16),
              "stablelm-12b": dict(num_layers=8)}
# The cluster the serverless front door places the card's jobs on: one
# node of one H100-80G (``repro_torch.core.orchestrator.make_cluster``).
ONE_H100 = [(1, 1, "H100-80G")]
# Kernel path vs plain path, max |logit delta| / max |logit|, bf16 at full
# width: the two paths round attention differently (p to bf16 before PV in
# the kernels, float32 throughout in the plain versions; bf16 steps are
# 2^-8 = 3.9e-3 relative) and 28 residual layers (llama; stablelm-12b has
# 40) carry such one-step differences to the logits.  A wrong mask, head
# mapping or merge moves the logits by the order of their own scale.
LOGITS_TOL = 5e-2

# deepseek-v2 kernel path vs plain path, max |logit delta|, absolute: the
# two paths round attention differently (as for llama above), and a bf16
# difference in a router's input can flip a near-tied top-6 choice, which
# swaps one expert's whole output for a token.  The JAX package's own
# MoE/MLA check loosens to the same atol 0.8 for this reason
# (tests/test_models.py:38-43).  Layer 0's MLA output has no routing in
# front of it and is held at the kernels' own 2e-2 of max |ref|.
DEEPSEEK_LOGITS_ATOL = 0.8
DEEPSEEK_LAYERS = 4

# The SSD scan against its plain version, elementwise |d| <= tol + tol |ref|
# on y and on the final state: the JAX package's own SSD kernel tolerances
# (tests/test_kernels.py:57).  The kernel chunks at 64 rows in segments and
# the plain version at 128 rows, which is exact in math, so they differ by
# float32 sums in other orders, in bf16 by the kernel's products (bf16 hi +
# lo halves, ~16 bits) and by y rounded once on each side.
SSD_BF16_TOL, SSD_FP32_TOL = 5e-2, 2e-3
# mamba2-130m kernel path vs plain path, max |d| / max |ref|: layer 0's
# mixer output and final state, and the whole model's logits.  The two
# paths chunk the scan differently and round y to bf16 on different sums;
# 24 residual layers carry such one-step differences to the logits.  A
# wrong decay, mask or state carry moves them by their own scale.
MAMBA2_TOL = 5e-2
# The SSD gradient against its plain version, max |d| <= tol * max |ref| per
# gradient: the JAX package's SSD kernel tolerances (tests/test_kernels.py:
# 57).  Both compute in float32 from the same inputs and chunk at 64 rows
# against 128, so they differ by sums in other orders and, in bf16, by the
# outputs' rounding.  dA_log sums over every (position, p, n) and has the
# least headroom.
SSD_BWD_BF16_TOL, SSD_BWD_FP32_TOL = 5e-2, 2e-3

# jamba: one block of its 72 layers (the layer pattern repeats every 8) with
# 8 of its 16 experts -- the block at 16 experts is 45,144,659,968
# parameters, 90.3 GB in bf16, above the card's 80 GB; at 8, 25,817,044,992
# (the JAX package's param_count) -- and the top-2 routing kept, so a token
# sees the published per-token work.  Kernel path vs plain path, max
# |logit delta| absolute: as for deepseek-v2, a bf16 difference in a
# router's input can flip a near-tied top-2 choice.  On an H100 the sound
# path gave 0.371 (max |logit| 4.688) and the two faults of phase 6 (b2)
# 1.115 (the SSD state dropped at the prompt's half) and 5.078 (two MoE
# sub-layers swapped): the limit sits at the geometric mean of 0.371 and
# 1.115, and the phase fails unless each fault exceeds it.  Layer 4's
# attention is held at the kernels' own 2e-2 of max |ref|, layer 0's mixer
# at MAMBA2_TOL.
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 8
JAMBA_PARAMS = 25_817_044_992
JAMBA_LOGITS_ATOL = 0.64

# The bf16 bodies that must run on the tensor cores: by source, groups of
# (kernel names, first template argument of each instantiation) -- the
# attention kernels' head dims, the SSD product kernel's state width N,
# the SSD segment and scan kernels' and the SSD gradient's head dim P and
# the MLA decode's latent width r.
MMA_KERNELS = {"flash_attention": [(("flash_attention_mma",),
                                    (32, 48, 64, 128, 160, 192))],
               "flash_attention_bwd": [(("bwd_dkdv_mma",), (32, 64, 128)),
                                       (("bwd_dkdv_split_mma",), (160, 192)),
                                       (("bwd_dq_mma",), (32, 64, 128, 160, 192))],
               "ssd_scan": [(("ssd_cb",), (16, 128)),
                            (("ssd_seg_state", "ssd_chunk_scan"), (32, 64))],
               "ssd_scan_bwd": [(("ssd_bwd_chunk_mma", "ssd_bwd_grads_mma"), (32, 64))],
               "flash_decode_mla": [(("mla_partials_mma",), (32, 512))]}

# stablelm-12b whole: 40 layers, 32/8 heads of 160, bf16; the JAX
# package's serve_peak_bytes(cfg, 8, 544, d=1, t=1) beside the card's peaks
# (the whole run's and the decode steps' alone, which it models)
STABLELM_PARAMS = 12_142_924_800
SERVE_PREDICTED_PEAK = {"stablelm-12b": 25_182_382_080}

SPIN_CYCLES = 2_000_000    # ~1 ms at the H100's ~2 GHz: covers a call's host work

PREFILL = dict(b=8, s=512, H=24, K=8, D=128)
DECODE = dict(b=8, S=544, H=24, K=8, D=128)
# deepseek-v2's MLA at b=8, prompt 512 + 32 new tokens: prefill attention at
# qk head dim dn + dr = 192 (H = K = 128), decode over latent width r = 512
# and rope width dr = 64
MLA_PREFILL = dict(b=8, s=512, H=128, D=192)
# jamba's attention at b=8, prompt 512 + 32 new tokens: 64 query heads on 8
# KV heads of 128, so 8 query heads share a KV head in the decode
JAMBA_PREFILL = dict(b=8, s=512, H=64, K=8, D=128)
JAMBA_DECODE = dict(b=8, S=544, H=64, K=8, D=128)
MLA_DECODE = dict(b=8, S=544, H=128, r=512, dr=64)
# mamba2-130m's SSD scan at b=8, prompt 512 (24 heads of P=64, state N=128),
# and at one 32,768-token prompt, the JAX package's prefill_32k length
SSD_PREFILL = dict(b=8, s=512, h=24, P=64, N=128)
SSD_LONG = dict(b=1, s=32_768, h=24, P=64, N=128)
# jamba's SSD scan at the b=8 prefill: d_inner 16,384 as 256 heads of 64
SSD_JAMBA = dict(b=8, s=512, h=256, P=64, N=128)
# the SSD gradient at mamba2-130m's training microbatch (b=1 of 8, s=1024)
SSD_TRAIN = dict(b=1, s=1024, h=24, P=64, N=128)
# stablelm-12b's attention at b=8, prompt 512 + 32 new tokens: 32 query
# heads on 8 KV heads of 160, so 4 query heads share a KV head in the decode
STABLELM_PREFILL = dict(b=8, s=512, H=32, K=8, D=160)
STABLELM_DECODE = dict(b=8, S=544, H=32, K=8, D=160)
# deepseek-v2's MLA training microbatch: b=1, s=1024, H=K=128 at qk width
# dn + dr = 192 (v zero-padded to it), causal
MLA_TRAIN = dict(b=1, s=1024, H=128, D=192)
# stablelm-12b's training microbatch: b=1, s=1024, 32 query heads on 8 KV
# heads of 160, causal
STABLELM_TRAIN = dict(b=1, s=1024, H=32, K=8, D=160)
# one rank of gpt2-7b's (d=8, t=2) plan in phase (m): b=1, s=1024, 16 of its
# 32 heads of 128, causal
GPT2_7B_T2 = dict(b=1, s=1024, H=16, D=128)
# one rank's attention in phase (f), b=1, s=1024, causal: deepseek-v2's MLA
# at t=16 and t=8 (8 and 16 of its 128 heads of dn + dr = 192), jamba's GQA
# at t=8 (8 of its 64 query heads on 1 of its 8 KV heads of 128); and in
# phase (p) deepseek-v2's at t=16 over train_4k's s=4,096
RANK_ATTENTION = {"mla_t16": dict(b=1, s=1024, H=8, K=8, D=192),
                  "mla_t8": dict(b=1, s=1024, H=16, K=16, D=192),
                  "jamba_t8": dict(b=1, s=1024, H=8, K=1, D=128),
                  "mla_t16_s4096": dict(b=1, s=4096, H=8, K=8, D=192)}
# one rank's SSD scan and gradient in phase (f), b=1, s=1024, P=64, N=128:
# jamba at t=8 (32 of its 256 heads), mamba2-130m at t=4 and t=8 (6 and 3
# of its 24)
SSD_RANKS = {"jamba_t8_h32": 32, "mamba2_t4_h6": 6, "mamba2_t8_h3": 3}

# Phase (f): rank 0 of multi-device plans of the MLA, MoE and Mamba2
# families, as phase (m) runs the Fig 6 combos (fake process group, s=1024,
# microbatch 1, block remat, one step): (arch, cut, global batch, d, t,
# ZeRO stages).  ``run_one`` draws rank 0's shards at their own shapes:
# one stacked expert leaf of deepseek-v2 is 151 GB whole.  The port's
# exact_peak_bytes for each, on
# the CPU: deepseek 20,400,381,379 B; jamba 37,990,310,579 (ZeRO 1) and
# 29,525,686,835 (ZeRO 3); mamba2 1,510,496,771 at (2,4) and 1,395,313,555
# at (1,8).
# - deepseek-v2-236b, no cut: 60 layers, 160 routed experts top-6 and 2
#   shared, 128 heads of 192 -- rank 0 holds 8 heads and 10 experts of
#   each layer, a 13.3 GB state.  Not at ZeRO 1: the model-local bf16
#   gradient (2W/t, ~29.9 GB) beside its 48.5 GB prediction would crowd
#   the card.
# - jamba-1.5-large-398b, one 8-layer block of its 72 (the layer pattern
#   repeats every 8), all 16 experts: rank 0 holds 2 experts, 8 query heads
#   on 1 KV head and 32 SSM heads; the whole 72 layers at (4,8) are
#   predicted ~9x the block.
# - mamba2-130m, whole: 6 SSM heads a rank at (2,4), 3 at (1,8); at (2,4)
#   also ZeRO 3, where its per-head and per-channel vectors shard over data
#   on the stacked layer axis only and are gathered whole before the
#   blocks (1,510,496,771 B predicted at ZeRO 1, 1,468,597,139 at ZeRO 3;
#   the six gathered leaves hold 112,320 B on rank 0).
# Every head count divides its t; each plan is accepted by
# ``check_sharded_supported``.
FAMILY_PLANS = [("deepseek-v2-236b", {}, 16, 16, 16, (3,)),
                ("jamba-1.5-large-398b", dict(num_layers=8), 4, 4, 8, (1, 3)),
                ("mamba2-130m", {}, 8, 2, 4, (1, 3)),
                ("mamba2-130m", {}, 8, 1, 8, (1,))]


# Phase (q): rank 0 (and rank t - 1 = 15 where a second rank is listed) of
# the (16, 16) production plan of each GQA config whose head counts do not
# divide t = 16, so that its attention runs the head_dim / seq fallback:
# the weights shard their head_dim, each rank attends its 256 of train_4k's
# 4,096 query rows against every key at query offset 256 r.  Under the fake
# process group a rank's collectives do not communicate, so rank 0 runs at
# offset 0 and rank 15 at 3,840, the largest offset and the most causal
# work.  Whole configs at published widths and depth, global batch 16
# (microbatch 1, one row a data rank), one step, ZeRO from
# ``launch.inputs.default_train_config`` (3 above 20e9 parameters, else 1).
# The port's exact_peak_bytes for each, on the CPU: stablelm-12b 5.45 GB,
# llama3.2-3b 2.70, mixtral-8x22b 15.17, jamba-1.5-large-398b (all 72
# layers, 16 experts) 37.53, starcoder2-7b 3.92, musicgen-medium 1.86,
# llava-next-34b 7.65 (its 2,880 modal positions inside the 4,096).
# (arch, ranks)
SEQ_PLANS = [("stablelm-12b", (0, 15)), ("llama3.2-3b", (0,)),
             ("mixtral-8x22b", (0,)), ("jamba-1.5-large-398b", (0, 15)),
             ("starcoder2-7b", (0,)), ("musicgen-medium", (0,)),
             ("llava-next-34b", (0,))]
SEQ_MESH, SEQ_LEN, SEQ_BATCH = (16, 16), 4096, 16
# The same ranks' peaks before the logits were kept sharded over the
# vocabulary (every model rank gathered all of them), NVIDIA H100 80GB
# HBM3 at 700.00 W, phase (q) of this script at the commit that added it:
# {(arch, rank): bytes}; each plan's prediction is unchanged.
SEQ_GATHERED_PEAK = {("stablelm-12b", 0): 13_148_228_096,
                     ("stablelm-12b", 15): 13_148_228_096,
                     ("llama3.2-3b", 0): 12_980_440_576,
                     ("mixtral-8x22b", 0): 15_856_322_560,
                     ("jamba-1.5-large-398b", 0): 41_960_960_000,
                     ("jamba-1.5-large-398b", 15): 41_960_960_000,
                     ("starcoder2-7b", 0): 7_167_567_360,
                     ("musicgen-medium", 0): 1_177_666_560,
                     ("llava-next-34b", 0): 13_271_535_616}

# Phase (p): rank 0 of the two-pod (2, 16, 16) train_4k plan, ("pod",
# "data", "model"), whose 32 data shards run over the flattened pod and
# data axes: s = 4,096, global batch 32 (one row a data shard,
# microbatch 1), one step, ZeRO from ``launch.inputs.default_train_config``
# (3 above 20e9 parameters, else 1), whole at published widths and depth.
# - llama3.2-3b (ZeRO 1): tied, 24/8 heads on t = 16, the head_dim / seq
#   fallback and a vocabulary-sharded tied head; predicted 2,585,820,351 B.
# - deepseek-v2-236b (ZeRO 3): MLA by head, expert-parallel MoE, every
#   leaf gathered over 32 data shards; predicted 13,570,287,739 B.
POD_PLANS = ["llama3.2-3b", "deepseek-v2-236b"]
POD_MESH, POD_BATCH = (2, 16, 16), 32
# Phase 2's cases at those plans' local shapes, b=1: 256 query rows against
# 4,096 keys at offset 0 (rank 0) or 3,840 (rank 15); starcoder2-7b's last
# rank at s=8,192, where its 4,096-key window leaves keys 0-3,584 unseen.
# (sq, sk, H, K, D, offset, window)
SEQ_ATTENTION = {"stablelm_r0": (256, 4096, 32, 8, 160, 0, 0),
                 "stablelm_r15": (256, 4096, 32, 8, 160, 3840, 0),
                 "jamba_r15": (256, 4096, 64, 8, 128, 3840, 0),
                 "musicgen_r15": (256, 4096, 24, 24, 64, 3840, 0),
                 "starcoder2_7b_r15": (256, 4096, 36, 4, 128, 3840, 0),
                 "starcoder2_7b_band": (512, 8192, 36, 4, 128, 7680, 4096)}


# Phase (v): one rank of the sharded serving steps (the JAX package's dry
# run, repro/launch/dryrun.py:77-116) on the (16, 16) production mesh,
# under the fake process group, whole configs at published widths and
# depth, weights drawn at their shards' shapes (over the data axes too
# where ``launch.inputs.serve_weights_over_data`` says so), one prefill of
# the rank's rows or one decode step at position cache_len - 1 (every slot
# valid) through ``repro_torch.launch.memcheck.run_serve``:
# - llama3.2-3b decode_32k: 8 rows a data rank, 24/8 heads on t = 16, the
#   head_dim / seq fallback: 8 columns of 32,768 slots a rank, moved to
#   2,048 slots of every column for the GQA decode, merged over the model
#   axis by the log-sum-exp; and prefill_32k: 2 rows of 32,768, 2,048
#   query rows a rank at offset 0;
# - deepseek-v2-236b decode_32k: MLA on 8 of 128 heads, the latent cache
#   of 8 rows x 32,768 slots replicated over the model axis (~18 GB a
#   rank), 10 of 160 experts, weights over data too, gathered a layer at a
#   time;
# - jamba-1.5-large-398b long_500k: one row, its 524,288 slots split over
#   the 16 data ranks (32,768 a rank, 2,048 after the all-to-all), the
#   fallback attention merged over the model and the data axes, 16 of 256
#   SSM heads, one of 16 experts, weights over data; as rank 0 and rank 15.
# (arch, shape, ranks)
SERVE_PLANS = [("llama3.2-3b", "decode_32k", (0,)),
               ("llama3.2-3b", "prefill_32k", (0,)),
               ("deepseek-v2-236b", "decode_32k", (0,)),
               ("jamba-1.5-large-398b", "long_500k", (0, 15))]
SERVE_MESH = (16, 16)
# phase 2's ``flash_decode_gqa(..., return_lse=True)`` at those decode
# plans' local shapes after the all-to-all (every slot valid)
LSE_DECODE = {"llama_decode_32k_rank": dict(b=8, S=2048, H=24, K=8, D=128),
              "jamba_long_500k_rank": dict(b=1, S=2048, H=64, K=8, D=128)}
# and the other kernels phase (v) launches, at its local shapes (every slot
# valid): deepseek-v2's MLA decode on its rank's 8 heads over the 32,768
# latent slots, and llama3.2-3b's prefill_32k attention, 2 rows of 2,048
# query rows at offset 0 (rank 0) against the 32,768 keys
MLA_SERVE_DECODE = dict(b=8, S=32_768, H=8, r=512, dr=64)
SERVE_ATTENTION = {"llama_prefill_32k_r0": dict(b=2, sq=2048, sk=32_768, H=24,
                                                 K=8, D=128, q_offset=0)}


def seq_plan_config(arch, batch=SEQ_BATCH, mesh=SEQ_MESH):
    """(cfg, tc, *mesh) of a ``SEQ_PLANS`` plan, or at another global
    batch on another mesh (a ``POD_PLANS`` plan: ``pod_plan_config``)."""
    import dataclasses
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.inputs import default_train_config
    cfg = get_arch(arch)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=SEQ_LEN,
                                global_batch=batch)
    return (cfg, default_train_config(cfg, shape), *mesh)


def pod_plan_config(arch):
    """(cfg, tc, pods, d, t) of a ``POD_PLANS`` plan."""
    return seq_plan_config(arch, POD_BATCH, POD_MESH)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def norms_per_pass(cfg):
    """rms_norm launches in one forward pass of ``cfg`` (a prefill or a
    decode step): each layer's input norm, its FFN's norm where it has an
    FFN, Mamba2's gated norm, MLA's latent norms (kv_ln, and q_ln with a
    query rank); then the final norm."""
    n = 1
    for l in range(cfg.num_layers):
        n += 1 + (cfg.layer_is_moe(l) or cfg.d_ff > 0)
        if cfg.layer_kind(l) == "ssm":
            n += 1
        elif cfg.attention == "mla":
            n += 1 + bool(cfg.q_lora_rank)
    return n


def demangle(mangled):
    """``name<args>`` of a kernel from its mangled name: the last
    length-prefixed component of the nested name and its template
    arguments (integers, float, named types)."""
    s = re.sub(r"^_ZN?", "", mangled)
    parts = []
    while (m := re.match(r"\d+", s)):
        n = int(m.group())
        parts.append(s[m.end():m.end() + n])
        s = s[m.end() + n:]
    if not parts:
        return mangled
    args = []
    if s.startswith("I"):
        s = s[1:]
        while s and s[0] != "E":
            if (m := re.match(r"Li(-?\d+)E", s)):
                args.append(m.group(1))
            elif (m := re.match("f", s)):
                args.append("float")
            elif (m := re.match(r"\d+", s)):
                n = int(m.group())
                args.append(s[m.end():m.end() + n])
                s = s[m.end() + n:]
                continue
            else:
                break
            s = s[m.end():]
    return f"{parts[-1]}<{', '.join(args)}>" if args else parts[-1]


def ptxas_report(log):
    """{mangled kernel: dict of registers, stack, spill bytes and static
    shared memory} from a ``ptxas -v`` log."""
    out, cur, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        if (m := re.search(r"Compiling entry function '([^']+)'", line)):
            cur = m.group(1)
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                             r" (\d+) bytes spill loads", line)):
            frame = tuple(int(x) for x in m.groups())
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur] = dict(registers=int(m.group(1)), stack=frame[0],
                            spill_stores=frame[1], spill_loads=frame[2],
                            static_smem=int(smem.group(1)) if smem else 0)
            cur, frame = None, (0, 0, 0)
    return out


def sass_opcodes(lib):
    """{mangled kernel: Counter of SASS opcodes (HMMA, ATOMG, ...)} from
    ``cuobjdump -sass`` of a built library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if (m := re.search(r"Function : (\S+)", line)):
            cur = out.setdefault(m.group(1), Counter())
        elif cur is not None and (m := re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9]*)", line)):
            cur[m.group(1)] += 1
    return out


def report_build():
    """Per kernel of every source: registers, spills and static shared
    memory from the ptxas log (dynamic shared memory is set at launch),
    and tensor-core instructions from the SASS.  Fails unless every bf16
    body of MMA_KERNELS (attention at every head dim, the SSD scan's and
    the MLA decode's at both widths) has HMMA (or HGMMA) instructions and
    the gradient kernels and the norm have no atomics."""
    from repro_torch.kernels import _build
    for src in _build.sources():
        lib = _build.library(src)
        report = ptxas_report(lib.with_suffix(".log").read_text())
        sass = sass_opcodes(lib)
        for mangled in sorted(report, key=demangle):
            r, ops = report[mangled], sass.get(mangled, Counter())
            print(f"build {src}: {demangle(mangled)}: {r['registers']} registers,"
                  f" {r['spill_stores']} B spill stores, {r['spill_loads']} B"
                  f" spill loads, {r['stack']} B stack, {r['static_smem']} B"
                  f" static smem, {ops['HMMA'] + ops['HGMMA']} HMMA/HGMMA")
        if src in ("flash_attention_bwd", "ssd_scan_bwd", "rms_norm"):
            # ATOM* and RED are memory atomics; REDUX is a warp reduction
            atomics = sum(c for ops in sass.values() for op, c in ops.items()
                          if op.startswith("ATOM") or op == "RED")
            print(f"sass {src}: {atomics} atomic instructions"
                  f" {'ok' if atomics == 0 else 'FAIL'}")
            check(atomics == 0, f"{src} uses atomics")
        if src not in MMA_KERNELS:
            continue
        labels = Counter()
        for mangled, ops in sass.items():
            labels[demangle(mangled)] += ops["HMMA"] + ops["HGMMA"]
        for names, dims in MMA_KERNELS[src]:
            for name in names:
                for D in dims:
                    n = sum(c for label, c in labels.items()
                            if label.startswith(f"{name}<{D}>") or
                            label.startswith(f"{name}<{D},"))
                    print(f"sass {src}: {name}<{D}> bf16: {n} HMMA/HGMMA"
                          f" {'ok' if n > 0 else 'FAIL'}")
                    check(n > 0, f"{name}<{D}> has no tensor-core instruction")


def time_ms(fn, flush, iters=20):
    """Mean device time of fn() over iters launches, each after an L2 flush
    (the serving path finds its attention inputs cold: the weights of a
    layer stream through the cache between two attention calls).  A spin
    kernel after the flush keeps the card busy while the host issues fn(),
    so the events time the device's work and not the host's."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def device_profile(fn, n):
    """Device time per call of fn() over n calls, from a torch.profiler
    trace: (busy ms, [(kernel name, ms)] largest first, device events per
    call).  Busy is the sum of the device events' durations; the path runs
    on one stream, so they do not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n)
                      for e in events), key=lambda r: -r[1])
    return (sum(ms for _, ms in kernels), kernels,
            sum(e.count for e in events) / n)


def bound(nbytes, flops, peaks, rate=None):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the flops over ``rate`` (default: bf16 tensor cores)."""
    t_bytes, t_ops = nbytes / peaks[0], flops / (rate or peaks[1])
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_max_err(got, want):
    """max|got - want| / max|want|, in float32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def close(got, want, tol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    return ok, err.max().item()


def ring_valid(gen, b, S):
    """(b, S) ring-buffer validity of rows at random positions in [1, 2S)."""
    pos = torch.randint(1, 2 * S, (b,), generator=gen, device="cuda")
    age = (pos[:, None] % S - torch.arange(S, device="cuda")[None]) % S
    return age <= torch.clamp(pos[:, None], max=S - 1)


def phase_kernels(peaks, flush):
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_lse)
    from repro_torch.kernels.flash_decode import (flash_decode_gqa,
                                                  gqa_decode_ref,
                                                  gqa_decode_splitk)
    from repro_torch.kernels.flash_decode.flash_decode import block_s
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = {}
    bf16, f32 = torch.bfloat16, torch.float32
    p = PREFILL
    attn_cases = [
        ("prefill", p["b"], p["s"], p["s"], p["H"], p["K"], p["D"], True, 0, bf16),
        ("window64", 2, 512, 512, 24, 8, 128, True, 64, bf16),
        ("noncausal_sq!=sk", 2, 96, 200, 8, 2, 64, False, 0, bf16),
        ("fp32_D32", 2, 160, 160, 8, 4, 32, True, 0, f32),
        ("ragged_s129", 2, 129, 129, 8, 2, 128, True, 0, bf16),
        ("jamba_prefill", *(JAMBA_PREFILL[k] for k in "bs"), JAMBA_PREFILL["s"],
         *(JAMBA_PREFILL[k] for k in "HKD"), True, 0, bf16),
        ("stablelm_prefill", *(STABLELM_PREFILL[k] for k in "bs"),
         STABLELM_PREFILL["s"], *(STABLELM_PREFILL[k] for k in "HKD"), True, 0,
         bf16),
        ("stablelm_window64", 2, 512, 512, 32, 8, 160, True, 64, bf16),
        ("stablelm_noncausal_sq!=sk", 2, 96, 200, 8, 2, 160, False, 0, bf16),
        ("stablelm_fp32_ragged", 2, 130, 130, 8, 2, 160, True, 0, f32),
        *((name, c["b"], c["s"], c["s"], c["H"], c["K"], c["D"], True, 0, bf16)
          for name, c in RANK_ATTENTION.items()),
    ]
    for name, b, sq, sk, H, K, D, causal, window, dt in attn_cases:
        q, k, v = randn(b, sq, H, D, dtype=dt), randn(b, sk, K, D, dtype=dt), \
            randn(b, sk, K, D, dtype=dt)
        got, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        ok, err = close(got, want, tol)
        # lse is float32 from float32 scores whatever the inputs' dtype
        ok_lse, err_lse = close(lse, attention_lse_ref(
            q, k, causal=causal, window=window), FP32_TOL)
        print(f"kernel flash_attention {name} b={b} sq={sq} sk={sk} H={H} K={K}"
              f" D={D} causal={causal} window={window} {str(dt)[6:]}:"
              f" max_abs_err={err:.3e} tol={tol:g}, lse max_abs_err="
              f"{err_lse:.3e} tol={FP32_TOL:g} {'ok' if ok and ok_lse else 'FAIL'}")
        check(ok and ok_lse,
              f"flash_attention {name} disagrees with its plain version")
        if name not in ("prefill", "jamba_prefill", "stablelm_prefill",
                        *RANK_ATTENTION):
            continue
        pos_q = torch.arange(sq, device="cuda")[:, None]
        pos_k = torch.arange(sk, device="cuda")[None]
        pairs = int((pos_k <= pos_q).sum()) if causal else sq * sk
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        bound_ms, bound_by = bound(nbytes, 4 * D * b * H * pairs, peaks)
        if name != "prefill":
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            print(f"time flash_attention {name} (D={D}, {nbytes} bytes):"
                  f" bound {bound_ms:.4f} ms"
                  f" ({bound_by}), kernel"
                  f" {time_ms(lambda: flash_attention(q, k, v, causal=True), flush):.4f}"
                  f" ms, plain {time_ms(lambda: attention_ref(q, k, v, causal=True), flush):.4f}"
                  f" ms, library (SDPA) {time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), flush):.4f} ms")
            continue
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows["flash_attention"] = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:78",
            max_abs_err=err,
            ms=time_ms(lambda: flash_attention(q, k, v, causal=True), flush),
            plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=True), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush))

    d, j = DECODE, JAMBA_DECODE
    for name, b, S, H, K, D, dt in [
            ("decode_ring", d["b"], d["S"], d["H"], d["K"], d["D"], bf16),
            ("masked_block", 4, 700, 24, 8, 128, bf16),
            ("invalid_row", 4, 300, 8, 2, 32, f32),
            ("jamba_decode_G8", j["b"], j["S"], j["H"], j["K"], j["D"], bf16),
            ("jamba_invalid_row_G8", 4, 300, 64, 8, 128, f32),
            ("stablelm_decode", *(STABLELM_DECODE[k] for k in "bSHKD"), bf16),
            ("stablelm_masked_block", 4, 700, 32, 8, 160, bf16),
            ("stablelm_invalid_row_fp32", 4, 300, 32, 8, 160, f32)]:
        q, k, v = randn(b, 1, H, D, dtype=dt), randn(b, S, K, D, dtype=dt), \
            randn(b, S, K, D, dtype=dt)
        valid = ring_valid(gen, b, S)
        bs = block_s(k)                  # the kernel's split of this cache
        if "masked_block" in name:       # two whole splits masked
            valid[:, bs:3 * bs] = False
            valid[:, 0] = True
        if "invalid_row" in name:
            valid[1] = False
        got = flash_decode_gqa(q, k, v, valid)
        # non-finite values in masked slots must not reach the output
        k_bad, v_bad = k.clone(), v.clone()
        k_bad[~valid] = float("nan")
        v_bad[~valid] = float("inf")
        unread = torch.equal(flash_decode_gqa(q, k_bad, v_bad, valid), got)
        del k_bad, v_bad
        want = gqa_decode_splitk(q, k, v, valid, block_s=bs)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        ok, err = close(got, want, tol)
        if not valid[1].any():
            ok = ok and bool((got[1] == 0).all())
            live = valid.any(dim=1)
            ok_ref, _ = close(got[live], gqa_decode_ref(q[live], k[live], v[live],
                                                        valid[live]), tol)
        else:
            ok_ref, _ = close(got, gqa_decode_ref(q, k, v, valid), tol)
        print(f"kernel flash_decode_gqa {name} b={b} S={S} H={H} K={K} D={D}"
              f" {str(dt)[6:]}, {bs}-row splits: max_abs_err={err:.3e} (vs"
              f" split-KV plain at the kernel's split)"
              f" tol={tol:g}, masked slots never read {unread}"
              f" {'ok' if ok and ok_ref and unread else 'FAIL'}")
        check(ok and ok_ref and unread,
              f"flash_decode_gqa {name} disagrees with its plain versions")
        if name not in ("decode_ring", "jamba_decode_G8", "stablelm_decode"):
            continue
        # the function needs q, the valid rows of K and V and the mask, and
        # writes the output; masked rows are neither read nor computed on
        n_valid = int(valid.sum())
        nbytes = (2 * (q.numel() + got.numel()) + 2 * 2 * K * D * n_valid
                  + valid.numel())
        bound_ms, bound_by = bound(nbytes, 4 * D * H * n_valid, peaks)
        if name != "decode_ring":
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            print(f"time flash_decode_gqa {name} (D={D}): {n_valid} of {b * S}"
                  f" rows valid, {nbytes} bytes, bound {bound_ms:.4f} ms"
                  f" ({bound_by}), kernel"
                  f" {time_ms(lambda: flash_decode_gqa(q, k, v, valid), flush):.4f}"
                  f" ms, plain {time_ms(lambda: gqa_decode_ref(q, k, v, valid), flush):.4f}"
                  f" ms, library (SDPA) {time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid[:, None, None, :], enable_gqa=True), flush):.4f} ms")
            continue
        print(f"time flash_decode_gqa inputs: {n_valid} of {b * S} cache rows"
              f" valid, {nbytes} bytes needed")
        # the call's two kernels, partials and merge, from a trace
        _, split_ms, _ = device_profile(lambda: flash_decode_gqa(q, k, v, valid), 20)
        print("time flash_decode_gqa kernels (ms per call, traced, L2 warm): "
              + "; ".join(f"{kn[:40]} {ms:.4f}" for kn, ms in split_ms))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = valid[:, None, None, :]
        rows["flash_decode_gqa"] = dict(
            name="flash_decode_gqa", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode/flash_decode.py:83",
            max_abs_err=err,
            ms=time_ms(lambda: flash_decode_gqa(q, k, v, valid), flush),
            plain_ms=time_ms(lambda: gqa_decode_ref(q, k, v, valid), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), flush))
    for name, c in LSE_DECODE.items():
        b, S, H, K, D = (c[x] for x in "bSHKD")
        q, k, v = randn(b, 1, H, D, dtype=bf16), randn(b, S, K, D, dtype=bf16), \
            randn(b, S, K, D, dtype=bf16)
        valid = torch.ones((b, S), dtype=torch.bool, device="cuda")
        o, lse = flash_decode_gqa(q, k, v, valid, return_lse=True)
        want_o, want_lse = gqa_decode_ref(q, k, v, valid, return_lse=True)
        split_o, split_lse = gqa_decode_splitk(q, k, v, valid, block_s=block_s(k),
                                               return_lse=True)
        ok, err = close(o, want_o, BF16_TOL)
        ok_split, _ = close(o, split_o, BF16_TOL)
        err_lse = (lse - want_lse).abs().max().item()
        plain_bits = torch.equal(flash_decode_gqa(q, k, v, valid), o.to(bf16))
        # a rank holding no valid slot: 0 and -inf exactly
        none_o, none_lse = flash_decode_gqa(q, k, v, torch.zeros_like(valid),
                                            return_lse=True)
        empty = bool((none_o == 0).all()) and bool((none_lse == -math.inf).all())
        good = ok and ok_split and err_lse <= BF16_TOL and plain_bits and empty
        print(f"kernel flash_decode_gqa return_lse {name} b={b} S={S} H={H} K={K}"
              f" D={D} bf16: out max_abs_err={err:.3e} tol={BF16_TOL:g}, lse"
              f" max_abs_err={err_lse:.3e}, without the flag the float32 output"
              f" rounded once {plain_bits}, no valid slot gives 0 and -inf"
              f" {empty} {'ok' if good else 'FAIL'}")
        check(good, f"flash_decode_gqa return_lse {name} disagrees with its"
                    f" plain version")
        nbytes = (2 * q.numel() + 2 * 2 * K * D * b * S + 4 * (o.numel() + lse.numel())
                  + valid.numel())
        bound_ms, bound_by = bound(nbytes, 4 * D * H * b * S, peaks)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        print(f"time flash_decode_gqa return_lse {name} (phase (v)): {nbytes}"
              f" bytes, bound {bound_ms:.4f} ms ({bound_by}), kernel"
              f" {time_ms(lambda: flash_decode_gqa(q, k, v, valid, return_lse=True), flush):.4f}"
              f" ms (without the flag"
              f" {time_ms(lambda: flash_decode_gqa(q, k, v, valid), flush):.4f} ms), plain {time_ms(lambda: gqa_decode_ref(q, k, v, valid, return_lse=True), flush):.4f}"
              f" ms, library (SDPA) {time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True), flush):.4f} ms")
    for name, c in SERVE_ATTENTION.items():
        b, sq, sk, H, K, D = (c[x] for x in ("b", "sq", "sk", "H", "K", "D"))
        kw = dict(causal=True, q_offset=c["q_offset"])
        q, k, v = randn(b, sq, H, D, dtype=bf16), randn(b, sk, K, D, dtype=bf16), \
            randn(b, sk, K, D, dtype=bf16)
        got, lse = flash_attention_lse(q, k, v, **kw)
        # the plain version a row at a time for the check: its float32
        # scores over the whole batch take ~13 GB a copy
        want = torch.cat([attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
                          for i in range(b)])
        want_lse = torch.cat([attention_lse_ref(q[i:i + 1], k[i:i + 1], **kw)
                              for i in range(b)])
        ok, err = close(got, want, BF16_TOL)
        ok_l, err_l = close(lse, want_lse, FP32_TOL)
        del want, want_lse
        print(f"kernel flash_attention {name} b={b} sq={sq} sk={sk} H={H} K={K}"
              f" D={D} q_offset={kw['q_offset']} causal bf16 (phase (v)):"
              f" max_abs_err={err:.3e} tol={BF16_TOL:g}, lse max_abs_err="
              f"{err_l:.3e} tol={FP32_TOL:g} {'ok' if ok and ok_l else 'FAIL'}")
        check(ok and ok_l,
              f"flash_attention {name} disagrees with its plain version")
        # q read and o written whole, K and V read at the keys some row
        # reaches; two products over the live pairs
        live = live_pairs(sq, sk, kw["q_offset"], True, 0)
        reached = live.any(0)
        pairs = int(live.sum())
        nbytes = 2 * (2 * q.numel() + 2 * b * K * D * int(reached.sum()))
        bound_ms, bound_by = bound(nbytes, 4 * D * b * H * pairs, peaks)
        # SDPA on the reached keys [lo, hi]: a square block is is_causal,
        # rows ending at the last key causal_lower_right
        from torch.nn.attention.bias import causal_lower_right
        lo, hi = (int(i) for i in reached.nonzero()[[0, -1], 0])
        lib_kw = (dict(is_causal=True) if hi + 1 - lo == sq else
                  dict(attn_mask=causal_lower_right(sq, hi + 1 - lo)))
        qt, kt, vt = (t.transpose(1, 2).contiguous()
                      for t in (q, k[:, lo:hi + 1], v[:, lo:hi + 1]))
        print(f"time flash_attention {name} (phase (v), {pairs} live pairs,"
              f" keys {lo}-{hi} reached, {nbytes} bytes): bound"
              f" {bound_ms:.4f} ms ({bound_by}), kernel"
              f" {time_ms(lambda: flash_attention(q, k, v, **kw), flush):.4f}"
              f" ms, plain {time_ms(lambda: attention_ref(q, k, v, **kw), flush):.4f}"
              f" ms, library (SDPA on the reached keys) {time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **lib_kw), flush):.4f} ms")
        del q, k, v, qt, kt, vt, got, lse, live
    rows.update(phase_mla_kernels(peaks, flush, gen, randn))
    rows.update(phase_attention_bwd(peaks, flush, randn))
    rows.update(phase_adam(peaks, flush, gen))
    rows.update(phase_ssd_kernel(peaks, flush, gen))
    rows.update(phase_ssd_bwd(peaks, flush, gen))
    rows.update(phase_rms_norm(peaks, flush, gen))
    for r in rows.values():
        library = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms,"
              f" plain {r['plain_ms']:.4f} ms, library {library},"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def phase_rms_norm(peaks, flush, gen):
    """The RMSNorm kernel against its plain version (within the kernels'
    tolerance: they sum in other orders), rerun bit-identical, and 8 rows
    at once against each alone bit for bit, at the main paths' widths:
    llama's prefill (its row for the kernels line) and decode, Mamba2's
    gated norm (mamba2-130m's d_inner 1536, jamba's 16384), stablelm's
    5120, float32, and a bf16 x with a float32 scale."""
    from repro_torch.kernels.rms_norm import rms_norm, rms_norm_ref
    bf16, f32 = torch.bfloat16, torch.float32
    row = {}
    for name, rows_, d, dt, sdt in [
            ("llama_prefill", 4096, 3072, bf16, bf16),
            ("llama_decode", 8, 3072, bf16, bf16),
            ("mamba2_gated", 8, 1536, bf16, bf16),
            ("jamba_gated", 8, 16384, bf16, bf16),
            ("stablelm_decode", 8, 5120, bf16, bf16),
            ("fp32_rows37", 37, 768, f32, f32),
            ("bf16_x_fp32_scale", 8, 4096, bf16, f32)]:
        x = (3 * torch.randn(rows_, 1, d, generator=gen, device="cuda")).to(dt)
        scale = torch.randn(d, generator=gen, device="cuda").to(sdt)
        got, _ = rms_norm(x, scale)
        want = rms_norm_ref(x, scale)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        err = rel_max_err(got, want)
        same = torch.equal(rms_norm(x, scale)[0], got)
        alone = torch.cat([rms_norm(x[i:i + 1], scale)[0] for i in range(8)])
        invariant = torch.equal(alone, got[:8])
        plain_alone = torch.cat([rms_norm_ref(x[i:i + 1], scale) for i in range(8)])
        ok = err <= tol and same and invariant
        print(f"kernel rms_norm {name} rows={rows_} d={d} {str(dt)[6:]} scale"
              f" {str(sdt)[6:]}: max|d|/max|ref| {err:.3e} tol={tol:g},"
              f" bit-identical rerun {same}, 8 rows alone = in a batch"
              f" {invariant} (plain version: {torch.equal(plain_alone, want[:8])})"
              f" {'ok' if ok else 'FAIL'}")
        check(ok, f"rms_norm {name} disagrees with its plain version or"
                  f" depends on the rows beside it")
        if name not in ("llama_prefill", "llama_decode"):
            continue
        # x in, y out, the scale and the row scales: one pass of each
        nbytes = 2 * x.numel() * x.element_size() + d * scale.element_size() \
            + 4 * rows_
        bound_ms, bound_by = bound(nbytes, 4 * x.numel(), peaks, rate=peaks[2])
        ms = time_ms(lambda: rms_norm(x, scale), flush)
        plain_ms = time_ms(lambda: rms_norm_ref(x, scale), flush)
        library_ms = time_ms(lambda: F.rms_norm(x, (d,), scale, 1e-5), flush)
        print(f"time rms_norm {name} ({nbytes} bytes): kernel {ms:.4f} ms, plain"
              f" {plain_ms:.4f} ms, library (F.rms_norm) {library_ms:.4f} ms,"
              f" bound {bound_ms:.6f} ms ({bound_by})")
        if name == "llama_prefill":
            row["rms_norm"] = dict(
                name="rms_norm", route="cuda",
                source="src/repro_torch/kernels/csrc/rms_norm.cu",
                replaces="src/repro/models/common.py:8 (rms_norm; no Pallas"
                         " kernel)",
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)
    return row


def phase_mla_kernels(peaks, flush, gen, randn):
    """The MLA decode kernel and the forward attention at the MLA head dims
    against their plain versions; the decode's row for the kernels line and
    the D=192 attention's times on a line of their own."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_decode import (flash_decode_mla,
                                                  mla_decode_ref,
                                                  mla_decode_splitk)
    from repro_torch.kernels.flash_decode.flash_decode_mla import launch_plan
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    d = MLA_DECODE
    for name, b, S, H, r, dr, dt in [
            ("decode_ring", d["b"], d["S"], d["H"], d["r"], d["dr"], bf16),
            ("fp32", d["b"], d["S"], d["H"], d["r"], d["dr"], f32),
            ("smoke_dims", 8, 544, 8, 32, 16, bf16),
            ("smoke_dims_fp32", 3, 300, 8, 32, 16, f32),
            ("masked_block_S700", 4, 700, 128, 512, 64, bf16),
            ("long_S9000", 2, 9000, 128, 512, 64, bf16),
            ("invalid_row_H20", 4, 300, 20, 512, 16, f32),
            ("deepseek_decode_32k_rank", *(MLA_SERVE_DECODE[k] for k in
                                           ("b", "S", "H", "r", "dr")), bf16)]:
        q_lat, q_rope = randn(b, H, r, dtype=dt), randn(b, H, dr, dtype=dt)
        c_kv, k_rope = randn(b, S, r, dtype=dt), randn(b, S, dr, dtype=dt)
        valid = ring_valid(gen, b, S)            # ragged: a position per row
        if name.endswith("_rank"):               # phase (v): every slot valid
            valid[:] = True
        bs, grid, fused = launch_plan(q_lat, c_kv)  # the kernel's split and grid
        if name.startswith("masked_block"):      # two whole splits masked
            valid[:, bs:3 * bs] = False
            valid[:, 0] = True
        if name.startswith("invalid_row"):
            valid[1] = False
        denom = math.sqrt(128 + dr)
        args = (q_lat, q_rope, c_kv, k_rope, valid)
        got = flash_decode_mla(*args, denom=denom)
        want = mla_decode_splitk(*args, denom=denom, block_s=bs)
        live = valid.any(dim=1)
        ref = mla_decode_ref(*(t[live] for t in args), denom=denom)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        err, err_ref = rel_max_err(got, want), rel_max_err(got[live], ref)
        ok = err <= tol and err_ref <= tol and bool((got[~live] == 0).all())
        merge = "in a cluster" if fused else "by a second kernel"
        print(f"kernel flash_decode_mla {name} b={b} S={S} H={H} r={r} dr={dr}"
              f" {str(dt)[6:]}, {bs}-row splits merged {merge}:"
              f" max|d|/max|ref| {err:.3e}"
              f" (split-KV plain at the kernel's split),"
              f" {err_ref:.3e} (whole-cache plain) tol={tol:g}"
              f" {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_decode_mla {name} disagrees with its plain versions")
        # the function needs the queries, the valid rows of c_kv and k_rope
        # and the mask, and writes o_lat; per valid row and head it does
        # 2(r + dr) flops of scores and 2r of p.c_kv
        n_valid = int(valid.sum())
        nbytes = (2 * (q_lat.numel() + q_rope.numel() + got.numel())
                  + 2 * (r + dr) * n_valid + valid.numel())
        bound_ms, bound_by = bound(nbytes, H * n_valid * (4 * r + 2 * dr),
                                   peaks)
        # SDPA on the MQA form: one shared key [c_kv | k_rope], value c_kv
        qm = torch.cat([q_lat, q_rope], dim=-1)[:, :, None]   # (b, H, 1, r+dr)
        km = torch.cat([c_kv, k_rope], dim=-1)[:, None]       # (b, 1, S, r+dr)
        vm = c_kv[:, None]
        mask = valid[:, None, None, :]
        if name.endswith("_rank"):
            print(f"time flash_decode_mla {name} (phase (v), {n_valid} of"
                  f" {b * S} rows valid, {bs}-row splits, grid {grid},"
                  f" {nbytes} bytes): bound {bound_ms:.4f} ms ({bound_by}),"
                  f" kernel {time_ms(lambda: flash_decode_mla(*args, denom=denom), flush):.4f}"
                  f" ms, plain {time_ms(lambda: mla_decode_ref(*args, denom=denom), flush):.4f}"
                  f" ms, library (SDPA on the MQA form)"
                  f" {time_ms(lambda: F.scaled_dot_product_attention(qm, km, vm, attn_mask=mask, scale=1.0 / denom, enable_gqa=True), flush):.4f} ms")
        if name != "decode_ring":
            continue
        # the split does not depend on the batch: each row alone gives the
        # same bits as in the batch
        alone = torch.cat([flash_decode_mla(*(t[i:i + 1] for t in args),
                                            denom=denom) for i in range(b)])
        print(f"kernel flash_decode_mla {name}: each row alone equals the"
              f" batch bit for bit: {torch.equal(alone, got)}")
        check(torch.equal(alone, got),
              "flash_decode_mla's output depends on the batch around a row")
        partial_bytes = 4 * b * grid[0] * H * (r + 2)
        merged = (f"merged in clusters of {grid[0]} splits, so"
                  f" {partial_bytes} bytes of float32 partials stay on chip"
                  if fused else f"{partial_bytes} bytes of float32 partials"
                  f" merged by a second kernel")
        print(f"time flash_decode_mla inputs: {n_valid} of {b * S} cache rows"
              f" valid, {nbytes} bytes needed; {bs}-row splits, grid {grid}"
              f" = {math.prod(grid)} blocks, {merged}; library is SDPA on the"
              f" MQA form (one shared key [c_kv | k_rope], value c_kv)")
        # the call's kernels from a trace
        _, split_ms, _ = device_profile(
            lambda: flash_decode_mla(*args, denom=denom), 20)
        print("time flash_decode_mla kernels (ms per call, traced, L2 warm): "
              + "; ".join(f"{kn[:48]} {ms:.4f}" for kn, ms in split_ms))
        rows["flash_decode_mla"] = dict(
            name="flash_decode_mla", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode_mla.cu",
            replaces="src/repro/kernels/flash_decode/flash_decode.py:158",
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            ms=time_ms(lambda: flash_decode_mla(*args, denom=denom), flush),
            plain_ms=time_ms(lambda: mla_decode_ref(*args, denom=denom), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qm, km, vm, attn_mask=mask, scale=1.0 / denom,
                enable_gqa=True), flush))

    p = MLA_PREFILL
    for name, b, s, H, D, dt in [("mla_prefill", p["b"], p["s"], p["H"], p["D"], bf16),
                                 ("smoke_dims", 2, 512, 8, 48, bf16),
                                 ("fp32_ragged", 2, 100, 8, 48, f32),
                                 ("fp32_ragged", 2, 100, 8, 192, f32)]:
        q, k, v = (randn(b, s, H, D, dtype=dt) for _ in range(3))
        scale = D ** -0.5
        got = flash_attention(q, k, v, causal=True, softmax_scale=scale)
        want = attention_ref(q, k, v, causal=True, softmax_scale=scale)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        err = rel_max_err(got, want)
        print(f"kernel flash_attention {name} b={b} s={s} H=K={H} D={D} causal"
              f" {str(dt)[6:]}: max|d|/max|ref| {err:.3e} tol={tol:g}"
              f" {'ok' if err <= tol else 'FAIL'}")
        check(err <= tol, f"flash_attention D={D} {name} disagrees with its"
                          f" plain version")
        if name != "mla_prefill":
            continue
        nbytes = 2 * 4 * q.numel()
        bound_ms, bound_by = bound(nbytes, 4 * D * b * H * (s * (s + 1) // 2),
                                   peaks)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                             softmax_scale=scale), flush)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True,
                                                 softmax_scale=scale), flush)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale), flush)
        print(f"time flash_attention D=192 (deepseek-v2 MLA prefill b={b}"
              f" s={s} H=K={H}, {nbytes} bytes): kernel {ms:.4f} ms, plain"
              f" {plain_ms:.4f} ms, library {library_ms:.4f} ms (SDPA), bound"
              f" {bound_ms:.4f} ms ({bound_by}), max_abs_err"
              f" {(got.float() - want.float()).abs().max().item():.3e}")
    return rows


def phase_attention_bwd(peaks, flush, randn):
    """The attention backward against its plain versions (explicit and
    autograd through the plain forward), run twice for bit-identical
    gradients, with dK and dV exactly zero on the keys no query row
    reaches.  The cases at a query offset (``SEQ_ATTENTION``'s local shapes
    of phase (q)'s plans, and float32 at two head dims with a window) also
    check the forward and its lse, and time both directions.  Each timed
    shape stands beside its bound, its plain version and SDPA on the keys
    some row reaches (K and V repeated to the query heads), never called on
    a path."""
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_lse)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    # (name, b, sq, sk, H, K, D, causal, window, q_offset, dtype)
    cases = [
        ("train", 1, 1024, 1024, 16, 16, 64, True, 0, 0, bf16),
        ("window64", 2, 512, 512, 24, 8, 128, True, 64, 0, bf16),
        ("gqa", 2, 512, 512, 24, 8, 128, True, 0, 0, bf16),
        ("noncausal_sq!=sk", 2, 96, 200, 8, 2, 64, False, 0, 0, bf16),
        ("fp32_D32", 2, 160, 160, 8, 4, 32, True, 0, 0, f32),
        ("ragged", 2, 100, 100, 8, 4, 64, True, 0, 0, bf16),
        ("mla_train", *(MLA_TRAIN[k] for k in "bss"), MLA_TRAIN["H"],
         *(MLA_TRAIN[k] for k in "HD"), True, 0, 0, bf16),
        ("mla_gqa_window", 2, 300, 300, 8, 2, 192, True, 64, 0, bf16),
        ("mla_no_key_rows", 1, 40, 8, 4, 4, 192, True, 4, 0, bf16),
        ("mla_noncausal_sq!=sk", 2, 96, 200, 4, 2, 192, False, 0, 0, bf16),
        ("mla_fp32_ragged", 1, 130, 130, 4, 4, 192, True, 0, 0, f32),
        ("stablelm_train", *(STABLELM_TRAIN[k] for k in "bss"),
         *(STABLELM_TRAIN[k] for k in "HKD"), True, 0, 0, bf16),
        ("stablelm_gqa_window", 2, 300, 300, 8, 2, 160, True, 64, 0, bf16),
        ("stablelm_no_key_rows", 1, 40, 8, 8, 2, 160, True, 4, 0, bf16),
        ("stablelm_noncausal_sq!=sk", 2, 96, 200, 4, 2, 160, False, 0, 0,
         bf16),
        ("stablelm_fp32_ragged", 1, 130, 130, 8, 2, 160, True, 0, 0, f32),
        ("gpt2_7b_t2", *(GPT2_7B_T2[k] for k in "bss"),
         *(GPT2_7B_T2[k] for k in "HHD"), True, 0, 0, bf16),
        *((name, c["b"], c["s"], c["s"], c["H"], c["K"], c["D"], True, 0, 0,
           bf16) for name, c in RANK_ATTENTION.items()),
        *((name, 1, sq, sk, H, K, D, True, window, offset, bf16)
          for name, (sq, sk, H, K, D, offset, window)
          in SEQ_ATTENTION.items()),
        ("fp32_D64_window", 2, 200, 700, 8, 2, 64, True, 100, 300, f32),
        ("fp32_D160_window", 2, 200, 700, 8, 2, 160, True, 100, 300, f32)]
    for name, b, sq, sk, H, K, D, causal, window, q_offset, dt in cases:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        at_offset = q_offset > 0 or name in SEQ_ATTENTION
        q, k, v = randn(b, sq, H, D, dtype=dt), randn(b, sk, K, D, dtype=dt), \
            randn(b, sk, K, D, dtype=dt)
        do = randn(b, sq, H, D, dtype=dt)
        o, lse = flash_attention_lse(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        explicit = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        tol = BF16_TOL if dt == bf16 else FP32_TOL
        err = max(rel_max_err(g, e) for g, e in zip(got, explicit))
        ok = err <= tol and same and all(
            bool(torch.isfinite(g.float()).all()) for g in got)
        forward = ""
        if at_offset:
            ok_f, err_f = close(o, attention_ref(q, k, v, **kw), tol)
            ok_l, err_l = close(lse, attention_lse_ref(q, k, **kw), FP32_TOL)
            ok = ok and ok_f and ok_l
            forward = f" forward max_abs_err={err_f:.3e}, lse {err_l:.3e};"
        if name.endswith("no_key_rows"):
            # rows 11.. see no key: zero gradients, where autograd through
            # the plain forward (the mean of V there) has none to compare
            err_ag = float("nan")
            ok = ok and not got[0][:, 11:].any()
        else:
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            attention_ref(*leaves, **kw).backward(do)
            err_ag = max(rel_max_err(g, t.grad) for g, t in zip(got, leaves))
            ok = ok and err_ag <= tol
            del leaves
        live = live_pairs(sq, sk, q_offset, causal, window)
        reached = live.any(0)
        zeros = all(not g[:, ~reached].any() for g in got[1:])
        ok = ok and zeros
        print(f"kernel flash_attention_bwd {name} b={b} sq={sq} sk={sk} H={H}"
              f" K={K} D={D} causal={causal} window={window}"
              f" q_offset={q_offset} {str(dt)[6:]}:{forward}"
              f" max|d|/max|ref| {err:.3e} (explicit), {err_ag:.3e}"
              f" (autograd) tol={tol:g}, bit-identical rerun {same}, dK dV"
              f" exactly 0 on the {int((~reached).sum())} keys no row"
              f" reaches {zeros} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention_bwd {name} disagrees with its plain"
                  f" versions, is not deterministic or leaves unreached"
                  f" keys' dK/dV nonzero")
        if dt != bf16 or name not in ("train", "mla_train", "stablelm_train",
                                      "gpt2_7b_t2", *RANK_ATTENTION,
                                      *SEQ_ATTENTION):
            continue
        pairs = int(live.sum())
        # each input read once and each output written once: q, o, dO and
        # dQ whole, K and V read at the keys some row reaches, dK and dV
        # written at every key
        kv_reached = 2 * b * K * D * int(reached.sum())
        nbytes = 2 * (4 * q.numel() + kv_reached + k.numel() + v.numel()) \
            + 4 * lse.numel()
        # the gradient's five products (S, dP, dV, dK, dQ) over the live
        # pairs: 2.5x the forward's two
        bound_ms, bound_by = bound(nbytes, 10 * D * b * H * pairs, peaks)
        # SDPA on the reached keys [lo, hi): a square causal block is its
        # flash path's is_causal; rows ending at the last key are
        # causal_lower_right; a window has no built-in bias, so a boolean
        # mask
        lo, hi = (int(i) for i in reached.nonzero()[[0, -1], 0])
        ks, vs = k[:, lo:hi + 1], v[:, lo:hi + 1]
        if window:
            lib_kw, lib_mask = dict(attn_mask=live[:, lo:hi + 1]), "boolean"
        elif hi + 1 - lo == sq:
            lib_kw, lib_mask = dict(is_causal=True), "is_causal"
        else:
            lib_kw = dict(attn_mask=causal_lower_right(sq, hi + 1 - lo))
            lib_mask = "causal_lower_right"
        # the library time: SDPA's backward alone under each of its
        # backends, the fastest kept -- the default choice moved between
        # runs (cuDNN's ~0.044 ms, the memory-efficient kernel's ~0.14 ms)
        library = sdpa_backward_ms(q, ks, vs, do, flush, **lib_kw)
        if name == "train":
            rows["flash_attention_bwd"] = dict(
                name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:78 (its gradient)",
                max_abs_err=max((g.float() - e.float()).abs().max().item()
                                for g, e in zip(got, explicit)),
                ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                       **kw), flush),
                plain_ms=time_ms(lambda: attention_bwd_ref(q, k, v, o, lse,
                                                           do, **kw), flush),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=min(library.values()))
            print("time flash_attention_bwd library: SDPA backward alone, "
                  + ", ".join(f"{k} {ms:.4f} ms" for k, ms in library.items()))
            continue
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
                     flush)
        plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                     **kw), flush)
        _, parts, _ = device_profile(
            lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), 10)
        library = (", ".join(f"{kb} {m:.4f}" for kb, m in library.items())
                   or "none")
        parts = "; ".join(f"{kn[:40]} {tm:.4f}" for kn, tm in parts)
        if not at_offset:
            cell = {"mla_train": "deepseek-v2 MLA training",
                    "stablelm_train": "stablelm-12b training",
                    "gpt2_7b_t2": "gpt2-7b at t=2, phase (m)",
                    "mla_t16": "deepseek-v2 at t=16, phase (f)",
                    "mla_t16_s4096": "deepseek-v2 at t=16, s=4,096, phase"
                                     " (p)",
                    "mla_t8": "deepseek-v2 at t=8",
                    "jamba_t8": "jamba at t=8, phase (f)"}[name]
            print(f"time flash_attention_bwd D={D} ({cell}"
                  f" b={b} s={sq} H={H} K={K}, {nbytes} bytes,"
                  f" {10 * D * b * H * pairs} flops): kernel {ms:.4f} ms, plain"
                  f" {plain_ms:.4f} ms, library (SDPA's backward alone) "
                  f"{library} ms, bound {bound_ms:.4f} ms ({bound_by});"
                  f" kernels (traced, L2 warm) {parts}")
            continue
        fwd_bytes = 2 * (2 * q.numel() + kv_reached)
        fwd_bound = bound(fwd_bytes, 4 * D * b * H * pairs, peaks)
        G = H // K
        qt, kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous() for t, g in ((q, 1), (ks, G), (vs, G)))
        fwd = [time_ms(lambda: flash_attention(q, k, v, **kw), flush),
               time_ms(lambda: attention_ref(q, k, v, **kw), flush),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, **lib_kw), flush)]
        del qt, kt, vt
        print(f"time flash_attention offset {name} (D={D}, q_offset={q_offset},"
              f" {pairs} live pairs, keys {lo}-{hi} reached, {fwd_bytes}"
              f" bytes): bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}), kernel"
              f" {fwd[0]:.4f} ms, plain {fwd[1]:.4f} ms, library (SDPA on the"
              f" reached keys, {lib_mask}) {fwd[2]:.4f} ms")
        print(f"time flash_attention_bwd offset {name} ({nbytes} bytes,"
              f" {10 * D * b * H * pairs} flops): bound {bound_ms:.4f} ms"
              f" ({bound_by}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
              f" library (SDPA's backward alone on the reached keys,"
              f" {lib_mask}) {library} ms; kernels (traced, L2 warm) {parts}")
    return rows


def live_pairs(sq, sk, offset, causal, window):
    """(sq, sk) bool: the pairs of query rows at positions offset.. against
    keys 0.. that the mask keeps -- the work the kernels do."""
    qp = torch.arange(offset, offset + sq, device="cuda")[:, None]
    kp = torch.arange(sk, device="cuda")[None]
    ok = kp <= qp if causal else torch.ones(sq, sk, dtype=torch.bool,
                                              device="cuda")
    return ok & (kp > qp - window) if window else ok


def sdpa_backward_ms(q, k, v, do, flush, **kw):
    """{backend: ms} of SDPA's backward alone (one autograd.grad on a
    retained graph) on (b, s, heads, D) inputs, under each backend that
    takes them: a yardstick, never called on a path.  With fewer KV heads
    than query heads (GQA) K and V are repeated to the query heads first,
    since SDPA's fused backwards take one head count: its dK and dV are
    then per query head, without the sum over each group."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
                  .requires_grad_(True) for t, g in ((q, 1), (k, G), (v, G)))
    dot = do.transpose(1, 2).contiguous()
    library = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
                library[backend.name] = time_ms(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True), flush)
            del out
        except RuntimeError as err:       # the backend refuses these shapes
            print(f"time SDPA backward {backend.name}: not available at"
                  f" D={q.shape[-1]} ({str(err).splitlines()[0][:80]})")
    return library


def phase_adam(peaks, flush, gen):
    from repro_torch.kernels.adam_update import adam_ref, adam_update
    rows = {}
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1, c1=0.5,
              c2=0.2)
    for shape in [(37,), (1000,), (64, 130), (4096,), (24, 1024, 4096)]:
        g = torch.randn(shape, generator=gen, device="cuda")
        m = torch.randn(shape, generator=gen, device="cuda") * 0.1
        v = torch.randn(shape, generator=gen, device="cuda").abs() * 0.01
        mp = torch.randn(shape, generator=gen, device="cuda")
        want = adam_ref(g, m, v, mp, **kw)
        param = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        adam_update(g, m, v, mp, param, **kw)
        errs = [(a - w).abs().max().item() for a, w in zip((m, v, mp), want)]
        ok = all(bool(((a - w).abs() <= ADAM_ATOL + ADAM_RTOL * w.abs()).all())
                 for a, w in zip((m, v, mp), want))
        ok = ok and torch.equal(param, mp.to(torch.bfloat16))
        print(f"kernel adam_update n={g.numel()} shape={shape}: max_abs_err"
              f" m {errs[0]:.3e} v {errs[1]:.3e} master {errs[2]:.3e}"
              f" atol={ADAM_ATOL:g} rtol={ADAM_RTOL:g}, param = bf16(master')"
              f" {'ok' if ok else 'FAIL'}")
        check(ok, f"adam_update n={g.numel()} disagrees with its plain version")
        if len(shape) < 3:
            continue
        n = g.numel()
        # reads g, m, v, master; writes m, v, master and the bf16 param;
        # ~15 float32 operations an element on the CUDA cores
        bound_ms, bound_by = bound(30 * n, 15 * n, peaks, rate=peaks[2])
        w = g.clone().requires_grad_(True)
        w.grad = g
        opt = torch.optim.AdamW([w], lr=1e-3, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)
        opt.step()                       # creates its m and v
        rows["adam_update"] = dict(
            name="adam_update", route="cuda",
            source="src/repro_torch/kernels/csrc/adam_update.cu",
            replaces="src/repro/kernels/adam_update/adam_update.py:40",
            max_abs_err=max(errs),
            ms=time_ms(lambda: adam_update(g, m, v, mp, param, **kw), flush),
            plain_ms=time_ms(lambda: adam_ref(g, m, v, mp, **kw), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(opt.step, flush))
        print(f"time adam_update inputs: one leaf of {n} parameters"
              f" (gpt2-350m's ffn.w1), {30 * n} bytes; library is"
              f" torch.optim.AdamW(fused=True).step() on the same float32"
              f" leaf, which updates m, v and the weights but writes no bf16"
              f" copy")
        del opt, w
    return rows


def phase_ssd_kernel(peaks, flush, gen):
    """The SSD scan against its plain version at the serving path's shape
    and at edge cases; its row for the kernels line, and the 32k prompt's
    times on a line of their own."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import chunk, segment_chunks
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    p, q, j = SSD_PREFILL, SSD_LONG, SSD_JAMBA
    for name, b, s, h, P, N, dt in [
            ("prefill", p["b"], p["s"], p["h"], p["P"], p["N"], bf16),
            ("prefill_32k", q["b"], q["s"], q["h"], q["P"], q["N"], bf16),
            ("jamba_prefill_h256", j["b"], j["s"], j["h"], j["P"], j["N"], bf16),
            ("ragged", 2, 1000, 24, 64, 128, bf16),
            ("segments_b1", 1, 4096, 24, 64, 128, bf16),
            ("mid_segment_b1", 1, 4000, 24, 64, 128, bf16),
            ("fp32_ragged", 2, 1000, 24, 64, 128, f32),
            ("smoke_dims", 2, 200, 16, 32, 16, bf16),
            ("smoke_dims_fp32", 3, 77, 16, 32, 16, f32),
            *((name, 1, 1024, h, 64, 128, bf16)
              for name, h in SSD_RANKS.items())]:
        args = ssd_inputs(gen, b, s, h, P, N, dt)
        x, dt_raw, A_log, B, C, D, dt_bias = args
        got = ssd_scan(*args)
        want = ssd_scan_ref(*args)
        tol = SSD_BF16_TOL if dt == bf16 else SSD_FP32_TOL
        (ok_y, err_y), (ok_s, err_s) = (close(g, w, tol)
                                        for g, w in zip(got, want))
        seg = (f", segments of {segment_chunks(x) * chunk()} rows"
               if dt == bf16 else "")
        print(f"kernel ssd_scan {name} b={b} s={s} h={h} P={P} N={N}"
              f" {str(dt)[6:]}{seg}: y max_abs_err={err_y:.3e} (max|ref|"
              f" {want[0].float().abs().max().item():.3f}), state"
              f" max_abs_err={err_s:.3e} (max|ref|"
              f" {want[1].abs().max().item():.3f}) tol={tol:g}"
              f" {'ok' if ok_y and ok_s else 'FAIL'}")
        check(ok_y and ok_s, f"ssd_scan {name} disagrees with its plain version")
        if "prefill" not in name and name not in SSD_RANKS:
            continue
        # reads x, dt_raw, B, C and the (h,) vectors, writes y and the
        # float32 state; the products that every chunk length L needs, per
        # (batch, head, position): the state update and C . state (2 P N
        # each).  The chunked form's L x L products (C.B^T, W.x) grow with
        # the kernel's choice of L, so they are not part of the bound.
        L = chunk()
        nbytes = (x.element_size() * (2 * x.numel() + dt_raw.numel()
                                      + B.numel() + C.numel())
                  + 4 * (want[1].numel() + 3 * h))
        flops = b * h * s * 4 * P * N
        bound_ms, bound_by = bound(nbytes, flops, peaks)
        ms = time_ms(lambda: ssd_scan(*args), flush)
        plain_ms = time_ms(lambda: ssd_scan_ref(*args), flush)
        print(f"time ssd_scan {name} inputs: {nbytes} bytes, {flops} flops"
              f" independent of the chunk (the kernel's L={L}): kernel"
              f" {ms:.4f} ms, plain"
              f" {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by});"
              f" no PyTorch call computes the scan")
        _, parts, _ = device_profile(lambda: ssd_scan(*args), 10)
        print(f"time ssd_scan {name} kernels (ms per call, traced, L2 warm): "
              + "; ".join(f"{kn[:40]} {t:.4f}" for kn, t in parts))
        if name == "prefill":
            rows["ssd_scan"] = dict(
                name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/ssd_scan.py:76",
                max_abs_err=max(err_y, err_s), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return rows


def ssd_inputs(gen, b, s, h, P, N, dt):
    """x, dt_raw, A_log, B, C, D, dt_bias as in the JAX package's SSD kernel
    sweep (tests/test_kernels.py:44-52)."""
    return (torch.randn(b, s, h, P, generator=gen, device="cuda").to(dt),
            (torch.randn(b, s, h, generator=gen, device="cuda") * 0.5).to(dt),
            torch.randn(h, generator=gen, device="cuda") * 0.3,
            torch.randn(b, s, N, generator=gen, device="cuda").to(dt),
            torch.randn(b, s, N, generator=gen, device="cuda").to(dt),
            torch.randn(h, generator=gen, device="cuda"),
            torch.full((h,), 0.1, device="cuda"))


def phase_ssd_bwd(peaks, flush, gen):
    """The SSD gradient against its plain version at the training path's
    shape and at edge cases, against autograd through the plain scan at the
    training shape, and run twice for bit-identical results; its row for
    the kernels line."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd, ssd_scan_bwd_ref,
                                              ssd_scan_ref)
    from repro_torch.kernels.ssd_scan.ssd_scan import (
        bwd_chunk, bwd_heads_per_group, bwd_scratch)
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("dx", "ddt_raw", "dA_log", "dB", "dC", "dD", "ddt_bias")
    rows = {}
    t = SSD_TRAIN
    train = (t["b"], t["s"], t["h"], t["P"], t["N"])
    for name, (b, s, h, P, N), dt, with_state in [
            ("train", train, bf16, False),
            ("train_d_state", train, bf16, True),
            ("train_fp32", train, f32, True),
            ("ragged", (2, 1000, 24, 64, 128), bf16, True),
            ("b4", (4, 512, 24, 64, 128), bf16, False),
            ("smoke_dims", (2, 200, 16, 32, 16), bf16, True),
            ("smoke_dims_fp32", (3, 77, 16, 32, 16), f32, False),
            *((name, (1, 1024, h, 64, 128), bf16, False)
              for name, h in SSD_RANKS.items())]:
        args = ssd_inputs(gen, b, s, h, P, N, dt)
        dy = torch.randn(b, s, h, P, generator=gen, device="cuda").to(dt)
        ds = (torch.randn(b, h, P, N, generator=gen, device="cuda")
              if with_state else None)
        got = ssd_scan_bwd(*args, dy, ds)
        again = ssd_scan_bwd(*args, dy, ds)
        want = ssd_scan_bwd_ref(*args, dy, ds)
        tol = SSD_BWD_BF16_TOL if dt == bf16 else SSD_BWD_FP32_TOL
        errs = [rel_max_err(g, w) for g, w in zip(got, want)]
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        ok = max(errs) <= tol and same and all(
            g.dtype == w.dtype and bool(torch.isfinite(g.float()).all())
            for g, w in zip(got, want))
        auto = ""
        if name.startswith("train"):
            # autograd through the plain scan, the port's ssd_chunked
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            y, st = ssd_scan_ref(*leaves)
            loss = (y.float() * dy.float()).sum()
            if ds is not None:
                loss = loss + (st * ds).sum()
            errs_auto = [rel_max_err(g, w) for g, w in
                         zip(got, torch.autograd.grad(loss, leaves))]
            ok = ok and max(errs_auto) <= tol
            auto = (", vs autograd through the plain scan " + " ".join(
                f"{n} {e:.3e}" for n, e in zip(names, errs_auto)))
        grid = ""
        if dt == bf16:                 # the grads kernel's grid and clusters
            hpg = bwd_heads_per_group(args[0], N)
            grid = (f", grid ({-(-h // hpg)}, {-(-s // bwd_chunk())}, {b}) in"
                    f" clusters of {-(-h // hpg)} groups of {hpg} heads")
        print(f"kernel ssd_scan_bwd {name} b={b} s={s} h={h} P={P} N={N}"
              f" {str(dt)[6:]} d_state={'yes' if with_state else 'no'}{grid}:"
              f" max|d|/max|ref| " + " ".join(f"{n} {e:.3e}" for n, e in
                                              zip(names, errs))
              + auto + f", rerun bit-identical {same} tol={tol:g}"
              f" {'ok' if ok else 'FAIL'}")
        check(ok, f"ssd_scan_bwd {name} disagrees with its plain versions")
        if name != "train" and name not in SSD_RANKS:
            continue
        # reads x, dt_raw, B, C, dy and the (h,) vectors, writes dx,
        # ddt_raw, dB, dC and the (h,) gradients; the products that every
        # chunk length L needs, per (batch, head, position): six of P x N
        # (the state update and its gradient, G B, x^T G, S C, dy^T S).
        # The chunked backward's L x L products (C.B^T, dy.x^T and those
        # into dB, dC and dx) grow with the kernel's choice of L, so they
        # are not part of the bound.
        L = bwd_chunk()
        x, dt_raw, _, B, C, _, _ = args
        nbytes = (x.element_size() * (3 * x.numel() + 2 * dt_raw.numel()
                                      + 2 * B.numel() + 2 * C.numel())
                  + 4 * 6 * h)
        flops = b * h * s * 2 * 6 * P * N
        bound_ms, bound_by = bound(nbytes, flops, peaks)
        if name in SSD_RANKS:
            ms = time_ms(lambda: ssd_scan_bwd(*args, dy, ds), flush)
            plain_ms = time_ms(lambda: ssd_scan_bwd_ref(*args, dy, ds), flush)
            print(f"time ssd_scan_bwd {name} (one rank, phase (f)): {nbytes}"
                  f" bytes, {flops} flops: kernel {ms:.4f} ms, plain"
                  f" {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            continue
        # the call's scratch: its peak allocated memory less what was
        # allocated before it (the inputs among it) and its outputs
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = ssd_scan_bwd(*args, dy, ds)
        torch.cuda.synchronize()
        scratch = (torch.cuda.max_memory_allocated() - before
                   - sum(t.numel() * t.element_size() for t in out))
        plan = bwd_scratch(b, s, h, P, N, dt, L)
        print(f"scratch ssd_scan_bwd {name}: {scratch} B allocated during the"
              f" call besides its outputs; the plan "
              + ", ".join(f"{k} {v}" for k, v in plan.items())
              + f" = {sum(4 * math.prod(v) for v in plan.values())} B float32")
        del out
        ms = time_ms(lambda: ssd_scan_bwd(*args, dy, ds), flush)
        plain_ms = time_ms(lambda: ssd_scan_bwd_ref(*args, dy, ds), flush)
        print(f"time ssd_scan_bwd {name} inputs: {nbytes} bytes, {flops} flops"
              f" independent of the chunk (the kernel's L={L}): kernel"
              f" {ms:.4f} ms, plain"
              f" {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by});"
              f" no PyTorch call computes the gradient")
        _, parts, _ = device_profile(lambda: ssd_scan_bwd(*args, dy, ds), 10)
        print(f"time ssd_scan_bwd {name} kernels (ms per call, traced, L2 warm): "
              + "; ".join(f"{kn[:40]} {tm:.4f}" for kn, tm in parts))
        rows["ssd_scan_bwd"] = dict(
            name="ssd_scan_bwd", route="cuda",
            source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            replaces="src/repro/kernels/ssd_scan/ssd_scan.py:76 (its gradient:"
                     " no Pallas kernel, JAX autodiff of"
                     " src/repro/models/mamba2.py:72)",
            max_abs_err=max((g.float() - w.float()).abs().max().item()
                            for g, w in zip(got, want)),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
    return rows


def serve_main_path(cfg, params, prompt, new, want_launches):
    """(a) batch prefill + greedy decode with the launch counts set to 0
    just before and read just after, after a warm-up run; then a
    torch.profiler trace of one prefill and one decode step.  Returns
    (tokens, launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import prefill, serve_step
    b, s = prompt.shape
    cache_len = s + new

    def run_main():
        logits, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        toks = [tok]
        for i in range(new - 1):
            logits, cache = serve_step(cfg, params, tok, cache, s + i)
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            toks.append(tok)
        torch.cuda.synchronize()
        return torch.cat(toks, dim=1), logits, t1

    run_main()                                          # warm-up
    reset_launches()
    t0 = time.perf_counter()
    toks, last_logits, t1 = run_main()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES)
    prefill_tok_s = b * s / (t1 - t0)
    decode_tok_s = b * (new - 1) / (t2 - t1)
    print(f"(a) serve b={b} prompt={s} new={new} cache_len={cache_len}:"
          f" prefill {t1 - t0:.4f}s {prefill_tok_s:.1f} tok/s, decode"
          f" {new - 1} steps {t2 - t1:.4f}s {decode_tok_s:.1f} tok/s,"
          f" launches {launches}")
    check(tuple(toks.shape) == (b, new)
          and bool(torch.isfinite(last_logits.float()).all())
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "main path produced malformed tokens or non-finite logits")
    check(launches == want_launches,
          f"main path launch counts {launches} != {want_launches}")

    # the device's busy time in one prefill and one decode step, against
    # their wall time above; the profiled runs are not counted in launches
    _, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
    tok = toks[:, :1]
    for what, fn, n, wall_ms in (
            ("prefill", lambda: prefill(cfg, params, {"tokens": prompt}, cache_len),
             2, (t1 - t0) * 1e3),
            ("decode step", lambda: serve_step(cfg, params, tok, cache, s),
             8, (t2 - t1) * 1e3 / (new - 1))):
        busy, kernels, _ = device_profile(fn, n)
        if busy == 0:
            print(f"(a) trace {what}: the profiler saw no device time;"
                  " idle share not measured")
            continue
        top = "; ".join(f"{k[:48]} {ms:.4f}" for k, ms in kernels[:6])
        print(f"(a) trace {what}: device busy {busy:.4f} ms of {wall_ms:.4f} ms"
              f" wall, idle share {1 - busy / wall_ms:.3f}; top kernels (ms per"
              f" call): {top}")
    return toks, launches


# The functions of a decode step that the batch probe hooks, by module
# (repro_torch.models.* and repro_torch.kernels.dispatch): each sub-layer's
# end (_ffn_residual, its sub{j} output), the norms, the mixers (GQA and
# MLA attention, Mamba2) and the FFNs (dense, MoE), and the parts inside
# them (projections, the attention kernel's dispatch, C . state, the
# experts' products).
PROBE_HOOKS = {
    "models.transformer": ("rms_norm", "mlp", "_ffn_residual", "_head"),
    "models.attention": ("gqa_project_qkv", "_out_project",
                         "gqa_attend_decode", "mla_attend_decode"),
    "models.mamba2": ("_project", "c_dot_state", "gated_rms_norm",
                      "mamba2_decode"),
    "models.moe": ("_expert_ffn", "moe_ffn"),
    "kernels.dispatch": ("flash_decode", "mla_flash_decode"),
}


def _tensors(x):
    """The tensors of a value: itself, or those in a tuple, list or dict."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


class _Recorder:
    """While ``on``, each hooked function's call in a decode step is kept as
    (label, input shapes, the output tensors' row ``row``, the function,
    its arguments); ``layer`` counts the sub-layers finished in the step."""

    def __init__(self, period):
        self.period, self.on, self.row = period, False, 0
        self.calls, self.layer = [], 0

    def start(self, row):
        self.on, self.row, self.calls, self.layer = True, row, [], 0


@contextmanager
def decode_hooks(rec):
    """Wraps every function of PROBE_HOOKS to record into ``rec``."""
    import importlib
    saved = []

    def hook(mod, name, inner):
        def wrapped(*args, **kw):
            out = inner(*args, **kw)
            if rec.on:
                # the activation: the first tensor argument (weights and
                # caches come in dicts, or after it)
                nb = next(a for a in args if isinstance(a, torch.Tensor)
                          and a.ndim).shape[0]
                rows = [t[rec.row:rec.row + 1].clone()
                        if t.ndim and t.shape[0] == nb else None
                        for t in _tensors(out)]
                i, j = divmod(rec.layer, rec.period)
                # the arguments by reference, for the trace of the call:
                # a cache written in place since keeps its shapes
                rec.calls.append((f"block {i} sub{j} {name}"
                                  if name != "_head" else name,
                                  [tuple(a.shape) for a in args
                                   if isinstance(a, torch.Tensor)],
                                  rows, inner, args, kw))
                if name == "_ffn_residual":
                    rec.layer += 1
            return out
        return wrapped

    try:
        for path, names in PROBE_HOOKS.items():
            mod = importlib.import_module(f"repro_torch.{path}")
            for name in names:
                inner = getattr(mod, name)
                saved.append((mod, name, inner))
                setattr(mod, name, hook(mod, name, inner))
        yield rec
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)


class _ProbeDone(Exception):
    """Raised out of the batcher once the probed token's step is kept."""


def batch_probe(cfg, params, prompts, new, cls, r, t):
    """Request ``r``'s row through ``cls`` against its per-request greedy
    decode, whose token ``t`` it first leaves: both re-run up to that token
    with every PROBE_HOOKS function recorded, then the row's outputs are
    compared bit for bit, decode step by decode step and, inside a step, in
    the order they were computed.  Prints the first output that differs,
    the shapes it ran at on both sides and the batch's live rows and
    positions, and the device kernels of that call on each side.  Returns
    (token, label) of that output, or None when none differs."""
    from repro_torch.serve import ServeRequest, engine, greedy_decode
    n, s = prompts.shape
    cache_len = s + new
    rec = _Recorder(cfg.block_period)
    inner_step = engine.decode_step
    kept = {"greedy": {}, "batch": {}}
    side = {}

    def step(cfg_, params_, tokens, cache, pos):
        k, row, ctx = side["where"]()
        if k is not None and 1 <= k <= t:
            rec.start(row)
        try:
            out = inner_step(cfg_, params_, tokens, cache, pos)
        finally:
            rec.on = False
        if k is not None and 1 <= k <= t:
            kept[side["name"]][k] = (rec.calls, ctx)
            if side["name"] == "batch" and k == t:
                raise _ProbeDone
        return out

    calls = iter(range(1, t + 1))
    side.update(name="greedy", where=lambda: (next(calls), 0, "alone, b=1"))
    engine.decode_step = step
    try:
        with decode_hooks(rec):
            greedy_decode(cfg, params, prompts[r:r + 1], t + 1, cache_len)
            cb = cls(cfg, params, slots=8, cache_len=cache_len)

            def where():
                slot = next((i for i, q in enumerate(cb.active)
                             if q is not None and q.request_id == r), None)
                if slot is None:
                    return None, 0, ""
                live = [i for i, q in enumerate(cb.active) if q is not None]
                return (len(cb.active[slot].tokens), slot,
                        f"slot {slot} of {cb.slots}, live slots {live},"
                        f" positions {cb.pos.tolist()}")

            side.update(name="batch", where=where)
            for i in range(n):
                cb.submit(ServeRequest(i, prompts[i], new))
            try:
                cb.run()
            except _ProbeDone:
                pass
    finally:
        engine.decode_step = inner_step
    for k in range(1, t + 1):
        (bat, ctx), (alone, _) = kept["batch"][k], kept["greedy"][k]
        check([c[0] for c in bat] == [c[0] for c in alone],
              f"probe: the batch and the lone row ran other functions at"
              f" token {k}")
        for m, (cb_, ca) in enumerate(zip(bat, alone)):
            diff = [(x.float() - y.float()).abs().max().item()
                    for x, y in zip(cb_[2], ca[2])
                    if x is not None and y is not None and not torch.equal(x, y)]
            if not diff:
                continue
            print(f"(c) probe {cls.__name__}, request {r} (first leaves"
                  f" per-request greedy at token {t}): its row first differs"
                  f" at token {k}, output {m + 1} of {len(bat)} of the step,"
                  f" {cb_[0]} (max|d| {max(diff):.3e}); ran at {cb_[1]} in"
                  f" the batch ({ctx}), at {ca[1]} alone; every earlier"
                  f" output and step bit-identical")
            for where_, (_, _, _, fn, args, kw) in (("batch", cb_), ("alone", ca)):
                if any(a.is_cuda for a in args if isinstance(a, torch.Tensor)):
                    _, kernels, _ = device_profile(lambda: fn(*args, **kw), 1)
                    print(f"(c) probe {cb_[0]} {where_}: kernels "
                          + "; ".join(f"{kn[:90]}" for kn, _ in kernels[:8]))
            return k, cb_[0]
    print(f"(c) probe {cls.__name__}, request {r}: no hooked output of its row"
          f" differs up to token {t}")
    return None


def serve_batchers(cfg, params, prompts, new):
    """(c) the requests through 8 slots of the continuous and the
    disaggregated batchers, against per-request greedy decoding: every
    request's tokens must equal its own (the reference's batcher contract,
    kept since the norms sum each row in a fixed order); for each batcher,
    the first request that leaves greedy goes through ``batch_probe`` before
    the phase fails; then the first decode step of requests 0-7, each alone
    against the same rows as one batch of 8, which measures how far a step's
    logits depend on the batch around a row on this card."""
    from repro_torch.serve import (ContinuousBatcher, DisaggregatedBatcher,
                                   ServeRequest, greedy_decode, prefill,
                                   serve_step)
    n, s = prompts.shape
    cache_len = s + new
    want = {i: greedy_decode(cfg, params, prompts[i:i + 1], new, cache_len)[0].tolist()
            for i in range(n)}
    shares = []
    for cls in (ContinuousBatcher, DisaggregatedBatcher):
        cb = cls(cfg, params, slots=8, cache_len=cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            cb.submit(ServeRequest(i, prompts[i], new))
        out = cb.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_tok = sum(len(t) for t in out.values())
        check(sorted(out) == list(range(n))
              and all(len(t) == new for t in out.values()),
              f"{cls.__name__} did not serve all {n} requests")
        same = sum(out[i] == want[i] for i in range(n)) / n
        shares.append(same)
        first = [next(k for k, (a, c) in enumerate(zip(out[i], want[i])) if a != c)
                 for i in range(n) if out[i] != want[i]]
        print(f"(c) {cls.__name__}: {len(out)} requests, {n_tok} tokens,"
              f" {cb.decode_steps} decode steps, {dt:.3f}s {n_tok / dt:.1f} tok/s,"
              f" share equal to per-request greedy {same:.3f}; the others"
              f" first differ at token {first}")
        if first:
            r = next(i for i in range(n) if out[i] != want[i])
            batch_probe(cfg, params, prompts, new, cls, r, first[0])
    caches = [prefill(cfg, params, {"tokens": prompts[i:i + 1]}, cache_len)[1]
              for i in range(8)]
    batch = {j: {k: torch.cat([c[j][k] for c in caches], dim=1) for k in sub}
             for j, sub in caches[0].items()}
    tok = torch.tensor([[want[i][0]] for i in range(8)], device="cuda")
    alone = torch.cat([serve_step(cfg, params, tok[i:i + 1], caches[i], s)[0]
                       for i in range(8)])
    together, _ = serve_step(cfg, params, tok, batch, s)
    print(f"(c) first decode step of requests 0-7, each alone vs as one batch"
          f" of 8: max|dlogit|/max|logit| {rel_max_err(together, alone):.3e}")
    check(shares == [1.0, 1.0], f"{cfg.name}: the batchers' tokens leave"
                                f" per-request greedy ({shares})")


def phase_model(arch="llama3.2-3b", seed=2, want_params=None, serve_plan=None):
    """A dense GQA model at full width and depth: llama3.2-3b, and
    stablelm-12b (head dim 160) with its parameter count checked and its
    peak device memory beside the JAX package's serving prediction; with
    ``serve_plan`` (llama's, from the front door), its peaks beside the
    plan's ``pred_bytes``."""
    from repro_torch.configs import get_arch
    from repro_torch.core.memory_model import serve_bytes_split, serve_peak_bytes
    from repro_torch.kernels import LAUNCHES, dispatch
    from repro_torch.models import init_params, param_count
    from repro_torch.serve import prefill, serve_step
    cfg = get_arch(arch)
    check(want_params is None or param_count(cfg) == want_params,
          f"{arch} has {param_count(cfg)} parameters, not {want_params}")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"model {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model}"
          f" heads={cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim}"
          f" d_ff={cfg.d_ff} vocab={cfg.vocab_size} params={n_params}"
          f" ({n_bytes} bytes) bf16 init {time.perf_counter() - t0:.1f}s")
    b, s, new = 8, 512, 32
    cache_len = s + new
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(flash_attention=cfg.num_layers,
                flash_decode_gqa=cfg.num_layers * (new - 1),
                rms_norm=norms_per_pass(cfg) * new)
    torch.cuda.reset_peak_memory_stats()
    toks, launches = serve_main_path(cfg, params, prompt, new, want)
    if arch in SERVE_PREDICTED_PEAK or serve_plan is not None:
        peak = torch.cuda.max_memory_allocated()
        print(f"(a) peak device memory over the serving run and its trace:"
              f" {peak} B; the JAX package's serve_peak_bytes(b={b},"
              f" cache_len={cache_len}) prediction"
              f" {SERVE_PREDICTED_PEAK.get(arch, 'not on record')}"
              f"{' B' if arch in SERVE_PREDICTED_PEAK else ''}")
        # the decode steps alone, which serve_peak_bytes models (weights,
        # cache, a small workspace): the peak is reset after the prefill
        # and the ring caches' build
        _, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(new - 1):
            _, cache = serve_step(cfg, params, toks[:, i:i + 1], cache, s + i)
        torch.cuda.synchronize()
        decode_peak = torch.cuda.max_memory_allocated()
        del cache
        w, c, ws = serve_bytes_split(cfg, b, cache_len, 1, 1)
        predicted = serve_peak_bytes(cfg, b, cache_len, 1, 1)
        if arch in SERVE_PREDICTED_PEAK:
            check(predicted == SERVE_PREDICTED_PEAK[arch],
                  f"the port's serve_peak_bytes {predicted} != the JAX"
                  f" package's")
        if serve_plan is not None:
            print(f"(s) {arch} serving plan d={serve_plan.d}"
                  f" t={serve_plan.t} {serve_plan.n_devices}x"
                  f" {serve_plan.device_type}: pred_bytes"
                  f" {serve_plan.pred_bytes:.0f} B; the card's decode-only"
                  f" peak {decode_peak} B"
                  f" ({decode_peak / serve_plan.pred_bytes:.4f}), whole-run"
                  f" peak {peak} B ({peak / serve_plan.pred_bytes:.4f})"
                  f" (reported, not required)")
        print(f"(a) peak device memory over the {new - 1} decode steps alone:"
              f" {decode_peak} B; the port's serve_peak_bytes {predicted:.0f} B"
              f" (weights {w:.0f}, cache {c:.0f}, workspace {ws:.0f});"
              f" decode peak / predicted {decode_peak / predicted:.4f}, whole"
              f" run / predicted {peak / predicted:.4f} (reported, not"
              f" required)")

    # (b) kernel path against the plain path: prefill logits, first decode
    def first_two():
        logits, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        step, _ = serve_step(cfg, params, tok_fixed, cache, s)
        return logits[:, -1].float(), step[:, -1].float()

    tok_fixed = toks[:, :1]
    kern = first_two()
    with dispatch.force("ref"):
        plain = first_two()
    rel = [((a - c).abs().max() / c.abs().max()).item() for a, c in zip(kern, plain)]
    print(f"(b) kernel vs plain path: prefill max|dlogit|/max|logit|={rel[0]:.3e},"
          f" first decode {rel[1]:.3e}, tol {LOGITS_TOL:g}")
    check(max(rel) <= LOGITS_TOL, "kernel path logits differ from the plain path")

    # (c) 16 requests through 8 slots, against per-request greedy decoding
    prompts = torch.randint(0, cfg.vocab_size, (16, s), generator=gen, device="cuda")
    serve_batchers(cfg, params, prompts, new)
    return launches


def phase_serverless():
    """(s) The serverless front door on a cluster of one H100-80G: whole
    stablelm-12b (predicted 245.7 GB on one device) must come back queued
    with plans of two devices or more only, and llama3.2-3b's serving
    submission at batch 8, cache 544 must start on d=1 t=1.  Returns the
    serving plan, whose ``pred_bytes`` phase 3 prints beside its peaks."""
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core.orchestrator import Orchestrator, make_cluster
    from repro_torch.core.serverless import submit, submit_serve
    orch = Orchestrator(make_cluster(ONE_H100))
    whole = submit(orch, get_arch("stablelm-12b"),
                   TrainConfig(global_batch=8, seq_len=1024, zero=1))
    sizes = sorted({p.n_devices for p in whole.plans})
    print(f"(s) stablelm-12b whole at 8 x 1024: {whole.job.state},"
          f" {len(whole.plans)} feasible plans of {sizes} devices; top:"
          f" d={whole.plans[0].d} t={whole.plans[0].t}, pred_bytes"
          f" {whole.plans[0].pred_bytes:.0f} B")
    check(whole.job.state == "queued" and whole.plans and sizes[0] >= 2,
          f"whole stablelm-12b is {whole.job.state} with plans of {sizes}"
          f" devices, not queued with plans of two or more")
    serve = submit_serve(orch, get_arch("llama3.2-3b"), batch=8,
                         cache_len=544)
    plan = serve.job.allocation.plan if serve.job.allocation else None
    print(f"(s) llama3.2-3b serving at batch 8, cache 544: "
          + serve.describe().replace("\n", ";"))
    check(serve.job.state == "running" and plan is not None
          and (plan.d, plan.t, plan.device_type) == (1, 1, "H100-80G"),
          f"llama3.2-3b's serving submission is {serve.job.state} on {plan}")
    orch.release(serve.job.job_id)
    check(serve.job.state == "done",
          f"llama3.2-3b's serving job is {serve.job.state} after release")
    return plan


def phase_deepseek():
    """deepseek-v2-236b, published widths, DEEPSEEK_LAYERS of 60 layers."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, dispatch
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params, param_count
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import cache_from_prefill
    cfg = get_arch("deepseek-v2-236b").scaled(num_layers=DEEPSEEK_LAYERS)
    n_params = param_count(cfg)
    check(n_params == 16_937_047_040, f"deepseek-v2 at 4 layers has {n_params}"
                                      f" parameters")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"model {cfg.name}: {cfg.num_layers} of 60 layers, d_model={cfg.d_model}"
          f" heads={cfg.num_heads} MLA q_lora={cfg.q_lora_rank}"
          f" kv_lora={cfg.kv_lora_rank} dn/dr/dv={cfg.qk_nope_head_dim}/"
          f"{cfg.qk_rope_head_dim}/{cfg.v_head_dim} experts={cfg.num_experts}"
          f" routed top-{cfg.top_k} + {cfg.num_shared_experts} shared of"
          f" d_ff {cfg.moe_d_ff} vocab={cfg.vocab_size} params={n_params}"
          f" ({n_bytes} bytes, bf16 with a float32 router), init"
          f" {time.perf_counter() - t0:.1f}s")
    b, s, new = 8, 512, 32
    cache_len = s + new
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(flash_attention=cfg.num_layers,
                flash_decode_mla=cfg.num_layers * (new - 1),
                rms_norm=norms_per_pass(cfg) * new)
    toks, launches = serve_main_path(cfg, params, prompt, new, want)

    # (b1) layer 0's MLA, which no routing precedes: prefill output, and the
    # first decode step over the cache that prefill wrote
    p0 = {k: v[0] for k, v in params["blocks"]["sub0"]["mixer"].items()}
    norm1 = params["blocks"]["sub0"]["norm1"][0]
    h = rms_norm(params["embed"][prompt], norm1, cfg.norm_eps)
    h_new = rms_norm(params["embed"][toks[:, :1]], norm1, cfg.norm_eps)
    positions = torch.arange(s, device="cuda")

    def layer0():
        with torch.inference_mode():
            out, kv = attn.mla_attend_train(cfg, p0, h, positions)
            ring = cache_from_prefill(cfg, {"sub0": {k: t[None] for k, t in
                                                     kv.items()}}, cache_len)
            step, _ = attn.mla_attend_decode(
                cfg, p0, h_new, {k: t[0] for k, t in ring["sub0"].items()},
                attn.ring_index(s, cache_len, b, "cuda"))
        return out, step

    kern = layer0()
    with dispatch.force("ref"):
        plain = layer0()
    rel = [rel_max_err(a, c) for a, c in zip(kern, plain)]
    print(f"(b) layer 0 MLA, kernel vs plain: prefill max|d|/max|ref|"
          f" {rel[0]:.3e}, first decode step {rel[1]:.3e}, tol {BF16_TOL:g}")
    check(max(rel) <= BF16_TOL, "layer 0's MLA differs from the plain path")

    # (b2) the whole model
    logits_vs_plain(cfg, params, prompt, toks[:, :1], cache_len,
                    DEEPSEEK_LOGITS_ATOL)

    # (c) 16 requests through 8 slots
    prompts = torch.randint(0, cfg.vocab_size, (16, s), generator=gen, device="cuda")
    serve_batchers(cfg, params, prompts, new)
    return launches


def phase_mamba2():
    """mamba2-130m at full width and depth."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, dispatch, reset_launches
    from repro_torch.models import init_params, param_count
    from repro_torch.models.common import rms_norm
    from repro_torch.models.mamba2 import c_dot_state, mamba2_forward
    from repro_torch.serve import prefill, serve_step
    cfg = get_arch("mamba2-130m")
    n_params = param_count(cfg)
    check(n_params == 167_598_528, f"mamba2-130m has {n_params} parameters")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"model {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model}"
          f" d_inner={cfg.d_inner} ssd heads={cfg.n_ssm_heads} of"
          f" P={cfg.ssm_head_dim} state N={cfg.ssm_state} conv={cfg.ssm_conv}"
          f" vocab={cfg.vocab_size} params={n_params} ({n_bytes} bytes, bf16"
          f" with float32 A_log/D/dt_bias), init {time.perf_counter() - t0:.1f}s")
    b, s, new = 8, 512, 32
    cache_len = s + new
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(ssd_scan=cfg.num_layers, rms_norm=norms_per_pass(cfg) * new)
    toks, launches = serve_main_path(cfg, params, prompt, new, want)

    # (a') one prompt of 32,768 tokens, timed after a warm-up prefill
    s_long = SSD_LONG["s"]
    long_prompt = torch.randint(0, cfg.vocab_size, (1, s_long), generator=gen,
                                device="cuda")
    prefill(cfg, params, {"tokens": long_prompt}, s_long + 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = prefill(cfg, params, {"tokens": long_prompt}, s_long + 1)
    torch.cuda.synchronize()
    dt_long = time.perf_counter() - t0
    print(f"(a') prefill b=1 prompt={s_long}: {dt_long:.4f}s"
          f" {s_long / dt_long:.1f} tok/s, launches {dict(LAUNCHES)}")
    check(LAUNCHES["ssd_scan"] == cfg.num_layers
          and bool(torch.isfinite(logits.float()).all()),
          "the 32k prefill did not run the kernel once a layer or gave"
          " non-finite logits")

    # (b1) layer 0's mixer: output and final SSD state, kernel vs plain
    p0 = {k: v[0] for k, v in params["blocks"]["sub0"]["mixer"].items()}
    h = rms_norm(params["embed"][prompt], params["blocks"]["sub0"]["norm1"][0],
                 cfg.norm_eps)

    def layer0():
        with torch.inference_mode():
            out, cache = mamba2_forward(cfg, p0, h)
        return out, cache["ssd"]

    kern = layer0()
    with dispatch.force("ref"):
        plain = layer0()
    rel = [rel_max_err(a, c) for a, c in zip(kern, plain)]
    print(f"(b) layer 0 Mamba2 mixer, kernel vs plain: output max|d|/max|ref|"
          f" {rel[0]:.3e}, final SSD state {rel[1]:.3e}, tol {MAMBA2_TOL:g}")
    check(max(rel) <= MAMBA2_TOL, "layer 0's Mamba2 mixer differs from the"
                                  " plain path")

    # (b2) the whole model: prefill logits and the first decode step's
    def first_two():
        logits, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        step, _ = serve_step(cfg, params, toks[:, :1], cache, s)
        return logits[:, -1].float(), step[:, -1].float()

    kern = first_two()
    with dispatch.force("ref"):
        plain = first_two()
    rel = [rel_max_err(a, c) for a, c in zip(kern, plain)]
    print(f"(b) kernel vs plain path: prefill max|dlogit|/max|logit|={rel[0]:.3e},"
          f" first decode {rel[1]:.3e}, tol {MAMBA2_TOL:g}")
    check(max(rel) <= MAMBA2_TOL, "mamba2 kernel path logits differ from the"
                                  " plain path")

    # (c) 16 requests through 8 slots (the share equal to per-request greedy
    # is printed, not required); then the decode step's float32 C . state
    # (mamba2.c_dot_state, a sum over N whose order does not depend on the
    # batch), one row at a time against 8 rows at once: required bit-equal
    prompts = torch.randint(0, cfg.vocab_size, (16, s), generator=gen, device="cuda")
    serve_batchers(cfg, params, prompts, new)
    C = torch.randn(8, cfg.ssm_state, generator=gen, device="cuda")
    state = torch.randn(8, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                        generator=gen, device="cuda")
    one = torch.cat([c_dot_state(C[i:i + 1], state[i:i + 1]) for i in range(8)])
    eight = c_dot_state(C, state)
    print(f"(c) mamba2_decode's float32 C . state (c_dot_state) at batch 8 vs"
          f" one row at a time: max|d| {(eight - one).abs().max().item():.3e},"
          f" bit-identical {torch.equal(eight, one)}")
    check(torch.equal(eight, one), "mamba2's decode C . state depends on the"
                                   " batch around a row")
    return launches


def routing_spy(moe):
    """Wraps moe.moe_ffn to record each call's routing choices (each
    token's top-k set); returns (the list they go to, a function that
    restores moe_ffn)."""
    routes = []
    inner = moe.moe_ffn

    def spy(cfg_, p, x, par=None):
        with torch.no_grad():
            probs = torch.softmax(x.float() @ p["router"], dim=-1)
            routes.append(torch.topk(probs, cfg_.top_k,
                                     dim=-1).indices.sort(-1).values)
        return inner(cfg_, p, x, par)

    moe.moe_ffn = spy
    return routes, lambda: setattr(moe, "moe_ffn", inner)


@contextmanager
def subs_swapped(params, i, j):
    """A fault: sub-layers i and j of the blocks (of one kind) run in each
    other's places while the context is open."""
    blocks = params["blocks"]
    a, b = f"sub{i}", f"sub{j}"
    blocks[a], blocks[b] = blocks[b], blocks[a]
    try:
        yield
    finally:
        blocks[a], blocks[b] = blocks[b], blocks[a]


@contextmanager
def ssd_carry_dropped():
    """A fault: while the context is open the SSD scan runs the two halves
    of a sequence apart, so the second starts from a zero state."""
    from repro_torch.kernels import dispatch
    inner = dispatch.ssd

    def halves(x, dt_raw, A_log, B, C, D, dt_bias, **kw):
        cut = x.shape[1] // 2
        if cut == 0:
            return inner(x, dt_raw, A_log, B, C, D, dt_bias, **kw)
        parts = [inner(x[:, i].contiguous(), dt_raw[:, i].contiguous(), A_log,
                       B[:, i].contiguous(), C[:, i].contiguous(), D, dt_bias,
                       **kw)
                 for i in (slice(0, cut), slice(cut, None))]
        return torch.cat([parts[0][0], parts[1][0]], 1), parts[1][1]

    dispatch.ssd = halves
    try:
        yield
    finally:
        dispatch.ssd = inner


def logits_vs_plain(cfg, params, prompt, first, cache_len, atol, faults=()):
    """(b2) The whole model, kernel path against the plain path: the prefill
    logits and the first decode step's (from token ``first``), max |logit
    delta| within ``atol``, and the share of routing choices (a token's
    top-k set in one MoE layer, prefill and first decode step) equal on
    both paths.  Each of ``faults``, (name, context manager that breaks the
    kernel path while open), must move the logits by more than ``atol``:
    the limit tells a sound path from a broken one."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import moe
    from repro_torch.serve import prefill, serve_step
    s = prompt.shape[1]
    routes, restore = routing_spy(moe)

    def first_two():
        routes.clear()
        logits, cache = prefill(cfg, params, {"tokens": prompt}, cache_len)
        step, _ = serve_step(cfg, params, first, cache, s)
        return logits[:, -1].float(), step[:, -1].float(), list(routes)

    try:
        kern = first_two()
        with dispatch.force("ref"):
            plain = first_two()
    finally:
        restore()

    def dlogit(got):
        return [(a - c).abs().max().item() for a, c in zip(got[:2], plain[:2])]

    agree = (sum(int((a == c).all(-1).sum()) for a, c in zip(kern[2], plain[2]))
             / sum(a.shape[0] * a.shape[1] for a in kern[2]))
    dl = dlogit(kern)
    scale = max(c.abs().max().item() for c in plain[:2])
    print(f"(b) kernel vs plain path: prefill max|dlogit| {dl[0]:.3e},"
          f" first decode {dl[1]:.3e} (max|logit| {scale:.3f}), atol"
          f" {atol:g}; share of routing choices (a token's top-{cfg.top_k}"
          f" set in one MoE layer, prefill and first decode step) equal on"
          f" both paths: {agree:.4f}")
    check(max(dl) <= atol, f"{cfg.name} kernel path logits differ from the"
                           f" plain path")
    for name, fault in faults:
        with fault():
            broken = dlogit(first_two())
        print(f"(b) fault, {name}: prefill max|dlogit| {broken[0]:.3e}, first"
              f" decode {broken[1]:.3e}, atol {atol:g}")
        check(max(broken) > atol, f"{cfg.name}'s logits limit {atol:g} does"
                                  f" not catch the fault: {name}")


def phase_jamba():
    """jamba-1.5-large-398b, published widths, one block of JAMBA_LAYERS
    layers and JAMBA_EXPERTS of its 16 experts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, dispatch, reset_launches
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params, param_count
    from repro_torch.models.common import rms_norm
    from repro_torch.models.mamba2 import mamba2_forward
    from repro_torch.models.transformer import cache_from_prefill
    from repro_torch.serve import prefill
    cfg = get_arch("jamba-1.5-large-398b").scaled(num_layers=JAMBA_LAYERS,
                                                  num_experts=JAMBA_EXPERTS)
    n_params = param_count(cfg)
    check(n_params == JAMBA_PARAMS, f"jamba at one block and {JAMBA_EXPERTS}"
                                    f" experts has {n_params} parameters")
    kinds = [("attn" if cfg.layer_kind(l) == "attn" else "mamba2")
             + ("+moe" if cfg.layer_is_moe(l) else "+mlp")
             for l in range(cfg.num_layers)]
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"model {cfg.name}: {cfg.num_layers} of 72 layers ({', '.join(kinds)}),"
          f" d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} of"
          f" {cfg.head_dim}, d_inner={cfg.d_inner} ssd heads={cfg.n_ssm_heads}"
          f" of P={cfg.ssm_head_dim} state N={cfg.ssm_state}, d_ff={cfg.d_ff},"
          f" experts={cfg.num_experts} of 16 top-{cfg.top_k} of d_ff"
          f" {cfg.moe_d_ff}, vocab={cfg.vocab_size} params={n_params}"
          f" ({n_bytes} bytes, bf16 with float32 router and A_log/D/dt_bias),"
          f" init {time.perf_counter() - t0:.1f}s")
    n_attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.num_layers))
    b, s, new = 8, 512, 32
    cache_len = s + new
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(flash_attention=n_attn, flash_decode_gqa=n_attn * (new - 1),
                ssd_scan=cfg.num_layers - n_attn,
                rms_norm=norms_per_pass(cfg) * new)
    toks, launches = serve_main_path(cfg, params, prompt, new, want)

    # (a') one prompt of 32,768 tokens, timed after a warm-up prefill
    s_long = SSD_LONG["s"]
    long_prompt = torch.randint(0, cfg.vocab_size, (1, s_long), generator=gen,
                                device="cuda")
    prefill(cfg, params, {"tokens": long_prompt}, s_long + 1)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, _ = prefill(cfg, params, {"tokens": long_prompt}, s_long + 1)
    torch.cuda.synchronize()
    dt_long = time.perf_counter() - t0
    print(f"(a') prefill b=1 prompt={s_long}: {dt_long:.4f}s"
          f" {s_long / dt_long:.1f} tok/s, launches {dict(LAUNCHES)}, peak"
          f" device memory {torch.cuda.max_memory_allocated()} B")
    check(LAUNCHES["ssd_scan"] == cfg.num_layers - n_attn
          and LAUNCHES["flash_attention"] == n_attn
          and bool(torch.isfinite(logits.float()).all()),
          "the 32k prefill did not run the kernels once a layer or gave"
          " non-finite logits")
    del logits, long_prompt

    # (b1) layer 4's attention, prefill output and the first decode step
    # over the cache that prefill wrote, and layer 0's mixer output and
    # final SSD state, each from the normed embeddings
    j_attn = next(j for j in range(cfg.block_period)
                  if cfg.layer_kind(j) == "attn")
    sub_a, sub_m = params["blocks"][f"sub{j_attn}"], params["blocks"]["sub0"]
    pa = {k: v[0] for k, v in sub_a["mixer"].items()}
    pm = {k: v[0] for k, v in sub_m["mixer"].items()}
    ha = rms_norm(params["embed"][prompt], sub_a["norm1"][0], cfg.norm_eps)
    ha_new = rms_norm(params["embed"][toks[:, :1]], sub_a["norm1"][0], cfg.norm_eps)
    hm = rms_norm(params["embed"][prompt], sub_m["norm1"][0], cfg.norm_eps)
    positions = torch.arange(s, device="cuda")

    def layers():
        with torch.inference_mode():
            out, kv = attn.gqa_attend_train(cfg, pa, ha, positions)
            ring = cache_from_prefill(cfg, {"sub": {k: t[None] for k, t in
                                                    kv.items()}}, cache_len)
            step, _ = attn.gqa_attend_decode(
                cfg, pa, ha_new, {k: t[0] for k, t in ring["sub"].items()},
                attn.ring_index(s, cache_len, b, "cuda"))
            mixed, cache = mamba2_forward(cfg, pm, hm)
        return out, step, mixed, cache["ssd"]

    kern = layers()
    with dispatch.force("ref"):
        plain = layers()
    rel = [rel_max_err(a, c) for a, c in zip(kern, plain)]
    print(f"(b) layer {j_attn} attention ({cfg.num_heads}/{cfg.num_kv_heads}"
          f" heads), kernel vs plain: prefill max|d|/max|ref| {rel[0]:.3e},"
          f" first decode step {rel[1]:.3e}, tol {BF16_TOL:g}; layer 0 Mamba2"
          f" mixer ({cfg.n_ssm_heads} heads):"
          f" output {rel[2]:.3e}, final SSD state {rel[3]:.3e}, tol"
          f" {MAMBA2_TOL:g}")
    check(max(rel[:2]) <= BF16_TOL and max(rel[2:]) <= MAMBA2_TOL,
          "jamba's attention or Mamba2 layer differs from the plain path")
    del kern, plain

    # (b2) the whole model, and the same with two faults put in on purpose
    logits_vs_plain(cfg, params, prompt, toks[:, :1], cache_len,
                    JAMBA_LOGITS_ATOL,
                    faults=[("sub-layers 1 and 3 swapped",
                             lambda: subs_swapped(params, 1, 3)),
                            ("SSD state dropped at the prompt's half",
                             ssd_carry_dropped)])

    # (c) 16 requests through 8 slots
    prompts = torch.randint(0, cfg.vocab_size, (16, s), generator=gen, device="cuda")
    serve_batchers(cfg, params, prompts, new)
    return launches


def train_config(steps, batch=8, seq=1024, zero=1):
    """The training cells' traffic: global batch 8 x 1024, microbatch 1,
    block remat (a submitted cell passes its job's batch and sequence and
    its plan's ZeRO stage)."""
    from repro_torch.configs import TrainConfig
    return TrainConfig(global_batch=batch, seq_len=seq, microbatch=1,
                       steps=steps, warmup_steps=1, remat="block", seed=0,
                       zero=zero)


def submit_train(arch):
    """The training cell through the port's serverless front door on a
    cluster of one H100-80G: MARP predicts the plans, HAS places the job.
    Requires it running on plan d=1 t=1 of the H100-80G with the JAX
    package's predicted peak as its ``pred_bytes``.  Returns the
    orchestrator and the submission."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.orchestrator import Orchestrator, make_cluster
    from repro_torch.core.serverless import submit
    orch = Orchestrator(make_cluster(ONE_H100))
    res = submit(orch, train_cfg(arch),
                 TrainConfig(global_batch=8, seq_len=1024, zero=1))
    job = res.job
    plan = job.allocation.plan if job.allocation else None
    print(f"(s) {arch} submitted: {len(res.plans)} feasible plans;"
          f" {res.describe()}".replace("\n", ";"))
    check(job.state == "running" and plan is not None
          and (plan.d, plan.t, plan.device_type) == (1, 1, "H100-80G"),
          f"{arch}'s submission is {job.state} on {plan}, not running on"
          f" d=1 t=1 of the H100-80G")
    check(plan.pred_bytes == JAX_PREDICTED_PEAK[arch],
          f"{arch}'s plan predicts {plan.pred_bytes} B, the JAX package"
          f" {JAX_PREDICTED_PEAK[arch]} B")
    return orch, res


def expandable_segments():
    """Whether the caching allocator holds growable segments, from a
    snapshot of its segments (after something was allocated)."""
    return any(seg.get("is_expandable", False)
               for seg in torch.cuda.memory_snapshot())


def train_cfg(arch):
    """The training cell's config: ``arch`` as published, cut by
    TRAIN_CUTS where it does not fit one card."""
    from repro_torch.configs import get_arch
    return get_arch(arch).scaled(**TRAIN_CUTS.get(arch, {}))


def phase_train(peaks, arch):
    """Training ``arch`` at full width (and depth, but for TRAIN_CUTS):
    global batch 8 x 1024, microbatch 1, block remat, 1 warm-up + 12 timed
    steps."""
    from repro_torch.core import memtrace
    from repro_torch.core.marp import predict_plans
    from repro_torch.core.serverless import report_oom
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import LAUNCHES, dispatch, reset_launches
    from repro_torch.launch.train import loss_fell, to_device, train
    from repro_torch.models import active_param_count, moe, param_count
    from repro_torch.train import accumulate_grads, build_train_step
    from repro_torch.train.optimizer import global_norm, tree_leaves
    orch, sub = submit_train(arch)
    job, plan = sub.job, sub.job.allocation.plan
    cfg = train_cfg(arch)
    n_params, n_active = param_count(cfg), active_param_count(cfg)
    check(n_params == TRAIN_PARAMS[arch], f"{arch} has {n_params} parameters")
    steps = 13                            # 1 warm-up + 12 timed steps
    tc = train_config(steps, job.global_batch, job.seq_len, plan.zero)
    b, s = tc.global_batch, tc.seq_len
    n_attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.num_layers))
    n_ssm = cfg.num_layers - n_attn
    if cfg.attention == "mla":            # qk width dn + dr, v width dv
        d_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        d_v = cfg.v_head_dim
    else:
        d_qk = d_v = cfg.head_dim
    layers = ", ".join(
        desc for n, desc in (
            (n_attn, f"{n_attn} {cfg.attention} attention of"
                     f" {cfg.num_heads}/{cfg.num_kv_heads} heads, qk/v width"
                     f" {d_qk}/{d_v}"),
            (n_ssm, f"{n_ssm} Mamba2"),
            (cfg.num_experts, f"MoE: {cfg.num_experts} routed experts, top-"
                              f"{cfg.top_k} + {cfg.num_shared_experts} shared"
                              f" of d_ff {cfg.moe_d_ff}")) if n)
    cut = (f" (cut: {TRAIN_CUTS[arch]})" if arch in TRAIN_CUTS else "")
    print(f"model {cfg.name}{cut}: {cfg.num_layers} layers ({layers})"
          f" d_model={cfg.d_model} d_ff={cfg.d_ff} vocab={cfg.vocab_size}"
          f" params={n_params} (active {n_active}); train global_batch={b}"
          f" seq={s} microbatch=1 remat=block, {steps} steps")
    reset_launches()
    out = train(cfg, tc, device="cuda", log_every=1,
                log=lambda line: print(f"(t) {line}"))
    launches = dict(LAUNCHES)
    n_micro = out["n_micro"]
    # a layer's forward kernel runs twice a microbatch (the forward, and its
    # recompute under block remat in the backward), its gradient once; the
    # final norm, outside the blocks, once
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rms_norm=(2 * norms_per_pass(cfg) - 1) * n_micro * steps,
                flash_attention=2 * n_attn * n_micro * steps,
                flash_attention_bwd=n_attn * n_micro * steps,
                ssd_scan=2 * n_ssm * n_micro * steps,
                ssd_scan_bwd=n_ssm * n_micro * steps,
                adam_update=len(tree_leaves(out["state"]["params"])) * steps)
    losses, step_s = out["losses"], out["step_s"][1:]
    step_ms = 1e3 * sum(step_s) / len(step_s)
    tokens = b * s
    pairs = s * (s + 1) // 2
    # the forward's two products (S over qk width, P V over v width) and
    # the backward's four, over the causal pairs of every attention layer
    attn_flops = 6 * n_attn * b * cfg.num_heads * (d_qk + d_v) * pairs
    mfu = (6 * n_active * tokens + attn_flops) / (step_ms * 1e-3 * peaks[1])
    print(f"(t) train: {len(step_s)} timed steps, step {step_ms:.2f} ms (min"
          f" {1e3 * min(step_s):.2f}, max {1e3 * max(step_s):.2f}),"
          f" {tokens / (step_ms * 1e-3):.1f} tokens/s, MFU {mfu:.4f}"
          f" ((6 N_active tokens + {attn_flops:.3e} attention flops, no SSD"
          f" term; N_active {n_active} of {n_params})"
          f" / (step x {peaks[1]:.3g})), launches {launches}")
    peak, memory = out["peak_bytes"], out["memory"]
    predicted = memory["exact_bytes"]
    with memtrace.feedback():             # the corrector reads the samples
        corrected = memtrace.corrected_bytes(cfg.family, tc.zero, "H100-80G",
                                             predicted)
        margin = memtrace.margin_for(cfg.family, tc.zero, "H100-80G")
    print(f"(t) peak device memory over step 1: {peak} B"
          f" ({peak / 2**30:.3f} GiB); the port's exact_peak_bytes prediction"
          f" {predicted:.0f} B ({predicted / 2**30:.3f} GiB; the JAX package's"
          f" {JAX_PREDICTED_PEAK[arch]} B), accuracy {memory['acc_exact']:.4f};"
          f" paper_peak_bytes {memory['paper_bytes']:.0f} B, accuracy"
          f" {memory['acc_paper']:.4f}; observed / predicted"
          f" {peak / predicted:.4f}; memtrace ({memory['device_type']}):"
          f" corrected_bytes {corrected:.0f} B, margin_for {margin:.4f}")
    check(predicted == JAX_PREDICTED_PEAK[arch],
          f"the port's prediction {predicted} != the JAX package's"
          f" {JAX_PREDICTED_PEAK[arch]}")
    check(peak == ONE_DEVICE_PEAK[arch],
          f"{arch}'s peak {peak} B != the one-device path's"
          f" {ONE_DEVICE_PEAK[arch]} B")
    if peak > plan.pred_bytes:            # the lifecycle's answer, then fail
        report_oom(orch, sub, peak)
        print(f"(s) {arch} out of memory reported: "
              + sub.describe().replace("\n", ";"))
    check(peak <= plan.pred_bytes, f"{arch}'s peak {peak} B exceeds its"
                                   f" plan's pred_bytes {plan.pred_bytes:.0f} B")
    orch.release(job.job_id)
    check(job.state == "done", f"{arch}'s job is {job.state} after release")
    with memtrace.feedback():             # the replan after this sample
        fed = [p for p in predict_plans(cfg, job.global_batch, job.seq_len,
                                        device_types=["H100-80G"],
                                        zero=plan.zero)
               if (p.d, p.t) == (1, 1)]
    print(f"(s) {arch}: plan d={plan.d} t={plan.t} {plan.n_devices}x"
          f" {plan.device_type}, pred_bytes {plan.pred_bytes:.0f} B, min_mem"
          f" {plan.min_mem} B; observed peak over step 1 {peak} B, accuracy"
          f" {memory['acc_exact']:.4f}; min_mem under memtrace.feedback()"
          f" after the driver's sample "
          f"{fed[0].min_mem if fed else 'none (no d=1 t=1 plan)'}"
          f"{' B' if fed else ''}; job {job.state}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(loss_fell(losses), f"loss did not fall: {losses}")
    check(launches == want, f"training path launch counts {launches} != {want}")

    # the device's busy time in one step against its wall time above
    state = out["state"]
    step, _ = build_train_step(cfg, tc, b, s)
    batch = to_device(next(SyntheticTokens(cfg, b, s, seed=1)), "cuda")
    busy, kernels, n_events = device_profile(lambda: step(state, batch), 1)
    if busy == 0:
        print("(t) trace step: the profiler saw no device time; idle share"
              " not measured")
    else:
        top = "; ".join(f"{k[:48]} {ms:.3f}" for k, ms in kernels[:10])
        print(f"(t) trace step: device busy {busy:.2f} ms of {step_ms:.2f} ms"
              f" wall, idle share {1 - busy / step_ms:.3f}, {n_events:.0f}"
              f" device events ({(step_ms - busy) * 1e3 / n_events:.1f} us of"
              f" idle per event); top kernels (ms per step): {top}")

    # one full-width microbatch, kernel path against the plain path; the
    # optimizer state is no longer needed and makes room for the plain
    # path's gradient sum (deepseek-v2's cell fills the card)
    del state["opt"]
    gc.collect()
    torch.cuda.empty_cache()
    micro = {k: t[:1] for k, t in batch.items()}
    res, routes = [], []
    for impl in (None, "ref"):
        spied, restore = routing_spy(moe)
        try:
            with dispatch.force(impl):
                grads, loss = accumulate_grads(cfg, tc, state["params"], micro, 1)
                res.append((loss.item(), global_norm(grads).item()))
        finally:
            restore()
        routes.append(spied)
        del grads
    (lk, gk), (lp, gp) = res
    rl, rg = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    agree = ""
    if routes[0]:
        share = (sum(int((a == c).all(-1).sum()) for a, c in zip(*routes))
                 / sum(a.shape[0] * a.shape[1] for a in routes[0]))
        agree = (f"; share of routing choices (a token's top-{cfg.top_k} set"
                 f" in one MoE layer, forward and its recompute) equal on both"
                 f" paths: {share:.4f}")
    print(f"(t) kernel vs plain path, one microbatch b=1 s={s}: loss {lk:.6f}"
          f" vs {lp:.6f} (rel {rl:.3e}, tol {LOSS_RTOL:g}), grad norm"
          f" {gk:.6f} vs {gp:.6f} (rel {rg:.3e}, tol {GNORM_RTOL:g}){agree}")
    check(rl <= LOSS_RTOL and rg <= GNORM_RTOL,
          f"{arch} training kernel path differs from the plain path")
    return launches


# phase (m)'s and (v)'s rows, for phase (d)
MEASURED = {"m": [], "v": []}


def phase_memcheck():
    """(m) Fig 6 on the card: the ten ``launch.memcheck.COMBOS`` at ZeRO 1,
    each as rank 0 of its (d, t) plan under the fake process group (an
    out-of-memory, or a state whose bytes are not the specs' shards, raises
    out of ``run_one``), the mean accuracy beside the paper's 0.92; the
    attention forward and backward, RMSNorm and Adam must have run."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.memcheck import COMBOS, card, describe, run_one
    smi = card()
    reset_launches()
    rows = []
    for arch, b, s, d, t in COMBOS:
        t0 = time.perf_counter()
        rows.append(run_one(arch, b, s, d, t, zero=1, smi=smi))
        print(f"(m) {describe(rows[-1])}; rank 0's state"
              f" {rows[-1]['state_bytes']} B, held before it"
              f" {rows[-1]['base_bytes']} B; {time.perf_counter() - t0:.1f} s")
    launches = dict(LAUNCHES)
    MEASURED["m"] = rows
    under = sum(r["actual_bytes"] <= r["pred_exact"] for r in rows)
    print(f"(m) mean accuracy over the {len(rows)} combos at ZeRO 1: exact"
          f" {sum(r['acc_exact'] for r in rows) / len(rows):.4f}, paper"
          f" {sum(r['acc_paper'] for r in rows) / len(rows):.4f} (the paper"
          f" reports 0.92); observed <= exact prediction in {under} of"
          f" {len(rows)}; launches {launches}")
    with open(os.path.join(ROOT, "experiments", "memcheck_torch",
                           "memcheck_zero1.json")) as f:
        kept = [r["actual_bytes"] for r in json.load(f)]
    print(f"(m) peaks equal to the committed"
          f" experiments/memcheck_torch/memcheck_zero1.json rows:"
          f" {[r['actual_bytes'] for r in rows] == kept}")
    for k in ("flash_attention", "flash_attention_bwd", "adam_update",
              "rms_norm"):
        check(launches[k] > 0, f"phase (m) never launched {k}")
    return launches


def phase_family():
    """(f) rank 0 of each ``FAMILY_PLANS`` plan under the fake process
    group, one sharded step (an out-of-memory, or a state whose bytes are
    not the specs' shards, raises out of ``run_one``): the peak beside the
    port's prediction, reported; the plan's attention forward and backward,
    SSD scan and gradient, Adam and RMSNorm must have run."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.memcheck import card, describe, run_one
    from repro_torch.models.transformer import _mixer_kind
    smi = card()
    total = Counter()
    for arch, cut, b, d, t, zeros in FAMILY_PLANS:
        cfg = get_arch(arch).scaled(**cut) if cut else get_arch(arch)
        kinds = {_mixer_kind(cfg, j) for j in range(cfg.block_period)}
        want = ["adam_update", "rms_norm"]
        if kinds - {"ssm"}:
            want += ["flash_attention", "flash_attention_bwd"]
        if "ssm" in kinds:
            want += ["ssd_scan", "ssd_scan_bwd"]
        for zero in zeros:
            reset_launches()
            t0 = time.perf_counter()
            row = run_one(arch, b, 1024, d, t, zero=zero, cfg=cfg, smi=smi)
            launches = {k: n for k, n in LAUNCHES.items() if n}
            total.update(launches)
            print(f"(f) {describe(row)}{' cut ' + str(cut) if cut else ''};"
                  f" observed <= exact prediction"
                  f" {row['actual_bytes'] <= row['pred_exact']}; rank 0's"
                  f" state {row['state_bytes']} B, held before it"
                  f" {row['base_bytes']} B; launches {launches};"
                  f" {time.perf_counter() - t0:.1f} s")
            for k in want:
                check(launches.get(k, 0) > 0,
                      f"phase (f) {arch} d={d} t={t} zero={zero} never"
                      f" launched {k}")
    return total


def phase_seq():
    """(q) each ``SEQ_PLANS`` plan as rank 0 (and rank 15) of (16, 16)
    under the fake process group, one sharded step on the head_dim / seq
    fallback (an out-of-memory, or a state whose bytes are not the specs'
    shards, raises out of ``run_one``): the peak beside the port's
    prediction, reported; the plan's attention forward and backward, Adam
    and RMSNorm (and jamba's SSD scan and gradient) must have run, and at
    rank 15 the attention forward and backward at a nonzero query
    offset."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.memcheck import card, describe, run_one
    from repro_torch.models.transformer import _mixer_kind
    from repro_torch.parallel import sharding as sh
    smi = card()
    total = Counter()
    for arch, ranks in SEQ_PLANS:
        cfg, tc, d, t = seq_plan_config(arch)
        check(not sh.attn_head_sharded(cfg, t),
              f"phase (q) {arch}: its heads divide t={t}")
        want = ["adam_update", "rms_norm", "flash_attention",
                "flash_attention_bwd"]
        if "ssm" in {_mixer_kind(cfg, j) for j in range(cfg.block_period)}:
            want += ["ssd_scan", "ssd_scan_bwd"]
        for rank in ranks:
            reset_launches()
            t0 = time.perf_counter()
            row = run_one(arch, tc.global_batch, tc.seq_len, d, t,
                          zero=tc.zero, cfg=cfg, smi=smi, rank=rank)
            launches = {k: n for k, n in LAUNCHES.items() if n}
            total.update(launches)
            offset = (rank % t) * tc.seq_len // t
            before = SEQ_GATHERED_PEAK[arch, rank]
            print(f"(q) rank {rank} (query offset {offset}): {describe(row)};"
                  f" observed <= exact prediction"
                  f" {row['actual_bytes'] <= row['pred_exact']}; with the"
                  f" logits gathered {before} B (exact accuracy"
                  f" {1 - abs(row['pred_exact'] - before) / before:.4f}),"
                  f" now {row['actual_bytes'] - before:+d} B; the rank's"
                  f" state {row['state_bytes']} B, held before it"
                  f" {row['base_bytes']} B; launches {launches};"
                  f" {time.perf_counter() - t0:.1f} s")
            for k in want + (["flash_attention_offset",
                              "flash_attention_bwd_offset"] if offset else []):
                check(launches.get(k, 0) > 0,
                      f"phase (q) {arch} rank {rank} never launched {k}")
    return total


def phase_pod():
    """(p) rank 0 of each ``POD_PLANS`` plan on the two-pod (2, 16, 16)
    mesh under the fake process group, one sharded step (an
    out-of-memory, or a state whose bytes are not the specs' shards,
    raises out of ``run_one``): the peak beside both predictions and
    whether it stays under, reported; the attention forward and backward,
    Adam and RMSNorm must have run."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.memcheck import card, describe, run_one
    smi = card()
    total = Counter()
    for arch in POD_PLANS:
        cfg, tc, pods, d, t = pod_plan_config(arch)
        reset_launches()
        t0 = time.perf_counter()
        row = run_one(arch, tc.global_batch, tc.seq_len, d, t, zero=tc.zero,
                      cfg=cfg, smi=smi, pods=pods)
        launches = {k: n for k, n in LAUNCHES.items() if n}
        total.update(launches)
        print(f"(p) rank 0 of ({pods}, {d}, {t}): {describe(row)}; observed"
              f" <= exact prediction {row['actual_bytes'] <= row['pred_exact']}"
              f", <= paper prediction {row['actual_bytes'] <= row['pred_paper']};"
              f" rank 0's state {row['state_bytes']} B, held before it"
              f" {row['base_bytes']} B; launches {launches};"
              f" {time.perf_counter() - t0:.1f} s")
        for k in ("flash_attention", "flash_attention_bwd", "adam_update",
                  "rms_norm"):
            check(launches.get(k, 0) > 0,
                  f"phase (p) {arch} on {POD_MESH} never launched {k}")
    return total


def phase_serve():
    """(v) each ``SERVE_PLANS`` plan as rank 0 (and 15) of (16, 16) under
    the fake process group (``memcheck.run_serve``; an out-of-memory
    raises): the peak beside ``serve_peak_bytes`` and its accuracy,
    reported; the logits at the rank's shape and finite; the decode
    kernel of its attention (``flash_decode_gqa`` or ``flash_decode_mla``),
    on a prefill ``flash_attention`` (and jamba's ``ssd_scan``), and
    RMSNorm must have run."""
    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.memcheck import card, describe_serve, run_serve
    from repro_torch.models.transformer import _mixer_kind
    smi = card()
    total = Counter()
    for arch, shape, ranks in SERVE_PLANS:
        cfg = get_arch(arch)
        kinds = {_mixer_kind(cfg, j) for j in range(cfg.block_period)}
        want = ["rms_norm"]
        if get_shape(shape).kind == "prefill":
            want += ["flash_attention"] + (["ssd_scan"] if "ssm" in kinds else [])
        else:
            want += ["flash_decode_mla" if "mla" in kinds else "flash_decode_gqa"]
        for rank in ranks:
            reset_launches()
            t0 = time.perf_counter()
            row = run_serve(arch, shape, *SERVE_MESH, smi=smi, rank=rank)
            MEASURED["v"].append(row)
            launches = {k: n for k, n in LAUNCHES.items() if n}
            total.update(launches)
            print(f"(v) {describe_serve(row)}; observed <= serve_peak_bytes"
                  f" {row['actual_bytes'] <= row['pred_serve']}; logits"
                  f" {row['logits_shape']} finite {row['logits_finite']};"
                  f" launches {launches}; {time.perf_counter() - t0:.1f} s")
            t = SERVE_MESH[1]
            v = cfg.vocab_size // t if cfg.vocab_size % t == 0 else cfg.vocab_size
            check(row["logits_shape"][-1] == v and row["logits_finite"],
                  f"phase (v) {arch} {shape} rank {rank}: logits"
                  f" {row['logits_shape']}")
            for k in want:
                check(launches.get(k, 0) > 0,
                      f"phase (v) {arch} {shape} rank {rank} never launched {k}")
    return total


def phase_dryrun():
    """(d) rank 0's dry-run peak (meta device, the kernels' stand-ins) of
    each plan phases (m) and (v) ran, plus the row's ``base_bytes``,
    against the peak they measured in this run, each within
    ``dryrun.MEMCHECK_TOLERANCE`` (1%); the dry run launches nothing.  The stand-ins plan
    their launches for ``kernels.meta.SM_COUNT`` SMs, the card for its
    own."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.memory_model import dryrun_peak_bytes
    from repro_torch.kernels import LAUNCHES, meta
    from repro_torch.launch import dryrun
    from repro_torch.launch.memcheck import card
    smi = card()
    n_sm = meta.sm_count(torch.empty(0, device="cuda"))
    print(f"(d) the card has {n_sm} SMs, the dry run plans for"
          f" {meta.SM_COUNT}; {smi['device']}, {smi['power_limit']}")
    check(MEASURED["m"] and MEASURED["v"], "phase (d) runs after (m) and (v)")
    before = dict(LAUNCHES)
    ratios = []
    for row in MEASURED["m"]:
        t0 = time.perf_counter()
        got = dryrun.memcheck_row(row)
        ratios.append(got["ratio"])
        print(f"(d) {row['arch']} b={row['batch']} d={row['d']} t={row['t']}"
              f" zero={row['zero']}: dry-run peak {got['peak_bytes']} B +"
              f" base {row['base_bytes']} B against (m)'s"
              f" {row['actual_bytes']} B: {got['ratio']:.4f};"
              f" {time.perf_counter() - t0:.1f} s")
    for row in MEASURED["v"]:
        t0 = time.perf_counter()
        stats, _ = dryrun.trace_serve(get_arch(row["arch"]), row["shape"], 1,
                                      *SERVE_MESH, rank=row["rank"])
        peak = dryrun_peak_bytes(stats)
        ratio = (peak + row["base_bytes"]) / row["actual_bytes"]
        ratios.append(ratio)
        print(f"(d) {row['arch']} {row['shape']} rank {row['rank']} on"
              f" {SERVE_MESH}: dry-run peak {peak} B + base"
              f" {row['base_bytes']} B against (v)'s {row['actual_bytes']} B:"
              f" {ratio:.4f}; {time.perf_counter() - t0:.1f} s")
    check(dict(LAUNCHES) == before, "the dry run launched a kernel")
    worst = max(abs(r - 1) for r in ratios)
    print(f"(d) {len(ratios)} plans: dry run + base over the card's peak"
          f" {min(ratios):.4f} to {max(ratios):.4f}; {smi['device']},"
          f" {smi['power_limit']}")
    check(worst <= dryrun.MEMCHECK_TOLERANCE,
          f"a dry-run peak is {worst:.4f} off the card's")


def phase_op_timing():
    """(o) with ``op_timing`` on: llama3.2-3b's serving cell (8 requests)
    and two gpt2-350m training steps through their entry points, the
    exports reported; each ``ops_s/<op>`` has ``ops/<op>`` samples, and the
    kernels of both paths launched.  Returns the launches."""
    import tempfile
    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve as serve_main
    from repro_torch.launch.memcheck import card
    from repro_torch.launch.train import train
    from repro_torch.obs.export import export_chrome_trace, export_metrics
    from repro_torch.obs.report import report
    smi = card()
    reset_launches()
    obs.enable(op_timing=True)
    try:
        serve_main.main(["--arch", "llama3.2-3b", "--batch", "8",
                         "--prompt-len", "512", "--gen", "32",
                         "--continuous", "8"])
        gc.collect()
        torch.cuda.empty_cache()
        out = train(get_arch("gpt2-350m"), train_config(2), device="cuda",
                    log_every=1, log=lambda line: print(f"(o) {line}"))
        del out
    finally:
        obs.disable()
    launches = dict(LAUNCHES)
    with tempfile.TemporaryDirectory() as td:
        tpath, mpath = os.path.join(td, "trace.json"), os.path.join(
            td, "metrics.json")
        export_chrome_trace(tpath)
        export_metrics(mpath)
        with open(tpath) as f:
            trace = json.load(f)
        with open(mpath) as f:
            metrics = json.load(f)
    obs.clear()
    print(f"(o) the run report (op times are host times, not card times;"
          f" {smi['device']}, {smi['power_limit']}):")
    report(trace, metrics, out=sys.stdout)
    ops = {k[4:]: int(v) for k, v in metrics["counters"].items()
           if k.startswith("ops/")}
    timed = {k[6:]: h["total"] for k, h in metrics["histograms"].items()
             if k.startswith("ops_s/")}
    print(f"(o) ops {ops}; ops_s samples {timed}; launches"
          f" {({k: n for k, n in launches.items() if n})}")
    check(ops and timed == ops, f"ops_s samples {timed} != ops counts {ops}")
    for k in ("flash_attention", "flash_attention_bwd", "flash_decode_gqa",
              "rms_norm", "adam_update"):
        check(launches[k] > 0, f"phase (o) never launched {k}")
    return launches


def train_peak(arch):
    """--train-peak ARCH: the peak allocated (and reserved) device memory
    over step 1 of ARCH's training cell, under the PYTORCH_CUDA_ALLOC_CONF
    this process was started with, on one JSON line."""
    from repro_torch.launch.train import train
    out = train(train_cfg(arch), train_config(1), device="cuda",
                log=lambda line: None)
    print(json.dumps({"arch": arch,
                      "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
                      "expandable": expandable_segments(),
                      "peak_bytes": out["peak_bytes"],
                      "peak_reserved_bytes": torch.cuda.max_memory_reserved()}))
    return 0


def alloc_peaks():
    """--alloc-peaks: each training cell's peak over step 1 with the
    caching allocator's expandable segments off, then on (as the entry
    points set them), one process each."""
    from repro_torch.kernels import _build
    from repro_torch.launch import ALLOC_CONF
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    _build.build()
    for arch in TRAIN_PARAMS:
        for conf in ("expandable_segments:False", ALLOC_CONF):
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--train-peak", arch], capture_output=True,
                                 text=True,
                                 env={**os.environ, "PYTORCH_CUDA_ALLOC_CONF": conf})
            check(res.returncode == 0, f"{arch} with {conf} failed:\n"
                                       f"{res.stderr[-4000:]}")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(f"alloc {arch} PYTORCH_CUDA_ALLOC_CONF={conf}: expandable"
                  f" segments in use {line['expandable']}, peak allocated over"
                  f" step 1 {line['peak_bytes']} B, peak reserved"
                  f" {line['peak_reserved_bytes']} B; the JAX package's"
                  f" prediction {JAX_PREDICTED_PEAK[arch]} B")
    return 0


def time_kernels():
    """--time-kernels: the redesigned kernels' times at their main-path
    shapes, from whichever tree ``--src`` names, on one JSON line."""
    from repro_torch.kernels.flash_decode import flash_decode_gqa, flash_decode_mla
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    t = SSD_TRAIN
    for name, (b, s, h, P, N) in (
            ("ssd_scan_bwd train", (t["b"], t["s"], t["h"], t["P"], t["N"])),
            ("ssd_scan_bwd ragged b=2 s=1000", (2, 1000, 24, 64, 128))):
        args = ssd_inputs(gen, b, s, h, P, N, torch.bfloat16)
        dy = torch.randn(b, s, h, P, generator=gen, device="cuda").bfloat16()
        out[name] = time_ms(lambda: ssd_scan_bwd(*args, dy), flush)
    for name, shape in (("ssd_scan prefill", SSD_PREFILL),
                        ("ssd_scan prefill_32k", SSD_LONG)):
        b, s, h, P, N = (shape[k] for k in ("b", "s", "h", "P", "N"))
        args = (torch.randn(b, s, h, P, generator=gen, device="cuda").bfloat16(),
                (torch.randn(b, s, h, generator=gen, device="cuda") * 0.5).bfloat16(),
                torch.randn(h, generator=gen, device="cuda") * 0.3,
                torch.randn(b, s, N, generator=gen, device="cuda").bfloat16(),
                torch.randn(b, s, N, generator=gen, device="cuda").bfloat16(),
                torch.randn(h, generator=gen, device="cuda"),
                torch.full((h,), 0.1, device="cuda"))
        out[name] = time_ms(lambda: ssd_scan(*args), flush)
    d = DECODE
    q = torch.randn(d["b"], 1, d["H"], d["D"], generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(d["b"], d["S"], d["K"], d["D"], generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    valid = ring_valid(gen, d["b"], d["S"])
    out["flash_decode_gqa decode_ring"] = time_ms(
        lambda: flash_decode_gqa(q, k, v, valid), flush)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out["SDPA decode_ring"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=valid[:, None, None, :], enable_gqa=True), flush)
    d = MLA_DECODE
    for b in (d["b"], 4, 1):            # the decode shape, then smaller batches
        mla = (*(torch.randn(b, n, w, generator=gen, device="cuda").bfloat16()
                 for n, w in ((d["H"], d["r"]), (d["H"], d["dr"]),
                              (d["S"], d["r"]), (d["S"], d["dr"]))),
               ring_valid(gen, b, d["S"]))
        out["flash_decode_mla decode_ring" + ("" if b == d["b"] else f" b={b}")] = \
            time_ms(lambda: flash_decode_mla(*mla, denom=math.sqrt(128 + d["dr"])),
                    flush)
    print(json.dumps({"src": SRC, "ms": out}))
    return 0


def mla_splits():
    """--mla-splits: ``flash_decode_mla`` at deepseek-v2's decode shape and
    at b=4 and b=1 of the same cache, at each split from one to nine splits
    and at 16- and 48-row splits: the clusters of each split count the card
    holds at once, the kernels' traced times (L2 warm), the mean time after
    an L2 flush, and the error against the split-KV oracle at that split;
    the kernel's own split is marked."""
    from repro_torch.kernels.flash_decode import mla_block_s, mla_decode_splitk
    from repro_torch.kernels.flash_decode.flash_decode_mla import (
        _launch, _resident_clusters)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    d = MLA_DECODE
    denom = math.sqrt(128 + d["dr"])
    print(f"device: {torch.cuda.get_device_name(0)}; clusters of 1..8 splits"
          f" resident at once:"
          f" {[_resident_clusters(d['r'], d['dr'], n) for n in range(1, 9)]}")
    splits = {16 * math.ceil(math.ceil(d["S"] / n) / 16) for n in range(1, 10)}
    for b in (d["b"], 4, 1):
        args = (*(torch.randn(b, n, w, generator=gen, device="cuda").bfloat16()
                  for n, w in ((d["H"], d["r"]), (d["H"], d["dr"]),
                               (d["S"], d["r"]), (d["S"], d["dr"]))),
                ring_valid(gen, b, d["S"]))
        chosen = mla_block_s(args[0], args[2])
        for bs in sorted(splits | {16, 48}):
            got = _launch(*args, denom, bs)
            err = rel_max_err(got, mla_decode_splitk(*args, denom=denom,
                                                     block_s=bs))
            ms = time_ms(lambda: _launch(*args, denom, bs), flush)
            _, kernels, _ = device_profile(lambda: _launch(*args, denom, bs), 20)
            print(f"mla b={b} split {bs} rows, {-(-d['S'] // bs)} splits"
                  f"{' (chosen)' if bs == chosen else ''}: {ms:.4f} ms after"
                  f" an L2 flush; traced "
                  + "; ".join(f"{kn[:48]} {t:.4f}" for kn, t in kernels)
                  + f"; max|d|/max|ref| {err:.3e}")
            check(err <= BF16_TOL,
                  f"flash_decode_mla at b={b}, {bs}-row splits disagrees")
    return 0


def ab(other):
    """--ab OTHER: --time-kernels on OTHER's tree and on this one, in turns
    (other, this, this, other), one process each."""
    here = os.path.join(ROOT, "src")
    there = os.path.join(os.path.abspath(other), "src")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    for turn, src in enumerate((there, here, here, there)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--time-kernels", "--src", src],
                             capture_output=True, text=True)
        check(res.returncode == 0, f"turn {turn} ({src}) failed:\n{res.stderr[-4000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"ab turn {turn} {'other' if src == there else 'this'}: "
              + ", ".join(f"{k} {ms:.4f} ms" for k, ms in line["ms"].items()))
    return 0


def timed_phase(name, fn):
    """Run one phase, print its wall time, and free what it left on the
    card (its weights) before the next phase starts."""
    t0 = time.perf_counter()
    out = fn()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase {name}: {time.perf_counter() - t0:.1f}s wall")
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    if "--time-kernels" in sys.argv:
        return time_kernels()
    if "--ab" in sys.argv:
        return ab(sys.argv[sys.argv.index("--ab") + 1])
    if "--mla-splits" in sys.argv:
        return mla_splits()
    if "--train-peak" in sys.argv:
        return train_peak(sys.argv[sys.argv.index("--train-peak") + 1])
    if "--alloc-peaks" in sys.argv:
        return alloc_peaks()
    from repro_torch.kernels import _build
    from repro_torch.launch import configure_allocator

    configure_allocator()     # as the entry points do, before any allocation

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in smi), None)
    check(peaks is not None, f"no peak rates on record for {smi!r}")
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | kernels built in {build_s:.1f}s")
    report_build()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    print(f"allocator: PYTORCH_CUDA_ALLOC_CONF="
          f"{os.environ['PYTORCH_CUDA_ALLOC_CONF']}, expandable segments in"
          f" use {expandable_segments()}")
    rows = timed_phase("kernels", lambda: phase_kernels(peaks, flush))
    del flush
    serve_plan = timed_phase("serverless front door", phase_serverless)
    # launches: the sum over the main-path runs, each counted from 0
    path_launches = [timed_phase("llama3.2-3b serving", lambda: phase_model(
                         serve_plan=serve_plan)),
                     timed_phase("deepseek-v2-236b serving", phase_deepseek),
                     timed_phase("mamba2-130m serving", phase_mamba2),
                     timed_phase("jamba-1.5-large-398b serving", phase_jamba),
                     timed_phase("gpt2-350m training",
                                 lambda: phase_train(peaks, "gpt2-350m")),
                     timed_phase("mamba2-130m training",
                                 lambda: phase_train(peaks, "mamba2-130m")),
                     timed_phase("stablelm-12b serving", lambda: phase_model(
                         "stablelm-12b", seed=8, want_params=STABLELM_PARAMS)),
                     timed_phase("deepseek-v2-236b training",
                                 lambda: phase_train(peaks, "deepseek-v2-236b")),
                     timed_phase("stablelm-12b training",
                                 lambda: phase_train(peaks, "stablelm-12b")),
                     timed_phase("(m) memcheck", phase_memcheck),
                     timed_phase("(f) family plans", phase_family),
                     timed_phase("(q) query offset", phase_seq),
                     timed_phase("(p) pod axis", phase_pod),
                     timed_phase("(v) sharded serving", phase_serve)]
    timed_phase("(d) dry run against the card", phase_dryrun)
    path_launches.append(timed_phase("(o) op timing and the report",
                                     phase_op_timing))
    for kname, row in rows.items():
        row["launches"] = sum(launches[kname] for launches in path_launches)
    print(f"total wall time {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [rows[k] for k in (
        "flash_attention", "flash_attention_bwd", "flash_decode_gqa",
        "flash_decode_mla", "adam_update", "ssd_scan", "ssd_scan_bwd",
        "rms_norm")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
