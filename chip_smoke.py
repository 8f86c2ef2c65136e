#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (honk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA device and
nvcc. Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build the three kernels (csrc/mfcc.cu, csrc/res_stack.cu,
   csrc/assemble.cu) with nvcc, in parallel;
3. MFCC kernel against its plain PyTorch version on the card, B=257
   (256 rows of seeded noise and one silent row, which must be exactly 0)
   at 16000 samples and at the 8000 and 24000 that /listen also sends,
   B=1, and against the float64 golden (compute_mfccs_reference) on a few
   rows; its launch geometry;
4. res-stack kernel against its plain version: zoo/res8.pt weights at
   B = 1, 2, 3, 133 and 256, and random res8-narrow, res26 and
   res26-narrow weights (randomized BN statistics) at B = 1 and 3; the
   cluster geometry the wrapper picks at each;
5. LabelService("res8", "zoo/res8.pt") on cuda against the same service
   on the CPU: evaluate_batch of 256 seeded utterances;
6. the serving path: the HTTP server answers GET /labels and 8 POST /listen
   requests; each answer is checked against the CPU service, and each
   kernel's launch count must be exactly 8 over this phase; the same
   utterances then go through LabelService.evaluate alone, on the host
   clock, to split a request's time between HTTP and the service;
7. each kernel and its plain version timed with CUDA events at B=1 and
   B=256;
8. the assembly kernel against its plain version: the exact and the
   sub-row layout, B=64 and B=1024, with silence rows;
9. three float32 train steps of res8 at full width, B=64, on cuda and on
   the CPU from the same initial weights and the same draws (made on the
   CPU: the two devices' generators differ): losses and weights compared;
10. the training path through its entry point: honk_tpu_torch.cli.train
    trains res8 (bf16, B=64) for 2 epochs on a synthetic corpus, with exact
    launch counts of all three kernels over the run (the res stack's in its
    bf16-activation mode: the run's dev and test sweeps evaluate its bf16
    model in flax's dtype flow); then
    --type eval of its best.pt (float32) on cuda and on the CPU must give
    the same accuracy;
11. timings with CUDA events: the assembly kernel and its plain version
    at B=64 and B=1024, the MFCC at B=64, and one train step at B=64 in
    float32 and bf16, split into assembly, MFCC and forward + backward +
    update;

then the rest of the model family (res15, res15-narrow, cnn-trad-pool2),
which runs on cuDNN and cuBLAS between the MFCC and assembly kernels:

12. the eval forward of zoo_hard_v2/res15.pt, res15-narrow.pt and
    cnn-trad-pool2.pt through LabelService at B=256 on cuda and on the
    CPU: logits within 2e-4, equal labels, exactly one MFCC launch per
    batch and no res-stack launch;
13. /listen for res15 and cnn-trad-pool2: one server per model, 4
    requests each, each answer equal to the CPU service's; MFCC launches
    exactly 4 per model, res stack 0;
14. hard_v2 clip by clip: the corpus regenerated from
    zoo_hard_v2/MANIFEST.json's corpus_recipe, loaded with dev_pct=10,
    test_pct=80 (the MANIFEST's split sizes), and all seven zoo_hard_v2
    checkpoints evaluated on the card at B=256 (res8 and res26 through the
    res-stack kernel, res15 and cnn-trad-pool2 through cuDNN): each
    model's per-clip correctness must agree with its committed
    <model>_test_correct.npy on at least 9,550 of the 9,559 test clips,
    and its accuracy be within 0.1 points of test_acc_recheck;
15. three float32 train steps of res15 (B=16) and cnn-trad-pool2 (B=64) on
    cuda and on the CPU from the same weights, draws and dropout masks,
    compared like phase 9; then honk_tpu_torch.cli.train trains each (bf16,
    B=64) for one epoch on phase 10's corpus with exact MFCC and assembly
    launch counts (res stack 0), and --type eval of each best.pt gives the
    same accuracy on cuda and on the CPU;
16. timings for res15 and cnn-trad-pool2: the eval forward (MFCC + model)
    at B=1 and B=256 with CUDA events, and one train step at B=64 in
    float32 and bf16 on the host clock (50 steps) and as device time,
    kernels per step and idle share (torch.profiler, 10 steps);

then streaming, on the ground-truth track of tests/test_stream.py (60 s of
noise with six keywords planted at known positions, zoo/res8.pt):

17. the MFCC kernel's causal framing (the online step) against its plain
    version at 8 x (480 + 3200), 1 x (480 + 160) and 64 x (480 + 16000), and
    its center framing on one 60 s and one 10 min waveform; times and bounds;
18. offline: LabelService.evaluate_long and stream_file on the track, cuda
    against cpu (smoothed within 1e-4, equal events, the planted positions),
    exactly one mfcc and one res_stack launch; POST /stream against the CPU
    service; a 10 min track on cuda (wall time, audio-s per s); the res stack
    at B=8 and at B = the 10 min track's windows, against plain and timed;
19. online: a Streamer over the track on cuda against the CPU, chunk by
    chunk, one mfcc and one res_stack launch a step;
20. the stream hub over HTTP with the serving CLI's defaults (8 slots,
    3200-sample chunks, 2 ms coalescing), one session on the track and seven
    on noise, run four times (sync, pipelined, the int16 wire, push_bin):
    every answer equal to a CPU hub's on the same chunks, the planted
    keywords found and no event on the noise; host ms per tick and per push
    (the first on a new keep-alive connection apart), device ms and kernels
    per tick (torch.profiler over 20 ticks), launches per tick;
21. res15 and cnn-trad-pool2 through stream_file and a 3-slot BatchStreamer
    on the track (60 steps), cuda against cpu.

then personalization and the dataset generator, on zoo/res8.pt:

22. TrainingService.fine_tune of three positives (the generator's word "cat"
    as "yes"): 3 steps on cuda against the CPU from the same weights (loss
    and weights as phase 9), then the default 60 steps on both; exactly one
    mfcc launch and nothing else per fine-tune; torch.profiler over a 10-step
    fine-tune; then a server with 8 stream slots: POST /train (one mfcc
    launch), /listen of the positives and 8 utterances against a CPU service
    given the same new weights (one mfcc and one res_stack launch each), a
    hub session opened before /train against a CPU hub swapped at the same
    chunk; POST /train on a --no-train server answers 503;
23. the datagen CLI with --eval_checkpoint zoo/res8.pt on the 60 s and 10 min
    tracks with a caption at each planted keyword (66 clips), on cuda and on
    the CPU: the same clip files and verdicts, probabilities within 1e-4,
    ceil(66 / 256) launches of the MFCC and the res stack; clips scored per
    second;

then the device worker, data parallel, profiling and the native loader
(25-27 run right after phase 11 on its corpus, 28 after phase 14 on the
hard_v2 corpus, 24 last):

24. the repair of the per-thread setup: for res8, res15 and cnn-trad-pool2,
    30 /listen on a new connection each (a new server thread each): the
    round trip, the service call inside it, GET /labels beside it; then
    LabelService.evaluate on the main thread, on a new thread per call and
    on one worker thread; the hub's first push on a new connection (phase
    20) against its steady push;
25. data parallel at world size 1 on NCCL: cli.train trains res8 as phase
    10 did, with --coordinator / --num-processes 1 / --process-id 0; its
    last step checkpoint must equal phase 10's within 1e-6 and its accuracy
    be phase 10's; launch counts; then, in a world-1 NCCL group, a train
    step's host ms with and without the mesh, in turns, the device time of
    an NCCL all-reduce of res8's gradient (torch.profiler),
    dryrun_multichip(1), stream_file and an 8-slot BatchStreamer (masked
    every other step) with data_axis="data" bitwise equal to their
    unsharded runs;
26. each kernel on a rank's rows (2 and 4 ranks of a B=64 batch) against
    the same rows of the unsharded launch: assembly and MFCC bitwise, the
    res stack within its gate;
27. cli.train --profile-dir: the traces of the first dispatch and the first
    dev eval name the three kernels and the annotate ranges;
28. the native WAV loader built with g++ here: the hard_v2 corpus loaded
    through it equals the Python reader's, and the load times of both;

then the bf16 eval path and the Orbax loader (29 right after phase 7, 30
after phase 16, 31 after phase 34):

29. the res stack's two bf16 modes against their plain versions (bf16
    operands, float32 sums). The bf16 mode (the TPU kernel's float32
    activations and bf16 Dense): zoo/res8.pt, built bf16, at B = 1, 3, 8,
    256 and 2,996 on its bf16 stem, and random res8-narrow, res26 and
    res26-narrow weights at B = 1 and 3, held row by row (BF16_KERNEL_ROWS)
    on the stack's first two layers at every shape and on the whole stack
    from B=256, each of three faults run beside it as plain versions
    (float32 operands, truncation, an unrounded mean) outside that gate.
    The bf16-activation mode (flax's dtype flow: each layer's output, the
    residual sum and BN's output rounded to bf16, a float32 Dense) the same
    way at B = 1, 8, 256 and 2,996 and on the random models at B = 1 and 3
    (BF16_FLOW_ROWS on the whole stack, BF16_FLOW_LAYER_ROWS on two layers),
    its faults the Pallas flow, float32 activations and a bf16 Dense. Every logit within 0.05, argmax equal outside that margin of
    a tie; argmax against the float32 mode on the same input, the cluster
    geometry, ptxas registers and spills, CUDA-event times beside the
    float32 mode's and the bound (bytes over HBM or flops over dense bf16);
30. the bf16 eval path through its entry points: the training CLI runs of
    phases 10 and 15 (the CLI's default --compute_dtype bfloat16) launch
    only the res stack's bf16-activation mode in their dev and test sweeps
    (res8) or none (res15, cnn-trad-pool2), and their --type eval stays
    float32; then make_forward of a bf16 res8 (zoo_hard_v2/res8.pt) on 256
    hard_v2 test clips on the card against the same forward on the CPU,
    held row by row (BF16_FORWARD_ROWS) with the float32 forward outside
    that gate, argmax equal outside 0.05 of a tie, one mfcc and one
    bf16-activation res-stack launch, its times beside the float32
    forward's; then the TPU kernel's fused forward (res_forward_fused: the
    float32 stem, then the bf16 mode) on the same clips, one mfcc and one
    bf16-mode launch, cuda against the CPU by the same rows. Whether the
    port's bf16 forward computes flax's bf16 apply is held on the CPU
    (tests/test_torch_bf16.py), not here;
31. the Orbax loader, the port's own (ckpt.ocdbt, ckpt.zstd on the system's
    libzstd): the decoder report (whether ctypes finds and opens libzstd,
    and whether zstandard, numcodecs and tensorstore import); all 14
    committed best/ directories read on the host, each bit for bit its
    sibling .pt, with the host ms of each load beside the .pt's; /listen x4
    from zoo/res8/best against the zoo/res8.pt service's answers, one MFCC
    and one res_forward launch a request; the serving CLI built on
    --checkpoint zoo/res8; and cli.train --type eval --input_file
    zoo_hard_v2/res15/best on phase 14's corpus, equal to the same CLI on
    res15.pt and to phase 14's res15 accuracy, one MFCC launch a batch;
32. the stream hub sharded over ranks (StreamHub(data_axis="data"), int16
    wire): at world size 1 on NCCL over HTTP (make_handler with a
    TrainingService at PERSONALIZE_LR), eight sessions on phase 20's
    streams, one /stream/push_bin a tick and POST /train before tick
    HUB_SWAP_TICK; bitwise the unsharded hub given the same ticks and the
    same new weights (over HTTP, and through push_rows), the swap seen on
    that tick against a hub without it, the planted keywords found and no
    false alarm before the swap and over the whole track without it,
    exactly one mfcc and one float32 res-stack launch a tick (and /train's
    one mfcc); NCCL's refusal of a raw int16 broadcast, and the int16
    wire's bytes through NCCL (broadcast_bytes); then the same hub over
    HUB_RANKS gloo ranks on the one card (scripts/chip_hub_ranks.py: NCCL
    refuses two ranks on one device), rank 0 leading and rank 1 following,
    within RANKS_ATOL of world size 1 with the same events, each rank's
    launches one a tick; host ms per tick of each run, device ms per tick
    of the world-1 run;

and the bf16 training step (right after phase 11):

33. phase 9's three train steps of res8 at B=64 in bf16 on cuda and on the
    CPU, and in float32 on cuda: every layer's output dtype equal on both
    devices and flax's (bf16 but the output Dense); the bf16 pool
    (layers.avg_pool) bitwise equal on both, forward and backward, on
    conv0's bf16 ReLU output; the weights' cuda-CPU distance within
    BF16_TRAIN_RATIO of their cuda bf16-float32 distance over all tensors
    and BF16_TRAIN_TENSOR_RATIO a tensor; phase 11's bf16 and float32
    steps' host ms, device ms and kernels beside each other.

and the recipe's accuracy (right after phase 30, on phase 14's corpus):

34. python -m honk_tpu_torch.cli.zoo build trains res8 and res15 on the
    regenerated hard_v2 at zoo_hard_v2's recipe (26 epochs, B=64, bf16,
    lr 0.1 / 0.01 / 0.001 at steps 220 / 440, dev 10 %, test 80 %), seed 0,
    with exact launch counts (res8's sweeps in the bf16-activation mode),
    then cli.zoo compare --against zoo_hard_v2 scores both in float32 on
    the 9,559 test clips: each test_acc_recheck must lie within the JAX
    package's seeds 0-2 (runs/seed_variance_r04.json) widened by 2 SE, and
    res15 must beat res8 (McNemar z > 0); prints both accuracies, the z,
    the paired z against the committed vectors and each model's wall time.

and the scaling harness (right after phase 33):

35. python -m honk_tpu_torch.cli.scaling 1 on the card (scripts/scaling_bench.py's
    harness: res8 float32, 128 utterances a step, scans of 20 and 80 steps
    timed twice after one untimed run of each): its row has scaling_bench's
    keys and a finite step time, printed beside phase 11's float32 step at
    B=64; the assembly and MFCC kernels launched exactly once a step and the
    res stack never. Two and four cards: scripts/chip_train_nccl.py.

and the measuring tools (right after phase 35, each printing its JSON line):

36. honk_tpu_torch.graft_entry.entry() (__graft_entry__.py's res8 float32
    raw-audio -> logits forward): its logits on the card against the same
    entry on the CPU within 2e-4; one MFCC and one float32 res-stack launch;
37. python -m honk_tpu_torch.cli.bench (bench.py) at BENCH_REPS=3 and scans
    of 8 / 32 train links (16 / 64 inference links): bench.py's keys, both
    rates finite and positive, suspect false, and exact launches per link:
    an inference link one MFCC and one res stack in its bf16-activation mode,
    a train link one assembly and one MFCC;
38. python -m honk_tpu_torch.cli.bench_stream (scripts/bench_stream.py) at
    256 streams of 3200 samples: its keys, a finite step, one causal MFCC
    and one bf16-activation res stack a step;
39. python -m honk_tpu_torch.cli.bench_serve (scripts/bench_http_serve.py)
    for 10 s at 64 slots and 4 gateways on push_bin: its keys, every push
    answered, and one MFCC and one float32 res stack per slab dispatch (the
    device-only reference's 53 and the hub's).

and the reference's last repo-level tools (right after phase 39, each leg's
launches read from 0 around its ``cli.bench.marginal`` call, one a leg):

40. python -m honk_tpu_torch.cli.microbench 256 (scripts/tpu_microbench.py,
    float32 res8, chains of 20 / 60): its four lines, finite times; no
    launch per frontend_jnp link (cuBLAS), one MFCC per frontend_pallas
    link, one float32 res stack per model_only link, one of each per
    full_fwd link;
41. python -m honk_tpu_torch.cli.bench_res_kernel (scripts/bench_res_kernel.py,
    bf16 res8, RK_BATCH=256, one rep): its keys and the model's own line; a
    link of the model's forward one res stack in its bf16-activation mode, of
    the xla leg (cuDNN) none, of the fused leg one in its bfloat16 mode; then
    the fused leg's logits against the xla leg's on the card at the
    reference's bf16 gate (tests/test_res_kernel.py: atol and rtol 0.05,
    argmax equal outside 0.05 of a tie);
42. python -m honk_tpu_torch.cli.hard_probe (scripts/hard_probe.py), one
    epoch of a bf16 res8 at B=64 on a corpus of 20 clips a word: its lines,
    one assembly and one MFCC a step, one MFCC and one bf16-activation res
    stack a dev batch;
43. python -m honk_tpu_torch.cli.make_corpus --hard (scripts/make_corpus.py)
    at 2 clips a word: the line is the corpus's CORPUS.json; no launch;
44. python -m honk_tpu_torch.cli.prof_fwd <leg> (prof_fwd2.py), every leg at
    B=1024: its lines; a link of xla and mfcc_only no launch, of pmfcc and
    pmfcc_only one MFCC, of mk one res stack in its bfloat16 mode;
45. python -m honk_tpu_torch.cli.prof_train <leg> 256 (prof_train.py), every
    leg: its line; a link of full one assembly and one MFCC, of noaug and
    frontend one MFCC, of aug one assembly, of fwdbwd none;
46-48. python -m honk_tpu_torch.cli.prof_res15 / prof_res15_parts /
    prof_res15_dispatch (scripts/prof_res15*.py) at B=256, chains of 2 / 4,
    one rep: their keys, finite times; one assembly and one MFCC per train
    step, no launch in any other probe;
49. each kernel those tools launched, against its plain version on the
    tools' own inputs at their shapes: the MFCC at B = 256 (microbench,
    prof_train) and 1,024 (prof_fwd) at MFCC_TOL; the float32 res stack on
    microbench's res8 at 256 at RES_TOL; the bfloat16 mode on
    bench_res_kernel's fused stem at 256 and prof_fwd's mk stem at 1,024,
    the bfloat16_activations mode on bench_res_kernel's bf16 stem at 256,
    by phase 29's row limits; the assembly on prof_train's and the res15
    probes' draws at 256 within ASSEMBLE_ATOL.

and the res stack with the stem inside it (right after phase 29):

50. the res stack's entry from the features (res_forward: conv0, ReLU and
    the pool inside the kernel, one launch from the MFCC features to the
    logits) against res_forward_plain in all three modes: zoo/res8.pt and
    random res26 weights at B = 1, 8, 256, 1,024 and 2,996, res8-narrow and
    res26-narrow at 256 (float32 at RES_TOL; the bf16 modes by phase 29's
    row limits, their faults refused on res8 at 256); from torch.profiler
    exactly one device kernel per eval forward of res8 and res26 in float32
    and bf16 at B = 8 and 256 and of res_forward_fused, each one res_forward
    launch and no res_stack one; CUDA-event times of each forward beside the
    two-launch path it replaced (the stem as PyTorch ops, then the pooled
    entry) and the plain version, and the bound (conv0 at the float32
    CUDA-core rate plus the stack at the mode's tensor-core rate).

It prints a JSON line of per-kernel results (for the res stack also each
mode's forward from the features, and its launches by entry on every path),
then, as the last line,
{"ok": true, "device": {...}}. The port's package, never JAX, is imported.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
START_TIME = time.time()
CHECKPOINT = os.path.join(ROOT, "zoo", "res8.pt")
HARD_V2 = os.path.join(ROOT, "zoo_hard_v2")
FAMILY = ("res15", "res15-narrow", "cnn-trad-pool2")  # the configs the res-stack kernel does not run
N_LISTEN_FAMILY = 4
# Phase 14: clips of the 9,559 that may disagree with the committed vectors
# (each is a near-tie whose argmax flips between two f32 runtimes), and the
# accuracy gap allowed against test_acc_recheck (0.1 points).
HARD_V2_MIN_AGREE = 9550
HARD_V2_ACC_ATOL = 1e-3
SEED = 0
BATCH = 256
N_LISTEN = 8
# Kernel against its plain version on the same card, both float32 with TF32 off.
# MFCC: the DFT sums 480 products in another order and the log turns that
# relative error into absolute error on each mel energy; 1e-4 is still 50x
# inside the 5e-3 gate against the float64 golden.
MFCC_TOL = dict(atol=1e-4, rtol=1e-4)
# Against the float64 golden: the reference's golden gate (tests/test_frontend.py).
GOLDEN_TOL = dict(atol=5e-3, rtol=1e-3)
# Res stack: the reference's own gate for its res-stack kernel
# (tests/test_res_kernel.py, kernel against the XLA model in f32).
RES_TOL = dict(atol=5e-4, rtol=1e-3)
# Whole service, cuda against cpu: the checkpoint logit gate of the reference
# (tests/test_cross_runtime.py); probabilities of one answer within 1e-4.
LOGIT_ATOL = 2e-4
PROB_ATOL = 1e-4
# Assembly: the reference's gate (tests/test_assemble_kernel.py). The kernel
# rounds the two products and the sum as the plain version does, so 0 is expected.
ASSEMBLE_ATOL = 1e-6
# Train steps, cuda against cpu, float32 with TF32 off, lr 0.01 then 0.001: the
# MFCC kernel differs from the plain frontend by ~2e-6 and cuDNN's backward sums
# in another order than the CPU's, and three steps from a fresh init amplify that.
TRAIN_LOSS_ATOL = 1e-4
TRAIN_PARAM_TOL = dict(atol=1e-4, rtol=1e-3)
TRAIN_BATCH = 64
# Phase 33: the weights after three bf16 steps, the cuda run's distance from
# the CPU's as a share of its distance from the cuda float32 run (Frobenius
# norms): over all tensors at most BF16_TRAIN_RATIO, the rule that holds the
# port's bf16 step to JAX's on the CPU (tests/test_torch_bf16_train.py), and
# each tensor nearer the other bf16 run than the float32 one. cuDNN and
# oneDNN sum bf16 products in other orders, and a rounding decided the other
# way grows through BN: JAX's own compiled and op-by-op bf16 steps part by
# up to 0.65 a tensor at res8 B=64 (scripts/probe_bf16_step_spread.py).
BF16_TRAIN_RATIO = 0.5
BF16_TRAIN_TENSOR_RATIO = 1.0
# Streaming (phases 17-21): the ground-truth track of tests/test_stream.py,
# keywords planted at known positions in 60 s of noise, and its detection
# config; smoothed posteriors cuda against cpu within 1e-4 (probabilities
# from logits within the 2e-4 gate, averaged).
STREAM_KEYWORDS = ("yes", "stop", "go", "left", "no", "right")
STREAM_CFG = dict(min_gap_windows=10, smoothing_window=3, detection_threshold=0.6)
STREAM_ATOL = 1e-4
CHUNK = 3200  # 200 ms, the serving CLI's default
HUB_SLOTS = 8  # the serving CLI's default
LONG_TRACK_S = 600  # the offline phase's long track: 10 min
FAMILY_STREAM_STEPS = 60  # res15 / cnn BatchStreamer steps (12 s of the track): the CPU side is the slow one
# Personalization (phase 22): an unknown word of the synthetic generator takes
# over a keyword's label slot, as the reference's web demo personalizes one.
PERSONALIZE_WORD = "cat"
PERSONALIZE_LABEL = "yes"
# TrainingService's defaults (the JAX package's: lr 0.01, momentum 0.9, 60
# steps, BN frozen) diverge on zoo/res8.pt; the swap over HTTP is checked
# with a trainer at this rate, which converges (0.41 after 60 steps on the CPU).
PERSONALIZE_LR = 0.001
# Phase 24: rounds of one call per column, taken in turns.
N_WORKER_ROUNDS = 40
# Phases 29-30: the res stack's bf16 mode against its plain version on the card,
# and make_forward of a bf16 model cuda against cpu, held row by row. Both sides
# round the same f32 values to bf16, but their f32 sums differ in order, so a
# value near a rounding boundary can round the other way ("a flip") and move a
# row's logits by 1e-3 to 1.6e-2, while a row without one stays within ~1e-6.
# Flips grow with depth and rows: in 24 layers of random res26 weights, 2 of 3
# rows have one. So a gate reads each row's largest logit gap: the median row,
# the share of rows past a tail gap, and every row within the reference's own
# gate for its bf16 mode (tests/test_res_kernel.py: 0.05). The faults it must catch run
# beside it as plain versions on the same input (bf16_faults, or the float32
# forward), and each fault's median must pass the median limit and be
# BF16_NEARER times the kernel's. Phase 29 holds the kernel so at every shape on
# the stack's first BF16_DEPTH layers, where flips are rare, and on the whole
# stack from BF16_FULL_ROWS rows up. Each limit sits between the kernel's
# readings and the faults' (PERF.md §6).
# Phase 32: the hub sharded over ranks. Posteriors of two ranks within
# RANKS_ATOL of one rank (tests/test_torch_parallel.py's streaming gate); the
# served posteriors are rounded to 1e-6, so those lists may differ by one
# rounding step more, and the unrounded prob of the winning label is held to
# RANKS_ATOL itself.
HUB_RANKS = 2
HUB_SWAP_TICK = 280  # 56 s into the 60 s track: after the last planted keyword
RANKS_ATOL = 1e-6
BF16_KERNEL_ROWS = (1e-4, 2e-3, 0.1)  # (largest median row gap, tail gap, largest share of rows past it)
BF16_FORWARD_ROWS = (1e-3, 2e-3, 0.3)  # make_forward: the MFCC's own rounding feeds the bf16 stem
BF16_NEARER = 10.0
BF16_OUTER = 0.05  # no logit further; a row whose top two are closer may take either label
BF16_DEPTH = 2  # one plain layer and one residual layer
BF16_FULL_ROWS = 256
BF16_BATCHES = (1, 3, 8, 256, 2996)  # a /listen, a few, a hub tick, an eval batch, a 10 min track's windows
BF16_FLOW_BATCHES = (1, 8, 256, 2996)
# Phase 34: the models cli.zoo builds at zoo_hard_v2's recipe (res15 over res8 is
# the JAX zoo's closest resolved ordering, runs/seed_variance_r04.json).
RECIPE_MODELS = ("res8", "res15")
# The bf16-activation mode's row gates (median row gap, tail gap, largest share
# of rows past it), on the whole stack from BF16_FULL_ROWS rows and on its first
# BF16_DEPTH layers at every shape. Every layer rounds its output to bf16, so a
# flipped rounding carries on through the layers: on the whole stack nearly
# every row has one, and the median row moves by 1.2e-4-2.0e-4 (on an NVIDIA
# H100 80GB HBM3 at 700 W: res8 B=256 and 2,996, res26 and res26-narrow at
# B = 1 and 3; PERF.md §6), where the f32 mean and Dense keep each flip to
# ~1e-4; its faults read 3.9e-3 (float32 activations) to 7.7e-3 (the Pallas
# flow) on res8 from B=256, and as little as 3.7e-4 on res26 at B=1, so the
# whole stack is gated from B=256 only. On two layers the kernel's median is
# at most 4.4e-6 and the faults' at least 4.8e-5 (float32 activations on
# res26-narrow): each limit sits between the two.
BF16_FLOW_ROWS = (5e-4, 2e-3, 0.1)
BF16_FLOW_LAYER_ROWS = (2e-5, 2e-3, 0.1)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def max_err(got, ref) -> float:
    return float((got - ref).abs().max())


def close(got, ref, atol, rtol) -> bool:
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def peaks(name: str) -> tuple[float, float, float, float]:
    """(f32 FLOP/s outside the tensor cores, dense TF32 and dense bf16
    tensor-core FLOP/s, HBM bytes/s): NVIDIA's SXM data sheets."""
    if "H200" in name:
        return 67e12, 495e12, 989e12, 4.8e12
    return 67e12, 495e12, 989e12, 3.35e12  # H100 SXM


def bound(flops: float, nbytes: float, name: str, tf32x3: bool = False, bf16: bool = False) -> tuple[float, str]:
    """Least time in ms: operations over the peak of the arithmetic the kernel
    uses (3xTF32: three tensor-core products per product; bf16: one) or bytes
    over HBM."""
    f32, tf32, bf, b = peaks(name)
    t_ops = (3 * flops / tf32 if tf32x3 else flops / bf if bf16 else flops / f32) * 1e3
    t_bytes = nbytes / b * 1e3
    if t_ops < t_bytes:
        return t_bytes, "bytes"
    return t_ops, "operations (3xTF32)" if tf32x3 else "operations (bf16)" if bf16 else "operations"


def time_ms(torch, fn, iters: int) -> float:
    """Device time per call: CUDA events around `iters` calls queued behind a spin
    kernel, so the host's enqueue time is hidden and the calls run back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * 400_000)  # ~200 us of spinning per queued call at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel entry of an nvcc -Xptxas -v log: registers and spills."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            kernel = re.match(r"_Z\d+(\w+?)(?:I|P|$)", name)
            nt = re.search(r"Li(\d+)EE", name)
            op = re.search(r"I\d+(Tf32x3|Bf16)", name)
            entry = (kernel.group(1) if kernel else name) + (
                f"<{op.group(1) + ', ' if op else ''}NT={nt.group(1)}>" if nt else f"<{op.group(1)}>" if op else "")
        elif "spill stores" in line:
            spill = line.strip()
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{entry}: {regs.group(1) if regs else '?'} registers, {spill}")
            entry = None
    return out


def post_json(url: str, obj) -> dict:
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def assemble_work(ops, n_samples: int = 16000) -> tuple[float, float]:
    """(operations, bytes) one assembly needs on these operands.

    Bytes: the corpus samples and noise samples it must read, each once (the
    union of the windows that count: rows with gain 0 add nothing of the
    corpus, rows with nscale 0 nothing of the noise; noise windows overlap),
    the output written once, and 24 B of operands per row. Operations: two
    products, a sum and a clamp per output sample.
    """
    clip_start, noise_start, gain, nscale = (t.cpu().numpy() for t in ops)

    def covered(starts):  # samples in the union of the windows [s, s + n_samples)
        if starts.size == 0:
            return 0
        s = np.sort(starts)
        return int(n_samples + np.minimum(np.diff(s), n_samples).sum())

    b = clip_start.shape[0]
    nbytes = 2 * covered(clip_start[gain != 0]) + 4 * covered(noise_start[nscale != 0]) + 4 * b * n_samples + 24 * b
    return 4.0 * b * n_samples, float(nbytes)


def phase_assemble(torch, dev, A, K):
    """8. The assembly kernel against its plain version, both layouts, B=64 and 1024."""
    rng = np.random.default_rng(SEED + 8)
    n = 2000
    raw = rng.integers(-32768, 32768, (n, 16000), dtype=np.int16)  # the full range: the clamp bites
    labels = rng.integers(2, 12, n, dtype=np.int32)
    noise = (rng.standard_normal(16000 * 60) * 0.3).astype(np.float32)
    cfg = A.AugmentConfig(n_silence=n // 10)
    errs, exact = {}, None
    for layout in ("exact", "subrow"):
        arrays = A.prepare_train_arrays(raw, labels, noise, cfg, layout=layout, device=dev)
        exact = exact or arrays
        for b in (64, 1024):
            draws = A.draw_batch(A.step_generator(SEED, b, dev), arrays, b, cfg)
            *ops, _ = A.kernel_operands(draws, arrays, cfg)
            got = K.assemble(arrays.pool, arrays.noise, *ops)
            ref = K.assemble_plain(arrays.pool, arrays.noise, *ops)
            torch.cuda.synchronize()
            silence = draws.idx >= n
            if got.shape != (b, 16000) or not torch.isfinite(got).all() or float(got.abs().max()) > 1.0:
                fail(f"assemble kernel, {layout} B={b}: shape {tuple(got.shape)}, non-finite or outside [-1, 1]")
            if not bool(silence.any()):
                fail(f"assemble kernel, {layout} B={b}: the draws hold no silence row")
            err = max_err(got, ref)
            if err > ASSEMBLE_ATOL:
                fail(f"assemble kernel disagrees with its plain version, {layout} B={b}: max abs err {err:.3e}")
            errs[f"{layout}_b{b}"] = (err, bool(torch.equal(got, ref)), int(silence.sum()))
    print("[assemble] " + "; ".join(f"{k}: max abs err {e:.3e}, bitwise equal {eq}, {ns} silence rows"
                                    for k, (e, eq, ns) in errs.items()) + f" (atol {ASSEMBLE_ATOL})")
    return max(e for e, _, _ in errs.values()), exact, cfg


def train_step_inputs(A):
    """Phases 9, 15 and 33's corpus: 256 clips of seeded noise, labels, background noise, the augmentation."""
    rng = np.random.default_rng(SEED + 9)
    n = 256
    raw = (rng.standard_normal((n, 16000)) * 3000).clip(-32768, 32767).astype(np.int16)
    labels = rng.integers(0, 12, n, dtype=np.int32)
    noise = (rng.standard_normal(16000 * 8) * 0.1).astype(np.float32)
    return raw, labels, noise, A.AugmentConfig(n_silence=n // 10)


def phase_train_steps(torch, dev, A, conf: str = "res8", batch: int = TRAIN_BATCH):
    """9 and 15. Three float32 train steps on cuda and on the CPU: same weights, same draws, same dropout masks."""
    from honk_tpu_torch.models import find_config, find_model, init_weights
    from honk_tpu_torch.train import create_train_state, make_optimizer
    from honk_tpu_torch.train.steps import make_train_step

    raw, labels, noise, cfg = train_step_inputs(A)
    sides = {}
    for side, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = init_weights(find_model(conf)(find_config(conf)), torch.Generator().manual_seed(SEED)).to(d)
        tx = make_optimizer(lrs=(0.01, 0.001), boundaries=(2,))  # the ladder switches at update 2
        sides[side] = (create_train_state(model, tx), make_train_step(tx, batch, cfg),
                       A.prepare_train_arrays(raw, labels, noise, cfg, device=d))
    losses = {k: [] for k in sides}
    for step in range(3):
        # The draws, then the dropout masks, from one CPU generator (the two
        # devices' generators differ), as a train step draws them from its own.
        gen = A.step_generator(SEED + 1, step, "cpu")
        draws = A.draw_batch(gen, sides["cpu"][2], batch, cfg)
        cpu_model = sides["cpu"][0].model
        masks = cpu_model.keep_masks(batch, gen) if hasattr(cpu_model, "keep_masks") else None
        for k, (state, train_step, arrays) in sides.items():
            d = arrays.pool.device
            moved = A.Draws(*(t.to(d) for t in draws))
            dropout = None if masks is None else [m.to(d) for m in masks]
            _, m = train_step.apply_batch(state, *A.assemble_batch(moved, arrays, cfg), dropout=dropout)
            losses[k].append(float(m["loss"]))
    loss_err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    if not all(math.isfinite(v) for v in losses["cuda"]) or loss_err > TRAIN_LOSS_ATOL:
        fail(f"{conf} train steps cuda vs cpu: losses {losses}")
    gpu_sd, cpu_sd = (sides[k][0].model.state_dict() for k in ("cuda", "cpu"))
    param_err, gate_share = 0.0, 0.0
    for name, ref in cpu_sd.items():
        got, ref = gpu_sd[name].cpu().float(), ref.float()
        param_err = max(param_err, max_err(got, ref))
        # The largest |got - ref| as a share of its element's own limit, atol + rtol * |ref|.
        limit = TRAIN_PARAM_TOL["atol"] + TRAIN_PARAM_TOL["rtol"] * ref.abs()
        gate_share = max(gate_share, float(((got - ref).abs() / limit).max()))
        if not close(got, ref, **TRAIN_PARAM_TOL):
            fail(f"{conf} train steps cuda vs cpu: {name} max abs err {max_err(got, ref):.3e}")
    print(f"[train_steps] {conf} B={batch} f32, 3 steps{', dropout masks made on the CPU' if masks else ''}: "
          f"losses cuda {losses['cuda']} cpu {losses['cpu']}; "
          f"loss max abs err {loss_err:.3e} (atol {TRAIN_LOSS_ATOL}); weights and BN stats max abs err "
          f"{param_err:.3e} (atol {TRAIN_PARAM_TOL['atol']}, rtol {TRAIN_PARAM_TOL['rtol']}), "
          f"at most {gate_share:.2f} of an element's limit")
    return {"loss_max_abs_err": loss_err, "param_max_abs_err": param_err, "param_gate_share": gate_share}


@contextlib.contextmanager
def layer_dtypes(model):
    """The dtype of each layer's output in a res model's forwards inside, by layer ("pool": the stem's pool)."""
    from honk_tpu_torch.models import res

    names = {id(m): n for n, m in model.named_modules()}
    seen: dict[str, str] = {}
    conv, pool, bn = res.conv, res.avg_pool, res.batch_norm_train

    def rec(name, y):
        seen[name] = str(y.dtype).replace("torch.", "")
        return y

    hook = model.output.register_forward_hook(lambda m, i, o: rec("output", o))
    res.conv = lambda layer, x, dtype: rec(names[id(layer)], conv(layer, x, dtype))
    res.avg_pool = lambda x, window: rec("pool", pool(x, window))
    res.batch_norm_train = lambda x, module, mesh=None: rec(names[id(module)], bn(x, module, mesh))
    try:
        yield seen
    finally:
        res.conv, res.avg_pool, res.batch_norm_train = conv, pool, bn
        hook.remove()


def phase_bf16_train(torch, dev, A, step_times, smi) -> dict:
    """33. The bf16 train step on the card: phase 9's three steps of res8 at full width, B=64, in bf16
    on cuda and on the CPU (and float32 on cuda), the same initial weights and draws (made on the CPU).

    Every layer's output dtype is flax's and equal on both devices; the bf16
    pool (chained bf16 adds, a bf16 division) is bitwise equal on both, forward
    and backward; the weights' cuda-CPU distance is at most BF16_TRAIN_RATIO of
    their cuda bf16-float32 distance over all tensors, and at most
    BF16_TRAIN_TENSOR_RATIO a tensor. The step's host and device ms and
    kernel count are phase 11's, bf16 beside float32."""
    import torch.nn.functional as F

    from honk_tpu_torch.frontend import compute_mfccs
    from honk_tpu_torch.models import find_config, find_model, init_weights
    from honk_tpu_torch.models.layers import avg_pool, conv
    from honk_tpu_torch.train import create_train_state, make_optimizer
    from honk_tpu_torch.train.steps import make_train_step

    t0 = time.perf_counter()
    raw, labels, noise, cfg = train_step_inputs(A)
    cpu = torch.device("cpu")
    runs = {("cuda", "bfloat16"): (dev, torch.bfloat16), ("cpu", "bfloat16"): (cpu, torch.bfloat16),
            ("cuda", "float32"): (dev, torch.float32)}
    cpu_arrays = A.prepare_train_arrays(raw, labels, noise, cfg)
    states, losses, dtypes, first_audio = {}, {}, {}, None
    for key, (d, dtype) in runs.items():
        model = init_weights(find_model("res8")(find_config("res8"), dtype=dtype),
                             torch.Generator().manual_seed(SEED)).to(d)
        tx = make_optimizer(lrs=(0.01, 0.001), boundaries=(2,))
        state, train_step = create_train_state(model, tx), make_train_step(tx, TRAIN_BATCH, cfg)
        arrays = A.prepare_train_arrays(raw, labels, noise, cfg, device=d)
        losses[key], states[key] = [], []
        for step in range(3):
            gen = A.step_generator(SEED + 1, step, "cpu")
            draws = A.Draws(*(t.to(d) for t in A.draw_batch(gen, cpu_arrays, TRAIN_BATCH, cfg)))
            audio, lab = A.assemble_batch(draws, arrays, cfg)
            if step == 0 and key == ("cuda", "bfloat16"):
                first_audio = audio
            with layer_dtypes(model) as seen:
                _, m = train_step.apply_batch(state, audio, lab)
            if step == 0:
                dtypes[key] = dict(seen)
            losses[key].append(float(m["loss"]))
            states[key].append({k: v.detach().cpu().double() for k, v in model.state_dict().items()
                                if v.is_floating_point()})
    if not all(math.isfinite(v) for v in sum(losses.values(), [])):
        fail(f"bf16 train steps: losses {losses}")
    want = {n: "bfloat16" for n in dtypes[("cuda", "float32")]} | {"output": "float32"}
    if not dtypes[("cuda", "bfloat16")] == dtypes[("cpu", "bfloat16")] == want:
        fail(f"bf16 train step: layer output dtypes cuda {dtypes[('cuda', 'bfloat16')]}, "
             f"cpu {dtypes[('cpu', 'bfloat16')]}, flax's {want}")

    def share(step):
        """Each tensor's, and all tensors' ("all"), distance of the CPU bf16 run from the cuda one as a
        share of the cuda bf16 run's distance from the cuda float32 run, after ``step`` + 1 steps."""
        c16, o, c32 = (states[k][step] for k in (("cuda", "bfloat16"), ("cpu", "bfloat16"), ("cuda", "float32")))
        per = {k: float((c16[k] - o[k]).norm() / (c16[k] - c32[k]).norm()) for k in c16}
        num = math.sqrt(sum(float((c16[k] - o[k]).norm()) ** 2 for k in c16))
        per["all"] = num / math.sqrt(sum(float((c16[k] - c32[k]).norm()) ** 2 for k in c16))
        return per

    shares = [share(s) for s in range(3)]
    by_step = [[s["all"], *max((v, k) for k, v in s.items() if k != "all")[::-1]] for s in shares]
    ratios = shares[2]
    worst = max((k for k in ratios if k != "all"), key=ratios.get)
    if not (ratios["all"] <= BF16_TRAIN_RATIO and ratios[worst] <= BF16_TRAIN_TENSOR_RATIO):
        fail(f"bf16 train steps cuda vs cpu: {ratios['all']:.3f} of the bf16-float32 distance over all tensors "
             f"(limit {BF16_TRAIN_RATIO}), {worst} {ratios[worst]:.3f} (limit {BF16_TRAIN_TENSOR_RATIO}); "
             f"by tensor {ratios}")

    # The pool alone, on conv0's bf16 ReLU output of the first batch, with a seeded cotangent.
    model = init_weights(find_model("res8")(find_config("res8"), dtype=torch.bfloat16),
                         torch.Generator().manual_seed(SEED)).to(dev)
    with torch.no_grad():
        y = F.relu(conv(model.conv0, compute_mfccs(first_audio)[:, None], torch.bfloat16))
    ct_shape = (y.shape[0], y.shape[1], y.shape[2] // model.pool[0], y.shape[3] // model.pool[1])
    ct = torch.from_numpy(np.random.default_rng(SEED + 33).standard_normal(ct_shape).astype(np.float32))
    pooled = {}
    for side, d in (("cuda", dev), ("cpu", cpu)):
        x = y.detach().to(d).requires_grad_(True)
        out = avg_pool(x, model.pool)
        out.backward(ct.to(d, torch.bfloat16))
        pooled[side] = (out.detach().cpu(), x.grad.cpu())
    (fwd_g, bwd_g), (fwd_c, bwd_c) = pooled["cuda"], pooled["cpu"]
    if not (fwd_g.dtype == bwd_g.dtype == torch.bfloat16 and torch.equal(fwd_g, fwd_c) and torch.equal(bwd_g, bwd_c)):
        fail(f"bf16 pool cuda vs cpu: forward {int((fwd_g != fwd_c).sum())} and backward "
             f"{int((bwd_g != bwd_c).sum())} elements differ ({fwd_g.dtype}, {bwd_g.dtype})")

    clocks = {dt: {k: step_times[dt].get(k) for k in ("step_wall", "device_ms", "device_kernels_per_step",
                                                        "device_idle_share")} for dt in ("float32", "bfloat16")}
    out = {"losses": {f"{s}_{dt}": v for (s, dt), v in losses.items()}, "layer_dtypes": dtypes[("cuda", "bfloat16")],
           "ratios": ratios, "by_step": by_step, "pool_shape": list(y.shape),
           "pool_bitwise": True, "step_b64": clocks, "card": smi, "s": time.perf_counter() - t0}
    print(f"[bf16_train] res8 B={TRAIN_BATCH}, 3 bf16 steps on cuda and cpu: layer dtypes equal and flax's "
          f"({len(want)} layers); pool {list(y.shape)} bitwise equal, forward and backward; cuda-cpu distance "
          f"as a share of bf16-float32 after steps 1-3 [all, worst tensor, its share]: {json.dumps(by_step)} "
          f"(limits {BF16_TRAIN_RATIO} all, {BF16_TRAIN_TENSOR_RATIO} a tensor); step (phase 11) "
          f"float32 {json.dumps(clocks['float32'])} bf16 {json.dumps(clocks['bfloat16'])}; {smi}; "
          f"{out['s']:.1f} s")
    return out


def run_cli(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def final_accuracy(out: str) -> float:
    lines = [ln for ln in out.splitlines() if ln.startswith("final test accuracy:")]
    if len(lines) != 1:
        fail(f"expected one 'final test accuracy:' line, got {lines}")
    return float(lines[0].split(":", 1)[1])


def uses_res_stack(conf: str) -> bool:
    """Whether a config's eval forward runs the res-stack kernel (res8, res26 and their -narrow forms)."""
    from honk_tpu_torch.models import find_config

    return conf.startswith("res") and not find_config(conf).get("use_dilation")


def phase_entry_point(torch, root, tmp, counters, conf="res8", n_epochs=2, flags=()):
    """10 and 15. honk_tpu_torch.cli.train: train on cuda with exact launch counts, then eval cuda vs cpu."""
    from honk_tpu_torch.cli.train import main as cli_main
    from honk_tpu_torch.data import load_speech_commands

    ds = load_speech_commands(root)  # the CLI's defaults: the same splits it will train on
    eval_b = 256
    n_train = len(ds.train)
    steps = n_epochs * math.ceil((n_train + int(0.1 * n_train)) / TRAIN_BATCH)
    evals = n_epochs * math.ceil(len(ds.dev) / eval_b) + math.ceil(len(ds.test) / eval_b)
    expect = {"assemble": steps, "mfcc": steps + evals, "res_stack": evals if uses_res_stack(conf) else 0}
    out_dir, metrics = os.path.join(tmp, f"run-{conf}"), os.path.join(tmp, f"metrics-{conf}.jsonl")
    argv = ["--type", "train", "--model", conf, "--batch_size", str(TRAIN_BATCH), "--n_epochs", str(n_epochs),
            "--dev_every", "1", "--data_dir", root, "--output_dir", out_dir, "--metrics_jsonl", metrics, *flags]
    reset(counters)
    t0 = time.perf_counter()
    rc, out = run_cli(cli_main, argv)
    train_s = time.perf_counter() - t0
    launches = read(counters, bf16=True)
    by_mode = launches.by_mode
    if rc != 0:
        fail(f"cli.train --type train returned {rc}")
    if launches != expect:
        fail(f"cli.train launched {launches}, expected {expect} "
             f"({steps} train steps, {evals} eval batches)")
    # The run's model is bf16 (the CLI's default --compute_dtype), so are its dev and test sweeps.
    if by_mode != bf16_eval_modes(expect["res_stack"]):
        fail(f"cli.train's sweeps launched the res stack's modes {by_mode}: expected the bf16-activation mode only")
    train_acc = final_accuracy(out)
    best = os.path.join(out_dir, "best.pt")
    if not os.path.isfile(best):
        fail("cli.train wrote no best.pt")
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if r["kind"] == "train_epoch"]
    if len(epochs) != n_epochs or not all(math.isfinite(r["loss"]) for r in epochs):
        fail(f"cli.train epoch records: {epochs}")
    accs = {}
    for d in ("cuda", "cpu"):
        rc, out = run_cli(cli_main, ["--type", "eval", "--model", conf, "--data_dir", root,
                                     "--input_file", best, "--device", d])
        if rc != 0:
            fail(f"cli.train --type eval --device {d} returned {rc}")
        accs[d] = final_accuracy(out)
    if accs["cuda"] != accs["cpu"]:
        fail(f"--type eval of best.pt: cuda {accs['cuda']} != cpu {accs['cpu']}")
    print(f"[train_cli] {conf} bf16 B={TRAIN_BATCH} {' '.join(flags)}, {n_epochs} epochs on {n_train} clips "
          f"(dev {len(ds.dev)}, test {len(ds.test)}): {train_s:.1f} s; launches {launches} (exact), "
          f"res stack by mode {by_mode}; "
          f"epochs " + "; ".join(f"loss {r['loss']:.4f} acc {r['acc']:.4f} audio_s_per_s {r['audio_s_per_s']}"
                                 for r in epochs)
          + f"; final test accuracy {train_acc}; --type eval of best.pt cuda {accs['cuda']} = cpu {accs['cpu']}")
    return launches, epochs, train_acc, by_mode


def phase_step_times(torch, dev, A, K, mfcc_kernel, arrays, cfg):
    """11. The assembly kernel, plain, at B=64 and 1024; the MFCC at B=64; one train step split."""
    from honk_tpu_torch.models import SpeechResModel, find_config, init_weights
    from honk_tpu_torch.train import create_train_state, make_optimizer
    from honk_tpu_torch.train.steps import make_train_step

    times, work = {}, {}
    for b in (64, 1024):
        draws = A.draw_batch(A.step_generator(SEED + 11, b, dev), arrays, b, cfg)
        *ops, _ = A.kernel_operands(draws, arrays, cfg)
        iters = 200 if b == 64 else 50
        times[f"assemble_b{b}"] = time_ms(torch, lambda: K.assemble(arrays.pool, arrays.noise, *ops), iters)
        times[f"assemble_plain_b{b}"] = time_ms(torch, lambda: K.assemble_plain(arrays.pool, arrays.noise, *ops), iters)
        work[b] = assemble_work(ops)
    gen = A.step_generator(SEED + 11, 0, dev)
    audio, labels = A.sample_train_batch(gen, arrays, TRAIN_BATCH, cfg)
    times["mfcc_b64"] = time_ms(torch, lambda: mfcc_kernel.mfcc(audio), 100)
    times["mfcc_plain_b64"] = time_ms(torch, lambda: mfcc_kernel.mfcc_plain(audio), 100)
    feats = mfcc_kernel.mfcc(audio)
    steps = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = init_weights(SpeechResModel(find_config("res8"), dtype=dtype), torch.Generator().manual_seed(SEED))
        tx = make_optimizer(lrs=(0.01,), boundaries=())
        state = create_train_state(model.to(dev), tx)
        step = make_train_step(tx, TRAIN_BATCH, cfg)
        parts = {
            "assembly": time_ms(torch, lambda: A.sample_train_batch(gen, arrays, TRAIN_BATCH, cfg), 50),
            "mfcc": times["mfcc_b64"],
            "fwd_bwd_update": time_ms(torch, lambda: step.apply_features(state, feats, labels), 50),
            "step": time_ms(torch, lambda: step(state, SEED, arrays), 50),
        }
        parts.update(step_clocks(torch, lambda: step(state, SEED, arrays)))
        steps[dtype_name] = parts
    print("[step_times] ms per call (CUDA events behind a spin kernel; step_wall: host clock over 50 steps; "
          "device_ms and top_kernels_ms: torch.profiler over 10 steps): "
          + json.dumps({"kernels": times, "train_step_b64": steps}))
    return times, steps, work


def step_clocks(torch, step_fn, n_wall: int = 50, n_profile: int = 10) -> dict:
    """A step's host ms over ``n_wall`` calls (synchronised at the ends), then
    torch.profiler's device view of ``n_profile`` more."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_wall):
        step_fn()
    torch.cuda.synchronize()
    return {"step_wall": (time.perf_counter() - t0) * 1e3 / n_wall, **profile_steps(torch, step_fn, n_profile)}


def listen(svc, cpu, requests, counters, serve) -> tuple[list[float], dict]:
    """POST each PCM16 request to /listen on a server of ``svc``; every answer must
    equal the CPU service's. Returns the host seconds per request and the
    kernel launches over the requests (counts set to 0 just before)."""
    reset(counters)
    httpd = serve(svc, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/labels", timeout=60) as r:
            if json.loads(r.read())["labels"] != svc.labels:
                fail("GET /labels: wrong labels")
        answers, listen_s = [], []
        for pcm in requests:
            t0 = time.perf_counter()
            answers.append(post_json(f"{base}/listen", {"wav_data": base64.b64encode(pcm.tobytes()).decode()}))
            listen_s.append(time.perf_counter() - t0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    launches = read(counters)
    if th.is_alive():
        fail("HTTP server thread did not stop")
    for pcm, ans in zip(requests, answers):
        label, prob = cpu.evaluate(pcm.astype(np.float32) / 32768.0)
        if ans["label"] != label or abs(ans["prob"] - prob) > PROB_ATOL:
            fail(f"/listen answered {ans}, the CPU service ({label}, {prob})")
        if ans["contains_command"] != (label not in ("__silence__", "__unknown__")):
            fail(f"/listen contains_command wrong: {ans}")
    return listen_s, launches


def phase_family_eval(torch, LabelService, counters, utts) -> tuple[dict, dict]:
    """12. LabelService on cuda against the CPU, B=256, for the configs outside the res-stack kernel."""
    services, errs = {}, {}
    for conf in FAMILY:
        path = os.path.join(HARD_V2, f"{conf}.pt")
        gpu, cpu = LabelService(conf, path), LabelService(conf, path, device="cpu")
        reset(counters)
        got = gpu.logits(utts).cpu()
        launches = read(counters)
        if launches != {"assemble": 0, "mfcc": 1, "res_stack": 0}:
            fail(f"{conf} eval forward at B={len(utts)} launched {launches}: expected one mfcc, nothing else")
        ref = cpu.logits(utts)
        if got.shape != (len(utts), 12) or not torch.isfinite(got).all():
            fail(f"{conf} eval forward on cuda: shape {tuple(got.shape)} or non-finite values")
        errs[conf] = max_err(got, ref)
        if errs[conf] > LOGIT_ATOL:
            fail(f"{conf} LabelService cuda vs cpu: logits max abs err {errs[conf]:.3e} > {LOGIT_ATOL}")
        if not torch.equal(got.argmax(-1), ref.argmax(-1)):
            fail(f"{conf} LabelService cuda vs cpu: labels differ")
        services[conf] = (gpu, cpu)
    print(f"[family_eval] LabelService B={len(utts)} cuda vs cpu, labels equal, one mfcc launch and no res_stack "
          "launch per batch; logits max abs err " + ", ".join(f"{c} {e:.3e}" for c, e in errs.items())
          + f" (atol {LOGIT_ATOL})")
    return services, errs


def hard_v2_manifest() -> dict:
    with open(os.path.join(HARD_V2, "MANIFEST.json")) as f:
        return json.load(f)


def hard_v2_corpus(root: str) -> float:
    """Regenerate the hard_v2 corpus into ``root`` from zoo_hard_v2/MANIFEST.json's
    corpus_recipe; returns the seconds it took."""
    from honk_tpu_torch.data import generate_hard_dataset

    recipe = {k: tuple(v) if isinstance(v, list) else v
              for k, v in hard_v2_manifest()["corpus_recipe"].items() if k != "generator"}
    t0 = time.perf_counter()
    generate_hard_dataset(root, **recipe)
    return time.perf_counter() - t0


def phase_hard_v2(torch, dev, counters, tmp) -> dict:
    """14. The committed zoo_hard_v2 models on the card, clip by clip against their committed vectors."""
    from honk_tpu_torch.data import load_speech_commands
    from honk_tpu_torch.frontend import compute_mfccs
    from honk_tpu_torch.models import find_config, find_model, load_honk_checkpoint

    manifest = hard_v2_manifest()
    root = os.path.join(tmp, "hard_v2")
    gen_s = hard_v2_corpus(root)
    t0 = time.perf_counter()
    ds = load_speech_commands(root, dev_pct=10, test_pct=80)
    load_s = time.perf_counter() - t0
    sizes = {"train": len(ds.train), "dev": len(ds.dev), "test": len(ds.test)}
    if sizes != manifest["split_sizes"]:
        fail(f"hard_v2 split sizes {sizes} != the MANIFEST's {manifest['split_sizes']}")
    audio = torch.from_numpy(ds.test.audio).to(dev)
    labels = np.asarray(ds.test.labels)
    n = len(labels)
    n_batches = math.ceil(n / BATCH)
    results = {}
    for name, entry in manifest["models"].items():
        cfg = find_config(name)
        cfg["n_labels"] = ds.n_labels
        model = load_honk_checkpoint(os.path.join(HARD_V2, entry["pt"]), find_model(name)(cfg)).to(dev).eval()
        reset(counters)
        t0 = time.perf_counter()
        with torch.inference_mode():
            packed = model.eval_operands()
            logits = torch.cat([model(compute_mfccs(audio[s:s + BATCH].float() / 32768.0), packed=packed)
                                for s in range(0, n, BATCH)]).cpu()
        eval_s = time.perf_counter() - t0
        launches = read(counters)
        expect = {"assemble": 0, "mfcc": n_batches, "res_stack": n_batches if uses_res_stack(name) else 0}
        if launches != expect:
            fail(f"hard_v2 {name}: launched {launches}, expected {expect}")
        if not torch.isfinite(logits).all():
            fail(f"hard_v2 {name}: non-finite logits")
        correct = logits.argmax(-1).numpy() == labels
        want = np.load(os.path.join(HARD_V2, f"{name}_test_correct.npy"))
        differ = np.flatnonzero(correct != want)
        top2 = logits.topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).numpy()
        acc = float(correct.mean())
        results[name] = {
            "acc": acc, "test_acc_recheck": entry["test_acc_recheck"], "clips_differ": int(differ.size),
            "min_top2_margin_of_differing": float(margins[differ].min()) if differ.size else None,
            "eval_s": eval_s, "launches": launches,
        }
        if want.shape != (n,) or n - differ.size < HARD_V2_MIN_AGREE:
            fail(f"hard_v2 {name}: {differ.size} of {n} clips differ from {name}_test_correct.npy")
        if abs(acc - entry["test_acc_recheck"]) > HARD_V2_ACC_ATOL:
            fail(f"hard_v2 {name}: accuracy {acc} against test_acc_recheck {entry['test_acc_recheck']}")
    print(f"[hard_v2] corpus generated in {gen_s:.1f} s, loaded in {load_s:.1f} s, splits {sizes} (the MANIFEST's); "
          f"B={BATCH}, {n_batches} batches a model: "
          + "; ".join(f"{k} acc {r['acc']:.4f} (recheck {r['test_acc_recheck']}), {r['clips_differ']} clips differ"
                      + (f" (smallest top-2 margin {r['min_top2_margin_of_differing']:.3e})"
                         if r["clips_differ"] else "")
                      + f", {r['eval_s']:.2f} s, launches {r['launches']}"
                      for k, r in results.items()))
    return {"generate_s": gen_s, "load_s": load_s, "models": results}


def phase_family_times(torch, dev, A, arrays, cfg) -> dict:
    """16. res15 and cnn-trad-pool2: the eval forward at B=1 and 256, and a train step at B=64."""
    from honk_tpu_torch.frontend import compute_mfccs
    from honk_tpu_torch.models import find_config, find_model, init_weights, load_honk_checkpoint
    from honk_tpu_torch.train import create_train_state, make_optimizer
    from honk_tpu_torch.train.steps import make_train_step

    rng = np.random.default_rng(SEED + 16)
    audio = torch.from_numpy((rng.standard_normal((BATCH, 16000)) * 0.2).astype(np.float32)).to(dev)
    out = {}
    for conf in ("res15", "cnn-trad-pool2"):
        model = load_honk_checkpoint(os.path.join(HARD_V2, f"{conf}.pt"), find_model(conf)(find_config(conf)))
        model = model.to(dev).eval()
        packed = model.eval_operands()
        r = {}
        with torch.inference_mode():
            for b, iters in ((1, 100), (BATCH, 10)):
                a = audio[:b].contiguous()
                r[f"eval_forward_b{b}_ms"] = time_ms(torch, lambda: model(compute_mfccs(a), packed=packed), iters)
            # One utterance as /listen sends it: the host clock of a synchronised
            # forward, and the profiler's device view of the same calls.
            a1 = audio[:1].contiguous()
            r["eval_forward_b1_host"] = step_clocks(torch, lambda: model(compute_mfccs(a1), packed=packed), 20, 20)
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            m = init_weights(find_model(conf)(find_config(conf), dtype=dtype), torch.Generator().manual_seed(SEED))
            tx = make_optimizer(lrs=(0.01,), boundaries=())
            state = create_train_state(m.to(dev), tx)
            step = make_train_step(tx, TRAIN_BATCH, cfg)
            step(state, SEED, arrays)  # warm up cuDNN's choices for these shapes
            r[f"train_step_b{TRAIN_BATCH}_{dtype_name}"] = step_clocks(torch, lambda: step(state, SEED, arrays))
        out[conf] = r
    print("[family_times] eval_forward: MFCC + model, ms per call (CUDA events behind a spin kernel); "
          "train step: step_wall host clock over 50 steps, device_ms and top_kernels_ms torch.profiler over 10: "
          + json.dumps(out))
    return out


def profile_steps(torch, fn, n: int, required: bool = True) -> dict:
    """Device time per call from torch.profiler's kernel records, and the busiest kernels.

    With ``required=False`` a window with no device record gives ``device_ms``
    None ("not measured") instead of failing: the hub's kernels are launched
    from the HTTP server's threads, not the profiling one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    # Device records, less the annotations that span them (torch.optim's
    # "Optimizer.step#SGD.step" shows on the device timeline too).
    records = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels = {}
    for e in records:
        kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3 / n
    device = sum(kernels.values())
    if device <= 0:
        if not required:
            return {"profiled_wall_ms": wall, "device_ms": None, "device_idle_share": None,
                    "device_kernels_per_step": 0, "top_kernels_ms": []}
        fail("torch.profiler recorded no device time for the profiled calls")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_ms": wall, "device_ms": device, "device_idle_share": max(0.0, 1 - device / wall),
            "device_kernels_per_step": len(records) / n,
            "top_kernels_ms": [[name[:60], ms] for name, ms in top]}


def mfcc_work(n_frames: int, n_samples: int) -> tuple[float, float]:
    """(operations, bytes) the MFCC function needs for ``n_frames`` frames of
    ``n_samples`` input samples, whatever the kernel does: per frame the Hann
    window, a real FFT of 480 points (2.5 N log2 N), |X|^2 of 241 bins, the mel
    filters' nonzero taps, 40 logs and the 40x40 DCT. Bytes: audio in, MFCCs
    out, the window, the mel taps and the DCT."""
    from honk_tpu_torch.frontend import filters

    mel_taps = int(np.count_nonzero(filters.frontend_constants(np.float32)["mel"]))
    per_frame = 480 + 2.5 * 480 * math.log2(480) + 3 * 241 + 2 * mel_taps + 40 + 2 * 40 * 40
    nbytes = 4 * (n_samples + n_frames * 40 + 480 + mel_taps + 40 * 40)
    return n_frames * per_frame, nbytes


def weight_bytes(mode: str) -> tuple[int, int]:
    """Bytes a value of the conv weights and of the Dense weights that the res
    stack's ``mode`` needs: bf16 conv weights in both bf16 modes and a bf16
    Dense in the ``bfloat16`` mode, float32 everywhere else."""
    return (4 if mode == "float32" else 2), (2 if mode == "bfloat16" else 4)


def res_work(b: int, C: int, H: int, W: int, L: int, n_lab: int, mode: str = "float32") -> tuple[float, float]:
    """(operations, bytes) of the res stack at batch ``b`` in ``mode``: the
    convs' products, the dense layer; the pooled input, the weights (at
    weight_bytes) and the logits."""
    conv_b, dense_b = weight_bytes(mode)
    flops = 2 * b * L * H * W * 9 * C * C + 2 * b * C * n_lab
    nbytes = 4 * (b * C * H * W + 2 * L * C + n_lab + b * n_lab) + conv_b * L * 9 * C * C + dense_b * C * n_lab
    return flops, nbytes


def reset(counters) -> None:
    """Every launch count to 0, the res stack's per-mode and per-entry counts too."""
    for mod in counters.values():
        mod.launches = 0
        for by in (getattr(mod, "launches_by_mode", {}), getattr(mod, "launches_by_entry", {})):
            for key in by:
                by[key] = 0


class Launches(dict):
    """Each kernel's launches since ``reset``; ``by_mode`` the res stack's by
    operand mode and ``by_entry`` by entry (``res_forward``: from the features
    with the stem inside; ``res_stack``: from the pooled map), read at the same time."""

    def __init__(self, counters):
        super().__init__({k: mod.launches for k, mod in counters.items()})
        self.by_mode = dict(counters["res_stack"].launches_by_mode)
        self.by_entry = dict(counters["res_stack"].launches_by_entry)


def read(counters, bf16: bool = False) -> Launches:
    """Each kernel's launches since ``reset``. Only a path that evaluates a bf16
    model or the TPU kernel's bf16 forward (``bf16=True``) may have launched one
    of the res stack's bf16 modes."""
    launches = Launches(counters)
    if not bf16 and any(n for mode, n in launches.by_mode.items() if mode != "float32"):
        fail(f"a float32 path launched a bf16 mode of the res stack: {launches.by_mode}")
    return launches


def bf16_eval_modes(n: int) -> dict:
    """The res stack's launches by mode where a bf16 model's eval forward ran ``n`` times:
    its bf16-activation mode (flax's flow) alone."""
    return {"float32": 0, "bfloat16": 0, "bfloat16_activations": n}


def check_ground_truth(what: str, events, positions, labels) -> None:
    """Every planted keyword detected once, with its label, within 250 ms; nothing else."""
    got = [(round(e.time_s, 3), labels[e.label]) for e in events]
    if len(events) != len(positions) or any(
            labels[e.label] != w or abs(e.time_s - t) > 0.25 for e, (t, w) in zip(events, positions)):
        fail(f"{what}: detections {got}, planted {positions}")


def check_same_events(what: str, got, ref) -> None:
    """Label and time exactly, score within STREAM_ATOL."""
    if [(e.time_s, e.label) for e in got] != [(e.time_s, e.label) for e in ref] or any(
            abs(g.score - r.score) > STREAM_ATOL for g, r in zip(got, ref)):
        fail(f"{what}: cuda events {got} != cpu events {ref}")


def phase_causal_mfcc(torch, dev, mfcc_kernel, name) -> dict:
    """17. The MFCC kernel's causal framing (the online step) and its center
    framing on long waveforms (offline streaming), against the plain version."""
    rng = np.random.default_rng(SEED + 17)
    out = {}
    for key, b, n, k, iters in (("causal_b8", 8, 480 + CHUNK, CHUNK // 160, 200),
                                ("causal_b1_hop", 1, 480 + 160, 1, 200),
                                ("causal_b64", 64, 480 + 16000, 100, 100),
                                ("center_60s", 1, 60 * 16000, None, 50),
                                ("center_10min", 1, 600 * 16000, None, 20)):
        center = k is None
        a = torch.from_numpy((rng.standard_normal((b, n)) * 0.2).astype(np.float32)).to(dev)
        got = mfcc_kernel.mfcc(a, center=center, n_frames=k)
        ref = mfcc_kernel.mfcc_plain(a, center=center, n_frames=k)
        torch.cuda.synchronize()
        frames = 1 + n // 160 if center else k
        if got.shape != (b, frames, 40) or not torch.isfinite(got).all():
            fail(f"mfcc kernel, {key}: shape {tuple(got.shape)} or non-finite values")
        err = max_err(got, ref)
        if not close(got, ref, **MFCC_TOL):
            fail(f"mfcc kernel disagrees with its plain version, {key}: max abs err {err:.3e}")
        bnd, by = bound(*mfcc_work(b * frames, b * n), name)
        out[key] = {
            "batch": b, "n_samples": n, "frames": frames, "center": center, "max_abs_err": err,
            "ms": time_ms(torch, lambda: mfcc_kernel.mfcc(a, center=center, n_frames=k), iters),
            "plain_ms": time_ms(torch, lambda: mfcc_kernel.mfcc_plain(a, center=center, n_frames=k), iters),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "geometry": mfcc_kernel.geometry(a, center=center, n_frames=k),
        }
    print(f"[causal_mfcc] kernel against its plain version (atol {MFCC_TOL['atol']}, rtol {MFCC_TOL['rtol']}), "
          "ms per call (CUDA events behind a spin kernel): " + json.dumps(out))
    return out


def phase_offline(torch, svc, cpu, counters, serve, track, positions, name) -> dict:
    """18. Offline streaming: evaluate_long / stream_file on the 60 s track, cuda
    against cpu, exact launches; POST /stream; then a 10 min track on cuda."""
    from honk_tpu_torch.cli.demo import synthesize_long_audio
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.ops import res_kernel
    from honk_tpu_torch.stream import frame_mfccs, stream_file

    cfg = StreamConfig(**STREAM_CFG)
    cpu_sm, cpu_ev = stream_file(cpu.model, None, track, cfg, packed=cpu._packed)
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = svc.evaluate_long(track, cfg)  # the service's entry point
    wall_60s = time.perf_counter() - t0
    launches = read(counters)
    if launches != {"assemble": 0, "mfcc": 1, "res_stack": 1}:
        fail(f"evaluate_long of the 60 s track launched {launches}: expected one mfcc and one res_stack")
    gpu_sm, gpu_ev = stream_file(svc.model, None, track, cfg, packed=svc._packed)
    err = float(np.abs(gpu_sm - cpu_sm).max())
    if gpu_sm.shape != cpu_sm.shape or not np.isfinite(gpu_sm).all() or err > STREAM_ATOL:
        fail(f"stream_file cuda vs cpu: shape {gpu_sm.shape} vs {cpu_sm.shape}, max abs err {err:.3e}")
    check_same_events("stream_file on the track", gpu_ev, cpu_ev)
    check_ground_truth("stream_file on the track (cuda)", gpu_ev, positions, svc.labels)
    if [(e["time_s"], e["label"]) for e in events] != [(e.time_s, svc.labels[e.label]) for e in gpu_ev]:
        fail(f"evaluate_long {events} != stream_file {gpu_ev}")

    # POST /stream (the service's default StreamConfig) against the CPU service on the same PCM16.
    pcm = np.clip(np.round(track * 32767), -32768, 32767).astype(np.int16)
    httpd = serve(svc, port=0, n_stream_slots=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        reset(counters)
        t0 = time.perf_counter()
        answer = post_json(f"http://127.0.0.1:{httpd.server_address[1]}/stream",
                           {"wav_data": base64.b64encode(pcm.tobytes()).decode()})["detections"]
        post_s = time.perf_counter() - t0
        post_launches = read(counters)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    want = cpu.evaluate_long(pcm.astype(np.float32) / 32768.0)
    if [(e["time_s"], e["label"]) for e in answer] != [(e["time_s"], e["label"]) for e in want] or any(
            abs(a["prob"] - w["prob"]) > STREAM_ATOL for a, w in zip(answer, want)):
        fail(f"POST /stream answered {answer}, the CPU service {want}")
    planted = dict((w, t) for t, w in positions)
    if not answer or any(abs(planted.get(e["label"], -9.0) - e["time_s"]) > 0.5 for e in answer):
        fail(f"POST /stream: detections {answer} are not at the planted keywords {positions}")
    if post_launches != {"assemble": 0, "mfcc": 1, "res_stack": 1}:
        fail(f"POST /stream launched {post_launches}")

    # 10 minutes on cuda: wall time, audio-s per s, the res stack at B = n_windows.
    long_track, long_pos = synthesize_long_audio(list(STREAM_KEYWORDS) * 10, seconds=LONG_TRACK_S, seed=8,
                                                 gap_s=8.0, noise_amp=0.01)
    stream_file(svc.model, None, long_track, cfg, packed=svc._packed)  # warm up cuDNN for this batch
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    long_sm, long_ev = stream_file(svc.model, None, long_track, cfg, packed=svc._packed)
    wall_10min = time.perf_counter() - t0
    long_launches = read(counters)
    if long_launches != {"assemble": 0, "mfcc": 1, "res_stack": 1}:
        fail(f"stream_file of 10 min launched {long_launches}")
    found = sum(any(abs(e.time_s - t) <= 0.25 and svc.labels[e.label] == w for e in long_ev) for t, w in long_pos)
    # Where the 10 min call's time goes: the device's part (torch.profiler over 3 calls).
    long_prof = profile_steps(torch, lambda: stream_file(svc.model, None, long_track, cfg, packed=svc._packed), 3)
    # The res stack at the offline batch (every window of 10 min) and at the
    # hub's (8 slots), kernel against plain, timed.
    with torch.inference_mode():
        feats = frame_mfccs(torch.from_numpy(long_track).to(svc.device))
        windows = feats.unfold(0, 101, cfg.hop_samples // 160).transpose(1, 2).contiguous()
        pooled = svc.model.stem(windows)
        packed = svc._packed
        C, H, W = pooled.shape[1:]
        L, n_lab = packed[0].shape[0], packed[3].shape[1]
        res = {}
        for b, iters in ((HUB_SLOTS, 200), (pooled.shape[0], 5)):
            x = pooled[:b].contiguous()
            got = res_kernel.res_stack(x, *packed)
            ref = res_kernel.res_stack_plain(x, *packed)
            torch.cuda.synchronize()
            e = max_err(got, ref)
            if not close(got, ref, **RES_TOL):
                fail(f"res_stack kernel at B={b}: max abs err {e:.3e}")
            bnd, by = bound(*res_work(b, C, H, W, L, n_lab), name, tf32x3=True)
            res[b] = {"max_abs_err": e, "ms": time_ms(torch, lambda: res_kernel.res_stack(x, *packed), iters),
                      "plain_ms": time_ms(torch, lambda: res_kernel.res_stack_plain(x, *packed), iters),
                      "bound_ms": bnd, "bound_by": by, "library_ms": None,
                      "geometry": res_kernel.geometry(x)}
    out = {"wall_ms_60s": wall_60s * 1e3, "smoothed_max_abs_err": err, "launches": launches,
           "events": [(round(e.time_s, 3), svc.labels[e.label], round(e.score, 4)) for e in gpu_ev],
           "post_stream_host_ms": post_s * 1e3, "post_stream_detections": answer,
           "post_stream_launches": post_launches, "n_windows_10min": int(long_sm.shape[0]),
           "wall_ms_10min": wall_10min * 1e3, "audio_s_per_s_10min": LONG_TRACK_S / wall_10min,
           "launches_10min": long_launches, "events_10min": len(long_ev),
           "planted_10min": len(long_pos), "planted_found_10min": int(found),
           "profile_10min": {k: long_prof[k] for k in ("profiled_wall_ms", "device_ms", "device_idle_share",
                                                       "device_kernels_per_step", "top_kernels_ms")}}
    print("[offline] " + json.dumps(out))
    print("[offline] res_stack at the streaming batches (CUDA events): " + json.dumps(res))
    return out, res


def phase_online(torch, svc, cpu, counters, track, positions) -> dict:
    """19. Streamer over the 60 s track on cuda against the CPU, chunk by chunk;
    events against the planted positions; launches and host ms per step."""
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.stream import Streamer, detect_stream

    cfg = StreamConfig(**STREAM_CFG)
    n = len(track) // CHUNK
    chunks = track[: n * CHUNK].reshape(n, CHUNK)
    series = {}
    for side, s in (("cpu", cpu), ("cuda", svc)):
        st = Streamer(s.model, None, cfg, CHUNK)
        state = st.reset()
        if side == "cuda":
            torch.cuda.synchronize()
            reset(counters)
            t0 = time.perf_counter()
        posts = []
        for c in chunks:
            state, post = st.process(state, c)
            posts.append(post)
        series[side] = torch.stack(posts).cpu().numpy()  # waits for the card
    wall = time.perf_counter() - t0
    launches = read(counters)
    # Device time of a step (torch.profiler over 20 more steps of the same stream).
    more = iter(chunks[:20])
    prof = profile_steps(torch, lambda: st.process(state, next(more)), 20)
    if launches != {"assemble": 0, "mfcc": n, "res_stack": n}:
        fail(f"Streamer over {n} chunks launched {launches}: expected one mfcc and one res_stack a step")
    err = float(np.abs(series["cuda"] - series["cpu"]).max())
    if not np.isfinite(series["cuda"]).all() or err > STREAM_ATOL:
        fail(f"Streamer cuda vs cpu: max abs err {err:.3e}")
    events = detect_stream(series["cuda"], cfg, CHUNK)
    check_same_events("Streamer on the track", events, detect_stream(series["cpu"], cfg, CHUNK))
    check_ground_truth("Streamer on the track (cuda)", events, positions, svc.labels)
    out = {"steps": n, "smoothed_max_abs_err": err, "launches": launches,
           "launches_per_step": {k: v / n for k, v in launches.items()}, "host_ms_per_step": wall * 1e3 / n,
           "device_ms_per_step": prof["device_ms"], "device_kernels_per_step": prof["device_kernels_per_step"],
           "device_idle_share": prof["device_idle_share"], "top_kernels_ms": prof["top_kernels_ms"][:4],
           "events": [(round(e.time_s, 3), svc.labels[e.label], round(e.score, 4)) for e in events]}
    print("[online] " + json.dumps(out))
    return out


def hub_streams(track) -> np.ndarray:
    """The hub phase's 8 PCM16 streams: the track, then seven of noise."""
    rng = np.random.default_rng(SEED + 20)
    noise = rng.standard_normal((HUB_SLOTS - 1, len(track))) * 0.01
    audio = np.concatenate([track[None], noise]).astype(np.float32)
    return np.clip(np.round(audio * 32767), -32768, 32767).astype(np.int16)


def phase_hub(torch, svc, cpu, counters, serve, track, positions) -> dict:
    """20. The stream hub over HTTP: serve() with the serving CLI's defaults (8
    slots, 3200-sample chunks, 2 ms coalescing), one session on the track and
    seven on noise, four times: sync, pipelined, the int16 wire, push_bin."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.serve import StreamHub

    cfg = StreamConfig(**STREAM_CFG)
    pcm = hub_streams(track)
    n_ticks = pcm.shape[1] // CHUNK
    rows = [pcm[:, t * CHUNK:(t + 1) * CHUNK] for t in range(n_ticks)]

    # The CPU hub on the same chunks: per-tick results and each session's events.
    ref_hub = StreamHub(cpu, HUB_SLOTS, cfg, CHUNK)
    ref_sids = [ref_hub.open() for _ in range(HUB_SLOTS)]
    ref_ticks = [ref_hub.push_rows(ref_sids, r) for r in rows]
    ref_ticks = [[res[s] for s in ref_sids] for res in ref_ticks]
    ref_events = [ref_hub.close(s)["events"] for s in ref_sids]

    def same_events(a, b):
        return [(e["time_s"], e["label"]) for e in a] == [(e["time_s"], e["label"]) for e in b] and all(
            abs(x["prob"] - y["prob"]) <= 2 * STREAM_ATOL for x, y in zip(a, b))

    results = {}
    for run, kw in (("sync", {}), ("pipelined", {"stream_pipelined": True}),
                    ("int16_wire", {"stream_wire_dtype": "int16"}), ("push_bin", {})):
        httpd = serve(svc, port=0, n_stream_slots=HUB_SLOTS, stream_cfg=cfg, chunk_samples=CHUNK,
                      stream_coalesce_ms=2.0, **kw)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        port = httpd.server_address[1]
        local, conns = threading.local(), []
        lock = threading.Lock()

        def request(path, body, ctype="application/json", fresh=False):
            # One keep-alive connection per client thread; ``fresh`` replaces it
            # with a new one (a new server thread) before this request.
            conn = getattr(local, "conn", None)
            if fresh and conn is not None:
                conn.close()
            if conn is None or fresh:
                conn = local.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                with lock:
                    conns.append(conn)
            t0 = time.perf_counter()
            conn.request("POST", path, body, {"Content-Type": ctype})
            r = conn.getresponse()
            data = json.loads(r.read())
            if r.status != 200:
                fail(f"hub {run}: {path} answered {r.status} {data}")
            return data, time.perf_counter() - t0

        try:
            n_clients = 1 if run == "push_bin" else HUB_SLOTS
            with ThreadPoolExecutor(max_workers=n_clients) as pool:
                sids = [request("/stream/open", b"{}")[0]["stream_id"] for _ in range(HUB_SLOTS)]

                # Mid-run, every client pushes once on a new connection: the
                # first push on a new connection, with the clients' threads
                # already running and the ticks already in phase.
                prof_at = 100
                reconnect_at = prof_at + 20 + 50

                def push(i, t):
                    body = json.dumps({"stream_id": sids[i],
                                       "wav_data": base64.b64encode(rows[t][i].tobytes()).decode()}).encode()
                    return request("/stream/push", body, fresh=t == reconnect_at)

                def push_bin(t):
                    header = json.dumps({"stream_ids": sids, "posterior": True}).encode()
                    out, dt = request("/stream/push_bin",
                                      len(header).to_bytes(4, "little") + header + rows[t].astype("<i2").tobytes(),
                                      "application/octet-stream", fresh=t == reconnect_at)
                    return [(out["results"][s], dt) for s in sids]

                answers, tick_ms, push_ms = [], [], []

                def tick(t):
                    t0 = time.perf_counter()
                    if run == "push_bin":
                        got = pool.submit(push_bin, t).result()
                    else:
                        got = [f.result() for f in [pool.submit(push, i, t) for i in range(HUB_SLOTS)]]
                    tick_ms.append((time.perf_counter() - t0) * 1e3)
                    push_ms.append([dt * 1e3 for _, dt in got])
                    answers.append([a for a, _ in got])

                reset(counters)
                for t in range(prof_at):
                    tick(t)
                it = iter(range(prof_at, prof_at + 20))
                prof = profile_steps(torch, lambda: tick(next(it)), 20, required=False)
                for t in range(prof_at + 20, n_ticks):
                    tick(t)
                closed = [request("/stream/close", json.dumps({"stream_id": s}).encode())[0] for s in sids]
                launches = read(counters)
        finally:
            for conn in conns:
                conn.close()
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)
        if th.is_alive():
            fail(f"hub {run}: the server thread did not stop")

        # Results: the CPU hub's, tick by tick (pipelined: one tick late) and session by session.
        lag = 1 if run == "pipelined" else 0
        post_err = 0.0
        for t, ans in enumerate(answers):
            if t < lag:
                if not all(a.get("pending") for a in ans):
                    fail(f"hub {run}: the first push is not pending: {ans[0]}")
                continue
            for a, r in zip(ans, ref_ticks[t - lag]):
                if a["label"] != r["label"] or not same_events(a["events"], r["events"]):
                    fail(f"hub {run}, tick {t}: {a['label']} {a['events']} != cpu {r['label']} {r['events']}")
                post_err = max(post_err, float(np.abs(np.asarray(a["posterior"]) - r["posterior"]).max()))
        if post_err > STREAM_ATOL:
            fail(f"hub {run}: posteriors against the CPU hub's, max abs err {post_err:.3e}")
        for i, c in enumerate(closed):
            if not same_events(c["events"], ref_events[i]):
                fail(f"hub {run}: session {i} closed with {c['events']}, the CPU hub's {ref_events[i]}")
        planted = [(e["time_s"], e["label"]) for e in closed[0]["events"]]
        if len(planted) != len(positions) or any(
                lab != w or abs(ts - t) > 0.25 for (ts, lab), (t, w) in zip(planted, positions)):
            fail(f"hub {run}: track session's events {planted}, planted {positions}")
        if any(c["events"] for c in closed[1:]):
            fail(f"hub {run}: false alarms on the noise sessions: {[c['events'] for c in closed[1:]]}")
        if launches["mfcc"] != launches["res_stack"] or not n_ticks <= launches["mfcc"] <= HUB_SLOTS * n_ticks \
                or launches["assemble"]:
            fail(f"hub {run}: launched {launches} over {n_ticks} ticks")
        if run == "push_bin" and launches["mfcc"] != n_ticks:
            fail(f"hub push_bin: one frame a tick must be one dispatch, launched {launches}")
        first = push_ms[0]
        steady = [ms for t, row in enumerate(push_ms) if t >= prof_at + 20 and t != reconnect_at for ms in row]
        results[run] = {
            "ticks": n_ticks, "launches": launches, "launches_per_tick": launches["mfcc"] / n_ticks,
            "posterior_max_abs_err": post_err,
            "track_events": planted, "host_ms_per_tick_median": float(np.median(tick_ms)),
            "host_ms_per_tick_p99": float(np.percentile(tick_ms, 99)),
            "push_ms_first_on_new_connection": first, "push_ms_on_new_connection_mid_run": push_ms[reconnect_at],
            "push_ms_steady_median": float(np.median(steady)), "push_ms_steady_p99": float(np.percentile(steady, 99)),
            "device_ms_per_tick": prof["device_ms"], "device_kernels_per_tick": prof["device_kernels_per_step"],
            "device_idle_share": prof["device_idle_share"], "top_kernels_ms": prof["top_kernels_ms"][:4],
        }
    print("[hub] 8 sessions (the track and 7 of noise), "
          f"{n_ticks} ticks each run, results equal to the CPU hub's: " + json.dumps(results))
    return results


def phase_stream_family(torch, family_services, counters, track) -> dict:
    """21. res15 and cnn-trad-pool2 (cuDNN / cuBLAS) through stream_file and a
    3-slot BatchStreamer on the track, cuda against cpu."""
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.stream import BatchStreamer, stream_file

    cfg = StreamConfig(**STREAM_CFG)
    rng = np.random.default_rng(SEED + 21)
    three = np.concatenate([track[None], rng.standard_normal((2, len(track))) * 0.01]).astype(np.float32)
    out = {}
    for conf in ("res15", "cnn-trad-pool2"):
        gpu, cpu_svc = family_services[conf]
        smoothed, launches = {}, {}
        for side, s in (("cpu", cpu_svc), ("cuda", gpu)):
            reset(counters)
            smoothed[side], _ = stream_file(s.model, None, track, cfg, packed=s._packed)
            launches[side] = read(counters)
        if launches["cuda"] != {"assemble": 0, "mfcc": 1, "res_stack": 0}:
            fail(f"{conf} stream_file launched {launches['cuda']}")
        off_err = float(np.abs(smoothed["cuda"] - smoothed["cpu"]).max())
        if off_err > STREAM_ATOL:
            fail(f"{conf} stream_file cuda vs cpu: max abs err {off_err:.3e}")
        series = {}
        for side, s in (("cpu", cpu_svc), ("cuda", gpu)):
            bs = BatchStreamer(s.model, None, 3, cfg, CHUNK)
            state = bs.reset()
            reset(counters)
            posts = []
            for t in range(FAMILY_STREAM_STEPS):
                state, post = bs.process(state, three[:, t * CHUNK:(t + 1) * CHUNK])
                posts.append(post)
            series[side] = torch.stack(posts).cpu().numpy()
            launches[f"batch_{side}"] = read(counters)
        if launches["batch_cuda"] != {"assemble": 0, "mfcc": FAMILY_STREAM_STEPS, "res_stack": 0}:
            fail(f"{conf} BatchStreamer launched {launches['batch_cuda']}")
        on_err = float(np.abs(series["cuda"] - series["cpu"]).max())
        if not np.isfinite(series["cuda"]).all() or on_err > STREAM_ATOL:
            fail(f"{conf} BatchStreamer cuda vs cpu: max abs err {on_err:.3e}")
        out[conf] = {"stream_file_max_abs_err": off_err, "batch_streamer_max_abs_err": on_err,
                     "launches_stream_file": launches["cuda"], "launches_batch_streamer": launches["batch_cuda"],
                     "batch_steps": FAMILY_STREAM_STEPS}
    print(f"[stream_family] cuda vs cpu (atol {STREAM_ATOL}): " + json.dumps(out))
    return out


def phase_streaming(torch, dev, svc, cpu, counters, serve, family_services, mfcc_kernel, name) -> dict:
    """17-21 on the 60 s ground-truth track; returns each phase's results and
    the kernels' launches on each streaming path."""
    from honk_tpu_torch.cli.demo import synthesize_long_audio

    t0 = time.perf_counter()
    mfcc = phase_causal_mfcc(torch, dev, mfcc_kernel, name)
    track, positions = synthesize_long_audio(list(STREAM_KEYWORDS), seconds=60, seed=7, gap_s=8.0, noise_amp=0.01)
    offline, res_stack = phase_offline(torch, svc, cpu, counters, serve, track, positions, name)
    online = phase_online(torch, svc, cpu, counters, track, positions)
    hub = phase_hub(torch, svc, cpu, counters, serve, track, positions)
    family = phase_stream_family(torch, family_services, counters, track)
    by_path = {
        "stream_offline_res8": offline["launches"], "stream_post_res8": offline["post_stream_launches"],
        "stream_offline_10min_res8": offline["launches_10min"], "stream_online_res8": online["launches"],
        **{f"stream_hub_{run}_res8": r["launches"] for run, r in hub.items()},
        **{f"stream_offline_{c}": r["launches_stream_file"] for c, r in family.items()},
        **{f"stream_batch3_{c}": r["launches_batch_streamer"] for c, r in family.items()},
    }
    print(f"[streaming] phases 17-21 took {time.perf_counter() - t0:.1f} s")
    return {"mfcc": mfcc, "res_stack": res_stack, "offline": offline, "online": online, "hub": hub,
            "family": family, "launches_by_path": by_path}


def personalize_positives() -> list[np.ndarray]:
    """Phase 22's three positives as PCM16: the synthetic generator's word
    "cat" (an unknown word to the zoo models) by three speakers, each over a
    0.01 noise floor."""
    from honk_tpu_torch.data.synthetic import DEFAULT_WORDS, UNKNOWN_WORDS, _word_signal

    idx = len(DEFAULT_WORDS) + UNKNOWN_WORDS.index(PERSONALIZE_WORD)
    out = []
    for s in range(3):
        rng = np.random.default_rng(SEED + 22 + s)
        clip = _word_signal(idx, speaker=s, n=0, sr=16000, rng=rng) + rng.standard_normal(16000) * 0.01
        out.append(np.clip(np.round(clip * 32767), -32768, 32767).astype(np.int16))
    return out


def request_status(url: str, obj) -> tuple[int, dict]:
    """POST JSON; the status and the JSON answer, error statuses included."""
    try:
        req = urllib.request.Request(url, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def train_over_http(httpd, counters, pcm, utts, chunks) -> dict:
    """Against a running-to-be server with a stream hub: open a session, push a
    chunk, POST /train with the positives, push the next chunk, then /listen
    the positives and the utterances; launches of /train and of the /listens."""
    b64 = lambda a: base64.b64encode(a.tobytes()).decode()  # noqa: E731
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    out = {}
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        sid = post_json(f"{base}/stream/open", {})["stream_id"]
        out["push_before"] = post_json(f"{base}/stream/push", {"stream_id": sid, "wav_data": b64(chunks[0])})
        reset(counters)
        t0 = time.perf_counter()
        out["code"], out["answer"] = request_status(f"{base}/train", {"positives": [b64(p) for p in pcm],
                                                                       "label": PERSONALIZE_LABEL})
        out["train_ms"] = (time.perf_counter() - t0) * 1e3
        out["train_launches"] = read(counters)
        out["push_after"] = post_json(f"{base}/stream/push", {"stream_id": sid, "wav_data": b64(chunks[1])})
        reset(counters)
        out["listens"] = [post_json(f"{base}/listen", {"wav_data": b64(p)}) for p in pcm + utts]
        out["listen_launches"] = read(counters)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    if th.is_alive():
        fail("the /train server's thread did not stop")
    return out


def check_served(what, run, listen_svc, hub_svc, requests, chunks, swap=None) -> tuple[float, float]:
    """A train_over_http run against the CPU: its /listens against ``listen_svc``,
    its session's two posteriors against a CPU hub on ``hub_svc`` given ``swap``
    (new weights) between the chunks. Returns the max abs errors (probs, posteriors)."""
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.serve import StreamHub

    n = len(requests)
    if run["listen_launches"] != {"assemble": 0, "mfcc": n, "res_stack": n}:
        fail(f"{what}: /listen x{n} launched {run['listen_launches']}: expected {n} mfcc and res_stack")
    prob_err = 0.0
    for p, ans in zip(requests, run["listens"]):
        label, prob = listen_svc.evaluate(p.astype(np.float32) / 32768.0)
        prob_err = max(prob_err, abs(ans["prob"] - prob))
        if ans["label"] != label or abs(ans["prob"] - prob) > PROB_ATOL:
            fail(f"{what}: /listen answered {ans}, the CPU service ({label}, {prob})")
    ref = StreamHub(hub_svc, HUB_SLOTS, StreamConfig(**STREAM_CFG), CHUNK)
    rsid = ref.open()
    want = [ref.push(rsid, chunks[0])]
    if swap is not None:
        ref.set_variables(swap)
    want.append(ref.push(rsid, chunks[1]))
    hub_err = max(float(np.abs(np.asarray(run[k]["posterior"]) - w["posterior"]).max())
                  for k, w in zip(("push_before", "push_after"), want))
    if hub_err > STREAM_ATOL:
        fail(f"{what}: the hub session's posteriors against a CPU hub's, max abs err {hub_err:.3e}")
    return prob_err, hub_err


def phase_personalize(torch, counters, serve) -> dict:
    """22. Personalization of zoo/res8.pt at full width: TrainingService on cuda
    against the CPU (3 steps; 60 at the defaults and at PERSONALIZE_LR), exact
    launches; POST /train on servers with 8 stream slots (the defaults, which
    diverge on res8, then PERSONALIZE_LR), /listen and a hub session opened
    before /train against the CPU; --no-train."""
    from http.server import ThreadingHTTPServer

    from honk_tpu_torch.cli import serve as cli_serve
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.serve import LabelService, StreamHub, TrainingService
    from honk_tpu_torch.serve.http import make_handler

    pcm = personalize_positives()
    pos = [p.astype(np.float32) / 32768.0 for p in pcm]
    gpu, cpu = LabelService("res8", CHECKPOINT), LabelService("res8", CHECKPOINT, device="cpu")
    one_mfcc = {"assemble": 0, "mfcc": 1, "res_stack": 0}

    def fine_tune(svc, **kw):
        trainer = TrainingService(svc, **kw)
        reset(counters)
        t0 = time.perf_counter()
        out = trainer.fine_tune(pos, PERSONALIZE_LABEL)
        torch.cuda.synchronize()
        wall, launches = time.perf_counter() - t0, read(counters)
        if svc is gpu and launches != one_mfcc:
            fail(f"fine_tune ({trainer.steps} steps) launched {launches}: expected one mfcc, nothing else")
        return out, wall * 1e3, launches

    def weight_errs(a, b):
        """Max abs weight difference and the largest share of an element's limit (NaN if any weight is)."""
        err, share = [], []
        for k, ref in b["variables"].items():
            got, ref = a["variables"][k].cpu().double(), ref.cpu().double()
            diff = (got - ref).abs()
            err.append(diff.max())
            share.append((diff / (TRAIN_PARAM_TOL["atol"] + TRAIN_PARAM_TOL["rtol"] * ref.abs())).max())
        return float(torch.stack(err).max()), float(torch.stack(share).max())

    runs = {}
    for key, kw in (("steps3", {"steps": 3}), ("steps60_defaults", {}),
                    ("steps60_lr", {"learning_rate": PERSONALIZE_LR})):
        (g, g_ms, launches), (c, c_ms, _) = fine_tune(gpu, **kw), fine_tune(cpu, **kw)
        err, share = weight_errs(g, c)
        runs[key] = {"final_loss": {"cuda": g["final_loss"], "cpu": c["final_loss"]}, "weight_max_abs_err": err,
                     "weight_gate_share": share, "launches": launches, "host_ms": {"cuda": g_ms, "cpu": c_ms}}
        if key == "steps3" and (abs(g["final_loss"] - c["final_loss"]) > TRAIN_LOSS_ATOL or not share <= 1.0):
            fail(f"fine_tune 3 steps cuda vs cpu: loss {g['final_loss']} vs {c['final_loss']}, "
                 f"weights at {share:.2f} of their limit")
        if key == "steps60_lr" and not (math.isfinite(g["final_loss"]) and math.isfinite(c["final_loss"])):
            fail(f"fine_tune at lr {PERSONALIZE_LR}: final losses {runs[key]['final_loss']}")
    diverges = not math.isfinite(runs["steps60_defaults"]["final_loss"]["cuda"])
    if diverges != (not math.isfinite(runs["steps60_defaults"]["final_loss"]["cpu"])):
        fail(f"fine_tune at the defaults: cuda and cpu disagree on divergence: {runs['steps60_defaults']}")
    # Device view of a 10-step fine-tune at the defaults (the copy of the model and the MFCC included).
    steps_prof = 10
    prof = profile_steps(torch, lambda: TrainingService(gpu, steps=steps_prof).fine_tune(pos, PERSONALIZE_LABEL), 1)

    rng = np.random.default_rng(SEED + 22)
    utts = [(rng.standard_normal(n) * 3000).astype(np.int16)
            for n in (16000, 12000, 20000, 16000, 8000, 16000, 24000, 16000)]
    chunks = [np.clip(np.round(rng.standard_normal(CHUNK) * 0.05 * 32767), -32768, 32767).astype(np.int16)
              for _ in range(2)]
    requests = pcm + utts
    base_labels = [cpu.evaluate(p)[0] for p in pos]
    cfg = StreamConfig(**STREAM_CFG)

    # serve() as the CLI builds it (TrainingService's defaults): on res8 they diverge, so 422 and no swap.
    before_model = gpu.model
    run_default = train_over_http(serve(gpu, port=0, n_stream_slots=HUB_SLOTS, stream_cfg=cfg, chunk_samples=CHUNK),
                                  counters, pcm, utts, chunks)
    want_code = 422 if diverges else 200
    if run_default["code"] != want_code or run_default["train_launches"] != one_mfcc:
        fail(f"POST /train at the defaults answered {run_default['code']} {run_default['answer']}, launched "
             f"{run_default['train_launches']}: expected {want_code} and one mfcc")
    if diverges:
        if gpu.model is not before_model:
            fail("a diverged POST /train swapped the service's model")
        check_served("after a diverged /train", run_default, cpu, cpu, requests, chunks)
    else:
        gpu.set_variables({k: v for k, v in before_model.state_dict().items()})

    # The same handler with the trainer at PERSONALIZE_LR: 200, and the weights swapped everywhere.
    hub = StreamHub(gpu, HUB_SLOTS, cfg, CHUNK, coalesce_ms=2.0)
    trainer = TrainingService(gpu, learning_rate=PERSONALIZE_LR)
    before_model = gpu.model
    try:
        run = train_over_http(ThreadingHTTPServer(("127.0.0.1", 0), make_handler(gpu, trainer, hub)),
                              counters, pcm, utts, chunks)
    finally:
        hub.shutdown()
    if run["code"] != 200 or run["train_launches"] != one_mfcc:
        fail(f"POST /train at lr {PERSONALIZE_LR} answered {run['code']} {run['answer']}, launched "
             f"{run['train_launches']}: expected 200 and one mfcc")
    if gpu.model is before_model:
        fail("POST /train did not swap the service's model")
    new_sd = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    prob_err, hub_err = check_served("after /train", run, LabelService("res8", new_sd, device="cpu"), cpu,
                                     requests, chunks, swap=new_sd)

    httpd = cli_serve.make_server(["--no-train", "--checkpoint", CHECKPOINT, "--port", "0", "--stream-slots", "0"])
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        no_train, _ = request_status(f"http://127.0.0.1:{httpd.server_address[1]}/train",
                                     {"positives": [base64.b64encode(pcm[0].tobytes()).decode()],
                                      "label": PERSONALIZE_LABEL})
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    if no_train != 503:
        fail(f"POST /train on a --no-train server answered {no_train}")

    out = {
        "positives": f"{len(pcm)} x the generator's {PERSONALIZE_WORD!r} as {PERSONALIZE_LABEL!r}",
        "batch": 2 * 4 * len(pcm), "fine_tune": runs, "defaults_diverge": diverges,
        "profile_10_steps": {"device_ms_per_step": prof["device_ms"] / steps_prof,
                             "device_kernels_per_step": prof["device_kernels_per_step"] / steps_prof,
                             "device_idle_share": prof["device_idle_share"],
                             "profiled_wall_ms_per_step": prof["profiled_wall_ms"] / steps_prof,
                             "top_kernels_ms_per_call": prof["top_kernels_ms"][:5]},
        "post_train_defaults": {"status": run_default["code"], "ms": run_default["train_ms"],
                                "launches": run_default["train_launches"]},
        "post_train": {"status": run["code"], "ms": run["train_ms"], "final_loss": run["answer"]["final_loss"],
                       "launches": run["train_launches"]},
        "train_launches": run["train_launches"], "listen_after_train_launches": run["listen_launches"],
        "listen_after_train_prob_max_abs_err": prob_err, "hub_posterior_max_abs_err": hub_err,
        "positives_labels_before": base_labels, "positives_labels_after": [a["label"] for a in run["listens"][:3]],
        "no_train_status": no_train,
    }
    print("[personalize] " + json.dumps(out))
    return out


def _srt_time(t: float) -> str:
    ms = int(round(t * 1000))
    return f"{ms // 3600000:02d}:{ms // 60000 % 60:02d}:{ms // 1000 % 60:02d},{ms % 1000:03d}"


def _tree(root: str) -> dict:
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(dp, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dp, f), root)] = fh.read()
    return out


def phase_datagen(torch, counters, tmp) -> dict:
    """23. The dataset generator on the streaming phases' tracks (60 s and 10 min,
    keywords planted at known times, one caption each): the CLI with
    --eval_checkpoint zoo/res8.pt on cuda and on the CPU, then the scoring rate."""
    from honk_tpu_torch.cli.demo import synthesize_long_audio
    from honk_tpu_torch.data import write_wav
    from honk_tpu_torch.datagen import (LocalFileSource, evaluate_clips, extract_clips,
                                        find_keyword_occurrences)
    from honk_tpu_torch.datagen.cli import main as datagen_main
    from honk_tpu_torch.serve import LabelService

    src = os.path.join(tmp, "datagen_src")
    os.makedirs(src)
    for stem, kw in (("track60s", dict(keywords=list(STREAM_KEYWORDS), seconds=60, seed=7)),
                     ("track10min", dict(keywords=list(STREAM_KEYWORDS) * 10, seconds=LONG_TRACK_S, seed=8))):
        audio, positions = synthesize_long_audio(gap_s=8.0, noise_amp=0.01, **kw)
        write_wav(os.path.join(src, f"{stem}.wav"), audio, 16000)
        with open(os.path.join(src, f"{stem}.srt"), "w") as f:
            f.write("\n".join(f"{i + 1}\n{_srt_time(t)} --> {_srt_time(t + 1.0)}\n{w}\n"
                              for i, (t, w) in enumerate(positions)))
    runs = {}
    for side in ("cuda", "cpu"):
        out_dir, report = os.path.join(tmp, f"datagen_{side}"), os.path.join(tmp, f"datagen_{side}.json")
        reset(counters)
        t0 = time.perf_counter()
        rc, _ = run_cli(datagen_main, ["--keywords", *STREAM_KEYWORDS, "--input_dir", src, "--out_dir", out_dir,
                                       "--eval_checkpoint", CHECKPOINT, "--report_json", report, "--device", side])
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"datagen CLI --device {side} returned {rc}")
        with open(report) as f:
            runs[side] = {"files": _tree(out_dir), "report": json.load(f), "wall_s": wall, "launches": read(counters)}
    got, want = runs["cuda"]["report"], runs["cpu"]["report"]
    n = got["n_clips"]
    if n != 11 * len(STREAM_KEYWORDS) or got["n_scored"] != n:  # every planted keyword of both tracks
        fail(f"datagen: {n} clips, {got['n_scored']} scored; expected {11 * len(STREAM_KEYWORDS)}")
    if runs["cuda"]["files"] != runs["cpu"]["files"] or len(runs["cuda"]["files"]) != n:
        fail(f"datagen: the clip files differ between cuda and cpu ({len(runs['cuda']['files'])} files, {n} clips)")
    batches = math.ceil(n / BATCH)
    if runs["cuda"]["launches"] != {"assemble": 0, "mfcc": batches, "res_stack": batches}:
        fail(f"datagen CLI on cuda launched {runs['cuda']['launches']} for {n} clips: expected {batches} each")
    prob_err = 0.0
    for g, w in zip(got["verdicts"], want["verdicts"]):
        if (g["keyword"], g["pred"], g["accept"]) != (w["keyword"], w["pred"], w["accept"]):
            fail(f"datagen verdict cuda {g} != cpu {w}")
        prob_err = max(prob_err, abs(g["prob"] - w["prob"]), abs(g["keyword_prob"] - w["keyword_prob"]))
    if len(got["verdicts"]) != len(want["verdicts"]) or prob_err > PROB_ATOL or got["per_keyword"] != want["per_keyword"]:
        fail(f"datagen report cuda vs cpu: prob max abs err {prob_err:.3e}, {got['per_keyword']} vs {want['per_keyword']}")
    accepted = sum(v["accept"] for v in got["verdicts"])

    # Scoring rate on the card: the clips in one padded batch, and 4 full batches.
    svc = LabelService("res8", CHECKPOINT)
    clips = [c for item in LocalFileSource(src)
             for c in extract_clips(item.audio, find_keyword_occurrences(item.captions, STREAM_KEYWORDS))]
    rates = {}
    for key, cl in (("clips", clips), ("full_batches_4", (clips * (4 * BATCH // len(clips) + 1))[:4 * BATCH])):
        evaluate_clips(svc.model, None, svc.labels, cl)  # warm up cuDNN for the shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            evaluate_clips(svc.model, None, svc.labels, cl)
        torch.cuda.synchronize()
        rates[key] = {"n_clips": len(cl), "clips_per_s": 5 * len(cl) / (time.perf_counter() - t0)}
    out = {"n_clips": n, "accepted": accepted, "per_keyword": got["per_keyword"], "prob_max_abs_err": prob_err,
           "launches": runs["cuda"]["launches"], "cli_wall_s": {k: r["wall_s"] for k, r in runs.items()},
           "scoring": rates}
    print("[datagen] " + json.dumps(out))
    return out


# ---- 24-28: the device worker, data parallel, --profile-dir, the native loader ----

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ms_summary(ms: list[float]) -> dict:
    return {"median_ms": float(np.median(ms)), "p99_ms": float(np.percentile(ms, 99)),
            "min_ms": float(min(ms)), "max_ms": float(max(ms))}


def phase_worker_thread(torch, services, serve, hub, smi) -> dict:
    """24. The repair: /listen on a new connection per request (a new server thread
    each): its round trip, the service call inside it on the handler's thread, and
    GET /labels (no device work) on a new connection each; against
    LabelService.evaluate on the main thread, on a new thread per call and on one
    worker thread (scripts/probe_torch_listen_threads.py's three columns); the
    hub's first push on a new connection against its steady push."""
    from concurrent.futures import ThreadPoolExecutor

    x = (np.random.default_rng(SEED + 24).standard_normal(16000) * 0.1).astype(np.float32)
    pcm = {"wav_data": base64.b64encode(np.round(x * 32767).astype(np.int16).tobytes()).decode()}
    out = {}
    with ThreadPoolExecutor(max_workers=1) as one_worker:
        for conf, svc in services.items():
            evaluate = svc.evaluate
            call = lambda: evaluate(x)  # noqa: E731

            def timed(fn=call):
                t0 = time.perf_counter()
                fn()
                return (time.perf_counter() - t0) * 1e3

            def on_new_thread():
                box = []
                th = threading.Thread(target=lambda: box.append(timed()))
                th.start()
                th.join(timeout=60)
                if not box:
                    fail(f"{conf}: a probe thread did not finish")
                return box[0]

            for _ in range(3):
                call()
                one_worker.submit(call).result()
            in_server_ms, handler_threads = [], set()

            def evaluate_timed(audio):  # the handler's service call, on the handler's thread
                t0 = time.perf_counter()
                try:
                    return evaluate(audio)
                finally:
                    in_server_ms.append((time.perf_counter() - t0) * 1e3)
                    handler_threads.add(threading.current_thread().name)

            def labels():
                with urllib.request.urlopen(f"{base}/labels", timeout=60) as r:
                    r.read()

            httpd = serve(svc, port=0, enable_training=False, n_stream_slots=0)
            th = threading.Thread(target=httpd.serve_forever, daemon=True)
            th.start()
            svc.evaluate = evaluate_timed
            cols = {k: [] for k in ("listen_new_connection", "labels_new_connection", "evaluate_main_thread",
                                    "evaluate_new_thread_per_call", "evaluate_one_worker_thread")}
            try:
                base = f"http://127.0.0.1:{httpd.server_address[1]}"
                ans = post_json(f"{base}/listen", pcm)  # warm up the server path
                in_server_ms.clear()
                # In turns, one of each a round: a drift of the shared host moves every column alike.
                # urllib opens a new connection per request: a new server thread each.
                for _ in range(N_WORKER_ROUNDS):
                    cols["listen_new_connection"].append(timed(lambda: post_json(f"{base}/listen", pcm)))
                    cols["labels_new_connection"].append(timed(labels))
                    cols["evaluate_main_thread"].append(timed())
                    cols["evaluate_new_thread_per_call"].append(on_new_thread())
                    cols["evaluate_one_worker_thread"].append(one_worker.submit(timed).result())
            finally:
                del svc.evaluate
                httpd.shutdown()
                httpd.server_close()
                th.join(timeout=30)
            if ans["label"] != svc.evaluate(x)[0]:
                fail(f"{conf} /listen on a new connection answered {ans}")
            if len(in_server_ms) != N_WORKER_ROUNDS or threading.current_thread().name in handler_threads:
                fail(f"{conf}: {len(in_server_ms)} service calls timed inside {N_WORKER_ROUNDS} /listen, "
                     f"on {handler_threads}")
            cols["service_call_in_listen"] = in_server_ms
            r = out[conf] = {k: ms_summary(v) for k, v in cols.items()}
            one = r["evaluate_one_worker_thread"]["median_ms"]
            for k in ("listen_new_connection", "service_call_in_listen", "evaluate_new_thread_per_call"):
                r[f"{k}_over_one_worker"] = r[k]["median_ms"] / one
    first_push = {run: {"first_ms": r["push_ms_first_on_new_connection"],
                        "mid_run_ms": r["push_ms_on_new_connection_mid_run"],
                        "steady_median_ms": r["push_ms_steady_median"],
                        "first_over_steady": max(r["push_ms_first_on_new_connection"]) / r["push_ms_steady_median"],
                        "mid_run_over_steady": max(r["push_ms_on_new_connection_mid_run"]) / r["push_ms_steady_median"]}
                  for run, r in hub.items()}
    print(f"[worker_thread] {smi}: host ms, medians and p99 over {N_WORKER_ROUNDS} rounds of one /listen (a new "
          "connection), one GET /labels (a new connection) and one evaluate() per column: " + json.dumps(out))
    print(f"[worker_thread] {smi}: the hub's first push on each new connection against its steady push: "
          + json.dumps(first_push))
    return {"listen": out, "hub_first_push": first_push}


def latest_step(out_dir: str) -> dict:
    import torch

    name = max(f for f in os.listdir(out_dir) if re.fullmatch(r"step_\d+\.pt", f))
    return torch.load(os.path.join(out_dir, name), map_location="cpu", weights_only=True)


def phase_data_parallel(torch, dev, root, tmp, counters, single_acc, smi, A, arrays, aug, svc) -> dict:
    """25-26. Data parallel at world size 1 on NCCL: cli.train res8 as phase 10 with
    --coordinator / --num-processes 1 / --process-id 0, weights and accuracy against
    phase 10's run, launches; then, in a world-1 NCCL group, a step's host ms with
    and without the mesh, the NCCL all-reduce of a res8 gradient, dryrun_multichip(1),
    stream_file and a BatchStreamer with data_axis against their unsharded runs."""
    from honk_tpu_torch.cli.train import main as cli_main
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.models import SpeechResModel, find_config, init_weights
    from honk_tpu_torch.parallel import initialize_distributed, make_data_mesh, shutdown, world_size
    from honk_tpu_torch.parallel.dryrun import dryrun_multichip
    from honk_tpu_torch.stream import BatchStreamer, stream_file
    from honk_tpu_torch.train import create_train_state, make_optimizer
    from honk_tpu_torch.train.steps import make_train_step
    import torch.distributed as dist

    out_dir = os.path.join(tmp, "run-res8-nccl")
    argv = ["--type", "train", "--model", "res8", "--batch_size", str(TRAIN_BATCH), "--n_epochs", "2",
            "--dev_every", "1", "--data_dir", root, "--output_dir", out_dir,
            "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1", "--process-id", "0"]
    reset(counters)
    t0 = time.perf_counter()
    rc, log = run_cli(cli_main, argv)
    train_s = time.perf_counter() - t0
    launches = read(counters, bf16=True)
    by_mode = launches.by_mode
    if rc != 0 or dist.is_initialized():
        fail(f"cli.train on a world-1 NCCL group returned {rc} (group left open: {dist.is_initialized()})")
    acc = final_accuracy(log)
    single, nccl = latest_step(os.path.join(tmp, "run-res8")), latest_step(out_dir)
    weight_err = max(max_err(nccl["state"]["model"][k].float(), v.float())
                     for k, v in single["state"]["model"].items())
    bitwise = all(torch.equal(nccl["state"]["model"][k], v) for k, v in single["state"]["model"].items())
    if int(nccl["state"]["step"]) != int(single["state"]["step"]) or weight_err > 1e-6 or acc != single_acc:
        # What a second single-device run gives against the first: run-to-run noise of the card, or the mesh.
        again_dir = os.path.join(tmp, "run-res8-again")
        run_cli(cli_main, argv[: argv.index("--output_dir")] + ["--output_dir", again_dir])
        again = latest_step(again_dir)
        again_err = max(max_err(again["state"]["model"][k].float(), v.float())
                        for k, v in single["state"]["model"].items())
        fail(f"world-1 NCCL training against the single-device run: step {nccl['state']['step']} vs "
             f"{single['state']['step']}, weights max abs err {weight_err:.3e}, accuracy {acc} vs {single_acc}; "
             f"a second single-device run against the first: {again_err:.3e}")

    if by_mode != bf16_eval_modes(launches["res_stack"]):
        fail(f"cli.train on a world-1 NCCL group: res stack modes {by_mode}, expected the bf16-activation mode only")
    out = {"train_s": train_s, "launches": launches, "res_stack_by_mode": by_mode, "weights_max_abs_err": weight_err,
           "weights_bitwise": bitwise, "final_test_accuracy": acc}
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        if dist.get_backend() != "nccl" or world_size() != 1:
            fail(f"expected a world-1 NCCL group, got {dist.get_backend()} of {world_size()}")
        mesh = make_data_mesh(0, "data")
        # A train step's host time with and without the mesh (f32, B=64), in turns.
        model = init_weights(SpeechResModel(find_config("res8")), torch.Generator().manual_seed(SEED)).to(dev)
        tx = make_optimizer(lrs=(0.01,), boundaries=())
        state = create_train_state(model, tx)
        steps = {"single": make_train_step(tx, TRAIN_BATCH, aug), "mesh_world1": make_train_step(tx, TRAIN_BATCH, aug, mesh)}
        host = {k: [] for k in steps}
        for _ in range(2):
            for k in ("single", "mesh_world1", "mesh_world1", "single"):
                host[k].append(step_clocks(torch, lambda: steps[k](state, SEED, arrays), 50, 5)["step_wall"])
        out["step_host_ms"] = host
        prof = profile_steps(torch, lambda: steps["mesh_world1"](state, SEED, arrays), 10)
        out["step_nccl_kernels"] = [n for n, _ in prof["top_kernels_ms"] if "nccl" in n.lower()]
        # What one gradient all-reduce of res8 costs on NCCL at world size 1 (the step launches none).
        n_params = sum(p.numel() for p in model.parameters())
        grads = torch.ones(n_params, device=dev)
        dist.all_reduce(grads)  # the first collective sets up NCCL's communicator: not a step's cost
        torch.cuda.synchronize()
        ar = profile_steps(torch, lambda: dist.all_reduce(grads), 20, required=False)
        out["all_reduce"] = {"floats": n_params, "bytes": 4 * n_params, "device_ms": ar["device_ms"],
                             "host_ms": ar["profiled_wall_ms"], "kernels": ar["top_kernels_ms"][:2]}

        reset(counters)
        out["dryrun"] = dryrun_multichip(1)
        out["dryrun_launches"] = read(counters)

        cfg = StreamConfig(**STREAM_CFG)
        from honk_tpu_torch.cli.demo import synthesize_long_audio

        track, _ = synthesize_long_audio(list(STREAM_KEYWORDS), seconds=60, seed=7, gap_s=8.0, noise_amp=0.01)
        plain_sm, plain_ev = stream_file(svc.model, None, track, cfg, packed=svc._packed)
        reset(counters)
        dp_sm, dp_ev = stream_file(svc.model, None, track, cfg, data_axis="data", packed=svc._packed)
        out["stream_file_launches"] = read(counters)
        if not np.array_equal(dp_sm, plain_sm) or [(e.time_s, e.label) for e in dp_ev] != [
                (e.time_s, e.label) for e in plain_ev]:
            fail("stream_file(data_axis='data') at world size 1 differs from the unsharded run")
        chunks = hub_streams(track)[:, : 30 * CHUNK].reshape(HUB_SLOTS, 30, CHUNK).transpose(1, 0, 2)
        mask = np.arange(HUB_SLOTS) % 3 != 0
        posts = {}
        for ax in (None, "data"):
            bs = BatchStreamer(svc.model, None, HUB_SLOTS, cfg, CHUNK, data_axis=ax)
            st, rows = bs.reset(), []
            reset(counters)
            for t, c in enumerate(chunks):  # every other step masked, as the hub's ticks
                st, post = bs.process(st, c, mask if t % 2 else None)
                rows.append(post)
            posts[ax] = torch.stack(rows)
        out["batch_streamer_launches"] = read(counters)
        if not torch.equal(posts[None], posts["data"]):
            fail("BatchStreamer(data_axis='data') at world size 1 differs from the unsharded one")
    finally:
        shutdown()
    print(f"[data_parallel] {smi}: " + json.dumps(out))
    return out


def phase_shards(torch, dev, A, K, mfcc_kernel, res_kernel, arrays, aug, svc, smi) -> dict:
    """26. Each kernel on a rank's rows (2 and 4 ranks) against the same rows of the
    unsharded launch: assembly and MFCC bitwise, the res stack within RES_TOL."""
    from honk_tpu_torch.parallel import DataMesh

    b = TRAIN_BATCH
    gen = lambda: A.step_generator(SEED + 26, 0, dev)  # noqa: E731
    audio, _ = A.sample_train_batch(gen(), arrays, b, aug)
    with torch.inference_mode():
        feats = mfcc_kernel.mfcc(audio)
        pooled = svc.model.stem(feats)
        logits = res_kernel.res_stack(pooled, *svc._packed)
        out = {}
        for world in (2, 4):
            res_err = 0.0
            for r in range(world):
                s, e = DataMesh("data", r, world).shard_rows(b)
                a_r, _ = A.sample_train_batch(gen(), arrays, b, aug, (s, e))
                if not torch.equal(a_r, audio[s:e]):
                    fail(f"assemble on rank {r} of {world}: not the unsharded launch's rows")
                if not torch.equal(mfcc_kernel.mfcc(audio[s:e].contiguous()), feats[s:e]):
                    fail(f"mfcc on rank {r} of {world}: not the unsharded launch's rows")
                got = res_kernel.res_stack(pooled[s:e].contiguous(), *svc._packed)
                if not close(got, logits[s:e], **RES_TOL):
                    fail(f"res_stack on rank {r} of {world}: max abs err {max_err(got, logits[s:e]):.3e}")
                res_err = max(res_err, max_err(got, logits[s:e]))
            out[world] = {"assemble": "bitwise", "mfcc": "bitwise", "res_stack_max_abs_err": res_err}
    print(f"[shards] {smi}: B={b}, each rank's launch against the unsharded launch's rows: " + json.dumps(out))
    return out


def phase_profile_dir(torch, root, tmp, counters, smi) -> dict:
    """27. cli.train --profile-dir on the card: the traces name the three kernels and the annotate ranges."""
    from honk_tpu_torch.cli.train import main as cli_main

    prof_dir = os.path.join(tmp, "prof")
    rc, log = run_cli(cli_main, ["--type", "train", "--model", "res8", "--batch_size", str(TRAIN_BATCH),
                                 "--n_epochs", "1", "--data_dir", root, "--output_dir", os.path.join(tmp, "run-prof"),
                                 "--profile-dir", prof_dir])
    if rc != 0:
        fail(f"cli.train --profile-dir returned {rc}")
    out = {}
    for name, kernels, ranges in (("train_dispatch", ("assemble_kernel", "mfcc_kernel"),
                                   ("train_step", "assemble", "mfcc", "forward_backward", "update")),
                                  ("dev_eval", ("mfcc_kernel", "res_stack_kernel"), ("eval_batch",))):
        with open(os.path.join(prof_dir, f"{name}.rank0.pt.trace.json")) as f:
            events = json.load(f)["traceEvents"]
        gpu = [e for e in events if e.get("cat") == "kernel"]
        names = [e.get("name", "") for e in events]
        found = {k: sum(k in e["name"] for e in gpu) for k in kernels}
        found_ranges = {r: names.count(r) for r in ranges}
        if not all(found.values()) or not all(found_ranges.values()):
            fail(f"--profile-dir {name} trace: kernels {found}, ranges {found_ranges}")
        out[name] = {"kernels": found, "ranges": found_ranges, "device_kernels": len(gpu),
                     "device_ms": sum(e.get("dur", 0) for e in gpu) / 1e3}
    print(f"[profile_dir] {smi}: " + json.dumps(out))
    return out


def phase_native(torch, root, smi) -> dict:
    """28. The native WAV loader built with g++ here, against the Python reader, on the hard_v2 corpus."""
    from honk_tpu_torch.data import load_speech_commands
    from honk_tpu_torch.native import wavpack

    if not wavpack.available():
        fail("the native WAV loader is not available on this machine")
    built_this_run = wavpack.library_path().stat().st_mtime >= START_TIME
    with tempfile.TemporaryDirectory() as tmp:  # the build's time: the same g++ command once more
        t0 = time.perf_counter()
        subprocess.run(["g++", *wavpack.CXX_FLAGS, str(wavpack.SOURCE), "-o", os.path.join(tmp, "lib.so"),
                        "-lpthread"], check=True, capture_output=True, timeout=120)
        build_s = time.perf_counter() - t0
    times, loaded = {}, {}
    real = wavpack.load_files_packed
    for side in ("native", "python", "native_again"):
        wavpack.load_files_packed = real if side != "python" else (lambda *a, **k: None)
        try:
            t0 = time.perf_counter()
            loaded[side] = load_speech_commands(root, dev_pct=10, test_pct=80)
            times[side] = time.perf_counter() - t0
        finally:
            wavpack.load_files_packed = real
    for split in ("train", "dev", "test"):
        if not np.array_equal(getattr(loaded["native"], split).audio, getattr(loaded["python"], split).audio):
            fail(f"the native loader's {split} split differs from the Python reader's")
    n = sum(len(getattr(loaded["native"], s)) for s in ("train", "dev", "test"))
    out = {"built_this_run": built_this_run, "build_s": build_s, "clips": n, "load_s": times}
    print(f"[native] {smi}: " + json.dumps(out))
    return out


# ---- 29-31: the bf16 eval path (the res stack's bf16 mode) and the Orbax loader ----

def hub_over_http(torch, httpd, pcm, swap=None, counters=None, profile=False) -> dict:
    """Serve ``httpd`` (a hub behind make_handler) and drive it: a session per
    PCM16 stream, one /stream/push_bin a tick with every stream's chunk
    (posteriors asked), ``swap(base_url)`` before tick HUB_SWAP_TICK, then every
    close. With ``counters``, the launches over the ticks; with ``profile``,
    torch.profiler over 20 ticks from tick 100."""
    import http.client

    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    out: dict = {"answers": [], "tick_ms": []}
    try:
        sids = [post_json(f"{base}/stream/open", {})["stream_id"] for _ in range(pcm.shape[0])]
        header = json.dumps({"stream_ids": sids, "posterior": True}).encode()

        def tick(t):
            rows = pcm[:, t * CHUNK:(t + 1) * CHUNK].astype("<i2").tobytes()
            body = len(header).to_bytes(4, "little") + header + rows
            t0 = time.perf_counter()
            conn.request("POST", "/stream/push_bin", body, {"Content-Type": "application/octet-stream"})
            r = conn.getresponse()
            data = json.loads(r.read())
            out["tick_ms"].append((time.perf_counter() - t0) * 1e3)
            if r.status != 200:
                fail(f"hub over ranks: /stream/push_bin answered {r.status} {data}")
            out["answers"].append([data["results"][s] for s in sids])

        n_ticks = pcm.shape[1] // CHUNK
        if counters is not None:
            reset(counters)
        t = 0
        while t < n_ticks:
            if t == HUB_SWAP_TICK and swap is not None:
                out["swap"] = swap(base)
            if profile and t == 100:
                it = iter(range(t, t + 20))
                out["profile"] = profile_steps(torch, lambda: tick(next(it)), 20, required=False)
                t += 20
                continue
            tick(t)
            t += 1
        if counters is not None:
            out["launches"] = read(counters)
        out["closed"] = [post_json(f"{base}/stream/close", {"stream_id": s}) for s in sids]
    finally:
        conn.close()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    if th.is_alive():
        fail("hub over ranks: the server thread did not stop")
    return out


def served_gap(got: list, ref: list) -> tuple[float, float]:
    """Two runs' answers, tick by tick: the largest gap of the served posteriors and
    of the winning label's prob; raises if a label or an event differs."""
    post_gap = prob_gap = 0.0
    for t, (ga, ra) in enumerate(zip(got, ref, strict=True)):
        for a, r in zip(ga, ra, strict=True):
            if a["label"] != r["label"] or [(e["time_s"], e["label"]) for e in a["events"]] != [
                    (e["time_s"], e["label"]) for e in r["events"]]:
                fail(f"hub over ranks, tick {t}: {a['label']} {a['events']} != {r['label']} {r['events']}")
            post_gap = max(post_gap, float(np.abs(np.asarray(a["posterior"]) - r["posterior"]).max()))
            prob_gap = max(prob_gap, abs(a["prob"] - r["prob"]))
    return post_gap, prob_gap


def hub_ranks(torch, world: int, inputs: dict, backend: str = "gloo", scenario: str = "drive",
              timeout: float = 300) -> tuple[list[dict], float]:
    """scripts/chip_hub_ranks.py on ``world`` ranks of ``backend`` with ``inputs``: each rank's record, and the
    seconds from their start to the last one's exit."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, path)
        port = free_port()
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "scripts", "chip_hub_ranks.py"), str(r),
                                   str(world), str(port), path, outs[r], backend, scenario], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in procs:  # exact PIDs only
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        seconds = time.perf_counter() - t0
        if any(proc.returncode for proc in procs):
            fail(f"hub over {world} {backend} ranks: a rank failed:\n" + "\n".join(log[-3000:] for log in logs))
        ranks = []
        for o in outs:  # None for a rank that left without a record
            if os.path.exists(o):
                with open(o) as f:
                    ranks.append(json.load(f))
            else:
                ranks.append(None)
    return ranks, seconds


def check_hub_ranks(ranks: list[dict], ref_ticks: list, ref_closed: list, n_ticks: int, backend: str):
    """Rank 0's answers within RANKS_ATOL of the world-1 hub's with the same events, and every rank on
    ``backend`` with its block of the slots and one mfcc and one float32 res stack a tick; the two gaps."""
    world = len(ranks)
    post_gap, prob_gap = served_gap(ranks[0]["ticks"], ref_ticks)
    if prob_gap > RANKS_ATOL or post_gap > RANKS_ATOL + 1e-6:
        fail(f"hub over {world} ranks against world size 1: prob {prob_gap:.3e}, posteriors {post_gap:.3e}")
    for a, r in zip(ranks[0]["closed"], ref_closed, strict=True):
        if [(e["time_s"], e["label"]) for e in a["events"]] != [(e["time_s"], e["label"]) for e in r["events"]]:
            fail(f"hub over {world} ranks: closed with {a['events']}, world size 1 {r['events']}")
    block = -(-HUB_SLOTS // world)
    for r, rk in enumerate(ranks):
        want = {"mfcc": n_ticks, "res_stack": n_ticks}
        if rk["backend"] != backend or rk["rows"] != [r * block, min((r + 1) * block, HUB_SLOTS)] or {
                k: rk["launches"][k] for k in want} != want or rk["launches"]["res_stack_by_mode"]["float32"] != n_ticks:
            fail(f"hub over {world} ranks, rank {r}: {rk['backend']}, rows {rk['rows']}, launched "
                 f"{rk['launches']}: expected {backend}, its block, one mfcc and one float32 res stack a tick")
    return post_gap, prob_gap


def phase_hub_ranks(torch, counters, smi) -> dict:
    """32. The stream hub sharded over ranks (see the module docstring)."""
    from http.server import ThreadingHTTPServer

    from honk_tpu_torch.cli.demo import synthesize_long_audio
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.parallel import broadcast_bytes, initialize_distributed, shutdown, world_size
    from honk_tpu_torch.serve import LabelService, StreamHub, TrainingService
    from honk_tpu_torch.serve.http import make_handler
    import torch.distributed as dist

    t_phase = time.perf_counter()
    cfg = StreamConfig(**STREAM_CFG)
    track, positions = synthesize_long_audio(list(STREAM_KEYWORDS), seconds=60, seed=7, gap_s=8.0, noise_amp=0.01)
    if max(t for t, _ in positions) + 1.0 > HUB_SWAP_TICK * CHUNK / 16000:
        fail(f"hub over ranks: a keyword is planted after the swap at tick {HUB_SWAP_TICK}: {positions}")
    pcm = hub_streams(track)
    n_ticks = pcm.shape[1] // CHUNK
    pos = personalize_positives()
    b64 = lambda a: base64.b64encode(a.tobytes()).decode()  # noqa: E731
    out: dict = {"smi": smi, "ticks": n_ticks}

    def hub_of(svc, axis):
        return StreamHub(svc, HUB_SLOTS, cfg, CHUNK, data_axis=axis, coalesce_ms=2.0, wire_dtype="int16")

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        if dist.get_backend() != "nccl" or world_size() != 1:
            fail(f"expected a world-1 NCCL group, got {dist.get_backend()} of {world_size()}")
        # The int16 wire's chunks cross NCCL as bytes: NCCL has no 16-bit integer type.
        x = torch.from_numpy(pcm[:, :CHUNK].copy()).cuda()
        try:
            dist.broadcast(x.clone(), src=0)
            out["nccl_raw_int16"] = "accepted"
        except (RuntimeError, TypeError) as e:
            out["nccl_raw_int16"] = f"refused: {str(e)[:200]}"
        if not torch.equal(broadcast_bytes(x.clone()), x):
            fail("broadcast_bytes of an int16 tensor on NCCL changed it")

        # The sharded hub with POST /train before tick HUB_SWAP_TICK: the main path.
        svc = LabelService("res8", CHECKPOINT)
        trainer = TrainingService(svc, learning_rate=PERSONALIZE_LR)

        def train(base):
            t0 = time.perf_counter()
            code, answer = request_status(f"{base}/train", {"positives": [b64(p) for p in pos],
                                                            "label": PERSONALIZE_LABEL})
            if code != 200:
                fail(f"hub over ranks: POST /train answered {code} {answer}")
            return {"code": code, "train_ms": (time.perf_counter() - t0) * 1e3, **answer}

        hub = hub_of(svc, "data")
        sharded = hub_over_http(torch, ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc, trainer, hub)), pcm,
                                train, counters, profile=True)
        new_sd = {k: v.detach().clone() for k, v in svc.model.state_dict().items()}
    finally:
        shutdown()

    # The unsharded hub on the same ticks, given the same new weights at the same tick, and without them.
    ref_svc = LabelService("res8", CHECKPOINT)
    ref_hub = hub_of(ref_svc, None)

    def swap(base):
        ref_svc.set_variables(new_sd)
        ref_hub.set_variables(new_sd)

    unsharded = hub_over_http(torch, ThreadingHTTPServer(("127.0.0.1", 0), make_handler(ref_svc, None, ref_hub)),
                              pcm, swap)
    plain_svc = LabelService("res8", CHECKPOINT)
    plain_hub = hub_of(plain_svc, None)
    no_swap = hub_over_http(torch, ThreadingHTTPServer(("127.0.0.1", 0), make_handler(plain_svc, None, plain_hub)), pcm)
    # The unsharded hub driven as rank 0 drives it below (push_rows, no HTTP): the host ms that part compares with.
    direct_hub = hub_of(LabelService("res8", CHECKPOINT), None)
    direct_sids = [direct_hub.open() for _ in range(HUB_SLOTS)]
    direct = {"answers": [], "tick_ms": []}
    for t in range(n_ticks):
        if t == HUB_SWAP_TICK:
            direct_hub.set_variables(new_sd)
        t0 = time.perf_counter()
        res = direct_hub.push_rows(direct_sids, pcm[:, t * CHUNK:(t + 1) * CHUNK])
        direct["tick_ms"].append((time.perf_counter() - t0) * 1e3)
        direct["answers"].append([res[s] for s in direct_sids])
    for h in (hub, ref_hub, plain_hub, direct_hub):
        h.shutdown()
    if served_gap(direct["answers"], sharded["answers"]) != (0.0, 0.0):
        fail("hub over ranks: push_rows on the unsharded hub differs from the world-1 hub's /stream/push_bin")

    if sharded["answers"] != unsharded["answers"] or sharded["closed"] != unsharded["closed"]:
        fail("hub over ranks: the world-1 NCCL hub with data_axis differs from the unsharded hub")
    if sharded["answers"][:HUB_SWAP_TICK] != no_swap["answers"][:HUB_SWAP_TICK]:
        fail("hub over ranks: before the swap, the ticks differ from the hub without it")
    swap_gap = max(float(np.abs(np.asarray(a["posterior"]) - b["posterior"]).max())
                   for a, b in zip(sharded["answers"][HUB_SWAP_TICK], no_swap["answers"][HUB_SWAP_TICK]))
    if swap_gap <= 1e-4:
        fail(f"hub over ranks: the /train swap did not show on tick {HUB_SWAP_TICK} (gap {swap_gap:.3e})")
    # Before the swap: the planted keywords on the track's session, nothing on the noise sessions (and so over
    # the whole track without the swap). After it, the personalized model's events, equal to the unsharded hub's.
    for what, answers in (("before the swap", sharded["answers"][:HUB_SWAP_TICK]), ("without it", no_swap["answers"])):
        fired = [[(e["time_s"], e["label"]) for a in answers for e in a[i]["events"]] for i in range(HUB_SLOTS)]
        if len(fired[0]) != len(positions) or any(
                lab != w or abs(ts - t) > 0.25 for (ts, lab), (t, w) in zip(fired[0], positions)):
            fail(f"hub over ranks, {what}: the track session's events {fired[0]}, planted {positions}")
        if any(fired[1:]):
            fail(f"hub over ranks, {what}: false alarms on the noise sessions: {fired[1:]}")
    planted = fired[0]
    after_swap = sum(len(c["events"]) for c in sharded["closed"]) - len(planted)
    launches = sharded["launches"]
    if dict(launches) != {"mfcc": n_ticks + 1, "res_stack": n_ticks, "assemble": 0} or launches.by_mode[
            "float32"] != n_ticks:
        fail(f"hub over ranks: launched {launches} ({launches.by_mode}) over {n_ticks} ticks and one /train: "
             f"expected one mfcc and one float32 res stack a tick, and /train's one mfcc")
    prof = sharded["profile"]
    out.update({
        "launches": launches, "track_events": planted, "swap": sharded["swap"], "swap_tick_gap": swap_gap,
        "events_after_swap": after_swap,
        "host_ms_per_tick": {k: ms_summary(r["tick_ms"]) for k, r in (
            ("data_axis_nccl_world1", sharded), ("unsharded", unsharded), ("unsharded_no_swap", no_swap),
            ("unsharded_push_rows", direct))},
        "device_ms_per_tick": prof["device_ms"], "device_kernels_per_tick": prof["device_kernels_per_step"],
        "device_idle_share": prof["device_idle_share"], "top_kernels_ms": prof["top_kernels_ms"][:4],
    })

    # The same hub over HUB_RANKS gloo ranks on the card, against world size 1.
    ranks, ranks_s = hub_ranks(torch, HUB_RANKS, {
        "checkpoint": CHECKPOINT, "pcm": pcm, "chunk": CHUNK, "n_slots": HUB_SLOTS, "cfg": STREAM_CFG,
        "swap_at": HUB_SWAP_TICK, "swap": {k: v.cpu() for k, v in new_sd.items()}})
    post_gap, prob_gap = check_hub_ranks(ranks, sharded["answers"], sharded["closed"], n_ticks, "gloo")
    out["gloo_ranks"] = {
        "ranks": HUB_RANKS, "s": ranks_s, "posterior_max_abs_err": post_gap,
        "prob_max_abs_err": prob_gap, "launches": [rk["launches"] for rk in ranks],
        "rows": [rk["rows"] for rk in ranks],
        "rank0_host_ms_per_tick": ms_summary(ranks[0]["tick_ms"]),
    }
    out["s"] = time.perf_counter() - t_phase
    print(f"[hub_ranks] {smi}: " + json.dumps(out))
    return out


def decisive_argmax_equal(got, ref, margin: float) -> tuple[bool, int, int]:
    """Whether argmax agrees on every row whose reference top-two margin exceeds
    ``margin`` (a near tie inside the logit gate may go either way), and how many
    rows are inside it and how many of all rows differ."""
    top2 = ref.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > margin
    same = got.argmax(-1) == ref.argmax(-1)
    return bool(same[decisive].all()), int((~decisive).sum()), int((~same).sum())


def row_reading(got, ref, gate) -> dict:
    """Each row's largest logit gap, read as ``gate`` holds it."""
    gaps = (got - ref).abs().amax(dim=-1)
    return {"median": float(gaps.median()), "tail_share": float((gaps > gate[1]).float().mean()),
            "max": float(gaps.max())}


def first_layers(packed, depth: int) -> tuple:
    """The res stack's operands cut to its first ``depth`` layers."""
    w_all, bn_scale, bn_offset, dense_w, dense_b = packed
    return (w_all[:depth].contiguous(), bn_scale[:depth].contiguous(), bn_offset[:depth].contiguous(),
            dense_w, dense_b)


def bf16_faults(torch, x, w_all, bn_scale, bn_offset, dense_w, dense_b) -> dict:
    """The plain bf16 stack with each fault the bf16 mode could have, on the bf16
    operands of ``pack_res_params(model, bfloat16)``: float32 activations (the
    3xTF32 mode launched under the bf16 label), activations truncated to bf16
    instead of rounded to nearest even, and the Dense's mean left unrounded."""
    F = torch.nn.functional

    def rne(t):
        return t.to(torch.bfloat16).float()

    def trunc(t):
        return (t.view(torch.int32) & -65536).view(torch.float32)

    def stack(act, mean):
        C, old, h = x.shape[1], x, x
        for i in range(w_all.shape[0]):
            y = F.relu(F.conv2d(act(h), w_all[i].reshape(3, 3, C, C).permute(3, 2, 0, 1), padding=1))
            if (i + 1) % 2 == 0:
                y = y + old
                old = y
            h = y * bn_scale[i, :, None, None] + bn_offset[i, :, None, None]
        return mean(h.mean(dim=(2, 3))) @ dense_w + dense_b

    def same(t):
        return t

    return {"float32_operands": stack(same, same), "truncated": stack(trunc, trunc), "mean_unrounded": stack(rne, same)}


def flow_faults(torch, x, w_all, bn_scale, bn_offset, dense_w, dense_b) -> dict:
    """The plain stack with each fault the bf16-activation mode could have, on the
    operands of ``pack_res_params(model, bfloat16, bfloat16)`` (bf16 conv weights,
    a float32 Dense): the Pallas flow (the bf16 mode's float32 activations and
    bf16 Dense), float32 activations with flax's float32 Dense, and flax's bf16
    activations with the Dense's operands rounded to bf16."""
    F = torch.nn.functional

    def rne(t):
        return t.to(torch.bfloat16).float()

    def same(t):
        return t

    def stack(act, dense):
        C, old, h = x.shape[1], x, x
        for i in range(w_all.shape[0]):
            y = F.relu(act(F.conv2d(rne(h), w_all[i].reshape(3, 3, C, C).permute(3, 2, 0, 1), padding=1)))
            if (i + 1) % 2 == 0:
                y = act(y + old)
                old = y
            h = act(y * bn_scale[i, :, None, None] + bn_offset[i, :, None, None])
        return dense(h.mean(dim=(2, 3))) @ dense(dense_w) + dense_b

    return {"pallas_flow": stack(same, rne), "float32_activations": stack(same, same), "bf16_dense": stack(rne, rne)}


def stem_faults(torch, feats, conv0_w, pool, mode: str) -> dict:
    """The pooled maps of each fault the stem inside the kernel could have in the
    bf16 ``mode`` (res_forward), where res_kernel.stem_plain is the mode's
    stem. ``bfloat16_activations`` (flax's bf16 flow): the float32 stem of the
    other modes, conv0 on float32 features and weights (its sum still rounded
    to bf16), and the pool's window summed in float32 and rounded once (not
    after each add). ``bfloat16`` (the fused forward's float32 stem): flax's
    bf16 stem."""
    from honk_tpu_torch.ops import res_kernel

    F = torch.nn.functional
    bf16, (ph, pw) = torch.bfloat16, pool
    if mode == "bfloat16":
        return {"bf16_stem": res_kernel.stem_plain(feats, conv0_w, pool, bf16)}

    def pooled(y, chained: bool):
        if chained:
            return res_kernel.chained_avg_pool(y, pool).float().contiguous()
        b, c, h, w = y.shape
        v = y.float()[:, :, : h // ph * ph, : w // pw * pw].reshape(b, c, h // ph, ph, w // pw, pw)
        return (v.sum(dim=(3, 5)).to(bf16) / (ph * pw)).float().contiguous()

    conv_bf16 = F.relu(F.conv2d(feats[:, None].to(bf16), conv0_w.to(bf16), padding=1))
    conv_f32 = F.relu(F.conv2d(feats[:, None], conv0_w, padding=1).to(bf16))
    return {"float32_stem": res_kernel.stem_plain(feats, conv0_w, pool, torch.float32),
            "conv0_float32": pooled(conv_f32, True), "pool_rounded_once": pooled(conv_bf16, False)}


def refuses(reading: dict, fault: dict, gate) -> bool:
    """Whether ``gate`` tells the kernel's row ``reading`` from a ``fault``'s: the
    fault's median past the gate's median limit and BF16_NEARER times the kernel's."""
    return fault["median"] > max(gate[0], BF16_NEARER * reading["median"])


def check_rows(what: str, reading: dict, faults: dict, gate, refuse_faults: bool = True) -> None:
    """The kernel's row reading within ``gate``, and (``refuse_faults``) each
    fault refused (``refuses``): the gate tells the kernel from each fault."""
    median, tail, share = gate
    if reading["median"] > median or reading["tail_share"] > share or reading["max"] > BF16_OUTER:
        fail(f"{what}: row gaps {reading} past the gate (median {median}, share {share} past {tail}, "
             f"max {BF16_OUTER})")
    for fault, r in faults.items() if refuse_faults else ():
        if not refuses(reading, r, gate):
            fail(f"{what}: the gate cannot tell the kernel (median row gap {reading['median']:.3e}) from its "
                 f"{fault} fault (median {r['median']:.3e})")


def bf16_res8(torch, dev, checkpoint: str = CHECKPOINT):
    """res8 of ``checkpoint`` built with dtype=bfloat16 (a bf16 training run's
    model), in eval mode on ``dev``."""
    from honk_tpu_torch.models import SpeechResModel, find_config, load_honk_checkpoint

    model = SpeechResModel(find_config("res8"), dtype=torch.bfloat16)
    return load_honk_checkpoint(checkpoint, model).to(dev).eval()


def bf16_modes(torch) -> dict:
    """Each bf16 mode of the res stack: (operand dtype, activation dtype, gates on the
    whole stack and on its first BF16_DEPTH layers, the faults its gate must refuse)."""
    bf16, f32 = torch.bfloat16, torch.float32
    return {"bfloat16": (bf16, f32, (BF16_KERNEL_ROWS, BF16_KERNEL_ROWS), bf16_faults),
            "bfloat16_activations": (bf16, bf16, (BF16_FLOW_ROWS, BF16_FLOW_LAYER_ROWS), flow_faults)}


def check_bf16_case(torch, res_kernel, mode: str, label: str, x, p16, tag: str = "bf16_kernel",
                    refuse_faults: bool = True, forward: tuple | None = None, run_faults: bool = True,
                    stem: dict | None = None) -> tuple:
    """The res stack's bf16 ``mode`` against its plain version on the pooled ``x``
    and operands ``p16``, by rows beside its faults (check_rows) on its first
    BF16_DEPTH layers, and on the whole stack from BF16_FULL_ROWS rows; argmax
    equal outside BF16_OUTER of a tie. With ``forward`` = (features, conv0
    weights, pool), the entry from the features (res_forward, the stem inside)
    against res_forward_plain, ``x`` being the plain stem's output that the
    faults run on; ``run_faults=False`` runs none (nor refuses them). ``stem``
    (stem_faults' pooled maps) runs the plain stack of the mode on each, and
    each must be refused (``refuses``) by the whole stack's gate or by the
    first layers' one. Returns (the reading, rows whose argmax differs, near
    ties, the kernel's logits, the plain version's)."""
    compute, act, gates, faults_of = bf16_modes(torch)[mode]
    b = x.shape[0]
    what = f"res_{'forward' if forward else 'stack'} {mode} mode against its plain version, {label}"
    check = {}
    for (part, p), gate in zip((("full", p16), (f"first_{BF16_DEPTH}_layers", first_layers(p16, BF16_DEPTH))), gates):
        if forward is None:
            got = res_kernel.res_stack(x, *p, compute_dtype=compute, activation_dtype=act)
            ref = res_kernel.res_stack_plain(x, *p, compute_dtype=compute, activation_dtype=act)
        else:
            got = res_kernel.res_forward(*forward, *p, compute_dtype=compute, activation_dtype=act)
            ref = res_kernel.res_forward_plain(*forward, *p, compute_dtype=compute, activation_dtype=act)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{what}, {part}: shape {tuple(got.shape)} or non-finite values")
        reading = row_reading(got, ref, gate)
        faults = {k: row_reading(v, ref, gate) for k, v in faults_of(torch, x, *p).items()} if run_faults else {}
        check[part] = {"rows": reading, "faults": faults}
        if stem:
            check[part]["stem_faults"] = {k: row_reading(res_kernel.res_stack_plain(
                v, *p, compute_dtype=compute, activation_dtype=act), ref, gate) for k, v in stem.items()}
            for r in check[part]["stem_faults"].values():
                r["refused"] = refuses(reading, r, gate)
        print(f"[{tag}] {mode} {label} {part}: kernel row gaps {reading}; faults' {faults}; stem faults' "
              f"{check[part].get('stem_faults')}")
        if part != "full" or b >= BF16_FULL_ROWS:
            check_rows(f"{what}, {part}", reading, faults, gate, refuse_faults and bool(faults))
        elif reading["max"] > BF16_OUTER:
            fail(f"{what}: max abs err {reading['max']:.3e} past {BF16_OUTER}")
        if part == "full":
            full, full_ref = got, ref
    for k in stem or ():
        if not any(c["stem_faults"][k]["refused"] for c in check.values()):
            fail(f"{what}: neither gate tells the kernel from its stem's {k} fault: "
                 + json.dumps({part: (c["rows"], c["stem_faults"][k]) for part, c in check.items()}))
    decisive, near, differ = decisive_argmax_equal(full, full_ref, BF16_OUTER)
    if not decisive:
        fail(f"{what}: argmax differs on {differ} rows ({near} within {BF16_OUTER} of a tie)")
    return check, differ, near, full, full_ref


def phase_bf16_kernel(torch, dev, res_kernel, mfcc_kernel, logs, name, smi) -> dict:
    """29. The res stack's two bf16 modes against their plain versions, each held by
    rows beside its faults (check_rows) on its first BF16_DEPTH layers, and on the
    whole stack from BF16_FULL_ROWS rows. The bf16 mode (the TPU kernel's):
    zoo/res8.pt at B = 1, 3, 8, 256 and 2,996 on its bf16 stem, random res8-narrow,
    res26 and res26-narrow weights at B = 1 and 3, faults bf16_faults. The
    bf16-activation mode (flax's flow, the bf16 eval forward's): zoo/res8.pt at
    BF16_FLOW_BATCHES, the random models at B = 1 and 3, faults flow_faults.
    Argmax against the f32 mode on the same input; geometry, ptxas, CUDA-event
    times beside the f32 mode's and the bound."""
    from honk_tpu_torch.models import SpeechResModel, find_config

    bf16 = torch.bfloat16
    rng = np.random.default_rng(SEED + 29)
    audio = torch.from_numpy((rng.standard_normal((BF16_BATCHES[-1], 16000)) * 0.2).astype(np.float32)).to(dev)
    model = bf16_res8(torch, dev)
    out = {"ptxas": [ln for ln in ptxas_summary(logs.get("res_stack", "")) if "Bf16" in ln or "bf16" in ln],
           "checks": {}, "flow_checks": {}, "times": {}, "flow_times": {}}
    modes = bf16_modes(torch)
    with torch.inference_mode():
        pooled = model.stem(mfcc_kernel.mfcc(audio), bf16)
        packs = {"bfloat16": res_kernel.pack_res_params(model, bf16), "bfloat16_activations": model.eval_operands()}
        packed32 = res_kernel.pack_res_params(model)
        cases = [("bfloat16", "res8", b, pooled[:b].contiguous(), packs["bfloat16"], packed32) for b in BF16_BATCHES]
        cases += [("bfloat16_activations", "res8", b, pooled[:b].contiguous(), packs["bfloat16_activations"],
                   packed32) for b in BF16_FLOW_BATCHES]
        for conf in ("res8-narrow", "res26", "res26-narrow"):
            torch.manual_seed(SEED)
            m = SpeechResModel(find_config(conf), dtype=bf16)
            for i in range(1, m.n_layers + 1):
                bn = getattr(m, f"bn{i}")
                bn.running_mean.normal_(0, 0.1)
                bn.running_var.uniform_(0.5, 1.0)
            m = m.to(dev).eval()
            p_m = m.stem(mfcc_kernel.mfcc(audio[:3]), bf16)
            cases += [(mode, conf, b, p_m[:b].contiguous(), res_kernel.pack_res_params(m, bf16, act),
                       res_kernel.pack_res_params(m))
                      for mode, (_, act, _, _) in modes.items() for b in (1, 3)]
        res8_err = {mode: 0.0 for mode in modes}
        for mode, conf, b, x, p16, p32 in cases:
            check, differ, near, full, _ = check_bf16_case(torch, res_kernel, mode, f"{conf} B={b}", x, p16)
            mode32 = res_kernel.res_stack(x, *p32)
            out["checks" if mode == "bfloat16" else "flow_checks"][f"{conf} B={b}"] = {
                "max_abs_err": check["full"]["rows"]["max"], **check,
                "argmax_differs_plain": differ, "near_ties": near,
                "argmax_equal_f32_mode": float((full.argmax(-1) == mode32.argmax(-1)).float().mean()),
                "max_abs_diff_f32_mode": max_err(full, mode32), "geometry": res_kernel.geometry(x, bf16)}
            if conf == "res8":
                res8_err[mode] = max(res8_err[mode], check["full"]["rows"]["max"])
        C, H, W = pooled.shape[1:]
        L, n_lab = packed32[0].shape[0], packed32[3].shape[1]
        for mode, key, batches in (("bfloat16", "times", (1, 8, BATCH, BF16_BATCHES[-1])),
                                   ("bfloat16_activations", "flow_times", BF16_FLOW_BATCHES)):
            compute, act = modes[mode][:2]
            p = packs[mode]
            for b in batches:
                x = pooled[:b].contiguous()
                iters = 200 if b <= 8 else 20 if b <= BATCH else 5
                t = {"ms": time_ms(torch, lambda: res_kernel.res_stack(x, *p, compute_dtype=compute,
                                                                       activation_dtype=act), iters),
                     "f32_mode_ms": time_ms(torch, lambda: res_kernel.res_stack(x, *packed32), iters),
                     "plain_ms": time_ms(torch, lambda: res_kernel.res_stack_plain(x, *p, compute_dtype=compute,
                                                                                   activation_dtype=act), iters)}
                t["bound_ms"], t["bound_by"] = bound(*res_work(b, C, H, W, L, n_lab, mode), name, bf16=True)
                t["f32_mode_bound_ms"], _ = bound(*res_work(b, C, H, W, L, n_lab), name, tf32x3=True)
                out[key][b] = t
    out["res8_max_abs_err"], out["flow_res8_max_abs_err"] = res8_err["bfloat16"], res8_err["bfloat16_activations"]
    print(f"[bf16_kernel] {smi}: the res stack's bf16 modes against their plain versions (per row, on the first "
          f"{BF16_DEPTH} layers at every shape and on the whole stack from B={BF16_FULL_ROWS}: median gap, share of "
          f"rows past the tail gap (bf16 mode {BF16_KERNEL_ROWS}, bf16-activation mode {BF16_FLOW_ROWS}, on its "
          f"first layers {BF16_FLOW_LAYER_ROWS}), each "
          f"fault's median past {BF16_NEARER}x the kernel's; every gap within {BF16_OUTER}; argmax equal outside "
          f"{BF16_OUTER} of a tie): " + json.dumps(out))
    return out


def phase_bf16_eval(torch, dev, counters, hard_v2_root, train_runs, smi) -> dict:
    """30. The bf16 eval path through its entry points: the training CLI's sweeps
    (phases 10 and 15, read by mode), then make_forward of a bf16 res8 at B=256
    on the card against the same forward on the CPU, and its times beside the f32
    forward's; then the TPU kernel's fused forward (res_forward_fused: the float32
    stem and the bf16 mode) on the same clips, cuda against the CPU."""
    from honk_tpu_torch.data import load_speech_commands
    from honk_tpu_torch.frontend import compute_mfccs
    from honk_tpu_torch.ops.res_kernel import res_forward_fused
    from honk_tpu_torch.train.steps import make_forward

    for conf, by_mode in train_runs.items():
        want = by_mode["bfloat16_activations"] if uses_res_stack(conf) else 0
        if by_mode != bf16_eval_modes(want) or (uses_res_stack(conf) and not want):
            fail(f"cli.train {conf}: res stack modes {by_mode} in its dev and test sweeps")
    ds = load_speech_commands(hard_v2_root, dev_pct=10, test_pct=80)
    clips = torch.from_numpy(ds.test.audio[:BATCH].astype(np.float32) / 32768.0)
    labels = torch.from_numpy(np.asarray(ds.test.labels[:BATCH], np.int64))
    ckpt = os.path.join(HARD_V2, "res8.pt")
    forward = make_forward()
    models = {"bfloat16": bf16_res8(torch, dev, ckpt), "cpu": bf16_res8(torch, torch.device("cpu"), ckpt)}
    from honk_tpu_torch.models import SpeechResModel, find_config, load_honk_checkpoint

    models["float32"] = load_honk_checkpoint(ckpt, SpeechResModel(find_config("res8"))).to(dev).eval()
    a = clips.to(dev)
    reset(counters)
    got = forward(models["bfloat16"], a)
    torch.cuda.synchronize()
    launches = read(counters, bf16=True)
    by_mode = launches.by_mode
    if launches != {"assemble": 0, "mfcc": 1, "res_stack": 1} or by_mode != bf16_eval_modes(1):
        fail(f"make_forward of a bf16 res8 launched {launches}, res stack modes {by_mode}")
    got = got.cpu()
    ref = forward(models["cpu"], clips)
    f32 = forward(models["float32"], a).cpu()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"make_forward bf16 res8: shape {tuple(got.shape)} or non-finite values")
    reading = row_reading(got, ref, BF16_FORWARD_ROWS)
    faults = {"float32_forward": row_reading(f32, ref, BF16_FORWARD_ROWS)}
    print(f"[bf16_eval] make_forward cuda vs cpu row gaps {reading}; the float32 forward's {faults}")
    check_rows("make_forward bf16 res8 cuda vs cpu", reading, faults, BF16_FORWARD_ROWS)
    decisive, near, differ = decisive_argmax_equal(got, ref, BF16_OUTER)
    if not decisive:
        fail(f"make_forward bf16 res8 cuda vs cpu: argmax differs on {differ} rows ({near} within {BF16_OUTER} "
             "of a tie)")
    out = {"launches": launches, "res_stack_by_mode": by_mode, "cuda_vs_cpu_max_abs_err": reading["max"],
           "rows": reading, "faults": faults,
           "argmax_differs": differ, "near_ties": near, "max_abs_diff_f32_forward": max_err(got, f32),
           "acc": {"bfloat16": float((got.argmax(-1) == labels).float().mean()),
                   "float32": float((f32.argmax(-1) == labels).float().mean())},
           "train_cli_res_stack_by_mode": train_runs, "times": {}}
    # The TPU kernel's fused forward (its public entry point; bf16 operands by default): the bf16 mode alone.
    reset(counters)
    fused = res_forward_fused(models["float32"], compute_mfccs(a))
    torch.cuda.synchronize()
    fused_launches = read(counters, bf16=True)
    if fused_launches != {"assemble": 0, "mfcc": 1, "res_stack": 1} or fused_launches.by_mode != {
            "float32": 0, "bfloat16": 1, "bfloat16_activations": 0}:
        fail(f"res_forward_fused of res8 launched {fused_launches}, res stack modes {fused_launches.by_mode}")
    fused = fused.cpu()
    fused_ref = res_forward_fused(load_honk_checkpoint(ckpt, SpeechResModel(find_config("res8"))).eval(),
                                  compute_mfccs(clips))
    fused_reading = row_reading(fused, fused_ref, BF16_FORWARD_ROWS)
    fused_faults = {"float32_forward": row_reading(f32, fused_ref, BF16_FORWARD_ROWS)}
    print(f"[bf16_eval] res_forward_fused cuda vs cpu row gaps {fused_reading}; the float32 forward's {fused_faults}")
    check_rows("res_forward_fused res8 cuda vs cpu", fused_reading, fused_faults, BF16_FORWARD_ROWS)
    out["fused"] = {"launches": fused_launches, "res_stack_by_mode": fused_launches.by_mode, "rows": fused_reading,
                    "faults": fused_faults, "max_abs_diff_make_forward": max_err(fused, got)}
    with torch.inference_mode():
        for k in ("float32", "bfloat16", "bfloat16", "float32"):  # in turns
            t = out["times"].setdefault(k, {"events_ms": [], "wall_ms": [], "profiler_device_ms": []})
            t["events_ms"].append(time_ms(torch, lambda: forward(models[k], a), 20))
            clocks = step_clocks(torch, lambda: forward(models[k], a), 20, 5)
            t["wall_ms"].append(clocks["step_wall"])
            t["profiler_device_ms"].append(clocks["device_ms"])
            t["top_kernels_ms"] = clocks["top_kernels_ms"]
    print(f"[bf16_eval] {smi}: make_forward B={BATCH} on the first {BATCH} hard_v2 test clips, "
          f"zoo_hard_v2/res8.pt; logits cuda vs cpu held by rows {BF16_FORWARD_ROWS} against the float32 forward: "
          + json.dumps(out))
    return out


def recipe_ranges() -> dict:
    """Each recipe model's accuracy range: the JAX package's seeds 0-2
    (runs/seed_variance_r04.json) widened by 2 SE of the MANIFEST's test split."""
    with open(os.path.join(ROOT, "runs", "seed_variance_r04.json")) as f:
        seeds = json.load(f)["per_seed"]
    se = hard_v2_manifest()["models"]["res8"]["test_acc_se"]
    return {m: (min(r[m] for r in seeds) - 2 * se, max(r[m] for r in seeds) + 2 * se) for m in RECIPE_MODELS}


def phase_recipe(torch, counters, root, tmp, smi, seed: int = 0, compute_dtype: str | None = None,
                 gate: bool = True) -> dict:
    """34. The recipe's accuracy: ``python -m honk_tpu_torch.cli.zoo build`` trains
    RECIPE_MODELS on the hard_v2 corpus at ``root`` at zoo_hard_v2's recipe (its
    MANIFEST: 26 epochs, B=64, bf16, the lr ladder at 220 / 440, dev 10 %, test
    80 %) from ``seed``, with exact launch counts (the sweeps of a bf16 res8 in
    the bf16-activation mode), then ``cli.zoo compare --against zoo_hard_v2``
    scores both in float32 and pairs them with each other and with the committed
    vectors. With ``gate``, each test_acc_recheck lies in recipe_ranges() and
    res15 beats res8 (McNemar z > 0). ``compute_dtype`` overrides the recipe's."""
    from honk_tpu_torch.cli.zoo import main as zoo_main
    from honk_tpu_torch.data import load_speech_commands

    recipe = hard_v2_manifest()["models"]["res8"]["recipe"]
    dtype = compute_dtype or recipe["compute_dtype"]
    split = ["--dev_pct", str(recipe["dev_pct"]), "--test_pct", str(recipe["test_pct"])]
    flags = ["--n_epochs", str(recipe["n_epochs"]), "--batch_size", str(recipe["batch_size"]), "--seed", str(seed),
             "--compute_dtype", dtype, "--lr", *map(str, recipe["lr"]), "--schedule", *map(str, recipe["schedule"]),
             "--data_dir", root, *split]
    ds = load_speech_commands(root, dev_pct=recipe["dev_pct"], test_pct=recipe["test_pct"])
    n_train, b, eval_b = len(ds.train), recipe["batch_size"], 256
    steps = recipe["n_epochs"] * math.ceil((n_train + int(0.1 * n_train)) / b)
    evals = recipe["n_epochs"] * math.ceil(len(ds.dev) / eval_b) + math.ceil(len(ds.test) / eval_b)
    zoo_dir = os.path.join(tmp, f"zoo_recipe_seed{seed}_{dtype}")
    out = {"seed": seed, "compute_dtype": dtype, "models": {}}
    for name in RECIPE_MODELS:
        reset(counters)
        t0 = time.perf_counter()
        rc, _ = run_cli(zoo_main, ["build", zoo_dir, "--models", name, *flags])
        wall = time.perf_counter() - t0
        launches = read(counters, bf16=dtype == "bfloat16")
        n_res = evals if uses_res_stack(name) else 0
        by_mode = bf16_eval_modes(n_res) if dtype == "bfloat16" else {"float32": n_res, "bfloat16": 0,
                                                                        "bfloat16_activations": 0}
        if rc != 0:
            fail(f"cli.zoo build {name} returned {rc}")
        if launches != {"assemble": steps, "mfcc": steps + evals, "res_stack": n_res} or launches.by_mode != by_mode:
            fail(f"cli.zoo build {name}: launched {launches} ({launches.by_mode}), expected {steps} steps, "
                 f"{evals} eval batches, res stack {by_mode}")
        out["models"][name] = {"wall_s": wall, "launches": launches, "res_stack_by_mode": launches.by_mode}
    n_test = math.ceil(len(ds.test) / eval_b)
    reset(counters)
    rc, _ = run_cli(zoo_main, ["compare", zoo_dir, "--data_dir", root, *split, "--against", HARD_V2])
    launches = read(counters)
    want = {"assemble": 0, "mfcc": n_test * len(RECIPE_MODELS), "res_stack": n_test * sum(map(uses_res_stack,
                                                                                                RECIPE_MODELS))}
    if rc != 0 or launches != want:
        fail(f"cli.zoo compare returned {rc}, launched {launches}: expected {want}")
    with open(os.path.join(zoo_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    ranges = recipe_ranges()
    for name, m in out["models"].items():
        e = manifest["models"][name]
        m.update(test_acc=e["test_acc"], test_acc_recheck=e["test_acc_recheck"], test_acc_se=e["test_acc_se"],
                 jax_range=ranges[name], against=manifest["against_stats"]["pairwise"][name])
        m["in_range"] = ranges[name][0] <= e["test_acc_recheck"] <= ranges[name][1]
    pair = manifest["ladder_stats"]["pairwise"]["_vs_".join(RECIPE_MODELS)]
    out.update(z_res15_over_res8=-pair["mcnemar_z"], pair=pair, compare_launches=launches)
    print(f"[recipe] {smi}: cli.zoo build {' '.join(RECIPE_MODELS)} at zoo_hard_v2's recipe, seed {seed}, {dtype} "
          f"({steps} steps, {evals} eval batches a model), then compare --against zoo_hard_v2: " + json.dumps(out))
    if gate:
        for name, m in out["models"].items():
            if not m["in_range"]:
                fail(f"recipe {name} seed {seed}: test_acc_recheck {m['test_acc_recheck']} outside the JAX "
                     f"package's seeds widened by 2 SE, {ranges[name]}")
        if not out["z_res15_over_res8"] > 0:
            fail(f"recipe seed {seed}: res15 over res8 McNemar z {out['z_res15_over_res8']}, not > 0")
    return out


SCALING_KEYS = ["n_devices", "global_batch", "step_ms", "audio_s_per_s", "scaling_efficiency_vs_1"]


def phase_scaling(torch, counters, step_times, smi) -> dict:
    """35. ``python -m honk_tpu_torch.cli.scaling 1`` on the card: scaling_bench's row, launches exact
    (assembly and MFCC once a step, no res stack), its step beside phase 11's float32 step at B=64."""
    from honk_tpu_torch.cli import scaling

    knobs = scaling.settings(torch.device("cuda"))
    steps = (1 + scaling.REPS) * (knobs["scan_short"] + knobs["scan_long"])
    reset(counters)
    t0 = time.perf_counter()
    rc, out = run_cli(scaling.main, ["1"])
    wall = time.perf_counter() - t0
    launches = read(counters)
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    if rc != 0 or len(rows) != 1 or list(rows[0]) != SCALING_KEYS or rows[0]["n_devices"] != 1:
        fail(f"cli.scaling 1 returned {rc}, printed {out!r}: expected one row with scaling_bench's keys")
    row = rows[0]
    if not (math.isfinite(row["step_ms"]) and row["step_ms"] > 0 and row["scaling_efficiency_vs_1"] == 1.0):
        fail(f"cli.scaling 1: {row}")
    if launches != {"assemble": steps, "mfcc": steps, "res_stack": 0}:
        fail(f"cli.scaling 1 launched {launches}: expected {steps} assemble and mfcc, no res stack")
    f32 = step_times["float32"]
    result = {"row": row, "knobs": knobs, "launches": launches, "wall_s": wall, "host_cores": os.cpu_count(),
              "phase11_f32_step_b64": {"cuda_event_ms": f32["step"], "host_ms": f32["step_wall"]}}
    print(f"[scaling] {smi}: " + json.dumps(result))
    return result


BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "infer_audio_s_per_s", "train_audio_s_per_s",
              "infer_spread", "train_spread", "batch", "scan_lens", "infer_scan_lens", "model", "device",
              "implied_tflops", "suspect"]
STREAM_KEYS = ["model", "n_streams", "chunk_samples", "step_ms", "audio_s_per_s", "realtime_streams_capacity",
               "device"]
SERVE_KEYS = ["metric", "value", "unit", "device_only_streams", "host_share", "payload", "pipelined", "inflight",
              "wire_dtype", "coalesce_ms", "dispatches", "chunks_per_dispatch", "slots", "gateways",
              "chunk_samples", "seconds", "total_chunks", "model", "checkpoint", "device", "note"]
BENCH_SMOKE = {"BENCH_REPS": "3", "BENCH_SCAN_SHORT": "8", "BENCH_SCAN_LONG": "32"}  # phase 37's knobs
SERVE_SMOKE_S = 10


def tool_row(what: str, rc: int, out: str, keys: list) -> dict:
    """A tool's one JSON line, which must carry exactly the reference tool's keys."""
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    if rc != 0 or len(rows) != 1 or list(rows[0]) != keys:
        fail(f"{what} returned {rc}, printed {out[-2000:]!r}: expected one line with the reference's keys")
    return rows[0]


def phase_tools(torch, counters, smi) -> dict:
    """36-39. The measuring tools on the card, each with its launches counted from 0."""
    from honk_tpu_torch import graft_entry
    from honk_tpu_torch.cli import bench, bench_serve, bench_stream

    name = torch.cuda.get_device_name(0)
    out = {}
    # 36. entry(): the res8 float32 forward, cuda against the CPU.
    fn, (model, audio) = graft_entry.entry()
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    reset(counters)
    got = fn(model, audio)
    torch.cuda.synchronize()
    launches = read(counters)
    err = max_err(got.cpu(), cpu_fn(*cpu_args))
    if got.shape != (8, 12) or not torch.isfinite(got).all() or err > LOGIT_ATOL:
        fail(f"entry(): shape {tuple(got.shape)}, max abs err against the CPU {err:.3e} (gate {LOGIT_ATOL})")
    if launches != {"mfcc": 1, "res_stack": 1, "assemble": 0} or launches.by_mode["float32"] != 1:
        fail(f"entry() launched {launches} ({launches.by_mode}): expected one MFCC and one float32 res stack")
    out["entry"] = {"max_abs_err": err, "launches": launches, "by_mode": launches.by_mode}
    print(f"[entry] {smi}: " + json.dumps(out["entry"]))
    del fn, model, audio

    # 37. cli.bench at shortened knobs.
    with mock.patch.dict(os.environ, BENCH_SMOKE):
        knobs = bench.settings()
        reset(counters)
        t0 = time.perf_counter()
        rc, text = run_cli(bench.main, [])
        wall = time.perf_counter() - t0
        launches = read(counters, bf16=True)
    torch.cuda.empty_cache()  # the 2,048-clip pool and the corpus go before the next phase
    row = tool_row("cli.bench", rc, text, BENCH_KEYS)
    (ts, tl), (i_s, i_l), reps = knobs["scan_lens"], knobs["infer_scan_lens"], knobs["reps"]
    infer_links, train_links = (1 + reps) * (i_s + i_l), (1 + reps) * (ts + tl)
    rates = (row["infer_audio_s_per_s"], row["train_audio_s_per_s"])
    if not all(math.isfinite(r) and r > 0 for r in rates) or row["suspect"] or row["device"] != name:
        fail(f"cli.bench: {row}")
    want = {"mfcc": infer_links + train_links, "res_stack": infer_links, "assemble": train_links}
    if launches != want or launches.by_mode != bf16_eval_modes(infer_links):
        fail(f"cli.bench launched {launches} ({launches.by_mode}) over {infer_links} inference and {train_links} "
             f"train links: expected {want}, the res stack in its bf16-activation mode only")
    out["bench"] = {"row": row, "launches": launches, "by_mode": launches.by_mode, "infer_links": infer_links,
                    "train_links": train_links, "wall_s": wall}
    print(f"[bench] {smi}: " + json.dumps(out["bench"]))

    # 38. cli.bench_stream at 256 streams.
    knobs = bench_stream.settings()
    reset(counters)
    t0 = time.perf_counter()
    rc, text = run_cli(bench_stream.main, [])
    wall = time.perf_counter() - t0
    launches = read(counters, bf16=True)
    row = tool_row("cli.bench_stream", rc, text, STREAM_KEYS)
    ls, ll = bench_stream.CHAINS
    steps = (1 + knobs["reps"]) * (ls + ll)
    if row["n_streams"] != 256 or not (math.isfinite(row["step_ms"]) and row["step_ms"] > 0):
        fail(f"cli.bench_stream: {row}")
    if launches != {"mfcc": steps, "res_stack": steps, "assemble": 0} or launches.by_mode != bf16_eval_modes(steps):
        fail(f"cli.bench_stream launched {launches} ({launches.by_mode}) over {steps} steps: expected one causal "
             "MFCC and one bf16-activation res stack a step")
    out["bench_stream"] = {"row": row, "launches": launches, "by_mode": launches.by_mode, "steps": steps,
                           "wall_s": wall}
    print(f"[bench_stream] {smi}: " + json.dumps(out["bench_stream"]))

    # 39. cli.bench_serve for SERVE_SMOKE_S at 64 slots and 4 gateways.
    reset(counters)
    t0 = time.perf_counter()
    rc, text = run_cli(bench_serve.main, ["--seconds", str(SERVE_SMOKE_S), "--checkpoint",
                                          os.path.join(HARD_V2, "res8.pt")])
    wall = time.perf_counter() - t0
    launches = read(counters)
    row = tool_row("cli.bench_serve", rc, text, SERVE_KEYS)
    n = 3 + bench_serve.DEVICE_ITERS + row["dispatches"]  # the device-only loop's steps, then the hub's
    if row["slots"] != 64 or row["gateways"] != 4 or row["total_chunks"] <= 0 or row["total_chunks"] % 16:
        fail(f"cli.bench_serve: {row}")
    if launches != {"mfcc": n, "res_stack": n, "assemble": 0}:
        fail(f"cli.bench_serve launched {launches}: expected {n} MFCC and float32 res stack, one a slab step")
    out["bench_serve"] = {"row": row, "launches": launches, "by_mode": launches.by_mode, "wall_s": wall}
    print(f"[bench_serve] {smi}: " + json.dumps(out["bench_serve"]))
    return out


# Phases 40-49: the reference's repo-level tools, each at short knobs.
RK_KEYS = ["model", "batch", "xla_ms_per_batch", "fused_ms_per_batch", "xla_audio_s_per_s", "fused_audio_s_per_s",
           "speedup_fused_over_xla", "compile_s", "device"]
RES15_KEYS = ["batch", "device", "conv45_fwd_ms_by_dilation", "conv45_fwdbwd_ms_by_dilation",
              "conv45_fwdbwd_implied_tflops_by_dilation", "conv_fwd_ms_by_maps_d1", "bn_residual_ms", "res15_fwd_ms",
              "res15_train_step_ms", "conv45_implied_tflops_by_dilation", "res15_train_implied_tflops"]
PARTS_KEYS = ["batch", "device", "full_grad_train_bn_ms", "full_grad_eval_bn_ms", "convstack13_grad_ms"]
DISPATCH_KEYS = ["batch", "model", "device", "scan_carry_ms_per_step", "step_dispatch_ms_per_step",
                 "auto_layout_nondefault_leaves", "auto_layout_total_leaves", "step_dispatch_auto_layout_ms_per_step",
                 "speedup_step_vs_scan", "speedup_auto_vs_scan", "train_audio_s_per_s_scan",
                 "train_audio_s_per_s_step", "train_audio_s_per_s_auto"]
PROBE_KEYS = {"generated": ["variant", "generated_s"],
              "epoch": ["variant", "model", "epoch", "loss", "train_acc", "dev_acc", "wall_s"],
              "summary": ["variant", "model", "knobs", "dev_curve", "final_dev", "best_dev"]}
MICRO_LINE = re.compile(r"^ *(\S+): +(\d+\.\d{3}) ms/batch +[\d,]+ audio-s/s$")
FWD_LINE = re.compile(r"^(\w+): (\d+\.\d{3}) ms/iter \(\d+ audio-s/s\)$")
TRAIN_LINE = re.compile(r"^(\w+): B=(\d+) per-step (\d+\.\d{3}) ms -> [\d,]+ audio-s/s$")
PROFILE_SMOKE = {"micro_batch": 256, "train_batch": 256, "micro_chains": (20, 60), "rk": {"RK_BATCH": "256", "RK_REPS": "1"},
                 "res15": ["--batch", "256", "--reps", "1", "--short", "2", "--long", "4"],
                 "probe": ["--epochs", "1", "--batch", "64", "--clips_per_word", "20", "--n_speakers", "10"],
                 "corpus": ["--hard", "--clips_per_word", "2", "--n_speakers", "2"]}


def zero() -> dict:
    return {"mfcc": 0, "res_stack": 0, "assemble": 0}


class LegLaunches:
    """Each ``cli.bench.marginal`` call's launches (one leg each), read through
    ``bench.LEG_HOOKS`` as differences while the tool runs after one ``reset``."""

    def __init__(self, counters, bench):
        self.counters, self.bench, self.legs = counters, bench, []

    def hook(self, phase: str, lens: tuple[int, int], reps: int) -> None:
        if phase == "begin":
            self.before = Launches(self.counters)
            return
        after = Launches(self.counters)
        self.legs.append({"links": (1 + reps) * (lens[0] + lens[1]),
                          "launches": {k: after[k] - self.before[k] for k in after},
                          "by_mode": {m: after.by_mode[m] - self.before.by_mode[m] for m in after.by_mode}})

    def __enter__(self):
        reset(self.counters)
        self.bench.LEG_HOOKS.append(self.hook)
        return self

    def __exit__(self, *exc):
        self.bench.LEG_HOOKS.remove(self.hook)

    def check(self, what: str, want: list[tuple[str, dict, dict]]) -> dict:
        """Each leg's launches against ``want``: (label, launches a link, res-stack launches a link by mode)."""
        if len(self.legs) != len(want):
            fail(f"{what}: {len(self.legs)} timed legs, expected {len(want)}")
        out = {}
        for (label, per_link, modes), leg in zip(want, self.legs):
            n = leg["links"]
            expect = {k: v * n for k, v in {**zero(), **per_link}.items()}
            expect_modes = {m: modes.get(m, 0) * n for m in leg["by_mode"]}
            if leg["launches"] != expect or leg["by_mode"] != expect_modes:
                fail(f"{what} {label}: {leg['launches']} ({leg['by_mode']}) over {n} links, expected {expect} "
                     f"({expect_modes})")
            out[label] = leg
        return out


def check_row(what: str, row: dict, times: list) -> None:
    if not times or not all(t is not None and math.isfinite(t) and t > 0 for t in times):
        fail(f"{what}: times not finite and positive: {row}")


def phase_profile_tools(torch, counters, tmp, smi) -> dict:
    """40-49. The reference's last repo-level tools, each leg's launches counted from 0,
    then each kernel they launched against its plain version at their shapes."""
    from honk_tpu_torch.cli import (bench, bench_res_kernel, hard_probe, make_corpus, microbench, prof_fwd,
                                    prof_res15, prof_res15_dispatch, prof_res15_parts, prof_train)
    from honk_tpu_torch.data import load_speech_commands

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    out = {"t0": time.perf_counter(), "paths": {}}
    res_f32, res_bf16, res_act = {"float32": 1}, {"bfloat16": 1}, {"bfloat16_activations": 1}

    def run(tool, mod, argv, env=None, patches=()):
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, env or {}), contextlib.ExitStack() as stack:
            for target, attr, value in patches:
                stack.enter_context(mock.patch.object(target, attr, value))
            legs = stack.enter_context(LegLaunches(counters, bench))
            rc, text = run_cli(mod.main, argv)
            total = read(counters, bf16=True)
        torch.cuda.empty_cache()
        if rc != 0:
            fail(f"{tool} {argv} returned {rc}: {text[-2000:]}")
        out["paths"]["tool_" + tool.removeprefix("cli.").replace(" ", "_")] = total
        return legs, total, text, time.perf_counter() - t0

    # 40. cli.microbench (scripts/tpu_microbench.py), float32 res8.
    B = PROFILE_SMOKE["micro_batch"]
    legs, total, text, wall = run("cli.microbench", microbench, [str(B)],
                                  patches=[(microbench, "CHAINS", PROFILE_SMOKE["micro_chains"])])
    lines = [MICRO_LINE.match(line) for line in text.splitlines()]
    labels = ["frontend_jnp", "frontend_pallas", "res8_model_only", "res8_full_fwd"]
    if not all(lines) or [m.group(1) for m in lines] != labels:
        fail(f"cli.microbench printed {text!r}: expected the reference's four lines")
    ms = {m.group(1): float(m.group(2)) for m in lines}
    check_row("cli.microbench", ms, list(ms.values()))
    out["microbench"] = {"batch": B, "ms": ms, "launches": total, "wall_s": wall, "legs": legs.check("cli.microbench", [
        ("frontend_jnp", {}, {}), ("frontend_pallas", {"mfcc": 1}, {}), ("res8_model_only", {"res_stack": 1}, res_f32),
        ("res8_full_fwd", {"mfcc": 1, "res_stack": 1}, res_f32)])}
    print(f"[microbench] {smi}: " + json.dumps(out["microbench"]))

    # 41. cli.bench_res_kernel (scripts/bench_res_kernel.py), bf16 res8; the fused leg against the cuDNN leg.
    legs, total, text, wall = run("cli.bench_res_kernel", bench_res_kernel, [], env=PROFILE_SMOKE["rk"],
                                  patches=[(bench_res_kernel, "CHAINS", (8, 32))])
    text_lines = text.splitlines()
    if len(text_lines) != 2 or not text_lines[0].startswith("model_eval_ms_per_batch: "):
        fail(f"cli.bench_res_kernel printed {text!r}")
    row = tool_row("cli.bench_res_kernel", 0, text_lines[1], RK_KEYS)
    check_row("cli.bench_res_kernel", row, [row["xla_ms_per_batch"], row["fused_ms_per_batch"]])
    if row["device"] != name or row["batch"] != int(PROFILE_SMOKE["rk"]["RK_BATCH"]):
        fail(f"cli.bench_res_kernel: {row}")
    rk_legs = legs.check("cli.bench_res_kernel", [("model", {"res_stack": 1}, res_act), ("xla", {}, {}),
                                                  ("fused", {"res_stack": 1}, res_bf16)])
    model = bench.make_model("res8", torch.bfloat16, dev)
    forwards = bench_res_kernel.make_forwards(model)
    feats = bench_res_kernel.make_pool(row["batch"], dev)[:row["batch"]].contiguous()
    with torch.no_grad():
        got = {leg: fn(feats) for leg, fn in forwards.items()}
    torch.cuda.synchronize()
    err = max_err(got["fused"], got["xla"])
    decisive, near, differ = decisive_argmax_equal(got["fused"], got["xla"], BF16_OUTER)
    if not close(got["fused"], got["xla"], BF16_OUTER, BF16_OUTER) or not decisive:
        fail(f"res_forward_fused against the cuDNN bf16 forward: max abs err {err:.3e} (atol and rtol {BF16_OUTER}), "
             f"argmax differs on {differ} rows ({near} within {BF16_OUTER} of a tie)")
    out["bench_res_kernel"] = {
        "row": row, "model_ms": float(text_lines[0].split()[1]), "launches": total, "wall_s": wall, "legs": rk_legs,
        "fused_vs_xla": {"max_abs_err": err, "rows": row_reading(got["fused"], got["xla"], BF16_FLOW_ROWS),
                         "near_ties": near, "argmax_differ": differ},
        "model_vs_xla": {"max_abs_err": max_err(got["model"], got["xla"]),
                         "rows": row_reading(got["model"], got["xla"], BF16_FLOW_ROWS)}}
    print(f"[bench_res_kernel] {smi}: " + json.dumps(out["bench_res_kernel"]))
    del model, forwards, feats, got

    # 42. cli.hard_probe (scripts/hard_probe.py): one epoch of a bf16 res8 on a small hard corpus.
    root = os.path.join(tmp, "hard_probe")
    reset(counters)
    t0 = time.perf_counter()
    rc, text = run_cli(hard_probe.main, PROFILE_SMOKE["probe"] + ["--root", root])
    wall = time.perf_counter() - t0
    total = read(counters, bf16=True)
    rows = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    if rc != 0 or [list(r) for r in rows] != [PROBE_KEYS[k] for k in ("generated", "epoch", "summary")]:
        fail(f"cli.hard_probe returned {rc}, printed {text[-2000:]!r}")
    ds = load_speech_commands(root + "_0")
    steps = -(-(len(ds.train) + int(0.1 * len(ds.train))) // 64)
    sweeps = -(-len(ds.dev) // 256)
    want = {"mfcc": steps + sweeps, "res_stack": sweeps, "assemble": steps}
    if total != want or total.by_mode != bf16_eval_modes(sweeps) or not math.isfinite(rows[1]["loss"]):
        fail(f"cli.hard_probe launched {total} ({total.by_mode}) over {steps} steps and {sweeps} dev batches: "
             f"expected {want}, the res stack in its bf16-activation mode; {rows}")
    out["paths"]["tool_hard_probe"] = total
    out["hard_probe"] = {"rows": rows, "launches": total, "by_mode": total.by_mode, "steps": steps,
                         "dev_batches": sweeps, "wall_s": wall}
    print(f"[hard_probe] {smi}: " + json.dumps(out["hard_probe"]))

    # 43. cli.make_corpus (scripts/make_corpus.py): host work, no launch.
    root = os.path.join(tmp, "make_corpus")
    reset(counters)
    rc, text = run_cli(make_corpus.main, [root] + PROFILE_SMOKE["corpus"])
    total = read(counters)
    with open(os.path.join(root, "CORPUS.json")) as f:
        recipe = json.load(f)
    if rc != 0 or [json.loads(line) for line in text.splitlines()] != [recipe] or total != zero():
        fail(f"cli.make_corpus returned {rc}, printed {text!r}, launched {total}")
    out["paths"]["tool_make_corpus"] = total
    out["make_corpus"] = {"recipe": recipe, "launches": total}
    print(f"[make_corpus] {smi}: " + json.dumps(out["make_corpus"]))

    # 44. cli.prof_fwd (prof_fwd2.py), every leg at its defaults (float32 res8, B=1024).
    out["prof_fwd"] = {}
    per_leg = {"xla": ({}, {}), "pmfcc": ({"mfcc": 1}, {}), "mk": ({"res_stack": 1}, res_bf16),
               "mfcc_only": ({}, {}), "pmfcc_only": ({"mfcc": 1}, {})}
    for leg, (per_link, modes) in per_leg.items():
        legs, total, text, wall = run(f"cli.prof_fwd {leg}", prof_fwd, [leg])
        m = FWD_LINE.match(text.splitlines()[-1])
        if not m or m.group(1) != leg or len(text.splitlines()) != 6:
            fail(f"cli.prof_fwd {leg} printed {text!r}")
        check_row(f"cli.prof_fwd {leg}", {}, [float(m.group(2))])
        out["prof_fwd"][leg] = {"ms": float(m.group(2)), "wall_s": wall,
                                **legs.check(f"cli.prof_fwd {leg}", [(leg, per_link, modes)])[leg]}
    print(f"[prof_fwd] {smi}: " + json.dumps(out["prof_fwd"]))

    # 45. cli.prof_train (prof_train.py), every leg at its defaults (bf16 res8, B=256).
    out["prof_train"] = {}
    per_leg = {"full": {"assemble": 1, "mfcc": 1}, "noaug": {"mfcc": 1}, "fwdbwd": {}, "aug": {"assemble": 1},
               "frontend": {"mfcc": 1}}
    for leg, per_link in per_leg.items():
        legs, total, text, wall = run(f"cli.prof_train {leg}", prof_train, [leg, str(PROFILE_SMOKE["train_batch"])])
        m = TRAIN_LINE.match(text.splitlines()[-1])
        if not m or m.group(1) != leg or m.group(2) != str(PROFILE_SMOKE["train_batch"]):
            fail(f"cli.prof_train {leg} printed {text!r}")
        check_row(f"cli.prof_train {leg}", {}, [float(m.group(3))])
        out["prof_train"][leg] = {"ms": float(m.group(3)), "wall_s": wall,
                                  **legs.check(f"cli.prof_train {leg}", [(leg, per_link, {})])[leg]}
    print(f"[prof_train] {smi}: " + json.dumps(out["prof_train"]))

    # 46-48. The res15 probes (scripts/prof_res15{,_parts,_dispatch}.py) at B=256, short chains.
    step = ("train_step", {"assemble": 1, "mfcc": 1}, {})
    probes = (
        ("prof_res15", prof_res15, RES15_KEYS,
         [(f"conv{k}_d{d}", {}, {}) for k in ("_fwd", "_fwdbwd") for d in (1, 2, 4, 8, 16)]
         + [(f"conv_fwd_maps{c}", {}, {}) for c in (45, 64, 128)] + [("bn", {}, {}), ("res15_fwd", {}, {}), step]),
        ("prof_res15_parts", prof_res15_parts, PARTS_KEYS, [("train_bn", {}, {}), ("eval_bn", {}, {}), ("stack", {}, {})]),
        ("prof_res15_dispatch", prof_res15_dispatch, DISPATCH_KEYS, [("scan", *step[1:]), ("step", *step[1:])]),
    )
    for tool, mod, keys, want in probes:
        legs, total, text, wall = run(f"cli.{tool}", mod, PROFILE_SMOKE["res15"])
        row = tool_row(f"cli.{tool}", 0, text, keys)
        times = [v for k, v in row.items() if k.endswith("_ms") or k.endswith("_per_step")]
        times += [t for k, v in row.items() if k.endswith(("_by_dilation", "_d1")) and "tflops" not in k
                  for t in v.values()]
        check_row(f"cli.{tool}", row, [t for t in times if t is not None])
        if row["device"] != name or row["batch"] != int(PROFILE_SMOKE["res15"][1]):
            fail(f"cli.{tool}: {row}")
        out[tool] = {"row": row, "launches": total, "wall_s": wall, "legs": legs.check(f"cli.{tool}", want)}
        print(f"[{tool}] {smi}: " + json.dumps(out[tool]))
    # 49. Each kernel the tools launched, against its plain version at the tools' shapes.
    out["kernels_at_tool_shapes"] = phase_tool_kernels(torch, dev, smi)
    out["s"] = time.perf_counter() - out.pop("t0")
    return out


def phase_tool_kernels(torch, dev, smi) -> dict:
    """49. Each kernel that phases 40-48 launch, against its plain version on the
    tool's own inputs at the tool's shapes. The MFCC on microbench's audio
    (PROFILE_SMOKE's B=256), prof_train's fixed audio (B=256) and prof_fwd's
    (B=1,024), at MFCC_TOL. The res stack's float32 mode on microbench's res8 at
    B=256, behind its model_only features and its full forward's MFCCs, at
    RES_TOL. Its bfloat16 mode on res_forward_fused's stems, bench_res_kernel's
    bf16 res8 (B=256) and prof_fwd's mk leg (B=1,024); its bfloat16_activations
    mode on bench_res_kernel's model(feats) (B=256): each as phase 29 holds it
    (check_bf16_case), by phase 29's row limits. Their faults' readings are
    printed but not required past the gate: on the tools' seeded weights the
    logits are small and a fault's gap may lie inside it; phase 29 shows on
    zoo/res8.pt that the gate refuses each fault. The assembly on the draws of prof_train's corpus and of
    the res15 probes' (B=256, their first step's key), within ASSEMBLE_ATOL.
    hard_probe runs phase 10's shapes (B=64 steps, dev sweeps of 256)."""
    from honk_tpu_torch.cli import bench, bench_res_kernel, microbench, prof_fwd, prof_res15, prof_train
    from honk_tpu_torch.data import augment as A
    from honk_tpu_torch.ops import assemble_kernel, mfcc_kernel, res_kernel

    bf16, f32 = torch.bfloat16, torch.float32
    B, rk_b = PROFILE_SMOKE["micro_batch"], int(PROFILE_SMOKE["rk"]["RK_BATCH"])
    out = {"mfcc": {}, "res_stack": {}, "res_stack[bf16]": {}, "res_stack[bf16_activations]": {}, "assemble": {}}
    t0 = time.perf_counter()
    with torch.inference_mode():
        micro_audio, micro_feats = microbench.make_inputs(B, dev)
        train = prof_train.make_setup("res8", bf16, PROFILE_SMOKE["train_batch"], dev)
        fwd_audio = prof_fwd.make_audio(prof_fwd.BATCH, dev)
        for label, a in ((f"microbench B={B}", micro_audio), (f"prof_train B={PROFILE_SMOKE['train_batch']}",
                                                             train["fixed_audio"]),
                         (f"prof_fwd B={prof_fwd.BATCH}", fwd_audio)):
            got, ref = mfcc_kernel.mfcc(a), mfcc_kernel.mfcc_plain(a)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            if got.shape != (a.shape[0], 101, 40) or not torch.isfinite(got).all() or not close(got, ref, **MFCC_TOL):
                fail(f"mfcc kernel on {label}'s audio: shape {tuple(got.shape)}, max abs err {err:.3e}")
            out["mfcc"][label] = err

        model = bench.make_model("res8", f32, dev).eval()
        packed = model.eval_operands()
        for label, f in ((f"microbench model_only B={B}", micro_feats),
                         (f"microbench full_fwd B={B}", mfcc_kernel.mfcc(micro_audio))):
            x = model.stem(f)
            got, ref = res_kernel.res_stack(x, *packed), res_kernel.res_stack_plain(x, *packed)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            if not torch.isfinite(got).all() or not close(got, ref, **RES_TOL):
                fail(f"res_stack kernel on {label}: max abs err {err:.3e}")
            out["res_stack"][label] = err

        rk = bench.make_model("res8", bf16, dev).eval()
        rk_feats = bench_res_kernel.make_pool(rk_b, dev)[:rk_b].contiguous()
        cases = [("bfloat16", f"bench_res_kernel fused B={rk_b}", rk.stem(rk_feats), res_kernel.pack_res_params(rk, bf16)),
                 ("bfloat16", f"prof_fwd mk B={prof_fwd.BATCH}", model.stem(mfcc_kernel.mfcc_plain(fwd_audio)),
                  res_kernel.pack_res_params(model, bf16)),
                 ("bfloat16_activations", f"bench_res_kernel model B={rk_b}", rk.stem(rk_feats, bf16),
                  rk.eval_operands())]
        for mode, label, x, p in cases:
            check, differ, near, _, _ = check_bf16_case(torch, res_kernel, mode, label, x, p, tag="tool_kernels",
                                                         refuse_faults=False)
            key = "res_stack[bf16]" if mode == "bfloat16" else "res_stack[bf16_activations]"
            out[key][label] = {"max_abs_err": check["full"]["rows"]["max"], **check, "argmax_differs_plain": differ,
                               "near_ties": near}

        b15 = int(PROFILE_SMOKE["res15"][1])
        aug15, arrays15 = prof_res15.train_inputs(np.random.default_rng(0), b15, dev)
        for label, arrays, aug, key, b in (
                (f"prof_train B={train['batch']}", train["arrays"], train["aug"], prof_train.KEY, train["batch"]),
                (f"prof_res15 train_step B={b15}", arrays15, aug15, prof_res15.KEY, b15)):
            draws = A.draw_batch(A.step_generator(key, 0, dev), arrays, b, aug)
            *ops, _ = A.kernel_operands(draws, arrays, aug)
            got = assemble_kernel.assemble(arrays.pool, arrays.noise, *ops)
            ref = assemble_kernel.assemble_plain(arrays.pool, arrays.noise, *ops)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            if got.shape != (b, 16000) or not torch.isfinite(got).all() or err > ASSEMBLE_ATOL:
                fail(f"assemble kernel on {label}'s draws: shape {tuple(got.shape)}, max abs err {err:.3e}")
            out["assemble"][label] = {"max_abs_err": err, "bitwise_equal": bool(torch.equal(got, ref))}
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"[tool_kernels] {smi}: each kernel against its plain version at the tools' shapes (mfcc atol/rtol "
          f"{MFCC_TOL['atol']}, float32 res stack {RES_TOL}, bf16 modes by rows as phase 29, assemble atol "
          f"{ASSEMBLE_ATOL}): " + json.dumps(out))
    return out


# Phase 50: the res stack with the stem inside (res_forward: the features to the
# logits in one launch) against its plain version at each batch of RF_BATCHES (a
# /listen, a hub tick, an eval batch, a bench batch, a 10 min track's windows)
# for res8 and res26, and the narrow models at RF_NARROW_BATCH: float32 at
# RES_TOL, the bf16 modes by phase 29's row gates (check_bf16_case), their faults
# and their stem's (stem_faults) refused on zoo/res8.pt at BF16_FULL_ROWS rows.
RF_BATCHES = (1, 8, 256, 1024, 2996)
RF_NARROW_BATCH = 256


def forward_work(b: int, C: int, H: int, W: int, L: int, n_lab: int, ph: int, pw: int,
                 mode: str = "float32") -> tuple[float, float, float]:
    """(conv0's operations, the stack's operations, bytes) of the forward from the
    features at batch ``b`` in ``mode``: conv0 over the H*ph x W*pw pixels the
    pool reads; the convs' products and the Dense layer; the features, conv0's
    and BN's float32 values, the conv and Dense weights at weight_bytes, the logits."""
    conv_b, dense_b = weight_bytes(mode)
    conv0 = 2 * b * H * ph * W * pw * 9 * C
    stack = 2 * b * L * H * W * 9 * C * C + 2 * b * C * n_lab
    nbytes = (4 * (b * 101 * 40 + 9 * C + 2 * L * C + n_lab + b * n_lab) + conv_b * L * 9 * C * C
              + dense_b * C * n_lab)
    return conv0, stack, nbytes


def forward_bound(b: int, C: int, H: int, W: int, L: int, n_lab: int, pool, name: str,
                  mode: str) -> tuple[float, str]:
    """Least time in ms of the forward from the features: conv0 at the float32
    CUDA-core rate plus the stack at the mode's tensor-core rate (3xTF32: three
    products a product; bf16: one), or the bytes over HBM, the larger."""
    f32, tf32, bf, hbm = peaks(name)
    conv0, stack, nbytes = forward_work(b, C, H, W, L, n_lab, *pool, mode)
    t_ops = (conv0 / f32 + (3 * stack / tf32 if mode == "float32" else stack / bf)) * 1e3
    t_bytes = nbytes / hbm * 1e3
    return (t_bytes, "bytes") if t_ops < t_bytes else (t_ops, "operations")


def forward_models(torch, dev) -> dict:
    """Phase 50's float32 models in eval mode on ``dev``: zoo/res8.pt, and random
    res26, res8-narrow and res26-narrow weights from SEED with randomized BN
    statistics (as phase 4's)."""
    from honk_tpu_torch.models import SpeechResModel, find_config, load_honk_checkpoint

    models = {"res8": load_honk_checkpoint(CHECKPOINT, SpeechResModel(find_config("res8")))}
    for conf in ("res26", "res8-narrow", "res26-narrow"):
        torch.manual_seed(SEED)
        m = SpeechResModel(find_config(conf))
        for i in range(1, m.n_layers + 1):
            bn = getattr(m, f"bn{i}")
            bn.running_mean.normal_(0, 0.1)
            bn.running_var.uniform_(0.5, 1.0)
        models[conf] = m
    return {conf: m.to(dev).eval() for conf, m in models.items()}


def device_kernels(torch, fn) -> list[str]:
    """The device kernels of one call of ``fn`` after a warm one, by name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def phase_res_forward(torch, dev, counters, name, smi) -> dict:
    """50. The res stack with the stem inside (res_kernel.res_forward, one launch
    from the features) against res_forward_plain on the card in all three modes:
    res8 (zoo/res8.pt) and res26 at RF_BATCHES, res8-narrow and res26-narrow at
    RF_NARROW_BATCH (float32 at RES_TOL; the bf16 modes by check_bf16_case, the
    stack's faults and the stem's (stem_faults) refused on res8 at
    BF16_FULL_ROWS rows). Then one device kernel per
    eval forward (torch.profiler): res8 and res26 of each dtype at B=256 and 8,
    and res_forward_fused of res8 at B=256; one res_forward launch and no
    res_stack one per eval forward (the counters); CUDA-event times of each
    forward beside the two-launch path it replaced (the stem as PyTorch ops,
    then the pooled entry) and the plain version, and forward_bound."""
    from honk_tpu_torch.models import SpeechResModel, find_config
    from honk_tpu_torch.ops import mfcc_kernel, res_kernel

    bf16, f32 = torch.bfloat16, torch.float32
    modes = {"float32": (f32, f32), "bfloat16": (bf16, f32), "bfloat16_activations": (bf16, bf16)}
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 50)
    out = {"checks": {m: {} for m in modes}, "times": {m: {} for m in modes}, "kernels_per_forward": {}}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.inference_mode():
        audio = torch.from_numpy((rng.standard_normal((RF_BATCHES[-1], 16000)) * 0.2).astype(np.float32)).to(dev)
        feats = mfcc_kernel.mfcc(audio)
        del audio
        models = forward_models(torch, dev)
        for conf, model in models.items():
            batches = RF_BATCHES if conf in ("res8", "res26") else (RF_NARROW_BATCH,)
            w0, pool, n_lab = model.conv0.weight, model.pool, model.output.out_features
            C, L, H, W = model.n_maps, model.n_layers, 101 // pool[0], 40 // pool[1]
            for mode, (compute, act) in modes.items():
                packed = res_kernel.pack_res_params(model, compute, act)
                stem_dtype = bf16 if mode == "bfloat16_activations" else f32
                for b in batches:
                    f, label = feats[:b].contiguous(), f"{conf} B={b}"
                    cs = res_kernel.cluster_size(b, C, H, W, n_sm, compute, act)
                    geo = {"cluster": cs, "smem_bytes": res_kernel.smem_bytes(C, H, W, cs, compute, act)}
                    if mode == "float32":
                        got = res_kernel.res_forward(f, w0, pool, *packed)
                        ref = res_kernel.res_forward_plain(f, w0, pool, *packed)
                        torch.cuda.synchronize()
                        err = max_err(got, ref)
                        if got.shape != (b, n_lab) or not torch.isfinite(got).all() or not close(got, ref, **RES_TOL):
                            fail(f"res_forward float32 against its plain version, {label}: shape "
                                 f"{tuple(got.shape)}, max abs err {err:.3e}")
                        check = {"max_abs_err": err}
                    else:
                        refuse = conf == "res8" and b == BF16_FULL_ROWS
                        reading, differ, near, _, _ = check_bf16_case(
                            torch, res_kernel, mode, label, model.stem(f, stem_dtype), packed, tag="res_forward",
                            refuse_faults=refuse, forward=(f, w0, pool), run_faults=refuse,
                            stem=stem_faults(torch, f, w0, pool, mode) if refuse else None)
                        check = {"max_abs_err": reading["full"]["rows"]["max"], **reading,
                                 "argmax_differs_plain": differ, "near_ties": near}
                    out["checks"][mode][label] = {**check, "geometry": geo}
                    if conf not in ("res8", "res26"):
                        continue
                    iters = 100 if b <= 8 else 20 if b <= BF16_FULL_ROWS else 10 if b <= 1024 else 5
                    kw = dict(compute_dtype=compute, activation_dtype=act)
                    t = {"ms": time_ms(torch, lambda: res_kernel.res_forward(f, w0, pool, *packed, **kw), iters),
                         "two_launch_ms": time_ms(torch, lambda: res_kernel.res_stack(model.stem(f, stem_dtype),
                                                                                    *packed, **kw), iters),
                         "plain_ms": time_ms(torch, lambda: res_kernel.res_forward_plain(f, w0, pool, *packed, **kw),
                                             min(iters, 5))}
                    t["bound_ms"], t["bound_by"] = forward_bound(b, C, H, W, L, n_lab, pool, name, mode)
                    t["bytes_ms"] = forward_work(b, C, H, W, L, n_lab, *pool, mode)[2] / peaks(name)[3] * 1e3
                    out["times"][mode].setdefault(conf, {})[b] = t
            torch.cuda.empty_cache()

        # One kernel per eval forward, and the main path's entry.
        f256, f8 = feats[:BF16_FULL_ROWS].contiguous(), feats[:8].contiguous()
        forwards = {}
        for conf in ("res8", "res26"):
            m16 = SpeechResModel(find_config(conf), dtype=bf16)
            m16.load_state_dict(models[conf].state_dict())
            for dtype, m in (("float32", models[conf]), ("bfloat16", m16.to(dev).eval())):
                ops = m.eval_operands()
                for b, f in ((BF16_FULL_ROWS, f256), (8, f8)):
                    forwards[f"{conf} {dtype} eval forward B={b}"] = lambda m=m, ops=ops, f=f: m(f, packed=ops)
        fused_ops = res_kernel.pack_res_params(models["res8"], bf16)
        forwards[f"res_forward_fused res8 B={BF16_FULL_ROWS}"] = lambda: res_kernel.res_forward_fused(
            models["res8"], f256, packed=fused_ops)
        for label, fn in forwards.items():
            names = device_kernels(torch, fn)
            out["kernels_per_forward"][label] = names
            if len(names) != 1 or "res_stack_kernel" not in names[0]:
                fail(f"{label}: {len(names)} device kernels, not the res stack's one: {names}")
            reset(counters)
            fn()
            launched = read(counters, bf16=True)
            if launched["res_stack"] != 1 or launched.by_entry != {"res_forward": 1, "res_stack": 0}:
                fail(f"{label}: res stack launches {launched['res_stack']} by entry {launched.by_entry}, "
                     "expected one res_forward")
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"[res_forward] {smi}: the res stack from the features (the stem inside) against its plain version "
          f"(float32 {RES_TOL}, bf16 modes by rows as phase 29), one kernel per eval forward, CUDA-event times "
          f"beside the two-launch path and the bound: " + json.dumps(out))
    return out


def phase_orbax(torch, counters, serve, requests, svc, hard_v2_root, hard_v2, smi) -> dict:
    """31. The port's Orbax reader on the card's machine: the decoder report, all 14
    committed best/ directories against their .pt, /listen from zoo/res8/best,
    the serving CLI on zoo/res8, and --type eval of zoo_hard_v2/res15/best on
    phase 14's corpus. A directory that does not load fails the run."""
    import ctypes.util
    import glob
    import importlib

    from honk_tpu_torch.ckpt import read_state_dict, zstd
    from honk_tpu_torch.cli.serve import make_server
    from honk_tpu_torch.cli.train import main as cli_main
    from honk_tpu_torch.serve import LabelService

    report = {"find_library_zstd": ctypes.util.find_library("zstd"), "decoder": zstd.describe()}
    for module in ("zstandard", "numcodecs", "tensorstore"):
        try:
            importlib.import_module(module)
            report[f"{module}_imports"] = True
        except ImportError:
            report[f"{module}_imports"] = False
    print(f"[orbax] {smi}: decoder report " + json.dumps(report))
    out = {"report": report, "loads": {}}
    for best in sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "zoo*", "*", "best"))):
        t0 = time.perf_counter()
        got = read_state_dict(os.path.join(ROOT, best))
        orbax_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        pt = torch.load(os.path.join(ROOT, best[: -len("/best")] + ".pt"), map_location="cpu", weights_only=True)
        pt_ms = (time.perf_counter() - t0) * 1e3
        pt = {k: v for k, v in pt.items() if not k.endswith(".num_batches_tracked")}
        if got.keys() != pt.keys() or not all(got[k].dtype == v.dtype and torch.equal(got[k], v)
                                              for k, v in pt.items()):
            fail(f"{best} does not load bit for bit equal to its .pt")
        out["loads"][best] = {"orbax_ms": orbax_ms, "pt_ms": pt_ms, "tensors": len(pt)}
    if len(out["loads"]) != 14:
        fail(f"found {len(out['loads'])} committed best/ directories, not 14")
    print(f"[orbax] {smi}: all {len(out['loads'])} best/ directories equal their .pt bit for bit; host ms to "
          "load each (Orbax, then .pt): " + json.dumps(out["loads"]))

    orbax = LabelService("res8", os.path.join(ROOT, "zoo", "res8", "best"))
    if not all(torch.equal(a, b) for a, b in zip(orbax._packed, svc._packed)):
        fail("zoo/res8/best's kernel operands differ from zoo/res8.pt's")
    _, out["launches"] = listen(orbax, svc, requests, counters, serve)
    n = len(requests)
    if out["launches"] != {"mfcc": n, "res_stack": n, "assemble": 0} or \
            out["launches"].by_entry.get("res_forward") != n:
        fail(f"/listen from zoo/res8/best launched {out['launches']} ({out['launches'].by_entry})")
    print(f"[orbax] {smi}: /listen x{n} from zoo/res8/best answered like the zoo/res8.pt service; launches "
          f"{dict(out['launches'])}, res stack by entry {out['launches'].by_entry}")

    httpd = make_server(["--checkpoint", os.path.join(ROOT, "zoo", "res8"), "--port", "0"])
    httpd.server_close()
    print(f"[orbax] cli.serve --checkpoint zoo/res8 built its server on port {httpd.server_address[1]}")

    argv = ["--type", "eval", "--model", "res15", "--data_dir", hard_v2_root, "--dev_pct", "10", "--test_pct", "80",
            "--eval_batch_size", str(BATCH), "--input_file"]
    n_test = hard_v2_manifest()["split_sizes"]["test"]  # phase 14 holds the corpus to it
    n_batches = math.ceil(n_test / BATCH)
    acc = {}
    for source in ("best", "pt"):
        path = os.path.join(HARD_V2, "res15", "best") if source == "best" else os.path.join(HARD_V2, "res15.pt")
        reset(counters)
        rc, text = run_cli(cli_main, [*argv, path])
        launches = read(counters)
        if rc != 0 or launches != {"assemble": 0, "mfcc": n_batches, "res_stack": 0}:
            fail(f"cli.train --type eval --input_file {os.path.relpath(path, ROOT)} returned {rc}, launched {launches}")
        acc[source] = final_accuracy(text)
        if source == "best":
            out["eval_launches"] = launches
    phase14 = hard_v2["models"]["res15"]["acc"]
    out["eval"] = {"orbax": acc["best"], "pt": acc["pt"], "phase14": phase14,
                   "clips_from_phase14": round(abs(acc["best"] - phase14) * n_test)}
    if acc["best"] != acc["pt"] or abs(acc["best"] - phase14) > HARD_V2_ACC_ATOL:
        fail(f"--type eval of zoo_hard_v2/res15/best: {out['eval']}")
    print(f"[orbax] {smi}: cli.train --type eval --input_file zoo_hard_v2/res15/best on the hard_v2 corpus: "
          f"{json.dumps(out['eval'])}, launches {dict(out['eval_launches'])}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.frontend import compute_mfccs_reference
    from honk_tpu_torch.frontend import filters as mfcc_filters
    from honk_tpu_torch.models import SpeechResModel, find_config
    from honk_tpu_torch.data import augment as A
    from honk_tpu_torch.data import generate_dataset
    from honk_tpu_torch.ops import _build, assemble_kernel, mfcc_kernel, res_kernel
    from honk_tpu_torch.serve import LabelService, serve

    dev = torch.device("cuda")
    use_full_f32()
    name = torch.cuda.get_device_name(0)

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. Build the three kernels from the sources in this checkout, in parallel.
    t0 = time.perf_counter()
    logs = _build.build("mfcc", "res_stack", "assemble")
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f} s ({', '.join(sorted(logs)) or 'already built'})")
    for src, log in logs.items():
        for line in ptxas_summary(log):
            print(f"[build] {src}: {line}")

    rng = np.random.default_rng(SEED)
    audio_np = (rng.standard_normal((BATCH + 1, 16000)) * 0.2).astype(np.float32)
    audio_np[-1] = 0.0
    audio = torch.from_numpy(audio_np).to(dev)

    # 3. MFCC kernel against its plain version, at the lengths /listen sends,
    # and against the float64 golden.
    mfcc_err, mfcc_errs = 0.0, {}
    for n in (16000, 8000, 24000):
        a = audio if n == 16000 else torch.from_numpy(
            (rng.standard_normal((BATCH + 1, n)) * 0.2).astype(np.float32)).to(dev)
        a[-1] = 0.0
        got = mfcc_kernel.mfcc(a)
        ref = mfcc_kernel.mfcc_plain(a)
        torch.cuda.synchronize()
        if got.shape != (BATCH + 1, 1 + n // 160, 40) or not torch.isfinite(got).all():
            fail(f"mfcc kernel, {n} samples: shape {tuple(got.shape)} or non-finite values")
        if not bool((got[-1] == 0).all()):
            fail(f"mfcc kernel, {n} samples: the silent row is not exactly 0")
        err = max_err(got, ref)
        if not close(got, ref, **MFCC_TOL):
            fail(f"mfcc kernel disagrees with its plain version, {n} samples: max abs err {err:.3e}")
        got1 = mfcc_kernel.mfcc(a[:1].contiguous())
        if not close(got1, ref[:1], **MFCC_TOL):
            fail(f"mfcc kernel at B=1, {n} samples: max abs err {max_err(got1, ref[:1]):.3e}")
        mfcc_errs[n] = err
        if n == 16000:
            mfcc_err = err
            golden_err = 0.0
            for i in range(4):
                golden = torch.from_numpy(compute_mfccs_reference(audio_np[i].astype(np.float64)))
                g = got[i].cpu().double()
                golden_err = max(golden_err, max_err(g, golden))
                if not close(g, golden, **GOLDEN_TOL):
                    fail(f"mfcc kernel against the float64 golden, row {i}: max abs err {max_err(g, golden):.3e}")
    print(f"[mfcc] B={BATCH + 1} max abs err " + ", ".join(f"{n} samples {e:.3e}" for n, e in mfcc_errs.items())
          + f" (atol {MFCC_TOL['atol']}, rtol {MFCC_TOL['rtol']}); silent rows exactly 0; B=1 ok; "
          f"float64 golden max abs err {golden_err:.3e} on 4 rows (atol {GOLDEN_TOL['atol']}, rtol {GOLDEN_TOL['rtol']}); "
          f"geometry B=1 {mfcc_kernel.geometry(audio[:1])}, B={BATCH} {mfcc_kernel.geometry(audio[:BATCH])}")

    # 4. Res-stack kernel against its plain version.
    svc = LabelService("res8", CHECKPOINT)  # device defaults to cuda
    res_errs = {}
    with torch.inference_mode():
        feats = mfcc_kernel.mfcc_plain(audio[:BATCH])
        pooled = svc.model.stem(feats)
        packed = res_kernel.pack_res_params(svc.model)
        ref = res_kernel.res_stack_plain(pooled, *packed)
        for b in (1, 2, 3, 133, BATCH):
            x = pooled[:b].contiguous()
            got = res_kernel.res_stack(x, *packed)
            torch.cuda.synchronize()
            if got.shape != (b, 12) or not torch.isfinite(got).all():
                fail(f"res_stack kernel, res8 B={b}: shape {tuple(got.shape)} or non-finite values")
            err = max_err(got, ref[:b])
            if not close(got, ref[:b], **RES_TOL):
                fail(f"res_stack kernel disagrees with its plain version, res8 B={b}: max abs err {err:.3e}")
            res_errs[f"res8 B={b}"] = (err, res_kernel.geometry(x))
        res_err = res_errs[f"res8 B={BATCH}"][0]
        # Random weights with randomized BN stats: the narrow and the 26-layer models.
        for conf in ("res8-narrow", "res26", "res26-narrow"):
            cfg = find_config(conf)
            torch.manual_seed(SEED)
            m = SpeechResModel(cfg)
            for i in range(1, cfg["n_layers"] + 1):
                bn = getattr(m, f"bn{i}")
                bn.running_mean.normal_(0, 0.1)
                bn.running_var.uniform_(0.5, 1.0)
            m = m.to(dev).eval()
            packed_m = res_kernel.pack_res_params(m)
            for b in (1, 3):
                pooled_m = m.stem(feats[:b])
                got_m = res_kernel.res_stack(pooled_m, *packed_m)
                ref_m = res_kernel.res_stack_plain(pooled_m, *packed_m)
                torch.cuda.synchronize()
                err = max_err(got_m, ref_m)
                if not close(got_m, ref_m, **RES_TOL):
                    fail(f"res_stack kernel, {conf} B={b}: max abs err {err:.3e}")
                res_errs[f"{conf} B={b}"] = (err, res_kernel.geometry(pooled_m))
    print(f"[res_stack] max abs err against the plain version (atol {RES_TOL['atol']}, rtol {RES_TOL['rtol']}), "
          "cluster geometry: " + "; ".join(f"{k} {e:.3e} cluster {g['cluster']} x {g['threads']} threads, "
                                          f"{g['rows_per_cta']} rows, {g['smem_bytes']} B smem"
                                          for k, (e, g) in res_errs.items()))

    # 5. The service on cuda against the same service on the CPU.
    cpu = LabelService("res8", CHECKPOINT, device="cpu")
    utts = audio_np[:BATCH]
    gpu_logits = svc.logits(utts).cpu()
    cpu_logits = cpu.logits(utts)
    logit_err = max_err(gpu_logits, cpu_logits)
    if logit_err > LOGIT_ATOL:
        fail(f"LabelService cuda vs cpu: logits max abs err {logit_err:.3e} > {LOGIT_ATOL}")
    gpu_out, cpu_out = svc.evaluate_batch(utts), cpu.evaluate_batch(utts)
    if [lab for lab, _ in gpu_out] != [lab for lab, _ in cpu_out]:
        fail("LabelService cuda vs cpu: labels differ")
    print(f"[service] evaluate_batch B={BATCH}: labels equal, logits max abs err {logit_err:.3e}")

    # 6. The main path: HTTP /listen through both kernels.
    counters = {"assemble": assemble_kernel, "mfcc": mfcc_kernel, "res_stack": res_kernel}
    requests = [
        (rng.standard_normal(n) * 3000).astype(np.int16)
        for n in (16000, 12000, 20000, 16000, 8000, 16000, 24000, 16000)
    ]
    listen_s, launches = listen(svc, cpu, requests, counters, serve)
    if launches != {"mfcc": N_LISTEN, "res_stack": N_LISTEN, "assemble": 0}:
        fail(f"/listen x{N_LISTEN} launched {launches}, expected {N_LISTEN} mfcc and res_stack, no assemble")
    # The same utterances through LabelService.evaluate alone (no HTTP, JSON or
    # base64), to split the host time of a /listen between front end and service.
    evaluate_s = []
    for pcm in requests:
        x = pcm.astype(np.float32) / 32768.0
        t0 = time.perf_counter()
        svc.evaluate(x)
        evaluate_s.append(time.perf_counter() - t0)
    print(f"[listen] {N_LISTEN} requests answered like the CPU service; launches {launches}; "
          f"host ms per request {[round(s * 1e3, 3) for s in listen_s]}; "
          f"per evaluate() alone {[round(s * 1e3, 3) for s in evaluate_s]}")

    # 7. Times at B=1 (one /listen) and B=256, kernel and plain version.
    with torch.inference_mode():
        a1, a256 = audio[:1].contiguous(), audio[:BATCH].contiguous()
        p1, p256 = pooled[:1].contiguous(), pooled
        times = {}
        for b, a, p, iters in ((1, a1, p1, 200), (BATCH, a256, p256, 20)):
            times[b] = {
                "mfcc": time_ms(torch, lambda: mfcc_kernel.mfcc(a), iters),
                "mfcc_plain": time_ms(torch, lambda: mfcc_kernel.mfcc_plain(a), iters),
                "res_stack": time_ms(torch, lambda: res_kernel.res_stack(p, *packed), iters),
                "res_stack_plain": time_ms(torch, lambda: res_kernel.res_stack_plain(p, *packed), iters),
            }

    # 29. The res stack's bf16 mode against its plain version, and its times beside the f32 mode's.
    bf16_kernel = phase_bf16_kernel(torch, dev, res_kernel, mfcc_kernel, logs, name, smi)
    # 50. The res stack with the stem inside: every res8 / res26 eval forward is one launch.
    res_fwd = phase_res_forward(torch, dev, counters, name, smi)

    # 8-11. The training path.
    assemble_err, arrays, aug = phase_assemble(torch, dev, A, assemble_kernel)
    train_step_errs = {"res8": phase_train_steps(torch, dev, A)}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        generate_dataset(corpus, clips_per_word=40, n_speakers=8)
        train_launches, epochs, train_acc, train_modes = phase_entry_point(torch, corpus, tmp, counters)
        train_times, step_times, assemble_ops = phase_step_times(torch, dev, A, assemble_kernel, mfcc_kernel,
                                                                 arrays, aug)
        # 33. The bf16 train step: flax's dtype flow on cuda and on the CPU, the bf16 pool bitwise.
        bf16_train = phase_bf16_train(torch, dev, A, step_times, smi)
        # 35. The scaling harness at one card, beside phase 11's step.
        scaling = phase_scaling(torch, counters, step_times, smi)
        # 36-39. The measuring tools: entry(), cli.bench, cli.bench_stream, cli.bench_serve.
        t0 = time.perf_counter()
        tools = phase_tools(torch, counters, smi)
        print(f"[tools] phases 36-39 took {time.perf_counter() - t0:.1f} s")
        # 40-49. The reference's last repo-level tools: microbench, bench_res_kernel, hard_probe,
        # make_corpus, prof_fwd, prof_train and the three res15 probes.
        profile_tools = phase_profile_tools(torch, counters, tmp, smi)
        print(f"[profile_tools] phases 40-49 took {profile_tools['s']:.1f} s")

        # 25-27. Data parallel at world size 1 on NCCL, each kernel on a rank's rows, --profile-dir.
        t0 = time.perf_counter()
        data_parallel = phase_data_parallel(torch, dev, corpus, tmp, counters, train_acc, smi, A, arrays, aug, svc)
        shards = phase_shards(torch, dev, A, assemble_kernel, mfcc_kernel, res_kernel, arrays, aug, svc, smi)
        profile_dir = phase_profile_dir(torch, corpus, tmp, counters, smi)
        print(f"[data_parallel+profile] phases 25-27 took {time.perf_counter() - t0:.1f} s")

        # 12-16. The rest of the model family, on cuDNN and cuBLAS between the kernels.
        family_services, family_errs = phase_family_eval(torch, LabelService, counters, audio_np[:BATCH])
        family_listen = {}
        for conf in ("res15", "cnn-trad-pool2"):
            gpu, cpu_svc = family_services[conf]
            listen_ms, family_launches = listen(gpu, cpu_svc, requests[:N_LISTEN_FAMILY], counters, serve)
            if family_launches != {"mfcc": N_LISTEN_FAMILY, "res_stack": 0, "assemble": 0}:
                fail(f"{conf} /listen x{N_LISTEN_FAMILY} launched {family_launches}, "
                     f"expected {N_LISTEN_FAMILY} mfcc, no res_stack or assemble")
            evaluate_ms = []
            for pcm in requests[:N_LISTEN_FAMILY]:
                t0 = time.perf_counter()
                gpu.evaluate(pcm.astype(np.float32) / 32768.0)
                evaluate_ms.append((time.perf_counter() - t0) * 1e3)
            family_listen[conf] = {"launches": family_launches, "host_ms": [t * 1e3 for t in listen_ms],
                                   "evaluate_host_ms": evaluate_ms}
        print(f"[family_listen] {N_LISTEN_FAMILY} requests per model answered like the CPU service; host ms per "
              "request, then per evaluate() alone: " + json.dumps(family_listen))
        hard_v2 = phase_hard_v2(torch, dev, counters, tmp)
        native = phase_native(torch, os.path.join(tmp, "hard_v2"), smi)  # 28. on the hard_v2 corpus
        family_train = {}
        for conf, batch, flags in (("res15", 16, ()),
                                   ("cnn-trad-pool2", TRAIN_BATCH, ("--lr", "0.003", "0.0003", "--schedule", "440"))):
            train_step_errs[conf] = phase_train_steps(torch, dev, A, conf, batch)
            family_train[conf] = phase_entry_point(torch, corpus, tmp, counters, conf, 1, flags)
        family_times = phase_family_times(torch, dev, A, arrays, aug)
        # 30. The bf16 eval path: the CLI runs' sweeps by mode, make_forward of a bf16 res8.
        bf16_eval = phase_bf16_eval(torch, dev, counters, os.path.join(tmp, "hard_v2"),
                                    {"res8": train_modes, **{c: v[3] for c, v in family_train.items()}}, smi)
        # 34. The recipe's accuracy: cli.zoo build res8 and res15 on hard_v2, compare against zoo_hard_v2.
        recipe = phase_recipe(torch, counters, os.path.join(tmp, "hard_v2"), tmp, smi)
        # 31. The port's Orbax reader: all 14 best/ directories, /listen, cli.serve and --type eval from them.
        orbax = phase_orbax(torch, counters, serve, requests[:4], svc, os.path.join(tmp, "hard_v2"), hard_v2, smi)

    # 17-21. Streaming: the MFCC kernel's causal framing, offline, online, the hub over HTTP, res15 and cnn.
    streaming = phase_streaming(torch, dev, svc, cpu, counters, serve, family_services, mfcc_kernel, name)

    # 22-23. Personalization (TrainingService, POST /train) and the dataset generator's quality scoring.
    t0 = time.perf_counter()
    personalize = phase_personalize(torch, counters, serve)
    with tempfile.TemporaryDirectory() as tmp:
        datagen = phase_datagen(torch, counters, tmp)
    print(f"[personalize+datagen] phases 22-23 took {time.perf_counter() - t0:.1f} s")

    # 24. The repair: one device worker per service, whatever thread a request arrives on.
    worker = phase_worker_thread(torch, {"res8": svc, "res15": family_services["res15"][0],
                                         "cnn-trad-pool2": family_services["cnn-trad-pool2"][0]},
                                 serve, streaming["hub"], smi)

    # 32. The stream hub sharded over ranks: world size 1 on NCCL, then two gloo ranks on the card.
    hub_ranks = phase_hub_ranks(torch, counters, smi)

    C, H, W = pooled.shape[1:]
    L, n_lab = packed[0].shape[0], packed[3].shape[1]

    def mfcc_work_b(b):  # b utterances of 1 s
        return mfcc_work(b * 101, b * 16000)

    def res_work_b(b):
        return res_work(b, C, H, W, L, n_lab)

    # "launches" counts the training path's run (phase 10) for mfcc, assemble
    # and the res stack's bf16-activation mode (its dev and test sweeps), the
    # serving path's 8 requests (phase 6) for the res stack's float32 mode, and
    # the TPU kernel's fused forward (res_forward_fused, phase 30) for its bf16
    # mode, the path named by "launches_path"; "launches_listen" the serving
    # path's; and "launches_by_path" every path the script drives with the
    # counts set to 0 just before it (the res stack by mode: read() refuses a
    # bf16 launch on every path but the CLI runs, the recipe's builds,
    # make_forward of a bf16 model and res_forward_fused). ms / plain_ms /
    # bound_ms are at "batch"; the other keys give the other sizes.
    by_path = {
        "train_res8": train_launches, "listen_res8": launches,
        **{f"listen_{c}": v["launches"] for c, v in family_listen.items()},
        **{f"hard_v2_{c}": r["launches"] for c, r in hard_v2["models"].items()},
        **{f"train_{c}": v[0] for c, v in family_train.items()},
        **streaming["launches_by_path"],
        "train_personalize": personalize["train_launches"],
        "listen_after_train": personalize["listen_after_train_launches"],
        "datagen_quality": datagen["launches"],
        "train_res8_nccl_world1": data_parallel["launches"], "dryrun_1": data_parallel["dryrun_launches"],
        "stream_offline_res8_data_axis": data_parallel["stream_file_launches"],
        "stream_batch8_res8_data_axis": data_parallel["batch_streamer_launches"],
        "make_forward_res8_bf16": bf16_eval["launches"], "listen_res8_orbax": orbax["launches"],
        "eval_res15_orbax": orbax["eval_launches"],
        "res_forward_fused_res8": bf16_eval["fused"]["launches"],
        **{f"recipe_build_{c}": m["launches"] for c, m in recipe["models"].items()},
        "recipe_compare": recipe["compare_launches"],
        "stream_hub_push_bin_res8_data_axis_nccl_world1": hub_ranks["launches"],
        "scaling_1": scaling["launches"],
        **{f"tool_{k}": v["launches"] for k, v in tools.items()},
        **profile_tools["paths"],
    }
    by_path = {p: v for p, v in by_path.items() if v is not None}
    res_modes = {p: v.by_mode for p, v in by_path.items()}  # the res stack's launches by mode, as read on each path
    kernels = []
    for kname, src, replaces, work, err, tf32x3 in (
        ("mfcc", "honk_tpu_torch/ops/csrc/mfcc.cu", "honk_tpu/ops/mfcc_kernel.py:75", mfcc_work_b, mfcc_err, False),
        ("res_stack", "honk_tpu_torch/ops/csrc/res_stack.cu", "honk_tpu/ops/res_kernel.py:139", res_work_b, res_err,
         True),
    ):
        b256, by = bound(*work(BATCH), name, tf32x3)
        b1, by1 = bound(*work(1), name, tf32x3)
        res = kname == "res_stack"
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": res_modes["listen_res8"]["float32"] if res else train_launches[kname],
            "launches_path": "listen_res8" if res else "train_res8",
            "launches_listen": res_modes["listen_res8"]["float32"] if res else launches[kname],
            "launches_dp": res_modes["train_res8_nccl_world1"]["float32"] if res else data_parallel["launches"][kname],
            "launches_by_path": {p: (res_modes[p]["float32"] if res else v[kname]) for p, v in by_path.items()},
            "max_abs_err": err,
            "ms": times[BATCH][kname], "plain_ms": times[BATCH][kname + "_plain"],
            "bound_ms": b256, "bound_by": by, "library_ms": None, "batch": BATCH,
            "ms_b1": times[1][kname], "plain_ms_b1": times[1][kname + "_plain"],
            "bound_ms_b1": b1, "bound_by_b1": by1,
        })
    b64, by64 = bound(*mfcc_work_b(TRAIN_BATCH), name)
    kernels[0].update({"ms_b64": train_times["mfcc_b64"], "plain_ms_b64": train_times["mfcc_plain_b64"],
                       "bound_ms_b64": b64, "bound_by_b64": by64, "streaming": streaming["mfcc"]})
    kernels[1]["streaming"] = streaming["res_stack"]
    for kname, mode, path, times, err, replaces in (
            ("res_stack[bf16]", "bfloat16", "res_forward_fused_res8", bf16_kernel["times"],
             bf16_kernel["res8_max_abs_err"], "honk_tpu/ops/res_kernel.py:139"),
            ("res_stack[bf16_activations]", "bfloat16_activations", "train_res8", bf16_kernel["flow_times"],
             bf16_kernel["flow_res8_max_abs_err"], "honk_tpu/models/res.py:41")):
        t = times[BATCH]
        kernels.append({
            "name": kname, "route": "cuda", "source": "honk_tpu_torch/ops/csrc/res_stack.cu",
            "replaces": replaces, "launches": res_modes[path][mode],
            "launches_path": path, "launches_listen": res_modes["listen_res8"][mode],
            "launches_dp": res_modes["train_res8_nccl_world1"][mode],
            "launches_by_path": {p: m[mode] for p, m in res_modes.items()},
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "batch": BATCH, "ms_f32_mode": t["f32_mode_ms"],
            "by_batch": {str(b): bt for b, bt in times.items()},
        })
    a64, aby64 = bound(*assemble_ops[TRAIN_BATCH], name)
    a1024, aby1024 = bound(*assemble_ops[1024], name)
    kernels.append({
        "name": "assemble", "route": "cuda", "source": "honk_tpu_torch/ops/csrc/assemble.cu",
        "replaces": "honk_tpu/ops/assemble_kernel.py:122", "launches": train_launches["assemble"],
        "launches_path": "train_res8", "launches_listen": launches["assemble"], "launches_dp": data_parallel["launches"]["assemble"],
        "launches_by_path": {p: v["assemble"] for p, v in by_path.items()}, "max_abs_err": assemble_err,
        "ms": train_times["assemble_b64"], "plain_ms": train_times["assemble_plain_b64"],
        "bound_ms": a64, "bound_by": aby64, "library_ms": None, "batch": TRAIN_BATCH,
        "ms_b1024": train_times["assemble_b1024"], "plain_ms_b1024": train_times["assemble_plain_b1024"],
        "bound_ms_b1024": a1024, "bound_by_b1024": aby1024,
    })
    # Each kernel beside the library path of the reference tool that times it against one (phases
    # 40-41, B=BATCH; ms a batch, the tool's marginal on the host clock, the kernel's leg beside it):
    # the MFCC against microbench's frontend_jnp (cuBLAS DFT GEMMs), the res stack's bf16 modes
    # against bench_res_kernel's xla leg (cuDNN's bf16 convs in flax's flow). No tool has a library
    # leg for the float32 res stack or the assembly.
    micro, rk = profile_tools["microbench"], profile_tools["bench_res_kernel"]
    library_legs = {
        "mfcc": ("cli.microbench frontend_jnp", micro["ms"]["frontend_jnp"], micro["ms"]["frontend_pallas"]),
        "res_stack[bf16]": ("cli.bench_res_kernel xla", rk["row"]["xla_ms_per_batch"], rk["row"]["fused_ms_per_batch"]),
        "res_stack[bf16_activations]": ("cli.bench_res_kernel xla", rk["row"]["xla_ms_per_batch"], rk["model_ms"]),
    }
    # Phase 49: each kernel against its plain version at the shapes the tools gave it.
    tool_errs = profile_tools["kernels_at_tool_shapes"]
    for k in kernels:
        k["library_leg"], k["library_leg_ms"], k["library_leg_kernel_ms"] = library_legs.get(k["name"], (None,) * 3)
        k["max_abs_err_at_tool_shapes"] = {label: v["max_abs_err"] if isinstance(v, dict) else v
                                           for label, v in tool_errs.get(k["name"], {}).items()}
    # Phase 50: each mode's entry from the features (res_forward, the stem inside) at
    # RF_BATCHES beside the two-launch path it replaced, and the res stack's
    # launches by entry on every path.
    for k in kernels:
        mode = {"res_stack": "float32", "res_stack[bf16]": "bfloat16",
                "res_stack[bf16_activations]": "bfloat16_activations"}.get(k["name"])
        if mode:
            k["forward"] = {"entry": "res_forward", "by_model_batch": res_fwd["times"][mode],
                            "max_abs_err": {label: c["max_abs_err"] for label, c in res_fwd["checks"][mode].items()},
                            "library_ms": None}
        if k["name"] == "res_stack":
            k["launches_by_entry_by_path"] = {p: v.by_entry for p, v in by_path.items()}
            k["kernels_per_forward"] = {label: len(v) for label, v in res_fwd["kernels_per_forward"].items()}
    print(json.dumps({"build_s": build_s, "listen_host_ms": [s * 1e3 for s in listen_s],
                      "evaluate_host_ms": [s * 1e3 for s in evaluate_s],
                      "train_steps_cuda_vs_cpu": train_step_errs,
                      "train_epochs": epochs, "train_step_b64_ms": step_times,
                      "family_eval_logit_err": family_errs, "family_listen": family_listen, "hard_v2": hard_v2,
                      "family_train_epochs": {c: v[1] for c, v in family_train.items()},
                      "family_times": family_times,
                      "streaming": {k: v for k, v in streaming.items() if k not in ("mfcc", "res_stack")},
                      "personalize": personalize, "datagen": datagen, "worker_thread": worker,
                      "data_parallel": data_parallel, "shards": shards, "profile_dir": profile_dir,
                      "native": native, "bf16_kernel": {k: v for k, v in bf16_kernel.items() if not k.endswith("times")},
                      "bf16_eval": bf16_eval, "orbax": orbax, "hub_ranks": hub_ranks, "bf16_train": bf16_train,
                      "recipe": recipe, "scaling": scaling, "tools": tools,
                      "profile_tools": {k: v for k, v in profile_tools.items() if k != "paths"},
                      "res_forward": {k: v for k, v in res_fwd.items() if k != "times"}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
