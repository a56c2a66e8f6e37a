#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ccnet_tpu_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card of compute
capability 9.0 and ``nvcc``. It imports nothing of JAX. Phases, in order; any
failure raises and exits non-zero:

1. card: the ``nvidia-smi`` name and power limit; capability (9, 0) required;
2. build: the six CUDA libraries of ``ccnet_tpu_torch/csrc`` (``cca_fwd``,
   ``cca_bwd``, ``upsampled_ce``, ``cca_lines``, ``cca_lines_tc``,
   ``probes``), one ``nvcc`` each, started together;
3. kernels vs plain: K1 ``cca_fwd_col`` and K2 ``cca_fwd_row`` against their
   plain-torch versions, and the routed op against the joint-softmax
   oracle, at the sliding-tile, VOC (8, 41, 41), whole-image and edge
   shapes, in f32 (TF32
   off: the CUDA-core kernel) and bf16 (each kernel's own line: lines of at
   most 128 on the one-block tensor-core design, longer ones on K7a's
   tensor-core kernel, as at the whole-image shape and the edge shapes of
   bf16 natural-route lines of 129 to 400; both against the plain versions
   on the same bf16 tensors, their bf16 outputs bit-equal to the rounding
   plain versions' but for a few flipped roundings, which the plain version
   that does not round p is not); at the sliding shape CUDA-event times of
   the tensor-core and CUDA-core designs and the plain versions, and the
   CCA forward against the plain op;
4. backward kernels vs plain: K3 ``cca_bwd_col`` and K4 ``cca_bwd_row``
   against their plain versions, and the autograd Function's grads against
   torch.autograd of the plain op, at the same shapes and dtypes (bf16: the
   one-block tensor-core design on lines of at most 128, K7b's tensor-core
   kernels on longer ones, against the plain version on the same bf16
   tensors; f32: the CUDA-core pair); times of the tensor-core and
   CUDA-core designs at the sliding shape;
5. loss kernels vs plain: K5 ``upsampled_nll_fwd`` and K6
   ``upsampled_nll_bwd`` against the materialised upsample + NLL and its
   autograd, int32 and uint8 labels, at the 769² and full-frame shapes,
   ragged column tiles and r = 300, K6 also with a sparse and a zero g;
   times at (8, 97, 97, 19) → 769² and (2, 129, 257, 19) → 1025×2049, K6
   with a dense g and with g live on 2 % of the pixels, beside the bounds;
   ``criterion_ohem_dsn`` forward + backward at the 769² step's logits,
   kernel route against plain route, timed in turns; the OHEM threshold's
   count bisection (``phase_ohem``) at the step's 8 × 769² map against the
   exact ``kthvalue`` rule: equal keep masks, both timed;
6. line kernels vs plain: K7a ``cca_line_fwd`` and K7b ``cca_line_bwd`` on
   both paths as the line route calls them, and the routed Function's
   output and grads (each direction routed as the JAX package routes it),
   at the whole-image shapes of scales 1.0 and 1.75 and edge shapes, f32
   (the CUDA-core kernels against the f32 plain versions) and bf16 (the
   tensor-core kernels against the plain versions fed the same bf16
   tensors, which round p and de where the kernels do; K7a's o bit-equal
   to theirs but for a few flipped roundings, which the plain version that
   keeps p in f32 is not), plus edge lines of N = 16, 17, 65, 128 and
   463-465 in bf16; times at the long shapes of both designs, the rounding
   plain versions, the plain op and K1–K4 forced at the same shape;
   (3, 4 and 6 also time the one-call yardstick of the attention,
   ``F.scaled_dot_product_attention`` with a row-or-column mask on
   ``(B, 1, H·W, C)``, forward and forward + backward, on every backend
   that takes it, after checking it computes the plain op's function)
7. probes vs plain: P1–P5 (``ccnet_tpu_torch/ops/probes.py``) at the shapes
   of ``scripts/probe_mosaic.py`` and at the model's (P4 at K1's column
   logits (8, 97, 97, 64), P5 at v (8, 97, 97, 512)): the copies and the
   scale bit-exact, the dots at 1e-4 x scale; times (``probe_times``: the
   burst time, and the device µs per call from ``torch.profiler`` beside
   the host µs per call of back-to-back calls, of the kernel and of the one
   library call, which says whether the device or the host's pace sets
   the time; for P1/P4 beside the ``einsum``'s); the dot also at the
   shapes that reach its other paths (one pixel, scalar staging for C % 8
   != 0 and for a base 2 bytes past 16, bands past 64 tiles at H = 231,
   three channel chunks at C = 136, P4's bands of a ragged line); then the
   probe main path, ``ccnet_tpu_torch.cli.probe.main``, prints five PASS
   lines and launches each kernel;
8. full model: CCNet-R101 R=2 bf16 with seeded random weights (``gamma`` =
   0.5, so the attention moves the logits), kernel route vs plain route on
   one (8, 3, 769, 769) batch (K1/K2) and on one (1, 3, 1024, 2048) image
   (K7a), and both routes' eval forward timed in turns in this process;
   the weights go to a ``.pth``;
9. train step: one OHEM+DSN ``train_step`` from that ``.pth`` with the
   kernels (CCA and loss) and one with the plain versions: loss, CCA grads,
   launch counts, peak memory, then steps of the two timed in turns; at
   batch 8 of 769² (K1–K6);
10. train main path: ``ccnet_tpu_torch.cli.train.main`` with ``--synthetic``,
    batch 8 of 769², OHEM, 4 steps from that ``.pth``; launch counts of
    K1–K6; the exported ``CS_scenes_4.pth`` loads strictly; the card's
    s/step (CUDA events, augment + step: the batch was copied by the
    prefetch thread) beside the median host wall s/step;
11. full-frame training: 9 and 10 at batch 2 of 1025×2049 crops padded from
    the 1024×2048 images (features 129×257: K7a/K7b and K5/K6), 2 steps;
12. evaluation main path: ``ccnet_tpu_torch.cli.evaluate.main`` on the
    synthetic 1024×2048 set with the trained ``.pth``, sliding 769²
    windows (K1/K2, every launch on the tensor cores); then ``--whole 1``
    (K7a at 129×257); then multi-scale
    + flip whole image, scales 0.75–1.75, ``--save-preds 1`` (K7a at
    97×193 … 225×449), whose prediction PNGs are decoded with the standard
    library (``data.palette.read_png``).
    Each run's launch counts must show that it went through its kernels;
    the card's s/img (predict + confusion) beside the median host wall
    s/img;
13. PSPNet-R101 and DeepLabv3-R101 (bf16, seeded random weights): 9 and 10
    (2 steps) at batch 8 of 769² through K5/K6 (2 launches of each per step,
    none of the attention), and sliding ``cli.evaluate --model X
    --save-preds 1`` of the exported ``.pth`` on the synthetic set;
14. VOC loss kernels: K5/K6 at (8, 21, 41, 41) → 321² (21 classes, the
    kernels' class bound 32) as in 5, then their times and bounds;
15. VOC end to end: ``scripts/e2e_voc_synthetic.py``'s tree generated in
    memory (no JPEG round trip: the card decodes none), ``cli.train
    --dataset voc`` (CCNet R101 R=2 bf16, batch 8 of 321², 300 steps, lr
    5e-3, no OHEM), K1–K6 launch counts, card and host wall s/step, peak
    memory; the exported ``.pth`` through the bucketed ``Evaluator`` (tile
    321, bucket 128) must score held-out meanIU > 0.5 (else the recipe runs
    again on the plain route and both numbers are raised);
16. ``cli.predict`` on 2 synthetic 1024×2048 images with 10's ``.pth``,
    sliding (K1/K2) and ``--whole 1`` (K7a): the labelId PNGs, decoded with
    ``read_png``, equal the mapped argmax of ``Evaluator.predict_batch``;
17. ``cli.evaluate --restore-dir`` on 10's snapshots gives the confusion
    matrix of ``--restore-from`` its ``.pth``, exactly;
18. ``cli.train --augment-backend native`` (g++ builds the C++/OpenMP
    augmenter), 4 steps at batch 8 of 769², card beside host wall s/step;
19. remat: two steps at batch 8 of 769² each with no remat, ``blocks`` and
    ``conv12``: the first step's grads (layers 3 and 4, the rest), the
    second step's loss and the BN running stats' update agree, peak memory
    of each (``blocks`` below none);
20. ``cli.train --profile-steps 1,2``: the chrome trace names K1/K2;
21. data parallelism, two ranks on the one card:
    ``python -m torch.distributed.run --standalone --nproc_per_node 2
    chip_smoke.py --rank-main train ...`` runs ``cli.train.main --synthetic``
    in each rank (gloo: the ranks share the card), CCNet R101 R=2 bf16
    OHEM+DSN at global batch 8 of 769² (no random scales), 3 steps, a
    ``.pth`` after each; then the same 3 steps in this process on the same
    global batches (``ccnet_tpu_torch.parallel.RankOrder``). Each rank's
    K1–K6 launch counts equal one process's; the losses agree within
    DDP_LOSS_RTOL and the first step's BN running-stats update within
    DDP_STATS_RTOL; in each rank, ABN over the ranks on a seeded layer-4 BN
    input whose shares differ agrees with ``F.batch_norm`` on the global
    batch within DDP_ABN_RTOL (y, dx, stats): bounds that no update, a
    halved or doubled one, per-rank BN moments and per-rank BN backward
    sums each break (``--ddp-diagnostics``); both runs' s/step (two ranks
    on one card measure correctness, not scaling); in each rank, the
    Lovász criteria (``criterion_ohem_dsn2`` at the 769² step's logits and
    ``lovasz_hinge``) on the rank's share of a seeded global batch: the
    shares' losses sum to one process's on the global batch within
    LOVASZ_LOSS_RTOL and each rank's grads are its rows of one process's
    within LOVASZ_GRAD_TOL;
22. one rank under torchrun over NCCL, 2 steps, against the same 2 steps
    without torchrun, twice: no further from the first plain run than the
    second plain run is;
23. two ranks of sliding ``cli.evaluate.main`` over 4 synthetic 1024×2048
    images: the summed confusion equals one process's integer for integer,
    rank 0 alone writes ``result.txt``;
24. height-sharded whole-image inference: two ranks of ``cli.evaluate
    --whole 1 --space 2`` (gloo, one card) on the ``.pth`` of 8 (CCNet R101
    R=2 bf16, two 1024×2048 images, then MS+flip on one) and on seeded
    random PSPNet and DeepLabv3 R50 (one image each), each rank running the
    network on its rows of every image (halo-exchanged convolutions, the
    attention's q, k, v gathered: K7a on the whole map), against one
    process's ``--whole 1``: confusion totals equal, each rank's K7a
    launches equal one process's, and the library's sharded logits of the
    first image within MODEL_TOL × scale of one process's, argmax agreement
    >= MODEL_ARGMAX; per rank s/img, peak memory, the collectives' calls
    and bytes, K7a's launches.
    A rank that fails or outlasts DDP_TIMEOUT fails the run; the launcher
    and its ranks run in a session of their own and are killed with it;
25. the flagship learnability run, ``scripts/e2e_synthetic_torch.py``'s
    ``run``: CCNet R101 R=2 bf16 with OHEM (``ohem_keep`` 30000), device
    augmentation, batch 8 of 353² crops of 512×1024 ``LearnableDS`` images
    (each 64-pixel block one class, drawn as its colour plus noise), 300
    steps at lr 5e-3; the exported ``.pth`` scores 2 held-out images
    through the sliding ``Evaluator`` (bf16, K1/K2) and through the
    independent reference replica (``tests/_torch_reference_replica.py``,
    f32, plain attention): 300 finite losses, K1–K6's launches, held-out
    meanIU > 0.5 through both (else the plain route's run is raised beside
    it); the argmax agreement, the trained ``gamma``, card and host wall
    s/step and peak memory printed;
26. remat at scale, ``scripts/remat_scale_torch.py`` in a child process
    per batch and mode (CCNet R101 R=2 bf16 OHEM, random 769² batches, 2
    warm and 6 timed steps): at batch 16 every mode runs; at the batch
    that this card's bs-16 peaks per crop put 10 % past the free memory
    without remat and 10 % under it with remat (``True``), no remat runs
    out of memory and remat runs; s/step, crops/s and peak memory each;
27. whole-image batches, ``scripts/probe_whole_batch_torch.py``: CCNet
    R101 R=2 bf16 (seeded, ``gamma`` = 0.5) forward + ``predict_whole`` +
    argmax at B = 1, 2 and 4 over four 1024×2048 images (K7a at 129×257):
    each B fits, B = 2 and 4 give each image B = 1's argmax on at least
    99.9 % of its pixels; ms/batch and ms/img per B.
Each of 25–27 prints its seconds.

Every kernel's time stands beside its bound: the larger of the bytes the
function must move (each input read once, each output written once,
counted from this run's tensors, the attention's intermediates and
gradients in the value dtype as the TPU functions hold them) over 3.35
TB/s and its operations over the peak rate of its inputs' type (989
TFLOP/s bf16 tensor cores, 67 TFLOP/s f32). Timed calls cycle through
copies of their inputs that hold 4x the L2 cache between them, so every
time reads its inputs from HBM as the bound assumes. It prints one JSON
line of per-kernel results (launches summed over the main paths that run
each kernel, 15, 16, 24's ranks and 25–27 included; K5/K6 also carry their VOC row,
``voc_321``), then, as the last line, ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

also profiles one kernel-route train step of CCNet (769², batch 8),
PSPNet and DeepLabv3 and prints their top kernels by device time and the
time of the attention kernels (``cca_*``) among them.

    python3 chip_smoke.py --ddp-diagnostics

runs nothing of the above but the build: phase 21's readings for the two
ranks as they are and with each fault of DDP_FAULTS planted in both
(``_plant``), each with its s/step, then rank 0's trace of one two-rank
step split into global BN, collectives and the rest (``_trace_split``).

    python3 chip_smoke.py --ab outputs/parent

runs nothing of the above: it times P1/P4 (``probe_times``) and 4 steps of
``cli.train --synthetic`` at batch 8 of 769² with ``--num-workers 8``
(``train_wall``) in the checkout ``outputs/parent`` (a ``git archive`` of
the parent commit) and in this one, in turns (parent, this, this, parent),
each turn in its own process, and prints one ``[ab]`` JSON line per turn.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

SLIDING = (8, 97, 97, 64, 512)  # B, H, W, Cq, Cv of the sliding tile batch
VOC_CCA = (8, 41, 41, 64, 512)  # ... and of the VOC recipe's 321² crops and tiles
SHAPES = [SLIDING, VOC_CCA, (1, 129, 257, 64, 512), (2, 9, 8, 8, 16), (1, 1, 7, 4, 8),
          (1, 7, 1, 4, 8)]
# max |kernel - plain| <= TOL * max(1, max|plain|): f32 differs by summation
# order only; bf16 outputs are rounded to 8 bits of mantissa (2^-8 = 0.4%)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# full model: the two routes share every bf16 layer except CCA, whose
# outputs differ by bf16 rounding (the plain route rounds the attention
# weights to bf16); ~4 bf16 layers follow it
MODEL_TOL, MODEL_ARGMAX = 5e-2, 0.995
TIMING_REPS = 20
# K3/K4 and the Function's grads: f32 (TF32 off) differs by summation order;
# bf16 against the plain version in f32 from the same bf16 inputs, where the
# kernels round the output and the final grads to bf16
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the tensor-core K1–K4 against the plain versions fed the same bf16
# tensors, which round p (and de), o_col, the output and the grads where the
# kernels do: f32 sums in another order flip one of those roundings here
# and there (the same plain versions and the TPU kernels in interpret mode
# agree to 2^-8 x scale on the CPU)
TC_TOL = 1e-2
# ... and their bf16 outputs (K1's o_col, K2's out) bit-equal to the
# rounding plain versions' but for at most this share of flipped roundings;
# the plain version that keeps p in f32 differs from them in more
TC_FLIPS = 1e-2
# edge lines of the tensor-core designs beyond SHAPES (B, H, W, Cq, Cv): the
# longest line (128) of the one-block design on both paths, N = 16 / 17 with
# 4 or 8 q/k channels, and bf16 natural-route lines past 128, which K1–K4 run
# on the tensor-core line kernels: the forward at H = 129 and the model's
# widths (K1 on them, K2 not), and narrow widths with lines of 129 to 400
TC_EDGE_SHAPES = [(1, 128, 128, 64, 512), (2, 16, 17, 8, 16), (1, 17, 16, 4, 512),
                  (1, 129, 120, 64, 512), (2, 300, 200, 8, 16), (1, 300, 129, 8, 16)]
EVAL_AB_REPS = 6  # timed eval forwards of each CCA route, in turns
# B, H, W, Cq, Cv of the line route: whole image at scale 1.0 (and full-frame
# training), at scale 1.75, and edge shapes (N = 1 on either path)
LINE_SHAPES = [(1, 129, 257, 64, 512), (1, 225, 449, 64, 512), (2, 9, 441, 8, 16),
               (1, 1, 300, 4, 8), (1, 300, 1, 4, 8)]
# edge lines of the tensor-core K7a/K7b beyond LINE_SHAPES: N = 16, 17, 65,
# 128 and 463-465 on either path, Cq 12 and 128, odd Cv
LINE_TC_EDGE_SHAPES = [(2, 16, 17, 8, 16), (1, 65, 128, 64, 512), (1, 463, 5, 64, 512),
                       (1, 3, 464, 16, 32), (2, 465, 3, 12, 21), (1, 33, 97, 128, 64)]
TRAIN_AB_REPS = 3  # timed train steps of each route, in turns
# B, h, w, C, r of K5/K6: the 769² crops, small shapes, full frame (129 x 257
# -> 1025 x 2049), ragged column tiles (94 -> 24, 24, 24, 22; 85 -> 43, 42 at
# r = 4) and r = 256 (a tile's fine columns outnumber a block's threads); the
# large ones at ratios of 2^n, where the plain version's F.interpolate
# computes the source index exactly (at r = 3, W = 253 it misses by 1e-5)
LOSS_SHAPES = [(8, 97, 97, 19, 8), (2, 5, 7, 4, 3), (1, 9, 9, 6, 4), (2, 129, 257, 19, 8),
               (1, 5, 94, 19, 8), (2, 3, 85, 7, 4), (1, 2, 3, 3, 256)]
LOSS_TIMED = {"769²": LOSS_SHAPES[0], "full frame": LOSS_SHAPES[3]}  # the train steps' shapes
SPARSE_G = 0.02  # share of pixels with g != 0 in the sparse case (OHEM once trained)
NLL_TOL = 1e-5        # K5: max abs err of the f32 nll
NLL_GRAD_TOL = 1e-4   # K6: max abs err over max |plain grad|
CRITERION_AB_REPS = 6  # timed criterion_ohem_dsn forward + backward of each route, in turns
# train step, kernel route vs plain route from one state (bf16 model): the
# plain route rounds the attention weights to bf16 in the forward; the
# kernel route's backward takes delta = sum(out * g) from the bf16 output,
# as the JAX package's bf16 route does, and de = p (dp - delta) cancels.
# The q/k conv grads of the two routes differ by 5.4 % (relative norm) on
# the CPU stand-in (plain versions behind the Function, R50, 2 x 65^2).
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 0.15  # ||kernel grad - plain grad|| / ||plain grad||
TRAIN_BATCH, CROP, DEPTH, TRAIN_STEPS = 8, 769, 101, 4
# full-frame training: 1025x2049 crops (features 129x257, integer ratio 8 to
# the labels, so K5/K6 stay on) padded from the 1024x2048 images
FULL_FRAME, FULL_FRAME_BATCH, FULL_FRAME_STEPS = (1025, 2049), 2, 2
HEAD_TRAIN_STEPS = 2  # cli.train steps of PSPNet and DeepLabv3
MS_SCALES = (0.75, 1.0, 1.25, 1.5, 1.75)  # multi-scale + flip whole-image evaluation
EVAL_HW = (1024, 2048)  # the synthetic Cityscapes-sized images of training and evaluation
CCA_GRADS = ("head.cca.query_conv.weight", "head.cca.key_conv.weight",
             "head.cca.value_conv.weight", "head.cca.gamma")


# (wrapper, source in csrc/, the TPU kernel it replaces)
KERNELS = [
    ("cca_fwd_col", "cca_fwd.cu", "ccnet_tpu/ops/cc_attention_pallas.py:123"),
    ("cca_fwd_row", "cca_fwd.cu", "ccnet_tpu/ops/cc_attention_pallas.py:159"),
    ("cca_bwd_col", "cca_bwd.cu", "ccnet_tpu/ops/cc_attention_pallas.py:304"),
    ("cca_bwd_row", "cca_bwd.cu", "ccnet_tpu/ops/cc_attention_pallas.py:350"),
    ("upsampled_nll_fwd", "upsampled_ce.cu", "ccnet_tpu/ops/upsampled_ce.py:102"),
    ("upsampled_nll_bwd", "upsampled_ce.cu", "ccnet_tpu/ops/upsampled_ce.py:126"),
    ("cca_line_fwd", "cca_lines_tc.cu", "ccnet_tpu/ops/cc_attention_pallas.py:552"),
    ("cca_line_bwd", "cca_lines_tc.cu", "ccnet_tpu/ops/cc_attention_pallas.py:661"),
    ("mid_batch_dot", "probes.cu", "scripts/probe_mosaic.py:33"),
    ("swap_leading", "probes.cu", "scripts/probe_mosaic.py:55"),
    ("scale_ragged", "probes.cu", "scripts/probe_mosaic.py:70"),
    ("mid_batch_dot_4d", "probes.cu", "scripts/probe_mosaic.py:89"),
    ("store_transposed", "probes.cu", "scripts/probe_mosaic.py:119"),
]

# the H100 SXM's published peaks (NVIDIA's data sheet, dense): memory, and
# the rate of the operations on inputs of each type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# timed calls cycle through copies of their inputs holding 4x the H100's
# 50 MB L2 between them, so each call reads its inputs from HBM
ROTATE_BYTES = 4 * 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    log(smi)
    from ccnet_tpu_torch.utils import is_hopper

    cap = torch.cuda.get_device_capability(0)
    if not is_hopper():
        raise RuntimeError(f"need a Hopper card (capability 9.0), got {cap} "
                           f"({torch.cuda.get_device_name(0)})")
    log(f"[card] {torch.cuda.get_device_name(0)} capability {cap}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi


LIBRARIES = ("cca_fwd", "cca_bwd", "upsampled_ce", "cca_lines", "cca_lines_tc", "probes")


def phase_build() -> None:
    from ccnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_libraries(LIBRARIES)  # one nvcc per source, started together
    log(f"[build] {', '.join(LIBRARIES)} built in {time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {_build.BUILD_SECONDS[n]:.2f} s" for n in LIBRARIES) + ")")
    for name in LIBRARIES:
        for line in _build.PTXAS_REPORT.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")


def _inputs(shape, dtype, seed):
    B, H, W, Cq, Cv = shape
    rng = np.random.RandomState(seed)
    q, k = (torch.from_numpy(rng.randn(B, H, W, Cq).astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.randn(B, H, W, Cv).astype(np.float32))
    return [t.to("cuda", dtype) for t in (q, k, v)]


def _err(got, want) -> tuple:
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, max(1.0, want.abs().max().item())


def _flipped(got, want) -> float:
    """The share of the elements of ``got`` not bit-equal to ``want``."""
    return (got != want).float().mean().item()


def _rel_check(what: str, got, want, tol: float) -> float:
    """max |got - want| <= tol * max(1, max |want|); returns the error."""
    err, scale = _err(got, want)
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {tol:g} x scale {scale:.3g}")
    return err


def _copies(args) -> list:
    """Argument tuples for timing: ``args`` and copies of its tensors, as
    many as hold ROTATE_BYTES between them (at most 64)."""
    size = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    n = 1 if size == 0 else min(64, max(1, math.ceil(ROTATE_BYTES / size)))

    def copy(a):
        if not isinstance(a, torch.Tensor):
            return a
        return a.detach().clone().requires_grad_(a.requires_grad)

    return [tuple(args)] + [tuple(copy(a) for a in args) for _ in range(n - 1)]


def _time_ms(fn, *args, sets=None) -> float:
    """Median CUDA-event time of one ``fn(*args)`` over TIMING_REPS bursts,
    after warm-up. A burst is one call, or as many back-to-back calls as fill
    about 1 ms, so that a call of a few microseconds is not timed as the
    host's launch latency. Successive calls take successive argument tuples
    of ``sets`` (default :func:`_copies` of ``args``), and a burst's results
    stay allocated until it ends, so that no call reads an input that an
    earlier call left in the L2 cache, nor writes over an earlier output."""
    calls = itertools.cycle(sets or _copies(args))
    for _ in range(3):
        fn(*next(calls))
    times, n = [], 1
    for rep in range(TIMING_REPS + 1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        keep = [fn(*next(calls)) for _ in range(n)]
        b.record()
        b.synchronize()
        del keep
        if rep == 0:  # a first single call sizes the burst
            n = int(min(50, max(1, math.ceil(1.0 / max(a.elapsed_time(b), 1e-3)))))
        else:
            times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def _bound(inputs, outputs, flops: float, dtype) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each distinct input tensor read once, each output written once;
    views of one tensor count once) over HBM_BYTES_PER_S and ``flops`` over
    the peak rate of ``dtype``. An entry ``(t, dt)`` counts tensor ``t`` at
    the element size of ``dt``: the attention's TPU functions hold their
    intermediates and gradients in the value dtype where the port's kernels
    write f32, and the bound counts the bytes the function needs. The
    bytes the port moves are ``port_bytes``."""
    seen, nbytes, port = set(), 0, 0
    for entry in (*inputs, *outputs):
        t, dt = entry if isinstance(entry, tuple) else (entry, entry.dtype)
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            nbytes += t.numel() * dt.itemsize
            port += t.numel() * t.element_size()
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops
            else "operations", "bound_bytes": nbytes, "port_bytes": port, "bound_flops": flops}


def _in_value_dtype(tensors, dtype) -> list:
    """``tensors`` as :func:`_bound` counts them at ``dtype``."""
    return [(t, dtype) for t in tensors]


def _cca_flops(shape, fwd: bool, path: str) -> float:
    """FLOPs of one CCA path at (B, H, W, Cq, Cv): the forward's q·kᵀ and
    p·v (2·Cq + 2·Cv per pair), the backward's recomputed q·kᵀ, dq, dk
    (3 · 2·Cq) and g·vᵀ, dv (2 · 2·Cv); a path has B·W·H² (columns) or
    B·H·W² (rows) pairs."""
    B, H, W, Cq, Cv = shape
    pairs = B * W * H * H if path == "col" else B * H * W * W
    return pairs * (2 * (Cq + Cv) if fwd else 2 * (3 * Cq + 2 * Cv))


def _cca_mask(H: int, W: int, device) -> torch.Tensor:
    """(H·W, H·W) bool: pixel j is in pixel i's row or column (itself once)."""
    idx = torch.arange(H * W, device=device)
    r, c = idx // W, idx % W
    return (r[:, None] == r[None, :]) | (c[:, None] == c[None, :])


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def _sdpa_yardstick(q, k, v, g=None) -> tuple:
    """The one-call yardstick of the CCA on NHWC bf16 q, k, v:
    ``F.scaled_dot_product_attention(q, k, v, attn_mask=row-or-column,
    scale=1.0)`` on ``(B, 1, H·W, C)``, its forward (``g`` None) or forward
    + backward through autograd. Each backend is asked in turn; one that
    refuses the call is recorded with its reason; each one that runs is
    checked against the plain op (f32) at the bf16 tolerances, then timed.
    Returns (fastest ms, its backend, {backend: ms or refusal})."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ccnet_tpu_torch.ops import cc_attention as plain

    B, H, W, _ = q.shape
    mask = _cca_mask(H, W, q.device)
    flat = [t.detach().reshape(B, 1, H * W, t.shape[-1]).requires_grad_(g is not None)
            for t in (q, k, v)]
    if g is not None:
        flat.append(g.reshape(B, 1, H * W, -1))

    def call(backend, *qkvg):
        with sdpa_kernel(backend):
            out = F.scaled_dot_product_attention(*qkvg[:3], attn_mask=mask, scale=1.0)
            if g is None:
                return (out,)
            return torch.autograd.grad(out, qkvg[:3], qkvg[3])

    leaves = [t.detach().float().requires_grad_(g is not None) for t in (q, k, v)]
    want = plain.criss_cross_attention(*leaves)
    wants = (want,) if g is None else torch.autograd.grad(want, leaves, g.float())
    del want, leaves
    results = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with warnings.catch_warnings(record=True) as why:  # a refusal's reasons
                warnings.simplefilter("always")
                got = call(backend, *flat)
                torch.cuda.synchronize()
        except RuntimeError as e:  # this backend does not take the call: recorded
            reasons = [str(w.message).strip() for w in why
                       if not any(x in str(w.message) for x in ("not used because", "disabled"))]
            reasons.append(str(e).strip())
            results[name] = "refused: " + " | ".join(r.splitlines()[0][:160] for r in reasons
                                                     if r.splitlines())
            continue
        for i, (a, b) in enumerate(zip(got, wants)):
            _rel_check(f"SDPA {name} output {i} vs the plain CCA at {tuple(q.shape)}",
                       a.reshape(b.shape), b, TOL[torch.bfloat16] if g is None
                       else BWD_TOL[torch.bfloat16])
        del got
        results[name] = _time_ms(lambda *t: call(backend, *t), *flat)
    timed = {n: ms for n, ms in results.items() if isinstance(ms, float)}
    if not timed:
        raise RuntimeError(f"no SDPA backend ran the CCA yardstick: {results}")
    best = min(timed, key=timed.get)
    del mask, flat, wants
    torch.cuda.empty_cache()
    return timed[best], best, results


def _log_sdpa(tag: str, shape, res: tuple) -> None:
    ms, best, results = res
    log(f"[{tag}] library yardstick at {shape} bf16: F.scaled_dot_product_attention with the "
        f"row-or-column mask, fastest {best} {ms:.4f} ms; "
        + "; ".join(f"{n} {v:.4f} ms" if isinstance(v, float) else f"{n} {v}"
                    for n, v in results.items()))


def phase_kernels() -> dict:
    """K1/K2 against their plain versions, and the routed op against the
    joint-softmax oracle, at every shape in f32 and bf16 (and the edge lines
    of the tensor-core design in bf16). Where the call takes the
    tensor-core design (bf16, lines of at most 128) the plain versions get
    the same bf16 tensors and round where the kernels round; elsewhere (the
    CUDA-core kernel) they compute in f32. Then, at the sliding shape, times
    of both designs and the plain versions, and the CCA forward against the
    plain op."""
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    cases = [(torch.float32, s) for s in SHAPES]
    cases += [(torch.bfloat16, s) for s in SHAPES + TC_EDGE_SHAPES]
    with torch.inference_mode():
        for dtype, shape in cases:
            q, k, v = _inputs(shape, dtype, seed=sum(shape))
            q32, k32, v32 = q.float(), k.float(), v.float()
            tc = dtype == torch.bfloat16  # every bf16 design rounds p as the TPU kernels
            tol = TC_TOL if tc else TOL[dtype]
            before = dict(K.LAUNCHES)
            col = K.cca_fwd_col(q, k, v)
            row = K.cca_fwd_row(q, k, v, *col)  # K2 fed K1's own outputs
            out, m, L = K.criss_cross_attention_cuda(q, k, v)
            torch.cuda.synchronize()
            moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
            want = _cca_want(shape, dtype, fwd=1)  # the op's launches, K1/K2 or K7a
            _add_natural(want, shape, dtype, "fwd")  # and the wrappers' own
            if moved != want:
                raise RuntimeError(f"K1/K2 at {shape} {dtype} launched {moved}, not {want}")
            ins = (q, k, v) if tc else (q32, k32, v32)
            want_col, want_row = K.cca_fwd_col_plain(*ins), K.cca_fwd_row_plain(*ins, *col)
            checks = {
                "K1": zip(("o_col", "m_col", "l_col"), col, want_col),
                "K2": zip(("out", "m", "L"), row, want_row),
                "op": zip(("out", "m", "L"), (out, m, L),
                          plain.criss_cross_attention_stats(q32, k32, v32)),
            }
            errs = {}
            for kern, pairs in checks.items():
                for name, got, want in pairs:
                    errs[f"{kern}.{name}"] = _rel_check(f"{kern} {name} at {shape} {dtype}", got,
                                                        want, TOL[dtype] if kern == "op" else tol)
            if col[0].dtype != v.dtype:
                raise AssertionError(f"K1 o_col is {col[0].dtype}, not v's {v.dtype}")
            flips = ""
            if tc:  # p rounded where the plain versions round it, not kept in f32
                unrounded = K.cca_fwd_row_plain(q32, k32, v32, *K.cca_fwd_col_plain(q32, k32, v32))
                share = {"K1.o_col": _flipped(col[0], want_col[0]),
                         "K2.out": _flipped(row[0], want_row[0]),
                         "unrounded.out": _flipped(unrounded[0].to(v.dtype), want_row[0])}
                flips = " flipped " + " ".join(f"{n}={x:.2e}" for n, x in share.items())
                if max(share["K1.o_col"], share["K2.out"]) > TC_FLIPS:
                    raise AssertionError(f"K1/K2 at {shape}: {flips.strip()}, over {TC_FLIPS:g}")
                if share["unrounded.out"] <= TC_FLIPS:
                    raise AssertionError(f"at {shape} the unrounded plain version is within "
                                         f"{TC_FLIPS:g} of the rounding one: {flips.strip()}")
                del unrounded
            if shape[1] == 1 and not (torch.all(col[1] == plain.NEG_INF)
                                      and torch.all(col[2] == 1.0)):
                raise AssertionError(f"K1 at {shape} {dtype}: H = 1 stats are not (-1e9, 1)")
            if shape == SLIDING and dtype == torch.bfloat16:
                for kern, key in (("K1", "cca_fwd_col"), ("K2", "cca_fwd_row")):
                    report[key] = {"max_abs_err": max(e for n, e in errs.items()
                                                      if n.startswith(kern))}
            log(f"[kernels] {str(dtype)[6:]} {shape} {_designs(shape, dtype)}: "
                f"ok (K1/K2 tol {tol:g} x scale, op {TOL[dtype]:g}) "
                + " ".join(f"{n}={e:.2e}" for n, e in errs.items()) + flips)

        # times at the sliding shape, bf16: the tensor-core design, the
        # CUDA-core kernel forced at the same shape (the earlier design, held
        # against the f32 plain versions first) and the plain versions on the
        # same bf16 tensors; the yardstick of K1 + K2 is one SDPA forward
        bf16 = torch.bfloat16
        q, k, v = _inputs(SLIDING, bf16, seed=1)
        f32_ins = (q.float(), k.float(), v.float())
        col = K.cca_fwd_col(q, k, v)
        row = K.cca_fwd_row(q, k, v, *col)
        col_cc = K.cca_fwd_col(q, k, v, design="cuda_core")
        row_cc = K.cca_fwd_row(q, k, v, *col_cc, design="cuda_core")
        for kern, got_t, want_t in (("K1", col_cc, K.cca_fwd_col_plain(*f32_ins)),
                                    ("K2", row_cc, K.cca_fwd_row_plain(*f32_ins, *col_cc))):
            for i, (got, want) in enumerate(zip(got_t, want_t)):
                _rel_check(f"{kern} CUDA-core design output {i} at {SLIDING}", got, want,
                           TOL[bf16])
        del col_cc, row_cc, f32_ins
        report["cca_fwd_col"].update(_bound((q, k, v), col, _cca_flops(SLIDING, True, "col"),
                                            bf16))
        report["cca_fwd_row"].update(_bound((q, k, v, *col), row,
                                            _cca_flops(SLIDING, True, "row"), bf16))
        for name, extra in (("cca_fwd_col", ()), ("cca_fwd_row", col)):
            fn, fn_plain = getattr(K, name), getattr(K, f"{name}_plain")
            r = report[name]
            r["ms"] = _time_ms(fn, q, k, v, *extra)
            r["earlier_ms"] = _time_ms(lambda *a: fn(*a, design="cuda_core"), q, k, v, *extra)
            r["plain_ms"] = _time_ms(fn_plain, q, k, v, *extra)
            r.update(design="tensor cores (mma.sync m16n8k16 bf16), one block per line, p in "
                            "registers", share=r["bound_ms"] / r["ms"],
                     tflops=r["bound_flops"] / r["ms"] / 1e9)
        op_ms = _time_ms(K.criss_cross_attention_cuda, q, k, v)
        plain_op_ms = _time_ms(plain.criss_cross_attention, q, k, v)
        del col, row
    sdpa = _sdpa_yardstick(q, k, v)
    _log_sdpa("kernels", SLIDING, sdpa)
    for name in ("cca_fwd_col", "cca_fwd_row"):
        r = report[name]
        r["library_ms"] = sdpa[0]
        log(f"[kernels] {name} at {SLIDING} bf16: {r['design']} {r['ms']:.4f} ms "
            f"({r['share']:.1%} of the bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['tflops']:.1f} TFLOP/s); earlier design (CUDA cores, online softmax) "
            f"{r['earlier_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms (median of {TIMING_REPS})")
    log(f"[kernels] CCA forward at {SLIDING} bf16: kernels {op_ms:.4f} ms, plain "
        f"criss_cross_attention {plain_op_ms:.4f} ms (median of {TIMING_REPS})")
    return report


def phase_bwd_kernels() -> dict:
    """K3/K4 against their plain versions, and the autograd Function's grads
    against torch.autograd of the plain op, at every shape in f32 and bf16
    (and the edge lines of the tensor-core design in bf16). Where the call
    takes the tensor-core design (bf16, lines of at most 128) the plain
    version gets the same bf16 tensors and rounds where the kernels round;
    elsewhere (the CUDA-core pair) it computes in f32. Then times of both
    designs at the sliding shape."""
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    cases = [(torch.float32, s) for s in SHAPES]
    cases += [(torch.bfloat16, s) for s in SHAPES + TC_EDGE_SHAPES]
    for dtype, shape in cases:
        q, k, v = _inputs(shape, dtype, seed=sum(shape) + 1)
        g = _inputs(shape, dtype, seed=sum(shape) + 2)[2]
        q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
        tc = dtype == torch.bfloat16  # every bf16 design rounds p and de as the TPU kernels
        tol = TC_TOL if tc else BWD_TOL[dtype]
        with torch.no_grad():
            out, m, L = K.criss_cross_attention_cuda(q, k, v)
            delta = (g32 * out.float()).sum(dim=-1)
            before = dict(K.LAUNCHES)
            col = K.cca_bwd_col(q, k, v, g, m, L, delta)
            row = K.cca_bwd_row(q, k, v, g, m, L, delta, *col)
            torch.cuda.synchronize()
            moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
            if moved != _add_natural({n: 0 for n in K.LAUNCHES}, shape, dtype, "bwd"):
                raise RuntimeError(f"K3/K4 at {shape} {dtype} launched {moved}")
            ins = (q, k, v, g) if tc else (q32, k32, v32, g32)
            col_p = K.cca_bwd_col_plain(*ins, m, L, delta)
            row_p = K.cca_bwd_row_plain(*ins, m, L, delta, *col)
        errs = {}
        for kern, got_t, want_t in (("K3", col, col_p), ("K4", row, row_p)):
            for name, got, want in zip(("dq", "dk", "dv"), got_t, want_t):
                errs[f"{kern}.{name}"] = _rel_check(f"{kern} {name} at {shape} {dtype}",
                                                    got, want, tol)
        if shape[1] == 1 and any(c.abs().max().item() != 0.0 for c in col):
            raise AssertionError(f"K3 at {shape} {dtype}: H = 1 column grads are not all 0")
        # the Function (K1 K2 K3 K4) vs torch.autograd of the plain op in f32
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(K.criss_cross_attention_cuda(*leaves)[0], leaves, g)
        leaves32 = [t.detach().clone().requires_grad_(True) for t in (q32, k32, v32)]
        grads_p = torch.autograd.grad(plain.criss_cross_attention(*leaves32), leaves32, g32)
        for name, got, want in zip(("dq", "dk", "dv"), grads, grads_p):
            errs[f"fn.{name}"] = _rel_check(f"Function {name} at {shape} {dtype}",
                                            got, want, BWD_TOL[dtype])
        if shape == SLIDING and dtype == torch.bfloat16:
            for kern, key in (("K3", "cca_bwd_col"), ("K4", "cca_bwd_row")):
                report[key] = {"max_abs_err": max(e for n, e in errs.items()
                                                  if n.startswith(kern))}
        log(f"[bwd] {str(dtype)[6:]} {shape} {_designs(shape, dtype)}: ok "
            f"(K3/K4 tol {tol:g} x scale, Function {BWD_TOL[dtype]:g}) "
            + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))
        del q, k, v, g, out, m, L, delta, col, row, col_p, row_p, leaves, grads, grads_p

    # times at the training shape, bf16, of the tensor-core design, the
    # CUDA-core pair forced at the same shape (the earlier design) and the
    # plain version; the bounds count the column path's grads in the value
    # dtype, as both the TPU function and the tensor-core design write them
    bf16 = torch.bfloat16
    q, k, v = _inputs(SLIDING, bf16, seed=1)
    g = _inputs(SLIDING, bf16, seed=2)[2]
    with torch.no_grad():
        out, m, L = K.criss_cross_attention_cuda(q, k, v)
        delta = (g.float() * out.float()).sum(dim=-1)
        stats = (q, k, v, g, m, L, delta)
        col = K.cca_bwd_col(*stats)
        row = K.cca_bwd_row(*stats, *col)
        report["cca_bwd_col"].update(_bound(stats, _in_value_dtype(col, bf16),
                                            _cca_flops(SLIDING, False, "col"), bf16))
        report["cca_bwd_row"].update(_bound((*stats, *_in_value_dtype(col, bf16)), row,
                                            _cca_flops(SLIDING, False, "row"), bf16))
        del row
        for name, extra in (("cca_bwd_col", ()), ("cca_bwd_row", col)):
            fn, fn_plain = getattr(K, name), getattr(K, f"{name}_plain")
            r = report[name]
            r["ms"] = _time_ms(fn, *stats, *extra)
            r["earlier_ms"] = _time_ms(lambda *a: fn(*a, design="cuda_core"), *stats, *extra)
            r["plain_ms"] = _time_ms(fn_plain, *stats, *extra)
            r.update(design="tensor cores (mma.sync m16n8k16 bf16), one block per line",
                     share=r["bound_ms"] / r["ms"], tflops=r["bound_flops"] / r["ms"] / 1e9)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd(fn):
        return lambda q_, k_, v_, g_: torch.autograd.grad(fn(q_, k_, v_), (q_, k_, v_), g_)

    op_ms = _time_ms(fwd_bwd(lambda *a: K.criss_cross_attention_cuda(*a)[0]), *leaves, g)
    plain_op_ms = _time_ms(fwd_bwd(plain.criss_cross_attention), *leaves, g)
    del col, out, m, L, delta, leaves, stats
    sdpa = _sdpa_yardstick(q, k, v, g)  # forward + backward: the yardstick of K3 + K4
    _log_sdpa("bwd", SLIDING, sdpa)
    for name in ("cca_bwd_col", "cca_bwd_row"):
        r = report[name]
        r["library_ms"] = sdpa[0]
        log(f"[bwd] {name} at {SLIDING} bf16: {r['design']} {r['ms']:.4f} ms ({r['share']:.1%} "
            f"of the bound {r['bound_ms']:.4f} ms by {r['bound_by']}, {r['tflops']:.1f} TFLOP/s); "
            f"earlier design (CUDA cores, two passes, f32 scratch) {r['earlier_ms']:.4f} ms; "
            f"plain {r['plain_ms']:.4f} ms (median of {TIMING_REPS})")
    log(f"[bwd] CCA forward+backward at {SLIDING} bf16: kernels {op_ms:.4f} ms, plain "
        f"criss_cross_attention + autograd {plain_op_ms:.4f} ms (median of {TIMING_REPS})")
    return report


# the two views the line route hands K7a/K7b: (path, masked, view of NHWC)
LINE_PATHS = (("col", True, lambda t: t.transpose(1, 2)), ("row", False, lambda t: t))


def _line_check(shape, dtype, errs: dict, flips: dict) -> None:
    """K7a then K7b on both paths vs their plain versions, from the joint
    stats of the route's own combine. bf16 takes the tensor-core design and
    its plain versions the same bf16 tensors, rounding p and de where the
    kernels do (K7a's o must also be bit-equal to theirs but for at most
    TC_FLIPS of its elements, and the plain version that keeps p in f32
    must differ in more on lines of 64 and longer); f32 the CUDA-core
    design against the f32 plain versions."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    tc = dtype == torch.bfloat16
    tol = TC_TOL if tc else BWD_TOL[dtype]
    round_to = torch.bfloat16 if tc else None
    q, k, v = _inputs(shape, dtype, seed=sum(shape) + 3)
    g = _inputs(shape, dtype, seed=sum(shape) + 4)[2]
    with torch.no_grad():
        before = dict(K.LAUNCHES)
        fwd = {}
        for path, masked, view in LINE_PATHS:
            fwd[path] = K.cca_line_fwd(view(q), view(k), view(v), masked)
            want = K.cca_line_fwd_plain(view(q), view(k), view(v), masked, round_to=round_to)
            want = (want[0].to(v.dtype), *want[1:])
            for name, got, ref in zip(("o", "m", "l"), fwd[path], want):
                errs[f"K7a.{path}.{name}"] = _rel_check(
                    f"K7a {path} {name} at {shape} {dtype}", got, ref, tol)
            if tc:
                flips[f"K7a.{path}.o"] = _flipped(fwd[path][0], want[0])
                unrounded = K.cca_line_fwd_plain(*(view(t).float() for t in (q, k, v)), masked)[0]
                flips[f"unrounded.{path}.o"] = _flipped(unrounded.to(v.dtype), want[0])
                if flips[f"K7a.{path}.o"] > TC_FLIPS:
                    raise AssertionError(f"K7a {path} at {shape}: {flips}, over {TC_FLIPS:g}")
                if view(q).shape[2] >= 64 and flips[f"unrounded.{path}.o"] <= TC_FLIPS:
                    raise AssertionError(f"K7a {path} at {shape}: the unrounded plain version is "
                                         f"within {TC_FLIPS:g} of the rounding one: {flips}")
        o_c, m_c, l_c = (K._to_col(t) for t in fwd["col"])
        out, m, L = K._combine(o_c.float(), m_c, l_c, fwd["row"][0].float(), *fwd["row"][1:])
        delta = (g.float() * out).sum(dim=-1)
        for path, masked, view in LINE_PATHS:
            args = [view(t) for t in (q, k, v, g, m, L, delta)]
            got = K.cca_line_bwd(*args, masked)
            want = K.cca_line_bwd_plain(*args, masked, round_to=round_to)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                errs[f"K7b.{path}.{name}"] = _rel_check(f"K7b {path} {name} at {shape} {dtype}",
                                                        a, b.to(a.dtype), tol)
                if tc:
                    flips[f"K7b.{path}.{name}"] = _flipped(a, b.to(a.dtype))
        torch.cuda.synchronize()
        moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
        if moved != {**{n: 0 for n in K.LAUNCHES}, "cca_line_fwd": 2, "cca_line_bwd": 2,
                     "cca_line_fwd_tc": 2 * tc, "cca_line_bwd_tc": 2 * tc}:
            raise RuntimeError(f"K7a/K7b at {shape} {dtype} launched {moved}")
    if shape[1] == 1 and not (torch.all(fwd["col"][1] == -1e9) and torch.all(fwd["col"][2] == 1.0)
                              and torch.equal(fwd["col"][0].to(v.dtype), K._to_col(v))):
        raise AssertionError(f"K7a at {shape} {dtype}: the all-self-slot column is not "
                             f"(o = v, m = -1e9, l = 1)")


def phase_line_kernels() -> dict:
    """K7a/K7b against their plain versions on both paths as the line route
    calls them (columns through the transposed view, masked; rows), and the
    routed Function's output and grads against torch.autograd of the plain
    op, at every line shape in f32 and bf16 (and the tensor-core design's
    edge lines in bf16). Then CUDA-event times at the long shapes: each
    kernel in both designs vs its plain version, and the route's forward
    and forward + backward vs K1–K4 forced at the same shape and vs the
    plain op."""
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"cca_line_fwd": {"max_abs_err": 0.0}, "cca_line_bwd": {"max_abs_err": 0.0}}
    cases = [(torch.float32, s) for s in LINE_SHAPES]
    cases += [(torch.bfloat16, s) for s in LINE_SHAPES + LINE_TC_EDGE_SHAPES]
    for dtype, shape in cases:
        errs, flips = {}, {}
        _line_check(shape, dtype, errs, flips)
        if shape in LINE_SHAPES:  # the routed Function vs torch.autograd of the plain op in f32
            q, k, v = _inputs(shape, dtype, seed=sum(shape) + 3)
            g = _inputs(shape, dtype, seed=sum(shape) + 4)[2]
            f32 = [t.float() for t in (q, k, v, g)]
            before = dict(K.LAUNCHES)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            out_fn = K.criss_cross_attention_cuda(*leaves)[0]
            grads = torch.autograd.grad(out_fn, leaves, g)
            leaves32 = [t.detach().clone().requires_grad_(True) for t in f32[:3]]
            out_p = plain.criss_cross_attention(*leaves32)
            grads_p = torch.autograd.grad(out_p, leaves32, f32[3])
            torch.cuda.synchronize()
            moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
            want = _cca_want(shape, dtype, fwd=1, bwd=1)
            if moved != want:
                raise AssertionError(f"the Function at {shape} {dtype} launched {moved}, "
                                     f"not {want}")
            tol = BWD_TOL[dtype]
            errs["fn.out"] = _rel_check(f"Function out at {shape} {dtype}", out_fn, out_p, tol)
            for name, a, b in zip(("dq", "dk", "dv"), grads, grads_p):
                errs[f"fn.{name}"] = _rel_check(f"Function {name} at {shape} {dtype}", a, b, tol)
            del q, k, v, g, f32, leaves, out_fn, grads, leaves32, out_p, grads_p
        if shape == LINE_SHAPES[0] and dtype == torch.bfloat16:
            for kern, key in (("K7a", "cca_line_fwd"), ("K7b", "cca_line_bwd")):
                report[key]["max_abs_err"] = max(e for n, e in errs.items() if n.startswith(kern))
        log(f"[lines] {str(dtype)[6:]} {shape} "
            f"{'tensor cores' if dtype == torch.bfloat16 else 'CUDA cores'}: ok (kernels tol "
            f"{TC_TOL if dtype == torch.bfloat16 else BWD_TOL[dtype]:g} x scale, Function "
            f"{BWD_TOL[dtype]:g}) " + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
            + (" flipped " + " ".join(f"{n}={x:.2e}" for n, x in flips.items()) if flips else ""))
        torch.cuda.empty_cache()

    def line_fwd(fn):
        return lambda q, k, v: [fn(view(q), view(k), view(v), masked)
                                for _, masked, view in LINE_PATHS]

    def line_bwd(fn):
        return lambda *qkvgmld: [fn(*(view(t) for t in qkvgmld), masked)
                                 for _, masked, view in LINE_PATHS]

    def k1_k4(q, k, v, g):  # the natural route forced at a long shape (K7a/K7b's kernels)
        o, m_, L_ = K.cca_fwd_row(q, k, v, *K.cca_fwd_col(q, k, v))
        d = (g.float() * o.float()).sum(dim=-1)
        K.cca_bwd_row(q, k, v, g, m_, L_, d, *K.cca_bwd_col(q, k, v, g, m_, L_, d))

    def fwd_bwd(fn):
        return lambda q, k, v, g: torch.autograd.grad(fn(q, k, v), (q, k, v), g)

    bf16 = torch.bfloat16
    cuda_core = {"design": "cuda_core"}
    rounding = {"round_to": bf16}
    for shape in LINE_SHAPES[:2]:  # the long shapes, bf16
        q, k, v = _inputs(shape, bf16, seed=1)
        g = _inputs(shape, bf16, seed=2)[2]
        with torch.no_grad():
            out, m, L = K.criss_cross_attention_cuda(q, k, v)
            delta = (g.float() * out.float()).sum(dim=-1)
            stats = (q, k, v, g, m, L, delta)
            if shape == LINE_SHAPES[0]:  # the CUDA-core design forced here: the f32 function
                f32 = [t.float() for t in stats[:4]]
                for kern, got_t, want_t in (
                        ("K7a", line_fwd(lambda *a: K.cca_line_fwd(*a, **cuda_core))(q, k, v),
                         line_fwd(K.cca_line_fwd_plain)(*f32[:3])),
                        ("K7b", line_bwd(lambda *a: K.cca_line_bwd(*a, **cuda_core))(*stats),
                         line_bwd(K.cca_line_bwd_plain)(*f32, m, L, delta))):
                    for p, (got_p, want_p) in enumerate(zip(got_t, want_t)):
                        for i, (got, want) in enumerate(zip(got_p, want_p)):
                            _rel_check(f"{kern} CUDA-core design path {p} output {i} at {shape}",
                                       got, want, BWD_TOL[bf16])
                del f32, got_t, want_t
            t = {"K7a": _time_ms(line_fwd(K.cca_line_fwd), q, k, v),
                 "K7a CUDA-core": _time_ms(line_fwd(
                     lambda *a: K.cca_line_fwd(*a, **cuda_core)), q, k, v),
                 "K7a plain": _time_ms(line_fwd(
                     lambda *a: K.cca_line_fwd_plain(*a, **rounding)), q, k, v),
                 "K7b": _time_ms(line_bwd(K.cca_line_bwd), *stats),
                 "K7b CUDA-core": _time_ms(line_bwd(
                     lambda *a: K.cca_line_bwd(*a, **cuda_core)), *stats),
                 "K7b plain": _time_ms(line_bwd(
                     lambda *a: K.cca_line_bwd_plain(*a, **rounding)), *stats),
                 "route fwd": _time_ms(K.cca_line_route_fwd, q, k, v),
                 "K1+K2 fwd": _time_ms(lambda *a: K.cca_fwd_row(*a, *K.cca_fwd_col(*a)), q, k, v),
                 "plain fwd": _time_ms(plain.criss_cross_attention, q, k, v),
                 "K1-K4 fwd+bwd": _time_ms(k1_k4, q, k, v, g)}
        leaves = [t_.detach().clone().requires_grad_(True) for t_ in (q, k, v)]
        t["route fwd+bwd"] = _time_ms(fwd_bwd(lambda *a: K.criss_cross_attention_cuda(*a)[0]),
                                      *leaves, g)
        t["plain fwd+bwd"] = _time_ms(fwd_bwd(plain.criss_cross_attention), *leaves, g)
        with torch.no_grad():  # both paths of one call, as timed
            fwd_out = [e for o, m_, l_ in line_fwd(K.cca_line_fwd)(q, k, v) for e in (o, m_, l_)]
            bwd_out = [e for grads in line_bwd(K.cca_line_bwd)(*stats) for e in grads]
        bounds = {"K7a": _bound((q, k, v), fwd_out,
                                sum(_cca_flops(shape, True, p) for p in ("col", "row")), bf16),
                  "K7b": _bound(stats, bwd_out,
                                sum(_cca_flops(shape, False, p) for p in ("col", "row")), bf16)}
        # K7b's dq parts: ceil(N / 64) x pixels x Cq f32 per path, written and read back
        B, H, W, Cq, _ = shape
        dq_part_mb = sum(-(-n // 64) for n in (H, W)) * B * H * W * Cq * 4 * 2 / 1e6
        del fwd_out, bwd_out, out, m, L, delta, leaves, stats
        torch.cuda.empty_cache()
        if shape == LINE_SHAPES[0]:  # the yardstick's row-or-column mask is 1.1 GB here
            fwd_sdpa, bwd_sdpa = _sdpa_yardstick(q, k, v), _sdpa_yardstick(q, k, v, g)
            _log_sdpa("lines fwd", shape, fwd_sdpa)
            _log_sdpa("lines fwd+bwd", shape, bwd_sdpa)
            design = ("tensor cores (mma.sync m16n8k16 bf16), keys tiled by 64, p rounded to bf16 "
                      "after the line's max")
            for kern, key, sdpa in (("K7a", "cca_line_fwd", fwd_sdpa),
                                    ("K7b", "cca_line_bwd", bwd_sdpa)):
                r = report[key]
                r.update(ms=t[kern], earlier_ms=t[f"{kern} CUDA-core"], plain_ms=t[f"{kern} plain"],
                         library_ms=sdpa[0], **bounds[kern])
                r.update(design=design, share=r["bound_ms"] / r["ms"],
                         tflops=r["bound_flops"] / r["ms"] / 1e9)
        else:
            log(f"[lines] library yardstick at {shape}: not run, its (H·W)² bool mask would "
                f"take {(shape[1] * shape[2]) ** 2 / 1e9:.1f} GB")
        log(f"[lines] times at {shape} bf16, ms (median of {TIMING_REPS}; K7a/K7b: both paths "
            f"of one call, two launches; plain: the rounding plain versions on the bf16 tensors): "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in t.items())
            + "; bounds " + ", ".join(
                f"{n} {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bound_ms'] / t[n]:.1%} of "
                f"it; {b['bound_bytes'] / 1e6:.1f} MB, port {b['port_bytes'] / 1e6:.1f} MB, "
                f"{b['bound_flops'] / 1e9:.1f} GFLOP)" for n, b in bounds.items())
            + f"; K7b also writes and reads {dq_part_mb:.1f} MB of dq parts")
    return report


def _loss_case(shape, seed, live: float = 1.0):
    """logits, int32 labels (15 % ignore) and g, nonzero on a share ``live``
    of the pixels."""
    B, h, w, C, r = shape
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32)).cuda()
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.15] = 255  # ignore pixels
    g = rng.rand(B, H, W).astype(np.float32)
    g[rng.rand(B, H, W) >= live] = 0.0
    return logits, torch.from_numpy(labels).cuda(), torch.from_numpy(g).cuda()


def _check_loss_case(shape, live: float) -> dict:
    """K5/K6 and the autograd Function at ``shape`` with int32 and uint8
    labels and g live on ``live`` of the pixels, against the materialised
    upsample + NLL and its autograd; returns the largest errors."""
    from ccnet_tpu_torch.ops import upsampled_ce as U

    logits, labels, g = _loss_case(shape, seed=sum(shape), live=live)
    errs = {}
    for lab in (labels, labels.to(torch.uint8)):
        before = dict(U.LAUNCHES)
        nll = U.upsampled_nll_fwd(logits, lab)
        dl = U.upsampled_nll_bwd(logits, lab, g)
        x = logits.clone().requires_grad_(True)
        fn_nll = U.UpsampledNLLFn.apply(x, lab)
        (fn_dl,) = torch.autograd.grad(fn_nll, x, g)
        torch.cuda.synchronize()
        if U.LAUNCHES != {n: c + 2 for n, c in before.items()}:
            raise RuntimeError(f"launch counts did not advance: {before} -> {U.LAUNCHES}")
        want_nll = U.upsampled_nll_reference(logits, lab)
        want_dl = U.upsampled_nll_bwd_plain(logits, lab, g)
        tag = f"{shape} {str(lab.dtype)[6:]} labels, g live on {live:.0%}"
        if live == 0.0 and float(dl.abs().max()) != 0.0:
            raise AssertionError(f"K6 at {tag}: a zero g gives a nonzero gradient")
        for name, got, want, tol in (("K5", nll, want_nll, NLL_TOL),
                                     ("fn.fwd", fn_nll, want_nll, NLL_TOL),
                                     ("K6", dl, want_dl, NLL_GRAD_TOL),
                                     ("fn.bwd", fn_dl, want_dl, NLL_GRAD_TOL)):
            err = (got - want).abs().max().item()
            limit = tol * (1.0 if name in ("K5", "fn.fwd") else want.abs().max().item())
            if not err <= limit:
                raise AssertionError(f"{name} at {tag}: max abs err {err:.3e} > {limit:.3e}")
            errs[name] = max(errs.get(name, 0.0), err)
        del nll, dl, x, fn_nll, fn_dl, want_nll, want_dl
    log(f"[loss] {shape} (B, h, w, C, r), int32 and uint8 labels, g live on {live:.0%}: ok "
        f"(K5 <= {NLL_TOL:g} abs, K6 <= {NLL_GRAD_TOL:g} x max|plain grad|) "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))
    del logits, labels, g
    torch.cuda.empty_cache()
    return errs


def phase_loss_kernels() -> dict:
    """K5/K6 against the materialised upsample + NLL and its autograd, int32
    and uint8 labels, at every shape of LOSS_SHAPES, with a dense g and, at
    the 769² shape, a g nonzero on SPARSE_G of the pixels and one zero
    everywhere; then :func:`loss_times` and :func:`criterion_ab`."""
    cases = [(shape, 1.0) for shape in LOSS_SHAPES] + [(LOSS_SHAPES[0], SPARSE_G),
                                                       (LOSS_SHAPES[0], 0.0)]
    for shape, live in cases:
        errs = _check_loss_case(shape, live)
        if shape == LOSS_SHAPES[0] and live == 1.0:
            report = {"upsampled_nll_fwd": {"max_abs_err": errs["K5"]},
                      "upsampled_nll_bwd": {"max_abs_err": errs["K6"]}}
    for name, r in loss_times().items():
        report[name].update(r)
    criterion_ab()
    return report


def _loss_shape_times(tag: str, shape) -> tuple:
    """CUDA-event times of K5 and K6 and of their plain versions at
    ``shape``, K6 with a dense g, with one live on SPARSE_G of the pixels and
    with g = 0, each beside its bound (logged); returns ``(times, bounds)``."""
    from ccnet_tpu_torch.ops import upsampled_ce as U

    B, h, w, C, r = shape
    t, b = {}, {}
    for live in (1.0, SPARSE_G, 0.0):  # g = 0: K6's cost without a softmax
        logits, labels, g = _loss_case(shape, seed=7, live=live)
        kind = {1.0: "dense", SPARSE_G: "sparse", 0.0: "zero g"}[live]
        t[f"K6 {kind}"] = _time_ms(U.upsampled_nll_bwd, logits, labels, g)
        # the operations the function needs per live fine pixel and class:
        # the height lerp (2), the width lerp shared by r rows (~1), exp
        # and sum (2); the backward twice that (recompute, then the
        # transposed lerps); every valid pixel's nll, the live pixels' grad
        valid = int((labels != 255).sum())
        active = int(((labels != 255) & (g != 0)).sum())
        b[f"K6 {kind}"] = _bound((logits, labels, g), (U.upsampled_nll_bwd(logits, labels, g),),
                                 10 * C * active, torch.float32)
        if live == 1.0:
            t["K5"] = _time_ms(U.upsampled_nll_fwd, logits, labels)
            t["K5 plain"] = _time_ms(U.upsampled_nll_reference, logits, labels)
            b["K5"] = _bound((logits, labels), (U.upsampled_nll_fwd(logits, labels),),
                             5 * C * valid, torch.float32)
            graphs = []  # one graph per copy of the inputs, its backward timed alone
            for lg, lab, gg in _copies((logits, labels, g)):
                x = lg.clone().requires_grad_(True)
                graphs.append((U.upsampled_nll_reference(x, lab), x, gg))
            t["K6 plain"] = _time_ms(
                lambda nll, x, g_: torch.autograd.grad(nll, x, g_, retain_graph=True),
                sets=graphs)
            del graphs
        del logits, labels, g
        torch.cuda.empty_cache()
    log(f"[loss] times at {shape} (B, h, w, C, r) -> {tag}, ms (median of {TIMING_REPS}): "
        + ", ".join(f"{n} {ms:.4f}" for n, ms in t.items())
        + f"; K6 dense / sparse {t['K6 dense'] / t['K6 sparse']:.2f}; bounds "
        + ", ".join(f"{n} {x['bound_ms']:.4f} ms by {x['bound_by']} ({x['bound_ms'] / t[n]:.1%} "
                    f"of it; {x['bound_bytes'] / 1e6:.1f} MB, {x['bound_flops'] / 1e9:.2f} GFLOP)"
                    for n, x in b.items()))
    return t, b


def _loss_rows(t: dict, b: dict) -> dict:
    """K5's and K6's (dense g) report rows from :func:`_loss_shape_times`."""
    rows = {}
    for name, kern in (("upsampled_nll_fwd", "K5"), ("upsampled_nll_bwd", "K6 dense")):
        plain = t[f"{kern.split()[0]} plain"]
        rows[name] = {"ms": t[kern], "plain_ms": plain, "library_ms": None, **b[kern],
                      "share": b[kern]["bound_ms"] / t[kern]}
    rows["upsampled_nll_bwd"]["sparse_ms"] = t["K6 sparse"]
    return rows


def loss_times() -> dict:
    """:func:`_loss_shape_times` at the shapes of LOSS_TIMED; returns the
    769² numbers as the report's. Uses only what every version of
    ``ccnet_tpu_torch`` has, so it also times an earlier tree's kernels (run
    from its checkout)."""
    report = {}
    for tag, shape in LOSS_TIMED.items():
        t, b = _loss_shape_times(tag, shape)
        if shape == LOSS_SHAPES[0]:
            report = _loss_rows(t, b)
            for row in report.values():
                row["design"] = ("one block per (image, coarse band or row, tile of coarse "
                                 "columns), the band in shared memory")
    for name in report:  # F.interpolate + F.cross_entropy: two calls
        log(f"[loss] {name}: no one library call computes it")
    return report


def criterion_ab(reps: int = CRITERION_AB_REPS) -> dict:
    """``criterion_ohem_dsn`` forward + backward at the 769² step's main and
    DSN logits (8, 19, 97, 97) f32 and labels (8, 769, 769): the kernel
    route (K5/K6) against the plain route (materialised upsample), the two
    agreeing first, then timed in turns (kernel, plain, plain, kernel, ...)
    after one untimed call of each; returns the medians (ms)."""
    from ccnet_tpu_torch.losses import criterion_ohem_dsn

    B, h, w, C, r = LOSS_SHAPES[0]
    rng = np.random.RandomState(11)
    heads = [torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32)).cuda().requires_grad_(True)
             for _ in range(2)]
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    y = rng.randint(0, C, (B, H, W)).astype(np.int32)
    y[rng.rand(B, H, W) < 0.1] = 255
    y = torch.from_numpy(y).cuda()

    def step(impl):
        loss = criterion_ohem_dsn({"main": heads[0], "aux": heads[1]}, y, impl=impl)
        return (loss, *torch.autograd.grad(loss, heads))

    got = {impl: step(impl) for impl in ("kernel", "torch")}
    rel = abs(got["kernel"][0].item() - got["torch"][0].item()) / abs(got["torch"][0].item())
    gerr = max((a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(got["kernel"][1:], got["torch"][1:]))
    del got
    times = {"kernel": [], "torch": []}
    for rep in range(reps):
        for impl in ("kernel", "torch") if rep % 2 == 0 else ("torch", "kernel"):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            step(impl)
            end.record()
            end.synchronize()
            times[impl].append(start.elapsed_time(end))
    med = {impl: float(np.median(v)) for impl, v in times.items()}
    log(f"[loss] criterion_ohem_dsn forward + backward at main/DSN {(B, C, h, w)} -> {H}x{W}, "
        f"the two NLL routes in turns: kernel median {med['kernel']:.4f} ms, plain median "
        f"{med['torch']:.4f} ms, kernel faster by {med['torch'] - med['kernel']:.4f} ms (CUDA "
        f"events, {reps} each; kernel {' '.join(f'{v:.4f}' for v in times['kernel'])}; plain "
        f"{' '.join(f'{v:.4f}' for v in times['torch'])}); loss rel diff {rel:.2e}, grads "
        f"{gerr:.2e} x max")
    if not rel <= 1e-4 or not gerr <= NLL_GRAD_TOL * 10:
        raise AssertionError(f"criterion_ohem_dsn: kernel route disagrees (loss {rel:.2e}, "
                             f"grads {gerr:.2e})")
    del heads, y
    torch.cuda.empty_cache()
    return med


# the probes: wrapper -> (the script's shape, the model's shape, input dtype);
# P1, P2, P3 at the model's widths: one image's columns of q (H, W, 64) and
# of v (H, W, 512), and a scale over an f32 tensor of o_col's size (8·97·97, 512)
PROBES = {
    "mid_batch_dot": ((96, 16, 64), (97, 97, 64), torch.bfloat16),
    "swap_leading": ((96, 16, 128), (97, 97, 512), torch.bfloat16),
    "scale_ragged": ((97, 256), (8 * 97 * 97, 512), torch.float32),
    "mid_batch_dot_4d": ((2, 96, 33, 64), (8, 97, 97, 64), torch.bfloat16),
    "store_transposed": ((2, 96, 33, 512), (8, 97, 97, 512), torch.bfloat16),
}
PROBE_DOT_TOL = 1e-4  # x scale: the same bf16 products, f32 sums in another order
# the dot's other paths (csrc/probes.cu): (wrapper, shape, first element's offset);
# one pixel, scalar staging (C % 8 != 0, or a base 2 bytes past 16), bands
# past 64 tiles (H = 231), three channel chunks, P4 with bands of a ragged line
PROBE_DOT_EDGES = [("mid_batch_dot", (1, 1, 8), 0), ("mid_batch_dot", (7, 3, 70), 0),
                   ("mid_batch_dot", (97, 97, 64), 1), ("mid_batch_dot", (231, 2, 64), 0),
                   ("mid_batch_dot", (97, 97, 136), 0), ("mid_batch_dot_4d", (1, 33, 5, 8), 0)]
PROBE_HOST_CALLS = 200  # back-to-back calls timed on the host's clock
PROBE_TRACE_CALLS = 20  # back-to-back calls traced by torch.profiler


def _probe_inputs(name: str, shape) -> list:
    _, _, dtype = PROBES[name]
    rng = np.random.RandomState(sum(shape))
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to("cuda", dtype)
            for _ in range(2 if "dot" in name else 1)]


def _probe_library(name: str):
    """The one PyTorch call computing probe ``name``'s function: a bf16
    ``einsum`` for the dots, the plain version (``contiguous()``, ``2*x``)
    for the copies and the scale."""
    from ccnet_tpu_torch.ops import probes as P

    if "dot" not in name:
        return getattr(P, f"{name}_plain")
    eq = "htc,gtc->thg" if name == "mid_batch_dot" else "bhwc,bgwc->bwhg"
    return lambda *a: torch.einsum(eq, *a)


def _device_us(fn, sets) -> tuple:
    """(device µs per call, kernels per call) of PROBE_TRACE_CALLS
    back-to-back ``fn`` calls under ``torch.profiler``, from the exported
    chrome trace's kernel events (their device time alone). A trace now and
    then comes back without its kernel events; it is taken again, up to
    three times in all, and then reported as not measured (None, None)."""
    from torch.profiler import ProfilerActivity, profile

    calls = itertools.cycle(sets)
    for _ in range(3):
        fn(*next(calls))
    for _ in range(3):
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                keep = [fn(*next(calls)) for _ in range(PROBE_TRACE_CALLS)]
                torch.cuda.synchronize()
            del keep
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                durs = [e["dur"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        if durs:
            return sum(durs) / PROBE_TRACE_CALLS, len(durs) / PROBE_TRACE_CALLS
    log("[probe-times] torch.profiler recorded no kernel on the card in three traces: "
        "device time not measured")
    return None, None


def _host_us(fn, sets) -> float:
    """Host wall µs per call of back-to-back ``fn`` calls with no
    synchronise between them, the pace at which the host issues the work
    whatever the device does with it: the median over 10 rounds of
    PROBE_HOST_CALLS / 10 calls (the host's cores are shared)."""
    calls = itertools.cycle(sets)
    for _ in range(3):
        fn(*next(calls))
    n, rounds = PROBE_HOST_CALLS // 10, []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*next(calls))
        rounds.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return float(np.median(rounds))


def probe_times(names=tuple(PROBES)) -> dict:
    """At the model's shapes, for each probe of ``names``: the burst time
    of :func:`_time_ms` (``ms``) of the kernel, of its plain version and of
    the one library call, and for the kernel and the library call the
    device µs and host µs per call (:func:`_device_us`, :func:`_host_us`);
    the burst time is about the larger of the two. Uses only what every
    version of ``ccnet_tpu_torch.ops.probes`` has, so it also times an
    earlier tree's kernels (run from its checkout)."""
    from ccnet_tpu_torch.ops import probes as P

    report = {}
    for name in names:
        shape = PROBES[name][1]
        sets = _copies(_probe_inputs(name, shape))
        kernel, plain, library = getattr(P, name), getattr(P, f"{name}_plain"), _probe_library(name)
        r = {"ms": _time_ms(kernel, sets=sets), "library_ms": _time_ms(library, sets=sets)}
        r["plain_ms"] = _time_ms(plain, sets=sets) if "dot" in name else r["library_ms"]
        r["device_us"], r["kernels_per_call"] = _device_us(kernel, sets)
        r["host_us"] = _host_us(kernel, sets)
        r["library_device_us"], r["library_kernels_per_call"] = _device_us(library, sets)
        r["library_host_us"] = _host_us(library, sets)
        report[name] = r
        us = {k: "not measured" if v is None else f"{v:.2f}" for k, v in r.items()}
        log(f"[probe-times] {name} at {shape}: kernel burst {r['ms'] * 1e3:.2f} µs/call, device "
            f"{us['device_us']} µs/call ({us['kernels_per_call']} kernels), host "
            f"{us['host_us']} µs/call; library burst {r['library_ms'] * 1e3:.2f}, device "
            f"{us['library_device_us']} ({us['library_kernels_per_call']} kernels), host "
            f"{us['library_host_us']}; plain burst {r['plain_ms'] * 1e3:.2f} (bursts: median "
            f"of {TIMING_REPS}; device: {PROBE_TRACE_CALLS} calls under torch.profiler; host: "
            f"median of 10 rounds of {PROBE_HOST_CALLS // 10} calls, no synchronise)")
        del sets
    torch.cuda.empty_cache()
    return report


# design variants of csrc/probes.cu's copy and scale kernels, as text edits
# of the source: (old, new) pairs, each of which must occur
PROBE_VARIANTS = {
    "streaming hints": [
        ("v[u] = x[(a * p.b + b) * p.r + (i - row * p.r)];",
         "v[u] = __ldcs(&x[(a * p.b + b) * p.r + (i - row * p.r)]);"),
        ("if (i < plane) y[i] = v[u];", "if (i < plane) __stcs(&y[i], v[u]);"),
        ("if (i < p.body) v[u] = x4[i];", "if (i < p.body) v[u] = __ldcs(&x4[i]);"),
        ("if (i < p.body) y4[i] = make_float4(v[u].x * s, v[u].y * s, v[u].z * s, v[u].w * s);",
         "if (i < p.body) __stcs(&y4[i], make_float4(v[u].x * s, v[u].y * s, v[u].z * s, "
         "v[u].w * s));")],
    "128 threads x 2 loads": [
        ("constexpr int COPY_THREADS = 256;", "constexpr int COPY_THREADS = 128;"),
        ("constexpr int COPY_UNROLL = 1;", "constexpr int COPY_UNROLL = 2;")],
    "256 threads x 4 loads": [("constexpr int COPY_UNROLL = 1;", "constexpr int COPY_UNROLL = 4;")],
}


def _probes_variant(name: str, edits) -> tuple:
    """``csrc/probes.cu`` with the text ``edits`` ((old, new) pairs, each of
    which must occur), built by its own ``nvcc`` under the build directory:
    (name, (the declared ctypes library, the edited source))."""
    import ctypes
    import shutil

    from ccnet_tpu_torch.ops import _build
    from ccnet_tpu_torch.ops import probes as P

    text = (_build.CSRC / "probes.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} not in csrc/probes.cu")
        text = text.replace(old, new)
    d = _build.BUILD_DIR / "variants" / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, d / f.name)
    (d / "probes.cu").write_text(text)
    so = d / "libprobes.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(d / "probes.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name!r}:\n{proc.stderr}")
    return name, (P.declare(ctypes.CDLL(str(so))), text)


def probe_variants(rounds: int = 2) -> dict:
    """Device µs (:func:`_device_us`) of the probe copy (P2 and P5 at the
    model's shapes) and scale (P3) kernels: this source's design, the
    variants of PROBE_VARIANTS (each built by its own ``nvcc``), this design
    on grids of one and of four waves (2048 threads on each SM) striding
    over the tiles instead of one tile per block, and the one library call;
    each checked bit-exact, all timed in ``rounds`` turns (the order
    reversed every other round). Returns {(variant, grid, probe): [µs]}."""
    from concurrent.futures import ThreadPoolExecutor

    from ccnet_tpu_torch.ops import probes as P

    def build(name):
        name, (lib, text) = _probes_variant(name, PROBE_VARIANTS.get(name, ()))
        threads, unroll = (int(text.split(f"constexpr int {k} = ")[1].split(";")[0])
                           for k in ("COPY_THREADS", "COPY_UNROLL"))
        return name, (lib, threads, unroll)

    names = ["this design", *PROBE_VARIANTS]
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(ex.map(build, names))
    wave = torch.cuda.get_device_properties(0).multi_processor_count * 2048
    cases = {"swap_leading": (1, 97, 97), "store_transposed": (8, 97, 97), "scale_ragged": None}
    sets = {name: _copies(_probe_inputs(name, PROBES[name][1])) for name in cases}
    runs = [(v, "one tile per block") for v in names]
    runs += [("this design", g) for g in ("1 wave", "4 waves")] + [("library", "one call")]

    def launcher(variant, grid, name):
        if variant == "library":
            return _probe_library(name)
        lib, threads, unroll = libs[variant]
        waves = {"1 wave": 1, "4 waves": 4}.get(grid)
        x = sets[name][0][0]
        if name == "scale_ragged":  # fresh tensors: 16-byte aligned, no head
            body = x.numel() // 4
            plan = P.ScalePlan(0, body, x.numel() % 4, -(-body // (threads * unroll)))
            if waves:
                plan = plan._replace(blocks=min(plan.blocks, waves * wave // threads))
            c = P._ScalePlanC(*plan)
            return lambda t: _probe_call(lib.probe_scale, t, torch.empty_like(t), c, 2.0)
        n, a, b = cases[name]
        r = x.shape[-1] // 8
        plan = P.SwapPlan(n, a, b, r, *P.fast_divider(r), *P.fast_divider(a),
                          -(-a * b * r // (threads * unroll)))
        if waves:
            plan = plan._replace(blocks=max(1, min(plan.blocks, waves * wave // threads // n)))
        c = P._SwapPlanC(*plan)
        shape = (b, a, x.shape[-1]) if n == 1 else (n, b, a, x.shape[-1])
        return lambda t: _probe_call(lib.probe_swap_leading, t,
                                     torch.empty(shape, device=t.device, dtype=t.dtype), c)

    times = {}
    for rnd in range(rounds):
        for variant, grid in (runs if rnd % 2 == 0 else runs[::-1]):
            for name in cases:
                fn = launcher(variant, grid, name)
                x = sets[name][0][0]
                if not torch.equal(fn(x), getattr(P, f"{name}_plain")(x)):
                    raise AssertionError(f"{name}, {variant} on {grid}: not bit-exact")
                times.setdefault((variant, grid, name), []).append(_device_us(fn, sets[name])[0])
    for name in cases:
        log(f"[probe-variants] {name} at {PROBES[name][1]}, device µs per call ({rounds} rounds "
            f"in turns): " + "; ".join(f"{v} on {g} " + " ".join(
                "not measured" if t is None else f"{t:.2f}" for t in ts)
                                       for (v, g, n), ts in times.items() if n == name))
    del sets
    torch.cuda.empty_cache()
    return times


# what holds the dot back, as text edits of csrc/probes.cu that each leave
# out one phase of its work (their results are wrong, so they are timed only)
DOT_DIAGNOSTICS = {
    "no global stores": [("for (int i = threadIdx.x; i < body; i += 32 * WARPS) out4[i] = es4[i];",
                          "")],
    "no products": [("mma_2(acc[i][0], acc[i][1], a, b);",
                     "acc[i][0][0] += __uint_as_float(a[0] ^ b[0]);")],
    "no shared-memory band": [("if (r < w.bh && g < H) es[r * H + g] = acc[i][j >> 2][j & 3];",
                               "if (r < w.bh && g < H && acc[i][j >> 2][j & 3] == 1.2345f) "
                               "es[r * H + g] = 0.f;")],
}
# ... and the staging alone: no products, no band, no stores
DOT_DIAGNOSTICS["loads alone"] = [*DOT_DIAGNOSTICS["no global stores"],
                                  *DOT_DIAGNOSTICS["no products"],
                                  *DOT_DIAGNOSTICS["no shared-memory band"]]
# ... everything but the loads; and the launch of blocks that do nothing
DOT_DIAGNOSTICS["no loads"] = [
    ("cp_async16(dst + r * KP + j, valid ? src + r * sH + c0 + j : src, valid);", "(void)valid;")]
DOT_DIAGNOSTICS["empty blocks"] = [
    ("  extern __shared__ __align__(16) unsigned char smem[];\n  const int band_p",
     "  extern __shared__ __align__(16) unsigned char smem[];\n  if (p.H > 0) return;\n"
     "  const int band_p")]


def dot_diagnostics(rounds: int = 2) -> dict:
    """Device µs (:func:`_device_us`) of P1 and P4 at the model's shapes on
    this source and on each DOT_DIAGNOSTICS variant, under ``dot_plan``'s
    plan, in ``rounds`` turns: the time a phase costs is what leaving it
    out saves. Returns {(probe, variant): [µs]}."""
    from concurrent.futures import ThreadPoolExecutor

    from ccnet_tpu_torch.ops import probes as P

    names = ["this design", *DOT_DIAGNOSTICS]
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(ex.map(lambda n: _probes_variant(n, DOT_DIAGNOSTICS.get(n, ())), names))
    for name in ("mid_batch_dot", "mid_batch_dot_4d"):
        plan = P.dot_plan(*_dot_layout(name, PROBES[name][1]))
        resident = P.dot_occupancy(plan.warps, plan.smem)
        log(f"[dot-diagnostics] {name}: {plan}; {resident} blocks resident per SM")
    times = {}
    for rnd in range(rounds):
        for name in ("mid_batch_dot", "mid_batch_dot_4d"):
            shape = PROBES[name][1]
            N, T, H, C, strides = _dot_layout(name, shape)
            c = P._DotPlanC(*P.dot_plan(N, T, H, C, strides))
            sets = _copies(_probe_inputs(name, shape))
            for variant in (names if rnd % 2 == 0 else names[::-1]):
                lib = libs[variant][0]

                def fn(q, k, lib=lib):
                    e = torch.empty((N, T, H, H), device=q.device, dtype=torch.float32)
                    return _probe_call(lib.probe_mid_batch_dot, q, k, c, out=e)
                if variant == "this design":
                    want = getattr(P, f"{name}_plain")(*sets[0])
                    _rel_check(f"{name} {variant}", fn(*sets[0]).reshape(want.shape), want,
                               PROBE_DOT_TOL)
                times.setdefault((name, variant), []).append(_device_us(fn, sets)[0])
            del sets
    for name in ("mid_batch_dot", "mid_batch_dot_4d"):
        log(f"[dot-diagnostics] {name} at {PROBES[name][1]}, device µs per call ({rounds} "
            f"rounds in turns): " + "; ".join(f"{v} " + " ".join(
                "not measured" if t is None else f"{t:.2f}" for t in ts)
                                           for (n, v), ts in times.items() if n == name))
    torch.cuda.empty_cache()
    return times


def _dot_layout(name: str, shape) -> tuple:
    """(N, T, H, C, element strides) of probe ``name``'s dot at ``shape``."""
    if name == "mid_batch_dot":
        H, T, C = shape
        return 1, T, H, C, (0, T * C, C)
    N, H, T, C = shape
    return N, T, H, C, (H * T * C, T * C, C)


def dot_variants(rounds: int = 2) -> dict:
    """Device µs (:func:`_device_us`) of the dot kernel under other launch
    plans than ``dot_plan``'s, all through the one built library: P1 in
    blocks of 16 warps (one per SM) with bands of 16, 32, 48, 64 and 97
    query rows, and of 8 warps (two per SM) with bands of 64 and 97; P4 in
    blocks of 8 warps on grids of 132, 264, 388 and 776 blocks (its 776
    whole-line items), and of 16 on 132; each checked against the
    plain version (the bf16 ``einsum`` beside them rounds its output, so it
    is timed only), in ``rounds`` turns (the order reversed every other
    round). Returns {(probe, variant): [µs]}."""
    from ccnet_tpu_torch.ops import probes as P

    lib = P._lib()
    cases = {}
    for name in ("mid_batch_dot", "mid_batch_dot_4d"):
        N, T, H, C, strides = _dot_layout(name, PROBES[name][1])
        base = P.dot_plan(N, T, H, C, strides)
        # (warps, band, blocks); blocks None: one per resident slot or item
        runs = ([(16, b, None) for b in (16, 32, 48, 64, 97)] + [(8, 64, None), (8, 97, None)]
                if name == "mid_batch_dot" else
                [(8, base.band, b) for b in (132, 264, 388, 776)] + [(16, base.band, None)])
        plans = {}
        for warps, band, blocks in runs:
            es_bytes, smem = P.dot_smem(H, band, base.group)
            items = N * T * -(-H // band)
            blocks = blocks or min(items, P.H100_SMS * P.DOT_DESIGNS[warps])
            plans[f"{warps} warps, band {band}, {blocks} blocks"] = base._replace(
                band=band, bands=-(-H // band), warps=warps, es_bytes=es_bytes, smem=smem,
                items=items, blocks=blocks)
        cases[name] = (N, T, H, plans)
    times = {}
    for rnd in range(rounds):
        for name, (N, T, H, plans) in cases.items():
            sets = _copies(_probe_inputs(name, PROBES[name][1]))
            runs = [*plans, "einsum"]
            for variant in (runs if rnd % 2 == 0 else runs[::-1]):
                if variant == "einsum":
                    fn = _probe_library(name)
                else:
                    c = P._DotPlanC(*plans[variant])

                    def fn(q, k, c=c):
                        e = torch.empty((N, T, H, H), device=q.device, dtype=torch.float32)
                        _probe_call(lib.probe_mid_batch_dot, q, k, c, out=e)
                        return e
                    q, k = sets[0]
                    want = getattr(P, f"{name}_plain")(q, k)
                    _rel_check(f"{name} {variant}", fn(q, k).reshape(want.shape), want,
                               PROBE_DOT_TOL)
                times.setdefault((name, variant), []).append(_device_us(fn, sets)[0])
            del sets
    for name in cases:
        log(f"[dot-variants] {name} at {PROBES[name][1]}, device µs per call ({rounds} rounds "
            f"in turns): " + "; ".join(f"{v} " + " ".join(
                "not measured" if t is None else f"{t:.2f}" for t in ts)
                                       for (n, v), ts in times.items() if n == name))
    torch.cuda.empty_cache()
    return times


def _probe_call(fn, x, y, *args, out=None):
    """One launch of a probe kernel variant on x into y (on x and y into
    ``out``, for the dot); returns y (``out``)."""
    from ccnet_tpu_torch.ops import probes as P

    ptrs = (x.data_ptr(), y.data_ptr()) + (() if out is None else (out.data_ptr(),))
    rc = fn(*ptrs, *args, P._stream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"probe variant launch failed: CUDA error {rc}")
    return y if out is None else out


def phase_probes() -> dict:
    """P1–P5 against their plain versions at the script's and the model's
    shapes (the copies and the scale bit-exact); at the model's shapes the
    bound and :func:`probe_times`."""
    from ccnet_tpu_torch.ops import probes as P

    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    for name, (small, big, dtype) in PROBES.items():
        kernel, plain = getattr(P, name), getattr(P, f"{name}_plain")
        dot = "dot" in name
        for shape in (small, big):
            xs = _probe_inputs(name, shape)
            before = P.LAUNCHES[name]
            got = kernel(*xs)
            torch.cuda.synchronize()
            if P.LAUNCHES[name] != before + 1:
                raise RuntimeError(f"{name} did not count its launch")
            want = plain(*xs)
            if dot:
                err = _rel_check(f"{name} at {shape}", got, want, PROBE_DOT_TOL)
            elif got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{name} at {shape} is not bit-exact")
            else:
                err = 0.0
        # the model's shape: the bound. Operations: a multiply-add per channel
        # of each logit; one multiply per scaled value; the copies do no
        # arithmetic
        flops = 2 * got.numel() * shape[-1] if dot else got.numel() * (name == "scale_ragged")
        report[name] = {"max_abs_err": err, **_bound(xs, (got,), flops, dtype)}
        report[name]["design"] = (
            "a band of query rows and all its line's keys staged once per block, mma.sync, "
            "the band's run of e stored as float4 from shared memory" if dot else
            "one 16-byte chunk per thread, one tile per block, no staging")
        log(f"[probes] {name}: ok at {small} and {shape} {str(dtype)[6:]} "
            f"({'<= %g x scale, err %.2e' % (PROBE_DOT_TOL, err) if dot else 'bit-exact'})")
        del xs, got, want
    for name, shape, offset in PROBE_DOT_EDGES:
        n = math.prod(shape)
        xs = [x[offset:offset + n].view(shape) for x in _probe_inputs(name, (n + 8,))]
        before = P.LAUNCHES[name]
        got = getattr(P, name)(*xs)
        torch.cuda.synchronize()
        if P.LAUNCHES[name] != before + 1:
            raise RuntimeError(f"{name} did not count its launch")
        err = _rel_check(f"{name} at {shape}, offset {offset}", got,
                         getattr(P, f"{name}_plain")(*xs), PROBE_DOT_TOL)
        log(f"[probes] {name}: ok at {shape}, base {2 * offset} bytes past 16 (<= "
            f"{PROBE_DOT_TOL:g} x scale, err {err:.2e})")
        del xs, got
    for name, r in probe_times().items():
        e = report[name]
        e.update(r)
        dev = {k: "not measured" if e[k] is None else f"{e[k]:.2f}"
               for k in ("device_us", "library_device_us")}
        us = "" if "dot" not in name else (
            f"; device µs {dev['device_us']} vs einsum {dev['library_device_us']}, host µs "
            f"{e['host_us']:.2f} vs einsum {e['library_host_us']:.2f}")
        log(f"[probes] {name} at {PROBES[name][1]}: kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['bound_ms'] / e['ms']:.1%} of it; "
            f"median of {TIMING_REPS}){us}")
    return report


def phase_probe_cli() -> dict:
    """The probes' main path: ``cli.probe.main`` on the card prints five
    PASS lines (exits 1 otherwise) and launches every probe kernel."""
    from ccnet_tpu_torch.cli.probe import main

    _reset_counts()
    results = main(["--device", "cuda"])
    launches = _counts()
    if len(results) != 5 or not all(results.values()):
        raise AssertionError(f"cli.probe: {results}")
    moved = {n: launches[n] for n in PROBES}
    if any(c < 1 for c in moved.values()) or any(
            c for n, c in launches.items() if n not in PROBES):
        raise AssertionError(f"cli.probe launches {launches}")
    log(f"[probe-cli] 5 PASS; launches {moved}")
    return moved


def _eval_ab(model, x, tag: str, want: dict) -> None:
    """The eval forward of ``model`` on ``x`` through each CCA route: the
    kernel route's main logits against the plain route's, the kernel
    route's launches against ``want``, then both routes timed in turns
    (kernel, plain, plain, kernel, ...) after one untimed call of each."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    with torch.inference_mode():
        before = dict(K.LAUNCHES)
        model.set_cca_impl("kernel")
        main_k = model(x)["main"]
        moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
        if moved != want:
            raise RuntimeError(f"{tag}: impl='kernel' launched {moved}, not {want}")
        model.set_cca_impl("torch")
        main_t = model(x)["main"]
        times = {"kernel": [], "torch": []}
        for rep in range(EVAL_AB_REPS + 1):
            for impl in ("kernel", "torch") if rep % 2 else ("torch", "kernel"):
                model.set_cca_impl(impl)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                model(x)
                end.record()
                end.synchronize()
                if rep:
                    times[impl].append(start.elapsed_time(end))
        model.set_cca_impl("auto")
    torch.cuda.synchronize()
    B, _, H, W = x.shape
    if (tuple(main_k.shape) != (B, 19, _features(H), _features(W))
            or not torch.isfinite(main_k).all()):
        raise AssertionError(f"{tag}: kernel-route logits malformed: {tuple(main_k.shape)}")
    err, scale = _err(main_k, main_t)
    agree = (main_k.argmax(1) == main_t.argmax(1)).float().mean().item()
    log(f"[model] {tag}, gamma=0.5: kernel vs plain main logits max abs err {err:.3e} (scale "
        f"{scale:.3g}, tol {MODEL_TOL:g} x scale), argmax agreement {agree:.6f} "
        f"(>= {MODEL_ARGMAX})")
    log(f"[model] {tag} eval forward, the two CCA routes in turns in one process: impl='kernel' "
        f"median {np.median(times['kernel']):.4f} ms, impl='torch' median "
        f"{np.median(times['torch']):.4f} ms (CUDA events, {EVAL_AB_REPS} each; kernel "
        f"{' '.join(f'{t:.4f}' for t in times['kernel'])}; torch "
        f"{' '.join(f'{t:.4f}' for t in times['torch'])})")
    if not err <= MODEL_TOL * scale or agree < MODEL_ARGMAX:
        raise AssertionError(f"{tag}: the kernel route disagrees with the plain route")


def phase_model(pth: str) -> None:
    """R101 R=2 bf16 with seeded random weights (saved to ``pth``): the eval
    forward's kernel route against its plain route on 8 crops of 769²
    (K1/K2) and on one whole 1024×2048 image (K7a, the line route)."""
    from ccnet_tpu_torch.models import build_model, randomize_

    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's default setting
    model = build_model("ccnet", num_classes=19, recurrence=2, depth=101,
                        dtype=torch.bfloat16, device="cuda")
    randomize_(model, seed=0)
    torch.save(model.state_dict(), pth)
    rng = np.random.RandomState(2)
    for batch, hw in ((8, (CROP, CROP)), (1, EVAL_HW)):
        x = torch.from_numpy((rng.rand(batch, 3, *hw) * 255.0 - 120.0).astype(np.float32)).cuda()
        want = _cca_want((batch, *map(_features, hw), 64, 512), torch.bfloat16,
                         fwd=2)  # R=2 recurrences
        _eval_ab(model, x, f"R101 R=2 bf16 ({batch},3,{hw[0]},{hw[1]})", want)
        del x
    del model
    torch.cuda.empty_cache()


def _launch_counts() -> tuple:
    from ccnet_tpu_torch.ops import cc_attention_cuda as K
    from ccnet_tpu_torch.ops import probes as P
    from ccnet_tpu_torch.ops import upsampled_ce as U

    return K.LAUNCHES, U.LAUNCHES, P.LAUNCHES


def _reset_counts() -> None:
    for counts in _launch_counts():
        for key in counts:
            counts[key] = 0


def _counts() -> dict:
    return {n: c for counts in _launch_counts() for n, c in counts.items()}


def _path_designs(shape, dtype) -> dict:
    """{path: the design K1–K4 of that path take} for ``(B, H, W, Cq, Cv)``
    features of ``dtype`` (``kernel_design``, from the path's own line)."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    q = torch.empty(shape[:3] + (shape[3],), dtype=dtype, device="meta")
    return {path: K.kernel_design(q, path) for path in K.PATHS}


def _designs(shape, dtype) -> str:
    return ", ".join(f"{path} {d.replace('_', ' ')}"
                     for path, d in _path_designs(shape, dtype).items())


def _add_natural(want: dict, shape, dtype, d: str, n: int = 1) -> dict:
    """Add to ``want`` the launches of ``n`` calls of K1 and K2 (``d`` =
    ``"fwd"``) or K3 and K4 (``"bwd"``): each under its own name and, on the
    tensor cores, under its design's count (``cca_{d}_{path}_tc`` for one
    block per line, ``cca_line_{d}_tc`` for the line kernels, which bf16
    lines past 128 take); the CUDA-core design (f32) has none."""
    for path, design in _path_designs(shape, dtype).items():
        want[f"cca_{d}_{path}"] += n
        if design == "tensor_core":
            want[f"cca_{d}_{path}_tc"] += n
        elif design == "tensor_core_lines":
            want[f"cca_line_{d}_tc"] += n
    return want


def _cca_want(shape, dtype, fwd: int = 0, bwd: int = 0) -> dict:
    """The attention kernels' launch counts of ``fwd`` forward and ``bwd``
    backward calls of the routed Function on ``(B, H, W, Cq, Cv)`` features
    of ``dtype``: each direction routed as the JAX package routes it
    (``uses_line_route``), one launch of each of K1/K2 (K3/K4) per call
    (:func:`_add_natural`), or one of K7a (K7b) per path and call on the
    line route; every bf16 launch on the tensor cores."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    _, H, W, Cq, Cv = shape
    bf16 = dtype == torch.bfloat16
    want = {n: 0 for n in K.LAUNCHES}
    for d, n in (("fwd", fwd), ("bwd", bwd)):
        if K.uses_line_route(d, H, W, Cq, Cv, dtype):
            want[f"cca_line_{d}"] += 2 * n
            want[f"cca_line_{d}_tc"] += 2 * n * bf16
        else:
            _add_natural(want, shape, dtype, d, n)
    return want


def _features(n: int) -> int:
    """The model's output-stride-8 feature length of an ``n``-pixel side:
    the stem's stride-2 3x3 convolution, the ceil-mode 3x3 max pool, and
    layer2's stride-2 3x3 convolution (769 -> 97, 1024 -> 129, 2048 -> 257)."""
    a = (n + 1) // 2
    b = -(-(a - 1) // 2) + 1
    return (b + 1) // 2


def _want(hw, fwd: int, bwd: int = 0, loss: int = 0) -> dict:
    """The launch counts of ``fwd`` forward and ``bwd`` backward CCA calls of
    the bf16 model on the OS-8 features of an ``hw`` input
    (:func:`_cca_want`) and ``loss`` calls of each of K5/K6."""
    want = {n: 0 for n in _counts()}
    want.update(_cca_want((1, *map(_features, hw), 64, 512), torch.bfloat16, fwd, bwd))
    want.update(upsampled_nll_fwd=loss, upsampled_nll_bwd=loss)
    return want


def _train_batch(seed: int, batch: int, hw):
    rng = np.random.RandomState(seed)
    x = (rng.rand(batch, 3, *hw) * 255.0 - 120.0).astype(np.float32)
    y = rng.randint(0, 19, (batch, *hw)).astype(np.int32)
    y[rng.rand(batch, *hw) < 0.1] = 255
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def _top_kernels(fn, top: int = 6) -> str:
    """One ``fn()`` under ``torch.profiler``: its device kernel time, the
    ``top`` kernels by summed device time (read from the exported chrome
    trace, whose kernel events carry device time alone), and the summed
    time and count of each hand-written attention kernel (``cca_*``)."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    total = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    cca = {}
    for e in events:
        if "cca_" in e["name"]:
            name = e["name"].split("cca_", 1)[1].split("(")[0]
            ms, n = cca.get(name, (0.0, 0))
            cca[name] = (ms + e["dur"] / 1e3, n + 1)
    return (f"kernels {total:.1f} ms; top: "
            + "; ".join(f"{ms:.1f} ms {name[:90]}" for name, ms in ranked)
            + "; attention kernels: "
            + ("; ".join(f"cca_{n} {ms:.3f} ms ({c} launches)" for n, (ms, c) in cca.items())
               or "none"))


def random_pth(name: str, pth: str, depth: int = DEPTH) -> None:
    """R101 (or ``depth``) bf16 ``name`` with seeded random weights
    (``randomize_``), saved."""
    from ccnet_tpu_torch.models import build_model, randomize_

    model = build_model(name, num_classes=19, depth=depth, dtype=torch.bfloat16)
    randomize_(model, seed=0)
    torch.save(model.state_dict(), pth)


# the grads compared between the kernel and plain routes of a train step:
# the attention's for CCNet, the classifiers' (right behind K6) otherwise
HEAD_GRADS = ("head.1.weight", "dsn.3.weight")


def phase_train_step(pth: str, batch: int, hw, model_name: str = "ccnet",
                     profile: bool = False) -> None:
    """One train step from the same state through the kernels and through
    the plain versions: the loss and the grads agree (CCNet: the CCA
    grads; PSPNet/DeepLabv3, whose kernels are K5/K6 alone: the
    classifiers'); then TRAIN_AB_REPS more steps of each from its state,
    timed in turns. ``profile``: also one kernel-route step under
    :func:`_top_kernels`."""
    from ccnet_tpu_torch.losses import build_criterion
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.train import create_train_state, make_train_step
    from ccnet_tpu_torch.utils import load_pth

    torch.backends.cudnn.allow_tf32 = True
    x, y = _train_batch(3, batch, hw)
    ccnet = model_name == "ccnet"
    grads = CCA_GRADS if ccnet else HEAD_GRADS
    runs, routes = {}, {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for impl in ("kernel", "torch"):
        held = torch.cuda.memory_allocated() - base  # the other route's model and state
        model = build_model(model_name, num_classes=19, recurrence=2, depth=DEPTH,
                            dtype=torch.bfloat16, impl=impl, drop_rate=0.0, device="cuda")
        load_pth(pth, model, strict=True)
        state = create_train_state(model)
        step = make_train_step(build_criterion(ohem=True, impl=impl))
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = step(state, x, y)["loss"].item()
        runs[impl] = {"loss": loss, "launches": _counts(),
                      "peak": torch.cuda.max_memory_allocated() - held,
                      "grads": {n: p.grad.float().clone() for n, p in model.named_parameters()
                                if n in grads}}
        routes[impl] = (state, step)
    # more steps of the two routes from their states, timed in turns (kernel,
    # plain, plain, kernel, ...); the first step of each paid for cuDNN's set-up
    times = {"kernel": [], "torch": []}
    for rep in range(TRAIN_AB_REPS):
        for impl in ("kernel", "torch") if rep % 2 == 0 else ("torch", "kernel"):
            state, step = routes[impl]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, x, y)
            end.record()
            end.synchronize()
            times[impl].append(start.elapsed_time(end) / 1000.0)
    for impl in runs:
        runs[impl]["s"] = float(np.median(times[impl]))
    if profile:  # where the step's time goes
        state, step = routes["kernel"]
        log(f"[train-step] {model_name} kernel route, one step under torch.profiler: "
            + _top_kernels(lambda: step(state, x, y)))
    del routes, state, step, model
    torch.cuda.empty_cache()
    k, t = runs["kernel"], runs["torch"]
    # each CCA call once per recurrence (R=2), each loss kernel once per head
    want = _want(hw, 2 * ccnet, 2 * ccnet, 2)
    if k["launches"] != want or any(t["launches"].values()):
        raise AssertionError(f"launches: kernel route {k['launches']} (want {want}), plain "
                             f"{t['launches']}")
    rel_loss = abs(k["loss"] - t["loss"]) / abs(t["loss"])
    rel = {n: (k["grads"][n] - t["grads"][n]).norm().item() / t["grads"][n].norm().item()
           for n in grads}
    tag = (f"{model_name} R{DEPTH}{' R=2' if ccnet else ''} bf16 ({batch},3,{hw[0]},{hw[1]}) "
           f"OHEM{', gamma=0.5' if ccnet else ''}")
    log(f"[train-step] {tag}: loss kernel {k['loss']:.6f} vs plain {t['loss']:.6f} (rel "
        f"{rel_loss:.2e}, tol {TRAIN_LOSS_RTOL:g}); grads rel err "
        + " ".join(f"{n}={e:.2e}" for n, e in rel.items())
        + f" (tol {TRAIN_GRAD_RTOL:g}); launches {k['launches']}")
    log(f"[train-step] {tag}: peak memory kernel route {k['peak'] / 2**30:.2f} GiB, plain "
        f"route {t['peak'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated, less the other "
        f"route's model and state); steps in turns: kernel route median {k['s']:.4f} s "
        f"({batch / k['s']:.2f} crops/s; {' '.join(f'{v:.4f}' for v in times['kernel'])}), "
        f"plain route {t['s']:.4f} s ({' '.join(f'{v:.4f}' for v in times['torch'])}) "
        f"(CUDA events, {TRAIN_AB_REPS} each)")
    if not rel_loss <= TRAIN_LOSS_RTOL or not all(e <= TRAIN_GRAD_RTOL for e in rel.values()):
        raise AssertionError("train step: kernel route disagrees with the plain route")
    if not all(t["grads"][n].abs().max().item() > 0 for n in grads):
        raise AssertionError(f"a grad of {grads} is zero: the backward kernels were not exercised")


def phase_train_main_path(pth: str, snap_dir: str, batch: int, hw, steps: int,
                          model_name: str = "ccnet") -> tuple:
    """``cli.train.main --model model_name`` on the synthetic set of
    :data:`EVAL_HW` images; returns (launches, the exported ``.pth``)."""
    from ccnet_tpu_torch.cli.train import main
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.utils import load_pth

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    result = main(["--model", model_name, "--synthetic", "--synthetic-size",
                   f"{EVAL_HW[0]},{EVAL_HW[1]}", "--device", "cuda", "--batch-size", str(batch),
                   "--input-size", f"{hw[0]},{hw[1]}",
                   "--depth", str(DEPTH), "--ohem", "1", "--num-steps", str(steps),
                   "--save-pred-every", str(steps), "--restore-from", pth,
                   "--snapshot-dir", snap_dir])
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = result["losses"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses {losses}")
    cca = 2 * steps * (model_name == "ccnet")  # R=2 recurrences of CCNet's attention
    want = _want(hw, cca, cca, 2 * steps)  # the loss kernels once per head (main + aux)
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    out = os.path.join(snap_dir, f"CS_scenes_{steps}.pth")
    model = build_model(model_name, num_classes=19, recurrence=2, depth=DEPTH,
                        dtype=torch.bfloat16, device="cuda")
    load_pth(out, model, strict=True)
    del model
    torch.cuda.empty_cache()
    dev = result["step_seconds"][1:]
    wall = result["wall_seconds"][1:]
    tag = (f"cli.train --model {model_name} R{DEPTH}{' R=2' if cca else ''} bf16 OHEM bs "
           f"{batch} {hw[0]}x{hw[1]}")
    log(f"[train] {tag}, {steps} steps: losses {' '.join(f'{v:.4f}' for v in losses)}; "
        f"launches {launches}")
    log(f"[train] {tag}, steps 2-{steps}: {np.mean(dev):.4f} s/step on the card (CUDA events, "
        f"augment + step; median {np.median(dev):.4f}), {batch / np.mean(dev):.2f} crops/s; "
        f"host wall {np.mean(wall):.4f} s/step (median {np.median(wall):.4f}; the loader's "
        f"wait, the step and the last step's checkpoint), {batch / np.mean(wall):.2f} "
        f"crops/s; first step {result['step_seconds'][0]:.3f} s on the card; peak memory "
        f"{peak / 2**30:.2f} GiB; {out} loads with strict=True")
    return launches, out


def train_wall(steps: int = 4, batch: int = TRAIN_BATCH, workers: int = 8) -> dict:
    """``cli.train --synthetic`` (R101 R=2 bf16 OHEM, seeded init) at batch
    ``batch`` of 769², ``steps`` steps, ``--num-workers workers``: the
    medians over steps 2.. of the host wall s/step and of the card's
    s/step. Uses only what every version of ``cli.train`` has, so it also
    times an earlier tree (run from its checkout)."""
    from ccnet_tpu_torch.cli.train import main

    with tempfile.TemporaryDirectory() as d:
        result = main(["--synthetic", "--synthetic-size", f"{EVAL_HW[0]},{EVAL_HW[1]}",
                       "--device", "cuda", "--batch-size", str(batch), "--input-size",
                       f"{CROP},{CROP}", "--depth", str(DEPTH), "--ohem", "1", "--num-steps",
                       str(steps), "--save-pred-every", str(steps), "--export-pth", "0",
                       "--num-workers", str(workers), "--snapshot-dir", d])
    r = {"wall_s_per_step": float(np.median(result["wall_seconds"][1:])),
         "card_s_per_step": float(np.median(result["step_seconds"][1:])),
         "wall_seconds": result["wall_seconds"], "step_seconds": result["step_seconds"]}
    log(f"[train-wall] cli.train --synthetic bs {batch} {CROP}x{CROP}, {steps} steps, "
        f"--num-workers {workers}: host wall median {r['wall_s_per_step']:.4f} s/step "
        f"({' '.join(f'{v:.4f}' for v in r['wall_seconds'])}), card median "
        f"{r['card_s_per_step']:.4f} s/step ({' '.join(f'{v:.4f}' for v in r['step_seconds'])})")
    return r


def eval_times(mode: str) -> dict:
    """``cli.evaluate --synthetic`` (R101 R=2 bf16, seeded random weights)
    on the 2 images of :data:`EVAL_HW` in ``EVAL_MODES[mode]``: the card's
    s/img of each image (``batch_seconds``). Uses only what every version
    of ``cli.evaluate`` has, so it also times an earlier tree."""
    from ccnet_tpu_torch.cli.evaluate import main

    flags, _ = EVAL_MODES[mode]
    with tempfile.TemporaryDirectory() as d:
        result = main(["--synthetic", "--synthetic-size", f"{EVAL_HW[0]},{EVAL_HW[1]}",
                       "--input-size", f"{CROP},{CROP}", "--device", "cuda", "--save-preds",
                       "0", "--output-dir", d] + flags)
    secs = [float(v) for v in result["batch_seconds"]]
    log(f"[eval-times] cli.evaluate {mode}: s/img on the card "
        + " ".join(f"{v:.4f}" for v in secs))
    return {"s_per_img": secs}


def ab_turn() -> None:
    """One turn of the parent/change A/B, run from a checkout's root: the
    card, P1/P4's :func:`probe_times`, :func:`train_wall` and the sliding
    and whole-image :func:`eval_times`, then one JSON line tagged ``[ab]``."""
    from ccnet_tpu_torch.ops import _build

    phase_card()
    _build.build_libraries(LIBRARIES)
    out = {"dots": probe_times(("mid_batch_dot", "mid_batch_dot_4d")), "train": train_wall(),
           "sliding": eval_times("sliding"), "whole": eval_times("whole")}
    out["train"] = {k: v for k, v in out["train"].items() if "per_step" in k}
    log("[ab] " + json.dumps({"checkout": os.getcwd(), **out}))


def ab(parent: str, order=("parent", "tree", "tree", "parent")) -> None:
    """:func:`ab_turn` in the checkout ``parent`` (a ``git archive`` of the
    parent commit) and in this one, in turns, each in its own process."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import importlib.util as u, sys; sys.path.insert(0, '.'); "
            f"sp = u.spec_from_file_location('cs', {os.path.abspath(__file__)!r}); "
            "cs = u.module_from_spec(sp); sp.loader.exec_module(cs); cs.ab_turn()")
    for who in order:
        log(f"[ab] turn: {who}")
        subprocess.run([sys.executable, "-c", code], cwd=parent if who == "parent" else here,
                       check=True, timeout=900)


# evaluation modes: extra cli.evaluate flags, and the forward CCA calls of
# one image at R=2 at each scale (sliding: per chunk of 8 tiles; whole
# image; the whole image at 5 scales x 2 flips)
EVAL_MODES = {
    "sliding": ([], {1.0: 2}),
    "sliding-png": (["--save-preds", "1"], {1.0: 2}),
    "whole": (["--whole", "1"], {1.0: 2}),
    "msflip": (["--whole", "1", "--scales", ",".join(map(str, MS_SCALES)), "--flip", "1",
                "--save-preds", "1"], {s: 2 * 2 for s in MS_SCALES}),
}


def _eval_want(mode: str, images: int, model_name: str = "ccnet") -> dict:
    """The launch counts of evaluating ``images`` of :data:`EVAL_HW` in one
    of :data:`EVAL_MODES` (CCNet: its attention kernels; the other heads
    launch none)."""
    from ccnet_tpu_torch.evaluation import compute_tiles

    want = {n: 0 for n in _counts()}
    for scale, n in EVAL_MODES[mode][1].items():
        n *= model_name == "ccnet"
        if mode.startswith("sliding"):  # chunks of 8 tiles
            hw, n = (CROP, CROP), n * -(-len(compute_tiles(EVAL_HW, (CROP, CROP))) // 8)
        else:  # predict_multiscale's round(H * s)
            hw = tuple(int(round(x * scale)) for x in EVAL_HW)
        for name, c in _want(hw, images * n).items():
            want[name] += c
    return want


def phase_main_path(pth: str, mode: str, model_name: str = "ccnet") -> dict:
    """``cli.evaluate.main --model model_name`` on the synthetic 1024×2048
    set in one of :data:`EVAL_MODES`: meanIU, the confusion sum, launch
    counts (CCNet: its attention kernels; the other heads launch none),
    PNGs, s/img, peak memory."""
    from ccnet_tpu_torch.cli.evaluate import main
    from ccnet_tpu_torch.data import SyntheticDataset
    from ccnet_tpu_torch.data.palette import read_png

    flags, _ = EVAL_MODES[mode]
    ds = SyntheticDataset(n=2, hw=EVAL_HW, num_classes=19)
    want = _eval_want(mode, len(ds), model_name)
    with tempfile.TemporaryDirectory() as out_dir:
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        result = main(["--model", model_name, "--synthetic", "--synthetic-size",
                       f"{EVAL_HW[0]},{EVAL_HW[1]}", "--input-size", f"{CROP},{CROP}",
                       "--restore-from", pth, "--device", "cuda", "--save-preds", "0",
                       "--output-dir", out_dir] + flags)
        peak = torch.cuda.max_memory_allocated()
        launches = _counts()
        if not 0.0 <= result["meanIU"] <= 1.0:
            raise AssertionError(f"meanIU {result['meanIU']} outside [0, 1]")
        if not os.path.isfile(os.path.join(out_dir, "result.txt")):
            raise AssertionError("result.txt was not written")
        valid = sum(int((ds[i][1] != 255).sum()) for i in range(len(ds)))
        total = int(np.asarray(result["confusion"]).sum())
        if total != valid:
            raise AssertionError(f"confusion matrix sums to {total}, {valid} pixels are not ignored")
        if launches != want:
            raise AssertionError(f"{mode}: expected launches {want}, got {launches}")
        pngs = ""
        if "--save-preds" in flags:
            for i in range(len(ds)):
                pred, pal = read_png(os.path.join(out_dir, f"{ds.name(i)}.png"), 3)
                if pred.shape != EVAL_HW or pred.max() >= 19 or pal.size != 768:
                    raise AssertionError(f"prediction PNG {i}: shape {pred.shape}, "
                                         f"max index {pred.max()}, {pal.size} palette bytes")
            pngs = (f"; {len(ds)} prediction PNGs written, decoded with read_png: "
                    f"{EVAL_HW[0]}x{EVAL_HW[1]}, indices < 19")
    secs, wall = result["batch_seconds"], result["wall_seconds"]
    log(f"[{mode}] {model_name} R{DEPTH}{' R=2' if model_name == 'ccnet' else ''} bf16 "
        f"{EVAL_HW[0]}x{EVAL_HW[1]} synthetic, 2 images {' '.join(flags)}: meanIU "
        f"{result['meanIU']:.6f}, launches {launches}, s/img {secs[1]:.4f} on the card (CUDA "
        f"events, predict + confusion; second image; first {secs[0]:.4f}), host wall "
        f"median {np.median(wall):.4f} s/img ({' '.join(f'{v:.4f}' for v in wall)}); peak "
        f"memory {peak / 2**30:.2f} GiB{pngs}")
    return launches


# ----------------------------------------------------------------------------
# The rest of the single-card surface: VOC, test-set prediction, --restore-dir,
# the native augmenter, remat and the profiler.
VOC_LOSS = (8, 41, 41, 21, 8)  # B, h, w, C, r: the VOC recipe's logits, 41² -> 321²
VOC_STEPS, VOC_BATCH, VOC_CROP, VOC_CLASSES, VOC_BUCKET = 300, 8, 321, 21, 128
VOC_MIN_MIOU = 0.5  # the held-out bar of scripts/e2e_voc_synthetic.py:32
# 21 well-separated colours, as scripts/e2e_voc_synthetic.py:38-42 draws them
VOC_COLORS = np.random.RandomState(42).permutation(
    np.stack(np.meshgrid([40, 120, 200], [40, 120, 200], [40, 120, 200]), -1)
    .reshape(-1, 3).astype(np.float64))[:21] + np.arange(21)[:, None] * 0.7
NATIVE_STEPS = 4
REMAT_MODES = ("none", "blocks", "conv12")
REMAT_LOSS_RTOL = 1e-2
# ||grads (mode) - grads (none)|| / ||grads (none)|| of one step, per group: the
# same kernels on the same activations, recomputed; a dropped or doubled
# grad of a remat'd block is off by O(1)
REMAT_GRAD_RTOL = 1e-2
REMAT_STATS_RTOL = 1e-2  # ||Δ stats (mode) - Δ stats (none)|| / ||Δ stats (none)|| of one step
PROFILE_STEPS, PROFILE_RANGE, PROFILE_BATCH = 3, (1, 2), 2


def _peak_reset() -> int:
    """Reset the peak-memory counter; the bytes allocated now."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _seconds(fn) -> float:
    """One ``fn()`` in CUDA-event seconds."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def phase_voc_loss_kernels() -> dict:
    """K5/K6 at the VOC recipe's shape (21 classes: the kernels' class bound
    32, where the Cityscapes shapes take 20) against the materialised
    upsample + NLL and its autograd, int32 and uint8 labels, g dense, sparse
    and zero; then their times and bounds beside the 769² rows'."""
    errs = {}
    for live in (1.0, SPARSE_G, 0.0):
        for name, e in _check_loss_case(VOC_LOSS, live).items():
            errs[name] = max(errs.get(name, 0.0), e)
    rows = _loss_rows(*_loss_shape_times("VOC 321²", VOC_LOSS))
    rows["upsampled_nll_fwd"]["max_abs_err"] = errs["K5"]
    rows["upsampled_nll_bwd"]["max_abs_err"] = errs["K6"]
    return rows


class MemoryVOC:
    """Raw VOC samples in memory, in ``VOCDataset``'s layouts: ``"float32"``
    (f32 image, int32 label) or ``"uint8"``."""

    def __init__(self, items, raw_dtype: str = "float32"):
        self.items, self.raw_dtype = items, raw_dtype

    def __len__(self):
        return len(self.items)

    def name(self, index: int) -> str:
        return self.items[index][2]

    def __getitem__(self, index: int):
        image, label, name = self.items[index]
        if self.raw_dtype == "uint8":
            return image, label, name
        return image.astype(np.float32), label.astype(np.int32), name


def voc_synthetic_tree(n_train: int = 8, n_val: int = 2) -> dict:
    """``scripts/e2e_voc_synthetic.py``'s tree (``:38-68``) in memory, without
    its JPEG round trip: images of 280–460 × 320–500 whose 64-pixel blocks
    carry one of 21 classes as a colour, plus noise; ``{"train": [(image
    uint8, label uint8, name)], "val": [...]}``."""
    tree = {}
    for split, n, seed0 in (("train", n_train, 0), ("val", n_val, 1000)):
        tree[split] = []
        for i in range(n):
            rng = np.random.RandomState(seed0 + i)
            h, w = int(rng.randint(280, 460)), int(rng.randint(320, 500))
            blocks = rng.randint(0, VOC_CLASSES, (h // 64 + 1, w // 64 + 1))
            lbl = np.kron(blocks, np.ones((64, 64), np.int64))[:h, :w]
            img = np.clip(VOC_COLORS[lbl] + rng.randn(h, w, 3) * 5.0, 0, 255)
            tree[split].append((img.astype(np.uint8), lbl.astype(np.uint8), f"{split}_{i:04d}"))
    return tree


def _voc_eval(pth: str, val, impl: str = "auto") -> dict:
    """The exported ``.pth`` through the bucketed ``Evaluator`` (tile
    VOC_CROP, bucket VOC_BUCKET, the VOC mean) on the held-out images."""
    from ccnet_tpu_torch.data.voc import VOC_MEAN
    from ccnet_tpu_torch.evaluation import Evaluator
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.utils import load_pth

    model = build_model("ccnet", num_classes=VOC_CLASSES, recurrence=2, depth=DEPTH,
                        dtype=torch.bfloat16, impl=impl, device="cuda")
    load_pth(pth, model, strict=True)
    ev = Evaluator(lambda x: model(x)["main"], num_classes=VOC_CLASSES,
                   tile_hw=(VOC_CROP, VOC_CROP), mean=VOC_MEAN, bucket=VOC_BUCKET, device="cuda")
    loader = [(img[None], lbl.astype(np.int32)[None], [name]) for img, lbl, name in val]
    result = ev.run(loader)
    del model, ev
    torch.cuda.empty_cache()
    return result


def _voc_train_plain(tree, snap: str) -> float:
    """The VOC recipe of :func:`phase_voc_e2e` on the plain route
    (``impl="torch"``: no hand-written kernel), through the CLI's wiring;
    returns the held-out meanIU."""
    from ccnet_tpu_torch.cli.train import voc_dataset
    from ccnet_tpu_torch.data import DataLoader
    from ccnet_tpu_torch.data.voc import VOC_MEAN
    from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(num_classes=VOC_CLASSES, depth=DEPTH, input_size=(VOC_CROP, VOC_CROP),
                      batch_size=VOC_BATCH, learning_rate=5e-3, num_steps=VOC_STEPS,
                      save_every=VOC_STEPS, snapshot_dir=snap, seed=304,
                      augment_backend="precropped", mean=VOC_MEAN, impl="torch", device="cuda")
    ds = voc_dataset(MemoryVOC(tree["train"]), (VOC_CROP, VOC_CROP), seed=304)
    Trainer(cfg).run(DataLoader(ds, VOC_BATCH, shuffle=True, seed=304))
    return _voc_eval(os.path.join(snap, f"CS_scenes_{VOC_STEPS}.pth"), tree["val"],
                     impl="torch")["meanIU"]


def phase_voc_e2e(tmp: str) -> dict:
    """``scripts/e2e_voc_synthetic.py`` on the card: ``cli.train --dataset
    voc`` (``VOCDataset`` → ``CachedDataset`` → ``AugmentingDataset``, given
    the in-memory tree) trains CCNet R101 R=2 bf16 from its seeded init,
    batch VOC_BATCH of VOC_CROP², VOC_STEPS steps, lr 5e-3, no OHEM; the
    exported ``.pth`` goes through the bucketed ``Evaluator`` on the 2
    held-out images, which must score meanIU > VOC_MIN_MIOU. If they do not,
    the same recipe runs on the plain route, and both numbers are raised.
    Returns the training's launch counts."""
    from ccnet_tpu_torch.cli.train import main

    tree = voc_synthetic_tree()
    snap = os.path.join(tmp, "voc")
    _reset_counts()
    base = _peak_reset()
    t0 = time.perf_counter()
    result = main(["--dataset", "voc", "--num-classes", str(VOC_CLASSES), "--depth", str(DEPTH),
                   "--batch-size", str(VOC_BATCH), "--input-size", f"{VOC_CROP},{VOC_CROP}",
                   "--num-steps", str(VOC_STEPS), "--save-pred-every", str(VOC_STEPS),
                   "--learning-rate", "5e-3", "--ohem", "0", "--random-seed", "304",
                   "--snapshot-dir", snap, "--device", "cuda"], dataset=MemoryVOC(tree["train"]))
    train_s = time.perf_counter() - t0
    launches, peak = _counts(), torch.cuda.max_memory_allocated() - base
    losses = result["losses"]
    if len(losses) != VOC_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"VOC train losses {losses}")
    # R=2 attention calls forward and backward per step, the NLL of both heads
    want = _want((VOC_CROP, VOC_CROP), 2 * VOC_STEPS, 2 * VOC_STEPS, 2 * VOC_STEPS)
    if launches != want:
        raise AssertionError(f"VOC training: expected launches {want}, got {launches}")
    _reset_counts()
    ev = _voc_eval(os.path.join(snap, f"CS_scenes_{VOC_STEPS}.pth"), tree["val"])
    eval_launches = {n: c for n, c in _counts().items() if c}
    dev, wall = result["step_seconds"][1:], result["wall_seconds"][1:]
    tag = (f"cli.train --dataset voc CCNet R{DEPTH} R=2 bf16 bs {VOC_BATCH} {VOC_CROP}x{VOC_CROP}"
           f", {VOC_STEPS} steps, lr 5e-3, no OHEM")
    log(f"[voc] {tag}: losses first {losses[0]:.4f}, step 50 {losses[min(49, len(losses) - 1)]:.4f}"
        f", last {losses[-1]:.4f}; launches {launches}")
    log(f"[voc] {tag}, steps 2-{VOC_STEPS}: {np.mean(dev):.4f} s/step on the card (CUDA "
        f"events; median {np.median(dev):.4f}), host wall {np.mean(wall):.4f} s/step (median "
        f"{np.median(wall):.4f}), {train_s:.1f} s in all; peak memory {peak / 2**30:.2f} GiB")
    secs = ev["batch_seconds"]
    log(f"[voc] held-out meanIU {ev['meanIU']:.4f} (bar {VOC_MIN_MIOU}) on {len(tree['val'])} "
        f"images, bucket {VOC_BUCKET}, tile {VOC_CROP}: s/img on the card "
        + " ".join(f"{v:.4f}" for v in secs) + f"; evaluator launches {eval_launches}")
    if not ev["meanIU"] > VOC_MIN_MIOU:
        plain = _voc_train_plain(tree, os.path.join(tmp, "voc_plain"))
        raise AssertionError(f"VOC e2e: held-out meanIU {ev['meanIU']:.4f} <= {VOC_MIN_MIOU} "
                             f"on the kernel route; the plain route's {plain:.4f}")
    return launches


def phase_predict(pth: str, tmp: str) -> dict:
    """``cli.predict.main`` on 2 synthetic :data:`EVAL_HW` images with the
    769² training's ``.pth``, sliding (K1/K2) and ``--whole 1`` (K7a): the
    labelId PNGs, decoded with the standard library, equal
    ``trainid_to_labelid`` of ``Evaluator.predict_batch`` on the same
    weights, and the launch counts are the evaluation's. Returns the
    launches of both runs, summed."""
    from ccnet_tpu_torch.cli.predict import main
    from ccnet_tpu_torch.data import SyntheticDataset, trainid_to_labelid
    from ccnet_tpu_torch.data.palette import read_png
    from ccnet_tpu_torch.evaluation import Evaluator
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.utils import load_pth

    ds = SyntheticDataset(n=2, hw=EVAL_HW, num_classes=19)
    model = build_model("ccnet", num_classes=19, recurrence=2, depth=DEPTH,
                        dtype=torch.bfloat16, device="cuda")
    load_pth(pth, model, strict=True)
    total = {n: 0 for n in _counts()}
    for mode, flags in (("sliding", []), ("whole", ["--whole", "1"])):
        out = os.path.join(tmp, f"predict_{mode}")
        _reset_counts()
        result = main(["--restore-from", pth, "--depth", str(DEPTH), "--input-size",
                       f"{CROP},{CROP}", "--output-dir", out, "--device", "cuda"] + flags,
                      dataset=ds)
        launches = _counts()
        want = _eval_want(mode, len(ds))
        if launches != want:
            raise AssertionError(f"predict {mode}: expected launches {want}, got {launches}")
        ev = Evaluator(lambda x: model(x)["main"], num_classes=19, tile_hw=(CROP, CROP),
                       whole=mode == "whole", device="cuda")
        for i, path in enumerate(result["paths"]):
            got = read_png(path, 0)[0]
            want_png = trainid_to_labelid(ev.predict_batch(ds[i][0][None])[0])
            if got.shape != EVAL_HW or not np.array_equal(got, want_png):
                raise AssertionError(f"predict {mode}: {path} differs from the evaluator's "
                                     f"labelIds on {int((got != want_png).sum())} pixels")
        for name, c in launches.items():
            total[name] += c
        secs = result["seconds"]
        log(f"[predict] cli.predict {' '.join(flags) or 'sliding'} R{DEPTH} R=2 bf16, 2 "
            f"synthetic {EVAL_HW[0]}x{EVAL_HW[1]} images: labelId PNGs (stdlib-decoded) equal "
            f"the evaluator's mapped argmax; launches {launches}; host s/img "
            + " ".join(f"{v:.4f}" for v in secs) + " (predict, copy back and PNG)")
    del model
    torch.cuda.empty_cache()
    return total


def phase_restore_dir(snap_dir: str, steps: int) -> None:
    """``cli.evaluate --restore-dir`` on the 769² training's full-state
    snapshots gives, exactly, the confusion matrix of ``--restore-from``
    the ``.pth`` exported at the same step (sliding, synthetic set)."""
    from ccnet_tpu_torch.cli.evaluate import main

    common = ["--synthetic", "--synthetic-size", f"{EVAL_HW[0]},{EVAL_HW[1]}", "--depth",
              str(DEPTH), "--input-size", f"{CROP},{CROP}", "--device", "cuda", "--save-preds", "0"]
    with tempfile.TemporaryDirectory() as out:
        by_dir = main(common + ["--restore-dir", snap_dir, "--output-dir", out])
        by_pth = main(common + ["--restore-from", os.path.join(snap_dir, f"CS_scenes_{steps}.pth"),
                                "--output-dir", out])
    a, b = np.asarray(by_dir["confusion"]), np.asarray(by_pth["confusion"])
    if not np.array_equal(a, b):
        raise AssertionError(f"--restore-dir and --restore-from disagree on {int((a != b).sum())} "
                             f"confusion entries")
    log(f"[restore-dir] cli.evaluate --restore-dir {os.path.basename(snap_dir)} (step {steps}) = "
        f"--restore-from CS_scenes_{steps}.pth: the same confusion matrix (sum {int(a.sum())}), "
        f"meanIU {by_dir['meanIU']:.6f}")


def phase_native_train(pth: str, tmp: str) -> None:
    """``cli.train --synthetic --augment-backend native`` (the C++/OpenMP
    library, built with g++ here), NATIVE_STEPS steps at batch TRAIN_BATCH
    of 769²: launch counts, and the card's s/step beside the host wall
    s/step, as :func:`train_wall` prints them."""
    from ccnet_tpu_torch import native
    from ccnet_tpu_torch.cli.train import main

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    _reset_counts()
    result = main(["--synthetic", "--synthetic-size", f"{EVAL_HW[0]},{EVAL_HW[1]}", "--device",
                   "cuda", "--batch-size", str(TRAIN_BATCH), "--input-size", f"{CROP},{CROP}",
                   "--depth", str(DEPTH), "--ohem", "1", "--num-steps", str(NATIVE_STEPS),
                   "--save-pred-every", str(NATIVE_STEPS), "--export-pth", "0",
                   "--augment-backend", "native", "--restore-from", pth, "--snapshot-dir",
                   os.path.join(tmp, "snapshots_native")])
    launches = _counts()
    want = _want((CROP, CROP), 2 * NATIVE_STEPS, 2 * NATIVE_STEPS, 2 * NATIVE_STEPS)
    if launches != want or not all(math.isfinite(v) for v in result["losses"]):
        raise AssertionError(f"native: launches {launches} (want {want}), losses "
                             f"{result['losses']}")
    dev, wall = result["step_seconds"], result["wall_seconds"]
    log(f"[native] cli.train --synthetic --augment-backend native bs {TRAIN_BATCH} {CROP}x{CROP},"
        f" {NATIVE_STEPS} steps (library built/loaded in {build_s:.2f} s): losses "
        + " ".join(f"{v:.4f}" for v in result["losses"])
        + f"; host wall median {np.median(wall[1:]):.4f} s/step ("
        + " ".join(f"{v:.4f}" for v in wall) + f"), card median {np.median(dev[1:]):.4f} s/step ("
        + " ".join(f"{v:.4f}" for v in dev) + ")")


def _grad_groups(model) -> dict:
    """The model's grads after a step, flattened per group: the remat'd
    layers 3 and 4 of the trunk, and the rest."""
    groups = {"layer3": [], "layer4": [], "rest": []}
    for name, p in model.named_parameters():
        if p.grad is not None:
            key = next((g for g in ("layer3", "layer4") if f".{g}." in f".{name}"), "rest")
            groups[key].append(p.grad.float().flatten())
    return {g: torch.cat(v) for g, v in groups.items()}


def phase_remat(pth: str) -> None:
    """Two OHEM train steps of CCNet R101 R=2 bf16 at batch TRAIN_BATCH of
    769² from the same state for each mode of REMAT_MODES. Against ``none``:
    the first step's grads within REMAT_GRAD_RTOL per group (layers 3 and 4,
    whose backward recomputes, and the rest), the second step's loss, which
    the first step's update feeds, within REMAT_LOSS_RTOL, and the BN running
    stats' update within REMAT_STATS_RTOL (a recompute that updated them
    again would move them about twice as far); ``blocks`` peaks below
    ``none``. Prints each mode's peak memory (less the model and its state)
    and the second step's time."""
    from ccnet_tpu_torch.losses import build_criterion
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.train import create_train_state, make_train_step
    from ccnet_tpu_torch.utils import load_pth

    x, y = _train_batch(3, TRAIN_BATCH, (CROP, CROP))
    runs = {}
    for mode in REMAT_MODES:
        model = build_model("ccnet", num_classes=19, recurrence=2, depth=DEPTH,
                            dtype=torch.bfloat16, drop_rate=0.0, device="cuda",
                            remat={"none": False, "blocks": True}.get(mode, mode))
        load_pth(pth, model, strict=True)
        before = torch.cat([b.flatten() for n, b in model.named_buffers()
                            if n.endswith(("running_mean", "running_var"))]).clone()
        state = create_train_state(model)
        step = make_train_step(build_criterion(ohem=True))
        base = _peak_reset()
        loss = step(state, x, y)["loss"].item()
        peak = torch.cuda.max_memory_allocated() - base
        delta = torch.cat([b.flatten() for n, b in model.named_buffers()
                           if n.endswith(("running_mean", "running_var"))]) - before
        grads = _grad_groups(model)
        second = {}
        seconds = _seconds(lambda: second.update(step(state, x, y)))
        runs[mode] = {"loss": loss, "loss2": second["loss"].item(), "delta": delta,
                      "grads": grads, "peak": peak, "s": seconds}
        del model, state, step
        torch.cuda.empty_cache()
    plain = runs["none"]
    for mode, r in runs.items():
        r["loss_rel"] = max(abs(r[k] - plain[k]) / abs(plain[k]) for k in ("loss", "loss2"))
        r["stats_rel"] = ((r["delta"] - plain["delta"]).norm() / plain["delta"].norm()).item()
        r["grad_rel"] = {g: ((r["grads"][g] - v).norm() / v.norm()).item()
                         for g, v in plain["grads"].items()}
    log(f"[remat] CCNet R{DEPTH} R=2 bf16 OHEM bs {TRAIN_BATCH} {CROP}x{CROP}, two steps per mode: "
        + "; ".join(f"{m} loss {r['loss']:.6f} then {r['loss2']:.6f} (rel {r['loss_rel']:.2e}, tol "
                    f"{REMAT_LOSS_RTOL:g}), first step's grads rel "
                    + " ".join(f"{g}={e:.2e}" for g, e in r["grad_rel"].items())
                    + f" (tol {REMAT_GRAD_RTOL:g}), BN stats update rel {r['stats_rel']:.2e} (tol "
                    f"{REMAT_STATS_RTOL:g}), peak memory {r['peak'] / 2**30:.2f} GiB, second step "
                    f"{r['s']:.4f} s" for m, r in runs.items()))
    if not all(r["loss_rel"] <= REMAT_LOSS_RTOL and r["stats_rel"] <= REMAT_STATS_RTOL
               and max(r["grad_rel"].values()) <= REMAT_GRAD_RTOL for r in runs.values()):
        raise AssertionError("remat: a mode's losses, grads or BN stats disagree with no remat")
    if not all(v.norm().item() > 0 for v in plain["grads"].values()):
        raise AssertionError("remat: a group of no-remat grads is zero")
    if not runs["blocks"]["peak"] < plain["peak"]:
        raise AssertionError("remat: blocks did not lower the peak memory")


def phase_profiler(pth: str, tmp: str) -> None:
    """``cli.train --profile-steps 1,2``, PROFILE_STEPS steps at batch
    PROFILE_BATCH of 769²: the chrome trace of step 1 is written and names
    the attention's forward kernels (K1/K2, ``cca_fwd_*``)."""
    from ccnet_tpu_torch.cli.train import main

    snap = os.path.join(tmp, "snapshots_profile")
    main(["--synthetic", "--synthetic-size", f"{EVAL_HW[0]},{EVAL_HW[1]}", "--device", "cuda",
          "--batch-size", str(PROFILE_BATCH), "--input-size", f"{CROP},{CROP}", "--depth",
          str(DEPTH), "--num-steps", str(PROFILE_STEPS), "--save-pred-every",
          str(PROFILE_STEPS), "--export-pth", "0", "--restore-from", pth, "--snapshot-dir", snap,
          "--profile-steps", ",".join(map(str, PROFILE_RANGE))])
    path = os.path.join(snap, "profile", "trace_%d_%d.json" % PROFILE_RANGE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    cca = sorted({e["name"][:80] for e in kernels if "cca_fwd" in e["name"]})
    if not cca:
        raise AssertionError(f"{path}: no cca_fwd kernel among {len(kernels)} kernel events")
    log(f"[profiler] cli.train --profile-steps {PROFILE_RANGE[0]},{PROFILE_RANGE[1]}: {path} "
        f"({os.path.getsize(path) / 1e6:.1f} MB), {len(kernels)} kernel events, "
        f"{sum('cca_fwd' in e['name'] for e in kernels)} of the attention's forward: {cca}")


# ----------------------------------------------------------------------------
# The OHEM threshold by count bisection, which took kthvalue's place.
def _keep_by_kthvalue(p, valid, thresh: float, min_kept: int):
    """The keep mask as the port took it before the count bisection: an
    exact ``torch.kthvalue`` over the flat map (the yardstick)."""
    flat = torch.where(valid, p, torch.full_like(p, float("inf"))).reshape(-1)
    kth = torch.kthvalue(flat, min(min_kept, flat.numel())).values
    t = torch.tensor(thresh, device=p.device)
    return valid & (p <= torch.where(valid.sum() <= min_kept, torch.ones_like(t),
                                     torch.maximum(t, kth)))


def phase_ohem() -> None:
    """``ohem_keep_mask`` (the JAX package's count bisection) at the 769²
    step's map (TRAIN_BATCH × 769², the default thresh 0.7 and min_kept
    100000) against the exact ``kthvalue`` rule: equal keep masks where the
    k-th statistic binds and where thresh does; both timed."""
    from ccnet_tpu_torch.losses.ohem import ohem_keep_mask

    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (TRAIN_BATCH, CROP, CROP)
    valid = torch.rand(shape, device="cuda", generator=g) > 0.05
    for case, p in (("k-th binds", 0.6 + 0.4 * torch.rand(shape, device="cuda", generator=g)),
                    ("thresh binds", torch.rand(shape, device="cuda", generator=g))):
        got = ohem_keep_mask(p, valid, 0.7, 100000)
        want = _keep_by_kthvalue(p, valid, 0.7, 100000)
        if not torch.equal(got, want):
            raise AssertionError(f"ohem ({case}): {int((got != want).sum())} pixels differ")
        ms = _time_ms(ohem_keep_mask, p, valid, 0.7, 100000)
        ref = _time_ms(_keep_by_kthvalue, p, valid, 0.7, 100000)
        log(f"[ohem] ohem_keep_mask at {shape} ({case}, {int(got.sum())} kept): bisection "
            f"{ms:.4f} ms, kthvalue {ref:.4f} ms; keep masks equal")


# ----------------------------------------------------------------------------
# Data parallelism: N ranks under torchrun against one process.
DDP_RANKS = 2  # ranks sharing the one card over gloo
DDP_STEPS, NCCL_STEPS, DDP_EVAL_IMAGES = 3, 2, 4
DDP_TIMEOUT = 600  # seconds a torchrun launch may take before its ranks are killed
# phase_ddp_train's bf16 bounds (NVIDIA H100 80GB HBM3, 700 W; readings
# in PERF.md). Each sits between what two ranks read against one process
# and what a fault of DDP_FAULTS reads (``chip_smoke.py
# --ddp-diagnostics``): the losses catch no update and a halved or doubled
# one, the first step's BN running-stats update (a forward quantity from
# the same random weights) catches per-rank BN moments, and ABN over the
# ranks on a layer-4 BN input of the step against ``F.batch_norm`` on the
# global batch (DDP_ABN_SHAPE) catches per-rank moments and per-rank
# backward sums. The parameters' change is printed and not held: from
# random weights the step's gradient is shattered, so bf16 rounding alone
# turns it (one process in bf16 against f32 differs by 1.41 of itself,
# as far as two orthogonal vectors of one length).
DDP_LOSS_RTOL = 2.5e-4
DDP_STATS_RTOL = 3e-4
DDP_ABN_RTOL = 1e-2
DDP_ABN_SHAPE = (TRAIN_BATCH, 512, 97, 97)  # a layer-4 BN input of the 769² step
DDP_FAULTS = ("zero", "half", "double", "bn_dx", "bn")
DDP_PROFILE = (2, 3)  # the two-rank step that --ddp-diagnostics profiles


def _torchrun(nproc: int, args, log_path: str) -> None:
    """``python -m torch.distributed.run --standalone --nproc_per_node nproc
    chip_smoke.py --rank-main ...``: the ranks in a session of their own,
    all killed if they outlast DDP_TIMEOUT; raises with the log's tail if
    any rank fails."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), os.path.abspath(__file__), "--rank-main", *args]
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            rc = proc.wait(timeout=DDP_TIMEOUT)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)  # the agent and every rank it started
            except ProcessLookupError:
                pass
            proc.wait()
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"torchrun --nproc_per_node {nproc} "
                             f"{'timed out' if rc is None else f'exited {rc}'}:\n{tail}")


def _plant(fault: str) -> None:
    """Break this rank's step the way ``fault`` names, for
    ``--ddp-diagnostics``: ``zero`` applies no update, ``half``/``double``
    scale the rank's loss by 1 or 2N instead of N (DDP averages), ``bn_dx``
    takes the BN backward's sums over the rank's share alone (as if every
    rank's were equal), ``bn`` normalises with the rank's own moments
    (``F.batch_norm``, plain DDP)."""
    import torch.nn.functional as F

    import ccnet_tpu_torch.nn.layers
    import ccnet_tpu_torch.train.step
    from ccnet_tpu_torch.parallel import world

    layers, step = (sys.modules[f"ccnet_tpu_torch.{m}"] for m in ("nn.layers", "train.step"))
    rank, size = world()
    if fault == "zero":
        torch.optim.SGD.step = lambda self, closure=None: None
    elif fault in ("half", "double"):
        step.world = lambda: (rank, 1 if fault == "half" else 2 * size)
    elif fault == "bn_dx":
        backward, reduce = layers._GlobalBatchNorm.backward, layers.all_reduce_sum

        def local_backward(ctx, dy):
            layers.all_reduce_sum = lambda t, kind: t * size
            try:
                return backward(ctx, dy)
            finally:
                layers.all_reduce_sum = reduce

        layers._GlobalBatchNorm.backward = staticmethod(local_backward)
    elif fault == "bn":
        class Local:
            @staticmethod
            def apply(x, weight, bias, running_mean, running_var, momentum, eps):
                return F.batch_norm(x, running_mean, running_var, weight, bias, training=True,
                                    momentum=momentum, eps=eps)

        layers._GlobalBatchNorm = Local
    else:
        raise ValueError(f"unknown fault {fault!r}")


def _abn_rank_check() -> dict:
    """In a rank: ABN (identity, as in the trunk) in train mode over the
    ranks on the rank's share of a seeded global bf16 batch of
    DDP_ABN_SHAPE whose two halves differ in mean, scale and gradient,
    against ``F.batch_norm`` on the whole batch in this process:
    ``||got − want|| / ||want||`` of y, dx and the running stats' update."""
    import torch.nn.functional as F

    from ccnet_tpu_torch.nn.layers import ABN
    from ccnet_tpu_torch.parallel import rank_slice, world

    rank, size = world()
    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    C, half = DDP_ABN_SHAPE[1], DDP_ABN_SHAPE[0] // 2
    x, dy = randn(*DDP_ABN_SHAPE), randn(*DDP_ABN_SHAPE)
    x[half:] = x[half:] * 2.0 + 1.5
    dy[half:] += 0.5 + 0.3 * x[half:]
    x, dy = x.bfloat16(), dy.bfloat16()
    layer = ABN(C, activation="identity").cuda().train()
    with torch.no_grad():
        layer.weight.add_(0.1 * randn(C))
        layer.bias.add_(0.1 * randn(C))
    mine = rank_slice(x, rank, size).clone().requires_grad_(True)
    y = layer(mine)
    y.backward(rank_slice(dy, rank, size))
    full = x.clone().requires_grad_(True)
    mean, var = torch.zeros(C, device="cuda"), torch.ones(C, device="cuda")
    want = F.batch_norm(full, mean, var, layer.weight.detach(), layer.bias.detach(),
                        training=True, momentum=0.1, eps=layer.eps)
    want.backward(dy)
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()  # noqa: E731
    return {"y": rel(y.detach(), rank_slice(want.detach(), rank, size)),
            "dx": rel(mine.grad, rank_slice(full.grad, rank, size)),
            "stats": max(rel(layer.running_mean, mean), rel(layer.running_var - 1, var - 1))}


# the Lovász criteria over the ranks (phase 21): each rank's share of the
# seeded global inputs against one process on the global batch, f32 on the
# card. The shares sum in another order (loss) and ties among equal errors
# may sort apart (grads): LOVASZ_LOSS_RTOL relative, LOVASZ_GRAD_TOL x max |grad|.
LOVASZ_LOSS_RTOL, LOVASZ_GRAD_TOL = 1e-5, 1e-4


def _lovasz_inputs() -> tuple:
    """Seeded global inputs on the card: the 769² step's main logits
    (TRAIN_BATCH, 19, 97, 97), labels at 769² (10 % ignored; class 17 only
    in the second half of the batch, class 18 nowhere), and binary logits
    and labels at (TRAIN_BATCH, 97, 97) for the hinge."""
    g = torch.Generator(device="cuda").manual_seed(11)
    B, f = TRAIN_BATCH, _features(CROP)
    main = torch.randn((B, 19, f, f), generator=g, device="cuda") * 2.0
    labels = torch.randint(0, 18, (B, CROP, CROP), generator=g, device="cuda")
    labels[:B // 2][labels[:B // 2] == 17] = 0
    labels[torch.rand(labels.shape, generator=g, device="cuda") < 0.1] = 255
    hinge = torch.randn((B, f, f), generator=g, device="cuda")
    binary = torch.randint(0, 2, (B, f, f), generator=g, device="cuda")
    binary[torch.rand(binary.shape, generator=g, device="cuda") < 0.1] = 255
    return main, labels, hinge, binary


def _lovasz_losses(main, labels, hinge, binary) -> dict:
    """``criterion_ohem_dsn2`` (CE + Lovász-softmax at 769²) and
    ``lovasz_hinge`` (``per_image=False``): name -> (loss, grad of its
    logits); over N ranks, the rank's shares."""
    from ccnet_tpu_torch.losses import criterion_ohem_dsn2
    from ccnet_tpu_torch.losses.lovasz import lovasz_hinge

    m, x = main.clone().requires_grad_(True), hinge.clone().requires_grad_(True)
    dsn2 = criterion_ohem_dsn2({"main": m, "aux": main}, labels)
    hinge_loss = lovasz_hinge(x, binary, per_image=False, ignore=255)
    return {"criterion_ohem_dsn2": (float(dsn2.detach()), torch.autograd.grad(dsn2, m)[0]),
            "lovasz_hinge": (float(hinge_loss.detach()), torch.autograd.grad(hinge_loss, x)[0])}


def _lovasz_rank_check(out: str) -> dict:
    """In a rank: :func:`_lovasz_losses` on the rank's share of
    :func:`_lovasz_inputs`; the loss shares, the grads to
    ``OUT/lovasz_r<rank>.pt``."""
    from ccnet_tpu_torch.parallel import rank_slice, world

    rank, size = world()
    got = _lovasz_losses(*(rank_slice(t, rank, size) for t in _lovasz_inputs()))
    torch.save({k: g.cpu() for k, (_, g) in got.items()}, os.path.join(out, f"lovasz_r{rank}.pt"))
    return {k: loss for k, (loss, _) in got.items()}


def _lovasz_readings(ranks: list, out: str) -> dict:
    """The ranks' Lovász shares against one process on the global batch:
    per criterion the summed loss, its relative difference and the max abs
    grad difference over max |grad|."""
    want = _lovasz_losses(*_lovasz_inputs())
    grads = [torch.load(os.path.join(out, f"lovasz_r{r['rank']}.pt")) for r in ranks]
    got = {}
    for name, (loss, grad) in want.items():
        total = sum(r["lovasz"][name] for r in ranks)
        mine = torch.cat([g[name] for g in grads]).cuda()
        got[name] = {"loss": total, "one": loss, "loss_rel": abs(total - loss) / abs(loss),
                     "grad": ((mine - grad).abs().max() / grad.abs().max()).item()}
    return got


def rank_main(argv) -> None:
    """One rank under torchrun: ``--rank-main train|train+FAULT|evaluate
    OUT -- ARGV`` runs ``cli.train.main(ARGV)`` (with :func:`_plant`'s
    FAULT; then :func:`_abn_rank_check` and :func:`_lovasz_rank_check`) or
    ``cli.evaluate.main(ARGV)`` (on DDP_EVAL_IMAGES synthetic images of
    EVAL_HW, into ``OUT/eval_r<rank>``) and writes its launch counts and
    result to ``OUT/rank<rank>.json``; ``--rank-main space OUT -- PTH...``
    runs :func:`_space_rank` on the weights of SPACE_JOBS."""
    what, out, cli_argv = argv[0], argv[1], argv[3:]
    rank = int(os.environ["RANK"])
    _reset_counts()
    if what == "space":
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(_space_rank(out, cli_argv), f)
        return
    if what.startswith("train"):
        from ccnet_tpu_torch.cli.train import main as cli_main
        from ccnet_tpu_torch.parallel import maybe_initialize_distributed

        if "+" in what:  # the group first: the fault reads the rank and the size
            maybe_initialize_distributed(device="cuda")
            _plant(what.split("+")[1])
        result = cli_main(cli_argv)
        result["abn"] = _abn_rank_check()
        result["lovasz"] = _lovasz_rank_check(out)
    else:
        from ccnet_tpu_torch.cli.evaluate import main as cli_main
        from ccnet_tpu_torch.data import SyntheticDataset

        result = cli_main(cli_argv + ["--output-dir", os.path.join(out, f"eval_r{rank}")],
                          dataset=SyntheticDataset(n=DDP_EVAL_IMAGES, hw=EVAL_HW, num_classes=19))
    from ccnet_tpu_torch.parallel import world

    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": world()[1], "launches": _counts(), **{
            k: result[k] for k in ("losses", "step_seconds", "wall_seconds", "confusion",
                                   "batch_seconds", "abn", "lovasz") if k in result}}, f)


def _ranks(out: str, n: int) -> list:
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if [r["world"] for r in ranks] != [n] * n:
        raise AssertionError(f"ranks saw world sizes {[r['world'] for r in ranks]}, not {n}")
    return ranks


def _weights_diff(a: str, b: str, init: str) -> dict:
    """Two exported ``.pth`` against each other, by their change from
    ``init``: ``||Δa − Δb|| / ||Δb||`` over all parameters (``change``; a
    tensor whose change is near zero, a conv bias ahead of BN, would make a
    per-tensor ratio noise) and over all BN running stats (``stats``), the
    worst parameter tensor's ratio, and the largest max |a − b|."""
    a, b, i = (torch.load(p, map_location="cpu") for p in (a, b, init))
    sums = {"change": [0.0, 0.0], "stats": [0.0, 0.0]}
    worst, abs_diff = (0.0, ""), 0.0
    for k in b:
        if not a[k].is_floating_point():
            continue
        d = a[k].double() - b[k].double()
        abs_diff = max(abs_diff, d.abs().max().item())
        moved = (b[k].double() - i[k].double()).norm().item()
        part = sums["stats" if k.endswith(("running_mean", "running_var")) else "change"]
        part[0], part[1] = part[0] + d.norm().item() ** 2, part[1] + moved ** 2
        if moved > 0 and part is sums["change"]:
            worst = max(worst, (d.norm().item() / moved, k))
    return {**{k: (n / d) ** 0.5 for k, (n, d) in sums.items()}, "worst": worst, "abs": abs_diff}


def _train_argv(pth: str, steps: int, snap: str, save_every: int = 0) -> list:
    return ["--depth", str(DEPTH), "--device", "cuda", "--batch-size", str(TRAIN_BATCH),
            "--input-size", f"{CROP},{CROP}", "--synthetic-size", f"{EVAL_HW[0]},{EVAL_HW[1]}",
            "--ohem", "1", "--num-steps", str(steps), "--save-pred-every",
            str(save_every or steps), "--restore-from", pth, "--num-workers", "4",
            "--snapshot-dir", snap, "--random-scale", "0"]


def _one_process(pth: str, steps: int, snap: str, ranks: int, save_every: int = 0) -> dict:
    """``cli.train.main`` in this process on the global batches of
    ``ranks`` ranks (``RankOrder``; the synthetic set of ``--synthetic``
    with its device augmentation); its launch counts beside its result."""
    from ccnet_tpu_torch.cli.train import main
    from ccnet_tpu_torch.data import SyntheticDataset
    from ccnet_tpu_torch.parallel import RankOrder

    ds = SyntheticDataset(n=max(TRAIN_BATCH * 4, 16), hw=EVAL_HW, num_classes=19)
    _reset_counts()
    result = main(_train_argv(pth, steps, snap, save_every)
                  + ["--augment-backend", "device", "--cache-decoded", "0"],
                  dataset=RankOrder(ds, TRAIN_BATCH, ranks, seed=304))
    return {**result, "launches": _counts()}


def _s_step(r: dict) -> str:
    return (f"{np.median(r['step_seconds'][1:]):.4f} s/step on the card (median of steps 2-, "
            f"CUDA events), host wall {np.median(r['wall_seconds'][1:]):.4f}")


def _ddp_readings(out: str, snap: str, one: dict, pth: str) -> dict:
    """The two-rank run in ``out`` (rank files) and ``snap`` (its .pth of
    every step) against one process: the losses' max relative difference,
    and :func:`_weights_diff` after the first step and after the last."""
    ranks = _ranks(out, DDP_RANKS)
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"the ranks logged different losses: {[r['losses'] for r in ranks]}")
    pth_of = lambda d, s: os.path.join(d, f"CS_scenes_{s}.pth")  # noqa: E731
    return {"ranks": ranks, "losses": ranks[0]["losses"],
            "loss": max(abs(x - y) / abs(y) for x, y in zip(ranks[0]["losses"], one["losses"])),
            "abn": {k: max(r["abn"][k] for r in ranks) for k in ranks[0]["abn"]},
            "lovasz": _lovasz_readings(ranks, out),
            "first": _weights_diff(pth_of(snap, 1), pth_of(one["snap"], 1), pth),
            "last": _weights_diff(pth_of(snap, DDP_STEPS), pth_of(one["snap"], DDP_STEPS), pth)}


def _ddp_run(pth: str, out: str, fault: str = "", profile: bool = False) -> None:
    """Two ranks of ``cli.train --synthetic`` under torchrun (gloo, the one
    card), DDP_STEPS steps, a .pth after each, into ``out``."""
    os.makedirs(out)
    argv = _train_argv(pth, DDP_STEPS, os.path.join(out, "snap"), save_every=1)
    if profile:
        argv += ["--profile-steps", ",".join(map(str, DDP_PROFILE))]
    _torchrun(DDP_RANKS, ["train" + (f"+{fault}" if fault else ""), out, "--", "--synthetic"]
              + argv, os.path.join(out, "torchrun.log"))


def _ddp_one(pth: str, tmp: str) -> dict:
    """The same DDP_STEPS steps in this process on the same global batches."""
    snap = os.path.join(tmp, "ddp_one")
    return {**_one_process(pth, DDP_STEPS, snap, DDP_RANKS, save_every=1), "snap": snap}


def _ddp_line(tag: str, got: dict) -> str:
    f, last, abn = got["first"], got["last"], got["abn"]
    return (f"[{tag}] losses " + " ".join(f"{v:.6f}" for v in got["losses"])
            + f" (max rel {got['loss']:.2e}, tol {DDP_LOSS_RTOL:g}); the first step's BN stats "
            f"update rel {f['stats']:.3e} (tol {DDP_STATS_RTOL:g}); ABN over the ranks at "
            f"{DDP_ABN_SHAPE} bf16 against F.batch_norm, worst rank: y {abn['y']:.3e}, dx "
            f"{abn['dx']:.3e}, stats {abn['stats']:.3e} (tol {DDP_ABN_RTOL:g}); not held: the "
            f"first step's change rel {f['change']:.3e} (worst tensor {f['worst'][1]} "
            f"{f['worst'][0]:.3e}), max abs {f['abs']:.3e}; after step {DDP_STEPS}: change rel "
            f"{last['change']:.3e}, stats rel {last['stats']:.3e}, max abs {last['abs']:.3e}; "
            "Lovász over the ranks against one process on the global batch: " + "; ".join(
                f"{k} loss {v['loss']:.6f} / {v['one']:.6f} rel {v['loss_rel']:.2e} (tol "
                f"{LOVASZ_LOSS_RTOL:g}), grad {v['grad']:.2e} x max (tol {LOVASZ_GRAD_TOL:g})"
                for k, v in got["lovasz"].items()))


def _ddp_fails(got: dict) -> bool:
    return (got["loss"] > DDP_LOSS_RTOL or got["first"]["stats"] > DDP_STATS_RTOL
            or max(got["abn"].values()) > DDP_ABN_RTOL
            or any(v["loss_rel"] > LOVASZ_LOSS_RTOL or v["grad"] > LOVASZ_GRAD_TOL
                   for v in got["lovasz"].values()))


def phase_ddp_train(pth: str, tmp: str, smi: str) -> None:
    """Two ranks of ``cli.train --synthetic`` under torchrun on the one card
    (gloo), CCNet R101 R=2 bf16 OHEM+DSN, global batch TRAIN_BATCH of 769²,
    DDP_STEPS steps, against the same steps in one process on the same
    global batches (``RankOrder``). Each rank launches K1–K6 as one process
    does; the losses agree within DDP_LOSS_RTOL, the first step's BN
    running-stats update within DDP_STATS_RTOL, and each rank's ABN check
    (:func:`_abn_rank_check`) within DDP_ABN_RTOL."""
    out = os.path.join(tmp, "ddp_train")
    torch.cuda.empty_cache()  # the ranks share the card with this process
    _ddp_run(pth, out)
    one = _ddp_one(pth, tmp)
    got = _ddp_readings(out, os.path.join(out, "snap"), one, pth)
    want = _want((CROP, CROP), 2 * DDP_STEPS, 2 * DDP_STEPS, 2 * DDP_STEPS)
    bad = [r["rank"] for r in got["ranks"] if r["launches"] != want]
    if bad or one["launches"] != want:
        raise AssertionError(f"launches: want {want} in every rank and in one process; ranks "
                             f"{[r['launches'] for r in got['ranks']]}, one process "
                             f"{one['launches']}")
    log(f"[ddp-train] cli.train --synthetic CCNet R{DEPTH} R=2 bf16 OHEM global bs {TRAIN_BATCH} "
        f"{CROP}x{CROP}, {DDP_STEPS} steps, {DDP_RANKS} ranks (torchrun, gloo, one card) against "
        "one process on the same global batches (losses " + " ".join(
            f"{v:.6f}" for v in one["losses"]) + ")")
    log(_ddp_line("ddp-train", got))
    for r in got["ranks"]:
        log(f"[ddp-train] rank {r['rank']}: launches " + ", ".join(
            f"{k} {r['launches'][k]}" for k in ("cca_fwd_col", "cca_fwd_row", "cca_bwd_col",
                                                "cca_bwd_row", "upsampled_nll_fwd",
                                                "upsampled_nll_bwd"))
            + f"; {_s_step(r)}")
    log(f"[ddp-train] one process: {_s_step(one)}. {smi}. Two ranks sharing one card "
        "measure correctness, not scaling.")
    for d in (out, one["snap"]):  # six .pth and six checkpoints of R101
        shutil.rmtree(d)
    if _ddp_fails(got):
        raise AssertionError("ddp-train: the two ranks disagree with one process")


def _trace_split(path: str) -> dict:
    """One profiled step of a rank, from its chrome trace: the trace's span;
    the device's kernel time (sum) and busy time (union); the host time
    inside ``_GlobalBatchNorm``'s forward and backward (the union of their
    ops on each thread: the launches of its kernels and the waits on its
    collectives) and the device time of the kernels launched there; each
    collective op's count, host time and count inside BN."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def union(spans) -> float:
        total, end = 0.0, -1.0
        for a, b in sorted(spans):
            total, end = total + max(0.0, b - max(a, end)), max(end, b)
        return total / 1e6

    bn = {}
    for e in events:
        if e.get("cat") == "cpu_op" and "_GlobalBatchNorm" in e["name"]:
            bn.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    inside = lambda e: any(a <= e["ts"] <= b for a, b in bn.get(e["tid"], ()))  # noqa: E731
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    bn_kernels = [e for e in kernels if (src := launch.get(e.get("args", {}).get("correlation")))
                  is not None and inside(src)]
    comm = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith(("c10d::", "gloo:", "nccl:")):
            c = comm.setdefault(e["name"], [0, 0.0, 0])
            c[0], c[1], c[2] = c[0] + 1, c[1] + e["dur"] / 1e6, c[2] + inside(e)
    return {"span": union([(min(e["ts"] for e in events),
                            max(e["ts"] + e["dur"] for e in events))]),
            "kernels": sum(e["dur"] for e in kernels) / 1e6,
            "busy": union((e["ts"], e["ts"] + e["dur"]) for e in kernels),
            "bn_host": sum(union(v) for v in bn.values()), "bn_ops": sum(map(len, bn.values())),
            "bn_kernels": sum(e["dur"] for e in bn_kernels) / 1e6, "comm": comm}


def ddp_diagnostics(pth: str, tmp: str, smi: str) -> None:
    """``--ddp-diagnostics``: phase_ddp_train's readings for the two ranks
    as they are and with each fault of DDP_FAULTS planted in both ranks
    (:func:`_plant`), against the same one-process run, each with its
    s/step; then one two-rank step (DDP_PROFILE) under ``torch.profiler``
    (rank 0's trace) split into BN, collectives and the rest."""
    one = _ddp_one(pth, tmp)
    log(f"[ddp-diag] one process: losses " + " ".join(f"{v:.6f}" for v in one["losses"])
        + f"; {_s_step(one)}. {smi}")
    for fault in ("",) + DDP_FAULTS:
        out = os.path.join(tmp, f"ddp_{fault or 'clean'}")
        torch.cuda.empty_cache()
        _ddp_run(pth, out, fault)
        got = _ddp_readings(out, os.path.join(out, "snap"), one, pth)
        log(_ddp_line(f"ddp-diag {fault or 'no fault'}", got) + f"; fails the phase: "
            f"{_ddp_fails(got)}; rank 0 {_s_step(got['ranks'][0])}")
        shutil.rmtree(out)
    out = os.path.join(tmp, "ddp_profile")
    _ddp_run(pth, out, profile=True)
    split = _trace_split(os.path.join(out, "snap", "profile", "trace_%d_%d.json" % DDP_PROFILE))
    log(f"[ddp-diag] rank 0's step {DDP_PROFILE[0]} under torch.profiler (2 ranks, gloo, one "
        f"card): trace span {split['span']:.4f} s; kernels {split['kernels']:.4f} s, device "
        f"busy {split['busy']:.4f} s; global BN ({split['bn_ops']} host ops): {split['bn_host']:.4f}"
        f" s of host time, {split['bn_kernels']:.4f} s of kernels; collectives (count, host s, "
        f"count inside BN): " + "; ".join(f"{k} {c[0]} {c[1]:.4f} {c[2]}"
                                          for k, c in sorted(split["comm"].items()))
        + f". {smi}")


def phase_ddp_nccl_one_rank(pth: str, tmp: str) -> None:
    """One rank of ``cli.train --synthetic`` under torchrun over NCCL (the
    backend of one rank per card), NCCL_STEPS steps, against the same steps
    without torchrun, twice: the torchrun run's losses and weights differ
    from the first plain run by no more than the second plain run does."""
    out = os.path.join(tmp, "ddp_nccl")
    os.makedirs(out)
    torch.cuda.empty_cache()
    _torchrun(1, ["train", out, "--", "--synthetic"]
              + _train_argv(pth, NCCL_STEPS, os.path.join(out, "snap")),
              os.path.join(out, "torchrun.log"))
    with open(os.path.join(out, "torchrun.log")) as f:
        if "backend nccl" not in f.read():
            raise AssertionError("the one-rank run did not initialise NCCL")
    rank, = _ranks(out, 1)
    one = [_one_process(pth, NCCL_STEPS, os.path.join(out, f"one{i}"), 1) for i in range(2)]
    pth_of = lambda d: os.path.join(d, f"CS_scenes_{NCCL_STEPS}.pth")  # noqa: E731
    got = _weights_diff(pth_of(os.path.join(out, "snap")), pth_of(os.path.join(out, "one0")), pth)
    rep = _weights_diff(pth_of(os.path.join(out, "one1")), pth_of(os.path.join(out, "one0")), pth)
    loss = max(abs(a - b) / abs(b) for a, b in zip(rank["losses"], one[0]["losses"]))
    rep_loss = max(abs(a - b) / abs(b) for a, b in zip(one[1]["losses"], one[0]["losses"]))
    log(f"[ddp-nccl] torchrun --nproc_per_node 1 (nccl) cli.train R{DEPTH} bs {TRAIN_BATCH}, "
        f"{NCCL_STEPS} steps: losses " + " ".join(f"{v:.6f}" for v in rank["losses"])
        + " against " + " ".join(f"{v:.6f}" for v in one[0]["losses"])
        + f" without torchrun: loss rel {loss:.2e}, max abs {got['abs']:.3e}, change rel "
        f"{got['change']:.3e}, stats rel {got['stats']:.3e}; the repeat without torchrun: loss "
        f"rel {rep_loss:.2e}, max abs {rep['abs']:.3e}, change rel {rep['change']:.3e}, stats rel "
        f"{rep['stats']:.3e}; {_s_step(rank)} (torchrun), {_s_step(one[0])} (plain)")
    if loss > rep_loss or got["abs"] > rep["abs"]:
        raise AssertionError("ddp-nccl: the NCCL rank differs from the plain run by more than "
                             "the plain run from itself")


def phase_ddp_eval(pth: str, tmp: str) -> None:
    """Two ranks of sliding ``cli.evaluate`` under torchrun (gloo, one card)
    over DDP_EVAL_IMAGES synthetic EVAL_HW images: each rank scores its
    share, the summed confusion equals the one-process one integer for
    integer, rank 0 alone writes ``result.txt``."""
    from ccnet_tpu_torch.cli.evaluate import main
    from ccnet_tpu_torch.data import SyntheticDataset

    out = os.path.join(tmp, "ddp_eval")
    os.makedirs(out)
    argv = ["--restore-from", pth, "--depth", str(DEPTH), "--input-size", f"{CROP},{CROP}",
            "--device", "cuda", "--save-preds", "0", "--num-workers", "2"]
    torch.cuda.empty_cache()
    _torchrun(DDP_RANKS, ["evaluate", out, "--"] + argv, os.path.join(out, "torchrun.log"))
    ranks = _ranks(out, DDP_RANKS)
    _reset_counts()
    one = main(argv + ["--output-dir", os.path.join(out, "one")],
               dataset=SyntheticDataset(n=DDP_EVAL_IMAGES, hw=EVAL_HW, num_classes=19))
    share = DDP_EVAL_IMAGES // DDP_RANKS
    if _counts() != _eval_want("sliding", DDP_EVAL_IMAGES) or any(
            r["launches"] != _eval_want("sliding", share) for r in ranks):
        raise AssertionError(f"eval launches: one process {_counts()}, ranks "
                             f"{[r['launches'] for r in ranks]}")
    want = np.asarray(one["confusion"])
    for r in ranks:
        if not np.array_equal(np.asarray(r["confusion"]), want):
            raise AssertionError(f"rank {r['rank']}'s summed confusion differs from one "
                                 f"process's in {int((np.asarray(r['confusion']) != want).sum())} "
                                 "entries")
    written = [os.path.isfile(os.path.join(out, f"eval_r{r}", "result.txt"))
               for r in range(DDP_RANKS)]
    if written != [True] + [False] * (DDP_RANKS - 1):
        raise AssertionError(f"result.txt written by ranks {written}")
    log(f"[ddp-eval] cli.evaluate sliding R{DEPTH} bf16, {DDP_EVAL_IMAGES} synthetic "
        f"{EVAL_HW[0]}x{EVAL_HW[1]} images, {DDP_RANKS} ranks (torchrun, gloo, one card, "
        f"{share} images each): summed confusion = one process's, integer for integer (sum "
        f"{int(want.sum())}, meanIU {one['meanIU']:.6f}); result.txt written once, by rank 0; "
        "s/img on the card " + "; ".join(
            f"rank {r['rank']} " + " ".join(f"{v:.4f}" for v in r["batch_seconds"])
            for r in ranks) + "; one process " + " ".join(f"{v:.4f}" for v in one["batch_seconds"]))


# ----------------------------------------------------------------------------
# Height-sharded whole-image inference: --whole 1 --space 2 over two ranks.
SPACE_RANKS = 2
# (tag, model, depth, synthetic EVAL_HW images, cli.evaluate flags); the
# heads at depth 50 keep the whole script within its time
SPACE_JOBS = [("whole", "ccnet", DEPTH, 2, ["--whole", "1"]),
              ("msflip", "ccnet", DEPTH, 1, ["--whole", "1", "--scales",
                                             ",".join(map(str, MS_SCALES)), "--flip", "1"]),
              ("pspnet", "pspnet", 50, 1, ["--whole", "1"]),
              ("deeplabv3", "deeplabv3", 50, 1, ["--whole", "1"])]
SPACE_K7A = ("cca_line_fwd", "cca_line_fwd_tc")


def _space_job(job, pth: str, out: str, space: bool, models: dict) -> dict:
    """One of SPACE_JOBS in this process: ``cli.evaluate.main`` (with
    ``--space SPACE_RANKS`` in a rank) on its synthetic images, its launch
    counts and peak memory; then the library's ``predict_multiscale``
    (``whole=True``, over a space group in a rank) of the first image, whose
    logits (a rank: its rows) go to ``out/<tag>_<rank or one>.pt``."""
    from ccnet_tpu_torch.cli.evaluate import main
    from ccnet_tpu_torch.data import CITYSCAPES_MEAN_BGR, SyntheticDataset
    from ccnet_tpu_torch.evaluation import predict_multiscale
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.parallel import space_group, world
    from ccnet_tpu_torch.utils import load_pth

    tag, name, depth, n, flags = job
    rank = world()[0] if space else "one"
    ds = SyntheticDataset(n=n, hw=EVAL_HW, num_classes=19)
    argv = ["--model", name, "--depth", str(depth), "--restore-from", pth, "--device", "cuda",
            "--save-preds", "0", "--input-size", f"{CROP},{CROP}", "--num-workers", "2",
            "--output-dir", os.path.join(out, f"{tag}_{rank}")] + flags
    torch.cuda.empty_cache()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    result = main(argv + (["--space", str(SPACE_RANKS)] if space else []), dataset=ds)
    got = {k: result[k] for k in ("confusion", "batch_seconds", "wall_seconds", "collectives")
           if k in result}
    got.update(launches=_counts(), peak=torch.cuda.max_memory_allocated())
    if (name, depth) not in models:
        model = build_model(name, num_classes=19, depth=depth, dtype=torch.bfloat16,
                            device="cuda")
        load_pth(pth, model)
        models[(name, depth)] = model.eval()
    model = models[(name, depth)]
    group = space_group(SPACE_RANKS) if space else None
    mean = torch.tensor(CITYSCAPES_MEAN_BGR, device="cuda")
    x = (torch.from_numpy(np.asarray(ds[0][0])).cuda().float() - mean).permute(2, 0, 1)[None]
    scales = [float(v) for v in flags[flags.index("--scales") + 1].split(",")] \
        if "--scales" in flags else [1.0]
    with torch.inference_mode():
        logits = predict_multiscale(lambda t: model(t)["main"], x, (CROP, CROP), 19,
                                    scales=scales, flip="--flip" in flags, whole=True,
                                    space=group)
    got["span"] = group.rows(EVAL_HW[0]) if space else (0, EVAL_HW[0])
    got["logits"] = os.path.join(out, f"{tag}_{rank}.pt")
    torch.save(logits.cpu(), got["logits"])
    return got


def _space_rank(out: str, pths) -> dict:
    """In a rank: every job of SPACE_JOBS with the weights ``pths``."""
    from ccnet_tpu_torch.parallel import maybe_initialize_distributed, world

    maybe_initialize_distributed(device="cuda")
    models = {}
    jobs = {job[0]: _space_job(job, pth, out, True, models) for job, pth in zip(SPACE_JOBS, pths)}
    return {"rank": world()[0], "world": world()[1], "jobs": jobs}


def _space_s_img(r: dict) -> str:
    secs = r["batch_seconds"]
    return f"{secs[-1]:.4f} s/img (image {len(secs)} of {len(secs)})"


def phase_space_eval(ccnet_pth: str, tmp: str, smi: str) -> dict:
    """Two ranks of ``cli.evaluate --whole 1 --space 2`` under torchrun
    (gloo, one card), each image's height split over the ranks, against one
    process's ``--whole 1`` on the same ``.pth`` and images (SPACE_JOBS:
    CCNet R101 R=2 bf16 on two 1024×2048 images and MS+flip on one, PSPNet
    and DeepLabv3 R50 on one): the summed confusion totals equal, each
    rank's K7a launches equal one process's (the attention runs on the
    gathered map), and the library's sharded logits of the first image,
    the ranks' rows together, within MODEL_TOL × scale of one process's with
    argmax agreement >= MODEL_ARGMAX. Prints per rank s/img, peak memory,
    the collectives (calls and bytes) and K7a's launches; returns K7a's
    launches summed over the ranks."""
    out = os.path.join(tmp, "space_eval")
    os.makedirs(out)
    pths = []
    for _, name, depth, _, _ in SPACE_JOBS:
        pth = ccnet_pth if name == "ccnet" else os.path.join(out, f"{name}_r{depth}.pth")
        if not os.path.isfile(pth):
            random_pth(name, pth, depth)
        pths.append(pth)
    torch.cuda.empty_cache()
    _torchrun(SPACE_RANKS, ["space", out, "--"] + pths, os.path.join(out, "torchrun.log"))
    ranks = _ranks(out, SPACE_RANKS)
    models, failed, k7a = {}, [], {n: 0 for n in SPACE_K7A}
    for job, pth in zip(SPACE_JOBS, pths):
        tag, name, depth, n, flags = job
        one = _space_job(job, pth, out, False, models)
        want = torch.load(one["logits"])
        rows = [torch.load(r["jobs"][tag]["logits"]) for r in ranks]
        spans = [r["jobs"][tag]["span"] for r in ranks]
        got = torch.cat(rows, dim=2)
        err, scale = _err(got, want)
        agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
        total = int(np.asarray(one["confusion"]).sum())
        totals = [int(np.asarray(r["jobs"][tag]["confusion"]).sum()) for r in ranks]
        entries = [int((np.asarray(r["jobs"][tag]["confusion"])
                        != np.asarray(one["confusion"])).sum()) for r in ranks]
        log(f"[space-eval] {tag}: cli.evaluate {name} R{depth} bf16 {' '.join(flags)} --space "
            f"{SPACE_RANKS}, {n} synthetic {EVAL_HW[0]}x{EVAL_HW[1]} image(s), {SPACE_RANKS} ranks "
            f"(torchrun, gloo, one card; rows {spans}) against one process: confusion totals "
            f"{totals} / {total} ({entries} entries differ); first image's logits, the ranks' "
            f"rows against one process: max abs err {err:.3e} (scale {scale:.3g}, tol "
            f"{MODEL_TOL:g} x scale), argmax agreement {agree:.6f} (>= {MODEL_ARGMAX}); one "
            f"process {_space_s_img(one)}, peak {one['peak'] / 2**30:.2f} GiB, K7a "
            f"{[one['launches'][k] for k in SPACE_K7A]}")
        for r in ranks:
            j = r["jobs"][tag]
            c = j["collectives"]
            log(f"[space-eval] {tag} rank {r['rank']}: {_space_s_img(j)} on the card (CUDA "
                f"events; one process {_space_s_img(one)}), host wall median "
                f"{np.median(j['wall_seconds']):.4f} s/img; peak {j['peak'] / 2**30:.2f} GiB "
                f"(one process {one['peak'] / 2**30:.2f}); collectives (calls, MB): " + ", ".join(
                    f"{k} {v[0]} {v[1] / 1e6:.3f}" for k, v in c.items())
                + f"; K7a launches {[j['launches'][k] for k in SPACE_K7A]} (cca_line_fwd, on "
                "tensor cores)")
            for k in SPACE_K7A:
                k7a[k] += j["launches"][k]
            if j["launches"] != one["launches"]:
                failed.append(f"{tag} rank {r['rank']} launches {j['launches']}, one process "
                              f"{one['launches']}")
        if not err <= MODEL_TOL * scale or agree < MODEL_ARGMAX or set(totals) != {total}:
            failed.append(f"{tag}: the ranks disagree with one process")
        for path in [one["logits"]] + [r["jobs"][tag]["logits"] for r in ranks]:
            os.remove(path)
    log(f"[space-eval] {smi}. Two ranks sharing one card measure correctness and the cost of "
        "the collectives, not scaling.")
    del models
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("space-eval: " + "; ".join(failed))
    return k7a


# ----------------------------------------------------------------------------
# The port's drivers of scripts/: the flagship learnability run, remat at
# scale and the whole-image batch probe.
E2E_STEPS = 300  # scripts/e2e_synthetic.py's recipe
REMAT_SCALE_BATCH, REMAT_SCALE_HW = 16, (769, 769)
REMAT_SCALE_MODES = ("False", "True", "conv12", "convs")
# the larger batch is chosen so that no remat needs >= (1 + margin) x the free
# memory and remat (True) <= (1 - margin) x it, by the bs-16 peaks per crop
REMAT_MARGIN = 0.10
DRIVER_TIMEOUT = 600  # seconds a driver's child process may take
WHOLE_BATCH_ARGMAX = 0.999  # B = 2 and 4 against B = 1, each image


def _driver(name: str):
    """``scripts/<name>.py`` as a module (``scripts/`` is not a package)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_e2e_synthetic(tmp: str) -> dict:
    """``scripts/e2e_synthetic_torch.py``'s ``run`` at the flagship recipe
    (CCNet R101 R=2 bf16, OHEM ``ohem_keep`` 30000, batch 8 of 353² crops of
    512×1024 ``LearnableDS`` images, E2E_STEPS steps, lr 5e-3, device
    augmentation), then the exported ``.pth`` through the sliding
    ``Evaluator`` and through the reference replica in f32: E2E_STEPS finite
    losses, the training's launches (K1–K4 at (8, 45, 45, 64/512), K5/K6 at
    (8, 45, 45, 19) → 353²) and the evaluation's, and held-out meanIU >
    0.5 through both (``require_bar``: else the plain route's run is raised
    beside it). Returns the launches of training and evaluation."""
    e2e = _driver("e2e_synthetic_torch")
    recipe = dict(depth=DEPTH, steps=E2E_STEPS, device="cuda", snap_dir=os.path.join(tmp, "e2e"))
    _reset_counts()
    r = e2e.run(**recipe)
    launches = _counts()
    losses = r["losses"]
    if len(losses) != E2E_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"e2e train losses {losses}")
    crop = (e2e.CROP, e2e.CROP)
    # R=2 attention calls forward and backward per step, the NLL of both heads
    want = _want(crop, 2 * E2E_STEPS, 2 * E2E_STEPS, 2 * E2E_STEPS)
    if r["train_launches"] != want:
        raise AssertionError(f"e2e training: expected launches {want}, got {r['train_launches']}")
    from ccnet_tpu_torch.evaluation import compute_tiles

    # each held-out image is predicted twice (Evaluator.run, predict_batch),
    # its tiles in chunks of 8, R=2 attention calls a chunk
    chunks = -(-len(compute_tiles(e2e.HW, crop)) // 8)
    want_eval = _want(crop, 2 * chunks * 2 * e2e.HELD_OUT)
    if r["eval_launches"] != want_eval:
        raise AssertionError(f"e2e evaluation: expected launches {want_eval}, got "
                             f"{r['eval_launches']}")
    e2e.require_bar(r, **recipe)
    log(f"[e2e-synthetic] held-out meanIU port {r['port_miou']:.4f}, replica "
        f"{r['replica_miou']:.4f}: both above the bar {e2e.MIN_MIOU}; launches as expected")
    torch.cuda.empty_cache()
    return launches


def _remat_child(batch: int, mode: str) -> dict:
    """One ``scripts/remat_scale_torch.py --batch batch --modes mode`` in a
    process of its own: its JSON line."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.join(here, "scripts", "remat_scale_torch.py"), "--batch",
           str(batch), "--hw", *map(str, REMAT_SCALE_HW), "--modes", mode]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=DRIVER_TIMEOUT, cwd=here)
    lines = [line for line in p.stdout.splitlines() if line.startswith("{")]
    if p.returncode or not lines:
        raise AssertionError(f"remat_scale_torch.py --batch {batch} --modes {mode} exited "
                             f"{p.returncode}: {p.stderr[-2000:]}")
    return json.loads(lines[-1])


def _remat_line(r: dict) -> str:
    state = (f"{r['s_per_step']:.4f} s/step, {r['crops_per_s']:.2f} crops/s" if r["ok"]
             else f"out of memory ({r['error'][:80]})")
    return (f"remat={r['mode']} bs {r['batch']}: {state}, peak {r['peak_bytes'] / 2**30:.2f} GiB"
            + (f" (held before the first step {r['held_bytes'] / 2**30:.2f})"
               if "held_bytes" in r else ""))


def phase_remat_scale() -> dict:
    """``scripts/remat_scale_torch.py`` (CCNet R101 R=2 bf16 OHEM, random
    769² batches), one child process per batch and mode, so that an OOM's
    fragments stay out of every other run's allocator: at REMAT_SCALE_BATCH
    every mode of REMAT_SCALE_MODES runs; then, at the smallest batch where
    no remat needs (1 + REMAT_MARGIN) x the card's free memory and remat
    (True) at most (1 - REMAT_MARGIN) x it, by this card's bs-16 peaks per
    crop, ``False`` runs out of memory while ``True`` runs. Each run that
    completes launched K1–K6 as its steps do. Returns the children's
    launches, summed."""
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    runs = [_remat_child(REMAT_SCALE_BATCH, m) for m in REMAT_SCALE_MODES]
    log("[remat-scale] " + "; ".join(_remat_line(r) for r in runs))
    if not all(r["ok"] for r in runs):
        raise AssertionError(f"remat-scale: a mode ran out of memory at bs {REMAT_SCALE_BATCH}")
    at = {r["mode"]: r for r in runs}

    def need(mode: str, batch: int) -> float:  # held + batch x this card's bytes per crop
        r = at[mode]
        return r["held_bytes"] + batch * (r["peak_bytes"] - r["held_bytes"]) / REMAT_SCALE_BATCH

    big = next(b for b in range(REMAT_SCALE_BATCH + 1, 1024)
               if need("False", b) >= (1 + REMAT_MARGIN) * free)
    log(f"[remat-scale] free memory {free / 2**30:.2f} of {total / 2**30:.2f} GiB; per crop "
        + ", ".join(f"{m} {(at[m]['peak_bytes'] - at[m]['held_bytes']) / REMAT_SCALE_BATCH / 2**30:.3f}"
                    for m in REMAT_SCALE_MODES)
        + f" GiB; the larger batch {big}: no remat needs {need('False', big) / 2**30:.2f} GiB, "
        f"remat {need('True', big) / 2**30:.2f} GiB (margin {REMAT_MARGIN:.0%} on both sides)")
    if need("True", big) > (1 - REMAT_MARGIN) * free:
        raise AssertionError(f"remat-scale: no batch where no remat needs {1 + REMAT_MARGIN:g}x "
                             f"the free memory and remat at most {1 - REMAT_MARGIN:g}x")
    runs += [_remat_child(big, m) for m in ("False", "True")]
    log("[remat-scale] " + "; ".join(_remat_line(r) for r in runs[-2:]))
    if not (runs[-2]["oom"] and runs[-1]["ok"]):
        raise AssertionError(f"remat-scale at bs {big}: no remat {runs[-2]}, remat {runs[-1]}")
    script = _driver("remat_scale_torch")
    steps = script.WARM_STEPS + script.TIMED_STEPS
    want = {n: c for n, c in _want(REMAT_SCALE_HW, 2 * steps, 2 * steps, 2 * steps).items() if c}
    bad = [r for r in runs if r["ok"] and r["launches"] != want]
    if bad:
        raise AssertionError(f"remat-scale: expected launches {want}, got {bad[0]['launches']}")
    total_launches = {n: 0 for n in _counts()}
    for r in runs:
        for name, c in r["launches"].items():
            total_launches[name] += c
    return total_launches


def phase_whole_batch() -> dict:
    """``scripts/probe_whole_batch_torch.py``'s probe on the card: CCNet R101
    R=2 bf16 (seeded, ``gamma`` = 0.5) eval forward + ``predict_whole`` +
    argmax at B = 1, 2 and 4 over four 1024×2048 images (K7a at 129×257):
    every B fits, B = 2 and 4 give each image B = 1's argmax on at least
    WHOLE_BATCH_ARGMAX of its pixels, and the launches are K7a's, two per
    path and forward. Prints ms/batch and ms/img per B; returns the
    launches."""
    probe = _driver("probe_whole_batch_torch")
    _reset_counts()
    r = probe.probe("cuda")
    launches = _counts()
    batches = r["batches"]
    for B, b in batches.items():
        log(f"[whole-batch] B={B}: " + (f"out of memory: {b['oom']}" if "oom" in b else
            f"{b['ms_per_batch']:.2f} ms/batch, {b['ms_per_img']:.2f} ms/img (CUDA events, "
            f"{probe.REPS} passes over {len(b['agreement'])} images after a warm call); argmax "
            f"agreement with B=1 "
            + " ".join(f"{a:.6f}" for a in b["agreement"])))
    if any("oom" in b for b in batches.values()):
        raise AssertionError("whole-batch: a batch ran out of memory")
    if not all(a >= WHOLE_BATCH_ARGMAX for b in batches.values() for a in b["agreement"]):
        raise AssertionError(f"whole-batch: argmax agreement below {WHOLE_BATCH_ARGMAX}")
    want = _want(probe.HW, 2 * sum(b["forwards"] for b in batches.values()))
    if launches != want:
        raise AssertionError(f"whole-batch: expected launches {want}, got {launches}")
    torch.cuda.empty_cache()
    return launches


def _phase_seconds(name: str, phase, *args):
    """``phase(*args)``, its seconds logged."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run one kernel-route train step of CCNet, PSPNet and "
                             "DeepLabv3 under torch.profiler and print its top kernels by "
                             "device time")
    parser.add_argument("--ab", metavar="PARENT_DIR",
                        help="instead, time P1/P4 and cli.train --synthetic in the checkout "
                             "PARENT_DIR and in this one in turns (parent, this, this, parent)")
    parser.add_argument("--ddp-diagnostics", action="store_true",
                        help="instead, read phase_ddp_train's numbers with each planted fault "
                             "and profile one two-rank step")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-main"]:  # one rank of a torchrun launch below
        rank_main(argv[1:])
        return
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one H100")
    if args.ab:
        ab(args.ab)
        return
    if args.ddp_diagnostics:
        smi = phase_card()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            pth = os.path.join(tmp, "ccnet_r101_random.pth")
            random_pth("ccnet", pth)
            ddp_diagnostics(pth, tmp, smi)
        log(smi)
        return
    t_main = time.perf_counter()
    smi = phase_card()
    phase_build()
    report = phase_kernels()
    report.update(phase_bwd_kernels())
    report.update(phase_loss_kernels())
    phase_ohem()
    report.update(phase_line_kernels())
    report.update(phase_probes())
    probe_launches = phase_probe_cli()
    with tempfile.TemporaryDirectory() as tmp:
        pth = ccnet_pth = os.path.join(tmp, "ccnet_r101_random.pth")
        phase_model(pth)
        phase_train_step(pth, TRAIN_BATCH, (CROP, CROP), profile=args.profile)
        snap_769 = os.path.join(tmp, "snapshots")
        launches, trained = phase_train_main_path(pth, snap_769, TRAIN_BATCH, (CROP, CROP),
                                                  TRAIN_STEPS)
        trained_769 = trained
        phase_train_step(pth, FULL_FRAME_BATCH, FULL_FRAME)
        full_frame, _ = phase_train_main_path(pth, os.path.join(tmp, "snapshots_full"),
                                              FULL_FRAME_BATCH, FULL_FRAME, FULL_FRAME_STEPS)
        sliding = phase_main_path(trained, "sliding")
        whole = phase_main_path(trained, "whole")
        msflip = phase_main_path(trained, "msflip")
        heads = []
        for name in ("pspnet", "deeplabv3"):  # the heads without attention: K5/K6
            pth = os.path.join(tmp, f"{name}_r101_random.pth")
            random_pth(name, pth)
            phase_train_step(pth, TRAIN_BATCH, (CROP, CROP), name, profile=args.profile)
            head, trained = phase_train_main_path(pth, os.path.join(tmp, f"snapshots_{name}"),
                                                  TRAIN_BATCH, (CROP, CROP), HEAD_TRAIN_STEPS,
                                                  name)
            heads.append(head)
            phase_main_path(trained, "sliding-png", name)
        # the rest of the single-card surface
        voc_loss = phase_voc_loss_kernels()
        voc = phase_voc_e2e(tmp)
        predict = phase_predict(trained_769, tmp)
        phase_restore_dir(snap_769, TRAIN_STEPS)
        phase_native_train(ccnet_pth, tmp)
        phase_remat(ccnet_pth)
        phase_profiler(ccnet_pth, tmp)
        # data parallelism: two ranks on the one card, one rank over NCCL
        phase_ddp_train(ccnet_pth, tmp, smi)
        phase_ddp_nccl_one_rank(ccnet_pth, tmp)
        phase_ddp_eval(trained_769, tmp)
        # height-sharded whole-image inference: two ranks on the one card
        space_k7a = phase_space_eval(ccnet_pth, tmp, smi)
        # the port's drivers of scripts/: learnability, remat at scale, whole-image batches
        e2e = _phase_seconds("e2e-synthetic", phase_e2e_synthetic, tmp)
        remat_scale = _phase_seconds("remat-scale", phase_remat_scale)
        whole_batch = _phase_seconds("whole-batch", phase_whole_batch)
    # each kernel's launches in the main paths that run it: K1–K6 in the 769²
    # cli.train run (K1/K2 plus the sliding evaluation's, K5/K6 plus
    # full-frame, PSPNet's and DeepLabv3's cli.train), K7a in the --whole and
    # MS+flip evaluations and full-frame cli.train, K7b in full-frame
    # cli.train, P1–P5 in cli.probe
    for name in ("cca_fwd_col", "cca_fwd_row", "cca_fwd_col_tc", "cca_fwd_row_tc"):
        launches[name] += sliding[name]
    for name in ("upsampled_nll_fwd", "upsampled_nll_bwd"):
        launches[name] += full_frame[name] + sum(head[name] for head in heads)
    for name in ("cca_line_fwd", "cca_line_fwd_tc"):  # and the --space 2 ranks' (phase 24)
        launches[name] = whole[name] + msflip[name] + full_frame[name] + space_k7a[name]
    for name in ("cca_line_bwd", "cca_line_bwd_tc"):
        launches[name] = full_frame[name]
    # the VOC training (K1–K6 at 41x41, K5/K6 at 21 classes) and cli.predict
    # (K1/K2 sliding, K7a with --whole 1)
    for name in voc:
        launches[name] += voc[name] + predict[name]
    # the drivers: K1–K6 in the learnability run and the remat children, K7a
    # in the whole-image batches
    for name in launches:
        launches[name] += e2e[name] + remat_scale[name] + whole_batch[name]
    launches.update(probe_launches)
    kernels = [{"name": name, "route": "cuda", "source": f"ccnet_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                **{key: report[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "bound_by", "library_ms")},
                **{key: report[name][key] for key in ("design", "earlier_ms", "share", "tflops",
                                                      "device_us", "host_us")
                   if key in report[name]}}
               for name, source, replaces in KERNELS]
    for k in kernels:  # K1–K4, K7a/K7b: how many of the path's launches took the tensor cores
        if f"{k['name']}_tc" in launches:
            k["launches_tensor_core"] = launches[f"{k['name']}_tc"]
        if k["name"] in voc_loss:  # K5/K6 at the VOC shape (21 classes), beside the 769² row
            r = voc_loss[k["name"]]
            k["voc_321"] = {"shape": list(VOC_LOSS), "launches": voc[k["name"]],
                            **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                                       "bound_ms", "bound_by")}}
    log("[summary] kernel: ms / bound ms (share of bound) / plain ms / library ms")
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        r = report[k["name"]]
        log(f"[summary] {k['name']}: {k['ms']:.4f} / {k['bound_ms']:.4f} by {k['bound_by']} "
            f"({k['bound_ms'] / k['ms']:.1%}) / {k['plain_ms']:.4f} / {lib}; "
            f"{k['launches']} launches on its path; bound from {r['bound_bytes'] / 1e6:.2f} MB "
            f"(the port moves {r['port_bytes'] / 1e6:.2f} MB), {r['bound_flops'] / 1e9:.3f} GFLOP")
        if "voc_321" in k:
            v = k["voc_321"]
            log(f"[summary] {k['name']} at {tuple(VOC_LOSS)} (B, h, w, C, r): {v['ms']:.4f} / "
                f"{v['bound_ms']:.4f} by {v['bound_by']} ({v['bound_ms'] / v['ms']:.1%}) / "
                f"{v['plain_ms']:.4f} / none; {v['launches']} launches in the VOC training")
    log(f"[chip-smoke] every phase passed in {time.perf_counter() - t_main:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
