"""Chip smoke test of the PyTorch/CUDA port (cal_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds every CUDA kernel of the port from cal_tpu_torch/csrc (one nvcc
   per source, all at once);
2. kernel phase: on a real synthetic batch at the production shapes (B=128,
   N=256, H=128; 4 heads of 32 for GAT), holds each kernel (adjacency build,
   dual masked-GCN forward and backward, flash-GAT forward and backward)
   against its plain PyTorch twin on the card, in bf16 and f32, flash-GAT at
   dropout rate 0 and 0.2; every f32 backward also against torch.autograd of
   its forward twin; checks the dropout law (keep fraction, unbiased
   output); and times kernel, twin and (where one exists) a single PyTorch
   call computing the same function, with CUDA events on a cold L2, with
   the dual backward's device time by pass (torch.profiler);
3. for CausalGCN, then CausalGAT (hidden 128, 3 layers, bf16):
   a. serving: saves a seeded model with the port's checkpointer, drives
      ``cal_tpu_torch.main_syn --inference`` with the launch counters set to
      0 just before, and fails unless every kernel of the path launched;
      then checks the forward against the plain twins on the card (bf16) and
      against the CPU on a small f32 input;
   b. training: drives ``cal_tpu_torch.main_syn`` training (3 epochs,
      ``--save_model``) with the counters set to 0 just before, fails unless
      every kernel of the path launched (each backward the expected number
      of times), every epoch's loss is finite and the last epoch's is below
      the first's, then serves the saved checkpoint and fails unless its
      accuracies equal the checkpoint's;
   c. gradient check: one bf16 step's gradients at full width, kernels
      against the plain twins on the card (GAT with dropout on, one seed),
      and one f32 step on 16 graphs, card against CPU; then the device time
      of one warm bf16 train step by operator, eager and as a replay of
      its captured CUDA graph (``profile_train_step_captured``);
   d. captured epoch (``CAPTURE_CASES``: dense CausalGCN, CausalGAT and the
      GCN baseline; sparse CausalGCN, CausalGIN, CausalGAT and the GAT
      baseline; packed sparse CausalGCN on REDDIT-shaped threads, pad
      batches in its stacks; dense CausalGAT on REDDIT-shaped threads at N
      = 2,560, its convs on the edge kernel): the device-side epoch
      (``make_*_train_epoch``, the step captured as one CUDA graph) against
      the eager steps from one state for 3 epochs of the shuffled train
      batches; fails unless each non-synthetic-dense stack's batches differ
      in their heavy-chunk counts, parameters, BatchNorm statistics, Adam's
      moments and the epoch sums are bitwise equal and the launches agree
      (the graph's counted launches added per replay); both runs' epoch
      seconds, the staged bytes, the peak device memory; then the
      benchmark's configs 1 and 2 at their full timed windows
      (``bench_config`` lines, ms a step);
4. sparse layout (CausalGCN serving, ``--layout sparse``) on the canonical
   dataset size (data_num 2000: batches of 128 graphs at V = 31,744 nodes,
   E = 128,000 edges):
   a. kernel phase: on a real serving batch and on a batch of 128
      REDDIT-shaped threads (hubs of thousands of edges), holds the sender
      degree (K1), pair SpMM (K2), plain SpMM (K3) and pool (K4) kernels
      against their plain twins, bf16 and f32, and times kernel, twin and a
      PyTorch library call (torch.sparse.mm on a CSR of materialized
      coefficients, index_add_), cold L2;
   b. serving: saves a seeded model, drives ``main_syn --layout sparse
      --inference`` (the sweep through the eval epoch) with the counters at
      0 and fails unless K1 (the pair), the plain conv's degree, K2, K3 and
      K4 launched 1, 1, 1, 3 and 2 times per batch and no dense kernel
      launched; serves the
      checkpoint of the CausalGCN training run (3.b) through both layouts
      and fails unless their f32 eval counts are equal and their f32
      log-probs agree batch by batch (warm sparse and dense serving rates
      beside); checks the forward against the twins on
      the card (bf16) and against the CPU (f32, 16 graphs); the device time
      of one forward;
5. sparse CausalGCN training (``--layout sparse``) at the same size:
   a. kernel phase: on the same two batches, holds the backward kernels
      (K2T/K3T transposed SpMM, K5 SDDMM chain, K6 chain tail, K7 pool
      backward) against their plain twins, bf16 and f32, every f32 backward
      also against torch.autograd of the f32 forward twins, and times them
      beside a PyTorch library call where one exists;
   b. training: drives ``main_syn --layout sparse`` (3 epochs, data_num
      2000, ``--save_model``) with the counters at 0 and fails unless each
      backward kernel launched its per-step count (K7 2, K2T 1, K3T 3, K5 1,
      K6 1; the sender-sum passes run inside the K5/K6 launches), the forward
      kernels their per-batch counts over the training and eval batches, and
      no dense kernel; serves that checkpoint through both layouts (f32 eval
      counts equal);
   c. gradient check: one sparse step's gradients, bf16 kernels on the card
      against the plain twins on the CPU (with the gap of the twins run on
      the card, and per kernel wrapper the gap with it alone on its kernel
      and with all but it), f32 card against CPU, and f32 sparse against
      dense on the card for 3 weight seeds on each of 4 batches, with a
      seeded fault (every 32nd edge masked out) that must read above the
      limit; the device time of one warm sparse train step by operator,
      eager and captured (``profile_train_step_captured``);
6. sparse CausalGAT (``--model CausalGAT --layout sparse``) at the same size:
   a. kernel phase: on the same two batches, holds the row statistics (K8),
      the coefficient SpMM and its transposed mode (K9, K9T) and the SDDMM
      chain (K10) against their plain twins, bf16 and f32 features, at
      attention dropout 0 and 0.2 (same tolerance: the keep bits are one
      hash), the f32 aggregate's backward against autograd of the twins,
      the dropout law (K9's kept (edge, head) pairs equal to the hash's,
      their fraction within 0.002 of 0.8 over both batches), and times them
      beside PyTorch library calls (scatter_reduce_ amax + index_add_,
      torch.sparse.mm);
   b. serving: ``main_syn --model CausalGAT --layout sparse --inference``
      (launches per batch K1 1, K2 1, K4 2, K8 3, K9 3, no dense kernel),
      the dense CausalGAT checkpoint of 3.b through both layouts (f32 eval
      counts equal), the forward against the twins and the CPU;
   c. training: ``main_syn --model CausalGAT --layout sparse`` for 3 epochs
      (per step K2T, K5, K6 1, K7 2, K9T 3, K10 3; the forward kernels per
      training and eval batch), its checkpoint on both layouts;
   d. gradient check as 5.c, with attention dropout on for the bf16 and the
      f32 card-against-CPU steps; the device time of one sparse GAT step.
7. CausalGIN and the GCN/GIN/GAT baselines:
   a. kernel phase: on the same two batches, holds the coefficient SpMM
      (K11), its transposed mode (K11T) and the SDDMM (K12) against their
      plain twins, bf16 and f32 features, at coef = the edge mask (sparse
      GIN's) and a random coefficient on every edge, the f32 Function's
      backward against autograd of the twin, and times them beside
      torch.sparse.mm and torch.sparse.sampled_addmm;
   b. dense CausalGIN serving and training as 3.a-b (data_num 320);
   c. sparse CausalGIN at the canonical size: serving (launches per batch
      K1 1, K2 1, K4 2, K11 3, nothing dense), the dense checkpoint of 7.b
      through both layouts, 3 epochs of training (per step K2T, K5, K6 1, K7
      2, K11T 3, K12 never), its checkpoint on both layouts, the gradient
      check as 5.c (the bf16 kernels held against the twins on the card:
      GRAD_CONDITIONS) and the device time of one step;
   d. each baseline (GCN, GIN, GAT) trains one epoch through ``main_syn`` on
      the dense and the sparse layout, with exact launches (sparse GIN per
      step K11 3, K11T 3, K4 1, K7 1).

8. the real-data protocol on SYNREDDIT (2,000 REDDIT-BINARY-shaped threads,
   written by ``benchmarks.gen_reddit_synthetic`` in a subprocess), dense
   layout, N = 3,840:
   a. kernel phase: on its first batch of 128 graphs, builds the batch's
      edge index (timed on a line of its own, held against its plain
      build), holds the edge-formulated GAT forward and backward
      (``csrc/edge_gat.cu``, ``edge_gat_bwd.cu``) against their twins, bf16
      and f32, at dropout 0 and 0.2, over the index and without it, the f32
      backward against autograd of the forward twin, and the keep bits bit
      for bit on a probe batch; times them as a layer's step calls them
      beside the twins; times rows 1, 2 (split
      into its degree pass and aggregate) and 2b (handed the forward's
      statistics and live map, and alone) at this N, held against the twins
      on 8 graphs, the hand-over's bits against the backward alone;
   b. drives ``cal_tpu_torch.main_real --model CausalGAT --dataset SYNREDDIT
      --dtype bfloat16`` at full width for 2 folds of 2 epochs with the
      counters at 0: per forward one adjacency build, one dual conv and three
      edge forwards, per step one dual backward and three edge backwards, no
      flash; finite losses, the ``sydall`` line; epoch seconds, peak device
      memory; then emits a.'s rows 1, 2 and 2b lines with these launches,
      and the device time of one train step at N = 3,840, eager and
      captured;
   c. times flash against edge (forward plus backward, bf16, dropout 0.2,
      B = 128) at five (N, Eg') shapes beside the v5e rule's choice.

9. packed sparse batches and the benchmark entry point:
   a. (in the sparse kernel phase) row 12's kernels, K13 sender degree, K14
      coefficient SpMM, K14T its transposed mode, K15 SDDMM chain, K16 chain
      tail (``csrc/spmm.cu``), against their twins on the benchmark's
      config-4 graph (V = 8,192, E = 131,072) and on the REDDIT-shaped batch,
      bf16 and f32, ``negate`` both ways, timed beside torch.sparse.mm (K14,
      K14T); the three sparse batches' degree profiles (``csr_profile``),
      rows 9's K19/K19T/K20 and row 14 on the REDDIT batch too, the
      coefficient SpMM walk's REDDIT rows (``walk_rows``: K2-K19T beside
      bound and library call), a ``copy_`` floor of its bytes and the walk's
      ``sparse_digests`` on the serving and REDDIT batches;
   b. ``main_syn --model CausalGCN --layout sparse --pack_batches true`` at
      the canonical size for PACK_EPOCHS epochs and ``main_real --model
      CausalGCN --dataset SYNREDDIT --layout sparse`` ("auto" packs) for 2
      folds of 2 epochs, each with exact K1-K7 launches for the real batches
      of the replayed loaders (none for the padding batches);
   c. ``cal_tpu_torch.bench.main`` at BENCH_SCALE of its timed steps: its
      four lines in order, finite and positive, and one K13, K14, K14T, K15
      and K16 launch per config-4 kernel iteration; from its config 3,
      packed against worst-case-padded training on 256 REDDIT-shaped
      threads, in graphs/s.

10. the parity entry point and the last four TPU kernel rows:
   a. ``cal_tpu_torch.parity.main`` in this process at full size, every
      counter at 0 just before: benchmarks/parity_tpu.py's eleven sections,
      each kernel path against the port's plain reference on the card,
      forward and gradients; a failure ends the smoke.  Rows 3, 4 and 9 and
      K12 must launch there, their only run; K21 (row 14) has no run;
   b. rows 4 and 3 (K17/K17T, K18/K18B, ``csrc/fused_gcn.cu``) against their
      twins on the synthetic dense batch (B = 128, N = 256, H = 128), bf16 and
      f32, both ``negate``s, timed beside torch.bmm on a prebuilt normalized
      adjacency (row 4; bf16 on its one-launch cluster path), and K17/K17T
      once more on the two-pass path (B = 16, N = 640); row 9 (K19/K19T/K20,
      ``csrc/coo_spmm.cu``) at 4 heads of 32 and row 14 (K21) at 4 planes on
      the serving batch, timed beside torch.sparse.mm on a block-diagonal
      per-head CSR, a batched torch.sparse.sampled_addmm (K20) and
      scatter_reduce_ amax; then a digest of the dense masked-conv kernels'
      outputs (rows 2, 2b, 3, 3b, 4, 4-dx) on seeded inputs.

Prints one JSON line per result, then a ``{"kernels": [...]}`` line, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
CUDA or the package is missing, or when any check fails.

    python3 chip_smoke.py --digests

prints only the digest lines (dense, sparse, and the edge GAT's on the
first SYNREDDIT batch): run from the root of another tree of the port (a
copy of this file there), it gives that tree's bits for an A/B.

    python3 chip_smoke.py --rows

builds the kernels and runs the dense masked-GCN rows and K21 alone: the
ptxas report of the dense kernels and K21, row 2 (the dual forward) at N =
256 split into its degree pass and aggregate, rows 3 and 4 at N = 256 (and
K17/K17T two-pass at N = 640), K21 on the serving and REDDIT batches beside
scatter_reduce_ amax, the digests, and rows 1, 2 and 2b at N = 3,840 on the
first SYNREDDIT batch (2b with and without the forward's hand-over); from
another tree's root, for an A/B.

    python3 chip_smoke.py --edge

builds the kernels and runs rows 6 and 6b (the edge-formulated GAT,
``csrc/edge_gat.cu`` and ``edge_gat_bwd.cu``) alone on the first SYNREDDIT
batch: the ptxas report of the edge kernels, the per-batch edge index timed
on its own line (and held against its plain build), the forward and
backward held against their twins and timed in bf16 and f32 at dropout 0
and 0.2 as a layer's step calls them (over the batch's index, the backward
handed the forward's statistics), and the edge digests (whole outputs, and
the rows of nodes without a slot); from another tree's root, for an A/B.

    python3 chip_smoke.py --flash

builds the flash-GAT kernels (``csrc/flash_gat.cu``) and runs rows 5 and 5b
alone on the counts of the first dense test batch (B = 128, N = 256): the
ptxas report of every flash kernel instance, the forward and backward held
against their twins in bf16 and f32 at dropout 0 and 0.2 and timed at both
rates (cold L2; the warm split by kernel), and the flash digests (out, m,
den, dti, dtj, dxh); from another tree's root, for an A/B.

    python3 chip_smoke.py --epoch

builds the kernels and times the training paths alone: the eager
``profile_train_step`` and, where the tree captures that path,
``profile_train_step_captured`` of dense CausalGCN and CausalGAT (N =
256), of sparse CausalGCN, CausalGAT and CausalGIN on the canonical serving
batch, and of dense CausalGAT on the first SYNREDDIT batch (N = 3,840, the
edge kernel); ``main_real`` on SYNREDDIT (dense CausalGAT and packed sparse
CausalGCN, epoch seconds); the captured-epoch phase's cases the tree
supports; the benchmark's configs 1-3; from another tree's root
(``PYTHONPATH`` set to it), for an A/B.

    python3 chip_smoke.py --walk

builds the kernels and runs the coefficient SpMM walk alone: the ptxas
report of its instances and of spmm.cu's other kernels, each sparse batch's
degree profile and ``copy_`` floor, every sparse kernel held against its
twin and timed on the serving and REDDIT batches (row 12 also on config 4's
graph; K1 (its sums, with its deg / dis epilogue, and the plain conv's
degree), K13, K5, K6, K15, K16, K7, K12 and K20 with the warm device ms of
each kernel a call launches), the walk's rows by batch, both digest lines, and
two sparse CausalGCN ``profile_train_step`` lines; from another tree's
root, for an A/B.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, TEST_GRAPHS, H, LAYERS = 128, 256, 128, 3
DATA_NUM = 320            # test split = 8 * int(0.1 * DATA_NUM) = 256 graphs
TRAIN_EPOCHS = 3          # train split 896 graphs = 7 steps of 128 per epoch
SEED = 666
# Published dense peaks (NVIDIA data sheets): bytes/s, bf16 FLOP/s, f32 FLOP/s
# (f32 outside the tensor cores: the f32 paths keep full f32, no TF32).
PEAKS = {"H100 SXM": (3.35e12, 989e12, 67e12), "H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12), "H200": (4.8e12, 989e12, 67e12)}
# Kernel vs plain twin on the card.  adj: exact.  f32: the same f32 math with
# sums in another order and the approximate rsqrtf (2 ulp).  bf16: a norm
# entry can round to the neighbouring bf16 value when the f32 degree differs
# in its last bits (2^-8 of a norm <= 1, times |x| of a few), and the output
# is itself rounded to bf16 (2^-8 relative).
DUAL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1.6e-2)}   # (atol, rtol)
# Backward kernel vs its plain twin: the same reasons (m, g*dis and x*dis are
# rounded to bf16 at the same places, results cast once), on outputs of the
# same scale (|dx| <= ~3, |dsrc|, |ddst| <= ~10 on seeded N(0, 1) inputs).
DUAL_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1.6e-2)}
# flash-GAT kernels vs their plain twins: both run every step in f32 (the
# inputs are exact in f32 in either dtype), with sums over up to N = 256
# terms in another order and expf against PyTorch's exp (a few ulp each):
# out, m, den, dti and dtj (f32, of order 1-10) within 1e-4.  dxh is rounded
# to the input dtype: in bf16 a sum on the other side of a rounding boundary
# moves by one bf16 ulp (2^-7 relative at most).
FLASH_TOL = (1e-4, 1e-4)
FLASH_DXH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 8e-3)}
HEADS, GAT_RATE = 4, 0.2           # CausalGAT: 4 heads of H / 4, attention dropout
DROP_SEED = 0x9E3779B97F4A7C15     # the kernel phase's dropout seed (64 bits)
# The dropout law over the B*heads*N*N cells of one call (33.5 M at the
# production shapes, so the keep fraction's sd is 6.9e-5): keep fraction
# within 0.002 of 1 - rate; the output sum on |xh| with dropout within 0.02
# of the sum without (tests/test_pallas_gat.py test_dropout_keep_rate_is_unbiased).
KEEP_TOL, MEAN_TOL = 2e-3, 2e-2
# Whole-step gradients, all parameters as one vector: ||got - ref|| / ||ref||.
# bf16 kernels against the plain twins (same rounding contract; a result that
# crosses a bf16 rounding boundary moves by 2^-8 and propagates through five
# convs and BatchNorms); f32 card against CPU (sums in other orders).  Per
# tensor the relative error is reported, not held: a bias whose gradient is a
# sum that cancels (node_att_bias) has a large relative error at any dtype.
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Whole forward, log-probs: bf16 as in tests/test_torch_port_model.py (single
# bf16 ulps propagate through BatchNorm and the f32 readouts); f32 on a small
# input, card against CPU (cuBLAS and the CPU sum in other orders).
FWD_TOL = {"bfloat16": (5e-2, 5e-2), "float32": (1e-4, 1e-4)}
SPARSE_DATA_NUM = 2000    # canonical size: test split 1600 graphs, V 31,744, E 128,000
# Sparse kernels vs their twins (same rounding points, csrc/spmm.cu header).
# K1 degrees (f32 sums of sigmoids, another order, expf): rtol 1e-5.  K2/K3:
# f32 sums over up to thousands of edges (REDDIT hubs) in another order with
# fmaf; bf16 outputs rounded once, so one bf16 ulp (2^-7 relative at most)
# where the f32 sums straddle a rounding boundary.  K4: f32 sums of up to
# 3,800 rows in another order.
DEG_TOL = (1e-4, 1e-5)
SPARSE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 8e-3)}
POOL_TOL = (1e-3, 1e-4)
# Sparse backward kernels vs their twins (same rounding points, csrc/spmm.cu
# header).  K2T/K3T as K2/K3 (SPARSE_TOL).  K5/K6 outputs are f32: dot
# products of H terms and sums over a row's edges (thousands at a REDDIT
# hub) in another order with fmaf and expf, on values of order 10-100.  K7
# copies an f32 row and rounds it once: exact.
CHAIN_TOL = (1e-3, 1e-4)
# Whole-step gradients on the sparse layout.  bf16: the kernels on the card
# against the plain twins, both deterministic, so the gap does not move
# between runs.  sparse_grad_check's breakdown on an H100 read 1.50e-2
# (CausalGCN) and 2.39e-2 (CausalGAT, dropout on) against the twins on the
# CPU, where the twins themselves, run on the card, read 1.76e-2 and 2.23e-2
# against the CPU: the gap is the devices' f32 summation orders (cuBLAS,
# BatchNorm, index_add_) flipping bf16 roundings of [V, H] activations, which
# propagate through five convs and BatchNorms.  Each wrapper put alone on its
# kernel moves the gap by at most 1.9e-3 (K8; every GCN wrapper <= 1.1e-4, K3
# lowers it by 2.6e-3): rounding, no kernel error, where a broken kernel
# moves it by O(1).  So the twins' own card gap (2.2e-2) plus ~2e-3 for each
# of the few wrappers that move it: 3e-2.
SPARSE_GRAD_TOL_BF16 = 3e-2
# f32: sparse against dense on the card (the same math, sums in another
# order), held on every pair of LAYOUT_SEEDS (weights) x the first
# LAYOUT_BATCHES test batches, each limit a constant above the largest
# reading of correct kernels; a seeded fault, the sparse step with every
# 32nd edge masked out (what a kernel that skipped the last edge of each
# 32-edge group would compute), must read above it on the first pair.
LAYOUT_SEEDS, LAYOUT_BATCHES = (SEED, SEED + 1, SEED + 2), 4
# The sparse gradient checks by the conditioning of the model's gradients:
# condition -> (reference of the bf16 kernels, f32 sparse-against-dense
# limit).  Well conditioned (CausalGCN, CausalGAT): the twins on the CPU;
# the f32 gap read 2.8e-6 to 3.0e-4 over the 12 pairs on an H100 80GB HBM3
# (PERF.md section 6), so 1e-3.  A Linear feeding a BatchNorm an input of
# large mean (each GIN layer's lin1 on unnormalized neighbour sums of ReLU
# outputs):
# lin1's weight gradient carries mean(h) times sum_v dh_v, which is 0
# exactly and rounding noise in practice, so any change of summation order
# moves it.  There the plain twins themselves read 7.2e-2 (bf16) card
# against CPU, each kernel wrapper moving that by at most 2.5e-4, so the
# bf16 kernels are held against the twins on the same card in deterministic
# mode; the f32 gap read 3.8e-5 to 2.2e-3 over the 12 pairs, so 1e-2.
GRAD_CONDITIONS = {
    "well_conditioned": ("cpu_twins", 1e-3),
    "linear_into_batchnorm_on_sums": ("card_twins", 1e-2),
}
SPARSE_TRAIN_EPOCHS = 3
# Sparse GAT kernels vs their twins (same rounding points, csrc/gat_sparse.cu
# header: x in the model dtype, everything else f32, so one tolerance for
# both dtypes).  K8: m is a max of the same f32 values, den a sum of up to
# ~1,300 exp terms <= 1 in another order with expf.  K9/K9T: f32 outputs,
# sums over up to 1,323 edges (a REDDIT hub) in another order with fmaf.
# K10 as K5 (CHAIN_TOL).  Rate 0.2 at the same tolerances as rate 0: the
# keep bits are the same hash in kernel and twin.
GAT_STATS_TOL = (1e-5, 1e-5)
GAT_SPMM_TOL = (1e-4, 1e-4)
# Coefficient SpMM kernels vs their twins (same rounding points,
# csrc/coo_spmm.cu header: x and g read in their dtype, everything else f32,
# so one tolerance for both dtypes).  K11/K11T: f32 sums over up to 29,400
# edges (the padded run at V-1, random coefficients) in another order with
# fmaf; K12: dot products of H terms in another order.
COO_TOL = (1e-4, 1e-4)
BASELINE_EPOCHS = 1       # each baseline's short run, per layout
CAPTURE_EPOCHS = 3        # the captured-epoch phase: 3 epochs of 7 steps
# Its REDDIT-shaped cases: 384 threads (data/reddit_synthetic.py), 3 dense
# batches of 128 at N = 2,560 (the GAT convs on the edge kernel), or packed
# sparse batches (3 real and 1 pad an epoch).
CAPTURE_REDDIT_GRAPHS = 384
# (model, case) of the captured-epoch phase: "dense" / "sparse" the
# synthetic run's train batches, "sparse_packed" and "dense_edge" the
# REDDIT-shaped ones.
CAPTURE_CASES = (("CausalGCN", "dense"), ("CausalGAT", "dense"), ("GCN", "dense"),
                 ("CausalGCN", "sparse"), ("CausalGIN", "sparse"), ("CausalGAT", "sparse"),
                 ("GAT", "sparse"), ("CausalGCN", "sparse_packed"), ("CausalGAT", "dense_edge"))
# Real-data phase: main_real on SYNREDDIT at full width; only the fold and
# epoch counts are cut (the protocol runs 10 folds of 100 epochs).
REAL_FOLDS, REAL_EPOCHS = 2, 2
# Edge-formulated GAT kernels vs their twins (csrc/edge_gat.cu header: every
# step in f32, xh and g read in their dtype).  out and dxh: sums over a row's
# or a sender's slots (a SYNREDDIT hub holds ~2,000) in another order with
# expf and fmaf, of order 1 (f32: 1e-4); in bf16 rounded once, so one bf16
# ulp (2^-7 relative) where a sum straddles a rounding boundary.  dti, dtj:
# f32 sums of the same slots' dpre, values of order 10-100 at a hub, as K5's
# (CHAIN_TOL).  Rate 0.2 at the same tolerances: the keep bits are one
# Philox stream in kernel and twin (checked bit for bit on a probe batch).
EDGE_X_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 8e-3)}
EDGE_T_TOL = CHAIN_TOL
# Flash against edge, (N, Eg' edges per graph): the shapes cal_tpu's v5e
# sweep bracketed (N = 256 with sparse and denser graphs, the switch at 384,
# a mid size) and SYNREDDIT's N = 3,840 with its largest graph's 8,752 edges.
SWEEP_SHAPES = ((256, 512), (256, 1408), (384, 1152), (1024, 3072), (3840, 8752))
# Packed sparse batches (phase 9): main_syn's packed run and the benchmark's
# share of its timed steps (warm-ups kept); row 12's kernels are held at the
# tolerances of the pair kernels whose rounding points they share (K13 as
# K1: DEG_TOL; K14/K14T as K2: SPARSE_TOL; K15/K16 as K5/K6: CHAIN_TOL).
PACK_EPOCHS = 2
BENCH_SCALE = 0.25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def peaks_for(name: str):
    for key in ("H200", "PCIe", "NVL"):
        if key in name:
            return next(v for k, v in PEAKS.items() if key in k), key
    return PEAKS["H100 SXM"], "H100 SXM"


def time_ms(torch, fn, flush, reps=30, warmup=3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``, each after a write
    of a buffer larger than L2 (inputs come from device memory).  A short
    device-side sleep ahead of the start event keeps the card busy while the
    host enqueues ``fn``, so the host's launch cost is not timed."""
    sleep = getattr(torch.cuda, "_sleep", None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if sleep is not None:
            sleep(1_000_000)            # ~0.5 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def live_cells(batch) -> int:
    """sum over the batch's graphs of n_b^2: the (receiver, sender) cells of
    real nodes.  The dense masked-GCN backward skips the m tiles without an
    edge, so the products this run's data needs are over these cells."""
    return int((batch.n_nodes.long() ** 2).sum())


def max_excess(torch, got, ref, atol, rtol):
    """(max |got - ref|, max of |got - ref| - (atol + rtol |ref|))."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    return float(err.max()), float((err - (atol + rtol * ref.abs())).max())


def kernel_phase(torch, batch, peaks, flush):
    from cal_tpu_torch.ops.adj_build import adj_build, adj_build_plain
    from cal_tpu_torch.ops.fused_gcn import (
        fused_gcn_dense_att_dual, fused_gcn_dense_att_dual_bwd,
        fused_gcn_dense_att_dual_bwd_plain, fused_gcn_dense_att_dual_plain)

    bw, bf16_peak, f32_peak = peaks
    ef = batch.edge_flat
    bsz, n, _ = batch.x.shape
    e = ef.shape[0]
    ef64 = ef.long()
    results = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        adj_k = adj_build(ef, bsz, n, dt)
        adj_p = adj_build_plain(ef, bsz, n, dt)
        torch.cuda.synchronize()
        check(torch.equal(adj_k, adj_p), f"adj_build {dt_name} differs from its plain twin")
        a_bytes = e * ef.element_size() + bsz * n * n * elt
        adj = {
            "name": "adj_build", "dtype": dt_name, "max_abs_err": 0.0,
            "kernel_ms": time_ms(torch, lambda: adj_build(ef, bsz, n, dt), flush),
            "plain_ms": time_ms(torch, lambda: adj_build_plain(ef, bsz, n, dt), flush),
            "library_ms": time_ms(
                torch, lambda: torch.bincount(ef64, minlength=bsz * n * n + 1), flush),
            "library_call": "torch.bincount(edge_flat.long(), minlength=B*N*N+1)",
            "bytes": a_bytes, "flops": 0,
            "bound_ms": a_bytes / bw * 1e3, "bound_by": "bytes",
            "edges": e, "real_edges": int((ef < bsz * n * n).sum()),
        }
        emit({"phase": "kernel", **adj})

        gen = torch.Generator(device="cuda").manual_seed(SEED)
        xc = torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt)
        xo = torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt)
        src = torch.randn((bsz, n), generator=gen, device="cuda").to(dt)
        dst = (2.0 * torch.randn((bsz, n), generator=gen, device="cuda")).to(dt)
        args = (xc, xo, adj_k, src, dst)
        oc_k, oo_k = fused_gcn_dense_att_dual(*args)
        oc_p, oo_p = fused_gcn_dense_att_dual_plain(*args)
        torch.cuda.synchronize()
        atol, rtol = DUAL_TOL[dt_name]
        err_c, over_c = max_excess(torch, oc_k, oc_p, atol, rtol)
        err_o, over_o = max_excess(torch, oo_k, oo_p, atol, rtol)
        check(bool(torch.isfinite(oc_k.float()).all() and torch.isfinite(oo_k.float()).all()),
              f"dual forward {dt_name} not finite")
        check(max(over_c, over_o) <= 0,
              f"dual forward {dt_name} differs from its plain twin: {err_c} {err_o}")
        d_bytes = (bsz * n * n + 4 * bsz * n * H + 2 * bsz * n) * elt
        d_flops = 2 * 2 * bsz * n * n * H
        t_bytes = d_bytes / bw
        t_ops = d_flops / (bf16_peak if dt == torch.bfloat16 else f32_peak)
        dual = {
            "name": "fused_gcn_dense_att_dual_fwd", "dtype": dt_name,
            "max_abs_err": max(err_c, err_o), "atol": atol, "rtol": rtol,
            "kernel_ms": time_ms(torch, lambda: fused_gcn_dense_att_dual(*args), flush),
            "plain_ms": time_ms(torch, lambda: fused_gcn_dense_att_dual_plain(*args), flush),
            "library_ms": None, "bytes": d_bytes, "flops": d_flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        emit({"phase": "kernel", **dual})

        gc = torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt)
        go = torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt)
        bargs = args + (gc, go)
        got = fused_gcn_dense_att_dual_bwd(*bargs)
        ref = fused_gcn_dense_att_dual_bwd_plain(*bargs)
        torch.cuda.synchronize()
        atol, rtol = DUAL_BWD_TOL[dt_name]
        errs = []
        for nm, a, r in zip(("dxc", "dxo", "dsrc", "ddst"), got, ref):
            check(bool(torch.isfinite(a.float()).all()), f"dual backward {dt_name} {nm} not finite")
            err, over = max_excess(torch, a, r, atol, rtol)
            check(over <= 0, f"dual backward {dt_name} {nm} differs from its plain twin: {err}")
            errs.append(err)
        extra = {}
        if dt == torch.float32:
            leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
            oc, oo = fused_gcn_dense_att_dual_plain(leaves[0], leaves[1], adj_k, leaves[2],
                                                    leaves[3])
            auto = torch.autograd.grad((oc * gc).sum() + (oo * go).sum(), leaves)
            auto_err = []
            for nm, a, r in zip(("dxc", "dxo", "dsrc", "ddst"), got, auto):
                err, over = max_excess(torch, a, r, atol, rtol)
                check(over <= 0, f"dual backward f32 {nm} differs from autograd: {err}")
                auto_err.append(err)
            extra["max_abs_err_vs_autograd"] = max(auto_err)
        b_bytes = (bsz * n * n + 6 * bsz * n * H + 4 * bsz * n) * elt
        b_flops = 3 * 2 * 2 * live_cells(batch) * H
        t_bytes = b_bytes / bw
        t_ops = b_flops / (bf16_peak if dt == torch.bfloat16 else f32_peak)
        bwd = {
            "name": "fused_gcn_dense_att_dual_bwd", "dtype": dt_name,
            "max_abs_err": max(errs), "atol": atol, "rtol": rtol, **extra,
            "kernel_ms": time_ms(torch, lambda: fused_gcn_dense_att_dual_bwd(*bargs), flush),
            "plain_ms": time_ms(torch, lambda: fused_gcn_dense_att_dual_bwd_plain(*bargs),
                                flush),
            "library_ms": None, "bytes": b_bytes, "flops": b_flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "passes": profile_passes(torch, lambda: fused_gcn_dense_att_dual_bwd(*bargs)),
        }
        emit({"phase": "kernel", **bwd})
        results[dt_name] = (adj, dual, bwd) + flash_kernels(torch, adj_k, dt_name, peaks, flush)
    return results


def flash_live_cells(torch, counts) -> int:
    """The cells a flash-GAT call must work on: ceff > 0 in the [B, N, N]
    counts plane, the analytic self loops included (one count for all
    heads)."""
    eye = torch.eye(counts.shape[-1], dtype=torch.bool, device=counts.device)
    return int(((counts > 0) | eye).sum())


def flash_inputs(torch, counts):
    """The seeded flash-GAT inputs over a counts plane: ti, tj (formed as
    flash_gat_dense_flat forms them), xh of the counts' dtype and the f32
    cotangent g."""
    dt = counts.dtype
    bsz, n, _ = counts.shape
    d = H // HEADS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    xh = torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt)
    att = (0.5 * torch.randn((HEADS, 2 * d), generator=gen, device="cuda")).to(dt).float()
    x4 = xh.float().view(bsz, n, HEADS, d)
    ti = torch.einsum("bnhd,hd->bnh", x4, att[:, :d])          # as flash_gat_dense_flat
    tj = torch.einsum("bnhd,hd->bnh", x4, att[:, d:])
    g = torch.randn((bsz, n, H), generator=gen, device="cuda")
    return ti, tj, xh, g


def flash_kernels(torch, counts, dt_name, peaks, flush, rates=(GAT_RATE,), split=False):
    """The flash-GAT forward and backward kernels against their twins at
    rate 0 and GAT_RATE, the f32 backward against autograd of the forward
    twin, the dropout law, and their rows, timed at each of ``rates``
    (GAT_RATE is the training path; the forward also at rate 0, the serving
    path).  The bound counts what a call must do: the bytes of every input
    and output once, the products on the live cells only (``live_cells``:
    ceff > 0, self loops included), 2 H a cell forward and 4 H backward.
    ``split``: each row also carries the warm device ms by kernel."""
    from cal_tpu_torch.ops.flash_gat import (
        dropout_keep, flash_gat_bwd, flash_gat_bwd_plain, flash_gat_fwd, flash_gat_fwd_plain)

    bw, bf16_peak, f32_peak = peaks
    dt = counts.dtype
    bsz, n, _ = counts.shape
    ti, tj, xh, g = flash_inputs(torch, counts)
    live = flash_live_cells(torch, counts)
    atol, rtol = FLASH_TOL
    errs = {"fwd": [], "bwd": []}
    stats_ref = {}
    for rate in (0.0, GAT_RATE):
        got = flash_gat_fwd(ti, tj, counts, xh, DROP_SEED, rate)
        ref = flash_gat_fwd_plain(ti, tj, counts, xh, DROP_SEED, rate)
        torch.cuda.synchronize()
        for nm, a, r in zip(("out", "m", "den"), got, ref):
            check(bool(torch.isfinite(a).all()), f"flash forward {dt_name} {nm} not finite")
            err, over = max_excess(torch, a, r, atol, rtol)
            check(over <= 0, f"flash forward {dt_name} rate {rate} {nm} differs from its "
                             f"plain twin: {err}")
            errs["fwd"].append(err)
        stats_ref[rate] = ref[1], ref[2]
        bgot = flash_gat_bwd(ti, tj, counts, xh, ref[1], ref[2], g, DROP_SEED, rate)
        bref = flash_gat_bwd_plain(ti, tj, counts, xh, ref[1], ref[2], g, DROP_SEED, rate)
        torch.cuda.synchronize()
        for nm, a, r in zip(("dti", "dtj", "dxh"), bgot, bref):
            tol = FLASH_DXH_TOL[dt_name] if nm == "dxh" else FLASH_TOL
            check(bool(torch.isfinite(a.float()).all()), f"flash backward {dt_name} {nm} not finite")
            err, over = max_excess(torch, a, r, *tol)
            check(over <= 0, f"flash backward {dt_name} rate {rate} {nm} differs from its "
                             f"plain twin: {err}")
            errs["bwd"].append(err)
    extra = {}
    if dt == torch.float32:
        leaves = [t.clone().requires_grad_() for t in (ti, tj, xh)]
        out, _, _ = flash_gat_fwd_plain(leaves[0], leaves[1], counts, leaves[2], DROP_SEED,
                                        GAT_RATE)
        auto = torch.autograd.grad((out * g).sum(), leaves)
        auto_err = []
        for nm, a, r in zip(("dti", "dtj", "dxh"), bgot, auto):
            err, over = max_excess(torch, a, r, atol, rtol)
            check(over <= 0, f"flash backward f32 {nm} differs from autograd: {err}")
            auto_err.append(err)
        extra["max_abs_err_vs_autograd"] = max(auto_err)
        del leaves, out, auto
    keep = float(dropout_keep(DROP_SEED, bsz, HEADS, n, GAT_RATE, "cuda").float().mean())
    xa = xh.abs()
    ratio = float(flash_gat_fwd(ti, tj, counts, xa, DROP_SEED, GAT_RATE)[0].sum()
                  / flash_gat_fwd(ti, tj, counts, xa)[0].sum())
    emit({"phase": "flash_dropout_law", "dtype": dt_name, "rate": GAT_RATE,
          "cells": bsz * HEADS * n * n, "keep_fraction": keep, "keep_tol": KEEP_TOL,
          "mean_ratio": ratio, "mean_tol": MEAN_TOL})
    check(abs(keep - (1.0 - GAT_RATE)) <= KEEP_TOL, f"keep fraction {keep}")
    check(abs(ratio - 1.0) <= MEAN_TOL, f"dropout output mean ratio {ratio}")

    elt = xh.element_size()
    peak = bf16_peak if dt == torch.bfloat16 else f32_peak
    stats = bsz * n * HEADS * 4                                  # one [B, N, heads] f32 plane
    none = ("none: no single PyTorch call computes the masked, multiplicity-weighted "
            "leaky-ReLU softmax and its dropout")
    rows = []
    for rate in rates:
        m, den = stats_ref[rate]
        for name, fn, plain, nbytes, flops, err in (
                ("flash_gat_fwd",
                 lambda: flash_gat_fwd(ti, tj, counts, xh, DROP_SEED, rate),
                 lambda: flash_gat_fwd_plain(ti, tj, counts, xh, DROP_SEED, rate),
                 4 * stats + bsz * n * n * elt + bsz * n * H * (elt + 4),
                 2 * live * H, max(errs["fwd"])),
                ("flash_gat_bwd",
                 lambda: flash_gat_bwd(ti, tj, counts, xh, m, den, g, DROP_SEED, rate),
                 lambda: flash_gat_bwd_plain(ti, tj, counts, xh, m, den, g, DROP_SEED, rate),
                 6 * stats + bsz * n * n * elt + bsz * n * H * (2 * elt + 4),
                 4 * live * H, max(errs["bwd"]))):
            t_bytes, t_ops = nbytes / bw, flops / peak
            row = {"name": name, "dtype": dt_name, "rate": rate, "max_abs_err": err,
                   "atol": atol, "rtol": rtol,
                   "kernel_ms": time_ms(torch, fn, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": None, "library_call": none, "bytes": nbytes, "flops": flops,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "live_cells": live, "cells": bsz * n * n, "root": HERE}
            if name == "flash_gat_fwd" and rate > 0:
                row["kernel_ms_rate0"] = time_ms(
                    torch, lambda: flash_gat_fwd(ti, tj, counts, xh), flush)
            elif name == "flash_gat_bwd":
                row.update(extra)
            if split:
                row["passes"] = profile_passes(torch, fn)
            emit({"phase": "kernel", **row})
            if rate == GAT_RATE:
                rows.append(row)
    return tuple(rows)


def flash_digests(torch, counts) -> dict:
    """sha256 of the flash-GAT kernels' outputs (out, m, den, dti, dtj, dxh)
    on ``flash_inputs`` over a counts plane, at dropout 0 and GAT_RATE; the
    backward is handed the plain twin's m and den, so its digests compare
    kernels on equal inputs.  Public calls only, so another tree's digests
    come from this function with its package (``--flash``)."""
    from cal_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd, flash_gat_fwd_plain

    dt_name = {torch.bfloat16: "bfloat16", torch.float32: "float32"}[counts.dtype]
    ti, tj, xh, g = flash_inputs(torch, counts)
    out = {}
    for rate in (0.0, GAT_RATE):
        fwd = flash_gat_fwd(ti, tj, counts, xh, DROP_SEED, rate)
        _, m, den = flash_gat_fwd_plain(ti, tj, counts, xh, DROP_SEED, rate)
        bwd = flash_gat_bwd(ti, tj, counts, xh, m, den, g, DROP_SEED, rate)
        for name, t in zip(("out", "m", "den", "dti", "dtj", "dxh"), (*fwd, *bwd)):
            out[f"flash_{name}_{dt_name}_{rate}"] = _digest([t])
    return out


def profile_passes(torch, fn, reps=3, tries=3):
    """Device ms a call of each kernel that ``fn`` launches (torch.profiler
    over ``reps`` warm calls), slowest first: a multi-pass kernel's split.
    The profiler can miss a window's first kernels, so ``ms_per_launch``
    (time over the launches it recorded) is the figure to read; a window
    in which it recorded none is taken again, up to ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for k, t, c in _device_rows(prof):
            m = re.search(r"\w+_kernel<[^>]*>", k)   # the kernel and its template arguments
            rows.append({"kernel": m.group(0) if m else k[:80], "device_ms": t / reps,
                         "calls": c / reps, "ms_per_launch": t / c})
        if rows:
            break
    return rows


def ptxas_kernels(log: str, names: str) -> dict:
    """{kernel instance: registers, spill bytes and static shared memory} of
    the functions whose mangled name matches ``names`` (an alternation of
    kernel names), from nvcc's ``-Xptxas -v`` log."""
    modes = {"0": "dual", "1": "sig", "2": "neg", "3": "plain", "4": "plain_t"}
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            k = re.search(r"\d+(" + names + r")I(13__nv_bfloat16|f)?(?:L([ib])(\d)E)?"
                          r"(?:Li(\d+)E)?", m.group(1))
            name = None
            if k:
                args = [] if k.group(2) is None else ["bf16" if k.group(2) != "f" else "f32"]
                if k.group(3) == "b":   # row 4's cluster kernel: transpose
                    args.append("K17T" if k.group(4) == "1" else "K17")
                elif k.group(3):
                    args.append(modes.get(k.group(4), k.group(4)))
                if k.group(5):          # the degree pass's load width
                    args.append(f"{k.group(5)} B")
                name = f"{k.group(1)}<{', '.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if name and m:
            out[name] = {"spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))}
        m = re.search(r"Used (\d+) registers", ln)
        if name and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def _device_rows(prof):
    """(kernel, device ms, calls), slowest first: device-side events only.
    Operator-level rows and user annotations (Adam's "Optimizer.step") would
    count their kernels' time a second time."""
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    return sorted(((e.key, dev(e) / 1e3, e.count) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and dev(e) > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])


def profile_forward(torch, model, batch, to_dense, top=16, layout="dense") -> None:
    """Device time of one warm bf16 forward (dense: adjacency build
    included), by operator, from torch.profiler; and its wall time on the
    host clock (median of 10, each ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    run = lambda: model(to_dense(batch, torch.bfloat16), eval_random=False)
    with torch.no_grad():
        walls = []
        for _ in range(12):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        fwd_ms = statistics.median(walls[2:])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    rows = _device_rows(prof)
    emit({"phase": "profile_forward", "model": model_name(model), "layout": layout,
          "batch": list(batch.x.shape), "wall_ms": fwd_ms,
          "device_ms": sum(r[1] for r in rows),
          "top": [{"op": k, "device_ms": t, "calls": c} for k, t, c in rows[:top]]})


def model_name(model) -> str:
    return {"gcn": "CausalGCN", "gin": "CausalGIN", "gat": "CausalGAT"}[model.backbone]


def counters(model: str, training: bool) -> tuple:
    """The launch-counted kernel wrappers of a model's serving or training
    path."""
    from cal_tpu_torch.ops.adj_build import adj_build
    from cal_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd
    from cal_tpu_torch.ops.fused_gcn import (
        fused_gcn_dense_att_dual, fused_gcn_dense_att_dual_bwd)

    ks = (adj_build, fused_gcn_dense_att_dual)
    if model == "CausalGAT":
        ks += (flash_gat_fwd,)
    if training:
        ks += (fused_gcn_dense_att_dual_bwd,)
        if model == "CausalGAT":
            ks += (flash_gat_bwd,)
    return ks


def plain_twins():
    """Patches that route every kernel wrapper of the forward and backward
    to its plain twin (on the card's tensors)."""
    import contextlib
    from unittest import mock

    import cal_tpu_torch.graph as graph_mod
    import cal_tpu_torch.ops.flash_gat as flash_mod
    import cal_tpu_torch.ops.fused_gcn as fused_mod
    from cal_tpu_torch.ops.adj_build import adj_build_plain

    stack = contextlib.ExitStack()
    # the forward wrapper also returns the degree statistics and the live
    # map that the autograd Function hands to the backward wrapper (the twins
    # have neither)
    for mod, name, plain in (
            (graph_mod, "adj_build", adj_build_plain),
            (fused_mod, "_dual_fwd",
             lambda *a: (fused_mod.fused_gcn_dense_att_dual_plain(*a), None, None)),
            (fused_mod, "fused_gcn_dense_att_dual_bwd",
             lambda *a: fused_mod.fused_gcn_dense_att_dual_bwd_plain(*a[:7])),
            (flash_mod, "flash_gat_fwd", flash_mod.flash_gat_fwd_plain),
            (flash_mod, "flash_gat_bwd", flash_mod.flash_gat_bwd_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def serving_phase(torch, test_set, model: str):
    import cal_tpu_torch.graph as graph_mod
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.main_syn import main
    from cal_tpu_torch.models.factory import get_model
    from cal_tpu_torch.train.causal import evaluate_causal
    from cal_tpu_torch.utils.checkpoint import Checkpointer
    from cal_tpu_torch.utils.config import Config

    save_dir = os.path.join(HERE, "build", f"chip_smoke_ckpt_{model}")
    argv = ["--model", model, "--inference", "true", "--save_dir", save_dir,
            "--data_num", str(DATA_NUM), "--seed", str(SEED), "--dtype", "bfloat16",
            "--hidden", str(H), "--layers", str(LAYERS), "--batch_size", str(B),
            "--device", "cuda"]
    cfg = Config(model=model, hidden=H, layers=LAYERS, batch_size=B,
                 dtype="bfloat16", seed=SEED)
    feat = test_set[0].x.shape[1]
    net = get_model(cfg, feat, cfg.num_classes)
    Checkpointer(save_dir).save(0, net, {"epoch": 0})

    kernels = counters(model, training=False)
    for k in kernels:
        k.launches = 0
    res = main(argv)
    launches = {k.__name__: k.launches for k in kernels}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the {model} serving path never launched: {launches}")
    emit({"phase": "serving", "model": model, "graphs": res["graphs"],
          "seconds": res["seconds"], "graphs_per_s": res["graphs"] / res["seconds"],
          "test_acc_co": res["test_acc_co"], "test_acc_c": res["test_acc_c"],
          "test_acc_o": res["test_acc_o"], "launches": launches,
          "hidden": H, "layers": LAYERS, "batch": B, "dtype": "bfloat16"})
    check(res["graphs"] == len(test_set), "serving sweep missed graphs")
    warm = evaluate_causal(test_set, Config(
        model=model, inference=True, save_dir=save_dir, data_num=DATA_NUM,
        seed=SEED, dtype="bfloat16", hidden=H, layers=LAYERS, batch_size=B,
        device="cuda"))
    t0 = time.perf_counter()
    loader = Loader(test_set, B)
    t1 = time.perf_counter()
    n_batches = sum(1 for _ in loader.host_batches())
    pack_s = time.perf_counter() - t1
    emit({"phase": "serving_warm", "model": model, "graphs": warm["graphs"],
          "seconds": warm["seconds"], "graphs_per_s": warm["graphs"] / warm["seconds"],
          "host_pack_ms_per_batch": pack_s / n_batches * 1e3,
          "loader_init_ms": (t1 - t0) * 1e3})

    # the same forward through the plain twins, on the card
    batch = next(Loader(test_set, B).host_batches()).to("cuda")
    net = net.to("cuda").eval()
    with torch.no_grad():
        g = graph_mod.to_dense(batch, torch.bfloat16)
        check(g.adj.shape[1] == 256, f"node budget {g.adj.shape[1]} != 256")
        out_k = net(g, eval_random=False)
        with plain_twins():
            out_p = net(graph_mod.to_dense(batch, torch.bfloat16), eval_random=False)
    profile_forward(torch, net, batch, graph_mod.to_dense)
    atol, rtol = FWD_TOL["bfloat16"]
    errs = []
    for a, b in zip(out_k, out_p):
        check(a.shape == (B, cfg.num_classes) and bool(torch.isfinite(a).all()),
              "serving log-probs not finite or misshapen")
        err, over = max_excess(torch, a, b, atol, rtol)
        check(over <= 0, f"{model} bf16 forward differs from the plain twins by {err}")
        errs.append(err)

    # small f32 input: card (kernels) against the CPU (plain twins)
    m32 = get_model(cfg.replace(dtype="float32"), feat, cfg.num_classes).eval()
    small = next(Loader(test_set[:16], 16).host_batches())
    with torch.no_grad():
        ref = m32(graph_mod.to_dense(small.to("cpu"), torch.float32), eval_random=False)
        got = m32.to("cuda")(graph_mod.to_dense(small.to("cuda"), torch.float32),
                             eval_random=False)
    atol32, rtol32 = FWD_TOL["float32"]
    errs32 = []
    for a, b in zip(got, ref):
        err, over = max_excess(torch, a.cpu(), b, atol32, rtol32)
        check(over <= 0, f"{model} f32 forward on the card differs from the CPU by {err}")
        errs32.append(err)
    emit({"phase": "forward_check", "model": model, "bf16_vs_plain_max_abs_err": max(errs),
          "bf16_tol": [atol, rtol], "f32_card_vs_cpu_max_abs_err": max(errs32),
          "f32_tol": [atol32, rtol32], "f32_graphs": 16})
    return launches


def training_phase(torch, model: str) -> dict:
    """Train through ``main_syn`` with the counters at 0, then serve the
    checkpoint it saved.  Returns the training run's launch counts."""
    import shutil

    from cal_tpu_torch.main_syn import main
    from cal_tpu_torch.models.factory import get_model
    from cal_tpu_torch.ops.edge_gat import edge_gat_bwd, edge_gat_fwd
    from cal_tpu_torch.utils.checkpoint import Checkpointer
    from cal_tpu_torch.utils.config import Config

    save_dir = os.path.join(HERE, "build", f"chip_smoke_train_{model}")
    shutil.rmtree(save_dir, ignore_errors=True)
    common = ["--model", model, "--dtype", "bfloat16", "--hidden", str(H),
              "--layers", str(LAYERS), "--batch_size", str(B), "--data_num", str(DATA_NUM),
              "--seed", str(SEED), "--save_dir", save_dir, "--device", "cuda"]
    kernels = counters(model, training=True)
    for k in kernels + (edge_gat_fwd, edge_gat_bwd):
        k.launches = 0
    res = main(common + ["--epochs", str(TRAIN_EPOCHS), "--save_model", "true"])
    launches = {k.__name__: k.launches for k in kernels}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the {model} training path never launched: {launches}")
    # N = 256 lies below the edge kernel's switch: flash only
    check(edge_gat_fwd.launches == edge_gat_bwd.launches == 0,
          f"the edge-formulated GAT kernel launched at N = 256 ({model})")
    steps = res["steps_per_epoch"] * TRAIN_EPOCHS
    check(launches["fused_gcn_dense_att_dual_bwd"] == steps,
          f"{launches['fused_gcn_dense_att_dual_bwd']} dual backward launches for {steps} steps")
    if model == "CausalGAT":
        check(launches["flash_gat_bwd"] == LAYERS * steps,
              f"{launches['flash_gat_bwd']} flash backward launches for {steps} steps")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_EPOCHS and all(map(math.isfinite, losses)),
          f"{model} training losses {losses}")
    check(losses[-1] < losses[0], f"{model} training loss did not fall: {losses}")
    warm = hist[1:]
    train_s = sum(h["train_seconds"] for h in warm)
    emit({"phase": "training", "model": model, "epochs": TRAIN_EPOCHS, "losses": losses,
          "epoch_seconds": [h["seconds"] for h in hist],
          "train_seconds": [h["train_seconds"] for h in hist],
          "train_graphs": res["train_graphs"], "steps_per_epoch": res["steps_per_epoch"],
          "train_graphs_per_s_warm": res["train_graphs"] * len(warm) / train_s,
          "steps_per_s_warm": res["steps_per_epoch"] * len(warm) / train_s,
          "best_epoch": res["epoch"], "best_val_acc": res["best_val_acc"],
          "test_acc_co": res["test_acc_co"], "test_acc_c": res["test_acc_c"],
          "test_acc_o": res["test_acc_o"], "launches": launches,
          "hidden": H, "layers": LAYERS, "batch": B, "dtype": "bfloat16"})

    cfg = Config(model=model, hidden=H, layers=LAYERS, dtype="bfloat16")
    meta = Checkpointer(save_dir).restore(get_model(cfg, 10, cfg.num_classes))
    served = main(common + ["--inference", "true"])
    for k in ("test_acc_co", "test_acc_c", "test_acc_o"):
        check(served[k] == meta[k], f"{model} served {k} {served[k]} != checkpoint's {meta[k]}")
    emit({"phase": "train_then_serve", "model": model, "ckpt_epoch": meta["epoch"],
          "test_acc": [served[k] for k in ("test_acc_co", "test_acc_c", "test_acc_o")]})
    return launches


def _step_grads(torch, model, g, seeds=None):
    """Gradients of one train-mode loss on the device graph ``g`` (dense or
    sparse; no intervention shuffle, no update; ``seeds`` turn the GAT
    layers' dropout on)."""
    from cal_tpu_torch.train.losses import causal_losses

    model.zero_grad(set_to_none=True)
    c, o, co = model(g, eval_random=False, train=True, dropout_seeds=seeds)
    total, _ = causal_losses(c, o, co, g.y, g.graph_mask, 0.5, 1.0, 0.5)
    total.backward()
    return float(total.detach()), {n: p.grad.detach().float().cpu().clone()
                          for n, p in model.named_parameters() if p.grad is not None}


def _rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| over all gradients as one vector."""
    check(got.keys() == ref.keys(), "gradient sets differ")
    diff = math.sqrt(sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref))
    return diff / math.sqrt(sum(float((ref[n] ** 2).sum()) for n in ref))


def _grad_err(torch, got, ref, tol):
    """Relative L2 error of all gradients as one vector (held to ``tol``
    unless it is None: the caller holds it after reporting), and the tensor
    with the largest max|got - ref| / max|ref| (reported)."""
    check(all(bool(torch.isfinite(g).all()) for g in got.values()), "gradient not finite")
    rel = _rel_l2(got, ref)
    worst = max((float((got[n] - ref[n]).abs().max()) / max(float(ref[n].abs().max()), 1e-30), n)
                for n in ref)
    if tol is not None:
        check(rel <= tol, f"step gradients differ by {rel} (relative L2)")
    return rel, worst


def _ulp_probe(torch, model, g, ref, seeds=None) -> float:
    """The relative L2 gap that random 1-ulp noise on every f32 weight of
    ``model`` opens in the step gradients on ``g`` (``ref``: the gradients
    without noise): the gradients' own conditioning on this batch."""
    import copy

    noisy = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for p in noisy.parameters():
            sign = torch.randint(0, 2, p.shape, generator=gen).to(p.device) * 2 - 1
            p.mul_(1.0 + sign * 2.0 ** -23)
    return _rel_l2(_step_grads(torch, noisy, g, seeds)[1], ref)


def _err_shares(got, ref, top=6) -> list:
    """The tensors holding most of ||got - ref||^2: (name, share of the
    squared error, ||ref[name]||^2 / ||ref||^2), largest share first."""
    err = {n: float(((got[n] - ref[n]) ** 2).sum()) for n in ref}
    norm = {n: float((ref[n] ** 2).sum()) for n in ref}
    e_tot, r_tot = sum(err.values()) or 1.0, sum(norm.values()) or 1.0
    return [(n, err[n] / e_tot, norm[n] / r_tot)
            for n in sorted(err, key=lambda k: -err[k])[:top]]


def grad_check(torch, test_set, batch, model: str):
    """bf16 at full width: kernels against the plain twins (forward and
    backward; CausalGAT with dropout on, the same seeds), on the card.  f32
    on 16 graphs, dropout off: card against CPU."""
    import copy

    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.graph import to_dense
    from cal_tpu_torch.models.factory import get_model
    from cal_tpu_torch.train.steps import dropout_seeds
    from cal_tpu_torch.utils.config import Config

    cfg = Config(model=model, hidden=H, layers=LAYERS, dtype="bfloat16", seed=SEED)
    feat = test_set[0].x.shape[1]
    net = get_model(cfg, feat, cfg.num_classes).to("cuda")
    seeds = dropout_seeds(net, SEED, 0)
    loss_k, grads_k = _step_grads(torch, net, to_dense(batch, torch.bfloat16), seeds)
    with plain_twins():
        loss_p, grads_p = _step_grads(torch, net, to_dense(batch, torch.bfloat16), seeds)
    bf16 = _grad_err(torch, grads_k, grads_p, GRAD_TOL["bfloat16"])

    m32 = get_model(cfg.replace(dtype="float32"), feat, cfg.num_classes)
    small = next(Loader(test_set[:16], 16).host_batches())
    loss_cpu, grads_cpu = _step_grads(torch, copy.deepcopy(m32),
                                      to_dense(small.to("cpu"), torch.float32))
    loss_gpu, grads_gpu = _step_grads(torch, m32.to("cuda"),
                                      to_dense(small.to("cuda"), torch.float32))
    f32 = _grad_err(torch, grads_gpu, grads_cpu, GRAD_TOL["float32"])
    emit({"phase": "grad_check", "model": model, "bf16_dropout": seeds is not None,
          "bf16_loss_kernels": loss_k, "bf16_loss_plain": loss_p,
          "bf16_rel_l2_err": bf16[0], "bf16_worst_tensor": bf16[1],
          "bf16_tol": GRAD_TOL["bfloat16"], "f32_loss_card": loss_gpu, "f32_loss_cpu": loss_cpu,
          "f32_rel_l2_err": f32[0], "f32_worst_tensor": f32[1],
          "f32_tol": GRAD_TOL["float32"], "params": len(grads_k), "f32_graphs": 16})


def profile_train_step(torch, test_set, host, model: str, top=20, layout="dense") -> None:
    """Device time of one warm bf16 train step (dense: adjacency build
    included; forward, backward, Adam) on the host batch ``host``, by
    operator, from torch.profiler; and its wall time on the host clock
    (median of 10, each ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    from cal_tpu_torch.train.optim import cosine_lr
    from cal_tpu_torch.train.steps import init_state, make_causal_train_step
    from cal_tpu_torch.utils.config import Config

    cfg = Config(model=model, hidden=H, layers=LAYERS, dtype="bfloat16", seed=SEED)
    state = init_state(cfg, test_set[0].x.shape[1], cfg.num_classes, torch.device("cuda"))
    step = make_causal_train_step(state, cosine_lr(cfg.lr, cfg.min_lr, 100, 10),
                                  cfg.c, cfg.o, cfg.co, cfg.with_random, cfg.seed)
    walls = []
    for _ in range(12):
        t0 = time.perf_counter()
        step(host, None)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(host, None)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    emit({"phase": "profile_train_step", "model": model, "layout": layout,
          "batch": list(host.x.shape),
          "wall_ms": statistics.median(walls[2:]),
          "device_ms": sum(r[1] for r in rows), "kernels": sum(r[2] for r in rows),
          "top": [{"op": k, "device_ms": t, "calls": c} for k, t, c in rows[:top]]})

def _dense_train_split(cfg):
    """The dense synthetic run's train loader (``make_loaders``: budgets over
    the three splits, the trainer's shuffle) and its graphs."""
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
    from cal_tpu_torch.train.causal import make_loaders

    ds = generate_synthetic_dataset(data_num=cfg.data_num, seed=cfg.seed)
    train, val, test, _ = dataset_bias_split(ds, bias=cfg.bias, total=cfg.data_num * 4,
                                             seed=cfg.seed)
    return make_loaders(train, val, test, cfg)[0], train


def _state_gap(a, b) -> dict:
    """Largest |a - b| over two train states' parameters, buffers (the
    BatchNorm statistics) and Adam moments, each group apart."""
    gap = lambda xs, ys: max((float((x.detach().float() - y.detach().float()).abs().max())
                              for x, y in zip(xs, ys)), default=0.0)
    moments = lambda st: [t for s in st.optimizer.state.values() for t in s.values()]
    return {"params": gap(a.model.parameters(), b.model.parameters()),
            "buffers": gap(a.model.buffers(), b.model.buffers()),
            "adam": gap(moments(a), moments(b))}


def _capture_loader(model: str, case: str):
    """(cfg, train loader, feature width) of a captured-epoch case: the
    synthetic run's shuffled train loader on the case's layout
    (``make_loaders``, budgets over the three splits), or a shuffled loader
    of CAPTURE_REDDIT_GRAPHS REDDIT-shaped threads, packed sparse or dense."""
    from cal_tpu_torch.data.loader import Loader, compute_budgets
    from cal_tpu_torch.data.reddit_synthetic import reddit_graphs
    from cal_tpu_torch.utils.config import Config

    layout = "sparse" if case.startswith("sparse") else "dense"
    cfg = Config(model=model, hidden=H, layers=LAYERS, batch_size=B, dtype="bfloat16",
                 seed=SEED, data_num=DATA_NUM, device="cuda", epochs=100, layout=layout)
    if case in ("dense", "sparse"):
        loader, train = _dense_train_split(cfg)
        return cfg, loader, train[0].x.shape[1]
    graphs = reddit_graphs(CAPTURE_REDDIT_GRAPHS, seed=SEED, feat=10)
    budgets = compute_budgets(graphs, B, layout, pack=layout == "sparse")
    loader = Loader(graphs, B, shuffle=True, budgets=budgets, seed=SEED, layout=layout)
    return cfg, loader, graphs[0].x.shape[1]


def _heavy_counts(torch, stacked) -> list:
    """Each step's heavy-chunk counts: both CSRs' of a sparse stack, the edge
    index's heavy receiver and sender lists of a dense one (the edge GAT's
    walk; built on the card), as (receiver, sender) pairs."""
    from cal_tpu_torch.graph import GraphBatch
    from cal_tpu_torch.ops.edge_gat import EdgeIndex

    b = stacked.batch
    if isinstance(b, GraphBatch):
        return list(zip(b.recv.heavy_count[:, 0].tolist(), b.send.heavy_count[:, 0].tolist()))
    bsz, n = b.x.shape[1:3]
    out = []
    for s in range(stacked.steps):
        counts = EdgeIndex(b.edge_flat[s], bsz, n).build().counts.tolist()
        out.append((counts[1], counts[3]))
    return out


def captured_epoch_phase(torch, model: str, case: str = "dense") -> dict:
    """The device-side epoch against the per-step loop from one state: two
    copies of a fresh ``model`` (bf16, H 128, 3 layers, B 128) train
    CAPTURE_EPOCHS epochs of one case's shuffled batches (``_capture_loader``;
    staged on the card once), one through ``step.on_device`` batch by batch
    (eager, int dropout seeds), one through ``make_*_train_epoch`` (the
    first step eager, the second captured, every later one a replay; the
    dropout seeds from the epoch's seed table on the card), with the
    counters at 0 before each.  A packed epoch's pad batches are skipped by
    both.  Fails unless each stack's batches differ in their heavy-chunk
    counts (a count frozen at the capture would show), the parameters, the
    BatchNorm statistics, Adam's moments and every epoch's sums are bitwise
    equal, and the kernels launched as often in both; prints both runs'
    epoch seconds, the staged bytes and the peak device memory."""
    from cal_tpu_torch.graph import to_dense
    from cal_tpu_torch.models.factory import BASELINES
    from cal_tpu_torch.nn.layers import takes_edge_kernel
    from cal_tpu_torch.train import steps as st
    from cal_tpu_torch.train.optim import cosine_lr

    cfg, loader, feat = _capture_loader(model, case)
    stacks = [st.ship(st.stack_batches_host(list(loader.host_batches())), torch.device("cuda"))
              for _ in range(CAPTURE_EPOCHS)]
    staged = sum(t.numel() * t.element_size() for t in stacks[0].leaves())
    heavy = [_heavy_counts(torch, stacked) for stacked in stacks]
    pads = sum(int((~stacked.real).sum()) for stacked in stacks)
    if case != "dense":
        check(all(len(set(h)) > 1 for h in heavy),
              f"{model} {case}: a stack's batches share their heavy-chunk counts {heavy}")
    if case == "sparse_packed":
        check(pads > 0, f"{model} {case}: no pad batch in the stacks")
    if case == "dense_edge":
        probe = to_dense(stacks[0].at(0), torch.bfloat16)
        check(takes_edge_kernel(probe, probe.x.shape[1]),
              f"{model} {case}: batch {tuple(probe.x.shape)} not on the edge kernel")
        del probe
    baseline = model in BASELINES
    schedule = cosine_lr(cfg.lr, cfg.min_lr, cfg.epochs, loader.schedule_steps)
    counts = all_counters()
    runs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kind in ("eager", "captured"):
        state = st.init_state(cfg, feat, cfg.num_classes, torch.device("cuda"))
        if baseline:
            step = st.make_baseline_train_step(state, schedule, cfg.seed)
            epoch_fn = st.make_baseline_train_epoch(state, schedule, cfg.seed)
        else:
            args = (state, schedule, cfg.c, cfg.o, cfg.co, cfg.with_random, cfg.seed)
            step, epoch_fn = st.make_causal_train_step(*args), st.make_causal_train_epoch(*args)
        for k in counts.values():
            k.launches = 0
        sums, secs = [], []
        for stacked in stacks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "captured":
                m = epoch_fn(stacked)
            else:
                m = None
                for s in range(stacked.steps):
                    if stacked.real[s]:
                        m = step.on_device(stacked.at(s), m)
            sums.append(m.tolist())
            secs.append(time.perf_counter() - t0)
        runs[kind] = {"state": state, "sums": sums, "seconds": secs,
                      "launches": {n: k.launches for n, k in counts.items() if k.launches},
                      "replays": getattr(getattr(epoch_fn, "call", None), "replays", 0)}
    peak = torch.cuda.max_memory_allocated()
    eager, cap = runs["eager"], runs["captured"]
    gap = _state_gap(eager["state"], cap["state"])
    sums_gap = max(abs(a - b) for x, y in zip(eager["sums"], cap["sums"]) for a, b in zip(x, y))
    steps = sum(int(stacked.real.sum()) for stacked in stacks)
    first = int(stacks[0].real.sum())
    emit({"phase": "captured_epoch", "model": model, "case": case, "layout": cfg.layout,
          "epochs": CAPTURE_EPOCHS, "steps": steps, "pad_steps": pads,
          "replays": cap["replays"], "max_abs_diff": {**gap, "sums": sums_gap},
          "heavy_counts": heavy, "batch_shape": list(stacks[0].batch.x.shape[1:]),
          "staged_bytes_per_epoch": staged, "peak_device_memory_gb": peak / 1e9,
          "eager_epoch_seconds": eager["seconds"], "captured_epoch_seconds": cap["seconds"],
          "eager_ms_per_step_warm": sum(eager["seconds"][1:]) / (steps - first) * 1e3,
          "captured_ms_per_step_warm": sum(cap["seconds"][1:]) / (steps - first) * 1e3,
          "launches_eager": eager["launches"], "launches_captured": cap["launches"],
          "hidden": H, "layers": LAYERS, "batch": B, "dtype": "bfloat16"})
    # the first step runs eagerly, every later one is a replay
    check(cap["replays"] == steps - 1, f"{cap['replays']} replays for {steps} steps")
    check(eager["launches"] == cap["launches"],
          f"captured launches {cap['launches']} != eager {eager['launches']}")
    check(max(gap.values()) == 0.0 and sums_gap == 0.0 and eager["sums"] == cap["sums"],
          f"{model} {case}: the captured epoch differs from the eager steps: {gap}, "
          f"sums {sums_gap}")
    return cap["launches"]


def profile_captured_step(torch, test_set, host, model: str, top=20, layout="dense") -> None:
    """``profile_train_step`` for the captured step: a stack of the one host
    batch (either layout) through ``make_causal_train_epoch`` (its first
    call eager, its second captured), then the wall time of one replay
    (median of 10, each with its batch copy-in and ending in a synchronize)
    and its device time by kernel from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from cal_tpu_torch.train.optim import cosine_lr
    from cal_tpu_torch.train.steps import (
        init_state, make_causal_train_epoch, ship, stack_batches_host)
    from cal_tpu_torch.utils.config import Config

    cfg = Config(model=model, hidden=H, layers=LAYERS, dtype="bfloat16", seed=SEED)
    state = init_state(cfg, test_set[0].x.shape[1], cfg.num_classes, torch.device("cuda"))
    epoch = make_causal_train_epoch(state, cosine_lr(cfg.lr, cfg.min_lr, 100, 10),
                                    cfg.c, cfg.o, cfg.co, cfg.with_random, cfg.seed)
    stacked = ship(stack_batches_host([host]), torch.device("cuda"))
    walls = []
    for _ in range(12):
        t0 = time.perf_counter()
        epoch(stacked)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(stacked)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    emit({"phase": "profile_train_step_captured", "model": model, "layout": layout,
          "batch": list(host.x.shape), "replays": epoch.call.replays,
          "wall_ms": statistics.median(walls[2:]),
          "device_ms": sum(r[1] for r in rows), "kernels": sum(r[2] for r in rows),
          "top": [{"op": k, "device_ms": t, "calls": c} for k, t, c in rows[:top]]})


def bench_configs_12(torch) -> None:
    """The benchmark's configs 1 and 2 (dense CausalGCN and CausalGAT
    training on its staged batches) at their full timed windows, in ms a
    step; the tree's own ``bench_causal_train`` (the captured epoch where
    the tree has it, else its per-step loop)."""
    from cal_tpu_torch import bench

    cfg, batches, edges = bench._train_workload()
    cfg = cfg.replace(device="cuda")
    for metric, model, target in (("causal_train_edges_per_s", "CausalGCN", 400),
                                  ("causal_gat_train_edges_per_s", "CausalGAT", 200)):
        r = bench.bench_causal_train(model, cfg, batches, edges, target)
        emit({"phase": "bench_config", "metric": metric, "model": model, "root": HERE,
              "edges_per_s": r["edges_per_s"], "ms_per_step": r["seconds"] / r["steps"] * 1e3,
              "steps": r["steps"], "steps_per_call": r.get("steps_per_call"),
              "batches": len(batches)})


def bench_config_3(torch) -> None:
    """The benchmark's config 3 (packed sparse CausalGCN on 256
    REDDIT-shaped threads, against the worst-case budgets) at its full timed
    window, in ms a step and graphs/s; the tree's own ``bench_sparse_pack``
    (the captured epoch where the tree has it for the sparse layout, else
    the per-step loop)."""
    from cal_tpu_torch import bench

    cfg = bench._train_workload()[0].replace(device="cuda")
    r = bench.bench_sparse_pack(cfg)
    worst = r.pop("worst")
    keys = ("edges_per_s", "graphs_per_s", "steps", "seconds", "batches", "budgets")
    emit({"phase": "bench_config", "metric": "sparse_pack_train_edges_per_s",
          "model": "CausalGCN", "root": HERE, "edges_per_s": r["edges_per_s"],
          "ms_per_step": r["seconds"] / r["steps"] * 1e3, "steps": r["steps"],
          "steps_per_call": r.get("steps_per_call"), "graphs_per_s": r["graphs_per_s"],
          "speedup_vs_worst": r["speedup_vs_worst_case_padding"],
          "worst": {k: worst[k] for k in keys}})


def real_epochs(torch, root, model: str, layout: str) -> None:
    """``main_real --dataset SYNREDDIT`` (REAL_FOLDS folds of REAL_EPOCHS
    epochs, bf16, full width) on ``layout`` (sparse: "auto" packs), with the
    tree's default ``--scan_epochs``: its epoch and train seconds and the
    peak device memory (the full run holds its launches)."""
    import contextlib
    import io

    from cal_tpu_torch.main_real import main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = main(["--model", model, "--dataset", "SYNREDDIT", "--layout", layout, "--dtype",
                    "bfloat16", "--folds", str(REAL_FOLDS), "--epochs", str(REAL_EPOCHS),
                    "--data_root", root, "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    hist = res["history"]
    emit({"phase": "real_epochs", "model": model, "layout": layout, "root": HERE,
          "folds": REAL_FOLDS, "epochs": REAL_EPOCHS, "wall_s": time.perf_counter() - t0,
          "epoch_seconds": [h["seconds"] for h in hist],
          "train_seconds": [h["train_seconds"] for h in hist],
          "losses": [h["loss"] for h in hist],
          "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9})


def serving_rates(torch, test_set, repeats: int = 3) -> None:
    """The serving sweep of ``main_syn --inference`` (``evaluate_causal``
    on a checkpoint of random weights from SEED, bf16, full width) over
    ``test_set`` for CausalGCN and CausalGAT on both layouts, ``repeats``
    sweeps each under the tree's ``--scan_epochs`` default and under
    ``--scan_epochs false`` (the per-batch loop): graphs/s of every sweep,
    the first included (a captured sweep pays its capture in each)."""
    import contextlib
    import io

    from cal_tpu_torch.models.factory import get_model
    from cal_tpu_torch.train.causal import evaluate_causal
    from cal_tpu_torch.utils.checkpoint import Checkpointer
    from cal_tpu_torch.utils.config import Config

    feat = test_set[0].x.shape[1]
    for model in ("CausalGCN", "CausalGAT"):
        save_dir = os.path.join(HERE, "build", f"chip_smoke_ckpt_serving_{model}")
        cfg = Config(model=model, hidden=H, layers=LAYERS, batch_size=B, dtype="bfloat16",
                     seed=SEED, inference=True, save_dir=save_dir, device="cuda")
        Checkpointer(save_dir).save(0, get_model(cfg, feat, cfg.num_classes), {"epoch": 0})
        for layout in ("dense", "sparse"):
            for scan in (cfg.scan_epochs, False):
                with contextlib.redirect_stdout(io.StringIO()):
                    runs = [evaluate_causal(test_set, cfg.replace(layout=layout,
                                                                  scan_epochs=scan))
                            for _ in range(repeats)]
                emit({"phase": "serving_rate", "model": model, "layout": layout,
                      "scan_epochs": scan, "root": HERE, "graphs": runs[0]["graphs"],
                      "graphs_per_s": [r["graphs"] / r["seconds"] for r in runs],
                      "test_acc_co": [r["test_acc_co"] for r in runs]})


def _csr_coefs(torch, g, src, dst, deg, dis):
    """Per-edge coefficients of the sparse convs (dead edges 0), for the
    library calls: [pair c, pair o] with logits, [plain] without."""
    s, r = g.senders.long(), g.receivers.long()
    live = (g.edge_mask & (s != r)).float()
    if src is None:
        return [dis[0][s] * dis[0][r] * live]
    sig = torch.sigmoid(src.float()[s] + dst.float()[r])
    return [dis[0][s] * sig * dis[0][r] * live, dis[1][s] * (1.0 - sig) * dis[1][r] * live]


def _library_spmm(torch, g, coefs, xs):
    """One torch.sparse.mm over a block-diagonal CSR of the materialized
    coefficients (one block per branch) and the stacked features; the CSR
    and the stacking are built outside the timed call."""
    v = g.num_nodes
    nnz = g.senders.shape[0]
    crow = torch.cat([g.recv.ptr[:-1] + k * nnz for k in range(len(xs))]
                     + [g.recv.ptr[-1:] + (len(xs) - 1) * nnz])
    col = torch.cat([g.senders + k * v for k in range(len(xs))])
    x = torch.cat(xs)
    a = torch.sparse_csr_tensor(crow, col, torch.cat(coefs).to(x.dtype),
                                size=(len(xs) * v, len(xs) * v))
    return lambda: torch.sparse.mm(a, x)


def degree_calls(spmm):
    """(K1 as the pair aggregate takes it, (src, dst, g) -> (deg, dis); the
    plain conv's degree, g -> (deg, dis)) of the tree whose ``ops.spmm`` is
    given: its wrappers where it has them, else the operations that tree's
    aggregates run for them (K1's sums, + 1 and torch.rsqrt; 2 x K1 at zero
    logits + 1 and torch.rsqrt), so that an A/B times what each tree's
    forward launches."""
    import torch

    if hasattr(spmm, "plain_sender_degree"):
        return (lambda src, dst, g: spmm.pair_sender_degree(src, dst, g, norm=True),
                spmm.plain_sender_degree)

    def pair(src, dst, g):
        deg = spmm.pair_sender_degree(src, dst, g) + 1.0
        return deg, torch.rsqrt(deg)

    def plain(g):
        deg = 2.0 * spmm.pair_sender_degree(None, None, g)[:1] + 1.0
        return deg, torch.rsqrt(deg)

    return pair, plain


def sparse_kernel_rows(torch, g, label, peaks, flush):
    """K1-K4 and the plain conv's degree against their twins on one sparse
    batch ``g`` (on the card), in bf16 and f32, with their times (K1's sums,
    K1 with its deg / dis epilogue as the pair aggregate takes it, the
    plain conv's degree and K4 each with the warm device ms of each kernel a
    call launches, ``passes``; K4 with the cold time of one
    ``torch.sum(x, 0, dtype=torch.float32)`` of the same x, a library
    reduction over all of x and no floor: the batch's ``fill_floor`` line is
    the floor of x's bytes); returns {dtype: {kernel: row}}."""
    from cal_tpu_torch.ops import spmm
    from cal_tpu_torch.ops.pool import segment_pool, segment_pool_plain
    from cal_tpu_torch.ops.spmm import (
        coef_spmm_plain, pair_coef_spmm, pair_sender_degree, pair_sender_degree_plain,
        plain_coef_spmm)

    pair_norm, plain_degree = degree_calls(spmm)

    bw, _, f32_peak = peaks
    v, e = g.num_nodes, g.senders.shape[0]
    n_live = int((g.edge_mask & (g.senders != g.receivers)).sum())
    g1 = g.num_graphs + 1
    csr = lambda c: 4 * (2 * (v + 1) + c.num_chunks)          # ptr, chunk_ptr, chunk_row
    s64 = g.senders.long()
    live32 = (g.edge_mask & (g.senders != g.receivers)).float()
    zcount = torch.zeros(v, device="cuda")
    out = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        xc = torch.randn((v, H), generator=gen, device="cuda").to(dt)
        xo = torch.randn((v, H), generator=gen, device="cuda").to(dt)
        src = torch.randn(v, generator=gen, device="cuda").to(dt)
        dst = (2.0 * torch.randn(v, generator=gen, device="cuda")).to(dt)
        rows = {}

        def row(name, fn, plain, nbytes, flops, err, tol, lib_fn=None, lib_call=None,
                **extra):
            t_bytes, t_ops = nbytes / bw, flops / f32_peak
            r = {"name": name, "batch": label, "dtype": dt_name, "max_abs_err": err,
                 "atol": tol[0], "rtol": tol[1],
                 "kernel_ms": time_ms(torch, fn, flush), "plain_ms": time_ms(torch, plain, flush),
                 "library_ms": None if lib_fn is None else time_ms(torch, lib_fn, flush),
                 "library_call": lib_call, "bytes": nbytes, "flops": flops,
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "nodes": v, "edges": e, "live_edges": n_live, **extra}
            if name in ("pair_sender_degree", "pair_sender_degree_norm", "plain_sender_degree",
                        "segment_pool"):
                r["passes"] = profile_passes(torch, fn)
            emit({"phase": "sparse_kernel", **r})
            rows[name] = r

        def held(name, got, ref, tol):
            got, ref = (got,) if torch.is_tensor(got) else got, (ref,) if torch.is_tensor(ref) else ref
            torch.cuda.synchronize()
            errs = []
            for a, b in zip(got, ref, strict=True):
                check(a.dtype == b.dtype and a.shape == b.shape, f"{name} {dt_name} misshapen")
                check(bool(torch.isfinite(a.float()).all()), f"{name} {dt_name} on {label} not finite")
                err, over = max_excess(torch, a, b, *tol)
                check(over <= 0, f"{name} {dt_name} on {label} differs from its plain twin: {err}")
                errs.append(err)
            return max(errs)

        # K1: its sums at the pair logits and at zero logits; with its deg /
        # dis epilogue (bit for bit the sums + 1 and torch.rsqrt); the plain
        # conv's degree (a count: exact)
        degs = pair_sender_degree(src, dst, g)
        err = held("pair_sender_degree", degs, pair_sender_degree_plain(src, dst, g), DEG_TOL)
        zero = pair_sender_degree(None, None, g)
        held("pair_sender_degree", zero, pair_sender_degree_plain(None, None, g), (0.0, 0.0))
        row("pair_sender_degree", lambda: pair_sender_degree(src, dst, g),
            lambda: pair_sender_degree_plain(src, dst, g),
            2 * v * elt + 9 * e + csr(g.send) + 2 * v * 4, 4 * n_live, err, DEG_TOL,
            None, "none: no single PyTorch call computes the sigmoid-weighted sender sums")

        def norm_twin():
            d = pair_sender_degree_plain(src, dst, g) + 1.0
            return d, torch.rsqrt(d)

        def plain_twin():
            d = 2.0 * pair_sender_degree_plain(None, None, g)[:1] + 1.0
            return d, torch.rsqrt(d)

        deg, dis = pair_norm(src, dst, g)
        check(torch.equal(deg, degs + 1.0) and torch.equal(dis, torch.rsqrt(degs + 1.0)),
              f"K1's deg / dis {dt_name} on {label} differ from its sums + 1 and torch.rsqrt")
        err = held("pair_sender_degree_norm", (deg, dis), norm_twin(), DEG_TOL)
        row("pair_sender_degree_norm", lambda: pair_norm(src, dst, g), norm_twin,
            2 * v * elt + 9 * e + csr(g.send) + 4 * v * 4, 4 * n_live + 4 * v, err, DEG_TOL,
            None, "none: no single PyTorch call computes the sigmoid-weighted sender sums")
        pdeg, pdis = plain_degree(g)
        err = held("plain_sender_degree", (pdeg, pdis), plain_twin(), (0.0, 0.0))
        row("plain_sender_degree", lambda: plain_degree(g), plain_twin,
            9 * e + csr(g.send) + 2 * v * 4, n_live + 2 * v, err, (0.0, 0.0),
            lambda: zcount.index_add_(0, s64, live32),
            "counts.index_add_(0, senders, live) into a preallocated f32 out (no 1 + "
            "and rsqrt)")

        tol = SPARSE_TOL[dt_name]
        err = held("pair_coef_spmm", pair_coef_spmm(xc, xo, src, dst, deg, dis, g),
                   tuple(coef_spmm_plain([xc, xo], src, dst, deg, dis, g)), tol)
        lib = _library_spmm(torch, g, _csr_coefs(torch, g, src, dst, deg, dis), [xc, xo])
        row("pair_coef_spmm", lambda: pair_coef_spmm(xc, xo, src, dst, deg, dis, g),
            lambda: coef_spmm_plain([xc, xo], src, dst, deg, dis, g),
            4 * v * H * elt + 2 * v * elt + 5 * e + csr(g.recv) + 4 * v * 4,
            2 * 2 * H * n_live, err, tol, lib,
            "torch.sparse.mm(block-diagonal CSR [2V, 2V], [xc; xo]), coefficients "
            "materialized outside the call, no self term")

        err = held("plain_coef_spmm", plain_coef_spmm(xc, pdeg, pdis, g),
                   coef_spmm_plain([xc], None, None, pdeg, pdis, g)[0], tol)
        lib = _library_spmm(torch, g, _csr_coefs(torch, g, None, None, pdeg, pdis), [xc])
        row("plain_coef_spmm", lambda: plain_coef_spmm(xc, pdeg, pdis, g),
            lambda: coef_spmm_plain([xc], None, None, pdeg, pdis, g),
            2 * v * H * elt + 5 * e + csr(g.recv) + 2 * v * 4, 2 * H * n_live, err, tol, lib,
            "torch.sparse.mm(CSR [V, V], x), coefficients materialized outside the "
            "call, no self term")

        ng = g.node_graph
        err = held("segment_pool", segment_pool(xc, ng, g1), segment_pool_plain(xc, ng, g1),
                   POOL_TOL)
        pooled = torch.zeros((g1, H), device="cuda")
        ng64, x32 = ng.long(), xc.float()
        row("segment_pool", lambda: segment_pool(xc, ng, g1),
            lambda: segment_pool_plain(xc, ng, g1), v * H * elt + 4 * v + g1 * H * 4,
            v * H, err, POOL_TOL, lambda: pooled.index_add_(0, ng64, x32),
            "out.index_add_(0, node_graph, x.float()) into a preallocated f32 out",
            sum_dim0_ms=time_ms(torch, lambda: torch.sum(xc, 0, dtype=torch.float32), flush),
            sum_dim0_call="torch.sum(x, 0, dtype=torch.float32)")
        out[dt_name] = rows
    return out


def _twin_table() -> dict:
    """Every sparse kernel wrapper, forward and backward: label -> (module,
    attribute, plain twin).  The autograd Functions look the wrappers up at
    call time, so patching the attribute routes a step through the twin."""
    import cal_tpu_torch.ops.coo_spmm as coo_mod
    import cal_tpu_torch.ops.gat_sparse as gat_mod
    import cal_tpu_torch.ops.pool as pool_mod
    import cal_tpu_torch.ops.spmm as spmm_mod

    plain = spmm_mod.coef_spmm_plain
    return {
        "K1": (spmm_mod, "pair_sender_degree", spmm_mod.pair_sender_degree_plain),
        "K1P": (spmm_mod, "plain_sender_degree", spmm_mod.plain_sender_degree_plain),
        "K2": (spmm_mod, "pair_coef_spmm",
               lambda xc, xo, src, dst, deg, dis, g: tuple(plain([xc, xo], src, dst, deg, dis, g))),
        "K3": (spmm_mod, "plain_coef_spmm",
               lambda x, deg, dis, g: plain([x], None, None, deg, dis, g)[0]),
        "K2T": (spmm_mod, "pair_coef_spmm_t",
                lambda gc, go, src, dst, deg, dis, g: tuple(
                    plain([gc, go], src, dst, deg, dis, g, transpose=True))),
        "K3T": (spmm_mod, "plain_coef_spmm_t",
                lambda gx, deg, dis, g: plain([gx], None, None, deg, dis, g, transpose=True)[0]),
        "K5": (spmm_mod, "pair_sddmm_chain", spmm_mod.pair_sddmm_chain_plain),
        "K6": (spmm_mod, "pair_dpre", spmm_mod.pair_dpre_plain),
        "K4": (pool_mod, "_pool_fwd", pool_mod.segment_pool_plain),
        "K7": (pool_mod, "segment_pool_bwd", pool_mod.segment_pool_bwd_plain),
        "K8": (gat_mod, "gat_row_stats", gat_mod.gat_row_stats_plain),
        "K9": (gat_mod, "gat_coef_spmm", gat_mod.gat_coef_spmm_plain),
        "K9T": (gat_mod, "gat_coef_spmm_t",
                lambda *a: gat_mod.gat_coef_spmm_plain(*a, transpose=True)),
        "K10": (gat_mod, "gat_sddmm_chain", gat_mod.gat_sddmm_chain_plain),
        "K11": (coo_mod, "coo_spmm", coo_mod.coo_spmm_plain),
        "K11T": (coo_mod, "coo_spmm_t", coo_mod.coo_spmm_t_plain),
        "K12": (coo_mod, "coo_sddmm", coo_mod.coo_sddmm_plain),
    }


def sparse_twins(labels=None):
    """Patches that route the sparse kernel wrappers named by ``labels``
    (all of them when None) to their plain twins."""
    import contextlib
    from unittest import mock

    stack = contextlib.ExitStack()
    for label, (mod, name, fn) in _twin_table().items():
        if labels is None or label in labels:
            stack.enter_context(mock.patch.object(mod, name, fn))
    return stack


def sparse_counters(training: bool = False) -> dict:
    """Launch counters of the sparse serving or training path of any model
    (and the dense kernels, which it must not launch)."""
    from cal_tpu_torch.ops import coo_spmm, gat_sparse, spmm
    from cal_tpu_torch.ops.adj_build import adj_build
    from cal_tpu_torch.ops.edge_gat import edge_gat_bwd, edge_gat_fwd
    from cal_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd
    from cal_tpu_torch.ops.fused_gcn import fused_gcn_dense_att_dual, fused_gcn_dense_att_dual_bwd
    from cal_tpu_torch.ops.pool import segment_pool, segment_pool_bwd

    ks = {"pair_sender_degree": spmm.pair_sender_degree,
          "plain_sender_degree": spmm.plain_sender_degree, "pair_coef_spmm": spmm.pair_coef_spmm,
          "plain_coef_spmm": spmm.plain_coef_spmm, "segment_pool": segment_pool,
          "gat_row_stats": gat_sparse.gat_row_stats, "gat_coef_spmm": gat_sparse.gat_coef_spmm,
          "coo_spmm": coo_spmm.coo_spmm, "adj_build": adj_build, "fused_gcn_dense_att_dual": fused_gcn_dense_att_dual,
          "flash_gat_fwd": flash_gat_fwd, "edge_gat_fwd": edge_gat_fwd}
    if training:
        ks.update(pair_coef_spmm_t=spmm.pair_coef_spmm_t,
                  plain_coef_spmm_t=spmm.plain_coef_spmm_t,
                  pair_sddmm_chain=spmm.pair_sddmm_chain, pair_dpre=spmm.pair_dpre,
                  segment_pool_bwd=segment_pool_bwd,
                  gat_coef_spmm_t=gat_sparse.gat_coef_spmm_t,
                  gat_sddmm_chain=gat_sparse.gat_sddmm_chain,
                  coo_spmm_t=coo_spmm.coo_spmm_t, coo_sddmm=coo_spmm.coo_sddmm,
                  fused_gcn_dense_att_dual_bwd=fused_gcn_dense_att_dual_bwd,
                  flash_gat_bwd=flash_gat_bwd, edge_gat_bwd=edge_gat_bwd)
    return ks


def sparse_want(model: str, fwd: int, steps: int | None = None) -> dict:
    """Exact launches of ``sparse_counters`` for ``fwd`` forwards (eval
    batches and train steps) and ``steps`` backwards (None: serving).  Per
    forward: K1 1 (the pair), K2 1; CausalGCN the plain conv's degree 1
    (each forward computes it once from its own batch) and K3 3, CausalGAT
    K8 and K9 one per layer, CausalGIN K11 one per layer; all K4 2.  Per
    backward: K2T, K5, K6 1, K7 2; CausalGCN K3T 3, CausalGAT K9T and K10
    one per layer, CausalGIN K11T one per layer (K12 never: GIN's
    coefficient, the edge mask, needs no gradient).  No dense kernel."""
    gat, gin = model == "CausalGAT", model == "CausalGIN"
    want = {"pair_sender_degree": fwd, "pair_coef_spmm": fwd,
            "plain_sender_degree": 0 if gat or gin else fwd,
            "plain_coef_spmm": 0 if gat or gin else 3 * fwd, "segment_pool": 2 * fwd,
            "gat_row_stats": LAYERS * fwd if gat else 0,
            "gat_coef_spmm": LAYERS * fwd if gat else 0,
            "coo_spmm": LAYERS * fwd if gin else 0,
            "adj_build": 0, "fused_gcn_dense_att_dual": 0, "flash_gat_fwd": 0,
            "edge_gat_fwd": 0}
    if steps is not None:
        want.update(pair_coef_spmm_t=steps,
                    plain_coef_spmm_t=0 if gat or gin else 3 * steps,
                    pair_sddmm_chain=steps, pair_dpre=steps, segment_pool_bwd=2 * steps,
                    gat_coef_spmm_t=LAYERS * steps if gat else 0,
                    gat_sddmm_chain=LAYERS * steps if gat else 0,
                    coo_spmm_t=LAYERS * steps if gin else 0, coo_sddmm=0,
                    fused_gcn_dense_att_dual_bwd=0, flash_gat_bwd=0, edge_gat_bwd=0)
    return want


def baseline_want(model: str, layout: str, fwd: int, steps: int) -> dict:
    """Exact launches of ``sparse_counters(training=True)`` for a baseline's
    training run of ``fwd`` forwards (train steps and eval batches) and
    ``steps`` backwards.  Sparse: per forward GCN K3, GIN K11, GAT K8 and K9
    one per layer, all K4 1, and GCN's plain degree once; per backward GCN
    K3T, GIN K11T, GAT K9T and K10 one per layer, all K7 1.  Dense: the
    adjacency build once a forward and, for GAT, the flash forward one per
    layer a forward and its backward one per layer a step (the GCN and GIN
    aggregates are plain products).  Nothing else."""
    want = dict.fromkeys(sparse_counters(training=True), 0)
    if layout == "dense":
        want["adj_build"] = fwd
        if model == "GAT":
            want.update(flash_gat_fwd=LAYERS * fwd, flash_gat_bwd=LAYERS * steps)
        return want
    want.update(segment_pool=fwd, segment_pool_bwd=steps,
                plain_sender_degree=fwd if model == "GCN" else 0)
    per_layer = {"GCN": (("plain_coef_spmm",), ("plain_coef_spmm_t",)),
                 "GIN": (("coo_spmm",), ("coo_spmm_t",)),
                 "GAT": (("gat_row_stats", "gat_coef_spmm"),
                         ("gat_coef_spmm_t", "gat_sddmm_chain"))}[model]
    want.update({k: LAYERS * fwd for k in per_layer[0]})
    want.update({k: LAYERS * steps for k in per_layer[1]})
    return want


def sparse_serving_phase(torch, test_set, trained_dir: str, model: str = "CausalGCN") -> dict:
    """``model`` through ``main_syn --layout sparse --inference`` at the
    canonical size, held to the twins and the CPU; then the checkpoint that
    the model's dense training phase saved in ``trained_dir`` served through
    both layouts, whose f32 eval counts must be equal."""
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.graph import to_dense
    from cal_tpu_torch.main_syn import main
    from cal_tpu_torch.models.factory import get_model
    from cal_tpu_torch.train.causal import evaluate_causal
    from cal_tpu_torch.utils.checkpoint import Checkpointer
    from cal_tpu_torch.utils.config import Config

    save_dir = os.path.join(HERE, "build", f"chip_smoke_ckpt_sparse_{model}")
    cfg = Config(model=model, hidden=H, layers=LAYERS, batch_size=B, dtype="bfloat16",
                 seed=SEED, data_num=SPARSE_DATA_NUM, inference=True, save_dir=save_dir,
                 device="cuda")
    feat = test_set[0].x.shape[1]
    net = get_model(cfg, feat, cfg.num_classes)
    Checkpointer(save_dir).save(0, net, {"epoch": 0})
    argv = ["--model", model, "--inference", "true", "--save_dir", save_dir, "--layout",
            "sparse", "--data_num", str(SPARSE_DATA_NUM), "--seed", str(SEED), "--dtype",
            "bfloat16", "--hidden", str(H), "--layers", str(LAYERS), "--batch_size", str(B),
            "--device", "cuda"]
    counts = sparse_counters()
    for k in counts.values():
        k.launches = 0
    res = main(argv)
    launches = {n: k.launches for n, k in counts.items()}
    n_batches = -(-len(test_set) // B)
    want = sparse_want(model, n_batches)
    check(launches == want, f"sparse serving launches {launches}, expected {want}")
    check(res["graphs"] == len(test_set), "sparse serving sweep missed graphs")
    emit({"phase": "sparse_serving", "model": model, "graphs": res["graphs"],
          "batches": n_batches, "seconds": res["seconds"],
          "graphs_per_s": res["graphs"] / res["seconds"], "test_acc_co": res["test_acc_co"],
          "test_acc_c": res["test_acc_c"], "test_acc_o": res["test_acc_o"],
          "launches": launches, "hidden": H, "layers": LAYERS, "batch": B,
          "dtype": "bfloat16"})

    # the trained checkpoint through both layouts: warm bf16 sweeps, then f32
    trained = cfg.replace(save_dir=trained_dir)
    warm = {lay: evaluate_causal(test_set, trained.replace(layout=lay))
            for lay in ("sparse", "dense")}
    f32 = {lay: evaluate_causal(test_set, trained.replace(layout=lay, dtype="float32"))
           for lay in ("sparse", "dense")}
    keys = ("test_acc_co", "test_acc_c", "test_acc_o")
    loader = Loader(test_set, B, layout="sparse")
    t0 = time.perf_counter()
    host = list(loader.host_batches())
    pack_ms = (time.perf_counter() - t0) / len(host) * 1e3
    emit({"phase": "sparse_serving_warm", "model": model, "graphs": warm["sparse"]["graphs"],
          "sparse_graphs_per_s": warm["sparse"]["graphs"] / warm["sparse"]["seconds"],
          "dense_graphs_per_s": warm["dense"]["graphs"] / warm["dense"]["seconds"],
          "sparse_host_pack_ms_per_batch": pack_ms,
          "f32_acc_sparse": [f32["sparse"][k] for k in keys],
          "f32_acc_dense": [f32["dense"][k] for k in keys],
          "bf16_acc_sparse": [warm["sparse"][k] for k in keys],
          "bf16_acc_dense": [warm["dense"][k] for k in keys],
          "bf16_acc_diff": [warm["sparse"][k] - warm["dense"][k] for k in keys]})
    check(all(f32["sparse"][k] == f32["dense"][k] for k in keys),
          f"f32 eval counts differ between layouts: {f32}")
    # the same checkpoint's f32 log-probs, batch by batch, sparse against dense
    m32 = get_model(cfg.replace(dtype="float32"), feat, cfg.num_classes)
    Checkpointer(trained_dir).restore(m32)
    m32 = m32.to("cuda").eval()
    lay_err = 0.0
    with torch.no_grad():
        for sb, db in zip(host, Loader(test_set, B).host_batches(), strict=True):
            sb = sb.to("cuda")
            a = m32(sb, eval_random=False)
            b = m32(to_dense(db.to("cuda"), torch.float32), eval_random=False)
            for u, w in zip(a, b):
                err, over = max_excess(torch, u[sb.graph_mask], w[sb.graph_mask],
                                       *FWD_TOL["float32"])
                check(over <= 0, f"f32 sparse and dense log-probs differ by {err}")
                lay_err = max(lay_err, err)
    emit({"phase": "sparse_vs_dense_f32", "model": model, "graphs": len(test_set),
          "max_abs_err": lay_err,
          "tol": list(FWD_TOL["float32"])})

    # one batch: kernels against the twins (bf16), card against CPU (f32)
    batch = host[0].to("cuda")
    check((batch.num_nodes, batch.senders.shape[0]) == (31744, 128000),
          f"sparse batch V, E = {batch.num_nodes}, {batch.senders.shape[0]}")
    net = net.to("cuda").eval()
    with torch.no_grad():
        out_k = net(batch, eval_random=False)
        with sparse_twins():
            out_p = net(batch, eval_random=False)
    atol, rtol = FWD_TOL["bfloat16"]
    errs = []
    for a, b in zip(out_k, out_p):
        check(a.shape == (B, cfg.num_classes) and bool(torch.isfinite(a).all()),
              "sparse log-probs not finite or misshapen")
        err, over = max_excess(torch, a, b, atol, rtol)
        check(over <= 0, f"sparse bf16 forward differs from the plain twins by {err}")
        errs.append(err)
    m32 = get_model(cfg.replace(dtype="float32", layout="sparse"), feat, cfg.num_classes).eval()
    small = next(Loader(test_set[:16], 16, layout="sparse").host_batches())
    with torch.no_grad():
        ref = m32(small.to("cpu"), eval_random=False)
        got = m32.to("cuda")(small.to("cuda"), eval_random=False)
    atol32, rtol32 = FWD_TOL["float32"]
    errs32 = []
    for a, b in zip(got, ref):
        err, over = max_excess(torch, a.cpu(), b, atol32, rtol32)
        check(over <= 0, f"sparse f32 forward on the card differs from the CPU by {err}")
        errs32.append(err)
    emit({"phase": "sparse_forward_check", "model": model, "bf16_vs_plain_max_abs_err": max(errs),
          "bf16_tol": [atol, rtol], "f32_card_vs_cpu_max_abs_err": max(errs32),
          "f32_tol": [atol32, rtol32], "f32_graphs": 16})
    profile_forward(torch, net, batch, lambda b, dt: b, layout="sparse")
    return launches


def _library_spmm_t(torch, g, coefs, gs):
    """torch.sparse.mm over the block-diagonal TRANSPOSED CSR (rows =
    senders, through the sender CSR's perm) of the materialized
    coefficients; CSR and stacking built outside the timed call."""
    v = g.num_nodes
    nnz = g.senders.shape[0]
    perm = g.send.perm.long()
    crow = torch.cat([g.send.ptr[:-1] + k * nnz for k in range(len(gs))]
                     + [g.send.ptr[-1:] + (len(gs) - 1) * nnz])
    col = torch.cat([g.receivers[perm] + k * v for k in range(len(gs))])
    x = torch.cat(gs)
    a = torch.sparse_csr_tensor(crow, col, torch.cat([c[perm] for c in coefs]).to(x.dtype),
                                size=(len(gs) * v, len(gs) * v))
    return lambda: torch.sparse.mm(a, x)


def repeated(torch, g, what, fn):
    """fn()'s outputs, after checking that the call left both of ``g``'s
    CSRs' arrival counters at 0 and that a second call repeats its bits."""
    got = fn()
    torch.cuda.synchronize()
    check(not g.recv.arrivals.any() and not g.send.arrivals.any(),
          f"{what} left arrival counters set")
    check(all(torch.equal(a, b) for a, b in zip(got, fn())), f"{what} differs between two calls")
    return got


def sparse_bwd_kernel_rows(torch, g, label, peaks, flush):
    """K2T, K3T, K5, K6 and K7 against their twins on one sparse batch ``g``
    (on the card; K7 also on its node_graph shuffled), bf16 and f32, every
    f32 backward also against autograd of the f32 forward twins; with their
    times (K5's, K6's and K7's also with the warm device ms of each kernel a
    call launches, ``passes``).  Returns {dtype: {kernel: row}}."""
    from cal_tpu_torch.ops import spmm
    from cal_tpu_torch.ops.pool import (
        segment_pool, segment_pool_bwd, segment_pool_bwd_plain, segment_pool_plain)

    bw, _, f32_peak = peaks
    v, e = g.num_nodes, g.senders.shape[0]
    n_live = int((g.edge_mask & (g.senders != g.receivers)).sum())
    g1 = g.num_graphs + 1
    csr = lambda c: 4 * (2 * (v + 1) + c.num_chunks)
    out = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        xc, xo, gc, go = (torch.randn((v, H), generator=gen, device="cuda").to(dt)
                          for _ in range(4))
        src = torch.randn(v, generator=gen, device="cuda").to(dt)
        dst = (2.0 * torch.randn(v, generator=gen, device="cuda")).to(dt)
        deg = spmm.pair_sender_degree(src, dst, g) + 1.0
        dis = torch.rsqrt(deg)
        pdeg = 2.0 * spmm.pair_sender_degree(None, None, g)[:1] + 1.0
        pdis = torch.rsqrt(pdeg)
        rows = {}

        def row(name, fn, plain, nbytes, flops, err, tol, lib_fn=None, lib_call=None):
            t_bytes, t_ops = nbytes / bw, flops / f32_peak
            r = {"name": name, "batch": label, "dtype": dt_name, "max_abs_err": err,
                 "atol": tol[0], "rtol": tol[1],
                 "kernel_ms": time_ms(torch, fn, flush), "plain_ms": time_ms(torch, plain, flush),
                 "library_ms": None if lib_fn is None else time_ms(torch, lib_fn, flush),
                 "library_call": lib_call, "bytes": nbytes, "flops": flops,
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "nodes": v, "edges": e, "live_edges": n_live}
            if name in ("pair_sddmm_chain", "pair_dpre", "segment_pool_bwd"):
                r["passes"] = profile_passes(torch, fn)
            emit({"phase": "sparse_bwd_kernel", **r})
            rows[name] = r

        def held(name, got, ref, tol):
            got = (got,) if torch.is_tensor(got) else tuple(got)
            ref = (ref,) if torch.is_tensor(ref) else tuple(ref)
            torch.cuda.synchronize()
            errs = []
            for a, b in zip(got, ref, strict=True):
                check(a.dtype == b.dtype and a.shape == b.shape, f"{name} {dt_name} misshapen")
                check(bool(torch.isfinite(a.float()).all()),
                      f"{name} {dt_name} on {label} not finite")
                err, over = max_excess(torch, a, b, *tol)
                check(over <= 0, f"{name} {dt_name} on {label} differs from its plain twin: {err}")
                errs.append(err)
            return max(errs)

        tol = SPARSE_TOL[dt_name]
        err = held("pair_coef_spmm_t", spmm.pair_coef_spmm_t(gc, go, src, dst, deg, dis, g),
                   spmm.coef_spmm_plain([gc, go], src, dst, deg, dis, g, transpose=True), tol)
        lib = _library_spmm_t(torch, g, _csr_coefs(torch, g, src, dst, deg, dis), [gc, go])
        row("pair_coef_spmm_t", lambda: spmm.pair_coef_spmm_t(gc, go, src, dst, deg, dis, g),
            lambda: spmm.coef_spmm_plain([gc, go], src, dst, deg, dis, g, transpose=True),
            4 * v * H * elt + 2 * v * elt + 9 * e + csr(g.send) + 4 * v * 4,
            2 * 2 * H * n_live, err, tol, lib,
            "torch.sparse.mm(block-diagonal transposed CSR [2V, 2V], [gc; go]), "
            "coefficients materialized outside the call, no self term")

        err = held("plain_coef_spmm_t", spmm.plain_coef_spmm_t(gc, pdeg, pdis, g),
                   spmm.coef_spmm_plain([gc], None, None, pdeg, pdis, g, transpose=True)[0], tol)
        lib = _library_spmm_t(torch, g, _csr_coefs(torch, g, None, None, pdeg, pdis), [gc])
        row("plain_coef_spmm_t", lambda: spmm.plain_coef_spmm_t(gc, pdeg, pdis, g),
            lambda: spmm.coef_spmm_plain([gc], None, None, pdeg, pdis, g, transpose=True),
            2 * v * H * elt + 9 * e + csr(g.send) + 2 * v * 4, 2 * H * n_live, err, tol, lib,
            "torch.sparse.mm(transposed CSR [V, V], g), coefficients materialized outside "
            "the call, no self term")

        chain = lambda: spmm.pair_sddmm_chain(xc, xo, gc, go, src, dst, dis, g)
        chain_p = lambda: spmm.pair_sddmm_chain_plain(xc, xo, gc, go, src, dst, dis, g)
        ref = chain_p()
        err = held("pair_sddmm_chain",
                   repeated(torch, g, f"pair_sddmm_chain {dt_name} on {label}", chain), ref,
                   CHAIN_TOL)
        none = "none: no single PyTorch call computes the {} of the pair VJP"
        row("pair_sddmm_chain", chain, chain_p,
            4 * v * H * elt + 2 * v * elt + 5 * e + csr(g.recv) + 4 * e + csr(g.send)
            + 2 * v * 4 + 3 * e * 4 + 4 * v * 4, 2 * 2 * H * n_live, err, CHAIN_TOL,
            None, none.format("SDDMM chain (dot products, chain terms, ddis sums)"))

        vec = ref[0]
        ddeg = torch.randn((2, v), generator=gen, device="cuda")
        err = held("pair_dpre", repeated(torch, g, f"pair_dpre {dt_name} on {label}",
                                         lambda: spmm.pair_dpre(vec, ddeg, g)),
                   spmm.pair_dpre_plain(vec, ddeg, g), CHAIN_TOL)
        row("pair_dpre", lambda: spmm.pair_dpre(vec, ddeg, g),
            lambda: spmm.pair_dpre_plain(vec, ddeg, g),
            3 * e * 4 + 2 * v * 4 + 4 * e + csr(g.recv) + 4 * e + csr(g.send) + 2 * v * 4,
            6 * e, err, CHAIN_TOL, None, none.format("edge logit gradient and its two sums"))

        ng = g.node_graph
        dp = torch.randn((g1, H), generator=gen, device="cuda")
        err = held("segment_pool_bwd", segment_pool_bwd(dp, ng, dt),
                   segment_pool_bwd_plain(dp, ng, dt), (0.0, 0.0))
        shuffled = ng[torch.randperm(v, generator=gen, device="cuda")]
        held("segment_pool_bwd", segment_pool_bwd(dp, shuffled, dt),
             segment_pool_bwd_plain(dp, shuffled, dt), (0.0, 0.0))
        ng64 = ng.long()
        row("segment_pool_bwd", lambda: segment_pool_bwd(dp, ng, dt),
            lambda: segment_pool_bwd_plain(dp, ng, dt), v * H * elt + 4 * v + g1 * H * 4,
            0, err, (0.0, 0.0), lambda: dp.index_select(0, ng64),
            "dpooled.index_select(0, node_graph) (f32 rows, no cast)")

        if dt == torch.float32:
            # the Functions' backward kernels against autograd of the twins
            leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
            d = spmm.pair_sender_degree_plain(leaves[2], leaves[3], g) + 1.0
            oc, oo = spmm.coef_spmm_plain(leaves[:2], leaves[2], leaves[3], d, torch.rsqrt(d), g)
            auto = torch.autograd.grad((oc * gc).sum() + (oo * go).sum(), leaves)
            leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
            oc, oo = spmm.gcn_aggregate_sparse_pair(*leaves, g)
            got = torch.autograd.grad((oc * gc).sum() + (oo * go).sum(), leaves)
            errs = [held("pair VJP vs autograd", a, b, CHAIN_TOL) for a, b in zip(got, auto)]
            x = xc.clone().requires_grad_()
            (o,) = spmm.coef_spmm_plain([x], None, None, pdeg, pdis, g)
            auto = torch.autograd.grad((o * gc).sum(), x)[0]
            x = xc.clone().requires_grad_()
            got = torch.autograd.grad((spmm.gcn_aggregate_sparse_plain(x, g) * gc).sum(), x)[0]
            errs.append(held("plain VJP vs autograd", got, auto, tol))
            x = xc.clone().requires_grad_()
            auto = torch.autograd.grad((segment_pool_plain(x, ng, g1) * dp).sum(), x)[0]
            x = xc.clone().requires_grad_()
            got = torch.autograd.grad((segment_pool(x, ng, g1) * dp).sum(), x)[0]
            errs.append(held("pool VJP vs autograd", got, auto, (0.0, 0.0)))
            emit({"phase": "sparse_bwd_vs_autograd", "batch": label, "dtype": dt_name,
                  "max_abs_err": max(errs), "tol": list(CHAIN_TOL)})
        out[dt_name] = rows
    return out


def _library_gat_spmm(torch, g, q, x, transpose: bool):
    """One torch.sparse.mm over a block-diagonal CSR of the per-head
    weights q [heads, E] (one [V, V] block per head; rows = receivers, or
    senders through the sender CSR's perm when ``transpose``) and the
    per-head column blocks of x stacked [heads * V, d]; both built outside
    the timed call."""
    heads, nnz = q.shape
    v, hd = x.shape
    csr, nbr = (g.send, g.receivers[g.send.perm.long()]) if transpose else (g.recv, g.senders)
    vals = q[:, g.send.perm.long()] if transpose else q
    crow = torch.cat([csr.ptr[:-1] + k * nnz for k in range(heads)]
                     + [csr.ptr[-1:] + (heads - 1) * nnz])
    col = torch.cat([nbr + k * v for k in range(heads)])
    a = torch.sparse_csr_tensor(crow, col, vals.reshape(-1).to(x.dtype),
                                size=(heads * v, heads * v))
    xs = x.view(v, heads, hd // heads).transpose(0, 1).reshape(heads * v, hd // heads)
    return lambda: torch.sparse.mm(a, xs)


def gat_inputs(torch, v, dt, seed=SEED + 4):
    """Seeded inputs of row 13's kernels on V nodes: (xh [V, HEADS, d] in
    dt, att [2, HEADS, d], x = xh as [V, H], ti, tj [HEADS, V] from them, w
    [V, H] and dD [HEADS, V] f32), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xh = torch.randn((v, HEADS, H // HEADS), generator=gen, device="cuda").to(dt)
    att = 0.3 * torch.randn((2, HEADS, H // HEADS), generator=gen, device="cuda")
    ti = torch.einsum("vhd,hd->hv", xh.float(), att[0]).contiguous()
    tj = torch.einsum("vhd,hd->hv", xh.float(), att[1]).contiguous()
    w = torch.randn((v, H), generator=gen, device="cuda")
    dD = torch.randn((HEADS, v), generator=gen, device="cuda")
    return xh, att, xh.reshape(v, H), ti, tj, w, dD


def timed_seed(torch, seed: int, older):
    """The 64-bit dropout ``seed`` of a timed GAT kernel call as a captured
    step hands it over: a seed buffer on the card, which the kernels read
    there, where the tree's sparse and edge GAT kernels take one (else
    ``older``, the form an older parent's wrappers take, for an A/B)."""
    from cal_tpu_torch import graph as graph_mod
    from cal_tpu_torch.ops.flash_gat import seed_buffer

    return seed_buffer(seed, "cuda") if hasattr(graph_mod, "heavy_capacity") else older


def gat_kernel_rows(torch, g, label, peaks, flush, split=False):
    """K8, K9, K9T and K10 against their twins on one sparse batch ``g`` (on
    the card), bf16 and f32 features, at dropout rate 0 and GAT_RATE (the
    same tolerance: identical keep bits), each call's counters on both CSRs
    back at 0, K8, K9, K9T and K10 equal bit for bit on a second call, the f32
    Function VJP against autograd of the twins, the dropout law from K9
    itself, and their times (at GAT_RATE, the training path; K9, K9T and
    K10 also at rate 0, ``kernel_ms_rate0``).  ``split``: each row also
    carries the warm device ms by launch (``passes``).  Returns ({dtype:
    {kernel: row}}, (kept pairs, live pairs))."""
    from cal_tpu_torch.ops import gat_sparse as gs
    from cal_tpu_torch.ops.gat import head_ids, keep_mask

    bw, _, f32_peak = peaks
    v, e = g.num_nodes, g.senders.shape[0]
    s, r = g.senders.long(), g.receivers.long()
    live = g.edge_mask & (s != r)
    n_live = int(live.sum())
    d = H // HEADS
    plane = HEADS * v * 4
    csr = lambda c: 4 * (2 * (v + 1) + c.num_chunks)
    words = (DROP_SEED & 0xFFFFFFFF, DROP_SEED >> 32)
    seed = timed_seed(torch, DROP_SEED, words)
    out = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        xh, att, x, ti, tj, w, dD = gat_inputs(torch, v, dt)
        rows = {}

        def held(name, got, ref, tol):
            got = (got,) if torch.is_tensor(got) else tuple(got)
            ref = (ref,) if torch.is_tensor(ref) else tuple(ref)
            torch.cuda.synchronize()
            errs = []
            for a, b in zip(got, ref, strict=True):
                check(a.dtype == b.dtype and a.shape == b.shape, f"{name} {dt_name} misshapen")
                check(bool(torch.isfinite(a.float()).all()),
                      f"{name} {dt_name} on {label} not finite")
                err, over = max_excess(torch, a, b, *tol)
                check(over <= 0, f"{name} {dt_name} on {label} differs from its plain twin: {err}")
                errs.append(err)
            return max(errs)

        def row(name, fn, plain, nbytes, flops, err, tol, lib_fn=None, lib_call=None, **extra):
            t_bytes, t_ops = nbytes / bw, flops / f32_peak
            rr = {"name": name, "batch": label, "dtype": dt_name, "rate": GAT_RATE,
                  "max_abs_err": err, "atol": tol[0], "rtol": tol[1],
                  "kernel_ms": time_ms(torch, fn, flush), "plain_ms": time_ms(torch, plain, flush),
                  "library_ms": None if lib_fn is None else time_ms(torch, lib_fn, flush),
                  "library_call": lib_call, "bytes": nbytes, "flops": flops,
                  "bound_ms": max(t_bytes, t_ops) * 1e3,
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "nodes": v, "edges": e, "live_edges": n_live, "root": HERE, **extra}
            if split:
                rr["passes"] = profile_passes(torch, fn)
            emit({"phase": "gat_kernel", **rr})
            rows[name] = rr

        def settled(name):
            torch.cuda.synchronize()
            check(not g.recv.arrivals.any() and not g.send.arrivals.any(),
                  f"{name} {dt_name} on {label} left arrival counters set")

        m, den = gs.gat_row_stats(tj, ti, g)
        settled("gat_row_stats")
        err8 = held("gat_row_stats", (m, den), gs.gat_row_stats_plain(tj, ti, g), GAT_STATS_TOL)
        check(all(torch.equal(a, b) for a, b in zip((m, den), gs.gat_row_stats(tj, ti, g))),
              f"gat_row_stats {dt_name} on {label} differs between two calls")
        errs = {"gat_coef_spmm": [], "gat_coef_spmm_t": [], "gat_sddmm_chain": []}
        for rate in (0.0, GAT_RATE):
            for name, xin, t in (("gat_coef_spmm", x, False), ("gat_coef_spmm_t", w, True)):
                fn = getattr(gs, name)
                got = fn(xin, tj, ti, m, words, rate, g)
                settled(name)
                errs[name].append(held(
                    name, got, gs.gat_coef_spmm_plain(xin, tj, ti, m, words, rate, g, t),
                    GAT_SPMM_TOL))
                check(torch.equal(got, fn(xin, tj, ti, m, words, rate, g)),
                      f"{name} {dt_name} on {label} differs between two calls")
            chain = gs.gat_sddmm_chain(x, w, tj, ti, m, dD, words, rate, g)
            settled("gat_sddmm_chain")
            errs["gat_sddmm_chain"].append(held(
                "gat_sddmm_chain", chain,
                gs.gat_sddmm_chain_plain(x, w, tj, ti, m, dD, words, rate, g), CHAIN_TOL))
            check(all(torch.equal(a, b) for a, b in zip(
                chain, gs.gat_sddmm_chain(x, w, tj, ti, m, dD, words, rate, g))),
                f"gat_sddmm_chain {dt_name} on {label} differs between two calls")

        # the library yardsticks: the max and the exp sums as two calls, the
        # per-head SpMMs as one sparse.mm each way
        _, q = gs._edge_q(tj, ti, m, s, r, live)
        pre = tj[:, s] + ti[:, r]
        score = torch.where(live, torch.nn.functional.leaky_relu(pre, 0.2),
                            torch.full_like(pre, -torch.inf))
        self_score = torch.nn.functional.leaky_relu(ti + tj, 0.2)
        r_idx = r.expand(HEADS, -1).contiguous()
        mx, dn = self_score.clone(), torch.zeros_like(den)
        amax = lambda: mx.scatter_reduce_(1, r_idx, score, "amax")
        iadd = lambda: dn.index_add_(1, r, q)
        lib8 = [time_ms(torch, amax, flush), time_ms(torch, iadd, flush)]
        row("gat_row_stats", lambda: gs.gat_row_stats(tj, ti, g),
            lambda: gs.gat_row_stats_plain(tj, ti, g),
            2 * plane + 5 * e + csr(g.recv) + 2 * plane, 6 * HEADS * n_live, err8,
            GAT_STATS_TOL, lambda: (amax(), iadd()),
            "Tensor.scatter_reduce_(1, receivers, scores, 'amax') then index_add_(1, "
            "receivers, exp terms), scores and exp terms materialized outside the calls",
            library_ms_parts=lib8)
        qk = q * gs._edge_keep(words, GAT_RATE, HEADS, e, q.device) / (1.0 - GAT_RATE)
        row("gat_coef_spmm", lambda: gs.gat_coef_spmm(x, tj, ti, m, seed, GAT_RATE, g),
            lambda: gs.gat_coef_spmm_plain(x, tj, ti, m, words, GAT_RATE, g),
            v * H * elt + 3 * plane + 5 * e + csr(g.recv) + v * H * 4,
            2 * H * n_live + 8 * HEADS * n_live, max(errs["gat_coef_spmm"]), GAT_SPMM_TOL,
            _library_gat_spmm(torch, g, qk, x, False),
            "torch.sparse.mm(block-diagonal CSR [heads V, heads V] of the per-head weights, "
            "per-head x blocks), weights materialized outside the call, no self term",
            kernel_ms_rate0=time_ms(torch, lambda: gs.gat_coef_spmm(x, tj, ti, m, seed, 0.0, g),
                                    flush))
        row("gat_coef_spmm_t", lambda: gs.gat_coef_spmm_t(w, tj, ti, m, seed, GAT_RATE, g),
            lambda: gs.gat_coef_spmm_plain(w, tj, ti, m, words, GAT_RATE, g, transpose=True),
            v * H * 4 + 3 * plane + 9 * e + csr(g.send) + v * H * 4,
            2 * H * n_live + 8 * HEADS * n_live, max(errs["gat_coef_spmm_t"]), GAT_SPMM_TOL,
            _library_gat_spmm(torch, g, qk, w, True),
            "torch.sparse.mm(block-diagonal transposed CSR of the per-head weights, "
            "per-head w blocks), weights materialized outside the call",
            kernel_ms_rate0=time_ms(
                torch, lambda: gs.gat_coef_spmm_t(w, tj, ti, m, seed, 0.0, g), flush))
        row("gat_sddmm_chain", lambda: gs.gat_sddmm_chain(x, w, tj, ti, m, dD, seed, GAT_RATE, g),
            lambda: gs.gat_sddmm_chain_plain(x, w, tj, ti, m, dD, words, GAT_RATE, g),
            v * H * (elt + 4) + 4 * plane + 5 * e + csr(g.recv) + 4 * e + csr(g.send)
            + 2 * plane, 2 * H * n_live + 10 * HEADS * n_live, max(errs["gat_sddmm_chain"]),
            CHAIN_TOL, None, "none: no single PyTorch call computes the per-head SDDMM chain "
            "(dot products, keep bits, dq, dpre) and its sums by sender and by receiver",
            kernel_ms_rate0=time_ms(
                torch, lambda: gs.gat_sddmm_chain(x, w, tj, ti, m, dD, seed, 0.0, g), flush))

        if dt == torch.float32:
            # the Function's backward kernels against autograd of the twins
            a = [t.clone().requires_grad_() for t in (xh, att[0], att[1])]
            b = [t.clone().requires_grad_() for t in (xh, att[0], att[1])]
            got = gs.gat_aggregate_sparse_fused(*a, words, g, GAT_RATE)
            ref = gs.gat_aggregate_sparse_fused_plain(*b, words, g, GAT_RATE)
            errs_v = [held("GAT forward vs twins", got, ref, GAT_SPMM_TOL)]
            cot = w.view(got.shape)
            for u, z in zip(torch.autograd.grad(got, a, cot), torch.autograd.grad(ref, b, cot)):
                errs_v.append(held("GAT VJP vs autograd", u, z, CHAIN_TOL))
            emit({"phase": "gat_bwd_vs_autograd", "batch": label, "dtype": dt_name,
                  "rate": GAT_RATE, "max_abs_err": max(errs_v), "tol": list(CHAIN_TOL)})
            del a, b, got, ref

            # the dropout law from K9 itself: zero logits make every live
            # weight 1, so K9 on ones counts each receiver's kept (edge,
            # head) pairs; they must equal the hash's count bit for bit
            zero = torch.zeros((HEADS, v), device="cuda")
            ones = torch.ones((v, H), device="cuda")
            got = gs.gat_coef_spmm(ones, zero, zero, zero, words, GAT_RATE, g)
            kept_k = got.view(v, HEADS, d)[:, :, 0] * (1.0 - GAT_RATE)
            bits = keep_mask(head_ids(torch.arange(e, device="cuda"), HEADS), words, GAT_RATE,
                             0) * live[:, None]
            kept_p = torch.zeros((v, HEADS), device="cuda").index_add_(0, r, bits)
            check(bool((kept_k.round() == kept_p).all()),
                  f"K9's keep bits on {label} differ from the hash")
            keep_pairs = (float(kept_p.sum()), n_live * HEADS)
        out[dt_name] = rows
    return out, keep_pairs


def _library_sddmm(torch, g, x, gout):
    """One torch.sparse.sampled_addmm over the receiver CSR (rows r,
    columns s) of (gout @ x^T), i.e. <gout[r], x[s]> per stored edge, f32
    (gout is f32; x cast outside the call), CSR built outside."""
    a = torch.sparse_csr_tensor(g.recv.ptr.long(), g.senders.long(),
                                torch.zeros(g.senders.shape[0], device="cuda"),
                                size=(g.num_nodes, g.num_nodes))
    xt = x.float().t()
    return lambda: torch.sparse.sampled_addmm(a, gout, xt, beta=0.0)


def _library_sddmm_mh(torch, g, x, gout, heads):
    """One batched torch.sparse.sampled_addmm over the receiver CSR
    repeated per head [heads, V, V] of (gout_h @ x_h^T), i.e. <gout[r, h],
    x[s, h]> per stored edge and head, f32; the CSR, the per-head split of
    gout and x and the cast of x built outside the call.  Returns the call
    and its result's values as [E, heads]."""
    v, e = g.num_nodes, g.senders.shape[0]
    d = gout.shape[1] // heads
    a = torch.sparse_csr_tensor(g.recv.ptr.long()[None].expand(heads, -1).contiguous(),
                                g.senders.long()[None].expand(heads, -1).contiguous(),
                                torch.zeros((heads, e), device="cuda"), size=(heads, v, v))
    gh = gout.float().view(v, heads, d).permute(1, 0, 2).contiguous()
    xt = x.float().view(v, heads, d).permute(1, 2, 0).contiguous()
    fn = lambda: torch.sparse.sampled_addmm(a, gh, xt, beta=0.0)
    return fn, lambda: fn().values().T


def coo_kernel_rows(torch, g, label, peaks, flush):
    """K11, K11T and K12 against their twins on one sparse batch ``g`` (on
    the card), x in bf16 and f32, at coef = the edge mask (sparse GIN's) and
    at a random coefficient on every edge, dead ones too; the f32 Function's
    backward (K11T, K12) against autograd of the forward twin; times at
    coef = mask, K12 with the warm device ms of each kernel a call launches
    (``passes``).  Returns {dtype: {kernel: row}}."""
    from cal_tpu_torch.ops import coo_spmm as coo

    bw, _, f32_peak = peaks
    v, e = g.num_nodes, g.senders.shape[0]
    n_nz = int(g.edge_mask.sum())
    csr = lambda c: 4 * (2 * (v + 1) + c.num_chunks)
    out = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        x = torch.randn((v, H), generator=gen, device="cuda").to(dt)
        gout = torch.randn((v, H), generator=gen, device="cuda")
        mask = g.edge_mask.float()
        rand = torch.randn(e, generator=gen, device="cuda")
        rows = {}

        def row(name, fn, plain, nbytes, flops, err, lib_fn, lib_call, **extra):
            t_bytes, t_ops = nbytes / bw, flops / f32_peak
            r = {"name": name, "batch": label, "dtype": dt_name, "max_abs_err": err,
                 "atol": COO_TOL[0], "rtol": COO_TOL[1], "coef": "edge_mask",
                 "kernel_ms": time_ms(torch, fn, flush), "plain_ms": time_ms(torch, plain, flush),
                 "library_ms": None if lib_fn is None else time_ms(torch, lib_fn, flush),
                 "library_call": lib_call, "bytes": nbytes, "flops": flops,
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "nodes": v, "edges": e, "nonzero_coef_edges": n_nz, **extra}
            emit({"phase": "coo_kernel", **r})
            rows[name] = r

        def held(name, got, ref):
            torch.cuda.synchronize()
            check(got.dtype == ref.dtype and got.shape == ref.shape, f"{name} {dt_name} misshapen")
            check(bool(torch.isfinite(got).all()), f"{name} {dt_name} on {label} not finite")
            err, over = max_excess(torch, got, ref, *COO_TOL)
            check(over <= 0, f"{name} {dt_name} on {label} differs from its plain twin: {err}")
            return err

        errs = {"coo_spmm": [], "coo_spmm_t": []}
        for coef in (mask, rand):
            errs["coo_spmm"].append(held("coo_spmm", coo.coo_spmm(x, coef, g),
                                         coo.coo_spmm_plain(x, coef, g)))
            errs["coo_spmm_t"].append(held("coo_spmm_t", coo.coo_spmm_t(gout, coef, g),
                                           coo.coo_spmm_t_plain(gout, coef, g)))
        err = held("coo_sddmm", coo.coo_sddmm(x, gout, g), coo.coo_sddmm_plain(x, gout, g))

        row("coo_spmm", lambda: coo.coo_spmm(x, mask, g), lambda: coo.coo_spmm_plain(x, mask, g),
            v * H * elt + 8 * e + csr(g.recv) + v * H * 4, 2 * H * n_nz, max(errs["coo_spmm"]),
            _library_spmm(torch, g, [mask], [x]),
            "torch.sparse.mm(CSR [V, V] of the coefficients, x) in x's dtype, CSR built "
            "outside the call")
        row("coo_spmm_t", lambda: coo.coo_spmm_t(gout, mask, g),
            lambda: coo.coo_spmm_t_plain(gout, mask, g),
            v * H * 4 + 12 * e + csr(g.send) + v * H * 4, 2 * H * n_nz,
            max(errs["coo_spmm_t"]), _library_spmm_t(torch, g, [mask], [gout]),
            "torch.sparse.mm(transposed CSR [V, V] of the coefficients, g), CSR built "
            "outside the call")
        row("coo_sddmm", lambda: coo.coo_sddmm(x, gout, g), lambda: coo.coo_sddmm_plain(x, gout, g),
            v * H * elt + v * H * 4 + 4 * e + csr(g.recv) + 4 * e, 2 * H * e, err,
            _library_sddmm(torch, g, x, gout),
            "torch.sparse.sampled_addmm(receiver CSR [V, V], g, x^T) in f32, CSR and the "
            "cast of x built outside the call",
            passes=profile_passes(torch, lambda: coo.coo_sddmm(x, gout, g)))

        if dt == torch.float32:
            # the Function's backward kernels against autograd of the twin
            a = [t.clone().requires_grad_() for t in (x, rand)]
            b = [t.clone().requires_grad_() for t in (x, rand)]
            got = torch.autograd.grad((coo.coo_aggregate(*a, g) * gout).sum(), a)
            auto = torch.autograd.grad((coo.coo_spmm_plain(*b, g) * gout).sum(), b)
            errs = [held("coo VJP vs autograd", u, w) for u, w in zip(got, auto)]
            emit({"phase": "coo_vs_autograd", "batch": label, "dtype": dt_name,
                  "max_abs_err": max(errs), "tol": list(COO_TOL)})
        out[dt_name] = rows
    return out


def baseline_phase(torch, model: str, layout: str, n_val: int, n_test: int) -> dict:
    """One short bf16 training run of the ``model`` baseline through
    ``main_syn --layout layout`` (dense: data_num DATA_NUM; sparse: the
    canonical SPARSE_DATA_NUM) with every counter at 0 just before; fails
    unless each kernel launched exactly ``baseline_want``'s count and every
    epoch's loss is finite.  ``n_val``/``n_test``: the split sizes."""
    from cal_tpu_torch.main_syn import main

    data_num = SPARSE_DATA_NUM if layout == "sparse" else DATA_NUM
    argv = ["--model", model, "--layout", layout, "--dtype", "bfloat16", "--hidden", str(H),
            "--layers", str(LAYERS), "--batch_size", str(B), "--data_num", str(data_num),
            "--seed", str(SEED), "--epochs", str(BASELINE_EPOCHS), "--device", "cuda"]
    counts = sparse_counters(training=True)
    for k in counts.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = main(argv)
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in counts.items()}
    steps = res["steps_per_epoch"] * BASELINE_EPOCHS
    evals = (-(-n_val // B) - (-n_test // B)) * BASELINE_EPOCHS
    want = baseline_want(model, layout, steps + evals, steps)
    check(launches == want, f"{model} {layout} baseline launches {launches}, expected {want}")
    losses = [h["loss"] for h in res["history"]]
    check(all(map(math.isfinite, losses)), f"{model} {layout} baseline losses {losses}")
    emit({"phase": "baseline", "model": model, "layout": layout, "data_num": data_num,
          "epochs": BASELINE_EPOCHS, "losses": losses, "main_wall_s": wall,
          "epoch_seconds": [h["seconds"] for h in res["history"]],
          "train_seconds": [h["train_seconds"] for h in res["history"]],
          "steps_per_epoch": res["steps_per_epoch"], "eval_batches": evals,
          "val_acc": res["history"][-1]["val_acc"], "test_acc": res["history"][-1]["test_acc"],
          "launches": {k: v for k, v in launches.items() if v},
          "hidden": H, "layers": LAYERS, "batch": B, "dtype": "bfloat16"})
    return launches


def sparse_training_phase(torch, sparse_test, n_val: int, model: str = "CausalGCN") -> dict:
    """``model`` trained through ``main_syn --layout sparse`` with the
    counters at 0, then its checkpoint served through both layouts (``n_val``
    graphs in the val split).  Returns the training run's launch counts."""
    import shutil

    from cal_tpu_torch.main_syn import main
    from cal_tpu_torch.train.causal import evaluate_causal
    from cal_tpu_torch.utils.config import Config

    save_dir = os.path.join(HERE, "build", f"chip_smoke_train_sparse_{model}")
    shutil.rmtree(save_dir, ignore_errors=True)
    argv = ["--model", model, "--layout", "sparse", "--dtype", "bfloat16", "--hidden",
            str(H), "--layers", str(LAYERS), "--batch_size", str(B), "--data_num",
            str(SPARSE_DATA_NUM), "--seed", str(SEED), "--save_dir", save_dir, "--device",
            "cuda", "--epochs", str(SPARSE_TRAIN_EPOCHS), "--save_model", "true"]
    counts = sparse_counters(training=True)
    for k in counts.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = main(argv)
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in counts.items()}
    steps = res["steps_per_epoch"] * SPARSE_TRAIN_EPOCHS
    # every epoch sweeps the val and the test split
    evals = (-(-n_val // B) - (-len(sparse_test) // B)) * SPARSE_TRAIN_EPOCHS
    want = sparse_want(model, steps + evals, steps)
    check(launches == want, f"sparse training launches {launches}, expected {want}")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == SPARSE_TRAIN_EPOCHS and all(map(math.isfinite, losses)),
          f"sparse training losses {losses}")
    check(losses[-1] < losses[0], f"sparse training loss did not fall: {losses}")
    warm = hist[1:]
    train_s = sum(h["train_seconds"] for h in warm)
    emit({"phase": "sparse_training", "model": model, "epochs": SPARSE_TRAIN_EPOCHS,
          "losses": losses, "epoch_seconds": [h["seconds"] for h in hist],
          "train_seconds": [h["train_seconds"] for h in hist], "main_wall_s": wall,
          "train_graphs": res["train_graphs"], "steps_per_epoch": res["steps_per_epoch"],
          "train_graphs_per_s_warm": res["train_graphs"] * len(warm) / train_s,
          "steps_per_s_warm": res["steps_per_epoch"] * len(warm) / train_s,
          "best_epoch": res["epoch"], "best_val_acc": res["best_val_acc"],
          "test_acc_co": res["test_acc_co"], "test_acc_c": res["test_acc_c"],
          "test_acc_o": res["test_acc_o"], "launches": launches, "eval_batches": evals,
          "hidden": H, "layers": LAYERS, "batch": B, "dtype": "bfloat16"})

    cfg = Config(model=model, hidden=H, layers=LAYERS, batch_size=B, seed=SEED,
                 data_num=SPARSE_DATA_NUM, inference=True, save_dir=save_dir, device="cuda")
    keys = ("test_acc_co", "test_acc_c", "test_acc_o")
    served = {(lay, dt): evaluate_causal(sparse_test, cfg.replace(layout=lay, dtype=dt))
              for lay in ("sparse", "dense") for dt in ("bfloat16", "float32")}
    check(all(served[("sparse", "float32")][k] == served[("dense", "float32")][k] for k in keys),
          "f32 eval counts of the sparse-trained checkpoint differ between layouts")
    # the run evaluated on budgets over all three splits, the server on the
    # test split's: reported, not held (the linear layers' GEMMs see other V)
    emit({"phase": "sparse_train_then_serve", "model": model, "ckpt_epoch": res["epoch"],
          "run_test_acc": [res[k] for k in keys],
          **{f"{lay}_{dt}": [served[(lay, dt)][k] for k in keys] for lay, dt in served}})
    return launches


# The sparse kernel wrappers that each model's train step runs (labels of
# _twin_table).
SPARSE_STEP_WRAPPERS = {
    "CausalGCN": ("K1", "K2", "K3", "K4", "K2T", "K3T", "K5", "K6", "K7"),
    "CausalGAT": ("K1", "K2", "K4", "K8", "K9", "K2T", "K5", "K6", "K7", "K9T", "K10"),
    "CausalGIN": ("K1", "K2", "K4", "K11", "K2T", "K5", "K6", "K7", "K11T"),
}


def sparse_grad_check(torch, sparse_test, model: str = "CausalGCN") -> None:
    """One sparse step's gradients (CausalGAT with attention dropout on, one
    seed: the keep bits are the same hash on both devices).  bf16 at full
    width: the kernels on the card against the plain twins, on the CPU or,
    where the model's GRAD_CONDITIONS entry says so, on the card (both
    deterministic; held to SPARSE_GRAD_TOL_BF16), beside the gap of all
    twins run on the card and, per wrapper, the gap with that wrapper alone
    on its kernel (the others on their twins) and with every wrapper but it
    on its kernel, the tensors that hold most of the gap, and the gap of
    the bf16 gradients (kernels and CPU twins) from the f32 gradients of the
    same weights on the CPU.  f32 on 16 graphs, card against CPU; f32 at
    full width without dropout, sparse against dense on the card on every
    pair of ``_layout_gaps``, held to the condition's limit, which its
    seeded fault must exceed.  Every number is reported before any is
    held."""
    import copy

    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.models.factory import get_model
    from cal_tpu_torch.train.steps import dropout_seeds
    from cal_tpu_torch.utils.config import Config

    cfg = Config(model=model, hidden=H, layers=LAYERS, dtype="bfloat16", seed=SEED)
    feat = sparse_test[0].x.shape[1]
    host = next(Loader(sparse_test, B, layout="sparse").host_batches())
    batch = host.to("cuda")
    net = get_model(cfg, feat, cfg.num_classes)
    seeds = dropout_seeds(net, SEED, 0)
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = _step_grads(torch, copy.deepcopy(net), host.to("cpu"), seeds)
    cpu_s = time.perf_counter() - t0
    ref32 = get_model(cfg.replace(dtype="float32"), feat, cfg.num_classes)
    ref32.load_state_dict(net.state_dict())
    _, grads_ref32 = _step_grads(torch, ref32, host.to("cpu"), seeds)
    net = net.to("cuda")
    loss_k, grads_k = _step_grads(torch, net, batch, seeds)
    bf16 = _grad_err(torch, grads_k, grads_cpu, None)
    # the twins' index_add_ in its deterministic mode on the card: the
    # breakdown does not move between runs
    torch.use_deterministic_algorithms(True, warn_only=True)
    with sparse_twins():
        loss_p, grads_p = _step_grads(torch, net, batch, seeds)
        base_again = _rel_l2(_step_grads(torch, net, batch, seeds)[1], grads_cpu)
    base = _rel_l2(grads_p, grads_cpu)
    labels = SPARSE_STEP_WRAPPERS[model]
    for label in labels:
        with sparse_twins([lb for lb in labels if lb != label]):
            alone = _rel_l2(_step_grads(torch, net, batch, seeds)[1], grads_cpu)
        with sparse_twins([label]):
            without = _rel_l2(_step_grads(torch, net, batch, seeds)[1], grads_cpu)
        emit({"phase": "sparse_grad_breakdown", "model": model, "wrapper": label,
              "kernel_alone_rel_l2": alone, "adds_to_twins_on_card": alone - base,
              "all_kernels_but_it_rel_l2": without, "twins_on_card_rel_l2": base,
              "all_kernels_rel_l2": bf16[0]})
    torch.use_deterministic_algorithms(False)

    m32 = get_model(cfg.replace(dtype="float32"), feat, cfg.num_classes)
    small = next(Loader(sparse_test[:16], 16, layout="sparse").host_batches())
    loss_cpu32, grads_cpu32 = _step_grads(torch, copy.deepcopy(m32), small.to("cpu"), seeds)
    m32 = m32.to("cuda")
    loss_gpu, grads_gpu = _step_grads(torch, m32, small.to("cuda"), seeds)
    f32 = _grad_err(torch, grads_gpu, grads_cpu32, None)
    condition = grad_condition(net)
    bf16_ref, layout_tol = GRAD_CONDITIONS[condition]
    gaps, first, fault = _layout_gaps(torch, sparse_test, cfg, feat)
    kernels_vs_card_twins = _rel_l2(grads_k, grads_p)
    emit({"phase": "sparse_grad_check", "model": model, "dropout": seeds is not None,
          "bf16_loss_kernels": loss_k, "bf16_loss_cpu_twins": loss_cpu,
          "bf16_loss_card_twins": loss_p, "bf16_rel_l2_err": bf16[0],
          "bf16_worst_tensor": bf16[1], "bf16_card_twins_rel_l2_err": [base, base_again],
          "bf16_kernels_vs_card_twins_rel_l2": kernels_vs_card_twins,
          "bf16_err_shares": _err_shares(grads_k, grads_cpu),
          "bf16_kernels_vs_f32_rel_l2": _rel_l2(grads_k, grads_ref32),
          "bf16_cpu_twins_vs_f32_rel_l2": _rel_l2(grads_cpu, grads_ref32),
          "bf16_tol": SPARSE_GRAD_TOL_BF16, "cpu_step_s": cpu_s,
          "f32_loss_card": loss_gpu, "f32_loss_cpu": loss_cpu32,
          "f32_rel_l2_err": f32[0], "f32_worst_tensor": f32[1], "f32_graphs": 16,
          "f32_tol": GRAD_TOL["float32"], "condition": condition, "bf16_reference": bf16_ref,
          "f32_sparse_vs_dense": [{"seed": sd, "batch": i, "rel_l2": gap, "one_ulp_probe": pr}
                                  for sd, i, gap, pr in gaps],
          "f32_sparse_vs_dense_worst_tensor": _grad_err(torch, *first, None)[1],
          "f32_sparse_vs_dense_err_shares": _err_shares(*first),
          "f32_sparse_vs_dense_tol": layout_tol, "seeded_fault_rel_l2": fault,
          "params": len(grads_k)})
    bf16_held = kernels_vs_card_twins if bf16_ref == "card_twins" else bf16[0]
    held = [(f"bf16 kernels vs {bf16_ref}", bf16_held, SPARSE_GRAD_TOL_BF16),
            ("f32 card vs CPU", f32[0], GRAD_TOL["float32"])]
    held += [(f"f32 sparse vs dense (seed {sd}, batch {i})", gap, layout_tol)
             for sd, i, gap, _ in gaps]
    for name, rel, tol in held:
        check(rel <= tol, f"{model} {name}: step gradients differ by {rel} (relative L2)")
    check(fault > layout_tol, f"{model}: the seeded fault reads {fault} (relative L2), "
          f"within the sparse-against-dense limit {layout_tol}")


def grad_condition(model) -> str:
    """The GRAD_CONDITIONS key of a model: a GIN layer feeds its BatchNorm
    lin1 of unnormalized neighbour sums."""
    from cal_tpu_torch.nn.layers import GINConvLayer

    if any(isinstance(m, GINConvLayer) for m in model.modules()):
        return "linear_into_batchnorm_on_sums"
    return "well_conditioned"


def _layout_gaps(torch, sparse_test, cfg, feat):
    """f32 step gradients without dropout, sparse against dense on the card,
    for each weight seed of LAYOUT_SEEDS on each of the first LAYOUT_BATCHES
    test batches: [(seed, batch, relative L2 gap, the gap that 1-ulp noise
    on every weight opens in the sparse gradients)]; the (sparse, dense)
    gradients of the first pair; and the gap on the first pair of the
    seeded fault (every 32nd edge of the sparse batch masked out)."""
    import dataclasses
    import itertools

    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.graph import to_dense
    from cal_tpu_torch.models.factory import get_model

    cut = lambda loader: list(itertools.islice(loader.host_batches(), LAYOUT_BATCHES))
    pairs = list(zip(cut(Loader(sparse_test, B, layout="sparse")), cut(Loader(sparse_test, B))))
    gaps, first, fault = [], None, None
    for seed in LAYOUT_SEEDS:
        m = get_model(cfg.replace(dtype="float32", seed=seed), feat, cfg.num_classes).to("cuda")
        for i, (sparse, dense) in enumerate(pairs):
            g = sparse.to("cuda")
            grads_s = _step_grads(torch, m, g)[1]
            grads_d = _step_grads(torch, m, to_dense(dense.to("cuda"), torch.float32))[1]
            gaps.append((seed, i, _rel_l2(grads_s, grads_d), _ulp_probe(torch, m, g, grads_s)))
            if first is None:
                first = (grads_s, grads_d)
                mask = g.edge_mask.clone()
                mask[31::32] = 0
                faulty = _step_grads(torch, m, dataclasses.replace(g, edge_mask=mask))[1]
                fault = _rel_l2(faulty, grads_d)
    return gaps, first, fault


def real_data():
    """SYNREDDIT (2,000 REDDIT-BINARY-shaped threads) written by the repo's
    NumPy generator, in a subprocess, into build/, then read and expanded
    ('deg+odeg10') by the port's TU reader.  Returns (root, dataset)."""
    import shutil

    from cal_tpu_torch.data.datasets import create_n_filter_triples, get_dataset

    root = os.path.join(HERE, "build", "chip_smoke_real")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "benchmarks.gen_reddit_synthetic", "--root", root],
                   cwd=HERE, check=True, capture_output=True, text=True, timeout=600)
    t1 = time.perf_counter()
    (name, feat_str, _), = create_n_filter_triples(["SYNREDDIT"])
    ds = get_dataset(name, feat_str=feat_str, root=root)
    ns = [g.num_nodes for g in ds]
    es = [g.num_edges for g in ds]
    emit({"phase": "real_data", "dataset": name, "feat_str": feat_str, "graphs": len(ds),
          "features": ds.num_features, "classes": ds.num_classes,
          "nodes_mean": statistics.mean(ns), "nodes_max": max(ns), "edges_max": max(es),
          "generate_s": t1 - t0, "read_s": time.perf_counter() - t1})
    check(len(ds) == 2000 and ds.num_classes == 2, f"SYNREDDIT has {len(ds)} graphs")
    return root, ds


def edge_keep_probe(torch, bsz, n):
    """The forward kernel's keep bits, read off a probe batch, against the
    twin's bit for bit.  Each graph's receivers r < n/2 take one edge from
    sender n/2 + r; ti = tj = 0, so edge and self term weigh 1/2 each; xh is
    0 on receivers and 1 on senders, so a receiver's head-h output is
    keep(slot, h) * scale / 2 and a sender's (no edges) keep_self * scale."""
    from cal_tpu_torch.ops.edge_gat import edge_gat_fwd, edge_keep

    half, d = n // 2, H // HEADS
    g = torch.arange(bsz, device="cuda").repeat_interleave(half)
    r = torch.arange(half, device="cuda").repeat(bsz)
    ef = ((g * n + r) * n + half + r).int()
    zeros = torch.zeros((bsz, n, HEADS), device="cuda")
    xh = torch.zeros((bsz, n, H), dtype=torch.bfloat16, device="cuda")
    xh[:, half:] = 1.0
    out = edge_gat_fwd(zeros, zeros, xh, ef, DROP_SEED, GAT_RATE).float().view(bsz, n, HEADS, d)
    scale = 1.0 / (1.0 - GAT_RATE)
    vals = set(out.unique().tolist())
    check(vals <= {0.0, scale / 2, scale}, f"edge keep probe values {sorted(vals)[:8]}")
    keep_e, keep_v = edge_keep(torch.arange(bsz * half, device="cuda"), bsz * n, HEADS,
                               DROP_SEED, GAT_RATE)
    got_e = (out[:, :half, :, 0] > 0).reshape(-1, HEADS)
    got_v = (out[:, half:, :, 0] > 0).reshape(-1, HEADS)
    want_v = keep_v.view(bsz, n, HEADS)[:, half:].reshape(-1, HEADS)
    check(bool((out == out[..., :1]).all()), "a head's columns disagree on their keep bit")
    check(torch.equal(got_e, keep_e), "edge kernel slot keep bits differ from the twin's")
    check(torch.equal(got_v, want_v), "edge kernel self-term keep bits differ from the twin's")
    emit({"phase": "edge_keep_bits", "slot_bits": keep_e.numel(), "self_bits": want_v.numel(),
          "equal": True, "keep_fraction_slots": float(got_e.float().mean()),
          "keep_fraction_self": float(got_v.float().mean()), "rate": GAT_RATE})


def edge_inputs(torch, batch, dt):
    """Seeded (ti, tj, xh, g) of the edge GAT kernels on a dense batch in
    dtype ``dt``: xh and its cotangent g random, the score halves formed
    from xh as the layer forms them."""
    bsz, n, _ = batch.x.shape
    d = H // HEADS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    xh32 = torch.randn((bsz, n, H), generator=gen, device="cuda")
    att = (0.5 * torch.randn((HEADS, 2 * d), generator=gen, device="cuda"))
    g32 = torch.randn((bsz, n, H), generator=gen, device="cuda")
    xh, g = xh32.to(dt), g32.to(dt)
    x4 = xh.float().view(bsz, n, HEADS, d)
    ti = torch.einsum("bnhd,hd->bnh", x4, att.to(dt).float()[:, :d])
    tj = torch.einsum("bnhd,hd->bnh", x4, att.to(dt).float()[:, d:])
    return ti, tj, xh, g


def edge_layer_calls(eg, ti, tj, xh, ef, g, rate):
    """(forward, backward) of the edge GAT kernels as a layer's step calls
    them: over the batch's index, built once, the backward handed the
    forward's statistics, the seed as a captured step hands it over."""
    import torch

    seed = timed_seed(torch, DROP_SEED, DROP_SEED)
    idx = eg.EdgeIndex(ef, *ti.shape[:2]).build()
    stats = eg.edge_gat_fwd(ti, tj, xh, ef, seed, rate, idx, with_stats=True)[1]
    return (lambda: eg.edge_gat_fwd(ti, tj, xh, ef, seed, rate, idx, with_stats=True),
            lambda: eg.edge_gat_bwd(ti, tj, xh, ef, g, seed, rate, idx, stats))


def edge_index_line(torch, ef, bsz, n, flush) -> dict:
    """The per-batch edge index (ops/edge_gat.py EdgeIndex): its build
    timed on its own (cold L2), its list sizes, and whether the kernels'
    build equals the plain build."""
    from cal_tpu_torch.ops import edge_gat as eg

    idx = eg.EdgeIndex(ef, bsz, n).build()
    counts = idx.counts.tolist()
    same = idx.as_lists() == eg.EdgeIndex(ef, bsz, n).build_plain().as_lists()
    check(same, "the edge index the kernels build differs from the plain build")
    build = lambda: eg.EdgeIndex(ef, bsz, n).build()
    return {"phase": "edge_index", "root": HERE, "batch": [bsz, n], "slots": int(ef.shape[0]),
            "ms": time_ms(torch, build, flush), "passes": profile_passes(torch, build),
            "light_r": counts[0], "heavy_r_chunks": counts[1], "light_s": counts[2],
            "heavy_s_chunks": counts[3], "equals_plain_build": same}


def edge_slot_nodes(torch, ef, bsz, n):
    """(receivers, nodes) with a slot: the counts of the nodes that hold a
    live slot other than a self loop as receiver, and either way.  Only
    their rows of xh and of the forward's statistics enter the walks; the
    other nodes' outputs follow from their logits and xh or g alone."""
    from cal_tpu_torch.ops.edge_gat import edge_slots

    _, rv, sv = edge_slots(ef, bsz, n)
    used = torch.zeros(bsz * n, dtype=torch.bool, device=ef.device)
    used[rv] = True
    recv = int(used.sum())
    used[sv] = True
    return recv, int(used.sum())


def edge_kernel_rows(torch, batch, peaks, flush, rates=(GAT_RATE,), autograd=True):
    """The edge-formulated GAT kernels (csrc/edge_gat.cu, edge_gat_bwd.cu) on
    a dense SYNREDDIT batch (B = 128, N = 3,840): forward and backward
    against their twins in bf16 and f32 at dropout 0 and GAT_RATE (``autograd``:
    the f32 backward also against autograd of the forward twin, and the keep
    bits bit for bit); timed at each of ``rates`` as a layer's step calls
    them (over the batch's index; the backward handed the forward's
    statistics), the forward also building its own index (``kernel_ms_own_index``),
    beside the twins; the index's own line.  The bounds count what each
    call must move: the forward reads ti, tj, xh and the live slots and
    writes out and the statistics of the receivers with slots; the backward
    reads ti, tj, g, the live slots, xh only of the nodes with a slot either
    way and the statistics only of the receivers with slots, and writes
    dti, dtj and dxh.  No single PyTorch call computes the masked
    multiplicity softmax with dropout, so there is no library time."""
    from cal_tpu_torch.ops import edge_gat as eg
    from cal_tpu_torch.ops.edge_gat import (
        edge_gat_bwd, edge_gat_bwd_plain, edge_gat_fwd, edge_gat_fwd_plain, edge_slots)

    bw, bf16_peak, f32_peak = peaks
    ef = batch.edge_flat
    bsz, n, _ = batch.x.shape
    live = int(edge_slots(ef, bsz, n)[0].numel())
    recv, slotted = edge_slot_nodes(torch, ef, bsz, n)
    none = ("none: no single PyTorch call computes the masked, multiplicity-weighted "
            "leaky-ReLU softmax over an edge list and its dropout")
    emit(edge_index_line(torch, ef, bsz, n, flush))
    rows = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        ti, tj, xh, g = edge_inputs(torch, batch, dt)
        errs = {"fwd": [], "bwd": []}
        for rate in (0.0, GAT_RATE):
            fwd, bwd = edge_layer_calls(eg, ti, tj, xh, ef, g, rate)
            out_p = edge_gat_fwd_plain(ti, tj, xh, ef, DROP_SEED, rate)
            for out_k in (fwd(), edge_gat_fwd(ti, tj, xh, ef, DROP_SEED, rate)):
                out_k = out_k[0] if isinstance(out_k, tuple) else out_k
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out_k.float()).all()),
                      f"edge forward {dt_name} not finite")
                err, over = max_excess(torch, out_k, out_p, *EDGE_X_TOL[dt_name])
                check(over <= 0, f"edge forward {dt_name} rate {rate} differs from its twin: {err}")
                errs["fwd"].append(err)
            bp = edge_gat_bwd_plain(ti, tj, xh, ef, g, DROP_SEED, rate)
            for bk in (bwd(), edge_gat_bwd(ti, tj, xh, ef, g, DROP_SEED, rate)):
                torch.cuda.synchronize()
                for nm, a, r in zip(("dti", "dtj", "dxh"), bk, bp):
                    tol = EDGE_X_TOL[dt_name] if nm == "dxh" else EDGE_T_TOL
                    check(bool(torch.isfinite(a.float()).all()),
                          f"edge backward {dt_name} {nm} not finite")
                    err, over = max_excess(torch, a, r, *tol)
                    check(over <= 0, f"edge backward {dt_name} rate {rate} {nm} differs from "
                                     f"its twin: {err}")
                    errs["bwd"].append(err)
        extra = {}
        if autograd and dt == torch.float32:
            leaves = [t.clone().requires_grad_() for t in (ti, tj, xh)]
            out = edge_gat_fwd_plain(*leaves, ef, DROP_SEED, GAT_RATE)
            auto = torch.autograd.grad((out * g).sum(), leaves)
            auto_err = []
            for nm, a, r in zip(("dti", "dtj", "dxh"), bk, auto):
                tol = EDGE_X_TOL[dt_name] if nm == "dxh" else EDGE_T_TOL
                err, over = max_excess(torch, a, r, *tol)
                check(over <= 0, f"edge backward f32 {nm} differs from autograd: {err}")
                auto_err.append(err)
            extra["max_abs_err_vs_autograd"] = max(auto_err)
            del leaves, out, auto
        elt = xh.element_size()
        plane, stats, row_stats = bsz * n * H * elt, bsz * n * HEADS * 4, 2 * HEADS * 4
        peak = bf16_peak if dt == torch.bfloat16 else f32_peak
        for rate in rates:
            fwd, bwd = edge_layer_calls(eg, ti, tj, xh, ef, g, rate)
            for name, fn, plain, nbytes, flops, err in (
                    ("edge_gat_fwd", fwd,
                     lambda: edge_gat_fwd_plain(ti, tj, xh, ef, DROP_SEED, rate),
                     2 * stats + live * 4 + 2 * plane + recv * row_stats,
                     live * (2 * H + 8 * HEADS), max(errs["fwd"])),
                    ("edge_gat_bwd", bwd,
                     lambda: edge_gat_bwd_plain(ti, tj, xh, ef, g, DROP_SEED, rate),
                     4 * stats + live * 4 + 2 * plane + slotted * H * elt + recv * row_stats,
                     live * (4 * H + 16 * HEADS), max(errs["bwd"]))):
                t_bytes, t_ops = nbytes / bw, flops / peak
                row = {"name": name, "dtype": dt_name, "rate": rate, "max_abs_err": err,
                       "kernel_ms": time_ms(torch, fn, flush),
                       "plain_ms": time_ms(torch, plain, flush),
                       "library_ms": None, "library_call": none, "bytes": nbytes, "flops": flops,
                       "bound_ms": max(t_bytes, t_ops) * 1e3,
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "batch": [bsz, n, H], "slots": int(ef.shape[0]), "live_edges": live,
                       "receivers_with_slots": recv, "nodes_with_slots": slotted, "root": HERE}
                if rate == GAT_RATE:   # device ms by kernel, warm
                    row["passes"] = profile_passes(torch, fn)
                if name == "edge_gat_fwd":
                    row["kernel_ms_own_index"] = time_ms(
                        torch, lambda: edge_gat_fwd(ti, tj, xh, ef, DROP_SEED, rate), flush)
                    if rate > 0:
                        row["kernel_ms_rate0"] = time_ms(torch, edge_layer_calls(
                            eg, ti, tj, xh, ef, g, 0.0)[0], flush)
                else:
                    row.update(extra)
                emit({"phase": "kernel", **row})
                rows.setdefault(dt_name, {})[name] = row
    if autograd:
        edge_keep_probe(torch, bsz, n)
    return rows


def edge_digests(torch, batch) -> dict:
    """sha256 of the edge GAT kernels' outputs (out, dti, dtj, dxh) on the
    seeded inputs of ``edge_inputs`` over a dense batch, bf16 and f32, at
    dropout 0 and GAT_RATE: of each whole output, and (``_empty``) of its
    rows on the nodes without a live slot either way, whose bits no
    redesign of the walk may move.  The calls are the public ones, so
    another tree's digests come from this function with its package
    (``--digests``, ``--edge``)."""
    from cal_tpu_torch.ops import edge_gat as eg

    ef = batch.edge_flat
    bsz, n, _ = batch.x.shape
    live = ef[(ef >= 0) & (ef < bsz * n * n)].long()
    used = torch.zeros(bsz * n, dtype=torch.bool, device=ef.device)
    used[live // n] = True
    used[live // (n * n) * n + live % n] = True
    out = {"empty_nodes": int((~used).sum())}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        ti, tj, xh, g = edge_inputs(torch, batch, dt)
        for rate in (0.0, GAT_RATE):
            res = (eg.edge_gat_fwd(ti, tj, xh, ef, DROP_SEED, rate),
                   *eg.edge_gat_bwd(ti, tj, xh, ef, g, DROP_SEED, rate))
            for name, t in zip(("out", "dti", "dtj", "dxh"), res):
                flat = t.reshape(bsz * n, -1)
                out[f"edge_{name}_{dt_name}_{rate}"] = _digest([flat])
                out[f"edge_{name}_{dt_name}_{rate}_empty"] = _digest([flat[~used]])
    return out


def _digest(ts) -> str:
    """sha256 of tensors' values as f32, its first 16 hex digits."""
    import hashlib

    digest = hashlib.sha256()
    for x in ts:
        digest.update(x.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def forward_split(torch, fn, tries=3) -> dict:
    """Device ms of one warm call of a dense forward, by pass: the degree
    pass (which reads adj in full) and the aggregate, each launched once a
    call (torch.profiler; ms a launch, so a launch the profiler missed does
    not count).  A window in which the profiler recorded no launch of a pass
    is taken again, up to ``tries`` windows; a pass still unrecorded reads
    None, never 0."""
    keys = ("degree_", "aggregate_")
    for _ in range(tries):
        rows = profile_passes(torch, fn)
        got = {k: [r["ms_per_launch"] for r in rows if k in r["kernel"]] for k in keys}
        if all(got.values()):
            break
    return {"degree_ms": sum(got["degree_"]) if got["degree_"] else None,
            "aggregate_ms": sum(got["aggregate_"]) if got["aggregate_"] else None,
            "passes": rows}


def live_tiles(torch, edge_flat, bsz, n) -> int:
    """The live map's 64 x 32 cells of a dense batch that hold an edge other
    than a self loop, counted from its flat edge list: the cells of adj that
    a kernel handed the map must read."""
    e = edge_flat.long()
    e = e[(e >= 0) & (e < bsz * n * n)]
    b, r, c = e // (n * n), e // n % n, e % n
    cell = (b * -(-n // 64) + r // 64) * -(-n // 32) + c // 32
    return int(torch.unique(cell[r != c]).numel())


def dense_rows_at_scale(torch, batch, peaks, flush, slice_graphs=8):
    """Rows 1, 2 and 2b (adjacency build, dual masked-GCN forward and
    backward) at the SYNREDDIT node budget, N = 3,840: the kernels timed on
    the whole batch (B = 128); held against the twins, and the twins timed,
    on the first ``slice_graphs`` graphs, since the twins' f32 [B, N, N]
    planes would need ~100 GB at B = 128.  Row 2's line splits its device
    time into the degree pass and the aggregate; row 2b's is timed as the
    training step runs it, handed what the forward hands it (``kernel_ms``;
    its bound counts adj's bytes in the live cells only, since that is all
    such a call must read), and alone (``kernel_ms_own_degree``: its own
    degree pass, a full read of adj, in ``bound_ms_own_degree``).  All
    three carry digests of their outputs on the whole batch, row 1 the warm
    device ms of each kernel a call launches (``passes``).  Returns the three
    lines (the caller emits them)."""
    from cal_tpu_torch.ops import fused_gcn as fg
    from cal_tpu_torch.ops.adj_build import adj_build, adj_build_plain

    bw, bf16_peak, _ = peaks
    ef = batch.edge_flat
    bsz, n, _ = batch.x.shape
    dt, k = torch.bfloat16, slice_graphs
    adj = adj_build(ef, bsz, n, dt)
    check(torch.equal(adj, adj_build_plain(ef, bsz, n, dt)), "adj_build at N = 3,840 differs")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dt)
    xc, xo, gc, go = (rand(bsz, n, H) for _ in range(4))
    src, dst = rand(bsz, n), (2.0 * rand(bsz, n)).to(dt)
    args, bargs = (xc, xo, adj, src, dst), (xc, xo, adj, src, dst, gc, go)
    cut = lambda ts: tuple(t[:k].contiguous() for t in ts)
    errs = []
    for got, ref, tol in ((fg.fused_gcn_dense_att_dual(*cut(args)),
                           fg.fused_gcn_dense_att_dual_plain(*cut(args)), DUAL_TOL["bfloat16"]),
                          (fg.fused_gcn_dense_att_dual_bwd(*cut(bargs),
                                                           *fg._dual_fwd(*cut(args))[1:]),
                           fg.fused_gcn_dense_att_dual_bwd_plain(*cut(bargs)),
                           DUAL_BWD_TOL["bfloat16"])):
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            check(bool(torch.isfinite(a.float()).all()), "dual kernel at N = 3,840 not finite")
            err, over = max_excess(torch, a, r, *tol)
            check(over <= 0, f"dual kernel at N = 3,840 differs from its twin: {err}")
            errs.append(err)
    handed = fg._dual_fwd(*args)[1:]   # what the forward hands its backward
    own = fg.fused_gcn_dense_att_dual_bwd(*bargs)
    check(all(torch.equal(a, b) for a, b in zip(
        fg.fused_gcn_dense_att_dual_bwd(*bargs, *handed), own)),
        "row 2b at N = 3,840: the hand-over changed the bits")
    digests = {"adj_build": _digest([adj]),
               "fused_gcn_dense_att_dual_fwd": _digest(fg.fused_gcn_dense_att_dual(*args)),
               "fused_gcn_dense_att_dual_bwd": _digest(own)}
    del own
    def bincount_at_scale() -> dict:
        # the library call of row 1: int64 counts of every cell, 15 GB at B 128
        ef64 = ef.long()
        counts = torch.bincount(ef64, minlength=cells + 1)
        check(torch.equal(counts[:cells].view(bsz, n, n).to(dt), adj),
              "torch.bincount at N = 3,840 differs from adj_build")
        del counts
        ms = time_ms(torch, lambda: torch.bincount(ef64, minlength=cells + 1), flush, 3, 1)
        torch.cuda.empty_cache()
        return {"library_ms": ms,
                "library_call": "torch.bincount(edge_flat.long(), minlength=B*N*N+1)"}

    extra = {
        "adj_build": lambda: {"passes": profile_passes(torch, lambda: adj_build(ef, bsz, n, dt)),
                              **bincount_at_scale()},
        "fused_gcn_dense_att_dual_fwd": lambda: forward_split(
            torch, lambda: fg.fused_gcn_dense_att_dual(*args)),
        "fused_gcn_dense_att_dual_bwd": lambda: {
            "kernel_ms_own_degree": time_ms(
                torch, lambda: fg.fused_gcn_dense_att_dual_bwd(*bargs), flush, 3, 1),
            "bytes_own_degree": cells * elt + b_rest,
            "bound_ms_own_degree": max((cells * elt + b_rest) / bw,
                                       12 * live_cells(batch) * H / bf16_peak) * 1e3,
            "handed": len(handed),
            "passes": profile_passes(torch, lambda: fg.fused_gcn_dense_att_dual_bwd(
                *bargs, *handed)),
            "passes_own_degree": profile_passes(
                torch, lambda: fg.fused_gcn_dense_att_dual_bwd(*bargs))},
    }
    elt, e = 2, ef.shape[0]
    cells = bsz * n * n
    # row 2b beside adj: the x, g and dx planes, the logits and their
    # gradients; handed, the statistics (f32) and the live map besides
    b_rest = (6 * bsz * n * H + 4 * bsz * n) * elt
    b_handed = (live_tiles(torch, ef, bsz, n) * 64 * 32 * elt + b_rest + 4 * bsz * n * 4
                + bsz * -(-n // 64) * -(-n // 32))
    lines = []
    for name, fn, plain, nbytes, flops, reps in (
            ("adj_build", lambda: adj_build(ef, bsz, n, dt),
             lambda: adj_build_plain(ef[:int((ef < k * n * n).sum())], k, n, dt),
             e * 4 + cells * elt, 0, 10),
            ("fused_gcn_dense_att_dual_fwd", lambda: fg.fused_gcn_dense_att_dual(*args),
             lambda: fg.fused_gcn_dense_att_dual_plain(*cut(args)),
             (cells + 4 * bsz * n * H + 2 * bsz * n) * elt, 4 * cells * H, 10),
            ("fused_gcn_dense_att_dual_bwd",
             lambda: fg.fused_gcn_dense_att_dual_bwd(*bargs, *handed),
             lambda: fg.fused_gcn_dense_att_dual_bwd_plain(*cut(bargs)),
             b_handed, 12 * live_cells(batch) * H, 3)):
        t_bytes, t_ops = nbytes / bw, flops / bf16_peak
        line = {"phase": "dense_kernel_n3840", "name": name, "dtype": "bfloat16",
                "batch": [bsz, n, H], "kernel_ms": time_ms(torch, fn, flush, reps, 1),
                "plain_ms_on_slice": time_ms(torch, plain, flush, 3, 1), "slice_graphs": k,
                "max_abs_err_on_slice": max(errs) if name != "adj_build" else 0.0,
                "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if name in extra:
            line.update(extra[name]())
            line["digest"] = digests[name]
        lines.append(line)
    del adj, xc, xo, gc, go
    torch.cuda.empty_cache()
    return lines


# the N = 3,840 kernel lines -> their counter in real_protocol_phase
REAL_COUNTER = {"adj_build": "adj_build",
                "fused_gcn_dense_att_dual_fwd": "fused_gcn_dense_att_dual",
                "fused_gcn_dense_att_dual_bwd": "fused_gcn_dense_att_dual_bwd"}


def real_counters() -> dict:
    """The launch-counted wrappers of the dense CausalGAT training path."""
    from cal_tpu_torch.ops.adj_build import adj_build
    from cal_tpu_torch.ops.edge_gat import edge_gat_bwd, edge_gat_fwd
    from cal_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd
    from cal_tpu_torch.ops.fused_gcn import fused_gcn_dense_att_dual, fused_gcn_dense_att_dual_bwd

    return {k.__name__: k for k in (adj_build, fused_gcn_dense_att_dual,
                                    fused_gcn_dense_att_dual_bwd, flash_gat_fwd, flash_gat_bwd,
                                    edge_gat_fwd, edge_gat_bwd)}


def real_protocol_phase(torch, root, ds) -> dict:
    """``python -m cal_tpu_torch.main_real --model CausalGAT --dataset SYNREDDIT
    --dtype bfloat16`` at full width (hidden 128, 3 layers, batch 128, 4
    heads, dropout 0.2; N = 3,840) on REAL_FOLDS folds of REAL_EPOCHS epochs,
    the counters at 0 just before: exact launches (per forward one
    adjacency build, one dual conv and LAYERS edge forwards; per step one
    dual backward and LAYERS edge backwards; no flash), finite losses, the
    sydall line; epoch seconds and peak device memory."""
    import contextlib
    import io

    import numpy as np

    from cal_tpu_torch.data.kfold import k_fold
    from cal_tpu_torch.main_real import main

    kernels = real_counters()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = main(["--model", "CausalGAT", "--dataset", "SYNREDDIT", "--dtype", "bfloat16",
                    "--folds", str(REAL_FOLDS), "--epochs", str(REAL_EPOCHS),
                    "--data_root", root, "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log = buf.getvalue()
    print("\n".join(ln for ln in log.splitlines() if "|" in ln or "=" * 20 in ln), flush=True)
    launches = {name: k.launches for name, k in kernels.items()}
    train_idx, test_idx, _ = k_fold(np.array([g.y for g in ds]), REAL_FOLDS, "test_max")
    steps = REAL_EPOCHS * sum(-(-len(t) // B) for t in train_idx)
    fwd = steps + REAL_EPOCHS * sum(-(-len(t) // B) for t in test_idx)
    want = {"adj_build": fwd, "fused_gcn_dense_att_dual": fwd,
            "fused_gcn_dense_att_dual_bwd": steps, "flash_gat_fwd": 0, "flash_gat_bwd": 0,
            "edge_gat_fwd": LAYERS * fwd, "edge_gat_bwd": LAYERS * steps}
    check(launches == want, f"main_real launches {launches} != {want}")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == REAL_FOLDS * REAL_EPOCHS and all(map(math.isfinite, losses)),
          f"main_real losses {losses}")
    check("sydall Final: Causal | Dataset:[SYNREDDIT]" in log, "main_real printed no sydall line")
    emit({"phase": "real_protocol", "model": "CausalGAT", "dataset": "SYNREDDIT",
          "folds": REAL_FOLDS, "epochs": REAL_EPOCHS, "hidden": H, "layers": LAYERS,
          "batch": B, "dtype": "bfloat16", "steps": steps, "forwards": fwd,
          "launches": launches, "losses": losses,
          "epoch_seconds": [h["seconds"] for h in hist],
          "train_seconds": [h["train_seconds"] for h in hist],
          "wall_s": wall, "peak_device_memory_gb": peak / 1e9,
          "result": {k: v for k, v in res.items() if k != "history"}})
    return launches


def crossover_sweep(torch, flush):
    """Flash against edge-formulated GAT, forward plus backward, bf16 at
    dropout GAT_RATE, B = 128, on random graphs of N nodes with Eg' edges
    each (SWEEP_SHAPES).  It informs the switch; the port keeps cal_tpu's
    v5e rule, whose verdict is printed beside each shape."""
    from types import SimpleNamespace

    import numpy as np

    from cal_tpu_torch.nn.layers import takes_edge_kernel
    from cal_tpu_torch.ops.adj_build import adj_build
    from cal_tpu_torch.ops.edge_gat import edge_gat_bwd, edge_gat_fwd
    from cal_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd

    d = H // HEADS
    for n, eg in SWEEP_SHAPES:
        rng = np.random.default_rng(n + eg)
        r, s = rng.integers(0, n, (B, eg)), rng.integers(0, n, (B, eg))
        keys = np.sort(((np.arange(B)[:, None] * n + r) * n + s).ravel())
        ef = torch.from_numpy(keys.astype(np.int32)).to("cuda")
        counts = adj_build(ef, B, n, torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(n)
        xh = torch.randn((B, n, H), generator=gen, device="cuda").to(torch.bfloat16)
        att = 0.5 * torch.randn((HEADS, 2 * d), generator=gen, device="cuda")
        x4 = xh.float().view(B, n, HEADS, d)
        ti = torch.einsum("bnhd,hd->bnh", x4, att[:, :d])
        tj = torch.einsum("bnhd,hd->bnh", x4, att[:, d:])
        g = torch.randn((B, n, H), generator=gen, device="cuda")
        gb = g.to(torch.bfloat16)
        _, m, den = flash_gat_fwd(ti, tj, counts, xh, DROP_SEED, GAT_RATE)
        reps = 3 if n >= 1024 else 20
        t = {"flash_fwd_ms": time_ms(torch, lambda: flash_gat_fwd(
                 ti, tj, counts, xh, DROP_SEED, GAT_RATE), flush, reps, 1),
             "flash_bwd_ms": time_ms(torch, lambda: flash_gat_bwd(
                 ti, tj, counts, xh, m, den, g, DROP_SEED, GAT_RATE), flush, reps, 1),
             "edge_fwd_ms": time_ms(torch, lambda: edge_gat_fwd(
                 ti, tj, xh, ef, DROP_SEED, GAT_RATE), flush, reps, 1),
             "edge_bwd_ms": time_ms(torch, lambda: edge_gat_bwd(
                 ti, tj, xh, ef, gb, DROP_SEED, GAT_RATE), flush, reps, 1)}
        flash = t["flash_fwd_ms"] + t["flash_bwd_ms"]
        edge = t["edge_fwd_ms"] + t["edge_bwd_ms"]
        rule = takes_edge_kernel(SimpleNamespace(edge_flat=ef, eg_budget=eg), n)
        emit({"phase": "gat_crossover", "n": n, "eg": eg, "batch": B, "dtype": "bfloat16",
              "rate": GAT_RATE, **t, "flash_ms": flash, "edge_ms": edge,
              "faster": "edge" if edge < flash else "flash",
              "v5e_rule_takes": "edge" if rule else "flash"})
        del counts, ef, xh, g, gb, m, den
    torch.cuda.empty_cache()


def _sig_coefs(torch, g, src, dst, dis, negate):
    """Per-edge coefficients dis[s] w dis[r] of the single sigmoid branch
    (dead edges 0), for the library calls."""
    s, r = g.senders.long(), g.receivers.long()
    live = (g.edge_mask & (s != r)).float()
    sig = torch.sigmoid(src.float()[s] + dst.float()[r])
    return dis[s] * ((1.0 - sig) if negate else sig) * dis[r] * live


def sigmoid_kernel_rows(torch, g, label, peaks, flush):
    """K13-K16 (row 12) against their twins on one sparse batch ``g`` (on the
    card), x in bf16 and f32 with f32 logits (config 4's), ``negate`` both
    ways, with their times (K13's, K15's and K16's also with the warm device
    ms of each kernel a call launches, ``passes``); returns {(dtype, negate):
    {kernel: row}}."""
    from cal_tpu_torch.ops import spmm

    bw, _, f32_peak = peaks
    v, e = g.num_nodes, g.senders.shape[0]
    n_live = int((g.edge_mask & (g.senders != g.receivers)).sum())
    csr = lambda c: 4 * (2 * (v + 1) + c.num_chunks)          # ptr, chunk_ptr, chunk_row
    out = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
        x, gout = (torch.randn((v, H), generator=gen, device="cuda").to(dt) for _ in range(2))
        src = torch.randn(v, generator=gen, device="cuda")
        dst = 2.0 * torch.randn(v, generator=gen, device="cuda")
        ddeg = torch.randn(v, generator=gen, device="cuda")
        for negate in (False, True):
            rows = {}

            def row(name, fn, plain, nbytes, flops, err, tol, lib_fn=None, lib_call=None):
                t_bytes, t_ops = nbytes / bw, flops / f32_peak
                r = {"name": name, "batch": label, "dtype": dt_name, "negate": negate,
                     "max_abs_err": err, "atol": tol[0], "rtol": tol[1],
                     "kernel_ms": time_ms(torch, fn, flush),
                     "plain_ms": time_ms(torch, plain, flush),
                     "library_ms": None if lib_fn is None else time_ms(torch, lib_fn, flush),
                     "library_call": lib_call, "bytes": nbytes, "flops": flops,
                     "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "nodes": v, "edges": e, "live_edges": n_live}
                if name in ("sigmoid_sender_degree", "sigmoid_sddmm_chain", "sigmoid_dpre"):
                    r["passes"] = profile_passes(torch, fn)
                emit({"phase": "sigmoid_kernel", **r})
                rows[name] = r

            def held(name, got, ref, tol):
                got = (got,) if torch.is_tensor(got) else got
                ref = (ref,) if torch.is_tensor(ref) else ref
                torch.cuda.synchronize()
                errs = []
                for a, b in zip(got, ref, strict=True):
                    check(a.dtype == b.dtype and a.shape == b.shape, f"{name} {dt_name} misshapen")
                    check(bool(torch.isfinite(a.float()).all()),
                          f"{name} {dt_name} negate={negate} on {label} not finite")
                    err, over = max_excess(torch, a, b, *tol)
                    check(over <= 0, f"{name} {dt_name} negate={negate} on {label} differs "
                          f"from its plain twin: {err}")
                    errs.append(err)
                return max(errs)

            deg, dis = spmm.sigmoid_sender_degree_plain(src, dst, g, negate)
            got = spmm.sigmoid_sender_degree(src, dst, g, negate)
            check(torch.equal(got[1], torch.rsqrt(got[0])),
                  f"K13's dis {dt_name} negate={negate} on {label} differs from torch.rsqrt")
            err = held("sigmoid_sender_degree", got, (deg, dis), DEG_TOL)
            row("sigmoid_sender_degree", lambda: spmm.sigmoid_sender_degree(src, dst, g, negate),
                lambda: spmm.sigmoid_sender_degree_plain(src, dst, g, negate),
                2 * v * 4 + 9 * e + csr(g.send) + 2 * v * 4, 4 * n_live, err, DEG_TOL,
                None, "none: no single PyTorch call computes the sigmoid-weighted sender sums")
            tol = SPARSE_TOL[dt_name]
            coef = _sig_coefs(torch, g, src, dst, dis, negate)
            for name, inp, transpose in (("sigmoid_coef_spmm", x, False),
                                         ("sigmoid_coef_spmm_t", gout, True)):
                fn = getattr(spmm, name)
                err = held(name, fn(inp, src, dst, deg, dis, g, negate),
                           spmm.sigmoid_coef_spmm_plain(inp, src, dst, deg, dis, g, negate,
                                                        transpose), tol)
                lib = (_library_spmm_t if transpose else _library_spmm)(torch, g, [coef], [inp])
                row(name, lambda: fn(inp, src, dst, deg, dis, g, negate),
                    lambda: spmm.sigmoid_coef_spmm_plain(inp, src, dst, deg, dis, g, negate,
                                                         transpose),
                    2 * v * H * elt + 2 * v * 4 + 2 * v * 4 + (9 if transpose else 5) * e
                    + csr(g.send if transpose else g.recv), 2 * H * n_live, err, tol, lib,
                    "torch.sparse.mm(CSR [V, V]" + (" transposed" if transpose else "")
                    + ", x), coefficients materialized outside the call, no self term")
            ref = spmm.sigmoid_sddmm_chain_plain(x, gout, src, dst, dis, g, negate)
            what = f"{dt_name} negate={negate} on {label}"
            err = held("sigmoid_sddmm_chain", repeated(
                torch, g, f"sigmoid_sddmm_chain {what}",
                lambda: spmm.sigmoid_sddmm_chain(x, gout, src, dst, dis, g, negate)),
                ref, CHAIN_TOL)
            row("sigmoid_sddmm_chain",
                lambda: spmm.sigmoid_sddmm_chain(x, gout, src, dst, dis, g, negate),
                lambda: spmm.sigmoid_sddmm_chain_plain(x, gout, src, dst, dis, g, negate),
                2 * v * H * elt + 2 * v * 4 + 4 * v + 9 * e + 8 * e + 8 * v
                + csr(g.recv) + csr(g.send), 2 * H * n_live, err, CHAIN_TOL,
                None, "none: no single PyTorch call computes the SDDMM with its chain values")
            vec = ref[0]
            err = held("sigmoid_dpre", repeated(
                torch, g, f"sigmoid_dpre {what}",
                lambda: spmm.sigmoid_dpre(vec, ddeg, g, negate)),
                spmm.sigmoid_dpre_plain(vec, ddeg, g, negate), CHAIN_TOL)
            row("sigmoid_dpre", lambda: spmm.sigmoid_dpre(vec, ddeg, g, negate),
                lambda: spmm.sigmoid_dpre_plain(vec, ddeg, g, negate),
                8 * e + 4 * v + 8 * e + 8 * v + csr(g.recv) + csr(g.send), 3 * n_live, err,
                CHAIN_TOL, None, "none: no single PyTorch call computes dpre with both sums")
            out[(dt_name, negate)] = rows
    return out


def sigmoid_counters() -> dict:
    from cal_tpu_torch.ops import spmm

    return {k: getattr(spmm, k) for k in SIGMOID_KERNEL_ROWS}


def packed_train_phase(torch, splits) -> dict:
    """``main_syn --model CausalGCN --layout sparse --pack_batches true`` at
    the canonical size for PACK_EPOCHS epochs, the counters at 0: exact K1-K7
    launches for the epoch's real batches (the trainer's loaders replayed:
    the same seeds give the same packed chunks) and none for its padding
    batches, falling losses."""
    import contextlib
    import io

    from cal_tpu_torch.main_syn import main
    from cal_tpu_torch.train.causal import make_loaders
    from cal_tpu_torch.utils.config import Config

    cfg = Config(model="CausalGCN", layout="sparse", pack_batches="true", batch_size=B,
                 seed=SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        train_l, val_l, test_l = make_loaders(*splits, cfg)
    real = lambda chunks: sum(len(c) > 0 for c in chunks)
    steps = sum(real(train_l._chunks()) for _ in range(PACK_EPOCHS))
    pads = PACK_EPOCHS * len(train_l) - steps
    evals = PACK_EPOCHS * (real(val_l._chunks()) + real(test_l._chunks()))
    counts = sparse_counters(training=True)
    for k in counts.values():
        k.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(["--model", "CausalGCN", "--layout", "sparse", "--pack_batches", "true",
                    "--dtype", "bfloat16", "--hidden", str(H), "--layers", str(LAYERS),
                    "--batch_size", str(B), "--data_num", str(SPARSE_DATA_NUM), "--seed",
                    str(SEED), "--epochs", str(PACK_EPOCHS), "--device", "cuda"])
    launches = {n: k.launches for n, k in counts.items()}
    want = sparse_want("CausalGCN", steps + evals, steps)
    check(launches == want, f"packed training launches {launches}, expected {want}")
    check("packed sparse budgets" in buf.getvalue(), "main_syn did not pack")
    losses = [h["loss"] for h in res["history"]]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"packed training losses {losses}")
    hist = res["history"]
    emit({"phase": "packed_training", "model": "CausalGCN", "epochs": PACK_EPOCHS,
          "budgets": {k: train_l.budgets[k] for k in ("node_budget", "edge_budget")},
          "steps_per_epoch": len(train_l), "schedule_steps": train_l.schedule_steps,
          "real_steps": steps, "pad_steps": pads, "eval_batches": evals,
          "launches": launches, "losses": losses,
          "epoch_seconds": [h["seconds"] for h in hist],
          "train_seconds": [h["train_seconds"] for h in hist],
          "test_acc_co": res["test_acc_co"], "test_acc_o": res["test_acc_o"]})
    return launches


def packed_real_phase(torch, root, ds) -> dict:
    """``main_real --model CausalGCN --dataset SYNREDDIT --layout sparse
    --dtype bfloat16`` (REAL_FOLDS folds of REAL_EPOCHS epochs; "auto" packs
    these heavy-tailed threads), the counters at 0: exact K1-K7 launches for
    the real batches of the replayed fold loaders, none for padding, the
    sydall line."""
    import contextlib
    import io

    import numpy as np

    from cal_tpu_torch.data.kfold import k_fold
    from cal_tpu_torch.data.loader import Loader, compute_budgets
    from cal_tpu_torch.main_real import main

    graphs = list(ds)
    budgets = compute_budgets(graphs, B, "sparse", pack=True)
    real = lambda chunks: sum(len(c) > 0 for c in chunks)
    steps = evals = 0
    train_idx, test_idx, _ = k_fold(np.array([g.y for g in graphs]), REAL_FOLDS, "test_max")
    for fold, (tr, te) in enumerate(zip(train_idx, test_idx)):
        tl = Loader([graphs[i] for i in tr], B, shuffle=True, budgets=budgets,
                    seed=SEED + fold, layout="sparse")
        tl._chunks()
        steps += sum(real(tl._chunks()) for _ in range(REAL_EPOCHS))
        te_l = Loader([graphs[i] for i in te], B, budgets=budgets, layout="sparse")
        evals += REAL_EPOCHS * real(te_l._chunks())
    counts = sparse_counters(training=True)
    for k in counts.values():
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = main(["--model", "CausalGCN", "--dataset", "SYNREDDIT", "--layout", "sparse",
                    "--dtype", "bfloat16", "--hidden", str(H), "--layers", str(LAYERS),
                    "--batch_size", str(B), "--folds", str(REAL_FOLDS), "--epochs",
                    str(REAL_EPOCHS), "--data_root", root, "--seed", str(SEED),
                    "--device", "cuda"])
    wall = time.perf_counter() - t0
    log = buf.getvalue()
    launches = {n: k.launches for n, k in counts.items()}
    want = sparse_want("CausalGCN", steps + evals, steps)
    check(launches == want, f"packed main_real launches {launches}, expected {want}")
    check("pack_batches auto: worst-case batch" in log, "main_real did not pack SYNREDDIT")
    check("sydall Final: Causal | Dataset:[SYNREDDIT]" in log, "main_real printed no sydall")
    losses = [h["loss"] for h in res["history"]]
    check(all(map(math.isfinite, losses)), f"packed main_real losses {losses}")
    emit({"phase": "packed_real_protocol", "model": "CausalGCN", "dataset": "SYNREDDIT",
          "folds": REAL_FOLDS, "epochs": REAL_EPOCHS, "budgets": budgets, "steps": steps,
          "eval_batches": evals, "launches": launches, "losses": losses,
          "epoch_seconds": [h["seconds"] for h in res["history"]],
          "train_seconds": [h["train_seconds"] for h in res["history"]], "wall_s": wall,
          "result": {k: v for k, v in res.items() if k != "history"}})
    return launches


def bench_phase(torch) -> dict:
    """``cal_tpu_torch.bench.main`` at BENCH_SCALE of its steps, the row-12
    counters at 0 just before: its four lines in order, each value finite and
    positive, and exactly one K13, K14, K14T, K15 and K16 launch per config-4
    kernel iteration (configs 1-3 train the causal models, whose convs take
    the pair kernels); then config 3's packed against worst-case-padded
    training on 256 REDDIT-shaped threads, in graphs/s."""
    import contextlib
    import io

    from cal_tpu_torch import bench

    counts = sigmoid_counters()
    for k in counts.values():
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        lines, results = bench.main(["--scale", str(BENCH_SCALE)])
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in counts.items()}
    print(buf.getvalue(), end="", flush=True)
    names = ["causal_train_edges_per_s", "causal_gat_train_edges_per_s",
             "sparse_pack_train_edges_per_s", "spmm_tiled_edges_per_s"]
    check([ln["metric"] for ln in lines] == names, f"bench lines {lines}")
    vals = [v for ln in lines for k, v in ln.items() if k not in ("metric", "unit")]
    check(all(math.isfinite(v) and v > 0 for v in vals), f"bench values {lines}")
    check(buf.getvalue().startswith("# device: "), "bench printed no card line first")
    iters = 2 * max(1, round(bench.SPMM_ITERS * BENCH_SCALE))
    check(all(n == iters for n in launches.values()),
          f"bench row-12 launches {launches}, expected {iters} each")
    emit({"phase": "bench", "scale": BENCH_SCALE, "lines": lines, "launches": launches,
          "kernel_iterations": iters, "wall_s": wall})
    r = dict(results["sparse_pack_train_edges_per_s"])
    worst = r.pop("worst")
    keys = ("edges_per_s", "steps", "seconds", "batches", "budgets")
    emit({"phase": "packed_vs_worst", "graphs": 256, "packed_graphs_per_s": r["graphs_per_s"],
          "worst_graphs_per_s": worst["graphs_per_s"],
          "speedup": r["graphs_per_s"] / worst["graphs_per_s"],
          "packed": {k: r[k] for k in keys}, "worst": {k: worst[k] for k in keys}})
    return launches


def parity_phase(torch) -> dict:
    """``cal_tpu_torch.parity.main`` in this process on the card at full
    size, every kernel counter at 0 just before: the eleven sections of
    benchmarks/parity_tpu.py, each kernel path against the port's plain
    reference, forward and gradients.  A failure ends the smoke (the
    entry point's SystemExit is not caught).  Returns the launches of the
    run by kernel; rows 3, 4 and 9 (and K12) must have launched."""
    from cal_tpu_torch import parity

    counts = all_counters()
    for k in counts.values():
        k.launches = 0
    t0 = time.perf_counter()
    results = parity.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in counts.items()}
    reached = [n for n in ROW_KERNEL_ROWS if n not in OFF_MAIN_PATH] + ["coo_sddmm"]
    check(all(launches[n] > 0 for n in reached), f"parity launches {launches}")
    check(launches["segment_max"] == 0, "the parity run launched K21")
    worst = {}
    for r in results:
        if "rel_max_err" in r:
            key = r["section"].split(" vs ")[0]
            worst[key] = max(worst.get(key, 0.0), r["rel_max_err"])
    emit({"phase": "parity", "seconds": wall, "checks": len(results),
          "worst_rel_max_err_by_section": worst, "launches": launches,
          "rows_3_4": {r["name"]: r["rel_max_err"] for r in results
                       if r["section"].startswith("fused dense GCN")}})
    return launches


def plain_cluster_plan() -> dict:
    """Row 4's cluster kernel on this card at the path's limit (N = 256, the
    dense batch's): dynamic shared memory (bytes) and the clusters resident
    at once (each walks B / clusters graphs)."""
    import ctypes

    from cal_tpu_torch.kernels import build
    from cal_tpu_torch.ops import fused_gcn as fg

    out = {}
    for k in ("K17", "K17T"):
        plan = (ctypes.c_longlong * 2)()
        build.check(fg._lib().gcn_plain_cluster_plan(fg.MAX_CLUSTER_N, int(k == "K17T"), plan),
                    "gcn_plain_cluster_plan")
        out[k] = {"n": fg.MAX_CLUSTER_N, "smem": plan[0], "clusters": plan[1]}
    return out


def all_counters() -> dict:
    """Every launch-counted kernel wrapper of the port, by row name."""
    from cal_tpu_torch.ops import (
        adj_build, coo_spmm, edge_gat, flash_gat, fused_gcn, gat_sparse, pool, spmm)

    mods = (adj_build, fused_gcn, flash_gat, edge_gat, spmm, pool, gat_sparse, coo_spmm)
    names = ([c for c, *_ in KERNEL_ROWS.values()] + list(SPARSE_KERNEL_ROWS)
             + list(SPARSE_BWD_KERNEL_ROWS) + list(GAT_KERNEL_ROWS) + list(COO_KERNEL_ROWS)
             + list(EDGE_KERNEL_ROWS) + list(SIGMOID_KERNEL_ROWS) + list(ROW_KERNEL_ROWS))
    out = {}
    for n in names:
        out[n] = next(getattr(m, n) for m in mods if hasattr(getattr(m, n, None), "launches"))
    return out


def _row(torch, name, dt_name, fn, plain, nbytes, flops, peak, err, tol, bw, flush,
         lib_fn=None, lib_call=None, **extra):
    t_bytes, t_ops = nbytes / bw, flops / peak
    r = {"name": name, "dtype": dt_name, "max_abs_err": err, "atol": tol[0], "rtol": tol[1],
         "kernel_ms": time_ms(torch, fn, flush), "plain_ms": time_ms(torch, plain, flush),
         "library_ms": None if lib_fn is None else time_ms(torch, lib_fn, flush),
         "library_call": lib_call, "bytes": nbytes, "flops": flops,
         "bound_ms": max(t_bytes, t_ops) * 1e3,
         "bound_by": "bytes" if t_bytes >= t_ops else "operations", **extra}
    emit({"phase": "row_kernel", **r})
    return r


def _held(torch, name, dt_name, got, ref, tol):
    torch.cuda.synchronize()
    check(got.dtype == ref.dtype and got.shape == ref.shape, f"{name} {dt_name} misshapen")
    check(bool(torch.isfinite(got.float()).all()), f"{name} {dt_name} not finite")
    err, over = max_excess(torch, got, ref, *tol)
    check(over <= 0, f"{name} {dt_name} differs from its plain twin: {err}")
    return err


def dense_row_kernels(torch, batch, peaks, flush):
    """Rows 4 and 3 (K17, K17T, K18, K18B) against their twins on the
    synthetic dense batch (B = 128, N = 256, H = 128), bf16 and f32, both
    ``negate``s, timed beside torch.bmm on a prebuilt normalized adjacency
    (rows 4); row 3 has no single PyTorch call.  Returns {dtype: {kernel:
    row}}."""
    from cal_tpu_torch.graph import to_dense
    from cal_tpu_torch.ops import fused_gcn as fg

    bw, bf16_peak, f32_peak = peaks
    bsz, n, _ = batch.x.shape
    out = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        peak = bf16_peak if dt == torch.bfloat16 else f32_peak
        adj = to_dense(batch, dt).adj
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
        x, g = (torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt) for _ in range(2))
        src = torch.randn((bsz, n), generator=gen, device="cuda").to(dt)
        dst = (2.0 * torch.randn((bsz, n), generator=gen, device="cuda")).to(dt)
        tol, btol = DUAL_TOL[dt_name], DUAL_BWD_TOL[dt_name]
        e17 = _held(torch, "K17", dt_name, fg._mm_fwd(x, adj), fg.fused_gcn_dense_plain(x, adj),
                    tol)
        e17t = _held(torch, "K17T", dt_name, fg.fused_gcn_dense_t(g, adj),
                     fg.fused_gcn_dense_plain(g, adj, True), tol)
        e18, e18b = [], []
        for negate in (False, True):
            e18.append(_held(torch, "K18", dt_name,
                             fg.fused_gcn_dense_att(x, adj, src, dst, negate),
                             fg.fused_gcn_dense_att_plain(x, adj, src, dst, negate), tol))
            for nm, a, r in zip(("dx", "dsrc", "ddst"),
                                fg.fused_gcn_dense_att_bwd(x, adj, src, dst, g, negate),
                                fg.fused_gcn_dense_att_bwd_plain(x, adj, src, dst, g, negate)):
                e18b.append(_held(torch, f"K18B {nm}", dt_name, a, r, btol))
        # the library yardstick: the normalized adjacency (and its transpose)
        # built outside the call, one batched product in x's dtype
        m = fg._offdiag(adj)
        deg = m.sum(dim=-2) + 1.0
        dis = torch.rsqrt(deg)
        norm = ((m * dis[:, None, :]) * dis[:, :, None]).to(dt)
        norm_t = norm.transpose(1, 2).contiguous()
        plane, adj_b, lg = bsz * n * H * elt, bsz * n * n * elt, bsz * n * elt
        prod = 2 * bsz * n * n * H
        rows = {}
        cluster = fg.plain_cluster_size(dt, n, H)
        path = {"path": "cluster" if cluster else "two_pass", "cluster": cluster}
        # the two-pass forwards' device time by pass (degree, aggregate)
        split = lambda fn: {} if cluster else forward_split(torch, fn)
        rows["fused_gcn_dense"] = _row(
            torch, "fused_gcn_dense", dt_name, lambda: fg._mm_fwd(x, adj),
            lambda: fg.fused_gcn_dense_plain(x, adj), adj_b + 2 * plane, prod, peak, e17, tol,
            bw, flush, lambda: torch.bmm(norm, x),
            "torch.bmm(normalized adjacency, x) in x's dtype, adjacency built outside the call",
            **path, **split(lambda: fg._mm_fwd(x, adj)))
        rows["fused_gcn_dense_t"] = _row(
            torch, "fused_gcn_dense_t", dt_name, lambda: fg.fused_gcn_dense_t(g, adj),
            lambda: fg.fused_gcn_dense_plain(g, adj, True), adj_b + 2 * plane, prod, peak,
            e17t, tol, bw, flush, lambda: torch.bmm(norm_t, g),
            "torch.bmm(transposed normalized adjacency, g), built outside the call", **path,
            **split(lambda: fg.fused_gcn_dense_t(g, adj)))
        rows["fused_gcn_dense_att"] = _row(
            torch, "fused_gcn_dense_att", dt_name,
            lambda: fg._att_fwd(x, adj, src, dst, False),
            lambda: fg.fused_gcn_dense_att_plain(x, adj, src, dst, False),
            adj_b + 2 * plane + 2 * lg, prod, peak, max(e18), tol, bw, flush, None,
            "none: no single PyTorch call computes the sigmoid-weighted normalized aggregate",
            **forward_split(torch, lambda: fg._att_fwd(x, adj, src, dst, False)))
        rows["fused_gcn_dense_att_bwd"] = _row(
            torch, "fused_gcn_dense_att_bwd", dt_name,
            lambda: fg.fused_gcn_dense_att_bwd(x, adj, src, dst, g, False),
            lambda: fg.fused_gcn_dense_att_bwd_plain(x, adj, src, dst, g, False),
            adj_b + 3 * plane + 4 * lg, 6 * live_cells(batch) * H, peak, max(e18b), btol, bw,
            flush, None,
            "none: no single PyTorch call computes the sigmoid-weighted aggregate's VJP")
        out[dt_name] = rows
    plain_two_pass(torch, peaks, flush)
    return out


def plain_two_pass(torch, peaks, flush, bsz=16, n=640):
    """K17 and K17T (bf16) past the one-launch path's limit (N > 256): the
    two-pass path, a degree pass and the aggregate, on a seeded adjacency of
    counts (about 13 edges a node, 1 in 10 of them doubled), held against the
    twins and timed beside torch.bmm."""
    from cal_tpu_torch.ops import fused_gcn as fg

    bw, bf16_peak, _ = peaks
    dt = torch.bfloat16
    check(fg.plain_cluster_size(dt, n, H) == 0, f"N = {n} is not on the two-pass path")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    adj = ((torch.rand((bsz, n, n), generator=gen, device="cuda") < 0.02).float()
           + (torch.rand((bsz, n, n), generator=gen, device="cuda") < 0.002)).to(dt)
    x, g = (torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt) for _ in range(2))
    tol = DUAL_TOL["bfloat16"]
    before = (fg.fused_gcn_dense.launches, fg.fused_gcn_dense_t.launches)
    e17 = _held(torch, "K17 two-pass", "bfloat16", fg._mm_fwd(x, adj),
                fg.fused_gcn_dense_plain(x, adj), tol)
    e17t = _held(torch, "K17T two-pass", "bfloat16", fg.fused_gcn_dense_t(g, adj),
                 fg.fused_gcn_dense_plain(g, adj, True), tol)
    check((fg.fused_gcn_dense.launches, fg.fused_gcn_dense_t.launches)
          == (before[0] + 1, before[1] + 1), "K17 / K17T two-pass launches")
    m = fg._offdiag(adj)
    dis = torch.rsqrt(m.sum(dim=-2) + 1.0)
    norm = ((m * dis[:, None, :]) * dis[:, :, None]).to(dt)
    norm_t = norm.transpose(1, 2).contiguous()
    nbytes = (bsz * n * n + 2 * bsz * n * H) * 2
    extra = {"path": "two_pass", "batch": [bsz, n, H]}
    _row(torch, "fused_gcn_dense", "bfloat16", lambda: fg._mm_fwd(x, adj),
         lambda: fg.fused_gcn_dense_plain(x, adj), nbytes, 2 * bsz * n * n * H, bf16_peak, e17,
         tol, bw, flush, lambda: torch.bmm(norm, x),
         "torch.bmm(normalized adjacency, x), adjacency built outside the call", **extra,
         **forward_split(torch, lambda: fg._mm_fwd(x, adj)))
    _row(torch, "fused_gcn_dense_t", "bfloat16", lambda: fg.fused_gcn_dense_t(g, adj),
         lambda: fg.fused_gcn_dense_plain(g, adj, True), nbytes, 2 * bsz * n * n * H,
         bf16_peak, e17t, tol, bw, flush, lambda: torch.bmm(norm_t, g),
         "torch.bmm(transposed normalized adjacency, g), built outside the call", **extra,
         **forward_split(torch, lambda: fg.fused_gcn_dense_t(g, adj)))


def dense_digests(torch, batch) -> dict:
    """sha256 of the adjacency (row 1) and the dense masked-conv kernels'
    outputs (rows 2, 2b, 3, 3b, 4 and 4-dx) on seeded inputs over the
    synthetic dense batch's adjacency, bf16 and f32.  Two trees whose
    digests agree computed the same bits; the calls are the public
    functions, so the digests of another tree of the port come from this
    function with that tree's package imported (``--digests``)."""
    from cal_tpu_torch.graph import to_dense
    from cal_tpu_torch.ops import fused_gcn as fg

    bsz, n, _ = batch.x.shape
    out = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        adj = to_dense(batch, dt).adj
        out[f"row1_{dt_name}"] = _digest([adj])
        gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
        xc, xo, gc, go = (torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt)
                          for _ in range(4))
        src = torch.randn((bsz, n), generator=gen, device="cuda").to(dt)
        dst = (2.0 * torch.randn((bsz, n), generator=gen, device="cuda")).to(dt)
        calls = {
            "row2": lambda: fg.fused_gcn_dense_att_dual(xc, xo, adj, src, dst),
            "row2b": lambda: fg.fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go),
            "row3": lambda: [fg.fused_gcn_dense_att(xc, adj, src, dst, neg)
                             for neg in (False, True)],
            "row3b": lambda: [t for neg in (False, True)
                              for t in fg.fused_gcn_dense_att_bwd(xc, adj, src, dst, gc, neg)],
            "row4": lambda: [fg.fused_gcn_dense(xc, adj)],
            "row4_dx": lambda: [fg.fused_gcn_dense_t(gc, adj)],
        }
        for name, fn in calls.items():
            out[f"{name}_{dt_name}"] = _digest(fn())
    return out


def sparse_digests(torch, batches: dict) -> dict:
    """sha256 of every instantiation of the coefficient SpMM walk (K2, K2T,
    K3, K3T, K11, K11T, K14, K14T at both ``negate`` values, K19, K19T at
    HEADS heads), of K21 (4 planes, dead edges left random), of K8's, K9's,
    K9T's and K10's outputs (each apart, K9 / K9T at rate 0 and GAT_RATE,
    K10 at GAT_RATE), the chain's (``chain_digests``), the degrees' and
    K7's (``degree_digests``) and K12's / K20's (``sddmm_digests``) on
    seeded inputs
    over each sparse batch, bf16 and f32 (K21's values f32).  The
    degrees and coefficients are seeded too (no kernel's output feeds
    another), so equal digests mean the walks computed the same bits; from
    another tree's root with ``--digests``, as ``dense_digests``."""
    from cal_tpu_torch.ops import coo_spmm as coo
    from cal_tpu_torch.ops import gat_sparse as gs
    from cal_tpu_torch.ops import spmm

    words = (DROP_SEED & 0xFFFFFFFF, DROP_SEED >> 32)
    out = {}
    for label, g in batches.items():
        v, e = g.num_nodes, g.senders.shape[0]
        live = g.edge_mask & (g.senders != g.receivers)
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
            xc, xo = (torch.randn((v, H), generator=gen, device="cuda").to(dt)
                      for _ in range(2))
            src = torch.randn(v, generator=gen, device="cuda").to(dt)
            dst = (2.0 * torch.randn(v, generator=gen, device="cuda")).to(dt)
            deg = 1.0 + 4.0 * torch.rand((2, v), generator=gen, device="cuda")
            dis = torch.rsqrt(deg)
            coef = torch.randn(e, generator=gen, device="cuda")
            coef = coef * (torch.rand(e, generator=gen, device="cuda") < 0.9)
            coef_mh = torch.rand((e, HEADS), generator=gen, device="cuda") * live[:, None]
            vals = torch.randn((4, e), generator=gen, device="cuda")
            s32, d32 = src.float(), dst.float()
            calls = {
                "K2": lambda: spmm.pair_coef_spmm(xc, xo, src, dst, deg, dis, g),
                "K2T": lambda: spmm.pair_coef_spmm_t(xc, xo, src, dst, deg, dis, g),
                "K3": lambda: [spmm.plain_coef_spmm(xc, deg[:1], dis[:1], g)],
                "K3T": lambda: [spmm.plain_coef_spmm_t(xc, deg[:1], dis[:1], g)],
                "K11": lambda: [coo.coo_spmm(xc, coef, g)],
                "K11T": lambda: [coo.coo_spmm_t(xc, coef, g)],
                "K14": lambda: [spmm.sigmoid_coef_spmm(xc, s32, d32, deg[0], dis[0], g, neg)
                                for neg in (False, True)],
                "K14T": lambda: [spmm.sigmoid_coef_spmm_t(xc, s32, d32, deg[0], dis[0], g, neg)
                                 for neg in (False, True)],
                "K19": lambda: [coo._coo_spmm_mh_fwd(xc, coef_mh, g, HEADS)],
                "K19T": lambda: [coo.coo_spmm_mh_t(xc, coef_mh, g, HEADS)],
                "K21": lambda: [coo.segment_max(vals, g)],
            }
            for name, fn in calls.items():
                out[f"{name}_{label}_{dt_name}"] = _digest(fn())
            # row 13's K8 (m, den), K9 and K9T (at rate 0 and GAT_RATE, K9T on w
            # in the dtype) and K10 (dtj, dti), each handed the twin's m, apart:
            # m is a max, equal bit for bit across designs; the sums need not be
            _, _, x, ti, tj, w, dD = gat_inputs(torch, v, dt, SEED + 31)
            m_ref = gs.gat_row_stats_plain(tj, ti, g)[0]
            for name, t in zip(("K8_m", "K8_den", "K10_dtj", "K10_dti"),
                               (*gs.gat_row_stats(tj, ti, g),
                                *gs.gat_sddmm_chain(x, w, tj, ti, m_ref, dD, words, GAT_RATE, g))):
                out[f"{name}_{label}_{dt_name}"] = _digest([t])
            for rate in (0.0, GAT_RATE):
                out[f"K9_{label}_{dt_name}_r{rate}"] = _digest(
                    [gs.gat_coef_spmm(x, tj, ti, m_ref, words, rate, g)])
                out[f"K9T_{label}_{dt_name}_r{rate}"] = _digest(
                    [gs.gat_coef_spmm_t(w.to(dt), tj, ti, m_ref, words, rate, g)])
    return {**out, **chain_digests(torch, batches), **degree_digests(torch, batches),
            **sddmm_digests(torch, batches)}


def sddmm_digests(torch, batches: dict) -> dict:
    """sha256 of K12's and K20's (at HEADS heads) dot products on seeded x
    (bf16 and f32) and g (f32) over each sparse batch, stopping the run if
    a second call does not repeat the bits.  Only public wrappers: from
    another tree's root it gives that tree's bits."""
    from cal_tpu_torch.ops import coo_spmm as coo

    out = {}
    for label, g in batches.items():
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
            x = torch.randn((g.num_nodes, H), generator=gen, device="cuda").to(dt)
            gout = torch.randn((g.num_nodes, H), generator=gen, device="cuda")
            for name, fn in (("K12", lambda: coo.coo_sddmm(x, gout, g)),
                             ("K20", lambda: coo.coo_sddmm_mh(x, gout, g, HEADS))):
                got = fn()
                check(torch.equal(got, fn()), f"{name} {dt_name} on {label} differs between "
                      "two calls")
                out[f"{name}_{label}_{dt_name}"] = _digest([got])
    return out


def degree_digests(torch, batches: dict) -> dict:
    """sha256 of K1's sums (logits in bf16 and f32, and zero logits), K1's
    deg / dis and the plain conv's degree (``degree_calls``), K13's (deg,
    dis) at both ``negate`` values, K7's dx in bf16 and f32 (on the
    batch's node_graph and on it shuffled) and K4's pooled sums of x in bf16
    and f32 (stopping the run if a second call does not repeat the bits), on
    seeded inputs over each sparse batch.  The zero-logit sums and the plain
    degree are counts, exact in any order, and K7 a copy: these equal every
    tree's."""
    from cal_tpu_torch.ops import pool, spmm

    pair_norm, plain_degree = degree_calls(spmm)
    out = {}
    for label, g in batches.items():
        v = g.num_nodes
        gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
        src = torch.randn(v, generator=gen, device="cuda")
        dst = 2.0 * torch.randn(v, generator=gen, device="cuda")
        dp = torch.randn((g.num_graphs + 1, H), generator=gen, device="cuda")
        shuffled = g.node_graph[torch.randperm(v, generator=gen, device="cuda")]
        out[f"K1_zero_{label}"] = _digest([spmm.pair_sender_degree(None, None, g)])
        out[f"K1_plain_{label}"] = _digest(plain_degree(g))
        for neg in (False, True):
            out[f"K13_neg{int(neg)}_{label}"] = _digest(
                spmm.sigmoid_sender_degree(src, dst, g, neg))
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            out[f"K1_{label}_{dt_name}"] = _digest(
                [spmm.pair_sender_degree(src.to(dt), dst.to(dt), g)])
            out[f"K1_norm_{label}_{dt_name}"] = _digest(pair_norm(src.to(dt), dst.to(dt), g))
            for name, ng in (("K7", g.node_graph), ("K7_shuffled", shuffled)):
                out[f"{name}_{label}_{dt_name}"] = _digest([pool.segment_pool_bwd(dp, ng, dt)])
            x = torch.randn((v, H), generator=torch.Generator(device="cuda").manual_seed(
                SEED + 34), device="cuda").to(dt)
            pooled = pool.segment_pool(x, g.node_graph, g.num_graphs + 1)
            check(torch.equal(pooled, pool.segment_pool(x, g.node_graph, g.num_graphs + 1)),
                  f"K4 {dt_name} on {label} differs between two calls")
            out[f"K4_{label}_{dt_name}"] = _digest([pooled])
    return out


def chain_digests(torch, batches: dict) -> dict:
    """sha256 of K5's, K6's, K15's and K16's outputs (each apart, K15 / K16
    at both ``negate`` values) on seeded inputs over each sparse batch, x and
    g in bf16 and f32 (K6's and K16's vec planes, 0 on dead edges as K5
    writes them, and ddeg f32).  Only public wrappers: from another tree's
    root it gives that tree's bits."""
    from cal_tpu_torch.ops import spmm

    out = {}
    heads, tails = ("vec", "ddis_s", "ddis_r"), ("dsrc", "ddst")
    for label, g in batches.items():
        v, e = g.num_nodes, g.senders.shape[0]
        live = g.edge_mask & (g.senders != g.receivers)
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
            xc, xo, gc, go = (torch.randn((v, H), generator=gen, device="cuda").to(dt)
                              for _ in range(4))
            src = torch.randn(v, generator=gen, device="cuda")
            dst = 2.0 * torch.randn(v, generator=gen, device="cuda")
            dis = torch.rsqrt(1.0 + 4.0 * torch.rand((2, v), generator=gen, device="cuda"))
            vec = torch.randn((3, e), generator=gen, device="cuda") * live
            ddeg = torch.randn((2, v), generator=gen, device="cuda")
            chain = {"K5": (heads, lambda: spmm.pair_sddmm_chain(
                         xc, xo, gc, go, src.to(dt), dst.to(dt), dis, g)),
                     "K6": (tails, lambda: spmm.pair_dpre(vec, ddeg, g))}
            for neg in (False, True):
                chain[f"K15_neg{int(neg)}"] = (heads, lambda neg=neg: spmm.sigmoid_sddmm_chain(
                    xc, gc, src, dst, dis[0], g, neg))
                chain[f"K16_neg{int(neg)}"] = (tails, lambda neg=neg: spmm.sigmoid_dpre(
                    vec[1:], ddeg[0], g, neg))
            for name, (parts, fn) in chain.items():
                for part, t in zip(parts, fn(), strict=True):
                    out[f"{name}_{part}_{label}_{dt_name}"] = _digest([t])
    return out


def csr_profile(g, label) -> dict:
    """The degree profile of one sparse batch as the coefficient SpMM walk
    sees it, for both CSRs: chunks, rows by edge count, rows of more than one
    chunk (the heavy rows) and their edges, and the run at node V-1 (the
    padded edges of a padded batch) with its dead edges and chunks.  From
    ptr and chunk_ptr alone, so it reads any tree's batches."""
    import numpy as np

    v = g.num_nodes
    mask = g.edge_mask.cpu().numpy()
    out = {"phase": "csr_profile", "batch": label, "V": v, "E": int(mask.size),
           "live_edges": int((g.edge_mask & (g.senders != g.receivers)).sum())}
    for name, csr in (("recv", g.recv), ("send", g.send)):
        n = np.diff(csr.ptr.cpu().numpy())
        chunks = np.diff(csr.chunk_ptr.cpu().numpy())
        last = np.arange(csr.ptr[v - 1].item(), csr.ptr[v].item())
        if csr.perm is not None:
            last = csr.perm.cpu().numpy()[last]
        out[name] = {
            "chunks": csr.num_chunks,
            "rows_by_edges": {"0": int((n == 0).sum()), "1": int((n == 1).sum()),
                              "2-4": int(((n >= 2) & (n <= 4)).sum()),
                              "5-32": int(((n >= 5) & (n <= 32)).sum()),
                              ">32": int((n > 32).sum())},
            "multi_chunk_rows": int((chunks > 1).sum()),
            "multi_chunk_edges": int(n[chunks > 1].sum()),
            "max_row_edges": int(n.max()), "mean_row_edges": float(n.mean()),
            "last_node_run": {"edges": int(n[-1]), "dead": int((~mask[last]).sum()),
                              "chunks": int(chunks[-1])}}
    return out


def ptxas_walk(report: dict, libs=("spmm", "coo_spmm")) -> dict:
    """{instance: registers, spill bytes} of the coefficient SpMM walk's
    kernels (csr_spmm_kernel, csr_spmm_combine) in ``libs`` (spmm.cu and
    coo_spmm.cu; gat_sparse.cu for K9 / K9T), from nvcc's ``-Xptxas -v``
    logs; an instance is named by its policy, element type and integer and
    bool template arguments (branches or heads, NEG or TRANS, H / 32).
    With spmm.cu, also its other kernels (K1's, K5's receiver pass
    ``chain_head_kernel<dtype, branches, NEG, H / 32>`` and sender sums
    ``csr_reduce_kernel``, K6's ``chain_tail_kernel<branches, NEG>``), named
    by their element type and integer and bool template arguments; with
    coo_spmm.cu, K12 / K20's ``coo_sddmm_kernel<x dtype, g dtype, heads,
    H / 32>`` (``ptxas_instances``)."""
    out = {} if "spmm" not in libs else {
        k: v for k, v in ptxas_instances(report, ["spmm"]).items()
        if not k.startswith("csr_spmm_kernel")}
    if "coo_spmm" in libs:
        out.update({k: v for k, v in ptxas_instances(report, ["coo_spmm"]).items()
                    if k.startswith("coo_sddmm_kernel")})
    for lib in libs:
        name = None
        for ln in report.get(lib, {}).get("log", "").splitlines():
            m = re.search(r"Function properties for (\w+)", ln)
            if m:
                k = re.search(r"(csr_spmm_kernel(?:_bounded)?|csr_spmm_combine)I\w*?"
                              r"(GcnSpmm|SigSpmm|CooSpmm|GatSpmm)I(13__nv_bfloat16|f)(\w*)",
                              m.group(1))
                name = None if k is None else "{}<{}, {}, {}>".format(
                    k.group(1), k.group(2), "bf16" if k.group(3) != "f" else "f32",
                    ", ".join(re.findall(r"L[ib](\d+)E", k.group(4))))
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if name and m:
                out[name] = {"spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))}
            m = re.search(r"Used (\d+) registers", ln)
            if name and m:
                out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def _mangled_kernel(mangled: str):
    """(kernel name, the mangled template arguments after it) of an Itanium
    mangled function name whose last name component ends in ``_kernel``
    (possibly inside namespaces: ``_ZN<len><name>...``), else (None, "")."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else -1
    while 0 <= i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        ident, i = mangled[j:j + n], j + n
        if ident.endswith("_kernel"):
            return ident, mangled[i:]
    return None, ""


def _first_targs(targs: str) -> str:
    """The first template argument list (``I ... E``) of a mangled name's
    tail: literals (``L ... E``), substitutions (``S_``, ``S0_``), template
    parameters (``T_``) and length-prefixed names skipped whole."""
    depth, i = 0, 0
    while i < len(targs):
        c = targs[i]
        if c == "L":
            i = targs.index("E", i) + 1
            continue
        if c in "ST":
            i = targs.index("_", i) + 1
            continue
        if c.isdigit():
            j = i
            while targs[j].isdigit():
                j += 1
            i = j + int(targs[i:j])
            continue
        if c in "IXN":
            depth += 1
        elif c == "E":
            depth -= 1
            if depth == 0:
                return targs[:i + 1]
        i += 1
    return targs


def _targ_dtypes(first: str) -> list:
    """The element types (bf16, f32) among the top-level arguments of a
    mangled template argument list (``I ... E``), in order; a substitution
    there (``S_``, ``S1_``) repeats ``__nv_bfloat16``, the one element type
    that is not a builtin, once that has appeared."""
    out, depth, i = [], 0, 0
    while i < len(first):
        c = first[i]
        if c == "L":
            i = first.index("E", i) + 1
            continue
        if c in "ST":
            j = first.index("_", i) + 1
            if c == "S" and depth == 1 and "bf16" in out:
                out.append("bf16")
            i = j
            continue
        if c.isdigit():
            j = i
            while first[j].isdigit():
                j += 1
            ident, i = first[j:j + int(first[i:j])], j + int(first[i:j])
            if depth == 1 and ident == "__nv_bfloat16":
                out.append("bf16")
            continue
        if c == "f" and depth == 1:
            out.append("f32")
        elif c in "IXN":
            depth += 1
        elif c == "E":
            depth -= 1
        i += 1
    return out


def ptxas_instances(report: dict, libs) -> dict:
    """{instance: registers, spill bytes} of every ``*_kernel`` of the
    libraries ``libs``, from nvcc's ``-Xptxas -v`` logs; an instance is
    named by the element types and the integer and bool arguments of the
    kernel's own template argument list, a ``csr_reduce_kernel`` also by its
    values policy (``RowReduce``, ``DegreeSum``) and that policy's element
    type."""
    out = {}
    for lib in libs:
        name = None
        for ln in report.get(lib, {}).get("log", "").splitlines():
            m = re.search(r"Function properties for (\w+)", ln)
            if m:
                kernel, targs = _mangled_kernel(m.group(1))
                name = None
                if kernel:
                    first = _first_targs(targs)
                    dtypes = _targ_dtypes(first)
                    pol = re.search(r"\d(RowReduce|DegreeSum)(?:I(13__nv_bfloat16|f))?", first)
                    if pol and pol.group(2):
                        dtypes = ["bf16" if pol.group(2) != "f" else "f32"]
                    ints = re.findall(r"L[ib](\d+)E", first)
                    parts = ([pol.group(1)] if pol else []) + dtypes + ints
                    name = f"{kernel}<{', '.join(parts)}>" if parts else kernel
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if name and m:
                out[name] = {"spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))}
            m = re.search(r"Used (\d+) registers", ln)
            if name and m:
                out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def ptxas_gat(report: dict) -> dict:
    """Registers and spills of row 13's kernels (gat_sparse.cu): every
    ``*_kernel`` there, K9 / K9T's walk instances named by their policy
    (``csr_spmm_kernel<GatSpmm, dtype, heads, TRANS, H / 32>``)."""
    own = {k: v for k, v in ptxas_instances(report, ["gat_sparse"]).items()
           if not k.startswith("csr_spmm_kernel")}
    return {**own, **ptxas_walk(report, ("gat_sparse",))}


def ptxas_edge(report: dict) -> dict:
    """Registers and spills of the edge GAT kernels (every ``*_kernel`` of
    edge_gat.cu and edge_gat_bwd.cu; template arguments: heads, then heads
    * d or columns a lane)."""
    return ptxas_instances(report, sorted(k for k in report if k.startswith("edge_gat")))


def ptxas_flash(report: dict) -> dict:
    """Registers and spills of the flash GAT kernels (flash_gat.cu; the
    template argument: the 32-lane column groups a lane keeps)."""
    return ptxas_instances(report, ["flash_gat"])


def sparse_row_kernels(torch, g, label, peaks, flush, heads=HEADS, planes=4):
    """Row 9 (K19, K19T, K20) at ``heads`` heads of H / heads and row 14
    (K21) at ``planes`` value planes against their twins on one sparse batch
    ``g``, x in bf16 and f32 (the coefficients, K21's values and the
    cotangent f32), timed beside torch.sparse.mm on a block-diagonal
    per-head CSR (K19, K19T), a batched sampled_addmm over the receiver CSR
    repeated per head (K20, held against K20's twin too; with the warm
    device ms of each kernel a call launches, ``passes``) and scatter_reduce_
    amax (K21).  Returns {dtype: {kernel: row}}."""
    from cal_tpu_torch.ops import coo_spmm as coo

    bw, _, f32_peak = peaks
    v, e = g.num_nodes, g.senders.shape[0]
    live = g.edge_mask & (g.senders != g.receivers)
    n_nz = int(live.sum())
    csr = lambda c: 4 * (2 * (v + 1) + c.num_chunks)
    out = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        x = torch.randn((v, H), generator=gen, device="cuda").to(dt)
        gout = torch.randn((v, H), generator=gen, device="cuda")
        coef = torch.rand((e, heads), generator=gen, device="cuda") * live[:, None]
        vals = torch.randn((planes, e), generator=gen, device="cuda")
        vals = torch.where(g.edge_mask[None], vals, torch.full_like(vals, -1e30))
        e19 = _held(torch, "K19", dt_name, coo._coo_spmm_mh_fwd(x, coef, g, heads),
                    coo.coo_spmm_plain(x, coef, g), COO_TOL)
        e19t = _held(torch, "K19T", dt_name, coo.coo_spmm_mh_t(gout, coef, g, heads),
                     coo.coo_spmm_t_plain(gout, coef, g), COO_TOL)
        e20 = _held(torch, "K20", dt_name, coo.coo_sddmm_mh(x, gout, g, heads),
                    coo.coo_sddmm_plain(x, gout, g, heads), COO_TOL)
        lib20, lib20_vals = _library_sddmm_mh(torch, g, x, gout, heads)
        _held(torch, "K20's sampled_addmm yardstick", dt_name, lib20_vals(),
              coo.coo_sddmm_plain(x, gout, g, heads), COO_TOL)
        extra = {"batch": label, "nodes": v, "edges": e, "nonzero_coef_edges": n_nz,
                 "heads": heads}
        rows = {}
        rows["coo_spmm_mh"] = _row(
            torch, "coo_spmm_mh", dt_name, lambda: coo._coo_spmm_mh_fwd(x, coef, g, heads),
            lambda: coo.coo_spmm_plain(x, coef, g),
            v * H * elt + 4 * e * (1 + heads) + csr(g.recv) + v * H * 4, 2 * H * n_nz,
            f32_peak, e19, COO_TOL, bw, flush, _library_gat_spmm(torch, g, coef.T.contiguous(),
                                                                 x, False),
            "torch.sparse.mm(block-diagonal per-head CSR [heads*V, heads*V], per-head x "
            "blocks) in x's dtype, built outside the call", **extra)
        rows["coo_spmm_mh_t"] = _row(
            torch, "coo_spmm_mh_t", dt_name, lambda: coo.coo_spmm_mh_t(gout, coef, g, heads),
            lambda: coo.coo_spmm_t_plain(gout, coef, g),
            v * H * 4 + 4 * e * (2 + heads) + csr(g.send) + v * H * 4, 2 * H * n_nz,
            f32_peak, e19t, COO_TOL, bw, flush,
            _library_gat_spmm(torch, g, coef.T.contiguous(), gout, True),
            "torch.sparse.mm(transposed block-diagonal per-head CSR, per-head g blocks), "
            "built outside the call", **extra)
        rows["coo_sddmm_mh"] = _row(
            torch, "coo_sddmm_mh", dt_name, lambda: coo.coo_sddmm_mh(x, gout, g, heads),
            lambda: coo.coo_sddmm_plain(x, gout, g, heads),
            v * H * elt + v * H * 4 + 4 * e + csr(g.recv) + 4 * heads * e, 2 * H * e,
            f32_peak, e20, COO_TOL, bw, flush, lib20,
            "torch.sparse.sampled_addmm(receiver CSR repeated per head [heads, V, V], "
            "per-head g [heads, V, d], per-head x^T [heads, d, V]) in f32, CSR, split and "
            "cast built outside the call",
            passes=profile_passes(torch, lambda: coo.coo_sddmm_mh(x, gout, g, heads)), **extra)
        rows["segment_max"] = segment_max_row(torch, g, label, peaks, flush, planes,
                                              dt_name, vals)
        out[dt_name] = rows
    return out


def segment_max_row(torch, g, label, peaks, flush, planes, dt_name, vals):
    """Row 14 (K21) at ``planes`` value planes [K, E] f32 on sparse batch
    ``g``, bit for bit against its twin, timed beside scatter_reduce_ amax."""
    from cal_tpu_torch.ops import coo_spmm as coo

    v, e = g.num_nodes, g.senders.shape[0]
    csr = 4 * (2 * (v + 1) + g.recv.num_chunks)
    e21 = _held(torch, "K21", dt_name, coo.segment_max(vals, g),
                coo.segment_max_plain(vals, g), (0.0, 0.0))
    idx = g.receivers.long()[None].expand(planes, -1)
    amax = torch.full((planes, v), -1e30, device="cuda")
    return _row(
        torch, "segment_max", dt_name, lambda: coo.segment_max(vals, g),
        lambda: coo.segment_max_plain(vals, g), 4 * planes * e + csr + 4 * planes * v,
        planes * e, peaks[2], e21, (0.0, 0.0), peaks[0], flush,
        lambda: amax.scatter_reduce_(1, idx, vals, "amax"),
        "Tensor.scatter_reduce_(1, receivers [K, E], vals, 'amax') into a [K, V] plane "
        "at -1e30, index built outside the call",
        batch=label, nodes=v, edges=e, planes=planes)


# kernel row -> (launch counter, model whose training run is its main path,
# source, the TPU kernel it replaces)
KERNEL_ROWS = {
    "adj_build": ("adj_build", "CausalGCN", "cal_tpu_torch/csrc/adj_build.cu",
                  "cal_tpu/ops/pallas_adj.py:38"),
    "fused_gcn_dense_att_dual_fwd": ("fused_gcn_dense_att_dual", "CausalGCN",
                                     "cal_tpu_torch/csrc/fused_gcn.cu",
                                     "cal_tpu/ops/pallas_gcn.py:283"),
    "fused_gcn_dense_att_dual_bwd": ("fused_gcn_dense_att_dual_bwd", "CausalGCN",
                                     "cal_tpu_torch/csrc/fused_gcn.cu",
                                     "cal_tpu/ops/pallas_gcn.py:324"),
    "flash_gat_fwd": ("flash_gat_fwd", "CausalGAT", "cal_tpu_torch/csrc/flash_gat.cu",
                      "cal_tpu/ops/pallas_gat.py:92"),
    "flash_gat_bwd": ("flash_gat_bwd", "CausalGAT", "cal_tpu_torch/csrc/flash_gat.cu",
                      "cal_tpu/ops/pallas_gat.py:137"),
}
# sparse kernel row -> (source, the TPU kernel it replaces); launches come from
# the sparse serving run, its main path
SPARSE_KERNEL_ROWS = {
    "pair_sender_degree": ("cal_tpu_torch/csrc/spmm.cu", "cal_tpu/ops/pallas_spmm.py:1222"),
    "plain_sender_degree": ("cal_tpu_torch/csrc/spmm.cu",
                            "cal_tpu/ops/pallas_spmm.py:1222 at zero logits in _plain_fwd (:1066)"),
    "pair_coef_spmm": ("cal_tpu_torch/csrc/spmm.cu", "cal_tpu/ops/pallas_spmm.py:1292"),
    "plain_coef_spmm": ("cal_tpu_torch/csrc/spmm.cu", "cal_tpu/ops/pallas_spmm.py:1032"),
    "segment_pool": ("cal_tpu_torch/csrc/pool.cu", "cal_tpu/ops/pallas_pool.py:79"),
}
# sparse GAT kernel row -> (source, the TPU kernel it replaces); launches come
# from the sparse CausalGAT training run, its main path
GAT_KERNEL_ROWS = {
    "gat_row_stats": ("cal_tpu_torch/csrc/gat_sparse.cu",
                      "cal_tpu/ops/pallas_spmm.py:1639 and :1695"),
    "gat_coef_spmm": ("cal_tpu_torch/csrc/gat_sparse.cu", "cal_tpu/ops/pallas_spmm.py:1772"),
    "gat_coef_spmm_t": ("cal_tpu_torch/csrc/gat_sparse.cu",
                        "cal_tpu/ops/pallas_spmm.py:1772 on tiles_bwd (cal_tpu/ops/gat.py:312)"),
    "gat_sddmm_chain": ("cal_tpu_torch/csrc/gat_sparse.cu", "cal_tpu/ops/pallas_spmm.py:1864"),
}
# coefficient SpMM kernel row -> (source, the TPU kernel it replaces); launches
# come from the sparse CausalGIN training run, its main path, where K12 runs
# no time (no model's coefficient needs a gradient; the kernel phase launches
# and holds it on its own)
COO_KERNEL_ROWS = {
    "coo_spmm": ("cal_tpu_torch/csrc/coo_spmm.cu", "cal_tpu/ops/pallas_spmm.py:444"),
    "coo_spmm_t": ("cal_tpu_torch/csrc/coo_spmm.cu",
                   "cal_tpu/ops/pallas_spmm.py:444 on tiles_bwd (_coo_bwd, :585)"),
    "coo_sddmm": ("cal_tpu_torch/csrc/coo_spmm.cu", "cal_tpu/ops/pallas_spmm.py:513"),
}
# the kernel rows no run of the port reaches: row 14 (K21), whose only path
# is its tests (cal_tpu's too); it is held and timed in phase 10
OFF_MAIN_PATH = {"segment_max"}
# edge-formulated GAT kernel row -> (source, the TPU kernel it replaces);
# launches come from the main_real CausalGAT run on SYNREDDIT, its main path
EDGE_KERNEL_ROWS = {
    "edge_gat_fwd": ("cal_tpu_torch/csrc/edge_gat.cu", "cal_tpu/ops/pallas_gat_sparse.py:323"),
    "edge_gat_bwd": ("cal_tpu_torch/csrc/edge_gat_bwd.cu",
                     "cal_tpu/ops/pallas_gat_sparse.py:361"),
}
# row 12's kernel row -> (source, the TPU kernel it replaces); launches come
# from ``cal_tpu_torch.bench`` (config 4), its main path
SIGMOID_KERNEL_ROWS = {
    "sigmoid_sender_degree": ("cal_tpu_torch/csrc/spmm.cu",
                              "cal_tpu/ops/pallas_spmm.py:1126 and :1990 (_sig_fwd, :888)"),
    "sigmoid_coef_spmm": ("cal_tpu_torch/csrc/spmm.cu",
                          "cal_tpu/ops/pallas_spmm.py:444 in _sig_fwd (:888)"),
    "sigmoid_coef_spmm_t": ("cal_tpu_torch/csrc/spmm.cu",
                            "cal_tpu/ops/pallas_spmm.py:444 on tiles_bwd in _sig_bwd (:913)"),
    "sigmoid_sddmm_chain": ("cal_tpu_torch/csrc/spmm.cu",
                            "cal_tpu/ops/pallas_spmm.py:513 and :1990 in _sig_bwd (:913)"),
    "sigmoid_dpre": ("cal_tpu_torch/csrc/spmm.cu",
                     "cal_tpu/ops/pallas_spmm.py:1126 and :1990 in _sig_bwd (:913)"),
}
# rows 3, 4, 9 and 14's kernel row -> (source, the TPU kernel it replaces);
# launches come from the parity entry point's run (cal_tpu_torch.parity), the
# only run of the port that reaches rows 3, 4 and 9 (as benchmarks/
# parity_tpu.py is cal_tpu's)
ROW_KERNEL_ROWS = {
    "fused_gcn_dense": ("cal_tpu_torch/csrc/fused_gcn.cu",
                        "cal_tpu/ops/pallas_gcn.py:178 _mm_call (_mm_kernel :82)"),
    "fused_gcn_dense_t": ("cal_tpu_torch/csrc/fused_gcn.cu",
                          "cal_tpu/ops/pallas_gcn.py:178 _mm_call, transpose (VJP :202)"),
    "fused_gcn_dense_att": ("cal_tpu_torch/csrc/fused_gcn.cu",
                            "cal_tpu/ops/pallas_gcn.py:222 _att_fwd (_att_fwd_kernel :113)"),
    "fused_gcn_dense_att_bwd": ("cal_tpu_torch/csrc/fused_gcn.cu",
                                "cal_tpu/ops/pallas_gcn.py:238 _att_bwd (_att_bwd_kernel :124)"),
    "coo_spmm_mh": ("cal_tpu_torch/csrc/coo_spmm.cu", "cal_tpu/ops/pallas_spmm.py:696"),
    "coo_spmm_mh_t": ("cal_tpu_torch/csrc/coo_spmm.cu",
                      "cal_tpu/ops/pallas_spmm.py:696 on tiles_bwd (_coo_mh_bwd, :799)"),
    "coo_sddmm_mh": ("cal_tpu_torch/csrc/coo_spmm.cu", "cal_tpu/ops/pallas_spmm.py:745"),
    "segment_max": ("cal_tpu_torch/csrc/coo_spmm.cu",
                    "cal_tpu/ops/pallas_spmm.py:1937 tile_scatter_max (kernel :1915)"),
}
# sparse backward kernel row -> (source, the TPU kernel it replaces); launches
# come from the sparse training run, its main path
SPARSE_BWD_KERNEL_ROWS = {
    "pair_coef_spmm_t": ("cal_tpu_torch/csrc/spmm.cu", "cal_tpu/ops/pallas_spmm.py:1537"),
    "plain_coef_spmm_t": ("cal_tpu_torch/csrc/spmm.cu", "cal_tpu/ops/pallas_spmm.py:1084"),
    "pair_sddmm_chain": ("cal_tpu_torch/csrc/spmm.cu", "cal_tpu/ops/pallas_spmm.py:1379"),
    "pair_dpre": ("cal_tpu_torch/csrc/spmm.cu", "cal_tpu/ops/pallas_spmm.py:1452"),
    "segment_pool_bwd": ("cal_tpu_torch/csrc/pool.cu", "cal_tpu/ops/pallas_pool.py:110"),
}


def missing(torch) -> bool:
    """True (and the reason on stderr) when there is no card or no package."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return True
    if not os.path.isdir(os.path.join(HERE, "cal_tpu_torch")):
        print("chip_smoke: the cal_tpu_torch package is missing", file=sys.stderr)
        return True
    return False


def main() -> int:
    import torch

    if missing(torch):
        return 2
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
    from cal_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    laps = {}

    def lap(name):
        laps[name] = time.perf_counter() - start - sum(laps.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks, peaks_of = peaks_for(name)
    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "nvidia_smi": smi, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_seconds": build_s,
          "peaks_of": peaks_of, "bytes_per_s": peaks[0],
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in report.items()},
          "ptxas_dense_bwd": ptxas_kernels(report.get("fused_gcn", {}).get("log", ""),
                                           r"bwd_\w*?_kernel"),
          "ptxas_dense_fwd": ptxas_kernels(
              report.get("fused_gcn", {}).get("log", ""),
              "plain_cluster_kernel|aggregate_mma_kernel|aggregate_fma_kernel|"
              "degree_wide_kernel|degree_col_kernel"),
          "ptxas_walk": ptxas_walk(report),
          "ptxas_pool": ptxas_instances(report, ["pool"]),
          "ptxas_edge": ptxas_edge(report),
          "ptxas_flash": ptxas_flash(report),
          "ptxas_gat": ptxas_gat(report),
          "plain_cluster_plan": plain_cluster_plan()})

    t0 = time.perf_counter()
    ds = generate_synthetic_dataset(data_num=DATA_NUM, seed=SEED)
    _, val_set, test_set, _ = dataset_bias_split(ds, bias=0.5, total=DATA_NUM * 4, seed=SEED)
    check(len(test_set) == TEST_GRAPHS, f"test split has {len(test_set)} graphs")
    batch = next(Loader(test_set, B).host_batches()).to("cuda")
    check(tuple(batch.x.shape[:2]) == (B, 256), f"batch shape {tuple(batch.x.shape)}")
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "test_graphs": len(test_set), "batch_shape": list(batch.x.shape)})

    lap("build_and_data")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = kernel_phase(torch, batch, peaks, flush)
    lap("dense_kernels")

    # each model's serving and training runs, counters at 0 just before each
    serving, training = {}, {}
    for model in ("CausalGCN", "CausalGAT"):
        serving[model] = serving_phase(torch, test_set, model)
        training[model] = training_phase(torch, model)
        grad_check(torch, test_set, batch, model)
        host = next(Loader(test_set, B).host_batches())
        profile_train_step(torch, test_set, host, model)
        profile_captured_step(torch, test_set, host, model)
        lap(f"dense_{model}")
    # the device-side epoch: captured against eager steps from one state,
    # both layouts, packed sparse and the dense edge-GAT path included
    for model, case in CAPTURE_CASES:
        captured_epoch_phase(torch, model, case)
    bench_configs_12(torch)
    lap("captured_epoch")

    # sparse layout: kernels on a serving batch and a REDDIT-shaped batch,
    # then CausalGCN serving through main_syn --layout sparse
    from cal_tpu_torch.data.reddit_synthetic import reddit_graphs

    t0 = time.perf_counter()
    ds = generate_synthetic_dataset(data_num=SPARSE_DATA_NUM, seed=SEED)
    sparse_train, sparse_val, sparse_test, _ = dataset_bias_split(
        ds, bias=0.5, total=SPARSE_DATA_NUM * 4, seed=SEED)
    del ds
    syn_batch = next(Loader(sparse_test, B, layout="sparse").host_batches()).to("cuda")
    reddit = reddit_graphs(B, seed=SEED, feat=10)
    reddit_batch = next(Loader(reddit, B, layout="sparse").host_batches()).to("cuda")
    deg = lambda g: (g.recv.ptr[1:-1] - g.recv.ptr[:-2]).max().item()
    emit({"phase": "sparse_data", "seconds": time.perf_counter() - t0,
          "test_graphs": len(sparse_test),
          "synthetic_batch": {"V": syn_batch.num_nodes, "E": syn_batch.senders.shape[0],
                              "live_edges": int(syn_batch.edge_mask.sum()),
                              "max_in_degree": deg(syn_batch)},
          "reddit_batch": {"V": reddit_batch.num_nodes, "E": reddit_batch.senders.shape[0],
                           "live_edges": int(reddit_batch.edge_mask.sum()),
                           "max_in_degree": deg(reddit_batch)}})
    # row 12 (K13-K16) on the benchmark's config-4 graph, its main path, and
    # on the REDDIT-shaped batch; the coefficient SpMM walk's every
    # instantiation on the REDDIT batch (rows 9's K19/K19T too)
    from cal_tpu_torch.bench import spmm_workload

    bench_graph = spmm_workload(8192, 131072, H, "cuda", torch.bfloat16)[0]
    for label, g in (("synthetic", syn_batch), ("reddit", reddit_batch),
                     ("bench_config4", bench_graph)):
        emit(csr_profile(g, label))
    sparse_rows = sparse_kernel_rows(torch, syn_batch, "synthetic", peaks, flush)
    red_rows = [sparse_kernel_rows(torch, reddit_batch, "reddit", peaks, flush)]
    bwd_rows = sparse_bwd_kernel_rows(torch, syn_batch, "synthetic", peaks, flush)
    red_rows.append(sparse_bwd_kernel_rows(torch, reddit_batch, "reddit", peaks, flush))
    gat_rows, keep_syn = gat_kernel_rows(torch, syn_batch, "synthetic", peaks, flush)
    _, keep_red = gat_kernel_rows(torch, reddit_batch, "reddit", peaks, flush)
    coo_rows = coo_kernel_rows(torch, syn_batch, "synthetic", peaks, flush)
    red_rows.append(coo_kernel_rows(torch, reddit_batch, "reddit", peaks, flush))
    sig_rows = sigmoid_kernel_rows(torch, bench_graph, "bench_config4", peaks, flush)
    red_rows.append(sigmoid_kernel_rows(torch, reddit_batch, "reddit", peaks, flush))
    red_rows.append(sparse_row_kernels(torch, reddit_batch, "reddit", peaks, flush))
    emit(walk_table("reddit", *red_rows))
    emit(copy_floor(torch, reddit_batch, "reddit", flush))
    for label, g in (("synthetic", syn_batch), ("reddit", reddit_batch)):
        emit(fill_floor(torch, g, label, flush))
    emit({"phase": "sparse_digests", **sparse_digests(
        torch, {"synthetic": syn_batch, "reddit": reddit_batch})})
    del syn_batch, reddit_batch, bench_graph
    lap("sparse_kernels")
    sparse_launches = sparse_serving_phase(
        torch, sparse_test, os.path.join(HERE, "build", "chip_smoke_train_CausalGCN"))
    lap("sparse_serving")

    # sparse training: main_syn --layout sparse, its checkpoint on both
    # layouts, one step's gradients, the step's device time
    sparse_train_launches = sparse_training_phase(torch, sparse_test, len(sparse_val))
    sparse_grad_check(torch, sparse_test)
    sparse_host = next(Loader(sparse_test, B, layout="sparse").host_batches())
    profile_train_step(torch, sparse_test, sparse_host, "CausalGCN", layout="sparse")
    profile_captured_step(torch, sparse_test, sparse_host, "CausalGCN", layout="sparse")
    profile_train_step(torch, sparse_test, next(Loader(sparse_test, B).host_batches()),
                       "CausalGCN", layout="dense")
    lap("sparse_training")

    # sparse CausalGAT: the dropout law over both kernel batches, serving
    # through main_syn (and the dense GAT checkpoint on both layouts),
    # training, one step's gradients, the step's device time
    kept, pairs = keep_syn[0] + keep_red[0], keep_syn[1] + keep_red[1]
    emit({"phase": "gat_sparse_dropout_law", "rate": GAT_RATE, "pairs": pairs,
          "keep_fraction": kept / pairs, "keep_tol": KEEP_TOL,
          "per_batch": {"synthetic": keep_syn[0] / keep_syn[1],
                        "reddit": keep_red[0] / keep_red[1]}})
    check(abs(kept / pairs - (1.0 - GAT_RATE)) <= KEEP_TOL, f"sparse keep fraction {kept / pairs}")
    gat_serve_launches = sparse_serving_phase(
        torch, sparse_test, os.path.join(HERE, "build", "chip_smoke_train_CausalGAT"),
        "CausalGAT")
    gat_train_launches = sparse_training_phase(torch, sparse_test, len(sparse_val), "CausalGAT")
    sparse_grad_check(torch, sparse_test, "CausalGAT")
    profile_train_step(torch, sparse_test, sparse_host, "CausalGAT", layout="sparse")
    profile_captured_step(torch, sparse_test, sparse_host, "CausalGAT", layout="sparse")
    lap("sparse_gat")

    # CausalGIN: dense serving and training (its checkpoint feeds the sparse
    # serving phase's both-layout check), then sparse serving, training,
    # one step's gradients and the step's device time
    serving["CausalGIN"] = serving_phase(torch, test_set, "CausalGIN")
    training["CausalGIN"] = training_phase(torch, "CausalGIN")
    gin_serve_launches = sparse_serving_phase(
        torch, sparse_test, os.path.join(HERE, "build", "chip_smoke_train_CausalGIN"),
        "CausalGIN")
    gin_train_launches = sparse_training_phase(torch, sparse_test, len(sparse_val), "CausalGIN")
    sparse_grad_check(torch, sparse_test, "CausalGIN")
    profile_train_step(torch, sparse_test, sparse_host, "CausalGIN", layout="sparse")
    profile_captured_step(torch, sparse_test, sparse_host, "CausalGIN", layout="sparse")
    lap("causal_gin")
    # the GCN, GIN and GAT baselines: one short run each on both layouts
    baseline_launches = {}
    for model in ("GCN", "GIN", "GAT"):
        baseline_launches[f"train_dense_{model}"] = baseline_phase(
            torch, model, "dense", len(val_set), len(test_set))
        baseline_launches[f"train_sparse_{model}"] = baseline_phase(
            torch, model, "sparse", len(sparse_val), len(sparse_test))
    lap("baselines")

    # the real-data protocol: SYNREDDIT on the dense layout at N = 3,840,
    # where the GAT convs take the edge-formulated kernel; the kernels on one
    # batch, rows 1, 2 and 2b at that N, main_real, a step profile, and the
    # flash/edge crossover sweep
    from cal_tpu_torch.data.loader import compute_budgets
    from cal_tpu_torch.nn.layers import takes_edge_kernel

    root, real_ds = real_data()
    real_graphs = list(real_ds)
    real_host = next(Loader(real_graphs, B, budgets=compute_budgets(real_graphs, B))
                     .host_batches())
    real_batch = real_host.to("cuda")
    emit({"phase": "real_batch", "batch": list(real_host.x.shape),
          "slots": int(real_host.edge_flat.shape[0]), "eg_budget": real_host.eg_budget,
          "live_slots": int((real_host.edge_flat < B * 3840 * 3840).sum()),
          "edge_flat_dtype": str(real_host.edge_flat.dtype)})
    check(real_host.x.shape[1] == 3840 and takes_edge_kernel(real_host, 3840),
          f"SYNREDDIT batch {real_host.x.shape}, eg_budget {real_host.eg_budget}: "
          "not on the edge-formulated kernel")
    edge_rows = edge_kernel_rows(torch, real_batch, peaks, flush)
    at_scale = dense_rows_at_scale(torch, real_batch, peaks, flush)
    del real_batch
    lap("real_kernels")
    real_launches = real_protocol_phase(torch, root, real_ds)
    for line in at_scale:   # launches: main_real's run, the rows' main path at this N
        emit({**line, "launches": real_launches[REAL_COUNTER[line["name"]]]})
    profile_train_step(torch, real_graphs, real_host, "CausalGAT")
    profile_captured_step(torch, real_graphs, real_host, "CausalGAT")
    lap("real_protocol")
    crossover_sweep(torch, flush)
    lap("gat_crossover")

    # packed sparse batches: main_syn --pack_batches true, main_real on
    # SYNREDDIT --layout sparse, packed against worst-case graphs/s; then the
    # benchmark entry point, whose config 4 is row 12's main path
    packed_train_phase(torch, (sparse_train, sparse_val, sparse_test))
    packed_real_phase(torch, root, real_ds)
    lap("packed")
    bench_launches = bench_phase(torch)
    lap("bench")

    # phase 10: the parity entry point at full size (rows 3, 4 and 9's only
    # run), then rows 3, 4, 9 and 14's kernels against their twins, timed
    parity_launches = parity_phase(torch)
    lap("parity")
    dense_rows = dense_row_kernels(torch, batch, peaks, flush)
    emit({"phase": "dense_digests", **dense_digests(torch, batch)})
    serve_batch = next(Loader(sparse_test, B, layout="sparse").host_batches()).to("cuda")
    row_rows = {dt: {**dense_rows[dt], **r} for dt, r in sparse_row_kernels(
        torch, serve_batch, "synthetic", peaks, flush).items()}
    del serve_batch
    lap("row_kernels")

    # launches: the training run of the model whose slice brought the kernel
    # (its main path); every run's counts beside them
    rows = []
    for r in results["bfloat16"]:
        counter, model, src, rep = KERNEL_ROWS[r["name"]]
        by_run = {f"{kind}_{m}": counts[m].get(counter, 0)
                  for kind, counts in (("train", training), ("serve", serving)) for m in counts}
        rows.append({"name": r["name"], "route": "cuda", "source": src, "replaces": rep,
                     "launches": training[model][counter], "launches_by_run": by_run,
                     "max_abs_err": r["max_abs_err"],
                     "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "dtype": "bfloat16",
                     **({"live_cells": r["live_cells"]} if "live_cells" in r else {})})
    for table, kernel_rows, main_run in (
            (SPARSE_KERNEL_ROWS, sparse_rows, sparse_launches),
            (SPARSE_BWD_KERNEL_ROWS, bwd_rows, sparse_train_launches)):
        for kernel, (src, rep) in table.items():
            r = kernel_rows["bfloat16"][kernel]
            by_run = {"train_sparse_CausalGCN": sparse_train_launches[kernel]}
            if kernel in sparse_launches:
                by_run["serve_sparse_CausalGCN"] = sparse_launches[kernel]
            rows.append({"name": kernel, "route": "cuda", "source": src, "replaces": rep,
                         "launches": main_run[kernel], "launches_by_run": by_run,
                         "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                         "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"], "dtype": "bfloat16"})
    for kernel, (src, rep) in GAT_KERNEL_ROWS.items():
        r = gat_rows["bfloat16"][kernel]
        by_run = {"train_sparse_CausalGAT": gat_train_launches[kernel]}
        if kernel in gat_serve_launches:
            by_run["serve_sparse_CausalGAT"] = gat_serve_launches[kernel]
        rows.append({"name": kernel, "route": "cuda", "source": src, "replaces": rep,
                     "launches": gat_train_launches[kernel], "launches_by_run": by_run,
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "dtype": "bfloat16"})
    for kernel, (src, rep) in COO_KERNEL_ROWS.items():
        r = coo_rows["bfloat16"][kernel]
        by_run = {"train_sparse_CausalGIN": gin_train_launches[kernel],
                  **{run: c[kernel] for run, c in baseline_launches.items() if c[kernel]}}
        if kernel in gin_serve_launches:
            by_run["serve_sparse_CausalGIN"] = gin_serve_launches[kernel]
        # no model's coefficient needs a gradient: K12's run is the parity run
        main_run = parity_launches if kernel == "coo_sddmm" else gin_train_launches
        rows.append({"name": kernel, "route": "cuda", "source": src, "replaces": rep,
                     "launches": main_run[kernel], "launches_by_run": by_run,
                     "on_main_path": kernel != "coo_sddmm",
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "dtype": "bfloat16"})
    for kernel, (src, rep) in EDGE_KERNEL_ROWS.items():
        r = edge_rows["bfloat16"][kernel]
        rows.append({"name": kernel, "route": "cuda", "source": src, "replaces": rep,
                     "launches": real_launches[kernel],
                     "launches_by_run": {"real_CausalGAT_SYNREDDIT": real_launches[kernel]},
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "dtype": "bfloat16"})
    for kernel, (src, rep) in SIGMOID_KERNEL_ROWS.items():
        r = sig_rows[("bfloat16", False)][kernel]
        rows.append({"name": kernel, "route": "cuda", "source": src, "replaces": rep,
                     "launches": bench_launches[kernel],
                     "launches_by_run": {"bench_config4": bench_launches[kernel]},
                     "max_abs_err": max(t[kernel]["max_abs_err"] for t in sig_rows.values()),
                     "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "dtype": "bfloat16"})
    for kernel, (src, rep) in ROW_KERNEL_ROWS.items():
        r = row_rows["bfloat16"][kernel]
        rows.append({"name": kernel, "route": "cuda", "source": src, "replaces": rep,
                     "launches": parity_launches[kernel],
                     "launches_by_run": {"parity": parity_launches[kernel]},
                     "on_main_path": False,
                     "max_abs_err": max(t[kernel]["max_abs_err"] for t in row_rows.values()),
                     "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "dtype": "bfloat16"})
    for r in rows:
        r["launches_by_run"].setdefault("parity", parity_launches[r["name"]]
                                        if r["name"] in parity_launches
                                        else parity_launches[KERNEL_ROWS[r["name"]][0]])
    check(len(rows) == 37, f"{len(rows)} kernel rows")
    # every row has launches in the run that reaches it; row 14 has no run
    check(all((r["launches"] > 0) != (r["name"] in OFF_MAIN_PATH) for r in rows),
          "a kernel row has no launch in the run that reaches it")
    emit({"phase": "timing", "seconds": laps, "total_s": time.perf_counter() - start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


# the coefficient SpMM walk's instantiations: kernel -> its row's name
WALK_KERNELS = {"K2": "pair_coef_spmm", "K2T": "pair_coef_spmm_t", "K3": "plain_coef_spmm",
                "K3T": "plain_coef_spmm_t", "K11": "coo_spmm", "K11T": "coo_spmm_t",
                "K14": "sigmoid_coef_spmm", "K14T": "sigmoid_coef_spmm_t",
                "K19": "coo_spmm_mh", "K19T": "coo_spmm_mh_t"}


def walk_table(label, *tables) -> dict:
    """The walk's rows of one batch from the row functions' returns ({dtype:
    {row name: row}}; row 12's keyed (dtype, negate), negate False taken):
    {kernel: {dtype: kernel, library and bound ms}}."""
    out = {}
    for t in tables:
        for key, rows in t.items():
            if isinstance(key, tuple) and key[1]:
                continue
            dt_name = key[0] if isinstance(key, tuple) else key
            for k, name in WALK_KERNELS.items():
                if name in rows:
                    r = rows[name]
                    out.setdefault(k, {})[dt_name] = {
                        "kernel_ms": r["kernel_ms"], "library_ms": r["library_ms"],
                        "bound_ms": r["bound_ms"], "max_abs_err": r["max_abs_err"]}
    return {"phase": "walk_rows", "batch": label, "kernels": out}


def copy_floor(torch, g, label, flush) -> dict:
    """The time of one ``copy_`` of a bf16 [V, H] into an f32 [V, H] on
    batch ``g``'s V, cold L2 as the kernel rows: the bytes K11 must move
    (x read once, the f32 output written once) on this timing protocol."""
    x = torch.randn((g.num_nodes, H), device="cuda").bfloat16()
    out = torch.empty((g.num_nodes, H), device="cuda")
    return {"phase": "copy_floor", "batch": label, "bytes": g.num_nodes * H * 6,
            "ms": time_ms(torch, lambda: out.copy_(x), flush)}


def fill_floor(torch, g, label, flush) -> dict:
    """The time of one ``fill_`` of a bf16 and of an f32 [V, H] on batch
    ``g``'s V, cold L2 as the kernel rows: the bytes K7 must write (dx
    written once) on this timing protocol."""
    out = {"phase": "fill_floor", "batch": label}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x = torch.empty((g.num_nodes, H), dtype=dt, device="cuda")
        out[dt_name] = {"bytes": x.numel() * x.element_size(),
                        "ms": time_ms(torch, lambda: x.fill_(1.0), flush)}
    return out


def sparse_test_graphs() -> list:
    """The canonical dataset's test split (data_num SPARSE_DATA_NUM, 1,600
    graphs)."""
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset

    ds = generate_synthetic_dataset(data_num=SPARSE_DATA_NUM, seed=SEED)
    return dataset_bias_split(ds, bias=0.5, total=SPARSE_DATA_NUM * 4, seed=SEED)[2]


def sparse_batches(torch, sparse_test=None) -> dict:
    """The sparse kernel batches: a serving batch of the canonical dataset
    (V 31,744; of ``sparse_test``, made when None), a batch of 128
    REDDIT-shaped threads and the benchmark's config-4 graph, on the
    card."""
    from cal_tpu_torch.bench import spmm_workload
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.data.reddit_synthetic import reddit_graphs

    sparse_test = sparse_test_graphs() if sparse_test is None else sparse_test
    return {"synthetic": next(Loader(sparse_test, B, layout="sparse").host_batches()).to("cuda"),
            "reddit": next(Loader(reddit_graphs(B, seed=SEED, feat=10), B,
                                  layout="sparse").host_batches()).to("cuda"),
            "bench_config4": spmm_workload(8192, 131072, H, "cuda", torch.bfloat16)[0]}


def walk_main() -> int:
    """``--walk``: the coefficient SpMM walk alone, for an A/B of two trees
    (run this file from the other tree's root): the build's ptxas report of
    the walk and of K7, each sparse batch's csr_profile, every sparse kernel
    held against its twin and timed on the serving and REDDIT batches (row
    12 also on config 4's graph; K1, K13, K5, K6, K15, K16, K7, K4, K12 and
    K20 with the warm device ms of each kernel a call launches, K4 beside a cold
    ``torch.sum`` of its x over dim 0), the walk's rows by batch, the ``copy_`` and ``fill_`` floors
    of each batch, the digests (the chain's and the degrees' among the
    sparse ones), and two sparse CausalGCN ``profile_train_step`` lines (the
    step's kernels and device ms)."""
    import torch

    if missing(torch):
        return 2
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
    from cal_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks, _ = peaks_for(name)
    report = build.build_all()
    emit({"phase": "env", "root": HERE, "nvidia_smi": smi, "device": name,
          "ptxas_walk": ptxas_walk(report), "ptxas_pool": ptxas_instances(report, ["pool"])})
    sparse_test = sparse_test_graphs()
    batches = sparse_batches(torch, sparse_test)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for label, g in batches.items():
        emit(csr_profile(g, label))
        emit(copy_floor(torch, g, label, flush))
        emit(fill_floor(torch, g, label, flush))
    for label in ("synthetic", "reddit"):
        g = batches[label]
        emit(walk_table(label, sparse_kernel_rows(torch, g, label, peaks, flush),
                        sparse_bwd_kernel_rows(torch, g, label, peaks, flush),
                        coo_kernel_rows(torch, g, label, peaks, flush),
                        sigmoid_kernel_rows(torch, g, label, peaks, flush),
                        sparse_row_kernels(torch, g, label, peaks, flush)))
    g = batches["bench_config4"]
    emit(walk_table("bench_config4", sigmoid_kernel_rows(torch, g, "bench_config4", peaks,
                                                         flush)))
    emit({"phase": "sparse_digests", "root": HERE, **sparse_digests(
        torch, {k: batches[k] for k in ("synthetic", "reddit")})})
    ds = generate_synthetic_dataset(data_num=DATA_NUM, seed=SEED)
    _, _, test_set, _ = dataset_bias_split(ds, bias=0.5, total=DATA_NUM * 4, seed=SEED)
    batch = next(Loader(test_set, B).host_batches()).to("cuda")
    emit({"phase": "dense_digests", "root": HERE, **dense_digests(torch, batch)})
    # the sparse CausalGCN step the walk's kernels serve: its kernels and device ms, twice
    host = next(Loader(sparse_test, B, layout="sparse").host_batches())
    for _ in range(2):
        profile_train_step(torch, sparse_test, host, "CausalGCN", layout="sparse")
    emit({"phase": "walk_done", "seconds": time.perf_counter() - start, "nvidia_smi": smi})
    return 0


def ptxas_k21(report: dict) -> dict:
    """{kernel: registers, spill bytes} of K21's kernel in coo_spmm.cu
    (csr_reduce_kernel), from nvcc's ``-Xptxas -v`` log."""
    out, name = {}, None
    for ln in report.get("coo_spmm", {}).get("log", "").splitlines():
        m = re.search(r"Function properties for \w*?(csr_reduce_kernel)", ln)
        if "Function properties for" in ln:
            name = m.group(1) if m else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if name and m:
            out[name] = {"spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))}
        m = re.search(r"Used (\d+) registers", ln)
        if name and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def dual_row(torch, batch, peaks, flush) -> None:
    """Row 2 (the dual forward) on the synthetic dense batch (N = 256), bf16
    and f32, against its twin, timed and split into the degree pass and the
    aggregate."""
    from cal_tpu_torch.graph import to_dense
    from cal_tpu_torch.ops import fused_gcn as fg

    bw, bf16_peak, f32_peak = peaks
    bsz, n, _ = batch.x.shape
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        adj = to_dense(batch, dt).adj
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        xc, xo = (torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt) for _ in range(2))
        src = torch.randn((bsz, n), generator=gen, device="cuda").to(dt)
        dst = (2.0 * torch.randn((bsz, n), generator=gen, device="cuda")).to(dt)
        args = (xc, xo, adj, src, dst)
        got, ref = fg.fused_gcn_dense_att_dual(*args), fg.fused_gcn_dense_att_dual_plain(*args)
        err = max(_held(torch, "row 2", dt_name, a, r, DUAL_TOL[dt_name])
                  for a, r in zip(got, ref))
        line = _row(torch, "fused_gcn_dense_att_dual_fwd", dt_name,
                    lambda: fg.fused_gcn_dense_att_dual(*args),
                    lambda: fg.fused_gcn_dense_att_dual_plain(*args),
                    (bsz * n * n + 4 * bsz * n * H + 2 * bsz * n) * elt, 4 * bsz * n * n * H,
                    bf16_peak if dt == torch.bfloat16 else f32_peak, err, DUAL_TOL[dt_name],
                    bw, flush, batch=[bsz, n, H])
        emit({"phase": "row2_split", "dtype": dt_name, "kernel_ms": line["kernel_ms"],
              **forward_split(torch, lambda: fg.fused_gcn_dense_att_dual(*args))})


def adj_rows(torch, batch, peaks, flush) -> None:
    """Row 1 (the adjacency build) on the synthetic dense batch (B = 128, N =
    256), bf16 and f32: exact against its twin, timed beside torch.bincount,
    with the warm device ms of each kernel a call launches (``passes``) and
    the cold time of one ``fill_`` of the [B, N, N] output's bytes
    (``fill_floor_ms``), its write floor on this protocol."""
    from cal_tpu_torch.ops.adj_build import adj_build, adj_build_plain

    ef = batch.edge_flat
    bsz, n, _ = batch.x.shape
    ef64 = ef.long()
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        check(torch.equal(adj_build(ef, bsz, n, dt), adj_build_plain(ef, bsz, n, dt)),
              f"adj_build {dt_name} differs from its plain twin")
        plane = torch.empty((bsz, n, n), dtype=dt, device="cuda")
        nbytes = plane.numel() * plane.element_size()
        _row(torch, "adj_build", dt_name, lambda: adj_build(ef, bsz, n, dt),
             lambda: adj_build_plain(ef, bsz, n, dt), ef.shape[0] * ef.element_size() + nbytes,
             0, 1.0, 0.0, (0.0, 0.0), peaks[0], flush,
             lambda: torch.bincount(ef64, minlength=bsz * n * n + 1),
             "torch.bincount(edge_flat.long(), minlength=B*N*N+1)", batch=[bsz, n],
             edges=ef.shape[0], real_edges=int((ef < bsz * n * n).sum()),
             passes=profile_passes(torch, lambda: adj_build(ef, bsz, n, dt)),
             fill_floor_ms=time_ms(torch, lambda: plane.fill_(1.0), flush),
             fill_floor_bytes=nbytes)


def rows_main() -> int:
    """``--rows``: the dense rows and K21 alone, for an A/B of two
    trees (run this file from the other tree's root): the build's ptxas
    report of the dense kernels and K21; row 1 at N = 256 (bf16, f32) with
    its passes and ``fill_`` floor; row 2 at N = 256 (bf16, f32) split
    into the degree pass and the aggregate; rows 4 and 3 (K17/K17T, K18/K18B;
    f32 K17 on the two-pass path) at N = 256 and K17/K17T two-pass at N =
    640; K21 on the serving and REDDIT batches beside scatter_reduce_ amax;
    the dense and sparse digests; then rows 1, 2 and 2b at N = 3,840 on the
    first SYNREDDIT batch (2b handed the forward's statistics and live map,
    and alone), with their digests; then two dense CausalGCN
    ``profile_train_step`` lines (the step's kernels and device ms)."""
    import torch

    if missing(torch):
        return 2
    from cal_tpu_torch.data.loader import Loader, compute_budgets
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
    from cal_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks, _ = peaks_for(name)
    report = build.build_all()
    log = report.get("fused_gcn", {}).get("log", "")
    emit({"phase": "env", "root": HERE, "nvidia_smi": smi, "device": name,
          "ptxas_dense_fwd": ptxas_kernels(
              log, "plain_cluster_kernel|aggregate_mma_kernel|aggregate_fma_kernel|"
              "degree_wide_kernel|degree_col_kernel"),
          "ptxas_dense_bwd": ptxas_kernels(log, r"bwd_\w*?_kernel"),
          "ptxas_k21": ptxas_k21(report)})
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    ds = generate_synthetic_dataset(data_num=DATA_NUM, seed=SEED)
    _, _, test_set, _ = dataset_bias_split(ds, bias=0.5, total=DATA_NUM * 4, seed=SEED)
    batch = next(Loader(test_set, B).host_batches()).to("cuda")
    adj_rows(torch, batch, peaks, flush)
    dual_row(torch, batch, peaks, flush)
    dense_row_kernels(torch, batch, peaks, flush)
    emit({"phase": "dense_digests", "root": HERE, **dense_digests(torch, batch)})
    batches = sparse_batches(torch)
    for label in ("synthetic", "reddit"):
        g = batches[label]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        vals = torch.randn((4, g.senders.shape[0]), generator=gen, device="cuda")
        vals = torch.where(g.edge_mask[None], vals, torch.full_like(vals, -1e30))
        segment_max_row(torch, g, label, peaks, flush, 4, "float32", vals)
    emit({"phase": "sparse_digests", "root": HERE, **sparse_digests(
        torch, {k: batches[k] for k in ("synthetic", "reddit")})})
    del batches
    _, real_ds = real_data()
    graphs = list(real_ds)
    real_batch = next(Loader(graphs, B, budgets=compute_budgets(graphs, B))
                      .host_batches()).to("cuda")
    for line in dense_rows_at_scale(torch, real_batch, peaks, flush):
        emit(line)
    del real_batch
    # the dense CausalGCN step row 1 serves (main_syn): its kernels and device ms, twice
    host = next(Loader(test_set, B).host_batches())
    for _ in range(2):
        profile_train_step(torch, test_set, host, "CausalGCN")
    emit({"phase": "rows_done", "seconds": time.perf_counter() - start, "nvidia_smi": smi})
    return 0


def real_batch(torch):
    """The first dense batch of SYNREDDIT (B = 128, N = 3,840), on the card."""
    from cal_tpu_torch.data.loader import Loader, compute_budgets

    _, real_ds = real_data()
    graphs = list(real_ds)
    return next(Loader(graphs, B, budgets=compute_budgets(graphs, B)).host_batches()).to("cuda")


def edge_main() -> int:
    """``--edge``: rows 6 and 6b alone, for an A/B of two trees (run this
    file from the other tree's root): the build's ptxas report of the edge
    kernels, the first SYNREDDIT batch's edge index line, the forward and
    backward held against their twins and timed in bf16 and f32 at dropout
    0 and GAT_RATE as a layer's step calls them, and the edge digests."""
    import torch

    if missing(torch):
        return 2
    from cal_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks, _ = peaks_for(name)
    report = build.build_all()
    emit({"phase": "env", "root": HERE, "nvidia_smi": smi, "device": name,
          "build_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas_edge": ptxas_edge(report)})
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    batch = real_batch(torch)
    edge_kernel_rows(torch, batch, peaks, flush, rates=(0.0, GAT_RATE), autograd=False)
    emit({"phase": "edge_digests", "root": HERE, **edge_digests(torch, batch)})
    emit({"phase": "edge_done", "seconds": time.perf_counter() - start, "nvidia_smi": smi})
    return 0


def dense_batch(torch):
    """The first dense test batch of the synthetic set (B = 128, N = 256),
    on the card."""
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset

    ds = generate_synthetic_dataset(data_num=DATA_NUM, seed=SEED)
    _, _, test_set, _ = dataset_bias_split(ds, bias=0.5, total=DATA_NUM * 4, seed=SEED)
    return next(Loader(test_set, B).host_batches()).to("cuda")


def flash_main() -> int:
    """``--flash``: rows 5 and 5b alone, for an A/B of two trees (run this
    file from the other tree's root): the ptxas report of the flash kernels,
    the forward and backward held against their twins in bf16 and f32 at
    dropout 0 and GAT_RATE and timed at both rates on the first dense test
    batch's counts (cold L2, with the warm split by kernel), and the flash
    digests."""
    import torch

    if missing(torch):
        return 2
    from cal_tpu_torch.kernels import build
    from cal_tpu_torch.ops.adj_build import adj_build

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks, _ = peaks_for(name)
    report = build.build_all(["adj_build", "flash_gat"])
    emit({"phase": "env", "root": HERE, "nvidia_smi": smi, "device": name,
          "build_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas_flash": ptxas_flash(report)})
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    batch = dense_batch(torch)
    bsz, n, _ = batch.x.shape
    digests = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        counts = adj_build(batch.edge_flat, bsz, n, dt)
        flash_kernels(torch, counts, dt_name, peaks, flush, rates=(0.0, GAT_RATE), split=True)
        digests.update(flash_digests(torch, counts))
    emit({"phase": "flash_digests", "root": HERE, **digests})
    emit({"phase": "flash_done", "seconds": time.perf_counter() - start, "nvidia_smi": smi})
    return 0


def gat_main() -> int:
    """``--gat``: row 13 (K8, K9, K9T, K10) alone, for an A/B of two trees
    (run this file from the other tree's root): the ptxas report of
    gat_sparse.cu's kernels, the four held against their twins and timed in
    bf16 and f32 at dropout 0 and GAT_RATE on the serving and REDDIT batches
    (cold L2, with the warm split by launch), and the sparse digests (K8's m
    and den, K10's dtj and dti among them)."""
    import torch

    if missing(torch):
        return 2
    from cal_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks, _ = peaks_for(name)
    report = build.build_all(["gat_sparse", "spmm", "coo_spmm", "pool"])
    emit({"phase": "env", "root": HERE, "nvidia_smi": smi, "device": name,
          "build_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas_gat": ptxas_gat(report)})
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    batches = sparse_batches(torch)
    for label in ("synthetic", "reddit"):
        g = batches[label]
        emit(csr_profile(g, label))
        gat_kernel_rows(torch, g, label, peaks, flush, split=True)
    emit({"phase": "sparse_digests", "root": HERE, **sparse_digests(
        torch, {k: batches[k] for k in ("synthetic", "reddit")})})
    emit({"phase": "gat_done", "seconds": time.perf_counter() - start, "nvidia_smi": smi})
    return 0


def epoch_main() -> int:
    """``--epoch``: the training paths' step and epoch times, for an A/B of
    two trees of the port (run this file from each tree's root with
    ``PYTHONPATH`` set to it).  Builds every kernel, then: dense CausalGCN
    and CausalGAT at B 128, N 256 (``profile_train_step`` and, where the
    tree has the device-side epoch, ``profile_captured_step``); sparse
    CausalGCN, CausalGAT and CausalGIN on the canonical serving batch (V
    31,744, E 128,000) and dense CausalGAT on the first SYNREDDIT batch (B
    128, N 3,840, the edge kernel), each eager and, where the tree captures
    that path, captured; ``main_real`` on SYNREDDIT, dense CausalGAT and
    packed sparse CausalGCN (epoch seconds); the captured-epoch phase's
    cases the tree supports; the benchmark's configs 1-3; and the serving
    sweep's graphs/s (``serving_rates``, on the canonical test split)."""
    import torch

    if missing(torch):
        return 2
    from cal_tpu_torch import graph
    from cal_tpu_torch.data.loader import Loader, compute_budgets
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
    from cal_tpu_torch.kernels import build
    from cal_tpu_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    emit({"phase": "env", "root": HERE, "torch": torch.__version__,
          "build_seconds": time.perf_counter() - t0,
          "nvidia_smi": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
              capture_output=True, text=True, timeout=60).stdout.strip()})
    captured = hasattr(steps, "make_causal_train_epoch")
    # the tree captures the sparse layout and the edge GAT (fixed-size lists)
    captured_all = captured and hasattr(graph, "heavy_capacity")
    ds = generate_synthetic_dataset(data_num=DATA_NUM, seed=SEED)
    _, _, test_set, _ = dataset_bias_split(ds, bias=0.5, total=DATA_NUM * 4, seed=SEED)
    host = next(Loader(test_set, B).host_batches())
    for model in ("CausalGCN", "CausalGAT"):
        profile_train_step(torch, test_set, host, model)
        if captured:
            profile_captured_step(torch, test_set, host, model)
    ds = generate_synthetic_dataset(data_num=SPARSE_DATA_NUM, seed=SEED)
    _, _, sparse_test, _ = dataset_bias_split(ds, bias=0.5, total=SPARSE_DATA_NUM * 4,
                                              seed=SEED)
    del ds
    serving_rates(torch, sparse_test)
    sparse_host = next(Loader(sparse_test, B, layout="sparse").host_batches())
    for model in ("CausalGCN", "CausalGAT", "CausalGIN"):
        profile_train_step(torch, sparse_test, sparse_host, model, layout="sparse")
        if captured_all:
            profile_captured_step(torch, sparse_test, sparse_host, model, layout="sparse")
    root, real_ds = real_data()
    real_graphs = list(real_ds)
    real_host = next(Loader(real_graphs, B, budgets=compute_budgets(real_graphs, B))
                     .host_batches())
    profile_train_step(torch, real_graphs, real_host, "CausalGAT")
    if captured_all:
        profile_captured_step(torch, real_graphs, real_host, "CausalGAT")
    del real_host
    real_epochs(torch, root, "CausalGAT", "dense")
    real_epochs(torch, root, "CausalGCN", "sparse")
    if captured:
        for model, case in CAPTURE_CASES:
            if case == "dense" or captured_all:
                captured_epoch_phase(torch, model, case)
    bench_configs_12(torch)
    bench_config_3(torch)
    return 0


def digests_main() -> int:
    """``--digests``: only the dense_digests, sparse_digests and
    edge_digests lines (the last on the first SYNREDDIT batch), for
    comparing the bits of two trees of the port (run this file from the
    other tree's root)."""
    import torch

    if missing(torch):
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = dense_batch(torch)
    emit({"phase": "dense_digests", "root": HERE, **dense_digests(torch, batch)})
    batches = sparse_batches(torch)
    emit({"phase": "sparse_digests", "root": HERE, **sparse_digests(
        torch, {k: batches[k] for k in ("synthetic", "reddit")})})
    del batches
    emit({"phase": "edge_digests", "root": HERE, **edge_digests(torch, real_batch(torch))})
    return 0


if __name__ == "__main__":
    modes = {"--digests": digests_main, "--walk": walk_main, "--rows": rows_main,
             "--edge": edge_main, "--flash": flash_main, "--gat": gat_main,
             "--epoch": epoch_main}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in modes else main())
