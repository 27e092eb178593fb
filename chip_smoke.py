#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (proxsdp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit, torch and CUDA versions, and
   builds the port's CUDA kernels from kernels/csrc with nvcc (one process
   per source, in parallel);
2. phase A: solves maxcut_problem(random_graph_weights(0, 250)) with
   Options(hybrid_precision=False) (the f64 program, dense eigh) twice,
   times the second solve, counts its launches, and checks status,
   objective and X against the JAX package's constants;
3. phase B: checks each kernel entry point of the default path against its
   plain PyTorch version on the card at that path's side-250 shapes (f64
   and f32 K1-K4, K5-K8 at k = 24 in f32 and k = 16 in the mixed f64
   polish, K5 also on the polar reseed's column slices of the basis), and
   times it beside the plain version and, where one PyTorch call computes
   the same function, that call; the mixed-type entry points of the f64
   program's polar reseed, which the side-250 solves do not run, are
   checked alike;
   Phase B also holds the batch path's kernels to their plain versions:
   K9 (the batched Jacobi PSD projection) at sides 2-64 in f32 and f64 on
   1024 random, rank-deficient and non-finite matrices, K10 (the
   packed-triangle gathers) and the batched K1-K4 entry points at phase
   D's shapes;
4. phase C: solves the same instance with the default Options() (the
   hybrid f32 race and f64 polish) twice, times the second, counts its
   launches, checks status, objective and X, and prints its phase events
   beside the JAX package's;
5. phase D: solve_batch of 1024 side-16 max-cut instances at
   Options(tol_gap=1e-4, tol_feasibility=1e-4), a first solve then a
   timed warm one: every status 1, each X within the solver's feasibility
   bound and PSD, instances 0-15 against the JAX package's batch solve
   under the same Options() (2e-4 (1 + |obj|) each; its f64 solve
   reported beside it); prints
   instances/s, the iteration spread, the f32 race's length, and from a
   profiled window of each program the launches per iteration and each
   batch kernel's device time per launch.

   Phase B also holds the giant sides' kernels to their plain versions:
   K11 (the Lanczos recurrence) at n = 1100, 2000 and 5000 (ncv 34, 62,
   156) in f64 and f32 on five inputs, with the Ritz step
   (ops.lanczos.ritz_pairs) after it, timed beside torch.linalg.eigh of
   the same X; and K5-K8 at the side-2000 shapes: K7 at k = 32, 128,
   192, 256, K8 at the race's buckets and the polish's, K5 on square
   products, on the reseed's column slices and as the Ritz rotation, K6
   in every type pair; then K5 and K7 at ragged, unaligned and
   degenerate shapes, checked and not timed (edge_kernel_checks);
6. phase E: the default Options(chunk_iters=256) solve of
   maxcut_problem(random_graph_weights(0, 2000)) (maxG32's side), once:
   status 1, the objective within 2e-4 (1 + |obj|) of the JAX package's,
   X within the solver's feasibility bound and PSD; prints the phase
   events, the timers, the host eighs' seconds and a dual bound;
7. phase F: 300 iterations of the f64 Lanczos program
   (Options(hybrid_precision=False)) on that instance from init_state,
   against the JAX package's accept sequence and last iterate, K11's
   launches and device time; then solve(max_iter=300), status 3.

   Phase B also holds phase G's kernels to their plain versions: K12
   (the batched accept-always subspace step) in f32, the mixed mode and
   f64 at B = 256, side 40, k = 16 and B = 64, side 100, k = 16 and 24,
   one instance non-finite and one exactly 0, timed beside the library
   route (torch.linalg.qr, torch.bmm, torch.linalg.eigh); K9 at side 40
   (B = 256), 100 and 118 in f64, 100 and 168 in f32 (B = 64); K10 and
   the batched K1-K4 at G1's and G2's shapes;
8. phase G: solve_batch's subspace mode under Options(tol_gap=1e-4,
   tol_feasibility=1e-4) and projection "auto": G1, 256 max-cut
   instances of side 40 (one counted solve), G2,
   64 of side 100 (one solve).  Every status 1, each X within the
   solver's feasibility bound and PSD, the objectives against the exact
   optima within the JAX solve's own scatter; prints instances/s, each
   phase's seconds, each host reseed and program switch beside the JAX
   driver's, and from a profiled window of each program K12's and K9's
   launches and device us per launch and the device's busy share.

   Phase B also holds phases H and I's kernels to their plain versions:
   K3 with a row scale at H's shape and over I's 33-block table, K4 over
   that table, K13 (the SOC projection) at I's 128 blocks and at 4096
   blocks of lengths 2-257, K14 (the COO products) on H's and I's
   operators, K9 at I's (32, 19, 19) stack;
9. phase H: the Lovasz-theta SDP of a random graph on 300 vertices with
   4374 edges (SDPLIB theta6's n and m; square form n = 90,000, the COO
   operator, a row-norm spread of 24.5), three solves.  H1, the default
   Options(chunk_iters=256): the block-equilibration probe (its arms
   stop at the 20 s clock, or solve inside it), then the winner's solve;
   the objective within 2e-4 (1 + |obj|) of the JAX package's answer on
   the arm that won (the equilibrated arm's answers span H_EQ_REF_RANGE
   as the clock moves; a default arm that solved inside its round, the
   JAX answers over f32 race ends, H_UNCUT_REF_RANGE); the probe's
   rounds and winner printed beside the JAX run's.  H2,
   block_equilibration_probe_iters=500 (the arms stop at that depth):
   the JAX run's rounds and winner (the equilibrated arm), the objective
   within 2e-4 (1 + |obj|) of its.  H3, at 2000 (below both arms' solve
   points): the objective within 2e-4 (1 + |obj|) of the JAX answer of
   the arm that won, a winner other than the JAX run's printed.  All:
   status 1, tr X = 1 and X_ij = 0 on the edges within the solver's
   feasibility bound, X PSD, no probe arm raised; K3 launched with a row
   scale;
10. phase I: a seeded program with every block kind (32 PSD blocks of
   side 19, one of side 200, 128 SOC blocks of length 16, 400 LP
   coordinates, 600 equality rows; conic_program_data): 300 iterations
   of the f64 program from init_state against the JAX package's iterate
   (1e-6 relative), then the default Options(chunk_iters=256) solve
   against the JAX run's status and objective, every PSD block PSD and
   every SOC block within tol_soc;
11. phase J: the certificate search.  J1, the side-124 max-cut with the
   equality X_00 = -1 appended (infeasible), at J1_OPTS; J2, the same
   graph with X_00 free and rewarded (unbounded), at J2_OPTS; status,
   certificate_found and status string against the JAX package's runs
   (J1_REF, J2_REF), the declaration, the final iteration and the ray's
   farkas() value printed beside them; J3, the first J3_SIZE (256) of
   phase D's instances with one of them infeasible through solve_batch:
   the others status 1, that one
   status 6 with a ray after the batch's re-entry into solve.

   Phase B also holds K15 and K15b (the linesearch's trial loop) to the
   K2 -> product -> sq_dist sequence they replace, bit for bit in f64,
   at the shapes of phases A, C, D, G, H, I and J; K2 and sq_dist
   themselves run only on the tensor-parallel path (phase O).
12. phase K: per-instance operators in solve_batch and the API.  K1,
   solve_batch of randsdp_problem(s, 40, 20, varbounds=False) for s < 8
   ("dense_batched") at Options(tol_gap=1e-4, tol_feasibility=1e-4),
   projection "eigh": every status 1, feasibility within the solver's
   bound, PSD, randsdp's relative violation and the objectives beside
   the optimum and the JAX batch of instances 0-7 (printed: C19); then
   the f64 program of instances 0-7 for 300 iterations against the JAX
   package's (1e-6).  K3, 64 max-cut instances whose diagonal rows carry
   per-instance weights ("ell_batched"): status 1, feasibility, PSD,
   instances 0-7 within 2e-4 (1 + |obj|) of the JAX batch.  K2, the API:
   MIMO n = 100 and sensor localisation n = 100 through
   Optimizer.optimize against the JAX runs (MIMO under the default
   options to 3000 iterations, C18, and in the f64 program to status 1),
   one solve_cone_program and one solve_sdp against known answers.

   Phase B also holds phase K's kernels to their plain versions: K16
   (the batched GEMV, both directions) at K1's (8, 20, 820) stack, K1b'
   (a value stride) at K3's stacked ELL values bit for bit, K15b' over
   K3's per-instance ELL and K1's per-instance dense M'.
13. phase L: solve_batch past one block's shared memory.  L1, 16 max-cut
   instances of side 250 (mcp250's) in the eigh mode (K9L in both
   programs): statuses, feasibility and PSD, objectives within 2e-4 (1 +
   |obj|) of the JAX batch's, then their f64 program on instances 0-3 for
   300 iterations against the JAX package's (1e-6); L3, the same
   instances under Options(projection="polar") (K5b, K6b), against the
   JAX batch; L2, 40 instances of side 500 (mcp500's) in the "auto"
   subspace mode (K12L), against the JAX run lined up for C11 and C12
   within L2_OBJ_RTOL / L2_OBJ_MEAN_RTOL, its reseeds and programs printed
   beside the JAX run's.

   Phase B also holds phase L's kernels to their plain versions: K9L at
   sides 119, 169, 250 and 500 in f64 and f32, K12L (and K12 at L2's f32
   k = 24) at side 500, B = 40, k = 24-256 in f32, the mixed mode and
   f64, K5b and K6b at (16, 250, 250) in f32 and f64 (the side-500 K9L
   and the k = 192, 256 K12L rows checked but not timed).
14. phase M: solve_batch over any cone layout, a sweep of phase I's
   program (conic_sweep_instance: one shared COO operator, each
   instance's b and c).  M1, 16 instances in the eigh mode (K9 on all
   512 side-19 blocks in one launch, K9L on the side-200 ones, K13b,
   K14b, K15b's COO form): statuses, feasibility, every PSD block PSD,
   every SOC block within tol_soc, objectives within 2e-4 (1 + |obj|) of
   the JAX batch's; a profiled window of its f32 program; its f64
   program on instances 0-3 for 300 iterations against the JAX package's
   (1e-6).  M2, the same in the subspace mode (K12 on the side-200 block
   beside K9) against the JAX run lined up for C11 and C12 within phase
   G's bounds, its reseeds and programs printed beside the JAX run's.

   Phase B also holds phase M's kernels to their plain versions and K13b
   and K14b bit for bit to K13 and K14 on each row: K14b and K15b's COO
   form at M's shape and, off the path, at theta's operator (B = 7), K13b
   at M's blocks and at B = 7 instances of 4096 blocks of lengths 2-257,
   K9 at (512, 19, 19), K9L at (16, 200, 200), K12 at (16, 200, 16).

15. phase O: the sharded solves and K18.  Phase O's rows hold K18 (the
   dense-eigh reconstruction, ``kernels.psd_reconstruct``) to its plain
   version at sides 16, 100, 250 and 1024 in f64, f32 and the mixed pair,
   the whole product and the row slabs of 2 and 4 ranks, timed beside
   torch.matmul of the same rows.  Then two ranks, two processes sharing
   the card over gloo (NCCL refuses two ranks on one device;
   ``parallel.dist.spawn``): O1, solve_batch(mesh=...) of 16 side-40
   max-cut instances in the f64 program against the unsharded card batch
   (equal statuses, |dobj| <= 1e-9); O2, solve_sharded of the side-250
   max-cut under the default Options() against the unsharded solve
   (status 1, 1e-4 (1 + |obj|)), then 300 iterations of its f64 program
   against the unsharded card run (bit for bit, else 1e-12 relative),
   with K18's launches a rank, collectives and ms an iteration; and one
   solve_sharded at world size 1 over NCCL in this process.

16. phase P: the iteration's control.  K19 (``kernels.control``: the
   residual formulas, the ring writes and every decision of _control),
   K20a and K20b (``kernels.restart_average`` and ``restart_adopt``: the
   restart's running sums and reductions, the jump to the average) and
   K21 (``kernels.freeze_rows``: the batch's masked freeze) against
   their plain twins on the card: on the states phases C and D recorded
   (their solves' 1st, 100th and last iterations; K19 fed K3's pass-1
   partials, as on the path) and on every crafted branch state of
   ``kernels.control_cases`` (b1, b2 with and without its reset, fire3
   and fire4 under both line_search_flag and step_balance modes,
   statuses 1, 5, 6 and 7, a NaN dual objective, the certificate wait,
   a restart epoch with and without the jump) on the side-250 max-cut
   and a small program with SOC blocks and inequality rows, in f64 and
   f32, single and as batches.  K19, K20b and K21 bit for bit, K20a's
   averages and reductions within 1e-15 (f64) / 1e-6 (f32) relative;
   prints the branches that fired and the CUDA kernels a call of the
   scalar step (at most 4: K3's first pass, K20a, K19, K20b).

    python3 chip_smoke.py --phase-p

builds the kernels, runs phase C's default solve and phase D's batch
solve once each to record their states, then phase P alone with its
kernel rows.

    python3 chip_smoke.py --phase-h

builds the kernels and runs phase H alone, then the equilibrated arm's
path through the default options' probe with the arm capped at 10, 15,
20, 25 and 30 s (as the 20 s clock cuts it on a slower or faster host),
each answer held to 2e-4 (1 + |obj|) of H_EQ_REF_RANGE.

    python3 chip_smoke.py --phase-k

builds the kernels and runs phase K's phase-B rows and phase K alone.

    python3 chip_smoke.py --phase-l

builds the kernels and runs phase L's phase-B rows and phase L alone.

    python3 chip_smoke.py --phase-m

builds the kernels and runs phase M's phase-B rows and phase M alone.

    python3 chip_smoke.py --phase-o

builds the kernels and runs phase O's rows and phase O alone (each
--phase-* run prints its own kernels line, and no device line).

Each phase prints its wall time.  Any failed phase exits non-zero.  The
last line is a JSON object with the device; the line before it lists the
kernels.  A side-2000 row's launches are those of its entry point at its
call shape in phases E and F (every wrapper call there is recorded by
shape); the shapes launched there that no row checks are printed.  It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SIDE = 250
# the JAX package's solve of this instance with Options(hybrid_precision=
# False) (f64, CPU): status 1, 598 iterations, final rank 8
REF_OBJ = 1250.6130819530558
REF_ITERS = 598
# max|diag(X) - 1| of the reference's X.  The solver stops at feasibility
# max|A x - b| / (1 + ||b||) <= tol_feasibility in rhs-scaled units, i.e.
# |X_ii - 1| <= 1e-4 * (1 + 1) * sqrt(250) = 3.16e-3 in user units; the
# checks hold the port to that bound, the solver's own.
REF_DIAG_ERR = 0.003009914531918012
# the JAX package's default Options(chunk_iters=256) solve (the port's
# fixed chunk) on one CPU thread: status 1, 598 iterations, the race's
# subspace rank 24 (observed 14), the hand-over at 597, the polish rank 16
# (observed 8), 143 polar reseeds and 0 dense-eigh fallbacks
HYB_REF_OBJ = 1250.5958191446912
HYB_REF_ITERS = 598
HYB_REF_RACE_RANK = 24
HYB_REF_HANDOVER = 597
HYB_REF_POLISH_RANK = 16
HYB_REF_RESEEDS = 143
HYB_REF_DENSE = 0
HYB_REF_DIAG_ERR = 0.003048931860007542
# phase D: solve_batch of maxcut_problem(random_graph_weights(s, 16)) for s
# in range(1024) at Options(tol_gap=1e-4, tol_feasibility=1e-4) (bench.py's
# BENCH_MODE=batch sweep).  References, the JAX package on the CPU, one
# thread (tests/test_torch_batch.py keeps them true): its batch solve of
# these instances with the same Options() -- the hybrid race and f64
# final phase that phase D runs, the check; each instance reaches an f32
# status inside the race's one chunk and then runs alone, so instances
# 0-15 come out alike in a batch of 16 and of 1024 -- and its f64 solve
# (hybrid_precision=False) of instances 0-15, reported beside it.
# The JAX package's own two modes differ by up to 1.14e-3 (1 + |obj|) on
# this batch (19 % of the instances above 2e-4: each stops at the 1e-4
# tolerances at another point), so the f64 one is not the check.
# Objectives of instances 0-15, all status 1:
BATCH_HYB_REF_OBJ = [
    13.096346594152177, 15.824168555957952, 16.731458929630534,
    16.868796674219332, 15.09873249280418, 15.383250456368378,
    16.358025927318895, 16.652644927898177, 13.837881049053143,
    13.086015867157379, 12.931857506459826, 15.701798501871084,
    13.828233361294478, 13.686190227295912, 14.89206565235259,
    15.42635530147343,
]
BATCH_SIDE = 16
BATCH_SIZE = 1024
BATCH_REF_OBJ = [
    13.096354231526517, 15.823228353787306, 16.731964759981373,
    16.868839224452948, 15.099546908667755, 15.383237994330926,
    16.343638444673857, 16.65271693489418, 13.838146226795732,
    13.08604412776561, 12.917495023848206, 15.70180393787491,
    13.829341803692628, 13.686995447070771, 14.903252826900498,
    15.426360692707982,
]
# phases E and F: maxcut_problem(random_graph_weights(0, 2000)), maxG32's
# side (SDPLIB's maxG32 is not in the repository).  Phase E: the JAX
# package's default Options(chunk_iters=256) solve on the CPU (all 8
# threads of one host, 615 s; its f32 race's sums depend on the thread
# count): status 1, the race's subspace rank, the hand-over, the polish
# rank, the polar reseeds (and 0 dense-eigh fallbacks), final rank 20.
LZ_SIDE = 2000
LZE_REF_OBJ = 30134.04480898839
LZE_REF_ITERS = 1029
LZE_REF_RACE_RANK = 192  # observed 165
LZE_REF_HANDOVER = 1028
LZE_REF_POLISH_RANK = 32  # observed 20
LZE_REF_RESEEDS = 406
# Phase F: LZF_ITERS iterations of the JAX package's f64 Lanczos program
# (Options(hybrid_precision=False)) from init_state, stepped one at a time.
# Iteration 1 projects x0 - tau c, 0 in exact arithmetic: the port keeps
# that 0 and its start vector comes back as the top Ritz vector, while
# XLA's fused evaluation leaves ~1e-21 of noise whose top Ritz vector no
# other implementation reproduces; the reference therefore sets the JAX
# warm vector after iteration 1 to the normalised start vector, the exact
# answer.  LZF_REF_ACCEPT: per iteration, 1 where the Lanczos residual test
# accepted (no polar fallback); LZF_REF_FETCH: the last iterate's fetch
# scalars [iter, status, gap, feas, prim_obj, dual_obj, pres, dres, comb,
# target_rank, proj_fallbacks, sub_stats x 3]; LZF_REF_NEAR: {iteration:
# the largest ratio of a leading pair's residual to its threshold} where
# that ratio is within 1e-2 of 1 (a decision rounding can turn; here none
# is: the nearest lies 0.094 away).  All 8 threads of one CPU host, 630 s
# with the replay; tests/test_torch_reference_values.py keeps all of them
# true.
LZF_ITERS = 300
LZF_SOLVE_ITERS = 100  # phase F's solve() through the iteration limit
LZF_REF_ACCEPT = (
    "100000000000000000000000000000000000000000000000000000000000"
    "000000000000000000000000000000000000000000000000001111111111"
    "111111111111111111111111111111111111111111111111111111111111"
    "111111111111111111111111111111111111111111111111111111111111"
    "111111111111111111111111100000000000000000000000000000000000"
)
LZF_REF_FETCH = [
    300.0, 0.0, 0.9354293230804994, 0.008881663169918843,
    -21598.040446688632, -647390.0882754801, 10.871741884721631,
    0.34746708972127693, 10.871741884721631, 3.0, 144.0, 0.0, 0.0, 0.0,
]
LZF_REF_NEAR = {}
# phase G: solve_batch of maxcut_problem(random_graph_weights(s, side))
# for s in range(B) at Options(tol_gap=1e-4, tol_feasibility=1e-4),
# projection "auto" (the subspace mode: B > 32).  G1: B = 256 at side 40
# (the README's side-40 record, bench.py's BENCH_MODE=batch sweep); G2:
# B = 64 at side 100 (SDPLIB mcp100's side; the file is not in the
# repository).  References, the JAX package on the CPU on XLA's default
# threads (8 cores), lined up with the port where the JAX driver has two
# faults the port does not copy: after iteration 1 its subspace program
# takes the port's basis (ROADMAP C11), and its fetch reads the latest
# ring slot (C12) (tests/test_torch_reference_values.py keeps them true,
# marked slow): *_REF_OBJ its batch solve under these Options() (all
# status 1), with its reseeds (dtype, smallest and largest iteration, k,
# instances masked, r_max), programs (dtype, k; k = 0 the eigh program)
# and iterations min/median/max; *_EXACT_OBJ its f64 dense-eigh solve at
# 1e-8 tolerances, the optima.  Each objective is held within G_OBJ_RTOL
# (1 + |obj|) of the JAX solve's and all of them within G_OBJ_MEAN_RTOL
# on average.  At 1e-4 tolerances two f32 races stop at other points of
# a tolerance box ~1e-3 wide in the objective: the reference's own runs
# on 1 and 8 threads lie up to 9.42e-4 apart on G1 (mean 3.3e-5), the
# port's CPU runs up to 1.041e-3 (mean 1.00e-4) from it on G1 and
# 5.87e-4 (mean 1.26e-4) on G2 (PERF.md); G2's one-thread JAX run
# keeps the subspace program at its fourth reseed (r_max 13, not ~60)
# and stalls in it (C13), ending up to 1.2e-2 from the optima.
G_OBJ_RTOL = 1.5e-3
G_OBJ_MEAN_RTOL = 2e-4
G1_SIZE = 256
G1_SIDE = 40
G1_REF_OBJ = [
    72.74872240474538, 69.93596189483954, 77.64018931090553,
    66.08616418938539, 66.39491205542724, 67.56579233606661,
    65.70519521415314, 66.63124047825936, 63.91812948125928,
    68.84135778971401, 67.78057789978065, 71.92921909458687,
    64.73976045554434, 75.4467706087064, 66.51929021587468,
    78.00177947595687, 74.59124515222352, 65.70695519088311,
    64.19280908245939, 72.93510443720521, 66.20152347520819,
    72.04764983119826, 67.7591310813638, 66.61954320731803,
    60.97468936813357, 65.00295141006008, 71.682001535829,
    64.19856468531803, 69.67345465598119, 66.67748949981087,
    63.39144021719536, 71.5706625273906, 75.39146411591634,
    71.7463031735578, 77.59173167103131, 67.1325563471624,
    70.6549278927242, 67.11827852202858, 68.9374664222038,
    71.05839618277972, 68.71871512330837, 70.71976403556323,
    64.79232095403758, 69.39556119712257, 60.3491359841137,
    75.0944156569247, 69.11199083415171, 64.7172149288147,
    67.27632497715999, 63.41049909697441, 72.35932312265217,
    68.00927003090673, 69.25771238587188, 63.539369312250464,
    69.35113736606873, 72.59644693459961, 64.86908696130949,
    76.47749801340404, 66.26139802103441, 65.81623194675193,
    73.4261952756439, 73.1768222074706, 69.21756317974707,
    75.02200145478857, 77.7093533004607, 74.76501336105093,
    74.59604397921771, 70.74086002132613, 69.4711597812387,
    64.38546743079264, 70.70374893378596, 67.121340705772,
    64.40647135923628, 72.98844744783676, 65.9692231947764,
    62.87893571434959, 68.89585167154387, 75.09475158785864,
    66.42619042745972, 67.40150298336991, 66.42100338410795,
    67.76489247376807, 66.2216452257978, 72.18764653232661,
    68.16331664989043, 68.6112103774502, 71.57640939329457,
    74.14166921375347, 63.99016035879572, 66.21156949414807,
    68.39437453205521, 70.30614503412251, 69.34752580261923,
    70.35985838390974, 71.49516311792404, 67.77165878282469,
    67.70118954722408, 70.81662081020855, 64.77573453198829,
    69.36179028141368, 71.07433413424977, 68.2832077189868,
    65.02865708643047, 70.75936586825374, 67.76172105732188,
    67.0809231737764, 71.21754998473655, 69.9961803372781,
    67.70881461343501, 66.3510046003162, 73.43794931479228,
    65.4794927982953, 73.7804005959161, 73.9842250558341,
    68.72121403214689, 60.2201007642192, 73.16756041349689,
    67.97740855799148, 67.98661828386562, 66.88662046964242,
    61.858800936299126, 64.01935638162513, 69.6605393538145,
    63.526790065381995, 64.91483837320831, 71.17918163723644,
    68.53589459511079, 63.63198314345636, 73.33979095952903,
    72.22498710406961, 73.56594077993563, 70.99030996589612,
    65.26655830880378, 71.03674696208049, 70.72228147900269,
    65.96234906478917, 70.81933541432373, 69.0909714539493,
    65.75520092513439, 65.76443071033978, 73.51881795097496,
    63.79280404067403, 65.11090404076506, 63.6200968476885,
    72.4535946020539, 73.48065849604869, 71.3507910364331,
    74.03779876980454, 72.36511279861274, 70.30151672815016,
    75.25755294778548, 68.90229485751154, 80.17126440707871,
    70.03182539834764, 73.19702848835284, 70.04352424135578,
    66.41202840133445, 66.56377169463379, 63.509577477265076,
    75.54934261398135, 65.96186184880904, 68.17777445187134,
    64.65308610545777, 75.28213351109717, 63.06704943833267,
    67.24491504693765, 68.56148765771445, 75.00376163858375,
    67.94867560634574, 72.55878684583364, 65.19180556731725,
    70.1253929656817, 68.4732408841402, 68.45001229061938,
    71.7871967303259, 71.99386345099886, 65.01574080433006,
    63.77761256058898, 64.75387465361935, 68.5084531744468,
    68.58365399006027, 74.06507202387891, 74.77396631744355,
    69.3070075159271, 62.52452884916734, 70.32984063757755,
    63.59979692782471, 66.52140874180205, 66.34190811946686,
    73.98489142030886, 71.05638139408603, 60.5178489592069,
    65.94534835064674, 68.59333189303423, 70.39303236396721,
    63.296214741192664, 65.82283030011737, 65.14494440296069,
    73.45811605589078, 76.7251794700881, 76.62988147538714,
    67.87378167365598, 78.90390797521293, 67.16182223869967,
    63.137857485133, 63.76073449522166, 69.07395260578674,
    73.00965945675213, 64.31711715568237, 68.13604868429594,
    73.72824103294687, 71.18016033034503, 66.3793364914219,
    71.13040024843636, 78.50853851316896, 67.96015863740547,
    66.58359035949114, 73.72236540146353, 68.65881001826638,
    73.88120650803651, 60.33836064948664, 62.02975233505588,
    65.91893659332897, 69.83583821676648, 68.23423064223793,
    68.27877106676777, 68.37501175039341, 69.16794320289165,
    70.33079426173829, 72.19530010820513, 64.22633934045632,
    75.6706144991777, 71.28939013648969, 68.72695064972376,
    70.59162431853558, 56.3772850767374, 63.994833130784826,
    74.22709606428322, 68.48132689555858, 65.99881747531572,
    68.87163044191335, 68.96650604243602, 75.69739598666914,
    62.47092655152147, 76.2716265261677, 67.68108445829988,
    64.00999735442913, 68.68005748382866, 60.20906927094509,
    63.516354429921726, 67.43563347932196, 67.04412026611342,
    60.3851693266536, 65.13238502578929, 79.06065813016912,
    65.17589795546994,
]
G1_EXACT_OBJ = [
    72.75993668321631, 69.93352782197394, 77.6510712029041,
    66.07318591978701, 66.38930017567503, 67.56390199093006,
    65.71119101615227, 66.67072362039288, 63.91323359382776,
    68.81760238774041, 67.78573760195225, 71.9552042955663,
    64.74318543156679, 75.4169194086084, 66.54699228029554,
    77.99415435202204, 74.58573668017637, 65.71023538205978,
    64.17314395567776, 72.92429754845578, 66.20661076788328,
    72.0496216212531, 67.76702519350528, 66.60222137278586,
    60.97500515532539, 65.02738797261883, 71.6779147263037,
    64.20180903928947, 69.66898556594316, 66.67294806618683,
    63.41670926116267, 71.56755109277046, 75.37628357997843,
    71.7784374577301, 77.59862882995294, 67.13134479642177,
    70.66372643116709, 67.13678459054682, 68.93339887146155,
    71.0648124634062, 68.71028448246953, 70.71215250265475,
    64.78254614139246, 69.37200762068038, 60.359194181489904,
    75.09311170425113, 69.10932243405584, 64.71087891939354,
    67.2792241830586, 63.3965756002591, 72.35086252093599,
    67.99802587727152, 69.25236567509914, 63.53729711110302,
    69.35456677941994, 72.6007654041342, 64.8882644144217,
    76.482726289094, 66.2658563776087, 65.85194532718053,
    73.41651823001588, 73.19817804339995, 69.21788751615958,
    75.06696240747884, 77.6956036354249, 74.76836107987864,
    74.5774803230605, 70.72919578349986, 69.46694334266427,
    64.38548449264003, 70.71167165215914, 67.13345890552849,
    64.41562380789074, 72.96285085084754, 65.99922450361629,
    62.873758754063005, 68.89903071424833, 75.0955627245039,
    66.42162144344597, 67.38649608856115, 66.42943966168373,
    67.7618213267456, 66.21920655346206, 72.2021956590147,
    68.15427580008574, 68.61045390011886, 71.56772334916124,
    74.1093042013288, 63.988191925708385, 66.21744691352036,
    68.39789368920252, 70.32537997750566, 69.35310199180326,
    70.35907900308938, 71.48814309158637, 67.75404238854878,
    67.69308522666981, 70.815006837079, 64.79148174927231,
    69.36101537827194, 71.11173177609744, 68.28721506588634,
    65.0332119361043, 70.744140530629, 67.78522462201467,
    67.05953654965691, 71.24214399496344, 69.97621242407476,
    67.70961630454367, 66.3486375347114, 73.43151208534148,
    65.4841296783554, 73.78805093092924, 73.9672918185404,
    68.73136934509952, 60.24605363875092, 73.15018308045292,
    67.96939828849996, 67.9655321346028, 66.87571974324844,
    61.853033531186526, 64.00357226161195, 69.66499303023471,
    63.557068952840304, 64.9013537220262, 71.17006534535915,
    68.53921259781742, 63.63495691436013, 73.35808011569941,
    72.21975431985399, 73.5397693958875, 70.99352769352596,
    65.2302503399399, 71.03314608040799, 70.73267668737698,
    65.96661123175336, 70.82095812047936, 69.09888399600705,
    65.75361403333528, 65.7459806506777, 73.51044503041749,
    63.79180520726831, 65.12826551183593, 63.622634069309754,
    72.4324956903426, 73.48290914770115, 71.35512231860287,
    74.03789460242275, 72.35759833591193, 70.30424791700685,
    75.25261721006613, 68.91181311168846, 80.15636842505116,
    70.0340502198275, 73.16843224974262, 70.04470387441815,
    66.39647642712626, 66.55853079055146, 63.52061077158525,
    75.55196675149142, 65.9583789425684, 68.18977073091455,
    64.6582750950282, 75.2694460184864, 63.08385508988495,
    67.24169012185125, 68.55554193182414, 75.01007592474862,
    67.93712123524303, 72.55981237553458, 65.2266004357345,
    70.11958320126956, 68.49007476076834, 68.4821622380211,
    71.77627397030972, 71.99224074111302, 65.03068641379413,
    63.78290793846096, 64.7663596293991, 68.51108172881484,
    68.57049750053861, 74.0618376140766, 74.74401250126282,
    69.2924033758999, 62.50816919031755, 70.31649347296097,
    63.60310607175936, 66.51442389519003, 66.33657197373954,
    74.0006654185716, 71.05034695392503, 60.513404029141924,
    65.93460737429501, 68.56371735177376, 70.41782999691608,
    63.297889226748396, 65.82567965507188, 65.14018540685872,
    73.45276787286294, 76.69933693475069, 76.6143218061883,
    67.87288743209959, 78.90621958212958, 67.17210851675001,
    63.14073901753589, 63.76174643685952, 69.07395324740828,
    72.99931768719948, 64.31491524505797, 68.13463277089811,
    73.71774408822883, 71.20084607682494, 66.38005222293522,
    71.1353176917292, 78.49609330616342, 67.9599846543843,
    66.60970344923525, 73.70952088891565, 68.65457608391407,
    73.86245084342724, 60.34065763481572, 62.03714282658721,
    65.95441678545689, 69.82640564439846, 68.22997744894947,
    68.30636506165474, 68.33753447753402, 69.18418821089446,
    70.33776027370033, 72.19327937969285, 64.25145596549919,
    75.67242418129972, 71.28097527071395, 68.73518111124291,
    70.58532836111102, 56.36050409426337, 64.0081081077017,
    74.23039058241149, 68.4851493542437, 66.02452614932622,
    68.85458430447609, 68.98371503731957, 75.73918905163119,
    62.465945916763324, 76.26450757152884, 67.68547860132053,
    64.01503505356436, 68.68987220340571, 60.21406142727829,
    63.5297632803899, 67.42717094700045, 67.07667722405112,
    60.39720779572818, 65.12467537371478, 79.07020619461078,
    65.17888872873483,
]
G1_REF_ITERS = "198/422/3583"
G1_REF_RESEEDS = [
    ('float32', 128, 128, 16, 256, 6),
    ('float32', 136, 1152, 16, 247, 6),
    ('float32', 136, 2176, 16, 14, 8),
    ('float32', 136, 3200, 16, 14, 16),
]
G1_REF_PROGRAMS = [('float32', 16), ('float32', 0), ('float64', 0)]
G1_REF = {"obj": G1_REF_OBJ, "exact": G1_EXACT_OBJ,
          "iters": G1_REF_ITERS, "reseeds": G1_REF_RESEEDS,
          "programs": G1_REF_PROGRAMS}
G2_SIZE = 64
G2_SIDE = 100
G2_REF_OBJ = [
    291.39853631836695, 280.39675896133343, 299.63273078584285,
    291.7967307410104, 291.12392347430455, 300.4139789247294,
    295.2849669803723, 291.0864398296205, 295.05113705125444,
    278.82388415185795, 307.1544309348451, 282.5937967042558,
    303.4415448532996, 301.2700887006318, 298.1910193910883,
    304.53923058809926, 300.1594637427928, 296.7310701157245,
    290.57475542276285, 290.18559902053454, 304.8449058128616,
    302.202397055899, 302.31766823803105, 301.95314545321594,
    303.9523264509828, 287.5429953406049, 309.89078634575026,
    295.4268649866263, 307.13330372546085, 301.362495198712,
    288.9152495097032, 297.25575355194553, 299.314135351707,
    292.04409751371867, 300.44400673191643, 310.4158020113607,
    305.3755256430509, 297.9761253931152, 305.74692029052017,
    293.8295031055016, 288.3319902972947, 295.79166315073314,
    283.91605932815634, 296.560491199584, 300.50858006906367,
    287.58281771793213, 289.3225777951088, 301.30080746010697,
    288.48274804400336, 289.88625035978043, 298.94947188243987,
    294.7181477325273, 295.01136844112364, 296.10094114822664,
    301.0142997660614, 300.62491068455313, 284.1846309895861,
    297.4802949389706, 287.6456052460397, 300.8761452222363,
    295.372273238427, 307.0361824626332, 302.2853016651146,
    290.6748416581151,
]
G2_EXACT_OBJ = [
    291.3971761875672, 280.4287622889434, 299.64594562471916,
    291.755778148709, 291.16175968065886, 300.3460366124735,
    295.23701022576375, 291.02769065123505, 295.02780637651915,
    278.77565911071105, 307.17836303898366, 282.512131916337,
    303.47667956954024, 301.26381043939824, 298.2646309549708,
    304.4672145685419, 300.11625420097033, 296.6797744731653,
    290.6081204525489, 290.2224141684109, 304.89626722960446,
    302.3311582387843, 302.26721527979714, 302.02226482711615,
    303.8839030901032, 287.4658950814607, 309.87963594326516,
    295.43948358845586, 307.1594519213415, 301.39464432585254,
    288.90246814996533, 297.2303203956531, 299.3579703493429,
    292.1021286650829, 300.38185431537374, 310.38673013286007,
    305.3936908495514, 298.023339196623, 305.7808521219534,
    293.77239443854444, 288.3043397832631, 295.86208888012567,
    283.9539192074758, 296.5812941568885, 300.4814708963938,
    287.5873717102706, 289.2746054005025, 301.10532943643005,
    288.457463176479, 289.94244518574885, 299.0168307600141,
    294.66760977585614, 295.0770635205274, 296.1555172012357,
    300.93411442550513, 300.5850412041009, 284.3164557044,
    297.45495457323415, 287.7345722511113, 300.7750122234433,
    295.41544057182324, 307.0973494217215, 302.35526439766335,
    290.6748149231377,
]
G2_REF_ITERS = "452/1036/2435"
G2_REF_RESEEDS = [
    ('float32', 128, 128, 16, 64, 10),
    ('float32', 128, 128, 24, 64, 10),
    ('float32', 435, 1152, 24, 64, 9),
    ('float32', 435, 2176, 24, 25, 59),
]
G2_REF_PROGRAMS = [('float32', 16), ('float32', 24), ('float32', 0), ('float64', 0)]
G2_REF = {"obj": G2_REF_OBJ, "exact": G2_EXACT_OBJ,
          "iters": G2_REF_ITERS, "reseeds": G2_REF_RESEEDS,
          "programs": G2_REF_PROGRAMS}
# phase H: the Lovasz-theta SDP (min -<J, X>, tr X = 1, X_ij = 0 on the
# edges, X psd) of a random graph on 300 vertices with exactly 4374 edges,
# drawn by numpy.random.default_rng(0): SDPLIB theta6's n = 300 and
# m = 4375; square form n = 90,000, the trace row against the edge rows
# a row-norm spread of 24.5, so the default solve runs the probe
THETA_N = 300
THETA_EDGES = 4374
# phase I: a seeded conic program with every block kind (conic_program_data)
I_PSD_SIDES = (19,) * 32 + (200,)
I_SOC_LENS = (16,) * 128
I_LP = 400
I_ROWS = 600
I_DENSITY = 0.05
I_SEED = 0
I_ITERS = 300
# phase H, the JAX package on one CPU thread (tests/test_torch_reference_
# values.py keeps these true).  H1: its default Options(chunk_iters=256)
# solve: the probe's rounds (depth, the default arm's score, the
# equilibrated arm's) and winner, then the winner's solve.  Both arms
# stopped at the 20 s clock, so where they stop, the winner and the answer
# move with the host's speed.  The default arm's answer barely moves
# (its arm stopped at 1000-4000 iterations, then the warm solve: -63.62448
# to -63.62490); the equilibrated arm's does: its warm solve from an arm
# stopped past the f32 race's end declares within ~45 iterations, at
# -63.62649 (2500), -63.60832 (2900, 3000), while the arm unstopped at
# the probe's depth 6000 solves at 2520, at -63.64085, as one solve does
# (at max_iter 4000, at 3078 at -63.63280): H_EQ_REF_RANGE holds the
# extremes.  H_OPT_OBJ: the optimum (a solve at tol_gap =
# tol_feasibility = 1e-7; on 8 threads it gave -63.610350, gap 6.2e-8),
# printed beside each answer.
H_REF_OBJ = -63.62505361662326
H_REF_ITERS = 5047
H_REF_PROBE = [(6000, 4.031e-04, 5.380e-04)]
H_REF_WINNER = "default"
H_EQ_REF_RANGE = (-63.64084599702091, -63.60832434764272)
H_OPT_OBJ = -63.610366670728084
# H_UNCUT_REF_RANGE: the default arm solved inside its round (no warm
# solve; the port's arm does on the card since B8): the JAX package's
# answers to that arm uncut (tools/theta_uncut_arm.py --jax), each from
# one f32 race end -- its own race's, or the hand-over of a port run
# (--dump-race) put in place of its own (--race): the race hands over
# where its f32 rounding sends it, and the f64 polish, whose subspace step
# keeps an f32 basis, stops where that hand-over and its own rounding send
# it.  From one hand-over (the card's) the card, the port on the CPU and
# the JAX package part pairwise at one rate (their objectives 1e-8
# relative apart at the first iteration, 1e-4 by the 73rd-77th) and stop
# at -63.67665, -63.63542 and -63.63628 (PERF.md, PR 14; --series,
# --compare).  tests/test_torch_theta_probe.py
# re-derives the port's CPU race's answer; the JAX races' hand-overs move
# with its clock (its chunks follow measured rates).
H_UNCUT_REF_ANSWERS = {
    "the JAX race, one thread": -63.61380147784672,
    "the JAX race, eight threads": -63.624536732692235,
    "the port's CPU race": -63.667417029129396,
    "the port's card race": -63.63627938359218,
}
H_UNCUT_REF_RANGE = (min(H_UNCUT_REF_ANSWERS.values()),
                     max(H_UNCUT_REF_ANSWERS.values()))
# H3: Options(chunk_iters=256, block_equilibration_probe_iters=
# H3_PROBE_ITERS) on a frozen clock (tests/test_torch_theta_probe.py keeps
# these true): both arms cut at their depth, below both arms' solve points,
# so the probe compares cut arms on every host, as H1's 20 s clock did
# before the port's arms solved inside it.  The JAX run's equilibrated arm
# wins; on the card the default arm scores better at the cut (its f32 race
# rounds otherwise), so H3_REF_DEFAULT_OBJ is the JAX default arm cut at
# H3_PROBE_ITERS, then warm-solved, as the probe does when it wins.  Cut,
# either arm's answer barely moves: the default arm cut at 1000-4000
# iterations then warm-solved gave -63.62448 to -63.62505.
H3_PROBE_ITERS = 2000
H3_REF_OBJ = -63.624413730718324
H3_REF_ITERS = 1463
H3_REF_PROBE = [(2000, 2.298e-03, 7.466e-04)]
H3_REF_WINNER = "block-equilibrated"
H3_REF_DEFAULT_OBJ = -63.62461537754403
# H2: block_equilibration_probe_iters=H2_PROBE_ITERS, the arms stopped at
# their depth (~14 s each in the JAX run, well under the card's): one
# round, the equilibrated arm, and its warm solve
H2_PROBE_ITERS = 500
H2_REF_OBJ = -63.62501254259607
H2_REF_ITERS = 2823
H2_REF_PROBE = [(500, 1.160e-01, 8.216e-03)]
H2_REF_WINNER = "block-equilibrated"
# phase I: the JAX package's default Options(chunk_iters=256) solve, and
# I_ITERS iterations of its f64 program (Options(hybrid_precision=False,
# block_equilibration=False)) from init_state: the 14 fetched scalars,
# each PSD block's ||X||_F and lambda_min, ||x|| over the SOC and the LP
# coordinates
I_REF_STATUS = 1
I_REF_OBJ = 211.10795932925933
I_REF_ITERS = 367
I_REF_FETCH = [300.0, 0.0, 0.0003680778787180689, 5.314232778956193e-05, 211.15104268837894, 211.30690819266553, 0.03404290418265106, 0.001106578125495842, 0.03404290418265106, 66.0, 300.0, 0.0, 0.0, 0.0]
I_REF_NORMS = [0.0452919708238009, 0.15673420796138232, 0.201239276495823, 0.05605162442153663, 0.2392007962742606, 0.04297869740774104, 0.22813631530310594, 0.04901637449619447, 0.03390195652724769, 0.08249282687751794, 0.10006640694797077, 0.18050323904085605, 0.13379479673358688, 0.07714905310430434, 0.16738003164202647, 0.17492882923384281, 0.22259062287790976, 0.1067878022155411, 0.08412574211213165, 0.12968973157650582, 0.10146164207046113, 0.06371949211606777, 0.10215270212556345, 0.33195968428017153, 0.06420926681027185, 0.15592657931124504, 0.13156683703147262, 0.210460612764359, 0.030285002593155887, 0.24877401444489733, 0.010724732008380687, 0.11949511314390052, 0.9524483458464743]
I_REF_LMINS = [-2.2188774041079063e-19, -1.0041903978417853e-17, -1.689954861257729e-17, -2.1628777206632205e-18, -5.934035237453267e-19, -1.167429633324117e-17, -3.6545378161915804e-17, -2.0079018782958847e-18, -3.359981565370283e-18, -1.0317400855718895e-18, -2.060399528335929e-18, -5.808585718248484e-18, -1.0689520108382303e-18, -4.170516244088755e-18, -2.612773425766672e-17, -1.8733959020672962e-17, -6.611065962365022e-18, -1.8579980602280578e-18, -1.0144653452833767e-18, -1.8220685556766464e-18, -4.201786011986191e-18, -5.8077643799098436e-18, -1.3210747285059785e-17, -5.164621521021949e-17, -1.3778931988610813e-17, -5.1614748556666374e-17, -2.5725093796889365e-17, -6.904218266059426e-19, -2.499548272108292e-20, -3.2148024901463594e-17, -3.147334385042732e-19, -1.2447889823578778e-18, -2.2217209360633713e-16]
I_REF_SOC_NORM = 1.1878091508941349
I_REF_LP_NORM = 0.2538993817603355
# kernel vs plain version on the card.  f64: elementwise outputs round
# alike (-fmad=false, the plain version's operation order); reductions
# differ in summation order only, ~1e-14 in practice.  f32: the GEMM sums
# in another order than the plain version's (2e-5 of the output's scale);
# K3's f32 program and K8's Ritz sums in the mixed polish are f64 slots.
RTOL = {"f64": 1e-12, "f32": 2e-5}
# K5's ragged and unaligned dimensions (edge_kernel_checks)
EDGE_DIMS = (1, 31, 33, 127, 250)
REPS = 20  # timed calls a row, within the script's time limit
SLOW_MS = 20.0
# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and the fastest
# IEEE rate per type (f32 on the CUDA cores, f64 on the FP64 tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 67e12}


def theta_graph(seed: int = 0, n: int = THETA_N, m: int = THETA_EDGES):
    """(i, j), i < j: m distinct edges of the complete graph on n vertices
    drawn by numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, 1)
    pick = np.sort(rng.choice(iu.size, size=m, replace=False))
    return iu[pick], ju[pick]


def build_theta(pkg, edges, n: int = THETA_N):
    """The Lovasz-theta SDP of the graph through ``pkg.Optimizer`` (the
    port or the JAX package): min -<J, X> s.t. tr X = 1, X_ij = 0 on the
    edges, X psd.  Returns (problem, the index matrix of X)."""
    opt = pkg.Optimizer()
    X = opt.add_psd_var(n)
    opt.add_eq_constraint({int(X[i, i]): 1.0 for i in range(n)}, 1.0)
    for i, j in zip(*edges):
        opt.add_eq_constraint({int(X[i, j]): 1.0}, 0.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, -np.ones((n, n))))
    return opt.build_problem(), X


def conic_indices(sides, soc_lens, n_lp: int):
    """Where ``conic_program_data``'s variables lie: (each PSD block's
    diagonal variables, each SOC block's head, the LP coordinates, the
    number of variables)."""
    diags, pos = [], 0
    for side in sides:
        j = np.repeat(np.arange(side), np.arange(1, side + 1))
        i = np.concatenate([np.arange(k + 1) for k in range(side)])
        diags.append(pos + np.nonzero(i == j)[0])
        pos += side * (side + 1) // 2
    soc_off = pos + np.concatenate([[0], np.cumsum(soc_lens)[:-1]])
    pos += sum(soc_lens)
    return diags, soc_off.astype(int), np.arange(pos, pos + n_lp), pos + n_lp


def conic_program_data(seed: int = I_SEED, sides=I_PSD_SIDES,
                       soc_lens=I_SOC_LENS, n_lp: int = I_LP,
                       rows: int = I_ROWS, density: float = I_DENSITY) -> dict:
    """A feasible, bounded conic program with PSD blocks of ``sides``, SOC
    blocks of ``soc_lens`` and ``n_lp`` nonnegative LP coordinates, as
    plain arrays from numpy.random.default_rng(seed).

    Variables are numbered as the Optimizer numbers them: each PSD block's
    upper triangle X_ij, i <= j, column by column, then the SOC blocks,
    then the LP coordinates (free variables with the rows -x <= 0).  Of
    the ``rows`` equality rows, one per PSD block sums its diagonal, one
    per SOC block holds its head s, one sums the LP coordinates (so that
    every block is nonzero at the optimum), and the others each take a
    random ``density`` share of the variables; every row's normal
    coefficients are scaled to a unit row.  b = A x0 with x0 interior to
    the cone (X = I, SOC (1, 0), LP 1), and c = s0 - A^T y0 - G^T z0 for a
    random y0, z0 > 0 and s0 interior to the dual cone (S = I, SOC (1.5, v)
    with |v| = 0.5, 0 on the LP coordinates), so the dual is strictly
    feasible and the optimum finite."""
    rng = np.random.default_rng(seed)
    diags, soc_off, lp, N = conic_indices(sides, soc_lens, n_lp)
    anchors = diags + [np.array([off]) for off in soc_off] + [lp]
    x0 = np.zeros(N)
    s0 = np.zeros(N)
    for d in diags:
        x0[d] = 1.0
        s0[d] = 1.0
    for off, ln in zip(soc_off, soc_lens):
        x0[off] = 1.0
        v = rng.standard_normal(ln - 1)
        s0[off] = 1.5
        s0[off + 1 : off + ln] = 0.5 * v / np.linalg.norm(v)
    x0[lp] = 1.0
    k = int(round(density * N))
    cols = anchors + [np.sort(rng.choice(N, size=k, replace=False))
                      for _ in range(rows - len(anchors))]
    vals = [rng.standard_normal(len(cl)) for cl in cols]
    vals = [v / np.linalg.norm(v) for v in vals]
    b = np.array([np.dot(v, x0[cl]) for cl, v in zip(cols, vals)])
    y0 = rng.standard_normal(rows)
    z0 = 1.0 + rng.random(n_lp)
    aty = np.zeros(N)
    for cl, v, y in zip(cols, vals, y0):
        aty[cl] += v * y
    c = s0 - aty
    c[lp] += z0  # G = -I on the LP coordinates: -G^T z0 = z0
    return {"sides": tuple(sides), "soc_lens": tuple(soc_lens), "n_lp": n_lp,
            "cols": cols, "vals": vals, "b": b, "c": c}


def conic_sweep_instance(data: dict, s: int) -> dict:
    """Instance s of a sweep over ``conic_program_data``'s program: its
    rows (cols, vals) kept, b and c drawn anew by phase I's construction
    from numpy.random.default_rng(s) -- b = A x0 for an x0 interior to the
    cone (each PSD block's diagonal 1 + U(0, 1), each SOC block (2 + U(0,
    1), w) with |w| < 1, the LP coordinates 1 + U(0, 1)), c = s0 - A^T y0
    - G^T z0 for a random y0, z0 > 0 and s0 interior to the dual cone
    (each diagonal 1 + U(0, 1), each SOC block (1.5, v) with |v| = 0.5, 0
    on the LP coordinates) -- so every instance is feasible and bounded.
    Returns ``data`` with the instance's b and c."""
    rng = np.random.default_rng(s)
    sides, soc_lens, n_lp = data["sides"], data["soc_lens"], data["n_lp"]
    cols, vals = data["cols"], data["vals"]
    diags, soc_off, lp, N = conic_indices(sides, soc_lens, n_lp)
    x0, s0 = np.zeros(N), np.zeros(N)
    for d in diags:
        x0[d] = 1.0 + rng.random(d.size)
        s0[d] = 1.0 + rng.random(d.size)
    for off, ln in zip(soc_off, soc_lens):
        w, v = rng.standard_normal(ln - 1), rng.standard_normal(ln - 1)
        x0[off] = 2.0 + rng.random()
        x0[off + 1 : off + ln] = rng.random() * w / np.linalg.norm(w)
        s0[off] = 1.5
        s0[off + 1 : off + ln] = 0.5 * v / np.linalg.norm(v)
    x0[lp] = 1.0 + rng.random(n_lp)
    y0 = rng.standard_normal(len(cols))
    z0 = 1.0 + rng.random(n_lp)
    aty = np.zeros(N)
    for cl, v, y in zip(cols, vals, y0):
        aty[cl] += v * y
    c = s0 - aty
    c[lp] += z0
    b = np.array([np.dot(v, x0[cl]) for cl, v in zip(cols, vals)])
    return {**data, "b": b, "c": c}


def build_conic_program(pkg, data: dict):
    """``conic_program_data``'s program through ``pkg.Optimizer``;
    (problem, PSD index matrices, SOC indices, LP indices)."""
    opt = pkg.Optimizer()
    Xs = [opt.add_psd_var(side) for side in data["sides"]]
    socs = [opt.add_soc_var(ln) for ln in data["soc_lens"]]
    lp = opt.add_free_vars(data["n_lp"])
    for cols, vals, rhs in zip(data["cols"], data["vals"], data["b"]):
        opt.add_eq_constraint(dict(zip(cols.tolist(), vals.tolist())), rhs)
    for v in lp:
        opt.add_ineq_constraint({int(v): -1.0}, 0.0)
    opt.set_objective({v: float(cv) for v, cv in enumerate(data["c"])
                       if cv != 0.0})
    return opt.build_problem(), Xs, socs, lp


# phase J: the certificate search at mcp124's side (SDPLIB's files are not
# in the repo: random graphs of their shapes)
J_SIDE = 124
# phase J3's infeasible instance (X_00 = -1): one, since each re-entry
# into solve takes ~25-35 s of the run's time
J_BAD = (3,)
# phase J3's batch: the first J3_SIZE of phase D's instances (1024 until
# the whole script passed ~1000 s on a slow host)
J3_SIZE = 256


def j1_problem(maxcut_problem, random_graph_weights):
    """Max-cut at side 124 with the equality X_00 = -1 appended (the JAX
    suite's realistic certificate test, tests/test_models.py:144-190):
    infeasible, as X psd forces X_00 >= 0."""
    import scipy.sparse as sp

    problem, _ = maxcut_problem(random_graph_weights(0, J_SIDE))
    row = np.zeros((1, problem.n))
    row[0, problem.sdp_vars[0][0]] = 1.0
    return type(problem)(
        c=problem.c, A=sp.vstack([sp.csr_matrix(problem.A),
                                  sp.csr_matrix(row)]).tocsr(),
        b=np.concatenate([problem.b, [-1.0]]), G=problem.G, h=problem.h,
        sdp_vars=problem.sdp_vars, objective_sense=problem.objective_sense)


def j2_problem(maxcut_problem, random_graph_weights):
    """The same graph without the equality X_00 = 1 and with X_00 added to
    the maximised objective: X = t e_0 e_0^T is a primal ray (the objective
    grows by t, every constraint holds).  Dropping the equality alone
    leaves the supremum infinite but no ray (W's diagonal is 0: the
    objective grows with sqrt(X_00) through the row's off-diagonals)."""
    problem, _ = maxcut_problem(random_graph_weights(0, J_SIDE))
    c = problem.c.copy()  # stored for minimisation: -1 maximises X_00
    c[problem.sdp_vars[0][0]] -= 1.0
    return type(problem)(
        c=c, A=problem.A[1:], b=problem.b[1:], G=problem.G, h=problem.h,
        sdp_vars=problem.sdp_vars, objective_sense=problem.objective_sense)


# J1's options: the JAX test's (hybrid_precision=False) at max_iter 2000,
# not its 20,000 -- a side-124 f64 iteration takes 7.7 ms on the card
# (launch-bound, ROADMAP B8), so its 25,632 iterations took 222 s; at 2000
# the declaration still comes at the iteration limit (the limit-time
# path), and the whole run stays inside its time
J1_OPTS = dict(hybrid_precision=False, max_iter=2000, chunk_iters=256)
# J2's options: the JAX conformance suite's infeas_opt knobs
# (tests/test_conformance.py:33-47); at the defaults the 100 %-gap stall
# that declares an unbounded SDP needs ~1e5-1e6 iterations
J2_OPTS = dict(chunk_iters=256, infeas_gap_tol=0.3, infeas_stable_gap_tol=1e-2)


def j3_problems(problems):
    """Phase D's instances with X_00 = -1 in the instances J_BAD (one
    geometry and one constraint matrix still)."""
    out = []
    for i, problem in enumerate(problems):
        if i in J_BAD:
            b = problem.b.copy()
            b[0] = -1.0
            problem = type(problem)(
                c=problem.c, A=problem.A, b=b, G=problem.G, h=problem.h,
                sdp_vars=problem.sdp_vars,
                objective_sense=problem.objective_sense)
        out.append(problem)
    return out


def farkas(res, problem) -> float:
    """The ray's value per unit: b'y / ||y|| over the duals (y_eq, y_in)
    of an infeasibility certificate, c'x / ||x|| over the primal of an
    unboundedness one (user units, the objective's sense)."""
    if res.status == 6:
        y = np.concatenate([res.dual_eq, res.dual_in])
        bh = np.concatenate([problem.b, problem.h])
        return float(np.dot(bh, y) / max(np.linalg.norm(y), 1e-300))
    x = res.primal
    return float(np.dot(problem.c, x) / max(np.linalg.norm(x), 1e-300))


# phase K: per-instance operators in solve_batch and the API on the card.
# K1 a randsdp sweep (dense A_k: "dense_batched"), K3 a max-cut sweep whose
# diagonal rows carry per-instance weights (one pattern: "ell_batched"),
# projection "eigh", K3 at Options(tol_gap=1e-4, tol_feasibility=1e-4),
# K1 at K1_TOL.  K1 sweeps instances 0-7, the JAX references' batch, at
# 1e-3: a sweep of 64 at 1e-4 took 306 s of the script's 1200 on one host
# (its slowest instance's ~28,000 launch-bound steps), of 8 at 1e-4 177 s
# (24,184 steps); at 1e-3 the JAX run's slowest instance takes 6,530
# iterations against 19,307, on the same kernels of dense_batched's path
K1_SIZE, K1_SIDE, K1_ROWS = 8, 40, 20
K1_TOL = 1e-3
K3_SIZE, K3_SIDE = 64, 40
# the JAX package's solve_batch of instances 0-7 of K1 and of K3 under the
# same options (one CPU thread; tests/test_torch_reference_values.py
# re-derives them, slow): statuses all 1
K1_REF_OBJ = [262.739882468766, 309.2979400137903, 292.08323623793797,
              233.78388053927137, 342.0000656487037, 272.1485725809556,
              585.1131754311178, 244.61683071923562]
K1_REF_ITERS = [3421, 4257, 6530, 2599, 5313, 4879, 2479, 2612]
K3_REF_OBJ = [72.76375332712261, 69.93610649084243, 77.66198958210019,
              66.06956412877948, 66.39328895115288, 67.56914574196529,
              65.71511650481064, 66.67022793203446]
K3_REF_ITERS = [353, 339, 388, 274, 332, 380, 378, 187]
K_OBJ_RTOL = 2e-4
# randsdp's answers at 1e-4 tolerances do not pin the objective: its dense
# A_k (entries ~10, b_k ~1e3) let a 1e-4 relative infeasibility move it
# by percent, and where in that box a solve stops depends on its f32
# race's rounding (ROADMAP C19).  The JAX package's own solves of
# instances 0-7 lie up to 2.33e-2 (1 + |obj|) from the optimum
# (K1_EXACT_OBJ: its f64 program at 1e-7 tolerances) in the hybrid mode
# (K1_REF_OBJ) and 1.6e-2 in the f64 program; the port's CPU hybrid run
# up to 1.95e-2, the card's 7.08e-2 (PERF.md).  So the
# default sweep is held to status, feasibility and PSD, its objectives
# printed beside the optimum and the JAX batch, and the like-mode check
# is K1's f64 program: instances 0-7 for K1_F64_ITERS iterations, the
# objective and ||x|| within 1e-6 relative of the JAX package's
# (K1_F64_REF; the port's CPU run agrees to 6e-11).
K1_EXACT_OBJ = [261.1705530574257, 307.28433608202124, 292.07716446981266,
                228.63672150567578, 341.98563513516183, 268.03812287957504,
                583.0440330403297, 239.88800938387803]
K1_F64_ITERS = 300
K1_F64_REF = {
    "obj": [4615.220057550045, 7435.738825943252, 6267.703904380513,
            5410.940466712292, 5295.253585391379, 7389.202902621326,
            6696.068142044327, 5505.911410142615],
    "xnorm": [688.6628999282582, 854.6454769751252, 866.7300276262781,
              636.6193143759991, 701.846481305907, 695.7210282814125,
              744.3761246229025, 559.6818629878279]}
K1_F64_RTOL = 1e-6
# K2: the smallest MIMO and sensor-localisation sizes of
# benchmarks/applications.py:109-110 through Optimizer.optimize.  MIMO
# n = 100 under the default options does not reach status 1 in the JAX
# package: its hybrid solve stops at the iteration limit (1e6, status 3,
# objective 0.034, 1226 s on one CPU thread; the TPU run of
# benchmarks/results/tpu_queue_r5/mimo100_long_tpu.csv: 715,194
# iterations, gap 0.133), while its f64 program (hybrid_precision=False)
# reaches status 1 in 254 iterations at the optimum ~1e-5 (ROADMAP C18).
# So K2 runs MIMO twice: under the default options to K2_MIMO_MAX_ITER
# iterations (the API's default path; status and decode error against
# the JAX run's; the objective, printed beside it, is that of the
# best-iterate snapshot, taken at most every 2 s of wall time, so it moves
# with the host's speed in either package), and in the f64 program to
# status 1, against the JAX run's objective within K_OBJ_RTOL.
K2_MIMO_N, K2_MIMO_MAX_ITER = 100, 3000
K2_MIMO_REF = {"status": 3, "obj": 0.03030874766409397, "iter": 3000,
               "gap": 0.012704258784651756, "decode": 0.0}
K2_MIMO64_REF = {"status": 1, "obj": 9.952962778533468e-06, "iter": 254,
                 "gap": 5.854201266358679e-06, "decode": 0.0}
K2_SL_N = 100
K2_SL_REF = {"status": 1, "iter": 1677, "pos_err": 0.0009424733177226924}


def k3_problems(Optimizer, random_graph_weights, B=K3_SIZE, side=K3_SIDE):
    """Max-cut relaxations whose row i reads d_i X_ii = d_i, d_i = 1 + the
    weighted degree of vertex i (a degree-scaled constraint, as a model
    whose rows carry their own units states it): the same feasible set and
    optimum as the max-cut's, the same sparsity pattern in every
    instance, per-instance values."""
    problems = []
    for s in range(B):
        W = random_graph_weights(s, side)
        d = 1.0 + np.abs(W).sum(axis=1)
        opt = Optimizer()
        X = opt.add_psd_var(side)
        for i in range(side):
            opt.add_eq_constraint({int(X[i, i]): float(d[i])}, float(d[i]))
        opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * W),
                          sense="max")
        problems.append(opt.build_problem())
    return problems


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(torch, fn) -> float:
    """Median of REPS CUDA-event-timed calls after 3 warm-up calls; a call
    slower than SLOW_MS (cuSOLVER's batched eigh above side 32 takes
    ~0.5 s) gets one warm-up and 3 timed calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    slow = start.elapsed_time(end) > SLOW_MS
    for _ in range(0 if slow else 2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3 if slow else REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, got, want):
    """(max abs error, max error relative to the largest finite value) of a
    kernel's outputs against the plain version's; equal entries (incl. inf
    and NaN pairs) count as 0."""
    got = torch.cat([g.reshape(-1).double() for g in got])
    want = torch.cat([w.reshape(-1).double() for w in want])
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    finite = want[torch.isfinite(want)]
    scale = float(finite.abs().max()) if finite.numel() else 1.0
    err = float(diff.max())
    return err, err / max(scale, 1e-300)


def nbytes(tensors) -> int:
    """Bytes of distinct tensors (one read or write each)."""
    seen, total = set(), 0
    for t in tensors:
        if t is None or t.data_ptr() in seen:
            continue
        seen.add(t.data_ptr())
        total += t.numel() * t.element_size()
    return total


# the shape of a wrapper call, by kernel: the side-2000 phases give a
# kernels-line row the launches of its own shape (ns_gemm: M, K, N)
CALL_SHAPE = {
    "ns_gemm": lambda A, B, *a, **kw: (A.shape[0], A.shape[1], B.shape[1]),
    "fro_scale": lambda X, *a, **kw: tuple(X.shape),
    "sym": lambda Y, *a, **kw: tuple(Y.shape),
    "sym_guard": lambda P, *a, **kw: tuple(P.shape),
    "cholqr": lambda Y, *a, **kw: tuple(Y.shape),
    "ritz_accept": lambda W, *a, **kw: tuple(W.shape),
    "lanczos_krylov": lambda X, v0, ncv, *a, **kw: (X.shape[0], ncv),
    # phase G: (B, side, k) of K12, (B, s, s) of K9
    "batched_subspace": lambda v, warm, *a, **kw: tuple(warm.shape),
    "batched_psd_eigh": lambda X, *a, **kw: tuple(X.shape),
    # phase N: (side, k) of K17
    "subspace_sign": lambda Q, *a, **kw: tuple(Q.shape),
    # phases A and O: (side, rows) of K18
    "psd_reconstruct": lambda V, w, r0, r1, *a, **kw: (V.shape[0], r1 - r0),
}


class ShapeCounts:
    """Launches by entry point and call shape: wraps the CALL_SHAPE
    wrappers of ``kernels`` and credits the change of the wrappers' own
    counts over each call to that call's shape."""

    def __init__(self, kernels):
        self.counts = collections.Counter()  # (entry, shape) -> launches
        lc = kernels.launch_counts
        for name, shape in CALL_SHAPE.items():
            def counted(*a, _fn=getattr(kernels, name), _shape=shape, **kw):
                before = dict(lc)
                out = _fn(*a, **kw)
                for entry, n in lc.items():
                    if n != before[entry]:
                        self.counts[entry, _shape(*a, **kw)] += n - before[entry]
                return out

            setattr(kernels, name, counted)

    def reset(self) -> None:
        self.counts.clear()


SHAPES: ShapeCounts | None = None  # installed by main()


class TrialCounts:
    """The trial counts that K15 and K15b return, kept per entry point
    until the launch counts are next set to 0 (``reset_launch_counts`` is
    wrapped to clear them too).  The runs do no device work for it: the
    outputs are summed when read."""

    def __init__(self, torch, kernels):
        self.torch = torch
        self.outs = collections.defaultdict(list)
        for name in ("linesearch_loop", "linesearch_loop_batch"):
            def counted(*a, _fn=getattr(kernels, name), _name=name, **kw):
                out = _fn(*a, **kw)
                self.outs[_name].append(out[4])
                return out

            setattr(kernels, name, counted)
        reset = kernels.reset_launch_counts

        def reset_all():
            reset()
            self.outs.clear()

        kernels.reset_launch_counts = reset_all

    def read(self, name: str) -> str:
        outs = self.outs.get(name)
        if not outs:
            return f"{name}: not launched"
        t = self.torch.cat([o.reshape(-1) for o in outs]).double()
        ran = t[t > 0]
        return (f"{name}: {len(outs)} launches, {int(t.sum())} trials, "
                f"{float(ran.mean()):.3f} trials per "
                + ("iteration" if name == "linesearch_loop"
                   else "active instance and iteration"))


TRIALS: TrialCounts | None = None  # installed by main()


def solve_timed(torch, kernels, solve, problem, opts, capture=False):
    """Warm-up solve, then the timed one with the launch counts set to 0
    just before it and read just after; (result, wall s, counts by entry
    point, counts by kernel, counts by entry point and call shape,
    captured stdout)."""
    solve(problem, opts.replace(log_verbose=False, timer_verbose=False))
    torch.cuda.synchronize()
    buf = io.StringIO()
    kernels.reset_launch_counts()
    SHAPES.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf) if capture else contextlib.nullcontext():
        res = solve(problem, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, wall, dict(kernels.launch_counts), kernels.kernel_launches(),
            collections.Counter(SHAPES.counts), buf.getvalue())


def assign_launches(rows, shapes, entries):
    """Each row's launches in a counted run: a row whose call shape was
    recorded takes its entry point's launches at that shape (``shapes``),
    any other row its entry point's (``entries``).  Returns (the rows for
    the kernels line, the rows left off it: not launched at their shape,
    or a second row of an entry point and shape already on the line)."""
    kept, left, seen = [], [], set()
    for row in rows:
        entry, key = row["name"].split(" ")[0], row["_shape"]
        row["launches"] = entries[entry] if key is None else shapes[entry, key]
        if key is not None and (not row["launches"] or (entry, key) in seen):
            left.append(row)
        else:
            seen.add((entry, key))
            kept.append(row)
    return kept, left


def print_shapes(label, shapes, rows):
    """The launches of a counted run by entry point and shape, and those
    at a shape no row of ``rows`` checks."""
    checked = {(row["name"].split(" ")[0], row["_shape"]) for row in rows}
    print(f"{label}: launches by entry point and shape: " + "; ".join(
        f"{e} {list(key)} {n}" for (e, key), n in sorted(shapes.items())))
    unchecked = {f"{e} {list(key)}": n for (e, key), n in shapes.items()
                 if (e, key) not in checked}
    print(f"{label}: launched at shapes no row checks: "
          + (json.dumps(unchecked) if unchecked else "none"))


def check_solution(res, Xidx, ref_obj, diag_tol, label):
    X = res.primal[Xidx]
    diag_err = float(np.max(np.abs(np.diag(X) - 1.0)))
    lam_min = float(np.linalg.eigvalsh(X)[0])
    fro = float(np.linalg.norm(X))
    check(res.status == 1, f"{label}: status {res.status}, want 1 (OPTIMAL)")
    check(abs(res.objval - ref_obj) <= 1e-4 * (1 + abs(ref_obj)),
          f"{label}: objval {res.objval} vs {ref_obj}")
    check(np.all(np.isfinite(X)) and X.shape == (SIDE, SIDE),
          f"{label}: X not finite")
    check(diag_err <= diag_tol, f"{label}: max|diag(X)-1| = {diag_err} > {diag_tol}")
    check(lam_min >= -1e-6 * fro, f"{label}: lambda_min(X) = {lam_min}")
    return diag_err, lam_min, fro


def check_entry(torch, kernels, out, name, sfx, source, replaces, call, plain,
                inputs, outputs, flops, library=None, compare_fn=None,
                tol=None, label="", note="", wrapper=None, timed=True):
    """Run one entry point on the card and its plain version on the same
    inputs, compare, time both (and the library call), and append the
    kernels-line row to ``out``; launches are filled in later.  The bound's
    bytes are those of ``inputs`` and ``outputs``, each once.  ``wrapper``
    names the wrapper that routes to the entry point, where it is not
    ``name`` (K9L and K12L are routes of batched_psd_eigh and
    batched_subspace).  ``timed=False`` checks without timing (a row of
    a shape no path runs, kept off the kernels line: its times None)."""
    entry = f"{name}_{sfx}"
    row_name = f"{entry} ({label})" if label else entry
    fn = wrapper or name
    kernels.reset_launch_counts()
    SHAPES.reset()
    got = call(getattr(kernels, fn))
    torch.cuda.synchronize()
    check(kernels.launch_counts[entry] >= 1,
          f"{entry}: the wrapper launched no kernel")
    shapes = {key for e, key in SHAPES.counts if e == entry}
    want = call(plain)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, rel = (compare_fn or (lambda g, w: compare(torch, g, w)))(got, want)
    if tol is None:
        tol = RTOL["f64" if all(w.dtype != torch.float32 for w in want)
                   else "f32"]
    ms = median_ms(torch, lambda: call(getattr(kernels, fn))) if timed else None
    plain_ms = median_ms(torch, lambda: call(plain)) if timed else None
    lib_ms = median_ms(torch, library) if library and timed else None
    t_bytes = nbytes(list(inputs) + list(outputs)) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS["f32" if "f32" in sfx else "f64"] * 1e3
    times = (f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
             f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms" if timed
             else "not timed (off every path)")
    print(f"kernel {row_name:32s} max_abs_err {err:.3e} rel {rel:.3e} "
          f"(tol {tol:.2g}) {times} "
          f"bound {max(t_bytes, t_ops) * 1e3:.3f} us{note}")
    check(rel <= tol, f"{entry}: relative error {rel:.3e} > {tol}")
    out.append({
        "name": row_name, "route": "cuda",
        "source": f"proxsdp_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        # the call's shape (one, or none for an unrecorded kernel); removed
        # before the kernels line is printed
        "_shape": shapes.pop() if len(shapes) == 1 else None,
    })


def _tables(M) -> list:
    """The M' tables of a port operator (None where a form has none)."""
    return list(M.rmatvec_tables()[1:4])


def _ls_compare(torch, sfx, label, exact):
    """K15's (K15b's) outputs against the sequence's: the same trial
    counts, and in f64 the same bits where ``exact``."""
    def cmp(got, want):
        check(torch.equal(got[4], want[4]),
              f"linesearch ({label}): trial counts differ from the sequence's")
        if sfx == "f64" and exact:
            for g, w in zip(got, want):
                check(torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)),
                      f"linesearch ({label}): f64 outputs not bit for bit "
                      "the sequence's")
        return compare(torch, got[:4], want[:4])
    return cmp


def linesearch_row(torch, kernels, out, M, p, m, sfx, dt, dev, rng, label,
                   tau=3.0):
    """Phase B row of K15 on the operator M: a state whose first step is
    ~tau ||M|| times an accepted one (several trials), against the K2 ->
    product -> sq_dist sequence with a host read a trial (the plain loop
    on the card): bit for bit in f64 and within 1e-7 in f32 on the sparse
    forms; on the dense form, whose plain M' y is a cuBLAS product that
    sums in another order, the same trial count and RTOL.  Bound: the
    inputs (y, Mx, Mx_old, y_old, b, h, Mty_old, the M' tables) read once
    and y_temp, Mty written once -- what a trial rereads stays in the 50 MB
    L2 at every shape here -- against trials x (10 (p + m) + 2 nnz + 3 n)
    flops; one trial's bytes in the note."""
    rows_, n = p + m, M.shape[1]

    def vec(k):
        return torch.tensor(rng.standard_normal(k), dtype=dt, device=dev)

    def sc(v):
        return torch.tensor(v, dtype=dt, device=dev)

    y, y_old, Mx, Mx_old = (vec(rows_) for _ in range(4))
    b, h = vec(p), vec(m)
    args = (M, y, Mx, Mx_old, b, h, y_old, M.rmatvec(y_old), sc(tau), sc(tau),
            sc(1.0), sc(1.0), p, m, 0.9999, 0.75, 5000)
    want = kernels.linesearch_loop_plain(*args)
    trials = int(want[4])
    tables = _tables(M)
    exact = tables[1] is not None  # the sparse forms
    trial_bytes = y.element_size() * (6 * rows_ + 2 * n) + nbytes(tables)
    check_entry(torch, kernels, out, "linesearch_loop", sfx, "ls_loop.cu",
                "proxsdp_tpu/solver.py:436", lambda f: f(*args),
                kernels.linesearch_loop_plain,
                [t for t in args if isinstance(t, torch.Tensor)] + tables,
                want, trials * (10 * rows_ + 2 * tables[2].numel() + 3 * n),
                compare_fn=_ls_compare(torch, sfx, label, exact),
                tol=(0.0 if sfx == "f64" else 1e-7) if exact else None,
                label=label,
                note=f" ({trials} trials, {trial_bytes} bytes a trial; "
                "library: none)")
    LAUNCH_US.append((f"linesearch_loop_{sfx} ({label})",
                      lambda: kernels.linesearch_loop(*args), "ls_loop_kernel"))


def linesearch_batch_row(torch, kernels, out, o, p, m, sfx, dt, dev, rng,
                         label, exact=True):
    """Phase B row of K15b over the batch's operator o.M -- shared, or one
    per instance (K15b': stacked ELL values or dense matrices) -- every
    instance active with its own step scale (1 to ~8 trials), against
    the batched K2 -> M' product -> sq_dist sequence: bit for bit in f64
    where ``exact`` (and within 1e-7 in f32), else the same trial counts
    and RTOL (a dense M' whose plain product sums in another order).
    Bound: the inputs and the tables read once, the outputs written once
    (as K15's); flops per trial of an instance count its own table."""
    B, rows_ = o.b.shape[0], p + m
    n = o.M.shape[1]

    def rows_of(k):
        return torch.tensor(rng.standard_normal((B, k)), dtype=dt, device=dev)

    def per(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, B), dtype=dt, device=dev)

    y, y_old, Mx, Mx_old = (rows_of(rows_) for _ in range(4))
    tau = per(0.5, 4.0)
    args = (o.M, y, Mx, Mx_old, o.b, o.h, y_old, rows_of(n),
            o.M.rmatvec_batch(y_old), tau, tau, per(0.5, 1.0),
            torch.ones_like(tau), torch.ones(B, dtype=torch.bool, device=dev),
            p, m, 0.9999, 0.75, 5000)
    want = kernels.linesearch_loop_batch_plain(*args)
    trials = want[4].cpu().numpy()
    tables = _tables(o.M)
    nnz = tables[2].numel() // (B if o.M.batched else 1)
    check_entry(torch, kernels, out, "linesearch_loop_batch", sfx,
                "ls_loop.cu", "proxsdp_tpu/parallel/batch.py:141",
                lambda f: f(*args), kernels.linesearch_loop_batch_plain,
                [t for t in args if isinstance(t, torch.Tensor)] + tables,
                want, int(trials.sum()) * (10 * rows_ + 2 * nnz + 3 * n),
                compare_fn=_ls_compare(torch, sfx, label, exact),
                tol=(0.0 if sfx == "f64" else 1e-7) if exact else None,
                label=label,
                note=f" (trials {int(trials.min())}-{int(trials.max())}, "
                f"mean {trials.mean():.2f}; library: none)")
    LAUNCH_US.append((f"linesearch_loop_batch_{sfx} ({label})",
                      lambda: kernels.linesearch_loop_batch(*args),
                      "ls_loop_batch_kernel"))


def k10_take_index(torch, kernels, B, side, width, dt, dev):
    """Flat indices for K10's library column: torch.take of the gather
    tri_to_square makes from B rows of ``width`` (its scale left out), and
    of the one square_to_tri makes from B (side, side) matrices."""
    gidx, _, sq_of_tri, _ = kernels._tri_maps(side, dt, dev)
    rows = torch.arange(B, device=dev)[:, None]
    return (rows * width + gidx.long()[None, :],
            rows * (side * side) + sq_of_tri.long()[None, :])


def kernel_checks(torch, kernels, setup, rng, dev):
    """Each entry point of the default path against its plain version at
    the path's shapes on ``dev``; (rows of the kernels line, launches
    filled in later; rows of entry points the side-250 solves do not run,
    checked alike but left out of that line)."""
    import torch.nn.functional as F

    from proxsdp_tpu_torch.ops.cones import POLAR_QA, POLAR_QB, POLAR_QC
    from proxsdp_tpu_torch.ops.linop import build_linop

    n, p, m = setup.layout.n, setup.layout.p, setup.layout.m
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    rows, off_path = [], []

    def add(*args, on_path=True, **kw):
        check_entry(torch, kernels, rows if on_path else off_path, *args,
                    note="" if on_path else " (not on the side-250 solves)",
                    **kw)

    # ---- K1-K4 in both programs (the f32 race and the f64 polish)
    for sfx, dt in dtypes.items():
        M = build_linop(setup.A, setup.G, dt, device=dev)

        def vec(k, scale=1.0, dt=dt):
            return torch.tensor(scale * rng.standard_normal(k), dtype=dt,
                                device=dev)

        def scalar(v, dt=dt):
            return torch.tensor(v, dtype=dt, device=dev)

        b = torch.tensor(setup.b, dtype=dt, device=dev)
        h = torch.tensor(setup.h, dtype=dt, device=dev)
        c = torch.tensor(setup.c, dtype=dt, device=dev)
        x, x_old, Mty, Mty_old = vec(n), vec(n), vec(n, 1e-2), vec(n, 1e-2)
        y, y_old, Mx, Mx_old = vec(p + m), vec(p + m), vec(p + m), vec(p + m)
        tau, sigma, theta = scalar(0.37), scalar(0.21), scalar(0.93)
        csr_row = torch.sparse_coo_tensor(
            torch.stack([torch.arange(p + m, device=dev).repeat_interleave(
                M.row_cols.shape[1]), M.row_cols.reshape(-1).long()]),
            M.row_vals.reshape(-1), (p + m, n)).to_sparse_csr()
        csr_col = torch.sparse_coo_tensor(
            torch.stack([torch.arange(n, device=dev).repeat_interleave(
                M.col_rows.shape[1]), M.col_rows.reshape(-1).long()]),
            M.col_vals.reshape(-1), (n, p + m)).to_sparse_csr()
        out_pm, out_n = vec(p + m), vec(n)
        add("ell_spmv", sfx, "ell_spmv.cu", "proxsdp_tpu/ops/linop.py:123",
            lambda f: (f(M.row_cols, M.row_vals, x), f(M.col_rows, M.col_vals, y)),
            kernels.ell_spmv_plain,
            (M.row_cols, M.row_vals, x, M.col_rows, M.col_vals, y),
            (out_pm, out_n), 2 * (M.row_vals.numel() + M.col_vals.numel()),
            library=lambda: (torch.sparse.mm(csr_row, x[:, None]),
                             torch.sparse.mm(csr_col, y[:, None])))
        # one trial's kernels: they run only on the tensor-parallel path
        # (phase O), where K15 cannot span the ranks
        check_entry(torch, kernels, TRIAL_ROWS, "ls_dual_update", sfx,
                    "ls_dual_update.cu", "proxsdp_tpu/solver.py:452",
                    lambda f: f(y, Mx, Mx_old, b, h, y_old, sigma, theta, p, m),
                    kernels.ls_dual_update_plain,
                    (y, Mx, Mx_old, b, h, y_old, sigma, theta), (out_pm, tau),
                    10 * (p + m), note=" (one trial's kernel: the tensor-parallel path only)")
        check_entry(torch, kernels, TRIAL_ROWS, "sq_dist", sfx,
                    "ls_dual_update.cu", "proxsdp_tpu/solver.py:459",
                    lambda f: (f(Mty, Mty_old),), kernels.sq_dist_plain,
                    (Mty, Mty_old), (tau,), 3 * n,
                    library=lambda: F.mse_loss(Mty, Mty_old, reduction="sum"),
                    note=" (one trial's kernel: the tensor-parallel path only)")
        # their own generator: the other rows keep their inputs
        linesearch_row(torch, kernels, rows, M, p, m, sfx, dt, dev,
                       np.random.default_rng(10), f"side {SIDE}, ELL")
        add("residuals", sfx, "residuals.cu", "proxsdp_tpu/solver.py:545",
            lambda f: (f(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old,
                         sigma, b, h, c, p, m, (SIDE,)),),
            kernels.residuals_plain,
            (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c),
            (torch.empty(9, dtype=torch.float64, device=dev),),
            10 * n + 10 * (p + m))
        add("primal_update_sym", sfx, "primal_update_sym.cu",
            "proxsdp_tpu/solver.py:308",
            lambda f: (f(x, Mty, c, tau, (SIDE,)),),
            kernels.primal_update_sym_plain, (x, Mty, c, tau), (out_n,), 5 * n)

    # ---- K5-K8: a side-250 matrix with the race's spectrum (a few large
    # positive eigenvalues, a negative bulk), its Newton-Schulz iterate, and
    # the subspace bases (k = 24 in the f32 race, 16 in the mixed polish)
    f32, f64 = torch.float32, torch.float64
    V, _ = np.linalg.qr(rng.standard_normal((SIDE, SIDE)))
    w = np.concatenate([np.linspace(40.0, 1.0, 14),
                        -np.linspace(0.05, 5.0, SIDE - 14)])
    X64 = torch.tensor((V * w) @ V.T, dtype=f64, device=dev)
    X = X64.float()
    # the sign of X and a warm (side, 24) basis: its top eigenvectors
    Sgn = torch.tensor((V * np.sign(w)) @ V.T, dtype=f32, device=dev)
    wb = torch.tensor(V[:, :24], dtype=f32, device=dev)
    Y, _ = kernels.fro_scale_plain(X, f32)
    A = kernels.ns_gemm_plain(Y, Y)
    S = kernels.sym_plain(Y)
    P = kernels.ns_gemm_plain(S, X, X, 0.5, 0.5)
    mat = torch.empty_like(X)
    cube = 2 * SIDE ** 3
    add("ns_gemm", "f32", "ns_gemm.cu", "proxsdp_tpu/ops/cones.py:89",
        lambda f: (f(A, A, A, POLAR_QB, POLAR_QC),), kernels.ns_gemm_plain,
        (A,), (mat,), cube + 3 * SIDE * SIDE,
        library=lambda: torch.addmm(A, A, A, beta=POLAR_QB, alpha=POLAR_QC))
    LAUNCH_US.append((f"ns_gemm_f32 (side {SIDE}, QB A + QC A A)",
                      lambda: kernels.ns_gemm(A, A, A, POLAR_QB, POLAR_QC),
                      "gemm_axpby_kernel"))
    add("ns_gemm", "f32", "ns_gemm.cu", "proxsdp_tpu/ops/cones.py:90",
        lambda f: (f(Y, A, Y, POLAR_QA, 1.0),), kernels.ns_gemm_plain,
        (Y, A), (mat,), cube + 3 * SIDE * SIDE,
        library=lambda: torch.addmm(Y, Y, A, beta=POLAR_QA, alpha=1.0),
        label="Y = QA Y + Y B")
    # polar_reseed's P+ on the leading k - 1 columns and P- on the last:
    # column slices of the basis, row stride k, partial tiles
    for label, cols, sign, line in (("P+ warm", slice(None, -1), 0.5, 296),
                                    ("P- last", slice(-1, None), -0.5, 297)):
        Wc = wb[:, cols]
        kc = Wc.shape[1]
        add("ns_gemm", "f32", "ns_gemm.cu", f"proxsdp_tpu/ops/cones.py:{line}",
            lambda f, Wc=Wc, sign=sign: (f(Sgn, Wc, Wc, 0.5, sign),),
            kernels.ns_gemm_plain, (Sgn, Wc),
            (torch.empty(SIDE, kc, dtype=f32, device=dev),),
            2 * SIDE * SIDE * kc + 3 * SIDE * kc,
            library=lambda Wc=Wc, sign=sign: torch.addmm(
                Wc, Sgn, Wc, beta=0.5, alpha=sign),
            label=f"{label}, strided")
    add("fro_scale", "f32", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:85",
        lambda f: f(X, f32), kernels.fro_scale_plain, (X,), (mat,),
        3 * SIDE * SIDE)
    add("sym", "f32", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:94",
        lambda f: (f(Y),), kernels.sym_plain, (Y,), (mat,), 2 * SIDE * SIDE)
    add("sym_guard", "f32", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:96",
        lambda f: f(P, S, X), kernels.sym_guard_plain,
        (P, torch.diagonal(S).contiguous()), (mat,), 3 * SIDE * SIDE)
    # the f64 program's f32-compute polar reseed (subspace_fallback
    # "polar"): the default path takes it in the polish above
    # polar_fallback_min_side = 384, not at side 250
    add("fro_scale", "f64_f32", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:281",
        lambda f: f(X64, f32), kernels.fro_scale_plain, (X64,),
        (mat, torch.empty_like(mat)),
        3 * SIDE * SIDE, on_path=False)
    add("sym_guard", "f32_f64", "polar_sym.cu", "proxsdp_tpu/ops/cones.py:303",
        lambda f: f(P, S, X64), kernels.sym_guard_plain,
        (P, torch.diagonal(S).contiguous()), (X64,), 3 * SIDE * SIDE,
        tol=RTOL["f32"], on_path=False)
    for sfx, k, dt in (("f32", 24, f32), ("f32", 16, f32)):
        Yk = torch.matmul(X, torch.tensor(rng.standard_normal((SIDE, k)),
                                          dtype=dt, device=dev))
        add("cholqr", sfx, "cholqr.cu", "proxsdp_tpu/ops/cones.py:247",
            lambda f, Yk=Yk: (f(Yk, kernels.CHOLQR_EPS[f32]),),
            kernels.cholqr_plain, (Yk,), (Yk, torch.empty_like(Yk)),
            # G = Y^T Y (symmetric), its Cholesky, the solve Y L^-T
            2 * SIDE * k * k + k ** 3 // 3, label=f"k={k}",
            library=lambda Yk=Yk: torch.linalg.qr(Yk))
        # a launch runs one CUDA function (the small pass) or three
        LAUNCH_US.append((f"cholqr_f32 (side {SIDE}, k={k})",
                          lambda Yk=Yk: kernels.cholqr(Yk), "cholqr_", True))
    # K8: the race's f32 test (theta from the eigh) at k = 24, and the
    # mixed polish's f64 test (f64 Rayleigh quotients) at k = 16
    for sfx, k, dt in (("f32", 24, f32), ("f64", 16, f64)):
        Wk = torch.tensor(V[:, :k], dtype=dt, device=dev)
        Xk = X64.to(dt)
        XW = torch.matmul(Xk, Wk)
        th = (torch.tensor(w[:k], dtype=dt, device=dev) if sfx == "f32"
              else None)
        at = torch.tensor(1e-4, dtype=dt, device=dev)
        tol = 1e-9 if sfx == "f32" else 4e-6

        def exact_flags(g, wnt):
            check(torch.equal(g[2].cpu(), wnt[2].cpu()),
                  f"ritz_accept_{sfx}: flags {g[2].tolist()} vs {wnt[2].tolist()}")
            return compare(torch, g[:2], wnt[:2])

        add("ritz_accept", sfx, "ritz_accept.cu",
            "proxsdp_tpu/ops/cones.py:443",
            lambda f, Wk=Wk, XW=XW, th=th, at=at, tol=tol: f(
                Wk, XW, th, at, tol, 1e-7, False),
            kernels.ritz_accept_plain, (Wk, XW, th, at),
            (torch.empty(k + 3, dtype=dt, device=dev),), 8 * SIDE * k,
            compare_fn=exact_flags)
    return rows, off_path


EIGH_SIDES = (2, 10, 16, 31, 32, 33, 40, 64)
EIGH_OFF_PATH_B = 128
# K9 against torch.linalg.eigh: two backward-stable eigensolvers, whose
# projections and eigenvalues differ by a few s * eps * ||X||; held
# relative to the batch's largest entry, to EIGH_RTOL, and in f32 above
# side 118 to EIGH_RTOL_F32_WIDE: at side 168 the f32 rotations' rounding
# puts K9 1.41e-4 of the scale from cuSOLVER, with jacobi.cuh's global
# stop and with a per-pair relative stop alike (on an H100, PERF.md)
EIGH_RTOL = {"f64": 1e-11, "f32": 1e-4}
EIGH_RTOL_F32_WIDE = 1.5e-4
TOL_PSD = 1e-7


def eigh_inputs(torch, rng, side, dt, dev, B=BATCH_SIZE):
    """B symmetric side x side matrices: random ones, every third
    rank-deficient (half its eigenvalues exactly 0), instance 1 NaN."""
    X = rng.standard_normal((B, side, side))
    X = 0.5 * (X + X.transpose(0, 2, 1))
    Q, _ = np.linalg.qr(rng.standard_normal((B // 3 + 1, side, side)))
    w = 3.0 * rng.standard_normal((B // 3 + 1, side))
    w[:, : side // 2] = 0.0
    X[::3] = np.einsum("bik,bk,bjk->bij", Q, w, Q)[: len(X[::3])]
    X[1, 0, side - 1] = np.nan
    return torch.tensor(X, dtype=dt, device=dev)


def eigh_compare(torch, X, tol):
    """K9's outputs (Xp, w, rank, warm) against the plain version's: the
    NaN instance alone NaN with rank 0; projection and eigenvalues to
    ``tol`` of the largest entry; ranks equal wherever every eigenvalue
    clears tol_psd by more than that; the top eigenvector up to sign where
    the top eigenvalue is simple.  Returns (max abs error, relative)."""

    def fn(got, want):
        (Xp, w, rank, warm), (pXp, pw, prank, pwarm) = got, want
        fin = torch.isfinite(X).all(dim=(1, 2))
        for t in (Xp.flatten(1), w, warm):
            check(torch.equal(torch.isnan(t).all(dim=1), ~fin),
                  "batched_psd_eigh: NaN outside the non-finite instance")
        check(bool((rank[~fin] == 0).all()), "batched_psd_eigh: NaN rank")
        scale = float(X[fin].abs().max())
        err = max(float((Xp[fin] - pXp[fin]).abs().max()),
                  float((w[fin] - pw[fin]).abs().max()))
        clear = ((pw[fin] - TOL_PSD).abs() > tol * scale).all(dim=1)
        check(torch.equal(rank[fin][clear], prank[fin][clear]),
              "batched_psd_eigh: ranks differ")
        simple = (pw[fin][:, -1] - pw[fin][:, -2]) > 1e-3 * scale
        dots = torch.sum(warm[fin] * pwarm[fin], dim=1).abs()[simple]
        check(not dots.numel() or float((1 - dots).abs().max()) <= 1e-3,
              "batched_psd_eigh: top eigenvectors differ")
        return err, err / scale

    return fn


def batch_kernel_checks(torch, kernels, setups, rng, dev, eigh_sides=EIGH_SIDES,
                        phase="D"):
    """Phase B rows of a batch path: K9 at every side of ``eigh_sides`` in
    each type that takes it (the path's side on the path, the others
    checked but off it), K10 and the batched K1-K4 entry points at the
    path's shapes (``setups``: its instances), in f32 (the race) and f64;
    (rows of the kernels line, off-path rows)."""
    from proxsdp_tpu_torch.parallel.batch import _batch_operands

    rows, off_path = [], []
    B = len(setups)
    lay = setups[0].layout
    side, n, p, m = lay.sdp_sides[0], lay.n, lay.p, lay.m
    tl = side * (side + 1) // 2
    tag = "" if phase == "D" else f"{phase}: "
    for sfx, dt in (("f64", torch.float64), ("f32", torch.float32)):
        for s in eigh_sides:
            if s > kernels.EIGH_MAX_SIDE[dt]:
                continue
            # an off-path side is checked on at most EIGH_OFF_PATH_B
            # matrices: cuSOLVER's batched eigh, the library row, takes
            # ~0.5-0.9 s a call on 1024 of them above side 32
            X = eigh_inputs(torch, rng, s, dt, dev,
                            B if s == side else min(B, EIGH_OFF_PATH_B))
            # the function's work, whatever the algorithm: a symmetric
            # eigendecomposition with vectors ~9 s^3 (symmetric QR), the
            # reconstruction V diag(max(w, 0)) V^T ~1.5 s^3
            nb = X.shape[0]
            flops = nb * 10.5 * s ** 3
            outs = (torch.empty_like(X), torch.empty(nb, s, dtype=dt, device=dev),
                    torch.empty(nb, dtype=torch.int32, device=dev),
                    torch.empty(nb, s, dtype=dt, device=dev))
            on = s == side
            tol = EIGH_RTOL_F32_WIDE if sfx == "f32" and s > 118 else EIGH_RTOL[sfx]
            check_entry(
                torch, kernels, rows if on else off_path, "batched_psd_eigh",
                sfx, "batched_eigh.cu", "proxsdp_tpu/ops/cones.py:622",
                lambda f, X=X: f(X, TOL_PSD), kernels.batched_psd_eigh_plain,
                (X,), outs, flops,
                library=lambda Xf=torch.nan_to_num(X): torch.linalg.eigh(Xf),
                compare_fn=eigh_compare(torch, X, tol),
                tol=tol, label=f"{tag}side {s}",
                note="" if on else f" (side {s}: not phase {phase}'s)")

        o = _batch_operands(setups, dt, dev, "auto")
        M = o.M

        def rows_of(k, scale=1.0, dt=dt):
            return torch.tensor(scale * rng.standard_normal((B, k)), dtype=dt,
                                device=dev)

        def steps(dt=dt):
            return torch.tensor(rng.uniform(0.1, 1.0, B), dtype=dt, device=dev)

        x, x_old, Mty, Mty_old = rows_of(n), rows_of(n), rows_of(n, 1e-2), \
            rows_of(n, 1e-2)
        y, y_old, Mx, Mx_old = (rows_of(p + m) for _ in range(4))
        tau, sigma, theta = steps(), steps(), steps()
        out_pm, out_n = rows_of(p + m), rows_of(n)
        csr_row = torch.sparse_coo_tensor(
            torch.stack([torch.arange(p + m, device=dev).repeat_interleave(
                M.row_cols.shape[1]), M.row_cols.reshape(-1).long()]),
            M.row_vals.reshape(-1), (p + m, n)).to_sparse_csr()
        csr_col = torch.sparse_coo_tensor(
            torch.stack([torch.arange(n, device=dev).repeat_interleave(
                M.col_rows.shape[1]), M.col_rows.reshape(-1).long()]),
            M.col_vals.reshape(-1), (n, p + m)).to_sparse_csr()
        xT, yT = x.T.contiguous(), y.T.contiguous()

        def add(*args, **kw):
            check_entry(torch, kernels, rows, *args,
                        label=f"{phase}: side {side}" if tag else "", **kw)

        add("ell_spmv_batch", sfx, "ell_spmv.cu", "proxsdp_tpu/ops/linop.py:123",
            lambda f: (f(M.row_cols, M.row_vals, x), f(M.col_rows, M.col_vals, y)),
            kernels.ell_spmv_batch_plain,
            (M.row_cols, M.row_vals, x, M.col_rows, M.col_vals, y),
            (out_pm, out_n), 2 * B * (M.row_vals.numel() + M.col_vals.numel()),
            library=lambda: (torch.sparse.mm(csr_row, xT),
                             torch.sparse.mm(csr_col, yT)))
        # one trial's kernels (off the path: K15b runs the trials)
        for args in (
                ("ls_dual_update_batch", sfx, "ls_dual_update.cu",
                 "proxsdp_tpu/solver.py:452",
                 lambda f: f(y, Mx, Mx_old, o.b, o.h, y_old, sigma, theta, p, m),
                 kernels.ls_dual_update_batch_plain,
                 (y, Mx, Mx_old, o.b, o.h, y_old, sigma, theta), (out_pm, tau),
                 10 * B * (p + m)),
                ("sq_dist_batch", sfx, "ls_dual_update.cu",
                 "proxsdp_tpu/solver.py:459",
                 lambda f: (f(Mty, Mty_old),), kernels.sq_dist_batch_plain,
                 (Mty, Mty_old), (tau,), 3 * B * n)):
            check_entry(torch, kernels, off_path, *args,
                        label=f"{phase}: side {side}",
                        note=" (one trial's kernel: not on the path)")
        linesearch_batch_row(torch, kernels, rows, o, p, m, sfx, dt, dev,
                             np.random.default_rng(11),
                             f"{phase}: side {side}, B = {B}")
        add("residuals_batch", sfx, "residuals.cu", "proxsdp_tpu/solver.py:545",
            lambda f: (f(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old,
                         sigma, o.b, o.h, o.c, p, m),),
            kernels.residuals_batch_plain,
            (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, o.b,
             o.h, o.c),
            (torch.empty(B, 9, dtype=torch.float64, device=dev),),
            B * (10 * n + 10 * (p + m)))
        add("primal_update_batch", sfx, "primal_update_sym.cu",
            "proxsdp_tpu/solver.py:308",
            lambda f: (f(x, Mty, o.c, tau),), kernels.primal_update_batch_plain,
            (x, Mty, o.c, tau), (out_n,), 3 * B * n)
        S = kernels.tri_to_square_plain(x, side)
        # the library column: the same gather (without the scale) by one
        # torch.take on flat indices made beforehand
        take_in, take_out = k10_take_index(torch, kernels, B, side, x.shape[1],
                                           dt, dev)
        add("tri_to_square", sfx, "tri_gather.cu", "proxsdp_tpu/ops/tri.py:39",
            lambda f: (f(x, side),), kernels.tri_to_square_plain,
            (x, *kernels._tri_maps(side, dt, dev)[:2]), (S,), B * side * side,
            library=lambda: torch.take(x, take_in))
        add("square_to_tri", sfx, "tri_gather.cu", "proxsdp_tpu/ops/tri.py:47",
            lambda f: (f(S, side),), kernels.square_to_tri_plain,
            (S, *kernels._tri_maps(side, dt, dev)[2:]), (x[:, :tl],), B * tl,
            library=lambda: torch.take(S, take_out))
    return rows, off_path


# K12 against its plain version on the card: f64 sums in other orders and
# Jacobi for LAPACK's k x k eigh; f32 and the mixed mode (an f32 basis)
# to f32 rounding of the Ritz vectors; held relative to the largest entry
SUB_RTOL = {"f64": 1e-10, "f32": 1e-4, "f64_f32": 1e-4}
# the mixed mode's f64 Rayleigh quotients, on bases that span the top
# eigenvectors (the polish after an exact reseed): quotients of two f32
# bases agree to second order in their rounding (the JAX step against the
# plain version ~1e-10), while Ritz values of an f32 eigh lie 5.4e-6 and
# 1.1e-5 away at k = 16 (the f32 mode, run as the control that must fail);
# K12 lies 7.3e-9, 4.8e-9 and 2.09e-8 of the scale from the plain version
# at G's three shapes, with the k x k Jacobi's global stop and with its
# per-pair relative stop alike (on an H100, PERF.md), so the bound is set
# just above those readings
SUB_THETA_RTOL = 3e-8
# phase G's K12 shapes (B, side, k): G1's, then G2's before and after its
# bucket escalation
SUB_SHAPES = ((256, 40, 16), (64, 100, 16), (64, 100, 24))


def subspace_inputs(torch, rng, B, side, k, dt, dev, converged=False):
    """B packed scaled triangles of matrices with six clear positive
    eigenvalues (as phase G's iterates have a handful), orthonormal (side,
    k) bases -- random, or with ``converged`` spanning the k top
    eigenvectors, rotated at random; instance 1 has a NaN entry, instance
    2 is exactly 0."""
    from proxsdp_tpu_torch import kernels

    Q, _ = np.linalg.qr(rng.standard_normal((B, side, side)))
    w = rng.standard_normal((B, side))
    w[:, :6] = 5.0 + 3.0 * rng.random((B, 6))
    X = np.einsum("bik,bk,bjk->bij", Q, w, Q)
    X[2] = 0.0
    V, _ = np.linalg.qr(rng.standard_normal((B, side, k)))
    if converged:
        top = np.argsort(-w, axis=1)[:, :k]
        V = np.take_along_axis(Q, top[:, None, :], axis=2) @ np.linalg.qr(
            rng.standard_normal((B, k, k)))[0]
    v = kernels.square_to_tri_plain(torch.tensor(X), side)
    v[1, 3] = float("nan")
    return v.to(dt).to(dev), torch.tensor(V, dtype=dt, device=dev)


def theta_err(torch, got, want, side, scale):
    """The largest difference, relative to ``scale``, between two K12
    outputs' Ritz values -- theta_j of each positive pair recovered from
    the blocks and the basis as w_j^T Xp w_j / |w_j|^4 (exact to second
    order in W's rounding), min_eig and stats' min theta -- over the
    instances the guard passed."""
    from proxsdp_tpu_torch import kernels

    def thetas(out):
        blk, me, _, warm, _, stats = out
        W = warm.double()
        Xp = kernels.tri_to_square_plain(blk.double(), side)
        th = torch.einsum("bik,bij,bjk->bk", W, Xp, W) / torch.sum(W * W, 1) ** 2
        return th, me.double(), stats[:, 1].double()

    ok = ~want[4]
    return max(float((a[ok] - b[ok]).abs().max())
               for a, b in zip(thetas(got), thetas(want))) / scale


def subspace_compare(torch, v, V, side, tol, theta=None,
                     theta_tol=SUB_THETA_RTOL, vec_tol=None, sep=1e-3):
    """K12's outputs (blocks, min_eig, rank, warm, bad, stats) against the
    plain version's: the guard flags equal (instance 1 alone), the guarded
    instance's basis back unchanged; blocks, min eigenvalue and the Ritz
    stats to ``tol`` of the largest entry; ranks and positive counts
    equal; the bases up to column sign where the Ritz value is simple
    (``sep`` of the scale from its neighbours) to ``vec_tol`` (default
    ``tol``).
    With a dict ``theta`` (the mixed mode) also the Ritz values to
    SUB_THETA_RTOL (``theta_err``, recorded there under "kernel").
    Returns (max abs error of the blocks, relative)."""
    from proxsdp_tpu_torch import kernels

    def fn(got, want):
        blk, me, rank, warm, bad, stats = got
        pblk, pme, prank, pwarm, pbad, pstats = want
        scale = float(v[torch.isfinite(v)].abs().max())
        check(torch.equal(bad, pbad) and bad.tolist()[:3] == [False, True, False]
              and int(bad.sum()) == 1, "batched_subspace: guard flags")
        check(torch.equal(warm[bad], V[bad]), "batched_subspace: guarded basis")
        check(torch.equal(torch.isnan(blk), torch.isnan(pblk)),
              "batched_subspace: NaN outside the guarded instance")
        ok = ~bad
        fin = torch.isfinite(pblk)
        err = max(float((blk[fin] - pblk[fin]).abs().max()),
                  float((me[ok] - pme[ok]).abs().max()),
                  float((stats[ok, :2] - pstats[ok, :2]).abs().max()))
        check(torch.equal(rank, prank) and torch.equal(stats[:, 2], pstats[:, 2]),
              "batched_subspace: ranks differ")
        X = kernels.tri_to_square_plain(torch.nan_to_num(v), side).double()
        W = pwarm.double()
        th = torch.einsum("bik,bij,bjk->bk", W, X, W)
        inf = th.new_full((th.shape[0], 1), float("inf"))
        d = torch.diff(th, dim=1).abs()
        simple = torch.minimum(torch.cat([d, inf], 1), torch.cat([inf, d], 1)) \
            > sep * scale
        dots = torch.sum(warm.double() * W, dim=1).abs()
        sel = simple & ok[:, None]
        apart = float((1 - dots[sel]).abs().max()) if bool(sel.any()) else 0.0
        vtol = max(tol, 1e-8) if vec_tol is None else vec_tol
        check(apart <= vtol, f"batched_subspace: Ritz vectors differ: "
              f"1 - |cos| up to {apart:.3e} (> {vtol:.0e})")
        if theta is not None:
            theta["kernel"] = theta_err(torch, got, want, side, scale)
            theta["exact"] = (theta_exact_err(torch, got, v, side, scale),
                              theta_exact_err(torch, want, v, side, scale))
            check(theta["kernel"] <= theta_tol,
                  f"batched_subspace (mixed): Ritz values {theta['kernel']:.3e}"
                  f" of the scale from the plain version's (> {theta_tol}); "
                  f"from the exact eigenvalues: kernel {theta['exact'][0]:.3e}"
                  f", plain {theta['exact'][1]:.3e}")
        return err, err / scale

    return fn


def subspace_kernel_checks(torch, kernels, rng, dev):
    """K12 against its plain version at phase G's shapes in f32 (phase G's
    race), the mixed mode and f64 (checked here, off phase G's path: its
    f64 phase runs the eigh program after the drop), timed beside the
    library route (torch.linalg.qr, torch.bmm, torch.linalg.eigh of the
    Rayleigh matrix, the reconstruction); (rows of the kernels line,
    off-path rows)."""
    rows, off_path = [], []
    for B, side, k in SUB_SHAPES:
        tl = side * (side + 1) // 2
        for sfx in ("f32", "f64_f32", "f64"):
            dt = torch.float32 if sfx == "f32" else torch.float64
            mixed = sfx == "f64_f32"
            # the mixed mode on converged bases, where its f64 quotients
            # are held to SUB_THETA_RTOL
            v, V = subspace_inputs(torch, rng, B, side, k, dt, dev,
                                   converged=mixed)
            theta = {} if mixed else None
            Xs = torch.nan_to_num(kernels.tri_to_square_plain(v, side))

            def library(Xs=Xs, V=V):
                Q = torch.linalg.qr(torch.bmm(Xs, V)).Q
                th, U = torch.linalg.eigh(torch.bmm(Q.mT, torch.bmm(Xs, Q)))
                W = torch.bmm(Q, U)
                return torch.bmm(W * th.clamp_min(0)[:, None, :], W.mT)

            outs = (torch.empty(B, tl, dtype=dt, device=dev),
                    torch.empty_like(V),
                    torch.empty(B, 5, dtype=dt, device=dev))
            # the function's work (cones.py:427-510): X V and X Q, the
            # reconstruction, CholeskyQR twice, the rotations, Jacobi
            flops = B * (6 * side * side * k + 14 * side * k * k + 10 * k ** 3)
            on = sfx == "f32"
            check_entry(
                torch, kernels, rows if on else off_path, "batched_subspace",
                sfx, "batched_subspace.cu", "proxsdp_tpu/ops/cones.py:427",
                lambda f, v=v, V=V, m=mixed: f(v, V, side, TOL_PSD, m),
                kernels.batched_subspace_plain, (v, V), outs, flops,
                library=library,
                compare_fn=subspace_compare(torch, v, V, side, SUB_RTOL[sfx],
                                            theta),
                tol=SUB_RTOL[sfx], label=f"G: B = {B}, side {side}, k = {k}",
                note="" if on else " (off phase G's path)")
            if mixed:
                # the control: Ritz values and XW worked out in f32 (the f32
                # mode on the same inputs) must fail the mixed mode's check
                want = kernels.batched_subspace_plain(v, V, side, TOL_PSD, True)
                ctl = kernels.batched_subspace_plain(v.float(), V.float(), side,
                                                     TOL_PSD, False)
                scale = float(v[torch.isfinite(v)].abs().max())
                ctl_err = theta_err(torch, ctl, want, side, scale)
                print(f"kernel batched_subspace_f64_f32 (G: B = {B}, side {side},"
                      f" k = {k}) Ritz values on converged bases: kernel "
                      f"{theta['kernel']:.3e}, f32-quotient control {ctl_err:.3e}"
                      f" of the scale (tol {SUB_THETA_RTOL:.0e}; the control "
                      "must exceed it)")
                check(ctl_err > SUB_THETA_RTOL,
                      "batched_subspace (mixed): the f32-quotient control "
                      "passes the mixed mode's Ritz-value check")
    return rows, off_path


# the batch path's CUDA functions as the profiler names them (K10's two
# directions are one function)
BATCH_DEVICE_FNS = {
    "ell_spmv_batch": "ell_spmv_batch_kernel",
    "linesearch_loop_batch": "ls_loop_batch_kernel",
    "residuals_batch": "residuals_batch_",
    "primal_update_batch": "primal_update_batch_kernel",
    "batched_psd_eigh": "batched_psd_eigh_kernel",
    "tri_gather": "gather_scale_kernel",
    "batched_subspace": "batched_subspace_kernel",
    "batched_psd_eigh_large": "batched_psd_eigh_large_kernel",
    "soc_projection_batch": "soc_proj_batch_kernel",
    "coo_spmv_batch": "seg_spmv_batch_kernel",
}


PROFILE_STEPS = 16  # a profiled window's steps


def profile_steps(torch, kernels, setups, opts, steps=PROFILE_STEPS, sub_k=0):
    """``steps`` iterations of the batch program of ``opts`` on the setups
    (after 8 warm-up ones; the subspace program at bucket ``sub_k`` when it
    is not 0) under torch.profiler: (CUDA kernels per
    iteration, the port's kernel launches per iteration, device-busy
    share of the window, ms per iteration, device µs per launch of each
    function of BATCH_DEVICE_FNS).  None where the profiler shows no
    device events."""
    from torch.profiler import ProfilerActivity, profile

    from proxsdp_tpu_torch.parallel import batch as tbatch

    dev = torch.device("cuda")
    opts = tbatch._force_batch_options(opts)
    if sub_k:  # the subspace program at bucket sub_k
        opts = opts.replace(subspace_rank=sub_k, subspace_accept_always=True)
    dt = torch.float32 if opts.dtype == "float32" else torch.float64
    layout = setups[0].layout
    o = tbatch._batch_operands(setups, dt, dev, opts.linop)
    st = tbatch._stack_states(layout, opts, setups, dev)
    stats = tbatch.BatchStats()
    run = tbatch.make_batch_runner(layout, opts, device=dev, stats=stats)[0]
    st = run(st, o, 8)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    steps0 = stats.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = run(st, o, 8 + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    done = stats.steps - steps0
    ours = sum(kernels.launch_counts.values()) / max(done, 1)
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        return None, ours, None, wall * 1e3 / max(done, 1), None

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    n_kernels = sum(e.count for e in dev_events)
    busy_us = sum(dev_us(e) for e in dev_events)
    per_launch = {}
    for name, fn in BATCH_DEVICE_FNS.items():
        hits = [e for e in dev_events if fn in e.key]
        count = sum(e.count for e in hits)
        if count:
            per_launch[name] = sum(dev_us(e) for e in hits) / count
    return (n_kernels / max(done, 1), ours, busy_us * 1e-6 / wall,
            wall * 1e3 / max(done, 1), per_launch)


def phase_d(torch, kernels, smi, problems, setups, brows, recorder=None):
    """One solve_batch run of the BATCH_SIZE side-16 max-cut instances at
    Options(tol_gap=1e-4, tol_feasibility=1e-4), timed, with the launch
    counts set to 0 just before it and read just after (no warm-up
    repeat: the run keeps within its time).  Checks every status,
    the feasibility and PSD bounds per instance and the objectives of
    instances 0-15; fills the launches of the batch rows."""
    from proxsdp_tpu_torch import Options, solve_batch
    from proxsdp_tpu_torch.parallel import batch as tbatch

    probs = [p for p, _ in problems]
    Xidx = problems[0][1]
    opts = Options(tol_gap=1e-4, tol_feasibility=1e-4)
    kernels.reset_launch_counts()
    stats = tbatch.BatchStats()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        res = solve_batch(probs, opts, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entries = dict(kernels.launch_counts)
    B = len(res)
    status = np.array([r.status for r in res])
    iters = np.array([r.iter for r in res])
    X = np.stack([r.primal[Xidx] for r in res])
    diag_err = np.abs(np.diagonal(X, axis1=1, axis2=2) - 1.0).max(axis=1)
    diag_tol = np.array([1e-4 * (1.0 + s.norm_b) * s.rhs_scale for s in setups])
    lam_min = np.linalg.eigvalsh(X)[:, 0]
    fro = np.linalg.norm(X, axis=(1, 2))
    obj = np.array([r.objval for r in res[: len(BATCH_HYB_REF_OBJ)]])
    ref = np.array(BATCH_HYB_REF_OBJ)
    obj_dev = np.abs(obj - ref) / (1.0 + np.abs(ref))
    f64_dev = np.abs(obj - BATCH_REF_OBJ) / (1.0 + np.abs(BATCH_REF_OBJ))
    print(f"phase D (solve_batch, B = {B}, side {BATCH_SIDE}, Options(tol_gap="
          f"1e-4, tol_feasibility=1e-4)) on {smi}: solve {wall:.3f} s, "
          f"{B / wall:.1f} instances/s; "
          f"statuses {dict(zip(*np.unique(status, return_counts=True)))}; "
          f"iterations min/median/max {iters.min()}/{int(np.median(iters))}/"
          f"{iters.max()}; f32 race {stats.race_iters} iterations "
          f"({stats.race_seconds:.3f} s), program steps {stats.steps}, final "
          f"phase {stats.final_seconds:.3f} s")
    print(f"phase D checks: max|diag(X)-1| worst {diag_err.max():.3e} "
          f"(its bound {diag_tol[diag_err.argmax()]:.3e}), min over instances "
          f"of lambda_min(X)/||X||_F {float((lam_min / fro).min()):.3e}, "
          f"objective of instances 0-{len(ref) - 1} vs the JAX batch solve "
          f"(same Options()): max |diff|/(1+|ref|) {obj_dev.max():.3e} (bound "
          f"2e-4), mean {obj_dev.mean():.3e}; vs the JAX "
          f"f64 solve {f64_dev.max():.3e} (instances "
          f"{np.nonzero(f64_dev > 2e-4)[0].tolist()} above 2e-4; the JAX "
          "package's own modes differ by up to 1.14e-3 there)")
    print("phase D launches: " + json.dumps(
        {e: n for e, n in entries.items() if n}))
    print(f"phase D: the port's kernel launches per program step "
          f"{sum(entries.values()) / max(stats.steps, 1):.2f}")
    for label, dtype in (("f32 race", "float32"), ("f64", "float64")):
        per_step, ours, busy, ms, per_launch = profile_steps(
            torch, kernels, setups, Options(dtype=dtype, hybrid_precision=False,
                                            tol_gap=1e-4, tol_feasibility=1e-4))
        print(f"phase D profile ({label} program, {PROFILE_STEPS} "
              f"iterations of all "
              f"{B} instances): {ms:.3f} ms/iteration, CUDA kernels per "
              f"iteration {'not measured' if per_step is None else f'{per_step:.1f}'}"
              f" (the port's own {ours:.1f}), device busy "
              f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}; "
              "device us per launch "
              + ("not measured" if per_launch is None
                 else json.dumps(per_launch)))
    check((status == 1).all(), "D: not every instance reached status 1")
    check((diag_err <= diag_tol).all(),
          f"D: max|diag(X)-1| above the bound for "
          f"{int((diag_err > diag_tol).sum())} instances")
    check((lam_min >= -1e-6 * fro).all(),
          f"D: lambda_min(X) < -1e-6 ||X||_F for "
          f"{int((lam_min < -1e-6 * fro).sum())} instances")
    check((obj_dev <= 2e-4).all(),
          f"D: objectives of instances {np.nonzero(obj_dev > 2e-4)[0].tolist()}"
          " differ from the JAX batch solve by more than 2e-4 (1 + |obj|)")
    for row in brows:
        row["launches"] = entries[row["name"].split(" ")[0]]
        check(row["launches"] > 0, f"{row['name']} launched no kernel in D")
    for name in ("control_batch", "restart_average_batch",
                 "restart_adopt_batch", "freeze_rows"):
        check(sum(n for e, n in entries.items()
                  if e.rsplit("_", 1)[0] == name) > 0,
              f"D: {name} launched no kernel")
    print(f"phase D: K19's batch entry point {entries['control_batch_f32']} "
          f"f32 / {entries['control_batch_f64']} f64 launches in "
          f"{stats.steps} program steps")
    return entries


# ---------------------------------------------------------------------------
# Sides above full_eig_max_side: K11 and the side-2000 shapes (phase B),
# the default solve at side 2000 (phase E), the f64 Lanczos program (F)
# ---------------------------------------------------------------------------

LZ_SIDES = (1100, 2000, 5000)
LZ_INPUTS = ("random", "lowrank", "rank10", "v0_zero", "nan")
# K11 against its plain version on the card: the 16 leading Ritz values
# (those the residual test judges) within LZ_VAL_TOL of the largest
# |value|, their vectors up to sign where the value is simple, the residual
# test's decisions and ranks equal; in f64 alphas, betas and every Ritz
# value within 1e-8 ||X||_F (reordered sums move late Lanczos vectors by
# about eps over the gap between neighbouring Ritz values)
LZ_VAL_TOL = {"f64": 1e-10, "f32": 1e-4}
LZ_VEC_TOL = {"f64": 1e-8, "f32": 1e-3}
K_MAX = 16  # max_target_rank_krylov_eigs


def lanczos_input(torch, n, kind, dt, dev):
    """(X, v0, tol) of one K11 input: random symmetric, rank 8 plus noise
    1e-3 (its leading pairs converge), exactly rank 10 (beta breaks down
    and the restart vector runs; in f32 at tol 1e-7, a breakdown threshold
    above f32 rounding), v0 = 0 (the e0 start), one NaN entry."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    A = 0.5 * (A + A.T)
    v0 = rng.standard_normal(n)
    tol = 1e-12
    if kind == "lowrank":
        Q, _ = np.linalg.qr(rng.standard_normal((n, 8)))
        A = (Q * np.linspace(50.0, 10.0, 8)) @ Q.T + 1e-3 * A
    elif kind == "rank10":
        Q, _ = np.linalg.qr(rng.standard_normal((n, 10)))
        A = (Q * np.arange(1.0, 11.0)) @ Q.T
        tol = 1e-7 if dt == torch.float32 else tol
    elif kind == "v0_zero":
        v0 = np.zeros(n)
    elif kind == "nan":
        A[3, 5] = A[5, 3] = np.nan
    return (torch.tensor(A, dtype=dt, device=dev),
            torch.tensor(v0, dtype=dt, device=dev), tol)


def residual_test(torch, r, tr, tol):
    """(conv_ok, positive pairs, the largest residual / threshold ratio)
    of the Lanczos branch's test on the tr leading Ritz pairs."""
    v, res = r.vals[:tr], r.resid[:tr]
    thresh = torch.clamp_min(tol * v.abs(), 10 * tol)
    return (bool(torch.all(res <= thresh)), int((v > 0).sum()),
            float(torch.amax(res / thresh)))


def lanczos_compare(torch, kernels, X, sfx, tol, errs):
    """compare_fn of a K11 row: (alphas, betas, V) of the kernel and of the
    plain version, each through ops.lanczos.ritz_pairs (K5 for the
    kernel's, its plain twin for the plain one's).  Records the errors in
    ``errs``; returns (max abs error of the leading Ritz values, relative
    to the largest |value|)."""
    from proxsdp_tpu_torch.ops.lanczos import ritz_pairs

    def fn(got, want):
        g = ritz_pairs(*got)
        w = ritz_pairs(*want, gemm=kernels.ns_gemm_plain)
        if not torch.isfinite(X).all():
            nan = all(bool(torch.isnan(t).all())
                      for t in (*got[:2], got[2][1:], *g))
            check(nan, "lanczos_krylov: a NaN input gave finite outputs")
            check(not residual_test(torch, g, 2, tol)[0],
                  "lanczos_krylov: NaN accepted")
            errs.append(("nan", 0.0, 0.0, 0.0))
            return 0.0, 0.0
        k = min(K_MAX, g.vals.shape[0])
        scale = float(w.vals.abs().max())
        err = float((g.vals[:k] - w.vals[:k]).abs().max())
        for tr in (2, 8, K_MAX):
            dg, dw = residual_test(torch, g, tr, tol), residual_test(torch, w, tr, tol)
            check(dg[:2] == dw[:2], f"lanczos_krylov_{sfx}: residual test at "
                  f"target rank {tr}: {dg} vs plain {dw}")
        gaps = (w.vals[:-1] - w.vals[1:]).abs()
        vec_err = 0.0
        for i in range(k):
            near = min(float(gaps[i - 1]) if i else np.inf,
                       float(gaps[i]) if i < len(gaps) else np.inf)
            if near > 1e-3 * scale:
                cos = float((g.vecs[:, i] @ w.vecs[:, i]).abs()
                            / (g.vecs[:, i].norm() * w.vecs[:, i].norm()))
                vec_err = max(vec_err, 1.0 - cos)
        check(vec_err <= LZ_VEC_TOL[sfx],
              f"lanczos_krylov_{sfx}: Ritz vectors differ by {vec_err:.3e}")
        ab = float(max((got[0] - want[0]).abs().max(),
                       (got[1] - want[1]).abs().max()))
        interior = float((g.vals - w.vals).abs().max())
        fro = float(torch.linalg.norm(X))
        if sfx == "f64":
            check(max(ab, interior) <= 1e-8 * fro,
                  f"lanczos_krylov_f64: alphas/betas {ab:.3e}, Ritz values "
                  f"{interior:.3e} > 1e-8 ||X||_F = {1e-8 * fro:.3e}")
        errs.append((err / scale, vec_err, ab / fro, interior / fro))
        return err, err / scale

    return fn


# (row label, call, CUDA function name[, True: the time a call of all
# the functions matched]) of the rows whose device time a launch main()
# reads under the profiler after the phases
LAUNCH_US: list = []
# rows of one linesearch trial's kernels (K2, sq_dist): checked against
# their plain versions; they run only on the tensor-parallel path (phase
# O), K15 and K15b running the trials elsewhere
TRIAL_ROWS: list = []


def device_us(torch, fn, name, calls=3, per_call=False):
    """Device µs per launch of the CUDA functions whose names contain
    ``name``, over ``calls`` calls of fn under torch.profiler (None where
    the profiler shows no device events); ``per_call``: their device time
    a call of fn, one launch of ours that may run several of them (K7: G,
    the factor and the solve, or the one small-pass kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # CPU and CUDA activities, as profile_steps: a CUDA-only profile
    # recorded no device event in about half of the late profiles of a run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
    count = sum(e.count for e in hits)
    if not count:
        return None
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in hits) / (calls if per_call else count)


def print_launch_us(torch) -> None:
    """Each LAUNCH_US row's device µs a launch, under the profiler."""
    for label, fn, pattern, *per_call in LAUNCH_US:
        us = device_us(torch, fn, pattern, calls=10, per_call=bool(per_call))
        print(f"kernel {label}: device "
              f"{'not measured' if us is None else f'{us:.1f} us'} a launch")


def giant_kernel_checks(torch, kernels, rng, dev):
    """Phase B rows above full_eig_max_side: K11 at n = 1100, 2000, 5000
    (ncv 34, 62, 156) in f64 and f32 on the five inputs (timed on the
    random one); K5-K8 at the side-2000 default path's shapes and the
    f64 Lanczos program's (K7 at k = 32, 128, 192, 256 in both types, K5
    on square products, the reseed's column slices at each bucket and the
    Ritz rotation, K6 in every type pair, K8 at the race's and the
    polish's buckets)."""
    from proxsdp_tpu_torch import Options
    from proxsdp_tpu_torch.ops.cones import POLAR_QA, lanczos_ncv

    rows = []
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    for n in LZ_SIDES:
        ncv = lanczos_ncv(n, Options())
        for sfx, dt in dtypes.items():
            errs = []
            for kind in LZ_INPUTS:
                X, v0, tol = lanczos_input(torch, n, kind, dt, dev)
                call = lambda f, X=X, v0=v0, tol=tol: f(X, v0, ncv, tol)
                cmp = lanczos_compare(torch, kernels, X, sfx, tol, errs)
                if kind != "random":
                    kernels.reset_launch_counts()
                    got = call(kernels.lanczos_krylov)
                    torch.cuda.synchronize()
                    check(kernels.launch_counts[f"lanczos_krylov_{sfx}"] == 1,
                          "lanczos_krylov: not one launch")
                    cmp(got, call(kernels.lanczos_krylov_plain))
                    continue
                size = X.element_size()
                # the products X q, and the two Gram-Schmidt passes over
                # the rows written so far (4 n i flops at step i)
                flops = 2 * n * n * ncv + 4 * n * ncv * ncv
                note = (f" [n={n} ncv={ncv}; X read ncv times "
                        f"{ncv * n * n * size / PEAK_BYTES * 1e6:.1f} us from "
                        f"HBM; device "
                        f"{device_us(torch, lambda: call(kernels.lanczos_krylov), 'lanczos_kernel'):.1f}"
                        f" us/launch]")
                check_entry(
                    torch, kernels, rows, "lanczos_krylov", sfx, "lanczos.cu",
                    "proxsdp_tpu/ops/lanczos.py:38", call,
                    kernels.lanczos_krylov_plain, (X, v0),
                    (torch.empty((ncv, n), dtype=dt, device=dev),
                     torch.empty(2 * ncv, dtype=dt, device=dev)), flops,
                    library=lambda X=X: torch.linalg.eigh(X), compare_fn=cmp,
                    tol=LZ_VAL_TOL[sfx], label=f"n={n}", note=note)
            print(f"kernel lanczos_krylov_{sfx} n={n} ncv={ncv} errors by input "
                  f"{list(LZ_INPUTS)}: leading Ritz values "
                  f"(rel. largest |value|), Ritz vectors (1 - |cos|), "
                  f"alphas/betas and all Ritz values (rel. ||X||_F): "
                  + "; ".join(f"{e[0]:.2e} {e[1]:.2e} {e[2]:.2e} {e[3]:.2e}"
                              if isinstance(e[0], float) else "nan ok"
                              for e in errs))
    # K5-K8 at the side-2000 shapes.  The subspace buckets: the JAX race
    # enters at 192, the port's at 128 or 192 (the observed rank is
    # rounding-sensitive there); the polish and the watchdog escalate one
    # bucket at a time; the polish runs at 32
    side = LZ_SIDE
    f32, f64 = torch.float32, torch.float64
    Xs = torch.tensor(rng.standard_normal((side, side)), dtype=f64,
                      device=dev)
    for sfx, dt in dtypes.items():
        for k in (32, 128, 192, 256):
            Yk = torch.matmul(Xs.to(dt), torch.tensor(
                rng.standard_normal((side, k)), dtype=dt, device=dev))
            check_entry(
                torch, kernels, rows, "cholqr", sfx, "cholqr.cu",
                "proxsdp_tpu/ops/cones.py:247",
                lambda f, Yk=Yk, dt=dt: (f(Yk, kernels.CHOLQR_EPS[dt]),),
                kernels.cholqr_plain, (Yk,), (Yk, torch.empty_like(Yk)),
                # G = Y^T Y (symmetric), its Cholesky, the solve Y L^-T
                2 * side * k * k + k ** 3 // 3, label=f"side {side} k={k}",
                library=lambda Yk=Yk: torch.linalg.qr(Yk))
            if k in (128, 256):
                LAUNCH_US.append((f"cholqr_{sfx} (side {side}, k={k})",
                                  lambda Yk=Yk: kernels.cholqr(Yk), "cholqr_",
                                  True))
        # K5: one Newton-Schulz product at side 2000 (the f32 race's polar
        # projection and reseeds; the f64 program's polar fallback)
        Y = (Xs / torch.linalg.norm(Xs)).to(dt)
        A = torch.matmul(Y, Y)
        check_entry(
            torch, kernels, rows, "ns_gemm", sfx, "ns_gemm.cu",
            "proxsdp_tpu/ops/cones.py:90",
            lambda f, Y=Y, A=A: (f(Y, A, Y, POLAR_QA, 1.0),),
            kernels.ns_gemm_plain, (Y, A), (A,), 2 * side ** 3 + 3 * side ** 2,
            library=lambda Y=Y, A=A: torch.addmm(Y, Y, A, beta=POLAR_QA),
            label=f"side {side}")
        LAUNCH_US.append((f"ns_gemm_{sfx} (side {side}, QA Y + Y A)",
                          lambda Y=Y, A=A: kernels.ns_gemm(Y, A, Y, POLAR_QA, 1.0),
                          "gemm_axpby_kernel"))
    # a side-2000 matrix with 90 positive eigenvalues (the rank the port's
    # race observes) and a negative bulk, its Newton-Schulz iterate and
    # sign, and its leading eigenvectors as the subspace basis (as phase
    # B's side-250 rows)
    V, _ = torch.linalg.qr(torch.tensor(rng.standard_normal((side, side)),
                                        dtype=f64, device=dev))
    w = torch.cat([torch.linspace(40.0, 1.0, 90, dtype=f64, device=dev),
                   -torch.linspace(0.05, 5.0, side - 90, dtype=f64,
                                   device=dev)])
    X64 = torch.matmul(V * w[None, :], V.T)
    X64 = 0.5 * (X64 + X64.T)
    Sg64 = torch.matmul(V * torch.sign(w)[None, :], V.T)
    for sfx, dt in dtypes.items():
        X = X64.to(dt)
        Y, _ = kernels.fro_scale_plain(X, dt)
        S = kernels.sym_plain(Y)
        P = kernels.ns_gemm_plain(S, X, X, 0.5, 0.5)
        mat = torch.empty_like(X)
        # K6 around every polar projection: the f32 race, the f64
        # program's polar fallback
        check_entry(torch, kernels, rows, "fro_scale", sfx, "polar_sym.cu",
                    "proxsdp_tpu/ops/cones.py:85",
                    lambda f, X=X, dt=dt: f(X, dt),
                    kernels.fro_scale_plain, (X,),
                    (mat,), 3 * side * side, label=f"side {side}")
        check_entry(torch, kernels, rows, "sym", sfx, "polar_sym.cu",
                    "proxsdp_tpu/ops/cones.py:94", lambda f, Y=Y: (f(Y),),
                    kernels.sym_plain, (Y,), (mat,), 2 * side * side,
                    label=f"side {side}")
        check_entry(torch, kernels, rows, "sym_guard", sfx, "polar_sym.cu",
                    "proxsdp_tpu/ops/cones.py:96",
                    lambda f, P=P, S=S, X=X: f(P, S, X),
                    kernels.sym_guard_plain,
                    (P, torch.diagonal(S).contiguous()), (mat,),
                    3 * side * side, label=f"side {side}")
        # polar_reseed's P+ on the leading k - 1 columns of a bucket-k
        # basis and P- on the last (strided column slices).  One P- row, as
        # its shape is the same at every bucket, at k = 128, whose last
        # column is not in the positive span (there P- gives 0)
        Sg = Sg64.to(dt)
        for k in ((32, 128, 192, 256) if sfx == "f32" else ()):
            wb = V[:, :k].to(dt).contiguous()  # row-major, as the basis
            for label, cols, sign, line in (
                    ("P+ warm", slice(None, -1), 0.5, 296),
                    ("P- last", slice(-1, None), -0.5, 297))[:2 if k == 128 else 1]:
                Wc = wb[:, cols]
                kc = Wc.shape[1]
                check_entry(
                    torch, kernels, rows, "ns_gemm", sfx, "ns_gemm.cu",
                    f"proxsdp_tpu/ops/cones.py:{line}",
                    lambda f, Sg=Sg, Wc=Wc, sign=sign: (
                        f(Sg, Wc, Wc, 0.5, sign),),
                    kernels.ns_gemm_plain, (Sg, Wc),
                    (torch.empty(side, kc, dtype=dt, device=dev),),
                    2 * side * side * kc + 3 * side * kc,
                    library=lambda Sg=Sg, Wc=Wc, sign=sign: torch.addmm(
                        Wc, Sg, Wc, beta=0.5, alpha=sign),
                    label=f"{label}, side {side} k={k}, strided")
    # the mixed polish's f32-compute polar reseed (from side 384)
    X32 = X64.float()
    Y, _ = kernels.fro_scale_plain(X32, f32)
    S = kernels.sym_plain(Y)
    P = kernels.ns_gemm_plain(S, X32, X32, 0.5, 0.5)
    mat = torch.empty_like(X32)
    check_entry(torch, kernels, rows, "fro_scale", "f64_f32", "polar_sym.cu",
                "proxsdp_tpu/ops/cones.py:281", lambda f: f(X64, f32),
                kernels.fro_scale_plain, (X64,), (mat, torch.empty_like(mat)),
                3 * side * side, label=f"side {side}")
    check_entry(torch, kernels, rows, "sym_guard", "f32_f64", "polar_sym.cu",
                "proxsdp_tpu/ops/cones.py:303", lambda f: f(P, S, X64),
                kernels.sym_guard_plain, (P, torch.diagonal(S).contiguous()),
                (X64,), 3 * side * side, tol=RTOL["f32"],
                label=f"side {side}")
    # K8: the race's f32 test at its buckets, the polish's f64 test at 32
    for sfx, k, dt in (("f32", 128, f32), ("f32", 192, f32), ("f32", 256, f32),
                       ("f64", 32, f64)):
        Wk = V[:, :k].to(dt).contiguous()
        XW = torch.matmul(X64.to(dt), Wk)
        th = w[:k].to(dt) if sfx == "f32" else None
        at = torch.tensor(1e-4, dtype=dt, device=dev)
        tol = 1e-9 if sfx == "f32" else 4e-6

        def exact_flags(g, wnt, sfx=sfx):
            check(torch.equal(g[2].cpu(), wnt[2].cpu()),
                  f"ritz_accept_{sfx}: flags {g[2].tolist()} vs {wnt[2].tolist()}")
            return compare(torch, g[:2], wnt[:2])

        check_entry(
            torch, kernels, rows, "ritz_accept", sfx, "ritz_accept.cu",
            "proxsdp_tpu/ops/cones.py:443",
            lambda f, Wk=Wk, XW=XW, th=th, at=at, tol=tol: f(
                Wk, XW, th, at, tol, 1e-7, False),
            kernels.ritz_accept_plain, (Wk, XW, th, at),
            (torch.empty(k + 3, dtype=dt, device=dev),), 8 * side * k,
            compare_fn=exact_flags, label=f"side {side} k={k}")
    # K5: the Ritz rotation of the f64 Lanczos projection, (V^T S)^T =
    # S^T V with S (ncv, ncv) and V (ncv, n)
    ncv = lanczos_ncv(side, Options())
    St, _ = torch.linalg.qr(torch.tensor(rng.standard_normal((ncv, ncv)),
                                         dtype=f64, device=dev))
    St = St.T.contiguous()
    Vl = torch.tensor(rng.standard_normal((ncv, side)), dtype=f64, device=dev)
    check_entry(
        torch, kernels, rows, "ns_gemm", "f64", "ns_gemm.cu",
        "proxsdp_tpu/ops/lanczos.py:105", lambda f: (f(St, Vl),),
        kernels.ns_gemm_plain, (St, Vl),
        (torch.empty(ncv, side, dtype=f64, device=dev),),
        2 * ncv * ncv * side, library=lambda: torch.matmul(St, Vl),
        label=f"Ritz rotation, n={side} ncv={ncv}")
    return rows


def edge_kernel_checks(torch, kernels, rng, dev):
    """K5 and K7 at the ragged, unaligned and degenerate shapes of their
    designs against the plain versions (RTOL), checked and not timed: K5
    at M, N, K in EDGE_DIMS (every M, N pair, K cycling through them), the
    strided P+ / P- slices of k = 33 and 128 bases, a row slab from an odd
    row, batches of 3 (K5b); K7 at k = 1, 33, 200, at the f64 shared-memory
    edge of its factor and one past it (side 2000), on a zero Y (jitter
    -1) and on a Y with a zero column (no jitter), both NaN everywhere."""
    for sfx, dt in (("f32", torch.float32), ("f64", torch.float64)):
        def mat(*shape, dt=dt):
            return torch.tensor(rng.standard_normal(shape), dtype=dt,
                                device=dev)

        worst = {"ns_gemm": 0.0, "cholqr": 0.0}
        count = {"ns_gemm": 0, "cholqr": 0}

        def one(name, args, label, kind):
            kernels.reset_launch_counts()
            got = getattr(kernels, name)(*args)
            torch.cuda.synchronize()
            check(kernels.launch_counts[f"{name}_{sfx}"] == 1,
                  f"{name}_{sfx} ({label}): not one launch")
            _, rel = compare(torch, (got,), (getattr(kernels, name + "_plain")(*args),))
            check(rel <= RTOL[sfx], f"{name}_{sfx} ({label}): relative error "
                  f"{rel:.3e} > {RTOL[sfx]}")
            worst[kind] = max(worst[kind], rel)
            count[kind] += 1
            return got

        for i, M in enumerate(EDGE_DIMS):
            for j, N in enumerate(EDGE_DIMS):
                K = EDGE_DIMS[(i + 2 * j) % len(EDGE_DIMS)]
                one("ns_gemm", (mat(M, K), mat(K, N), mat(M, N), -0.75, 1.25),
                    f"{M}x{K}x{N}", "ns_gemm")
        S = mat(SIDE, SIDE)
        for k in (33, 128):
            W = mat(SIDE, k)
            for cols, sign in ((slice(None, -1), 0.5), (slice(-1, None), -0.5)):
                Wc = W[:, cols]
                one("ns_gemm", (S, Wc, Wc, 0.5, sign), f"k={k} slice", "ns_gemm")
        one("ns_gemm", (S[125:], S, S[125:], 0.5, 0.5), "rows 125-250",
            "ns_gemm")
        Xb, Zb = mat(3, SIDE, SIDE), mat(3, SIDE, SIDE)
        for args in ((Xb, Zb, Xb, 0.5, -1.5), (Xb, Zb),
                     (mat(3, 33, 31), mat(3, 31, 127))):
            one("ns_gemm_batch", args, "B = 3", "ns_gemm")
        edge = max(k for k in range(1, kernels.CHOLQR_MAX_K + 1)
                   if kernels.cholqr_shared_columns(k, dt) == 0)
        shapes = [(SIDE, 1), (SIDE, 33), (LZ_SIDE, 200)]
        if edge < kernels.CHOLQR_MAX_K:
            shapes += [(LZ_SIDE, edge), (LZ_SIDE, edge + 1)]
        X = mat(LZ_SIDE, LZ_SIDE)
        for side, k in shapes:
            Y = torch.matmul(X[:side, :side], mat(side, k))
            one("cholqr", (Y, kernels.CHOLQR_EPS[dt]), f"side {side} k={k}",
                "cholqr")
        Yz = torch.zeros(SIDE, 24, dtype=dt, device=dev)
        Yc = mat(SIDE, 24)
        Yc[:, 5] = 0.0
        for label, Y, eps in (("zero Y", Yz, -1.0), ("zero column", Yc, 0.0)):
            Q = one("cholqr", (Y, eps), label, "cholqr")
            check(bool(torch.isnan(Q).all()), f"cholqr_{sfx} ({label}): "
                  "Q not NaN everywhere")
        print(f"kernel ns_gemm_{sfx} edges: {count['ns_gemm']} products (M, N, "
              f"K in {EDGE_DIMS}, strided slices, a row slab, B = 3) max rel "
              f"err {worst['ns_gemm']:.3e} (tol {RTOL[sfx]:.2g}); not timed")
        print(f"kernel cholqr_{sfx} edges: {count['cholqr']} passes (side, k "
              f"{shapes}; shared-memory edge k = {edge}; zero Y and zero "
              f"column NaN everywhere) max rel err {worst['cholqr']:.3e} "
              f"(tol {RTOL[sfx]:.2g}); not timed")


class HostTimer:
    """Accumulated seconds in module functions, wrapped for one block."""

    def __init__(self, targets):
        self.targets = targets  # [(module, name)]
        self.seconds = {name: 0.0 for _, name in targets}
        self.calls = {name: 0 for _, name in targets}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
                    self.calls[_name] += 1

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_e(torch, kernels, smi, W):
    """The default Options(chunk_iters=256) solve of the side-2000 max-cut
    instance, once, with the launch counts set to 0 just before it and read
    just after; checks status, objective, feasibility, PSD; prints the
    phase events, the timers, the host eighs' seconds and a dual bound."""
    from proxsdp_tpu_torch import Options, solve
    from proxsdp_tpu_torch import solver as tsolver
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem
    from proxsdp_tpu_torch.problem import preprocess, to_square_form

    problem, Xidx = maxcut_problem(W)
    setup = to_square_form(preprocess(problem))
    diag_tol = 1e-4 * (1.0 + setup.norm_b) * setup.rhs_scale
    opts = Options(chunk_iters=256, log_verbose=True, timer_verbose=True)
    buf = io.StringIO()
    timer = HostTimer([(tsolver, "preprocess"),
                       (tsolver, "_estimate_subspace"),
                       (tsolver, "_cache_solution")])
    kernels.reset_launch_counts()
    SHAPES.reset()
    t0 = time.perf_counter()
    with timer, contextlib.redirect_stdout(buf):
        res = solve(problem, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entries = dict(kernels.launch_counts)
    shapes = collections.Counter(SHAPES.counts)
    log = buf.getvalue()
    for line in log.splitlines():
        if line.startswith("  [") or "total" in line or "status:" in line or (
                line.startswith("  ") and "loop" in line):
            print("  | " + line.strip())
    X = res.primal[Xidx]
    diag_err = float(np.max(np.abs(np.diag(X) - 1.0)))
    ev = np.linalg.eigvalsh(X)
    fro = float(np.linalg.norm(X))
    # a dual bound from the returned y: for any y, <C, X> <= sum(y) +
    # n max(0, lambda_max(C - Diag(y))) on {diag X = 1, X psd}, C = W / 4
    C = 0.25 * W
    y = np.asarray(res.dual_eq, np.float64)
    bounds = [float(np.sum(sy)) + LZ_SIDE * max(0.0, float(
        np.linalg.eigvalsh(C - np.diag(sy))[-1])) for sy in (y, -y)]
    race = re.search(r"f32 race: subspace rank (\d+) \(observed (\d+)\)", log)
    hand = re.search(r"f32 -> f64 at iter (\d+)", log)
    pol = re.search(r"f64 polish: subspace rank (\d+) \(observed (\d+)\)", log)
    fb = re.search(r"f32 polar-reseed=(\d+), dense-eigh=(\d+)", log)
    bound = 2e-4 * (1 + abs(LZE_REF_OBJ))
    diff = res.objval - LZE_REF_OBJ
    print(f"phase E (default Options(chunk_iters=256), side {LZ_SIDE}) on "
          f"{smi}: status {res.status} objval {res.objval!r} (reference "
          f"{LZE_REF_OBJ!r}, diff {diff:.4e}, bound {bound:.3f}, ratio to the "
          f"bound {abs(diff) / bound:.3f}) iterations {res.iter} (reference "
          f"{LZE_REF_ITERS}, {100.0 * (res.iter - LZE_REF_ITERS) / LZE_REF_ITERS:+.1f}%) "
          f"final rank {res.final_rank} gap {res.gap:.3e}; wall {wall:.3f} s, "
          f"{res.iter / wall:.2f} iterations/s")
    print(f"phase E events: race rank {race and race.group(1)} (observed "
          f"{race and race.group(2)}; reference {LZE_REF_RACE_RANK}), hand-over "
          f"at {hand and hand.group(1)} (reference {LZE_REF_HANDOVER}), polish "
          f"rank {pol and pol.group(1)} (observed {pol and pol.group(2)}; "
          f"reference {LZE_REF_POLISH_RANK}), polar reseeds {fb and fb.group(1)}"
          f" (reference {LZE_REF_RESEEDS}), dense-eigh fallbacks "
          f"{fb and fb.group(2)}")
    print("phase E host seconds: " + ", ".join(
        f"{name} {sec:.3f} s in {timer.calls[name]} calls"
        for name, sec in timer.seconds.items()))
    print(f"phase E checks: max|diag(X)-1| {diag_err:.6e} (bound "
          f"{diag_tol:.3e}), lambda_min(X) {ev[0]:.3e}, ||X||_F {fro:.3e}; "
          f"dual bound from the returned y (diagnostic, not held): "
          f"{min(bounds)!r} (objective {res.objval!r}, relative gap "
          f"{(min(bounds) - res.objval) / abs(res.objval):.3e})")
    print("phase E launches: " + json.dumps({e: n for e, n in entries.items() if n}))
    if abs(res.iter - LZE_REF_ITERS) > 0.25 * LZE_REF_ITERS:
        print(f"phase E FINDING: iterations {res.iter} differ from the "
              f"reference's {LZE_REF_ITERS} by more than 25 %")
    check(res.status == 1, f"E: status {res.status}, want 1")
    check(abs(diff) <= bound, f"E: objval {res.objval} vs {LZE_REF_OBJ}")
    check(np.all(np.isfinite(X)) and X.shape == (LZ_SIDE, LZ_SIDE),
          "E: X not finite")
    check(diag_err <= diag_tol, f"E: max|diag(X)-1| = {diag_err} > {diag_tol}")
    check(ev[0] >= -1e-6 * fro, f"E: lambda_min(X) = {ev[0]}")
    return entries, shapes


def phase_f(torch, kernels, smi, W):
    """The f64 Lanczos program (Options(hybrid_precision=False)) at side
    2000: LZF_ITERS iterations of the chunk runner's iteration from
    init_state with the launch counts set to 0 just before and read just
    after, against the JAX package's accept sequence and last iterate;
    then solve(..., max_iter=LZF_SOLVE_ITERS), which must return status 3."""
    from proxsdp_tpu_torch import Options, convert, solve
    from proxsdp_tpu_torch import solver as tsolver
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem
    from proxsdp_tpu_torch.ops.cones import lanczos_ncv
    from proxsdp_tpu_torch.ops.lanczos import lanczos_topk
    from proxsdp_tpu_torch.ops.linop import build_linop
    from proxsdp_tpu_torch.problem import preprocess, to_square_form

    dev = torch.device("cuda")
    N = LZF_ITERS
    problem, _ = maxcut_problem(W)
    setup = to_square_form(preprocess(problem))
    layout = setup.layout
    opts = Options(hybrid_precision=False)
    ncv, tol = lanczos_ncv(LZ_SIDE, opts), opts.krylovkit_tol
    host = tsolver.init_state(layout, opts, setup)
    M = build_linop(setup.A, setup.G, torch.float64, device=dev)
    o = convert.operands_from_numpy(
        M=M, b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
        norm_h=setup.norm_h, norm_c=setup.norm_c,
        obj_scale=setup.obj_scale * setup.rhs_scale, device=dev)
    _, iteration, fetch = tsolver.make_chunk_runner(layout, opts, device=dev)
    s = convert.state_from_numpy(host, dev)
    w0 = np.asarray(host["warm"][0])
    accept, parting = [], None
    kernels.reset_launch_counts()
    SHAPES.reset()
    t0 = time.perf_counter()
    for k in range(N):
        tr, fb = (int(v) for v in torch.stack([s.target_rank[0],
                                               s.proj_fallbacks]).cpu())
        s_prev = s
        s = iteration(s, o, k, (tr,))
        accept.append(int(s.proj_fallbacks) == fb)
        if parting is None and accept[-1] != (LZF_REF_ACCEPT[k] == "1"):
            parting = (k + 1, s_prev, tr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entries = dict(kernels.launch_counts)
    shapes = collections.Counter(SHAPES.counts)
    got = fetch(s)
    launches = kernels.kernel_launches()["lanczos_krylov"]
    # after the counted run: K11's device time, the start vector check
    us = device_us(torch, lambda: iteration(s, o, N, (tr,)), "lanczos_kernel",
                   2)
    warm1 = convert.state_to_numpy(iteration(convert.state_from_numpy(
        host, dev), o, 0, (2,)))["warm"][0]
    start_kept = float(np.abs(warm1 - w0 / np.linalg.norm(w0)).max())
    acc_share = sum(accept) / N
    print(f"phase F (f64 Lanczos program, side {LZ_SIDE}, ncv {ncv}, {N} "
          f"iterations from init_state) on {smi}: {wall:.3f} s, "
          f"{1e3 * wall / N:.2f} ms/iteration; Lanczos accept share "
          f"{acc_share:.3f} (reference {LZF_REF_ACCEPT.count('1') / N:.3f}); "
          f"K11 launches {launches} ({launches / N:.2f} per iteration), "
          f"device {'not measured' if us is None else f'{us:.1f}'} us per "
          f"launch; iteration 1's warm vector vs the start vector: "
          f"{start_kept:.2e}")
    print("phase F launches: " + json.dumps({e: n for e, n in entries.items() if n}))
    check(launches == N, f"F: K11 launched {launches} times, want {N}")
    ref = np.asarray(LZF_REF_FETCH)
    names = ("gap", "feas", "prim_obj", "dual_obj", "pres", "dres", "comb")
    rel = {nm: abs(float(got[i]) - ref[i]) / max(abs(ref[i]), 1e-300)
           for i, nm in zip(range(2, 9), names)}
    print(f"phase F last iterate: target_rank {int(got[9])} (reference "
          f"{int(ref[9])}), proj_fallbacks {int(got[10])} (reference "
          f"{int(ref[10])}), relative differences " + ", ".join(
              f"{nm} {v:.3e}" for nm, v in rel.items()))
    if parting is None:
        check(int(got[9]) == int(ref[9]) and int(got[10]) == int(ref[10]),
              "F: target_rank or proj_fallbacks differ")
        check(max(rel.values()) <= 1e-6,
              f"F: last iterate differs by {max(rel.values()):.3e} > 1e-6")
        print("phase F: the accept sequence equals the JAX package's")
    else:
        t, sp, trp = parting
        X = kernels.primal_update_sym(sp.x, sp.Mty, o.c, sp.primal_step,
                                      (LZ_SIDE,)).view(LZ_SIDE, LZ_SIDE)
        mine = residual_test(torch, lanczos_topk(X, sp.warm[0], ncv=ncv,
                                                 tol=tol), trp, tol)[2]
        theirs = LZF_REF_NEAR.get(t)
        print(f"phase F: the accept sequences part at iteration {t} "
              f"(port {'accept' if accept[t - 1] else 'fallback'}): the "
              f"deciding pair's residual / threshold {mine!r} here, "
              f"{theirs!r} in the JAX run (threshold 1)")
        near = (abs(mine - 1.0) <= 1e-3 and theirs is not None
                and abs(theirs - 1.0) <= 1e-3)
        check(near, f"F: a parting at iteration {t} away from the threshold")
        check(int(got[9]) == int(ref[9]), "F: target_rank differs")
        check(rel["prim_obj"] <= 1e-4, f"F: objective differs by "
              f"{rel['prim_obj']:.3e} > 1e-4 after a rounding parting")
    # the public entry point, through the iteration limit (a shorter one
    # than N, to keep the run within its time)
    t0 = time.perf_counter()
    res = solve(problem, Options(hybrid_precision=False, max_iter=LZF_SOLVE_ITERS))
    torch.cuda.synchronize()
    print(f"phase F solve(max_iter={LZF_SOLVE_ITERS}): status {res.status} iterations "
          f"{res.iter} objval {res.objval!r} gap {res.gap:.3e} wall "
          f"{time.perf_counter() - t0:.3f} s ({res.status_string})")
    check(res.status == 3, f"F: solve status {res.status}, want 3")
    return entries, shapes


# ---------------------------------------------------------------------------
# Phase G: solve_batch's subspace mode (K12, host reseeds, the drop to the
# eigh program, K9 past side 64)
# ---------------------------------------------------------------------------


def phase_g(torch, kernels, smi, label, B, side, warm_first, ref):
    """solve_batch of max-cut instances s = 0..B-1 of ``side`` at
    Options(tol_gap=1e-4, tol_feasibility=1e-4), projection "auto" (the
    subspace mode: B > 32), with the launch counts set to 0 just before
    the counted solve and read just after (a first, uncounted solve when
    ``warm_first``).  Checks every status, the feasibility and PSD bounds
    per instance, and the objectives against the JAX solve's (``ref``: the
    JAX package's constants) within G_OBJ_RTOL each and G_OBJ_MEAN_RTOL on
    average; prints the reseeds and programs beside
    the JAX driver's, instances/s, and from a profiled window of each
    program its launches per iteration, busy share and device us per
    launch.  Returns (launches by entry point, by entry point and shape,
    the subspace buckets run)."""
    from proxsdp_tpu_torch import Options, solve_batch
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu_torch.parallel import batch as tbatch
    from proxsdp_tpu_torch.problem import preprocess

    problems = [maxcut_problem(random_graph_weights(s, side)) for s in range(B)]
    probs, Xidx = [p for p, _ in problems], problems[0][1]
    setups = [preprocess(p) for p in probs]
    opts = Options(tol_gap=1e-4, tol_feasibility=1e-4)
    first = None
    if warm_first:
        t0 = time.perf_counter()
        solve_batch(probs, opts)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    stats = tbatch.BatchStats()
    kernels.reset_launch_counts()
    SHAPES.reset()
    t0 = time.perf_counter()
    res = solve_batch(probs, opts, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entries = dict(kernels.launch_counts)
    shapes = collections.Counter(SHAPES.counts)
    status = np.array([r.status for r in res])
    iters = np.array([r.iter for r in res])
    X = np.stack([r.primal[Xidx] for r in res])
    diag_err = np.abs(np.diagonal(X, axis1=1, axis2=2) - 1.0).max(axis=1)
    diag_tol = np.array([1e-4 * (1.0 + s.norm_b) * s.rhs_scale for s in setups])
    lam_min = np.linalg.eigvalsh(X)[:, 0]
    fro = np.linalg.norm(X, axis=(1, 2))
    obj = np.array([r.objval for r in res])
    exact, jax_obj = np.array(ref["exact"]), np.array(ref["obj"])
    err = np.abs(obj - exact) / (1.0 + np.abs(exact))
    err_jax = np.abs(jax_obj - exact) / (1.0 + np.abs(exact))
    dev = np.abs(obj - jax_obj) / (1.0 + np.abs(jax_obj))
    seq = [("reseed", k, n, r) for _, _, _, k, n, r in stats.reseeds]
    programs = [(d, k) for d, _, k in stats.programs]
    print(f"phase {label} (solve_batch, B = {B}, side {side}, Options(tol_gap="
          f"1e-4, tol_feasibility=1e-4), projection 'auto') on {smi}: "
          f"{'warm ' if warm_first else ''}solve {wall:.3f} s, "
          f"{B / wall:.2f} instances/s"
          + (f" (first solve {first:.3f} s)" if warm_first else "")
          + f"; f32 race {stats.race_iters} iterations in "
          f"{stats.race_seconds:.3f} s, final phase {stats.final_seconds:.3f} s,"
          f" program steps {stats.steps}; statuses "
          f"{dict(zip(*np.unique(status, return_counts=True)))}; iterations "
          f"min/median/max {iters.min()}/{int(np.median(iters))}/{iters.max()}"
          f" (JAX {ref['iters']})")
    print(f"phase {label} reseeds (dtype, iteration min, max, k, instances "
          f"masked, r_max): {stats.reseeds}; JAX: {ref['reseeds']}")
    print(f"phase {label} programs (dtype, k; k = 0 the eigh program): "
          f"{programs}; JAX: {ref['programs']}")
    if [s[1] for s in seq] != [r[3] for r in ref["reseeds"]] or \
            programs != [tuple(p) for p in ref["programs"]]:
        print(f"phase {label} FINDING: the reseed buckets or the programs "
              "differ from the JAX driver's (above)")
    elif [s[2:] for s in seq] != [tuple(r[4:]) for r in ref["reseeds"]]:
        print(f"phase {label}: the JAX driver's reseeds at its buckets and its "
              "programs; the instances masked and r_max differ (f32 rounding "
              "moves the race's trajectories)")
    worst = np.argsort(-dev)[:5].tolist()
    print(f"phase {label} checks: max|diag(X)-1| worst {diag_err.max():.3e} "
          f"(its bound {diag_tol[diag_err.argmax()]:.3e}), min over instances "
          f"of lambda_min(X)/||X||_F {float((lam_min / fro).min()):.3e}; "
          f"objective vs the JAX solve: max |diff|/(1+|obj|) {dev.max():.3e} "
          f"(bound {G_OBJ_RTOL:.1e}), mean {dev.mean():.3e} (bound "
          f"{G_OBJ_MEAN_RTOL:.1e}), above 2e-4 {int((dev > 2e-4).sum())} "
          f"instances (worst {worst}: iterations {iters[worst].tolist()}); vs "
          f"the exact optima: max {err.max():.3e}, mean {err.mean():.3e} (the "
          f"JAX solve's {err_jax.max():.3e}, {err_jax.mean():.3e})")
    print(f"phase {label} objectives: " + json.dumps(obj.tolist()))
    print(f"phase {label} launches: " + json.dumps(
        {e: n for e, n in entries.items() if n}))
    buckets = sorted({k for _, _, k in stats.programs if k})
    windows = [(f"f32 subspace k = {k}", "float32", k) for k in buckets] + [
        ("f32 eigh", "float32", 0), ("f64 eigh", "float64", 0)]
    for name, dtype, k in windows:
        per_step, ours, busy, ms, per_launch = profile_steps(
            torch, kernels, setups, Options(dtype=dtype, hybrid_precision=False,
                                            tol_gap=1e-4, tol_feasibility=1e-4),
            sub_k=k)
        print(f"phase {label} profile ({name} program, {PROFILE_STEPS} "
              f"iterations of all "
              f"{B} instances): {ms:.3f} ms/iteration, CUDA kernels per "
              f"iteration {'not measured' if per_step is None else f'{per_step:.1f}'}"
              f" (the port's own {ours:.1f}), device busy "
              f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}; "
              "device us per launch "
              + ("not measured" if per_launch is None
                 else json.dumps(per_launch)))
    check((status == 1).all(), f"{label}: not every instance reached status 1")
    check((diag_err <= diag_tol).all(),
          f"{label}: max|diag(X)-1| above the bound for "
          f"{int((diag_err > diag_tol).sum())} instances")
    check((lam_min >= -1e-6 * fro).all(),
          f"{label}: lambda_min(X) < -1e-6 ||X||_F for "
          f"{int((lam_min < -1e-6 * fro).sum())} instances")
    check(dev.max() <= G_OBJ_RTOL,
          f"{label}: objectives of instances "
          f"{np.nonzero(dev > G_OBJ_RTOL)[0].tolist()} lie farther from the "
          f"JAX solve's than {G_OBJ_RTOL:.1e} (1 + |obj|)")
    check(dev.mean() <= G_OBJ_MEAN_RTOL,
          f"{label}: objectives lie {dev.mean():.3e} (1 + |obj|) from the JAX "
          f"solve's on average (> {G_OBJ_MEAN_RTOL:.1e})")
    return entries, shapes, buckets


def soc_blocks(rng, lens, rows=1):
    """``rows`` rows of SOC blocks of ``lens`` laid end to end, (rows,
    sum(lens)): the three cases of cones.py:50-55 in turn (inside the
    cone, in its polar, outside both) and every fourth with v = 0."""
    parts = []
    for i, ln in enumerate(tuple(lens) * rows):
        w = rng.standard_normal(ln - 1)
        nv = np.linalg.norm(w)
        head = (2.0 * nv, -1.5 * nv, 0.3 * nv, -0.7)[i % 4]
        parts.append(np.concatenate([[head], 0 * w if i % 4 == 3 else w]))
    return np.concatenate(parts).reshape(rows, -1)


def soc_padded(torch, V, lens):
    """The v parts of the SOC blocks of ``lens`` in V (..., sum(lens)),
    zero-padded to the longest: the library call's input."""
    width = max(lens)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    gather = torch.tensor(off[:, None] + 1 + np.minimum(
        np.arange(width - 1)[None, :], np.array(lens)[:, None] - 2),
        device=V.device)
    pad = torch.tensor(np.arange(width - 1)[None, :]
                       < np.array(lens)[:, None] - 1, device=V.device)
    return torch.where(pad, V[..., gather], 0.0)


def conic_kernel_checks(torch, kernels, rng, dev):
    """Phase B rows of phases H and I: K3 with a row scale at phase H's
    shape (n = 90,000, p = 4375, one side-300 block; the equilibrated
    probe arm's row scale 1/E), K3 and K4 over phase I's 33-block table,
    K13 at phase I's 128 SOC blocks of length 16 (and, off the path, at
    4096 blocks of lengths 2-257 in all three cases and with v = 0), K9 at
    phase I's grouped (32, 19, 19) stack, in f64 and f32; (rows by phase
    {"H": [...], "I": [...]}, off-path rows)."""
    import proxsdp_tpu_torch as tx
    from proxsdp_tpu_torch.ops.linop import build_linop
    from proxsdp_tpu_torch.problem import preprocess, to_square_form

    rows, off_path = {"H": [], "I": []}, []
    setups = {"H": to_square_form(preprocess(build_theta(tx, theta_graph())[0])),
              "I": to_square_form(preprocess(build_conic_program(
                  tx, conic_program_data())[0]))}
    n_i = sum(s * s for s in I_PSD_SIDES) + sum(I_SOC_LENS) + I_LP
    p_i, m_i = I_ROWS, I_LP
    n_h, p_h = THETA_N * THETA_N, THETA_EDGES + 1
    for sfx, dt in (("f64", torch.float64), ("f32", torch.float32)):
        def vec(k, scale=1.0, dt=dt):
            return torch.tensor(scale * rng.standard_normal(k), dtype=dt,
                                device=dev)

        def scalar(v, dt=dt):
            return torch.tensor(v, dtype=dt, device=dev)

        tau, sigma = scalar(0.37), scalar(0.21)
        for phase, n, p, m, sides, rs in (
                ("H", n_h, p_h, 0, (THETA_N,),
                 torch.tensor(rng.uniform(0.05, 20.0, p_h), dtype=dt,
                              device=dev)),
                ("I", n_i, p_i, m_i, I_PSD_SIDES, None)):
            x, x_old, Mty, Mty_old, c = (vec(n, sc) for sc in
                                         (1, 1, 1e-2, 1e-2, 1))
            y, y_old, Mx, Mx_old = (vec(p + m) for _ in range(4))
            b, h = vec(p), vec(m)
            label = (f"H: n = {n}, p = {p}, row scale" if rs is not None
                     else f"I: n = {n}, p = {p}, m = {m}, {len(sides)} blocks")
            check_entry(
                torch, kernels, rows[phase], "residuals", sfx, "residuals.cu",
                "proxsdp_tpu/solver.py:545",
                lambda f, a=(x, x_old, Mty, Mty_old, tau, y, y_old, Mx,
                             Mx_old, sigma, b, h, c, p, m, sides), rs=rs:
                (f(*a, row_scale=rs),),
                kernels.residuals_plain,
                (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b,
                 h, c) + (() if rs is None else (rs,)),
                (torch.empty(9, dtype=torch.float64, device=dev),),
                10 * n + 12 * (p + m), label=label)
            if phase == "I":
                check_entry(
                    torch, kernels, rows["I"], "primal_update_sym", sfx,
                    "primal_update_sym.cu", "proxsdp_tpu/solver.py:308",
                    lambda f, a=(x, Mty, c, tau, sides): (f(*a),),
                    kernels.primal_update_sym_plain, (x, Mty, c, tau),
                    (torch.empty_like(x),), 5 * n, label=label,
                    tol=0.0 if sfx == "f64" else 1e-7)
        # K14: the COO operator's two products at phase H's and I's shapes
        for phase, st in setups.items():
            M = build_linop(st.A, st.G, dt, device=dev)
            check(type(M).__name__ == "CooOp",
                  f"{phase}: the operator is {type(M).__name__}, not COO")
            nr, nc = M.shape
            x, y = vec(nc), vec(nr)
            csr_row = torch.sparse_csr_tensor(M.row_ptr, M.row_idx.long(),
                                              M.row_vals, (nr, nc))
            csr_col = torch.sparse_csr_tensor(M.col_ptr, M.col_idx.long(),
                                              M.col_vals, (nc, nr))
            check_entry(
                torch, kernels, rows[phase], "coo_spmv", sfx, "coo_spmv.cu",
                "proxsdp_tpu/ops/linop.py:81",
                lambda f, M=M, x=x, y=y: (
                    f(M.row_ptr, M.row_idx, M.row_vals, x, M.row_seg),
                    f(M.col_ptr, M.col_idx, M.col_vals, y, M.col_seg)),
                kernels.coo_spmv_plain,
                (M.row_ptr, M.row_idx, M.row_vals, x, M.col_ptr, M.col_idx,
                 M.col_vals, y), (vec(nr), vec(nc)),
                4 * M.row_vals.numel(),
                library=lambda a=csr_row, b=csr_col, x=x, y=y: (
                    torch.sparse.mm(a, x[:, None]), torch.sparse.mm(b, y[:, None])),
                label=f"{phase}: {nr} x {nc}, {M.row_vals.numel()} nonzeros")
            LAUNCH_US.append((f"coo_spmv_{sfx} ({phase}: M x)",
                              lambda M=M, x=x: kernels.coo_spmv(
                                  M.row_ptr, M.row_idx, M.row_vals, x,
                                  M.row_seg), "seg_spmv_kernel"))
            linesearch_row(torch, kernels, rows[phase], M, st.layout.p,
                           st.layout.m, sfx, dt, dev,
                           np.random.default_rng(12),
                           f"{phase}: {nr} x {nc}, COO")
        # K13: phase I's blocks, then 4096 of lengths 2-257
        for nblk, on in ((len(I_SOC_LENS), True), (4096, False)):
            if on:
                lens = I_SOC_LENS
                v = vec(sum(lens))
                v[:: I_SOC_LENS[0]] *= 3.0  # heads: a mix of the cases
            else:
                lens = tuple(2 + (37 * i) % 256 for i in range(nblk))
                v = torch.tensor(soc_blocks(rng, lens)[0], dtype=dt,
                                 device=dev)
            Vpad = soc_padded(torch, v, lens)
            check_entry(
                torch, kernels, rows["I"] if on else off_path, "soc_projection", sfx,
                "soc_proj.cu", "proxsdp_tpu/ops/cones.py:43",
                lambda f, v=v, lens=lens: f(v, lens),
                kernels.soc_projection_plain, (v,),
                (torch.empty_like(v), scalar(0.0)), 4.3 * v.numel(),
                library=lambda Vpad=Vpad: torch.linalg.vector_norm(Vpad, dim=1),
                tol=0.0 if sfx == "f64" else 1e-7,
                label=f"{nblk} blocks of lengths "
                + (f"{lens[0]}" if on else "2-257"),
                note="" if on else " (not on phase I's path)")
            LAUNCH_US.append((f"soc_projection_{sfx} ({nblk} blocks)",
                              lambda v=v, lens=lens: kernels.soc_projection(
                                  v, lens), "soc_proj_kernel"))
        # K9 at phase I's grouped stack of side-19 blocks
        s19 = I_PSD_SIDES[0]
        X = eigh_inputs(torch, rng, s19, dt, dev, B=I_PSD_SIDES.count(s19))
        B = X.shape[0]
        check_entry(
            torch, kernels, rows["I"], "batched_psd_eigh", sfx,
            "batched_eigh.cu", "proxsdp_tpu/ops/cones.py:622",
            lambda f, X=X: f(X, TOL_PSD), kernels.batched_psd_eigh_plain,
            (X,), (torch.empty_like(X), torch.empty(B, s19, dtype=dt,
                                                    device=dev),
                   torch.empty(B, dtype=torch.int32, device=dev),
                   torch.empty(B, s19, dtype=dt, device=dev)),
            B * 10.5 * s19 ** 3,
            library=lambda Xf=torch.nan_to_num(X): torch.linalg.eigh(Xf),
            compare_fn=eigh_compare(torch, X, EIGH_RTOL[sfx]),
            tol=EIGH_RTOL[sfx], label=f"I: side {s19}")
    return rows, off_path


def race_kernel_checks(torch, kernels, rng, dev, side, ks, polish_k, rank,
                       phase):
    """Phase B rows of K5-K8 at one side's hybrid shapes (phases H and I):
    the f32 race's polar projection (K5's Newton-Schulz square product,
    K6) and its subspace step at each bucket of ``ks`` (K7 CholeskyQR, K8
    with the eigh's Ritz values, K5 on the polar reseed's column slices),
    and the mixed f64 polish's K8 test at ``polish_k``, on a matrix with
    ``rank`` positive eigenvalues and a negative bulk (the iterate's
    spectrum); rows labelled with ``phase``."""
    from proxsdp_tpu_torch.ops.cones import POLAR_QA

    rows = []
    f32, f64 = torch.float32, torch.float64
    V, _ = torch.linalg.qr(torch.tensor(rng.standard_normal((side, side)),
                                        dtype=f64, device=dev))
    w = torch.cat([torch.linspace(40.0, 1.0, rank, dtype=f64, device=dev),
                   -torch.linspace(0.05, 5.0, side - rank, dtype=f64,
                                   device=dev)])
    X64 = torch.matmul(V * w[None, :], V.T)
    X64 = 0.5 * (X64 + X64.T)
    X = X64.float()
    Sg = torch.matmul(V * torch.sign(w)[None, :], V.T).float()
    Y, _ = kernels.fro_scale_plain(X, f32)
    A = kernels.ns_gemm_plain(Y, Y)
    S = kernels.sym_plain(Y)
    P = kernels.ns_gemm_plain(S, X, X, 0.5, 0.5)
    mat = torch.empty_like(X)
    tag = f"{phase}: side {side}"
    check_entry(torch, kernels, rows, "ns_gemm", "f32", "ns_gemm.cu",
                "proxsdp_tpu/ops/cones.py:90",
                lambda f: (f(Y, A, Y, POLAR_QA, 1.0),), kernels.ns_gemm_plain,
                (Y, A), (mat,), 2 * side ** 3 + 3 * side ** 2,
                library=lambda: torch.addmm(Y, Y, A, beta=POLAR_QA), label=tag)
    check_entry(torch, kernels, rows, "fro_scale", "f32", "polar_sym.cu",
                "proxsdp_tpu/ops/cones.py:85", lambda f: f(X, f32),
                kernels.fro_scale_plain, (X,), (mat,), 3 * side * side,
                label=tag)
    check_entry(torch, kernels, rows, "sym", "f32", "polar_sym.cu",
                "proxsdp_tpu/ops/cones.py:94", lambda f: (f(Y),),
                kernels.sym_plain, (Y,), (mat,), 2 * side * side, label=tag)
    check_entry(torch, kernels, rows, "sym_guard", "f32", "polar_sym.cu",
                "proxsdp_tpu/ops/cones.py:96", lambda f: f(P, S, X),
                kernels.sym_guard_plain, (P, torch.diagonal(S).contiguous()),
                (mat,), 3 * side * side, label=tag)
    for k in ks:
        Yk = torch.matmul(X, torch.tensor(rng.standard_normal((side, k)),
                                          dtype=f32, device=dev))
        check_entry(torch, kernels, rows, "cholqr", "f32", "cholqr.cu",
                    "proxsdp_tpu/ops/cones.py:247",
                    lambda f, Yk=Yk: (f(Yk, kernels.CHOLQR_EPS[f32]),),
                    kernels.cholqr_plain, (Yk,), (Yk, torch.empty_like(Yk)),
                    2 * side * k * k + k ** 3 // 3, label=f"{tag} k={k}",
                    library=lambda Yk=Yk: torch.linalg.qr(Yk))
        # the basis's last column outside the positive span (else P- of it
        # is 0 and the check is of rounding alone), as the reseed meets it
        wb = torch.cat([V[:, : k - 1], V[:, rank : rank + 1]], 1).float()
        pm = (("P+ warm", slice(None, -1), 0.5, 296),
              ("P- last", slice(-1, None), -0.5, 297))
        for label, cols, sign, line in pm[: 2 if k == ks[0] else 1]:
            Wc = wb[:, cols]
            kc = Wc.shape[1]
            check_entry(
                torch, kernels, rows, "ns_gemm", "f32", "ns_gemm.cu",
                f"proxsdp_tpu/ops/cones.py:{line}",
                lambda f, Wc=Wc, sign=sign: (f(Sg, Wc, Wc, 0.5, sign),),
                kernels.ns_gemm_plain, (Sg, Wc),
                (torch.empty(side, kc, dtype=f32, device=dev),),
                2 * side * side * kc + 3 * side * kc,
                library=lambda Wc=Wc, sign=sign: torch.addmm(
                    Wc, Sg, Wc, beta=0.5, alpha=sign),
                label=f"{label}, {tag} k={k}, strided")
    for sfx, k, dt in [("f32", k, f32) for k in ks] + [("f64", polish_k, f64)]:
        Wk = V[:, :k].to(dt).contiguous()
        XW = torch.matmul(X64.to(dt), Wk)
        th = w[:k].to(dt) if sfx == "f32" else None
        at = torch.tensor(1e-4, dtype=dt, device=dev)
        tol = 1e-9 if sfx == "f32" else 4e-6

        def exact_flags(g, wnt, sfx=sfx):
            check(torch.equal(g[2].cpu(), wnt[2].cpu()),
                  f"ritz_accept_{sfx}: flags {g[2].tolist()} vs {wnt[2].tolist()}")
            return compare(torch, g[:2], wnt[:2])

        check_entry(torch, kernels, rows, "ritz_accept", sfx, "ritz_accept.cu",
                    "proxsdp_tpu/ops/cones.py:443",
                    lambda f, Wk=Wk, XW=XW, th=th, at=at, tol=tol: f(
                        Wk, XW, th, at, tol, 1e-7, False),
                    kernels.ritz_accept_plain, (Wk, XW, th, at),
                    (torch.empty(k + 3, dtype=dt, device=dev),), 8 * side * k,
                    compare_fn=exact_flags, label=f"{tag} k={k}")
    return rows


def _probe_lines(log: str):
    rounds = [(int(d), float(a), float(b)) for d, a, b in re.findall(
        r"\[beq probe\] depth (\d+): default (\S+) vs block-equilibrated "
        r"(\S+)", log)]
    won = re.search(r"\[beq probe\] -> (\S+)", log)
    return rounds, won and won.group(1)


def theta_solve(torch, kernels, tx, problem, opts):
    """One counted solve of phase H's instance, its log captured: (result,
    wall s, log, launches by entry point, by entry point and shape, K3's
    launches with a row scale by dtype)."""
    buf = io.StringIO()
    kernels.reset_launch_counts()
    SHAPES.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = tx.solve(problem, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, wall, buf.getvalue(), dict(kernels.launch_counts),
            collections.Counter(SHAPES.counts),
            dict(kernels.row_scale_launches))


def theta_checks(label, res, log, X, edges, opts, ref, bound_desc, ok_obj):
    """Phase H's checks of one solve: status 1, no probe arm failed, the
    objective (``ok_obj``), tr X = 1 and X_ij = 0 on the edges within the
    solver's feasibility bound, lambda_min(X) >= -1e-6 ||X||_F."""
    lin = max(abs(float(np.trace(X)) - 1.0),
              float(np.abs(X[edges[0], edges[1]]).max()))
    lin_bound = opts.tol_feasibility * 2.0  # (1 + max |b|), b in {0, 1}
    ev = np.linalg.eigvalsh(X)
    fro = float(np.linalg.norm(X))
    print(f"phase {label} checks: objval {res.objval!r} against {ref} "
          f"({bound_desc}); the optimum {H_OPT_OBJ!r} lies "
          f"{res.objval - H_OPT_OBJ:+.3e} away; max(|tr X - 1|, max |X_ij| "
          f"on edges) {lin:.3e} (bound {lin_bound:.1e}), lambda_min(X) "
          f"{ev[0]:.3e}, ||X||_F {fro:.3e}")
    failed = re.findall(r"\[beq probe\] arm \S+ failed: .*", log)
    check(not failed, f"{label}: a probe arm raised: {failed}")
    check(res.status == 1, f"{label}: status {res.status}, want 1")
    check(ok_obj, f"{label}: objval {res.objval} outside {bound_desc}")
    check(np.all(np.isfinite(X)), f"{label}: X not finite")
    check(lin <= lin_bound, f"{label}: linear violation {lin} > {lin_bound}")
    check(ev[0] >= -1e-6 * fro, f"{label}: lambda_min(X) = {ev[0]}")


def phase_h(torch, kernels, smi):
    """The Lovasz-theta SDP at SDPLIB theta6's shape, three solves.  H1:
    the default Options(chunk_iters=256): the row-norm spread 24.5 sends
    it through the block-equilibration probe (both arms, each round capped
    at 20 s, so the clock picks the depths and the winner; a winner other
    than the JAX run's is printed as a finding), then the winner's solve,
    warm-started from its arm.  The objective is held to the JAX package's
    answer on the arm that won: the default arm's within 2e-4 (1 + |obj|)
    of H_REF_OBJ, or, where that arm solved inside its round, of
    H_UNCUT_REF_RANGE (its JAX answers move with where its f32 race
    hands over); the equilibrated arm's, whose JAX answers move with the
    depth its arm stops at, within 2e-4 (1 + |obj|) of H_EQ_REF_RANGE.
    H2: block_equilibration_probe_iters=H2_PROBE_ITERS, shallow enough
    that the arms stop at their depth, not the clock, here and in the JAX
    run: the probe's rounds and winner (the equilibrated arm) equal to
    the JAX run's and the objective within 2e-4 (1 + |obj|) of H2_REF_OBJ.
    H3: H3_PROBE_ITERS, both arms cut below their solve points (see
    H3_PROBE_ITERS): the objective within 2e-4 (1 + |obj|) of the JAX
    answer of the arm that won (H3_REF_OBJ, the equilibrated arm's, or
    H3_REF_DEFAULT_OBJ, the default arm's), a winner other than the JAX
    run's printed as a finding (the arms' scores at the cut move with
    the f32 race's rounding).
    All: status 1, tr X = 1 and X_ij = 0 on the edges within the solver's
    feasibility bound, lambda_min(X) >= -1e-6 ||X||_F, no probe arm
    raised.  Returns (launches by entry point, by entry point and shape,
    K3's launches with a row scale by dtype), the three solves' summed."""
    import proxsdp_tpu_torch as tx

    edges = theta_graph()
    problem, Xidx = build_theta(tx, edges)
    entries, shapes, rs = collections.Counter(), collections.Counter(), {}
    refs = {"H1": (H_REF_PROBE, H_REF_WINNER, H_REF_ITERS),
            "H2": (H2_REF_PROBE, H2_REF_WINNER, H2_REF_ITERS),
            "H3": (H3_REF_PROBE, H3_REF_WINNER, H3_REF_ITERS)}
    for label, kw in (("H1", {}),
                      ("H2", {"block_equilibration_probe_iters": H2_PROBE_ITERS}),
                      ("H3", {"block_equilibration_probe_iters": H3_PROBE_ITERS})):
        opts = tx.Options(chunk_iters=256, log_verbose=True, log_freq=10 ** 9,
                          timer_verbose=True, **kw)
        res, wall, log, ent, shp, rsl = theta_solve(torch, kernels, tx,
                                                    problem, opts)
        entries.update(ent)
        shapes.update(shp)
        for sfx, n in rsl.items():
            rs[sfx] = rs.get(sfx, 0) + n
        for line in log.splitlines():
            if line.startswith("  [") or "total" in line or "status:" in line:
                print("  | " + line.strip())
        rounds, winner = _probe_lines(log)
        ref_probe, ref_winner, ref_iters = refs[label]
        print(f"phase {label} (Lovasz theta, n = {THETA_N}, {THETA_EDGES} "
              f"edges, Options(chunk_iters=256"
              + "".join(f", {k}={v}" for k, v in kw.items())
              + f")) on {smi}: status {res.status} objval {res.objval!r}, "
              f"{res.iter} iterations after the probe (JAX {ref_iters}), "
              f"wall {wall:.3f} s; "
              f"probe rounds (depth, default score, equilibrated score) "
              f"{rounds}, winner {winner}; JAX: {ref_probe}, winner "
              f"{ref_winner}; K3 launches with a row scale {rsl}; "
              f"{res.objval - H_OPT_OBJ:+.3e} from the optimum")
        check(winner is not None, f"{label}: the probe did not run")
        same = (winner == ref_winner
                and [r[0] for r in rounds] == [r[0] for r in ref_probe])
        if label == "H2":
            check(same, f"H2: probe rounds {rounds}, winner {winner}; JAX: "
                  f"{ref_probe}, winner {ref_winner}")
            ref, lo, hi = H2_REF_OBJ, H2_REF_OBJ, H2_REF_OBJ
        else:
            if not same:
                print(f"phase {label} FINDING: the probe's rounds or winner "
                      "differ from the JAX run's "
                      + ("(each arm's round is capped at 20 s: the clock "
                         "decides where the arms stop)" if label == "H1" else
                         "(the arms' scores at their cut move with the f32 "
                         "race's rounding)")
                      + "; the objective is held to the JAX answer of the "
                      "arm that won")
            # the default arm solved inside its round: no warm solve after
            # the probe, the arm's own answer (H_UNCUT_REF_RANGE)
            arm_its = re.findall(r"\(iterations (\d+) / ", log)
            uncut = (winner == "default" and res.status == 1 and arm_its
                     and int(arm_its[-1]) == res.iter
                     and res.iter < rounds[-1][0])
            if label == "H3":
                ref = H3_REF_DEFAULT_OBJ if winner == "default" else H3_REF_OBJ
                lo = hi = ref
            elif uncut:
                print("phase H1: the default arm solved inside its round "
                      f"({res.iter} iterations), held to H_UNCUT_REF_RANGE")
                ref, (lo, hi) = H_UNCUT_REF_RANGE, H_UNCUT_REF_RANGE
            elif winner == "default":
                ref, lo, hi = H_REF_OBJ, H_REF_OBJ, H_REF_OBJ
            else:
                ref, (lo, hi) = H_EQ_REF_RANGE, H_EQ_REF_RANGE
        bound = 2e-4 * (1 + max(abs(lo), abs(hi)))
        theta_checks(label, res, log, res.primal[Xidx], edges, opts, ref,
                     f"{lo - bound!r} .. {hi + bound!r}, 2e-4 (1 + |obj|) "
                     f"= {bound:.3e} around the JAX answer of the {winner} "
                     "arm", lo - bound <= res.objval <= hi + bound)
    print("phase H launches: " + json.dumps({e: n for e, n in entries.items()
                                             if n}))
    check(sum(rs.values()) > 0, "H: K3 launched with no row scale in phase H")
    return dict(entries), shapes, rs


def phase_h_arms(torch, kernels, smi, caps=(10.0, 15.0, 20.0, 25.0, 30.0)):
    """The equilibrated arm's path through the default options' probe
    when that arm wins -- the arm at depth 6000 capped at a clock, then the
    winner's warm solve -- once for each cap in ``caps`` (the 20 s of the
    probe, and the depths a slower or faster host would reach); each
    answer within 2e-4 (1 + |obj|) of H_EQ_REF_RANGE, the JAX arm's
    answers as the clock moves, and printed beside H_REF_OBJ and the
    optimum.  Run by ``chip_smoke.py --phase-h``; fails if an answer
    misses the bound."""
    import proxsdp_tpu_torch as tx

    edges = theta_graph()
    problem, Xidx = build_theta(tx, edges)
    opts = tx.Options(chunk_iters=256, block_equilibration=True)
    lo, hi = H_EQ_REF_RANGE
    bound = 2e-4 * (1 + max(abs(lo), abs(hi)))
    for cap in caps:
        t0 = time.perf_counter()
        arm = tx.solve(problem, opts.replace(
            max_iter=6000, time_limit=cap, certificate_search=False,
            log_verbose=False, timer_verbose=False, warn_on_limit=False))
        res = arm
        if arm.status != 1:
            res = tx.solve(problem, opts, warm_start=arm
                           if arm.status in (2, 3) else None)
        torch.cuda.synchronize()
        print(f"phase H arms on {smi}: the equilibrated arm capped at "
              f"{cap:.0f} s: {arm.iter} iterations (status {arm.status}), "
              f"then {res.iter if res is not arm else 0} in its warm solve: "
              f"status {res.status} objval {res.objval!r}, "
              f"{res.objval - H_REF_OBJ:+.3e} from H_REF_OBJ, "
              f"{res.objval - H_OPT_OBJ:+.3e} from the optimum; the bound "
              f"{lo - bound!r} .. {hi + bound!r}; "
              f"{time.perf_counter() - t0:.1f} s")
        check(res.status == 1 and lo - bound <= res.objval <= hi + bound,
              f"H arms: cap {cap} s: status {res.status}, objval {res.objval}")


def phase_i(torch, kernels, smi, dev=None):
    """Every block kind in one program (``conic_program_data``): I1 runs
    I_ITERS iterations of the f64 program from init_state with the launch
    counts set to 0 just before and read just after, against the JAX
    package's last iterate (the fetched scalars, each PSD block's ||X||_F
    and lambda_min, the SOC and LP parts' norms: 1e-6 relative, phase F's
    bound); I2 solves it under the default Options(chunk_iters=256)
    against the JAX run's status and objective (2e-4 (1 + |obj|)), with
    lambda_min >= -1e-6 ||X||_F for every PSD block and ||v|| - s <=
    tol_soc for every SOC block.  Returns (I1's launches, I2's, I2's by
    entry point and shape)."""
    import proxsdp_tpu_torch as tx
    from proxsdp_tpu_torch import convert
    from proxsdp_tpu_torch import solver as tsolver
    from proxsdp_tpu_torch.ops.linop import build_linop
    from proxsdp_tpu_torch.problem import preprocess, to_square_form

    dev = dev or torch.device("cuda")
    data = conic_program_data()
    problem, Xs, socs, _ = build_conic_program(tx, data)
    setup = to_square_form(preprocess(problem))
    layout = setup.layout
    opts = tx.Options(hybrid_precision=False, block_equilibration=False,
                      max_iter=I_ITERS)
    o = convert.operands_from_numpy(
        M=build_linop(setup.A, setup.G, torch.float64, device=dev), b=setup.b,
        h=setup.h, c=setup.c, norm_b=setup.norm_b, norm_h=setup.norm_h,
        norm_c=setup.norm_c, obj_scale=setup.obj_scale * setup.rhs_scale,
        device=dev)
    _, iteration, fetch = tsolver.make_chunk_runner(layout, opts, device=dev)
    s = convert.state_from_numpy(tsolver.init_state(layout, opts, setup), dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(I_ITERS):
        s = iteration(s, o, k)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    entries1 = dict(kernels.launch_counts)
    got = fetch(s)
    x = s.x.cpu().numpy()
    norms, lmins = [], []
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        blk = x[off : off + side * side].reshape(side, side)
        norms.append(float(np.linalg.norm(blk)))
        lmins.append(float(np.linalg.eigvalsh(blk)[0]))
    end = sum(sd * sd for sd in layout.sdp_sides)
    soc_end = end + sum(layout.soc_lens)
    ref = np.asarray(I_REF_FETCH)
    rel = {"fetch": max(abs(float(got[i]) - ref[i]) / max(abs(ref[i]), 1e-300)
                        for i in range(2, 9)),
           "norms": max(abs(g - r) / r for g, r in zip(norms, I_REF_NORMS)),
           "lmins": max(abs(g - r) / nr for g, r, nr in
                        zip(lmins, I_REF_LMINS, I_REF_NORMS)),
           "soc": abs(float(np.linalg.norm(x[end:soc_end])) - I_REF_SOC_NORM)
           / I_REF_SOC_NORM,
           "lp": abs(float(np.linalg.norm(x[soc_end:])) - I_REF_LP_NORM)
           / I_REF_LP_NORM}
    print(f"phase I1 (f64 program, {len(layout.sdp_sides)} PSD blocks, "
          f"{len(layout.soc_lens)} SOC blocks, {I_LP} LP coordinates, "
          f"{I_ROWS} rows, n = {layout.n}, {I_ITERS} iterations from "
          f"init_state) on {smi}: {wall1:.3f} s, "
          f"{1e3 * wall1 / I_ITERS:.2f} ms/iteration; relative differences "
          "from the JAX iterate " + ", ".join(f"{k_} {v:.3e}"
                                              for k_, v in rel.items()))
    print("phase I1 launches: " + json.dumps(
        {e: n for e, n in entries1.items() if n}))
    check(got[:2].tolist() == ref[:2].tolist()
          and got[9:11].tolist() == ref[9:11].tolist(),
          f"I1: counters {got[:2].tolist() + got[9:11].tolist()} vs the JAX "
          f"run's {ref[:2].tolist() + ref[9:11].tolist()}")
    check(max(rel.values()) <= 1e-6,
          f"I1: the iterate differs by {max(rel.values()):.3e} > 1e-6")

    res, wall, entries2, counts, shapes, log = solve_timed(
        torch, kernels, tx.solve, problem,
        tx.Options(chunk_iters=256, log_verbose=True, log_freq=10 ** 9,
                   timer_verbose=True), capture=True)
    for line in log.splitlines():
        if line.startswith("  [") or "total" in line or "status:" in line:
            print("  | " + line.strip())
    lam = [float(np.linalg.eigvalsh(res.primal[X])[0])
           / max(float(np.linalg.norm(res.primal[X])), 1e-300) for X in Xs]
    gaps = [float(np.linalg.norm(res.primal[v][1:]) - res.primal[v][0])
            for v in socs]
    bound = 2e-4 * (1 + abs(I_REF_OBJ))
    print(f"phase I2 (default Options(chunk_iters=256)) on {smi}: status "
          f"{res.status} objval {res.objval!r} (reference {I_REF_OBJ!r}, "
          f"diff {res.objval - I_REF_OBJ:.3e}, bound {bound:.3e}) iterations "
          f"{res.iter} (reference {I_REF_ITERS}) wall {wall:.3f} s, "
          f"{res.iter / wall:.1f} iterations/s; min lambda_min(X)/||X||_F "
          f"{min(lam):.3e}, max ||v|| - s {max(gaps):.3e}")
    print("phase I2 launches: " + json.dumps(
        {e: n for e, n in entries2.items() if n}))
    check(res.status == I_REF_STATUS,
          f"I2: status {res.status}, want {I_REF_STATUS}")
    if I_REF_STATUS == 1:
        check(abs(res.objval - I_REF_OBJ) <= bound,
              f"I2: objval {res.objval} vs {I_REF_OBJ}")
    check(min(lam) >= -1e-6, f"I2: lambda_min(X)/||X||_F = {min(lam)}")
    check(max(gaps) <= tx.Options().tol_soc, f"I2: SOC gap {max(gaps)}")
    for name in ("soc_projection", "batched_psd_eigh", "primal_update_sym",
                 "residuals"):
        check(counts[name] > 0, f"I2: {name} launched no kernel")
    return entries1, entries2, shapes


# The JAX package's phase J runs (one thread, chunk_iters=256, a frozen
# clock; tests/test_torch_reference_values.py re-derives them, slow):
# the status, certificate_found and string, the first declaration (status,
# iteration), the final iteration and the ray's farkas() value
J1_REF = {"status": 6, "found": True, "string": "Infeasible [Dual ray found]",
          "decl": [6, 2000], "iters": 4048, "farkas": -1.414189505095264}
J2_REF = {"status": 5, "found": True, "string": "Unbounded [Primal ray found]",
          "decl": [5, 5745], "iters": 5746, "farkas": -1.28768498977866}
# the first declaration's iteration: J1's f64 program declares at the
# iteration limit; J2's comes after the default hybrid race, whose f32 sums
# run in other orders in the two packages (0.45 % later on an H100)
J_DECL_RTOL = {"J1": 0.0, "J2": 5e-3}


def j_kernel_checks(torch, kernels, rng, dev, bsetups):
    """Phase B rows of phase J: K15 on J1's operator (f64) and J2's (f32,
    f64), K15b at J3's shapes (the first J3_SIZE of phase D's), and K15
    on the dense operator that J3's re-entries solve through (``solve``
    builds it for an instance of side 16: f32 and f64); rows by phase."""
    from proxsdp_tpu_torch.models.maxcut import (maxcut_problem,
                                                 random_graph_weights)
    from proxsdp_tpu_torch.ops.linop import build_linop
    from proxsdp_tpu_torch.parallel.batch import _batch_operands
    from proxsdp_tpu_torch.problem import preprocess, to_square_form

    dtypes = {"f64": torch.float64, "f32": torch.float32}
    rows = {"J1": [], "J2": [], "J3": []}
    for tag, build, sfxs in (("J1", j1_problem, ("f64",)),
                             ("J2", j2_problem, ("f64", "f32"))):
        st = to_square_form(preprocess(build(maxcut_problem,
                                             random_graph_weights)))
        for sfx in sfxs:
            M = build_linop(st.A, st.G, dtypes[sfx], device=dev)
            linesearch_row(torch, kernels, rows[tag], M, st.layout.p,
                           st.layout.m, sfx, dtypes[sfx], dev, rng,
                           f"{tag}: side {J_SIDE}, {type(M).__name__}")
    st = to_square_form(bsetups[J_BAD[0]])
    for sfx, dt in dtypes.items():
        M = build_linop(st.A, st.G, dt, device=dev)
        linesearch_row(torch, kernels, rows["J3"], M, st.layout.p,
                       st.layout.m, sfx, dt, dev, rng,
                       f"J3 re-entry: side {BATCH_SIDE}, {type(M).__name__}")
    lay, jsetups = bsetups[0].layout, bsetups[:J3_SIZE]
    for sfx, dt in dtypes.items():
        linesearch_batch_row(torch, kernels, rows["J3"],
                             _batch_operands(jsetups, dt, dev, "auto"), lay.p,
                             lay.m, sfx, dt, dev, rng,
                             f"J3: side {BATCH_SIDE}, B = {len(jsetups)}")
    return rows


def phase_j(torch, kernels, smi, bproblems):
    """J1 (infeasible) and J2 (unbounded) at side 124 through ``solve``,
    J3 (the first J3_SIZE of phase D's instances, one made infeasible)
    through ``solve_batch``;
    (launches by entry point of each)."""
    from proxsdp_tpu_torch import Options, solve, solve_batch
    from proxsdp_tpu_torch.models.maxcut import (maxcut_problem,
                                                 random_graph_weights)

    entries = {}
    for tag, build, opts, ref in (
            ("J1", j1_problem, Options(**J1_OPTS), J1_REF),
            ("J2", j2_problem, Options(**J2_OPTS), J2_REF)):
        problem = build(maxcut_problem, random_graph_weights)
        buf = io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = solve(problem, opts.replace(log_verbose=True,
                                              log_freq=10 ** 9))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        entries[tag] = dict(kernels.launch_counts)
        log = buf.getvalue()
        decl = [(int(a), int(b)) for a, b in
                re.findall(r"\[cert\] status (\d) at iter (\d+)", log)]
        for line in log.splitlines():
            if line.startswith(("  [cert]", "  [hybrid]", "  [polish]")):
                print(f"  | {tag} " + line.strip())
        got = dict(status=res.status, found=res.certificate_found,
                   string=res.status_string, decl=list(decl[0]) if decl else None,
                   iters=res.iter, farkas=farkas(res, problem))
        print(f"phase {tag} on {smi}: {json.dumps(got)} in {wall:.1f} s; the "
              f"JAX package's: {json.dumps(ref)}")
        print(f"phase {tag}: {TRIALS.read('linesearch_loop')}")
        check(res.status == ref["status"] and res.certificate_found
              == ref["found"] and res.status_string == ref["string"],
              f"{tag}: status {res.status} ({res.status_string!r}), "
              f"certificate_found {res.certificate_found}; the JAX package's "
              f"{ref['status']} ({ref['string']!r}), {ref['found']}")
        check(res.certificate_found, f"{tag}: no ray")
        check(bool(decl) and decl[0][0] == ref["decl"][0]
              and abs(decl[0][1] - ref["decl"][1])
              <= J_DECL_RTOL[tag] * ref["decl"][1],
              f"{tag}: first declaration {decl[:1]}, the JAX package's "
              f"{ref['decl']} (within {J_DECL_RTOL[tag]:.1%})")
        check(entries[tag]["linesearch_loop_f64"] > 0,
              f"{tag}: linesearch_loop_f64 (K15) launched no kernel")
    # J3: the batch's re-entry
    probs = j3_problems([p for p, _ in bproblems[:J3_SIZE]])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_batch(probs, Options(tol_gap=1e-4, tol_feasibility=1e-4))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entries["J3"] = dict(kernels.launch_counts)
    status = np.array([r.status for r in res])
    good = np.ones(len(res), bool)
    good[list(J_BAD)] = False
    print(f"phase J3 (solve_batch, B = {len(res)}, side {BATCH_SIDE}, "
          f"instances {list(J_BAD)} with X_00 = -1) on {smi}: {wall:.1f} s; "
          f"statuses of the others "
          f"{dict(zip(*np.unique(status[good], return_counts=True)))}; the "
          "infeasible ones: " + json.dumps(
              [dict(status=res[i].status, found=res[i].certificate_found,
                    string=res[i].status_string, iters=res[i].iter,
                    farkas=farkas(res[i], probs[i])) for i in J_BAD]))
    print(f"phase J3: {TRIALS.read('linesearch_loop_batch')}; "
          f"{TRIALS.read('linesearch_loop')} (the re-entries)")
    check((status[good] == 1).all(), "J3: a feasible instance not at status 1")
    for i in J_BAD:
        check(res[i].status == 6 and res[i].certificate_found,
              f"J3: instance {i}: status {res[i].status} "
              f"({res[i].status_string!r})")
    check(entries["J3"]["linesearch_loop_batch_f64"] > 0
          and entries["J3"]["linesearch_loop_batch_f32"] > 0,
          "J3: linesearch_loop_batch (K15b) launched no kernel")
    return entries

# ---------------------------------------------------------------------------
# Phase L: solve_batch past one block's shared memory (K9L, K12L) and the
# batched polar projection (K5b, K6b)
# ---------------------------------------------------------------------------

L_SIDE = 250  # SDPLIB mcp250's side
L_SIZE = 16
L_OBJ_RTOL = 2e-4
L_F64_SIZE = 4
L_F64_ITERS = 300
L_F64_RTOL = 1e-6
L2_SIDE = 500  # SDPLIB mcp500's side
L2_SIZE = 40  # B > 32: the "auto" mode takes the subspace step
# L2's objectives against the JAX run's, each and on average, relative to
# 1 + |obj|: at side 500 the hybrid subspace mode's answers scatter ~4e-3
# between runs that differ only in the subspace step's rounding -- the
# port with K12 / K12L against the port with the plain version (cuBLAS,
# cuSOLVER) on the card: up to 3.40e-3, mean 1.12e-3; each against the
# JAX run up to 3.94e-3, mean 1.45e-3 (`--phase-l2-scatter`, PERF.md) --
# where phase G's sides 40 and 100 scatter ~1e-3 (G_OBJ_RTOL); the bounds
# sit ~1.5x above those readings, as phase G's do
L2_OBJ_RTOL = 6e-3
L2_OBJ_MEAN_RTOL = 2e-3
# the JAX package's solve_batch of the L instances on one CPU thread
# (tests/test_torch_reference_values.py::L_CHILD re-derives them, slow):
# L1, projection "eigh" under Options(tol_gap=1e-4, tol_feasibility=1e-4);
# L3, the same with Options(projection="polar"); L1's f64 program on
# instances 0-3 for L_F64_ITERS iterations; L2, projection "auto" at side
# 500, lined up with the port for C11 and C12 (its reseeds and programs)
L1_REF_OBJ = [1250.5705977860448, 1250.6867370153282, 1236.9364245486324,
    1244.909933316663, 1265.2657589221892, 1235.7032585367538,
    1254.1132416205385, 1255.9986235637741, 1252.8908344849456,
    1241.7469219869886, 1256.4342077862304, 1268.5049404856024,
    1244.1563574518123, 1279.7413688245765, 1238.2900940223496,
    1223.3301748272377]
L1_REF_ITERS = [599, 547, 578, 538, 595, 605, 591, 556, 574, 555, 594, 579, 610, 603,
    616, 584]
L3_REF_OBJ = [1250.5799186153952, 1250.691437740201, 1236.9250459663845,
    1244.9159085333774, 1265.2803424899496, 1235.708337830987,
    1254.1201161643908, 1256.005708649414, 1252.8873926109807,
    1241.7535339474525, 1256.4455492023064, 1268.5006661980603,
    1244.1600264967815, 1279.748029078369, 1238.2949464798214,
    1223.3170553208845]
L3_REF_ITERS = [599, 547, 579, 538, 595, 605, 593, 556, 575, 555, 594, 580, 611, 603,
    616, 585]
L1_F64_REF = {
    "obj": [1243.7927710468, 1246.0445274725107, 1234.7806416374776, 1241.782078781181],
    "xnorm": [61.47779406674972, 64.14378768945117, 63.18034179023062, 63.55354830112831]}
L2_REF_OBJ = [3615.8433905879015, 3614.850894753789, 3632.513245579528,
    3661.165076914528, 3654.09515854805, 3629.9605392232083,
    3615.4464726926626, 3618.5831557807796, 3642.0358147590764,
    3591.3198280845177, 3590.97961619432, 3644.552666861177,
    3641.102896298311, 3654.853382499658, 3638.0301387152385,
    3696.359290464876, 3632.2717256604456, 3624.0469612105494,
    3642.5347477739383, 3628.770360731356, 3632.328910870525,
    3568.39895574957, 3617.3835310155187, 3624.0774511269947,
    3637.116832546995, 3653.4180235104864, 3612.6214907552876,
    3627.4983426336025, 3644.5338022782207, 3606.2346515581357,
    3610.1966655091337, 3624.53315554426, 3581.918823750074,
    3627.5520854213573, 3615.9384665776292, 3588.6270218878867,
    3634.6576251373344, 3583.789203004272, 3630.055063016431,
    3641.405733850178]
L2_REF_ITERS = '839/1382/1846'
L2_REF_RESEEDS = [
    ('float32', 128, 128, 16, 40, 83), ('float32', 128, 128, 96, 40, 83),
    ('float32', 703, 1152, 96, 40, 13), ('float32', 703, 1152, 24, 40, 13),
    ('float32', 703, 1620, 24, 5, 13), ('float64', 703, 1620, 24, 40, 13),
    ('float64', 839, 1727, 24, 2, 13)]
L2_REF_PROGRAMS = [('float32', 16), ('float32', 96), ('float32', 24),
                   ('float64', 24)]
# K9L's f32 rows: K9L works an f32 input in f64 and rounds its outputs
# (its f32 Jacobi lay 1.3e-4 to 9.9e-4 of the scale from cuSOLVER at sides
# 169-500 and moved phase L1's answers: ROADMAP C22), its plain version is
# the f32 eigh (cuSOLVER on the card; LAPACK's, as the JAX package's, on
# the CPU), so the rows measure the f32 eigh's own distance from an f64
# one, relative to the largest entry: on two input draws 2.75e-4 / 3.09e-4
# at side 169, 5.12e-4 / 5.68e-4 at 250 and 1.69e-3 / 1.71e-3 at 500
# (`tools/phase_l_diagnostics.py rows 12 13`, PERF.md), up to 3.4e-6 a
# unit of side; the bound is twice that, times the side
EIGH_RTOL_F32_L = 7e-6
# K12L at side 500 against its plain version, relative to the largest
# entry: f64 as K12's rows; f32 and the mixed mode's f32 basis sum 500-term
# products and rotate up to 128 columns, and the readings grow with k to
# 1.44e-4 (f32, k = 128): twice the largest reading of two draws (PERF.md)
SUB_RTOL_L = {"f64": 1e-10, "f32": 3e-4, "f64_f32": 3e-4}
# past k = 128 (buckets 192 and 256) the f32 readings grow on, to 2.90e-4
# (k = 192) and 5.01e-4 (256): twice the largest reading of two draws.
# There the plain version's f32 k x k eigh (cuSOLVER's) is itself the far
# one: K12 with its Jacobi worked in f64 (exact for its f32 Rayleigh
# matrix) read 4.3e-4 to 7.6e-4 of the scale from it on theta (PR 10,
# PERF.md), so it misorders Ritz pairs closer than ~1.5e-3 of the scale
# (a mixed row's Ritz vector read 1 - |cos| = 0.129 against it, the same
# with either Jacobi).  So the bases are held only where a Ritz value
# lies 1e-2 of the scale from its neighbours, where 1 - |cos| <= (7.6e-4 /
# 1e-2)^2 / 2 = 2.9e-3 bounds an error of that size: the mixed mode's to
# 3e-2 (readings to 1.32e-2 with the 1e-3 separation), the f32 mode's to
# its 1e-3
SUB_WIDE_K = 128
SUB_RTOL_L_WIDE = {"f64": 1e-10, "f32": 1e-3, "f64_f32": 3e-4}
SUB_SEP_L_WIDE = 1e-2
SUB_VEC_RTOL_L_WIDE = 3e-2
# the mixed mode's f64 Ritz values at side 500 against the plain
# version's, relative to the largest entry: at side 500 both f32 k x k
# eigensolvers (Jacobi, cuSOLVER) leave them 1e-8 to 3.7e-6 of the scale
# from the exact eigenvalues (K12 at sides 40-100: 3e-8, SUB_THETA_RTOL),
# so the bound is set above the readings of two draws (PERF.md)
SUB_THETA_RTOL_L = 1e-5


def theta_exact_err(torch, out, v, side, scale):
    """The largest distance, relative to ``scale``, between a K12 output's
    positive Ritz values (recovered as in ``theta_err``, sorted) and the k
    largest eigenvalues of X (f64, torch.linalg.eigvalsh, clamped at 0),
    over the instances the guard passed."""
    from proxsdp_tpu_torch import kernels

    blk, _, _, warm, bad, _ = out
    k = warm.shape[2]
    W = warm.double()
    Xp = kernels.tri_to_square_plain(blk.double(), side)
    th = torch.einsum("bik,bij,bjk->bk", W, Xp, W) / torch.sum(W * W, 1) ** 2
    X = kernels.tri_to_square_plain(torch.nan_to_num(v).double(), side)
    top = torch.linalg.eigvalsh(X)[:, -k:].clamp_min(0.0)
    ok = ~bad
    return float((th.sort(dim=1).values[ok] - top[ok]).abs().max()) / scale
# phase L's K9L sides: the first past each of K9's caps, L1's, L2's
L_EIGH_SIDES = (119, 169, 250, 500)
L_EIGH_B = 16
# K12L at side 500: buckets 24-256 and L2's path (f32 k = 96, the mixed
# f64 polish at k = 24)
L_SUB_KS = (24, 32, 48, 64, 96, 128, 192, 256)
# rows checked but not timed, to keep the script inside its time limit
# (phase M's cost): K9L at side 500 and K12L at k = 192 and 256, shapes no
# path runs (L2 stays on the subspace step at k <= 96); their earlier
# times stand in PERF.md's kernel table
L_UNTIMED_SIDES = (500,)
L_UNTIMED_KS = (192, 256)


def _l_maxcut(side, B):
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights

    return [maxcut_problem(random_graph_weights(s, side)) for s in range(B)]


def large_kernel_checks(torch, kernels, rng, dev):
    """Phase B rows of phase L's kernels: K9L (batched_psd_eigh past K9's
    shared memory) at L_EIGH_SIDES in f64 and, past side 168, f32; K12L
    (batched_subspace on a device-memory working set) at side 500, B = 40,
    k in L_SUB_KS in f32, the mixed mode and f64 (K12 where the shape fits
    one block: L2's f32 k = 24); K5b and K6b (the polar projection's batched entry points)
    at L1's (16, 250, 250) in f32 and f64.  Each against its plain
    version, timed beside it and the library call."""
    rows = []
    for sfx, dt in (("f64", torch.float64), ("f32", torch.float32)):
        for s in L_EIGH_SIDES:
            if s <= kernels.EIGH_MAX_SIDE[dt]:
                continue
            X = eigh_inputs(torch, rng, s, dt, dev, L_EIGH_B)
            nb = X.shape[0]
            outs = (torch.empty_like(X), torch.empty(nb, s, dtype=dt, device=dev),
                    torch.empty(nb, dtype=torch.int32, device=dev),
                    torch.empty(nb, s, dtype=dt, device=dev))
            tol = EIGH_RTOL_F32_L * s if sfx == "f32" else EIGH_RTOL[sfx]

            def library(Xf=torch.nan_to_num(X)):
                w, V = torch.linalg.eigh(Xf)
                return torch.matmul(V * w.clamp_min(0)[:, None, :], V.mT)

            check_entry(
                torch, kernels, rows, "batched_psd_eigh_large", sfx,
                "batched_eigh_large.cu", "proxsdp_tpu/ops/cones.py:622",
                lambda f, X=X: f(X, TOL_PSD), kernels.batched_psd_eigh_plain,
                (X,), outs, nb * 10.5 * s ** 3, library=library,
                compare_fn=eigh_compare(torch, X, tol), tol=tol,
                label=f"L: side {s}", wrapper="batched_psd_eigh",
                timed=s not in L_UNTIMED_SIDES)
            if s == L_SIDE:  # L1's shape: device time under the profiler
                LAUNCH_US.append((
                    f"batched_psd_eigh_large_{sfx} (L: side {s})",
                    lambda X=X: kernels.batched_psd_eigh(X, TOL_PSD),
                    "batched_psd_eigh_large_kernel"))
    B, side = L2_SIZE, L2_SIDE
    tl = side * (side + 1) // 2
    # subspace_inputs' matrices, made once (a QR of B side x side draws),
    # with a basis for each k: random, or spanning the top k eigenvectors
    # (rotated at random) for the mixed mode
    Qx, _ = np.linalg.qr(rng.standard_normal((B, side, side)))
    w = rng.standard_normal((B, side))
    w[:, :6] = 5.0 + 3.0 * rng.random((B, 6))
    Xl = (Qx * w[:, None, :]) @ Qx.transpose(0, 2, 1)
    Xl[2] = 0.0
    v64 = kernels.square_to_tri_plain(torch.tensor(Xl), side)
    v64[1, 3] = float("nan")
    order = np.argsort(-w, axis=1)
    for sfx in ("f32", "f64_f32", "f64"):
        dt = torch.float32 if sfx == "f32" else torch.float64
        mixed = sfx == "f64_f32"
        v = v64.to(dt).to(dev)
        for k in L_SUB_KS:
            # K12 where the shape fits one block (L2's f32 k = 24), else K12L
            k12 = (k <= kernels.SUBSPACE_MAX_K and kernels.subspace_smem_bytes(
                side, k, dt, mixed) <= kernels.SUBSPACE_SMEM_BYTES)
            if mixed:
                Vn = np.take_along_axis(Qx, order[:, None, :k], axis=2) \
                    @ np.linalg.qr(rng.standard_normal((B, k, k)))[0]
            else:
                Vn = np.linalg.qr(rng.standard_normal((B, side, k)))[0]
            V = torch.tensor(Vn, dtype=dt, device=dev)
            theta = {} if mixed else None
            wide = k > SUB_WIDE_K and sfx != "f64"
            rtol = SUB_RTOL_L_WIDE if wide else SUB_RTOL_L
            vec = dict(sep=SUB_SEP_L_WIDE) if wide else {}
            if wide and mixed:
                vec["vec_tol"] = SUB_VEC_RTOL_L_WIDE
            Xs = torch.nan_to_num(kernels.tri_to_square_plain(v, side))

            def library(Xs=Xs, V=V):
                Q = torch.linalg.qr(torch.bmm(Xs, V)).Q
                th, U = torch.linalg.eigh(torch.bmm(Q.mT, torch.bmm(Xs, Q)))
                W = torch.bmm(Q, U)
                return torch.bmm(W * th.clamp_min(0)[:, None, :], W.mT)

            outs = (torch.empty(B, tl, dtype=dt, device=dev),
                    torch.empty_like(V), torch.empty(B, 5, dtype=dt, device=dev))
            flops = B * (6 * side * side * k + 14 * side * k * k + 10 * k ** 3)
            check_entry(
                torch, kernels, rows,
                "batched_subspace" if k12 else "batched_subspace_large", sfx,
                "batched_subspace.cu", "proxsdp_tpu/ops/cones.py:427",
                lambda f, v=v, V=V, m=mixed: f(v, V, side, TOL_PSD, m),
                kernels.batched_subspace_plain, (v, V), outs, flops,
                library=library,
                compare_fn=subspace_compare(torch, v, V, side,
                                            rtol[sfx], theta,
                                            SUB_THETA_RTOL_L, **vec),
                tol=rtol[sfx], label=f"L: B = {B}, side {side}, k = {k}",
                wrapper="batched_subspace", timed=k not in L_UNTIMED_KS)
            if (sfx, k) in (("f32", 96), ("f64_f32", 24)):  # L2's K12L shapes
                LAUNCH_US.append((
                    f"batched_subspace_large_{sfx} (L: k = {k})",
                    lambda v=v, V=V, m=mixed, sd=side: kernels.batched_subspace(
                        v, V, sd, TOL_PSD, m),
                    "batched_subspace_kernel"))
            if mixed:
                print(f"kernel batched_subspace{'' if k12 else '_large'}"
                      f"_f64_f32 (L: k = {k}) "
                      f"Ritz values on converged bases {theta['kernel']:.3e} "
                      f"of the scale from the plain version's (tol "
                      f"{SUB_THETA_RTOL_L:.0e}); from the exact eigenvalues: "
                      f"kernel {theta['exact'][0]:.3e}, plain "
                      f"{theta['exact'][1]:.3e}")
    from proxsdp_tpu_torch.ops.cones import POLAR_QB, POLAR_QC, polar_psd_batch

    B, side = L_SIZE, L_SIDE
    for sfx, dt in (("f32", torch.float32), ("f64", torch.float64)):
        X = eigh_inputs(torch, rng, side, dt, dev, B)
        Xf = torch.nan_to_num(X)
        Y = kernels.fro_scale_batch_plain(Xf)
        A2 = torch.matmul(Y, Y)
        out3 = torch.empty_like(X)
        flag = (torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev))
        for name, call, plain, ins, outs, flops, lib in (
                # QB A + QC (A @ A), the quintic step's middle product
                ("ns_gemm_batch", lambda f: f(A2, A2, A2, POLAR_QB, POLAR_QC),
                 kernels.ns_gemm_batch_plain, (A2,), (out3,),
                 2 * B * side ** 3, lambda: torch.bmm(A2, A2)),
                ("fro_scale_batch", lambda f: f(Xf),
                 kernels.fro_scale_batch_plain, (Xf,), (out3,),
                 3 * B * side * side, None),
                ("sym_batch", lambda f: f(Y), kernels.sym_batch_plain, (Y,),
                 (out3,), 2 * B * side * side, None),
                ("sym_guard_batch", lambda f: f(A2, Y, X),
                 kernels.sym_guard_batch_plain, (A2, Y, X), (out3, *flag),
                 2 * B * side * side, None)):
            check_entry(torch, kernels, rows, name, sfx,
                        "ns_gemm.cu" if name == "ns_gemm_batch"
                        else "polar_sym.cu", "proxsdp_tpu/ops/cones.py:62",
                        call, plain, ins, outs, flops, library=lib,
                        label=f"L: B = {B}, side {side}")
        LAUNCH_US.append((
            f"ns_gemm_batch_{sfx} (L: B = {B}, side {side})",
            lambda A2=A2: kernels.ns_gemm_batch(A2, A2, A2, POLAR_QB,
                                                POLAR_QC),
            "gemm_axpby_kernel"))
        # the whole projection: 30 products of 2 s^3 flops an instance
        ms = median_ms(torch, lambda: polar_psd_batch(X, aggressive=7, polish=4))
        bound = 30 * 2 * B * side ** 3 / PEAK_FLOPS[sfx] * 1e3
        print(f"polar_psd_batch {sfx} (L: B = {B}, side {side}): {ms:.4f} ms "
              f"a projection, bound {bound * 1e3:.3f} us (30 products)")
    return rows


# the polar engine's answers are PSD to its schedule's inexactness: the
# default (7, 4) Newton-Schulz sign projects eigenvalues below ~9e-5
# ||X||_F only approximately (cones.py:74-78), so L3's lambda_min(X) is
# held to -1e-4 ||X||_F, the eigh and subspace answers to phase D's -1e-6
L_POLAR_PSD_TOL = 1e-4


def _l_checks(tag, res, setups, Xidx, ref_obj, rtol, mean_rtol=None,
              psd_tol=1e-6):
    """Statuses, max|diag(X) - 1| against each instance's bound,
    lambda_min(X) >= -psd_tol ||X||_F, the objectives against ``ref_obj``
    (each to ``rtol``, on average to ``mean_rtol``) relative to 1 +
    |obj|."""
    status = np.array([r.status for r in res])
    X = np.stack([r.primal[Xidx] for r in res])
    diag_err = np.abs(np.diagonal(X, axis1=1, axis2=2) - 1.0).max(axis=1)
    diag_tol = np.array([1e-4 * (1.0 + s.norm_b) * s.rhs_scale for s in setups])
    lam_min = np.linalg.eigvalsh(X)[:, 0]
    fro = np.linalg.norm(X, axis=(1, 2))
    ref = np.array(ref_obj)
    dev = np.abs(np.array([r.objval for r in res]) - ref) / (1.0 + np.abs(ref))
    print(f"phase {tag} checks: statuses "
          f"{dict(zip(*np.unique(status, return_counts=True)))}; max|diag(X)-1|"
          f" worst {diag_err.max():.3e} (its bound "
          f"{diag_tol[diag_err.argmax()]:.3e}), min lambda_min(X)/||X||_F "
          f"{float((lam_min / fro).min()):.3e}; objectives vs the JAX batch: "
          f"max |diff|/(1+|ref|) {dev.max():.3e} (bound {rtol:.1e}), mean "
          f"{dev.mean():.3e}" + (f" (bound {mean_rtol:.0e})" if mean_rtol else ""))
    check((status == 1).all(), f"{tag}: not every instance reached status 1")
    check((diag_err <= diag_tol).all(), f"{tag}: max|diag(X)-1| above the "
          f"bound for {int((diag_err > diag_tol).sum())} instances")
    check((lam_min >= -psd_tol * fro).all(), f"{tag}: lambda_min(X) < "
          f"-{psd_tol} ||X||_F for {int((lam_min < -psd_tol * fro).sum())} "
          "instances")
    check((dev <= rtol).all(), f"{tag}: objectives of instances "
          f"{np.nonzero(dev > rtol)[0].tolist()} differ from the JAX batch's "
          f"by more than {rtol} (1 + |obj|)")
    check(mean_rtol is None or dev.mean() <= mean_rtol,
          f"{tag}: mean objective deviation {dev.mean():.3e} > {mean_rtol}")


# the kernels whose launches phase L prints
L_KERNELS = ("batched_psd_eigh_large", "batched_subspace_large",
             "ns_gemm_batch", "fro_scale_batch", "sym_batch", "sym_guard_batch",
             "batched_psd_eigh", "batched_subspace")


def _l_run(torch, kernels, tag, smi, probs, opts, names=None, **kw):
    """One counted solve_batch: the launch counts set to 0 just before it
    and read just after; prints seconds, instances/s, steps and the
    launches of each kernel of ``names`` (default L_KERNELS).  Returns
    (results, entries, shapes, stats)."""
    from proxsdp_tpu_torch import solve_batch
    from proxsdp_tpu_torch.parallel import batch as tbatch

    stats = tbatch.BatchStats()
    kernels.reset_launch_counts()
    SHAPES.reset()
    t0 = time.perf_counter()
    res = solve_batch(probs, opts, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entries = dict(kernels.launch_counts)
    shapes = collections.Counter(SHAPES.counts)
    iters = np.array([r.iter for r in res])
    print(f"phase {tag} (solve_batch, B = {len(res)}) on {smi}: {wall:.3f} s, "
          f"{len(res) / wall:.3f} instances/s; f32 race {stats.race_iters} "
          f"iterations ({stats.race_seconds:.3f} s), final phase "
          f"{stats.final_seconds:.3f} s, program steps {stats.steps}; "
          f"iterations min/median/max {iters.min()}/{int(np.median(iters))}/"
          f"{iters.max()}; launches " + json.dumps(
              {e: n for e, n in entries.items()
               if n and e.rsplit("_f", 1)[0] in (names or L_KERNELS)}))
    return res, entries, shapes, stats


def phase_l(torch, kernels, smi):
    """L1: 16 side-250 max-cut instances, projection "eigh" (K9L in the
    f32 race and the f64 phase), against the JAX batch; its f64 program on
    instances 0-3 for L_F64_ITERS iterations against the JAX package's.
    L2: 40 side-500 instances, projection "auto" (the subspace mode: K12L
    past one block's shared memory), against the JAX run lined up for C11
    and C12, its reseeds and programs printed beside the JAX run's.  L3:
    L1's instances under Options(projection="polar") (K5b, K6b).  Returns
    {tag: (entries, shapes)} of the counted runs."""
    from proxsdp_tpu_torch import Options, solve_batch
    from proxsdp_tpu_torch.problem import preprocess

    out = {}
    base = Options(tol_gap=1e-4, tol_feasibility=1e-4)
    l1 = _l_maxcut(L_SIDE, L_SIZE)
    probs, Xidx = [p for p, _ in l1], l1[0][1]
    setups = [preprocess(p) for p in probs]
    t = time.perf_counter()
    res, entries, shapes, _ = _l_run(torch, kernels, "L1", smi, probs, base,
                                     projection="eigh")
    print(f"phase L1 iterations {[r.iter for r in res]} (JAX {L1_REF_ITERS})")
    _l_checks("L1", res, setups, Xidx, L1_REF_OBJ, L_OBJ_RTOL)
    for sfx in ("f32", "f64"):
        check(entries[f"batched_psd_eigh_large_{sfx}"] > 0,
              f"L1: K9L launched no {sfx} kernel")
    out["L1"] = (entries, shapes)
    # the f64 program against the JAX package's iterate
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_batch(probs[:L_F64_SIZE], base.replace(
        hybrid_precision=False, max_iter=L_F64_ITERS), projection="eigh")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d_obj = np.abs(np.array([r.objval for r in res])
                   / np.array(L1_F64_REF["obj"]) - 1.0)
    d_x = np.abs(np.array([np.linalg.norm(r.primal) for r in res])
                 / np.array(L1_F64_REF["xnorm"]) - 1.0)
    print(f"phase L1 f64 (instances 0-{L_F64_SIZE - 1}, hybrid_precision="
          f"False, {L_F64_ITERS} iterations) on {smi}: {wall:.2f} s; objective"
          f" vs the JAX f64 program: max relative {d_obj.max():.3e}, ||x|| "
          f"{d_x.max():.3e} (bound {L_F64_RTOL:.0e}); K9L f64 launches "
          f"{kernels.launch_counts['batched_psd_eigh_large_f64']}")
    check(all(r.status == 3 and r.iter == L_F64_ITERS for r in res),
          "L1 f64: not at the iteration limit")
    check(max(d_obj.max(), d_x.max()) <= L_F64_RTOL,
          "L1 f64: the f64 program parts from the JAX package's")
    check(kernels.launch_counts["batched_psd_eigh_large_f64"] > 0,
          "L1 f64: K9L launched no f64 kernel")
    print(f"phase L1: {time.perf_counter() - t:.1f} s")

    # ---- L3: the polar engine on L1's instances
    t = time.perf_counter()
    res, entries, shapes, _ = _l_run(torch, kernels, "L3", smi, probs,
                                     base.replace(projection="polar"),
                                     projection="eigh")
    print(f"phase L3 iterations {[r.iter for r in res]} (JAX {L3_REF_ITERS})")
    _l_checks("L3", res, setups, Xidx, L3_REF_OBJ, L_OBJ_RTOL,
              psd_tol=L_POLAR_PSD_TOL)
    for name in ("ns_gemm_batch", "fro_scale_batch", "sym_batch",
                 "sym_guard_batch"):
        for sfx in ("f32", "f64"):
            check(entries[f"{name}_{sfx}"] > 0,
                  f"L3: {name}_{sfx} launched no kernel")
    check(entries["batched_psd_eigh_large_f32"] == 0
          and entries["batched_psd_eigh_large_f64"] == 0,
          "L3: the eigh ran under the polar engine")
    out["L3"] = (entries, shapes)
    print(f"phase L3: {time.perf_counter() - t:.1f} s")

    # ---- L2: the subspace mode at side 500
    t = time.perf_counter()
    l2 = _l_maxcut(L2_SIDE, L2_SIZE)
    probs2, Xidx2 = [p for p, _ in l2], l2[0][1]
    res, entries, shapes, stats = _l_run(torch, kernels, "L2", smi, probs2,
                                         base)
    it2 = [r.iter for r in res]
    print(f"phase L2 iterations {min(it2)}/{int(np.median(it2))}/{max(it2)} "
          f"(JAX {L2_REF_ITERS})")
    print(f"phase L2 reseeds (dtype, min iter, max iter, k, masked, r_max): "
          f"{stats.reseeds}; JAX: {L2_REF_RESEEDS}")
    programs = [(d, k) for d, _, k in stats.programs]
    print(f"phase L2 programs (dtype, k): {programs}; JAX: {L2_REF_PROGRAMS}")
    if [tuple(r) for r in stats.reseeds] != L2_REF_RESEEDS \
            or programs != L2_REF_PROGRAMS:
        print("phase L2 FINDING: the reseed or program sequence differs from "
              "the JAX run's (C14)")
    check(sum(entries[f"batched_subspace_large_{sfx}"]
              for sfx in ("f32", "f64", "f64_f32")) > 0,
          "L2: K12L launched no kernel")
    _l_checks("L2", res, [preprocess(p) for p in probs2], Xidx2, L2_REF_OBJ,
              L2_OBJ_RTOL, L2_OBJ_MEAN_RTOL)
    out["L2"] = (entries, shapes)
    print(f"phase L2: {time.perf_counter() - t:.1f} s")
    return out


def phase_l_rows(rows, runs):
    """Each phase-L row's launches: K9L's at its shape in L1, K12L's and
    K12's at their shape in L2, K5b's and K6b's their entry point's in L3;
    (rows for the kernels line, rows left off it: not launched at their
    shape)."""
    k9l = [r for r in rows if r["name"].startswith("batched_psd_eigh_large")]
    k12l = [r for r in rows if r["name"].startswith("batched_subspace")]
    polar = [r for r in rows if r not in k9l and r not in k12l]
    kept, left = [], []
    for group, tag in ((k9l, "L1"), (k12l, "L2"), (polar, "L3")):
        entries, shapes = runs[tag]
        a, b = assign_launches(group, shapes, entries)
        kept += a
        left += b
    return kept, left


def k_setups(torch):
    """Phase K's sweeps: (K1 problems, K1 randsdp data, K3 problems, the
    shared index matrix of a side-40 block)."""
    from proxsdp_tpu_torch import Optimizer
    from proxsdp_tpu_torch.models.maxcut import random_graph_weights
    from proxsdp_tpu_torch.models.randsdp import randsdp_problem

    built = [randsdp_problem(s, K1_SIDE, K1_ROWS, varbounds=False)
             for s in range(K1_SIZE)]
    k3 = k3_problems(Optimizer, random_graph_weights)
    return ([b[0] for b in built], [b[2] for b in built], k3,
            built[0][1])


def k_kernel_checks(torch, kernels, rng, dev, k1, k3):
    """Phase B rows of phase K: K16 (both directions) at K1's per-instance
    dense operator, K1b' (K1's batched entry point with a value stride)
    at K3's stacked ELL values, K15b' over K3's per-instance ELL (bit for
    bit its plain loop in f64) and K1's per-instance dense M' (RTOL), in
    f32 (the race) and f64; (rows on the path, K16's M' y row: the plain
    loop's part, on the path only inside K15b')."""
    from proxsdp_tpu_torch.parallel.batch import _batch_operands, operator_kind
    from proxsdp_tpu_torch.problem import preprocess

    rows, off_path = [], []
    s1 = [preprocess(p) for p in k1]
    s3 = [preprocess(p) for p in k3]
    for sfx, dt in (("f64", torch.float64), ("f32", torch.float32)):
        o1 = _batch_operands(s1, dt, dev, "auto")
        o3 = _batch_operands(s3, dt, dev, "auto")
        check(operator_kind(o1.M) == "dense_batched"
              and operator_kind(o3.M) == "ell_batched",
              f"K: operators {operator_kind(o1.M)}, {operator_kind(o3.M)}")
        M = o1.M.mat
        B, R, n = M.shape
        X = torch.tensor(rng.standard_normal((B, n)), dtype=dt, device=dev)
        Y = torch.tensor(rng.standard_normal((B, R)), dtype=dt, device=dev)
        label = f"K1: B = {B}, {R} x {n} per instance"
        check_entry(torch, kernels, rows, "batched_gemv", sfx,
                    "batched_gemv.cu", "proxsdp_tpu/ops/linop.py:44",
                    lambda f: f(M, X), kernels.batched_gemv_plain, (M, X),
                    (torch.empty(B, R, dtype=dt, device=dev),), 2 * B * R * n,
                    library=lambda: torch.bmm(M, X.unsqueeze(-1)), label=label)
        check_entry(torch, kernels, off_path, "batched_gemv_t", sfx,
                    "batched_gemv.cu", "proxsdp_tpu/ops/linop.py:47",
                    lambda f: f(M, Y), kernels.batched_gemv_t_plain, (M, Y),
                    (torch.empty(B, n, dtype=dt, device=dev),), 2 * B * R * n,
                    library=lambda: torch.bmm(Y.unsqueeze(1), M), label=label,
                    note=" (M' y: on the path inside K15b')")
        E = o3.M
        B3, n3 = E.row_vals.shape[0], E.shape[1]
        x3 = torch.tensor(rng.standard_normal((B3, n3)), dtype=dt, device=dev)
        y3 = torch.tensor(rng.standard_normal((B3, E.shape[0])), dtype=dt,
                          device=dev)
        # library: none (no one PyTorch call multiplies B sparse matrices
        # of one pattern, each by its own vector)
        check_entry(torch, kernels, rows, "ell_spmv_batch", sfx, "ell_spmv.cu",
                    "proxsdp_tpu/ops/linop.py:123",
                    lambda f: (f(E.row_cols, E.row_vals, x3),
                               f(E.col_rows, E.col_vals, y3)),
                    kernels.ell_spmv_batch_plain,
                    (E.row_cols, E.row_vals, x3, E.col_rows, E.col_vals, y3),
                    (torch.empty(B3, E.shape[0], dtype=dt, device=dev),
                     torch.empty(B3, n3, dtype=dt, device=dev)),
                    2 * (E.row_vals.numel() + E.col_vals.numel()),
                    tol=0.0, label=f"K3: B = {B3}, values per instance")
        lay1, lay3 = s1[0].layout, s3[0].layout
        linesearch_batch_row(torch, kernels, rows, o3, lay3.p, lay3.m, sfx, dt,
                             dev, np.random.default_rng(12),
                             f"K3: B = {B3}, ELL per instance")
        linesearch_batch_row(torch, kernels, rows, o1, lay1.p, lay1.m, sfx, dt,
                             dev, np.random.default_rng(13),
                             f"K1: B = {B}, dense per instance", exact=False)
    return rows, off_path


def _rel_dev(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got)[:len(want)] - want) / (1 + np.abs(want))


def _optimizer_of(module, build, *args):
    """(the Optimizer a model builder filled, what the builder returned):
    the builders return the built problem only, and phase K2 solves
    through Optimizer.optimize."""
    made = []

    class Kept(module.Optimizer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    original = module.Optimizer
    module.Optimizer = Kept
    try:
        out = build(*args)
    finally:
        module.Optimizer = original
    return made[0], out


def phase_k(torch, kernels, smi, k1, k1_data, k3, Xidx):
    """K1 (randsdp, dense_batched) and K3 (scaled max-cut, ell_batched):
    solve_batch of K1_SIZE and K3_SIZE instances; K2: the API on the card
    (MIMO and sensor localisation through Optimizer.optimize, one
    solve_cone_program and one solve_sdp).  Returns the launches by entry point and the
    per-instance launches of each sweep."""
    from proxsdp_tpu_torch import (ConeDims, Options, solve_batch,
                                   solve_cone_program, solve_sdp)
    from proxsdp_tpu_torch.models import mimo, sensorloc
    from proxsdp_tpu_torch.models.randsdp import randsdp_eval
    from proxsdp_tpu_torch.parallel import batch as tbatch
    from proxsdp_tpu_torch.problem import preprocess

    out = {}
    for tag, probs, ref_obj, ref_iters, kind, tol in (
            ("K1", k1, K1_REF_OBJ, K1_REF_ITERS, "dense_batched", K1_TOL),
            ("K3", k3, K3_REF_OBJ, K3_REF_ITERS, "ell_batched", 1e-4)):
        opts = Options(tol_gap=tol, tol_feasibility=tol)
        setups = [preprocess(p) for p in probs]
        stats = tbatch.BatchStats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve_batch(probs, opts, projection="eigh", stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[tag] = (dict(kernels.launch_counts),
                    dict(kernels.per_instance_launches))
        B = len(res)
        status = np.array([r.status for r in res])
        iters = np.array([r.iter for r in res])
        X = np.stack([r.primal[Xidx] for r in res])
        lam_min = np.linalg.eigvalsh(X)[:, 0]
        fro = np.linalg.norm(X, axis=(1, 2))
        # max |A x - b| against the solver's own bound (preprocess's rhs
        # scale): the test it declares on
        viol = np.array([np.abs(p.A @ r.primal - p.b).max()
                         for p, r in zip(probs, res)])
        bound = np.array([opts.tol_feasibility * (1 + s.norm_b) * s.rhs_scale
                          for s in setups])
        obj = np.array([r.objval for r in res])
        ref = np.array(ref_obj)
        dev = np.abs(obj[:len(ref)] - ref) / (1 + np.abs(ref))
        extra = ""
        if tag == "K1":
            rel = np.array([max(abs(v) / (1 + abs(d[1][k]))
                                for k, v in enumerate(randsdp_eval(
                                    d[0], d[1], d[2], x)[3]))
                            for d, x in zip(k1_data, X)])
            exact = np.array(K1_EXACT_OBJ)
            extra = (f"; vs the optimum: max {_rel_dev(obj, exact).max():.3e}"
                     f" (the JAX batch's {_rel_dev(ref, exact).max():.3e}; "
                     "C19: not held); randsdp's relative violation max_k "
                     f"|<A_k, X> - b_k| / (1 + |b_k|): max {rel.max():.3e}, "
                     f"median {np.median(rel):.3e}")
        print(f"phase {tag} (solve_batch, B = {B}, {kind}, Options(tol_gap="
              f"{tol:.0e}, tol_feasibility={tol:.0e}), projection 'eigh') on "
              f"{smi}: "
              f"{wall:.3f} s, {B / wall:.2f} instances/s; f32 race "
              f"{stats.race_iters} iterations ({stats.race_seconds:.3f} s), "
              f"final phase {stats.final_seconds:.3f} s, program steps "
              f"{stats.steps}; statuses "
              f"{dict(zip(*np.unique(status, return_counts=True)))}; "
              f"iterations min/median/max {iters.min()}/"
              f"{int(np.median(iters))}/{iters.max()} (JAX, instances 0-7: "
              f"{ref_iters})")
        print(f"phase {tag} checks: max|A x - b| worst {viol.max():.3e} "
              f"(its bound {bound[viol.argmax()]:.3e}), min over instances of "
              f"lambda_min(X)/||X||_F {float((lam_min / fro).min()):.3e}; "
              f"objectives of instances 0-{len(ref) - 1} vs the JAX batch "
              f"solve: max |diff|/(1+|ref|) {dev.max():.3e}"
              + (f" (bound {K_OBJ_RTOL:.0e})" if tag == "K3" else " (not held)")
              + f", mean {dev.mean():.3e}" + extra)
        print(f"phase {tag} objectives 0-{len(ref) - 1}: "
              + json.dumps(obj[:len(ref)].tolist()))
        print(f"phase {tag} launches: " + json.dumps(
            {e: n for e, n in out[tag][0].items() if n})
            + "; with per-instance operator values: "
            + json.dumps(out[tag][1]))
        check((status == 1).all(), f"{tag}: not every instance reached "
              "status 1")
        check((viol <= bound).all(), f"{tag}: max|A x - b| above the solver's"
              f" bound for {int((viol > bound).sum())} instances")
        check((lam_min >= -1e-6 * fro).all(),
              f"{tag}: lambda_min(X) < -1e-6 ||X||_F for "
              f"{int((lam_min < -1e-6 * fro).sum())} instances")
        check(tag == "K1" or (dev <= K_OBJ_RTOL).all(),
              f"{tag}: objectives of instances "
              f"{np.nonzero(dev > K_OBJ_RTOL)[0].tolist()} differ from the "
              f"JAX batch solve by more than {K_OBJ_RTOL} (1 + |obj|)")
        for sfx in ("f32", "f64"):
            check(out[tag][1][f"linesearch_loop_batch_{sfx}"] > 0,
                  f"{tag}: K15b' launched no per-instance kernel in {sfx}")
            check(out[tag][0]["batched_gemv_" + sfx] > 0 if tag == "K1" else
                  out[tag][1][f"ell_spmv_batch_{sfx}"] > 0,
                  f"{tag}: its operator's M x kernel not launched in {sfx}")

    # ---- K1's f64 program, instances 0-7, against the JAX package's
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_batch(k1[:8], Options(tol_gap=1e-4, tol_feasibility=1e-4,
                                      hybrid_precision=False,
                                      max_iter=K1_F64_ITERS),
                      projection="eigh")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.per_instance_launches)
    got_obj = np.array([r.objval for r in res])
    got_x = np.array([np.linalg.norm(r.primal) for r in res])
    d_obj = np.abs(got_obj / np.array(K1_F64_REF["obj"]) - 1.0)
    d_x = np.abs(got_x / np.array(K1_F64_REF["xnorm"]) - 1.0)
    print(f"phase K1 f64 (instances 0-7, hybrid_precision=False, "
          f"{K1_F64_ITERS} iterations) on {smi}: {wall:.2f} s; statuses "
          f"{[r.status for r in res]}; objective vs the JAX f64 program: max "
          f"relative {d_obj.max():.3e}, ||x|| {d_x.max():.3e} (bound "
          f"{K1_F64_RTOL:.0e}); K15b' launches {launches}")
    check(all(r.status == 3 and r.iter == K1_F64_ITERS for r in res),
          "K1 f64: not at the iteration limit")
    check(max(d_obj.max(), d_x.max()) <= K1_F64_RTOL,
          "K1 f64: the f64 program parts from the JAX package's")
    check(launches["linesearch_loop_batch_f64"] > 0, "K1 f64: no K15b'")

    # ---- K2: the API on the card
    kernels.reset_launch_counts()
    t_k2 = time.perf_counter()
    for label, kw, ref in (
            ("MIMO default", dict(chunk_iters=256), K2_MIMO_REF),
            ("MIMO f64", dict(chunk_iters=256, hybrid_precision=False),
             K2_MIMO64_REF)):
        opt, (problem, X_m, s_true) = _optimizer_of(
            mimo, mimo.mimo_problem, 0, K2_MIMO_N)
        t0 = time.perf_counter()
        res = opt.optimize(max_iter=K2_MIMO_MAX_ITER, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        decode = float(mimo.mimo_eval(s_true, opt.get_psd_solution(X_m))[1])
        diff = (opt.objective_value - ref["obj"]) / (1 + abs(ref["obj"]))
        print(f"phase K2 {label} (mimo_problem(0, {K2_MIMO_N}), side "
              f"{K2_MIMO_N + 1}, {problem.G.shape[0]} box rows, "
              f"Options({', '.join(f'{k}={v}' for k, v in kw.items())}, "
              f"max_iter={K2_MIMO_MAX_ITER})) on {smi}: {opt.termination_status}"
              f" (status {res.status}, JAX {ref['status']}), objective "
              f"{opt.objective_value!r} (JAX {ref['obj']!r}, diff/(1+|ref|) "
              f"{diff:+.3e}), gap {res.gap:.3e} (JAX {ref['gap']:.3e}), "
              f"decode error {decode} (JAX {ref['decode']}), "
              f"{opt.pdhg_iterations} iterations in {wall:.2f} s "
              f"({opt.pdhg_iterations / wall:.1f} iterations/s)")
        check(res.status == ref["status"], f"K2 {label}: status {res.status}")
        check(decode == ref["decode"], f"K2 {label}: decode error {decode}")
        if not kw.get("hybrid_precision", True):
            check(abs(diff) <= K_OBJ_RTOL, f"K2 {label}: objective {diff:+.3e}"
                  " (relative) from the JAX run's")
    opt, (problem, X_s, x_true) = _optimizer_of(
        sensorloc, sensorloc.sensorloc_problem, 0, K2_SL_N)
    t0 = time.perf_counter()
    res = opt.optimize(chunk_iters=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    Xs = opt.get_psd_solution(X_s)
    pos_err = float(np.sqrt(np.mean(np.sum((Xs[:2, 2:] - x_true) ** 2,
                                           axis=0))))
    setup = preprocess(problem)
    viol = float(np.abs(problem.A @ res.primal - problem.b).max())
    bound = opt.options.tol_feasibility * (1 + setup.norm_b) * setup.rhs_scale
    lam = float(np.linalg.eigvalsh(Xs)[0])
    print(f"phase K2 sensorloc (sensorloc_problem(0, {K2_SL_N}), side "
          f"{K2_SL_N + 2}, {problem.A.shape[0]} rows, Options(chunk_iters=256))"
          f" on {smi}: {opt.termination_status} (status {res.status}, JAX "
          f"{K2_SL_REF['status']}) in {opt.pdhg_iterations} iterations (JAX "
          f"{K2_SL_REF['iter']}), {wall:.2f} s; max|A x - b| {viol:.3e} (the "
          f"solver's bound {bound:.3e}); position error {pos_err:.4e} (JAX "
          f"{K2_SL_REF['pos_err']:.4e}); lambda_min(X) {lam:.3e}; primal "
          f"{opt.primal_status}, dual {opt.dual_status}")
    check(res.status == K2_SL_REF["status"], f"K2 sensorloc: status "
          f"{res.status}")
    check(viol <= bound, f"K2 sensorloc: max|A x - b| {viol} > {bound}")
    check(lam >= -1e-6 * float(np.linalg.norm(Xs)),
          f"K2 sensorloc: lambda_min(X) = {lam}")
    # one solve_cone_program (the conformance battery's every-cone case,
    # objective 5) and one solve_sdp (the minimum eigenvalue of [[2, 1],
    # [1, 2]], 1)
    sol = solve_cone_program(
        np.array([1.0, 1.0, 0.0]),
        np.array([[1.0, 0.0, -1.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0],
                  [0.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 0.0],
                  [0.0, 0.0, 0.0]]),
        np.array([0.0, -2.0, 0.0, 3.0, 0.0, 0.0, 0.0]),
        dims=ConeDims(z=1, l=1, q=(2,), s=(2,)))
    Xe, r_sdp = solve_sdp([[2.0, 1.0], [1.0, 2.0]], As=[np.eye(2)], bs=[1.0])
    print(f"phase K2 solve_cone_program: {sol.termination_status} objective "
          f"{sol.objval!r} (known 5); solve_sdp: {r_sdp.termination_status} "
          f"objective {r_sdp.objval!r} (known 1), tr X {np.trace(Xe):.6f}")
    check(sol.status == 1 and abs(sol.objval - 5.0) <= 1e-4 + 1e-3 * 5.0,
          f"K2 solve_cone_program: status {sol.status}, {sol.objval}")
    check(r_sdp.status == 1 and abs(r_sdp.objval - 1.0) <= 1e-3,
          f"K2 solve_sdp: status {r_sdp.status}, {r_sdp.objval}")
    out["K2"] = (dict(kernels.launch_counts), dict(kernels.per_instance_launches))
    print(f"phase K2: {time.perf_counter() - t_k2:.1f} s; launches: "
          + json.dumps({e: n for e, n in out["K2"][0].items() if n}))
    for name in ("ell_spmv", "linesearch_loop", "residuals",
                 "primal_update_sym"):
        check(out["K2"][0][f"{name}_f32"] > 0 and out["K2"][0][f"{name}_f64"] > 0,
              f"K2: {name} launched no kernel")
    return out


# ---------------------------------------------------------------------------
# Phase M: solve_batch over any cone layout -- a sweep of phase I's program
# ---------------------------------------------------------------------------

M_SIZE = 16
M_OBJ_RTOL = 2e-4
M_F64_SIZE = 4
M_F64_ITERS = 300
M_F64_RTOL = 1e-6
M_OFF_B = 7  # the phase B rows' off-path batch
# the kernels whose launches phase M prints
M_KERNELS = ("batched_psd_eigh", "batched_psd_eigh_large", "batched_subspace",
             "batched_subspace_large", "soc_projection_batch",
             "coo_spmv_batch", "linesearch_loop_batch")
# the JAX package's solve_batch of phase M's instances on one CPU thread
# (tests/test_torch_reference_values.py::M_CHILD re-derives them, slow):
# M1, projection "eigh" under Options(tol_gap=1e-4, tol_feasibility=1e-4);
# its f64 program on instances 0-3 for M_F64_ITERS iterations; M2,
# projection "subspace", lined up with the port for C11 and C12 on every
# subspace block (its reseeds and programs)
M1_REF_OBJ = [
    514.0938333493236, 578.2716325860428, 543.6222345056243,
    563.3704034683371, 511.34960610375447, 524.0296788592997,
    535.7985588729339, 586.3231402652752, 501.09246153394724,
    545.8167641500443, 494.9105753801208, 526.0631884869275,
    538.8641995215304, 568.3689667380162, 479.1053481820511,
    523.9744327061547]
M1_REF_ITERS = [
    461, 331, 411, 416, 273, 234, 326, 294, 309, 468, 389, 397, 298, 343, 308, 316]
M1_F64_REF = {
    "obj": [514.1285114554069, 578.327155985561, 543.6058438383927, 563.3838316370322],
    "xnorm": [46.89867659771977, 46.358234256743366, 46.14628048339254, 45.93151310115228]}
M2_REF_OBJ = [
    515.3025169641796, 579.1474034116839, 543.6484921014734,
    563.4708798281249, 511.9450928246255, 523.9292999946762,
    536.5947530116574, 586.731429170858, 501.97233048768595,
    546.1972265578237, 495.5230534377686, 526.8249057095946,
    538.9811662729916, 569.2719684042686, 480.3249146141457,
    523.9996788275798]
M2_REF_ITERS = '215/249/363'
M2_REF_RESEEDS = [
    ('float32', 128, 128, 16, 16, 32),
    ('float32', 128, 128, 48, 16, 32),
    ('float32', 212, 356, 48, 16, 8),
    ('float32', 212, 356, 16, 16, 8),
    ('float64', 212, 356, 16, 16, 8)]
M2_REF_PROGRAMS = [('float32', 16), ('float32', 48), ('float32', 16), ('float64', 16)]


@functools.lru_cache(maxsize=1)
def m_problems(tx):
    """Phase M's instances: ``conic_sweep_instance`` s = 0 .. M_SIZE - 1
    of phase I's program (one operator, each instance's b and c); (the
    problems, (PSD index matrices, SOC indices, LP indices))."""
    data = conic_program_data()
    built = [build_conic_program(tx, conic_sweep_instance(data, s))
             for s in range(M_SIZE)]
    return [b[0] for b in built], built[0][1:]


def _rows_exact(torch, per_row, label):
    """A compare_fn: the batched kernel's outputs bit for bit those of
    ``per_row()`` (the single-instance kernel on each row, on the card),
    then the errors against the plain version."""
    def cmp(got, want):
        for g, r in zip(got, per_row(), strict=True):
            check(torch.equal(g, r), f"{label}: not bit for bit the "
                  "single-instance kernel on each row")
        return compare(torch, got, want)
    return cmp


def sweep_kernel_checks(torch, kernels, rng, dev):
    """Phase B rows of phase M's kernels, each against its plain version
    and, for K13b and K14b, bit for bit against K13 and K14 on each row:
    K14b (M x and M' y of the shared COO operator) and K15b's COO form at
    M's shape (B = 16, 1000 x 28,628) and, off the path, over phase H's
    theta operator at B = 7; K13b at M's 128 blocks of 16 (B = 16) and,
    off the path, B = 7 instances of 4096 blocks of lengths 2-257 in all
    three cases and with v = 0; K9 at M's grouped (512, 19, 19) stack, K9L
    at (16, 200, 200), K12 (or K12L) at M2's first program (16, 200, 16);
    in f64 and f32.  (rows for the kernels line, off-path rows)."""
    import proxsdp_tpu_torch as tx
    from proxsdp_tpu_torch.parallel import batch as tbatch
    from proxsdp_tpu_torch.problem import preprocess

    rows, off_path = [], []
    msetups = [preprocess(p) for p in m_problems(tx)[0]]
    hsetups = [preprocess(build_theta(tx, theta_graph())[0])] * M_OFF_B
    for sfx, dt in (("f64", torch.float64), ("f32", torch.float32)):
        for tag, setups, out in (("M", msetups, rows),
                                 ("H", hsetups, off_path)):
            o = tbatch._batch_operands(setups, dt, dev, "auto")
            M, lay = o.M, setups[0].layout
            check(type(M).__name__ == "CooOp" and not M.batched,
                  f"{tag}: the batch's operator is {type(M).__name__}, not "
                  "one shared COO operator")
            B, (nr, nc) = len(setups), M.shape
            nnz = M.row_vals.numel()
            label = f"{tag}: B = {B}, {nr} x {nc}, {nnz} nonzeros"
            X = torch.tensor(rng.standard_normal((B, nc)), dtype=dt, device=dev)
            Y = torch.tensor(rng.standard_normal((B, nr)), dtype=dt, device=dev)
            csr_row = torch.sparse_csr_tensor(M.row_ptr, M.row_idx.long(),
                                              M.row_vals, (nr, nc))
            csr_col = torch.sparse_csr_tensor(M.col_ptr, M.col_idx.long(),
                                              M.col_vals, (nc, nr))

            def per_row(M=M, X=X, Y=Y):
                return (torch.stack([kernels.coo_spmv(
                            M.row_ptr, M.row_idx, M.row_vals, x, M.row_seg)
                            for x in X]),
                        torch.stack([kernels.coo_spmv(
                            M.col_ptr, M.col_idx, M.col_vals, y, M.col_seg)
                            for y in Y]))

            check_entry(
                torch, kernels, out, "coo_spmv_batch", sfx, "coo_spmv.cu",
                "proxsdp_tpu/ops/linop.py:81",
                lambda f, M=M, X=X, Y=Y: (
                    f(M.row_ptr, M.row_idx, M.row_vals, X, M.row_seg),
                    f(M.col_ptr, M.col_idx, M.col_vals, Y, M.col_seg)),
                kernels.coo_spmv_batch_plain,
                (M.row_ptr, M.row_idx, M.row_vals, X, M.col_ptr, M.col_idx,
                 M.col_vals, Y), (Y, X), 4 * nnz * B,
                library=lambda a=csr_row, b=csr_col, X=X, Y=Y: (
                    torch.sparse.mm(a, X.T), torch.sparse.mm(b, Y.T)),
                compare_fn=_rows_exact(torch, per_row, f"coo_spmv_batch "
                                       f"({label})"),
                label=label,
                note="" if tag == "M" else " (not on phase M's path)")
            if tag == "M":
                LAUNCH_US.append((f"coo_spmv_batch_{sfx} ({label}: M x)",
                                  lambda M=M, X=X: kernels.coo_spmv_batch(
                                      M.row_ptr, M.row_idx, M.row_vals, X,
                                      M.row_seg), "seg_spmv_batch_kernel"))
            linesearch_batch_row(torch, kernels, out, o, lay.p, lay.m, sfx,
                                 dt, dev, rng, f"{label}, COO")
        # K13b: M's blocks, then 4096 of lengths 2-257 at B = 7
        for B, lens, on in ((M_SIZE, I_SOC_LENS, True),
                            (M_OFF_B, tuple(2 + (37 * i) % 256
                                            for i in range(4096)), False)):
            V = torch.tensor(soc_blocks(rng, lens, B), dtype=dt, device=dev)
            Vpad = soc_padded(torch, V, lens)

            def per_row(V=V, lens=lens):
                outs = [kernels.soc_projection(v.contiguous(), lens)
                        for v in V]
                return (torch.stack([o[0] for o in outs]),
                        torch.stack([o[1] for o in outs]))

            label = (f"{'M' if on else 'off'}: B = {B}, {len(lens)} blocks of "
                     f"lengths " + (f"{lens[0]}" if on else "2-257"))
            check_entry(
                torch, kernels, rows if on else off_path,
                "soc_projection_batch", sfx, "soc_proj.cu",
                "proxsdp_tpu/ops/cones.py:43",
                lambda f, V=V, lens=lens: f(V, lens),
                kernels.soc_projection_batch_plain, (V,),
                (torch.empty_like(V), torch.empty(B, dtype=dt, device=dev)),
                4.3 * V.numel(),
                library=lambda Vpad=Vpad: torch.linalg.vector_norm(Vpad, dim=-1),
                compare_fn=_rows_exact(torch, per_row,
                                       f"soc_projection_batch ({label})"),
                tol=0.0 if sfx == "f64" else 1e-7, label=label,
                note="" if on else " (not on phase M's path)")
            if on:
                LAUNCH_US.append((f"soc_projection_batch_{sfx} ({label})",
                                  lambda V=V, lens=lens:
                                  kernels.soc_projection_batch(V, lens),
                                  "soc_proj_batch_kernel"))
        # K9 at M's grouped stack, K9L at its side-200 blocks
        for side, nb in ((I_PSD_SIDES[0], M_SIZE * I_PSD_SIDES.count(
                I_PSD_SIDES[0])), (I_PSD_SIDES[-1], M_SIZE)):
            X = eigh_inputs(torch, rng, side, dt, dev, B=nb)
            large = side > kernels.EIGH_MAX_SIDE[dt]
            tol = (EIGH_RTOL_F32_L * side if large and sfx == "f32"
                   else EIGH_RTOL[sfx])
            check_entry(
                torch, kernels, rows,
                "batched_psd_eigh_large" if large else "batched_psd_eigh", sfx,
                "batched_eigh_large.cu" if large else "batched_eigh.cu",
                "proxsdp_tpu/ops/cones.py:622",
                lambda f, X=X: f(X, TOL_PSD), kernels.batched_psd_eigh_plain,
                (X,), (torch.empty_like(X), torch.empty(nb, side, dtype=dt,
                                                        device=dev),
                       torch.empty(nb, dtype=torch.int32, device=dev),
                       torch.empty(nb, side, dtype=dt, device=dev)),
                nb * 10.5 * side ** 3,
                library=lambda Xf=torch.nan_to_num(X): torch.linalg.eigh(Xf),
                compare_fn=eigh_compare(torch, X, tol), tol=tol,
                label=f"M: side {side}", wrapper="batched_psd_eigh")
    # K12 at M2's first program: the f32 race's subspace step, bucket 16
    side, k, B, dt = I_PSD_SIDES[-1], 16, M_SIZE, torch.float32
    v, V = subspace_inputs(torch, rng, B, side, k, dt, dev)
    large = not (k <= kernels.SUBSPACE_MAX_K and kernels.subspace_smem_bytes(
        side, k, dt, False) <= kernels.SUBSPACE_SMEM_BYTES)
    Xs = torch.nan_to_num(kernels.tri_to_square_plain(v, side))

    def library(Xs=Xs, V=V):
        Q = torch.linalg.qr(torch.bmm(Xs, V)).Q
        th, U = torch.linalg.eigh(torch.bmm(Q.mT, torch.bmm(Xs, Q)))
        W = torch.bmm(Q, U)
        return torch.bmm(W * th.clamp_min(0)[:, None, :], W.mT)

    check_entry(
        torch, kernels, rows,
        "batched_subspace_large" if large else "batched_subspace", "f32",
        "batched_subspace.cu", "proxsdp_tpu/ops/cones.py:427",
        lambda f: f(v, V, side, TOL_PSD, False), kernels.batched_subspace_plain,
        (v, V), (torch.empty(B, side * (side + 1) // 2, dtype=dt, device=dev),
                 torch.empty_like(V), torch.empty(B, 5, dtype=dt, device=dev)),
        B * (6 * side * side * k + 14 * side * k * k + 10 * k ** 3),
        library=library,
        compare_fn=subspace_compare(torch, v, V, side, SUB_RTOL_L["f32"]),
        tol=SUB_RTOL_L["f32"], label=f"M: B = {B}, side {side}, k = {k}",
        wrapper="batched_subspace")
    return rows, off_path


def _m_checks(tag, res, Xs, socs, ref_obj, rtol, mean_rtol=None):
    """Statuses, feasibility within the solver's bound, lambda_min(X) >=
    -1e-6 ||X||_F for every PSD block of every instance, ||v|| - s <=
    tol_soc for every SOC block, the objectives against ``ref_obj`` (each
    to ``rtol``, on average to ``mean_rtol``) relative to 1 + |obj|."""
    from proxsdp_tpu_torch import Options

    status = np.array([r.status for r in res])
    feas = np.array([r.primal_feasible_user_tol for r in res])
    lam = min(float(np.linalg.eigvalsh(r.primal[X])[0])
              / max(float(np.linalg.norm(r.primal[X])), 1e-300)
              for r in res for X in Xs)
    gap = max(float(np.linalg.norm(r.primal[v][1:]) - r.primal[v][0])
              for r in res for v in socs)
    ref = np.array(ref_obj)
    dev = np.abs(np.array([r.objval for r in res]) - ref) / (1.0 + np.abs(ref))
    tol_soc = Options().tol_soc
    print(f"phase {tag} checks: statuses "
          f"{dict(zip(*np.unique(status, return_counts=True)))}; feasible "
          f"{int(feas.sum())}/{len(res)}; min lambda_min(X)/||X||_F over "
          f"{len(Xs)} blocks {lam:.3e}; max ||v|| - s over {len(socs)} SOC "
          f"blocks {gap:.3e} (bound {tol_soc:.0e}); objectives vs the JAX "
          f"batch: max |diff|/(1+|ref|) {dev.max():.3e} (bound {rtol:.1e}), "
          f"mean {dev.mean():.3e}"
          + (f" (bound {mean_rtol:.0e})" if mean_rtol else ""))
    check((status == 1).all(), f"{tag}: not every instance reached status 1")
    check(feas.all(), f"{tag}: {int((~feas).sum())} instances not feasible "
          "within tol_feasibility")
    check(lam >= -1e-6, f"{tag}: lambda_min(X)/||X||_F = {lam}")
    check(gap <= tol_soc, f"{tag}: SOC gap {gap} > {tol_soc}")
    check((dev <= rtol).all(), f"{tag}: objectives of instances "
          f"{np.nonzero(dev > rtol)[0].tolist()} differ from the JAX batch's "
          f"by more than {rtol} (1 + |obj|)")
    check(mean_rtol is None or dev.mean() <= mean_rtol,
          f"{tag}: mean objective deviation {dev.mean():.3e} > {mean_rtol}")


def phase_m(torch, kernels, smi):
    """M1: phase I's program swept over M_SIZE instances (each its own b
    and c: ``conic_sweep_instance``) with one shared COO operator (1000 x
    28,628: ROADMAP C26's case), projection "eigh" under
    Options(tol_gap=1e-4, tol_feasibility=1e-4): K9 on the 32 side-19
    blocks of every instance in one launch, K9L on the side-200 blocks,
    K13b, K14b and K15b's COO form, in the f32 race and the f64 phase;
    against the JAX batch; a profiled window of its f32 program; its f64
    program on instances 0-3 for M_F64_ITERS iterations against the JAX
    package's.  M2: the same instances under projection "subspace" (the
    side-200 block on K12 / K12L, the side-19 blocks on K9 in the same
    step) against the JAX run lined up for C11 and C12, its reseeds and
    programs printed beside the JAX run's.  Returns {tag: (entries,
    shapes)} of the counted runs."""
    import proxsdp_tpu_torch as tx
    from proxsdp_tpu_torch import Options, solve_batch
    from proxsdp_tpu_torch.problem import preprocess

    out = {}
    base = Options(tol_gap=1e-4, tol_feasibility=1e-4)
    probs, (Xs, socs, _) = m_problems(tx)
    lay = preprocess(probs[0]).layout
    print(f"phase M: {M_SIZE} instances of phase I's program: "
          f"{len(lay.sdp_sides)} PSD blocks, {len(lay.soc_lens)} SOC blocks, "
          f"n = {lay.n}, p = {lay.p}, m = {lay.m}")
    t = time.perf_counter()
    res, entries, shapes, _ = _l_run(torch, kernels, "M1", smi, probs, base,
                                     names=M_KERNELS, projection="eigh")
    print(f"phase M1 iterations {[r.iter for r in res]} (JAX {M1_REF_ITERS})")
    _m_checks("M1", res, Xs, socs, M1_REF_OBJ, M_OBJ_RTOL)
    for name in ("batched_psd_eigh", "batched_psd_eigh_large",
                 "soc_projection_batch", "coo_spmv_batch",
                 "linesearch_loop_batch"):
        for sfx in ("f32", "f64"):
            check(entries[f"{name}_{sfx}"] > 0,
                  f"M1: {name}_{sfx} launched no kernel")
    out["M1"] = (entries, shapes)
    setups = [preprocess(p) for p in probs]
    prof = profile_steps(torch, kernels, setups,
                         base.replace(dtype="float32"))
    per = prof[4] or {}
    print(f"phase M1 f32 program, a profiled window of {PROFILE_STEPS} steps "
          f"on {smi}: "
          f"{'not measured' if prof[0] is None else f'{prof[0]:.1f}'} CUDA "
          f"kernels and {prof[1]:.1f} of the port's launches a step, device "
          f"busy {'not measured' if prof[2] is None else f'{prof[2]:.3f}'}, "
          f"{prof[3]:.2f} ms a step; device us a launch: " + ", ".join(
              f"{k_} {per[k_]:.1f}" if k_ in per else f"{k_} not measured"
              for k_ in ("soc_projection_batch", "coo_spmv_batch",
                         "linesearch_loop_batch", "batched_psd_eigh",
                         "batched_psd_eigh_large")))
    # the f64 program against the JAX package's iterate
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_batch(probs[:M_F64_SIZE], base.replace(
        hybrid_precision=False, max_iter=M_F64_ITERS), projection="eigh")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d_obj = np.abs(np.array([r.objval for r in res])
                   / np.array(M1_F64_REF["obj"]) - 1.0)
    d_x = np.abs(np.array([np.linalg.norm(r.primal) for r in res])
                 / np.array(M1_F64_REF["xnorm"]) - 1.0)
    print(f"phase M1 f64 (instances 0-{M_F64_SIZE - 1}, hybrid_precision="
          f"False, {M_F64_ITERS} iterations) on {smi}: {wall:.2f} s; objective"
          f" vs the JAX f64 program: max relative {d_obj.max():.3e}, ||x|| "
          f"{d_x.max():.3e} (bound {M_F64_RTOL:.0e}); launches " + json.dumps(
              {e: n for e, n in kernels.launch_counts.items()
               if n and e.rsplit("_f", 1)[0] in M_KERNELS}))
    check(all(r.status == 3 and r.iter == M_F64_ITERS for r in res),
          "M1 f64: not at the iteration limit")
    check(max(d_obj.max(), d_x.max()) <= M_F64_RTOL,
          "M1 f64: the f64 program parts from the JAX package's")
    print(f"phase M1: {time.perf_counter() - t:.1f} s")

    # ---- M2: the subspace mode on the side-200 block
    t = time.perf_counter()
    res, entries, shapes, stats = _l_run(torch, kernels, "M2", smi, probs,
                                         base, names=M_KERNELS,
                                         projection="subspace")
    it2 = [r.iter for r in res]
    print(f"phase M2 iterations {min(it2)}/{int(np.median(it2))}/{max(it2)} "
          f"(JAX {M2_REF_ITERS})")
    print(f"phase M2 reseeds (dtype, min iter, max iter, k, masked, r_max): "
          f"{stats.reseeds}; JAX: {M2_REF_RESEEDS}")
    programs = [(d, k) for d, _, k in stats.programs]
    print(f"phase M2 programs (dtype, k): {programs}; JAX: {M2_REF_PROGRAMS}")
    if [tuple(r) for r in stats.reseeds] != M2_REF_RESEEDS \
            or programs != M2_REF_PROGRAMS:
        print("phase M2 FINDING: the reseed or program sequence differs from "
              "the JAX run's (C14)")
    check(sum(entries[f"{name}_{sfx}"] for name in ("batched_subspace",
                                                    "batched_subspace_large")
              for sfx in ("f32", "f64", "f64_f32")) > 0,
          "M2: K12 / K12L launched no kernel")
    check(entries["batched_psd_eigh_f32"] > 0,
          "M2: K9 launched no kernel beside the subspace step")
    _m_checks("M2", res, Xs, socs, M2_REF_OBJ, G_OBJ_RTOL, G_OBJ_MEAN_RTOL)
    out["M2"] = (entries, shapes)
    print(f"phase M2: {time.perf_counter() - t:.1f} s")
    return out


def phase_m_rows(rows, runs):
    """Each phase-M row's launches: K12's (K12L's) at its shape in M2, the
    others' at their shape (K9, K9L) or their entry point's in M1; (rows
    for the kernels line, rows left off it)."""
    sub = [r for r in rows if r["name"].startswith("batched_subspace")]
    kept, left = [], []
    for group, tag in (([r for r in rows if r not in sub], "M1"),
                       (sub, "M2")):
        entries, shapes = runs[tag]
        a, b = assign_launches(group, shapes, entries)
        kept += a
        left += b
    return kept, left



# ---------------------------------------------------------------------------
# Phase N: the single solve's remaining options on the side-250 max-cut
# ---------------------------------------------------------------------------

N_ITERS = 300  # the f64 programs' iterations from init_state (N1, N3)
N_F64_RTOL = 1e-6  # phases F and I's bound on a 300-iteration iterate
N2_OBJ_RTOL = 2e-4  # an f32 race's like-mode bound, relative to 1 + |obj|
N3_OPTS = {"hybrid_precision": False, "subspace_rank": 16,
           "subspace_accept_always": True}
# N3's default (mixed) program builds its basis in f32: the two builds'
# f32 rounding moves its residuals ~2e-3 apart over 300 iterations (the
# JAX mixed and f64 programs differ by as much), so ||X||_F, lambda_min
# and the objectives are held to this and the rest printed; its f64 form
# (subspace_mixed=False) is held to N_F64_RTOL in full
N3_MIXED_RTOL = 1e-5
N4_SAVE = 100  # N4's checkpoint iteration (f64) ...
N4_RACE_SAVE = 512  # ... and in the default driver's f32 subspace race
# the JAX package on one CPU thread (tests/test_torch_reference_values.py::
# N_CHILD re-derives them, slow): N1, Options(square_form=False,
# chunk_iters=256) -- status, objective, iterations and [race rank,
# hand-over, polar reseeds] -- and its f64 program's iterate after N_ITERS
# iterations (the 14 fetched scalars, ||X||_F, lambda_min); N2, the same
# under Options(subspace_sign=True); N3, N3_OPTS's iterate (mixed, and
# with subspace_mixed=False: "f64") in the square and the packed layout,
# the JAX run given the port's basis after iteration 1 (C11)
N1_REF = {'status': 1, 'objval': 1250.5878444614436, 'iter': 598, 'events': [24, 597, 144]}
N1_F64_REF = {'fetch': [300.0, 0.0, 0.005715743269095343, 0.0001718348455696725, -1243.7927710468, -1229.6494943237433, 0.08131993591705226, 0.001373923975738065, 0.08131993591705226, 2.0, 300.0, 0.0, 0.0, 0.0], 'norm': 5.40713931648196, 'lmin': -6.679388390237639e-16}
N2_REF = {'status': 1, 'objval': 1250.4963688516564, 'iter': 596, 'events': [24, 595, 127]}
N3_REF = {
    "N3sq": {'fetch': [300.0, 0.0, 0.0063056546271998675, 0.0015889409615874976, -1235.9270488936681, -1220.43179274321, 0.4740251315005866, 0.012500483155618157, 0.4740251315005866, 2.0, 0.0, 0.00010280819393411129, -0.4160046215330444, 11.0], 'norm': 5.461291736350423, 'lmin': -8.085643220459639e-16},
    "N3tri": {'fetch': [300.0, 0.0, 0.006305654627198305, 0.001588940961587456, -1235.9270488936643, -1220.43179274321, 0.474025131500578, 0.012500483155617827, 0.474025131500578, 2.0, 0.0, 0.00010280819393410624, -0.4160046215330444, 11.0], 'norm': 5.461291736350425, 'lmin': -8.246058225813558e-16},
    "N3f64sq": {'fetch': [300.0, 0.0, 0.006306278154156093, 0.001585500935340177, -1235.940781348429, -1220.4438304546559, 0.4731230132962321, 0.012472793978042889, 0.4731230132962321, 2.0, 0.0, 0.00010264620280294961, -0.41600664742327625, 11.0], 'norm': 5.461530996465812, 'lmin': -8.798134260099886e-16},
    "N3f64tri": {'fetch': [300.0, 0.0, 0.006306278154151599, 0.001585500935337776, -1235.9407813484158, -1220.4438304546538, 0.4731230132956655, 0.012472793978023195, 0.4731230132956655, 2.0, 0.0, 0.0001026462028028944, -0.4160066474232764, 11.0], 'norm': 5.461530996465809, 'lmin': -9.17657274161157e-16},
}


def block_of(x, side: int, square: bool):
    """The (side, side) matrix of the PSD block at offset 0 of x: reshaped
    (square form) or unpacked from its scaled triangle (column-major upper
    triangle, off-diagonal entries times sqrt(2))."""
    x = np.asarray(x, np.float64)
    if square:
        return x[: side * side].reshape(side, side)
    j = np.repeat(np.arange(side), np.arange(1, side + 1))
    i = np.concatenate([np.arange(c + 1) for c in range(side)])
    v = x[: side * (side + 1) // 2] / np.where(i == j, 1.0, np.sqrt(2.0))
    X = np.zeros((side, side))
    X[i, j] = v
    X[j, i] = v
    return X


# K17 against its plain twin: Bp and the statistics relative to the
# largest entry (f32 products summed in other orders through ~30
# dependent k x k products: K12's 3e-6 to 1e-5 of the scale); the flags
# equal, except where a test's statistic lies within SIGN_NEAR of its
# threshold (then the case is printed)
SIGN_RTOL = 1e-5
SIGN_NEAR = 1e-4
# (side, k, timed): the f32 race's buckets at side 250, phase E's k = 128
# at side 2000 (timed) and the largest bucket (checked only)
SIGN_SHAPES = ((SIDE, 16, True), (SIDE, 24, True), (SIDE, 32, True),
               (LZ_SIDE, 128, True), (LZ_SIDE, 256, False))
# K12 at B = 1 (the accept-always step in solve) against its plain twin,
# as phase G's rows
SUB1_RTOL = {"f64": 1e-10, "f32": 1e-4, "f64_f32": 1e-4}


def sign_margins(torch, Q, Z, accept_tol, subspace_tol, k):
    """The sign body's three tests (cones.py:370-386) as (value, threshold)
    pairs from the plain arithmetic: rfro against thresh * scale, k - npos
    against 0.5, ||S S - I||_F against 0.05 sqrt(k)."""
    from proxsdp_tpu_torch.ops.cones import POLAR_QA, POLAR_QB, POLAR_QC

    B = Q.T @ Z
    B = 0.5 * (B + B.T)
    sF = torch.sqrt(torch.sum(B * B)) + 1e-30
    Y = B / sF
    for _ in range(7):
        A2 = Y @ Y
        Y = POLAR_QA * Y + Y @ (POLAR_QB * A2 + POLAR_QC * (A2 @ A2))
    for _ in range(4):
        Y = 1.5 * Y - 0.5 * (Y @ (Y @ Y))
    S = 0.5 * (Y + Y.T)
    eye = torch.eye(k, dtype=Q.dtype, device=Q.device)
    R = (Z - Q @ B) @ (0.5 * (eye + S))
    thresh = max(subspace_tol, float(accept_tol)) * max(float(sF), 1.0)
    npos = 0.5 * (k + float(torch.trace(S)))
    return [(float(torch.sqrt(torch.sum(R * R))), thresh), (k - npos, 0.5),
            (float(torch.sqrt(torch.sum((S @ S - eye) ** 2))),
             0.05 * np.sqrt(k))]


def sign_inputs(torch, kernels, rng, side, k, dev, case="converged"):
    """(Q, Z, accept_tol) of one sign step on the card: X with the race's
    spectrum (k // 2 clear positive eigenvalues, a negative bulk), Q the
    CholeskyQR2 basis of X times the top-k eigenvectors (``converged``) or
    them plus noise (``unconverged``), Z = X Q; ``rank_deficient`` zeroes
    a column of Q, ``nan`` puts a NaN in Z."""
    f32 = torch.float32
    U = torch.linalg.qr(torch.tensor(rng.standard_normal((side, side)),
                                     dtype=torch.float64, device=dev)).Q
    npos = k // 2
    w = np.concatenate([np.linspace(40.0, 1.0, npos),
                        -np.linspace(0.05, 5.0, side - npos)])
    X = ((U * torch.tensor(w, device=dev)) @ U.T).to(f32)
    warm = U[:, :k].to(f32)
    if case == "unconverged":
        warm = warm + 0.3 * torch.tensor(rng.standard_normal((side, k)),
                                         dtype=f32, device=dev)
    Q = kernels.cholqr_plain(kernels.cholqr_plain(X @ warm, 1e-6), 1e-6)
    if case == "rank_deficient":
        Q[:, k // 3] = 0.0
    Z = X @ Q
    if case == "nan":
        Z[3, 1] = float("nan")
    return Q.contiguous(), Z.contiguous(), torch.tensor(1e-4, dtype=f32,
                                                        device=dev)


def option_kernel_checks(torch, kernels, rng, dev):
    """Phase N's kernels against their plain versions: K17 at the f32
    race's buckets at side 250 (k = 16, 24, 32) and at side 2000 (k = 128
    timed, 256 checked), and at side 250, k = 24 on unconverged,
    rank-deficient and non-finite inputs (checked); K12 at B = 1 (side
    250, k = 16) in f32, the mixed mode and f64; K10 and the packed-form
    K4 (an empty square-block table) at side 250, K4 bit for bit.  Times
    beside the plain twin and the library route: for K17 the eigh route
    it replaces (torch.linalg.eigh of B and the reconstruction of Bp).
    Returns (rows for the kernels line, rows checked but off every path)."""
    rows, off = [], []
    f32 = torch.float32

    def sign_row(side, k, case, timed):
        Q, Z, at = sign_inputs(torch, kernels, rng, side, k, dev, case)
        B = Q.T @ Z
        B = 0.5 * (B + B.T)

        def library(B=B):  # the eigh route the sign body replaces
            w, V = torch.linalg.eigh(B)
            return (V * w.clamp_min(0.0)) @ V.T

        def cmp(got, want):
            flags_equal = torch.equal(got[2].cpu(), want[2].cpu())
            if not flags_equal:
                margins = sign_margins(torch, Q, Z, at, 1e-9, k)
                near = [abs(v - t) <= SIGN_NEAR * max(abs(t), 1e-30)
                        for v, t in margins]
                print(f"kernel subspace_sign_f32 ({case}, side {side}, k = {k})"
                      f": flags {got[2].tolist()} vs {want[2].tolist()}, tests "
                      f"(value, threshold) {margins}")
                check(any(near), f"subspace_sign ({case}, k = {k}): flags "
                      f"{got[2].tolist()} vs {want[2].tolist()} away from "
                      "every threshold")
            fin = torch.isfinite(want[0]).all()
            check(bool(fin) == bool(torch.isfinite(got[0]).all()),
                  "subspace_sign: Bp finite in one version only")
            return compare(torch, got[:2], want[:2])

        args = (Q, Z, at, 1e-9, 7, 4, False)
        # Q^T Z, Q B, the residual's Pp product (2 side k^2 each) and
        # ~30 k x k products (7 x 3 + 4 x 2 + S S, S B)
        flops = 3 * 2 * side * k * k + 31 * 2 * k ** 3
        dest = rows if (timed and case == "converged") else off
        check_entry(torch, kernels, dest, "subspace_sign", "f32",
                    "subspace_sign.cu", "proxsdp_tpu/ops/cones.py:349",
                    lambda f: f(*args), kernels.subspace_sign_plain, (Q, Z, at),
                    (torch.empty(k * k + 3, dtype=f32, device=dev),
                     torch.empty(3, dtype=torch.int32, device=dev)),
                    flops, library=library, compare_fn=cmp, tol=SIGN_RTOL,
                    label=f"N: {case}, side {side}, k = {k}",
                    note=" (library: eigh of B and Bp)", timed=timed)
        if timed and case == "converged":
            LAUNCH_US.append((f"subspace_sign_f32 (side {side}, k = {k})",
                              lambda: kernels.subspace_sign(*args),
                              "subspace_sign_kernel"))

    for side, k, timed in SIGN_SHAPES:
        sign_row(side, k, "converged", timed)
    for case in ("unconverged", "rank_deficient", "nan"):
        sign_row(SIDE, 24, case, False)

    # ---- K12 at B = 1: the accept-always step in solve
    side, k = SIDE, 16
    tl = side * (side + 1) // 2
    for sfx in ("f64_f32", "f32", "f64"):
        dt = f32 if sfx == "f32" else torch.float64
        mixed = sfx == "f64_f32"
        v, V = subspace_inputs(torch, rng, 3, side, k, dt, dev,
                               converged=mixed)
        v, V = v[:1].contiguous(), V[:1].contiguous()
        Xs = kernels.tri_to_square_plain(v, side)

        def library(Xs=Xs, V=V):
            Q = torch.linalg.qr(torch.bmm(Xs, V)).Q
            th, U = torch.linalg.eigh(torch.bmm(Q.mT, torch.bmm(Xs, Q)))
            W = torch.bmm(Q, U)
            return torch.bmm(W * th.clamp_min(0)[:, None, :], W.mT)

        def cmp(got, want, v=v, tol=SUB1_RTOL[sfx]):
            blk, me, rank, warm, bad, stats = got
            pblk, pme, prank, pwarm, pbad, pstats = want
            check(torch.equal(bad, pbad) and not bool(bad.any()),
                  "batched_subspace (B = 1): guard flags")
            check(torch.equal(rank, prank)
                  and torch.equal(stats[:, 2], pstats[:, 2]),
                  "batched_subspace (B = 1): ranks differ")
            P = warm[0].double() @ warm[0].double().T
            Pp = pwarm[0].double() @ pwarm[0].double().T
            span = float((P - Pp).abs().max())
            check(span <= max(tol, 1e-9) * 10,
                  f"batched_subspace (B = 1): bases span other spaces ({span:.3e})")
            scale = float(v.abs().max())
            err = max(float((blk - pblk).abs().max()),
                      float((me - pme).abs().max()),
                      float((stats[:, :2] - pstats[:, :2]).abs().max()))
            return err, err / scale

        check_entry(
            torch, kernels, rows if sfx != "f32" else off, "batched_subspace",
            sfx,
            "batched_subspace.cu", "proxsdp_tpu/ops/cones.py:497",
            lambda f, v=v, V=V, m=mixed: f(v, V, side, TOL_PSD, m),
            kernels.batched_subspace_plain, (v, V),
            (torch.empty(1, tl, dtype=dt, device=dev), torch.empty_like(V),
             torch.empty(1, 5, dtype=dt, device=dev)),
            6 * side * side * k + 14 * side * k * k + 10 * k ** 3,
            library=library, compare_fn=cmp, tol=SUB1_RTOL[sfx],
            label=f"N3: B = 1, side {side}, k = {k}",
            note="" if sfx != "f32" else " (not on phase N's path)")

    # ---- K10 and the packed-form K4 at side 250 (N1's shapes)
    for sfx, dt in (("f32", f32), ("f64", torch.float64)):
        v = torch.tensor(rng.standard_normal((1, tl)), dtype=dt, device=dev)
        Xs = kernels.tri_to_square_plain(v, side).contiguous()
        gather = (torch.empty(side * side, dtype=torch.int32, device=dev),)
        take_in, take_out = k10_take_index(torch, kernels, 1, side, tl, dt, dev)
        check_entry(torch, kernels, rows, "tri_to_square", sfx, "tri_gather.cu",
                    "proxsdp_tpu/ops/tri.py:39", lambda f, v=v: (f(v, side),),
                    kernels.tri_to_square_plain, (v,) + gather, (Xs,),
                    side * side, tol=0.0, label=f"N1: B = 1, side {side}",
                    library=lambda v=v, i=take_in: torch.take(v, i))
        check_entry(torch, kernels, rows, "square_to_tri", sfx, "tri_gather.cu",
                    "proxsdp_tpu/ops/tri.py:47", lambda f, Xs=Xs: (f(Xs, side),),
                    kernels.square_to_tri_plain, (Xs,) + gather[:0]
                    + (torch.empty(tl, dtype=torch.int32, device=dev),), (v,),
                    tl, tol=0.0, label=f"N1: B = 1, side {side}",
                    library=lambda Xs=Xs, i=take_out: torch.take(Xs, i))
        x, Mty, c = (torch.tensor(rng.standard_normal(tl), dtype=dt, device=dev)
                     for _ in range(3))
        tau = torch.tensor(0.37, dtype=dt, device=dev)
        check_entry(torch, kernels, rows, "primal_update_sym", sfx,
                    "primal_update_sym.cu", "proxsdp_tpu/solver.py:308",
                    lambda f: (f(x, Mty, c, tau, ()),),
                    kernels.primal_update_sym_plain, (x, Mty, c, tau),
                    (torch.empty_like(x),), 3 * tl, tol=0.0,
                    label=f"N1: packed, n = {tl}")
    return rows, off


def _solve_once(torch, kernels, solve, problem, opts, **kw):
    """One solve with the launch counts set to 0 just before it and read
    just after: (result, wall s, counts by entry point, by kernel, by entry
    point and call shape, captured stdout)."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    SHAPES.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = solve(problem, opts, **kw)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, dict(kernels.launch_counts),
            kernels.kernel_launches(), collections.Counter(SHAPES.counts),
            buf.getvalue())


def _events(log: str) -> list:
    """[race rank, hand-over iteration, polar reseeds] from a solve's log
    (0, 0, -1 where absent), as the JAX references record them."""
    race = re.search(r"f32 race: subspace rank (\d+)", log)
    hand = re.search(r"f32 -> f64 at iter (\d+)", log)
    fb = re.search(r"f32 polar-reseed=(\d+), dense-eigh=(\d+)", log)
    return [int(race.group(1)) if race else 0, int(hand.group(1)) if hand else 0,
            int(fb.group(1)) if fb else -1]


def _n_steps(torch, kernels, problem, opts, square=True, iters=N_ITERS,
             axis=None):
    """``iters`` iterations of ``opts``' program from init_state on this
    process's card, its operator sharded over ``axis`` (an active
    tensor-parallel axis) where given, the launch counts set to 0 just
    before and read just after.  Returns a dict: the fetched scalars
    ("fetch"), "x", "y", ||X||_F and lambda_min of the side-SIDE block
    ("norm", "lmin"), counts by entry point ("entries") and by entry
    point and shape ("shapes"), seconds ("wall") and the warnings of
    synchronising calls after the first iteration ("syncs")."""
    import warnings

    from proxsdp_tpu_torch import convert
    from proxsdp_tpu_torch import solver as tsolver
    from proxsdp_tpu_torch.ops.linop import build_linop, shard_linop
    from proxsdp_tpu_torch.problem import preprocess, to_square_form

    dev = torch.device("cuda", torch.cuda.current_device())
    setup = preprocess(problem)
    if square:
        setup = to_square_form(setup)
    layout = setup.layout
    M = build_linop(setup.A, setup.G, torch.float64, device=dev)
    if axis is not None:
        M = shard_linop(M, axis)
    o = convert.operands_from_numpy(
        M=M, b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
        norm_h=setup.norm_h, norm_c=setup.norm_c,
        obj_scale=setup.obj_scale * setup.rhs_scale, device=dev)
    _, iteration, fetch = tsolver.make_chunk_runner(layout, opts, device=dev)
    s = convert.state_from_numpy(tsolver.init_state(layout, opts, setup), dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    SHAPES.reset()
    t0 = time.perf_counter()
    s = iteration(s, o, 0)
    torch.cuda.synchronize()
    # after the first iteration (its tables are built and cached), every
    # device-to-host synchronisation is reported
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for k in range(1, iters):
                s = iteration(s, o, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x = s.x.cpu().numpy()
    X = block_of(x, SIDE, square)
    return {"fetch": fetch(s), "x": x, "y": s.y.cpu().numpy(),
            "norm": float(np.linalg.norm(X)),
            "lmin": float(np.linalg.eigvalsh(X)[0]),
            "entries": dict(kernels.launch_counts),
            "shapes": collections.Counter(SHAPES.counts), "wall": wall,
            "syncs": [str(w.message).splitlines()[0] for w in caught
                      if "synchroniz" in str(w.message)]}


def _n_iterate_check(label, got, norm, lmin, ref, smi, wall,
                     rtol=N_F64_RTOL, held=range(2, 9)):
    """A 300-iteration iterate against the JAX one: the counters exactly;
    ||X||_F, lambda_min (relative to the norm) and the fetched scalars of
    ``held`` within ``rtol``, the others printed."""
    rf = np.asarray(ref["fetch"])
    each = {i: abs(float(got[i]) - rf[i]) / max(abs(rf[i]), 1e-300)
            for i in range(2, 9)}
    rel = {"fetch": max(each[i] for i in held),
           "norm": abs(norm - ref["norm"]) / ref["norm"],
           "lmin": abs(lmin - ref["lmin"]) / ref["norm"]}
    print(f"phase {label} ({N_ITERS} iterations from init_state) on {smi}: "
          f"{wall:.3f} s, {1e3 * wall / N_ITERS:.2f} ms/iteration; relative "
          "differences from the JAX iterate " + ", ".join(
              f"{k} {v:.3e}" for k, v in rel.items())
          + " (fetched gap, feas, prim, dual, pres, dres, comb: "
          + ", ".join(f"{each[i]:.1e}" for i in range(2, 9))
          + f"; held: {list(held)} to {rtol:.0e})")
    check(got[:2].tolist() == rf[:2].tolist()
          and got[9:11].tolist() == rf[9:11].tolist(),
          f"{label}: counters {got[:2].tolist() + got[9:11].tolist()} vs the "
          f"JAX run's {rf[:2].tolist() + rf[9:11].tolist()}")
    check(max(rel.values()) <= rtol,
          f"{label}: the iterate differs by {max(rel.values()):.3e} > {rtol}")


def phase_n(torch, kernels, smi):
    """The single solve's remaining options on the side-250 max-cut, each
    solve once with the launch counts set to 0 just before it and read
    just after.  N1: Options(square_form=False) under the default driver
    (K10 in and out of every projection, K4 without symmetrisation),
    against the JAX package's packed-layout answer, then its f64 program
    for N_ITERS iterations against the JAX iterate; N2:
    Options(subspace_sign=True) (K17 once per race subspace step, K8 only
    in the f64 polish); N3: N3_OPTS for N_ITERS iterations in both layouts,
    mixed and f64, against the JAX iterates lined up for C11 (K12 once an
    iteration, no K8, no synchronising call); N4: a checkpoint of the f64 program at
    iteration N4_SAVE resumed to status 1 against phase A's answer, and
    one taken in the default driver's f32 subspace race at N4_RACE_SAVE
    resumed into that race.  Returns {tag: (counts by entry point, by
    entry point and shape)} of N1, N2 and N3."""
    import os
    import tempfile

    import proxsdp_tpu_torch as tx
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu_torch.utils.checkpoint import load_checkpoint_numpy

    problem, Xidx = maxcut_problem(random_graph_weights(0, SIDE))
    out = {}
    # ---- N1: the packed layout
    res, wall, entries, counts, shapes, log = _solve_once(
        torch, kernels, tx.solve, problem, tx.Options(
            square_form=False, log_verbose=True, log_freq=10 ** 9,
            timer_verbose=True))
    bound = 1e-4 * (1 + abs(N1_REF["objval"]))
    ev = _events(log)
    k10 = counts["tri_to_square"] + counts["square_to_tri"]
    print(f"phase N1 (Options(square_form=False)) on {smi}: status {res.status}"
          f" objval {res.objval!r} (JAX packed {N1_REF['objval']!r}, diff "
          f"{res.objval - N1_REF['objval']:.3e}, bound {bound:.3e}; phase C's "
          f"square-layout reference {HYB_REF_OBJ!r}, diff "
          f"{res.objval - HYB_REF_OBJ:.3e}) iterations {res.iter} (JAX packed "
          f"{N1_REF['iter']}, square {HYB_REF_ITERS}) wall {wall:.3f} s, "
          f"{res.iter / wall:.1f} iterations/s; [race rank, hand-over, polar "
          f"reseeds] {ev} (JAX {N1_REF['events']}); K10 launches {k10} "
          f"({k10 / max(res.iter, 1):.2f} an iteration)")
    print("phase N1 launches: " + json.dumps({e: n for e, n in entries.items()
                                              if n}))
    check(res.status == 1, f"N1: status {res.status}")
    check(abs(res.objval - N1_REF["objval"]) <= bound,
          f"N1: objval {res.objval} vs {N1_REF['objval']}")
    check(k10 >= 2 * res.iter, f"N1: K10 launched {k10} < 2 x {res.iter}")
    X = res.primal[Xidx]
    check(float(np.linalg.eigvalsh(X)[0]) >= -1e-6 * float(np.linalg.norm(X)),
          "N1: X not PSD")
    out["N1"] = (entries, shapes)
    run = _n_steps(torch, kernels, problem,
                   tx.Options(hybrid_precision=False, square_form=False), False)
    entries_f = run["entries"]
    _n_iterate_check("N1 f64 packed", run["fetch"], run["norm"], run["lmin"],
                     N1_F64_REF, smi, run["wall"])
    check(entries_f["tri_to_square_f64"] >= N_ITERS
          and entries_f["primal_update_sym_f64"] >= N_ITERS,
          "N1 f64: K10 / K4 not launched every iteration")

    # ---- N2: the sign-based subspace race
    res, wall, entries, counts, shapes, log = _solve_once(
        torch, kernels, tx.solve, problem, tx.Options(
            subspace_sign=True, log_verbose=True, log_freq=10 ** 9,
            timer_verbose=True))
    bound = N2_OBJ_RTOL * (1 + abs(N2_REF["objval"]))
    ev = _events(log)
    k17 = entries["subspace_sign_f32"]
    # K7 runs twice a step: in each race subspace step, each polar reseed
    # of the race and each mixed polish step (one K8 launch each)
    steps = (entries["cholqr_f32"] // 2 - max(ev[2], 0)
             - entries["ritz_accept_f64"])
    print(f"phase N2 (Options(subspace_sign=True)) on {smi}: status "
          f"{res.status} objval {res.objval!r} (JAX {N2_REF['objval']!r}, diff "
          f"{res.objval - N2_REF['objval']:.3e}, bound {bound:.3e}) iterations "
          f"{res.iter} (JAX {N2_REF['iter']}) wall {wall:.3f} s; [race rank, "
          f"hand-over, polar reseeds] {ev} (JAX {N2_REF['events']}); race "
          f"subspace steps {steps}: K17 launches {k17}, accepts "
          f"{k17 - max(ev[2], 0)}, fallbacks {max(ev[2], 0)}; K8 launches f32 "
          f"{entries['ritz_accept_f32']}, f64 {entries['ritz_accept_f64']}")
    print("phase N2 launches: " + json.dumps({e: n for e, n in entries.items()
                                              if n}))
    check(res.status == 1, f"N2: status {res.status}")
    check(abs(res.objval - N2_REF["objval"]) <= bound,
          f"N2: objval {res.objval} vs {N2_REF['objval']}")
    check(k17 > 0 and k17 == steps,
          f"N2: K17 launched {k17} times in {steps} race subspace steps")
    check(entries["ritz_accept_f32"] == 0, "N2: K8 launched in the f32 race")
    out["N2"] = (entries, shapes)

    # ---- N3: the accept-always step, both layouts, the default mixed
    # program and its f64 form
    for mixed, square in ((True, True), (True, False), (False, True),
                          (False, False)):
        tag = ("N3" if mixed else "N3f64") + ("sq" if square else "tri")
        entry = "batched_subspace_f64_f32" if mixed else "batched_subspace_f64"
        run = _n_steps(torch, kernels, problem, tx.Options(
            **N3_OPTS, square_form=square, subspace_mixed=mixed), square)
        entries3, syncs = run["entries"], run["syncs"]
        _n_iterate_check(f"{tag} (accept-always, "
                         f"{'mixed' if mixed else 'f64'}, "
                         f"{'square' if square else 'packed'})", run["fetch"],
                         run["norm"], run["lmin"], N3_REF[tag], smi,
                         run["wall"],
                         *((N3_MIXED_RTOL, (4, 5)) if mixed else ()))
        k12 = entries3[entry]
        print(f"phase {tag}: K12 launches {k12}, K8 launches "
              f"{entries3['ritz_accept_f64'] + entries3['ritz_accept_f32']}, "
              f"synchronising calls after iteration 1: {len(syncs)}"
              + (f" ({syncs[:3]})" if syncs else ""))
        check(k12 == N_ITERS, f"{tag}: K12 launched {k12} != {N_ITERS}")
        check(entries3["ritz_accept_f64"] + entries3["ritz_accept_f32"] == 0,
              f"{tag}: K8 launched")
        check(not syncs, f"{tag}: a synchronising call in the iteration")
        out[tag] = (entries3, collections.Counter({
            (entry, (1, SIDE, 16)): k12}))

    # ---- N4: checkpoint and resume
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/n4.npz"
        r1, w1, *_ = _solve_once(torch, kernels, tx.solve, problem, tx.Options(
            hybrid_precision=False, checkpoint_path=path,
            checkpoint_freq=N4_SAVE, max_iter=2 * N4_SAVE, chunk_iters=N4_SAVE))
        check(r1.status == 3 and os.path.exists(path),
              f"N4: status {r1.status}, checkpoint written "
              f"{os.path.exists(path)}")
        r2, w2, *_ = _solve_once(torch, kernels, tx.solve, problem,
                                 tx.Options(hybrid_precision=False),
                                 resume_from=path)
        print(f"phase N4 (f64 checkpoint at {2 * N4_SAVE}) on {smi}: status "
              f"{r1.status} in {w1:.3f} s; resumed: status {r2.status} objval "
              f"{r2.objval!r} (phase A's reference {REF_OBJ!r}, diff "
              f"{r2.objval - REF_OBJ:.3e}) iterations {r2.iter} (phase A "
              f"{REF_ITERS}) in {w2:.3f} s")
        check(r2.status == 1 and abs(r2.objval - REF_OBJ)
              <= 1e-4 * (1 + abs(REF_OBJ)), f"N4: resumed {r2.status} "
              f"{r2.objval}")
        path = f"{tmp}/n4race.npz"
        r1, w1, *_, log1 = _solve_once(torch, kernels, tx.solve, problem,
                                       tx.Options(
                                           checkpoint_path=path,
                                           checkpoint_freq=N4_RACE_SAVE,
                                           max_iter=N4_RACE_SAVE,
                                           log_verbose=True, log_freq=10 ** 9))
        fields, phase32 = load_checkpoint_numpy(path)
        r2, w2, *_, log2 = _solve_once(torch, kernels, tx.solve, problem,
                                       tx.Options(log_verbose=True,
                                                  log_freq=10 ** 9),
                                       resume_from=path)
        ev1, ev2 = _events(log1), _events(log2)
        print(f"phase N4 (race checkpoint at {int(fields['iter'])}: f32 "
              f"{phase32}, basis {fields['warm'][0].shape}) on {smi}: entry "
              f"rank {ev1[0]}; resumed: status {r2.status} objval "
              f"{r2.objval!r} (phase C's reference {HYB_REF_OBJ!r}, diff "
              f"{r2.objval - HYB_REF_OBJ:.3e}) iterations {r2.iter} (phase C "
              f"{HYB_REF_ITERS}), hand-over at {ev2[1]}, a second race entry "
              f"{'yes' if ev2[0] else 'no'}, in {w2:.3f} s")
        check(phase32 and fields["warm"][0].ndim == 2 and ev1[0] > 0,
              "N4: the race checkpoint is not in the f32 subspace race")
        check(ev2[0] == 0 and ev2[1] > N4_RACE_SAVE,
              "N4: the resume did not continue in the f32 subspace race")
        check(r2.status == 1 and abs(r2.objval - HYB_REF_OBJ)
              <= 1e-4 * (1 + abs(HYB_REF_OBJ)),
              f"N4: race resume {r2.status} {r2.objval}")
    return out


def phase_n_rows(rows, runs):
    """Each phase-N row's launches: K17's at its shape in N2, K12's at its
    shape in N3 (both layouts), K10's and the packed K4's entry point in
    N1's solve; (rows for the kernels line, rows left off it)."""
    kept, left = [], []
    n3 = ({}, collections.Counter())
    for tag in ("N3sq", "N3tri", "N3f64sq", "N3f64tri"):
        for e, n in runs[tag][0].items():
            n3[0][e] = n3[0].get(e, 0) + n
        n3[1].update(runs[tag][1])
    for row in rows:
        name = row["name"]
        entries, shapes = (runs["N2"] if name.startswith("subspace_sign")
                           else n3 if name.startswith("batched_subspace")
                           else runs["N1"])
        a, b = assign_launches([row], shapes, entries)
        kept += [r for r in a if r["launches"]]
        left += b + [r for r in a if not r["launches"]]
    return kept, left


# ---------------------------------------------------------------------------
# Phase O: the sharded solves (B14) and K18, the dense-eigh reconstruction
# (B6)

O_SIDES = (16, 100, 250, 1024)
# K18 against its twin, max |err| relative to ||Xp||_F: f64 the rounding of
# two sums of n terms in other orders (cuBLAS blocks them), f32 the same
# at single precision
O_RTOL = {"f64": 1e-13, "f32": 1e-6, "f64_f32": 1e-6}
O_RANKS = 2  # two processes sharing the one card over gloo
O1_SIZE, O1_SIDE = 16, 40
O1_OBJ_ATOL = 1e-9
O2_OBJ_RTOL = 1e-4  # the default solve's bound against the unsharded one
O_F64_ITERS = 300
# a rank's 300-iteration f64 iterate against the unsharded one where not
# bit for bit (the CPU test's bound)
O_F64_RTOL = 1e-12
O_NCCL_SIDE = 16


def reconstruct_kernel_checks(torch, kernels, rng, dev):
    """K18 against its plain twin at sides O_SIDES in f64, f32 and the
    mixed pair (f64 eigenpairs, f32 block): the whole product and the
    row slabs of 2 and 4 ranks (every slab checked, the first of each
    split timed beside the twin and torch.matmul of the same rows), on
    the eigenpairs of a random symmetric matrix (about half of them
    positive).  Bound: V, w read and the rows written once, against 2
    rows n r flops for r positive eigenvalues.  Returns (rows, rows
    checked but not timed)."""
    from proxsdp_tpu_torch.parallel.dist import split

    rows, off = [], []
    for n in O_SIDES:
        A = rng.standard_normal((n, n))
        A = A + A.T
        for pair in ("f64", "f32", "f64_f32"):
            dt = torch.float32 if pair == "f32" else torch.float64
            out_dt = torch.float64 if pair == "f64" else torch.float32
            w, V = torch.linalg.eigh(torch.tensor(A, dtype=dt, device=dev))
            V = V.contiguous()  # eigh's column-major V, copied outside the timing
            pos = torch.clamp_min(w, 0.0)
            npos = int(torch.sum(pos > 0))
            fro = float(torch.linalg.norm(kernels.psd_reconstruct_plain(
                V, w, 0, n, torch.float64)))

            def cmp(got, want, fro=fro):
                err, _ = compare(torch, got, want)
                return err, err / max(fro, 1e-300)

            for parts in (1, 2, 4):
                for r, (r0, r1) in enumerate(split(n, parts)):
                    if r1 == r0:
                        continue
                    timed = r == 0
                    check_entry(
                        torch, kernels, rows if timed else off,
                        "psd_reconstruct", pair, "psd_reconstruct.cu",
                        "proxsdp_tpu/ops/cones.py:204",
                        lambda f, V=V, w=w, r0=r0, r1=r1, o=out_dt:
                            (f(V, w, r0, r1, o),),
                        kernels.psd_reconstruct_plain, (V, w),
                        (torch.empty((r1 - r0, n), dtype=out_dt, device=dev),),
                        2 * (r1 - r0) * n * npos,
                        library=(lambda V=V, pos=pos, r0=r0, r1=r1:
                                 torch.matmul(V[r0:r1] * pos[None, :], V.T)),
                        compare_fn=cmp, tol=O_RTOL[pair], timed=timed,
                        label=f"O0: side {n}, rows {r0}-{r1} of {parts}",
                        note=f" ({npos} positive; error relative to "
                        f"||Xp||_F; library: torch.matmul)")
                    if timed and n == SIDE and pair == "f64" and parts < 4:
                        LAUNCH_US.append((
                            f"psd_reconstruct_f64 (side {n}, rows {r0}-{r1})",
                            lambda V=V, w=w, r0=r0, r1=r1:
                                kernels.psd_reconstruct(V, w, r0, r1),
                            "psd_reconstruct_kernel"))
    return rows, off


def o_rank_job(mesh):
    """One rank of phase O's two (gloo, one card): O1, solve_batch of the
    O1 instances over the ranks; O2, solve_sharded of the side-250 max-cut
    under the default Options(), then O_F64_ITERS iterations of its f64
    program with the operator sharded.  Each run counted (launches set to
    0 just before, read just after) and timed; returns host data."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from proxsdp_tpu_torch import Options, kernels, solve_batch
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu_torch.parallel.sharded import solve_sharded, tp_context

    global SHAPES
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kernels.load()
    SHAPES = ShapeCounts(kernels)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": torch.distributed.get_rank(), "device": str(dev)}

    def counted(fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        SHAPES.reset()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, dict(kernels.launch_counts),
                collections.Counter(SHAPES.counts))

    # ---- O1: the instances over the ranks (an axis named "batch" over
    # the same two processes)
    bmesh = DeviceMesh(mesh.device_type, mesh.mesh.tolist(),
                       mesh_dim_names=("batch",))
    probs = [maxcut_problem(random_graph_weights(s, O1_SIDE))[0]
             for s in range(O1_SIZE)]
    res, wall, entries, _ = counted(lambda: solve_batch(
        probs, Options(hybrid_precision=False), mesh=bmesh, device=dev))
    out["O1"] = {"results": [(r.status, r.objval, r.iter) for r in res],
                 "wall": wall, "entries": entries}

    # ---- O2: the side-250 max-cut, its block split over the ranks
    problem, _ = maxcut_problem(random_graph_weights(0, SIDE))
    with tp_context(mesh) as axis:
        c0 = axis.collectives
        res, wall, entries, shapes = counted(lambda: solve_sharded(
            problem, mesh, Options()))
        out["O2"] = {"status": res.status, "objval": res.objval,
                     "iter": res.iter, "wall": wall, "entries": entries,
                     "shapes": shapes, "collectives": axis.collectives - c0}
        c0 = axis.collectives
        run = _n_steps(torch, kernels, problem,
                       Options(hybrid_precision=False, tp_shards=axis.size),
                       iters=O_F64_ITERS, axis=axis)
        out["O2f64"] = {k: run[k] for k in ("x", "y", "fetch", "wall",
                                            "entries", "shapes")}
        out["O2f64"]["collectives"] = axis.collectives - c0
    return out


def _o_nccl(torch, kernels, problem):
    """One solve_sharded at world size 1 over NCCL in this process (the
    path a machine with a card a rank takes), counted: (result, seconds,
    launches by entry point and shape, collectives, the backend)."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh

    from proxsdp_tpu_torch import Options
    from proxsdp_tpu_torch.parallel.dist import free_port
    from proxsdp_tpu_torch.parallel.sharded import solve_sharded, tp_context

    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                             rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", [0], mesh_dim_names=("tp",))
        with tp_context(mesh) as axis:
            res, wall, entries, _, shapes, _ = _solve_once(
                torch, kernels, lambda p, o: solve_sharded(p, mesh, o),
                problem, Options())
            return res, wall, entries, shapes, axis.collectives, axis.backend
    finally:
        tdist.destroy_process_group()


def phase_o(torch, kernels, smi, ref_default=None):
    """The sharded solves on the card, two ranks as two processes sharing
    it over gloo (NCCL refuses two ranks on one device), and one NCCL run
    at world size 1.  O1: solve_batch(mesh=...) of O1_SIZE side-40 max-cut
    instances in the f64 program, every rank's Results against the
    unsharded card batch (equal statuses, |dobj| <= O1_OBJ_ATOL).  O2:
    solve_sharded of the side-250 max-cut under the default Options()
    (status 1, within O2_OBJ_RTOL (1 + |obj|) of the unsharded card solve,
    ``ref_default`` where phase C gave it), then O_F64_ITERS iterations of
    its f64 program, each rank's x, y and fetched scalars against the
    unsharded card run (bit for bit, else within O_F64_RTOL with the
    differences printed); the NCCL run: the side-16 max-cut's default
    solve against the unsharded one.  Prints K18's launches a rank,
    collectives and ms an iteration.  Returns {tag: (counts by entry
    point, by entry point and shape)} of the counted runs whose launches
    the kernels line reads: the unsharded f64 program ("ref"), rank 0's
    O2 runs ("O2", "O2f64") and the NCCL solve ("nccl")."""
    from proxsdp_tpu_torch import Options, solve, solve_batch
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu_torch.parallel.dist import spawn

    runs = {}
    problem, _ = maxcut_problem(random_graph_weights(0, SIDE))
    # ---- the unsharded references on this card
    t_ref = time.perf_counter()
    probs = [maxcut_problem(random_graph_weights(s, O1_SIDE))[0]
             for s in range(O1_SIZE)]
    o1_ref = solve_batch(probs, Options(hybrid_precision=False))
    if ref_default is None:
        ref_default = solve(problem, Options())
    ref = _n_steps(torch, kernels, problem, Options(hybrid_precision=False),
                   iters=O_F64_ITERS)
    x_ref, y_ref, f_ref, wall_ref = ref["x"], ref["y"], ref["fetch"], ref["wall"]
    entries = ref["entries"]
    runs["ref"] = (entries, ref["shapes"])
    check(entries["psd_reconstruct_f64"] >= O_F64_ITERS,
          "O: psd_reconstruct_f64 (K18) launched less than once an iteration "
          "of the unsharded f64 program")
    print(f"phase O references: {time.perf_counter() - t_ref:.1f} s (the "
          f"unsharded f64 program {1e3 * wall_ref / O_F64_ITERS:.2f} "
          "ms/iteration)")

    # ---- the ranks (one spawn: O1 then O2)
    t_spawn = time.perf_counter()
    outs = spawn(o_rank_job, O_RANKS, backend="gloo", device_type="cuda",
                 threads=0, timeout=600)
    print(f"phase O ranks: {time.perf_counter() - t_spawn:.1f} s for "
          f"{O_RANKS} processes on {smi} (process start included)")
    for out in outs:
        check(out["device"].startswith("cuda"), f"O: rank {out['rank']} on "
              f"{out['device']}")

    # O1
    for out in outs:
        got = out["O1"]["results"]
        check(len(got) == O1_SIZE, f"O1: rank {out['rank']} returned "
              f"{len(got)} Results, want {O1_SIZE}")
        for i, ((st, obj, it), r) in enumerate(zip(got, o1_ref)):
            check(st == r.status == 1 and abs(obj - r.objval) <= O1_OBJ_ATOL,
                  f"O1: rank {out['rank']} instance {i}: status {st} obj "
                  f"{obj!r} vs the unsharded {r.status} {r.objval!r}")
    d1 = max(abs(obj - r.objval) for (_, obj, _), r in
             zip(outs[0]["O1"]["results"], o1_ref))
    e1 = outs[0]["O1"]["entries"]
    walls = ", ".join(f"rank {o['rank']} {o['O1']['wall']:.2f} s" for o in outs)
    print(f"phase O1 (solve_batch, {O1_SIZE} side-{O1_SIDE} instances over "
          f"{O_RANKS} ranks, f64 program): all status 1, max |dobj| {d1:.3e} "
          f"from the unsharded card batch (bound {O1_OBJ_ATOL:.0e}); {walls}; "
          f"rank 0 launches batched_psd_eigh {e1['batched_psd_eigh_f64']}, "
          f"linesearch_loop_batch {e1['linesearch_loop_batch_f64']}")
    check(e1["batched_psd_eigh_f64"] > 0 and e1["linesearch_loop_batch_f64"] > 0,
          "O1: the batch kernels did not launch on rank 0")

    # O2: the default solve
    bound = O2_OBJ_RTOL * (1 + abs(ref_default.objval))
    for out in outs:
        o2 = out["O2"]
        check(o2["status"] == 1 and abs(o2["objval"] - ref_default.objval)
              <= bound, f"O2: rank {out['rank']} status {o2['status']} objval "
              f"{o2['objval']!r} vs the unsharded {ref_default.objval!r}")
    check(len({(o["O2"]["objval"], o["O2"]["iter"]) for o in outs}) == 1,
          "O2: the ranks' answers differ")
    o2 = outs[0]["O2"]
    e2 = o2["entries"]
    print(f"phase O2 (solve_sharded, side {SIDE}, default Options(), "
          f"{O_RANKS} ranks): status {o2['status']} objval {o2['objval']!r} "
          f"(unsharded {ref_default.objval!r}, diff "
          f"{o2['objval'] - ref_default.objval:.3e}, bound {bound:.3f}) "
          f"iterations {o2['iter']} (unsharded {ref_default.iter}); "
          f"{o2['wall']:.2f} s, {1e3 * o2['wall'] / o2['iter']:.2f} "
          f"ms/iteration, {o2['collectives'] / o2['iter']:.1f} collectives an "
          f"iteration; rank 0 launches: ns_gemm_f32 {e2['ns_gemm_f32']}, "
          f"psd_reconstruct {e2['psd_reconstruct_f64']} f64 / "
          f"{e2['psd_reconstruct_f32']} f32, ls_dual_update "
          f"{e2['ls_dual_update_f32']} f32 / {e2['ls_dual_update_f64']} f64, "
          f"linesearch_loop {e2['linesearch_loop_f32'] + e2['linesearch_loop_f64']}")
    check(e2["ns_gemm_f32"] > 0 and e2["ls_dual_update_f32"] > 0
          and e2["sq_dist_f32"] > 0 and e2["ell_spmv_f32"] > 0,
          "O2: the race's row-slab K5, K2, sq_dist or K1 did not launch")
    check(e2["linesearch_loop_f32"] == e2["linesearch_loop_f64"] == 0,
          "O2: K15 launched under tensor parallelism")
    runs["O2"] = (e2, o2["shapes"])

    # O2: the f64 program's iterate
    worst = 0.0
    for out in outs:
        f = out["O2f64"]
        same = (np.array_equal(f["x"], x_ref) and np.array_equal(f["y"], y_ref)
                and np.array_equal(f["fetch"], f_ref))
        if not same:
            rel = max(float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                                         1e-300)
                      for a, b in ((f["x"], x_ref), (f["y"], y_ref),
                                   (f["fetch"][2:9], f_ref[2:9])))
            worst = max(worst, rel)
            print(f"phase O2 FINDING: rank {out['rank']}'s f64 iterate is not "
                  f"bit for bit the unsharded one: max relative difference "
                  f"{rel:.3e} (x, y and the fetched residuals)")
            check(rel <= O_F64_RTOL, f"O2: rank {out['rank']}'s f64 iterate "
                  f"differs by {rel:.3e} > {O_F64_RTOL}")
    f = outs[0]["O2f64"]
    ef = f["entries"]
    k18 = [o["O2f64"]["entries"]["psd_reconstruct_f64"] for o in outs]
    print(f"phase O2 f64 program ({O_F64_ITERS} iterations from init_state, "
          f"{O_RANKS} ranks): x, y and scalars "
          + ("bit for bit the unsharded card run's" if worst == 0.0 else
             f"within {worst:.3e} of the unsharded card run's")
          + f"; {1e3 * f['wall'] / O_F64_ITERS:.2f} ms/iteration (unsharded "
          f"{1e3 * wall_ref / O_F64_ITERS:.2f}), "
          f"{f['collectives'] / O_F64_ITERS:.1f} collectives an iteration; "
          f"K18 launches a rank {k18} (shapes "
          + ", ".join(f"{list(k)} {n}" for (e, k), n in f["shapes"].items()
                      if e.startswith("psd_reconstruct"))
          + f"), K1 {ef['ell_spmv_f64']}, K2 {ef['ls_dual_update_f64']}, "
          f"sq_dist {ef['sq_dist_f64']} on rank 0")
    check(all(n >= O_F64_ITERS for n in k18),
          "O2: K18 launched less than once an iteration on a rank")
    runs["O2f64"] = (ef, f["shapes"])

    # ---- NCCL at world size 1, in this process
    small, _ = maxcut_problem(random_graph_weights(0, O_NCCL_SIDE))
    want = solve(small, Options())
    res, wall, entries, shapes, ncoll, backend = _o_nccl(torch, kernels, small)
    bound = O2_OBJ_RTOL * (1 + abs(want.objval))
    print(f"phase O NCCL (solve_sharded at world size 1, backend {backend}, "
          f"side {O_NCCL_SIDE}, default Options()): status {res.status} "
          f"objval {res.objval!r} (unsharded {want.objval!r}, diff "
          f"{res.objval - want.objval:.3e}, bound {bound:.2e}); {wall:.2f} s, "
          f"{ncoll} collectives in {res.iter} iterations, K18 "
          f"{entries['psd_reconstruct_f32']} f32 / "
          f"{entries['psd_reconstruct_f64']} f64")
    check(backend == "nccl" and ncoll > 0, "O: the NCCL run made no collective")
    check(res.status == 1 and abs(res.objval - want.objval) <= bound,
          f"O NCCL: status {res.status} objval {res.objval} vs {want.objval}")
    runs["nccl"] = (entries, shapes)
    return runs


def phase_o_rows(rows, runs):
    """Each K18 row's launches at its shape in phase O's counted runs: the
    unsharded f64 program's, rank 0's O2 runs' and the NCCL solve's;
    (rows for the kernels line, rows left off it)."""
    shapes = collections.Counter()
    entries = collections.Counter()
    for e, sh in runs.values():
        shapes.update(sh)
        entries.update(e)
    return assign_launches(rows, shapes, entries)


# ---------------------------------------------------------------------------
# Phase P: the iteration's control (K19), the restart-to-average (K20a,
# K20b) and the batch's masked freeze (K21) -- B8

P_AVG_RTOL = {"f64": 1e-15, "f32": 1e-6}  # K20a against its twin, relative
P_STEPS = 20  # _scalar_step calls in a profiled window
P_SOURCES = {"control": "control.cu", "restart_average": "restart_avg.cu",
             "restart_adopt": "restart_avg.cu", "freeze_rows": "freeze_rows.cu"}
P_REPLACES = {
    "control": "proxsdp_tpu/solver.py:563-807 (_residuals_and_gap's "
               "formulas and ring writes, _control)",
    "restart_average": "proxsdp_tpu/solver.py:809-860 (the restart's sums "
                       "and its test's reductions)",
    "restart_adopt": "proxsdp_tpu/solver.py:862-897 (the jump to the average)",
    "freeze_rows": "proxsdp_tpu/parallel/batch.py:149-155 (the masked freeze)",
}


class ScalarStepRecorder:
    """While installed (``with``), keeps the arguments of
    ``solver._scalar_step``'s 1st, 100th and last whole calls (residuals
    and control) of the single solve and of the batch: references, since
    no step writes a state in place."""

    def __init__(self):
        self.calls = {"single": 0, "batch": 0}
        self.kept = {"single": {}, "batch": {}}

    def __enter__(self):
        from proxsdp_tpu_torch import solver as tsolver
        from proxsdp_tpu_torch.parallel import batch as tbatch

        orig = self._orig = tsolver._scalar_step

        def recorded(s, o, layout, opts, step, residuals=True,
                     control=True):
            if residuals and control:
                kind = "batch" if s.x.dim() == 2 else "single"
                self.calls[kind] += 1
                args = (s, o, layout, opts, step)
                if self.calls[kind] in (1, 100):
                    self.kept[kind][self.calls[kind]] = args
                self.kept[kind]["last"] = args
            return orig(s, o, layout, opts, step, residuals, control)

        tsolver._scalar_step = tbatch._scalar_step = recorded
        return self

    def __exit__(self, *exc):
        from proxsdp_tpu_torch import solver as tsolver
        from proxsdp_tpu_torch.parallel import batch as tbatch

        tsolver._scalar_step = tbatch._scalar_step = self._orig


def _exact(torch, label):
    """compare_fn for a bit-for-bit row: NaN pairs and equal values count
    as equal; any other difference fails the row (tolerance 0)."""
    def fn(got, want):
        err, rel = compare(torch, got, want)
        check(err == 0.0, f"{label}: differs from its twin by {err:.3e}")
        return err, rel
    return fn


def _fold_red(torch, parts):
    """K20a's (P, 5) f64 partials of one instance folded (sums, then the
    two maxima); the plain twin's (5,) as it is."""
    if parts.dim() == 1:
        return parts
    return torch.cat([parts[:, :3].sum(0), parts[:, 3:].amax(0)])


def _red_scale(torch, kernels, args, p, m):
    """The magnitude each of K20a's reductions is held against: the sum of
    |terms| of each dot, the largest |value| of each maximum."""
    x, y, Mx, Mty, ax, ay, amx, amty, aw, ps, c, b, h = args
    *avgs, _ = kernels.restart_average_plain(*args, p, m)
    wsum = torch.clamp_min(aw + ps, 1e-30).unsqueeze(-1)
    xa, ya, mxa = avgs[0] / wsum, avgs[1] / wsum, avgs[2] / wsum

    def dsum(a, v):
        return (a.abs() * v.abs()).sum(-1)
    one = torch.ones_like(aw)
    return torch.stack([
        dsum(c, xa), dsum(b, ya[..., :p]) if p else one,
        dsum(h, ya[..., p:]) if m else one,
        torch.amax((mxa[..., :p] - b).abs(), -1) if p else one,
        torch.amax((mxa[..., p:] - h).abs(), -1) if m else one,
    ], dim=-1).double().clamp_min(1e-300)


def _flat_control(upd, stalled, wsum):
    keys = sorted(upd)
    out = [upd[k] for k in keys]
    if stalled is not None:
        out += [stalled.to(upd["status"].dtype), wsum]
    return tuple(out)


def control_checks(torch, kernels, label, s, o, layout, opts, step, out,
                   fired=None, timed=False):
    """Hold K20a, K19 and K20b to their twins on the card on one state (the
    single solve's or a batch's): K20a's averages within P_AVG_RTOL and its
    reductions within it of their sums of |terms|; K19 (given K3's pass-1
    partials where ``s`` is a pre-residual state: the iteration's path;
    else its decisions alone) and K20b bit for bit, on the same inputs as
    their twins.  ``step``: the runner's kernels.ControlStep (the kernels
    run through it, as on the iteration's path).  ``fired(input,
    output)``: the crafted case's branch test, on the kernel's output.  With ``timed``, the rows go to ``out``
    (check_entry: times, bound).  Returns (the branch fired, stalled)."""
    from proxsdp_tpu_torch import convert

    batched = s.x.dim() == 2
    dt = s.x.dtype
    sfx = "f32" if dt == torch.float32 else "f64"
    p, m = layout.p, layout.m
    cfg, sides = step.cfg, step.sides_arr
    adaptive = opts.restart == "adaptive"
    residual = fired is None  # a recorded state: the iteration's path
    r_k = r_p = None
    if residual:
        args3 = (s.x, s.x_old, s.Mty, s.Mty_old, s.primal_step, s.y, s.y_old,
                 s.Mx, s.Mx_old, s.dual_step, o.b, o.h, o.c, p, m)
        if batched:
            r_k = r_p = kernels.residuals_batch(*args3)
        else:
            sq = layout.sdp_sides if layout.square_form else ()
            r_k = kernels.residuals(*args3, sq, row_scale=o.row_unscale,
                                    fold=False)
            r_p = kernels.residuals(*args3, sq, row_scale=o.row_unscale)
        s = s.replace(x_old=s.x, y_old=s.y, Mty_old=s.Mty, Mx_old=s.Mx)
    tag = f"{label}, {sfx}"
    red_t = avgs = None
    if adaptive:
        a_args = (s.x, s.y, s.Mx, s.Mty, s.avg_x, s.avg_y, s.avg_Mx,
                  s.avg_Mty, s.avg_w, s.primal_step, o.c, o.b, o.h)
        entry = "restart_average_batch" if batched else "restart_average"
        got = step.restart_average(s, o)
        want = kernels.restart_average_plain(*a_args, p, m)
        torch.cuda.synchronize()
        err, rel = compare(torch, got[:4], want[:4])
        check(rel <= P_AVG_RTOL[sfx], f"{entry} ({tag}): averages {rel:.3e}")
        red_k = got[4] if batched else _fold_red(torch, got[4])
        scale = _red_scale(torch, kernels, a_args, p, m)
        used = [0] + [1, 3] * bool(p) + [2, 4] * bool(m)  # read by K19
        red_err = float(((red_k - want[4].double()).abs()
                         / scale)[..., used].max())
        check(red_err <= P_AVG_RTOL[sfx],
              f"{entry} ({tag}): reductions {red_err:.3e} of their scale")
        print(f"phase P {entry} ({tag}): averages max_abs_err {err:.3e} "
              f"rel {rel:.3e}, reductions {red_err:.3e} of their |terms| "
              f"(tolerance {P_AVG_RTOL[sfx]:g})")
        red_t = red_k.to(dt)
        avgs = got[:4]
        if timed:
            check_entry(torch, kernels, out, entry, sfx, P_SOURCES[
                "restart_average"], P_REPLACES["restart_average"],
                lambda fn: tuple((step.restart_average(s, o)
                                  if fn is kernels.restart_average
                                  else fn(*a_args, p, m))[:4]),
                kernels.restart_average_plain, a_args, got, 0,
                compare_fn=lambda g, w: compare(torch, g, w),
                tol=P_AVG_RTOL[sfx], label=label, wrapper="restart_average")
            _p_device_us(torch, f"{entry}_{sfx} ({label})",
                         lambda: step.restart_average(s, o),
                         "restart_average_kernel")

    # K19 reads K20a's values as f64 rows: the partials' (1, 5) fold here
    red_f64 = None if red_t is None else red_t.double().reshape(-1, 5)

    def call(fn):
        if fn is kernels.control:
            return _flat_control(*step.control(s, o, r=r_k, red=red_f64))
        return _flat_control(*fn(s, o, cfg, sides, r=r_p, red=red_t))

    entry = "control_batch" if batched else "control"
    got_c = step.control(s, o, r=r_k, red=red_f64)
    want_c = kernels.control_plain(s, o, cfg, sides, r=r_p, red=red_t)
    torch.cuda.synchronize()
    err, _ = compare(torch, _flat_control(*got_c), _flat_control(*want_c))
    check(err == 0.0, f"{entry} ({tag}): differs from its twin by {err:.3e}")
    if timed:
        inputs = [getattr(s, f) for f in kernels.iteration_control.RINGS]
        check_entry(torch, kernels, out, entry, sfx, P_SOURCES["control"],
                    P_REPLACES["control"], call, kernels.control_plain,
                    inputs + [r_k, red_t], _flat_control(*got_c), 0,
                    compare_fn=_exact(torch, entry), tol=0.0, label=label,
                    wrapper="control")
        _p_device_us(torch, f"{entry}_{sfx} ({label})",
                     lambda: call(kernels.control),
                     "control_batch_kernel" if batched else "control_kernel")
    upd, stalled, wsum = got_c
    ok = True
    if fired is not None:
        new = s.replace(**upd)
        ok = fired(convert.state_to_numpy(s), convert.state_to_numpy(new))
    if adaptive:
        b_args = (s.x, s.y, s.Mx, s.Mty, *avgs, stalled, wsum)
        entry = "restart_adopt_batch" if batched else "restart_adopt"
        got = step.restart_adopt(s, avgs, stalled, wsum)
        want = kernels.restart_adopt_plain(*b_args[:8], stalled.bool(), wsum)
        torch.cuda.synchronize()
        err, _ = compare(torch, got, want)
        check(err == 0.0, f"{entry} ({tag}): differs from its twin by {err:.3e}")
        if timed:
            check_entry(torch, kernels, out, entry, sfx, P_SOURCES[
                "restart_adopt"], P_REPLACES["restart_adopt"],
                lambda fn: tuple(step.restart_adopt(s, avgs, stalled, wsum)
                                 if fn is kernels.restart_adopt
                                 else fn(*b_args[:8], stalled.bool(), wsum)),
                kernels.restart_adopt_plain, b_args, got, 0,
                compare_fn=_exact(torch, entry), tol=0.0, label=label,
                wrapper="restart_adopt")
            _p_device_us(torch, f"{entry}_{sfx} ({label})",
                         lambda: step.restart_adopt(s, avgs, stalled, wsum),
                         "restart_adopt_kernel")
        stalled = stalled.bool()
    return ok, stalled


def _p_program(pkg):
    """A small program with every row kind K19 reads: a PSD block of side
    4, an SOC block of length 3, five equality and two inequality rows."""
    o = pkg.Optimizer()
    X = o.add_psd_var(4)
    sv = o.add_soc_var(3)
    for i in range(4):
        o.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    o.add_eq_constraint({int(sv[0]): 1.0}, 2.0)
    o.add_ineq_constraint({int(X[0, 1]): 1.0}, 0.3)
    o.add_ineq_constraint({int(X[1, 2]): 1.0, int(sv[1]): 1.0}, 0.2)
    W = np.arange(16.0).reshape(4, 4)
    obj = o.psd_inner_product_coeffs(X, (W + W.T) / 10.0)
    obj[int(sv[2])] = 0.5
    o.set_objective(obj)
    return o.build_problem()


def _card_operands(torch, setup, dt, dev, B=None):
    """The Operands of ``setup`` on the card (``B``: a batch of B copies,
    the operator shared)."""
    from proxsdp_tpu_torch import convert
    from proxsdp_tpu_torch.ops.linop import build_linop

    o = convert.operands_from_numpy(
        M=build_linop(setup.A, setup.G, dt, device=dev), b=setup.b,
        h=setup.h, c=setup.c, norm_b=setup.norm_b, norm_h=setup.norm_h,
        norm_c=setup.norm_c, obj_scale=setup.obj_scale * setup.rhs_scale,
        device=dev, dtype=dt)
    if B is None:
        return o
    import dataclasses

    return dataclasses.replace(o, **{f: getattr(o, f).expand(
        (B,) + getattr(o, f).shape).contiguous() for f in (
        "b", "h", "c", "norm_b", "norm_h", "norm_c", "obj_scale")})


def crafted_checks(torch, kernels, dev):
    """Every crafted branch case (kernels.control_cases) on two layouts --
    the side-SIDE max-cut (square form) and _p_program (PSD, SOC,
    inequality rows) -- in f64 and f32, single; and each layout's
    default-options cases as one batch (the packed layout): K19 and K20b
    bit for bit, K20a within P_AVG_RTOL.  Prints which branches fired."""
    from proxsdp_tpu_torch import Options, convert
    from proxsdp_tpu_torch.kernels import control_cases
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu_torch.problem import preprocess, to_square_form
    from proxsdp_tpu_torch.solver import init_state

    import proxsdp_tpu_torch as tx

    fired_all = collections.Counter()
    names = set()
    problems = {"max-cut": maxcut_problem(random_graph_weights(0, SIDE))[0],
                "conic": _p_program(tx)}
    for lname, prob in problems.items():
        for dtype in ("float64", "float32"):
            dt = torch.float64 if dtype == "float64" else torch.float32
            opts = Options(hybrid_precision=False, dtype=dtype)
            for square in (True, False):
                setup = preprocess(prob)
                if square:
                    setup = to_square_form(setup)
                layout = setup.layout
                host = init_state(layout, opts, setup)
                cases = control_cases.branch_cases(host, opts, setup.c,
                                                   setup.b, setup.h)
                names.update(c.name for c in cases)
                if square:
                    o = _card_operands(torch, setup, dt, dev)
                    for c in cases:
                        s = convert.state_from_numpy(c.state, dev)
                        ok, _ = control_checks(
                            torch, kernels, c.name, s, o, layout, c.opts,
                            kernels.control_step(layout, c.opts, dev), [],
                            fired=c.fired)
                        check(ok, f"P: {c.name} ({lname}, {dtype}) did not "
                              "fire its branch on the card")
                        fired_all[c.name] += 1
                else:  # the default-options cases as one batch
                    same = [c for c in cases if c.opts == opts]
                    st = convert.state_from_numpy(convert.stack_states(
                        [c.state for c in same]), dev)
                    o = _card_operands(torch, setup, dt, dev, B=len(same))
                    step = kernels.control_step(layout, opts, dev)
                    control_checks(torch, kernels, f"{lname} batch of "
                                   f"{len(same)} cases", st, o, layout, opts,
                                   step, [], fired=lambda i, o_: True)
                    got = convert.state_to_numpy(_card_step(
                        torch, st, o, layout, opts, step, residuals=False))
                    for i, c in enumerate(same):
                        check(c.fired(c.state, convert.index_state(got, i)),
                              f"P: batched {c.name} ({lname}, {dtype}) did "
                              "not fire its branch")
    check(set(fired_all) == names, "P: a crafted branch was not checked")
    print("phase P branches fired on the card (single, both layouts, f64 and "
          "f32; the default-options ones also as batches): "
          + "; ".join(f"{n} x{k}" for n, k in sorted(fired_all.items())))


def _card_step(torch, s, o, layout, opts, step, residuals=True):
    from proxsdp_tpu_torch import solver as tsolver

    return tsolver._scalar_step(s, o, layout, opts, step, residuals=residuals)


def freeze_checks(torch, kernels, label, s, o, layout, opts, step, out):
    """K21 against its twin and against the torch.where per field it
    replaces (the library row), bit for bit, on a batch state and the
    state one step later (x_old is x there), every other instance
    frozen."""
    from proxsdp_tpu_torch import solver as tsolver
    from proxsdp_tpu_torch.parallel import batch as tbatch

    new = _card_step(torch, s, o, layout, opts, step)
    B = s.x.shape[0]
    mask = torch.arange(B, device=s.x.device) % 2 == 0
    flat_n, flat_o = [], []
    for name in tsolver.STATE_FIELDS:
        a, b = getattr(new, name), getattr(s, name)
        pairs = list(zip(a, b)) if name == "warm" else [(a, b)]
        for x, y in pairs:
            if x is not y:
                flat_n.append(x)
                flat_o.append(y)
    sfx = "u32"  # K21's one entry point, whatever the fields' dtypes

    def where_all():
        """parallel/batch.py's _where_rows before K21: one torch.where a
        field (46 and the warm vectors)."""
        return [torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o_)
                for n, o_ in zip(flat_n, flat_o)]

    got = tbatch._where_rows(mask, new, s)
    torch.cuda.synchronize()
    print(f"phase P freeze_rows ({label}): {len(flat_n)} fields "
          f"differ of {len(tsolver.STATE_FIELDS) - 1} + {len(s.warm)} warm")
    check(got.x_old is not got.x, "P: the freeze aliased x and x_old")
    check_entry(torch, kernels, out, "freeze_rows", sfx,
                P_SOURCES["freeze_rows"], P_REPLACES["freeze_rows"],
                lambda fn: tuple(fn(mask, flat_n, flat_o)),
                kernels.freeze_rows_plain, flat_n + flat_o + [mask],
                kernels.freeze_rows(mask, flat_n, flat_o), 0,
                library=where_all, compare_fn=_exact(torch, "freeze_rows"),
                tol=0.0, label=label)
    _p_device_us(torch, f"freeze_rows_{sfx} ({label})",
                 lambda: kernels.freeze_rows(mask, flat_n, flat_o),
                 "freeze_rows_kernel")


def _p_device_us(torch, label, fn, pattern):
    us = device_us(torch, fn, pattern, calls=10)
    print(f"kernel {label}: device "
          f"{'not measured' if us is None else f'{us:.1f} us'} a launch")


def scalar_step_kernels(torch, kernels, s, o, layout, opts, step):
    """(the port's launches a call, CUDA kernels a call, µs of device time
    a call) of solver._scalar_step (K3's first pass, K20a, K19, K20b)
    over P_STEPS calls on one state under torch.profiler; the last two
    None where the profiler shows no device events (late profiler
    sessions of a run may record some or none of them)."""
    from torch.profiler import ProfilerActivity, profile

    _card_step(torch, s, o, layout, opts, step)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(P_STEPS):
            _card_step(torch, s, o, layout, opts, step)
        torch.cuda.synchronize()
    ours = sum(kernels.launch_counts.values()) / P_STEPS
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_ev:
        return ours, None, None
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in dev_ev)
    return ours, sum(e.count for e in dev_ev) / P_STEPS, us / P_STEPS


def phase_p(torch, kernels, smi, rec_c, rec_d):
    """Phase P: K19, K20a, K20b and K21 against their twins on the states
    recorded from phase C's and D's card solves (calls 1, 100 and the
    last of each) and on every crafted branch state; the kernels an
    iteration of the scalar step, by profiler; the kernel rows."""
    rows = []
    for kind, rec in (("single", rec_c), ("batch", rec_d)):
        kept = rec.kept[kind]
        check({1, 100, "last"} <= set(kept),
              f"P: phase {'C' if kind == 'single' else 'D'} recorded only "
              f"{sorted(map(str, kept))}")
        # the rows' times: call 100 (f32 race) and the last call (f64)
        for when in (1, 100, "last"):
            s, o, layout, opts, step = kept[when]
            label = (f"phase {'C' if kind == 'single' else 'D'} call {when}, "
                     f"{opts.dtype}")
            control_checks(torch, kernels, label, s, o, layout, opts, step,
                           rows, timed=when in (100, "last"))
            ours, n_k, us = scalar_step_kernels(torch, kernels, s, o, layout,
                                                opts, step)
            print(f"phase P {label}: _scalar_step {ours:g} launches of the "
                  f"port's kernels a call, "
                  f"{'not measured' if n_k is None else f'{n_k:g}'} CUDA "
                  f"kernels a call by the profiler "
                  f"({'not measured' if us is None else f'{us:.1f} us'} of "
                  "device time)")
            check(ours == 4, f"P: _scalar_step launched {ours} of the port's "
                  "kernels a call, want 4")
            if n_k is not None:
                check(n_k <= 4, f"P: _scalar_step launched {n_k} kernels")
            if kind == "batch" and when != 1:
                freeze_checks(torch, kernels, label, s, o, layout, opts,
                              step, rows)
    crafted_checks(torch, kernels, torch.device("cuda"))
    return rows


def p_rows(rows, entries_a, entries_c, entries_d):
    """Each phase-P row's launches: the f64 single rows phase A's (the
    f64 program), the f32 ones phase C's, the batch rows phase D's; a row
    of an entry point already on the line, or not launched there, is left
    off.  (rows for the kernels line, rows left off it)."""
    kept, left, seen = [], [], set()
    for row in rows:
        entry = row["name"].split(" ")[0]
        batch = "_batch" in entry or entry.startswith("freeze_rows")
        src = entries_d if batch else (entries_a if entry.endswith("_f64")
                                       else entries_c)
        row["launches"] = src.get(entry, 0)
        if row["launches"] and entry not in seen:
            seen.add(entry)
            kept.append(row)
        else:
            left.append(row)
    return kept, left


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    from proxsdp_tpu_torch import Options, kernels, solve
    from proxsdp_tpu_torch.kernels import build
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu_torch.problem import preprocess, to_square_form

    # ---- 1. build
    global SHAPES, TRIALS
    t0 = time.perf_counter()
    kernels.load()
    SHAPES = ShapeCounts(kernels)
    TRIALS = TrialCounts(torch, kernels)
    print(f"build: {time.perf_counter() - t0:.2f} s to load, nvcc "
          f"{build.BuildInfo.seconds:.2f} s -> {build.BuildInfo.path}")
    for line in build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())

    if "--phase-k" in sys.argv[1:]:
        # phase K's kernel rows and phase K alone
        t_phase = time.perf_counter()
        k1, k1_data, k3, k_xidx = k_setups(torch)
        krows, koff = k_kernel_checks(torch, kernels, np.random.default_rng(10),
                                      torch.device("cuda"), k1, k3)
        print(f"phase K rows: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        phase_k(torch, kernels, smi, k1, k1_data, k3, k_xidx)
        print(f"phase K: {time.perf_counter() - t_phase:.1f} s")
        return 0

    if "--phase-l" in sys.argv[1:]:
        # phase L's kernel rows and phase L alone
        t_phase = time.perf_counter()
        lrows = large_kernel_checks(torch, kernels, np.random.default_rng(12),
                                    torch.device("cuda"))
        print(f"phase L rows: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        kept, left = phase_l_rows(lrows, phase_l(torch, kernels, smi))
        print(f"phase L: {time.perf_counter() - t_phase:.1f} s")
        print_launch_us(torch)
        print("phase L rows left off the line (not launched at their shape "
              "in L): " + ", ".join(row["name"] for row in left))
        print(json.dumps({"kernels": [
            {k: v for k, v in row.items() if k != "_shape"} for row in kept]}))
        return 0

    if "--phase-m" in sys.argv[1:]:
        # phase M's kernel rows and phase M alone
        t_phase = time.perf_counter()
        mrows, moff = sweep_kernel_checks(torch, kernels,
                                          np.random.default_rng(13),
                                          torch.device("cuda"))
        print(f"phase M rows: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        kept, left = phase_m_rows(mrows, phase_m(torch, kernels, smi))
        print(f"phase M: {time.perf_counter() - t_phase:.1f} s")
        print_launch_us(torch)
        print("phase M rows left off the line: " + ", ".join(
            row["name"] for row in left + moff))
        print(json.dumps({"kernels": [
            {k: v for k, v in row.items() if k != "_shape"} for row in kept]}))
        return 0

    if "--phase-n" in sys.argv[1:]:
        # phase N's kernel rows and phase N alone
        t_phase = time.perf_counter()
        nrows, noff = option_kernel_checks(torch, kernels,
                                           np.random.default_rng(14),
                                           torch.device("cuda"))
        print(f"phase N rows: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        kept, left = phase_n_rows(nrows, phase_n(torch, kernels, smi))
        print(f"phase N: {time.perf_counter() - t_phase:.1f} s")
        print_launch_us(torch)
        print("phase N rows left off the line: " + ", ".join(
            row["name"] for row in left + noff))
        print(json.dumps({"kernels": [
            {k: v for k, v in row.items() if k != "_shape"} for row in kept]}))
        return 0

    if "--phase-o" in sys.argv[1:]:
        # phase O's kernel rows and phase O alone
        t_phase = time.perf_counter()
        orows, ooff = reconstruct_kernel_checks(
            torch, kernels, np.random.default_rng(15), torch.device("cuda"))
        print(f"phase O rows: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        kept, left = phase_o_rows(orows, phase_o(torch, kernels, smi))
        print(f"phase O: {time.perf_counter() - t_phase:.1f} s")
        print_launch_us(torch)
        print("phase O rows left off the line: " + ", ".join(
            row["name"] for row in left + ooff))
        print(json.dumps({"kernels": [
            {k: v for k, v in row.items() if k != "_shape"} for row in kept]}))
        return 0

    if "--phase-p" in sys.argv[1:]:
        # phase P alone: phase C's default solve and phase D's batch solve
        # run (once each, untimed) to record their states, then phase P
        from proxsdp_tpu_torch import solve_batch

        t_phase = time.perf_counter()
        problem, _ = maxcut_problem(random_graph_weights(0, SIDE))
        bprobs = [maxcut_problem(random_graph_weights(s, BATCH_SIDE))[0]
                  for s in range(BATCH_SIZE)]
        rec_c, rec_d = ScalarStepRecorder(), ScalarStepRecorder()
        kernels.reset_launch_counts()
        with rec_c:
            solve(problem, Options())
        torch.cuda.synchronize()
        entries_c = dict(kernels.launch_counts)
        kernels.reset_launch_counts()
        with rec_d:
            solve_batch(bprobs, Options(tol_gap=1e-4, tol_feasibility=1e-4))
        torch.cuda.synchronize()
        entries_d = dict(kernels.launch_counts)
        print(f"phase P: the recording solves {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        prows = phase_p(torch, kernels, smi, rec_c, rec_d)
        print(f"phase P: {time.perf_counter() - t_phase:.1f} s")
        # the f64 single rows' launches from C's polish here (phase A's in
        # the whole run)
        kept, left = p_rows(prows, entries_c, entries_c, entries_d)
        print("phase P rows left off the line: " + ", ".join(
            row["name"] for row in left))
        print(json.dumps({"kernels": [
            {k: v for k, v in row.items() if k != "_shape"} for row in kept]}))
        return 0

    if "--phase-h" in sys.argv[1:]:
        # phase H alone, then the equilibrated arm's path at several caps
        t_phase = time.perf_counter()
        phase_h(torch, kernels, smi)
        phase_h_arms(torch, kernels, smi)
        print(f"phase H and its arms: {time.perf_counter() - t_phase:.1f} s")
        return 0

    problem, Xidx = maxcut_problem(random_graph_weights(0, SIDE))
    setup = to_square_form(preprocess(problem))
    diag_tol = 1e-4 * (1.0 + setup.norm_b) * setup.rhs_scale
    print(f"slice shapes: n={setup.layout.n} p={setup.layout.p} "
          f"m={setup.layout.m} block {SIDE}x{SIDE}")

    # ---- 2. phase A: the f64 program (hybrid_precision=False)
    t_start = t_phase = time.perf_counter()
    res, wall, entries_a, counts, _, _ = solve_timed(
        torch, kernels, solve, problem, Options(hybrid_precision=False))
    diag_err, lam_min, fro = check_solution(res, Xidx, REF_OBJ, diag_tol, "A")
    print(f"phase A (hybrid_precision=False): status {res.status} objval "
          f"{res.objval!r} (reference {REF_OBJ!r}, diff {res.objval - REF_OBJ:.3e}) "
          f"iterations {res.iter} (reference {REF_ITERS}) wall {wall:.3f} s, "
          f"{res.iter / wall:.1f} iterations/s; max|diag(X)-1| {diag_err:.6e} "
          f"(reference {REF_DIAG_ERR:.6e}, bound {diag_tol:.3e}), "
          f"lambda_min(X) {lam_min:.3e}")
    print("phase A launches: " + json.dumps(
        {e: n for e, n in entries_a.items() if n}))
    # K1 for M x; M' y inside K15, one launch an iteration; K18 the dense
    # eigh's reconstruction
    for name in ("ell_spmv", "linesearch_loop", "residuals",
                 "primal_update_sym", "psd_reconstruct", "control",
                 "restart_average", "restart_adopt"):
        check(counts[name] >= res.iter, f"A: {name} launched < iterations")
    check(counts["ls_dual_update"] == counts["sq_dist"] == 0,
          "A: one trial's kernels launched on the path")
    print(f"phase A: {TRIALS.read('linesearch_loop')}")

    print(f"phase A: {time.perf_counter() - t_phase:.1f} s")

    # ---- 3. phase B: every entry point of the default path vs its plain
    # version, then the batch path's at phase D's shapes, then the giant
    # sides' (K11; K7 and K5 at side 2000)
    t_phase = time.perf_counter()
    rows, off_path = kernel_checks(torch, kernels, setup,
                                   np.random.default_rng(0),
                                   torch.device("cuda"))
    bproblems = [maxcut_problem(random_graph_weights(s, BATCH_SIDE))
                 for s in range(BATCH_SIZE)]
    bsetups = [preprocess(p) for p, _ in bproblems]
    brows, boff = batch_kernel_checks(torch, kernels, bsetups,
                                      np.random.default_rng(1),
                                      torch.device("cuda"))
    t_b = time.perf_counter()
    grows = giant_kernel_checks(torch, kernels, np.random.default_rng(2),
                                torch.device("cuda"))
    edge_kernel_checks(torch, kernels, np.random.default_rng(15),
                       torch.device("cuda"))
    t_g = time.perf_counter()
    # phase G's shapes: K12 in its three modes, K9 past side 64, K10 and
    # the batched K1-K4 at G1's and G2's instances
    gsetups = {label: [preprocess(maxcut_problem(random_graph_weights(s, side))[0])
                       for s in range(B)]
               for label, B, side in (("G1", G1_SIZE, G1_SIDE),
                                      ("G2", G2_SIZE, G2_SIDE))}
    g1rows, g1off = batch_kernel_checks(
        torch, kernels, gsetups["G1"], np.random.default_rng(3),
        torch.device("cuda"), eigh_sides=(G1_SIDE,), phase="G1")
    g2rows, g2off = batch_kernel_checks(
        torch, kernels, gsetups["G2"], np.random.default_rng(4),
        torch.device("cuda"), eigh_sides=(G2_SIDE, 118, 168), phase="G2")
    srows, soff = subspace_kernel_checks(torch, kernels,
                                         np.random.default_rng(5),
                                         torch.device("cuda"))
    t_hi = time.perf_counter()
    crows, coff = conic_kernel_checks(torch, kernels, np.random.default_rng(6),
                                      torch.device("cuda"))
    # K5-K8 at the hybrid shapes of phase H (side 300: the race's buckets
    # 32-64, the polish at 64) and phase I (the side-200 block at 24)
    for phase, side, ks, polish_k, rank, seed in (("H", THETA_N, (32, 48, 64),
                                                   64, 45, 7),
                                                  ("I", 200, (24,), 24, 12, 8)):
        crows[phase] += race_kernel_checks(
            torch, kernels, np.random.default_rng(seed), torch.device("cuda"),
            side, ks, polish_k, rank, phase)
    jrows = j_kernel_checks(torch, kernels, np.random.default_rng(9),
                            torch.device("cuda"), bsetups)
    k1, k1_data, k3, k_xidx = k_setups(torch)
    krows, koff = k_kernel_checks(torch, kernels, np.random.default_rng(10),
                                  torch.device("cuda"), k1, k3)
    t_l = time.perf_counter()
    lrows = large_kernel_checks(torch, kernels, np.random.default_rng(12),
                                torch.device("cuda"))
    print(f"phase B: phase L's rows {time.perf_counter() - t_l:.1f} s")
    t_m = time.perf_counter()
    mrows, moff = sweep_kernel_checks(torch, kernels, np.random.default_rng(13),
                                      torch.device("cuda"))
    print(f"phase B: phase M's rows {time.perf_counter() - t_m:.1f} s")
    t_n = time.perf_counter()
    nrows, noff = option_kernel_checks(torch, kernels, np.random.default_rng(14),
                                       torch.device("cuda"))
    print(f"phase B: phase N's rows {time.perf_counter() - t_n:.1f} s")
    print(f"phase B: {time.perf_counter() - t_phase:.1f} s (above side 1024 "
          f"{t_g - t_b:.1f} s, phase G's shapes {t_hi - t_g:.1f} s, phases H "
          f"and I's {time.perf_counter() - t_hi:.1f} s)")

    # ---- 4. phase C: the default Options() -- hybrid race and polish
    t_phase = time.perf_counter()
    opts = Options(log_verbose=True, timer_verbose=True)
    rec_c = ScalarStepRecorder()  # phase P's states (references only)
    with rec_c:
        res, wall, entries, counts, shapes_c, log = solve_timed(
            torch, kernels, solve, problem, opts, capture=True)
    for line in log.splitlines():
        if line.startswith("  [") or "total" in line or "status:" in line:
            print("  | " + line.strip())
    diag_err, lam_min, fro = check_solution(res, Xidx, HYB_REF_OBJ, diag_tol, "C")
    res_c = res  # phase O's unsharded default solve
    race = re.search(r"f32 race: subspace rank (\d+) \(observed (\d+)\)", log)
    hand = re.search(r"f32 -> f64 at iter (\d+)", log)
    pol = re.search(r"f64 polish: subspace rank (\d+) \(observed (\d+)\)", log)
    fb = re.search(r"f32 polar-reseed=(\d+), dense-eigh=(\d+)", log)
    iters = res.iter
    print(f"phase C (default Options()): status {res.status} objval "
          f"{res.objval!r} (reference {HYB_REF_OBJ!r}, diff "
          f"{res.objval - HYB_REF_OBJ:.3e}, bound "
          f"{1e-4 * (1 + abs(HYB_REF_OBJ)):.3f}) iterations {iters} (reference "
          f"{HYB_REF_ITERS}, {100.0 * (iters - HYB_REF_ITERS) / HYB_REF_ITERS:+.1f}%) "
          f"final rank {res.final_rank} gap {res.gap:.3e}")
    print(f"phase C events: race rank {race and race.group(1)} (observed "
          f"{race and race.group(2)}; reference {HYB_REF_RACE_RANK}), hand-over "
          f"at {hand and hand.group(1)} (reference {HYB_REF_HANDOVER}), polish "
          f"rank {pol and pol.group(1)} (observed {pol and pol.group(2)}; "
          f"reference {HYB_REF_POLISH_RANK}), polar reseeds "
          f"{fb and fb.group(1)} (reference {HYB_REF_RESEEDS}), dense-eigh "
          f"fallbacks {fb and fb.group(2)} (reference {HYB_REF_DENSE})")
    if abs(iters - HYB_REF_ITERS) > 0.25 * HYB_REF_ITERS:
        print(f"phase C FINDING: iterations {iters} differ from the "
              f"reference's {HYB_REF_ITERS} by more than 25 %")
    print(f"phase C wall {wall:.3f} s, {iters / wall:.1f} iterations/s; "
          f"max|diag(X)-1| {diag_err:.6e} (reference {HYB_REF_DIAG_ERR:.6e}, "
          f"bound {diag_tol:.3e}), lambda_min(X) {lam_min:.3e}, "
          f"||X||_F {fro:.3e}")
    print("phase C launches: " + json.dumps(
        {e: n for e, n in entries.items() if n}))
    for name in kernels.SOLVE_KERNELS:
        # K11 runs only above full_eig_max_side (phase F), K13 only on SOC
        # blocks (phase I), K14 only on a COO operator (phases H and I),
        # K17 only under subspace_sign=True (phase N2), K18 only where a
        # dense eigh runs (phases A and O)
        check(counts[name] > 0 or name in ("lanczos_krylov", "soc_projection",
                                           "coo_spmv", "subspace_sign",
                                           "psd_reconstruct"),
              f"C: {name} launched no kernel")
    for name in ("ell_spmv", "linesearch_loop", "residuals",
                 "primal_update_sym"):
        check(entries.get(f"{name}_f32", 0) > 0, f"C: {name}_f32 not launched")
    print(f"phase C: {TRIALS.read('linesearch_loop')}")
    # launches: the f64 K1-K4 rows count phase A's solve (the f64
    # program), every other row phase C's (the default path); K5-K8 rows
    # those of their call shape
    f64_program = {f"{name}_f64" for name in ("ell_spmv", "linesearch_loop",
                                              "residuals",
                                              "primal_update_sym")}
    all_rows = rows + off_path
    rows, c_off = assign_launches(rows, shapes_c, {
        e: (entries_a if e in f64_program else entries)[e] for e in entries})
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} launched no kernel")
    print("kernels line: launches of the f64 ell_spmv, linesearch_loop, "
          "residuals and primal_update_sym rows from phase A, the "
          "others from phase C, the K5-K8 rows' at their call shape; checked "
          "against the plain version but left off the line (a second form "
          "of a row's shape, or not launched at its shape there): "
          + ", ".join(row["name"] for row in c_off) + "; not on the "
          "side-250 solves (the polish's polar reseed from side 384): "
          + ", ".join(row["name"] for row in off_path))
    print_shapes("phase C", shapes_c, all_rows)

    print(f"phase C: {time.perf_counter() - t_phase:.1f} s")

    # ---- 5. phase D: the batched sweep (solve_batch)
    t_phase = time.perf_counter()
    rec_d = ScalarStepRecorder()  # phase P's states (references only)
    entries_d = phase_d(torch, kernels, smi, bproblems, bsetups, brows,
                        recorder=rec_d)
    print(f"phase D: {time.perf_counter() - t_phase:.1f} s")
    rows += brows
    print("kernels line: the batch rows' launches from phase D's warm solve; "
          "K9 checked against its plain version but not on phase D's path: "
          + ", ".join(row["name"] for row in boff))

    # ---- 6. phase E: the default solve at side 2000; phase F: the f64
    # Lanczos program there
    W = random_graph_weights(0, LZ_SIDE)
    t_e = time.perf_counter()
    entries_e, shapes_e = phase_e(torch, kernels, smi, W)
    t_f = time.perf_counter()
    print(f"phase E: {t_f - t_e:.1f} s")
    entries_f, shapes_f = phase_f(torch, kernels, smi, W)
    print(f"phase F: {time.perf_counter() - t_f:.1f} s")
    # launches: each side-2000 row, and each side-250 row of an entry point
    # the side-250 solves do not run, takes the launches of its own entry
    # point and call shape in phases E and F
    ran = shapes_e + shapes_f
    kept, late_off = assign_launches(grows + off_path, ran, {})
    rows += kept
    print("kernels line: the side-2000 rows' launches are those of their "
          "shape in phases E and F; checked against the plain version but "
          "not launched at their shape there: "
          + ", ".join(row["name"] for row in late_off))
    print_shapes("phases E and F", ran, all_rows + grows)
    print("kernels line: one trial's kernels, checked against the plain "
          "version; on the tensor-parallel path only (phase O: K15 runs the "
          "trials elsewhere): " + ", ".join(row["name"] for row in TRIAL_ROWS))
    for name in ("lanczos_krylov_f64", "ns_gemm_f64"):
        check(entries_f[name] > 0, f"F: {name} launched no kernel")

    # ---- 7. phase G: solve_batch's subspace mode, B = 256 at side 40 (G1,
    # the README's record and bench.py's batch sweep) and B = 64 at side
    # 100 (G2, SDPLIB mcp100's side)
    t_phase = time.perf_counter()
    # one G1 solve (no warm-up repeat: the run keeps within its time)
    entries_g1, shapes_g1, _ = phase_g(torch, kernels, smi, "G1", G1_SIZE,
                                       G1_SIDE, False, G1_REF)
    print(f"phase G1: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    entries_g2, shapes_g2, _ = phase_g(torch, kernels, smi, "G2", G2_SIZE,
                                       G2_SIDE, False, G2_REF)
    print(f"phase G2: {time.perf_counter() - t_phase:.1f} s")
    # launches: a K9 or K12 row takes its entry point's launches at its
    # shape in its phase, a K10 or batched K1-K4 row its entry point's
    g1_kept, g1_left = assign_launches(g1rows, shapes_g1, entries_g1)
    g2_kept, g2_left = assign_launches(g2rows, shapes_g2, entries_g2)
    s_kept, s_left = assign_launches(srows, shapes_g1 + shapes_g2, {
        e: entries_g1[e] + entries_g2[e] for e in entries_g1})
    for row in g1_kept + g2_kept + s_kept:
        check(row["launches"] > 0, f"{row['name']} launched no kernel in G")
    check(entries_g1["batched_subspace_f32"] > 0
          and entries_g2["batched_subspace_f32"] > 0,
          "G: batched_subspace_f32 (K12) launched no kernel")
    rows += g1_kept + g2_kept + s_kept
    print("kernels line: phase G's rows take the launches of their entry "
          "point (K9, K12: at their shape) in phase G1 or G2; checked "
          "against the plain version but not launched there: "
          + ", ".join(row["name"] for row in
                      g1_left + g2_left + s_left + g1off + g2off + soff))
    print_shapes("phase G1", shapes_g1, g1rows + srows)
    print_shapes("phase G2", shapes_g2, g2rows + g2off + srows)

    # ---- 8. phase H: the Lovasz-theta SDP through the probe; phase I:
    # every block kind in one program
    t_phase = time.perf_counter()
    entries_h, shapes_h, rs_h = phase_h(torch, kernels, smi)
    print(f"phase H: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    _, entries_i2, shapes_i2 = phase_i(torch, kernels, smi)
    print(f"phase I: {time.perf_counter() - t_phase:.1f} s")
    # ---- 9. phase J: the certificate search (J1 infeasible, J2
    # unbounded, J3 the batch's re-entry)
    t_phase = time.perf_counter()
    entries_j = phase_j(torch, kernels, smi, bproblems)
    print(f"phase J: {time.perf_counter() - t_phase:.1f} s")
    for tag, jr in jrows.items():
        for row in jr:
            row["launches"] = entries_j[tag][row["name"].split(" ")[0]]
            check(row["launches"] > 0, f"{row['name']} launched no kernel in {tag}")
        rows += jr
    # launches: the row-scale K3 rows take phase H's launches of K3 with a
    # row scale, its other rows those of their entry point, phase I's rows
    # those of the default solve (I2), K9's at its shape
    h_kept, h_left = assign_launches(crows["H"], shapes_h, entries_h)
    for row in list(h_kept):
        if row["name"].startswith("residuals_"):
            row["launches"] = rs_h[row["name"].split(" ")[0][-3:]]
            if not row["launches"]:
                h_kept.remove(row)
                h_left.append(row)
    i_kept, i_left = assign_launches(crows["I"], shapes_i2, entries_i2)
    for row in h_kept + i_kept:
        check(row["launches"] > 0, f"{row['name']} launched no kernel in H/I")
    rows += h_kept + i_kept
    print("kernels line: phase H's and I's rows take the launches of their "
          "entry point (K9: at its shape) in phase H or the default solve of "
          "phase I; checked against the plain version but not launched "
          "there: " + ", ".join(row["name"] for row in h_left + i_left + coff))
    print_shapes("phase H", shapes_h, crows["H"])
    print_shapes("phase I2", shapes_i2, crows["I"])
    # ---- 10. phase K: per-instance operators in solve_batch (K1, K3) and
    # the API on the card (K2)
    t_phase = time.perf_counter()
    entries_k = phase_k(torch, kernels, smi, k1, k1_data, k3, k_xidx)
    print(f"phase K: {time.perf_counter() - t_phase:.1f} s")
    for row in krows:
        entry, tag = row["name"].split(" ")[0], row["name"].split("(")[1][:2]
        counts, per_instance = entries_k[tag]
        row["launches"] = (per_instance[entry] if entry in per_instance
                           else counts[entry])
        check(row["launches"] > 0, f"{row['name']} launched no kernel in {tag}")
    rows += krows
    print("kernels line: phase K's rows take the launches of their entry "
          "point in K1 or K3 (K1b' and K15b': those over per-instance "
          "values); checked against the plain version but on the path only "
          "inside K15b' (and the fixed step): "
          + ", ".join(row["name"] for row in koff))

    # ---- 11. phase L: solve_batch past one block's shared memory (K9L at
    # side 250, K12L at side 500) and the batched polar projection
    t_phase = time.perf_counter()
    runs_l = phase_l(torch, kernels, smi)
    print(f"phase L: {time.perf_counter() - t_phase:.1f} s")
    l_kept, l_left = phase_l_rows(lrows, runs_l)
    for row in l_kept:
        check(row["launches"] > 0, f"{row['name']} launched no kernel in L")
    rows += l_kept
    print("kernels line: phase L's rows take the launches of their entry "
          "point (K9L, K12L: at their shape) in L1, L2 or L3; checked against "
          "the plain version but not launched at their shape there: "
          + ", ".join(row["name"] for row in l_left))

    # ---- 12. phase M: solve_batch over any cone layout (phase I's program
    # swept over 16 instances: K9, K9L, K13b, K14b, K15b's COO form; M2 the
    # subspace mode, K12 beside K9)
    t_phase = time.perf_counter()
    runs_m = phase_m(torch, kernels, smi)
    print(f"phase M: {time.perf_counter() - t_phase:.1f} s")
    m_kept, m_left = phase_m_rows(mrows, runs_m)
    for row in m_kept:
        check(row["launches"] > 0, f"{row['name']} launched no kernel in M")
    rows += m_kept
    print("kernels line: phase M's rows take the launches of their entry "
          "point (K9, K9L, K12: at their shape) in M1 or M2; checked against "
          "the plain version but not launched at their shape there: "
          + ", ".join(row["name"] for row in m_left + moff))
    print_shapes("phase M1", runs_m["M1"][1], mrows)
    print_shapes("phase M2", runs_m["M2"][1], mrows)

    # ---- 13. phase N: the single solve's remaining options (the packed
    # layout, the sign-based race on K17, the accept-always step on K12 at
    # B = 1, checkpoint and resume)
    t_phase = time.perf_counter()
    runs_n = phase_n(torch, kernels, smi)
    print(f"phase N: {time.perf_counter() - t_phase:.1f} s")
    n_kept, n_left = phase_n_rows(nrows, runs_n)
    rows += n_kept
    print("kernels line: phase N's rows take the launches of their entry "
          "point (K17, K12: at their shape) in N1, N2 or N3; checked against "
          "the plain version but not launched at their shape there: "
          + ", ".join(row["name"] for row in n_left + noff))
    print_shapes("phase N2", runs_n["N2"][1], all_rows + nrows)

    # ---- 14. phase O: the sharded solves (solve_batch(mesh=...) and
    # solve_sharded over two ranks sharing the card, NCCL at world size 1)
    # and K18
    t_phase = time.perf_counter()
    orows, ooff = reconstruct_kernel_checks(
        torch, kernels, np.random.default_rng(15), torch.device("cuda"))
    print(f"phase O rows: {time.perf_counter() - t_phase:.1f} s")
    runs_o = phase_o(torch, kernels, smi, ref_default=res_c)
    print(f"phase O: {time.perf_counter() - t_phase:.1f} s (rows included)")
    o_kept, o_left = phase_o_rows(orows, runs_o)
    rows += o_kept
    # one trial's kernels run on the tensor-parallel path: their rows take
    # rank 0's launches of their entry point in O2's runs
    e_o2 = collections.Counter(runs_o["O2"][0])
    e_o2.update(runs_o["O2f64"][0])
    trial_kept = []
    for row in TRIAL_ROWS:
        row["launches"] = e_o2[row["name"].split(" ")[0]]
        if row["launches"]:
            trial_kept.append(row)
    rows += trial_kept
    print("kernels line: phase O's K18 rows take the launches of their shape "
          "in the unsharded f64 program, rank 0's O2 runs and the NCCL solve, "
          "K2's and sq_dist's rows rank 0's O2 launches; checked against the "
          "plain version but not launched at their shape there: "
          + ", ".join(row["name"] for row in o_left + ooff
                      + [r for r in TRIAL_ROWS if r not in trial_kept]))

    # ---- 15. phase P: the iteration's control (K19), the restart (K20a,
    # K20b) and the batch's freeze (K21) on phase C's and D's recorded
    # states and on every crafted branch state
    t_phase = time.perf_counter()
    prows = phase_p(torch, kernels, smi, rec_c, rec_d)
    print(f"phase P: {time.perf_counter() - t_phase:.1f} s")
    p_kept, p_left = p_rows(prows, entries_a, entries, entries_d)
    rows += p_kept
    print("kernels line: phase P's rows take the launches of their entry "
          "point in phase A (the f64 single rows), C (the f32 ones) or D "
          "(the batch rows); checked against the plain version but left off "
          "the line (a second row of an entry point): "
          + ", ".join(row["name"] for row in p_left))
    rec_c.kept.clear()
    rec_d.kept.clear()

    print_launch_us(torch)
    check(all(row["ms"] is not None for row in rows),
          "kernels line: a row without its times")
    on_line = {row["name"].split(" ")[0] for row in rows}
    # one trial's kernels (TRIAL_KERNELS) are checked in phase B and run
    # only on the tensor-parallel path (phase O): K15 and K15b run the
    # trials everywhere else
    missing = {k for k in kernels.SOLVE_KERNELS + kernels.BATCH_KERNELS
               if not any(f"{k}_{sfx}" in on_line
                          for sfx in kernels._suffixes(k))}
    check(not missing, f"kernels line: no row of {sorted(missing)}")

    print(f"phases A-P: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        {k: v for k, v in row.items() if k != "_shape"} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
