#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hessgpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); builds the kernels from
hessgpu_tpu_torch/csrc at first use. Exits non-zero, printing no result, if
there is no device, and on any failed phase. Every phase before `compiled`
runs the eager route (inside utils.graphs.disable_graphs), where each kernel
wrapper counts its launches. Phases, one JSON line each:

  device     the card (name and power limit as nvidia-smi gives them)
  build      seconds to build the kernel library
  kernels    each of the six detection kernels against its plain PyTorch
             version on the card, at every shape the main path gives it (640x480, B=16,
             five octaves; keypoint tables 16 x 2048 and 16 x 3072) plus an
             odd shape and one smaller than the chain's halo, Hessian and
             DoG, and a 33-tap chain that runs in groups; the pyramid built
             in place as the main path builds it (the blur into level 0 of
             octave 0's stack, each chain's decimation epilogue into the
             next stack's level 0) against the plain chain and the plain
             decimation, cropped, and the standalone decimation beside it;
             the epilogue at every level of the grouped chain and after an
             identity transition; orientation also on
             an all-invalid table and on large supports (sigma x
             LARGE_SIGMA_FACTOR); timings by CUDA events
             (warm-up, then the median of REPS launches, the L2 cache
             flushed and the card kept busy ~1 ms before each); the
             RANSAC cores' small SVDs (csrc/linalg.cu, linalg_kernels):
             null_vector at (512, 8, 9), (428, 9), (2048, 9), (256, 12, 12)
             and on a degenerate batch, svd3 at (512, 3, 3), (3, 3),
             (256, 3, 3) and on zero, rank-1 and rank-2 matrices, each
             bit-equal to its plain version (ops/linalg.py), the sweeps
             each matrix ran too (min / max / mean per shape), the null
             vectors against the card's float64 SVD, ms and us a round
             beside the plain version's, torch.linalg.svd's (with its own
             sync) and the bound for the sweeps these inputs ran
  main_path  detect_batch on 16 seeded 640x480 textures, through the
             kernels (launch counts read), against the same batch through
             the plain versions on the card, frame 0 against its pinned
             counts and against a CPU run; Hessian then DoG, first in the
             detection-only upright configuration (-sd -ofix), then in the
             default configuration (orientations, descriptors)
  compaction the row-capped compaction of a flooded (16, 3, 480, 640) octave
             on the card against the same on the CPU
  describe   describe_keypoints on the card fed frame 0's own keypoints
  first_octave  DoG at -fo -1 (octave 0 upsampled to 960x1280): every kernel
             against its plain version along that pyramid and on its tables,
             detect_batch on the 16 upsampled frames (launches pinned) against
             the plain versions, frame 0 through detect_and_describe against
             the batch and the CPU; ms per frame; chain and detect at 960x1280
  direct     conv_mode="direct", Hessian and DoG, -sd -ofix, B=16: launches
             pinned (blur 21 / 26, downsample2 4, no chain), bit-equal to the
             plain route, frame 0 equal to the CPU; pyramid ms and device
             busy (torch.profiler) beside the chain mode's
  facade     HessianSift on PGM files of frames 0-3 equal to
             detect_and_describe, get_feature_vector, save_sift and
             load_sift_text, run_with_keypoints, device_stage_report; run ms
             split into load / pipeline / download
  cli        python -m hessgpu_tpu_torch.cli.hess -i on two PGMs (the .sift
             files byte-equal to the facade's) and -speed on one (Hz,
             .speed.csv)
  matcher    frame 0 against its 10 degree rotation, plain and guided: the
             card's matches equal the CPU's; dots equal to int64 numpy at
             frame 0's size and at 16384 x 16384; ms of _match_core and of
             _guided_gate
  server     the port's hess_server (hessgpu_tpu_torch/csrc/hess_server.cpp,
             built with g++) spawned on loopback with -device cuda and driven
             by the port's RemoteSift: run_sift_data on frames 0-3 (u8
             640x480), run_sift on a PGM, run_sift_keys, set_keypoint_list +
             run_sift_current, each reply's bytes against an in-process
             HessianSift on the card (a field that is not bit-equal is named
             and held to the facade's card-vs-CPU rules); match over the wire
             against SiftMatcher; initialize answers 1; two clients at
             once (one server thread each) sending frames 0 and 1 30 times,
             every reply byte-equal to that frame's reply alone; build and
             start seconds, ms per request over the wire beside the
             in-process ms
  match_tiled  bench_match.py's table (seed 0, N1 = N2 = 65536, d2 = d1
             rolled by 7): match_sharded(mesh=None) mutual-best at n2_tile
             16384 equal to n2_tile 8192; 256 sampled rows (non-mutual) equal
             to float64 numpy; at 16384 x 16384 the tiled result equal to the
             untiled _match_core, plain and guided by H; seconds per table
             (warm-up, best of 3 windows of >= 1 s, every rep), Gpairs/s,
             matches, peak memory, the bound (FP32 operations; the bytes of
             the float32 table's passes beside it)
  evaluation evaluate_repeatability on frame 0 under the rotation, card = CPU
  ba         bench_ba.py's problem (64 cameras, 4096 points, 32768
             observations, 30 CG steps per LM step): one lm_step on the card
             and on the CPU (at one torch thread) from the same state (cost0
             within 1e-5 relative,
             cost1 within 1e-3, accepted equal); LM and CG iterations/s over
             10 LM steps after 2 warm-up steps; launches and device busy per
             LM step (utils.timing.device_profile); the final RMSE on the
             card and the CPU within 1e-2 px; two card runs bit-equal
  sfm        the synthetic TUM sequence (write_tum_sequence's scene, 40
             frames at 640x480, rendered in memory): HessianSift(threshold
             0.003).run per frame on the card (launches pinned), then
             reconstruct_sequence on the card and on the CPU from those
             features (the CPU at one torch thread, where it repeats
             itself): all 40 frames registered on both, the same view_ids,
             the card's ATE at most twice the JAX package's (JAX_SFM_ATE);
             the card's reconstruction launching null_vector and svd3
             twice a fundamental RANSAC and once a PnP; the share of PnP
             hypotheses kept (ok, positive scale) on the card and the CPU;
             then the card under SFM_TORCH_STREAMS torch.Generator streams
             (scripts/torch_sfm_streams.py), each 40 of 40 within the ATE
             limit; seconds for detection, reconstruction, its BA and its
             SVDs outside the RANSAC cores
  spatial    one 4032x6048 frame (make_texture's blobs at the 640x480
             frames' density, seed SPATIAL_SEED) through
             sharded_detect_and_describe on in-process meshes of 1, 2 and 4
             row bands: launches pinned (EXPECTED_SPATIAL), the table equal
             to the same path through the plain versions on the card
             (keypoints bit for bit, descriptors within DESC_TOL) and to
             one-device detect_and_describe where no shard's level cap is
             full (reported per level); ms per frame beside the one-device
             run's; device ms by kernel of the 4-band run (torch.profiler)
  ba_mesh    bench_ba's problem through make_sharded_lm_step on in-process
             meshes of 2 and 8 shards: one step's costs within 1e-5 / 1e-3
             relative of lm_step's, LM iterations/s beside mesh=None's in
             the same phase, the final RMSE within 1e-2 px of mesh=None's,
             two card runs bit-equal, launches and device busy per step
  batch_mesh the main path's batch (B=16, default config) over 2 shards in
             process (launches pinned, bit-equal to detect_batch without a
             mesh; ms in turns with mesh=None), and over a 2-rank gloo group
             on this one card (gloo_rank: its collectives take the CUDA
             tensors; the graphs on, as a user's process has them: the
             mesh caches capture nothing, each rank's batch shard replays
             the one-device graph): detect_batch bit-equal to mesh=None,
             the 4032x6048 frame's 2-band table bit-equal to the
             in-process one,
             bundle_adjust_sharded within 1e-4 relative of the in-process
             2-shard run (all_reduce's order; 10 LM steps of 30 CG steps
             carry the last bits); each rank's ms
  sfm_mesh   the sfm phase's 40 frames reconstructed on the card with a
             2-shard in-process mesh (every BA ends with the distributed LM
             polish; the periodic ones opt in to polish_prune_px =
             SFM_MESH_POLISH_PRUNE_PX): all registered, ATE within the sfm
             phase's limit, seconds; the default polish (the JAX
             package's) once more, its ATE reported beside the limit
  dryrun     dryrun_multichip(8) (hessgpu_tpu_torch/entry.py) on the card:
             seconds, launches
  compiled   the JAX package's jit boundaries as captured CUDA graphs
             (utils/graphs.py): detect_batch (B=16 and B=1) under the
             default config, -sd -ofix and DoG, and HessianSift.run, the
             replay bit-equal to the eager route field by field, the graph
             holding the eager path's kernel launches, a second call on
             texture_frame(16..31) giving those frames' tables and leaving
             the first call's unchanged; ms per call in turns (eager,
             graph, graph, eager; best of 3 windows of ~1 s), frames/s,
             device busy ms and launches (the profiler's; every kernel of
             the path must be in the replay's trace), host launches per
             call, capture seconds,
             memory_allocated before and after the capture and each graph's
             pool; two threads at once through one shared graph
             (HessianSift.run at B=1, detect_batch at B=16, each thread its
             own frames, 100 calls each: every result equal to the eager
             one) and two threads capturing two new keys at once; a
             2400x3200 frame (-maxd's default) under the default config and
             DoG: bit-equal to eager, the graph's pool against the eager
             call's peak memory, ms in turns; three replayed lm_steps at
             bench_ba's size against eager
             (bit-equal, else cost1 within 1e-4 relative and two replays
             bit-equal), LM iterations/s in turns; then the boundaries past
             those (compiled_boundaries), one line each, every call of the
             graph route bit-equal to the eager route, with ms in turns
             over shorter windows, host launches a call (the profiler's
             runtime calls), device launches and busy ms, captures, eager
             first calls, capture seconds, pool bytes, graphs replayed a
             call, host syncs a call eager and replayed
             (torch.cuda.set_sync_debug_mode): describe
             (frame 0's keypoints computing theta and given theta; the
             bucket's first n slots equal to an unpadded eager run),
             describe kernels (describe_keypoints' own graph, captured
             with each stage's output kept: blur, chain, its decimation
             epilogue, detect, orientation and descriptor inside the
             replay bit-equal to their eager launches), rectangles,
             describe threads (two threads, 40 calls each, through one
             graph), match (2000 x 1948 of the main path's descriptors in
             the 2048 x 2048 bucket, mutual and not; the SiftMatcher's ms
             in turns), guided (the gate and the gated match), ransac_f
             (the sequence's first pair with its JAX draws), pnp (300
             seeded correspondences in a bucket of 512; each core one graph
             holding its null_vector and svd3 launches, no host sync on
             either route), posegraph (a
             drifted 12-camera loop, 20 steps); then the mesh boundaries
             on in-process meshes (compiled_mesh), the same report each:
             the 4032x6048 frame over 1, 2 and 4 bands (the graph's
             launches pinned, EXPECTED_SPATIAL; its pool beside the eager
             call's peak; the three graphs held at once; every kernel
             inside the 4-band replay bit-equal to its eager launch), the
             B=16 batch over 2 shards (every shard's launches, each kernel
             bit-equal to its eager launch, equal to mesh=None),
             dryrun_multichip(8) (three calls through the graphs equal to
             eager, captures by cache), the sharded LM step over 2 and 8
             shards (three chained steps bit-equal, LM iterations/s in
             turns), match_sharded at 16384^2 mutual and guided and at
             65536^2 (its first call eager, its second captured), and the
             sfm sequence with a 2-shard mesh, eager and through the
             graphs, each a first pass (40 of 40, ATE within the limit,
             bit-equal); the sfm sequence in
             SFM_TURNS, each run a first pass (every cache it uses emptied
             first): eager, then with the pipeline's and the LM step's
             graphs alone ("base") and with every graph ("all") in turns
             (40 of 40, ATE within the sfm limit, every run bit-equal to
             the eager one; seconds, captures, eager first calls,
             replays, repeat share and pools by cache; the median of the
             "all" runs over the "base" runs' median);
             every cache's clear_cache() returning the pools
  blur       the octave-0 blur's ms beside the card's name and power limit
  {"kernels": [...]}   one entry per kernel, the six detection kernels
             and the two small SVDs: launches on the main path (the small
             SVDs': the sfm phase's reconstruction on the card),
             error, times, bound; path_ms and path_bound_ms sum a batch's
             launches (every octave shape); octave_chain adds its time per
             octave with and without the decimation and from a base (the
             standalone contract); downsample2, launched 0 times (fused into
             octave_chain), carries the standalone kernel's times and, as
             path_ms, the epilogue's cost (chain with minus without the
             decimation, summed over the octaves); blur adds its path per detector
             and its times at the smaller octave shapes and with 33 taps;
             detect_octave adds the bounds of every map written densely and
             its first gate's warp shares; orientation and descriptor
             their time on an all-invalid table, orientation on large
             supports; octave_chain and detect_octave their ms at
             960x1280 (-fo -1); every kernel its launches on each path
             (launches_by_path, the mesh phases' paths too), its device
             ms in the 4-band spatial run (spatial_n4_device_ms) and its
             launches that the default B=16 graph holds and replays
             (launches_per_default_replay, its capture's count)
  <name>, <power limit>
  {"ok": true, "device": {...}}
"""

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# Keypoints of the seed-0 640x480 texture under SiftConfig(
# compute_descriptors=False, fixed_orientation=True): total and per
# (octave, key level). tests/test_torch_pipeline.py asserts the same
# constants against the JAX package on the CPU.
FRAME0_KEYPOINTS = 139
FRAME0_LEVEL_COUNTS = [22, 18, 19, 19, 22, 22, 13, 3, 1, 0, 0, 0, 0, 0, 0]
# The same frame under the default SiftConfig() (up to 2 orientations per
# keypoint, descriptors): features after the expansion, total and per level.
# tests/test_torch_pipeline_default.py asserts them against the JAX package.
FRAME0_FEATURES = 210
FRAME0_FEATURE_LEVELS = [35, 31, 26, 31, 30, 32, 20, 3, 2, 0, 0, 0, 0, 0, 0]

# Kernel against plain version, per-keypoint stages: sums of 10^2..10^4 terms
# in another order, so smoothed votes and raw descriptor entries agree to
# VOTE_TOL of the keypoint's largest entry (1e-6 * sqrt(N)); descriptors
# after normalization to DESC_TOL absolute.
VOTE_TOL = 2e-5
DESC_TOL = 2e-6
# Float operations per contributing pixel, counted in csrc/patch.cu:
# orientation - offsets 4, distance 3, cut 1, bin 2, weight 14 (expf ~12),
# add 1; descriptor - offsets 4, rotation 6, cell coordinates and support 6,
# Gaussian 16, bin and fraction 5, then 2 x 2 cell weights 12, 2 bin shares
# 3, 8 entries x (multiply, multiply-add) 23.
ORI_FLOPS_PER_PIXEL = 25
DESC_FLOPS_PER_PIXEL = 75
# The orientation kernel on the main path's keypoints with their sigma scaled
# by this: boxes of 5 * 10^3 .. 1.3 * 10^4 pixels, the supports that
# describe_keypoints meets with a user's large keypoints.
LARGE_SIGMA_FACTOR = 6.0

BATCH = 16
HEIGHT, WIDTH = 480, 640
REPS = 10
# Cycles of torch.cuda._sleep (~1 ms) that keep the card busy before a timed
# launch, after the L2 flush: a per-keypoint wrapper takes 0.1-0.2 ms of host
# time to enqueue its launch, longer than the flush keeps the card busy, and
# what it takes beyond that entered the kernel's time.
BUSY_CYCLES = 2_000_000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
# downsample2 is the chain's decimation epilogue on the main path
EXPECTED_LAUNCHES = {"blur": 1, "octave_chain": 5, "downsample2": 0,
                     "detect_octave": 5, "orientation": 0, "descriptor": 0,
                     "null_vector": 0, "svd3": 0, "row_counts": 5,
                     "level_scan": 1, "table_scatter": 1}
EXPECTED_LAUNCHES_DEFAULT = dict(EXPECTED_LAUNCHES, orientation=1,
                                 descriptor=1)
# per-kernel details that the kernels line carries where a kernel has them
DETAIL = ("fused_into", "octave_ms_without_decimation",
          "octave_ms_from_base", "epilogue_ms_by_octave",
          "epilogue_bound_ms_by_octave", "standalone_path_ms",
          "standalone_path_bound_ms", "octave_bound_ms",
          "segment_rows", "path_ms_by_detector", "restart_blurs_by_detector",
          "octave_shape_ms", "ms_33_taps", "empty_table_ms",
          "large_support_ms", "large_support_pixels",
          "octave_ms", "valid_cells", "bound_ms_dense_contract",
          "path_bound_ms_dense_contract", "octave0_warp_share_nms",
          "octave0_warp_share_keypoint", "ms_960x1280", "launches_by_path",
          "spatial_n4_device_ms", "launches_per_default_replay",
          "ms_by_shape", "wall_ms_by_shape", "plain_ms_by_shape",
          "library_ms_by_shape", "bound_ms_by_shape",
          "min_cos_vs_float64_svd", "sweeps_by_shape",
          "us_per_round_by_shape")
# ba phase: bench_ba.py's problem (64 cameras, 4096 points, every camera
# sees every 8th point: 32768 observations), built here in NumPy
BA_CAMS, BA_PTS, BA_SEE_EVERY = 64, 4096, 8
BA_CG_ITERS, BA_WARMUP, BA_ITERS = 30, 2, 10
# sfm phase: write_tum_sequence's scene (seed 7, its K), 40 frames at
# 640x480, SiftConfig(threshold=0.003), reconstruct_sequence's defaults
SFM_FRAMES, SFM_SEED, SFM_THRESHOLD = 40, 7, 0.003
# The JAX package's ATE on that sequence (write_tum_sequence(n_frames=40,
# h=480, w=640) -> evaluate_sequence_ate, SiftConfig(threshold=0.003),
# mesh=None) on a CPU host: scripts/jax_sfm_ate_reference.py, 40 of 40
# frames registered, 1944 points. The card's ATE must be at most twice it.
JAX_SFM_ATE = 0.000959249298848135
# match_tiled phase: bench_match.py's table (65536 x 65536, 16384 tiles)
MT_N, MT_TILE = 65536, 16384
# the multi-device phases. spatial: one 4032x6048 frame (an ETH3D DSLR
# frame's size) of make_texture's blobs at the 640x480 frames' density,
# row-sharded over in-process meshes of 1, 2 and 4 bands; batch_mesh: the
# main path's batch over 2 shards, in process and over 2 gloo ranks on the
# one card; ba_mesh: bench_ba's problem over 2 and 8 shards; sfm_mesh: the
# sfm phase's sequence with a 2-shard mesh; dryrun: dryrun_multichip(8)
SPATIAL_H, SPATIAL_W, SPATIAL_SEED, SPATIAL_BLOBS = 4032, 6048, 3, 80000
SPATIAL_MESHES = (1, 2, 4)
SPATIAL_REPS = 5
BATCH_MESH, BATCH_MESH_REPS = 2, 10
BA_MESHES = (2, 8)
SFM_MESH = 2
# the sfm_mesh runs opt in to reconstruct_sequence(polish_prune_px=): the
# periodic BAs' distributed polish over the observations within 4 px (the
# final BA's prune threshold). The default, the JAX package's polish over
# every observation, is run once beside them and reported, not held to the
# limit (a reference-side caveat: ROADMAP Queue 3, PERF.md section 6).
SFM_MESH_POLISH_PRUNE_PX = 4.0
DRYRUN_SHARDS = 8
# compiled phase: host ms per call as the best of COMPILED_WINDOWS windows of
# about COMPILED_WINDOW_S seconds each (bench.py's reasoning against host
# noise), eager and graph routes in turns
COMPILED_WINDOW_S, COMPILED_WINDOWS = 1.0, 3
# calls each of two threads makes at once through one shared graph (in
# process), and requests each of two server clients sends at once
THREAD_ROUNDS = 100
SERVER_ROUNDS = 30
# the boundaries past the pipeline: ms per call in turns over shorter
# windows; the matcher at MATCH_N features of the main path's frames (off
# the bucket, 2048 x 2048, so that its padding is part of the check); PnP over PNP_N seeded correspondences (a fifth moved 20-60 px)
# in a bucket of 512; the pose graph over a drifted loop of PG_VIEWS
BOUNDARY_WINDOW_S = 0.2
# the sfm sequence in the compiled phase: eager, with the pipeline's and the
# LM step's graphs alone ("base"), with every graph ("all"), in turns. Every
# run is a first pass: each starts with every cache the sequence uses
# emptied, as a process that reconstructs one sequence starts, so a run
# pays its own captures (one run's seconds move by a second between runs on
# a shared host).
SFM_TURNS = ("eager", "base", "all", "all", "base")
MATCH_N = (2000, 1948)
PNP_N, PNP_SEED = 300, 5
PG_VIEWS = 12
# the largest frame -maxd's default (3200) lets through, 4:3: one graph's
# pool at that size against the eager call's peak
BIG_HEIGHT, BIG_WIDTH = 2400, 3200
# one 4032x6048 frame through the spatial path, 8 octaves: the initial blur
# and 4 level blurs an octave, 7 decimations, a detect an octave, one
# orientation and one descriptor launch over every level and band
EXPECTED_SPATIAL = {"blur": 33, "octave_chain": 0, "downsample2": 7,
                    "detect_octave": 8, "orientation": 1, "descriptor": 1,
                    "null_vector": 0, "svd3": 0, "row_counts": 0,
                    "level_scan": 0, "table_scatter": 0}
# the same as a graph's launches (read at its capture: the kernels launched
# at least once)
EXPECTED_SPATIAL_GRAPH = {k: n for k, n in EXPECTED_SPATIAL.items() if n}
# the compiled phase's match_sharded: MESH_MATCH_N^2 of match_tiled's
# descriptors, mutual and guided, and its whole MT_N^2 table
MESH_MATCH_N = 16384
# the kernels' symbols in a profiler's trace
KERNEL_SYMBOL = {"blur": "blur_kernel", "octave_chain": "chain_kernel",
                 "downsample2": "downsample2_kernel",
                 "detect_octave": "detect_kernel",
                 "orientation": "orientation_kernel",
                 "descriptor": "descriptor_kernel",
                 "null_vector": "null_vector_", "svd3": "svd3_kernel",
                 "row_counts": "row_count_kernel",
                 "level_scan": "level_scan_kernel",
                 "table_scatter": "table_scatter_kernel"}
KERNEL_INFO = {
    "blur": ("hessgpu_tpu_torch/csrc/conv.cu",
             "hessgpu_tpu/ops/pallas/conv.py:381"),
    "octave_chain": ("hessgpu_tpu_torch/csrc/conv.cu",
                     "hessgpu_tpu/ops/pallas/conv.py:310"),
    "downsample2": ("hessgpu_tpu_torch/csrc/conv.cu",
                    "hessgpu_tpu/ops/pallas/conv.py:494"),
    "detect_octave": ("hessgpu_tpu_torch/csrc/detect.cu",
                      "hessgpu_tpu/ops/pallas/detect.py:550"),
    "orientation": ("hessgpu_tpu_torch/csrc/patch.cu",
                    "hessgpu_tpu/ops/pallas/patch.py:893"),
    "descriptor": ("hessgpu_tpu_torch/csrc/patch.cu",
                   "hessgpu_tpu/ops/pallas/patch.py:584"),
    # no pallas_call: the JAX package's jnp.linalg.svd inside its jitted
    # RANSACs, the null vector and the 3 x 3 SVD of each solve
    "null_vector": ("hessgpu_tpu_torch/csrc/linalg.cu",
                    "hessgpu_tpu/sfm/twoview.py:52,127,234 (jnp.linalg.svd "
                    "in jax.jit; not a TPU kernel)"),
    "svd3": ("hessgpu_tpu_torch/csrc/linalg.cu",
             "hessgpu_tpu/sfm/twoview.py:55,129,237 (jnp.linalg.svd in "
             "jax.jit; not a TPU kernel)"),
}
# the kernels of the SfM path (their launches are the sfm phase's); the
# other six are the detection path's
SFM_KERNELS = ("null_vector", "svd3")
# H100 SXM, NVIDIA data sheet: float64 outside the tensor cores
F64_FLOPS_PER_S = 34e12
# the sfm phase's RANSAC streams past the JAX draws: the torch.Generator
# streams of scripts/torch_sfm_streams.py
SFM_TORCH_STREAMS = 3


REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def write_pgm(path, img_u8):
    """An 8-bit grayscale image as a binary PGM (P5)."""
    import numpy as np
    with open(path, "wb") as f:
        f.write(f"P5\n{img_u8.shape[1]} {img_u8.shape[0]}\n255\n".encode())
        f.write(np.ascontiguousarray(img_u8).tobytes())
    return path


def ba_problem():
    """bench_ba.py's problem in NumPy: cameras on a ring looking at a point
    cloud, Gaussian pixel noise (0.5 px), perturbed start (0.05)."""
    import numpy as np
    import torch

    from hessgpu_tpu_torch.sfm.ba import so3_exp

    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (BA_PTS, 3)).astype(np.float32)
    X[:, 2] += 6.0
    R_list, t_list = [], []
    for c in range(BA_CAMS):
        ang = 0.4 * np.sin(2 * np.pi * c / BA_CAMS)
        w = np.array([0.0, ang, 0.0], np.float32)
        R = so3_exp(torch.from_numpy(w)).numpy()
        cpos = np.array([3.0 * np.sin(ang), 0.3 * np.cos(ang), 0.0])
        R_list.append(R)
        t_list.append(-R @ cpos)
    R = np.stack(R_list).astype(np.float32)
    t = np.stack(t_list).astype(np.float32)
    f, cx, cy = 800.0, 320.0, 240.0
    intr = np.tile(np.array([f, cx, cy], np.float32), (BA_CAMS, 1))
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(BA_CAMS):
        pts = np.arange(c % BA_SEE_EVERY, BA_PTS, BA_SEE_EVERY)
        Xc = X[pts] @ R[c].T + t[c]
        uv = Xc[:, :2] / Xc[:, 2:3] * f + np.array([cx, cy])
        cam_idx.append(np.full(len(pts), c))
        pt_idx.append(pts)
        uvs.append(uv + rng.normal(0, 0.5, uv.shape))
    uv = np.concatenate(uvs)
    return dict(R=R, t=t + rng.normal(0, 0.05, t.shape),
                X=X + rng.normal(0, 0.05, X.shape), intr=intr,
                cam_idx=np.concatenate(cam_idx), pt_idx=np.concatenate(pt_idx),
                uv=uv, weight=np.ones(len(uv), np.float32))


def one_torch_thread(fn, *args, **kw):
    """fn(*args, **kw) at one torch CPU thread, the caller's count restored
    after: the CPU yardsticks run there, where the ordered segment sums of
    sfm/ba.py add in observation order (several threads add at once, in no
    fixed order)."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_num_threads(before)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gloo_rank(rank, world, url, frames, image, ba_np, out_dir):
    """One rank of the batch_mesh phase's process group: two processes on
    the one card in a gloo group whose collectives take the CUDA tensors
    themselves (nccl refuses two ranks on one device). Runs detect_batch,
    the row-sharded detect + describe and bundle_adjust_sharded over the
    group, with the graphs on as a user's process has them (a process
    group's mesh takes the eager route: the mesh caches capture nothing;
    its batch shard replays the one-device pipeline graph), and saves its
    results, times and each cache's captures."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hessgpu_tpu_torch import SiftConfig, detect_batch
    from hessgpu_tpu_torch import pyramid as tpyr
    from hessgpu_tpu_torch.convert import ba_from_numpy
    from hessgpu_tpu_torch.parallel import batch as tbatch
    from hessgpu_tpu_torch.parallel import spatial as tsp
    from hessgpu_tpu_torch.parallel.distributed import device_mesh
    from hessgpu_tpu_torch.parallel.spatial import sharded_detect_and_describe
    from hessgpu_tpu_torch.sfm import distributed_ba as tdba
    from hessgpu_tpu_torch.sfm.distributed_ba import bundle_adjust_sharded

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=url, world_size=world,
                            rank=rank)
    try:
        mesh = device_mesh("batch")
        dev = torch.device("cuda", 0)
        imgs = torch.from_numpy(frames).to(dev)
        img = torch.from_numpy(image).to(dev)

        def timed(fn, reps):
            out, ms = fn(), []
            for _ in range(reps):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return out, ms

        table, batch_ms = timed(lambda: detect_batch(imgs, SiftConfig(),
                                                     mesh=mesh),
                                BATCH_MESH_REPS)
        spatial, spatial_ms = timed(lambda: sharded_detect_and_describe(
            img, SiftConfig(), mesh), SPATIAL_REPS)
        st, pr = ba_from_numpy(device=dev, **ba_np)
        out, cost = bundle_adjust_sharded(st, pr, mesh, iterations=BA_ITERS,
                                          cg_iters=BA_CG_ITERS)
        res = {f"batch_{k}": v.cpu().numpy()
               for k, v in table._asdict().items()}
        res.update({f"spatial_{k}": v.cpu().numpy()
                    for k, v in spatial._asdict().items()})
        res.update({f"ba_{k}": v.cpu().numpy()
                    for k, v in out._asdict().items()})
        caches = (tbatch._MESH_BATCH_GRAPHS, tsp._SPATIAL_GRAPHS,
                  tdba._SHARDED_LM_GRAPHS, tpyr._PIPELINE_GRAPHS)
        np.savez(f"{out_dir}/rank{rank}.npz", ba_cost=cost,
                 batch_ms=batch_ms, spatial_ms=spatial_ms,
                 captures=[c.captures for c in caches], **res)
    finally:
        dist.destroy_process_group()


def server_clients_at_once(r, port, images, sequential):
    """Two clients of one server at once (the server gives each its own
    thread), each sending its own image of one size SERVER_ROUNDS times:
    every reply must equal, byte for byte, the server's reply to that image
    when it was alone (`sequential`). `r` is the first client; the second
    connects to `port`. Returns the replies for the caller's own checks."""
    from hessgpu_tpu_torch.parallel.client import RemoteSift

    r2 = RemoteSift(host="127.0.0.1", port=port)
    if not r2.initialize():
        fail("server: a second client's initialize answered 0")
    clients = [r, r2]
    got = [[], []]
    errors = []
    start = threading.Barrier(2)

    def client(i):
        try:
            start.wait()
            for _ in range(SERVER_ROUNDS):
                if not clients[i].run_sift_data(images[i]):
                    errors.append(f"client {i}: run_sift_data answered 0")
                    return
                got[i].append(clients[i].get_feature_vector())
        except Exception as e:                  # noqa: BLE001
            errors.append(f"client {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    r2.close()
    if errors:
        fail(f"server: two clients at once: {errors}")
    wrong = [sum(kp.tobytes() != sequential[i][0].tobytes()
                 or desc.tobytes() != sequential[i][1].tobytes()
                 for kp, desc in got[i]) for i in (0, 1)]
    if wrong != [0, 0] or [len(g) for g in got] != [SERVER_ROUNDS] * 2:
        fail(f"server: two clients at once: {wrong} of {SERVER_ROUNDS} "
             "replies each differ from the reply to the image alone")
    return dict(rounds=SERVER_ROUNDS, replies_differing=wrong,
                seconds=seconds, replies=got)


def mesh_phases(dev, smi_line, same, max_abs, launches_by_path, frames,
                ba_np, seq, sfm_card_ate):
    """The multi-device phases: spatial, ba_mesh, batch_mesh (in process
    and over two gloo ranks), sfm_mesh and dryrun. Returns each kernel's
    device ms in one 4-band spatial run (the profiler's), by kernel."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from hessgpu_tpu_torch import (SiftConfig, detect_and_describe,
                                   detect_batch)
    from hessgpu_tpu_torch.convert import ba_from_numpy
    from hessgpu_tpu_torch.entry import dryrun_multichip
    from hessgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hessgpu_tpu_torch.parallel.distributed import local_mesh
    from hessgpu_tpu_torch.parallel.spatial import sharded_detect_and_describe
    from hessgpu_tpu_torch.sfm import ba as tba
    from hessgpu_tpu_torch.sfm import distributed_ba as tdba
    from hessgpu_tpu_torch.sfm import incremental as tinc
    from hessgpu_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
    from hessgpu_tpu_torch.sfm.synthetic import make_texture
    from hessgpu_tpu_torch.utils.timing import device_profile

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    keypoint_fields = ("x", "y", "sigma", "theta", "response", "level",
                       "ftype", "valid")

    # ---- spatial: one 4032x6048 frame, row-sharded -------------------------
    t0 = time.perf_counter()
    image = make_texture(np.random.RandomState(SPATIAL_SEED), SPATIAL_W,
                         SPATIAL_BLOBS)[:SPATIAL_H]
    texture_s = time.perf_counter() - t0
    img = torch.from_numpy(image).to(dev)
    cfg = SiftConfig()
    one, one_aux = detect_and_describe(image, cfg)
    one_ms = wall_ms(lambda: detect_and_describe(image, cfg), SPATIAL_REPS)
    spatial = {}
    tables = {}
    for n in SPATIAL_MESHES:
        mesh = local_mesh(n)
        reset_launch_counts()
        got, aux = sharded_detect_and_describe(img, cfg, mesh, with_aux=True)
        torch.cuda.synchronize()
        launches = launch_counts()
        if launches != EXPECTED_SPATIAL:
            fail(f"spatial n={n}: launches {launches} != {EXPECTED_SPATIAL}")
        if n > 1:
            launches_by_path[f"spatial_{SPATIAL_H}x{SPATIAL_W}_n{n}"] = \
                launches
        plain = sharded_detect_and_describe(img, cfg, mesh, plain=True)
        for f in keypoint_fields:
            if not same(getattr(got, f), getattr(plain, f)):
                fail(f"spatial n={n}: {f} differs from the plain route")
        desc_err = max_abs(got.desc, plain.desc)
        if desc_err > DESC_TOL:
            fail(f"spatial n={n}: descriptors {desc_err} from the plain route")
        full = (aux["shard_level_counts"] >= aux["level_cap"]).any(0)
        if not bool(full.any()):
            for f in got._fields:
                if not same(getattr(got, f), getattr(one, f)):
                    fail(f"spatial n={n}: {f} differs from one-device "
                         "detect_and_describe with no level cap full")
        tables[n] = got
        spatial[f"n{n}"] = dict(
            ms=wall_ms(lambda: sharded_detect_and_describe(img, cfg, mesh),
                       SPATIAL_REPS),
            plain_ms=wall_ms(lambda: sharded_detect_and_describe(
                img, cfg, mesh, plain=True), 2),
            launches=launches, features=int(got.count()),
            level_cap=aux["level_cap"],
            levels_with_a_full_shard=[int(i) for i in
                                      torch.nonzero(full)[:, 0].tolist()],
            equals_one_device=not bool(full.any()),
            sharded_octaves=aux["sharded_octaves"],
            plain_desc_max_abs_err=desc_err)
    prof = device_profile(lambda: sharded_detect_and_describe(
        img, cfg, local_mesh(4)), runs=3)
    kernel_ms = {k: sum(v[0] for name, v in prof["by_kernel"].items()
                        if sym in name)
                 for k, sym in KERNEL_SYMBOL.items()}
    for n in SPATIAL_MESHES:
        spatial[f"n{n}"]["ms_median"] = statistics.median(
            spatial[f"n{n}"]["ms"])
    emit("spatial", height=SPATIAL_H, width=SPATIAL_W, seed=SPATIAL_SEED,
         blobs=SPATIAL_BLOBS, texture_s=texture_s,
         one_device_ms=one_ms, one_device_ms_median=statistics.median(
             one_ms), one_device_features=int(one.count()),
         one_device_level_counts=one_aux["level_counts"].tolist(),
         meshes=spatial, n4_device_busy_ms=prof["busy_ms"],
         n4_launches_all=prof["launches"], n4_kernel_ms=kernel_ms,
         n4_top_device_work=dict(list(prof["by_kernel"].items())[:10]),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         nvidia_smi=smi_line)
    del one, plain, img

    # ---- ba_mesh: bench_ba's problem over 2 and 8 shards -------------------
    st, pr = ba_from_numpy(device=dev, **ba_np)
    lam0 = torch.tensor(1e-3, device=dev)

    def lm_run(step, iters):
        s, lam = st, lam0
        for _ in range(iters):
            s, lam = step(s, lam)[:2]
        return s

    local = lambda s, lam: tba.lm_step(s, pr, lam, cg_iters=BA_CG_ITERS)
    ref_step = local(st, lam0)
    rates, ba_mesh = {}, {}
    ref = None
    for n in (1,) + BA_MESHES:
        if n == 1:
            step = local
        else:
            prob_n = tdba.pad_problem(pr, n)
            sharded = tdba.make_sharded_lm_step(local_mesh(n),
                                                cg_iters=BA_CG_ITERS)
            step = (lambda f, p: lambda s, lam: f(s, lam, p))(sharded,
                                                             prob_n)
        lm_run(step, BA_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm_run(step, BA_ITERS)
        torch.cuda.synchronize()
        rates[n] = BA_ITERS / (time.perf_counter() - t0)
        if n == 1:
            ref = out
            continue
        again = lm_run(step, BA_ITERS)
        for f in ("R", "t", "X"):
            if not same(getattr(out, f), getattr(again, f)):
                fail(f"ba_mesh n={n}: two card runs differ in {f}")
        one_step = step(st, lam0)
        c0 = [float(one_step[2]), float(ref_step[2])]
        c1 = [float(one_step[3]), float(ref_step[3])]
        if abs(c0[0] - c0[1]) > 1e-5 * abs(c0[1]) \
                or abs(c1[0] - c1[1]) > 1e-3 * abs(c1[1]):
            fail(f"ba_mesh n={n}: step {c0[0]} -> {c1[0]}, mesh=None "
                 f"{c0[1]} -> {c1[1]}")
        rmse = [tba.reprojection_rmse(out, pr), tba.reprojection_rmse(ref, pr)]
        if abs(rmse[0] - rmse[1]) > 1e-2:
            fail(f"ba_mesh n={n}: RMSE {rmse[0]} px, mesh=None {rmse[1]}")
        p = device_profile(lambda: step(st, lam0), runs=3)
        ba_mesh[f"n{n}"] = dict(
            lm_iters_per_s=rates[n], step_cost0_mesh_none=c0,
            step_cost1_mesh_none=c1, final_rmse_px_mesh_none=rmse,
            two_runs_bit_equal=True, launches_per_lm_iter=p["launches"],
            device_busy_ms_per_lm_iter=p["busy_ms"],
            vs_mesh_none_max_abs_diff={
                f: max_abs(getattr(out, f), getattr(ref, f))
                for f in ("R", "t", "X")})
    emit("ba_mesh", cameras=BA_CAMS, points=BA_PTS,
         observations=int(pr.uv.shape[0]), cg_iters=BA_CG_ITERS,
         timed_iters=BA_ITERS, mesh_none_lm_iters_per_s=rates[1],
         meshes=ba_mesh, nvidia_smi=smi_line)

    # ---- batch_mesh: the main path's batch over 2 shards -------------------
    cfg = SiftConfig()
    imgs = torch.from_numpy(frames).to(dev)
    mesh = local_mesh(BATCH_MESH)
    want = detect_batch(imgs, cfg)
    reset_launch_counts()
    got = detect_batch(imgs, cfg, mesh=mesh)
    torch.cuda.synchronize()
    launches = launch_counts()
    want_launches = {k: BATCH_MESH * v
                     for k, v in EXPECTED_LAUNCHES_DEFAULT.items()}
    if launches != want_launches:
        fail(f"batch_mesh: launches {launches} != {want_launches}")
    launches_by_path[f"batch_mesh_n{BATCH_MESH}"] = launches
    for f in got._fields:
        if not same(getattr(got, f), getattr(want, f)):
            fail(f"batch_mesh: {f} differs from detect_batch without a mesh")
    none_ms, mesh_ms = [], []
    for _ in range(2):              # in turns: none, mesh, mesh, none
        none_ms += wall_ms(lambda: detect_batch(imgs, cfg),
                           BATCH_MESH_REPS // 2)
        mesh_ms += wall_ms(lambda: detect_batch(imgs, cfg, mesh=mesh),
                           BATCH_MESH_REPS)
        none_ms += wall_ms(lambda: detect_batch(imgs, cfg),
                           BATCH_MESH_REPS // 2)
    # the process-group route: two gloo ranks on this card
    ba_ref, ba_ref_cost = tdba.bundle_adjust_sharded(
        st, pr, local_mesh(2), iterations=BA_ITERS, cg_iters=BA_CG_ITERS)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    try:
        t0 = time.perf_counter()
        mp.start_processes(gloo_rank, args=(
            2, f"file://{workdir}/rendezvous", frames, image, ba_np, workdir),
            nprocs=2, join=True, start_method="spawn")
        gloo_s = time.perf_counter() - t0
        ranks = [dict(np.load(f"{workdir}/rank{r}.npz")) for r in range(2)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gloo = {"seconds_with_spawn": gloo_s}
    for r, res in enumerate(ranks):
        for f in got._fields:
            if not np.array_equal(res[f"batch_{f}"],
                                  getattr(want, f).cpu().numpy()):
                fail(f"batch_mesh: gloo rank {r}: {f} differs from "
                     "detect_batch without a mesh")
            if not np.array_equal(res[f"spatial_{f}"],
                                  getattr(tables[2], f).cpu().numpy()):
                fail(f"batch_mesh: gloo rank {r}: spatial {f} differs from "
                     "the in-process 2-band run")
        ba_rel = max(float(np.abs(res[f"ba_{f}"] - getattr(ba_ref, f)
                                  .cpu().numpy()).max()
                           / max(1e-30, float(getattr(ba_ref, f).abs()
                                              .max())))
                     for f in ("R", "t", "X"))
        if ba_rel > 1e-4:
            fail(f"batch_mesh: gloo rank {r}: BA state {ba_rel} relative "
                 "from the in-process 2-shard run")
        mesh_caps, pipeline_caps = res["captures"][:3].tolist(), \
            int(res["captures"][3])
        if any(mesh_caps):
            fail(f"batch_mesh: gloo rank {r}: the mesh caches (batch, "
                 f"spatial, sharded LM) captured {mesh_caps} graphs on a "
                 "process group")
        gloo[f"rank{r}"] = dict(
            batch_ms=res["batch_ms"].tolist(),
            spatial_ms=res["spatial_ms"].tolist(),
            ba_cost=float(res["ba_cost"]), ba_max_rel_diff=ba_rel,
            mesh_cache_captures=mesh_caps,
            pipeline_graph_captures=pipeline_caps)
    emit("batch_mesh", batch=int(frames.shape[0]), height=HEIGHT,
         width=WIDTH, shards=BATCH_MESH, launches=launches,
         bit_equal_to_mesh_none=True, mesh_none_ms=none_ms,
         mesh_none_ms_median=statistics.median(none_ms), mesh_ms=mesh_ms,
         mesh_ms_median=statistics.median(mesh_ms),
         gloo_two_ranks_one_card=gloo, gloo_collectives_on_cuda_tensors=True,
         gloo_batch_bit_equal=True, gloo_spatial_bit_equal=True,
         in_process_ba_cost=ba_ref_cost, nvidia_smi=smi_line)

    # ---- sfm_mesh: the sequence with a 2-shard mesh ------------------------
    seq_feats, seq_K, seq_centers = seq
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = tinc.reconstruct_sequence(
        seq_feats, seq_K, mesh=local_mesh(SFM_MESH),
        polish_prune_px=SFM_MESH_POLISH_PRUNE_PX, device="cuda")
    torch.cuda.synchronize()
    sfm_s = time.perf_counter() - t0
    if rec is None or rec.view_ids != list(range(len(seq_feats))):
        fail(f"sfm_mesh: registered {None if rec is None else rec.view_ids}")
    ate = ate_rmse(camera_centers(rec.R, rec.t), seq_centers[rec.view_ids])
    if not ate <= 2 * JAX_SFM_ATE:
        fail(f"sfm_mesh: ATE {ate}, limit {2 * JAX_SFM_ATE}")
    ref = tinc.reconstruct_sequence(seq_feats, seq_K,
                                    mesh=local_mesh(SFM_MESH), device="cuda")
    ref_ate = None if ref is None else ate_rmse(
        camera_centers(ref.R, ref.t), seq_centers[ref.view_ids])
    emit("sfm_mesh", frames=len(seq_feats), shards=SFM_MESH, seconds=sfm_s,
         polish_prune_px=SFM_MESH_POLISH_PRUNE_PX,
         registered=rec.num_cameras, points=rec.num_points, ate=ate,
         ate_limit=2 * JAX_SFM_ATE, mesh_none_ate=sfm_card_ate,
         default_polish=dict(
             registered=None if ref is None else ref.num_cameras,
             ate=ref_ate, within_limit=ref_ate is not None
             and ref_ate <= 2 * JAX_SFM_ATE, held_to_limit=False),
         nvidia_smi=smi_line)

    # ---- dryrun: dryrun_multichip on an 8-shard in-process mesh ------------
    reset_launch_counts()
    t0 = time.perf_counter()
    result = dryrun_multichip(DRYRUN_SHARDS)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    launches = launch_counts()
    if min(launches[k] for k in ("blur", "octave_chain", "detect_octave",
                                 "orientation", "descriptor")) < 1:
        fail(f"dryrun: launches {launches}")
    launches_by_path[f"dryrun_{DRYRUN_SHARDS}"] = launches
    emit("dryrun", shards=DRYRUN_SHARDS, seconds=dry_s, launches=launches,
         **result, nvidia_smi=smi_line)
    return kernel_ms


def boundary_checks(same, eager, in_turns):
    """(equal, boundary): equal(a, b) compares results field by field, bit
    for bit; boundary(what, cache, call) holds a graph entry point's calls
    to its eager route and reports what the key's graph costs."""
    import warnings

    import numpy as np
    import torch

    from hessgpu_tpu_torch.utils.timing import device_profile

    def graphs_replayed(fn):
        """The CUDA graphs one call of fn replays."""
        real = torch.cuda.CUDAGraph.replay
        n = [0]

        def counted(self):
            n[0] += 1
            return real(self)
        torch.cuda.CUDAGraph.replay = counted
        try:
            fn()
        finally:
            torch.cuda.CUDAGraph.replay = real
        return n[0]

    def host_syncs(fn):
        """The calls of one fn() that synchronised with the host
        (torch.cuda.set_sync_debug_mode's warnings), by file:line."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [f"{os.path.relpath(w.filename, REPO_DIR)}:{w.lineno}"
                for w in caught if "synchroniz" in str(w.message)]

    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return same(a, b)
        return np.array_equal(a, b)

    def boundary(what, cache, call, calls=3, **extra):
        """call() eagerly, then `calls` times through `cache` (every result
        bit-equal to the eager one); ms in turns; host launches a call (the
        profiler's runtime calls); the key's graph."""
        want = eager(call)()
        cap0, eager0 = cache.captures, cache.eager_calls
        for i in range(calls):
            if not equal(call(), want):
                fail(f"compiled: {what}: call {i + 1} through the graph "
                     "differs from the eager route")
        st = cache.stats()[-1]        # the most recently used: this key's
        ms = in_turns(eager(call), call, BOUNDARY_WINDOW_S)
        prof_e = device_profile(eager(call), runs=3)
        prof_g = device_profile(call, runs=3)
        syncs_e, syncs_g = host_syncs(eager(call)), host_syncs(call)
        report = dict(
            what=what, bit_equal_to_eager=True, calls_checked=calls,
            ms_per_call_eager_graph_graph_eager=ms,
            host_launches_per_call_eager=prof_e["host_launches"],
            host_launches_per_call_graph=prof_g["host_launches"],
            device_launches_eager=prof_e["launches"],
            device_launches_graph=prof_g["launches"],
            busy_ms_eager=prof_e["busy_ms"], busy_ms_graph=prof_g["busy_ms"],
            eager_first_calls=cache.eager_calls - eager0,
            captures=cache.captures - cap0, capture_at=st.capture_at,
            capture_s=st.capture_s, graph_kept_bytes=st.kept_bytes,
            graph_pool_reserved_bytes=st.pool_reserved_bytes,
            graphs_replayed_per_call=graphs_replayed(call),
            host_syncs_per_call_eager=len(syncs_e),
            host_syncs_per_call_graph=len(syncs_g),
            host_syncs_eager_at=sorted(set(syncs_e))[:8],
            graph_kernel_launches=st.launches, **extra)
        return want, report

    return equal, boundary


def compiled_boundaries(dev, smi_line, same, frames, seq, eager, sync,
                        in_turns):
    """The compiled phase's boundaries past the pipeline and the LM step:
    the keypoint re-entry program (describe_keypoints, describe_rectangles),
    the matcher (_match_core, _guided_gate), the RANSAC cores (fundamental,
    PnP) and the pose-graph step, each replayed against its eager route.
    Returns the kernel launches that the re-entry graphs hold, by path."""
    import numpy as np
    import torch

    from hessgpu_tpu_torch import (SiftConfig, SiftMatcher,
                                   describe_keypoints, describe_rectangles,
                                   detect_and_describe, to_numpy_trimmed)
    from hessgpu_tpu_torch import describe as tdesc
    from hessgpu_tpu_torch import matcher as tm
    from hessgpu_tpu_torch.sfm import incremental as tinc
    from hessgpu_tpu_torch.sfm import posegraph as tpg
    from hessgpu_tpu_torch.sfm import twoview as ttv
    from hessgpu_tpu_torch.sfm.ba import so3_exp
    from hessgpu_tpu_torch.utils.graphs import disable_graphs

    equal, boundary = boundary_checks(same, eager, in_turns)

    cfg = SiftConfig()
    img, img1 = frames[0], frames[1]
    f0 = to_numpy_trimmed(detect_and_describe(img, cfg)[0])
    keys = np.stack([f0["x"], f0["y"], f0["sigma"], f0["theta"]], axis=1)
    first = np.ones(len(keys), bool)          # first orientation a keypoint
    first[1:] = (keys[1:, :3] != keys[:-1, :3]).any(axis=1)
    launches_by_path = {}

    # ---- keypoint re-entry -------------------------------------------------
    describe_keypoints.clear_cache()
    for case, k, ho in (("computing theta", keys[first, :3], False),
                        ("given theta", keys, True)):
        want, rep = boundary(
            "describe", tdesc._DESCRIBE_GRAPHS,
            lambda k=k, ho=ho: describe_keypoints(img, k, has_orientation=ho))
        # the bucket's first n slots equal an unpadded eager run
        arr, plan, pcfg = tdesc.prepare_input(img, cfg, dev)
        kt = k[:, 3] if ho else np.zeros(len(k), np.float32)
        with disable_graphs():
            theta, desc = tdesc._describe_padded(
                arr, plan, pcfg, k[:, 0], k[:, 1], k[:, 2], kt, ho, len(k))
        if not np.array_equal(desc, want["desc"]) or (not ho and not \
                np.array_equal(np.mod(tdesc.TWO_PI - theta, tdesc.TWO_PI),
                               want["theta"])):
            fail(f"compiled: describe, {case}: the padded list differs "
                 "from the unpadded one")
        launches_by_path[f"describe_replay_{'given' if ho else 'computed'}"
                         "_theta"] = rep["graph_kernel_launches"]
        emit("compiled", case=case, keypoints=len(k),
             bucket=tdesc._bucket(len(k)), padded_equals_unpadded=True,
             **rep, nvidia_smi=smi_line)

    # the five kernels inside the entry's own replay, each against its eager
    # launch: describe_keypoints' graph of _describe_all, captured with each
    # launch's output kept (a tensor the capture made and that stays
    # referenced keeps its place in the pool, and every replay rewrites it),
    # against the same entry inside disable_graphs()
    n = int(first.sum())
    cap = tdesc._bucket(n)
    call = lambda: describe_keypoints(img, keys[first, :3],  # noqa: E731
                                      has_orientation=False)
    describe_keypoints.clear_cache()
    want, want_out = record_kernel_outputs(eager(call))
    cap0 = tdesc._DESCRIBE_GRAPHS.captures
    got, got_out = record_kernel_outputs(call)    # captured, replayed once
    if tdesc._DESCRIBE_GRAPHS.captures != cap0 + 1:
        fail("compiled: describe kernels: the entry captured no graph")
    kernel_vs_eager = kernel_outputs_vs_eager(
        "describe kernels", got, want,
        tdesc._DESCRIBE_GRAPHS.stats()[-1].launches)
    if not equal(got_out, want_out):
        fail("compiled: describe kernels: the entry's outputs differ")
    del got, want
    describe_keypoints.clear_cache()
    emit("compiled", what="describe kernels", keypoints=n, bucket=cap,
         graph="describe_keypoints' own (_describe_all)",
         replay_max_abs_vs_eager=kernel_vs_eager, nvidia_smi=smi_line)

    rects = np.stack([keys[first, 0] - 3 * keys[first, 2],
                      keys[first, 1] - 2 * keys[first, 2],
                      6 * keys[first, 2], 4 * keys[first, 2]],
                     axis=1).astype(np.float32)
    _, rep = boundary("rectangles", tdesc._DESCRIBE_GRAPHS,
                      lambda: describe_rectangles(img, rects))
    launches_by_path["rectangles_replay"] = rep["graph_kernel_launches"]
    emit("compiled", rectangles=len(rects), **rep, nvidia_smi=smi_line)

    # two threads (the server's clients) describe their own frames through
    # one re-entry graph
    f1 = to_numpy_trimmed(detect_and_describe(img1, cfg)[0])
    keys1 = np.stack([f1["x"], f1["y"], f1["sigma"], f1["theta"]], axis=1)
    m = min(len(keys), len(keys1))
    inputs = [(img, keys[:m]), (img1, keys1[:m])]
    wants = [eager(describe_keypoints)(*x) for x in inputs]
    describe_keypoints(*inputs[0])
    caps0 = tdesc._DESCRIBE_GRAPHS.captures
    wrong, errors = [0, 0], []
    start = threading.Barrier(2)

    def client(i):
        try:
            start.wait()
            for _ in range(40):
                if not equal(describe_keypoints(*inputs[i]), wants[i]):
                    wrong[i] += 1
        except Exception as e:              # noqa: BLE001
            errors.append(repr(e))

    ts = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    if wrong != [0, 0] or errors or \
            tdesc._DESCRIBE_GRAPHS.captures != caps0:
        fail(f"compiled: describe, two threads: wrong {wrong}, {errors}")
    emit("compiled", what="describe threads", calls=40, wrong=wrong,
         graphs=len(tdesc._DESCRIBE_GRAPHS),
         graphs_reserved_bytes=tdesc._DESCRIBE_GRAPHS.reserved_bytes(),
         describe_graph_bytes=tdesc.DESCRIBE_GRAPH_BYTES,
         nvidia_smi=smi_line)

    # ---- the matcher: 2048 x 2048 features of the main path's frames -------
    tm._match_core.clear_cache()
    feats = [to_numpy_trimmed(detect_and_describe(f, cfg)[0])
             for f in frames[:16]]
    desc = np.concatenate([f["desc"] for f in feats])
    loc = np.concatenate([np.stack([f["x"], f["y"]], 1) for f in feats])
    q = torch.as_tensor(tm.quantize_descriptors(desc), device=dev)
    n1, n2 = MATCH_N
    d1, d2 = q[:n1], q[n1 // 2: n1 // 2 + n2]
    if len(d2) != n2:
        fail(f"compiled: match: {len(q)} features, {n1 // 2 + n2} needed")
    ones1 = torch.ones(n1, dtype=torch.bool, device=dev)
    ones2 = torch.ones(n2, dtype=torch.bool, device=dev)
    for mutual in (True, False):
        want, rep = boundary("match", tm._MATCH_GRAPHS, lambda mu=mutual:
                             tm._match_core(d1, d2, ones1, ones2, 0.7, 0.8,
                                            mu))
        sm = SiftMatcher()
        sm.set_descriptors(0, d1.cpu().numpy())
        sm.set_descriptors(1, d2.cpu().numpy())
        emit("compiled", n1=n1, n2=n2, bucket=[tm._bucket(n1),
                                               tm._bucket(n2)],
             mutual_best=mutual,
             matches=int((want >= 0).sum()), **rep,
             sift_matcher_ms_eager_graph_graph_eager=in_turns(
                 eager(lambda: sm.get_sift_match(mutual_best=mutual)),
                 lambda: sm.get_sift_match(mutual_best=mutual),
                 BOUNDARY_WINDOW_S),
             nvidia_smi=smi_line)
    l1 = torch.as_tensor(loc[:n1], dtype=torch.float32, device=dev)
    l2 = torch.as_tensor(loc[n1 // 2: n1 // 2 + n2], dtype=torch.float32,
                         device=dev)
    H = torch.eye(3, device=dev)
    F = torch.eye(3, device=dev)
    gate, rep = boundary("guided", tm._MATCH_GRAPHS,
                         lambda: tm._guided_gate(l1, l2, H, 32.0, F, 1e20))
    want, rep_m = boundary("guided", tm._MATCH_GRAPHS, lambda: tm._match_core(
        d1, d2, ones1, ones2, 0.7, 0.8, True, gate))
    emit("compiled", n1=n1, n2=n2, admissible=int(gate.sum()),
         matches=int((want >= 0).sum()), gate=rep, guided_match=rep_m,
         what="guided", nvidia_smi=smi_line)

    # ---- the RANSAC cores: the SfM's first pair, and a PnP of its scale ----
    def one_program(rep, what, launches):
        """A RANSAC core is one graph with its small-SVD kernels inside,
        and its replay reads nothing back to the host; the eager route's
        host syncs are reported with their places."""
        if rep["graphs_replayed_per_call"] != 1 \
                or rep["graph_kernel_launches"] != launches \
                or rep["host_syncs_per_call_graph"]:
            fail(f"compiled: {what}: {rep['graphs_replayed_per_call']} "
                 f"graphs a call holding {rep['graph_kernel_launches']} "
                 f"(expected one holding {launches}), "
                 f"{rep['host_syncs_per_call_graph']} host syncs a replay")

    seq_feats, seq_K = seq[0], seq[1]
    mm = tinc._match_pair(seq_feats[0], seq_feats[1], dev)
    q1 = np.stack([seq_feats[0]["x"][mm[:, 0]], seq_feats[0]["y"][mm[:, 0]]],
                  1).astype(np.float32)
    q2 = np.stack([seq_feats[1]["x"][mm[:, 1]], seq_feats[1]["y"][mm[:, 1]]],
                  1).astype(np.float32)
    nm = len(q1)
    idx = tinc.sample_indices(0, nm, (512, 8),
                              np.full(nm, 1.0 / nm, np.float32), dev)
    p1 = torch.as_tensor(q1, device=dev)
    p2 = torch.as_tensor(q2, device=dev)
    valid = torch.ones(nm, dtype=torch.bool, device=dev)
    ttv.ransac_fundamental_from_samples.clear_cache()
    want, rep = boundary("ransac_f", ttv._RANSAC_F_GRAPHS, lambda:
                         ttv.ransac_fundamental_from_samples(idx, p1, p2,
                                                             valid))
    one_program(rep, "ransac_f", {"null_vector": 2, "svd3": 2})
    emit("compiled", matches=nm, hypotheses=512,
         inliers=int(want.num_inliers), **rep, nvidia_smi=smi_line)

    rng = np.random.RandomState(PNP_SEED)
    X = rng.uniform(-1, 1, (PNP_N, 3)) * [3, 2, 1] + [0, 0, 6]
    uv = X[:, :2] / X[:, 2:] * seq_K[0, 0] + seq_K[:2, 2]
    uv[: PNP_N // 5] += rng.uniform(20, 60, (PNP_N // 5, 2))
    uv += rng.normal(0, 0.5, uv.shape)
    pcap = max(64, 1 << int(np.ceil(np.log2(PNP_N))))
    Xp = np.zeros((pcap, 3), np.float32)
    uvp = np.zeros((pcap, 2), np.float32)
    Xp[:PNP_N], uvp[:PNP_N] = X, uv
    pvalid = np.arange(pcap) < PNP_N
    probs = pvalid / pvalid.sum()
    pidx = tinc.sample_indices(1, pcap, (256, 6), probs.astype(np.float32),
                               dev)
    pargs = (pidx, torch.as_tensor(Xp, device=dev),
             torch.as_tensor(uvp, device=dev),
             torch.as_tensor(pvalid, device=dev),
             torch.as_tensor(seq_K, dtype=torch.float32, device=dev))
    ttv.ransac_pnp_from_samples.clear_cache()
    want, rep = boundary("pnp", ttv._PNP_GRAPHS,
                         lambda: ttv.ransac_pnp_from_samples(*pargs))
    one_program(rep, "pnp", {"null_vector": 1, "svd3": 1})
    _, _, ok, scale = ttv.pnp_hypotheses(pargs[0], *pargs[1:3], pargs[4])
    emit("compiled", correspondences=PNP_N, bucket=pcap, hypotheses=256,
         inliers=int(want.num_inliers),
         hypotheses_kept=int((ok & (scale > 0)).sum()), **rep,
         nvidia_smi=smi_line)

    # ---- the pose graph: a drifted 12-camera loop, 20 steps ----------------
    C = PG_VIEWS
    rng = np.random.RandomState(42)
    rot = lambda w: so3_exp(torch.tensor(               # noqa: E731
        w, dtype=torch.float32)[None])[0].double().numpy()
    Rs = np.stack([rot([0.0, 0.3 * c, 0.0]) for c in range(C)])
    tt = np.stack([[np.cos(0.3 * c), 0.1 * c % 0.5, np.sin(0.3 * c)]
                   for c in range(C)])
    edges = [(c, c + 1) for c in range(C - 1)] + [(0, C - 1), (0, C // 2)]
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    graph = tpg.PoseGraph(
        edge_i=torch.as_tensor([i for i, _ in edges], device=dev),
        edge_j=torch.as_tensor([j for _, j in edges], device=dev),
        R_ij=f32(np.stack([Rs[j] @ Rs[i].T for i, j in edges])),
        t_ij=f32(np.stack([tt[j] - Rs[j] @ Rs[i].T @ tt[i]
                           for i, j in edges])),
        weight=f32(np.ones(len(edges))))
    Rp, tp = Rs.copy(), tt.copy()
    for c in range(1, C):
        Rp[c] = rot(0.05 * rng.randn(3)) @ Rp[c]
        tp[c] = tp[c] + 0.1 * rng.randn(3)
    tpg.optimize_pose_graph.clear_cache()
    want, rep = boundary("posegraph", tpg._STEP_GRAPHS,
                         lambda: tpg.optimize_pose_graph(f32(Rp), f32(tp),
                                                         graph,
                                                         iterations=20))
    moved = float((want[1] - f32(tp)).abs().max())
    if not moved > 1e-2:
        fail(f"compiled: posegraph: the poses moved {moved}")
    emit("compiled", views=C, edges=len(edges), iterations=20,
         translation_moved=moved, **rep, nvidia_smi=smi_line)
    return launches_by_path


def record_kernel_outputs(call):
    """call() with every kernel wrapper keeping a clone of what its launch
    wrote, by kernel in launch order: detect_octave its maps and gradient
    maps, orientation its thetas and peaks, the others their output (the
    chain its whole stack, the next stack's base included). Under a capture
    the clones are the graph's own tensors, which each replay rewrites.
    Returns (rec, call's result)."""
    import torch
    from torch.utils import _pytree as pytree

    from hessgpu_tpu_torch.ops.cuda import conv as kconv
    from hessgpu_tpu_torch.ops.cuda import detect as kdetect
    from hessgpu_tpu_torch.ops.cuda import patch as kpatch

    wrappers = {"blur": (kconv, "blur"), "downsample2": (kconv, "downsample2"),
                "octave_chain": (kconv, "octave_chain_into"),
                "detect_octave": (kdetect, "detect_octave"),
                "orientation": (kpatch, "orientation"),
                "descriptor": (kpatch, "descriptor")}
    real = {k: getattr(*v) for k, v in wrappers.items()}
    rec = {k: [] for k in wrappers}

    def recording(name):
        def run(*a, **kw):
            out = real[name](*a, **kw)
            kept = out[:2] if name == "orientation" else out
            rec[name].append(pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                kept))
            return out
        return run

    for name, (mod, attr) in wrappers.items():
        setattr(mod, attr, recording(name))
    try:
        out = call()
    finally:
        for name, (mod, attr) in wrappers.items():
            setattr(mod, attr, real[name])
    return rec, out


def kernel_outputs_vs_eager(what, got, want, launches):
    """Each kernel's outputs in a replay (the last `launches[k]` of got[k],
    recorded at the capture) against its eager launches (want[k]), bit for
    bit; the detect kernel's payload maps where its valid map is set (it
    writes them nowhere else). Returns the max abs difference by kernel."""
    import torch

    diffs = {}
    for k, ws in want.items():
        n = launches.get(k, 0)
        if n != len(ws):
            fail(f"compiled: {what}: the graph holds {n} {k} launches, the "
                 f"eager route made {len(ws)}")
        if not n:
            continue
        worst = 0.0
        for g, w in zip(got[k][-n:], ws):
            if k == "detect_octave":
                (gm, gg, gr), (wm, wg, wr) = g, w
                pairs = [(gm.valid, wm.valid), (gg, wg), (gr, wr)]
                if torch.equal(gm.valid, wm.valid):
                    pairs += [(a[wm.valid], b[wm.valid])
                              for a, b in zip(gm[1:], wm[1:])]
            elif isinstance(w, tuple):
                pairs = list(zip(g, w))
            else:
                pairs = [(g, w)]
            for a, b in pairs:
                if a.shape != b.shape or not torch.equal(a, b):
                    fail(f"compiled: {what}: a {k} launch inside the replay "
                         "differs from its eager launch")
                if a.numel() and a.dtype.is_floating_point:
                    worst = max(worst, float((a.double() - b.double())
                                             .abs().max()))
        diffs[k] = worst
    return diffs


def compiled_mesh(dev, smi_line, same, frames, ba_np, seq, eager, sync,
                  in_turns):
    """The compiled phase's mesh boundaries on in-process meshes: the JAX
    package's five jit(shard_map) programs as captured graphs, each against
    its eager route (inside disable_graphs). Returns the kernel launches
    the spatial and batch graphs hold (read at their captures), by path."""
    import numpy as np
    import torch

    from hessgpu_tpu_torch import SiftConfig, detect_batch
    from hessgpu_tpu_torch import matcher as tm
    from hessgpu_tpu_torch.convert import ba_from_numpy
    from hessgpu_tpu_torch.entry import dryrun_multichip
    from hessgpu_tpu_torch.parallel import batch as tbatch
    from hessgpu_tpu_torch.parallel import distributed as tdist
    from hessgpu_tpu_torch.parallel import spatial as tsp
    from hessgpu_tpu_torch.sfm import ba as tba
    from hessgpu_tpu_torch.sfm import distributed_ba as tdba
    from hessgpu_tpu_torch.sfm import incremental as tinc
    from hessgpu_tpu_torch.sfm import posegraph as tpg
    from hessgpu_tpu_torch.sfm import twoview as ttv
    from hessgpu_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
    from hessgpu_tpu_torch.sfm.synthetic import make_texture

    equal, boundary = boundary_checks(same, eager, in_turns)
    caches = {"spatial": tsp._SPATIAL_GRAPHS,
              "batch_mesh": tbatch._MESH_BATCH_GRAPHS,
              "ba_mesh": tdba._SHARDED_LM_GRAPHS,
              "match_sharded": tdist._MATCH_SHARDED_GRAPHS}
    clears = (tsp._sharded_program.clear_cache,
              tbatch._sharded_batch_program.clear_cache,
              tdba.make_sharded_lm_step.clear_cache,
              tdist.match_sharded.clear_cache)
    launches_by_path = {}

    def eager_peak(call):
        """The bytes an eager call allocates at its peak, and reserves."""
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        eager(call)()
        sync()
        return (torch.cuda.max_memory_allocated() - a0,
                torch.cuda.max_memory_reserved() - r0)

    # ---- spatial: the 4032x6048 frame over 1, 2 and 4 in-process bands -----
    image = make_texture(np.random.RandomState(SPATIAL_SEED), SPATIAL_W,
                         SPATIAL_BLOBS)[:SPATIAL_H]
    img = torch.from_numpy(image).to(dev)
    cfg = SiftConfig()
    spatial = tsp._SPATIAL_GRAPHS
    for n in SPATIAL_MESHES:
        mesh = tdist.local_mesh(n)
        call = lambda mesh=mesh: tsp.sharded_detect_and_describe(  # noqa
            img, cfg, mesh, with_aux=True)
        peak = eager_peak(call)
        want, rep = boundary(f"spatial n={n}", spatial, call)
        if rep["graph_kernel_launches"] != EXPECTED_SPATIAL_GRAPH:
            fail(f"compiled: spatial n={n}: the graph holds the launches "
                 f"{rep['graph_kernel_launches']}, the eager path "
                 f"{EXPECTED_SPATIAL_GRAPH}")
        launches_by_path[f"spatial_replay_n{n}"] = rep["graph_kernel_launches"]
        emit("compiled", height=SPATIAL_H, width=SPATIAL_W, shards=n,
             features=int(want[0].count()), eager_peak_allocated_bytes=peak[0],
             eager_peak_reserved_bytes=peak[1], **rep, nvidia_smi=smi_line)
    # the 1-, 2- and 4-band graphs of the frame held at once
    spatial_held = {f"n{g.key[0][3]}": g.pool_reserved_bytes
                    for g in spatial.stats()}
    if len(spatial_held) != len(SPATIAL_MESHES):
        fail(f"compiled: spatial: the cache holds {spatial_held} after "
             f"{len(SPATIAL_MESHES)} keys (bound {tsp.SPATIAL_GRAPH_BYTES})")
    # every kernel inside the 4-band replay against its eager launch: a
    # graph captured with each launch's output kept
    mesh4 = tdist.local_mesh(SPATIAL_MESHES[-1])
    call4 = lambda: tsp.sharded_detect_and_describe(img, cfg, mesh4)  # noqa
    tsp._sharded_program.clear_cache()
    want_k, want_t = record_kernel_outputs(eager(call4))
    got_k, got_t = record_kernel_outputs(call4)   # captured, replayed once
    st = spatial.stats()[-1]
    diffs = kernel_outputs_vs_eager("spatial kernels", got_k, want_k,
                                    st.launches)
    if not equal(got_t, want_t):
        fail("compiled: spatial kernels: the table differs from eager")
    del got_k, want_k
    tsp._sharded_program.clear_cache()
    emit("compiled", what="spatial kernels", shards=SPATIAL_MESHES[-1],
         graph="sharded_detect_and_describe's own (_sharded_program)",
         replay_max_abs_vs_eager=diffs, pools_held_together=spatial_held,
         spatial_graph_bytes=tsp.SPATIAL_GRAPH_BYTES, nvidia_smi=smi_line)
    del img, want, want_t, got_t

    # ---- batch_mesh: the main path's batch over 2 shards, and the dry run --
    imgs = torch.from_numpy(frames).to(dev)
    mesh = tdist.local_mesh(BATCH_MESH)
    call = lambda: detect_batch(imgs, cfg, mesh=mesh)        # noqa: E731
    want, rep = boundary(f"batch_mesh n={BATCH_MESH}",
                         tbatch._MESH_BATCH_GRAPHS, call)
    expected = {k: BATCH_MESH * v for k, v in EXPECTED_LAUNCHES_DEFAULT.items()
                if v}
    if rep["graph_kernel_launches"] != expected:
        fail(f"compiled: batch_mesh: the graph holds the launches "
             f"{rep['graph_kernel_launches']}, the eager path {expected}")
    launches_by_path[f"batch_mesh_replay_n{BATCH_MESH}"] = \
        rep["graph_kernel_launches"]
    if not equal(want, detect_batch(imgs, cfg)):
        fail("compiled: batch_mesh: the replay differs from mesh=None")
    tbatch._sharded_batch_program.clear_cache()
    want_k, _ = record_kernel_outputs(eager(call))
    got_k, _ = record_kernel_outputs(call)
    diffs = kernel_outputs_vs_eager(
        "batch_mesh kernels", got_k, want_k,
        tbatch._MESH_BATCH_GRAPHS.stats()[-1].launches)
    del got_k, want_k
    emit("compiled", batch=int(frames.shape[0]), height=HEIGHT, width=WIDTH,
         shards=BATCH_MESH, equals_mesh_none=True,
         kernels_replay_max_abs_vs_eager=diffs,
         mesh_batch_graph_bytes=tbatch.MESH_BATCH_GRAPH_BYTES, **rep,
         nvidia_smi=smi_line)
    for clear in clears:
        clear()
    captures0 = {k: c.captures for k, c in caches.items()}

    def dryrun():                   # its report line kept off stdout
        with contextlib.redirect_stdout(io.StringIO()):
            return dryrun_multichip(DRYRUN_SHARDS)

    want = eager(dryrun)()
    runs = [dryrun() for _ in range(3)]
    if not all(equal(r, want) for r in runs):
        fail(f"compiled: dryrun: {runs} through the graphs, eager {want}")
    ms = in_turns(eager(dryrun), dryrun, BOUNDARY_WINDOW_S)
    emit("compiled", what="dryrun", shards=DRYRUN_SHARDS, result=want,
         calls_bit_equal_to_eager=3, ms_per_call_eager_graph_graph_eager=ms,
         captures={k: c.captures - captures0[k] for k, c in caches.items()},
         nvidia_smi=smi_line)

    # ---- ba_mesh: bench_ba's problem, the sharded step over 2 and 8 --------
    st0, pr = ba_from_numpy(device=dev, **ba_np)
    lam0 = torch.tensor(1e-3, device=dev)
    for n in BA_MESHES:
        prob_n = tdba.pad_problem(pr, n)
        step = tdba.make_sharded_lm_step(tdist.local_mesh(n),
                                         cg_iters=BA_CG_ITERS)

        def lm_run(iters, step=step, prob_n=prob_n):
            s, lam, out = st0, lam0, []
            for _ in range(iters):
                s, lam, c0, c1 = step(s, lam, prob_n)
                out.append((s, lam, c0, c1))
            return out

        _, rep = boundary(f"ba_mesh n={n}", tdba._SHARDED_LM_GRAPHS,
                          lambda step=step, prob_n=prob_n:
                          step(st0, lam0, prob_n))
        e, g = eager(lm_run)(3), lm_run(3)
        if not equal(e, g):
            fail(f"compiled: ba_mesh n={n}: three replayed steps differ from "
                 "three eager steps")
        ba_ms = []
        for run in (eager(lm_run), lm_run, lm_run, eager(lm_run)):
            run(BA_WARMUP)
            sync()
            t0 = time.perf_counter()
            run(BA_ITERS)
            sync()
            ba_ms.append((time.perf_counter() - t0) * 1e3 / BA_ITERS)
        emit("compiled", cameras=BA_CAMS, points=BA_PTS,
             observations=int(prob_n.uv.shape[0]), shards=n,
             cg_iters=BA_CG_ITERS, three_steps_bit_equal=True,
             ms_per_lm_iter_eager_graph_graph_eager=ba_ms,
             lm_iters_per_s_eager=1e3 / min(ba_ms[0], ba_ms[3]),
             lm_iters_per_s_graph=1e3 / min(ba_ms[1], ba_ms[2]), **rep,
             nvidia_smi=smi_line)

    # ---- match_sharded: 16384^2 mutual and guided, 65536^2 -----------------
    rng = np.random.default_rng(0)
    d = rng.standard_normal((MT_N, 128)).astype(np.float32)
    d = np.abs(d) / np.linalg.norm(d, axis=1, keepdims=True)
    q1 = torch.from_numpy((d * 512).astype(np.uint8)).to(dev)
    q2 = torch.roll(q1, 7, 0)
    del d
    m = MESH_MATCH_N
    loc1 = torch.from_numpy(rng.uniform(0, 4000, (m, 2)).astype(
        np.float32)).to(dev)
    loc2 = torch.roll(loc1, 7, 0) + 3.0
    Hm = np.eye(3, dtype=np.float32)
    Hm[:2, 2] = 3.0
    cases = {
        f"{m}^2 mutual": lambda: tdist.match_sharded(q1[:m], q2[:m]),
        f"{m}^2 guided": lambda: tdist.match_sharded(
            q1[:m], q2[:m], loc1=loc1, loc2=loc2, H=Hm, hdistmax=32.0),
        f"{MT_N}^2 mutual": lambda: tdist.match_sharded(q1, q2)}
    for name, call in cases.items():
        peak = eager_peak(call)
        want, rep = boundary(f"match_sharded {name}",
                             tdist._MATCH_SHARDED_GRAPHS, call)
        if rep["captures"] != 1 or rep["eager_first_calls"] != 1:
            fail(f"compiled: match_sharded {name}: {rep['captures']} "
                 f"captures, {rep['eager_first_calls']} eager first calls")
        emit("compiled", matches=int((want >= 0).sum()),
             key=list(map(str, tdist._MATCH_SHARDED_GRAPHS.stats()[-1]
                          .key[0])),
             eager_peak_allocated_bytes=peak[0],
             eager_peak_reserved_bytes=peak[1],
             match_sharded_graph_bytes=tdist.MATCH_SHARDED_GRAPH_BYTES,
             **rep, nvidia_smi=smi_line)
    del q1, q2, loc1, loc2, want

    # ---- sfm_mesh: the sequence with a 2-shard mesh, eager and graphs ------
    seq_feats, seq_K, seq_centers = seq
    recs, turns = {}, {}
    seq_clears = clears + (tba.lm_step.clear_cache, tm._match_core.clear_cache,
                           ttv.ransac_fundamental_from_samples.clear_cache,
                           ttv.ransac_pnp_from_samples.clear_cache,
                           tpg.optimize_pose_graph.clear_cache)
    for mode in ("eager", "graphs"):
        for clear in seq_clears:              # a first pass
            clear()
        before = {k: (c.captures, c.replays) for k, c in caches.items()}
        sync()
        t0 = time.perf_counter()
        run = lambda: tinc.reconstruct_sequence(  # noqa: E731
            seq_feats, seq_K, mesh=tdist.local_mesh(SFM_MESH),
            polish_prune_px=SFM_MESH_POLISH_PRUNE_PX, device="cuda")
        rec = eager(run)() if mode == "eager" else run()
        sync()
        seconds = time.perf_counter() - t0
        if rec is None or rec.view_ids != list(range(len(seq_feats))):
            fail(f"compiled: sfm_mesh ({mode}): registered "
                 f"{None if rec is None else rec.view_ids}")
        ate = ate_rmse(camera_centers(rec.R, rec.t),
                       seq_centers[rec.view_ids])
        if not ate <= 2 * JAX_SFM_ATE:
            fail(f"compiled: sfm_mesh ({mode}): ATE {ate}, limit "
                 f"{2 * JAX_SFM_ATE}")
        recs[mode] = [np.stack(rec.R), np.stack(rec.t), rec.points]
        turns[mode] = dict(
            seconds=seconds, ate=ate, registered=rec.num_cameras,
            captures={k: c.captures - before[k][0]
                      for k, c in caches.items()},
            replays={k: c.replays - before[k][1] for k, c in caches.items()})
    if not all(np.array_equal(a, b) for a, b in zip(recs["eager"],
                                                    recs["graphs"])):
        fail("compiled: sfm_mesh: the run through the graphs differs from "
             "the eager run")
    emit("compiled", what="sfm_mesh", frames=len(seq_feats), shards=SFM_MESH,
         polish_prune_px=SFM_MESH_POLISH_PRUNE_PX, first_pass_each=True,
         bit_equal_to_eager=True, turns=turns,
         ate_limit=2 * JAX_SFM_ATE, nvidia_smi=smi_line)
    held = {k: len(c) for k, c in caches.items()}
    for clear in clears:
        clear()
    emit("compiled", what="mesh caches", graphs_held_before_clear=held,
         nvidia_smi=smi_line)
    return launches_by_path


def compiled_phase(dev, smi_line, same, frames, ba_np, seq):
    """The compiled phase: the JAX package's jit boundaries as captured CUDA
    graphs (run_pipeline_jit, _batched_pipeline, lm_step) against the eager
    route they capture, which runs inside disable_graphs(). Returns the
    launches of each kernel that the default B=16 graph holds (its
    capture's count), by kernel."""
    import numpy as np
    import torch

    from hessgpu_tpu_torch import HessianSift, SiftConfig, detect_batch
    from hessgpu_tpu_torch import pyramid as tpyr
    from hessgpu_tpu_torch.convert import ba_from_numpy
    from hessgpu_tpu_torch.sfm import ba as tba
    from hessgpu_tpu_torch.sfm import incremental as tinc
    from hessgpu_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
    from hessgpu_tpu_torch.sfm.synthetic import texture_frame
    from hessgpu_tpu_torch.utils.graphs import disable_graphs
    from hessgpu_tpu_torch.utils.timing import device_profile

    def eager(fn):
        def run(*a, **kw):
            with disable_graphs():
                return fn(*a, **kw)
        return run

    def sync():
        torch.cuda.synchronize()

    def window_ms(fn, window_s=COMPILED_WINDOW_S):
        """Host ms per call of fn: the best of COMPILED_WINDOWS windows of
        about window_s each, a synchronize before and after each."""
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        n = max(1, int(window_s / max(time.perf_counter() - t0, 1e-6)))
        best = float("inf")
        for _ in range(COMPILED_WINDOWS):
            sync()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            sync()
            best = min(best, (time.perf_counter() - t0) * 1e3 / n)
        return best

    def in_turns(eager_fn, graph_fn, window_s=COMPILED_WINDOW_S):
        """eager, graph, graph, eager: each turn's best window, ms per call."""
        return [window_ms(f, window_s) for f in (eager_fn, graph_fn,
                                                 graph_fn, eager_fn)]

    def tables_equal(a, b, what):
        for f in a._fields:
            if not same(getattr(a, f), getattr(b, f)):
                fail(f"compiled: {what}: {f} of the replay differs from the "
                     "eager route")

    def kernel_launches(prof):
        return {k: int(round(sum(n for name, (_, n) in prof["by_kernel"]
                                 .items() if sym in name)))
                for k, sym in KERNEL_SYMBOL.items()}

    graphs = tpyr._PIPELINE_GRAPHS
    cfgs = {"default": (SiftConfig(), EXPECTED_LAUNCHES_DEFAULT),
            "sd-ofix": (SiftConfig(compute_descriptors=False,
                                   fixed_orientation=True), EXPECTED_LAUNCHES),
            "dog": (SiftConfig(detector="dog"), EXPECTED_LAUNCHES_DEFAULT)}
    imgs = torch.from_numpy(frames).to(dev)
    imgs2 = torch.from_numpy(np.stack([
        texture_frame(s, HEIGHT, WIDTH)
        for s in range(BATCH, 2 * BATCH)])).to(dev)
    replay_launches = {}
    paths = {}
    for name, (cfg, expected) in cfgs.items():
        for b in (BATCH, 1):
            x, x2 = imgs[:b], imgs2[:b]
            want = eager(detect_batch)(x, cfg)
            sync()
            alloc0 = torch.cuda.memory_allocated()
            captures0 = graphs.captures
            t0 = time.perf_counter()
            got = detect_batch(x, cfg)
            sync()
            first_s = time.perf_counter() - t0
            alloc1 = torch.cuda.memory_allocated()
            if graphs.captures != captures0 + 1:
                fail(f"compiled: {name} B={b}: {graphs.captures - captures0} "
                     "captures on the first call")
            st = graphs.stats()[-1]
            got_launches = dict(st.launches)
            want_launches = {k: n for k, n in expected.items() if n}
            if got_launches != want_launches:
                fail(f"compiled: {name} B={b}: the graph holds the kernel "
                     f"launches {got_launches}, the eager path "
                     f"{want_launches}")
            tables_equal(got, want, f"{name} B={b}")
            kept = [t.clone() for t in got]
            got2 = detect_batch(x2, cfg)
            tables_equal(got2, eager(detect_batch)(x2, cfg),
                         f"{name} B={b}, other frames")
            for t, k in zip(got, kept):
                if not same(t, k):
                    fail(f"compiled: {name} B={b}: a later replay changed an "
                         "earlier call's result")
            if same(got.x, got2.x):
                fail(f"compiled: {name} B={b}: other frames gave the same "
                     "table")
            rep = dict(capture_s=st.capture_s, first_call_s=first_s,
                       memory_allocated_before=alloc0,
                       memory_allocated_after=alloc1,
                       graph_kept_bytes=st.kept_bytes,
                       graph_pool_reserved_bytes=st.pool_reserved_bytes,
                       graph_kernel_launches=got_launches,
                       host_launches_per_call_graph=st.inputs + 1
                       + st.outputs, features=got.count().tolist()[:4])
            if b == BATCH:
                # the replay's trace must hold every kernel of the path (the
                # profiler's counts a call are approximate: it can lose an
                # event, so they are reported, not pinned)
                prof_e = device_profile(eager(detect_batch), x, cfg)
                prof_g = device_profile(detect_batch, x, cfg)
                le, lg = kernel_launches(prof_e), kernel_launches(prof_g)
                if any(lg[k] < 1 for k in want_launches):
                    fail(f"compiled: {name}: the replay's trace holds the "
                         f"kernels {lg}, the eager route's {le}")
                if name == "default":
                    replay_launches = {k: got_launches.get(k, 0)
                                       for k in KERNEL_SYMBOL}
                ms = in_turns(lambda: eager(detect_batch)(x, cfg),
                              lambda: detect_batch(x, cfg))
                rep.update(
                    ms_per_batch_eager_graph_graph_eager=ms,
                    frames_per_s_eager=BATCH * 1e3 / min(ms[0], ms[3]),
                    frames_per_s_graph=BATCH * 1e3 / min(ms[1], ms[2]),
                    busy_ms_eager=prof_e["busy_ms"],
                    busy_ms_graph=prof_g["busy_ms"],
                    device_launches_eager=prof_e["launches"],
                    device_launches_graph=prof_g["launches"],
                    host_launches_per_call_eager=prof_e["launches"],
                    profiler_kernel_launches_eager=le,
                    profiler_kernel_launches_graph=lg,
                    top_device_work_graph=dict(
                        list(prof_g["by_kernel"].items())[:8]))
            paths[f"{name}_b{b}"] = rep
        # HessianSift.run at B=1: a PGM's path, load to download
        img = frames[0]
        sift = HessianSift(cfg)
        want_f = eager(sift.run)(img)
        got_f = sift.run(img)
        for k in want_f:
            if not np.array_equal(got_f[k], want_f[k]):
                fail(f"compiled: HessianSift.run {name}: {k} of the replay "
                     "differs from the eager route")
        ms = in_turns(lambda: eager(sift.run)(img), lambda: sift.run(img))
        paths[f"{name}_hessian_sift_run"] = dict(
            features=len(got_f["x"]), ms_per_run_eager_graph_graph_eager=ms)
    emit("compiled", what="main path", batch=BATCH, height=HEIGHT,
         width=WIDTH, bit_equal_to_eager=True, no_aliasing=True,
         graphs=len(graphs), graphs_reserved_bytes=graphs.reserved_bytes(),
         pipeline_graph_bytes=tpyr.PIPELINE_GRAPH_BYTES,
         paths=paths, nvidia_smi=smi_line)

    # ---- threads: two callers at once (the server's clients) ---------------
    def two_threads(runs, inputs, wants, equal, rounds):
        wrong, errors = [0, 0], []
        start = threading.Barrier(2)

        def caller(i):
            try:
                start.wait()
                for _ in range(rounds):
                    if not equal(runs[i](inputs[i]), wants[i]):
                        wrong[i] += 1
            except Exception as e:              # noqa: BLE001
                errors.append(repr(e))

        ts = [threading.Thread(target=caller, args=(i,)) for i in (0, 1)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return dict(rounds=rounds, wrong=wrong, errors=errors,
                    seconds=time.perf_counter() - t0)

    def tables_same(a, b):
        return all(same(getattr(a, f), getattr(b, f)) for f in a._fields)

    cfg = SiftConfig()
    sifts = [HessianSift(cfg), HessianSift(cfg)]
    thread_runs = {
        # one shared graph, each thread its own frames, call after call
        "hessian_sift_run_b1": two_threads(
            [sf.run for sf in sifts], frames[:2],
            [eager(sf.run)(x) for sf, x in zip(sifts, frames[:2])],
            lambda a, b: a.keys() == b.keys() and all(
                np.array_equal(a[k], b[k]) for k in a), THREAD_ROUNDS),
        "detect_batch_b16": two_threads(
            [lambda x: detect_batch(x, cfg)] * 2, [imgs, imgs2],
            [eager(detect_batch)(x, cfg) for x in (imgs, imgs2)],
            tables_same, THREAD_ROUNDS)}
    # two new keys met at once: two captures, one after the other
    tpyr.run_pipeline_jit.clear_cache()
    pair = [SiftConfig(), cfgs["sd-ofix"][0]]
    captures0 = graphs.captures
    thread_runs["two_captures_at_once"] = two_threads(
        [lambda x, c=c: detect_batch(x, c) for c in pair], [imgs[:4]] * 2,
        [eager(detect_batch)(imgs[:4], c) for c in pair], tables_same, 1)
    thread_runs["two_captures_at_once"]["captures"] = \
        graphs.captures - captures0
    for k, r in thread_runs.items():
        if r["wrong"] != [0, 0] or r["errors"]:
            fail(f"compiled: threads, {k}: {r}")
    if graphs.captures != captures0 + 2:
        fail(f"compiled: threads: {graphs.captures - captures0} captures "
             "for two new keys")
    emit("compiled", what="threads", runs=thread_runs, nvidia_smi=smi_line)

    # ---- a 3200-pixel frame: one graph's pool at that size -----------------
    big = texture_frame(0, BIG_HEIGHT, BIG_WIDTH)
    big_paths = {}
    for name in ("default", "dog"):
        sift = HessianSift(cfgs[name][0])
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        want_f = eager(sift.run)(big)
        sync()
        peak_a = torch.cuda.max_memory_allocated() - a0
        peak_r = torch.cuda.max_memory_reserved() - r0
        captures0 = graphs.captures
        got_f = sift.run(big)
        if graphs.captures != captures0 + 1:
            fail(f"compiled: {BIG_HEIGHT}x{BIG_WIDTH} {name}: no capture")
        for k in want_f:
            if not np.array_equal(got_f[k], want_f[k]):
                fail(f"compiled: {BIG_HEIGHT}x{BIG_WIDTH} {name}: {k} of "
                     "the replay differs from the eager route")
        st = graphs.stats()[-1]
        big_paths[name] = dict(
            features=len(got_f["x"]), eager_peak_allocated_bytes=peak_a,
            eager_peak_reserved_bytes=peak_r,
            graph_pool_reserved_bytes=st.pool_reserved_bytes,
            graph_kept_bytes=st.kept_bytes, capture_s=st.capture_s,
            ms_per_run_eager_graph_graph_eager=in_turns(
                lambda: eager(sift.run)(big), lambda: sift.run(big)))
    emit("compiled", what="3200-pixel frame", height=BIG_HEIGHT,
         width=BIG_WIDTH, bit_equal_to_eager=True, paths=big_paths,
         graphs=len(graphs), graphs_reserved_bytes=graphs.reserved_bytes(),
         pipeline_graph_bytes=tpyr.PIPELINE_GRAPH_BYTES, nvidia_smi=smi_line)

    # ---- BA: lm_step replays against eager ---------------------------------
    st0, pr = ba_from_numpy(device=dev, **ba_np)

    def lm_run(n):
        st, lam, out = st0, torch.tensor(1e-3, device=dev), []
        for _ in range(n):
            st, lam, c0, c1, acc = tba.lm_step(st, pr, lam,
                                               cg_iters=BA_CG_ITERS)
            out.append((st, lam, c0, c1, acc))
        return out

    lm = tba._LM_GRAPHS
    cap0 = lm.captures
    e = eager(lm_run)(3)
    g1 = lm_run(3)
    g2 = lm_run(3)
    if lm.captures != cap0 + 1:
        fail(f"compiled: ba: {lm.captures - cap0} captures for one shape")
    flat = lambda r: [t for step in r for t in step[0] + step[1:]]
    bit_equal = all(same(a, b) for a, b in zip(flat(e), flat(g1)))
    if not all(same(a, b) for a, b in zip(flat(g1), flat(g2))):
        fail("compiled: ba: two replayed runs differ")
    cost1_rel = max(abs(float(a[3]) - float(b[3])) / abs(float(b[3]))
                    for a, b in zip(g1, e))
    if not bit_equal and cost1_rel > 1e-4:
        fail(f"compiled: ba: replayed cost1 {cost1_rel} relative from eager")
    lm_st = lm.stats()[-1]

    def lm_ms(run):
        run(BA_WARMUP)
        sync()
        t0 = time.perf_counter()
        run(BA_ITERS)
        sync()
        return (time.perf_counter() - t0) * 1e3 / BA_ITERS

    ba_ms = [lm_ms(f) for f in (eager(lm_run), lm_run, lm_run, eager(lm_run))]
    step = lambda: tba.lm_step(st0, pr, torch.tensor(1e-3, device=dev),
                               cg_iters=BA_CG_ITERS)
    prof_e = device_profile(eager(step), runs=3)
    prof_g = device_profile(step, runs=3)
    emit("compiled", what="ba", cameras=BA_CAMS, points=BA_PTS,
         observations=int(pr.uv.shape[0]), cg_iters=BA_CG_ITERS,
         replay_bit_equal_to_eager=bit_equal, two_replays_bit_equal=True,
         cost1_max_rel_diff=cost1_rel,
         ms_per_lm_iter_eager_graph_graph_eager=ba_ms,
         lm_iters_per_s_eager=1e3 / min(ba_ms[0], ba_ms[3]),
         lm_iters_per_s_graph=1e3 / min(ba_ms[1], ba_ms[2]),
         busy_ms_eager=prof_e["busy_ms"], busy_ms_graph=prof_g["busy_ms"],
         device_launches_eager=prof_e["launches"],
         device_launches_graph=prof_g["launches"],
         host_launches_per_step_graph=lm_st.inputs + 1 + lm_st.outputs,
         capture_s=lm_st.capture_s, graph_kept_bytes=lm_st.kept_bytes,
         graph_pool_reserved_bytes=lm_st.pool_reserved_bytes,
         nvidia_smi=smi_line)

    # ---- the boundaries past the pipeline and the LM step -------------------
    boundary_launches = compiled_boundaries(dev, smi_line, same, frames, seq,
                                            eager, sync, in_turns)
    # ---- the mesh boundaries on in-process meshes ----------------------------
    boundary_launches.update(compiled_mesh(dev, smi_line, same, frames, ba_np,
                                           seq, eager, sync, in_turns))

    # ---- sfm: the sequence with every graph, and with the base ones alone ---
    from hessgpu_tpu_torch import describe as tdesc
    from hessgpu_tpu_torch import matcher as tm
    from hessgpu_tpu_torch.sfm import posegraph as tpg
    from hessgpu_tpu_torch.sfm import twoview as ttv

    seq_feats, seq_K, seq_centers = seq
    # the caches past the base ones (the pipeline's and the LM step's): off
    # in the "base" runs
    new_caches = {"match": tm._MATCH_GRAPHS,
                  "ransac_f": ttv._RANSAC_F_GRAPHS, "pnp": ttv._PNP_GRAPHS,
                  "posegraph": tpg._STEP_GRAPHS}
    caches = dict(new_caches, lm=lm)

    def reconstruct(mode):
        for c in caches.values():         # a first pass
            c.clear()
        before = {k: (c.captures, c.capture_s, c.eager_calls, c.replays)
                  for k, c in caches.items()}
        sync()
        t0 = time.perf_counter()
        if mode == "eager":
            with disable_graphs():
                rec = tinc.reconstruct_sequence(seq_feats, seq_K,
                                                device="cuda")
        elif mode == "base":
            with disable_graphs(caches=new_caches.values()):
                rec = tinc.reconstruct_sequence(seq_feats, seq_K,
                                                device="cuda")
        else:
            rec = tinc.reconstruct_sequence(seq_feats, seq_K, device="cuda")
        sync()
        s = time.perf_counter() - t0
        if rec is None or rec.view_ids != list(range(len(seq_feats))):
            fail(f"compiled: sfm ({mode}): registered "
                 f"{None if rec is None else rec.view_ids}")
        by_cache = {}
        for k, c in caches.items():
            eager_first = c.eager_calls - before[k][2]
            replays = c.replays - before[k][3]
            by_cache[k] = dict(
                captures=c.captures - before[k][0],
                capture_s=c.capture_s - before[k][1],
                eager_first_calls=eager_first, replays=replays,
                repeat_share=replays / max(replays + eager_first, 1),
                graphs_held=len(c), reserved_bytes=c.reserved_bytes(),
                first_two_shapes=[[list(sh) for sh, _ in g.key[1][:2]]
                                  for g in c.stats()])
        return rec, dict(
            mode=mode, seconds=s, points=rec.num_points,
            ate=ate_rmse(camera_centers(rec.R, rec.t),
                         seq_centers[rec.view_ids]), **by_cache)

    runs = [reconstruct(m) for m in SFM_TURNS]
    rec_of = lambda r: [np.stack(r[0].R), np.stack(r[0].t), r[0].points]
    eager_run = runs[SFM_TURNS.index("eager")]
    for r in runs:
        if not all(np.array_equal(a, b)
                   for a, b in zip(rec_of(eager_run), rec_of(r))):
            fail(f"compiled: sfm: the {r[1]['mode']} run differs from the "
                 "eager run")
        if not r[1]["ate"] <= 2 * JAX_SFM_ATE:
            fail(f"compiled: sfm ({r[1]['mode']}): ATE {r[1]['ate']}, "
                 f"limit {2 * JAX_SFM_ATE}")
    seconds = lambda mode: [r[1]["seconds"] for m, r in          # noqa: E731
                            zip(SFM_TURNS, runs) if m == mode]
    all_runs = [r[1] for m, r in zip(SFM_TURNS, runs) if m == "all"]
    emit("compiled", what="sfm", frames=len(seq_feats),
         registered=runs[1][0].num_cameras, turns=list(SFM_TURNS),
         first_pass_each=True, runs=[r[1] for r in runs],
         runs_bit_equal_to_eager=True,
         seconds_eager=seconds("eager"), seconds_base=seconds("base"),
         seconds_all=seconds("all"),
         median_all_over_base=statistics.median(seconds("all"))
         / statistics.median(seconds("base")),
         ransac_f_repeat_share=[r["ransac_f"]["repeat_share"]
                                for r in all_runs],
         ate_limit=2 * JAX_SFM_ATE, lm_graph_bytes=tba.LM_GRAPH_BYTES,
         match_graph_bytes=tm.MATCH_GRAPH_BYTES,
         ransac_graph_bytes=ttv.RANSAC_GRAPH_BYTES,
         pose_graph_bytes=tpg.POSE_GRAPH_BYTES, nvidia_smi=smi_line)

    # ---- clear_cache returns the pools ---------------------------------------
    del got, got2, kept, g1, g2, e, runs, eager_run
    sync()
    all_caches = [graphs, lm, tdesc._DESCRIBE_GRAPHS, *new_caches.values()]
    held = [len(c) for c in all_caches]
    before = torch.cuda.memory_allocated()
    reserved_before = torch.cuda.memory_reserved()
    for clear in (tpyr.run_pipeline_jit.clear_cache, tba.lm_step.clear_cache,
                  tdesc.describe_keypoints.clear_cache,
                  tm._match_core.clear_cache,
                  ttv.ransac_fundamental_from_samples.clear_cache,
                  ttv.ransac_pnp_from_samples.clear_cache,
                  tpg.optimize_pose_graph.clear_cache):
        clear()
    after = torch.cuda.memory_allocated()
    if any(len(c) for c in all_caches) or not after < before:
        fail(f"compiled: clear_cache left {[len(c) for c in all_caches]} "
             f"graphs, memory_allocated {before} -> {after}")
    emit("compiled", what="clear_cache", graphs_before=held,
         memory_allocated_before=before, memory_allocated_after=after,
         memory_reserved_before=reserved_before,
         memory_reserved_after=torch.cuda.memory_reserved(),
         nvidia_smi=smi_line)
    return replay_launches, boundary_launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs one CUDA device", file=sys.stderr)
        sys.exit(2)

    from hessgpu_tpu_torch.utils.graphs import disable_graphs

    dev = torch.device("cuda", 0)

    # ---- device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi_line, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # Every phase up to the compiled one runs the eager route, whose wrappers
    # count their launches (a graph replay calls no wrapper).
    with disable_graphs():
        ran = eager_phases(dev, smi_line)
    replay_launches, boundary_launches = compiled_phase(
        dev, smi_line, ran["same"], ran["frames"], ran["ba_np"], ran["seq"])
    timing = ran["timing"]

    emit("blur", octave0_ms=timing["blur"]["ms"],
         path_ms_by_detector=timing["blur"]["path_ms_by_detector"],
         nvidia_smi=smi_line)

    # ---- result -------------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        t = timing[name]
        t["launches_by_path"] = {
            path: n[name] for path, n in ran["launches_by_path"].items()}
        # the re-entry graphs' launches (a replay's, read at its capture)
        t["launches_by_path"].update(
            (path, n.get(name, 0)) for path, n in boundary_launches.items())
        t["spatial_n4_device_ms"] = ran["spatial_kernel_ms"][name]
        t["launches_per_default_replay"] = replay_launches[name]
        # the detection kernels' launches are the default main path's; the
        # small SVDs' the sfm phase's reconstruction on the card
        main = ran["launches_sfm" if name in SFM_KERNELS else "launches_def"]
        if main[name] < 1 and (name in SFM_KERNELS
                               or EXPECTED_LAUNCHES_DEFAULT[name]):
            fail(f"{name}: launched no time on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main[name],
            "max_abs_err": ran["errs"][name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "shape": t["shape"], "path_ms": t["path_ms"],
            "path_bound_ms": t["path_bound_ms"],
            **{k: t[k] for k in DETAIL if k in t}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def device_timer(dev):
    """time_ms(fn, reps=REPS): the median device time of fn() by CUDA
    events, 3 warm-up calls, then reps timed ones. Before each, a 512 MB
    write evicts the 50 MB L2 and, with a sleep of BUSY_CYCLES, keeps the
    card busy while the host enqueues the launch, so a short kernel's time
    is its own and not the host's time to launch it."""
    import torch

    flush_buf = torch.empty(512 * 1024 * 1024, dtype=torch.int8, device=dev)

    def time_ms(fn, reps=REPS):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            torch.cuda._sleep(BUSY_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    return time_ms


def ransac_systems(seed):
    """The RANSAC cores' systems on a seeded two-view scene (300 points at
    640x480, 0.3 px noise): the 512 eight-point systems (512, 8, 9), the
    weighted refit's (N, 9) at N = 428 (the sfm sequence's first pair has
    428 matches) and 2048, the 256 DLT systems (256, 12, 12); and a batch
    of degenerate ones: a repeated draw, the zero matrix, a sample of 4
    points drawn twice."""
    import numpy as np
    import torch

    from hessgpu_tpu_torch.sfm import twoview as ttv

    rng = np.random.RandomState(seed)
    n = 300
    X = rng.uniform(-1, 1, (n, 3)) * [3, 2, 1] + [0, 0, 6]
    a = 0.1
    R2 = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    Xc = X @ R2.T + [-0.5, 0.0, 0.0]
    f = 600.0
    p1 = X[:, :2] / X[:, 2:] * f + [320, 240] + rng.normal(0, 0.3, (n, 2))
    p2 = Xc[:, :2] / Xc[:, 2:] * f + [320, 240] + rng.normal(0, 0.3, (n, 2))
    p1, p2 = (torch.from_numpy(p.astype(np.float32)) for p in (p1, p2))

    def eight(idx):
        n1, _ = ttv._normalize_points(p1[idx])
        n2, _ = ttv._normalize_points(p2[idx])
        return ttv._design(n1, n2)

    def refit(m):
        idx = torch.from_numpy(rng.randint(0, n, m))
        return eight(idx)

    idx = torch.from_numpy(rng.randint(0, n, (512, 8)))
    pidx = rng.randint(0, n, (256, 6))
    Xh = np.concatenate([X[pidx], np.ones((256, 6, 1))], -1)
    xn = (Xc[pidx, :2] / Xc[pidx, 2:]).astype(np.float32)
    z = np.zeros_like(Xh)
    dlt = np.concatenate([
        np.concatenate([z, -Xh, xn[..., 1, None] * Xh], -1),
        np.concatenate([Xh, z, -xn[..., 0, None] * Xh], -1)], -2)
    degenerate = eight(idx[:4]).clone()
    degenerate[0, 5] = degenerate[0, 2]
    degenerate[1] = 0.0
    degenerate[2, 4:] = degenerate[2, :4]
    return {"512x8x9": eight(idx), "428x9": refit(428),
            "2048x9": refit(2048),
            "256x12x12": torch.from_numpy(dlt.astype(np.float32)),
            "degenerate_4x8x9": degenerate}


def svd3_systems(seed):
    """svd3's inputs: seeded random 3 x 3s at the RANSAC cores' shapes
    (512, 3, 3), (3, 3) and (256, 3, 3), and a degenerate batch: the zero
    matrix, rank 2, rank 1, the identity, diag(1, 1, 0)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    degenerate = torch.zeros(5, 3, 3)
    degenerate[1] = torch.tensor([[1.0, 2, 3], [4, 5, 9], [7, 8, 15]])
    degenerate[2] = torch.tensor([[1.0, 2, 3], [2, 4, 6], [3, 6, 9]])
    degenerate[3] = torch.eye(3)
    degenerate[4] = torch.tensor([[1.0, 0, 0], [0, 1, 0], [0, 0, 0]])
    return {"512x3x3": torch.from_numpy(rng.randn(512, 3, 3)).float(),
            "3x3": torch.from_numpy(rng.randn(3, 3)).float(),
            "256x3x3": torch.from_numpy(rng.randn(256, 3, 3)).float(),
            "degenerate_5x3x3": degenerate}


def linalg_kernels(dev, time_ms, must_equal, checked):
    """null_vector and svd3 (csrc/linalg.cu) against their plain versions
    (ops/linalg.py) on the card at the RANSAC cores' shapes and on a
    degenerate batch, bit for bit (the same sums, rotations, convergence
    test and sign rule), the sweeps each matrix ran too (min / max / mean
    per shape in the kernels line); the null vectors against the card's
    float64 SVD where the gap sigma_{n-1} / sigma_1 >= 1e-3. Times: the
    kernel by CUDA events (time_ms), the plain version, and torch.linalg.svd
    at the same shape (library_ms: the host clock around the call and its
    own sync, median of REPS; the kernel's wall_ms beside it the same way);
    us_per_round, the kernel's time over its slowest matrix's rounds (a
    launch lasts as long as that matrix). Bound: the bytes read and written
    over HBM_BYTES_PER_S against the float64 operations these inputs need
    over F64_FLOPS_PER_S, for what each matrix ran: the Gram matrix of the
    n real columns and its trace, the convergence test of each of the
    n (n - 1) / 2 pairs in every sweep it ran, and the rotations it applied
    (the plain version's count: a pair the test skipped, or the padded
    index's, computes none; svd3 likewise over its 3 column pairs)."""
    import torch

    from hessgpu_tpu_torch.ops import linalg
    from hessgpu_tpu_torch.ops.cuda import linalg as cuda_linalg

    def wall(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def bound(nbytes, flops):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = flops / F64_FLOPS_PER_S * 1e3
        return max(tb, tf), ("bytes" if tb >= tf else "operations")

    def checked_sweeps(kernel, name, A, fn, plain):
        """Runs the kernel with its sweeps output against the plain version
        (bit for bit, the sweeps too); returns its result, its sweeps and
        the rotations the plain version applied."""
        sweeps = torch.zeros(A.shape[:-2], dtype=torch.int32, device=dev)
        got = fn(A, sweeps=sweeps)
        *want, counts = plain(A, return_counts=True)
        got_parts = got if isinstance(got, tuple) else (got,)
        for part, g, w in zip("USV" if len(want) == 3 else "v", got_parts,
                              want):
            must_equal(kernel, f"{name} {part}", g, w)
        must_equal(kernel, f"{name} sweeps", sweeps, counts.sweeps)
        checked[kernel] += 1
        return got, sweeps, counts.rotations

    def sweep_stats(sweeps, rotations):
        s = sweeps.double()
        return {"min": int(s.min()), "max": int(s.max()),
                "mean": float(s.mean()), "rotations": int(rotations.sum())}

    def null_vector_bound(M, n, sweeps, rotations):
        # a test: two products, a product by tol^2, an abs and a compare
        # (5); a rotation: d, e, r, q, w, c, s, t and the two diagonal
        # entries (17), rows p and q of G once, by symmetry, and columns p
        # and q of V (6 n each)
        pairs = n * (n - 1) // 2
        flops = float((M * n * (n + 1) + n + sweeps.double() * pairs * 5
                       + rotations.double() * (12 * n + 17)).sum())
        B = sweeps.numel()
        return bound(4 * B * (M * n + n), flops)

    def svd3_bound(sweeps, rotations):
        # a test: three dot products (15) and the squared compare (4); a
        # rotation: d, e, r, q, w, c, s (13), two columns of W and of V
        # (36); then the three norms and U (27)
        flops = float((sweeps.double() * 3 * 19 + rotations.double() * 49
                       + 27).sum())
        return bound(4 * sweeps.numel() * (9 + 9 + 3 + 9), flops)

    systems = ransac_systems(11)
    by_shape, cos_min = {}, {}
    for name, A in systems.items():
        A = A.to(dev)
        got, sweeps, rotations = checked_sweeps(
            "null_vector", name, A, cuda_linalg.null_vector,
            linalg.null_vector_plain)
        if bool(got.isnan().any()):
            fail(f"null_vector: NaN at {name}")
        if int(sweeps.max()) > linalg.NULL_VECTOR_SWEEPS:
            fail(f"null_vector: {name} ran {int(sweeps.max())} sweeps")
        ref = torch.linalg.svd(A.double(), full_matrices=True)
        sv = ref.S
        gap = (sv[..., -2] if A.shape[-2] >= A.shape[-1] else sv[..., -1]) \
            / sv[..., 0].clamp_min(1e-300)
        cos = (got.double() * ref.Vh[..., -1, :]).sum(-1).abs()
        det = gap >= 1e-3
        cos_min[name] = float(cos[det].min()) if bool(det.any()) else None
        if bool(det.any()) and cos_min[name] < 1 - 1e-5:
            fail(f"null_vector: {name}: |<v, v_svd>| {cos_min[name]}")
        M, n = A.shape[-2:]
        stats = sweep_stats(sweeps, rotations)
        if name.startswith("degenerate"):
            by_shape[name] = dict(sweeps=stats)
            continue
        ms = time_ms(lambda: cuda_linalg.null_vector(A))
        by_shape[name] = dict(
            ms=ms, sweeps=stats,
            us_per_round=ms * 1e3 / max(1, stats["max"] * (n + (n & 1) - 1)),
            wall_ms=wall(lambda: cuda_linalg.null_vector(A)),
            plain_ms=time_ms(lambda: linalg.null_vector_plain(A), reps=3),
            library_ms=wall(lambda: torch.linalg.svd(A, full_matrices=True)),
            bound=null_vector_bound(M, n, sweeps, rotations))
    timed = {k: v for k, v in by_shape.items() if "ms" in v}
    timing = {}
    # a fundamental RANSAC launches the eight-point and the refit shapes, a
    # PnP the DLT shape
    path = ("512x8x9", "428x9", "256x12x12")
    timing["null_vector"] = dict(
        shape=[512, 8, 9], **{k: by_shape["512x8x9"][k] for k in
                              ("ms", "plain_ms", "library_ms", "bound")},
        ms_by_shape={k: v["ms"] for k, v in timed.items()},
        wall_ms_by_shape={k: v["wall_ms"] for k, v in timed.items()},
        plain_ms_by_shape={k: v["plain_ms"] for k, v in timed.items()},
        library_ms_by_shape={k: v["library_ms"] for k, v in timed.items()},
        bound_ms_by_shape={k: v["bound"][0] for k, v in timed.items()},
        sweeps_by_shape={k: v["sweeps"] for k, v in by_shape.items()},
        us_per_round_by_shape={k: v["us_per_round"]
                               for k, v in timed.items()},
        path_ms=sum(by_shape[k]["ms"] for k in path),
        path_bound_ms=sum(by_shape[k]["bound"][0] for k in path),
        min_cos_vs_float64_svd=cos_min)

    s_by = {}
    for name, A in svd3_systems(12).items():
        A = A.to(dev)
        got, sweeps, rotations = checked_sweeps(
            "svd3", name, A, cuda_linalg.svd3, linalg.svd3_plain)
        if int(sweeps.max()) > linalg.SVD3_SWEEPS:
            fail(f"svd3: {name} ran {int(sweeps.max())} sweeps")
        U, S, Vh = (x.double() for x in got)
        err = float(((U * S[..., None, :]) @ Vh - A.double()).abs().max())
        orth = float((U.mT @ U - torch.eye(3, device=dev,
                                           dtype=U.dtype)).abs().max())
        if any(bool(x.isnan().any()) for x in got) or err > 1e-5 \
                or orth > 1e-6:
            fail(f"svd3: {name}: rebuilt to {err}, U orthogonal to {orth}")
        stats = sweep_stats(sweeps, rotations)
        if name.startswith("degenerate"):
            s_by[name] = dict(sweeps=stats)
            continue
        ms = time_ms(lambda: cuda_linalg.svd3(A))
        s_by[name] = dict(
            ms=ms, sweeps=stats,
            us_per_round=ms * 1e3 / max(1, stats["max"] * 3),
            wall_ms=wall(lambda: cuda_linalg.svd3(A)),
            plain_ms=time_ms(lambda: linalg.svd3_plain(A), reps=3),
            library_ms=wall(lambda: torch.linalg.svd(A)),
            bound=svd3_bound(sweeps, rotations))
    timed = {k: v for k, v in s_by.items() if "ms" in v}
    path = ("512x3x3", "3x3", "256x3x3")
    timing["svd3"] = dict(
        shape=[512, 3, 3], **{k: s_by["512x3x3"][k] for k in
                              ("ms", "plain_ms", "library_ms", "bound")},
        ms_by_shape={k: v["ms"] for k, v in timed.items()},
        wall_ms_by_shape={k: v["wall_ms"] for k, v in timed.items()},
        plain_ms_by_shape={k: v["plain_ms"] for k, v in timed.items()},
        library_ms_by_shape={k: v["library_ms"] for k, v in timed.items()},
        bound_ms_by_shape={k: v["bound"][0] for k, v in timed.items()},
        sweeps_by_shape={k: v["sweeps"] for k, v in s_by.items()},
        us_per_round_by_shape={k: v["us_per_round"]
                               for k, v in timed.items()},
        path_ms=sum(s_by[k]["ms"] for k in path),
        path_bound_ms=sum(s_by[k]["bound"][0] for k in path))
    return timing


def eager_phases(dev, smi_line):
    """Every phase before `compiled`, on the eager route (the caller runs it
    inside disable_graphs). Returns what the compiled phase and the result
    line read."""
    import numpy as np
    import torch

    from hessgpu_tpu_torch import (SiftConfig, describe_keypoints,
                                   detect_batch, make_plan, to_numpy_trimmed)
    from hessgpu_tpu_torch import pyramid as tpyr
    from hessgpu_tpu_torch.features import FeatureTable
    from hessgpu_tpu_torch.ops import gaussian, hessian
    from hessgpu_tpu_torch.ops.cuda import (build, conv, detect,
                                            launch_counts, patch,
                                            reset_launch_counts)
    from hessgpu_tpu_torch.ops.descriptor import (compute_descriptors_flat,
                                                  finalize_descriptors)
    from hessgpu_tpu_torch.ops.orientation import peaks_from_votes
    from hessgpu_tpu_torch.params import gaussian_taps
    from hessgpu_tpu_torch.sfm.synthetic import texture_frame

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=build.build_seconds,
         sources=[p.name for p in build.sources()],
         flags=" ".join(build.NVCC_FLAGS))

    # ---- helpers ----------------------------------------------------------
    time_ms = device_timer(dev)

    def same(a, b):
        """Bit-for-bit equality of two tensors (NaN equals NaN)."""
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return bool(torch.equal(a, b))

    def max_abs(a, b):
        d = (a.double() - b.double()).abs()
        return float(d[~d.isnan()].max()) if d.numel() else 0.0

    errs = {k: 0.0 for k in KERNEL_INFO}      # max abs error per kernel
    detect_errs = {"grad_max_rel_err": 0.0, "rot_max_abs_err": 0.0}
    checked = {k: 0 for k in KERNEL_INFO}     # shapes checked per kernel

    def must_equal(kernel, what, got, want):
        errs[kernel] = max(errs[kernel], max_abs(got.float(), want.float()))
        if not same(got, want):
            fail(f"{kernel}: {what} differs from the plain version at "
                 f"{tuple(got.shape)}: max abs err "
                 f"{max_abs(got.float(), want.float())}")

    def check_detect(stack, cfg, **over):
        p = cfg.scale_params()
        kw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
                  subpixel=cfg.subpixel,
                  darkness_adaption=cfg.darkness_adaption,
                  detector=cfg.detector)
        kw.update(over)
        args = (stack, tpyr._detect_norms(p, cfg), p.key_levels)
        gm, ggrad, grot = detect.detect_octave(*args, **kw)
        wm, wgrad, wrot = detect.detect_octave_plain(*args, **kw)
        torch.cuda.synchronize()
        # the kernel's contract: valid everywhere, the payload at the valid
        # cells only (elsewhere its maps hold what torch.empty gave)
        must_equal("detect_octave", "valid", gm.valid, wm.valid)
        for f in ("ftype", "response", "dx", "dy", "ds"):
            must_equal("detect_octave", f"{f} at the valid cells",
                       getattr(gm, f)[wm.valid], getattr(wm, f)[wm.valid])
        # grad: sqrt is IEEE on both sides, 1e-6 relative allows a last-bit
        # difference; rot: atan2f vs torch.atan2 may differ in the last bit,
        # 2e-6 rad
        rel = ((ggrad - wgrad).abs() / wgrad.abs().clamp_min(1e-30)).max()
        rot_err = (grot - wrot).abs().max()
        detect_errs["grad_max_rel_err"] = max(
            detect_errs["grad_max_rel_err"], float(rel))
        detect_errs["rot_max_abs_err"] = max(
            detect_errs["rot_max_abs_err"], float(rot_err))
        errs["detect_octave"] = max(errs["detect_octave"], float(rot_err),
                                    max_abs(ggrad, wgrad))
        if float(rel) > 1e-6:
            fail(f"detect_octave: grad rel err {float(rel)} > 1e-6")
        if float(rot_err) > 2e-6:
            fail(f"detect_octave: rot abs err {float(rot_err)} > 2e-6")
        checked["detect_octave"] += 1
        return int(gm.valid.sum())

    def check_pyramid_kernels(imgs, cfg):
        """Every kernel against its plain version along one pyramid, built
        in place as the main path builds it, each fed the same input (the
        kernel route's own intermediates): the blur into level 0 of octave
        0's stack; each chain from its level 0, decimating level level_ds
        into the next stack's level 0, against the plain chain and the plain
        decimation cropped to the plan's shape; the chain from a base and
        the standalone decimation beside them."""
        p = cfg.scale_params()
        plan = make_plan(imgs.shape[1], imgs.shape[2], cfg)
        taps0 = gaussian_taps(p.initial_blur_sigma(cfg.first_octave),
                              p.filter_width_factor)
        taps_list = gaussian.chain_taps(p)
        lds = p.level_ds - p.level_min

        def new_stack(o):
            return torch.empty((imgs.shape[0], p.num_levels)
                               + plan.octave_shapes[o], device=dev)

        stack = new_stack(0)
        conv.blur(imgs, taps0, out=stack[:, 0])
        must_equal("blur", "into a stack", stack[:, 0],
                   conv.blur_plain(imgs, taps0))
        must_equal("blur", "output", conv.blur(imgs, taps0), stack[:, 0])
        checked["blur"] += 1
        keys = 0
        for o in range(plan.num_octaves):
            base = stack[:, 0].contiguous()
            if o > 0:   # the blur at every octave shape, 13 and 33 taps
                for taps in (taps0, gaussian_taps(5.0)):
                    must_equal("blur", "octave shape", conv.blur(base, taps),
                               conv.blur_plain(base, taps))
                    checked["blur"] += 1
            want = conv.octave_chain_plain(base, taps_list)
            must_equal("octave_chain", "stack from a base",
                       conv.octave_chain(base, taps_list), want)
            nxt = new_stack(o + 1) if o + 1 < plan.num_octaves else None
            if nxt is None:
                conv.octave_chain_into(stack, taps_list)
            else:
                conv.octave_chain_into(stack, taps_list, decimate_level=lds,
                                       next_base=nxt[:, 0])
            must_equal("octave_chain", "stack in place", stack, want)
            groups = conv.octave_chain_groups(base, taps_list)
            if groups != 1:
                fail(f"octave_chain at {tuple(base.shape)} ({cfg.detector}) "
                     f"takes {groups} device launches, not one")
            checked["octave_chain"] += 1
            keys += check_detect(stack, cfg)
            if nxt is not None:
                nh, nw = plan.octave_shapes[o + 1]
                src = stack[:, lds]
                must_equal("downsample2", "the chain's decimation", nxt[:, 0],
                           conv.downsample2_plain(src)[..., :nh, :nw])
                must_equal("downsample2", "standalone", conv.downsample2(src),
                           conv.downsample2_plain(src))
                checked["downsample2"] += 2
            stack = nxt
        return keys

    def check_fused_decimation(x, taps_list, level):
        """octave_chain_into on x's stack, in place, decimating `level` into
        a plane of another stack, against the plain chain and decimation."""
        B, H, W = x.shape
        stack = torch.empty((B, 1 + len(taps_list), H, W), device=dev)
        stack[:, 0] = x
        nxt = torch.empty((B, 2, H // 2, W // 2), device=dev)
        conv.octave_chain_into(stack, taps_list, decimate_level=level,
                               next_base=nxt[:, 0])
        want = conv.octave_chain_plain(x, taps_list)
        must_equal("octave_chain", f"in place, level {level} decimated",
                   stack, want)
        must_equal("downsample2", f"the chain's decimation of level {level}",
                   nxt[:, 0],
                   conv.downsample2_plain(want[:, level])[..., :H // 2,
                                                          :W // 2])
        checked["downsample2"] += 1

    # ---- inputs -----------------------------------------------------------
    t0 = time.perf_counter()
    frames = np.stack([texture_frame(seed, HEIGHT, WIDTH)
                       for seed in range(BATCH)])
    imgs = torch.from_numpy(frames).to(dev)
    slice_cfg = dict(compute_descriptors=False, fixed_orientation=True)
    cfg_h = SiftConfig(**slice_cfg)
    cfg_d = SiftConfig(detector="dog", **slice_cfg)
    input_seconds = time.perf_counter() - t0

    # ---- kernels: correctness ----------------------------------------------
    keys_h = check_pyramid_kernels(imgs, cfg_h)
    keys_d = check_pyramid_kernels(imgs, cfg_d)
    # an odd shape (plan floor-halves, decimation ceil-halves), a tiny one,
    # the widest filter, and the detector's other switches
    rng = np.random.RandomState(7)
    taps_h = gaussian.chain_taps(cfg_h.scale_params())
    odd = torch.from_numpy(rng.rand(2, 101, 75).astype(np.float32)).to(dev)
    tiny = torch.from_numpy(rng.rand(3, 30, 40).astype(np.float32)).to(dev)
    for x in (odd, tiny):
        for cfg in (cfg_h, cfg_d):
            check_pyramid_kernels(x, cfg)
        wide = gaussian_taps(5.0)            # 33 taps, the maximum
        must_equal("blur", "33 taps", conv.blur(x, wide),
                   conv.blur_plain(x, wide))
        checked["blur"] += 1
    # the chain beyond one launch: four 33-tap transitions (cumulative halo
    # 64) run in groups of levels wherever the image is larger than a tile
    # plus that halo, and in one launch where it is smaller than the halo; an
    # identity transition copies its level
    wide_chain = [gaussian_taps(5.0)] * 4
    big = torch.from_numpy(rng.rand(2, 200, 264).astype(np.float32)).to(dev)
    chain_groups = {}
    for x in (big, odd, tiny):
        must_equal("octave_chain", "33-tap chain",
                   conv.octave_chain(x, wide_chain),
                   conv.octave_chain_plain(x, wide_chain))
        chain_groups[str(tuple(x.shape))] = conv.octave_chain_groups(
            x, wide_chain)
        checked["octave_chain"] += 1
        with_identity = [taps_h[0], (), taps_h[1], taps_h[2]]
        must_equal("octave_chain", "identity transition",
                   conv.octave_chain(x, with_identity),
                   conv.octave_chain_plain(x, with_identity))
        checked["octave_chain"] += 1
        # the epilogue in every launch of the groups: a group's base, a
        # level inside a later group, a launch's last level; and the level
        # an identity transition produces
        for level in range(len(wide_chain) + 1):
            check_fused_decimation(x, wide_chain, level)
        check_fused_decimation(x, with_identity, 2)
    if chain_groups[str(tuple(big.shape))] < 2:
        fail(f"the 33-tap chain did not run in groups: {chain_groups}")
    odd_stack_h = conv.octave_chain(odd, taps_h)
    odd_stack_d = conv.octave_chain(odd, gaussian.chain_taps(cfg_d.scale_params()))
    for stack, cfg in ((odd_stack_h, cfg_h), (odd_stack_d, cfg_d)):
        check_detect(stack, cfg, subpixel=False)
        check_detect(stack, cfg, darkness_adaption=True)
        check_detect(stack, cfg, subpixel=False, darkness_adaption=True)
    if keys_h < BATCH * 50 or keys_d < BATCH * 50:
        fail(f"degenerate kernel check: {keys_h} Hessian / {keys_d} DoG "
             "keypoints")

    # ---- per-keypoint kernels: correctness ----------------------------------
    ori_stats = {"cases": 0, "keypoints": 0, "differing_keypoints": 0,
                 "votes_max_rel_err": 0.0}
    desc_stats = {"cases": 0, "keypoints": 0, "raw_max_rel_err": 0.0,
                  "normalized_max_abs_err": 0.0, "norm_max_abs_err": 0.0}

    def keypoint_scene(x, cfg):
        """Table, maps and window sizes as the pipeline hands them to the
        per-keypoint stages for the batch x."""
        plan = make_plan(x.shape[1], x.shape[2], cfg)
        table, maps, _ = tpyr.detect_from_octaves(
            tpyr._build_pyramid(x, plan, cfg), plan, cfg)
        p = cfg.scale_params()
        owin, dwin = tpyr.window_sizes(
            cfg, p.key_level_sigma(p.key_levels[-1]) * p.sigmak)
        return table, maps, owin, dwin

    def check_orientation(t, maps, owin, **mode):
        """The orientation kernel against its plain version on one table.
        Returns (kernel result, plain result, (B, G) mask of the keypoints
        whose orientations differ between the two)."""
        args = (t.x, t.y, t.sigma, t.valid, t.level_id, maps, owin)
        got = patch.orientation(*args, return_votes=True, **mode)
        again = patch.orientation(*args, return_votes=True, **mode)
        want = patch.orientation_plain(*args, **mode)
        torch.cuda.synchronize()
        what = f"orientation {mode} at {tuple(t.x.shape)}"
        for f in ("thetas", "valid", "votes"):
            if not same(getattr(got, f), getattr(again, f)):
                fail(f"{what}: {f} differs between two runs of the kernel")
        inv = ~t.valid
        if bool(got.thetas[inv].any()) or bool(got.valid[inv].any()) \
                or bool(got.votes[inv].any()):
            fail(f"{what}: a slot that is not valid is not zero")
        scale = want.votes.amax(-1, keepdim=True).clamp_min(1e-30)
        rel = float(((got.votes - want.votes).abs() / scale).max())
        if rel > VOTE_TOL:
            fail(f"{what}: votes {rel} away from the plain version's, "
                 f"relative to the keypoint's largest; limit {VOTE_TOL}")
        # Orientations are discrete, so a histogram inside its tolerance can
        # still put a peak on the other side of 0.8 * max, swap two peaks or
        # move floor(frac * 255) by one. The plain peak picker on the
        # kernel's own histograms must give the kernel's orientations bit
        # for bit: then a keypoint that differs between the two routes
        # differs through its histogram alone, which is within VOTE_TOL.
        max_peaks = mode.get("max_peaks", 4)
        single = bool(mode.get("single")) or max_peaks <= 1
        th, ov = peaks_from_votes(got.votes, single=single,
                                  max_peaks=max_peaks)
        th = th.masked_fill(inv[..., None], 0.0)
        ov = ov & t.valid[..., None]
        if not (same(th, got.thetas) and same(ov, got.valid)):
            fail(f"{what}: the plain peak picking on the kernel's histograms "
                 "does not reproduce the kernel's orientations")
        if single:   # full-precision theta: 1e-4 rad is far below a quantum
            differing = ((got.thetas - want.thetas).abs() > 1e-4).any(-1)
        else:
            differing = ((got.valid != want.valid)
                         | (got.thetas != want.thetas)).any(-1)
        ori_stats["cases"] += 1
        ori_stats["keypoints"] += int(t.valid.sum())
        ori_stats["differing_keypoints"] += int(differing.sum())
        ori_stats["votes_max_rel_err"] = max(ori_stats["votes_max_rel_err"],
                                             rel)
        errs["orientation"] = max(errs["orientation"],
                                  max_abs(got.votes, want.votes))
        checked["orientation"] += 1
        return got, want, differing

    def check_descriptor(t, maps, dwin):
        """The descriptor kernel against its plain version on one table with
        device-frame theta. Returns the plain version's count of contributing
        pixels per slot."""
        args = (t.x, t.y, t.sigma, t.theta, t.valid, t.level_id, maps, dwin)
        got = patch.descriptor(*args)
        again = patch.descriptor(*args)
        want, support = compute_descriptors_flat(*args)
        torch.cuda.synchronize()
        what = f"descriptor at {tuple(t.x.shape)}"
        if not same(got, again):
            fail(f"{what}: two runs of the kernel differ")
        if bool(got[~t.valid].any()):
            fail(f"{what}: a slot that is not valid is not zero")
        scale = want.abs().amax((-2, -1), keepdim=True).clamp_min(1e-30)
        rel = float(((got - want).abs() / scale).max())
        if rel > VOTE_TOL:
            fail(f"{what}: raw entries {rel} away from the plain version's, "
                 f"relative to the keypoint's largest; limit {VOTE_TOL}")
        for half in (False, True):
            a = finalize_descriptors(got, t.valid, half, True)
            b = finalize_descriptors(want, t.valid, half, True)
            d = max_abs(a, b)
            desc_stats["normalized_max_abs_err"] = max(
                desc_stats["normalized_max_abs_err"], d)
            if d > DESC_TOL:
                fail(f"{what}: normalized descriptors {d} apart (half_sift="
                     f"{half}); limit {DESC_TOL}")
            some = t.valid & (got != 0).flatten(-2).any(-1)
            nerr = float((a[some].norm(dim=-1) - 1).abs().max())
            desc_stats["norm_max_abs_err"] = max(
                desc_stats["norm_max_abs_err"], nerr)
            if nerr > 1e-5:
                fail(f"{what}: a descriptor's norm is {nerr} from 1")
        desc_stats["cases"] += 1
        desc_stats["keypoints"] += int(t.valid.sum())
        desc_stats["raw_max_rel_err"] = max(desc_stats["raw_max_rel_err"], rel)
        errs["descriptor"] = max(errs["descriptor"], max_abs(got, want))
        checked["descriptor"] += 1
        return support

    # the real tables and maps of the seeded batch, in the default mode (up
    # to 2 orientations), then the expanded table through the descriptor
    cfg_def = {"hessian": SiftConfig(), "dog": SiftConfig(detector="dog")}
    scenes, differing_frames = {}, {}
    for det, cfg in cfg_def.items():
        t, maps, owin, dwin = keypoint_scene(imgs, cfg)
        got, want, differing = check_orientation(
            t, maps, owin, max_peaks=cfg.max_orientations)
        differing_frames[det] = differing.any(-1)
        g_exp = int(t.x.shape[-1] * cfg.expansion_factor + 7) // 8 * 8
        te = tpyr._expand_orientations(t, got.thetas, got.valid, g_exp)
        scenes[det] = dict(table=t, maps=maps, owin=owin, dwin=dwin,
                           expanded=te, ori_support=want.support,
                           desc_support=check_descriptor(te, maps, dwin))
    ori_modes = [dict(single=True), dict(max_peaks=1), dict(max_peaks=2),
                 dict(max_peaks=3), dict(max_peaks=4),
                 dict(max_peaks=2, half_sift=True),
                 dict(single=True, half_sift=True)]
    sc = scenes["hessian"]
    for mode in ori_modes:
        check_orientation(sc["table"], sc["maps"], sc["owin"], **mode)
    # an all-invalid table, and every sigma scaled by LARGE_SIGMA_FACTOR
    for det, cfg in cfg_def.items():
        s = scenes[det]
        tab = s["table"]
        check_orientation(tab._replace(valid=torch.zeros_like(tab.valid)),
                          s["maps"], s["owin"], max_peaks=cfg.max_orientations)
        big = tab._replace(sigma=(tab.sigma * LARGE_SIGMA_FACTOR).contiguous())
        big_win = tpyr.window_sizes(cfg, float(big.sigma[big.valid].max()))[0]
        for mode in (dict(max_peaks=cfg.max_orientations), dict(single=True)):
            _, want, _ = check_orientation(big, s["maps"], big_win, **mode)
        s["large"] = (big, big_win, want.support)
    # an odd-shaped and a tiny batch (a lower threshold, so that the small
    # frames have keypoints), every mode, both personalities
    for shape in ((2, 101, 75), (3, 30, 40)):
        x = torch.from_numpy(np.stack(
            [texture_frame(seed, *shape[1:]) for seed in range(shape[0])]
        )).to(dev)
        for det in ("hessian", "dog"):
            cfg = SiftConfig(detector=det, threshold=0.002)
            t, maps, owin, dwin = keypoint_scene(x, cfg)
            if int(t.valid.sum()) < 3:
                fail(f"degenerate per-keypoint check at {shape} ({det})")
            for mode in ori_modes:
                got, _, _ = check_orientation(t, maps, owin, **mode)
            check_descriptor(
                t._replace(theta=got.thetas[..., 0].contiguous()), maps, dwin)

    # ---- kernels: time, at every shape the main path gives them ------------
    p = cfg_h.scale_params()
    plan = make_plan(HEIGHT, WIDTH, cfg_h)
    taps0 = gaussian_taps(p.initial_blur_sigma(0), p.filter_width_factor)
    taps_list = gaussian.chain_taps(p)
    chain_taps_n = [len(t) for t in taps_list]
    lds = p.level_ds - p.level_min
    L, NK = p.num_levels, len(p.key_levels)
    norms = tpyr._detect_norms(p, cfg_h)
    dkw = dict(threshold=p.threshold, edge_threshold=p.edge_threshold,
               subpixel=True, darkness_adaption=False, detector="hessian")
    octaves = tpyr._build_pyramid(imgs, plan, cfg_h)
    bases = [o[:, 0].contiguous() for o in octaves]

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        return max(tb, tf), ("bytes" if tb >= tf else "operations")

    timing = {}
    # blur: one launch on the main path, the initial blur. Its library
    # yardstick is one cuDNN convolution with the outer product of the taps
    # over a replicate-padded copy (TF32 by default, so it is held to 2e-3
    # only); timed here, used nowhere in the port.
    n0 = BATCH * HEIGHT * WIDTH
    r0 = len(taps0) // 2
    t0f = torch.tensor(taps0, dtype=torch.float32, device=dev)
    k2d = torch.outer(t0f, t0f)[None, None]

    def blur_library():
        padded = torch.nn.functional.pad(imgs[:, None], (r0, r0, r0, r0),
                                         mode="replicate")
        return torch.nn.functional.conv2d(padded, k2d)[:, 0]

    lib_err = max_abs(blur_library(), conv.blur(imgs, taps0))
    if lib_err > 2e-3:
        fail(f"blur: the library convolution is {lib_err} away")

    def blur_bound(x, taps):
        # reads the planes once, writes them once; 2 passes of `taps`
        # multiply-adds
        return bound(8 * x.numel(), 4 * len(taps) * x.numel())

    def blur_path(cfg):
        """The blur launches of one batch of cfg's main path: the initial
        blur, and a restart blur at every later octave where the scale
        schedule has one (octave_restart_sigma() is 0 for both
        personalities: level_ds - num_scales == level_min). Returns (ms,
        bound ms, restart launches), each launch timed at its own shape."""
        q = cfg.scale_params()
        calls = [(imgs, gaussian_taps(q.initial_blur_sigma(cfg.first_octave),
                                      q.filter_width_factor))]
        if q.octave_restart_sigma() > 0:
            rt = gaussian_taps(q.octave_restart_sigma(), q.filter_width_factor)
            calls += [(b, rt) for b in bases[1:]]
        return (sum(time_ms(lambda: conv.blur(x, t)) for x, t in calls),
                sum(blur_bound(x, t)[0] for x, t in calls), len(calls) - 1)

    blur_h, blur_d = blur_path(cfg_h), blur_path(cfg_d)
    timing["blur"] = dict(
        shape=[BATCH, HEIGHT, WIDTH, len(taps0)],
        ms=time_ms(lambda: conv.blur(imgs, taps0)),
        plain_ms=time_ms(lambda: conv.blur_plain(imgs, taps0)),
        library_ms=time_ms(blur_library), library_max_abs_err=lib_err,
        bound=blur_bound(imgs, taps0),
        path_ms=blur_h[0], path_bound_ms=blur_h[1],
        path_ms_by_detector={"hessian": blur_h[0], "dog": blur_d[0]},
        restart_blurs_by_detector={"hessian": blur_h[2], "dog": blur_d[2]},
        segment_rows=conv.blur_segment_rows(imgs),
        # the same 13 taps at the smaller octave shapes, and the widest
        # filter at the main path's shape
        octave_shape_ms=[time_ms(lambda: conv.blur(b, taps0))
                         for b in bases[1:]],
        ms_33_taps=time_ms(lambda: conv.blur(imgs, gaussian_taps(5.0))))

    # Bounds of the multi-launch kernels, per launch at each octave's shape;
    # a path bound is their sum over the launches of one batch.
    def chain_bound(n, n_dec=0):
        # in place: reads level 0 once, writes the L - 1 levels after it and
        # the n_dec pixels of the decimated plane; per level 2 passes of taps
        return bound(4 * n * L + 4 * n_dec, 4 * sum(chain_taps_n) * n)

    def down_bound(n):
        # standalone: reads the kept quarter of the pixels, writes them
        return bound(8 * n, 0)

    def epilogue_bound(n):
        # fused: the kept pixels are on chip; it writes them
        return bound(4 * n, 0)

    def detect_bound(n, n_valid):
        # reads L Gaussian planes; writes per key level valid (1 byte), grad
        # and rot (4 bytes each) at every pixel and the payload (response,
        # dx, dy, ds, ftype: 20 bytes) at this run's valid cells. About 13
        # float ops per response plane and pixel, 30 per key level and
        # pixel (threshold, gradient, angle), 170 per valid cell (NMS, edge
        # test, 3x3 solve, typing)
        return bound(n * (4 * L + 9 * NK) + 20 * n_valid,
                     n * (13 * L + 30 * NK) + 170 * n_valid)

    def detect_bound_dense(n):
        # the dense contract: all eight maps at every pixel, the whole
        # test at every pixel and key level
        return bound(n * (4 * L + 29 * NK), n * (13 * L + 170 * NK))

    n_oct = [BATCH * h * w for h, w in plan.octave_shapes]
    # the decimated plane of octave o: level 0 of octave o + 1
    n_dec = [BATCH * h * w for h, w in plan.octave_shapes[1:]] + [0]
    chain_ms, nodec_ms, from_base_ms, down_ms = [], [], [], []
    det_ms, det_valid = [], []
    for o, stack in enumerate(octaves):
        # the main path's call, in place into a copy of the octave's stack
        # (level 0 stays, the levels after it are rewritten alike), the
        # decimation into a plane of a stack of the next octave's shape
        work = stack.clone()
        fused = {}
        if o + 1 < len(octaves):
            nxt = torch.empty_like(octaves[o + 1])
            fused = dict(decimate_level=lds, next_base=nxt[:, 0])
        chain_ms.append(time_ms(
            lambda: conv.octave_chain_into(work, taps_list, **fused)))
        nodec_ms.append(time_ms(
            lambda: conv.octave_chain_into(work, taps_list)))
        from_base_ms.append(time_ms(
            lambda: conv.octave_chain(bases[o], taps_list)))
        det_valid.append(int(detect.detect_octave(
            stack, norms, p.key_levels, **dkw)[0].valid.sum()))
        det_ms.append(time_ms(
            lambda: detect.detect_octave(stack, norms, p.key_levels, **dkw)))
        if o + 1 < len(octaves):
            down_ms.append(time_ms(
                lambda: conv.downsample2(stack[:, lds])))
        del work, fused

    def chain_plain_0():
        # what the plain route does for octave 0: the chain, then the
        # decimation of level level_ds, cropped, as the next base
        s0 = conv.octave_chain_plain(bases[0], taps_list)
        h1, w1 = plan.octave_shapes[1]
        return conv.downsample2_plain(s0[:, lds])[..., :h1, :w1].contiguous()

    timing["octave_chain"] = dict(
        shape=list(octaves[0].shape), ms=chain_ms[0], octave_ms=chain_ms,
        path_ms=sum(chain_ms), octave_ms_without_decimation=nodec_ms,
        octave_ms_from_base=from_base_ms,
        plain_ms=time_ms(chain_plain_0),
        library_ms=None, bound=chain_bound(n0, n_dec[0]),
        octave_bound_ms=[chain_bound(n, d)[0] for n, d in zip(n_oct, n_dec)],
        path_bound_ms=sum(chain_bound(n, d)[0] for n, d in zip(n_oct, n_dec)))
    src0 = octaves[0][:, lds]
    n_down = [BATCH * ((h + 1) // 2) * ((w + 1) // 2)
              for h, w in plan.octave_shapes[:-1]]
    epilogue_ms = [a - b for a, b in zip(chain_ms[:-1], nodec_ms[:-1])]
    timing["downsample2"] = dict(
        fused_into="octave_chain",
        shape=list(src0.shape), ms=down_ms[0], octave_ms=down_ms,
        standalone_path_ms=sum(down_ms),
        standalone_path_bound_ms=sum(down_bound(n)[0] for n in n_down),
        epilogue_ms_by_octave=epilogue_ms,
        epilogue_bound_ms_by_octave=[epilogue_bound(n)[0]
                                     for n in n_dec[:-1]],
        path_ms=sum(epilogue_ms),
        path_bound_ms=sum(epilogue_bound(n)[0] for n in n_dec[:-1]),
        plain_ms=time_ms(lambda: conv.downsample2_plain(src0)),
        # the one PyTorch call that computes the same function
        library_ms=time_ms(lambda: src0[..., ::2, ::2].contiguous()),
        bound=down_bound(n_down[0]))

    def detect_gate_shares(stack):
        """The kernel's first gate on one octave: the share of warp passes
        (32 adjacent columns of one row, one key level) with a lane inside
        the border whose |response| passes the threshold - they run the
        NMS - and the share that holds a keypoint. A function, so that its
        temporaries are gone before the main path's peak memory is read."""
        def warp_share(m):
            seg = torch.nn.functional.pad(m, (0, (-m.shape[-1]) % 32))
            return float(seg.reshape(m.shape[:-1] + (-1, 32)).any(-1)
                         .float().mean())

        valid = detect.detect_octave(stack, norms, p.key_levels,
                                     **dkw)[0].valid
        resp = hessian.hessian_response_and_gradient(
            stack, norms, grad_levels=p.key_levels)[0][:, p.key_levels]
        interior = torch.zeros(resp.shape[-2:], dtype=torch.bool, device=dev)
        interior[1:-1, 1:-1] = True
        thr0 = 0.8 * p.threshold if dkw["subpixel"] else p.threshold
        return warp_share(interior & (resp.abs() > thr0)), warp_share(valid)

    share_nms, share_keypoint = detect_gate_shares(octaves[0])
    timing["detect_octave"] = dict(
        shape=list(octaves[0].shape), ms=det_ms[0], octave_ms=det_ms,
        path_ms=sum(det_ms),
        plain_ms=time_ms(lambda: detect.detect_octave_plain(
            octaves[0], norms, p.key_levels, **dkw)),
        library_ms=None, valid_cells=det_valid,
        bound=detect_bound(n0, det_valid[0]),
        path_bound_ms=sum(detect_bound(n, v)[0]
                          for n, v in zip(n_oct, det_valid)),
        bound_ms_dense_contract=detect_bound_dense(n0)[0],
        path_bound_ms_dense_contract=sum(detect_bound_dense(n)[0]
                                         for n in n_oct),
        octave0_warp_share_nms=share_nms,
        octave0_warp_share_keypoint=share_keypoint)
    # the per-keypoint kernels at the main path's tables. Bound: each valid
    # keypoint's contributing pixels read once from both maps, the table read
    # once, the outputs written once; operations per contributing pixel as
    # counted in the kernels.
    def sum_int(a):
        return int(a.sum(dtype=torch.int64))

    t, maps, te = sc["table"], sc["maps"], sc["expanded"]
    ori_args = (t.x, t.y, t.sigma, t.valid, t.level_id, maps, sc["owin"])
    ori_kw = dict(max_peaks=cfg_def["hessian"].max_orientations)
    n_ori, px_ori = t.x.numel(), sum_int(sc["ori_support"])
    ori_none = ori_args[:3] + (torch.zeros_like(t.valid),) + ori_args[4:]
    big, big_win, big_support = sc["large"]
    ori_big = (big.x, big.y, big.sigma, big.valid, big.level_id, maps,
               big_win)
    timing["orientation"] = dict(
        shape=list(t.x.shape),
        ms=time_ms(lambda: patch.orientation(*ori_args, **ori_kw)),
        empty_table_ms=time_ms(lambda: patch.orientation(*ori_none,
                                                         **ori_kw)),
        large_support_ms=time_ms(lambda: patch.orientation(*ori_big,
                                                           **ori_kw)),
        large_support_pixels=sum_int(big_support),
        plain_ms=time_ms(lambda: patch.orientation_plain(*ori_args, **ori_kw),
                         reps=3),
        library_ms=None, valid_keypoints=sum_int(t.valid),
        support_pixels=px_ori,
        bound=bound(8 * px_ori + n_ori * (17 + 20),
                    ORI_FLOPS_PER_PIXEL * px_ori))
    desc_args = (te.x, te.y, te.sigma, te.theta, te.valid, te.level_id, maps,
                 sc["dwin"])
    n_desc, px_desc = te.x.numel(), sum_int(sc["desc_support"])
    # the same table with every slot marked not valid: what the walk over
    # the slots and the zeros cost
    no_slot = torch.zeros_like(te.valid)
    empty_args = desc_args[:4] + (no_slot,) + desc_args[5:]
    if bool(patch.descriptor(*empty_args).any()):
        fail("descriptor: an all-invalid table does not give zeros")
    timing["descriptor"] = dict(
        shape=list(te.x.shape),
        ms=time_ms(lambda: patch.descriptor(*desc_args)),
        empty_table_ms=time_ms(lambda: patch.descriptor(*empty_args)),
        plain_ms=time_ms(lambda: patch.descriptor_plain(*desc_args), reps=3),
        library_ms=None, valid_keypoints=sum_int(te.valid),
        support_pixels=px_desc,
        bound=bound(8 * px_desc + n_desc * (21 + 512),
                    DESC_FLOPS_PER_PIXEL * px_desc))
    for name in ("orientation", "descriptor"):
        timing[name]["path_ms"] = timing[name]["ms"]
    for name in ("orientation", "descriptor"):   # one launch a batch
        timing[name]["path_bound_ms"] = timing[name]["bound"][0]
    # the SfM path's kernels: the RANSAC cores' small SVDs
    timing.update(linalg_kernels(dev, time_ms, must_equal, checked))
    emit("kernels",
         max_abs_err=errs, detect=detect_errs,
         exact=["blur", "octave_chain", "downsample2",
                "detect_octave: valid; ftype response dx dy ds at the "
                "valid cells", "null_vector (the tall refit too)",
                "svd3: U S Vh"],
         tolerances={"grad_rel": 1e-6, "rot_abs": 2e-6,
                     "votes_and_raw_descriptor_rel": VOTE_TOL,
                     "normalized_descriptor_abs": DESC_TOL},
         orientation=ori_stats, descriptor=desc_stats,
         deterministic=["orientation", "descriptor"],
         keypoints_checked={"hessian": keys_h, "dog": keys_d},
         chain_device_launches_33_taps=chain_groups,
         empty_table_ms={k: timing[k]["empty_table_ms"]
                         for k in ("orientation", "descriptor")},
         shapes_checked=checked,
         timing_ms={k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                    for k, v in timing.items()},
         reps=REPS, l2_flushed=True, busy_cycles=BUSY_CYCLES)

    # ---- compaction: the per-row candidate cap on the card ------------------
    def check_row_cap():
        """compact_octave_keypoints of a flooded (16, 3, 480, 640) octave on
        the card against the same on the CPU: key level 0 has rows of 214
        candidates (the cap keeps 32), level 1 sparse cells only, level 2
        so many capped rows that the level cap binds too. Every field but
        sigma bit for bit. A function, so that its maps are gone before the
        main path's peak memory is read."""
        from hessgpu_tpu_torch.ops.compaction import (_row_cap,
                                                      compact_octave_keypoints)
        from hessgpu_tpu_torch.ops.keypoint import KeypointMaps
        g = np.random.RandomState(9)
        shape = (BATCH, 3, HEIGHT, WIDTH)
        valid = g.rand(*shape) < 0.002
        valid[:, 0, ::37, ::3] = True
        valid[:, 2, ::5, ::2] = True
        f = lambda: torch.from_numpy(
            g.rand(*shape).astype(np.float32) * 1.9 - 0.95)
        cpu_maps = KeypointMaps(
            valid=torch.from_numpy(valid), response=f(), dx=f(), dy=f(),
            ds=f(), ftype=torch.from_numpy(g.randint(0, 3, shape)
                                           .astype(np.int32)))
        cap = plan.level_caps[0]
        sig = [p.key_level_sigma(k) for k in p.key_levels]
        want = compact_octave_keypoints(cpu_maps, sig, p.sigmak, cap)
        got = compact_octave_keypoints(
            KeypointMaps(*(a.to(dev) for a in cpu_maps)), sig, p.sigmak, cap)
        torch.cuda.synchronize()
        for fld in ("valid", "x", "y", "theta", "response", "ftype"):
            if not same(getattr(got, fld).cpu(), getattr(want, fld)):
                fail(f"row-capped compaction: {fld} differs between the card "
                     "and the CPU")
        # sigma = level sigma * step**ds: pow may differ in the last bit
        # between the two devices
        sig_err = float(((got.sigma.cpu() - want.sigma).abs()
                         / want.sigma.abs().clamp_min(1e-30)).max())
        if sig_err > 1e-6:
            fail(f"row-capped compaction: sigma {sig_err} apart (rel)")
        kpr = min(WIDTH, _row_cap(WIDTH))
        expect = np.minimum(valid.sum(-1), kpr).sum(-1).clip(max=cap)
        counts = want.count().numpy()
        if not (counts == expect).all() or counts[0, 0] >= valid[0, 0].sum() \
                or counts[0, 2] != cap:
            fail(f"row-capped compaction: counts {counts[0].tolist()}, "
                 f"expected {expect[0].tolist()}")
        emit("compaction", shape=list(shape), capacity=cap, kpr=kpr,
             frame0_valid_cells=valid[0].sum((-2, -1)).tolist(),
             frame0_kept=counts[0].tolist(), card_equals_cpu=True,
             sigma_max_rel_err=sig_err,
             sigma_bit_equal=bool(same(got.sigma.cpu(), want.sigma)))

    check_row_cap()

    # ---- main path ----------------------------------------------------------
    def table_fields(t):
        return {f: getattr(t, f) for f in t._fields}

    def run_main(cfg, pinned):
        reset_launch_counts()
        table = detect_batch(imgs, cfg)              # device defaults to cuda
        torch.cuda.synchronize()
        launches = launch_counts()
        for name, n in launches.items():
            if n == 0 and EXPECTED_LAUNCHES[name]:
                fail(f"main path ({cfg.detector}) never launched {name}")
        if launches != EXPECTED_LAUNCHES:
            fail(f"launch counts {launches} != {EXPECTED_LAUNCHES}")
        plain = detect_batch(imgs, cfg, plain=True)  # plain versions, on the card
        torch.cuda.synchronize()
        if launch_counts() != launches:
            fail("the plain run launched a kernel")
        G = min(cfg.global_feature_cap, sum(plan.level_caps))
        for f, a in table_fields(table).items():
            want_shape = (BATCH, G) + ((128,) if f == "desc" else ())
            if tuple(a.shape) != want_shape:
                fail(f"{f}: shape {tuple(a.shape)} != {want_shape}")
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{f}: non-finite values")
            if not same(a, getattr(plain, f)):
                fail(f"main path ({cfg.detector}): {f} differs between the "
                     "kernels and the plain versions")
        if bool(table.theta.any()) or bool(table.desc.any()):
            fail("theta/desc must be zero in the upright, detection-only mode")
        counts = table.count().tolist()
        if pinned:
            lv = table.level[0][table.valid[0]].cpu().numpy()
            level_counts = np.bincount(lv, minlength=len(plan.level_caps))
            if counts[0] != FRAME0_KEYPOINTS or \
                    level_counts.tolist() != FRAME0_LEVEL_COUNTS:
                fail(f"frame 0: {counts[0]} keypoints, per level "
                     f"{level_counts.tolist()}; pinned {FRAME0_KEYPOINTS}, "
                     f"{FRAME0_LEVEL_COUNTS}")
            # the same frame on the CPU (plain versions): same keypoints.
            # exp2/pow differ in the last bit between the two devices, so
            # sigma is compared to 1e-6 relative; the rest is exact.
            cpu = detect_batch(frames[:1], cfg, device="cpu")
            for f in ("valid", "level", "ftype", "response", "x", "y"):
                if not same(getattr(table, f)[:1].cpu(), getattr(cpu, f)):
                    fail(f"frame 0: {f} differs between the card and the CPU")
            if not torch.allclose(table.sigma[:1].cpu(), cpu.sigma,
                                  rtol=1e-6, atol=0):
                fail("frame 0: sigma differs between the card and the CPU")
        return launches, counts

    launches_h, counts_h = run_main(cfg_h, pinned=True)

    # a few timed iterations of the entry point, host clock around work that
    # ends in a synchronize
    torch.cuda.reset_peak_memory_stats()
    iters = []
    for _ in range(5):
        t0 = time.perf_counter()
        detect_batch(imgs, cfg_h)
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    kernel_path_ms = sum(t["path_ms"] for name, t in timing.items()
                         if EXPECTED_LAUNCHES[name])
    emit("main_path", config="-sd -ofix", detector="hessian", batch=BATCH,
         height=HEIGHT,
         width=WIDTH, launches=launches_h, keypoints=counts_h,
         frame0_keypoints=counts_h[0], equals_plain=True,
         frame0_equals_cpu=True,
         batch_seconds=iters, frames_per_s_best=BATCH / min(iters),
         frames_per_s_median=BATCH / statistics.median(iters),
         kernels_ms_per_batch=kernel_path_ms,
         max_memory_allocated=peak, input_seconds=round(input_seconds, 3))

    launches_d, counts_d = run_main(cfg_d, pinned=False)
    emit("main_path", config="-sd -ofix", detector="dog", batch=BATCH,
         launches=launches_d, keypoints=counts_d, equals_plain=True)

    # ---- main path, default configuration -----------------------------------
    quantum = 2.0 * np.pi / 255.0

    def circ(a, b):
        d = (a - b).abs() % (2.0 * np.pi)
        return torch.minimum(d, 2.0 * np.pi - d)

    def run_main_default(cfg, pinned):
        reset_launch_counts()
        table = detect_batch(imgs, cfg)              # device defaults to cuda
        torch.cuda.synchronize()
        launches = launch_counts()
        for name, n in launches.items():
            if n == 0 and EXPECTED_LAUNCHES_DEFAULT[name]:
                fail(f"default main path ({cfg.detector}) never launched "
                     f"{name}")
        if launches != EXPECTED_LAUNCHES_DEFAULT:
            fail(f"launch counts {launches} != {EXPECTED_LAUNCHES_DEFAULT}")
        plain = detect_batch(imgs, cfg, plain=True)  # plain versions, on the card
        torch.cuda.synchronize()
        if launch_counts() != launches:
            fail("the plain run launched a kernel")
        G = min(cfg.global_feature_cap, sum(plan.level_caps))
        g_exp = int(G * cfg.expansion_factor + 7) // 8 * 8
        for f, a in table_fields(table).items():
            want_shape = (BATCH, g_exp) + ((128,) if f == "desc" else ())
            if tuple(a.shape) != want_shape:
                fail(f"{f}: shape {tuple(a.shape)} != {want_shape}")
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{f}: non-finite values")
        # Both runs feed bit-equal tables to the orientation stage (checked
        # above, field for field), so the keypoints whose orientations differ
        # between kernel and plain version are those the kernels phase found
        # and explained. A frame that holds one has its later slots shifted;
        # every other frame must agree slot for slot.
        ok = ~differing_frames[cfg.detector]
        for f in ("valid", "level", "ftype", "x", "y", "sigma", "response",
                  "theta"):
            if not same(getattr(table, f)[ok], getattr(plain, f)[ok]):
                fail(f"default main path ({cfg.detector}): {f} differs "
                     "between the kernels and the plain versions")
        desc_err = max_abs(table.desc[ok], plain.desc[ok])
        if desc_err > DESC_TOL:
            fail(f"default main path ({cfg.detector}): descriptors "
                 f"{desc_err} apart; limit {DESC_TOL}")
        norm_err = float((table.desc[table.valid].norm(dim=-1) - 1)
                         .abs().max())
        if norm_err > 1e-5:
            fail(f"a valid descriptor's norm is {norm_err} from 1")
        if bool(table.desc[~table.valid].any()) \
                or bool(table.theta[~table.valid].any()):
            fail("a slot that is not valid is not zero")
        counts = table.count().tolist()
        report = dict(launches=launches, features=counts,
                      frames_with_differing_orientations=int((~ok).sum()),
                      desc_max_abs_err=desc_err, norm_max_abs_err=norm_err)
        if pinned:
            lv = table.level[0][table.valid[0]].cpu().numpy()
            levels = np.bincount(lv, minlength=len(plan.level_caps)).tolist()
            if counts[0] != FRAME0_FEATURES or levels != FRAME0_FEATURE_LEVELS:
                fail(f"frame 0: {counts[0]} features, per level {levels}; "
                     f"pinned {FRAME0_FEATURES}, {FRAME0_FEATURE_LEVELS}")
            # The same frame on the CPU (plain versions). exp, atan2 and the
            # sums differ in the last bits between the devices: positions
            # are exact, sigma 1e-6 relative; an orientation may land one
            # 2pi/255 quantum away on at most 1% of the features, and the
            # descriptors of the others agree to 1e-5.
            cpu = detect_batch(frames[:1], cfg, device="cpu")
            for f in ("valid", "level", "ftype", "response", "x", "y"):
                if not same(getattr(table, f)[:1].cpu(), getattr(cpu, f)):
                    fail(f"frame 0: {f} differs between the card and the CPU")
            if not torch.allclose(table.sigma[:1].cpu(), cpu.sigma,
                                  rtol=1e-6, atol=0):
                fail("frame 0: sigma differs between the card and the CPU")
            dth = circ(table.theta[:1].cpu(), cpu.theta)
            moved = dth > 1e-6
            if float(dth.max()) > quantum + 1e-6 \
                    or int(moved.sum()) > counts[0] // 100:
                fail(f"frame 0: theta differs between the card and the CPU "
                     f"on {int(moved.sum())} features, by up to "
                     f"{float(dth.max())}")
            cpu_err = max_abs(table.desc[:1].cpu()[~moved], cpu.desc[~moved])
            if cpu_err > 1e-5:
                fail(f"frame 0: descriptors {cpu_err} apart between the card "
                     "and the CPU")
            report.update(frame0_features=counts[0],
                          frame0_theta_moved_vs_cpu=int(moved.sum()),
                          frame0_desc_max_abs_err_vs_cpu=cpu_err)
        return table, report

    table_def, report_h = run_main_default(cfg_def["hessian"], pinned=True)
    launches_def = report_h["launches"]
    torch.cuda.reset_peak_memory_stats()
    iters = []
    for _ in range(5):
        t0 = time.perf_counter()
        detect_batch(imgs, cfg_def["hessian"])
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t0)
    emit("main_path", config="default", detector="hessian", batch=BATCH,
         height=HEIGHT, width=WIDTH, **report_h,
         batch_seconds=iters, frames_per_s_best=BATCH / min(iters),
         frames_per_s_median=BATCH / statistics.median(iters),
         kernels_ms_per_batch=sum(t["path_ms"] for name, t in timing.items()
                                  if EXPECTED_LAUNCHES_DEFAULT[name]),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    _, report_d = run_main_default(cfg_def["dog"], pinned=False)
    emit("main_path", config="default", detector="dog", batch=BATCH,
         **report_d)

    # ---- keypoint re-entry --------------------------------------------------
    # describe_keypoints on the card, fed frame 0's own keypoints. It bins a
    # keypoint to a level by its scale, which is not always the level it was
    # detected on (the subpixel step moves sigma); where it is, (a) without
    # theta its full-precision strongest orientation lies within one 2pi/255
    # quantum of the pipeline's first, quantized one, and the descriptors,
    # taken a fraction of a quantum apart, within 0.05; (b) given the
    # pipeline's theta the descriptors agree to 1e-5 on at least 99% of the
    # keypoints (a pixel whose angle sits on a bin edge can move a whole
    # vote: 0.02 at most).
    from hessgpu_tpu_torch.describe import _bin_by_scale
    f0 = to_numpy_trimmed(FeatureTable(*(a[0] for a in table_def)))
    keys = np.stack([f0["x"], f0["y"], f0["sigma"], f0["theta"]], axis=1)
    first = np.ones(len(keys), bool)        # first orientation per keypoint
    first[1:] = (keys[1:, :3] != keys[:-1, :3]).any(axis=1)
    binned, _ = _bin_by_scale(f0["sigma"], plan.num_octaves,
                              cfg_def["hessian"])
    level_kept = binned == f0["level"]
    reset_launch_counts()
    no_theta = describe_keypoints(frames[0], keys[first, :3],
                                  has_orientation=False)
    with_theta = describe_keypoints(frames[0], keys)
    describe_launches = launch_counts()
    if describe_launches["orientation"] != 1 \
            or describe_launches["descriptor"] != 2:
        fail(f"describe_keypoints launches: {describe_launches}")
    sel = level_kept[first]
    dth = np.abs(np.mod(no_theta["theta"] - f0["theta"][first] + np.pi,
                        2 * np.pi) - np.pi)[sel]
    dd = np.abs(no_theta["desc"] - f0["desc"][first]).max(axis=1)[sel]
    dd4 = np.abs(with_theta["desc"] - f0["desc"]).max(axis=1)[level_kept]
    if sel.mean() < 0.8 or dth.max() > quantum + 1e-5 or dd.max() > 0.05 \
            or (dd4 <= 1e-5).mean() < 0.99 or dd4.max() > 0.02 \
            or not np.isfinite(no_theta["desc"]).all() \
            or not np.isfinite(with_theta["desc"]).all():
        fail(f"describe_keypoints vs the pipeline on frame 0: level kept "
             f"{sel.mean()}, theta {dth.max()}, desc {dd.max()}, with theta "
             f"{dd4.max()} ({(dd4 <= 1e-5).mean()} within 1e-5)")
    emit("describe", keypoints=int(first.sum()), features=len(keys),
         level_kept_share=float(level_kept.mean()),
         theta_max_abs_diff=float(dth.max()), quantum=quantum,
         desc_max_abs_diff_without_theta=float(dd.max()),
         desc_max_abs_diff_with_theta=float(dd4.max()),
         share_within_1e_5_with_theta=float((dd4 <= 1e-5).mean()),
         launches=describe_launches)

    # =======================================================================
    # The public entry points and the last two pipeline modes. Each phase
    # sets the launch counts to 0 just before it drives its path and reads
    # them just after.
    # =======================================================================
    from hessgpu_tpu_torch import HessianSift, SiftMatcher, detect_and_describe
    from hessgpu_tpu_torch import matcher as tmatch
    from hessgpu_tpu_torch.evaluation import (evaluate_repeatability,
                                              rotation_homography, warp_image)
    from hessgpu_tpu_torch.formats import load_sift_text
    from hessgpu_tpu_torch.ops.resize import upsample
    from hessgpu_tpu_torch.utils.timing import (REFERENCE_BUCKETS,
                                                device_profile, synchronize)

    def wall_ms(fn, reps=5):
        """Host clock around fn() and a synchronize, after one warm-up:
        every rep's ms."""
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def device_busy(fn):
        """Device ms and pieces of device work per call of fn (the port's
        own accounting, utils.timing.device_profile), over 5 calls."""
        prof = device_profile(fn)
        if prof["busy_ms"] <= 0:
            fail("torch.profiler saw no device time")
        return dict(busy_ms=prof["busy_ms"], kernel_launches=prof["launches"])

    def frame_vs_cpu(card_table, cpu_table, what, descriptors=True):
        """One frame on the card against the same frame on the CPU (plain
        versions): the rules of the main path's frame-0 check."""
        for f in ("valid", "level", "ftype", "response", "x", "y"):
            if not same(getattr(card_table, f).cpu(), getattr(cpu_table, f)):
                fail(f"{what}: {f} differs between the card and the CPU")
        if not torch.allclose(card_table.sigma.cpu(), cpu_table.sigma,
                              rtol=1e-6, atol=0):
            fail(f"{what}: sigma differs between the card and the CPU")
        n = int(cpu_table.valid.sum())
        dth = circ(card_table.theta.cpu(), cpu_table.theta)
        moved = dth > 1e-6
        if float(dth.max()) > quantum + 1e-6 or int(moved.sum()) > n // 100:
            fail(f"{what}: theta differs between the card and the CPU on "
                 f"{int(moved.sum())} features, by up to {float(dth.max())}")
        err = max_abs(card_table.desc.cpu()[~moved], cpu_table.desc[~moved]) \
            if descriptors else 0.0
        if err > 1e-5:
            fail(f"{what}: descriptors {err} apart between the card and the "
                 "CPU")
        return dict(features=n, theta_moved=int(moved.sum()),
                    desc_max_abs_err=err)

    def kernels_equal_plain(table, plain, ok, what):
        """The main path through the kernels against the plain versions on
        the card, slot for slot on the frames `ok` (a frame outside it holds
        a keypoint whose orientations the kernels phase found differing
        within tolerance), descriptors within DESC_TOL."""
        for f in ("valid", "level", "ftype", "x", "y", "sigma", "response",
                  "theta"):
            if not same(getattr(table, f)[ok], getattr(plain, f)[ok]):
                fail(f"{what}: {f} differs between the kernels and the plain "
                     "versions")
            a = getattr(table, f)
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                fail(f"{what}: {f} has non-finite values")
        err = max_abs(table.desc[ok], plain.desc[ok])
        if err > DESC_TOL:
            fail(f"{what}: descriptors {err} apart; limit {DESC_TOL}")
        return err

    launches_by_path = {"default": launches_def}

    # ---- first_octave: DoG at -fo -1, octave 0 upsampled to 960x1280 -------
    cfg_fo = SiftConfig(detector="dog", first_octave=-1)
    up = upsample(imgs).contiguous()                   # (16, 960, 1280)
    plan_fo = make_plan(2 * HEIGHT, 2 * WIDTH, cfg_fo)
    n_fo = plan_fo.num_octaves
    # the kernels against their plain versions along this pyramid (blur,
    # chain in place with its decimation, detect) and on its tables
    keys_fo = check_pyramid_kernels(up, cfg_fo)
    t_fo, maps_fo, owin_fo, dwin_fo = keypoint_scene(up, cfg_fo)
    got_fo, _, differing_fo = check_orientation(
        t_fo, maps_fo, owin_fo, max_peaks=cfg_fo.max_orientations)
    g_fo = int(t_fo.x.shape[-1] * cfg_fo.expansion_factor + 7) // 8 * 8
    check_descriptor(tpyr._expand_orientations(t_fo, got_fo.thetas,
                                               got_fo.valid, g_fo),
                     maps_fo, dwin_fo)
    del t_fo, maps_fo, got_fo
    expected_fo = dict(EXPECTED_LAUNCHES_DEFAULT, octave_chain=n_fo,
                       detect_octave=n_fo, row_counts=n_fo)
    reset_launch_counts()
    table_fo = detect_batch(up, cfg_fo)
    torch.cuda.synchronize()
    launches_fo = launch_counts()
    if launches_fo != expected_fo:
        fail(f"-fo -1 launch counts {launches_fo} != {expected_fo}")
    launches_by_path["first_octave_dog"] = launches_fo
    plain_fo = detect_batch(up, cfg_fo, plain=True)
    torch.cuda.synchronize()
    if launch_counts() != launches_fo:
        fail("the plain -fo -1 run launched a kernel")
    ok_fo = ~differing_fo.any(-1)
    fo_desc_err = kernels_equal_plain(table_fo, plain_fo, ok_fo, "-fo -1")
    # frame 0 through detect_and_describe (the upsample on the card), against
    # the batch's row 0 and against the CPU
    one_fo, _ = detect_and_describe(frames[0], cfg_fo)
    for f in one_fo._fields:
        if not same(getattr(one_fo, f), getattr(table_fo, f)[0]):
            fail(f"-fo -1 frame 0: {f} differs between detect_and_describe "
                 "and the batch")
    cpu_fo, _ = detect_and_describe(frames[0], cfg_fo, device="cpu")
    fo_cpu = frame_vs_cpu(one_fo, cpu_fo, "-fo -1 frame 0")
    # ms per frame, and the two dense kernels at 960x1280
    fo_batch_ms = wall_ms(lambda: detect_batch(up, cfg_fo))
    fo_frame_ms = wall_ms(lambda: detect_and_describe(frames[0], cfg_fo))
    p_fo = cfg_fo.scale_params()
    taps_fo = gaussian.chain_taps(p_fo)
    lds_fo = p_fo.level_ds - p_fo.level_min
    oct_fo = tpyr._build_pyramid(up, plan_fo, cfg_fo)
    work = oct_fo[0].clone()
    nxt = torch.empty_like(oct_fo[1])
    chain_fo_ms = time_ms(lambda: conv.octave_chain_into(
        work, taps_fo, decimate_level=lds_fo, next_base=nxt[:, 0]))
    norms_fo = tpyr._detect_norms(p_fo, cfg_fo)
    dkw_fo = dict(threshold=p_fo.threshold,
                  edge_threshold=p_fo.edge_threshold, subpixel=True,
                  darkness_adaption=False, detector="dog")
    valid_fo = int(detect.detect_octave(oct_fo[0], norms_fo, p_fo.key_levels,
                                        **dkw_fo)[0].valid.sum())
    detect_fo_ms = time_ms(lambda: detect.detect_octave(
        oct_fo[0], norms_fo, p_fo.key_levels, **dkw_fo))
    n_big = BATCH * 4 * HEIGHT * WIDTH
    L_fo, NK_fo = p_fo.num_levels, len(p_fo.key_levels)
    chain_fo_bound = bound(4 * n_big * L_fo + n_big,
                           4 * sum(len(t) for t in taps_fo) * n_big)
    detect_fo_bound = bound(n_big * (4 * L_fo + 9 * NK_fo) + 20 * valid_fo,
                            n_big * (13 * L_fo + 30 * NK_fo) + 170 * valid_fo)
    del work, nxt, oct_fo, plain_fo
    emit("first_octave", detector="dog", first_octave=-1, batch=BATCH,
         input=[HEIGHT, WIDTH], octave0=[2 * HEIGHT, 2 * WIDTH],
         octaves=n_fo, launches=launches_fo, keypoints_checked=keys_fo,
         features=table_fo.count().tolist(),
         frames_with_differing_orientations=int((~ok_fo).sum()),
         equals_plain=True, desc_max_abs_err=fo_desc_err,
         frame0_equals_batch=True, frame0_vs_cpu=fo_cpu,
         batch_ms=fo_batch_ms, ms_per_frame_batched=min(fo_batch_ms) / BATCH,
         frame0_ms=fo_frame_ms, ms_per_frame_single=min(fo_frame_ms),
         chain_ms_960x1280=chain_fo_ms, chain_bound_ms_960x1280=chain_fo_bound,
         detect_ms_960x1280=detect_fo_ms,
         detect_bound_ms_960x1280=detect_fo_bound,
         detect_valid_cells_960x1280=valid_fo)
    timing["octave_chain"]["ms_960x1280"] = chain_fo_ms
    timing["detect_octave"]["ms_960x1280"] = detect_fo_ms
    del table_fo, one_fo, up

    # ---- direct: every level blurred from the octave base ------------------
    direct_report = {}
    for det, blurs in (("hessian", 21), ("dog", 26)):
        cfg_dir = SiftConfig(detector=det, conv_mode="direct", **slice_cfg)
        cfg_chain = SiftConfig(detector=det, **slice_cfg)
        expected = dict(EXPECTED_LAUNCHES, blur=blurs, downsample2=4,
                        octave_chain=0)
        reset_launch_counts()
        table = detect_batch(imgs, cfg_dir)
        torch.cuda.synchronize()
        launches = launch_counts()
        if launches != expected:
            fail(f"direct ({det}) launch counts {launches} != {expected}")
        launches_by_path[f"direct_{det}"] = launches
        plain = detect_batch(imgs, cfg_dir, plain=True)
        torch.cuda.synchronize()
        if launch_counts() != launches:
            fail("the plain direct run launched a kernel")
        # detection only: the whole table is upstream of the orientation
        # stage, so kernel and plain routes agree bit for bit
        for f in table._fields:
            if not same(getattr(table, f), getattr(plain, f)):
                fail(f"direct ({det}): {f} differs between the kernels and "
                     "the plain versions")
        cpu = detect_batch(frames[:1], cfg_dir, device="cpu")
        frame_vs_cpu(FeatureTable(*(a[:1] for a in table)), cpu,
                     f"direct ({det}) frame 0", descriptors=False)
        plan_d = make_plan(HEIGHT, WIDTH, cfg_dir)
        direct_report[det] = dict(
            launches=launches, keypoints=table.count().tolist(),
            chain_mode_keypoints=detect_batch(imgs, cfg_chain).count()
            .tolist(),
            pyramid_ms=time_ms(lambda: tpyr._build_pyramid(imgs, plan_d,
                                                           cfg_dir)),
            chain_mode_pyramid_ms=time_ms(lambda: tpyr._build_pyramid(
                imgs, plan_d, cfg_chain)),
            device=device_busy(lambda: detect_batch(imgs, cfg_dir)),
            chain_mode_device=device_busy(lambda: detect_batch(imgs,
                                                               cfg_chain)))
        del table, plain
    emit("direct", config="-sd -ofix", batch=BATCH, height=HEIGHT,
         width=WIDTH, equals_plain=True, frame0_equals_cpu=True,
         **direct_report)

    # ---- facade: HessianSift on PGM files ----------------------------------
    workdir = tempfile.mkdtemp(prefix="hessgpu_smoke_")
    try:
        u8 = [(np.clip(frames[i], 0, 1) * 255 + 0.5).astype(np.uint8)
              for i in range(4)]
        pgms = [write_pgm(os.path.join(workdir, f"f{i}.pgm"), u8[i])
                for i in range(4)]
        sift = HessianSift()                          # device defaults to cuda
        reset_launch_counts()
        feats = [sift.run(p) for p in pgms]
        torch.cuda.synchronize()
        launches = launch_counts()
        want_launches = {k: 4 * v for k, v in EXPECTED_LAUNCHES_DEFAULT.items()}
        if launches != want_launches:
            fail(f"HessianSift.run launch counts {launches} != "
                 f"{want_launches}")
        launches_by_path["facade_4_frames"] = launches
        # Each frame's run is detect_and_describe's on the card, field for
        # field. That B=1 path is held, slot for slot, to its plain versions
        # on the card and, under the main path's frame-0 rules, to the CPU.
        facade_vs_cpu = []
        for i, f in enumerate(feats):
            card, _ = detect_and_describe(u8[i], SiftConfig())
            want = to_numpy_trimmed(card)
            for k in want:
                if not np.array_equal(f[k], want[k]):
                    fail(f"HessianSift.run frame {i}: {k} differs from "
                         "detect_and_describe")
            reset_launch_counts()
            plain, _ = tpyr.run_pipeline(
                *tpyr.prepare_input(u8[i], SiftConfig()), plain=True)
            torch.cuda.synchronize()
            if any(launch_counts().values()):
                fail("the plain B=1 run launched a kernel")
            kernels_equal_plain(FeatureTable(*(a[None] for a in card)),
                                FeatureTable(*(a[None] for a in plain)),
                                torch.ones(1, dtype=torch.bool, device=dev),
                                f"HessianSift.run frame {i}")
            cpu, _ = detect_and_describe(u8[i], SiftConfig(), device="cpu")
            facade_vs_cpu.append(frame_vs_cpu(card, cpu,
                                              f"HessianSift.run frame {i}"))
            del card, plain, cpu
        if len(feats[0]["x"]) != FRAME0_FEATURES:
            fail(f"HessianSift.run frame 0: {len(feats[0]['x'])} features, "
                 f"pinned {FRAME0_FEATURES}")
        facade_sifts = []
        for i in (0, 1):
            f = sift.run(pgms[i])
            kp, desc = sift.get_feature_vector()
            if kp.shape != (len(f["x"]), 6) or desc is not f["desc"] \
                    or not np.array_equal(kp[:, 0], f["x"]) \
                    or not np.array_equal(kp[:, 5].view(np.uint32) & 0xFFFF,
                                          f["level"]):
                fail("get_feature_vector does not carry the features")
            path = os.path.join(workdir, f"facade{i}.sift")
            sift.save_sift(path)
            facade_sifts.append(path)
            back = load_sift_text(path)
            if len(back["x"]) != len(f["x"]) \
                    or np.abs(back["x"] - f["x"]).max() > 0.005 \
                    or np.abs(back["desc"] - f["desc"]).max() > 0.5 / 512 + 1e-6 \
                    or not np.array_equal(back["level"], f["level"]):
                fail("save_sift / load_sift_text do not round-trip")
        kp, _ = sift.get_feature_vector()       # frame 1's
        reset_launch_counts()
        reentry = sift.run_with_keypoints(pgms[1], kp)
        reentry_launches = launch_counts()
        if reentry_launches["descriptor"] != 1 \
                or reentry_launches["orientation"] != 0 \
                or len(reentry["x"]) != len(kp) \
                or not np.array_equal(reentry["response"], kp[:, 4]) \
                or not np.isfinite(reentry["desc"]).all() \
                or np.abs(np.linalg.norm(reentry["desc"], axis=1) - 1).max() \
                > 1e-5:
            fail(f"run_with_keypoints: launches {reentry_launches}")
        rep = sift.device_stage_report(pgms[0])
        vals = list(rep.values())
        if tuple(rep) != REFERENCE_BUCKETS or not all(
                np.isfinite(v) and v >= 0 for v in vals) \
                or rep["TOTAL"] < sum(vals[:-1]) - 1e-9 \
                or rep["TOTAL"] <= 0 or rep["BUILD_PYRAMID"] <= 0 \
                or rep["DETECT_KEYPOINTS"] <= 0:
            fail(f"device_stage_report: {dict(rep)}")
        stage_ms = {k: [] for k in ("load", "pipeline", "download")}
        run_ms = []
        sift.run(pgms[0])
        for _ in range(10):
            t0 = time.perf_counter()
            sift.run(pgms[0])
            run_ms.append((time.perf_counter() - t0) * 1e3)
            for k in stage_ms:
                stage_ms[k].append(sift.timer.last[k])
        emit("facade", frames=4, features=[len(f["x"]) for f in feats],
             launches=launches, equals_detect_and_describe=True,
             equals_plain=True, vs_cpu=facade_vs_cpu,
             save_sift_roundtrip=True, reentry_launches=reentry_launches,
             device_stage_report_ms=dict(rep),
             run_ms=run_ms, run_ms_median=statistics.median(run_ms),
             stage_ms_median={k: statistics.median(v)
                              for k, v in stage_ms.items()},
             stage_ms=stage_ms, nvidia_smi=smi_line)

        # ---- cli: python -m hessgpu_tpu_torch.cli.hess, on the card ---------
        env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        cli = subprocess.run(
            [sys.executable, "-m", "hessgpu_tpu_torch.cli.hess", "-i",
             pgms[0], pgms[1]], cwd=workdir, env=env, capture_output=True,
            text=True, timeout=300)
        if cli.returncode != 0:
            fail(f"hess -i: exit {cli.returncode}: {cli.stderr[-2000:]}")
        for i, path in enumerate(facade_sifts):
            with open(path, "rb") as a, \
                    open(os.path.join(workdir, f"f{i}.sift"), "rb") as b:
                if a.read() != b.read():
                    fail(f"hess -i: f{i}.sift differs from the facade's")
        speed = subprocess.run(
            [sys.executable, "-m", "hessgpu_tpu_torch.cli.hess", "-i",
             pgms[2], "-speed"], cwd=workdir, env=env, capture_output=True,
            text=True, timeout=300)
        hz = [float(v) for v in re.findall(r"([0-9.]+) Hz \(",
                                           speed.stdout)]
        csv_path = os.path.join(workdir, "f2.speed.csv")
        if speed.returncode != 0 or len(hz) != 2 \
                or not os.path.exists(csv_path):
            fail(f"hess -speed: exit {speed.returncode}: {speed.stdout[-800:]}"
                 f"{speed.stderr[-1500:]}")
        with open(csv_path) as fh:
            speed_csv = fh.read().splitlines()
        if tuple(speed_csv[3].split(",")) != REFERENCE_BUCKETS:
            fail(f"hess -speed: {csv_path} buckets {speed_csv[3]}")
        emit("cli", images=2, sift_files_equal_facade=True, speed_hz=hz,
             speed_csv=speed_csv, nvidia_smi=smi_line)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- matcher ------------------------------------------------------------
    H10 = rotation_homography(10, HEIGHT, WIDTH)
    warped = warp_image(frames[0], H10)
    fa = HessianSift().run(frames[0])
    fb = HessianSift().run(warped)
    m_card, m_cpu = SiftMatcher(), SiftMatcher(device="cpu")
    pairs = [m.match(fa, fb) for m in (m_card, m_cpu)]
    if not np.array_equal(pairs[0], pairs[1]) or len(pairs[0]) < 50:
        fail(f"matcher: {len(pairs[0])} matches on the card, {len(pairs[1])} "
             "on the CPU, or they differ")
    guided = []
    for m in (m_card, m_cpu):
        m.set_feature_location(0, np.stack([fa["x"], fa["y"]], 1))
        m.set_feature_location(1, np.stack([fb["x"], fb["y"]], 1))
        guided.append(m.get_guided_sift_match(H=H10.astype(np.float32)))
    if not np.array_equal(guided[0], guided[1]) or len(guided[0]) < 50:
        fail("matcher: guided matches differ between the card and the CPU")
    qa = torch.from_numpy(tmatch.quantize_descriptors(fa["desc"])).to(dev)
    qb = torch.from_numpy(tmatch.quantize_descriptors(fb["desc"])).to(dev)
    dots = tmatch.descriptor_dots(qa, qb).cpu().numpy()
    want = qa.cpu().numpy().astype(np.int64) @ qb.cpu().numpy().astype(
        np.int64).T
    if not (dots == want).all():
        fail("matcher: the dots at frame 0's size differ from int64 numpy")
    g = np.random.RandomState(11)
    N = 16384
    big_a = torch.from_numpy(g.randint(0, 256, (N, 128), np.uint8)).to(dev)
    big_b = torch.from_numpy(g.randint(0, 256, (N, 128), np.uint8)).to(dev)
    big_a[0] = 255      # the largest dot: 128 * 255^2 = 8323200 < 2^24
    big_b[0] = 255
    dots = tmatch.descriptor_dots(big_a, big_b).cpu().numpy()
    # every partial sum is an integer below 2^24, so the float64 product
    # (BLAS, exact below 2^53) is the int64 one
    want = (big_a.cpu().numpy().astype(np.float64)
            @ big_b.cpu().numpy().astype(np.float64).T).astype(np.int64)
    if not (dots == want).all() or int(want.max()) != 128 * 255 * 255:
        fail("matcher: the 16384 x 16384 dots differ from int64 numpy")
    del dots, want
    va = torch.ones(N, dtype=torch.bool, device=dev)
    core = lambda a, b, v1, v2: tmatch._match_core(a, b, v1, v2, 0.7, 0.8)
    loc_a = torch.from_numpy(g.rand(N, 2).astype(np.float32) * 640).to(dev)
    loc_b = torch.from_numpy(g.rand(N, 2).astype(np.float32) * 640).to(dev)
    Ht = torch.from_numpy(H10.astype(np.float32)).to(dev)
    Ft = torch.eye(3, device=dev)
    vq = torch.ones(len(qa), dtype=torch.bool, device=dev)
    vr = torch.ones(len(qb), dtype=torch.bool, device=dev)
    emit("matcher", frame0_features=[len(fa["x"]), len(fb["x"])],
         matches=len(pairs[0]), guided_matches=len(guided[0]),
         card_equals_cpu=True, dots_equal_int64=[[len(qa), len(qb)], [N, N]],
         match_core_ms_frame0=time_ms(lambda: core(qa, qb, vq, vr)),
         match_core_ms_16384=time_ms(lambda: core(big_a, big_b, va, va),
                                     reps=5),
         guided_gate_ms_16384=time_ms(lambda: tmatch._guided_gate(
             loc_a, loc_b, Ht, 32.0, Ft, 16.0), reps=5),
         nvidia_smi=smi_line)
    del big_a, big_b

    # ---- server: the port's hess_server on loopback, on the card ----------
    from hessgpu_tpu_torch import server_build
    from hessgpu_tpu_torch.features import keypoint_buffer
    from hessgpu_tpu_torch.parallel.client import RemoteSift

    def wire_vs_in_process(kp, desc, feats, what):
        """A reply's keypoint and descriptor bytes against the in-process
        run's: bit for bit, or else each differing field named and held to
        frame_vs_cpu's rules."""
        want_kp = keypoint_buffer(feats)
        want_desc = np.ascontiguousarray(feats["desc"], np.float32)
        if kp.shape != want_kp.shape or desc.shape != want_desc.shape:
            fail(f"server {what}: {kp.shape} / {desc.shape} against "
                 f"{want_kp.shape} / {want_desc.shape} in process")
        if kp.tobytes() == want_kp.tobytes() \
                and desc.tobytes() == want_desc.tobytes():
            return []
        names = ("x", "y", "sigma", "theta", "response", "level|type")
        differing = [n for i, n in enumerate(names)
                     if kp[:, i].tobytes() != want_kp[:, i].tobytes()]
        if desc.tobytes() != want_desc.tobytes():
            differing.append("desc")
        for i, n in enumerate(names):
            if n in ("sigma", "theta"):
                continue
            if kp[:, i].tobytes() != want_kp[:, i].tobytes():
                fail(f"server {what}: {n} differs from the in-process run")
        if not np.allclose(kp[:, 2], want_kp[:, 2], rtol=1e-6, atol=0):
            fail(f"server {what}: sigma differs from the in-process run")
        dth = np.abs(np.mod(kp[:, 3] - want_kp[:, 3] + np.pi, 2 * np.pi)
                     - np.pi)
        moved = dth > 1e-6
        if dth.max(initial=0) > quantum + 1e-6 or moved.sum() > len(kp) // 100:
            fail(f"server {what}: theta differs on {int(moved.sum())} "
                 f"features, by up to {float(dth.max())}")
        err = np.abs(desc[~moved] - want_desc[~moved]).max(initial=0)
        if err > 1e-5:
            fail(f"server {what}: descriptors {err} apart")
        return differing

    def free_port():
        import socket
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    t0 = time.perf_counter()
    server_bin = str(server_build.build())
    server_build_s = time.perf_counter() - t0
    workdir = tempfile.mkdtemp(prefix="hessgpu_server_")
    try:
        u8 = [(np.clip(frames[i], 0, 1) * 255 + 0.5).astype(np.uint8)
              for i in range(4)]
        pgm0 = write_pgm(os.path.join(workdir, "f0.pgm"), u8[0])
        sift = HessianSift()
        reset_launch_counts()
        feats = [sift.run(u) for u in u8]
        torch.cuda.synchronize()
        if launch_counts() != {k: 4 * v for k, v in
                               EXPECTED_LAUNCHES_DEFAULT.items()}:
            fail(f"server: in-process launch counts {launch_counts()}")
        env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        differing = {}
        replies = []
        port = free_port()
        t0 = time.perf_counter()
        with RemoteSift(port=port, server_binary=server_bin,
                        spawn_args=["-device", "cuda"], env=env) as r:
            if not r.initialize():
                fail("server: initialize answered 0 on the card")
            # the server imports the port in the connection's thread
            server_start_s = time.perf_counter() - t0
            for i in range(4):
                if not r.run_sift_data(u8[i]):
                    fail(f"server: run_sift_data failed on frame {i}")
                replies.append(r.get_feature_vector())
                differing[f"run_sift_data_{i}"] = wire_vs_in_process(
                    *replies[i], feats[i], f"frame {i}")
            concurrent = server_clients_at_once(r, port, u8[:2], replies[:2])
            for i, got in enumerate(concurrent["replies"]):
                for kp, desc in got:
                    wire_vs_in_process(kp, desc, feats[i],
                                       f"client {i} of two at once")
            if not r.run_sift(pgm0):
                fail("server: run_sift failed on a PGM")
            differing["run_sift_pgm"] = wire_vs_in_process(
                *r.get_feature_vector(), sift.run(pgm0), "run_sift")
            keys = keypoint_buffer(feats[0])[:64]
            r.run_sift_data(u8[0])
            if not r.run_sift_keys(keys[:, :4]):
                fail("server: run_sift_keys failed")
            differing["run_sift_keys"] = wire_vs_in_process(
                *r.get_feature_vector(),
                sift.run_with_keypoints(u8[0], keys[:, :4]), "run_sift_keys")
            r.set_keypoint_list(keys)
            if not r.run_sift_current():
                fail("server: set_keypoint_list + run_sift_current failed")
            differing["set_keypoint_list"] = wire_vs_in_process(
                *r.get_feature_vector(),
                sift.run_with_keypoints(u8[0], keys), "set_keypoint_list")
            wire_matches = {}
            for name, (a, b) in (("frames_0_1", (feats[0], feats[1])),
                                 ("frame0_rotated", (fa, fb))):
                r.match_set_descriptors(0, a["desc"])
                r.match_set_descriptors(1, b["desc"])
                got = r.match()
                if not np.array_equal(got, SiftMatcher().match(a, b)):
                    fail(f"server: match over the wire ({name}) differs "
                         "from SiftMatcher in process")
                wire_matches[name] = len(got)
            if wire_matches["frame0_rotated"] < 50:
                fail(f"server: {wire_matches} matches")
            wire_ms = []
            for _ in range(11):
                t0 = time.perf_counter()
                r.run_sift_data(u8[0])
                r.get_feature_vector()
                wire_ms.append((time.perf_counter() - t0) * 1e3)
            wire_ms = wire_ms[1:]
        local_ms = []
        for _ in range(11):
            t0 = time.perf_counter()
            keypoint_buffer(sift.run(u8[0]))
            local_ms.append((time.perf_counter() - t0) * 1e3)
        local_ms = local_ms[1:]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit("server", frames=4, height=HEIGHT, width=WIDTH,
         features=[len(f["x"]) for f in feats],
         build_s=server_build_s, gxx_seconds=server_build.build_seconds,
         spawn_to_first_answer_s=server_start_s,
         fields_not_bit_equal={k: v for k, v in differing.items() if v},
         bit_equal=not any(differing.values()), wire_matches=wire_matches,
         wire_ms_per_request=wire_ms,
         wire_ms_median=statistics.median(wire_ms),
         two_clients_at_once={k: v for k, v in concurrent.items()
                              if k != "replies"},
         in_process_ms=local_ms, in_process_ms_median=statistics.median(
             local_ms), nvidia_smi=smi_line)

    # ---- match_tiled: bench_match.py's 65536 x 65536 table ----------------
    from hessgpu_tpu_torch.parallel.distributed import match_sharded

    rng = np.random.default_rng(0)
    d = rng.standard_normal((MT_N, 128)).astype(np.float32)
    d = np.abs(d) / np.linalg.norm(d, axis=1, keepdims=True)
    mt1 = (d * 512).astype(np.uint8)
    mt2 = np.roll(mt1, 7, axis=0)
    del d
    mt1_t, mt2_t = (torch.from_numpy(a).to(dev) for a in (mt1, mt2))

    def table(tile, mutual=True, a=mt1_t, b=mt2_t, **kw):
        return match_sharded(a, b, mutual_best=mutual, n2_tile=tile, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    m_tile = table(MT_TILE)
    torch.cuda.synchronize()
    mt_peak = torch.cuda.max_memory_allocated() - base_mem
    if not torch.equal(m_tile, table(MT_TILE // 2)):
        fail(f"match_tiled: n2_tile {MT_TILE} and {MT_TILE // 2} differ")
    mt_matches = int((m_tile >= 0).sum())
    planted = float((m_tile == (torch.arange(MT_N, device=dev) + 7)
                     % MT_N).float().mean())
    # 256 rows (non-mutual) against float64 numpy, exact for these sums; a
    # row whose test lands within 1e-6 rad of its threshold is counted apart
    rows_only = table(MT_TILE, mutual=False).cpu().numpy()
    sel = np.random.RandomState(5).choice(MT_N, 256, replace=False)
    dots64 = mt1[sel].astype(np.float64) @ mt2.astype(np.float64).T
    best = dots64.argmax(1)
    bv = dots64[np.arange(256), best]
    dots64[np.arange(256), best] = -np.inf
    nv = dots64.max(1)
    del dots64
    dist = np.arccos(np.minimum(bv / 512.0 ** 2, 1.0))
    distn = np.arccos(np.clip(nv / 512.0 ** 2, -1.0, 1.0))
    want = np.where((dist < 0.7) & (dist < 0.8 * distn) & (bv > 0), best, -1)
    near = (np.abs(dist - 0.7) < 1e-6) | (np.abs(dist - 0.8 * distn) < 1e-6)
    if not np.array_equal(rows_only[sel][~near], want[~near]):
        fail("match_tiled: sampled rows differ from float64 numpy")
    # 16384 x 16384: tiled against the untiled _match_core, plain and guided
    n = MT_TILE
    sub1, sub2 = mt1_t[:n], mt2_t[:n]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    if not torch.equal(table(MT_TILE // 4, a=sub1, b=sub2),
                       tmatch._match_core(sub1, sub2, ones, ones, 0.7, 0.8)):
        fail("match_tiled: 16384^2 tiled differs from _match_core (plain)")
    g = np.random.RandomState(12)
    loc1 = (g.rand(n, 2) * [WIDTH, HEIGHT]).astype(np.float32)
    x2 = np.c_[np.roll(loc1, 7, axis=0), np.ones(n)] @ H10.T
    loc2 = (x2[:, :2] / x2[:, 2:]).astype(np.float32)
    l1, l2 = (torch.from_numpy(a).to(dev) for a in (loc1, loc2))
    Hg = torch.from_numpy(H10.astype(np.float32)).to(dev)
    gate = tmatch._guided_gate(l1, l2, Hg, 32.0, torch.eye(3, device=dev),
                               1.0e20)
    want_g = tmatch._match_core(sub1, sub2, ones, ones, 0.7, 0.8, gate=gate)
    del gate
    got_g = table(MT_TILE // 4, a=sub1, b=sub2, loc1=l1, loc2=l2,
                  H=H10.astype(np.float32))
    if not torch.equal(got_g, want_g) or int((got_g >= 0).sum()) < n // 2:
        fail("match_tiled: 16384^2 guided tiled differs from _match_core")
    # seconds per table: warm-up, then the best of 3 windows of >= 1 s
    table(MT_TILE)
    torch.cuda.synchronize()
    mt_reps = []
    for _ in range(3):
        calls, t0 = 0, time.perf_counter()
        while True:
            table(MT_TILE)
            torch.cuda.synchronize()
            calls += 1
            if time.perf_counter() - t0 >= 1.0:
                break
        mt_reps.append((time.perf_counter() - t0) / calls)
    mt_s = min(mt_reps)
    mt_flops = MT_N * MT_N * 128 * 2
    # the float32 table as this design walks it: written once by the
    # product, read by the row max and second and the column max and second
    mt_pass_bytes = 5 * MT_N * MT_N * 4
    emit("match_tiled", n1=MT_N, n2=MT_N, n2_tile=MT_TILE,
         equals_tile_8192=True, matches=mt_matches,
         planted_share=planted, sampled_rows_equal_float64=256 - int(
             near.sum()), sampled_rows_near_threshold=int(near.sum()),
         equals_match_core_16384=True,
         guided_matches_16384=int((got_g >= 0).sum()),
         seconds_per_table=mt_s, seconds_reps=mt_reps,
         gpairs_per_s=MT_N * MT_N / mt_s / 1e9, peak_memory_bytes=mt_peak,
         bound_ms=bound(2 * MT_N * 128 + MT_N * 8, mt_flops)[0],
         bound_by=bound(2 * MT_N * 128 + MT_N * 8, mt_flops)[1],
         flops=mt_flops, passes_bytes=mt_pass_bytes,
         passes_bytes_ms=mt_pass_bytes / HBM_BYTES_PER_S * 1e3,
         nvidia_smi=smi_line)
    del mt1_t, mt2_t, sub1, sub2, m_tile

    # ---- evaluation: repeatability under the 10 degree rotation ------------
    scores = [evaluate_repeatability(frames[0], angles=(10,), scales=(1.0,),
                                     device=d) for d in ("cuda", "cpu")]
    if scores[0] != scores[1] or not scores[0]["mean"] > 0.5:
        fail(f"evaluate_repeatability: card {scores[0]}, CPU {scores[1]}")
    emit("evaluation", angle=10, scale=1.0,
         repeatability=scores[0]["mean"], card_equals_cpu=True)

    # ---- ba: bundle adjustment at bench_ba.py's size ---------------------
    from hessgpu_tpu_torch.convert import ba_from_numpy
    from hessgpu_tpu_torch.sfm import ba as tba

    ba_np = ba_problem()
    st_card, pr_card = ba_from_numpy(device=dev, **ba_np)
    st_cpu, pr_cpu = ba_from_numpy(device="cpu", **ba_np)
    lam0 = 1e-3
    step_card = tba.lm_step(st_card, pr_card, torch.tensor(lam0, device=dev),
                            cg_iters=BA_CG_ITERS)
    step_cpu = one_torch_thread(tba.lm_step, st_cpu, pr_cpu,
                                torch.tensor(lam0), cg_iters=BA_CG_ITERS)
    c0 = [float(step_card[2]), float(step_cpu[2])]
    c1 = [float(step_card[3]), float(step_cpu[3])]
    if abs(c0[0] - c0[1]) > 1e-5 * abs(c0[1]) \
            or abs(c1[0] - c1[1]) > 1e-3 * abs(c1[1]) \
            or bool(step_card[4]) != bool(step_cpu[4]):
        fail(f"ba: lm_step card {c0[0]} -> {c1[0]} ({bool(step_card[4])}), "
             f"CPU {c0[1]} -> {c1[1]} ({bool(step_cpu[4])})")

    def lm_run(st, pr, iters):
        lam = torch.tensor(lam0, device=st.R.device)
        for _ in range(iters):
            st, lam, _, _, _ = tba.lm_step(st, pr, lam, cg_iters=BA_CG_ITERS)
        return st

    lm_run(st_card, pr_card, BA_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_card = lm_run(st_card, pr_card, BA_ITERS)
    torch.cuda.synchronize()
    ba_s = time.perf_counter() - t0
    out_card2 = lm_run(st_card, pr_card, BA_ITERS)
    out_cpu = one_torch_thread(lm_run, st_cpu, pr_cpu, BA_ITERS)
    rmse = [tba.reprojection_rmse(out_card, pr_card),
            tba.reprojection_rmse(out_cpu, pr_cpu)]
    rmse2 = tba.reprojection_rmse(out_card2, pr_card)
    if abs(rmse[0] - rmse[1]) > 1e-2 or not np.isfinite(rmse[0]):
        fail(f"ba: final RMSE {rmse[0]} px on the card, {rmse[1]} on the CPU")
    # the segment sums are ordered (sfm/ba.py), so a card run repeats itself
    for f in ("R", "t", "X"):
        if not same(getattr(out_card, f), getattr(out_card2, f)):
            fail(f"ba: two card runs of the same LM steps differ in {f}")
    prof = device_profile(lambda: tba.lm_step(
        st_card, pr_card, torch.tensor(lam0, device=dev),
        cg_iters=BA_CG_ITERS), runs=3)
    emit("ba", cameras=BA_CAMS, points=BA_PTS,
         observations=int(pr_card.uv.shape[0]), cg_iters=BA_CG_ITERS,
         lm_step_cost0_card_cpu=c0, lm_step_cost1_card_cpu=c1,
         accepted=bool(step_card[4]),
         lm_iters_per_s=BA_ITERS / ba_s, cg_iters_per_s=BA_ITERS
         * BA_CG_ITERS / ba_s, timed_iters=BA_ITERS, timed_s=ba_s,
         launches_per_lm_iter=prof["launches"],
         device_busy_ms_per_lm_iter=prof["busy_ms"],
         wall_ms_per_lm_iter_profiler_on=prof["wall_ms"],
         top_device_work=dict(list(prof["by_kernel"].items())[:8]),
         final_rmse_px_card_cpu=rmse, rmse_px_second_card_run=rmse2,
         two_card_runs_max_abs_diff={
             f: max_abs(getattr(out_card, f), getattr(out_card2, f))
             for f in ("R", "t", "X")},
         card_vs_cpu_max_abs_diff={
             f: max_abs(getattr(out_card, f).cpu(), getattr(out_cpu, f))
             for f in ("R", "t", "X")},
         nvidia_smi=smi_line)
    del st_card, pr_card, out_card, out_card2

    # ---- sfm: the synthetic TUM sequence, detect + reconstruct + ATE ------
    from hessgpu_tpu_torch.sfm import incremental as tinc
    from hessgpu_tpu_torch.sfm import twoview as ttv
    from hessgpu_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
    from hessgpu_tpu_torch.sfm.synthetic import tum_sequence

    seq_frames, seq_K, _, seq_centers = tum_sequence(
        SFM_FRAMES, HEIGHT, WIDTH, seed=SFM_SEED)
    sift = HessianSift(SiftConfig(threshold=SFM_THRESHOLD))
    reset_launch_counts()
    t0 = time.perf_counter()
    seq_feats = [sift.run(f) for f in seq_frames]
    torch.cuda.synchronize()
    detect_s = time.perf_counter() - t0
    launches = launch_counts()
    want_launches = {k: SFM_FRAMES * v
                     for k, v in EXPECTED_LAUNCHES_DEFAULT.items()}
    if launches != want_launches:
        fail(f"sfm: HessianSift.run launch counts {launches} != "
             f"{want_launches}")
    launches_by_path[f"sfm_{SFM_FRAMES}_frames"] = launches

    def reconstruct(device, sampler=None):
        """reconstruct_sequence on `device` (under `sampler`'s RANSAC draws,
        else the JAX package's), its BA and (on the card) its SVDs outside
        the RANSAC cores timed by the host clock around a synchronize; the
        cores' calls counted, each PnP's arguments kept."""
        stats = {"ba_s": 0.0, "svd": {}, "ransac_f_calls": 0}
        pnp_args = []
        real_ba, real_svd = tinc.bundle_adjust, torch.linalg.svd
        real_f = tinc.ransac_fundamental_from_samples
        real_p, real_draws = tinc.ransac_pnp_from_samples, tinc.sample_indices

        def timed_ba(*a, **kw):
            t = time.perf_counter()
            out = real_ba(*a, **kw)
            synchronize(device)
            stats["ba_s"] += time.perf_counter() - t
            return out

        def timed_svd(A, *a, **kw):
            synchronize(device)
            t = time.perf_counter()
            out = real_svd(A, *a, **kw)
            synchronize(device)
            k = stats["svd"].setdefault("x".join(map(str, A.shape)),
                                        [0, 0.0])
            k[0] += 1
            k[1] += time.perf_counter() - t
            return out

        def counted_f(*a, **kw):
            stats["ransac_f_calls"] += 1
            return real_f(*a, **kw)

        def kept_p(*a, **kw):
            pnp_args.append(a[:3] + a[4:5])       # idx, X, uv, K
            return real_p(*a, **kw)

        tinc.bundle_adjust = timed_ba
        torch.linalg.svd = timed_svd
        tinc.ransac_fundamental_from_samples = counted_f
        tinc.ransac_pnp_from_samples = kept_p
        if sampler is not None:
            tinc.sample_indices = sampler
        try:
            t = time.perf_counter()
            rec = tinc.reconstruct_sequence(seq_feats, seq_K, device=device)
            synchronize(device)
            stats["seconds"] = time.perf_counter() - t
        finally:
            tinc.bundle_adjust, torch.linalg.svd = real_ba, real_svd
            tinc.ransac_fundamental_from_samples = real_f
            tinc.ransac_pnp_from_samples = real_p
            tinc.sample_indices = real_draws
        if rec is None:
            fail(f"sfm: reconstruct_sequence on {device} returned None")
        ids = rec.view_ids
        stats["svd_s"] = sum(v[1] for v in stats["svd"].values())
        stats.update(
            registered=rec.num_cameras, points=rec.num_points,
            pnp_calls=len(pnp_args),
            ate=ate_rmse(camera_centers(rec.R, rec.t), seq_centers[ids]))
        return rec, stats, pnp_args

    def pnp_kept_share(pnp_args):
        """The share of the PnP hypotheses with ok and a positive scale (the
        ones whose rotation is right; ROADMAP's reference-side caveats)."""
        kept = total = 0
        for idx, X, uv, K in pnp_args:
            _, _, ok, scale = ttv.pnp_hypotheses(idx, X, uv, K)
            kept += int((ok & (scale > 0)).sum())
            total += ok.numel()
        return kept / max(total, 1)

    reset_launch_counts()
    rec_card, sfm_card, pnp_card = reconstruct("cuda")
    sfm_launches = launch_counts()
    want_linalg = 2 * sfm_card["ransac_f_calls"] + sfm_card["pnp_calls"]
    if (sfm_launches["null_vector"], sfm_launches["svd3"]) != \
            (want_linalg, want_linalg) or want_linalg == 0:
        fail(f"sfm: the RANSAC cores launched null_vector "
             f"{sfm_launches['null_vector']} and svd3 {sfm_launches['svd3']} "
             f"times, {want_linalg} each expected (2 a fundamental RANSAC, "
             "1 a PnP)")
    launches_by_path[f"sfm_{SFM_FRAMES}_frames_reconstruction"] = \
        sfm_launches
    rec_cpu, sfm_cpu, pnp_cpu = one_torch_thread(reconstruct, "cpu")
    sfm_card["pnp_kept_share"] = pnp_kept_share(pnp_card)
    sfm_cpu["pnp_kept_share"] = pnp_kept_share(pnp_cpu)
    if rec_card.view_ids != list(range(SFM_FRAMES)) \
            or rec_cpu.view_ids != rec_card.view_ids:
        fail(f"sfm: view_ids on the card {rec_card.view_ids}, on the CPU "
             f"{rec_cpu.view_ids}; all {SFM_FRAMES} expected")
    if not sfm_card["ate"] <= 2 * JAX_SFM_ATE:
        fail(f"sfm: ATE {sfm_card['ate']} on the card, limit "
             f"{2 * JAX_SFM_ATE} (twice the JAX package's)")
    # the card under the torch.Generator streams of
    # scripts/torch_sfm_streams.py
    sys.path.insert(0, os.path.join(REPO_DIR, "scripts"))
    from torch_sfm_streams import torch_stream
    streams = []
    for k in range(SFM_TORCH_STREAMS):
        rec_k, st_k, pnp_k = reconstruct("cuda", torch_stream(k))
        if rec_k.view_ids != list(range(SFM_FRAMES)) \
                or not st_k["ate"] <= 2 * JAX_SFM_ATE:
            fail(f"sfm: torch stream {k}: registered {rec_k.view_ids}, ATE "
                 f"{st_k['ate']} (limit {2 * JAX_SFM_ATE})")
        streams.append(dict(stream=f"torch_{k}", ate=st_k["ate"],
                            registered=st_k["registered"],
                            points=st_k["points"], seconds=st_k["seconds"],
                            pnp_kept_share=pnp_kept_share(pnp_k)))
    emit("sfm", frames=SFM_FRAMES, height=HEIGHT, width=WIDTH,
         threshold=SFM_THRESHOLD, features=[len(f["x"]) for f in seq_feats],
         launches=launches, detect_s=detect_s,
         reconstruction_launches=sfm_launches,
         view_ids_equal=True, card=sfm_card, cpu=sfm_cpu,
         card_torch_streams=streams,
         jax_ate_reference=JAX_SFM_ATE, ate_limit=2 * JAX_SFM_ATE,
         cpu_torch_threads=1,
         nvidia_smi=smi_line)

    spatial_kernel_ms = mesh_phases(
        dev, smi_line, same, max_abs, launches_by_path, frames, ba_np,
        (seq_feats, seq_K, seq_centers), sfm_card["ate"])

    return dict(same=same, frames=frames, ba_np=ba_np,
                seq=(seq_feats, seq_K, seq_centers), timing=timing,
                launches_by_path=launches_by_path,
                spatial_kernel_ms=spatial_kernel_ms,
                launches_def=launches_def, launches_sfm=sfm_launches,
                errs=errs)


if __name__ == "__main__":
    main()
